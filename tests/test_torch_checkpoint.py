"""The port's flash checkpoint against the JAX package's, on the CPU.

A checkpoint directory, a memory snapshot and the agent protocol are
shared by both packages: the port's train state is laid out as the JAX
train state's leaves (``models/convert.train_state_leaves``), its
``.meta`` pickles name the JAX package's classes, and each package's
saver serves the other's engine. Each case runs with optax ``adamw``
against the port's AdamW (fp32 params) and with ``adam8bit`` on both
sides (bf16 params); a tiny GPT on the einsum attention path, one seed
of numpy batches. Restored state is held bit for bit; losses of the
two packages after a restore agree to ``LOSS_TOL``, the tolerance of
``test_torch_trainer.py`` (fp32 summation order).

The ``gpu``-marked test imports no JAX (the JAX package is imported
inside the CPU tests), so on the card it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_checkpoint.py
"""

import glob
import os
import pickle
import signal
import subprocess
import sys
import time
import types
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common import ckpt_persist
from dlrover_tpu_torch.common.storage import PosixDiskStorage
from dlrover_tpu_torch.models.convert import leaf_bytes, train_state_leaves
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.optim import adam8bit, adamw
from dlrover_tpu_torch.train.checkpoint import engine as port_engine
from dlrover_tpu_torch.train.trainer import Trainer, TrainerCallback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
BASE = dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=2,
            d_model=32, attn_impl="xla")
OPTS = ("adamw", "adam8bit")
PARAM_DTYPE = {"adamw": "float32", "adam8bit": "bfloat16"}
LR = {"adamw": 1e-3, "adam8bit": 1e-2}


def batches(n=6, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (4, 32), dtype=np.int32) for _ in range(n)]


def _jax():
    """The JAX package, imported by the CPU tests only."""
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.accel import ParallelSpec
    from dlrover_tpu.agent import ckpt_saver
    from dlrover_tpu.models import gpt
    from dlrover_tpu.optim import low_bit
    from dlrover_tpu.train import trainer
    from dlrover_tpu.train.checkpoint import engine

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, optax=optax, ParallelSpec=ParallelSpec,
        gpt=gpt, low_bit=low_bit, trainer=trainer, engine=engine,
        ckpt_saver=ckpt_saver)


class Losses(TrainerCallback):
    def __init__(self):
        self.values = []

    def on_step_end(self, trainer, step, metrics):
        self.values.append(float(metrics["loss"]))


def jax_trainer(opt, ckpt_dir="", persist_every=100, callbacks=()):
    J = _jax()
    dt = getattr(J.jnp, PARAM_DTYPE[opt])
    tx = (J.optax.adamw(LR[opt]) if opt == "adamw"
          else J.low_bit.adam8bit(LR[opt]))
    model = J.gpt.GPT(J.gpt.GPTConfig(**BASE, dtype=J.jnp.float32,
                                      param_dtype=dt))

    def loss(module, params, batch):
        return J.gpt.loss_fn(module.apply({"params": params}, batch), batch)

    return J.trainer.Trainer(model, tx, loss, batches(1)[0],
                             spec=J.ParallelSpec(), checkpoint_dir=ckpt_dir,
                             persist_every=persist_every,
                             callbacks=list(callbacks))


def port_trainer(opt, ckpt_dir="", persist_every=100, callbacks=(), seed=0,
                 device="cpu"):
    dt = getattr(torch, PARAM_DTYPE[opt])
    gen = torch.Generator(device=device).manual_seed(seed)
    model = GPT(GPTConfig(**BASE, dtype=torch.float32, param_dtype=dt),
                device=device, generator=gen)
    tx = adamw(LR[opt]) if opt == "adamw" else adam8bit(LR[opt])
    return Trainer(model, tx, lambda m, p, b: loss_fn(m(b), b),
                   batches(1)[0], device=device, callbacks=callbacks,
                   checkpoint_dir=ckpt_dir, persist_every=persist_every)


def port_bytes(state):
    """{keystr path: leaf bytes} of the port's train state."""
    return {leaf.path: leaf_bytes(leaf).cpu().numpy().tobytes()
            for leaf in train_state_leaves(state)}


def jax_bytes(state):
    """{keystr path: leaf bytes} of the JAX train state."""
    arrays, objects = _jax().engine._flatten_state(state)
    assert not objects
    return {path: np.asarray(leaf).tobytes() for path, leaf in arrays}


def jax_losses():
    """A ``Losses`` that is also a JAX ``TrainerCallback``."""
    base = _jax().trainer.TrainerCallback
    return type("JaxRecorder", (Losses, base), {})()


@pytest.fixture
def job(monkeypatch):
    """A unique job: its sockets and shm segments never collide, and its
    segments are removed afterwards."""
    name = f"ckpt-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", name)
    yield name
    for path in glob.glob(f"/dev/shm/ckpt_{name}_*"):
        os.unlink(path)


@pytest.fixture
def port_saver(job):
    AsyncCheckpointSaver.start_async_saving_ckpt()
    yield AsyncCheckpointSaver
    AsyncCheckpointSaver.stop()


@pytest.fixture
def jax_saver(job):
    saver = _jax().ckpt_saver.AsyncCheckpointSaver
    saver.start_async_saving_ckpt()
    yield saver
    saver.stop()


def wait_for_saver(saver, timeout=30.0):
    deadline = time.monotonic() + timeout
    while saver.get_ckpt_saver() is None:
        assert time.monotonic() < deadline, "saver never registered"
        time.sleep(0.05)
    return saver.get_ckpt_saver()


# ------------------------------------------------------------ format


@pytest.mark.parametrize("opt", OPTS)
def test_leaf_paths_dtypes_shapes_match_jax(opt, job):
    """The port flattens its train state to the JAX engine's leaves: the
    same keystr paths, in the same order, with the same dtype names and
    shapes; the JAX engine's ``_flatten_state`` is the reference."""
    jt, tt = jax_trainer(opt), port_trainer(opt)
    arrays, _ = _jax().engine._flatten_state(jt.state)
    want = [(p, str(np.asarray(x).dtype), tuple(np.shape(x)))
            for p, x in arrays]
    leaves, objects = port_engine._flatten_state(tt.state)
    got = [(leaf.path, port_engine.DTYPE_NAMES[leaf.dtype], leaf.shape)
           for leaf in leaves]
    assert got == want and not objects


@pytest.mark.parametrize("opt", OPTS)
def test_jax_save_restores_in_port(opt, job, tmp_path):
    """A JAX Trainer persists step 2; a fresh port Trainer restores it:
    every leaf bit-identical to the JAX state's, and the next step's loss
    within LOSS_TOL of JAX's."""
    data = batches()
    jt = jax_trainer(opt, str(tmp_path), persist_every=2)
    jt.fit(iter(data[:2]), steps=2)
    want = jax_bytes(jt.state)
    tt = port_trainer(opt, str(tmp_path), seed=1)
    assert tt.restore() == 2
    stats = tt.checkpointer.engine.last_restore_stats
    assert stats["source"] == "storage" and stats["step"] == 2
    assert port_bytes(tt.state) == want
    j_cb, t_cb = jax_losses(), Losses()
    jt._callbacks, tt._callbacks = [j_cb], [t_cb]
    jt.fit(iter(data[2:3]), steps=3, start_step=2)
    tt.fit(iter(data[2:3]), steps=3, start_step=2)
    np.testing.assert_allclose(t_cb.values, j_cb.values, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    jt.close()
    tt.close()


@pytest.mark.parametrize("opt", OPTS)
def test_port_save_restores_in_jax(opt, job, tmp_path):
    """The port persists step 2; the JAX engine restores it into its
    template bit for bit, and one more step on each side gives the same
    loss within LOSS_TOL."""
    data = batches()
    tt = port_trainer(opt, str(tmp_path), persist_every=2)
    tt.fit(iter(data[:2]), steps=2)
    want = port_bytes(tt.state)
    jt = jax_trainer(opt, str(tmp_path))
    assert jt.restore() == 2
    assert jax_bytes(jt.state) == want
    j_cb, t_cb = jax_losses(), Losses()
    jt._callbacks, tt._callbacks = [j_cb], [t_cb]
    jt.fit(iter(data[2:3]), steps=3, start_step=2)
    tt.fit(iter(data[2:3]), steps=3, start_step=2)
    np.testing.assert_allclose(t_cb.values, j_cb.values, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    jt.close()
    tt.close()


@pytest.mark.parametrize("opt", OPTS)
def test_meta_pickles_name_the_jax_classes(opt, job, tmp_path):
    """The port's ``.meta`` names ``dlrover_tpu.common.ckpt_meta`` and
    never the port; a process that imports only the JAX package (no
    torch) decodes it and verifies the step."""
    tt = port_trainer(opt, str(tmp_path), persist_every=2)
    tt.fit(iter(batches()[:2]), steps=2)
    tt.close()
    meta = tmp_path / "checkpoint-2" / "shard_0.meta"
    raw = meta.read_bytes()
    assert b"dlrover_tpu_torch" not in raw
    assert b"dlrover_tpu.common.ckpt_meta" in raw
    code = (
        "import pickle, sys\n"
        "from dlrover_tpu.common import ckpt_persist, storage\n"
        f"m = pickle.loads(open({str(meta)!r}, 'rb').read())\n"
        "ok, why = ckpt_persist.verify_step(storage.PosixDiskStorage(), "
        f"{str(tmp_path)!r}, 2)\n"
        "assert 'torch' not in sys.modules, 'torch was imported'\n"
        "print(type(m).__module__, m.step, len(m.tensors), ok, why)\n"
    )
    from tests.conftest import cpu_subprocess_env

    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=cpu_subprocess_env())
    assert out.returncode == 0, out.stderr
    n = len(train_state_leaves(tt.state))
    assert out.stdout.split() == ["dlrover_tpu.common.ckpt_meta", "2",
                                  str(n), "True", "ok"]


# ------------------------------------------------------------ agent protocol


@pytest.mark.parametrize("opt", OPTS)
def test_jax_saver_persists_and_flushes_a_port_engine(opt, jax_saver,
                                                      tmp_path):
    """The JAX package's agent saver takes a port engine's registration,
    persists its DISK save (step 2) and, after the trainer stops, flushes
    its last memory snapshot (step 3), which a fresh port Trainer
    restores bit for bit."""
    tt = port_trainer(opt, str(tmp_path), persist_every=2)
    assert tt.checkpointer.engine.agent_mode
    tt.fit(iter(batches()[:3]), steps=3)
    assert tt.checkpointer.wait_persisted(2, timeout=60)
    tt.checkpointer.engine.wait_staged()
    want = port_bytes(tt.state)
    wait_for_saver(jax_saver).save_shm_to_storage()
    storage = PosixDiskStorage()
    assert ckpt_persist.read_tracker(storage, str(tmp_path)) == 3
    tt.close()
    jax_saver.stop()
    fresh = port_trainer(opt, str(tmp_path), seed=1)
    assert not fresh.checkpointer.engine.agent_mode
    assert fresh.restore() == 3
    assert port_bytes(fresh.state) == want
    fresh.close()


@pytest.mark.parametrize("opt", OPTS)
def test_port_saver_persists_and_flushes_a_jax_engine(opt, port_saver,
                                                      tmp_path):
    """The port's agent saver takes a JAX engine's registration, persists
    its DISK save (step 2) and flushes its last memory snapshot (step 3);
    a port Trainer restores that step bit for bit."""
    jt = jax_trainer(opt, str(tmp_path), persist_every=2)
    engine = jt._ckpt.engine
    assert engine.agent_mode
    jt.fit(iter(batches()[:2]), steps=2)
    # The JAX engine skips a memory snapshot asked for while an earlier
    # one still stages (engine.py's save_to_memory_async): step 1's
    # staging, which a loaded host can leave in flight past step 3, is
    # joined before step 3 asks for the snapshot the flush persists.
    engine.wait_staged()
    jt.fit(iter(batches()[2:3]), steps=3, start_step=2)
    assert engine.wait_persisted(2, timeout=60)
    engine.wait_staged()
    want = jax_bytes(jt.state)
    wait_for_saver(port_saver).save_shm_to_storage()
    assert ckpt_persist.read_tracker(PosixDiskStorage(), str(tmp_path)) == 3
    jt.close()
    port_saver.stop()
    tt = port_trainer(opt, str(tmp_path))
    assert tt.restore() == 3
    assert port_bytes(tt.state) == want
    tt.close()


# ------------------------------------------------------------ crash, restore

CHILD = r'''
import sys, time
import numpy as np, torch
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.train.trainer import Trainer, TrainerCallback

mode, ckpt_dir, out, kill_at, steps = sys.argv[1:6]
kill_at, steps = int(kill_at), int(steps)
torch.set_num_threads(1)  # CPU math that repeats from run to run
rng = np.random.default_rng(7)
data = [rng.integers(0, 256, (4, 32), dtype=np.int32) for _ in range(steps)]


class Record(TrainerCallback):
    def on_step_end(self, trainer, step, metrics):
        with open(out, "a") as f:
            f.write(f"{step} {float(metrics['loss'])!r}\n")
        if mode == "crash" and step == kill_at:
            trainer.checkpointer.engine.wait_staged()
            open(out + ".ready", "w").close()
            time.sleep(600)  # SIGKILLed here


model = GPT(GPTConfig(vocab_size=256, max_seq_len=64, num_layers=2,
                      num_heads=2, d_model=32, dtype=torch.float32,
                      attn_impl="xla"),
            device="cpu", generator=torch.Generator().manual_seed(0))
trainer = Trainer(model, adamw(1e-3), lambda m, p, b: loss_fn(m(b), b),
                  data[0], device="cpu", callbacks=[Record()],
                  checkpoint_dir="" if mode == "ref" else ckpt_dir,
                  persist_every=1000)
start = trainer.restore()
trainer.fit(iter(data[start:]), steps=steps, start_step=start)
trainer.close()
'''


def test_crash_and_resume_repeats_the_losses(port_saver, tmp_path):
    """A child trains with a memory snapshot every step and no disk save;
    it is SIGKILLed after step 4; the parent's saver flushes the last
    snapshot; a new child resumes from disk at step 4 and its three
    losses equal an uninterrupted run's, bit for bit."""
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    ckpt_dir = tmp_path / "ckpt"
    # One thread, and MKL's reproducible mode: the CPU's matmuls and
    # reductions otherwise pick their partition by the machine's load,
    # which moves the last bits of a loss from one process to the next.
    env = dict(os.environ, PYTHONPATH=REPO, MKL_CBWR="COMPATIBLE",
               OMP_NUM_THREADS="1")

    def run(mode, out, wait=True):
        args = [sys.executable, str(script), mode, str(ckpt_dir), str(out),
                "4", "7"]
        # The log goes to a file: a pipe nobody drains could fill.
        with open(f"{out}.log", "w") as err:
            proc = subprocess.Popen(args, env=env, stdout=subprocess.DEVNULL,
                                    stderr=err)
        if wait:
            proc.wait(timeout=120)
            assert proc.returncode == 0, open(f"{out}.log").read()
        return proc

    def losses(out):
        return dict(line.split() for line in out.read_text().splitlines())

    ref = tmp_path / "ref.txt"
    run("ref", ref)
    crashed = tmp_path / "crash.txt"
    proc = run("crash", crashed, wait=False)
    deadline = time.monotonic() + 120
    while not os.path.exists(str(crashed) + ".ready"):
        assert proc.poll() is None, open(f"{crashed}.log").read()
        assert time.monotonic() < deadline, "child never reached step 4"
        time.sleep(0.05)
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    storage = PosixDiskStorage()
    assert ckpt_persist.read_tracker(storage, str(ckpt_dir)) is None
    wait_for_saver(port_saver).save_shm_to_storage()
    assert ckpt_persist.read_tracker(storage, str(ckpt_dir)) == 4
    port_saver.stop()
    resumed = tmp_path / "resumed.txt"
    run("resume", resumed)
    got = losses(resumed)
    assert sorted(got, key=int) == ["5", "6", "7"]
    want = losses(ref)
    assert got == {k: want[k] for k in got}


@pytest.fixture
def one_thread():
    """CPU math that repeats bit for bit between two trainers: one
    thread, so no partition follows the machine's load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fresh_adamw_restores_before_its_first_step(job, tmp_path,
                                                    one_thread):
    """Torch AdamW builds its state at its first step; the port lays it
    out from step 0, so a fresh Trainer restores into it, and the two
    trainers then take the same step bit for bit."""
    data = batches()
    a = port_trainer("adamw", str(tmp_path), persist_every=2)
    a.fit(iter(data[:2]), steps=2)
    b = port_trainer("adamw", str(tmp_path), seed=1)
    opt = b.state["opt"]
    assert all(len(s) == 3 for s in opt.state.values())  # materialized
    assert all(float(s["step"]) == 0 for s in opt.state.values())
    assert b.restore() == 2
    assert port_bytes(b.state) == port_bytes(a.state)
    ca, cb = Losses(), Losses()
    a._callbacks, b._callbacks = [ca], [cb]
    a.fit(iter(data[2:3]), steps=3, start_step=2)
    b.fit(iter(data[2:3]), steps=3, start_step=2)
    assert ca.values == cb.values
    assert port_bytes(b.state) == port_bytes(a.state)
    a.close()
    b.close()


def test_flipped_byte_is_caught_and_quarantined(job, tmp_path):
    """A byte flipped inside the newest step's bin fails its stripe
    checksum in the port's reader: restore quarantines that step, says
    why, and falls back to the step before."""
    data = batches()
    tt = port_trainer("adamw", str(tmp_path), persist_every=2)
    tt.fit(iter(data[:2]), steps=2)
    at_2 = port_bytes(tt.state)
    tt.fit(iter(data[2:4]), steps=4, start_step=2)
    tt.close()
    storage = PosixDiskStorage()
    assert ckpt_persist.verify_step(storage, str(tmp_path), 4) == (True, "ok")
    path = tmp_path / "checkpoint-4" / "shard_0.bin"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    path.write_bytes(bytes(raw))
    ok, why = ckpt_persist.verify_step(storage, str(tmp_path), 4)
    assert not ok and "checksum mismatch" in why
    fresh = port_trainer("adamw", str(tmp_path), seed=1)
    assert fresh.restore() == 2
    stats = fresh.checkpointer.engine.last_restore_stats
    assert stats["fallback_from"] == 4
    assert "checksum mismatch" in stats["fallback_reason"]
    assert ckpt_persist.is_quarantined(storage, str(tmp_path), 4)
    assert port_bytes(fresh.state) == at_2
    fresh.close()


def test_memory_restore_prefers_a_newer_disk_step(job, tmp_path):
    """An engine restores its memory snapshot when no newer step is
    committed; once a newer one is (another trainer persisted it), it
    restores that step from disk."""
    data = batches()
    a = port_trainer("adamw", str(tmp_path), persist_every=100)
    a.fit(iter(data[:3]), steps=3)
    want = port_bytes(a.state)
    step, _ = a.checkpointer.load_checkpoint(a.state)
    assert step == 3 and a.checkpointer.engine.last_restore_stats[
        "source"] == "memory"
    assert port_bytes(a.state) == want
    b = port_trainer("adamw", str(tmp_path), persist_every=4, seed=1)
    b.fit(iter(data[:4]), steps=4)
    step, _ = a.checkpointer.load_checkpoint(a.state)
    assert step == 4 and a.checkpointer.engine.last_restore_stats[
        "source"] == "storage"
    assert port_bytes(a.state) == port_bytes(b.state)
    a.close()
    b.close()


def test_pickles_refuse_foreign_globals():
    """The port decodes metas without trusting them: a pickle naming any
    global outside the metas' classes and a few builtins raises."""
    from dlrover_tpu_torch.common import ckpt_meta

    with pytest.raises(pickle.UnpicklingError, match="may not name"):
        ckpt_meta.loads(pickle.dumps(os.system))
    meta = ckpt_meta.ShardMeta(step=3, mesh_axes={"data": 1},
                               objects={"x": 1.5, "y": complex(1, 2)})
    assert ckpt_meta.loads(ckpt_meta.dumps(meta)) == meta


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the staging path is CUDA streams "
                    "and a registered mapping)")
    return torch.device("cuda")


def _clone(state):
    """{path: bytes tensor on the card}, copied on the compute stream."""
    return {leaf.path: leaf_bytes(leaf).clone()
            for leaf in train_state_leaves(state)}


def _snapshot_equals(engine, want) -> bool:
    step, views = engine.memory_leaves()
    return step >= 0 and set(views) == set(want) and all(
        torch.equal(views[p].to(want[p].device), want[p]) for p in want)


@pytest.mark.gpu
def test_cuda_snapshot_restores_bit_for_bit_and_catches_a_race(
        cuda_device, tmp_path, monkeypatch):
    """On the card: the snapshot goes through the registered mapping;
    memory and disk restores into fresh Trainers are bit-identical to
    clones taken at their steps; and the bit-for-bit check catches a
    planted race: the device copy's event recorded before the copy, so
    the waits on it (the side stream's and the staging thread's) pass
    while the compute stream is held up and the copy has not run."""
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"gpu-{uuid.uuid4().hex[:8]}")
    data = batches()
    a = port_trainer("adam8bit", str(tmp_path), persist_every=2,
                     device="cuda")
    engine = a.checkpointer.engine
    try:
        a.fit(iter(data[:2]), steps=2)
        at_2 = _clone(a.state)
        a.fit(iter(data[2:3]), steps=3, start_step=2)
        at_3 = _clone(a.state)
        assert engine.registered
        assert _snapshot_equals(engine, at_3)
        b = port_trainer("adam8bit", str(tmp_path), device="cuda", seed=1)
        assert engine.load(b.state)[0] == 3
        assert engine.last_restore_stats["source"] == "memory"
        got = _clone(b.state)
        assert got.keys() == at_3.keys()
        assert all(torch.equal(got[p], at_3[p]) for p in at_3)
        c = port_trainer("adam8bit", str(tmp_path), device="cuda", seed=2)
        assert c.restore() == 2
        assert all(torch.equal(_clone(c.state)[p], at_2[p]) for p in at_2)

        def step_then_snapshot(step):
            a.train_step(a.state, torch.from_numpy(data[step]).cuda())
            want = _clone(a.state)
            torch.cuda._sleep(200_000_000)  # holds the compute stream
            assert engine.save_to_memory_async(step + 1, a.state)
            engine.wait_staged()
            return _snapshot_equals(engine, want)

        assert step_then_snapshot(3)

        def event_too_early(self, plan, leaves):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=plan.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            end.record()  # planted: recorded before the copy it marks
            torch.cuda._sleep(200_000_000)  # the copy comes late
            port_engine._copy_groups(plan, plan.stage_views,
                                     port_engine._members(leaves))
            return start, end

        monkeypatch.setattr(port_engine.CheckpointEngine, "_own_copies",
                            event_too_early)
        assert not step_then_snapshot(4)
        for t in (b, c):
            t.close()
    finally:
        a.close()
        from dlrover_tpu_torch.common.shared_memory import SharedMemory

        SharedMemory.remove(engine.shm_name)
