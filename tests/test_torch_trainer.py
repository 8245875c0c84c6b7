"""The port's Trainer against the JAX package's, and the loop's pieces.

Both trainers start from the same parameters (the JAX trainer's, carried
across with ``models/convert.py``), see the same numpy batches and use
AdamW with optax's defaults, on one device each (the port on the CPU).
"""

import logging

import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.accel import ParallelSpec as JaxSpec
from dlrover_tpu.models.gpt import GPT as JaxGPT
from dlrover_tpu.models.gpt import GPTConfig as JaxConfig
from dlrover_tpu.models.gpt import loss_fn as jax_loss
from dlrover_tpu.train.trainer import Trainer as JaxTrainer
from dlrover_tpu.train.trainer import TrainerCallback as JaxCallback
from dlrover_tpu_torch import train as ttrain
from dlrover_tpu_torch.accel import ParallelSpec, auto_accelerate
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.models.convert import params_from_flax
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.train.data import DevicePrefetchIterator
from dlrover_tpu_torch.train.metrics import DeferredMetrics, batch_token_count
from dlrover_tpu_torch.train.trainer import (
    LoggingCallback,
    Trainer,
    TrainerCallback,
)

# fp32 losses agree to summation order (1e-5). Params after three AdamW
# steps to 5e-5 absolute: a step moves a param by at most lr = 1e-3, and
# where |g| is near eps Adam's division by sqrt(v) + eps turns the
# gradients' last-bit differences into percent-level differences of
# that step.
LOSS_TOL, PARAM_TOL = 1e-5, 5e-5
BASE = dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=2,
            d_model=32, attn_impl="pallas")


def batches(n=3, b=4, s=32, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (b, s), dtype=np.int32) for _ in range(n)]


def port_loss(module, params, batch):
    return loss_fn(module(batch), batch)


def jax_token_loss(module, params, batch):
    return jax_loss(module.apply({"params": params}, batch), batch)


class Losses(TrainerCallback, JaxCallback):
    def __init__(self):
        self.values = []

    def on_step_end(self, trainer, step, metrics):
        self.values.append(float(metrics["loss"]))


def port_trainer(seed=0, state_dict=None, callbacks=(), **kw):
    model = GPT(GPTConfig(**BASE, dtype=torch.float32), device="cpu",
                generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return Trainer(model, adamw(1e-3), port_loss, batches(1)[0],
                   spec=ParallelSpec(), device="cpu", callbacks=callbacks,
                   **kw)


def test_fit_matches_jax_trainer(job_name):
    import jax
    import jax.numpy as jnp

    data = batches()
    j_cb, t_cb = Losses(), Losses()
    jt = JaxTrainer(
        JaxGPT(JaxConfig(**BASE, dtype=jnp.float32)), optax.adamw(1e-3),
        jax_token_loss, data[0], spec=JaxSpec(), callbacks=[j_cb],
    )
    init = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   jt.state["params"]))
    tt = port_trainer(state_dict=init, callbacks=[t_cb])
    j_out = jt.fit(iter(data), steps=3)
    t_out = tt.fit(iter(data), steps=3)
    assert t_out["step"] == j_out["step"] == 3
    np.testing.assert_allclose(t_cb.values, j_cb.values, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   jt.state["params"]))
    for name, value in tt.module.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=name)


def test_pipelined_and_sync_loops_are_bit_identical():
    runs = []
    for pipeline in (True, False):
        cb = Losses()
        # One fixed batch every step, so the loss must fall.
        port_trainer(callbacks=[cb]).fit(iter(batches(1) * 4), steps=4,
                                         pipeline=pipeline)
        runs.append(cb.values)
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]


def test_grad_accum_matches_one_batch():
    outs = []
    for accum in (1, 2):
        cb = Losses()
        t = port_trainer(callbacks=[cb], grad_accum=accum)
        t.fit(iter(batches()), steps=3)
        outs.append((cb.values, t.module.state_dict()))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-6, atol=1e-6)
    for name, value in outs[0][1].items():
        np.testing.assert_allclose(value.numpy(), outs[1][1][name].numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL)


def test_pipelined_metrics_are_lag1():
    seen = []

    class Keep(TrainerCallback):
        def on_step_end(self, trainer, step, metrics):
            seen.append(dict(metrics))

    t = port_trainer(callbacks=[Keep()])
    t.fit(iter(batches()), steps=3)
    assert t.phase_breakdown.stats["compute_s"].count == 3
    assert seen[0]["loss_lag1"] is None
    assert seen[1]["loss_lag1"] == float(seen[0]["loss"])
    assert all(m["tokens_per_s"] > 0 for m in seen)


def test_evaluate_takes_no_gradients():
    t = port_trainer()
    out = t.evaluate(iter(batches(4)), max_batches=2)
    assert out["eval_batches"] == 2 and np.isfinite(out["eval_loss"])
    assert all(p.grad is None for p in t.module.parameters())


def test_fit_interleaves_eval():
    evals = []

    class Keep(TrainerCallback):
        def on_evaluate(self, trainer, step, metrics):
            evals.append((step, metrics["eval_batches"]))

    out = port_trainer(callbacks=[Keep()]).fit(
        iter(batches(3)), steps=3, eval_batches=lambda: iter(batches(2)),
        eval_every=2,
    )
    assert evals == [(2, 2), (3, 2)]
    assert np.isfinite(out["eval_loss"])


def test_fit_stops_when_data_runs_out():
    out = port_trainer().fit(iter(batches(2)), steps=5)
    assert out["step"] == 2


def test_update_and_apply_branch():
    class FusedSGD:
        def __init__(self, lr):
            self.lr = lr
            self.calls = 0

        def update_and_apply(self, grads, params):
            self.calls += 1
            for g, p in zip(grads, params):
                p.sub_(self.lr * g)

    model = GPT(GPTConfig(**BASE, dtype=torch.float32), device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = torch.from_numpy(batches(1)[0])
    port_loss(model, None, batch).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    opt = FusedSGD(0.1)
    res = auto_accelerate(model, opt, batch, port_loss, device="cpu")
    state, metrics = res.train_step(res.state, batch)
    assert opt.calls == 1 and state["step"] == 1
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), before[n] - 0.1 * grads[n])
        assert p.grad is None


@pytest.mark.parametrize("kwargs", [
    dict(precision="int8"), dict(profiler=object()),
])
def test_later_slices_raise(kwargs):
    # A checkpoint over several processes is a ShardedCheckpointer now
    # (tests/test_torch_parallel.py); int8 matmuls and the profiler's
    # trace capture still come with later slices.
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_trainer(**kwargs)


@pytest.mark.parametrize("env", [
    "DLROVER_TPU_MASTER_ADDR", "DLROVER_TPU_CHAOS",
])
def test_master_and_chaos_raise(monkeypatch, env):
    monkeypatch.setenv(env, "localhost:1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_trainer()


def test_rescale_engine_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_trainer().fit(iter(batches()), steps=1, rescale_engine=object())


def test_multi_device_specs_raise():
    # A spec of several devices needs a world of as many processes (the
    # mesh branches: tests/test_torch_parallel.py); a degree of a later
    # slice raises naming it.
    model = GPT(GPTConfig(**BASE, dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="world of 2"):
        auto_accelerate(model, adamw(1e-3), batches(1)[0], port_loss,
                        spec=ParallelSpec(data=2), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        auto_accelerate(model, adamw(1e-3), batches(1)[0], port_loss,
                        spec=ParallelSpec(seq=2, tensor=2), device="cpu")


class TestDevicePrefetch:
    def test_drains_the_tail(self):
        src = [np.full((2, 3), i) for i in range(5)]
        it = DevicePrefetchIterator(iter(src), "cpu", depth=2)
        got = [int(b[0, 0]) for b in it]
        assert got == [0, 1, 2, 3, 4]
        assert it.exhausted

    def test_swap_resets_after_exhaustion(self):
        it = DevicePrefetchIterator(iter([np.zeros(2)] * 3), "cpu", depth=2)
        list(it)
        assert it.exhausted
        it2 = DevicePrefetchIterator(iter([np.ones(2)] * 5), "cpu", depth=2)
        next(it2)
        assert it2.swap(iter([np.full(2, 7.0)] * 2)) == 2
        assert not it2.exhausted and it2.swaps == 1
        assert [float(b[0]) for b in it2] == [7.0, 7.0]

    def test_structured_batches(self):
        src = [{"x": np.ones((2, 2)), "y": (np.zeros(3), np.zeros(1))}]
        batch = next(DevicePrefetchIterator(iter(src), "cpu"))
        assert isinstance(batch["x"], torch.Tensor)
        assert batch_token_count(batch) == 8

    def test_rejects_zero_depth(self):
        with pytest.raises(ValueError):
            DevicePrefetchIterator(iter([]), "cpu", depth=0)


def test_deferred_metrics_lag1():
    d = DeferredMetrics()
    assert d.push(1, {"loss": torch.tensor(2.0)}) is None
    assert d.push(2, {"loss": torch.tensor(3.0)}) == (1, {"loss": 2.0})
    assert d.pending_step == 2
    assert d.flush() == (2, {"loss": 3.0})
    assert d.flush() is None


def test_init_training_single_process(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_PROCESS_ID", "0")
    monkeypatch.setenv("DLROVER_TPU_NUM_PROCESSES", "1")
    assert ttrain.init_training(device="cpu") == torch.device("cpu")
    assert "init_s" in ttrain.bootstrap_timings()
    assert (ttrain.global_rank(), ttrain.world_size(),
            ttrain.local_rank()) == (0, 1, 0)


def test_init_training_joins_a_gloo_group(tmp_path):
    """Two CPU processes join one group from the agent's env contract
    (a ``host:port`` coordinator) and all-reduce across it. The store at
    that address is this process's, bound to a port the system picks and
    held open, as torchrun's agent holds its own for its workers
    (``TORCHELASTIC_USE_AGENT_STORE``), so no port is freed before the
    group binds it."""
    import os
    import subprocess
    import sys

    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False)
    script = (
        "import torch, torch.distributed as dist\n"
        "from dlrover_tpu_torch.train import init_training\n"
        "dev = init_training(device='cpu')\n"
        "x = torch.tensor([dist.get_rank() + 1.0])\n"
        "dist.all_reduce(x)\n"
        "print(dev, dist.get_world_size(), float(x))\n"
        "dist.destroy_process_group()\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=repo,
                   DLROVER_TPU_COORDINATOR_ADDR=f"127.0.0.1:{store.port}",
                   TORCHELASTIC_USE_AGENT_STORE="True",
                   DLROVER_TPU_NUM_PROCESSES="2",
                   DLROVER_TPU_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["cpu", "2", "3.0"]


def test_lr_schedule_is_reported_like_jax():
    """``lr_schedule=`` (the JAX trainer's): both loops report the
    schedule's value at each finished step as ``metrics["lr"]``, and
    ``LoggingCallback`` logs it."""
    import jax.numpy as jnp
    import optax

    sched = optax.linear_schedule(1e-3, 1e-4, transition_steps=4)

    class Lrs(TrainerCallback, JaxCallback):
        def __init__(self):
            self.values = []

        def on_step_end(self, trainer, step, metrics):
            self.values.append(metrics["lr"])

    data = batches()
    j_cb, t_cb = Lrs(), Lrs()
    jt = JaxTrainer(
        JaxGPT(JaxConfig(**BASE, dtype=jnp.float32)), optax.adamw(sched),
        jax_token_loss, data[0], spec=JaxSpec(), callbacks=[j_cb],
        lr_schedule=sched,
    )
    jt.fit(iter(data), steps=3)
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    logger.addHandler(handler)
    try:
        port_trainer(callbacks=[t_cb, LoggingCallback(every=1)],
                     lr_schedule=sched).fit(iter(data), steps=3)
    finally:
        logger.removeHandler(handler)
    assert t_cb.values == j_cb.values == [float(sched(s)) for s in (1, 2, 3)]
    assert all(isinstance(v, float) for v in t_cb.values)
    assert any(m.endswith("| lr 7.75e-04") for m in logged)
