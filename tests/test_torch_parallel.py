"""The port on a mesh of gloo CPU ranks against the JAX package's mesh.

Two worlds of processes, started as torchrun starts them (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; the group meets at a file, not a port):
this file is also the worker (``python tests/test_torch_parallel.py
<inputs>``). A world of 2 trains ``ParallelSpec(data=2)``, ``(fsdp=2)``
and ``(tensor=2)`` and runs the checkpoint cases; a world of 4 trains
``(data=2, fsdp=2)``, ``(data=2, tensor=2)`` and ``(fsdp=2, tensor=2)``
(FSDP2 over the tensor-parallel DTensors) and saves and restores a
two-axis checkpoint; a world of 8 trains ``(data=2, fsdp=2,
tensor=2)`` under AdamW. Each training case is
GPT tiny or LLaMA tiny (fp32, einsum attention) under ``adamw`` or
``adam8bit``, from the JAX package's initial weights, three steps of
the same global batches on every rank; the JAX side runs as
``tests/test_accel.py`` runs it, ``auto_accelerate(spec=...)`` over the
first N of the 8 host devices, while the worlds run.

Tolerances: losses, and AdamW's parameters, within ``rtol=atol=2e-5``
of the JAX package's under the same spec and of the port's one-device
run (the JAX package's own sharded-vs-baseline tolerance,
``tests/test_accel.py``). Under the 8-bit Adam the gradients' last bits
(summed in other orders across ranks) move int8 rounds, and one round
moves a parameter by up to about the learning rate; its parameters are
held as ``tests/test_torch_optim.py``'s fit test holds them (largest and
median difference). Its moments are held to JAX's with that test's
bound on each int8 value (+-1), and with the share of flipped values
and the scales' relative difference that the JAX package shows between
its own sharded and one-device runs here: on LLaMA tiny at lr 1e-2,
data, fsdp or tensor = 2 against one device, 0.99% of int8 values
flipped and scales 3.8e-3 apart after three steps (GPT tiny: 0.08%,
4.9e-4), past the fit test's 1% and 1e-3. ``MESH_FLIP_SHARE`` and
``MESH_SCALE_REL`` are twice and about 2.6 times those.

Plain modules (``tests/test_torch_registry.py``'s torch twins of the
flax ``PlainLM`` and ``GQALM``, from the flax init) train three AdamW
steps under ``tensor=2`` (planned with ``allow_tensor=True``, and
placed by a ``registry=`` of one registered MLP pair), ``fsdp=2`` and
``fsdp=2 x tensor=2`` (planned): losses within 2e-5 of the JAX package's
``auto_accelerate`` of the flax model under the same spec and
arguments (``tests/test_tp_planner.py``'s tolerance). A vocab the
tensor degree does not divide is refused by both packages. ``ConvLM``
(a causal ``Conv1d`` and a bare parameter its registry puts on the
tensor axis) trains under ``tensor=2`` and ``fsdp=2 x tensor=2``: the
shards gathered whole in the forward, its losses and parameters JAX's
within 2e-5, a rank's checkpoint blocks its shards.

``offload_optimizer=True`` on a mesh (``OFFLOAD``: AdamW under fsdp=2,
tensor=2 and ZeRO over data=2, the 8-bit Adam under fsdp=2 and the
fp32 masters of the 8-bit Adam under ZeRO) trains bit for bit as the
same mesh without it, with state moved to the host, and is held to the
JAX package's losses of the same mesh (2e-5): JAX's offloaded step
does not run on its CPU mesh (XLA's SPMD partitioner refuses the
host-placement custom call, "Side-effect HLO must have sharding"), and
offload moves bytes, not math, so JAX's losses without it are the
reference, not its placement.

A world or process of JAX references is killed when one of its
processes fails, when none gains CPU time for ``WORLD_STALL_S`` (hung)
or at ``WORLD_DEADLINE_S`` from its start. The references start first,
on one XLA thread each, and the worlds run in two waves of at most 8
ranks beside them. A world or reference process that fails fails only
the tests that read its results, with its processes' logs.
"""

import dataclasses
import glob
import math
import os
import pickle
import shutil
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A world (or a process of JAX references) is hung when none of its
# processes gains CPU time for WORLD_STALL_S seconds, and cut at
# WORLD_DEADLINE_S seconds from its start whatever it does. On a loaded
# machine a process gets a small share of a core, so its wall time says
# little and its CPU time says whether it moves.
WORLD_STALL_S = 120
WORLD_DEADLINE_S = 900
LOSS_TOL = PARAM_TOL = 2e-5
STEPS, ROWS, SEQ = 3, 8, 16
FAMILIES = ("gpt", "llama")
OPTS = ("adamw", "adam8bit")
LR = {"adamw": 1e-3, "adam8bit": 1e-2}
MESH_FLIP_SHARE, MESH_SCALE_REL = 2e-2, 1e-2
# Twelve 8-bit Adam runs (its Pallas kernel interpreted: the slowest),
# two in each process, dealt first.
JAX_PROCS = 6
WORLD2 = ({"data": 2}, {"fsdp": 2}, {"tensor": 2})
WORLD4 = ({"data": 2, "fsdp": 2}, {"data": 2, "tensor": 2},
          {"fsdp": 2, "tensor": 2})
TWO_AXES = {"fsdp": 2, "tensor": 2}
# fsdp x tensor with data too: a world of 8, AdamW only.
WORLD8 = ({"data": 2, "fsdp": 2, "tensor": 2},)
REMAT_POLICIES = ("nothing", "dots", "dots_lite", "offload")
# Plain modules (tests/test_torch_registry.py's twins): (model, spec,
# placed by the registry rather than the planner).
# "odd_vocab": a vocab (129) the tensor degree does not divide, whose
# embedding and head JAX's rules shard all the same (no vocab guard
# for a model without cfg.vocab_size).
PLAIN_MODELS = ("mha", "gqa", "odd_vocab")
PLAIN = ([(m, {"tensor": 2}, False) for m in PLAIN_MODELS]
         + [("mha", {"tensor": 2}, True), ("mha", {"fsdp": 2}, False)]
         + [(m, {"fsdp": 2, "tensor": 2}, False) for m in PLAIN_MODELS])


# A conv and a bare parameter on the tensor axis (placed by ConvLM's
# registry): (model, spec, registry).
PLAIN_CONV = [("conv", {"tensor": 2}, True),
              ("conv", {"fsdp": 2, "tensor": 2}, True)]
# offload_optimizer=True on a world of 2: (family, optimizer, spec, the
# train case of the same mesh without it, held to JAX's offload run).
OFFLOAD = [("gpt", "adamw", {"fsdp": 2}, "gpt-adamw-fsdp2", True),
           ("gpt", "adamw", {"tensor": 2}, "gpt-adamw-tensor2", True),
           ("gpt", "adamw", {"data": 2, "zero": True}, "gpt-adamw-data2",
            False),
           ("gpt", "adam8bit", {"fsdp": 2}, "gpt-adam8bit-fsdp2", False),
           ("gpt", "bf16_adam8bit", {"data": 2, "zero": True},
            "gpt-bf16_adam8bit-data2-zero", False)]


def plain_name(model, spec, registry):
    return f"plain-{model}{'-registry' if registry else ''}-{spec_id(spec)}"


def offload_name(family, opt, spec):
    return f"offload-{family}-{opt}-{spec_id(spec)}"
REMAT_CASES = (("gpt", {"fsdp": 2}), ("llama", {"tensor": 2}))


def spec_id(spec: dict) -> str:
    return "-".join(f"{k}{v}" if k != "zero" else "zero"
                    for k, v in spec.items() if v)


def global_batches():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (ROWS, SEQ), dtype=np.int64)
            for _ in range(STEPS)]


# ------------------------------------------------------ the port side


def port_model(family: str, seed: int = 0, policy: str = "none",
               bf16: bool = False):
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig

    gen = torch.Generator().manual_seed(seed)
    remat = dict(remat=policy != "none",
                 remat_policy="nothing" if policy == "none" else policy)
    if bf16:
        remat["param_dtype"] = torch.bfloat16
    if family == "gpt":
        cfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32,
                                  **remat)
        return GPT(cfg, device="cpu", generator=gen)
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                              **remat)
    return Llama(cfg, device="cpu", generator=gen)


def port_loss(module, params, batch):
    from dlrover_tpu_torch.models.gpt import loss_fn

    return loss_fn(module(batch), batch)


def port_opt(opt: str):
    from dlrover_tpu_torch.optim import adam8bit, adamw, bf16_master_weights

    if opt == "bf16_adam8bit":
        return bf16_master_weights(adam8bit(LR["adam8bit"]))
    return adamw(LR[opt]) if opt == "adamw" else adam8bit(LR[opt])


def port_train(family, opt, spec: dict, init=None, offload=False):
    """Three steps of the global batches under ``spec`` (one device when
    empty): losses, the whole parameters, the 8-bit Adam state (numpy,
    JAX's layout) and, on a mesh, what this rank holds; offloaded, the
    bytes of state moved and whether they lie on the host."""
    from dlrover_tpu_torch.accel import ParallelSpec, auto_accelerate
    from dlrover_tpu_torch.accel import sharding
    from dlrover_tpu_torch.models import convert

    model = port_model(family, bf16=opt.startswith("bf16"))
    if init is not None:
        model.load_state_dict(convert.params_from_flax(init))
    batches = global_batches()
    res = auto_accelerate(model, port_opt(opt), batches[0], port_loss,
                          spec=ParallelSpec(**spec), device="cpu",
                          offload_optimizer=offload)
    local = {n: tuple(sharding.local(p).shape)
             for n, p in res.state["params"].items()}
    heads = {type(m).__name__: (m.heads, getattr(m, "kv_heads", None))
             for m in res.module.modules() if hasattr(m, "tp_group")}
    losses = []
    for b in batches:
        _, metrics = res.train_step(res.state, torch.from_numpy(
            res.local_batch(b)))
        losses.append(float(metrics["loss"]))
    with torch.no_grad():
        full = {n: sharding.gather_full(p, sharding.layout_of(p), p.shape)
                .float().numpy().copy()
                for n, p in res.state["params"].items()}
    opt_state = None
    if opt == "adam8bit" and not offload:
        opt_state = convert.adam8bit_state_to_flax(res.state["opt"].state)
    out = {"losses": losses, "params": full, "adam8": opt_state,
           "local": local, "heads": heads,
           "global": {n: tuple(p.shape)
                      for n, p in res.state["params"].items()}}
    if offload:
        opt = res.state["opt"]
        out["moved"] = opt.nbytes
        out["on_host"] = all(t.device.type == "cpu" and t.data_ptr() ==
                             h.data_ptr() for t, h in zip(opt.moved,
                                                          opt._host))
        out["inner"] = type(opt.inner).__name__
        out["copies"] = opt.take_copy_stats()
    return out


def plain_batches():
    rng = np.random.default_rng(17)
    return [rng.integers(0, 128, (ROWS, SEQ), dtype=np.int64)
            for _ in range(STEPS)]


def port_plain_train(model, spec: dict, init, registry: bool):
    """A plain twin from the flax ``init``, placed by the planner
    (``allow_tensor=True``) or by ``port_registry(model)``: three AdamW
    steps of ``plain_batches``; the losses, what this rank holds and the
    roles of its layers, the whole bias of each row-parallel layer
    (which the tensor ranks hold replicated), the whole parameters, and
    this rank's checkpoint blocks of the conv's and ``gain``'s leaves."""
    from dlrover_tpu_torch.accel import ParallelSpec, auto_accelerate
    from dlrover_tpu_torch.accel import sharding
    from dlrover_tpu_torch.models.convert import plain_from_flax
    from test_torch_registry import port_registry, token_loss, torch_model

    twin = torch_model(model)
    twin.load_state_dict(plain_from_flax(init, twin))
    batches = plain_batches()
    res = auto_accelerate(twin, port_opt("adamw"), batches[0], token_loss,
                          spec=ParallelSpec(**spec), device="cpu",
                          allow_tensor=not registry,
                          registry=port_registry(model) if registry else None)
    losses = []
    for b in batches:
        _, metrics = res.train_step(res.state, torch.from_numpy(
            res.local_batch(b)))
        losses.append(float(metrics["loss"]))
    params = res.state["params"]
    with torch.no_grad():
        row_bias = {
            f"{n}.bias": sharding.gather_full(
                params[f"{n}.bias"], sharding.layout_of(params[f"{n}.bias"]),
                params[f"{n}.bias"].shape).numpy().copy()
            for n, m in res.module.named_modules()
            if getattr(m, "role", None) == "row" and m.bias is not None}
    from torch.distributed.fsdp import FSDPModule

    with torch.no_grad():
        whole = {n: sharding.gather_full(p, sharding.layout_of(p), p.shape)
                 .numpy().copy() for n, p in params.items()}
    return {"losses": losses, "row_bias": row_bias, "params": whole,
            "conv_blocks": [b for b in blocks_of(res.state)
                            if "conv" in b[0] or "gain" in b[0]],
            "fsdp_units": sorted(n for n, m in res.module.named_modules()
                                 if isinstance(m, FSDPModule)),
            "local": {n: tuple(sharding.local(p).shape)
                      for n, p in res.state["params"].items()},
            "global": {n: tuple(p.shape)
                       for n, p in res.state["params"].items()},
            "roles": {n: m.role for n, m in res.module.named_modules()
                      if hasattr(m, "role")}}


def blocks_of(state):
    """This rank's checkpoint blocks: (path, index, global shape, shape,
    dtype, persist, bytes) each."""
    from dlrover_tpu_torch.models.convert import leaf_bytes, \
        train_state_leaves

    return [(leaf.path, leaf.index, leaf.global_shape, tuple(leaf.shape),
             leaf.dtype, leaf.persist,
             leaf_bytes(leaf).cpu().numpy().tobytes())
            for leaf in train_state_leaves(state)]


def assemble(ranks_blocks):
    """{path: bytes of the whole leaf} from every rank's blocks."""
    full = {}
    for blocks in ranks_blocks:
        for path, index, gshape, shape, dtype, _, raw in blocks:
            size = torch.empty((), dtype=dtype).element_size()
            u = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[size]
            gshape = tuple(gshape or shape)
            arr = full.setdefault(path, np.zeros(gshape, dtype=u))
            block = np.frombuffer(raw, dtype=u).reshape(shape)
            if index is None:
                arr[...] = block
            else:
                arr[tuple(slice(a, b) for a, b in index)] = block
    return {p: a.tobytes() for p, a in full.items()}


def ckpt_trainer(family, opt, spec, ckpt_dir, seed=0):
    from dlrover_tpu_torch.accel import ParallelSpec
    from dlrover_tpu_torch.train.trainer import Trainer

    return Trainer(port_model(family, seed), port_opt(opt), port_loss,
                   global_batches()[0], spec=ParallelSpec(**spec),
                   device="cpu", checkpoint_dir=ckpt_dir, persist_every=2,
                   report_metrics=False)


# ------------------------------------------------------ worker cases


def case_train(case, inputs):
    return port_train(case["family"], case["opt"], case["spec"],
                      inputs["init"][case["family"]])


def case_save(case, inputs):
    """Train 2 steps and persist step 2 (``persist_every=2``); then a
    fresh trainer of another seed restores it, and one more step runs on
    both: the restored blocks and the next losses. A rank returns from
    ``fit`` once its own shard is written, shard 0 once it has committed
    the step: the barrier keeps every restore behind the commit (a
    restore that finds shard 0's meta missing quarantines the step)."""
    import torch.distributed as dist

    t = ckpt_trainer("gpt", case["opt"], case["spec"], case["dir"])
    t.fit(iter(global_batches()[:2]), steps=2, start_step=0)
    saved = blocks_of(t.state)
    dist.barrier()
    fresh = ckpt_trainer("gpt", case["opt"], case["spec"], case["dir"],
                         seed=5)
    step = fresh.restore()
    restored = blocks_of(fresh.state)
    nxt = []
    batch = global_batches()[2]
    for tr in (t, fresh):
        _, m = tr.train_step(tr.state, torch.from_numpy(
            tr._result.local_batch(batch)))
        nxt.append(float(m["loss"]))
    t.close()
    fresh.close()
    return {"saved": saved, "restored": restored, "step": step,
            "next": nxt}


def case_restore(case, inputs):
    """Restore a checkpoint another topology (or package) saved."""
    t = ckpt_trainer("gpt", case["opt"], case["spec"], case["dir"], seed=5)
    step = t.restore()
    out = {"step": step, "restored": blocks_of(t.state)}
    t.close()
    return out


def case_remat(case, inputs):
    """Each remat policy's losses under ``spec`` (the recompute runs
    inside FSDP2's and the tensor collectives' backward)."""
    from dlrover_tpu_torch.accel import ParallelSpec, auto_accelerate

    out = {}
    for policy in ("none",) + REMAT_POLICIES:
        res = auto_accelerate(port_model(case["family"], policy=policy),
                              port_opt("adamw"), global_batches()[0],
                              port_loss, spec=ParallelSpec(**case["spec"]),
                              device="cpu")
        out[policy] = [float(res.train_step(res.state, torch.from_numpy(
            res.local_batch(b)))[1]["loss"]) for b in global_batches()[:2]]
    return out


def case_agent_save(case, inputs):
    """Under an agent's saver (in the test's process, serving this
    node's two local ranks): persist step 2 and wait for its commit."""
    t = ckpt_trainer("gpt", "adamw", case["spec"], case["dir"])
    assert t.checkpointer.engine.agent_mode
    t.fit(iter(global_batches()[:2]), steps=2, start_step=0)
    assert t.checkpointer.wait_persisted(2, timeout=60)
    out = {"saved": blocks_of(t.state)}
    t.close()
    return out


def case_plain(case, inputs):
    """A plain model's run; a placement the port refuses (a dim the
    tensor degree does not divide), its error."""
    try:
        return port_plain_train(case["model"], case["spec"],
                                inputs["plain_init"][case["model"]],
                                case["registry"])
    except ValueError as e:
        return {"refused": str(e)}


def case_offload(case, inputs):
    return port_train(case["family"], case["opt"], case["spec"],
                      inputs["init"].get(case["family"])
                      if case["opt"] != "bf16_adam8bit" else None,
                      offload=case.get("offload", True))


CASES = {"train": case_train, "save": case_save, "restore": case_restore,
         "remat": case_remat, "agent_save": case_agent_save,
         "plain": case_plain, "offload": case_offload}


def worker(path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    join_world()
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    from dlrover_tpu_torch.models import gpt, llama

    # What the attention of each block sees: its local heads.
    seen = []
    attention = gpt._attention

    def spy(q, k, v, cfg, *seq_group):
        seen.append(q.shape[2])
        return attention(q, k, v, cfg, *seq_group)

    gpt._attention = llama._attention = spy
    rank = int(os.environ["RANK"])
    out = {}
    for case in inputs["cases"]:
        seen.clear()
        out[case["name"]] = CASES[case["kind"]](case, inputs)
        out[case["name"]]["attn_heads"] = sorted(set(seen))
    with open(f"{path}.rank{rank}", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------ spawning


def join_world():
    """A worker joins the gloo group of its ``World``: ranks meet at the
    file the world names (``WORLD_INIT``), so no port is picked and
    freed for the group to bind later, when another process may hold
    it."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=os.environ["WORLD_INIT"],
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


def cpu_ticks(pids):
    """The CPU time the processes have used (user + system clock ticks,
    from ``/proc``); None where it cannot be read."""
    total = 0
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            total += int(fields[11]) + int(fields[12])
        except (OSError, IndexError, ValueError):
            return None
    return total


class WorldFailed(Exception):
    """A world's process failed, or the world hung or missed its
    deadline; the message holds every process's exit code and log
    tail."""


# XLA's flags for a JAX reference process on one thread: XLA's CPU
# client otherwise runs each op on a pool as wide as the machine, so
# the reference processes beside the gloo ranks and the other test
# workers ask for several times the cores there are.
ONE_THREAD_XLA = ("--xla_cpu_multi_thread_eigen=false "
                  "intra_op_parallelism_threads=1")


class World:
    """``n`` worker processes of ``script`` (this file by default) on
    ``inputs`` (a pickle path; ``--jax``: one process of JAX references,
    on one XLA thread with ``one_thread``); a worker joins the group with
    ``join_world`` (a file rendezvous beside the inputs); ``collect``
    waits for them, kills every process when one fails, when none gains
    CPU time for ``WORLD_STALL_S`` or at the deadline, and raises
    ``WorldFailed`` with their logs (``join``: ``pytest.fail`` with
    them)."""

    def __init__(self, n: int, inputs: str, job: str, jax_refs=False,
                 script: str = __file__, one_thread: bool = False):
        self.n, self.inputs, self.job = n, inputs, job
        self.procs, self.logs = [], []
        for r in range(n):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                       WORLD_INIT=f"file://{os.path.abspath(inputs)}.rdzv",
                       OMP_NUM_THREADS="1", DLROVER_TPU_JOB_NAME=job,
                       PYTHONPATH=REPO)
            if one_thread:
                env["XLA_FLAGS"] = " ".join(
                    (env.get("XLA_FLAGS", ""), ONE_THREAD_XLA)).strip()
            for name in ("DLROVER_TPU_PROCESS_ID", "DLROVER_TPU_NUM_PROCESSES",
                         "DLROVER_TPU_LOCAL_RANK",
                         "DLROVER_TPU_LOCAL_WORLD_SIZE", "MASTER_ADDR",
                         "MASTER_PORT"):
                env.pop(name, None)
            log = open(f"{inputs}.log{r}", "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(script)]
                + (["--jax"] if jax_refs else []) + [inputs],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
        self.t0 = time.monotonic()

    def kill(self):
        """End every process still running (a world never collected)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()

    def join(self, deadline_s: float = WORLD_DEADLINE_S):
        try:
            return self.collect(deadline_s)
        except WorldFailed as e:
            pytest.fail(str(e))

    def collect(self, deadline_s: float = WORLD_DEADLINE_S):
        why = "failed"
        try:
            cpu, moved = None, time.monotonic()
            while any(p.poll() is None for p in self.procs):
                failed = [p for p in self.procs if p.poll() not in (None, 0)]
                now = time.monotonic()
                ticks = cpu_ticks(p.pid for p in self.procs
                                  if p.poll() is None)
                if ticks is None or ticks != cpu:
                    cpu, moved = ticks, now
                if failed:
                    break
                if now - self.t0 > deadline_s:
                    why = f"missed its {deadline_s:.0f}s deadline"
                    break
                if now - moved > WORLD_STALL_S:
                    why = f"gained no CPU time for {WORLD_STALL_S}s (hung)"
                    break
                time.sleep(0.1)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for path in glob.glob(f"/dev/shm/ckpt_{self.job}_*"):
                os.unlink(path)
        codes = [p.returncode for p in self.procs]
        if any(codes):
            tails = []
            for r, log in enumerate(self.logs):
                log.seek(0)
                tails.append(f"--- rank {r} (exit {codes[r]}) ---\n"
                             + log.read()[-4000:])
            raise WorldFailed(
                f"{self.n} process(es) of {self.inputs} {why} after "
                f"{time.monotonic() - self.t0:.0f}s:\n" + "\n".join(tails))
        self.seconds = time.monotonic() - self.t0
        out = []
        for r in range(self.n):
            with open(f"{self.inputs}.rank{r}", "rb") as f:
                out.append(pickle.load(f))
        return out


# ------------------------------------------------------ the JAX side


def _jax():
    from test_torch_checkpoint import _jax as jax_modules

    return jax_modules()


def jax_model(family):
    J = _jax()
    from dlrover_tpu.models import llama as jllama

    if family == "gpt":
        return J.gpt.GPT(dataclasses.replace(J.gpt.GPTConfig.tiny(),
                                             dtype=J.jnp.float32))
    return jllama.Llama(dataclasses.replace(jllama.LlamaConfig.tiny(),
                                            dtype=J.jnp.float32))


def jax_init(family):
    """The JAX model's initial params, as ``auto_accelerate`` makes them
    (``init`` from ``PRNGKey(0)`` on the sample batch), numpy."""
    import flax.linen as nn

    J = _jax()
    variables = jax_model(family).init(
        J.jax.random.PRNGKey(0), global_batches()[0].astype(np.int32))
    return J.jax.tree_util.tree_map(np.asarray,
                                    nn.meta.unbox(variables["params"]))


def jax_refs(path):
    """A process of JAX references: ``jax_train`` of each (family, opt,
    spec) in the inputs, ``jax_plain_train`` of each plain case, pickled
    beside them."""
    with open(path, "rb") as f:
        todo = pickle.load(f)
    out = {key: (jax_plain_ref(key[1], spec, key[2]) if key[0] == "plain"
                 else jax_train(*key[:2], spec)[1:])
           for key, spec in todo}
    with open(f"{path}.rank0", "wb") as f:
        pickle.dump(out, f)


def jax_train(family, opt, spec: dict):
    """The JAX package's run under ``spec`` over the first N host
    devices: (initial params, losses, params, optimizer state), numpy."""
    J = _jax()
    from dlrover_tpu.accel import auto_accelerate
    from dlrover_tpu.models import llama as jllama

    lossf = J.gpt.loss_fn if family == "gpt" else jllama.loss_fn
    tx = (J.optax.adamw(LR[opt]) if opt == "adamw"
          else J.low_bit.adam8bit(LR[opt]))
    s = J.ParallelSpec(**spec)
    batches = [b.astype(np.int32) for b in global_batches()]
    res = auto_accelerate(
        jax_model(family), tx, batches[0],
        lambda m, p, b: lossf(m.apply({"params": p}, b), b), spec=s,
        devices=J.jax.devices()[:s.total])
    tree = J.jax.tree_util.tree_map
    state = res.state
    init = tree(np.asarray, state["params"])
    losses = []
    for b in batches:
        state, m = res.train_step(state, J.jax.device_put(
            b, res.batch_sharding))
        losses.append(float(m["loss"]))
    return init, losses, tree(np.asarray, state["params"]), \
        tree(np.asarray, state["opt"])


def jax_plain_train(model, spec: dict, registry: bool):
    """The JAX package's ``auto_accelerate`` of the flax plain model under
    ``spec`` over the first N host devices, planned (``allow_tensor``)
    or with ``jax_registry(model)``: the losses of three AdamW steps
    (``ConvLM``: and its final params, numpy)."""
    J = _jax()
    from dlrover_tpu.accel import auto_accelerate
    from test_torch_registry import flax_models, jax_loss, jax_registry

    s = J.ParallelSpec(**spec)
    batches = [b.astype(np.int32) for b in plain_batches()]
    res = auto_accelerate(
        flax_models()[model](), J.optax.adamw(LR["adamw"]), batches[0],
        jax_loss, spec=s, devices=J.jax.devices()[:s.total],
        allow_tensor=not registry,
        registry=jax_registry(model) if registry else None)
    state, losses = res.state, []
    for b in batches:
        state, m = res.train_step(state, J.jax.device_put(
            b, res.batch_sharding))
        losses.append(float(m["loss"]))
    if model == "conv":
        return losses, J.jax.tree_util.tree_map(np.asarray, state["params"])
    return losses


def jax_plain_ref(model, spec: dict, registry: bool):
    """``jax_plain_train``'s losses under ``spec``; for ``odd_vocab``,
    whose embedding and head JAX's rules shard over a tensor degree that
    does not divide them, JAX's refusal (its message)."""
    if model != "odd_vocab":
        return jax_plain_train(model, spec, registry)
    try:
        jax_plain_train(model, spec, registry)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"JAX trained {model} under {spec}")


def jax_ckpt_trainer(spec: dict, ckpt_dir: str):
    """The JAX package's Trainer of GPT tiny under ``spec``, persisting
    every 2 steps (one process: its blocks are one shard)."""
    J = _jax()

    def loss(m, p, b):
        return J.gpt.loss_fn(m.apply({"params": p}, b), b)

    return J.trainer.Trainer(
        jax_model("gpt"), J.optax.adamw(LR["adamw"]), loss,
        global_batches()[0].astype(np.int32), spec=J.ParallelSpec(**spec),
        checkpoint_dir=ckpt_dir, persist_every=2)


# ------------------------------------------------------ the runs


class Held(dict):
    """Results by key. A key whose producer (a world, or a process of
    JAX references) failed raises that failure, with its processes'
    logs, where a test reads it: a failed world fails only the tests
    that read it."""

    def __init__(self):
        super().__init__()
        self.failures = {}

    def __getitem__(self, key):
        if key in self.failures:
            pytest.fail(self.failures[key])
        return super().__getitem__(key)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worlds, the JAX references and the checkpoints they share."""
    from test_torch_checkpoint import jax_bytes, port_bytes

    root = tmp_path_factory.mktemp("mesh")
    job = f"mesh-{uuid.uuid4().hex[:8]}"
    old_job = os.environ.get("DLROVER_TPU_JOB_NAME")
    os.environ["DLROVER_TPU_JOB_NAME"] = job + "-main"
    try:
        yield _runs(root, job, jax_bytes, port_bytes)
    finally:
        if old_job is None:
            os.environ.pop("DLROVER_TPU_JOB_NAME", None)
        else:
            os.environ["DLROVER_TPU_JOB_NAME"] = old_job
        for path in glob.glob(f"/dev/shm/ckpt_{job}*"):
            os.unlink(path)


#: The checkpoint dirs each world writes (the others are written here).
WRITES = {"w2": ("fsdp", "fsdp8", "tensor", "data"), "w4": ("fsdp_tensor",),
          "agent": ("agent",), "w8": ()}


def _runs(root, job, jax_bytes, port_bytes):
    """The JAX references start first, in ``JAX_PROCS`` processes on one
    XLA thread each: they take two to three times as long as the
    largest world. The worlds run in two waves of at most 8 ranks (2 +
    4 + 2, then 8) beside them, so the ranks, the references and this
    process ask for about the machine's cores, not several times them.
    Each world and each reference process is collected on its own: one
    that fails (or hangs, or misses ``WORLD_DEADLINE_S``) fails the
    tests that read its results (``Held``), not the module."""
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common.comm import clear_job_sockets

    out = Held()
    out["jax"], out["one"], out["dirs"] = Held(), {}, Held()
    # The JAX references, the slowest first (the 8-bit Adam's Pallas
    # kernel is interpreted, LLaMA compiles longest), dealt out in turns.
    todo = [((fam, opt, spec_id(spec)), spec) for opt in OPTS[::-1]
            for fam in FAMILIES[::-1] for spec in WORLD2 + WORLD4]
    todo += [((fam, "adamw", spec_id(spec)), spec) for fam in FAMILIES
             for spec in WORLD8]
    todo += [(("plain", m, r, spec_id(spec)), spec)
             for m, spec, r in PLAIN + PLAIN_CONV]
    refs, worlds = [], []
    try:
        for k in range(JAX_PROCS):
            path = str(root / f"jax{k}.pkl")
            with open(path, "wb") as f:
                pickle.dump(todo[k::JAX_PROCS], f)
            refs.append((World(1, path, f"{job}-j{k}", jax_refs=True,
                               one_thread=True),
                         [key for key, _ in todo[k::JAX_PROCS]]))
        _worlds_and_checkpoints(root, job, out, worlds, jax_bytes,
                                port_bytes)
        for world, keys in refs:
            try:
                out["jax"].update(world.collect()[0])
            except WorldFailed as e:
                out["jax"].failures.update(dict.fromkeys(keys, str(e)))
    finally:
        for world, _ in refs:
            world.kill()
        for world in worlds:
            world.kill()
        AsyncCheckpointSaver.stop()
        clear_job_sockets(f"{job}-agent")
    return out


def _worlds_and_checkpoints(root, job, out, worlds, jax_bytes, port_bytes):
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver

    # The JAX package's initial weights (the same under every spec).
    init = {f: jax_init(f) for f in FAMILIES}
    from test_torch_registry import flax_init

    plain_init = {m: flax_init(m, plain_batches()[0].astype(np.int32))[1]
                  for m in PLAIN_MODELS + ("conv",)}
    dirs = {k: str(root / k) for k in ("fsdp", "fsdp8", "one", "tensor",
                                       "data", "jax_fsdp", "agent",
                                       "fsdp_tensor", "jax_fsdp_tensor")}
    out["dirs"].update(dirs)
    # Checkpoints the worlds restore: one device (port) and fsdp=2 (JAX).
    t = ckpt_trainer("gpt", "adamw", {}, dirs["one"])
    t.fit(iter(global_batches()[:2]), steps=2, start_step=0)
    out["one_ckpt"] = port_bytes(t.state)
    t.close()
    jt = jax_ckpt_trainer({"fsdp": 2}, dirs["jax_fsdp"])
    jt.fit(iter(b.astype(np.int32) for b in global_batches()[:2]), steps=2,
           start_step=0)
    out["jax_fsdp_ckpt"] = jax_bytes(jt.state)
    jt.close()
    jt = jax_ckpt_trainer(TWO_AXES, dirs["jax_fsdp_tensor"])
    jt.fit(iter(b.astype(np.int32) for b in global_batches()[:2]), steps=2,
           start_step=0)
    out["jax_fsdp_tensor_ckpt"] = jax_bytes(jt.state)
    jt.close()

    def train_cases(specs):
        return [dict(kind="train", name=f"{fam}-{opt}-{spec_id(s)}",
                     family=fam, opt=opt, spec=s)
                for s in specs for fam in FAMILIES for opt in OPTS]

    w2_cases = train_cases(WORLD2) + [
        dict(kind="save", name="save-fsdp", spec={"fsdp": 2}, opt="adamw",
             dir=dirs["fsdp"]),
        dict(kind="save", name="save-fsdp-adam8bit", spec={"fsdp": 2},
             opt="adam8bit", dir=dirs["fsdp8"]),
        dict(kind="save", name="save-tensor", spec={"tensor": 2},
             opt="adamw", dir=dirs["tensor"]),
        dict(kind="save", name="save-data", spec={"data": 2}, opt="adamw",
             dir=dirs["data"]),
        dict(kind="restore", name="one-to-fsdp", spec={"fsdp": 2},
             opt="adamw", dir=dirs["one"]),
        dict(kind="restore", name="jax-fsdp-to-fsdp", spec={"fsdp": 2},
             opt="adamw", dir=dirs["jax_fsdp"]),
    ] + [dict(kind="remat", name=f"remat-{fam}-{spec_id(spec)}", family=fam,
              spec=spec) for fam, spec in REMAT_CASES]
    def plain_cases(n):
        return [dict(kind="plain", name=plain_name(m, spec, r), model=m,
                     spec=spec, registry=r)
                for m, spec, r in PLAIN + PLAIN_CONV
                if math.prod(spec.values()) == n]

    w2_cases += plain_cases(2)
    w2_cases += [dict(kind="offload", name=offload_name(f, o, s), family=f,
                      opt=o, spec=s) for f, o, s, _, _ in OFFLOAD]
    # The masters of the 8-bit Adam under ZeRO without offload.
    w2_cases += [dict(kind="offload", name="gpt-bf16_adam8bit-data2-zero",
                      family="gpt", opt="bf16_adam8bit",
                      spec={"data": 2, "zero": True}, offload=False)]
    w4_cases = train_cases(WORLD4) + plain_cases(4) + [
        dict(kind="save", name="save-fsdp-tensor", spec=TWO_AXES,
             opt="adamw", dir=dirs["fsdp_tensor"]),
        dict(kind="restore", name="jax-fsdp-tensor-to-fsdp-tensor",
             spec=TWO_AXES, opt="adamw", dir=dirs["jax_fsdp_tensor"]),
    ]
    agent_cases = [dict(kind="agent_save", name="agent-fsdp",
                        spec={"fsdp": 2}, dir=dirs["agent"])]
    w8_cases = [c for c in train_cases(WORLD8) if c["opt"] == "adamw"]
    waves = (((2, "w2", w2_cases), (4, "w4", w4_cases),
              (2, "agent", agent_cases)), ((8, "w8", w8_cases),))
    for wave in waves:
        started = []
        for n, tag, cases in wave:
            path = str(root / f"{tag}.pkl")
            with open(path, "wb") as f:
                pickle.dump({"init": init, "plain_init": plain_init,
                             "cases": cases}, f)
            if tag == "agent":
                # The agent's saver of this world's node, in this process
                # (it reads the job's name when a registration comes).
                os.environ["DLROVER_TPU_JOB_NAME"] = f"{job}-{tag}"
                AsyncCheckpointSaver.start_async_saving_ckpt()
            world = World(n, path, f"{job}-{tag}")
            worlds.append(world)
            started.append((tag, world))
        if not out["one"]:
            # The one-device runs, here while the first wave trains.
            for fam in FAMILIES:
                for opt in OPTS:
                    out["one"][fam, opt] = port_train(fam, opt, {},
                                                      init[fam])
        for tag, world in started:
            try:
                out[tag] = world.collect()
            except WorldFailed as e:
                out.failures[tag] = str(e)
                out["dirs"].failures.update(dict.fromkeys(WRITES[tag],
                                                          str(e)))


# ------------------------------------------------------ training


def _hold_params(got, want, opt, label):
    from test_torch_optim import FIT_PARAM_MAX, FIT_PARAM_MEDIAN

    if opt == "adamw":
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=PARAM_TOL,
                                       atol=PARAM_TOL, err_msg=f"{label} {n}")
        return
    diffs = np.concatenate([np.abs(got[n] - want[n]).reshape(-1)
                            for n in want])
    assert diffs.max() <= FIT_PARAM_MAX, (label, diffs.max())
    assert np.median(diffs) <= FIT_PARAM_MEDIAN, (label, np.median(diffs))


TRAIN = [(n, s, f, o) for n, specs in ((2, WORLD2), (4, WORLD4))
         for s in specs for f in FAMILIES for o in OPTS] + [
    (8, s, f, "adamw") for s in WORLD8 for f in FAMILIES]


@pytest.mark.parametrize("world,spec,family,opt", TRAIN, ids=[
    f"{f}-{o}-{spec_id(s)}" for _, s, f, o in TRAIN])
def test_mesh_training_matches_jax_and_one_device(runs, world, spec, family,
                                                  opt):
    from dlrover_tpu_torch.models.convert import params_from_flax
    from test_torch_optim import assert_states_close

    name = f"{family}-{opt}-{spec_id(spec)}"
    got = runs[f"w{world}"][0][name]
    j_losses, j_params, j_opt = runs["jax"][family, opt, spec_id(spec)]
    one = runs["one"][family, opt]
    for want, label in ((j_losses, "jax"), (one["losses"], "one device")):
        np.testing.assert_allclose(got["losses"], want, rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=f"{name} vs {label}")
    want = {n: t.numpy() for n, t in params_from_flax(j_params).items()}
    _hold_params(got["params"], want, opt, f"{name} vs jax")
    _hold_params(got["params"], one["params"], opt, f"{name} vs one device")
    if opt == "adam8bit":
        from dlrover_tpu_torch.models.convert import adam8bit_state_from_flax

        assert_states_close(adam8bit_state_from_flax(got["adam8"]), j_opt,
                            MESH_FLIP_SHARE, MESH_SCALE_REL)
    # Every rank computed the same losses.
    for rank in runs[f"w{world}"][1:]:
        assert rank[name]["losses"] == got["losses"]


def fsdp_dims(family: str, spec: dict) -> dict:
    """The dim the fsdp axis shards, by parameter name: the one JAX's
    rules give the leaf's ``embed`` axis, dim 0 without one."""
    from dlrover_tpu_torch.accel import ParallelSpec
    from dlrover_tpu_torch.accel.sharding import mesh_dims

    rules = ParallelSpec(**spec).rules()
    return {n: mesh_dims(a, rules).get("fsdp", 0)
            for n, a in port_model(family).logical_axes().items()}


@pytest.mark.parametrize("world,spec", [(2, {"fsdp": 2}),
                                        (4, {"data": 2, "fsdp": 2})])
def test_fsdp_holds_half_of_each_leaf(runs, world, spec):
    """Under fsdp=2 each rank holds half of every parameter, along the
    dim JAX's rules give its ``embed`` axis (dim 0 without one, as FSDP2
    splits); two ranks' halves make the leaf."""
    for family in FAMILIES:
        name = f"{family}-adamw-{spec_id(spec)}"
        ranks = [r[name] for r in runs[f"w{world}"]]
        dims = fsdp_dims(family, spec)
        assert any(d == 1 for d in dims.values())
        for n, shape in ranks[0]["global"].items():
            d = dims[n]
            rows = [r["local"][n][d] for r in ranks]
            for r in ranks:
                assert r["local"][n][:d] + r["local"][n][d + 1:] == \
                    shape[:d] + shape[d + 1:], n
            assert all(x == -(-shape[d] // 2) or x == shape[d] // 2
                       for x in rows), (n, rows)
            # Each fsdp pair of ranks splits the dim once.
            assert sum(rows) == shape[d] * world // 2, (n, rows)


@pytest.mark.parametrize("world,spec", [(2, {"tensor": 2}),
                                        (4, {"data": 2, "tensor": 2})])
def test_tensor_computes_on_half_the_heads(runs, world, spec):
    """Under tensor=2 each block's attention sees half the heads (LLaMA:
    half the q and half the kv heads), and the column-parallel kernels
    hold half the heads' and half the ``mlp`` columns, the row-parallel
    ones half the rows; LLaMA's head holds half the vocab."""
    for family in FAMILIES:
        r = runs[f"w{world}"][0][f"{family}-adamw-{spec_id(spec)}"]
        g, loc = r["global"], r["local"]
        if family == "gpt":
            assert r["heads"] == {"Block": (1, None)}
            assert r["attn_heads"] == [1]
            col, row = ("qkv", "up"), ("proj", "down")
            # The tiny vocab (256) divides: the tied wte's rows too.
            assert loc["wte.weight"] == (g["wte.weight"][0] // 2,
                                         g["wte.weight"][1])
        else:
            assert r["heads"] == {"LlamaBlock": (2, 1)}
            assert r["attn_heads"] == [2]
            col = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
            row = ("o_proj", "down_proj")
            assert loc["lm_head.kernel"][1] == g["lm_head.kernel"][1] // 2
            # The vocab-parallel embedding: half its rows.
            assert loc["embed.weight"] == (g["embed.weight"][0] // 2,
                                           g["embed.weight"][1])
        for n in g:
            m = n.split(".")[-2] if "." in n else ""
            if n.endswith(".kernel") and m in col:
                assert loc[n] == (g[n][0], g[n][1] // 2), n
            elif n.endswith(".kernel") and m in row:
                assert loc[n] == (g[n][0] // 2, g[n][1]), n


def test_fsdp_and_tensor_hold_a_quarter_of_each_kernel(runs):
    """Under fsdp=2 x tensor=2 a rank holds a quarter of every
    column-parallel kernel (fsdp's half of its ``embed`` rows, tensor's
    half of its columns), of every row-parallel one (tensor's half of its
    rows, fsdp's half of its ``embed`` columns), and of the embedding
    (tensor's half of the vocab, fsdp's of ``embed``), as JAX places
    them; the blocks still see half the heads."""
    for family in FAMILIES:
        name = f"{family}-adamw-{spec_id(TWO_AXES)}"
        for rank in runs["w4"]:
            r = rank[name]
            g, loc = r["global"], r["local"]
            assert r["attn_heads"] == [1 if family == "gpt" else 2]
            if family == "gpt":
                col, row, table = ("qkv", "up"), ("proj", "down"), "wte"
            else:
                col = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
                row, table = ("o_proj", "down_proj"), "embed"
            for n in g:
                m = n.split(".")[-2] if "." in n else ""
                if n.endswith(".kernel") and m in col:
                    assert loc[n] == (g[n][0] // 2, g[n][1] // 2), n
                elif n.endswith(".kernel") and m in row:
                    assert loc[n] == (g[n][0] // 2, g[n][1] // 2), n
            assert loc[f"{table}.weight"] == (g[f"{table}.weight"][0] // 2,
                                              g[f"{table}.weight"][1] // 2)


@pytest.mark.parametrize("family,spec", REMAT_CASES,
                         ids=[f"{f}-{spec_id(s)}" for f, s in REMAT_CASES])
def test_remat_policies_equal_no_remat_on_a_mesh(runs, family, spec):
    """Under fsdp=2 (GPT) and tensor=2 (LLaMA) every remat policy's
    losses equal no remat's bit for bit, on every rank."""
    for rank in runs["w2"]:
        got = rank[f"remat-{family}-{spec_id(spec)}"]
        for policy in REMAT_POLICIES:
            assert got[policy] == got["none"], policy


@pytest.mark.parametrize("model,spec,registry", PLAIN, ids=[
    plain_name(m, s, r) for m, s, r in PLAIN])
def test_plain_models_train_as_jax(runs, model, spec, registry):
    """A plain module planned (``allow_tensor=True``) or placed by a
    ``registry=``: its losses are the JAX package's ``auto_accelerate``'s
    of the flax model under the same spec within 2e-5, on every rank
    alike; the planned layers are the Megatron pairs, and under tensor=2
    a column-parallel kernel holds half its rows (torch's ``[out, in]``),
    a row-parallel one half its columns, and fsdp halves the other dim
    (its ``embed`` dim; under fsdp alone nothing is tensor-parallel).
    A vocab the tensor degree does not divide (129) is refused by both
    packages, at placement, on every rank. A row-parallel bias, which
    only the first tensor rank adds, is stepped alike on every rank.
    Under fsdp each block is an FSDP2 unit."""
    name = plain_name(model, spec, registry)
    world = runs[f"w{math.prod(spec.values())}"]
    got = world[0][name]
    want = runs["jax"]["plain", model, registry, spec_id(spec)]
    if model == "odd_vocab":
        assert "should be divisible by 2" in want, want
        for rank in world:
            refused = rank[name]["refused"]
            assert "should be divisible by the tensor degree 2" in refused
            assert "wte.weight" in refused, refused
        return
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for rank in world[1:]:
        assert rank[name]["losses"] == got["losses"]
    g, loc = got["global"], got["local"]
    f, t = spec.get("fsdp", 1), spec.get("tensor", 1)
    assert bool(got["row_bias"]) == (t > 1)
    # FSDP2 gathers one block at a time: each block a unit, then the root.
    assert got["fsdp_units"] == ([] if f == 1 else
                                 ["", "block_0", "block_1"])
    for rank in world[1:]:
        for n, bias in got["row_bias"].items():
            np.testing.assert_array_equal(rank[name]["row_bias"][n], bias)
    if t == 1:
        assert got["roles"] == {}
    elif registry:
        assert got["roles"] == {"block_0.up": "col", "block_0.down": "row",
                                "block_1.up": "col", "block_1.down": "row"}
    else:
        assert got["roles"]["block_0.q_proj"] == "col"
        assert got["roles"]["block_0.k_proj"] == "col"
        assert got["roles"]["block_0.o_proj"] == "row"
        assert got["roles"]["lm_head"] == "col"
    up, down = "block_0.up.weight", "block_0.down.weight"
    assert loc[up] == (g[up][0] // t, g[up][1] // f), loc[up]
    assert loc[down] == (g[down][0] // f, g[down][1] // t), loc[down]
    assert loc["wte.weight"] == (-(-g["wte.weight"][0] // t),
                                 g["wte.weight"][1] // f)


@pytest.mark.parametrize("model,spec,registry", PLAIN_CONV, ids=[
    plain_name(m, s, r) for m, s, r in PLAIN_CONV])
def test_conv_and_bare_parameter_train_as_jax(runs, model, spec, registry):
    """``ConvLM``'s conv weight (``[out, in, k]``), its bias and its bare
    ``gain``, which the registry puts on the tensor axis: a rank stores
    half of each along the out channels (and fsdp halves that half again,
    dim 0 being each one's only sharded dim), the module
    computes on the whole tensors, and the losses and final parameters
    are the JAX package's GSPMD run's within 2e-5, every rank alike; a
    rank's checkpoint blocks of them are its shards (``gain``'s ``[16]``
    of ``[32]`` under tensor=2), each written once."""
    from dlrover_tpu_torch.models.convert import plain_from_flax
    from test_torch_registry import torch_model

    name = plain_name(model, spec, registry)
    world = runs[f"w{math.prod(spec.values())}"]
    losses, jparams = runs["jax"]["plain", model, registry, spec_id(spec)]
    got = world[0][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    want = plain_from_flax(jparams, torch_model("conv"))
    for n, t in want.items():
        np.testing.assert_allclose(got["params"][n], t.numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=n)
    t, f = spec["tensor"], spec.get("fsdp", 1)
    for rank in world:
        r = rank[name]
        assert r["losses"] == got["losses"]
        for n in ("block_0.conv.weight", "block_0.conv.bias",
                  "block_0.gain"):
            assert r["local"][n][0] == r["global"][n][0] // (t * f), n
        (gain,) = [b for b in r["conv_blocks"]
                   if b[0].startswith("['params']") and "gain" in b[0]]
        assert gain[2] == (32,) and gain[3] == (32 // (t * f),)
    written = [(b[0], b[1]) for rank in world
               for b in rank[name]["conv_blocks"] if b[5]]
    assert len(written) == len(set(written))


@pytest.mark.parametrize("family,opt,spec,base,held", OFFLOAD, ids=[
    offload_name(f, o, s) for f, o, s, _, _ in OFFLOAD])
def test_offload_on_a_mesh_trains_bit_for_bit(runs, family, opt, spec, base,
                                              held):
    """``offload_optimizer=True`` on a mesh: the state a rank steps (its
    fsdp or tensor shards' AdamW moments, its ZeRO slices, the 8-bit
    moments ``MeshOptimizer`` keeps whole, the masters' slices and whole
    moments of the 8-bit Adam under ZeRO) lies in host memory between
    steps, moved in and out once a step, and the losses and parameters
    are the same mesh's without offload bit for bit, every rank alike,
    and JAX's of that mesh within 2e-5 (the module's docstring: JAX's
    offloaded step does not run on its CPU mesh)."""
    name = offload_name(family, opt, spec)
    for rank in runs["w2"]:
        got, want = rank[name], rank[base]
        assert got["moved"] > 0 and got["on_host"]
        assert got["copies"]["in_bytes"] == STEPS * got["moved"]
        assert got["copies"]["out_bytes"] == STEPS * got["moved"]
        assert got["losses"] == want["losses"]
        for n in want["params"]:
            assert np.array_equal(got["params"][n], want["params"][n]), n
    if spec.get("zero"):
        assert runs["w2"][0][name]["inner"].startswith("Zero")
    if held:
        losses = runs["jax"][family, opt, spec_id(spec)][0]
        np.testing.assert_allclose(runs["w2"][0][name]["losses"], losses,
                                   rtol=LOSS_TOL, atol=LOSS_TOL)


# ------------------------------------------------------ checkpoints


def _by_path(blocks):
    return {(b[0], b[1]): b for b in blocks}


def test_fsdp_checkpoint_restores_at_fsdp_bit_for_bit(runs):
    """fsdp=2 -> fsdp=2: every rank's blocks come back bit for bit (AdamW
    and the 8-bit Adam, whose whole moments every rank holds), and the
    next step's losses are the uninterrupted run's."""
    for case in ("save-fsdp", "save-fsdp-adam8bit"):
        for rank in runs["w2"]:
            r = rank[case]
            assert r["step"] == 2
            assert _by_path(r["restored"]) == _by_path(r["saved"])
            assert r["next"][0] == r["next"][1]


@pytest.mark.parametrize("case", ["save-fsdp", "save-tensor",
                                  "save-fsdp-tensor"])
def test_sharded_checkpoint_restores_on_one_device(runs, case):
    """fsdp=2, tensor=2 (GPT's fused qkv as three regions a rank) and
    fsdp=2 x tensor=2 (blocks over two axes; a column bias's nested in
    dim 0) -> one device: each leaf equals the one the ranks held
    together."""
    from test_torch_checkpoint import port_bytes

    world = runs["w4" if case == "save-fsdp-tensor" else "w2"]
    want = assemble([r[case]["saved"] for r in world])
    t = ckpt_trainer("gpt", "adamw", {},
                     runs["dirs"][case[5:].replace("-", "_")], seed=5)
    assert t.restore() == 2
    assert port_bytes(t.state) == want
    t.close()


def test_one_device_checkpoint_restores_at_fsdp(runs):
    got = assemble([r["one-to-fsdp"]["restored"] for r in runs["w2"]])
    assert all(r["one-to-fsdp"]["step"] == 2 for r in runs["w2"])
    assert got == runs["one_ckpt"]


def test_data_checkpoint_has_one_writer_per_block(runs):
    """data=2: two shards, each a process; every block written by exactly
    one of them (replica 0), and the committed step counts both."""
    from dlrover_tpu_torch.common import ckpt_persist
    from dlrover_tpu_torch.common.storage import PosixDiskStorage

    d, storage = runs["dirs"]["data"], PosixDiskStorage()
    assert ckpt_persist.read_tracker(storage, d) == 2
    assert ckpt_persist.count_done(storage, d, 2) == 2
    metas = ckpt_persist.load_step_metas(storage, d, 2)
    assert sorted(metas) == [0, 1]
    written = [t.path for m in metas.values() for t in m.tensors]
    assert len(written) == len(set(written))
    assert set(written) == {b[0] for b in runs["w2"][0]["save-data"]["saved"]}
    assert not metas[1].tensors  # rank 1 is every leaf's second replica
    assert all(m.mesh_axes == {"data": 2} for m in metas.values())


def test_agent_saver_persists_every_local_shard(runs):
    """Two local ranks (``LOCAL_WORLD_SIZE=2``) under one agent's saver:
    it waits for both segments, persists both shards and commits the
    step; the step restores on one device as the ranks held it."""
    from dlrover_tpu_torch.common import ckpt_persist
    from dlrover_tpu_torch.common.storage import PosixDiskStorage
    from test_torch_checkpoint import port_bytes

    d, storage = runs["dirs"]["agent"], PosixDiskStorage()
    assert ckpt_persist.read_tracker(storage, d) == 2
    assert sorted(ckpt_persist.load_step_metas(storage, d, 2)) == [0, 1]
    want = assemble([r["agent-fsdp"]["saved"] for r in runs["agent"]])
    t = ckpt_trainer("gpt", "adamw", {}, d, seed=5)
    assert t.restore() == 2
    assert port_bytes(t.state) == want
    t.close()


def test_topology_gap_raises(runs, tmp_path):
    """A sharded step missing one block of a leaf raises
    ``TopologyMismatchError`` naming both topologies, as the JAX engine
    does, and is not quarantined."""
    from dlrover_tpu_torch.common import ckpt_meta, ckpt_persist
    from dlrover_tpu_torch.common.storage import PosixDiskStorage

    d = str(tmp_path / "cut")
    shutil.copytree(runs["dirs"]["fsdp"], d)
    path = os.path.join(ckpt_persist.step_dir(d, 2), "shard_1.meta")
    with open(path, "rb") as f:
        meta = ckpt_meta.loads(f.read())
    victim = next(t for t in meta.tensors if t.index is not None)
    meta.tensors = [t for t in meta.tensors if t is not victim]
    with open(path, "wb") as f:
        f.write(ckpt_meta.dumps(meta))
    t = ckpt_trainer("gpt", "adamw", {}, d, seed=5)
    with pytest.raises(ckpt_persist.TopologyMismatchError,
                       match="fsdp.*cover") as e:
        t.restore()
    assert "step 2" in str(e.value)
    assert not ckpt_persist.is_quarantined(PosixDiskStorage(), d, 2)
    t.close()


def test_jax_fsdp_checkpoint_restores_in_port(runs):
    """The JAX package's fsdp=2 step (2 host devices) restores into the
    port at fsdp=2 and on one device."""
    from test_torch_checkpoint import port_bytes

    got = assemble([r["jax-fsdp-to-fsdp"]["restored"] for r in runs["w2"]])
    assert got == runs["jax_fsdp_ckpt"]
    t = ckpt_trainer("gpt", "adamw", {}, runs["dirs"]["jax_fsdp"], seed=5)
    assert t.restore() == 2
    assert port_bytes(t.state) == runs["jax_fsdp_ckpt"]
    t.close()


def test_port_fsdp_checkpoint_restores_in_jax(runs, tmp_path):
    """The port's fsdp=2 step (two shard files) restores into the JAX
    package on one device."""
    from test_torch_checkpoint import jax_bytes, jax_trainer

    want = assemble([r["save-fsdp"]["saved"] for r in runs["w2"]])
    jt = jax_trainer("adamw", runs["dirs"]["fsdp"])
    assert jt.restore() == 2
    assert jax_bytes(jt.state) == want
    jt.close()


def test_two_axis_checkpoint_restores_bit_for_bit_at_its_topology(runs):
    """fsdp=2 x tensor=2 -> the same: every rank's blocks (each leaf's
    once a replica, in JAX's global coordinates) come back bit for bit,
    and the next step's losses are the uninterrupted run's."""
    for rank in runs["w4"]:
        r = rank["save-fsdp-tensor"]
        assert r["step"] == 2
        assert _by_path(r["restored"]) == _by_path(r["saved"])
        assert r["next"][0] == r["next"][1]


def test_port_two_axis_checkpoint_restores_in_jax(runs):
    """The port's fsdp=2 x tensor=2 step (four shard files) restores into
    the JAX package on one device, bit for bit."""
    from test_torch_checkpoint import jax_bytes, jax_trainer

    want = assemble([r["save-fsdp-tensor"]["saved"] for r in runs["w4"]])
    jt = jax_trainer("adamw", runs["dirs"]["fsdp_tensor"])
    assert jt.restore() == 2
    assert jax_bytes(jt.state) == want
    jt.close()


def test_jax_two_axis_checkpoint_restores_in_port(runs):
    """The JAX package's fsdp=2 x tensor=2 step (4 host devices) restores
    into the port at fsdp=2 x tensor=2 and on one device, bit for bit."""
    from test_torch_checkpoint import port_bytes

    name = "jax-fsdp-tensor-to-fsdp-tensor"
    assert all(r[name]["step"] == 2 for r in runs["w4"])
    got = assemble([r[name]["restored"] for r in runs["w4"]])
    assert got == runs["jax_fsdp_tensor_ckpt"]
    t = ckpt_trainer("gpt", "adamw", {}, runs["dirs"]["jax_fsdp_tensor"],
                     seed=5)
    assert t.restore() == 2
    assert port_bytes(t.state) == runs["jax_fsdp_tensor_ckpt"]
    t.close()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1] == "--jax":
        import conftest  # noqa: F401  (8 host devices, before JAX starts)

        jax_refs(sys.argv[2])
    else:
        worker(sys.argv[1])
