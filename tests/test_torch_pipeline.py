"""The port's pipeline parallelism against the JAX package's (CPU).

In this process: the tick formulas; GPipe and circular logits, MoE aux
and gradients of GPT and LLaMA tiny (fp32) on the JAX package's
pipelined weights carried across, against its ``apply``, and against
the port's unpipelined model on the same weights by logical layer;
the converter both ways, bit for bit, for both layouts with and
without ``scan_layers``; the refusals' errors.

Then worlds of gloo ranks, started as torchrun starts them (this file
is also the worker: ``python tests/test_torch_pipeline.py <inputs>``;
``--jax`` for a process of JAX references): a world of 2 trains
``ParallelSpec(pipe=2)`` under GPipe and the circular schedule (M 4,
C 2) and runs the checkpoint cases; a world of 4 trains ``(pipe=4)``,
``(data=2, pipe=2)`` and LLaMA-MoE tiny under ``(data=2, pipe=2)`` at
capacity factor 0.5 (every expert drops tokens: a data rank that
routed other rows of a microbatch than JAX's would drop other tokens).
Each run is three AdamW steps of the same global batches from the
port's seeded weights (carried to the JAX side by
``models/convert.py``), beside the port's one-device pipelined run and
JAX's ``auto_accelerate(spec=...)`` over as many host devices. One
world serves every spec of its size; each has a deadline of its own.
The worlds and the reference processes start with the module and run
beside the in-process tests.

The world of 2 also trains GPT tiny under ``pipe=2`` with the
``update_and_apply`` optimizers (``OPT_RUNS``): the 8-bit Adam and
``bf16_master_weights`` of AdamW (fp32 parameters) and of the 8-bit
Adam (bf16 parameters), GPipe and circular. Each trains bit for bit as the port's one device (the same
arithmetic: a stage's rows of the 8-bit state are blocks of their own),
each rank holds its stages' rows of the state only and no all-gather
runs in a step; the 8-bit Adam's pipe=2 snapshot restores at pipe=2 and
on one device bit for bit. The JAX package's runs of the same specs
hold the losses (2e-5) and the parameters (AdamW's masters: 2e-5; the
8-bit Adam's, whose int8 rounds the gradients' last bits move:
``tests/test_torch_optim.py``'s largest and median difference); JAX
runs the 8-bit Adam's Pallas kernel in interpret mode, the port its
plain version.

Tolerances: logits and aux within 1e-5 and gradients within 2e-5 of
JAX's (fp32, the order of sums only); losses and parameters within
2e-5 of JAX's under the same spec and of the port's one-device run
(``tests/test_torch_parallel.py``'s, the JAX package's own
sharded-vs-baseline tolerance, ``tests/test_pipeline.py``).
"""

import dataclasses
import functools
import glob
import os
import pickle
import sys
import time
import uuid

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import (  # noqa: E402
    World,
    assemble,
    blocks_of,
    join_world,
)

LOGIT_TOL, GRAD_TOL, LOSS_TOL = 1e-5, 2e-5, 2e-5
STEPS, ROWS, SEQ = 3, 8, 16
LR = 1e-3
JAX_PROCS = 4
WORLD_DEADLINE_S = 300
SCHEDULES = ("gpipe", "circular")
FAMILIES = ("gpt", "llama")
# Every training run: (world, name, family, spec, schedule, stages,
# experts, capacity factor).
RUNS = (
    (2, "gpt-pipe2", "gpt", {"pipe": 2}, "gpipe", 2, 0, 1.25),
    (2, "gpt-pipe2-circular", "gpt", {"pipe": 2}, "circular", 2, 0, 1.25),
    (2, "llama-pipe2-circular", "llama", {"pipe": 2}, "circular", 2, 0,
     1.25),
    (4, "gpt-pipe4", "gpt", {"pipe": 4}, "gpipe", 4, 0, 1.25),
    (4, "gpt-data2-pipe2", "gpt", {"data": 2, "pipe": 2}, "gpipe", 2, 0,
     1.25),
    (4, "llama-moe-data2-pipe2-overflow", "llama", {"data": 2, "pipe": 2},
     "gpipe", 2, 4, 0.5),
)
CKPT = dict(family="gpt", schedule="gpipe", stages=2, experts=0, cf=1.25)
OPTS = ("adam8bit", "bf16", "bf16_adam8bit")
# GPT tiny on pipe=2 under each update_and_apply optimizer: (name,
# schedule, optimizer, held to JAX's run).
OPT_RUNS = tuple(
    (f"gpt-pipe2-{sched}-{opt}", sched, opt, opt != "bf16_adam8bit")
    for opt in OPTS for sched in SCHEDULES)
# The runs with bf16 parameters; the others' are fp32. (Trained bf16
# parameters are held to JAX's only on the same gradients,
# tests/test_torch_optim_more.py: the two packages round a few bf16
# gradients to the other side of a tie, and Adam's division turns that
# into a percent of a step. The fp32 masters' placement and arithmetic
# are the same with fp32 parameters.)
BF16_PARAMS = ("bf16_adam8bit",)


def config_kw(schedule="gpipe", stages=2, experts=0, cf=1.25, layers=4,
              microbatches=4, scan=True):
    return dict(num_layers=layers, pipeline_stages=stages,
                pipeline_microbatches=microbatches,
                pipeline_repeats=2 if schedule == "circular" else 1,
                num_experts=experts, moe_capacity_factor=cf,
                scan_layers=scan)


def port_opt(opt="adamw"):
    from dlrover_tpu_torch.optim import adam8bit, adamw, bf16_master_weights

    return {"adamw": lambda: adamw(LR), "adam8bit": lambda: adam8bit(LR),
            "bf16": lambda: bf16_master_weights(adamw(LR)),
            "bf16_adam8bit": lambda: bf16_master_weights(adam8bit(LR))
            }[opt]()


def global_batches():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (ROWS, SEQ), dtype=np.int64)
            for _ in range(STEPS)]


# ------------------------------------------------------ the port side


def port_model(family, seed=0, bf16=False, **kw):
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig

    cls, cfg = ((GPT, GPTConfig.tiny()) if family == "gpt"
                else (Llama, LlamaConfig.tiny()))
    cfg = dataclasses.replace(cfg, dtype=torch.float32, **config_kw(**kw))
    if bf16:
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    return cls(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def port_loss(module, params, batch):
    from dlrover_tpu_torch.models.gpt import loss_fn, moe_loss_fn

    out = module(batch)
    return moe_loss_fn(out, batch) if isinstance(out, tuple) \
        else loss_fn(out, batch)


def port_train(family, spec, schedule, stages, experts, cf, opt="adamw"):
    """Three steps under ``spec`` (one device when empty): losses, ticks,
    this rank's parameters (fp32) and their names, the all-gathers the
    steps ran, and the optimizer's state by JAX leaf path (the 8-bit
    moments: ``q`` and ``scale``; the fp32 masters)."""
    import torch.distributed as dist

    from dlrover_tpu_torch.accel import ParallelSpec, auto_accelerate

    batches = global_batches()
    model = port_model(family, schedule=schedule, stages=stages,
                       experts=experts, cf=cf, bf16=opt in BF16_PARAMS)
    res = auto_accelerate(model, port_opt(opt), batches[0], port_loss,
                          spec=ParallelSpec(**spec), device="cpu")
    gathers = []
    real = {f: getattr(dist, f) for f in ("all_gather",
                                          "all_gather_into_tensor")}

    def spy(f):
        def call(*args, **kwargs):
            gathers.append(f)
            return real[f](*args, **kwargs)
        return call

    for f in real:
        setattr(dist, f, spy(f))
    try:
        losses = [float(res.train_step(res.state, torch.from_numpy(
            res.local_batch(b)))[1]["loss"]) for b in batches]
    finally:
        for f, fn in real.items():
            setattr(dist, f, fn)
    return {"losses": losses, "ticks": res.module.pipeline.ticks,
            "params": {n: p.detach().float().numpy().copy()
                       for n, p in res.state["params"].items()},
            "gathers": gathers, "state": opt_state(res.state["opt"])}


def opt_state(opt) -> dict:
    """The state an ``update_and_apply`` optimizer holds (numpy, by JAX
    leaf path): the 8-bit moments' ``q`` and ``scale``, and the masters
    (by parameter name); empty for AdamW."""
    from dlrover_tpu_torch.accel.accelerate import MeshOptimizer
    from dlrover_tpu_torch.optim.bf16 import Bf16MasterOptimizer

    out = {}
    if isinstance(opt, MeshOptimizer):
        opt = opt.inner
    if isinstance(opt, Bf16MasterOptimizer):
        out.update({("master", n): t.numpy().copy()
                    for n, t in opt.master.items()})
        opt = opt.inner
    st = getattr(opt, "state", None)
    if hasattr(st, "m"):
        for moment in ("m", "v"):
            for path, qt in getattr(st, moment).items():
                out[(moment, path)] = (qt.q.numpy().copy(),
                                       qt.scale.numpy().copy())
    return out


def ckpt_trainer(spec, ckpt_dir, seed=0, opt="adamw"):
    from dlrover_tpu_torch.accel import ParallelSpec
    from dlrover_tpu_torch.train.trainer import Trainer

    kw = {k: v for k, v in CKPT.items() if k != "family"}
    return Trainer(port_model("gpt", seed, **kw), port_opt(opt), port_loss,
                   global_batches()[0], spec=ParallelSpec(**spec),
                   device="cpu", checkpoint_dir=ckpt_dir, persist_every=2,
                   report_metrics=False)


def wait_done(ckpt_dir: str, timeout: float = 200):
    """Until the checkpoint's writer (another process) marks it done."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(ckpt_dir + ".done"):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint in {ckpt_dir}")
        time.sleep(0.1)


def case_train(case, inputs):
    return port_train(case["family"], case["spec"], case["schedule"],
                      case["stages"], case["experts"], case["cf"],
                      case.get("opt", "adamw"))


def case_save(case, inputs):
    """2 steps, step 2 persisted (then marked done); a fresh trainer of
    another seed restores it; the eval loss of both."""
    import torch.distributed as dist

    opt = case.get("opt", "adamw")
    t = ckpt_trainer(case["spec"], case["dir"], opt=opt)
    t.fit(iter(global_batches()[:2]), steps=2, start_step=0)
    saved = blocks_of(t.state)
    dist.barrier()
    if dist.get_rank() == 0:
        open(case["dir"] + ".done", "w").close()
    fresh = ckpt_trainer(case["spec"], case["dir"], seed=5, opt=opt)
    step = fresh.restore()
    evals = [tr.evaluate(iter(global_batches()[2:]))["eval_loss"]
             for tr in (t, fresh)]
    out = {"saved": saved, "restored": blocks_of(fresh.state), "step": step,
           "eval": evals}
    t.close()
    fresh.close()
    return out


def case_restore(case, inputs):
    """Restore a checkpoint another topology or package saved."""
    wait_done(case["dir"])
    t = ckpt_trainer(case["spec"], case["dir"], seed=5)
    out = {"step": t.restore(), "restored": blocks_of(t.state)}
    t.close()
    return out


CASES = {"train": case_train, "save": case_save, "restore": case_restore}


def worker(path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    join_world()
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    out = {case["name"]: CASES[case["kind"]](case, inputs)
           for case in inputs["cases"]}
    with open(f"{path}.rank{dist.get_rank()}", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------ the JAX side


@functools.lru_cache(maxsize=None)
def _jax():
    import types

    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.accel import ParallelSpec, auto_accelerate
    from dlrover_tpu.accel import pipeline
    from dlrover_tpu.models import gpt, llama

    return types.SimpleNamespace(
        nn=nn, jax=jax, jnp=jnp, optax=optax, gpt=gpt, llama=llama,
        pipeline=pipeline, ParallelSpec=ParallelSpec,
        auto_accelerate=auto_accelerate)


def jax_model(family, bf16=False, **kw):
    J = _jax()
    mod = J.gpt if family == "gpt" else J.llama
    cls, cfg = ((mod.GPT, mod.GPTConfig) if family == "gpt"
                else (mod.Llama, mod.LlamaConfig))
    cfg = dataclasses.replace(cfg.tiny(), dtype=J.jnp.float32,
                              **config_kw(**kw))
    if bf16:
        cfg = dataclasses.replace(cfg, param_dtype=J.jnp.bfloat16)
    return cls(cfg)


def jax_opt(opt="adamw"):
    J = _jax()
    from dlrover_tpu.optim.bf16 import bf16_master_weights
    from dlrover_tpu.optim.low_bit import adam8bit

    return {"adamw": lambda: J.optax.adamw(LR),
            "adam8bit": lambda: adam8bit(LR),
            "bf16": lambda: bf16_master_weights(J.optax.adamw(LR))}[opt]()


def jax_loss(m, p, b):
    J = _jax()
    out = m.apply({"params": p}, b)
    return J.gpt.moe_loss_fn(out, b) if isinstance(out, tuple) \
        else J.gpt.loss_fn(out, b)


@functools.lru_cache(maxsize=None)
def jax_init(family, seed=0, **kw):
    """The JAX model's params (numpy) from ``PRNGKey(seed)`` (``init``
    jitted: a pipelined model's eager init takes seconds longer)."""
    J = _jax()
    tokens = global_batches()[0].astype(np.int32)
    variables = J.jax.jit(jax_model(family, **kw).init)(
        J.jax.random.PRNGKey(seed), tokens)
    return J.jax.tree_util.tree_map(np.asarray,
                                    J.nn.meta.unbox(variables["params"]))


def jax_apply(family, params, tokens, **kw):
    model = jax_model(family, **kw)
    return _jax().jax.jit(lambda p, x: model.apply({"params": p}, x))(
        params, tokens.astype(np.int32))


def jax_train(family, spec, schedule, stages, experts, cf, init,
              opt="adamw"):
    """(losses, params) of the JAX package's run under ``spec`` from the
    params ``init`` (numpy, in place of its own initial ones; a
    ``bf16_master_weights`` run's masters start from them too, and its
    params are the fp32 masters, of which the bf16 ones are roundings)."""
    J = _jax()
    jax = J.jax
    s = J.ParallelSpec(**spec)
    batches = [b.astype(np.int32) for b in global_batches()]
    tx = jax_opt(opt)
    res = J.auto_accelerate(
        jax_model(family, opt in BF16_PARAMS, schedule=schedule,
                  stages=stages, experts=experts, cf=cf), tx, batches[0],
        jax_loss, spec=s, devices=jax.devices()[:s.total])
    state, losses = dict(res.state), []
    state["params"] = jax.tree_util.tree_map(
        lambda cur, new: jax.device_put(new, cur.sharding), state["params"],
        init)
    # Fresh buffers: fp32 masters would alias the params, which the step
    # donates.
    state["opt"] = jax.tree_util.tree_map(
        lambda cur, new: jax.device_put(np.asarray(new), cur.sharding),
        state["opt"], tx.init(state["params"]))
    for b in batches:
        state, m = res.train_step(state, jax.device_put(b, res.batch_sharding))
        losses.append(float(m["loss"]))
    params = state["opt"].master if opt == "bf16" else state["params"]
    return losses, jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), params)


def jax_ckpt_trainer(ckpt_dir):
    """The JAX package's Trainer of the pipelined GPT on one device,
    persisting every 2 steps."""
    J = _jax()
    from dlrover_tpu.train import trainer

    kw = {k: v for k, v in CKPT.items() if k != "family"}
    return trainer.Trainer(
        jax_model("gpt", **kw), J.optax.adamw(LR), jax_loss,
        global_batches()[0].astype(np.int32), spec=J.ParallelSpec(),
        checkpoint_dir=ckpt_dir, persist_every=2)


def jax_ckpt(ckpt_dir):
    """Step 2 of the JAX package's pipelined GPT, persisted into
    ``ckpt_dir`` (then marked done): its train state's bytes."""
    from test_torch_checkpoint import jax_bytes

    jt = jax_ckpt_trainer(ckpt_dir)
    jt.fit(iter(b.astype(np.int32) for b in global_batches()[:2]), steps=2,
           start_step=0)
    out = jax_bytes(jt.state)
    jt.close()
    open(ckpt_dir + ".done", "w").close()
    return out


def jax_restore(ckpt_dir):
    """The port's checkpoint in ``ckpt_dir`` (once marked done) restored
    into the JAX package on one device: (step, the state's bytes)."""
    from test_torch_checkpoint import jax_bytes

    wait_done(ckpt_dir)
    jt = jax_ckpt_trainer(ckpt_dir)
    out = (jt.restore(), jax_bytes(jt.state))
    jt.close()
    return out


def jax_refs(path):
    with open(path, "rb") as f:
        todo = pickle.load(f)
    jobs = {"train": jax_train, "ckpt": jax_ckpt, "restore": jax_restore}
    out = {key: jobs[key[0]](*job) for key, job in todo}
    with open(f"{path}.rank0", "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------ schedules


def test_tick_formulas_equal_jax():
    from dlrover_tpu_torch.accel import pipeline

    J = _jax()
    for m in range(1, 9):
        for p in range(1, 6):
            assert pipeline.gpipe_ticks(m, p) == J.pipeline.gpipe_ticks(m, p)
            for c in range(1, 5):
                assert pipeline.circular_ticks(m, p, c) == \
                    J.pipeline.circular_ticks(m, p, c)
                assert pipeline.schedule_cost(m, p, c) == \
                    J.pipeline.schedule_cost(m, p, c)


def _carried(family, params, **kw):
    """The port's model of ``kw`` holding the JAX ``params``."""
    from dlrover_tpu_torch.models import convert

    model = port_model(family, **kw)
    model.load_state_dict(convert.params_from_flax(params))
    return model


def _dense(family, model):
    """The port's unpipelined model on ``model``'s weights by logical
    layer."""
    from dlrover_tpu_torch.models import convert

    cfg = dataclasses.replace(model.cfg, pipeline_stages=0,
                              pipeline_repeats=1, pipeline_microbatches=0)
    dense = type(model)(cfg, device="cpu")
    dense.load_state_dict(convert.dense_state_dict(model.state_dict(),
                                                   model.cfg))
    return dense


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_logits_match_jax_and_the_dense_model(family, schedule):
    """Logits on JAX's pipelined weights equal JAX's ``apply``, and the
    port's unpipelined model's on the same weights (JAX's
    ``TestScheduleExactness`` / ``TestCircularSchedule``)."""
    params = jax_init(family, 42, schedule=schedule)
    tokens = global_batches()[0]
    want = np.asarray(jax_apply(family, params, tokens, schedule=schedule))
    model = _carried(family, params, schedule=schedule)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
        dense = _dense(family, model)(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(got, dense, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert model.pipeline.ticks == (5 if schedule == "gpipe" else 9)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_moe_logits_and_aux_match_jax(family, schedule):
    """With experts each microbatch routes alone and the aux rides the
    carry: JAX's ``mean(aux_outs) / (P*C)``, and the dense model run
    microbatch by microbatch (JAX's ``TestMoEPipeline._exact``)."""
    kw = dict(schedule=schedule, experts=2)
    params = jax_init(family, 7, **kw)
    tokens = global_batches()[0]
    logits, aux = jax_apply(family, params, tokens, **kw)
    model = _carried(family, params, **kw)
    dense = _dense(family, model)
    with torch.no_grad():
        got, got_aux = model(torch.from_numpy(tokens))
        parts = [dense(torch.from_numpy(tokens[i * 2:(i + 1) * 2]))
                 for i in range(4)]
    np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(float(got_aux), float(aux), rtol=LOGIT_TOL)
    np.testing.assert_allclose(
        got.numpy(), torch.cat([p[0] for p in parts]).numpy(),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(
        float(got_aux), float(torch.stack([p[1] for p in parts]).mean()),
        rtol=LOGIT_TOL)


@pytest.mark.parametrize("family,schedule,experts", [
    ("gpt", "gpipe", 0), ("gpt", "circular", 0), ("gpt", "circular", 2),
    ("llama", "gpipe", 0), ("llama", "circular", 0)])
def test_gradients_match_jax(family, schedule, experts):
    from dlrover_tpu_torch.models import convert

    J = _jax()
    kw = dict(schedule=schedule, experts=experts)
    # The logits' and the MoE tests' weights.
    params = jax_init(family, 7 if experts else 42, **kw)
    tokens = global_batches()[1]
    model = jax_model(family, **kw)
    want = J.jax.jit(J.jax.grad(lambda p: jax_loss(
        model, p, tokens.astype(np.int32))))(params)
    model = _carried(family, params, **kw)
    port_loss(model, None, torch.from_numpy(tokens)).backward()
    got = convert.flax_from_params({n: p.grad for n, p in
                                    model.named_parameters()})
    flat_want = dict(J.jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(J.jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_got.keys() == flat_want.keys()
    for path, g in flat_want.items():
        np.testing.assert_allclose(flat_got[path], np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=J.jax.tree_util.keystr(path))


def _jax_error(build):
    with pytest.raises(ValueError) as e:
        build()
    return str(e.value)


@pytest.mark.parametrize("family", FAMILIES)
def test_refusals_match_jax(family):
    """A batch the microbatches do not divide, a circular schedule with
    fewer microbatches than stages, and layers the chunks do not
    divide: JAX's ``ValueError``s, word for word."""
    tokens = np.zeros((6, SEQ), np.int32)
    want = _jax_error(lambda: jax_model(family).init(
        _jax().jax.random.PRNGKey(0), tokens))
    model = port_model(family)
    with pytest.raises(ValueError) as e:
        model(torch.from_numpy(tokens.astype(np.int64)))
    assert str(e.value) == want == "batch 6 not divisible by 4 microbatches"
    kw = dict(schedule="circular", stages=4, layers=8, microbatches=2)
    want = _jax_error(lambda: jax_model(family, **kw).init(
        _jax().jax.random.PRNGKey(0), np.zeros((8, SEQ), np.int32)))
    with pytest.raises(ValueError) as e:
        port_model(family, **kw)
    assert str(e.value) == want and "microbatches >= stages" in want
    want = _jax_error(lambda: jax_model(family, stages=3))
    with pytest.raises(ValueError) as e:
        port_model(family, stages=3)
    assert str(e.value) == want and "divisible" in want


# ------------------------------------------------------ the converter


def _flat(tree):
    J = _jax()
    return {J.jax.tree_util.keystr(k): np.asarray(v)
            for k, v in J.jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("scan", [True, False], ids=["scan", "unscanned"])
def test_converter_round_trip_is_bit_exact(family, schedule, scan):
    """JAX -> port -> JAX, every leaf's bytes, for both layouts with and
    without ``scan_layers`` (GPipe ``stage/block_<j>`` leaves are
    ``[P, ...]``); the bank's ``(p, c)`` is logical chunk ``c*P + p``
    in the unpipelined model's layers (JAX's ``_stack_chunks_dense``)."""
    from dlrover_tpu_torch.models import convert

    # GPipe's scanned weights are the logits test's (4 layers, 2 a
    # stage); the others 8 layers (the circular bank's 2 a chunk).
    seed, kw = 42, dict(schedule=schedule)
    if schedule == "circular" or not scan:
        seed, kw = 1, dict(schedule=schedule, layers=8, scan=scan)
    params = jax_init(family, seed, **kw)
    model = _carried(family, params, **kw)
    back = convert.flax_from_params(model.state_dict(), stacked=scan)
    want, got = _flat(params), _flat(back)
    assert got.keys() == want.keys()
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype and \
            got[path].tobytes() == arr.tobytes(), path
    if not scan:
        return
    dense = convert.dense_state_dict(model.state_dict(), model.cfg)
    stack = "blocks" if family == "gpt" else "layers"
    bank = (params["pipeline"]["bank"]["blocks"] if schedule == "circular"
            else params["pipeline"]["ticks"]["stages"]["stage"]["blocks"])
    kernel = bank["qkv" if family == "gpt" else "q_proj"]["kernel"]
    p_ = 2
    for i in range(model.cfg.num_layers):
        if schedule == "circular":  # chunk j = c*P + p of 2 layers
            j, k = divmod(i, 2)
            layer = kernel[j % p_, j // p_, k]
        else:
            layer = kernel[i // 2, i % 2]
        name = f"{stack}.{i}.{'qkv' if family == 'gpt' else 'q_proj'}.kernel"
        assert np.array_equal(dense[name].numpy(), layer), i


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pipelined_init_is_the_dense_init_by_layer(family, schedule):
    """A seed gives a pipelined model the weights it gives the
    unpipelined one, layer by logical layer."""
    from dlrover_tpu_torch.models import convert

    model = port_model(family, seed=4, schedule=schedule, layers=8)
    dense = port_model(family, seed=4, stages=0, layers=8)
    got = convert.dense_state_dict(model.state_dict(), model.cfg)
    want = dense.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[n], want[n]) for n in want)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_adam8_table_walks_pipelined_leaves_by_stage(schedule):
    """The 8-bit Adam kernel's table gives each stage of a pipelined
    ``[P, L/P, ...]`` leaf (quantized a stage at a time, its layers
    straddling the stage's blocks) a row of its own; the rows' walk (the
    kernel's addressing, ``walk_rows``) is the leaf's block layout."""
    from dlrover_tpu_torch.models import convert
    from dlrover_tpu_torch.optim import low_bit

    model = port_model("gpt", schedule=schedule, layers=8)
    params = {n: p.detach() for n, p in model.named_parameters()}
    leaves = list(convert.param_leaves(params).values())
    specs = [(leaf.shape, len(leaf.names), params[leaf.names[0]].numel())
             for leaf in leaves]
    rows = low_bit.leaf_rows(specs)
    walked = iter(low_bit.walk_rows(rows, [params[n] for leaf in leaves
                                           for n in leaf.names]))
    by_stage = 0
    for (shape, nmem, _), leaf in zip(specs, leaves):
        k = low_bit._row_count(shape, nmem)
        by_stage += k > 1
        got = torch.cat([next(walked) for _ in range(k)])
        want = low_bit._blocks_of(low_bit._leaf(
            [params[n] for n in leaf.names], shape), low_bit.KERNEL_BLOCK)
        assert torch.equal(got, want), shape
    assert by_stage == len([leaf for leaf in leaves
                            if leaf.shape[0] == 2 and len(leaf.shape) > 2])
    assert [r.block0 for r in rows] == list(np.cumsum(
        [0] + [r.nblocks for r in rows[:-1]]))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_adam8_table_of_a_pipe_rank_walks_its_stages_rows(schedule):
    """On pipe rank r of 2 the 8-bit Adam's leaves are ``StageBlock``s of
    its stages (``param_leaves``, from the stage layouts' global count),
    and its table's rows walk exactly stage ``r``'s rows of the whole
    model's table: the kernel steps the rows the rank owns, with their
    own blocks and scales."""
    from dlrover_tpu_torch.accel.sharding import Layout, set_layout
    from dlrover_tpu_torch.models import convert
    from dlrover_tpu_torch.optim import low_bit
    from test_torch_mesh import FakeMesh

    model = port_model("gpt", schedule=schedule, layers=8)
    params = {n: p.detach() for n, p in model.named_parameters()}
    whole = convert.param_leaves(params)
    rows = low_bit.leaf_rows([(leaf.shape, len(leaf.names),
                               params[leaf.names[0]].numel())
                              for leaf in whole.values()])
    walk = low_bit.walk_rows(rows, [params[n] for leaf in whole.values()
                                    for n in leaf.names])
    by_leaf, it = {}, iter(walk)
    for path, leaf in whole.items():
        k = low_bit._row_count(leaf.shape, len(leaf.names))
        by_leaf[path] = [next(it) for _ in range(k)]
    for r in range(2):
        mesh = FakeMesh({"pipe": 2}, [r])
        mine = {n: t.clone() for n, t in params.items()
                if n.startswith(f"pipeline.stages.{r}.")
                or n.startswith(f"pipeline.bank.{r}.")}
        for t in mine.values():
            set_layout(t, Layout(mesh, (None,), placed=(0,), stages=2))
        leaves = convert.param_leaves(mine)
        assert all(leaf.index[0] == (r, r + 1) for leaf in leaves.values())
        state = low_bit.adam8bit(LR).init(mine, leaves)
        for path, leaf in leaves.items():
            assert leaf.shape == whole[path].shape
            assert state.m[path].q.shape[0] == 1
            own = low_bit.leaf_rows([(leaf.local_shape, len(leaf.names),
                                      mine[leaf.names[0]].numel())])
            got = low_bit.walk_rows(own, [mine[n] for n in leaf.names])
            assert torch.equal(torch.cat(got), by_leaf[path][r]), path


# ------------------------------------------------------ the pipe worlds


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory):
    """The gloo worlds and the processes of JAX references, started with
    the module so that they run beside its in-process tests; ``runs``
    joins them. Whatever is still running at the module's end is
    killed."""
    root = tmp_path_factory.mktemp("pipe")
    job = f"pipe-{uuid.uuid4().hex[:8]}"
    old_job = os.environ.get("DLROVER_TPU_JOB_NAME")
    os.environ["DLROVER_TPU_JOB_NAME"] = job + "-main"
    started = {"root": root, "worlds": []}
    try:
        _start(started, job)
        yield started
    finally:
        for world in started["worlds"]:
            for proc in world.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if old_job is None:
            os.environ.pop("DLROVER_TPU_JOB_NAME", None)
        else:
            os.environ["DLROVER_TPU_JOB_NAME"] = old_job
        for path in glob.glob(f"/dev/shm/ckpt_{job}*"):
            os.unlink(path)


def _start(started, job):
    """Write every process's inputs and start the JAX references (in
    JAX_PROCS processes, the longest jobs first to the least loaded)
    and the worlds of 2 and 4 ranks."""
    from dlrover_tpu_torch.models import convert

    root = started["root"]
    dirs = started["dirs"] = {k: str(root / k)
                              for k in ("pipe2", "jax", "pipe2_adam8bit")}
    todo = [(8, ("ckpt",), (dirs["jax"],))]
    for _, name, fam, spec, sched, stages, experts, cf in RUNS:
        init = convert.flax_from_params(port_model(
            fam, schedule=sched, stages=stages, experts=experts,
            cf=cf).state_dict())
        todo.append((6, ("train", name),
                     (fam, spec, sched, stages, experts, cf, init)))
    _jax()  # numpy's bfloat16, for the bf16 weights' arrays
    for name, sched, opt, held in OPT_RUNS:
        if held:
            init = convert.flax_from_params(port_model(
                "gpt", schedule=sched, bf16=opt in BF16_PARAMS)
                .state_dict())
            todo.append((10 if opt == "adam8bit" else 6, ("train", name),
                         ("gpt", {"pipe": 2}, sched, 2, 0, 1.25, init,
                          opt)))
    todo.append((6, ("restore",), (dirs["pipe2"],)))
    share = [[0, []] for _ in range(JAX_PROCS)]
    for cost, key, args in todo:
        least = min(share, key=lambda x: x[0])
        least[0] += cost
        least[1].append((key, args))
    for k, (_, jobs) in enumerate(share):
        path = str(root / f"jax{k}.pkl")
        with open(path, "wb") as f:
            pickle.dump(jobs, f)
        started["worlds"].append(World(1, path, f"{job}-j{k}",
                                       jax_refs=True, script=__file__))
    cases = {2: [], 4: []}
    for world, name, fam, spec, sched, stages, experts, cf in RUNS:
        cases[world].append(dict(
            kind="train", name=name, family=fam, spec=spec,
            schedule=sched, stages=stages, experts=experts, cf=cf))
    cases[2] += [
        dict(kind="train", name=name, family="gpt", spec={"pipe": 2},
             schedule=sched, stages=2, experts=0, cf=1.25, opt=opt)
        for name, sched, opt, _ in OPT_RUNS]
    cases[2] += [
        dict(kind="save", name="save-pipe2", spec={"pipe": 2},
             dir=dirs["pipe2"]),
        dict(kind="save", name="save-pipe2-adam8bit", spec={"pipe": 2},
             dir=dirs["pipe2_adam8bit"], opt="adam8bit"),
        dict(kind="restore", name="jax-to-pipe2", spec={"pipe": 2},
             dir=dirs["jax"])]
    for n in (2, 4):
        path = str(root / f"w{n}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"cases": cases[n]}, f)
        started["worlds"].append(World(n, path, f"{job}-w{n}",
                                       script=__file__))


@pytest.fixture(scope="module")
def runs(worlds):
    """The one-device runs, then every world's and reference's results,
    and the pipe=2 checkpoint restored on one device."""
    from test_torch_checkpoint import port_bytes

    out = {"dirs": worlds["dirs"], "one": {}}
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # beside the worlds' processes
        try:
            for _, name, fam, _, sched, stages, experts, cf in RUNS:
                out["one"][name] = port_train(fam, {}, sched, stages,
                                              experts, cf)
            for name, sched, opt, _ in OPT_RUNS:
                out["one"][name] = port_train("gpt", {}, sched, 2, 0, 1.25,
                                              opt)
        finally:
            torch.set_num_threads(threads)
    finally:
        results = [w.join(WORLD_DEADLINE_S) for w in worlds["worlds"]]
    out["jax"] = {}
    for refs in results[:JAX_PROCS]:
        out["jax"].update(refs[0])
    out["jax_ckpt"] = out["jax"].pop(("ckpt",))
    out["jax_restored"] = out["jax"].pop(("restore",))
    out["w2"], out["w4"] = results[JAX_PROCS:]
    # The pipe=2 checkpoints on one device, here.
    t = ckpt_trainer({}, worlds["dirs"]["pipe2"], seed=5)
    out["one_restored"] = (t.restore(), port_bytes(t.state))
    t.close()
    t = ckpt_trainer({}, worlds["dirs"]["pipe2_adam8bit"], seed=5,
                     opt="adam8bit")
    out["one_restored_adam8bit"] = (t.restore(), port_bytes(t.state))
    t.close()
    return out


def _whole(ranks, name):
    """Every rank's parameters of a run, by name (a name two ranks hold
    must be equal on both)."""
    whole = {}
    for rank in ranks:
        for n, v in rank[name]["params"].items():
            if n in whole:
                np.testing.assert_array_equal(whole[n], v, err_msg=n)
            whole[n] = v
    return whole


@pytest.mark.parametrize("world,name,family,spec,schedule,stages", [
    r[:6] for r in RUNS], ids=[r[1] for r in RUNS])
def test_pipe_training_matches_jax_and_one_device(runs, world, name, family,
                                                  spec, schedule, stages):
    from dlrover_tpu_torch.accel import pipeline
    from dlrover_tpu_torch.models.convert import params_from_flax

    ranks = runs[f"w{world}"]
    one = runs["one"][name]
    jax_losses, jax_params = runs["jax"][("train", name)]
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank[name]["losses"], one["losses"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=f"rank {r}")
    np.testing.assert_allclose(one["losses"], jax_losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    whole = _whole(ranks, name)
    jax_whole = {n: t.numpy() for n, t in params_from_flax(jax_params).items()}
    assert whole.keys() == one["params"].keys() == jax_whole.keys()
    for n, v in whole.items():
        np.testing.assert_allclose(v, one["params"][n], rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=n)
        np.testing.assert_allclose(v, jax_whole[n], rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=n)
    # The ticks each rank ran, and the one-device loop's: JAX's formula.
    per_step = (pipeline.gpipe_ticks(4, stages) if schedule == "gpipe"
                else pipeline.circular_ticks(4, stages, 2))
    assert [rank[name]["ticks"] for rank in ranks] == \
        [STEPS * per_step] * world
    assert one["ticks"] == STEPS * per_step


@pytest.mark.parametrize("world,name,family,spec", [
    r[:4] for r in RUNS], ids=[r[1] for r in RUNS])
def test_pipe_ranks_hold_their_stages(runs, world, name, family, spec):
    """A rank holds its block of stages (bank rows, every chunk), the
    first the embedding, the last the final norm and head (GPT's tied
    ``wte`` on both)."""
    import re

    pipe = spec["pipe"]
    stages = [r for r in RUNS if r[1] == name][0][5]
    k = stages // pipe
    for g, rank in enumerate(runs[f"w{world}"]):
        coord = g % pipe  # the mesh is (data, pipe)
        names = set(rank[name]["params"])
        held = {int(re.match(r"pipeline\.\w+\.(\d+)\.", n).group(1))
                for n in names if n.startswith("pipeline.")}
        assert held == set(range(coord * k, (coord + 1) * k)), (g, held)
        top = {n for n in names if not n.startswith("pipeline.")}
        if family == "gpt":
            want = ({"wte.weight"} if coord in (0, pipe - 1) else set()) | (
                {"wpe"} if coord == 0 else set()) | (
                {"ln_f.weight", "ln_f.bias"} if coord == pipe - 1 else set())
        else:
            want = ({"embed.weight"} if coord == 0 else set()) | (
                {"final_norm.weight", "lm_head.kernel"}
                if coord == pipe - 1 else set())
        assert top == want, (g, top)


def test_pipe_checkpoint_restores_at_pipe2_and_on_one_device(runs):
    """The pipe=2 snapshot of step 2: each rank writes its stages (the
    leaves keep their stage dim), a fresh pipe=2 trainer restores it
    bit for bit, and so does one device; the restored trainers' eval
    losses equal the saving ones'."""
    w2 = runs["w2"]
    saved = assemble([r["save-pipe2"]["saved"] for r in w2])
    assert assemble([r["save-pipe2"]["restored"] for r in w2]) == saved
    assert all(r["save-pipe2"]["step"] == 2 for r in w2)
    stage = "['params']['pipeline']['ticks']['stages']['stage']['blocks']"
    for g, rank in enumerate(w2):
        blocks = [b for b in rank["save-pipe2"]["saved"]
                  if b[0] == stage + "['qkv']['kernel']"]
        assert [(b[1][0], b[2][0], b[5]) for b in blocks] == \
            [((g, g + 1), 2, True)]
    assert runs["one_restored"] == (2, saved)
    for r in w2:
        a, b = r["save-pipe2"]["eval"]
        assert a == b


@pytest.mark.parametrize("name,schedule,opt,held", OPT_RUNS,
                         ids=[r[0] for r in OPT_RUNS])
def test_pipe_optimizers_train_bit_for_bit_as_one_device(runs, name,
                                                         schedule, opt,
                                                         held):
    """pipe=2 under the 8-bit Adam and fp32 masters: every rank's losses
    and the ranks' parameters (the tied ``wte`` equal on both) are the
    one device's bit for bit; a rank's state is its stages' (and ends')
    only, the stages' rows of the one device's state, bit for bit; the
    steps ran no all-gather; the losses and parameters are JAX's (2e-5;
    the 8-bit Adam's parameters to the fit test's bounds; under fp32
    masters the masters)."""
    from dlrover_tpu_torch.models.convert import params_from_flax

    ranks, one = runs["w2"], runs["one"][name]
    for rank in ranks:
        assert rank[name]["losses"] == one["losses"]
        assert rank[name]["gathers"] == []
    whole = _whole(ranks, name)
    assert whole.keys() == one["params"].keys()
    for n, v in whole.items():
        assert np.array_equal(v, one["params"][n]), n
    # Each rank's state: its stage's rows of every stage leaf's.
    stage = "pipeline/"
    for r, rank in enumerate(ranks):
        got = rank[name]["state"]
        assert got
        for key, val in got.items():
            want = one["state"][key]
            if key[0] == "master":
                assert np.array_equal(val, want), key
                continue
            for a, b in zip(val, want):
                if key[1].startswith(stage):
                    assert a.shape[0] == b.shape[0] // 2, key
                    b = b[r * a.shape[0]:(r + 1) * a.shape[0]]
                assert np.array_equal(a, b), key
        paths = {k[1] for k in got if k[0] != "master"}
        everywhere = {k[1] for k in one["state"] if k[0] != "master"}
        ends = {"wte/embedding", "wpe"} if r == 0 else {
            "wte/embedding", "ln_f/scale", "ln_f/bias"}
        if opt != "bf16":
            assert paths == {p for p in everywhere
                             if p.startswith(stage)} | ends, paths
    if not held:
        return
    jax_losses, jax_params = runs["jax"][("train", name)]
    np.testing.assert_allclose(one["losses"], jax_losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    want = {n: t.float().numpy() for n, t in
            params_from_flax(jax_params).items()}
    if opt == "adam8bit":
        from test_torch_optim import FIT_PARAM_MAX, FIT_PARAM_MEDIAN

        diffs = np.concatenate([np.abs(whole[n] - want[n]).reshape(-1)
                                for n in want])
        assert diffs.max() <= FIT_PARAM_MAX, diffs.max()
        assert np.median(diffs) <= FIT_PARAM_MEDIAN, np.median(diffs)
    else:
        # JAX's masters against the port's (the bf16 parameters are
        # their roundings, one ulp apart where a master sits on an edge).
        masters = {}
        for rank in ranks:
            masters.update({k[1]: v for k, v in rank[name]["state"].items()
                            if k[0] == "master"})
        for n in want:
            np.testing.assert_allclose(masters[n], want[n], rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=n)


def test_pipe_adam8bit_checkpoint_restores_bit_for_bit(runs):
    """The 8-bit Adam's pipe=2 snapshot of step 2: each rank writes its
    stages' rows of every stage leaf's moments (blocks of the global
    ``[P, blocks, 256]`` leaf), a fresh pipe=2 trainer restores them bit
    for bit, and so does one device; the eval losses agree."""
    w2 = runs["w2"]
    saved = assemble([r["save-pipe2-adam8bit"]["saved"] for r in w2])
    assert assemble([r["save-pipe2-adam8bit"]["restored"] for r in w2]) \
        == saved
    q = ("['opt'].m['pipeline']['ticks']['stages']['stage']['blocks']"
         "['qkv']['kernel'].q")
    for g, rank in enumerate(w2):
        blocks = [b for b in rank["save-pipe2-adam8bit"]["saved"]
                  if b[0] == q]
        assert [(b[1][0], b[2][0], b[5]) for b in blocks] == \
            [((g, g + 1), 2, True)]
    assert runs["one_restored_adam8bit"] == (2, saved)
    for r in w2:
        a, b = r["save-pipe2-adam8bit"]["eval"]
        assert a == b


def test_pipe_checkpoints_cross_between_the_packages(runs):
    """The JAX package's pipelined step 2 (one device) restores into the
    port at pipe=2; the port's pipe=2 step 2 restores into the JAX
    package on one device."""
    got = assemble([r["jax-to-pipe2"]["restored"] for r in runs["w2"]])
    assert got == runs["jax_ckpt"]
    want = assemble([r["save-pipe2"]["saved"] for r in runs["w2"]])
    assert runs["jax_restored"] == (2, want)


# ------------------------------------------------------ what raises


@pytest.mark.parametrize("spec", [{"pipe": 2, "tensor": 2},
                                  {"pipe": 2, "fsdp": 2},
                                  {"pipe": 2, "seq": 2},
                                  {"pipe": 2, "expert": 2}],
                         ids=["tensor", "fsdp", "seq", "expert"])
def test_pipe_with_other_axes_raises_naming_its_slice(spec):
    from dlrover_tpu_torch.accel import ParallelSpec, auto_accelerate
    from dlrover_tpu_torch.optim import adamw

    with pytest.raises(NotImplementedError, match="item 6"):
        auto_accelerate(port_model("gpt"), adamw(LR), global_batches()[0],
                        port_loss, spec=ParallelSpec(**spec), device="cpu")


def test_pipe_degree_without_stages_raises_as_jax():
    """JAX's ``_check_spec_axes_used``: a pipe degree with no stage leaf
    would waste its devices."""
    from dlrover_tpu_torch.accel import ParallelSpec, auto_accelerate
    from dlrover_tpu_torch.optim import adamw

    with pytest.raises(ValueError, match="'stage'.*pipeline_stages"):
        auto_accelerate(port_model("gpt", stages=0), adamw(LR),
                        global_batches()[0], port_loss,
                        spec=ParallelSpec(pipe=2), device="cpu")


if __name__ == "__main__":
    if sys.argv[1] == "--jax":
        import conftest  # noqa: F401  (8 host devices, before JAX starts)

        jax_refs(sys.argv[2])
    else:
        worker(sys.argv[1])
