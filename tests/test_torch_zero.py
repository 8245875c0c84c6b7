"""The port's ZeRO-1 against ``dlrover_tpu/accel/zero.py``.

In one process: the dim each optimizer-state leaf is sliced along
equals the JAX package's relabelling (``apply_zero``'s ``.names``) for
GPT and LLaMA tiny under AdamW, ``bf16_master_weights(adamw)``, AGD and
the 8-bit Adam (which shards nothing and warns, in both), at data
degrees 2, 4, 7 and 8 and with fsdp; and on a one-rank gloo mesh (as
the card runs ``chip_smoke.py``'s ``[zero]`` phase) the wrapper owns
whole leaves and trains bit for bit as one device, its checkpoint
stamped with degree 0.

Then worlds of gloo ranks (a file rendezvous; this file is the worker:
``python tests/test_torch_zero.py <inputs>``), beside processes of JAX
references (``--jax``). On 2 and 4 ranks ``ParallelSpec(data=N,
zero=True)`` trains GPT and LLaMA tiny three steps under AdamW, AGD and
fp32 masters: losses and parameters equal ``ParallelSpec(data=N)``'s
bit for bit, each rank's optimizer state is more than ``0.75 N`` times
smaller, and the losses are JAX's ``data=N, zero=True`` losses within
``tests/test_torch_parallel.py``'s data-axis tolerance (2e-5). On 4
ranks ``(data=2, fsdp=2, zero=True)`` and ``(data=2, tensor=2,
zero=True)`` (a slice cut from the rank's fsdp or tensor shard) train
bit for bit as the same spec without ``zero`` under AdamW and fp32
masters, and the optimizer state a rank holds is the bytes JAX's
estimate (``state_bytes_per_device``) gives a device. A
``data=2`` ZeRO checkpoint (one shard a rank, every slice written by its
owner) restores at degree 2 bit for bit, reslices into degree 4, one
device and the JAX package at degrees 2 and 4; JAX's ``data=2`` ZeRO
checkpoint restores into the port at 2 and 4; slices that do not cover
the requested degree raise ``ZeroDegreeMismatchError`` naming both
degrees.

Beside pipe, seq and expert (``BESIDE_MORE``, a world of 4 at degree 2
each): GPT tiny pipelined (GPipe and circular, 4 layers in 2 stages),
with ring attention, and with 4 experts (LLaMA tiny too) train bit for
bit as the same spec without ``zero``, each leaf sliced along the dim
JAX's ``apply_zero`` relabels (never a stage dim), a rank's state
smaller than without ZeRO. ``bf16_master_weights(adam8bit)`` under
``zero=True`` (``ADAM8_MASTERS``: data=2, and data=2 beside fsdp=2 and
pipe=2) slices the fp32 masters and keeps the 8-bit moments whole:
losses and parameters the spec's without ``zero`` bit for bit, the
moments equal on every data rank and to the unsliced run's, each
master slice the unsliced run's slice, slices that cut the 256-value
quantization blocks (GPT's ``[32, 96]`` kernels cut at column 48).
The JAX package's runs of data=2 beside pipe=2, seq=2 and expert=2 and
of the 8-bit Adam under sliced masters (the port's initial weights
carried across; the 8-bit Adam's Pallas kernel in interpret mode, the
port's plain version) hold the losses within 2e-5 and the parameters
within 2e-5 (AdamW) or to ``tests/test_torch_optim.py``'s fit bounds
(the 8-bit Adam, whose int8 rounds the gradients' last bits move).
"""

import contextlib
import dataclasses
import functools
import glob
import logging
import math
import os
import pickle
import re
import shutil
import sys
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.accel import sharding
from dlrover_tpu_torch.accel.accelerate import ParallelSpec
from dlrover_tpu_torch.accel.zero import (
    ZERO_AXIS,
    apply_zero,
    param_names,
    zero_degree_of,
    zero_dim,
    zero_sharded_paths,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig

LOSS_TOL = 2e-5  # tests/test_torch_parallel.py's data-axis tolerance
STEPS, ROWS, SEQ = 3, 8, 16
FAMILIES = ("gpt", "llama")
OPTS = ("adamw", "agd", "bf16")
LR = 1e-3
# The JAX references: (family, optimizer, data degree), fp32.
JAX_RUNS = [(f, o, n) for n in (2, 4) for f in FAMILIES
            for o in ("adamw", "agd")]
# ZeRO-1 beside another axis on 4 ranks: (axis, family, optimizer).
BESIDE = [(a, f, o) for a in ("fsdp", "tensor") for f in FAMILIES
          for o in ("adamw", "bf16")]
# Models that carry a pipe, seq or expert axis, by variant: the config
# fields each sets (both packages), and the mesh axis it takes.
VARIANTS = {
    "pipe": (dict(num_layers=4, pipeline_stages=2,
                  pipeline_microbatches=4), "pipe"),
    "circular": (dict(num_layers=4, pipeline_stages=2, pipeline_repeats=2,
                      pipeline_microbatches=4), "pipe"),
    "seq": (dict(attn_impl="ring"), "seq"),
    "expert": (dict(num_experts=4), "expert"),
}
# ZeRO-1 beside pipe, seq or expert on 4 ranks: (variant, family,
# optimizer, held to JAX's run).
BESIDE_MORE = [("pipe", "gpt", "adamw", True), ("pipe", "gpt", "bf16", False),
               ("pipe", "llama", "adamw", False),
               ("circular", "gpt", "adamw", False),
               ("seq", "gpt", "adamw", True), ("seq", "llama", "adamw", False),
               ("expert", "gpt", "adamw", True),
               ("expert", "llama", "adamw", False)]
# bf16_master_weights(adam8bit) under zero=True: (world, variant or
# another axis, family, optimizer, held to JAX's run). "f32a8" is the
# same optimizer over fp32 parameters: trained bf16 parameters are held
# to JAX's only on the same gradients (tests/test_torch_optim_more.py:
# the packages round a few bf16 gradients to the other side of a tie).
ADAM8_MASTERS = [(2, None, "gpt", "f32a8", True),
                 (2, None, "gpt", "bf16a8", False),
                 (2, None, "llama", "bf16a8", False),
                 (4, "fsdp", "gpt", "bf16a8", False),
                 (4, "pipe", "gpt", "bf16a8", False)]


@contextlib.contextmanager
def port_log(log=logger):
    """The records a package's logger (which does not propagate) emits:
    the port's by default."""
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    log.addHandler(handler)
    try:
        yield records
    finally:
        log.removeHandler(handler)


def global_batches():
    rng = np.random.default_rng(13)
    return [rng.integers(0, 256, (ROWS, SEQ), dtype=np.int64)
            for _ in range(STEPS)]


# ------------------------------------------------------ the port side


# A GPT tiny of DEEP layers: its norms' and row biases' [DEEP, 32]
# leaves are sliced along the layers (whole layers a rank).
DEEP = 40


def port_model(family, bf16=False, seed=0, init=None, variant=None):
    from dlrover_tpu_torch.models import convert

    cls, cfg = ((GPT, GPTConfig.tiny()) if family in ("gpt", "deep")
                else (Llama, LlamaConfig.tiny()))
    cfg = dataclasses.replace(
        cfg, dtype=torch.float32,
        param_dtype=torch.bfloat16 if bf16 else torch.float32)
    if family == "deep":
        cfg = dataclasses.replace(cfg, num_layers=DEEP)
    if variant in VARIANTS:
        cfg = dataclasses.replace(cfg, **VARIANTS[variant][0])
    model = cls(cfg, device="cpu",
                generator=torch.Generator().manual_seed(seed))
    if init is not None:
        model.load_state_dict(convert.params_from_flax(init))
    return model


def port_opt(name):
    from dlrover_tpu_torch.optim import adam8bit, adamw, agd
    from dlrover_tpu_torch.optim import bf16_master_weights

    return {"adamw": lambda: adamw(LR), "agd": lambda: agd(LR),
            "bf16": lambda: bf16_master_weights(adamw(LR)),
            "adam8bit": lambda: adam8bit(1e-2),
            "bf16a8": lambda: bf16_master_weights(adam8bit(1e-2)),
            "f32a8": lambda: bf16_master_weights(adam8bit(1e-2))}[name]()


def token_loss(module, params, batch):
    from dlrover_tpu_torch.models.gpt import moe_loss_fn

    out = module(batch)
    return moe_loss_fn(out, batch) if isinstance(out, tuple) \
        else loss_fn(out, batch)


def opt_state_bytes(opt) -> int:
    """The bytes of the optimizer state this rank holds."""
    from dlrover_tpu_torch.accel.accelerate import MeshOptimizer
    from dlrover_tpu_torch.accel.zero import ZeroOptimizer
    from dlrover_tpu_torch.optim.bf16 import Bf16MasterOptimizer
    from dlrover_tpu_torch.optim.low_bit import Adam8bitOptimizer

    if isinstance(opt, (ZeroOptimizer, MeshOptimizer)):
        return opt_state_bytes(opt.inner)
    if isinstance(opt, Bf16MasterOptimizer):
        return sum(t.numel() * t.element_size()
                   for t in opt.master.values()) + opt_state_bytes(opt.inner)
    if isinstance(opt, Adam8bitOptimizer):
        return sum(t.numel() * t.element_size()
                   for moment in (opt.state.m, opt.state.v)
                   for qt in moment.values() for t in qt)
    # A DTensor's bytes are this rank's shard's.
    return sum(sharding.local(t).numel() * t.element_size()
               for st in opt.state.values()
               for t in st.values() if torch.is_tensor(t))


def opt_array_bytes(opt) -> int:
    """``opt_state_bytes`` without the scalars (step counts)."""
    from dlrover_tpu_torch.accel.accelerate import MeshOptimizer
    from dlrover_tpu_torch.accel.zero import ZeroOptimizer
    from dlrover_tpu_torch.optim.bf16 import Bf16MasterOptimizer
    from dlrover_tpu_torch.optim.low_bit import Adam8bitOptimizer

    if isinstance(opt, (ZeroOptimizer, MeshOptimizer)):
        return opt_array_bytes(opt.inner)
    if isinstance(opt, Adam8bitOptimizer):
        return opt_state_bytes(opt)
    if isinstance(opt, Bf16MasterOptimizer):
        return sum(sharding.local(t).numel() * t.element_size()
                   for t in opt.master.values()) + opt_array_bytes(opt.inner)
    return sum(sharding.local(t).numel() * t.element_size()
               for st in opt.state.values()
               for t in st.values() if torch.is_tensor(t) and t.dim())


def port_train(family, opt, spec, init=None, variant=None):
    from dlrover_tpu_torch.accel import auto_accelerate

    batches = global_batches()
    with port_log() as records:
        res = auto_accelerate(port_model(family, opt.startswith("bf16"),
                                         init=init, variant=variant),
                              port_opt(opt), batches[0], token_loss,
                              spec=ParallelSpec(**spec), device="cpu")
    losses = []
    for b in batches:
        _, m = res.train_step(res.state, torch.from_numpy(
            res.local_batch(b)))
        losses.append(float(m["loss"]))
    with torch.no_grad():
        params = {n: sharding.gather_full(p, sharding.layout_of(p), p.shape)
                  .float().numpy().copy()
                  for n, p in res.state["params"].items()}
    opt = res.state["opt"]
    out = {"losses": losses, "params": params,
           "opt_bytes": opt_state_bytes(opt),
           "opt_array_bytes": opt_array_bytes(opt),
           "opt": type(opt).__name__, "dims": getattr(opt, "dims", None),
           "log": [r.getMessage() for r in records]}
    if spec.get("zero") is not None and opt_name_is_masters(opt):
        out.update(_masters_and_moments(opt))
    return out


def opt_name_is_masters(opt) -> bool:
    from dlrover_tpu_torch.optim.bf16 import Bf16MasterOptimizer
    from dlrover_tpu_torch.optim.low_bit import Adam8bitOptimizer

    inner = getattr(opt, "inner", None)
    return isinstance(inner, Bf16MasterOptimizer) and isinstance(
        inner.inner, Adam8bitOptimizer)


def _masters_and_moments(opt):
    """Under ``bf16_master_weights(adam8bit)``: the 8-bit moments (numpy,
    by leaf path) and each master as this rank's ZeRO slice of it (the
    whole master sliced the same way without ZeRO), with each slice's
    first value's place in its layer's 256-value blocks."""
    from dlrover_tpu_torch.accel.zero import ZeroOptimizer

    inner = opt.inner
    moments = {(m, path): (qt.q.numpy().copy(), qt.scale.numpy().copy())
               for m in ("m", "v")
               for path, qt in getattr(inner.inner.state, m).items()}
    masters = {n: t.numpy().copy() for n, t in inner.master.items()}
    return {"moments": moments, "masters": masters,
            "pieces": {p.name: (p.dim, p.start, p.length, p.shape)
                       for p in opt._own}
            if isinstance(opt, ZeroOptimizer) else {}}


def ckpt_trainer(spec, ckpt_dir, seed=0, init=None, family="gpt"):
    from dlrover_tpu_torch.optim import adamw
    from dlrover_tpu_torch.train.trainer import Trainer

    return Trainer(port_model(family, seed=seed, init=init), adamw(LR),
                   token_loss, global_batches()[0], spec=ParallelSpec(**spec),
                   device="cpu", checkpoint_dir=ckpt_dir, persist_every=2,
                   report_metrics=False)


def case_train(case, inputs):
    # A variant's or bf16 run's JAX twin starts from the port's weights.
    variant = case.get("variant")
    init = (inputs["init"].get(case["family"])
            if case["opt"] in ("adamw", "agd", "adam8bit") and variant is None
            else None)
    out = port_train(case["family"], case["opt"], case["spec"], init,
                     variant)
    if case["family"] == "deep" and case["spec"]["zero"]:
        # Which leaves this rank holds some layers of, whole.
        from dlrover_tpu_torch.accel import auto_accelerate

        res = auto_accelerate(port_model("deep"), port_opt("adamw"),
                              global_batches()[0], token_loss,
                              spec=ParallelSpec(**case["spec"]),
                              device="cpu")
        out["by_layers"] = sorted(
            path for path, lay in res.state["opt"]._layouts.items()
            if lay.placed)
    return out


def case_save(case, inputs):
    """Persist step 2 under ZeRO; a fresh trainer of another seed restores
    it, and one more step runs on both."""
    import torch.distributed as dist
    from test_torch_parallel import blocks_of

    family = case.get("family", "gpt")
    t = ckpt_trainer(case["spec"], case["dir"], family=family)
    t.fit(iter(global_batches()[:2]), steps=2, start_step=0)
    saved = blocks_of(t.state)
    dist.barrier()  # shard 0 has committed the step
    fresh = ckpt_trainer(case["spec"], case["dir"], seed=5, family=family)
    step = fresh.restore()
    restored = blocks_of(fresh.state)
    nxt = []
    for tr in (t, fresh):
        _, m = tr.train_step(tr.state, torch.from_numpy(
            tr._result.local_batch(global_batches()[2])))
        nxt.append(float(m["loss"]))
    t.close()
    fresh.close()
    return {"saved": saved, "restored": restored, "step": step, "next": nxt}


def case_restore(case, inputs):
    """Restore a checkpoint another degree (or package) saved; the error's
    text when it raises ``ZeroDegreeMismatchError``."""
    from dlrover_tpu_torch.common import ckpt_persist
    from test_torch_parallel import blocks_of

    t = ckpt_trainer(case["spec"], case["dir"], seed=5)
    try:
        step = t.restore()
    except ckpt_persist.ZeroDegreeMismatchError as e:
        return {"error": str(e)}
    finally:
        t.close()
    return {"step": step, "restored": blocks_of(t.state)}


CASES = {"train": case_train, "save": case_save, "restore": case_restore}


def worker(path):
    import torch.distributed as dist
    from test_torch_parallel import join_world

    torch.set_num_threads(1)
    join_world()
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    out = {case["name"]: CASES[case["kind"]](case, inputs)
           for case in inputs["cases"]}
    with open(f"{path}.rank{os.environ['RANK']}", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------ the JAX side


def jax_refs(path):
    """A process of JAX references: each (family, optimizer, degree)'s
    losses under ``data=N, zero=True``; then the saves and restores its
    inputs ask for."""
    from test_torch_checkpoint import jax_bytes
    from test_torch_parallel import _jax, jax_model

    with open(path, "rb") as f:
        todo = pickle.load(f)
    J = _jax()
    from dlrover_tpu.accel import auto_accelerate
    from dlrover_tpu.models import llama as jllama
    from dlrover_tpu.optim.agd import agd

    out = {}
    batches = [b.astype(np.int32) for b in global_batches()]
    for family, opt, n in todo.get("train", ()):
        lossf = J.gpt.loss_fn if family == "gpt" else jllama.loss_fn
        tx = J.optax.adamw(LR) if opt == "adamw" else agd(LR)
        res = auto_accelerate(
            jax_model(family), tx, batches[0],
            lambda m, p, b, f=lossf: f(m.apply({"params": p}, b), b),
            spec=J.ParallelSpec(data=n, zero=True),
            devices=J.jax.devices()[:n])
        state, losses = res.state, []
        for b in batches:
            state, m = res.train_step(state, J.jax.device_put(
                b, res.batch_sharding))
            losses.append(float(m["loss"]))
        out[family, opt, n] = losses
    for name, family, variant, opt, spec, init in todo.get("carried", ()):
        out[name] = jax_carried(family, variant, opt, spec, init)
    for name, n, ckpt_dir, save in todo.get("ckpt", ()):
        t = jax_ckpt_trainer(n, ckpt_dir)
        if save:
            t.fit(iter(batches[:2]), steps=2, start_step=0)
            out[name] = {"step": 2, "bytes": jax_bytes(t.state)}
        else:
            out[name] = {"step": t.restore(), "bytes": jax_bytes(t.state)}
        t.close()
    with open(f"{path}.rank0", "wb") as f:
        pickle.dump(out, f)


def jax_carried(family, variant, opt, spec, init):
    """(losses, params) of the JAX package's run of ``family`` configured
    as ``variant`` under ``spec``, from the port's initial params
    ``init`` (a flax tree of numpy; an optimizer's state built on
    them)."""
    from test_torch_parallel import _jax

    J = _jax()
    jax = J.jax
    from dlrover_tpu.accel import auto_accelerate
    from dlrover_tpu.models import llama as jllama
    from dlrover_tpu.optim.bf16 import bf16_master_weights
    from dlrover_tpu.optim.low_bit import adam8bit

    mod = J.gpt if family == "gpt" else jllama
    cfg = (J.gpt.GPTConfig if family == "gpt" else jllama.LlamaConfig).tiny()
    cfg = dataclasses.replace(
        cfg, dtype=J.jnp.float32,
        param_dtype=J.jnp.bfloat16 if opt.startswith("bf16")
        else J.jnp.float32, **VARIANTS.get(variant, ({},))[0])
    model = (mod.GPT if family == "gpt" else mod.Llama)(cfg)
    tx = {"adamw": lambda: J.optax.adamw(LR),
          "bf16": lambda: bf16_master_weights(J.optax.adamw(LR)),
          "bf16a8": lambda: bf16_master_weights(adam8bit(1e-2)),
          "f32a8": lambda: bf16_master_weights(adam8bit(1e-2))}[opt]()

    def lossf(m, p, b):
        out = m.apply({"params": p}, b)
        return J.gpt.moe_loss_fn(out, b) if isinstance(out, tuple) \
            else J.gpt.loss_fn(out, b)

    batches = [b.astype(np.int32) for b in global_batches()]
    s = J.ParallelSpec(**spec)
    res = auto_accelerate(model, tx, batches[0], lossf, spec=s,
                          devices=jax.devices()[:s.total])
    state = dict(res.state)
    put = functools.partial(jax.tree_util.tree_map,
                            lambda cur, new: jax.device_put(new, cur.sharding))
    state["params"] = put(state["params"], init)
    # Fresh buffers: fp32 masters would alias the params, which the step
    # donates.
    state["opt"] = put(state["opt"], jax.tree_util.tree_map(
        np.asarray, tx.init(state["params"])))
    losses = []
    for b in batches:
        state, m = res.train_step(state, jax.device_put(b, res.batch_sharding))
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), state["params"])


def jax_ckpt_trainer(n, ckpt_dir):
    """The JAX package's Trainer of GPT tiny under ``data=n, zero=True``
    (one process: its slices are one shard), persisting every 2 steps."""
    from test_torch_parallel import _jax, jax_model

    J = _jax()
    return J.trainer.Trainer(
        jax_model("gpt"), J.optax.adamw(LR),
        lambda m, p, b: J.gpt.loss_fn(m.apply({"params": p}, b), b),
        global_batches()[0].astype(np.int32),
        spec=J.ParallelSpec(data=n, zero=True), checkpoint_dir=ckpt_dir,
        persist_every=2)


# ------------------------------------------------------ the runs


def _worlds(specs, root, job, tag, init):
    """Start the port's worlds (``{n: cases}``) and JAX processes
    (``{k: todo}``)."""
    from test_torch_parallel import World

    worlds = {}
    for key, payload in specs.items():
        path = str(root / f"{tag}-{key}.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload if isinstance(key, str) else
                        {"init": init, "cases": payload}, f)
        if isinstance(key, str):
            worlds[key] = World(1, path, f"{job}-{tag}-{key}", jax_refs=True,
                                script=__file__)
        else:
            worlds[key] = World(key, path, f"{job}-{tag}-{key}",
                                script=__file__)
    # Every world is joined (its processes ended, its segments removed)
    # before the first failure is raised.
    results, failure = {}, None
    for key, w in worlds.items():
        try:
            results[key] = w.join()
        except BaseException as e:  # pytest.fail's Failed among them
            failure = failure or e
    if failure is not None:
        raise failure
    return results


def _cut(src, dst):
    """A copy of a ZeRO step with the slices of shard 1 dropped from its
    meta, as a restoring rank sees a step whose peers' slices are gone."""
    from dlrover_tpu_torch.common import ckpt_meta, ckpt_persist

    shutil.copytree(src, dst)
    path = os.path.join(ckpt_persist.step_dir(dst, 2), "shard_1.meta")
    with open(path, "rb") as f:
        meta = ckpt_meta.loads(f.read())
    kept = [t for t in meta.tensors
            if not (t.index is not None and t.path.startswith("['opt']"))]
    assert len(kept) < len(meta.tensors)
    meta.tensors = kept
    with open(path, "wb") as f:
        f.write(ckpt_meta.dumps(meta))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both phases' worlds and JAX processes; this process's trainers run
    under a job name of the fixture's, whose segments go afterwards."""
    root = tmp_path_factory.mktemp("zero")
    job = f"zero-{uuid.uuid4().hex[:8]}"
    old = os.environ.get("DLROVER_TPU_JOB_NAME")
    os.environ["DLROVER_TPU_JOB_NAME"] = job + "-main"
    try:
        yield _runs(root, job)
    finally:
        if old is None:
            os.environ.pop("DLROVER_TPU_JOB_NAME", None)
        else:
            os.environ["DLROVER_TPU_JOB_NAME"] = old
        for path in glob.glob(f"/dev/shm/ckpt_{job}*"):
            os.unlink(path)


def more_name(variant, family, opt, zero):
    return f"{family}-{opt}-{zero}-{variant}"


def masters_name(other, family, opt, zero):
    return f"{family}-{opt}-{zero}-data2" + (f"-{other}2" if other else "")


def _runs(root, job):
    from test_torch_parallel import jax_init

    init = {f: jax_init(f) for f in FAMILIES}
    dirs = {k: str(root / k) for k in ("port2", "jax2", "cut", "deep2")}
    train = [dict(kind="train", name=f"{f}-{o}-{z}", family=f, opt=o,
                  spec=dict(data=0, zero=z))
             for f in FAMILIES for o in OPTS for z in (False, True)]
    train += [dict(kind="train", name=f"gpt-adam8bit-{z}", family="gpt",
                   opt="adam8bit", spec=dict(data=0, zero=z))
              for z in (False, True)]
    train += [dict(kind="train", name=f"deep-adamw-{z}", family="deep",
                   opt="adamw", spec=dict(data=0, zero=z))
              for z in (False, True)]

    def at(n):
        return [dict(c, spec=dict(c["spec"], data=n)) for c in train]

    save = [dict(kind="save", name="save", spec=dict(data=2, zero=True),
                 dir=dirs["port2"]),
            dict(kind="save", name="save-deep", family="deep",
                 spec=dict(data=2, zero=True), dir=dirs["deep2"])]
    half = len(JAX_RUNS) // 2
    beside = [dict(kind="train", name=f"{f}-{o}-{z}-{a}", family=f, opt=o,
                   spec={"data": 2, a: 2, "zero": z})
              for a, f, o in BESIDE for z in (False, True)]
    beside += [dict(kind="train", name=more_name(v, f, o, z), family=f,
                    opt=o, variant=v, spec={"data": 2, VARIANTS[v][1]: 2,
                                            "zero": z})
               for v, f, o, _ in BESIDE_MORE for z in (False, True)]
    masters = {2: [], 4: []}
    for world, other, f, o, _ in ADAM8_MASTERS:
        v = other if other in VARIANTS else None
        extra = {} if other is None else {VARIANTS[v][1] if v else other: 2}
        masters[world] += [dict(kind="train",
                                name=masters_name(other, f, o, z),
                                family=f, opt=o, variant=v,
                                spec=dict(data=2, zero=z, **extra))
                           for z in (False, True)]
    # The JAX runs from the port's weights (a third and a fourth process).
    from dlrover_tpu_torch.models import convert

    carried = []
    for v, f, o, held in BESIDE_MORE:
        if held:
            carried.append((more_name(v, f, o, True), f, v, o,
                            {"data": 2, VARIANTS[v][1]: 2, "zero": True}))
    for world, other, f, o, held in ADAM8_MASTERS:
        if held:
            carried.append((masters_name(other, f, o, True), f, None, o,
                            {"data": 2, "zero": True}))
    carried = [job + (convert.flax_from_params(port_model(
        job[1], job[3].startswith("bf16"), variant=job[2]).state_dict()),)
        for job in carried]
    first = _worlds({2: at(2) + save + masters[2],
                     4: at(4) + beside + masters[4],
                     "a": {"train": JAX_RUNS[:half],
                           "ckpt": [("jax-save", 2, dirs["jax2"], True)]},
                     "b": {"train": JAX_RUNS[half:]},
                     "c": {"carried": carried[::2]},
                     "d": {"carried": carried[1::2]}},
                    root, job, "1", init)
    _cut(dirs["port2"], dirs["cut"])

    def restore(name, n, d):
        return dict(kind="restore", name=name, spec=dict(data=n, zero=True),
                    dir=d)

    second = _worlds({2: [restore("jax-at-2", 2, dirs["jax2"])],
                      4: [restore("port-at-4", 4, dirs["port2"]),
                          restore("jax-at-4", 4, dirs["jax2"]),
                          restore("cut-at-4", 4, dirs["cut"])],
                      "c": {"ckpt": [("port-in-jax-2", 2, dirs["port2"],
                                      False),
                                     ("port-in-jax-4", 4, dirs["port2"],
                                      False)]}},
                     root, job, "2", init)
    jax = {**first["a"][0], **first["b"][0], **first["c"][0],
           **first["d"][0], **second["c"][0]}
    return {"w2": first[2], "w4": first[4], "r2": second[2],
            "r4": second[4], "jax": jax, "dirs": dirs}


# ------------------------------------------------------ the dim choice


def _jax_abstract(family, opt, bf16, variant=None):
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.models import gpt as jgpt
    from dlrover_tpu.models import llama as jllama
    from dlrover_tpu.optim.agd import agd
    from dlrover_tpu.optim.bf16 import bf16_master_weights
    from dlrover_tpu.optim.low_bit import adam8bit

    pd = jnp.bfloat16 if bf16 else jnp.float32
    over = VARIANTS[variant][0] if variant else {}
    model = (jgpt.GPT(dataclasses.replace(jgpt.GPTConfig.tiny(),
                                          param_dtype=pd, **over))
             if family == "gpt" else
             jllama.Llama(dataclasses.replace(jllama.LlamaConfig.tiny(),
                                              param_dtype=pd, **over)))
    tx = {"adamw": lambda: optax.adamw(LR), "agd": lambda: agd(LR),
          "bf16": lambda: bf16_master_weights(optax.adamw(LR)),
          "adam8bit": lambda: adam8bit(LR)}[opt]()
    tokens = jnp.zeros((ROWS, SEQ), jnp.int32)

    def init_fn(r):
        p = model.init(r, tokens)["params"]
        return {"params": p, "opt": tx.init(p), "step": 0}

    return jax.eval_shape(init_fn, jax.random.PRNGKey(0))


def _jax_opt_names(abstract):
    """{keystr under ['opt']: names} of the boxed optimizer leaves."""
    import jax

    flat = jax.tree_util.tree_flatten_with_path(
        abstract["opt"], is_leaf=lambda x: hasattr(x, "names"))[0]
    return {"['opt']" + jax.tree_util.keystr(p): tuple(leaf.names)
            for p, leaf in flat if hasattr(leaf, "names")}


DEGREES = [dict(data=2), dict(data=4), dict(data=7), dict(data=8),
           dict(data=2, fsdp=4), dict(data=2, tensor=2),
           dict(data=2, fsdp=2, tensor=2)]


@pytest.mark.parametrize("spec", DEGREES,
                         ids=["-".join(f"{k}{v}" for k, v in d.items())
                              for d in DEGREES])
@pytest.mark.parametrize("opt", ["adamw", "bf16", "agd", "adam8bit"])
@pytest.mark.parametrize("family", FAMILIES)
def test_dim_choice_matches_jax(family, opt, spec):
    """Each optimizer-state leaf's names after the relabelling equal
    JAX's ``apply_zero``'s (an indivisible degree shards nothing; fsdp's
    dims keep their names). AGD has no JAX train-state layout in the
    port, so its moments are held leaf by leaf through their params."""
    from dlrover_tpu.accel import ParallelSpec as JSpec
    from dlrover_tpu.accel import zero as jzero
    from dlrover_tpu_torch.accel import search
    from dlrover_tpu_torch.models.convert import param_leaves

    bf16 = opt in ("bf16", "adam8bit")
    jspec, tspec = JSpec(zero=True, **spec), ParallelSpec(zero=True, **spec)
    jab = _jax_abstract(family, opt, bf16)
    want = _jax_opt_names(jzero.apply_zero(jab, jspec, jspec.rules(),
                                           warn=False))
    model = port_model(family, bf16)
    if opt == "agd":
        groups = param_leaves(dict(model.named_parameters()))
        names = param_names(model, groups)
        for path, jnames in want.items():
            # ['opt'].exp_avg['blocks']['qkv']['kernel'] -> its param
            leaf = "/".join(re.findall(r"\['([^']*)'\]", path)[1:])
            dim = zero_dim(names[leaf], groups[leaf].shape, tspec.rules(),
                           spec["data"])
            got = names[leaf] if dim is None else (
                names[leaf][:dim] + (ZERO_AXIS,) + names[leaf][dim + 1:])
            assert got == jnames, path
        assert want
        return
    abstract = search.abstract_state(model, port_opt(opt))
    got = apply_zero(abstract, tspec, tspec.rules(), warn=False)
    got = {leaf.path: leaf.names for leaf in got
           if leaf.path.startswith("['opt']") and leaf.names is not None}
    assert got == want
    sharded = zero_sharded_paths(apply_zero(abstract, tspec, tspec.rules(),
                                            warn=False))
    assert sharded == [p for p, n in want.items() if ZERO_AXIS in n]
    if opt == "adam8bit" or spec["data"] == 7:
        assert not sharded


def test_eight_bit_adam_shards_nothing_and_warns_as_jax():
    """JAX unboxes the 8-bit moments, so ``apply_zero`` finds nothing to
    shard and warns; the port's relabelling warns the same words."""
    from dlrover_tpu.accel import ParallelSpec as JSpec
    from dlrover_tpu.accel import zero as jzero
    from dlrover_tpu.common.log import logger as jax_logger
    from dlrover_tpu_torch.accel import search

    jspec = JSpec(data=2, zero=True)
    with port_log(jax_logger) as jax_records:
        jzero.apply_zero(_jax_abstract("gpt", "adam8bit", True), jspec,
                         jspec.rules())
    jax_warning = [r.getMessage() for r in jax_records]
    spec = ParallelSpec(data=2, zero=True)
    with port_log() as records:
        apply_zero(search.abstract_state(port_model("gpt", True),
                                         port_opt("adam8bit")),
                   spec, spec.rules())
    assert jax_warning and [r.getMessage() for r in records] == jax_warning


def test_zero_degree_of_is_jax():
    from dlrover_tpu.accel import ParallelSpec as JSpec
    from dlrover_tpu.accel import zero as jzero

    for kw in (dict(data=8, zero=True), dict(data=8), dict(zero=True),
               dict(data=2, fsdp=2, zero=True)):
        assert zero_degree_of(ParallelSpec(**kw)) == jzero.zero_degree_of(
            JSpec(**kw))


@pytest.mark.parametrize("spec", [dict(fsdp=2), dict(tensor=2),
                                  dict(seq=2), dict(expert=2), dict(pipe=2)],
                         ids=["fsdp", "tensor", "seq", "expert", "pipe"])
def test_zero_with_another_axis_raises_naming_the_item(world_of_one, spec):
    """ZeRO-1 beside any other axis is placed (4 ranks train it below):
    the spec check passes it (a world of one then refuses its degrees,
    and nothing names a later item), and on a one-rank mesh of data and
    that axis, with a model that carries it (pipelined, ring attention,
    experts), the optimizer is a ``ZeroOptimizer`` and the losses the
    one device's bit for bit."""
    from dlrover_tpu_torch.accel import accelerate, auto_accelerate, mesh
    from dlrover_tpu_torch.accel.zero import ZeroOptimizer

    (axis,) = spec
    variant = {"seq": "seq", "expert": "expert", "pipe": "pipe"}.get(axis)
    with pytest.raises(ValueError, match="world of 4"):
        auto_accelerate(port_model("gpt", variant=variant),
                        port_opt("adamw"), global_batches()[0], token_loss,
                        spec=ParallelSpec(data=2, zero=True, **spec),
                        device="cpu")
    batches = global_batches()
    one = auto_accelerate(port_model("gpt", variant=variant),
                          port_opt("adamw"), batches[0], token_loss,
                          spec=ParallelSpec(), device="cpu")
    m = mesh.create_mesh([("data", 1), (axis, 1)], torch.device("cpu"))
    res = accelerate.accelerate_on_mesh(
        port_model("gpt", variant=variant), port_opt("adamw"), batches[0],
        token_loss, m, device="cpu", zero=True)
    assert isinstance(res.state["opt"], ZeroOptimizer)
    for b in batches:
        _, a = res.train_step(res.state, torch.from_numpy(b))
        _, w = one.train_step(one.state, torch.from_numpy(b))
        assert float(a["loss"]) == float(w["loss"])


def test_zero_with_an_explicit_offload_asks_for_offload_optimizer():
    """``offload(inner)`` passed as the optimizer under ``zero=True``: the
    port slices ``inner``'s state and offloads the slices when given
    ``offload_optimizer=True``, and says so."""
    from dlrover_tpu_torch.accel.zero import _sliceable
    from dlrover_tpu_torch.optim import adamw, offload

    with pytest.raises(ValueError, match="offload_optimizer=True"):
        _sliceable(offload(adamw(LR)))


def test_a_shared_shard_refuses_a_zero_state():
    """Data ranks are not replicas of their slices: one shard written by
    the lowest replica would drop the others'."""
    from dlrover_tpu_torch.train.checkpoint.engine import CheckpointEngine

    with pytest.raises(ValueError, match="ShardedCheckpointer"):
        CheckpointEngine("/nonexistent", replica_rank=1, replica_count=2,
                         zero_degree=2)


# ------------------------------------------------------ a world of one


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    """A gloo process group of one rank, as the card's NCCL one."""
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.fail("a process group is already up in this process")
    rdzv = tmp_path_factory.mktemp("zero-world-of-one") / "rdzv"
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_zero_on_a_plain_module_beside_fsdp_and_tensor(world_of_one):
    """A plain module (``tests/test_torch_registry.py``'s MHA twin) with
    ``zero=True`` on ("data", 1), ("fsdp", 1), ("tensor", 1): planned
    (its q/k/v/up ``ParallelLinear``s column-parallel), its optimizer a
    ``ZeroOptimizer`` over the registry's axes, its losses the one
    device's bit for bit."""
    from dlrover_tpu_torch.accel import accelerate, auto_accelerate, mesh
    from dlrover_tpu_torch.accel.zero import ZeroOptimizer
    from dlrover_tpu_torch.models.tensor_parallel import ParallelLinear
    from test_torch_registry import token_loss as plain_loss, torch_model

    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 128, (ROWS, SEQ)) for _ in range(STEPS)]

    def twin():
        torch.manual_seed(3)
        return torch_model("mha")

    one = auto_accelerate(twin(), port_opt("adamw"), batches[0], plain_loss,
                          spec=ParallelSpec(), device="cpu")
    m = mesh.create_mesh([("data", 1), ("fsdp", 1), ("tensor", 1)],
                         torch.device("cpu"))
    res = accelerate.accelerate_on_mesh(
        twin(), port_opt("adamw"), batches[0], plain_loss, m, device="cpu",
        zero=True, allow_tensor=True)
    assert isinstance(res.state["opt"], ZeroOptimizer)
    assert isinstance(res.module.block_0.q_proj, ParallelLinear)
    for b in batches:
        _, a = res.train_step(res.state, torch.from_numpy(b))
        _, w = one.train_step(one.state, torch.from_numpy(b))
        assert float(a["loss"]) == float(w["loss"])


@pytest.mark.parametrize("opt", ["adamw", "bf16", "adam8bit"])
def test_data_axis_of_one_owns_whole_leaves(world_of_one, opt, tmp_path,
                                            monkeypatch):
    """On ("data", 1) the wrapper runs (its all-gather a copy) and its
    slices are whole leaves: losses and parameters bit for bit the one
    device's; its snapshot is stamped with degree 0 and restores into a
    one-device trainer bit for bit. The 8-bit Adam shards nothing: JAX's
    warning, and the mesh's usual optimizer."""
    job = f"zero1-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
    try:
        _one_rank_zero(opt, tmp_path)
    finally:
        for path in glob.glob(f"/dev/shm/ckpt_{job}_*"):
            os.unlink(path)


def _one_rank_zero(opt, tmp_path):
    from dlrover_tpu_torch.accel import accelerate, auto_accelerate, mesh
    from dlrover_tpu_torch.accel.zero import ZeroOptimizer
    from dlrover_tpu_torch.common import ckpt_persist
    from dlrover_tpu_torch.common.storage import PosixDiskStorage
    from dlrover_tpu_torch.train.checkpoint import (
        FlashCheckpointer,
        ShardedCheckpointer,
        StorageType,
    )
    from test_torch_checkpoint import port_bytes

    batches = global_batches()
    bf16 = opt != "adamw"
    one = auto_accelerate(port_model("gpt", bf16), port_opt(opt), batches[0],
                          token_loss, spec=ParallelSpec(), device="cpu")
    m = mesh.create_mesh([("data", 1)], torch.device("cpu"))
    with port_log() as records:
        res = accelerate.accelerate_on_mesh(
            port_model("gpt", bf16), port_opt(opt), batches[0], token_loss,
            m, device="cpu", zero=True)
    assert res.spec.zero and zero_degree_of(res.spec) == 0
    zero = isinstance(res.state["opt"], ZeroOptimizer)
    assert zero == (opt != "adam8bit")
    warned = any("no optimizer-state leaf" in r.getMessage()
                 for r in records)
    assert warned == (opt == "adam8bit")
    if zero:
        assert set(res.state["opt"].slices) == set(res.state["params"])
    for b in batches:
        _, a = res.train_step(res.state, torch.from_numpy(b))
        _, w = one.train_step(one.state, torch.from_numpy(b))
        assert float(a["loss"]) == float(w["loss"])
    for name, p in res.state["params"].items():
        assert torch.equal(p, one.state["params"][name]), name
    ck = ShardedCheckpointer(str(tmp_path), mesh_axes={"data": 1},
                             zero_degree=zero_degree_of(res.spec))
    assert ck.save_checkpoint(STEPS, res.state, StorageType.DISK)
    ck.close()
    metas = ckpt_persist.load_step_metas(PosixDiskStorage(), str(tmp_path),
                                         STEPS)
    assert metas and all(meta.zero_degree == 0 for meta in metas.values())
    fresh = auto_accelerate(port_model("gpt", bf16, seed=7), port_opt(opt),
                            batches[0], token_loss, spec=ParallelSpec(),
                            device="cpu")
    ck = FlashCheckpointer(str(tmp_path))
    assert ck.load_checkpoint(fresh.state)[0] == STEPS
    ck.close()
    assert port_bytes(fresh.state) == port_bytes(one.state)


# ------------------------------------------------------ training on 2 and 4


TRAIN = [(n, f, o) for n in (2, 4) for f in FAMILIES for o in OPTS]


@pytest.mark.parametrize("world,family,opt", TRAIN,
                         ids=[f"{f}-{o}-data{n}" for n, f, o in TRAIN])
def test_zero_trains_bit_for_bit_as_data(runs, world, family, opt):
    for rank in runs[f"w{world}"]:
        z, d = rank[f"{family}-{opt}-True"], rank[f"{family}-{opt}-False"]
        assert z["opt"].startswith("Zero") and not d["opt"].startswith("Zero")
        assert z["losses"] == d["losses"]
        for n in d["params"]:
            assert np.array_equal(z["params"][n], d["params"][n]), n
        assert d["opt_bytes"] > 0.75 * world * z["opt_bytes"], (
            d["opt_bytes"], z["opt_bytes"])
    assert len({tuple(r[f"{family}-{opt}-True"]["losses"])
                for r in runs[f"w{world}"]}) == 1


def _jax_opt_bytes(family, opt, spec, fsdp_everywhere=False):
    """JAX's estimate of the optimizer state's bytes a device holds under
    ``spec`` (``state_bytes_per_device``'s arithmetic over the abstract
    opt subtree, ZeRO's relabelling first), without its scalars. With
    ``fsdp_everywhere`` a leaf no logical axis puts on fsdp is split
    along dim 0 over it too, as FSDP2 shards every parameter."""
    import jax

    from dlrover_tpu.accel import ParallelSpec as JSpec
    from dlrover_tpu.accel import zero as jzero

    jspec = JSpec(**spec)
    rules = dict(jspec.rules())
    tree = jzero.apply_zero(_jax_abstract(family, opt, opt == "bf16"),
                            jspec, jspec.rules(), warn=False)["opt"]
    sizes = {"data": jspec.data, "fsdp": jspec.fsdp, "tensor": jspec.tensor}
    total = 0
    for leaf in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: hasattr(x, "names")):
        value = getattr(leaf, "value", leaf)
        if not value.shape:
            continue
        names = getattr(leaf, "names", (None,) * len(value.shape))
        divs = []
        for name in names:
            axes = rules.get(name) if name else None
            axes = (axes,) if isinstance(axes, str) else (axes or ())
            divs.append(math.prod(sizes.get(a, 1) for a in axes))
        if fsdp_everywhere and not any(
                "fsdp" in ((rules.get(n),) if isinstance(rules.get(n), str)
                           else (rules.get(n) or ())) for n in names if n):
            divs[0] *= jspec.fsdp
        total += math.prod(-(-d // v) for d, v in zip(value.shape, divs)) \
            * value.dtype.itemsize
    return total


@pytest.mark.parametrize("axis,family,opt", BESIDE,
                         ids=[f"{f}-{o}-data2-{a}2" for a, f, o in BESIDE])
def test_zero_beside_another_axis_trains_bit_for_bit(runs, axis, family, opt):
    """ZeRO-1 beside fsdp or tensor on 4 ranks: losses and parameters the
    same spec's without ``zero`` bit for bit, every rank alike; the
    optimizer state a rank holds falls to JAX's estimate of a device's,
    exactly (without ``zero``, AdamW's moments are the shards' and equal
    JAX's too; ``bf16_master_weights`` keeps its state whole there, as
    every ``update_and_apply`` optimizer does on a mesh). Under fsdp the
    estimate also splits over fsdp the leaves JAX's rules leave whole on
    it (the biases of the column-parallel layers), which FSDP2 shards."""
    spec = {"data": 2, axis: 2}
    everywhere = axis == "fsdp"
    want = _jax_opt_bytes(family, opt, dict(spec, zero=True), everywhere)
    assert want < _jax_opt_bytes(family, opt, spec, everywhere)
    for rank in runs["w4"]:
        z = rank[f"{family}-{opt}-True-{axis}"]
        d = rank[f"{family}-{opt}-False-{axis}"]
        assert z["opt"].startswith("Zero") and not d["opt"].startswith("Zero")
        assert z["losses"] == d["losses"]
        for n in d["params"]:
            assert np.array_equal(z["params"][n], d["params"][n]), n
        assert z["opt_array_bytes"] == want
        if opt == "adamw":
            assert d["opt_array_bytes"] == _jax_opt_bytes(family, opt, spec,
                                                          everywhere)
    assert len({tuple(r[f"{family}-{opt}-True-{axis}"]["losses"])
                for r in runs["w4"]}) == 1


def _jax_zero_dims(family, opt, variant, spec):
    """JAX's ZeRO dim of each params leaf (by ``/``-path; None: whole):
    where ``apply_zero`` puts ``zero_dp`` on the leaf's first optimizer
    state that mirrors it (AdamW's ``mu``, the masters)."""
    from dlrover_tpu.accel import ParallelSpec as JSpec
    from dlrover_tpu.accel import zero as jzero

    jspec = JSpec(**spec)
    names = _jax_opt_names(jzero.apply_zero(
        _jax_abstract(family, opt, opt.startswith("bf16"), variant), jspec,
        jspec.rules(), warn=False))
    head = "['opt'].master" if opt.startswith("bf16") else "['opt'][0].mu"
    out = {}
    for path, n in names.items():
        if path.startswith(head):
            leaf = "/".join(re.findall(r"\['([^']*)'\]", path[len(head):]))
            out[leaf] = n.index(ZERO_AXIS) if ZERO_AXIS in n else None
    return out


@pytest.mark.parametrize("variant,family,opt,held", BESIDE_MORE,
                         ids=[more_name(*c[:3], "") + "data2"
                              for c in BESIDE_MORE])
def test_zero_beside_pipe_seq_expert_trains_bit_for_bit(runs, variant,
                                                        family, opt, held):
    """ZeRO-1 over data=2 beside pipe=2 (GPipe, circular), seq=2 (ring)
    or expert=2: losses and parameters the same spec's without ``zero``
    bit for bit, every rank alike; each leaf sliced along the dim JAX's
    ``apply_zero`` relabels (never a pipelined leaf's stage dim: the
    pipe axis shards it); a rank's state smaller than without ZeRO; the
    JAX package's losses and parameters within 2e-5."""
    from dlrover_tpu_torch.models.convert import params_from_flax

    axis = VARIANTS[variant][1]
    spec = {"data": 2, axis: 2, "zero": True}
    want_dims = _jax_zero_dims(family, opt, variant, spec)
    for rank in runs["w4"]:
        z = rank[more_name(variant, family, opt, True)]
        d = rank[more_name(variant, family, opt, False)]
        assert z["opt"].startswith("Zero") and not d["opt"].startswith("Zero")
        assert z["losses"] == d["losses"]
        for n in d["params"]:
            assert np.array_equal(z["params"][n], d["params"][n]), n
        assert z["opt_array_bytes"] < d["opt_array_bytes"]
        assert z["dims"] == {p: want_dims[p] for p in z["dims"]}
        assert any(dim is not None for dim in z["dims"].values())
        if variant in ("pipe", "circular"):
            assert all(dim != 0 for p, dim in z["dims"].items()
                       if p.startswith("pipeline/"))
    assert len({tuple(r[more_name(variant, family, opt, True)]["losses"])
                for r in runs["w4"]}) == 1
    if not held:
        return
    jax_losses, jax_params = runs["jax"][more_name(variant, family, opt,
                                                   True)]
    got = runs["w4"][0][more_name(variant, family, opt, True)]
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    # Every rank's parameters (a pipe rank's: its stages and ends).
    want = params_from_flax(jax_params)
    for rank in runs["w4"]:
        for n, v in rank[more_name(variant, family, opt, True)][
                "params"].items():
            np.testing.assert_allclose(v, want[n].float().numpy(),
                                       rtol=LOSS_TOL, atol=LOSS_TOL,
                                       err_msg=n)


@pytest.mark.parametrize(
    "world,other,family,opt,held", ADAM8_MASTERS,
    ids=[f"{f}-{o}-data2" + (f"-{x}2" if x else "")
         for _, x, f, o, _ in ADAM8_MASTERS])
def test_eight_bit_adam_under_sliced_masters(runs, world, other, family,
                                             opt, held):
    """``bf16_master_weights(adam8bit)`` with ``zero=True``: the masters
    sliced over data, the 8-bit moments whole, equal on every rank and
    to the unsliced run's bit for bit; losses and parameters the same
    spec's without ``zero`` bit for bit; each master slice the unsliced
    run's slice of the master; GPT's slices cut its 256-value blocks
    (the qkv kernel's rows of 96 cut at 48, so a block's values lie on
    both ranks); JAX's losses within 2e-5 and its parameters to the fit
    test's bounds (over fp32 parameters)."""
    from dlrover_tpu_torch.models.convert import params_from_flax
    from test_torch_optim import FIT_PARAM_MAX, FIT_PARAM_MEDIAN

    z_name = masters_name(other, family, opt, True)
    d_name = masters_name(other, family, opt, False)
    ranks = runs[f"w{world}"]
    cuts = 0
    for r, rank in enumerate(ranks):
        z, d = rank[z_name], rank[d_name]
        # Its data peer of rank 0's (or 1's) pipe coordinate: the mesh is
        # (data, pipe), so pipe ranks hold their stages' moments.
        moments = ranks[r % 2 if other == "pipe" else 0][d_name]["moments"]
        assert z["opt"] == "ZeroAdam8Optimizer", z["opt"]
        assert z["losses"] == d["losses"]
        for n in d["params"]:
            assert np.array_equal(z["params"][n], d["params"][n]), n
        for key, (q, scale) in moments.items():
            for a, b in zip(z["moments"][key], (q, scale)):
                assert np.array_equal(a, b), key
            for a, b in zip(d["moments"][key], (q, scale)):
                assert np.array_equal(a, b), key
        assert z["pieces"]
        if other == "fsdp":
            continue  # (slices of the rank's fsdp shard)
        for n, (dim, start, length, shape) in z["pieces"].items():
            whole = d["masters"][n]
            want = whole if dim is None else np.take(
                whole, range(start, start + length), axis=dim)
            assert np.array_equal(z["masters"][n], want), n
            if dim is not None and dim > 0:
                cuts += (start * math.prod(shape[dim + 1:])) % 256 != 0
    if family == "gpt" and other != "fsdp":
        assert cuts
    if not held:
        return
    jax_losses, jax_params = runs["jax"][z_name]
    got = ranks[0][z_name]
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    diffs = np.concatenate([
        np.abs(got["params"][n] - t.float().numpy()).reshape(-1)
        for n, t in params_from_flax(jax_params).items()])
    assert diffs.max() <= FIT_PARAM_MAX, diffs.max()
    assert np.median(diffs) <= FIT_PARAM_MEDIAN, np.median(diffs)


@pytest.mark.parametrize("world", [2, 4])
def test_whole_layers_slice_a_deep_stack(runs, world):
    """Where a stacked leaf's layers dim is its largest that the degree
    divides ([40, 32] norms and row biases), each rank steps whole layers:
    bit for bit as ``data=N`` still."""
    for rank in runs[f"w{world}"]:
        z, d = rank["deep-adamw-True"], rank["deep-adamw-False"]
        assert "blocks/ln1/scale" in z["by_layers"]
        assert "blocks/qkv/kernel" not in z["by_layers"]
        assert z["losses"] == d["losses"]
        for n in d["params"]:
            assert np.array_equal(z["params"][n], d["params"][n]), n


def test_layer_sliced_checkpoint_restores_on_one_device(runs):
    """A rank's whole layers are its blocks of the leaf (the layers'
    region): they restore at degree 2 and on one device."""
    from dlrover_tpu_torch.optim import adamw
    from dlrover_tpu_torch.train.trainer import Trainer
    from test_torch_checkpoint import port_bytes
    from test_torch_parallel import _by_path, assemble

    for rank in runs["w2"]:
        r = rank["save-deep"]
        assert r["step"] == 2 and r["next"][0] == r["next"][1]
        assert _by_path(r["restored"]) == _by_path(r["saved"])
    want = assemble([r["save-deep"]["saved"] for r in runs["w2"]])
    t = Trainer(port_model("deep", seed=5), adamw(LR), token_loss,
                global_batches()[0], spec=ParallelSpec(), device="cpu",
                checkpoint_dir=runs["dirs"]["deep2"], report_metrics=False)
    assert t.restore() == 2
    assert port_bytes(t.state) == want
    t.close()


@pytest.mark.parametrize("world,family,opt",
                         [(n, f, o) for f, o, n in JAX_RUNS],
                         ids=[f"{f}-{o}-data{n}" for f, o, n in JAX_RUNS])
def test_zero_losses_match_jax(runs, world, family, opt):
    got = runs[f"w{world}"][0][f"{family}-{opt}-True"]["losses"]
    np.testing.assert_allclose(got, runs["jax"][family, opt, world],
                               rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_eight_bit_adam_under_zero_stays_replicated(runs, world):
    for rank in runs[f"w{world}"]:
        z, d = rank["gpt-adam8bit-True"], rank["gpt-adam8bit-False"]
        assert z["opt"] == d["opt"] == "MeshOptimizer"
        assert any("no optimizer-state leaf" in line for line in z["log"])
        assert z["losses"] == d["losses"]


# ------------------------------------------------------ checkpoints


def test_zero_checkpoint_restores_at_its_degree(runs):
    """Each rank writes its own slices (the owner, not the lowest
    replica), the metas carry the degree, and a restore at degree 2 gives
    every block back bit for bit and the uninterrupted run's next loss."""
    from dlrover_tpu_torch.common import ckpt_persist
    from dlrover_tpu_torch.common.storage import PosixDiskStorage
    from test_torch_parallel import _by_path

    d = runs["dirs"]["port2"]
    metas = ckpt_persist.load_step_metas(PosixDiskStorage(), d, 2)
    assert sorted(metas) == [0, 1]
    assert all(m.zero_degree == 2 for m in metas.values())
    for gid, meta in metas.items():
        sliced = [t for t in meta.tensors if t.index is not None]
        assert sliced and all(t.path.startswith("['opt']") for t in sliced)
    assert all(not t.path.startswith("['params']")
               for t in metas[1].tensors)
    for rank in runs["w2"]:
        r = rank["save"]
        assert r["step"] == 2
        assert _by_path(r["restored"]) == _by_path(r["saved"])
        assert r["next"][0] == r["next"][1]


def test_zero_checkpoint_reslices_into_degree_four_and_one_device(runs):
    from test_torch_checkpoint import port_bytes
    from test_torch_parallel import assemble, ckpt_trainer as one_trainer

    want = assemble([r["save"]["saved"] for r in runs["w2"]])
    got = assemble([r["port-at-4"]["restored"] for r in runs["r4"]])
    assert all(r["port-at-4"]["step"] == 2 for r in runs["r4"])
    assert got == want
    t = one_trainer("gpt", "adamw", {}, runs["dirs"]["port2"], seed=5)
    assert t.restore() == 2
    assert port_bytes(t.state) == want
    t.close()


@pytest.mark.parametrize("n", [2, 4])
def test_port_zero_checkpoint_restores_in_jax(runs, n):
    from test_torch_parallel import assemble

    want = assemble([r["save"]["saved"] for r in runs["w2"]])
    got = runs["jax"][f"port-in-jax-{n}"]
    assert got["step"] == 2 and got["bytes"] == want


@pytest.mark.parametrize("n", [2, 4])
def test_jax_zero_checkpoint_restores_in_port(runs, n):
    from test_torch_parallel import assemble

    ranks = runs[f"r{n}"]
    assert all(r[f"jax-at-{n}"]["step"] == 2 for r in ranks)
    got = assemble([r[f"jax-at-{n}"]["restored"] for r in ranks])
    assert got == runs["jax"]["jax-save"]["bytes"]


def test_uncovered_slices_fail_naming_both_degrees(runs):
    """Shard 1's slices gone from its meta: at degree 4 the ranks whose
    quarters lay in them (2 and 3) cannot re-slice, and raise
    ``ZeroDegreeMismatchError`` naming the saved and the restoring
    degree (not a corruption: the step is not quarantined); ranks 0 and
    1 find their quarters in shard 0's slices."""
    from dlrover_tpu_torch.common import ckpt_persist
    from dlrover_tpu_torch.common.storage import PosixDiskStorage

    got = [rank["cut-at-4"] for rank in runs["r4"]]
    assert ["error" in r for r in got] == [False, False, True, True]
    for r in got[2:]:
        assert "zero_degree=2" in r["error"] and "zero_degree=4" in r["error"]
    assert all(r["step"] == 2 for r in got[:2])
    assert not ckpt_persist.is_quarantined(PosixDiskStorage(),
                                           runs["dirs"]["cut"], 2)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1] == "--jax":
        import conftest  # noqa: F401  (8 host devices, before JAX starts)

        jax_refs(sys.argv[2])
    else:
        worker(sys.argv[1])
