"""The port's sequence and expert parallelism on gloo CPU ranks against
the JAX package's mesh.

Two worlds of processes, started as torchrun starts them (this file is
also the worker: ``python tests/test_torch_seq_expert.py <inputs>``):
a world of 2 runs ring and Ulysses attention at seq 2, trains under
``ParallelSpec(seq=2)`` (ring, and Ulysses), ``(expert=2)`` and
``(data=2)`` with an overflowing batch, and runs the checkpoint cases;
a world of 4 runs ring attention at seq 4 and trains under
``(data=2, expert=2)`` and ``(data=2, seq=2)``. One world serves every
spec of its size. Every model is GPT or LLaMA tiny (fp32) with 4
experts (top 2), from the port's seeded initial weights (carried to
the JAX side by ``models/convert.py``), three steps of the same global
batches on every rank; the JAX side runs ``auto_accelerate(spec=...)``
over the first N of the 8 host devices, in processes beside the worlds.

Tolerances: attention outputs and gradients within 1e-5 of JAX's
``ring_attention`` / ``ulysses_attention`` and of the plain attention
(fp32, summation order only); losses and AdamW's parameters within
2e-5 of JAX's under the same spec and of the port's one-device run
(``tests/test_torch_parallel.py``'s tolerance, the JAX package's own
sharded-vs-baseline one). The 8-bit Adam runs (lr 1e-2) are held to the
port's one-device run at the JAX package's own spread between its
expert=2 and one-device runs (LLaMA-MoE tiny: largest parameter
difference 3.8e-3, median 5.6e-8; 0.06% of int8 moments one level
apart, scales 8.0e-3 apart; ``MESH8_PARAM_MAX`` and
``MESH8_PARAM_MEDIAN`` are about twice those, the moments held with
``tests/test_torch_parallel.py``'s bounds); against JAX's, their losses
within 2e-5 and their parameters within ``test_torch_optim``'s largest
difference (2e-2). Past that the two packages part on one device
already: a gradient's last bit moves an int8 round, a parameter moves
by about lr / 127, and a token whose top-2 choice or drop then flips
changes its experts' gradients wholesale (LLaMA-MoE tiny, port against
JAX on one device after three steps: 14.5% of int8 moments apart, by up
to 24 levels; parameters' median difference 8.6e-6).

The overflowing batches (capacity factor 0.5: every expert drops
tokens) show the global-position hazard: a rank that numbered its
buffer positions from its own tokens, or sized the buffers from them,
would drop other tokens than JAX does.
"""

import dataclasses
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
    MESH_FLIP_SHARE,
    MESH_SCALE_REL,
    World,
    _hold_params,
    assemble,
    blocks_of,
    join_world,
)

ATTN_TOL = 1e-5
LOSS_TOL = 2e-5
STEPS, ROWS, SEQ = 3, 8, 16
FAMILIES = ("gpt", "llama")
EXPERTS = 4
LR = {"adamw": 1e-3, "adam8bit": 1e-2}
JAX_PROCS = 4
MESH8_PARAM_MAX, MESH8_PARAM_MEDIAN = 8e-3, 1.2e-7
# (world, spec, attn_impl) of the grid every family trains under.
GRID = ((2, {"seq": 2}, "ring"), (2, {"seq": 2}, "ulysses"),
        (2, {"expert": 2}, "xla"), (4, {"data": 2, "expert": 2}, "xla"),
        (4, {"data": 2, "seq": 2}, "ring"))
# Further runs: (world, name, family, spec, attn_impl, capacity, opt).
EXTRA = ((2, "overflow-data2", "gpt", {"data": 2}, "xla", 0.5, "adamw"),
         (4, "overflow-data2-seq2", "llama", {"data": 2, "seq": 2}, "ring",
          0.5, "adamw"),
         (2, "adam8bit-expert2", "llama", {"expert": 2}, "xla", 1.25,
          "adam8bit"))
# Attention alone: (world, impl, seq degree).
ATTN = ((2, "ring", 2), (4, "ring", 4), (2, "ulysses", 2))


def spec_id(spec: dict) -> str:
    return "-".join(f"{k}{v}" for k, v in spec.items())


def runs_list():
    """Every training run: (world, name, family, spec, attn, cf, opt)."""
    out = [(w, f"{fam}-{spec_id(s)}-{attn}", fam, s, attn, 1.25, "adamw")
           for w, s, attn in GRID for fam in FAMILIES]
    return out + [(w, f"{fam}-{name}", fam, s, attn, cf, opt)
                  for w, name, fam, s, attn, cf, opt in EXTRA]


def global_batches():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (ROWS, SEQ), dtype=np.int64)
            for _ in range(STEPS)]


def attn_inputs():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((2, SEQ, 4, 8)).astype(np.float32)
            for _ in range(4)]  # q, k, v, dO


# ------------------------------------------------------ the port side


def port_model(family: str, attn: str = "xla", cf: float = 1.25,
               seed: int = 0):
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig

    gen = torch.Generator().manual_seed(seed)
    kw = dict(dtype=torch.float32, attn_impl=attn, num_experts=EXPERTS,
              moe_capacity_factor=cf)
    if family == "gpt":
        return GPT(dataclasses.replace(GPTConfig.tiny(), **kw), device="cpu",
                   generator=gen)
    return Llama(dataclasses.replace(LlamaConfig.tiny(), **kw), device="cpu",
                 generator=gen)


def port_loss(module, params, batch):
    from dlrover_tpu_torch.models.gpt import moe_loss_fn

    return moe_loss_fn(module(batch), batch)


def port_opt(opt: str):
    from dlrover_tpu_torch.optim import adam8bit, adamw

    return adamw(LR[opt]) if opt == "adamw" else adam8bit(LR[opt])


def port_init(family):
    """The port's initial weights (seed 0) as the JAX params tree."""
    from dlrover_tpu_torch.models import convert

    return convert.flax_from_params(port_model(family).state_dict())


def port_train(family, spec, attn, cf, opt):
    """Three steps of the global batches under ``spec`` (one device when
    empty): losses, whole parameters, the 8-bit Adam state (JAX's
    layout) and the local shapes."""
    from dlrover_tpu_torch.accel import ParallelSpec, auto_accelerate
    from dlrover_tpu_torch.accel import sharding
    from dlrover_tpu_torch.models import convert

    batches = global_batches()
    res = auto_accelerate(port_model(family, attn, cf), port_opt(opt),
                          batches[0], port_loss,
                          spec=ParallelSpec(**spec), device="cpu")
    losses = [float(res.train_step(res.state, torch.from_numpy(
        res.local_batch(b)))[1]["loss"]) for b in batches]
    with torch.no_grad():
        full = {n: sharding.gather_full(p, sharding.layout_of(p), p.shape)
                .numpy().copy() for n, p in res.state["params"].items()}
    state = None
    if opt == "adam8bit":
        state = convert.adam8bit_state_to_flax(res.state["opt"].state)
    local = {n: tuple(sharding.local(p).shape)
             for n, p in res.state["params"].items()}
    return {"losses": losses, "params": full, "adam8": state,
            "local": local}


def ckpt_trainer(spec, ckpt_dir, seed=0):
    from dlrover_tpu_torch.accel import ParallelSpec
    from dlrover_tpu_torch.train.trainer import Trainer

    return Trainer(port_model("gpt", seed=seed), port_opt("adamw"),
                   port_loss, global_batches()[0], spec=ParallelSpec(**spec),
                   device="cpu", checkpoint_dir=ckpt_dir, persist_every=2,
                   report_metrics=False)


# ------------------------------------------------------ worker cases


def case_attn(case, inputs):
    """This rank's shard of q, k, v through the sequence-parallel body
    over a seq group of ``case["n"]`` ranks: the output and q/k/v
    gradients of its shard."""
    from dlrover_tpu_torch.accel import create_mesh
    from dlrover_tpu_torch.ops.ring_attention import ring_attention_shard
    from dlrover_tpu_torch.ops.ulysses import ulysses_attention_shard

    n = case["n"]
    mesh = create_mesh([("seq", n), ("data", -1)], torch.device("cpu"))
    r, s = mesh.get_local_rank("seq"), SEQ // n
    q, k, v, do = (torch.from_numpy(a[:, r * s:(r + 1) * s].copy())
                   for a in attn_inputs())
    for t in (q, k, v):
        t.requires_grad_(True)
    body = (ring_attention_shard if case["impl"] == "ring"
            else ulysses_attention_shard)
    out = body(q, k, v, causal=True, group=mesh.get_group("seq"))
    (out * do).sum().backward()
    return {"out": out.detach().numpy(),
            "grads": [t.grad.numpy() for t in (q, k, v)], "rank": r}


def case_bad_heads(case, inputs):
    """Ulysses over 2 ranks with 3 heads: the error it raises."""
    from dlrover_tpu_torch.accel import create_mesh
    from dlrover_tpu_torch.ops.ulysses import ulysses_attention_shard

    mesh = create_mesh([("seq", 2)], torch.device("cpu"))
    q = torch.zeros(1, SEQ // 2, 3, 8)
    try:
        ulysses_attention_shard(q, q, q, group=mesh.get_group("seq"))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def case_train(case, inputs):
    return port_train(case["family"], case["spec"], case["attn"], case["cf"],
                      case["opt"])


def case_save(case, inputs):
    """GPT-MoE under ``spec``: 2 steps, step 2 persisted (then marked
    done); a fresh trainer of another seed restores it."""
    import torch.distributed as dist

    t = ckpt_trainer(case["spec"], case["dir"])
    t.fit(iter(global_batches()[:2]), steps=2, start_step=0)
    saved = blocks_of(t.state)
    dist.barrier()
    if dist.get_rank() == 0:
        open(case["dir"] + ".done", "w").close()
    fresh = ckpt_trainer(case["spec"], case["dir"], seed=5)
    step = fresh.restore()
    out = {"saved": saved, "restored": blocks_of(fresh.state), "step": step}
    t.close()
    fresh.close()
    return out


def wait_done(ckpt_dir: str, timeout: float = 240):
    """Until the checkpoint's writer (another process) marks it done."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(ckpt_dir + ".done"):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint in {ckpt_dir}")
        time.sleep(0.1)


def case_restore(case, inputs):
    """Restore a checkpoint another topology (or package) saved."""
    wait_done(case["dir"])
    t = ckpt_trainer(case["spec"], case["dir"], seed=5)
    step = t.restore()
    out = {"step": step, "restored": blocks_of(t.state)}
    t.close()
    return out


CASES = {"attn": case_attn, "bad_heads": case_bad_heads,
         "train": case_train, "save": case_save, "restore": case_restore}


def worker(path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    join_world()
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    rank = int(os.environ["RANK"])
    out = {case["name"]: CASES[case["kind"]](case, inputs)
           for case in inputs["cases"]}
    with open(f"{path}.rank{rank}", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------ the JAX side


def _jax():
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.accel import ParallelSpec, auto_accelerate
    from dlrover_tpu.models import gpt, llama
    from dlrover_tpu.optim import low_bit

    return dict(nn=nn, jax=jax, jnp=jnp, optax=optax, gpt=gpt, llama=llama,
                low_bit=low_bit, ParallelSpec=ParallelSpec,
                auto_accelerate=auto_accelerate)


def jax_model(family, attn="xla", cf=1.25):
    J = _jax()
    kw = dict(dtype=J["jnp"].float32, attn_impl=attn, num_experts=EXPERTS,
              moe_capacity_factor=cf)
    if family == "gpt":
        return J["gpt"].GPT(dataclasses.replace(J["gpt"].GPTConfig.tiny(),
                                                **kw))
    return J["llama"].Llama(dataclasses.replace(
        J["llama"].LlamaConfig.tiny(), **kw))


def jax_loss(m, p, b):
    return _jax()["gpt"].moe_loss_fn(m.apply({"params": p}, b), b)


def jax_train(family, spec, attn, cf, opt, init):
    """(losses, params, optimizer state) of the JAX package's run from the
    params ``init`` (numpy, in place of its own initial ones)."""
    J = _jax()
    jax = J["jax"]
    tx = (J["optax"].adamw(LR[opt]) if opt == "adamw"
          else J["low_bit"].adam8bit(LR[opt]))
    s = J["ParallelSpec"](**spec)
    batches = [b.astype(np.int32) for b in global_batches()]
    res = J["auto_accelerate"](jax_model(family, attn, cf), tx, batches[0],
                               jax_loss, spec=s,
                               devices=jax.devices()[:s.total])
    state, losses = dict(res.state), []
    state["params"] = jax.tree_util.tree_map(
        lambda cur, new: jax.device_put(new, cur.sharding), state["params"],
        init)
    for b in batches:
        state, m = res.train_step(state, jax.device_put(b, res.batch_sharding))
        losses.append(float(m["loss"]))
    tree = jax.tree_util.tree_map
    return losses, tree(np.asarray, state["params"]), \
        tree(np.asarray, state["opt"])


def jax_attn(impl, n):
    """JAX's ``ring_attention`` / ``ulysses_attention`` over a ``seq`` mesh
    of n host devices: the output and the q/k/v gradients of
    ``sum(out * dO)``."""
    J = _jax()
    jax, jnp = J["jax"], J["jnp"]
    from jax.sharding import Mesh

    from dlrover_tpu.ops.ring_attention import ring_attention
    from dlrover_tpu.ops.ulysses import ulysses_attention

    fn = ring_attention if impl == "ring" else ulysses_attention
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    q, k, v, do = (jnp.asarray(a) for a in attn_inputs())

    def attend(q, k, v):
        return fn(q, k, v, causal=True, mesh=mesh)

    out = jax.jit(attend)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(attend(q, k, v) * do),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def jax_ckpt(spec, ckpt_dir):
    """The JAX package's GPT-MoE step 2 under ``spec``, persisted into
    ``ckpt_dir`` (then marked done): its train state's bytes."""
    from test_torch_checkpoint import jax_bytes

    jt = jax_ckpt_trainer(spec, ckpt_dir)
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
    jt = jax_ckpt_trainer({}, ckpt_dir)
    step = jt.restore()
    out = (step, jax_bytes(jt.state))
    jt.close()
    return out


def jax_refs(path):
    with open(path, "rb") as f:
        todo = pickle.load(f)
    jobs = {"attn": jax_attn, "train": jax_train, "ckpt": jax_ckpt,
            "restore": jax_restore}
    out = {key: jobs[key[0]](*job) for key, job in todo}
    with open(f"{path}.rank0", "wb") as f:
        pickle.dump(out, f)


def jax_ckpt_trainer(spec, ckpt_dir):
    """The JAX package's Trainer of GPT-MoE tiny under ``spec`` (one
    process: its blocks are one shard), persisting every 2 steps."""
    J = _jax()
    from dlrover_tpu.train import trainer

    return trainer.Trainer(
        jax_model("gpt"), J["optax"].adamw(LR["adamw"]), jax_loss,
        global_batches()[0].astype(np.int32), spec=J["ParallelSpec"](**spec),
        checkpoint_dir=ckpt_dir, persist_every=2)


# ------------------------------------------------------ the runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_checkpoint import port_bytes

    root = tmp_path_factory.mktemp("seq-expert")
    job = f"seqexp-{uuid.uuid4().hex[:8]}"
    old_job = os.environ.get("DLROVER_TPU_JOB_NAME")
    os.environ["DLROVER_TPU_JOB_NAME"] = job + "-main"
    try:
        yield _runs(root, job, port_bytes)
    finally:
        if old_job is None:
            os.environ.pop("DLROVER_TPU_JOB_NAME", None)
        else:
            os.environ["DLROVER_TPU_JOB_NAME"] = old_job
        for path in glob.glob(f"/dev/shm/ckpt_{job}*"):
            os.unlink(path)


def _runs(root, job, port_bytes):
    dirs = {k: str(root / k) for k in ("one", "expert", "jax")}
    out = {"dirs": dirs}
    init = {f: port_init(f) for f in FAMILIES}
    # The JAX references first, in JAX_PROCS processes, the longest jobs
    # first to the least loaded (seconds each, alone): the checkpoint a
    # world restores, the 8-bit Adam's interpreted kernel, the training
    # runs, the port's checkpoint restored (it waits for a world), the
    # attention.
    todo = [(10, ("ckpt",), ({"expert": 2}, dirs["jax"]))]
    todo += [(12 if opt == "adam8bit" else 7, ("train", name),
              (fam, spec, attn, cf, opt, init[fam]))
             for _, name, fam, spec, attn, cf, opt in runs_list()]
    todo += [(6, ("restore",), (dirs["expert"],))]
    todo += [(2, ("attn", impl, n), (impl, n)) for _, impl, n in ATTN]
    share = [[0, []] for _ in range(JAX_PROCS)]
    for cost, key, job in todo:
        least = min(share, key=lambda x: x[0])
        least[0] += cost
        least[1].append((key, job))
    worlds = []
    for k, (_, jobs) in enumerate(share):
        path = str(root / f"jax{k}.pkl")
        with open(path, "wb") as f:
            pickle.dump(jobs, f)
        worlds.append(World(1, path, f"{job}-j{k}", jax_refs=True,
                            script=__file__))
    try:
        # Checkpoints the world restores: one device (the port's, here)
        # and expert=2 (the JAX package's, on 2 host devices, made in a
        # process of references).
        t = ckpt_trainer({}, dirs["one"])
        t.fit(iter(global_batches()[:2]), steps=2, start_step=0)
        out["one_ckpt"] = port_bytes(t.state)
        t.close()
        open(dirs["one"] + ".done", "w").close()
        cases = {2: [], 4: []}
        for world, impl, n in ATTN:
            cases[world].append(dict(kind="attn", name=f"attn-{impl}-{n}",
                                     impl=impl, n=n))
        cases[2].append(dict(kind="bad_heads", name="ulysses-3-heads"))
        for world, name, fam, spec, attn, cf, opt in runs_list():
            cases[world].append(dict(kind="train", name=name, family=fam,
                                     spec=spec, attn=attn, cf=cf, opt=opt))
        cases[2] += [
            dict(kind="save", name="save-expert2", spec={"expert": 2},
                 dir=dirs["expert"]),
            dict(kind="restore", name="one-to-expert2", spec={"expert": 2},
                 dir=dirs["one"]),
            dict(kind="restore", name="jax-to-expert2", spec={"expert": 2},
                 dir=dirs["jax"])]
        for n in (2, 4):
            path = str(root / f"w{n}.pkl")
            with open(path, "wb") as f:
                pickle.dump({"cases": cases[n]}, f)
            worlds.append(World(n, path, f"{job}-w{n}", script=__file__))
        out["one"] = {}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # beside the worlds' processes
        try:
            for _, name, fam, spec, attn, cf, opt in runs_list():
                out["one"][name] = port_train(fam, {}, attn, cf, opt)
        finally:
            torch.set_num_threads(threads)
    finally:
        results = [w.join() for w in worlds]
    out["jax"] = {}
    for refs in results[:JAX_PROCS]:
        out["jax"].update(refs[0])
    out["jax_ckpt"] = out["jax"].pop(("ckpt",))
    out["jax_restored"] = out["jax"].pop(("restore",))
    out["w2"], out["w4"] = results[JAX_PROCS:]
    return out


# ------------------------------------------------------ attention


def _plain_attention():
    from dlrover_tpu_torch.ops.attention import reference_attention

    q, k, v, do = (torch.from_numpy(a) for a in attn_inputs())
    for t in (q, k, v):
        t.requires_grad_(True)
    out = reference_attention(q, k, v, causal=True)
    (out * do).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("world,impl,n", ATTN,
                         ids=[f"{i}-seq{n}" for _, i, n in ATTN])
def test_attention_matches_jax_and_plain(runs, world, impl, n):
    """Each rank's shard of the output and of the q/k/v gradients equals
    JAX's (and the plain attention's) at its positions."""
    j_out, j_grads = runs["jax"]["attn", impl, n]
    p_out, p_grads = _plain_attention()
    s = SEQ // n
    ranks = [r[f"attn-{impl}-{n}"] for r in runs[f"w{world}"]]
    assert sorted(r["rank"] for r in ranks) == sorted(
        list(range(n)) * (world // n))
    for r in ranks:
        part = slice(r["rank"] * s, (r["rank"] + 1) * s)
        for want in ((j_out, j_grads), (p_out, p_grads)):
            np.testing.assert_allclose(r["out"], want[0][:, part],
                                       rtol=ATTN_TOL, atol=ATTN_TOL)
            for g, w in zip(r["grads"], want[1]):
                np.testing.assert_allclose(g, w[:, part], rtol=ATTN_TOL,
                                           atol=ATTN_TOL)


def test_ulysses_refuses_heads_the_degree_does_not_divide(runs):
    for rank in runs["w2"]:
        assert "heads 3 not divisible by seq degree 2" in \
            rank["ulysses-3-heads"]["error"]


# ------------------------------------------------------ training


RUNS = runs_list()


@pytest.mark.parametrize("world,name,family,spec,attn,cf,opt", RUNS,
                         ids=[r[1] for r in RUNS])
def test_training_matches_jax_and_one_device(runs, world, name, family, spec,
                                             attn, cf, opt):
    from dlrover_tpu_torch.models.convert import (
        adam8bit_state_from_flax,
        params_from_flax,
    )
    from test_torch_optim import assert_states_close

    got = runs[f"w{world}"][0][name]
    j_losses, j_params, _ = runs["jax"]["train", name]
    one = runs["one"][name]
    for want, label in ((j_losses, "jax"), (one["losses"], "one device")):
        np.testing.assert_allclose(got["losses"], want, rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=f"{name} vs {label}")
    want = {n: t.numpy() for n, t in params_from_flax(j_params).items()}
    if opt == "adamw":
        _hold_params(got["params"], want, opt, f"{name} vs jax")
        _hold_params(got["params"], one["params"], opt,
                     f"{name} vs one device")
    else:
        from test_torch_optim import FIT_PARAM_MAX

        def diffs(ref):
            return np.concatenate([np.abs(got["params"][n] - ref[n])
                                   .reshape(-1) for n in ref])

        assert diffs(want).max() <= FIT_PARAM_MAX, name
        d = diffs(one["params"])
        assert d.max() <= MESH8_PARAM_MAX, (name, d.max())
        assert np.median(d) <= MESH8_PARAM_MEDIAN, (name, np.median(d))
        assert_states_close(adam8bit_state_from_flax(got["adam8"]),
                            one["adam8"], MESH_FLIP_SHARE, MESH_SCALE_REL)
    # Every rank computed the same losses and the same whole parameters.
    for rank in runs[f"w{world}"][1:]:
        assert rank[name]["losses"] == got["losses"]


@pytest.mark.parametrize("family", FAMILIES)
def test_expert_ranks_hold_their_experts(runs, family):
    """Under expert=2 each rank holds 2 of the 4 experts of every stack
    and 2 of the router's 4 columns; the rest is whole."""
    r = runs["w2"][0][f"{family}-expert2-xla"]
    for n, shape in r["local"].items():
        full = r["params"][n].shape
        if ".moe.router" in n:
            assert shape == (full[0], full[1] // 2), n
        elif ".moe." in n:
            assert shape == (full[0] // 2,) + full[1:], n
        else:
            assert shape == full, n


def test_gpt_position_rows_are_sharded_over_seq(runs):
    r = runs["w2"][0]["gpt-seq2-ring"]
    assert r["local"]["wpe"] == (r["params"]["wpe"].shape[0] // 2,
                                 r["params"]["wpe"].shape[1])


# ------------------------------------------------------ checkpoints


def _by_path(blocks):
    return {(b[0], b[1]): b for b in blocks}


def test_expert_checkpoint_restores_at_expert2_and_on_one_device(runs):
    """expert=2 -> expert=2 bit for bit on every rank; -> one device: each
    leaf the one the ranks held together."""
    from test_torch_checkpoint import port_bytes

    for rank in runs["w2"]:
        r = rank["save-expert2"]
        assert r["step"] == 2
        assert _by_path(r["restored"]) == _by_path(r["saved"])
    want = assemble([r["save-expert2"]["saved"] for r in runs["w2"]])
    t = ckpt_trainer({}, runs["dirs"]["expert"], seed=5)
    assert t.restore() == 2
    assert port_bytes(t.state) == want
    t.close()


def test_one_device_checkpoint_restores_at_expert2(runs):
    got = assemble([r["one-to-expert2"]["restored"] for r in runs["w2"]])
    assert all(r["one-to-expert2"]["step"] == 2 for r in runs["w2"])
    assert got == runs["one_ckpt"]


def test_expert_checkpoints_cross_between_the_packages(runs):
    """The JAX package's expert=2 step (2 host devices) restores into the
    port at expert=2; the port's expert=2 step restores into the JAX
    package on one device."""
    got = assemble([r["jax-to-expert2"]["restored"] for r in runs["w2"]])
    assert got == runs["jax_ckpt"]
    want = assemble([r["save-expert2"]["saved"] for r in runs["w2"]])
    assert runs["jax_restored"] == (2, want)


# ------------------------------------------------------ what raises


@pytest.mark.parametrize("spec,match", [
    ({"expert": 2, "fsdp": 2}, "item 6"),
    ({"expert": 2, "tensor": 2}, "item 6"),
    ({"seq": 2, "fsdp": 2}, "item 6"),
    ({"seq": 2, "tensor": 2}, "item 6"),
    ({"seq": 2, "expert": 2}, "item 6"),
    ({"pipe": 2, "expert": 2}, "item 6"),
])
def test_refused_compositions_name_their_slice(spec, match):
    from dlrover_tpu_torch.accel import ParallelSpec, auto_accelerate

    with pytest.raises(NotImplementedError, match=match):
        auto_accelerate(port_model("gpt"), port_opt("adamw"),
                        global_batches()[0], port_loss,
                        spec=ParallelSpec(**spec), device="cpu")


def test_seq_without_ring_or_ulysses_raises():
    from dlrover_tpu_torch.accel import accelerate
    from test_torch_mesh import FakeMesh

    with pytest.raises(NotImplementedError, match="item 6"):
        accelerate.sequence_parallel(port_model("gpt", attn="xla"),
                                     FakeMesh({"seq": 2}, [0]))


@pytest.mark.parametrize("axis", ["fsdp", "tensor"])
def test_moe_model_on_fsdp_or_tensor_raises(axis):
    from dlrover_tpu_torch.accel import accelerate_on_mesh
    from test_torch_mesh import FakeMesh

    with pytest.raises(NotImplementedError, match="item 6"):
        accelerate_on_mesh(port_model("gpt"), port_opt("adamw"),
                           global_batches()[0], port_loss,
                           FakeMesh({axis: 2}, [0]), device="cpu")


def test_expert_degree_without_experts_raises():
    """JAX's ``_check_spec_axes_used``: an expert degree with no expert
    leaf would waste its devices."""
    from dlrover_tpu_torch.accel import accelerate
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from test_torch_mesh import FakeMesh

    with pytest.raises(ValueError, match="expert"):
        accelerate.expert_parallel(GPT(GPTConfig.tiny(), device="cpu"),
                                   FakeMesh({"expert": 2}, [0]))


@pytest.mark.parametrize("family", FAMILIES)
def test_pipeline_stages_raise_naming_their_slice(family):
    """Pipelined models build (tests/test_torch_pipeline.py); on a seq
    axis they still raise, naming the rest of item 6."""
    from dlrover_tpu_torch.accel import accelerate_on_mesh
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
    from test_torch_mesh import FakeMesh

    cls, cfg = ((GPT, GPTConfig.tiny()) if family == "gpt"
                else (Llama, LlamaConfig.tiny()))
    model = cls(dataclasses.replace(cfg, pipeline_stages=2,
                                    attn_impl="ring"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        accelerate_on_mesh(model, port_opt("adamw"), global_batches()[0],
                           port_loss, FakeMesh({"seq": 2}, [0]),
                           device="cpu")


if __name__ == "__main__":
    if sys.argv[1] == "--jax":
        import conftest  # noqa: F401  (8 host devices, before JAX starts)

        jax_refs(sys.argv[2])
    else:
        worker(sys.argv[1])
