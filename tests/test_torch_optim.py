"""The port's 8-bit Adam against the JAX package's, on the CPU.

The JAX ``adam8bit`` runs its Pallas kernel in interpret mode here, as
``tests/test_optim.py`` runs it; the port runs its kernels' plain
version (``_adam8_plain``). Inputs are made with numpy from a seed and
handed to both; state crosses with ``models/convert.py``.

Tolerances. The int8 moments agree exactly, or within +-1 on at most
0.1% of their entries: on the CPU, XLA contracts ``b1 m + (1 - b1) g``
into an FMA and turns ``x / 127`` into a multiply by the reciprocal,
while the port rounds each operation as the Pallas body writes it, so a
value within an ulp of a rounding tie may land on the other side. Scales
agree to 1e-6 relative (an ulp or two). Updates and params agree to 1e-6
of their value plus one ulp of their dtype plus 1e-6 of the leaf's
largest magnitude: where ``b1 m`` and ``(1 - b1) g`` cancel, the FMA's
difference is an ulp of those terms, not of their sum.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.accel import ParallelSpec as JaxSpec
from dlrover_tpu.models.gpt import GPT as JaxGPT
from dlrover_tpu.models.gpt import GPTConfig as JaxConfig
from dlrover_tpu.models.gpt import loss_fn as jax_loss
from dlrover_tpu.optim import low_bit as jlb
from dlrover_tpu.train.trainer import Trainer as JaxTrainer
from dlrover_tpu.train.trainer import TrainerCallback as JaxCallback
from dlrover_tpu_torch.accel import auto_accelerate
from dlrover_tpu_torch.models.convert import (
    adam8bit_state_from_flax,
    adam8bit_state_to_flax,
    jax_leaves,
    params_from_flax,
)
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.optim import adam8bit
from dlrover_tpu_torch.optim import low_bit as port
from dlrover_tpu_torch.train.trainer import Trainer, TrainerCallback

Q_FLIP_SHARE = 1e-3
SCALE_REL = 1e-6
REL = 1e-6
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def assert_values_close(got, want, dtype_eps, name=""):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    a = np.abs(want)
    scale = a.max() if a.size else 0.0
    unit = dtype_eps * 2.0 ** np.floor(np.log2(np.maximum(a, 1e-38)))
    limit = REL * a + unit + REL * scale
    bad = np.abs(got - want) > limit
    assert not bad.any(), (name, got[bad][:5], want[bad][:5])


def eps_of(dtype) -> float:
    return 2.0 ** -7 if np.dtype(dtype).name == "bfloat16" else \
        float(np.finfo(np.float32).eps)


def assert_states_close(port_state, jax_state, flip_share=Q_FLIP_SHARE,
                        scale_rel=SCALE_REL):
    got = jax.tree_util.tree_leaves(adam8bit_state_to_flax(port_state))
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_state)]
    assert len(got) == len(want)
    flips = total = 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if b.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max(initial=0) <= 1
            flips += int((diff > 0).sum())
            total += b.size
        elif b.ndim:
            np.testing.assert_allclose(a, b, rtol=scale_rel, atol=0)
        else:
            assert a == b  # the step
    assert flips <= flip_share * total, (flips, total)


# ------------------------------------------------------ layout helpers


@pytest.mark.parametrize("shape", [(300,), (4, 32, 96), (2, 96)],
                         ids=["ragged", "chunked", "straddling"])
def test_layout_helpers_match_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x[..., :7] = 0.0  # and an exact zero or two
    jq = jlb._quantize(jnp.asarray(x), 256)
    pq = port._quantize(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(pq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(jq.scale))
    # The state layout of a leaf: per layer when chunked (init's vmap).
    jleaf = (jax.vmap(lambda a: jlb._quantize(a, 256))(jnp.asarray(x))
             if jlb._chunked(shape) else jq)
    pleaf = port._quantize_leaf(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(pleaf.q.numpy(), np.asarray(jleaf.q))
    np.testing.assert_array_equal(pleaf.scale.numpy(),
                                  np.asarray(jleaf.scale))
    assert port._chunked(shape) == jlb._chunked(shape)
    jb = np.asarray(jlb._blocks_of(jnp.asarray(x), 256))
    pb = port._blocks_of(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(pb.numpy(), jb)
    np.testing.assert_array_equal(
        port._unblocks(pb, shape, 256).numpy(),
        np.asarray(jlb._unblocks(jnp.asarray(jb), shape, 256)))


# ------------------------------------------------------ the leaf table


def table_leaves():
    """(JAX shape, members) of every leaf of the tiny GPT (stacked), a
    stacked bias of 7 layers of 37 values (its blocks straddle layers and
    no 16-value lane divides a layer) and one of 3 x 5 x 13, whose members
    hold distinct values."""
    model = GPT(GPTConfig.tiny(), device="cpu")
    params = dict(model.named_parameters())
    leaves = [(leaf.shape, [params[n].detach() for n in leaf.names])
              for leaf in jax_leaves((n, tuple(p.shape))
                                     for n, p in params.items()).values()]
    rng = np.random.default_rng(11)
    for layers, member in ((7, (37,)), (3, (5, 13))):
        leaves.append(((layers,) + member, [
            torch.from_numpy(rng.standard_normal(member).astype(np.float32))
            for _ in range(layers)]))
    return leaves


def walk(leaves, fault=None):
    """Each leaf's block layout as the kernel's table addresses it
    (``walk_rows`` over ``leaf_rows``), with one planted ``fault``."""
    specs = [(shape, len(ms), ms[0].numel()) for shape, ms in leaves]
    rows = port.leaf_rows(specs)
    if fault == "member_offset":  # members start one value early
        rows = [r._replace(n=r.n - 1) if r.stride % 256 else r
                for r in rows]
    if fault == "layer_offset":  # each layer starts one block late
        rows = [r._replace(stride=r.stride + 256)
                if r.stride % 256 == 0 and r.nmem > 1 else r for r in rows]
    return rows, port.walk_rows(rows, [m for _, ms in leaves for m in ms])


def test_table_walk_is_the_block_layout():
    leaves = table_leaves()
    rows, walked = walk(leaves)
    assert [r.member0 for r in rows] == list(np.cumsum(
        [0] + [len(ms) for _, ms in leaves[:-1]]))
    straddling = 0
    for (shape, members), row, got in zip(leaves, rows, walked):
        want = port._blocks_of(port._leaf(members, shape), 256)
        assert got.shape == want.shape and row.nblocks == want.shape[0]
        assert torch.equal(got, want), shape
        straddling += row.stride % 256 != 0
    assert straddling >= 4  # the tiny GPT's biases and norms, and ours
    assert [r.block0 for r in rows] == list(np.cumsum(
        [0] + [r.nblocks for r in rows[:-1]]))


@pytest.mark.parametrize("fault", ["member_offset", "layer_offset"])
def test_table_walk_fault_fails_the_check(fault):
    """A table that addresses members one value (or one block) off feeds
    the update other gradients; ``adam8_errors`` rejects the result."""
    leaves = table_leaves()
    _, walked = walk(leaves)
    _, faulty = walk(leaves, fault)
    hit = 0
    for (shape, members), good, bad in zip(leaves, walked, faulty):
        if torch.equal(good, bad):
            continue
        hit += 1
        n = good.shape[0]
        rng = np.random.default_rng(0)
        qm = port._quantize(torch.from_numpy(
            rng.standard_normal((n, 256)).astype(np.float32)) * 0.1, 256)
        qv = port._quantize(torch.from_numpy(np.abs(
            rng.standard_normal((n, 256))).astype(np.float32)) * 0.1, 256)
        bc = torch.tensor([1 - 0.9 ** 3, 1 - 0.999 ** 3])
        run = lambda gb: port._adam8_plain(  # noqa: E731
            bc, gb, qm.q, qm.scale, qv.q, qv.scale, lr=1e-2, b1=0.9,
            b2=0.999, eps=1e-8)
        assert port.adam8_failures(port.adam8_errors(run(bad), run(good))), \
            shape
    assert hit


# ------------------------------------------------------ the tiny GPT


def jax_tree(param_dtype, scan=True):
    cfg = dataclasses.replace(JaxConfig.tiny(), param_dtype=param_dtype,
                              scan_layers=scan)
    variables = JaxGPT(cfg).init(jax.random.PRNGKey(0),
                                 jnp.zeros((2, 16), jnp.int32))
    return jax.tree_util.tree_map(np.asarray,
                                  nn.meta.unbox(variables["params"]))


def jax_leaf_table(tree):
    return {"/".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("scan", [True, False], ids=["stacked", "unstacked"])
def test_jax_leaves_follow_the_jax_tree(scan):
    tree = jax_tree(jnp.float32, scan)
    model = GPT(GPTConfig.tiny(), device="cpu")
    named = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    leaves = jax_leaves(named + [("extra.weight", (3, 4, 5))], stacked=scan)
    assert leaves.pop("extra.weight") == (("extra.weight",), (3, 4, 5))
    assert {k: v.shape for k, v in leaves.items()} == jax_leaf_table(tree)
    assert sorted(n for leaf in leaves.values() for n in leaf.names) == \
        sorted(n for n, _ in named)
    if scan:
        assert leaves["blocks/ln1/scale"].names == (
            "blocks.0.ln1.weight", "blocks.1.ln1.weight")


def seeded_grads(tree, rng):
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(p.dtype),
        tree)


def warm_jax_state(opt, tree, rng, steps=2):
    state = opt.init(tree)
    for _ in range(steps):
        _, state = opt.update(seeded_grads(tree, rng), state, tree)
    return jax.tree_util.tree_map(np.asarray, state)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_update_matches_jax(dt):
    # wd 0 here: with it, the update is the difference of u and lr*wd*p,
    # each rounded to the params' dtype on both sides (held exactly by
    # the crafted weight-decay cases below).
    tree = jax_tree(JAX_DT[dt])
    rng = np.random.default_rng(1)
    jopt = jlb.adam8bit(1e-2)
    state = warm_jax_state(jopt, tree, rng)
    grads = seeded_grads(tree, rng)
    ju, js = jopt.update(grads, state, tree)
    pu, ps = adam8bit(1e-2).update(
        params_from_flax(grads), adam8bit_state_from_flax(state),
        params_from_flax(tree))
    assert_states_close(ps, js)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, ju))
    assert set(pu) == set(want)
    for name, u in pu.items():
        assert u.dtype == want[name].dtype
        assert_values_close(u.float(), want[name].float(), eps_of(JAX_DT[dt]),
                            name)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_update_and_apply_matches_jax(dt):
    tree = jax_tree(JAX_DT[dt])
    rng = np.random.default_rng(2)
    jopt = jlb.adam8bit(1e-2, weight_decay=0.1)
    state = warm_jax_state(jopt, tree, rng)
    grads = seeded_grads(tree, rng)
    jp, js = jopt.update_and_apply(grads, state, tree)
    params = params_from_flax(tree)
    opt = adam8bit(1e-2, weight_decay=0.1)(params.items())
    opt.state = adam8bit_state_from_flax(state)
    g = params_from_flax(grads)
    opt.update_and_apply([g[n] for n in params], list(params.values()))
    assert_states_close(opt.state, js)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in params.items():
        assert p.dtype == want[name].dtype
        assert_values_close(p.float(), want[name].float(), eps_of(JAX_DT[dt]),
                            name)


def test_update_and_apply_matches_jax_on_pipelined_leaves():
    """The same on a circular GPT (8 layers, 2 stages x 2 repeats): its
    ``[P, C, Lc, ...]`` bank leaves quantize a stage at a time, the
    stage's layers straddling its blocks; from JAX's initial state."""
    cfg = dataclasses.replace(JaxConfig.tiny(), num_layers=8,
                              pipeline_stages=2, pipeline_microbatches=2,
                              pipeline_repeats=2)
    variables = jax.jit(JaxGPT(cfg).init)(jax.random.PRNGKey(0),
                                          jnp.zeros((2, 16), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray,
                                  nn.meta.unbox(variables["params"]))
    jopt = jlb.adam8bit(1e-2, weight_decay=0.1)
    state = jax.tree_util.tree_map(np.asarray, jopt.init(tree))
    grads = seeded_grads(tree, np.random.default_rng(2))
    jp, js = jopt.update_and_apply(grads, state, tree)
    params = params_from_flax(tree)
    opt = adam8bit(1e-2, weight_decay=0.1)(params.items())
    opt.state = adam8bit_state_from_flax(state)
    g = params_from_flax(grads)
    opt.update_and_apply([g[n] for n in params], list(params.values()))
    assert_states_close(opt.state, js)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in params.items():
        assert_values_close(p, want[name], eps_of(jnp.float32), name)


def test_state_round_trips_bit_exactly():
    tree = jax_tree(jnp.bfloat16)
    state = warm_jax_state(jlb.adam8bit(1e-2), tree, np.random.default_rng(3))
    back = adam8bit_state_to_flax(adam8bit_state_from_flax(state))
    a, b = jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(back)
    assert len(a) == len(b) == 1 + 2 * 2 * 16  # step; m, v x (q, scale)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    # and the JAX package steps from the state that came back
    back = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(state),
                                        b)
    jlb.adam8bit(1e-2).update(seeded_grads(tree, np.random.default_rng(4)),
                              back, tree)


# ------------------------------------------------------ crafted blocks


def crafted(case):
    """(params, grads, adam8bit kwargs) of one crafted case: leaves the
    GPT does not name, so each is its own JAX leaf."""
    rng = np.random.default_rng(5)
    if case == "tie":
        # b1 = 0.5 and a fresh state: m = g / 2 exactly, absmax 127, so
        # m * 127 / absmax lands on ties: 2.5 -> 2, -2.5 -> -2, 0.5 -> 0,
        # 1.5 -> 2, 3.5 -> 4 (half to even).
        g = rng.integers(-40, 40, 256).astype(np.float32) * 2
        g[:6] = [254, 5, -5, 1, 3, 7]
        return {"w": np.ones(256, np.float32)}, {"w": g}, dict(b1=0.5)
    if case == "zero":
        g = rng.standard_normal(600).astype(np.float32)
        g[256:512] = 0.0  # the second block is all zero
        return {"w": np.ones(600, np.float32)}, {"w": g}, {}
    if case == "floor":
        # |g| 1e-3 under an absmax of 1: s * 127 / absmax = 0.127 rounds
        # to 0, so max(q, 0.5) decides the denominator.
        g = np.full(256, 1e-3, np.float32)
        g[0] = 1.0
        return {"w": np.ones(256, np.float32)}, {"w": g}, {}
    shape = (3, 40, 70)  # chunked, ragged per layer, + a flat leaf
    return ({"stack": rng.standard_normal(shape).astype(np.float32),
             "w": rng.standard_normal(333).astype(np.float32)},
            {"stack": rng.standard_normal(shape).astype(np.float32),
             "w": rng.standard_normal(333).astype(np.float32)},
            dict(weight_decay=0.5))


@pytest.mark.parametrize("fused", [False, True], ids=["update", "fused"])
@pytest.mark.parametrize("case", ["tie", "zero", "floor", "weight_decay"])
def test_crafted_blocks_match_jax(case, fused):
    params, grads, kw = crafted(case)
    jopt = jlb.adam8bit(1e-2, **kw)
    js0 = jopt.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    if fused:
        jout, js = jopt.update_and_apply(grads, js0, params)
        opt = adam8bit(1e-2, **kw)(tp.items())
        opt.update_and_apply([tg[k] for k in tp], list(tp.values()))
        pout, ps = tp, opt.state
    else:
        jout, js = jopt.update(grads, js0, params)
        pout, ps = adam8bit(1e-2, **kw).update(
            tg, adam8bit(1e-2, **kw).init(tp), tp)
    got = jax.tree_util.tree_leaves(adam8bit_state_to_flax(ps))
    for a, b in zip(got, jax.tree_util.tree_leaves(js)):
        if a.dtype == np.int8:  # no value here lies an ulp from a tie
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            np.testing.assert_allclose(a, np.asarray(b), rtol=SCALE_REL)
    for k in params:
        assert_values_close(pout[k].numpy(), np.asarray(jout[k]),
                            eps_of(np.float32), k)
    qm = ps.m["w"].q.reshape(-1)
    if case == "tie":
        assert qm[:6].tolist() == [127, 2, -2, 0, 2, 4]
    if case == "zero":
        assert ps.m["w"].scale[1] == 0 and ps.v["w"].scale[1] == 0
        assert not qm[256:512].any()
        if not fused:
            assert not pout["w"][256:512].any()
    if case == "floor":
        assert ps.v["w"].q.reshape(-1)[1:].eq(0).all()


def test_fused_equals_update_plus_apply():
    """update_and_apply == update + apply, exactly (the port's copy of
    tests/test_optim.py::TestFusedApply::test_fused_matches_unfused)."""
    params = {"stack": torch.ones(4, 32, 96) * 0.5,
              "w": torch.ones(64, 160) * 0.1}
    grads = {k: torch.full_like(p, 0.01) for k, p in params.items()}
    tx = adam8bit(1e-2, weight_decay=0.1)
    u, s1 = tx.update(grads, tx.init(params), params)
    live = {k: p.clone() for k, p in params.items()}
    opt = tx(live.items())
    opt.update_and_apply([grads[k] for k in live], list(live.values()))
    for k, p in params.items():
        torch.testing.assert_close(live[k], p + u[k], rtol=1e-6, atol=1e-7)
    for a, b in zip(jax.tree_util.tree_leaves(adam8bit_state_to_flax(s1)),
                    jax.tree_util.tree_leaves(
                        adam8bit_state_to_flax(opt.state))):
        np.testing.assert_array_equal(a, b)


def test_auto_accelerate_binds_by_name():
    model = GPT(GPTConfig.tiny(), device="cpu")
    res = auto_accelerate(model, adam8bit(1e-3), torch.zeros(2, 8).long(),
                          lambda m, p, b: loss_fn(m(b), b), device="cpu")
    opt = res.state["opt"]
    assert set(opt.state.m) == set(jax_leaf_table(jax_tree(jnp.float32)))
    assert opt.state.m["blocks/qkv/kernel"].q.shape == (2, 12, 256)
    assert opt.state.m["blocks/qkv/bias"].q.shape == (1, 256)
    res.train_step(res.state, torch.zeros(2, 8).long())
    assert int(opt.state.step) == 1


# ------------------------------------------------------ Trainer.fit

# 3 steps of lr 1e-2 from the same weights. The losses agree to 1e-5
# (fp32 summation order). The gradients differ in their last bits (XLA
# and PyTorch sum in other orders), and each step's moments, scales and
# int8 rounds are built from them: after three steps the scales agree to
# 1e-3 relative (2.3e-4 measured) and the int8 moments within +-1 on at
# most 1% of entries (0.11% measured). One round that lands the other
# way moves a block's m by 1/127 of its absmax, or, in sqrt(v), can
# change a small entry's step by up to its size, about lr: 2 * lr bounds
# a parameter's difference (6.8e-4 measured), and the median difference
# stays at the gradients' noise, under 2e-6 (2.8e-7 measured).
FIT_LOSS_TOL, FIT_PARAM_MAX, FIT_PARAM_MEDIAN = 1e-5, 2e-2, 2e-6
FIT_FLIP_SHARE, FIT_SCALE_REL = 1e-2, 1e-3
BASE = dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=2,
            d_model=32, attn_impl="pallas")


class Losses(TrainerCallback, JaxCallback):
    def __init__(self):
        self.values = []

    def on_step_end(self, trainer, step, metrics):
        self.values.append(float(metrics["loss"]))


def test_fit_matches_jax_trainer_with_adam8bit():
    rng = np.random.default_rng(7)
    data = [rng.integers(0, 256, (4, 32), dtype=np.int32) for _ in range(3)]
    j_cb, t_cb = Losses(), Losses()
    jt = JaxTrainer(
        JaxGPT(JaxConfig(**BASE, dtype=jnp.float32)), jlb.adam8bit(1e-2),
        lambda m, p, b: jax_loss(m.apply({"params": p}, b), b), data[0],
        spec=JaxSpec(), callbacks=[j_cb],
    )
    model = GPT(GPTConfig(**BASE, dtype=torch.float32), device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.state["params"])))
    tt = Trainer(model, adam8bit(1e-2), lambda m, p, b: loss_fn(m(b), b),
                 data[0], device="cpu", callbacks=[t_cb])
    jt.fit(iter(data), steps=3)
    tt.fit(iter(data), steps=3)
    np.testing.assert_allclose(t_cb.values, j_cb.values, rtol=FIT_LOSS_TOL,
                               atol=FIT_LOSS_TOL)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   jt.state["params"]))
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - want[n].numpy()).reshape(-1)
        for n, p in tt.module.state_dict().items()])
    assert diffs.max() <= FIT_PARAM_MAX
    assert np.median(diffs) <= FIT_PARAM_MEDIAN
    assert_states_close(tt.state["opt"].state,
                        jax.tree_util.tree_map(np.asarray, jt.state["opt"]),
                        FIT_FLIP_SHARE, FIT_SCALE_REL)
