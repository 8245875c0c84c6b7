"""The port's MoE (``dlrover_tpu_torch/ops/moe.py``) against the JAX
package's, in one process on the CPU.

The same numpy inputs and weights (carried across with
``models/convert.py``) go through both: the routing on crafted gates
(ties, an overflowing expert, every token on one expert) must give the
same combine and dispatch tensors, capacity and load-balance loss
exactly; ``MoEMLP`` (gelu and swiglu experts) its outputs, aux loss and
gradients within 1e-5 in fp32 (summation order only) and 2e-2 in bf16
(both round after every product, in their own order); GPT and LLaMA
tiny with 4 experts their logits, aux and gradients within the same.
Params and the 8-bit Adam state convert both ways bit for bit; every
remat policy's gradients equal no remat's bit for bit, and "dots" /
"offload" keep the MoE's products where JAX's policies do; three
``Trainer.fit`` steps with ``moe_loss_fn`` give JAX's losses within
1e-5.
"""

import dataclasses
import functools
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.ops import moe as jmoe
from dlrover_tpu.optim import low_bit as jlb
from dlrover_tpu_torch.models import remat
from dlrover_tpu_torch.models.convert import (
    adam8bit_state_from_flax,
    adam8bit_state_to_flax,
    flax_from_params,
    params_from_flax,
)
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, moe_loss_fn
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
from dlrover_tpu_torch.ops import moe
from dlrover_tpu_torch.optim import adam8bit, adamw
from dlrover_tpu_torch.train.trainer import Trainer, TrainerCallback

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EXPERTS = 4
MODELS = {
    "gpt": (jgpt.GPT, jgpt.GPTConfig.tiny, GPT, GPTConfig.tiny),
    "llama": (jllama.Llama, jllama.LlamaConfig.tiny, Llama,
              LlamaConfig.tiny),
}


def tokens(seed=0, b=2, s=32):
    return np.random.default_rng(seed).integers(0, 256, (b, s),
                                                dtype=np.int32)


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


# ------------------------------------------------------ routing


def crafted_gates():
    """Rows of ties, an overflowing expert and one expert for all."""
    ties = np.array([[0.25, 0.25, 0.25, 0.25], [0.4, 0.4, 0.1, 0.1],
                     [0.1, 0.3, 0.3, 0.3]], np.float32)
    hot = np.tile(np.array([[0.7, 0.2, 0.1, 0.0]], np.float32), (20, 1))
    mixed = np.random.default_rng(3).dirichlet(np.ones(4), 9).astype(
        np.float32)
    return {"ties": np.tile(ties, (4, 1)),
            "overflow": np.concatenate([hot, mixed]),
            "one expert": np.tile(np.array([[1.0, 0.0, 0.0, 0.0]],
                                            np.float32), (24, 1))}


@pytest.mark.parametrize("case", list(crafted_gates()))
@pytest.mark.parametrize("top_k,capacity", [(1, 8), (2, 8), (2, 16)])
def test_dispatch_matches_jax_exactly(case, top_k, capacity):
    gates = crafted_gates()[case]
    jc, jd = jmoe.compute_dispatch(jnp.asarray(gates), top_k, capacity)
    tc, td = moe.compute_dispatch(torch.from_numpy(gates), top_k, capacity)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    top1 = np.eye(4, dtype=np.float32)[gates.argmax(-1)]
    assert float(moe.load_balance_loss(torch.from_numpy(gates),
                                       torch.from_numpy(top1))) == \
        float(jmoe.load_balance_loss(jnp.asarray(gates), jnp.asarray(top1)))


def test_dispatch_drops_past_capacity_and_keeps_token_order():
    """20 tokens want expert 0 first with room for 8: the first 8 keep it
    (positions 0-7 in token order), the rest are dropped there."""
    gates = torch.from_numpy(crafted_gates()["overflow"])
    r = moe.route(gates, top_k=1, capacity=8)
    assert r.keep[0, :8].all() and not r.keep[0, 8:20].any()
    assert r.slot[0, :8].tolist() == list(range(8))


@pytest.mark.parametrize("n,e,k,cf", [(64, 4, 2, 1.25), (8192, 8, 2, 1.25),
                                      (2, 4, 1, 1.0), (100, 3, 2, 0.5)])
def test_capacity_matches_jax(n, e, k, cf):
    assert moe.expert_capacity(n, e, k, cf) == jmoe.expert_capacity(n, e, k,
                                                                      cf)
    assert moe.expert_capacity(n, e, k, cf) % 8 == 0


def test_argmax_ties_go_to_the_lowest_expert():
    r = moe.route(torch.full((3, 4), 0.25), top_k=2, capacity=8)
    assert r.expert[0].tolist() == [0, 0, 0]
    assert r.expert[1].tolist() == [1, 1, 1]


# ------------------------------------------------------ the layer


def layer_pair(mlp_type, dt, cf=1.25, d=32, f=64):
    jlayer = jmoe.MoEMLP(num_experts=EXPERTS, ff_dim=f, top_k=2,
                         capacity_factor=cf, dtype=JAX_DT[dt],
                         param_dtype=jnp.float32, mlp_type=mlp_type)
    x = np.random.default_rng(1).standard_normal((2, 16, d)).astype(
        np.float32)
    params = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(
        jax.jit(jlayer.init)(jax.random.PRNGKey(2), jnp.asarray(x))[
            "params"]))
    cfg = types.SimpleNamespace(num_experts=EXPERTS, d_model=d, ff_dim=f,
                                moe_top_k=2, moe_capacity_factor=cf,
                                dtype=TORCH_DT[dt], param_dtype=torch.float32)
    layer = moe.MoEMLP(cfg, "cpu", mlp_type=mlp_type)
    layer.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in params.items()})
    return jlayer, params, layer, x


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type,cf", [("gelu", 1.25), ("swiglu", 1.25),
                                         ("gelu", 0.5), ("swiglu", 0.5)])
def test_layer_matches_jax(mlp_type, cf, dt):
    jlayer, params, layer, x = layer_pair(mlp_type, dt, cf)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jlayer.apply({"params": p}, xx)
        return jnp.sum(out.astype(jnp.float32) * w) + aux, (out, aux)

    (_, (j_out, j_aux)), (j_gp, j_gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(x, JAX_DT[dt]))
    xt = torch.from_numpy(x).to(TORCH_DT[dt]).requires_grad_(True)
    out, aux = layer(xt)
    (torch.sum(out.float() * torch.from_numpy(w)) + aux).backward()
    tol = TOL[dt]
    assert out.dtype == TORCH_DT[dt] and aux.dtype == torch.float32
    close(out.detach().float(), j_out.astype(jnp.float32), tol, "out")
    close(aux.detach(), j_aux, tol, "aux")
    close(xt.grad.float(), j_gx.astype(jnp.float32), tol, "x grad")
    for name, p in layer.named_parameters():
        close(p.grad, j_gp[name], tol, name)


# ------------------------------------------------------ the models


@functools.lru_cache(maxsize=None)
def jax_tree(family, dt="float32", param_dt="float32", scan=True):
    """The JAX model's params from seed 0, numpy (they depend on neither
    the capacity factor, remat nor the attention path); every reader
    copies them."""
    jm_cls, jcfg = MODELS[family][:2]
    jc = dataclasses.replace(jcfg(), dtype=JAX_DT[dt],
                             param_dtype=JAX_DT[param_dt],
                             num_experts=EXPERTS, scan_layers=scan)
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(
        jax.jit(jm_cls(jc).init)(jax.random.PRNGKey(0),
                                 jnp.asarray(tokens()))["params"]))


def model_pair(family, dt="float32", **kw):
    jm_cls, jcfg, tm_cls, tcfg = MODELS[family]
    change = dict(num_experts=EXPERTS, **kw)
    jc = dataclasses.replace(jcfg(), dtype=JAX_DT[dt], **change)
    tc = dataclasses.replace(tcfg(), dtype=TORCH_DT[dt], **change)
    toks = tokens()
    jmodel = jm_cls(jc)
    tree = jax_tree(family, dt)
    model = tm_cls(tc, device="cpu")
    model.load_state_dict(params_from_flax(tree))
    return jmodel, tree, model, toks


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(MODELS))
def test_model_matches_jax(family, dt):
    jmodel, tree, model, toks = model_pair(family, dt)

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(toks))
        return jgpt.moe_loss_fn(out, jnp.asarray(toks)), out

    (j_loss, (j_logits, j_aux)), j_grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(tree)
    t = torch.from_numpy(toks).long()
    logits, aux = model(t)
    loss = moe_loss_fn((logits, aux), t)
    loss.backward()
    tol = TOL[dt]
    close(logits.detach().float(), j_logits.astype(jnp.float32), tol,
          "logits")
    close(aux.detach(), j_aux, tol, "aux")
    close(loss.detach(), j_loss, tol, "loss")
    want = params_from_flax(jax.tree_util.tree_map(
        lambda g: np.asarray(g, np.float32), j_grads))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        close(p.grad.float(), want[name], tol, name)


@pytest.mark.parametrize("family", list(MODELS))
def test_active_param_count_counts_top_k_experts(family):
    """With experts, ``param_count(active=True)`` counts the top-k
    experts and the router a layer (the JAX GPT's formula; a swiglu
    expert has three matrices and both biases)."""
    model = model_pair(family)[2]
    cfg = model.cfg
    d, f, e, k, layers = (cfg.d_model, cfg.ff_dim, EXPERTS, cfg.moe_top_k,
                          cfg.num_layers)
    mats = 2 if family == "gpt" else 3
    expert = mats * d * f + f + d
    assert cfg.param_count() - cfg.param_count(active=True) == \
        layers * (e - k) * expert
    stacks = sum(p.numel() for n, p in model.named_parameters()
                 if ".moe." in n)
    assert stacks == layers * (e * expert + d * e)


# ------------------------------------------------------ conversion


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("family", list(MODELS))
def test_params_and_adam8bit_state_convert_bit_for_bit(family, scan):
    """The MoE leaves (``moe/{router, w_up, b_up, [w_gate,] w_down,
    b_down}``, stacked ``[L, ...]`` under scanned layers, one
    ``layer_<i>`` each otherwise) carry across and back bit for bit; so
    do a JAX 8-bit Adam state over the stacked leaves and the port's
    state after a step of its own."""
    tm_cls, tcfg = MODELS[family][2:]
    tree = jax_tree(family, "bfloat16", "bfloat16", scan)
    sd = params_from_flax(tree)
    assert any(".moe.w_up" in n for n in sd)
    back = flax_from_params(sd, stacked=scan)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        assert flat[path].dtype == leaf.dtype
        np.testing.assert_array_equal(flat[path].view(np.int16),
                                      leaf.view(np.int16))
    if not scan:
        return
    # A JAX state with nonzero moments: one update from seeded gradients.
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), tree)
    tx = jlb.adam8bit(1e-3)
    _, state = jax.jit(tx.update)(grads, tx.init(tree), tree)
    port = adam8bit_state_from_flax(state)
    for a, b in zip(jax.tree_util.tree_leaves(adam8bit_state_to_flax(port)),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    model = tm_cls(dataclasses.replace(tcfg(), param_dtype=torch.bfloat16,
                                       num_experts=EXPERTS), device="cpu")
    model.load_state_dict(sd)
    opt = adam8bit(1e-3)(model.named_parameters())
    t = torch.from_numpy(tokens()).long()
    moe_loss_fn(model(t), t).backward()
    live = list(model.parameters())
    with torch.no_grad():
        opt.update_and_apply([p.grad for p in live], live)
    again = adam8bit_state_from_flax(adam8bit_state_to_flax(opt.state))
    for path, qt in opt.state.m.items():
        assert torch.equal(again.m[path].q, qt.q), path
        assert torch.equal(again.v[path].scale, opt.state.v[path].scale)


# ------------------------------------------------------ remat


def grads_under(family, policy):
    _, tree, model, toks = model_pair(
        family, "bfloat16", moe_capacity_factor=0.5,
        remat=policy is not None, remat_policy=policy or "nothing")
    t = torch.from_numpy(toks).long()
    moe_loss_fn(model(t), t).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", remat.POLICIES)
@pytest.mark.parametrize("family", list(MODELS))
def test_remat_grads_equal_no_remat(family, policy):
    """bf16, experts overflowing (capacity factor 0.5): the routing, the
    gathers and the aux loss all run again in the recompute."""
    want = grads_under(family, None)
    got = grads_under(family, policy)
    for name, g in want.items():
        assert torch.equal(got[name], g), name


@pytest.mark.parametrize("family,kept", [
    # dots: qkv, two attention bmm, proj | router, dispatch, up, down,
    # combine; LLaMA: q, k, v, two bmm, o | router, dispatch, up, gate,
    # down, combine. offload: the products without batch dims only.
    ("gpt", {"dots": 9, "offload": 5}),
    ("llama", {"dots": 12, "offload": 7}),
])
def test_dots_and_offload_keep_the_moe_products(family, kept, monkeypatch):
    """What each policy keeps a block: JAX's ``checkpoint_dots`` keeps the
    router's logits, the experts' products and the dispatch and combine
    contractions (here gathers); ``offload_dot_with_no_batch_dims``
    those without batch dims (the experts' are batched over E)."""
    counts = []
    put = remat._Keep.put

    def counted(self, out):
        counts[-1] += 1
        return put(self, out)

    monkeypatch.setattr(remat._Keep, "put", counted)
    start = remat._Keep.begin

    def begin(self):
        if self.passes == 0:
            counts.append(0)
        start(self)

    monkeypatch.setattr(remat._Keep, "begin", begin)
    for policy, n in kept.items():
        counts.clear()
        _, _, model, toks = model_pair(family, remat=True,
                                       remat_policy=policy, attn_impl="xla")
        model(torch.from_numpy(toks).long())
        assert counts == [n] * model.cfg.num_layers, policy


# ------------------------------------------------------ the trainer


class Losses(TrainerCallback):
    def __init__(self):
        self.values = []

    def on_step_end(self, trainer, step, metrics):
        self.values.append(float(metrics["loss"]))


@pytest.mark.parametrize("family", list(MODELS))
def test_trainer_fit_matches_jax_losses(family):
    """Three ``Trainer.fit`` steps (AdamW) with ``moe_loss_fn``: JAX's
    losses within 1e-5; the first is the logits' loss plus 1e-2 times
    the aux loss, as in JAX."""
    jmodel, tree, model, _ = model_pair(family)
    batches = [tokens(seed=s, b=4) for s in (7, 8, 9)]
    t0 = torch.from_numpy(batches[0]).long()
    with torch.no_grad():
        logits, aux = model(t0)
        from dlrover_tpu_torch.models.gpt import loss_fn

        first = float(loss_fn(logits, t0) + 1e-2 * aux)
    rec = Losses()
    trainer = Trainer(model, adamw(1e-3),
                      lambda m, p, b: moe_loss_fn(m(b), b), batches[0],
                      device="cpu", callbacks=[rec], report_metrics=False)
    trainer.fit(iter(batches), steps=3, pipeline=False)
    tx = optax.adamw(1e-3)

    @jax.jit
    def step(params, opt_state, b):
        lv, g = jax.value_and_grad(lambda p: jgpt.moe_loss_fn(
            jmodel.apply({"params": p}, b), b))(params)
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, lv

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state, want = tx.init(params), []
    for b in batches:
        params, opt_state, lv = step(params, opt_state, jnp.asarray(b))
        want.append(float(lv))
    np.testing.assert_allclose(rec.values, want, rtol=1e-5, atol=1e-5)
    assert rec.values[0] == pytest.approx(first, abs=1e-6)
