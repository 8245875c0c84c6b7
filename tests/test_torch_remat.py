"""Remat (activation checkpointing) of the port's GPT and LLaMA.

Under each policy ("nothing", "dots", "dots_lite", "offload") a step's
gradients equal the port's without remat bit for bit, and JAX's under
the same policy within 1e-5 (fp32, weights carried across; "offload" is
held to JAX's "dots", which keeps the same values on the device: JAX's
"offload" does not run on the CPU). What each policy keeps shows in
what the backward runs again: "dots" and "offload" recompute no Dense
product, "offload" recomputes the einsum path's batched products and
"dots" does not, "nothing" and "dots_lite" recompute them all, and
"dots_lite" keeps its named tensors without a copy; the flash forward
runs a second time a layer under every policy (a kernel is no aten op,
so none keeps it). No dispatch mode runs inside a block under any
policy, and "offload" moves every Dense product to the host and back
once, into a pool that does not grow after the first step.
"""

import dataclasses
import functools
from collections import Counter

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch.models import remat
from dlrover_tpu_torch.models.convert import params_from_flax
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, _check_supported
from dlrover_tpu_torch.models.gpt import loss_fn
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
from dlrover_tpu_torch.ops import attention

POLICIES = ("nothing", "dots", "dots_lite", "offload")
# JAX's "offload" keeps on the host what its "dots" keeps on the device.
JAX_POLICY = {"offload": "dots"}
MODELS = {
    "gpt": (jgpt.GPT, jgpt.GPTConfig.tiny, GPT, GPTConfig.tiny),
    "llama": (jllama.Llama, jllama.LlamaConfig.tiny, Llama,
              LlamaConfig.tiny),
}
# fp32 gradients against JAX's: summation order only.
JAX_TOL = 1e-5


def tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (2, 64),
                                                dtype=np.int32)


@functools.lru_cache(maxsize=None)
def jax_tree(family):
    """The JAX model's params from seed 0, numpy (init on the einsum
    path: the params do not depend on the attention path); every reader
    copies them."""
    jmodel, jtiny, _, _ = MODELS[family]
    cfg = dataclasses.replace(jtiny(), dtype=jnp.float32)
    variables = jmodel(cfg).init(jax.random.PRNGKey(0),
                                 jnp.asarray(tokens()))
    return jax.tree_util.tree_map(np.asarray,
                                  nn.meta.unbox(variables["params"]))



def port_model(family, policy=None, attn="pallas", tree=None):
    """The port model under ``policy`` (None: no remat), with ``tree``'s
    weights when given."""
    _, _, model_cls, tiny = MODELS[family]
    cfg = dataclasses.replace(tiny(), dtype=torch.float32, attn_impl=attn,
                              remat=policy is not None,
                              remat_policy=policy or "nothing")
    model = model_cls(cfg, device="cpu")
    if tree is not None:
        model.load_state_dict(params_from_flax(tree))
    return model


def port_grads(family, tree, policy=None, attn="pallas", toks=None):
    """{name: grad} of one loss.backward() of the port model with these
    weights, under ``policy`` (None: no remat)."""
    model = port_model(family, policy, attn, tree)
    t = torch.from_numpy(tokens() if toks is None else toks).long()
    loss_fn(model(t), t).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", sorted(MODELS))
def test_remat_grads_equal_no_remat(family, policy, attn):
    tree = jax_tree(family)
    want = port_grads(family, tree, None, attn)
    got = port_grads(family, tree, policy, attn)
    for name, g in got.items():
        assert torch.equal(g, want[name]), name


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", sorted(MODELS))
def test_remat_grads_match_jax_remat(family, policy):
    """Both packages on the einsum path, where "dots" also saves the
    attention's products; the flash path under remat is held bit for bit
    to no remat above, and no remat to JAX in test_torch_gpt.py /
    test_torch_llama.py."""
    jmodel, jtiny, _, _ = MODELS[family]
    cfg = dataclasses.replace(jtiny(), dtype=jnp.float32, attn_impl="xla",
                              remat=True,
                              remat_policy=JAX_POLICY.get(policy, policy))
    tree = jax_tree(family)
    toks = jnp.asarray(tokens())
    loss_of = jgpt.loss_fn if family == "gpt" else jllama.loss_fn

    def loss(p):
        return loss_of(jmodel(cfg).apply({"params": p}, toks), toks)

    j_grads = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray,
                                                          tree))))
    got = port_grads(family, tree, policy, attn="xla")
    assert set(got) == set(j_grads)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), j_grads[name].numpy(),
                                   rtol=JAX_TOL, atol=JAX_TOL, err_msg=name)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(family, policy, attn="pallas"):
    """The aten ops the backward of one step runs, and how many times
    the flash forward (its plain version, on the CPU) ran in the forward
    and in the backward."""
    model = port_model(family, policy, attn)
    t = torch.from_numpy(tokens()).long()
    calls = []
    plain = attention._fwd_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    attention._fwd_plain = counted
    try:
        loss = loss_fn(model(t), t)
        forward_calls = len(calls)
        counter = _OpCounter()
        with counter:
            loss.backward()
    finally:
        attention._fwd_plain = plain
    return counter.ops, forward_calls, len(calls) - forward_calls


@pytest.mark.parametrize("family", sorted(MODELS))
def test_policies_save_what_they_name(family):
    layers = 2
    mm, clone = torch.ops.aten.mm.default, torch.ops.aten.clone.default
    base, fwd, bwd = _backward_ops(family, None)
    assert (fwd, bwd) == (layers, 0)
    runs = {p: _backward_ops(family, p) for p in POLICIES}
    for policy, (ops, fwd, bwd) in runs.items():
        # The flash forward runs again in the backward under every policy.
        assert (fwd, bwd) == (layers, layers), policy
    # "dots" and "offload" take every product from what they kept: the
    # backward's matrix products are the gradients' alone, as without
    # remat.
    assert runs["dots"][0][mm] == base[mm]
    assert runs["offload"][0][mm] == base[mm]
    # "nothing" and "dots_lite" recompute the forward's products too.
    assert runs["nothing"][0][mm] > base[mm]
    assert runs["dots_lite"][0][mm] == runs["nothing"][0][mm]
    # "dots_lite" keeps its named tensors without a copy.
    assert runs["dots_lite"][0][clone] == runs["nothing"][0][clone]


@pytest.mark.parametrize("family", sorted(MODELS))
def test_offload_recomputes_batched_products(family):
    """On the einsum path "offload" keeps what JAX's
    ``offload_dot_with_no_batch_dims`` keeps: the Dense products (no
    batch dims), not the attention's batched ones, which "dots" keeps
    too; and it moves every Dense product to the host and back once."""
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    base = _backward_ops(family, None, "xla")[0]
    nothing = _backward_ops(family, "nothing", "xla")[0]
    dots = _backward_ops(family, "dots", "xla")[0]
    offload = _backward_ops(family, "offload", "xla")[0]
    assert nothing[bmm] > base[bmm]
    assert (dots[mm], dots[bmm]) == (base[mm], base[bmm])
    assert (offload[mm], offload[bmm]) == (base[mm], nothing[bmm])

    model = port_model(family, "offload", "xla")
    t = torch.from_numpy(tokens()).long()
    loss_fn(model(t), t).backward()
    dense = [m for m in model.modules() if type(m).__name__ == "Dense"
             and m is not getattr(model, "lm_head", None)]
    want = t.numel() * sum(m.kernel.shape[1] for m in dense) * 4  # fp32
    moved = model.remat.pool.take_copy_stats()
    assert (moved["out_bytes"], moved["in_bytes"]) == (want, want)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", sorted(MODELS))
def test_no_dispatch_mode_in_blocks(family, policy, monkeypatch):
    """Neither a block's forward nor its recompute runs under a dispatch
    mode (a selective-checkpoint context pushes one)."""
    model = port_model(family, policy)
    blocks = model.blocks if family == "gpt" else model.layers
    block_cls = type(blocks[0])
    seen = []
    forward = block_cls.forward

    def watched(self, x):
        seen.append(torch._C._len_torch_dispatch_stack())
        return forward(self, x)

    monkeypatch.setattr(block_cls, "forward", watched)
    t = torch.from_numpy(tokens()).long()
    loss_fn(model(t), t).backward()
    assert seen == [0] * (2 * len(blocks))
    assert not hasattr(remat, "create_selective_checkpoint_contexts")


@pytest.mark.parametrize("policy", POLICIES)
def test_no_grad_runs_blocks_plainly(policy):
    """Without gradients a remat model runs the ops a model without
    remat runs, and keeps nothing."""
    t = torch.from_numpy(tokens()).long()
    counts = []
    for p in (None, policy):
        counter = _OpCounter()
        model = port_model("gpt", p, "xla")
        with torch.no_grad(), counter:
            model(t)
        counts.append(counter.ops)
    assert counts[0] == counts[1]
    if policy == "offload":
        moved = model.remat.pool.take_copy_stats()
        assert moved["out_bytes"] == moved["in_bytes"] == 0


@pytest.mark.parametrize("family", sorted(MODELS))
def test_offload_calls_keep_apart(family):
    """Two forwards before one backward (two microbatches' graphs alive
    at once): each call keeps its own products, the second forward takes
    a slab of its own, and the gradients equal no remat's bit for bit."""
    tree = jax_tree(family)
    toks = [torch.from_numpy(tokens(seed)).long() for seed in (1, 2)]
    grads = []
    for policy in (None, "offload"):
        model = port_model(family, policy, "xla", tree)
        sum(loss_fn(model(t), t) for t in toks).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[1].items():
        assert torch.equal(g, grads[0][name]), name
    moved = model.remat.pool.take_copy_stats()
    assert moved["out_bytes"] == moved["in_bytes"] > 0


def test_offload_pool_is_reused():
    """The host slabs are made at the first step and reused: the pool
    does not grow after it."""
    model = port_model("gpt", "offload")
    t = torch.from_numpy(tokens()).long()
    sizes = []
    for _ in range(3):
        loss_fn(model(t), t).backward()
        sizes.append(model.remat.pool.nbytes)
    assert sizes[0] > 0 and sizes == [sizes[0]] * 3


def test_unknown_policy_raises():
    cfg = dataclasses.replace(GPTConfig.tiny(), remat=True,
                              remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        GPT(cfg, device="cpu")


def test_gpt2_xl_builds_with_remat():
    cfg = GPTConfig.gpt2_xl()
    assert cfg.remat and cfg.head_dim == 64
    _check_supported(dataclasses.replace(cfg, remat_policy="dots"))
    _check_supported(cfg)
