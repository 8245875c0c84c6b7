"""Remat (activation checkpointing) of the port's GPT and LLaMA.

Under each policy ("nothing", "dots", "dots_lite") a step's gradients
equal the port's without remat bit for bit, and JAX's under the same
policy within 1e-5 (fp32, weights carried across). What each policy
saves shows in what the backward runs again: "dots" recomputes no matrix
product, "nothing" and "dots_lite" recompute them, "dots_lite" takes
its named tensors from the cache; the flash forward runs a second time
a layer under every policy (a kernel is no aten op, so none saves it).
"offload" raises.
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

POLICIES = ("nothing", "dots", "dots_lite")
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



def port_grads(family, tree, policy=None, attn="pallas", toks=None):
    """{name: grad} of one loss.backward() of the port model with these
    weights, under ``policy`` (None: no remat)."""
    _, _, model_cls, tiny = MODELS[family]
    cfg = dataclasses.replace(tiny(), dtype=torch.float32, attn_impl=attn,
                              remat=policy is not None,
                              remat_policy=policy or "nothing")
    model = model_cls(cfg, device="cpu")
    model.load_state_dict(params_from_flax(tree))
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
                              remat=True, remat_policy=policy)
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


def _backward_ops(family, policy):
    """The aten ops the backward of one step runs, and how many times
    the flash forward (its plain version, on the CPU) ran in the forward
    and in the backward."""
    _, _, model_cls, tiny = MODELS[family]
    cfg = dataclasses.replace(tiny(), dtype=torch.float32,
                              attn_impl="pallas", remat=policy is not None,
                              remat_policy=policy or "nothing")
    model = model_cls(cfg, device="cpu")
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
    mm = torch.ops.aten.mm.default
    named = remat.NAMED[0]
    base, fwd, bwd = _backward_ops(family, None)
    assert (fwd, bwd) == (layers, 0)
    runs = {p: _backward_ops(family, p) for p in POLICIES}
    for policy, (ops, fwd, bwd) in runs.items():
        # The flash forward runs again in the backward under every policy.
        assert (fwd, bwd) == (layers, layers), policy
    # "dots" takes every product from the cache: the backward's matrix
    # products are the gradients' alone, as without remat.
    assert runs["dots"][0][mm] == base[mm]
    # "nothing" and "dots_lite" recompute the forward's products too.
    assert runs["nothing"][0][mm] > base[mm]
    assert runs["dots_lite"][0][mm] == runs["nothing"][0][mm]
    # "dots_lite"'s named tensors come from the cache; no other policy
    # names anything.
    assert all(named not in ops for ops, _, _ in runs.values())


def test_no_grad_runs_blocks_plainly():
    cfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32,
                              remat=True, remat_policy="dots_lite")
    model = GPT(cfg, device="cpu")
    t = torch.from_numpy(tokens()).long()
    counter = _OpCounter()
    with torch.no_grad(), counter:
        model(t)
    assert remat.NAMED[0] not in counter.ops


@pytest.mark.parametrize("family", sorted(MODELS))
def test_offload_raises(family):
    _, _, model_cls, tiny = MODELS[family]
    cfg = dataclasses.replace(tiny(), remat=True, remat_policy="offload")
    with pytest.raises(NotImplementedError, match="offload"):
        model_cls(cfg, device="cpu")


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
