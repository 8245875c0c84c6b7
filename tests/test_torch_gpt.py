"""The port's GPT against the JAX package's, on weights carried across.

JAX params are made from a seed, turned into numpy and converted with
``models/convert.py``; the same numpy tokens go through both models.
Logits, loss and every parameter's gradient are compared, for the plain
einsum attention and the flash-attention path (Pallas in interpret mode
on the JAX side, the kernels' plain versions on the port's).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models.gpt import GPT as JaxGPT
from dlrover_tpu.models.gpt import GPTConfig as JaxConfig
from dlrover_tpu.models.gpt import loss_fn as jax_loss
from dlrover_tpu_torch.models.convert import flax_from_params, params_from_flax
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn

# fp32: 1e-5 for logits and loss, 1e-4 for gradients (summation order
# only). bf16: both models round to bf16 after every product, norm and
# GELU, but XLA and PyTorch's CPU kernels accumulate and round in their
# own order, so one-ulp differences (2^-8 relative) compound over the
# layers: 2e-2 on logits and gradients, 5e-3 on the loss.
TOL = {
    "float32": {"logits": 1e-5, "loss": 1e-5, "grads": 1e-4},
    "bfloat16": {"logits": 2e-2, "loss": 5e-3, "grads": 2e-2},
}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(dt, attn, scan=True, param_dt="float32"):
    base = dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=2,
                d_model=32, attn_impl=attn, scan_layers=scan)
    return (JaxConfig(**base, dtype=JAX_DT[dt],
                      param_dtype=JAX_DT[param_dt]),
            GPTConfig(**base, dtype=TORCH_DT[dt],
                      param_dtype=TORCH_DT[param_dt]))


def tokens(seed=0, b=2, s=64, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def jax_params(cfg, toks):
    variables = JaxGPT(cfg).init(jax.random.PRNGKey(0), jnp.asarray(toks))
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(
        variables["params"]))


def port_model(cfg, tree):
    model = GPT(cfg, device="cpu")
    model.load_state_dict(params_from_flax(tree))
    return model


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn", ["xla", "pallas"])
def test_logits_loss_and_grads_match_jax(dt, attn):
    check_against_jax(*configs(dt, attn), dt)


@pytest.mark.parametrize("attn", ["xla", "pallas"])
def test_bf16_params_match_jax(attn):
    """The 1.5B preset's param dtype: bf16 weights, LayerNorm scale and
    bias joining the fp32 normalisation (flax promotes them, the port
    calls ``.float()``), bf16 gradients."""
    jcfg, tcfg = configs("bfloat16", attn, param_dt="bfloat16")
    check_against_jax(jcfg, tcfg, "bfloat16")


def check_against_jax(jcfg, tcfg, dt):
    toks = tokens()
    tree = jax_params(jcfg, toks)
    jmodel = JaxGPT(jcfg)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(toks))
        return jax_loss(logits, jnp.asarray(toks)), logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree)
    )

    model = port_model(tcfg, tree)
    t_logits = model(torch.from_numpy(toks).long())
    t_loss = loss_fn(t_logits, torch.from_numpy(toks).long())
    t_loss.backward()

    tol = TOL[dt]
    assert t_logits.dtype == TORCH_DT[dt]
    np.testing.assert_allclose(
        t_logits.detach().float().numpy(),
        np.asarray(j_logits.astype(jnp.float32)),
        rtol=tol["logits"], atol=tol["logits"],
    )
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=tol["loss"], atol=tol["loss"])
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, j_grads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert g.dtype == want[name].dtype == tcfg.param_dtype
        np.testing.assert_allclose(
            g.float().numpy(), want[name].float().numpy(),
            rtol=tol["grads"], atol=tol["grads"], err_msg=name,
        )


@pytest.mark.parametrize("scan", [True, False])
def test_converter_round_trips_bit_exactly(scan):
    jcfg, tcfg = configs("float32", "xla", scan=scan)
    toks = tokens(seed=1)
    tree = jax_params(jcfg, toks)
    sd = params_from_flax(tree)
    back = flax_from_params(sd, stacked=scan)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    model = port_model(tcfg, tree)
    for name, value in model.state_dict().items():
        assert torch.equal(value, sd[name]), name


@pytest.mark.parametrize("scan", [True, False])
def test_converter_round_trips_bf16_bit_exactly(scan):
    jcfg, tcfg = configs("bfloat16", "xla", scan=scan, param_dt="bfloat16")
    tree = jax_params(jcfg, tokens(seed=2))
    sd = params_from_flax(tree)
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    back = flax_from_params(sd, stacked=scan)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        assert flat_b[path].dtype == leaf.dtype
        np.testing.assert_array_equal(flat_b[path].view(np.int16),
                                      leaf.view(np.int16))
    model = port_model(tcfg, tree)
    for name, value in model.state_dict().items():
        assert torch.equal(value.view(torch.int16), sd[name].view(torch.int16))


def test_unstacked_and_stacked_trees_load_alike():
    jcfg, tcfg = configs("float32", "xla")
    tree = jax_params(jcfg, tokens())
    unstacked = flax_from_params(params_from_flax(tree), stacked=False)
    a, b = params_from_flax(tree), params_from_flax(unstacked)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_param_count_matches_the_module():
    _, tcfg = configs("float32", "xla")
    model = GPT(tcfg, device="cpu")
    d, f = tcfg.d_model, tcfg.ff_dim
    # param_count (the JAX package's formula) leaves out the Dense
    # biases and ln_f's bias.
    assert sum(p.numel() for p in model.parameters()) == \
        tcfg.param_count() + tcfg.num_layers * (5 * d + f) + d


def test_init_is_seeded_by_the_generator():
    _, tcfg = configs("float32", "xla")
    a = GPT(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = GPT(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c = GPT(tcfg, device="cpu", generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    assert not torch.equal(a.wte.weight, c.wte.weight)
    assert float(a.wpe.detach().std()) == pytest.approx(0.01, rel=0.1)
    assert float(a.blocks[0].qkv.kernel.detach().std()) == pytest.approx(0.02, rel=0.1)


@pytest.mark.parametrize("change,spec,match", [
    # Experts, ring / Ulysses attention and pipeline stages build
    # (tests/test_torch_moe.py, tests/test_torch_seq_expert.py,
    # tests/test_torch_pipeline.py); the int8 MLP still raises, and so
    # does a pipelined model on a pipe axis with expert, tensor, seq or
    # fsdp.
    (dict(num_experts=4, pipeline_stages=2), dict(pipe=2, expert=2),
     "pipe axis together"),
    (dict(pipeline_stages=2), dict(pipe=2, tensor=2), "pipe axis together"),
    (dict(mlp_precision="int8"), None, "mlp_precision"),
    (dict(attn_impl="ring", pipeline_stages=2), dict(pipe=2, seq=2),
     "pipe axis together"),
    (dict(attn_impl="ulysses", pipeline_stages=2), dict(pipe=2, fsdp=2),
     "pipe axis together"),
])
def test_later_slices_raise(change, spec, match):
    from dlrover_tpu_torch.accel import ParallelSpec, auto_accelerate
    from dlrover_tpu_torch.optim import adamw

    cfg = dataclasses.replace(configs("float32", "xla")[1], **change)
    with pytest.raises(NotImplementedError, match=match) as e:
        model = GPT(cfg, device="cpu")
        if spec is not None:
            auto_accelerate(model, adamw(1e-3), np.zeros((2, 8), np.int64),
                            None, spec=ParallelSpec(**spec), device="cpu")
    assert "ROADMAP" in str(e.value)
