"""The port's LLaMA against the JAX package's, on weights carried across.

JAX params are made from a seed, turned into numpy and converted with
``models/convert.py``; the same numpy inputs go through both models.
RoPE, RMSNorm, one layer and the whole model's logits, loss and every
parameter's gradient are compared, for the einsum attention and the
flash path (Pallas in interpret mode on the JAX side, the kernels' plain
versions on the port's); the params and the 8-bit Adam state carry
across bit for bit; three ``Trainer.fit`` steps give JAX's losses; a
flash checkpoint of either package restores in the other.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.accel import ParallelSpec as JaxSpec
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.optim import low_bit as jlb
from dlrover_tpu.train.trainer import Trainer as JaxTrainer
from dlrover_tpu_torch.models.convert import (
    LLAMA_NAMING,
    adam8bit_state_from_flax,
    adam8bit_state_to_flax,
    flax_from_params,
    jax_leaves,
    naming_of,
    params_from_flax,
)
from dlrover_tpu_torch.models.llama import (
    Llama,
    LlamaBlock,
    LlamaConfig,
    RMSNorm,
    loss_fn,
    rope,
)
from dlrover_tpu_torch.optim import adam8bit, adamw
from dlrover_tpu_torch.train.checkpoint import engine as port_engine
from dlrover_tpu_torch.train.trainer import Trainer
from test_torch_optim import assert_states_close, assert_values_close, eps_of
from test_torch_checkpoint import (  # noqa: F401  (job is a fixture)
    LOSS_TOL,
    Losses,
    _jax,
    jax_bytes,
    jax_losses,
    job,
    port_bytes,
)

# As tests/test_torch_gpt.py: fp32 to summation order; bf16 rounds after
# every product, norm and activation on both sides, in each framework's
# own order.
TOL = {
    "float32": {"logits": 1e-5, "loss": 1e-5, "grads": 1e-5},
    "bfloat16": {"logits": 2e-2, "loss": 5e-3, "grads": 2e-2},
}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(dt="float32", attn="xla", scan=True, param_dt="float32",
            **kw):
    """The JAX and port ``LlamaConfig.tiny()`` (4 heads over 2 kv heads)
    with these types and attention path."""
    base = dict(attn_impl=attn, scan_layers=scan, **kw)
    return (dataclasses.replace(jllama.LlamaConfig.tiny(), **base,
                                dtype=JAX_DT[dt],
                                param_dtype=JAX_DT[param_dt]),
            dataclasses.replace(LlamaConfig.tiny(), **base,
                                dtype=TORCH_DT[dt],
                                param_dtype=TORCH_DT[param_dt]))


def tokens(seed=0, b=2, s=64):
    return np.random.default_rng(seed).integers(0, 256, (b, s),
                                                dtype=np.int32)


def jax_params(cfg, toks=None):
    """The JAX model's params from seed 0; they do not depend on the
    attention path, so init runs the einsum one (Pallas' interpret mode
    is slow)."""
    toks = tokens() if toks is None else toks
    cfg = dataclasses.replace(cfg, attn_impl="xla")
    variables = jllama.Llama(cfg).init(jax.random.PRNGKey(0),
                                       jnp.asarray(toks))
    return jax.tree_util.tree_map(np.asarray,
                                  nn.meta.unbox(variables["params"]))


def port_model(cfg, tree):
    model = Llama(cfg, device="cpu")
    model.load_state_dict(params_from_flax(tree))
    return model


def jax_logits_and_grads(cfg, tree, toks):
    model = jllama.Llama(cfg)

    def loss(p):
        logits = model.apply({"params": p}, jnp.asarray(toks))
        return jllama.loss_fn(logits, jnp.asarray(toks)), logits

    (value, logits), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return logits, value, params_from_flax(
        jax.tree_util.tree_map(np.asarray, grads))


def port_logits_and_grads(model, toks):
    t = torch.from_numpy(toks).long()
    logits = model(t)
    loss = loss_fn(logits, t)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return logits.detach(), loss.detach(), grads


def assert_close(got, want, tol, what):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol, err_msg=what)


# ------------------------------------------------------------- pieces


def test_rope_matches_jax_and_rotates_interleaved_pairs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
    pos = np.arange(16)
    got = rope(torch.from_numpy(x), torch.from_numpy(pos))
    want = jllama.rope(jnp.asarray(x), jnp.asarray(pos))
    assert_close(got, want, 1e-5, "rope")
    # Position 0 is the identity.
    np.testing.assert_array_equal(got[:, 0].numpy(), x[:, 0])
    # Pairs are (x[2i], x[2i+1]): position 1 rotates pair 0 by 1 radian.
    c, s = np.cos(1.0), np.sin(1.0)
    x0, x1 = x[:, 1, :, 0], x[:, 1, :, 1]
    assert_close(got[:, 1, :, 0], x0 * c - x1 * s, 1e-6, "pair 0, x")
    assert_close(got[:, 1, :, 1], x0 * s + x1 * c, 1e-6, "pair 0, y")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rms_norm_matches_flax(dt):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 32)) * 3).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    jnorm = nn.RMSNorm(epsilon=1e-5, dtype=JAX_DT[dt])
    want = jnorm.apply({"params": {"scale": jnp.asarray(scale)}},
                       jnp.asarray(x).astype(JAX_DT[dt]))
    _, cfg = configs(dt)
    norm = RMSNorm(32, cfg, "cpu")
    norm.load_state_dict({"weight": torch.from_numpy(scale)})
    got = norm(torch.from_numpy(x).to(TORCH_DT[dt]))
    assert got.dtype == TORCH_DT[dt]
    assert_close(got.float(), want.astype(jnp.float32),
                 TOL[dt]["logits"], "rmsnorm")


def test_one_block_matches_jax():
    jcfg, tcfg = configs()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    variables = jllama.LlamaBlock(jcfg).init(jax.random.PRNGKey(1),
                                             jnp.asarray(x))
    tree = jax.tree_util.tree_map(np.asarray,
                                  nn.meta.unbox(variables["params"]))
    want, _ = jllama.LlamaBlock(jcfg).apply({"params": tree},
                                            jnp.asarray(x))
    block = LlamaBlock(tcfg, "cpu")
    sd = params_from_flax({"layer_0": tree})
    block.load_state_dict({k[len("layers.0."):]: v for k, v in sd.items()})
    got = block(torch.from_numpy(x))
    assert_close(got.detach(), want, 1e-5, "block")


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn", ["xla", "pallas"])
def test_logits_loss_and_grads_match_jax(dt, attn):
    jcfg, tcfg = configs(dt, attn)
    toks = tokens()
    tree = jax_params(jcfg, toks)
    j_logits, j_loss, j_grads = jax_logits_and_grads(jcfg, tree, toks)
    logits, loss, grads = port_logits_and_grads(port_model(tcfg, tree), toks)
    tol = TOL[dt]
    assert logits.dtype == TORCH_DT[dt]
    assert logits.shape == (2, 64, 256)
    assert_close(logits.float(), j_logits.astype(jnp.float32),
                 tol["logits"], "logits")
    assert_close(float(loss), float(j_loss), tol["loss"], "loss")
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        assert g.dtype == j_grads[name].dtype == tcfg.param_dtype
        assert_close(g.float(), j_grads[name].float(), tol["grads"], name)


def test_bf16_params_match_jax():
    """The preset's param dtype: bf16 weights and norm scales (joining
    the fp32 normalisation), bf16 gradients."""
    jcfg, tcfg = configs("bfloat16", "pallas", param_dt="bfloat16")
    toks = tokens(seed=3)
    tree = jax_params(jcfg, toks)
    j_logits, _, j_grads = jax_logits_and_grads(jcfg, tree, toks)
    logits, _, grads = port_logits_and_grads(port_model(tcfg, tree), toks)
    assert_close(logits.float(), j_logits.astype(jnp.float32), 2e-2,
                 "logits")
    for name, g in grads.items():
        assert g.dtype == torch.bfloat16
        assert_close(g.float(), j_grads[name].float(), 2e-2, name)


def test_gqa_repeats_each_kv_head_in_place():
    """kv head j serves query heads j * r .. j * r + r - 1 (r = heads /
    kv heads), as ``jnp.repeat(axis=2)``: with all of V's weight in kv
    head 0, only the first r query heads see anything."""
    _, tcfg = configs()
    block = LlamaBlock(tcfg, "cpu")
    hd, r = tcfg.head_dim, tcfg.num_heads // tcfg.kv_heads
    with torch.no_grad():
        for m in (block.q_proj, block.k_proj, block.v_proj):
            m.kernel.normal_(0.0, 0.5)
        block.v_proj.kernel[:, hd:] = 0.0
        block.o_proj.kernel.copy_(torch.eye(tcfg.d_model))
        block.gate_proj.kernel.zero_()
    x = torch.randn(1, 8, tcfg.d_model)
    out = (block(x) - x).reshape(1, 8, tcfg.num_heads, hd)
    seen = out.abs().amax(dim=(0, 1, 3))
    assert (seen[:r] > 0).all() and (seen[r:] == 0).all()


def test_preset_is_the_bench_llama():
    cfg = LlamaConfig.preset()
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.kv_heads,
            cfg.head_dim, cfg.vocab_size, cfg.ff_dim) == (22, 2048, 16, 8,
                                                          128, 32000, 5504)
    assert cfg.remat and cfg.remat_policy == "dots"
    assert cfg.param_dtype == torch.bfloat16 and cfg.attn_impl == "pallas"
    assert cfg.param_count() == 22 * 46_403_584 + 2 * 32000 * 2048 + 2048
    jcfg = jllama.LlamaConfig(
        vocab_size=32000, max_seq_len=8192, num_layers=22, num_heads=16,
        num_kv_heads=8, d_model=2048)
    assert LlamaConfig.preset(8192).flops_per_token() == \
        jcfg.flops_per_token()


def test_param_count_matches_the_module():
    _, tcfg = configs()
    model = Llama(tcfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == tcfg.param_count()


def test_init_is_seeded_by_the_generator():
    _, tcfg = configs()
    a, b, c = (Llama(tcfg, device="cpu",
                     generator=torch.Generator().manual_seed(s))
               for s in (3, 3, 4))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    assert not torch.equal(a.embed.weight, c.embed.weight)
    assert all(m.bias is None for m in (a.layers[0].q_proj, a.lm_head))


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

    cfg = dataclasses.replace(LlamaConfig.tiny(), **change)
    with pytest.raises(NotImplementedError, match=match) as e:
        model = Llama(cfg, device="cpu")
        if spec is not None:
            auto_accelerate(model, adamw(1e-3), np.zeros((2, 8), np.int64),
                            None, spec=ParallelSpec(**spec), device="cpu")
    assert "ROADMAP" in str(e.value)


# ------------------------------------------------------ the converter


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_params_round_trip_bit_exactly(scan, dt):
    jcfg, tcfg = configs(dt, scan=scan, param_dt=dt)
    tree = jax_params(jcfg)
    assert ("layers" in tree) == scan and ("layer_1" in tree) != scan
    sd = params_from_flax(tree)
    assert naming_of(sd) is LLAMA_NAMING
    back = flax_from_params(sd, stacked=scan)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert flat_b[path].dtype == leaf.dtype
        assert flat_b[path].tobytes() == leaf.tobytes(), path
    model = port_model(tcfg, tree)
    for name, value in model.state_dict().items():
        assert value.dtype == TORCH_DT[dt]
        assert torch.equal(value, sd[name]), name


def test_jax_leaves_follow_the_llama_tree():
    jcfg, tcfg = configs()
    tree = jax_params(jcfg)
    want = {"/".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    model = Llama(tcfg, device="cpu")
    leaves = jax_leaves((n, tuple(p.shape))
                        for n, p in model.named_parameters())
    assert {k: v.shape for k, v in leaves.items()} == want
    assert leaves["layers/attn_norm/scale"].shape == (2, 32)
    assert leaves["layers/attn_norm/scale"].names == (
        "layers.0.attn_norm.weight", "layers.1.attn_norm.weight")


def test_adam8bit_state_round_trips_and_matches_jax_layout():
    """The JAX 8-bit Adam state of the LLaMA params carries across bit
    for bit both ways; the port's own state has the JAX layout, the
    stacked [L, d] norm scales quantized whole (their blocks run across
    the layers), and one update on each side agrees."""
    jcfg, _ = configs(param_dt="bfloat16")
    tree = jax_params(jcfg)
    rng = np.random.default_rng(5)

    def grads():
        return jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(p.dtype),
            tree)

    jopt = jlb.adam8bit(1e-2)
    state = jopt.init(tree)
    for _ in range(2):
        _, state = jopt.update(grads(), state, tree)
    state = jax.tree_util.tree_map(np.asarray, state)
    port_state = adam8bit_state_from_flax(state)
    back = adam8bit_state_to_flax(port_state)
    a, b = jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(back)
    assert len(a) == len(b) == 1 + 2 * 2 * len(jax.tree_util.tree_leaves(
        tree))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    norm = port_state.m["layers/attn_norm/scale"]
    fresh = adam8bit(1e-2).init(params_from_flax(tree))
    assert set(fresh.m) == set(port_state.m)
    for path, qt in fresh.m.items():
        assert qt.q.shape == port_state.m[path].q.shape, path
        assert qt.scale.shape == port_state.m[path].scale.shape, path
    assert norm.q.numel() == 256  # 2 layers x 32, one block
    g = grads()
    ju, js = jopt.update(g, state, tree)
    pu, ps = adam8bit(1e-2).update(params_from_flax(g), port_state,
                                   params_from_flax(tree))
    assert_states_close(ps, js)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, ju))
    for name, u in pu.items():
        assert_values_close(u.float(), want[name].float(),
                            eps_of(jnp.bfloat16), name)


# ------------------------------------------------------------ training


def test_fit_matches_jax_trainer():
    """Three steps of ``Trainer.fit`` (AdamW, fp32, the flash path) from
    the JAX trainer's initial params give its losses."""
    import optax

    rng = np.random.default_rng(7)
    data = [rng.integers(0, 256, (4, 32), dtype=np.int32) for _ in range(3)]
    jcfg, tcfg = configs(attn="pallas")
    j_cb, t_cb = jax_losses(), Losses()
    jt = JaxTrainer(
        jllama.Llama(jcfg), optax.adamw(1e-3),
        lambda m, p, b: jllama.loss_fn(m.apply({"params": p}, b), b),
        data[0], spec=JaxSpec(), callbacks=[j_cb])
    model = port_model(tcfg, jax.tree_util.tree_map(np.asarray,
                                                    jt.state["params"]))
    tt = Trainer(model, adamw(1e-3), lambda m, p, b: loss_fn(m(b), b),
                 data[0], device="cpu", callbacks=[t_cb])
    jt.fit(iter(data), steps=3)
    tt.fit(iter(data), steps=3)
    assert_close(t_cb.values, j_cb.values, LOSS_TOL, "losses")
    assert t_cb.values[-1] != t_cb.values[0]


# ---------------------------------------------------- flash checkpoint


def _jax_llama_trainer(ckpt_dir, persist_every=100):
    jcfg, _ = configs(param_dt="bfloat16")
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    return JaxTrainer(
        jllama.Llama(jcfg), jlb.adam8bit(1e-2),
        lambda m, p, b: jllama.loss_fn(m.apply({"params": p}, b), b),
        _batches()[0], spec=JaxSpec(), checkpoint_dir=ckpt_dir,
        persist_every=persist_every)


def _port_llama_trainer(ckpt_dir, persist_every=100, seed=0):
    _, tcfg = configs(param_dt="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    model = Llama(tcfg, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    return Trainer(model, adam8bit(1e-2), lambda m, p, b: loss_fn(m(b), b),
                   _batches()[0], device="cpu", checkpoint_dir=ckpt_dir,
                   persist_every=persist_every)


def _batches(n=3, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (4, 32), dtype=np.int32) for _ in range(n)]


def test_leaf_paths_dtypes_shapes_match_jax(job, tmp_path):
    jt, tt = _jax_llama_trainer(""), _port_llama_trainer("")
    arrays, _ = _jax().engine._flatten_state(jt.state)
    want = [(p, str(np.asarray(x).dtype), tuple(np.shape(x)))
            for p, x in arrays]
    leaves, _ = port_engine._flatten_state(tt.state)
    got = [(leaf.path, port_engine.DTYPE_NAMES[leaf.dtype], leaf.shape)
           for leaf in leaves]
    assert got == want


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_flash_checkpoint_restores_across_packages(saver, job, tmp_path):
    """One package persists step 2 of the tiny LLaMA (bf16 params,
    adam8bit); a fresh trainer of the other restores it bit for bit, and
    one more step on each side gives the same loss within LOSS_TOL."""
    data = _batches()
    if saver == "jax":
        src = _jax_llama_trainer(str(tmp_path), persist_every=2)
        dst = _port_llama_trainer(str(tmp_path), seed=1)
        want_of, got_of = jax_bytes, port_bytes
    else:
        src = _port_llama_trainer(str(tmp_path), persist_every=2)
        dst = _jax_llama_trainer(str(tmp_path))
        want_of, got_of = port_bytes, jax_bytes
    src.fit(iter(data[:2]), steps=2)
    want = want_of(src.state)
    assert dst.restore() == 2
    assert got_of(dst.state) == want
    cbs = {"jax": jax_losses(), "port": Losses()}
    jt, tt = (src, dst) if saver == "jax" else (dst, src)
    jt._callbacks, tt._callbacks = [cbs["jax"]], [cbs["port"]]
    jt.fit(iter(data[2:3]), steps=3, start_step=2)
    tt.fit(iter(data[2:3]), steps=3, start_step=2)
    assert_close(cbs["port"].values, cbs["jax"].values, LOSS_TOL, "loss")
    src.close()
    dst.close()
