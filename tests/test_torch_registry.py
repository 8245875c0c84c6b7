"""The port's sharding registry and tensor-parallel planner against
``dlrover_tpu/accel/registry.py`` and ``dlrover_tpu/accel/tp_planner.py``.

Four plain models, each defined here twice: in flax as
``tests/test_tp_planner.py`` defines them (``PlainLM``: MHA q/k/v
squares, GELU MLP; ``GQALM``: GQA k/v contractions, SwiGLU MLP;
``SwiGLULM``: MHA with a SwiGLU MLP; ``TwoHeads``: an LM head beside a
d -> 1 value head) and as torch twins of ``nn.Embedding`` /
``nn.Linear`` / ``nn.LayerNorm`` at the same paths, whose blocks take
their head count from the local width (``view(b, s, -1, head_dim)``).
``models/convert.plain_from_flax`` carries the flax init into a twin bit
for bit and back, and the twin's logits are the flax model's within
1e-5. For every parameter the port's ``axes_for`` (torch dim order)
equals JAX's ``ShardingRegistry.axes_for`` on the flax leaf, mapped to
torch's order: the defaults, registered rules, their left padding and
the rank-mismatch error. ``plan_tp``'s roles and rules equal JAX's
``plan_tp``'s, parameter by parameter, for the four models.

A fifth, ``ConvLM``, holds a causal ``Conv1d`` (flax's ``nn.Conv``)
and a bare parameter (flax's ``self.param``), which its registry puts
on the tensor axis (their ``mlp`` channels): the converter carries
both, and its twin's logits are flax's within 1e-5.

The models train on gloo ranks in ``tests/test_torch_parallel.py``'s
worlds (``allow_tensor=True`` and ``registry=`` under ``tensor=2`` and
``fsdp=2 x tensor=2``) and ``tests/test_torch_search.py``'s (``"auto"``
over 4 ranks); this file holds only what they import, which is torch's:
the flax side is built inside functions.
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

VOCAB, D, LAYERS, HEADS, KV_HEADS = 128, 32, 2, 4, 2
HEAD_DIM = D // HEADS
MODELS = ("mha", "gqa", "swiglu", "two_heads")
# An MHA LM whose vocab no tensor degree above 1 divides (the twins of
# tests/test_torch_parallel.py's uneven vocab-parallel case).
ODD_VOCAB = VOCAB + 1
TOL = 1e-5  # the twin's logits against flax's, fp32
CONV_K = 3  # ConvLM's causal kernel


# ------------------------------------------------------ torch twins


def _attention(q, k, v):
    """Causal attention over this rank's heads: [B, S, H, hd] each (k, v
    with H / rep heads), -1e9 masked, as the flax blocks compute it."""
    rep = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    s = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(HEAD_DIM)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(logits.masked_fill(~mask, -1e9), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Block(nn.Module):
    """The flax blocks' twin: q/k/v (GQA: k/v of ``KV_HEADS``), o_proj,
    and a GELU (up, down) or SwiGLU (gate, up, down) MLP; LayerNorm's
    epsilon is flax's 1e-6."""

    def __init__(self, kv_heads=HEADS, swiglu=False):
        super().__init__()
        self.ln1 = nn.LayerNorm(D, eps=1e-6)
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, kv_heads * HEAD_DIM)
        self.v_proj = nn.Linear(D, kv_heads * HEAD_DIM)
        self.o_proj = nn.Linear(D, D)
        self.ln2 = nn.LayerNorm(D, eps=1e-6)
        self.swiglu = swiglu
        if swiglu:
            self.gate = nn.Linear(D, 4 * D)
        self.up = nn.Linear(D, 4 * D)
        self.down = nn.Linear(4 * D, D)

    def forward(self, x):
        b, s, _ = x.shape
        y = self.ln1(x)
        q = self.q_proj(y).view(b, s, -1, HEAD_DIM)
        k = self.k_proj(y).view(b, s, -1, HEAD_DIM)
        v = self.v_proj(y).view(b, s, -1, HEAD_DIM)
        x = x + self.o_proj(_attention(q, k, v).reshape(b, s, -1))
        y = self.ln2(x)
        if self.swiglu:
            y = F.silu(self.gate(y)) * self.up(y)
        else:
            y = F.gelu(self.up(y), approximate="tanh")
        return x + self.down(y)


class LM(nn.Module):
    """``wte``, ``block_<i>``, ``lm_head``: the flax LMs' twin."""

    def __init__(self, kv_heads=HEADS, swiglu=False, vocab=VOCAB):
        super().__init__()
        self.wte = nn.Embedding(vocab, D)
        for i in range(LAYERS):
            self.add_module(f"block_{i}", Block(kv_heads, swiglu))
        self.lm_head = nn.Linear(D, vocab)

    def forward(self, tokens):
        x = self.wte(tokens)
        for i in range(LAYERS):
            x = getattr(self, f"block_{i}")(x)
        return self.lm_head(x)


class ConvBlock(nn.Module):
    """A causal conv over the sequence (kernel ``CONV_K``, left-padded)
    and a bare per-channel ``gain``: ``x + gelu(conv(ln(x))) * gain``."""

    def __init__(self):
        super().__init__()
        self.ln = nn.LayerNorm(D, eps=1e-6)
        self.conv = nn.Conv1d(D, D, CONV_K)
        self.gain = nn.Parameter(torch.ones(D))

    def forward(self, x):
        y = F.pad(self.ln(x).transpose(1, 2), (CONV_K - 1, 0))
        y = self.conv(y).transpose(1, 2)
        return x + F.gelu(y, approximate="tanh") * self.gain


class ConvLM(nn.Module):
    def __init__(self):
        super().__init__()
        self.wte = nn.Embedding(VOCAB, D)
        self.block_0 = ConvBlock()
        self.lm_head = nn.Linear(D, VOCAB)

    def forward(self, tokens):
        return self.lm_head(self.block_0(self.wte(tokens)))


class TwoHeads(nn.Module):
    def __init__(self):
        super().__init__()
        self.wte = nn.Embedding(VOCAB, D)
        self.lm_head = nn.Linear(D, VOCAB)
        self.value_head = nn.Linear(D, 1)

    def forward(self, tokens):
        x = self.wte(tokens)
        return self.lm_head(x), self.value_head(x)


def torch_model(name: str) -> nn.Module:
    return {"mha": lambda: LM(), "gqa": lambda: LM(KV_HEADS, swiglu=True),
            "swiglu": lambda: LM(swiglu=True),
            "two_heads": TwoHeads,
            "odd_vocab": lambda: LM(vocab=ODD_VOCAB),
            "conv": ConvLM}[name]()


def token_loss(module, params, batch):
    """Next-token cross entropy of the whole logits, in fp32 (the JAX
    test's loss)."""
    logits = module(batch)[:, :-1].float()
    targets = batch[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(lse - tgt)


def port_registry(model: str = "mha"):
    """A registry of one registered Megatron pair (each block's GELU
    MLP: ``up`` column-, ``down`` row-parallel) in torch's order; the
    rest falls to the defaults. ``ConvLM``'s puts its conv's out
    channels, its bias and its ``gain`` on ``mlp`` (the tensor axis)."""
    from dlrover_tpu_torch.accel.registry import ShardingRegistry

    if model == "conv":
        return (ShardingRegistry()
                .register(r"conv\.weight$", ("mlp", None, None))
                .register(r"conv\.bias$", ("mlp",))
                .register(r"gain$", ("mlp",)))
    return (ShardingRegistry()
            .register(r"block_\d+\.up\.weight$", ("mlp", "embed"))
            .register(r"block_\d+\.up\.bias$", ("mlp",))
            .register(r"block_\d+\.down\.weight$", ("embed", "mlp")))


# ------------------------------------------------------ the flax side


def flax_models():
    """The flax models of ``tests/test_tp_planner.py`` (and a SwiGLU MLP
    beside MHA), by name."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    def attention(q, k, v, s):
        rep = q.shape[2] // k.shape[2]
        k = jnp.repeat(k, rep, axis=2)
        v = jnp.repeat(v, rep, axis=2)
        logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(HEAD_DIM)
        mask = jnp.tril(jnp.ones((s, s), bool))
        probs = jax.nn.softmax(jnp.where(mask, logits, -1e9), axis=-1)
        return jnp.einsum("bhqk,bkhd->bqhd", probs, v)

    class FBlock(fnn.Module):
        kv_heads: int = HEADS
        swiglu: bool = False

        @fnn.compact
        def __call__(self, x):
            b, s, d = x.shape
            y = fnn.LayerNorm(name="ln1")(x)
            q = fnn.Dense(D, name="q_proj")(y)
            k = fnn.Dense(self.kv_heads * HEAD_DIM, name="k_proj")(y)
            v = fnn.Dense(self.kv_heads * HEAD_DIM, name="v_proj")(y)
            attn = attention(q.reshape(b, s, HEADS, HEAD_DIM),
                             k.reshape(b, s, self.kv_heads, HEAD_DIM),
                             v.reshape(b, s, self.kv_heads, HEAD_DIM), s)
            x = x + fnn.Dense(D, name="o_proj")(attn.reshape(b, s, d))
            y = fnn.LayerNorm(name="ln2")(x)
            if self.swiglu:
                gate = fnn.Dense(4 * D, name="gate")(y)
                y = fnn.silu(gate) * fnn.Dense(4 * D, name="up")(y)
            else:
                y = fnn.gelu(fnn.Dense(4 * D, name="up")(y))
            return x + fnn.Dense(D, name="down")(y)

    class FLM(fnn.Module):
        kv_heads: int = HEADS
        swiglu: bool = False
        vocab: int = VOCAB

        @fnn.compact
        def __call__(self, tokens):
            x = fnn.Embed(self.vocab, D, name="wte")(tokens)
            for i in range(LAYERS):
                x = FBlock(self.kv_heads, self.swiglu, name=f"block_{i}")(x)
            return fnn.Dense(self.vocab, name="lm_head")(x)

    class FConvLM(fnn.Module):
        @fnn.compact
        def __call__(self, tokens):
            x = fnn.Embed(VOCAB, D, name="wte")(tokens)

            class FConvBlock(fnn.Module):
                @fnn.compact
                def __call__(self, x):
                    y = fnn.LayerNorm(name="ln")(x)
                    y = fnn.Conv(D, (CONV_K,), padding=[(CONV_K - 1, 0)],
                                 name="conv")(y)
                    gain = self.param("gain", fnn.initializers.ones, (D,))
                    return x + fnn.gelu(y) * gain

            x = FConvBlock(name="block_0")(x)
            return fnn.Dense(VOCAB, name="lm_head")(x)

    class FTwoHeads(fnn.Module):
        @fnn.compact
        def __call__(self, tokens):
            x = fnn.Embed(VOCAB, D, name="wte")(tokens)
            return (fnn.Dense(VOCAB, name="lm_head")(x),
                    fnn.Dense(1, name="value_head")(x))

    return {"mha": lambda: FLM(), "gqa": lambda: FLM(KV_HEADS, True),
            "swiglu": lambda: FLM(swiglu=True), "two_heads": FTwoHeads,
            "odd_vocab": lambda: FLM(vocab=ODD_VOCAB), "conv": FConvLM}


def flax_init(name: str, tokens):
    """The flax model's params from ``PRNGKey(0)`` (numpy)."""
    import jax

    model = flax_models()[name]()
    params = model.init(jax.random.PRNGKey(0), tokens)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def jax_registry(model: str = "mha"):
    """``port_registry``'s rules in JAX's paths and order."""
    from dlrover_tpu.accel.registry import ShardingRegistry

    if model == "conv":
        return (ShardingRegistry()
                .register(r"conv/kernel$", (None, None, "mlp"))
                .register(r"conv/bias$", ("mlp",))
                .register(r"gain$", ("mlp",)))
    return (ShardingRegistry()
            .register(r"block_\d+/up/kernel$", ("embed", "mlp"))
            .register(r"block_\d+/up/bias$", ("mlp",))
            .register(r"block_\d+/down/kernel$", ("mlp", "embed")))


def jax_loss(module, params, batch):
    import jax
    import jax.numpy as jnp

    logits = module.apply({"params": params}, batch)[:, :-1]
    logits = logits.astype(jnp.float32)
    lse = jax.scipy.special.logsumexp(logits, axis=-1)
    tgt = jnp.take_along_axis(logits, batch[:, 1:, None], axis=-1)[..., 0]
    return jnp.mean(lse - tgt)


def _flax_leaves(params):
    """{``/``-path: shape} of a flax params tree."""
    from dlrover_tpu_torch.models.convert import _flat

    return {path: tuple(np.shape(v)) for path, v in _flat(params)}


def _torch_name(path: str) -> str:
    """A flax leaf path -> the twin's parameter name."""
    *mods, leaf = path.split("/")
    leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight",
            "bias": "bias"}[leaf]
    return ".".join(mods + [leaf])


def _to_torch_order(path: str, axes: tuple) -> tuple:
    """JAX's axes of a flax leaf in the twin's dim order (a Dense kernel
    is transposed)."""
    return tuple(reversed(axes)) if path.endswith("/kernel") else axes


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """(name, flax model, flax params, twin holding them)."""
    name = request.param
    tokens = np.random.default_rng(0).integers(0, VOCAB, (2, 8)).astype(
        np.int32)
    model, params = flax_init(name, tokens)
    from dlrover_tpu_torch.models.convert import plain_from_flax

    twin = torch_model(name)
    twin.load_state_dict(plain_from_flax(params, twin))
    return name, model, params, twin, tokens


# ------------------------------------------------------ the converter


def test_converter_carries_the_flax_init_both_ways(pair):
    _round_trip(*pair[1:])


def _conv_pair():
    from dlrover_tpu_torch.models.convert import plain_from_flax

    tokens = np.random.default_rng(0).integers(0, VOCAB, (2, 8)).astype(
        np.int32)
    model, params = flax_init("conv", tokens)
    # A gain of ones would hide a dropped multiply.
    params["block_0"]["gain"] = np.linspace(0.5, 1.5, D, dtype=np.float32)
    twin = torch_model("conv")
    twin.load_state_dict(plain_from_flax(params, twin))
    return model, params, twin, tokens


def test_conv_and_bare_parameter_cross_both_ways():
    """``ConvLM``: the Conv kernel ``[k, in, out]`` becomes the Conv1d's
    ``[out, in, k]`` weight and back, the bare ``gain`` is its own leaf,
    bit for bit; the twin's logits are flax's within 1e-5."""
    model, params, twin, tokens = _conv_pair()
    assert tuple(twin.block_0.conv.weight.shape) == (D, D, CONV_K)
    _round_trip(model, params, twin, tokens)


def test_conv_registry_puts_the_channels_on_tensor_as_jax():
    """The conv registries of both packages give every ``ConvLM`` leaf the
    same axes (the torch order's reversed for a kernel), and the rules of
    ``tensor=2`` put the conv's out channels, its bias and ``gain`` on
    the tensor axis, beside the embedding's vocab (the defaults')."""
    from dlrover_tpu_torch.accel import ParallelSpec
    from dlrover_tpu_torch.accel.sharding import mesh_dims

    _, params, twin, _ = _conv_pair()
    jreg, preg = jax_registry("conv"), port_registry("conv")
    axes = preg.axes_of(twin)
    for path, shape in _flax_leaves(params).items():
        name = path.replace("/", ".")
        if path.endswith("/kernel"):
            name = name[:-len("kernel")] + "weight"
        elif path.endswith("/embedding") or path.endswith("/scale"):
            name = name.rsplit(".", 1)[0] + ".weight"
        want = jreg.axes_for(path, shape)
        got = axes[name]
        assert got == (tuple(reversed(want)) if path.endswith("/kernel")
                       else want), path
    rules = ParallelSpec(tensor=2).rules()
    on_tensor = {n for n, a in axes.items()
                 if "tensor" in mesh_dims(a, rules)}
    assert on_tensor == {"block_0.conv.weight", "block_0.conv.bias",
                         "block_0.gain", "wte.weight"}


def _round_trip(model, params, twin, tokens):
    import jax

    from dlrover_tpu_torch.models.convert import _flat, flax_from_plain

    back = dict(_flat(flax_from_plain(twin)))
    want = dict(_flat(params))
    assert set(back) == set(want)
    for path in want:
        assert back[path].dtype == want[path].dtype
        assert np.array_equal(back[path], want[path]), path
    out = model.apply({"params": params}, tokens)
    with torch.no_grad():
        got = twin(torch.from_numpy(tokens.astype(np.int64)))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(out)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


# ------------------------------------------------------ the registry


def test_default_axes_match_jax(pair):
    """The defaults on every parameter: embedding-like tables, 1-D leaves,
    the largest dim (a square kernel's out dim: JAX's tie rule on the
    flax leaf, torch's dim 0)."""
    from dlrover_tpu.accel.registry import default_registry as jreg
    from dlrover_tpu_torch.accel.registry import (
        default_registry,
        param_kinds,
    )

    name, _, params, twin, _ = pair
    kinds = param_kinds(twin)
    shapes = dict(twin.named_parameters())
    got = default_registry.axes_of(twin)
    for path, shape in _flax_leaves(params).items():
        tname = _torch_name(path)
        want = _to_torch_order(path, jreg.axes_for(path, shape))
        assert default_registry.axes_for(
            tname, tuple(shapes[tname].shape), kinds[tname]) == want, path
        assert got[tname] == want, path
    # A square kernel: JAX's tie picks the flax out dim, torch's dim 0.
    if name != "two_heads":
        assert got["block_0.q_proj.weight"] == ("embed", None)


def test_registered_rules_match_jax(pair):
    """A registered Megatron pair, the defaults for the rest (all of
    ``TwoHeads``)."""
    name, _, params, twin, _ = pair
    from dlrover_tpu_torch.accel.registry import param_kinds

    jreg, reg = jax_registry(), port_registry()
    kinds = param_kinds(twin)
    shapes = {n: tuple(p.shape) for n, p in twin.named_parameters()}
    for path, shape in _flax_leaves(params).items():
        tname = _torch_name(path)
        want = _to_torch_order(path, jreg.axes_for(path, shape))
        assert reg.axes_for(tname, shapes[tname], kinds[tname]) == want, path


def test_left_padding_and_rank_mismatch_match_jax():
    from dlrover_tpu.accel.registry import ShardingRegistry as JReg
    from dlrover_tpu_torch.accel.registry import ShardingRegistry

    jreg = JReg().register(r"stack", ("embed",))
    reg = ShardingRegistry().register(r"stack", ("embed",))
    for shape in ((4, 8), (2, 4, 8)):
        assert reg.axes_for("stack.w", shape) == \
            jreg.axes_for("stack/w", shape) == \
            (None,) * (len(shape) - 1) + ("embed",)
    jreg = JReg().register(r"w", ("embed", "mlp", None))
    reg = ShardingRegistry().register(r"w", ("embed", "mlp", None))
    for r, path in ((jreg, "w"), (reg, "w")):
        with pytest.raises(ValueError, match="rank-mismatch"):
            r.axes_for(path, (4, 8))


def test_has_annotations_is_logical_axes():
    from dlrover_tpu_torch.accel.registry import has_annotations
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig

    assert has_annotations(GPT(GPTConfig.tiny(), device="cpu"))
    assert not has_annotations(torch_model("mha"))


# ------------------------------------------------------ the planner


#: The Megatron pairs of ``tests/test_tp_planner.py``, by module.
_ATTN = {"q_proj": "col", "k_proj": "col", "v_proj": "col", "o_proj": "row"}
EXPECTED_ROLES = {
    "mha": {**_ATTN, "up": "col", "down": "row"},
    "gqa": {**_ATTN, "gate": "col", "up": "col", "down": "row"},
    "swiglu": {**_ATTN, "gate": "col", "up": "col", "down": "row"},
}


def _planned(name, twin, tokens):
    """(JAX's registry of the flax model, the port's of the twin)."""
    import jax

    from dlrover_tpu.accel.tp_planner import plan_tp as jplan
    from dlrover_tpu_torch.accel.tp_planner import plan_tp

    jreg = jplan(flax_models()[name](), jax.random.PRNGKey(0), tokens,
                 vocab_size=VOCAB)
    reg = plan_tp(twin, torch.from_numpy(tokens.astype(np.int64)),
                  vocab_size=VOCAB)
    return jreg, reg


def test_plan_roles_match_jax(pair):
    """Every parameter's planned axes (column: the out dim over ``mlp``,
    or ``vocab`` for the top-level head of the vocab's width; row: the
    in dim; a column layer's bias sharded, a row layer's replicated; the
    rest the defaults) equal JAX's ``plan_tp``'s, mapped to torch's
    names and order; the roles are the Megatron pairs (GQA's k/v
    contractions column-parallel, the d -> 1 value head row-parallel)."""
    from dlrover_tpu_torch.accel.registry import param_kinds

    name, _, params, twin, tokens = pair
    jreg, reg = _planned(name, twin, tokens)
    kinds = param_kinds(twin)
    shapes = {n: tuple(p.shape) for n, p in twin.named_parameters()}
    jroles = {}
    for path, shape in _flax_leaves(params).items():
        tname = _torch_name(path)
        want = _to_torch_order(path, jreg.axes_for(path, shape))
        assert reg.axes_for(tname, shapes[tname], kinds[tname]) == want, path
        if path.endswith("/kernel") and any(
                re.fullmatch(p.pattern.strip("^$"), path)
                for p, _ in jreg._rules):
            mod = tname[:-len(".weight")]
            jroles[mod] = "row" if want[1] == "mlp" else "col"
    assert reg.roles == jroles
    if name == "two_heads":
        assert reg.roles == {"lm_head": "col", "value_head": "row"}
        assert reg.axes_for("lm_head.weight", (VOCAB, D)) == ("vocab",
                                                               "embed")
        return
    want = {f"block_{i}.{m}": role for i in range(LAYERS)
            for m, role in EXPECTED_ROLES[name].items()}
    want["lm_head"] = "col"
    assert reg.roles == want
    assert reg.axes_for("lm_head.weight", (VOCAB, D)) == ("vocab", "embed")


def test_plan_keeps_the_modules_modes_and_norms_out():
    """The planning forward runs in eval mode and leaves every module's
    mode as it was; norms (no ``nn.Linear``) are never planned."""
    from dlrover_tpu_torch.accel.tp_planner import plan_tp

    twin = torch_model("mha")
    twin.train()
    twin.block_0.eval()
    reg = plan_tp(twin, torch.zeros((1, 8), dtype=torch.long))
    assert twin.training and not twin.block_0.training
    assert twin.block_1.training
    assert not any("ln" in pat.pattern for pat, _ in reg._rules)
