"""GPT-2-class decoder in PyTorch — counterpart of ``dlrover_tpu/models/gpt.py``.

Same config, same parameters and the same numerics as the JAX model:

- params in ``param_dtype`` (fp32 by default; the 1.5B preset trains
  ``gpt2_xl`` with bf16 params); Dense, embedding and the tied head
  compute in ``dtype`` (bf16 by default: the weight is cast, the product
  runs in bf16);
  LayerNorm's scale and bias join its fp32 arithmetic, as flax's do;
- LayerNorm takes its statistics in fp32 (E[x^2] - E[x]^2, clipped at 0,
  as flax does) and casts its output to ``dtype``; the residual stream
  is ``dtype``; logits are upcast to fp32 only inside ``loss_fn``;
- GELU is the tanh approximation; ``qkv`` splits into contiguous thirds,
  each reshaped to (heads, head_dim);
- Dense kernels keep flax's ``[in, out]`` layout (``y = x @ kernel +
  bias``), so weights carry across without transposes
  (``models/convert.py``); init is normal(0.02) for Dense and the token
  embedding, normal(0.01) for the position embedding.

``attn_impl="pallas"`` runs the hand-written flash-attention kernels
(``ops/attention.py``), ``"xla"`` the plain einsum softmax, ``"ring"``
and ``"ulysses"`` the sequence-parallel attention over the model's
``seq`` group (``ops/ring_attention.py``, ``ops/ulysses.py``; plain
attention without one, as in JAX). ``remat``
checkpoints each block under ``remat_policy`` (``models/remat.py``:
"nothing", "dots", "dots_lite", "offload"; every matrix product goes
through ``remat.product`` and the block names ``attn_out`` and
``ffn_act`` where JAX does).

``num_experts > 0`` makes every block's FFN an ``ops.moe.MoEMLP`` of gelu
experts (parameters ``blocks.<i>.moe.{router, w_up, b_up, w_down,
b_down}``), and the model returns ``(logits, aux)``, the load-balance
loss averaged over the layers; train it with ``moe_loss_fn``. On a
``seq`` mesh axis (``accel.accelerate``) the model keeps its shard of
each row's sequence, its position rows are sharded over the axis, and
its logits are a sequence-sharded DTensor (``models/sequence_parallel``).
On a ``tensor`` axis the blocks compute on their local heads, and when
the vocab divides by the degree the tied ``wte``'s rows are sharded
over it: the lookup is vocab-parallel and the head's logits a DTensor
sharded along the vocab (GPT-2's 50257 stays whole, with JAX's
warning).

``pipeline_stages > 1`` splits the blocks into a GPipe schedule
(``pipeline.stages.<p>.blocks.<j>``), or with ``pipeline_repeats > 1`` a
circular one (``pipeline.bank.<p>.<c>.blocks.<k>``), of
``pipeline_microbatches`` microbatches (``accel/pipeline.py``); the
blocks are initialized in logical layer order, so a pipelined model
holds the weights of the unpipelined one of the same seed. On a
``pipe`` mesh axis a rank keeps its stages, the first also ``wte`` and
``wpe``, the last ``ln_f`` and the tied head's ``wte``; the forward
returns None on every rank but the last. The int8 MLP raises
``NotImplementedError``.
"""

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.models import sequence_parallel as sp
from dlrover_tpu_torch.models import tensor_parallel as tp
from dlrover_tpu_torch.models.remat import (
    Remat,
    check_policy,
    checkpoint_name,
    product,
)
# The module, not its names: ops.moe imports this package in turn.
from dlrover_tpu_torch.ops import moe as moe_ops


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 0  # 0 -> 4 * d_model
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False
    remat_policy: str = "nothing"
    # Layers run as a Python loop here; kept so JAX configs carry over.
    scan_layers: bool = True
    scan_unroll: int = 1
    attn_impl: str = "xla"  # "xla" | "pallas" | "ring" | "ulysses"
    # TPU tile hints of the JAX kernel; the CUDA kernels pick 64 x 64.
    attn_block_q: int = 512
    attn_block_k: int = 512
    mlp_precision: str = "bf16"
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    pipeline_repeats: int = 1

    def __post_init__(self):
        if self.pipeline_stages > 1:
            chunks = self.pipeline_stages * max(self.pipeline_repeats, 1)
            if self.num_layers % chunks:
                raise ValueError(
                    f"num_layers {self.num_layers} not divisible by "
                    f"pipeline_stages*repeats {chunks}"
                )

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def flops_per_token(self) -> float:
        """Approx training FLOPs/token (6*N_active params + attention)."""
        n = self.param_count(active=True)
        attn = 12 * self.num_layers * self.d_model * self.max_seq_len
        return 6 * n + attn

    def param_count(self, active: bool = False) -> int:
        """Total params; ``active=True`` counts only the top-k experts a
        token visits (the MoE FLOPs basis)."""
        d, f, v, l = self.d_model, self.ff_dim, self.vocab_size, self.num_layers
        if self.num_experts > 0:
            n_ffn = self.moe_top_k if active else self.num_experts
            mlp = n_ffn * (2 * d * f + f + d) + d * self.num_experts
        else:
            mlp = 2 * d * f
        per_layer = 4 * d * d + mlp + 4 * d  # qkvo + ffn/moe + ln
        return v * d + self.max_seq_len * d + l * per_layer + d

    def vocab_param_count(self) -> int:
        """The params outside the layer stack: the embedding and the
        position table (the head is tied to the embedding)."""
        return self.vocab_size * self.d_model + self.max_seq_len * self.d_model

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=256, max_seq_len=64, num_layers=2,
                         num_heads=2, d_model=32)

    @staticmethod
    def gpt2_xl():
        """GPT-2 1.5B, the JAX package's large preset (``remat=True`` as
        there)."""
        return GPTConfig(vocab_size=50257, max_seq_len=1024, num_layers=48,
                         num_heads=25, d_model=1600, remat=True)


def _check_supported(cfg: GPTConfig):
    check_policy(cfg)
    if cfg.mlp_precision != "bf16":
        raise NotImplementedError(
            f"mlp_precision={cfg.mlp_precision!r} comes with the int8 "
            "matmul slice of the port (ROADMAP queue 1)"
        )
    if cfg.attn_impl not in ("xla", "pallas", "ring", "ulysses"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel [in, out]`` and ``bias`` (unless
    ``use_bias=False``) in ``param_dtype``; the product runs in
    ``dtype``. ``axes`` are the kernel's logical axes (the bias has the
    last one), as the JAX model annotates them.

    Under tensor parallelism (``tp``: ``("column" | "row", group)``, set
    by ``accel.accelerate``) the kernel is a DTensor and the product
    runs on its local shard: a column-parallel layer gives this rank's
    output columns, a row-parallel one sums its partial products over
    the group before the (replicated) bias."""

    def __init__(self, d_in: int, d_out: int, cfg, device,
                 use_bias: bool = True, axes=("embed", "mlp")):
        super().__init__()
        self.dtype = cfg.dtype
        self.axes = tuple(axes)
        self.tp = None
        # Zeros until reset_parameters: a layer built alone holds no
        # uninitialized (possibly non-finite) memory.
        self.kernel = nn.Parameter(
            torch.zeros(d_in, d_out, dtype=cfg.param_dtype, device=device)
        )
        self.bias = nn.Parameter(
            torch.zeros(d_out, dtype=cfg.param_dtype, device=device)
        ) if use_bias else None

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.kernel.normal_(0.0, 0.02, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        x = x.to(self.dtype)
        kernel, bias = self.kernel, self.bias
        if self.tp is not None:
            kernel = kernel.to_local()
            if self.tp[0] == "column" and bias is not None:
                bias = bias.to_local()
        # x @ kernel as matmul folds it: one mm over the flattened rows.
        y = product(x.reshape(-1, x.shape[-1]), kernel.to(self.dtype))
        y = y.view(*x.shape[:-1], y.shape[-1])
        if self.tp is not None and self.tp[0] == "row":
            y = tp.reduce(y, self.tp[1])
        if bias is None:
            return y
        return y + bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)``: fp32 statistics, output cast
    to ``dtype``; ``weight`` is flax's ``scale``."""

    def __init__(self, d: int, cfg: GPTConfig, device, eps: float = 1e-5):
        super().__init__()
        self.dtype = cfg.dtype
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(d, dtype=cfg.param_dtype, device=device)
        )
        self.bias = nn.Parameter(
            torch.zeros(d, dtype=cfg.param_dtype, device=device)
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype)


def _attention(q, k, v, cfg: GPTConfig, seq_group=None):
    """Causal attention. q, k, v: [B, S, H, D] (this rank's sequence shard
    under ring / Ulysses attention over ``seq_group``)."""
    if cfg.attn_impl == "ring":
        from dlrover_tpu_torch.ops.ring_attention import ring_attention

        return ring_attention(q, k, v, causal=True, group=seq_group)
    if cfg.attn_impl == "ulysses":
        from dlrover_tpu_torch.ops.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, causal=True, group=seq_group)
    if cfg.attn_impl == "pallas":
        from dlrover_tpu_torch.ops.attention import flash_attention

        return flash_attention(
            q, k, v, causal=True,
            block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        )
    # The einsums "bqhd,bkhd->bhqk" and "bhqk,bkhd->bqhd" as the two
    # batched products remat "dots" keeps.
    scale = 1.0 / math.sqrt(cfg.head_dim)
    b, s, h, d = q.shape
    heads = lambda t: t.transpose(1, 2).reshape(b * h, s, d)  # noqa: E731
    kt = k.permute(0, 2, 3, 1).reshape(b * h, d, s)
    logits = product(heads(q), kt).view(b, h, s, s) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(cfg.dtype)
    out = product(probs.reshape(b * h, s, s), heads(v))
    return out.view(b, h, s, d).transpose(1, 2)


class Block(nn.Module):
    """Pre-LN transformer block. Under tensor parallelism (``tp_group``
    set by ``accel.accelerate``) it computes on this rank's ``heads``
    of q, of k and of v (the local columns of ``qkv``, three regions)
    and its ``mlp`` columns; on a ``seq`` axis its attention crosses the
    ``seq_group``. With experts its FFN is ``moe`` and it returns
    ``(x, aux)``."""

    def __init__(self, cfg: GPTConfig, device):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.heads = cfg.num_heads
        self.tp_group = None
        self.seq_group = None
        self.ln1 = LayerNorm(d, cfg, device)
        self.qkv = Dense(d, 3 * d, cfg, device, axes=("embed", "heads"))
        self.proj = Dense(d, d, cfg, device, axes=("heads", "embed"))
        self.ln2 = LayerNorm(d, cfg, device)
        if cfg.num_experts > 0:
            self.moe = moe_ops.MoEMLP(cfg, device, mlp_type="gelu")
        else:
            self.up = Dense(d, cfg.ff_dim, cfg, device, axes=("embed", "mlp"))
            self.down = Dense(cfg.ff_dim, d, cfg, device,
                              axes=("mlp", "embed"))

    def forward(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        h, hd = self.heads, cfg.head_dim
        y = tp.enter(self.ln1(x), self.tp_group)
        q, k, v = self.qkv(y).split(h * hd, dim=-1)
        attn = _attention(
            q.reshape(b, s, h, hd), k.reshape(b, s, h, hd),
            v.reshape(b, s, h, hd), cfg, self.seq_group,
        ).reshape(b, s, h * hd)
        attn = checkpoint_name(attn, "attn_out")
        x = x + self.proj(attn)
        if cfg.num_experts > 0:
            y, aux = self.moe(self.ln2(x))
            return x + y, aux
        y = tp.enter(self.ln2(x), self.tp_group)
        y = F.gelu(self.up(y), approximate="tanh")
        y = checkpoint_name(y, "ffn_act")
        return x + self.down(y)


class GPT(nn.Module):
    """Decoder-only LM. ``forward(tokens[B,S]) -> logits[B,S,V]``, or
    ``(logits, aux)`` with experts.

    Built on ``device`` (the card unless the caller names another) and
    initialized from ``generator`` (a seeded ``torch.Generator`` on that
    device; seed 0 when omitted).
    """

    def __init__(self, cfg: GPTConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.wte = nn.Embedding(
            cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype, device=device
        )
        self.wpe = nn.Parameter(torch.empty(
            cfg.max_seq_len, cfg.d_model, dtype=cfg.param_dtype,
            device=device,
        ))
        self.remat = Remat(cfg)
        self.pipeline = None
        if cfg.pipeline_stages > 1:
            from dlrover_tpu_torch.accel import pipeline

            self.pipeline = pipeline.build(cfg, lambda: Block(cfg, device),
                                           self.remat)
        else:
            self.blocks = nn.ModuleList(
                Block(cfg, device) for _ in range(cfg.num_layers)
            )
        self.ln_f = LayerNorm(cfg.d_model, cfg, device)
        # The tensor-parallel group's mesh when wte's vocab rows are
        # sharded (set by accel.accelerate): the lookup is vocab-parallel
        # and the tied head's logits a DTensor sharded along the vocab.
        self.vocab_mesh = None
        # The seq axis's 1-D mesh on a seq mesh (set by accel.accelerate).
        self.seq_mesh = None
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.wte.weight.normal_(0.0, 0.02, generator=generator)
            self.wpe.normal_(0.0, 0.01, generator=generator)
        _reset_in_order(self, [self.ln_f], generator,
                        (Dense, LayerNorm, moe_ops.MoEMLP))

    def layers_in_order(self):
        """The blocks this model holds, in logical layer order."""
        return layers_in_order(self, "blocks")

    def keep_ends(self, first: bool, last: bool):
        """On a pipe rank: drop what neither end of the pipeline it holds
        reads (the first embeds, the last runs ``ln_f`` and the tied
        head)."""
        if not first:
            self.wpe = None
        if not (first or last):
            self.wte = None
        if not last:
            self.ln_f = None

    #: Parameters a pipe mesh keeps on both its first and its last rank.
    TIED = ("wte.weight",)

    def logical_axes(self):
        """Each parameter's logical axes, as the JAX GPT annotates them
        (``dlrover_tpu/models/gpt.py``)."""
        return _logical_axes(self, {"wte.weight": ("vocab", "embed"),
                                    "wpe": ("seq", "embed")})

    def forward(self, tokens):
        cfg = self.cfg
        tokens, lo = sp.shard_tokens(tokens, self.seq_mesh)
        b, s = tokens.shape
        pipe = self.pipeline
        if pipe is None or pipe.first:
            wpe = sp.gather_rows(self.wpe, self.seq_mesh)
            x = tp.embed(self.wte, tokens, self.vocab_mesh).to(cfg.dtype) \
                + wpe[lo:lo + s].to(cfg.dtype)
        else:  # a later pipe rank: the shape of what it receives
            x = torch.empty(b, s, cfg.d_model, dtype=cfg.dtype, device="meta")
        if pipe is None:
            x, auxes = self.remat.run(self.blocks, x)
            aux = torch.stack(auxes).mean() if auxes else None
        else:
            out = pipe(x)
            if out is None:
                return None
            x, aux = out
        x = self.ln_f(x)
        # Tied output head: logits via the embedding table, in dtype.
        if self.vocab_mesh is None:
            logits = sp.shard_logits(x @ self.wte.weight.to(cfg.dtype).t(),
                                     self.seq_mesh)
        else:
            from torch.distributed.tensor import DTensor, Shard

            x = tp.enter(x, self.vocab_mesh.get_group())
            logits = DTensor.from_local(
                x @ self.wte.weight.to_local().to(cfg.dtype).t(),
                self.vocab_mesh, [Shard(2)], run_check=False)
        if cfg.num_experts > 0:
            return logits, aux
        return logits


def layers_in_order(model: nn.Module, stack: str):
    """A model's blocks in logical layer order: its ``stack``, or its
    pipeline's chunks in logical order."""
    if model.pipeline is not None:
        return model.pipeline.layers()
    return list(getattr(model, stack))


def _reset_in_order(model: nn.Module, tail, generator: torch.Generator,
                    kinds):
    """Initialize the ``kinds`` of modules of every block in logical layer
    order, then those of ``tail``: a pipelined model draws what the
    unpipelined one of the same seed draws, in the same order."""
    for block in list(model.layers_in_order()) + list(tail):
        for m in block.modules():
            if isinstance(m, kinds):
                m.reset_parameters(generator)


def _logical_axes(model: nn.Module, top, norms=(LayerNorm,)) -> dict:
    """``{parameter name: logical axes}``: ``top`` for the parameters
    outside the layers, a ``Dense``'s kernel axes (its bias: the last),
    ``("embed",)`` for a norm's and an MoE layer's ``AXES``."""
    out = {}
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, moe_ops.MoEMLP):
            for leaf, _ in module.named_parameters(recurse=False):
                out[prefix + leaf] = module.AXES[leaf]
        elif isinstance(module, Dense):
            out[prefix + "kernel"] = module.axes
            if module.bias is not None:
                out[prefix + "bias"] = module.axes[-1:]
        elif isinstance(module, norms):
            for leaf, _ in module.named_parameters(recurse=False):
                out[prefix + leaf] = ("embed",)
    out.update(top)
    return out


def loss_fn(logits, tokens):
    """Next-token cross entropy; logits[B,S,V], tokens[B,S]: logsumexp
    minus the target logit, in fp32. Logits that are a DTensor sharded
    along the vocab (a vocab-parallel head) take the logsumexp and the
    target logit across the shards (``models/tensor_parallel.py``);
    sharded along the sequence, each rank its positions' share
    (``models/sequence_parallel.py``)."""
    from torch.distributed.tensor import DTensor, Shard

    targets = tokens[:, 1:]
    if isinstance(logits, DTensor) and logits.placements[0] == Shard(1):
        return sp.loss(logits, tokens)
    if isinstance(logits, DTensor):
        mesh = logits.device_mesh
        x = logits.to_local()[:, :-1].float()
        lo = mesh.get_local_rank() * x.shape[-1]
        group = mesh.get_group()
        lse = tp.vocab_parallel_lse(x, group)
        tgt = tp.vocab_parallel_target(x, targets.long(), lo, group)
        return torch.mean(lse - tgt)
    logits = logits[:, :-1].float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(lse - tgt)


def moe_loss_fn(out, tokens, aux_weight: float = 1e-2):
    """Loss of a model with experts: ``out`` is its ``(logits, aux)``;
    ``loss_fn`` plus the load-balance loss at Switch's weight."""
    logits, aux = out
    return loss_fn(logits, tokens) + aux_weight * aux
