"""LLaMA-family decoder in PyTorch — counterpart of ``dlrover_tpu/models/llama.py``.

RoPE, RMSNorm, SwiGLU and grouped-query attention, with the JAX model's
config, parameters and numerics:

- RoPE rotates **interleaved pairs** (``x[..., 0::2]``, ``x[..., 1::2]``,
  stacked on the last axis), in fp32, cast back to the input's dtype;
- RMSNorm is flax's: eps 1e-5, the mean square in fp32, the scale folded
  into ``rsqrt`` before the multiply, output cast to ``dtype``;
- no projection has a bias; the SwiGLU MLP is ``down(silu(gate) * up)``;
- GQA repeats each kv head ``num_heads / kv_heads`` times in place
  (``repeat_interleave``, as ``jnp.repeat(axis=2)``); the attention
  kernels stay multi-head;
- the head is **untied** (``lm_head``), vocab 32000 in the presets;
- parameters mirror the JAX tree: ``embed``, per layer ``attn_norm``,
  ``q_proj``, ``k_proj``, ``v_proj``, ``o_proj``, ``mlp_norm``,
  ``gate_proj``, ``up_proj``, ``down_proj``, then ``final_norm`` and
  ``lm_head``; the layers are ``layers.<i>`` (JAX's scanned ``layers``,
  or ``layer_<i>`` unscanned; ``models/convert.py`` carries them).

``attn_impl="pallas"`` runs the hand-written flash kernels (head_dim 128
in the presets), ``"xla"`` the einsum softmax, ``"ring"`` / ``"ulysses"``
the sequence-parallel attention (GQA's K/V repeated to the query heads
first, as in JAX); ``remat`` checkpoints each layer under
``remat_policy`` (``models/remat.py``). ``num_experts > 0`` makes every
layer's MLP an ``ops.moe.MoEMLP`` of swiglu experts (``layers.<i>.moe``:
``router``, ``w_up``, ``b_up``, ``w_gate``, ``w_down``, ``b_down``) and
the model returns ``(logits, aux)``, as the port's GPT does. On a
``tensor`` mesh axis the layers compute on their local heads, and the
embedding's rows and the head's vocab columns are sharded over it (the
lookup vocab-parallel, the logits a DTensor). On a ``seq`` mesh axis
RoPE takes each shard's global positions.
``pipeline_stages > 1`` runs the layers as the port's GPT runs its
blocks (``accel/pipeline.py``; ``pipeline.stages.<p>.blocks.<j>``, or
``pipeline.bank.<p>.<c>.blocks.<k>``, JAX's ``_LlamaStage`` names); on a
``pipe`` axis the first rank keeps ``embed``, the last ``final_norm``
and ``lm_head``. The int8 MLP raises ``NotImplementedError``, as in the
port's GPT.
"""

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.models import sequence_parallel as sp
from dlrover_tpu_torch.models import tensor_parallel as tp
from dlrover_tpu_torch.models.gpt import (  # shared attention + loss
    Dense,
    _attention,
    _check_supported,
    _logical_axes,
    _reset_in_order,
    layers_in_order,
    loss_fn,
    moe_loss_fn,
)
from dlrover_tpu_torch.models.remat import Remat, checkpoint_name
# The module, not its names: ops.moe imports this package in turn.
from dlrover_tpu_torch.ops import moe as moe_ops

__all__ = ["LlamaConfig", "Llama", "LlamaBlock", "RMSNorm", "rope",
           "loss_fn", "moe_loss_fn"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 0  # 0 -> = num_heads (MHA); < heads = GQA
    d_model: int = 1024
    d_ff: int = 0  # 0 -> the LLaMA 8/3 * d_model rounded up to 128
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False
    remat_policy: str = "nothing"
    # Layers run as a Python loop here; kept so JAX configs carry over.
    scan_layers: bool = True
    attn_impl: str = "xla"  # "xla" | "pallas" | "ring" | "ulysses"
    # TPU tile hints of the JAX kernel; the CUDA kernels pick their own.
    attn_block_q: int = 512
    attn_block_k: int = 512
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    mlp_precision: str = "bf16"
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    pipeline_repeats: int = 1

    def __post_init__(self):
        if self.kv_heads > self.num_heads or self.num_heads % self.kv_heads:
            raise ValueError(
                f"num_kv_heads {self.kv_heads} must divide num_heads "
                f"{self.num_heads}"
            )
        if self.pipeline_stages > 1:
            chunks = self.pipeline_stages * max(self.pipeline_repeats, 1)
            if self.num_layers % chunks:
                raise ValueError(
                    f"num_layers {self.num_layers} not divisible by "
                    f"pipeline_stages*repeats {chunks}"
                )

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff:
            return self.d_ff
        raw = int(8 * self.d_model / 3)
        return (raw + 127) // 128 * 128

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def param_count(self, active: bool = False) -> int:
        """Total params; with experts, ``active=True`` counts only the
        top-k experts a token visits (as the JAX GPT counts them, with
        three matrices and both biases a swiglu expert)."""
        d, f, v, l = self.d_model, self.ff_dim, self.vocab_size, self.num_layers
        kv = self.kv_heads * self.head_dim
        if self.num_experts > 0:
            n_ffn = self.moe_top_k if active else self.num_experts
            mlp = n_ffn * (3 * d * f + f + d) + d * self.num_experts
        else:
            mlp = 3 * d * f
        per_layer = d * d + 2 * d * kv + d * d + mlp + 2 * d
        return 2 * v * d + l * per_layer + d

    def vocab_param_count(self) -> int:
        """Embedding + untied LM head: the params outside the layers."""
        return 2 * self.vocab_size * self.d_model

    def flops_per_token(self) -> float:
        """Approx training FLOPs/token (6 * active params + attention)."""
        attn = 12 * self.num_layers * self.d_model * self.max_seq_len
        return 6 * self.param_count(active=True) + attn

    @staticmethod
    def tiny():
        return LlamaConfig(vocab_size=256, max_seq_len=64, num_layers=2,
                           num_heads=4, num_kv_heads=2, d_model=32)

    @staticmethod
    def preset(seq_len: int = 2048):
        """The JAX package's ~1.15B LLaMA as ``bench.py``'s
        ``section_llama`` trains it: 22 x 2048, 16 heads / 8 kv heads
        (head_dim 128), vocab 32000, bf16 params, remat "dots", the
        flash kernels."""
        return LlamaConfig(
            vocab_size=32000, max_seq_len=seq_len, num_layers=22,
            num_heads=16, num_kv_heads=8, d_model=2048,
            param_dtype=torch.bfloat16, remat=True, remat_policy="dots",
            attn_impl="pallas", attn_block_q=1024, attn_block_k=1024,
        )


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(epsilon=1e-5, dtype=dtype)``: the mean square in
    fp32, ``rsqrt(ms + eps) * scale`` then the multiply, output cast to
    ``dtype``; ``weight`` is flax's ``scale``."""

    def __init__(self, d: int, cfg: LlamaConfig, device, eps: float = 1e-5):
        super().__init__()
        self.dtype = cfg.dtype
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(d, dtype=cfg.param_dtype, device=device)
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        xf = x.float()
        mul = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps) * \
            self.weight.float()
        return (xf * mul).to(self.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over [B, S, H, D] (D even), positions [S]: each
    interleaved pair (x[2i], x[2i+1]) rotated by positions * theta^(-2i/D),
    in fp32."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[:, None].float() * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]  # [1, S, 1, D/2]
    sin = torch.sin(angles)[None, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                      dim=-1).reshape(x.shape)
    return out.to(x.dtype)


class LlamaBlock(nn.Module):
    """Pre-norm decoder layer: GQA attention with RoPE, SwiGLU MLP. Under
    tensor parallelism (``tp_group`` set by ``accel.accelerate``) it
    computes on this rank's ``heads`` and ``kv_heads`` (both counts
    split) and its ``mlp`` columns; on a ``seq`` axis its positions are
    its shard's and its attention crosses the ``seq_group``. With
    experts its MLP is ``moe`` and it returns ``(x, aux)``."""

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        kv = cfg.kv_heads * hd
        self.cfg = cfg
        self.heads, self.kv_heads = cfg.num_heads, cfg.kv_heads
        self.tp_group = None
        self.seq_group = None
        self.attn_norm = RMSNorm(d, cfg, device)
        heads, mlp = ("embed", "heads"), ("embed", "mlp")
        self.q_proj = Dense(d, cfg.num_heads * hd, cfg, device,
                            use_bias=False, axes=heads)
        self.k_proj = Dense(d, kv, cfg, device, use_bias=False, axes=heads)
        self.v_proj = Dense(d, kv, cfg, device, use_bias=False, axes=heads)
        self.o_proj = Dense(d, d, cfg, device, use_bias=False,
                            axes=("heads", "embed"))
        self.mlp_norm = RMSNorm(d, cfg, device)
        if cfg.num_experts > 0:
            self.moe = moe_ops.MoEMLP(cfg, device, mlp_type="swiglu")
            return
        self.gate_proj = Dense(d, cfg.ff_dim, cfg, device, use_bias=False,
                               axes=mlp)
        self.up_proj = Dense(d, cfg.ff_dim, cfg, device, use_bias=False,
                             axes=mlp)
        self.down_proj = Dense(cfg.ff_dim, d, cfg, device, use_bias=False,
                               axes=("mlp", "embed"))

    def forward(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        h, kvh, hd = self.heads, self.kv_heads, cfg.head_dim
        y = tp.enter(self.attn_norm(x), self.tp_group)
        q = self.q_proj(y).reshape(b, s, h, hd)
        k = self.k_proj(y).reshape(b, s, kvh, hd)
        v = self.v_proj(y).reshape(b, s, kvh, hd)
        # A seq rank's tokens start at rank * s (an even split).
        lo = 0 if self.seq_group is None else \
            dist.get_rank(self.seq_group) * s
        positions = torch.arange(lo, lo + s, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if kvh != h:
            k = torch.repeat_interleave(k, h // kvh, dim=2)
            v = torch.repeat_interleave(v, h // kvh, dim=2)
        attn = _attention(q, k, v, cfg, self.seq_group).reshape(b, s, h * hd)
        attn = checkpoint_name(attn, "attn_out")
        x = x + self.o_proj(attn)
        if cfg.num_experts > 0:
            y, aux = self.moe(self.mlp_norm(x))
            return x + y, aux
        y = tp.enter(self.mlp_norm(x), self.tp_group)
        y = F.silu(self.gate_proj(y)) * self.up_proj(y)
        y = checkpoint_name(y, "ffn_act")
        return x + self.down_proj(y)


class Llama(nn.Module):
    """Decoder-only LM. ``forward(tokens[B,S]) -> logits[B,S,V]``, or
    ``(logits, aux)`` with experts.

    Built on ``device`` (the card unless the caller names another) and
    initialized from ``generator`` (a seeded ``torch.Generator`` on that
    device; seed 0 when omitted): normal(0.02) for the embedding and
    every projection, ones for the norms.
    """

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(
            cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype, device=device
        )
        self.remat = Remat(cfg)
        self.pipeline = None
        if cfg.pipeline_stages > 1:
            from dlrover_tpu_torch.accel import pipeline

            self.pipeline = pipeline.build(
                cfg, lambda: LlamaBlock(cfg, device), self.remat)
        else:
            self.layers = nn.ModuleList(
                LlamaBlock(cfg, device) for _ in range(cfg.num_layers)
            )
        self.final_norm = RMSNorm(cfg.d_model, cfg, device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg, device,
                             use_bias=False, axes=("embed", "vocab"))
        # The tensor-parallel group's mesh when the embedding and the head
        # are vocab-parallel (set by accel.accelerate): the lookup sums
        # the ranks' rows, and the logits are a DTensor sharded along the
        # vocab.
        self.vocab_mesh = None
        # The seq axis's 1-D mesh on a seq mesh (set by accel.accelerate).
        self.seq_mesh = None
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 0.02, generator=generator)
        _reset_in_order(self, [self.final_norm, self.lm_head], generator,
                        (Dense, RMSNorm, moe_ops.MoEMLP))

    def layers_in_order(self):
        """The layers this model holds, in logical order."""
        return layers_in_order(self, "layers")

    def keep_ends(self, first: bool, last: bool):
        """On a pipe rank: the first keeps the embedding, the last the
        final norm and the head."""
        if not first:
            self.embed = None
        if not last:
            self.final_norm = None
            self.lm_head = None

    TIED = ()

    def logical_axes(self):
        """Each parameter's logical axes, as the JAX LLaMA annotates them
        (``dlrover_tpu/models/llama.py``)."""
        return _logical_axes(self, {"embed.weight": ("vocab", "embed")},
                             norms=(RMSNorm,))

    def forward(self, tokens):
        cfg = self.cfg
        tokens, _ = sp.shard_tokens(tokens, self.seq_mesh)
        pipe = self.pipeline
        if pipe is None or pipe.first:
            x = tp.embed(self.embed, tokens, self.vocab_mesh).to(cfg.dtype)
        else:  # a later pipe rank: the shape of what it receives
            x = torch.empty(*tokens.shape, cfg.d_model, dtype=cfg.dtype,
                            device="meta")
        if pipe is None:
            x, auxes = self.remat.run(self.layers, x)
            aux = torch.stack(auxes).mean() if auxes else None
        else:
            out = pipe(x)
            if out is None:
                return None
            x, aux = out
        x = self.final_norm(x)
        if self.vocab_mesh is None:
            logits = sp.shard_logits(self.lm_head(x), self.seq_mesh)
        else:
            from torch.distributed.tensor import DTensor, Shard

            logits = self.lm_head(tp.enter(x, self.vocab_mesh.get_group()))
            logits = DTensor.from_local(logits, self.vocab_mesh, [Shard(2)],
                                        run_check=False)
        if cfg.num_experts > 0:
            return logits, aux
        return logits
