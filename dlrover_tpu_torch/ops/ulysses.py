"""Ulysses-style all-to-all sequence parallelism — counterpart of
``dlrover_tpu/ops/ulysses.py``.

One all-to-all turns q, k and v from sequence-sharded ``[B, S/n, H, D]``
to head-sharded ``[B, S, H/n, D]`` (JAX's tiled ``all_to_all``,
``split_axis=2``, ``concat_axis=1``: head chunk j goes to rank j, the
received blocks concatenated along the sequence in rank order); every
rank runs full-sequence attention over its heads, and a second
all-to-all restores the sequence sharding. The all-to-alls are
autograd-aware: each one's backward is the other.

``inner="xla"`` runs the plain ``reference_attention``; ``inner="pallas"``
runs the flash kernels unchanged (``ops/attention.py``).
``ulysses_attention`` runs plain attention when there is no ``seq``
group larger than one, as the JAX package does with no ``seq`` axis.
"""

from typing import Any, Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.ops.attention import flash_attention, \
    reference_attention

__all__ = ["ulysses_attention", "ulysses_attention_shard"]


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of x's dim 0 to rank j; chunk i of the result from rank i."""
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S/n, H, D] -> [B, S, H/n, D]."""
    n = dist.get_world_size(group)
    b, s, h, d = x.shape
    parts = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = _all_to_all(parts, group)  # [n (source), B, S/n, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S, H/n, D] -> [B, S/n, H, D]."""
    n = dist.get_world_size(group)
    b, s, hn, d = x.shape
    parts = x.reshape(b, n, s // n, hn, d).permute(1, 0, 2, 3, 4)
    got = _all_to_all(parts, group)  # [n (source), B, S/n, H/n, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hn, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group), None


def ulysses_attention_shard(q, k, v, causal: bool = True, group: Any = None,
                            inner: str = "xla"):
    """Per-rank body. q, k, v: this rank's sequence blocks [B, S/n, H, D];
    H must divide by the size n of ``group`` (the default group when
    None)."""
    n = dist.get_world_size(group)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"ulysses: heads {h} not divisible by seq degree "
                         f"{n}")
    if inner not in ("xla", "pallas"):
        raise ValueError(f"unknown inner {inner!r}")
    qg, kg, vg = (_SeqToHeads.apply(t, group) for t in (q, k, v))
    if inner == "pallas":
        out = flash_attention(qg, kg, vg, causal=causal)
    else:
        out = reference_attention(qg, kg, vg, causal=causal)
    return _HeadsToSeq.apply(out, group)


def ulysses_attention(q, k, v, causal: bool = True,
                      group: Optional[Any] = None, inner: str = "xla"):
    """Sequence-parallel attention via two all-to-alls over ``group``
    (the model's ``seq`` group); plain attention when there is none or
    it has one rank."""
    if group is None or dist.get_world_size(group) <= 1:
        return reference_attention(q, k, v, causal=causal)
    return ulysses_attention_shard(q, k, v, causal=causal, group=group,
                                   inner=inner)
