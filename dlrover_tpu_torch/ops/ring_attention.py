"""Ring attention — sequence parallelism over a process group;
counterpart of ``dlrover_tpu/ops/ring_attention.py``.

Each rank keeps its query block and the K/V blocks rotate around the
``seq`` group (``batch_isend_irecv``: to the next rank, from the one
before). Softmax is the online (max / sum carrying) form in fp32, so
the result is exact: the arithmetic is the JAX ring's, step for step.
The causal mask uses global positions (query row r of rank ``my`` is at
``my * S_local + r``, key column c of the block from rank ``src`` at
``src * S_local + c``); a block wholly above the diagonal contributes
nothing (its probabilities are set to zero); the final ``l == 0`` guard
stays. Every block is computed, masked or not, as in JAX: each rank's
rotated K/V then take part in its graph, so every rank runs each
rotation's backward exchange.

The backward is autograd's through the same operations, with the
rotation's own backward (the gradients rotate the other way), as JAX
differentiates through ``ppermute``.

``ring_attention_shard`` is the per-rank body; ``ring_attention`` runs
plain attention when there is no ``seq`` group larger than one, as the
JAX package does with no ``seq`` mesh axis.
"""

import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.ops.attention import reference_attention

_NEG_INF = -1e30

__all__ = ["ring_attention", "ring_attention_shard"]


def _exchange(t: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``t`` to group rank ``to`` and receive its like from ``frm``."""
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """K and V (one buffer) to the next rank of ``group``, from the one
    before; the gradients go the other way."""

    @staticmethod
    def forward(ctx, k, v, group):
        n, my = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.shape = group, k.shape
        flat = torch.cat([k.reshape(-1), v.reshape(-1)])
        got = _exchange(flat, group, (my + 1) % n, (my - 1) % n)
        k2, v2 = got.split(k.numel())
        return k2.view(k.shape), v2.view(v.shape)

    @staticmethod
    def backward(ctx, gk, gv):
        group = ctx.group
        n, my = dist.get_world_size(group), dist.get_rank(group)
        flat = torch.cat([gk.reshape(-1), gv.reshape(-1)])
        got = _exchange(flat, group, (my - 1) % n, (my + 1) % n)
        a, b = got.split(gk.numel())
        return a.view(ctx.shape), b.view(ctx.shape), None


def ring_attention_shard(q, k, v, causal: bool = True, group: Any = None):
    """Per-rank ring attention body. q, k, v: this rank's blocks
    [B, S_local, H, D] of a sequence laid out over ``group`` in rank
    order (the default group when None). Exact (online softmax): full
    attention over the gathered sequence, within fp32 rounding."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    b, s_loc, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    m = torch.full((b, h, s_loc), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    rows = torch.arange(s_loc, device=q.device)[:, None]
    cols = torch.arange(s_loc, device=q.device)[None, :]
    k_cur, v_cur = k, v
    for step in range(n):
        # After `step` rotations this rank holds the block of rank
        # (my - step) mod n.
        src = (my - step) % n
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, k_cur.float()) * scale
        if causal:
            mask = (my * s_loc + rows) >= (src * s_loc + cols)
            logits = torch.where(mask, logits, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        if causal:
            # A fully masked block contributes nothing even when m_new is
            # itself _NEG_INF (exp(0) = 1 otherwise).
            p = torch.where(logits <= _NEG_INF / 2, 0.0, p)
        corr = torch.exp(m - m_new)  # [b, h, s]
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v_cur.float())
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
        if step != n - 1:
            k_cur, v_cur = _Rotate.apply(k_cur, v_cur, group)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / l_safe.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_attention(q, k, v, causal: bool = True,
                   group: Optional[Any] = None):
    """Sequence-parallel attention over ``group`` (the model's ``seq``
    group); plain attention when there is none or it has one rank."""
    if group is None or dist.get_world_size(group) <= 1:
        return reference_attention(q, k, v, causal=causal)
    return ring_attention_shard(q, k, v, causal=causal, group=group)
