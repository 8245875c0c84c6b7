"""The collectives of a tensor-parallel block (Megatron's ``f`` and ``g``)
and the cross entropy over logits sharded along the vocab.

Under ``ParallelSpec(tensor=T)`` a block's column-parallel ``Dense``
layers (``qkv``, ``up``; LLaMA's ``q/k/v_proj``, ``gate/up_proj``) hold
their output columns' shard, and the row-parallel ones (``proj``,
``down``; ``o_proj``, ``down_proj``) their input rows'. The activations
between them are this rank's heads and ``mlp`` columns; ``enter`` marks
the replicated input of the column-parallel layers (its gradient is
summed over the tensor group), ``reduce`` sums the row-parallel
products' partial outputs. With no group both are the identity.

``vocab_parallel_lse`` / ``vocab_parallel_target`` compute the
logsumexp and the target logit of logits whose vocab axis is sharded
over the group (LLaMA's untied head): a max and a sum of exponentials
all-reduced, the same operations ``torch.logsumexp`` runs on the whole
vocab.
"""

from typing import Any

import torch
import torch.distributed as dist


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return x if group is None else _Enter.apply(x, group)


def reduce(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum over ``group`` forward; identity backward."""
    return x if group is None else _Reduce.apply(x, group)


class _LSE(torch.autograd.Function):
    """logsumexp over the last axis, sharded over ``group``: ATen's
    ``logsumexp`` (max, exp of the difference, sum, log, plus the max),
    with the max and the sum all-reduced; its backward is ATen's,
    ``g * exp(x - lse)``, on the local shard."""

    @staticmethod
    def forward(ctx, x, group):
        m = x.amax(-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        m.masked_fill_(m.abs() == float("inf"), 0)
        s = (x - m).exp_().sum(-1)
        dist.all_reduce(s, group=group)
        lse = s.log_().add_(m.squeeze(-1))
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g.unsqueeze(-1) * (x - lse.unsqueeze(-1)).exp(), None


class _Target(torch.autograd.Function):
    """``x[..., t]`` of logits sharded along the vocab: each rank gathers
    the targets in its range ``[lo, lo + width)``, zero elsewhere, and
    the sum over ``group`` is the target logit; backward scatters the
    gradient into the local range, as ``gather``'s does."""

    @staticmethod
    def forward(ctx, x, targets, lo, group):
        width = x.shape[-1]
        local = targets - lo
        mine = (local >= 0) & (local < width)
        idx = torch.where(mine, local, torch.zeros_like(local))
        out = torch.gather(x, -1, idx[..., None])[..., 0]
        out = torch.where(mine, out, torch.zeros_like(out))
        dist.all_reduce(out, group=group)
        ctx.save_for_backward(idx, mine)
        ctx.shape = x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        idx, mine = ctx.saved_tensors
        g = torch.where(mine, g, torch.zeros_like(g))
        out = g.new_zeros(ctx.shape).scatter_add_(-1, idx[..., None],
                                                  g[..., None])
        return out, None, None, None


def vocab_parallel_lse(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _LSE.apply(x, group)


def vocab_parallel_target(x: torch.Tensor, targets: torch.Tensor, lo: int,
                          group: Any) -> torch.Tensor:
    return _Target.apply(x, targets, lo, group)
