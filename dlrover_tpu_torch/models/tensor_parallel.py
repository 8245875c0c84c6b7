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

A plain module's parameter that the rules put on the tensor axis but
that no ``ParallelLinear`` or ``VocabParallelEmbedding`` takes (a
conv's weight, a bare ``nn.Parameter``) is stored as this rank's shard;
``gather_in_forward`` gathers it whole before its module's forward, so
the module computes on the whole tensor, and its gradient comes back
as the shard's slice.

``vocab_parallel_lse`` / ``vocab_parallel_target`` compute the
logsumexp and the target logit of logits whose vocab axis is sharded
over the group (LLaMA's untied head, GPT's tied one when its vocab
divides): a max and a sum of exponentials all-reduced, the same
operations ``torch.logsumexp`` runs on the whole vocab.

``vocab_parallel_embed`` looks tokens up in an embedding whose rows (the
vocab) are sharded over the group: each rank takes the rows it holds,
zeros for the others, and the sum over the group is the row, exactly
(one value and zeros). ``gather_last`` / ``split_last`` move a tensor
between this rank's slice of its last dim and the whole of it
(Megatron's gather and scatter), for a plain module's tensor-parallel
``nn.Linear`` (``accel/tp_planner.py``) given the other kind of input
than it takes, and for the logits of its vocab-parallel head.
"""

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


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


def _chunk(total: int, n: int, r: int):
    """``(start, width)`` of part ``r`` of ``n`` equal parts of a dim of
    ``total`` (the placement refuses a dim ``n`` does not divide)."""
    width = total // n
    return r * width, width


def _cat(x: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (its part of ``dim``) in rank order along
    ``dim``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    """This rank's part of ``dim`` -> the whole (every rank's in rank
    order); backward: this rank's part of the gradient. Every rank runs
    what follows on the whole tensor alike, so each holds the whole
    gradient and its part is the gradient of its part."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        start, width = _chunk(g.shape[ctx.dim], n, dist.get_rank(ctx.group))
        return g.narrow(ctx.dim, start, width).contiguous(), None, None


class _SplitLast(torch.autograd.Function):
    """A last dim every rank holds whole -> this rank's part; backward:
    every rank's part of the gradient gathered into the whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.total = group, x.shape[-1]
        start, width = _chunk(ctx.total, dist.get_world_size(group),
                              dist.get_rank(group))
        return x.narrow(-1, start, width).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _cat(g, ctx.group, -1), None


class _FirstRank(torch.autograd.Function):
    """``x`` on the group's first rank, zeros on the others; backward:
    the gradient on every rank (each rank's is the same: what reaches a
    row-parallel product through ``reduce``)."""

    @staticmethod
    def forward(ctx, x, first):
        return x.view_as(x) if first else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_last(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The whole last dim from every rank's part (autograd-aware)."""
    return _Gather.apply(x, group, -1)


def split_last(x: torch.Tensor, group: Any) -> torch.Tensor:
    """This rank's part of a last dim every rank holds whole."""
    return _SplitLast.apply(x, group)


def vocab_parallel_embed(weight: torch.Tensor, tokens: torch.Tensor,
                         lo: int, group: Any) -> torch.Tensor:
    """Rows ``tokens`` of an embedding whose rows ``[lo, lo + len(weight))``
    this rank holds (``weight``, local): the rank's rows, zeros for the
    tokens outside them, summed over ``group``. The gradient reaches the
    local rows of the tokens this rank holds only."""
    local = tokens - lo
    mine = (local >= 0) & (local < weight.shape[0])
    rows = torch.nn.functional.embedding(
        torch.where(mine, local, torch.zeros_like(local)), weight)
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return reduce(rows, group)


def embed(embedding: torch.nn.Embedding, tokens: torch.Tensor,
          mesh: Any = None) -> torch.Tensor:
    """``embedding(tokens)``; with ``mesh`` (the tensor axis's 1-D mesh,
    over which the embedding's rows are sharded, a DTensor) its
    vocab-parallel lookup."""
    if mesh is None:
        return embedding(tokens)
    weight = embedding.weight
    lo, _ = _chunk(weight.shape[0], mesh.size(), mesh.get_local_rank())
    return vocab_parallel_embed(weight.to_local(), tokens, lo,
                                mesh.get_group())


def vocab_parallel_lse(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _LSE.apply(x, group)


def vocab_parallel_target(x: torch.Tensor, targets: torch.Tensor, lo: int,
                          group: Any) -> torch.Tensor:
    return _Target.apply(x, targets, lo, group)


class ParallelLinear(nn.Module):
    """A plain module's ``nn.Linear`` over the tensor axis's 1-D ``mesh``
    (``accel.accelerate`` swaps it in, under the layer's own name, with
    the layer's parameters, already DTensors of this rank's shard): a
    ``"col"`` layer's weight (``[out, in]``) and bias hold its rows (this
    rank's out columns), a ``"row"`` layer's weight its in columns, its
    bias replicated. A column layer takes the whole input (its gradient
    summed over the group) and gives its out columns, all of them with
    ``gather`` (a vocab-parallel head's logits); a row layer takes its in
    columns and gives the sum of the ranks' products, the bias in the
    first rank's (so on one rank it is ``nn.Linear``'s product, one
    rounding). Given the other kind of input, a layer gathers or slices
    it (Megatron's gather and scatter)."""

    def __init__(self, linear: nn.Linear, role: str, mesh, gather: bool):
        super().__init__()
        self.role, self.mesh, self.gather = role, mesh, gather
        self.in_features = linear.in_features
        self.weight, self.bias = linear.weight, linear.bias

    def forward(self, x):
        group = self.mesh.get_group()
        weight, bias = self.weight.to_local(), self.bias
        if self.role == "col":
            if bias is not None:
                bias = bias.to_local()
            if x.shape[-1] != self.in_features:
                x = gather_last(x, group)
            y = F.linear(enter(x, group), weight, bias)
            return gather_last(y, group) if self.gather else y
        if x.shape[-1] != weight.shape[-1]:
            x = split_last(x, group)
        if bias is not None:
            bias = _FirstRank.apply(bias, self.mesh.get_local_rank() == 0)
        return reduce(F.linear(x, weight, bias), group)


class VocabParallelEmbedding(nn.Module):
    """A plain module's ``nn.Embedding`` whose rows (the vocab) are
    sharded over the tensor axis's 1-D ``mesh``: its ``weight``, a
    DTensor of this rank's rows, looked up by ``vocab_parallel_embed``."""

    def __init__(self, embedding: nn.Embedding, mesh):
        super().__init__()
        self.mesh, self.weight = mesh, embedding.weight

    def forward(self, tokens):
        return embed(self, tokens, self.mesh)


def gather_in_forward(module: nn.Module, leaves, mesh):
    """Gather the parameters ``leaves`` (``{leaf: dim}``) of ``module``,
    DTensors of this rank's shard along ``dim`` over the tensor axis's
    1-D ``mesh``, whole before its forward: a forward pre-hook sets each
    gathered tensor on the module under the parameter's own name (an
    instance attribute comes before ``nn.Module``'s parameter lookup, so
    the module's own forward reads it), and a forward hook removes them.
    The gather is ``_Gather``: the module computes on the whole tensor
    on every rank alike, and the shard's gradient is its slice of the
    whole one."""
    group = mesh.get_group()

    def gather(mod, args):
        for leaf, dim in leaves.items():
            p = mod._parameters[leaf]
            local = p.to_local() if hasattr(p, "to_local") else p
            mod.__dict__[leaf] = _Gather.apply(local, group, dim)

    def drop(mod, args, out):
        for leaf in leaves:
            mod.__dict__.pop(leaf, None)

    module.register_forward_pre_hook(gather)
    module.register_forward_hook(drop)
