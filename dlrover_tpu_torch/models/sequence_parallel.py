"""What a model does on a ``seq`` mesh axis (``ParallelSpec(seq=N)``).

A seq rank r of N holds the tokens ``[r*S/N, (r+1)*S/N)`` of each row:
the model takes every row's whole sequence (every process holds the
global batch) and keeps its shard (``shard_tokens``); its logits are a
``DTensor`` sharded along the sequence (``Shard(1)``, ``shard_logits``),
from which ``loss_fn`` takes this rank's targets: the last position of
shard r predicts the first token of shard r + 1, and only the last
rank drops its last position. The rank's share of the loss (its sum
over the global ``B * (S - 1)``) is summed over the group forward, and
each rank differentiates its own share (``tensor_parallel.reduce``);
the train step sums the gradients of the parameters the group
replicates.

GPT's position table is sharded over ``seq`` as JAX annotates it
(``("seq", "embed")``): ``gather_rows`` puts the table together for the
forward, and its backward hands each rank the summed gradient of its
own rows. Attention crosses the shards through ring or Ulysses
attention over the group (``ops/ring_attention.py``, ``ops/ulysses.py``).
"""

from typing import Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.models import tensor_parallel as tp


def shard_tokens(tokens: torch.Tensor, seq_mesh) -> Tuple[torch.Tensor, int]:
    """This rank's shard of every row of ``tokens`` [B, S], and the global
    position of its first token (the tokens and 0 without a mesh)."""
    if seq_mesh is None:
        return tokens, 0
    n, r = seq_mesh.size(), seq_mesh.get_local_rank()
    total = tokens.shape[1]
    if total % n:
        raise ValueError(f"a sequence of {total} tokens does not split "
                         f"over {n} seq ranks")
    s = total // n
    return tokens[:, r * s:(r + 1) * s], r * s


def shard_logits(logits: torch.Tensor, seq_mesh):
    """This rank's logits [B, S/N, V] as the sequence-sharded DTensor of
    the global [B, S, V] (the tensor itself without a mesh)."""
    if seq_mesh is None:
        return logits
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(logits, seq_mesh, [Shard(1)], run_check=False)


class _GatherRows(torch.autograd.Function):
    """The whole table from every rank's rows (all-gathered over
    ``group``, in rank order); each rank uses its own positions of it,
    so the gradient is summed over the group and each rank keeps its
    rows."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), \
            x.shape[0]
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows].contiguous(), None


def gather_rows(table: torch.Tensor, seq_mesh) -> torch.Tensor:
    """A seq-sharded parameter (a DTensor, ``Shard(0)``) whole, for the
    forward; the parameter itself without a mesh."""
    if seq_mesh is None:
        return table
    return _GatherRows.apply(table.to_local(), seq_mesh.get_group())


def loss(logits, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy of sequence-sharded logits (``Shard(1)``
    DTensor) against ``tokens`` [B, S], the rows' whole sequences: this
    rank's share summed over the group (the same value on every rank)."""
    mesh = logits.device_mesh
    n, r = mesh.size(), mesh.get_local_rank()
    x = logits.to_local()
    b, s, _ = x.shape
    total = s * n
    targets = tokens[:, r * s + 1:(r + 1) * s + 1].long()
    x = x[:, :targets.shape[1]].float()
    lse = torch.logsumexp(x, dim=-1)
    tgt = torch.gather(x, -1, targets[..., None])[..., 0]
    share = torch.sum(lse - tgt) / (b * (total - 1))
    return tp.reduce(share, mesh.get_group())
