"""Mixture-of-Experts with expert parallelism — counterpart of
``dlrover_tpu/ops/moe.py``.

Routing is the JAX package's, value for value: top-k in fp32, ``argmax``
ties to the lowest expert (as ``jnp.argmax``), positions in an expert's
buffer in token order (a cumsum over the global ``[B*S]`` order), a
token past the capacity dropped for that choice, the kept weights
renormalized over the gates the token selected (``compute_dispatch``).
``expert_capacity`` and ``load_balance_loss`` are JAX's.

**Dispatch and combine by index.** The JAX layer builds dense
``[N, E, C]`` combine / dispatch tensors and contracts them with the
tokens (``nec,nd->ecd``) and the experts' outputs (``nec,ecd->nd``).
``MoEMLP`` computes the same two contractions by index instead: each
buffer slot holds at most one token (``dispatch``: a gather into
``[E, C, d]``), and each token sums at most ``top_k`` weighted slots
(``combine``, in fp32). ``compute_dispatch`` builds the dense pair from
the same routing, for the tests and as the reference.

**Expert parallelism.** ``accel.accelerate`` shards the stacks over the
``expert`` mesh axis (``Axis`` attributes ``expert``, ``data``,
``seq`` of each layer). Tokens are replicated over ``expert``, as JAX's
``batch`` rule names only data and fsdp: every expert rank routes all of
its tokens (the router, sharded along its expert columns, is gathered
whole), computes its ``E/K`` experts' slots and its partial outputs,
which are summed over the expert group in fp32. The dispatch input's
gradient and the combine weights' gradient are summed over the group on
the way back (``tensor_parallel.enter``); the routing path is the same
on every rank, so its gradient is not.

**Global positions.** JAX routes the global batch once: capacity comes
from the global ``N``, and a slot position counts every earlier token of
the flattened ``[B*S]`` order. A rank of a ``data`` / ``seq`` mesh
holds rows ``[d*B, (d+1)*B)`` and positions ``[s*S/n, (s+1)*S/n)``; it
all-gathers each row's per-expert counts of every round over those
groups (one gather a layer, the choices not depending on the counts)
and offsets its tokens' positions by the counts of the tokens before
them. The load-balance loss takes its two means over the global ``N``:
the sums are reduced over the groups before the product.
"""

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.models import tensor_parallel as tp
from dlrover_tpu_torch.models.remat import kept, product

__all__ = ["Axis", "MoEMLP", "Route", "compute_dispatch", "expert_capacity",
           "load_balance_loss", "route"]


class Axis(NamedTuple):
    """One mesh axis as a layer sees it: its process group, this rank's
    index along it and its size."""

    group: Any
    rank: int
    size: int

    @staticmethod
    def of(mesh, name: str) -> "Axis":
        return Axis(mesh.get_group(name), mesh.get_local_rank(name),
                    mesh.size(mesh.mesh_dim_names.index(name)))


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Static per-expert buffer size, rounded up to a multiple of 8 (at
    least 8), as the JAX package sizes it."""
    c = int(math.ceil(capacity_factor * top_k * n_tokens / n_experts))
    return max(8, ((c + 7) // 8) * 8)


def load_balance_loss(gates: torch.Tensor, top1_onehot: torch.Tensor
                      ) -> torch.Tensor:
    """Switch-Transformer auxiliary loss ``E * sum_e(frac_e * prob_e)``
    over the rows of gates [N, E] (fp32) and the first choices'
    one-hots."""
    e = gates.shape[-1]
    return e * torch.sum(top1_onehot.mean(0) * gates.mean(0))


class Route(NamedTuple):
    """Each token's ``top_k`` choices, round by round ([K, N] each):
    the expert, the slot ``expert * capacity + position`` (meaningful
    where ``keep``), whether the position is within capacity, and the
    combine weight (fp32; differentiable in the gates)."""

    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    weight: torch.Tensor


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.int64) -> torch.Tensor:
    """``F.one_hot`` without its range check (a host sync on the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _exclusive_prefix(counts: torch.Tensor, data: Optional[Axis],
                      seq: Optional[Axis]) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """From this rank's per-row counts [K, B, E] (each round's choices of
    each local row): the count of earlier tokens in the global ``[B*S]``
    order choosing each expert, per local row ([K, B, E]: every earlier
    row whole, and the earlier seq shards of the row), and each
    expert's total over the global batch ([K, E])."""
    table = counts[None, None]  # [D, N, K, B, E]
    for axis, dim in ((seq, 1), (data, 0)):
        if axis is None:
            continue
        shape = tuple(table.shape)
        out = torch.empty((axis.size * shape[0],) + shape[1:],
                          dtype=table.dtype, device=table.device)
        dist.all_gather_into_tensor(out, table.contiguous(),
                                    group=axis.group)
        table = out.view((axis.size,) + shape).movedim(0, dim).flatten(
            dim, dim + 1)
    d, n, k, b, e = table.shape
    order = table.permute(2, 0, 3, 1, 4).reshape(k, d * b * n, e)
    before = (order.cumsum(1) - order).view(k, d, b, n, e)
    me_d = data.rank if data is not None else 0
    me_s = seq.rank if seq is not None else 0
    return before[:, me_d, :, me_s], order.sum(1)


def route(gates: torch.Tensor, top_k: int, capacity: int, rows: int = 1,
          data: Optional[Axis] = None, seq: Optional[Axis] = None) -> Route:
    """Top-k assignment of gates [N, E] (fp32; ``rows`` rows of this
    rank's tokens in row-major order) to per-expert buffers of
    ``capacity`` slots, in the JAX package's order over the global batch
    (this rank's rows and sequence shard of it under ``data`` / ``seq``).
    """
    n, e = gates.shape
    remaining = gates
    experts, onehots, gate_vals = [], [], []
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        onehot = _one_hot(idx, e, gates.dtype)
        experts.append(idx)
        onehots.append(onehot)
        gate_vals.append(torch.sum(remaining * onehot, dim=-1))
        remaining = remaining * (1.0 - onehot)
    expert = torch.stack(experts)                       # [K, N]
    hits = _one_hot(expert, e).view(top_k, rows, n // rows, e)
    prefix, total = _exclusive_prefix(hits.sum(2), data, seq)
    # Each token's place among the earlier tokens of its row that chose
    # its expert (the token axis innermost: a fast scan on the card),
    # then the earlier tokens elsewhere.
    by_expert = hits.transpose(2, 3).contiguous()       # [K, B, E, S]
    earlier = by_expert.cumsum(-1) - by_expert
    own = expert.view(top_k, rows, 1, -1)
    in_row = torch.gather(earlier, 2, own).view(top_k, n)
    before = torch.gather(prefix, 2, own[:, :, 0]).view(top_k, n)
    base = torch.zeros(e, dtype=hits.dtype, device=gates.device)
    slots, keeps = [], []
    selected = torch.zeros(n, dtype=gates.dtype, device=gates.device)
    for k in range(top_k):
        pos = in_row[k] + before[k] + base[expert[k]]
        keep = pos < capacity
        slots.append(expert[k] * capacity + pos)
        keeps.append(keep)
        selected = selected + gate_vals[k]
        # Slots kept this round: the first (capacity - base) choosers.
        base = base + torch.minimum(total[k], capacity - base).clamp(min=0)
    denom = torch.where(selected > 0, selected, torch.ones_like(selected))
    weight = torch.stack([g * keep.to(g.dtype) for g, keep in
                          zip(gate_vals, keeps)]) / denom
    return Route(expert, torch.stack(slots), torch.stack(keeps), weight)


def compute_dispatch(gates: torch.Tensor, top_k: int, capacity: int):
    """The JAX package's dense form of ``route`` on one device: (combine
    [N, E, C] fp32, dispatch [N, E, C] bool)."""
    n, e = gates.shape
    r = route(gates, top_k, capacity)
    combine = torch.zeros(n * e * capacity, dtype=gates.dtype,
                          device=gates.device)
    tok = torch.arange(n, device=gates.device).expand(top_k, n)
    flat = tok * (e * capacity) + torch.where(r.keep, r.slot, 0)
    combine.index_put_((flat[r.keep],), r.weight[r.keep])
    combine = combine.view(n, e, capacity)
    return combine, combine > 0


def _scatter_rows(src: torch.Tensor, slot: torch.Tensor, mask: torch.Tensor,
                  slots: int) -> torch.Tensor:
    """Rows ``src`` [K*N, d] to rows ``slot`` [K, N] of a zero
    [slots, d] buffer where ``mask`` (each row hit at most once); the
    others go to a spare row past its end, so no count of the mask
    reaches the host."""
    out = src.new_zeros(slots + 1, src.shape[1])
    out.index_copy_(0, torch.where(mask, slot, slots).reshape(-1), src)
    return out[:slots]


class _Dispatch(torch.autograd.Function):
    """Tokens x [N, d] into ``slots`` buffer rows: row ``slot[k, n]``
    holds token n where ``mask[k, n]`` (each row at most one token),
    zero elsewhere. Backward: each token sums the gradients of its rows
    (fp32, then x's dtype) — the ``nec,nd->ecd`` contraction both
    ways."""

    @staticmethod
    def saved(x, slot, mask, slots):
        return slot, mask

    @staticmethod
    def forward(ctx, x, slot, mask, slots):
        ctx.save_for_backward(slot, mask)
        return _scatter_rows(x.repeat(slot.shape[0], 1), slot, mask, slots)

    @staticmethod
    def backward(ctx, g):
        slot, mask = ctx.saved_tensors
        k, n = slot.shape
        rows = g.index_select(0, slot.reshape(-1)).view(k, n, -1).float()
        gx = (rows * mask[..., None]).sum(0).to(g.dtype)
        return gx, None, None, None


class _Combine(torch.autograd.Function):
    """Each token's weighted sum of its buffer rows, in fp32: token n
    gets ``sum_k w[k, n] * out[slot[k, n]]`` over the choices in
    ``mask`` (``w`` in the experts' dtype, as JAX casts combine) — the
    ``nec,ecd->nd`` contraction."""

    @staticmethod
    def saved(out, w, slot, mask):
        return out, w, slot, mask

    @staticmethod
    def forward(ctx, out, w, slot, mask):
        k, n = slot.shape
        rows = out.index_select(0, slot.reshape(-1)).view(k, n, -1)
        wm = w.float() * mask
        ctx.save_for_backward(out, w, slot, mask)
        return (rows.float() * wm[..., None]).sum(0)

    @staticmethod
    def backward(ctx, g):
        out, w, slot, mask = ctx.saved_tensors
        k, n = slot.shape
        src = (w.float()[..., None] * g[None]).to(out.dtype)
        g_out = _scatter_rows(src.view(k * n, -1), slot, mask, out.shape[0])
        rows = out.index_select(0, slot.reshape(-1)).view(k, n, -1)
        g_w = ((rows.float() * g[None]).sum(-1) * mask).to(w.dtype)
        return g_out, g_w, None, None


class _AllReduce(torch.autograd.Function):
    """The sum over ``group`` both ways: the gradient of a value every
    rank of the group computes from the sum is the sum of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherCols(torch.autograd.Function):
    """The whole router from this rank's expert columns (all-gathered
    over ``group``); its gradient is the same on every rank, and this
    rank's columns of it are its shard's."""

    @staticmethod
    def forward(ctx, x, group, rank):
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.rank, ctx.width = rank, x.shape[1]
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[:, lo:lo + ctx.width].contiguous(), None, None


def _local(p: torch.Tensor) -> torch.Tensor:
    """A DTensor parameter's local shard (differentiably), or ``p``."""
    from torch.distributed.tensor import DTensor

    return p.to_local() if isinstance(p, DTensor) else p


class MoEMLP(nn.Module):
    """Expert FFN: ``[B, S, d] -> ([B, S, d], aux_loss)``, with the JAX
    layer's parameters: ``router [d, E]``, ``w_up [E, d, f]``,
    ``b_up [E, f]``, ``w_down [E, f, d]``, ``b_down [E, d]`` and, for
    ``mlp_type="swiglu"`` (LLaMA / Mixtral experts), ``w_gate [E, d, f]``
    (swiglu experts keep both biases, as JAX's code does). ``gelu``
    experts use the tanh form. ``expert``, ``data`` and ``seq``
    (``Axis``) are set by ``accel.accelerate`` on a mesh."""

    AXES = {"router": ("embed", "expert"),
            "w_up": ("expert", "embed", "mlp"),
            "b_up": ("expert", "mlp"),
            "w_gate": ("expert", "embed", "mlp"),
            "w_down": ("expert", "mlp", "embed"),
            "b_down": ("expert", "embed")}

    def __init__(self, cfg, device, mlp_type: str = "gelu"):
        super().__init__()
        if mlp_type not in ("gelu", "swiglu"):
            raise ValueError(f"unknown mlp_type {mlp_type!r}")
        e, d, f = cfg.num_experts, cfg.d_model, cfg.ff_dim
        self.num_experts, self.top_k = e, cfg.moe_top_k
        self.capacity_factor = cfg.moe_capacity_factor
        self.dtype, self.mlp_type = cfg.dtype, mlp_type
        self.expert: Optional[Axis] = None
        self.data: Optional[Axis] = None
        self.seq: Optional[Axis] = None

        def param(*shape):
            return nn.Parameter(torch.zeros(*shape, dtype=cfg.param_dtype,
                                            device=device))

        self.router = param(d, e)
        self.w_up = param(e, d, f)
        self.b_up = param(e, f)
        if mlp_type == "swiglu":
            self.w_gate = param(e, d, f)
        self.w_down = param(e, f, d)
        self.b_down = param(e, d)

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            for name, p in self.named_parameters(recurse=False):
                if name.startswith("b_"):
                    p.zero_()
                else:
                    p.normal_(0.0, 0.02, generator=generator)

    def _router(self) -> torch.Tensor:
        r = _local(self.router)
        if self.expert is None:
            return r
        return _GatherCols.apply(r, self.expert.group, self.expert.rank)

    def _global_tokens(self, b: int, s: int) -> int:
        rows = b * (self.data.size if self.data is not None else 1)
        return rows * s * (self.seq.size if self.seq is not None else 1)

    def _aux(self, gates, top1, n_global):
        """``load_balance_loss`` over the global batch: the two sums
        reduced over ``seq`` (each rank's share of one sequence) and
        ``data`` (each a whole loss, averaged by the step) first."""
        sums = torch.stack([top1.sum(0), gates.sum(0)])
        if self.seq is not None:
            sums = tp.reduce(sums, self.seq.group)
        if self.data is not None:
            sums = _AllReduce.apply(sums, self.data.group)
        frac, prob = sums / n_global
        return self.num_experts * torch.sum(frac * prob)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, d = x.shape
        n, e, dt = b * s, self.num_experts, self.dtype
        xf = x.reshape(n, d)
        n_global = self._global_tokens(b, s)
        with torch.profiler.record_function("moe/routing"):
            # Routing in fp32: the order of the gates must not depend on
            # bf16 rounding.
            logits = product(xf.float(), self._router().float())
            gates = torch.softmax(logits, dim=-1)
            top1 = _one_hot(torch.argmax(gates, dim=-1), e, gates.dtype)
            aux = self._aux(gates, top1, n_global)
            cap = expert_capacity(n_global, e, self.top_k,
                                  self.capacity_factor)
            r = route(gates, self.top_k, cap, rows=b, data=self.data,
                      seq=self.seq)
        w_up, b_up = _local(self.w_up), _local(self.b_up)
        w_down, b_down = _local(self.w_down), _local(self.b_down)
        local_e = w_up.shape[0]
        lo = self.expert.rank * local_e if self.expert is not None else 0
        group = self.expert.group if self.expert is not None else None
        # This rank's choices: kept, of a positive weight (JAX's
        # dispatch is ``combine > 0``), to one of its experts.
        mask = r.keep & (r.weight > 0) & (r.expert >= lo) & \
            (r.expert < lo + local_e)
        slot = torch.where(mask, r.slot - lo * cap, 0)
        with torch.profiler.record_function("moe/dispatch"):
            expert_in = kept(_Dispatch, tp.enter(xf, group), slot, mask,
                             local_e * cap).view(local_e, cap, d)
        with torch.profiler.record_function("moe/experts"):
            h = product(expert_in, w_up.to(dt)) + b_up.to(dt)[:, None, :]
            if self.mlp_type == "swiglu":
                g = product(expert_in, _local(self.w_gate).to(dt))
                h = F.silu(g) * h
            else:
                h = F.gelu(h, approximate="tanh")
            out_e = product(h, w_down.to(dt)) + b_down.to(dt)[:, None, :]
        with torch.profiler.record_function("moe/combine"):
            w = tp.enter(r.weight.to(dt), group)
            out = kept(_Combine, out_e.view(local_e * cap, d), w, slot, mask)
            out = tp.reduce(out, group).to(dt)
        return out.view(b, s, d), aux
