"""Pipeline parallelism — counterpart of ``dlrover_tpu/accel/pipeline.py``.

Two schedules, as in the JAX package, over a bank of stage chunks that
the module owns:

- :class:`Pipeline` — GPipe: ``P`` stages of ``L/P`` blocks
  (``stages.<p>.blocks.<j>``), ``M + P - 1`` ticks;
- :class:`CircularPipeline` — the interleaved schedule: a ``[P, C]``
  bank of ``L/(P*C)``-block chunks (``bank.<p>.<c>.blocks.<k>``); bank
  row ``p``, column ``c`` holds logical chunk ``c*P + p``, so a
  microbatch makes ``C`` passes around the ring, and ``C*M + P - 1``
  ticks. Chunk ``(c, p)`` of microbatch ``m`` runs at tick
  ``c*M + p + m``; the ring-wrap edge ``(c, P-1) -> (c+1, 0)`` is
  ``D = M - P + 1`` ticks long, so the schedule needs ``M >= P``.

Both carry the auxiliary scalar of an MoE stage beside the activations,
with JAX's normalisation: each microbatch's aux is the sum of its
chunks' means over their own layers, computed on that microbatch
alone, and the schedule returns ``mean(aux_outs) / (P*C)`` (``C = 1``
for GPipe).

**One process.** JAX runs every stage at every tick on a ``[P, ...]``
carry and rolls it; slots that hold no microbatch compute garbage that
never reaches an output. Here the schedule is a loop over the ticks
that runs only the (stage, tick) slots that hold a microbatch, so the
work is ``C*M`` chunk applications, and the values are the same: each
chunk sees one microbatch, as in JAX. The whole step is one autograd
graph; the backward is autograd's. Both runtimes share that loop
(``_Schedule._loop``); they differ only in the hand-off at the end of a
tick: in-process on one process, P2P between pipe ranks.

**Pipe ranks.** On a mesh with a ``pipe`` axis of size ``R > 1``
(``accel.accelerate``) rank ``r`` owns stages (bank rows)
``[r*P/R, (r+1)*P/R)`` with all their chunks; the others' modules are
gone from it. Every rank runs the same tick loop (after one
all-reduce on the default group, which NCCL needs before a batch of
P2P operations that not every rank posts); within a rank the
activations pass from stage to stage in the graph, and at the end of a
tick each rank sends its last stage's output to the next rank (the
wrap from the last rank to the first, for the circular schedule) and
receives its own input for a later tick, all in one
``batch_isend_irecv``. A received activation is a leaf. The backward
runs the ticks in reverse, explicitly: at each tick a rank
back-propagates the segment whose output it sent at that tick (its
gradient received earlier from the consumer, or, on the last rank, the
head's) with ``torch.autograd.backward``, then sends its input leaf's
gradient to the producer in the tick's one batch of sends and
receives. Every rank posts the same matching operations at the same
tick, so no order of autograd's can deadlock the ranks. The first rank
ends with the embedding's backward from the gradient of its input;
the last rank's output (and aux) are leaves the head reads, so the
loss's own ``backward`` stops there. ``ticks`` counts the ticks run.
"""

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn


def gpipe_ticks(num_microbatches: int, num_stages: int) -> int:
    return num_microbatches + num_stages - 1


def circular_ticks(num_microbatches: int, num_stages: int,
                   num_repeats: int) -> int:
    return num_repeats * num_microbatches + num_stages - 1


def schedule_cost(num_microbatches: int, num_stages: int,
                  num_repeats: int = 1) -> float:
    """Wall-clock of one pipeline pass in units of one *full forward*
    (all layers, one microbatch): ticks x per-tick work. Lower is
    better; the ideal (bubble-free) value is ``M / P``."""
    if num_repeats <= 1:
        return gpipe_ticks(num_microbatches, num_stages) / num_stages
    return circular_ticks(num_microbatches, num_stages, num_repeats) / (
        num_repeats * num_stages
    )


class Stage(nn.Module):
    """One chunk: its ``blocks`` in order through the model's remat
    (``models/remat.Remat``; the blocks' positions for "offload" start
    at ``first_layer``, the logical index of the chunk's first block).
    Returns ``(x, aux)``: the mean of the blocks' auxiliary losses (MoE
    blocks), or None."""

    def __init__(self, blocks: Sequence[nn.Module], remat,
                 first_layer: int):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.remat = remat
        self.first_layer = first_layer

    def forward(self, x):
        x, auxes = self.remat.run(self.blocks, x, offset=self.first_layer)
        return x, (torch.stack(auxes).mean() if auxes else None)


class _Elsewhere(nn.Module):
    """A stage (or bank row) another pipe rank owns."""


class PipeRanks(NamedTuple):
    """The ``pipe`` mesh axis as a schedule sees it: this rank's
    coordinate along it, the global ranks of every coordinate of this
    rank's line of the mesh (its data coordinate's), and on the line's
    first and last ranks the process group of the two (a tied head's
    gradient is summed over it; None elsewhere)."""

    rank: int
    peers: Tuple[int, ...]
    ends: Any = None

    @property
    def size(self) -> int:
        return len(self.peers)


class _Record:
    """What the pipe-rank forward keeps for its backward."""

    def __init__(self):
        self.sent: Dict[tuple, tuple] = {}      # (m, c) -> (x, aux) sent
        self.received: Dict[tuple, tuple] = {}  # (m, c) -> leaves read
        self.grads: Dict[tuple, tuple] = {}     # (m, c) -> grads received
        self.done: List[tuple] = []             # last rank: outputs by m
        self.x = self.x_leaf = None             # first rank: the input
        self.y_leaf = self.aux_leaf = None      # last rank: the output
        self.mb = 0


class _Schedule(nn.Module):
    """The tick loop both schedules share (GPipe is ``C = 1``)."""

    def __init__(self, num_stages: int, num_repeats: int,
                 num_microbatches: int, has_aux: bool):
        super().__init__()
        self.num_stages = num_stages
        self.num_repeats = num_repeats
        self.num_microbatches = num_microbatches or num_stages
        self.has_aux = has_aux
        #: Set by ``accel.accelerate`` on a mesh with a pipe axis.
        self.ranks: Optional[PipeRanks] = None
        #: Ticks run, counted as the loop runs them.
        self.ticks = 0
        self._record: Optional[_Record] = None
        self._joined = False

    def chunk(self, p: int, c: int) -> Stage:
        raise NotImplementedError

    def chunks_in_order(self) -> List[Tuple[int, int]]:
        """The bank's ``(p, c)`` in logical order (chunk ``c*P + p``)."""
        return [(j % self.num_stages, j // self.num_stages)
                for j in range(self.num_stages * self.num_repeats)]

    def layers(self) -> List[nn.Module]:
        """The blocks this module holds, in logical order."""
        return [b for p, c in self.chunks_in_order() if self.owns(p)
                for b in self.chunk(p, c).blocks]

    def owns(self, p: int) -> bool:
        lo, hi = self.rows()
        return lo <= p < hi

    def rows(self) -> Tuple[int, int]:
        """The stages (bank rows) this rank runs."""
        if self.ranks is None:
            return 0, self.num_stages
        k = self.num_stages // self.ranks.size
        return self.ranks.rank * k, (self.ranks.rank + 1) * k

    @property
    def first(self) -> bool:
        """Whether this rank feeds the microbatches (embeds the batch)."""
        return self.ranks is None or self.ranks.rank == 0

    @property
    def last(self) -> bool:
        """Whether this rank collects the outputs (runs the head)."""
        return self.ranks is None or self.ranks.rank == self.ranks.size - 1

    @property
    def distributed(self) -> bool:
        return self.ranks is not None and self.ranks.size > 1

    def place(self, ranks: PipeRanks):
        """Keep only the stages ``ranks`` gives this rank."""
        self.ranks = ranks
        lo, hi = self.rows()
        for p in range(self.num_stages):
            if not lo <= p < hi:
                self._drop(p)

    def _drop(self, p: int):
        raise NotImplementedError

    def _slot(self, t: int, p: int) -> Optional[Tuple[int, int]]:
        """(microbatch, pass) at stage ``p`` on tick ``t``, or None."""
        rel = t - p
        if 0 <= rel < self.num_repeats * self.num_microbatches:
            return rel % self.num_microbatches, rel // self.num_microbatches
        return None

    def _run_chunk(self, p: int, c: int, inp):
        x, aux = inp
        y, a = self.chunk(p, c)(x)
        if a is not None:
            aux = a if aux is None else aux + a
        return y, aux

    def _total_aux(self, auxes):
        return torch.stack(auxes).mean() / (self.num_stages
                                            * self.num_repeats)

    def forward(self, x: torch.Tensor):
        """``x`` [B, ...] -> ``(y [B, ...], aux or None)``. On pipe ranks
        only the first passes the batch; the others pass a tensor on the
        ``meta`` device of its shape and dtype, and only the last gets
        the result (None elsewhere)."""
        m = self.num_microbatches
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        if self.distributed:
            return self._ranked(x, b // m)
        return self._local(x, b // m)

    def _loop(self, xs, hand_off):
        """The tick loop over this rank's stages (all of them on one
        process), shared by both runtimes. Stage ``p`` reads stage
        ``p-1``'s output of the tick before, the first stage of the first
        pass a microbatch of ``xs``, and the first stage of this rank
        otherwise what ``hand_off`` put in ``inputs``. At the end of each
        tick ``hand_off(t, slot, out, inputs)`` gets the tick, the
        (microbatch, pass) and output of this rank's last stage (None
        when it had no slot or made a final output) and fills ``inputs``
        for later ticks.
        Returns the final outputs by microbatch (None off the last
        rank)."""
        p_, c_, m_ = self.num_stages, self.num_repeats, self.num_microbatches
        lo, hi = self.rows()
        inputs: Dict[tuple, tuple] = {}
        carry: Dict[int, tuple] = {}
        outs: List[Optional[tuple]] = [None] * m_
        for t in range(circular_ticks(m_, p_, c_)):
            new = {}
            for p in range(lo, hi):
                slot = self._slot(t, p)
                if slot is None:
                    continue
                mi, c = slot
                if p > lo:
                    inp = carry[p - 1]
                elif p == 0 and c == 0:
                    inp = (xs[mi], None)
                else:
                    inp = inputs.pop((mi, c))
                new[p] = self._run_chunk(p, c, inp)
            slot = self._slot(t, hi - 1)
            out = None
            if slot is not None:
                mi, c = slot
                out = new[hi - 1]
                if self.last and c == c_ - 1:
                    outs[mi], out = out, None
            hand_off(t, slot, out, inputs)
            carry = new
            self.ticks += 1
        return outs

    # ------------------------------------------------------ one process

    def _local(self, x, mb):
        def wrap(t, slot, out, inputs):
            # The ring wrap: the last stage's output is the first
            # stage's input for the microbatch's next pass.
            if out is not None:
                inputs[(slot[0], slot[1] + 1)] = out

        outs = self._loop(x.split(mb), wrap)
        y = torch.cat([o[0] for o in outs])
        if not self.has_aux:
            return y, None
        return y, self._total_aux([o[1] for o in outs])

    # ------------------------------------------------------ pipe ranks

    def _peer(self, coord: int) -> int:
        return self.ranks.peers[coord % self.ranks.size]

    def _sends(self, tensors, coord, ops):
        for tag, t in enumerate(tensors):
            ops.append(dist.P2POp(dist.isend, t.detach().reshape(-1)
                                  .contiguous(), self._peer(coord), tag=tag))

    def _recvs(self, shapes, coord, ops):
        bufs = []
        for tag, (shape, dtype) in enumerate(shapes):
            buf = torch.empty(shape, dtype=dtype, device=self._device)
            ops.append(dist.P2POp(dist.irecv, buf.view(-1),
                                  self._peer(coord), tag=tag))
            bufs.append(buf)
        return bufs

    @staticmethod
    def _exchange(ops):
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def _carry_shapes(self):
        shapes = [(self._mb_shape, self._dtype)]
        if self.has_aux:
            shapes.append(((), torch.float32))
        return shapes

    def _join(self):
        """One collective on the default group, on every rank, before the
        first ``batch_isend_irecv``: under NCCL a batch that is the
        group's first collective must be posted by every rank of the
        group, and the first tick's sends involve only some of them."""
        if not self._joined:
            dist.all_reduce(torch.zeros(1, device=self._device))
            self._joined = True

    def _ranked(self, x, mb):
        p_, c_ = self.num_stages, self.num_repeats
        r = self.ranks.rank
        lo = self.rows()[0]
        grad = torch.is_grad_enabled()
        self._device = next(self.parameters()).device
        self._mb_shape = (mb,) + tuple(x.shape[1:])
        self._dtype = x.dtype
        self._join()
        rec = _Record() if grad else None
        self._record = rec
        xs = None
        if self.first:
            leaf = x.detach().requires_grad_(grad and x.requires_grad)
            xs = leaf.split(mb)
            if rec is not None:
                rec.x, rec.x_leaf = x, leaf

        def exchange(t, slot, out, inputs):
            ops: list = []
            if out is not None:
                self._sends([v for v in out if v is not None], r + 1, ops)
                if rec is not None:
                    rec.sent[slot] = out
            # This rank's first stage reads, at a later tick, what the
            # stage before it makes now (the last stage's wrap, for the
            # first rank).
            recv_key = None
            if r > 0:
                recv_key = self._slot(t, lo - 1)
            else:
                slot = self._slot(t, p_ - 1)
                if slot is not None and slot[1] < c_ - 1:
                    recv_key = (slot[0], slot[1] + 1)
            bufs = (self._recvs(self._carry_shapes(), r - 1, ops)
                    if recv_key is not None else None)
            self._exchange(ops)
            if bufs is not None:
                leaves = [b.requires_grad_(grad) for b in bufs]
                aux = leaves[1] if self.has_aux else None
                inputs[recv_key] = (leaves[0], aux)
                if rec is not None:
                    rec.received[recv_key] = tuple(leaves)

        outs = self._loop(xs, exchange)
        if not self.last:
            return None
        y = torch.cat([o[0].detach() for o in outs]).requires_grad_(grad)
        aux = None
        if self.has_aux:
            aux_leaf = torch.stack([o[1].detach() for o in outs]
                                   ).requires_grad_(grad)
            aux = aux_leaf.mean() / (p_ * c_)
        if rec is not None:
            rec.done, rec.y_leaf, rec.mb = outs, y, mb
            rec.aux_leaf = aux_leaf if self.has_aux else None
        return y, aux

    def backward(self):
        """The pipe-rank forward's backward, tick by tick in reverse (see
        the module's docstring). The last rank calls it after the loss's
        own ``backward``; every rank calls it once a forward."""
        rec, self._record = self._record, None
        if rec is None:
            raise RuntimeError("no pipelined forward to differentiate")
        p_, c_, m_ = self.num_stages, self.num_repeats, self.num_microbatches
        r, n = self.ranks.rank, self.ranks.size
        lo, hi = self.rows()
        k = hi - lo
        for t in reversed(range(circular_ticks(m_, p_, c_))):
            ops: list = []
            slot = self._slot(t, hi - 1)
            if slot is not None:
                mi, c = slot
                if self.last and c == c_ - 1:
                    outs = rec.done[mi]
                    grads = [_grad_of(rec.y_leaf, rec.mb * mi, rec.mb)]
                    if self.has_aux:
                        grads.append(_grad_of(rec.aux_leaf, mi, 1)[0])
                else:
                    outs = rec.sent.pop((mi, c))
                    grads = rec.grads.pop((mi, c))
                pairs = [(o, g) for o, g in zip(outs, grads)
                         if o is not None and o.requires_grad]
                if pairs:
                    torch.autograd.backward([o for o, _ in pairs],
                                            [g for _, g in pairs])
                leaves = rec.received.pop((mi, c), None)
                if leaves is not None:
                    self._sends([_grad_of(v) for v in leaves], r - 1, ops)
            # The consumer of this rank's output back-propagates it now:
            # the next rank's segment, or the first rank's next pass.
            slot = self._slot(t, hi - 1 + k) if r < n - 1 else None
            key = slot
            if r == n - 1:
                slot = self._slot(t, k - 1)
                key = (slot[0], slot[1] - 1) if slot and slot[1] > 0 else None
            bufs = (self._recvs(self._carry_shapes(), r + 1, ops)
                    if key is not None else None)
            self._exchange(ops)
            if bufs is not None:
                rec.grads[key] = tuple(bufs)
        if rec.x_leaf is not None and rec.x.requires_grad:
            torch.autograd.backward([rec.x], [_grad_of(rec.x_leaf)])


def _grad_of(t: torch.Tensor, start: int = 0, length: int = 0):
    """The gradient a leaf gathered (zeros where nothing reached it), or
    its rows ``[start, start + length)``."""
    g = t.grad if t.grad is not None else torch.zeros_like(t)
    return g.narrow(0, start, length) if length else g


class Pipeline(_Schedule):
    """GPipe over ``stages``: ``P`` ``Stage`` chunks of ``L/P`` blocks,
    stage ``p`` holding layers ``[p*L/P, (p+1)*L/P)``."""

    def __init__(self, stages: Sequence[Stage], num_microbatches: int = 0,
                 has_aux: bool = False):
        super().__init__(len(stages), 1, num_microbatches, has_aux)
        self.stages = nn.ModuleList(stages)

    def chunk(self, p, c):
        return self.stages[p]

    def _drop(self, p):
        self.stages[p] = _Elsewhere()


class CircularPipeline(_Schedule):
    """The circular schedule over ``bank[p][c]``, a ``[P, C]`` grid of
    ``Stage`` chunks of ``L/(P*C)`` blocks, ``bank[p][c]`` holding
    logical chunk ``c*P + p``. Needs ``M >= P`` (JAX's error)."""

    def __init__(self, bank: Sequence[Sequence[Stage]],
                 num_microbatches: int = 0, has_aux: bool = False):
        super().__init__(len(bank), len(bank[0]), num_microbatches, has_aux)
        if self.num_microbatches < self.num_stages:
            raise ValueError(
                f"circular schedule needs microbatches >= stages "
                f"(got M={self.num_microbatches} < P={self.num_stages})"
            )
        self.bank = nn.ModuleList(nn.ModuleList(row) for row in bank)

    def chunk(self, p, c):
        return self.bank[p][c]

    def _drop(self, p):
        self.bank[p] = _Elsewhere()


def build(cfg, make_block, remat):
    """The schedule ``cfg`` configures (``pipeline_stages`` > 1): GPipe,
    or circular with ``pipeline_repeats`` > 1, its blocks from
    ``make_block()`` in logical order."""
    p_ = cfg.pipeline_stages
    c_ = max(cfg.pipeline_repeats, 1)
    per = cfg.num_layers // (p_ * c_)
    has_aux = cfg.num_experts > 0

    def chunk(j):
        return Stage([make_block() for _ in range(per)], remat, j * per)

    if c_ == 1:
        return Pipeline([chunk(p) for p in range(p_)],
                        cfg.pipeline_microbatches, has_aux)
    return CircularPipeline(
        [[chunk(c * p_ + p) for c in range(c_)] for p in range(p_)],
        cfg.pipeline_microbatches, has_aux)


def layer_names(cfg, stack: str) -> List[str]:
    """Each logical layer's module path in a model of ``cfg``: under
    ``stack`` (``blocks`` / ``layers``) without stages, in the schedule's
    bank with them."""
    if cfg.pipeline_stages <= 1:
        return [f"{stack}.{i}" for i in range(cfg.num_layers)]
    p_ = cfg.pipeline_stages
    c_ = max(cfg.pipeline_repeats, 1)
    per = cfg.num_layers // (p_ * c_)
    out = []
    for i in range(cfg.num_layers):
        j, k = divmod(i, per)
        p, c = j % p_, j // p_
        out.append(f"pipeline.stages.{p}.blocks.{k}" if c_ == 1
                   else f"pipeline.bank.{p}.{c}.blocks.{k}")
    return out
