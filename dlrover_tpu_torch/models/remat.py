"""Activation checkpointing (remat) of a model's blocks — counterpart of
``_remat_policy`` in ``dlrover_tpu/models/gpt.py``, shared by GPT and
LLaMA as there.

With ``cfg.remat`` each block runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: its
forward keeps what the policy names, and the backward recomputes the
rest of the block from its input.

- ``"nothing"``: keeps only the block input (least memory);
- ``"dots"``: keeps the output of every matrix product and recomputes
  the elementwise work, as ``jax.checkpoint_policies.checkpoint_dots``
  does: each ``Dense`` product (``mm``), on the einsum attention
  path the two batched attention products (``bmm``), and in an MoE
  layer the router's logits, the experts' batched products and the
  dispatch and combine gathers (``kept``);
- ``"dots_lite"``: keeps only the tensors a block names ``attn_out`` and
  ``ffn_act`` with ``checkpoint_name``, as
  ``save_only_these_names("attn_out", "ffn_act")`` does;
- ``"offload"``: keeps what ``offload_dot_with_no_batch_dims("device",
  "pinned_host")`` keeps, every ``Dense`` product and the MoE's
  dispatch and combine, in host memory (``HostPool``); the batched
  products (attention's, the experts') are recomputed.

**The mechanism.** No dispatch mode and no selective-checkpoint context:
each checkpointed call of a block owns a ``_Keep``. In the forward, the
models' products go through ``product`` and their named tensors through
``checkpoint_name``, which put what the policy keeps into the call's
``_Keep``; in the recompute the same calls hand it back instead of
computing it. A product's forward is autograd's own ``mm`` / ``bmm``,
so its backward is too (no Python runs in the backward), and the
gradients equal those without remat bit for bit; in the recompute
``_Replay``, an ``autograd.Function``, returns the kept output and saves
the operands that node saved, in its order, for the checkpoint to hand
over. Every elementwise op, cast and bias add runs again. A ``_Keep`` belongs
to one call, so blocks and microbatches never mix.

**Offload.** After a block's forward its products go to a pinned host
slab on a side stream, ordered after the compute stream by an event;
each product's device memory is freed once its copy is done
(``record_stream``). When the backward's recompute reaches block i + 1,
block i's products come back on the side stream, and the compute stream
waits on that copy's event before it first uses them. The slabs are
made on the first step, one a block, and reused. On the CPU (the tests)
the same path copies into plain CPU tensors and takes no CUDA branch.

The flash-attention kernels are ctypes launches inside an
``autograd.Function``; no policy keeps their output, so their forward
runs again in the backward under every policy, as the JAX package
recomputes a ``pallas_call`` (it is not a ``dot_general``): a step
launches the forward kernel twice a layer.
"""

import contextvars
import functools
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.utils.profiler import CopyClock

POLICIES = ("nothing", "dots", "dots_lite", "offload")
_ALIGN = 512  # byte alignment of each product in a host slab

# The _Keep of the checkpointed call running now (None outside one).
_KEEP = contextvars.ContextVar("dlrover_tpu_torch_remat_keep", default=None)


def check_policy(cfg):
    """Raises on a remat policy the port does not know (duck-typed on
    ``remat`` and ``remat_policy``, as the JAX package is)."""
    if cfg.remat and cfg.remat_policy not in POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.mm(b) if a.dim() == 2 else a.bmm(b)


@functools.lru_cache(maxsize=None)
def _saved_operands(batched: bool, a_grad: bool, b_grad: bool):
    """The operands (0: ``a``, 1: ``b``), in order, that autograd's
    ``mm`` / ``bmm`` saves for its backward when those of them that need
    a gradient are ``a_grad`` and ``b_grad``: probed once on tiny CPU
    tensors, since the order is the generated code's."""
    shapes = ((2, 5, 3), (2, 3, 7)) if batched else ((5, 3), (3, 7))
    a = torch.zeros(shapes[0], requires_grad=a_grad)
    b = torch.zeros(shapes[1], requires_grad=b_grad)
    seen = []

    def pack(t):
        seen.append(0 if t.shape == a.shape else 1)
        return t

    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _mm(a, b)
    return tuple(seen)


class _Replay(torch.autograd.Function):
    """A kept product in the recompute: hands back the output the
    forward kept and saves the operands autograd's ``mm`` / ``bmm`` saved
    there, in the same order, so the forward's own ``MmBackward0`` /
    ``BmmBackward0`` nodes find their saved tensors and compute the
    gradients (bit for bit those without remat)."""

    @staticmethod
    def forward(ctx, a, b, keep):
        out = keep.take()
        order = _saved_operands(a.dim() == 3, *ctx.needs_input_grad[:2])
        ctx.save_for_backward(*((a, b)[i] for i in order))
        return out

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("a remat recompute's graph is not differentiated")


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.mm(b)`` (a ``Dense``: no batch dims) or ``a.bmm(b)`` (batched
    attention): kept for the recompute when the running block's policy
    keeps it (the forward's op is autograd's own; the recompute hands the
    kept output back through ``_Replay``), a plain op otherwise."""
    keep = _KEEP.get()
    if keep is None or not keep.keeps(a.dim() == 3):
        return _mm(a, b)
    if keep.replaying:
        return _Replay.apply(a, b, keep)
    # Probe what the recompute's _Replay saves here, so that the backward
    # runs no probe (the recompute's inputs need the forward's grads).
    _saved_operands(a.dim() == 3, a.requires_grad, b.requires_grad)
    return keep.put(_mm(a, b))


class _KeptReplay(torch.autograd.Function):
    """A kept gathered product (``kept``) in the recompute: hands back the
    forward's output and saves what that function's node saved (its
    ``saved(*args)``), so its backward finds them. ``args`` are the
    function's own tensor inputs, so the output needs a gradient where
    the forward's did."""

    @staticmethod
    def forward(ctx, keep, saved, *args):
        out = keep.take()
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("a remat recompute's graph is not differentiated")


def kept(fn, *args) -> torch.Tensor:
    """``fn.apply(*args)`` for an ``autograd.Function`` that computes a
    contraction by index (the MoE's dispatch and combine, JAX's
    ``nec,nd->ecd`` and ``nec,ecd->nd``: products without batch dims),
    kept as a ``Dense`` product is (under "dots" and "offload"); ``fn``
    names what its forward saves with a static ``saved(*args)``."""
    keep = _KEEP.get()
    if keep is None or not keep.keeps(False):
        return fn.apply(*args)
    if keep.replaying:
        return _KeptReplay.apply(keep, fn.saved(*args), *args)
    return keep.put(fn.apply(*args))


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: under "dots_lite" the forward
    keeps ``x`` (no copy) and the recompute takes it back; the identity
    elsewhere."""
    keep = _KEEP.get()
    if keep is None or keep.policy != "dots_lite":
        return x
    if keep.replaying:
        # What the recompute's ops save depends on which inputs need grad.
        return keep.named.pop(name).requires_grad_(x.requires_grad)
    keep.named[name] = x.detach()
    return x


class _Keep:
    """What one checkpointed call of a block keeps from its forward for
    its recompute: the products, in call order, or the named tensors.
    Under "offload" the products sit in ``pool`` between the two, and
    ``prev`` is the call of the block before (fetched ahead of use)."""

    def __init__(self, policy: str, position: int,
                 pool: Optional["HostPool"] = None,
                 prev: Optional["_Keep"] = None):
        self.policy, self.position = policy, position
        self.pool, self.prev = pool, prev
        self.items: List[torch.Tensor] = []
        self.named: Dict[str, torch.Tensor] = {}
        self.passes = 0
        self.replaying = False
        self.fetched = False
        self.device: Optional[torch.device] = None
        self.ready = None  # the copy the compute stream waits on
        self._next = 0

    def keeps(self, batched: bool) -> bool:
        return self.policy == "dots" or (self.policy == "offload"
                                         and not batched)

    def put(self, out: torch.Tensor) -> torch.Tensor:
        self.items.append(out.detach())
        return out

    def take(self) -> torch.Tensor:
        if self.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(self.ready)
            self.ready = None
        t, self.items[self._next] = self.items[self._next], None
        self._next += 1
        return t

    def begin(self):
        if self.passes > 1:
            raise RuntimeError("a remat block was recomputed twice (a "
                               "second backward through one graph)")
        self.replaying = self.passes == 1
        if self.replaying and self.pool is not None:
            self.pool.fetch(self)
            if self.prev is not None:
                self.pool.fetch(self.prev)

    def end(self):
        if self.replaying:
            # A recompute stops at the block's last saved tensor; what it
            # did not reach is not needed.
            self.items, self.named = [], {}
        elif self.pool is not None and self.items:
            self.pool.offload(self)
        self.passes += 1


def _kept_call(block, keep: _Keep, x):
    keep.begin()
    token = _KEEP.set(keep)
    try:
        return block(x)
    finally:
        _KEEP.reset(token)
        keep.end()


class HostPool:
    """Host memory of "offload": one slab a block position, made at the
    first step (pinned on the card) and reused while its size holds.
    Counts the bytes moved each way and, on the card, times each block's
    copies with events (``clock``, read by ``take_copy_stats``)."""

    def __init__(self):
        self.clock = CopyClock()
        self._slabs: Dict[int, list] = {}  # position -> [buffer, owner]
        self._stream = None

    @property
    def nbytes(self) -> int:
        """Bytes of host memory the pool holds."""
        return sum(buf.numel() for buf, _ in self._slabs.values())

    def _slab(self, keep: _Keep, nbytes: int) -> torch.Tensor:
        slot = self._slabs.get(keep.position)
        if (slot is None or slot[0].numel() < nbytes
                or (slot[1] is not None and slot[1]() is not None)):
            # First use, a larger block, or the slab still holds the
            # products of a call whose backward has not run.
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              pin_memory=keep.device.type == "cuda")
            slot = self._slabs[keep.position] = [buf, None]
        slot[1] = weakref.ref(keep)
        return slot[0]

    def _release(self, keep: _Keep):
        slot = self._slabs.get(keep.position)
        if slot is not None and slot[1] is not None and slot[1]() is keep:
            slot[1] = None

    def _side(self, device: torch.device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        return self._stream

    def offload(self, keep: _Keep):
        """The kept products to a host slab; the device tensors are freed
        when their copies end."""
        items = keep.items
        keep.device = items[0].device
        spans, total = [], 0
        for t in items:
            n = t.numel() * t.element_size()
            spans.append((total, n))
            total += (n + _ALIGN - 1) // _ALIGN * _ALIGN
        slab = self._slab(keep, total)
        host = [slab[o:o + n].view(t.dtype).view(t.shape)
                for t, (o, n) in zip(items, spans)]
        nbytes = sum(n for _, n in spans)
        if keep.device.type == "cuda":
            self._copy_out(items, host, nbytes)
        else:
            for h, t in zip(host, items):
                h.copy_(t)
            self.clock.add("out", nbytes)
        keep.items = host

    def _copy_out(self, items, host, nbytes):
        dev = items[0].device
        stream = self._side(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        start, end = self.clock.events(dev)
        with torch.cuda.stream(stream):
            start.record(stream)
            for h, t in zip(host, items):
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)
            end.record(stream)
        self.clock.add("out", nbytes, start, end)

    def fetch(self, keep: _Keep):
        """Start bringing ``keep``'s products back to the device (once);
        ``keep.take`` makes the compute stream wait for them."""
        if keep.fetched or not keep.items:
            return
        keep.fetched = True
        host = keep.items
        total = sum(h.numel() * h.element_size() for h in host)
        if keep.device.type == "cuda":
            dev = keep.device
            compute = torch.cuda.current_stream(dev)
            out = [torch.empty(h.shape, dtype=h.dtype, device=dev)
                   for h in host]
            stream = self._side(dev)
            # The memory's last users on the compute stream are done.
            stream.wait_stream(compute)
            start, end = self.clock.events(dev)
            with torch.cuda.stream(stream):
                start.record(stream)
                for o, h in zip(out, host):
                    o.copy_(h, non_blocking=True)
                    o.record_stream(stream)
                end.record(stream)
            keep.ready = end
        else:
            out = [h.clone() for h in host]
            start = end = None
        self.clock.add("in", total, start, end)
        keep.items = out
        self._release(keep)

    def take_copy_stats(self) -> Dict[str, float]:
        """``CopyClock.take``: the bytes and device ms of the copies each
        way since the last call."""
        return self.clock.take()


class Remat:
    """A model's remat: runs its blocks under ``cfg``'s policy, and owns
    "offload"'s host pool (``pool``; None under any other policy)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.pool = (HostPool() if cfg.remat and cfg.remat_policy == "offload"
                     else None)

    def run(self, blocks, x, offset: int = 0):
        """``x`` through ``blocks`` in order: ``(x, auxes)``, where
        ``auxes`` are the auxiliary losses of the blocks that return
        ``(x, aux)`` (MoE blocks). Without remat, or when autograd does
        not record the call (there is nothing to keep), each block runs
        as it is. ``offset`` is the logical index of the first block (a
        pipeline chunk's), the position of its host slab under
        "offload"."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        policy, prev, auxes = cfg.remat_policy, None, []
        # No block draws random numbers, so no RNG state is kept for the
        # recompute.
        for i, block in enumerate(blocks):
            if not remat:
                out = block(x)
            elif policy == "nothing":
                out = checkpoint(block, x, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                keep = _Keep(policy, offset + i, self.pool, prev)
                out = checkpoint(_kept_call, block, keep, x,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
                prev = keep
            if isinstance(out, tuple):
                x, aux = out
                auxes.append(aux)
            else:
                x = out
        return x, auxes
