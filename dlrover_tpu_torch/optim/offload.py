"""Host-offloaded optimizer — the port of ``dlrover_tpu/optim/offload.py``.

The big leaves of the optimizer's state live in host memory between
steps (pinned on the card), so the forward and backward run with none of
them on the device. Each update streams them to the device, runs the
inner optimizer there and streams them back: peak device memory becomes
max(forward/backward without the state, the update's). Which leaves
move is the JAX package's ``_offloadable`` rule on the JAX state's
leaves (``models/convert.train_state_leaves`` lays them out): a tensor
leaf of rank > 0 and at least ``MIN_OFFLOAD_ELEMS`` values. Step counts,
bias moments and the 8-bit Adam's scales stay on the device; its int8
moments move (as JAX's ``offload_shardings`` moves them), and its fused
kernel's table then points at the device copies streamed in for the
update. So the inner optimizer is one that has a JAX state layout:
``adam8bit``, torch Adam/AdamW, and ``bf16_master_weights`` around
them.

On a mesh (``accel/accelerate.py``) the inner optimizer is whatever the
rank steps, and what moves is the state it holds, by the same rule on
the JAX leaf's global shape: under FSDP2 and tensor parallelism its
DTensor moments' local shards, under ZeRO-1 its slices, under
``MeshOptimizer`` and on pipe ranks the 8-bit moments (whole, or the
rank's stages' rows).

A moved tensor keeps its identity: its storage is swapped (``.data``)
between the host copy and a device copy, so the inner optimizer, the
train state and the checkpoint engine hold the same objects throughout.
The copies run on the compute stream, in order with the update, a chunk
of parameters at a time where the inner optimizer updates each
parameter on its own. On the CPU (``device="cpu"``) "host" is the CPU:
the same path copies into separate CPU tensors and pins nothing.
"""

from typing import Dict, List, Sequence, Tuple

import torch

from dlrover_tpu_torch.optim.base import apply_grads, bind
from dlrover_tpu_torch.optim.bf16 import Bf16MasterOptimizer
from dlrover_tpu_torch.utils.profiler import CopyClock

#: JAX's ``_MIN_OFFLOAD_ELEMS``: smaller leaves stay on the device.
MIN_OFFLOAD_ELEMS = 4096
#: Bytes of moved state a chunk of a per-parameter update streams in.
CHUNK_BYTES = 1 << 30


def offloadable(jax_shape: Tuple[int, ...]) -> bool:
    """JAX's ``_offloadable`` on a leaf of that shape."""
    n = 1
    for d in jax_shape:
        n *= d
    return len(jax_shape) > 0 and n >= MIN_OFFLOAD_ELEMS


def _per_parameter(opt) -> bool:
    """Whether ``opt`` updates each parameter on its own (a torch
    optimizer, bare or under ``bf16_master_weights``), so the update can
    go a few parameters at a time; the 8-bit Adam's one launch walks
    every leaf."""
    if isinstance(opt, Bf16MasterOptimizer):
        opt = opt.inner
    return isinstance(opt, torch.optim.Optimizer)


class Offload:
    """``offload(inner)``, unbound; binding it to named parameters gives
    an ``OffloadOptimizer``."""

    takes_named_parameters = True

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, named_parameters) -> "OffloadOptimizer":
        named = list(named_parameters)
        return OffloadOptimizer(bind(self.inner, named), named)


class OffloadOptimizer:
    """A bound optimizer (``inner``) whose offloadable state tensors
    (``moved``) lie in host memory between steps. ``update_and_apply``
    streams them in, updates, and streams them out; an inner optimizer
    that updates each parameter on its own does so ``CHUNK_BYTES`` of
    moved state at a time, so the update holds one chunk on the device
    (the 8-bit Adam's whole state comes in for its one launch).
    ``take_copy_stats`` gives the bytes and, on the card, the device ms
    of the copies, as ``HostPool.take_copy_stats`` does."""

    def __init__(self, inner, named_parameters):
        # models.convert imports the optimizers; import it here.
        from dlrover_tpu_torch.accel import sharding
        from dlrover_tpu_torch.models.convert import (
            opt_state_leaves,
            param_leaves,
        )

        self.inner = inner
        params = dict(named_parameters)
        self.device = sharding.local(next(iter(params.values()))).device
        cuda = self.device.type == "cuda"
        groups = param_leaves(params)
        per_parameter = _per_parameter(inner)
        self.moved: List[torch.Tensor] = []
        self._host: List[torch.Tensor] = []
        owner: Dict[str, List[int]] = {}  # parameter name -> moved indices
        with torch.no_grad():
            for leaf in opt_state_leaves(inner, params, groups):
                if not (leaf.members and offloadable(leaf.shape)):
                    continue
                names = (groups[leaf.param_path].names
                         if per_parameter and leaf.param_path
                         else ("",) * len(leaf.members))
                for name, member in zip(names, leaf.members):
                    # A DTensor's storage is its local shard's.
                    t = sharding.local(member)
                    host = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=cuda)
                    host.copy_(t)
                    t.data = host
                    owner.setdefault(name, []).append(len(self.moved))
                    self.moved.append(t)
                    self._host.append(host)
        self.nbytes = sum(t.numel() * t.element_size() for t in self.moved)
        # (parameter names, indices of their moved tensors) a chunk.
        self._chunks: List[Tuple[set, List[int]]] = []
        if per_parameter:
            names, idx, size = set(), [], 0
            for n in params:
                names.add(n)
                for i in owner.get(n, ()):
                    idx.append(i)
                    t = self.moved[i]
                    size += t.numel() * t.element_size()
                if size >= CHUNK_BYTES:
                    self._chunks.append((names, idx))
                    names, idx, size = set(), [], 0
            if names:
                self._chunks.append((names, idx))
        else:
            self._chunks.append((set(params), list(range(len(self.moved)))))
        self._names = {id(p): n for n, p in params.items()}
        self.clock = CopyClock()

    def _stream(self, way: str, idx: List[int]):
        """The moved tensors ``idx`` to the device ("in") or back to
        their host copies ("out"), on the compute stream."""
        start, end = self.clock.events(self.device)
        if start is not None:
            start.record()
        nbytes = 0
        for i in idx:
            t, host = self.moved[i], self._host[i]
            nbytes += t.numel() * t.element_size()
            if way == "in":
                dev = torch.empty(t.shape, dtype=t.dtype, device=self.device)
                dev.copy_(host, non_blocking=True)
                t.data = dev
            else:
                host.copy_(t.data, non_blocking=True)
                # The device copy is freed here; the compute stream's
                # order keeps its memory until the copy has read it.
                t.data = host
        if end is not None:
            end.record()
        self.clock.add(way, nbytes, start, end)

    def update_and_apply(self, grads: Sequence[torch.Tensor],
                         params: Sequence[torch.Tensor]):
        named = [(self._names[id(p)], g, p) for g, p in zip(grads, params)]
        with torch.no_grad():
            for p in params:
                p.grad = None  # each chunk sets its own
            for names, idx in self._chunks:
                part = [(g, p) for n, g, p in named if n in names]
                self._stream("in", idx)
                if part:
                    apply_grads(self.inner, [p for _, p in part],
                                [g for g, _ in part])
                self._stream("out", idx)

    @property
    def launches_per_step(self) -> int:
        return getattr(self.inner, "launches_per_step", 0)

    def take_copy_stats(self) -> Dict[str, float]:
        """``CopyClock.take``: the bytes and device ms of the copies each
        way since the last call."""
        return self.clock.take()


def offload(inner) -> Offload:
    """Keep ``inner``'s big state leaves in host memory between steps
    (``inner``: an unbound optimizer, such as ``adamw(lr)``,
    ``adam8bit(lr)`` or ``bf16_master_weights(...)``);
    ``auto_accelerate(offload_optimizer=True)`` wraps the optimizer so."""
    return Offload(inner)
