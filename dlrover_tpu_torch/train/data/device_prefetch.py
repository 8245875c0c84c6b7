"""Device-side batch prefetch — keep the card's queue full.

Counterpart of ``dlrover_tpu/train/data/device_prefetch.py``. It wraps a
host batch iterator and keeps ``depth`` batches already on their way to
the device, so the copy of batch N+1 overlaps step N:

- host tensors are pinned and copied with ``non_blocking=True`` on a
  side stream; an event recorded after each copy is what the consumer's
  stream waits on when it takes the batch (a device-side wait: the host
  never blocks), and the batch is recorded as used by that stream so
  the allocator does not hand its memory back early;
- on the CPU the "copy" is plain ``torch.as_tensor`` (no streams);
- ``StopIteration`` is clean: the buffer drains after the source runs
  out, so no prefetched batch is dropped at the tail;
- ``swap(new_batches)`` replaces the source and discards the buffered
  batches (they belong to the old stream); the wrapper is usable again
  even after exhaustion.

A batch is a tensor or numpy array, or a list, tuple or dict of them.
``take`` (a function of the host batch, such as
``AccelerateResult.local_batch``: this rank's rows of a global batch on
a mesh) runs on each batch before its copy, so only those bytes cross
to the device.
"""

import collections
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import logger


def map_batch(fn: Callable, batch):
    """``fn`` over every tensor or array of a batch, keeping its
    structure."""
    if isinstance(batch, dict):
        return {k: map_batch(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(map_batch(fn, v) for v in batch)
    return fn(batch)



def _leaves(batch):
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _leaves(v)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _leaves(v)
    else:
        yield batch


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return torch.as_tensor(x)


def to_device(batch, device: torch.device):
    """Copy a host batch to ``device`` (blocking; the unpipelined path)."""
    return map_batch(lambda x: _as_tensor(x).to(device), batch)


class DevicePrefetchIterator:
    """Wrap a host batch iterator; keep ``depth`` batches in flight to
    ``device`` (the card unless another is named)."""

    def __init__(self, batches: Iterable, device: DeviceLike = None,
                 depth: int = 2, take: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it: Iterator = iter(batches)
        self.depth = depth
        self._take = take
        self._set_device(device)
        self._buf: "collections.deque" = collections.deque()
        self._exhausted = False
        self._swaps = 0
        self._fill()

    def _set_device(self, device: DeviceLike):
        self._device = resolve_device(device)
        self._stream = None
        if self._device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self._device)

    # ------------- internals -------------
    def _put(self, host_batch):
        if self._take is not None:
            host_batch = self._take(host_batch)
        if self._stream is None:
            return to_device(host_batch, self._device), None

        def copy(x):
            t = _as_tensor(x)
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            return t.to(self._device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            out = map_batch(copy, host_batch)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _fill(self):
        """Dispatch copies until ``depth`` batches are in flight."""
        while not self._exhausted and len(self._buf) < self.depth:
            try:
                host = next(self._it)
            except StopIteration:
                self._exhausted = True
                return
            self._buf.append(self._put(host))

    # ------------- iterator protocol -------------
    def __iter__(self) -> "DevicePrefetchIterator":
        return self

    def __next__(self):
        if not self._buf:
            # Source swapped after exhaustion: try to refill first.
            self._fill()
            if not self._buf:
                raise StopIteration
        out, ready = self._buf.popleft()
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for t in _leaves(out):
                t.record_stream(consumer)
        # Refill BEFORE handing the batch back: the next copy rides
        # ahead of the step the caller is about to launch.
        self._fill()
        return out

    # ------------- elastic restart -------------
    def swap(self, batches: Iterable,
             device: Optional[DeviceLike] = None) -> int:
        """Replace the source iterator; returns the number of buffered
        batches discarded. ``device`` optionally re-targets the copies."""
        dropped = len(self._buf)
        self._buf.clear()
        self._it = iter(batches)
        if device is not None:
            self._set_device(device)
        self._exhausted = False
        self._swaps += 1
        if dropped:
            logger.info(
                "device prefetch: source swapped, %s buffered batch(es) "
                "discarded", dropped,
            )
        self._fill()
        return dropped

    # ------------- introspection -------------
    @property
    def exhausted(self) -> bool:
        """True when the source is done AND the buffer is drained."""
        return self._exhausted and not self._buf

    @property
    def swaps(self) -> int:
        return self._swaps
