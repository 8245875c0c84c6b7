"""Deferred (lag-1) metric readback for the asynchronous step loop.

Counterpart of ``dlrover_tpu/train/metrics.py``. CUDA launches return
before the card finishes them, so reading the loss every step with
``float(loss)`` syncs the host with the card each step. The lag-1
protocol keeps the queue full: the loop pushes step N's device metrics
and receives step N-1's values as host floats, which blocks only until
N-1 is done while N already runs.
"""

from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["DeferredMetrics", "batch_token_count"]


class DeferredMetrics:
    """One-slot lag-1 buffer of device metrics.

    ``push(step, metrics)`` stores this step's (device-resident) metrics
    and returns the previous push as ``(step, {name: float})``.
    ``flush()`` reads whatever is pending.
    """

    def __init__(self):
        self._pending: Optional[Tuple[int, Dict[str, Any]]] = None
        self._event: Optional[torch.cuda.Event] = None

    def push(self, step: int,
             metrics: Dict[str, Any]) -> Optional[Tuple[int, Dict]]:
        prev = self.flush()
        self._pending = (int(step), dict(metrics))
        self._event = None
        cuda = [v for v in metrics.values()
                if isinstance(v, torch.Tensor) and v.is_cuda]
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda[0].device))
        return prev

    def fence(self):
        """Block until the pending step's metrics are computed, without
        consuming them (separates the device wait from the readback)."""
        if self._event is not None:
            self._event.synchronize()

    def flush(self) -> Optional[Tuple[int, Dict]]:
        if self._pending is None:
            return None
        step, metrics = self._pending
        self._pending = None
        self._event = None
        host: Dict[str, Any] = {}
        for name, value in metrics.items():
            try:
                host[name] = float(value)
            except (TypeError, ValueError, RuntimeError):
                host[name] = value  # non-scalar: hand back as-is
        return step, host

    @property
    def pending_step(self) -> Optional[int]:
        return self._pending[0] if self._pending is not None else None


def batch_token_count(batch: Any) -> int:
    """Total elements across a batch (tensor, array, or a list, tuple or
    dict of them) — the tokens/s basis."""
    if isinstance(batch, dict):
        return sum(batch_token_count(v) for v in batch.values())
    if isinstance(batch, (list, tuple)):
        return sum(batch_token_count(v) for v in batch)
    shape = getattr(batch, "shape", None)
    if shape is None:
        return 0
    n = 1
    for dim in shape:
        n *= int(dim)
    return n
