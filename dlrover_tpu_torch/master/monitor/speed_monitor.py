"""Global-step/throughput tracking and hang detection (the port's copy
of ``dlrover_tpu/master/monitor/speed_monitor.py``).

Parity: reference ``master/monitor/speed_monitor.py`` — workers report
(step, timestamp); the monitor derives global throughput, tracks per-worker
step staleness for hang detection, and exposes the sample window to the
auto-scaler.
"""

import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple


class SpeedMonitor:
    def __init__(self, sample_window: int = 600, hang_seconds: float = 1800.0):
        self._global_step = 0
        self._start_step_time: Optional[float] = None
        self._last_step_time: Optional[float] = None
        self._samples: Deque[Tuple[int, float]] = deque(maxlen=4096)
        self._sample_window = sample_window
        self._hang_seconds = hang_seconds
        self._worker_last_report: Dict[int, float] = {}

    @property
    def global_step(self) -> int:
        return self._global_step

    def collect_global_step(self, step: int, timestamp: float, worker_id: int = 0):
        if self._start_step_time is None:
            self._start_step_time = timestamp
        if step > self._global_step:
            self._global_step = step
            self._samples.append((step, timestamp))
        self._last_step_time = timestamp
        self._worker_last_report[worker_id] = time.time()

    def running_speed(self) -> float:
        """Steps per second over the recent sample window."""
        if len(self._samples) < 2:
            return 0.0
        now = self._samples[-1]
        window_start = None
        for step, ts in self._samples:
            if now[1] - ts <= self._sample_window:
                window_start = (step, ts)
                break
        if window_start is None or now[1] == window_start[1]:
            return 0.0
        return (now[0] - window_start[0]) / (now[1] - window_start[1])

    @property
    def hang_seconds(self) -> float:
        return self._hang_seconds

    def reset_worker_reports(self):
        """Re-arm hang detection after a recovery (stale report times
        would otherwise re-fire on every monitor pass)."""
        self._worker_last_report.clear()

    def worker_hang(self, worker_id: Optional[int] = None) -> bool:
        """True when no step progress has been reported for hang_seconds."""
        now = time.time()
        if worker_id is not None:
            last = self._worker_last_report.get(worker_id)
            return last is not None and now - last > self._hang_seconds
        if not self._worker_last_report:
            return False
        return now - max(self._worker_last_report.values()) > self._hang_seconds

    def remove_worker(self, worker_id: int):
        self._worker_last_report.pop(worker_id, None)

    # ------------- master state snapshot/restore -------------
    def checkpoint(self) -> dict:
        return {"global_step": self._global_step}

    def restore(self, state: dict):
        """Reload the global step (throughput samples and per-worker
        report times are intentionally ephemeral: speed re-derives from
        fresh reports and stale report times would trip hang detection
        against the pre-crash clock)."""
        self._global_step = max(
            self._global_step, int(state.get("global_step", 0))
        )
