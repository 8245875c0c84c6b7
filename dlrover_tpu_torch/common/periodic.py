"""Shared periodic background task: daemon thread + Event + one callback
(the port's copy of ``dlrover_tpu/common/periodic.py``).

Every agent/master-side monitor loop (heartbeats, resource reports,
training-metric tailing, config polling) is the same shape; this is the
single implementation they share.
"""

import threading
from typing import Callable, Optional

from dlrover_tpu_torch.common.log import logger


class PeriodicTask:
    """Run ``fn()`` every ``interval`` seconds in a daemon thread.

    Exceptions are logged and do not kill the loop. ``stop()`` wakes the
    thread immediately (Event-based wait) and joins it.
    """

    def __init__(self, fn: Callable[[], None], interval: float, name: str):
        self._fn = fn
        self._interval = interval
        self._name = name
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=self._name
        )
        self._thread.start()

    def _run(self):
        while not self._stopped.wait(self._interval):
            try:
                self._fn()
            except Exception as e:
                logger.warning("%s iteration failed: %s", self._name, e)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, join_timeout: float = 2.0):
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            self._thread = None
