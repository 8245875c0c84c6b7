"""Named barrier/sync groups across workers (the port's copy of
``dlrover_tpu/master/sync_service.py``).

Parity: reference ``master/elastic_training/sync_service.py`` — workers join
a named sync; the sync completes when every alive worker has joined; a
separate notify/wait barrier lets one worker release the rest.
"""

import threading

from dlrover_tpu_torch.common.lockdep import instrumented_lock
from typing import Dict, Set


class SyncService:
    #: Barrier/sync membership is read-modify-write state.
    GUARDED_BY = {
        "_sync_objs": "master.sync_service",
        "_finished_syncs": "master.sync_service",
        "_barriers": "master.sync_service",
    }

    def __init__(self, job_manager=None):
        self._job_manager = job_manager
        self._sync_objs: Dict[str, Set[int]] = {}
        self._finished_syncs: Set[str] = set()
        self._barriers: Set[str] = set()
        self._lock = instrumented_lock("master.sync_service")

    def _alive_workers(self) -> Set[int]:
        if self._job_manager is None:
            return set()
        return set(self._job_manager.alive_worker_ranks())

    def join_sync(self, sync_name: str, worker_rank: int) -> bool:
        with self._lock:
            self._sync_objs.setdefault(sync_name, set()).add(worker_rank)
            alive = self._alive_workers()
            if alive and alive.issubset(self._sync_objs[sync_name]):
                self._finished_syncs.add(sync_name)
        return True

    def sync_finished(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._finished_syncs

    def notify_barrier(self, sync_name: str) -> bool:
        with self._lock:
            self._barriers.add(sync_name)
        return True

    def barrier_reached(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._barriers
