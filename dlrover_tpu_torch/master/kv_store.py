"""Master-hosted key-value store (the port's copy of
``dlrover_tpu/master/kv_store.py``).

Used as the rendezvous/bootstrap store by agents and trainers (parity:
reference ``master/elastic_training/kv_store_service.py`` +
``elastic_agent/torch/master_kv_store.py``).
"""

import threading

from dlrover_tpu_torch.common.lockdep import instrumented_lock
from typing import Dict, Optional, Tuple


class KVStoreService:
    #: Every access to the declared attrs holds the named lock.
    GUARDED_BY = {"_store": "master.kv_store"}

    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._lock = instrumented_lock("master.kv_store")

    def set(self, key: str, value: bytes):
        with self._lock:
            self._store[key] = value

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._store.get(key)

    def add(self, key: str, amount: int) -> int:
        with self._lock:
            current = int(self._store.get(key, b"0"))
            current += amount
            self._store[key] = str(current).encode()
            return current

    def multi_get(self, keys: Tuple[str, ...]):
        with self._lock:
            return {k: self._store.get(k) for k in keys}

    def setnx(self, key: str, value: bytes) -> bytes:
        """Set `key` to `value` only if absent; return the winning value.

        The atomic first-claimant-wins primitive behind the checkpoint
        writer election: every replica proposes itself and all of them
        observe the same winner, including under concurrent proposals."""
        with self._lock:
            current = self._store.get(key)
            if current is None:
                self._store[key] = value
                return value
            return current

    def delete(self, key: str):
        with self._lock:
            self._store.pop(key, None)

    # ------------- master state snapshot/restore -------------
    def export_state(self) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._store)

    def restore_state(self, state: Dict[str, bytes]):
        with self._lock:
            self._store = dict(state)
