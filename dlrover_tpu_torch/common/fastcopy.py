"""The host thread pool of the checkpoint I/O path — the port's copy of
the pool half of ``dlrover_tpu/common/fastcopy.py``.

Stripe checksums (C loops that release the interpreter lock) and
positional reads run on one shared pool of ``DLROVER_TPU_COPY_THREADS``
threads, created on first use. The JAX package's native memcpy engine
(``dlrover_tpu/ops/csrc/fastcopy.cpp``) is not ported: the port's
snapshot bytes move by DMA between the card and the mapping, and its
host copies go through ``torch`` (ROADMAP queue 1, item 2).
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from dlrover_tpu_torch.common import env_utils

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=max(1, env_utils.COPY_THREADS.get()),
                thread_name_prefix="fastcopy",
            )
        return _POOL


def submit(fn, *args):
    """Schedule ``fn(*args)`` on the shared pool and return its Future."""
    return _pool().submit(fn, *args)


def parallel_map(fn, items):
    """``[fn(i) for i in items]`` on the shared pool."""
    items = list(items)
    if len(items) <= 1:
        return [fn(i) for i in items]
    return list(_pool().map(fn, items))
