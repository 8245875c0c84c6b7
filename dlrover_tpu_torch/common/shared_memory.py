"""POSIX shared memory that survives process death — the port's copy of
``dlrover_tpu/common/shared_memory.py``.

A file under ``DLROVER_TPU_SHM_DIR`` (``/dev/shm`` by default) mapped
with ``mmap``: the segment lives until ``unlink()`` (or a reboot), so an
agent re-attaches to a dead trainer's buffer and persists it. The
directory is read when a segment is named, not when the module is
imported.

A tmpfs answers a write past its size limit with SIGBUS, not with an
exception, so ``create`` checks the directory's free space first and
raises with both numbers.
"""

import mmap
import os
from typing import Optional

from dlrover_tpu_torch.common import env_utils


def _path(name: str) -> str:
    return os.path.join(env_utils.SHM_DIR.get(), name.replace("/", "_"))


def _check_room(path: str, fd: int, size: int):
    """Raise when growing the file at ``fd`` to ``size`` bytes would not
    fit its filesystem."""
    grow = size - os.fstat(fd).st_size
    if grow <= 0:
        return
    st = os.statvfs(os.path.dirname(path))
    free = st.f_bavail * st.f_frsize
    if grow > free:
        raise OSError(
            f"shared memory {path} needs {size} bytes ({grow} more) but "
            f"{os.path.dirname(path)} has {free} free; point "
            f"{env_utils.SHM_DIR.name} at a tmpfs that fits"
        )


class SharedMemory:
    """A named, persistent shared-memory segment (never tracked by the
    resource tracker, so it outlives the process that made it)."""

    def __init__(self, name: str, create: bool = False, size: int = 0):
        self.name = name
        self._file_path = _path(name)
        self._mmap: Optional[mmap.mmap] = None
        self._buf: Optional[memoryview] = None
        if create:
            if size <= 0:
                raise ValueError("size must be > 0 when creating")
            fd = os.open(self._file_path, os.O_CREAT | os.O_RDWR, 0o600)
            try:
                if os.fstat(fd).st_size != size:
                    _check_room(self._file_path, fd, size)
                    os.ftruncate(fd, size)
                self._mmap = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            self._size = size
        else:
            fd = os.open(self._file_path, os.O_RDWR)
            try:
                self._size = os.fstat(fd).st_size
                if self._size == 0:
                    raise ValueError(f"shared memory {name} is empty")
                self._mmap = mmap.mmap(fd, self._size)
            finally:
                os.close(fd)
        self._buf = memoryview(self._mmap)

    @property
    def size(self) -> int:
        return self._size

    @property
    def buf(self) -> memoryview:
        if self._buf is None:
            raise ValueError("shared memory is closed")
        return self._buf

    def flush(self):
        if self._mmap is not None:
            self._mmap.flush()

    def close(self):
        # Views over `buf` (numpy arrays, tensors) keep it exported; the
        # mapping then stays until they are collected, which is what a
        # saver thread still persisting from a view needs.
        if self._buf is not None:
            try:
                self._buf.release()
                self._buf = None
            except BufferError:
                return
        if self._mmap is not None:
            try:
                self._mmap.close()
                self._mmap = None
            except BufferError:
                pass

    def unlink(self):
        self.close()
        self.remove(self.name)

    @staticmethod
    def exists(name: str) -> bool:
        return os.path.exists(_path(name))

    @staticmethod
    def remove(name: str):
        try:
            os.unlink(_path(name))
        except FileNotFoundError:
            pass

    def __del__(self):  # close the map, never unlink implicitly
        try:
            self.close()
        except Exception:  # interpreter teardown: __del__ must not raise
            pass
