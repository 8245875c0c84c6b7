"""Checkpoint storage — the port's copy of ``dlrover_tpu/common/storage.py``.

``CheckpointStorage`` is the interface the persist path writes through;
``PosixDiskStorage`` (local disk, NFS, fuse mounts) is the one backend.
Two capability handles serve the striped persist (``ckpt_persist``):

- :meth:`CheckpointStorage.open_writer` — positional writes into a
  preallocated ``.tmp`` file, one fsync and an atomic ``os.replace``;
- :meth:`CheckpointStorage.open_reader` — positional reads (``pread``)
  from one open descriptor into caller-owned views, safe to share across
  the restore thread pool.

The JAX package's ``CountingStorage`` and chaos wrapper come with later
slices (ROADMAP queue 1, items 4 and 7).
"""

import os
import shutil
from abc import ABC, abstractmethod
from typing import List, Optional

# os.pwritev takes at most IOV_MAX buffers per call; chunk conservatively.
_IOV_MAX = min(getattr(os, "IOV_MAX", 1024), 1024)


def _as_u8(data) -> memoryview:
    """A flat byte-typed memoryview over any contiguous buffer."""
    mv = data if isinstance(data, memoryview) else memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    return mv


class StripeWriter:
    """Positional write handle: ``write_at`` anywhere, then ``commit``
    publishes the file atomically (or ``abort`` leaves no trace).

    This base implementation buffers in memory and commits through the
    storage's ``write_bytes`` — correct for any backend (and exactly what
    the chaos wrapper needs: the whole file passes through one faultable
    write). Backends with positional I/O override ``open_writer`` to
    return a streaming handle instead.
    """

    def __init__(self, storage: "CheckpointStorage", path: str,
                 size: Optional[int] = None):
        self._storage = storage
        self._path = path
        self._buf = bytearray(size or 0)

    def write_at(self, offset: int, data) -> None:
        mv = _as_u8(data)
        end = offset + mv.nbytes
        if len(self._buf) < end:
            self._buf.extend(bytes(end - len(self._buf)))
        self._buf[offset:end] = mv

    def writev_at(self, offset: int, views: List[memoryview]) -> None:
        """Scatter-gather write of consecutive views starting at `offset`."""
        for v in views:
            self.write_at(offset, v)
            offset += _as_u8(v).nbytes

    def commit(self) -> None:
        self._storage.write_bytes(self._buf, self._path)

    def abort(self) -> None:
        self._buf = bytearray()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.commit()
        else:
            self.abort()
        return False


class _PosixStripeWriter(StripeWriter):
    """pwrite/pwritev into a preallocated ``.tmp``, one fsync, atomic
    rename — the stripe pipeline's write side. Preallocation means
    positional writes never extend the file, so out-of-order stripes
    don't create sparse-then-filled metadata churn."""

    def __init__(self, path: str, size: Optional[int] = None):
        self._path = path
        self._tmp = path + ".tmp"
        self._fd: Optional[int] = os.open(
            self._tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644
        )
        if size:
            os.ftruncate(self._fd, size)

    def write_at(self, offset: int, data) -> None:
        mv = _as_u8(data)
        while mv.nbytes:
            n = os.pwrite(self._fd, mv, offset)
            offset += n
            mv = mv[n:]

    def writev_at(self, offset: int, views: List[memoryview]) -> None:
        iov = [_as_u8(v) for v in views if _as_u8(v).nbytes]
        while iov:
            batch = iov[:_IOV_MAX]
            n = os.pwritev(self._fd, batch, offset)
            offset += n
            # Drop fully-written buffers; trim a partially-written head.
            while n and batch:
                head = batch[0]
                if n >= head.nbytes:
                    n -= head.nbytes
                    batch.pop(0)
                else:
                    batch[0] = head[n:]
                    n = 0
            iov = batch + iov[_IOV_MAX:]

    def commit(self) -> None:
        os.fsync(self._fd)
        os.close(self._fd)
        self._fd = None
        os.replace(self._tmp, self._path)

    def abort(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        try:
            os.remove(self._tmp)
        except OSError:
            pass


class RangeReader:
    """Positional read handle over one stored file.

    ``read`` returns bytes (possibly short at EOF); ``read_into`` fills a
    caller-owned writable view and returns the byte count — the restore
    path points it straight at the preallocated destination arrays, so
    block bytes are copied exactly once. The base implementation goes
    through ``read_range`` per call; ``PosixDiskStorage`` overrides with
    a shared-fd pread."""

    def __init__(self, storage: "CheckpointStorage", path: str):
        self._storage = storage
        self._path = path

    def read(self, offset: int, nbytes: int) -> bytes:
        data = self._storage.read_range(self._path, offset, nbytes)
        return b"" if data is None else data

    def read_into(self, offset: int, view) -> int:
        mv = _as_u8(memoryview(view))
        data = self.read(offset, mv.nbytes)
        n = min(len(data), mv.nbytes)
        mv[:n] = data[:n]
        return n

    def size(self) -> Optional[int]:
        data = self._storage.read_bytes(self._path)
        return None if data is None else len(data)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


class _PosixRangeReader(RangeReader):
    def __init__(self, path: str):
        self._fd = os.open(path, os.O_RDONLY)
        self._size = os.fstat(self._fd).st_size

    def read(self, offset: int, nbytes: int) -> bytes:
        return os.pread(self._fd, nbytes, offset)

    def read_into(self, offset: int, view) -> int:
        mv = _as_u8(memoryview(view))
        total = 0
        while mv.nbytes:
            n = os.preadv(self._fd, [mv], offset)
            if n == 0:
                break
            total += n
            offset += n
            mv = mv[n:]
        return total

    def size(self) -> int:
        return self._size

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


class CheckpointStorage(ABC):
    @abstractmethod
    def write(self, content, path: str):
        ...

    @abstractmethod
    def write_bytes(self, data: bytes, path: str):
        ...

    @abstractmethod
    def read(self, path: str, mode: str = "r"):
        ...

    @abstractmethod
    def read_bytes(self, path: str) -> bytes:
        ...

    def read_range(self, path: str, offset: int, nbytes: int):
        """Read `nbytes` starting at `offset`.

        The default falls back to a whole-file read — O(filesize) PER
        BLOCK during sharded restore. Real backends (object stores, ...)
        should override with a native range read.
        """
        data = self.read_bytes(path)
        if data is None:
            return None
        return data[offset:offset + nbytes]

    def open_writer(self, path: str, size: Optional[int] = None) -> StripeWriter:
        """A positional writer whose ``commit`` publishes `path` atomically."""
        return StripeWriter(self, path, size)

    def open_reader(self, path: str) -> Optional[RangeReader]:
        """A positional reader for `path`, or None when it doesn't exist."""
        if not self.exists(path):
            return None
        return RangeReader(self, path)

    def write_chunks(self, chunks, path: str):
        """Write an iterable of bytes-like chunks as one file (atomic).

        Streams through :meth:`open_writer` in scatter-gather batches —
        the chunk iterable is never joined into one contiguous copy of
        the whole checkpoint.
        """
        with self.open_writer(path) as w:
            offset = 0
            batch: List[memoryview] = []
            batch_off = 0
            batch_bytes = 0
            for c in chunks:
                mv = _as_u8(c)
                batch.append(mv)
                batch_bytes += mv.nbytes
                offset += mv.nbytes
                if batch_bytes >= (4 << 20) or len(batch) >= _IOV_MAX:
                    w.writev_at(batch_off, batch)
                    batch, batch_off, batch_bytes = [], offset, 0
            if batch:
                w.writev_at(batch_off, batch)

    @abstractmethod
    def safe_rename(self, src: str, dst: str):
        ...

    @abstractmethod
    def safe_makedirs(self, path: str):
        ...

    @abstractmethod
    def safe_remove(self, path: str):
        ...

    @abstractmethod
    def exists(self, path: str) -> bool:
        ...

    @abstractmethod
    def listdir(self, path: str):
        ...

    def commit(self, step: int, success: bool):
        """Hook called after a full step's shards are persisted."""


class PosixDiskStorage(CheckpointStorage):
    def write(self, content, path: str):
        mode = "wb" if isinstance(content, (bytes, bytearray, memoryview)) else "w"
        tmp = path + ".tmp"
        with open(tmp, mode) as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def write_bytes(self, data: bytes, path: str):
        self.write(data, path)

    # read/read_range open and catch instead of pre-checking existence:
    # the exists() probe was both an extra syscall per block and a TOCTOU
    # race against concurrent gc/quarantine renames.
    def read(self, path: str, mode: str = "r"):
        try:
            with open(path, mode) as f:
                return f.read()
        except (FileNotFoundError, NotADirectoryError):
            return None

    def read_bytes(self, path: str) -> Optional[bytes]:
        return self.read(path, "rb")

    def read_range(self, path: str, offset: int, nbytes: int):
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                return f.read(nbytes)
        except (FileNotFoundError, NotADirectoryError):
            return None

    def open_writer(self, path: str, size: Optional[int] = None) -> StripeWriter:
        return _PosixStripeWriter(path, size)

    def open_reader(self, path: str) -> Optional[RangeReader]:
        try:
            return _PosixRangeReader(path)
        except (FileNotFoundError, NotADirectoryError, IsADirectoryError):
            return None

    def safe_rename(self, src: str, dst: str):
        os.replace(src, dst)

    def safe_makedirs(self, path: str):
        os.makedirs(path, exist_ok=True)

    def safe_remove(self, path: str):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            try:
                os.remove(path)
            except OSError:
                pass

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str):
        if not os.path.isdir(path):
            return []
        return sorted(os.listdir(path))


def get_checkpoint_storage(storage: Optional[CheckpointStorage] = None):
    return storage or PosixDiskStorage()
