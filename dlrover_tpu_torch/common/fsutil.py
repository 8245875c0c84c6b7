"""Atomic small-file writes: tmp + fsync + ``os.replace`` (the port's
copy of ``dlrover_tpu/common/fsutil.py``).

The commit protocol every durable artifact in this codebase uses (state
snapshots, trackers, trace exports, result files): write the full
payload to a same-directory temp file, fsync it, then ``os.replace``
onto the final name. Readers therefore see either the old complete file
or the new complete file, never a torn one.

Same-directory matters twice: ``os.replace`` must not cross a
filesystem boundary, and the rename is only durable once the *directory*
is synced, which callers that need directory durability do themselves
(the state store does; one-shot result files don't bother).
"""

import os
import tempfile
from typing import Union


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Atomically replace `path` with `data` (tmp+fsync+replace)."""
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp", dir=dirname
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # Never leave a stray tmp on the durable path (GC trusts the
        # directory contents); the original file is untouched.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(
    path: str, data: str, encoding: str = "utf-8", fsync: bool = True
) -> None:
    atomic_write_bytes(path, data.encode(encoding), fsync=fsync)


def write_or_none(path: str) -> Union[bytes, None]:
    """Open-and-catch read: the file's bytes, or None if it does not
    exist (the race-free replacement for exists-then-open)."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except (FileNotFoundError, IsADirectoryError):
        return None
