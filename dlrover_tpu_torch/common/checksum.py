"""Per-block and per-stripe checkpoint checksums — the port's copy of
``dlrover_tpu/common/checksum.py``.

crc32c (Castagnoli) when a native implementation is importable
(``crc32c``, else ``google_crc32c``), else zlib's crc32: the same
imports in the same order as the JAX package, so both stamp the same
algorithm on one machine. The writer stamps its algorithm's name into
``ShardMeta.crc_algo``; a reader that cannot compute it skips the
verification with a warning instead of reporting corruption. Every entry
point takes a contiguous buffer (memoryview, numpy array, bytes) without
an intermediate copy.
"""

import zlib
from typing import Callable, Dict, Optional

from dlrover_tpu_torch.common.log import logger

#: One-shot checksum over a whole buffer.
_ALGOS: Dict[str, Callable[..., int]] = {
    "crc32": lambda data: zlib.crc32(data) & 0xFFFFFFFF,
}

#: Incremental fold: fn(data, running_crc) -> running_crc.
_INCR: Dict[str, Callable[..., int]] = {
    "crc32": lambda data, crc: zlib.crc32(data, crc),
}

try:  # pragma: no cover - depends on the environment
    import crc32c as _crc32c_mod

    _ALGOS["crc32c"] = lambda data: _crc32c_mod.crc32c(data) & 0xFFFFFFFF
    _INCR["crc32c"] = lambda data, crc: _crc32c_mod.crc32c(data, crc)
except ImportError:
    try:  # pragma: no cover
        import google_crc32c as _gcrc32c_mod

        def _gcrc_one_shot(data):
            return int.from_bytes(
                _gcrc32c_mod.Checksum(bytes(data)).digest(), "big"
            )

        def _gcrc_incr(data, crc):
            c = _gcrc32c_mod.Checksum()
            c._crc = crc  # resume the running value
            c.update(bytes(data))
            return int.from_bytes(c.digest(), "big")

        _ALGOS["crc32c"] = _gcrc_one_shot
        _INCR["crc32c"] = _gcrc_incr
    except ImportError:
        pass

#: Algorithm new checkpoints are written with.
DEFAULT_ALGO = "crc32c" if "crc32c" in _ALGOS else "crc32"

_warned_algos = set()


def supports(algo: str) -> bool:
    """Whether this build can compute `algo`."""
    return algo in _ALGOS


def warn_unavailable(algo: str):
    """Log (once per algorithm) that verification is being skipped."""
    if algo not in _warned_algos:
        _warned_algos.add(algo)
        logger.warning(
            "checkpoint written with unavailable checksum algo %r; "
            "skipping verification", algo,
        )


class Incremental:
    """Streaming checksum state: ``update()`` buffers, ``digest()`` the
    running uint32, folding each view in place."""

    __slots__ = ("_fn", "_crc")

    def __init__(self, algo: str = DEFAULT_ALGO):
        self._fn = _INCR[algo]
        self._crc = 0

    def update(self, data) -> None:
        self._crc = self._fn(data, self._crc)

    def digest(self) -> int:
        return self._crc & 0xFFFFFFFF


def incremental(algo: str = DEFAULT_ALGO) -> Incremental:
    """A fresh streaming checksum for `algo` (KeyError if unsupported)."""
    return Incremental(algo)


def block_checksum(data, algo: str = DEFAULT_ALGO) -> int:
    """Checksum of a contiguous bytes-like block under `algo` (uint32)."""
    return _ALGOS[algo](data)


def verify_block(data, expected: Optional[int], algo: str) -> bool:
    """True when `data` matches `expected` (or verification is moot: no
    checksum in the meta, or an algorithm this build cannot compute)."""
    if expected is None:
        return True
    fn = _ALGOS.get(algo)
    if fn is None:
        warn_unavailable(algo)
        return True
    return fn(data) == expected
