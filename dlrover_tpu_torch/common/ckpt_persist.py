"""Shard persistence + two-phase commit, shared by agent saver and
standalone (agent-less) trainer engines — the port's copy of
``dlrover_tpu/common/ckpt_persist.py``, which *is* the on-disk format:
a directory written by either package restores in the other. The
``.meta`` pickles name the JAX package's classes (``ckpt_meta.dumps``).

Layout under ``checkpoint_dir`` (parity: reference done-file + tracker-file
protocol, ``dlrover/python/elastic_agent/torch/ckpt_saver.py:747-785``)::

    checkpoint-{step}/shard_{gid}.bin    raw shm buffer (used bytes only)
    checkpoint-{step}/shard_{gid}.meta   pickled ShardMeta
    checkpoint-{step}/done_{gid}         commit vote of shard gid
    latest_checkpointed_iteration.txt    tracker: last fully-committed step

A step is readable iff the tracker names it; the tracker is written only
after every ``done_*`` file exists, so readers can never observe a torn
checkpoint.

On top of the commit protocol sits integrity, at two granularities
(stamped here, on the async persist path — never in the trainer's hot
save path; verified on every storage read). New checkpoints are written
**striped**: the persist payload is cut into fixed-size stripes
(``DLROVER_TPU_CKPT_STRIPE_MB``, default 32 MB), each stripe is
checksummed on the ``fastcopy`` thread pool while the persist thread
overlaps positional writes into a preallocated temp file — a bounded
producer/consumer pipeline, then one fsync and the unchanged atomic
rename. Per-stripe CRCs land in ``ShardMeta.stripes``; restore verifies
them in parallel and localizes corruption to a stripe. Pre-stripe
checkpoints (per-block ``TensorMeta.crc``, or none at all) keep
verifying through the old path — no format flag day. A step caught
lying — missing shards, undecodable metas, short or bit-flipped bins —
is *quarantined*: a marker file with the reason is dropped into its dir
and both restore and GC skip it from then on, so a damaged step is
diagnosed once, not re-read on every restart.
"""

import dataclasses
import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import checksum, ckpt_meta, env_utils, fastcopy
from dlrover_tpu_torch.common.backoff import ExponentialBackoff
from dlrover_tpu_torch.common.ckpt_meta import ShardMeta, StripeMeta, TensorMeta
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.storage import CheckpointStorage, RangeReader


class StepCorruptionError(Exception):
    """A persisted step failed integrity verification.

    Raised by :func:`read_block` on a checksum mismatch and by restore
    paths that find a step structurally broken (missing shards, torn
    bins, undecodable metas). Carries enough context to quarantine the
    step with a useful reason."""

    def __init__(self, step: int, reason: str):
        super().__init__(f"checkpoint step {step} corrupt: {reason}")
        self.step = step
        self.reason = reason


class TopologyMismatchError(Exception):
    """A checkpoint can't be re-sliced for the restoring mesh topology:
    the step on disk is intact, but the persisted blocks of some leaf do
    not tile the requested template (the JAX package's error, same
    message). Deliberately not a :class:`StepCorruptionError`: falling
    back to an older step would silently load wrong slices, so it
    propagates, naming both topologies."""

    def __init__(self, step: int, saved_axes, restore_axes, detail: str = ""):
        msg = (
            f"checkpoint step {step} was saved under mesh axes "
            f"{saved_axes or 'unknown'} but is being restored under "
            f"{restore_axes or 'unknown'}, and the persisted blocks do "
            "not cover the requested template"
        )
        if detail:
            msg += f" ({detail})"
        msg += (
            "; restore with a coverable topology or re-save under the "
            "new mesh"
        )
        super().__init__(msg)
        self.step = step
        self.saved_axes = saved_axes
        self.restore_axes = restore_axes


class ZeroDegreeMismatchError(Exception):
    """A ZeRO-sharded checkpoint can't be re-sliced for the restoring
    spec: the step on disk is intact, but it belongs to another
    weight-update sharding degree (``accel/zero.py``) and the persisted
    optimizer-state slices do not tile the requested template (the JAX
    package's error, same message). Deliberately not a
    :class:`StepCorruptionError`: the fallback chain must not skip to an
    older step and load a wrong slice silently, so it propagates to the
    caller, naming both degrees."""

    def __init__(self, step: int, saved_degree: int, restore_degree: int,
                 detail: str = ""):
        msg = (
            f"checkpoint step {step} was saved with zero_degree="
            f"{saved_degree} but is being restored with zero_degree="
            f"{restore_degree}, and the persisted optimizer-state slices "
            "do not cover the requested template"
        )
        if detail:
            msg += f" ({detail})"
        msg += (
            "; restore with the original parallel spec or re-save under "
            "the new degree"
        )
        super().__init__(msg)
        self.step = step
        self.saved_degree = saved_degree
        self.restore_degree = restore_degree


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{CheckpointConstant.STEP_DIR_PREFIX}{step}")


def _tracker_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, CheckpointConstant.TRACKER_FILE)


#: Default stripe size. Big enough that per-stripe overhead (one pool
#: dispatch, one pwritev batch, one StripeMeta) vanishes; small enough
#: that a 1 GB shard still gets real checksum parallelism and corruption
#: localizes usefully.
DEFAULT_STRIPE_MB = 32

#: How many stripes may be in flight (checksummed but not yet reaped)
#: ahead of the writer — bounds the pending-future queue, not memory
#: (stripe views alias the shm buffer; nothing is copied).
_PIPELINE_DEPTH = 16


def stripe_bytes_config() -> int:
    """Configured stripe size in bytes; 0 disables striping entirely
    (legacy per-block-CRC format, kept for A/B benchmarking and as the
    writer of old-format fixtures in tests). Clamped to >= 1 MB so a
    misconfigured env cannot explode a shard into millions of stripes."""
    mb = env_utils.CKPT_STRIPE_MB.get()
    if mb <= 0:
        return 0
    return max(1 << 20, int(mb * (1 << 20)))


def incremental_enabled() -> bool:
    """Content-hash incremental stripes on/off (needs striping too)."""
    return env_utils.CKPT_INCREMENTAL.get()


def _plan_stripes(chunks: List[memoryview],
                  stripe_bytes: int) -> List[Tuple[int, List[memoryview]]]:
    """Cut the concatenated chunk stream into fixed-size stripes.

    Returns ``[(file_offset, [views])]`` where each view aliases (a slice
    of) an input chunk — stripes are a relabeling of the same memory,
    never a copy. Stripe boundaries ignore block boundaries."""
    plan: List[Tuple[int, List[memoryview]]] = []
    cur: List[memoryview] = []
    cur_off = 0
    cur_n = 0
    for c in chunks:
        mv = c if isinstance(c, memoryview) else memoryview(c)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        while mv.nbytes:
            take = min(mv.nbytes, stripe_bytes - cur_n)
            cur.append(mv[:take])
            cur_n += take
            mv = mv[take:]
            if cur_n == stripe_bytes:
                plan.append((cur_off, cur))
                cur_off += cur_n
                cur, cur_n = [], 0
    if cur:
        plan.append((cur_off, cur))
    return plan


def _stripe_crc(views: List[memoryview], algo: str) -> Tuple[int, float]:
    """Fold one stripe's views through an incremental checksum.

    Runs on a fastcopy pool thread; returns (crc, cpu_seconds) so the
    persist stats can report checksum overhead separately from I/O."""
    t0 = time.perf_counter()
    inc = checksum.incremental(algo)
    for v in views:
        inc.update(v)
    return inc.digest(), time.perf_counter() - t0


def _write_striped(
    storage: CheckpointStorage, path: str,
    chunks: List[memoryview], total: int, stripe_bytes: int,
    prev: Optional[Dict[int, Tuple[int, int, int]]] = None,
) -> Tuple[List[StripeMeta], float, int]:
    """The pipelined persist: for each stripe, submit its checksum to the
    pool; once the crc is reaped the stripe is written positionally —
    checksum and I/O still overlap (the write trails the hash by up to
    the pipeline depth), but now the hash gates the write: with ``prev``
    (the previous committed step's stripe table,
    ``{offset: (nbytes, crc, owner_step)}``), a stripe whose offset,
    length and crc all match is recorded as a *reference* to the owner
    step's bin instead of rewritten — only changed bytes hit storage.
    One fsync + atomic rename at commit (the writer handle owns the
    protocol; unwritten referenced ranges stay holes in the preallocated
    file and are never read from it). Returns the stripe metas (in file
    order), total checksum CPU-seconds, and the bytes actually written.
    """
    plan = _plan_stripes(chunks, stripe_bytes)
    algo = checksum.DEFAULT_ALGO
    stripes: List[StripeMeta] = []
    checksum_s = 0.0
    written = 0
    pending = deque()  # (offset, nbytes, views, future)

    with storage.open_writer(path, total) as w:
        def _reap():
            nonlocal checksum_s, written
            off, nbytes, views, fut = pending.popleft()
            crc, cpu_s = fut.result()
            checksum_s += cpu_s
            hit = prev.get(off) if prev else None
            if hit is not None and hit[0] == nbytes and hit[1] == crc:
                stripes.append(StripeMeta(
                    offset=off, nbytes=nbytes, crc=crc, ref_step=hit[2]
                ))
                return
            w.writev_at(off, views)
            written += nbytes
            stripes.append(StripeMeta(offset=off, nbytes=nbytes, crc=crc))

        for off, views in plan:
            nbytes = sum(v.nbytes for v in views)
            pending.append(
                (off, nbytes, views, fastcopy.submit(_stripe_crc, views, algo))
            )
            while len(pending) >= _PIPELINE_DEPTH:
                _reap()
        while pending:
            _reap()
    return stripes, checksum_s, written


def _prev_stripe_map(
    storage: CheckpointStorage, ckpt_dir: str, step: int, gid: int,
    stripe_bytes: int,
) -> Optional[Dict[int, Tuple[int, int, int]]]:
    """Stripe table of the newest committed step below `step` for shard
    `gid`: ``{offset: (nbytes, crc, owner_step)}``, for the incremental
    persist to diff against. ``owner_step`` follows one existing ref hop
    so new references always point at the bin that physically holds the
    bytes — chains never deepen. None when there is nothing safe to
    reference (no committed prior step, quarantined, different stripe
    size or checksum algorithm — offsets/crcs would not be comparable).
    """
    tracker = read_tracker(storage, ckpt_dir)
    if tracker is None or tracker >= step:
        return None
    if is_quarantined(storage, ckpt_dir, tracker):
        return None
    d = step_dir(ckpt_dir, tracker)
    prefix = os.path.join(d, f"{CheckpointConstant.SHARD_FILE_PREFIX}{gid}")
    raw = storage.read_bytes(prefix + ".meta")
    if raw is None:
        return None
    try:
        meta = ckpt_meta.loads(raw)
    except Exception:
        return None
    stripes = getattr(meta, "stripes", None)
    if not stripes or getattr(meta, "stripe_bytes", 0) != stripe_bytes:
        return None
    if getattr(meta, "crc_algo", "") != checksum.DEFAULT_ALGO:
        return None
    out: Dict[int, Tuple[int, int, int]] = {}
    for s in stripes:
        ref = getattr(s, "ref_step", -1)
        owner = ref if ref >= 0 else tracker
        out[s.offset] = (s.nbytes, s.crc, owner)
    return out


def step_refs(meta: ShardMeta) -> set:
    """Steps whose bins a shard meta's stripes reference (excluding its
    own) — the GC liveness inputs."""
    return {
        ref for s in (getattr(meta, "stripes", None) or [])
        if (ref := getattr(s, "ref_step", -1)) >= 0
    }


def persist_shard(storage: CheckpointStorage, ckpt_dir: str,
                  meta: ShardMeta, buf: memoryview) -> Dict[str, float]:
    """Write one shard's persist-owned blocks + meta and its done file.

    The shm buffer may hold blocks this process stages only for fast local
    memory restore (replica copies another process persists); the disk file
    carries exclusively the ``persist=True`` blocks, with offsets remapped
    to the file layout, so a sharded checkpoint stores each byte once.

    Integrity is stamped here — this function runs on the agent saver's
    persist thread (or the standalone engine's inline persist), off the
    trainer's ``save_to_memory`` hot path, so it costs zero save-time
    synchronization. With striping enabled (the default) per-stripe CRCs
    are computed on the fastcopy pool, overlapped with the positional
    writes; with ``DLROVER_TPU_CKPT_STRIPE_MB=0`` the legacy per-block
    format is written instead.

    Returns persist stats (bytes, wall seconds, MB/s, checksum seconds).
    """
    d = step_dir(ckpt_dir, meta.step)
    storage.safe_makedirs(d)
    gid = meta.global_shard_id
    prefix = os.path.join(d, f"{CheckpointConstant.SHARD_FILE_PREFIX}{gid}")
    pairs: List[Tuple[TensorMeta, memoryview]] = []
    offset = 0
    opt_bytes = 0
    for t in meta.tensors:
        if not t.persist:
            continue
        pairs.append((t, buf[t.offset:t.offset + t.nbytes]))
        offset += t.nbytes
        # Optimizer-state share of this shard's persist volume — the
        # number ZeRO-1 shrinks ~Ndp× (state paths are keystr paths into
        # the train-state dict, so opt leaves start with ['opt']).
        if t.path.startswith("['opt']"):
            opt_bytes += t.nbytes

    stripe_bytes = stripe_bytes_config()
    t0 = time.perf_counter()
    written = offset
    if stripe_bytes:
        file_off = 0
        disk_tensors = []
        for t, _ in pairs:
            disk_tensors.append(
                dataclasses.replace(t, offset=file_off, crc=None))
            file_off += t.nbytes
        prev = (
            _prev_stripe_map(storage, ckpt_dir, meta.step, gid, stripe_bytes)
            if incremental_enabled() else None
        )
        stripes, checksum_s, written = _write_striped(
            storage, prefix + ".bin", [b for _, b in pairs], offset,
            stripe_bytes, prev=prev,
        )
    else:
        # Legacy format: one CRC per block, serial checksum-then-write.
        checksum_s = 0.0
        file_off = 0
        disk_tensors = []
        for t, block in pairs:
            tc0 = time.perf_counter()
            crc = checksum.block_checksum(block)
            checksum_s += time.perf_counter() - tc0
            disk_tensors.append(
                dataclasses.replace(t, offset=file_off, crc=crc))
            file_off += t.nbytes
        stripes = None
        storage.write_chunks([b for _, b in pairs], prefix + ".bin")
    persist_s = time.perf_counter() - t0

    disk_meta = dataclasses.replace(
        meta, tensors=disk_tensors, used_bytes=offset, shm_name="",
        crc_algo=checksum.DEFAULT_ALGO,
        stripes=stripes, stripe_bytes=stripe_bytes,
    )
    storage.write_bytes(ckpt_meta.dumps(disk_meta), prefix + ".meta")
    storage.write(
        "", os.path.join(d, f"{CheckpointConstant.DONE_FILE_PREFIX}{gid}")
    )
    ref_stripes = sum(
        1 for s in (stripes or []) if getattr(s, "ref_step", -1) >= 0
    )
    stats = {
        "bytes": float(offset),
        "opt_bytes": float(opt_bytes),
        "persist_s": persist_s,
        "persist_mbps": (offset / persist_s / 1e6) if persist_s > 0 else 0.0,
        "checksum_s": checksum_s,
        "striped": 1.0 if stripe_bytes else 0.0,
        # Incremental accounting: bytes physically written this step
        # (== payload when nothing could be referenced) and how many
        # stripes rode as references to an earlier step's bin.
        "written_bytes": float(written),
        "ref_stripes": float(ref_stripes),
        "total_stripes": float(len(stripes or [])),
    }
    return stats


def count_done(storage: CheckpointStorage, ckpt_dir: str, step: int) -> int:
    d = step_dir(ckpt_dir, step)
    return sum(
        1 for f in storage.listdir(d)
        if f.startswith(CheckpointConstant.DONE_FILE_PREFIX)
    )


def commit_step(storage: CheckpointStorage, ckpt_dir: str, step: int,
                global_shard_num: int, timeout: float = 600.0) -> bool:
    """Wait for every shard's done file, then publish `step` in the tracker.

    Returns False (and leaves the tracker untouched) on timeout — a partial
    step directory is garbage-collected later, never published.

    Polls with jittered exponential backoff: the committer's listdir scans
    hit shared storage, and a fixed interval from every job on the
    filesystem synchronizes into a thundering herd.
    """
    deadline = time.monotonic() + timeout
    backoff = ExponentialBackoff(initial=0.05, max_delay=1.0)
    while True:
        n = count_done(storage, ckpt_dir, step)
        if n >= global_shard_num:
            storage.write(str(step), _tracker_path(ckpt_dir))
            logger.info(
                "flash ckpt: committed step %s (%s shards)", step, n
            )
            return True
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        backoff.sleep(remaining)
    logger.error(
        "flash ckpt: commit of step %s timed out (%s/%s done)",
        step, count_done(storage, ckpt_dir, step), global_shard_num,
    )
    return False


def read_tracker(storage: CheckpointStorage, ckpt_dir: str) -> Optional[int]:
    content = storage.read(_tracker_path(ckpt_dir))
    if not content:
        return None
    try:
        return int(str(content).strip())
    except ValueError:
        return None


def load_shard(storage: CheckpointStorage, ckpt_dir: str, step: int,
               gid: int) -> Optional[Tuple[ShardMeta, bytes]]:
    d = step_dir(ckpt_dir, step)
    prefix = os.path.join(d, f"{CheckpointConstant.SHARD_FILE_PREFIX}{gid}")
    raw_meta = storage.read_bytes(prefix + ".meta")
    raw_bin = storage.read_bytes(prefix + ".bin")
    if raw_meta is None or raw_bin is None:
        return None
    return ckpt_meta.loads(raw_meta), raw_bin


def load_step_metas(storage: CheckpointStorage, ckpt_dir: str,
                    step: int) -> Dict[int, ShardMeta]:
    """All shard metas of a step, keyed by global shard id.

    Restore after a world-size change cannot know how many shards the save
    wrote, so the step directory is enumerated instead of trusting the
    current world size (the reshard-on-restore entry point)."""
    d = step_dir(ckpt_dir, step)
    metas: Dict[int, ShardMeta] = {}
    for name in storage.listdir(d):
        if not (name.startswith(CheckpointConstant.SHARD_FILE_PREFIX)
                and name.endswith(".meta")):
            continue
        try:
            gid = int(name[len(CheckpointConstant.SHARD_FILE_PREFIX):-5])
        except ValueError:
            continue
        raw = storage.read_bytes(os.path.join(d, name))
        if raw is None:
            continue
        try:
            metas[gid] = ckpt_meta.loads(raw)
        except Exception:
            logger.warning("undecodable shard meta %s", name)
    return metas


def read_block(storage: CheckpointStorage, ckpt_dir: str, step: int,
               gid: int, t: TensorMeta, crc_algo: str = "") -> Optional[bytes]:
    """Read one block's bytes out of a shard's bin file, verified.

    Returns None when the block is missing or short (file gone or
    truncated past this block). Raises :class:`StepCorruptionError` when
    the bytes are present but fail their checksum — a length-preserving
    bit flip, the failure mode the commit protocol alone cannot see.
    ``crc_algo`` comes from the shard's :class:`ShardMeta`; old metas
    without checksums verify vacuously (read via getattr — they may
    predate the ``crc`` field entirely).
    """
    d = step_dir(ckpt_dir, step)
    path = os.path.join(
        d, f"{CheckpointConstant.SHARD_FILE_PREFIX}{gid}.bin"
    )
    data = storage.read_range(path, t.offset, t.nbytes)
    if data is None or len(data) != t.nbytes:
        return None
    if not checksum.verify_block(data, getattr(t, "crc", None), crc_algo):
        raise StepCorruptionError(
            step,
            f"checksum mismatch in shard {gid} block {t.path!r} "
            f"(offset {t.offset}, {t.nbytes} bytes, algo {crc_algo or 'crc32'})",
        )
    return data


def shard_bin_path(ckpt_dir: str, step: int, gid: int) -> str:
    return os.path.join(
        step_dir(ckpt_dir, step),
        f"{CheckpointConstant.SHARD_FILE_PREFIX}{gid}.bin",
    )


def open_shard_reader(storage: CheckpointStorage, ckpt_dir: str, step: int,
                      gid: int) -> Optional[RangeReader]:
    """One positional reader for a shard's bin file (None when missing).

    The restore path opens this once per shard and serves every block
    through it — replacing the open-per-block ``read_range`` pattern
    (an open/seek/read/close quartet per pytree leaf). Callers own
    ``close()``. pread is offset-addressed, so one reader is safe to
    share across the fastcopy pool."""
    return storage.open_reader(shard_bin_path(ckpt_dir, step, gid))


class _RoutedShardReader(RangeReader):
    """A RangeReader over a shard whose stripes may reference earlier
    steps' bins (incremental persist): byte ranges inside a referenced
    stripe are served from the owner step's bin *at the same offset*
    (references only happen when content at that offset is unchanged, so
    the layouts coincide); everything else reads the step's own bin.
    Owner-step readers open lazily under a lock (stripe verification
    reads through this from the fastcopy pool)."""

    def __init__(self, storage: CheckpointStorage, ckpt_dir: str,
                 step: int, gid: int, meta: ShardMeta):
        import bisect
        import threading

        self._bisect = bisect
        self._storage = storage
        self._ckpt_dir = ckpt_dir
        self._step = step
        self._gid = gid
        # Sorted (start, end, owner_step) spans; -1 owner = own bin.
        self._spans = sorted(
            (s.offset, s.offset + s.nbytes, getattr(s, "ref_step", -1))
            for s in (getattr(meta, "stripes", None) or [])
        )
        self._starts = [sp[0] for sp in self._spans]
        self._readers: Dict[int, Optional[RangeReader]] = {}
        self._open_lock = threading.Lock()

    def _reader_for(self, owner: int) -> Optional[RangeReader]:
        with self._open_lock:
            if owner not in self._readers:
                target = self._step if owner < 0 else owner
                self._readers[owner] = self._storage.open_reader(
                    shard_bin_path(self._ckpt_dir, target, self._gid)
                )
            return self._readers[owner]

    def _route(self, offset: int, nbytes: int):
        """Split [offset, offset+nbytes) into (offset, nbytes, owner)
        pieces along the stripe spans; gaps outside the table read own."""
        end = offset + nbytes
        while offset < end:
            i = self._bisect.bisect_right(self._starts, offset) - 1
            owner = -1
            stop = end
            if 0 <= i < len(self._spans) and offset < self._spans[i][1]:
                owner = self._spans[i][2]
                stop = min(end, self._spans[i][1])
            elif i + 1 < len(self._spans):
                stop = min(end, self._spans[i + 1][0])
            yield offset, stop - offset, owner
            offset = stop

    def read_into(self, offset: int, view) -> int:
        mv = memoryview(view)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        total = 0
        for off, n, owner in self._route(offset, mv.nbytes):
            r = self._reader_for(owner)
            if r is None:
                break
            got = r.read_into(off, mv[total:total + n])
            total += got
            if got != n:
                break
        return total

    def read(self, offset: int, nbytes: int) -> bytes:
        buf = bytearray(nbytes)
        n = self.read_into(offset, memoryview(buf))
        return bytes(buf[:n])

    def size(self) -> Optional[int]:
        own = self._reader_for(-1)
        return None if own is None else own.size()

    def close(self) -> None:
        with self._open_lock:
            for r in self._readers.values():
                if r is not None:
                    try:
                        r.close()
                    except OSError:
                        pass
            self._readers.clear()


def open_routed_reader(storage: CheckpointStorage, ckpt_dir: str, step: int,
                       gid: int, meta: ShardMeta) -> Optional[RangeReader]:
    """The reader restore/verify should use: a plain shard reader when
    every stripe's bytes live in the step's own bin, a routing reader
    when incremental persist referenced earlier steps. Returns None when
    the step's own bin is missing (a fully-referenced bin still exists —
    the writer creates it, holes and all)."""
    if any(
        getattr(s, "ref_step", -1) >= 0
        for s in (getattr(meta, "stripes", None) or [])
    ):
        if not storage.exists(shard_bin_path(ckpt_dir, step, gid)):
            return None
        return _RoutedShardReader(storage, ckpt_dir, step, gid, meta)
    return open_shard_reader(storage, ckpt_dir, step, gid)


#: Scratch granularity for stripe verification — bounds per-task memory
#: while keeping reads large enough to stream.
_VERIFY_CHUNK = 4 << 20


def verify_stripes(reader: RangeReader, meta: ShardMeta, step: int,
                   gid: int) -> None:
    """Verify every stripe checksum of a striped shard, in parallel.

    No-op for pre-stripe metas (their integrity rides per-block through
    :func:`read_block` / :func:`verify_step`). Raises
    :class:`StepCorruptionError` naming the damaged stripe — its index,
    byte range, and shard — so corruption localizes to ~one stripe
    instead of "shard bad". Stripes are checked on the fastcopy pool;
    each task streams through a small scratch buffer, so verification
    memory is bounded regardless of stripe size."""
    stripes = getattr(meta, "stripes", None)
    if not stripes:
        return
    algo = getattr(meta, "crc_algo", "") or "crc32"
    if not checksum.supports(algo):
        checksum.warn_unavailable(algo)
        return

    def _one(item):
        i, s = item
        inc = checksum.incremental(algo)
        scratch = memoryview(bytearray(min(s.nbytes, _VERIFY_CHUNK)))
        done = 0
        while done < s.nbytes:
            k = min(s.nbytes - done, len(scratch))
            got = reader.read_into(s.offset + done, scratch[:k])
            if got != k:
                return i, "truncated"
            inc.update(scratch[:k])
            done += k
        return i, (None if inc.digest() == s.crc else "checksum mismatch")

    for i, bad in fastcopy.parallel_map(_one, enumerate(stripes)):
        if bad:
            s = stripes[i]
            raise StepCorruptionError(
                step,
                f"{bad} in shard {gid} stripe {i}/{len(stripes)} "
                f"(offset {s.offset}, {s.nbytes} bytes, algo {algo})",
            )


def list_steps(storage: CheckpointStorage, ckpt_dir: str) -> List[int]:
    """Sorted step numbers that have a step directory (committed or not)."""
    steps = []
    for name in storage.listdir(ckpt_dir):
        if name.startswith(CheckpointConstant.STEP_DIR_PREFIX):
            try:
                steps.append(
                    int(name[len(CheckpointConstant.STEP_DIR_PREFIX):])
                )
            except ValueError:
                continue
    return sorted(steps)


def _quarantine_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(
        step_dir(ckpt_dir, step), CheckpointConstant.QUARANTINE_FILE
    )


def quarantine_step(storage: CheckpointStorage, ckpt_dir: str, step: int,
                    reason: str) -> None:
    """Mark a step dir as damaged so restore and GC skip it from now on.

    The marker body carries the reason for post-mortems. Quarantine is
    negative-only caching: a step is never marked "verified good" — reads
    always re-verify checksums, because storage can rot after a positive
    verdict but a damaged step stays damaged."""
    logger.error(
        "flash ckpt: quarantining step %s under %s: %s",
        step, ckpt_dir, reason,
    )
    try:
        storage.write(reason, _quarantine_path(ckpt_dir, step))
    except Exception:
        logger.warning(
            "flash ckpt: could not write quarantine marker for step %s",
            step, exc_info=True,
        )


def is_quarantined(storage: CheckpointStorage, ckpt_dir: str,
                   step: int) -> bool:
    return storage.exists(_quarantine_path(ckpt_dir, step))


def quarantine_reason(storage: CheckpointStorage, ckpt_dir: str,
                      step: int) -> Optional[str]:
    content = storage.read(_quarantine_path(ckpt_dir, step))
    return None if content is None else str(content)


def verify_step(storage: CheckpointStorage, ckpt_dir: str,
                step: int) -> Tuple[bool, str]:
    """Full integrity check of one persisted step: ``(ok, reason)``.

    Checks, in order of increasing cost: quarantine marker, shard metas
    decodable, gid coverage against the step's own ``global_shard_num``,
    done-file votes, and every block's length + checksum. Used by GC
    before trusting a step as a keeper; restore performs the same checks
    implicitly while reading."""
    if is_quarantined(storage, ckpt_dir, step):
        return False, "quarantined"
    metas = load_step_metas(storage, ckpt_dir, step)
    if not metas:
        return False, "no readable shard metas"
    expected = max(m.global_shard_num for m in metas.values())
    missing = sorted(set(range(expected)) - set(metas))
    if missing:
        return False, f"missing shard metas {missing} of {expected}"
    if count_done(storage, ckpt_dir, step) < expected:
        return False, "incomplete done votes"
    for gid, meta in sorted(metas.items()):
        algo = getattr(meta, "crc_algo", "")
        if getattr(meta, "stripes", None):
            # Striped format: parallel per-stripe verification over one
            # shared reader covers every persisted byte, including a
            # length check (a short stripe read is truncation). The
            # routed reader resolves referenced stripes through their
            # owner step's bin, so a step built incrementally only
            # verifies if every bin it references is intact too.
            reader = open_routed_reader(storage, ckpt_dir, step, gid, meta)
            if reader is None:
                return False, f"shard {gid} bin missing"
            try:
                verify_stripes(reader, meta, step, gid)
            except StepCorruptionError as e:
                return False, e.reason
            finally:
                reader.close()
            continue
        for t in meta.tensors:
            try:
                data = read_block(storage, ckpt_dir, step, gid, t, algo)
            except StepCorruptionError as e:
                return False, e.reason
            if data is None:
                return False, (
                    f"shard {gid} bin missing/truncated at block "
                    f"{t.path!r} (offset {t.offset}, {t.nbytes} bytes)"
                )
    return True, "ok"


def _step_shard_num(storage: CheckpointStorage, ckpt_dir: str,
                    step: int) -> int:
    """How many shards the step's own save wrote (from its metas) — NOT the
    current world size: reshard-on-restore means old steps may have been
    saved under a different world, and they are still complete."""
    d = step_dir(ckpt_dir, step)
    for name in storage.listdir(d):
        if (name.startswith(CheckpointConstant.SHARD_FILE_PREFIX)
                and name.endswith(".meta")):
            raw = storage.read_bytes(os.path.join(d, name))
            if raw is None:
                continue
            try:
                return int(ckpt_meta.loads(raw).global_shard_num)
            except Exception:  # a corrupt or foreign meta: try the next shard
                continue
    return 0


def gc_steps(storage: CheckpointStorage, ckpt_dir: str, keep_latest: int):
    """Drop old step dirs: keep the newest `keep_latest` *verified* dirs
    (all done files present judged against each step's OWN saved shard
    count, metas decodable, every block checksum-valid); delete every
    other dir at or below the tracker step — including torn partial saves
    from crash flushes, which otherwise leak multi-GB dirs forever. Dirs
    newer than the tracker are in-flight and never touched.

    The tracker step gets no free pass: if the published step turns out
    corrupt on disk, trusting it here would delete the older step that is
    in fact the newest restorable checkpoint — GC must never destroy the
    newest checksum-valid step just because garbage sits above it.
    Steps that fail verification are quarantined (so the verdict is
    cached and restore skips them too) and deleted like any other
    non-keeper. Verification walks newest-first and stops once
    `keep_latest` keepers are found, so old already-doomed dirs are not
    re-read before removal.

    Incremental-stripe liveness rule: a stripe is live while any kept
    step references it, so a step dir whose bin a keeper's stripes point
    into is *pinned* — it survives GC even when it falls outside the
    keep window (and even if independently quarantined: its bytes are
    still what makes the keeper restorable — the keeper's own routed
    verification already proved the referenced ranges intact)."""
    tracker = read_tracker(storage, ckpt_dir)
    if tracker is None or keep_latest <= 0:
        return
    candidates = [s for s in list_steps(storage, ckpt_dir) if s <= tracker]

    keep = set()
    for s in reversed(candidates):
        if len(keep) >= keep_latest:
            break
        if is_quarantined(storage, ckpt_dir, s):
            continue
        ok, reason = verify_step(storage, ckpt_dir, s)
        if ok:
            keep.add(s)
        else:
            quarantine_step(storage, ckpt_dir, s, f"gc verify: {reason}")
    # Pin every step a keeper references (closure-walked defensively,
    # though the writer flattens ref chains to the owner at persist).
    frontier = set(keep)
    pinned = set(keep)
    while frontier:
        refs = set()
        for s in frontier:
            for meta in load_step_metas(storage, ckpt_dir, s).values():
                refs |= step_refs(meta)
        frontier = refs - pinned
        pinned |= refs
    for s in candidates:
        if s not in pinned:
            storage.safe_remove(step_dir(ckpt_dir, s))
