"""Trainer-side flash-checkpoint engine — the port of
``dlrover_tpu/train/checkpoint/engine.py``.

The train state (``{"params", "opt", "step"}``) is staged, leaf by leaf
as the JAX train state flattens (``models/convert.train_state_leaves``),
into one POSIX shared-memory segment with the JAX engine's layout: each
leaf at a 128-byte aligned offset, its bytes those of the JAX leaf (a
stacked ``[L, ...]`` leaf is its layers' tensors one after another).
``ShardMeta``/``TensorMeta`` name the leaves by ``keystr`` path, so a
segment or a checkpoint directory of either package restores in the
other.

**Staging on the card.** The optimizers write params and state in place,
so a copy that runs beside the next step would race it. As the JAX
engine makes engine-owned copies (``_own_copies``), this one copies every
leaf, on the compute stream in the order of the step that made it, into
an engine-owned device buffer laid out as the segment (``_foreach_copy_``
once a dtype) and records an event. A side stream waits on the event and
copies the buffer into the segment's mapping, which is registered with
``cudaHostRegister`` once per layout, so the copy is a DMA that neither
stream nor host waits for; a staging thread waits on it (the wait
releases the interpreter lock) and publishes the meta. The copy goes in
chunks with pauses, so it takes a fifth of the host link's time: at the
full rate it stalls the step on the card for about as long as it runs. A snapshot asked for while one is in flight is skipped, and
counted.

**Restore** writes in place into the live tensors and returns
``(step, state)``: memory first (the segment, when its meta is whole and
no newer step is on disk), then disk (the tracker's step, stripes
verified, with the JAX engine's fallback chain and quarantine). On the
card the bytes go host → device buffer (from the registered mapping, or
through two pinned bounce buffers from disk) and then to the tensors.

**Agent mode**: when the agent's saver (``agent/ckpt_saver.py``, either
package's) serves the factory queue, the engine registers with it and
leaves persisting and crash flushes to it; standalone it persists
inline with the same two-phase commit, so the files are the same.

**Several processes.** On a mesh each leaf is this rank's blocks
(``models/convert.train_state_leaves``), each with its region of the
JAX leaf in global coordinates (``TensorMeta.index`` and
``global_shape``) and marked ``persist`` on the first replica only, so
a sharded state is written once across the ranks: one shard file each
(``ShardedCheckpointer``), or, for replicas of one shard
(``FlashCheckpointer``), the lowest replica as the writer (without a
master; the master's writer election and step vote come with the agent
slice, ROADMAP queue 1, item 3). A restore copies the blocks whose
region the template's block has, and assembles any other from the
saved blocks that overlap it (``_region_fill``): a checkpoint restores
under another topology. Blocks that do not cover the template raise
``TopologyMismatchError``, or ``ZeroDegreeMismatchError`` when the step
was saved under another ZeRO degree (``zero_degree``, stamped into every
``ShardMeta``; a ZeRO-1 state's optimizer slices are blocks of their
own on each data rank, ``accel/zero.py``). The chaos sites, ``ckpt.io``
events and the comms governor's staging deferral come with the chaos
and observability slice (ROADMAP queue 1, item 5).
"""

import concurrent.futures
import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common import (
    checksum,
    ckpt_meta,
    ckpt_persist,
    env_utils,
    fastcopy,
)
from dlrover_tpu_torch.common.backoff import poll_until
from dlrover_tpu_torch.common.ckpt_meta import (
    SaveEvent,
    SaverRegistration,
    ShardMeta,
    TensorMeta,
    ckpt_event_queue,
    ckpt_factory_queue,
    ckpt_lock_name,
    ckpt_meta_dict,
    ckpt_shm_name,
)
from dlrover_tpu_torch.common.comm import (
    SharedDict,
    SharedLock,
    SharedQueue,
    server_exists,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.shared_memory import SharedMemory
from dlrover_tpu_torch.common.storage import (
    CheckpointStorage,
    get_checkpoint_storage,
)
from dlrover_tpu_torch.models.convert import (
    StateLeaf,
    param_leaves,
    train_state_leaves,
)

_ALIGN = 128  # bytes; the JAX engine's alignment of each leaf
_D2H_CHUNK = 64 << 20  # bytes a copy from the device buffer to the segment
#: Share of the time the copy to the segment may take the card's host
#: link. A copy of GBs at the link's full rate leaves the card idle for
#: about as long as it runs (``staging_probe.py``, on an H100: +7-25% a
#: 124M step, +15-45% at 1.5B, with no more kernel time); at a fifth, a
#: 124M step pays about 1% and a snapshot goes every two or three steps.
_D2H_DUTY = 0.2
_BOUNCE = 256 << 20  # bytes of each pinned buffer of a disk restore

#: ``TensorMeta.dtype`` (numpy's name, as the JAX engine writes it) of
#: each torch dtype. The bytes move as uint8, so no bfloat16 numpy type
#: is needed.
DTYPE_NAMES = {
    torch.bfloat16: "bfloat16", torch.float16: "float16",
    torch.float32: "float32", torch.float64: "float64",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _flatten_state(state, cache: Optional[Dict] = None
                   ) -> Tuple[List[StateLeaf], Dict[str, Any]]:
    """The state's leaves (paths, shapes, dtypes and the tensors that hold
    them) in the JAX engine's order, and its non-array objects (none:
    the port's scalars are int32 leaves, as JAX's are). ``cache`` keeps
    the grouping of the params into JAX leaves while their names and
    shapes stay (it is most of the host time of a snapshot)."""
    params = state["params"]
    groups = None
    if cache is not None:
        key = tuple((n, p.shape) for n, p in params.items())
        if cache.get("key") != key:
            cache["key"] = key
            cache["groups"] = param_leaves(params)
        groups = cache["groups"]
    return train_state_leaves(state, groups=groups), {}


def _nbytes(leaf: StateLeaf) -> int:
    if leaf.members:
        return sum(m.numel() * m.element_size() for m in leaf.members)
    return 4  # an int32 host scalar


class _Plan:
    """One layout of the segment: each leaf's ``TensorMeta`` (offset,
    size, dtype, shape), where each member tensor lies, and, on the card,
    the engine-owned device buffer laid out the same way."""

    def __init__(self, leaves: List[StateLeaf], persist_all: bool = False):
        self.key = _layout_key(leaves)
        self.metas: List[TensorMeta] = []
        self.spans: List[Tuple[int, int, torch.dtype, tuple]] = []
        self.scalars: List[Tuple[int, int]] = []  # (leaf index, offset)
        offset = 0
        for i, leaf in enumerate(leaves):
            nbytes = _nbytes(leaf)
            self.metas.append(TensorMeta(
                path=leaf.path, offset=offset, nbytes=nbytes,
                dtype=DTYPE_NAMES[leaf.dtype], shape=tuple(leaf.shape),
                global_shape=leaf.global_shape, index=leaf.index,
                persist=persist_all or leaf.persist))
            if leaf.members:
                at = offset
                for m in leaf.members:
                    n = m.numel() * m.element_size()
                    self.spans.append((at, n, m.dtype, tuple(m.shape)))
                    at += n
            else:
                self.scalars.append((i, offset))
            offset += _aligned(nbytes)
        self.used = offset
        # The state's card; leaves an offloaded optimizer keeps in host
        # memory between steps may lie beside it on the CPU.
        members = [m for leaf in leaves for m in leaf.members]
        cards = {m.device for m in members if m.device.type != "cpu"}
        if len(cards) > 1:
            raise ValueError(f"the train state spans devices {cards}")
        self.device = cards.pop() if cards else torch.device("cpu")
        # Member indices by dtype and place: one foreach copy each.
        self.groups: Dict[tuple, List[int]] = {}
        for j, ((_, _, dtype, _), m) in enumerate(zip(self.spans, members)):
            self.groups.setdefault((dtype, m.device.type), []).append(j)
        self._stage: Optional[torch.Tensor] = None
        self._stage_views: List[torch.Tensor] = []

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Each member's typed view into a uint8 buffer of this layout."""
        return [buf[off:off + n].view(dtype).view(shape)
                for off, n, dtype, shape in self.spans]

    @property
    def stage(self) -> torch.Tensor:
        """The engine-owned device buffer (made at first use)."""
        if self._stage is None:
            self._stage = torch.empty(self.used, dtype=torch.uint8,
                                      device=self.device)
            self._stage_views = self.views(self._stage)
        return self._stage

    @property
    def stage_views(self) -> List[torch.Tensor]:
        self.stage  # noqa: B018 -- made with the buffer
        return self._stage_views


def _layout_key(leaves: List[StateLeaf]) -> tuple:
    return tuple((leaf.path, leaf.dtype, tuple(leaf.shape), leaf.index,
                  leaf.persist, tuple(m.numel() for m in leaf.members))
                 for leaf in leaves)


def _members(leaves: List[StateLeaf]) -> List[torch.Tensor]:
    return [m for leaf in leaves for m in leaf.members]


def _copy_groups(plan: _Plan, dst: List[torch.Tensor],
                 src: List[torch.Tensor]):
    """``dst[i].copy_(src[i])`` for every member, one foreach call a
    dtype and place (a foreach copy takes its fast path only within one
    dtype and device); a member in host memory beside a state on the card
    is copied on its own, in stream order; outside autograd, as the
    members include the parameters."""
    with torch.no_grad():
        for idx in plan.groups.values():
            d, s = [dst[i] for i in idx], [src[i] for i in idx]
            if d[0].device == s[0].device:
                torch._foreach_copy_(d, s)
                continue
            for a, b in zip(d, s):
                a.copy_(b, non_blocking=True)


class CheckpointEngine:
    """Stage one process's train state into shared memory; persist it to
    ``checkpoint_dir`` and restore it, in the JAX engine's format."""

    def __init__(
        self,
        checkpoint_dir: str,
        global_shard_id: int = 0,
        global_shard_num: int = 1,
        persist_shard: bool = True,
        storage: Optional[CheckpointStorage] = None,
        keep_latest: int = 3,
        job: str = "",
        replica_rank: int = 0,
        replica_count: int = 1,
        mesh_axes: Optional[Dict[str, int]] = None,
        zero_degree: int = 0,
    ):
        self.checkpoint_dir = checkpoint_dir
        self.global_shard_id = global_shard_id
        self.global_shard_num = global_shard_num
        self.persist_shard = persist_shard
        # Replicas of one shard persist it once: the lowest replica writes
        # (the master's writer election comes with the agent slice).
        self.replica_rank = int(replica_rank)
        self.replica_count = int(replica_count)
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        # The data degree the optimizer state is ZeRO-sliced over (0: not
        # sliced), stamped into every ShardMeta. Data ranks are replicas
        # of the parameters but not of their slices, so one shard written
        # by the lowest replica would drop the others' slices.
        self.zero_degree = int(zero_degree)
        if self.zero_degree > 1 and global_shard_num == 1 \
                and self.replica_count > 1:
            raise ValueError(
                f"a ZeRO state (zero_degree={self.zero_degree}) differs "
                "across data ranks: give each process a shard of its own "
                "(ShardedCheckpointer), not one shard its replicas share")
        self.storage = get_checkpoint_storage(storage)
        self.keep_latest = keep_latest
        self._job = job or env_utils.JOB_NAME.get()
        self._local_rank = env_utils.LOCAL_RANK.get()
        self._node_rank = env_utils.NODE_RANK.get()
        self._local_world = env_utils.LOCAL_WORLD_SIZE.get()

        self._shm: Optional[SharedMemory] = None
        self._shm_host: Optional[torch.Tensor] = None  # uint8 over the map
        self._registered: Optional[Tuple[int, int]] = None  # (ptr, size)
        self._shm_name = ckpt_shm_name(
            self._job, self._node_rank, self._local_rank
        )
        self._layout_version = 0
        self._plan: Optional[_Plan] = None
        self._groups: Dict[str, Any] = {}  # _flatten_state's cache
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self._link_rate: Optional[float] = None  # bytes/s, last snapshot
        # One staging thread, at most one snapshot in flight.
        self._stage_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-stage"
        )
        self._staging: Optional[concurrent.futures.Future] = None
        # Every request takes a generation; the segment write and the
        # meta publish happen under _write_mutex, and a request that a
        # newer one overtook is dropped.
        self._write_mutex = threading.Lock()
        self._gen_lock = threading.Lock()
        self._next_gen = 0
        self._done_gen = 0
        #: ``save_to_memory_async``: calls, skips (a staging was in
        #: flight), snapshots published, the ms of each started call on
        #: the caller's thread; and the seconds of each cudaHostRegister.
        self.stats: Dict[str, Any] = {
            "requested": 0, "skipped": 0, "staged": 0, "host_ms": [],
            "register_s": [],
        }
        #: One entry a published snapshot: ``step``, ``copy_ms`` and
        #: ``d2h_ms`` (device time of the copy into the device buffer and
        #: of the copies to the segment; on the card, with the span from
        #: the first chunk's start to the last one's end, ``d2h_wall_ms``,
        #: and its timing events, ``d2h_events``), ``bytes``,
        #: ``publish_s`` (call to published meta).
        self.stage_log: collections.deque = collections.deque(maxlen=4096)
        self.last_persist_stats: Dict[str, float] = {}
        self._restore_stats: Dict[str, Any] = {}

        self.agent_mode = server_exists(
            "queue", ckpt_factory_queue(self._node_rank), self._job
        )
        if self.agent_mode:
            self._register_with_agent()
            self._lock = SharedLock(
                ckpt_lock_name(self._node_rank, self._local_rank),
                create=False, job=self._job,
            )
            self._meta = SharedDict(
                ckpt_meta_dict(self._node_rank), create=False, job=self._job
            )
            self._events = SharedQueue(
                ckpt_event_queue(self._node_rank), create=False, job=self._job
            )
            logger.info("checkpoint engine in agent mode (shm %s)",
                        self._shm_name)
        else:
            self._lock = None
            self._meta_local: Dict[str, bytes] = {}
            logger.info("checkpoint engine in standalone mode (shm %s)",
                        self._shm_name)

    # ------------- agent handshake -------------
    def _register_with_agent(self):
        factory = SharedQueue(
            ckpt_factory_queue(self._node_rank), create=False, job=self._job
        )
        factory.put(
            SaverRegistration(
                class_name="CommonDirCheckpointSaver",
                checkpoint_dir=self.checkpoint_dir,
                local_shard_num=self._local_world,
                global_shard_num=self.global_shard_num,
                node_rank=self._node_rank,
                is_committer=self._node_rank == 0,
                keep_latest=self.keep_latest,
            )
        )

    @property
    def shm_name(self) -> str:
        return self._shm_name

    @property
    def registered(self) -> bool:
        """Whether the segment's mapping is registered with CUDA (page-
        locked, so copies to and from it are asynchronous DMAs)."""
        return self._registered is not None

    # ------------- staging -------------
    def _layout(self, leaves: List[StateLeaf]) -> _Plan:
        """The segment's layout for ``leaves`` (its ``TensorMeta``s and
        used bytes), kept while the leaves' paths, dtypes and sizes stay."""
        key = _layout_key(leaves)
        if self._plan is None or self._plan.key != key:
            self._plan = None  # free the old device buffer first
            # One shard: it is persisted whole, by the replica that owns
            # it (the JAX engine's rule for a replicated layout).
            self._plan = _Plan(leaves,
                               persist_all=self.global_shard_num == 1)
        return self._plan

    def _snapshot(self, state):
        """``(plan, leaves, events)``: the state's layout and leaves and,
        on the card, the events around the copy of every leaf into the
        engine-owned device buffer (None on the CPU, whose leaves the
        caller copies before the next step runs)."""
        leaves, _ = _flatten_state(state, self._groups)
        plan = self._layout(leaves)
        if plan.device.type != "cuda":
            return plan, leaves, None
        return plan, leaves, self._own_copies(plan, leaves)

    def _own_copies(self, plan: _Plan, leaves: List[StateLeaf]):
        """Copy every leaf into the device buffer on the current (compute)
        stream; returns its (start, end) timing events."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=plan.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _copy_groups(plan, plan.stage_views, _members(leaves))
        end.record()
        return start, end

    def _fetch(self, plan: _Plan, events, host: torch.Tensor,
               duty: float) -> Dict:
        """Copy the device buffer into the segment on the side stream, in
        chunks. The stream waits on the event of the copy that filled the
        buffer, and so does this thread; it then enqueues each chunk when
        the link, at the rate measured on the last snapshot, would have
        spent ``duty`` of the time since on the chunks before it, and
        waits once, for the last. The first snapshot (no rate yet), and a
        synchronous save (duty 1), go at the full rate."""
        start, copied = events
        stream = self._copy_stream
        stream.wait_event(copied)
        _wait(copied)
        rate = self._link_rate * duty if self._link_rate else None
        t0 = time.perf_counter()
        marks = []
        with torch.cuda.device(plan.device), torch.cuda.stream(stream):
            for off in range(0, plan.used, _D2H_CHUNK):
                n = min(_D2H_CHUNK, plan.used - off)
                if rate and duty < 1.0:
                    time.sleep(max(0.0, t0 + off / rate - time.perf_counter()))
                c0 = torch.cuda.Event(enable_timing=True)
                c1 = torch.cuda.Event(enable_timing=True)
                c0.record(stream)
                host[off:off + n].copy_(plan.stage[off:off + n],
                                        non_blocking=True)
                c1.record(stream)
                marks.append((c0, c1))
        _wait(marks[-1][1])
        busy_ms = sum(c0.elapsed_time(c1) for c0, c1 in marks)
        self._link_rate = plan.used / (busy_ms / 1e3)
        first, last = marks[0][0], marks[-1][1]
        return {"copy_ms": start.elapsed_time(copied), "d2h_ms": busy_ms,
                "d2h_wall_ms": first.elapsed_time(last),
                "bytes": plan.used, "d2h_events": (first, last)}

    def _fill_host(self, plan: _Plan, leaves: List[StateLeaf],
                   host: torch.Tensor) -> Dict:
        """CPU tensors straight into the segment."""
        _copy_groups(plan, plan.views(host), _members(leaves))
        return {"bytes": plan.used}

    def _ensure_shm(self, plan: _Plan, create: bool = True):
        """A segment of at least ``plan.used`` bytes, mapped (and, for a
        state on the card, registered with CUDA). ``create=False`` (a
        restore) maps the segment that exists, whatever its size, and
        never replaces it."""
        needed = plan.used
        if self._shm is None or (create and self._shm.size < needed):
            self._release_shm()
            shm = None
            if SharedMemory.exists(self._shm_name):
                try:
                    shm = SharedMemory(self._shm_name)
                    if create and shm.size < needed:
                        shm.close()
                        shm = None
                except (ValueError, OSError):
                    shm = None
            if shm is None and not create:
                raise FileNotFoundError(
                    f"no checkpoint segment {self._shm_name}")
            if shm is None:
                # Slack so steady-state training never recreates it.
                size = _aligned(int(needed * 1.1) + 4096)
                SharedMemory.remove(self._shm_name)
                shm = SharedMemory(self._shm_name, create=True, size=size)
                self._layout_version += 1
                logger.info("created checkpoint shm %s (%.1f MB)",
                            self._shm_name, size / 1e6)
            self._shm = shm
            self._shm_host = torch.frombuffer(shm.buf, dtype=torch.uint8)
        if plan.device.type == "cuda" and self._registered is None:
            self._register(plan.device)

    def _register(self, device: torch.device):
        """Page-lock the mapping for the card (pins and touches every
        page: seconds for GBs, once a layout). Raises when CUDA refuses:
        copies from pageable memory would hold up the loop."""
        host = self._shm_host
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            err = torch.cuda.cudart().cudaHostRegister(
                host.data_ptr(), host.numel(), 0)
        if int(err) != 0:
            raise RuntimeError(
                f"cudaHostRegister of the checkpoint segment "
                f"{self._shm_name} ({host.numel()} bytes) failed: {err}"
            )
        self._registered = (host.data_ptr(), host.numel())
        if not host.is_pinned():
            raise RuntimeError(
                "the registered checkpoint segment does not read as pinned")
        self.stats["register_s"].append(time.perf_counter() - t0)

    def _release_shm(self):
        if self._registered is not None:
            torch.cuda.cudart().cudaHostUnregister(self._registered[0])
            self._registered = None
        self._shm_host = None
        if self._shm is not None:
            self._shm.close()
            self._shm = None

    def save_to_memory(self, step: int, state, block: bool = False) -> bool:
        """Stage `state` into the segment and return when it is published.
        With ``block=False`` a snapshot the agent's saver holds the lock
        of (it is persisting the segment) is skipped instead of waited
        for; DISK saves pass ``block=True``."""
        self.wait_staged()
        t0 = time.perf_counter()
        gen = self._take_gen()
        plan, leaves, events = self._snapshot(state)
        return self._write_snapshot(
            step, plan, self._filler(plan, leaves, events, duty=1.0),
            _scalars(leaves), block, gen, t0)

    def save_to_memory_async(self, step: int, state) -> bool:
        """Start a memory snapshot and return: the copy into the device
        buffer is enqueued on the compute stream, a staging thread
        finishes the copy to the segment and publishes the meta. Returns
        False (skipped, and counted) while a staging is in flight. On the
        CPU the snapshot is written before this returns."""
        self.stats["requested"] += 1
        if self._staging is not None and not self._staging.done():
            self.stats["skipped"] += 1
            return False
        t0 = time.perf_counter()
        gen = self._take_gen()
        plan, leaves, events = self._snapshot(state)
        args = (step, plan, self._filler(plan, leaves, events),
                _scalars(leaves), True, gen, t0)
        if events is None:
            self._staging = concurrent.futures.Future()
            self._staging.set_result(self._write_snapshot(*args))
        else:
            self._staging = self._stage_pool.submit(self._stage_async, *args)
        self.stats["host_ms"].append((time.perf_counter() - t0) * 1e3)
        return True

    def _filler(self, plan, leaves, events, duty: Optional[float] = None
                ) -> Callable[[torch.Tensor], Dict]:
        duty = _D2H_DUTY if duty is None else duty
        if events is None:
            return lambda host: self._fill_host(plan, leaves, host)
        return lambda host: self._fetch(plan, events, host, duty)

    def _stage_async(self, *args) -> bool:
        step = args[0]
        try:
            ok = self._write_snapshot(*args)
        except Exception:
            # Nobody may read this future: say it loudly.
            logger.exception("async memory snapshot of step %s FAILED to "
                             "stage", step)
            return False
        if not ok:
            logger.warning("async memory snapshot of step %s was not staged",
                           step)
        return ok

    def wait_staged(self, timeout: float = 600.0) -> bool:
        """Join an in-flight async staging (no-op when none pending)."""
        if self._staging is None:
            return True
        try:
            return bool(self._staging.result(timeout=timeout))
        except Exception:
            logger.exception("async checkpoint staging failed")
            return False

    def _take_gen(self) -> int:
        with self._gen_lock:
            self._next_gen += 1
            return self._next_gen

    def _superseded(self, gen: int) -> bool:
        with self._gen_lock:
            return gen <= self._done_gen

    def _write_snapshot(self, step: int, plan: _Plan,
                        fill: Callable[[torch.Tensor], Dict],
                        scalars: Dict[int, int], block: bool, gen: int,
                        t0: float) -> bool:
        with self._write_mutex:
            if self._superseded(gen):
                logger.info("memory snapshot of step %s superseded; dropped",
                            step)
                return False
            if self._lock is not None and not self._lock.acquire(
                blocking=block, timeout=30.0 if block else -1
            ):
                logger.warning("skip memory save at step %s: saver holds "
                               "the shard lock", step)
                return False
            try:
                self._ensure_shm(plan)
                host = self._shm_host
                info = fill(host)
                for i, off in plan.scalars:
                    host[off:off + 4].view(torch.int32)[0] = scalars[i]
                self._shm.flush()
                self._publish_meta(ShardMeta(
                    step=step, shm_name=self._shm_name, used_bytes=plan.used,
                    tensors=plan.metas, objects={},
                    global_shard_id=self.global_shard_id,
                    global_shard_num=self.global_shard_num,
                    # The agent's saver persists every local shard whose
                    # meta says so: a replica that does not write says no.
                    persist=self._persist_owner(),
                    layout_version=self._layout_version,
                    zero_degree=self.zero_degree,
                    mesh_axes=self.mesh_axes,
                ))
                with self._gen_lock:
                    self._done_gen = max(self._done_gen, gen)
                self.stats["staged"] += 1
                info.update(step=step, publish_s=time.perf_counter() - t0)
                self.stage_log.append(info)
                return True
            finally:
                if self._lock is not None:
                    self._lock.release()

    def _publish_meta(self, shard_meta: ShardMeta):
        raw = ckpt_meta.dumps(shard_meta)
        if self.agent_mode:
            self._meta.set(f"rank_{self._local_rank}", raw)
        else:
            self._meta_local[f"rank_{self._local_rank}"] = raw

    def save_to_storage(self, step: int, state) -> bool:
        """Memory save, then the agent's asynchronous persist (agent mode)
        or an inline one (standalone)."""
        if not self.save_to_memory(step, state, block=True):
            return False
        if self.agent_mode:
            if self._local_rank == 0:
                self._events.put(SaveEvent(step=step))
            return True
        if not self._persist_owner():
            return True
        return self._persist_inline(step)

    def _persist_owner(self) -> bool:
        """Whether this process writes its shard: ``persist_shard``, and,
        among replicas of one shard, the lowest replica rank (the JAX
        engine's rule without a master)."""
        return self.persist_shard and (self.replica_count <= 1
                                       or self.replica_rank == 0)

    def _persist_inline(self, step: int) -> bool:
        """Write this shard; shard 0 then waits for every shard's done
        file and commits the step."""
        meta = ckpt_meta.loads(self._meta_local[f"rank_{self._local_rank}"])
        self.last_persist_stats = ckpt_persist.persist_shard(
            self.storage, self.checkpoint_dir, meta, self._shm.buf
        )
        if self.global_shard_id != 0:
            return True
        ok = ckpt_persist.commit_step(
            self.storage, self.checkpoint_dir, step, self.global_shard_num,
        )
        if ok:
            ckpt_persist.gc_steps(
                self.storage, self.checkpoint_dir, self.keep_latest
            )
        return ok

    # ------------- restore -------------
    def _memory_meta(self) -> Optional[ShardMeta]:
        raw = (
            self._meta.get(f"rank_{self._local_rank}")
            if self.agent_mode
            else self._meta_local.get(f"rank_{self._local_rank}")
        )
        if not raw:
            return None
        try:
            return ckpt_meta.loads(raw)
        except Exception:
            logger.exception("undecodable memory snapshot meta")
            return None

    def load(self, template) -> Tuple[int, Any]:
        """Restore ``(step, state)`` in place into ``template``'s tensors
        (the live train state): the memory snapshot when its meta is whole
        and no newer step is committed on disk, else the newest intact
        step on disk. Returns ``(-1, template)`` when nothing restores. A
        leaf the checkpoint lacks, or holds with another shape or dtype,
        raises ``KeyError`` (the model changed); nothing falls back past
        that. Phase times land in ``last_restore_stats``."""
        self.wait_staged(60.0)
        self._reset_restore_stats()
        t0 = time.perf_counter()
        leaves, _ = _flatten_state(template, self._groups)
        plan = self._layout(leaves)
        meta = self._memory_meta()
        if meta is not None and meta.step >= 0 and \
                SharedMemory.exists(self._shm_name):
            tracker = ckpt_persist.read_tracker(self.storage,
                                                self.checkpoint_dir)
            if tracker is not None and tracker > meta.step:
                logger.info("memory snapshot of step %s is older than the "
                            "committed step %s; restoring from storage",
                            meta.step, tracker)
            else:
                try:
                    copies, built = _match({0: meta.tensors}, plan)
                    with self._write_mutex:
                        t_reg = time.perf_counter()
                        self._ensure_shm(plan, create=False)
                        self._restore_stats["register_s"] = (
                            time.perf_counter() - t_reg)
                        if meta.used_bytes > self._shm.size:
                            raise ValueError(
                                f"snapshot of {meta.used_bytes} bytes in a "
                                f"{self._shm.size}-byte segment")
                        host = self._shm_host

                        def fill(buf):
                            self._copy_in(host, [c[1:] for c in copies], buf)
                            _put_built(buf, built, lambda _, off, n: (
                                host[off:off + n].numpy()))

                        self._rebuild(plan, leaves, fill)
                    self._finish_restore_stats("memory", plan.used, t0)
                    self._restore_stats["step"] = meta.step
                    logger.info("restored step %s from memory (%s)",
                                meta.step, self._restore_stats)
                    return meta.step, template
                except _CoverGap:
                    logger.info("the memory snapshot's blocks do not cover "
                                "this topology's; restoring from storage")
                except KeyError:
                    raise
                except Exception:
                    logger.exception("memory restore failed; trying storage")
        return self._load_from_storage(template, plan, leaves)

    def _load_from_storage(self, template, plan: _Plan,
                           leaves: List[StateLeaf]) -> Tuple[int, Any]:
        """The tracker's step first, then older step directories: a step
        found missing, torn or corrupt is quarantined and skipped, so a
        damaged newest checkpoint costs one interval, never the run."""
        tracker = ckpt_persist.read_tracker(self.storage, self.checkpoint_dir)
        steps = ckpt_persist.list_steps(self.storage, self.checkpoint_dir)
        candidates = ([s for s in steps if s <= tracker]
                      if tracker is not None else steps)
        skipped: List[Tuple[int, str]] = []
        for step in reversed(candidates):
            if ckpt_persist.is_quarantined(
                self.storage, self.checkpoint_dir, step
            ):
                skipped.append((step, "quarantined"))
                continue
            self._reset_restore_stats()
            t0 = time.perf_counter()
            try:
                nbytes = self._restore_step(plan, leaves, step)
            except ckpt_persist.StepCorruptionError as e:
                ckpt_persist.quarantine_step(
                    self.storage, self.checkpoint_dir, step, e.reason
                )
                skipped.append((step, e.reason))
                continue
            self._finish_restore_stats("storage", nbytes, t0)
            s = self._restore_stats
            s["step"] = step
            s["skipped"] = list(skipped)
            if skipped:
                s["fallback_from"], s["fallback_reason"] = skipped[0]
            logger.info("restored step %s from storage (%s)", step, s)
            return step, template
        if skipped:
            logger.error("no restorable checkpoint in %s; every candidate "
                         "was damaged: %s", self.checkpoint_dir, skipped)
            self._restore_stats["skipped"] = list(skipped)
        return -1, template

    def _restore_step(self, plan: _Plan, leaves: List[StateLeaf],
                      step: int) -> int:
        """Rebuild the state from one persisted step, every shard's
        stripes (or legacy blocks) verified first. Raises
        ``StepCorruptionError`` when the step is broken, and
        ``ZeroDegreeMismatchError`` (saved under another ZeRO degree) or
        ``TopologyMismatchError`` when its blocks do not cover the
        template's."""
        metas = ckpt_persist.load_step_metas(
            self.storage, self.checkpoint_dir, step
        )
        if not metas:
            raise ckpt_persist.StepCorruptionError(
                step, "no readable shard metas")
        expected = max(m.global_shard_num for m in metas.values())
        missing = sorted(set(range(expected)) - set(metas))
        if missing:
            raise ckpt_persist.StepCorruptionError(
                step, f"missing shard metas {missing} of {expected}")
        try:
            copies, built = _match({g: m.tensors for g, m in metas.items()},
                                   plan)
        except _CoverGap as e:
            saved_zero = max((getattr(m, "zero_degree", 0)
                              for m in metas.values()), default=0)
            if saved_zero != self.zero_degree:
                # Optimizer slices saved under one data degree restored
                # under another: not corruption, so no older step either.
                raise ckpt_persist.ZeroDegreeMismatchError(
                    step, saved_zero, self.zero_degree, str(e)) from e
            saved_axes = next((m.mesh_axes for m in metas.values()
                               if getattr(m, "mesh_axes", None)), None)
            raise ckpt_persist.TopologyMismatchError(
                step, saved_axes, self.mesh_axes, str(e)) from e
        readers: Dict[int, Any] = {}
        try:
            for gid in sorted(metas):
                meta = metas[gid]
                if not meta.tensors:
                    continue
                reader = ckpt_persist.open_routed_reader(
                    self.storage, self.checkpoint_dir, step, gid, meta
                )
                if reader is None:
                    raise ckpt_persist.StepCorruptionError(
                        step, f"shard {gid} bin missing")
                readers[gid] = reader
                t_v0 = time.perf_counter()
                ckpt_persist.verify_stripes(reader, meta, step, gid)
                _verify_blocks(reader, meta, step, gid)
                self._restore_stats["verify_s"] += time.perf_counter() - t_v0

            def read(gid, off, n):
                raw = readers[gid].read(off, n)
                if len(raw) != n:
                    raise ckpt_persist.StepCorruptionError(
                        step, f"missing/truncated block at offset {off} "
                        f"({n} bytes) in shard {gid}")
                return np.frombuffer(raw, dtype=np.uint8)

            def fill(buf):
                self._read_in(readers, copies, buf, step)
                _put_built(buf, built, read)

            self._rebuild(plan, leaves, fill)
        finally:
            for reader in readers.values():
                reader.close()
        return sum(t.nbytes for t in plan.metas)

    def _copy_in(self, host: torch.Tensor, segs, buf: torch.Tensor):
        """Segment bytes into ``buf``: one copy when the snapshot's layout
        is this one (from the registered mapping, on the card), else one
        per leaf."""
        if not segs:
            return
        if all(src == dst for src, dst, _ in segs):
            end = max(dst + n for _, dst, n in segs)
            buf[:end].copy_(host[:end], non_blocking=True)
            return
        for src, dst, n in segs:
            buf[dst:dst + n].copy_(host[src:src + n], non_blocking=True)

    def _read_in(self, readers, segs, buf: torch.Tensor, step: int):
        """File bytes into ``buf`` (``segs``: shard, file offset, layout
        offset, bytes each): straight into a CPU buffer, or through two
        pinned buffers in turns into the device buffer."""
        if not segs:
            return

        def read(piece):
            dst_view, gid, src, n = piece
            if readers[gid].read_into(src, dst_view) != n:
                raise ckpt_persist.StepCorruptionError(
                    step, f"missing/truncated block at offset {src} "
                    f"({n} bytes) in shard {gid}")

        if buf.device.type == "cpu":
            arr = buf.numpy()
            fastcopy.parallel_map(read, [(arr[dst:dst + n], gid, src, n)
                                         for gid, src, dst, n in segs])
            return
        bounce = [torch.empty(_BOUNCE, dtype=torch.uint8, pin_memory=True)
                  for _ in range(2)]
        done: List[Optional[torch.cuda.Event]] = [None, None]
        used = max(dst + n for _, _, dst, n in segs)
        for k, w0 in enumerate(range(0, used, _BOUNCE)):
            w1 = min(w0 + _BOUNCE, used)
            turn = k % 2
            if done[turn] is not None:
                done[turn].synchronize()
            arr = bounce[turn].numpy()
            pieces = []
            for gid, src, dst, n in segs:
                lo, hi = max(dst, w0), min(dst + n, w1)
                if lo < hi:
                    pieces.append((arr[lo - w0:hi - w0], gid, src + lo - dst,
                                   hi - lo))
            fastcopy.parallel_map(read, pieces)
            buf[w0:w1].copy_(bounce[turn][:w1 - w0], non_blocking=True)
            done[turn] = torch.cuda.Event()
            done[turn].record()
        torch.cuda.current_stream(buf.device).synchronize()

    def _rebuild(self, plan: _Plan, leaves: List[StateLeaf],
                 fill: Callable[[torch.Tensor], None]):
        """Fill a buffer of the layout (the device buffer on the card, a
        host one on the CPU) by ``fill``, then copy each leaf from it into
        the template's tensors, in place, and set its host scalars."""
        cuda = plan.device.type == "cuda"
        buf = plan.stage if cuda else torch.empty(plan.used,
                                                  dtype=torch.uint8)
        t0 = time.perf_counter()
        fill(buf)
        if cuda:
            torch.cuda.current_stream(plan.device).synchronize()
        self._restore_stats["read_s"] += time.perf_counter() - t0
        views = plan.stage_views if cuda else plan.views(buf)
        _copy_groups(plan, _members(leaves), views)
        for i, off in plan.scalars:
            leaves[i].assign(int(buf[off:off + 4].view(torch.int32)[0]))
        if cuda:
            torch.cuda.current_stream(plan.device).synchronize()

    def memory_leaves(self) -> Tuple[int, Dict[str, torch.Tensor]]:
        """``(step, {path: uint8 view})`` of the published memory snapshot
        (``(-1, {})`` without one): each leaf's bytes in the mapped
        segment, for checks that hold a snapshot to the state it was
        taken of. The views alias the segment: read them, and drop them
        before ``close``."""
        self.wait_staged()
        meta = self._memory_meta()
        if meta is None or self._shm_host is None:
            return -1, {}
        host = self._shm_host
        return meta.step, {t.path: host[t.offset:t.offset + t.nbytes]
                           for t in meta.tensors}

    # ------------- restore attribution -------------
    @property
    def last_restore_stats(self) -> Dict[str, Any]:
        """The last ``load``: ``source`` ("memory" or "storage"), ``step``,
        ``bytes``, ``total_s``, ``register_s`` (mapping and registering
        the segment, memory), ``read_s`` (bytes into the layout's buffer),
        ``verify_s`` (stripe checksums), ``scatter_s`` (the rest: buffer
        to tensors) and the fallback chain (``skipped``,
        ``fallback_from``, ``fallback_reason``)."""
        return dict(self._restore_stats)

    def _reset_restore_stats(self):
        self._restore_stats = {
            "source": None, "read_s": 0.0, "verify_s": 0.0,
            "register_s": 0.0, "scatter_s": 0.0, "total_s": 0.0,
            "bytes": 0, "step": -1,
            "skipped": [], "fallback_from": None, "fallback_reason": None,
        }

    def _finish_restore_stats(self, source: str, nbytes: int, t0: float):
        s = self._restore_stats
        s["source"] = source
        s["bytes"] = int(nbytes)
        s["total_s"] = time.perf_counter() - t0
        s["scatter_s"] = max(0.0, s["total_s"] - s["read_s"] - s["verify_s"]
                             - s["register_s"])

    # ------------- misc -------------
    def wait_persisted(self, step: int, timeout: float = 120.0) -> bool:
        """Block until a step >= `step` is committed in storage."""

        def committed() -> bool:
            tracker = ckpt_persist.read_tracker(
                self.storage, self.checkpoint_dir
            )
            return tracker is not None and tracker >= step

        return poll_until(committed, timeout, initial=0.05, max_delay=1.0)

    def close(self):
        done = self.wait_staged(30.0)
        self._stage_pool.shutdown(wait=False)
        if self._staging is not None and not self._staging.done():
            # A wedged staging thread still owns the segment.
            logger.warning("checkpoint staging still in flight at close; "
                           "leaving shm mapped (done=%s)", done)
            return
        with self._write_mutex:
            self._release_shm()
            self._plan = None


def _wait(event: torch.cuda.Event):
    """Wait for ``event`` by polling, which leaves the host's cores to the
    loop (a blocking wait may spin one); ``staging_probe.py`` measured
    the two level."""
    while not event.query():
        time.sleep(0.0002)


def _scalars(leaves: List[StateLeaf]) -> Dict[int, int]:
    """Host scalar values by leaf index, as of the call."""
    return {i: leaf.value for i, leaf in enumerate(leaves)
            if not leaf.members}


class _CoverGap(KeyError):
    """The saved blocks of a leaf do not cover a block of the template."""


_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_ITEMSIZE = {name: torch.empty((), dtype=dt).element_size()
             for dt, name in DTYPE_NAMES.items()}


def _global_shape(t: TensorMeta) -> Tuple[int, ...]:
    return tuple(int(d) for d in (t.global_shape if t.global_shape is not None
                                  else t.shape))


def _region(t: TensorMeta) -> Tuple[Tuple[int, int], ...]:
    """A block's region of its leaf (the whole leaf when it has no
    index)."""
    if t.index is None:
        return tuple((0, d) for d in _global_shape(t))
    return tuple((int(a), int(b)) for a, b in t.index)


def _overlap(a, b):
    out = []
    for (s0, e0), (s1, e1) in zip(a, b):
        s, e = max(s0, s1), min(e0, e1)
        if s >= e:
            return None
        out.append((s, e))
    return tuple(out)


def _size(region) -> int:
    return int(np.prod([e - s for s, e in region])) if region else 1


def _match(saved: Dict[int, List[TensorMeta]], plan: _Plan):
    """How each block of ``plan`` comes from saved blocks (by source: one
    segment, or each shard of a step): ``copies`` ``(source, saved
    offset, layout offset, bytes)`` for a block saved with the same
    region, and ``built`` ``(layout offset, wanted meta, [(source, saved
    meta)])`` for one assembled from the saved blocks that overlap it. A
    leaf missing, or saved with another global shape or dtype, raises
    ``KeyError`` (the model changed); blocks that do not cover a wanted
    block raise ``_CoverGap``."""
    catalog: Dict[str, List[Tuple[int, TensorMeta]]] = {}
    for src in sorted(saved):
        for t in saved[src]:
            catalog.setdefault(t.path, []).append((src, t))
    copies, built = [], []
    for want in plan.metas:
        have = catalog.get(want.path)
        if not have:
            raise KeyError(f"checkpoint is missing leaf {want.path}; model "
                           "definition changed since the snapshot")
        shape = _global_shape(want)
        for _, t in have:
            if _global_shape(t) != shape or t.dtype != want.dtype:
                raise KeyError(
                    f"checkpoint leaf {t.path} is {t.dtype}"
                    f"{list(_global_shape(t))} but the template wants "
                    f"{want.dtype}{list(shape)}; model definition changed "
                    "since the snapshot")
        region = _region(want)
        exact = next(((src, t) for src, t in have if _region(t) == region),
                     None)
        if exact is not None:
            copies.append((exact[0], exact[1].offset, want.offset,
                           want.nbytes))
            continue
        uniq = {}
        for src, t in have:
            uniq.setdefault(_region(t), (src, t))
        covered = sum(_size(o) for o in (_overlap(region, r) for r in uniq)
                      if o is not None)
        if covered < _size(region):
            raise _CoverGap(
                f"checkpoint blocks cover {covered}/{_size(region)} elements "
                f"of region {region} of {want.path}")
        built.append((want.offset, want, list(uniq.values())))
    return copies, built


def _region_fill(want: TensorMeta, have, read) -> np.ndarray:
    """The bytes of block ``want`` assembled from the saved blocks ``have``
    (``(source, meta)`` each) that overlap it; ``read(source, offset,
    nbytes)`` gives a saved block's bytes as uint8."""
    u = _UINT[_ITEMSIZE[want.dtype]]
    region = _region(want)
    out = np.empty(tuple(e - s for s, e in region), dtype=u)
    for src, t in have:
        t_region = _region(t)
        inter = _overlap(region, t_region)
        if inter is None:
            continue
        block = read(src, t.offset, t.nbytes).view(u).reshape(
            tuple(e - s for s, e in t_region))
        out[tuple(slice(s - r, e - r) for (s, e), (r, _) in
                  zip(inter, region))] = block[
            tuple(slice(s - b, e - b) for (s, e), (b, _) in
                  zip(inter, t_region))]
    return out.reshape(-1).view(np.uint8)


def _put_built(buf: torch.Tensor, built, read):
    """Each assembled block into its place in ``buf``."""
    for dst, want, have in built:
        arr = _region_fill(want, have, read)
        buf[dst:dst + want.nbytes].copy_(torch.from_numpy(arr))


def _verify_blocks(reader, meta: ShardMeta, step: int, gid: int = 0):
    """The legacy format's per-block checksums (striped metas carry none)."""
    algo = getattr(meta, "crc_algo", "")

    def one(t: TensorMeta):
        crc = getattr(t, "crc", None)
        if crc is None:
            return
        data = np.empty(t.nbytes, dtype=np.uint8)
        if reader.read_into(t.offset, data) != t.nbytes:
            raise ckpt_persist.StepCorruptionError(
                step, f"missing/truncated block {t.path!r} in shard {gid}")
        if not checksum.verify_block(data, crc, algo):
            raise ckpt_persist.StepCorruptionError(
                step, f"checksum mismatch in shard {gid} block {t.path!r} "
                f"(offset {t.offset}, {t.nbytes} bytes, algo {algo})")

    fastcopy.parallel_map(one, meta.tensors)
