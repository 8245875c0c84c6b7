"""Agent-side async flash-checkpoint saver — the port of
``dlrover_tpu/agent/ckpt_saver.py``.

The saver singleton is made on demand from a registration the trainer
pushes through the "factory" ``SharedQueue``; a persist thread wakes on
save events, copies each local shard out of shared memory to storage
under the shard lock (dirty-write protection), writes per-shard done
files, and the committer node publishes the tracker once every global
shard is done. ``save_shm_to_storage`` is the crash/SIGTERM flush: it
persists the *last memory snapshot*, which is what makes every-step
memory snapshots recoverable.

The wire protocol and the files are the JAX package's, so this saver
serves a JAX engine as well as a port engine, and the JAX saver serves
the port's. It never imports torch's CUDA state: shards are opaque
(meta, bytes) pairs. The agent process that drives it (restart loop,
rendezvous) comes with ROADMAP queue 1, item 6; the ``ckpt.*`` events
with item 7.
"""

import concurrent.futures
import queue
import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common import ckpt_meta, ckpt_persist, env_utils
from dlrover_tpu_torch.common.backoff import ExponentialBackoff
from dlrover_tpu_torch.common.ckpt_meta import (
    SaveEvent,
    SaverRegistration,
    ShardMeta,
    ckpt_event_queue,
    ckpt_factory_queue,
    ckpt_lock_name,
    ckpt_meta_dict,
)
from dlrover_tpu_torch.common.comm import SharedDict, SharedLock, SharedQueue
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.shared_memory import SharedMemory
from dlrover_tpu_torch.common.storage import get_checkpoint_storage


class CommonDirCheckpointSaver:
    """Persists this node's local shards into per-step directories.

    One instance per agent; covers the replicated (1 global shard) and
    sharded (shard per process) layouts — which local ranks publish metadata
    decides what gets persisted, so no per-layout subclasses are needed
    (the reference splits DDP/Megatron/DeepSpeed savers mainly over torch
    file naming, ``ckpt_saver.py:979-1029``).
    """

    def __init__(self, reg: SaverRegistration, job: str = ""):
        self._job = job or env_utils.JOB_NAME.get()
        self._node_rank = reg.node_rank
        self.checkpoint_dir = reg.checkpoint_dir
        self.local_shard_num = reg.local_shard_num
        self.global_shard_num = reg.global_shard_num
        self.is_committer = reg.is_committer
        self.keep_latest = reg.keep_latest
        self.storage = get_checkpoint_storage()
        self._last_persisted = -1
        self._flush_lock = threading.Lock()
        self._stopped = False
        # Persist rounds currently in flight (`busy`): the agent's link
        # probe stays off the disks and links while they run.
        self._persisting = 0
        # Aggregated persist_shard stats of the current save round,
        # appended under _io_lock (shards persist concurrently);
        # ``last_persist_stats`` holds those of the last committed round.
        self._io_lock = threading.Lock()
        self._io_stats: list = []
        self.last_persist_stats: list = []

        self._meta = SharedDict(
            ckpt_meta_dict(self._node_rank), create=True, job=self._job
        )
        self._events = SharedQueue(
            ckpt_event_queue(self._node_rank), create=True, job=self._job
        )
        self._locks = [
            SharedLock(ckpt_lock_name(self._node_rank, i), create=True,
                       job=self._job)
            for i in range(self.local_shard_num)
        ]
        self._persist_thread = threading.Thread(
            target=self._persist_loop, name="ckpt-persist", daemon=True
        )
        self._persist_thread.start()
        logger.info(
            "checkpoint saver up: dir=%s local_shards=%s global_shards=%s "
            "committer=%s",
            self.checkpoint_dir, self.local_shard_num, self.global_shard_num,
            self.is_committer,
        )

    def update(self, reg: SaverRegistration):
        """Re-registration after a worker restart (idempotent)."""
        self.checkpoint_dir = reg.checkpoint_dir
        self.global_shard_num = reg.global_shard_num
        self.keep_latest = reg.keep_latest
        if reg.local_shard_num > len(self._locks):
            for i in range(len(self._locks), reg.local_shard_num):
                self._locks.append(
                    SharedLock(ckpt_lock_name(self._node_rank, i),
                               create=True, job=self._job)
                )
            self.local_shard_num = reg.local_shard_num

    # ------------- persist machinery -------------
    def _persist_loop(self):
        backoff = ExponentialBackoff(initial=0.5, max_delay=5.0)
        while not self._stopped:
            try:
                event: SaveEvent = self._events.get(block=True, timeout=5.0)
            except queue.Empty:
                continue
            except Exception:
                if self._stopped:
                    return
                logger.exception("checkpoint event queue failure")
                backoff.sleep()
                continue
            backoff.reset()
            if event.kind == "stop":
                return
            try:
                self.save_step_checkpoint(event.step)
            except Exception:
                logger.exception("persist of step %s failed", event.step)

    def _local_metas(self) -> Dict[int, ShardMeta]:
        metas = {}
        for key, raw in self._meta.copy().items():
            if not key.startswith("rank_"):
                continue
            try:
                metas[int(key[5:])] = ckpt_meta.loads(raw)
            except Exception:
                logger.warning("undecodable checkpoint meta under %s", key)
        return metas

    def _persist_one(self, local_rank: int, meta: ShardMeta) -> bool:
        """Copy one shard out of shm under its lock. Refuses a dirty shard
        (writer mid-copy) — the lock is the consistency boundary (parity:
        ``ckpt_saver.py:590-594``)."""
        lock = self._locks[local_rank] if local_rank < len(self._locks) else None
        if lock is not None and not lock.acquire(blocking=True, timeout=30.0):
            logger.error(
                "shard %s lock busy >30s; skipping persist", local_rank
            )
            return False
        try:
            # Re-read the meta under the lock — the writer may have finished
            # a newer step between wake-up and acquisition. A different step
            # is skipped: its own save event will persist it (persisting it
            # here would scatter done files across step dirs).
            fresh = self._local_metas().get(local_rank, meta)
            if fresh.step != meta.step:
                logger.warning(
                    "shard %s moved from step %s to %s under persist; "
                    "skipping", local_rank, meta.step, fresh.step,
                )
                return False
            if not SharedMemory.exists(fresh.shm_name):
                logger.error("shm %s vanished; cannot persist", fresh.shm_name)
                return False
            shm = SharedMemory(fresh.shm_name)
            try:
                stats = ckpt_persist.persist_shard(
                    self.storage, self.checkpoint_dir, fresh, shm.buf
                )
                with self._io_lock:
                    self._io_stats.append(stats)
            finally:
                shm.close()
            return True
        finally:
            if lock is not None:
                lock.release()

    def save_step_checkpoint(self, step: int, commit_timeout: float = 600.0):
        """Persist every local shard at a consistent step >= `step`, then
        (committer only) publish the tracker once all global shards' done
        files exist.

        A shm buffer only holds its *latest* snapshot, so if the trainer has
        already staged a newer step by the time we wake up, we chase forward
        and persist that newer step instead of silently dropping the save
        (the reference logs an error and loses it, ``ckpt_saver.py:521``)."""
        if step <= self._last_persisted:
            # A previous event already chased past this step; re-copying a
            # multi-GB buffer for a step that is on disk is pure waste.
            return
        self._persisting += 1
        try:
            self._save_step_checkpoint(step, commit_timeout)
        finally:
            self._persisting -= 1

    @property
    def busy(self) -> bool:
        """True while a persist round is in flight."""
        return self._persisting > 0

    def _save_step_checkpoint(self, step: int, commit_timeout: float):
        commit_at = -1
        with self._io_lock:
            self._io_stats = []
        # The commit wait (potentially minutes, multi-node) runs OUTSIDE
        # _flush_lock — the crash/SIGTERM flush must never queue behind it.
        with self._flush_lock:
            target = step
            prev_steps = None
            # Bounded wall clock: a local rank that died mid-memory-save
            # never advances, and the crash flush (which needs _flush_lock)
            # must not wait minutes behind it.
            deadline = time.monotonic() + 90.0
            while time.monotonic() < deadline:
                metas = self._wait_local_step(target, timeout=10.0)
                to_save = {
                    r: m for r, m in metas.items() if m.persist
                }
                if not to_save:
                    # This node owns no disk shard (replicated mode, node>0);
                    # still run the commit if we are the committer.
                    commit_at = target
                    break
                steps = {r: m.step for r, m in to_save.items()}
                if len(set(steps.values())) > 1:
                    if steps == prev_steps:
                        # No progress across a full wait: a writer is dead.
                        # Give up; the crash flush persists per-step groups.
                        logger.error(
                            "persist of step %s: shards stuck at %s",
                            step, steps,
                        )
                        break
                    prev_steps = steps
                    target = max(steps.values())  # wait for laggards, retry
                    continue
                target = next(iter(steps.values()))
                if target < step:
                    logger.error(
                        "persist of step %s: shards stuck at %s", step, target
                    )
                    break
                with concurrent.futures.ThreadPoolExecutor(
                    max_workers=max(1, len(to_save))
                ) as pool:
                    results = list(
                        pool.map(
                            lambda item: self._persist_one(item[0], item[1]),
                            to_save.items(),
                        )
                    )
                if all(results):
                    self._last_persisted = max(self._last_persisted, target)
                    commit_at = target
                    break
                # Some shard moved ahead mid-persist; chase the new step.
                target += 1
                prev_steps = None
            else:
                logger.error(
                    "persist of step %s never converged (trainer outpacing "
                    "saver)", step,
                )
        if commit_at >= 0:
            with self._io_lock:
                self.last_persist_stats = list(self._io_stats)
            self._finish_step(commit_at, commit_timeout)

    def _wait_local_step(self, step: int, timeout: float) -> Dict[int, ShardMeta]:
        """Give laggard local ranks a moment to finish their memory copy of
        `step` before declaring them stale: every local rank's shard (one a
        worker process on this node) must have published one."""
        deadline = time.monotonic() + timeout
        backoff = ExponentialBackoff(initial=0.05, max_delay=0.5)
        while True:
            metas = self._local_metas()
            if len(metas) >= self.local_shard_num and \
                    all(m.step >= step for m in metas.values()):
                return metas
            if time.monotonic() >= deadline:
                return metas
            backoff.sleep(deadline - time.monotonic())

    def _finish_step(self, step: int, commit_timeout: float):
        if self.is_committer:
            ok = ckpt_persist.commit_step(
                self.storage, self.checkpoint_dir, step,
                self.global_shard_num, timeout=commit_timeout,
            )
            if ok:
                ckpt_persist.gc_steps(
                    self.storage, self.checkpoint_dir, self.keep_latest
                )

    # ------------- crash / SIGTERM flush -------------
    def save_shm_to_storage(self, commit_timeout: float = 60.0):
        """Persist the last memory snapshot if it is newer than anything on
        disk. Called by the agent on worker failure, membership change,
        SIGTERM, and proactively inside a preemption grace window
        (parity: ``ckpt_saver.py:566``). Raises the same ``busy`` signal
        as the per-step persist path."""
        self._persisting += 1
        try:
            self._save_shm_to_storage(commit_timeout)
        finally:
            self._persisting -= 1

    def _save_shm_to_storage(self, commit_timeout: float):
        metas = {
            r: m for r, m in self._local_metas().items() if m.persist
        }
        steps = sorted({m.step for m in metas.values() if m.step >= 0})
        if not steps:
            logger.info("crash flush: no memory snapshot to persist")
            return
        tracker = ckpt_persist.read_tracker(self.storage, self.checkpoint_dir)
        if tracker is not None:
            steps = [s for s in steps if s > tracker]
        if not steps:
            logger.info("crash flush: storage is already up to date")
            return
        if len(steps) > 1:
            # A shard's buffer only holds its latest step, so a torn snapshot
            # (crash mid-memory-save) flushes each shard at its own step; the
            # commit of an incomplete step times out and is never published.
            logger.warning(
                "crash flush: local shards at different steps %s", steps
            )
        with self._flush_lock:
            with self._io_lock:
                self._io_stats = []
            for step in steps:
                group = {
                    r: m for r, m in metas.items() if m.step == step
                }
                logger.info(
                    "crash flush: persisting %s shard(s) of step %s",
                    len(group), step,
                )
                for local_rank, meta in group.items():
                    self._persist_one(local_rank, meta)
            with self._io_lock:
                self.last_persist_stats = list(self._io_stats)
        # Commit outside _flush_lock; spend the real budget on the newest
        # step only (older torn steps almost never complete globally).
        for i, step in enumerate(steps):
            timeout = commit_timeout if i == len(steps) - 1 else 5.0
            self._finish_step(step, timeout)

    def stop(self):
        self._stopped = True
        try:
            self._events.put(SaveEvent(kind="stop"), timeout=1.0)
        except Exception:  # shutdown: the queue may be closed or full
            pass
        self._persist_thread.join(timeout=5.0)
        self._meta.close()
        self._events.close()
        for lock in self._locks:
            lock.close()


class AsyncCheckpointSaver:
    """Class-level facade the agent drives (parity: ``ckpt_saver.py:344``).

    ``start_async_saving_ckpt`` opens the factory queue and waits for a
    trainer registration; the saver singleton is created from the first one.
    """

    _saver: Optional[CommonDirCheckpointSaver] = None
    _factory: Optional[SharedQueue] = None
    _thread: Optional[threading.Thread] = None
    _lock = threading.Lock()
    _stopped = False

    @classmethod
    def start_async_saving_ckpt(cls, node_rank: int = 0):
        with cls._lock:
            if cls._thread is not None and cls._thread.is_alive():
                return
            cls._stopped = False
            cls._factory = SharedQueue(
                ckpt_factory_queue(node_rank), create=True
            )
            cls._thread = threading.Thread(
                target=cls._factory_loop, name="ckpt-factory", daemon=True
            )
            cls._thread.start()

    @classmethod
    def _factory_loop(cls):
        backoff = ExponentialBackoff(initial=0.5, max_delay=5.0)
        while not cls._stopped:
            try:
                reg: SaverRegistration = cls._factory.get(
                    block=True, timeout=5.0
                )
            except queue.Empty:
                continue
            except Exception:
                if cls._stopped:
                    return
                backoff.sleep()
                continue
            backoff.reset()
            with cls._lock:
                if cls._stopped:
                    # stop() won the lock between our dequeue and here; do
                    # not resurrect a saver nothing will ever stop.
                    return
                if cls._saver is None:
                    try:
                        cls._saver = CommonDirCheckpointSaver(reg)
                    except Exception:
                        logger.exception("failed to create checkpoint saver")
                else:
                    cls._saver.update(reg)

    @classmethod
    def get_ckpt_saver(cls) -> Optional[CommonDirCheckpointSaver]:
        return cls._saver

    @classmethod
    def stop(cls):
        cls._stopped = True
        with cls._lock:
            if cls._saver is not None:
                cls._saver.stop()
                cls._saver = None
            if cls._factory is not None:
                cls._factory.close()
                cls._factory = None
            cls._thread = None
