"""Job master composition and run loop — the port's copy of the core of
``dlrover_tpu/master/master.py``'s ``JobMaster``.

Composes the node manager, both rendezvous managers, the kv store, the
sync service, the speed monitor, the mutation locks, the state store
(under ``state_dir``) and the RPC servicer; ``run()`` watches the exit
conditions (a job-exit request, every node exited, every node lost).

It leaves out the rest of the JAX ``JobMaster``, each part with the
ROADMAP queue 1 item that brings it: the task manager and shard leases
and the rescale coordinator (item 4); the observability plane, the
straggler detector and the link-profile aggregator (item 5); the
preemption coordinator, remediation, the brain, the job metric
collector, auto-scaling, auto-tuned parallel configs and the hot
standby (item 10's rest). Their RPCs are answered with an error naming
the item (``servicer.LEFT_OUT``), their options raise here, and their
journal records and snapshot sections are skipped on recovery with a
warning naming the item.
"""

import os
import threading
import time
from collections import Counter
from typing import Optional

from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.constants import JobStage, RendezvousName
from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import DEDUP_TTL
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.mutation_locks import MutationLocks
from dlrover_tpu_torch.master.node_manager import JobManager, LocalJobManager
from dlrover_tpu_torch.master.rendezvous import (
    DeviceCheckRendezvousManager,
    ElasticTrainingRendezvousManager,
)
from dlrover_tpu_torch.master.servicer import (
    LeftOut,
    MasterServicer,
    create_master_service,
)
from dlrover_tpu_torch.master.state_store import MasterStateStore
from dlrover_tpu_torch.master.sync_service import SyncService
from dlrover_tpu_torch.master.wal_records import LEFT_OUT, LEFT_OUT_STATE
from dlrover_tpu_torch.observability.events import EventKind, emit


#: Settings of the JAX master that the port's does not read: what each
#: sets, and the ROADMAP queue 1 item that brings it. The port runs the
#: JAX defaults of the tuning settings as constants (``common/rpc.py``,
#: ``master/state_store.py``).
LEFT_OUT_SETTINGS = {
    "DLROVER_TPU_WAL_SYNC":
        ("the journal's durability mode (the port's: group commit)",
         "item 10's rest"),
    "DLROVER_TPU_WAL_GROUP_WINDOW_S":
        ("the group-commit window (the port's: 2 ms)", "item 10's rest"),
    "DLROVER_TPU_RPC_WORKERS":
        ("the RPC bulk lane's threads (the port's: 16)", "item 10's rest"),
    "DLROVER_TPU_RPC_CONTROL_WORKERS":
        ("the RPC control lane's threads (the port's: 4)",
         "item 10's rest"),
    "DLROVER_TPU_RPC_DRAIN_S":
        ("the RPC server's drain (the port's: 5 s)", "item 10's rest"),
    "DLROVER_TPU_RPC_DEDUP_SIZE":
        ("the RPC dedup cache's size (the port's: 65536)",
         "item 10's rest"),
    "DLROVER_TPU_RPC_DEDUP_TTL_S":
        ("the RPC dedup cache's lifetime (the port's: 180 s)",
         "item 10's rest"),
    "DLROVER_TPU_STATE_SNAPSHOT_SECS":
        ("the state store's snapshot interval (the port's: 30 s)",
         "item 10's rest"),
    "DLROVER_TPU_STATE_SNAPSHOT_RECORDS":
        ("the state store's snapshot backstop (the port's: 2048 records)",
         "item 10's rest"),
    "DLROVER_TPU_LOCKDEP_EXPORT":
        ("the export of the lock-order graph", "item 5"),
}


def check_left_out_env():
    """Raise for an environment that asks for a part the port's master
    leaves out."""
    for name, (what, item) in LEFT_OUT_SETTINGS.items():
        if os.environ.get(name):
            raise NotImplementedError(
                f"{name} sets {what}, which the port's master does not "
                f"read (ROADMAP queue 1, {item})")
    if env_utils.METRICS_PORT.get() >= 0:
        raise NotImplementedError(
            f"{env_utils.METRICS_PORT.name} asks for the /metrics exporter "
            "of the observability plane, which the port's master leaves "
            "out (ROADMAP queue 1, item 5)")
    if env_utils.MASTER_HA_DIR.get():
        raise NotImplementedError(
            f"{env_utils.MASTER_HA_DIR.name} asks for the master hot "
            "standby, which the port's master leaves out (ROADMAP queue 1, "
            "item 10's rest)")
    if get_context().auto_paral_tuning:
        raise NotImplementedError(
            f"{env_utils.AUTO_PARAL.name} asks for auto-tuned parallel "
            "configs, whose strategy generator reads the job metric "
            "collector, which the port's master leaves out (ROADMAP queue "
            "1, item 10's rest)")


class JobMaster:
    def __init__(
        self,
        port: int = 0,
        node_num: int = 1,
        job_name: str = "local-job",
        job_manager: Optional[JobManager] = None,
        state_dir: str = "",
    ):
        check_left_out_env()
        ctx = get_context()
        self.job_name = job_name
        # Durable state (opt-in via --state_dir): snapshots + WAL so a
        # relaunched master at the same address resumes the previous
        # incarnation's kv store, node registry and rendezvous rounds
        # instead of booting blank.
        self.state_store: Optional[MasterStateStore] = None
        self.incarnation = 0
        self.last_recovery_stats = {}
        if state_dir:
            self.state_store = MasterStateStore(state_dir)
            self.incarnation = self.state_store.next_incarnation()
        self.speed_monitor = SpeedMonitor(hang_seconds=ctx.hang_detection_seconds)
        self.job_manager = job_manager or LocalJobManager(
            node_num=node_num, heartbeat_timeout=ctx.heartbeat_timeout
        )
        self.rdzv_managers = {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(
                RendezvousName.TRAINING
            ),
            RendezvousName.DEVICE_CHECK: DeviceCheckRendezvousManager(
                RendezvousName.DEVICE_CHECK,
                check_timeout=ctx.device_check_timeout,
            ),
        }
        for mgr in self.rdzv_managers.values():
            mgr.update_rdzv_params(
                node_num, node_num, ctx.rdzv_waiting_timeout, 1
            )
        self.kv_store = KVStoreService()
        self.sync_service = SyncService(self.job_manager)
        if self.state_store is not None:
            for mgr in self.rdzv_managers.values():
                mgr.set_state_listener(self._journal_rdzv_state)
        # Per-subsystem mutation shards; the snapshot quiesce holds ALL
        # of them (in canonical order) so no journal record can land
        # past a rotation it isn't covered by.
        self.mutation_locks = MutationLocks()
        if self.state_store is not None:
            self.state_store.quiesce = self.mutation_locks.all
        self.servicer = MasterServicer(
            rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store,
            job_manager=self.job_manager,
            speed_monitor=self.speed_monitor,
            sync_service=self.sync_service,
            state_store=self.state_store,
            mutation_locks=self.mutation_locks,
        )
        self._server = create_master_service(port, self.servicer)
        self.port = self._server.port
        if self.state_store is not None:
            self._server.incarnation = self.incarnation
            self._recover_state()
            # Fold whatever was recovered into a fresh generation right
            # away: opens this incarnation's journal and bounds the next
            # recovery's replay to post-boot mutations.
            self.state_store.snapshot(self._collect_state)
        self.stage = JobStage.INIT
        self._stopped = threading.Event()
        self._abort_reason: Optional[str] = None
        self._monitor_thread: Optional[threading.Thread] = None

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    # ------------- durable state -------------
    def _journal_rdzv_state(self, name: str, state: dict):
        # Absolute counter values, so replaying a duplicate is a no-op
        # (restore() takes the max) and journal-after-apply is safe.
        self.state_store.append(("rdzv", name, state, time.time()))

    def _collect_state(self) -> dict:
        """The snapshot, in the JAX master's layout: the sections of the
        parts this master serves (the JAX master restores the others as
        fresh subsystems)."""
        return {
            "version": 1,
            "incarnation": self.incarnation,
            "time": time.time(),
            "kv": self.kv_store.export_state(),
            "nodes": self.job_manager.export_nodes(),
            "rdzv": {
                name: mgr.checkpoint()
                for name, mgr in self.rdzv_managers.items()
            },
            "speed": self.speed_monitor.checkpoint(),
        }

    def _recover_state(self):
        """Load the newest valid snapshot, replay the journal chain over
        it, and seed the RPC dedup cache with the replayed responses so
        in-flight client retries are answered, not re-applied. Sections
        and records of left-out parts are skipped, counted and named
        with their item in one warning."""
        store = self.state_store
        state, records = store.recover()
        if state is None and not records:
            return
        store.replaying = True
        seeds = []
        now = time.time()
        applied = 0
        skipped = Counter()
        try:
            if state is not None:
                self.kv_store.restore_state(state.get("kv", {}))
                self.job_manager.restore_nodes(state.get("nodes", []))
                for name, st in state.get("rdzv", {}).items():
                    mgr = self.rdzv_managers.get(name)
                    if mgr is not None:
                        mgr.restore(st)
                self.speed_monitor.restore(state.get("speed", {}))
                for key, item in LEFT_OUT_STATE.items():
                    if state.get(key):
                        skipped[f"snapshot section {key!r} (item {item})"] += 1
            for rec in records:
                try:
                    kind = rec[0]
                    if kind == "rpc":
                        _, req_id, request, ts = rec
                        resp = self.servicer.handle(request)
                        if req_id and now - ts < DEDUP_TTL:
                            seeds.append((req_id, resp))
                    elif kind == "evict":
                        _, node_id, reason, ts = rec
                        self._evict_node(node_id, f"replayed: {reason}")
                    elif kind == "rdzv":
                        _, name, st, ts = rec
                        mgr = self.rdzv_managers.get(name)
                        if mgr is not None:
                            mgr.restore(st)
                    elif kind in LEFT_OUT:
                        skipped[f"{kind!r} records (item {LEFT_OUT[kind]})"] += 1
                        continue
                    else:
                        logger.warning("skipping unknown journal record %r",
                                       kind)
                        continue
                    applied += 1
                except LeftOut as e:
                    skipped[f"'rpc' records of {type(rec[2]).__name__}: "
                            f"{e}"] += 1
                except Exception:
                    logger.exception("skipping unreplayable journal record")
        finally:
            store.replaying = False
        for req_id, resp in seeds:
            self._server.seed_dedup(req_id, resp)
        if skipped:
            logger.warning(
                "recovery skipped what the port's master leaves out "
                "(ROADMAP queue 1): %s",
                "; ".join(f"{n} x {what}" for what, n in skipped.items()),
            )
        stats = dict(store.last_recovery_stats)
        stats.update(replayed=applied, dedup_seeded=len(seeds),
                     skipped=dict(skipped))
        self.last_recovery_stats = stats
        logger.info(
            "recovered master state: incarnation=%s snapshot_seq=%s "
            "journal_records=%s replayed=%s dedup_seeded=%s torn_tails=%s "
            "quarantined=%s",
            self.incarnation, stats.get("snapshot_seq"),
            stats.get("journal_records"), applied, len(seeds),
            stats.get("torn_tails"), stats.get("quarantined_snapshots"),
        )

    def prepare(self):
        self._server.start()
        self.stage = JobStage.RUNNING
        self._monitor_thread = threading.Thread(
            target=self._node_monitor_loop, daemon=True,
            name="node-monitor",
        )
        self._monitor_thread.start()
        logger.info("master %s serving on port %s", self.job_name, self.port)

    # ------------- failure detection -------------
    def _node_monitor_loop(self):
        """Failure detection:

        - *Node death* (stale heartbeat — the agent itself is gone):
          evict the node so survivors re-form a smaller world.
        - *Training hang* (agents heartbeat but step progress stopped):
          synchronous SPMD stalls ALL nodes at once, so eviction would
          kill the whole job; instead invalidate the round — every agent
          restarts its workers and re-rendezvouses.
        """
        interval = get_context().node_monitor_interval
        while not self._stopped.wait(interval):
            try:
                for node_id in self.job_manager.find_dead_nodes():
                    self._evict_node(node_id, "heartbeat timeout")
                if self.speed_monitor.worker_hang():
                    logger.error(
                        "training hang: no step progress for %.0fs; "
                        "invalidating the round so agents restart",
                        self.speed_monitor.hang_seconds,
                    )
                    emit(
                        EventKind.NODE_HANG, _role="master",
                        hang_seconds=self.speed_monitor.hang_seconds,
                    )
                    for mgr in self.rdzv_managers.values():
                        mgr.invalidate_round()
                    # Restarted workers report steps again; clearing the
                    # stale report times re-arms detection instead of
                    # re-firing every pass.
                    self.speed_monitor.reset_worker_reports()
                if self.state_store is not None:
                    self.state_store.maybe_snapshot(self._collect_state)
                if not self.job_manager.all_nodes():
                    self._abort_reason = "all nodes lost"
                    return
            except Exception:
                logger.exception("node monitor iteration failed")

    def _evict_node(self, node_id: int, reason: str):
        logger.error("evicting node %s: %s", node_id, reason)
        emit(
            EventKind.NODE_EVICT, _node_id=node_id, _role="master",
            reason=reason,
        )
        store = self.state_store
        if store is not None and not store.replaying:
            # Write-ahead. Eviction spans nodes/rdzv, so it holds every
            # mutation shard: it serializes against concurrent RPC
            # mutations in journal order.
            with self.mutation_locks.all():
                seq = store.append(("evict", node_id, reason, time.time()))
                self._apply_evict(node_id, reason)
            store.wait_durable(seq)
            return
        self._apply_evict(node_id, reason)

    def _apply_evict(self, node_id: int, reason: str):
        self.job_manager.remove_node(node_id, reason)
        for mgr in self.rdzv_managers.values():
            mgr.remove_alive_node(node_id)
        self.speed_monitor.remove_worker(node_id)

    def run(self, poll_interval: float = 1.0) -> int:
        """Block until the job finishes; returns an exit code."""
        try:
            while not self._stopped.is_set():
                # Event.wait, not sleep: stop() takes effect immediately
                # instead of up to a full poll interval later.
                self._stopped.wait(poll_interval)
                exit_req = self.servicer.job_exit_request()
                if exit_req is not None:
                    self.stage = (
                        JobStage.SUCCEEDED if exit_req.success else JobStage.FAILED
                    )
                    break
                if self._abort_reason:
                    logger.error("aborting job: %s", self._abort_reason)
                    self.stage = JobStage.FAILED
                    break
                if self.job_manager.all_workers_exited():
                    self.stage = (
                        JobStage.SUCCEEDED
                        if self.job_manager.all_workers_succeeded()
                        else JobStage.FAILED
                    )
                    break
        finally:
            self.stop()
        logger.info("master exiting with stage %s at global step %s",
                    self.stage, self.speed_monitor.global_step)
        return 0 if self.stage == JobStage.SUCCEEDED else 1

    def stop(self):
        self._stopped.set()
        self._server.stop()
        if self.state_store is not None:
            # Sockets are severed, so no mutation can race the final
            # snapshot; best-effort — a failure here is exactly the
            # crash case the journal already covers.
            try:
                self.state_store.snapshot(self._collect_state)
            except Exception:
                logger.exception("final state snapshot failed")
            self.state_store.close()
