"""The master's single RPC endpoint — the port's copy of
``dlrover_tpu/master/servicer.py``.

One generic endpoint dispatching on message class: rendezvous joins and
worlds, device-check reports and diagnosis queries, the kv store and the
checkpoint writer election, steps and heartbeats, failures, node status,
sync barriers, the parallel config, the cluster version and job exit.

The port's master is the JAX master's core. A message whose handler
needs a subsystem it leaves out (:data:`LEFT_OUT`: the task manager and
shard leases, the rescale coordinator, the event log, the preemption
coordinator, the brain, the metric collector, the hot standby) is
answered with an error naming the ROADMAP queue 1 item that brings it,
before anything is applied or journaled; the client raises it.
"""

import os
import signal
import time
from typing import Any, Dict

from dlrover_tpu_torch.chaos.injector import fault_hit
from dlrover_tpu_torch.chaos.sites import ChaosSite
from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import RpcServer, current_request_id
from dlrover_tpu_torch.master.mutation_locks import MutationLocks
from dlrover_tpu_torch.observability.events import EventKind, emit

#: Messages whose handlers mutate durable master state. With a state
#: store attached, each is journaled WRITE-AHEAD (append, then apply,
#: both under the store's mutation lock) so a crash between the two is
#: recovered by replay and journal order equals apply order.
_JOURNALED = (
    m.KVStoreSet,
    m.KVStoreAdd,
    m.KVStoreDelete,
    m.NodeStatusReport,
    m.NodeFailure,
    # Writer elections are first-claimant races over kv state; journaling
    # them replays the race in the original order, so a recovered master
    # answers with the same owner it already promised.
    m.CkptWriterElect,
)

_TASKS = "task manager and shard leases"
_RESCALE = "rescale coordinator"
#: Message class -> (the subsystem its handler needs, its ROADMAP queue 1
#: item). The JAX master serves these; the port's answers each with an
#: error naming the item.
LEFT_OUT = {
    m.DatasetShardParams: (_TASKS, "4"),
    m.TaskRequest: (_TASKS, "4"),
    m.TaskReport: (_TASKS, "4"),
    m.TaskHoldReport: (_TASKS, "4"),
    m.LeaseRequest: (_TASKS, "4"),
    m.LeaseReport: (_TASKS, "4"),
    m.ShardCheckpointRequest: (_TASKS, "4"),
    m.DatasetEpochRequest: (_TASKS, "4"),
    m.RescalePlanRequest: (_RESCALE, "4"),
    m.RescaleAck: (_RESCALE, "4"),
    m.EventReport: ("event log of the observability plane", "5"),
    m.PreemptionNotice: ("preemption coordinator", "10's rest"),
    m.BrainStatusRequest: ("brain decision layer", "10's rest"),
    m.ModelInfo: ("job metric collector, brain and rescale coordinator",
                  "10's rest and item 4"),
    m.WalSubscribe: ("master hot standby", "10's rest"),
}


class LeftOut(NotImplementedError):
    """A request for a subsystem the port's master leaves out."""


def left_out(what: str, item: str, name: str) -> LeftOut:
    return LeftOut(f"{name} needs the {what}, which the port's master "
                   f"leaves out (ROADMAP queue 1, item {item})")


class MasterServicer:
    #: The servicer itself keeps almost no state — every mutation lands
    #: in a subsystem behind that subsystem's lock (via the per-message
    #: mutation shard). ``_paral_config`` is never written, and
    #: ``_job_exit`` is a write-once exit flag.
    GUARDED_BY = {
        "_paral_config": None,
        "_job_exit": None,
    }

    def __init__(
        self,
        rdzv_managers: Dict[str, Any],
        kv_store,
        job_manager,
        speed_monitor,
        sync_service,
        state_store=None,
        mutation_locks=None,
    ):
        self._rdzv_managers = rdzv_managers
        self._kv_store = kv_store
        self._job_manager = job_manager
        self._speed_monitor = speed_monitor
        self._sync_service = sync_service
        self._state_store = state_store
        self._locks = mutation_locks or MutationLocks()
        self._paral_config = m.ParallelConfig()
        self._job_exit = None

    # The transport handler.
    def handle(self, request: Any) -> Any:
        store = self._state_store
        replaying = store is not None and store.replaying
        if not replaying:
            # Injected crashes model a *live* RPC arriving. A replayed
            # journal record must not re-roll the dice (or burn fault
            # budget): the recovering master would crash-loop on the
            # very record whose original arrival killed it.
            chaos = fault_hit(
                ChaosSite.MASTER_CRASH, detail=type(request).__name__
            )
            if chaos is not None:
                if chaos.kind == "kill":
                    # A real master death: no flushes, no atexit —
                    # exactly what SIGKILL on the pod looks like.
                    os.kill(os.getpid(), signal.SIGKILL)
                elif chaos.kind == "exit":
                    os._exit(1)
        gap = LEFT_OUT.get(type(request))
        if gap is not None:
            raise left_out(*gap, type(request).__name__)
        handler = self._HANDLERS.get(type(request))
        if handler is None:
            raise ValueError(f"unknown control message {type(request).__name__}")
        if replaying or store is None or not isinstance(request, _JOURNALED):
            return handler(self, request)
        with self._locks.for_message(request):
            seq = store.append(
                ("rpc", current_request_id(), request, time.time())
            )
            resp = handler(self, request)
        # Durability barrier OUTSIDE the shard: the group-commit fsync
        # wait must never serialize unrelated mutations.
        store.wait_durable(seq)
        return resp

    # ---------------- rendezvous ----------------
    def _join_rendezvous(self, req: m.JoinRendezvous):
        mgr = self._rdzv_managers[req.rdzv_name]
        round_ = mgr.join_rendezvous(req.node_rank, req.local_world_size)
        if req.rdzv_name == RendezvousName.TRAINING and self._job_manager:
            self._job_manager.report_heartbeat(req.node_id, time.time())
        return round_

    def _get_comm_world(self, req: m.CommWorldRequest):
        mgr = self._rdzv_managers[req.rdzv_name]
        round_, group, world = mgr.get_comm_world(req.node_rank)
        return m.CommWorld(
            rdzv_name=req.rdzv_name, round=round_, group=group, world=world
        )

    def _num_nodes_waiting(self, req: m.WaitingNodeNumRequest):
        return self._rdzv_managers[req.rdzv_name].num_nodes_waiting()

    def _world_status(self, req: m.WorldStatusRequest):
        return self._rdzv_managers[req.rdzv_name].world_stale(req.round)

    def _update_rdzv_params(self, req: m.RendezvousParams):
        for mgr in self._rdzv_managers.values():
            mgr.update_rdzv_params(
                req.min_nodes, req.max_nodes, req.waiting_timeout, req.node_unit
            )
        return m.Response()

    # ---------------- device check ----------------
    def _report_check_result(self, req: m.DeviceCheckResult):
        mgr = self._rdzv_managers[RendezvousName.DEVICE_CHECK]
        mgr.report_check_result(
            req.node_rank, req.normal, req.elapsed_time,
            round_=req.round if req.round > 0 else None,
        )
        return m.Response()

    def _get_fault_nodes(self, req: m.FaultNodesRequest):
        mgr = self._rdzv_managers[RendezvousName.DEVICE_CHECK]
        nodes, done = mgr.check_fault_node()
        return m.DiagnosisResult(
            nodes=nodes, done=done, completed_rounds=mgr.completed_rounds()
        )

    def _get_stragglers(self, req: m.StragglersRequest):
        mgr = self._rdzv_managers[RendezvousName.DEVICE_CHECK]
        nodes, done = mgr.check_straggler()
        return m.DiagnosisResult(
            nodes=nodes, done=done, completed_rounds=mgr.completed_rounds()
        )

    # ---------------- kv store ----------------
    def _kv_set(self, req: m.KVStoreSet):
        self._kv_store.set(req.key, req.value)
        return m.Response()

    def _kv_get(self, req: m.KVStoreGet):
        return self._kv_store.get(req.key)

    def _kv_add(self, req: m.KVStoreAdd):
        return self._kv_store.add(req.key, req.amount)

    def _kv_multi_get(self, req: m.KVStoreMultiGet):
        return self._kv_store.multi_get(req.keys)

    def _kv_delete(self, req: m.KVStoreDelete):
        self._kv_store.delete(req.key)
        return m.Response()

    # ---------------- checkpoint writer election ----------------
    def _ckpt_writer_elect(self, req: m.CkptWriterElect):
        # First claimant wins; the decision lives in the kv store, so it
        # rides in state snapshots for free and a late proposer (or a
        # client retry) reads back the recorded owner.
        key = f"ckpt_writer/{req.epoch}/{req.group}"
        won = self._kv_store.setnx(key, str(req.rank).encode())
        return m.CkptWriterLease(
            group=req.group, epoch=req.epoch, owner_rank=int(won.decode())
        )

    # ---------------- metrics ----------------
    def _report_step(self, req: m.GlobalStep):
        self._speed_monitor.collect_global_step(
            req.step, req.timestamp or time.time(), req.node_id
        )
        return m.Response()

    def _report_resource(self, req: m.NodeResourceStats):
        # Device-only reports (cpu/mem < 0: forwarded device stats from
        # the training monitor) feed only the metric collector.
        if req.cpu_percent < 0 or req.used_memory_mb < 0:
            raise left_out("job metric collector", "10's rest",
                           "a device-only NodeResourceStats")
        node = self._job_manager.get_node(req.node_id) if self._job_manager else None
        if node is not None:
            node.used_resource.cpu = req.cpu_percent
            node.used_resource.memory_mb = req.used_memory_mb
        return m.Response()

    def _report_failure(self, req: m.NodeFailure):
        # Master-visible detection point: the node drops out of every
        # rendezvous below.
        emit(
            EventKind.NODE_EVICT, _node_id=req.node_id, _role="master",
            reason=req.level, restart_count=req.restart_count,
            cause="crash",
        )
        if self._job_manager:
            self._job_manager.process_error(
                req.node_id, req.restart_count, req.error_data, req.level
            )
        for mgr in self._rdzv_managers.values():
            mgr.remove_alive_node(req.node_id)
        return m.Response()

    def _report_heartbeat(self, req: m.NodeHeartbeat):
        if self._job_manager:
            self._job_manager.report_heartbeat(req.node_id, req.timestamp)
        return m.Response()

    def _agent_beat(self, req: m.AgentBeat):
        """The coalesced agent heartbeat: one RPC folds the node
        heartbeat and the newest step progress (a link-probe sample
        needs the observability plane, and is refused before anything
        is applied)."""
        if req.probe:
            raise left_out("observability plane's link profile", "5",
                           "an AgentBeat with a probe sample")
        if self._job_manager:
            self._job_manager.report_heartbeat(req.node_id, req.timestamp)
        if req.step >= 0:
            self._report_step(m.GlobalStep(
                node_id=req.node_id, node_type=req.node_type,
                step=req.step, timestamp=req.step_ts or req.timestamp,
            ))
        return m.Response()

    def _report_node_status(self, req: m.NodeStatusReport):
        if self._job_manager:
            self._job_manager.update_node_status(
                req.node_id, req.status, req.exit_reason
            )
        return m.Response()

    # ---------------- sync ----------------
    def _sync_join(self, req: m.SyncJoin):
        return self._sync_service.join_sync(req.sync_name, req.worker_rank)

    def _sync_finished(self, req: m.SyncFinish):
        return self._sync_service.sync_finished(req.sync_name)

    def _sync_barrier(self, req: m.SyncBarrierRequest):
        if req.notify:
            return self._sync_service.notify_barrier(req.sync_name)
        return self._sync_service.barrier_reached(req.sync_name)

    # ---------------- parallel config ----------------
    def _get_paral_config(self, req: m.ParallelConfigRequest):
        # Version 0, never tuned: the strategy generator that tunes it
        # reads the job metric collector (ROADMAP queue 1, item 10's
        # rest).
        return self._paral_config

    # ---------------- cluster version ----------------
    def _get_cluster_version(self, req: m.ClusterVersionRequest):
        store = self._state_store
        version = store.incarnation if store is not None else 0
        return m.ClusterVersion(version_type=req.version_type, version=version)

    # ---------------- job exit ----------------
    def _handle_job_exit(self, req: m.JobExitRequest):
        self._job_exit = req
        logger.info("job exit requested: success=%s reason=%s",
                    req.success, req.reason)
        return m.Response()

    def job_exit_request(self):
        return self._job_exit

    _HANDLERS = {}


MasterServicer._HANDLERS = {
    m.JoinRendezvous: MasterServicer._join_rendezvous,
    m.CommWorldRequest: MasterServicer._get_comm_world,
    m.WaitingNodeNumRequest: MasterServicer._num_nodes_waiting,
    m.WorldStatusRequest: MasterServicer._world_status,
    m.RendezvousParams: MasterServicer._update_rdzv_params,
    m.DeviceCheckResult: MasterServicer._report_check_result,
    m.FaultNodesRequest: MasterServicer._get_fault_nodes,
    m.StragglersRequest: MasterServicer._get_stragglers,
    m.KVStoreSet: MasterServicer._kv_set,
    m.KVStoreGet: MasterServicer._kv_get,
    m.KVStoreAdd: MasterServicer._kv_add,
    m.KVStoreMultiGet: MasterServicer._kv_multi_get,
    m.KVStoreDelete: MasterServicer._kv_delete,
    m.CkptWriterElect: MasterServicer._ckpt_writer_elect,
    m.GlobalStep: MasterServicer._report_step,
    m.NodeResourceStats: MasterServicer._report_resource,
    m.NodeFailure: MasterServicer._report_failure,
    m.NodeHeartbeat: MasterServicer._report_heartbeat,
    m.AgentBeat: MasterServicer._agent_beat,
    m.NodeStatusReport: MasterServicer._report_node_status,
    m.SyncJoin: MasterServicer._sync_join,
    m.SyncFinish: MasterServicer._sync_finished,
    m.SyncBarrierRequest: MasterServicer._sync_barrier,
    m.ParallelConfigRequest: MasterServicer._get_paral_config,
    m.ClusterVersionRequest: MasterServicer._get_cluster_version,
    m.JobExitRequest: MasterServicer._handle_job_exit,
}


#: High-volume periodic telemetry classes routed to the RPC server's
#: bulk worker lane; everything else (rendezvous, kv barriers, failures)
#: stays on the control lane, so a telemetry storm can exhaust bulk
#: workers without queueing ahead of a rendezvous join.
_BULK_CLASSES = (
    m.EventReport,
    m.GlobalStep,
    m.NodeResourceStats,
    m.NodeHeartbeat,
    m.AgentBeat,
    m.ModelInfo,
    m.LeaseRequest,
    m.LeaseReport,
    m.WalSubscribe,
)


def message_priority(request: Any) -> str:
    """RpcServer lane classifier: ``bulk`` for periodic telemetry,
    ``control`` for everything latency-critical."""
    return "bulk" if isinstance(request, _BULK_CLASSES) else "control"


def create_master_service(port: int, servicer: MasterServicer) -> RpcServer:
    return RpcServer(port, servicer.handle, classify=message_priority)
