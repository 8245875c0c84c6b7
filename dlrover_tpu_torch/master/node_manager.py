"""Node lifecycle management on the master (the port's copy of
``dlrover_tpu/master/node_manager.py``).

Parity: reference ``master/node/dist_job_manager.py`` + ``local_job_manager.py``
— the master tracks one :class:`~dlrover_tpu_torch.common.node.Node` per agent,
consumes status reports/heartbeats/failures, decides relaunch vs abort via
the status flow, and (on a scheduler-backed platform) drives a scaler with
``ScalePlan``s. The local platform has no scheduler, so relaunch decisions
only feed rendezvous membership; the agent's own process supervision does
the respawning.
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.lockdep import instrumented_lock
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node, NodeGroupResource, NodeResource
from dlrover_tpu_torch.master.monitor.error_monitor import ErrorMonitor
from dlrover_tpu_torch.master.status_flow import get_node_state_flow, should_relaunch


@dataclass
class ScalePlan:
    """A requested change to the node set (parity: ScalePlan CRD)."""

    node_group_resources: Dict[str, NodeGroupResource] = field(default_factory=dict)
    launch_nodes: List[Node] = field(default_factory=list)
    remove_nodes: List[Node] = field(default_factory=list)

    def empty(self) -> bool:
        return not (
            self.node_group_resources or self.launch_nodes or self.remove_nodes
        )


class Scaler:
    """Platform backend that realizes a ScalePlan (k8s/GKE later)."""

    def scale(self, plan: ScalePlan):
        raise NotImplementedError


class NoopScaler(Scaler):
    def scale(self, plan: ScalePlan):
        if not plan.empty():
            logger.info("noop scaler ignoring plan %s", plan)


class JobManager:
    """Tracks job nodes and reacts to their lifecycle events."""

    GUARDED_BY = {
        "_nodes": "master.node_manager",
        "_preempting": "master.node_manager",
    }

    def __init__(
        self,
        node_num: int = 1,
        max_relaunch_count: int = 3,
        scaler: Optional[Scaler] = None,
        error_monitor: Optional[ErrorMonitor] = None,
        heartbeat_timeout: float = 120.0,
        resource_manager=None,
    ):
        self._lock = instrumented_lock("master.node_manager")
        self._nodes: Dict[int, Node] = {}
        self._node_num = node_num
        self._max_relaunch_count = max_relaunch_count
        self._scaler = scaler or NoopScaler()
        self._error_monitor = error_monitor or ErrorMonitor()
        self._heartbeat_timeout = heartbeat_timeout
        # Per-role resource bookkeeping + OOM escalation
        # (master/job_resource.py; optional — tests may inject).
        if resource_manager is None:
            from dlrover_tpu_torch.master.job_resource import JobResourceManager

            resource_manager = JobResourceManager()
            resource_manager.init_from_config(node_num)
        self.resource_manager = resource_manager
        self._stopped = False
        # Node ids with an active preemption notice: their upcoming exit
        # is planned, so process_error must not treat it as a crash
        # (no relaunch, no OOM escalation). Set by the JAX master's
        # preemption coordinator (ROADMAP queue 1, item 10's rest); here
        # only a recovered registry carries it.
        self._preempting: set = set()
        for i in range(node_num):
            node = Node(
                NodeType.WORKER, i, max_relaunch_count=max_relaunch_count
            )
            self._nodes[i] = node

    # ---------------- queries ----------------
    def get_node(self, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_id)

    def all_nodes(self) -> List[Node]:
        with self._lock:
            return list(self._nodes.values())

    def alive_worker_ranks(self) -> List[int]:
        with self._lock:
            return [
                n.rank_index
                for n in self._nodes.values()
                if n.status in (NodeStatus.RUNNING, NodeStatus.PENDING,
                                NodeStatus.INITIAL)
            ]

    def all_workers_exited(self) -> bool:
        with self._lock:
            return bool(self._nodes) and all(
                n.exited() for n in self._nodes.values()
            )

    def all_workers_succeeded(self) -> bool:
        with self._lock:
            return bool(self._nodes) and all(
                n.status == NodeStatus.SUCCEEDED for n in self._nodes.values()
            )

    # ---------------- event intake ----------------
    def update_node_status(self, node_id: int, status: str, exit_reason: str = ""):
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                node = Node(NodeType.WORKER, node_id,
                            max_relaunch_count=self._max_relaunch_count)
                self._nodes[node_id] = node
            old_status = node.status
            flow = get_node_state_flow(old_status, status)
            node.update_status(status)
            if exit_reason:
                node.exit_reason = exit_reason
            relaunch = False
            if flow.should_relaunch:
                relaunch = should_relaunch(node, flow, self._max_relaunch_count)
                if relaunch:
                    node.inc_relaunch_count()
        if relaunch:
            self._relaunch_node(node)
        return relaunch

    def report_heartbeat(self, node_id: int, timestamp: float):
        with self._lock:
            node = self._nodes.get(node_id)
            if node:
                node.heartbeat_time = timestamp or time.time()
                if node.status in (NodeStatus.INITIAL, NodeStatus.PENDING):
                    node.update_status(NodeStatus.RUNNING)

    # ---------------- preemption plane ----------------
    def is_preempting(self, node_id: int) -> bool:
        with self._lock:
            return int(node_id) in self._preempting

    def process_error(
        self, node_id: int, restart_count: int, error_data: str, level: str
    ) -> bool:
        if self.is_preempting(node_id):
            # Planned departure: the infrastructure announced this exit
            # ahead of time and the preemption plane already flushed and
            # handed off. No relaunch decision, no OOM escalation —
            # the node registry just records the preempted status.
            self.update_node_status(
                node_id, NodeStatus.FAILED, NodeExitReason.PREEMPTED
            )
            return False
        relaunch_node = self._error_monitor.process_error(
            node_id, restart_count, error_data, level
        )
        if relaunch_node:
            reason = self._error_monitor.classify(error_data)
            if reason == NodeExitReason.OOM:
                # Escalate the role's memory request before the relaunch
                # (parity: JobResourceOptimizer.adjust_oom_resource) —
                # relaunching into the same size just OOM-loops. A spent
                # escalation budget makes the failure fatal.
                node = self.get_node(node_id)
                if node is not None:
                    adjusted = self.resource_manager.adjust_oom_resource(
                        node
                    )
                    if adjusted is None:
                        node.relaunchable = False
                        relaunch_node = False
            self.update_node_status(node_id, NodeStatus.FAILED, reason)
        return relaunch_node

    def _relaunch_node(self, node: Node):
        logger.info("relaunching node %s (count %s)", node.id, node.relaunch_count)
        plan = ScalePlan(launch_nodes=[node.get_relaunch_node()],
                         remove_nodes=[node])
        self._scaler.scale(plan)
        with self._lock:
            fresh = node.get_relaunch_node()
            fresh.update_status(NodeStatus.PENDING)
            self._nodes[node.id] = fresh

    # ---------------- hang detection ----------------
    def find_dead_nodes(self) -> List[int]:
        """Nodes whose heartbeat went stale."""
        now = time.time()
        dead = []
        with self._lock:
            for node in self._nodes.values():
                if (
                    node.status == NodeStatus.RUNNING
                    and node.heartbeat_time > 0
                    and now - node.heartbeat_time > self._heartbeat_timeout
                ):
                    dead.append(node.id)
        return dead

    def remove_node(self, node_id: int, reason: str = "") -> bool:
        """Scale-in a permanently-lost node: it stops counting toward
        all_workers_exited/succeeded so survivors can finish the job.
        (The local platform has no scheduler to bring it back; a node
        that does come back re-registers via its next status report.)"""
        with self._lock:
            node = self._nodes.pop(node_id, None)
            remaining = len(self._nodes)
        if node is None:
            return False
        logger.warning(
            "removed node %s from the job (%s); %s nodes remain",
            node_id, reason or "permanent loss", remaining,
        )
        return True

    def stop(self):
        self._stopped = True

    # ------------- master state snapshot/restore -------------
    def export_nodes(self) -> List[Dict]:
        with self._lock:
            return [
                {
                    "id": n.id,
                    "type": n.type,
                    "rank_index": n.rank_index,
                    "name": n.name,
                    "status": n.status,
                    "exit_reason": n.exit_reason,
                    "relaunch_count": n.relaunch_count,
                    "relaunchable": n.relaunchable,
                    "max_relaunch_count": n.max_relaunch_count,
                    "preempting": n.id in self._preempting,
                }
                for n in self._nodes.values()
            ]

    def restore_nodes(self, dumped: List[Dict]):
        with self._lock:
            self._nodes.clear()
            self._preempting.clear()
            for d in dumped:
                if d.get("preempting"):
                    self._preempting.add(int(d["id"]))
                node = Node(
                    d["type"], d["id"], rank_index=d.get("rank_index"),
                    name=d.get("name", ""),
                    max_relaunch_count=d.get(
                        "max_relaunch_count", self._max_relaunch_count
                    ),
                )
                node.status = d.get("status", NodeStatus.INITIAL)
                node.exit_reason = d.get("exit_reason", "")
                node.relaunch_count = d.get("relaunch_count", 0)
                node.relaunchable = d.get("relaunchable", True)
                # heartbeat_time stays 0: find_dead_nodes skips such
                # nodes, so a restored registry cannot mass-evict before
                # fenced clients re-register and heartbeat again.
                self._nodes[node.id] = node


class LocalJobManager(JobManager):
    """Single-host deployment: the agent supervises processes itself."""
