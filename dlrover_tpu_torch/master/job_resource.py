"""Per-role job resource bookkeeping + OOM-driven adjustment (the port's
copy of ``dlrover_tpu/master/job_resource.py``).

Parity: the reference's ``master/resource/job.py`` (``JobResource``:
per-role NodeGroupResource accounting, 569 LoC with PS/chief/evaluator
machinery) and the OOM-adjustment paths of its JobResourceOptimizer
(``adjust_oom_resource``). The allreduce cut keeps the roles generic
(workers dominate; PS is N/A by design — SURVEY §2.2) and the policy
explicit: every role's requested resources live here, scalers read the
CURRENT truth from one place, and an OOM kill escalates the role's
memory geometrically up to a cap before giving up.
"""

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node, NodeGroupResource, NodeResource


class JobResource:
    """The job's per-role resource table (requested state)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: Dict[str, NodeGroupResource] = {}

    # ------------- accounting -------------
    def update_node_group_resource(self, node_type: str, num: int,
                                   cpu: float, memory_mb: int):
        with self._lock:
            self._groups[node_type] = NodeGroupResource(
                count=num,
                node_resource=NodeResource(cpu=cpu, memory_mb=memory_mb),
            )

    def get_node_group_resource(
        self, node_type: str
    ) -> Optional[NodeGroupResource]:
        with self._lock:
            return self._groups.get(node_type)


@dataclass
class OomPolicy:
    """Geometric memory escalation on OOM kills (parity:
    ``_adjust_oom_worker_resource``'s stepped increments)."""

    factor: float = 1.5
    max_memory_mb: int = 262144  # 256 GiB host RAM ceiling
    max_escalations: int = 4


class JobResourceManager:
    """Owns the JobResource truth; turns OOM events into updated
    per-role requests the scaler realizes: an OOM-killed node escalates
    its role's memory before relaunch instead of crash-looping at the
    same size. (The JAX manager also records the resource optimizer's
    plans, which come with auto-scaling, ROADMAP queue 1, item 10's
    rest.)"""

    def __init__(self, policy: Optional[OomPolicy] = None):
        self.job_resource = JobResource()
        self.policy = policy or OomPolicy()
        self._oom_counts: Dict[str, int] = {}

    def init_from_config(self, worker_num: int, cpu: float = 0.0,
                         memory_mb: int = 0):
        self.job_resource.update_node_group_resource(
            "worker", worker_num, cpu, memory_mb
        )

    def adjust_oom_resource(self, node: Node) -> Optional[NodeGroupResource]:
        """Escalate the role's memory after an OOM kill; returns the new
        group resource, or None when the cap/escalation budget is spent
        (the node should then be treated as fatally failed, not
        relaunched into the same OOM loop)."""
        role = node.type
        count = self._oom_counts.get(role, 0)
        if count >= self.policy.max_escalations:
            logger.error(
                "role %s hit the OOM escalation budget (%d); giving up",
                role, count,
            )
            return None
        group = self.job_resource.get_node_group_resource(role)
        if group is None:
            return None
        cur = group.node_resource.memory_mb
        new_mem = min(
            int(max(cur, 1024) * self.policy.factor),
            self.policy.max_memory_mb,
        )
        if new_mem <= cur:
            logger.error(
                "role %s already at the memory ceiling (%d MB)", role, cur
            )
            return None
        self._oom_counts[role] = count + 1
        self.job_resource.update_node_group_resource(
            role, group.count, group.node_resource.cpu, new_mem
        )
        logger.info(
            "OOM on %s-%s: memory %d -> %d MB (escalation %d/%d)",
            role, node.id, cur, new_mem, count + 1,
            self.policy.max_escalations,
        )
        return self.job_resource.get_node_group_resource(role)
