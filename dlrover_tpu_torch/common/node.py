"""Node model used by the master — the port's copy of
``dlrover_tpu/common/node.py``."""

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import NodeStatus, NodeType


@dataclass
class NodeResource:
    cpu: float = 0.0
    memory_mb: int = 0
    device_type: str = "h100"
    device_count: int = 0

    def to_dict(self) -> Dict:
        return {
            "cpu": self.cpu,
            "memory_mb": self.memory_mb,
            "device_type": self.device_type,
            "device_count": self.device_count,
        }


@dataclass
class NodeGroupResource:
    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)


class Node:
    """A member of the job: one host (agent) or the master."""

    def __init__(
        self,
        node_type: str = NodeType.WORKER,
        node_id: int = 0,
        rank_index: Optional[int] = None,
        name: str = "",
        config_resource: Optional[NodeResource] = None,
        max_relaunch_count: int = 3,
    ):
        self.type = node_type
        self.id = node_id
        self.rank_index = rank_index if rank_index is not None else node_id
        self.name = name or f"{node_type}-{node_id}"
        self.status = NodeStatus.INITIAL
        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.exit_reason = ""
        self.relaunch_count = 0
        self.max_relaunch_count = max_relaunch_count
        self.relaunchable = True
        self.is_released = False
        self.create_time: Optional[float] = None
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.heartbeat_time: float = 0.0
        self.start_hang = False
        self.reported_status = ""

    def inc_relaunch_count(self):
        self.relaunch_count += 1

    def update_status(self, status: str):
        self.status = status
        now = time.time()
        if status == NodeStatus.RUNNING and self.start_time is None:
            self.start_time = now
        if status in (NodeStatus.SUCCEEDED, NodeStatus.FAILED, NodeStatus.DELETED):
            self.finish_time = now

    def exited(self) -> bool:
        return self.status in (
            NodeStatus.SUCCEEDED,
            NodeStatus.FAILED,
            NodeStatus.DELETED,
        )

    def get_relaunch_node(self) -> "Node":
        node = Node(
            node_type=self.type,
            node_id=self.id,
            rank_index=self.rank_index,
            name=self.name,
            config_resource=self.config_resource,
            max_relaunch_count=self.max_relaunch_count,
        )
        node.relaunch_count = self.relaunch_count + 1
        return node

    def __repr__(self):
        return f"Node({self.type}-{self.id} rank={self.rank_index} {self.status})"
