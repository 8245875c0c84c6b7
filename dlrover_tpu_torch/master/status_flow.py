"""Legal node status transitions + relaunch decisions (the port's copy of
``dlrover_tpu/master/status_flow.py``).

Parity: reference ``master/node/status_flow.py`` — a transition table from
(from_status, to_status, exit_reason) to whether the node should be
relaunched.
"""

from dataclasses import dataclass

from dlrover_tpu_torch.common.constants import NodeExitReason, NodeStatus


@dataclass
class NodeStateFlow:
    from_status: str
    to_status: str
    should_relaunch: bool


_FLOWS = [
    NodeStateFlow(NodeStatus.INITIAL, NodeStatus.PENDING, False),
    NodeStateFlow(NodeStatus.INITIAL, NodeStatus.RUNNING, False),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.RUNNING, False),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.SUCCEEDED, False),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.FAILED, True),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.DELETED, True),
    NodeStateFlow(NodeStatus.RUNNING, NodeStatus.SUCCEEDED, False),
    NodeStateFlow(NodeStatus.RUNNING, NodeStatus.FAILED, True),
    NodeStateFlow(NodeStatus.RUNNING, NodeStatus.DELETED, True),
    NodeStateFlow(NodeStatus.SUCCEEDED, NodeStatus.DELETED, False),
    NodeStateFlow(NodeStatus.FAILED, NodeStatus.DELETED, False),
]


def get_node_state_flow(from_status: str, to_status: str) -> NodeStateFlow:
    if from_status == to_status:
        return NodeStateFlow(from_status, to_status, False)
    for flow in _FLOWS:
        if flow.from_status == from_status and flow.to_status == to_status:
            return flow
    # Unknown transition: allow it, do not relaunch.
    return NodeStateFlow(from_status, to_status, False)


def should_relaunch(node, flow: NodeStateFlow, relaunch_on_worker_failure: int = 3):
    """Refine the table decision with node-level facts."""
    decision = flow.should_relaunch
    if not decision:
        return False
    if not node.relaunchable:
        return False
    if node.exit_reason == NodeExitReason.SUCCEEDED:
        return False
    if node.exit_reason == NodeExitReason.FATAL_ERROR:
        return False
    if node.exit_reason == NodeExitReason.PREEMPTED:
        # Planned departure announced by the preemption plane; the
        # survivors already transitioned in place — relaunching the
        # victim would fight the shrink plan it was removed by.
        return False
    if node.relaunch_count >= min(node.max_relaunch_count, relaunch_on_worker_failure):
        return False
    return True
