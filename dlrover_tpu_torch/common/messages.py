"""Typed control-plane messages — the port's twins of the 53 dataclasses
of ``dlrover_tpu/common/messages.py``, with the same names, fields and
defaults, so that one pickle is either package's message: the wire codec
(``common/wire.py``) writes and reads these classes under the JAX
package's module name.

Every request whose handler mutates durable master state declares it
with a ``journaled`` class attribute — ``True`` for write-ahead
journaling, ``"apply-then-log"`` for dispatch-style records logged after
the handler picks the payload (``master/servicer.py``).
"""

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class BaseRequest:
    node_id: int = 0
    node_type: str = "worker"


# ---------------- rendezvous ----------------


@dataclass
class JoinRendezvous(BaseRequest):
    rdzv_name: str = ""
    node_rank: int = 0
    local_world_size: int = 1
    round: int = 0


@dataclass
class CommWorldRequest(BaseRequest):
    rdzv_name: str = ""
    node_rank: int = 0
    round: int = 0


@dataclass
class CommWorld:
    rdzv_name: str = ""
    round: int = -1
    group: int = 0
    # node_rank -> local world size (process count on the node)
    world: Dict[int, int] = field(default_factory=dict)


@dataclass
class WaitingNodeNumRequest(BaseRequest):
    rdzv_name: str = ""


@dataclass
class WorldStatusRequest(BaseRequest):
    """Is the round this agent is running still the live world?  Stale
    means a member died (heartbeat/hang) and survivors must re-form."""

    rdzv_name: str = ""
    round: int = 0


@dataclass
class RendezvousParams(BaseRequest):
    min_nodes: int = 1
    max_nodes: int = 1
    waiting_timeout: float = 30.0
    node_unit: int = 1


# ---------------- device check / diagnosis ----------------


@dataclass
class DeviceCheckResult(BaseRequest):
    node_rank: int = 0
    normal: bool = True
    elapsed_time: float = 0.0
    round: int = 0


@dataclass
class FaultNodesRequest(BaseRequest):
    pass


@dataclass
class StragglersRequest(BaseRequest):
    pass


@dataclass
class BrainStatusRequest(BaseRequest):
    """Read-only view of the brain decision layer (target world,
    parked nodes, recommendation, action counters)."""

    pass


@dataclass
class DiagnosisResult:
    nodes: List[int] = field(default_factory=list)
    done: bool = False
    # Number of check rounds whose members have all reported; lets an agent
    # distinguish "another round is needed" from "current round still
    # reporting" without racing other agents.
    completed_rounds: int = 0


# ---------------- kv store ----------------


@dataclass
class KVStoreSet(BaseRequest):
    journaled = True

    key: str = ""
    value: bytes = b""


@dataclass
class KVStoreGet(BaseRequest):
    key: str = ""


@dataclass
class KVStoreAdd(BaseRequest):
    journaled = True

    key: str = ""
    amount: int = 1


@dataclass
class KVStoreMultiGet(BaseRequest):
    keys: Tuple[str, ...] = ()


@dataclass
class KVStoreDelete(BaseRequest):
    journaled = True

    key: str = ""


# ---------------- dynamic data sharding ----------------


@dataclass
class DatasetShardParams(BaseRequest):
    journaled = True

    dataset_name: str = ""
    dataset_size: int = 0
    shard_size: int = 0
    num_epochs: int = 1
    shuffle: bool = False
    storage_type: str = "table"
    num_minibatches_per_shard: int = 0


@dataclass
class TaskRequest(BaseRequest):
    # Logged after dispatch (the record must carry the chosen shard's
    # exact range), not write-ahead — see servicer._APPLY_THEN_LOG.
    journaled = "apply-then-log"

    dataset_name: str = ""


@dataclass
class ShardTask:
    task_id: int = -1
    task_type: str = "training"
    dataset_name: str = ""
    shard_name: str = ""
    start: int = 0
    end: int = 0
    record_indices: Optional[List[int]] = None
    # Set on empty answers: True when the dataset is fully consumed (todo
    # AND doing empty, epochs done) — an empty answer with finished=False
    # means "retry: in-flight shards may yet be re-dispatched".
    finished: bool = False
    # True when the master does not know the dataset (e.g. it restarted
    # and lost registrations); clients should re-register and retry.
    unknown: bool = False

    @property
    def exists(self) -> bool:
        return self.task_id >= 0


@dataclass
class TaskReport(BaseRequest):
    journaled = True

    dataset_name: str = ""
    task_id: int = -1
    success: bool = True


@dataclass
class TaskHoldReport(BaseRequest):
    """Fencing re-report: "I am still holding this dispatched shard".

    Sent by a client that observed a master incarnation change, for every
    task it fetched but has not yet acked. A recovered master that knows
    the task (journal replay) just reaffirms the assignment; one that
    lost it (e.g. the dispatch raced the crash) re-installs the shard
    from the carried range so the records cannot be dispatched twice or
    dropped.
    """

    journaled = True

    dataset_name: str = ""
    task_id: int = -1
    start: int = 0
    end: int = 0
    shard_name: str = ""
    record_indices: Optional[List[int]] = None


@dataclass
class LeaseRequest(BaseRequest):
    """Bulk shard lease: hundreds of contiguous shards in one RPC.

    The data-plane amortization lever — one grant covers seconds of a
    host's consumption, so the master sees O(1/lease) RPCs instead of
    O(1/shard). Logged after dispatch like :class:`TaskRequest` (the
    record must carry the shard ids the handler chose); see
    ``servicer._APPLY_THEN_LOG``.
    """

    journaled = "apply-then-log"

    dataset_name: str = ""
    #: max shards wanted; 0 = the master's per-dataset target
    #: (DLROVER_TPU_SHARD_LEASE_SHARDS).
    max_shards: int = 0


@dataclass
class ShardLease:
    """A granted lease: a batch of shard tasks owned by one agent.

    Every task is simultaneously a ``doing`` entry in the TaskManager
    (worker_id = the leasing agent), so worker-failure recovery and the
    doing-timeout keep working unchanged underneath the lease."""

    lease_id: int = -1
    dataset_name: str = ""
    tasks: List[ShardTask] = field(default_factory=list)
    #: seconds the holder has to renew (any LeaseReport renews) before
    #: the whole lease is re-dispatched.
    ttl_s: float = 0.0
    #: mirrors ShardTask.finished/unknown for empty answers.
    finished: bool = False
    unknown: bool = False

    @property
    def exists(self) -> bool:
        return self.lease_id >= 0


@dataclass
class LeaseReport(BaseRequest):
    """Batched completion/renewal/release for a held lease.

    Journaled + request-id-deduped like every mutating RPC, so a retried
    completion batch lands exactly once — the at-least-once shard
    contract survives both client retries and master failover replay.
    ``success=False`` in the answer means the master no longer knows the
    lease (expired or lost): its shards were already re-dispatched, so
    the broker must drop its local copies and lease afresh.
    """

    journaled = True

    dataset_name: str = ""
    lease_id: int = -1
    #: task ids whose records were trained (acked exactly once each).
    done_ids: List[int] = field(default_factory=list)
    #: task ids handed back for immediate re-dispatch.
    failed_ids: List[int] = field(default_factory=list)
    #: True: release the lease — every still-outstanding shard returns
    #: to todo (agent shutdown / rescale handback).
    release: bool = False


@dataclass
class ShardCheckpointRequest(BaseRequest):
    dataset_name: str = ""


@dataclass
class ShardCheckpoint:
    content: str = ""


@dataclass
class DatasetEpochRequest(BaseRequest):
    dataset_name: str = ""


# ---------------- metrics / monitoring ----------------


@dataclass
class GlobalStep(BaseRequest):
    step: int = 0
    timestamp: float = 0.0


@dataclass
class NodeResourceStats(BaseRequest):
    cpu_percent: float = 0.0
    used_memory_mb: int = 0
    device_stats: List[Dict] = field(default_factory=list)


@dataclass
class ModelInfo(BaseRequest):
    params_count: int = 0
    flops_per_step: float = 0.0
    batch_size: int = 0
    seq_len: int = 0
    extra: Dict = field(default_factory=dict)


@dataclass
class NodeFailure(BaseRequest):
    journaled = True

    error_data: str = ""
    level: str = "process_error"
    restart_count: int = 0


@dataclass
class NodeHeartbeat(BaseRequest):
    timestamp: float = 0.0


@dataclass
class AgentBeat(BaseRequest):
    """One coalesced periodic agent RPC: node heartbeat + newest step
    progress + the latest link-probe sample, folded into a single
    message so 10k agents cost one RPC per interval each instead of
    three. Not journaled: every constituent is soft state (heartbeat
    times are zeroed on restore, steps are monotonic maxima, probe
    samples are ring-only telemetry), so a replayed/duplicated beat is
    idempotent by construction.
    """

    timestamp: float = 0.0
    #: Newest observed global step; -1 = no step progress this interval.
    step: int = -1
    step_ts: float = 0.0
    #: Latest link-probe sample (empty = none this interval).
    probe: Dict = field(default_factory=dict)


@dataclass
class EventReport(BaseRequest):
    """A batch of JobEvents forwarded from an agent/worker event buffer.

    Journaled + request-id-deduped like every mutating RPC, so a retried
    batch lands in the master's EventLog exactly once.
    """

    journaled = True

    events: List = field(default_factory=list)


# ---------------- live rescale plane ----------------


@dataclass
class RescalePlan:
    """A master-issued in-place scale transition (old world → new world).

    Issued by the RescaleCoordinator when a rendezvous round bump leaves a
    surviving quorum, instead of killing the fleet: survivors re-shard live
    state onto the new mesh and keep training. ``accum_counts`` is the
    derived per-rank microbatch schedule preserving the exact global batch
    across the transition (see ``common/batching.py``).
    """

    plan_id: int = -1
    rdzv_name: str = ""
    #: the round being superseded (the one the survivors were running)
    old_round: int = -1
    #: the round the plan installs; survivors adopt it without rejoining
    new_round: int = -1
    # node_rank -> local world size, before and after
    old_world: Dict[int, int] = field(default_factory=dict)
    new_world: Dict[int, int] = field(default_factory=dict)
    global_batch: int = 0
    #: effective micro batch of the derived schedule
    micro_batch: int = 0
    #: microbatches per new-world rank (dense, index = new rank order)
    accum_counts: List[int] = field(default_factory=list)
    #: newest global step known snapshotted to shm (freshness fence)
    snapshot_step: int = -1
    #: "issued" | "complete" | "aborted"
    status: str = ""
    #: mesh reshape: the ParallelSpec the fleet was running and
    #: the one the coordinator's constrained-world search picked for the
    #: surviving devices, as ``dataclasses.asdict`` dicts (degree name →
    #: degree, plus ``zero``). Empty dicts = DP-only plan (pre-reshape
    #: journals replay unchanged); survivors then keep their mesh and
    #: only retune the accumulation schedule.
    old_spec: Dict[str, Any] = field(default_factory=dict)
    new_spec: Dict[str, Any] = field(default_factory=dict)

    @property
    def exists(self) -> bool:
        return self.plan_id >= 0

    @property
    def reshapes(self) -> bool:
        """True when the plan carries a searched mesh change (not just
        a new accumulation schedule)."""
        return bool(self.new_spec) and self.new_spec != self.old_spec


@dataclass
class RescalePlanRequest(BaseRequest):
    """Poll for an active rescale plan covering this node's round.

    Read-only: agents/workers poll it when their round goes stale to learn
    whether to transition in place instead of tearing down.
    """

    rdzv_name: str = ""
    node_rank: int = 0
    round: int = 0


@dataclass
class RescaleAck(BaseRequest):
    """A survivor's report that it applied (or failed to apply) a plan.

    Journaled: the ack set decides whether the plan completes or aborts
    (abort invalidates the round so survivors fall back to full restart),
    and that decision must survive a master restart.
    """

    journaled = True

    plan_id: int = -1
    node_rank: int = 0
    ok: bool = True
    error: str = ""


# ---------------- checkpoint writer election ----------------


@dataclass
class CkptWriterElect(BaseRequest):
    """Propose this replica as the disk writer for a checkpoint group.

    First claimant wins: the master answers every proposer for the same
    (group, epoch) with the one elected owner rank. Journaled — replay
    re-runs the same first-claimant race in journal order, so the winner
    is identical after a master failover and no second writer is ever
    elected for a committed epoch.
    """

    journaled = True

    #: checkpoint group identity, e.g. "<ckpt_dir>:shard<gid>"
    group: str = ""
    #: election epoch (restart incarnation); a new epoch re-elects
    epoch: int = 0
    #: the proposing replica's rank along the data axis
    rank: int = -1


@dataclass
class CkptWriterLease:
    """The election answer: which replica persists this group this epoch."""

    group: str = ""
    epoch: int = 0
    owner_rank: int = -1

    @property
    def exists(self) -> bool:
        return self.owner_rank >= 0


# ---------------- preemption plane ----------------


@dataclass
class PreemptionNotice(BaseRequest):
    """A known-ahead termination notice for one node.

    The agent's preemption watcher reports this as soon as any notice
    source fires (notice file, env flip, metadata shim, chaos drill); the
    deadline is the wall-clock instant the infrastructure promised to
    kill the node. Journaled — a master failover mid-notice must replay
    the pending notice exactly once so the proactive shrink and writer
    handoff are not lost or doubled. Duplicate reports for the same node
    dedupe inside the coordinator (the first deadline wins).
    """

    journaled = True

    #: rank of the node the notice targets
    node_rank: int = -1
    #: wall-clock deadline (time.time()) the kill was promised for
    deadline_ts: float = 0.0
    #: grace window length in seconds, as announced by the source
    grace_s: float = 0.0
    #: which watcher source fired: "file" | "env" | "metadata" | "chaos"
    source: str = ""
    #: free-form reason string from the notice source
    reason: str = ""


# ---------------- sync service ----------------


@dataclass
class SyncJoin(BaseRequest):
    sync_name: str = ""
    worker_rank: int = 0


@dataclass
class SyncFinish(BaseRequest):
    sync_name: str = ""


@dataclass
class SyncBarrierRequest(BaseRequest):
    sync_name: str = ""
    notify: bool = False


# ---------------- runtime-tunable parallel config ----------------


@dataclass
class ParallelConfigRequest(BaseRequest):
    pass


@dataclass
class ParallelConfig:
    dataloader: Dict = field(default_factory=dict)
    mesh: Dict = field(default_factory=dict)
    version: int = 0


# ---------------- master hot standby (WAL streaming) ----------------


@dataclass
class WalSubscribe(BaseRequest):
    """A standby's pull for the next durable slice of the primary's WAL.

    Read-only on the primary (never journaled — the replication stream
    must not feed back into itself). The cursor is (``from_seq``,
    ``from_offset``): the commit seq and journal byte offset the standby
    has durably applied. A cursor of (0, 0) — or one the primary cannot
    serve because the journal rotated underneath it — is answered with a
    full-resync snapshot instead of a segment.
    """

    #: last commit seq the standby holds durable (0 = bootstrap)
    from_seq: int = 0
    #: byte offset into the primary's current journal file (0 = start)
    from_offset: int = 0
    #: cap on segment bytes per pull (server also caps by its own knob)
    max_bytes: int = 0


@dataclass
class WalSegment:
    """One replication pull's answer: a snapshot or a WAL byte range.

    ``kind`` is ``"snapshot"`` (full resync: ``data`` is a complete
    snapshot file image, byte-identical to the primary's newest snapshot;
    the standby replaces its replica and resumes from the fresh cursor)
    or ``"segment"`` (``data`` is whole-frame-aligned journal bytes
    starting at ``offset``; empty when the standby is caught up). The
    cursor the standby should pull from next is (``next_seq``,
    ``next_offset``); ``durable_seq``/``commit_seq`` let it compute
    replication lag.
    """

    kind: str = "segment"
    #: commit seq the data starts after (snapshot: seq captured within)
    seq: int = 0
    #: journal byte offset ``data`` starts at (snapshot: 0)
    offset: int = 0
    data: bytes = b""
    next_seq: int = 0
    next_offset: int = 0
    #: primary's durable/commit seqs and durable byte offset at read
    #: time (lag accounting: lag_bytes = durable_offset - local cursor)
    durable_seq: int = 0
    commit_seq: int = 0
    durable_offset: int = 0
    #: primary's incarnation — a standby seeing this move without a
    #: lease transition knows the world changed underneath it
    incarnation: int = 0


# ---------------- job / node lifecycle ----------------


@dataclass
class NodeStatusReport(BaseRequest):
    journaled = True

    status: str = ""
    exit_reason: str = ""


@dataclass
class ClusterVersionRequest(BaseRequest):
    """Poll the master's fencing epoch (state-store incarnation).

    A client that cached tasks across a master restart compares epochs
    to decide whether it must re-register/re-report (see
    :class:`TaskHoldReport`).
    """

    version_type: str = "local"


@dataclass
class ClusterVersion:
    version_type: str = "local"
    version: int = 0


@dataclass
class JobExitRequest(BaseRequest):
    success: bool = True
    reason: str = ""


@dataclass
class Response:
    success: bool = True
    reason: str = ""
