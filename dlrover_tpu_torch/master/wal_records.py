"""WAL record-tag registry: one row per journal record kind — the port's
copy of ``dlrover_tpu/master/wal_records.py``, split in two.

A journal written by the JAX master holds every kind below; the port's
master writes and replays the kinds of :data:`WAL_RECORDS` and skips the
others, naming the ROADMAP queue 1 item that brings the subsystem
replaying them (:data:`LEFT_OUT`). The tags and record shapes are the
JAX package's, so a journal of either master replays in the other.
"""

from typing import Dict, Tuple

#: tag -> the apply handler(s) ``JobMaster._recover_state`` dispatches
#: that record kind to. ``"rpc"`` re-enters the servicer dispatch, so
#: its effective handlers are the journaled RPC handler methods.
WAL_RECORDS: Dict[str, Tuple[str, ...]] = {
    # ("rpc", request_id, request, ts) — journaled write-ahead RPCs,
    # replayed through the full servicer dispatch.
    "rpc": ("MasterServicer.handle",),
    # ("evict", node_id, reason, ts) — master-initiated eviction. The
    # dispatcher re-enters _evict_node, whose write-ahead branch is
    # replay-guarded so only _apply_evict re-runs.
    "evict": ("JobMaster._evict_node",),
    # ("rdzv", name, state, ts) — absolute rendezvous counters;
    # restore() max-merges, so duplicates are no-ops.
    "rdzv": ("RendezvousManager.restore",),
}

#: tag -> the ROADMAP queue 1 item whose subsystem replays it: the task
#: manager and shard leases (dispatch, shards, reclaim, lease) and the
#: rescale coordinator (rescale, reshape) are item 4, the event log
#: item 5, the preemption coordinator, remediation and the brain item
#: 10's rest.
LEFT_OUT: Dict[str, str] = {
    "dispatch": "4", "shards": "4", "reclaim": "4", "lease": "4",
    "rescale": "4", "reshape": "4", "event": "5",
    "preempt": "10's rest", "remediate": "10's rest", "brain": "10's rest",
}

#: The sections of a JAX master's snapshot that the port's master does
#: not restore, with their item (the JAX master restores a snapshot
#: without them as a fresh subsystem).
LEFT_OUT_STATE: Dict[str, str] = {
    "task_manager": "4", "shard_lease": "4", "rescale": "4",
    "events": "5", "preempt": "10's rest", "remediation": "10's rest",
    "brain": "10's rest",
}
