"""Typed job events and the process-local emit entry point — the port's
copy of ``EventKind``, ``JobEvent`` and ``emit`` of
``dlrover_tpu/observability/events.py``.

Every process of a job reports what happened to it through :func:`emit`,
which never blocks and never raises. In the JAX package the event then
goes to the master's event log (a sink the master installs) or, from an
agent or a worker, to a reporter that batches it to the master over
``EventReport``; that plane (the event log, the reporter, the tracer
mirror, goodput) is ROADMAP queue 1, item 5. Until it comes, ``emit``
builds the event and returns it, and the port's master answers
``EventReport`` with that item.

``JobEvent`` travels on the master's wire and in its state files under
the JAX package's name (``common/wire.py``), so its fields are the JAX
package's.
"""

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common.constants import NodeEnv


class EventKind:
    """Dotted event names; the prefix is the subsystem."""

    RDZV_ROUND_START = "rendezvous.round_start"
    RDZV_JOIN = "rendezvous.join"
    RDZV_ROUND_COMPLETE = "rendezvous.round_complete"
    RDZV_INVALIDATED = "rendezvous.invalidated"
    NODE_JOIN = "node.join"
    NODE_EVICT = "node.evict"
    NODE_HANG = "node.hang"
    WORKER_RESTART = "worker.restart"
    WORKER_FAIL = "worker.fail"
    CKPT_SAVE = "ckpt.save"
    CKPT_COMMIT = "ckpt.commit"
    CKPT_RESTORE = "ckpt.restore"
    CKPT_FALLBACK = "ckpt.fallback"
    # Striped checkpoint I/O throughput (op="persist"|"read"|"staging"|
    # "persist-skip": bytes, mbps, checksum_s; persist also carries
    # written_bytes/ref_stripes for the incremental-stripe cut and
    # persist-skip marks an election-skipped replica with bytes=0) —
    # the perf counters behind the goodput story.
    CKPT_IO = "ckpt.io"
    CHAOS_INJECT = "chaos.inject"
    STEP_PROGRESS = "step.progress"
    # Per-step wall-time phase breakdown from the trainer (input_s /
    # compute_s / collective_s / readback_s) — high-frequency telemetry,
    # ring-only on the master (excluded from the WAL, see event_log).
    STEP_PHASES = "step.phases"
    # Background agent link probe: D2H/H2D bandwidth proxy + master RPC
    # round-trip — also high-frequency/ring-only.
    PROBE_LINK = "probe.link"
    # Communication plane. comms.profile is the aggregator's periodic
    # per-axis fleet link profile (ring-only — the kv store carries the
    # durable copy); comms.saturated / comms.cleared bracket a sustained
    # host-link saturation episode (durable, low-frequency — the
    # governor's trigger is auditable after the fact); comms.defer is a
    # worker-side governor decision (what="staging"|"readback", step) —
    # step-frequency under saturation, so ring-only.
    COMMS_PROFILE = "comms.profile"
    COMMS_SATURATED = "comms.saturated"
    COMMS_CLEARED = "comms.cleared"
    COMMS_DEFER = "comms.defer"
    # StragglerDetector verdicts: a sustained per-worker outlier was
    # classified (kind=link|compute|input, evidence=...), and later
    # cleared. Durable — these open/close goodput incidents.
    STRAGGLER_DETECT = "straggler.detect"
    STRAGGLER_RECOVER = "straggler.recover"
    # Live rescale plane: plan issued (master), survivor applying /
    # applied in place (worker), plan aborted → fall back to restart.
    RESCALE_PLAN = "rescale.plan"
    RESCALE_APPLY = "rescale.apply"
    RESCALE_COMPLETE = "rescale.complete"
    RESCALE_ABORT = "rescale.abort"
    # Preemption plane: a known-ahead termination notice arrived for a
    # node (context), the master converted it into a planned in-place
    # transition (detection — opens the preempt:handled incident), or the
    # deadline passed with the node still alive and the notice cancelled
    # cleanly (context; leases reverted, nothing restarted).
    PREEMPT_NOTICE = "preempt.notice"
    PREEMPT_HANDLED = "preempt.handled"
    PREEMPT_CANCEL = "preempt.cancel"
    # Automatic straggler remediation (master/remediation.py): a
    # sustained verdict was acted on — the node quarantined out of the
    # world via an in-place shrink (detection — opens the
    # remediation:<kind> incident); its probes recovered and it regrew
    # on probation (recovery — closes it); probation finished clean; an
    # action was nacked/declined and reverted to SUSPECT with backoff
    # (context); or the node failed probation twice and was permanently
    # evicted (closes the incident). REMEDIATION_FAILED surfaces an
    # eviction callback that raised — a broken remediation path must be
    # visible, not swallowed (context).
    REMEDIATION_QUARANTINE = "remediation.quarantine"
    REMEDIATION_PROBATION = "remediation.probation"
    REMEDIATION_CLEAR = "remediation.clear"
    REMEDIATION_REVERT = "remediation.revert"
    REMEDIATION_EVICT = "remediation.evict"
    REMEDIATION_FAILED = "remediation.failed"
    # Master hot standby: a promoted standby took over (carries
    # detect_ts/promote_ts so the goodput ledger books the failover
    # incident's detect/act stamps; emitted by the NEW master so it
    # lands in the surviving event log), and a deposed primary observed
    # a newer incarnation in the lease and fenced its store (context —
    # its log dies with it; the failover incident lives on the winner).
    MASTER_FAILOVER = "master.failover"
    MASTER_FENCED = "master.fenced"
    # Brain decision layer (brain/policy.py): the start recommendation
    # was computed (context — carries feasible/world_size/source); the
    # target world size changed (context); a join was admitted as a
    # brain-sanctioned grow; a chip whose marginal goodput went
    # negative was shrunk out and parked (opens the brain:shrink
    # incident — the chip left the fleet on purpose); a shrink plan
    # aborted and the node was released back (closes it, context); a
    # parked node was released to cover a capacity shortfall (closes
    # it — the spare rejoined).
    BRAIN_RECOMMEND = "brain.recommend"
    BRAIN_TARGET = "brain.target"
    BRAIN_GROW = "brain.grow"
    BRAIN_SHRINK = "brain.shrink"
    BRAIN_REVERT = "brain.revert"
    BRAIN_RELEASE = "brain.release"


@dataclass
class JobEvent:
    kind: str = ""
    ts: float = 0.0
    node_id: int = -1          # -1 = the master itself / unknown
    role: str = ""             # "master" | "agent" | "worker"
    pid: int = 0
    seq: int = -1              # assigned by the master-side EventLog
    args: Dict[str, Any] = field(default_factory=dict)


def _derive_identity() -> Dict[str, Any]:
    node_id = int(os.getenv(NodeEnv.NODE_ID, -1))
    # Workers carry a PROCESS_ID from the agent; anything else that can
    # reach a master defaults to "agent".
    role = "worker" if os.getenv(NodeEnv.PROCESS_ID) else "agent"
    return {"node_id": node_id, "role": role}


def emit(_kind: str, _node_id: Optional[int] = None,
         _role: Optional[str] = None, **args) -> JobEvent:
    """The event, stamped with this process's identity and the time.

    ``_node_id``/``_role`` override the process identity — the master
    uses them to stamp events it records ABOUT a node (evictions, hangs)
    with that node's id so incident attribution lands on the right host.
    All parameters are underscore-prefixed so payload keys can never
    shadow them (a chaos event's payload legitimately contains ``kind``).
    """
    ident = _derive_identity()
    return JobEvent(
        kind=_kind, ts=time.time(),
        node_id=int(_node_id) if _node_id is not None else ident["node_id"],
        role=_role if _role is not None else ident["role"],
        pid=os.getpid(), args=args,
    )
