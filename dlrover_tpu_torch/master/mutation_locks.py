"""Sharded master mutation locks (the port's copy of
``dlrover_tpu/master/mutation_locks.py``).

One global mutation lock serialized every servicer dispatch against
every other — a kv barrier ping could queue behind a 256-event
telemetry batch. These shards split that lock by subsystem so
independent mutations proceed in parallel while each subsystem keeps
its strict journal-order = apply-order guarantee (the state store's
``append`` is internally serialized; cross-shard interleavings replay
identically because replay is single-threaded and the subsystems are
disjoint).

Deadlock discipline: every multi-shard acquisition takes locks in the
canonical ``SHARDS`` order, and each lock carries a lockdep-instrumented
hierarchical name (``master.mutation.<shard>``) so the runtime lockdep
proves the order cycle-free. The store
lock (``master.state_store``) only ever nests INSIDE a shard — never the
reverse — and the snapshot path acquires ALL shards first via
:meth:`MutationLocks.all`, matching that order.
"""

from contextlib import ExitStack, contextmanager
from typing import Dict, Iterable, Tuple

from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common.lockdep import instrumented_lock

#: Canonical acquisition order. Multi-shard holders (NodeFailure, the
#: snapshot quiesce) always acquire in this sequence.
SHARDS: Tuple[str, ...] = ("kv", "tasks", "nodes", "rdzv", "events")

#: Declared lock hierarchy, coarse to fine. Tier 0 is the mutation
#: shards in canonical order (ordered *within* the tier: kv before
#: tasks before ...); later tiers are unordered internally but strictly
#: finer than every earlier tier — a tier-N lock must never be held
#: while acquiring a tier-(N-1) lock. It names the JAX master's locks
#: too, so a lockdep export of either master reads against one order.
#: ``rdzv.*`` matches every per-rendezvous lock (one order class, as in
#: kernel lockdep). ``master.state_store`` sits below everything that
#: journals; ``master.state_store.commit`` is the innermost leaf (the
#: group-commit cv), which is why ``wait_durable`` must be called with
#: no coarser lock held at all.
LOCK_ORDER: Tuple[Tuple[str, ...], ...] = (
    # == tuple(f"master.mutation.{s}" for s in SHARDS).
    (
        "master.mutation.kv",
        "master.mutation.tasks",
        "master.mutation.nodes",
        "master.mutation.rdzv",
        "master.mutation.events",
    ),
    (
        "master.task_manager",
        "master.node_manager",
        "master.kv_store",
        "master.rescale",
        "master.preempt",
        "master.shard_lease",
        "master.sync_service",
        "master.straggler",
        "master.job_collector",
        "rdzv.*",
        "observability.event_log",
    ),
    ("master.state_store",),
    ("master.state_store.commit",),
)

#: Message class -> the shards its handler mutates. A journaled message
#: missing here falls back to every shard (correct, just slower) so a
#: future message class cannot silently under-lock.
_SHARDS_BY_TYPE: Dict[type, Tuple[str, ...]] = {
    m.KVStoreSet: ("kv",),
    m.KVStoreAdd: ("kv",),
    m.KVStoreDelete: ("kv",),
    # Writer election is a first-claimant race over kv state.
    m.CkptWriterElect: ("kv",),
    m.DatasetShardParams: ("tasks",),
    m.TaskRequest: ("tasks",),
    m.TaskReport: ("tasks",),
    # The lease plane is bulk dispatch/ack over the same todo/doing
    # queues the per-call path mutates.
    m.LeaseRequest: ("tasks",),
    m.LeaseReport: ("tasks",),
    m.TaskHoldReport: ("tasks",),
    # Status changes also reclaim the node's in-flight shards.
    m.NodeStatusReport: ("tasks", "nodes"),
    # Failure handling spans the node registry, every rendezvous, task
    # reclaim, and the rescale coordinator (rdzv shard).
    m.NodeFailure: ("tasks", "nodes", "rdzv"),
    # A preemption notice pre-elects writer leases (kv) and flags the
    # victim in the node registry (nodes).
    m.PreemptionNotice: ("kv", "nodes"),
    m.RescaleAck: ("rdzv",),
    m.EventReport: ("events",),
}


class MutationLocks:
    """The servicer's per-subsystem mutation shards."""

    def __init__(self):
        self._locks = {
            name: instrumented_lock(f"master.mutation.{name}", rlock=True)
            for name in SHARDS
        }

    def shard(self, name: str):
        return self._locks[name]

    @contextmanager
    def acquire(self, names: Iterable[str]):
        """Hold the named shards, always in canonical order."""
        wanted = set(names)
        with ExitStack() as stack:
            for name in SHARDS:
                if name in wanted:
                    stack.enter_context(self._locks[name])
            yield

    def all(self):
        """Every shard, in canonical order — the snapshot quiesce and
        the master's own multi-subsystem mutations (evict) use this."""
        return self.acquire(SHARDS)

    def shards_for(self, request) -> Tuple[str, ...]:
        """The canonical-order shard tuple a message's handler holds."""
        wanted = set(_SHARDS_BY_TYPE.get(type(request), SHARDS))
        return tuple(n for n in SHARDS if n in wanted)

    def for_message(self, request) -> "ExitStack":
        return self.acquire(self.shards_for(request))
