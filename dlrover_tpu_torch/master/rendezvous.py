"""Rendezvous managers: elastic-training membership + device-check
diagnosis — the port's copy of ``dlrover_tpu/master/rendezvous.py``.

Capability parity with the reference's
``master/elastic_training/rdzv_manager.py``:

- ``RendezvousManager`` — waiting-node admission with min/max nodes,
  ``node_unit`` granularity and a last-call timeout; a frozen *round* is the
  communication world handed to every agent.
- ``ElasticTrainingRendezvousManager`` — one global group per round.
- ``DeviceCheckRendezvousManager`` — the 2-round paired-group diagnosis that
  localizes fault nodes, plus the elapsed-time median×N straggler rule.

A "node" is one host; the master side is transport-agnostic — it only
sees join/report RPCs. The managers read ``time.monotonic()`` through
the module's ``time``, which a test replaces to drive both packages'
managers with one fake clock.
"""

import statistics
import threading
import time
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch.common.lockdep import instrumented_lock
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.events import EventKind, emit


class RendezvousManager(ABC):
    #: The three membership sets are the rendezvous state machine; every transition happens under this manager's rdzv.*
    #: lock. The _freeze_* helpers run inside callers' critical sections
    #: (see their holds() markers).
    GUARDED_BY = {
        "_waiting_nodes": "rdzv.*",
        "_rdzv_nodes": "rdzv.*",
        "_alive_nodes": "rdzv.*",
    }

    def __init__(self, name: str):
        self.name = name
        self._lock = instrumented_lock(f"rdzv.{name}")
        self._min_nodes = 1
        self._max_nodes = 1
        self._node_unit = 1
        self._waiting_timeout = 30.0
        self._lastcall_timeout = 3.0
        # node_rank -> local world size, for nodes asking to join.
        self._waiting_nodes: Dict[int, int] = {}
        # The frozen world of the current round.
        self._rdzv_nodes: Dict[int, int] = {}
        self._rdzv_round = 0
        self._lastcall_time = 0.0
        self._alive_nodes: Set[int] = set()
        self._start_rdzv_time = 0.0
        # Rounds <= this are invalidated (a member died); survivors must
        # re-rendezvous.
        self._stale_round = 0
        # Observer fired (outside the lock) whenever the round/stale
        # counters change — the state-store-backed master journals the
        # new values so a relaunched master cannot hand out already-used
        # round numbers, which would make world_stale() mis-classify
        # agents holding previous-incarnation round tokens.
        self._on_state_change = None

    def set_state_listener(self, listener):
        self._on_state_change = listener

    def checkpoint(self) -> dict:
        with self._lock:
            return {
                "round": self._rdzv_round,
                "stale_round": self._stale_round,
            }

    def restore(self, state: dict):
        with self._lock:
            self._rdzv_round = max(
                self._rdzv_round, int(state.get("round", 0))
            )
            self._stale_round = max(
                self._stale_round, int(state.get("stale_round", 0))
            )

    def _notify_state(self):
        """Call WITHOUT the lock held."""
        listener = self._on_state_change
        if listener is not None:
            try:
                listener(self.name, self.checkpoint())
            except Exception:
                logger.exception("rdzv state listener failed")

    # ---------------- configuration ----------------
    def update_rdzv_params(
        self,
        min_nodes: int,
        max_nodes: int,
        waiting_timeout: float = 30.0,
        node_unit: int = 1,
    ):
        with self._lock:
            self._min_nodes = min_nodes
            self._max_nodes = max_nodes
            self._waiting_timeout = waiting_timeout
            self._node_unit = max(1, node_unit)

    # ---------------- membership ----------------
    def remove_alive_node(self, node_rank: int):
        changed = False
        with self._lock:
            self._alive_nodes.discard(node_rank)
            if node_rank in self._waiting_nodes:
                del self._waiting_nodes[node_rank]
            if node_rank in self._rdzv_nodes:
                # A member of the active world died: invalidate the round
                # so surviving agents (polling world_stale) restart their
                # workers and re-form without the dead node.
                del self._rdzv_nodes[node_rank]
                changed = self._stale_round != self._rdzv_round
                self._stale_round = self._rdzv_round
                logger.info(
                    "rdzv %s: node %s left active world; round %s is now "
                    "stale, survivors must re-form",
                    self.name, node_rank, self._rdzv_round,
                )
            round_ = self._rdzv_round
        # Emits (like _notify_state) stay outside the lock: the journal
        # path must never nest inside the rendezvous lock.
        if changed:
            self._notify_state()
            emit(
                EventKind.RDZV_INVALIDATED, _node_id=node_rank,
                _role="master", rdzv=self.name, round=round_,
                reason="member-left",
            )

    def world_stale(self, round_: int) -> bool:
        """True when the given round was invalidated by a member death."""
        with self._lock:
            return round_ <= self._stale_round

    def invalidate_round(self):
        """Invalidate the current round without evicting anyone (hang
        recovery: every member flushes, restarts and rejoins)."""
        changed = False
        with self._lock:
            if self._rdzv_nodes:
                changed = self._stale_round != self._rdzv_round
                self._stale_round = self._rdzv_round
                logger.info(
                    "rdzv %s: round %s invalidated; members must re-form",
                    self.name, self._rdzv_round,
                )
            round_ = self._rdzv_round
        if changed:
            self._notify_state()
            emit(
                EventKind.RDZV_INVALIDATED, _role="master",
                rdzv=self.name, round=round_, reason="invalidated",
            )

    def join_rendezvous(
        self, node_rank: int, local_world_size: int = 1
    ) -> int:
        """Register intent to join; returns the round being formed."""
        with self._lock:
            if node_rank in self._rdzv_nodes and node_rank not in self._waiting_nodes:
                # Rejoin after restart: previous world is stale.
                self._rdzv_nodes = {}
            first = not self._waiting_nodes
            if first:
                self._start_rdzv_time = time.monotonic()
            self._waiting_nodes[node_rank] = local_world_size
            self._alive_nodes.add(node_rank)
            self._lastcall_time = time.monotonic()
            round_ = self._rdzv_round
        if first:
            emit(
                EventKind.RDZV_ROUND_START, _role="master",
                rdzv=self.name, round=round_ + 1,
            )
        emit(
            EventKind.RDZV_JOIN, _node_id=node_rank, _role="master",
            rdzv=self.name, round=round_ + 1,
        )
        return round_

    def _freeze_ready(self) -> bool:
        """Called with the lock held: can the waiting set become a round?"""
        count = len(self._waiting_nodes)
        if count < max(self._min_nodes, 1):
            return False
        if count >= self._max_nodes:
            return True
        waited = time.monotonic() - self._start_rdzv_time
        lastcall = time.monotonic() - self._lastcall_time
        if waited >= self._waiting_timeout:
            return True
        return lastcall >= self._lastcall_timeout and count >= self._min_nodes

    def _freeze_round(self):
        """Admit a node_unit-aligned subset of the waiting set as the world."""
        count = len(self._waiting_nodes)
        admitted = (count // self._node_unit) * self._node_unit
        if admitted <= 0:
            return
        ranks = sorted(self._waiting_nodes)[:admitted]
        self._rdzv_nodes = {r: self._waiting_nodes[r] for r in ranks}
        for r in ranks:
            del self._waiting_nodes[r]
        self._rdzv_round += 1
        logger.info(
            "rdzv %s: froze round %s with nodes %s",
            self.name, self._rdzv_round, sorted(self._rdzv_nodes),
        )

    def num_nodes_waiting(self) -> int:
        """Agents poll this to detect membership changes (>0 => restart)."""
        with self._lock:
            return len(self._waiting_nodes)

    def current_world(self) -> Dict[int, int]:
        """The frozen world of the current round (empty while forming)."""
        with self._lock:
            return dict(self._rdzv_nodes)

    def current_round(self) -> int:
        """The newest round number (frozen or being formed). Lets the
        rescale coordinator abort an obsolete plan without invalidating
        a newer round that superseded it."""
        with self._lock:
            return self._rdzv_round

    def absorb_world(self, world: Dict[int, int]) -> int:
        """Install `world` as the next frozen round without a rendezvous.

        The rescale coordinator's primitive: survivors of an in-place
        transition adopt the returned round directly (via the plan RPC)
        instead of rejoining, so the old stale round is superseded
        without anyone tearing down. Members of `world` still sitting in
        the waiting set (a grown node that joined normally) are absorbed
        out of it. Every prior round is marked stale so survivors notice
        the transition through the same world_stale() poll that detects
        deaths — the plan RPC then tells them it is an in-place move.
        """
        with self._lock:
            self._rdzv_nodes = dict(world)
            for rank in world:
                self._waiting_nodes.pop(rank, None)
                self._alive_nodes.add(rank)
            self._stale_round = max(self._stale_round, self._rdzv_round)
            self._rdzv_round += 1
            round_ = self._rdzv_round
            logger.info(
                "rdzv %s: absorbed world %s as round %s (in-place rescale)",
                self.name, sorted(world), round_,
            )
        self._notify_state()
        emit(
            EventKind.RDZV_ROUND_COMPLETE, _role="master",
            rdzv=self.name, round=round_, nodes=len(world), rescale=True,
        )
        return round_

    @abstractmethod
    def get_comm_world(
        self, node_rank: int
    ) -> Tuple[int, int, Dict[int, int]]:
        """Returns (round, group, {node_rank: local_world_size}).

        An empty world means "keep polling" — the round is still forming.
        """


class ElasticTrainingRendezvousManager(RendezvousManager):
    """One global communication world per round."""

    def get_comm_world(self, node_rank: int):
        froze = False
        froze_round = froze_nodes = 0
        try:
            with self._lock:
                if node_rank in self._rdzv_nodes:
                    return self._rdzv_round, 0, dict(self._rdzv_nodes)
                if self._freeze_ready():
                    before = self._rdzv_round
                    self._freeze_round()
                    froze = self._rdzv_round != before
                    froze_round = self._rdzv_round
                    froze_nodes = len(self._rdzv_nodes)
                    if node_rank in self._rdzv_nodes:
                        return self._rdzv_round, 0, dict(self._rdzv_nodes)
                return self._rdzv_round, 0, {}
        finally:
            if froze:
                self._notify_state()
                emit(
                    EventKind.RDZV_ROUND_COMPLETE, _role="master",
                    rdzv=self.name, round=froze_round, nodes=froze_nodes,
                )


class DeviceCheckRendezvousManager(RendezvousManager):
    """Paired-group check rounds for fault/straggler localization.

    Check round 1: nodes are paired sequentially ``(0,1)(2,3)...``; each
    pair runs an allgather+matmul exercise. A failed pair makes both
    members suspects. Check round 2: every suspect is deliberately
    re-paired with a node that passed round 1 (parity: reference
    ``rdzv_manager.py:449-507``). A node that fails both rounds is the
    fault node; with only one round of data the diagnosis is not ``done``.

    A report deadline guards against a node dying mid-check: members that
    fail to report within ``check_timeout`` of the round freezing are
    recorded as failed, so the diagnosis can never wedge on a silent node.
    """

    def __init__(self, name: str, check_timeout: float = 120.0):
        super().__init__(name)
        self._node_status: Dict[int, Dict[int, bool]] = {}  # round -> rank -> ok
        self._node_times: Dict[int, Dict[int, float]] = {}  # round -> rank -> sec
        self._round_members: Dict[int, Set[int]] = {}  # round -> frozen members
        self._check_round = 0
        self._straggler_ratio = 2.0
        self._check_timeout = check_timeout
        self._round_frozen_time = 0.0
        # Groups snapshotted at freeze time so every member of a round sees
        # the same pairing even if earlier-round data changes underneath.
        self._groups: List[List[int]] = []

    def join_rendezvous(self, node_rank: int, local_world_size: int = 1) -> int:
        with self._lock:
            if not self._waiting_nodes:
                self._start_rdzv_time = time.monotonic()
            self._waiting_nodes[node_rank] = local_world_size
            self._alive_nodes.add(node_rank)
            self._lastcall_time = time.monotonic()
            return self._rdzv_round

    def get_comm_world(self, node_rank: int):
        froze = False
        froze_round = froze_nodes = 0
        try:
            with self._lock:
                self._expire_round()
                if not self._rdzv_nodes and self._freeze_ready():
                    before = self._rdzv_round
                    self._freeze_round()
                    froze = self._rdzv_round != before
                    froze_round = self._rdzv_round
                    froze_nodes = len(self._rdzv_nodes)
                    if self._rdzv_nodes:  # node_unit may admit zero nodes
                        self._check_round += 1
                        self._round_members[self._check_round] = set(
                            self._rdzv_nodes
                        )
                        self._round_frozen_time = time.monotonic()
                        self._groups = self._build_groups()
                if node_rank in self._rdzv_nodes:
                    for group_idx, members in enumerate(self._groups):
                        if node_rank in members:
                            world = {r: self._rdzv_nodes[r] for r in members}
                            return self._rdzv_round, group_idx, world
                return self._rdzv_round, 0, {}
        finally:
            if froze:
                self._notify_state()
                emit(
                    EventKind.RDZV_ROUND_COMPLETE, _role="master",
                    rdzv=self.name, round=froze_round, nodes=froze_nodes,
                )

    def _expire_round(self):
        """With the lock held: time out members that never reported."""
        if not self._rdzv_nodes or self._round_frozen_time <= 0:
            return
        if time.monotonic() - self._round_frozen_time < self._check_timeout:
            return
        r = self._check_round
        reported = set(self._node_status.get(r, {}))
        for rank in set(self._rdzv_nodes) - reported:
            logger.warning(
                "device check %s: node %s never reported in round %s; "
                "recording as failed", self.name, rank, r,
            )
            self._node_status.setdefault(r, {})[rank] = False
            self._node_times.setdefault(r, {})[rank] = float("inf")
        self._rdzv_nodes = {}

    def _build_groups(self) -> List[List[int]]:
        """Pair nodes; from check round 2 on, pair each suspect (failed the
        previous round) with a known-good node so the faulty member of a
        failed pair is isolated."""
        ranks = sorted(self._rdzv_nodes)
        prev = self._node_status.get(self._check_round - 1, {})
        suspects = [r for r in ranks if prev.get(r) is False]
        good = [r for r in ranks if r not in set(suspects)]
        if self._check_round > 1 and suspects and good:
            pairs: List[List[int]] = []
            g, s = list(good), list(suspects)
            while s and g:
                pairs.append([g.pop(0), s.pop(0)])
            rest = g + s
            for i in range(0, len(rest) - 1, 2):
                pairs.append([rest[i], rest[i + 1]])
            if len(rest) % 2:
                if pairs:
                    pairs[-1].append(rest[-1])
                else:
                    pairs.append([rest[-1]])
            return pairs
        groups = []
        for i in range(0, len(ranks) - 1, 2):
            groups.append([ranks[i], ranks[i + 1]])
        if len(ranks) % 2:
            if groups:
                groups[-1].append(ranks[-1])
            else:
                groups.append([ranks[-1]])
        return groups

    def report_check_result(self, node_rank: int, normal: bool,
                            elapsed: float, round_: Optional[int] = None):
        with self._lock:
            r = self._check_round if round_ is None else round_
            members = self._round_members.get(r)
            if members is not None and node_rank not in members:
                logger.warning(
                    "device check %s: dropping report from node %s for "
                    "round %s it was not a member of", self.name, node_rank, r,
                )
                return
            if members is not None and set(
                self._node_status.get(r, {})
            ) >= members:
                # The round already completed (possibly via expiry): a late
                # report must not flip a diagnosis others have acted on.
                logger.warning(
                    "device check %s: dropping late report from node %s for "
                    "completed round %s", self.name, node_rank, r,
                )
                return
            self._node_status.setdefault(r, {})[node_rank] = normal
            self._node_times.setdefault(r, {})[node_rank] = elapsed
            # The reported world is consumed; allow the next check round to
            # freeze once every member of the current round reported.
            if r == self._check_round and set(
                self._node_status[r]
            ) >= set(self._rdzv_nodes):
                self._rdzv_nodes = {}

    def _complete_rounds(self) -> List[int]:
        """With the lock held: rounds where every frozen member reported."""
        done = []
        for r, members in self._round_members.items():
            if set(self._node_status.get(r, {})) >= members:
                done.append(r)
        return sorted(done)

    def completed_rounds(self) -> int:
        with self._lock:
            self._expire_round()
            return len(self._complete_rounds())

    def check_fault_node(self) -> Tuple[List[int], bool]:
        """Returns (fault node ranks, diagnosis finished)."""
        with self._lock:
            self._expire_round()
            rounds = self._complete_rounds()
            if not rounds:
                return [], False
            last = rounds[-1]
            current = self._node_status[last]
            suspects = {r for r, ok in current.items() if not ok}
            if not suspects:
                return [], True
            if len(rounds) < 2:
                return sorted(suspects), False
            prev = self._node_status[rounds[-2]]
            confirmed = [r for r in suspects if not prev.get(r, True)]
            return sorted(confirmed), True

    def check_straggler(self) -> Tuple[List[int], bool]:
        """Elapsed-time median×ratio rule (reference rdzv_manager.py:492)."""
        with self._lock:
            rounds = self._complete_rounds()
            if not rounds:
                return [], False
            times = self._node_times[rounds[-1]]
            finite = [t for t in times.values() if t != float("inf")]
            if len(times) < 2 or not finite:
                return [], True
            median = statistics.median(finite)
            if median <= 0:
                return [], True
            stragglers = [
                r for r, t in times.items() if t > median * self._straggler_ratio
            ]
            return sorted(stragglers), True
