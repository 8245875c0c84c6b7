"""Seeded, declarative fault injector (the chaos control plane) — the
port's copy of ``dlrover_tpu/chaos/injector.py``.

A drill scripts a :class:`FaultPlan` — seed + events — and exports it
through ``DLROVER_TPU_CHAOS`` (inline JSON, or ``@/path/to/plan.json``).
Every process of the job (agent, master, workers — including workers
forked from the preloaded template, which swap in the launch env before
entering the training script) reads the same plan lazily on its first
instrumented call, so one env var arms the whole tree.

Determinism contract:

- each site keeps a monotonically increasing *occurrence counter*;
  ``at``/``every`` events key off it, so a schedule is a pure function
  of how often the site is reached — not of wall time;
- probabilistic events draw from a ``random.Random`` seeded with
  ``(plan.seed, site)``, consumed exactly once per occurrence per
  event, so the decision sequence replays identically for a seed;
- fired events are appended as JSON lines to ``DLROVER_TPU_CHAOS_LOG``
  (when set) — two runs of a drill with the same seed must produce the
  same journal, which is what the reproducibility drills assert.
"""

import json
import os
import random
import threading
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.chaos.sites import validate_sites
from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.lockdep import instrumented_lock
from dlrover_tpu_torch.common.log import logger

#: Inline JSON plan, or ``@<path>`` to a JSON file. Unset => chaos off.
CHAOS_ENV = env_utils.CHAOS.name
#: Optional journal: one JSON line per fired event (reproducibility).
CHAOS_LOG_ENV = env_utils.CHAOS_LOG.name


@dataclass
class FaultEvent:
    """One scripted fault: *where* (site), *what* (kind), *when*.

    Exactly one trigger should be set: ``at`` (fire on the Nth
    occurrence of the site, 1-based), ``every`` (fire on every Nth), or
    ``prob`` (fire with seeded probability per occurrence). ``at``
    events fire once; ``every``/``prob`` events fire up to
    ``max_fires`` times (0 = unlimited).
    """

    site: str
    kind: str
    at: Optional[int] = None
    every: Optional[int] = None
    prob: Optional[float] = None
    max_fires: int = 0
    delay_s: float = 0.0
    #: Substring filter on the site's detail string (e.g. a file path
    #: or message type) — the event only triggers when it matches.
    match: str = ""
    #: Kind-specific knobs (corrupt offset/xor, truncate bytes, rank…).
    args: Dict[str, Any] = field(default_factory=dict)
    # runtime state, not part of the declarative schema
    fired: int = 0

    def triggers(self, n: int, detail: str, rng: random.Random) -> bool:
        if self.match and self.match not in detail:
            return False
        if self.at is not None:
            return n == self.at and self.fired == 0
        limit = self.max_fires
        if limit and self.fired >= limit:
            return False
        if self.every is not None:
            return self.every > 0 and n % self.every == 0
        if self.prob is not None:
            # One draw per occurrence per event: the sequence of draws —
            # hence the schedule — is a pure function of (seed, site, n).
            return rng.random() < self.prob
        return False


@dataclass
class FaultPlan:
    seed: int = 0
    events: List[FaultEvent] = field(default_factory=list)

    def to_json(self) -> str:
        out = {
            "seed": self.seed,
            "events": [
                {k: v for k, v in asdict(e).items()
                 if k != "fired" and v not in (None, "", 0.0, 0, {})}
                for e in self.events
            ],
        }
        return json.dumps(out)

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        obj = json.loads(raw)
        return cls(
            seed=int(obj.get("seed", 0)),
            events=[FaultEvent(**e) for e in obj.get("events", [])],
        )

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        raw = env_utils.CHAOS.get()
        if not raw:
            return None
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        plan = cls.from_json(raw)
        # Fail fast on a typo'd site: an event that can never match any
        # instrumented call silently disables the drill it scripts.
        validate_sites(e.site for e in plan.events)
        return plan


class FaultInjector:
    """Per-process singleton consulted by instrumented call sites."""

    _instance: Optional["FaultInjector"] = None
    _instance_lock = threading.Lock()

    def __init__(self, plan: FaultPlan):
        self._plan = plan
        self._counters: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._by_site: Dict[str, List[FaultEvent]] = {}
        for e in plan.events:
            self._by_site.setdefault(e.site, []).append(e)
        self._lock = instrumented_lock("chaos.injector")
        self._log_path = env_utils.CHAOS_LOG.get()

    # ------------- singleton -------------
    @classmethod
    def get(cls) -> Optional["FaultInjector"]:
        """The process-wide injector, or None when chaos is off.

        Reads the env lazily so forkserver children (which swap env
        after the template imported this module) and late-set test envs
        both arm correctly.
        """
        inst = cls._instance
        if inst is not None:
            return inst
        if not env_utils.CHAOS.get():
            return None
        with cls._instance_lock:
            if cls._instance is None:
                try:
                    plan = FaultPlan.from_env()
                except Exception:
                    logger.exception("unparseable %s; chaos disabled", CHAOS_ENV)
                    plan = None
                if plan is None:
                    return None
                cls._instance = cls(plan)
                logger.warning(
                    "CHAOS ARMED: seed=%s, %s event(s) across sites %s",
                    plan.seed, len(plan.events), sorted({
                        e.site for e in plan.events
                    }),
                )
        return cls._instance

    @classmethod
    def reset(cls):
        """Drop the singleton (tests re-arm with a fresh plan/env)."""
        with cls._instance_lock:
            cls._instance = None

    # ------------- the hot call -------------
    def hit(self, site: str, detail: str = "") -> Optional[FaultEvent]:
        """Record one occurrence of `site`; return the event to apply.

        The first matching event wins (plans should not stack events on
        one occurrence). Counters advance even when nothing fires, so a
        later event's ``at`` index means "the Nth time this code path
        ran", independent of other events.
        """
        events = self._by_site.get(site)
        if not events:
            return None
        fired = None
        with self._lock:
            n = self._counters.get(site, 0) + 1
            self._counters[site] = n
            rng = self._rngs.get(site)
            if rng is None:
                rng = random.Random(f"{self._plan.seed}:{site}")
                self._rngs[site] = rng
            for e in events:
                if e.triggers(n, detail, rng):
                    e.fired += 1
                    self._journal(site, n, e, detail)
                    fired = e
                    break
        if fired is not None:
            # Self-report into the job timeline (outside our lock — the
            # emit path may take the master's journal lock). Lazy import:
            # chaos must stay importable with zero dependencies, so only
            # an import failure is absorbed; emit() itself never raises.
            try:
                from dlrover_tpu_torch.observability.events import EventKind, emit
            except ImportError:
                pass
            else:
                emit(
                    EventKind.CHAOS_INJECT, site=site, kind=fired.kind,
                    detail=detail, n=n,
                )
        return fired

    def occurrences(self, site: str) -> int:
        with self._lock:
            return self._counters.get(site, 0)

    def _journal(self, site: str, n: int, e: FaultEvent, detail: str):
        logger.warning(
            "CHAOS FIRE: site=%s n=%s kind=%s detail=%s", site, n, e.kind,
            detail,
        )
        if not self._log_path:
            return
        rec = {"site": site, "n": n, "kind": e.kind, "detail": detail}
        try:
            with open(self._log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass  # the journal is observability, never a failure source


def fault_hit(site: str, detail: str = "") -> Optional[FaultEvent]:
    """Instrumentation entry point: near-zero cost when chaos is off."""
    inj = FaultInjector.get()
    if inj is None:
        return None
    return inj.hit(site, detail)
