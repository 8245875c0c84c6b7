"""Runtime lock-order detector (lockdep), env-armed like the chaos injector
(the port's copy of ``dlrover_tpu/common/lockdep.py``).

Deadlocks in this codebase are cross-domain by construction: the rdzv
lock, the state store's mutation lock, the event log's ring lock, and
the RPC client lock all live in different modules, and a call chain
that acquires them in one order on thread A and the other on thread B
deadlocks only under exactly the wrong interleaving — which a unit test
will basically never hit. Lockdep turns that interleaving-dependent
deadlock into a deterministic failure: it records the *order class*
of every instrumented acquisition and fails fast the moment any thread
acquires locks in an order that closes a cycle, even though no actual
deadlock occurred on this run.

Usage::

    from dlrover_tpu_torch.common.lockdep import instrumented_lock

    self._lock = instrumented_lock("rdzv")          # threading.Lock
    self._lock = instrumented_lock("store.mutation", rlock=True)

Disarmed (the default — ``LOCKDEP`` env unset), ``instrumented_lock``
returns a plain ``threading.Lock``/``RLock``: zero wrapper, zero hot-path
overhead. Armed (``DLROVER_TPU_LOCKDEP=1``), it returns a wrapper that:

- keeps a thread-local stack of held lock *names* (instances of the
  same name form one order class, as in the kernel's lockdep);
- on each acquisition of ``B`` while holding ``A``, records the edge
  ``A -> B`` with the acquiring stack trace;
- before recording, checks whether a path ``B -> ... -> A`` already
  exists; if so, raises :class:`LockOrderViolation` carrying **both**
  acquisition stacks — where ``A -> B`` is being established now and
  where ``B -> ... -> A`` was established before;
- re-entrant acquisition of the same name is ignored (RLock recursion).

The graph is process-global and append-only; tests snapshot it with
:func:`lock_graph` and reset with :func:`reset`.
"""

import threading
import traceback
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import env_utils


class LockOrderViolation(RuntimeError):
    """Raised (fail fast) when an acquisition would close an order cycle.

    Attributes:
        cycle: the lock names along the pre-existing path new -> ... -> held.
        this_stack: formatted stack of the acquisition being attempted.
        prior_stacks: [(edge, formatted stack)] for each edge of the
            pre-existing path, i.e. where the conflicting order was set.
    """

    def __init__(self, cycle: List[str], this_stack: str,
                 prior_stacks: List[Tuple[str, str]]):
        self.cycle = cycle
        self.this_stack = this_stack
        self.prior_stacks = prior_stacks
        chain = " -> ".join(cycle)
        prior = "\n".join(
            f"--- prior acquisition order {edge} established at ---\n{stack}"
            for edge, stack in prior_stacks
        )
        super().__init__(
            f"lock-order cycle: acquiring '{cycle[-1]}' while holding "
            f"'{cycle[0]}' inverts the established order {chain}\n"
            f"--- this acquisition ---\n{this_stack}\n{prior}"
        )


class _LockGraph:
    """Global acquisition-order graph. Edges carry the stack that first
    established them."""

    def __init__(self):
        self._mu = threading.Lock()
        # a -> {b: stack_str where a->b was first recorded}
        self._edges: Dict[str, Dict[str, str]] = {}

    def note(self, held: List[str], new: str):
        """Record held[-1] -> new (and transitively nothing else: the
        chain a->b->c is covered by the pairwise edges already)."""
        if not held:
            return
        with self._mu:
            for a in held:
                if a == new:
                    continue
                targets = self._edges.setdefault(a, {})
                if new in targets:
                    continue
                path = self._find_path(new, a)
                if path is not None:
                    prior = [
                        (f"{x} -> {y}", self._edges[x][y])
                        for x, y in zip(path, path[1:])
                    ]
                    raise LockOrderViolation(
                        cycle=path,
                        this_stack="".join(traceback.format_stack(limit=16)),
                        prior_stacks=prior,
                    )
                targets[new] = "".join(traceback.format_stack(limit=16))

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src -> dst through recorded edges (caller holds _mu)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def edges(self) -> Dict[str, Tuple[str, ...]]:
        with self._mu:
            return {a: tuple(sorted(bs)) for a, bs in self._edges.items()}

    def clear(self):
        with self._mu:
            self._edges.clear()


_GRAPH = _LockGraph()
_HELD = threading.local()


def _held_stack() -> List[str]:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


class _InstrumentedLock:
    """Wrapper recording acquisition order; duck-types Lock/RLock."""

    __slots__ = ("_name", "_inner")

    def __init__(self, name: str, inner):
        self._name = name
        self._inner = inner

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        if self._name not in held:
            # Order is checked BEFORE blocking on the inner lock: a
            # would-be-deadlocking acquisition must raise, not hang.
            _GRAPH.note(held, self._name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            held.append(self._name)
        return got

    def release(self):
        held = _held_stack()
        # Remove the innermost occurrence (RLock may hold several).
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self._name:
                del held[i]
                break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()


def lockdep_armed() -> bool:
    """Armed iff the env says so — read per call-site creation (cheap:
    lock creation is cold path), so tests can arm/disarm freely."""
    return env_utils.LOCKDEP.get()


def instrumented_lock(name: str, rlock: bool = False):
    """A named lock: plain threading primitive when lockdep is off
    (zero overhead), the order-recording wrapper when armed."""
    inner = threading.RLock() if rlock else threading.Lock()
    if not lockdep_armed():
        return inner
    return _InstrumentedLock(name, inner)


def lock_graph() -> Dict[str, Tuple[str, ...]]:
    """Snapshot of the recorded acquisition-order edges."""
    return _GRAPH.edges()


def assert_acyclic() -> None:
    """Re-verify the whole recorded graph (edges are also checked on
    insert, so this only fires if someone mutated state manually)."""
    edges = _GRAPH.edges()
    for a, targets in edges.items():
        for b in targets:
            with _GRAPH._mu:
                path = _GRAPH._find_path(b, a)
            if path is not None:
                raise LockOrderViolation(path + [b], "(post-hoc check)", [])


def reset() -> None:
    """Drop all recorded edges (tests)."""
    _GRAPH.clear()
    if hasattr(_HELD, "stack"):
        _HELD.stack = []
