"""Master↔agent control-plane transport — the port's copy of
``dlrover_tpu/common/rpc.py``, speaking the same wire.

A tiny generic transport plus typed dataclass messages
(:mod:`dlrover_tpu_torch.common.messages`): a selector-loop TCP server and
a retrying client exchanging length-prefixed pickles. A request is a
tuple ``(request_id, message)``, a response ``(ok, value)`` (with the
master's incarnation as a third item once it has a state store). The
pickles name the JAX package's classes (:mod:`dlrover_tpu_torch.common.
wire`), so either package's client talks to either package's master.

Security note: the control plane is job-internal (pods of one job / one
host), same trust model as the reference's pickled-gRPC protocol.
"""

import selectors
import socket
import struct
import threading
import time
import uuid
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

from dlrover_tpu_torch.chaos.injector import fault_hit
from dlrover_tpu_torch.chaos.sites import ChaosSite
from dlrover_tpu_torch.common.backoff import ExponentialBackoff
from dlrover_tpu_torch.common import wire
from dlrover_tpu_torch.common.lockdep import instrumented_lock
from dlrover_tpu_torch.common.log import logger

_LEN = struct.Struct(">I")

# The id of the envelope currently being dispatched by an RpcServer
# worker thread. Handlers that need it (the master's WAL keys journal
# records by request id so replayed responses can re-seed the dedup
# cache) read it via current_request_id() instead of widening every
# handler signature.
_req_ctx = threading.local()


def current_request_id() -> Optional[str]:
    return getattr(_req_ctx, "req_id", None)

# Control-plane timing contract, derived from one place so the pieces
# cannot drift apart. The dedup cache must remember a request id for
# STRICTLY LONGER than any client can still be retrying it, otherwise a
# retry landing after TTL expiry re-applies a mutating message. A client
# gives up at retry_deadline after the outage began, and its final
# attempt can then occupy the wire for up to one request timeout — so
# the TTL carries a full request-timeout of margin past the deadline.
RPC_TIMEOUT = 60.0
RPC_RETRY_DEADLINE = 120.0
DEDUP_TTL = RPC_RETRY_DEADLINE + RPC_TIMEOUT
# Request ids the dedup cache remembers: at least one in-retry-window
# entry per client, or eviction silently breaks exactly-once at scale.
DEDUP_SIZE = 65536
# Handler threads of the server's two lanes: rendezvous, failure and kv
# RPCs on the control lane, so a telemetry storm cannot starve them.
CONTROL_WORKERS = 4
BULK_WORKERS = 16
# Seconds ``RpcServer.stop`` waits for in-flight handlers to finish and
# their responses to flush before severing connections.
DRAIN_S = 5.0
# The JAX master's settings for these values are refused by the port's
# (``master.master.LEFT_OUT_SETTINGS``).


def _send(sock: socket.socket, obj: Any):
    data = wire.dumps(obj)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            raise ConnectionError("socket closed mid-message")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return wire.loads(_recv_exact(sock, n))


def endpoint_from_file(path: str) -> Callable[[], str]:
    """An ``endpoint_source`` reading ``host:port`` from a file.

    The file is the HA plane's published endpoint (or any ``--port_file``
    -style record): a promoted standby — or an externally relaunched
    master on a new port — rewrites it atomically, and every client
    consulting this source rides over between retry rounds without a
    process restart."""
    def read() -> str:
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return ""
    return read


class _DedupCache:
    """Remember recent request-id → response so client retries after a
    connection error never apply a non-idempotent message twice.

    ``begin`` claims an id before the handler runs; a duplicate arriving
    while the first execution is still in flight waits for it to finish
    instead of re-executing the handler concurrently.
    """

    #: Exactly-once hinges on these two maps moving
    #: atomically (claim, wait, publish) — every access is locked.
    GUARDED_BY = {"_entries": "rpc.dedup", "_pending": "rpc.dedup"}

    def __init__(self):
        # req_id -> (timestamp, response) once done; response is None and a
        # pending Event is registered while the handler is executing.
        self._entries: "OrderedDict[str, Tuple[float, Any]]" = OrderedDict()
        self._pending: dict = {}
        self._lock = instrumented_lock("rpc.dedup")

    def begin(self, req_id: str):
        """Returns (is_duplicate, response). For an in-flight duplicate,
        blocks until the first execution completes."""
        with self._lock:
            entry = self._entries.get(req_id)
            if entry is not None:
                return True, entry[1]
            event = self._pending.get(req_id)
            if event is None:
                self._pending[req_id] = threading.Event()
                return False, None
        event.wait(timeout=RPC_TIMEOUT)
        with self._lock:
            entry = self._entries.get(req_id)
            if entry is not None:
                return True, entry[1]
        # First execution vanished (crashed thread / timeout): re-execute.
        return False, None

    def finish(self, req_id: str, response: Any):
        now = time.monotonic()
        with self._lock:
            self._entries[req_id] = (now, response)
            self._entries.move_to_end(req_id)
            event = self._pending.pop(req_id, None)
            while len(self._entries) > DEDUP_SIZE:
                self._entries.popitem(last=False)
            while self._entries:
                oldest = next(iter(self._entries))
                if now - self._entries[oldest][0] > DEDUP_TTL:
                    self._entries.popitem(last=False)
                else:
                    break
        if event is not None:
            event.set()


class _Conn:
    """Per-connection state owned by the selector loop thread."""

    __slots__ = ("sock", "rbuf", "wbuf", "pending", "busy")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()     # partial inbound frames
        self.wbuf = bytearray()     # outbound bytes not yet written
        self.pending: deque = deque()  # decoded envelopes awaiting dispatch
        self.busy = False           # a worker is executing for this conn


class RpcServer:
    """Selector-loop request/response server: ``handler(request) -> response``.

    One event-loop thread owns every socket (accept, read, write); decoded
    requests execute on a bounded worker pool instead of a thread per
    connection, so 10k idle agent connections cost file descriptors, not
    threads. Two lanes — ``control`` and ``bulk`` — each get their own
    pool (``CONTROL_WORKERS``, ``BULK_WORKERS`` threads): a telemetry
    storm can exhaust the bulk lane without ever queueing ahead of a
    rendezvous or rescale RPC.

    Requests arrive as ``(req_id, payload)``; responses for recent ids are
    cached so a retried request is answered from cache instead of being
    re-applied (the wire retry in :class:`RpcClient` is therefore safe for
    mutating messages such as KVStoreAdd/JoinRendezvous/TaskReport).
    """

    #: ``_conns`` is owned by the event-loop thread (stop()'s drain poll
    #: does a deliberately racy read, see comment there); ``_outbox``
    #: relies on deque's atomic append/popleft for the worker->loop
    #: handoff; ``_pools`` is wired once in __init__.
    GUARDED_BY = {
        "_conns": None,
        "_outbox": None,
        "_pools": None,
    }

    def __init__(self, port: int, handler: Callable[[Any], Any],
                 host: str = "0.0.0.0",
                 classify: Optional[Callable[[Any], str]] = None):
        self._handler = handler
        #: request -> "control" | "bulk" lane (default: all control).
        self._classify = classify or (lambda request: "control")
        self._dedup = _DedupCache()
        # Monotonic boot counter of the process logically behind this
        # server (the master's incarnation). When set, every response is
        # stamped with it so clients can detect a master restart — the
        # fencing signal that triggers re-registration. None (the
        # default) keeps the legacy 2-tuple wire format.
        self.incarnation: Optional[int] = None
        # Established per-client connections (loop-owned _Conn objects),
        # so stop() can sever them: a killed master process drops every
        # socket, and the in-process analog (tests, graceful handover)
        # must behave the same — a stopped server that keeps answering
        # on old connections would let clients talk to a master that no
        # longer exists logically.
        self._conns: Dict[socket.socket, _Conn] = {}
        self._pools = {
            "control": ThreadPoolExecutor(
                max_workers=CONTROL_WORKERS,
                thread_name_prefix="rpc-ctl",
            ),
            "bulk": ThreadPoolExecutor(
                max_workers=BULK_WORKERS,
                thread_name_prefix="rpc-bulk",
            ),
        }
        # Worker -> loop handoff: thread-safe deque of ("send"|"close",
        # conn, bytes) plus a socketpair to wake the selector.
        self._outbox: deque = deque()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._inflight = 0          # loop-owned: dispatched, not yet sent
        self._running = False
        self._stop_accepting = False
        self._listener_closed = threading.Event()
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, port))
        self._listen.listen(1024)
        self._listen.setblocking(False)
        self.port = self._listen.getsockname()[1]
        self._thread: Optional[threading.Thread] = None

    def seed_dedup(self, req_id: str, result: Any):
        """Pre-populate the dedup cache with a replayed response.

        The cache dies with the master process; a recovered master
        re-seeds it from its journal so a client retry of a request the
        OLD incarnation already applied is answered from cache instead
        of being re-applied — the exactly-once half of failover.
        """
        self._dedup.finish(req_id, (True, result))

    def start(self):
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="rpc-server", daemon=True
        )
        self._thread.start()

    # ---------------- event loop (single thread) ----------------
    def _loop(self):
        sel = selectors.DefaultSelector()
        sel.register(self._listen, selectors.EVENT_READ, "accept")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        try:
            while self._running:
                if self._stop_accepting and not self._listener_closed.is_set():
                    try:
                        sel.unregister(self._listen)
                    except (KeyError, ValueError):
                        pass
                    self._listen.close()
                    self._listener_closed.set()
                for key, _ in sel.select(timeout=0.5):
                    what = key.data
                    if what == "accept":
                        self._accept(sel)
                    elif what == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        self._service_conn(sel, what, key.events)
                self._drain_outbox(sel)
        finally:
            for conn in list(self._conns.values()):
                self._close_conn(sel, conn)
            if not self._listener_closed.is_set():
                try:
                    self._listen.close()
                except OSError:
                    pass
                self._listener_closed.set()
            sel.close()

    def _accept(self, sel):
        while True:
            try:
                sock, _ = self._listen.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock)
            self._conns[sock] = conn
            sel.register(sock, selectors.EVENT_READ, conn)

    def _service_conn(self, sel, conn: _Conn, events: int):
        if events & selectors.EVENT_READ:
            while True:
                try:
                    chunk = conn.sock.recv(65536)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    self._close_conn(sel, conn)
                    return
                if not chunk:
                    self._close_conn(sel, conn)
                    return
                conn.rbuf += chunk
                if len(chunk) < 65536:
                    break
            if not self._parse_frames(sel, conn):
                return
            self._dispatch(sel, conn)
        if events & selectors.EVENT_WRITE and conn.wbuf:
            try:
                sent = conn.sock.send(conn.wbuf)
                del conn.wbuf[:sent]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self._close_conn(sel, conn)
                return
            if not conn.wbuf:
                self._update_interest(sel, conn)

    def _parse_frames(self, sel, conn: _Conn) -> bool:
        """Decode complete length-prefixed pickles out of rbuf; False if
        the connection was torn down on a decode error."""
        while len(conn.rbuf) >= _LEN.size:
            (n,) = _LEN.unpack_from(conn.rbuf)
            if len(conn.rbuf) < _LEN.size + n:
                break
            raw = bytes(conn.rbuf[_LEN.size:_LEN.size + n])
            del conn.rbuf[:_LEN.size + n]
            try:
                envelope = wire.loads(raw)
            except Exception:
                logger.warning("rpc server: undecodable frame; closing conn")
                self._close_conn(sel, conn)
                return False
            conn.pending.append(envelope)
        return True

    def _dispatch(self, sel, conn: _Conn):
        """Hand the next decoded request to its lane's worker pool.
        One in-flight request per connection: the RpcClient is strict
        request-response, and in-order responses are part of the
        contract."""
        if conn.busy or not conn.pending:
            return
        envelope = conn.pending.popleft()
        if isinstance(envelope, tuple) and len(envelope) == 2:
            req_id, request = envelope
        else:  # bare request (tests / simple callers)
            req_id, request = None, envelope
        try:
            lane = self._classify(request)
        except Exception:
            lane = "control"
        if lane not in self._pools:
            lane = "control"
        conn.busy = True
        self._inflight += 1
        try:
            self._pools[lane].submit(self._work, conn, req_id, request)
        except RuntimeError:  # pool shut down: stop() already severing
            self._inflight -= 1
            self._close_conn(sel, conn)

    def _drain_outbox(self, sel):
        while True:
            try:
                op, conn, data = self._outbox.popleft()
            except IndexError:
                return
            self._inflight -= 1
            conn.busy = False
            if op == "close" or conn.sock not in self._conns:
                self._close_conn(sel, conn)
                continue
            conn.wbuf += _LEN.pack(len(data)) + data
            # Opportunistic inline write: the common case (small
            # response, empty socket buffer) completes here without a
            # second selector pass.
            try:
                sent = conn.sock.send(conn.wbuf)
                del conn.wbuf[:sent]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self._close_conn(sel, conn)
                continue
            self._update_interest(sel, conn)
            self._dispatch(sel, conn)

    def _update_interest(self, sel, conn: _Conn):
        want = selectors.EVENT_READ
        if conn.wbuf:
            want |= selectors.EVENT_WRITE
        try:
            sel.modify(conn.sock, want, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _close_conn(self, sel, conn: _Conn):
        self._conns.pop(conn.sock, None)
        try:
            sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _wake(self):
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    # ---------------- worker side ----------------
    def _work(self, conn: _Conn, req_id: Optional[str], request: Any):
        chaos = fault_hit(
            ChaosSite.RPC_SERVER_RECV, detail=type(request).__name__
        )
        if chaos is not None:
            if chaos.kind == "delay":
                time.sleep(chaos.delay_s)
            elif chaos.kind == "drop":
                # Request lost before execution: the client sees a
                # dead connection and must retry.
                self._outbox.append(("close", conn, b""))
                self._wake()
                return
        duplicate, response = (
            self._dedup.begin(req_id) if req_id else (False, None)
        )
        if not duplicate:
            _req_ctx.req_id = req_id
            try:
                response = (True, self._handler(request))
            except NotImplementedError as e:
                # A request for a part this master leaves out: the
                # message names it, a traceback would add nothing.
                logger.warning("rpc refused %s: %s",
                               type(request).__name__, e)
                response = (False, repr(e))
            except Exception as e:
                logger.exception(
                    "rpc handler error for %r", type(request)
                )
                response = (False, repr(e))
            finally:
                _req_ctx.req_id = None
            if req_id is not None:
                self._dedup.finish(req_id, response)
        if self.incarnation is not None:
            # Stamp at send time (not into the dedup cache): a cache
            # entry seeded from the previous incarnation's journal
            # still answers with THIS incarnation.
            response = response + (self.incarnation,)
        if chaos is not None and chaos.kind == "drop_response":
            # Executed and dedup-cached, but the answer is lost: the
            # retry MUST be served from the cache, not re-applied —
            # the exact failure the dedup layer exists for.
            self._outbox.append(("close", conn, b""))
            self._wake()
            return
        try:
            data = wire.dumps(response)
        except Exception as e:
            logger.exception("rpc response unpicklable")
            data = wire.dumps((False, repr(e)))
        self._outbox.append(("send", conn, data))
        self._wake()

    # ---------------- shutdown ----------------
    def stop(self, drain: Optional[float] = None):
        """Stop accepting, drain in-flight handlers (bounded by
        ``DRAIN_S``), then sever every connection.

        The drain keeps a failover drill at high concurrency from
        leaking half-applied socket errors into client retries: a
        request whose handler already ran gets its response flushed (and
        its dedup entry written) before the socket dies.
        """
        if drain is None:
            drain = DRAIN_S
        if self._thread is None:
            # start() never ran: nothing in flight, just release the port.
            try:
                self._listen.close()
            except OSError:
                pass
            self._listener_closed.set()
        else:
            self._stop_accepting = True
            self._wake()
            # The loop closes the listener (it owns the selector); wait
            # so a successor can rebind the port the moment we return.
            self._listener_closed.wait(timeout=5.0)
            deadline = time.monotonic() + max(0.0, drain)
            while time.monotonic() < deadline:
                # Racy read of loop-owned state is fine for a drain
                # poll: a false "not drained" just waits one more tick.
                if self._inflight == 0 and not any(
                    c.wbuf or c.pending for c in list(self._conns.values())
                ):
                    break
                time.sleep(0.02)
            self._running = False
            self._wake()
            self._thread.join(timeout=5.0)
            self._thread = None
        for pool in self._pools.values():
            pool.shutdown(wait=False)
        try:
            self._wake_w.close()
        except OSError:
            pass
        try:
            self._wake_r.close()
        except OSError:
            pass


class RpcClient:
    """Persistent-connection client with automatic reconnect.

    Connection-dead failures retry with backoff until
    ``retry_deadline`` elapses — the master-failover contract: when the
    master process dies and is relaunched at the same address (the
    reference's operator relaunching the master pod), agents and
    workers ride out the outage instead of crashing on the first
    refused connection. Timeouts of in-flight requests are never
    retried (the first attempt may still be executing server-side and a
    retried envelope could miss the dedup cache).
    """

    def __init__(self, addr: str, timeout: float = RPC_TIMEOUT,
                 retry_deadline: float = RPC_RETRY_DEADLINE,
                 connect_timeout: float = 5.0,
                 endpoint_source: Optional[Callable[[], str]] = None):
        host, port = addr.rsplit(":", 1)
        self._addr: Tuple[str, int] = (host, int(port))
        # Optional ``() -> "host:port"`` consulted between retry rounds
        # while the current address is unreachable (see
        # :func:`endpoint_from_file`). Without it the address is frozen
        # at construction and clients of a moved master are stranded
        # until their process restarts.
        self._endpoint_source = endpoint_source
        self._timeout = timeout
        self._retry_deadline = retry_deadline
        self._connect_timeout = connect_timeout
        self._sock: Optional[socket.socket] = None
        self._lock = instrumented_lock("rpc.client")
        # Last master incarnation observed in a response (None until an
        # incarnation-stamping server answers). A change means the
        # master restarted: the observer below is invoked once per
        # transition so the owner can re-register with the new master.
        self.incarnation: Optional[int] = None
        self.on_incarnation_change: Optional[Callable[[int, int], None]] = None
        self._fencing = threading.local()
        # First-failure timestamp of the CURRENT outage, shared by all
        # threads on this client: every caller measures the retry
        # window from the same start, so N threads queued on a dead
        # master fail after ~retry_deadline total, not N x deadline.
        self._down_since: Optional[float] = None

    def _connect(self):
        # Short connect timeout: a dead pod IP that blackholes SYNs
        # (no RST) must register as a retryable outage quickly, not eat
        # the whole request timeout per attempt.
        s = socket.create_connection(
            self._addr, timeout=self._connect_timeout
        )
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(self._timeout)
        self._sock = s

    def call(self, request: Any, timeout: Optional[float] = None) -> Any:
        envelope = (uuid.uuid4().hex, request)
        backoff = ExponentialBackoff(initial=0.1, max_delay=2.0)
        reported = False
        fence = None
        while True:
            outage_err = None
            with self._lock:
                try:
                    if self._sock is None:
                        # Connect failures — including connect
                        # TIMEOUTS (blackholed address) — sent
                        # nothing: provably safe to retry.
                        self._connect()
                except OSError as e:
                    outage_err = e
                if outage_err is None:
                    try:
                        chaos = fault_hit(
                            ChaosSite.RPC_CLIENT_SEND,
                            detail=type(request).__name__,
                        )
                        if chaos is not None:
                            if chaos.kind == "delay":
                                time.sleep(chaos.delay_s)
                            elif chaos.kind in ("drop", "reset"):
                                # Tear the connection down before the
                                # send: flows through the normal
                                # connection-dead retry path below.
                                self._close_locked()
                                raise ConnectionResetError(
                                    f"chaos: {chaos.kind} before send"
                                )
                        part = fault_hit(
                            ChaosSite.MASTER_PARTITION,
                            detail=type(request).__name__,
                        )
                        if part is not None and part.kind == "drop":
                            # Symmetric loss: the request never reaches
                            # the master.
                            self._close_locked()
                            raise ConnectionResetError(
                                "chaos: partition dropped request"
                            )
                        self._sock.settimeout(timeout or self._timeout)
                        _send(self._sock, envelope)
                        if part is not None and part.kind == "drop_response":
                            # Asymmetric (one-way) loss: the request
                            # PASSES — the master executes and caches —
                            # but the response never arrives. The retry
                            # reuses the same envelope id, so the dedup
                            # cache must answer it exactly-once instead
                            # of re-applying the mutation.
                            self._close_locked()
                            raise ConnectionResetError(
                                "chaos: partition dropped response"
                            )
                        resp = _recv(self._sock)
                        if len(resp) == 3:
                            ok, payload, inc = resp
                        else:
                            ok, payload = resp
                            inc = None
                        if inc is not None and not getattr(
                            self._fencing, "active", False
                        ):
                            # Only the thread that performs the
                            # old->new transition (under the lock)
                            # fires the observer; RPCs issued BY the
                            # observer leave self.incarnation alone so
                            # a further restart mid-observer is
                            # detected by the next regular call.
                            prev = self.incarnation
                            self.incarnation = inc
                            if prev is not None and inc != prev:
                                fence = (prev, inc)
                        self._down_since = None
                        break
                    except socket.timeout:
                        # Never retry an in-flight timeout: the attempt
                        # may still be executing on the server, so a
                        # retried envelope could miss the dedup cache
                        # and run the handler concurrently.
                        self._close_locked()
                        raise
                    except (ConnectionError, OSError, EOFError) as e:
                        # Safe to retry: the connection is dead (the
                        # server is not still processing it) and the
                        # server dedups on the request id, so a request
                        # applied before the connection died is
                        # answered from cache, not re-applied.
                        self._close_locked()
                        outage_err = e
                now = time.monotonic()
                if self._down_since is None:
                    self._down_since = now
                if self._endpoint_source is not None:
                    # Endpoint re-resolution between retry rounds: a
                    # promoted standby (or an external relaunch on a new
                    # port) republished the endpoint — follow it with a
                    # fresh retry window instead of burning the rest of
                    # this one against the dead address.
                    cand = None
                    try:
                        fresh = self._endpoint_source() or ""
                    except Exception:
                        fresh = ""
                    if fresh and ":" in fresh:
                        fhost, fport = fresh.rsplit(":", 1)
                        try:
                            cand = (fhost, int(fport))
                        except ValueError:
                            cand = None
                    if cand is not None and cand != self._addr:
                        logger.warning(
                            "master endpoint moved %s -> %s; "
                            "re-resolving", self._addr, cand,
                        )
                        self._addr = cand
                        self._close_locked()
                        self._down_since = now
                delay = backoff.next_delay()
                expired = (
                    now + delay
                    > self._down_since + self._retry_deadline
                )
            if expired:
                raise outage_err
            if not reported:
                logger.warning(
                    "master %s unreachable (%s); retrying for up to "
                    "%.0f s", self._addr, outage_err,
                    self._retry_deadline,
                )
                reported = True
            # Sleep OUTSIDE the lock: other threads (heartbeat,
            # monitors) must not serialize behind this backoff.
            time.sleep(delay)
        if fence is not None and self.on_incarnation_change is not None:
            # Outside the lock: the observer re-registers over this same
            # client, which must not deadlock or serialize other threads.
            self._fencing.active = True
            try:
                self.on_incarnation_change(*fence)
            except Exception:
                logger.exception(
                    "incarnation-change observer failed (%s -> %s)", *fence
                )
            finally:
                self._fencing.active = False
        if not ok:
            raise RuntimeError(f"master rejected {type(request).__name__}: {payload}")
        return payload

    def _close_locked(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self):
        with self._lock:
            self._close_locked()
