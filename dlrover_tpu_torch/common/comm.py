"""Cross-process shared objects over unix-domain sockets — the port's
copy of ``dlrover_tpu/common/comm.py``, which carries the engine ↔ agent
checkpoint protocol.

The owner process (normally the agent's checkpoint saver) runs a small
threaded server per object; trainer processes are clients. The wire
format is the JAX package's: a 4-byte big-endian length, then a pickled
``(method, args, kwargs)`` request or ``(ok, payload)`` reply, pickled
with ``ckpt_meta.dumps`` / ``loads``, so a port engine talks to a JAX
agent and back. The socket path is
``$DLROVER_TPU_SOCK_DIR/<job>/<kind>_<name>.sock`` in both packages.
"""

import os
import queue
import socket
import struct
import threading
import time
import uuid
from typing import Any, Dict, Optional, Tuple

from dlrover_tpu_torch.common import ckpt_meta, env_utils
from dlrover_tpu_torch.common.backoff import ExponentialBackoff
from dlrover_tpu_torch.common.log import logger

_LEN = struct.Struct(">I")


def _sock_dir(job: str) -> str:
    return os.path.join(env_utils.SOCK_DIR.get(), job)


def _sock_path(job: str, kind: str, name: str) -> str:
    d = _sock_dir(job)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{kind}_{name}.sock")


def _send(sock: socket.socket, obj: Any):
    data = ckpt_meta.dumps(obj)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv(sock: socket.socket) -> Any:
    header = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(header)
    return ckpt_meta.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            raise ConnectionError("socket closed mid-message")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class LocalSocketComm:
    """Base for a named shared object: server in the owner, clients elsewhere."""

    KIND = "obj"

    def __init__(self, name: str, create: bool = False, job: str = ""):
        self.name = name
        self._job = job or env_utils.JOB_NAME.get()
        self._path = _sock_path(self._job, self.KIND, name)
        self._server_sock: Optional[socket.socket] = None
        self._stopped = False
        if create:
            self._start_server()

    # ----- server side -----
    def _start_server(self):
        if os.path.exists(self._path):
            os.unlink(self._path)
        self._server_sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server_sock.bind(self._path)
        self._server_sock.listen(128)
        t = threading.Thread(
            target=self._serve, name=f"{self.KIND}-{self.name}", daemon=True
        )
        t.start()

    def _serve(self):
        while not self._stopped:
            try:
                conn, _ = self._server_sock.accept()
            except OSError:
                break
            threading.Thread(
                target=self._handle_conn, args=(conn,), daemon=True
            ).start()

    def _handle_conn(self, conn: socket.socket):
        with conn:
            while True:
                try:
                    method, args, kwargs = _recv(conn)
                except (ConnectionError, EOFError, OSError):
                    return
                try:
                    result = getattr(self, "_srv_" + method)(*args, **kwargs)
                    reply = (True, result)
                except Exception as e:  # surface remote errors to the client
                    reply = (False, repr(e))
                try:
                    _send(conn, reply)
                except OSError:
                    return

    def close(self):
        self._stopped = True
        if self._server_sock is not None:
            try:
                self._server_sock.close()
            except OSError:
                pass
            try:
                os.unlink(self._path)
            except FileNotFoundError:
                pass

    # ----- client side -----
    def _call(self, method: str, *args, timeout: float = 60.0, **kwargs):
        deadline = time.monotonic() + timeout
        last_err: Optional[Exception] = None
        backoff = ExponentialBackoff(initial=0.02, max_delay=0.5)
        while time.monotonic() < deadline:
            try:
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                    s.settimeout(max(0.1, deadline - time.monotonic()))
                    s.connect(self._path)
                    _send(s, (method, args, kwargs))
                    ok, payload = _recv(s)
                if ok:
                    return payload
                raise RuntimeError(f"remote {self.KIND}.{method} failed: {payload}")
            except (FileNotFoundError, ConnectionError, socket.timeout) as e:
                last_err = e
                backoff.sleep(deadline - time.monotonic())
        raise TimeoutError(
            f"{self.KIND} '{self.name}' unreachable at {self._path}: {last_err}"
        )


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


class SharedLock(LocalSocketComm):
    """A lock owned by the agent; any process on the host can acquire it.

    The flash-checkpoint protocol uses it for dirty-write detection: the
    saver refuses to persist a shard whose lock is held by a writer.

    Ownership is tracked per client ``(pid, token)``: a dead owner's lock is
    force-released, so a trainer that crashes mid-write can never wedge the
    saver, and retried acquire/release calls are idempotent (each call runs
    on a fresh connection, so the owner token — not the connection — is the
    identity).
    """

    KIND = "lock"

    def __init__(self, name: str, create: bool = False, job: str = ""):
        if create:
            self._cond = threading.Condition()
            self._owner: Optional[Tuple[int, str]] = None
        self._client_token = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        super().__init__(name, create, job)

    # Server side: `owner` is (pid, token) of the requesting client.
    def _srv_acquire(self, owner, blocking: bool = True, timeout: float = -1):
        deadline = None
        if blocking and timeout >= 0:
            deadline = time.monotonic() + timeout
        # Cap any blocking acquire so a server thread never waits forever on
        # behalf of a client that has already timed out and gone away.
        hard_deadline = time.monotonic() + 55.0
        owner = tuple(owner)
        with self._cond:
            while True:
                if self._owner is not None and not _pid_alive(self._owner[0]):
                    logger.warning(
                        "lock %s: owner pid %s died; force-releasing",
                        self.name, self._owner[0],
                    )
                    self._owner = None
                if self._owner is None:
                    self._owner = owner
                    return True
                if self._owner == owner:  # idempotent re-acquire (rpc retry)
                    return True
                if not blocking:
                    return False
                now = time.monotonic()
                limit = hard_deadline if deadline is None else min(deadline, hard_deadline)
                if now >= limit:
                    return False
                self._cond.wait(timeout=min(1.0, limit - now))

    def _srv_release(self, owner):
        owner = tuple(owner)
        with self._cond:
            if self._owner == owner:
                self._owner = None
                self._cond.notify_all()
                return True
            return False

    # Each server-side wait is bounded (a server thread must never block
    # forever for a client that already gave up), so a long or infinite
    # client acquire is issued as a loop of bounded slices.
    _SLICE = 30.0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        owner = (os.getpid(), self._client_token)
        if not blocking or (0 <= timeout <= self._SLICE):
            return self._call(
                "acquire", owner, blocking, timeout,
                timeout=max(60.0, timeout + 30.0),
            )
        deadline = None if timeout < 0 else time.monotonic() + timeout
        while True:
            remaining = self._SLICE if deadline is None else min(
                self._SLICE, deadline - time.monotonic()
            )
            if remaining <= 0:
                return False
            if self._call(
                "acquire", owner, True, remaining, timeout=remaining + 30.0
            ):
                return True

    def release(self) -> bool:
        return self._call("release", (os.getpid(), self._client_token))



class SharedQueue(LocalSocketComm):
    """A queue owned by the agent (e.g. the checkpoint event queue)."""

    KIND = "queue"

    def __init__(self, name: str, create: bool = False, maxsize: int = 0, job: str = ""):
        self._queue: Optional[queue.Queue] = (
            queue.Queue(maxsize) if create else None
        )
        super().__init__(name, create, job)

    def _srv_put(self, item, block=True, timeout=None):
        self._queue.put(item, block=block, timeout=timeout)

    def _srv_get(self, block=True, timeout=None):
        return self._queue.get(block=block, timeout=timeout)

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        self._call("put", item, block, timeout, timeout=(timeout or 60.0) + 60.0)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        try:
            return self._call(
                "get", block, timeout, timeout=(timeout or 3600.0) + 5.0
            )
        except RuntimeError as e:
            if "Empty" in str(e):
                raise queue.Empty from e
            raise


class SharedDict(LocalSocketComm):
    """A dict owned by the agent (e.g. checkpoint tensor metadata)."""

    KIND = "dict"

    def __init__(self, name: str, create: bool = False, job: str = ""):
        self._dict: Optional[Dict] = {} if create else None
        self._dict_lock = threading.Lock() if create else None
        super().__init__(name, create, job)

    def _srv_set(self, key, value):
        with self._dict_lock:
            self._dict[key] = value

    def _srv_get(self, key, default=None):
        with self._dict_lock:
            return self._dict.get(key, default)

    def _srv_copy(self):
        with self._dict_lock:
            return dict(self._dict)

    def set(self, key, value):
        self._call("set", key, value)

    def get(self, key, default=None):
        return self._call("get", key, default)

    def copy(self) -> Dict:
        return self._call("copy")


def server_exists(kind: str, name: str, job: str = "") -> bool:
    """True iff the owner process of a shared object is live and accepting.

    A real connect probe, not a stat: a SIGKILLed agent leaves its socket
    file behind, and a stale file must not make a standalone trainer
    misdetect agent mode. Used by the checkpoint engine to decide between
    agent mode (stage to shm, agent persists asynchronously) and standalone
    mode (persist inline).
    """
    job = job or env_utils.JOB_NAME.get()
    path = _sock_path(job, kind, name)
    if not os.path.exists(path):
        return False
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(2.0)
            s.connect(path)
        return True
    except OSError:
        return False


def clear_job_sockets(job: str):
    """Remove all socket files of a job (test/bootstrap hygiene)."""
    d = _sock_dir(job)
    if not os.path.isdir(d):
        return
    for f in os.listdir(d):
        try:
            os.unlink(os.path.join(d, f))
        except OSError as e:
            logger.warning("failed removing socket %s: %s", f, e)
