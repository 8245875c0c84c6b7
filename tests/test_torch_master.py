"""The port's master core and its wire against the JAX package's.

- **The wire.** Every dataclass of ``dlrover_tpu/common/messages.py`` has
  a twin in ``dlrover_tpu_torch/common/messages.py`` with the same fields
  and defaults. Each twin, filled with seeded values (nested twins and
  ``JobEvent``s where a field holds them), pickles through the port's
  codec to the bytes the JAX package's ``pickle.dumps`` writes for the
  JAX message, alone and in a request or response envelope; those bytes
  load through JAX's ``pickle.loads`` into the JAX class, equal field by
  field, and JAX's bytes load through the port's codec into the twin,
  also where a value holds the port's module name. The decoder refuses
  any other global.
- **The rendezvous.** Seeded sequences of joins, leaves, parameter
  changes, invalidations, reports and clock ticks drive a JAX manager and
  the port's under one fake clock (each module's ``time`` replaced);
  every answer and the round counters agree after every operation, for
  the elastic-training manager and the device-check manager (its groups,
  fault and straggler verdicts, report expiry).
- **End to end.** ``tests/test_master.py::TestMasterEndToEnd``'s
  scenarios that this slice serves (kv store, rendezvous RPC, metrics /
  sync / status, job exit) in three pairings: the port's client with the
  port's master, the JAX client with the port's master, the port's client
  with the JAX master. The port's master runs in a child process in which
  importing ``dlrover_tpu`` (or jax) raises (``master.launch``), bound to
  port 0 and read from ``--port_file``; what the scenarios read of the
  master's state is read from its final snapshot. The JAX scenario of
  dynamic sharding is item 4's and answers with that item.
- **The state store.** A port master with ``--state_dir`` is killed with
  SIGKILL and relaunched: it serves the kv store, the node registry and
  the rendezvous round, also to a client of the old address that reads
  the new one from a file (``rpc.endpoint_from_file``). A JAX master's
  state dir (kv, nodes, rounds,
  step, and records of parts the port leaves out) recovers in the port's
  master, and the port's in the JAX master's.
- **Out-of-slice parts.** Each message whose handler needs a part the
  port's master leaves out raises through the client with its ROADMAP
  queue 1 item, and so does each left-out flag or environment setting.
- **Lockdep and chaos.** Armed (``DLROVER_TPU_LOCKDEP``), the port's
  master records an acyclic lock order whose every edge the JAX master
  records for the same RPCs, and an ABBA inversion raises in both
  packages. A seeded fault plan (``DLROVER_TPU_CHAOS``) on the RPC sites
  journals (``DLROVER_TPU_CHAOS_LOG``) the same faults for a port client
  and master as for the JAX pair, and the retried writes apply once.
- **Load.** 100 port clients at once against the port's master (a child
  process), 12 RPCs each: zero RPC errors and a p99 under 1000 ms, the
  bound of JAX's ``tests/test_master_scale.py::test_hundred_agent_smoke``.
"""

import dataclasses
import glob
import os
import pickle
import shutil
import signal
import statistics
import threading
import time
import typing
import uuid

import numpy as np
import pytest

import dlrover_tpu.common.messages as jm
import dlrover_tpu.common.node as jnode
import dlrover_tpu.master.rendezvous as jrdzv
import dlrover_tpu.observability.events as jev
from dlrover_tpu.agent.master_client import MasterClient as JaxClient
from dlrover_tpu.master.master import JobMaster as JaxMaster
from dlrover_tpu_torch.agent import master_client as pclient
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import messages as pm
from dlrover_tpu_torch.common import wire
from dlrover_tpu_torch.common.constants import NodeStatus, RendezvousName
from dlrover_tpu_torch.common import rpc as prpc
from dlrover_tpu_torch.master import launch, main as pmain
from dlrover_tpu_torch.master import master as pmaster
from dlrover_tpu_torch.master import rendezvous as prdzv
from dlrover_tpu_torch.master import servicer as pservicer
from dlrover_tpu_torch.master import state_store as pstore
from dlrover_tpu_torch.master.master import JobMaster
from dlrover_tpu_torch.observability import events as pev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINING = RendezvousName.TRAINING
CHECK = RendezvousName.DEVICE_CHECK


def jax_classes():
    return {n: c for n, c in vars(jm).items()
            if dataclasses.is_dataclass(c) and c.__module__ == jm.__name__}


NAMES = sorted(jax_classes())


# ------------------------------------------------------------ the wire


def test_there_are_53_messages():
    assert len(NAMES) == 53
    port = {n for n, c in vars(pm).items()
            if dataclasses.is_dataclass(c) and c.__module__ == pm.__name__}
    assert port == set(NAMES)


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    return f.default_factory()


@pytest.mark.parametrize("name", NAMES)
def test_twin_has_the_same_fields_and_defaults(name):
    j, p = getattr(jm, name), getattr(pm, name)
    jf, pf = dataclasses.fields(j), dataclasses.fields(p)
    assert [f.name for f in jf] == [f.name for f in pf]
    for a, b in zip(jf, pf):
        assert _default(a) == _default(b), (name, a.name)
        assert type(_default(a)) is type(_default(b)), (name, a.name)
        assert str(a.type) == str(b.type).replace("dlrover_tpu_torch.",
                                                  "dlrover_tpu."), a.name
    assert getattr(j, "journaled", None) == getattr(p, "journaled", None)
    assert [k for k in vars(j) if isinstance(vars(j)[k], property)] == \
        [k for k in vars(p) if isinstance(vars(p)[k], property)]


def _value(hint, rng, depth):
    """A seeded value of the field's type (both packages' twins for a
    nested message or a JobEvent)."""
    origin = typing.get_origin(hint)
    args = typing.get_args(hint)
    if origin is typing.Union:  # Optional[X]
        return _value(next(a for a in args if a is not type(None)), rng,
                      depth)
    if hint is int:
        return int(rng.integers(-5, 10**6))
    if hint is float:
        return float(rng.uniform(-1e3, 1e9))
    if hint is bool:
        return bool(rng.integers(0, 2))
    if hint is str:
        return "".join(chr(c) for c in rng.integers(32, 127,
                                                    rng.integers(0, 24)))
    if hint is bytes:
        return rng.bytes(int(rng.integers(0, 40)))
    if hint is typing.Any:
        return [int(rng.integers(0, 9)), "any", None]
    if origin in (list, typing.List) or hint in (list, typing.List):
        if args and args[0] is jm.ShardTask:
            return [_pair("ShardTask", rng, depth + 1)
                    for _ in range(int(rng.integers(1, 3)))]
        if not args:  # EventReport.events: JobEvents
            return [_event_pair(rng) for _ in range(2)]
        return [_value(args[0], rng, depth)
                for _ in range(int(rng.integers(0, 4)))]
    if origin in (tuple, typing.Tuple):
        return tuple(_value(args[0], rng, depth)
                     for _ in range(int(rng.integers(0, 4))))
    if origin in (dict, typing.Dict) or hint in (dict, typing.Dict):
        k, v = args if args else (str, int)
        return {_value(k, rng, depth): _value(v, rng, depth)
                for _ in range(int(rng.integers(0, 4)))}
    raise AssertionError(f"no value for {hint}")


class Pair:
    """One value as each package builds it."""

    def __init__(self, j, p):
        self.j, self.p = j, p


def _split(value, side):
    if isinstance(value, Pair):
        return getattr(value, side)
    if isinstance(value, list):
        return [_split(v, side) for v in value]
    return value


def _event_pair(rng):
    kw = dict(kind="rendezvous.join", ts=float(rng.uniform(0, 2e9)),
              node_id=int(rng.integers(0, 9)), role="master", pid=7,
              seq=int(rng.integers(0, 99)),
              args={"round": int(rng.integers(0, 5))})
    return Pair(jev.JobEvent(**kw), pev.JobEvent(**kw))


def _pair(name, rng, depth=0):
    hints = typing.get_type_hints(getattr(jm, name))
    kw = {f.name: _value(hints[f.name], rng, depth)
          for f in dataclasses.fields(getattr(jm, name))}
    return Pair(getattr(jm, name)(**{k: _split(v, "j") for k, v in kw.items()}),
                getattr(pm, name)(**{k: _split(v, "p") for k, v in kw.items()}))


def _same_fields(j, p):
    """Field by field: the port's twin against the JAX message, nested
    messages and events too."""
    if dataclasses.is_dataclass(j):
        assert type(j).__name__ == type(p).__name__
        assert type(p).__module__.startswith("dlrover_tpu_torch.")
        for f in dataclasses.fields(j):
            _same_fields(getattr(j, f.name), getattr(p, f.name))
    elif isinstance(j, (list, tuple)):
        assert type(j) is type(p) and len(j) == len(p)
        for a, b in zip(j, p):
            _same_fields(a, b)
    elif isinstance(j, dict):
        assert j.keys() == p.keys()
        for k in j:
            _same_fields(j[k], p[k])
    else:
        assert type(j) is type(p) and j == p


@pytest.mark.parametrize("name", NAMES)
def test_messages_cross_both_ways_bit_for_bit(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    for _ in range(3):
        pair = _pair(name, rng)
        rid = uuid.uuid4().hex
        for j, p in ((pair.j, pair.p), ((rid, pair.j), (rid, pair.p)),
                     ((True, pair.j, 4), (True, pair.p, 4))):
            data = wire.dumps(p)
            assert data == pickle.dumps(j)
            back = pickle.loads(data)
            assert back == j
            _same_fields(back, p)
            mine = wire.loads(pickle.dumps(j))
            assert mine == p
            _same_fields(j, mine)


def test_port_name_in_a_value_takes_the_slow_path_unchanged():
    """A kv value that is itself a plain pickle of a port message, and a
    key that names the port's module: the pure-Python pickler renames
    class globals only, so their bytes cross untouched."""
    inner = pickle.dumps(pm.CommWorld(rdzv_name="x", world={0: 2}))
    for kw in ({"key": "k", "value": inner},
               {"key": "dlrover_tpu_torch.common.messages", "value": b""}):
        p = (uuid.uuid4().hex, pm.KVStoreSet(**kw))
        j = (p[0], jm.KVStoreSet(**kw))
        assert wire.dumps(p) == pickle.dumps(j)
        assert wire.loads(wire.dumps(p)) == p


def test_large_message_crosses_over_many_frames():
    p = pm.KVStoreSet(key="big", value=bytes(range(256)) * 1024)
    j = jm.KVStoreSet(key="big", value=p.value)
    assert wire.dumps(p) == pickle.dumps(j)
    assert wire.loads(pickle.dumps(j)) == p


@pytest.mark.parametrize("payload", [
    lambda: pickle.dumps(os.system),
    lambda: pickle.dumps(np.zeros(3)),
    lambda: pickle.dumps(jnode.NodeResource()),
    lambda: pickle.dumps(jev.EventKind),
], ids=["os.system", "numpy", "other-module", "non-message-class"])
def test_decoder_refuses_other_globals(payload):
    with pytest.raises(pickle.UnpicklingError, match="may not name"):
        wire.loads(payload())


# ------------------------------------------------------------ rendezvous


class Clock:
    """One clock for both packages' managers (``time.monotonic``)."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(jrdzv, "time", c)
    monkeypatch.setattr(prdzv, "time", c)
    return c


def _training_op(rng, ranks):
    kind = rng.choice(["params", "join", "join", "join", "world", "world",
                       "world", "remove", "invalidate", "waiting", "stale",
                       "tick", "tick", "absorb"])
    r = int(rng.integers(0, ranks))
    if kind == "params":
        lo = int(rng.integers(1, 4))
        return ("update_rdzv_params", lo, int(rng.integers(lo, 5)),
                float(rng.choice([2.0, 30.0])), int(rng.integers(1, 3)))
    if kind == "join":
        return ("join_rendezvous", r, int(rng.choice([1, 2, 4])))
    if kind == "world":
        return ("get_comm_world", r)
    if kind == "remove":
        return ("remove_alive_node", r)
    if kind == "invalidate":
        return ("invalidate_round",)
    if kind == "waiting":
        return ("num_nodes_waiting",)
    if kind == "stale":
        return ("world_stale", int(rng.integers(0, 6)))
    if kind == "absorb":
        return ("absorb_world", {int(x): 1 for x in
                                 rng.choice(ranks, 2, replace=False)})
    return ("tick", float(rng.choice([0.5, 1.0, 3.5, 40.0])))


def _check_op(rng, ranks):
    kind = rng.choice(["params", "join", "join", "join", "world", "world",
                       "world", "report", "report", "report", "fault",
                       "straggler", "completed", "remove", "tick"])
    r = int(rng.integers(0, ranks))
    if kind == "params":
        lo = int(rng.integers(2, 5))
        return ("update_rdzv_params", lo, int(rng.integers(lo, 7)), 5.0, 1)
    if kind == "join":
        return ("join_rendezvous", r, 1)
    if kind == "world":
        return ("get_comm_world", r)
    if kind == "report":
        round_ = None if rng.random() < 0.7 else int(rng.integers(1, 4))
        return ("report_check_result", r, bool(rng.random() < 0.75),
                float(rng.choice([1.0, 1.1, 0.9, 5.0])), round_)
    if kind == "fault":
        return ("check_fault_node",)
    if kind == "straggler":
        return ("check_straggler",)
    if kind == "completed":
        return ("completed_rounds",)
    if kind == "remove":
        return ("remove_alive_node", r)
    return ("tick", float(rng.choice([0.5, 2.0, 6.0, 200.0])))


def _drive(managers, ops, clock):
    for op in ops:
        if op[0] == "tick":
            clock.t += op[1]
            continue
        answers = []
        for mgr in managers:
            args, kw = list(op[1:]), {}
            if op[0] == "report_check_result":
                args, kw = args[:3], {"round_": args[3]}
            try:
                answers.append(getattr(mgr, op[0])(*args, **kw))
            except Exception as e:  # the JAX manager's own errors too
                answers.append((type(e).__name__, e.args))
        assert answers[0] == answers[1], op
        states = [(m.checkpoint(), m.current_world(), m.current_round(),
                   m.num_nodes_waiting()) for m in managers]
        assert states[0] == states[1], op


@pytest.mark.parametrize("seed", range(6))
def test_training_rendezvous_matches_jax(clock, seed):
    rng = np.random.default_rng(seed)
    managers = [jrdzv.ElasticTrainingRendezvousManager(TRAINING),
                prdzv.ElasticTrainingRendezvousManager(TRAINING)]
    for mgr in managers:
        mgr.update_rdzv_params(2, 4, 30.0, 1)
    _drive(managers, [_training_op(rng, 6) for _ in range(300)], clock)


@pytest.mark.parametrize("seed", range(6))
def test_device_check_rendezvous_matches_jax(clock, seed):
    rng = np.random.default_rng(100 + seed)
    managers = [jrdzv.DeviceCheckRendezvousManager(CHECK, check_timeout=60),
                prdzv.DeviceCheckRendezvousManager(CHECK, check_timeout=60)]
    for mgr in managers:
        mgr.update_rdzv_params(4, 4, 5.0, 1)
    _drive(managers, [_check_op(rng, 6) for _ in range(300)], clock)


def test_device_check_localizes_a_fault_as_jax(clock):
    """JAX's two-round diagnosis (tests/test_master.py), step by step in
    both packages: pairs, suspects, the confirmed fault node, then the
    straggler rule."""
    managers = [jrdzv.DeviceCheckRendezvousManager(CHECK),
                prdzv.DeviceCheckRendezvousManager(CHECK)]
    ops = [("update_rdzv_params", 4, 4, 5.0, 1)]
    for bad in ((2, 3), (3,)):
        ops += [("join_rendezvous", r, 1) for r in range(4)]
        ops += [("get_comm_world", r) for r in range(4)]
        ops += [("report_check_result", r, r not in bad, 1.0, None)
                for r in range(4)]
        ops += [("check_fault_node",), ("completed_rounds",)]
    _drive(managers, ops, clock)
    assert managers[1].check_fault_node() == ([3], True)
    ops = [("join_rendezvous", r, 1) for r in range(4)]
    ops += [("get_comm_world", r) for r in range(4)]
    ops += [("report_check_result", r, True, t, None)
            for r, t in enumerate((1.0, 1.1, 0.9, 5.0))]
    ops += [("check_straggler",)]
    _drive(managers, ops, clock)
    assert managers[1].check_straggler() == ([3], True)


# ------------------------------------------------------------ masters


def child_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    for name in ("DLROVER_TPU_MASTER_ADDR", "DLROVER_TPU_METRICS_PORT",
                 "DLROVER_TPU_MASTER_HA_DIR"):
        env.pop(name, None)
    return env


class PortMaster:
    """The port's master in a child process where ``dlrover_tpu`` and jax
    may not be imported (``launch.start_master``), with a state dir."""

    def __init__(self, root, node_num=2, state_dir=None):
        self.root = root
        self.state_dir = state_dir or str(root / "state")
        self.port_file = str(root / f"port-{uuid.uuid4().hex[:6]}")
        self.log = open(root / f"master-{uuid.uuid4().hex[:6]}.log", "w+")
        self.proc = launch.start_master(
            self.port_file, ["--node_num", str(node_num),
                             "--state_dir", self.state_dir],
            env=child_env(), stdout=self.log)
        try:
            self.port = launch.wait_for_port(self.port_file, self.proc)
        except Exception:
            self.close()
            raise AssertionError(self.tail())
        self.addr = f"127.0.0.1:{self.port}"

    def tail(self):
        self.log.flush()
        self.log.seek(0)
        return self.log.read()[-4000:]

    def wait(self, timeout=30):
        code = self.proc.wait(timeout=timeout)
        assert code == 0, self.tail()
        return code

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


class JaxMasterInProcess:
    """The JAX master in this process, with a state dir."""

    def __init__(self, root, node_num=2, state_dir=None):
        self.state_dir = state_dir or str(root / "state")
        self.master = JaxMaster(port=0, node_num=node_num,
                                state_dir=self.state_dir)
        self.master.prepare()
        self.addr = self.master.addr
        self.stopped = False

    def wait(self, timeout=30):
        self.stopped = True  # run() stops the master
        assert self.master.run(poll_interval=0.05) == 0
        return 0

    def close(self):
        if not self.stopped:
            self.master.stop()


def newest_snapshot(state_dir):
    """The newest snapshot of a state dir, read by the port's codec."""
    paths = glob.glob(os.path.join(state_dir, "snapshot-*.bin"))
    path = max(paths, key=lambda p: int(p.rsplit("-", 1)[1][:-4]))
    with open(path, "rb") as f:
        data = f.read()
    algo, off = pstore._read_header(data, pstore._SNAP_MAGIC)
    payloads, torn = pstore._iter_frames(data[off:], algo)
    assert not torn and len(payloads) == 1
    return wire.loads(payloads[0])


PAIRINGS = {
    "port-client-port-master": (MasterClient, PortMaster),
    "jax-client-port-master": (JaxClient, PortMaster),
    "port-client-jax-master": (MasterClient, JaxMasterInProcess),
}


@pytest.fixture(params=sorted(PAIRINGS))
def pairing(request, tmp_path):
    client_cls, master_cls = PAIRINGS[request.param]
    master = master_cls(tmp_path)
    clients = []

    def client(node_id=0):
        c = client_cls(master.addr, node_id=node_id)
        clients.append(c)
        return c

    yield master, client
    for c in clients:
        c.close()
    master.close()


def test_kv_store(pairing):
    _, client = pairing
    c = client()
    c.kv_store_set("a", b"1")
    assert c.kv_store_get("a") == b"1"
    assert c.kv_store_get("missing") is None
    assert c.kv_store_add("ctr", 2) == 2
    assert c.kv_store_add("ctr", 3) == 5
    assert c.kv_store_multi_get(["a", "ctr"]) == {"a": b"1", "ctr": b"5"}
    c.kv_store_delete("a")
    assert c.kv_store_get("a") is None
    lease = c.elect_ckpt_writer("g", 0, 1)
    assert lease.owner_rank == 1 and c.elect_ckpt_writer("g", 0, 0) \
        .owner_rank == 1


def test_rendezvous_rpc(pairing):
    _, client = pairing
    c0, c1 = client(0), client(1)
    c0.report_rdzv_params(2, 2, 10.0, 1)
    assert c0.join_rendezvous(TRAINING, 0, 4) == 0
    c1.join_rendezvous(TRAINING, 1, 4)
    round_, group, world = c0.get_comm_world(TRAINING)
    assert (round_, group, world) == (1, 0, {0: 4, 1: 4})
    assert c1.get_comm_world(TRAINING) == (1, 0, {0: 4, 1: 4})
    assert c0.num_nodes_waiting(TRAINING) == 0
    assert c0.world_stale(TRAINING, 1) is False
    c1.report_failure("worker died", level="node_error")
    assert c0.world_stale(TRAINING, 1) is True


def test_metrics_sync_and_status(pairing):
    master, client = pairing
    c = client()
    c.report_global_step(10)
    c.report_heartbeat()
    assert c.join_sync("warmup", 0) in (True, False)
    c.barrier("b1", notify=True)
    assert c.barrier("b1") is True
    c.report_node_status(NodeStatus.RUNNING)
    assert c.get_paral_config().version == 0
    c.report_job_exit(success=True, reason="done")
    master.wait()
    state = newest_snapshot(master.state_dir)
    assert state["speed"]["global_step"] == 10
    nodes = {n["id"]: n for n in state["nodes"]}
    assert nodes[0]["status"] == NodeStatus.RUNNING


def test_job_exit(pairing):
    master, client = pairing
    client().report_job_exit(success=True, reason="done")
    assert master.wait() == 0


# ------------------------------------------------------------ left out


@pytest.fixture(scope="module")
def port_master(tmp_path_factory):
    master = JobMaster(port=0, node_num=2)
    master.prepare()
    yield master
    master.stop()


def _left_out_request(cls):
    req = cls()
    if cls is pm.AgentBeat:
        req.probe = {"rtt_ms": 1.0}
    if cls is pm.NodeResourceStats:
        req.cpu_percent = -1.0
    return req


@pytest.mark.parametrize("cls", sorted(
    list(pservicer.LEFT_OUT) + [pm.AgentBeat, pm.NodeResourceStats],
    key=lambda c: c.__name__), ids=lambda c: c.__name__)
def test_left_out_handler_raises_with_its_item(port_master, cls):
    c = MasterClient(port_master.addr, node_id=0)
    try:
        with pytest.raises(RuntimeError, match=r"ROADMAP queue 1, item "
                           r"(4|5|10's rest)"):
            c._call(_left_out_request(cls))
    finally:
        c.close()


def test_left_out_client_methods_raise_with_their_item(port_master):
    c = MasterClient(port_master.addr, node_id=0)
    try:
        for call, item in (
                (lambda: c.report_dataset_shard_params("ds", 100, 10), "4"),
                (lambda: c.get_task("ds"), "4"),
                (lambda: c.request_lease("ds"), "4"),
                (lambda: c.get_rescale_plan(TRAINING, 0, 1), "4"),
                (lambda: c.report_events([pev.JobEvent(kind="x")]), "5"),
                (lambda: c.report_beat(probe={"rtt_ms": 1.0}), "5"),
                (lambda: c.report_preemption_notice(0, 1.0, 1.0, "file"),
                 "10's rest"),
                (lambda: c.report_model_info(1, 1.0), "10's rest")):
            with pytest.raises(RuntimeError, match=f"item {item}"):
                call()
        # The served half of the same messages still works.
        assert c.report_beat(step=3).success
        assert c.report_resource_stats(10.0, 100).success
    finally:
        c.close()


@pytest.mark.parametrize("flags,item", [
    (["--metrics_port", "0"], "item 5"),
    (["--ha_dir", "/nonexistent"], "item 10's rest"),
    (["--standby"], "item 10's rest"),
    (["--platform", "k8s"], "item 10's rest"),
], ids=["metrics_port", "ha_dir", "standby", "platform"])
def test_left_out_flags_raise_at_start(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        pmain.run(pmain.parse_args(["--port", "0", *flags]))


@pytest.mark.parametrize("name,value,item", [
    ("DLROVER_TPU_METRICS_PORT", "0", "item 5"),
    ("DLROVER_TPU_MASTER_HA_DIR", "/nonexistent", "item 10's rest"),
] + [(name, "1", item) for name, (_, item) in
     sorted(pmaster.LEFT_OUT_SETTINGS.items())],
    ids=lambda v: v if str(v).startswith("DLROVER") else "")
def test_left_out_environment_raises_at_start(monkeypatch, name, value,
                                              item):
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match=f"{name}.*{item}"):
        JobMaster(port=0)


@pytest.mark.parametrize("name", pclient.HA_SETTINGS)
def test_left_out_client_settings_raise(monkeypatch, name):
    """Following a master under the hot standby is not the port's yet:
    the client refuses the JAX client's settings for it."""
    monkeypatch.setenv(name, "/nonexistent")
    with pytest.raises(NotImplementedError, match="item 10's rest"):
        MasterClient("127.0.0.1:1", node_id=0)


# ------------------------------------------------------------ state store


def test_killed_master_resumes_kv_nodes_and_round(tmp_path):
    state = str(tmp_path / "state")
    master = PortMaster(tmp_path, node_num=2, state_dir=state)
    c0, c1 = MasterClient(master.addr, 0), MasterClient(master.addr, 1)
    try:
        c0.report_rdzv_params(2, 2, 10.0, 1)
        c0.join_rendezvous(TRAINING, 0, 1)
        c1.join_rendezvous(TRAINING, 1, 1)
        assert c0.get_comm_world(TRAINING) == (1, 0, {0: 1, 1: 1})
        c0.kv_store_set("ckpt", b"step-7")
        assert c0.kv_store_add("n", 5) == 5
        c1.report_node_status(NodeStatus.SUCCEEDED)
        c0.report_global_step(7)
        os.kill(master.proc.pid, signal.SIGKILL)
        master.proc.wait()
    finally:
        c0.close(), c1.close()
        master.close()
    again = PortMaster(tmp_path, node_num=2, state_dir=state)
    # A client of the old address finds the new one in a file.
    endpoint = tmp_path / "endpoint"
    endpoint.write_text(again.addr)
    moved = prpc.RpcClient(master.addr, retry_deadline=30.0,
                           endpoint_source=prpc.endpoint_from_file(
                               str(endpoint)))
    c0 = MasterClient(again.addr, 0)
    try:
        assert moved.call(pm.KVStoreGet(key="ckpt")) == b"step-7"
        assert c0.kv_store_get("ckpt") == b"step-7"
        assert c0.kv_store_add("n", 1) == 6
        # The round counter resumed: the next world is round 2.
        c0.report_rdzv_params(1, 1, 10.0, 1)
        assert c0.join_rendezvous(TRAINING, 0, 1) == 1
        assert c0.get_comm_world(TRAINING) == (2, 0, {0: 1})
        c0.report_job_exit(success=True)
        again.wait()
    finally:
        moved.close()
        c0.close()
        again.close()
    snap = newest_snapshot(state)
    nodes = {n["id"]: n["status"] for n in snap["nodes"]}
    assert nodes[1] == NodeStatus.SUCCEEDED
    assert snap["rdzv"][TRAINING]["round"] == 2


def _fill(client_cls, addr, left_out=False):
    """What both directions check: kv, a frozen round, node statuses and
    a step; with ``left_out``, records of parts the port leaves out."""
    c0, c1 = client_cls(addr, node_id=0), client_cls(addr, node_id=1)
    c0.report_rdzv_params(2, 2, 10.0, 1)
    c0.join_rendezvous(TRAINING, 0, 2)
    c1.join_rendezvous(TRAINING, 1, 2)
    assert c0.get_comm_world(TRAINING)[2] == {0: 2, 1: 2}
    c0.kv_store_set("k", b"v")
    c0.kv_store_add("n", 3)
    c0.report_node_status(NodeStatus.RUNNING)
    c1.report_node_status(NodeStatus.SUCCEEDED)
    c0.report_global_step(42)
    if left_out:
        c0.report_dataset_shard_params("ds", 100, 10)
        t = c0.get_task("ds")
        c0.report_task("ds", t.task_id)
    c0.close(), c1.close()


def _recovered(master):
    """What a recovered master (either package's) holds of the state
    this slice serves."""
    return {"kv": master.kv_store.export_state(),
            "nodes": {n.id: n.status for n in master.job_manager.all_nodes()},
            "rdzv": {name: mgr.checkpoint()
                     for name, mgr in master.rdzv_managers.items()},
            "step": master.speed_monitor.global_step}


def _recover_in_both(state, tmp_path):
    """The state dir recovered by a JAX master and by a port master,
    each in a copy of its own (recovery mints an incarnation)."""
    out = {}
    for name, cls in (("jax", JaxMaster), ("port", JobMaster)):
        d = str(tmp_path / f"recover-{name}")
        shutil.copytree(state, d)
        master = cls(port=0, node_num=2, state_dir=d)
        try:
            out[name] = _recovered(master)
            if name == "port":
                out["skipped"] = master.last_recovery_stats["skipped"]
        finally:
            master.stop()
    return out


def _held(got, step):
    assert got["kv"] == {"k": b"v", "n": b"3"}
    assert got["nodes"] == {0: NodeStatus.RUNNING, 1: NodeStatus.SUCCEEDED}
    assert got["rdzv"][TRAINING]["round"] == 1
    assert got["step"] == step


@pytest.mark.parametrize("crash", [False, True], ids=["stopped", "crashed"])
def test_jax_state_dir_recovers_in_port_master(tmp_path, crash):
    """As the JAX master recovers it: kv, nodes and rounds from the
    journal; the step (not journaled) from a snapshot, so after a crash
    neither package has it. The records of left-out parts are skipped
    with their item."""
    state = str(tmp_path / "state")
    jax_master = JaxMaster(port=0, node_num=2, state_dir=state)
    jax_master.prepare()
    _fill(JaxClient, jax_master.addr, left_out=True)
    if crash:
        # A process death: sockets severed, no final snapshot (the
        # journal carries the state), as tests/test_state_store.py's
        # crash_master simulates it.
        jax_master._stopped.set()
        jax_master._server.stop()
        jev.uninstall_sink(jax_master._event_sink_fn)
        jax_master.observability.stop()
        jax_master.state_store.close()
    else:
        jax_master.stop()
    got = _recover_in_both(state, tmp_path)
    assert got["port"] == got["jax"]
    _held(got["port"], 0 if crash else 42)
    assert any("item 4" in k for k in got["skipped"]), got["skipped"]


@pytest.mark.parametrize("crash", [False, True], ids=["stopped", "killed"])
def test_port_state_dir_recovers_in_jax_master(tmp_path, crash):
    state = str(tmp_path / "state")
    master = PortMaster(tmp_path, node_num=2, state_dir=state)
    try:
        _fill(MasterClient, master.addr)
        if crash:
            os.kill(master.proc.pid, signal.SIGKILL)
            master.proc.wait()
        else:
            c = MasterClient(master.addr, node_id=0)
            c.report_job_exit(success=True)
            c.close()
            master.wait()
    finally:
        master.close()
    got = _recover_in_both(state, tmp_path)
    assert got["jax"] == got["port"]
    _held(got["jax"], 0 if crash else 42)


def test_state_files_are_the_jax_package_bytes(tmp_path):
    """A journal record and a snapshot written by the port's store are
    byte for byte what the JAX store writes for the same state."""
    from dlrover_tpu.master import state_store as jstore

    rid = uuid.uuid4().hex
    rec_p = ("rpc", rid, pm.KVStoreSet(key="k", value=b"v"), 1.5)
    rec_j = ("rpc", rid, jm.KVStoreSet(key="k", value=b"v"), 1.5)
    state = {"version": 1, "kv": {"k": b"v"}, "nodes": [{"id": 0}]}
    out = {}
    for name, mod, rec in (("port", pstore, rec_p), ("jax", jstore, rec_j)):
        d = tmp_path / name
        store = mod.MasterStateStore(str(d))
        store.snapshot(lambda: state)
        store.append(rec)
        store.close()
        out[name] = {os.path.basename(p): open(p, "rb").read()
                     for p in sorted(glob.glob(str(d / "*-*")))}
    assert out["port"] == out["jax"]


# ------------------------------------------------------------ lockdep, chaos


def _edges(graph):
    return {(a, b) for a, bs in graph.items() for b in bs}


def test_armed_lockdep_records_jax_masters_order(monkeypatch, tmp_path):
    """Both packages' lockdep armed; the same RPCs and a snapshot against
    each package's master in this process. The port's recorded order is
    acyclic, holds the mutation locks, and every edge of it is one the
    JAX master records too."""
    from dlrover_tpu.common import lockdep as jlockdep
    from dlrover_tpu_torch.common import lockdep as plockdep

    monkeypatch.setenv("DLROVER_TPU_LOCKDEP", "1")
    graphs = {}
    for name, master_cls, client_cls, dep in (
            ("port", JobMaster, MasterClient, plockdep),
            ("jax", JaxMaster, JaxClient, jlockdep)):
        dep.reset()
        try:
            master = master_cls(port=0, node_num=2, job_name="lockdep",
                                state_dir=str(tmp_path / name))
            master.prepare()
            try:
                _fill(client_cls, master.addr)
                master.state_store.snapshot(master._collect_state)
            finally:
                master.stop()
            graphs[name] = _edges(dep.lock_graph())
            dep.assert_acyclic()
        finally:
            dep.reset()
    assert any(a.startswith("master.mutation.") for a, _ in graphs["port"])
    assert graphs["port"] <= graphs["jax"], graphs["port"] - graphs["jax"]


def test_lockdep_abba_inversion_raises_as_jax(monkeypatch):
    from dlrover_tpu.common import lockdep as jlockdep
    from dlrover_tpu_torch.common import lockdep as plockdep

    monkeypatch.setenv("DLROVER_TPU_LOCKDEP", "1")
    cycles = []
    for dep in (plockdep, jlockdep):
        dep.reset()
        try:
            a, b = dep.instrumented_lock("drill.a"), dep.instrumented_lock(
                "drill.b")
            with a, b:
                pass
            with b:
                with pytest.raises(dep.LockOrderViolation) as info:
                    a.acquire()
            cycles.append(info.value.cycle)
        finally:
            dep.reset()
    assert cycles[0] == cycles[1]


#: Faults on the three RPC sites the port instruments: every third
#: request's response lost, a seeded share of requests dropped at the
#: server, and the fifth send torn down at the client.
CHAOS_PLAN = {"seed": 11, "events": [
    {"site": "master.partition", "kind": "drop_response", "every": 3},
    {"site": "rpc.server.recv", "kind": "drop", "prob": 0.25},
    {"site": "rpc.client.send", "kind": "reset", "at": 5},
]}


def test_chaos_plan_journals_as_jax_and_applies_once(monkeypatch,
                                                     tmp_path):
    """One fault plan armed in both packages; the same single-threaded
    client's writes against each package's master in this process. Each
    retried write applies once, and the port's journal of fired faults is
    the JAX pair's, line for line."""
    import json

    from dlrover_tpu.chaos.injector import FaultInjector as JaxInjector
    from dlrover_tpu_torch.chaos.injector import FaultInjector

    monkeypatch.setenv("DLROVER_TPU_CHAOS", json.dumps(CHAOS_PLAN))
    journals = {}
    for name, master_cls, client_cls, injector in (
            ("port", JobMaster, MasterClient, FaultInjector),
            ("jax", JaxMaster, JaxClient, JaxInjector)):
        log = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("DLROVER_TPU_CHAOS_LOG", str(log))
        injector.reset()
        master = master_cls(port=0, node_num=1, job_name="chaos")
        master.prepare()
        c = client_cls(master.addr, node_id=0)
        try:
            got = [c.kv_store_add("n", 1) for _ in range(12)]
        finally:
            c.close()
            master.stop()
            injector.reset()
        assert got == list(range(1, 13)), name
        journals[name] = log.read_text().splitlines()
    assert len(journals["port"]) >= 6
    assert journals["port"] == journals["jax"]


# ------------------------------------------------------------ load


def test_hundred_clients_zero_errors_p99_under_a_second(tmp_path):
    """100 clients, each on its own connection and thread, 12 RPCs each
    (a kv write and read, a heartbeat and a step, three times), all at
    once against one master."""
    master = PortMaster(tmp_path, node_num=100)
    lat, errors = [], []
    lock = threading.Lock()
    start = threading.Barrier(100)

    def agent(i):
        c = MasterClient(master.addr, node_id=i)
        mine = []
        try:
            start.wait()
            for n in range(12):
                t0 = time.perf_counter()
                try:
                    if n % 4 == 0:
                        c.kv_store_set(f"a/{i}", str(n).encode())
                    elif n % 4 == 1:
                        c.report_heartbeat()
                    elif n % 4 == 2:
                        c.report_global_step(n)
                    else:
                        assert c.kv_store_get(f"a/{i}") == str(n - 3).encode()
                except Exception as e:  # counted, not raised
                    with lock:
                        errors.append(repr(e))
                mine.append(time.perf_counter() - t0)
        finally:
            c.close()
            with lock:
                lat.extend(mine)

    threads = [threading.Thread(target=agent, args=(i,)) for i in range(100)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        master.close()
    lat.sort()
    p99 = lat[int(0.99 * (len(lat) - 1))] * 1e3
    assert errors == []
    assert len(lat) == 1200
    assert p99 < 1000.0, (p99, statistics.median(lat) * 1e3)
