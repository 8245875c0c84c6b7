"""Times of the master's wire: the codec per message and RPC round trips.

``codec_times`` times, per message, two encodings of one request
envelope ``(request_id, message)`` and one decoding:

- ``c_pickle_us``: the C pickler on the port's message (the JAX package's
  ``pickle.dumps`` of its twin runs the same opcodes, under a module
  name six bytes shorter);
- ``wire_us``: ``common.wire.dumps``, the port's codec (the pure-Python
  pickler writing the JAX package's names);
- ``loads_us``: ``common.wire.loads`` of the JAX package's bytes.

``round_trips`` times ``n`` ``kv_store_set`` calls of a ``MasterClient``.

``python -m dlrover_tpu_torch.master.rpc_probe`` starts a port master in
a child process (``launch.start_master``), joins a one-node training
rendezvous, times the round trips and the codec, and prints one JSON
object.
"""

import argparse
import json
import os
import pickle
import statistics
import tempfile
import time
import timeit
import uuid

from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common import wire
from dlrover_tpu_torch.common.constants import RendezvousName

#: The messages whose codec times are reported: a rendezvous join, a
#: heartbeat and a kv write, as an agent sends them.
MESSAGES = {
    "JoinRendezvous": m.JoinRendezvous(
        node_id=3, rdzv_name=RendezvousName.TRAINING, node_rank=3,
        local_world_size=8),
    "NodeHeartbeat": m.NodeHeartbeat(node_id=3, timestamp=1.7e9),
    "KVStoreSet": m.KVStoreSet(node_id=3, key="loss", value=b"2.3456"),
}


def codec_times(number: int = 5000, repeat: int = 5) -> dict:
    """Microseconds per envelope of each encoding and of the decoding,
    the best of ``repeat`` runs of ``number`` calls."""
    out = {}
    for name, msg in MESSAGES.items():
        env = (uuid.uuid4().hex, msg)
        data = wire.dumps(env)

        def best(fn):
            return min(timeit.repeat(fn, number=number, repeat=repeat)) \
                / number * 1e6

        out[name] = {
            "c_pickle_us": best(lambda: pickle.dumps(env)),
            "wire_us": best(lambda: wire.dumps(env)),
            "loads_us": best(lambda: wire.loads(data)),
            "bytes": len(data),
        }
    return out


def round_trips(client, n: int = 200) -> dict:
    """Median and p99 milliseconds of ``n`` ``kv_store_set`` calls."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        client.kv_store_set(f"probe/{i}", b"x" * 16)
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return {"calls": n, "median_ms": statistics.median(times),
            "p99_ms": times[min(n - 1, int(round(0.99 * (n - 1))))]}


def rendezvous(client, node_rank: int = 0) -> dict:
    """One node's training rendezvous: report the parameters, join, poll
    the world; its milliseconds and the world."""
    t0 = time.perf_counter()
    client.report_rdzv_params(1, 1, 30.0, 1)
    client.join_rendezvous(RendezvousName.TRAINING, node_rank, 1)
    while True:
        round_, _, world = client.get_comm_world(RendezvousName.TRAINING)
        if world:
            break
        time.sleep(0.01)
    return {"ms": (time.perf_counter() - t0) * 1e3, "round": round_,
            "world": world}


def main(argv=None) -> int:
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.launch import start_master, wait_for_port

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calls", type=int, default=200)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        port_file = os.path.join(tmp, "port")
        with open(os.path.join(tmp, "master.log"), "w") as log:
            proc = start_master(port_file, stdout=log)
            try:
                port = wait_for_port(port_file, proc)
                client = MasterClient(f"127.0.0.1:{port}", node_id=0)
                out = {"rendezvous": rendezvous(client),
                       "kv_store_set": round_trips(client, args.calls)}
                client.report_job_exit(success=True)
                client.close()
                out["master_exit"] = proc.wait(timeout=30)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    out["codec"] = codec_times()
    print(json.dumps(out))
    return 0 if out["master_exit"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
