"""``python -m dlrover_tpu_torch.master.main`` — boot a job master (the
port's copy of ``dlrover_tpu/master/main.py``, with its flags).

The master binds ``--port`` (0 = a free port) and, with ``--port_file``,
writes the bound port there atomically once serving. The flags of parts
the port's master leaves out (``--metrics_port``, ``--ha_dir``,
``--standby``, a ``--platform`` other than local) raise at start with
the ROADMAP queue 1 item that brings them.
"""

import argparse
import os
import sys

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.master import JobMaster


def parse_args(argv=None):
    parser = argparse.ArgumentParser("dlrover_tpu_torch master")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--node_num", type=int, default=1)
    parser.add_argument("--job_name", type=str, default="local-job")
    parser.add_argument(
        "--platform", type=str, default="local", choices=["local", "k8s", "ray"]
    )
    parser.add_argument("--port_file", type=str, default="",
                        help="write the bound port to this file once serving")
    parser.add_argument("--state_dir", type=str, default="",
                        help="persist master state (snapshots + WAL) here; "
                        "a relaunched master with the same dir resumes the "
                        "previous incarnation's job state")
    parser.add_argument("--metrics_port", type=int, default=None,
                        help="refused: the /metrics exporter comes with "
                        "ROADMAP queue 1, item 5")
    parser.add_argument("--ha_dir", type=str, default="",
                        help="refused: the master hot standby comes with "
                        "ROADMAP queue 1, item 10's rest")
    parser.add_argument("--standby", action="store_true",
                        help="refused: the master hot standby comes with "
                        "ROADMAP queue 1, item 10's rest")
    return parser.parse_args(argv)


def check_args(args):
    """Raise for a flag of a part the port's master leaves out."""
    refused = []
    if args.metrics_port is not None:
        refused.append("--metrics_port (the observability plane's /metrics "
                       "exporter, ROADMAP queue 1, item 5)")
    if args.ha_dir:
        refused.append("--ha_dir (the master hot standby, ROADMAP queue 1, "
                       "item 10's rest)")
    if args.standby:
        refused.append("--standby (the master hot standby, ROADMAP queue 1, "
                       "item 10's rest)")
    if args.platform != "local":
        refused.append(f"--platform {args.platform} (the k8s and Ray "
                       "scalers, ROADMAP queue 1, item 10's rest)")
    if refused:
        raise NotImplementedError(
            "the port's master leaves out " + "; ".join(refused))


def write_port_file(path: str, port: int):
    """Atomic write: pollers either see nothing or the full port number,
    never an empty/partial file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(str(port))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def run(args) -> int:
    check_args(args)
    master = JobMaster(
        port=args.port, node_num=args.node_num, job_name=args.job_name,
        state_dir=args.state_dir,
    )
    master.prepare()
    if args.port_file:
        write_port_file(args.port_file, master.port)
    return master.run()


def main(argv=None) -> int:
    args = parse_args(argv)
    logger.info("starting master with %s", args)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
