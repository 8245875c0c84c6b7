"""Trainer-side library of the port: process bootstrap and the trainer.

Counterpart of ``dlrover_tpu/train/__init__.py``: the agent's env
contract (``NodeEnv``) is mapped onto ``torch.distributed`` instead of
``jax.distributed``.
"""

import os
import time as _time
from typing import Dict, Optional

import torch

from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import logger

# Process-entry timestamp: with the agent's DLROVER_TPU_SPAWN_TS this
# yields the spawn->entry phase (fork + python + imports).
_ENTRY_TS = _time.time()
_INIT_DONE_TS: Optional[float] = None


def init_training(coordinator_addr: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None,
                  device: DeviceLike = None) -> torch.device:
    """Join the job's process group from the agent's env handoff and
    return the device this worker trains on.

    The device is ``cuda:LOCAL_RANK`` (made current) unless the caller
    passes one; without CUDA that raises unless ``device="cpu"``. A
    single-process job initializes nothing else. A multi-process job
    calls ``init_process_group`` over ``tcp://<coordinator>`` with the
    world size and rank of the contract: nccl on CUDA, gloo on the CPU.
    """
    global _INIT_DONE_TS
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    coordinator = coordinator_addr or os.getenv(NodeEnv.COORDINATOR_ADDR, "")
    n = num_processes or int(os.getenv(NodeEnv.NUM_PROCESSES, "1"))
    pid = process_id if process_id is not None else int(
        os.getenv(NodeEnv.PROCESS_ID, "0")
    )
    if n <= 1 or not coordinator:
        logger.info("single-process run on %s; no process group", dev)
        _INIT_DONE_TS = _time.time()
        return dev
    import torch.distributed as dist

    backend = "nccl" if dev.type == "cuda" else "gloo"
    logger.info(
        "init_process_group(%s, tcp://%s, world_size=%s, rank=%s)",
        backend, coordinator, n, pid,
    )
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=n, rank=pid
    )
    _INIT_DONE_TS = _time.time()
    return dev


def bootstrap_timings() -> Dict[str, float]:
    """Restart-latency phases the bootstrap can see (seconds):
    ``spawn_s`` (agent fork -> process entry; needs the agent's
    ``DLROVER_TPU_SPAWN_TS``) and ``init_s`` (``init_training`` wall)."""
    out: Dict[str, float] = {}
    spawn_ts = env_utils.SPAWN_TS.get()
    if spawn_ts:
        out["spawn_s"] = round(_ENTRY_TS - spawn_ts, 3)
    if _INIT_DONE_TS is not None:
        out["init_s"] = round(_INIT_DONE_TS - _ENTRY_TS, 3)
    return out


def global_rank() -> int:
    return int(os.getenv(NodeEnv.PROCESS_ID, "0"))


def world_size() -> int:
    return int(os.getenv(NodeEnv.NUM_PROCESSES, "1"))


def local_rank() -> int:
    return int(os.getenv(NodeEnv.LOCAL_RANK, "0"))
