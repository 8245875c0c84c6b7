"""Launch-contract names and the checkpoint file layout — the port's
copy of ``NodeEnv`` and ``CheckpointConstant``
(``dlrover_tpu/common/constants.py``), limited to what the port reads."""

from dlrover_tpu_torch.common import env_utils as _env


class NodeEnv:
    """Environment variables the launcher/agent sets for every worker."""

    COORDINATOR_ADDR = _env.COORDINATOR_ADDR.name
    PROCESS_ID = _env.PROCESS_ID.name
    NUM_PROCESSES = _env.NUM_PROCESSES.name
    LOCAL_RANK = _env.LOCAL_RANK.name


class CheckpointConstant:
    """Flash-checkpoint file layout, the JAX package's: per-shard done
    files and a tracker file naming the last complete step."""

    TRACKER_FILE = "latest_checkpointed_iteration.txt"
    STEP_DIR_PREFIX = "checkpoint-"
    SHARD_FILE_PREFIX = "shard_"
    DONE_FILE_PREFIX = "done_"
    # A step dir found missing/corrupt/undecodable is stamped with this
    # marker (body = reason) and skipped by restore and GC thereafter.
    QUARANTINE_FILE = "QUARANTINED"
