"""Shared enums, launch-contract names and the checkpoint file layout —
the port's copy of the part of ``dlrover_tpu/common/constants.py`` that
the port reads. Values are the JAX package's: they travel on the
master's wire and in its state files."""

from dlrover_tpu_torch.common import env_utils as _env


class NodeType:
    """Roles a node can play in a job."""

    MASTER = "master"
    WORKER = "worker"
    PS = "ps"
    CHIEF = "chief"
    EVALUATOR = "evaluator"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    BREAKDOWN = "breakdown"
    UNKNOWN = "unknown"


class NodeExitReason:
    KILLED = "killed"
    OOM = "oom"
    FATAL_ERROR = "fatal-error"
    HARDWARE_ERROR = "hardware-error"
    PREEMPTED = "preempted"
    SUCCEEDED = "succeeded"
    UNKNOWN = "unknown"


class JobStage:
    INIT = "init"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    STOPPING = "stopping"


class RendezvousName:
    """Named rendezvous rounds managed by the master."""

    TRAINING = "elastic-training"
    DEVICE_CHECK = "device-check"


class TrainingExceptionLevel:
    RDZV_ERROR = "rdzv_error"
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    WARNING = "warning"
    INFO = "info"


class NodeEnv:
    """Environment variables the launcher/agent sets for every process."""

    JOB_NAME = _env.JOB_NAME.name
    MASTER_ADDR = _env.MASTER_ADDR.name
    NODE_ID = _env.NODE_ID.name
    NODE_RANK = _env.NODE_RANK.name
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
