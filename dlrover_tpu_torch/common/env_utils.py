"""The env knobs the port reads — its own copy of the part of
``dlrover_tpu/common/env_utils.py`` that the ported modules use.

Names, types and defaults are the JAX package's, so one launch
environment configures both packages. A worker's rank, world and local
rank fall back to torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and ``LOCAL_WORLD_SIZE`` when the package's names are unset. Reads go
to ``os.environ`` at call time, not import time.
"""

import os

_TRUTHY = ("1", "true", "yes", "on")


class EnvVar:
    """One declared variable; ``get()`` returns the typed value or the
    declared default when it is unset or does not parse."""

    __slots__ = ("name", "kind", "default", "doc", "fallback")

    def __init__(self, name: str, kind: type, default, doc: str,
                 fallback: str = ""):
        self.name = name
        self.kind = kind
        self.default = default
        self.doc = doc
        #: torchrun's name for the same value, read when ``name`` is unset.
        self.fallback = fallback

    def get(self):
        raw = os.environ.get(self.name)
        if raw is None and self.fallback:
            raw = os.environ.get(self.fallback)
        if raw is None:
            return self.default
        if self.kind is bool:
            return raw.strip().lower() in _TRUTHY
        try:
            return self.kind(raw)
        except ValueError:
            return self.default


LOG_LEVEL = EnvVar(
    "DLROVER_TPU_LOG_LEVEL", str, "INFO", "Logger level of the package.")
MASTER_ADDR = EnvVar(
    "DLROVER_TPU_MASTER_ADDR", str, "",
    "host:port of the job master; empty = no master (local run).")
COORDINATOR_ADDR = EnvVar(
    "DLROVER_TPU_COORDINATOR_ADDR", str, "",
    "host:port of the process-group rendezvous, exported by the agent.")
PROCESS_ID = EnvVar(
    "DLROVER_TPU_PROCESS_ID", int, 0, "This worker's global rank.",
    fallback="RANK")
NUM_PROCESSES = EnvVar(
    "DLROVER_TPU_NUM_PROCESSES", int, 1, "Total process count (world).",
    fallback="WORLD_SIZE")
LOCAL_RANK = EnvVar(
    "DLROVER_TPU_LOCAL_RANK", int, 0, "Worker index on this host.",
    fallback="LOCAL_RANK")
SPAWN_TS = EnvVar(
    "DLROVER_TPU_SPAWN_TS", float, 0.0,
    "time.time() stamped by the agent at worker spawn.")
STRAGGLER_PHASES = EnvVar(
    "DLROVER_TPU_STRAGGLER_PHASES", bool, True,
    "Keep the trainer's per-step phase breakdown.")
CHAOS = EnvVar(
    "DLROVER_TPU_CHAOS", str, "",
    "Fault plan; unset = chaos off. The port has no chaos sites yet.")

# ---------------- flash checkpoint ----------------
JOB_NAME = EnvVar(
    "DLROVER_TPU_JOB_NAME", str, "local-job",
    "Job name; namespaces shm segments and unix sockets.")
NODE_RANK = EnvVar(
    "DLROVER_TPU_NODE_RANK", int, 0, "Rendezvous rank of this node.")
LOCAL_WORLD_SIZE = EnvVar(
    "DLROVER_TPU_LOCAL_WORLD_SIZE", int, 1, "Worker processes per host.",
    fallback="LOCAL_WORLD_SIZE")
SOCK_DIR = EnvVar(
    "DLROVER_TPU_SOCK_DIR", str, "/tmp/dlrover_tpu/sock",
    "Directory for per-job unix sockets (shm coordination).")
SHM_DIR = EnvVar(
    "DLROVER_TPU_SHM_DIR", str, "/dev/shm",
    "Backing directory for flash-checkpoint shared-memory segments.")
CKPT_STRIPE_MB = EnvVar(
    "DLROVER_TPU_CKPT_STRIPE_MB", float, 32.0,
    "Stripe size for parallel checkpoint I/O; 0 = legacy per-block "
    "format; clamped to >= 1 MB otherwise.")
CKPT_INCREMENTAL = EnvVar(
    "DLROVER_TPU_CKPT_INCREMENTAL", bool, True,
    "Content-hash incremental stripes: a stripe whose crc is unchanged "
    "since the previous committed step is recorded as a reference to "
    "that step's bin instead of rewritten.")
COPY_THREADS = EnvVar(
    "DLROVER_TPU_COPY_THREADS", int, 8,
    "Worker threads in the fastcopy pool (checksum + read pipeline).")
