"""The env knobs the port reads — its own copy of the part of
``dlrover_tpu/common/env_utils.py`` that the ported modules use.

Names, types and defaults are the JAX package's, so one launch
environment configures both packages. Reads go to ``os.environ`` at call
time, not import time.
"""

import os

_TRUTHY = ("1", "true", "yes", "on")


class EnvVar:
    """One declared variable; ``get()`` returns the typed value or the
    declared default when it is unset or does not parse."""

    __slots__ = ("name", "kind", "default", "doc")

    def __init__(self, name: str, kind: type, default, doc: str):
        self.name = name
        self.kind = kind
        self.default = default
        self.doc = doc

    def get(self):
        raw = os.environ.get(self.name)
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
    "DLROVER_TPU_PROCESS_ID", int, 0, "This worker's global rank.")
NUM_PROCESSES = EnvVar(
    "DLROVER_TPU_NUM_PROCESSES", int, 1, "Total process count (world).")
LOCAL_RANK = EnvVar(
    "DLROVER_TPU_LOCAL_RANK", int, 0, "Worker index on this host.")
SPAWN_TS = EnvVar(
    "DLROVER_TPU_SPAWN_TS", float, 0.0,
    "time.time() stamped by the agent at worker spawn.")
STRAGGLER_PHASES = EnvVar(
    "DLROVER_TPU_STRAGGLER_PHASES", bool, True,
    "Keep the trainer's per-step phase breakdown.")
CHAOS = EnvVar(
    "DLROVER_TPU_CHAOS", str, "",
    "Fault plan; unset = chaos off. The port has no chaos sites yet.")
