"""Classify reported process/node errors — the port's copy of
``dlrover_tpu/master/monitor/error_monitor.py``, with the CUDA
signatures of an out-of-memory or a failing card (an Xid, an ECC error,
a card off the bus) beside the TPU ones: a job of either package reports
to either master."""

import re
from typing import List, Tuple

from dlrover_tpu_torch.common.constants import NodeExitReason, TrainingExceptionLevel
from dlrover_tpu_torch.common.log import logger

# Word-boundary patterns so ordinary words ("bloom", "policies",
# "suspicious") never classify a benign traceback as node-fatal. DOTALL +
# generous windows so real multi-line XLA allocator messages (e.g.
# "Error allocating device buffer: Attempting to allocate 4.00G. That was
# not possible. ...; (0x0x0_HBM0)") still classify as OOM.
_OOM_RE = re.compile(
    r"out of memory|\boom\b|resource_exhausted"
    r"|attempting to allocate"
    r"|\bhbm_?\d*\b.{0,400}?(oom|exhaust|exceed|not possible)"
    r"|allocat\w*.{0,400}?(\bhbm_?\d*\b|device buffer|device memory)"
    r"|cuda_error_out_of_memory|cublas_status_alloc_failed",
    re.IGNORECASE | re.DOTALL,
)
_HARDWARE_RE = re.compile(
    r"tpu halted|device unavailable|\bdata loss\b|uncorrectable ecc"
    r"|\bici\b.{0,80}?(fail|error|timeout|down)"
    r"|deadline exceeded: failed to connect"
    r"|\bxid\b|ecc error|gpu has fallen off the bus"
    r"|cuda_error_ecc_uncorrectable",
    re.IGNORECASE | re.DOTALL,
)


class ErrorMonitor:
    def __init__(self):
        self._errors: List[Tuple[int, str, str]] = []

    def process_error(
        self, node_id: int, restart_count: int, error_data: str, level: str
    ) -> bool:
        """Record the error; return True when it is node-fatal (relaunch node)."""
        self._errors.append((node_id, level, error_data))
        reason = self.classify(error_data)
        logger.info(
            "node %s reported %s error (restart %s): %s -> %s",
            node_id, level, restart_count, error_data[:200], reason,
        )
        if level == TrainingExceptionLevel.NODE_ERROR:
            return True
        return reason in (NodeExitReason.OOM, NodeExitReason.HARDWARE_ERROR)

    @staticmethod
    def classify(error_data: str) -> str:
        if _OOM_RE.search(error_data):
            return NodeExitReason.OOM
        if _HARDWARE_RE.search(error_data):
            return NodeExitReason.HARDWARE_ERROR
        return NodeExitReason.FATAL_ERROR

    def errors(self):
        return list(self._errors)
