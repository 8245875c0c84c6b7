"""Acceleration layer of the port (counterpart of ``dlrover_tpu/accel``).

One device in this slice; DDP, FSDP2 and tensor parallelism come with
the multi-device slice.
"""

from dlrover_tpu_torch.accel.accelerate import (  # noqa: F401
    AccelerateResult,
    ParallelSpec,
    auto_accelerate,
    make_train_step,
)
