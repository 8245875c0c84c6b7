"""Acceleration layer of the port (counterpart of ``dlrover_tpu/accel``):
``auto_accelerate`` on one device, or on a ``DeviceMesh`` of ``data``
(gradient averaging, and ZeRO-1's optimizer slices, ``accel/zero.py``),
``fsdp`` (FSDP2), ``pipe`` (pipeline stages on ranks,
``accel/pipeline.py``), ``tensor`` (DTensor tensor parallelism),
``seq`` (ring / Ulysses attention) and ``expert`` (the MoE stacks
sharded by expert) axes over several processes; ``spec="auto"`` chooses
the spec by the strategy search (``accel/search.py``)."""

from dlrover_tpu_torch.accel.accelerate import (  # noqa: F401
    AccelerateResult,
    ParallelSpec,
    accelerate_on_mesh,
    auto_accelerate,
    make_train_step,
)
from dlrover_tpu_torch.accel.mesh import (  # noqa: F401
    AXIS_ORDER,
    MeshConfig,
    create_mesh,
)
