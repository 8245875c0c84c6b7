"""Acceleration layer of the port (counterpart of ``dlrover_tpu/accel``):
``auto_accelerate`` on one device, or on a ``DeviceMesh`` of ``data``
(gradient averaging, and ZeRO-1's optimizer slices, ``accel/zero.py``),
``fsdp`` (FSDP2), ``pipe`` (pipeline stages on ranks,
``accel/pipeline.py``), ``tensor`` (DTensor tensor parallelism),
``seq`` (ring / Ulysses attention) and ``expert`` (the MoE stacks
sharded by expert) axes over several processes, fsdp and tensor in one
spec; ``spec="auto"`` chooses the spec by the strategy search
(``accel/search.py``). A plain ``nn.Module`` is placed by a
``ShardingRegistry`` (``accel/registry.py``), the tensor-parallel
planner's (``accel/tp_planner.py``) or the default one."""

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
from dlrover_tpu_torch.accel.registry import (  # noqa: F401
    ShardingRegistry,
    default_registry,
)
from dlrover_tpu_torch.accel.tp_planner import plan_tp  # noqa: F401
