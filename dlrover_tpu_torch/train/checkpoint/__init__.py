"""Flash checkpoint of the port — counterpart of
``dlrover_tpu/train/checkpoint/``: the train state is staged from the
card into a host shared-memory segment every step without stalling the
step, persisted to storage in the JAX package's format, and restored
memory first, disk second."""

from dlrover_tpu_torch.train.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    FlashCheckpointer,
    ShardedCheckpointer,
    StorageType,
)
from dlrover_tpu_torch.train.checkpoint.engine import (  # noqa: F401
    CheckpointEngine,
)
