"""Trainer-side data layer of the port."""

from dlrover_tpu_torch.train.data.device_prefetch import (  # noqa: F401
    DevicePrefetchIterator,
)
