"""Kernels of the port: hand-written Hopper CUDA beside plain PyTorch.

Counterpart of ``dlrover_tpu/ops``. Ported so far: flash attention
(forward, dQ, dK/dV), ring and Ulysses attention (``ring_attention``,
``ulysses``) and the mixture of experts (``moe``). The int8 matmuls come
in a later slice.
"""

from dlrover_tpu_torch.ops.attention import (  # noqa: F401
    LAUNCHES,
    FlashAttentionFunction,
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
    reference_attention,
    reset_launch_counts,
)

__all__ = [
    "LAUNCHES",
    "FlashAttentionFunction",
    "flash_attention",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_fwd",
    "reference_attention",
    "reset_launch_counts",
]
