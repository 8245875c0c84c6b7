"""Optimizers of the port.

- ``adamw``: the counterpart of ``optax.adamw``, an unbound optimizer (a
  factory taking the parameters) with optax's defaults spelled out,
  since ``torch.optim.AdamW``'s differ (weight_decay 1e-2 there, 1e-4 in
  optax); it decays every parameter, as optax does;
- ``adam8bit``: the 8-bit blockwise Adam of ``dlrover_tpu/optim/low_bit.py``
  on two CUDA kernels (``optim/low_bit.py``); it binds to named
  parameters and updates them in one fused pass;
- ``agd``: AGD (``optim/agd.py``), a ``torch.optim.Optimizer`` factory;
- ``WeightedSAM``: two-pass sharpness-aware minimization around any of
  them, with its own ``step`` (``optim/wsam.py``);
- ``bf16_master_weights``: fp32 master weights around an inner optimizer
  (``optim/bf16.py``);
- ``offload``: the inner optimizer's big state leaves in host memory
  between steps (``optim/offload.py``; what
  ``auto_accelerate(offload_optimizer=True)`` wraps).
"""

import functools

import torch

from dlrover_tpu_torch.optim.agd import agd  # noqa: F401
from dlrover_tpu_torch.optim.bf16 import bf16_master_weights  # noqa: F401
from dlrover_tpu_torch.optim.low_bit import adam8bit  # noqa: F401
from dlrover_tpu_torch.optim.offload import offload  # noqa: F401
from dlrover_tpu_torch.optim.wsam import WeightedSAM  # noqa: F401


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``params -> torch.optim.AdamW`` with optax's ``adamw`` defaults."""
    return functools.partial(
        torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
        weight_decay=weight_decay,
    )


__all__ = ["WeightedSAM", "adam8bit", "adamw", "agd", "bf16_master_weights",
           "offload"]
