"""Optimizers of the port.

``adamw`` is the counterpart of ``optax.adamw``: an unbound optimizer (a
factory taking the parameters) with optax's defaults spelled out, since
``torch.optim.AdamW``'s differ (weight_decay 1e-2 there, 1e-4 in optax).
It decays every parameter, as optax does. ``adam8bit`` is the 8-bit
blockwise Adam of ``dlrover_tpu/optim/low_bit.py`` on two CUDA kernels
(``optim/low_bit.py``); it binds to named parameters and updates them
in one fused pass. ``agd``, ``wsam``, ``bf16_master_weights`` and
``offload`` come in later slices.
"""

import functools

import torch

from dlrover_tpu_torch.optim.low_bit import adam8bit  # noqa: F401


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``params -> torch.optim.AdamW`` with optax's ``adamw`` defaults."""
    return functools.partial(
        torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
        weight_decay=weight_decay,
    )


__all__ = ["adam8bit", "adamw"]
