"""Optimizers of the port.

``adamw`` is the counterpart of ``optax.adamw``: an unbound optimizer (a
factory taking the parameters) with optax's defaults spelled out, since
``torch.optim.AdamW``'s differ (weight_decay 1e-2 there, 1e-4 in optax).
It decays every parameter, as optax does. The 8-bit Adam and the other
optimizers of ``dlrover_tpu/optim`` come in later slices.
"""

import functools

import torch


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``params -> torch.optim.AdamW`` with optax's ``adamw`` defaults."""
    return functools.partial(
        torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
        weight_decay=weight_decay,
    )
