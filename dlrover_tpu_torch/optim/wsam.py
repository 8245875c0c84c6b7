"""WeightedSAM — the port of ``dlrover_tpu/optim/wsam.py``: two-pass
sharpness-aware minimization with a ``gamma``-weighted sharpness term
(KDD'23), decoupled or folded into the gradient.

Usage::

    wsam = WeightedSAM(adamw(1e-3), rho=0.05, gamma=0.9)
    wsam.init(model.named_parameters())
    loss = wsam.step(lambda: loss_fn(model(batch), batch))

As in the JAX package it runs through its own ``step``, not through
``auto_accelerate``. The arithmetic follows JAX's ``step`` op for op:
the perturbation is taken at ``p + e(p)`` and the base update from the
unperturbed ``p`` (the params are restored from a copy, not by
subtracting ``e``).
"""

from typing import Callable, Dict, List

import numpy as np
import torch

from dlrover_tpu_torch.optim.base import apply_grads, bind


def _global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: sqrt of the sum of each leaf's sum of
    squares."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class WeightedSAM:
    """Two-pass sharpness-aware wrapper around an unbound optimizer."""

    def __init__(self, base, rho: float = 0.05, gamma: float = 0.9,
                 sam_eps: float = 1e-12, adaptive: bool = False,
                 decouple: bool = True, sharpness_lr=1e-3):
        """``sharpness_lr`` scales the decoupled sharpness step: a float,
        or a schedule ``step -> lr`` (pass the base optimizer's)."""
        if rho < 0:
            raise ValueError(f"invalid rho {rho}")
        self._base = base
        self.rho = rho
        self.alpha = gamma / (1 - gamma)
        self.sam_eps = sam_eps
        self.adaptive = adaptive
        self.decouple = decouple
        self._sharpness_lr = sharpness_lr
        self.params: Dict[str, torch.Tensor] = {}
        self.opt = None
        self.count = 0  # updates so far (drives a sharpness-lr schedule)

    def init(self, named_parameters) -> "WeightedSAM":
        """Binds the base optimizer to ``named_parameters``."""
        self.params = dict(named_parameters)
        self.opt = bind(self._base, self.params.items())
        self.count = 0
        return self

    def _grads(self, loss_fn, params):
        with torch.enable_grad():
            loss = loss_fn()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for g, p in zip(grads, params)]

    def step(self, loss_fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """One WSAM update of the live params: ascend to ``w + e(w)``,
        take the gradient there, and descend with the weighted
        combination. ``loss_fn()`` computes the loss from the live
        params; returns the first pass's loss."""
        if self.opt is None:
            raise RuntimeError("WeightedSAM.init(named_parameters) first")
        params = list(self.params.values())
        loss, g = self._grads(loss_fn, params)
        with torch.no_grad():
            norm_of = ([gr * torch.abs(p) for gr, p in zip(g, params)]
                       if self.adaptive else g)
            scale = self.rho / (_global_norm(norm_of) + self.sam_eps)
            saved = [p.detach().clone() for p in params]
            for p, gr in zip(params, g):
                p.add_(p * p * gr * scale if self.adaptive else gr * scale)
        _, g_sharp = self._grads(loss_fn, params)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
            del saved
            if self.decouple:
                base_grad = g
            else:
                base_grad = [self.alpha * gs + (1 - self.alpha) * gr
                             for gs, gr in zip(g_sharp, g)]
            apply_grads(self.opt, params, base_grad)
            if self.decouple:
                lr = (self._sharpness_lr(self.count)
                      if callable(self._sharpness_lr) else self._sharpness_lr)
                # JAX: lr (f32) * alpha, then times (g_sharp - g).
                c = float(np.float32(lr) * np.float32(self.alpha))
                for p, gs, gr in zip(params, g_sharp, g):
                    p.sub_((gs - gr) * c)
        self.count += 1
        return loss
