"""AGD — the port of ``dlrover_tpu/optim/agd.py`` (Yue et al., KDD'23),
as a ``torch.optim.Optimizer``.

- the first moment ``m`` as in Adam; the preconditioner ``v`` is an EMA
  of the squared difference of bias-corrected first moments between
  steps (step 1 uses the moment itself);
- the denominator is floored at ``delta * sqrt(bc2)``;
- the step is ``lr * sqrt(bc2) / bc1``; AMSGrad max-tracking, update
  clipping and (decoupled) weight decay as in JAX.

The scalars (bias corrections, the floor, the step size) are computed
in float32, as the JAX update computes them. The ``win`` variant is not
implemented there either. A parameter without a gradient is skipped.
"""

import functools
from typing import Optional

import numpy as np
import torch


class AGD(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 delta: float = 1e-5, weight_decay: float = 0.0,
                 weight_decouple: bool = True, fixed_decay: bool = False,
                 amsgrad: bool = False, clip: Optional[float] = None):
        if lr <= 0:
            raise ValueError(f"invalid learning rate {lr}")
        b1, b2 = betas
        if not 0 <= b1 < 1 or not 0 <= b2 < 1:
            raise ValueError(f"invalid betas ({b1}, {b2})")
        super().__init__(params, dict(
            lr=lr, betas=betas, delta=delta, weight_decay=weight_decay,
            weight_decouple=weight_decouple, fixed_decay=fixed_decay,
            amsgrad=amsgrad, clip=clip))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        f32 = np.float32
        for group in self.param_groups:
            lr, (b1, b2) = group["lr"], group["betas"]
            wd, decouple = group["weight_decay"], group["weight_decouple"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                    if group["amsgrad"]:
                        state["max_exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                stepf = f32(state["step"].item())
                bc1 = f32(1) - f32(b1) ** stepf
                bc1_old = f32(1) - f32(b1) ** (stepf - f32(1))
                bc2 = f32(1) - f32(b2) ** stepf
                g = p.grad
                if not decouple and wd:
                    g = g + wd * p
                m = state["exp_avg"]
                m_new = b1 * m + (1 - b1) * g
                if stepf == 1:
                    d = m_new / float(bc1)
                else:
                    d = m_new / float(bc1) - m / float(bc1_old or f32(1))
                v_new = b2 * state["exp_avg_sq"] + (1 - b2) * d * d
                den_src = v_new
                if group["amsgrad"]:
                    den_src = torch.maximum(state["max_exp_avg_sq"], v_new)
                    state["max_exp_avg_sq"].copy_(den_src)
                delta_adjust = float(f32(group["delta"]) * np.sqrt(bc2))
                lr_adjust = float(f32(lr) * np.sqrt(bc2) / bc1)
                u = m_new / torch.clamp(torch.sqrt(den_src), min=delta_adjust)
                if group["clip"] is not None:
                    u = torch.clamp(u, -group["clip"], group["clip"])
                out = -lr_adjust * u
                if decouple and wd:
                    decay = wd if group["fixed_decay"] else lr * wd
                    out = out - decay * p
                m.copy_(m_new)
                state["exp_avg_sq"].copy_(v_new)
                p.add_(out)
        return loss


def agd(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
        delta: float = 1e-5, weight_decay: float = 0.0,
        weight_decouple: bool = True, fixed_decay: bool = False,
        amsgrad: bool = False, clip: Optional[float] = None):
    """``params -> AGD`` with the JAX package's defaults (an unbound
    optimizer, as ``adamw`` is)."""
    if learning_rate <= 0:
        raise ValueError(f"invalid learning rate {learning_rate}")
    return functools.partial(
        AGD, lr=learning_rate, betas=(b1, b2), delta=delta,
        weight_decay=weight_decay, weight_decouple=weight_decouple,
        fixed_decay=fixed_decay, amsgrad=amsgrad, clip=clip)
