"""bf16 training with fp32 master weights — the port of
``dlrover_tpu/optim/bf16.py``.

The wrapper owns fp32 masters of the parameters: the model keeps its
bf16 params, the gradients are cast to fp32, the inner optimizer
updates the masters, and each param given a gradient is then moved to
``bf16(master)`` as the JAX package's emitted update does
(``p + (bf16(master) - p)``, in the param's dtype), so updates below a
bf16 ulp accumulate in the masters instead of vanishing.

A master keeps its parameter's mesh layout (``accel.sharding``), so on
a pipe rank the masters are its stages' and the inner optimizer (the
8-bit Adam too) holds and steps those stages only.
"""

from typing import Sequence

import torch

from dlrover_tpu_torch.optim.base import apply_grads, bind


class Bf16MasterWeights:
    """``bf16_master_weights(inner)``, unbound; binding it to named
    parameters gives a ``Bf16MasterOptimizer``."""

    takes_named_parameters = True

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, named_parameters) -> "Bf16MasterOptimizer":
        return Bf16MasterOptimizer(self.inner, named_parameters)


class Bf16MasterOptimizer:
    """The bound wrapper: ``master`` (name -> fp32 tensor, the state the
    JAX package keeps as ``Bf16MasterState.master``) and ``inner``, the
    inner optimizer bound to the masters under the params' names."""

    def __init__(self, inner, named_parameters):
        self.params = dict(named_parameters)
        self._names = {id(p): n for n, p in self.params.items()}
        from dlrover_tpu_torch.accel import sharding

        with torch.no_grad():
            self.master = {n: p.detach().to(torch.float32, copy=True)
                           for n, p in self.params.items()}
        for n, p in self.params.items():
            if sharding.layout_of(p) is not None:
                sharding.set_layout(self.master[n], sharding.layout_of(p))
        self.inner = bind(inner, self.master.items())

    def update_and_apply(self, grads: Sequence[torch.Tensor],
                         params: Sequence[torch.Tensor]):
        names = [self._names[id(p)] for p in params]
        with torch.no_grad():
            apply_grads(self.inner, [self.master[n] for n in names],
                        [g.float() for g in grads])
            for n, p in zip(names, params):
                p.add_(self.master[n].to(p.dtype) - p)


def bf16_master_weights(inner) -> Bf16MasterWeights:
    """fp32 master weights around ``inner`` (an unbound optimizer:
    ``adamw``, ``adam8bit``, ``agd``, ...)."""
    return Bf16MasterWeights(inner)
