"""Binding an optimizer to parameters, and one update from gradients —
shared by ``auto_accelerate`` and the wrapping optimizers
(``bf16_master_weights``, ``offload``, ``WeightedSAM``)."""

from typing import Iterable, Sequence, Tuple

import torch


def bind(optimizer, named_parameters: Iterable[Tuple[str, torch.Tensor]]):
    """``optimizer`` bound to ``named_parameters``: a factory whose
    ``takes_named_parameters`` is true (``adam8bit``,
    ``bf16_master_weights``, ``offload``; their state follows the JAX
    params tree by name) is given the names; any other factory
    (``adamw``, ``agd``) the tensors; an optimizer already bound (a
    ``torch.optim.Optimizer``, or one with ``update_and_apply``) is
    returned as it is. A torch Adam gets the state its first step would
    build, so the state has its layout from step 0."""
    # models.convert imports the optimizers' state types.
    from dlrover_tpu_torch.models.convert import materialize_adam_state

    named = list(named_parameters)
    opt = optimizer
    if getattr(optimizer, "takes_named_parameters", False):
        opt = optimizer(named)
    elif not isinstance(optimizer, torch.optim.Optimizer) and not hasattr(
            optimizer, "update_and_apply"):
        opt = optimizer([p for _, p in named])
    materialize_adam_state(opt)
    return opt


def apply_grads(opt, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor]):
    """One update of the bound ``opt`` from ``grads`` of ``params``: the
    fused ``update_and_apply`` where it has one, else ``.grad`` and
    ``step()`` (the grads are cleared after)."""
    fused = getattr(opt, "update_and_apply", None)
    if fused is not None:
        fused(list(grads), list(params))
        return
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None
