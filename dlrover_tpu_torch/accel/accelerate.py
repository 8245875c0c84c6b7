"""``auto_accelerate`` — train-step assembly for the port.

Counterpart of ``dlrover_tpu/accel/accelerate.py``. The JAX version
picks a ``ParallelSpec`` (mesh degrees), shards the state over a mesh
and jits one SPMD step. This slice of the port runs on one device: a
one-device spec (``ParallelSpec()``, or ``"auto"`` in a one-process
job) is accepted, and any larger degree raises until the DDP / FSDP2 /
TP slice lands. PyTorch runs eagerly, so the "step" is a plain function
over live modules: forward, backward, optimizer update.
"""

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.optim.base import bind
from dlrover_tpu_torch.optim.offload import OffloadOptimizer

# The JAX package's auto_accelerate arguments that come with the
# multi-device slice of the port (its mesh and strategy search).
_MULTI_DEVICE = ("devices", "profile", "profile_steps", "allow_tensor",
                 "registry", "search_top_k")


@dataclass(frozen=True)
class ParallelSpec:
    """Mesh degrees (the JAX package's Strategy object, same fields).
    ``zero`` flags ZeRO-1 optimizer-state sharding over ``data``;
    ``collectives`` maps an axis to its collective algorithm, which has
    a meaning only across devices (a later slice)."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1
    zero: bool = False
    collectives: tuple = ()

    def __post_init__(self):
        for name in ("data", "fsdp", "tensor", "seq", "expert", "pipe"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} degree must be >= 1")

    @property
    def total(self) -> int:
        return (self.data * self.fsdp * self.tensor * self.seq
                * self.expert * self.pipe)


@dataclass
class AccelerateResult:
    spec: ParallelSpec
    device: torch.device
    #: ``{"params": {name: Parameter}, "opt": Optimizer, "step": int}`` —
    #: live objects, updated in place by ``train_step``.
    state: Any
    train_step: Callable          # (state, batch) -> (state, metrics)
    module: nn.Module


def make_train_step(module: nn.Module, loss: Callable, grad_accum: int = 1):
    """The train step: ``step(state, batch) -> (state, {"loss": tensor})``.

    ``loss(module, params, batch) -> scalar``, where ``params`` is the
    module's live parameter dict (so ``module(batch)`` and
    ``torch.func.functional_call(module, params, batch)`` agree).
    ``grad_accum > 1`` splits the leading batch dim into that many
    microbatches, sums their gradients and divides by the count before
    one optimizer update, as the JAX step's scan does. An optimizer with
    ``update_and_apply(grads, params)`` updates the params in place in
    one pass (the fused 8-bit Adam's contract); any other gets
    ``step()``. The loss stays on the device: reading it syncs.
    """
    params = dict(module.named_parameters())

    def grads_of(batch):
        lv = loss(module, params, batch)
        lv.backward()
        return lv.detach()

    def step(state, batch):
        if grad_accum > 1:
            b = batch.shape[0]
            if b % grad_accum:
                raise ValueError(
                    f"batch {b} not divisible by grad_accum {grad_accum}"
                )
            micro = batch.reshape(grad_accum, b // grad_accum,
                                  *batch.shape[1:])
            loss_sum = torch.zeros((), device=batch.device)
            for mb in micro:
                loss_sum = loss_sum + grads_of(mb)  # .grad sums microbatches
            lv = loss_sum / grad_accum
            with torch.no_grad():
                for p in params.values():
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
        else:
            lv = grads_of(batch)
        opt = state["opt"]
        fused = getattr(opt, "update_and_apply", None)
        if fused is not None:
            live = [p for p in params.values() if p.grad is not None]
            with torch.no_grad():
                fused([p.grad for p in live], live)
        else:
            opt.step()
        for p in params.values():
            p.grad = None
        state["step"] += 1
        return state, {"loss": lv}

    return step


def _one_device_spec(spec: Any) -> ParallelSpec:
    if isinstance(spec, str):
        if spec != "auto":
            raise ValueError(f"spec must be a ParallelSpec or 'auto', got "
                             f"{spec!r}")
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            raise NotImplementedError(
                "auto_accelerate over several processes comes with the "
                "multi-device ParallelSpec slice (ROADMAP queue 1)"
            )
        return ParallelSpec()
    if not isinstance(spec, ParallelSpec):
        raise TypeError(f"spec must be a ParallelSpec or 'auto', got {spec!r}")
    if spec.total > 1 or spec.zero or spec.collectives:
        raise NotImplementedError(
            f"{spec} needs several devices; the DDP/FSDP2/TP slice of the "
            "port (ROADMAP queue 1) brings multi-device specs"
        )
    return spec


def auto_accelerate(
    module: nn.Module,
    optimizer,
    sample_batch,
    loss: Callable,
    spec: Any = "auto",
    device: DeviceLike = None,
    grad_accum: int = 1,
    offload_optimizer: bool = False,
    precision: str = "bf16",
    **later,
) -> AccelerateResult:
    """Place the model, bind the optimizer, build the train step.

    ``optimizer`` is unbound (a ``params -> torch.optim.Optimizer``
    factory such as ``dlrover_tpu_torch.optim.adamw(lr)``, the analog of
    an optax transformation) or an optimizer already bound to
    ``module``'s parameters (``optim.base.bind``). ``device`` defaults to
    this worker's card and raises without CUDA; the CPU runs only when
    named. ``offload_optimizer=True`` keeps the optimizer's big state
    leaves in host memory between steps (``optim/offload.py``).
    ``precision="int8"`` and the JAX package's other arguments
    (``devices``, ``profile``, ...) raise, naming the slice that brings
    them.
    """
    for name in later:
        if name not in _MULTI_DEVICE:
            # rng too: a port model is initialized where it is built.
            raise TypeError(f"auto_accelerate() got an unexpected keyword "
                            f"argument {name!r}")
        raise NotImplementedError(
            f"auto_accelerate({name}=...) comes with the multi-device "
            "ParallelSpec slice of the port (ROADMAP queue 1, item 2)")
    if precision == "int8":
        raise NotImplementedError(
            'precision="int8" comes with the int8 matmul slice of the port '
            "(ROADMAP queue 1, item 9)")
    if precision != "bf16":
        raise ValueError(f"precision must be 'bf16' or 'int8', got "
                         f"{precision!r}")
    dev = resolve_device(device)
    spec = _one_device_spec(spec)
    if sample_batch.shape[0] % grad_accum:
        raise ValueError(
            f"batch {sample_batch.shape[0]} not divisible by grad_accum "
            f"{grad_accum}"
        )
    module = module.to(dev)
    opt = bind(optimizer, module.named_parameters())
    if offload_optimizer:
        opt = OffloadOptimizer(opt, module.named_parameters())
    state = {"params": dict(module.named_parameters()), "opt": opt,
             "step": 0}
    logger.info("auto_accelerate: %.1fM params on %s, %s%s",
                sum(p.numel() for p in module.parameters()) / 1e6, dev, spec,
                ", optimizer state offloaded" if offload_optimizer else "")
    return AccelerateResult(
        spec=spec, device=dev, state=state,
        train_step=make_train_step(module, loss, grad_accum=grad_accum),
        module=module,
    )
