"""Activation checkpointing (remat) of a model's blocks — counterpart of
``_remat_policy`` in ``dlrover_tpu/models/gpt.py``, shared by GPT and
LLaMA as there.

With ``cfg.remat`` each block runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: its
forward keeps what the policy saves, and the backward recomputes the
rest from the block's input.

- ``"nothing"``: saves only the block input (least memory);
- ``"dots"``: saves the output of every matrix product (the aten
  ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` family, through
  ``create_selective_checkpoint_contexts``) and recomputes the
  elementwise work, as ``jax.checkpoint_policies.checkpoint_dots`` does;
- ``"dots_lite"``: saves only the tensors a block names ``attn_out`` and
  ``ffn_act`` with ``checkpoint_name``, as
  ``save_only_these_names("attn_out", "ffn_act")`` does;
- ``"offload"`` (activations to host memory) is a later slice and raises.

The flash-attention kernels are ctypes launches inside an
``autograd.Function``, not aten ops, so no policy can save their output:
their forward runs again in the backward under every policy, as the
JAX package recomputes a ``pallas_call`` (it is not a ``dot_general``).
A step launches the forward kernel twice a layer.
"""

import contextvars
import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

POLICIES = ("nothing", "dots", "dots_lite", "offload")

_aten = torch.ops.aten
#: The matrix products whose outputs "dots" saves.
DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
        _aten.baddbmm.default)

# True while a block runs (or is recomputed) under "dots_lite": only
# then does ``checkpoint_name`` put its tensor through the op the policy
# saves; otherwise it returns the tensor itself and costs nothing.
_NAMING = contextvars.ContextVar("dlrover_tpu_torch_remat_naming",
                                 default=False)


@torch.library.custom_op("dlrover_tpu_torch::checkpoint_name",
                         mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    # An op's output may not alias its input, so the name costs one copy.
    return x.clone()


@_named.register_fake
def _named_fake(x, name):
    return torch.empty_like(x)


def _named_backward(ctx, grad):
    return grad, None


_named.register_autograd(_named_backward)
#: The op "dots_lite" saves.
NAMED = (torch.ops.dlrover_tpu_torch.checkpoint_name.default,)


def _saving(ops):
    """The selective-checkpoint policy that saves the outputs of ``ops``
    and recomputes everything else."""
    saved = frozenset(ops)

    def policy(ctx, op, *args, **kwargs):
        if op in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


_SAVE_DOTS = _saving(DOTS)
_SAVE_NAMED = _saving(NAMED)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: marks ``x`` as the tensor
    ``name`` for the "dots_lite" policy; the identity elsewhere."""
    return _named(x, name) if _NAMING.get() else x


def check_policy(cfg):
    """Raises on a remat policy the port cannot run (duck-typed on
    ``remat`` and ``remat_policy``, as the JAX package is)."""
    if not cfg.remat:
        return
    if cfg.remat_policy == "offload":
        raise NotImplementedError(
            'remat_policy="offload" (activations to host memory) comes '
            "with its own slice of the port (ROADMAP queue 1)"
        )
    if cfg.remat_policy not in POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def _run_naming(block, x):
    token = _NAMING.set(True)
    try:
        return block(x)
    finally:
        _NAMING.reset(token)


def run_block(block, x, cfg):
    """``block(x)``, under ``cfg``'s remat policy when ``cfg.remat`` and
    autograd records the call (without gradients there is nothing to
    save, and the block runs as it is)."""
    if not cfg.remat or not torch.is_grad_enabled():
        return block(x)
    policy = cfg.remat_policy
    fn, context_fn = block, None
    if policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _SAVE_DOTS)
    elif policy == "dots_lite":
        fn = functools.partial(_run_naming, block)
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _SAVE_NAMED)
    kwargs = {} if context_fn is None else {"context_fn": context_fn}
    # No block draws random numbers, so no RNG state is kept for the
    # recompute.
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False,
                      **kwargs)
