"""Sharding registry — logical axes for a plain ``nn.Module``'s parameters.

Counterpart of ``dlrover_tpu/accel/registry.py``. The JAX package names
the logical axes of a flax model that carries none of its own from its
parameters' paths and shapes; the port names them from a torch module's
dotted parameter names (``block_0.q_proj.weight``) and shapes, with the
same rules:

- ``register(pattern, axes)`` adds a rule: a parameter whose name the
  pattern matches (``re.search``; the first registered match wins) has
  ``axes``, left-padded with ``None`` when it has more dims (a stack of
  layers), and a rule of more axes than dims raises ``ValueError``;
- otherwise the defaults: an embedding-like table (an ``nn.Embedding``'s
  weight, or a name with ``embedding`` in it or ``embed`` in its last
  part) gets ``("vocab", "embed")``, a 1-D parameter ``(None,)``, and
  any other the ``embed`` axis (which the rules put on ``fsdp``) on its
  largest dim, ties going to the last dim of the flax leaf.

Axes come out in the torch tensor's own dim order. An ``nn.Linear``'s
``weight`` is ``[out, in]``, the transpose of flax's ``[in, out]``
kernel, so its defaults are JAX's on the flax shape, reversed: a square
kernel's ``embed`` lands on its out dim, which is torch's dim 0, as
JAX's tie rule puts it on flax's last. Registered axes are read in the
torch order too (``tp_planner.plan_tp`` registers them so).

A model ``has_annotations`` when it names its own axes
(``logical_axes()``, as the port's GPT and LLaMA do); ``auto_accelerate``
applies a registry (the planner's, the caller's, or ``default_registry``)
to any other model on a mesh.
"""

import re
from typing import Dict, List, Optional, Sequence, Tuple

from torch import nn

#: What ``axes_for`` is told a parameter is: an ``nn.Linear``'s weight
#: (the transpose of its flax kernel) or an ``nn.Embedding``'s.
LINEAR, EMBEDDING = "linear", "embedding"


def _default_axes(name: str, shape: Sequence[int],
                  kind: Optional[str] = None) -> Tuple:
    """JAX's shape and name heuristics (FSDP-ready out of the box), in the
    torch tensor's dim order."""
    shape = tuple(shape)
    if len(shape) == 0:
        return ()
    lowered = name.lower()
    if len(shape) >= 2 and (kind == EMBEDDING or "embedding" in lowered
                            or "embed" in lowered.rsplit(".", 1)[-1]):
        return ("vocab", "embed") + (None,) * (len(shape) - 2)
    if len(shape) == 1:
        return (None,)
    flax = shape[::-1] if kind == LINEAR else shape
    # Shard the largest dim (ties: the last) over the fsdp axis.
    largest = max(range(len(flax)), key=lambda i: (flax[i], i))
    axes = tuple("embed" if i == largest else None for i in range(len(flax)))
    return axes[::-1] if kind == LINEAR else axes


def param_kinds(module: nn.Module) -> Dict[str, Optional[str]]:
    """``{parameter name: LINEAR, EMBEDDING or None}`` of ``module``."""
    kinds: Dict[str, Optional[str]] = {}
    for mname, m in module.named_modules():
        kind = (LINEAR if isinstance(m, nn.Linear) else
                EMBEDDING if isinstance(m, nn.Embedding) else None)
        for leaf, _ in m.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            kinds[name] = kind if leaf == "weight" else None
    return kinds


class ShardingRegistry:
    def __init__(self):
        self._rules: List[Tuple[re.Pattern, Tuple]] = []
        #: ``tp_planner.plan_tp``'s role of each module it planned, by
        #: name: ``"col"`` or ``"row"``.
        self.roles: Dict[str, str] = {}

    def register(self, pattern: str, axes: Sequence):
        """Axes (torch dim order) of the parameters whose dotted name
        matches ``pattern`` (first registered match wins; the defaults
        otherwise)."""
        self._rules.append((re.compile(pattern), tuple(axes)))
        return self

    def axes_for(self, name: str, shape, kind: Optional[str] = None
                 ) -> Tuple:
        """The logical axes of the parameter ``name`` of ``shape`` (the
        torch tensor's), in its dim order; ``kind`` says it is an
        ``nn.Linear``'s or ``nn.Embedding``'s weight (``param_kinds``)."""
        for pat, axes in self._rules:
            if pat.search(name):
                if len(axes) < len(shape):
                    # Leading stacked dims left-pad as unsharded.
                    axes = (None,) * (len(shape) - len(axes)) + axes
                if len(axes) != len(shape):
                    raise ValueError(
                        f"registered axes {axes} rank-mismatch param "
                        f"{name} of shape {tuple(shape)}"
                    )
                return axes
        return _default_axes(name, shape, kind)

    def axes_of(self, module: nn.Module) -> Dict[str, Tuple]:
        """``{parameter name: logical axes}`` of every parameter of
        ``module``."""
        kinds = param_kinds(module)
        return {name: self.axes_for(name, tuple(p.shape), kinds[name])
                for name, p in module.named_parameters()}


default_registry = ShardingRegistry()


def has_annotations(module: nn.Module) -> bool:
    """Does the model name its parameters' logical axes itself?"""
    return hasattr(module, "logical_axes")
