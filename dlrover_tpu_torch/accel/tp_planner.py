"""Tensor-parallel placement for a plain ``nn.Module`` — counterpart of
``dlrover_tpu/accel/tp_planner.py``.

The JAX package intercepts every projection of one abstract trace and
classifies it from the widths and the dataflow it recorded; the port
records the same from one forward with hooks on every ``nn.Linear``
(a module that owns a weight of its own, so norms are never planned):
its scope (the dotted path without its own name), in and out widths,
call order and the identity of its input tensor, every input kept
alive until the forward ends so that an id is never reused. The
classification is JAX's, per scope:

- projections that share one input form column-parallel branch groups:
  two or more squares (MHA's q/k/v), and twin contractions of one out
  width (GQA's k/v, out = kv_heads x head_dim < d_model) with their lone
  square sibling (GQA's q); a singleton contraction beside another
  projection (a d -> 1 value head beside the LM head) is left to the
  width rule;
- expansions (out > in) are column-parallel, contractions (in > out)
  row-parallel;
- a square after a column-parallel projection of its scope is their
  row-parallel closer (attention's output projection).

The result is a ``ShardingRegistry`` of rules in the torch weight's
order (``[out, in]``): a column-parallel weight ``(out axis, "embed")``
and its bias ``(out axis,)``, where the out axis is ``vocab`` for a
top-level head whose out width is ``vocab_size`` and ``mlp`` otherwise;
a row-parallel weight ``("embed", "mlp")`` and its bias ``(None,)``.
``registry.roles`` maps each planned module's name to ``"col"`` or
``"row"``. What no rule names falls to the registry's defaults.
"""

import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from dlrover_tpu_torch.accel.registry import ShardingRegistry
from dlrover_tpu_torch.common.log import logger


@dataclass
class _ProjRecord:
    path: Tuple[str, ...]
    in_features: int
    out_features: int
    input_id: int
    order: int
    role: Optional[str] = None  # "col" | "row" | None


def _trace_projections(module: nn.Module, *example_args
                       ) -> List[_ProjRecord]:
    """One forward of ``module`` on ``example_args`` without gradients (in
    eval mode), a record for every ``nn.Linear`` call on an input of two
    or more dims."""
    records: List[_ProjRecord] = []
    # Inputs stay alive until the forward ends, so ``id(x)`` is not
    # reused by a later tensor (two inputs on one id would make a false
    # sibling group).
    live_inputs: List[Any] = []

    def hook(name):
        def record(mod, args, out):
            x = args[0] if args else None
            if (isinstance(x, torch.Tensor) and isinstance(out, torch.Tensor)
                    and x.dim() >= 2 and out.dim() >= 2
                    and x.shape[:-1] == out.shape[:-1]):
                live_inputs.append(x)
                records.append(_ProjRecord(
                    path=tuple(name.split(".")),
                    in_features=int(x.shape[-1]),
                    out_features=int(out.shape[-1]),
                    input_id=id(x), order=len(records)))
        return record

    handles = [m.register_forward_hook(hook(name))
               for name, m in module.named_modules()
               if isinstance(m, nn.Linear) and name]
    # In eval mode: the forward changes no buffer (a norm's running
    # statistics) and draws no dropout mask.
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        with torch.no_grad():
            module(*example_args)
    finally:
        for h in handles:
            h.remove()
        for m, mode in modes:
            m.training = mode
    del live_inputs
    return records


def _classify(records: List[_ProjRecord]) -> List[_ProjRecord]:
    """Assign col/row roles per scope (see the module's docstring)."""
    by_scope: Dict[Tuple, List[_ProjRecord]] = defaultdict(list)
    for r in records:
        by_scope[r.path[:-1]].append(r)
    for rs in by_scope.values():
        rs.sort(key=lambda r: r.order)
        by_input: Dict[int, List[_ProjRecord]] = defaultdict(list)
        for r in rs:
            by_input[r.input_id].append(r)
        for group in by_input.values():
            if len(group) < 2:
                continue
            squares = [g for g in group if g.in_features == g.out_features]
            contractions = [g for g in group
                            if g.out_features < g.in_features]
            widths: Dict[int, int] = defaultdict(int)
            for g in contractions:
                widths[g.out_features] += 1
            twins = [g for g in contractions if widths[g.out_features] >= 2]
            if len(squares) >= 2:
                for g in squares:
                    g.role = "col"
            if twins:
                for g in twins:
                    g.role = "col"
                if len(squares) == 1:
                    squares[0].role = "col"
        for r in rs:
            if r.role is not None:
                continue
            if r.out_features > r.in_features:
                r.role = "col"
            elif r.in_features > r.out_features:
                r.role = "row"
        # A still-unclassified square after a column projection of its
        # scope is their row-parallel closer.
        for r in rs:
            if r.role is None and r.in_features == r.out_features:
                if any(p.role == "col" and p.order < r.order for p in rs):
                    r.role = "row"
    return records


def plan_tp(module: nn.Module, *example_args,
            vocab_size: Optional[int] = None,
            base: Optional[ShardingRegistry] = None) -> ShardingRegistry:
    """A registry with the tensor-parallel placement of ``module``'s
    projections from one forward on ``example_args`` (the rules of
    ``base`` first, when given)."""
    records = _classify(_trace_projections(module, *example_args))
    reg = ShardingRegistry()
    if base is not None:
        reg._rules.extend(base._rules)
    n_col = n_row = 0
    for r in records:
        path = ".".join(r.path)
        escaped = re.escape(path)
        if r.role == "col":
            # vocab sharding only for top-level heads: a block-internal
            # expansion that merely equals the vocab width is mlp.
            out_ax = ("vocab" if vocab_size and r.out_features == vocab_size
                      and len(r.path) == 1 else "mlp")
            reg.register(rf"^{escaped}\.weight$", (out_ax, "embed"))
            reg.register(rf"^{escaped}\.bias$", (out_ax,))
            n_col += 1
        elif r.role == "row":
            reg.register(rf"^{escaped}\.weight$", ("embed", "mlp"))
            reg.register(rf"^{escaped}\.bias$", (None,))
            n_row += 1
        if r.role is not None:
            reg.roles[path] = r.role
    logger.info("tp planner: %d column + %d row shards over %d projections",
                n_col, n_row, len(records))
    return reg
