"""Carry GPT weights and 8-bit Adam state between the JAX package and the port.

The JAX model's params are a tree of arrays (numpy here): ``wte/
embedding``, ``wpe``, ``ln_f/{scale,bias}`` and, per block, ``ln1``,
``qkv``, ``proj``, ``ln2``, ``up``, ``down`` — stacked along a leading
layer axis under ``blocks`` when the layers are ``nn.scan``-ned, or one
subtree ``block_<i>`` each when they are not. The port's ``state_dict``
has one ``blocks.<i>`` per layer. Dense kernels keep flax's ``[in, out]``
layout on both sides (the port multiplies ``x @ kernel``), and flax's
LayerNorm ``scale`` is the port's ``weight``. Both directions copy the
values bit for bit, bf16 included (through a 16-bit integer view).

``jax_leaves`` groups the port's named parameters into the JAX tree's
leaves; the port's ``adam8bit`` keeps its state per JAX leaf, so that
state converts across with ``adam8bit_state_from_flax`` /
``adam8bit_state_to_flax``.

``train_state_leaves`` lays the port's whole train state (``{"params",
"opt", "step"}``) out as the JAX train state's flattened leaves, keyed
by the exact ``jax.tree_util.keystr`` strings and in JAX's order; each
leaf lists the port's tensors whose bytes, one after another, are the
JAX leaf's. The flash checkpoint writes and restores through it, so a
checkpoint of either package restores into the other.
"""

import re
from typing import (
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    NamedTuple,
    Optional,
    Tuple,
)

import numpy as np
import torch

from dlrover_tpu_torch.optim.low_bit import (
    Adam8bitOptimizer,
    Adam8bitState,
    QTensor,
)

_DENSE = ("qkv", "proj", "up", "down")
_NORMS = ("ln1", "ln2")
_BLOCK_PARAM = re.compile(r"blocks\.(\d+)\.(\w+)\.(\w+)$")
# Port name <-> JAX leaf path, outside the blocks.
_TOP = {"wte.weight": "wte/embedding", "wpe": "wpe",
        "ln_f.weight": "ln_f/scale", "ln_f.bias": "ln_f/bias"}
_TOP_NAME = {path: name for name, path in _TOP.items()}
# (module, port leaf) <-> JAX leaf, inside a block.
_BLOCK_LEAF = {
    **{(m, "weight"): "scale" for m in _NORMS},
    **{(m, "bias"): "bias" for m in _NORMS + _DENSE},
    **{(m, "kernel"): "kernel" for m in _DENSE},
}
_PORT_LEAF = {(m, leaf): port for (m, port), leaf in _BLOCK_LEAF.items()}


def _tensor(v) -> torch.Tensor:
    arr = np.array(v, copy=True)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no torch twin
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy knows "bfloat16" once JAX has loaded its dtype package;
        # the port itself never needs it.
        return t.view(torch.int16).numpy().copy().view(np.dtype("bfloat16"))
    return t.numpy().copy()


def _flat(tree: Mapping, prefix: str = ""):
    """(``/``-joined path, leaf) of a nested dict; a leaf is anything
    that is not a mapping (an array, or a ``_QTensor``)."""
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _flat(sub, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", sub


def _nest(flat: Mapping[str, object]) -> Dict:
    """Inverse of ``_flat``."""
    tree: Dict = {}
    for path, leaf in flat.items():
        *parents, key = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[key] = leaf
    return tree


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX GPT params (a tree of arrays, or of anything shaped like them,
    such as gradients) -> the port's ``state_dict``."""
    out = {}
    for path, value in _flat(tree):
        if path in _TOP_NAME:
            out[_TOP_NAME[path]] = _tensor(value)
            continue
        prefix, module, leaf = path.split("/")
        port = _PORT_LEAF[module, leaf]
        if prefix == "blocks":
            for i, layer in enumerate(np.asarray(value)):
                out[f"blocks.{i}.{module}.{port}"] = _tensor(layer)
        else:
            i = int(prefix[len("block_"):])
            out[f"blocks.{i}.{module}.{port}"] = _tensor(value)
    return out


def flax_from_params(state_dict: Mapping[str, torch.Tensor],
                     stacked: bool = True) -> Dict:
    """The port's ``state_dict`` -> JAX GPT params as numpy arrays:
    stacked under ``blocks`` (``scan_layers=True``) or one ``block_<i>``
    per layer."""
    leaves = jax_leaves(((n, tuple(v.shape)) for n, v in state_dict.items()),
                        stacked=stacked)
    flat = {}
    for path, leaf in leaves.items():
        arrays = [_array(state_dict[n]) for n in leaf.names]
        flat[path] = (np.stack(arrays) if path.startswith("blocks/")
                      else arrays[0])
    return _nest(flat)


# ----------------------------------------------------- JAX leaf grouping


class JaxLeaf(NamedTuple):
    """One leaf of the JAX params tree: its parameters in the port, in
    layer order (one, or one per layer of a stacked leaf), and its shape
    in the JAX tree."""

    names: Tuple[str, ...]
    shape: Tuple[int, ...]


def _jax_path(name: str, stacked: bool) -> Tuple[str, int]:
    """(JAX leaf path, layer index or -1) of a port parameter name; a
    name the GPT does not have is its own leaf, under its own name."""
    if name in _TOP:
        return _TOP[name], -1
    hit = _BLOCK_PARAM.match(name)
    if hit and (hit.group(2), hit.group(3)) in _BLOCK_LEAF:
        i, module = int(hit.group(1)), hit.group(2)
        leaf = _BLOCK_LEAF[module, hit.group(3)]
        prefix = "blocks" if stacked else f"block_{i}"
        return f"{prefix}/{module}/{leaf}", (i if stacked else -1)
    return name, -1


def jax_leaves(named_shapes: Iterable[Tuple[str, Tuple[int, ...]]],
               stacked: bool = True) -> Dict[str, JaxLeaf]:
    """Group the port's parameters (name, shape) into the leaves of the
    JAX GPT's params tree, keyed by the leaf's ``/``-joined path:
    ``blocks/qkv/kernel`` holds every layer's ``qkv.kernel`` with shape
    ``[L, in, out]`` when ``stacked`` (``scan_layers=True``), and each
    ``block_<i>/qkv/kernel`` holds one layer's otherwise."""
    members: Dict[str, List[Tuple[int, str, Tuple[int, ...]]]] = {}
    for name, shape in named_shapes:
        path, layer = _jax_path(name, stacked)
        members.setdefault(path, []).append((layer, name, tuple(shape)))
    out = {}
    for path, group in members.items():
        group.sort()
        shape = group[0][2]
        if any(s != shape for _, _, s in group):
            raise ValueError(f"layers of {path} differ in shape")
        if path.startswith("blocks/"):
            if [layer for layer, _, _ in group] != list(range(len(group))):
                raise ValueError(f"{path} misses a layer")
            shape = (len(group),) + shape
        out[path] = JaxLeaf(tuple(n for _, n, _ in group), shape)
    return out


# ----------------------------------------------------- 8-bit Adam state


def adam8bit_state_from_flax(state) -> Adam8bitState:
    """The JAX package's ``Adam8bitState(step, m, v)``, whose ``m`` and
    ``v`` mirror the params tree with ``_QTensor(q, scale)`` leaves
    (numpy or JAX arrays) -> the port's state, keyed by leaf path. Bit
    for bit; the tensors are on the CPU."""

    def moments(tree):
        return {path: QTensor(_tensor(qt.q), _tensor(qt.scale))
                for path, qt in _flat(tree)}

    return Adam8bitState(
        step=torch.from_numpy(np.array(state.step, dtype=np.int32)),
        m=moments(state.m), v=moments(state.v),
    )


def adam8bit_state_to_flax(state: Adam8bitState) -> Adam8bitState:
    """The port's state -> the JAX layout as numpy: the same named tuples
    with ``m`` and ``v`` nested by leaf path, so its leaves line up one
    to one, in order, with those of the JAX package's state."""

    def moments(flat):
        return _nest({path: QTensor(_array(qt.q), _array(qt.scale))
                      for path, qt in flat.items()})

    return Adam8bitState(step=_array(state.step), m=moments(state.m),
                         v=moments(state.v))


# ----------------------------------------------------- the train state


class StateLeaf(NamedTuple):
    """One leaf of the JAX train state in the port: its ``keystr`` path,
    JAX shape and dtype, and the port's tensors that hold it, in layer
    order (one, or one per layer of a stacked leaf). A host scalar (the
    loop's ``step``, AdamW's ``count``) has no tensor: ``value`` is its
    int32 value and ``assign`` sets it."""

    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    members: Tuple[torch.Tensor, ...] = ()
    value: Optional[int] = None
    assign: Optional[Callable[[int], None]] = None


def keystr(prefix: str, path: str) -> str:
    """``jax.tree_util.keystr`` of a ``/``-joined dict path under
    ``prefix``: ``keystr("['params']", "blocks/qkv/kernel")`` is
    ``['params']['blocks']['qkv']['kernel']``."""
    return prefix + "".join(f"[{key!r}]" for key in path.split("/"))


def _in_jax_order(paths: Iterable[str]) -> List[str]:
    """JAX flattens a dict in sorted key order, level by level."""
    return sorted(paths, key=lambda p: p.split("/"))


def _plain_adam(opt) -> bool:
    """A torch ``Adam``/``AdamW`` whose state is optax's ``count``, ``mu``
    and ``nu``: no amsgrad, and the step kept on the host (not
    capturable, not fused)."""
    return isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)) and not any(
        g.get("amsgrad") or g.get("capturable") or g.get("fused")
        for g in opt.param_groups)


def materialize_adam_state(opt):
    """Give every parameter of a plain torch ``Adam``/``AdamW`` the state
    its first ``step()`` would build (``step`` 0 on the host, zero
    ``exp_avg``/``exp_avg_sq``), so the state has its layout from step
    0; ``step()`` then finds it and builds nothing. Parameters that have
    state keep it; any other optimizer is left alone."""
    if not _plain_adam(opt):
        return
    step_dtype = (torch.float64 if torch.get_default_dtype() == torch.float64
                  else torch.float32)
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state[p]
            if not state:
                state["step"] = torch.tensor(0.0, dtype=step_dtype)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def _adam_count(opt: torch.optim.Optimizer, names) -> int:
    """optax's one ``count`` from torch's step a parameter, which agree."""
    steps = {float(opt.state[p]["step"]) for p in names.values()}
    if len(steps) != 1:
        raise ValueError(f"Adam's parameters are at different steps {steps}")
    return int(steps.pop())


def _set_adam_count(opt: torch.optim.Optimizer, count: int):
    for state in opt.state.values():
        state["step"].fill_(float(count))


def train_state_leaves(state, stacked: bool = True,
                       groups: Optional[Dict[str, JaxLeaf]] = None
                       ) -> List[StateLeaf]:
    """The port's train state as the JAX train state's leaves, in the
    order ``jax.tree_util.tree_flatten_with_path`` gives them:
    ``['opt']...`` (optax ``adamw``: ``['opt'][0].count``, ``.mu[...]``,
    ``.nu[...]``; ``adam8bit``: ``['opt'].step`` and ``.m[...]``/
    ``.v[...]`` with ``.q`` and ``.scale``), ``['params'][...]``, then
    ``['step']``. A stacked leaf lists its layers' tensors; nothing is
    copied. Torch ``Adam``/``AdamW`` state is materialized first
    (``materialize_adam_state``). ``groups``: ``jax_leaves`` of the
    params, when the caller keeps it."""
    params, opt = state["params"], state["opt"]
    if groups is None:
        groups = jax_leaves(((n, tuple(p.shape)) for n, p in params.items()),
                            stacked=stacked)
    order = _in_jax_order(groups)
    leaves: List[StateLeaf] = []
    if isinstance(opt, Adam8bitOptimizer):
        st = opt.state
        leaves.append(StateLeaf("['opt'].step", (), st.step.dtype,
                                (st.step,)))
        for moment in ("m", "v"):
            tree = getattr(st, moment)
            for path in _in_jax_order(tree):
                for field in ("q", "scale"):
                    t = getattr(tree[path], field)
                    leaves.append(StateLeaf(
                        keystr(f"['opt'].{moment}", path) + f".{field}",
                        tuple(t.shape), t.dtype, (t,)))
    elif _plain_adam(opt):
        materialize_adam_state(opt)
        leaves.append(StateLeaf(
            "['opt'][0].count", (), torch.int32,
            value=_adam_count(opt, params),
            assign=lambda v: _set_adam_count(opt, v)))
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            for path in order:
                members = tuple(opt.state[params[n]][key]
                                for n in groups[path].names)
                leaves.append(StateLeaf(
                    keystr(f"['opt'][0].{moment}", path), groups[path].shape,
                    members[0].dtype, members))
    else:
        raise TypeError(
            f"no JAX train-state layout for optimizer {type(opt).__name__}; "
            "the port lays out adam8bit and torch Adam/AdamW without "
            "amsgrad, capturable or fused")
    for path in order:
        members = tuple(params[n] for n in groups[path].names)
        leaves.append(StateLeaf(keystr("['params']", path),
                                groups[path].shape, members[0].dtype,
                                members))

    def set_step(v: int):
        state["step"] = int(v)

    leaves.append(StateLeaf("['step']", (), torch.int32,
                            value=int(state["step"]), assign=set_step))
    return leaves


def leaf_bytes(leaf: StateLeaf) -> torch.Tensor:
    """A leaf's bytes as the JAX leaf holds them (its members' bytes one
    after another; a host scalar as int32), as uint8 on the members'
    device."""
    if not leaf.members:
        return torch.tensor([leaf.value], dtype=torch.int32).view(torch.uint8)
    return torch.cat([m.detach().reshape(-1).view(torch.uint8)
                      for m in leaf.members])
