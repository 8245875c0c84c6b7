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
"""

import re
from typing import Dict, Iterable, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.optim.low_bit import Adam8bitState, QTensor

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
        import ml_dtypes  # numpy's bfloat16, as JAX arrays carry it

        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
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
