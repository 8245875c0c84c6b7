"""Carry GPT, LLaMA and plain-module weights and 8-bit Adam state between the JAX package and the port.

The JAX model's params are a tree of arrays (numpy here). Each family
has its naming table (``Naming``):

- GPT: ``wte/embedding``, ``wpe``, ``ln_f/{scale,bias}`` and, per block,
  ``ln1``, ``qkv``, ``proj``, ``ln2``, ``up``, ``down``, stacked along a
  leading layer axis under ``blocks`` when the layers are
  ``nn.scan``-ned, or one subtree ``block_<i>`` each when they are not;
- LLaMA: ``embed/embedding``, ``final_norm/scale``, ``lm_head/kernel``
  and, per layer, ``attn_norm`` and ``mlp_norm`` (``scale``) and the
  bias-free ``{q,k,v,o,gate,up,down}_proj`` kernels, under ``layers``
  (scanned) or ``layer_<i>``;
- with experts (both families), a layer's ``moe/{router, w_up, b_up,
  w_gate, w_down, b_down}`` in place of its MLP, under the same names
  in the port (``blocks.<i>.moe.w_up``), stacked ``[L, E, ...]`` under
  scanned layers.

The port's ``state_dict`` has one ``blocks.<i>`` / ``layers.<i>`` per
layer, and the table is chosen from the names (``naming_of``). A
pipelined model's layers (both families) are the JAX pipeline's:

- GPipe: ``pipeline.stages.<p>.blocks.<j>`` is
  ``pipeline/ticks/stages/stage/blocks/*`` ``[P, L/P, ...]`` under
  ``scan_layers``, ``pipeline/ticks/stages/stage/block_<j>/*``
  ``[P, ...]`` without it;
- circular: ``pipeline.bank.<p>.<c>.blocks.<k>`` is
  ``pipeline/bank/blocks/*`` ``[P, C, L/(P*C), ...]`` (or
  ``pipeline/bank/block_<k>/*`` ``[P, C, ...]``): the bank's own
  ``(p, c)``, which holds logical chunk ``c*P + p``
  (``dense_state_dict`` renames a pipelined model's layers to the
  unpipelined model's by logical layer).

On a pipe rank a stage leaf's members are its stages only: the leaf
keeps the global stage count (``stages``) and says which stages it
holds (``StageBlock.index``). Dense
kernels keep flax's ``[in, out]`` layout on both sides (the port
multiplies ``x @ kernel``), and flax's norm ``scale`` is the port's
``weight``. Both directions copy the values bit for bit, bf16 included
(through a 16-bit integer view).

``jax_leaves`` groups the port's named parameters into the JAX tree's
leaves; the port's ``adam8bit`` keeps its state per JAX leaf, so that
state converts across with ``adam8bit_state_from_flax`` /
``adam8bit_state_to_flax``.

A model the port does not define (a plain module of ``nn.Linear`` /
``nn.Embedding`` / ``nn.LayerNorm`` / ``nn.Conv1d`` and bare
``nn.Parameter``s) carries its flax twin's ``Dense`` / ``Embed`` /
``LayerNorm`` / ``Conv`` params and ``self.param``s at the same paths
(``plain_from_flax``, ``flax_from_plain``): a Dense kernel is its
Linear's weight transposed, a Conv kernel ``[k, in, out]`` its Conv1d's
``[out, in, k]`` weight with its dims reversed.

``train_state_leaves`` lays the port's whole train state (``{"params",
"opt", "step"}``) out as the JAX train state's flattened leaves, keyed
by the exact ``jax.tree_util.keystr`` strings and in JAX's order; each
leaf lists the port's tensors whose bytes, one after another, are the
JAX leaf's. The flash checkpoint writes and restores through it, so a
checkpoint of either package restores into the other.
"""

import dataclasses
import math
import re
from typing import (
    Any,
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

class Naming(NamedTuple):
    """A model family's names on both sides: the layer stack (the port's
    ``ModuleList`` and JAX's scanned subtree), the prefix of JAX's
    unscanned layers, the parameters outside the layers (port name ->
    JAX leaf path) and those inside a layer ((module, port leaf) -> JAX
    leaf)."""

    stack: str
    unscanned: str
    top: Mapping[str, str]
    layer: Mapping[Tuple[str, str], str]

    @property
    def top_name(self) -> Dict[str, str]:
        return {path: name for name, path in self.top.items()}

    @property
    def port_leaf(self) -> Dict[Tuple[str, str], str]:
        return {(m, leaf): port for (m, port), leaf in self.layer.items()}

    def layer_param(self, name: str):
        """(layer, module, port leaf) of a port name inside the stack,
        or None."""
        hit = re.match(rf"{self.stack}\.(\d+)\.(\w+)\.(\w+)$", name)
        if hit and (hit.group(2), hit.group(3)) in self.layer:
            return int(hit.group(1)), hit.group(2), hit.group(3)
        return None


_GPT_DENSE = ("qkv", "proj", "up", "down")
# An MoE layer's leaves: the same name on both sides.
_MOE = {("moe", leaf): leaf for leaf in ("router", "w_up", "b_up", "w_gate",
                                         "w_down", "b_down")}
_GPT_NORMS = ("ln1", "ln2")
GPT_NAMING = Naming(
    stack="blocks", unscanned="block_",
    top={"wte.weight": "wte/embedding", "wpe": "wpe",
         "ln_f.weight": "ln_f/scale", "ln_f.bias": "ln_f/bias"},
    layer={
        **{(m, "weight"): "scale" for m in _GPT_NORMS},
        **{(m, "bias"): "bias" for m in _GPT_NORMS + _GPT_DENSE},
        **{(m, "kernel"): "kernel" for m in _GPT_DENSE},
        **_MOE,
    },
)
_LLAMA_PROJ = tuple(f"{p}_proj" for p in ("q", "k", "v", "o", "gate", "up",
                                           "down"))
LLAMA_NAMING = Naming(
    stack="layers", unscanned="layer_",
    top={"embed.weight": "embed/embedding",
         "final_norm.weight": "final_norm/scale",
         "lm_head.kernel": "lm_head/kernel"},
    layer={
        **{(m, "weight"): "scale" for m in ("attn_norm", "mlp_norm")},
        **{(m, "kernel"): "kernel" for m in _LLAMA_PROJ},
        **_MOE,
    },
)


_LLAMA_MODULES = frozenset(m for m, _ in LLAMA_NAMING.layer) - {"moe"}


def naming_of(names: Iterable[str]) -> Naming:
    """The naming table of a model from its parameter names (the port's,
    ``layers.3.q_proj.kernel``) or its JAX leaf paths
    (``layers/q_proj/kernel``): LLaMA's when one of them is LLaMA's,
    GPT's otherwise."""
    llama = LLAMA_NAMING
    for name in names:
        parts = re.split(r"[./]", name)
        if (name in llama.top or name in llama.top_name
                or parts[0] == llama.stack
                or parts[0].startswith(llama.unscanned)
                or _LLAMA_MODULES.intersection(parts)):
            return llama
    return GPT_NAMING


# A pipelined model's layers: (port name pattern, JAX leaf path prefix).
_PIPE_GPIPE = (re.compile(r"pipeline\.stages\.(\d+)\.blocks\.(\d+)\."
                          r"(\w+)\.(\w+)$"), "pipeline/ticks/stages/stage/")
_PIPE_BANK = (re.compile(r"pipeline\.bank\.(\d+)\.(\d+)\.blocks\.(\d+)\."
                         r"(\w+)\.(\w+)$"), "pipeline/bank/")


def _pipe_layer(name: str):
    """(JAX prefix, bank indices, block index, module, port leaf) of a
    pipelined model's layer parameter, or None."""
    for pattern, prefix in (_PIPE_GPIPE, _PIPE_BANK):
        hit = pattern.match(name)
        if hit:
            *idx, block, module, leaf = hit.groups()
            return prefix, tuple(int(i) for i in idx), int(block), module, leaf
    return None


def _pipe_path(path: str):
    """(JAX prefix, lead dims of the bank, block index or None when
    stacked, module, leaf) of a pipelined JAX leaf path, or None."""
    for pattern, prefix in (_PIPE_GPIPE, _PIPE_BANK):
        if path.startswith(prefix):
            blocks, module, leaf = path[len(prefix):].split("/")
            lead = 1 if pattern is _PIPE_GPIPE[0] else 2
            block = None if blocks == "blocks" else int(blocks[len("block_"):])
            return prefix, lead, block, module, leaf
    return None


def _pipe_name(prefix: str, idx, block: int, module: str, port: str) -> str:
    bank = "stages" if prefix == _PIPE_GPIPE[1] else "bank"
    return (f"pipeline.{bank}." + "".join(f"{i}." for i in idx)
            + f"blocks.{block}.{module}.{port}")


def dense_state_dict(state_dict: Mapping[str, torch.Tensor], cfg
                     ) -> Dict[str, torch.Tensor]:
    """A pipelined model's ``state_dict`` under the unpipelined model's
    names (its layers by logical index: bank chunk ``(p, c)`` is chunk
    ``c*P + p``); the tensors are not copied."""
    from dlrover_tpu_torch.accel.pipeline import layer_names

    stack = naming_of(state_dict).stack
    dense = dataclasses.replace(cfg, pipeline_stages=0, pipeline_repeats=1)
    rename = dict(zip(layer_names(cfg, stack), layer_names(dense, stack)))
    out = {}
    for name, value in state_dict.items():
        hit = re.match(r"(pipeline\.\w+\.\d+\.(?:\d+\.)?blocks\.\d+)\.(.*)$",
                       name)
        out[f"{rename[hit.group(1)]}.{hit.group(2)}" if hit else name] = value
    return out


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
    """JAX GPT or LLaMA params (a tree of arrays, or of anything shaped
    like them, such as gradients) -> the port's ``state_dict``."""
    flat = dict(_flat(tree))
    naming = naming_of(flat)
    top_name, port_leaf = naming.top_name, naming.port_leaf
    out = {}
    for path, value in flat.items():
        if path in top_name:
            out[top_name[path]] = _tensor(value)
            continue
        pipe = _pipe_path(path)
        if pipe is not None:
            prefix, lead, block, module, leaf = pipe
            port = port_leaf[module, leaf]
            arr = np.asarray(value)
            dims = arr.shape[:lead + (block is None)]
            for idx in np.ndindex(*dims):
                b = idx[lead] if block is None else block
                out[_pipe_name(prefix, idx[:lead], b, module, port)] = \
                    _tensor(arr[idx])
            continue
        prefix, module, leaf = path.split("/")
        port = port_leaf[module, leaf]
        if prefix == naming.stack:
            for i, layer in enumerate(np.asarray(value)):
                out[f"{naming.stack}.{i}.{module}.{port}"] = _tensor(layer)
        else:
            i = int(prefix[len(naming.unscanned):])
            out[f"{naming.stack}.{i}.{module}.{port}"] = _tensor(value)
    return out


def flax_from_params(state_dict: Mapping[str, torch.Tensor],
                     stacked: bool = True) -> Dict:
    """The port's ``state_dict`` -> JAX params as numpy arrays: stacked
    under ``blocks`` / ``layers`` (``scan_layers=True``) or one
    ``block_<i>`` / ``layer_<i>`` per layer."""
    leaves = jax_leaves(((n, tuple(v.shape)) for n, v in state_dict.items()),
                        stacked=stacked)
    flat = {}
    for path, leaf in leaves.items():
        arrays = [_array(state_dict[n]) for n in leaf.names]
        flat[path] = (arrays[0] if arrays[0].shape == leaf.shape
                      else np.stack(arrays).reshape(leaf.shape))
    return _nest(flat)


# ----------------------------------------------------- plain modules

#: A plain module's leaves: (torch module type, torch leaf, flax leaf,
#: whether the flax leaf is the torch one with its dims reversed).
_PLAIN = ((torch.nn.Linear, "weight", "kernel", True),
          (torch.nn.Linear, "bias", "bias", False),
          (torch.nn.Conv1d, "weight", "kernel", True),
          (torch.nn.Conv1d, "bias", "bias", False),
          (torch.nn.Embedding, "weight", "embedding", False),
          (torch.nn.LayerNorm, "weight", "scale", False),
          (torch.nn.LayerNorm, "bias", "bias", False))


def _plain_leaves(module: torch.nn.Module):
    """(port name, flax path, reversed) of each parameter of a plain
    module made of ``nn.Linear`` / ``nn.Embedding`` / ``nn.LayerNorm`` /
    ``nn.Conv1d`` and bare parameters: the flax path is the module's
    dotted path with ``/`` and the flax leaf's name (a bare parameter's
    own); a Linear's and a Conv1d's weight is its flax kernel with its
    dims reversed."""
    out = []
    for mname, m in module.named_modules():
        prefix = mname.replace(".", "/")
        known = {port: (leaf, rev) for kind, port, leaf, rev in _PLAIN
                 if type(m) is kind}
        for port, _ in m.named_parameters(recurse=False):
            leaf, rev = known.get(port, (port, False))
            out.append((f"{mname}.{port}" if mname else port,
                        f"{prefix}/{leaf}" if prefix else leaf, rev))
    return out


def _reversed(t: torch.Tensor) -> torch.Tensor:
    return t.permute(*reversed(range(t.dim())))


def plain_from_flax(tree: Mapping, module: torch.nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """A flax tree of ``Dense`` / ``Embed`` / ``LayerNorm`` / ``Conv``
    params and bare ``self.param``s (arrays) -> the ``state_dict`` of
    ``module``, its torch twin (``nn.Linear`` / ``nn.Embedding`` /
    ``nn.LayerNorm`` / ``nn.Conv1d`` and ``nn.Parameter``s at the same
    paths): each Dense or Conv kernel's dims reversed into its layer's
    weight, every value bit for bit. The counterpart of
    ``params_from_flax`` for a model the port does not define."""
    flat = dict(_flat(tree))
    out = {}
    for name, path, rev in _plain_leaves(module):
        t = _tensor(flat[path])
        out[name] = _reversed(t).contiguous() if rev else t
    return out


def flax_from_plain(module: torch.nn.Module) -> Dict:
    """The inverse of ``plain_from_flax``: ``module``'s parameters as the
    flax tree of its twin (numpy arrays)."""
    params = dict(module.named_parameters())
    return _nest({path: _array(_reversed(params[name]) if rev
                               else params[name])
                  for name, path, rev in _plain_leaves(module)})


# ----------------------------------------------------- JAX leaf grouping


class JaxLeaf(NamedTuple):
    """One leaf of the JAX params tree: its parameters in the port, in
    the order of its stacked (layer, stage) dims (one, or one per layer
    of a stacked leaf), and its shape in the JAX tree."""

    names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def index(self) -> Optional[Tuple[Tuple[int, int], ...]]:
        """The region of the stacked dims the parameters cover: None, all
        of them (``StageBlock``: a pipe rank's stages)."""
        return None

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The shape the parameters make together: the leaf's, its
        stacked dims cut to ``index`` (a pipe rank's stages)."""
        index = self.index
        if index is None:
            return self.shape
        return tuple(b - a for a, b in index) + self.shape[len(index):]


class StageBlock(JaxLeaf):
    """A pipe rank's stages of a stage leaf: the names are those stages'
    parameters, ``shape`` the whole leaf's, ``index`` the region of its
    stacked dims they cover."""

    def __new__(cls, names, shape, index=None):
        self = super().__new__(cls, names, shape)
        self._index = index
        return self

    @property
    def index(self):
        return self._index


def _jax_path(name: str, stacked: bool, naming: Naming
              ) -> Tuple[str, Tuple[int, ...]]:
    """(JAX leaf path, indices along its stacked dims) of a port
    parameter name; a name the model does not have is its own leaf,
    under its own name."""
    if name in naming.top:
        return naming.top[name], ()
    pipe = _pipe_layer(name)
    if pipe is not None:
        prefix, idx, block, module, port = pipe
        leaf = naming.layer[module, port]
        if stacked:
            return f"{prefix}blocks/{module}/{leaf}", idx + (block,)
        return f"{prefix}block_{block}/{module}/{leaf}", idx
    hit = naming.layer_param(name)
    if hit:
        i, module, port = hit
        leaf = naming.layer[module, port]
        prefix = naming.stack if stacked else f"{naming.unscanned}{i}"
        return f"{prefix}/{module}/{leaf}", ((i,) if stacked else ())
    return name, ()


def jax_leaves(named_shapes: Iterable[Tuple[str, Tuple[int, ...]]],
               stacked: bool = True, stages: Optional[int] = None
               ) -> Dict[str, JaxLeaf]:
    """Group the port's parameters (name, shape) into the leaves of the
    JAX model's params tree, keyed by the leaf's ``/``-joined path:
    ``blocks/qkv/kernel`` holds every layer's ``qkv.kernel`` with shape
    ``[L, in, out]`` when ``stacked`` (``scan_layers=True``), and each
    ``block_<i>/qkv/kernel`` holds one layer's otherwise (LLaMA's:
    ``layers/...`` and ``layer_<i>/...``; its norm scales stack to
    ``[L, d]`` leaves, which the 8-bit Adam quantizes whole, as the JAX
    package does); a pipelined model's leaves stack its stages first
    (``[P, L/P, ...]``, ``[P, C, L/(P*C), ...]``). ``stages`` is the
    global stage count when the names hold a pipe rank's stages only.
    The names select the model's table (``naming_of``)."""
    named_shapes = [(n, tuple(s)) for n, s in named_shapes]
    naming = naming_of(n for n, _ in named_shapes)
    members: Dict[str, List[Tuple[Tuple[int, ...], str,
                                  Tuple[int, ...]]]] = {}
    for name, shape in named_shapes:
        path, idx = _jax_path(name, stacked, naming)
        members.setdefault(path, []).append((idx, name, shape))
    out = {}
    for path, group in members.items():
        group.sort()
        shape = group[0][2]
        if any(s != shape for _, _, s in group):
            raise ValueError(f"layers of {path} differ in shape")
        lead = len(group[0][0])
        index = None
        if lead:
            dims = [sorted({idx[d] for idx, _, _ in group})
                    for d in range(lead)]
            counts = [len(v) for v in dims]
            first = [v[0] for v in dims]
            partial = (stages is not None and path.startswith("pipeline/")
                       and counts[0] < stages)
            if (math.prod(counts) != len(group)
                    or any(v != list(range(v[0], v[0] + len(v)))
                           for v in dims)
                    or any(first[1:]) or (first[0] and not partial)):
                raise ValueError(f"{path} misses a layer")
            if partial:
                index = ((first[0], first[0] + counts[0]),) + tuple(
                    (0, n) for n in counts[1:])
                counts[0] = stages
            shape = tuple(counts) + shape
        names = tuple(n for _, n, _ in group)
        out[path] = (JaxLeaf(names, shape) if index is None
                     else StageBlock(names, shape, index))
    return out


def param_leaves(params: Mapping[str, torch.Tensor], stacked: bool = True
                 ) -> Dict[str, JaxLeaf]:
    """``jax_leaves`` of live parameters; on a pipe rank, with the global
    stage count their layouts carry (``accel.sharding.Layout.stages``)."""
    from dlrover_tpu_torch.accel import sharding

    stages = max((getattr(sharding.layout_of(p), "stages", 0)
                  for p in params.values()), default=0)
    return jax_leaves(((n, tuple(p.shape)) for n, p in params.items()),
                      stacked=stacked, stages=stages or None)


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
    int32 value and ``assign`` sets it. An optimizer leaf that mirrors a
    params leaf (a master, a moment) names it in ``param_path`` (a
    ``jax_leaves`` key): its members belong to that leaf's parameters, in
    order.

    On a mesh a leaf is one block of this rank: ``shape`` is the block's,
    ``index`` its region ``((start, stop), ...)`` of the leaf of
    ``global_shape`` in the JAX leaf's global coordinates (both None for
    the whole leaf), its members views of the local tensors, and
    ``persist`` whether this rank is the replica that writes it;
    ``layout`` is the ``accel.sharding.Layout`` it came from. Before
    that, ``stacked`` is the region of the stacked dims the members
    cover when they are some of the leaf's stages (``JaxLeaf.index``;
    ``shape`` is then the whole leaf's)."""

    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    members: Tuple[torch.Tensor, ...] = ()
    value: Optional[int] = None
    assign: Optional[Callable[[int], None]] = None
    param_path: Optional[str] = None
    index: Optional[Tuple[Tuple[int, int], ...]] = None
    global_shape: Optional[Tuple[int, ...]] = None
    persist: bool = True
    layout: Any = None
    stacked: Optional[Tuple[Tuple[int, int], ...]] = None


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


def _opt_leaves(opt, prefix: str, params: Mapping[str, torch.Tensor],
                groups: Dict[str, JaxLeaf], order: List[str]
                ) -> List[StateLeaf]:
    """The leaves of a bound optimizer's state under ``prefix``, over
    ``params`` (the tensors it updates, by name)."""
    # The wrappers import this module's callers; import them here.
    from dlrover_tpu_torch.accel import sharding
    from dlrover_tpu_torch.accel.accelerate import MeshOptimizer
    from dlrover_tpu_torch.accel.zero import ZeroOptimizer
    from dlrover_tpu_torch.optim.bf16 import Bf16MasterOptimizer
    from dlrover_tpu_torch.optim.offload import OffloadOptimizer

    leaves: List[StateLeaf] = []
    if isinstance(opt, ZeroOptimizer):
        # Its inner optimizer's state is over this data rank's slices
        # (and the parameters no slice was cut of), each leaf laid out
        # as its slice.
        # (The 8-bit moments under sliced masters keep their own.)
        return [leaf._replace(layout=opt.state_layout(leaf.param_path))
                if leaf.param_path is not None or leaf.layout is None
                else leaf
                for leaf in _opt_leaves(opt.inner, prefix, opt.bound,
                                        opt.jax_groups, order)]
    if isinstance(opt, MeshOptimizer):
        # Its inner optimizer's state is whole where the parameter is
        # sharded (its gathered copy has no layout), and laid out as the
        # parameter elsewhere (a pipe rank's stages and ends).
        return _opt_leaves(opt.inner, prefix, opt.full, groups, order)
    if isinstance(opt, OffloadOptimizer):
        # JAX's offload keeps its inner transform's state as it is.
        return _opt_leaves(opt.inner, prefix, params, groups, order)
    if isinstance(opt, Bf16MasterOptimizer):
        # Bf16MasterState(master, inner).
        for path in order:
            members = tuple(opt.master[n] for n in groups[path].names)
            leaves.append(StateLeaf(keystr(f"{prefix}.master", path),
                                    groups[path].shape, members[0].dtype,
                                    members, param_path=path,
                                    layout=sharding.layout_of(members[0]),
                                    stacked=groups[path].index))
        return leaves + _opt_leaves(opt.inner, f"{prefix}.inner", opt.master,
                                    groups, order)
    if isinstance(opt, Adam8bitOptimizer):
        st = opt.state
        leaves.append(StateLeaf(f"{prefix}.step", (), st.step.dtype,
                                (st.step,)))
        for moment in ("m", "v"):
            tree = getattr(st, moment)
            for path in _in_jax_order(tree):
                leaf = opt._leaves[path]
                lay = sharding.layout_of(opt.params[leaf.names[0]])
                for field in ("q", "scale"):
                    t = getattr(tree[path], field)
                    shape, layout = _quantized_block(t, leaf, lay)
                    leaves.append(StateLeaf(
                        keystr(f"{prefix}.{moment}", path) + f".{field}",
                        shape, t.dtype, (t,), layout=layout))
    elif _plain_adam(opt):
        materialize_adam_state(opt)
        leaves.append(StateLeaf(
            f"{prefix}[0].count", (), torch.int32,
            value=_adam_count(opt, params),
            assign=lambda v: _set_adam_count(opt, v)))
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            for path in order:
                members = tuple(opt.state[params[n]][key]
                                for n in groups[path].names)
                leaves.append(StateLeaf(
                    keystr(f"{prefix}[0].{moment}", path), groups[path].shape,
                    members[0].dtype, members, param_path=path,
                    layout=sharding.layout_of(params[groups[path].names[0]]),
                    stacked=groups[path].index))
    else:
        raise TypeError(
            f"no JAX train-state layout for optimizer {type(opt).__name__}; "
            "the port lays out adam8bit, torch Adam/AdamW without amsgrad, "
            "capturable or fused, and bf16_master_weights and offload "
            "around them")
    return leaves


def _quantized_block(t: torch.Tensor, leaf: JaxLeaf, layout):
    """The JAX shape and the layout of an 8-bit moment's ``q`` or
    ``scale`` tensor ``t`` of a params leaf laid out as ``layout``: on a
    pipe rank a stage leaf's state is its stages' rows of the global
    leaf's (``[P, blocks, ...]``, dim 0 split over the pipe axis, as the
    rank's stages split the leaf's stage dim); any other leaf's state is
    whole where its parameter lies (its layout without the dims it
    shards: the 8-bit moments are never sharded)."""
    from dlrover_tpu_torch.accel import sharding

    if layout is None:
        return tuple(t.shape), None
    if leaf.index is not None:
        pipe = layout.mesh.mesh_dim_names.index("pipe")
        shard = tuple(0 if i == pipe else None
                      for i in range(len(layout.shard)))
        return ((leaf.shape[0],) + tuple(t.shape[1:]),
                sharding.Layout(layout.mesh, shard))
    return tuple(t.shape), dataclasses.replace(
        layout, shard=(None,) * len(layout.shard), fused=1)


def opt_state_leaves(opt, params: Mapping[str, torch.Tensor],
                     groups: Optional[Dict[str, JaxLeaf]] = None
                     ) -> List[StateLeaf]:
    """The leaves of a bound optimizer's state over ``params`` (by name),
    each with its own tensors as members (not this rank's blocks, which
    ``train_state_leaves`` cuts on a mesh): what ``optim/offload.py``
    moves."""
    if groups is None:
        groups = param_leaves(params)
    return _opt_leaves(opt, "['opt']", params, groups, _in_jax_order(groups))


def train_state_leaves(state, stacked: bool = True,
                       groups: Optional[Dict[str, JaxLeaf]] = None
                       ) -> List[StateLeaf]:
    """The port's train state as the JAX train state's leaves, in the
    order ``jax.tree_util.tree_flatten_with_path`` gives them:
    ``['opt']...`` (optax ``adamw``: ``['opt'][0].count``, ``.mu[...]``,
    ``.nu[...]``; ``adam8bit``: ``['opt'].step`` and ``.m[...]``/
    ``.v[...]`` with ``.q`` and ``.scale``; ``bf16_master_weights``:
    ``['opt'].master[...]``, then its inner state under
    ``['opt'].inner``; ``offload``: its inner state as it is),
    ``['params'][...]``, then
    ``['step']``. A stacked leaf lists its layers' tensors; nothing is
    copied. Torch ``Adam``/``AdamW`` state is materialized first
    (``materialize_adam_state``). ``groups``: ``jax_leaves`` of the
    params, when the caller keeps it."""
    from dlrover_tpu_torch.accel import sharding

    params, opt = state["params"], state["opt"]
    if groups is None:
        groups = param_leaves(params, stacked=stacked)
    order = _in_jax_order(groups)
    leaves = _opt_leaves(opt, "['opt']", params, groups, order)
    for path in order:
        members = tuple(params[n] for n in groups[path].names)
        leaves.append(StateLeaf(keystr("['params']", path),
                                groups[path].shape, members[0].dtype,
                                members, param_path=path,
                                layout=sharding.layout_of(members[0]),
                                stacked=groups[path].index))

    def set_step(v: int):
        state["step"] = int(v)

    leaves.append(StateLeaf("['step']", (), torch.int32,
                            value=int(state["step"]), assign=set_step))
    return _blocks(leaves)


def _blocks(leaves: List[StateLeaf]) -> List[StateLeaf]:
    """On a mesh (a leaf has a layout), each leaf as this rank's blocks:
    a leaf without a layout is whole on every rank, and only the first
    replica persists it; off a mesh, the leaves as they are."""
    from dlrover_tpu_torch.accel import sharding

    world = next((leaf.layout.mesh for leaf in leaves if leaf.layout), None)
    if world is None:
        return leaves
    out = []
    for leaf in leaves:
        lay = leaf.layout or sharding.Layout.replicated(world)
        persist = lay.replica() == 0
        if not leaf.members:
            out.append(leaf._replace(persist=persist, layout=lay))
            continue
        # The member's global shape: the leaf's last dims (a DTensor's
        # own shape is global, a ZeRO slice's is its slice).
        ndim = leaf.members[0].dim()
        member = tuple(leaf.shape[len(leaf.shape) - ndim:])
        # The stacked dims (layers, stages) before the member's own, and
        # the region of them the members cover.
        lead = leaf.stacked or tuple(
            (0, n) for n in leaf.shape[:len(leaf.shape) - len(member)])
        lead_shape = tuple(b - a for a, b in lead)
        per = [sharding.blocks(m, lay, member) for m in leaf.members]
        for k, (region, _) in enumerate(per[0]):
            views = tuple(p[k][1] for p in per)
            shape = tuple(views[0].shape)
            index = global_shape = None
            if region is not None or leaf.stacked is not None:
                index = lead + (region or tuple((0, n) for n in member))
                global_shape = tuple(leaf.shape)
            out.append(leaf._replace(
                shape=lead_shape + shape, members=views, index=index,
                global_shape=global_shape, persist=persist, layout=lay,
                stacked=None))
    return out


def leaf_bytes(leaf: StateLeaf) -> torch.Tensor:
    """A leaf's bytes as the JAX leaf holds them (its members' bytes one
    after another; a host scalar as int32), as uint8 on the members'
    device."""
    if not leaf.members:
        return torch.tensor([leaf.value], dtype=torch.int32).view(torch.uint8)
    return torch.cat([m.detach().reshape(-1).view(torch.uint8)
                      for m in leaf.members])
