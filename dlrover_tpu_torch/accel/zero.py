"""ZeRO-1 of the port — counterpart of ``dlrover_tpu/accel/zero.py``.

The JAX package makes ZeRO-1 a relabelling: every optimizer-state leaf
that mirrors a parameter (Adam's ``mu``/``nu``, ``bf16_master_weights``'
fp32 masters and their moments, AGD's moments) gets the ``zero_dp``
logical axis on one dim, the rules map that axis to the ``data`` mesh
axis, and GSPMD schedules the slice update and the all-gather of the
updated parameters. The dim is the largest one that (a) no mesh axis
already shards under the spec's rules and (b) the data degree divides;
ties go to the first such dim; scalars, and leaves without such a dim,
stay replicated. The 8-bit Adam's moments are not boxed in JAX (they
are a flattened relayout of the parameter), so under ``zero=True`` it
shards nothing and warns.

The port makes the same choice (``zero_dim``, over the JAX leaves of
``models/convert.jax_leaves`` and their logical names) and does the
work itself: a ``ZeroOptimizer`` on a mesh with a ``data`` axis binds
the inner optimizer to this data rank's slices of every shardable leaf
(contiguous views into one buffer a dtype, their gradients likewise)
and to the parameters no slice was cut of. The gradients are summed
over ``data`` as ``make_train_step`` sums them without ZeRO (one flat
all-reduce), so every element adds the same addends in the same order;
each rank steps its slices (an elementwise update of a slice is the
slice of the whole update), then one all-gather a dtype brings every
rank's updated slices back into the whole parameters. Losses and
parameters equal ``ParallelSpec(data=N)``'s bit for bit; the state each
rank holds is about ``1/N`` of it.

Beside any other axis the same rule picks a dim that no present axis
claims (a leaf without one the degree divides stays replicated over
``data``), and a data rank's slice is cut from its local shard (fsdp,
tensor, seq or expert) or from its pipe rank's stages: a stacked
leaf's layers dim (``L/P``, or a circular bank's ``C`` or
``L/(P*C)``) may be chosen, never its ``stage`` dim, which the pipe
axis shards. Its layout lies over two or three mesh axes
(``sharding.Layout.zero``), in the JAX leaf's global coordinates, so
the checkpoint's blocks need no new format. A leaf ZeRO leaves whole is
stepped as the parameter's local shard. On a ``data`` axis of size 1
the wrapper still runs and owns whole leaves, while ``zero_degree_of``
is 0 there, as in JAX (what the checkpoint stamps).

``bf16_master_weights(adam8bit)`` is sliced as JAX slices it: the fp32
masters over ``data``, the 8-bit moments and their scales whole on
every data rank (``ZeroAdam8Optimizer``). Each rank runs the moment
update of every whole leaf (one launch of the unfused kernel,
``Adam8bit.update``, over the whole fp32 gradients) and adds its slice
of the update to its masters, so a slice may cut a 256-value block
anywhere: no block's moments are split between ranks.
"""

import itertools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.accel import sharding
from dlrover_tpu_torch.accel.sharding import ZERO_AXIS
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.optim.base import bind

__all__ = ["ZERO_AXIS", "AbstractLeaf", "ZeroOptimizer", "apply_zero",
           "leaf_names", "param_names", "shard_optimizer_state",
           "zero_degree_of", "zero_dim", "zero_optimizer",
           "zero_sharded_paths"]

#: The JAX package's warning when ``zero=True`` shards nothing.
NOTHING_SHARDED = (
    "zero=True but no optimizer-state leaf could be sharded over data=%s "
    "(no boxed leaf has an unsharded dim divisible by the degree) — "
    "optimizer state stays replicated")


def zero_degree_of(spec) -> int:
    """Data-axis degree the optimizer state is ZeRO-sharded over under
    ``spec`` (0 when the spec does not shard weight updates)."""
    if getattr(spec, "zero", False) and getattr(spec, "data", 1) > 1:
        return spec.data
    return 0


def _resolved_axes(name, rules: Dict) -> Tuple[str, ...]:
    """Mesh axes a logical dim name maps to under the spec's rules."""
    if not name:
        return ()
    axes = rules.get(name)
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def zero_dim(names: Sequence[Optional[str]], shape: Sequence[int], rules,
             data: int) -> Optional[int]:
    """The dim of a leaf of logical ``names`` and ``shape`` that ZeRO
    shards over ``data`` (JAX's rule): the largest dim that resolves to
    no mesh axis under ``rules`` and that ``data`` divides, the first on
    ties; None when there is none (or the names do not match the
    shape)."""
    rd = dict(rules)
    names, shape = tuple(names), tuple(shape)
    if len(names) != len(shape):
        return None
    best: Optional[int] = None
    for i, dim in enumerate(shape):
        if _resolved_axes(names[i], rd):
            continue                     # already mesh-sharded
        if dim < data or dim % data:
            continue                     # uneven slice: keep replicated
        if best is None or dim > shape[best]:
            best = i
    return best


def leaf_names(path: str, shape: Sequence[int], axes: Sequence) -> tuple:
    """The logical names of a JAX params leaf (``jax_leaves`` key and
    shape) whose parameters have logical ``axes``: its stacked dims first
    (``layers`` for a scanned stack; a pipeline's ``stage`` axis before
    them, and the circular bank's chunk axis unnamed), as the JAX models
    box them."""
    lead = len(shape) - len(axes)
    if path.startswith("pipeline/bank/"):
        head: tuple = ("stage", None)
    elif path.startswith("pipeline/"):
        head = ("stage",)
    else:
        head = ()
    return (head + ("layers",) * lead)[:lead] + tuple(axes)


def param_names(module, groups, axes=None) -> Dict[str, tuple]:
    """``{JAX params leaf path: logical names}`` of ``module``'s
    parameters grouped as ``groups`` (``convert.param_leaves``), their
    axes ``module.logical_axes()`` or ``axes`` (a plain module's, by
    parameter name)."""
    axes = module.logical_axes() if axes is None else axes
    return {path: leaf_names(path, leaf.shape, axes[leaf.names[0]])
            for path, leaf in groups.items()}


# ------------------------------------------------------ the abstract state


class AbstractLeaf(NamedTuple):
    """One leaf of the JAX train state without values: its ``keystr``
    path, shape, bytes an element and, for a boxed leaf (a parameter, or
    optimizer state that mirrors one), its logical names."""

    path: str
    shape: Tuple[int, ...]
    itemsize: int
    names: Optional[tuple] = None


def shard_optimizer_state(leaves: List[AbstractLeaf], data: int, rules
                          ) -> List[AbstractLeaf]:
    """Relabel each boxed optimizer-state leaf's ZeRO dim (``zero_dim``)
    with ``ZERO_AXIS``; everything else passes through."""
    if data <= 1:
        return leaves
    out = []
    for leaf in leaves:
        dim = None
        if leaf.names is not None and leaf.path.startswith("['opt']"):
            dim = zero_dim(leaf.names, leaf.shape, rules, data)
        if dim is not None:
            leaf = leaf._replace(names=leaf.names[:dim] + (ZERO_AXIS,)
                                 + leaf.names[dim + 1:])
        out.append(leaf)
    return out


def zero_sharded_paths(leaves: List[AbstractLeaf]) -> List[str]:
    """Paths of the leaves that carry the zero axis."""
    return [leaf.path for leaf in leaves
            if leaf.names is not None and ZERO_AXIS in leaf.names]


def apply_zero(leaves: List[AbstractLeaf], spec, rules, warn: bool = True
               ) -> List[AbstractLeaf]:
    """The ZeRO-1 relabelling of an abstract train state for ``spec``
    (none unless ``spec.zero`` with a data degree above 1)."""
    degree = zero_degree_of(spec)
    if not degree:
        return leaves
    out = shard_optimizer_state(leaves, degree, rules)
    if warn and not zero_sharded_paths(out):
        logger.warning(NOTHING_SHARDED, degree)
    return out


# ------------------------------------------------------ the optimizer


class _Piece(NamedTuple):
    """A data rank's slice of one parameter: ``dim`` narrowed to
    ``[start, start + length)``, or the whole parameter (``dim`` None:
    some layers of a stacked leaf); ``shape`` the slice's."""

    name: str
    dim: Optional[int]
    start: int
    length: int
    shape: Tuple[int, ...]

    def of(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.dim is None else t.narrow(self.dim, self.start,
                                                   self.length)


def _pieces(leaf, dim: int, data: int, coord: int,
            member: Tuple[int, ...]) -> List[_Piece]:
    """Data rank ``coord``'s slices of a JAX leaf (``JaxLeaf``) whose
    parameters' local tensors (their fsdp, tensor, seq or expert shards)
    are ``member``, cut along its ``dim`` into ``data`` equal parts. A
    dim among the stacked ones (layers, a bank's chunks, stages) gives
    the parameters whose index along it is in the rank's part, whole."""
    lead = len(leaf.shape) - len(member)
    size = leaf.local_shape[dim] if dim < lead else member[dim - lead]
    if size % data:
        raise ValueError(
            f"ZeRO-1 cuts dim {dim} of {leaf.names[0]} into {data} slices, "
            f"but this rank's shard has {size} of it")
    n = size // data
    if dim >= lead:
        d = dim - lead
        shape = member[:d] + (n,) + member[d + 1:]
        return [_Piece(name, d, coord * n, n, shape) for name in leaf.names]
    # The names run over the stacked dims in C order.
    stacked = itertools.product(*(range(k) for k in leaf.local_shape[:lead]))
    return [_Piece(name, None, 0, 0, member)
            for name, idx in zip(leaf.names, stacked)
            if coord * n <= idx[dim] < (coord + 1) * n]


def _stacked_part(leaf, dim: int, lead: int, data: int, coord: int):
    """The region of the ``lead`` stacked dims that data rank
    ``coord``'s whole parameters of ``leaf`` cover (``_pieces`` along
    stacked ``dim``), in the leaf's global coordinates."""
    index = list(leaf.index or ((0, k) for k in leaf.shape[:lead]))
    lo, hi = index[dim]
    n = (hi - lo) // data
    index[dim] = (lo + coord * n, lo + (coord + 1) * n)
    return tuple(index)


class ZeroOptimizer:
    """ZeRO-1 around a torch optimizer (``adamw``, ``agd``): see the
    module's docstring. ``inner`` is bound to ``bound`` (by parameter
    name: this rank's slice of a sharded leaf's parameter, or the whole
    parameter of a leaf ZeRO leaves replicated); ``step()`` reads the
    parameters' gradients, steps the inner optimizer and gathers the
    slices back."""

    def __init__(self, optimizer, named_parameters, layouts, groups,
                 dims: Dict[str, Optional[int]], mesh):
        from dlrover_tpu_torch.models.convert import StageBlock

        self.params = dict(named_parameters)
        self._names = {id(p): n for n, p in self.params.items()}
        #: The dim of each JAX leaf (by path) sliced over data (None:
        #: whole), as JAX's ``apply_zero`` relabels it.
        self.dims = dict(dims)
        axis = mesh.mesh_dim_names.index("data")
        self.group = mesh.get_group("data")
        self.size = int(mesh.mesh.shape[axis])
        coord = int(mesh.get_coordinate()[axis])
        #: Per data rank, its pieces in one order (equal shapes on every
        #: rank, so each rank's buffer of a dtype has the same layout).
        self.pieces: List[List[_Piece]] = [[] for _ in range(self.size)]
        self._layouts: Dict[str, sharding.Layout] = {}
        self._whole = sharding.Layout.replicated(mesh)
        self._groups = {}
        sliced = set()
        for path, leaf in groups.items():
            dim = dims.get(path)
            if dim is None:
                self._groups[path] = leaf
                self._layouts[path] = layouts[leaf.names[0]]
                continue
            member = tuple(sharding.local(self.params[leaf.names[0]]).shape)
            for c in range(self.size):
                self.pieces[c] += _pieces(leaf, dim, self.size, c, member)
            sliced.update(leaf.names)
            lead = len(leaf.shape) - len(member)
            mine = _pieces(leaf, dim, self.size, coord, member)
            self._layouts[path] = sharding.Layout.zero(
                layouts[leaf.names[0]], dim - lead if dim >= lead else None)
            if dim < lead:  # some layers (stages, chunks), whole
                self._groups[path] = StageBlock(
                    tuple(p.name for p in mine), leaf.shape,
                    _stacked_part(leaf, dim, lead, self.size, coord))
            else:
                self._groups[path] = leaf
        # One buffer a dtype of this rank's slices, one of their grads.
        own = self.pieces[coord]
        self._dtypes: Dict[torch.dtype, List[int]] = {}
        for i, piece in enumerate(own):
            dtype = self.params[piece.name].dtype
            self._dtypes.setdefault(dtype, []).append(i)
        self.slices: Dict[str, torch.Tensor] = {}
        self._grad_views: Dict[str, torch.Tensor] = {}
        self._send: Dict[torch.dtype, torch.Tensor] = {}
        self._grads: Dict[torch.dtype, torch.Tensor] = {}
        for dtype, idx in self._dtypes.items():
            total = sum(math.prod(own[i].shape) for i in idx)
            dev = self.params[own[idx[0]].name].device
            send = torch.empty(total, dtype=dtype, device=dev)
            grads = torch.zeros(total, dtype=dtype, device=dev)
            self._send[dtype], self._grads[dtype] = send, grads
            off = 0
            for i in idx:
                piece = own[i]
                n = math.prod(piece.shape)
                self.slices[piece.name] = send[off:off + n].view(piece.shape)
                self._grad_views[piece.name] = grads[off:off + n].view(
                    piece.shape)
                off += n
        self._own = own
        with torch.no_grad():
            self._refresh()
        #: What the inner optimizer is bound to, by parameter name: a
        #: slice, or the local tensor of a parameter no slice was cut of.
        self.bound = {n: self.slices.get(n, sharding.local(p))
                      for n, p in self.params.items()
                      if n in self.slices or n not in sliced}
        self.inner = self._bind(optimizer)
        logger.info("ZeRO-1 over data=%s: %s of %s parameters sliced, "
                    "%.1f MB of slices on this rank", self.size,
                    len(self.slices), len(self.params),
                    sum(t.numel() * t.element_size()
                        for t in self._send.values()) / 1e6)

    def _bind(self, optimizer):
        return bind(optimizer, self.bound.items())

    @property
    def jax_groups(self):
        """The JAX leaves the inner optimizer's state covers: a leaf cut
        along its layers lists this rank's layers only."""
        return self._groups

    def state_layout(self, param_path: Optional[str]) -> sharding.Layout:
        """The layout of the optimizer state of a params leaf: its ZeRO
        slice's, or its parameter's (a scalar's: whole on every rank)."""
        return self._layouts.get(param_path, self._whole)

    def _refresh(self):
        """This rank's slices from the parameters (a restore may have
        rewritten them since the last step)."""
        if self._own:
            torch._foreach_copy_(
                [self.slices[p.name] for p in self._own],
                [p.of(sharding.local(self.params[p.name]).detach())
                 for p in self._own])

    def _take_grads(self, grads: Dict[str, Optional[torch.Tensor]]):
        """The gradients of this rank's slices into their buffers; the
        names whose gradient is None are returned."""
        have = [p for p in self._own if grads.get(p.name) is not None]
        if have:
            torch._foreach_copy_([self._grad_views[p.name] for p in have],
                                 [p.of(sharding.local(grads[p.name]))
                                  for p in have])
        return {p.name for p in self._own} - {p.name for p in have}

    def _gather(self):
        """Every data rank's updated slices into the whole parameters:
        one all-gather a dtype, then one copy a slice."""
        for dtype, idx in self._dtypes.items():
            send = self._send[dtype]
            recv = torch.empty(self.size * send.numel(), dtype=dtype,
                               device=send.device)
            dist.all_gather_into_tensor(recv, send, group=self.group)
            dst, src = [], []
            for c in range(self.size):
                seg = recv[c * send.numel():(c + 1) * send.numel()]
                off = 0
                for i in idx:
                    piece = self.pieces[c][i]
                    n = math.prod(piece.shape)
                    dst.append(piece.of(
                        sharding.local(self.params[piece.name]).detach()))
                    src.append(seg[off:off + n].view(piece.shape))
                    off += n
            torch._foreach_copy_(dst, src)

    @torch.no_grad()
    def step(self):
        self._refresh()
        missing = self._take_grads({n: p.grad for n, p in
                                    self.params.items()})
        for name, view in self.slices.items():
            view.grad = None if name in missing else self._grad_views[name]
        for name, t in self.bound.items():
            if name not in self.slices:
                g = self.params[name].grad
                t.grad = None if g is None else sharding.local(g)
        self.inner.step()
        self._gather()


class ZeroFusedOptimizer(ZeroOptimizer):
    """ZeRO-1 around an ``update_and_apply`` optimizer
    (``bf16_master_weights``): the fused contract over the slices."""

    def update_and_apply(self, grads, params):
        named = {self._names[id(p)]: g for g, p in zip(grads, params)}
        with torch.no_grad():
            self._refresh()
            missing = self._take_grads(named)
            names = [n for n in self.bound if n in named
                     and n not in missing]
            self.inner.update_and_apply(
                [self._grad_views[n] if n in self.slices
                 else sharding.local(named[n]) for n in names],
                [self.bound[n] for n in names])
            self._gather()


class ZeroAdam8Optimizer(ZeroOptimizer):
    """ZeRO-1 around ``bf16_master_weights(adam8bit)`` (see the module's
    docstring): ``inner`` is a ``Bf16MasterOptimizer`` whose masters are
    this rank's slices (and the local tensors of the parameters no slice
    was cut of), and whose inner ``Adam8bitOptimizer`` is bound to the
    parameters themselves for its leaves and whole moments (their global
    shapes, a pipe rank's stages); it is stepped through ``update``, never
    ``update_and_apply``."""

    def _bind(self, optimizer):
        from dlrover_tpu_torch.optim.bf16 import Bf16MasterOptimizer
        from dlrover_tpu_torch.optim.low_bit import Adam8bitOptimizer

        self._mine = {p.name: p for p in self._own}
        whole = Adam8bitOptimizer(optimizer.inner, self.params.items())
        return Bf16MasterOptimizer(whole, self.bound.items())

    def update_and_apply(self, grads, params):
        named = {self._names[id(p)]: g for g, p in zip(grads, params)}
        adam = self.inner.inner
        hp = adam.tx.hp
        with torch.no_grad():
            self._refresh()
            # Every leaf's whole fp32 gradient (zeros without one).
            whole = {}
            for n, p in self.params.items():
                g = named.get(n)
                whole[n] = (torch.zeros(sharding.local(p).shape,
                                        dtype=torch.float32,
                                        device=sharding.local(p).device)
                            if g is None else sharding.gather_full(
                                g, sharding.layout_of(p), p.shape).float())
            updates, _ = adam.tx.update(whole, adam.state,
                                        leaves=adam._leaves)
            for n, master in self.inner.master.items():
                u, lay = updates[n], sharding.layout_of(self.params[n])
                if lay is not None and lay.sharded_axes():
                    u = sharding.local_from_full(u, lay)
                if n in self._mine:
                    u = self._mine[n].of(u)
                if hp.wd:
                    # As Adam8bit.update: lr * wd rounded to the dtype.
                    c = torch.tensor(hp.lr * hp.wd, dtype=master.dtype).item()
                    u = u - (c * master).to(u.dtype)
                master.add_(u)
                held = self.bound[n]
                held.add_(master.to(held.dtype) - held)
            self._gather()


def _sliceable(optimizer) -> bool:
    """Whether ``optimizer``'s state is boxed in JAX, so ZeRO slices it:
    a torch optimizer's moments, ``bf16_master_weights``' masters and
    its inner optimizer's (of an 8-bit Adam, the masters only); not the
    bare 8-bit Adam's quantized moments."""
    from dlrover_tpu_torch.optim.bf16 import Bf16MasterWeights
    from dlrover_tpu_torch.optim.low_bit import Adam8bit

    if isinstance(optimizer, Adam8bit):
        return False
    if isinstance(optimizer, Bf16MasterWeights):
        if not isinstance(optimizer.inner, Adam8bit):
            _sliceable(optimizer.inner)
        return True
    if getattr(optimizer, "takes_named_parameters", False):
        # offload(inner): ZeRO slices inner's state, then offload_optimizer
        # moves the slices.
        raise ValueError(
            f"zero=True with {type(optimizer).__name__}: pass its inner "
            "optimizer with offload_optimizer=True, which offloads the "
            "ZeRO slices")
    return True


def zero_optimizer(optimizer, module, layouts, mesh, rules, axes=None):
    """``optimizer`` (unbound) bound to ``module``'s parameters under
    ZeRO-1 over ``mesh``'s data axis: a ``ZeroOptimizer`` (or its fused
    form), or None when no leaf can be sliced (the 8-bit Adam, or no dim
    the degree divides), after JAX's warning. ``axes``: a plain module's
    logical axes by parameter name."""
    from dlrover_tpu_torch.models.convert import param_leaves

    data = int(mesh.mesh.shape[mesh.mesh_dim_names.index("data")])
    named = list(module.named_parameters())
    groups = param_leaves(dict(named))
    dims: Dict[str, Optional[int]] = {}
    if _sliceable(optimizer):
        for path, names in param_names(module, groups, axes).items():
            dims[path] = zero_dim(names, groups[path].shape, rules, data)
    if not any(d is not None for d in dims.values()):
        logger.warning(NOTHING_SHARDED, data)
        return None
    from dlrover_tpu_torch.optim.low_bit import Adam8bit

    if isinstance(getattr(optimizer, "inner", None), Adam8bit):
        cls = ZeroAdam8Optimizer
    elif getattr(optimizer, "takes_named_parameters", False):
        cls = ZeroFusedOptimizer
    else:
        cls = ZeroOptimizer
    return cls(optimizer, named, layouts, groups, dims, mesh)
