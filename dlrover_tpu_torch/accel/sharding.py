"""Sharding rules and parameter layouts of the port — counterpart of
``dlrover_tpu/accel/sharding.py``.

``logical_rules`` is the JAX package's table from logical axis names
(annotated on every parameter: ``GPT.logical_axes()``,
``Llama.logical_axes()``, or a ``ShardingRegistry``'s axes for a plain
module) to mesh axes; ``mesh_dims`` maps one parameter's logical axes
through it to the tensor dim each mesh axis shards, the DTensor
placements the tensor axis gives a ``Dense``.

A ``Layout`` says where one parameter's values lie on the mesh: for
each mesh axis, the tensor dim it shards (``torch.chunk``'s split, as
DTensor and FSDP2 split) or None (replicated over that axis). Two mesh
axes may shard two dims (fsdp a kernel's ``embed`` dim, tensor the
other) or one dim between them, nested: the later mesh axis splits the
dim first and the earlier one splits the chunk it left, as FSDP2 shards
a tensor-parallel DTensor's local rows where the leaf has no ``embed``
dim (a column bias: ``_StridedShard``, a rank's rows the fsdp chunk of
its tensor chunk) and as ZeRO-1 cuts a data rank's slice from its fsdp
or tensor shard. GPT's fused ``qkv`` is sharded over
``tensor`` as ``fused=3`` equal regions (its q, its k and its v
columns), so a rank's local columns are its heads of q, of k and of v,
one region after another: three regions of the global leaf. Everything
that moves values between a rank's local tensor and the global leaf
goes through ``regions``: the checkpoint's blocks (``blocks``, in the
JAX leaf's global coordinates), the 8-bit Adam's whole-leaf view
(``gather_full``, one all-gather over each axis that shards the leaf;
``scatter_local``) and the placement of full weights
(``local_from_full``). A parameter without a layout lies whole on every
rank.
"""

import math
from dataclasses import dataclass, replace
from itertools import product as cartesian
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.log import logger

#: The logical axis ZeRO-1 relabels optimizer-state dims to (the JAX
#: package's ``accel/zero.ZERO_AXIS``).
ZERO_AXIS = "zero_dp"

Region = Tuple[Tuple[int, int], ...]


def logical_rules(data: int = 1, fsdp: int = 1, tensor: int = 1,
                  seq: int = 1, expert: int = 1, pipe: int = 1,
                  vocab_size: int = 0, zero: bool = False,
                  present: Sequence[str] = ()) -> List[Tuple[str, Any]]:
    """The JAX package's logical-axis rules for the given degrees: only
    axes of degree > 1 appear, and the mesh axes named in ``present``
    (a mesh that has the axis at size 1 takes its branch);
    ``vocab_size`` guards the vocab rule's divisibility (an indivisible
    vocab stays replicated, with JAX's warning)."""
    def on(axis: str, n: int) -> bool:
        return n > 1 or axis in present

    batch_axes = [a for a, n in (("data", data), ("fsdp", fsdp)) if on(a, n)]
    vocab_axes = [a for a, n in (("tensor", tensor), ("pipe", pipe))
                  if on(a, n)]
    vocab_shard = tensor * pipe
    if vocab_axes and vocab_size and vocab_size % vocab_shard:
        logger.warning(
            "vocab %s is not divisible by tensor*pipe=%s; replicating "
            "the vocab axis instead of sharding it (costs V x d_model "
            "per device — pad the vocab to a multiple of %s to shard)",
            vocab_size, vocab_shard, vocab_shard,
        )
        vocab_axes = []
    rules: List[Tuple[str, Any]] = [
        ("batch", tuple(batch_axes) if batch_axes else None),
        ("layers", None),
        ("embed", "fsdp" if on("fsdp", fsdp) else None),
        ("heads", "tensor" if on("tensor", tensor) else None),
        ("mlp", "tensor" if on("tensor", tensor) else None),
        ("vocab", tuple(vocab_axes) if vocab_axes else None),
        ("kv", None),
        ("seq", "seq" if on("seq", seq) else None),
        ("expert", "expert" if on("expert", expert) else None),
        ("stage", "pipe" if on("pipe", pipe) else None),
    ]
    if zero and data > 1:
        rules.append((ZERO_AXIS, "data"))
    return rules


def mesh_dims(axes: Sequence[Optional[str]], rules) -> dict:
    """``{mesh axis: tensor dim}`` of a parameter with logical ``axes``
    under ``rules``: each logical axis takes the first of its rule's mesh
    axes that no earlier dim took, as flax's ``logical_to_mesh`` does."""
    table = dict(rules)
    out: dict = {}
    for dim, name in enumerate(axes):
        target = table.get(name)
        for mesh_axis in ((target,) if isinstance(target, str)
                          else target or ()):
            if mesh_axis not in out:
                out[mesh_axis] = dim
                break
    return out


@dataclass(frozen=True)
class Layout:
    """Where one parameter's values lie on ``mesh``: ``shard[i]`` is the
    tensor dim mesh axis ``i`` shards (None: replicated over it);
    ``fused`` equal regions split the tensor-parallel dim (GPT's qkv).
    ``placed`` are the mesh axes along which the parameter lies whole
    on one coordinate only (a pipe rank's stages, the embedding on the
    first); ``stages`` is, for a stage's parameter, the global count of
    stages of its JAX leaf (whose stage dim the pipe axis shards)."""

    mesh: Any  # the job's DeviceMesh
    shard: Tuple[Optional[int], ...]
    fused: int = 1
    placed: Tuple[int, ...] = ()
    stages: int = 0

    @staticmethod
    def replicated(mesh) -> "Layout":
        return Layout(mesh, (None,) * mesh.ndim)

    @staticmethod
    def of(mesh, dims: dict, fused: int = 1) -> "Layout":
        """From ``{mesh axis name: tensor dim}``."""
        return Layout(mesh, tuple(dims.get(n) for n in mesh.mesh_dim_names),
                      fused)

    @staticmethod
    def zero(param: "Layout", dim: Optional[int]) -> "Layout":
        """The layout of a ZeRO-1 optimizer-state slice of a parameter
        laid out as ``param`` (``accel/zero.py``): the data axis shards
        tensor dim ``dim`` of this rank's fsdp or tensor shard (nested
        in another axis's split of the same dim), or, with ``dim`` None
        (the slice is some of a stacked leaf's layers, whole), the shard
        lies on one data coordinate only."""
        axis = param.mesh.mesh_dim_names.index("data")
        if dim is None:
            return replace(param, placed=param.placed + (axis,))
        shard = list(param.shard)
        shard[axis] = dim
        return replace(param, shard=tuple(shard))

    @property
    def coord(self) -> Tuple[int, ...]:
        return tuple(self.mesh.get_coordinate())

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(self.mesh.mesh.shape)

    def sharded_axes(self) -> List[int]:
        return [i for i, d in enumerate(self.shard)
                if d is not None and self.sizes[i] > 1]

    def replica(self) -> int:
        """This rank's index among the ranks that hold its values (0 is
        the one that persists them)."""
        idx = 0
        for i, (d, n) in enumerate(zip(self.shard, self.sizes)):
            if d is None and i not in self.placed:
                idx = idx * n + self.coord[i]
        return idx

    def _dims(self, shape: Sequence[int], coord: Optional[Sequence[int]]):
        """Per tensor dim, the ``(global range, local range)`` pairs of
        the rank at ``coord`` (this rank's by default); a rank past the
        end of a ``torch.chunk`` split has an empty range. Mesh axes that
        shard one dim nest from the last mesh axis to the first: each
        splits what the later ones left of the dim (the ``fused`` regions
        of the tensor axis, or ``torch.chunk``'s parts)."""
        coord = self.coord if coord is None else coord
        # Per dim: the (global start, global stop, local start) segments
        # of what the axes split so far left, and its local length.
        segs = [[(0, s, 0)] for s in shape]
        lengths = list(shape)
        names = self.mesh.mesh_dim_names
        for i in reversed(range(len(self.shard))):
            d = self.shard[i]
            if d is None:
                continue
            n, c, size = self.sizes[i], coord[i], lengths[d]
            if self.fused > 1 and n > 1 and names[i] == "tensor":
                if lengths[d] != shape[d] or size % (self.fused * n):
                    raise ValueError(
                        f"dim {d} of {tuple(shape)} does not split into "
                        f"{self.fused} x {n} regions")
                w = size // (self.fused * n)
                segs[d] = [(j * size // self.fused + c * w,
                            j * size // self.fused + (c + 1) * w, j * w)
                           for j in range(self.fused)]
                lengths[d] = self.fused * w
                continue
            chunk = -(-size // n)
            start = min(c * chunk, size)
            stop = min(start + chunk, size)
            kept = []
            for g0, g1, l0 in segs[d]:
                a, b = max(l0, start), min(l0 + g1 - g0, stop)
                if b > a:
                    kept.append((g0 + a - l0, g0 + b - l0, a - start))
            segs[d] = kept
            lengths[d] = stop - start
        return [[((g0, g1), (l0, l0 + g1 - g0)) for g0, g1, l0 in dim_segs]
                or [((0, 0), (0, 0))] for dim_segs in segs]

    def regions(self, shape: Sequence[int],
                coord: Optional[Sequence[int]] = None
                ) -> List[Tuple[Region, Region]]:
        """``(global region, local region)`` pairs of the rank at
        ``coord`` (this rank's by default) for a parameter of global
        ``shape``: each ``((start, stop), ...)`` per dim. Empty regions
        are left out."""
        out = []
        for combo in cartesian(*self._dims(shape, coord)):
            g = tuple(r[0] for r in combo)
            if all(b > a for a, b in g):
                out.append((g, tuple(r[1] for r in combo)))
        return out

    def local_shape(self, shape: Sequence[int],
                    coord: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
        """Shape of the local tensor of the rank at ``coord``."""
        return tuple(max(local[1] for _, local in ranges)
                     for ranges in self._dims(shape, coord))


def layout_of(t: torch.Tensor) -> Optional[Layout]:
    """The layout a parameter was given when its model was placed on a
    mesh (None: whole on every rank, the one-device path)."""
    return getattr(t, "_dlrover_layout", None)


def set_layout(t: torch.Tensor, layout: Layout):
    t._dlrover_layout = layout


def local(t: torch.Tensor) -> torch.Tensor:
    """The tensor this rank holds: a DTensor's local shard, or ``t``."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t._local_tensor
    return t


def _view(t: torch.Tensor, region: Region) -> torch.Tensor:
    for d, (a, b) in enumerate(region):
        if (a, b) != (0, t.shape[d]):
            t = t.narrow(d, a, b - a)
    return t


def blocks(t: torch.Tensor, layout: Optional[Layout],
           shape: Sequence[int]) -> List[Tuple[Optional[Region],
                                                 torch.Tensor]]:
    """This rank's blocks of a tensor laid out as ``layout`` (the
    parameter's, for its optimizer state too), global ``shape``: each
    ``(global region, view of the local tensor)``; the region is None
    when the block is the whole tensor."""
    loc = local(t)
    if layout is None:
        return [(None, loc)]
    out = []
    full = tuple((0, s) for s in shape)
    for g, l in layout.regions(shape):
        out.append((None if g == full else g, _view(loc, l)))
    return out


def local_from_full(full: torch.Tensor, layout: Layout) -> torch.Tensor:
    """This rank's local tensor of ``full`` (a new contiguous tensor)."""
    shape = tuple(full.shape)
    out = torch.empty(layout.local_shape(shape), dtype=full.dtype,
                      device=full.device)
    for g, l in layout.regions(shape):
        _view(out, l).copy_(_view(full, g))
    return out


def gather_full(t: torch.Tensor, layout: Optional[Layout],
                shape: Sequence[int], out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The whole tensor in the global leaf's order (``out`` when given),
    from every rank's local one: one all-gather over each mesh axis that
    shards it, in turn (the second gathers what the first gathered). A
    tensor no axis shards is its local tensor, no copy."""
    loc = local(t)
    axes = [] if layout is None else layout.sharded_axes()
    if not axes:
        if out is not None and out.data_ptr() != loc.data_ptr():
            out.copy_(loc)
            return out
        return loc
    shape = tuple(shape)
    names = layout.mesh.mesh_dim_names
    # The peers in the order the gathers stack them: the axis gathered
    # last outermost.
    coords = []
    for cs in cartesian(*(range(layout.sizes[i]) for i in reversed(axes))):
        coord = list(layout.coord)
        for i, c in zip(reversed(axes), cs):
            coord[i] = c
        coords.append(coord)
    width = max(math.prod(layout.local_shape(shape, c)) for c in coords)
    buf = torch.zeros(width, dtype=loc.dtype, device=loc.device)
    buf[:loc.numel()].copy_(loc.reshape(-1))
    for i in axes:
        recv = torch.empty(layout.sizes[i] * buf.numel(), dtype=loc.dtype,
                           device=loc.device)
        dist.all_gather_into_tensor(recv, buf,
                                    group=layout.mesh.get_group(names[i]))
        buf = recv
    if out is None:
        out = torch.empty(shape, dtype=loc.dtype, device=loc.device)
    for k, coord in enumerate(coords):
        lshape = layout.local_shape(shape, coord)
        peer = buf[k * width:k * width + math.prod(lshape)].view(lshape)
        for g, l in layout.regions(shape, coord):
            _view(out, g).copy_(_view(peer, l))
    return out


def scatter_local(full: torch.Tensor, t: torch.Tensor,
                  layout: Optional[Layout]):
    """Copy this rank's regions of ``full`` into its local tensor of
    ``t`` (nothing when they share storage)."""
    loc = local(t)
    if loc.data_ptr() == full.data_ptr() and loc.shape == full.shape:
        return
    if layout is None:
        loc.copy_(full)
        return
    for g, l in layout.regions(tuple(full.shape)):
        _view(loc, l).copy_(_view(full, g))
