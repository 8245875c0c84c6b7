"""8-bit Adam, the port of ``dlrover_tpu/optim/low_bit.py``.

Both Adam moments are int8 with one fp32 absmax scale per 256-element
block (about 2.03 bytes a parameter); ``v`` is stored as sqrt(v), and
the denominator is floored at half a quantization step of it (the JAX
package's docstrings give the reasons). One update is one pass over
memory: two CUDA kernels in ``ops/csrc/adam8bit.cu`` replace the two
Pallas kernels:

- ``adam8`` (``_adam8_kernel``, JAX ``low_bit.py:79``): dequantize,
  Adam, requantize, write the update ``u``;
- ``adam8_fused`` (``_adam8_fused_kernel``, ``:131``): the same, and
  write ``p * (1 - lr * wd) + u`` over the parameter.

The CUDA kernel takes a whole step in one launch: it walks a table of
every leaf and of every member tensor (``_Table``; ``leaf_rows`` lays it
out and ``walk_rows`` is the plain version of its addressing). The
bound optimizer's ``update_and_apply`` builds its table once and each
step only refreshes the gradients' pointers; ``update`` does the same
over the leaves it is given. The per-leaf wrappers (``adam8_update``,
``adam8_fused_update``) launch a table of one leaf for CUDA tensors, or
raise; they take the plain version ``_adam8_plain`` (the Pallas body op
for op, in fp32) only for tensors on the CPU.

**Layout.** The state is the JAX package's, leaf for leaf: one entry per
leaf of the JAX GPT's params tree, keyed by the leaf's path
(``models/convert.jax_leaves``; stacked layers, as ``scan_layers=True``
gives). A stacked ``[L, ...]`` leaf of rank >= 3 quantizes per layer
(``_chunked``); any other leaf is flattened whole, so the blocks of a
stacked bias ``[L, 3d]`` straddle layers. The kernel reads every value
from, and writes it back to, its own layer's tensor, so a straddling
leaf needs no gathered copy. A pipelined leaf ``[P, L/P, ...]``
quantizes per stage, its layers straddling the stage's blocks: the
table gives each stage a row of its own, pointing at the stage's
blocks of the state (``_row_count``). On a pipe rank the optimizer holds
only its stages: each leaf is a ``StageBlock`` of the global one, and
its state is those stages' rows of the global leaf's state, with their
own blocks and scales (a single stage keeps its row dim), so one launch
steps exactly the rows the rank owns.

**In place.** Unlike optax, ``update`` and ``update_and_apply`` update
the state's tensors (and, fused, the parameters) in place: a second
copy of the state would cost as much memory as the state saves.
"""

import ctypes
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

#: Elements of a quantization block in the CUDA kernel (32 lanes x 8).
KERNEL_BLOCK = 256

#: Launches of each kernel since the last ``reset_launch_counts()``; a
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {"adam8": 0, "adam8_fused": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class QTensor(NamedTuple):
    q: torch.Tensor      # int8 payload, padded to a block multiple
    scale: torch.Tensor  # fp32 absmax per block


class Adam8bitState(NamedTuple):
    step: torch.Tensor   # int32, 0-dim
    m: Dict[str, QTensor]  # by JAX leaf path; linear domain
    v: Dict[str, QTensor]  # by JAX leaf path; sqrt domain


class _Hyper(NamedTuple):
    lr: float
    b1: float
    b2: float
    eps: float
    wd: float
    block: int


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim fp32 tensor on ``like``'s device. PyTorch's CUDA division
    by a host scalar multiplies by its reciprocal; by a device tensor it
    divides, as the Pallas body does."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _chunked(shape) -> bool:
    """Stacked ``[L, ...]`` leaves of rank >= 3 quantize per layer."""
    return len(shape) >= 3 and shape[0] > 1


def _quantize(x: torch.Tensor, block: int) -> QTensor:
    flat = x.reshape(-1)
    blocks = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = blocks.reshape(-1, block)
    scale = blocks.abs().amax(dim=1)
    safe = torch.where(scale == 0, _const(1.0, scale), scale)
    q = torch.clamp(torch.round(blocks / safe[:, None] * _const(127.0, x)),
                    -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale.float())


def _quantize_leaf(x: torch.Tensor, block: int) -> QTensor:
    """A leaf quantized in the state's layout: per layer for a chunked
    leaf, as JAX's ``init`` vmaps ``_quantize`` over the layers."""
    if _chunked(x.shape):
        layers = [_quantize(t, block) for t in x.unbind(0)]
        return QTensor(torch.stack([t.q for t in layers]),
                       torch.stack([t.scale for t in layers]))
    return _quantize(x, block)


def _blocks_of(g: torch.Tensor, block: int) -> torch.Tensor:
    """A leaf in the state's block layout: per-layer flatten + pad for
    chunked leaves, plain flatten + pad otherwise."""
    pad = torch.nn.functional.pad
    if _chunked(g.shape):
        rows = g.reshape(g.shape[0], -1)
        return pad(rows, (0, (-rows.shape[1]) % block)).reshape(-1, block)
    flat = g.reshape(-1)
    return pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)


def _unblocks(u: torch.Tensor, shape, block: int) -> torch.Tensor:
    """Inverse of ``_blocks_of``."""
    shape = tuple(shape)
    if _chunked(shape):
        rest = 1
        for d in shape[1:]:
            rest *= d
        return u.reshape(shape[0], -1)[:, :rest].reshape(shape)
    size = 1
    for d in shape:
        size *= d
    return u.reshape(-1)[:size].reshape(shape)


# ------------------------------------------------------- plain version


def _adam8_plain(bc, gb, mq, msc, sq, ssc, *, lr, b1, b2, eps, wd=0.0,
                 pb=None):
    """Plain version of both kernels, op for op as the Pallas body, in
    fp32. ``gb``, ``mq``, ``sq`` (and ``pb``) are ``[nblocks, block]``,
    the scales ``[nblocks]``, ``bc`` the fp32 ``[bc1, bc2]``. Returns
    ``(out, mq', msc', sq', ssc')``: ``out`` is the update in g's dtype,
    or with ``pb`` the new params ``p * (1 - lr * wd) + u`` in p's."""
    c = lambda x: _const(x, gb)  # noqa: E731
    sqrt_bc2 = torch.sqrt(bc[1])
    lr_eff = c(-lr) * sqrt_bc2 / bc[0]
    eps_eff = c(eps) * sqrt_bc2
    g = gb.float()
    msc, ssc = msc.reshape(-1, 1), ssc.reshape(-1, 1)
    m = mq.float() * (msc * c(b1 / 127.0)) + c(1.0 - b1) * g
    s_prev = sq.float() * (ssc / c(127.0))
    v = c(b2) * s_prev * s_prev + c(1.0 - b2) * g * g
    s = torch.sqrt(v)
    ssc2 = s.amax(dim=1, keepdim=True)
    r_s = torch.where(ssc2 == 0, c(1.0), c(127.0) / ssc2)
    sq2 = torch.floor(s * r_s + c(0.5))
    denom = torch.maximum(sq2, c(0.5)) * (ssc2 / c(127.0))
    u = lr_eff * m / (denom + eps_eff)
    if pb is not None:
        out = (pb.float() * c(1.0 - lr * wd) + u).to(pb.dtype)
    else:
        out = u.to(gb.dtype)
    msc2 = m.abs().amax(dim=1, keepdim=True)
    r_m = torch.where(msc2 == 0, c(1.0), c(127.0) / msc2)
    mq2 = torch.round(m * r_m).to(torch.int8)  # half to even, as jnp.round
    return (out, mq2, msc2.reshape(-1), sq2.to(torch.int8),
            ssc2.reshape(-1))


# ------------------------------------------------------- the check

#: A kernel against its plain version on the same inputs, element by
#: element. The kernels pin the plain version's order of fp32 operations
#: (no FMA contraction, IEEE division and square root), so the int8
#: moments must agree exactly, each scale to ``scale_rel_err`` of its
#: value, and each output within one ulp of its dtype plus ``OUT_REL``
#: of its value (``out_err_over_limit`` <= 1).
ADAM8_LIMITS = {"q_mismatches": 0, "scale_rel_err": 1e-6,
                "out_err_over_limit": 1.0}
OUT_REL = 1e-6


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of each value of ``x`` in its dtype
    (the smallest normal for 0)."""
    info = torch.finfo(x.dtype)
    _, exp = torch.frexp(x.float())
    ulp = torch.ldexp(torch.full_like(x, info.eps, dtype=torch.float32),
                      exp - 1)
    return torch.where(x == 0, torch.full_like(ulp, info.tiny), ulp)


def adam8_errors(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]
                 ) -> Dict[str, float]:
    """Elementwise errors of a kernel's ``(out, mq, msc, sq, ssc)``
    against the plain version's, to hold against ``ADAM8_LIMITS``."""
    out, mq, msc, sq, ssc = got
    r_out, r_mq, r_msc, r_sq, r_ssc = ref
    dq = [(a.int() - b.int()).abs() for a, b in ((mq, r_mq), (sq, r_sq))]
    scale_err = 0.0
    for a, b in ((msc, r_msc), (ssc, r_ssc)):
        diff = (a - b).abs()
        rel = torch.where(b == 0, torch.where(diff == 0, 0.0, float("inf")),
                          diff / b.abs())
        scale_err = max(scale_err, rel.max().item())
    o, r = out.float(), r_out.float()
    limit = _ulp(r_out) + OUT_REL * r.abs()
    return {
        "q_mismatches": sum(int((d > 0).sum()) for d in dq),
        "q_max_diff": max(int(d.max()) for d in dq),
        "scale_rel_err": scale_err,
        "out_err_over_limit": ((o - r).abs() / limit).max().item(),
        "max_abs_err": (o - r).abs().max().item(),
    }


def adam8_failures(errors: Mapping[str, float]) -> List[str]:
    """The limits of ``ADAM8_LIMITS`` that ``errors`` break (NaN breaks
    every limit)."""
    return [f"{k} {errors[k]} > {lim}" for k, lim in ADAM8_LIMITS.items()
            if not errors[k] <= lim]


# ------------------------------------------------------- CUDA kernels

_PTR, _INT, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
# leaf table, leaves, blocks, g pointers, out pointers, bc, seven fp32
# scalars, stream.
_SIGNATURE = [_PTR, _INT, _LL, _PTR, _PTR, _PTR] + [_F] * 7 + [_PTR]
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_SIGNATURES = {f"adam8_{form}{dt}": _SIGNATURE
               for form in ("", "fused_") for dt in _DTYPES.values()}


def _lib():
    from dlrover_tpu_torch.ops.build import load_library

    return load_library("adam8bit", _SIGNATURES)


class LeafRow(NamedTuple):
    """A leaf as the kernel's table describes it (its ``struct Leaf``,
    less the state's four pointers)."""
    block0: int   # its first block in the step's numbering
    nblocks: int  # its quantization blocks
    n: int        # values of each member
    stride: int   # values between two members' starts in the block
                  # layout: a block multiple when each member starts a
                  # block (per-layer blocks, or one member), else n
    member0: int  # its first member in the table's member lists
    nmem: int


def _members(members: Sequence[torch.Tensor], shape) -> List[torch.Tensor]:
    """A leaf's member tensors, one per layer of a chunked leaf (a single
    stacked tensor is split into views of its layers)."""
    if _chunked(shape) and len(members) == 1:
        return list(members[0].reshape(shape[0], -1).unbind(0))
    return list(members)


def _row_count(shape, nmem: int) -> int:
    """The table's rows of a leaf: one, or one a chunk when a chunk holds
    several members (a pipelined leaf's ``[P, L/P, ...]`` has a member a
    layer and quantizes a stage at a time: each stage's members lie one
    after another in its blocks, a row of its own)."""
    return shape[0] if _chunked(shape) and nmem > shape[0] else 1


def leaf_rows(leaves: Sequence[Tuple[tuple, int, int]],
              block: int = KERNEL_BLOCK) -> List[LeafRow]:
    """The table's rows for ``leaves``, each ``(JAX shape, members, values
    a member)``, in order (``_row_count`` rows a leaf); the leaves'
    blocks are numbered one after another."""
    rows, block0, member0 = [], 0, 0
    for shape, nmem, n in leaves:
        chunks = _row_count(shape, nmem)
        if chunks > 1:
            k = nmem // chunks
            per = -(-(k * n) // block)
            for _ in range(chunks):
                rows.append(LeafRow(block0, per, n, n, member0, k))
                block0 += per
                member0 += k
            continue
        if _chunked(shape):
            per = -(-n // block)
            nblocks, stride = nmem * per, per * block
        else:
            nblocks = -(-(nmem * n) // block)
            stride = nblocks * block if nmem == 1 else n
        rows.append(LeafRow(block0, nblocks, n, stride, member0, nmem))
        block0 += nblocks
        member0 += nmem
    return rows


def walk_rows(rows: Sequence[LeafRow], members: Sequence[torch.Tensor],
              block: int = KERNEL_BLOCK) -> List[torch.Tensor]:
    """The plain version of the kernel's addressing: each leaf of the
    table in its block layout ``[nblocks, block]``, every value read from
    the member and offset where the kernel finds it (0 in the padding)."""
    out = []
    for row in rows:
        mats = torch.stack([t.reshape(-1) for t in
                            members[row.member0:row.member0 + row.nmem]])
        v = torch.arange(row.nblocks * block)
        if row.stride % block == 0:
            mem = v // block // (row.stride // block)
            off = v - mem * row.stride
        else:
            mem, off = v // row.n, v % row.n
        ok = (mem < row.nmem) & (off < row.n) & (off < mats.shape[1])
        vals = mats[torch.where(ok, mem, 0), torch.where(ok, off, 0)]
        out.append(torch.where(ok, vals, torch.zeros_like(vals))
                   .reshape(-1, block))
    return out


class _Table:
    """What one launch walks, on the device: a row per leaf (``LeafRow``
    and its state's pointers) and the g and out (u, or p) pointer of
    every member. Built once; ``point`` refreshes the member pointers
    each step with one small host-to-device copy, and skips it when they
    have not moved (gradients are new tensors every step, but the caching
    allocator tends to put them where they were). It holds the state's
    pointers, not its tensors: its users build it again when the state's
    storage moves (``_state_key``), as it does each step under
    ``offload``, whose device copies must be freed after the update."""

    def __init__(self, leaves, dtype: torch.dtype, dev: torch.device,
                 names=(), out: Optional[Mapping[str, torch.Tensor]] = None):
        """``leaves``: ``(JAX shape, members, QTensor m, QTensor v)`` each,
        the members being examples of g's (and out's) tensors; ``names``:
        each leaf's parameter names, for ``members``; ``out``: the named
        tensors that every step writes (the params, fused), if fixed."""
        if dtype not in _DTYPES:
            raise TypeError(f"adam8bit kernels take bf16 or fp32, got "
                            f"{dtype}")
        self.dtype, self.dev = dtype, dev
        self.names = [(ns, tuple(shape))
                      for ns, (shape, *_) in zip(names, leaves)]
        self.n = []  # values of each member
        specs = []
        for shape, members, qm, qv in leaves:
            members = _members(members, shape)
            specs.append((tuple(shape), len(members), members[0].numel()))
            self.n += [members[0].numel()] * len(members)
        self.rows = leaf_rows(specs)
        table = []
        rows = iter(self.rows)
        for (shape, nmem, _), (_, _, qm, qv) in zip(specs, leaves):
            own = [next(rows) for _ in range(_row_count(shape, nmem))]
            nblocks = sum(row.nblocks for row in own)
            # The kernel indexes a leaf's blocks, a member's values and a
            # straddling leaf's values in 32 bits.
            if any((row.nblocks * KERNEL_BLOCK >= 2 ** 31 - KERNEL_BLOCK
                    and row.stride % KERNEL_BLOCK)
                   or row.n >= 2 ** 31 - KERNEL_BLOCK
                   or row.nblocks >= 2 ** 31 for row in own):
                raise ValueError(f"adam8bit leaf {shape} is too large")
            for t, dt, elems in ((qm.q, torch.int8, KERNEL_BLOCK),
                                 (qv.q, torch.int8, KERNEL_BLOCK),
                                 (qm.scale, torch.float32, 1),
                                 (qv.scale, torch.float32, 1)):
                if (t.dtype != dt or t.device != dev or not t.is_contiguous()
                        or t.data_ptr() % 16
                        or t.numel() != nblocks * elems):
                    raise ValueError(
                        f"adam8bit state {tuple(t.shape)} {t.dtype} does "
                        f"not match a leaf {shape} of {nblocks} blocks "
                        f"(contiguous, 16-byte aligned, on {dev})")
            for row in own:
                # A chunk's state: its blocks of the leaf's.
                b = row.block0 - own[0].block0
                table.append(list(row) + [
                    qm.q.data_ptr() + b * KERNEL_BLOCK,
                    qm.scale.data_ptr() + 4 * b,
                    qv.q.data_ptr() + b * KERNEL_BLOCK,
                    qv.scale.data_ptr() + 4 * b])
        self.nblocks = self.rows[-1].block0 + self.rows[-1].nblocks
        self.zeros = None  # what a member without a gradient reads
        nmem = len(self.n)
        self._pinned = [torch.empty((2, nmem), dtype=torch.int64,
                                    pin_memory=True) for _ in range(2)]
        self._copied = [torch.cuda.Event(), torch.cuda.Event()]
        self._turn, self._last = 0, None
        self.ptrs = torch.empty((2, nmem), dtype=torch.int64, device=dev)
        host = torch.tensor(table, dtype=torch.int64).pin_memory()
        self.leaves = host.to(dev, non_blocking=True)
        self._table_host = host  # read by that copy; kept alive with it
        self.out = None if out is None else self.members(out)

    def members(self, named: Mapping[str, Optional[torch.Tensor]]):
        """The member tensors of ``named`` in the table's order (None for
        a name without a tensor)."""
        out = []
        for names, shape in self.names:
            ts = [named.get(n) for n in names]
            if ts[0] is None and len(ts) == 1 and _chunked(shape):
                out += [None] * shape[0]
            else:
                out += _members(ts, shape)
        return out

    def point(self, g: Sequence[Optional[torch.Tensor]],
              out: Sequence[torch.Tensor]):
        """Each member's g (None: a zero gradient) and out tensor."""
        need = max((n for t, n in zip(g, self.n) if t is None), default=0)
        if need and (self.zeros is None or self.zeros.numel() < need):
            self.zeros = torch.zeros(need, dtype=self.dtype, device=self.dev)
        zero = self.zeros.data_ptr() if need else 0
        ptrs = [zero if t is None else t.data_ptr() for t in g]
        ptrs += [t.data_ptr() for t in out]
        if ptrs == self._last:
            return
        for t, n in zip(list(g) + list(out), self.n + self.n):
            if t is not None and (t.dtype != self.dtype or t.device != self.dev
                                  or t.numel() != n or not t.is_contiguous()):
                raise ValueError(
                    f"adam8bit takes contiguous {self.dtype} tensors of "
                    f"the params' shapes on {self.dev}; got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}")
        k, self._turn = self._turn, 1 - self._turn
        # The copy that last read this staging buffer must be done.
        self._copied[k].synchronize()
        self._pinned[k].view(-1).numpy()[:] = ptrs
        self.ptrs.copy_(self._pinned[k], non_blocking=True)
        self._copied[k].record()
        self._last = ptrs

    def launch(self, fused: bool, bc: torch.Tensor, hp: _Hyper):
        if hp.block != KERNEL_BLOCK:
            raise ValueError(f"adam8bit kernels take block_size "
                             f"{KERNEL_BLOCK}, got {hp.block}")
        if bc.dtype != torch.float32 or bc.device != self.dev or \
                bc.numel() != 2:
            raise ValueError("bc must be fp32 [bc1, bc2] on the params' "
                             "device")
        counter = "adam8_fused" if fused else "adam8"
        entry = getattr(_lib(), f"{counter}_{_DTYPES[self.dtype]}")
        err = entry(
            self.leaves.data_ptr(), len(self.rows), self.nblocks,
            self.ptrs[0].data_ptr(), self.ptrs[1].data_ptr(), bc.data_ptr(),
            -hp.lr, hp.b1 / 127.0, 1.0 - hp.b1, hp.b2, 1.0 - hp.b2,
            1.0 - hp.lr * hp.wd, hp.eps,
            torch.cuda.current_stream(self.dev).cuda_stream)
        if err:
            raise RuntimeError(f"{counter} failed to launch: CUDA error "
                               f"{err}")
        LAUNCHES[counter] += 1


# ------------------------------------------------------- wrappers


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no adam8bit kernel for device {t.device}")
    return False


def _leaf(members: Sequence[torch.Tensor], shape) -> torch.Tensor:
    if len(members) == 1:
        return members[0].reshape(shape)
    return torch.stack(list(members)).reshape(shape)


def _plain_blocks(g, qm: QTensor, qv: QTensor, bc, shape, hp: _Hyper,
                  p=None):
    """``_adam8_plain`` on a leaf's members, in block layout."""
    blocks = lambda x: _blocks_of(_leaf(x, shape), hp.block)  # noqa: E731
    return _adam8_plain(
        bc, blocks(g), qm.q.reshape(-1, hp.block), qm.scale.reshape(-1),
        qv.q.reshape(-1, hp.block), qv.scale.reshape(-1), lr=hp.lr,
        b1=hp.b1, b2=hp.b2, eps=hp.eps, wd=hp.wd,
        pb=None if p is None else blocks(p))


def _plain_leaf(g, qm: QTensor, qv: QTensor, bc, shape, hp: _Hyper, p=None):
    """A leaf through the plain version, the state updated in place;
    returns the output of each member."""
    out, mq, msc, sq, ssc = _plain_blocks(g, qm, qv, bc, shape, hp, p)
    for dst, src in ((qm.q, mq), (qm.scale, msc), (qv.q, sq),
                     (qv.scale, ssc)):
        dst.copy_(src.reshape(dst.shape))
    out = _unblocks(out, shape, hp.block)
    if len(g) == 1:
        return [out.reshape(g[0].shape)]
    return [o.reshape(t.shape)
            for o, t in zip(out.reshape(len(g), -1).unbind(0), g)]


def adam8_update(g: Sequence[torch.Tensor], qm: QTensor, qv: QTensor, bc,
                 shape, hp: _Hyper) -> List[torch.Tensor]:
    """One leaf through ``_adam8_kernel``: the update of each member of
    ``g`` (one tensor, or one per layer of a stacked leaf of JAX shape
    ``shape``), in g's dtype; ``qm``, ``qv`` are updated in place."""
    if _on_cpu(g[0]):
        return _plain_leaf(g, qm, qv, bc, shape, hp)
    u = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in g]
    table = _Table([(shape, g, qm, qv)], g[0].dtype, g[0].device)
    table.point(_members(g, shape), _members(u, shape))
    table.launch(False, bc, hp)
    return u


def adam8_fused_update(g: Sequence[torch.Tensor], p: Sequence[torch.Tensor],
                       qm: QTensor, qv: QTensor, bc, shape, hp: _Hyper):
    """One leaf through ``_adam8_fused_kernel``: ``p <- p * (1 - lr * wd)
    + u`` for each member, in place, and the state in place."""
    for t in p:
        if not t.is_contiguous():
            raise ValueError("adam8bit updates params in place: they must "
                             "be contiguous")
    if _on_cpu(g[0]):
        with torch.no_grad():
            for t, new in zip(p, _plain_leaf(g, qm, qv, bc, shape, hp, p)):
                t.copy_(new)
        return
    table = _Table([(shape, p, qm, qv)], p[0].dtype, p[0].device)
    table.point(_members(g, shape), _members(p, shape))
    table.launch(True, bc, hp)


def kernel_and_plain(g, qm: QTensor, qv: QTensor, bc, shape, hp: _Hyper,
                     p=None):
    """The kernel (fused with ``p``) on copies of the state and params,
    and the plain version on the same inputs: ``(got, ref)``, each
    ``(out, mq, msc, sq, ssc)`` in block layout, for ``adam8_errors``."""
    ref = _plain_blocks(g, qm, qv, bc, shape, hp, p)
    km = QTensor(qm.q.clone(), qm.scale.clone())
    kv = QTensor(qv.q.clone(), qv.scale.clone())
    if p is None:
        out = adam8_update(g, km, kv, bc, shape, hp)
    else:
        out = [t.clone() for t in p]
        adam8_fused_update(g, out, km, kv, bc, shape, hp)
    got = (_blocks_of(_leaf(out, shape), hp.block),
           km.q.reshape(-1, hp.block), km.scale.reshape(-1),
           kv.q.reshape(-1, hp.block), kv.scale.reshape(-1))
    return got, ref


# ------------------------------------------------------- the optimizer


class Adam8bit:
    """Adam with int8 blockwise-quantized moments, unbound: what
    ``adam8bit(...)`` returns. ``auto_accelerate`` binds it to a module's
    named parameters (``takes_named_parameters``), which gives an
    ``Adam8bitOptimizer``. ``init`` and ``update`` are optax's contract
    over ``{name: tensor}`` dicts, with the state updated in place."""

    takes_named_parameters = True

    def __init__(self, hp: _Hyper):
        self.hp = hp
        self._betas: Dict[torch.device, torch.Tensor] = {}
        self._cache = None  # (key, update's tables)

    @staticmethod
    def leaves(params: Mapping[str, torch.Tensor]):
        """The JAX leaves of ``params`` (path -> ``JaxLeaf``); on a pipe
        rank, ``StageBlock``s of its stages (``convert.param_leaves``
        reads the global stage count from the parameters' layouts)."""
        # models.convert imports this module for the state's types.
        from dlrover_tpu_torch.models.convert import param_leaves

        return param_leaves(params)

    def init(self, params: Mapping[str, torch.Tensor], leaves=None
             ) -> Adam8bitState:
        """Zero moments of ``params``' JAX ``leaves`` (``leaves(params)``
        by default), each over its members (``local_shape``: a pipe
        rank's stages of a leaf quantized by stage keep their row dim,
        one stage too)."""
        dev = next(iter(params.values())).device
        if leaves is None:
            leaves = self.leaves(params)
        block = self.hp.block

        def zero(leaf):
            shape = leaf.local_shape
            qt = _quantize_leaf(torch.zeros(shape, device=dev), block)
            if _chunked(leaf.shape) and not _chunked(shape):
                qt = QTensor(qt.q.reshape(shape[0], -1, block),
                             qt.scale.reshape(shape[0], -1))
            return qt

        return Adam8bitState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m={k: zero(leaf) for k, leaf in leaves.items()},
            v={k: zero(leaf) for k, leaf in leaves.items()},
        )

    def update(self, grads: Mapping[str, torch.Tensor], state: Adam8bitState,
               params: Optional[Mapping[str, torch.Tensor]] = None,
               leaves=None
               ) -> Tuple[Dict[str, torch.Tensor], Adam8bitState]:
        """``(updates, state)``: one step through ``_adam8_kernel``, one
        launch over every leaf; ``weight_decay`` subtracts ``lr * wd * p``
        when ``params`` are given, outside the kernel, as the JAX package
        does. ``leaves``: the JAX leaves of ``grads`` (``leaves(grads)``
        by default)."""
        hp = self.hp
        with torch.no_grad():
            bc = self._advance(state)
            if leaves is None:
                leaves = self.leaves(grads)
            if _on_cpu(state.step):
                updates = self._run_plain(leaves, grads, state, params, bc)
            else:
                updates = {n: torch.empty(g.shape, dtype=g.dtype,
                                          device=g.device)
                           for n, g in grads.items()}
                for table in self.step_tables(grads, state, leaves):
                    table.point(table.members(grads),
                                table.members(updates))
                    table.launch(False, bc, hp)
            for name, un in updates.items():
                if hp.wd and params is not None:
                    p = params[name]
                    # JAX rounds the Python scalar to p's dtype first.
                    c = torch.tensor(hp.lr * hp.wd, dtype=p.dtype).item()
                    updates[name] = un - (c * p).to(un.dtype)
        return updates, state

    def step_tables(self, grads: Mapping[str, torch.Tensor],
                    state: Adam8bitState, leaves=None) -> List[_Table]:
        """``update``'s tables for ``grads``: built at the first call, and
        again when the grads' names, shapes or dtypes or the state's
        storage change."""
        key = (tuple((n, g.shape, g.dtype) for n, g in grads.items()),
               _state_key(state))
        if self._cache is None or self._cache[0] != key:
            self._cache = (key, _tables(
                self.leaves(grads) if leaves is None else leaves, grads,
                state))
        return self._cache[1]

    def __call__(self, named_parameters) -> "Adam8bitOptimizer":
        return Adam8bitOptimizer(self, named_parameters)

    def _advance(self, state: Adam8bitState) -> torch.Tensor:
        """Counts a step; returns the fp32 bias corrections [bc1, bc2].
        The int32 step is cast to fp32 inside the power's kernel (no copy
        kernel on the card), the same values as ``step.float()``."""
        dev = state.step.device
        state.step.add_(1)
        if dev not in self._betas:
            self._betas[dev] = torch.tensor([self.hp.b1, self.hp.b2],
                                            device=dev)
        return 1 - self._betas[dev] ** state.step

    def _run_plain(self, leaves, grads, state: Adam8bitState, params, bc,
                   fused: bool = False):
        """A step over ``leaves`` on the CPU, leaf by leaf through the
        plain version: in place on the state, and on the params when
        ``fused``; returns the updates when not. A parameter without a
        gradient steps with a zero one, as in JAX."""
        updates = {}
        for path, leaf in leaves.items():
            g = [grads[n] if grads.get(n) is not None
                 else torch.zeros_like(params[n]) for n in leaf.names]
            qm, qv = state.m[path], state.v[path]
            if fused:
                adam8_fused_update(g, [params[n] for n in leaf.names], qm,
                                   qv, bc, leaf.local_shape, self.hp)
                continue
            u = adam8_update(g, qm, qv, bc, leaf.local_shape, self.hp)
            updates.update(zip(leaf.names, u))
        return updates


def _state_key(state: Adam8bitState) -> tuple:
    """Where the state lies: a table built for it stays good while this
    does not change."""
    return tuple(t.data_ptr() for moment in (state.m, state.v)
                 for qt in moment.values() for t in qt)


def _tables(leaves, tensors: Mapping[str, torch.Tensor],
            state: Adam8bitState, fixed_out: bool = False) -> List[_Table]:
    """One table a dtype of ``tensors`` over ``leaves`` (path ->
    ``JaxLeaf``), in the leaves' order; ``fixed_out``: every step writes
    ``tensors`` (the params, fused)."""
    groups: Dict[torch.dtype, list] = {}
    for path, leaf in leaves.items():
        groups.setdefault(tensors[leaf.names[0]].dtype, []).append(
            (path, leaf))
    tables = []
    for dtype, items in groups.items():
        dev = tensors[items[0][1].names[0]].device
        tables.append(_Table(
            [(leaf.local_shape, [tensors[n] for n in leaf.names],
              state.m[path],
              state.v[path]) for path, leaf in items], dtype, dev,
            names=[leaf.names for _, leaf in items],
            out=tensors if fixed_out else None))
    return tables


class Adam8bitOptimizer:
    """``adam8bit`` bound to named parameters; ``update_and_apply(grads,
    params)`` is the train step's fused contract: one fused kernel launch
    over every leaf updates the params and the state in place. Its table
    is built at the first step, and again if the state is replaced. On a
    pipe rank the parameters are its stages and ends, and so are the
    leaves and the state (``Adam8bit.leaves``)."""

    def __init__(self, tx: Adam8bit, named_parameters):
        self.tx = tx
        self.params = dict(named_parameters)
        self._names = {id(p): n for n, p in self.params.items()}
        self._leaves = tx.leaves(self.params)
        self.state = tx.init(self.params, self._leaves)
        self._cache = None  # (key, the step's tables)

    @property
    def launches_per_step(self) -> int:
        """Kernel launches of one step: one a dtype of the params."""
        return len({p.dtype for p in self.params.values()})

    def update_and_apply(self, grads: Sequence[torch.Tensor],
                         params: Sequence[torch.Tensor]):
        named = {self._names[id(p)]: g for g, p in zip(grads, params)}
        with torch.no_grad():
            bc = self.tx._advance(self.state)
            if _on_cpu(self.state.step):
                self.tx._run_plain(self._leaves, named, self.state,
                                   self.params, bc, fused=True)
                return
            key = _state_key(self.state)
            if self._cache is None or self._cache[0] != key:
                for t in self.params.values():
                    if not t.is_contiguous():
                        raise ValueError("adam8bit updates params in place: "
                                         "they must be contiguous")
                self._cache = (key, _tables(self._leaves, self.params,
                                            self.state, fixed_out=True))
            for table in self._cache[1]:
                table.point(table.members(named), table.out)
                table.launch(True, bc, self.tx.hp)


def adam8bit(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8, weight_decay: float = 0.0,
             block_size: int = 256) -> Adam8bit:
    """Adam with int8 blockwise-quantized moments (JAX's defaults)."""
    return Adam8bit(_Hyper(learning_rate, b1, b2, eps, weight_decay,
                           block_size))
