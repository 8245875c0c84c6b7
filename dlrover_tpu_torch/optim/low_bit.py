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

Each wrapper (``adam8_update``, ``adam8_fused_update``) launches its
kernel for CUDA tensors, or raises; it takes the plain version
``_adam8_plain`` (the Pallas body op for op, in fp32) only for tensors
on the CPU.

**Layout.** The state is the JAX package's, leaf for leaf: one entry per
leaf of the JAX GPT's params tree, keyed by the leaf's path
(``models/convert.jax_leaves``; stacked layers, as ``scan_layers=True``
gives). A stacked ``[L, ...]`` leaf of rank >= 3 quantizes per layer
(``_chunked``); any other leaf is flattened whole, so the blocks of a
stacked bias ``[L, 3d]`` straddle layers. The kernels walk a chunked
leaf's layers through a table of pointers, one launch per leaf; the
flat leaves that span several parameters (the stacked biases and norms,
about 1M of GPT-2 xl's 1.56B values) are gathered into one buffer and,
fused, scattered back.

**In place.** Unlike optax, ``update`` and ``update_and_apply`` update
the state's tensors (and, fused, the parameters) in place: a second
copy of the state would cost as much memory as the state saves.
"""

import ctypes
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

#: Elements of a quantization block in the CUDA kernels (32 lanes x 8).
KERNEL_BLOCK = 256
#: Layers of a chunked leaf one launch walks (the kernel's pointer table).
MAX_SEGMENTS = 64

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
_PTRS = ctypes.POINTER(ctypes.c_void_p)
# g pointers, out pointers, segments, segment numel, blocks per segment,
# bc, mq, msc, sq, ssc, seven fp32 scalars, stream.
_SIGNATURE = [_PTRS, _PTRS, _INT, _LL, _INT] + [_PTR] * 5 + [_F] * 7 + [_PTR]
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_SIGNATURES = {f"adam8_{form}{dt}": _SIGNATURE
               for form in ("", "fused_") for dt in _DTYPES.values()}


def _lib():
    from dlrover_tpu_torch.ops.build import load_library

    return load_library("adam8bit", _SIGNATURES)


def _segments(members: Sequence[torch.Tensor], shape) -> List[torch.Tensor]:
    """The 1-D segments a launch walks: one per layer of a chunked leaf,
    else the whole leaf (gathered when it spans several tensors)."""
    if _chunked(shape):
        if len(members) == 1:
            return list(members[0].reshape(shape[0], -1).unbind(0))
        return [t.reshape(-1) for t in members]
    if len(members) == 1:
        return [members[0].reshape(-1)]
    return [torch.cat([t.reshape(-1) for t in members])]


def _launch(fused: bool, g_segs, out_segs, qm: QTensor, qv: QTensor, bc,
            hp: _Hyper):
    dtype, dev = g_segs[0].dtype, g_segs[0].device
    if dtype not in _DTYPES:
        raise TypeError(f"adam8bit kernels take bf16 or fp32, got {dtype}")
    if hp.block != KERNEL_BLOCK:
        raise ValueError(f"adam8bit kernels take block_size {KERNEL_BLOCK}, "
                         f"got {hp.block}")
    n = g_segs[0].numel()
    per = -(-n // KERNEL_BLOCK)  # blocks per segment
    for t in list(g_segs) + list(out_segs):
        if (t.dtype != dtype or t.device != dev or t.numel() != n
                or not t.is_contiguous()):
            raise ValueError("adam8bit segments must be contiguous, of one "
                             "dtype, device and size")
    for t, dt in ((qm.q, torch.int8), (qv.q, torch.int8),
                  (qm.scale, torch.float32), (qv.scale, torch.float32)):
        if (t.dtype != dt or t.device != dev or not t.is_contiguous()
                or t.data_ptr() % 8):
            raise ValueError(f"adam8bit state must be contiguous, aligned "
                             f"{dt} on {dev}")
    if (qm.q.numel() != len(g_segs) * per * KERNEL_BLOCK
            or qv.q.shape != qm.q.shape
            or qm.scale.numel() != len(g_segs) * per
            or qv.scale.shape != qm.scale.shape):
        raise ValueError(f"adam8bit state {tuple(qm.q.shape)} does not match "
                         f"{len(g_segs)} x {n} values")
    if bc.dtype != torch.float32 or bc.device != dev or bc.numel() != 2:
        raise ValueError("bc must be fp32 [bc1, bc2] on the params' device")
    entry = getattr(_lib(), f"adam8_{'fused_' if fused else ''}"
                            f"{_DTYPES[dtype]}")
    counter = "adam8_fused" if fused else "adam8"
    scalars = (-hp.lr, hp.b1 / 127.0, 1.0 - hp.b1, hp.b2, 1.0 - hp.b2,
               1.0 - hp.lr * hp.wd, hp.eps)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s0 in range(0, len(g_segs), MAX_SEGMENTS):
            s1 = min(s0 + MAX_SEGMENTS, len(g_segs))
            rows = s0 * per
            g_ptrs = (ctypes.c_void_p * (s1 - s0))(
                *[t.data_ptr() for t in g_segs[s0:s1]])
            o_ptrs = (ctypes.c_void_p * (s1 - s0))(
                *[t.data_ptr() for t in out_segs[s0:s1]])
            err = entry(
                g_ptrs, o_ptrs, s1 - s0, n, per, bc.data_ptr(),
                qm.q.data_ptr() + rows * KERNEL_BLOCK,
                qm.scale.data_ptr() + rows * 4,
                qv.q.data_ptr() + rows * KERNEL_BLOCK,
                qv.scale.data_ptr() + rows * 4,
                *scalars, stream,
            )
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
    return [o.reshape(t.shape) for o, t in zip(out.unbind(0), g)]


def adam8_update(g: Sequence[torch.Tensor], qm: QTensor, qv: QTensor, bc,
                 shape, hp: _Hyper) -> List[torch.Tensor]:
    """One leaf through ``_adam8_kernel``: the update of each member of
    ``g`` (one tensor, or one per layer of a stacked leaf of JAX shape
    ``shape``), in g's dtype; ``qm``, ``qv`` are updated in place."""
    if _on_cpu(g[0]):
        return _plain_leaf(g, qm, qv, bc, shape, hp)
    if len(g) > 1 and not _chunked(shape):  # one gathered segment
        buf = torch.empty(sum(t.numel() for t in g), dtype=g[0].dtype,
                          device=g[0].device)
        _launch(False, _segments(g, shape), [buf], qm, qv, bc, hp)
        return [x.view(t.shape)
                for x, t in zip(buf.split([t.numel() for t in g]), g)]
    u = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in g]
    _launch(False, _segments(g, shape), _segments(u, shape), qm, qv, bc, hp)
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
    segs = _segments(p, shape)
    _launch(True, _segments(g, shape), segs, qm, qv, bc, hp)
    if len(p) > 1 and not _chunked(shape):  # a gathered copy: scatter back
        with torch.no_grad():
            torch._foreach_copy_(list(p), [
                x.view(t.shape)
                for x, t in zip(segs[0].split([t.numel() for t in p]), p)])


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

    @staticmethod
    def leaves(params: Mapping[str, torch.Tensor]):
        """The JAX leaves of ``params`` (path -> ``JaxLeaf``)."""
        # models.convert imports this module for the state's types.
        from dlrover_tpu_torch.models.convert import jax_leaves

        return jax_leaves((n, tuple(p.shape)) for n, p in params.items())

    def init(self, params: Mapping[str, torch.Tensor]) -> Adam8bitState:
        dev = next(iter(params.values())).device
        leaves = self.leaves(params)
        zero = lambda leaf: _quantize_leaf(  # noqa: E731
            torch.zeros(leaf.shape, device=dev), self.hp.block)
        return Adam8bitState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m={k: zero(leaf) for k, leaf in leaves.items()},
            v={k: zero(leaf) for k, leaf in leaves.items()},
        )

    def update(self, grads: Mapping[str, torch.Tensor], state: Adam8bitState,
               params: Optional[Mapping[str, torch.Tensor]] = None
               ) -> Tuple[Dict[str, torch.Tensor], Adam8bitState]:
        """``(updates, state)``: one step through ``_adam8_kernel``;
        ``weight_decay`` subtracts ``lr * wd * p`` when ``params`` are
        given, outside the kernel, as the JAX package does."""
        return self.run(self.leaves(grads), grads, state, params,
                        fused=False), state

    def __call__(self, named_parameters) -> "Adam8bitOptimizer":
        return Adam8bitOptimizer(self, named_parameters)

    def run(self, leaves, grads, state: Adam8bitState, params, fused: bool):
        """One step over ``leaves``: in place on the state, and on the
        params when ``fused``; returns the updates when not. A parameter
        without a gradient steps with a zero one, as in JAX."""
        hp = self.hp
        dev = state.step.device
        with torch.no_grad():
            state.step.add_(1)
            if dev not in self._betas:
                self._betas[dev] = torch.tensor([hp.b1, hp.b2], device=dev)
            bc = 1 - self._betas[dev] ** state.step.float()
            updates = {}
            for path, leaf in leaves.items():
                g = [grads[n] if grads.get(n) is not None
                     else torch.zeros_like(params[n]) for n in leaf.names]
                qm, qv = state.m[path], state.v[path]
                if fused:
                    adam8_fused_update(g, [params[n] for n in leaf.names],
                                       qm, qv, bc, leaf.shape, hp)
                    continue
                u = adam8_update(g, qm, qv, bc, leaf.shape, hp)
                for name, un in zip(leaf.names, u):
                    if hp.wd and params is not None:
                        p = params[name]
                        # JAX rounds the Python scalar to p's dtype first.
                        c = torch.tensor(hp.lr * hp.wd, dtype=p.dtype).item()
                        un = un - (c * p).to(un.dtype)
                    updates[name] = un
        return updates


class Adam8bitOptimizer:
    """``adam8bit`` bound to named parameters; ``update_and_apply(grads,
    params)`` is the train step's fused contract: one fused kernel pass
    per JAX leaf updates the params and the state in place."""

    def __init__(self, tx: Adam8bit, named_parameters):
        self.tx = tx
        self.params = dict(named_parameters)
        self._names = {id(p): n for n, p in self.params.items()}
        self._leaves = tx.leaves(self.params)
        self.state = tx.init(self.params)

    @property
    def launches_per_step(self) -> int:
        """Kernel launches of one step: one a leaf, or one every
        ``MAX_SEGMENTS`` layers of a chunked leaf."""
        return sum(-(-leaf.shape[0] // MAX_SEGMENTS)
                   if _chunked(leaf.shape) else 1
                   for leaf in self._leaves.values())

    def update_and_apply(self, grads: Sequence[torch.Tensor],
                         params: Sequence[torch.Tensor]):
        named = {self._names[id(p)]: g for g, p in zip(grads, params)}
        self.tx.run(self._leaves, named, self.state, self.params, fused=True)


def adam8bit(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8, weight_decay: float = 0.0,
             block_size: int = 256) -> Adam8bit:
    """Adam with int8 blockwise-quantized moments (JAX's defaults)."""
    return Adam8bit(_Hyper(learning_rate, b1, b2, eps, weight_decay,
                           block_size))
