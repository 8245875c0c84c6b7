"""Flash attention (forward + backward) on hand-written Hopper kernels.

Counterpart of ``dlrover_tpu/ops/attention.py``. The public layout is the
models' ``[batch, seq, heads, head_dim]``. Three kernels, in
``ops/csrc/flash_attn.cu``, replace the three Pallas TPU kernels:

- ``flash_fwd``: online-softmax attention, writes O and the row
  logsumexp (``_fwd_kernel``);
- ``flash_bwd_dq``: dQ, one pass over the kv tiles (``_bwd_dq_kernel``);
- ``flash_bwd_dkv``: dK and dV, one pass over the q tiles
  (``_bwd_dkv_kernel``).

Each wrapper launches its kernel for a CUDA tensor, or raises; it takes
the plain PyTorch version beside it (``_fwd_plain``, ``_bwd_dq_plain``,
``_bwd_dkv_plain``) only for a tensor on the CPU. The plain versions
repeat the TPU kernels' arithmetic in fp32 and are the kernels' oracle.
The kernels take bf16 with head_dim 64 (GPT-2) or 128 (LLaMA), each
width a kernel of its own with a launch counter of its own
(``flash_fwd`` and ``flash_fwd_d128``, ...), and read the inputs through
their strides (through TMA maps built from them); their tiles are their
own (128 x 128 forward, 128 kv x 64 q dK/dV, 128 q x 64 kv dQ), whatever
``block_q``/``block_k`` say.

The causal mask is the kernels': rows >= cols, aligned top-left. The
JAX package's ``reference_attention`` aligns it bottom-right instead;
the two agree only when Sq == Sk, which is always so in the models.
"""

import ctypes
import math
from typing import Tuple

import torch

_NEG_INF = -1e30
#: The head_dims the CUDA kernels are built for, and the suffix of each
#: width's kernels (their C entries and launch counters).
HEAD_DIMS = {64: "", 128: "_d128"}
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

#: Launches of each kernel since the last ``reset_launch_counts()``; a
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {k + sfx: 0 for sfx in HEAD_DIMS.values() for k in KERNELS}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def reference_attention(q, k, v, causal: bool = True):
    """Einsum softmax attention — the numerics oracle of the model path.

    q, k, v: [B, S, H, D]; returns [B, S, H, D]. The causal mask is the
    kernels' (top-left aligned).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        logits = logits.masked_fill(
            ~_causal_mask(q.shape[1], k.shape[1], q.device), _NEG_INF
        )
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril()


# ------------------------------------------------------- plain versions


def _scores_plain(q, k, causal):
    """fp32 scaled scores with the kernels' causal mask (-1e30), and the
    mask (None when not causal)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if not causal:
        return s, None
    mask = _causal_mask(q.shape[1], k.shape[1], q.device)
    return s.masked_fill(~mask, _NEG_INF), mask


def _fwd_plain(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (O [B,S,H,D] in q's dtype,
    logsumexp [B,H,S] fp32)."""
    s, mask = _scores_plain(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (p @ v.float().transpose(1, 2)) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype), lse


def _ds_plain(q, k, v, do, lse, delta, causal):
    """P recomputed from the logsumexp, and dS = P * (dO V^T - delta)."""
    s, mask = _scores_plain(q, k, causal)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def _bwd_dq_plain(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """Plain version of the dQ kernel."""
    _, ds = _ds_plain(q, k, v, do, lse, delta, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def _bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool):
    """Plain version of the dK/dV kernel."""
    p, ds = _ds_plain(q, k, v, do, lse, delta, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float() * scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


#: A kernel's output may differ from its plain version's by at most this
#: share of the reference, in the Frobenius norm of every 64-row tile.
TILE_REL_TOL = 1e-2
#: ... and its fp32 logsumexp by at most this, element by element.
LSE_TOL = 1e-3


def tile_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest ``||got - ref|| / ||ref||`` (Frobenius) over the 64-row
    tiles along S of each (batch, head) of a ``[B, S, H, D]`` output.

    Taken tile by tile, the error of a kernel that mishandles a few
    tiles (a dropped kv tile, a mask off by one) is not averaged away by
    the rest; relative to each tile's own size, it does not depend on
    how large the values of other rows are.
    """
    b, s, h, d = ref.shape
    tile = 64  # the kernels' tile
    pad = (0, 0, 0, 0, 0, -s % tile)
    diff = torch.nn.functional.pad(got.float() - ref.float(), pad)
    ref = torch.nn.functional.pad(ref.float(), pad)
    num = diff.reshape(b, -1, tile, h, d).square().sum((2, 4))
    den = ref.reshape(b, -1, tile, h, d).square().sum((2, 4))
    return (num / den.clamp_min(1e-30)).sqrt().max().item()


# ------------------------------------------------------- CUDA kernels

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_STRIDES, _FLOAT = ctypes.POINTER(ctypes.c_longlong), ctypes.c_float
_TAIL = [_INT] * 5 + [_STRIDES, _FLOAT, _INT, _PTR]
_SIGNATURES = {
    f"{kernel}{sfx}_bf16": [_PTR] * n + _TAIL
    for sfx in HEAD_DIMS.values()
    for kernel, n in zip(KERNELS, (5, 7, 8))
}


def kernel_name(kernel: str, head_dim: int) -> str:
    """The launch counter of ``kernel`` ("flash_fwd", ...) at this
    head_dim: ``flash_fwd`` at 64, ``flash_fwd_d128`` at 128."""
    return kernel + HEAD_DIMS[head_dim]


def entry_name(kernel: str, head_dim: int) -> str:
    """The C entry of ``kernel`` at this head_dim."""
    return kernel_name(kernel, head_dim) + "_bf16"


def _lib():
    from dlrover_tpu_torch.ops.build import load_library

    return load_library("flash_attn", _SIGNATURES)


def _check(q, k, v):
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"flash attention kernels take bfloat16, got {t.dtype}"
            )
        if t.dim() != 4 or t.shape[-1] not in HEAD_DIMS:
            raise ValueError(
                f"flash attention kernels take [B, S, H, D] with D in "
                f"{sorted(HEAD_DIMS)}, got {tuple(t.shape)}"
            )
        if t.device != q.device:
            raise ValueError("q, k and v must be on one device")
    b, _, h, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2] != h
            or k.shape[3] != d):
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}"
        )


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read 16-byte rows: head_dim stride 1, other strides
    positive multiples of 8 elements, a 16-byte aligned base. Their TMA
    maps also want each of H, S, B to step over the whole extent of the
    dimension inside it (a view of a fused qkv tensor does). Copy
    otherwise."""
    nested = all(size == 1 or outer >= inner * inner_size
                 for size, outer, inner, inner_size in (
                     (t.shape[2], t.stride(2), 1, t.shape[3]),
                     (t.shape[1], t.stride(1), t.stride(2), t.shape[2]),
                     (t.shape[0], t.stride(0), t.stride(1), t.shape[1])))
    if (t.stride(-1) != 1 or any(s <= 0 or s % 8 for s in t.stride()[:3])
            or t.data_ptr() % 16 or not nested):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _strides(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launcher(entry: str, q, k, tensors, causal: bool):
    """The C entry bound to these tensors' pointers and strides and the
    current stream: each call launches the kernel with no further host
    work (and counts nothing), or raises."""
    b, sq, h, d = q.shape
    fn = getattr(_lib(), entry)
    args = (*[t.data_ptr() for t in tensors["ptrs"]],
            b, h, sq, k.shape[1], d, _strides(*tensors["strided"]),
            1.0 / math.sqrt(d), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{entry} failed to launch: CUDA error {err}")

    return launch


def _launch(kernel: str, q, k, tensors, causal: bool):
    """Launches ``kernel``'s form for q's head_dim and counts it."""
    d = q.shape[-1]
    with torch.cuda.device(q.device):
        _launcher(entry_name(kernel, d), q, k, tensors, causal)()
    LAUNCHES[kernel_name(kernel, d)] += 1


def _fwd_cuda(q, k, v, causal):
    _check(q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, sq, h, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k, {
        "ptrs": (q, k, v, o, lse), "strided": (q, k, v, o),
    }, causal)
    return o, lse


def _bwd_inputs(q, k, v, do, lse, delta):
    _check(q, k, v)
    _check(q, do, do)
    for t in (lse, delta):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != (q.shape[0], q.shape[2], q.shape[1])):
            raise ValueError("lse and delta must be contiguous fp32 [B,H,S]")
    return _aligned(q), _aligned(k), _aligned(v), _aligned(do)


def _bwd_dq_cuda(q, k, v, do, lse, delta, causal):
    q, k, v, do = _bwd_inputs(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_bwd_dq", q, k, {
        "ptrs": (q, k, v, do, lse, delta, dq),
        "strided": (q, k, v, do, dq),
    }, causal)
    return dq


def _bwd_dkv_cuda(q, k, v, do, lse, delta, causal):
    q, k, v, do = _bwd_inputs(q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("flash_bwd_dkv", q, k, {
        "ptrs": (q, k, v, do, lse, delta, dk, dv),
        "strided": (q, k, v, do, dk, dv),
    }, causal)
    return dk, dv


# ------------------------------------------------------- wrappers


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no flash attention for device {t.device}")
    return False


def flash_fwd(q, k, v, causal: bool = True):
    """(O, logsumexp [B,H,S] fp32): the forward kernel on CUDA tensors,
    its plain version on CPU tensors."""
    if _on_cpu(q):
        return _fwd_plain(q, k, v, causal)
    return _fwd_cuda(q, k, v, causal)


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dQ from the forward's logsumexp and delta = rowsum(dO * O)."""
    if _on_cpu(q):
        return _bwd_dq_plain(q, k, v, do, lse, delta, causal)
    return _bwd_dq_cuda(q, k, v, do, lse, delta, causal)


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """(dK, dV) from the forward's logsumexp and delta."""
    if _on_cpu(q):
        return _bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    return _bwd_dkv_cuda(q, k, v, do, lse, delta, causal)


def attention_delta(o, do) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B,H,S] — the cheap elementwise
    term the backward kernels read (plain PyTorch, as it was XLA)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's ``custom_vjp``):
    saves q, k, v, O and the logsumexp; backward runs dQ and dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = attention_delta(o, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_k: int = 512):
    """Flash attention over [B, S, H, D] inputs (differentiable).

    ``block_q``/``block_k`` are the JAX package's TPU tile hints, kept
    so model configs carry over; the CUDA kernels choose their own.
    """
    del block_q, block_k
    return FlashAttentionFunction.apply(q, k, v, causal)
