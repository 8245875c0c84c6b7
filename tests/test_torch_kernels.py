"""The CUDA kernels of the port against their plain PyTorch versions,
and the check that holds them there.

``test_cuda_kernels_match_plain`` needs an NVIDIA card with ``nvcc`` (a
CUDA kernel has no CPU mode) and skips without one. The other tests run
on the CPU: they emulate a kernel's arithmetic in PyTorch, once right
and once with a wrong mask, and show that ``tile_rel_err`` passes the
first within ``TILE_REL_TOL`` and fails the second. The file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops import attention as port


def inputs(s, seed=0, b=2, h=2, d=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for _ in range(4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("causal,s", [(True, 128), (False, 96), (True, 200)])
def test_cuda_kernels_match_plain(cuda_device, causal, s):
    q, k, v, g = (torch.tensor(x).to(cuda_device, torch.bfloat16)
                  for x in inputs(s, seed=4))
    port.reset_launch_counts()
    o, lse = port.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = port._fwd_plain(q, k, v, causal)
    delta = port.attention_delta(o_ref, g)
    dq = port.flash_bwd_dq(q, k, v, g, lse_ref, delta, causal)
    dk, dv = port.flash_bwd_dkv(q, k, v, g, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert port.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                             "flash_bwd_dkv": 1}
    dq_ref = port._bwd_dq_plain(q, k, v, g, lse_ref, delta, causal)
    dk_ref, dv_ref = port._bwd_dkv_plain(q, k, v, g, lse_ref, delta, causal)
    for got, ref in zip((o, dq, dk, dv), (o_ref, dq_ref, dk_ref, dv_ref)):
        assert port.tile_rel_err(got, ref) <= port.TILE_REL_TOL
    assert (lse - lse_ref).abs().max().item() < 1e-3


# ------------------------------------------- the check, on the CPU

S_CHECK = 1024  # the main path's sequence length


def _bhsd(x):
    return x.float().transpose(1, 2)


def emulated_fwd(q, k, v, mask):
    """The forward kernel's arithmetic with ``mask`` as its causal mask:
    fp32 scores and softmax, P rounded to bf16 before P.V, O in bf16."""
    s = _bhsd(q) @ _bhsd(k).transpose(-1, -2) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~mask, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (p.bfloat16().float() @ _bhsd(v)) / l
    return o.transpose(1, 2).bfloat16()


def emulated_bwd(q, k, v, do, lse, delta, mask):
    """The dQ and dK/dV kernels' arithmetic with ``mask``: P and dS
    rounded to bf16 before their products, outputs in bf16."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _bhsd(q) @ _bhsd(k).transpose(-1, -2) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    dp = _bhsd(do) @ _bhsd(v).transpose(-1, -2)
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    dq = ds @ _bhsd(k) * scale
    dk = ds.transpose(-1, -2) @ _bhsd(q) * scale
    dv = p.bfloat16().float().transpose(-1, -2) @ _bhsd(do)
    return tuple(x.transpose(1, 2).bfloat16() for x in (dq, dk, dv))


def _wrong_masks():
    right = torch.ones(S_CHECK, S_CHECK, dtype=torch.bool).tril()
    late = right.clone()
    late[512:, 256:320] = False  # q tiles 8.. skip kv tile 4
    last = right.clone()
    last[-64:, :64] = False  # only the last q tile skips kv tile 0
    return {
        "late_q_tiles_skip_a_kv_tile": late,
        "last_q_tile_skips_a_kv_tile": last,
        "diagonal_masked": right.tril(-1),
        "one_future_key_seen": torch.ones_like(right).tril(1),
    }


@pytest.fixture(scope="module")
def check_case():
    """bf16 q, k, v, dO at the main path's S (batch 1, 2 heads), and the
    plain versions' outputs on them."""
    q, k, v, do = (torch.tensor(x).bfloat16()
                   for x in inputs(S_CHECK, seed=7, b=1))
    o, lse = port._fwd_plain(q, k, v, True)
    delta = port.attention_delta(o, do)
    dq = port._bwd_dq_plain(q, k, v, do, lse, delta, True)
    dk, dv = port._bwd_dkv_plain(q, k, v, do, lse, delta, True)
    return (q, k, v, do, lse, delta), {"o": o, "dq": dq, "dk": dk, "dv": dv}


def _emulated(case, mask):
    (q, k, v, do, lse, delta), _ = case
    dq, dk, dv = emulated_bwd(q, k, v, do, lse, delta, mask)
    return {"o": emulated_fwd(q, k, v, mask), "dq": dq, "dk": dk, "dv": dv}


def test_check_passes_kernel_rounding(check_case):
    """The kernels' one departure from the plain versions, bf16 P and dS
    operands, stays well inside the limit."""
    right = torch.ones(S_CHECK, S_CHECK, dtype=torch.bool).tril()
    got, refs = _emulated(check_case, right), check_case[1]
    for name, ref in refs.items():
        assert port.tile_rel_err(got[name], ref) <= port.TILE_REL_TOL / 2, \
            name


@pytest.mark.parametrize("outputs", [("o",), ("dq",), ("dk", "dv")],
                         ids=["fwd", "dq", "dkv"])
@pytest.mark.parametrize("wrong", sorted(_wrong_masks()))
def test_check_rejects_wrong_kernel(check_case, wrong, outputs):
    got, refs = _emulated(check_case, _wrong_masks()[wrong]), check_case[1]
    worst = max(port.tile_rel_err(got[n], refs[n]) for n in outputs)
    assert worst > 2 * port.TILE_REL_TOL


def test_tile_rel_err_ragged_and_tile_local():
    """S not a multiple of the tile is padded, not dropped; an error in
    one tile is not diluted by the others."""
    ref = torch.ones(2, 100, 3, 64)
    got = ref.clone()
    assert port.tile_rel_err(got, ref) == 0.0
    got[1, 99, 2, 0] += 8.0  # the ragged last tile holds 36 rows
    assert port.tile_rel_err(got, ref) == pytest.approx(
        8.0 / math.sqrt(36 * 64))
