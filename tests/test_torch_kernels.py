"""The CUDA kernels of the port against their plain PyTorch versions,
and the checks that hold them there.

The ``gpu``-marked tests need an NVIDIA card with ``nvcc`` (a CUDA
kernel has no CPU mode) and skip without one. The other tests run on
the CPU: they emulate a kernel's arithmetic in PyTorch, once right and
once with a planted fault, and show that the check passes the first and
fails the second: ``tile_rel_err`` against ``TILE_REL_TOL`` and the
logsumexp against ``LSE_TOL`` for flash attention (a wrong mask, a V,
dO or K tile read with the wrong transpose flag, a logsumexp stored in
base 2, and the schedule faults an overlapped head_dim-128 loop can
make), ``adam8_errors`` against ``ADAM8_LIMITS`` for
the 8-bit Adam kernels (a neighbouring block's scale, the 0.5 floor
dropped, round half away from zero, weight decay dropped, the padded
tail in a block's absmax), and the kernel's exact bit tricks for the
int8 conversions and the floor, over every int8 and every tie. The file imports no JAX, so it also runs on
a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops import attention as port
from dlrover_tpu_torch.optim import low_bit as lowbit


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


def fused_views(q, k, v):
    """q, k and v as views of one [B, S, 3 H D] tensor, as the model's
    attention block passes them (row stride 3 H D)."""
    b, s, h, d = q.shape
    qkv = torch.cat([x.reshape(b, s, h * d) for x in (q, k, v)], dim=-1)
    return tuple(x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))


@pytest.mark.gpu
@pytest.mark.parametrize("causal,s,b,h,fused", [
    (True, 128, 2, 2, False),
    (False, 96, 2, 2, False),
    (True, 200, 2, 2, False),
    (True, 192, 2, 2, False),  # one 128-row block half empty
    (True, 1024, 4, 25, False),  # GPT-2 xl's B*H
    (True, 200, 2, 2, True),
    (True, 1024, 4, 25, True),
])
def test_cuda_kernels_match_plain(cuda_device, causal, s, b, h, fused):
    q, k, v, g = (torch.tensor(x).to(cuda_device, torch.bfloat16)
                  for x in inputs(s, seed=4, b=b, h=h))
    if fused:
        q, k, v = fused_views(q, k, v)
        assert q.stride(1) == 3 * h * 64 and port._aligned(q) is q
    _check_kernels(q, k, v, g, causal)


def _check_kernels(q, k, v, g, causal):
    """Each kernel of q's head_dim, launched once, against its plain
    version; no kernel of the other width runs."""
    port.reset_launch_counts()
    o, lse = port.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = port._fwd_plain(q, k, v, causal)
    delta = port.attention_delta(o_ref, g)
    dq = port.flash_bwd_dq(q, k, v, g, lse_ref, delta, causal)
    dk, dv = port.flash_bwd_dkv(q, k, v, g, lse_ref, delta, causal)
    torch.cuda.synchronize()
    d = q.shape[-1]
    assert port.LAUNCHES == {
        name: int(name in [port.kernel_name(k, d) for k in port.KERNELS])
        for name in port.LAUNCHES}
    dq_ref = port._bwd_dq_plain(q, k, v, g, lse_ref, delta, causal)
    dk_ref, dv_ref = port._bwd_dkv_plain(q, k, v, g, lse_ref, delta, causal)
    for got, ref in zip((o, dq, dk, dv), (o_ref, dq_ref, dk_ref, dv_ref)):
        assert port.tile_rel_err(got, ref) <= port.TILE_REL_TOL
    assert (lse - lse_ref).abs().max().item() < port.LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("causal,s,b,h,fused", [
    (True, 128, 2, 2, False),
    (False, 96, 2, 2, False),
    (True, 200, 2, 2, False),
    (True, 192, 2, 2, False),  # one 128-row block half empty
    (True, 1000, 3, 5, False),  # 120 items, fewer than the SMs
    (True, 2048, 4, 16, False),  # the LLaMA preset's attention
    (True, 200, 2, 2, True),
    (True, 128, 1, 1, False),  # one block, one item of one tile
    (False, 1000, 2, 4, False),
    (True, 2048, 1, 40, False),  # the forward's (b, h) in L2 groups
    (False, 2048, 1, 40, False),  # 25 and 15: a short last group
])
def test_cuda_d128_kernels_match_plain(cuda_device, causal, s, b, h, fused):
    """The head_dim 128 kernels (two 64-column panels a tile)."""
    q, k, v, g = (torch.tensor(x).to(cuda_device, torch.bfloat16)
                  for x in inputs(s, seed=5, b=b, h=h, d=128))
    if fused:
        q, k, v = fused_views(q, k, v)
        assert q.stride(1) == 3 * h * 128 and port._aligned(q) is q
    _check_kernels(q, k, v, g, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("causal,s,b,h", [
    (True, 2048, 1, 40),  # dK/dV's L2 groups of 22 and 18 (b, h)
    (False, 2048, 1, 40),  # 24 and 16
    (True, 8192, 1, 16),  # the preset's long row: groups of 4
    (True, 1000, 2, 4),  # a ragged S
    (False, 1000, 2, 4),
    (True, 900, 2, 3),  # the last kv tile's upper rows see no query
])
def test_cuda_d128_dkv_walk_writes_every_row(cuda_device, causal, s, b, h):
    """The head_dim-128 dK/dV kernel's walk over its items: dK and dV,
    filled with NaN before each launch, hold none after it (a dropped item
    fails even where the plain version's rows are zero), match the plain
    version, and come out bit for bit the same from a second launch."""
    q, k, v, g = (torch.tensor(x).to(cuda_device, torch.bfloat16)
                  for x in inputs(s, seed=6, b=b, h=h, d=128))
    o_ref, lse_ref = port._fwd_plain(q, k, v, causal)
    delta = port.attention_delta(o_ref, g)
    dk_ref, dv_ref = port._bwd_dkv_plain(q, k, v, g, lse_ref, delta, causal)
    outs = []
    for _ in range(2):
        dk = torch.full_like(k, float("nan"))
        dv = torch.full_like(v, float("nan"))
        port._launcher(port.entry_name("flash_bwd_dkv", 128), q, k, {
            "ptrs": (q, k, v, g, lse_ref, delta, dk, dv),
            "strided": (q, k, v, g, dk, dv)}, causal)()
        torch.cuda.synchronize()
        assert not dk.isnan().any() and not dv.isnan().any()
        outs.append((dk, dv))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert port.tile_rel_err(dk, dk_ref) <= port.TILE_REL_TOL
    assert port.tile_rel_err(dv, dv_ref) <= port.TILE_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("causal,s,b,h", [
    (True, 2048, 1, 40),  # dQ's L2 groups of 24 and 16 (b, h)
    (False, 2048, 1, 40),  # 25 and 15
    (True, 8192, 1, 16),  # the preset's long row: groups of 4
    (True, 1000, 2, 4),  # a ragged S
    (False, 1000, 2, 4),
    (True, 900, 2, 3),  # the last query tile's upper rows lie past S
    (True, 2048, 1, 1),  # one (b, h): 16 items, fewer than the SMs
])
def test_cuda_d128_dq_walk_writes_every_row(cuda_device, causal, s, b, h):
    """The head_dim-128 dQ kernel's walk over its items: dQ, filled with
    NaN before each launch, holds none after it (a dropped item fails
    even where the plain version's rows are zero), matches the plain
    version, and comes out bit for bit the same from a second launch."""
    q, k, v, g = (torch.tensor(x).to(cuda_device, torch.bfloat16)
                  for x in inputs(s, seed=8, b=b, h=h, d=128))
    o_ref, lse_ref = port._fwd_plain(q, k, v, causal)
    delta = port.attention_delta(o_ref, g)
    dq_ref = port._bwd_dq_plain(q, k, v, g, lse_ref, delta, causal)
    outs = []
    for _ in range(2):
        dq = torch.full_like(q, float("nan"))
        port._launcher(port.entry_name("flash_bwd_dq", 128), q, k, {
            "ptrs": (q, k, v, g, lse_ref, delta, dq),
            "strided": (q, k, v, g, dq)}, causal)()
        torch.cuda.synchronize()
        assert not dq.isnan().any()
        outs.append(dq)
    assert torch.equal(outs[0], outs[1])
    assert port.tile_rel_err(dq, dq_ref) <= port.TILE_REL_TOL


# ------------------------------------------- the check, on the CPU

S_CHECK = 1024  # the main path's sequence length
LOG2E = 1.4426950408889634


def _bhsd(x):
    return x.float().transpose(1, 2)


def _tiles_transposed(x):
    """[B, H, S, 64] with each 64 x 64 tile transposed: an MN-major B
    operand read with the wrong transpose flag."""
    b, h, s, d = x.shape
    return x.reshape(b, h, s // d, d, d).transpose(-1, -2).reshape(x.shape)


def _first_panel_twice(x):
    """[..., 128] read with its second 64-column panel taken from the
    first: a head_dim-128 operand whose descriptor does not step to the
    second panel."""
    return torch.cat([x[..., :64], x[..., :64]], dim=-1)


def _k_operand(k, fault):
    """K as the score products read it: "k_panel_not_stepped" leaves the
    K-major k-steps 4..7 in the first panel."""
    k = _bhsd(k)
    return _first_panel_twice(k) if fault == "k_panel_not_stepped" else k


def emulated_fwd(q, k, v, mask, fault=None):
    """The forward kernel's arithmetic with ``mask`` as its causal mask:
    fp32 scores and softmax, P rounded to bf16 before P.V, O in bf16;
    (O, logsumexp). ``fault`` "v_tile_transposed" reads V's tiles
    transposed, "lse_base2" stores the logsumexp in base 2; at head_dim
    128, "k_panel_not_stepped" (see ``_k_operand``) and "v_panel_lbo"
    reads V's second panel as its first (a wrong leading offset)."""
    s = _bhsd(q) @ _k_operand(k, fault).transpose(-1, -2) / math.sqrt(
        q.shape[-1])
    s = s.masked_fill(~mask, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    vt = _bhsd(v)
    if fault == "v_tile_transposed":
        vt = _tiles_transposed(vt)
    if fault == "v_panel_lbo":
        vt = _first_panel_twice(vt)
    o = (p.bfloat16().float() @ vt) / l
    lse = (m + torch.log(l)).squeeze(-1)
    if fault == "lse_base2":
        lse = lse * LOG2E
    return o.transpose(1, 2).bfloat16(), lse


FWD_TILE = 128  # the forward's kv tile and query rows of an item


def emulated_fwd_online(q, k, v, mask, fault=None):
    """The forward kernel's loop as it runs: 128-column kv tiles in order,
    a running max m and row sum l, O rescaled by each tile's correction
    exp(m_old - m_new) and P rounded to bf16 before P V; (O, logsumexp).
    Faults of an overlapped or ping-ponged loop: "corr_one_tile_late"
    rescales O by the previous tile's correction; "p_prev_with_v_cur"
    multiplies P_t with V_{t+1} (the last P with its own V);
    "rows_of_other_warpgroup" finishes the upper 64 rows of every 128-row
    item with the lower 64 rows' m and l."""
    s = _bhsd(q) @ _bhsd(k).transpose(-1, -2) / math.sqrt(q.shape[-1])
    vt = _bhsd(v)
    rows, cols = s.shape[-2:]
    m = torch.full(s.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros(s.shape[:-1] + (vt.shape[-1],))
    corr_prev = torch.zeros_like(m)  # the first tile's: exp(-1e30 - m)
    n = (cols + FWD_TILE - 1) // FWD_TILE
    for t in range(n):
        cols_t = slice(t * FWD_TILE, (t + 1) * FWD_TILE)
        seen = mask[:, cols_t]
        st = s[..., cols_t].masked_fill(~seen, -1e30)
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new).masked_fill(~seen, 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        v_t = t + 1 if fault == "p_prev_with_v_cur" and t + 1 < n else t
        pv = p.bfloat16().float() @ vt[..., v_t * FWD_TILE:(v_t + 1) *
                                        FWD_TILE, :]
        o = o * (corr_prev if fault == "corr_one_tile_late" else corr) + pv
        m, corr_prev = m_new, corr
    if fault == "rows_of_other_warpgroup":
        half = torch.arange(rows) % FWD_TILE >= FWD_TILE // 2
        other = torch.where(half, torch.arange(rows) - FWD_TILE // 2,
                            torch.arange(rows))
        m, l = m[..., other, :], l[..., other, :]
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = (m + torch.log(l)).squeeze(-1)
    return (o / l).transpose(1, 2).bfloat16(), lse


def emulated_bwd(q, k, v, do, lse, delta, mask, fault=None):
    """The dQ and dK/dV kernels' arithmetic with ``mask``: P and dS
    rounded to bf16 before their products, outputs in bf16. ``fault``
    "do_tile_transposed" reads dO's tiles transposed in dV += P^T dO,
    "k_tile_transposed" K's tiles transposed in dQ += dS K; at head_dim
    128, "k_panel_not_stepped" as in ``emulated_fwd``, "do_panel_lbo"
    and "k_panel_lbo" read dO's (dV) or K's (dQ) second panel as its
    first."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _bhsd(q) @ _k_operand(k, fault).transpose(-1, -2) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    dp = _bhsd(do) @ _bhsd(v).transpose(-1, -2)
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    kt = _bhsd(k)
    if fault == "k_tile_transposed":
        kt = _tiles_transposed(kt)
    if fault == "k_panel_lbo":
        kt = _first_panel_twice(kt)
    dq = ds @ kt * scale
    dk = ds.transpose(-1, -2) @ _bhsd(q) * scale
    dot = _bhsd(do)
    if fault == "do_tile_transposed":
        dot = _tiles_transposed(dot)
    if fault == "do_panel_lbo":
        dot = _first_panel_twice(dot)
    dv = p.bfloat16().float().transpose(-1, -2) @ dot
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


def _check_case(d):
    """bf16 q, k, v, dO at the main path's S (batch 1, 2 heads), and the
    plain versions' outputs on them."""
    q, k, v, do = (torch.tensor(x).bfloat16()
                   for x in inputs(S_CHECK, seed=7, b=1, d=d))
    o, lse = port._fwd_plain(q, k, v, True)
    delta = port.attention_delta(o, do)
    dq = port._bwd_dq_plain(q, k, v, do, lse, delta, True)
    dk, dv = port._bwd_dkv_plain(q, k, v, do, lse, delta, True)
    return (q, k, v, do, lse, delta), {"o": o, "lse": lse, "dq": dq,
                                       "dk": dk, "dv": dv}


@pytest.fixture(scope="module")
def check_case():
    return _check_case(64)


@pytest.fixture(scope="module")
def check_case_d128():
    return _check_case(128)


def _emulated(case, mask, fault=None):
    """The kernels' outputs on ``case``; the backward reads the plain
    logsumexp, or its base-2 form under the fault "lse_base2"."""
    (q, k, v, do, lse, delta), _ = case
    if fault == "lse_base2":
        lse = lse * LOG2E
    dq, dk, dv = emulated_bwd(q, k, v, do, lse, delta, mask, fault)
    o, lse_out = emulated_fwd(q, k, v, mask, fault)
    return {"o": o, "lse": lse_out, "dq": dq, "dk": dk, "dv": dv}


def _err_over_limit(name, got, ref):
    """An output's error as a multiple of its limit: LSE_TOL for the
    logsumexp (element by element), TILE_REL_TOL for the others."""
    if name == "lse":
        return (got - ref).abs().max().item() / port.LSE_TOL
    return port.tile_rel_err(got, ref) / port.TILE_REL_TOL


def test_check_passes_kernel_rounding(check_case):
    """The kernels' one departure from the plain versions, bf16 P and dS
    operands, stays well inside the limit."""
    _passes_rounding(check_case)


def test_check_passes_d128_kernel_rounding(check_case_d128):
    _passes_rounding(check_case_d128)


def _passes_rounding(case):
    right = torch.ones(S_CHECK, S_CHECK, dtype=torch.bool).tril()
    got, refs = _emulated(case, right), case[1]
    for name, ref in refs.items():
        assert _err_over_limit(name, got[name], ref) <= 0.5, name


_OUTPUTS = {"fwd": ("o",), "lse": ("lse",), "dq": ("dq",),
            "dkv": ("dk", "dv")}
# Faults of the Hopper design, each with the outputs it reaches: a V, dO
# or K tile read with the wrong transpose flag, and a logsumexp stored in
# base 2 (then read as natural by the backward).
_OPERAND_FAULTS = [("v_tile_transposed", "fwd"),
                   ("do_tile_transposed", "dkv"),
                   ("k_tile_transposed", "dq"),
                   ("lse_base2", "lse"), ("lse_base2", "dq"),
                   ("lse_base2", "dkv")]
_WRONG = [(w, o) for w in sorted(_wrong_masks())
          for o in ("fwd", "dq", "dkv")] + _OPERAND_FAULTS


@pytest.mark.parametrize("wrong,outputs", _WRONG,
                         ids=[f"{w}-{o}" for w, o in _WRONG])
def test_check_rejects_wrong_kernel(check_case, wrong, outputs):
    right = torch.ones(S_CHECK, S_CHECK, dtype=torch.bool).tril()
    masks = _wrong_masks()
    got = _emulated(check_case, masks.get(wrong, right),
                    None if wrong in masks else wrong)
    refs = check_case[1]
    worst = max(_err_over_limit(n, got[n], refs[n])
                for n in _OUTPUTS[outputs])
    assert worst > 2


# Faults of the head_dim-128 forms, each with the outputs it reaches: a
# K-major operand whose descriptor stays in the first 64-column panel,
# and an MN-major operand whose leading offset misses the second panel.
_PANEL_FAULTS = [("k_panel_not_stepped", "fwd"), ("k_panel_not_stepped",
                                                   "lse"),
                 ("k_panel_not_stepped", "dq"), ("k_panel_not_stepped",
                                                  "dkv"),
                 ("v_panel_lbo", "fwd"), ("do_panel_lbo", "dkv"),
                 ("k_panel_lbo", "dq")]


@pytest.mark.parametrize("wrong,outputs", _PANEL_FAULTS,
                         ids=[f"{w}-{o}" for w, o in _PANEL_FAULTS])
def test_check_rejects_wrong_d128_kernel(check_case_d128, wrong, outputs):
    right = torch.ones(S_CHECK, S_CHECK, dtype=torch.bool).tril()
    got = _emulated(check_case_d128, right, wrong)
    refs = check_case_d128[1]
    worst = max(_err_over_limit(n, got[n], refs[n])
                for n in _OUTPUTS[outputs])
    assert worst > 2


def test_check_passes_d128_online_rounding(check_case_d128):
    """The forward's tile-by-tile loop (running max and sum, bf16 P a
    tile) stays as far inside the limit as the one-pass emulation."""
    (q, k, v, _, _, _), refs = check_case_d128
    right = torch.ones(S_CHECK, S_CHECK, dtype=torch.bool).tril()
    o, lse = emulated_fwd_online(q, k, v, right)
    assert _err_over_limit("o", o, refs["o"]) <= 0.5
    assert _err_over_limit("lse", lse, refs["lse"]) <= 0.5


# Faults that an overlapped or ping-ponged head_dim-128 forward loop can
# make, each with the outputs it reaches.
_SCHEDULE_FAULTS = [("corr_one_tile_late", "fwd"),
                    ("p_prev_with_v_cur", "fwd"),
                    ("rows_of_other_warpgroup", "fwd"),
                    ("rows_of_other_warpgroup", "lse")]


@pytest.mark.parametrize("wrong,outputs", _SCHEDULE_FAULTS,
                         ids=[f"{w}-{o}" for w, o in _SCHEDULE_FAULTS])
def test_check_rejects_wrong_d128_schedule(check_case_d128, wrong, outputs):
    (q, k, v, _, _, _), refs = check_case_d128
    right = torch.ones(S_CHECK, S_CHECK, dtype=torch.bool).tril()
    o, lse = emulated_fwd_online(q, k, v, right, wrong)
    got = {"o": o, "lse": lse}
    worst = max(_err_over_limit(n, got[n], refs[n])
                for n in _OUTPUTS[outputs])
    assert worst > 2


DKV_ITEM, DKV_TILE = 128, 64  # dK/dV's kv rows an item, query rows a tile


def emulated_dkv_pipelined(q, k, v, do, lse, delta, fault=None):
    """The head_dim-128 dK/dV kernel's overlapped loop as it runs, causal:
    each 128-row kv item of each (b, h) as two warpgroups of 64 kv rows,
    each over the 64-row query tiles from the first one of its rows sees;
    tile t's P^T and dS^T (fp32, rounded to bf16) go into dV += P^T dO_t
    and dK += dS^T Q_t while tile t + 1's S^T forms and its P^T is
    computed. Faults of that pipeline: "do_of_next_tile" multiplies P^T_t
    with dO_{t+1} (the last tile's with its own); "delta_of_previous_tile"
    forms dS^T_t with the previous tile's delta (a warpgroup's first tile
    with its own); "rows_of_other_warpgroup" gives each item's upper 64 kv
    rows the lower 64 rows' dK and dV. (dK, dV) in bf16."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt, dot = (_bhsd(x) for x in (q, k, v, do))
    s_len = qt.shape[-2]
    n_q = -(-s_len // DKV_TILE)
    dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
    tile = lambda x, t: x[..., t * DKV_TILE:(t + 1) * DKV_TILE, :]  # noqa
    for lo in range(0, s_len, DKV_TILE):  # a warpgroup's kv rows
        rows = torch.arange(lo, min(lo + DKV_TILE, s_len))
        first = min(lo // DKV_TILE, n_q - 1)
        for t in range(first, n_q):
            cols = torch.arange(t * DKV_TILE, min((t + 1) * DKV_TILE, s_len))
            seen = cols[None, :] >= rows[:, None]
            s_t = kt[..., rows, :] @ tile(qt, t).transpose(-1, -2) * scale
            p = torch.exp(s_t - lse[..., None, cols]).masked_fill(~seen, 0.0)
            dp = vt[..., rows, :] @ tile(dot, t).transpose(-1, -2)
            t_delta = t - 1 if fault == "delta_of_previous_tile" and \
                t > first else t
            d_cols = cols - (t - t_delta) * DKV_TILE
            ds = (p * (dp - delta[..., None, d_cols])).bfloat16().float()
            t_do = t + 1 if fault == "do_of_next_tile" and t + 1 < n_q \
                else t
            do_t = tile(dot, t_do)[..., :len(cols), :]
            dv[..., rows, :] += p.bfloat16().float() @ do_t
            dk[..., rows, :] += ds @ tile(qt, t) * scale
    if fault == "rows_of_other_warpgroup":
        upper = torch.arange(s_len) % DKV_ITEM >= DKV_TILE
        other = torch.where(upper, torch.arange(s_len) - DKV_TILE,
                            torch.arange(s_len))
        dk, dv = dk[..., other, :], dv[..., other, :]
    return tuple(x.transpose(1, 2).bfloat16() for x in (dk, dv))


def test_check_passes_d128_pipelined_dkv_rounding(check_case_d128):
    """The dK/dV kernel's overlapped loop (a warpgroup's query tiles in
    order, bf16 P^T and dS^T a tile) stays as far inside the limit as the
    one-pass emulation."""
    (q, k, v, do, lse, delta), refs = check_case_d128
    dk, dv = emulated_dkv_pipelined(q, k, v, do, lse, delta)
    assert _err_over_limit("dk", dk, refs["dk"]) <= 0.5
    assert _err_over_limit("dv", dv, refs["dv"]) <= 0.5


# Faults that the overlapped head_dim-128 dK/dV loop can make, each with
# the output it reaches.
_DKV_SCHEDULE_FAULTS = [("do_of_next_tile", "dv"),
                        ("delta_of_previous_tile", "dk"),
                        ("rows_of_other_warpgroup", "dk"),
                        ("rows_of_other_warpgroup", "dv")]


@pytest.mark.parametrize("wrong,output", _DKV_SCHEDULE_FAULTS,
                         ids=[f"{w}-{o}" for w, o in _DKV_SCHEDULE_FAULTS])
def test_check_rejects_wrong_d128_dkv_schedule(check_case_d128, wrong,
                                               output):
    (q, k, v, do, lse, delta), refs = check_case_d128
    dk, dv = emulated_dkv_pipelined(q, k, v, do, lse, delta, wrong)
    got = {"dk": dk, "dv": dv}
    assert _err_over_limit(output, got[output], refs[output]) > 2


DQ_ITEM, DQ_TILE = 128, 64  # dQ's query rows an item, kv rows a tile


def emulated_dq_pipelined(q, k, v, do, lse, delta, fault=None):
    """The head_dim-128 dQ kernel's loop as it runs, causal: each 128-row
    query item of each (b, h) as two warpgroups of 64 rows, each with its
    rows' lse and delta read once for the item, over the 64-row kv tiles
    up to the last one its rows see; tile t's dS (fp32, rounded to bf16)
    goes into dQ += dS K_t. Faults of a loop whose lse and delta come from
    the item's buffer, or that runs a tile ahead: "rows_of_other_warpgroup"
    forms the upper 64 rows' dS with the lower 64 rows' lse and delta;
    "rows_of_previous_item" with the lse and delta of the query rows 128
    before (a buffer's rows left from the item before; the first item
    its own); "k_of_next_tile" adds dS_t K_{t+1} (the last tile's with its
    own K). dQ in bf16."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt, dot = (_bhsd(x) for x in (q, k, v, do))
    s_len = qt.shape[-2]
    src = torch.arange(s_len)  # the row whose lse and delta a row reads
    if fault == "rows_of_other_warpgroup":
        src = torch.where(src % DQ_ITEM >= DQ_TILE, src - DQ_TILE, src)
    if fault == "rows_of_previous_item":
        src = torch.where(src >= DQ_ITEM, src - DQ_ITEM, src)
    lse_r, delta_r = lse[..., src], delta[..., src]
    dq = torch.zeros_like(qt)
    tile = lambda x, t: x[..., t * DQ_TILE:(t + 1) * DQ_TILE, :]  # noqa
    for lo in range(0, s_len, DQ_TILE):  # a warpgroup's query rows
        rows = torch.arange(lo, min(lo + DQ_TILE, s_len))
        n_mine = lo // DQ_TILE + 1
        for t in range(n_mine):
            cols = torch.arange(t * DQ_TILE, min((t + 1) * DQ_TILE, s_len))
            seen = cols[None, :] <= rows[:, None]
            s_t = qt[..., rows, :] @ tile(kt, t).transpose(-1, -2) * scale
            p = torch.exp(s_t - lse_r[..., rows, None]).masked_fill(~seen,
                                                                   0.0)
            dp = dot[..., rows, :] @ tile(vt, t).transpose(-1, -2)
            ds = (p * (dp - delta_r[..., rows, None])).bfloat16().float()
            t_k = t + 1 if fault == "k_of_next_tile" and t + 1 < n_mine \
                else t
            dq[..., rows, :] += ds @ tile(kt, t_k)[..., :len(cols), :] * \
                scale
    return dq.transpose(1, 2).bfloat16()


def test_check_passes_d128_pipelined_dq_rounding(check_case_d128):
    """The dQ kernel's loop (a warpgroup's kv tiles in order, bf16 dS a
    tile) stays as far inside the limit as the one-pass emulation."""
    (q, k, v, do, lse, delta), refs = check_case_d128
    dq = emulated_dq_pipelined(q, k, v, do, lse, delta)
    assert _err_over_limit("dq", dq, refs["dq"]) <= 0.5


@pytest.mark.parametrize("wrong", ["rows_of_other_warpgroup",
                                   "rows_of_previous_item",
                                   "k_of_next_tile"])
def test_check_rejects_wrong_d128_dq_schedule(check_case_d128, wrong):
    (q, k, v, do, lse, delta), refs = check_case_d128
    dq = emulated_dq_pipelined(q, k, v, do, lse, delta, wrong)
    assert _err_over_limit("dq", dq, refs["dq"]) > 2


def test_tile_rel_err_ragged_and_tile_local():
    """S not a multiple of the tile is padded, not dropped; an error in
    one tile is not diluted by the others."""
    ref = torch.ones(2, 100, 3, 64)
    got = ref.clone()
    assert port.tile_rel_err(got, ref) == 0.0
    got[1, 99, 2, 0] += 8.0  # the ragged last tile holds 36 rows
    assert port.tile_rel_err(got, ref) == pytest.approx(
        8.0 / math.sqrt(36 * 64))


# ------------------------------------------- 8-bit Adam kernels

HP = lowbit._Hyper(lr=1e-2, b1=0.5, b2=0.999, eps=1e-8, wd=0.5, block=256)
TAIL = 100  # valid values in the case's last block


def adam8_case(dtype=torch.float32, seed=0):
    """One ragged leaf of 5 * 256 + TAIL values whose blocks hold what
    random data never hits: 0, an exact round-half tie of m (b1 = 0.5, a
    fresh block, m = g / 2, absmax 127: 2.5 -> 2); 1, all zeros; 2, a
    small |g| under a large one, so sqrt(v) rounds to 0 and the 0.5
    floor decides the update; 3-5, random values over a random state.
    fp32 params by default, so that weight decay (1 - lr * wd = 0.995)
    is many ulps: in bf16 it would be under one."""
    rng = np.random.default_rng(seed)
    n = 5 * 256 + TAIL
    g = rng.standard_normal(n).astype(np.float32)
    g[:256] = rng.integers(-40, 40, 256) * 2
    g[:4] = [254, 5, -5, 1]
    g[256:512] = 0.0
    g[512:768] = 1e-3
    g[512] = 1.0
    p = rng.standard_normal(n).astype(np.float32)
    m = rng.standard_normal((6, 256)).astype(np.float32) * 0.1
    s = np.abs(rng.standard_normal((6, 256))).astype(np.float32) * 0.3
    m[:3], s[:3] = 0.0, 0.0  # blocks 0-2 start fresh
    m[5, TAIL:], s[5, TAIL:] = 0.0, 0.0  # the padding stays zero
    qm = lowbit._quantize(torch.from_numpy(m), 256)
    qv = lowbit._quantize(torch.from_numpy(s), 256)
    bc = torch.tensor([1 - 0.5 ** 3, 1 - 0.999 ** 3])
    return (torch.from_numpy(g).to(dtype), torch.from_numpy(p).to(dtype),
            qm, qv, bc)


def cvt_i8_to_f32(q: np.ndarray) -> np.ndarray:
    """The kernel's int8 -> fp32: the byte x + 128 under 0x4B000000 is
    the float 2^23 + 128 + x; subtract 2^23 + 128 in fp32."""
    u = (q.astype(np.int8).view(np.uint8) ^ 0x80).astype(np.uint32)
    return (np.uint32(0x4B000000) | u).view(np.float32) - \
        np.float32(8388736.0)


def cvt_round_i8(x: np.ndarray) -> np.ndarray:
    """The kernel's round half to even into int8: the low byte of
    1.5 * 2^23 + x, added in round-to-nearest-even fp32."""
    y = x.astype(np.float32) + np.float32(12582912.0)
    return (y.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)


def cvt_floor_pos(y: np.ndarray):
    """The kernel's floor(y), y >= 0: 2^23 + y rounded down to fp32 (exact
    in float64, then down to the fp32 grid, whose step is 1 there);
    returns the float and the int8 in its low byte."""
    t = np.floor(y.astype(np.float64) + 8388608.0).astype(np.float32)
    return (t - np.float32(8388608.0),
            (t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8))


def emulated_adam8(bc, gb, mq, msc, sq, ssc, pb=None, fault=None,
                   fast_cvt=False):
    """The kernels' arithmetic on block-layout inputs, fp32 operation by
    operation, with one planted ``fault`` (or none); ``fast_cvt`` takes
    the kernel's bit tricks for the int8 conversions and the floor."""
    c = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    if fault == "neighbour_scale":  # a block reads the next block's scales
        msc, ssc = msc.roll(-1), ssc.roll(-1)
    g = gb.float()
    if fault == "tail_in_absmax":  # reads past the leaf's end
        g = g.clone()
        g.view(-1)[5 * 256 + TAIL:] = 3.0
    decay = 1.0 if fault == "no_weight_decay" else 1.0 - HP.lr * HP.wd
    sqrt_bc2 = torch.sqrt(bc[1])
    lr_eff = c(-HP.lr) * sqrt_bc2 / bc[0]
    eps_eff = c(HP.eps) * sqrt_bc2
    to_f32 = (lambda q: torch.from_numpy(  # noqa: E731
        cvt_i8_to_f32(q.numpy()))) if fast_cvt else (lambda q: q.float())
    m = to_f32(mq) * (msc[:, None] * c(HP.b1 / 127)) + c(1 - HP.b1) * g
    sp = to_f32(sq) * (ssc[:, None] / c(127.0))
    s = torch.sqrt(c(HP.b2) * sp * sp + c(1 - HP.b2) * g * g)
    amax_m = m.abs().amax(1, keepdim=True)
    amax_s = s.amax(1, keepdim=True)
    r_m = torch.where(amax_m == 0, c(1.0), c(127.0) / amax_m)
    r_s = torch.where(amax_s == 0, c(1.0), c(127.0) / amax_s)
    if fast_cvt:
        q2, sq2 = (torch.from_numpy(x) for x in cvt_floor_pos(
            (s * r_s + c(0.5)).numpy()))
    else:
        q2 = torch.floor(s * r_s + c(0.5))
        sq2 = q2.to(torch.int8)
    floor = c(0.0) if fault == "no_floor" else c(0.5)
    denom = torch.maximum(q2, floor) * (amax_s / c(127.0))
    u = lr_eff * m / (denom + eps_eff)
    out = u.to(gb.dtype) if pb is None else \
        (pb.float() * c(decay) + u).to(pb.dtype)
    x = m * r_m
    if fault == "roundf":  # half away from zero
        qm2 = (torch.sign(x) * torch.floor(x.abs() + c(0.5))).to(torch.int8)
    elif fast_cvt:
        qm2 = torch.from_numpy(cvt_round_i8(x.numpy()))
    else:
        qm2 = torch.round(x).to(torch.int8)
    return (out, qm2, amax_m.reshape(-1), sq2, amax_s.reshape(-1))


def plain_on_case(case, fused):
    g, p, qm, qv, bc = case
    blocks = lambda x: lowbit._blocks_of(x, 256)  # noqa: E731
    return (blocks(g), qm.q, qm.scale, qv.q, qv.scale,
            blocks(p) if fused else None), lowbit._adam8_plain(
        bc, blocks(g), qm.q, qm.scale, qv.q, qv.scale, lr=HP.lr, b1=HP.b1,
        b2=HP.b2, eps=HP.eps, wd=HP.wd,
        pb=blocks(p) if fused else None)


@pytest.mark.parametrize("fast_cvt", [False, True], ids=["cvt", "bits"])
@pytest.mark.parametrize("fused", [False, True], ids=["update", "fused"])
def test_adam8_check_passes_the_kernel_arithmetic(fused, fast_cvt):
    """The emulation without a fault is the plain version, bit for bit,
    with the conversions as instructions and as the kernel's bit tricks;
    the case's crafted blocks come out as designed."""
    (gb, mq, msc, sq, ssc, pb), ref = plain_on_case(adam8_case(), fused)
    got = emulated_adam8(torch.tensor([1 - 0.5 ** 3, 1 - 0.999 ** 3]),
                         gb, mq, msc, sq, ssc, pb, fast_cvt=fast_cvt)
    errs = lowbit.adam8_errors(got, ref)
    assert not lowbit.adam8_failures(errs), errs
    assert errs["max_abs_err"] == 0.0
    out, mq2, msc2, sq2, ssc2 = ref
    assert mq2[0, :4].tolist() == [127, 2, -2, 0]  # half to even
    assert msc2[1] == ssc2[1] == 0 and not mq2[1].any()  # zero block
    assert sq2[2, 1:].eq(0).all()  # the floor decides
    assert not mq2[5, TAIL:].any() and not sq2[5, TAIL:].any()


FAULTS = {
    "neighbour_scale": (False, True),
    "no_floor": (False, True),
    "roundf": (False, True),
    "tail_in_absmax": (False, True),
    "no_weight_decay": (True,),  # weight decay is inside the fused kernel
}


@pytest.mark.parametrize("fault,fused", [
    (f, fused) for f, forms in FAULTS.items() for fused in forms])
def test_adam8_check_rejects_a_faulty_kernel(fault, fused):
    (gb, mq, msc, sq, ssc, pb), ref = plain_on_case(adam8_case(), fused)
    got = emulated_adam8(torch.tensor([1 - 0.5 ** 3, 1 - 0.999 ** 3]),
                         gb, mq, msc, sq, ssc, pb, fault=fault)
    assert lowbit.adam8_failures(lowbit.adam8_errors(got, ref))


def test_adam8_int8_to_f32_bits_over_every_int8():
    q = np.arange(-128, 128, dtype=np.int8)
    got = cvt_i8_to_f32(q)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, q.astype(np.float32))


def test_adam8_round_bits_match_round_half_even():
    """Every tie k + 0.5 in [-127.5, 126.5], the integers, -0.0, values an
    ulp from a tie and random values in [-127, 127], as round half to
    even (torch.round, the plain version's) gives them."""
    k = np.arange(-128, 127, dtype=np.float32)
    ties = k + np.float32(0.5)
    near = np.concatenate([np.nextafter(ties, np.float32(-1e9)),
                           np.nextafter(ties, np.float32(1e9))])
    rnd = np.random.default_rng(0).uniform(-127, 127, 4096).astype(
        np.float32)
    x = np.concatenate([ties[1:], k[1:], near[2:-2], rnd,
                        np.array([-0.0, 1e-30, -1e-30], np.float32)])
    want = torch.round(torch.from_numpy(x)).to(torch.int8).numpy()
    np.testing.assert_array_equal(cvt_round_i8(x), want)
    assert cvt_round_i8(np.array([2.5, -2.5, 0.5, 1.5, 126.5], np.float32)
                        ).tolist() == [2, -2, 0, 2, 126]


def test_adam8_floor_bits_match_floor():
    """floor(y) for y = s * 127 / absmax + 0.5 in [0.5, 127.5]: at the
    integers, an ulp under and over them, and at random."""
    k = np.arange(1, 128, dtype=np.float32)
    y = np.concatenate([k, np.nextafter(k, np.float32(0)),
                        np.nextafter(k, np.float32(1e9)),
                        np.array([0.5, 127.5], np.float32),
                        np.random.default_rng(1).uniform(
                            0.5, 127.5, 4096).astype(np.float32)])
    f, byte = cvt_floor_pos(y)
    np.testing.assert_array_equal(f, np.floor(y))
    np.testing.assert_array_equal(byte, np.floor(y).astype(np.int8))


def test_adam8_ulp():
    x = torch.tensor([1.0, 1.5, -3.0, 0.0])
    assert lowbit._ulp(x).tolist() == [2 ** -23, 2 ** -23, 2 ** -22,
                                       torch.finfo(torch.float32).tiny]
    assert lowbit._ulp(x.bfloat16()).tolist()[:3] == [2 ** -7, 2 ** -7,
                                                      2 ** -6]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("fused", [False, True], ids=["update", "fused"])
def test_adam8_kernels_match_plain(cuda_device, dtype, fused):
    """Each kernel against the plain version, one launch a leaf: the
    crafted ragged leaf, a chunked stacked leaf (one tensor per layer),
    flat stacked leaves whose blocks straddle layers (walked in place;
    layers of 96 values, and of 37, which no 16-value lane divides), and
    a chunked leaf of 70 layers."""
    g, p, qm, qv, bc = (x.to(cuda_device) if isinstance(x, torch.Tensor)
                        else lowbit.QTensor(*(t.to(cuda_device) for t in x))
                        for x in adam8_case(dtype))
    rng = np.random.default_rng(9)
    layers = lambda shape, n: [  # noqa: E731
        torch.tensor(rng.standard_normal(shape), dtype=dtype,
                     device=cuda_device) for _ in range(n)]
    leaves = [([g], [p], qm, qv, tuple(g.shape))]
    for n, shape in ((3, (40, 70)), (3, (96,)), (7, (37,)), (70, (8, 40))):
        full = (n,) + shape
        state = lowbit._quantize_leaf(
            torch.tensor(rng.standard_normal(full), dtype=torch.float32,
                         device=cuda_device) * 0.1, 256)
        sq = lowbit._quantize_leaf(torch.zeros(full, device=cuda_device) +
                                   0.2, 256)
        leaves.append((layers(shape, n), layers(shape, n), state, sq, full))
    lowbit.reset_launch_counts()
    for gs, ps, m, v, shape in leaves:
        got, ref = lowbit.kernel_and_plain(gs, m, v, bc, shape, HP,
                                           p=ps if fused else None)
        torch.cuda.synchronize()
        errs = lowbit.adam8_errors(got, ref)
        assert not lowbit.adam8_failures(errs), (shape, errs)
    assert lowbit.LAUNCHES == {"adam8": 0 if fused else 5,
                               "adam8_fused": 5 if fused else 0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_adam8_one_launch_step_matches_plain(cuda_device, dtype):
    """The bound optimizer's whole step on the tiny GPT (its stacked
    biases and norms straddle layers) is one launch, and leaves the
    params and the state as the plain version does on the card from the
    same params, state and bias corrections, each element within
    ``ADAM8_LIMITS``; a second step too, with other gradient tensors
    (their pointers refreshed) and a parameter without a gradient."""
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig

    _one_launch_steps(GPT(GPTConfig.tiny(), device="cpu"), cuda_device,
                      dtype, "wpe.weight")


@pytest.mark.gpu
@pytest.mark.parametrize("repeats", [1, 2], ids=["gpipe", "circular"])
def test_adam8_one_launch_step_on_pipelined_leaves_matches_plain(
        cuda_device, repeats):
    """The same on a pipelined tiny GPT, whose ``[P, L/P, ...]`` leaves
    quantize a stage at a time with the stage's layers straddling its
    blocks: the kernel's table gives each stage a row of its own."""
    import dataclasses

    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = dataclasses.replace(GPTConfig.tiny(), num_layers=8,
                              pipeline_stages=2, pipeline_microbatches=2,
                              pipeline_repeats=repeats)
    name = ("pipeline.stages.1.blocks.2.ln1.bias" if repeats == 1
            else "pipeline.bank.1.0.blocks.1.ln1.bias")
    _one_launch_steps(GPT(cfg, device="cpu"), cuda_device, torch.bfloat16,
                      name)


def _one_launch_steps(model, cuda_device, dtype, dropped):
    """Two steps of the bound optimizer over ``model``'s parameters, the
    second without a gradient for ``dropped``, held leaf by leaf to the
    plain version."""
    rng = np.random.default_rng(3)
    params = {n: p.detach().to(device=cuda_device, dtype=dtype)
              for n, p in model.named_parameters()}
    opt = lowbit.adam8bit(1e-2, weight_decay=0.1)(params.items())
    hp = opt.tx.hp
    lowbit.reset_launch_counts()
    for step in range(2):
        grads = {n: torch.tensor(rng.standard_normal(p.shape) * 1e-2,
                                 dtype=dtype, device=cuda_device)
                 for n, p in params.items()
                 if not (step and n == dropped)}
        before = {n: p.clone() for n, p in params.items()}
        state = {path: tuple(lowbit.QTensor(qt.q.clone(), qt.scale.clone())
                             for qt in (opt.state.m[path], opt.state.v[path]))
                 for path in opt._leaves}
        names = [n for n in params if n in grads]
        opt.update_and_apply([grads[n] for n in names],
                             [params[n] for n in names])
        # The bias corrections the step used, computed the same way.
        bc = 1 - opt.tx._betas[opt.state.step.device] ** opt.state.step
        for path, leaf in opt._leaves.items():
            g = [grads[n] if n in grads else torch.zeros_like(params[n])
                 for n in leaf.names]
            ref = lowbit._plain_blocks(
                g, *state[path], bc, leaf.shape, hp,
                p=[before[n] for n in leaf.names])
            got = (lowbit._blocks_of(lowbit._leaf(
                [params[n] for n in leaf.names], leaf.shape), 256),) + tuple(
                t.reshape(-1, 256) if t.dtype == torch.int8 else t.reshape(-1)
                for qt in (opt.state.m[path], opt.state.v[path]) for t in qt)
            errs = lowbit.adam8_errors(got, ref)
            assert not lowbit.adam8_failures(errs), (step, path, errs)
    assert lowbit.LAUNCHES == {"adam8": 0, "adam8_fused": 2}
    assert opt.launches_per_step == 1


@pytest.mark.gpu
@pytest.mark.parametrize("repeats", [1, 2], ids=["gpipe", "circular"])
def test_adam8_fused_launch_over_a_pipe_ranks_rows(cuda_device, repeats):
    """Pipe rank 0 of 2 on a 4-stage tiny GPT: its optimizer binds its
    stages' parameters and its ends (``wte``, ``wpe``), its leaves are
    ``StageBlock``s of the global ones, and its state is stages [0, 2)'s
    rows of a whole model's state (views into it). One fused launch
    steps those rows as the plain version does on the card, leaf by
    leaf within ``ADAM8_LIMITS``, and leaves the rows of stages [2, 4)
    untouched, bit for bit."""
    import dataclasses

    from dlrover_tpu_torch.accel.sharding import Layout, set_layout
    from dlrover_tpu_torch.models.convert import param_leaves
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = dataclasses.replace(GPTConfig.tiny(), num_layers=8,
                              pipeline_stages=4, pipeline_microbatches=4,
                              pipeline_repeats=repeats)
    model = GPT(cfg, device="cpu")
    rng = np.random.default_rng(5)
    whole = {n: p.detach().to(device=cuda_device, dtype=torch.bfloat16)
             for n, p in model.named_parameters()}
    ours = ("wte.weight", "wpe")
    mine = {n: p for n, p in whole.items() if n in ours or any(
        n.startswith(f"pipeline.{k}.{s}.") for k in ("stages", "bank")
        for s in (0, 1))}
    stage = Layout(None, (None,), placed=(0,), stages=4)
    for n, p in mine.items():
        if n.startswith("pipeline."):
            set_layout(p, stage)
    tx = lowbit.adam8bit(1e-2, weight_decay=0.1)
    opt = tx(mine.items())
    # A whole model's state, random, and the rank's rows of it.
    full = tx.init(whole)
    for qt in list(full.m.values()) + list(full.v.values()):
        qt.q.copy_(torch.tensor(rng.integers(-127, 128, qt.q.shape),
                                dtype=torch.int8))
        qt.scale.copy_(torch.tensor(rng.uniform(0, 0.1, qt.scale.shape)))
    rows = {}
    for path, leaf in opt._leaves.items():
        if leaf.index is None:
            rows[path] = (full.m[path], full.v[path])
        else:
            lo, hi = leaf.index[0]
            assert (lo, hi) == (0, 2) and leaf.shape == param_leaves(
                whole)[path].shape
            rows[path] = tuple(lowbit.QTensor(qt.q[lo:hi], qt.scale[lo:hi])
                               for qt in (full.m[path], full.v[path]))
    assert set(rows) == set(opt.state.m)
    opt.state = lowbit.Adam8bitState(
        opt.state.step, {p: r[0] for p, r in rows.items()},
        {p: r[1] for p, r in rows.items()})
    others = {path: [t[2:].clone() for qt in (full.m[path], full.v[path])
                     for t in qt]
              for path, leaf in opt._leaves.items() if leaf.index}
    assert others
    grads = {n: torch.tensor(rng.standard_normal(p.shape) * 1e-2,
                             dtype=torch.bfloat16, device=cuda_device)
             for n, p in mine.items()}
    before = {n: p.clone() for n, p in mine.items()}
    state = {path: tuple(lowbit.QTensor(qt.q.clone(), qt.scale.clone())
                         for qt in r) for path, r in rows.items()}
    lowbit.reset_launch_counts()
    names = list(mine)
    opt.update_and_apply([grads[n] for n in names], [mine[n] for n in names])
    torch.cuda.synchronize()
    assert lowbit.LAUNCHES == {"adam8": 0, "adam8_fused": 1}
    bc = 1 - tx._betas[opt.state.step.device] ** opt.state.step
    for path, leaf in opt._leaves.items():
        shape = leaf.local_shape
        ref = lowbit._plain_blocks([grads[n] for n in leaf.names],
                                   *state[path], bc, shape, tx.hp,
                                   p=[before[n] for n in leaf.names])
        # The random moments reach the padding: its outputs are not kept.
        ref = (lowbit._blocks_of(lowbit._unblocks(ref[0], shape, 256),
                                 256),) + ref[1:]
        got = (lowbit._blocks_of(lowbit._leaf(
            [mine[n] for n in leaf.names], shape), 256),) + tuple(
            t.reshape(-1, 256) if t.dtype == torch.int8 else t.reshape(-1)
            for qt in rows[path] for t in qt)
        errs = lowbit.adam8_errors(got, ref)
        assert not lowbit.adam8_failures(errs), (path, errs)
    for path, rest in others.items():
        now = [t[2:] for qt in (full.m[path], full.v[path]) for t in qt]
        assert all(torch.equal(a, b) for a, b in zip(now, rest)), path
