"""Ablations and phase clocks of the Hopper flash kernels, on the card.

Builds variants of ``csrc/flash_attn.cu``, each a list of text
replacements of the committed source, into libraries of their own, and
for each times the forward, dQ and dK/dV launches alone (100 launches
after 5) at GPT-2 124M's and GPT-2 xl's attention shapes (B*H 16*12 and
4*25, S 1024, D 64, bf16, causal) and the LLaMA preset's (B*H 4*16,
S 2048, D 128), beside their tile errors against the plain versions (``dq_serial``: dQ's products and its dS one after the
other, not overlapped). The variant ``clocks`` adds ``clock64()`` marks to the
forward's consumer warpgroups and prints where a warpgroup's clocks go,
per kv tile of the main loop and per item (the marks cost registers and
time of their own, so its ms are not the committed kernel's).

    python -m dlrover_tpu_torch.ops.flash_probe [variant ...]

Needs an NVIDIA card and nvcc; nothing runs on import.
"""

import ctypes
import json
import os
import shutil
import sys

import torch

from dlrover_tpu_torch.ops import attention as attn
from dlrover_tpu_torch.ops import build

# label: (batch, heads, seq, head_dim)
SHAPES = {"gpt2-124m": (16, 12, 1024, 64), "gpt2-xl": (4, 25, 1024, 64),
          "llama-2048": (4, 16, 2048, 128)}
SOURCES = build.CSRC  # the committed sources every variant starts from

_RR = ("  const int i = j * g + (j % 2 ? g - 1 - (int)blockIdx.x : "
       "(int)blockIdx.x);", "  const int i = j * g + (int)blockIdx.x;")


def _stages(committed, d128, ring, n):
    """A ring of ``n`` stages at D = 64 (the probe's head_dim)."""
    return (f"STAGES = D == 64 ? {committed} : {d128};  // {ring} ring",
            f"STAGES = D == 64 ? {n} : {d128};  // {ring} ring")


def _mark(k):
    return f"mark({k});\n"


def _turns(indent, issue):
    """The lines ``issue`` between waiting for this warpgroup's turn and
    passing it to the other."""
    return (issue, f"{indent}my_turn();\n{issue}{indent}pass_turn();\n")


# The two consumer warpgroups of the forward take turns to issue their
# products, through named barriers 3 and 4 (FlashAttention-3's
# ping-pong): warpgroup 0 first, and it takes warpgroup 1's last pass.
_TURNS = [
    ("    const uint32_t v_base = hopper::smem_addr(sV);\n",
     "    const uint32_t v_base = hopper::smem_addr(sV);\n"
     "    auto my_turn = [&] { hopper::named_sync(3 + wg, 2 * WG); };\n"
     "    auto pass_turn = [&] {\n"
     "      asm volatile(\"bar.arrive %0, %1;\" :: \"r\"(4 - wg), "
     "\"r\"(2 * WG) : \"memory\");\n    };\n"
     "    if (wg == 1) pass_turn();\n"),
    _turns("      ", "      hopper::wgmma_fence();\n"
           "      issue_qk<D>(s, q_addr, k_base + (tile % FWD_STAGES) * "
           "kFwdTile);\n"
           "      issue_pv<D>(o_acc, pa, v_base + pst * kFwdTile);\n"),
    _turns("        ", "        hopper::wgmma_fence();\n"
           "        issue_qk<D>(s, q_addr, k_base + st * kFwdTile);\n"
           "        issue_pv<D>(o_acc, pa, v_base + prev * kFwdTile);\n"),
    _turns("    ", "    hopper::wgmma_fence();\n"
           "    issue_pv<D>(o_acc, pa, v_base + pst * kFwdTile);\n"),
    ("    finish();\n  }\n}\n",
     "    finish();\n    if (wg == 0) my_turn();\n  }\n}\n"),
]


# dQ's loop over its kv tiles: S_t and dP_t issued with dQ += dS_{t-1}
# K_{t-1} (the committed kernel), and one after the other.
_DQ_OVERLAP = (
    "      // S_t and dP_t go out with dQ += dS_{t-1} K_{t-1}, and dS_t is\n"
    "      // computed while the second product runs.\n"
    "      wait_full(0);\n"
    "      hopper::wgmma_fence();\n"
    "      issue_s_dp(0);\n"
    "      hopper::wgmma_wait<0>();\n"
    "      hopper::fence_regs(s);\n"
    "      hopper::fence_regs(dp);\n"
    "      ds(0);\n"
    "      pack_ds();\n"
    "      for (int t = 1; t < n_mine; ++t) {\n"
    "        wait_full(t);\n"
    "        hopper::wgmma_fence();\n"
    "        issue_s_dp(t);\n"
    "        issue_dq(t - 1);\n"
    "        hopper::wgmma_wait<1>();  // S_t and dP_t are in\n"
    "        hopper::fence_regs(s);\n"
    "        hopper::fence_regs(dp);\n"
    "        ds(t);\n"
    "        hopper::fence_regs(dp);  // dS is done before the wait\n"
    "        hopper::wgmma_wait<0>();\n"
    "        hopper::fence_regs(acc);\n"
    "        release(t - 1);\n"
    "        pack_ds();\n"
    "      }\n"
    "      hopper::wgmma_fence();\n"
    "      issue_dq(n_mine - 1);\n"
    "      hopper::wgmma_wait<0>();\n"
    "      hopper::fence_regs(acc);\n"
    "      release(n_mine - 1);\n")
_DQ_SERIAL = (
    "      for (int t = 0; t < n_mine; ++t) {\n"
    "        wait_full(t);\n"
    "        hopper::wgmma_fence();\n"
    "        issue_s_dp(t);\n"
    "        hopper::wgmma_wait<0>();\n"
    "        hopper::fence_regs(s);\n"
    "        hopper::fence_regs(dp);\n"
    "        ds(t);\n"
    "        pack_ds();\n"
    "        hopper::wgmma_fence();\n"
    "        issue_dq(t);\n"
    "        hopper::wgmma_wait<0>();\n"
    "        hopper::fence_regs(acc);\n"
    "        release(t);\n"
    "      }\n")


# Each variant: (file, old text, new text) replacements, in order.
VARIANTS = {
    "committed": [],
    "round_robin": [("flash_attn.cu",) + _RR],
    "turns": [("flash_attn.cu",) + r for r in _TURNS],
    "fwd_stages_2": [("flash_attn.cu",) + _stages(4, 2, "K/V", 2)],
    "fwd_stages_3": [("flash_attn.cu",) + _stages(4, 2, "K/V", 3)],
    "dkv_stages_2": [("flash_attn.cu",) + _stages(3, 2, "Q/dO", 2)],
    "dq_stages_2": [("flash_attn.cu",) + _stages(4, 3, "K/V", 2)],
    "dq_serial": [("flash_attn.cu", _DQ_OVERLAP, _DQ_SERIAL)],
    "clocks": [("flash_attn.cu", old, new) for old, new in (
        ("namespace {\n\nconstexpr float NEG_INF",
         "__device__ unsigned long long g_clocks[32];\n"
         "namespace {\n\nconstexpr float NEG_INF"),
        ("    uint32_t pa[FBN / 16][4] = {};\n",
         "    uint32_t pa[FBN / 16][4] = {};\n"
         "    unsigned long long P[16] = {};\n"
         "    long long tc = clock64();\n"
         "    auto mark = [&](int k) {\n"
         "      const long long n = clock64();\n"
         "      P[k] += n - tc;\n"
         "      tc = n;\n"
         "    };\n"),
        ("      hopper::mbar_wait(q_full + qb, (j / FWD_QBUF) & 1);\n",
         "      " + _mark(0)
         + "      hopper::mbar_wait(q_full + qb, (j / FWD_QBUF) & 1);\n"),
        ("      hopper::wgmma_fence();\n"
         "      issue_qk<D>(s, q_addr, k_base + (tile % FWD_STAGES) * "
         "kFwdTile);",
         "      " + _mark(1) + "      hopper::wgmma_fence();\n"
         "      issue_qk<D>(s, q_addr, k_base + (tile % FWD_STAGES) * "
         "kFwdTile);"),
        ("      hopper::wgmma_wait<1>();  // S_0 is in; the last P V runs on\n"
         "      hopper::fence_regs(s);\n",
         "      hopper::wgmma_wait<1>();  // S_0 is in; the last P V runs on\n"
         "      hopper::fence_regs(s);\n      " + _mark(2)),
        ("                     col_off, Sk, causal);\n"
         "      hopper::fence_regs(s);\n      hopper::wgmma_wait<0>();\n"
         "      hopper::fence_regs(o_acc);\n",
         "                     col_off, Sk, causal);\n"
         "      hopper::fence_regs(s);\n      " + _mark(3)
         + "      hopper::wgmma_wait<0>();\n"
         "      hopper::fence_regs(o_acc);\n      " + _mark(4)),
        ("        finish();\n      }\n#pragma unroll\n",
         "        finish();\n      }\n      " + _mark(5) + "#pragma unroll\n"),
        ("      pack_p(s, pa);\n      for (int t = 1; t < n_kv; ++t) {",
         "      pack_p(s, pa);\n      " + _mark(6)
         + "      for (int t = 1; t < n_kv; ++t) {"),
        ("        hopper::wgmma_fence();\n"
         "        issue_qk<D>(s, q_addr, k_base + st * kFwdTile);\n"
         "        issue_pv<D>(o_acc, pa, v_base + prev * kFwdTile);\n",
         "        " + _mark(7) + "        hopper::wgmma_fence();\n"
         "        issue_qk<D>(s, q_addr, k_base + st * kFwdTile);\n"
         "        issue_pv<D>(o_acc, pa, v_base + prev * kFwdTile);\n"
         "        " + _mark(8)),
        ("        hopper::wgmma_wait<1>();  // S_t is in; P_{t-1} V_{t-1} "
         "runs on\n        hopper::fence_regs(s);\n",
         "        hopper::wgmma_wait<1>();  // S_t is in; P_{t-1} V_{t-1} "
         "runs on\n        hopper::fence_regs(s);\n        " + _mark(9)),
        ("        // The softmax is done before the wait, not moved below "
         "it.\n        hopper::fence_regs(s);\n"
         "        hopper::wgmma_wait<0>();\n"
         "        hopper::fence_regs(o_acc);\n",
         "        // The softmax is done before the wait, not moved below "
         "it.\n        hopper::fence_regs(s);\n        " + _mark(10)
         + "        hopper::wgmma_wait<0>();\n"
         "        hopper::fence_regs(o_acc);\n        " + _mark(11)),
        ("        pack_p(s, pa);\n      }\n      p_q0 = q0;",
         "        pack_p(s, pa);\n        " + _mark(12)
         + "        P[15] += 1;\n      }\n      P[14] += 1;\n"
         "      p_q0 = q0;"),
        ("    finish();\n  }\n}\n",
         "    finish();\n"
         "    if (threadIdx.x % WG == 0) {\n"
         "      for (int k = 0; k < 16; ++k) "
         "atomicAdd(&g_clocks[16 * wg + k], P[k]);\n    }\n  }\n}\n"),
        ('}  // extern "C"\n',
         "int flash_probe_clocks(unsigned long long* out) {\n"
         "  cudaError_t err = cudaMemcpyFromSymbol(out, g_clocks, "
         "sizeof(g_clocks));\n"
         "  if (err != cudaSuccess) return (int)err;\n"
         "  unsigned long long zero[32] = {};\n"
         "  return (int)cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));\n"
         "}\n\n"
         '}  // extern "C"\n'),
    )],
}
ITEM_PHASES = ["to the item", "Q/K/V waits", "issue, S wait", "softmax",
               "last P V wait", "epilogue", "zero O, pack P"]
TILE_PHASES = ["K/V waits", "issue", "S wait", "softmax", "P V wait",
               "rescale, pack"]


def variant_source(name: str) -> str:
    """A copy of csrc/ with the variant's replacements, under build/."""
    out = os.path.join(os.path.dirname(build.BUILD_DIR), "probe", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(SOURCES, out)
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(out, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not in {fname} once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return out


def time_ms(fn, iters=100, warmup=5):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def clocks(lib, fwd):
    buf = (ctypes.c_ulonglong * 32)()
    lib.flash_probe_clocks.argtypes = [ctypes.c_void_p]
    lib.flash_probe_clocks.restype = ctypes.c_int
    lib.flash_probe_clocks(ctypes.addressof(buf))  # zero
    for _ in range(10):
        fwd()
    torch.cuda.synchronize()
    if lib.flash_probe_clocks(ctypes.addressof(buf)):
        raise RuntimeError("reading the clocks failed")
    out = {}
    for wg in range(2):
        c = buf[16 * wg:16 * wg + 16]
        items, tiles = c[14], c[15]
        out[f"warpgroup {wg}"] = {
            "items": items // 10, "loop tiles": tiles // 10,
            "clocks an item": {n: round(c[i] / items) for i, n in
                               enumerate(ITEM_PHASES)},
            "clocks a loop tile": {n: round(c[7 + i] / tiles) for i, n in
                                   enumerate(TILE_PHASES)},
        }
    return out


def probe(name, inputs):
    build.CSRC = variant_source(name)
    build._LIBS.clear()
    _, _, ptxas = build.build("flash_attn")
    lib = attn._lib()
    res = {"ptxas": [ln.strip() for ln in ptxas.splitlines()
                     if "spill" in ln or "registers" in ln or "C75" in ln]}
    for label, (q, k, v, do) in inputs.items():
        o_ref, lse_ref = attn._fwd_plain(q, k, v, True)
        delta = attn.attention_delta(o_ref, do)
        o = torch.empty_like(q)
        lse = torch.empty_like(lse_ref)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        entry = lambda k_: attn.entry_name(k_, q.shape[-1])  # noqa: E731
        fwd = attn._launcher(entry("flash_fwd"), q, k, {
            "ptrs": (q, k, v, o, lse), "strided": (q, k, v, o)}, True)
        dkv = attn._launcher(entry("flash_bwd_dkv"), q, k, {
            "ptrs": (q, k, v, do, lse_ref, delta, dk, dv),
            "strided": (q, k, v, do, dk, dv)}, True)
        dq_ = attn._launcher(entry("flash_bwd_dq"), q, k, {
            "ptrs": (q, k, v, do, lse_ref, delta, dq),
            "strided": (q, k, v, do, dq)}, True)
        row = {"flash_fwd_ms": time_ms(fwd), "flash_bwd_dq_ms": time_ms(dq_),
               "flash_bwd_dkv_ms": time_ms(dkv)}
        dq_ref = attn._bwd_dq_plain(q, k, v, do, lse_ref, delta, True)
        dk_ref, dv_ref = attn._bwd_dkv_plain(q, k, v, do, lse_ref, delta,
                                             True)
        row["tile_rel_err"] = max(attn.tile_rel_err(a, r) for a, r in (
            (o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)))
        row["lse_err"] = (lse - lse_ref).abs().max().item()
        if name == "clocks" and q.shape[-1] == 64:
            row["clocks"] = clocks(lib, fwd)
        res[label] = row
    return res


def main(names):
    if not torch.cuda.is_available():
        print("flash_probe: CUDA is not available", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {label: tuple(
        torch.randn((b, s, h, d), generator=gen,
                    device="cuda").to(torch.bfloat16) for _ in range(4))
        for label, (b, h, s, d) in SHAPES.items()}
    for name in names or list(VARIANTS):
        print(name, json.dumps(probe(name, inputs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
