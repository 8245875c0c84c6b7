"""Ablations and phase clocks of the Hopper flash kernels, on the card.

Builds variants of ``csrc/flash_attn.cu``, each a list of text
replacements of the committed source, into libraries of their own, and
for each times the forward, dQ and dK/dV launches alone (100 launches
after 5) at GPT-2 124M's and GPT-2 xl's attention shapes (B*H 16*12 and
4*25, S 1024, D 64, bf16, causal) and the LLaMA preset's two (B*H 4*16,
S 2048 and 1*16, S 8192, D 128), beside their tile errors against the
plain versions. What the head_dim-128 forward adds to the head_dim-64
loop is two switches of ``Fwd<D>`` (K_RELEASE, L2_GROUPS); the
``fwd128_*`` variants flip them at head_dim 128 (``fwd_l2_groups`` turns
the L2 groups on at head_dim 64), put back forms that were measured and
dropped (``fwd128_turns``: FlashAttention-3's ping-pong, the two
warpgroups issuing their products in strict turns through two
mbarriers, and ``turns`` the same at both head_dims;
``fwd128_bar_turns``: the turns through named barriers, which wait
without a time limit; ``fwd128_together``: the softmax after both
products, not under the warpgroup's own P V; ``fwd128_pv_first``: P V
issued and waited for before S; ``fwd128_few_chains``) or take the D-128
consumers' registers away (``fwd128_inline_trap``); ``fwd128_serial``
puts back the serial
head_dim-128 loop and item order the forward had before its ping-pong
(one product at a time inside a warpgroup, no turns), so the old and new
forms are timed in one call; ``fwd128_serial_l2`` is that loop in the
grouped order.
``dq_serial``: dQ's products and its dS one after the other, not
overlapped. The variant ``clocks`` adds ``clock64()`` marks to the
forward's consumer warpgroups and prints where a warpgroup's clocks go,
per kv tile of the main loop and per item, at both head_dims (the marks
cost registers and time of their own, so its ms are not the committed
kernel's). What the head_dim-128 dK/dV adds to the head_dim-64 one is
three switches of ``Dkv<D>`` (TRAP_OUT_OF_LINE, L2_GROUPS, OVERLAP) and
its ring (one K/V buffer, 4 Q/dO stages): ``dkv128_before`` is the form
before them, ``dkv128_inline_trap``, ``dkv128_snake`` and
``dkv128_serial`` turn each switch off alone, ``dkv128_two_kv``,
``dkv128_stages_3``, ``dkv128_two_kv_3`` and ``dkv128_two_kv_ahead``
try other rings, and the dropped forms are ``dkv128_split`` and
``dkv128_together`` (more of each tile under the last tile's products:
more registers than a consumer has) and ``dkv128_direct_store``;
``dkv128_clocks`` marks its consumers' phases at head_dim 128. What the
head_dim-128 dQ adds to the head_dim-64 one is five switches of
``Dq<D>`` (TRAP_OUT_OF_LINE, L2_GROUPS, STORE_APART, Q_HALVES, KV_LEAD)
and its ring (one Q/dO buffer, 4 K/V stages): ``dq128_before`` is the
form before them, ``dq128_after`` the committed one, each timed as
every ``dq128`` variant is, its dQ alone at the head_dim-128 shapes,
with its bits held to ``dq128_before``'s once that has run (name it
first); ``dq128_inline_trap``, ``dq128_snake``, ``dq128_store_in_q``,
``dq128_whole_q`` and ``dq128_lead_0`` turn each switch off alone,
``dq128_lead_3``, ``dq128_lead_4``, ``dq128_two_q`` (the old ring),
``dq128_one_q_4`` and ``dq128_one_q_5`` try other leads and rings, the
dropped forms are ``dq128_rows`` (lse and delta staged by the producer
warp), ``dq128_prefetch`` (the next item's Q and dO prefetched into the
L2 cache), ``dq128_tma_store`` (dQ out by TMA stores) and
``dq128_ahead`` (S_{t+1} and dP_{t+1} before dS_t, a second register
set), and ``dq128_clocks`` / ``dq128_before_clocks`` mark the new and
old forms' consumer phases. Each variant prints the highest register of
every kernel in its SASS. A variant named again in one run is timed
again, not built again; one that nvcc refuses prints its error.

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
          "llama-2048": (4, 16, 2048, 128),
          "llama-8192": (1, 16, 8192, 128)}
SOURCES = build.CSRC  # the committed sources every variant starts from

_RR = ("  const int i = j * g + (j % 2 ? g - 1 - (int)blockIdx.x : "
       "(int)blockIdx.x);", "  const int i = j * g + (int)blockIdx.x;")


def _stages(committed, d128, ring, n):
    """A ring of ``n`` stages at D = 64 (the probe's head_dim)."""
    return (f"STAGES = D == 64 ? {committed} : {d128};  // {ring} ring",
            f"STAGES = D == 64 ? {n} : {d128};  // {ring} ring")


def _switch(name, committed, value, trait="Fwd", kind="bool"):
    """One of the schedule switches of ``trait`` (``Fwd<D>`` or
    ``Dkv<D>``) set to ``value`` at both head_dims."""
    decl = f"  static constexpr {kind} {name} = "
    return ("flash_attn.cu", f"{decl}{committed};", f"{decl}{value};",
            f"struct {trait} {{\n")


def _dkv(name, value, committed="D == 128"):
    """A switch of ``Dkv<D>``: a bool, or with a number the ring's
    STAGES or KV_BUFS."""
    if isinstance(value, int):
        return _switch(name, committed, value, "Dkv", "int")
    return _switch(name, committed, value, "Dkv")


# The committed switches and ring of ``Dq<D>``; each dq128 variant names
# its departures from them.
DQ = {"TRAP_OUT_OF_LINE": "D == 128", "L2_GROUPS": "D == 128",
      "STORE_APART": "D == 128", "Q_HALVES": "D == 128",
      "KV_LEAD": "D == 64 ? 0 : 2", "Q_BUFS": "D == 64 ? 2 : 1",
      "STAGES": "4"}


def _dq(name, value):
    """A switch of ``Dq<D>`` set to ``value`` (keep D = 64's value in it:
    "D == 128", or "D == 64 ? 4 : 5" for a ring)."""
    kind = "int" if name in ("KV_LEAD", "Q_BUFS", "STAGES") else "bool"
    return _switch(name, DQ[name], value, "Dq", kind)


# PR 9's head_dim-128 forward loop: one product at a time inside a
# warpgroup (S = Q K^T, its softmax, then O += P V); it frees a stage's K
# and V together, after its P V.
_FWD128_SERIAL = (
    "    if constexpr (D == 128) {\n"
    "      int ring = 0;  // position in the K/V ring, across items\n"
    "      for (int j = 0, item; (item = snake_item(j, n_items)) >= 0; "
    "++j) {\n"
    "        const FwdItem it = item_at(item);\n"
    "        const int q0 = it.q_tile * FBM, n_kv = n_kv_of(q0);\n"
    "        const int qbuf = j % FWD_QBUF, row_lo = q0 + wg * 64;\n"
    "        const int row0 = row_lo + warp * 16 + lane / 4;\n"
    "        const uint32_t q_addr =\n"
    "            hopper::smem_addr(sQ + qbuf * kFwdTile + wg * 64 * "
    "ROW_BYTES);\n"
    "#pragma unroll\n"
    "        for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.0f;\n"
    "#pragma unroll\n"
    "        for (int i = 0; i < 2; ++i) {\n"
    "          m_run[i] = NEG_INF;\n"
    "          l_part[i] = 0.0f;\n"
    "        }\n"
    "        hopper::mbar_wait(q_full + qbuf, (j / FWD_QBUF) & 1);\n"
    "        for (int t = 0; t < n_kv; ++t, ++ring) {\n"
    "          const int st = ring % FWD_STAGES, k0 = t * FBN;\n"
    "          const uint32_t parity = (ring / FWD_STAGES) & 1;\n"
    "          hopper::mbar_wait(k_full + st, parity);\n"
    "          hopper::wgmma_fence();\n"
    "          issue_qk<D>(s, q_addr, k_base + st * kFwdTile);\n"
    "          hopper::wgmma_wait<0>();\n"
    "          hopper::fence_regs(s);\n"
    "          online_softmax(s, m_run, l_part, corr, scale_log2,\n"
    "                         k0 + FBN > Sk || (causal && k0 + FBN - 1 > "
    "row_lo),\n"
    "                         k0, row0, col_off, Sk, causal);\n"
    "#pragma unroll\n"
    "          for (int idx = 0; idx < D / 2; ++idx) {\n"
    "            o_acc[idx] *= corr[(idx / 2) % 2];\n"
    "          }\n"
    "          pack_p(s, pa);\n"
    "          hopper::mbar_wait(v_full + st, parity);\n"
    "          hopper::wgmma_fence();\n"
    "          issue_pv<D>(o_acc, pa, v_base + st * kFwdTile);\n"
    "          hopper::wgmma_wait<0>();\n"
    "          hopper::fence_regs(o_acc);\n"
    "          if (lane == 0) {\n"
    "            hopper::mbar_arrive(empty + st);\n"
    "            if (F::K_RELEASE) hopper::mbar_arrive(k_empty + st);\n"
    "          }\n"
    "        }\n"
    "        p_q0 = q0;\n"
    "        p_bh = it.bh;\n"
    "        p_qb = qbuf;\n"
    "#pragma unroll\n"
    "        for (int i = 0; i < 2; ++i) {\n"
    "          p_m[i] = m_run[i];\n"
    "          p_l[i] = l_part[i];\n"
    "        }\n"
    "        finish();\n"
    "      }\n"
    "      return;\n"
    "    }\n")
# The consumers' loop over their items.
_LOOP_START = ("      if (F::K_RELEASE && lane == 0) "
               "hopper::mbar_arrive(k_empty + st);\n    };\n"
               "    int tile = 0;\n")
# The end of the forward's consumer code.
_LAST_FINISH = "    finish();\n  }\n}\n"

# Fewer independent chains in the online softmax: maxima as four a row
# (not eight), sums as two (not four); fewer registers live under it.
_FEW_CHAINS = [("flash_attn.cu", old, new) for old, new in (
    ("  float mx[2][8];\n", "  float mx[2][4];\n"),
    ("    for (int c = 0; c < 8; ++c) mx[i][c] = m_run[i];\n",
     "    for (int c = 0; c < 4; ++c) mx[i][c] = m_run[i];\n"),
    ("    float& m = mx[(idx / 2) % 2][2 * ((idx / 4) % 4) + idx % 2];\n",
     "    float& m = mx[(idx / 2) % 2][2 * ((idx / 4) % 2) + idx % 2];\n"),
    ("    float m_new = fmaxf(fmaxf(fmaxf(mx[i][0], mx[i][1]),\n"
     "                              fmaxf(mx[i][2], mx[i][3])),\n"
     "                        fmaxf(fmaxf(mx[i][4], mx[i][5]),\n"
     "                              fmaxf(mx[i][6], mx[i][7])));\n",
     "    float m_new = fmaxf(fmaxf(mx[i][0], mx[i][1]),\n"
     "                        fmaxf(mx[i][2], mx[i][3]));\n"),
    ("  float sum[2][4] = {};\n", "  float sum[2][2] = {};\n"),
    ("    sum[i][2 * ((idx / 4) % 2) + idx % 2] += p;\n",
     "    sum[i][idx % 2] += p;\n"),
    ("                ((sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]))"
     ";\n",
     "                (sum[i][0] + sum[i][1]);\n"),
)]


# Reads and zeroes the phase clocks (a C entry of a clocks variant).
_READ_CLOCKS = ('}  // extern "C"\n',
                "int flash_probe_clocks(unsigned long long* out) {\n"
                "  cudaError_t err = cudaMemcpyFromSymbol(out, g_clocks, "
                "sizeof(g_clocks));\n"
                "  if (err != cudaSuccess) return (int)err;\n"
                "  unsigned long long zero[32] = {};\n"
                "  return (int)cudaMemcpyToSymbol(g_clocks, zero, "
                "sizeof(zero));\n"
                "}\n\n"
                '}  // extern "C"\n')
_CLOCK_SUMS = ("namespace {\n\nconstexpr float NEG_INF",
               "__device__ unsigned long long g_clocks[32];\n"
               "namespace {\n\nconstexpr float NEG_INF")
_MARK = ("    uint32_t P[16] = {};\n"
         "    long long tc = clock64();\n"
         "    auto mark = [&](int k) {\n"
         "      const long long n = clock64();\n"
         "      P[k] += (uint32_t)(n - tc);\n"
         "      tc = n;\n"
         "    };\n")

# Phase clocks of the forward's consumer warpgroups: 32-bit sums a thread
# (a block's launch is well under 2^32 clocks), read per warpgroup.
_CLOCKS = [
    _CLOCK_SUMS,
    ("    uint32_t pa[FBN / 16][4] = {};\n",
     "    uint32_t pa[FBN / 16][4] = {};\n" + _MARK),
    # per item
    ("      wait(q_full + qb, (j / FWD_QBUF) & 1);\n",
     "      mark(0);\n      wait(q_full + qb, (j / FWD_QBUF) & 1);\n"),
    ("      hopper::wgmma_fence();\n      issue_qk<D>(s, q_addr, k_base + (",
     "      mark(1);\n"
     "      hopper::wgmma_fence();\n      issue_qk<D>(s, q_addr, k_base + ("),
    ("      release_k(tile % FWD_STAGES);\n",
     "      release_k(tile % FWD_STAGES);\n      mark(2);\n"),
    ("                     col_off, Sk, causal);\n"
     "      hopper::fence_regs(s);\n      hopper::wgmma_wait<0>();\n"
     "      hopper::fence_regs(o_acc);\n",
     "                     col_off, Sk, causal);\n      mark(3);\n"
     "      hopper::fence_regs(s);\n      hopper::wgmma_wait<0>();\n"
     "      hopper::fence_regs(o_acc);\n      mark(4);\n"),
    ("        finish();\n      }\n#pragma unroll\n",
     "        finish();\n      }\n      mark(5);\n#pragma unroll\n"),
    ("      pack_p(s, pa);\n      for (int t = 1; t < n_kv; ++t) {",
     "      pack_p(s, pa);\n      mark(6);\n"
     "      for (int t = 1; t < n_kv; ++t) {"),
    # per kv tile of the loop
    ("        hopper::wgmma_fence();\n"
     "        issue_qk<D>(s, q_addr, k_base + st * kFwdTile);\n"
     "        issue_pv<D>(o_acc, pa, v_base + prev * kFwdTile);\n",
     "        mark(7);\n        hopper::wgmma_fence();\n"
     "        issue_qk<D>(s, q_addr, k_base + st * kFwdTile);\n"
     "        issue_pv<D>(o_acc, pa, v_base + prev * kFwdTile);\n"
     "        mark(8);\n"),
    ("        release_k(st);\n", "        release_k(st);\n        mark(9);\n"),
    ("        // The softmax is done before the wait, not moved below it.\n"
     "        hopper::fence_regs(s);\n        hopper::wgmma_wait<0>();\n"
     "        hopper::fence_regs(o_acc);\n",
     "        mark(10);\n"
     "        hopper::fence_regs(s);\n        hopper::wgmma_wait<0>();\n"
     "        hopper::fence_regs(o_acc);\n        mark(11);\n"),
    ("        pack_p(s, pa);\n      }\n      p_q0 = q0;",
     "        pack_p(s, pa);\n        mark(12);\n        P[15] += 1;\n"
     "      }\n      P[14] += 1;\n      p_q0 = q0;"),
    (_LAST_FINISH,
     "    finish();\n"
     "    if (threadIdx.x % WG == 0) {\n"
     "      for (int k = 0; k < 16; ++k) "
     "atomicAdd(&g_clocks[16 * wg + k], (unsigned long long)P[k]);\n"
     "    }\n  }\n}\n"),
    _READ_CLOCKS,
]


# The head_dim-128 dK/dV loop body: S^T_t issued with dV and dK of tile
# t - 1, P^T_t computed under them, then dP^T_t alone (the committed
# kernel, 192 registers live); tile t - 1's products in two halves, each
# beside half of tile t's (208 live), and all four at once, P^T_t and
# dS^T_t computed under dV and dK of tile t - 1 (224 live). ptxas spills
# the last two and serialises their wgmmas (C7512).
_DKV_AHEAD = (
    "          hopper::wgmma_fence();\n"
    "          issue_s(t);\n"
    "          issue_dv(t - 1);\n"
    "          issue_dk(t - 1);\n"
    "          hopper::wgmma_wait<2>();  // S^T_t is in\n"
    "          hopper::fence_regs(s);\n"
    "          p_of(t);\n"
    "          hopper::fence_regs(s);  // P^T is done before the wait\n"
    "          hopper::wgmma_wait<0>();\n"
    "          hopper::fence_regs(dv_acc);\n"
    "          hopper::fence_regs(dk_acc);\n"
    "          release(t - 1);\n"
    "          hopper::wgmma_fence();\n"
    "          issue_dp(t);\n"
    "          hopper::wgmma_wait<0>();\n"
    "          hopper::fence_regs(dp);\n"
    "          ds_of(t);\n"
    "          pack(s, pa);\n"
    "          pack(dp, da);\n")
_DKV_SPLIT = (
    "          hopper::wgmma_fence();\n"
    "          issue_s(t);\n"
    "          issue_dv(t - 1);\n"
    "          hopper::wgmma_wait<1>();  // S^T_t is in\n"
    "          hopper::fence_regs(s);\n"
    "          p_of(t);\n"
    "          hopper::fence_regs(s);  // P^T is done before the wait\n"
    "          hopper::wgmma_wait<0>();\n"
    "          hopper::fence_regs(dv_acc);\n"
    "          hopper::wgmma_fence();\n"
    "          issue_dp(t);\n"
    "          issue_dk(t - 1);\n"
    "          hopper::wgmma_wait<1>();  // dP^T_t is in\n"
    "          hopper::fence_regs(dp);\n"
    "          ds_of(t);\n"
    "          pack(s, pa);\n"
    "          hopper::fence_regs(dp);  // dS^T is done before the wait\n"
    "          hopper::wgmma_wait<0>();\n"
    "          hopper::fence_regs(dk_acc);\n"
    "          release(t - 1);\n"
    "          pack(dp, da);\n")
_DKV_TOGETHER = (
    "          hopper::wgmma_fence();\n"
    "          issue_s(t);\n"
    "          issue_dp(t);\n"
    "          issue_dv(t - 1);\n"
    "          issue_dk(t - 1);\n"
    "          hopper::wgmma_wait<2>();  // S^T_t and dP^T_t are in\n"
    "          hopper::fence_regs(s);\n"
    "          hopper::fence_regs(dp);\n"
    "          p_of(t);\n"
    "          ds_of(t);\n"
    "          hopper::fence_regs(s);\n"
    "          hopper::fence_regs(dp);\n"
    "          hopper::wgmma_wait<0>();\n"
    "          hopper::fence_regs(dv_acc);\n"
    "          hopper::fence_regs(dk_acc);\n"
    "          release(t - 1);\n"
    "          pack(s, pa);\n"
    "          pack(dp, da);\n")


def _marked(text, marks):
    """``text`` with ``mark(k)`` after each of its lines named in
    ``marks`` ({line: k}, 10-space indent)."""
    out = []
    for line in text.splitlines(keepends=True):
        out.append(line)
        if line.strip() in marks:
            out.append(f"          mark({marks[line.strip()]});\n")
    return "".join(out)


# Phase clocks of the dK/dV consumer warpgroups at head_dim 128, in the
# overlapped loop: per item and per query tile of the loop.
_DKV_CLOCKS = [
    _CLOCK_SUMS,
    ("    const float scale_log2 = scale * LOG2E;\n    int ring = 0;\n"
     "    for (int j = 0, item; (item = snake_item(j, n_items)) >= 0; ++j) {"
     "\n      const DkvItem it",
     "    const float scale_log2 = scale * LOG2E;\n" + _MARK +
     "    int ring = 0;\n"
     "    for (int j = 0, item; (item = snake_item(j, n_items)) >= 0; ++j) {"
     "\n      const DkvItem it"),
    ("      wait(kv_full + kb, (j / KV_BUFS) & 1);\n",
     "      mark(0);\n      wait(kv_full + kb, (j / KV_BUFS) & 1);\n"
     "      mark(1);\n"),
    ("        wait_full(t_mine);\n",
     "        mark(2);\n        wait_full(t_mine);\n"),
    ("        pack(s, pa);\n        pack(dp, da);\n        // S^T_t goes",
     "        pack(s, pa);\n        pack(dp, da);\n        mark(3);\n"
     "        // S^T_t goes"),
    ("          wait_full(t);\n" + _DKV_AHEAD,
     "          wait_full(t);\n          mark(6);\n" + _marked(_DKV_AHEAD, {
         "issue_dk(t - 1);": 7,
         "hopper::fence_regs(s);": 8,
         "hopper::fence_regs(s);  // P^T is done before the wait": 9,
         "release(t - 1);": 10,
         "hopper::fence_regs(dp);": 11,
         "ds_of(t);": 12,
         "pack(dp, da);": 13}) + "          P[15] += 1;\n"),
    ("        release(n_q - 1);\n        ring += n_q - t0;\n",
     "        release(n_q - 1);\n        mark(4);\n        P[14] += 1;\n"
     "        ring += n_q - t0;\n"),
    ("      if (lane == 0) hopper::mbar_arrive(kv_empty + kb);\n    }\n"
     "  }\n}\n",
     "      if (lane == 0) hopper::mbar_arrive(kv_empty + kb);\n"
     "      mark(5);\n    }\n"
     "    if (D == 128 && threadIdx.x % WG == 0) {\n"
     "      for (int k = 0; k < 16; ++k) "
     "atomicAdd(&g_clocks[16 * wg + k], (unsigned long long)P[k]);\n"
     "    }\n  }\n}\n"),
    _READ_CLOCKS,
]


def _turns(cond, bar=False):
    """FlashAttention-3's ping-pong where ``cond`` holds: a warpgroup
    issues its products once the other has issued its own, and passes the
    turn as soon as they are out; warpgroup 1 passes first, and both take
    one turn a kv tile and one for the last P V. The turns go through two
    mbarriers, whose wait traps after about 20 s, or with ``bar`` through
    named barriers 3 and 4, which wait without a limit (warpgroup 0 then
    takes warpgroup 1's last pass at the end)."""
    if bar:
        wait_turn = "hopper::named_sync(3 + wg, 2 * WG)"
        pass_ = ('asm volatile("bar.arrive %0, %1;\\n" :: "r"(4 - wg), '
                 '"r"(2 * WG) : "memory")')
    else:
        wait_turn = "wait(turn + wg, turns++ & 1)"
        pass_ = "if (lane == 0) hopper::mbar_arrive(turn + 1 - wg)"
    out = [] if bar else [
        ("  static constexpr int BARRIERS =\n"
         "      2 * FWD_QBUF + (K_RELEASE ? 4 : 3) * STAGES;\n",
         "  static constexpr int BARRIERS =\n"
         "      2 * FWD_QBUF + (K_RELEASE ? 4 : 3) * STAGES + 2;\n"),
        ("  uint64_t* k_empty = F::K_RELEASE ? empty + FWD_STAGES : empty;\n",
         "  uint64_t* k_empty = F::K_RELEASE ? empty + FWD_STAGES : empty;\n"
         "  uint64_t* turn = k_empty + FWD_STAGES;\n"),
        ("      if (F::K_RELEASE) hopper::mbar_init(k_empty + s, 2 * WG / 32);"
         "\n    }\n",
         "      if (F::K_RELEASE) hopper::mbar_init(k_empty + s, 2 * WG / 32);"
         "\n    }\n"
         "    for (int w = 0; w < 2; ++w) hopper::mbar_init(turn + w, WG /"
         " 32);"
         "\n")]
    out += [
        (_LOOP_START, _LOOP_START.replace(
            "    int tile = 0;\n",
            f"    constexpr bool TURNS = {cond};\n"
            "    [[maybe_unused]] int turns = 0;\n"
            "    auto my_turn = [&] {\n"
            f"      if (TURNS) {wait_turn};\n"
            "    };\n"
            "    auto pass_turn = [&] {\n"
            f"      if (TURNS) {{ {pass_}; }}\n"
            "    };\n"
            "    if (wg == 1) pass_turn();\n"
            "    int tile = 0;\n"))]
    for ind, issue in (
            ("      ", "issue_qk<D>(s, q_addr, k_base + (tile % FWD_STAGES) * "
                       "kFwdTile);\n      issue_pv<D>(o_acc, pa, v_base + pst "
                       "* kFwdTile);\n"),
            ("        ", "issue_qk<D>(s, q_addr, k_base + st * kFwdTile);\n"
                         "        issue_pv<D>(o_acc, pa, v_base + prev * "
                         "kFwdTile);\n"),
            ("    ", "issue_pv<D>(o_acc, pa, v_base + pst * kFwdTile);\n")):
        old = f"{ind}hopper::wgmma_fence();\n{ind}{issue}"
        out.append((old, f"{ind}my_turn();\n{old}{ind}pass_turn();\n"))
    if bar:
        out.append((_LAST_FINISH,
                    "    finish();\n    if (TURNS && wg == 0) my_turn();\n"
                    "  }\n}\n"))
    return [("flash_attn.cu", old, new) for old, new in out]


# The softmax of S_t after both of the warpgroup's products are in, not
# under its own P_{t-1} V_{t-1} (head_dim 128).
_TOGETHER = [("flash_attn.cu", f"{ind}hopper::wgmma_wait<1>();  {note}\n",
              f"{ind}hopper::wgmma_wait<D == 128 ? 0 : 1>();  {note}\n")
             for ind, note in (
                 ("      ", "// S_0 is in; the last P V runs on"),
                 ("        ", "// S_t is in; P_{t-1} V_{t-1} runs on"))]


def _pv_first(ind, qk, pv):
    """P V issued and waited for before S = Q K^T (head_dim 128), so
    that S, O and P are never all live."""
    return ("flash_attn.cu", f"{ind}{qk}\n{ind}{pv}\n",
            f"{ind}if constexpr (D == 128) {{\n{ind}  {pv}\n"
            f"{ind}  hopper::wgmma_wait<0>();\n"
            f"{ind}  hopper::fence_regs(o_acc);\n"
            f"{ind}  hopper::wgmma_fence();\n{ind}  {qk}\n"
            f"{ind}}} else {{\n{ind}  {qk}\n{ind}  {pv}\n{ind}}}\n")


_PV_FIRST = _TOGETHER + [
    _pv_first("      ",
              "issue_qk<D>(s, q_addr, k_base + (tile % FWD_STAGES) * "
              "kFwdTile);", "issue_pv<D>(o_acc, pa, v_base + pst * kFwdTile);"),
    _pv_first("        ", "issue_qk<D>(s, q_addr, k_base + st * kFwdTile);",
              "issue_pv<D>(o_acc, pa, v_base + prev * kFwdTile);")]

# dQ's loop over its kv tiles: S_t and dP_t issued with dQ += dS_{t-1}
# K_{t-1} (the committed kernel), then the last dQ += dS K; and the
# products one after the other.
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
    "      }\n")
_DQ_LAST = (
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

# dQ's loop at head_dim 128 with S_{t+1} and dP_{t+1} issued before dS_t is
# computed, into a second set of registers (copied back after each tile),
# so that dS_t runs under the next tile's two products and not only under
# dQ += dS_{t-1} K_{t-1}: 192 registers live beside the addresses.
_DQ_AHEAD = (
    "      if constexpr (D == 128) {\n"
    "        // S_{t+1} and dP_{t+1} go out before dS_t is computed.\n"
    "        float s_n[32], dp_n[32];\n"
    "        auto issue_s_dp_n = [&](int t) {\n"
    "          const uint32_t ka = k_addr(t), va = ka + kDqTile;\n"
    "#pragma unroll\n"
    "          for (int kk = 0; kk < D / 16; ++kk) {\n"
    "            hopper::wgmma_m64n64k16_ss(\n"
    "                s_n, hopper::desc_k_major(k_step(q_addr, kk, "
    "q_panel)),\n"
    "                hopper::desc_k_major(k_step(ka, kk, kDqPanel)), kk);\n"
    "          }\n"
    "#pragma unroll\n"
    "          for (int kk = 0; kk < D / 16; ++kk) {\n"
    "            hopper::wgmma_m64n64k16_ss(\n"
    "                dp_n, hopper::desc_k_major(k_step(do_addr, kk, "
    "q_panel)),\n"
    "                hopper::desc_k_major(k_step(va, kk, kDqPanel)), kk);\n"
    "          }\n"
    "          hopper::wgmma_commit();\n"
    "        };\n"
    "        wait_full(0);\n"
    "        hopper::wgmma_fence();\n"
    "        issue_s_dp(0);\n"
    "        for (int t = 0; t + 1 < n_mine; ++t) {\n"
    "          wait_full(t + 1);\n"
    "          hopper::wgmma_fence();\n"
    "          issue_s_dp_n(t + 1);\n"
    "          hopper::wgmma_wait<1>();  // S_t, dP_t and dQ_{t-1} are in\n"
    "          hopper::fence_regs(s);\n"
    "          hopper::fence_regs(dp);\n"
    "          hopper::fence_regs(acc);\n"
    "          if (t > 0) release(t - 1);\n"
    "          ds(t);\n"
    "          pack_ds();\n"
    "          hopper::wgmma_fence();\n"
    "          issue_dq(t);\n"
    "          hopper::wgmma_wait<1>();  // S_{t+1} and dP_{t+1} are in\n"
    "          hopper::fence_regs(s_n);\n"
    "          hopper::fence_regs(dp_n);\n"
    "#pragma unroll\n"
    "          for (int i = 0; i < 32; ++i) {\n"
    "            s[i] = s_n[i];\n"
    "            dp[i] = dp_n[i];\n"
    "          }\n"
    "        }\n"
    "        hopper::wgmma_wait<0>();\n"
    "        hopper::fence_regs(s);\n"
    "        hopper::fence_regs(dp);\n"
    "        hopper::fence_regs(acc);\n"
    "        if (n_mine > 1) release(n_mine - 2);\n"
    "        ds(n_mine - 1);\n"
    "        pack_ds();\n"
    "      } else {\n" + _DQ_OVERLAP + "      }\n")

# The dQ loop's tile, as committed (8-space indent).
_DQ_TILE = (
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
    "        pack_ds();\n")


def _marks_after(text, marks, indent):
    """``text`` with ``mark(k)`` after each of its lines in ``marks``
    ({line: k}; a line's first match only)."""
    out, todo = [], dict(marks)
    for line in text.splitlines(keepends=True):
        out.append(line)
        k = todo.pop(line.strip(), None)
        if k is not None:
            out.append(f"{indent}mark({k});\n")
    return "".join(out)


# Phase clocks of the dQ consumer warpgroups (read at head_dim 128): per
# item and per kv tile of the loop.
_DQ_CLOCKS = [
    _CLOCK_SUMS,
    ("    const float scale_log2 = scale * LOG2E;\n    int ring = 0;\n"
     "    for (int j = 0, item; (item = snake_item(j, n_items)) >= 0; ++j) {"
     "\n      const FwdItem it",
     "    const float scale_log2 = scale * LOG2E;\n" + _MARK +
     "    int ring = 0;\n"
     "    for (int j = 0, item; (item = snake_item(j, n_items)) >= 0; ++j) {"
     "\n      const FwdItem it"),
    ("      float lse2[2], dl[2];\n",
     "      mark(0);\n      float lse2[2], dl[2];\n"),
    ("\n      // The item's kv tiles, and this warpgroup's: those that see",
     "      mark(1);\n\n"
     "      // The item's kv tiles, and this warpgroup's: those that see"),
    ("      pack_ds();\n      for (int t = 1; t < n_mine; ++t) {\n",
     "      pack_ds();\n      mark(2);\n"
     "      for (int t = 1; t < n_mine; ++t) {\n"),
    (_DQ_TILE, _marks_after(_DQ_TILE, {
        "wait_full(t);": 6, "issue_dq(t - 1);": 7,
        "hopper::fence_regs(dp);": 8,
        "hopper::fence_regs(dp);  // dS is done before the wait": 9,
        "hopper::fence_regs(acc);": 10, "pack_ds();": 11}, " " * 8)
     + "        P[15] += 1;\n"),
    ("      release(n_mine - 1);\n      // Tiles past",
     "      release(n_mine - 1);\n      mark(3);\n      // Tiles past"),
    ("        release(t);\n      }\n      ring += n_kv;\n",
     "        release(t);\n      }\n      ring += n_kv;\n      mark(4);\n"
     "      P[14] += 1;\n"),
    ("        if (lane == 0) hopper::mbar_arrive(q_empty + qi);\n      }\n"
     "    }\n  }\n}\n",
     "        if (lane == 0) hopper::mbar_arrive(q_empty + qi);\n      }\n"
     "      mark(5);\n    }\n"
     "    if (D == 128 && threadIdx.x % WG == 0) {\n"
     "      for (int k = 0; k < 16; ++k) "
     "atomicAdd(&g_clocks[16 * wg + k], (unsigned long long)P[k]);\n"
     "    }\n  }\n}\n"),
    _READ_CLOCKS,
]


def _dq_form(**want):
    """``Dq<D>`` set to ``want`` where it departs from the committed form
    (DQ)."""
    return [_dq(k, v) for k, v in want.items() if DQ[k] != v]


# The head_dim-128 dQ's old ring: two whole Q/dO buffers through which dQ
# goes out, 3 K/V stages loaded after the item's Q and dO.
_DQ128_TWO_Q = dict(STORE_APART="false", Q_HALVES="false", KV_LEAD="0",
                    Q_BUFS="2", STAGES="D == 64 ? 4 : 3")
# At head_dim 128 the producer warp loads an item's lse (times log2 e) and
# delta beside its Q and dO (whole buffers: 1 KB after them), and the
# consumers read theirs from there once the buffer is full, not from
# global memory at the item's start.
_DQ_ROWS = [("flash_attn.cu", old, new) for old, new in (
    ("  static constexpr int QBUF = 2 * ROWS;            // a Q/dO buffer\n",
     "  static constexpr int QBUF = 2 * ROWS + (D == 128 ? 8 * QBM : 0);\n"),
    ("      hopper::mbar_init(q_full + i, 1);\n"
     "      // one arrival a warp (of a half's",
     "      hopper::mbar_init(q_full + i, D == 128 ? 32 : 1);\n"
     "      // one arrival a warp (of a half's"),
    ("    if (threadIdx.x == 2 * WG) {\n"
     "      hopper::tma_prefetch_map(&tm_q);\n"
     "      hopper::tma_prefetch_map(&tm_k);\n"
     "      hopper::tma_prefetch_map(&tm_v);\n"
     "      hopper::tma_prefetch_map(&tm_do);\n",
     "    const int lane = threadIdx.x % 32;\n"
     "    const bool issuer = D == 64 || lane == 0;  // of every TMA load\n"
     "    if (D == 128 ? threadIdx.x / 32 == 2 * WG / 32\n"
     "                 : threadIdx.x == 2 * WG) {\n"
     "      if (issuer) {\n"
     "        hopper::tma_prefetch_map(&tm_q);\n"
     "        hopper::tma_prefetch_map(&tm_k);\n"
     "        hopper::tma_prefetch_map(&tm_v);\n"
     "        hopper::tma_prefetch_map(&tm_do);\n"
     "      }\n"),
    ("        auto load_kv = [&](int t) {\n",
     "        auto load_kv = [&](int t) {\n          if (!issuer) return;\n"),
    ("          if (j >= Q_BUFS) wait(q_empty + qb, (j / Q_BUFS - 1) & 1);\n"
     "          hopper::mbar_arrive_tx(q_full + qb, 2 * kDqRows);\n"
     "          load_tile<D>(q_buf, &tm_q, q_full + qb, QBM, h, q0, b);\n"
     "          load_tile<D>(q_buf + kDqRows, &tm_do, q_full + qb, QBM, h, q0,"
     " b);\n",
     "          if (j >= Q_BUFS) wait(q_empty + qb, (j / Q_BUFS - 1) & 1);\n"
     "          if (D == 128) {\n"
     "            float* rows = reinterpret_cast<float*>(q_buf + 2 * kDqRows);"
     "\n"
     "            for (int r = lane; r < QBM; r += 32) {\n"
     "              const bool in = q0 + r < Sq;\n"
     "              const long long at = (long long)bh * Sq + q0 + r;\n"
     "              rows[r] = in ? lse[at] * LOG2E : 0.0f;\n"
     "              rows[QBM + r] = in ? delta[at] : 0.0f;\n"
     "            }\n"
     "            __syncwarp();\n"
     "            if (!issuer) hopper::mbar_arrive(q_full + qb);\n"
     "          }\n"
     "          if (issuer) {\n"
     "            hopper::mbar_arrive_tx(q_full + qb, 2 * kDqRows);\n"
     "            load_tile<D>(q_buf, &tm_q, q_full + qb, QBM, h, q0, b);\n"
     "            load_tile<D>(q_buf + kDqRows, &tm_do, q_full + qb, QBM, h, "
     "q0, b);\n"
     "          }\n"),
    ("      for (int i = 0; i < 2; ++i) {\n"
     "        const int row = row0 + 8 * i;\n"
     "        const long long at = (long long)bh * Sq + row;\n",
     "      for (int i = 0; D == 64 && i < 2; ++i) {\n"
     "        const int row = row0 + 8 * i;\n"
     "        const long long at = (long long)bh * Sq + row;\n"),
    ("      wait(q_full + qi, (j / Q_BUFS) & 1);\n",
     "      wait(q_full + qi, (j / Q_BUFS) & 1);\n"
     "      if (D == 128) {\n"
     "        const float* rows = reinterpret_cast<const float*>(\n"
     "            sQ + qb * kDqBuf + 2 * kDqRows);\n"
     "        for (int i = 0; i < 2; ++i) {\n"
     "          lse2[i] = rows[row0 + 8 * i - q0];\n"
     "          dl[i] = rows[QBM + row0 + 8 * i - q0];\n"
     "        }\n"
     "      }\n"))]
_TMA_MAP = "__device__ __forceinline__ void tma_prefetch_map("
# At head_dim 128 the producer asks for the next item's Q and dO (both
# halves) to be brought into the L2 cache once it has loaded this item's.
_DQ_PREFETCH = [
    ("hopper.cuh", _TMA_MAP,
     "__device__ __forceinline__ void tma_prefetch_4d(const CUtensorMap* "
     "map, int c0,\n"
     "                                                int c1, int c2, int c3)"
     " {\n"
     "  asm volatile(\n"
     "      \"cp.async.bulk.prefetch.tensor.4d.L2.global [%0, {%1, %2, %3, "
     "%4}];\\n\"\n"
     "      :: \"l\"(reinterpret_cast<uint64_t>(map)), \"r\"(c0), \"r\"(c1),"
     " \"r\"(c2),\n"
     "         \"r\"(c3)\n"
     "      : \"memory\");\n"
     "}\n\n" + _TMA_MAP),
    ("flash_attn.cu",
     "        for (int t = lead; t < n_kv; ++t) load_kv(t);\n"
     "        ring += n_kv;\n",
     "        const int next = snake_item(j + 1, n_items);\n"
     "        if (D == 128 && next >= 0) {\n"
     "          const FwdItem nx = item_at(next);\n"
     "          for (int w = 0; w < 2; ++w) {\n"
     "            for (int p = 0; p < D / 64; ++p) {\n"
     "              const int s0 = nx.q_tile * QBM + 64 * w;\n"
     "              hopper::tma_prefetch_4d(&tm_q, 64 * p, nx.bh % H, s0, "
     "nx.bh / H);\n"
     "              hopper::tma_prefetch_4d(&tm_do, 64 * p, nx.bh % H, s0, "
     "nx.bh / H);\n"
     "            }\n"
     "          }\n"
     "        }\n"
     "        for (int t = lead; t < n_kv; ++t) load_kv(t);\n"
     "        ring += n_kv;\n")]
# At head_dim 128 a warpgroup's dQ goes from its rows of dQ's own buffer
# to the output by one TMA store a panel (rows past Sq are not written),
# which runs on while the warpgroup takes its next item; the rows are
# written again once the last store has read them.
_DQ_TMA_STORE = [
    ("hopper.cuh", _TMA_MAP,
     "__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,\n"
     "                                             const void* src, int c0, "
     "int c1,\n"
     "                                             int c2, int c3) {\n"
     "  asm volatile(\n"
     "      \"cp.async.bulk.tensor.4d.global.shared::cta.bulk_group\"\n"
     "      \" [%0, {%2, %3, %4, %5}], [%1];\\n\"\n"
     "      :: \"l\"(reinterpret_cast<uint64_t>(map)), "
     "\"r\"(smem_addr(src)),\n"
     "         \"r\"(c0), \"r\"(c1), \"r\"(c2), \"r\"(c3)\n"
     "      : \"memory\");\n"
     "}\n\n" + _TMA_MAP),
    ("flash_attn.cu",
     "              Layout ldq, float scale, int causal, int group) {\n",
     "              Layout ldq, float scale, int causal, int group,\n"
     "              const __grid_constant__ CUtensorMap tm_dq) {\n"),
    ("flash_attn.cu",
     "        store_rows<D>(acc, scale, scale, sOut + wg * 64 * ROW_BYTES,\n"
     "                      kDqRowsPanel, dq + b * ldq.b + h * ldq.h, ldq.s,"
     "\n"
     "                      row_lo, Sq, wg);\n",
     "        unsigned char* out_rows = sOut + wg * 64 * ROW_BYTES;\n"
     "        if (tid == 0) {\n"
     "          asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: "
     "\"memory\");\n"
     "        }\n"
     "        hopper::named_sync(1 + wg, WG);\n"
     "#pragma unroll\n"
     "        for (int i = 0; i < 2; ++i) {\n"
     "          const int r = warp * 16 + lane / 4 + 8 * i;\n"
     "#pragma unroll\n"
     "          for (int n = 0; n < D / 8; ++n) {\n"
     "            *reinterpret_cast<uint32_t*>(\n"
     "                out_rows + (n / 8) * kDqRowsPanel + swizzled(r, n % 8) +"
     "\n"
     "                (lane % 4) * 4) =\n"
     "                hopper::pack_bf16(acc[4 * n + 2 * i] * scale,\n"
     "                                  acc[4 * n + 2 * i + 1] * scale);\n"
     "          }\n"
     "        }\n"
     "        asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
     "\"memory\");\n"
     "        hopper::named_sync(1 + wg, WG);\n"
     "        if (tid == 0) {\n"
     "          for (int p = 0; p < D / 64; ++p) {\n"
     "            hopper::tma_store_4d(&tm_dq, out_rows + p * kDqRowsPanel, "
     "64 * p,\n"
     "                                 h, row_lo, b);\n"
     "          }\n"
     "          asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: "
     "\"memory\");\n"
     "        }\n"),
    ("flash_attn.cu",
     "        if (lane == 0) hopper::mbar_arrive(q_empty + qi);\n      }\n"
     "    }\n  }\n}\n",
     "        if (lane == 0) hopper::mbar_arrive(q_empty + qi);\n      }\n"
     "    }\n"
     "    if (tid == 0) {  // the last TMA stores are done\n"
     "      asm volatile(\"cp.async.bulk.wait_group 0;\\n\" ::: \"memory\");"
     "\n"
     "    }\n  }\n}\n"),
    ("flash_attn.cu",
     "  CUtensorMap tq, tk, tv, tdo;\n"
     "  // Q and dO in boxes of an item's rows, or of a half's with Q_HALVES."
     "\n",
     "  CUtensorMap tq, tk, tv, tdo, tdq = {};\n"
     "  if (D == 128 && !input_map(&tdq, dq, B, Sq, H, D, strides, 4, 64)) {"
     "\n"
     "    return (int)cudaErrorInvalidValue;\n"
     "  }\n"
     "  // Q and dO in boxes of an item's rows, or of a half's with Q_HALVES."
     "\n"),
    ("flash_attn.cu",
     "      B * H, H, Sq, Sk, layout_at(strides, 4), scale, causal, group);\n",
     "      B * H, H, Sq, Sk, layout_at(strides, 4), scale, causal, group, "
     "tdq);\n")]
# The head_dim-128 dQ before its redesign: the old ring, the plain item
# order, the inlined trap.
_DQ128_BEFORE = _dq_form(TRAP_OUT_OF_LINE="false", L2_GROUPS="false",
                         **_DQ128_TWO_Q)


def _dkv_ring(bufs, stages):
    """dK/dV's ring at head_dim 128: ``bufs`` K/V item buffers and
    ``stages`` Q/dO stages."""
    return ("flash_attn.cu",
            "  static constexpr int KV_BUFS = D == 64 ? 2 : 1;  // K/V item "
            "buffers\n"
            "  static constexpr int STAGES = D == 64 ? 3 : 4;  // Q/dO ring\n",
            f"  static constexpr int KV_BUFS = D == 64 ? 2 : {bufs};\n"
            f"  static constexpr int STAGES = D == 64 ? 3 : {stages};\n")


# At head_dim 128 each stage's lse and delta (2 DBM floats) after the
# ring, not in 1024 bytes beside its tiles: two K/V buffers and 3 stages
# then fit in 227 KB.
_ROWS = "(D == 128 ? DKV_STAGES * 2 * DBM * 4 : 0)"
_DKV_ROWS_APART = [("flash_attn.cu", old, new) for old, new in (
    ("  static constexpr int STAGE = 2 * TILE + 1024;  // + lse and delta, "
     "aligned\n",
     "  static constexpr int STAGE = 2 * TILE + (D == 128 ? 0 : 1024);\n"),
    ("                                 (2 * KV_BUFS + 2 * STAGES) * "
     "sizeof(uint64_t);\n",
     "                                 (D == 128 ? STAGES * 2 * DBM * 4 : 0) "
     "+\n"
     "                                 (2 * KV_BUFS + 2 * STAGES) * "
     "sizeof(uint64_t);\n"),
    ("      reinterpret_cast<uint64_t*>(stages + DKV_STAGES * kDkvStage);",
     f"      reinterpret_cast<uint64_t*>(stages + DKV_STAGES * kDkvStage + "
     f"{_ROWS});"),
    ("    return reinterpret_cast<float*>(stages + st * kDkvStage + 2 * "
     "kDkvTile);",
     "    return reinterpret_cast<float*>(\n"
     "        D == 128 ? stages + DKV_STAGES * kDkvStage + st * 2 * DBM * 4\n"
     "                 : stages + st * kDkvStage + 2 * kDkvTile);"))]
# At head_dim 128 the next item's K and V go out once the producer has
# filled the ring with this item's first tiles (the consumers have taken
# the first: the item before is done with its buffer), not after this
# item's last tile.
_DKV_KV_AHEAD = (
    "flash_attn.cu",
    "        const int kb = j % KV_BUFS;\n"
    "        unsigned char* sK = sKV + kb * 2 * kDkvKv;\n"
    "        if (j >= KV_BUFS) wait(kv_empty + kb, (j / KV_BUFS - 1) & 1);\n"
    "        if (lane == 0) {\n"
    "          hopper::mbar_arrive_tx(kv_full + kb, 2 * kDkvKv);\n"
    "          load_tile<D>(sK, &tm_k, kv_full + kb, DBN, h, k0, b);\n"
    "          load_tile<D>(sK + kDkvKv, &tm_v, kv_full + kb, DBN, h, k0, b);"
    "\n        }\n"
    "        for (int t = first_q_tile(k0); t < n_q; ++t, ++ring) {\n",
    "        auto load_kv = [&](int j, int item) {\n"
    "          const DkvItem it = item_at(item);\n"
    "          const int k0 = it.kv_tile * DBN, b = it.bh / H, h = it.bh % H;"
    "\n          const int kb = j % KV_BUFS;\n"
    "          unsigned char* sK = sKV + kb * 2 * kDkvKv;\n"
    "          if (j >= KV_BUFS) wait(kv_empty + kb, (j / KV_BUFS - 1) & 1);"
    "\n          if (lane == 0) {\n"
    "            hopper::mbar_arrive_tx(kv_full + kb, 2 * kDkvKv);\n"
    "            load_tile<D>(sK, &tm_k, kv_full + kb, DBN, h, k0, b);\n"
    "            load_tile<D>(sK + kDkvKv, &tm_v, kv_full + kb, DBN, h, k0, "
    "b);\n          }\n        };\n"
    "        if (D == 64 || j == 0) load_kv(j, item);\n"
    "        const int t_first = first_q_tile(k0);\n"
    "        const int t_kv = min(t_first + DKV_STAGES - 1, n_q - 1);\n"
    "        for (int t = t_first; t < n_q; ++t, ++ring) {\n")
_DKV_KV_NEXT = (
    "flash_attn.cu",
    "            hopper::mbar_arrive(full + st);\n          }\n",
    "            hopper::mbar_arrive(full + st);\n          }\n"
    "          if (D == 128 && t == t_kv && snake_item(j + 1, n_items) >= 0) {"
    "\n            load_kv(j + 1, snake_item(j + 1, n_items));\n"
    "          }\n")

# dK and dV at head_dim 128 written straight from the accumulators (a
# thread's pairs of columns, 16 bytes of 8 rows a warp store), with the
# K/V buffer handed back before them instead of staging them.
_ROUND_J = ("// Round j of a persistent kernel's walk over its work items, "
            "heaviest")
_DKV_DIRECT_STORE = [("flash_attn.cu", _ROUND_J, (
    "// Writes this thread's pieces of a warpgroup's 64 x D fp32"
    " accumulator,\n"
    "// times ``mul``, as bf16 straight from the registers: rows ``row0``"
    " and\n"
    "// row0 + 8 of a strided output (those below ``nrows``), two columns at"
    " 8 n\n"
    "// + col_off each (the warp's stores fill 16 bytes of 8 rows at once;"
    " the\n"
    "// L2 cache joins the halves of each 32-byte sector). No shared memory"
    " and\n"
    "// no barrier.\n"
    "template <int D>\n"
    "__device__ __forceinline__ void store_rows_direct(const float (&acc)[D"
    " / 2],\n"
    "                                                  float mul, bf16* out,\n"
    "                                                  long long row_stride,\n"
    "                                                  int row0, int nrows)"
    " {\n"
    "  const int col_off = 2 * (threadIdx.x % 4);\n"
    "#pragma unroll\n"
    "  for (int i = 0; i < 2; ++i) {\n"
    "    if (row0 + 8 * i >= nrows) continue;\n"
    "    bf16* row = out + (long long)(row0 + 8 * i) * row_stride + col_off;\n"
    "#pragma unroll\n"
    "    for (int n = 0; n < D / 8; ++n) {\n"
    "      *reinterpret_cast<uint32_t*>(row + 8 * n) = hopper::pack_bf16(\n"
    "          acc[4 * n + 2 * i] * mul, acc[4 * n + 2 * i + 1] * mul);\n"
    "    }\n"
    "  }\n"
    "}\n"
    "\n"
) + _ROUND_J), ("flash_attn.cu", (
    "      // This warpgroup's K and V rows are read; they stage its dK and"
    " dV,\n"
    "      // and the buffer goes back to the producer once the rows are"
    " stored.\n"
    "      store_rows<D>(dk_acc, scale, scale, k_rows, kDkvKvPanel,\n"
    "                    dk + b * ldk.b + h * ldk.h, ldk.s, kv_lo, Sk, wg);\n"
    "      store_rows<D>(dv_acc, 1.0f, 1.0f, v_rows, kDkvKvPanel,\n"
    "                    dv + b * ldv.b + h * ldv.h, ldv.s, kv_lo, Sk, wg);\n"
    "      __syncwarp();\n"
    "      if (lane == 0) hopper::mbar_arrive(kv_empty + kb);"
), (
    "      if constexpr (D == 128) {\n"
    "        __syncwarp();\n"
    "        if (lane == 0) hopper::mbar_arrive(kv_empty + kb);\n"
    "        store_rows_direct<D>(dk_acc, scale, dk + b * ldk.b + h * ldk.h,\n"
    "                             ldk.s, row0, Sk);\n"
    "        store_rows_direct<D>(dv_acc, 1.0f, dv + b * ldv.b + h * ldv.h,\n"
    "                             ldv.s, row0, Sk);\n"
    "      } else {\n"
    "        // This warpgroup's K and V rows are read; they stage its dK"
    " and dV,\n"
    "        // and the buffer goes back to the producer once the rows are"
    " stored.\n"
    "        store_rows<D>(dk_acc, scale, scale, k_rows, kDkvKvPanel,\n"
    "                      dk + b * ldk.b + h * ldk.h, ldk.s, kv_lo, Sk,"
    " wg);\n"
    "        store_rows<D>(dv_acc, 1.0f, 1.0f, v_rows, kDkvKvPanel,\n"
    "                      dv + b * ldv.b + h * ldv.h, ldv.s, kv_lo, Sk,"
    " wg);\n"
    "        __syncwarp();\n"
    "        if (lane == 0) hopper::mbar_arrive(kv_empty + kb);"
    "\n      }"))]

_serial = ("flash_attn.cu", _LOOP_START,
           _LOOP_START.replace("    int tile = 0;\n",
                               _FWD128_SERIAL + "    int tile = 0;\n"))

# Each variant: (file, old text, new text) replacements, in order.
VARIANTS = {
    "committed": [],
    "round_robin": [("flash_attn.cu",) + _RR],
    # the ping-pong at both head_dims
    "turns": _turns("true"),
    "fwd_stages_2": [("flash_attn.cu",) + _stages(4, 2, "K/V", 2)],
    "fwd_stages_3": [("flash_attn.cu",) + _stages(4, 2, "K/V", 3)],
    "dkv_stages_2": [("flash_attn.cu",) + _stages(3, 4, "Q/dO", 2)],
    "dq_stages_2": [_dq("STAGES", "D == 64 ? 2 : 4")],
    "dq_serial": [("flash_attn.cu", _DQ_OVERLAP, _DQ_SERIAL),
                  ("flash_attn.cu", _DQ_LAST, "")],
    # PR 9's serial head_dim-128 loop, in the item order without groups
    "fwd128_serial": [_serial, _switch("L2_GROUPS", "D == 128", "false")],
    "fwd128_serial_l2": [_serial],
    "fwd128_snake": [_switch("L2_GROUPS", "D == 128", "false")],
    # the forward's wait watchdog trapping inline, which holds the
    # consumers to the launch's 168 registers: the loop spills
    "fwd128_inline_trap": [("flash_attn.cu",
                            "hopper::mbar_wait<D == 128>(bar, parity);",
                            "hopper::mbar_wait(bar, parity);")],
    "fwd_l2_groups": [_switch("L2_GROUPS", "D == 128", "true")],
    "fwd128_turns": _turns("D == 128"),
    "fwd128_bar_turns": _turns("D == 128", bar=True),
    "fwd128_one_release": [_switch("K_RELEASE", "D == 128", "false")],
    "fwd128_together": _TOGETHER,
    "fwd128_pv_first": _PV_FIRST,
    "fwd128_few_chains": _FEW_CHAINS,
    "clocks": [("flash_attn.cu",) + r for r in _CLOCKS],
    # The head_dim-128 dK/dV before its redesign: the serial loop (the
    # products of a query tile, then its P^T / dS^T, then the next
    # products), the plain item order, the inlined trap, two K/V buffers
    # and 2 Q/dO stages.
    "dkv128_before": [_dkv("TRAP_OUT_OF_LINE", "false"),
                      _dkv("L2_GROUPS", "false"), _dkv("OVERLAP", "false"),
                      _dkv_ring(2, 2)],
    # Each switch of the redesign turned off alone.
    "dkv128_inline_trap": [_dkv("TRAP_OUT_OF_LINE", "false")],
    "dkv128_snake": [_dkv("L2_GROUPS", "false")],
    "dkv128_serial": [_dkv("OVERLAP", "false")],

    # The ring: two K/V buffers and 2 stages (the ring before), one
    # buffer and 3 stages; two buffers and 3 stages, each stage's lse and
    # delta after the ring (so they fit), and with the next item's K and V
    # loaded as soon as the consumers take an item's first tile.
    "dkv128_two_kv": [_dkv_ring(2, 2)],
    "dkv128_stages_3": [_dkv_ring(1, 3)],
    "dkv128_two_kv_3": [_dkv_ring(2, 3)] + _DKV_ROWS_APART,
    # dK and dV from the registers, the K/V buffer freed before them.
    "dkv128_direct_store": _DKV_DIRECT_STORE,
    "dkv128_two_kv_ahead": ([_dkv_ring(2, 3)] + _DKV_ROWS_APART
                            + [_DKV_KV_AHEAD, _DKV_KV_NEXT]),
    # The overlaps that do not fit in the registers.
    "dkv128_split": [("flash_attn.cu", _DKV_AHEAD, _DKV_SPLIT)],
    "dkv128_together": [("flash_attn.cu", _DKV_AHEAD, _DKV_TOGETHER)],
    "dkv128_clocks": [("flash_attn.cu",) + r for r in _DKV_CLOCKS],
    # The head_dim-128 dQ: the form before its redesign, its phase clocks
    # and the committed form's; each switch of the redesign off alone; the
    # rings (Q/dO item buffers, K/V stages) and lse / delta staged by the
    # producer; S_{t+1} and dP_{t+1} issued before dS_t.
    "dq128_before": _DQ128_BEFORE,
    "dq128_before_clocks": _DQ128_BEFORE + [
        ("flash_attn.cu",) + r for r in _DQ_CLOCKS],
    "dq128_clocks": [("flash_attn.cu",) + r for r in _DQ_CLOCKS],
    # the committed form, timed as the other dq128 variants are (its dQ
    # alone; "committed" times the three kernels one after another)
    "dq128_after": [],
    "dq128_inline_trap": _dq_form(TRAP_OUT_OF_LINE="false"),
    "dq128_snake": _dq_form(L2_GROUPS="false"),
    "dq128_store_in_q": _dq_form(STORE_APART="false"),
    "dq128_whole_q": _dq_form(Q_HALVES="false"),
    "dq128_lead_0": _dq_form(KV_LEAD="0"),
    "dq128_lead_3": _dq_form(KV_LEAD="D == 64 ? 0 : 3"),
    "dq128_lead_4": _dq_form(KV_LEAD="D == 64 ? 0 : 4"),
    "dq128_two_q": _dq_form(**_DQ128_TWO_Q),
    "dq128_one_q_4": _dq_form(STORE_APART="false", Q_HALVES="false",
                              KV_LEAD="0"),
    "dq128_one_q_5": _dq_form(STORE_APART="false", Q_HALVES="false",
                              KV_LEAD="0", STAGES="D == 64 ? 4 : 5"),
    # The forms that were measured and dropped: lse and delta staged by the
    # producer warp, the next item's Q and dO prefetched into the L2
    # cache, dQ out by TMA stores, and S_{t+1} / dP_{t+1} before dS_t.
    "dq128_rows": _dq_form(Q_HALVES="false") + _DQ_ROWS,
    "dq128_prefetch": _DQ_PREFETCH,
    "dq128_tma_store": _DQ_TMA_STORE,
    "dq128_ahead": [("flash_attn.cu", _DQ_OVERLAP, _DQ_AHEAD)],
}
ITEM_PHASES = ["to the item", "Q/K/V waits", "issue, S wait",
               "softmax", "last P V wait", "epilogue", "zero O, pack P"]
TILE_PHASES = ["K/V waits", "issue", "S wait", "softmax", "P V wait",
               "rescale, pack"]
DKV_ITEM_PHASES = ["to the item", "K/V wait", "skipped tiles", "first tile",
                   "last dK/dV", "epilogue"]
DKV_TILE_PHASES = ["Q/dO wait", "issue S^T, dV, dK", "S^T wait", "P^T",
                   "dV/dK wait", "dP^T", "dS^T", "pack"]
DQ_ITEM_PHASES = ["to the item", "Q/dO wait, lse/delta", "first tile",
                  "last dQ wait", "skipped tiles", "epilogue"]
DQ_TILE_PHASES = ["K/V wait", "issue S, dP, dQ", "S/dP wait", "dS",
                  "dQ wait", "pack"]


def variant_source(name: str) -> str:
    """A copy of csrc/ with the variant's replacements, under build/
    (its library, built from it, stays beside it: a variant named again
    in one run is timed again, not built again)."""
    out = os.path.join(os.path.dirname(build.BUILD_DIR), "probe", name)
    for fname in os.listdir(SOURCES):
        if fname.endswith((".cu", ".cuh")):
            os.makedirs(out, exist_ok=True)
            shutil.copy(os.path.join(SOURCES, fname), out)
    for fname, old, new, *scope in VARIANTS[name]:
        path = os.path.join(out, fname)
        with open(path) as f:
            text = f.read()
        # A replacement scoped to a struct applies inside its braces.
        start = text.index(scope[0]) if scope else 0
        end = text.index("\n};\n", start) if scope else len(text)
        if text.count(old, start, end) != 1:
            raise ValueError(f"{name}: {old!r} is not in {fname} once")
        text = text[:start] + text[start:end].replace(old, new) + text[end:]
        with open(path, "w") as f:
            f.write(text)
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


def clocks(lib, launch, item_phases=ITEM_PHASES, tile_phases=TILE_PHASES):
    """Where a consumer warpgroup's clocks go over 10 launches: the sums
    of each phase a warpgroup, the item phases first, then the loop
    tile's; counts of items and loop tiles in the last two."""
    buf = (ctypes.c_ulonglong * 32)()
    lib.flash_probe_clocks.argtypes = [ctypes.c_void_p]
    lib.flash_probe_clocks.restype = ctypes.c_int
    lib.flash_probe_clocks(ctypes.addressof(buf))  # zero
    for _ in range(10):
        launch()
    torch.cuda.synchronize()
    if lib.flash_probe_clocks(ctypes.addressof(buf)):
        raise RuntimeError("reading the clocks failed")
    out = {}
    first_tile = len(item_phases)
    for wg in range(2):
        c = buf[16 * wg:16 * wg + 16]
        items, tiles = c[14], c[15]
        out[f"warpgroup {wg}"] = {
            "items": items // 10, "loop tiles": tiles // 10,
            "clocks an item": {n: round(c[i] / max(items, 1)) for i, n in
                               enumerate(item_phases)},
            "clocks a loop tile": {n: round(c[first_tile + i] / max(tiles, 1))
                                   for i, n in enumerate(tile_phases)},
        }
    return out


# dQ of ``dq128_before`` at each head_dim-128 shape, once it has run: the
# bits every later variant's dQ is held to.
_BEFORE_DQ = {}


def plain_refs(inputs):
    """The plain versions' outputs at a shape of ``inputs``, computed at
    its first use and kept for the run: (o, lse, delta, dq, dk, dv)."""
    memo = {}

    def get(label):
        if label not in memo:
            q, k, v, do = inputs[label]
            o_ref, lse_ref = attn._fwd_plain(q, k, v, True)
            delta = attn.attention_delta(o_ref, do)
            dq_ref = attn._bwd_dq_plain(q, k, v, do, lse_ref, delta, True)
            dk_ref, dv_ref = attn._bwd_dkv_plain(q, k, v, do, lse_ref, delta,
                                                 True)
            memo[label] = (o_ref, lse_ref, delta, dq_ref, dk_ref, dv_ref)
            torch.cuda.empty_cache()
        return memo[label]

    return get


def probe(name, inputs, refs):
    """The variant built anew (so ``ptxas -v`` speaks for it), timed and
    held to the plain versions at every shape of ``inputs`` (a dq128
    variant: its dQ alone at the head_dim-128 shapes, and its bits against
    ``dq128_before``'s once that has run)."""
    build.CSRC = variant_source(name)
    root, build.BUILD_DIR = build.BUILD_DIR, os.path.join(build.CSRC,
                                                          "kernels")
    build._LIBS.clear()
    try:
        path, _, ptxas = build.build("flash_attn")
        lib = attn._lib()
    finally:
        build.BUILD_DIR = root
    res = {"ptxas": [ln.strip() for ln in ptxas.splitlines()
                     if "spill" in ln or "registers" in ln or "C75" in ln
                     or "Compiling entry" in ln],
           "sass_highest_register": build.sass_registers(path)}
    dq_only = name.startswith("dq128")
    for label, (q, k, v, do) in inputs.items():
        d128 = q.shape[-1] == 128
        if dq_only and not d128:
            continue
        o_ref, lse_ref, delta, dq_ref, dk_ref, dv_ref = refs(label)
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
        if dq_only:
            row = {"flash_bwd_dq_ms": time_ms(dq_),
                   "tile_rel_err": attn.tile_rel_err(dq, dq_ref)}
        else:
            row = {"flash_fwd_ms": time_ms(fwd),
                   "flash_bwd_dq_ms": time_ms(dq_),
                   "flash_bwd_dkv_ms": time_ms(dkv)}
            row["tile_rel_err"] = max(attn.tile_rel_err(a, r) for a, r in (
                (o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)))
            row["lse_err"] = (lse - lse_ref).abs().max().item()
        if d128:
            if name == "dq128_before":
                _BEFORE_DQ[label] = dq.clone()
            row["dq_equals_before"] = (torch.equal(dq, _BEFORE_DQ[label])
                                       if label in _BEFORE_DQ else None)
        if name == "clocks":
            row["clocks"] = clocks(lib, fwd)
        if name == "dkv128_clocks" and d128:
            row["clocks"] = clocks(lib, dkv, DKV_ITEM_PHASES,
                                   DKV_TILE_PHASES)
        if name.endswith("clocks") and name.startswith("dq128"):
            row["clocks"] = clocks(lib, dq_, DQ_ITEM_PHASES, DQ_TILE_PHASES)
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
    refs = plain_refs(inputs)
    for name in names or list(VARIANTS):
        try:
            res = probe(name, inputs, refs)
        except RuntimeError as e:  # a variant nvcc refuses
            res = {"error": str(e)[-4000:]}
        print(name, json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
