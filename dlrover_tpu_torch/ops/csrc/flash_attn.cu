// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of dlrover_tpu/ops/attention.py:
//   fwd_kernel      <- _fwd_kernel      (attention.py:61, pallas_call :154)
//   bwd_dq_kernel   <- _bwd_dq_kernel   (attention.py:179, pallas_call :318)
//   bwd_dkv_kernel  <- _bwd_dkv_kernel  (attention.py:230, pallas_call :340)
//
// What they compute is the TPU kernels' arithmetic: online softmax with
// fp32 running max m, row sum l and output accumulator; masked scores are
// -1e30 and their probabilities exactly 0; a row with l == 0 divides by 1;
// the causal mask is rows >= cols aligned top-left; backward recomputes P
// from the forward's logsumexp (fp32 [B*H, S], natural log, m + log(l))
// and takes dS = P * (dP - delta), with delta = rowsum(dO * O) computed by
// the caller; P and dS are rounded to bf16 only as operands of their
// tensor-core products. dQ and dK/dV stay two passes, as in the
// reference, so no atomics are needed.
//
// What bounds them on an H100: at the GPT-2 shape (B*H = 192, S = 1024,
// D = 64, causal) the forward does 25.8 GFLOP on 101 MB (q, k, v, o,
// lse), 254 FLOP/byte: just under the card's ~295 FLOP/byte ridge, so its
// bound is the bytes (0.030 ms), with the tensor cores close behind
// (0.026 ms); the backward passes do 1.5x and 2x the FLOPs on a little
// more data and are bound by the tensor cores (0.039 ms dQ, 0.052 ms
// dK/dV). Reaching either needs the tensor cores fed at their Hopper rate
// and the exponentials and loads hidden under them.
//
// The three kernels are built for that (hopper.cuh holds the pieces).
// All are persistent: one block on each SM walks the work items
// in a snake order, heaviest first (snake_item). A block is three
// warpgroups: one producer thread issues every load through TMA
// (cp.async.bulk.tensor: 128-byte swizzled tiles, zero-filled past S)
// into rings of shared-memory stages guarded by full and empty mbarriers,
// and two consumer warpgroups, each owning 64 rows, issue wgmma with the
// accumulators in registers; setmaxnreg moves the producer's registers to
// the consumers (24 and 240 a thread; ptxas -v reports the 168 a thread
// that the launch of 384 threads allocates, and a 512-thread block of
// three consumer warpgroups, 128 a thread, spills).
// Scores never leave registers: the softmax works on each thread's pieces
// of two rows (the max and sum reduce over the 4 lanes of a quad), P or
// dS is packed to bf16 in registers and is the A operand of the next
// wgmma, and only the tiles that cross the diagonal or the ragged end
// test the mask.
//   fwd_kernel at D = 64: 128 query rows of one (b, h) an item; Q in two
//     buffers, K and V in 128-row tiles through 4 stages (165 KB of shared
//     memory); S = Q K^T by m64n128k16, exp2 on prescaled scores, O += P V
//     by m64n64k16 with V MN-major. Inside a warpgroup, S_t = Q K_t^T and
//     O += P_{t-1} V_{t-1} are issued together and the softmax of S_t runs
//     while the second product does, across items too (an item's last
//     P V goes with the next item's first S). What bounds it on the H100
//     (ops/flash_probe.py's phase clocks): the softmax, about 1,250-1,500
//     clocks a 128 x 128 tile a warpgroup, where its 8,192 exponentials
//     alone take 512 (MUFU: 16 a clock an SM, the same time as the tile's
//     products at D = 64) and the two warpgroups' softmaxes overlap; then
//     issuing behind the other warpgroup's products, the K/V waits, and
//     each item's first tile and epilogue.
//   bwd_dkv_kernel: 128 kv rows of one (b, h) an item; K and V once (two
//     buffers, so the next item's load overlaps this one's end), then
//     64-row tiles of Q and dO (with lse and delta, which the producer warp
//     loads) through 3 stages (119 KB); S^T = K Q^T and dP^T = V dO^T
//     (m64n64k16, the kv rows as M), P^T and dS^T in registers, dV += P^T
//     dO and dK += dS^T Q with dO and Q MN-major; the low kv tiles (the
//     most query tiles) come first. At D = 64 its products and its softmax
//     do not overlap inside a warpgroup; the two warpgroups and the load
//     ring are what overlap. It keeps 168 registers a thread with a
//     16-byte spill (SASS R177).
//   bwd_dq_kernel: dK/dV with Q and K/V swapped. 128 query rows of one
//     (b, h) an item, the last query tiles first; Q and dO once (two
//     buffers), then 64-row tiles of K and V through 4 stages (129 KB);
//     each consumer warpgroup keeps its 64 rows' lse (times log2 e) and
//     delta in registers; S = Q K^T and dP = dO V^T (m64n64k16, both
//     K-major), dS in registers, dQ += dS K with K MN-major; dQ goes out
//     through the item's Q buffer. Inside a warpgroup, S and dP of tile t
//     go out with dQ += dS_{t-1} K_{t-1}, and dS_t is computed while the
//     second product runs (4-8% faster on the H100 than one after the
//     other: ops/flash_probe.py's dq_serial). In a causal item warpgroup 0
//     skips the last kv tile, which none of its rows sees.
//
// Head_dim 128 (LLaMA's): the same three kernels, templated on D. A
// 128-wide tile lies as two 64-column panels (hopper.cuh), each a TMA box
// with the 128-byte swizzle; a K-major operand steps to the second panel
// after its fourth k-step, and the products with an MN-major B (P V,
// P^T dO, dS^T Q, dS K) are m64n128k16 with the descriptor's leading
// offset stepping between panels. Tiles and warpgroups stay as at D = 64;
// what shrinks is the rings, to fit 227 KB of shared memory: the forward
// keeps 2 K/V stages (192 KB), dQ one Q/dO buffer, 4 K/V stages and a dQ
// buffer (225 KB), dK/dV one K/V buffer and 4 Q/dO stages (197 KB). The
// accumulators double: the forward's O and dQ's hold 64 fp32 a thread,
// dK/dV's dK and dV 64 each beside S^T and dP^T (32 each), within the
// 240 registers setmaxnreg gives a consumer.
//   The forward at D = 128 runs the D = 64 loop and adds two things to
// it (Fwd<128>; each measured on the H100 with ops/flash_probe.py, which
// also keeps the forms that were dropped; PERF.md, section 6): with 2
// stages, a K tile goes back to the producer as soon as its S is in
// (K_RELEASE: freed with its V after the P V, it left the producer no
// lookahead); the items go in groups of (b, h) whose K and V fit in half
// the L2 cache (L2_GROUPS: at 4 x 2048 the 64 (b, h) hold 64 MB of K and
// V, which the plain order read again from HBM for every query tile).
// Its S, O and P (64 + 64 + 32 fp32 a thread) fit only in the 240
// registers setmaxnreg gives: a trap inlined into the consumers' code
// (mbar_wait's watchdog) held them to the launch's 168, and the loop
// spilled and serialised its wgmmas, so the forward traps out of line
// (hopper::deadlock). Measured and dropped, at 4 x 2048 / 1 x 8192 (16
// heads, causal) on an H100 80GB HBM3 at 700 W, where this form takes
// about 0.132 / 0.42 ms: FlashAttention-3's ping-pong, the two
// warpgroups issuing their products in strict turns (fwd128_turns, about
// 0.132 / 0.44 ms through mbarriers; through named barriers, which wait
// without a limit, 1-2% faster at 4 x 2048 only), as each softmax
// already runs under its own warpgroup's P V; the softmax after both
// products (fwd128_together) and P V waited for before S
// (fwd128_pv_first), each about 0.139 / 0.46-0.47. What bounds it (the
// probe's phase clocks): a warpgroup's softmax (about 1,400-1,600 clocks
// a tile) against its and the other warpgroup's products (about 1,000
// each), the issue behind those products, the K/V waits, and each item's
// first tile and epilogue.
//   dK/dV at D = 128 runs the D = 64 kernel plus four things (Dkv<128>;
// each measured on the H100 with ops/flash_probe.py, which keeps the forms
// that were dropped; PERF.md, section 6), at 4 x 2048 / 1 x 8192 (16
// heads, causal) 0.2485 / 0.8785 ms against the D = 64 design's 0.2958 /
// 0.9612 in one call: its waits trap out of line (TRAP_OUT_OF_LINE: the
// inlined trap cost 3% and 2%, though it never held dK/dV to 168
// registers, SASS R235); the items go in groups of (b, h) whose Q and dO
// fit in half the L2 cache (L2_GROUPS, 22 (b, h) at 4 x 2048: the 64 (b,
// h) hold 64 MB of Q and dO, which the plain order streamed again from
// HBM for every kv tile; 10% at 4 x 2048, none at 1 x 8192); inside a
// warpgroup S^T_t goes out with dV += P^T_{t-1} dO_{t-1} and dK +=
// dS^T_{t-1} Q_{t-1}, and P^T_t is computed while they run, then dP^T_t
// and dS^T_t (OVERLAP; 6% and 10%); the ring is one K/V buffer and 4
// Q/dO stages, as the overlap holds two tiles a warpgroup (two buffers and
// 2 stages: 39% and 29% slower; two buffers and 3 stages, which fit with
// each stage's lse and delta after the ring, even with the next item's
// K/V loaded a ring ahead: 9% and 5%). Its live registers peak at 192 a
// thread, as the serial loop's do (SASS R235, no spill): the overlaps
// that also put dP^T_t, or dP^T_t and dS^T_t, under tile t - 1's
// products keep 208 or 224 live, and ptxas spills them and serialises
// every wgmma (C7512), 0.33 and 0.44 ms. dK and dV written from the
// registers, the K/V buffer freed before them, were 8% and 3% slower.
// What bounds it (the probe's phase clocks): a tile's dP^T, dS^T and
// packing, which no product of its own warpgroup covers, the Q/dO waits,
// and each item's K/V wait, first tile and epilogue, about a fifth of a
// block's clocks.
//   dQ at D = 128 runs the D = 64 loop (S_t and dP_t issued with dQ +=
// dS_{t-1} K_{t-1}, dS_t computed under that product) and adds five
// things to it (Dq<128>; each measured on the H100 with
// ops/flash_probe.py, which keeps the forms that were dropped; PERF.md,
// section 6), at 4 x 2048 / 1 x 8192 (16 heads, causal) 0.1706 / 0.6189
// ms against the old form's 0.2010 / 0.7145 in one call, dQ bit for bit
// the same: its waits trap out of line (TRAP_OUT_OF_LINE: the old loop
// needed only 167 registers, and the inlined trap held it only once the
// probe's clock marks were added; inlined in the new form it spills);
// the items go in groups of (b, h) whose K and V fit in half the L2
// cache (L2_GROUPS, 22 (b, h) at 4 x 2048, 4 at 1 x 8192: the 64 (b, h)
// hold 64 MB of K and V, which the plain order read again for every
// query tile; 6% at 4 x 2048); the ring is one Q/dO buffer and 4 K/V
// stages (two buffers and 3 stages, the old ring, 11% / 13% slower); dQ
// goes out through a buffer of its own, so that the Q/dO buffer goes
// back to the producer once the item's last S and dP are in
// (STORE_APART, 1-2%), and that buffer is two halves, a warpgroup's rows
// each, freed and filled on their own (Q_HALVES, 2%: in a causal item
// warpgroup 0 ends a tile sooner); the producer loads an item's first 2
// K/V tiles between its halves (KV_LEAD; none 1% / 4% slower, 3 or 4
// no better). Its consumers reach SASS R214, no spill. Measured and
// dropped: lse and delta staged by the producer warp beside Q and dO
// (3-6% slower), the next item's Q and dO prefetched into the L2 cache
// (2-5% slower), dQ out by TMA stores (its epilogue's clocks fell from
// about 2,000 to 1,200 an item, its time did not), and S_{t+1} / dP_{t+1}
// issued before dS_t (a second S/dP set: ptxas serialises the wgmmas,
// C7518, 30-36% slower). What bounds it (the probe's phase clocks): the
// tile's products, which the two warpgroups take in turn (an issue of
// S, dP and dQ waits about 930 clocks for the tensor cores), its dS
// (about 620 clocks), which only the dQ product covers, the K/V waits
// (about 330 clocks a tile: the blocks read K and V from the L2 cache
// near its rate), and each item's Q/dO wait, first tile and epilogue,
// about a sixth of a block's clocks.
//
// Inputs are bf16 [B, S, H, D], D 64 or 128, read through their strides
// (head_dim stride 1, the others multiples of 8 elements, each at least
// the extent of the one inside it: the wrapper copies anything else).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (dlrover_tpu_torch/ops/build.py). Every entry
// returns cudaGetLastError() after its launch; the wrapper raises on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <vector>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Layout {
  long long b, s, h;  // element strides of [B, S, H, D]; D stride is 1
};

// The most dynamic shared memory a block may use on an H100.
constexpr size_t kMaxSmem = 232448;

// ------------------------------------------------------- Hopper kernels

constexpr int WG = 128;                  // threads of a warpgroup
constexpr int HOPPER_THREADS = 3 * WG;   // two consumer warpgroups, a producer
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int ROW_BYTES = 128;           // one swizzled panel row

// What setmaxnreg hands out must have been allocated at launch, or the
// consumers' request waits forever: 128 x 24 + 256 x 240 = 384 x 168.
static_assert(WG * PRODUCER_REGS + 2 * WG * CONSUMER_REGS <=
                  HOPPER_THREADS * 168,
              "register hand-off exceeds the launch allocation");

// The first 1024-byte boundary of the dynamic shared memory (the 128-byte
// swizzle repeats every 8 rows of 128 bytes).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = hopper::smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// Byte offset of 16-byte chunk ``chunk`` of row ``row`` in a 128-byte
// swizzled panel (the layout TMA writes).
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return row * ROW_BYTES + ((chunk ^ (row & 7)) << 4);
}

// Bytes of a tile of ``rows`` rows of D bf16: D / 64 panels of ``rows``
// x 128 bytes.
template <int D>
constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

// Shared-memory address of k-step ``kk`` (16 columns) of a K-major
// operand whose rows start at ``addr`` in the first panel of a tile whose
// panels lie ``panel`` bytes apart.
__device__ __forceinline__ uint32_t k_step(uint32_t addr, int kk, int panel) {
  return addr + (kk / 4) * panel + (kk % 4) * 32;
}

// Descriptor of an MN-major B operand (N = head_dim contiguous) at
// ``addr``, its 64-column panels ``panel`` bytes apart. At D = 64 it is
// the one panel's descriptor the head_dim-64 kernels always used.
template <int D>
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, int panel) {
  return D == 64 ? hopper::desc_mn_major(addr)
                 : hopper::desc_mn_major(addr, panel);
}

// Loads the tile of ``rows`` rows at s0 of (b, h): one TMA box a panel,
// all counted by ``bar``.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int rows, int h,
                                          int s0, int b) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) {
    hopper::tma_load_4d(dst + p * rows * ROW_BYTES, map, bar, 64 * p, h, s0,
                        b);
  }
}

// Writes a warpgroup's 64 x D fp32 accumulator, times ``mul``, as bf16
// rows [row0, row0 + 64) of a strided output, at most ``nrows`` of them.
// The tile goes through ``stage`` (64 rows of each panel, ``panel`` bytes
// apart: 8 KB a panel of shared memory the warpgroup alone uses) so that
// every global store is a whole 16-byte chunk.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul0, float mul1,
                                           unsigned char* stage, int panel,
                                           bf16* out, long long row_stride,
                                           int row0, int nrows, int wg) {
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
    const float mul = i ? mul1 : mul0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(stage + (n / 8) * panel +
                                   swizzled(r, n % 8) + (lane % 4) * 4) =
          hopper::pack_bf16(acc[4 * n + 2 * i] * mul,
                            acc[4 * n + 2 * i + 1] * mul);
    }
  }
  hopper::named_sync(1 + wg, WG);
  for (int c = tid; c < 64 * (D / 8); c += WG) {
    const int r = c / (D / 8), chunk = c % (D / 8);
    if (row0 + r < nrows) {
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * row_stride +
                                chunk * 8) =
          *reinterpret_cast<const uint4*>(stage + (chunk / 8) * panel +
                                          swizzled(r, chunk % 8));
    }
  }
}

// Round j of a persistent kernel's walk over its work items, heaviest
// first: the blocks take items j G .. j G + G - 1 (G = gridDim.x), in
// reverse block order in odd rounds, so that a block that took a heavier
// item in one round takes a lighter one in the next. -1 past the end.
__device__ __forceinline__ int snake_item(int j, int n_items) {
  const int g = gridDim.x;
  const int i = j * g + (j % 2 ? g - 1 - (int)blockIdx.x : (int)blockIdx.x);
  return i < n_items ? i : -1;
}

constexpr int FBM = 128;                 // query rows per block
constexpr int FBN = 128;                 // kv rows per tile
constexpr int FWD_QBUF = 2;  // Q buffers
constexpr int kFwdPanel = FBN * ROW_BYTES;  // a panel of Q, K or V

template <int D>
struct Fwd {
  static constexpr int STAGES = D == 64 ? 4 : 2;  // K/V ring
  // What the head_dim-128 loop adds to the head_dim-64 one (fwd_kernel):
  // K_RELEASE, a K tile goes back to the producer once S = Q K^T is in,
  // not with its V tile; L2_GROUPS, the items of a group of (b, h) whose K
  // and V fit in half the L2 cache come before the next group's.
  static constexpr bool K_RELEASE = D == 128;
  static constexpr bool L2_GROUPS = D == 128;
  static constexpr int TILE = tile_bytes<D>(FBN);
  static constexpr int BARRIERS =
      2 * FWD_QBUF + (K_RELEASE ? 4 : 3) * STAGES;
  static constexpr size_t SMEM = 1024 + (FWD_QBUF + 2 * STAGES) * TILE +
                                 BARRIERS * sizeof(uint64_t);
  static_assert(SMEM <= kMaxSmem, "forward shared memory");
};

// A forward work item: its query tile (of FBM rows) and (b, h).
struct FwdItem {
  int q_tile, bh;
};

// Item ``item`` of the forward's walk in groups of ``group`` (b, h)
// (Fwd<D>::L2_GROUPS; the last group may hold fewer): the blocks at work
// at once then read the K/V tiles of a few (b, h), which stay in the L2
// cache from one query tile to the next, where all of them would not.
// Inside a group the query tiles go heaviest first in the last group and
// every second one before it, and lightest first in the others, so that
// the tiles' weights rise and fall smoothly across groups (snake_item
// pairs a block's heavy item with a light one in the next round) and end
// light. The kernel walks it, and the host's choice of ``group``
// (fwd_l2_group) models that walk.
__host__ __device__ __forceinline__ FwdItem grouped_item(int item, int BH,
                                                         int n_q, int group) {
  const int g = item / (n_q * group), g0 = g * group;
  const int size = BH - g0 < group ? BH - g0 : group;
  const int n_groups = (BH + group - 1) / group;
  const int r = item % (n_q * group), i = r / size;
  return {(n_groups - 1 - g) % 2 ? i : n_q - 1 - i, g0 + r % size};
}

// One online-softmax step over a tile of raw scores ``s`` (64 rows x 128
// columns of a warpgroup; this thread holds pieces of rows row0 and row0 +
// 8 at columns 8 n + col_off + j): s becomes P = exp2(s scale log2 e - m
// scale log2 e), the running max m (of raw scores) and this thread's share
// of the row sums l move on, and ``corr`` is what the output rows must be
// multiplied by. Only a MASKED tile (across the diagonal or the ragged
// end) tests the mask: one compare a score against a bound per row.
// Maxima run as eight independent chains a row, sums as four.
template <bool MASKED>
__device__ __forceinline__ void online_softmax(
    float (&s)[64], float (&m_run)[2], float (&l_part)[2], float (&corr)[2],
    float scale_log2, int k0, int row0, int col_off, int Sk, int causal) {
  if (MASKED) {
    // Row i sees its columns 8 n + j (from k0 + col_off) up to lim[i].
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lim[i] = Sk - 1 - k0 - col_off;
      if (causal) lim[i] = min(lim[i], row0 + 8 * i - k0 - col_off);
    }
#pragma unroll
    for (int idx = 0; idx < 64; ++idx) {
      if (8 * (idx / 4) + idx % 2 > lim[(idx / 2) % 2]) s[idx] = NEG_INF;
    }
  }
  // idx = 4 n + 2 i + j: row i, chain (n % 4, j).
  float mx[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) mx[i][c] = m_run[i];
  }
#pragma unroll
  for (int idx = 0; idx < 64; ++idx) {
    float& m = mx[(idx / 2) % 2][2 * ((idx / 4) % 4) + idx % 2];
    m = fmaxf(m, s[idx]);
  }
  float m_scaled[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float m_new = fmaxf(fmaxf(fmaxf(mx[i][0], mx[i][1]),
                              fmaxf(mx[i][2], mx[i][3])),
                        fmaxf(fmaxf(mx[i][4], mx[i][5]),
                              fmaxf(mx[i][6], mx[i][7])));
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));
    corr[i] = hopper::fast_exp2((m_run[i] - m_new) * scale_log2);
    m_run[i] = m_new;
    // A row masked so far keeps m = -1e30: its scores are scaled against
    // 0, so that exp2 gives 0 for them and not exp2(0) = 1.
    m_scaled[i] = m_new <= NEG_INF * 0.5f ? 0.0f : m_new * scale_log2;
  }
  float sum[2][4] = {};
#pragma unroll
  for (int idx = 0; idx < 64; ++idx) {
    const int i = (idx / 2) % 2;
    const float p = hopper::fast_exp2(fmaf(s[idx], scale_log2, -m_scaled[i]));
    s[idx] = p;
    sum[i][2 * ((idx / 4) % 2) + idx % 2] += p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_part[i] = l_part[i] * corr[i] +
                ((sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]));
  }
}

// The tile's softmax, with the mask tests only where the tile needs them.
__device__ __forceinline__ void online_softmax(
    float (&s)[64], float (&m_run)[2], float (&l_part)[2], float (&corr)[2],
    float scale_log2, bool masked, int k0, int row0, int col_off, int Sk,
    int causal) {
  if (masked) {
    online_softmax<true>(s, m_run, l_part, corr, scale_log2, k0, row0,
                         col_off, Sk, causal);
  } else {
    online_softmax<false>(s, m_run, l_part, corr, scale_log2, k0, row0,
                          col_off, Sk, causal);
  }
}

// P as the register A operand of P V: the accumulator's layout, packed to
// bf16 pairs, 16 kv columns a k-step.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[FBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < FBN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[kk][r] = hopper::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
  }
}

// S = Q K^T for a warpgroup's 64 query rows against a 128-row K tile.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hopper::wgmma_m64n128k16_ss(
        s, hopper::desc_k_major(k_step(q_addr, kk, kFwdPanel)),
        hopper::desc_k_major(k_step(k_addr, kk, kFwdPanel)), kk);
  }
  hopper::wgmma_commit();
}

// O += P V for a 128-row V tile (MN-major: head_dim is contiguous).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o_acc)[D / 2],
                                         const uint32_t (&pa)[FBN / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < FBN / 16; ++kk) {
    hopper::wgmma_rs_tb(o_acc, pa[kk],
                        mn_desc<D>(v_addr + kk * 16 * ROW_BYTES, kFwdPanel));
  }
  hopper::wgmma_commit();
}

// A persistent kernel: one block on each SM walks the work items (query
// tile of 128 rows, batch*head) in snake_item's order, the heaviest
// causal tiles first, so that each SM gets a like share; the producer
// loads the next item's Q and first K/V tiles while the consumers finish
// the last one. Each item loops over its kv tiles; inside a consumer
// warpgroup the products of tile t (S_t = Q K_t^T and O += P_{t-1}
// V_{t-1}) are issued together, and the softmax of S_t runs while the
// second one does. An item's last P V goes out with the next item's first
// S = Q K^T in the same way, and its epilogue follows that softmax.
template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
           float* __restrict__ lse, int BH, int H, int Sq, int Sk, Layout lo,
           float scale_log2, int causal, int group) {
  using F = Fwd<D>;
  // At D = 128 a wait that never ends traps out of line, which leaves the
  // consumers setmaxnreg's registers (hopper::deadlock).
  auto wait = [](uint64_t* bar, uint32_t parity) {
    hopper::mbar_wait<D == 128>(bar, parity);
  };
  constexpr int FWD_STAGES = F::STAGES, kFwdTile = F::TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sK = sQ + FWD_QBUF * kFwdTile;
  unsigned char* sV = sK + FWD_STAGES * kFwdTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + FWD_STAGES * kFwdTile);
  uint64_t* q_empty = q_full + FWD_QBUF;
  uint64_t* k_full = q_empty + FWD_QBUF;
  uint64_t* v_full = k_full + FWD_STAGES;
  uint64_t* empty = v_full + FWD_STAGES;  // a stage's V (and K) is read
  // A stage's K is read: barriers of its own with K_RELEASE.
  uint64_t* k_empty = F::K_RELEASE ? empty + FWD_STAGES : empty;

  const int n_q = (Sq + FBM - 1) / FBM, n_items = n_q * BH;
  // Item i: query tile n_q - 1 - i / BH of (b, h) = i % BH, and its kv
  // tiles, so the heaviest causal tiles come first; with L2_GROUPS the
  // items go group by group (grouped_item).
  auto item_at = [&](int item) -> FwdItem {
    if constexpr (F::L2_GROUPS) {
      return grouped_item(item, BH, n_q, group);
    } else {
      return {n_q - 1 - item / BH, item % BH};
    }
  };
  auto n_kv_of = [&](int q0) {
    const int n = (Sk + FBN - 1) / FBN;
    return causal ? min(n, (q0 + FBM - 1) / FBN + 1) : n;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < FWD_QBUF; ++i) {
      hopper::mbar_init(q_full + i, 1);
      hopper::mbar_init(q_empty + i, 2 * WG / 32);  // one arrival a warp
    }
    for (int s = 0; s < FWD_STAGES; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(empty + s, 2 * WG / 32);
      if (F::K_RELEASE) hopper::mbar_init(k_empty + s, 2 * WG / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;

  if (wg == 2) {  // producer
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      hopper::tma_prefetch_map(&tm_q);
      hopper::tma_prefetch_map(&tm_k);
      hopper::tma_prefetch_map(&tm_v);
      int tile = 0;  // position in the K/V ring, across items
      for (int j = 0, item; (item = snake_item(j, n_items)) >= 0; ++j) {
        const FwdItem it = item_at(item);
        const int q0 = it.q_tile * FBM, b = it.bh / H, h = it.bh % H;
        const int qb = j % FWD_QBUF;
        if (j >= FWD_QBUF) {
          wait(q_empty + qb, (j / FWD_QBUF - 1) & 1);
        }
        hopper::mbar_arrive_tx(q_full + qb, kFwdTile);
        load_tile<D>(sQ + qb * kFwdTile, &tm_q, q_full + qb, FBM, h, q0, b);
        const int n_kv = n_kv_of(q0);
        for (int t = 0; t < n_kv; ++t, ++tile) {
          const int st = tile % FWD_STAGES;
          const uint32_t parity = (tile / FWD_STAGES - 1) & 1;
          if (tile >= FWD_STAGES) wait(k_empty + st, parity);
          hopper::mbar_arrive_tx(k_full + st, kFwdTile);
          load_tile<D>(sK + st * kFwdTile, &tm_k, k_full + st, FBN, h,
                       t * FBN, b);
          if (F::K_RELEASE && tile >= FWD_STAGES) {
            wait(empty + st, parity);
          }
          hopper::mbar_arrive_tx(v_full + st, kFwdTile);
          load_tile<D>(sV + st * kFwdTile, &tm_v, v_full + st, FBN, h,
                       t * FBN, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64)
    hopper::regs_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int col_off = 2 * (lane % 4);
    const uint32_t k_base = hopper::smem_addr(sK);
    const uint32_t v_base = hopper::smem_addr(sV);
    float o_acc[D / 2] = {}, s[64], corr[2];
    float m_run[2] = {NEG_INF, NEG_INF}, l_part[2] = {0.0f, 0.0f};
    uint32_t pa[FBN / 16][4] = {};
    // The previous item, whose last P V goes out with the next item's
    // first S = Q K^T: its query tile, (b, h), Q buffer, final row maxima
    // and sums, and the ring position of its last V tile (-1: none yet).
    int p_q0 = 0, p_bh = 0, p_qb = 0, p_last = -1;
    float p_m[2], p_l[2];
    // The previous item's epilogue, once its O is complete in o_acc: the
    // logsumexp, then O / l through its Q buffer (its Q rows are read),
    // which then goes back to the producer.
    auto finish = [&] {
      const int row_lo = p_q0 + wg * 64, row0 = row_lo + warp * 16 + lane / 4;
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = p_l[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float l_safe = l == 0.0f ? 1.0f : l;
        inv[i] = 1.0f / l_safe;
        const int row = row0 + 8 * i;
        if (lane % 4 == 0 && row < Sq) {
          const float m = p_m[i] <= NEG_INF * 0.5f
                              ? NEG_INF
                              : p_m[i] * scale_log2 * LN2;
          lse[(long long)p_bh * Sq + row] = m + logf(l_safe);
        }
      }
      store_rows<D>(o_acc, inv[0], inv[1],
                    sQ + p_qb * kFwdTile + wg * 64 * ROW_BYTES, kFwdPanel,
                    o + p_bh / H * lo.b + p_bh % H * lo.h, lo.s, row_lo, Sq,
                    wg);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(q_empty + p_qb);
    };
    // S = Q K^T of the K tile in stage st is in: with K_RELEASE that tile
    // goes back to the producer.
    auto release_k = [&](int st) {
      if (F::K_RELEASE && lane == 0) hopper::mbar_arrive(k_empty + st);
    };
    int tile = 0;
    for (int j = 0, item; (item = snake_item(j, n_items)) >= 0; ++j) {
      const FwdItem it = item_at(item);
      const int q0 = it.q_tile * FBM;
      const int n_kv = n_kv_of(q0), qb = j % FWD_QBUF;
      const int row_lo = q0 + wg * 64;
      const int row0 = row_lo + warp * 16 + lane / 4;
      const uint32_t q_addr =
          hopper::smem_addr(sQ + qb * kFwdTile + wg * 64 * ROW_BYTES);
      // A tile across the diagonal or the ragged end is masked.
      auto masked = [&](int k0) {
        return k0 + FBN > Sk || (causal && k0 + FBN - 1 > row_lo);
      };
      wait(q_full + qb, (j / FWD_QBUF) & 1);
      wait(k_full + tile % FWD_STAGES, (tile / FWD_STAGES) & 1);
      // Before the first item there is no P V to finish: the product is
      // issued all the same, P = 0 on whatever stage 0 holds, and its sum
      // is dropped. A branch around a wgmma would make ptxas serialise
      // every wgmma of the kernel (its warning C7520).
      const int pst = p_last >= 0 ? p_last % FWD_STAGES : 0;
      if (p_last >= 0) {
        wait(v_full + pst, (p_last / FWD_STAGES) & 1);
      }
      hopper::wgmma_fence();
      issue_qk<D>(s, q_addr, k_base + (tile % FWD_STAGES) * kFwdTile);
      issue_pv<D>(o_acc, pa, v_base + pst * kFwdTile);
      hopper::wgmma_wait<1>();  // S_0 is in; the last P V runs on
      hopper::fence_regs(s);
      release_k(tile % FWD_STAGES);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        p_m[i] = m_run[i];
        p_l[i] = l_part[i];
        m_run[i] = NEG_INF;
        l_part[i] = 0.0f;
      }
      online_softmax(s, m_run, l_part, corr, scale_log2, masked(0), 0, row0,
                     col_off, Sk, causal);
      hopper::fence_regs(s);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o_acc);
      if (p_last >= 0) {
        if (lane == 0) hopper::mbar_arrive(empty + pst);
        finish();
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.0f;
      pack_p(s, pa);
      for (int t = 1; t < n_kv; ++t) {
        const int cur = tile + t;
        const int st = cur % FWD_STAGES, prev = (cur - 1) % FWD_STAGES;
        wait(k_full + st, (cur / FWD_STAGES) & 1);
        wait(v_full + prev, ((cur - 1) / FWD_STAGES) & 1);
        hopper::wgmma_fence();
        issue_qk<D>(s, q_addr, k_base + st * kFwdTile);
        issue_pv<D>(o_acc, pa, v_base + prev * kFwdTile);
        hopper::wgmma_wait<1>();  // S_t is in; P_{t-1} V_{t-1} runs on
        hopper::fence_regs(s);
        release_k(st);
        online_softmax(s, m_run, l_part, corr, scale_log2, masked(t * FBN),
                       t * FBN, row0, col_off, Sk, causal);
        // The softmax is done before the wait, not moved below it.
        hopper::fence_regs(s);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o_acc);
        if (lane == 0) hopper::mbar_arrive(empty + prev);
#pragma unroll
        for (int idx = 0; idx < D / 2; ++idx) {
          o_acc[idx] *= corr[(idx / 2) % 2];
        }
        pack_p(s, pa);
      }
      p_q0 = q0;
      p_bh = it.bh;
      p_qb = qb;
      p_last = tile + n_kv - 1;
      tile += n_kv;
    }
    // Every block has an item (the grid is at most the item count): the
    // last one's P V and epilogue.
    const int pst = p_last % FWD_STAGES;
    wait(v_full + pst, (p_last / FWD_STAGES) & 1);
    hopper::wgmma_fence();
    issue_pv<D>(o_acc, pa, v_base + pst * kFwdTile);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o_acc);
    if (lane == 0) hopper::mbar_arrive(empty + pst);
    for (int i = 0; i < 2; ++i) {
      p_m[i] = m_run[i];
      p_l[i] = l_part[i];
    }
    finish();
  }
}

// P^T and dS^T of a dK/dV tile in place: s = P^T = exp2(S^T scale log2 e
// - lse log2 e) and dp = dS^T = P^T (dP^T - delta), where lse (already
// times log2 e) and delta belong to the columns, the query rows. Only a
// MASKED tile (the diagonal or the ragged end) tests the mask: query
// column 8 n + j of this thread's pieces (from col_off) is visible to kv
// row i when lo[i] <= 8 n + j < hi.
template <bool MASKED>
__device__ __forceinline__ void dkv_probs(float (&s)[32], float (&dp)[32],
                                          const float* s_lse,
                                          const float* s_delta,
                                          float scale_log2, int col_off,
                                          const int (&lo)[2], int hi) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = 8 * n + col_off;
    const float2 l2 = *reinterpret_cast<const float2*>(s_lse + c);
    const float2 dl = *reinterpret_cast<const float2*>(s_delta + c);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = 4 * n + r, jj = r % 2, cc = 8 * n + jj;
      float p = hopper::fast_exp2(s[idx] * scale_log2 - (jj ? l2.y : l2.x));
      if (MASKED && (cc < lo[r / 2] || cc >= hi)) p = 0.0f;
      s[idx] = p;
      dp[idx] = p * (dp[idx] - (jj ? dl.y : dl.x));
    }
  }
}

// dkv_probs in two halves, for a loop that computes each under a product
// of its own: P^T in place of S^T (dkv_p), then dS^T in place of dP^T
// (dkv_ds), with the same arithmetic.
template <bool MASKED>
__device__ __forceinline__ void dkv_p(float (&s)[32], const float* s_lse,
                                      float scale_log2, int col_off,
                                      const int (&lo)[2], int hi) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l2 =
        *reinterpret_cast<const float2*>(s_lse + 8 * n + col_off);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = 4 * n + r, jj = r % 2, cc = 8 * n + jj;
      float p = hopper::fast_exp2(s[idx] * scale_log2 - (jj ? l2.y : l2.x));
      if (MASKED && (cc < lo[r / 2] || cc >= hi)) p = 0.0f;
      s[idx] = p;
    }
  }
}

__device__ __forceinline__ void dkv_ds(const float (&s)[32], float (&dp)[32],
                                       const float* s_delta, int col_off) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 dl =
        *reinterpret_cast<const float2*>(s_delta + 8 * n + col_off);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = 4 * n + r;
      dp[idx] = s[idx] * (dp[idx] - (r % 2 ? dl.y : dl.x));
    }
  }
}

constexpr int DBN = 128;                   // kv rows per item
constexpr int DBM = 64;                    // query rows per tile
constexpr int kDkvKvPanel = DBN * ROW_BYTES;  // a panel of K or V
constexpr int kDkvPanel = DBM * ROW_BYTES;    // a panel of Q or dO

template <int D>
struct Dkv {
  // What the head_dim-128 form adds to the head_dim-64 one (bwd_dkv_kernel;
  // each measured on the H100 with ops/flash_probe.py): TRAP_OUT_OF_LINE,
  // a wait that never ends traps through hopper::deadlock, which leaves the
  // consumers setmaxnreg's registers; L2_GROUPS, the items of a group of
  // (b, h) whose Q and dO fit in half the L2 cache come before the next
  // group's; OVERLAP, inside a warpgroup S^T_t goes out with the products
  // of tile t - 1 and P^T_t is computed while those run (the ring then
  // holds two tiles a warpgroup); and a ring of one K/V buffer and 4
  // Q/dO stages in place of two buffers and 2 stages.
  static constexpr bool TRAP_OUT_OF_LINE = D == 128;
  static constexpr bool L2_GROUPS = D == 128;
  static constexpr bool OVERLAP = D == 128;
  static constexpr int KV_BUFS = D == 64 ? 2 : 1;  // K/V item buffers
  static constexpr int STAGES = D == 64 ? 3 : 4;  // Q/dO ring
  static constexpr int KV = tile_bytes<D>(DBN);    // K or V
  static constexpr int TILE = tile_bytes<D>(DBM);  // Q or dO
  static constexpr int STAGE = 2 * TILE + 1024;  // + lse and delta, aligned
  static constexpr size_t SMEM = 1024 + 2 * KV_BUFS * KV + STAGES * STAGE +
                                 (2 * KV_BUFS + 2 * STAGES) * sizeof(uint64_t);
  static_assert(SMEM <= kMaxSmem, "dK/dV shared memory");
};

// A dK/dV work item: its kv tile (of DBN rows) and (b, h).
struct DkvItem {
  int kv_tile, bh;
};

// Item ``item`` of the dK/dV walk in groups of ``group`` (b, h)
// (Dkv<D>::L2_GROUPS): grouped_item's walk over the kv tiles, the low ones
// (which see the most query tiles when causal) where it puts the high
// query tiles. The blocks at work at once then stream the Q and dO of a
// few (b, h), which stay in the L2 cache from one kv tile to the next. The
// kernel walks it, and the host's choice of ``group`` (dkv_l2_group)
// models that walk.
__host__ __device__ __forceinline__ DkvItem grouped_kv_item(int item, int BH,
                                                            int n_kv,
                                                            int group) {
  const FwdItem it = grouped_item(item, BH, n_kv, group);
  return {n_kv - 1 - it.q_tile, it.bh};
}

// The first query tile of a dK/dV item at kv row k0: the diagonal's when
// causal. With OVERLAP every item takes one tile at least (a kv tile past
// every query row sees a masked one), so that a warpgroup's loop, which
// holds no branch around a wgmma, always runs.
template <int D>
__host__ __device__ __forceinline__ int dkv_first_tile(int k0, int n_q,
                                                       int causal) {
  const int last = Dkv<D>::OVERLAP ? n_q - 1 : n_q;
  return !causal ? 0 : k0 / DBM < last ? k0 / DBM : last;
}

// A persistent kernel: one block on each SM walks the work items (kv tile
// of 128 rows, batch*head) in snake_item's order, the low kv tiles (which
// see the most query tiles) first; with L2_GROUPS group by group
// (grouped_kv_item). K and V of an item come in once, into one of
// KV_BUFS buffers, so the next item's load overlaps this one's end; each
// item loops over the 64-row query tiles from the diagonal. Scores are
// formed transposed (S^T = K Q^T), so the kv rows are the M of every
// product.
template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int H,
               int Sq, int Sk, Layout ldk, Layout ldv, float scale,
               int causal, int group) {
  using C = Dkv<D>;
  auto wait = [](uint64_t* bar, uint32_t parity) {
    hopper::mbar_wait<C::TRAP_OUT_OF_LINE>(bar, parity);
  };
  constexpr int DKV_STAGES = C::STAGES, KV_BUFS = C::KV_BUFS;
  constexpr int kDkvKv = C::KV, kDkvTile = C::TILE, kDkvStage = C::STAGE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sKV = align_1024(smem_raw);  // buffers of K then V
  unsigned char* stages = sKV + KV_BUFS * 2 * kDkvKv;
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(stages + DKV_STAGES * kDkvStage);
  uint64_t* kv_empty = kv_full + KV_BUFS;
  uint64_t* full = kv_empty + KV_BUFS;
  uint64_t* empty = full + DKV_STAGES;
  // lse (times log2 e) and delta of the tile in stage st, DBM each.
  auto stage_rows = [&](int st) {
    return reinterpret_cast<float*>(stages + st * kDkvStage + 2 * kDkvTile);
  };

  const int n_kv = (Sk + DBN - 1) / DBN, n_items = n_kv * BH;
  const int n_q = (Sq + DBM - 1) / DBM;
  // Item i: kv tile i / BH of (b, h) = i % BH, or grouped_kv_item's.
  auto item_at = [&](int item) -> DkvItem {
    if constexpr (C::L2_GROUPS) {
      return grouped_kv_item(item, BH, n_kv, group);
    } else {
      return {item / BH, item % BH};
    }
  };
  auto first_q_tile = [&](int k0) {
    return dkv_first_tile<D>(k0, n_q, causal);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < KV_BUFS; ++i) {
      hopper::mbar_init(kv_full + i, 1);
      hopper::mbar_init(kv_empty + i, 2 * WG / 32);  // one arrival a warp
    }
    for (int s = 0; s < DKV_STAGES; ++s) {
      hopper::mbar_init(full + s, 32);  // the producer warp's lanes
      hopper::mbar_init(empty + s, 2 * WG / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;

  if (wg == 2) {  // producer: one warp
    hopper::regs_dec<PRODUCER_REGS>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 == 2 * WG / 32) {
      int ring = 0;  // position in the Q/dO ring, across items
      for (int j = 0, item; (item = snake_item(j, n_items)) >= 0; ++j) {
        const DkvItem it = item_at(item);
        const int k0 = it.kv_tile * DBN, bh = it.bh, b = bh / H, h = bh % H;
        const int kb = j % KV_BUFS;
        unsigned char* sK = sKV + kb * 2 * kDkvKv;
        if (j >= KV_BUFS) wait(kv_empty + kb, (j / KV_BUFS - 1) & 1);
        if (lane == 0) {
          hopper::mbar_arrive_tx(kv_full + kb, 2 * kDkvKv);
          load_tile<D>(sK, &tm_k, kv_full + kb, DBN, h, k0, b);
          load_tile<D>(sK + kDkvKv, &tm_v, kv_full + kb, DBN, h, k0, b);
        }
        for (int t = first_q_tile(k0); t < n_q; ++t, ++ring) {
          const int st = ring % DKV_STAGES, q0 = t * DBM;
          unsigned char* stage = stages + st * kDkvStage;
          if (ring >= DKV_STAGES) {
            wait(empty + st, (ring / DKV_STAGES - 1) & 1);
          }
          float* s_lse = stage_rows(st);
          float* s_delta = s_lse + DBM;
          for (int r = lane; r < DBM; r += 32) {
            const bool in = q0 + r < Sq;
            const long long at = (long long)bh * Sq + q0 + r;
            s_lse[r] = in ? lse[at] * LOG2E : 0.0f;
            s_delta[r] = in ? delta[at] : 0.0f;
          }
          __syncwarp();
          if (lane == 0) {
            hopper::mbar_arrive_tx(full + st, 2 * kDkvTile);
            load_tile<D>(stage, &tm_q, full + st, DBM, h, q0, b);
            load_tile<D>(stage + kDkvTile, &tm_do, full + st, DBM, h, q0, b);
          } else {
            hopper::mbar_arrive(full + st);
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns kv rows k0 + 64 wg + [0, 64)
    hopper::regs_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int col_off = 2 * (lane % 4);
    const float scale_log2 = scale * LOG2E;
    int ring = 0;
    for (int j = 0, item; (item = snake_item(j, n_items)) >= 0; ++j) {
      const DkvItem it = item_at(item);
      const int k0 = it.kv_tile * DBN, bh = it.bh, b = bh / H, h = bh % H;
      const int kb = j % KV_BUFS;
      // This thread holds pieces of kv rows row0 and row0 + 8, at query
      // columns 8 n + col_off + j of every accumulator.
      const int kv_lo = k0 + wg * 64;
      const int row0 = kv_lo + warp * 16 + lane / 4;
      unsigned char* k_rows = sKV + kb * 2 * kDkvKv + wg * 64 * ROW_BYTES;
      unsigned char* v_rows = k_rows + kDkvKv;
      const uint32_t k_addr = hopper::smem_addr(k_rows);
      const uint32_t v_addr = hopper::smem_addr(v_rows);
      float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
      wait(kv_full + kb, (j / KV_BUFS) & 1);

      if constexpr (C::OVERLAP) {
        // The item's tiles from t0, and this warpgroup's from t_mine: the
        // first that one of its rows sees (in a causal item, warpgroup 1's
        // rows see none of the first), or the last tile when none does.
        // The loops hold no branch around a wgmma.
        const int t0 = first_q_tile(k0);
        const int t_mine = causal ? min(kv_lo / DBM, n_q - 1) : 0;
        auto stage_of = [&](int t) { return (ring + t - t0) % DKV_STAGES; };
        auto q_addr = [&](int t) {
          return hopper::smem_addr(stages + stage_of(t) * kDkvStage);
        };
        auto wait_full = [&](int t) {
          wait(full + stage_of(t), ((ring + t - t0) / DKV_STAGES) & 1);
        };
        auto release = [&](int t) {
          if (lane == 0) hopper::mbar_arrive(empty + stage_of(t));
        };
        float s[32], dp[32];
        uint32_t pa[DBM / 16][4], da[DBM / 16][4];
        // Each product is a commit group of its own: S^T = K Q_t^T,
        // dP^T = V dO_t^T, dV += P^T dO_t and dK += dS^T Q_t (dO and Q
        // MN-major).
        auto issue_s = [&](int t) {
          const uint32_t qa = q_addr(t);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            hopper::wgmma_m64n64k16_ss(
                s, hopper::desc_k_major(k_step(k_addr, kk, kDkvKvPanel)),
                hopper::desc_k_major(k_step(qa, kk, kDkvPanel)), kk);
          }
          hopper::wgmma_commit();
        };
        auto issue_dp = [&](int t) {
          const uint32_t doa = q_addr(t) + kDkvTile;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            hopper::wgmma_m64n64k16_ss(
                dp, hopper::desc_k_major(k_step(v_addr, kk, kDkvKvPanel)),
                hopper::desc_k_major(k_step(doa, kk, kDkvPanel)), kk);
          }
          hopper::wgmma_commit();
        };
        auto issue_dv = [&](int t) {
          const uint32_t doa = q_addr(t) + kDkvTile;
#pragma unroll
          for (int kk = 0; kk < DBM / 16; ++kk) {
            hopper::wgmma_rs_tb(
                dv_acc, pa[kk],
                mn_desc<D>(doa + kk * 16 * ROW_BYTES, kDkvPanel));
          }
          hopper::wgmma_commit();
        };
        auto issue_dk = [&](int t) {
          const uint32_t qa = q_addr(t);
#pragma unroll
          for (int kk = 0; kk < DBM / 16; ++kk) {
            hopper::wgmma_rs_tb(
                dk_acc, da[kk],
                mn_desc<D>(qa + kk * 16 * ROW_BYTES, kDkvPanel));
          }
          hopper::wgmma_commit();
        };
        // P^T of tile t in s, masked only on the diagonal and the ragged
        // end; then dS^T in dp.
        auto p_of = [&](int t) {
          const int q0 = t * DBM;
          const float* s_lse = stage_rows(stage_of(t));
          const int hi = Sq - q0 - col_off;
          int lo[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            lo[i] = causal ? row0 + 8 * i - q0 - col_off : -DBM;
          }
          if (q0 + DBM > Sq || (causal && q0 < kv_lo + 63)) {
            dkv_p<true>(s, s_lse, scale_log2, col_off, lo, hi);
          } else {
            dkv_p<false>(s, s_lse, scale_log2, col_off, lo, hi);
          }
        };
        auto ds_of = [&](int t) {
          dkv_ds(s, dp, stage_rows(stage_of(t)) + DBM, col_off);
        };
        auto pack = [&](const float (&x)[32], uint32_t (&a)[DBM / 16][4]) {
#pragma unroll
          for (int kk = 0; kk < DBM / 16; ++kk) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              a[kk][r] = hopper::pack_bf16(x[8 * kk + 2 * r],
                                           x[8 * kk + 2 * r + 1]);
            }
          }
        };

        // Tiles none of this warpgroup's rows sees: loaded, so waited
        // for, and handed back.
        for (int t = t0; t < t_mine; ++t) {
          wait_full(t);
          release(t);
        }
        wait_full(t_mine);
        hopper::wgmma_fence();
        issue_s(t_mine);
        issue_dp(t_mine);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        p_of(t_mine);
        ds_of(t_mine);
        pack(s, pa);
        pack(dp, da);
        // S^T_t goes out with dV += P^T_{t-1} dO_{t-1} and dK += dS^T_{t-1}
        // Q_{t-1}, and P^T_t is computed while those run; then dP^T_t,
        // and dS^T_t. At most both accumulators, S^T and the two packed
        // operands, or both accumulators, P^T and dP^T, are live: 192
        // registers a thread, as in the serial loop.
        for (int t = t_mine + 1; t < n_q; ++t) {
          wait_full(t);
          hopper::wgmma_fence();
          issue_s(t);
          issue_dv(t - 1);
          issue_dk(t - 1);
          hopper::wgmma_wait<2>();  // S^T_t is in
          hopper::fence_regs(s);
          p_of(t);
          hopper::fence_regs(s);  // P^T is done before the wait
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dv_acc);
          hopper::fence_regs(dk_acc);
          release(t - 1);
          hopper::wgmma_fence();
          issue_dp(t);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dp);
          ds_of(t);
          pack(s, pa);
          pack(dp, da);
        }
        hopper::wgmma_fence();
        issue_dv(n_q - 1);
        issue_dk(n_q - 1);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv_acc);
        hopper::fence_regs(dk_acc);
        release(n_q - 1);
        ring += n_q - t0;
      } else {
        for (int t = first_q_tile(k0); t < n_q; ++t, ++ring) {
          const int st = ring % DKV_STAGES, q0 = t * DBM;
          unsigned char* stage = stages + st * kDkvStage;
          wait(full + st, (ring / DKV_STAGES) & 1);
          if (causal && q0 + DBM - 1 < kv_lo) {  // every pair masked
            if (lane == 0) hopper::mbar_arrive(empty + st);
            continue;
          }
          const uint32_t q_addr = hopper::smem_addr(stage);
          const uint32_t do_addr = q_addr + kDkvTile;
          const float* s_lse = stage_rows(st);
          const float* s_delta = s_lse + DBM;

          float s[32], dp[32];
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            hopper::wgmma_m64n64k16_ss(
                s, hopper::desc_k_major(k_step(k_addr, kk, kDkvKvPanel)),
                hopper::desc_k_major(k_step(q_addr, kk, kDkvPanel)), kk);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            hopper::wgmma_m64n64k16_ss(
                dp, hopper::desc_k_major(k_step(v_addr, kk, kDkvKvPanel)),
                hopper::desc_k_major(k_step(do_addr, kk, kDkvPanel)), kk);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(s);
          hopper::fence_regs(dp);

          // P^T and dS^T, masked only on the diagonal and the ragged end.
          const int hi = Sq - q0 - col_off;
          int lo[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            lo[i] = causal ? row0 + 8 * i - q0 - col_off : -DBM;
          }
          if (q0 + DBM > Sq || (causal && q0 < kv_lo + 63)) {
            dkv_probs<true>(s, dp, s_lse, s_delta, scale_log2, col_off, lo,
                            hi);
          } else {
            dkv_probs<false>(s, dp, s_lse, s_delta, scale_log2, col_off, lo,
                             hi);
          }
          uint32_t pa[DBM / 16][4], da[DBM / 16][4];
#pragma unroll
          for (int kk = 0; kk < DBM / 16; ++kk) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              pa[kk][r] = hopper::pack_bf16(s[8 * kk + 2 * r],
                                            s[8 * kk + 2 * r + 1]);
              da[kk][r] = hopper::pack_bf16(dp[8 * kk + 2 * r],
                                            dp[8 * kk + 2 * r + 1]);
            }
          }
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DBM / 16; ++kk) {
            hopper::wgmma_rs_tb(
                dv_acc, pa[kk],
                mn_desc<D>(do_addr + kk * 16 * ROW_BYTES, kDkvPanel));
          }
#pragma unroll
          for (int kk = 0; kk < DBM / 16; ++kk) {
            hopper::wgmma_rs_tb(
                dk_acc, da[kk],
                mn_desc<D>(q_addr + kk * 16 * ROW_BYTES, kDkvPanel));
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dv_acc);
          hopper::fence_regs(dk_acc);
          if (lane == 0) hopper::mbar_arrive(empty + st);
        }
      }

      // This warpgroup's K and V rows are read; they stage its dK and dV,
      // and the buffer goes back to the producer once the rows are stored.
      store_rows<D>(dk_acc, scale, scale, k_rows, kDkvKvPanel,
                    dk + b * ldk.b + h * ldk.h, ldk.s, kv_lo, Sk, wg);
      store_rows<D>(dv_acc, 1.0f, 1.0f, v_rows, kDkvKvPanel,
                    dv + b * ldv.b + h * ldv.h, ldv.s, kv_lo, Sk, wg);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(kv_empty + kb);
    }
  }
}

// dS of a dQ tile in place of dP: ds = P (dP - delta), P = exp2(S scale
// log2 e - lse log2 e), with S the raw scores. This thread holds pieces
// of query rows row0 and row0 + 8, whose lse (times log2 e) and delta it
// keeps, at kv columns 8 n + col_off + j. Only a MASKED tile (across the
// diagonal or the ragged end) tests the mask: column 8 n + j is visible
// to row i when it is at most lim[i].
template <bool MASKED>
__device__ __forceinline__ void dq_probs(const float (&s)[32], float (&dp)[32],
                                         const float (&lse2)[2],
                                         const float (&dl)[2],
                                         float scale_log2,
                                         const int (&lim)[2]) {
#pragma unroll
  for (int idx = 0; idx < 32; ++idx) {
    const int i = (idx / 2) % 2;
    float p = hopper::fast_exp2(s[idx] * scale_log2 - lse2[i]);
    if (MASKED && 8 * (idx / 4) + idx % 2 > lim[i]) p = 0.0f;
    dp[idx] = p * (dp[idx] - dl[i]);
  }
}

constexpr int QBM = 128;                    // query rows per item
constexpr int QBN = 64;                     // kv rows per tile
constexpr int kDqRowsPanel = QBM * ROW_BYTES;  // a panel of Q or dO
constexpr int kDqPanel = QBN * ROW_BYTES;      // a panel of K or V

template <int D>
struct Dq {
  // What the head_dim-128 form adds to the head_dim-64 one (bwd_dq_kernel;
  // each measured on the H100 with ops/flash_probe.py): TRAP_OUT_OF_LINE,
  // a wait that never ends traps through hopper::deadlock, which leaves the
  // consumers setmaxnreg's registers; L2_GROUPS, the items of a group of
  // (b, h) whose K and V fit in half the L2 cache come before the next
  // group's; STORE_APART, dQ goes out through a buffer of its own, so that
  // an item's Q/dO buffer goes back to the producer once its last S and
  // dP are in, not after its dQ is stored; Q_HALVES, a Q/dO buffer is two
  // halves, a warpgroup's 64 rows each, with barriers of their own, so
  // that the warpgroup that ends an item first (in a causal item
  // warpgroup 0, a tile sooner) frees and gets back its half without
  // waiting for the other; KV_LEAD, the producer loads that many of an
  // item's first K/V tiles while the item before still holds the Q/dO
  // buffer (its second half); and a ring of one Q/dO buffer and 4 K/V
  // stages in place of two buffers and 3 stages.
  static constexpr bool TRAP_OUT_OF_LINE = D == 128;
  static constexpr bool L2_GROUPS = D == 128;
  static constexpr bool STORE_APART = D == 128;
  static constexpr bool Q_HALVES = D == 128;
  static constexpr int KV_LEAD = D == 64 ? 0 : 2;
  static constexpr int Q_BUFS = D == 64 ? 2 : 1;  // Q/dO item buffers
  static constexpr int STAGES = 4;                // K/V ring
  static constexpr int ROWS = tile_bytes<D>(QBM);  // Q or dO of an item
  static constexpr int TILE = tile_bytes<D>(QBN);  // K or V of a tile
  static constexpr int QBUF = 2 * ROWS;            // a Q/dO buffer
  static constexpr int OUT = STORE_APART ? ROWS : 0;  // dQ's own buffer
  // Q/dO buffers' full and empty barriers: one a buffer, or one a half.
  static constexpr int QBARS = Q_HALVES ? 2 * Q_BUFS : Q_BUFS;
  static constexpr size_t SMEM = 1024 + Q_BUFS * QBUF + STAGES * 2 * TILE +
                                 OUT +
                                 (2 * QBARS + 2 * STAGES) * sizeof(uint64_t);
  static_assert(SMEM <= kMaxSmem, "dQ shared memory");
};

// A persistent kernel: one block on each SM walks the work items (query
// tile of 128 rows, batch*head) in snake_item's order, the last query
// tiles (which see the most kv tiles) first; with L2_GROUPS group by group
// (grouped_item). Q and dO of an item come in once, into one of Q_BUFS
// buffers (with two, the next item's load overlaps this one's end; with
// one, STORE_APART and Q_HALVES free it early); each item loops over the
// 64-row K/V tiles up to the diagonal. It is dK/dV
// with the roles of Q and K/V swapped: the query rows are the M of every
// product, and dQ += dS K reads K MN-major.
template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int BH, int H, int Sq, int Sk,
              Layout ldq, float scale, int causal, int group) {
  using C = Dq<D>;
  auto wait = [](uint64_t* bar, uint32_t parity) {
    hopper::mbar_wait<C::TRAP_OUT_OF_LINE>(bar, parity);
  };
  constexpr int DQ_STAGES = C::STAGES, Q_BUFS = C::Q_BUFS;
  constexpr int kDqRows = C::ROWS, kDqTile = C::TILE, kDqBuf = C::QBUF;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);  // buffers of Q then dO
  unsigned char* sKV = sQ + Q_BUFS * kDqBuf;  // stages of K then V
  unsigned char* sOut = sKV + DQ_STAGES * 2 * kDqTile;  // with STORE_APART
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sOut + C::OUT);
  uint64_t* q_empty = q_full + C::QBARS;
  uint64_t* full = q_empty + C::QBARS;
  uint64_t* empty = full + DQ_STAGES;

  const int n_q = (Sq + QBM - 1) / QBM, n_items = n_q * BH;
  // Item i: query tile n_q - 1 - i / BH of (b, h) = i % BH, or
  // grouped_item's.
  auto item_at = [&](int item) -> FwdItem {
    if constexpr (C::L2_GROUPS) {
      return grouped_item(item, BH, n_q, group);
    } else {
      return {n_q - 1 - item / BH, item % BH};
    }
  };
  auto n_kv_of = [&](int q0) {
    const int n = (Sk + QBN - 1) / QBN;
    return causal ? min(n, (q0 + QBM - 1) / QBN + 1) : n;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::QBARS; ++i) {
      hopper::mbar_init(q_full + i, 1);
      // one arrival a warp (of a half's warpgroup with Q_HALVES)
      hopper::mbar_init(q_empty + i, (C::Q_HALVES ? 1 : 2) * WG / 32);
    }
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 2 * WG / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;

  if (wg == 2) {  // producer
    hopper::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      hopper::tma_prefetch_map(&tm_q);
      hopper::tma_prefetch_map(&tm_k);
      hopper::tma_prefetch_map(&tm_v);
      hopper::tma_prefetch_map(&tm_do);
      int ring = 0;  // position in the K/V ring, across items
      for (int j = 0, item; (item = snake_item(j, n_items)) >= 0; ++j) {
        const FwdItem it = item_at(item);
        const int q0 = it.q_tile * QBM, bh = it.bh, b = bh / H, h = bh % H;
        const int qb = j % Q_BUFS;
        unsigned char* q_buf = sQ + qb * kDqBuf;
        const int n_kv = n_kv_of(q0);
        // K/V tile t of the item into the ring.
        auto load_kv = [&](int t) {
          const int at = ring + t, st = at % DQ_STAGES;
          unsigned char* stage = sKV + st * 2 * kDqTile;
          if (at >= DQ_STAGES) wait(empty + st, (at / DQ_STAGES - 1) & 1);
          hopper::mbar_arrive_tx(full + st, 2 * kDqTile);
          load_tile<D>(stage, &tm_k, full + st, QBN, h, t * QBN, b);
          load_tile<D>(stage + kDqTile, &tm_v, full + st, QBN, h, t * QBN, b);
        };
        const int lead = min(n_kv, C::KV_LEAD);
        if constexpr (C::Q_HALVES) {
          // Half w: Q then dO of query rows q0 + 64 w + [0, 64). The lead
          // K/V tiles go out between the halves: the second waits for the
          // warpgroup that ends the item before last.
          for (int w = 0; w < 2; ++w) {
            const int qi = 2 * qb + w;
            unsigned char* half = q_buf + w * kDqRows;
            if (j >= Q_BUFS) wait(q_empty + qi, (j / Q_BUFS - 1) & 1);
            hopper::mbar_arrive_tx(q_full + qi, kDqRows);
            load_tile<D>(half, &tm_q, q_full + qi, 64, h, q0 + 64 * w, b);
            load_tile<D>(half + kDqRows / 2, &tm_do, q_full + qi, 64, h,
                         q0 + 64 * w, b);
            if (w == 0) {
              for (int t = 0; t < lead; ++t) load_kv(t);
            }
          }
        } else {
          for (int t = 0; t < lead; ++t) load_kv(t);
          if (j >= Q_BUFS) wait(q_empty + qb, (j / Q_BUFS - 1) & 1);
          hopper::mbar_arrive_tx(q_full + qb, 2 * kDqRows);
          load_tile<D>(q_buf, &tm_q, q_full + qb, QBM, h, q0, b);
          load_tile<D>(q_buf + kDqRows, &tm_do, q_full + qb, QBM, h, q0, b);
        }
        for (int t = lead; t < n_kv; ++t) load_kv(t);
        ring += n_kv;
      }
    }
  } else {  // consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64)
    hopper::regs_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int col_off = 2 * (lane % 4);
    const float scale_log2 = scale * LOG2E;
    int ring = 0;
    for (int j = 0, item; (item = snake_item(j, n_items)) >= 0; ++j) {
      const FwdItem it = item_at(item);
      const int q0 = it.q_tile * QBM, bh = it.bh, b = bh / H, h = bh % H;
      const int qb = j % Q_BUFS;
      // This thread holds pieces of query rows row0 and row0 + 8, at kv
      // columns 8 n + col_off + j of every accumulator; their lse (in
      // base 2) and delta stay in registers for the item.
      const int row_lo = q0 + wg * 64;
      const int row0 = row_lo + warp * 16 + lane / 4;
      float lse2[2], dl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        const long long at = (long long)bh * Sq + row;
        lse2[i] = row < Sq ? lse[at] * LOG2E : 0.0f;
        dl[i] = row < Sq ? delta[at] : 0.0f;
      }
      // This warpgroup's Q rows (its half with Q_HALVES: 64-row panels,
      // dO after them), their panel stride and their Q/dO barriers.
      unsigned char* q_rows =
          C::Q_HALVES ? sQ + qb * kDqBuf + wg * kDqRows
                      : sQ + qb * kDqBuf + wg * 64 * ROW_BYTES;
      constexpr int q_panel = C::Q_HALVES ? 64 * ROW_BYTES : kDqRowsPanel;
      const int qi = C::Q_HALVES ? 2 * qb + wg : qb;
      const uint32_t q_addr = hopper::smem_addr(q_rows);
      const uint32_t do_addr =
          q_addr + (C::Q_HALVES ? kDqRows / 2 : kDqRows);
      float acc[D / 2], s[32], dp[32];
      uint32_t da[QBN / 16][4];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
      wait(q_full + qi, (j / Q_BUFS) & 1);

      // The item's kv tiles, and this warpgroup's: those that see one of
      // its rows (in a causal item, warpgroup 0's rows see none of the
      // last tile). The loops hold no branch around a wgmma.
      const int n_kv = n_kv_of(q0);
      const int n_mine = causal ? min(n_kv, (row_lo + 63) / QBN + 1) : n_kv;
      auto k_addr = [&](int t) {
        return hopper::smem_addr(sKV + (ring + t) % DQ_STAGES * 2 * kDqTile);
      };
      auto wait_full = [&](int t) {
        wait(full + (ring + t) % DQ_STAGES, ((ring + t) / DQ_STAGES) & 1);
      };
      auto release = [&](int t) {
        if (lane == 0) hopper::mbar_arrive(empty + (ring + t) % DQ_STAGES);
      };
      // S = Q K_t^T and dP = dO V_t^T, one commit group.
      auto issue_s_dp = [&](int t) {
        const uint32_t ka = k_addr(t), va = ka + kDqTile;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          hopper::wgmma_m64n64k16_ss(
              s, hopper::desc_k_major(k_step(q_addr, kk, q_panel)),
              hopper::desc_k_major(k_step(ka, kk, kDqPanel)), kk);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          hopper::wgmma_m64n64k16_ss(
              dp, hopper::desc_k_major(k_step(do_addr, kk, q_panel)),
              hopper::desc_k_major(k_step(va, kk, kDqPanel)), kk);
        }
        hopper::wgmma_commit();
      };
      // dQ += dS K_t, K MN-major (head_dim contiguous), one commit group.
      auto issue_dq = [&](int t) {
        const uint32_t ka = k_addr(t);
#pragma unroll
        for (int kk = 0; kk < QBN / 16; ++kk) {
          hopper::wgmma_rs_tb(
              acc, da[kk], mn_desc<D>(ka + kk * 16 * ROW_BYTES, kDqPanel));
        }
        hopper::wgmma_commit();
      };
      // dS of tile t into dp, masked only on the diagonal and the ragged
      // end.
      auto ds = [&](int t) {
        const int k0 = t * QBN;
        int lim[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          lim[i] = Sk - 1 - k0 - col_off;
          if (causal) lim[i] = min(lim[i], row0 + 8 * i - k0 - col_off);
        }
        if (k0 + QBN > Sk || (causal && k0 + QBN - 1 > row_lo)) {
          dq_probs<true>(s, dp, lse2, dl, scale_log2, lim);
        } else {
          dq_probs<false>(s, dp, lse2, dl, scale_log2, lim);
        }
      };
      auto pack_ds = [&] {
#pragma unroll
        for (int kk = 0; kk < QBN / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            da[kk][r] = hopper::pack_bf16(dp[8 * kk + 2 * r],
                                          dp[8 * kk + 2 * r + 1]);
          }
        }
      };

      // S_t and dP_t go out with dQ += dS_{t-1} K_{t-1}, and dS_t is
      // computed while the second product runs.
      wait_full(0);
      hopper::wgmma_fence();
      issue_s_dp(0);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      ds(0);
      pack_ds();
      for (int t = 1; t < n_mine; ++t) {
        wait_full(t);
        hopper::wgmma_fence();
        issue_s_dp(t);
        issue_dq(t - 1);
        hopper::wgmma_wait<1>();  // S_t and dP_t are in
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        ds(t);
        hopper::fence_regs(dp);  // dS is done before the wait
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(t - 1);
        pack_ds();
      }
      if constexpr (C::STORE_APART) {
        // Every S and dP of the item is in: its Q and dO are read.
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(q_empty + qi);
      }
      hopper::wgmma_fence();
      issue_dq(n_mine - 1);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(n_mine - 1);
      // Tiles past this warpgroup's rows: loaded, so waited for, and
      // handed back.
      for (int t = n_mine; t < n_kv; ++t) {
        wait_full(t);
        release(t);
      }
      ring += n_kv;

      if constexpr (C::STORE_APART) {
        // dQ through the warpgroup's rows of its own buffer. A warp reuses
        // them only after this warpgroup's next wgmma, which none of its
        // warps passes before all four have issued it, so after every
        // warp's last read of them here.
        store_rows<D>(acc, scale, scale, sOut + wg * 64 * ROW_BYTES,
                      kDqRowsPanel, dq + b * ldq.b + h * ldq.h, ldq.s,
                      row_lo, Sq, wg);
      } else {
        // This warpgroup's Q rows are read; they stage its dQ, and the
        // buffer goes back to the producer once both warpgroups stored.
        store_rows<D>(acc, scale, scale, q_rows, q_panel,
                      dq + b * ldq.b + h * ldq.h, ldq.s, row_lo, Sq, wg);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(q_empty + qi);
      }
    }
  }
}

Layout layout_at(const long long* strides, int i) {
  return Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// A TMA map over input ``i`` of ``strides`` (S rows, boxes of ``rows``).
bool input_map(CUtensorMap* map, const void* base, int B, int S, int H,
               int D, const long long* strides, int i, int rows) {
  return hopper::make_bshd_map(map, base, B, S, H, D, strides[3 * i],
                               strides[3 * i + 1], strides[3 * i + 2], rows);
}

// Refuses a warp-specialised kernel whose launch would not allocate the
// registers its setmaxnreg hand-off assumes (the consumers would wait for
// them forever), and grants it its dynamic shared memory.
template <typename Kernel>
cudaError_t prepare_hopper(Kernel kernel, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * HOPPER_THREADS <
      WG * PRODUCER_REGS + 2 * WG * CONSUMER_REGS) {
    return cudaErrorInvalidConfiguration;
  }
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Blocks of a persistent kernel: one on each SM, at most one an item.
int resident_blocks(int items) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    sms = 1;
  }
  return items < sms ? items : sms;
}

// The most (b, h) whose ``bytes`` each, read again and again by a walk,
// fit in half the card's L2 cache (at least 1, at most BH).
int l2_cap(int BH, long long bytes) {
  int dev = 0, l2 = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev) !=
          cudaSuccess) {
    l2 = 0;
  }
  const long long fit = (long long)l2 / 2 / bytes;
  return fit < 1 ? 1 : fit < BH ? (int)fit : BH;
}

// The (b, h) a group of grouped_item's walk over ``n_tiles`` tiles of
// each (b, h), at most ``cap``. Blocks take items by snake_item, fixed in
// advance, so the group's size sets how evenly the work falls on them:
// each size up to ``cap`` is tried on a model of the walk, in which the
// item grouped_item gives tile index r costs cost(r), and the largest
// within 1% of the most even is taken.
template <typename Cost>
int even_group(int BH, int n_tiles, int cap, int blocks, Cost cost) {
  const int n_items = n_tiles * BH;
  std::vector<long long> load(blocks);
  std::vector<long long> worst(cap + 1);
  for (int g = 1; g <= cap; ++g) {
    std::fill(load.begin(), load.end(), 0);
    for (int item = 0; item < n_items; ++item) {
      const int r = grouped_item(item, BH, n_tiles, g).q_tile;
      const int j = item / blocks, b = item % blocks;
      load[j % 2 ? blocks - 1 - b : b] += cost(r);
    }
    worst[g] = *std::max_element(load.begin(), load.end());
  }
  const long long best = *std::min_element(worst.begin() + 1, worst.end());
  int g = cap;
  while (worst[g] * 100 > best * 101) --g;
  return g;
}

// The last group size a walk chose, per host thread, keyed on everything
// the choice depends on (the cap folds in D and the cache's size).
struct GroupMemo {
  long long key[5] = {-1, -1, -1, -1, -1};
  int group = 0;

  template <typename Choose>
  int get(const long long (&want)[5], Choose choose) {
    if (!std::equal(want, want + 5, key)) {
      group = choose();
      std::copy(want, want + 5, key);
    }
    return group;
  }
};

// The forward's (b, h) a group (Fwd<D>::L2_GROUPS): their K and V (bf16
// [Sk, D] each) within half the L2 cache, and an item costs its kv tiles
// plus two for its first tile and epilogue, as the phase clocks of
// ops/flash_probe.py show.
int fwd_l2_group(int BH, int Sq, int Sk, int D, int causal, int blocks) {
  const int cap = l2_cap(BH, 4LL * Sk * D);
  if (cap == BH || !causal) return cap;
  thread_local GroupMemo memo;
  const long long want[5] = {BH, Sq, Sk, cap, blocks};
  return memo.get(want, [&] {
    const int n_q = (Sq + FBM - 1) / FBM, n_k = (Sk + FBN - 1) / FBN;
    return even_group(BH, n_q, cap, blocks, [&](int qt) {
      return std::min(n_k, (qt * FBM + FBM - 1) / FBN + 1) + 2;
    });
  });
}

// dQ's (b, h) a group (Dq<D>::L2_GROUPS): their K and V (bf16 [Sk, D]
// each) within half the L2 cache, and an item costs its kv tiles plus two
// for its Q/dO wait, first tile and epilogue, as the forward's walk.
template <int D>
int dq_l2_group(int BH, int Sq, int Sk, int causal, int blocks) {
  const int cap = l2_cap(BH, 4LL * Sk * D);
  if (cap == BH || !causal) return cap;
  thread_local GroupMemo memo;
  const long long want[5] = {BH, Sq, Sk, cap, blocks};
  return memo.get(want, [&] {
    const int n_q = (Sq + QBM - 1) / QBM, n_k = (Sk + QBN - 1) / QBN;
    return even_group(BH, n_q, cap, blocks, [&](int qt) {
      return std::min(n_k, (qt * QBM + QBM - 1) / QBN + 1) + 2;
    });
  });
}

// dK/dV's (b, h) a group (Dkv<D>::L2_GROUPS): their Q and dO (bf16 [Sq,
// D] each) with lse and delta within half the L2 cache, and an item costs
// the query tiles it visits.
template <int D>
int dkv_l2_group(int BH, int Sq, int Sk, int causal, int blocks) {
  const int cap = l2_cap(BH, 4LL * Sq * D + 8LL * Sq);
  if (cap == BH || !causal) return cap;
  thread_local GroupMemo memo;
  const long long want[5] = {BH, Sq, Sk, cap, blocks};
  return memo.get(want, [&] {
    const int n_q = (Sq + DBM - 1) / DBM, n_kv = (Sk + DBN - 1) / DBN;
    return even_group(BH, n_kv, cap, blocks, [&](int r) {
      return n_q - dkv_first_tile<D>((n_kv - 1 - r) * DBN, n_q, causal);
    });
  });
}

// strides: [b, s, h] element strides of q, k, v, o (12 values).
template <int D>
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int H, int Sq, int Sk, int head_dim,
              const long long* strides, float scale, int causal,
              void* stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_hopper(fwd_kernel<D>, Fwd<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  if (!input_map(&tq, q, B, Sq, H, D, strides, 0, FBM) ||
      !input_map(&tk, k, B, Sk, H, D, strides, 1, FBN) ||
      !input_map(&tv, v, B, Sk, H, D, strides, 2, FBN)) {
    return (int)cudaErrorInvalidValue;
  }
  const int items = (Sq + FBM - 1) / FBM * B * H;
  const int blocks = resident_blocks(items);
  const int group =
      Fwd<D>::L2_GROUPS ? fwd_l2_group(B * H, Sq, Sk, D, causal, blocks) : 0;
  fwd_kernel<D><<<blocks, HOPPER_THREADS, Fwd<D>::SMEM,
                  (cudaStream_t)stream>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, B * H, H, Sq, Sk,
      layout_at(strides, 3), scale * LOG2E, causal, group);
  return (int)cudaGetLastError();
}

// strides: q, k, v, dO, dQ (15 values).
template <int D>
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int B, int H, int Sq, int Sk, int head_dim,
                 const long long* strides, float scale, int causal,
                 void* stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_hopper(bwd_dq_kernel<D>, Dq<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv, tdo;
  // Q and dO in boxes of an item's rows, or of a half's with Q_HALVES.
  const int q_box = Dq<D>::Q_HALVES ? QBM / 2 : QBM;
  if (!input_map(&tq, q, B, Sq, H, D, strides, 0, q_box) ||
      !input_map(&tk, k, B, Sk, H, D, strides, 1, QBN) ||
      !input_map(&tv, v, B, Sk, H, D, strides, 2, QBN) ||
      !input_map(&tdo, dout, B, Sq, H, D, strides, 3, q_box)) {
    return (int)cudaErrorInvalidValue;
  }
  const int items = (Sq + QBM - 1) / QBM * B * H;
  const int blocks = resident_blocks(items);
  const int group =
      Dq<D>::L2_GROUPS ? dq_l2_group<D>(B * H, Sq, Sk, causal, blocks) : 0;
  bwd_dq_kernel<D><<<blocks, HOPPER_THREADS, Dq<D>::SMEM,
                     (cudaStream_t)stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dq,
      B * H, H, Sq, Sk, layout_at(strides, 4), scale, causal, group);
  return (int)cudaGetLastError();
}

// strides: q, k, v, dO, dK, dV (18 values).
template <int D>
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int B, int H, int Sq, int Sk,
                  int head_dim, const long long* strides, float scale,
                  int causal, void* stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_hopper(bwd_dkv_kernel<D>, Dkv<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv, tdo;
  if (!input_map(&tq, q, B, Sq, H, D, strides, 0, DBM) ||
      !input_map(&tk, k, B, Sk, H, D, strides, 1, DBN) ||
      !input_map(&tv, v, B, Sk, H, D, strides, 2, DBN) ||
      !input_map(&tdo, dout, B, Sq, H, D, strides, 3, DBM)) {
    return (int)cudaErrorInvalidValue;
  }
  const int items = (Sk + DBN - 1) / DBN * B * H;
  const int blocks = resident_blocks(items);
  const int group =
      Dkv<D>::L2_GROUPS ? dkv_l2_group<D>(B * H, Sq, Sk, causal, blocks) : 0;
  bwd_dkv_kernel<D><<<blocks, HOPPER_THREADS, Dkv<D>::SMEM,
                      (cudaStream_t)stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, B * H, H, Sq, Sk, layout_at(strides, 4),
      layout_at(strides, 5), scale, causal, group);
  return (int)cudaGetLastError();
}

}  // namespace

// The C entries: one set for head_dim 64, one for 128 (``_d128``). Each
// returns cudaGetLastError() after its launch, or an error for a head_dim
// it was not built for.
extern "C" {

#define FLASH_ENTRIES(SUFFIX, D)                                              \
  int flash_fwd##SUFFIX##_bf16(const void* q, const void* k, const void* v, \
                               void* o, void* lse, int B, int H, int Sq,    \
                               int Sk, int head_dim,                        \
                               const long long* strides, float scale,       \
                               int causal, void* stream) {                  \
    return flash_fwd<D>(q, k, v, o, lse, B, H, Sq, Sk, head_dim, strides,   \
                        scale, causal, stream);                             \
  }                                                                         \
  int flash_bwd_dq##SUFFIX##_bf16(                                          \
      const void* q, const void* k, const void* v, const void* dout,        \
      const void* lse, const void* delta, void* dq, int B, int H, int Sq,   \
      int Sk, int head_dim, const long long* strides, float scale,          \
      int causal, void* stream) {                                           \
    return flash_bwd_dq<D>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk,     \
                           head_dim, strides, scale, causal, stream);       \
  }                                                                         \
  int flash_bwd_dkv##SUFFIX##_bf16(                                         \
      const void* q, const void* k, const void* v, const void* dout,        \
      const void* lse, const void* delta, void* dk, void* dv, int B, int H, \
      int Sq, int Sk, int head_dim, const long long* strides, float scale,  \
      int causal, void* stream) {                                           \
    return flash_bwd_dkv<D>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,    \
                            Sk, head_dim, strides, scale, causal, stream);  \
  }

FLASH_ENTRIES(, 64)
FLASH_ENTRIES(_d128, 128)

#undef FLASH_ENTRIES

}  // extern "C"
