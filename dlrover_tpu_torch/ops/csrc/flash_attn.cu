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
// from the forward's logsumexp and takes dS = P * (dP - delta), with
// delta = rowsum(dO * O) computed by the caller. dQ and dK/dV stay two
// passes, as in the reference, so no atomics are needed.
//
// What bounds them on an H100: at the GPT-2 shape (B*H = 192, S = 1024,
// D = 64, causal) the forward does 25.8 GFLOP on 101 MB (q, k, v, o,
// lse), 254 FLOP/byte: just under the card's ~295 FLOP/byte ridge, so
// its bound is the bytes (0.030 ms); the backward passes do 1.5x and 2x
// the FLOPs on a little more data and are bound by the tensor cores
// (0.039 ms dQ, 0.052 ms dK/dV). What the design does about it: every
// product runs on the tensor cores (WMMA bf16 m16n16k16, mma.sync
// underneath, fp32 accumulation), the S x S scores never leave shared
// memory, each input tile is read once per block, and each block walks
// its kv (or q) tiles in a loop that replaces the TPU's sequential grid
// axis, skipping causal tiles above the diagonal. It is the simple first
// version: no TMA, no wgmma, no warp specialisation, a softmax that goes
// through shared memory, K/V re-read by every query tile — so it reaches
// a few percent of its bound. Those are later work.
//
// Tiles: 64 query rows x 64 key rows, head_dim 64, 4 warps per block,
// each warp owning 16 rows of the block's tile. Inputs are bf16 and read
// through their [B, S, H, D] strides (head_dim stride 1, 16-byte aligned
// rows); the logsumexp and delta are fp32 [B*H, S].
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (dlrover_tpu_torch/ops/build.py). Every entry
// returns cudaGetLastError() after its launch; the wrapper raises on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;        // head_dim
constexpr int BM = 64;       // query rows per tile
constexpr int BN = 64;       // key/value rows per tile
constexpr int NWARPS = 4;    // each warp owns 16 rows of the tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int WROWS = 16;
// Shared-memory row pitches: padded against bank aliasing, and still
// multiples of 32 bytes per 16 rows as WMMA loads require.
constexpr int LDH = 72;      // bf16 tiles (64 + 8)
constexpr int LDF = 68;      // fp32 tiles (64 + 4)
constexpr float NEG_INF = -1e30f;

static_assert(BM == BN && BN == D, "tiles share one pitch");

struct Layout {
  long long b, s, h;  // element strides of [B, S, H, D]; D stride is 1
};

struct Layouts {
  Layout t[6];
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Copy rows [row0, row0 + 64) of a strided [S, 64] bf16 matrix into a
// shared tile; rows at or past `nrows` are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int nrows) {
  for (int c = threadIdx.x; c < 64 * 8; c += NTHREADS) {
    const int r = c >> 3, col = (c & 7) << 3;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + col) = val;
  }
}

// c[16 x 64] (fp32, pitch LDF) = a[16 x 64] * bt[64 x 64]^T, both bf16
// with pitch LDH: the warp's rows of a against every row of bt.
__device__ __forceinline__ void warp_gemm_abt(float* c, const bf16* a,
                                              const bf16* bt) {
  FragA fa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(fa[kk], a + kk * 16, LDH);
  }
#pragma unroll
  for (int nt = 0; nt < 64 / 16; ++nt) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBT fb;
      wmma::load_matrix_sync(fb, bt + nt * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, fa[kk], fb, acc);
    }
    wmma::store_matrix_sync(c + nt * 16, acc, LDF, wmma::mem_row_major);
  }
}

// acc[16 x 64] += a[16 x 64] * b[64 x 64], both bf16 with pitch LDH.
__device__ __forceinline__ void warp_gemm_ab(FragC* acc, const bf16* a,
                                             const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDH);
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * LDH + nt * 16, LDH);
      wmma::mma_sync(acc[nt], fa, fb, acc[nt]);
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

__device__ __forceinline__ bool visible(int gq, int gk, int Sq, int Sk,
                                        int causal) {
  return gq < Sq && gk < Sk && (!causal || gq >= gk);
}

// Number of kv tiles a query tile starting at q0 attends to.
__device__ __forceinline__ int kv_tiles(int q0, int Sk, int causal) {
  int n = (Sk + BN - 1) / BN;
  if (causal) n = min(n, (q0 + BM - 1) / BN + 1);
  return n;
}

constexpr size_t kFwdSmem =
    4 * BM * LDH * sizeof(bf16) + 2 * BM * LDF * sizeof(float) +
    2 * BM * sizeof(float);

// One block per (query tile, batch*head); loops over kv tiles.
__global__ void __launch_bounds__(NTHREADS)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int H, int Sq, int Sk, Layouts L,
           float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LDH;
  bf16* sV = sK + BN * LDH;
  bf16* sP = sV + BN * LDH;
  float* sS = reinterpret_cast<float*>(sP + BM * LDH);
  float* sO = sS + BM * LDF;
  float* sM = sO + BM * LDF;
  float* sL = sM + BM;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bf16* qb = q + b * L.t[0].b + h * L.t[0].h;
  const bf16* kb = k + b * L.t[1].b + h * L.t[1].h;
  const bf16* vb = v + b * L.t[2].b + h * L.t[2].h;
  bf16* ob = o + b * L.t[3].b + h * L.t[3].h;

  load_tile(sQ, qb, L.t[0].s, q0, Sq);
  for (int i = threadIdx.x; i < BM * LDF; i += NTHREADS) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.0f;
  }
  const int r0 = warp * WROWS;
  const int n_kv = kv_tiles(q0, Sk, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BN;
    __syncthreads();
    load_tile(sK, kb, L.t[1].s, k0, Sk);
    load_tile(sV, vb, L.t[2].s, k0, Sk);
    __syncthreads();
    warp_gemm_abt(sS + r0 * LDF, sQ + r0 * LDH, sK);
    __syncwarp();
    for (int r = r0; r < r0 + WROWS; ++r) {
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        x[j] = visible(q0 + r, k0 + c, Sq, Sk, causal)
                   ? sS[r * LDF + c] * scale
                   : NEG_INF;
      }
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x[0], x[1])));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = x[j] <= NEG_INF * 0.5f ? 0.0f : expf(x[j] - m_new);
        sum += p;
        sP[r * LDH + lane + 32 * j] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      const float corr = expf(m_prev - m_new);
      sO[r * LDF + lane] *= corr;
      sO[r * LDF + lane + 32] *= corr;
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + sum;
      }
    }
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      FragC acc;
      wmma::load_matrix_sync(acc, sO + r0 * LDF + nt * 16, LDF,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, sP + r0 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(fb, sV + kk * 16 * LDH + nt * 16, LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + r0 * LDF + nt * 16, acc, LDF,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }
  for (int r = r0; r < r0 + WROWS; ++r) {
    const int gq = q0 + r;
    if (gq >= Sq) break;
    const float l = sL[r];
    const float l_safe = l == 0.0f ? 1.0f : l;
    bf16* orow = ob + (long long)gq * L.t[3].s;
    orow[lane] = __float2bfloat16(sO[r * LDF + lane] / l_safe);
    orow[lane + 32] = __float2bfloat16(sO[r * LDF + lane + 32] / l_safe);
    if (lane == 0) lse[(long long)bh * Sq + gq] = sM[r] + logf(l_safe);
  }
}

constexpr size_t kDqSmem =
    5 * BM * LDH * sizeof(bf16) + 2 * BM * LDF * sizeof(float) +
    2 * BM * sizeof(float);

// One block per (query tile, batch*head); loops over kv tiles.
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int H, int Sq, int Sk, Layouts L,
              float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BM * LDH;
  bf16* sK = sdO + BM * LDH;
  bf16* sV = sK + BN * LDH;
  bf16* sDS = sV + BN * LDH;
  float* sS = reinterpret_cast<float*>(sDS + BM * LDH);
  float* sDP = sS + BM * LDF;
  float* sLse = sDP + BM * LDF;
  float* sDelta = sLse + BM;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bf16* qb = q + b * L.t[0].b + h * L.t[0].h;
  const bf16* kb = k + b * L.t[1].b + h * L.t[1].h;
  const bf16* vb = v + b * L.t[2].b + h * L.t[2].h;
  const bf16* dob = dout + b * L.t[3].b + h * L.t[3].h;
  bf16* dqb = dq + b * L.t[4].b + h * L.t[4].h;

  load_tile(sQ, qb, L.t[0].s, q0, Sq);
  load_tile(sdO, dob, L.t[3].s, q0, Sq);
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    const bool in = q0 + i < Sq;
    sLse[i] = in ? lse[(long long)bh * Sq + q0 + i] : 0.0f;
    sDelta[i] = in ? delta[(long long)bh * Sq + q0 + i] : 0.0f;
  }
  const int r0 = warp * WROWS;
  FragC acc[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) wmma::fill_fragment(acc[nt], 0.0f);
  const int n_kv = kv_tiles(q0, Sk, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BN;
    __syncthreads();
    load_tile(sK, kb, L.t[1].s, k0, Sk);
    load_tile(sV, vb, L.t[2].s, k0, Sk);
    __syncthreads();
    warp_gemm_abt(sS + r0 * LDF, sQ + r0 * LDH, sK);
    warp_gemm_abt(sDP + r0 * LDF, sdO + r0 * LDH, sV);
    __syncwarp();
    for (int i = lane; i < WROWS * BN; i += 32) {
      const int r = r0 + i / BN, c = i % BN;
      const float p = visible(q0 + r, k0 + c, Sq, Sk, causal)
                          ? expf(sS[r * LDF + c] * scale - sLse[r])
                          : 0.0f;
      sDS[r * LDH + c] = __float2bfloat16(p * (sDP[r * LDF + c] - sDelta[r]));
    }
    __syncwarp();
    warp_gemm_ab(acc, sDS + r0 * LDH, sK);
  }
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::store_matrix_sync(sS + r0 * LDF + nt * 16, acc[nt], LDF,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < WROWS * D; i += 32) {
    const int r = r0 + i / D, c = i % D;
    const int gq = q0 + r;
    if (gq < Sq) {
      dqb[(long long)gq * L.t[4].s + c] =
          __float2bfloat16(sS[r * LDF + c] * scale);
    }
  }
}

constexpr size_t kDkvSmem =
    6 * BM * LDH * sizeof(bf16) + 2 * BM * LDF * sizeof(float) +
    2 * BM * sizeof(float);

// One block per (kv tile, batch*head); loops over query tiles from the
// diagonal. Each warp owns 16 key rows; scores are formed transposed
// (S^T = K Q^T) so dV += P^T dO and dK += dS^T Q are plain row products.
__global__ void __launch_bounds__(NTHREADS)
bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq,
               int Sk, Layouts L, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * LDH;
  bf16* sQ = sV + BN * LDH;
  bf16* sdO = sQ + BM * LDH;
  bf16* sP = sdO + BM * LDH;
  bf16* sDS = sP + BN * LDH;
  float* sS = reinterpret_cast<float*>(sDS + BN * LDH);
  float* sDP = sS + BN * LDF;
  float* sLse = sDP + BN * LDF;
  float* sDelta = sLse + BM;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * BN;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const bf16* qb = q + b * L.t[0].b + h * L.t[0].h;
  const bf16* kb = k + b * L.t[1].b + h * L.t[1].h;
  const bf16* vb = v + b * L.t[2].b + h * L.t[2].h;
  const bf16* dob = dout + b * L.t[3].b + h * L.t[3].h;
  bf16* dkb = dk + b * L.t[4].b + h * L.t[4].h;
  bf16* dvb = dv + b * L.t[5].b + h * L.t[5].h;

  load_tile(sK, kb, L.t[1].s, k0, Sk);
  load_tile(sV, vb, L.t[2].s, k0, Sk);
  const int r0 = warp * WROWS;
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::fill_fragment(dk_acc[nt], 0.0f);
    wmma::fill_fragment(dv_acc[nt], 0.0f);
  }
  const int n_q = (Sq + BM - 1) / BM;
  for (int t = causal ? k0 / BM : 0; t < n_q; ++t) {
    const int q0 = t * BM;
    __syncthreads();
    load_tile(sQ, qb, L.t[0].s, q0, Sq);
    load_tile(sdO, dob, L.t[3].s, q0, Sq);
    for (int i = threadIdx.x; i < BM; i += NTHREADS) {
      const bool in = q0 + i < Sq;
      sLse[i] = in ? lse[(long long)bh * Sq + q0 + i] : 0.0f;
      sDelta[i] = in ? delta[(long long)bh * Sq + q0 + i] : 0.0f;
    }
    __syncthreads();
    warp_gemm_abt(sS + r0 * LDF, sK + r0 * LDH, sQ);
    warp_gemm_abt(sDP + r0 * LDF, sV + r0 * LDH, sdO);
    __syncwarp();
    for (int i = lane; i < WROWS * BM; i += 32) {
      const int r = r0 + i / BM, c = i % BM;  // r: key row, c: query row
      const float p = visible(q0 + c, k0 + r, Sq, Sk, causal)
                          ? expf(sS[r * LDF + c] * scale - sLse[c])
                          : 0.0f;
      sP[r * LDH + c] = __float2bfloat16(p);
      sDS[r * LDH + c] = __float2bfloat16(p * (sDP[r * LDF + c] - sDelta[c]));
    }
    __syncwarp();
    warp_gemm_ab(dv_acc, sP + r0 * LDH, sdO);
    warp_gemm_ab(dk_acc, sDS + r0 * LDH, sQ);
  }
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt) {
    wmma::store_matrix_sync(sS + r0 * LDF + nt * 16, dk_acc[nt], LDF,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(sDP + r0 * LDF + nt * 16, dv_acc[nt], LDF,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < WROWS * D; i += 32) {
    const int r = r0 + i / D, c = i % D;
    const int gk = k0 + r;
    if (gk < Sk) {
      dkb[(long long)gk * L.t[4].s + c] =
          __float2bfloat16(sS[r * LDF + c] * scale);
      dvb[(long long)gk * L.t[5].s + c] = __float2bfloat16(sDP[r * LDF + c]);
    }
  }
}

Layouts make_layouts(const long long* strides, int n) {
  Layouts L;
  for (int i = 0; i < n; ++i) {
    L.t[i].b = strides[3 * i];
    L.t[i].s = strides[3 * i + 1];
    L.t[i].h = strides[3 * i + 2];
  }
  return L;
}

}  // namespace

extern "C" {

// strides: [b, s, h] element strides of q, k, v, o (12 values).
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Sq, int Sk, int head_dim,
                   const long long* strides, float scale, int causal,
                   void* stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  fwd_kernel<<<grid, NTHREADS, kFwdSmem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      H, Sq, Sk, make_layouts(strides, 4), scale, causal);
  return (int)cudaGetLastError();
}

// strides: q, k, v, dO, dQ (15 values).
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Sq, int Sk, int head_dim,
                      const long long* strides, float scale, int causal,
                      void* stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  bwd_dq_kernel<<<grid, NTHREADS, kDqSmem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, H, Sq, Sk,
      make_layouts(strides, 5), scale, causal);
  return (int)cudaGetLastError();
}

// strides: q, k, v, dO, dK, dV (18 values).
int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Sq, int Sk,
                       int head_dim, const long long* strides, float scale,
                       int causal, void* stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + BN - 1) / BN, B * H);
  bwd_dkv_kernel<<<grid, NTHREADS, kDkvSmem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, H, Sq,
      Sk, make_layouts(strides, 6), scale, causal);
  return (int)cudaGetLastError();
}

}  // extern "C"
