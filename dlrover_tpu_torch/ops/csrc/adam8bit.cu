// 8-bit blockwise Adam for Hopper (sm_90a): the update kernel and its
// fused-apply form.
//
// Replaces the Pallas TPU kernels of dlrover_tpu/optim/low_bit.py:
//   adam8_kernel<T, false>  <- _adam8_kernel        (low_bit.py:79)
//   adam8_kernel<T, true>   <- _adam8_fused_kernel  (low_bit.py:131)
// both launched there by _pallas_leaf_update (pallas_call :226).
//
// What they compute, per 256-element quantization block, is the Pallas
// body's arithmetic: dequantize the int8 first moment m (linear, absmax
// scale) and the int8 s = sqrt(v) (its own absmax scale); m = b1 m +
// (1 - b1) g and v = b2 s^2 + (1 - b2) g^2; requantize s = sqrt(v) with
// floor(x + 0.5) and m with round half to even, each to its block's new
// absmax (a zero absmax takes the reciprocal 1); the update is
// lr_eff m / (max(q_s, 0.5) absmax_s / 127 + eps_eff), with the bias
// corrections folded into lr_eff = -lr sqrt(bc2) / bc1 and eps_eff =
// eps sqrt(bc2), read from the fp32 [bc1, bc2] on the device (no host
// sync). The unfused form writes u; the fused form writes p (1 - lr wd)
// + u over p. Every fp32 operation is pinned (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn): nvcc would otherwise contract a * b + c into
// an FMA and round differently from the plain PyTorch version, which
// flips an int8 round at a near-tie.
//
// What bounds them on an H100: memory. Per value of bf16 params the
// fused form reads g and p (4 B) and writes p (2 B), reads and writes
// each int8 moment (4 B), and per block each fp32 scale (16 B per 256
// values): 10.06 B a value, 15.67 GB a step for GPT-2 xl's 1.56B
// values, 4.68 ms at 3.35 TB/s. It does 21-23 fp32 operations a value
// (0.5 ms at 67 TFLOP/s), far under the card's ridge. What the design does about it:
// one pass over memory with nothing in between; 16-byte loads of g and
// p and 8-byte loads of the int8 moments, each lane's 8 values
// consecutive, neighbouring lanes on neighbouring addresses; the two
// block absmaxes by warp shuffles, so no shared memory and no barrier.
// The state is updated in place: every value is read by the lane that
// writes it, and a block's scales are written after the shuffles that
// follow every lane's read of them.
//
// Layout: one warp per quantization block, 8 values per lane, 8 warps
// a CTA, a grid over blocks. A launch walks up to MAX_SEGS segments of
// equal length, each padded to whole blocks: the layers of a stacked
// leaf (per-layer blocks, as the JAX state's chunked leaves), or one
// whole leaf. Values past a segment's end read as 0 and are never
// written. The state rows of segment k start at row k * blocks_per_seg.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (dlrover_tpu_torch/ops/build.py). Every entry
// returns cudaGetLastError() after its launch; the wrapper raises on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int QBLOCK = 256;          // values per quantization block
constexpr int PER_LANE = QBLOCK / 32;
constexpr int WARPS = 8;             // quantization blocks per CTA
constexpr int MAX_SEGS = 64;

struct Segments {
  const void* g[MAX_SEGS];
  void* out[MAX_SEGS];  // u (unfused) or p, read and written (fused)
};

struct Hyper {
  float neg_lr, b1_127, one_minus_b1, b2, one_minus_b2, decay, eps;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, bf16* dst) {
  *dst = __float2bfloat16_rn(x);
}

// x[0..8) <- src[0..n), zeros past n; one or two 16-byte loads when all
// 8 are valid and src is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load8(const T* src, int n, float (&x)[8]) {
  if (n == PER_LANE && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    T v[PER_LANE];
    static_assert(sizeof(v) % 16 == 0, "8 values fill whole 16-byte words");
#pragma unroll
    for (int w = 0; w < (int)(sizeof(v) / 16); ++w) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[w];
      memcpy(reinterpret_cast<char*>(v) + 16 * w, &raw, 16);
    }
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) x[i] = to_f32(v[i]);
    return;
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) x[i] = i < n ? to_f32(src[i]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, int n, const float (&x)[8]) {
  if (n == PER_LANE && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    T v[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) from_f32(x[i], &v[i]);
#pragma unroll
    for (int w = 0; w < (int)(sizeof(v) / 16); ++w) {
      uint4 raw;
      memcpy(&raw, reinterpret_cast<const char*>(v) + 16 * w, 16);
      reinterpret_cast<uint4*>(dst)[w] = raw;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i)
    if (i < n) from_f32(x[i], &dst[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, bool FUSED>
__global__ void __launch_bounds__(WARPS * 32)
adam8_kernel(Segments segs, long long seg_numel, int blocks_per_seg,
             int nblocks, const float* __restrict__ bc, int8_t* mq,
             float* msc, int8_t* sq, float* ssc, Hyper h) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= nblocks) return;  // the whole warp leaves together
  const int seg = row / blocks_per_seg;
  const long long off =
      (long long)(row - seg * blocks_per_seg) * QBLOCK + lane * PER_LANE;
  const long long left = seg_numel - off;
  const int n = left <= 0 ? 0 : (left >= PER_LANE ? PER_LANE : (int)left);

  const float sqrt_bc2 = __fsqrt_rn(bc[1]);
  const float lr_eff = __fdiv_rn(__fmul_rn(h.neg_lr, sqrt_bc2), bc[0]);
  const float eps_eff = __fmul_rn(h.eps, sqrt_bc2);

  float g[PER_LANE];
  load8(static_cast<const T*>(segs.g[seg]) + off, n, g);
  const long long qoff = (long long)row * QBLOCK + lane * PER_LANE;
  int8_t qm[PER_LANE], qs[PER_LANE];
  const int2 raw_m = *reinterpret_cast<const int2*>(mq + qoff);
  const int2 raw_s = *reinterpret_cast<const int2*>(sq + qoff);
  memcpy(qm, &raw_m, PER_LANE);
  memcpy(qs, &raw_s, PER_LANE);
  const float cm = __fmul_rn(msc[row], h.b1_127);
  const float cs = __fdiv_rn(ssc[row], 127.f);

  float m[PER_LANE], s[PER_LANE];
  float amax_m = 0.f, amax_s = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    m[i] = __fadd_rn(__fmul_rn((float)qm[i], cm),
                     __fmul_rn(h.one_minus_b1, g[i]));
    const float sp = __fmul_rn((float)qs[i], cs);
    const float g2 = __fmul_rn(__fmul_rn(h.one_minus_b2, g[i]), g[i]);
    const float v = __fadd_rn(__fmul_rn(__fmul_rn(h.b2, sp), sp), g2);
    s[i] = __fsqrt_rn(v);
    amax_m = fmaxf(amax_m, fabsf(m[i]));
    amax_s = fmaxf(amax_s, s[i]);
  }
  amax_m = warp_max(amax_m);
  amax_s = warp_max(amax_s);
  const float r_m = amax_m == 0.f ? 1.f : __fdiv_rn(127.f, amax_m);
  const float r_s = amax_s == 0.f ? 1.f : __fdiv_rn(127.f, amax_s);
  const float step_s = __fdiv_rn(amax_s, 127.f);

  T* out = static_cast<T*>(segs.out[seg]) + off;
  float o[PER_LANE];
  if (FUSED) load8(out, n, o);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const float q2 = floorf(__fadd_rn(__fmul_rn(s[i], r_s), 0.5f));
    const float denom = __fmul_rn(fmaxf(q2, 0.5f), step_s);
    const float u = __fdiv_rn(__fmul_rn(lr_eff, m[i]),
                              __fadd_rn(denom, eps_eff));
    o[i] = FUSED ? __fadd_rn(__fmul_rn(o[i], h.decay), u) : u;
    qs[i] = (int8_t)(int)q2;
    qm[i] = (int8_t)__float2int_rn(__fmul_rn(m[i], r_m));  // half to even
  }
  store8(out, n, o);
  int2 new_m, new_s;
  memcpy(&new_m, qm, PER_LANE);
  memcpy(&new_s, qs, PER_LANE);
  *reinterpret_cast<int2*>(mq + qoff) = new_m;
  *reinterpret_cast<int2*>(sq + qoff) = new_s;
  if (lane == 0) {
    msc[row] = amax_m;
    ssc[row] = amax_s;
  }
}

template <typename T, bool FUSED>
int launch(const void* const* g, void* const* out, int nseg,
           long long seg_numel, int blocks_per_seg, const float* bc,
           int8_t* mq, float* msc, int8_t* sq, float* ssc, Hyper h,
           void* stream) {
  if (nseg < 1 || nseg > MAX_SEGS || seg_numel < 1 || blocks_per_seg < 1 ||
      (long long)blocks_per_seg * QBLOCK < seg_numel ||
      (long long)(blocks_per_seg - 1) * QBLOCK >= seg_numel ||
      (long long)nseg * blocks_per_seg > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Segments segs;
  memset(&segs, 0, sizeof(segs));
  for (int i = 0; i < nseg; ++i) {
    segs.g[i] = g[i];
    segs.out[i] = out[i];
  }
  const int nblocks = nseg * blocks_per_seg;
  const unsigned grid = (unsigned)((nblocks + WARPS - 1) / WARPS);
  adam8_kernel<T, FUSED><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      segs, seg_numel, blocks_per_seg, nblocks, bc, mq, msc, sq, ssc, h);
  return (int)cudaGetLastError();
}

}  // namespace

#define ADAM8_ENTRY(NAME, T, FUSED)                                        \
  extern "C" int NAME(const void* const* g, void* const* out, int nseg,    \
                      long long seg_numel, int blocks_per_seg,             \
                      const float* bc, int8_t* mq, float* msc, int8_t* sq, \
                      float* ssc, float neg_lr, float b1_127,              \
                      float one_minus_b1, float b2, float one_minus_b2,    \
                      float decay, float eps, void* stream) {              \
    const Hyper h = {neg_lr, b1_127, one_minus_b1, b2, one_minus_b2,       \
                     decay, eps};                                          \
    return launch<T, FUSED>(g, out, nseg, seg_numel, blocks_per_seg, bc,   \
                            mq, msc, sq, ssc, h, stream);                  \
  }

ADAM8_ENTRY(adam8_bf16, bf16, false)
ADAM8_ENTRY(adam8_f32, float, false)
ADAM8_ENTRY(adam8_fused_bf16, bf16, true)
ADAM8_ENTRY(adam8_fused_f32, float, true)
