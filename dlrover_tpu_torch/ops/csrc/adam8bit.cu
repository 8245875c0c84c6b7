// 8-bit blockwise Adam for Hopper (sm_90a): one launch a step over every
// leaf of the state, in its update and its fused-apply form.
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
// values, 4.68 ms at 3.35 TB/s. Next comes instruction issue: about 45
// instructions a value, the IEEE square root and division the largest
// part, which the warps must hide under the loads. What the design does
// about it:
// - One launch a step. The kernel walks a table of every leaf (where its
//   blocks begin in the step's numbering, its members' length and spacing
//   in the leaf's block layout, its state) and of every member tensor
//   (its g and its p or u), so the stacked biases and norms, whose blocks
//   straddle layers, are read from and written back to each layer's own
//   tensor.
// - A persistent grid (CTAS CTAs of 8 warps on each SM): warp w of W
//   takes blocks w, w + W, ..., so neighbouring warps read neighbouring
//   blocks. Each warp keeps STAGES blocks in flight: cp.async copies a
//   block's inputs into the warp's ring of stages in shared memory while
//   an earlier block is computed, so the loads in flight hold no
//   registers (a prefetch into registers cost 19 of them and gained
//   nothing at 3 CTAs an SM; 4 CTAs then spilled).
// - One warp a block, 8 consecutive values a lane: a 16-byte load of g
//   and of p (bf16) and an 8-byte load of each int8 moment, neighbouring
//   lanes on neighbouring addresses; the two block absmaxes by warp
//   shuffles, so no shared memory and no barrier.
// - Exact bit tricks in place of the conversions: int8 to
//   fp32 by a byte permute into 2^23 + 128 + x and a subtraction; round
//   half to even by adding 1.5 * 2^23 (the low byte of the sum is the
//   int8); floor(y) for y >= 0 by adding 2^23 rounding down. Each gives
//   the conversion's result bit for bit over its whole range
//   (tests/test_torch_kernels.py emulates them on the CPU).
// ops/adam8_probe.py times the ablations of these choices on the card.
// The state is updated in place: every value is read by the lane that
// writes it, and a block's scales are written after the shuffles that
// follow every lane's read of them.
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

constexpr int QBLOCK = 256;              // values per quantization block
constexpr int PER_LANE = QBLOCK / 32;    // values a lane: a warp a block
constexpr int WARPS = 8;                 // warps a CTA
constexpr int CTAS = 3;                  // CTAs an SM: the grid and the
                                         // register budget
constexpr int STAGES = 3;                // blocks a warp has in flight

// One leaf of the table (all fields 8 bytes; the wrapper writes the same
// layout as int64 rows).
struct Leaf {
  long long block0;   // the leaf's first block in the step's numbering
  long long nblocks;  // its quantization blocks
  long long n;        // values of each member
  long long stride;   // values between two members' starts in the leaf's
                      // block layout: a multiple of QBLOCK when each
                      // member starts a block (per-layer blocks, or one
                      // member), else n (the members straddle blocks)
  long long member0;  // its first member in the member tables
  long long nmem;     // its members
  int8_t* mq;         // its state: [nblocks, QBLOCK] int8 and [nblocks]
  float* msc;         //   fp32 for each moment
  int8_t* sq;
  float* ssc;
};
static_assert(sizeof(Leaf) == 80, "the wrapper's row layout");

struct Hyper {
  float neg_lr, b1_127, one_minus_b1, b2, one_minus_b2, decay, eps;
};

// ------------------------------------------------------- conversions

// fp32 of int8 byte K of ``word`` (given as word ^ 0x80808080, each byte
// then x + 128): its byte below 0x4B000000 is the float 2^23 + 128 + x.
template <int K>
__device__ __forceinline__ float i8_to_f32(uint32_t word_x80) {
  return __fsub_rn(
      __int_as_float(__byte_perm(word_x80, 0x4B000000u, 0x7540 | K)),
      8388736.0f);
}

// x rounded half to even, |x| <= 127, as an int8 in the low byte: in
// round-to-nearest-even fp32, 1.5 * 2^23 + x keeps integers only.
__device__ __forceinline__ uint32_t round_i8(float x) {
  return __float_as_uint(__fadd_rn(x, 12582912.0f));
}

// floor(y) for 0 <= y < 2^23, as a float and as an int8 in the low byte
// of ``byte``: 2^23 + y rounded down is 2^23 + floor(y).
__device__ __forceinline__ float floor_pos(float y, uint32_t& byte) {
  const float t = __fadd_rd(y, 8388608.0f);
  byte = __float_as_uint(t);
  return __fsub_rn(t, 8388608.0f);
}

// The low bytes of a, b, c, d as one word, a lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// ------------------------------------------------------- a lane's values

// PER_LANE values of T as 16-byte words.
template <typename T>
struct Words {
  static constexpr int N = PER_LANE * (int)sizeof(T) / 16;
  uint4 w[N];
};

__device__ __forceinline__ void unpack(const Words<float>& v,
                                       float (&x)[PER_LANE]) {
  memcpy(x, v.w, sizeof(x));
}

__device__ __forceinline__ void unpack(const Words<bf16>& v,
                                       float (&x)[PER_LANE]) {
  const uint32_t u[4] = {v.w[0].x, v.w[0].y, v.w[0].z, v.w[0].w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(u[k] << 16);
    x[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void pack(const float (&x)[PER_LANE],
                                     Words<float>& v) {
  memcpy(v.w, x, sizeof(x));
}

__device__ __forceinline__ void pack(const float (&x)[PER_LANE],
                                     Words<bf16>& v) {
  uint32_t u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    memcpy(&u[k], &h, 4);
  }
  v.w[0] = make_uint4(u[0], u[1], u[2], u[3]);
}

// Where a lane's PER_LANE values of block ``lb`` of a leaf lie: ``cnt`` of
// them (0 past the leaf's last value) from value ``off`` of member
// ``mem``; cnt < 0 when they cross from one member into the next (a leaf
// whose members straddle blocks and whose length PER_LANE does not
// divide), and then each value is found on its own.
struct Loc {
  int mem, off, cnt;
};

__device__ __forceinline__ Loc locate(const Leaf* leaves, int leaf, int lb,
                                      int lane) {
  const Leaf& L = leaves[leaf];
  const long long stride = L.stride;
  const int n = (int)L.n, nmem = (int)L.nmem;
  Loc c;
  int left;
  if (stride % QBLOCK == 0) {  // every member starts a block
    const int bpm = (int)(stride / QBLOCK);
    c.mem = lb / bpm;
    c.off = (lb - c.mem * bpm) * QBLOCK + lane * PER_LANE;
    left = n - c.off;
    c.cnt = left >= PER_LANE ? PER_LANE : max(left, 0);
  } else {  // the wrapper keeps such a leaf under 2^31 values
    const unsigned v0 = (unsigned)lb * QBLOCK + lane * PER_LANE;
    c.mem = (int)(v0 / (unsigned)n);
    c.off = (int)(v0 - (unsigned)c.mem * n);
    left = n - c.off;
    if (c.mem >= nmem) {
      c.cnt = 0;
    } else if (left >= PER_LANE) {
      c.cnt = PER_LANE;
    } else {
      c.cnt = c.mem == nmem - 1 ? left : -1;
    }
  }
  return c;
}

// The member and offset of value i of the lane whose first value is at
// ``c``, or mem = -1 past the leaf's end.
__device__ __forceinline__ int value_at(const Loc& c, int i, int n, int nmem,
                                        int& off) {
  const int v = c.off + i, mem = c.mem + v / n;
  off = v % n;
  return mem < nmem ? mem : -1;
}

// The lane's values of a member table (g, or p) at ``c``, one by one,
// zeros past the leaf's end: the path of a lane that copy_vals cannot
// copy whole.
template <typename T>
__device__ __forceinline__ Words<T> load_vals(const void* const* ptrs,
                                              const Leaf& L, const Loc& c) {
  Words<T> v;
  const long long m0 = L.member0;
  T x[PER_LANE];
  const int n = (int)L.n, nmem = (int)L.nmem;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    int off, mem = -1;
    if (c.cnt < 0) {
      mem = value_at(c, i, n, nmem, off);
    } else if (i < c.cnt) {
      mem = c.mem;
      off = c.off + i;
    }
    x[i] = mem < 0 ? T(0.f) : static_cast<const T*>(ptrs[m0 + mem])[off];
  }
  memcpy(v.w, x, sizeof(x));
  return v;
}

template <typename T>
__device__ __forceinline__ void store_vals(void* const* ptrs, const Leaf& L,
                                           const Loc& c, const Words<T>& v) {
  const long long m0 = L.member0;
  if (c.cnt == PER_LANE) {
    T* dst = static_cast<T*>(ptrs[m0 + c.mem]) + c.off;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < Words<T>::N; ++k) {
        reinterpret_cast<uint4*>(dst)[k] = v.w[k];
      }
      return;
    }
  }
  T x[PER_LANE];
  memcpy(x, v.w, sizeof(x));
  const int n = (int)L.n, nmem = (int)L.nmem;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    int off, mem = -1;
    if (c.cnt < 0) {
      mem = value_at(c, i, n, nmem, off);
    } else if (i < c.cnt) {
      mem = c.mem;
      off = c.off + i;
    }
    if (mem >= 0) static_cast<T*>(ptrs[m0 + mem])[off] = x[i];
  }
}

// ------------------------------------------------------- cp.async

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One block's inputs in shared memory: g and p (fused), each lane's in
// its own slot; both moments (half a warp copies each, 16 bytes a lane);
// and the scales (copied by lane 0).
template <typename T>
struct Stage {
  Words<T> g[32], p[32];
  uint2 m[32], s[32];
  float msc, ssc, pad[2];
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(Stage<T>) * STAGES * WARPS;
}

// The lane's values of a member table into ``dst``: by cp.async when they
// are whole and aligned, else loaded one by one and stored.
template <typename T>
__device__ __forceinline__ void copy_vals(const void* const* ptrs,
                                          const Leaf& L, const Loc& c,
                                          Words<T>& dst) {
  if (c.cnt == PER_LANE) {
    const T* src = static_cast<const T*>(ptrs[L.member0 + c.mem]) + c.off;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < Words<T>::N; ++k) {
        cp_async<16>(&dst.w[k], reinterpret_cast<const uint4*>(src) + k);
      }
      return;
    }
  }
  dst = load_vals<T>(ptrs, L, c);
}

// Starts the copies of block ``lb`` of a leaf into a stage.
template <typename T, bool FUSED>
__device__ __forceinline__ void issue(const Leaf* leaves, int leaf, int lb,
                                      int lane, const void* const* g_ptrs,
                                      void* const* out_ptrs, Stage<T>& S) {
  const Leaf& L = leaves[leaf];
  const Loc c = locate(leaves, leaf, lb, lane);
  copy_vals<T>(g_ptrs, L, c, S.g[lane]);
  if (FUSED) copy_vals<T>(out_ptrs, L, c, S.p[lane]);
  // Lanes 0-15 copy the first moment's 256 bytes, lanes 16-31 the second's.
  const int half = lane / 16, at = (lane % 16) * 16;
  cp_async<16>(reinterpret_cast<unsigned char*>(half ? S.s : S.m) + at,
               (half ? L.sq : L.mq) + (long long)lb * QBLOCK + at);
  if (lane == 0) {
    cp_async<4>(&S.msc, L.msc + lb);
    cp_async<4>(&S.ssc, L.ssc + lb);
  }
}

// The largest x over the warp (one quantization block).
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Adam on block ``lb`` of a leaf from its stage, and its state, output
// and scales written back.
template <typename T, bool FUSED>
__device__ __forceinline__ void step_block(const Leaf* leaves, int leaf,
                                           int lb, int lane,
                                           const Stage<T>& S,
                                           void* const* out_ptrs,
                                           float lr_eff, float eps_eff,
                                           const Hyper& h) {
  const Leaf& L = leaves[leaf];
  float g[PER_LANE], o[PER_LANE];
  unpack(S.g[lane], g);
  if (FUSED) unpack(S.p[lane], o);
  const uint2 mw = S.m[lane], sw = S.s[lane];
  const float msc = S.msc, ssc = S.ssc;
  const float cm = __fmul_rn(msc, h.b1_127);
  const float cs = __fdiv_rn(ssc, 127.f);

  const uint32_t wm[2] = {mw.x ^ 0x80808080u, mw.y ^ 0x80808080u};
  const uint32_t ws[2] = {sw.x ^ 0x80808080u, sw.y ^ 0x80808080u};
  float m[PER_LANE], s[PER_LANE];
  float amax_m = 0.f, amax_s = 0.f;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const float qm4[4] = {i8_to_f32<0>(wm[w]), i8_to_f32<1>(wm[w]),
                          i8_to_f32<2>(wm[w]), i8_to_f32<3>(wm[w])};
    const float qs4[4] = {i8_to_f32<0>(ws[w]), i8_to_f32<1>(ws[w]),
                          i8_to_f32<2>(ws[w]), i8_to_f32<3>(ws[w])};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * w + k;
      m[i] = __fadd_rn(__fmul_rn(qm4[k], cm), __fmul_rn(h.one_minus_b1, g[i]));
      const float sp = __fmul_rn(qs4[k], cs);
      const float g2 = __fmul_rn(__fmul_rn(h.one_minus_b2, g[i]), g[i]);
      const float v = __fadd_rn(__fmul_rn(__fmul_rn(h.b2, sp), sp), g2);
      s[i] = __fsqrt_rn(v);
      amax_m = fmaxf(amax_m, fabsf(m[i]));
      amax_s = fmaxf(amax_s, s[i]);
    }
  }
  amax_m = warp_max(amax_m);
  amax_s = warp_max(amax_s);
  const float r_m = amax_m == 0.f ? 1.f : __fdiv_rn(127.f, amax_m);
  const float r_s = amax_s == 0.f ? 1.f : __fdiv_rn(127.f, amax_s);
  const float step_s = __fdiv_rn(amax_s, 127.f);

  uint32_t nm[2], ns[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    uint32_t bm[4], bs[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * w + k;
      const float q2 = floor_pos(__fadd_rn(__fmul_rn(s[i], r_s), 0.5f), bs[k]);
      const float denom = __fmul_rn(fmaxf(q2, 0.5f), step_s);
      const float u =
          __fdiv_rn(__fmul_rn(lr_eff, m[i]), __fadd_rn(denom, eps_eff));
      o[i] = FUSED ? __fadd_rn(__fmul_rn(o[i], h.decay), u) : u;
      bm[k] = round_i8(__fmul_rn(m[i], r_m));  // half to even
    }
    nm[w] = pack4(bm[0], bm[1], bm[2], bm[3]);
    ns[w] = pack4(bs[0], bs[1], bs[2], bs[3]);
  }
  Words<T> out;
  pack(o, out);
  store_vals<T>(out_ptrs, L, locate(leaves, leaf, lb, lane), out);
  const long long q = (long long)lb * QBLOCK + lane * PER_LANE;
  *reinterpret_cast<uint2*>(L.mq + q) = make_uint2(nm[0], nm[1]);
  *reinterpret_cast<uint2*>(L.sq + q) = make_uint2(ns[0], ns[1]);
  if (lane == 0) {
    L.msc[lb] = amax_m;
    L.ssc[lb] = amax_s;
  }
}

// ------------------------------------------------------- the kernel

// The leaf of block ``b`` of the step's numbering, and the block within
// it, walking forward from the last one found (b only grows).
struct Cursor {
  int leaf = 0;
  long long end;
  __device__ __forceinline__ int find(const Leaf* leaves, long long b) {
    while (b >= end) {
      ++leaf;
      end += leaves[leaf].nblocks;
    }
    return (int)(b - leaves[leaf].block0);
  }
};

// A persistent grid: warp w of W takes blocks w, w + W, w + 2 W, ... of
// the step's numbering (the leaves' blocks one after another), so that
// neighbouring warps take neighbouring blocks. Each warp keeps STAGES
// blocks in flight: cp.async copies block k + STAGES - 1 into its ring of
// stages in shared memory while block k is computed.
template <typename T, bool FUSED>
__global__ void __launch_bounds__(WARPS * 32, CTAS)
adam8_kernel(const Leaf* __restrict__ leaves, long long nblocks,
             const void* const* __restrict__ g_ptrs,
             void* const* __restrict__ out_ptrs,
             const float* __restrict__ bc, Hyper h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Stage<T>* ring = reinterpret_cast<Stage<T>*>(smem_raw) + warp * STAGES;
  const long long nwarps = (long long)gridDim.x * WARPS;
  const long long first = (long long)blockIdx.x * WARPS + warp;
  if (first >= nblocks) return;  // the whole warp leaves together

  const float sqrt_bc2 = __fsqrt_rn(bc[1]);
  const float lr_eff = __fdiv_rn(__fmul_rn(h.neg_lr, sqrt_bc2), bc[0]);
  const float eps_eff = __fmul_rn(h.eps, sqrt_bc2);

  Cursor loads{0, leaves[0].nblocks}, steps{0, leaves[0].nblocks};
  // Copies of the k-th block of this warp (a group, empty past the end).
  auto issue_k = [&](long long k) {
    const long long b = first + k * nwarps;
    if (b < nblocks) {
      const int lb = loads.find(leaves, b);
      issue<T, FUSED>(leaves, loads.leaf, lb, lane, g_ptrs, out_ptrs,
                      ring[k % STAGES]);
    }
    cp_commit();
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue_k(k);
  long long k = 0;
  for (long long b = first; b < nblocks; b += nwarps, ++k) {
    issue_k(k + STAGES - 1);
    cp_wait<STAGES - 1>();  // this lane's copies of block k are in,
    __syncwarp();           // and then every lane's
    const int lb = steps.find(leaves, b);
    step_block<T, FUSED>(leaves, steps.leaf, lb, lane, ring[k % STAGES],
                         out_ptrs, lr_eff, eps_eff, h);
    __syncwarp();  // the stage is read before it is copied into again
  }
}

// CTAs of the persistent grid: CTAS on each SM, at most one a warp's worth
// of blocks.
long long grid_size(long long nblocks) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 1;
    }
  }
  const long long need = (nblocks + WARPS - 1) / WARPS;
  return need < (long long)sms * CTAS ? need : (long long)sms * CTAS;
}

template <typename T, bool FUSED>
int launch(const void* leaves, int nleaves, long long nblocks,
           const void* g_ptrs, const void* out_ptrs, const float* bc,
           Hyper h, void* stream) {
  if (nleaves < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      adam8_kernel<T, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  adam8_kernel<T, FUSED><<<(unsigned)grid_size(nblocks), WARPS * 32, smem,
                           (cudaStream_t)stream>>>(
      static_cast<const Leaf*>(leaves), nblocks,
      static_cast<const void* const*>(g_ptrs),
      static_cast<void* const*>(out_ptrs), bc, h);
  return (int)cudaGetLastError();
}

}  // namespace

// leaves: the device table, nleaves rows of Leaf (block0 ascending from 0,
// no leaf empty); nblocks: the last row's block0 + nblocks; g_ptrs /
// out_ptrs: one device pointer per member (g, and u or p); bc: fp32
// [bc1, bc2].
#define ADAM8_ENTRY(NAME, T, FUSED)                                          \
  extern "C" int NAME(const void* leaves, int nleaves, long long nblocks,    \
                      const void* g_ptrs, const void* out_ptrs,              \
                      const float* bc, float neg_lr, float b1_127,           \
                      float one_minus_b1, float b2, float one_minus_b2,      \
                      float decay, float eps, void* stream) {                \
    const Hyper h = {neg_lr, b1_127, one_minus_b1, b2, one_minus_b2,         \
                     decay, eps};                                            \
    return launch<T, FUSED>(leaves, nleaves, nblocks, g_ptrs, out_ptrs, bc,  \
                            h, stream);                                      \
  }

ADAM8_ENTRY(adam8_bf16, bf16, false)
ADAM8_ENTRY(adam8_f32, float, false)
ADAM8_ENTRY(adam8_fused_bf16, bf16, true)
ADAM8_ENTRY(adam8_fused_f32, float, true)
