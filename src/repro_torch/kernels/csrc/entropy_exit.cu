// Fused BranchyNet exit decision for Hopper (sm_90a): normalized entropy,
// threshold flag and argmax token of K stacked branch heads in one launch.
//
// Replaces the reference package's Pallas TPU kernels
// repro/kernels/entropy_exit.py::entropy_exit_argmax_heads_pallas (body
// `_kernel_argmax_heads`) and, as its K = 1 launch,
// entropy_exit_argmax_pallas (body `_kernel_argmax`); the same kernel
// with the argmax compiled out (kArgmax = false, K = 1) replaces
// entropy_exit_pallas (body `_kernel`), the entropy + flag pair alone.
//
// What it computes, per (head k, row b) of logits (K, B, V) bf16: fp32
// (max m, sum s of e^(l-m), sum u of l*e^(l-m)) over V, giving
// H = (m + log s - u / s) / log V with V the logits width, pad lanes
// (-1e30) included; flag = H < thr[k]; token = the first index of the
// maximum (ties resolve to the lowest index, as torch.argmax and
// jnp.argmax do).
//
// What bounds it on this card: latency.  K * B * V * 2 B = 1,026,048 B at
// the serving shape (K=2, B=8, V=32064) is 0.3 us of HBM time and there is
// no tensor-core work; one block per row (16 blocks on 132 SMs, each
// thread a serial chain of ~63 dependent loads and exps) took 19 us.
//
// What the design does about it:
//   * each row's V is split across a thread-block cluster of kSplits = 8
//     blocks (the portable cluster size), grid (kSplits, K * B).  The
//     split is ceil(V / 8) elements rounded up to whole 8-element groups
//     (16 bytes), computed by the Python launcher (split_plan) and passed
//     in: a function of V alone, never of K, B or the data, so a row's
//     result is bitwise the same in any batch and each head's slice
//     equals the single-head launch.  128 blocks at the serving shape,
//     each reading ~8 KB;
//   * a thread owns whole 8-element groups (stride kThreads groups) and
//     loads two at a time before using them; per group it takes the max,
//     rescales its running sums once, and spends one exp per element;
//   * warps merge in two phases (shuffle max, one rescale, shuffle sums)
//     and the block's warps the same way through shared memory;
//   * each block leaves its partial in shared memory; after
//     cluster.sync() the rank-0 block reads the 8 partials through
//     distributed shared memory (lane r reads rank r), merges them the
//     same way and writes H, the flag and the token; a second
//     cluster.sync() keeps every block resident until then.  One launch,
//     no workspace, no atomics.
// Loads: kWidth = 8 (one 16-byte load per group) when V % 8 == 0 and the
// logits are 16-byte aligned (every served vocabulary: 32064, 32000,
// 50432), else kWidth = 1 (2-byte scalars).  The two do the same
// arithmetic in the same order and give bitwise equal results.  A row's
// last V % 8 elements (one partial group, at the end of the last
// non-empty split) go through thread 0 as scalars.
// An empty split (V < 64) contributes (m = -inf, 0, 0) and no index; a
// split of pad lanes has a finite max of -1e30, and its merge weight
// exp(-1e30 - m) is exactly 0.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSplits = 8;    // blocks per cluster = splits per row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;     // elements per group (16 bytes of bf16)
constexpr int kUnroll = 2;    // groups a thread loads before using them

struct Acc {
  float m, s, u;  // max, sum e^(l-m), sum l*e^(l-m)
  float bv;       // best value
  int bi;         // its first index (INT_MAX: none)
};

__device__ __forceinline__ Acc identity() {
  return Acc{-INFINITY, 0.f, 0.f, -INFINITY, 0x7fffffff};
}

// exp(m - to) with the empty accumulator (m = -inf) weighing 0.
__device__ __forceinline__ float weight(float m, float to) {
  return m == -INFINITY ? 0.f : expf(m - to);
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Fold n elements l[0..n) at indices idx0.. into a: their max first, the
// running sums rescaled once to it, then one exp per element.
template <bool kArgmax, int N>
__device__ __forceinline__ void absorb(Acc& a, const float (&l)[N], int n,
                                       int idx0) {
  float mt = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) mt = fmaxf(mt, l[i]);
  const float mn = fmaxf(a.m, mt);
  const float f = weight(a.m, mn);
  a.s *= f;
  a.u *= f;
  a.m = mn;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      const float e = expf(l[i] - mn);
      a.s += e;
      a.u = fmaf(l[i], e, a.u);
      // Strictly greater: indices rise with i, so the first index wins.
      if (kArgmax && l[i] > a.bv) {
        a.bv = l[i];
        a.bi = idx0 + i;
      }
    }
  }
}

// Two-phase merge over the lanes of a warp whose xor partners lie below
// `width` (a power of two): max, one rescale, sums; the argmax by
// (value, index).  Every lane ends with the result.
template <bool kArgmax, int kWidth>
__device__ __forceinline__ Acc warp_merge(Acc a) {
  float m = a.m;
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float f = weight(a.m, m);
  float s = a.s * f, u = a.u * f;
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    u += __shfl_xor_sync(0xffffffffu, u, o);
    if (kArgmax) {
      const float bv = __shfl_xor_sync(0xffffffffu, a.bv, o);
      const int bi = __shfl_xor_sync(0xffffffffu, a.bi, o);
      if (better(bv, bi, a.bv, a.bi)) {
        a.bv = bv;
        a.bi = bi;
      }
    }
  }
  a.m = m;
  a.s = s;
  a.u = u;
  return a;
}

// Group g of the row (elements 8g .. 8g+7) as fp32.  bf16 is the top half
// of an fp32, so each conversion is a shift or a mask.
template <int kWidth>
__device__ __forceinline__ void load_group(const __nv_bfloat16* __restrict__ x,
                                           int g, float (&l)[kGroup]) {
  const int i0 = g * kGroup;
  if constexpr (kWidth == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(x + i0);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      l[2 * j] = __uint_as_float(ws[j] << 16);
      l[2 * j + 1] = __uint_as_float(ws[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) l[j] = __bfloat162float(x[i0 + j]);
  }
}

// kArgmax = false: entropy and flag only; idx_out is not touched.
template <bool kArgmax, int kWidth>
__global__ void __cluster_dims__(kSplits, 1, 1) __launch_bounds__(kThreads)
    entropy_exit_argmax_kernel(
        const __nv_bfloat16* __restrict__ logits,  // (K, B, V)
        const float* __restrict__ thr,             // (K,)
        float* __restrict__ h_out,                 // (K, B)
        uint8_t* __restrict__ flag_out,            // (K, B) torch.bool
        int32_t* __restrict__ idx_out,             // (K, B)
        int b, int v, int split, float log_v) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // = blockIdx.x
  const int row = blockIdx.y;                                // k * b + bi
  const __nv_bfloat16* x = logits + static_cast<size_t>(row) * v;
  const int lo = min(rank * split, v);
  const int hi = min(lo + split, v);
  const int g_lo = lo / kGroup;
  const int g_hi = g_lo + (hi - lo) / kGroup;  // full groups of the split

  Acc a = identity();
  for (int g0 = g_lo + threadIdx.x; g0 < g_hi; g0 += kThreads * kUnroll) {
    float l[kUnroll][kGroup];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (g0 + j * kThreads < g_hi) load_group<kWidth>(x, g0 + j * kThreads, l[j]);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (g0 + j * kThreads < g_hi)
        absorb<kArgmax>(a, l[j], kGroup, (g0 + j * kThreads) * kGroup);
  }
  const int tail = (hi - lo) % kGroup;  // non-zero only where hi == v
  if (tail && threadIdx.x == 0) {
    float l[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      l[i] = i < tail ? __bfloat162float(x[hi - tail + i]) : -INFINITY;
    absorb<kArgmax>(a, l, tail, hi - tail);
  }

  a = warp_merge<kArgmax, 32>(a);
  __shared__ Acc warp_part[kWarps];
  __shared__ Acc block_part;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = warp_merge<kArgmax, kWarps>(lane < kWarps ? warp_part[lane] : identity());
    if (lane == 0) block_part = a;
  }
  cluster.sync();  // every block's partial is in its shared memory
  if (rank == 0 && warp == 0) {
    a = lane < kSplits ? *cluster.map_shared_rank(&block_part, lane) : identity();
    a = warp_merge<kArgmax, kSplits>(a);
    if (lane == 0) {
      const float h = (a.m + logf(a.s) - a.u / a.s) / log_v;
      h_out[row] = h;
      flag_out[row] = h < thr[row / b] ? 1 : 0;
      if (kArgmax) idx_out[row] = a.bi;
    }
  }
  cluster.sync();  // no block leaves while rank 0 still reads its partial
}

// Elements per load for rows of width v starting at logits (0: none fits).
int load_width(const void* logits, int v) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(logits);
  if (v % kGroup == 0 && addr % 16 == 0) return kGroup;
  return addr % 2 == 0 ? 1 : 0;
}

template <bool kArgmax>
int launch(const void* logits, const void* thr, void* h, void* flag, void* idx,
           int k, int b, int v, int split, float log_v, void* stream) {
  // A split of whole groups that covers the row: only the split ending at
  // V then has a partial group, and each split starts on a group.
  if (k < 1 || b < 1 || v < 1 || k * b > 65535 || split < kGroup ||
      split % kGroup != 0 || static_cast<long long>(split) * kSplits < v)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kSplits, k * b);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(logits);
  const auto* t = static_cast<const float*>(thr);
  auto* ho = static_cast<float*>(h);
  auto* fo = static_cast<uint8_t*>(flag);
  auto* io = static_cast<int32_t*>(idx);
  switch (load_width(logits, v)) {
    case 8:
      entropy_exit_argmax_kernel<kArgmax, 8><<<grid, kThreads, 0, s>>>(
          x, t, ho, fo, io, b, v, split, log_v);
      break;
    case 1:
      entropy_exit_argmax_kernel<kArgmax, 1><<<grid, kThreads, 0, s>>>(
          x, t, ho, fo, io, b, v, split, log_v);
      break;
    default:
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The load width the entry points below pick for these logits: 8 (16-byte
// loads) or 1 (scalars); 0 for an address no load fits.
extern "C" int entropy_exit_load_width(const void* logits, int v) {
  return load_width(logits, v);
}

// Plain C entry point (loaded with ctypes).  logits (K, B, V) bf16 and
// thr (K,) f32 contiguous on the current device; outputs (K, B) f32, bool,
// int32; split = elements per split (the launcher's split_plan).  Returns
// the cudaError_t of the launch (0 = ok); a refused cluster launch comes
// back here.
extern "C" int entropy_exit_argmax_bf16(const void* logits, const void* thr,
                                        void* h, void* flag, void* idx,
                                        int k, int b, int v, int split,
                                        float log_v, void* stream) {
  return launch<true>(logits, thr, h, flag, idx, k, b, v, split, log_v, stream);
}

// The same without the argmax: logits (K, B, V) bf16, thr (K,) f32;
// outputs (K, B) f32 and bool.
extern "C" int entropy_exit_bf16(const void* logits, const void* thr, void* h,
                                 void* flag, int k, int b, int v, int split,
                                 float log_v, void* stream) {
  return launch<false>(logits, thr, h, flag, nullptr, k, b, v, split, log_v,
                       stream);
}
