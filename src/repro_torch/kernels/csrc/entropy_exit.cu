// Fused BranchyNet exit decision for Hopper (sm_90a): normalized entropy,
// threshold flag and argmax token of K stacked branch heads in one pass.
//
// Replaces the reference package's Pallas TPU kernels
// repro/kernels/entropy_exit.py::entropy_exit_argmax_heads_pallas (body
// `_kernel_argmax_heads`) and, as its K = 1 launch,
// entropy_exit_argmax_pallas (body `_kernel_argmax`); the same kernel
// with the argmax compiled out (kArgmax = false, K = 1) replaces
// entropy_exit_pallas (body `_kernel`), the entropy + flag pair alone.
//
// What it computes, per (head k, row b) of logits (K, B, V) bf16: an fp32
// online (max m, sum s of e^(l-m), sum u of l*e^(l-m)) over V, giving
// H = (m + log s - u / s) / log V with V the logits width, pad lanes
// (-1e30) included; flag = H < thr[k]; token = the first index of the
// maximum (ties resolve to the lowest index, as torch.argmax and
// jnp.argmax do).
//
// What bounds it on this card: bytes, and at the main path's size launch
// latency.  K * B * V * 2 B = 1,026,048 B at K=2, B=8, V=32064 is 0.3 us
// of HBM time; there is no tensor-core work.
//
// What the design does about it: one block of 512 threads per (k, b) row.
// Each thread walks V with stride 512 (neighbouring threads on
// neighbouring addresses) keeping its own accumulators, one exp per
// element; the threads then merge by warp shuffles and one shared-memory
// pass in a fixed order.  The argmax merge compares (value, index) pairs,
// so ties break on the index explicitly and the result does not depend
// on the merge order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Acc {
  float m, s, u;  // running max, sum e^(l-m), sum l*e^(l-m)
  float bv;       // best value
  int bi;         // its first index
};

template <bool kArgmax>
__device__ __forceinline__ Acc merge(const Acc& a, const Acc& b) {
  Acc r;
  r.m = fmaxf(a.m, b.m);
  if (r.m == -INFINITY) {
    r.s = 0.f;
    r.u = 0.f;
  } else {
    const float fa = a.m == -INFINITY ? 0.f : expf(a.m - r.m);
    const float fb = b.m == -INFINITY ? 0.f : expf(b.m - r.m);
    r.s = a.s * fa + b.s * fb;
    r.u = a.u * fa + b.u * fb;
  }
  if (kArgmax) {
    const bool take_b = b.bv > a.bv || (b.bv == a.bv && b.bi < a.bi);
    r.bv = take_b ? b.bv : a.bv;
    r.bi = take_b ? b.bi : a.bi;
  }
  return r;
}

template <bool kArgmax>
__device__ __forceinline__ Acc shfl(const Acc& a, int o) {
  Acc r = a;
  r.m = __shfl_xor_sync(0xffffffffu, a.m, o);
  r.s = __shfl_xor_sync(0xffffffffu, a.s, o);
  r.u = __shfl_xor_sync(0xffffffffu, a.u, o);
  if (kArgmax) {
    r.bv = __shfl_xor_sync(0xffffffffu, a.bv, o);
    r.bi = __shfl_xor_sync(0xffffffffu, a.bi, o);
  }
  return r;
}

// kArgmax = false: entropy and flag only; idx_out is not touched.
template <bool kArgmax>
__global__ void __launch_bounds__(kThreads) entropy_exit_argmax_kernel(
    const __nv_bfloat16* __restrict__ logits,  // (K, B, V)
    const float* __restrict__ thr,             // (K,)
    float* __restrict__ h_out,                 // (K, B)
    uint8_t* __restrict__ flag_out,            // (K, B) torch.bool
    int32_t* __restrict__ idx_out,             // (K, B)
    int b, int v, float log_v) {
  const int row = blockIdx.x;  // k * b + bi
  const __nv_bfloat16* x = logits + static_cast<size_t>(row) * v;
  Acc a{-INFINITY, 0.f, 0.f, -INFINITY, 0x7fffffff};
#pragma unroll 4
  for (int i = threadIdx.x; i < v; i += kThreads) {
    const float l = __bfloat162float(x[i]);
    if (l > a.m) {
      // a.m == -inf on the first element: corr = 0 and s, u are still 0.
      const float corr = expf(a.m - l);
      a.s = a.s * corr + 1.f;
      a.u = a.u * corr + l;
      a.m = l;
    } else {
      const float e = expf(l - a.m);
      a.s += e;
      a.u += l * e;
    }
    if (kArgmax && l > a.bv) {  // strictly greater: first index in the thread
      a.bv = l;
      a.bi = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = merge<kArgmax>(a, shfl<kArgmax>(a, o));

  __shared__ Acc part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc r = part[0];
    for (int w = 1; w < kWarps; ++w) r = merge<kArgmax>(r, part[w]);
    const float lse = r.m + logf(r.s);
    const float h = (lse - r.u / r.s) / log_v;
    h_out[row] = h;
    flag_out[row] = h < thr[row / b] ? 1 : 0;
    if (kArgmax) idx_out[row] = r.bi;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  logits (K, B, V) bf16 and
// thr (K,) f32 contiguous on the current device; outputs (K, B) f32, bool,
// int32.  Returns the cudaError_t of the launch (0 = ok).
extern "C" int entropy_exit_argmax_bf16(const void* logits, const void* thr,
                                        void* h, void* flag, void* idx,
                                        int k, int b, int v, float log_v,
                                        void* stream) {
  if (k < 1 || b < 1 || v < 1) return static_cast<int>(cudaErrorInvalidValue);
  entropy_exit_argmax_kernel<true><<<k * b, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits),
      static_cast<const float*>(thr), static_cast<float*>(h),
      static_cast<uint8_t*>(flag), static_cast<int32_t*>(idx), b, v, log_v);
  return static_cast<int>(cudaGetLastError());
}

// The same without the argmax: logits (K, B, V) bf16, thr (K,) f32;
// outputs (K, B) f32 and bool.
extern "C" int entropy_exit_bf16(const void* logits, const void* thr, void* h,
                                 void* flag, int k, int b, int v, float log_v,
                                 void* stream) {
  if (k < 1 || b < 1 || v < 1) return static_cast<int>(cudaErrorInvalidValue);
  entropy_exit_argmax_kernel<false><<<k * b, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits),
      static_cast<const float*>(thr), static_cast<float*>(h),
      static_cast<uint8_t*>(flag), nullptr, b, v, log_v);
  return static_cast<int>(cudaGetLastError());
}
