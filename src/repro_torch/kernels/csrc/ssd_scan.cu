// Mamba2 / SSD state-space kernels for Hopper (sm_90a): the decode-time
// recurrent step against the resident state (ssd_update) and the prefill
// scan from a zero state (ssd_scan).
//
// Replaces the reference package's Pallas TPU kernels
//   repro/kernels/ssd_scan.py::ssd_update_pallas (body `_update_kernel`)
//   repro/kernels/ssd_scan.py::ssd_scan_pallas   (body `_kernel`).
//
// Both compute the SSD recurrence, per (row, head), with a P x N fp32
// state h and B, C shared by rep = H / G consecutive heads:
//     h_t = exp(a_t) h_{t-1} + x_t (x) B_t ;   y_t = h_t . C_t
// x and a are fp32; B and C are fp32 or bf16 (the model's compute dtype)
// and are read in place from the model's xBC activations: the (G, N)
// block of a token is contiguous and consecutive tokens are `sbc`
// elements apart.
//
// ---- ssd_update: one step, the state updated in place -------------------
// What it computes: sub-batch row i reads state row min(rows[i], Bc - 1)
// (the reference's clamped gather), writes h' back to row rows[i] and
// drops the write of a row >= Bc (the compacted runtime's out-of-bounds
// sentinel; the reference's `.at[rows].set(mode="drop")`).  This fuses the
// Pallas kernel with its caller's scatter: each live state row is read
// once and written once, with no dense copy and no scatter pass.
//
// What bounds it on this card: bytes.  The state is read and written once:
// at Zamba2-1.2B's shapes (B = Bc = 8, H = 64, P = N = 64) that is
// 2 x 8.4 MB, about 5 us at 3.35 TB/s; 5 flops per state element are
// 0.3 us at the fp32 peak.
//
// What the design does about it: one block of 256 threads per (row,
// head); the P x N tile moves as float4 (16 bytes a thread, neighbouring
// threads on neighbouring addresses), N / 4 consecutive lanes per state
// row; y's dot product over N reduces by warp shuffles within those
// lanes.  B_t and C_t are staged once per block in shared memory.
//
// ---- ssd_scan: L steps from a zero state --------------------------------
// What it computes: y (B, L, H, P) fp32 and the final state (B, H, P, N)
// fp32 of the recurrence started from h = 0, exactly the reference's
// sequential oracle (ssd_scan_ref) and, up to fp32 summation order, its
// chunked algorithm (ssd_chunked, ssd_scan_pallas).
//
// What bounds it on this card: at Zamba2-1.2B's admission shapes
// (B = 8, L = 128, H = 64, P = N = 64) x and y are 16.8 MB each and the
// final state 8.4 MB, about 12.5 us at 3.35 TB/s; the recurrence does
// 5 fp32 flops per state element and step, 1.34 GFLOP, about 20 us at the
// fp32 peak of 67 TFLOP/s — so operations bound it.  (The chunked form
// the TPU kernel uses trades those for (chunk x chunk) matmuls, which pay
// on a matrix unit; here no library and no tensor core is used.)
//
// What the design does about it: one block of 4P threads per (row, head)
// runs the recurrence sequentially over L with the state in registers:
// thread (p, s) holds h[p, s + 4k] for k < N / 4, so a step is N / 4
// FMA pairs per thread and two shuffles for y, with no global traffic.
// The inputs of `chunk` steps at a time (a, x, B, C) are staged in shared
// memory by coalesced loads, and y goes back through shared memory the
// same way; a ragged last chunk simply runs fewer steps (a state no-op
// past L, as the reference's zero padding is).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUpdateThreads = 256;
constexpr int kMaxN = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TB>
__global__ void __launch_bounds__(kUpdateThreads) ssd_update_kernel(
    float* __restrict__ h_state,      // (Bc, H, P, N), updated in place
    const float* __restrict__ x,      // (B, H, P)
    const float* __restrict__ a,      // (B, H)
    const TB* __restrict__ bm,        // (B, G, N), token stride sbc
    const TB* __restrict__ cm,        // (B, G, N), token stride sbc
    const int32_t* __restrict__ rows, // (B,)
    float* __restrict__ y,            // (B, H, P)
    int bc, int h, int p, int n, int g, long long sbc) {
  __shared__ float sb[kMaxN];
  __shared__ float sc[kMaxN];
  const int i = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int gi = hh / (h / g);
  const int row = rows[i];
  const bool write = row < bc;
  const int rr = write ? row : bc - 1;
  const size_t tile = static_cast<size_t>(p) * n;
  // Read and (unless dropped) written back in place: rr == row on a write.
  float4* hs =
      reinterpret_cast<float4*>(h_state + (static_cast<size_t>(rr) * h + hh) * tile);
  const TB* bv = bm + i * sbc + static_cast<long long>(gi) * n;
  const TB* cv = cm + i * sbc + static_cast<long long>(gi) * n;
  for (int k = threadIdx.x; k < n; k += kUpdateThreads) {
    sb[k] = to_f(bv[k]);
    sc[k] = to_f(cv[k]);
  }
  __syncthreads();
  const float ea = expf(a[i * h + hh]);
  const float* xr = x + (static_cast<size_t>(i) * h + hh) * p;
  float* yr = y + (static_cast<size_t>(i) * h + hh) * p;
  const int q = n / 4;  // float4 per state row = lanes per row (divides 32)
  const int total = p * q;
  const int iters = (total + kUpdateThreads - 1) / kUpdateThreads;
  for (int j = 0; j < iters; ++j) {
    const int f = threadIdx.x + kUpdateThreads * j;
    const bool ok = f < total;
    float part = 0.f;
    int pr = 0;
    if (ok) {
      pr = f / q;
      const int c = (f % q) * 4;
      float4 v = hs[f];
      const float xv = xr[pr];
      v.x = v.x * ea + xv * sb[c];
      v.y = v.y * ea + xv * sb[c + 1];
      v.z = v.z * ea + xv * sb[c + 2];
      v.w = v.w * ea + xv * sb[c + 3];
      part = v.x * sc[c] + v.y * sc[c + 1] + v.z * sc[c + 2] + v.w * sc[c + 3];
      if (write) hs[f] = v;
    }
    // Lanes of one state row are q consecutive lanes of one warp.
    for (int o = q / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (ok && f % q == 0) yr[pr] = part;
  }
}

template <int K, typename TB>
__global__ void ssd_scan_kernel(
    const float* __restrict__ x,  // (B, L, H, P)
    const float* __restrict__ a,  // (B, L, H)
    const TB* __restrict__ bm,    // (B, L, G, N), token stride sbc
    const TB* __restrict__ cm,    // (B, L, G, N), token stride sbc
    float* __restrict__ y,        // (B, L, H, P)
    float* __restrict__ h_out,    // (B, H, P, N)
    int l, int h, int p, int g, long long sbc, int chunk) {
  constexpr int N = 4 * K;
  extern __shared__ float smem[];
  float* sa = smem;            // chunk
  float* sx = sa + chunk;      // chunk x P
  float* sy = sx + chunk * p;  // chunk x P
  float* sB = sy + chunk * p;  // chunk x N
  float* sC = sB + chunk * N;  // chunk x N
  const int b = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int gi = hh / (h / g);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;  // 4P
  const int pr = tid >> 2;
  const int s = tid & 3;
  float st[K];
#pragma unroll
  for (int k = 0; k < K; ++k) st[k] = 0.f;

  for (int t0 = 0; t0 < l; t0 += chunk) {
    const int tl = min(chunk, l - t0);
    const size_t tok0 = static_cast<size_t>(b) * l + t0;
    for (int e = tid; e < tl; e += nt) sa[e] = a[(tok0 + e) * h + hh];
    for (int e = tid; e < tl * p; e += nt) {
      const int t = e / p;
      sx[e] = x[((tok0 + t) * h + hh) * p + (e - t * p)];
    }
    for (int e = tid; e < tl * N; e += nt) {
      const int t = e / N;
      const long long off = static_cast<long long>(tok0 + t) * sbc +
                            static_cast<long long>(gi) * N + (e - t * N);
      sB[e] = to_f(bm[off]);
      sC[e] = to_f(cm[off]);
    }
    __syncthreads();
    for (int t = 0; t < tl; ++t) {
      const float ea = expf(sa[t]);
      const float xv = sx[t * p + pr];
      const float* bt = sB + t * N;
      const float* ct = sC + t * N;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        st[k] = st[k] * ea + xv * bt[s + 4 * k];
        acc += st[k] * ct[s + 4 * k];
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (s == 0) sy[t * p + pr] = acc;
    }
    __syncthreads();
    for (int e = tid; e < tl * p; e += nt) {
      const int t = e / p;
      y[((tok0 + t) * h + hh) * p + (e - t * p)] = sy[e];
    }
    __syncthreads();  // the next chunk restages sx, sy, sB, sC
  }
  float* ho = h_out + ((static_cast<size_t>(b) * h + hh) * p + pr) * N;
#pragma unroll
  for (int k = 0; k < K; ++k) ho[s + 4 * k] = st[k];
}

template <int K, typename TB>
int launch_scan(const void* x, const void* a, const void* b, const void* c,
                void* y, void* h_out, int batch, int l, int h, int p, int g,
                long long sbc, int chunk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(chunk) *
                      (1 + 2 * p + 2 * 4 * K);
  auto kern = ssd_scan_kernel<K, TB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<batch * h, 4 * p, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const TB*>(b), static_cast<const TB*>(c),
      static_cast<float*>(y), static_cast<float*>(h_out), l, h, p, g, sbc, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB>
int dispatch_scan(const void* x, const void* a, const void* b, const void* c,
                  void* y, void* h_out, int batch, int l, int h, int p, int n,
                  int g, long long sbc, int chunk, cudaStream_t stream) {
  switch (n) {
    case 16: return launch_scan<4, TB>(x, a, b, c, y, h_out, batch, l, h, p, g, sbc, chunk, stream);
    case 32: return launch_scan<8, TB>(x, a, b, c, y, h_out, batch, l, h, p, g, sbc, chunk, stream);
    case 64: return launch_scan<16, TB>(x, a, b, c, y, h_out, batch, l, h, p, g, sbc, chunk, stream);
    case 128: return launch_scan<32, TB>(x, a, b, c, y, h_out, batch, l, h, p, g, sbc, chunk, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Pointers are device
// pointers on the current device; `bc_bf16` says whether B and C are bf16
// (1) or fp32 (0).  Each returns the cudaError_t of its launch (0 = ok).

// h_state (Bc, H, P, N) fp32, 16-byte aligned, updated in place; x (B, H,
// P) and a (B, H) fp32 contiguous; rows (B,) int32 with 0 <= rows[i];
// y (B, H, P) fp32 out.  N in {4, 8, ..., 128} (a power of two).
extern "C" int ssd_update(void* h_state, const void* x, const void* a,
                          const void* b, const void* c, const void* rows,
                          void* y, int batch, int bc, int h, int p, int n,
                          int g, long long sbc, int bc_bf16, void* stream) {
  if (batch < 1 || bc < 1 || h < 1 || p < 1 || g < 1 || h % g ||
      n < 4 || n > kMaxN || (n & (n - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_bf16) {
    ssd_update_kernel<__nv_bfloat16><<<batch * h, kUpdateThreads, 0, st>>>(
        static_cast<float*>(h_state), static_cast<const float*>(x),
        static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(c), static_cast<const int32_t*>(rows),
        static_cast<float*>(y), bc, h, p, n, g, sbc);
  } else {
    ssd_update_kernel<float><<<batch * h, kUpdateThreads, 0, st>>>(
        static_cast<float*>(h_state), static_cast<const float*>(x),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(c), static_cast<const int32_t*>(rows),
        static_cast<float*>(y), bc, h, p, n, g, sbc);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (B, L, H, P) and a (B, L, H) fp32 contiguous; y (B, L, H, P) and
// h_out (B, H, P, N) fp32 out.  P a multiple of 8 up to 256; N in {16, 32,
// 64, 128}; `chunk` steps of inputs staged in shared memory at a time.
extern "C" int ssd_scan(const void* x, const void* a, const void* b,
                        const void* c, void* y, void* h_out, int batch, int l,
                        int h, int p, int n, int g, long long sbc, int chunk,
                        int bc_bf16, void* stream) {
  if (batch < 1 || l < 1 || h < 1 || g < 1 || h % g || p < 8 || p % 8 ||
      p > 256 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bc_bf16
             ? dispatch_scan<__nv_bfloat16>(x, a, b, c, y, h_out, batch, l, h, p, n, g, sbc, chunk, st)
             : dispatch_scan<float>(x, a, b, c, y, h_out, batch, l, h, p, n, g, sbc, chunk, st);
}
