// Single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
// repro/kernels/flash_decode.py::flash_decode_pallas (body `_kernel`).
//
// What it computes: for query row b and kv head j, the G query heads of
// that group attend over row rows[b] (clamped into the cache, so the
// compacted runtime's out-of-bounds sentinel row reads the last row and
// never faults) of the resident ring cache k/v (Bc, C, Kh, D).  Slot c is
// valid when 0 <= k_pos[row, c] <= q_pos[b] and, with window > 0,
// q_pos[b] - k_pos[row, c] < window.  Masked slots score a finite -1e30
// (never -inf), so a fully masked row averages uniformly instead of going
// NaN; the output is acc / max(l, 1e-30), cast to bf16.  Scores and the
// online softmax run in fp32; q is pre-scaled by 1/sqrt(D).
//
// What bounds it on this card: bytes.  One call streams B * C * Kh * D
// bf16 of K and as much of V (402,653,184 B at B=8, C=4096, Kh=32,
// D=96); the arithmetic is 4 flops per K/V element pair, far below the
// card's ratio of ~295 flops per byte.
//
// What the design does about it: one block per (query row, kv head) — the
// TPU kernel's sequential C grid axis becomes a loop inside the block —
// with 8 warps each walking its own slots in tiles of 8.  A warp loads the
// 8 slots' K and V rows (bf16x2 per lane, neighbouring lanes on
// neighbouring addresses) before it reduces any of them, so every warp
// keeps 8 independent loads in flight; each warp carries its own online
// (m, l, acc) in registers and the 8 warps merge through shared memory in
// a fixed order (deterministic, no atomics).  D = 96 is not a power of
// two: lanes take bf16 pairs lane, lane+32, ... up to D/2, with the
// ragged tail masked.  It does not yet split C across blocks, so at
// B * Kh < 132 the card is not filled, nor skip slots past q_pos.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8;  // slots a warp loads before reducing them
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// G: query heads per kv head; P: bf16 pairs per lane (ceil(D / 64)).
template <int G, int P>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, Kh*G, D)
    const __nv_bfloat16* __restrict__ k,   // (Bc, C, Kh, D)
    const __nv_bfloat16* __restrict__ v,   // (Bc, C, Kh, D)
    const int32_t* __restrict__ k_pos,     // (Bc, C)
    const int32_t* __restrict__ q_pos,     // (B,)
    const int32_t* __restrict__ rows,      // (B,)
    __nv_bfloat16* __restrict__ out,       // (B, Kh*G, D)
    int bc, int c, int kh, int d, int window, float scale) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int npairs = d >> 1;

  int row = rows[b];
  row = row < 0 ? 0 : (row >= bc ? bc - 1 : row);
  const int qp = q_pos[b];
  const size_t row_base = static_cast<size_t>(row) * c;

  float2 qf[G][P];
  float2 acc[G][P];
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int idx = lane + 32 * p;
      float2 x = make_float2(0.f, 0.f);
      if (idx < npairs) {
        const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(
            q + (static_cast<size_t>(b) * kh * G + j * G + g) * d + 2 * idx);
        x = __bfloat1622float2(t);
        x.x *= scale;
        x.y *= scale;
      }
      qf[g][p] = x;
      acc[g][p] = make_float2(0.f, 0.f);
    }
  }

  for (int t0 = warp * kTile; t0 < c; t0 += kWarps * kTile) {
    __nv_bfloat162 kr[kTile][P], vr[kTile][P];
    int kp[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int slot = t0 + i;
      kp[i] = slot < c ? k_pos[row_base + slot] : -1;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int idx = lane + 32 * p;
        if (slot < c && idx < npairs) {
          const size_t off = ((row_base + slot) * kh + j) * d + 2 * idx;
          kr[i][p] = *reinterpret_cast<const __nv_bfloat162*>(k + off);
          vr[i][p] = *reinterpret_cast<const __nv_bfloat162*>(v + off);
        } else {
          kr[i][p] = __floats2bfloat162_rn(0.f, 0.f);
          vr[i][p] = kr[i][p];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[kTile];
      float tmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        float part = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float2 kk = __bfloat1622float2(kr[i][p]);
          part += qf[g][p].x * kk.x + qf[g][p].y * kk.y;
        }
        const float dot = warp_sum(part);
        const int slot = t0 + i;
        bool valid = kp[i] >= 0 && kp[i] <= qp;
        if (window > 0) valid = valid && (qp - kp[i] < window);
        // A slot past C does not exist: -inf gives it weight exactly 0.
        // A masked slot exists: the finite -1e30 keeps the uniform
        // average of a fully masked row, as the reference does.
        s[i] = slot >= c ? -INFINITY : (valid ? dot : kMasked);
        tmax = fmaxf(tmax, s[i]);
      }
      const float m_new = fmaxf(m[g], tmax);
      const float corr = expf(m[g] - m_new);
      float lsum = l[g] * corr;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        acc[g][p].x *= corr;
        acc[g][p].y *= corr;
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const float pr = expf(s[i] - m_new);
        lsum += pr;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float2 vv = __bfloat1622float2(vr[i][p]);
          acc[g][p].x += pr * vv.x;
          acc[g][p].y += pr * vv.y;
        }
      }
      l[g] = lsum;
      m[g] = m_new;
    }
  }

  // Merge the warps' (m, l, acc) in warp order.
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ float acc_s[G][P * 64];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  for (int e = threadIdx.x; e < G * P * 64; e += kThreads) {
    (&acc_s[0][0])[e] = 0.f;
  }
  __syncthreads();
  float m_all[G], l_all[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mm = m_s[0][g];
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, m_s[w][g]);
    float ll = 0.f;
    for (int w = 0; w < kWarps; ++w) ll += l_s[w][g] * expf(m_s[w][g] - mm);
    m_all[g] = mm;
    l_all[g] = ll;
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float f = expf(m[g] - m_all[g]);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int idx = lane + 32 * p;
          if (idx < npairs) {
            acc_s[g][2 * idx] += acc[g][p].x * f;
            acc_s[g][2 * idx + 1] += acc[g][p].y * f;
          }
        }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < G * d; e += kThreads) {
    const int g = e / d;
    const int x = e - g * d;
    out[(static_cast<size_t>(b) * kh * G + j * G + g) * d + x] =
        __float2bfloat16(acc_s[g][x] / fmaxf(l_all[g], 1e-30f));
  }
}

template <int G, int P>
int launch(const void* q, const void* k, const void* v, const void* k_pos,
           const void* q_pos, const void* rows, void* out, int b, int bc,
           int c, int kh, int d, int window, float scale,
           cudaStream_t stream) {
  dim3 grid(b, kh);
  flash_decode_kernel<G, P><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(k_pos), static_cast<const int32_t*>(q_pos),
      static_cast<const int32_t*>(rows), static_cast<__nv_bfloat16*>(out), bc,
      c, kh, d, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_p(int p, const void* q, const void* k, const void* v,
             const void* k_pos, const void* q_pos, const void* rows,
             void* out, int b, int bc, int c, int kh, int d, int window,
             float scale, cudaStream_t stream) {
  switch (p) {
    case 1: return launch<G, 1>(q, k, v, k_pos, q_pos, rows, out, b, bc, c, kh, d, window, scale, stream);
    case 2: return launch<G, 2>(q, k, v, k_pos, q_pos, rows, out, b, bc, c, kh, d, window, scale, stream);
    case 3: return launch<G, 3>(q, k, v, k_pos, q_pos, rows, out, b, bc, c, kh, d, window, scale, stream);
    case 4: return launch<G, 4>(q, k, v, k_pos, q_pos, rows, out, b, bc, c, kh, d, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every tensor is contiguous and
// on the current device; returns the cudaError_t of the launch (0 = ok).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* k_pos, const void* q_pos,
                                 const void* rows, void* out, int b, int bc,
                                 int c, int kh, int g, int d, int window,
                                 float scale, void* stream) {
  if (b < 1 || bc < 1 || c < 1 || kh < 1 || d < 2 || d % 2 || d > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int p = (d / 2 + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1: return launch_p<1>(p, q, k, v, k_pos, q_pos, rows, out, b, bc, c, kh, d, window, scale, s);
    case 2: return launch_p<2>(p, q, k, v, k_pos, q_pos, rows, out, b, bc, c, kh, d, window, scale, s);
    case 4: return launch_p<4>(p, q, k, v, k_pos, q_pos, rows, out, b, bc, c, kh, d, window, scale, s);
    case 8: return launch_p<8>(p, q, k, v, k_pos, q_pos, rows, out, b, bc, c, kh, d, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
