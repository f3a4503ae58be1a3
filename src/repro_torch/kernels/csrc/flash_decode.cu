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
// (never -inf), so a fully masked row averages V uniformly over all C
// slots instead of going NaN.  Scores and the online softmax run in fp32;
// q is pre-scaled by 1/sqrt(D); the output is bf16.
//
// What bounds it on this card: the bytes of the *valid* slots.  The work
// is 4 flops per K/V element pair, far below the card's ~295 flops per
// byte; and at G = 1 (Phi-3-mini, Zamba2) one query meets each K row, so
// a matrix product has nothing to share and the tensor cores buy nothing.
// On the serving path a row holds ~136 valid slots of C = 4096 (128-token
// prompts, 16 decode steps), so the bound is 8 rows * 136 * 32 heads *
// 96 * 2 (K, V) * 2 B = 13.4 MB, 0.004 ms; streaming every slot, as the
// first version of this kernel did, moved 30x that.
//
// What the design does about it:
//   * A fixed split of C.  The grid is (B, Kh, S) with S = ceil(C / 512):
//     the split depends on C only, never on B, the row map or the data, so
//     a row's output is a function of that row's inputs alone (compaction
//     on/off, a recycled slot and a solo run stay bitwise equal), and B = 1
//     still launches Kh * S blocks (256 at Kh = 32, C = 4096).
//   * Only valid slots are read.  A block loads its split's 512 k_pos
//     (one int4, 16 bytes, per thread), forms the validity mask and
//     compacts the valid slots into a list in shared memory, in slot order.
//     A split with no valid slot writes an empty partial and returns
//     without touching K or V.  Skipping a masked slot is exact: whenever
//     a row has a valid slot, a masked slot's weight exp(-1e30 - m) is 0 in
//     fp32; only the summation order changes.
//   * Loads in flight.  A group of GL lanes takes one slot; each lane holds
//     CH chunks of E bf16 (E = 8: 16 bytes a lane; E = 2 when D is not a
//     multiple of 8).  At D = 96 that is 4 lanes x 3 chunks, no lane idle,
//     8 slots per warp; every lane issues its U = 2 slots' K and V loads
//     (12 x 16 bytes at D = 96) before it reduces any of them.  GL grows
//     with G so that q and the accumulators stay in registers.
//   * Combine.  Each block writes an fp32 partial (m, l, acc) per query
//     head to a workspace the wrapper allocates; a second small kernel,
//     launched from the same C entry point, merges the S partials of a
//     (b, j) in split order: fixed, deterministic, no atomics.  If every
//     split is empty it writes the mean of V over all C slots of the cache
//     row, the reference's uniform average (rows the caller discards:
//     bucket padding, dead slots).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSplit = 4 * kThreads;  // 512 slots: one int4 of k_pos a thread
constexpr int kUnroll = 2;            // slots a lane loads before reducing
constexpr int kMergeThreads = 128;

template <int E> struct VecOf;
template <> struct VecOf<8> { using type = uint4; };
template <> struct VecOf<2> { using type = uint32_t; };

__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const uint32_t& v, float* f) {
  const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  f[0] = t.x;
  f[1] = t.y;
}

__device__ __forceinline__ bool slot_valid(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
}

// Partial of split s for (query row b, kv head j): over the split's valid
// slots, m (running max), l (sum of weights) and acc (weighted V sum) per
// query head.  ws_acc (B, Kh, S, G, D); ws_ml (B, Kh, S, G) float2 (m, l),
// l = 0 for a split with no valid slot (its acc is not written).
//
// G: query heads per kv head; E: bf16 per chunk; GL: lanes per slot; CH:
// chunks per lane (GL * CH * E >= D, the ragged chunks masked).
template <int G, int E, int GL, int CH>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, Kh*G, D)
    const __nv_bfloat16* __restrict__ k,   // (Bc, C, Kh, D)
    const __nv_bfloat16* __restrict__ v,   // (Bc, C, Kh, D)
    const int32_t* __restrict__ k_pos,     // (Bc, C)
    const int32_t* __restrict__ q_pos,     // (B,)
    const int32_t* __restrict__ rows,      // (B,)
    float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
    int bc, int c, int kh, int d, int window, float scale) {
  using Vec = typename VecOf<E>::type;
  constexpr int kSpw = 32 / GL;   // slots a warp takes per pass
  constexpr int kDm = GL * CH * E;
  __shared__ int list_s[kSplit];
  __shared__ int wtot_s[kWarps];
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ float acc_s[kWarps][G][kDm];

  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int s = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int row = rows[b];
  row = row < 0 ? 0 : (row >= bc ? bc - 1 : row);
  const int qp = q_pos[b];
  const size_t row_base = static_cast<size_t>(row) * c;
  const int c0 = s * kSplit;

  // ---- the split's validity mask, compacted in slot order
  int kp[4];
  const int32_t* kps = k_pos + row_base + c0;
  if (c0 + kSplit <= c && (c & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(k_pos) & 15) == 0) {
    const int4 t = *reinterpret_cast<const int4*>(kps + 4 * tid);
    kp[0] = t.x; kp[1] = t.y; kp[2] = t.z; kp[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) kp[i] = c0 + 4 * tid + i < c ? kps[4 * tid + i] : -1;
  }
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) bits |= slot_valid(kp[i], qp, window) ? 1u << i : 0u;
  const int cnt = __popc(bits);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wtot_s[warp] = incl;
  __syncthreads();
  int n = 0, off = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? wtot_s[w] : 0;
    n += wtot_s[w];
  }
  off += incl - cnt;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (bits & (1u << i)) list_s[off++] = c0 + 4 * tid + i;
  }
  const size_t part = (static_cast<size_t>(b) * kh + j) * splits + s;
  if (n == 0) {  // no valid slot: an empty partial, K and V untouched
    if (tid < G) ws_ml[part * G + tid] = make_float2(-INFINITY, 0.f);
    return;
  }
  __syncthreads();

  // ---- q in registers: lane (grp, gl) holds chunks gl + GL * ch
  const int grp = lane / GL;
  const int gl = lane % GL;
  const int nch = d / E;
  float qf[G][CH * E];
  float acc[G][CH * E];
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    const __nv_bfloat16* qr = q + (static_cast<size_t>(b) * kh * G + j * G + g) * d;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int chunk = gl + GL * ch;
#pragma unroll
      for (int e = 0; e < E; e += 2) {
        float2 x = make_float2(0.f, 0.f);
        if (chunk < nch) {
          x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(qr + chunk * E + e));
        }
        qf[g][ch * E + e] = x.x * scale;
        qf[g][ch * E + e + 1] = x.y * scale;
        acc[g][ch * E + e] = 0.f;
        acc[g][ch * E + e + 1] = 0.f;
      }
    }
  }

  // ---- the valid slots, kUnroll per lane group per pass
  for (int base = warp * kSpw * kUnroll; base < n; base += kWarps * kSpw * kUnroll) {
    Vec kr[kUnroll][CH], vr[kUnroll][CH];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * kSpw + grp;
      live[u] = e < n;
      const size_t off_kv =
          ((row_base + (live[u] ? list_s[e] : 0)) * kh + j) * static_cast<size_t>(d);
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        const int chunk = gl + GL * ch;
        if (live[u] && chunk < nch) {
          kr[u][ch] = *reinterpret_cast<const Vec*>(k + off_kv + chunk * E);
          vr[u][ch] = *reinterpret_cast<const Vec*>(v + off_kv + chunk * E);
        } else {
          kr[u][ch] = Vec{};
          vr[u][ch] = Vec{};
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc[kUnroll];
      float tmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part_dot = 0.f;
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          float kf[E];
          unpack(kr[u][ch], kf);
#pragma unroll
          for (int e = 0; e < E; ++e) part_dot += qf[g][ch * E + e] * kf[e];
        }
#pragma unroll
        for (int o = GL / 2; o > 0; o >>= 1)
          part_dot += __shfl_xor_sync(0xffffffffu, part_dot, o);
        sc[u] = live[u] ? part_dot : -INFINITY;
        tmax = fmaxf(tmax, sc[u]);
      }
      if (tmax == -INFINITY) continue;  // this group had no slot this pass
      const float m_new = fmaxf(m[g], tmax);
      const float corr = expf(m[g] - m_new);
      float lsum = l[g] * corr;
#pragma unroll
      for (int i = 0; i < CH * E; ++i) acc[g][i] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float pr = expf(sc[u] - m_new);
        lsum += pr;
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          float vf[E];
          unpack(vr[u][ch], vf);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][ch * E + e] += pr * vf[e];
        }
      }
      l[g] = lsum;
      m[g] = m_new;
    }
  }

  // ---- merge the warp's lane groups (butterfly), then the warps in order
#pragma unroll
  for (int o = GL; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mm = fmaxf(m[g], mo);
      const float fa = mm == -INFINITY ? 0.f : expf(m[g] - mm);
      const float fb = mm == -INFINITY ? 0.f : expf(mo - mm);
      l[g] = l[g] * fa + lo * fb;
#pragma unroll
      for (int i = 0; i < CH * E; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        acc[g][i] = acc[g][i] * fa + ao * fb;
      }
      m[g] = mm;
    }
  }
  if (lane < GL) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc_s[warp][g][(gl + GL * ch) * E + e] = acc[g][ch * E + e];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * d; e += kThreads) {
    const int g = e / d;
    const int x = e - g * d;
    float mm = m_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, m_s[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w][g] - mm);  // a warp with no slot: exp(-inf) = 0
      ll += l_s[w][g] * f;
      aa += acc_s[w][g][x] * f;
    }
    ws_acc[(part * G + g) * d + x] = aa;
    if (x == 0) ws_ml[part * G + g] = make_float2(mm, ll);
  }
}

// Merge the S partials of (query row b, kv head j) in split order into the
// bf16 output; with every split empty, the mean of V over the row's C
// slots (the reference's uniform average of a fully masked row).
__global__ void __launch_bounds__(kMergeThreads) flash_decode_merge_kernel(
    const __nv_bfloat16* __restrict__ v,   // (Bc, C, Kh, D)
    const int32_t* __restrict__ rows,      // (B,)
    const float* __restrict__ ws_acc, const float2* __restrict__ ws_ml,
    __nv_bfloat16* __restrict__ out,       // (B, Kh*G, D)
    int bc, int c, int kh, int g_heads, int d, int splits) {
  __shared__ int any_s;
  __shared__ float red_s[kMergeThreads * 2];
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t part0 = (static_cast<size_t>(b) * kh + j) * splits;
  // Validity does not depend on the query head: head 0's l says it all.
  if (tid == 0) {
    int any = 0;
    for (int s = 0; s < splits && !any; ++s) any = ws_ml[(part0 + s) * g_heads].y > 0.f;
    any_s = any;
  }
  __syncthreads();
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * kh + j) * g_heads * d;
  if (any_s) {
    for (int e = tid; e < g_heads * d; e += kMergeThreads) {
      const int g = e / d;
      const int x = e - g * d;
      float mm = -INFINITY;
      for (int s = 0; s < splits; ++s) {
        const float2 ml = ws_ml[(part0 + s) * g_heads + g];
        if (ml.y > 0.f) mm = fmaxf(mm, ml.x);
      }
      float ll = 0.f, aa = 0.f;
      for (int s = 0; s < splits; ++s) {
        const float2 ml = ws_ml[(part0 + s) * g_heads + g];
        if (ml.y > 0.f) {  // an empty split's acc was never written
          const float f = expf(ml.x - mm);
          ll += ml.y * f;
          aa += ws_acc[((part0 + s) * g_heads + g) * d + x] * f;
        }
      }
      ob[e] = __float2bfloat16(aa / ll);
    }
    return;
  }
  // Fully masked: thread (r, p) sums bf16 pair p over slots r, r + R, ...;
  // the R partial sums are added in r order.
  int row = rows[b];
  row = row < 0 ? 0 : (row >= bc ? bc - 1 : row);
  const int np = d / 2;
  const int nr = kMergeThreads / np;
  const int p = tid % np;
  const int r = tid / np;
  float2 sum = make_float2(0.f, 0.f);
  if (r < nr) {
    const __nv_bfloat16* vr = v + (static_cast<size_t>(row) * c * kh + j) * d + 2 * p;
    const size_t step = static_cast<size_t>(kh) * d;
#pragma unroll 8
    for (int cc = r; cc < c; cc += nr) {
      const float2 t = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vr + cc * step));
      sum.x += t.x;
      sum.y += t.y;
    }
  }
  red_s[2 * tid] = sum.x;
  red_s[2 * tid + 1] = sum.y;
  __syncthreads();
  for (int x = tid; x < d; x += kMergeThreads) {
    float t = 0.f;
    for (int rr = 0; rr < nr; ++rr) t += red_s[2 * (rr * np + x / 2) + (x & 1)];
    const __nv_bfloat16 mean = __float2bfloat16(t / static_cast<float>(c));
    for (int g = 0; g < g_heads; ++g) ob[g * d + x] = mean;
  }
}

template <int G, int E, int GL, int CH>
int launch(const void* q, const void* k, const void* v, const void* k_pos,
           const void* q_pos, const void* rows, float* ws_acc, float2* ws_ml,
           int b, int bc, int c, int kh, int d, int window, float scale,
           int splits, cudaStream_t stream) {
  flash_decode_split_kernel<G, E, GL, CH><<<dim3(b, kh, splits), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(k_pos),
      static_cast<const int32_t*>(q_pos), static_cast<const int32_t*>(rows),
      ws_acc, ws_ml, bc, c, kh, d, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every tensor is contiguous and
// on the current device; `ws` is an fp32 workspace of
// B * Kh * splits * G * (D + 2) floats, with splits = ceil(C / 512) (the
// launcher's split plan; checked here).  Launches the split kernel and the
// merge kernel on `stream`; returns the first cudaError_t (0 = ok).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* k_pos, const void* q_pos,
                                 const void* rows, void* out, void* ws, int b,
                                 int bc, int c, int kh, int g, int d,
                                 int window, float scale, int splits,
                                 void* stream) {
  if (b < 1 || bc < 1 || c < 1 || kh < 1 || d < 2 || d % 2 || d > 256 ||
      splits != (c + kSplit - 1) / kSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = d % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int e = wide ? 8 : 2;
  const int nch = d / e;
  // Lanes per slot: the fewest that keep G * CH * E <= 32 floats of q (and
  // as many of acc) per lane; 32 when none does, and always for E = 2.
  int gl = 32;
  if (wide) {
    for (int t = 4; t <= 32; t <<= 1) {
      if (g * ((nch + t - 1) / t) <= 4) { gl = t; break; }
    }
  }
  const int ch = (nch + gl - 1) / gl;
  float* ws_acc = static_cast<float*>(ws);
  float2* ws_ml = reinterpret_cast<float2*>(
      ws_acc + static_cast<size_t>(b) * kh * splits * g * d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  // The instantiations the rule above reaches; a lane's chunk count is
  // rounded up to the next one listed (ragged chunks are masked).  An
  // entry missing here returns cudaErrorInvalidValue: chip_smoke.py's
  // layout sweep (every G, every even D, aligned and not) reaches them all.
#define FD_TRY(G_, E_, GL_, CH_)                                              \
  if (err == static_cast<int>(cudaErrorInvalidValue) && g == G_ && e == E_ && \
      gl == GL_ && ch <= CH_)                                                 \
    err = launch<G_, E_, GL_, CH_>(q, k, v, k_pos, q_pos, rows, ws_acc, ws_ml,\
                                   b, bc, c, kh, d, window, scale, splits, s);
  FD_TRY(1, 8, 4, 1) FD_TRY(1, 8, 4, 2) FD_TRY(1, 8, 4, 3) FD_TRY(1, 8, 4, 4)
  FD_TRY(1, 8, 8, 4)
  FD_TRY(2, 8, 4, 1) FD_TRY(2, 8, 4, 2) FD_TRY(2, 8, 8, 2) FD_TRY(2, 8, 16, 2)
  FD_TRY(4, 8, 4, 1) FD_TRY(4, 8, 8, 1) FD_TRY(4, 8, 16, 1) FD_TRY(4, 8, 32, 1)
  FD_TRY(8, 8, 32, 1)
  FD_TRY(1, 2, 32, 1) FD_TRY(1, 2, 32, 2) FD_TRY(1, 2, 32, 4)
  FD_TRY(2, 2, 32, 1) FD_TRY(2, 2, 32, 2) FD_TRY(2, 2, 32, 4)
  FD_TRY(4, 2, 32, 1) FD_TRY(4, 2, 32, 2) FD_TRY(4, 2, 32, 4)
  FD_TRY(8, 2, 32, 1) FD_TRY(8, 2, 32, 2) FD_TRY(8, 2, 32, 4)
#undef FD_TRY
  if (err != 0) return err;
  flash_decode_merge_kernel<<<dim3(b, kh), kMergeThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(rows),
      ws_acc, ws_ml, static_cast<__nv_bfloat16*>(out), bc, c, kh, g, d, splits);
  return static_cast<int>(cudaGetLastError());
}
