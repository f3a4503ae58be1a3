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
// the output is bf16.
//
// Two routes, chosen by the head layout and K/V's alignment alone (never
// by the batch, the row map or the data), each a kernel over its own fixed
// split of C and a merge kernel, both launched from the same C entry:
//   * the split route (flash_decode_split_kernel): every G in {1, 2}, and
//     G in {4, 8} where D is not a multiple of 16 or K/V are not 16-byte
//     aligned;
//   * the grouped route (flash_decode_gqa_kernel): G in {4, 8}, D a
//     multiple of 16, K/V 16-byte aligned (every served GQA layout).
//
// What bounds it on this card: the bytes of the *valid* slots, and at the
// served sizes the chain of dependent round trips before them.  On the
// serving path a row holds ~136 valid slots of C = 4096 (128-token
// prompts, 16 decode steps).  At G = 1 (Phi-3-mini, Zamba2) that is 8 rows
// * 136 * 32 heads * 96 * 2 (K, V) * 2 B = 13.4 MB, 0.004 ms: one query
// meets each K row, a matrix product has nothing to share and the tensor
// cores buy nothing.  At G = 8 (Qwen3-30B-A3B: Kh = 4, D = 128) it is 8 *
// 136 * 4 * 128 * 2 * 2 B = 1.1 MB, a 0.00075 ms bound, and the G query
// heads meet the same K row: scoring 16 slots is a (16 x D)(D x G)
// product, the shape of one mma.sync.m16n8k16 per 16 of D.
//
// The split route (G = 1 and the odd layouts):
//   * A fixed split of C.  The grid is (B, Kh, S) with S = ceil(C / 512),
//     so B = 1 still launches Kh * S blocks (256 at Kh = 32, C = 4096).
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
//     with G so that q (pre-scaled by 1/sqrt(D) in fp32) and the
//     accumulators stay in registers: at G = 8, D = 128 no GL keeps them
//     small, so half the lanes idle and a warp scores one slot a pass --
//     why G = 4 and 8 take the grouped route.
//
// The grouped route (G = 4 and 8 at D % 16 == 0):
//   * Its own fixed split: 256 slots (kGqaSplit; 64, 128 and 512 timed
//     against it by experiments/flash_decode_ab.py, PERF.md), 16 splits at
//     C = 4096.  A served row's ~136 slots then sit in one busy block per
//     (row, kv head); finer splits spread them over more blocks but cost
//     more in the merge and in blocks with no valid slot than they win.
//     The same validity mask and in-order compaction as the split route,
//     and the same empty partial.
//   * Tiles of 16 valid slots.  Warp w of 4 takes tiles w, w + 4, ... of
//     the split's list in order (up to 4 a warp), and stages each tile's K
//     and V rows (one row of D bf16 per slot) in shared memory by 16-byte
//     cp.async copies, rows past the list zero-filled, in a ring of two:
//     the next tile's copies are in flight while one is scored.  A warp
//     waits on its own copies only: no block barrier in the loop.
//   * One instantiation per (G, D): with D a compile-time constant the
//     score and P.V loops unroll whole (a kernel a third faster at D = 128
//     than one instantiation per range of D, PERF.md).
//   * Scores on the tensor cores: S^T (16 slots x 8) = K_tile (16 x D) Q^T
//     (D x 8) by mma.sync.m16n8k16 bf16 with fp32 accumulation, K by
//     ldmatrix, Q^T loaded once per block, unscaled bf16 (at G = 4
//     columns 4-7 are zero and ignored).  bf16 x bf16 products are exact
//     in fp32; 1/sqrt(D) scales the fp32 scores after the product (scaling
//     bf16 q would round every score).  A tail tile's padding rows score
//     -inf before the max.
//   * The online softmax per head column in fp32 on the accumulator
//     fragments: a tile's max and sum are shuffles over the fragment's row
//     lanes.
//   * P.V on the tensor cores without rounding P to one bf16: O^T (D x 8)
//     += V^T (D x 16) (P_hi + P_mid + P_lo)^T, each term the bf16 of what
//     the ones before left of the fp32 weight (2^-27 of P left over, below
//     fp32's ulp), three mma.sync into one fp32 accumulator, V^T by
//     ldmatrix.trans, P's fragment transposed in registers (movmatrix).
//     One bf16 P would cost up to 2^-9 of each weight; two terms (2^-18)
//     pass the kernel's one-ulp check but moved a served branch entropy
//     past its kernel-vs-plain bound in an earlier design (PERF.md).
//   * wgmma (64-row tiles) and clusters are not used: a warp's share of a
//     split is a few tiles of 16 slots by 8 heads.
//   * A merge of its own.  The split route's merge walks the S splits one
//     after another in each thread (2 loads of (m, l) and one of acc per
//     split and element): reused here it took longer than the grouped
//     kernel itself (PERF.md).  The grouped merge loads a thread's partials
//     of 16 splits at once, beside the (m, l) loads, and has a warp per
//     query head compute every split's weight into shared memory.
//
// Both routes: each block writes an fp32 partial (m, l, acc) per query
// head to a workspace the wrapper allocates, (B, Kh, S, G, D); the merge
// kernel, launched from the same C entry point, adds the S partials of a
// (b, j) in split order: fixed, deterministic, no atomics.  Because each
// route's split depends on (C, G, D) and alignment only, a row's output is
// a function of that row's inputs alone (compaction on/off, a recycled
// slot and a solo run stay bitwise equal).  If every split is empty the
// merge writes the mean of V over all C slots of the cache row, the
// reference's uniform average (rows the caller discards: bucket padding,
// dead slots).
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

// ---- the grouped-query route
constexpr int kGqaWarps = 4;
constexpr int kGqaThreads = kGqaWarps * 32;
constexpr int kGqaSplit = 256;  // slots per split of the grouped route
constexpr int kTile = 16;       // slots a warp scores at once: the mma M
constexpr int kHeads = 8;       // mma N: the query heads of a kv head, padded
constexpr int kGqaMergeMaxThreads = 512;  // 4 outputs a thread at G = 8, D = 256
constexpr int kMergeBatch = 16;  // splits whose partials a merge thread loads at once
constexpr size_t kGqaMergeSmemMax = 200 * 1024;  // f and l f of up to 3,200 splits at G = 8
// Tiles a warp keeps in flight: two where a split holds two a warp.
constexpr int kRing = kGqaSplit / (kTile * kGqaWarps) >= 2 ? 2 : 1;
static_assert(kGqaSplit % 4 == 0 && kGqaSplit <= 4 * kGqaThreads,
              "one int4 of k_pos a thread covers the split");

// Row stride of a staged K or V tile, in bf16: D plus 8, so that the 8
// rows one ldmatrix reads start in 8 different 16-byte bank groups.
__host__ __device__ constexpr int gqa_stride(int d) { return d + 8; }

// Dynamic shared memory of a block: the warps' rings while they load and
// score, then the warps' partials (kHeads x (D + 4) floats a warp).
__host__ __device__ constexpr int gqa_smem_bytes(int d) {
  return kRing * kGqaWarps * 2 * kTile * gqa_stride(d) * 2 >
                 kGqaWarps * kHeads * (d + 4) * 4
             ? kRing * kGqaWarps * 2 * kTile * gqa_stride(d) * 2
             : kGqaWarps * kHeads * (d + 4) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 16-byte global -> shared copy; `fill` false writes zeros, reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col): bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transpose of the warp's 8 x 8 b16 matrix (lane l holds row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1, the lower column in the low half).
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// Two fp32 weights (x, y) as three packed bf16 pairs hi, mid, lo, each the
// bf16 of what the ones before left: x = hi + mid + lo to 2^-27 of x.
__device__ __forceinline__ void split3(float x, float y, uint32_t (&t)[3]) {
  t[0] = pack_bf16(x, y);
  const float2 h = unpack_bf16(t[0]);
  const float ex = x - h.x, ey = y - h.y;  // exact in fp32
  t[1] = pack_bf16(ex, ey);
  const float2 m = unpack_bf16(t[1]);
  t[2] = pack_bf16(ex - m.x, ey - m.y);
}

// The grouped route's partial of split s for (query row b, kv head j), in
// the split kernel's workspace layout.  G: query heads per kv head (4 or
// 8); kDt = D / 16, one instantiation per D (with D a compile-time
// constant the score and P.V loops unroll whole: 30% less time at D = 128
// than one instantiation per range of D, PERF.md).
template <int G, int kDt>
__global__ void __launch_bounds__(kGqaThreads) flash_decode_gqa_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, Kh*G, D)
    const __nv_bfloat16* __restrict__ k,   // (Bc, C, Kh, D), 16-byte aligned
    const __nv_bfloat16* __restrict__ v,   // (Bc, C, Kh, D), 16-byte aligned
    const int32_t* __restrict__ k_pos,     // (Bc, C)
    const int32_t* __restrict__ q_pos,     // (B,)
    const int32_t* __restrict__ rows,      // (B,)
    float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
    int bc, int c, int kh, int window, float scale) {
  constexpr int kD = 16 * kDt;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int list_s[kGqaSplit];
  __shared__ int wtot_s[kGqaWarps];
  __shared__ float wm_s[kGqaWarps][kHeads], wl_s[kGqaWarps][kHeads];
  __shared__ float wf_s[kGqaWarps][kHeads];  // each warp's weight per head

  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int s = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // mma fragment row group
  const int tq = lane & 3;   // and column pair
  int row = rows[b];
  row = row < 0 ? 0 : (row >= bc ? bc - 1 : row);
  const int qp = q_pos[b];
  const size_t row_base = static_cast<size_t>(row) * c;
  const int c0 = s * kGqaSplit;

  // ---- the split's validity mask (4 slots a thread), compacted in slot order
  int kp[4] = {-1, -1, -1, -1};
  const int32_t* kps = k_pos + row_base + c0;
  if (4 * tid < kGqaSplit) {
    if (c0 + kGqaSplit <= c && (c & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(k_pos) & 15) == 0) {
      const int4 t = *reinterpret_cast<const int4*>(kps + 4 * tid);
      kp[0] = t.x; kp[1] = t.y; kp[2] = t.z; kp[3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) kp[i] = c0 + 4 * tid + i < c ? kps[4 * tid + i] : -1;
    }
  }
  // q as the scores' B fragments, loaded while k_pos is in flight: lane
  // (gq, tq) holds head gq's D pairs 16 kk + 2 tq and 16 kk + 8 + 2 tq;
  // zero past G.
  uint32_t qb[kDt][2];
  {
    const __nv_bfloat16* qr = q + (static_cast<size_t>(b) * kh * G +
                                   static_cast<size_t>(j) * G + (gq < G ? gq : 0)) * kD;
#pragma unroll
    for (int kk = 0; kk < kDt; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        qb[kk][h] = gq < G ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 8 * h + 2 * tq)
                           : 0u;
      }
    }
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
  for (int w = 0; w < kGqaWarps; ++w) {
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

  // ---- warp w scores the list's tiles w, w + kGqaWarps, ... in order
  const int ds = gqa_stride(kD);
  __nv_bfloat16* wring =
      reinterpret_cast<__nv_bfloat16*>(smem) + warp * kRing * 2 * kTile * ds;
  const int ntiles = (n + kTile - 1) / kTile;
  const int mine = warp < ntiles ? (ntiles - warp + kGqaWarps - 1) / kGqaWarps : 0;
  const int cpr = kD / 8;  // 16-byte chunks of a row
  auto issue = [&](int i) {
    const int f = (warp + kGqaWarps * i) * kTile;  // the tile's first list entry
    const int rows_t = min(kTile, n - f);
    __nv_bfloat16* ks = wring + (i % kRing) * 2 * kTile * ds;
    __nv_bfloat16* vs = ks + kTile * ds;
    for (int e = lane; e < kTile * cpr; e += 32) {
      const int r = e / cpr;
      const int ch = e - r * cpr;
      const bool live = r < rows_t;
      const size_t src = live
          ? ((row_base + list_s[f + r]) * kh + j) * static_cast<size_t>(kD) + ch * 8 : 0;
      cp_async16(ks + r * ds + ch * 8, k + src, live);
      cp_async16(vs + r * ds + ch * 8, v + src, live);
    }
    cp_async_commit();
  };

  // The warp's online softmax for query heads 2 tq and 2 tq + 1: m is the
  // same in the lanes of one tq, l a per-lane partial sum.  acc[mt] holds
  // O^T rows 16 mt + gq and 16 mt + gq + 8 (of D) for those two heads.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[kDt][4];
#pragma unroll
  for (int mt = 0; mt < kDt; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

  for (int i = 0; i < kRing && i < mine; ++i) issue(i);
  const int mi = lane >> 3;  // the ldmatrix sub-matrix this lane addresses
  for (int i = 0; i < mine; ++i) {
    if (kRing > 1 && i + 1 < mine) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int rows_t = min(kTile, n - (warp + kGqaWarps * i) * kTile);
    const __nv_bfloat16* ks = wring + (i % kRing) * 2 * kTile * ds;
    const __nv_bfloat16* vs = ks + kTile * ds;
    // S^T (16 slots x 8 heads) = K (16 x D) Q^T, the even and odd D tiles
    // in two independent accumulators (half the dependent mma chain)
    float sc[4] = {0.f, 0.f, 0.f, 0.f}, so[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* ka = ks + ((mi & 1) * 8 + (lane & 7)) * ds + (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kDt; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, ka + 16 * kk);
      mma_bf16(kk & 1 ? so : sc, a, qb[kk][0], qb[kk][1]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) sc[t] += so[t];
    const bool va = gq < rows_t, vb = gq + 8 < rows_t;
    const float s0 = va ? sc[0] * scale : -INFINITY;  // slot gq, head 2 tq
    const float s1 = va ? sc[1] * scale : -INFINITY;  // slot gq, head 2 tq + 1
    const float s2 = vb ? sc[2] * scale : -INFINITY;  // slot gq + 8
    const float s3 = vb ? sc[3] * scale : -INFINITY;
    float x0 = fmaxf(s0, s2), x1 = fmaxf(s1, s3);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, o));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    }
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);  // finite: row 0 is valid
    const float f0 = expf(m0 - n0), f1 = expf(m1 - n1);
    const float p0 = expf(s0 - n0), p1 = expf(s1 - n1);
    const float p2 = expf(s2 - n0), p3 = expf(s3 - n1);
    l0 = l0 * f0 + p0 + p2;
    l1 = l1 * f1 + p1 + p3;
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int mt = 0; mt < kDt; ++mt) {
      acc[mt][0] *= f0;
      acc[mt][1] *= f1;
      acc[mt][2] *= f0;
      acc[mt][3] *= f1;
    }
    // O^T (D x 8 heads) += V^T (D x 16 slots) (P_hi + P_mid + P_lo)
    uint32_t pa[3], pb[3], ba[3], bb[3];
    split3(p0, p1, pa);  // slot gq
    split3(p2, p3, pb);  // slot gq + 8
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      ba[t] = movmatrix_trans(pa[t]);
      bb[t] = movmatrix_trans(pb[t]);
    }
    const __nv_bfloat16* vt = vs + ((mi >> 1) * 8 + (lane & 7)) * ds + (mi & 1) * 8;
#pragma unroll
    for (int mt = 0; mt < kDt; ++mt) {
      uint32_t a[4];
      ldsm_x4_trans(a, vt + 16 * mt);
      mma_bf16(acc[mt], a, ba[0], bb[0]);
      mma_bf16(acc[mt], a, ba[1], bb[1]);
      mma_bf16(acc[mt], a, ba[2], bb[2]);
    }
    __syncwarp();  // the tile's stage is free for tile i + kRing
    if (i + kRing < mine) issue(i + kRing);
  }

  // ---- the block's partial: its warps merged in warp order
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  __syncthreads();  // every warp has left its ring: the partials reuse it
  const int wst = kD + 4;  // a partial's row stride: its 4 column pairs in 4 bank groups
  float* wacc = reinterpret_cast<float*>(smem);  // [kGqaWarps][kHeads][wst]
  {
    float* wa = wacc + warp * kHeads * wst;
    if (gq == 0) {
      wm_s[warp][2 * tq] = m0;
      wm_s[warp][2 * tq + 1] = m1;
      wl_s[warp][2 * tq] = l0;
      wl_s[warp][2 * tq + 1] = l1;
    }
#pragma unroll
    for (int mt = 0; mt < kDt; ++mt) {
      const int x = 16 * mt + gq;
      wa[(2 * tq) * wst + x] = acc[mt][0];
      wa[(2 * tq + 1) * wst + x] = acc[mt][1];
      wa[(2 * tq) * wst + x + 8] = acc[mt][2];
      wa[(2 * tq + 1) * wst + x + 8] = acc[mt][3];
    }
  }
  __syncthreads();
  if (tid < G) {  // head tid: each warp's weight (0 for a warp with no tile)
    const int g = tid;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kGqaWarps; ++w)
      if (wl_s[w][g] > 0.f) mm = fmaxf(mm, wm_s[w][g]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kGqaWarps; ++w) {
      const float f = wl_s[w][g] > 0.f ? expf(wm_s[w][g] - mm) : 0.f;
      wf_s[w][g] = f;
      ll += wl_s[w][g] * f;
    }
    ws_ml[part * G + g] = make_float2(mm, ll);
  }
  __syncthreads();
  for (int e = 4 * tid; e < G * kD; e += 4 * kGqaThreads) {
    const int g = e / kD;  // D % 16 == 0: 4 elements share a head
    const int x = e - g * kD;
    float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kGqaWarps; ++w) {
      const float f = wf_s[w][g];
      if (f > 0.f) {  // a warp with no tile adds nothing
        const float4 a = *reinterpret_cast<const float4*>(wacc + (w * kHeads + g) * wst + x);
        aa.x += a.x * f;
        aa.y += a.y * f;
        aa.z += a.z * f;
        aa.w += a.w * f;
      }
    }
    *reinterpret_cast<float4*>(ws_acc + (part * G + g) * kD + x) = aa;
  }
}

// The grouped route's merge of the S partials of (query row b, kv head
// j) into the bf16 output, a thread per 4 outputs (and at least a warp per
// query head).  Each thread first loads its outputs' partials of the first
// kMergeBatch splits, before their weights are known (an empty split's acc
// is never written: it is loaded but not used), so that those loads and
// the (m, l) loads share one round trip.  Warp g then finds head g's
// largest split max and writes each split's weight f_s = exp(m_s - m) and
// l_s f_s (0 for an empty split) to shared memory, and its lane 0 adds the
// l_s f_s in split order; each thread adds f_s acc_s over the splits in
// split order.  With every split empty, the mean of V over the row's C
// slots (the reference's uniform average of a fully masked row).
template <int G>
__global__ void __launch_bounds__(kGqaMergeMaxThreads) flash_decode_gqa_merge_kernel(
    const __nv_bfloat16* __restrict__ v,   // (Bc, C, Kh, D)
    const int32_t* __restrict__ rows,      // (B,)
    const float* __restrict__ ws_acc, const float2* __restrict__ ws_ml,
    __nv_bfloat16* __restrict__ out,       // (B, Kh*G, D)
    int bc, int c, int kh, int d, int splits) {
  extern __shared__ float f_s[];  // [2][splits][G]: f, then l f
  __shared__ float ll_s[G];
  float* lf_s = f_s + splits * G;
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t part0 = (static_cast<size_t>(b) * kh + j) * splits;
  const int e = 4 * tid;  // this thread's 4 outputs: D % 16 == 0, one head
  const bool has = e < G * d;
  const int g = has ? e / d : 0;
  const float* ab = ws_acc + (part0 * G + g) * d + (e - g * d);
  const size_t step = static_cast<size_t>(G) * d;
  float4 a[kMergeBatch];
#pragma unroll
  for (int u = 0; u < kMergeBatch; ++u) {
    a[u] = has && u < splits ? *reinterpret_cast<const float4*>(ab + u * step)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (warp < G) {
    const int h = warp;
    float mm = -INFINITY;
    for (int s = lane; s < splits; s += 32) {
      const float2 ml = ws_ml[(part0 + s) * G + h];
      if (ml.y > 0.f) mm = fmaxf(mm, ml.x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
    for (int s = lane; s < splits; s += 32) {
      const float2 ml = ws_ml[(part0 + s) * G + h];
      const float f = ml.y > 0.f ? expf(ml.x - mm) : 0.f;  // an empty split: 0
      f_s[s * G + h] = f;
      lf_s[s * G + h] = ml.y * f;
    }
    __syncwarp();
    if (lane == 0) {
      float ll = 0.f;
      for (int s = 0; s < splits; ++s) ll += lf_s[s * G + h];
      ll_s[h] = ll;
    }
  }
  __syncthreads();
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * kh + j) * G * d;
  // Validity does not depend on the query head: head 0's l says it all.
  if (ll_s[0] > 0.f) {
    if (!has) return;
    float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += kMergeBatch) {
      if (s0 > 0) {
#pragma unroll
        for (int u = 0; u < kMergeBatch; ++u) {
          if (s0 + u < splits) a[u] = *reinterpret_cast<const float4*>(ab + (s0 + u) * step);
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const float f = s0 + u < splits ? f_s[(s0 + u) * G + g] : 0.f;
        if (f > 0.f) {  // an empty split adds nothing
          aa.x += a[u].x * f;
          aa.y += a[u].y * f;
          aa.z += a[u].z * f;
          aa.w += a[u].w * f;
        }
      }
    }
    const float ll = ll_s[g];
    *reinterpret_cast<uint2*>(ob + e) =
        make_uint2(pack_bf16(aa.x / ll, aa.y / ll), pack_bf16(aa.z / ll, aa.w / ll));
    return;
  }
  // Fully masked: thread (r, p) sums bf16 pair p over slots r, r + R, ...;
  // the R partial sums are added in r order (as the split route's merge).
  float* red_s = f_s;  // reused: 2 * nthr floats
  int row = rows[b];
  row = row < 0 ? 0 : (row >= bc ? bc - 1 : row);
  const int np = d / 2;
  const int nr = nthr / np;
  const int p = tid % np;
  const int r = tid / np;
  float2 sum = make_float2(0.f, 0.f);
  if (r < nr) {
    const __nv_bfloat16* vr = v + (static_cast<size_t>(row) * c * kh + j) * d + 2 * p;
    const size_t vstep = static_cast<size_t>(kh) * d;
#pragma unroll 8
    for (int cc = r; cc < c; cc += nr) {
      const float2 t = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vr + cc * vstep));
      sum.x += t.x;
      sum.y += t.y;
    }
  }
  red_s[2 * tid] = sum.x;
  red_s[2 * tid + 1] = sum.y;
  __syncthreads();
  for (int x = tid; x < d; x += nthr) {
    float t = 0.f;
    for (int rr = 0; rr < nr; ++rr) t += red_s[2 * (rr * np + x / 2) + (x & 1)];
    const __nv_bfloat16 mean = __float2bfloat16(t / static_cast<float>(c));
    for (int h = 0; h < G; ++h) ob[h * d + x] = mean;
  }
}

// Threads of the grouped merge: a warp per query head, at least one
// thread per 4 outputs.
int gqa_merge_threads(int g, int d) { return 32 * g > g * d / 4 ? 32 * g : g * d / 4; }

// Dynamic shared memory of the grouped merge: f and l f per (split, head),
// at least the fully masked row's 2 floats a thread.
size_t gqa_merge_smem_bytes(int g, int d, int splits) {
  const size_t n = static_cast<size_t>(2) * splits * g;
  const size_t t = static_cast<size_t>(2) * gqa_merge_threads(g, d);
  return (n > t ? n : t) * sizeof(float);
}

// Launch one grouped-route instantiation and its merge, raising both
// kernels' dynamic shared memory limits once per device first (above 48 KB
// a launch needs it).
template <int G, int kDt>
int launch_gqa(const void* q, const void* k, const void* v, const void* k_pos,
               const void* q_pos, const void* rows, void* out, float* ws_acc,
               float2* ws_ml, int b, int bc, int c, int kh, int window, float scale,
               int splits, cudaStream_t stream) {
  static bool raised[64] = {};
  const size_t merge_smem = gqa_merge_smem_bytes(G, 16 * kDt, splits);
  if (merge_smem > kGqaMergeSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    err = static_cast<int>(cudaFuncSetAttribute(
        flash_decode_gqa_kernel<G, kDt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        gqa_smem_bytes(16 * kDt)));
    if (err == 0) {
      err = static_cast<int>(cudaFuncSetAttribute(
          flash_decode_gqa_merge_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kGqaMergeSmemMax));
    }
    if (err != 0) return err;
    raised[dev] = true;
  }
  flash_decode_gqa_kernel<G, kDt>
      <<<dim3(b, kh, splits), kGqaThreads, gqa_smem_bytes(16 * kDt), stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(k_pos),
          static_cast<const int32_t*>(q_pos), static_cast<const int32_t*>(rows),
          ws_acc, ws_ml, bc, c, kh, window, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_decode_gqa_merge_kernel<G>
      <<<dim3(b, kh), gqa_merge_threads(G, 16 * kDt), merge_smem, stream>>>(
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(rows), ws_acc,
      ws_ml, static_cast<__nv_bfloat16*>(out), bc, c, kh, 16 * kDt, splits);
  return static_cast<int>(cudaGetLastError());
}

// The grouped route at D = 16 kDt, or the next instantiation up to D = 256.
template <int G, int kDt = 1>
int launch_gqa_at(int d, const void* q, const void* k, const void* v, const void* k_pos,
                  const void* q_pos, const void* rows, void* out, float* ws_acc,
                  float2* ws_ml, int b, int bc, int c, int kh, int window, float scale,
                  int splits, cudaStream_t stream) {
  if constexpr (kDt > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (d != 16 * kDt) {
      return launch_gqa_at<G, kDt + 1>(d, q, k, v, k_pos, q_pos, rows, out, ws_acc, ws_ml,
                                       b, bc, c, kh, window, scale, splits, stream);
    }
    return launch_gqa<G, kDt>(q, k, v, k_pos, q_pos, rows, out, ws_acc, ws_ml, b, bc, c, kh,
                              window, scale, splits, stream);
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
// B * Kh * splits * G * (D + 2) floats, with splits = ceil(C / 128) on the
// grouped route (G in {4, 8}, D % 16 == 0, K and V 16-byte aligned) and
// ceil(C / 512) on the split route (every other layout): the launcher's
// split plan, checked here.  Launches the route's kernel and its merge
// kernel on `stream`; returns the first cudaError_t (0 = ok).
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* k_pos, const void* q_pos,
                                 const void* rows, void* out, void* ws, int b,
                                 int bc, int c, int kh, int g, int d,
                                 int window, float scale, int splits,
                                 void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const bool grouped = (g == 4 || g == 8) && d % 16 == 0 && aligned;
  const int split = grouped ? kGqaSplit : kSplit;
  if (b < 1 || bc < 1 || c < 1 || kh < 1 || d < 2 || d % 2 || d > 256 ||
      splits != (c + split - 1) / split) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = d % 8 == 0 && aligned;
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
  if (grouped) {  // one instantiation per (G, D)
    return g == 4 ? launch_gqa_at<4>(d, q, k, v, k_pos, q_pos, rows, out, ws_acc, ws_ml, b,
                                     bc, c, kh, window, scale, splits, s)
                  : launch_gqa_at<8>(d, q, k, v, k_pos, q_pos, rows, out, ws_acc, ws_ml, b,
                                     bc, c, kh, window, scale, splits, s);
  }
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
