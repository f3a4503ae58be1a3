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
// fp32 of the recurrence started from h = 0, in the chunked form the TPU
// kernel uses (ssd_scan_pallas, ssd_chunked), chunks of Q = 64 tokens:
//     a_cum = cumsum(a) within the chunk (fp32)
//     S     = C B^T                          (Q x Q, masked i >= j)
//     Y     = (S o decay) X + exp(a_cum) o (C h_prev^T),
//             decay[i, j] = exp(a_cum[i] - a_cum[j])
//     h     = exp(a_cum[-1]) h_prev + (exp(a_cum[-1] - a_cum) o X)^T B
// A ragged last chunk is zero padded (a = 0, x = B = C = 0), a no-op on
// the state, as the reference's padding is.
//
// What bounds it on this card: at Zamba2-1.2B's admission shape (B = 8,
// L = 128, H = 64, P = N = 64) the bytes are 42 MB (x and y 16.8 MB each,
// the state 8.4 MB), 0.0125 ms at 3.35 TB/s; the chunked products are
// 2.1 GFLOP of matrix work, which the precision plan below runs as about
// 3x as many TF32 tensor-core operations, ~0.013 ms at 495 TFLOP/s — the
// two bounds meet.  The sequential recurrence the first version of this
// kernel ran needs no matrix unit but 1.34 GFLOP of fp32 FMAs in
// dependent steps, and reached 14% of the fp32 peak.
//
// What the design does about it: one block of 8 warps per (row, head)
// walks the chunks in order with h (P x N fp32) resident in shared memory.
// The next chunk's x, a, B and C are staged with cp.async (16 bytes a
// thread) into a second buffer while the current chunk computes, where two
// blocks still fit on an SM (N = 64); at N = 128 the chunks are staged in
// turn so that two blocks fit.  The four products run on the tensor cores
// as mma.sync m16n8k8 TF32 tiles, warp w owning 16-row tile w % 4 of each
// output and half w / 4 of its column tiles; the causal structure skips
// the tiles above the diagonal of S and of (S o decay) X.
//
// Precision plan (plain TF32 keeps ~11 bits and misses the checks):
//   * an fp32 operand is split as hi + lo, hi the nearest TF32 value and
//     lo the nearest TF32 value of the exact remainder (a split by
//     truncation leaves up to 2^-20 of the operand behind, rounding
//     2^-22); a product of two fp32 operands is lo*hi + hi*lo + hi*hi
//     (3xTF32), accumulated in fp32;
//   * bf16 B and C are exact in TF32, so C B^T is one product, and
//     C h_prev^T and the state update (the decay applied to X, not B) two;
//     fp32 B and C take the 3x form everywhere.
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

// ---- ssd_scan: the chunked form on the tensor cores
constexpr int kQ = 64;  // chunk length (the configs' ssm_chunk)
constexpr int kScanWarps = 8;
constexpr int kScanThreads = 32 * kScanWarps;
constexpr int kPad = 8;  // row padding: conflict-free fragment reads
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T> struct IsBf16 { static constexpr bool value = false; };
template <> struct IsBf16<__nv_bfloat16> { static constexpr bool value = true; };

// Byte offsets of the block's shared memory; `nbuf` staging buffers.
struct ScanLayout {
  size_t xs, bs, cs, as, xs_buf, bc_buf, as_buf, ms, hs, acum, ea, eend, total;
};
template <typename TB>
__host__ __device__ inline ScanLayout scan_layout(int p, int n, int nbuf) {
  ScanLayout s;
  s.xs_buf = sizeof(float) * kQ * (p + kPad);
  s.bc_buf = sizeof(TB) * kQ * (n + kPad);
  s.as_buf = sizeof(float) * kQ;
  s.xs = 0;
  s.bs = s.xs + nbuf * s.xs_buf;
  s.cs = s.bs + nbuf * s.bc_buf;
  s.as = s.cs + nbuf * s.bc_buf;
  s.ms = s.as + nbuf * s.as_buf;
  s.hs = s.ms + sizeof(float) * kQ * (kQ + kPad);
  s.acum = s.hs + sizeof(float) * p * (n + kPad);
  s.ea = s.acum + sizeof(float) * kQ;
  s.eend = s.ea + sizeof(float) * kQ;
  s.total = s.eend + sizeof(float) * kQ;
  return s;
}

// x rounded to the nearest TF32 value (ties away from zero), low 13
// mantissa bits cleared: the tensor core reads no more than the top 19.
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

template <bool kLo>
__device__ __forceinline__ FragA frag_a(float v0, float v1, float v2, float v3) {
  FragA f;
  const float v[4] = {v0, v1, v2, v3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32_hi(v[i]);
    f.lo[i] = kLo ? tf32_hi(v[i] - __uint_as_float(f.hi[i])) : 0u;
  }
  return f;
}
template <bool kLo>
__device__ __forceinline__ FragB frag_b(float v0, float v1) {
  FragB f;
  f.hi[0] = tf32_hi(v0);
  f.hi[1] = tf32_hi(v1);
  f.lo[0] = kLo ? tf32_hi(v0 - __uint_as_float(f.hi[0])) : 0u;
  f.lo[1] = kLo ? tf32_hi(v1 - __uint_as_float(f.hi[1])) : 0u;
  return f;
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[u] += a * b[u] for the four column tiles u that are on, with the low
// parts each operand has: lo*hi + hi*lo + hi*hi, issued term by term so
// that consecutive products go to different accumulators.
template <bool kLoA, bool kLoB>
__device__ __forceinline__ void mma3x4(float (*d)[4], const FragA& a,
                                       const FragB* b, const bool* on) {
  if (kLoA) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (on[u]) mma_tf32(d[u], a.lo, b[u].hi);
  }
  if (kLoB) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (on[u]) mma_tf32(d[u], a.hi, b[u].lo);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (on[u]) mma_tf32(d[u], a.hi, b[u].hi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage chunk tokens [t0, t0 + tl) of (row b, head hh) into one buffer;
// rows tl..kQ-1 are zeros (the reference's padding).  `aligned`: 16-byte
// cp.async; else element copies.
template <typename TB>
__device__ __forceinline__ void stage_chunk(
    float* xs, TB* bs, TB* cs, float* as, const float* x, const float* a,
    const TB* bm, const TB* cm, int b, int hh, int gi, int t0, int tl, int l,
    int h, int p, int n, long long sbc, bool aligned) {
  const int tid = threadIdx.x;
  const size_t tok0 = static_cast<size_t>(b) * l + t0;
  const int xq = p / 4;
  for (int e = tid; e < kQ * xq; e += kScanThreads) {
    const int i = e / xq;
    const int c = (e - i * xq) * 4;
    float* dst = xs + i * (p + kPad) + c;
    if (i < tl) {
      const float* src = x + ((tok0 + i) * h + hh) * p + c;
      if (aligned) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[u] = src[u];
      }
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int i = tid; i < kQ; i += kScanThreads) {
    if (i < tl) {
      cp_async4(as + i, a + (tok0 + i) * h + hh);
    } else {
      as[i] = 0.f;
    }
  }
  constexpr int kV = 16 / sizeof(TB);  // elements per 16 bytes
  const int bq = n / kV;
  for (int e = tid; e < 2 * kQ * bq; e += kScanThreads) {
    const int which = e / (kQ * bq);  // 0: B, 1: C
    const int r = e - which * kQ * bq;
    const int i = r / bq;
    const int c = (r - i * bq) * kV;
    TB* dst = (which ? cs : bs) + i * (n + kPad) + c;
    if (i < tl) {
      const TB* src = (which ? cm : bm) +
                      static_cast<long long>(tok0 + i) * sbc +
                      static_cast<long long>(gi) * n + c;
      if (aligned) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int u = 0; u < kV; ++u) dst[u] = src[u];
      }
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <typename TB>
__global__ void __launch_bounds__(kScanThreads, 2) ssd_scan_kernel(
    const float* __restrict__ x,  // (B, L, H, P)
    const float* __restrict__ a,  // (B, L, H)
    const TB* __restrict__ bm,    // (B, L, G, N), token stride sbc
    const TB* __restrict__ cm,    // (B, L, G, N), token stride sbc
    float* __restrict__ y,        // (B, L, H, P)
    float* __restrict__ h_out,    // (B, H, P, N)
    int l, int h, int p, int n, int g, long long sbc, int nbuf, int aligned) {
  constexpr bool kExact = IsBf16<TB>::value;  // bf16 B, C are exact TF32
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanLayout lay = scan_layout<TB>(p, n, nbuf);
  float* ms = reinterpret_cast<float*>(smem + lay.ms);
  float* hs = reinterpret_cast<float*>(smem + lay.hs);
  float* acum = reinterpret_cast<float*>(smem + lay.acum);
  float* ea = reinterpret_cast<float*>(smem + lay.ea);
  float* eend = reinterpret_cast<float*>(smem + lay.eend);
  const int b = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int gi = hh / (h / g);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Warp w owns 16-row tile rt = w % 4 of each output and one half
  // (ch = w / 4) of its column tiles.
  const int rt = warp & 3;
  const int ch = warp >> 2;
  const int gq = lane >> 2;  // fragment row / column group
  const int tq = lane & 3;
  const int ldx = p + kPad, ldb = n + kPad, ldm = kQ + kPad, ldh = n + kPad;
  const int nc = (l + kQ - 1) / kQ;
  auto bufx = [&](int k) { return reinterpret_cast<float*>(smem + lay.xs + k * lay.xs_buf); };
  auto bufb = [&](int k) { return reinterpret_cast<TB*>(smem + lay.bs + k * lay.bc_buf); };
  auto bufc = [&](int k) { return reinterpret_cast<TB*>(smem + lay.cs + k * lay.bc_buf); };
  auto bufa = [&](int k) { return reinterpret_cast<float*>(smem + lay.as + k * lay.as_buf); };
  auto stage = [&](int ci, int k) {
    stage_chunk<TB>(bufx(k), bufb(k), bufc(k), bufa(k), x, a, bm, cm, b, hh, gi,
                    ci * kQ, min(kQ, l - ci * kQ), l, h, p, n, sbc, aligned != 0);
    cp_async_commit();
  };

  stage(0, 0);
  for (int ci = 0; ci < nc; ++ci) {
    const int buf = nbuf == 2 ? (ci & 1) : 0;
    const int t0 = ci * kQ;
    const int tl = min(kQ, l - t0);
    if (nbuf == 2 && ci + 1 < nc) {
      stage(ci + 1, buf ^ 1);  // overlaps this chunk's products
      cp_async_wait<1>();
    } else {
      if (nbuf == 1 && ci > 0) stage(ci, 0);
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = bufx(buf);
    const TB* bs = bufb(buf);
    const TB* cs = bufc(buf);
    const float* as = bufa(buf);

    // 1. a_cum within the chunk (warp 0), exp(a_cum), exp(a_end - a_cum).
    if (warp == 0) {
      const float v0 = as[2 * lane];
      const float v1 = v0 + as[2 * lane + 1];
      float inc = v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
      }
      float ex = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) ex = 0.f;
      const float c0 = ex + v0, c1 = ex + v1;
      const float end = __shfl_sync(0xffffffffu, c1, 31);
      acum[2 * lane] = c0;
      acum[2 * lane + 1] = c1;
      ea[2 * lane] = expf(c0);
      ea[2 * lane + 1] = expf(c1);
      eend[2 * lane] = expf(end - c0);
      eend[2 * lane + 1] = expf(end - c1);
    }
    __syncthreads();
    const int i0 = 16 * rt;

    // 2. M = (C B^T) o decay, rows i0..i0+15, the column tiles j <= i of
    //    this warp's parity.
    {
      const int ntiles = (i0 + 16) / 8;  // even: both halves take ntiles / 2
      float sacc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[u][e] = 0.f;
      for (int k0 = 0; k0 < n; k0 += 8) {
        const TB* c_r0 = cs + (i0 + gq) * ldb + k0 + tq;
        const TB* c_r1 = c_r0 + 8 * ldb;
        const FragA fa = frag_a<!kExact>(to_f(c_r0[0]), to_f(c_r1[0]),
                                         to_f(c_r0[4]), to_f(c_r1[4]));
        FragB fb[4];
        bool on[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int nt = 2 * u + ch;
          on[u] = nt < ntiles;
          const TB* bp = bs + ((on[u] ? nt : 0) * 8 + gq) * ldb + k0 + tq;
          fb[u] = frag_b<!kExact>(to_f(bp[0]), to_f(bp[4]));
        }
        mma3x4<!kExact, !kExact>(sacc, fa, fb, on);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int nt = 2 * u + ch;
        if (nt < ntiles) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + gq + (e >> 1) * 8;
            const int jj = nt * 8 + 2 * tq + (e & 1);
            ms[i * ldm + jj] = i >= jj ? sacc[u][e] * expf(acum[i] - acum[jj]) : 0.f;
          }
        }
      }
    }
    __syncthreads();  // M's rows come from two warps

    // 3. Y = exp(a_cum) o (C h_prev^T) + M X, rows i0..i0+15; of each 64
    //    columns of P this warp takes half ch (four 8-column tiles).
    for (int pc = 32 * ch; pc < p; pc += 64) {
      float yacc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[u][e] = 0.f;
      if (ci > 0) {  // h_prev = 0 before the first chunk
        for (int k0 = 0; k0 < n; k0 += 8) {
          const TB* c_r0 = cs + (i0 + gq) * ldb + k0 + tq;
          const TB* c_r1 = c_r0 + 8 * ldb;
          const FragA fa = frag_a<!kExact>(to_f(c_r0[0]), to_f(c_r1[0]),
                                           to_f(c_r0[4]), to_f(c_r1[4]));
          FragB fb[4];
          bool on[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            on[u] = pc + u * 8 < p;
            const float* hp = hs + ((on[u] ? pc + u * 8 : 0) + gq) * ldh + k0 + tq;
            fb[u] = frag_b<true>(hp[0], hp[4]);
          }
          mma3x4<!kExact, true>(yacc, fa, fb, on);
        }
        const float e0 = ea[i0 + gq], e1 = ea[i0 + gq + 8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          yacc[u][0] *= e0;
          yacc[u][1] *= e0;
          yacc[u][2] *= e1;
          yacc[u][3] *= e1;
        }
      }
      for (int q0 = 0; q0 < i0 + 16; q0 += 8) {
        const float* m_r0 = ms + (i0 + gq) * ldm + q0 + tq;
        const float* m_r1 = m_r0 + 8 * ldm;
        const FragA fa = frag_a<true>(m_r0[0], m_r1[0], m_r0[4], m_r1[4]);
        FragB fb[4];
        bool on[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          on[u] = pc + u * 8 < p;
          const float* xp = xs + (q0 + tq) * ldx + (on[u] ? pc + u * 8 : 0) + gq;
          fb[u] = frag_b<true>(xp[0], xp[4 * ldx]);
        }
        mma3x4<true, true>(yacc, fa, fb, on);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p0 = pc + u * 8;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + gq + 8 * half;
          if (p0 < p && i < tl) {
            *reinterpret_cast<float2*>(
                y + ((static_cast<size_t>(b) * l + t0 + i) * h + hh) * p + p0 + 2 * tq) =
                make_float2(yacc[u][2 * half], yacc[u][2 * half + 1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done reading h_prev

    // 4. h = exp(a_end) h_prev + (exp(a_end - a_cum) o X)^T B: 16-row
    //    tiles of P, and of each 64 columns of N this warp's half.
    const float edec = expf(acum[kQ - 1]);
    for (int p0 = i0; p0 < p; p0 += 64) {
      for (int n0 = 32 * ch; n0 < n; n0 += 64) {
        float hacc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pr = p0 + gq + (e >> 1) * 8;
            const int col = n0 + u * 8 + 2 * tq + (e & 1);
            hacc[u][e] = ci > 0 && col < n && pr < p ? edec * hs[pr * ldh + col] : 0.f;
          }
        }
        for (int q0 = 0; q0 < kQ; q0 += 8) {
          // A[p][q] = exp(a_end - a_cum[q]) X[q][p]: the decay rides on X,
          // so bf16 B stays exact and the product takes two terms.
          const float* x0 = xs + (q0 + tq) * ldx + p0 + gq;
          const float d0 = eend[q0 + tq], d1 = eend[q0 + tq + 4];
          const FragA fa = frag_a<true>(d0 * x0[0], d0 * x0[8], d1 * x0[4 * ldx],
                                        d1 * x0[4 * ldx + 8]);
          FragB fb[4];
          bool on[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            on[u] = n0 + u * 8 < n;
            const TB* bp = bs + (q0 + tq) * ldb + (on[u] ? n0 + u * 8 : 0) + gq;
            fb[u] = frag_b<!kExact>(to_f(bp[0]), to_f(bp[4 * ldb]));
          }
          mma3x4<true, !kExact>(hacc, fa, fb, on);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pr = p0 + gq + (e >> 1) * 8;
            const int col = n0 + u * 8 + 2 * tq + (e & 1);
            if (col < n && pr < p) {
              hs[pr * ldh + col] = hacc[u][e];
              if (ci == nc - 1)
                h_out[((static_cast<size_t>(b) * h + hh) * p + pr) * n + col] = hacc[u][e];
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk restages the other buffer, reads hs
  }
}

template <typename TB>
int launch_scan(const void* x, const void* a, const void* b, const void* c,
                void* y, void* h_out, int batch, int l, int h, int p, int n,
                int g, long long sbc, cudaStream_t stream) {
  // Double-buffer only where two blocks still fit on an SM (Zamba2's
  // N = 64); else stage in turn, two blocks a SM (Mamba2-130M's N = 128).
  int nbuf = 2;
  size_t smem = scan_layout<TB>(p, n, 2).total;
  if (smem > kMaxSmem / 2) {
    nbuf = 1;
    smem = scan_layout<TB>(p, n, 1).total;
  }
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ssd_scan_kernel<TB>;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = kMaxSmem;
  }
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  const int aligned = (ptrs & 15) == 0 && (sbc * static_cast<long long>(sizeof(TB))) % 16 == 0;
  kern<<<batch * h, kScanThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const TB*>(b), static_cast<const TB*>(c),
      static_cast<float*>(y), static_cast<float*>(h_out), l, h, p, n, g, sbc,
      nbuf, aligned);
  return static_cast<int>(cudaGetLastError());
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
// h_out (B, H, P, N) fp32 out.  P a multiple of 8 up to 256; N a multiple
// of 8 up to 128; `chunk` must be 64 (the one chunk length the kernel
// computes).  Returns cudaErrorInvalidValue for anything else, or when
// the block's shared memory (one staging buffer) exceeds 227 KB.
extern "C" int ssd_scan(const void* x, const void* a, const void* b,
                        const void* c, void* y, void* h_out, int batch, int l,
                        int h, int p, int n, int g, long long sbc, int chunk,
                        int bc_bf16, void* stream) {
  if (batch < 1 || l < 1 || h < 1 || g < 1 || h % g || p < 8 || p % 8 ||
      p > 256 || n < 8 || n % 8 || n > kMaxN || chunk != kQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bc_bf16
             ? launch_scan<__nv_bfloat16>(x, a, b, c, y, h_out, batch, l, h, p, n, g, sbc, st)
             : launch_scan<float>(x, a, b, c, y, h_out, batch, l, h, p, n, g, sbc, st);
}
