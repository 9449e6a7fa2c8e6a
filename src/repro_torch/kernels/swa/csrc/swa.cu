// Causal sliding-window attention, hand-written for Hopper (sm_90a).
//
// Replaces swa_pallas of src/repro/kernels/swa/kernel.py (body _swa_kernel):
// o = softmax(mask(Q K^T * D^-1/2)) V with query i attending key j iff
// j <= i, i - j < window and j < S; GQA reads kv head h / (H / KV) in place.
//
// What bounds it on an H100: operations.  Each query row takes 4 D flops per
// live key (Q K^T and P V), 4 B H D sum_i min(i + 1, W) in all, against q, k, v
// and o moved once; at D = 256 and W = 2048 that is ~1000 flops per byte.
// Two kernels, one per input type:
//
// fp32 (swa_kernel): all math fp32 on the CUDA cores, no TF32, so the floor
// is the 67 TFLOP/s fp32 rate.
//  * One block of 256 threads per (query tile of BQ = 64 rows, head, batch).
//    The block walks only the kv tiles (BK = 32 keys) that overlap its rows'
//    windows, [q0 - W + 1, q_last], each exactly once: the TPU kernel's
//    sequential kv grid axis becomes this loop, and its VMEM scratch (m, l,
//    acc) lives in registers.
//  * Q^T (D x 64) stays in shared memory for the whole walk; each kv tile
//    stages K^T (D x 32) and V (32 x D).  Q^T and K^T are d-major so a
//    thread reads its 4 query rows as one float4 and its 2 keys as one
//    float2 per d: 8 FMAs for 2 shared loads.  D = 256 needs 148 KB of
//    dynamic shared memory (set with cudaFuncSetAttribute).
//  * Thread (ty, tx) of a 16 x 16 grid holds scores of rows 4 ty .. 4 ty + 3
//    and keys 2 tx, 2 tx + 1; row max and row sum reduce over the 16 lanes
//    of the row with shuffles.  It accumulates O rows 4 ty .. 4 ty + 3 at
//    columns tx + 16 jj, jj < NJ (NJ = ceil(D / 16) rounded to 4, 8 or 16),
//    so any D <= 256 works (120 included) with zero-padded V columns.
//
// bf16 (swa_bf16_kernel): both products on the tensor cores, floor the 989
// TFLOP/s bf16 rate.
//  * Q K^T with mma.sync m16n8k16 bf16 -> fp32: a bf16 x bf16 product is
//    exact in fp32, so only the order of the sums differs from fp32 math.
//    The D^-1/2 scale multiplies the fp32 scores.
//  * P V on the tensor cores with p split in two: p_hi = bf16(p), p_lo =
//    bf16(p - p_hi), two mmas into the same fp32 accumulators, so p keeps
//    ~16 bits as the TPU kernel keeps p in fp32 (one bf16 p, as the
//    reference's model path rounds it, would change the result by ~2^-9).
//  * One block of four warps per (64 query rows, head, batch), the heads of
//    a kv head next to each other in the grid (they read the same K/V tiles
//    through L2).  Each warp owns 16 query rows: their scores, softmax state
//    and all of O's columns (128 fp32 accumulators a thread at D = 256), so
//    no warp exchanges anything and no product is computed twice.  K and V
//    tiles are staged as bf16 with cp.async, double buffered, so the next
//    tile's copy overlaps this tile's math.  D <= 128: 64-key tiles, Q's
//    fragments loaded once per block into registers.  D = 256: registers
//    hold O, so Q's fragments are re-read from shared memory with ldmatrix,
//    and 32-key tiles keep a block at 99 KB so that two blocks share an SM.
//    D is zero-padded in shared memory to 16, 32, 64, 128 or 256.
//  * Only the band's edge tiles (the diagonal tile and the window's trailing
//    tile) take a per-element mask; interior tiles take none.
//
// Both kernels: masked scores are -inf and never reach expf: p = 0 for a
// masked key, and the running-max correction is 1 while a row has seen no
// live key, so exp(-inf - (-inf)) never forms.  (The TPU kernel uses -1e30
// instead, which gives p = 1 on a wholly masked first tile and is cleared by
// the correction once a live key arrives: the same result.)  Wholly masked
// kv tiles are never visited.  The output is acc / max(l, 1e-30), as the
// reference divides, cast to the input type.  Rows >= S (a ragged tail)
// load zeros, are computed and are not stored.
//
// Interface: plain C, one entry per dtype, launched on the caller's stream;
// each returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 32;      // keys per kv tile
constexpr int NT = 256;     // threads per block, a 16 x 16 grid
constexpr int QS = BQ + 4;  // row stride of Q^T and P^T (16-byte aligned rows)
constexpr int KS = BK + 4;  // row stride of K^T (16-byte aligned rows)

static_assert(NT == 256 && BQ == 64 && BK == 32,
              "the thread layout below assumes a 16 x 16 grid on 64 x 32 scores");

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// accumulator columns per thread (D padded to 16 * NJ), by head dim D <= 256
constexpr int nj_for(int D) { return D <= 64 ? 4 : D <= 128 ? 8 : 16; }

__host__ __device__ constexpr size_t smem_floats(int D, int DP) {
  return static_cast<size_t>(D) * QS + static_cast<size_t>(D) * KS +
         static_cast<size_t>(BK) * DP + static_cast<size_t>(BK) * QS;
}

template <int NJ>
__global__ void __launch_bounds__(NT)
    swa_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               float* __restrict__ o, int H, int KV, int S, int D, int window, float scale) {
  constexpr int DP = NJ * 16;  // padded head dim of V and of the accumulators
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][QS]
  float* Kt = Qt + static_cast<size_t>(D) * QS;  // [D][KS]
  float* Vs = Kt + static_cast<size_t>(D) * KS;  // [BK][DP]
  float* Pt = Vs + BK * DP;                      // [BK][QS]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t q_base = (static_cast<size_t>(b) * H + h) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * KV + h / (H / KV)) * S * D;

  // Q^T once; rows >= S load as 0
  {
    int r = tid / D, d = tid % D;
    for (int e = tid; e < BQ * D; e += NT) {
      const int s = q0 + r;
      Qt[d * QS + r] = s < S ? q[q_base + static_cast<size_t>(s) * D + d] : 0.f;
      d += NT;
      while (d >= D) { d -= D; ++r; }
    }
  }
  // V's padded columns [D, DP) stay 0 for the whole walk
  for (int e = tid; e < BK * (DP - D); e += NT) {
    const int c = e / (DP - D);
    Vs[c * DP + D + e % (DP - D)] = 0.f;
  }

  float acc[4][NJ];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_begin = max(0, q0 - window + 1) / BK;
  const int kt_end = q_last / BK;
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K^T, V and P^T are read (and Q^T is staged)
    {
      int c = tid / D, d = tid % D;
      for (int e = tid; e < BK * D; e += NT) {
        const int s = k0 + c;
        const bool in = s < S;
        const size_t at = kv_base + static_cast<size_t>(s) * D + d;
        Kt[d * KS + c] = in ? k[at] : 0.f;
        Vs[c * DP + d] = in ? v[at] : 0.f;
        d += NT;
        while (d >= D) { d -= D; ++c; }
      }
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * QS + ty * 4]);
      const float2 kb = *reinterpret_cast<const float2*>(&Kt[d * KS + tx * 2]);
      sc[0][0] = fmaf(qa.x, kb.x, sc[0][0]);
      sc[0][1] = fmaf(qa.x, kb.y, sc[0][1]);
      sc[1][0] = fmaf(qa.y, kb.x, sc[1][0]);
      sc[1][1] = fmaf(qa.y, kb.y, sc[1][1]);
      sc[2][0] = fmaf(qa.z, kb.x, sc[2][0]);
      sc[2][1] = fmaf(qa.z, kb.y, sc[2][1]);
      sc[3][0] = fmaf(qa.w, kb.x, sc[3][0]);
      sc[3][1] = fmaf(qa.w, kb.y, sc[3][1]);
    }

    // online softmax over this tile, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool live[2];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + tx * 2 + j;
        live[j] = kj <= qi && qi - kj < window && kj < S;
        sc[i][j] *= scale;
        if (live[j]) mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      // while the row has seen no live key, m_new is -inf: keep corr = 1
      const float corr = m_new == -INFINITY ? 1.f : expf(m_run[i] - m_new);
      float p[2], psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[j] = live[j] ? expf(sc[i][j] - m_new) : 0.f;
        psum += p[j];
      }
      l_run[i] = corr * l_run[i] + row_sum(psum);
      m_run[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
      Pt[(tx * 2) * QS + ty * 4 + i] = p[0];
      Pt[(tx * 2 + 1) * QS + ty * 4 + i] = p[1];
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * QS + ty * 4]);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float vv = Vs[c * DP + tx + 16 * jj];
        acc[0][jj] = fmaf(pa.x, vv, acc[0][jj]);
        acc[1][jj] = fmaf(pa.y, vv, acc[1][jj]);
        acc[2][jj] = fmaf(pa.z, vv, acc[2][jj]);
        acc[3][jj] = fmaf(pa.w, vv, acc[3][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) o[q_base + static_cast<size_t>(s) * D + d] = acc[i][jj] / l;
    }
  }
}

template <int NJ>
int launch_nj(const float* q, const float* k, const float* v, float* o, int B, int H, int KV,
              int S, int D, int window, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(D, NJ * 16) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        swa_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  swa_kernel<NJ><<<grid, NT, bytes, stream>>>(q, k, v, o, H, KV, S, D, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
               int S, int D, int window, float scale, void* stream) {
  cudaGetLastError();
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k);
  const auto* vt = static_cast<const float*>(v);
  auto* ot = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch (nj_for(D)) {
    case 4: return launch_nj<4>(qt, kt, vt, ot, B, H, KV, S, D, window, scale, st);
    case 8: return launch_nj<8>(qt, kt, vt, ot, B, H, KV, S, D, window, scale, st);
    default: return launch_nj<16>(qt, kt, vt, ot, B, H, KV, S, D, window, scale, st);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products in a pipelined flash kernel
// ---------------------------------------------------------------------------

constexpr int TQ = 64;       // query rows per block: four warps of 16 rows
constexpr int TC_THREADS = 128;

// DP: D zero-padded to 16, 32, 64, 128 or 256
template <int DP>
struct Tc {
  static constexpr int kBKV = DP > 128 ? 32 : 64;  // keys per kv tile
  static constexpr bool kQRegs = DP <= 128;        // Q's fragments held in registers
  static constexpr int kStride = DP + 8;  // bf16 row stride: conflict-free ldmatrix
  // Q, then K and V, each double buffered: 99 KB at D = 256, two blocks an SM
  static constexpr size_t kSmem = static_cast<size_t>(TQ + 4 * kBKV) * kStride * 2;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p = hi + lo to ~16 bits: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// Rows row0 .. row0 + nrows - 1 of a (S, D) bf16 matrix into dst (row stride
// ST), columns D .. DP - 1 and rows >= S as zeros.  16-byte cp.async when vec
// (D % 8 == 0 and q, k, v 16-byte aligned: every row then starts on 16
// bytes), else plain loads.
template <int DP, int ST, int NTH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                          int row0, int nrows, int S, int D, bool vec) {
  for (int e = threadIdx.x; e < nrows * (DP / 8); e += NTH) {
    const int r = e / (DP / 8), c = (e % (DP / 8)) * 8, s = row0 + r;
    __nv_bfloat16* at = dst + r * ST + c;
    if (vec) {
      const bool valid = s < S && c < D;
      cp_async16(at, valid ? src + static_cast<size_t>(s) * D + c : src, valid);
    } else {
      alignas(16) __nv_bfloat16 tmp[8];
#pragma unroll
      for (int x = 0; x < 8; ++x)
        tmp[x] = (s < S && c + x < D) ? src[static_cast<size_t>(s) * D + c + x]
                                      : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(at) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS)
    swa_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                    int KV, int S, int D, int window, float scale, bool vec) {
  constexpr int ST = Tc<DP>::kStride, BKV = Tc<DP>::kBKV, NTH = TC_THREADS;
  constexpr bool kQRegs = Tc<DP>::kQRegs;
  constexpr int KS = DP / 16;   // k = 16 steps of Q K^T
  constexpr int NS = BKV / 8;   // 8-key score fragments of a warp's 16 rows
  constexpr int NO = DP / 8;    // 8-column O fragments of a warp's 16 rows
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [TQ][ST]
  __nv_bfloat16* Ks = Qs + TQ * ST;                              // [2][BKV][ST]
  __nv_bfloat16* Vs = Ks + 2 * BKV * ST;                         // [2][BKV][ST]

  const int h = blockIdx.x % H, q0 = (blockIdx.x / H) * TQ, b = blockIdx.y;
  const int rg = threadIdx.x / 32, lane = threadIdx.x % 32;  // warp: rows 16 rg ..
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3, mrow = lane & 7;
  const size_t q_base = (static_cast<size_t>(b) * H + h) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * KV + h / (H / KV)) * S * D;

  const int q_last = min(q0 + TQ, S) - 1;
  const int kv_begin = max(0, q0 - window + 1) / BKV;
  const int kv_end = q_last / BKV;

  load_rows<DP, ST, NTH>(Qs, q + q_base, q0, TQ, S, D, vec);
  load_rows<DP, ST, NTH>(Ks, k + kv_base, kv_begin * BKV, BKV, S, D, vec);
  load_rows<DP, ST, NTH>(Vs, v + kv_base, kv_begin * BKV, BKV, S, D, vec);
  cp_async_commit();

  uint32_t qf[kQRegs ? KS : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows g, g + 8
  const int row_a = q0 + rg * 16 + g;

  for (int kt = kv_begin; kt <= kv_end; ++kt) {
    const int buf = (kt - kv_begin) & 1;
    if (kt < kv_end) {  // the next tile's copy overlaps this tile's math
      const int nb = buf ^ 1;
      load_rows<DP, ST, NTH>(Ks + nb * BKV * ST, k + kv_base, (kt + 1) * BKV, BKV, S, D, vec);
      load_rows<DP, ST, NTH>(Vs + nb * BKV * ST, v + kv_base, (kt + 1) * BKV, BKV, S, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // Q's fragment of step ks: (rows 0-7 | 8-15) x (d 0-7 | 8-15) -> a0 a1 a2 a3
    auto q_frag = [&](uint32_t(&r)[4], int ks) {
      ldsm_x4(r, Qs + (rg * 16 + (mat & 1) * 8 + mrow) * ST + ks * 16 + (mat >> 1) * 8);
    };
    if constexpr (kQRegs) {
      if (kt == kv_begin) {  // once per block
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) q_frag(qf[ks], ks);
      }
    }
    const __nv_bfloat16* Kt = Ks + buf * BKV * ST;
    const __nv_bfloat16* Vt = Vs + buf * BKV * ST;

    // scores of rows g, g + 8 against keys k0 + 8 n + 2 t + {0, 1}
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int x = 0; x < 4; ++x) qa[x] = qf[ks][x];
      } else {  // D = 256: registers hold O; re-read Q from shared memory
        q_frag(qa, ks);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];  // (keys 0-7 | 8-15) x (d 0-7 | 8-15) -> two key fragments
        ldsm_x4(r, Kt + (np * 16 + (mat >> 1) * 8 + mrow) * ST + ks * 16 + (mat & 1) * 8);
        mma_bf16(sc[2 * np], qa, r[0], r[1]);
        mma_bf16(sc[2 * np + 1], qa, r[2], r[3]);
      }
    }

    // online softmax in fp32; only the band's edge tiles take a mask
    const int k0 = kt * BKV;
    const bool edge = !(k0 + BKV - 1 <= q0 && q0 + TQ - 1 - k0 < window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale;
        if (edge) {
          const int qi = row_a + (e >> 1) * 8, kj = k0 + n * 8 + 2 * t + (e & 1);
          if (!(kj <= qi && qi - kj < window && kj < S)) x = -INFINITY;
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      // while the row has seen no live key, m_new is -inf: keep corr = 1
      corr[r] = m_new == -INFINITY ? 1.f : expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[n][e];
        const float p = x == -INFINITY ? 0.f : expf(x - m_run[e >> 1]);
        sc[n][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l_run[r] = corr[r] * l_run[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += (P_hi + P_lo) V: the score fragments of keys 16 j .. 16 j + 15
    // are the A fragment of step j
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      uint32_t ahi[4], alo[4];
      split_bf16(sc[2 * j][0], sc[2 * j][1], ahi[0], alo[0]);
      split_bf16(sc[2 * j][2], sc[2 * j][3], ahi[1], alo[1]);
      split_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1], ahi[2], alo[2]);
      split_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3], ahi[3], alo[3]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t r[4];  // (keys 0-7 | 8-15) x (d 0-7 | 8-15), transposed -> two O fragments
        ldsm_x4_trans(r, Vt + (j * 16 + (mat & 1) * 8 + mrow) * ST + dp * 16 + (mat >> 1) * 8);
        mma_bf16(acc[2 * dp], ahi, r[0], r[1]);
        mma_bf16(acc[2 * dp], alo, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], ahi, r[2], r[3]);
        mma_bf16(acc[2 * dp + 1], alo, r[2], r[3]);
      }
    }
    __syncthreads();  // this tile is read before the next copy overwrites it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row_a + r * 8;
    if (s >= S) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int d = n * 8 + 2 * t + x;
        if (d < D)
          o[q_base + static_cast<size_t>(s) * D + d] = __float2bfloat16_rn(acc[n][2 * r + x] / l);
      }
  }
}

constexpr int dp_for(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256; }

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
              int S, int D, int window, float scale, cudaStream_t stream) {
  const long long blocks = static_cast<long long>((S + TQ - 1) / TQ) * H;
  if (blocks > INT_MAX || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Tc<DP>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      swa_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // x: the heads of one query tile next to each other, then the query tiles
  swa_bf16_kernel<DP><<<dim3(static_cast<unsigned>(blocks), B), TC_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, KV, S, D, window,
      scale, D % 8 == 0 && aligned16(q, k, v));
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                int S, int D, int window, float scale, void* stream) {
  cudaGetLastError();
  auto st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch (dp_for(D)) {
    case 16: return launch_tc<16>(q, k, v, o, B, H, KV, S, D, window, scale, st);
    case 32: return launch_tc<32>(q, k, v, o, B, H, KV, S, D, window, scale, st);
    case 64: return launch_tc<64>(q, k, v, o, B, H, KV, S, D, window, scale, st);
    case 128: return launch_tc<128>(q, k, v, o, B, H, KV, S, D, window, scale, st);
    default: return launch_tc<256>(q, k, v, o, B, H, KV, S, D, window, scale, st);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at head dim D (0 above 256), of the
// fp32 kernel (bf16 == 0) or the bf16 one.
int swa_smem_bytes(int D, int bf16) {
  if (D < 1 || D > 256) return 0;
  if (!bf16) return static_cast<int>(smem_floats(D, nj_for(D) * 16) * sizeof(float));
  switch (dp_for(D)) {
    case 16: return static_cast<int>(Tc<16>::kSmem);
    case 32: return static_cast<int>(Tc<32>::kSmem);
    case 64: return static_cast<int>(Tc<64>::kSmem);
    case 128: return static_cast<int>(Tc<128>::kSmem);
    default: return static_cast<int>(Tc<256>::kSmem);
  }
}

int swa_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int S,
            int D, int window, float scale, void* stream) {
  return launch_f32(q, k, v, o, B, H, KV, S, D, window, scale, stream);
}

int swa_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int S,
             int D, int window, float scale, void* stream) {
  return launch_bf16(q, k, v, o, B, H, KV, S, D, window, scale, stream);
}

}  // extern "C"
