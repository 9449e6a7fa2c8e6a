// Chunkwise mLSTM (matrix memory with stabilized exponential gates),
// hand-written for Hopper (sm_90a).
//
// Replaces mlstm_pallas of src/repro/kernels/mlstm/kernel.py (body
// _mlstm_kernel): for every (batch, head), from zero state,
//   m_t = max(m_{t-1} + log_f_t, i_t)
//   C_t = e^{m_{t-1}+log_f_t-m_t} C_{t-1} + e^{i_t-m_t} v_t k_t^T,  n_t likewise with k_t
//   h_t = C_t q~_t / max(|n_t . q~_t|, e^{-m_t}),  q~ = q D^-1/2
// in the chunkwise form of the TPU kernel: within a chunk of c steps the
// gated scores S_ij = (q~_i . k_j) e^{A_i - A_j + i_j - m_i} (j <= i, A the
// in-chunk cumulative log-forget) and the carried (C, n, m) of the chunk's
// start give every h_i; the chunk's end updates the state.
//
// What bounds it on an H100: operations.  A chunk of a (batch, head) takes
// 4 c D (q k^T and S V) + 4 c D^2 (C q~ and the v k^T update) flops against
// 4 (3 D + 2) bytes per step in fp32; at D = 1024, c = 256 that is ~800 flops
// per byte.
//
// Design.  The TPU kernel keeps C (D x D fp32) in VMEM across its sequential
// chunk axis; at D = 1024 that is 4 MiB per (batch, head), far above an SM's
// 227 KB, and one block per (batch, head) would fill 32 of 132 SMs.  So the
// work is split into four grids on the caller's stream:
//  1. gates: one warp per (batch, head) walks the steps in 32-step slices
//     (shuffle scans): A_t (in-chunk cumulative log-forget), m_t and the m of
//     each chunk's start.  A scalar chain, so cheap.
//  2. states: one block per (128 x 128 tile of C^T, batch, head) walks the
//     chunks in order with its tile in registers: it decays the tile and
//     adds the chunk's sum_j w_j v_j k_j^T (w_j = e^{A_c - A_j + i_j - m_c}),
//     and stores the state entering every chunk after the first to a
//     workspace (C^T, e-major; n beside it).  This is the TPU kernel's carry
//     loop, parallel over the tiles of C.
//  3. scores: one block per (lower-triangular 128 x 128 tile pair, chunk,
//     batch, head) forms S_ij, gated and masked, into the workspace.  j > i
//     is written as 0 and never reaches expf, as the reference selects 0
//     there (a 0/1 mask would give inf * 0 = NaN).
//  4. outputs: one block per (128 rows, 128 columns of h, chunk, batch,
//     head): C q~ from the stored state, scaled by e^{m_prev + A_i - m_i},
//     then S V over the chunk's keys added on; the row sums of S and n . q~
//     for the denominator; h = num / max(|den|, e^{-m_i}).
// Grids 2 and 4 have two bodies, one per input type; grid 3 is one body
// for both.
//
// fp32 (state_kernel, score_kernel, out_kernel): IEEE fp32 FMAs on the CUDA
// cores, floor the 67 TFLOP/s fp32 rate.  Every product is a 128 x 128 tile
// from 16-deep staged slices: thread (ty, tx) of a 16 x 16 grid owns rows
// {4 ty, 64 + 4 ty} + 0..3 and columns {4 tx, 64 + 4 tx} + 0..3, one
// accumulator of 8 x 8, and reads its rows and columns as four float4 from
// shared memory per step: 64 FMAs for 4 loads.  Each grid is held to 128
// registers a thread, so two blocks (16 warps) share an SM.  Slices are
// staged by plain loads, with no overlap of loads and products.
//
// bf16 (state_mma_kernel, score_kernel<bf16>, out_mma_kernel): the two
// D x D products, the state update sum_j (w_j v_j) k_j^T and C q~, 84% of
// the work at D = 1024, c = 256, on the tensor cores (mma.sync m16n8k16,
// fp32 accumulators, floor the 989 TFLOP/s bf16 rate).  Each has one fp32
// operand, w v or C, split into bf16 terms x = hi + lo with hi = bf16(x),
// lo = bf16(x - hi) (WV_SPLIT, C_SPLIT terms); every term is multiplied into
// the same fp32 accumulators, so the operand keeps ~16 bits as the TPU
// kernel keeps it in fp32 (one term would move h by ~1e-3 in norm).
// The gated scores S = q k^T and S V, the rest, stay fp32 FMAs on the CUDA
// cores in the fp32 body's order, sum for sum: a random-weight xlstm-1.3b
// amplifies any rounding difference in S through its 48 layers, and with S
// from the tensor cores (two or three terms of S, IEEE partial sums, fp32
// FMA scores with tensor-core S V) its pooled features parted from the
// plain version's by 0.07-0.36 in norm on an H100 against 0.047 for the
// fp32 body, whose S matches the plain version's summation order.
//  * Each tensor-core block is 8 warps on a 128 x 128 fp32 tile, a warp 32
//    rows x 64 columns (2 x 8 m16n8 fragments).  Slices 32 deep (two k16
//    steps) are staged by 16-byte cp.async into a ring of stages in dynamic
//    shared memory (rows padded by 16 bytes, so ldmatrix is conflict-free),
//    several slices in flight while the warps multiply the current one; one
//    barrier a slice.  Each warp reads the next step's fragments before it
//    issues this step's mma.
//  * states: A = k^T (ldmatrix.trans of the staged k rows), B = the WV_SPLIT
//    terms of w v, formed in shared memory from the staged v rows one
//    slice ahead (two buffers, so one barrier a slice serves both).  The
//    state entering each chunk is stored as C_SPLIT bf16 planes of C^T, the
//    terms the outputs grid multiplies: as many bytes as fp32 at two terms.
//  * outputs: C q through the ring (A = q rows, B = the C^T planes as
//    stored), then S V and the row sums of S with fp32 FMAs on the same
//    accumulators, in the fp32 grid's order.
// What bounds the bf16 body at D = 1024: the chunk states' workspace, 4 D^2
// bytes per chunk and (batch, head), written once and read by each of the
// c / 128 row tiles of the outputs grid (~7.6 GB at (8, 4, 4096, 1024),
// c = 256, ~2.3 ms at 3.35 TB/s), and the CUDA-core S path (~0.1 TFLOP at
// fp32, ~1.6 ms at peak), against ~1.03 TFLOP of tensor-core work (~1.0 ms
// at peak).  Keeping C on chip across chunks is the next step.
// The workspace holds 4 D^2 (S / c - 1) + 4 S c + ~12 S bytes per (batch,
// head): 1.9 GiB at (8, 4, 4096, 1024), c = 256.
//
// Numerics: m starts at -1e30, so every decay of the first chunk is exactly
// 0; every other exponent but -m_i is <= 0 by construction, and e^{-m_i}
// may overflow to +inf (m_i < -88.7), giving h = 0 as in the reference.
// The gate arithmetic is fp32 in both bodies, expf the accurate one (no
// fast math), and a product with a decay or a gate rounds before it is
// summed.  The sums run in another order than the reference's (the decayed
// state, or decay_q C q~, is the sum's start), which moves h by ~1e-6 in
// norm; the bf16 body's split operands and tensor-core sums add ~1e-6.
// A ragged S is masked: rows >= S load zeros and are not stored, and the
// tail's steps never enter a state (only states entering chunks are kept).
//
// Interface: plain C, one entry per input type, launched on the caller's
// stream; each returns cudaGetLastError() after its launches.  D must be a
// multiple of 16, at most 1024 (checked by the wrapper and here); the bf16
// entry also needs q, k and v on 16 bytes (the wrapper's copies are).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int TILE = 128;      // output tile edge
constexpr int HALF = TILE / 2;  // a thread's second row (column) group starts here
constexpr int KT = 16;         // depth of one staged slice (fp32 body)
constexpr int NT = 256;        // threads per block: a 16 x 16 grid, 8 x 8 outputs each (fp32)
constexpr int LD = TILE + 4;   // shared row stride (16-byte aligned rows)
constexpr float NEG = -1e30f;  // the stabilizer's start

static_assert(NT == 256 && TILE == 128, "the 16 x 16 thread grid covers a 128 x 128 tile");

// bf16 body
using bf16 = __nv_bfloat16;
constexpr int WV_SPLIT = 2;  // bf16 terms of w v
constexpr int C_SPLIT = 2;   // bf16 terms of the stored chunk states C^T
constexpr int KS = 32;      // depth of one staged slice: two k16 steps
constexpr int SA = KS + 8;  // bf16 row stride of a [128][KS] tile
constexpr int SB = TILE + 8;  // bf16 row stride of a [KS][128] tile
constexpr int A_ELEMS = TILE * SA;  // bf16 elements of a [128][KS] tile
constexpr int B_ELEMS = KS * SB;    // bf16 elements of a [KS][128] tile
constexpr int RING_STATE = 4, RING_OUT = 3;  // stages in flight + 1
// bytes of one stage: q and k rows; k and v rows; the outputs' larger phase
constexpr int STAGE_STATE = 2 * B_ELEMS * 2;
constexpr int OUT_C_BYTES = A_ELEMS * 2 + C_SPLIT * B_ELEMS * 2 + KS * 4;
constexpr int STAGE_OUT = OUT_C_BYTES;
constexpr size_t SMEM_STATE =
    static_cast<size_t>(RING_STATE) * STAGE_STATE + 2 * (WV_SPLIT * B_ELEMS * 2 + KS * 4);
constexpr size_t SMEM_OUT = static_cast<size_t>(RING_OUT) * STAGE_OUT;
static_assert(STAGE_OUT % 16 == 0 && STAGE_STATE % 16 == 0, "stages start on 16 bytes");
static_assert(SMEM_OUT >= 2 * KT * LD * sizeof(float) + 2 * TILE * KT * (sizeof(float) + 2),
              "the S V phase stages in the ring");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Row (column) of a thread's a-th accumulator row (column), a < 8.
__device__ __forceinline__ int owned(int t, int a) { return (a < 4 ? 4 * t : HALF + 4 * t) + (a & 3); }

// Sum over the 2 lanes that share one row (lanes 2 g, 2 g + 1 of a warp).
__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

size_t round_up(size_t n) { return (n + 63) / 64 * 64; }

// The workspace, in floats, carved in this order (each part 256-byte aligned).
struct Work {
  float* A;   // (BH, S)             in-chunk cumulative log-forget
  float* M;   // (BH, S)             stabilizer m_t
  float* MP;  // (BH, nc)            stabilizer entering each chunk
  float* NS;  // (BH, nc - 1, D)     normalizer entering chunks 1 .. nc - 1
  float* P;   // (BH, nc, c, c)      gated scores, lower-triangular tiles
  float* CT;  // (BH, nc - 1, D, D)  C^T entering chunks 1 .. nc - 1: fp32, or
              //                     (bf16) C_SPLIT bf16 planes (BH, nc - 1, C_SPLIT, D, D)
};

// Floats of one stored chunk state.
size_t ct_floats(size_t D, bool bf16_body) { return bf16_body ? C_SPLIT * D * D / 2 : D * D; }

size_t work_floats(size_t BH, size_t S, size_t D, size_t c, bool bf16_body) {
  const size_t nc = (S + c - 1) / c;
  return 2 * round_up(BH * S) + round_up(BH * nc) + round_up(BH * (nc - 1) * D) +
         round_up(BH * nc * c * c) +
         round_up(BH * (nc - 1) * ct_floats(D, bf16_body));
}

Work carve(float* base, size_t BH, size_t S, size_t D, size_t c) {
  const size_t nc = (S + c - 1) / c;
  Work w;
  w.A = base;
  w.M = w.A + round_up(BH * S);
  w.MP = w.M + round_up(BH * S);
  w.NS = w.MP + round_up(BH * nc);
  w.P = w.NS + round_up(BH * (nc - 1) * D);
  w.CT = w.P + round_up(BH * nc * c * c);
  return w;
}

// acc[a][b] += As[k][owned(ty, a)] * Bs[k][owned(tx, b)] over the KT staged rows;
// kSkipUpper leaves out a < 4, b >= 4 (rows 0..63 by columns 64..127), whose
// sums a diagonal score tile never uses.
template <bool kSkipUpper = false>
__device__ __forceinline__ void tile_fma(float (&acc)[8][8], float (*As)[LD], float (*Bs)[LD],
                                         int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < KT; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][HALF + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][HALF + 4 * tx]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (!(kSkipUpper && i < 4 && j >= 4)) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Store row r of an 8 x 8 accumulator at dst[owned(tx, 0 .. 7)] as two float4.
__device__ __forceinline__ void store_row(float* dst, const float (&r)[8], int tx, int col0,
                                         int D) {
  if (col0 + 4 * tx < D)
    *reinterpret_cast<float4*>(dst + 4 * tx) = make_float4(r[0], r[1], r[2], r[3]);
  if (col0 + HALF + 4 * tx < D)
    *reinterpret_cast<float4*>(dst + HALF + 4 * tx) = make_float4(r[4], r[5], r[6], r[7]);
}

// 1. gates: one warp per (batch, head).
__global__ void __launch_bounds__(32)
    gates_kernel(const float* __restrict__ log_f, const float* __restrict__ i_gate, Work w,
                 int S, int c, int nc) {
  const size_t bh = blockIdx.x;
  const int lane = threadIdx.x;
  const float* f = log_f + bh * S;
  const float* ig = i_gate + bh * S;
  float* A = w.A + bh * S;
  float* M = w.M + bh * S;
  float m_prev = NEG;
  for (int kc = 0; kc < nc; ++kc) {
    if (lane == 0) w.MP[bh * nc + kc] = m_prev;
    const int t0 = kc * c;
    const int len = min(c, S - t0);
    float a_carry = 0.f;
    float g_carry = -INFINITY;
    for (int r0 = 0; r0 < len; r0 += 32) {
      const int r = r0 + lane;
      const bool live = r < len;
      float a = live ? f[t0 + r] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, a, off);
        if (lane >= off) a = a + y;
      }
      a = a_carry + a;
      float g = live ? ig[t0 + r] - a : -INFINITY;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, g, off);
        if (lane >= off) g = fmaxf(g, y);
      }
      g = fmaxf(g_carry, g);
      if (live) {
        A[t0 + r] = a;
        M[t0 + r] = a + fmaxf(m_prev, g);
      }
      a_carry = __shfl_sync(0xffffffffu, a, 31);
      g_carry = __shfl_sync(0xffffffffu, g, 31);
    }
    m_prev = a_carry + fmaxf(m_prev, g_carry);  // m at the chunk's last step
  }
}

// 2. states: one block per (128 x 128 tile of C^T, batch, head), chunks in order.
__global__ void __launch_bounds__(NT, 2)
    state_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ i_gate, Work w, int S, int D, int c, int nc,
                 int n_dt) {
  __shared__ __align__(16) float Ks[KT][LD];  // k_j[e]
  __shared__ __align__(16) float Vs[KT][LD];  // w_j v_j[d]
  __shared__ float ws[KT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int e0 = (blockIdx.x / n_dt) * TILE, d0 = (blockIdx.x % n_dt) * TILE;
  const size_t bh = blockIdx.z;
  const size_t base = bh * S * D;
  const float* A = w.A + bh * S;
  const float* M = w.M + bh * S;
  const float* ig = i_gate + bh * S;
  // n rides with the first d-tile: thread (nr, nh) sums every other step of
  // each slice into n[e0 + nr]
  const bool keeps_n = d0 == 0;
  const int nr = tid >> 1, nh = tid & 1;
  float C[8][8] = {};  // C^T[e0 + owned(ty, a)][d0 + owned(tx, b)]
  float n = 0.f;       // n[e0 + nr]
  for (int kc = 0; kc + 1 < nc; ++kc) {  // chunks 0 .. nc - 2 are full
    const int t0 = kc * c;
    const float A_c = A[t0 + c - 1];
    const float m_new = M[t0 + c - 1];
    const float decay_C = expf(w.MP[bh * nc + kc] + A_c - m_new);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) C[a][b] = __fmul_rn(decay_C, C[a][b]);
    float nk = 0.f;
    for (int j0 = 0; j0 < c; j0 += KT) {
      if (tid < KT) {
        const int j = t0 + j0 + tid;
        ws[tid] = j0 + tid < c ? expf(A_c - A[j] + ig[j] - m_new) : 0.f;
      }
      __syncthreads();
      for (int idx = tid; idx < KT * TILE; idx += NT) {
        const int j = idx / TILE, col = idx % TILE;
        const bool live = j0 + j < c;
        const size_t row = base + static_cast<size_t>(t0 + j0 + j) * D;
        Ks[j][col] = live && e0 + col < D ? k[row + e0 + col] : 0.f;
        Vs[j][col] = live && d0 + col < D ? __fmul_rn(ws[j], v[row + d0 + col]) : 0.f;
      }
      __syncthreads();
      tile_fma(C, Ks, Vs, ty, tx);
      if (keeps_n)
        for (int j = nh; j < KT; j += 2) nk = fmaf(ws[j], Ks[j][nr], nk);
      __syncthreads();
    }
    // the state entering chunk kc + 1
    float* CT = w.CT + (bh * (nc - 1) + kc) * D * D;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int e = e0 + owned(ty, a);
      if (e < D) store_row(CT + static_cast<size_t>(e) * D + d0, C[a], tx, d0, D);
    }
    if (keeps_n) {
      n = __fadd_rn(__fmul_rn(decay_C, n), pair_sum(nk));
      if (nh == 0 && e0 + nr < D) w.NS[(bh * (nc - 1) + kc) * D + e0 + nr] = n;
    }
  }
}

// 3. scores: one block per (tile pair jt <= it, chunk, batch, head); both
// bodies (bf16 inputs widened on load).
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    score_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const float* __restrict__ i_gate, Work w, int S, int D, int c, int nc,
                 float scale) {
  __shared__ __align__(16) float Qs[KT][LD];  // q~_i[e], e-major
  __shared__ __align__(16) float Ks[KT][LD];  // k_j[e], e-major
  int it = 0, jt = blockIdx.x;                // the lower-triangular pair of blockIdx.x
  while (jt > it) {
    jt -= it + 1;
    ++it;
  }
  const int kc = blockIdx.y;
  const size_t bh = blockIdx.z;
  const int t0 = kc * c;
  const int len = min(c, S - t0);
  const int i0 = it * TILE, j0 = jt * TILE;
  if (i0 >= len) return;  // rows past a ragged tail: never read
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t base = bh * S * D;
  float acc[8][8] = {};
  if constexpr (sizeof(T) == 2) {
    // bf16 (rows on 16 bytes): the next slice's q and k rows are copied by
    // cp.async into a second raw buffer while this one's FMAs run; thread
    // tid widens 8 columns (e8 ..) of row r of each into the tiles.  The
    // products and sums are those of the loop below.
    __shared__ __align__(16) T raw[2][2][TILE][KT];  // [buffer][q, k][row][e]
    const int r = tid >> 1, e8 = (tid & 1) * 8;
    const T* qr = q + base + static_cast<size_t>(t0 + i0 + r) * D + e8;
    const T* kr = k + base + static_cast<size_t>(t0 + j0 + r) * D + e8;
    const bool q_live = i0 + r < len, k_live = j0 + r < len;
    auto issue = [&](int e0, int buf) {
      cp_async16(&raw[buf][0][r][e8], q_live ? qr + e0 : q, q_live);
      cp_async16(&raw[buf][1][r][e8], k_live ? kr + e0 : k, k_live);
      cp_async_commit();
    };
    issue(0, 0);
    for (int e0 = 0, buf = 0; e0 < D; e0 += KT, buf ^= 1) {
      if (e0 + KT < D) issue(e0 + KT, buf ^ 1);
      else cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // this slice landed; every thread is done with the last
      const uint4 qv = *reinterpret_cast<const uint4*>(&raw[buf][0][r][e8]);
      const uint4 kv = *reinterpret_cast<const uint4*>(&raw[buf][1][r][e8]);
      const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w}, kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qw[x]));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kw[x]));
        Qs[e8 + 2 * x][r] = q_live ? __fmul_rn(a.x, scale) : 0.f;
        Qs[e8 + 2 * x + 1][r] = q_live ? __fmul_rn(a.y, scale) : 0.f;
        Ks[e8 + 2 * x][r] = b.x;
        Ks[e8 + 2 * x + 1][r] = b.y;
      }
      __syncthreads();
      if (it == jt) tile_fma<true>(acc, Qs, Ks, ty, tx);
      else tile_fma(acc, Qs, Ks, ty, tx);
    }
  } else {
    for (int e0 = 0; e0 < D; e0 += KT) {
      for (int idx = tid; idx < KT * TILE; idx += NT) {
        const int row = idx / KT, e = idx % KT;
        const bool col_live = e0 + e < D;
        Qs[e][row] = col_live && i0 + row < len
                         ? __fmul_rn(to_float(q[base + static_cast<size_t>(t0 + i0 + row) * D + e0 + e]),
                                     scale)
                         : 0.f;
        Ks[e][row] = col_live && j0 + row < len
                         ? to_float(k[base + static_cast<size_t>(t0 + j0 + row) * D + e0 + e])
                         : 0.f;
      }
      __syncthreads();
      tile_fma(acc, Qs, Ks, ty, tx);
      __syncthreads();
    }
  }
  const float* A = w.A + bh * S + t0;
  const float* M = w.M + bh * S + t0;
  const float* ig = i_gate + bh * S + t0;
  float* P = w.P + (bh * nc + kc) * static_cast<size_t>(c) * c;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + owned(ty, a);
    if (i >= c) continue;
    const bool row_live = i < len;
    const float A_i = row_live ? A[i] : 0.f;
    const float m_i = row_live ? M[i] : 0.f;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = j0 + owned(tx, b);
      if (j >= c) continue;
      float val = 0.f;
      if (row_live && j <= i) {
        const float logw = A_i - A[j] + ig[j] - m_i;  // ((A_i - A_j) + i_j) - m_i <= 0
        val = __fmul_rn(acc[a][b], expf(logw));
      }
      P[static_cast<size_t>(i) * c + j] = val;
    }
  }
}

// 4. outputs: one block per (128 columns, 128 rows, chunk, batch, head).
__global__ void __launch_bounds__(NT, 2)
    out_kernel(const float* __restrict__ q, const float* __restrict__ v, Work w,
               float* __restrict__ out, int S, int D, int c, int nc, int nt, float scale) {
  __shared__ __align__(16) float As[KT][LD];  // q~^T (e-major), then S^T (j-major)
  __shared__ __align__(16) float Bs[KT][LD];  // C^T[e][d], then v_j[d]
  __shared__ float ns[KT];
  __shared__ float dq_s[TILE], den_s[TILE], nq_s[TILE];
  const int d0 = (blockIdx.x / nt) * TILE, i0 = (blockIdx.x % nt) * TILE;
  const int kc = blockIdx.y;
  const size_t bh = blockIdx.z;
  const int t0 = kc * c;
  const int len = min(c, S - t0);
  if (i0 >= len) return;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t base = bh * S * D;
  const float* A = w.A + bh * S + t0;
  const float* M = w.M + bh * S + t0;
  const float m_prev = w.MP[bh * nc + kc];
  if (tid < TILE) {  // decay_q of each row: 0 in the first chunk
    const int i = i0 + tid;
    dq_s[tid] = i < len ? expf(m_prev + A[i] - M[i]) : 0.f;
  }
  float acc[8][8] = {};
  // row sums of S and n . q~: thread (nr, nh) sums every other term of row i0 + nr
  const int nr = tid >> 1, nh = tid & 1;
  float den = 0.f, nq = 0.f;

  // inter-chunk: decay_q C q~ and n . q~ from the state entering this chunk
  if (kc > 0) {
    const float* CT = w.CT + (bh * (nc - 1) + kc - 1) * D * D;
    const float* NS = w.NS + (bh * (nc - 1) + kc - 1) * D;
    for (int e0 = 0; e0 < D; e0 += KT) {
      for (int idx = tid; idx < KT * TILE; idx += NT) {
        const int row = idx / KT, e = idx % KT;
        As[e][row] = i0 + row < len && e0 + e < D
                         ? __fmul_rn(q[base + static_cast<size_t>(t0 + i0 + row) * D + e0 + e],
                                     scale)
                         : 0.f;
        const int ee = idx / TILE, col = idx % TILE;
        Bs[ee][col] = e0 + ee < D && d0 + col < D
                          ? CT[static_cast<size_t>(e0 + ee) * D + d0 + col]
                          : 0.f;
      }
      if (tid < KT) ns[tid] = e0 + tid < D ? NS[e0 + tid] : 0.f;
      __syncthreads();
      tile_fma(acc, As, Bs, ty, tx);
      for (int e = nh; e < KT; e += 2) nq = fmaf(As[e][nr], ns[e], nq);
      __syncthreads();
    }
  }
  __syncthreads();  // dq_s
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float dq = dq_s[owned(ty, a)];
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = __fmul_rn(dq, acc[a][b]);
  }

  // intra-chunk: S V over keys j < min(len, i0 + 128), added on
  const float* P = w.P + (bh * nc + kc) * static_cast<size_t>(c) * c;
  const int j_end = min(len, i0 + TILE);
  for (int j0 = 0; j0 < j_end; j0 += KT) {
    for (int idx = tid; idx < KT * TILE; idx += NT) {
      const int row = idx / KT, j = idx % KT;
      As[j][row] = i0 + row < len && j0 + j < j_end
                       ? P[static_cast<size_t>(i0 + row) * c + j0 + j]
                       : 0.f;
      const int jj = idx / TILE, col = idx % TILE;
      Bs[jj][col] = j0 + jj < j_end && d0 + col < D
                        ? v[base + static_cast<size_t>(t0 + j0 + jj) * D + d0 + col]
                        : 0.f;
    }
    __syncthreads();
    tile_fma(acc, As, Bs, ty, tx);
    for (int j = nh; j < KT; j += 2) den = den + As[j][nr];
    __syncthreads();
  }
  den = pair_sum(den);
  nq = pair_sum(nq);
  if (nh == 0) {
    den_s[nr] = den;
    nq_s[nr] = nq;
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int r = owned(ty, a);
    const int i = i0 + r;
    if (i >= len) continue;
    const float dn = __fadd_rn(den_s[r], __fmul_rn(dq_s[r], nq_s[r]));
    const float lim = fmaxf(fabsf(dn), expf(-M[i]));
    float h[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) h[b] = __fdiv_rn(acc[a][b], lim);
    store_row(out + base + static_cast<size_t>(t0 + i) * D + d0, h, tx, d0, D);
  }
}

// --- the bf16 body: tensor cores --------------------------------------------

// x = t_0 + t_1 + ... to ~8 N bits, for a pair (x0, x1) packed as bf16x2 per
// term: t_0 = bf16(x), t_1 = bf16(x - t_0), ... (x - bf16(x) is exact in fp32)
template <int N>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t (&t)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);  // x0 in the low half
    t[n] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Rows [0, NR) x columns [0, NC) of a row-major bf16 matrix (row stride ld
// elements, src at its (0, 0)) into dst (row stride st) by 16-byte cp.async;
// rows >= rows and columns >= cols arrive as zeros.  NC, cols multiples of 8.
template <int NR, int NC>
__device__ __forceinline__ void stage_bf16(bf16* dst, int st, const bf16* src, size_t ld,
                                           int rows, int cols) {
  constexpr int CH = NC / 8;
  for (int x = threadIdx.x; x < NR * CH; x += NT) {
    const int r = x / CH, c8 = (x % CH) * 8;
    const bool valid = r < rows && c8 < cols;
    cp_async16(dst + r * st + c8, valid ? src + r * ld + c8 : src, valid);
  }
}
// A warp's place in a block's 128 x 128 tile: rows m0 .. m0 + 31 (two m16
// fragments), columns n0 .. n0 + 63 (eight n8 fragments); lane roles of
// ldmatrix (mat, mrow) and of the accumulators (g, t).
struct Lane {
  int m0, n0, mat, mrow, g, t;
  __device__ Lane() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    m0 = (warp >> 1) * 32;
    n0 = (warp & 1) * 64;
    mat = lane >> 3;
    mrow = lane & 7;
    g = lane >> 2;
    t = lane & 3;
  }
};

// A fragments of the warp's two m16 tiles at depth k0, from a tile stored
// [m][k] (row stride st) ...
__device__ __forceinline__ void a_rows(uint32_t (&a)[2][4], const bf16* s, int st, const Lane& L,
                                       int k0) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldsm_x4(a[mi], s + (L.m0 + 16 * mi + (L.mat & 1) * 8 + L.mrow) * st + k0 + (L.mat >> 1) * 8);
}
// ... or stored [k][m]
__device__ __forceinline__ void a_cols(uint32_t (&a)[2][4], const bf16* s, int st, const Lane& L,
                                       int k0) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldsm_x4_trans(a[mi],
                  s + (k0 + (L.mat >> 1) * 8 + L.mrow) * st + L.m0 + 16 * mi + (L.mat & 1) * 8);
}
// B fragments of the n8 tiles n0 + 16 np + {0, 8} (b[0..1], b[2..3]) at depth
// k0, from a tile stored [k][n] (row stride st)
__device__ __forceinline__ void b_cols(uint32_t (&b)[4], const bf16* s, int st, const Lane& L,
                                       int np, int k0) {
  ldsm_x4_trans(b, s + (k0 + (L.mat & 1) * 8 + L.mrow) * st + L.n0 + 16 * np + (L.mat >> 1) * 8);
}

// acc += A (sum over the NB terms of B) over one 32-deep slice: A one bf16
// tile, stored [k][m] (a_t) or [m][k]; each B term a tile stored [k][n].
// The fragments of the next step (one n16 column pair of B; A at each k16
// step) are read from shared memory before this step's mma are issued.
template <int NB, bool a_t>
__device__ __forceinline__ void mma_slice(float (&acc)[2][8][4], const bf16* As, int sta,
                                          const bf16* const* Bs, int stb, const Lane& L) {
  uint32_t a[2][2][4], b[2][NB][4];
  auto load_a = [&](uint32_t(&f)[2][4], int k0) {
    if constexpr (a_t) a_cols(f, As, sta, L, k0);
    else a_rows(f, As, sta, L, k0);
  };
  auto load_b = [&](uint32_t(&f)[NB][4], int np, int k0) {
#pragma unroll
    for (int y = 0; y < NB; ++y) b_cols(f[y], Bs[y], stb, L, np, k0);
  };
  constexpr int STEPS = (KS / 16) * 4;  // (k16 step, n16 column pair)
  load_a(a[0], 0);
  load_b(b[0], 0, 0);
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int ks = st / 4, np = st % 4;
    if (st + 1 < STEPS) {
      if (np == 3) load_a(a[(ks + 1) & 1], 16 * (ks + 1));
      load_b(b[(st + 1) & 1], (st + 1) % 4, 16 * ((st + 1) / 4));
    }
    // the products of two terms into one accumulator are 4 mma apart
#pragma unroll
    for (int y = 0; y < NB; ++y)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mma_bf16(acc[mi][2 * np + h], a[ks & 1][mi], b[st & 1][y][2 * h],
                   b[st & 1][y][2 * h + 1]);
  }
}

// w_j v_j[d] of one staged slice of v rows (row r, 16 columns a thread) into
// WV_SPLIT bf16 terms at wv (planes B_ELEMS apart), w_j into ws[r]; rows j >= c
// (past the chunk) get w = 0.
__device__ __forceinline__ void split_wv(bf16* wv, float* ws, const bf16* vs, const float* A,
                                         const float* ig, int j0, int c, float A_c,
                                         float m_new) {
  const int tid = threadIdx.x, r = tid >> 3, c16 = (tid & 7) * 16, j = j0 + r;
  const float wj = j < c ? expf(A_c - A[j] + ig[j] - m_new) : 0.f;
  if ((tid & 7) == 0) ws[r] = wj;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const int at = r * SB + c16 + 8 * part;
    const uint4 raw = *reinterpret_cast<const uint4*>(vs + at);
    const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t tv[WV_SPLIT][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 x = unpack(in[p]);
      uint32_t terms[WV_SPLIT];
      split_pair<WV_SPLIT>(__fmul_rn(wj, x.x), __fmul_rn(wj, x.y), terms);
#pragma unroll
      for (int y = 0; y < WV_SPLIT; ++y) tv[y][p] = terms[y];
    }
#pragma unroll
    for (int y = 0; y < WV_SPLIT; ++y)
      *reinterpret_cast<uint4*>(wv + y * B_ELEMS + at) =
          make_uint4(tv[y][0], tv[y][1], tv[y][2], tv[y][3]);
  }
}

// 2. states (bf16): one block per (128 x 128 tile of C^T, batch, head), the
// chunks' slices in order through one ring.  The terms of w v are formed one
// slice ahead into a second buffer, so one barrier a slice separates both.
__global__ void __launch_bounds__(NT, 2)
    state_mma_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const float* __restrict__ i_gate, Work w, int S, int D, int c, int nc,
                     int n_dt) {
  extern __shared__ float4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4);   // [RING_STATE][k rows, v rows]
  bf16* wv = ring + RING_STATE * 2 * B_ELEMS;     // [2][WV_SPLIT][KS][SB]: terms of w v
  float* ws = reinterpret_cast<float*>(wv + 2 * WV_SPLIT * B_ELEMS);  // [2][KS]: w_j
  const int tid = threadIdx.x;
  const Lane L;
  const int e0 = (blockIdx.x / n_dt) * TILE, d0 = (blockIdx.x % n_dt) * TILE;
  const size_t bh = blockIdx.z;
  const size_t base = bh * S * D;
  const float* A = w.A + bh * S;
  const float* M = w.M + bh * S;
  const float* ig = i_gate + bh * S;
  const int nj = (c + KS - 1) / KS;  // slices a chunk
  const int G = (nc - 1) * nj;       // chunks 0 .. nc - 2 are full

  auto issue = [&](int g) {
    if (g < G) {
      const int j0 = (g % nj) * KS;
      const size_t row = base + static_cast<size_t>((g / nj) * c + j0) * D;
      bf16* st = ring + (g % RING_STATE) * 2 * B_ELEMS;
      stage_bf16<KS, TILE>(st, SB, k + row + e0, D, c - j0, D - e0);
      stage_bf16<KS, TILE>(st + B_ELEMS, SB, v + row + d0, D, c - j0, D - d0);
    }
    cp_async_commit();
  };
  // slice g's terms of w v into buffer g % 2
  auto split = [&](int g) {
    const int t0 = (g / nj) * c;
    split_wv(wv + (g & 1) * WV_SPLIT * B_ELEMS, ws + (g & 1) * KS,
             ring + (g % RING_STATE) * 2 * B_ELEMS + B_ELEMS, A + t0, ig + t0, (g % nj) * KS,
             c, A[t0 + c - 1], M[t0 + c - 1]);
  };
  for (int g = 0; g < RING_STATE - 1; ++g) issue(g);
  cp_async_wait<RING_STATE - 2>();
  __syncthreads();
  split(0);

  // n rides with the first d-tile: thread (nr, nh) sums every other step of
  // each slice into n[e0 + nr]
  const bool keeps_n = d0 == 0;
  const int nr = tid >> 1, nh = tid & 1;
  float acc[2][8][4] = {};  // C^T[e0 + rows][d0 + columns]
  float n = 0.f, nk = 0.f, decay_C = 0.f;
  for (int g = 0; g < G; ++g) {
    const int kc = g / nj, s = g % nj;
    if (s == 0) {
      const int t0 = kc * c;
      decay_C = expf(w.MP[bh * nc + kc] + A[t0 + c - 1] - M[t0 + c - 1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[mi][ni][x] = __fmul_rn(decay_C, acc[mi][ni][x]);
      nk = 0.f;
    }
    cp_async_wait<RING_STATE - 3>();
    // slice g + 1 landed and slice g's terms are in; every warp is done with
    // slice g - 1 (its ring slot and its buffer of terms)
    __syncthreads();
    issue(g + RING_STATE - 1);
    const bf16* ks = ring + (g % RING_STATE) * 2 * B_ELEMS;
    const bf16* b_src[WV_SPLIT];
#pragma unroll
    for (int y = 0; y < WV_SPLIT; ++y) b_src[y] = wv + ((g & 1) * WV_SPLIT + y) * B_ELEMS;
    mma_slice<WV_SPLIT, true>(acc, ks, SB, b_src, SB, L);
    if (g + 1 < G) split(g + 1);
    if (keeps_n) {
      const float* wj = ws + (g & 1) * KS;
      for (int j = nh; j < KS; j += 2) nk = fmaf(wj[j], __bfloat162float(ks[j * SB + nr]), nk);
    }
    if (s == nj - 1) {  // the state entering chunk kc + 1, as C_SPLIT bf16 planes
      bf16* CT = reinterpret_cast<bf16*>(w.CT) +
                 (bh * (nc - 1) + kc) * static_cast<size_t>(C_SPLIT) * D * D;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = e0 + L.m0 + 16 * mi + L.g + 8 * h;
          if (e >= D) continue;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int d = d0 + L.n0 + 8 * ni + 2 * L.t;
            if (d >= D) continue;
            uint32_t terms[C_SPLIT];
            split_pair<C_SPLIT>(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1], terms);
#pragma unroll
            for (int y = 0; y < C_SPLIT; ++y)
              *reinterpret_cast<uint32_t*>(CT + y * static_cast<size_t>(D) * D +
                                           static_cast<size_t>(e) * D + d) = terms[y];
          }
        }
      if (keeps_n) {
        n = __fadd_rn(__fmul_rn(decay_C, n), pair_sum(nk));
        if (nh == 0 && e0 + nr < D) w.NS[(bh * (nc - 1) + kc) * D + e0 + nr] = n;
      }
    }
  }
}

// 4. outputs (bf16): one block per (128 columns, 128 rows, chunk, batch,
// head).  C q on the tensor cores (chunks after the first), through a ring;
// then S V, the row sums of S and the division in fp32 FMAs on the CUDA
// cores, each output's sum in the order of the fp32 grid (out_kernel):
// decay_q C q~ first, then the keys in ascending order.
__global__ void __launch_bounds__(NT, 2)
    out_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v, Work w,
                   float* __restrict__ out, int S, int D, int c, int nc, int nt, float scale) {
  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);  // [RING_OUT][STAGE_OUT]
  __shared__ float dq_s[TILE], den_s[TILE], nq_s[TILE];
  const int d0 = (blockIdx.x / nt) * TILE, i0 = (blockIdx.x % nt) * TILE;
  const int kc = blockIdx.y;
  const size_t bh = blockIdx.z;
  const int t0 = kc * c;
  const int len = min(c, S - t0);
  if (i0 >= len) return;
  const int tid = threadIdx.x;
  const Lane L;
  const size_t base = bh * S * D;
  const float* A = w.A + bh * S + t0;
  const float* M = w.M + bh * S + t0;
  const float m_prev = w.MP[bh * nc + kc];
  const int ne = kc > 0 ? (D + KS - 1) / KS : 0;  // slices of C q
  const int rows = len - i0, cols = D - d0;       // rows of q, columns of C here
  const bf16* qb = q + base + static_cast<size_t>(t0 + i0) * D;
  // the state entering this chunk (none for the first), columns d0 ..
  const size_t prev = kc > 0 ? bh * (nc - 1) + kc - 1 : 0;
  const bf16* CT = reinterpret_cast<const bf16*>(w.CT) + prev * C_SPLIT * D * D + d0;
  const float* NS = w.NS + prev * D;

  // a stage: [q rows 128 x SA][C_SPLIT planes KS x SB][n: KS floats]
  auto issue = [&](int g) {
    if (g < ne) {
      const int e0 = g * KS;
      bf16* qs = reinterpret_cast<bf16*>(ring + (g % RING_OUT) * STAGE_OUT);
      stage_bf16<TILE, KS>(qs, SA, qb + e0, D, rows, D - e0);
#pragma unroll
      for (int y = 0; y < C_SPLIT; ++y)
        stage_bf16<KS, TILE>(qs + A_ELEMS + y * B_ELEMS, SB,
                             CT + (y * static_cast<size_t>(D) + e0) * D, D, D - e0, cols);
      float* ns = reinterpret_cast<float*>(qs + A_ELEMS + C_SPLIT * B_ELEMS);
      if (tid < KS / 4) cp_async16(ns + 4 * tid, NS + e0 + 4 * tid, e0 + 4 * tid < D);
    }
    cp_async_commit();
  };
  for (int g = 0; g < RING_OUT - 1; ++g) issue(g);

  if (tid < TILE) {  // decay_q of each row: 0 in the first chunk
    const int i = i0 + tid;
    dq_s[tid] = i < len ? expf(m_prev + A[i] - M[i]) : 0.f;
  }
  float acc[2][8][4] = {};
  // row sums of S and n . q: thread (nr, nh) sums every other term of row i0 + nr
  const int nr = tid >> 1, nh = tid & 1;
  float den = 0.f, nq = 0.f;
  for (int g = 0; g < ne; ++g) {  // inter-chunk: C q and n . q
    cp_async_wait<RING_OUT - 2>();
    __syncthreads();  // slice g landed; every warp is done with slice g - 1
    issue(g + RING_OUT - 1);
    const bf16* qs = reinterpret_cast<const bf16*>(ring + (g % RING_OUT) * STAGE_OUT);
    const bf16* b_src[C_SPLIT];
#pragma unroll
    for (int y = 0; y < C_SPLIT; ++y) b_src[y] = qs + A_ELEMS + y * B_ELEMS;
    mma_slice<C_SPLIT, false>(acc, qs, SA, b_src, SB, L);
    const float* ns = reinterpret_cast<const float*>(qs + A_ELEMS + C_SPLIT * B_ELEMS);
    for (int e = nh; e < KS; e += 2) nq = fmaf(__bfloat162float(qs[nr * SA + e]), ns[e], nq);
  }
  __syncthreads();  // dq_s; every warp is done with the ring
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // decay_q D^-1/2 C q
      const float dq = dq_s[L.m0 + 16 * mi + L.g + 8 * h];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int x = 0; x < 2; ++x)
          acc[mi][ni][2 * h + x] = __fmul_rn(dq, __fmul_rn(acc[mi][ni][2 * h + x], scale));
    }

  // intra-chunk: S V over keys j < min(len, i0 + 128), 16 at a time, in
  // fp32.  The next slice of S's rows and v's keys is copied by cp.async
  // into a second raw buffer while this one's FMAs run; thread tid widens 8
  // keys (j8 ..) of row pr of S and 8 columns (v8 ..) of key vj of v into the
  // tiles.
  float(*Ps)[LD] = reinterpret_cast<float(*)[LD]>(ring);  // S^T (j-major)
  float(*Vs)[LD] = Ps + KT;                                // v_j[d]
  float(*rawP)[TILE][KT] = reinterpret_cast<float(*)[TILE][KT]>(Vs + KT);  // [2][row][j]
  bf16(*rawV)[KT][TILE] = reinterpret_cast<bf16(*)[KT][TILE]>(rawP + 2);  // [2][j][d]
  const int j_end = min(len, i0 + TILE);
  const int pr = tid >> 1, j8 = (tid & 1) * 8, vj = tid >> 4, v8 = (tid & 15) * 8;
  const bool p_live = i0 + pr < len, v_cols = d0 + v8 < D, p_vec = c % 4 == 0;
  const float* Prow = w.P + (bh * nc + kc) * static_cast<size_t>(c) * c +
                      static_cast<size_t>(i0 + (p_live ? pr : 0)) * c + j8;
  const bf16* vcol = v + base + static_cast<size_t>(t0) * D + d0 + v8;
  auto issue_sv = [&](int j0, int buf) {
    float* dst = &rawP[buf][pr][j8];
    if (p_vec) {
#pragma unroll
      for (int x = 0; x < 8; x += 4) {
        const bool ok = p_live && j0 + j8 + x < j_end;
        cp_async16(dst + x, ok ? Prow + j0 + x : w.P, ok);
      }
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const bool ok = p_live && j0 + j8 + x < j_end;
        cp_async4(dst + x, ok ? Prow + j0 + x : w.P, ok);
      }
    }
    const bool ok = j0 + vj < j_end && v_cols;
    cp_async16(&rawV[buf][vj][v8], ok ? vcol + static_cast<size_t>(j0 + vj) * D : v, ok);
    cp_async_commit();
  };
  issue_sv(0, 0);
  for (int j0 = 0, buf = 0; j0 < j_end; j0 += KT, buf ^= 1) {
    if (j0 + KT < j_end) issue_sv(j0 + KT, buf ^ 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this slice landed; every thread is done with the last
    {
      const float4 a = *reinterpret_cast<const float4*>(&rawP[buf][pr][j8]);
      const float4 b = *reinterpret_cast<const float4*>(&rawP[buf][pr][j8 + 4]);
      const float pv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int x = 0; x < 8; ++x) Ps[j8 + x][pr] = pv[x];
      const uint4 vv = *reinterpret_cast<const uint4*>(&rawV[buf][vj][v8]);
      const float2 e = unpack(vv.x), f = unpack(vv.y), g = unpack(vv.z), h = unpack(vv.w);
      *reinterpret_cast<float4*>(&Vs[vj][v8]) = make_float4(e.x, e.y, f.x, f.y);
      *reinterpret_cast<float4*>(&Vs[vj][v8 + 4]) = make_float4(g.x, g.y, h.x, h.y);
    }
    __syncthreads();
    // keys past the warp's last row hold S = 0: skipping them leaves every
    // sum as it is
    const int kk_end = min(KT, i0 + L.m0 + 32 - j0);
#pragma unroll 4
    for (int kk = 0; kk < kk_end; ++kk) {
      float sr[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) sr[mi][h] = Ps[kk][L.m0 + 16 * mi + L.g + 8 * h];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const float2 b = *reinterpret_cast<const float2*>(&Vs[kk][L.n0 + 8 * ni + 2 * L.t]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[mi][ni][2 * h] = fmaf(sr[mi][h], b.x, acc[mi][ni][2 * h]);
            acc[mi][ni][2 * h + 1] = fmaf(sr[mi][h], b.y, acc[mi][ni][2 * h + 1]);
          }
      }
    }
    for (int j = nh; j < KT; j += 2) den = den + Ps[j][nr];
  }
  den = pair_sum(den);
  nq = pair_sum(nq);
  if (nh == 0) {
    den_s[nr] = den;
    nq_s[nr] = __fmul_rn(nq, scale);
  }
  __syncthreads();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = L.m0 + 16 * mi + L.g + 8 * h;
      const int i = i0 + r;
      if (i >= len) continue;
      const float dn = __fadd_rn(den_s[r], __fmul_rn(dq_s[r], nq_s[r]));
      const float lim = fmaxf(fabsf(dn), expf(-M[i]));
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int d = d0 + L.n0 + 8 * ni + 2 * L.t;
        if (d < D)
          *reinterpret_cast<float2*>(out + base + static_cast<size_t>(t0 + i) * D + d) =
              make_float2(__fdiv_rn(acc[mi][ni][2 * h], lim),
                          __fdiv_rn(acc[mi][ni][2 * h + 1], lim));
      }
    }
}

// fp32: the CUDA-core grids
int launch_f32(const float* q, const float* k, const float* v, const float* ig, float* o,
               const Work& w, int BH, int S, int D, int c, int nc, float scale, cudaStream_t st) {
  const int n_dt = (D + TILE - 1) / TILE;
  const int nt = (c + TILE - 1) / TILE;
  if (nc > 1)
    state_kernel<<<dim3(n_dt * n_dt, 1, BH), NT, 0, st>>>(k, v, ig, w, S, D, c, nc, n_dt);
  score_kernel<float><<<dim3(nt * (nt + 1) / 2, nc, BH), NT, 0, st>>>(q, k, ig, w, S, D, c, nc,
                                                                     scale);
  out_kernel<<<dim3(n_dt * nt, nc, BH), NT, 0, st>>>(q, v, w, o, S, D, c, nc, nt, scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the tensor-core states grid, the scores grid, the outputs grid
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* ig, float* o,
                const Work& w, int BH, int S, int D, int c, int nc, float scale, cudaStream_t st) {
  if (!aligned16(q, k, v)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_dt = (D + TILE - 1) / TILE;
  const int nt = (c + TILE - 1) / TILE;
  cudaError_t err = cudaFuncSetAttribute(
      state_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_STATE));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(out_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_OUT));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nc > 1)
    state_mma_kernel<<<dim3(n_dt * n_dt, 1, BH), NT, SMEM_STATE, st>>>(k, v, ig, w, S, D, c, nc,
                                                                      n_dt);
  score_kernel<bf16><<<dim3(nt * (nt + 1) / 2, nc, BH), NT, 0, st>>>(q, k, ig, w, S, D, c, nc,
                                                                    scale);
  out_mma_kernel<<<dim3(n_dt * nt, nc, BH), NT, SMEM_OUT, st>>>(q, v, w, o, S, D, c, nc, nt,
                                                               scale);
  return static_cast<int>(cudaGetLastError());
}

bool takes(int B, int H, int S, int D, int chunk) {
  if (B < 1 || H < 1 || S < 1 || chunk < 1 || D < 16 || D > 1024 || D % 16 != 0 ||
      static_cast<long long>(B) * H > 65535)
    return false;
  const int c = min(chunk, S);
  return (S + c - 1) / c <= 65535;
}

}  // namespace

extern "C" {

// Floats of workspace one call needs (chunk as the call gives it), for the
// fp32 (is_bf16 == 0) or the bf16 entry.
long long mlstm_workspace_floats(int B, int H, int S, int D, int chunk, int is_bf16) {
  if (B < 1 || H < 1 || S < 1 || D < 1 || chunk < 1) return 0;
  const int c = chunk < S ? chunk : S;
  return static_cast<long long>(work_floats(static_cast<size_t>(B) * H, S, D, c, is_bf16 != 0));
}

// The body an entry runs: 1 the tensor-core body (is_bf16 != 0), 0 the
// CUDA-core one; the bf16 terms of each split operand (w v, the stored
// states C) into terms[0 .. 1], 0 for the CUDA-core body.
int mlstm_body(int is_bf16, int* terms) {
  terms[0] = is_bf16 ? WV_SPLIT : 0;
  terms[1] = is_bf16 ? C_SPLIT : 0;
  return is_bf16 ? 1 : 0;
}

int mlstm_f32(const void* q, const void* k, const void* v, const void* log_f,
              const void* i_gate, void* out, void* work, int B, int H, int S, int D, int chunk,
              float scale, void* stream) {
  cudaGetLastError();
  if (!takes(B, H, S, D, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const int c = min(chunk, S), nc = (S + c - 1) / c, BH = B * H;
  const Work w = carve(static_cast<float*>(work), BH, S, D, c);
  auto st = static_cast<cudaStream_t>(stream);
  gates_kernel<<<BH, 32, 0, st>>>(static_cast<const float*>(log_f),
                                  static_cast<const float*>(i_gate), w, S, c, nc);
  return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<const float*>(i_gate),
                    static_cast<float*>(out), w, BH, S, D, c, nc, scale, st);
}

int mlstm_bf16(const void* q, const void* k, const void* v, const void* log_f,
               const void* i_gate, void* out, void* work, int B, int H, int S, int D, int chunk,
               float scale, void* stream) {
  cudaGetLastError();
  if (!takes(B, H, S, D, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const int c = min(chunk, S), nc = (S + c - 1) / c, BH = B * H;
  const Work w = carve(static_cast<float*>(work), BH, S, D, c);
  auto st = static_cast<cudaStream_t>(stream);
  gates_kernel<<<BH, 32, 0, st>>>(static_cast<const float*>(log_f),
                                  static_cast<const float*>(i_gate), w, S, c, nc);
  return launch_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const float*>(i_gate),
                     static_cast<float*>(out), w, BH, S, D, c, nc, scale, st);
}

}  // extern "C"
