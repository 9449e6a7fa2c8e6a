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
// per byte.  All math is fp32 on the CUDA cores (bf16 inputs widened on load,
// as the TPU kernel widens them), so the floor is the 67 TFLOP/s fp32 rate;
// tensor cores (wgmma) are later work.
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
// Every product is a 128 x 128 tile from 16-deep staged slices: thread
// (ty, tx) of a 16 x 16 grid owns rows {4 ty, 64 + 4 ty} + 0..3 and columns
// {4 tx, 64 + 4 tx} + 0..3, one accumulator of 8 x 8, and reads its rows and
// columns as four float4 from shared memory per step: 64 FMAs for 4 loads.
// Each of these grids is held to 128 registers a thread, so two blocks (16
// warps) share an SM.  Nothing overlaps a slice's global loads with the
// previous slice's products yet (no prefetch, no cp.async or TMA).
// The workspace holds 4 D^2 (S / c - 1) + 4 S c + ~12 S bytes per (batch,
// head): 1.9 GiB at (8, 4, 4096, 1024), c = 256.
//
// Numerics: m starts at -1e30, so every decay of the first chunk is exactly
// 0; every other exponent but -m_i is <= 0 by construction, and e^{-m_i}
// may overflow to +inf (m_i < -88.7), giving h = 0 as in the reference.
// expf is the accurate one (no fast math), and a product with a decay or a
// gate rounds before it is summed.  The sums run in another order than the
// reference's (the decayed state, or decay_q C q~, is the sum's start), which
// moves h by ~1e-6 in norm.  A ragged S is masked: rows >= S load zeros and
// are not stored, and the tail's steps never enter a state (only states
// entering chunks are kept).
//
// Interface: plain C, one entry per input type, launched on the caller's
// stream; each returns cudaGetLastError() after its launches.  D must be a
// multiple of 16, at most 1024 (checked by the wrapper and here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int TILE = 128;      // output tile edge
constexpr int HALF = TILE / 2;  // a thread's second row (column) group starts here
constexpr int KT = 16;         // depth of one staged slice
constexpr int NT = 256;        // threads per block: a 16 x 16 grid, 8 x 8 outputs each
constexpr int LD = TILE + 4;   // shared row stride (16-byte aligned rows)
constexpr float NEG = -1e30f;  // the stabilizer's start

static_assert(NT == 256 && TILE == 128, "the 16 x 16 thread grid covers a 128 x 128 tile");

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
  float* CT;  // (BH, nc - 1, D, D)  C^T entering chunks 1 .. nc - 1
};

size_t work_floats(size_t BH, size_t S, size_t D, size_t c) {
  const size_t nc = (S + c - 1) / c;
  return 2 * round_up(BH * S) + round_up(BH * nc) + round_up(BH * (nc - 1) * D) +
         round_up(BH * nc * c * c) + round_up(BH * (nc - 1) * D * D);
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

// acc[a][b] += As[k][owned(ty, a)] * Bs[k][owned(tx, b)] over the KT staged rows.
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
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    state_kernel(const T* __restrict__ k, const T* __restrict__ v,
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
        Ks[j][col] = live && e0 + col < D ? to_float(k[row + e0 + col]) : 0.f;
        Vs[j][col] = live && d0 + col < D ? __fmul_rn(ws[j], to_float(v[row + d0 + col])) : 0.f;
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

// 3. scores: one block per (tile pair jt <= it, chunk, batch, head).
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
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    out_kernel(const T* __restrict__ q, const T* __restrict__ v, Work w,
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
                         ? __fmul_rn(to_float(q[base + static_cast<size_t>(t0 + i0 + row) * D + e0 + e]),
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
                        ? to_float(v[base + static_cast<size_t>(t0 + j0 + jj) * D + d0 + col])
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* log_f, const void* i_gate,
           void* out, void* work, int B, int H, int S, int D, int chunk, float scale,
           void* stream) {
  cudaGetLastError();
  if (B < 1 || H < 1 || S < 1 || chunk < 1 || D < 16 || D > 1024 || D % 16 != 0 ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = min(chunk, S);
  const int nc = (S + c - 1) / c;
  if (nc > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int BH = B * H;
  const Work w = carve(static_cast<float*>(work), BH, S, D, c);
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* f = static_cast<const float*>(log_f);
  const auto* ig = static_cast<const float*>(i_gate);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int n_dt = (D + TILE - 1) / TILE;
  const int nt = (c + TILE - 1) / TILE;

  gates_kernel<<<BH, 32, 0, st>>>(f, ig, w, S, c, nc);
  if (nc > 1)
    state_kernel<T><<<dim3(n_dt * n_dt, 1, BH), NT, 0, st>>>(kt, vt, ig, w, S, D, c, nc, n_dt);
  score_kernel<T><<<dim3(nt * (nt + 1) / 2, nc, BH), NT, 0, st>>>(qt, kt, ig, w, S, D, c, nc,
                                                                 scale);
  out_kernel<T><<<dim3(n_dt * nt, nc, BH), NT, 0, st>>>(qt, vt, w, o, S, D, c, nc, nt, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of workspace one call needs (chunk as the call gives it).
long long mlstm_workspace_floats(int B, int H, int S, int D, int chunk) {
  if (B < 1 || H < 1 || S < 1 || D < 1 || chunk < 1) return 0;
  const int c = chunk < S ? chunk : S;
  return static_cast<long long>(work_floats(static_cast<size_t>(B) * H, S, D, c));
}

int mlstm_f32(const void* q, const void* k, const void* v, const void* log_f,
              const void* i_gate, void* out, void* work, int B, int H, int S, int D, int chunk,
              float scale, void* stream) {
  return launch<float>(q, k, v, log_f, i_gate, out, work, B, H, S, D, chunk, scale, stream);
}

int mlstm_bf16(const void* q, const void* k, const void* v, const void* log_f,
               const void* i_gate, void* out, void* work, int B, int H, int S, int D, int chunk,
               float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, log_f, i_gate, out, work, B, H, S, D, chunk, scale,
                               stream);
}

}  // extern "C"
