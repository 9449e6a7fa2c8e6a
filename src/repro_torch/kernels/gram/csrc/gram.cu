// Gram statistics G = H^T H and R = H^T T, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/gram/kernel.py:
//   gram_tri   <- gram_pallas_tri   (body _gram_tri_kernel)
//   gram_fused <- gram_pallas_fused (body _gram_fused_kernel)
//   gram_tri_q <- gram_pallas_tri_q (body _gram_tri_q_kernel)
//   gram_dense <- gram_pallas       (body _gram_kernel)
//
// What bounds them on an H100: operations.  G costs m*N*L^2 useful FMAs-worth of
// flops on the lower triangle and every byte of H is read once per tile pair
// that touches it, so the arithmetic intensity is ~BL/2 flops per byte even in
// this simple form; fp32 runs on the CUDA cores (no TF32 anywhere), so the
// floor is the 67 TFLOP/s fp32 rate.  bf16 inputs are widened to fp32 and run
// on the same FMA path: the tensor-core floor of bf16 is not reached by this
// kernel (a wgmma version is later work).  int8 (gram_tri_q) runs on the
// tensor cores through mma.sync m16n8k32 with int32 accumulators; its floor is
// the 1979 TOP/s int8 rate, far below what byte-wise staging without a
// pipeline reaches (a TMA + wgmma version is later work).
//
// Design:
//  * One thread block per (agent, lower-triangular tile pair (i, j <= i)); the
//    pair is decoded from blockIdx.x with exact integer arithmetic.  The block
//    walks the whole sample axis N itself (the TPU's sequential n grid axis).
//  * 128 x 128 G tile per block, 256 threads, an 8 x 8 fp32 register tile per
//    thread fed from 16-row slices of H staged in shared memory; every update
//    is an explicit fmaf, so a diagonal tile is computed symmetrically.
//  * The block writes its tile to (i, j) and the transpose to (j, i); on a
//    diagonal tile only the lower half is written (and mirrored), so G leaves
//    the kernel exactly symmetric.
//  * R = H^T T rides the j == 0 block of each row i (one writer per R tile),
//    16 target columns per pass over N; a second pass only for D > 16.
//  * Ragged N and L are masked in the kernel: rows >= N and columns >= L load
//    as 0, and nothing outside [0, L) is stored.  The wrapper never pads.
//  * gram_fused builds each hidden tile act(X W[:, tile] + b[tile]) in shared
//    memory from staged X rows and W columns (d_in walked 16 at a time), masks
//    rows >= N and columns >= L to exact 0 AFTER the activation (act(0) != 0),
//    and, for bf16, rounds the tile to bf16 before the product.  The two
//    hidden tiles of a pair are recomputed for every pair, as on the TPU: with
//    nl = L / 128 tile rows the hidden layer is computed ~(nl + 1) times.
//  * gram_tri_q keeps the grid and the mirror of gram_tri.  The quantization
//    tile (block_n rows x block_l columns, one fp32 scale each) is part of the
//    math, not of this tiling: block_l may be 32 inside a 128-wide G tile, so
//    each row and column of the tile looks up its own scale.  Within one row
//    block the int8 products add exactly in int32 (32 samples per mma step,
//    the step never crossing a row-block boundary: a partial step loads zero
//    rows); at each row-block end the int32 tile converts to fp32 and adds
//    float(prod) * (s_i * s_j) to the fp32 accumulator, rounded in the
//    reference's order (no FMA contraction).  R adds (q * s) * float(T_bf16)
//    with fmaf.  int32 -> fp32 is exact while block_n * 127^2 <= 2^24; the
//    wrapper refuses block_n above 1040.
//  * gram_dense is the dense-tile baseline for one agent: one block per
//    (i, j) tile pair, j > i included, no mirror, R on j == 0; the same
//    staging and FMA path as gram_tri, twice the tiles.
//
// Interface: plain C, one entry per kernel and dtype, launched on the caller's
// stream; each returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BL = 128;  // G tile edge
constexpr int BK = 16;   // sample rows staged per step
constexpr int RD = 16;   // R columns per pass
constexpr int DC = 16;   // d_in columns staged per step (fused)
constexpr int NT = 256;  // threads per block

static_assert(NT == 256 && BL == 128, "thread layouts below assume 256 x 128");
static_assert(BK * DC == NT, "one X element per thread per staging step");

enum Activation { kSigmoid = 0, kTanh = 1, kRelu = 2, kGelu = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kSigmoid:
      return 1.0f / (1.0f + expf(-x));
    case kTanh:
      return tanhf(x);
    case kRelu:
      return fmaxf(x, 0.0f);
    default: {  // gelu, tanh approximation (jax.nn.gelu's default)
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
    }
  }
}

// t = i (i + 1) / 2 + j  ->  (i, j <= i), exact for every t of the grid.
__device__ __forceinline__ void tri_decode(int t, int& i, int& j) {
  int r = static_cast<int>((sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  i = r;
  j = t - r * (r + 1) / 2;
}

// Row (or column) of the 128-wide tile held in register slot p by thread
// coordinate c in [0, 16): two float4 groups, 64 apart.
__device__ __forceinline__ int tile_index(int c, int p) {
  return (p < 4 ? 0 : 64) + c * 4 + (p & 3);
}

template <typename T>
__device__ __forceinline__ void load_h_tile(float (*dst)[BL], const T* __restrict__ H,
                                            int N, int L, int n0, int col0) {
  for (int e = threadIdx.x; e < BK * BL; e += NT) {
    const int k = e / BL, c = e % BL;
    const int n = n0 + k, l = col0 + c;
    dst[k][c] = (n < N && l < L) ? to_float(H[static_cast<size_t>(n) * L + l]) : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void load_t_tile(float (*dst)[RD], const T* __restrict__ Tm,
                                            int N, int D, int n0, int d0) {
  for (int e = threadIdx.x; e < BK * RD; e += NT) {
    const int k = e / RD, q = e % RD;
    const int n = n0 + k, d = d0 + q;
    dst[k][q] = (n < N && d < D) ? to_float(Tm[static_cast<size_t>(n) * D + d]) : 0.0f;
  }
}

// acc[p][q] += sum_k hi[k][row(p)] * hj[k][col(q)]
__device__ __forceinline__ void g_update(const float (*hi)[BL], const float (*hj)[BL],
                                         int ty, int tx, float acc[8][8]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&hi[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&hi[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&hj[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&hj[k][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
  }
}

// racc[q] += sum_k hi[k][l] * t[k][d0t + q], thread owns l = tid % 128 and
// the 8 R columns d0t = (tid / 128) * 8 of the current 16-column pass.
__device__ __forceinline__ void r_update(const float (*hi)[BL], const float (*t)[RD],
                                         float racc[8]) {
  const int l = threadIdx.x % BL, d0t = (threadIdx.x / BL) * 8;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float h = hi[k][l];
#pragma unroll
    for (int q = 0; q < 8; ++q) racc[q] = fmaf(h, t[k][d0t + q], racc[q]);
  }
}

__device__ __forceinline__ void store_r(float* __restrict__ Ra, const float racc[8],
                                        int L, int D, int i, int d0) {
  const int l = i * BL + threadIdx.x % BL;
  const int dbase = d0 + (threadIdx.x / BL) * 8;
  if (l >= L) return;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (dbase + q < D) Ra[static_cast<size_t>(l) * D + dbase + q] = racc[q];
}

__device__ __forceinline__ void store_g(float* __restrict__ Ga, const float acc[8][8],
                                       int L, int i, int j, int ty, int tx) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int r = tile_index(ty, p);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = tile_index(tx, q);
      const int gr = i * BL + r, gc = j * BL + c;
      // a diagonal tile writes its lower half and mirrors it: exact symmetry
      if (gr < L && gc < L && (i != j || r >= c)) {
        Ga[static_cast<size_t>(gr) * L + gc] = acc[p][q];
        Ga[static_cast<size_t>(gc) * L + gr] = acc[p][q];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) gram_tri_kernel(const T* __restrict__ H,
                                                      const T* __restrict__ Tg,
                                                      float* __restrict__ G,
                                                      float* __restrict__ R, int N,
                                                      int L, int D) {
  __shared__ __align__(16) float hi_s[BK][BL];
  __shared__ __align__(16) float hj_s[BK][BL];
  __shared__ __align__(16) float t_s[BK][RD];

  const int a = blockIdx.y;
  int i, j;
  tri_decode(blockIdx.x, i, j);
  const T* Ha = H + static_cast<size_t>(a) * N * L;
  const T* Ta = Tg + static_cast<size_t>(a) * N * D;
  const bool diag = (i == j), owns_r = (j == 0);
  const float(*hj)[BL] = diag ? hi_s : hj_s;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;

  const int n_pass = owns_r ? (D + RD - 1) / RD : 1;
  for (int pass = 0; pass < n_pass; ++pass) {
    const bool do_g = (pass == 0);
    const int d0 = pass * RD;
    float racc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int n0 = 0; n0 < N; n0 += BK) {
      load_h_tile(hi_s, Ha, N, L, n0, i * BL);
      if (do_g && !diag) load_h_tile(hj_s, Ha, N, L, n0, j * BL);
      if (owns_r) load_t_tile(t_s, Ta, N, D, n0, d0);
      __syncthreads();
      if (do_g) g_update(hi_s, hj, ty, tx, acc);
      if (owns_r) r_update(hi_s, t_s, racc);
      __syncthreads();
    }
    if (owns_r) store_r(R + static_cast<size_t>(a) * L * D, racc, L, D, i, d0);
  }
  store_g(G + static_cast<size_t>(a) * L * L, acc, L, i, j, ty, tx);
}

// One 16 x 128 hidden tile per call: pre-activations of rows n0.. for the
// thread's column c = tid % 128 and rows k0 = (tid / 128) * 8 .. k0 + 7.
template <bool kRoundBf16>
__device__ __forceinline__ void hidden_tiles(
    float (*hi)[BL], float (*hj)[BL], float (*x_s)[DC], float (*wi_s)[BL],
    float (*wj_s)[BL], const float* __restrict__ Xa, const float* __restrict__ W,
    const float* __restrict__ bias, int N, int L, int Din, int n0, int i, int j,
    bool diag, int act) {
  const int c = threadIdx.x % BL, k0 = (threadIdx.x / BL) * 8;
  float pi[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float pj[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int dd = 0; dd < Din; dd += DC) {
    {
      const int k = threadIdx.x / DC, q = threadIdx.x % DC;
      const int n = n0 + k, d = dd + q;
      x_s[k][q] = (n < N && d < Din) ? Xa[static_cast<size_t>(n) * Din + d] : 0.0f;
    }
    for (int e = threadIdx.x; e < DC * BL; e += NT) {
      const int q = e / BL, cc = e % BL, d = dd + q;
      const int li = i * BL + cc, lj = j * BL + cc;
      wi_s[q][cc] = (d < Din && li < L) ? W[static_cast<size_t>(d) * L + li] : 0.0f;
      if (!diag) wj_s[q][cc] = (d < Din && lj < L) ? W[static_cast<size_t>(d) * L + lj] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < DC; ++q) {
      const float wi = wi_s[q][c];
      const float wj = diag ? 0.0f : wj_s[q][c];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const float xv = x_s[k0 + p][q];
        pi[p] = fmaf(xv, wi, pi[p]);
        pj[p] = fmaf(xv, wj, pj[p]);
      }
    }
    __syncthreads();
  }
  const int li = i * BL + c, lj = j * BL + c;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int n = n0 + k0 + p;
    // padding rows / columns become exact zeros after the activation
    float h = (n < N && li < L) ? activate(pi[p] + bias[li], act) : 0.0f;
    if (kRoundBf16) h = __bfloat162float(__float2bfloat16(h));
    hi[k0 + p][c] = h;
    if (!diag) {
      float g = (n < N && lj < L) ? activate(pj[p] + bias[lj], act) : 0.0f;
      if (kRoundBf16) g = __bfloat162float(__float2bfloat16(g));
      hj[k0 + p][c] = g;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) gram_fused_kernel(
    const float* __restrict__ X, const float* __restrict__ W,
    const float* __restrict__ bias, const T* __restrict__ Tg, float* __restrict__ G,
    float* __restrict__ R, int N, int L, int D, int Din, int act) {
  constexpr bool kRound = !std::is_same<T, float>::value;
  __shared__ __align__(16) float hi_s[BK][BL];
  __shared__ __align__(16) float hj_s[BK][BL];
  __shared__ __align__(16) float t_s[BK][RD];
  __shared__ __align__(16) float x_s[BK][DC];
  __shared__ __align__(16) float wi_s[DC][BL];
  __shared__ __align__(16) float wj_s[DC][BL];

  const int a = blockIdx.y;
  int i, j;
  tri_decode(blockIdx.x, i, j);
  const float* Xa = X + static_cast<size_t>(a) * N * Din;
  const T* Ta = Tg + static_cast<size_t>(a) * N * D;
  const bool diag = (i == j), owns_r = (j == 0);
  const float(*hj)[BL] = diag ? hi_s : hj_s;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;

  const int n_pass = owns_r ? (D + RD - 1) / RD : 1;
  for (int pass = 0; pass < n_pass; ++pass) {
    const bool do_g = (pass == 0);
    const int d0 = pass * RD;
    float racc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int n0 = 0; n0 < N; n0 += BK) {
      // a later R pass needs only tile i: treat it as diagonal
      hidden_tiles<kRound>(hi_s, hj_s, x_s, wi_s, wj_s, Xa, W, bias, N, L, Din, n0, i,
                           j, diag || !do_g, act);
      if (owns_r) load_t_tile(t_s, Ta, N, D, n0, d0);
      __syncthreads();
      if (do_g) g_update(hi_s, hj, ty, tx, acc);
      if (owns_r) r_update(hi_s, t_s, racc);
      __syncthreads();
    }
    if (owns_r) store_r(R + static_cast<size_t>(a) * L * D, racc, L, D, i, d0);
  }
  store_g(G + static_cast<size_t>(a) * L * L, acc, L, i, j, ty, tx);
}

// ---------------------------------------------------------------------------
// gram_dense: every (i, j) tile pair of one agent, no mirror
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) gram_dense_kernel(const T* __restrict__ H,
                                                        const T* __restrict__ Tg,
                                                        float* __restrict__ G,
                                                        float* __restrict__ R, int N,
                                                        int L, int D) {
  __shared__ __align__(16) float hi_s[BK][BL];
  __shared__ __align__(16) float hj_s[BK][BL];
  __shared__ __align__(16) float t_s[BK][RD];

  const int i = blockIdx.y, j = blockIdx.x;
  const bool owns_r = (j == 0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;

  const int n_pass = owns_r ? (D + RD - 1) / RD : 1;
  for (int pass = 0; pass < n_pass; ++pass) {
    const bool do_g = (pass == 0);
    const int d0 = pass * RD;
    float racc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int n0 = 0; n0 < N; n0 += BK) {
      load_h_tile(hi_s, H, N, L, n0, i * BL);
      if (do_g) load_h_tile(hj_s, H, N, L, n0, j * BL);
      if (owns_r) load_t_tile(t_s, Tg, N, D, n0, d0);
      __syncthreads();
      if (do_g) g_update(hi_s, hj_s, ty, tx, acc);
      if (owns_r) r_update(hi_s, t_s, racc);
      __syncthreads();
    }
    if (owns_r) store_r(R, racc, L, D, i, d0);
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gr = i * BL + tile_index(ty, p);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int gc = j * BL + tile_index(tx, q);
      if (gr < L && gc < L) G[static_cast<size_t>(gr) * L + gc] = acc[p][q];
    }
  }
}

// ---------------------------------------------------------------------------
// gram_tri_q: int8 tiles on the tensor cores, per-tile scales
// ---------------------------------------------------------------------------

constexpr int QK = 32;        // samples per mma step (k of m16n8k32)
constexpr int QW = QK / 4;    // packed 32-bit words per column per step
constexpr int QS = QW + 4;    // smem row stride in words: conflict-free fragments
constexpr int WM = 64;        // warp tile rows (8 warps: 2 x 4)
constexpr int WN = 32;        // warp tile columns

static_assert(NT / 32 == (BL / WM) * (BL / WN), "one warp per 64 x 32 sub-tile");
static_assert(NT == 2 * BL, "R: two threads per tile column");

// dst[c][w] packs rows n0 + 4w .. n0 + 4w + 3 of column col0 + c, the lowest
// row in the lowest byte (the k order of an mma fragment register); rows >=
// n_end and columns >= L load as 0.
__device__ __forceinline__ void load_q_tile(uint32_t (*dst)[QS],
                                            const int8_t* __restrict__ Hq, int L,
                                            int n0, int n_end, int col0) {
  for (int e = threadIdx.x; e < BL * QW; e += NT) {
    const int c = e % BL, w = e / BL;
    const int l = col0 + c;
    uint32_t word = 0;
    if (l < L) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int n = n0 + 4 * w + b;
        if (n < n_end)
          word |= static_cast<uint32_t>(static_cast<uint8_t>(
                      Hq[static_cast<size_t>(n) * L + l]))
                  << (8 * b);
      }
    }
    dst[c][w] = word;
  }
}

__device__ __forceinline__ void load_t_q(float (*dst)[RD],
                                         const __nv_bfloat16* __restrict__ Tm, int D,
                                         int n0, int n_end, int d0) {
  for (int e = threadIdx.x; e < QK * RD; e += NT) {
    const int k = e / RD, q = e % RD;
    const int n = n0 + k, d = d0 + q;
    dst[k][q] =
        (n < n_end && d < D) ? __bfloat162float(Tm[static_cast<size_t>(n) * D + d]) : 0.0f;
  }
}

// per-column scales of row block nb for the 128 columns from col0 (0 past L)
__device__ __forceinline__ void load_scales(float* dst, const float* __restrict__ Sa,
                                            int nlq, int L, int bl, int nb, int col0) {
  for (int c = threadIdx.x; c < BL; c += NT) {
    const int l = col0 + c;
    dst[c] = l < L ? Sa[static_cast<size_t>(nb) * nlq + l / bl] : 0.0f;
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k = 32 step of the warp's 64 x 32 sub-tile: A = the i tile (row-major
// 16 x 32 fragments), B = the j tile (column-major 32 x 8 fragments).
__device__ __forceinline__ void q_update(const uint32_t (*hi)[QS],
                                         const uint32_t (*hj)[QS], int wm, int wn,
                                         int lane, int (&acc)[4][4][4]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[4][4], b[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int r = wm * WM + mi * 16 + g;
    a[mi][0] = hi[r][t];
    a[mi][1] = hi[r + 8][t];
    a[mi][2] = hi[r][t + 4];
    a[mi][3] = hi[r + 8][t + 4];
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = wn * WN + ni * 8 + g;
    b[ni][0] = hj[c][t];
    b[ni][1] = hj[c][t + 4];
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
}

// Tile row / column of accumulator element e of fragment (mi, ni).
__device__ __forceinline__ int q_row(int wm, int mi, int lane, int e) {
  return wm * WM + mi * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int q_col(int wn, int ni, int lane, int e) {
  return wn * WN + ni * 8 + (lane & 3) * 2 + (e & 1);
}

__global__ void __launch_bounds__(NT) gram_tri_q_kernel(
    const int8_t* __restrict__ Hq, const float* __restrict__ S,
    const __nv_bfloat16* __restrict__ Tg, float* __restrict__ G, float* __restrict__ R,
    int N, int L, int D, int bn, int bl) {
  __shared__ __align__(16) uint32_t qi_s[BL][QS];
  __shared__ __align__(16) uint32_t qj_s[BL][QS];
  __shared__ __align__(16) float t_s[QK][RD];
  __shared__ float si_s[BL];
  __shared__ float sj_s[BL];

  const int a = blockIdx.y;
  int i, j;
  tri_decode(blockIdx.x, i, j);
  const int nnq = (N + bn - 1) / bn, nlq = (L + bl - 1) / bl;
  const int8_t* Ha = Hq + static_cast<size_t>(a) * N * L;
  const float* Sa = S + static_cast<size_t>(a) * nnq * nlq;
  const __nv_bfloat16* Ta = Tg + static_cast<size_t>(a) * N * D;
  const bool diag = (i == j), owns_r = (j == 0);
  const uint32_t(*qj)[QS] = diag ? qi_s : qj_s;
  const float* sj = diag ? si_s : sj_s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BL / WN), wn = warp % (BL / WN);

  float acc[4][4][4];
  int iacc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  const int n_pass = owns_r ? (D + RD - 1) / RD : 1;
  for (int pass = 0; pass < n_pass; ++pass) {
    const bool do_g = (pass == 0);
    const int d0 = pass * RD;
    const int rl = threadIdx.x % BL, rd = (threadIdx.x / BL) * 8;
    float racc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int nb = 0; nb < nnq; ++nb) {
      const int b0 = nb * bn, b_end = min(b0 + bn, N);
      __syncthreads();  // the previous block's flush has read the scales
      load_scales(si_s, Sa, nlq, L, bl, nb, i * BL);
      if (do_g && !diag) load_scales(sj_s, Sa, nlq, L, bl, nb, j * BL);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) iacc[mi][ni][e] = 0;
      for (int n0 = b0; n0 < b_end; n0 += QK) {
        load_q_tile(qi_s, Ha, L, n0, b_end, i * BL);
        if (do_g && !diag) load_q_tile(qj_s, Ha, L, n0, b_end, j * BL);
        if (owns_r) load_t_q(t_s, Ta, D, n0, b_end, d0);
        __syncthreads();
        if (do_g) q_update(qi_s, qj, wm, wn, lane, iacc);
        if (owns_r) {
          const float s = si_s[rl];
#pragma unroll
          for (int w = 0; w < QW; ++w) {
            const uint32_t word = qi_s[rl][w];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const float h = __fmul_rn(
                  static_cast<float>(static_cast<int8_t>((word >> (8 * b)) & 0xff)), s);
#pragma unroll
              for (int q = 0; q < 8; ++q)
                racc[q] = fmaf(h, t_s[4 * w + b][rd + q], racc[q]);
            }
          }
        }
        __syncthreads();
      }
      if (do_g) {
        // the row block's exact int32 tile product, scaled into fp32
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ss = __fmul_rn(si_s[q_row(wm, mi, lane, e)],
                                         sj[q_col(wn, ni, lane, e)]);
              acc[mi][ni][e] = __fadd_rn(
                  acc[mi][ni][e], __fmul_rn(__int2float_rn(iacc[mi][ni][e]), ss));
            }
      }
    }
    if (owns_r) store_r(R + static_cast<size_t>(a) * L * D, racc, L, D, i, d0);
  }
  float* Ga = G + static_cast<size_t>(a) * L * L;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q_row(wm, mi, lane, e), c = q_col(wn, ni, lane, e);
        const int gr = i * BL + r, gc = j * BL + c;
        // a diagonal tile writes its lower half and mirrors it: exact symmetry
        if (gr < L && gc < L && (!diag || r >= c)) {
          Ga[static_cast<size_t>(gr) * L + gc] = acc[mi][ni][e];
          Ga[static_cast<size_t>(gc) * L + gr] = acc[mi][ni][e];
        }
      }
}

inline dim3 tri_grid(int m, int L) {
  const int nl = (L + BL - 1) / BL;
  return dim3(nl * (nl + 1) / 2, m);
}

}  // namespace

extern "C" {

int gram_tri_f32(const void* H, const void* T, void* G, void* R, int m, int N, int L,
                 int D, void* stream) {
  cudaGetLastError();
  gram_tri_kernel<float><<<tri_grid(m, L), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(H), static_cast<const float*>(T), static_cast<float*>(G),
      static_cast<float*>(R), N, L, D);
  return static_cast<int>(cudaGetLastError());
}

int gram_tri_bf16(const void* H, const void* T, void* G, void* R, int m, int N, int L,
                  int D, void* stream) {
  cudaGetLastError();
  gram_tri_kernel<__nv_bfloat16>
      <<<tri_grid(m, L), NT, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(H), static_cast<const __nv_bfloat16*>(T),
          static_cast<float*>(G), static_cast<float*>(R), N, L, D);
  return static_cast<int>(cudaGetLastError());
}

int gram_fused_f32(const void* X, const void* W, const void* b, const void* T, void* G,
                   void* R, int m, int N, int L, int D, int Din, int act, void* stream) {
  cudaGetLastError();
  gram_fused_kernel<float><<<tri_grid(m, L), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(W),
      static_cast<const float*>(b), static_cast<const float*>(T), static_cast<float*>(G),
      static_cast<float*>(R), N, L, D, Din, act);
  return static_cast<int>(cudaGetLastError());
}

int gram_fused_bf16(const void* X, const void* W, const void* b, const void* T, void* G,
                    void* R, int m, int N, int L, int D, int Din, int act, void* stream) {
  cudaGetLastError();
  gram_fused_kernel<__nv_bfloat16>
      <<<tri_grid(m, L), NT, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(X), static_cast<const float*>(W),
          static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(T),
          static_cast<float*>(G), static_cast<float*>(R), N, L, D, Din, act);
  return static_cast<int>(cudaGetLastError());
}

int gram_tri_q(const void* Hq, const void* S, const void* T, void* G, void* R, int m,
               int N, int L, int D, int bn, int bl, void* stream) {
  cudaGetLastError();
  gram_tri_q_kernel<<<tri_grid(m, L), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(Hq), static_cast<const float*>(S),
      static_cast<const __nv_bfloat16*>(T), static_cast<float*>(G), static_cast<float*>(R),
      N, L, D, bn, bl);
  return static_cast<int>(cudaGetLastError());
}

int gram_dense_f32(const void* H, const void* T, void* G, void* R, int N, int L, int D,
                   void* stream) {
  cudaGetLastError();
  const int nl = (L + BL - 1) / BL;
  gram_dense_kernel<float><<<dim3(nl, nl), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(H), static_cast<const float*>(T), static_cast<float*>(G),
      static_cast<float*>(R), N, L, D);
  return static_cast<int>(cudaGetLastError());
}

int gram_dense_bf16(const void* H, const void* T, void* G, void* R, int N, int L, int D,
                    void* stream) {
  cudaGetLastError();
  const int nl = (L + BL - 1) / BL;
  gram_dense_kernel<__nv_bfloat16>
      <<<dim3(nl, nl), NT, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(H), static_cast<const __nv_bfloat16*>(T),
          static_cast<float*>(G), static_cast<float*>(R), N, L, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
