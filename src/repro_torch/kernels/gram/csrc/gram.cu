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
// this simple form.  fp32 runs on the CUDA cores: IEEE fp32 FMAs, no TF32 and
// no tensor-core emulation of fp32 (3xTF32, split bf16), so its floor is the
// 67 TFLOP/s fp32 rate.  bf16 gram_tri and gram_dense are bound by the 989
// TFLOP/s bf16 tensor-core rate, which only wgmma reaches: every bf16 call
// runs gram_wgmma_kernel (TMA + wgmma, see below), reading H and T from
// copies padded to rows of 16 bytes where they are not so already.  int8
// (gram_tri_q) runs gram_q_kernel (TMA + int8 wgmma from a K-major copy of
// Hq, see below); its floor is the bytes: the 1979 TOP/s int8 rate puts the
// products below the time of writing the fp32 G.
//
// The fp32 body (gram_f32_kernel: gram_tri, gram_dense and gram_fused's fp32
// stage 2):
//  * One 128 x 128 G tile per block, 256 threads, an 8 x 8 fp32 register
//    tile per thread (g_update: 16 FMAs per 16-byte shared load, a's loads
//    broadcast); every update an explicit fmaf with the samples in order,
//    so a diagonal tile is computed symmetrically.  gram_tri: one block per
//    (agent, lower-triangular tile pair (i, j <= i)), decoded from
//    blockIdx.x with exact integer arithmetic; each tile is written to
//    (i, j) and mirrored to (j, i), a diagonal tile its lower half only, so
//    G leaves exactly symmetric.  gram_dense, the dense baseline of one
//    agent: every (i, j), no mirror.  The block walks the whole sample axis
//    itself (the TPU's sequential n grid axis).
//  * The sample rows are staged by cp.async into a ring of FSTAGES = 4
//    stages of FK = 16 samples x the 128 columns of tiles i and j in
//    dynamic shared memory (68 KB): 16-byte copies where L % 4 == 0 and H
//    lies on 16 bytes, zero-filling 4-byte copies otherwise (rows past N and
//    columns past L read as 0; nothing outside [0, L) is stored).  One
//    barrier a stage; cp.async.wait_group keeps the next three stages in
//    flight while one is multiplied, so no slice's global latency is
//    exposed.  Two blocks share an SM (at most 128 registers, no spills).
//    Against 3 or 6 stages, 32-sample stages and one block an SM with a
//    deeper ring, it was the fastest at gram_tri's main and full shapes
//    and within 1% at gram_dense's on an H100 (PERF.md §6).
//  * R = H^T T is spread over every block: R on the blocks of column 0
//    alone made them the last of gram_dense's single wave (skipping R's
//    products cut the call by 25% on an H100).  Tile k's rows are
//    staged by nl blocks (gram_dense: (k, 0 .. nl - 1); the triangle:
//    (k, 0 .. k) and (k + 1 .. nl - 1, k)), and slot s of them multiplies
//    rows [s rpb, (s + 1) rpb) of the tile, rpb = ceil(128 / nl), against
//    T staged in the same ring, one (row, column) item a thread.
//  * One owner per R item: where dw does not divide the block's threads,
//    the threads past r_rows * dw own none; else the last of them would
//    own the next pass's first row too, and a later gram_fused chunk would
//    add into that item twice at once.
//
// gram_tri_q on int8 wgmma (gram_q_kernel), the port of gram_pallas_tri_q:
//  * The quantization tile (block_n rows x block_l columns, one fp32 scale
//    each) is part of the math, not of this tiling: block_l may be 32
//    inside a 128-wide G tile, so each row and column of the tile looks up
//    its own scale.  Within one row block the int8 products add exactly in
//    int32; at each row-block end the int32 tile converts to fp32 and adds
//    float(prod) * (s_i * s_j) to the fp32 accumulator, rounded in the
//    plain version's order (no FMA contraction), so G equals it bit for bit.
//    int32 -> fp32 is exact while block_n * 127^2 <= 2^24; the wrapper
//    refuses block_n above 1040.
//  * wgmma takes 8-bit operands K-major only (the sample axis contiguous),
//    and Hq is (m, N, L) with L contiguous.  So a pre-pass
//    (q_kmajor_kernel, a byte transpose through shared memory) writes Hq^T
//    into a buffer the wrapper allocates, (m, L, nnq bnp): each row block's
//    samples padded with zero samples to bnp, a multiple of the stage of KS
//    = 128, 64 or 32 samples (kernel.py's q_layout: the deepest stage whose
//    padding adds at most a quarter to the least).  Every stage lies in one
//    row block, and a zero sample adds an exact 0 to the int32 sums.  The
//    same grid writes T^T in that layout, (m, D, nnq bnp) bf16.
//  * TMA copies KS samples x 128 rows of L (a KS-byte swizzle, rows past L
//    read as 0) per tile per stage into a ring of QSTAGES = 4 stages, one
//    producer warp (lane 0 issues the copies, every lane writes the
//    stage's scales); two consumer warpgroups each run
//    m64n128k32.s32.s8.s8 wgmmas for 64 rows of the tile, A and B both
//    K-major, a diagonal tile's B from its A's copy.  One 128 x 128 tile at
//    a time: its int32 and fp32 accumulators are 128 registers a thread
//    (168 in all, one block an SM).  The blocks are persistent, one an
//    SM, each walking the triangle's tiles of every agent, so the ring
//    fills with the next tile's stages while a tile is flushed and stored
//    (8% less device time than a block a tile on an H100).  Each tile and
//    its mirror go straight from the accumulators to G in whole 32-byte
//    sectors (staged through shared memory for coalesced rows, as in the
//    bf16 body, the grid took 0.216 ms at the main shape against 0.191, in
//    two calls on an H100).
//  * R = sum (q s) T in fp32 FMAs on the CUDA cores, while the stage's
//    wgmmas run, from the staged K-major rows and a TMA box of T^T (8
//    columns a pass), spread over the tiles as in the fp32 body: a row's
//    samples split over up to 16 neighbouring lanes, each byte converted
//    once for all the pass's columns (the conversion by fp32 bit tricks:
//    I2F runs at a quarter of the rate, and with it and a byte a column R
//    took a third of the call on an H100), the lanes summed by a
//    butterfly at the end.
//  * What holds it (PERF.md §6): the operand copies stream at ~3.7 TB/s
//    (two 128-row copies a tile; the registers leave no room for a
//    second tile that would share one), and R's FMAs are ~20% of the grid
//    at D = 3, ~45% at D = 8.
//
// gram_tri and gram_dense in bf16 on wgmma (gram_wgmma_kernel):
//  * The output tiles and G's stores are those above: 128 x 128 G tiles (the
//    triangle's with the exact-symmetry mirror, or every (i, j) of one agent
//    with no mirror); R here rides the blocks of column 0 (on the tensor
//    cores its products are few beside G's).  A block takes two tiles
//    side by side, (i, j0) and (i, j0 + 1), so that tile i is copied once
//    for both: 1.5 tile copies per tile of products, not 2.  The triangle's
//    rows hold blocks of two tiles where both are on or below the diagonal
//    and a lone diagonal tile where not (pair_decode); the dense baseline's
//    16 x 8 blocks at L 2048 fill the card's 132 SMs once.  One tile a
//    block, with a ring of 4 or 6 stages or 3 at two blocks an SM, took
//    7-22% longer on an H100 at L 2048 (device time: gram_tri (8, 8192,
//    2048) 0.527-0.573 ms against 0.492, gram_dense (8192, 2048)
//    0.118-0.126 against 0.104).
//  * Both operands of G = H^T H come from row-major H tiles [sample][column]:
//    A = H_i^T and B = H_j are MN-major, which wgmma takes for 16-bit types
//    through its transpose flags (not for fp32, hence bf16 only).  TMA
//    copies 64 samples x 64 columns (128 bytes, 128-byte swizzle) per box,
//    two boxes per tile, from a 3-D map of H (so a ragged N reads zeros, not
//    the next agent); a tile j == i is not loaded again: its B is tile i.
//  * One producer thread (a warp of its own) keeps a ring of four stages
//    (50 KB each) in flight, one mbarrier each way per stage; two consumer
//    warpgroups each run m64n128k16 wgmma for 64 rows of each tile (128 fp32
//    accumulators a thread) and free a stage once the next stage's products
//    are issued.
//    No wgmma sits behind a branch (each block shape has its own loop), or
//    ptxas serializes them.
//  * R = H_i^T T reuses the A operand.  TMA needs rows of 16 bytes on 16
//    bytes: where H's or T's rows are not a multiple of 8 bf16 values, or
//    the array is off 16 bytes, the wrapper hands a buffer (h_buffer,
//    t_buffer) that pad_rows_kernel first fills with the rows and zero
//    columns (both arrays in one launch); the zero columns add exact zeros,
//    and nothing at or past L is stored.  T's copy is read in 64-sample x
//    8-column boxes, each the B of an m64n8k16 wgmma; 16 columns a pass,
//    as above.  Staged through the producer's registers instead, T's loads
//    held each stage of the blocks of column 0 back (the slowest blocks:
//    gram_dense bf16 full 0.20 against 0.11 ms without them on an H100).
//  * Each finished tile is staged through the drained ring (row stride 129
//    floats), so the tile and its transpose both leave in coalesced rows.
//
// gram_fused (H = act(X W + b) never given by the caller):
//  * The TPU kernel keeps each hidden tile in VMEM and never writes H to HBM.
//    An SM has at most 227 KB of shared memory, so a tile pair cannot keep its
//    hidden tiles across the sample axis; rebuilding them per pair (the first
//    port) computed the hidden layer ~L / 128 times over and cost ~10x the
//    library.  What bounds the call is then operations: the hidden layer,
//    2 m N d_in L fp32 flops, once, plus the Gram's m N L^2.
//  * So the hidden layer is computed ONCE per call, a chunk of whole sample
//    rows of all m agents at a time, into a workspace of (m, rows, ldh) in the
//    compute dtype that the wrapper allocates (torch.empty) and bounds by a
//    budget (kernel.py's FUSED_WORKSPACE_BYTES): it does not grow with N.
//    The trade: H is written and read once more (~0.27 GB at m 8, N 2048,
//    L 2048 fp32, ~0.08 ms at 3.35 TB/s), and each later chunk reads G back.
//  * Stage 1, hidden_kernel: a 128 x 128 register-tiled fp32 product per
//    block (g_update's 8 x 8 per thread), X and W staged 16 d_in at a time
//    (the next slice loaded into registers during this slice's products, as
//    float4 where d_in, L and the pointers allow, two shared buffers), d_in
//    walked in order with fmaf (no TF32); the epilogue adds the bias,
//    applies the activation (gelu: the tanh form), stores rows < rows and
//    columns < ldh, columns >= L as exact 0 AFTER the activation (act(0) !=
//    0), and rounds to bf16 in the bf16 stream.
//  * Stage 2 adds the chunk's lower-triangular G and its R into the outputs:
//    the first chunk stores, each later chunk loads, adds and stores, one
//    owner per element (a diagonal tile still writes its lower half and
//    mirrors it, so G stays exactly symmetric).  fp32: the fp32 body. bf16:
//    gram_mma_kernel, mma.sync m16n8k16 bf16 -> fp32 on a 2 x 4 layout of 64 x
//    32 warp sub-tiles (q_row, q_col: each fragment element's row and column),
//    fragments by ldmatrix.trans from row-major H tiles staged with cp.async
//    in a ring of four 32-sample stages (three in flight while one is read,
//    one barrier a stage).  R is on the tensor cores too: on the j == 0 blocks
//    each warp adds a 16-row x 16-column slice of H_i^T T (two mmas a k-step
//    beside G's sixteen); on the FMA path, as in gram_tri, R took 0.8 of this
//    grid's 2.0 ms on an H100 at m 8, N 8192, L 2048.  Both gram_fused kernels
//    are held to 128 registers (a few bytes of spill), so that two blocks
//    share an SM.
//
// Interface: plain C, one entry per kernel and dtype, launched on the caller's
// stream; each returns cudaGetLastError() of its launch.  The dynamic shared
// memory a kernel asks for above 48 KB is allowed once per device and
// process (allow_dynamic_smem), not at every call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int BL = 128;  // G tile edge
constexpr int BK = 16;   // sample rows staged per step
constexpr int RD = 16;   // R columns per pass
constexpr int NT = 256;  // threads per block

static_assert(NT == 256 && BL == 128, "thread layouts below assume 256 x 128");

enum Activation { kSigmoid = 0, kTanh = 1, kRelu = 2, kGelu = 3 };

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

// acc[p][q] += sum_k hi[k][row(p)] * hj[k][col(q)], k = 0 .. KS - 1 in order
template <int KS, int SI, int SJ>
__device__ __forceinline__ void g_update(const float (*hi)[SI], const float (*hj)[SJ],
                                         int ty, int tx, float acc[8][8]) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
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

// One element of a lower-triangular tile and its mirror; G is exactly
// symmetric before a later chunk adds to it, so the lower element is the sum.
__device__ __forceinline__ void store_g_pair(float* __restrict__ Ga, int L, int gr, int gc,
                                            float v, bool accumulate) {
  if (accumulate) v += Ga[static_cast<size_t>(gr) * L + gc];
  Ga[static_cast<size_t>(gr) * L + gc] = v;
  Ga[static_cast<size_t>(gc) * L + gr] = v;
}

// ---------------------------------------------------------------------------
// The fp32 Gram body: gram_tri, gram_dense and gram_fused's fp32 stage 2
// ---------------------------------------------------------------------------

constexpr int FK = 16;       // samples per pipeline stage
constexpr int FSTAGES = 4;   // ring depth: copies run FSTAGES - 1 stages ahead

struct F32Stage {
  float hi[FK][BL];  // samples x the 128 columns of tile i
  float hj[FK][BL];  // ... of tile j (unused on a diagonal tile)
  float t[FK][RD];   // samples x the pass's 16 columns of T
};
constexpr size_t kF32Smem = FSTAGES * sizeof(F32Stage);  // dynamic, > 48 KB

// Rows n0 .. n0 + FK - 1 of the 128 columns from col0 of row-major fp32 H
// (rows x L) into dst by cp.async; rows >= rows and columns >= L are
// zero-filled.  kVec (L % 4 == 0, H on 16 bytes): 16-byte copies, whole or
// zero-filled whole; otherwise 4-byte copies.  A thread keeps one column
// and steps down the rows.
template <bool kVec>
__device__ __forceinline__ void copy_h_f32(float (*dst)[BL], const float* __restrict__ H,
                                           int rows, int L, int n0, int col0) {
  constexpr int W = kVec ? 4 : 1;      // floats a copy
  constexpr int STEP = NT / (BL / W);  // rows apart of one thread's copies
  static_assert(FK % STEP == 0, "whole copies per thread");
  const int c = (threadIdx.x % (BL / W)) * W, l = col0 + c, k0 = threadIdx.x / (BL / W);
  const float* src = H + static_cast<size_t>(n0 + k0) * L + l;
#pragma unroll
  for (int u = 0; u < FK / STEP; ++u) {
    const int k = k0 + u * STEP;
    const bool valid = n0 + k < rows && l < L;
    if constexpr (kVec)
      cp_async16(&dst[k][c], valid ? src : H, valid);
    else
      cp_async4(&dst[k][c], valid ? src : H, valid);
    src += static_cast<size_t>(STEP) * L;
  }
}

// Rows n0 .. n0 + FK - 1 of T's 16 columns from d0 (rows of D floats, no
// alignment to copy by: 4-byte copies), zero-filled past rows and D.
__device__ __forceinline__ void copy_t_f32(float (*dst)[RD], const float* __restrict__ Tm,
                                           int rows, int D, int n0, int d0) {
  static_assert(FK % (NT / RD) == 0, "whole copies per thread");
  const int q = threadIdx.x % RD, d = d0 + q, k0 = threadIdx.x / RD;
#pragma unroll
  for (int u = 0; u < FK / (NT / RD); ++u) {
    const int k = k0 + u * (NT / RD), n = n0 + k;
    const bool valid = n < rows && d < D;
    cp_async4(&dst[k][q], valid ? Tm + static_cast<size_t>(n) * D + d : Tm, valid);
  }
}

// G = H^T H and R = H^T T in fp32 on the CUDA cores, one 128 x 128 tile a
// block.  kDense: tile (blockIdx.y, blockIdx.x) of one agent, stored as
// computed; otherwise the triangle's tile tri_decode(blockIdx.x) of agent
// blockIdx.y, stored with its mirror.  H is (m, rows, L); t_stride: elements
// between agents of T; accumulate: add into G and R (a later gram_fused
// chunk, triangle only).
//
// R is split so that every block carries a share of it.  Each tile of rows
// is staged by nl blocks: the dense row's (i, 0 .. nl - 1), or the
// triangle's (k, 0 .. k) and (k + 1 .. nl - 1, k).  Slot s of those blocks
// multiplies the tile's rows [s rpb, (s + 1) rpb), rpb = ceil(128 / nl):
// block (i, j) takes tile i's rows of slot j and, off the triangle's
// diagonal, tile j's rows of slot i.  A pass multiplies up to NT / dw of
// those rows by dw = min(D, 16) columns of T, one (row, column) a thread;
// a block walks the sample axis again only for further passes (G in the
// first): at L 2048 (rpb 8) one pass for D <= 16.
//
// At most 128 registers, so that two blocks share an SM.
template <bool kDense, bool kVec>
__global__ void __launch_bounds__(NT, 2) gram_f32_kernel(
    const float* __restrict__ H, const float* __restrict__ Tg, float* __restrict__ G,
    float* __restrict__ R, int rows, int L, int D, size_t t_stride, bool accumulate) {
  extern __shared__ float4 f32_smem[];
  F32Stage* ring = reinterpret_cast<F32Stage*>(f32_smem);

  int a = 0, i, j;
  if (kDense) {
    i = blockIdx.y;
    j = blockIdx.x;
  } else {
    a = blockIdx.y;
    tri_decode(blockIdx.x, i, j);
  }
  const float* Ha = H + static_cast<size_t>(a) * rows * L;
  const float* Ta = Tg + static_cast<size_t>(a) * t_stride;
  const bool diag = (i == j);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  // this block's R rows: ni of tile i from ri0, then nr - ni of tile j from rj0
  const int nl = (L + BL - 1) / BL, rpb = (BL + nl - 1) / nl;
  const int ri0 = min(j * rpb, BL), ni = min(ri0 + rpb, BL) - ri0;
  const int rj0 = min(i * rpb, BL);
  const int nr = ni + (kDense || diag ? 0 : min(rj0 + rpb, BL) - rj0);
  // a pass: up to 16 columns of T (dw of them) by the NT / dw rows that
  // fill the block's threads, one (row, column) item a thread
  const int dw = min(D, RD), r_rows = NT / dw;
  const int d_pass = (D + dw - 1) / dw;
  const int n_pass = max(1, (nr + r_rows - 1) / r_rows * d_pass);

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;

  const int steps = (rows + FK - 1) / FK;
  for (int pass = 0; pass < n_pass; ++pass) {
    const bool do_g = (pass == 0);
    const int d0 = (pass % d_pass) * dw, q0 = (pass / d_pass) * r_rows;
    // this thread's R item: row q of the block's list, column d.  Only the
    // first r_rows * dw threads own one: where dw does not divide NT, the
    // last thread's row would be row q0 + r_rows, the next pass's first,
    // and a later gram_fused chunk would add into that item twice at once.
    const int dq = threadIdx.x % dw, q = q0 + threadIdx.x / dw, d = d0 + dq;
    const bool do_r = q0 < nr;   // the block has R rows in this pass
    const bool own_r = q < nr && d < D && threadIdx.x < r_rows * dw;
    const bool from_i = q < ni;
    const int rc = from_i ? ri0 + q : rj0 + q - ni;    // its column in the staged tile
    float racc = 0.0f;
    auto load = [&](int s) {
      F32Stage& sg = ring[s % FSTAGES];
      copy_h_f32<kVec>(sg.hi, Ha, rows, L, s * FK, i * BL);
      if (!diag) copy_h_f32<kVec>(sg.hj, Ha, rows, L, s * FK, j * BL);
      if (do_r) copy_t_f32(sg.t, Ta, rows, D, s * FK, d0);
    };
    for (int s = 0; s < FSTAGES - 1; ++s) {
      if (s < steps) load(s);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<FSTAGES - 2>();  // stage s has landed (this thread's copies)
      __syncthreads();  // ... everyone's; and stage s - 1 is read by everyone
      if (s + FSTAGES - 1 < steps) load(s + FSTAGES - 1);  // into stage s - 1's slot
      cp_async_commit();
      const F32Stage& sg = ring[s % FSTAGES];
      if (do_g) g_update<FK>(sg.hi, diag ? sg.hi : sg.hj, ty, tx, acc);
      if (own_r) {
        const float(*h)[BL] = from_i ? sg.hi : sg.hj;
#pragma unroll
        for (int k = 0; k < FK; ++k) racc = fmaf(h[k][rc], sg.t[k][dq], racc);
      }
    }
    __syncthreads();  // the ring is read before another pass refills it
    if (own_r) {
      const int l = (from_i ? i : j) * BL + rc;
      if (l < L) {
        float* at = R + (static_cast<size_t>(a) * L + l) * D + d;
        *at = accumulate ? *at + racc : racc;
      }
    }
  }
  float* Ga = G + static_cast<size_t>(a) * L * L;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int r = tile_index(ty, p);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = tile_index(tx, q);
      const int gr = i * BL + r, gc = j * BL + c;
      if (gr >= L || gc >= L) continue;
      if (kDense)
        Ga[static_cast<size_t>(gr) * L + gc] = acc[p][q];
      else if (!diag || r >= c)  // a diagonal tile writes its lower half and mirrors it
        store_g_pair(Ga, L, gr, gc, acc[p][q], accumulate);
    }
  }
}

// ---------------------------------------------------------------------------
// gram_fused, stage 1: the hidden layer of one chunk, once
// ---------------------------------------------------------------------------

constexpr int XS = BL + 4;  // row stride of the staged X^T slice (2-way store conflicts)

__device__ __forceinline__ void store_hidden(float* at, float h) { *at = h; }
__device__ __forceinline__ void store_hidden(__nv_bfloat16* at, float h) {
  *at = __float2bfloat16_rn(h);
}

// Hws[a][r][l] = act(sum_d X[a][n0 + r][d] W[d][l] + b[l]) for r < rows and
// l < ldh; columns L <= l < ldh are exact 0.  Hws has agent stride rows * ldh.
// kVec (d_in and L multiples of 4, X and W 16-byte aligned): X and W move as
// float4, four elements whole or masked whole; otherwise one float at a time.
// At most 128 registers, so that two blocks share an SM.
template <typename T, bool kVec>
__global__ void __launch_bounds__(NT, 2) hidden_kernel(
    const float* __restrict__ X, const float* __restrict__ W, const float* __restrict__ bias,
    T* __restrict__ Hws, int N, int n0, int rows, int L, int ldh, int Din, int act) {
  // two slices of 16 d_in: the next one is loaded into registers while this
  // one is multiplied, then stored into the other buffer (one barrier a slice)
  __shared__ __align__(16) float xs[2][BK][XS];  // X^T: xs[k][r] = X[n0 + r0 + r][d0 + k]
  __shared__ __align__(16) float ws[2][BK][BL];  // ws[k][c] = W[d0 + k][c0 + c]
  constexpr int PER = BK * BL / NT;              // elements of each a thread moves
  constexpr int PER4 = PER / 4;

  const int a = blockIdx.z, r0 = blockIdx.y * BL, c0 = blockIdx.x * BL;
  const float* Xa = X + (static_cast<size_t>(a) * N + n0) * Din;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;

  float xr[PER], wr[PER];
  auto fetch = [&](int d0) {
    if constexpr (kVec) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < PER4; ++u) {
        const int e = threadIdx.x + u * NT;
        const int r = e / (BK / 4), dx = d0 + (e % (BK / 4)) * 4;
        const float4 x = (r0 + r < rows && dx < Din)
            ? *reinterpret_cast<const float4*>(Xa + static_cast<size_t>(r0 + r) * Din + dx)
            : zero;
        const int dw = d0 + e / (BL / 4), l = c0 + (e % (BL / 4)) * 4;
        const float4 w = (dw < Din && l < L)
            ? *reinterpret_cast<const float4*>(W + static_cast<size_t>(dw) * L + l)
            : zero;
        xr[4 * u] = x.x, xr[4 * u + 1] = x.y, xr[4 * u + 2] = x.z, xr[4 * u + 3] = x.w;
        wr[4 * u] = w.x, wr[4 * u + 1] = w.y, wr[4 * u + 2] = w.z, wr[4 * u + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = threadIdx.x + u * NT;
        const int r = e / BK, kx = e % BK, dx = d0 + kx;  // neighbours read neighbouring d
        xr[u] = (r0 + r < rows && dx < Din) ? Xa[static_cast<size_t>(r0 + r) * Din + dx] : 0.0f;
        const int kw = e / BL, c = e % BL, dw = d0 + kw, l = c0 + c;
        wr[u] = (dw < Din && l < L) ? W[static_cast<size_t>(dw) * L + l] : 0.0f;
      }
    }
  };
  auto stash = [&](int buf) {
    if constexpr (kVec) {
#pragma unroll
      for (int u = 0; u < PER4; ++u) {
        const int e = threadIdx.x + u * NT;
        const int r = e / (BK / 4), kx = (e % (BK / 4)) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) xs[buf][kx + j][r] = xr[4 * u + j];
        *reinterpret_cast<float4*>(&ws[buf][e / (BL / 4)][(e % (BL / 4)) * 4]) =
            make_float4(wr[4 * u], wr[4 * u + 1], wr[4 * u + 2], wr[4 * u + 3]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = threadIdx.x + u * NT;
        xs[buf][e % BK][e / BK] = xr[u];
        ws[buf][e / BL][e % BL] = wr[u];
      }
    }
  };
  fetch(0);
  stash(0);
  __syncthreads();
  for (int d0 = 0, buf = 0; d0 < Din; d0 += BK, buf ^= 1) {
    const bool more = d0 + BK < Din;
    if (more) fetch(d0 + BK);               // in flight during the products
    g_update<BK>(xs[buf], ws[buf], ty, tx, acc);  // d_in in order, one fmaf per step
    if (more) stash(buf ^ 1);               // the slot read one slice ago
    __syncthreads();
  }

  T* Ha = Hws + static_cast<size_t>(a) * rows * ldh;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int r = r0 + tile_index(ty, p);
    if (r >= rows) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int l = c0 + tile_index(tx, q);
      // padding columns become exact zeros after the activation
      if (l < ldh)
        store_hidden(Ha + static_cast<size_t>(r) * ldh + l,
                     l < L ? activate(acc[p][q] + bias[l], act) : 0.0f);
    }
  }
}

// The 2 x 4 layout of 64 x 32 warp sub-tiles of gram_mma_kernel: tile row /
// column of accumulator element e of fragment (mi, ni).
constexpr int WM = 64;        // warp tile rows (8 warps: 2 x 4)
constexpr int WN = 32;        // warp tile columns

static_assert(NT / 32 == (BL / WM) * (BL / WN), "one warp per 64 x 32 sub-tile");

__device__ __forceinline__ int q_row(int wm, int mi, int lane, int e) {
  return wm * WM + mi * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int q_col(int wn, int ni, int lane, int e) {
  return wn * WN + ni * 8 + (lane & 3) * 2 + (e & 1);
}

// ---------------------------------------------------------------------------
// gram_fused, stage 2 in bf16: the chunk's G on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MK = 32;       // samples per pipeline stage (two k = 16 mma steps)
constexpr int MS = BL + 8;   // bf16 row stride: ldmatrix's 8 rows hit 8 distinct bank quads
constexpr int MSTAGES = 4;   // stages in flight: copies run three stages ahead
constexpr int TS = RD + 8;   // bf16 row stride of a staged T slice
constexpr int TPER = MK * RD / NT;  // T elements a thread stages per stage

static_assert(MK * BL / 8 == 2 * NT, "two 16-byte copies per thread per H tile");

struct MmaStage {
  __nv_bfloat16 hi[MK][MS];  // samples x the 128 columns of tile i
  __nv_bfloat16 hj[MK][MS];  // ... of tile j (unused on a diagonal tile)
  __nv_bfloat16 t[MK][TS];   // samples x T's 16 columns of the pass (R owners)
};
constexpr size_t kMmaSmem = MSTAGES * sizeof(MmaStage);  // dynamic, > 48 KB

// Rows n0 .. n0 + MK - 1 of the 128 columns from col0 of a row-major bf16 H
// (row stride ldh, a multiple of 8) into dst; rows >= rows and columns >= ldh
// are zero-filled.
__device__ __forceinline__ void load_h_bf16(__nv_bfloat16 (*dst)[MS],
                                            const __nv_bfloat16* __restrict__ H, int rows,
                                            int ldh, int n0, int col0) {
  for (int e = threadIdx.x; e < MK * (BL / 8); e += NT) {
    const int k = e / (BL / 8), c = (e % (BL / 8)) * 8;
    const int n = n0 + k, l = col0 + c;
    const bool valid = n < rows && l < ldh;
    cp_async16(&dst[k][c], valid ? H + static_cast<size_t>(n) * ldh + l : H, valid);
  }
}

// One stage (MK samples) of the warp's 64 x 32 sub-tile.  A = Hi^T, B = Hj,
// both from row-major [sample][column] tiles: ldmatrix.trans hands each
// thread the sample pairs an mma fragment holds.
__device__ __forceinline__ void mma_update(const __nv_bfloat16 (*hi)[MS],
                                           const __nv_bfloat16 (*hj)[MS], int wm, int wn,
                                           int lane, float (&acc)[4][4][4]) {
  const int mat = lane >> 3, row = lane & 7;
#pragma unroll
  for (int kk = 0; kk < MK; kk += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)  // (k 0-7 | 8-15) x (rows 0-7 | 8-15) -> a0 a1 a2 a3
      ldsm_x4_trans(a[mi], &hi[kk + (mat >> 1) * 8 + row][wm * WM + mi * 16 + (mat & 1) * 8]);
#pragma unroll
    for (int np = 0; np < 2; ++np) {  // two 8-column fragments per load
      uint32_t r[4];
      ldsm_x4_trans(r, &hj[kk + (mat & 1) * 8 + row][wn * WN + np * 16 + (mat >> 1) * 8]);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// One stage of R's 16 x 16 sub-tile of warp (wm, wn): rows wm * 64 + wn * 16
// of tile i against the pass's 16 columns of T, two 8-column fragments.
__device__ __forceinline__ void mma_r_update(const __nv_bfloat16 (*hi)[MS],
                                             const __nv_bfloat16 (*t)[TS], int wm, int wn,
                                             int lane, float (&racc)[2][4]) {
  const int mat = lane >> 3, row = lane & 7;
#pragma unroll
  for (int kk = 0; kk < MK; kk += 16) {
    uint32_t a[4], b[4];
    ldsm_x4_trans(a, &hi[kk + (mat >> 1) * 8 + row][wm * WM + wn * 16 + (mat & 1) * 8]);
    ldsm_x4_trans(b, &t[kk + (mat & 1) * 8 + row][(mat >> 1) * 8]);
    mma_bf16(racc[0], a, b[0], b[1]);
    mma_bf16(racc[1], a, b[2], b[3]);
  }
}

// R's sub-tile of one warp into R (m's slice, L x D): store or add
__device__ __forceinline__ void store_r_mma(float* __restrict__ Ra, const float (&racc)[2][4],
                                            int L, int D, int i, int d0, int wm, int wn,
                                            int lane, bool accumulate) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int l = i * BL + wm * WM + wn * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
      const int d = d0 + nt * 8 + (lane & 3) * 2 + (e & 1);
      if (l < L && d < D) {
        float* at = Ra + static_cast<size_t>(l) * D + d;
        *at = accumulate ? *at + racc[nt][e] : racc[nt][e];
      }
    }
}

// G and R of one gram_fused chunk in bf16: H (m, N, ldh) bf16 workspace, T
// bf16 with agent stride t_stride; stores (first chunk) or adds (later ones).
// A ring of MSTAGES stages in dynamic shared memory, one barrier a stage.
// At most 128 registers, so that two blocks (16 warps) share an SM.
__global__ void __launch_bounds__(NT, 2) gram_mma_kernel(
    const __nv_bfloat16* __restrict__ H, const __nv_bfloat16* __restrict__ Tg,
    float* __restrict__ G, float* __restrict__ R, int N, int L, int ldh, int D,
    size_t t_stride, bool accumulate) {
  extern __shared__ float4 smem4[];
  MmaStage* ring = reinterpret_cast<MmaStage*>(smem4);

  const int a = blockIdx.y;
  int i, j;
  tri_decode(blockIdx.x, i, j);
  const __nv_bfloat16* Ha = H + static_cast<size_t>(a) * N * ldh;
  const __nv_bfloat16* Ta = Tg + static_cast<size_t>(a) * t_stride;
  const bool diag = (i == j), owns_r = (j == 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BL / WN), wn = warp % (BL / WN);

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  const int steps = (N + MK - 1) / MK;
  const int n_pass = owns_r ? (D + RD - 1) / RD : 1;
  for (int pass = 0; pass < n_pass; ++pass) {
    const bool do_g = (pass == 0);
    const int d0 = pass * RD;
    float racc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    // T (rows of D bf16, no alignment to copy by) goes through registers one
    // stage ahead of its slot, so its loads are in flight during a stage
    __nv_bfloat16 treg[TPER];
    auto fetch_t = [&](int step) {
#pragma unroll
      for (int u = 0; u < TPER; ++u) {
        const int e = threadIdx.x + u * NT, n = step * MK + e / RD, d = d0 + e % RD;
        treg[u] = (n < N && d < D) ? Ta[static_cast<size_t>(n) * D + d]
                                   : __float2bfloat16_rn(0.f);
      }
    };
    auto stash_t = [&](int step) {
#pragma unroll
      for (int u = 0; u < TPER; ++u) {
        const int e = threadIdx.x + u * NT;
        ring[step % MSTAGES].t[e / RD][e % RD] = treg[u];
      }
    };
    auto load_h = [&](int step) {
      MmaStage& sg = ring[step % MSTAGES];
      load_h_bf16(sg.hi, Ha, N, ldh, step * MK, i * BL);
      if (do_g && !diag) load_h_bf16(sg.hj, Ha, N, ldh, step * MK, j * BL);
    };
    for (int s = 0; s < MSTAGES - 1; ++s) {
      if (s < steps) {
        load_h(s);
        if (owns_r) {
          fetch_t(s);
          stash_t(s);
        }
      }
      cp_async_commit();
    }
    if (owns_r && MSTAGES - 1 < steps) fetch_t(MSTAGES - 1);
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<MSTAGES - 2>();  // stage s has landed (this thread's copies)
      __syncthreads();  // ... everyone's; and stage s - 1 is read by everyone
      if (s + MSTAGES - 1 < steps) {  // into stage s - 1's slot
        load_h(s + MSTAGES - 1);
        if (owns_r) stash_t(s + MSTAGES - 1);
      }
      cp_async_commit();
      if (owns_r && s + MSTAGES < steps) fetch_t(s + MSTAGES);
      const MmaStage& sg = ring[s % MSTAGES];
      if (do_g) mma_update(sg.hi, diag ? sg.hi : sg.hj, wm, wn, lane, acc);
      if (owns_r) mma_r_update(sg.hi, sg.t, wm, wn, lane, racc);
    }
    __syncthreads();  // the ring is read before another R pass refills it
    if (owns_r)
      store_r_mma(R + static_cast<size_t>(a) * L * D, racc, L, D, i, d0, wm, wn, lane,
                  accumulate);
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
        if (gr < L && gc < L && (!diag || r >= c))
          store_g_pair(Ga, L, gr, gc, acc[mi][ni][e], accumulate);
      }
}

inline dim3 tri_grid(int m, int L) {
  const int nl = (L + BL - 1) / BL;
  return dim3(nl * (nl + 1) / 2, m);
}

// ---------------------------------------------------------------------------
// gram_tri / gram_dense in bf16 on Hopper's tensor cores: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int WK = 64;         // samples per stage: one TMA box deep
constexpr int WBOX = 64;       // columns per TMA box: 128 bytes, the swizzle's row
constexpr int WSTAGES = 4;     // ring depth
constexpr int WTILES = 2;      // 128 x 128 G tiles per block, side by side
constexpr int WCONS = 2;       // consumer warpgroups, 64 tile rows each
constexpr int WNT = 128 * WCONS + 32;  // and one producer warp
constexpr int WRG = RD / 8;    // R: 8-column groups of T per pass
constexpr int WSLICES = WK / 16;       // k = 16 wgmma steps per stage
constexpr int WST = BL + 1;    // fp32 row stride of a staged output tile
constexpr uint32_t kBoxBytes = WK * WBOX * 2;   // one TMA box, 8 KB
constexpr uint32_t kSliceBytes = 16 * WBOX * 2;  // 16 samples of a box
constexpr uint32_t kTBoxBytes = WK * 8 * 2;      // 64 samples of 8 columns of T
// MN-major 128-byte-swizzled operands (CUTLASS's canonical GMMA layout
// ((8, m), (8, k)) : ((1, LBO), (8, SBO)) in 16-byte units): LBO steps to
// the next 64 columns (a tile's second box), SBO to the next 8 samples.
constexpr uint32_t kSwLbo = kBoxBytes;
constexpr uint32_t kSwSbo = 8 * WBOX * 2;
// T's 8-column groups (one TMA box each, no swizzle): 16-byte rows, 8
// samples to a 128-byte core matrix; with one 8-column group the next core
// matrix along k is the only stride, so it is both offsets
constexpr uint32_t kTCore = 8 * 16;

struct alignas(1024) WgStage {
  __nv_bfloat16 hi[2][WK][WBOX];          // tile i, two boxes (TMA writes them swizzled)
  __nv_bfloat16 hj[WTILES][2][WK][WBOX];  // tiles j0, j0 + 1 (a tile j == i is read from hi)
  __nv_bfloat16 t[WRG][WK][8];            // the pass's 16 columns of T, two boxes
};
constexpr size_t kWgSmem = WSTAGES * sizeof(WgStage) + 1024;  // + alignment
static_assert(sizeof(WgStage) % 1024 == 0, "every stage on a swizzle atom");
static_assert(BL * WST * sizeof(float) <= WSTAGES * sizeof(WgStage),
              "an output tile is staged in the ring");

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return wgmma_desc(addr, kSwLbo, kSwSbo, 1);
}

// The triangle in blocks of up to two tiles: row i of tiles holds blocks
// p = 0 .. i / 2, block p the tiles (i, 2p) and (i, 2p + 1) where both are
// on or below the diagonal, else (i, i) alone.  Rows 2k and 2k + 1 hold
// 2k + 2 blocks, so k(k + 1) blocks come before row 2k.
__device__ __forceinline__ void pair_decode(int t, int& i, int& j0, int& tiles) {
  int k, unused;
  tri_decode(t >> 1, k, unused);  // the largest k with k(k + 1) <= t
  const int o = t - k * (k + 1);
  i = 2 * k + (o > k ? 1 : 0);
  j0 = 2 * (o > k ? o - (k + 1) : o);
  tiles = j0 + 1 <= i ? 2 : 1;
}

struct WgCursor {
  int stage, phase;  // the ring slot a consumer reads next, and its parity
};

// One pass of a consumer warpgroup over the sample axis: with kG, each of
// the block's kTiles tiles adds the products of the warpgroup's 64 rows into
// acc[t] (tile t's B from tile i's copy where bit t of from_hi is set); each
// of kRG 8-column groups of T adds H_i^T T into racc.  A
// stage's slot is freed once the next stage's products are issued (at most
// one group of them in flight).
template <int kTiles, bool kG, int kRG>
__device__ __forceinline__ void wg_consume(const WgStage* ring, uint64_t* full, uint64_t* empty,
                                           int steps, int wg, int lane, int from_hi,
                                           WgCursor& cur, float (&acc)[WTILES][64],
                                           float (&racc)[WRG][4]) {
  int held = -1;  // the slot whose products may still be in flight
  for (int s = 0; s < steps; ++s) {
    mbar_wait(&full[cur.stage], cur.phase);
    const WgStage& sg = ring[cur.stage];
    const uint32_t a0 = smem_u32(&sg.hi[wg][0][0]);
    const uint32_t t0 = smem_u32(&sg.t[0][0][0]);
    uint32_t b0[WTILES];
#pragma unroll
    for (int t = 0; t < WTILES; ++t)
      b0[t] = smem_u32((from_hi >> t) & 1 ? &sg.hi[0][0][0] : &sg.hj[t][0][0][0]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < WSLICES; ++k) {
      const uint64_t da = sw128_desc(a0 + k * kSliceBytes);
      if constexpr (kG) {
#pragma unroll
        for (int t = 0; t < kTiles; ++t)
          wgmma_m64n128k16_mn(acc[t], da, sw128_desc(b0[t] + k * kSliceBytes));
      }
#pragma unroll
      for (int g = 0; g < kRG; ++g)
        wgmma_m64n8k16_mn(racc[g], da,
                          wgmma_desc(t0 + g * WK * 16 + k * 2 * kTCore, kTCore, kTCore, 0));
    }
    wgmma_commit();
    wgmma_wait<1>();
    mbar_arrive_if(&empty[held < 0 ? 0 : held], held >= 0 && lane == 0);
    held = cur.stage;
    if (++cur.stage == WSTAGES) cur.stage = 0, cur.phase ^= 1;
  }
  wgmma_wait<0>();
  mbar_arrive_if(&empty[held < 0 ? 0 : held], held >= 0 && lane == 0);
}

// G = H^T H (and R = H^T T on the blocks of column 0) of up to two 128 x 128
// tiles (i, j0) and (i, j0 + 1) per block, bf16 on the tensor cores with fp32
// accumulators.  kDense: tiles (blockIdx.y, 2 blockIdx.x + t) of one agent,
// stored as computed; otherwise block blockIdx.x of pair_decode's triangle
// of agent blockIdx.y, each tile stored with its mirror.  hmap is H, or its
// copy padded with zero columns to Lp = 8 ceil(L / 8), (m, N, Lp), as a 3-D
// tensor map of 64 x 64 boxes, 128-byte swizzle; tmap is T padded likewise
// to a multiple of 8, (m, N, 8 ceil(D / 8)), in 64 x 8 boxes without
// swizzle.
template <bool kDense>
__global__ void __launch_bounds__(WNT, 1) gram_wgmma_kernel(
    const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap tmap,
    float* __restrict__ G, float* __restrict__ R, int N, int L, int D) {
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t full[WSTAGES], empty[WSTAGES];
  WgStage* ring = reinterpret_cast<WgStage*>(
      wg_smem + ((1024 - smem_u32(wg_smem) % 1024) % 1024));

  const int a = kDense ? 0 : blockIdx.y;
  int i, j0, tiles;
  if (kDense) {
    i = blockIdx.y;
    j0 = 2 * blockIdx.x;
    tiles = j0 + 1 < (L + BL - 1) / BL ? 2 : 1;
  } else {
    pair_decode(blockIdx.x, i, j0, tiles);
  }
  // bit t: tile j0 + t is tile i, whose B operand is tile i's copy (nothing
  // more loads)
  const int from_hi = (j0 == i ? 1 : 0) | (j0 + 1 == i ? 2 : 0);
  const bool owns_r = (j0 == 0);
  const int steps = (N + WK - 1) / WK;
  const int n_pass = owns_r ? (D + RD - 1) / RD : 1;
  // the warp index through a shuffle: the compiler then knows it is
  // uniform across the warp, and the role split below is not divergent
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(&full[s], 1);             // the producer, with its TMA bytes
      mbar_init(&empty[s], WCONS * 4);    // one lane of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == WCONS * 4) {
    // producer: one thread keeps the ring's TMA copies in flight
    if (lane != 0) return;
    int stage = 0, phase = 0;
    for (int pass = 0; pass < n_pass; ++pass) {
      const int d0 = pass * RD;
      // tile j0 + t loads on the first pass unless it is tile i; T's
      // 8-column groups of the pass on the blocks of column 0
      const int load_j = pass == 0 ? ~from_hi & ((1 << tiles) - 1) : 0;
      const int t_groups = owns_r ? (d0 + 8 < D ? 2 : 1) : 0;
      const uint32_t bytes = 2 * (1 + __popc(load_j)) * kBoxBytes + t_groups * kTBoxBytes;
      for (int s = 0; s < steps; ++s) {
        const int n0 = s * WK;
        mbar_wait(&empty[stage], phase ^ 1);
        WgStage& sg = ring[stage];
        mbar_arrive_expect_tx(&full[stage], bytes);
        for (int b = 0; b < 2; ++b) {
          tma_load_3d(&sg.hi[b][0][0], &hmap, &full[stage], i * BL + b * WBOX, n0, a);
          for (int t = 0; t < tiles; ++t)
            if ((load_j >> t) & 1)
              tma_load_3d(&sg.hj[t][b][0][0], &hmap, &full[stage], (j0 + t) * BL + b * WBOX,
                          n0, a);
        }
        for (int g = 0; g < t_groups; ++g)
          tma_load_3d(&sg.t[g][0][0], &tmap, &full[stage], d0 + 8 * g, n0, a);
        if (++stage == WSTAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows wg * 64 .. wg * 64 + 63
  const int wg = warp / 4;
  float acc[WTILES][64];
#pragma unroll
  for (int t = 0; t < WTILES; ++t)
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[t][v] = 0.0f;
  WgCursor cur{0, 0};
  for (int pass = 0; pass < n_pass; ++pass) {
    const int d0 = pass * RD;
    // 8-column groups of T this pass multiplies: none off column 0
    const int groups = owns_r ? (d0 + 8 < D ? 2 : 1) : 0;
    float racc[WRG][4];
#pragma unroll
    for (int g = 0; g < WRG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) racc[g][e] = 0.0f;
    // each case its own loop, so that no wgmma sits behind a branch
#define WG_CONSUME(T, G_, RG) \
  wg_consume<T, G_, RG>(ring, full, empty, steps, wg, lane, from_hi, cur, acc, racc)
    if (pass > 0 && groups == 1) WG_CONSUME(1, false, 1);
    else if (pass > 0) WG_CONSUME(1, false, 2);
    else if (tiles == 2 && groups == 0) WG_CONSUME(2, true, 0);
    else if (tiles == 2 && groups == 1) WG_CONSUME(2, true, 1);
    else if (tiles == 2) WG_CONSUME(2, true, 2);
    else if (groups == 0) WG_CONSUME(1, true, 0);
    else if (groups == 1) WG_CONSUME(1, true, 1);
    else WG_CONSUME(1, true, 2);
#undef WG_CONSUME
    if (owns_r) {
      float* Ra = R + static_cast<size_t>(a) * L * D;
#pragma unroll
      for (int g = 0; g < WRG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = i * BL + wg * 64 + (warp % 4) * 16 + lane / 4 + (e >= 2 ? 8 : 0);
          const int d = d0 + g * 8 + (lane % 4) * 2 + (e & 1);
          if (l < L && d < D) Ra[static_cast<size_t>(l) * D + d] = racc[g][e];
        }
    }
  }

  // each tile through shared memory (the ring is drained), so that the tile
  // and its mirror both leave in coalesced rows
  float* st = reinterpret_cast<float*>(ring);
  float* Ga = G + static_cast<size_t>(a) * L * L;
  const int tid = threadIdx.x, rows = min(BL, L - i * BL);
#pragma unroll
  for (int t = 0; t < WTILES; ++t) {
    if (t >= tiles) break;
    const int j = j0 + t, cols = min(BL, L - j * BL);
    named_bar_sync(1, WCONS * 128);  // the ring, or the last tile, is read
#pragma unroll
    for (int v = 0; v < 64; ++v) {
      const int r = wg * 64 + (warp % 4) * 16 + lane / 4 + ((v >> 1) & 1) * 8;
      const int c = (v >> 2) * 8 + (lane % 4) * 2 + (v & 1);
      st[r * WST + c] = acc[t][v];
    }
    named_bar_sync(1, WCONS * 128);
    for (int e = tid; e < BL * BL; e += WCONS * 128) {
      const int r = e / BL, c = e % BL;
      // a diagonal tile of the triangle writes its lower half and that
      // half's mirror: exact symmetry
      const bool upper = !kDense && j == i && r < c;
      if (r < rows && c < cols)
        Ga[static_cast<size_t>(i * BL + r) * L + j * BL + c] =
            upper ? st[c * WST + r] : st[r * WST + c];
    }
    if (!kDense && j != i) {
      for (int e = tid; e < BL * BL; e += WCONS * 128) {
        const int c = e / BL, r = e % BL;  // row j * BL + c of G, along its columns
        if (r < rows && c < cols)
          Ga[static_cast<size_t>(j * BL + c) * L + i * BL + r] = st[r * WST + c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// gram_tri_q on Hopper's tensor cores: K-major copies, TMA + int8 wgmma
// ---------------------------------------------------------------------------

constexpr int QSTAGES = 4;            // ring depth
constexpr int QCT = 128 * WCONS;      // consumer threads
constexpr int RQ = 8;                 // R columns a pass: rows of T's K-major copy a box
constexpr int QT_K = 64, QT_L = 256;  // the pre-pass's tile: positions x columns
constexpr int QT_U = QT_K / 16;       // 16-byte pieces a pre-pass thread loads and stores
static_assert(QT_L == 256 && QT_K % 16 == 0, "the pre-pass: a column a thread");

struct alignas(1024) QStage {
  int8_t hi[BL * 128];          // tile i: 128 rows of L x KS samples, as TMA swizzled them
  int8_t hj[BL * 128];          // tile j (not loaded on a diagonal tile)
  __nv_bfloat16 t[RQ * 128];    // T's K-major copy: the pass's RQ columns x KS samples
  float si[BL], sj[BL];         // the stage's row block's scales of tile i's and j's rows
};
constexpr size_t kQSmem = QSTAGES * sizeof(QStage) + 1024;  // + alignment
static_assert(sizeof(QStage) % 1024 == 0, "every stage on a swizzle atom");

// Byte offset of logical byte x of a tile of kRow-byte rows as TMA's
// kRow-byte swizzle stores it: the 16-byte chunk index XOR the 128-byte
// line index (bits 4.. ^= bits 7..), over 3, 2 or 1 bits.
template <int kRow>
__device__ __forceinline__ int swizzled(int x) {
  constexpr int mask = kRow / 16 - 1;
  return x ^ (((x >> 7) & mask) << 4);
}

// Byte b of w, a signed int8 stored as q + 128 (w XOR 0x80 in each byte),
// as an exact float on the full-rate pipes: the fp32 bits 2^23 + (q + 128),
// less 2^23 + 128 (I2F runs at a quarter of the rate)
__device__ __forceinline__ float biased_s8_to_f32(uint32_t w, int b) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | b)) - 8388736.0f;
}
// the bf16 in the low or high half of w, as fp32
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Hk[a][l][nb bnp + t] = Hq[a][nb bn + t][l] and, from the blocks of the
// first column tile, Tk[a][d][nb bnp + t] = T[a][nb bn + t][d], for t below
// the rows of row block nb; 0 at the other positions: the K-major copies
// gram_q_kernel reads (every row block a whole number of stages, every row
// on 16 bytes).  A block transposes
// QT_K positions x 256 columns of Hq through shared memory: each thread
// loads QT_U 16-byte pieces of Hq's rows at once (single bytes where L % 16
// != 0 or Hq is off 16 bytes), then stores QT_U 16-byte pieces of one row of
// Hk, each gathered from a column of the tile.
__global__ void __launch_bounds__(256) q_kmajor_kernel(
    const int8_t* __restrict__ Hq, int8_t* __restrict__ Hk, const __nv_bfloat16* __restrict__ T,
    __nv_bfloat16* __restrict__ Tk, int N, int L, int D, int bn, int bnp, int kp, bool vec) {
  __shared__ __align__(16) uint8_t tile[QT_K][QT_L + 16];
  const int a = blockIdx.z, k0 = blockIdx.x * QT_K, l0 = blockIdx.y * QT_L;
  // the sample at position k of the copy, or -1 at a padding position
  auto sample = [&](int k) {
    const int nb = k / bnp, t = k - nb * bnp, n = nb * bn + t;
    return k < kp && t < bn && n < N ? n : -1;
  };
  if (blockIdx.y == 0) {
    for (int e = threadIdx.x; e < D * QT_K; e += 256) {
      const int d = e / QT_K, k = k0 + e % QT_K, n = sample(k);
      if (k < kp)
        Tk[(static_cast<size_t>(a) * D + d) * kp + k] =
            n >= 0 ? T[(static_cast<size_t>(a) * N + n) * D + d] : __float2bfloat16_rn(0.f);
    }
  }
  const int8_t* Ha = Hq + static_cast<size_t>(a) * N * L;
  uint4 piece[QT_U];
#pragma unroll
  for (int u = 0; u < QT_U; ++u) {  // position k0 + e / 16, columns l .. l + 15
    const int e = threadIdx.x + 256 * u, l = l0 + 16 * (e % 16), n = sample(k0 + e / 16);
    piece[u] = make_uint4(0, 0, 0, 0);
    if (n >= 0 && l < L) {
      const int8_t* src = Ha + static_cast<size_t>(n) * L + l;
      if (vec) {
        piece[u] = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
        for (int b = 0; b < 16 && l + b < L; ++b)
          w[b / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * (b % 4));
        piece[u] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < QT_U; ++u) {
    const int e = threadIdx.x + 256 * u;
    *reinterpret_cast<uint4*>(&tile[e / 16][16 * (e % 16)]) = piece[u];
  }
  __syncthreads();
  const int l = l0 + threadIdx.x;
  if (l >= L) return;
  int8_t* dst = Hk + (static_cast<size_t>(a) * L + l) * kp + k0;
#pragma unroll
  for (int u = 0; u < QT_U; ++u) {  // positions k0 + 16 u .. k0 + 16 u + 15 of row l
    if (k0 + 16 * u >= kp) break;
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      w[b / 4] |= static_cast<uint32_t>(tile[16 * u + b][threadIdx.x]) << (8 * (b % 4));
    *reinterpret_cast<uint4*>(dst + 16 * u) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// What R a block of the triangle owns (as in gram_f32_kernel): ni rows of
// tile i from ri0 (slot j of the rows that nl blocks stage), then, off the
// diagonal, nr - ni rows of tile j from rj0 (slot i).  Row q of that list
// goes to the lanes (q / 8) parts .. + parts - 1 of consumer warp q % 8,
// each taking len = KS / parts of a stage's samples, from p0, and every
// column of the pass; this thread's row q is row `row` of tile i (from_i)
// or j.
struct QRWork {
  int ni, ri0, rj0, nr, parts;
  int q, row, p0, len;
  bool from_i;
};

template <int KS>
__device__ __forceinline__ QRWork q_r_work(int i, int j, int L, int warp, int lane) {
  const int nl = (L + BL - 1) / BL, rpb = (BL + nl - 1) / nl;
  QRWork w;
  w.ri0 = min(j * rpb, BL);
  w.ni = min(w.ri0 + rpb, BL) - w.ri0;
  w.rj0 = min(i * rpb, BL);
  w.nr = w.ni + (i == j ? 0 : min(w.rj0 + rpb, BL) - w.rj0);
  w.parts = min(16, KS / 8);
  while (w.parts > 1 && w.nr * w.parts > QCT) w.parts >>= 1;
  w.q = (lane / w.parts) * (WCONS * 4) + warp;
  w.from_i = w.q < w.ni;
  w.row = w.from_i ? w.ri0 + w.q : w.rj0 + w.q - w.ni;
  w.len = KS / w.parts;
  w.p0 = (lane % w.parts) * w.len;
  return w;
}

// One stage's R products: racc[dd] += (q s) T[., d0 + dd] over this thread's
// share of the stage's samples, q from the swizzled K-major rows (each byte
// converted once for all dw columns), s the row's scale of the stage's row
// block, T from its K-major box (fp32 FMAs, as the plain version multiplies
// the dequantized rows)
template <int KS>
__device__ __forceinline__ void q_r_stage(const QStage& sg, const QRWork& w, int dw,
                                          float (&racc)[RQ]) {
  if (w.q >= w.nr) return;
  const int8_t* tile = w.from_i ? sg.hi : sg.hj;
  const float s = w.from_i ? sg.si[w.row] : sg.sj[w.row];
  for (int k = w.p0; k < w.p0 + w.len; k += 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(tile + swizzled<KS>(w.row * KS + k));
    const uint32_t b0 = v.x ^ 0x80808080u, b1 = v.y ^ 0x80808080u;
    float h[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) h[b] = __fmul_rn(biased_s8_to_f32(b < 4 ? b0 : b1, b % 4), s);
#pragma unroll
    for (int dd = 0; dd < RQ; ++dd) {
      if (dd >= dw) break;
      const uint4 t = *reinterpret_cast<const uint4*>(&sg.t[dd * KS + k]);
      const uint32_t tv[4] = {t.x, t.y, t.z, t.w};
      float r = racc[dd];
#pragma unroll
      for (int b = 0; b < 8; ++b)
        r = fmaf(h[b], b % 2 ? bf16_hi(tv[b / 2]) : bf16_lo(tv[b / 2]), r);
      racc[dd] = r;
    }
  }
}

// A row block's exact int32 products scaled into the fp32 accumulators, in
// the plain version's arithmetic: acc + float(prod) * (s_i * s_j), each
// step rounded on its own (no FMA contraction)
__device__ __forceinline__ void q_flush(float (&acc)[64], const int (&iacc)[64], const float* si,
                                        const float* sj, int wg, int warp, int lane) {
  const int r = wg * 64 + (warp % 4) * 16 + lane / 4;
  const float s_lo = si[r], s_hi = si[r + 8];
#pragma unroll
  for (int v = 0; v < 64; v += 2) {
    const float2 sc = *reinterpret_cast<const float2*>(&sj[(v >> 2) * 8 + (lane % 4) * 2]);
    const float s = (v >> 1) & 1 ? s_hi : s_lo;
    acc[v] = __fadd_rn(acc[v], __fmul_rn(__int2float_rn(iacc[v]), __fmul_rn(s, sc.x)));
    acc[v + 1] = __fadd_rn(acc[v + 1], __fmul_rn(__int2float_rn(iacc[v + 1]), __fmul_rn(s, sc.y)));
  }
}

// G = Hq^T Hq in int8 on the tensor cores, scaled per quantization tile, and
// R = sum (q s) T, of the m agents' lower-triangular 128 x 128 tiles (i, j),
// each stored with its mirror.  Persistent: block b takes tiles b, b +
// gridDim.x, ... in the order (agent, tri_decode's triangle), so that the
// producer fills the ring with the next tile's stages while the consumers
// flush and store a tile.  qmap: Hk, the K-major copy of Hq, (m, L, kp) int8
// in boxes of KS samples x 128 rows, a KS-byte swizzle; tmap: Tk, T's
// K-major copy, (m, D, kp) bf16 in boxes of KS samples x tr = min(D, RQ)
// rows.
//
// One producer warp: its lane 0 keeps the ring's TMA copies in flight; all
// its lanes write each stage's scales (the next row block's fetched while
// this one's stages go).  Two consumer warpgroups, 64 rows of a tile each:
// the first stage of a row block starts the int32 sums anew (scale-d 0),
// its last waits for them and flushes them into fp32; R's products of a
// stage run on the CUDA cores while its wgmmas are in flight.
template <int KS>
__global__ void __launch_bounds__(WNT, 1) gram_q_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap tmap,
    const float* __restrict__ S, float* __restrict__ G, float* __restrict__ R, int m, int N,
    int L, int D, int bn, int bl, int bnp) {
  extern __shared__ uint8_t q_smem[];
  __shared__ __align__(8) uint64_t full[QSTAGES], empty[QSTAGES];
  QStage* ring = reinterpret_cast<QStage*>(q_smem + ((1024 - smem_u32(q_smem) % 1024) % 1024));

  const int nl = (L + BL - 1) / BL, ntri = nl * (nl + 1) / 2, tiles = m * ntri;
  const int nnq = (N + bn - 1) / bn, nlq = (L + bl - 1) / bl, spb = bnp / KS, tr = min(D, RQ);
  const int n_pass = (D + RQ - 1) / RQ;  // for a tile with R rows
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < QSTAGES; ++s) {
      mbar_init(&full[s], 1);             // the producer, with its TMA bytes
      mbar_init(&empty[s], WCONS * 4);    // one lane of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  int stage = 0, phase = 0;  // the ring slot taken next, and its parity
  if (warp == WCONS * 4) {
    // producer.  Lane e % 32 writes the scales of rows e = lane + 32 v:
    // tile i's for e < 128, tile j's after
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int a = t / ntri;
      int i, j;
      tri_decode(t - a * ntri, i, j);
      const bool diag = (i == j);
      const QRWork rw = q_r_work<KS>(i, j, L, 0, 0);
      int sc[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int e = lane + 32 * v, col = e < BL ? i * BL + e : j * BL + e - BL;
        sc[v] = col < L ? col / bl : -1;
      }
      const float* Sa = S + static_cast<size_t>(a) * nnq * nlq;
      for (int pass = 0; pass < (rw.nr > 0 ? n_pass : 1); ++pass) {
        // tile j for G on the first pass, for its R rows on later ones; T
        // where the tile has R rows
        const bool load_j = !diag && (pass == 0 || rw.nr > rw.ni);
        const bool load_t = rw.nr > 0;
        const uint32_t bytes = (load_j ? 2 : 1) * BL * KS + (load_t ? KS * tr * 2 : 0);
        float cur[8], nxt[8];  // this row block's scales, and the next one's in flight
#pragma unroll
        for (int v = 0; v < 8; ++v) nxt[v] = sc[v] >= 0 ? __ldg(Sa + sc[v]) : 0.0f;
        for (int nb = 0; nb < nnq; ++nb) {
          const float* Sn = Sa + static_cast<size_t>(nb + 1 < nnq ? nb + 1 : nb) * nlq;
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            cur[v] = nxt[v];
            nxt[v] = sc[v] >= 0 ? __ldg(Sn + sc[v]) : 0.0f;
          }
          for (int u = 0; u < spb; ++u) {
            if (lane == 0) mbar_wait(&empty[stage], phase ^ 1);
            __syncwarp();
            QStage& sg = ring[stage];
#pragma unroll
            for (int v = 0; v < 8; ++v) (v < 4 ? sg.si : sg.sj)[lane + 32 * (v % 4)] = cur[v];
            __syncwarp();  // the scales are written before lane 0's arrival releases them
            if (lane == 0) {
              const int k0 = nb * bnp + u * KS;
              mbar_arrive_expect_tx(&full[stage], bytes);
              tma_load_3d(sg.hi, &qmap, &full[stage], k0, i * BL, a);
              if (load_j) tma_load_3d(sg.hj, &qmap, &full[stage], k0, j * BL, a);
              if (load_t) tma_load_3d(sg.t, &tmap, &full[stage], k0, pass * RQ, a);
            }
            if (++stage == QSTAGES) stage = 0, phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows wg * 64 .. wg * 64 + 63
  const int wg = warp / 4;
  int iacc[64];
  float acc[64];
#pragma unroll
  for (int v = 0; v < 64; ++v) iacc[v] = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int a = t / ntri;
    int i, j;
    tri_decode(t - a * ntri, i, j);
    const bool diag = (i == j);
    const QRWork rw = q_r_work<KS>(i, j, L, warp, lane);
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[v] = 0.0f;
    for (int pass = 0; pass < (rw.nr > 0 ? n_pass : 1); ++pass) {
      const int dw = min(RQ, D - pass * RQ);
      float racc[RQ];
#pragma unroll
      for (int dd = 0; dd < RQ; ++dd) racc[dd] = 0.0f;
      if (pass == 0) {
        int held = -1;  // the slot whose products may still be in flight
        for (int nb = 0; nb < nnq; ++nb) {
          for (int u = 0; u < spb; ++u) {
            const bool first = u == 0, last = u == spb - 1;  // of the row block
            mbar_wait(&full[stage], phase);  // the stage has landed
            const QStage& sg = ring[stage];
            const uint32_t a0 = smem_u32(sg.hi) + wg * 64 * KS;
            const uint32_t b0 = smem_u32(diag ? sg.hi : sg.hj);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < KS / 32; ++k)
              wgmma_m64n128k32_s8(iacc, kmajor_desc<KS>(a0 + 32 * k),
                                  kmajor_desc<KS>(b0 + 32 * k), !(first && k == 0));
            wgmma_commit();
            wgmma_wait<1>();  // the previous stage's products are done: free its slot
            mbar_arrive_if(&empty[held < 0 ? 0 : held], held >= 0 && lane == 0);
            held = stage;
            q_r_stage<KS>(sg, rw, dw, racc);  // while this stage's products run
            if (last) {  // the row block's int32 sums into fp32, then its last slot
              wgmma_wait<0>();
              q_flush(acc, iacc, sg.si, diag ? sg.si : sg.sj, wg, warp, lane);
              mbar_arrive_if(&empty[stage], lane == 0);
              held = -1;
            }
            if (++stage == QSTAGES) stage = 0, phase ^= 1;
          }
        }
      } else {
        for (int s = 0; s < nnq * spb; ++s) {
          mbar_wait(&full[stage], phase);
          q_r_stage<KS>(ring[stage], rw, dw, racc);
          mbar_arrive_if(&empty[stage], lane == 0);
          if (++stage == QSTAGES) stage = 0, phase ^= 1;
        }
      }
      // a row's parts summed over its lanes (a butterfly), stored by the first
#pragma unroll
      for (int dd = 0; dd < RQ; ++dd)
        for (int off = 1; off < rw.parts; off <<= 1)
          racc[dd] += __shfl_xor_sync(0xffffffffu, racc[dd], off);
      if (rw.p0 == 0 && rw.q < rw.nr) {
        const int l = (rw.from_i ? i : j) * BL + rw.row;
        float* Rl = R + (static_cast<size_t>(a) * L + l) * D + pass * RQ;
#pragma unroll
        for (int dd = 0; dd < RQ; ++dd)
          if (dd < dw && l < L) Rl[dd] = racc[dd];
      }
    }

    // the tile and its mirror straight from the accumulators: each warp
    // store fills whole 32-byte sectors (8 rows x 4 pairs of neighbouring
    // columns of the tile, and the 4 x 8 they mirror to).  A diagonal tile
    // stores its lower half and that half's mirror: exact symmetry.
    float* Ga = G + static_cast<size_t>(a) * L * L;
    const int r0 = i * BL + wg * 64 + (warp % 4) * 16 + lane / 4, c0 = j * BL + (lane % 4) * 2;
    const bool pairs = !diag && L % 2 == 0;  // float2 stores on 8 bytes
#pragma unroll
    for (int v = 0; v < 64; v += 2) {
      const int gr = r0 + ((v >> 1) & 1) * 8, gc = c0 + (v >> 2) * 8;
      if (gr >= L) continue;
      float* row = Ga + static_cast<size_t>(gr) * L;
      if (pairs && gc + 1 < L) {
        *reinterpret_cast<float2*>(row + gc) = make_float2(acc[v], acc[v + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (gc + e < L && (!diag || gr >= gc + e)) row[gc + e] = acc[v + e];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (gc + e < L && (!diag || gr > gc + e))
          Ga[static_cast<size_t>(gc + e) * L + gr] = acc[v + e];
    }
  }
}

using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: reached through the runtime's
// entry-point query, so that the library links no libcuda
TensorMapEncode tensor_map_encode() {
  static const TensorMapEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncode>(p)
               : nullptr;
  }();
  return fn;
}

// cudaFuncAttributeMaxDynamicSharedMemorySize of kKernel, set once per
// device and process (a per-call set cost every launch its host time)
template <auto kKernel>
cudaError_t allow_dynamic_smem(size_t bytes) {
  static std::atomic<uint64_t> done{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// The current device's SM count, asked once per device and process
cudaError_t sm_count(int* sms) {
  static std::atomic<int> counts[64];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (*sms = counts[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) counts[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

// fp32 gram_tri (m agents) or gram_dense (m = 1) on the fp32 body
template <bool kDense>
int gram_f32(const float* H, const float* T, float* G, float* R, int m, int rows, int L, int D,
             size_t t_stride, bool accumulate, cudaStream_t st) {
  // 16-byte copies where every row of H starts on 16 bytes
  const bool vec = L % 4 == 0 && aligned16(H);
  const cudaError_t attr = vec ? allow_dynamic_smem<gram_f32_kernel<kDense, true>>(kF32Smem)
                               : allow_dynamic_smem<gram_f32_kernel<kDense, false>>(kF32Smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nl = (L + BL - 1) / BL;
  const dim3 grid = kDense ? dim3(nl, nl) : tri_grid(m, L);
  const auto kernel = vec ? gram_f32_kernel<kDense, true> : gram_f32_kernel<kDense, false>;
  kernel<<<grid, NT, kF32Smem, st>>>(H, T, G, R, rows, L, D, t_stride, accumulate);
  return static_cast<int>(cudaGetLastError());
}

// One array of `rows` rows of `w` bf16 values copied into rows of wp >= w
// values, the columns w <= c < wp zero: the rows as 16-byte strides that TMA
// can copy
struct PadRows {
  const __nv_bfloat16* src;
  __nv_bfloat16* dst;
  size_t rows;
  int w, wp;
};

// blockIdx.y picks the array (H and T padded in one launch); each thread
// writes one 16-byte group of 8 values of a padded row (a 32-bit division
// per group: a 64-bit one per element made padding H at L 300 cost more
// than its Gram grid on an H100)
__global__ void pad_rows_kernel(PadRows a, PadRows b) {
  const PadRows& p = blockIdx.y == 0 ? a : b;
  const uint32_t groups = p.wp / 8;  // of a padded row
  const size_t n = p.rows * groups;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < n; e += stride) {
    const size_t r = n <= UINT32_MAX ? static_cast<uint32_t>(e) / groups : e / groups;
    const int c0 = static_cast<int>(e - r * groups) * 8;
    const __nv_bfloat16* src = p.src + r * p.w;
    alignas(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = c0 + q < p.w ? src[c0 + q] : __float2bfloat16_rn(0.f);
    *reinterpret_cast<uint4*>(p.dst + r * p.wp + c0) = *reinterpret_cast<const uint4*>(v);
  }
}

// A 3-D tensor map of a contiguous (m, rows, width) array of `type` in
// boxes of box_w columns x box_rows rows, the given swizzle; false if the
// driver refuses it.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
                int m, long long rows, long long width, int box_w, int box_rows,
                CUtensorMapSwizzle swizzle) {
  const TensorMapEncode encode = tensor_map_encode();
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * elem_bytes,
                                 static_cast<cuuint64_t>(rows) * width * elem_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// gram_tri (m agents) or gram_dense (m = 1) in bf16 on the wgmma body.  Hp
// and Tp are where the kernel reads H (m, N, L) and T (m, N, D) from, with
// zero columns up to Lp = 8 ceil(L / 8) and Dp = 8 ceil(D / 8): H or T
// itself where its rows already are so, else a buffer that pad_rows_kernel
// fills first.  Both on 16 bytes, as TMA needs; otherwise it refuses with
// cudaErrorInvalidValue before it launches anything.
template <bool kDense>
int gram_wgmma(const void* H, void* Hp, const void* T, void* Tp, void* G, void* R, int m, int N,
               int L, int D, void* stream) {
  cudaGetLastError();
  const int Lp = (L + 7) / 8 * 8, Dp = (D + 7) / 8 * 8;
  CUtensorMap hmap, tmap;
  if ((Hp == H && L != Lp) || (Tp == T && D != Dp) || !aligned16(Hp, Tp) ||
      !encode_map(&hmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Hp, m, N, Lp, WBOX, WK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Tp, m, N, Dp, 8, WK,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(m) * N;
  const auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  PadRows jobs[2];
  int n_jobs = 0;
  if (Hp != H) jobs[n_jobs++] = {bf(H), static_cast<__nv_bfloat16*>(Hp), rows, L, Lp};
  if (Tp != T) jobs[n_jobs++] = {bf(T), static_cast<__nv_bfloat16*>(Tp), rows, D, Dp};
  if (n_jobs > 0) {
    // a thread a 16-byte group of the larger array, at most 65535 blocks
    const size_t groups = rows * (std::max(Hp != H ? Lp : 0, Tp != T ? Dp : 0) / 8);
    const unsigned blocks = static_cast<unsigned>(std::min<size_t>((groups + 255) / 256, 65535));
    pad_rows_kernel<<<dim3(blocks, n_jobs), 256, 0, st>>>(jobs[0], jobs[n_jobs - 1]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t attr = allow_dynamic_smem<gram_wgmma_kernel<kDense>>(kWgSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // blocks of two tiles: every row of tiles of the square, or the
  // triangle's rows (pair_decode), ceil(nl / 2) (floor(nl / 2) + 1) of them
  const int nl = (L + BL - 1) / BL, half = (nl + 1) / 2;
  const dim3 grid = kDense ? dim3(half, nl) : dim3(half * (nl / 2 + 1), m);
  gram_wgmma_kernel<kDense><<<grid, WNT, kWgSmem, st>>>(
      hmap, tmap, static_cast<float*>(G), static_cast<float*>(R), N, L, D);
  return static_cast<int>(cudaGetLastError());
}

// The K-major copies of Hq (m, N, L) int8 into Hk (m, L, kp) and of T
// (m, N, D) bf16 into Tk (m, D, kp), kp = nnq bnp (q_kmajor_kernel), on the
// caller's stream
cudaError_t q_kmajor(const void* Hq, void* Hk, const void* T, void* Tk, int m, int N, int L,
                     int D, int bn, int bnp, int kp, cudaStream_t st) {
  const bool vec = L % 16 == 0 && aligned16(Hq);
  const dim3 grid((kp + QT_K - 1) / QT_K, (L + QT_L - 1) / QT_L, m);
  q_kmajor_kernel<<<grid, 256, 0, st>>>(
      static_cast<const int8_t*>(Hq), static_cast<int8_t*>(Hk),
      static_cast<const __nv_bfloat16*>(T), static_cast<__nv_bfloat16*>(Tk), N, L, D, bn, bnp,
      kp, vec);
  return cudaGetLastError();
}

// The plan of the K-major copies, as kernel.py's q_layout makes it: ks a
// stage of 128, 64 or 32 samples, bnp a multiple of it that holds a row
// block's rows, kp = nnq bnp below 2^31
bool q_layout_ok(int N, int bn, int ks, int bnp) {
  const long long kp = static_cast<long long>((N + bn - 1) / bn) * bnp;
  return (ks == 128 || ks == 64 || ks == 32) && bnp % ks == 0 && bnp >= std::min(bn, N) &&
         kp < (1ll << 31);
}

// gram_tri_q on the tensor-core body: the K-major copies of Hq and T into
// Hk and Tk, then the Gram grid; cudaErrorInvalidValue before anything
// launches where a tensor map is refused
template <int KS>
int gram_q(const void* Hq, void* Hk, const void* S, const void* T, void* Tk, void* G, void* R,
           int m, int N, int L, int D, int bn, int bl, int bnp, cudaStream_t st) {
  const int kp = (N + bn - 1) / bn * bnp;
  const long long tiles = static_cast<long long>(tri_grid(m, L).x) * m;
  if (tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, tmap;
  const CUtensorMapSwizzle swizzle = KS == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : KS == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  if (!aligned16(Hk, Tk) ||
      !encode_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Hk, m, L, kp, KS, BL, swizzle) ||
      !encode_map(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, Tk, m, D, kp, KS,
                  std::min(D, RQ), CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = q_kmajor(Hq, Hk, T, Tk, m, N, L, D, bn, bnp, kp, st);
  if (err == cudaSuccess) err = allow_dynamic_smem<gram_q_kernel<KS>>(kQSmem);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block an SM (its shared memory), each walking tiles
  const unsigned blocks = static_cast<unsigned>(std::min<long long>(tiles, sms));
  gram_q_kernel<KS><<<blocks, WNT, kQSmem, st>>>(
      qmap, tmap, static_cast<const float*>(S), static_cast<float*>(G), static_cast<float*>(R),
      m, N, L, D, bn, bl, bnp);
  return static_cast<int>(cudaGetLastError());
}

// One chunk of gram_fused: sample rows [n0, n0 + rows) of all m agents.  The
// hidden layer goes into Hws (m * rows * ldh elements of the compute dtype, as
// the caller allocated it: ldh = L in fp32; in bf16 at least L, a multiple of
// 8, and Hws 16-byte aligned, for the Gram grid's cp.async), then the chunk's
// G and R go into the outputs.  Two grids per chunk on the caller's stream.
template <typename T>
int fused_chunk(const void* X, const void* W, const void* b, const void* Tg, void* G,
                void* R, void* Hws, int m, int N, int L, int D, int Din, int n0, int rows,
                int ldh, int act, void* stream) {
  cudaGetLastError();
  const bool accumulate = n0 > 0;  // the first chunk stores, each later chunk adds
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if (kBf16 ? (ldh < L || ldh % 8 != 0 || !aligned16(Hws)) : ldh != L)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 hgrid((ldh + BL - 1) / BL, (rows + BL - 1) / BL, m);
  // float4 loads only where every row of X and W starts on 16 bytes
  const bool vec = Din % 4 == 0 && L % 4 == 0 && aligned16(X, W);
  const auto hidden = vec ? hidden_kernel<T, true> : hidden_kernel<T, false>;
  hidden<<<hgrid, NT, 0, st>>>(static_cast<const float*>(X), static_cast<const float*>(W),
                               static_cast<const float*>(b), static_cast<T*>(Hws), N, n0, rows,
                               L, ldh, Din, act);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* Tc = static_cast<const T*>(Tg) + static_cast<size_t>(n0) * D;
  const size_t t_stride = static_cast<size_t>(N) * D;
  if constexpr (kBf16) {
    const cudaError_t attr = allow_dynamic_smem<gram_mma_kernel>(kMmaSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    gram_mma_kernel<<<tri_grid(m, L), NT, kMmaSmem, st>>>(static_cast<const T*>(Hws), Tc,
                                                   static_cast<float*>(G),
                                                   static_cast<float*>(R), rows, L, ldh, D,
                                                   t_stride, accumulate);
    return static_cast<int>(cudaGetLastError());
  } else {
    return gram_f32<false>(static_cast<const float*>(Hws), Tc, static_cast<float*>(G),
                           static_cast<float*>(R), m, rows, L, D, t_stride, accumulate, st);
  }
}

}  // namespace

extern "C" {

int gram_tri_f32(const void* H, const void* T, void* G, void* R, int m, int N, int L,
                 int D, void* stream) {
  cudaGetLastError();
  return gram_f32<false>(static_cast<const float*>(H), static_cast<const float*>(T),
                         static_cast<float*>(G), static_cast<float*>(R), m, N, L, D,
                         static_cast<size_t>(N) * D, false, static_cast<cudaStream_t>(stream));
}

int gram_dense_f32(const void* H, const void* T, void* G, void* R, int N, int L, int D,
                   void* stream) {
  cudaGetLastError();
  return gram_f32<true>(static_cast<const float*>(H), static_cast<const float*>(T),
                        static_cast<float*>(G), static_cast<float*>(R), 1, N, L, D,
                        static_cast<size_t>(N) * D, false, static_cast<cudaStream_t>(stream));
}

int gram_fused_chunk_f32(const void* X, const void* W, const void* b, const void* T,
                         void* G, void* R, void* Hws, int m, int N, int L, int D, int Din,
                         int n0, int rows, int ldh, int act, void* stream) {
  return fused_chunk<float>(X, W, b, T, G, R, Hws, m, N, L, D, Din, n0, rows, ldh, act,
                            stream);
}

int gram_fused_chunk_bf16(const void* X, const void* W, const void* b, const void* T,
                          void* G, void* R, void* Hws, int m, int N, int L, int D, int Din,
                          int n0, int rows, int ldh, int act, void* stream) {
  return fused_chunk<__nv_bfloat16>(X, W, b, T, G, R, Hws, m, N, L, D, Din, n0, rows, ldh,
                                    act, stream);
}

// Hk, Tk: the K-major copies' buffers, m L kp bytes and m D kp bf16 values,
// kp = ceil(N / bn) bnp; ks, bnp: kernel.py's q_layout
int gram_tri_q(const void* Hq, void* Hk, const void* S, const void* T, void* Tk, void* G,
               void* R, int m, int N, int L, int D, int bn, int bl, int ks, int bnp,
               void* stream) {
  cudaGetLastError();
  if (!q_layout_ok(N, bn, ks, bnp)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (ks == 128) return gram_q<128>(Hq, Hk, S, T, Tk, G, R, m, N, L, D, bn, bl, bnp, st);
  if (ks == 64) return gram_q<64>(Hq, Hk, S, T, Tk, G, R, m, N, L, D, bn, bl, bnp, st);
  return gram_q<32>(Hq, Hk, S, T, Tk, G, R, m, N, L, D, bn, bl, bnp, st);
}

// The K-major copies alone (gram_tri_q's first grid), for checks and
// timing
int gram_q_kmajor(const void* Hq, void* Hk, const void* T, void* Tk, int m, int N, int L, int D,
                  int bn, int ks, int bnp, void* stream) {
  cudaGetLastError();
  if (!q_layout_ok(N, bn, ks, bnp)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(q_kmajor(Hq, Hk, T, Tk, m, N, L, D, bn, bnp, (N + bn - 1) / bn * bnp,
                                   static_cast<cudaStream_t>(stream)));
}

// Hp, Tp: H and T themselves where their rows are a multiple of 8 values on
// 16 bytes, else buffers of m N 8 ceil(L / 8) and m N 8 ceil(D / 8) values
int gram_tri_bf16_wgmma(const void* H, void* Hp, const void* T, void* Tp, void* G, void* R,
                        int m, int N, int L, int D, void* stream) {
  return gram_wgmma<false>(H, Hp, T, Tp, G, R, m, N, L, D, stream);
}

int gram_dense_bf16_wgmma(const void* H, void* Hp, const void* T, void* Tp, void* G, void* R,
                          int N, int L, int D, void* stream) {
  return gram_wgmma<true>(H, Hp, T, Tp, G, R, 1, N, L, D, stream);
}

// dynamic shared memory of a gram_wgmma_kernel, a gram_f32_kernel and a
// gram_q_kernel block, in bytes
int gram_wgmma_smem_bytes() { return static_cast<int>(kWgSmem); }
int gram_f32_smem_bytes() { return static_cast<int>(kF32Smem); }
int gram_q_smem_bytes() { return static_cast<int>(kQSmem); }

}  // extern "C"
