// Causal sliding-window attention, hand-written for Hopper (sm_90a).
//
// Replaces swa_pallas of src/repro/kernels/swa/kernel.py (body _swa_kernel):
// o = softmax(mask(Q K^T * D^-1/2)) V with query i attending key j iff
// j <= i, i - j < window and j < S; GQA reads kv head h / (H / KV) in place.
//
// What bounds it on an H100: operations.  Each query row takes 4 D flops per
// live key (Q K^T and P V), 4 B H D sum_i min(i + 1, W) in all, against q, k, v
// and o moved once; at D = 256 and W = 2048 that is ~1000 flops per byte.  All
// math is fp32 on the CUDA cores (bf16 inputs widened on load, p kept in fp32
// as in the TPU kernel), so the floor is the 67 TFLOP/s fp32 rate.  A wgmma
// version for bf16 is later work.
//
// Design:
//  * One block of 256 threads per (query tile of BQ = 64 rows, head, batch).
//    The block walks only the kv tiles (BK = 32 keys) that overlap its rows'
//    windows, [q0 - W + 1, q_last], each exactly once: the TPU kernel's
//    sequential kv grid axis becomes this loop, and its VMEM scratch (m, l,
//    acc) lives in registers.
//  * Q^T (D x 64) stays in shared memory for the whole walk; each kv tile
//    stages K^T (D x 32) and V (32 x D) in fp32.  Q^T and K^T are d-major so
//    a thread reads its 4 query rows as one float4 and its 2 keys as one
//    float2 per d: 8 FMAs for 2 shared loads.  D = 256 needs 148 KB of
//    dynamic shared memory (set with cudaFuncSetAttribute).
//  * Thread (ty, tx) of a 16 x 16 grid holds scores of rows 4 ty .. 4 ty + 3
//    and keys 2 tx, 2 tx + 1; row max and row sum reduce over the 16 lanes
//    of the row with shuffles.  It accumulates O rows 4 ty .. 4 ty + 3 at
//    columns tx + 16 jj, jj < NJ (NJ = ceil(D / 16) rounded to 4, 8 or 16),
//    so any D <= 256 works (120 included) with zero-padded V columns.
//  * Masked scores are -inf and never reach expf: p = 0 for a masked key,
//    and the running-max correction is 1 while a row has seen no live key,
//    so exp(-inf - (-inf)) never forms.  (The TPU kernel uses -1e30 instead,
//    which gives p = 1 on a wholly masked first tile and is cleared by the
//    correction once a live key arrives: the same result.)
//  * The output is acc / max(l, 1e-30), as the reference divides, cast to
//    the input type.  Rows >= S (a ragged or padded tail) load zeros, are
//    computed and are not stored.
//
// Interface: plain C, one entry per dtype, launched on the caller's stream;
// each returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 32;      // keys per kv tile
constexpr int NT = 256;     // threads per block, a 16 x 16 grid
constexpr int QS = BQ + 4;  // row stride of Q^T and P^T (16-byte aligned rows)
constexpr int KS = BK + 4;  // row stride of K^T (16-byte aligned rows)

static_assert(NT == 256 && BQ == 64 && BK == 32,
              "the thread layout below assumes a 16 x 16 grid on 64 x 32 scores");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
    swa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, int H, int KV, int S, int D, int window, float scale) {
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
      Qt[d * QS + r] = s < S ? to_float(q[q_base + static_cast<size_t>(s) * D + d]) : 0.f;
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
        Kt[d * KS + c] = in ? to_float(k[at]) : 0.f;
        Vs[c * DP + d] = in ? to_float(v[at]) : 0.f;
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
      if (d < D) o[q_base + static_cast<size_t>(s) * D + d] = from_float<T>(acc[i][jj] / l);
    }
  }
}

template <typename T, int NJ>
int launch_nj(const T* q, const T* k, const T* v, T* o, int B, int H, int KV, int S, int D,
              int window, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(D, NJ * 16) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        swa_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  swa_kernel<T, NJ><<<grid, NT, bytes, stream>>>(q, k, v, o, H, KV, S, D, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int S,
           int D, int window, float scale, void* stream) {
  cudaGetLastError();
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  auto* ot = static_cast<T*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch (nj_for(D)) {
    case 4: return launch_nj<T, 4>(qt, kt, vt, ot, B, H, KV, S, D, window, scale, st);
    case 8: return launch_nj<T, 8>(qt, kt, vt, ot, B, H, KV, S, D, window, scale, st);
    default: return launch_nj<T, 16>(qt, kt, vt, ot, B, H, KV, S, D, window, scale, st);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at head dim D (0 above 256).
int swa_smem_bytes(int D) {
  if (D < 1 || D > 256) return 0;
  return static_cast<int>(smem_floats(D, nj_for(D) * 16) * sizeof(float));
}

int swa_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int S,
            int D, int window, float scale, void* stream) {
  return launch<float>(q, k, v, o, B, H, KV, S, D, window, scale, stream);
}

int swa_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int S,
             int D, int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, D, window, scale, stream);
}

}  // extern "C"
