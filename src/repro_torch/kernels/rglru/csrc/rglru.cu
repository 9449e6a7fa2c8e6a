// The RG-LRU diagonal linear recurrence, hand-written for Hopper (sm_90a).
//
// Replaces rglru_pallas of src/repro/kernels/rglru/kernel.py (body
// _rglru_kernel): h_t = exp(log_a_t) * h_{t-1} + b_t along the time axis,
// independently for every (batch, channel), from h_{-1} = h0.
//
// What bounds it on an H100: bytes.  It does 3 flops and an exp per 12 bytes
// moved (log_a and b read once, h written once), so the floor is
// 4 (3 B S D + B D) bytes over 3.35 TB/s.
//
// Design:
//  * One block per (64 channels, batch), one thread per channel walking the
//    whole time axis with the carry in a register: the TPU kernel's
//    sequential time grid axis and its VMEM carry become this loop.  At
//    recurrentgemma-2b's width (8 x 2560) that is 320 blocks for 132 SMs.
//  * The loads do not wait on the walk: slices of TS = 16 steps of log_a
//    and b for the block's channels are staged by cp.async into a ring of
//    RING = 4 slices in shared memory (32 KB), RING - 1 slices in flight
//    while the threads walk the current one (8 slices or 8-step slices read
//    no faster on an H100, 32-step slices and 128 channels a block no
//    faster at (8, 4096, 2560)).  One barrier a slice
//    frees the slot that the next copy refills.  16-byte copies where
//    D % 4 == 0 and the tensors lie on 16 bytes, 4-byte copies otherwise.
//  * A walk's step reads its log_a and b from shared memory; the exps of a
//    slice do not depend on h, so only the multiply and the add are in the
//    chain.  Each step's h is stored straight to device memory, coalesced
//    along the block's channels.
//  * Ragged S and D need no padding: channels >= D and steps >= S are
//    zero-filled in the ring and never stored.
//  * Each step rounds exp(log_a) * h and then the sum, as the plain version
//    does (no FMA contraction); expf is the accurate one (no fast math).
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int NC = 64;    // channels per block, one thread each
constexpr int TS = 16;    // time steps per slice
constexpr int RING = 4;   // slices in the ring (RING - 1 in flight)
constexpr int SLICE = 2 * TS * NC;  // floats of one slice: log_a, then b
constexpr size_t SMEM = static_cast<size_t>(RING) * SLICE * sizeof(float);

template <bool kVec>
__global__ void __launch_bounds__(NC)
    rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                 const float* __restrict__ h0, float* __restrict__ out, int S, int D) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [RING][2][TS][NC]
  const int tid = threadIdx.x, c0 = blockIdx.x * NC, d = c0 + tid;
  const size_t batch = blockIdx.y;
  const size_t base = batch * S * D + c0;
  const int live = min(NC, D - c0);  // channels of this block
  const int ns = (S + TS - 1) / TS;

  auto issue = [&](int g) {
    if (g < ns) {
      float* st = ring + (g % RING) * SLICE;
      const int t0 = g * TS;
      if constexpr (kVec) {
        for (int x = tid; x < SLICE / 4; x += NC) {
          const int arr = x / (TS * NC / 4), r = (x / (NC / 4)) % TS, c4 = (x % (NC / 4)) * 4;
          const bool valid = t0 + r < S && c4 < live;
          const float* src = (arr ? b : log_a) + base + static_cast<size_t>(t0 + r) * D + c4;
          cp_async16(st + (arr * TS + r) * NC + c4, valid ? src : log_a, valid);
        }
      } else {
        for (int x = tid; x < SLICE; x += NC) {
          const int arr = x / (TS * NC), r = (x / NC) % TS, cc = x % NC;
          const bool valid = t0 + r < S && cc < live;
          const float* src = (arr ? b : log_a) + base + static_cast<size_t>(t0 + r) * D + cc;
          cp_async4(st + (arr * TS + r) * NC + cc, valid ? src : log_a, valid);
        }
      }
    }
    cp_async_commit();
  };
  for (int g = 0; g < RING - 1; ++g) issue(g);

  float h = d < D ? h0[batch * D + d] : 0.f;
  float* o = out + base + tid;
  for (int g = 0; g < ns; ++g) {
    cp_async_wait<RING - 2>();
    __syncthreads();  // slice g landed; every thread is done with slice g - 1
    issue(g + RING - 1);
    const float* a_s = ring + (g % RING) * SLICE + tid;
    const float* b_s = a_s + TS * NC;
    const int t0 = g * TS;
    if (d >= D) continue;
    if (t0 + TS <= S) {
      float e[TS];
#pragma unroll
      for (int u = 0; u < TS; ++u) e[u] = expf(a_s[u * NC]);
#pragma unroll
      for (int u = 0; u < TS; ++u) {
        h = __fadd_rn(__fmul_rn(e[u], h), b_s[u * NC]);
        o[static_cast<size_t>(t0 + u) * D] = h;
      }
    } else {
      for (int u = 0; t0 + u < S; ++u) {
        h = __fadd_rn(__fmul_rn(expf(a_s[u * NC]), h), b_s[u * NC]);
        o[static_cast<size_t>(t0 + u) * D] = h;
      }
    }
  }
}

template <bool kVec>
int launch(const void* log_a, const void* b, const void* h0, void* out, int B, int S, int D,
           cudaStream_t stream) {
  const dim3 grid((D + NC - 1) / NC, B);
  rglru_kernel<kVec><<<grid, NC, SMEM, stream>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), S, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rglru_f32(const void* log_a, const void* b, const void* h0, void* out, int B, int S, int D,
              void* stream) {
  cudaGetLastError();
  if (B < 1 || B > 65535 || S < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned16(log_a, b))
    return launch<true>(log_a, b, h0, out, B, S, D, st);
  return launch<false>(log_a, b, h0, out, B, S, D, st);
}

}  // extern "C"
