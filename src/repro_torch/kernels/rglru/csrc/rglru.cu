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
//  * One thread per (batch, channel), walking the whole time axis with the
//    carry in a register: the TPU kernel's sequential time grid axis and its
//    VMEM carry become this loop.  Neighbouring threads take neighbouring
//    channels, so every load and store of a time step is coalesced along D.
//  * The walk loads U = 16 steps of log_a and b before it uses any of them,
//    so each thread keeps 32 loads in flight; with B x D threads in all (8 x
//    2560 at recurrentgemma-2b's width, ~5 warps an SM) that is what keeps
//    the memory busy.  Splitting time across threads (a chunked scan with a
//    carry fix-up pass) is later work.
//  * Ragged S and D need no padding: the last block masks channels >= D and
//    the walk ends at S.
//  * Each step rounds exp(log_a) * h and then the sum, as the plain version
//    does (no FMA contraction); expf is the accurate one (no fast math).
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;  // channels per block
constexpr int U = 16;    // time steps loaded ahead

__global__ void __launch_bounds__(NT)
    rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                 const float* __restrict__ h0, float* __restrict__ out, int S, int D) {
  const int d = blockIdx.x * NT + threadIdx.x;
  if (d >= D) return;
  const size_t batch = blockIdx.y;
  const size_t base = batch * S * D + d;
  float h = h0[batch * D + d];
  int t = 0;
  for (; t + U <= S; t += U) {
    float a[U], x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t at = base + static_cast<size_t>(t + u) * D;
      a[u] = log_a[at];
      x[u] = b[at];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = __fadd_rn(__fmul_rn(expf(a[u]), h), x[u]);
      out[base + static_cast<size_t>(t + u) * D] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t at = base + static_cast<size_t>(t) * D;
    h = __fadd_rn(__fmul_rn(expf(log_a[at]), h), b[at]);
    out[at] = h;
  }
}

}  // namespace

extern "C" {

int rglru_f32(const void* log_a, const void* b, const void* h0, void* out, int B, int S, int D,
              void* stream) {
  cudaGetLastError();
  const dim3 grid((D + NT - 1) / NT, B);
  rglru_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), S, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
