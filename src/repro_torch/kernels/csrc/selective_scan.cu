// selective_scan: Mamba's selective-scan recurrence over a sequence, from
// an initial state to the last one.
//
//   h_t = exp(delta_t * A) (.) h_{t-1} + (delta_t * x_t) B_t
//   y_t = sum_n h_t[:, n] C_t[n]
//
// delta, x, y: (B, S, Di); A: (Di, Ds); B, C: (B, S, Ds); h0, h_last:
// (B, Di, Ds); all float32, contiguous.  h0 may be null (zeros).
//
// Replaces the TPU kernel repro/kernels/mamba_scan/kernel.py:
// selective_scan_pallas (grid (batch, d_inner blocks, sequence chunks),
// the (block, Ds) state carried across the sequential chunk axis in VMEM
// scratch).  It computes the function of the reference's oracle,
// repro/kernels/mamba_scan/ref.py:selective_scan, which differs from that
// TPU kernel in two places: it starts from a given state h0 (the TPU
// kernel from zero) and returns the last state h_last besides y (the TPU
// kernel returns y only).  The port's Mamba layer needs both: the prefill
// leaves the state in the cache and every decode step resumes from it.
//
// What bounds it on an H100.  A prefill scan (B 4, S 2048, Di 16384, Ds
// 16) takes B*S*Di*Ds = 2.1e9 exponentials on the special-function units
// (16 a cycle per SM, about 4.2e12/s) and moves 1.6 GB of delta, x and y
// (0.48 ms at 3.35e12 B/s): both about half a millisecond, the
// exponentials a little more.  A decode step (S 1) only reads h0 and
// writes h_last: 8.4 MB, about 2.5 us.
//
// The design.  One thread owns one (batch row, channel) pair and keeps
// its Ds state values and its row of A in registers, so the state never
// leaves the chip between steps; the sequential chunk axis of the TPU
// grid becomes the thread's own loop over t.  A block of 128 threads
// covers 128 neighbouring channels of one batch row (the grid is
// (ceil(Di / 128), B); 512 blocks at the served shape), so each step's
// loads of delta and x and store of y are coalesced across the warp.
// B_t and C_t are the same for every channel of a row: the block stages
// them in shared memory for a chunk of 64 steps at a time.  Each step
// rounds as the plain twin does (built with --fmad=false, so no product
// is fused into an add): delta * A[n], expf (the full-precision one, not
// __expf), delta * x, the two products of the update, their sum, and y
// as a sum over n in a fixed order.  No atomics: every run gives the
// same bits.  Ds is a template parameter (1 to 16) so the state stays in
// registers; a ragged Di is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;   // steps whose B_t, C_t a block stages at once

template <int DS>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ delta,
                          const float* __restrict__ a,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ x,
                          const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ h_last,
                          int s, int di) {
  __shared__ float sb[kChunk * DS];
  __shared__ float sc[kChunk * DS];
  const int row = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;
  const size_t hoff = ((size_t)row * di + d) * DS;
  float av[DS], h[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    av[n] = live ? a[(size_t)d * DS + n] : 0.f;
    h[n] = (live && h0 != nullptr) ? h0[hoff + n] : 0.f;
  }
  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int len = min(kChunk, s - t0);
    const size_t first = (size_t)row * s + t0;   // (row, t0) in (B, S)
    __syncthreads();   // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < len * DS; i += kThreads) {
      sb[i] = bm[first * DS + i];
      sc[i] = cm[first * DS + i];
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const size_t off = (first + t) * di + d;
      const float dl = delta[off];
      const float dx = dl * x[off];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < DS; ++n) {
        const float ad = expf(dl * av[n]);
        const float decayed = ad * h[n];
        const float driven = dx * sb[t * DS + n];
        h[n] = decayed + driven;
        acc = acc + h[n] * sc[t * DS + n];
      }
      y[off] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < DS; ++n) h_last[hoff + n] = h[n];
  }
}

template <int DS>
int launch(const float* delta, const float* a, const float* bm,
           const float* cm, const float* x, const float* h0, float* y,
           float* h_last, int b, int s, int di, cudaStream_t st) {
  dim3 grid((di + kThreads - 1) / kThreads, b);
  selective_scan_kernel<DS><<<grid, kThreads, 0, st>>>(
      delta, a, bm, cm, x, h0, y, h_last, s, di);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_launch(const float* delta, const float* a,
                                     const float* bm, const float* cm,
                                     const float* x, const float* h0,
                                     float* y, float* h_last, int b, int s,
                                     int di, int ds, void* stream) {
  if (b <= 0 || s <= 0 || di <= 0 || b > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (ds) {
#define CASE(N) \
  case N:       \
    return launch<N>(delta, a, bm, cm, x, h0, y, h_last, b, s, di, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
