// possibility_v: per-destination possibility traffic of the N-Rank planner.
//
//   V[c, d] = sum_s T[s, d] * [du[s, c] + offset + dn[c, d] == dist[s, d]]
//
// Replaces the TPU kernel repro/kernels/possibility/kernel.py:
// possibility_v_pallas (grid over channel blocks x source blocks, the sum
// carried across the source axis in the VMEM-resident output block).
//
// What bounds it on an H100: compute.  At N = C = 1024 the pass is
// C*N*N = 1.07e9 compare-and-add steps on 28 MB of operands: every T and
// dist element is reused C times and every du element N times, so the
// bytes are small against the work, and each step is an int32 add and
// compare plus an fp64 add (the fp64 rate is half the fp32 rate).
//
// What this simple design does about it: one thread per output (c, d)
// keeps its sum in a register, and the sequential source axis of the TPU
// grid becomes the loop inside the thread (blocks run in no order, so
// nothing may carry between them).  A block computes a 32 (d) x 32 (c)
// tile of V with 256 threads, four channels per thread, and stages one
// 32-row source chunk of T, dist and du through shared memory per step,
// so each global element is read once per tile.  d is the fastest thread
// index, so loads of T and dist rows coalesce.  The sum runs in fp64 in
// ascending s: with integer-valued T every partial sum is exact and V
// matches any other order bit for bit; otherwise it differs from the
// reference's einsum order only by rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kBD = 32;        // destinations per tile (threadIdx.x)
constexpr int kBC = 32;        // channels per tile
constexpr int kRows = 8;       // threadIdx.y
constexpr int kPerThread = kBC / kRows;
constexpr int kBS = 32;        // sources staged per step

__global__ void possibility_v_kernel(const int* __restrict__ du,
                                     const int* __restrict__ dn,
                                     const double* __restrict__ t,
                                     const int* __restrict__ dist,
                                     double* __restrict__ v,
                                     int n, int c, int offset) {
  __shared__ double ts[kBS][kBD];
  __shared__ int ds[kBS][kBD];
  __shared__ int dus[kBS][kBC + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kBD + tx;
  const int d = blockIdx.x * kBD + tx;
  const int cbase = blockIdx.y * kBC;

  int rhs[kPerThread];
  double acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int cc = cbase + ty * kPerThread + j;
    rhs[j] = (cc < c && d < n) ? dn[(long long)cc * n + d] + offset : 0;
    acc[j] = 0.0;
  }

  for (int s0 = 0; s0 < n; s0 += kBS) {
    // T and dist rows: padding rows carry T = 0, so a match there adds 0.
    for (int r = ty; r < kBS; r += kRows) {
      const int s = s0 + r;
      const bool in = s < n && d < n;
      ts[r][tx] = in ? t[(long long)s * n + d] : 0.0;
      ds[r][tx] = in ? dist[(long long)s * n + d] : 0;
    }
    for (int idx = tid; idx < kBS * kBC; idx += kBD * kRows) {
      const int r = idx / kBC;
      const int cc = idx % kBC;
      const int s = s0 + r;
      const int ch = cbase + cc;
      dus[r][cc] = (s < n && ch < c) ? du[(long long)s * c + ch] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kBS; ++r) {
      const double tv = ts[r][tx];
      const int dv = ds[r][tx];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (dus[r][ty * kPerThread + j] + rhs[j] == dv) acc[j] += tv;
      }
    }
    __syncthreads();
  }

  if (d < n) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int cc = cbase + ty * kPerThread + j;
      if (cc < c) v[(long long)cc * n + d] = acc[j];
    }
  }
}

}  // namespace

// du (N, C) int32, dn (C, N) int32, t (N, N) fp64, dist (N, N) int32 ->
// v (C, N) fp64, all contiguous on the device.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int possibility_v_launch(const int* du, const int* dn,
                                    const double* t, const int* dist,
                                    double* v, int n, int c, int offset,
                                    void* stream) {
  if (n <= 0 || c <= 0) return 0;
  dim3 block(kBD, kRows);
  dim3 grid((n + kBD - 1) / kBD, (c + kBC - 1) / kBC);
  possibility_v_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      du, dn, t, dist, v, n, c, offset);
  return (int)cudaGetLastError();
}
