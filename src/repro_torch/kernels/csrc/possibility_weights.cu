// possibility_weights: the N-Rank possibility (eq. 5) and draining (eq. 7)
// weights of every channel.
//
//   W[c]     = sum_{s,d} T[s, d] * [du[s, c] + offset + dn[c, d] == dist[s, d]]
//   W_drn[c] = sum_s     tn[s, c] * [du[s, c] + offset == dsn[s, c]]
//
// Replaces the TPU kernel repro/kernels/possibility/kernel.py:
// possibility_weights_pallas (grid over channel blocks x source blocks,
// both sums carried across the source axis in VMEM-resident output blocks).
//
// What bounds it on an H100: compute.  At mesh2d(32, 32) (N = 1024,
// C = 3968) W is C*N*N = 4.2e9 compare-and-add steps on ~40 MB of operands:
// each T and dist element is reused C times, so bytes are small against
// the work.  Each step is an int32 add and compare (the int32 pipe runs at
// a quarter of the fp32 rate) and a predicated fp64 add.
//
// What this simple design does about it.  Blocks run in no order, so the
// sequential source axis of the TPU grid becomes a loop inside the block,
// and nothing is carried between blocks: a block owns a tile of kBC
// channels and produces their final W and W_drn.  Its 256 threads are
// kRows warps; lane tx of warp ty keeps fp64 sums for kPerThread channels
// over destinations d = d0 + tx.  For each 32-wide destination tile the
// block walks the sources in 32-row chunks, staging T, dist and du through
// shared memory, so each T and dist element is read once per channel tile
// and not once per channel.  After the last tile each warp folds its 32
// lanes with a fixed shuffle tree.  W_drn is O(N*C) and takes a first pass
// over the same source chunks, lane tx summing sources s = tx (mod 32).
// Every sum runs in fp64 in a fixed order with no atomics, so every run
// gives the same bits; W and W_drn are rounded once to float32, the
// reference op's output type.

#include <cuda_runtime.h>

namespace {

constexpr int kBD = 32;        // destinations per tile (threadIdx.x, a warp)
constexpr int kRows = 8;       // warps per block (threadIdx.y)
constexpr int kPerThread = 2;  // channels per warp
constexpr int kBC = kRows * kPerThread;  // channels per block
constexpr int kBS = 32;        // sources staged per step

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;  // lane 0 holds the sum
}

__global__ void possibility_weights_kernel(
    const int* __restrict__ du, const int* __restrict__ dn,
    const int* __restrict__ dsn, const float* __restrict__ tn,
    const float* __restrict__ t, const int* __restrict__ dist,
    float* __restrict__ w, float* __restrict__ wdrn,
    int n, int c, int offset) {
  __shared__ float ts[kBS][kBD];
  __shared__ int ds[kBS][kBD];
  __shared__ int dus[kBS][kBC + 1];
  __shared__ int dsns[kBS][kBC + 1];
  __shared__ float tns[kBS][kBC + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kBD + tx;
  const int cbase = blockIdx.x * kBC;

  // ---- W_drn: lane tx takes source row tx of every chunk ---- //
  double drn[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) drn[j] = 0.0;
  for (int s0 = 0; s0 < n; s0 += kBS) {
    for (int idx = tid; idx < kBS * kBC; idx += kBD * kRows) {
      const int r = idx / kBC;
      const int cc = idx % kBC;
      const int s = s0 + r;
      const int ch = cbase + cc;
      const bool in = s < n && ch < c;
      const long long at = (long long)s * c + ch;
      dus[r][cc] = in ? du[at] : 0;
      dsns[r][cc] = in ? dsn[at] : -1;   // padding never matches
      tns[r][cc] = in ? tn[at] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int cc = ty * kPerThread + j;
      if (dus[tx][cc] + offset == dsns[tx][cc]) drn[j] += (double)tns[tx][cc];
    }
    __syncthreads();
  }

  // ---- W: destination tiles x source chunks ---- //
  double acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.0;
  for (int d0 = 0; d0 < n; d0 += kBD) {
    const int d = d0 + tx;
    int rhs[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int ch = cbase + ty * kPerThread + j;
      // an out-of-range (channel, d) never matches: dist >= 0 > rhs + du
      rhs[j] = (ch < c && d < n) ? dn[(long long)ch * n + d] + offset
                                 : -(1 << 30);
    }
    for (int s0 = 0; s0 < n; s0 += kBS) {
      // padding rows and columns carry T = 0, so a match there adds 0
      for (int r = ty; r < kBS; r += kRows) {
        const int s = s0 + r;
        const bool in = s < n && d < n;
        ts[r][tx] = in ? t[(long long)s * n + d] : 0.0f;
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
        const double tv = (double)ts[r][tx];
        const int dv = ds[r][tx];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          if (dus[r][ty * kPerThread + j] + rhs[j] == dv) acc[j] += tv;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const double wsum = warp_sum(acc[j]);
    const double dsum = warp_sum(drn[j]);
    const int ch = cbase + ty * kPerThread + j;
    if (tx == 0 && ch < c) {
      w[ch] = __double2float_rn(wsum);
      wdrn[ch] = __double2float_rn(dsum);
    }
  }
}

}  // namespace

// du, dsn (N, C) int32, dn (C, N) int32, tn (N, C) float32, t (N, N)
// float32, dist (N, N) int32 -> w, wdrn (C,) float32, all contiguous on the
// device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int possibility_weights_launch(const int* du, const int* dn,
                                          const int* dsn, const float* tn,
                                          const float* t, const int* dist,
                                          float* w, float* wdrn, int n, int c,
                                          int offset, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  dim3 block(kBD, kRows);
  dim3 grid((c + kBC - 1) / kBC);
  possibility_weights_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      du, dn, dsn, tn, t, dist, w, wdrn, n, c, offset);
  return (int)cudaGetLastError();
}
