// selective_scan_bwd: the gradient of Mamba's selective scan
// (csrc/selective_scan.cu) with respect to all of its inputs.
//
//   forward:  h_t = abar_t (.) h_{t-1} + (delta_t x_t) B_t,
//             abar_t = exp(delta_t A),  y_t = sum_n h_t[:, n] C_t[n]
//   backward, g_t = dL/dh_t:
//     g_S = dh_last + dy_S C_S;   g_t = abar_{t+1} (.) g_{t+1} + dy_t C_t
//     dC_t = sum_d dy_t h_t        dB_t = sum_d g_t delta_t x_t
//     dx_t = delta_t sum_n g_t B_t
//     ddelta_t = x_t sum_n g_t B_t + sum_n g_t h_{t-1} abar_t A
//     dA = sum_{b,t} g_t h_{t-1} abar_t delta_t;   dh0 = abar_1 (.) g_1
//
// delta, x, dy, ddelta, dx: (B, S, Di); A, dA: (Di, Ds); B, C, dB, dC:
// (B, S, Ds); h0, dh_last, dh0: (B, Di, Ds); all float32, contiguous.
// h0 and dh_last may be null (zeros).
//
// Replaces no TPU kernel.  The reference differentiates its Mamba layer
// through a jnp associative scan (repro/models/layers/recurrent.py:
// 110-123) and its Pallas scan (repro/kernels/mamba_scan/kernel.py:
// selective_scan_pallas) has no backward; the port's forward is this
// file's sibling, so its gradient is a kernel too, or training on the
// card would differentiate the plain twin's loop over S.
//
// What bounds it on an H100.  A training call (B 2, S 1024, Di 16384,
// Ds 16) has B*S*Di*Ds = 5.4e8 states.  Each is recomputed as the forward
// computes it (13 instructions: delta * A, a precise expf of eight, the
// update's two products and their sum) and walked back in 15 float
// instructions: g (a product and a sum), dC's and dB's terms and their
// sums over Di, g . B (a product and a sum), q = g h_{t-1} abar (two
// products), ddelta's and dA's terms (a product and a sum each) and
// abar (.) g.  28 instructions a state at one warp instruction a
// scheduler a clock: 0.45 ms, above the 0.67 GB of delta, x, dy read and
// ddelta, dx written (0.20 ms).  The kernel issues about twice that: the
// checkpoint sweep runs the recurrence once more, the walk recomputes
// abar rather than keep it (shared memory holds the states alone), and
// the reduce-scatter adds 31 shuffles, 31 sums and 62 selects a step a
// lane (8 a state at Ds 16).
//
// The design.  Walking back needs h_{t-1} at every step, and undoing the
// recurrence divides by abar, which is near 0 at Jamba's A = -1 .. -16.
// So, as the forward, one lane owns a (batch row, channel) pair with its
// Ds states, its row of A, its g and its dA in registers, a block of 128
// lanes covering 128 neighbouring channels of one row.  A first sweep
// runs the recurrence forward and stores the state at the start of every
// chunk of kChunk steps (the lane's own checkpoints, (B, chunks, Di, Ds)
// in device memory).  Then the chunks are taken last to first: a chunk's
// states are recomputed from its checkpoint into shared memory (each lane
// its own column, conflict free) and walked backwards step by step.
// dB_t and dC_t sum over Di: a lane's 2 Ds terms of a step (padded to 32)
// are summed over its warp by a reduce-scatter of shuffles (lane l ends
// with value l), over the block's four warps in shared memory after the
// chunk, in warp order, and written as the block's partials (Di / 128,
// B, S, 32); dA is each lane's sum over its S steps, (B, Di, Ds).  A
// second launch sums the partials over the channel blocks and dA over
// the rows, each in a fixed order: no atomics, the same bits every run.
// Ds is a template parameter (1 to 16) so the state stays in registers;
// a ragged Di is masked (a dead lane carries zeros through the
// shuffles).  Every recomputed state rounds as the forward's does
// (--fmad=false), so the walk sees the forward's own states.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;    // steps whose states a chunk keeps
constexpr int kTerms = 32;   // dB's Ds terms at 0.., dC's at 16..
constexpr int kReduceThreads = 256;

struct Args {
  const float* delta;
  const float* a;
  const float* bm;
  const float* cm;
  const float* x;
  const float* h0;       // null: zeros
  const float* dy;
  const float* dh_last;  // null: zeros
  float* ddelta;
  float* dx;
  float* dh0;
  float* ckpt;           // (B, chunks, Di, Ds)
  float* part_bc;        // (Di blocks, B, S, kTerms)
  float* part_a;         // (B, Di, Ds)
  int b, s, di, chunks;
};

// the forward's update, rounded as csrc/selective_scan.cu rounds it
__device__ __forceinline__ float update(float h, float ad, float b,
                                        float dx) {
  const float decayed = ad * h;
  const float driven = dx * b;
  return decayed + driven;
}

// one level of the reduce-scatter below: a lane keeps the half of its
// first 2 W values that its partner (lane ^ W) does not, in v[0, W), and
// adds the partner's copy of that half
template <int W>
__device__ __forceinline__ void fold(float (&v)[kTerms], int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// v[l] summed over the warp lands in lane l (every index a constant, so
// v stays in registers)
__device__ __forceinline__ float reduce_scatter(float (&v)[kTerms],
                                                int lane) {
  static_assert(kTerms == 32, "one value a lane");
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0];
}

template <int DS>
__global__ void __launch_bounds__(kThreads, 2)
    selective_scan_bwd_chunks(const Args g) {
  // sh[j][n][lane]: slot 0 the chunk's checkpoint h_{t0-1}, slot j + 1
  // the state after step t0 + j; red[warp][j][term]
  extern __shared__ __align__(16) float smem[];
  float* sh = smem;
  float* red = smem + (kChunk + 1) * DS * kThreads;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < g.di;
  const int s = g.s, di = g.di;
  const size_t hoff = ((size_t)row * di + d) * DS;

  float av[DS], h[DS], gd[DS], da[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    av[n] = live ? g.a[(size_t)d * DS + n] : 0.f;
    h[n] = live && g.h0 ? g.h0[hoff + n] : 0.f;
    gd[n] = live && g.dh_last ? g.dh_last[hoff + n] : 0.f;
    da[n] = 0.f;
  }
  auto at = [&](const float* p, int t) {   // (row, t, d) of a (B, S, Di)
    return live ? p[((size_t)row * s + t) * di + d] : 0.f;
  };
  auto ckpt = [&](int k) {
    return g.ckpt + (((size_t)row * g.chunks + k) * di + d) * DS;
  };

  // the forward sweep: the state at the start of every chunk
  for (int k = 0; k < g.chunks; ++k) {
    if (live) {
      float* ck = ckpt(k);
#pragma unroll
      for (int n = 0; n < DS; ++n) ck[n] = h[n];
    }
    if (k == g.chunks - 1) break;
    for (int t = k * kChunk; t < (k + 1) * kChunk; ++t) {
      const float dl = at(g.delta, t), dxv = dl * at(g.x, t);
      const float* brow = g.bm + ((size_t)row * s + t) * DS;
#pragma unroll
      for (int n = 0; n < DS; ++n)
        h[n] = update(h[n], expf(dl * av[n]), brow[n], dxv);
    }
  }

  // the chunks, last to first
  for (int k = g.chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk, len = min(kChunk, s - t0);
    if (live) {
      const float* ck = ckpt(k);
#pragma unroll
      for (int n = 0; n < DS; ++n) h[n] = ck[n];
    } else {
#pragma unroll
      for (int n = 0; n < DS; ++n) h[n] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < DS; ++n) sh[n * kThreads + tid] = h[n];
    for (int j = 0; j < len; ++j) {
      const int t = t0 + j;
      const float dl = at(g.delta, t), dxv = dl * at(g.x, t);
      const float* brow = g.bm + ((size_t)row * s + t) * DS;
      float* slot = sh + (j + 1) * DS * kThreads;
#pragma unroll
      for (int n = 0; n < DS; ++n) {
        h[n] = update(h[n], expf(dl * av[n]), brow[n], dxv);
        slot[n * kThreads + tid] = h[n];
      }
    }
    // h holds the state after the chunk's last step
    for (int j = len - 1; j >= 0; --j) {
      const int t = t0 + j;
      const size_t io = ((size_t)row * s + t) * di + d;
      const float dl = at(g.delta, t), xv = at(g.x, t), dyv = at(g.dy, t);
      const float dxv = dl * xv;
      const float* brow = g.bm + ((size_t)row * s + t) * DS;
      const float* crow = g.cm + ((size_t)row * s + t) * DS;
      const float* prev = sh + j * DS * kThreads;
      float terms[kTerms];
      float gb = 0.f, dsum = 0.f;
#pragma unroll
      for (int n = 0; n < DS; ++n) {
        const float hp = prev[n * kThreads + tid];   // h_{t-1}
        const float ad = expf(dl * av[n]);
        const float gn = gd[n] + dyv * crow[n];
        terms[kTerms / 2 + n] = dyv * h[n];           // dC_t
        terms[n] = gn * dxv;                          // dB_t
        gb = gb + gn * brow[n];
        const float q = gn * hp * ad;
        dsum = dsum + q * av[n];
        da[n] = da[n] + q * dl;
        gd[n] = ad * gn;
        h[n] = hp;
      }
#pragma unroll
      for (int n = DS; n < kTerms / 2; ++n) {
        terms[n] = 0.f;
        terms[kTerms / 2 + n] = 0.f;
      }
      if (live) {
        g.ddelta[io] = xv * gb + dsum;
        g.dx[io] = dl * gb;
      }
      red[(warp * kChunk + j) * kTerms + lane] = reduce_scatter(terms, lane);
    }
    __syncthreads();   // every warp's terms of the chunk
    for (int i = tid; i < len * kTerms; i += kThreads) {
      const int j = i / kTerms, v = i % kTerms;
      float sum = red[j * kTerms + v];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[(w * kChunk + j) * kTerms + v];
      g.part_bc[(((size_t)blockIdx.x * g.b + row) * s + t0 + j) * kTerms +
                v] = sum;
    }
    __syncthreads();   // red is free for the next chunk
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < DS; ++n) {
      g.dh0[hoff + n] = gd[n];     // abar_1 (.) g_1
      g.part_a[hoff + n] = da[n];
    }
  }
}

// dB and dC: the channel blocks' partials summed in block order; dA: the
// rows' sums in row order
__global__ void __launch_bounds__(kReduceThreads)
    selective_scan_bwd_reduce(const float* part_bc, const float* part_a,
                              float* db, float* dc, float* da, int blocks,
                              int b, int s, int di, int ds) {
  const size_t nbc = (size_t)b * s * ds, na = (size_t)di * ds;
  const size_t plane = (size_t)b * s * kTerms;   // one channel block's
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < 2 * nbc + na; i += (size_t)gridDim.x * blockDim.x) {
    if (i < 2 * nbc) {
      const bool is_c = i >= nbc;
      const size_t r = is_c ? i - nbc : i;
      const size_t at = (r / ds) * kTerms + (is_c ? kTerms / 2 : 0) + r % ds;
      float sum = part_bc[at];
      for (int k = 1; k < blocks; ++k) sum += part_bc[k * plane + at];
      (is_c ? dc : db)[r] = sum;
    } else {
      const size_t r = i - 2 * nbc;
      float sum = part_a[r];
      for (int row = 1; row < b; ++row) sum += part_a[row * na + r];
      da[r] = sum;
    }
  }
}

template <int DS>
int launch(const Args& g, float* db, float* dc, float* da,
           cudaStream_t st) {
  const int smem = ((kChunk + 1) * DS * kThreads + kWarps * kChunk * kTerms) *
                   (int)sizeof(float);
  static const cudaError_t set = cudaFuncSetAttribute(
      selective_scan_bwd_chunks<DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return (int)set;
  const int blocks = (g.di + kThreads - 1) / kThreads;
  selective_scan_bwd_chunks<DS><<<dim3(blocks, g.b), kThreads, smem, st>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = 2 * (size_t)g.b * g.s * DS + (size_t)g.di * DS;
  const size_t want = (total + kReduceThreads - 1) / kReduceThreads;
  const int grid = (int)(want < 65535 ? want : 65535);
  selective_scan_bwd_reduce<<<grid, kReduceThreads, 0, st>>>(
      g.part_bc, g.part_a, db, dc, da, blocks, g.b, g.s, g.di, DS);
  return (int)cudaGetLastError();
}

}  // namespace

// The chunk and partial sizes the caller allocates scratch for.
extern "C" int selective_scan_bwd_chunk() { return kChunk; }
extern "C" int selective_scan_bwd_threads() { return kThreads; }
extern "C" int selective_scan_bwd_terms() { return kTerms; }

extern "C" int selective_scan_bwd_launch(
    const float* delta, const float* a, const float* bm, const float* cm,
    const float* x, const float* h0, const float* dy, const float* dh_last,
    float* ddelta, float* da, float* db, float* dc, float* dx, float* dh0,
    float* ckpt, float* part_bc, float* part_a, int b, int s, int di, int ds,
    void* stream) {
  if (b <= 0 || s <= 0 || di <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const int chunks = (s + kChunk - 1) / kChunk;
  const Args g{delta, a,   bm,     cm,     x,       h0, dy, dh_last, ddelta,
               dx,    dh0, ckpt,   part_bc, part_a, b,  s,  di,      chunks};
  cudaStream_t st = (cudaStream_t)stream;
  switch (ds) {
#define CASE(N) \
  case N:       \
    return launch<N>(g, db, dc, da, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
