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
// (B, S, Ds); dh_last, dh0: (B, Di, Ds); ckpt: (B, ceil(S / kChunk), Di,
// Ds), the forward kernel's states before every kChunk-th step (its
// checkpoint output; the first is h0); all float32, contiguous.  dh_last
// may be null (zeros).
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
// ddelta, dx written (0.20 ms).  The kernel issues more: dB/dC's sums
// over Di take a reduce-scatter of shuffles.
//
// The design.  Walking back needs h_{t-1} at every step, and undoing the
// recurrence divides by abar, which is near 0 at Jamba's A = -1 .. -16.
// So the walk starts from the forward's checkpoints, and the chunks are
// taken last to first: a chunk's states are recomputed from its
// checkpoint into shared memory, with abar_t beside them, and walked
// backwards step by step, the walk reading abar_t rather than taking the
// exponential again.  Both loops run kChunk steps at compile time (a
// chunk past S is padded with steps that change nothing), so the
// compiler interleaves the steps.  (A sweep of the recurrence here, in
// place of the forward's checkpoints, ran a second recurrence over every
// state; writing the checkpoints costs the forward 19 us on the H100.)
// * L = kLanes = 4 lanes share a (batch row, channel) pair: lane r
//   keeps states r NS .. r NS + NS - 1 (NS = ceil(Ds / L)), their A, g
//   and dA in registers and its own NS floats of each slot of the
//   chunk's states and abar in shared memory, as float4s (one
//   shared-memory instruction for four states).  A block of 64 L lanes
//   covers 64 neighbouring channels of one row, so a B 2 call has
//   L x 256 warps.  The sums over n for dx and ddelta take log2 L
//   shuffles.  Measured on an H100 at the training call, 4 lanes a
//   channel ran faster than 1 or 2 (PERF.md section 6 has the three
//   times; the forward, whose step has no sums over n, runs fastest at
//   one), so L stays a template parameter with the one instance.
// * The chunk's delta, x, dy, B, C and checkpoint reach shared memory by
//   cp.async while the previous chunk is walked (a ring of two stages).
// * dB_t and dC_t sum over Di: a lane's 2 NS terms of a step (padded to
//   32 / L) are summed over the warp's channels by a reduce-scatter of
//   shuffles (lane l ends with term l / L of state group l % L), over the
//   block's warps in shared memory after the chunk, in warp order, and
//   written as the block's partials (Di / 64, B, S, 32: dB's Ds at 0..,
//   dC's at 16..); dA is each lane's sum over its S steps, (B, Di, Ds).
//   A second launch sums the partials over the channel blocks and dA
//   over the rows, each in a fixed order: no atomics, the same bits
//   every run.
// * Ds is a template parameter (1 to 16) so the states stay in
//   registers; a lane's states past Ds hold zeros (A, B and C read as 0)
//   and are never stored; a ragged Di is masked (a dead lane carries
//   zeros through the shuffles).  Every recomputed state rounds as the
//   forward's does (--fmad=false: delta * A, expf, the two products and
//   their sum, each rounded), so the walk sees the forward's own states;
//   the walk's own arithmetic uses fused multiply-adds.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChannels = 64;   // channels a block
constexpr int kChunk = 8;       // steps a checkpoint starts
constexpr int kTerms = 32;      // dB's Ds terms at 0.., dC's at 16..
constexpr int kReduceThreads = 256;
constexpr int kLanes = 4;        // lanes a channel

struct Args {
  const float* delta;
  const float* a;
  const float* bm;
  const float* cm;
  const float* x;
  const float* dy;
  const float* dh_last;  // null: zeros
  const float* ckpt;     // (B, chunks, Di, Ds)
  float* ddelta;
  float* dx;
  float* dh0;
  float* part_bc;        // (Di / kChannels, B, S, kTerms)
  float* part_a;         // (B, Di, Ds)
  int b, s, di, chunks;
};

// the shared-memory layout of a block, in floats
template <int DS, int L>
struct Plan {
  static constexpr int kThreads = kChannels * L;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int NS = (DS + L - 1) / L;   // states a lane
  static constexpr int KT = kTerms / L;         // dB/dC terms a lane
  static_assert(2 * NS <= KT, "a lane's terms fit its share of the warp");
  static constexpr int RP = (L * NS + 3) / 4 * 4;  // a staged B or C row
  // a stage: delta, x, dy rows of the block's channels; B, C rows; each
  // lane's checkpoint
  static constexpr int kStage = 3 * kChunk * kChannels + 2 * kChunk * RP +
                                NS * kThreads;
  static constexpr int kStates = (kChunk + 1) * NS * kThreads;  // h
  static constexpr int kAbar = kChunk * NS * kThreads;
  static constexpr int kRed = kWarps * kChunk * 32;
  static constexpr size_t kSmem =
      sizeof(float) * (size_t(kStates) + kAbar + 2 * size_t(kStage) + kRed);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 4- and 16-byte copies; an invalid source is not read and its bytes are
// zeroed
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the forward's update, rounded as csrc/selective_scan.cu rounds it
__device__ __forceinline__ float update(float h, float ad, float b,
                                        float dx) {
  const float decayed = ad * h;
  const float driven = dx * b;
  return decayed + driven;
}

// one level of the reduce-scatter, and the levels below it: a lane keeps
// the half of its first 2 W values that its partner (lane ^ MASK) does
// not, in v[0, W), and adds the partner's copy of that half
template <int W, int MASK, int N>
__device__ __forceinline__ void fold(float (&v)[N], int lane) {
  const bool upper = lane & MASK;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
  if constexpr (W > 1) fold<W / 2, MASK / 2, N>(v, lane);
}

// a lane's NS values at p (its own NS consecutive floats of a [T][NS]
// array), as float4s where NS allows: one shared-memory instruction for
// four states
template <int NS>
__device__ __forceinline__ void store_lane(float* p, const float (&v)[NS]) {
  if constexpr (NS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NS; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) p[i] = v[i];
  }
}

// NS consecutive floats at row (a staged B or C row, or a lane's own
// states), as registers
template <int NS>
__device__ __forceinline__ void read_row(float (&out)[NS], const float* row) {
  if constexpr (NS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NS; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + i);
      out[i] = q.x;
      out[i + 1] = q.y;
      out[i + 2] = q.z;
      out[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) out[i] = row[i];
  }
}

template <int DS, int L>
__global__ void __launch_bounds__(Plan<DS, L>::kThreads)
    selective_scan_bwd_chunks(const Args g) {
  using C = Plan<DS, L>;
  constexpr int T = C::kThreads, NS = C::NS, KT = C::KT, RP = C::RP;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                 // [kChunk + 1][T][NS]: slot 0 h_{t0-1}
  float* ab = hs + C::kStates;      // [kChunk][T][NS]: abar_t
  float* stages = ab + C::kAbar;    // [2][kStage]
  float* red = stages + 2 * C::kStage;  // [warp][kChunk][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = tid / L, grp = tid % L;   // channel in the block, group
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int d = c0 + ch;
  const bool live = d < g.di;
  const int s = g.s, di = g.di;
  const int n0 = grp * NS;                 // this lane's first state
  const size_t hoff = ((size_t)row * di + d) * DS;

  float av[NS], h[NS], gd[NS], da[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const bool on = live && n0 + i < DS;
    av[i] = on ? g.a[(size_t)d * DS + n0 + i] : 0.f;
    gd[i] = on && g.dh_last ? g.dh_last[hoff + n0 + i] : 0.f;
    da[i] = 0.f;
  }

  // chunk k into stage buf: delta, x and dy of the block's channels, the
  // rows of B and C, and each lane's checkpoint; steps past S and
  // channels past Di read as 0
  auto stage = [&](int k, int buf) {
    float* st = stages + buf * C::kStage;
    const int t0 = k * kChunk;
    for (int i = tid; i < 3 * kChunk * kChannels; i += T) {
      const int a = i / (kChunk * kChannels), r = i % (kChunk * kChannels);
      const int t = t0 + r / kChannels, c = c0 + r % kChannels;
      const bool in = t < s && c < di;
      const float* src = a == 0 ? g.delta : a == 1 ? g.x : g.dy;
      cp_async4(st + i, src + (in ? ((size_t)row * s + t) * di + c : 0), in);
    }
    float* sb = st + 3 * kChunk * kChannels;
    for (int i = tid; i < 2 * kChunk * RP; i += T) {
      const int a = i / (kChunk * RP), r = i % (kChunk * RP);
      const int t = t0 + r / RP, n = r % RP;
      const bool in = t < s && n < DS;
      cp_async4(sb + i, (a ? g.cm : g.bm) + (in ? ((size_t)row * s + t) * DS + n
                                                : 0),
                in);
    }
    float* sk = sb + 2 * kChunk * RP + tid * NS;   // [T][NS]
    const float* ck = g.ckpt + (((size_t)row * g.chunks + k) * di + d) * DS + n0;
    if constexpr (NS % 4 == 0 && DS % 4 == 0) {
#pragma unroll
      for (int i = 0; i < NS; i += 4)
        cp_async16(sk + i, live ? ck + i : g.ckpt, live);
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const bool on = live && n0 + i < DS;
        cp_async4(sk + i, on ? ck + i : g.ckpt, on);
      }
    }
    cp_async_commit();
  };

  // the chunks, last to first.  Every chunk is walked as kChunk steps
  // (compile-time loops): steps past S were staged as zeros, and such a
  // step leaves h and g as they are (abar = exp(0) = 1, no drive, no dy)
  // and adds nothing; only its stores are skipped
  stage(g.chunks - 1, 0);
  for (int k = g.chunks - 1, it = 0; k >= 0; --k, ++it) {
    const int t0 = k * kChunk, len = min(kChunk, s - t0);
    if (k > 0) {
      stage(k - 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = stages + (it & 1) * C::kStage;
    const float* sdl = st;
    const float* sx = st + kChunk * kChannels;
    const float* sdy = st + 2 * kChunk * kChannels;
    const float* sb = st + 3 * kChunk * kChannels;
    const float* sc = sb + kChunk * RP;
    const float* sk = sc + kChunk * RP;

    // recompute the chunk's states and abar into shared memory, each
    // lane its own NS consecutive floats of a slot; the chunk's delta and
    // x stay in registers for the walk
    read_row<NS>(h, sk + tid * NS);
    store_lane<NS>(hs + tid * NS, h);
    float dls[kChunk], xs[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float dl = dls[j] = sdl[j * kChannels + ch];
      const float dxv = dl * (xs[j] = sx[j * kChannels + ch]);
      float bv[NS], ad[NS];
      read_row<NS>(bv, sb + j * RP + n0);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        ad[i] = expf(dl * av[i]);
        h[i] = update(h[i], ad[i], bv[i], dxv);
      }
      store_lane<NS>(hs + ((j + 1) * T + tid) * NS, h);
      store_lane<NS>(ab + (j * T + tid) * NS, ad);
    }
    // h holds the state after the chunk's last step; walk back
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const int t = t0 + j;
      const float dl = dls[j], xv = xs[j];
      const float dyv = sdy[j * kChannels + ch];
      const float dxv = dl * xv;
      float bv[NS], cv[NS], prev[NS], abar[NS];
      read_row<NS>(bv, sb + j * RP + n0);
      read_row<NS>(cv, sc + j * RP + n0);
      read_row<NS>(prev, hs + (j * T + tid) * NS);   // h_{t-1}
      read_row<NS>(abar, ab + (j * T + tid) * NS);
      float terms[KT];
      float gb = 0.f, dsum = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float gn = __fmaf_rn(dyv, cv[i], gd[i]);
        terms[NS + i] = dyv * h[i];            // dC_t
        terms[i] = gn * dxv;                   // dB_t
        gb = __fmaf_rn(gn, bv[i], gb);
        gd[i] = abar[i] * gn;
        const float q = gd[i] * prev[i];       // g h_{t-1} abar
        dsum = __fmaf_rn(q, av[i], dsum);
        da[i] = __fmaf_rn(q, dl, da[i]);
        h[i] = prev[i];
      }
#pragma unroll
      for (int i = 2 * NS; i < KT; ++i) terms[i] = 0.f;
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {   // over the channel's lanes
        gb += __shfl_xor_sync(0xffffffffu, gb, off);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
      }
      if (live && grp == 0 && j < len) {
        const size_t io = ((size_t)row * s + t) * di + d;
        g.ddelta[io] = __fmaf_rn(xv, gb, dsum);
        g.dx[io] = dl * gb;
      }
      fold<KT / 2, 16, KT>(terms, lane);
      red[(warp * kChunk + j) * 32 + lane] = terms[0];
    }
    __syncthreads();   // every warp's terms of the chunk
    for (int i = tid; i < len * 32; i += T) {
      const int j = i / 32, l = i % 32;
      float sum = red[j * 32 + l];
#pragma unroll
      for (int w = 1; w < C::kWarps; ++w) sum += red[(w * kChunk + j) * 32 + l];
      // lane l of each warp summed term l / L of state group l % L
      const int tau = l / L, n = (l % L) * NS + tau % NS;
      if (tau < 2 * NS && n < DS)
        g.part_bc[(((size_t)blockIdx.x * g.b + row) * s + t0 + j) * kTerms +
                  (tau < NS ? 0 : kTerms / 2) + n] = sum;
    }
    __syncthreads();   // red and the stage are free
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (n0 + i < DS) {
        g.dh0[hoff + n0 + i] = gd[i];     // abar_1 (.) g_1
        g.part_a[hoff + n0 + i] = da[i];
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

template <int DS, int L>
int launch(const Args& g, float* db, float* dc, float* da, cudaStream_t st) {
  using C = Plan<DS, L>;
  static const cudaError_t set = cudaFuncSetAttribute(
      selective_scan_bwd_chunks<DS, L>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (set != cudaSuccess) return (int)set;
  const int blocks = (g.di + kChannels - 1) / kChannels;
  selective_scan_bwd_chunks<DS, L>
      <<<dim3(blocks, g.b), C::kThreads, C::kSmem, st>>>(g);
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

// The chunk (which the forward's checkpoints must match), channel-block
// and partial sizes the caller allocates for.
extern "C" int selective_scan_bwd_chunk() { return kChunk; }
extern "C" int selective_scan_bwd_channels() { return kChannels; }
extern "C" int selective_scan_bwd_terms() { return kTerms; }

extern "C" int selective_scan_bwd_launch(
    const float* delta, const float* a, const float* bm, const float* cm,
    const float* x, const float* ckpt, const float* dy, const float* dh_last,
    float* ddelta, float* da, float* db, float* dc, float* dx, float* dh0,
    float* part_bc, float* part_a, int b, int s, int di, int ds,
    void* stream) {
  if (b <= 0 || s <= 0 || di <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const int chunks = (s + kChunk - 1) / kChunk;
  const Args g{delta, a,   bm,      cm,     x, dy, dh_last, ckpt, ddelta,
               dx,    dh0, part_bc, part_a, b, s,  di,      chunks};
  cudaStream_t st = (cudaStream_t)stream;
  switch (ds) {
#define CASE(N) \
  case N:       \
    return launch<N, kLanes>(g, db, dc, da, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
