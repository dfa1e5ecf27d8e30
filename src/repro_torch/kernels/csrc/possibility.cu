// possibility: the N-Rank planner's two possibility passes, one
// compare-and-add core with two epilogues.
//
//   V[c, d]  = sum_s T[s, d] * [du[s, c] + offset + dn[c, d] == dist[s, d]]
//   W[c]     = sum_d V[c, d]                          (eq. 5, T float32)
//   W_drn[c] = sum_s tn[s, c] * [du[s, c] + offset == dsn[s, c]]   (eq. 7)
//
// Replaces the TPU kernels of repro/kernels/possibility/kernel.py:
// possibility_v_pallas (V, T fp64) and possibility_weights_pallas (W and
// W_drn, T float32), both a grid over channel blocks x source blocks with
// the sums carried across the source axis in VMEM-resident output blocks.
//
// What bounds it on an H100: instruction issue.  Every (s, c, d) triple
// needs an int32 add (du + dn + offset, on the FMA pipe), an int32
// compare (the ALU pipe) and an fp64 add of T where the predicate holds
// (the FP64 pipe; a predicated add issues whether or not it holds): three
// warp instructions a triple at one a scheduler a clock.  ptxas emits no
// predicated fp64 add, so this code spends a fourth, the compiler's cost:
// the select of a 0/1 factor's high word (the ALU pipe), the add then a
// fused multiply-add of that factor with T.  The predicate ties s, c and d together
// through dist[s, d], so the pass has no exact matrix-product form for
// the tensor cores (no wgmma, no TMA tiles): it is integer compare-and-add
// on the CUDA cores.  At N = C = 1024 that is 1.07e9 triples on 28 MB of
// operands, each T and dist element reused C times, each du element N.
//
// What the design does about it.
// - Register tiles: a thread holds TC channels x TD destinations and their
//   dn + offset values, so a staged source row costs a few 16-byte shared
//   loads for TC*TD triples and the rest is the triples' own four
//   instructions.  A warp is 4 (channel) x 8 (destination) lanes, a block 2 x 2
//   warps; kernel.possibility_layout picks the thread tile from the shape
//   (8 x 4 at N = 1024, smaller ones for enough warps at N = 256).
// - Staging: kRows source rows of du, dist and T go into one of two
//   shared buffers by cp.async while the other buffer is compared, 16
//   bytes a copy where every row is 16-byte aligned, else one element a
//   copy; the ragged edge is zero-filled by the copy itself, and the last
//   stage compares only its real rows.
// - V keeps an fp64 sum for each (c, d) and adds over ascending s, so its
//   bits depend on no tile or split: the one-thread-an-output kernel
//   this replaces gave the same bits for any T.
// - W keeps one fp64 sum a channel on the large tiles (V summed over the
//   thread's d as it goes; fewer registers) and one a (c, d) on the small
//   ones (no chain of dependent adds a row where a launch is short).
//   Blocks split the destinations: a block reduces its channels over its
//   warps' lanes (a fixed shuffle tree, then its warps in order) and
//   writes an fp64 partial per (destination tile, channel); a second
//   small launch sums the partials in tile order and rounds once to
//   float32.  With one destination tile (N <= the tile: 4x4, 5x5) the
//   block rounds and stores W itself: one launch.  W_drn, O(N * C), rides
//   in the same launch: one block a channel tile, placed first so that it
//   runs beside the tiles and not after them, reads du, dsn and tn
//   directly (staging them beside the tiles' rows cost a round trip a
//   stage at 5x5).  No atomics: two runs give the same bits.
// - W's float32 T is widened to fp64 in registers as a thread loads its TD
//   values of a row (TD conversions for TC*TD triples); converting the
//   staged rows once a block would cost a second barrier a stage for as
//   many instructions.

#include <cuda_runtime.h>

namespace {

constexpr int kLanesC = 4;   // a warp's lanes along channels
constexpr int kLanesD = 8;   // along destinations
constexpr int kWarpsC = 2;   // a block's warps along channels
constexpr int kWarpsD = 2;   // along destinations
constexpr int kThreads = 32 * kWarpsC * kWarpsD;
constexpr int kRows = 16;    // source rows a stage
constexpr int kStages = 2;   // stage buffers
constexpr int kNever = -(1 << 30);  // dn + offset of an absent (c, d)

template <int TC, int TD>
struct Tile {
  static constexpr int kC = kWarpsC * kLanesC * TC;  // channels a block
  static constexpr int kD = kWarpsD * kLanesD * TD;  // destinations a block
};

// One stage of staged rows.
template <int TC, int TD, typename TT>
struct __align__(16) Stage {
  TT t[kRows][Tile<TC, TD>::kD];
  int dist[kRows][Tile<TC, TD>::kD];
  int du[kRows][Tile<TC, TD>::kC];
};

struct Args {
  const int* du;       // (N, C)
  const int* dn;       // (C, N)
  const int* dsn;      // (N, C), W only
  const float* tn;     // (N, C), W only
  const void* t;       // (N, N) fp64 (V) or float32 (W)
  const int* dist;     // (N, N)
  double* out;         // V (C, N), or W's partials (tiles, C)
  float* w;            // (C,), W with one destination tile
  float* wdrn;         // (C,)
  int n, c, offset, vec;
  int tiles_d;         // destination tiles
  int drn_blocks;      // W: blocks before the tiles' that compute W_drn
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem(dst)), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem(dst)), "l"(src), "n"(B), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kRows x COLS elements from g (row stride ld) at (row0, col0) into dst;
// rows >= nr and columns >= nc are zero-filled.  vec: 16-byte copies
// (every row start 16-byte aligned).
template <int COLS, typename E>
__device__ __forceinline__ void stage_rows(E (*dst)[COLS], const E* g,
                                           int ld, int row0, int col0,
                                           int nr, int nc, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(E);
    constexpr int kPerRow = COLS / kVec;
#pragma unroll
    for (int it = 0; it < (kRows * kPerRow + kThreads - 1) / kThreads;
         ++it) {
      const int i = it * kThreads + threadIdx.x;
      if ((kRows * kPerRow) % kThreads != 0 && i >= kRows * kPerRow) break;
      const int r = i / kPerRow, q = (i % kPerRow) * kVec;
      const int valid = r < nr ? max(0, min(kVec, nc - q)) : 0;
      const E* src =
          valid ? g + (long long)(row0 + r) * ld + col0 + q : g;
      cp_async<16>(&dst[r][q], src, valid * (int)sizeof(E));
    }
  } else {
#pragma unroll
    for (int it = 0; it < (kRows * COLS + kThreads - 1) / kThreads; ++it) {
      const int i = it * kThreads + threadIdx.x;
      if ((kRows * COLS) % kThreads != 0 && i >= kRows * COLS) break;
      const int r = i / COLS, q = i % COLS;
      const bool in = r < nr && q < nc;
      const E* src = in ? g + (long long)(row0 + r) * ld + col0 + q : g;
      cp_async<sizeof(E)>(&dst[r][q], src, in ? (int)sizeof(E) : 0);
    }
  }
}

// K consecutive ints of a staged row, 16, 8 or 4 bytes a load.
template <int K>
__device__ __forceinline__ void load_ints(const int* p, int (&out)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const int4 v = *reinterpret_cast<const int4*>(p + q);
      out[q] = v.x, out[q + 1] = v.y, out[q + 2] = v.z, out[q + 3] = v.w;
    }
  } else if constexpr (K == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    static_assert(K == 1, "a thread tile side is 1, 2, 4 or 8");
    out[0] = *p;
  }
}

// K consecutive T values of a staged row, widened to fp64.
template <int K>
__device__ __forceinline__ void load_t(const double* p, double (&out)[K]) {
#pragma unroll
  for (int q = 0; q < K; q += 2) {
    const double2 v = *reinterpret_cast<const double2*>(p + q);
    out[q] = v.x, out[q + 1] = v.y;
  }
}

template <int K>
__device__ __forceinline__ void load_t(const float* p, double (&out)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      out[q] = v.x, out[q + 1] = v.y, out[q + 2] = v.z, out[q + 3] = v.w;
    }
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  }
}

// The core: one source row against the thread's TC x TD tile; AD = TD
// keeps a sum for each (c, d), AD = 1 one for each c.
template <int TC, int TD, int AD, typename TT>
__device__ __forceinline__ void compare_add(const int* du_row,
                                            const int* dist_row,
                                            const TT* t_row,
                                            const int (&rhs)[TC][TD],
                                            double (&acc)[TC][AD]) {
  int u[TC], k[TD];
  double tv[TD];
  load_ints<TC>(du_row, u);
  load_ints<TD>(dist_row, k);
  load_t<TD>(t_row, tv);
#pragma unroll
  for (int i = 0; i < TC; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      // acc + t where the predicate holds, else acc: the 0/1 factor is one
      // select of its high word and the sum one fused multiply-add, exact
      // as an add.  (A predicated add, even written in PTX, comes out of
      // ptxas as an add and two selects, one a word of the sum.)
      const double m = u[i] + rhs[i][j] == k[j] ? 1.0 : 0.0;
      double& sum = acc[i][AD == 1 ? 0 : j];
      sum = fma(m, tv[j], sum);
    }
}

// Two blocks an SM: the 8 x 4 tile then keeps its registers (the
// compiler spills at three blocks' budget and the pass runs slower).
// W_drn of the kC channels from c0 over every source, by one block: thread
// tid sums channel tid % kC over the sources s = tid / kC (mod kThreads /
// kC), then the block adds its phases in order.  O(N * C) loads in all,
// coalesced along the channels, off the tiles' path.
template <int kC>
__device__ __forceinline__ void drn_block(const Args& a, int c0,
                                          double* part) {
  constexpr int kPhases = kThreads / kC;
  const int tid = threadIdx.x, cc = tid % kC, ch = c0 + cc;
  double sum = 0.0;
  if (ch < a.c) {
#pragma unroll 4
    for (int s = tid / kC; s < a.n; s += kPhases) {
      const long long at = (long long)s * a.c + ch;
      if (__ldg(a.du + at) + a.offset == __ldg(a.dsn + at))
        sum += (double)__ldg(a.tn + at);
    }
  }
  part[tid] = sum;
  __syncthreads();
  if (tid < kC && ch < a.c) {
    double w = part[tid];
#pragma unroll
    for (int k = 1; k < kPhases; ++k) w += part[k * kC + tid];
    a.wdrn[ch] = __double2float_rn(w);
  }
}

// V: a grid of (destination tiles, channel tiles).  W: a row of blocks,
// first a.drn_blocks of W_drn, one a channel tile, then the tiles,
// destination tile fastest.
template <int TC, int TD, typename TT, bool kW>
__global__ void __launch_bounds__(kThreads, 2) possibility_kernel(Args a) {
  using Tl = Tile<TC, TD>;
  using St = Stage<TC, TD, TT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  St* st = reinterpret_cast<St*>(smem_raw);
  static_assert(sizeof(St) >= sizeof(double) * kThreads, "");

  int bx = blockIdx.x, by = blockIdx.y;
  if constexpr (kW) {
    if (bx < a.drn_blocks) {
      drn_block<Tl::kC>(a, bx * Tl::kC, reinterpret_cast<double*>(st));
      return;
    }
    by = (bx - a.drn_blocks) / a.tiles_d;
    bx = (bx - a.drn_blocks) % a.tiles_d;
  }
  const int n = a.n, c = a.c;
  const bool vec = a.vec != 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wd = warp % kWarpsD, wc = warp / kWarpsD;
  const int dl = (wd * kLanesD + lane % kLanesD) * TD;  // in the block tile
  const int cl = (wc * kLanesC + lane / kLanesD) * TC;
  const int bd0 = bx * Tl::kD, bc0 = by * Tl::kC;
  const TT* t = static_cast<const TT*>(a.t);

  // W needs only the sum over d: one accumulator a channel for the large
  // tiles (fewer registers), one a (c, d) for the small ones (no chain of
  // dependent adds a row where a launch is short)
  constexpr int kAccD = kW && TC * TD >= 16 ? 1 : TD;
  int rhs[TC][TD];
  double acc[TC][kAccD];
#pragma unroll
  for (int i = 0; i < TC; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int ch = bc0 + cl + i, d = bd0 + dl + j;
      rhs[i][j] = (ch < c && d < n)
                      ? a.dn[(long long)ch * n + d] + a.offset : kNever;
    }
#pragma unroll
  for (int i = 0; i < TC; ++i)
#pragma unroll
    for (int j = 0; j < kAccD; ++j) acc[i][j] = 0.0;

  const int stages = (n + kRows - 1) / kRows;
  auto issue = [&](int g) {
    St& s = st[g % kStages];
    const int s0 = g * kRows, nr = min(kRows, n - s0);
    stage_rows(s.du, a.du, c, s0, bc0, nr, c - bc0, vec);
    stage_rows(s.dist, a.dist, n, s0, bd0, nr, n - bd0, vec);
    stage_rows(s.t, t, n, s0, bd0, nr, n - bd0, vec);
  };

  // a group is committed every step, empty past the last stage, so that
  // waiting for all but kStages - 1 groups leaves stage g landed
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < stages) issue(g);
    cp_async_commit();
  }
  for (int g = 0; g < stages; ++g) {
    if (g + kStages - 1 < stages) issue(g + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const St& s = st[g % kStages];
    const int nr = min(kRows, n - g * kRows);
    if (nr == kRows) {
#pragma unroll 4
      for (int r = 0; r < kRows; ++r)
        compare_add<TC, TD, kAccD, TT>(&s.du[r][cl], &s.dist[r][dl],
                                       &s.t[r][dl], rhs, acc);
    } else {
#pragma unroll 1
      for (int r = 0; r < nr; ++r)
        compare_add<TC, TD, kAccD, TT>(&s.du[r][cl], &s.dist[r][dl],
                                       &s.t[r][dl], rhs, acc);
    }
    __syncthreads();
  }

  if constexpr (!kW) {
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const int ch = bc0 + cl + i;
      if (ch >= c) continue;
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        const int d = bd0 + dl + j;
        if (d < n) a.out[(long long)ch * n + d] = acc[i][j];
      }
    }
  } else {
    // the stage buffers are free now: reuse them for the block's sums
    double* red = reinterpret_cast<double*>(&st[0]);  // [kWarpsD][kC]
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      double ws = acc[i][0];
#pragma unroll
      for (int j = 1; j < kAccD; ++j) ws += acc[i][j];
#pragma unroll
      for (int off = 1; off < kLanesD; off <<= 1)
        ws += __shfl_xor_sync(0xffffffffu, ws, off);
      if (lane % kLanesD == 0) red[wd * Tl::kC + cl + i] = ws;
    }
    __syncthreads();
    if (tid < Tl::kC && bc0 + tid < c) {
      double ws = red[tid];
#pragma unroll
      for (int k = 1; k < kWarpsD; ++k) ws += red[k * Tl::kC + tid];
      const int ch = bc0 + tid;
      if (a.tiles_d == 1)
        a.w[ch] = __double2float_rn(ws);
      else
        a.out[(long long)bx * c + ch] = ws;
    }
  }
}

// W from the destination tiles' partials, in tile order.
__global__ void possibility_weights_sum(Args a) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= a.c) return;
  double ws = a.out[ch];
  for (int k = 1; k < a.tiles_d; ++k) ws += a.out[(long long)k * a.c + ch];
  a.w[ch] = __double2float_rn(ws);
}

// Thread tiles (channels, destinations) by configuration number; the
// Python side mirrors this table (kernel.THREAD_TILES).
template <typename TT, bool kW>
int launch(int cfg, Args& a, int gx, int gy, cudaStream_t stream) {
  int kc = 0, kd = 0, smem_bytes = 0;
  void (*kernel)(Args) = nullptr;
  switch (cfg) {
    case 0:
      kc = Tile<8, 4>::kC, kd = Tile<8, 4>::kD;
      smem_bytes = sizeof(Stage<8, 4, TT>);
      kernel = possibility_kernel<8, 4, TT, kW>;
      break;
    case 1:
      kc = Tile<4, 2>::kC, kd = Tile<4, 2>::kD;
      smem_bytes = sizeof(Stage<4, 2, TT>);
      kernel = possibility_kernel<4, 2, TT, kW>;
      break;
    case 2:
      kc = Tile<2, 2>::kC, kd = Tile<2, 2>::kD;
      smem_bytes = sizeof(Stage<2, 2, TT>);
      kernel = possibility_kernel<2, 2, TT, kW>;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  // the caller's grid must be the one this tile needs
  if (gx != (a.n + kd - 1) / kd || gy != (a.c + kc - 1) / kc)
    return (int)cudaErrorInvalidValue;
  const int bytes = kStages * smem_bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  a.tiles_d = gx;
  a.drn_blocks = kW ? gy : 0;
  const dim3 grid = kW ? dim3(a.drn_blocks + gx * gy) : dim3(gx, gy);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// du (N, C), dn (C, N), dist (N, N) int32, t (N, N) fp64 -> v (C, N)
// fp64, all contiguous on the device; cfg and the grid (destination
// tiles, channel tiles) from kernel.possibility_layout; vec: every row
// 16-byte aligned.  Launches on `stream`; returns cudaGetLastError().
extern "C" int possibility_v_launch(const int* du, const int* dn,
                                    const double* t, const int* dist,
                                    double* v, int n, int c, int offset,
                                    int cfg, int gx, int gy, int vec,
                                    void* stream) {
  if (n <= 0 || c <= 0) return 0;
  Args a{du, dn, nullptr, nullptr, t, dist, v, nullptr, nullptr,
         n,  c,  offset,  vec,     0, 0};
  return launch<double, false>(cfg, a, gx, gy, (cudaStream_t)stream);
}

// du, dsn (N, C) int32, dn (C, N) int32, tn (N, C) float32, t (N, N)
// float32, dist (N, N) int32 -> w, wdrn (C,) float32; part_w (gx, C) fp64
// scratch when gx > 1 (unused otherwise).  Two launches on `stream` when
// gx > 1 (the tiles, then their sum), else one.
extern "C" int possibility_weights_launch(
    const int* du, const int* dn, const int* dsn, const float* tn,
    const float* t, const int* dist, float* w, float* wdrn, double* part_w,
    int n, int c, int offset, int cfg, int gx, int gy, int vec,
    void* stream) {
  if (n <= 0 || c <= 0) return 0;
  if (gx > 1 && part_w == nullptr) return (int)cudaErrorInvalidValue;
  Args a{du, dn, dsn, tn, t, dist, part_w, w, wdrn, n, c, offset, vec, 0, 0};
  const int err = launch<float, true>(cfg, a, gx, gy, (cudaStream_t)stream);
  if (err || gx == 1) return err;
  possibility_weights_sum<<<(c + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
