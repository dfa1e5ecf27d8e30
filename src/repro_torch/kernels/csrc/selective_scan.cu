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
// 16) updates B*S*Di*Ds = 2.1e9 states.  Each update rounds as the plain
// twin does (built with --fmad=false): delta * A[n], a precise expf (one
// MUFU.EX2 and seven float and integer instructions around it), the
// update's two products and their sum; y takes one fused multiply-add a
// state (__fmaf_rn, which --fmad=false leaves fused).  13 instructions a
// state, so the bound is instruction issue (one warp instruction a
// scheduler a clock: 0.84 ms), above the f32 pipes (0.71 ms), the 16
// exponentials a clock an SM (0.51 ms) and the 1.6 GB of delta, x and y
// (0.48 ms).  A decode step (S 1) moves h0 and h_last, 8.4 MB (3 us).
//
// The design.  One lane owns a (batch row, channel) pair: its Ds states
// and its row of A sit in registers as up to four float4s, so the state
// never leaves the chip between steps; a block of 128 lanes covers 128
// neighbouring channels of one row.  The sequence is cut into chunks of
// kChunk steps.  delta and x (the block's channels) and B and C (one row
// a step) of chunk k + 1 are copied into shared memory with cp.async
// while chunk k is computed, a ring of two stages, so no step waits on
// device memory; a step reads B_t and C_t as float4s.  y_t goes to shared
// memory, and the chunk's y leaves as whole rows of float4s after a
// barrier.  A decode step (S 1) is a chunk of one step.  Measured on the
// card, splitting the state over 2 or 4 lanes (for 32 or 64 warps an SM)
// ran slower: each lane repeats the step's loads and its share of y, and
// the kernel issues its instructions no faster with more warps.  Every
// state rounds as the twin's does, so h_last equals it bit for bit; y
// sums over the state in state order with one rounding a term, the twin
// in another order, within 1e-5 of its largest value.  Ds is a template
// parameter (1 to 16) so the state stays in registers; spare states (Ds
// not a multiple of 4) hold zeros and are never stored; a ragged Di is
// masked, and pointers not 16-byte aligned take 4-byte copies and loads.
// For training, a second instance (CKPT) also stores the state at the
// start of every kCkptChunk steps, the checkpoints the backward
// (selective_scan_bwd.cu) walks back from, so that it runs no sweep of
// its own; serving's instance stores nothing more.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;      // steps a stage holds
constexpr int kMinBlocks = 4;   // 16 warps an SM: 128 registers a thread
constexpr int kCkptChunk = 8;   // the backward's chunk (selective_scan_bwd.cu)

// A row of Ds states as kN float4s.  A staged row of B or C is kPitch
// floats, the states past Ds zeros.
template <int DS>
struct Quads {
  static constexpr int kN = (DS + 3) / 4;
  static constexpr int kPitch = 4 * kN;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// copies of 16 or 4 bytes; an invalid source is not read and its bytes
// are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// states 4q .. 4q + 3 of a row of DS floats; those past DS read as 0
template <int DS>
__device__ __forceinline__ float4 load_quad(const float* row, int q,
                                            bool live, bool aligned) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  const int n = 4 * q;
  if (!live || n >= DS) return v;
  if (DS % 4 == 0 && aligned) return *reinterpret_cast<const float4*>(row + n);
  v.x = row[n];
  if (n + 1 < DS) v.y = row[n + 1];
  if (n + 2 < DS) v.z = row[n + 2];
  if (n + 3 < DS) v.w = row[n + 3];
  return v;
}

template <int DS>
__device__ __forceinline__ void store_quad(float* row, int q, float4 v,
                                           bool aligned) {
  const int n = 4 * q;
  if (n >= DS) return;
  if (DS % 4 == 0 && aligned) {
    *reinterpret_cast<float4*>(row + n) = v;
    return;
  }
  row[n] = v.x;
  if (n + 1 < DS) row[n + 1] = v.y;
  if (n + 2 < DS) row[n + 2] = v.z;
  if (n + 3 < DS) row[n + 3] = v.w;
}

// one state's update, rounded as the twin rounds it: delta * A, its exp,
// the two products of the update and their sum, one at a time
__device__ __forceinline__ float update(float h, float a, float b, float dl,
                                        float dx) {
  const float ad = expf(dl * a);
  const float decayed = ad * h;
  const float driven = dx * b;
  return decayed + driven;
}

// a lane's NV float4s of state one step on (b, c: the step's B and C
// rows); returns y_t, one fused multiply-add a state in state order
template <int NV>
__device__ __forceinline__ float step(float4 (&h)[NV], const float4 (&a)[NV],
                                      const float4* b, const float4* c,
                                      float dl, float dx) {
  float acc = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 bq = b[v], cq = c[v];
    h[v].x = update(h[v].x, a[v].x, bq.x, dl, dx);
    h[v].y = update(h[v].y, a[v].y, bq.y, dl, dx);
    h[v].z = update(h[v].z, a[v].z, bq.z, dl, dx);
    h[v].w = update(h[v].w, a[v].w, bq.w, dl, dx);
    acc = __fmaf_rn(h[v].x, cq.x, acc);
    acc = __fmaf_rn(h[v].y, cq.y, acc);
    acc = __fmaf_rn(h[v].z, cq.z, acc);
    acc = __fmaf_rn(h[v].w, cq.w, acc);
  }
  return acc;
}

struct Args {
  const float* delta;
  const float* a;
  const float* bm;
  const float* cm;
  const float* x;
  const float* h0;   // null: zeros
  float* y;
  float* h_last;
  float* ckpt;       // (B, ceil(S / kCkptChunk), Di, Ds); CKPT only
  int s, di;
  bool aligned;      // every pointer on 16 bytes
};

// S steps, the inputs staged a chunk ahead; one lane a (row, channel)
// pair.  Grid (Di / kThreads, B).  With CKPT, the state before every
// kCkptChunk-th step goes to g.ckpt.
template <int DS, bool CKPT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    selective_scan_staged(const Args g) {
  constexpr int NV = Quads<DS>::kN, P = Quads<DS>::kPitch;
  // a row of the block's delta, x or y is kQuadsRow float4s; the block
  // moves kRows rows at once
  constexpr int kQuadsRow = kThreads / 4, kRows = kThreads / kQuadsRow;
  __shared__ __align__(16) float sdl[2][kChunk][kThreads];
  __shared__ __align__(16) float sx[2][kChunk][kThreads];
  __shared__ __align__(16) float sb[2][kChunk][P];
  __shared__ __align__(16) float sc[2][kChunk][P];
  __shared__ __align__(16) float sy[kChunk][kThreads];

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * kThreads;
  const int d = c0 + tid;
  const bool live = d < g.di;
  const int s = g.s, di = g.di;
  const bool vec_dx = g.aligned && di % 4 == 0;
  const bool vec_bc = g.aligned && DS == P;

  if (DS != P) {   // the pad columns of B and C are never copied: zeros
    for (int i = tid; i < 2 * kChunk * (P - DS); i += kThreads) {
      const int r = i / (P - DS), n = DS + i % (P - DS);
      (&sb[0][0][0])[r * P + n] = 0.f;
      (&sc[0][0][0])[r * P + n] = 0.f;
    }
  }

  // chunk [t0, t0 + len) into stage buf: the block's channels of delta
  // and x, the rows of B and C
  auto stage = [&](int buf, int t0, int len) {
    const size_t first = (size_t)row * s + t0;   // (row, t0) in (B, S)
    if (vec_dx) {   // a thread copies 16 bytes of every kRows-th row
      const int q = 4 * (tid % kQuadsRow);
      const bool in = c0 + q < di;
      const size_t off = in ? (first + tid / kQuadsRow) * di + c0 + q : 0;
      const size_t jump = in ? (size_t)kRows * di : 0;
      const float* pd = g.delta + off;
      const float* px = g.x + off;
      for (int t = tid / kQuadsRow; t < len; t += kRows) {
        cp_async16(&sdl[buf][t][q], pd, in);
        cp_async16(&sx[buf][t][q], px, in);
        pd += jump;
        px += jump;
      }
    } else {
      for (int i = tid; i < len * kThreads; i += kThreads) {
        const int t = i / kThreads, q = i % kThreads;
        const bool in = c0 + q < di;
        const size_t off = in ? (first + t) * di + c0 + q : 0;
        cp_async4(&sdl[buf][t][q], g.delta + off, in);
        cp_async4(&sx[buf][t][q], g.x + off, in);
      }
    }
    if (vec_bc) {   // DS == P: the chunk's rows are one contiguous run
      for (int i = tid; i < len * DS / 4; i += kThreads) {
        cp_async16(&sb[buf][0][0] + 4 * i, g.bm + first * DS + 4 * i, true);
        cp_async16(&sc[buf][0][0] + 4 * i, g.cm + first * DS + 4 * i, true);
      }
    } else {
      for (int i = tid; i < len * DS; i += kThreads) {
        const int t = i / DS, n = i % DS;
        cp_async4(&sb[buf][t][n], g.bm + first * DS + i, true);
        cp_async4(&sc[buf][t][n], g.cm + first * DS + i, true);
      }
    }
    cp_async_commit();
  };

  const size_t hoff = ((size_t)row * di + d) * DS;
  float4 av[NV], h[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    av[v] = load_quad<DS>(g.a + (size_t)d * DS, v, live, g.aligned);
    h[v] = load_quad<DS>(g.h0 + hoff, v, live && g.h0 != nullptr, g.aligned);
  }
  stage(0, 0, min(kChunk, s));
  for (int t0 = 0, buf = 0; t0 < s; t0 += kChunk, buf ^= 1) {
    const int len = min(kChunk, s - t0);
    cp_async_wait_all();   // this chunk, issued a chunk ago
    __syncthreads();       // ... for every thread; the other stage and sy
                           // are free
    if (t0 + kChunk < s)
      stage(buf ^ 1, t0 + kChunk, min(kChunk, s - t0 - kChunk));
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      if constexpr (CKPT) {
        if ((t0 + t) % kCkptChunk == 0 && live) {
          const int chunks = (s + kCkptChunk - 1) / kCkptChunk;
          float* ck = g.ckpt + (((size_t)row * chunks + (t0 + t) / kCkptChunk)
                                * di + d) * DS;
#pragma unroll
          for (int v = 0; v < NV; ++v) store_quad<DS>(ck, v, h[v], g.aligned);
        }
      }
      const float dl = sdl[buf][t][tid];
      const float dx = dl * sx[buf][t][tid];
      sy[t][tid] = step<NV>(h, av,
                            reinterpret_cast<const float4*>(&sb[buf][t][0]),
                            reinterpret_cast<const float4*>(&sc[buf][t][0]),
                            dl, dx);
    }
    __syncthreads();       // the chunk's y, written out as whole rows
    const size_t first = (size_t)row * s + t0;
    const int q = 4 * (tid % kQuadsRow);
    if (vec_dx && c0 + q < di) {
      float* py = g.y + (first + tid / kQuadsRow) * di + c0 + q;
      for (int t = tid / kQuadsRow; t < len; t += kRows) {
        *reinterpret_cast<float4*>(py) =
            *reinterpret_cast<const float4*>(&sy[t][q]);
        py += (size_t)kRows * di;
      }
    } else if (!vec_dx && live) {
      for (int t = 0; t < len; ++t) g.y[(first + t) * di + d] = sy[t][tid];
    }
  }
  if (live) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      store_quad<DS>(g.h_last + hoff, v, h[v], g.aligned);
  }
}

template <int DS>
int launch(const Args& g, int b, cudaStream_t st) {
  dim3 grid((g.di + kThreads - 1) / kThreads, b);
  if (g.ckpt)
    selective_scan_staged<DS, true><<<grid, kThreads, 0, st>>>(g);
  else
    selective_scan_staged<DS, false><<<grid, kThreads, 0, st>>>(g);
  return (int)cudaGetLastError();
}

bool on16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// ckpt: null, or (B, ceil(S / 8), Di, Ds) float32 for the state at the
// start of every 8 steps (the backward's checkpoints).
extern "C" int selective_scan_ckpt_chunk() { return kCkptChunk; }

extern "C" int selective_scan_launch(const float* delta, const float* a,
                                     const float* bm, const float* cm,
                                     const float* x, const float* h0,
                                     float* y, float* h_last, float* ckpt,
                                     int b, int s, int di, int ds,
                                     void* stream) {
  if (b <= 0 || s <= 0 || di <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const Args g{delta, a, bm, cm, x, h0, y, h_last, ckpt, s, di,
               on16(delta) && on16(a) && on16(bm) && on16(cm) && on16(x) &&
                   on16(h0) && on16(y) && on16(h_last) && on16(ckpt)};
  cudaStream_t st = (cudaStream_t)stream;
  switch (ds) {
#define CASE(N) \
  case N:       \
    return launch<N>(g, b, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Never launched: chip_smoke.py reads their machine code (cuobjdump -sass)
// to count the instructions of one precise expf as this library builds
// it, the first less the second.
extern "C" __global__ void scan_probe_expf(const float* in, float* out) {
  out[threadIdx.x] = expf(in[threadIdx.x]);
}
extern "C" __global__ void scan_probe_copy(const float* in, float* out) {
  out[threadIdx.x] = in[threadIdx.x];
}
