// flash_attention: forward attention with an online softmax, causal or
// full, GQA, with an optional per-row valid key length.
//
//   o[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,g,:] * scale) v[b,j,g,:]
//   over keys j < lim(b, i), g = h / (H / KV), q and k of head dim D, v
//   and o of head dim DV <= D (MLA: D 96, DV 64), where
//   lim(b, i) = min(Skv, len[b] or len[b, i], i + (Skv - Sq) + 1 if causal)
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (grid (B*H, q blocks, kv blocks), the (m, l, acc)
// state carried across the sequential kv axis in VMEM scratch).  It
// computes the function of the reference's oracle, flash_attention_ref
// (repro/models/layers/attention.py), which differs from that TPU kernel
// in two places: the causal diagonal is aligned at the end (Skv - Sq), and
// keys past the true Skv never count (the TPU wrapper pads K/V to a block
// multiple and the kernel then counts the zero keys).  The valid length
// generalises the TPU kernel's static kv_len, so one kernel serves the
// encoder (full), cross-attention (full, Sq << Skv) and cached decoder
// self-attention (len = index + t + 1), which the reference sends to its
// jnp path.
//
// What bounds it on an H100: operations at the encoder's shape
// (4*B*H*S^2*D = 1.8e10 FLOP at B=4, H=8, S=1500, D=64 against 25 MB of
// q/k/v/o), bytes for a decode step (one query row against 1500 cached
// keys).  This first design runs on the fp32 pipes, not the tensor cores,
// so it sits far from the operations bound; wgmma, TMA and split-KV for
// decode are later work.
//
// The design.  A block of 128 threads owns one (batch, head) pair and a
// tile of BQ query rows (64, or 16 when Sq <= 16 so that a decode step
// wastes less of the tile).  Blocks run in no order, so the sequential kv
// axis of the TPU grid is a loop inside the block: it walks key tiles of
// 64 rows up to the largest limit of its rows (tiles past every row's
// limit, such as those above the causal diagonal, are never read).  Each
// tile of K and V is converted to fp32 in shared memory.  Thread (tx, ty)
// computes the scores of BQ/8 rows against 4 keys (tx + 16 j): per 4
// dimensions it reads BQ/8 + 4 float4s for 16 * BQ/8 FMAs.  The row max
// and sum fold over the 16 lanes of a row with shuffles; p goes to shared
// memory; then the same thread accumulates its rows' outputs at dimensions
// tx + 16 c.  Scores, (m, l, acc) and the final division are fp32 (the
// softmax runs in base 2 with log2(e) folded into the scale); the output
// is rounded once to the input type.  No atomics, a fixed order: every run
// gives the same bits.
//
// Training: with a non-null lse pointer each row's natural-log
// log-sum-exp of its scaled scores, ln 2 * (m + log2 l) of the base-2
// state, goes to lse[b, i, h] (fp32), the residual the backward kernel
// (flash_attention_bwd.cu) recomputes P from; a row with no counted key
// gets +inf, so its recomputed P is 0.
//
// Head dims 192 and 256 (D = DV): the tile of 64 query rows would hold
// 128 fp32 accumulators a thread at 256, so those instances take 32 rows
// (175 KB of shared memory at 256, under the 227 KB a block may have).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kTX = 16;            // lanes across keys / output dims
constexpr int kTY = 8;             // lanes across query rows
constexpr int kBKV = 64;           // keys per tile
constexpr int kKPT = kBKV / kTX;   // keys per thread in a tile
constexpr int kPS = kBKV + 4;      // row pitch of the p tile (floats)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* lens;  // null: no length mask
  float* lse;       // null: no log-sum-exp wanted
  int b, h, kvh, sq, skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long len_sb, len_sq;
  int causal;
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float comp(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

template <int DP, int DVP, int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) *
             (size_t(BQ) * (16 * DP + 4) + size_t(kBKV) * (16 * DP + 4) +
              size_t(kBKV) * (16 * DVP + 4) + size_t(BQ) * kPS) +
         sizeof(int) * BQ;
}

// D = 16 DP (q, k), DV = 16 DVP (v, o)
template <typename T, int DP, int DVP, int BQ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  static_assert(DVP <= DP, "V's head dim: up to Q's and K's");
  constexpr int D = 16 * DP;
  constexpr int DV = 16 * DVP;
  constexpr int DS = D + 4;        // keeps float4 alignment, spreads banks
  constexpr int DVS = DV + 4;
  constexpr int RQ = BQ / kTY;     // query rows per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][DS]
  float* ks = qs + BQ * DS;                       // [kBKV][DS]
  float* vs = ks + kBKV * DS;                     // [kBKV][DVS]
  float* ps = vs + kBKV * DVS;                    // [BQ][kPS]
  int* rowlim = reinterpret_cast<int*>(ps + BQ * kPS);  // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int bi = blockIdx.y / a.h;
  const int hi = blockIdx.y % a.h;
  const int gi = hi / (a.h / a.kvh);
  const int q0 = blockIdx.x * BQ;
  const T* qg = static_cast<const T*>(a.q) + bi * a.q_sb + hi * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + bi * a.k_sb + gi * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + bi * a.v_sb + gi * a.v_sh;

  // key j counts for tile row r iff j < rowlim[r]
  if (tid < BQ) {
    const int i = q0 + tid;
    int lim = 0;
    if (i < a.sq) {
      lim = a.skv;
      if (a.lens) lim = min(lim, a.lens[bi * a.len_sb + i * a.len_sq]);
      if (a.causal) lim = min(lim, i + (a.skv - a.sq) + 1);
      lim = max(lim, 0);
    }
    rowlim[tid] = lim;
  }
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int i = q0 + r;
    qs[r * DS + d] = i < a.sq ? to_f32(qg[i * a.q_ss + d]) : 0.f;
  }
  __syncthreads();

  int kv_end = 0;
  for (int r = 0; r < BQ; ++r) kv_end = max(kv_end, rowlim[r]);
  int lim[RQ];
  float m[RQ], l[RQ], acc[RQ][DVP];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    lim[r] = rowlim[ty * RQ + r];
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DVP; ++c) acc[r][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBKV) {
    // keys past Skv are zeros, so a masked p of 0 never meets garbage
    for (int idx = tid; idx < kBKV * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx % D;
      const int j = kv0 + r;
      const bool in = j < a.skv;
      ks[r * DS + d] = in ? to_f32(kg[j * a.k_ss + d]) : 0.f;
      if (DV == D) vs[r * DVS + d] = in ? to_f32(vg[j * a.v_ss + d]) : 0.f;
    }
    if (DV != D) {
      for (int idx = tid; idx < kBKV * DV; idx += kThreads) {
        const int r = idx / DV;
        const int d = idx % DV;
        const int j = kv0 + r;
        vs[r * DVS + d] = j < a.skv ? to_f32(vg[j * a.v_ss + d]) : 0.f;
      }
    }
    __syncthreads();

    float s[RQ][kKPT];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int j = 0; j < kKPT; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kk[kKPT];
#pragma unroll
      for (int j = 0; j < kKPT; ++j)
        kk[j] = *reinterpret_cast<const float4*>(&ks[(tx + kTX * j) * DS + d]);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&qs[(ty * RQ + r) * DS + d]);
#pragma unroll
        for (int j = 0; j < kKPT; ++j) {
          float x = s[r][j];
          x = fmaf(qq.x, kk[j].x, x);
          x = fmaf(qq.y, kk[j].y, x);
          x = fmaf(qq.z, kk[j].z, x);
          x = fmaf(qq.w, kk[j].w, x);
          s[r][j] = x;
        }
      }
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const int key = kv0 + tx + kTX * j;
        s[r][j] = key < lim[r] ? s[r][j] * a.scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      // a row with no valid key so far keeps p = 0 and corr = 0
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[r] - m_ref);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const float p = exp2f(s[r][j] - m_ref);
        ps[(ty * RQ + r) * kPS + tx + kTX * j] = p;
        sum += p;
      }
      l[r] = l[r] * corr + row_sum(sum);
#pragma unroll
      for (int c = 0; c < DVP; ++c) acc[r][c] *= corr;
      m[r] = m_new;
    }
    __syncthreads();

#pragma unroll 2
    for (int j0 = 0; j0 < kBKV; j0 += 4) {
      float4 pp[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        pp[r] = *reinterpret_cast<const float4*>(&ps[(ty * RQ + r) * kPS + j0]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DVP];
#pragma unroll
        for (int c = 0; c < DVP; ++c)
          vv[c] = vs[(j0 + jj) * DVS + tx + kTX * c];
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const float p = comp(pp[r], jj);
#pragma unroll
          for (int c = 0; c < DVP; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

  T* og = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = q0 + ty * RQ + r;
    if (i >= a.sq) continue;
    if (a.lse && tx == 0)
      a.lse[(long long)(bi * a.sq + i) * a.h + hi] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f
                     : INFINITY;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = og + ((long long)(bi * a.sq + i) * a.h + hi) * DV;
#pragma unroll
    for (int c = 0; c < DVP; ++c)
      orow[tx + kTX * c] = from_f32<T>(acc[r][c] / den);
  }
}

template <typename T, int DP, int DVP, int BQ>
int launch_t(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP, DVP, BQ>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP, DVP, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((a.sq + BQ - 1) / BQ, a.b * a.h);
  flash_fwd_kernel<T, DP, DVP, BQ><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the (D, DV) pairs of flash_attention_split.cu
template <typename T, int BQ>
int launch_d(const Args& a, int d, int dv, cudaStream_t stream) {
  if (d == 96 && dv == 64) return launch_t<T, 6, 4, BQ>(a, stream);
  if (dv != d) return (int)cudaErrorInvalidValue;
  switch (d / 16) {
    case 1: return launch_t<T, 1, 1, BQ>(a, stream);
    case 2: return launch_t<T, 2, 2, BQ>(a, stream);
    case 3: return launch_t<T, 3, 3, BQ>(a, stream);
    case 4: return launch_t<T, 4, 4, BQ>(a, stream);
    case 5: return launch_t<T, 5, 5, BQ>(a, stream);
    case 6: return launch_t<T, 6, 6, BQ>(a, stream);
    case 7: return launch_t<T, 7, 7, BQ>(a, stream);
    case 8: return launch_t<T, 8, 8, BQ>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_q(const Args& a, int d, int dv, cudaStream_t stream) {
  if (d > 128) {  // 192 and 256: 16 or 32 query rows a block
    if (dv != d || (d != 192 && d != 256)) return (int)cudaErrorInvalidValue;
    if (a.sq <= 16)
      return d == 192 ? launch_t<T, 12, 12, 16>(a, stream)
                      : launch_t<T, 16, 16, 16>(a, stream);
    return d == 192 ? launch_t<T, 12, 12, 32>(a, stream)
                    : launch_t<T, 16, 16, 32>(a, stream);
  }
  return a.sq <= 16 ? launch_d<T, 16>(a, d, dv, stream)
                    : launch_d<T, 64>(a, d, dv, stream);
}

}  // namespace

// q (B, Sq, H, D), k (B, Skv, KV, D) and v (B, Skv, KV, DV) as strided
// views whose last dimension is contiguous (strides in elements for batch,
// sequence, head); o (B, Sq, H, DV) contiguous; dtype 0 = float32, 1 =
// bfloat16, the same for all four.  lens: null, or int32 (B,) (len_sq = 0)
// or (B, Sq) valid key lengths.  lse: null, or fp32 (B, Sq, H) contiguous.
// (D, DV) one of the pairs of launch_d, or (192, 192), (256, 256); H a
// multiple of KV.  Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, const int* lens,
    float* lse, int dtype, int b, int h, int kvh, int sq, int skv, int d,
    int dv,
    long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long len_sb, long long len_sq, int causal, float scale,
    void* stream) {
  if (d <= 0 || d > 256 || d % 16 != 0 || kvh <= 0 || h % kvh != 0 ||
      (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || sq <= 0) return 0;
  Args a{q,    k,    v,    o,    lens, lse,  b,      h,      kvh,
         sq,   skv,  q_sb, q_ss, q_sh, k_sb, k_ss,   k_sh,   v_sb,
         v_ss, v_sh, len_sb, len_sq, causal, scale * 1.4426950408889634f};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_q<float>(a, d, dv, st);
    case 1: return launch_q<__nv_bfloat16>(a, d, dv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
