// flash_attention_bwd: the gradient of forward attention (causal or full,
// GQA, V of its own head dim) from the forward's output and log-sum-exp.
//
//   P[i, j]  = exp(s[i, j] - lse[i]) over counted keys (0 elsewhere),
//              s = q[i] . k[j] * scale
//   D[i]     = sum_c dO[i, c] O[i, c]
//   dV[j]    = sum_i P[i, j] dO[i]          (summed over the G query heads
//   dS[i, j] = P[i, j] (dO[i] . v[j] - D[i]) * scale       of a KV head)
//   dQ[i]    = sum_j dS[i, j] k[j]
//   dK[j]    = sum_i dS[i, j] q[i]
//
// over keys j < lim(i) = min(Skv, i + (Skv - Sq) + 1 if causal): the
// diagonal aligned at the end, as the forward kernels and the plain twin.
//
// Replaces no TPU kernel: the reference's backward is a jax.custom_vjp
// written in jnp (_flash_attn_bwd of repro/models/layers/attention.py,
// :151-236), which its training path always takes; the reference has no
// Pallas backward.  It was added so that attention's gradient on the card
// is a hand-written kernel, as its forward is.  Its plain twin is
// kernels/flash_attention/ref.py:flash_attention_bwd_ref.
//
// What bounds it on an H100: operations.  Five products of 2 Dk or 2 Dv
// FLOP a counted (query, key) pair, 2 (3 Dk + 2 Dv) in all, against
// about 2 (2 Dk + 2 Dv) bytes a row read: at training's shapes (B 8,
// 128 tokens, GQA 16/8, D 128, causal) 1.35e9 FLOP, 1.4 us at the bf16
// tensor-core rate.  This first design runs on the fp32 pipes, not the
// tensor cores, and recomputes S and dP in both kernels, so it sits far
// from that bound; mma/wgmma tiles are later work.
//
// The design: two kernels, no floating-point atomics, a fixed order, so
// every run gives the same bits.
// * flash_bwd_dq: one block of 128 threads for each (batch, head, tile of
//   BQ query rows).  It computes D for its rows (written to `delta` for
//   the second kernel), then walks the key tiles up to its rows' largest
//   limit: S and dP for its rows against the tile's keys (thread (tx, ty)
//   holds BQ/8 rows x BK/16 keys), P from the lse, dS to shared memory,
//   then dQ += dS K into BQ/8 x D/16 fp32 accumulators a thread.
// * flash_bwd_dkdv: one block of 256 threads for each (batch, KV head,
//   tile of BK keys), launched after the first on the same stream.  It
//   walks the query tiles from the first one that can see its keys and,
//   inside each, the G query heads of its group in order: S^T and dP^T
//   for its keys against the tile's rows (thread (tx, ty) holds BK/16
//   keys x BQ/16 rows), P^T and dS^T to shared memory, then dV += P^T dO
//   and dK += dS^T Q into BK/16 x (D + DV)/16 fp32 accumulators a thread.
// Inputs are converted to fp32 in shared memory; every product and sum is
// fp32, and each gradient is rounded once to the input type.  Tiles are
// 64 x 64 up to D 128, 32 x 32 at 192 and 256 (shared memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kTX = 16;  // lanes across keys or columns

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // (B, Sq, H, DV) contiguous
  const void* dout;  // (B, Sq, H, DV) contiguous
  const float* lse;  // (B, Sq, H) contiguous, natural log
  void* dq;          // (B, Sq, H, D) contiguous
  void* dk;          // (B, Skv, KV, D) contiguous
  void* dv;          // (B, Skv, KV, DV) contiguous
  float* delta;      // (B, Sq, H): D, written by the first kernel
  int b, h, kvh, sq, skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal;
  float scale;       // the softmax scale
  float scale_log2;  // scale * log2(e)
};

constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float comp(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// keys j < row_limit count for query row i (0 for a row past Sq)
__device__ __forceinline__ int row_limit(const Args& a, int i) {
  if (i >= a.sq) return 0;
  int lim = a.skv;
  if (a.causal) lim = min(lim, i + (a.skv - a.sq) + 1);
  return max(lim, 0);
}

// rows [r0, r0 + n) of a strided (B, S, heads, W) input into shared rows of
// pitch `pitch` floats, zeros past `limit`
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const T* src, long long stride,
                                          int r0, int n, int limit, int tid,
                                          int nthreads) {
  for (int idx = tid; idx < n * W; idx += nthreads) {
    const int r = idx / W;
    const int c = idx % W;
    const int i = r0 + r;
    dst[r * pitch + c] = i < limit ? to_f32(src[i * stride + c]) : 0.f;
  }
}

template <int DP, int DVP, int BQ, int BK>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t(BQ) * (16 * DP + 4) +
                          size_t(BQ) * (16 * DVP + 4) +
                          size_t(BK) * (16 * DP + 4) +
                          size_t(BK) * (16 * DVP + 4) +
                          size_t(BQ) * (BK + 4) + 2 * size_t(BQ)) +
         sizeof(int) * BQ;
}

// D = 16 DP (q, k), DV = 16 DVP (v, o)
template <typename T, int DP, int DVP, int BQ, int BK>
__global__ void __launch_bounds__(128) flash_bwd_dq(Args a) {
  constexpr int D = 16 * DP;
  constexpr int DV = 16 * DVP;
  constexpr int DS = D + 4;   // float4 alignment, banks spread
  constexpr int DVS = DV + 4;
  constexpr int PS = BK + 4;
  constexpr int TY = 8;
  constexpr int RQ = BQ / TY;     // query rows a thread
  constexpr int KPT = BK / kTX;   // keys a thread in a tile
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][DS]
  float* dos = qs + BQ * DS;                     // [BQ][DVS]
  float* ks = dos + BQ * DVS;                    // [BK][DS]
  float* vs = ks + BK * DS;                      // [BK][DVS]
  float* dsm = vs + BK * DVS;                    // [BQ][PS]
  float* lse2 = dsm + BQ * PS;                   // [BQ]
  float* dlt = lse2 + BQ;                        // [BQ]
  int* rowlim = reinterpret_cast<int*>(dlt + BQ);  // [BQ]

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
  // the contiguous (B, Sq, H, DV) rows of o and dO: row stride H * DV
  const long long orow = (long long)a.h * DV;
  const long long obase = ((long long)bi * a.sq * a.h + hi) * DV;
  const T* og = static_cast<const T*>(a.o) + obase;
  const T* dog = static_cast<const T*>(a.dout) + obase;

  if (tid < BQ) {
    const int i = q0 + tid;
    rowlim[tid] = row_limit(a, i);
    lse2[tid] = i < a.sq ? a.lse[((long long)bi * a.sq + i) * a.h + hi] * kLog2e
                         : INFINITY;
  }
  load_rows<T, D>(qs, DS, qg, a.q_ss, q0, BQ, a.sq, tid, 128);
  load_rows<T, DV>(dos, DVS, dog, orow, q0, BQ, a.sq, tid, 128);
  __syncthreads();

  // D = rowsum(dO * O): 16 lanes a row, then a shuffle sum
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int row = ty * RQ + r;
    const int i = q0 + row;
    float part = 0.f;
    if (i < a.sq)
#pragma unroll
      for (int c = 0; c < DVP; ++c)
        part = fmaf(dos[row * DVS + tx + kTX * c],
                    to_f32(og[i * orow + tx + kTX * c]), part);
    part = row_sum(part);
    if (tx == 0) {
      dlt[row] = part;
      if (i < a.sq) a.delta[((long long)bi * a.sq + i) * a.h + hi] = part;
    }
  }
  __syncthreads();

  int kv_end = 0;
  for (int r = 0; r < BQ; ++r) kv_end = max(kv_end, rowlim[r]);
  int lim[RQ];
  float acc[RQ][DP];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    lim[r] = rowlim[ty * RQ + r];
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[r][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    load_rows<T, D>(ks, DS, kg, a.k_ss, kv0, BK, a.skv, tid, 128);
    load_rows<T, DV>(vs, DVS, vg, a.v_ss, kv0, BK, a.skv, tid, 128);
    __syncthreads();

    float s[RQ][KPT], dp[RQ][KPT];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kk[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kk[j] = *reinterpret_cast<const float4*>(&ks[(tx + kTX * j) * DS + d]);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&qs[(ty * RQ + r) * DS + d]);
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[r][j] = dot4(qq, kk[j], s[r][j]);
      }
    }
#pragma unroll 4
    for (int d = 0; d < DV; d += 4) {
      float4 vv[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        vv[j] = *reinterpret_cast<const float4*>(&vs[(tx + kTX * j) * DVS + d]);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float4 gg =
            *reinterpret_cast<const float4*>(&dos[(ty * RQ + r) * DVS + d]);
#pragma unroll
        for (int j = 0; j < KPT; ++j) dp[r][j] = dot4(gg, vv[j], dp[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int row = ty * RQ + r;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = kv0 + tx + kTX * j;
        const float p = key < lim[r]
                            ? exp2f(fmaf(s[r][j], a.scale_log2, -lse2[row]))
                            : 0.f;
        dsm[row * PS + tx + kTX * j] = p * (dp[r][j] - dlt[row]) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int j0 = 0; j0 < BK; j0 += 4) {
      float4 ds4[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        ds4[r] = *reinterpret_cast<const float4*>(&dsm[(ty * RQ + r) * PS + j0]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kv[DP];
#pragma unroll
        for (int c = 0; c < DP; ++c) kv[c] = ks[(j0 + jj) * DS + tx + kTX * c];
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const float x = comp(ds4[r], jj);
#pragma unroll
          for (int c = 0; c < DP; ++c) acc[r][c] = fmaf(x, kv[c], acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

  T* dqg = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = q0 + ty * RQ + r;
    if (i >= a.sq) continue;
    T* out = dqg + (((long long)bi * a.sq + i) * a.h + hi) * D;
#pragma unroll
    for (int c = 0; c < DP; ++c) out[tx + kTX * c] = from_f32<T>(acc[r][c]);
  }
}

template <int DP, int DVP, int BQ, int BK>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (size_t(BK) * (16 * DP + 4) +
                          size_t(BK) * (16 * DVP + 4) +
                          size_t(BQ) * (16 * DP + 4) +
                          size_t(BQ) * (16 * DVP + 4) +
                          2 * size_t(BK) * (BQ + 4) + 2 * size_t(BQ)) +
         sizeof(int) * BQ;
}

template <typename T, int DP, int DVP, int BQ, int BK>
__global__ void __launch_bounds__(256) flash_bwd_dkdv(Args a) {
  constexpr int D = 16 * DP;
  constexpr int DV = 16 * DVP;
  constexpr int DS = D + 4;
  constexpr int DVS = DV + 4;
  constexpr int PS = BQ + 4;
  constexpr int RK = BK / 16;    // keys a thread (16 rows of threads)
  constexpr int RQ = BQ / kTX;   // query rows a thread in S^T
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][DS]
  float* vs = ks + BK * DS;                      // [BK][DVS]
  float* qs = vs + BK * DVS;                     // [BQ][DS]
  float* dos = qs + BQ * DS;                     // [BQ][DVS]
  float* pt = dos + BQ * DVS;                    // [BK][PS]: P^T
  float* dst = pt + BK * PS;                     // [BK][PS]: dS^T
  float* lse2 = dst + BK * PS;                   // [BQ]
  float* dlt = lse2 + BQ;                        // [BQ]
  int* rowlim = reinterpret_cast<int*>(dlt + BQ);  // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int bi = blockIdx.y / a.kvh;
  const int gi = blockIdx.y % a.kvh;
  const int g = a.h / a.kvh;
  const int k0 = blockIdx.x * BK;
  const T* kg = static_cast<const T*>(a.k) + bi * a.k_sb + gi * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + bi * a.v_sb + gi * a.v_sh;
  const long long orow = (long long)a.h * DV;

  load_rows<T, D>(ks, DS, kg, a.k_ss, k0, BK, a.skv, tid, 256);
  load_rows<T, DV>(vs, DVS, vg, a.v_ss, k0, BK, a.skv, tid, 256);

  float dka[RK][DP], dva[RK][DVP];
#pragma unroll
  for (int r = 0; r < RK; ++r) {
#pragma unroll
    for (int c = 0; c < DP; ++c) dka[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DVP; ++c) dva[r][c] = 0.f;
  }

  // the first query that sees key k0: i + (Skv - Sq) >= k0 when causal
  const int first = a.causal ? max(0, k0 - (a.skv - a.sq)) : 0;
  for (int q0 = first - first % BQ; q0 < a.sq; q0 += BQ) {
    for (int jg = 0; jg < g; ++jg) {
      const int hi = gi * g + jg;
      const T* qg = static_cast<const T*>(a.q) + bi * a.q_sb + hi * a.q_sh;
      const T* dog = static_cast<const T*>(a.dout) +
                     ((long long)bi * a.sq * a.h + hi) * DV;
      __syncthreads();  // the previous (tile, head) is done with the tiles
      if (tid < BQ) {
        const int i = q0 + tid;
        rowlim[tid] = row_limit(a, i);
        const long long at = ((long long)bi * a.sq + i) * a.h + hi;
        lse2[tid] = i < a.sq ? a.lse[at] * kLog2e : INFINITY;
        dlt[tid] = i < a.sq ? a.delta[at] : 0.f;
      }
      load_rows<T, D>(qs, DS, qg, a.q_ss, q0, BQ, a.sq, tid, 256);
      load_rows<T, DV>(dos, DVS, dog, orow, q0, BQ, a.sq, tid, 256);
      __syncthreads();

      // S^T and dP^T: keys ty * RK + r against rows tx + 16 j
      float s[RK][RQ], dp[RK][RQ];
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int j = 0; j < RQ; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qq[RQ];
#pragma unroll
        for (int j = 0; j < RQ; ++j)
          qq[j] = *reinterpret_cast<const float4*>(&qs[(tx + kTX * j) * DS + d]);
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          const float4 kk =
              *reinterpret_cast<const float4*>(&ks[(ty * RK + r) * DS + d]);
#pragma unroll
          for (int j = 0; j < RQ; ++j) s[r][j] = dot4(qq[j], kk, s[r][j]);
        }
      }
#pragma unroll 4
      for (int d = 0; d < DV; d += 4) {
        float4 gg[RQ];
#pragma unroll
        for (int j = 0; j < RQ; ++j)
          gg[j] =
              *reinterpret_cast<const float4*>(&dos[(tx + kTX * j) * DVS + d]);
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[(ty * RK + r) * DVS + d]);
#pragma unroll
          for (int j = 0; j < RQ; ++j) dp[r][j] = dot4(gg[j], vv, dp[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        const int key = ty * RK + r;
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          const int row = tx + kTX * j;
          const float p =
              k0 + key < rowlim[row]
                  ? exp2f(fmaf(s[r][j], a.scale_log2, -lse2[row]))
                  : 0.f;
          pt[key * PS + row] = p;
          dst[key * PS + row] = p * (dp[r][j] - dlt[row]) * a.scale;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's rows, in order
#pragma unroll 2
      for (int j0 = 0; j0 < BQ; j0 += 4) {
        float4 p4[RK], d4[RK];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          p4[r] = *reinterpret_cast<const float4*>(&pt[(ty * RK + r) * PS + j0]);
          d4[r] = *reinterpret_cast<const float4*>(&dst[(ty * RK + r) * PS + j0]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int row = j0 + jj;
          float gv[DVP], qv[DP];
#pragma unroll
          for (int c = 0; c < DVP; ++c) gv[c] = dos[row * DVS + tx + kTX * c];
#pragma unroll
          for (int c = 0; c < DP; ++c) qv[c] = qs[row * DS + tx + kTX * c];
#pragma unroll
          for (int r = 0; r < RK; ++r) {
            const float p = comp(p4[r], jj);
            const float x = comp(d4[r], jj);
#pragma unroll
            for (int c = 0; c < DVP; ++c) dva[r][c] = fmaf(p, gv[c], dva[r][c]);
#pragma unroll
            for (int c = 0; c < DP; ++c) dka[r][c] = fmaf(x, qv[c], dka[r][c]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk);
  T* dvg = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int j = k0 + ty * RK + r;
    if (j >= a.skv) continue;
    const long long at = (long long)bi * a.skv + j;
    T* krow = dkg + (at * a.kvh + gi) * D;
    T* vrow = dvg + (at * a.kvh + gi) * DV;
#pragma unroll
    for (int c = 0; c < DP; ++c) krow[tx + kTX * c] = from_f32<T>(dka[r][c]);
#pragma unroll
    for (int c = 0; c < DVP; ++c) vrow[tx + kTX * c] = from_f32<T>(dva[r][c]);
  }
}

template <typename Kern>
int configure(Kern kernel, size_t smem, bool& configured) {
  if (configured) return 0;  // one attribute call per instantiation
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  configured = true;
  return 0;
}

template <typename T, int DP, int DVP, int BQ, int BK>
int launch_t(const Args& a, cudaStream_t stream) {
  static bool dq_ready = false, dkdv_ready = false;
  constexpr size_t s1 = dq_smem<DP, DVP, BQ, BK>();
  constexpr size_t s2 = dkdv_smem<DP, DVP, BQ, BK>();
  int err = configure(flash_bwd_dq<T, DP, DVP, BQ, BK>, s1, dq_ready);
  if (err) return err;
  err = configure(flash_bwd_dkdv<T, DP, DVP, BQ, BK>, s2, dkdv_ready);
  if (err) return err;
  const dim3 g1((a.sq + BQ - 1) / BQ, a.b * a.h);
  flash_bwd_dq<T, DP, DVP, BQ, BK><<<g1, 128, s1, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 g2((a.skv + BK - 1) / BK, a.b * a.kvh);
  flash_bwd_dkdv<T, DP, DVP, BQ, BK><<<g2, 256, s2, stream>>>(a);
  return (int)cudaGetLastError();
}

// the (D, DV) pairs of the forward kernels: DV = D at every multiple of 16
// up to 128 and at 192 and 256, and MLA's (96, 64)
template <typename T>
int launch_d(const Args& a, int d, int dv, cudaStream_t stream) {
  if (d == 96 && dv == 64) return launch_t<T, 6, 4, 64, 64>(a, stream);
  if (dv != d) return (int)cudaErrorInvalidValue;
  switch (d / 16) {
    case 1: return launch_t<T, 1, 1, 64, 64>(a, stream);
    case 2: return launch_t<T, 2, 2, 64, 64>(a, stream);
    case 3: return launch_t<T, 3, 3, 64, 64>(a, stream);
    case 4: return launch_t<T, 4, 4, 64, 64>(a, stream);
    case 5: return launch_t<T, 5, 5, 64, 64>(a, stream);
    case 6: return launch_t<T, 6, 6, 64, 64>(a, stream);
    case 7: return launch_t<T, 7, 7, 64, 64>(a, stream);
    case 8: return launch_t<T, 8, 8, 64, 64>(a, stream);
    case 12: return launch_t<T, 12, 12, 32, 32>(a, stream);
    case 16: return launch_t<T, 16, 16, 32, 32>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k (B, Skv, KV, D), v (B, Skv, KV, DV): strided views
// whose last dimension is contiguous (strides in elements for batch,
// sequence, head); o and dout (B, Sq, H, DV), lse (B, Sq, H) fp32 and the
// outputs dq (B, Sq, H, D), dk (B, Skv, KV, D), dv (B, Skv, KV, DV)
// contiguous; delta: fp32 scratch of B * Sq * H.  dtype 0 = float32, 1 =
// bfloat16, the same for q, k, v, o, dout and the outputs.  (D, DV) one
// of the pairs of launch_d, H a multiple of KV.  Launches both kernels on
// `stream` and returns the first cudaGetLastError().
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, int dtype, int b, int h, int kvh, int sq, int skv, int d,
    int d_v, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, float scale, void* stream) {
  if (d <= 0 || d > 256 || d % 16 != 0 || kvh <= 0 || h % kvh != 0 ||
      (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || sq <= 0 || skv <= 0) return 0;
  const Args a{q,    k,    v,    o,    dout, lse,  dq,   dk,   dv,
               delta, b,   h,    kvh,  sq,   skv,  q_sb, q_ss, q_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale,
               scale * kLog2e};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_d<float>(a, d, d_v, st);
    case 1: return launch_d<__nv_bfloat16>(a, d, d_v, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
