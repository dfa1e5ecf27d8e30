// flash_attention_bwd_tc: the gradient of forward attention in bf16 on the
// tensor cores (causal or full, GQA, V of its own head dim, (Dk, Dv) up to
// 128), from the forward's output and log-sum-exp.
//
//   P[i, j]  = exp(s[i, j] - lse[i]) over counted keys (0 elsewhere),
//              s = q[i] . k[j] * scale
//   D[i]     = sum_c dO[i, c] O[i, c]
//   dV[j]    = sum_i P[i, j] dO[i]          (summed over the G query heads
//   dS[i, j] = P[i, j] (dO[i] . v[j] - D[i])               of a KV head)
//   dQ[i]    = scale sum_j dS[i, j] k[j]
//   dK[j]    = scale sum_i dS[i, j] q[i]
//
// over keys j < lim(i) = min(Skv, i + (Skv - Sq) + 1 if causal): the
// diagonal aligned at the end, as the forward kernels and the plain twin.
//
// Replaces no TPU kernel: the reference's backward is a jax.custom_vjp
// written in jnp (_flash_attn_bwd of repro/models/layers/attention.py,
// :151-236).  It is the bf16 route of the port's flash backward; fp32 and
// the head dims above 128 take flash_attention_bwd.cu, the CUDA-core
// kernels (kernels/flash_attention/kernel.py:bwd_route picks).  Its plain
// twin is kernels/flash_attention/ref.py:flash_attention_bwd_ref.
//
// What bounds it on an H100: operations.  Five products of 2 Dk or 2 Dv
// FLOP a counted (query, key) pair, 2 (3 Dk + 2 Dv) in all, at the 989e12
// bf16 FLOP/s of the tensor cores: internlm2's training call (B 8, 128
// tokens, GQA 16/8, D 128, causal) 1.35e9 FLOP, 1.4 us, under its 25 MB
// of traffic (7.5 us); Jamba's (B 2, 1 024 tokens, GQA 64/8) 8.6e10 FLOP,
// 87 us.  Each pair also costs one exponential; the products run on
// mma.sync, which issues in order, so the two add up.
//
// The design: FlashAttention-2's backward on mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate), two kernels on one stream, no floating-point atomics
// and a fixed order, so every run gives the same bits.
// * flash_bwd_tc_dq: one block of four warps for each (batch, head, tile
//   of 64 query rows), a warp 16 rows, tiles taken from the last so the
//   longest causal rows start first.  It first computes D for its rows
//   (16-byte loads of O and dO, a fixed order) and writes it for the
//   second kernel.  Then it walks the key tiles up to its rows' largest
//   limit: 64 keys of K and V a tile by 16-byte cp.async copies, a ring
//   of two stages.  S = Q K^T and dP = dO V^T on the tensor cores (Q's
//   fragments held in registers, dO's read by ldmatrix from shared
//   memory), P = 2^(s * scale * log2 e - lse * log2 e) and
//   dS = P (dP - D) in fp32 registers, then dQ += dS K with dS rounded to
//   bf16 in registers as the A operand (K by ldmatrix.trans).
// * flash_bwd_tc_dkdv: one block of four warps for each (batch, KV head,
//   tile of 64 keys), a warp 16 keys, K and V held in shared memory.  It
//   walks the query tiles from the first that can see its keys (causal:
//   from the diagonal) and, inside each, the G query heads of its group
//   in order; each (tile, head) brings its Q, dO, lse and D into the ring
//   by cp.async while the previous one is computed.  Where the caller
//   passes `part` (G even and a long walk: kernel.py's bwd_tc_splits)
//   the group's heads are split over two blocks (G / 2 each) whose fp32
//   sums a third launch, flash_bwd_tc_combine, adds in a fixed order:
//   under a causal mask the first key tile sees every query tile and the
//   last one, so with one block a key tile the card waits on the first
//   tiles (at Jamba's call 256 blocks fit at once and the longest walks
//   128 (tile, head) pairs against a mean of 68; short walks such as
//   internlm2's keep one block a key tile, where the third launch would
//   cost more than the balance buys); the grid puts the key tile in y,
//   so the longest blocks start first.  S^T = K Q^T and
//   dP^T = V dO^T on the tensor cores, P^T and dS^T as above, then
//   dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to bf16 in
//   registers as the A operand (Q and dO by ldmatrix.trans); dK and dV
//   stay in fp32 registers to the end.
// * Why D first, in the dQ kernel: the dK/dV kernel reads D for every
//   (tile, head) it walks, so it must exist before that kernel starts; the
//   dQ kernel holds each row's dO anyway.  Writing dS to memory instead
//   (so that dQ needs no recompute) would cost B H Sq Skv bf16 bytes,
//   268 MB at Jamba's call, against a recompute of S and dP that the
//   tensor cores take in a third of the kernel's products.
// * Masking: tiles past every row's limit are never loaded or walked;
//   only a warp whose keys reach past the smallest limit of the tile's
//   rows (the diagonal, the ragged ends of Sq and Skv) masks in registers.
// * Precision: the bf16 twins keep P and dS in fp32, and the checks hold
//   each gradient's error to twice theirs.  Rounded to bf16, dS put dQ
//   and dK past that limit on the H100 (each row of dS sums to 0, so
//   dQ = dS (K - mean K) cancels in its sum), and P put dV near it.  So P and dS enter their products as two
//   bf16 operands each, the rounding and what the rounding left, on the
//   same B fragments: the tensor cores run eight products a counted pair
//   where five would do.  Each gradient is rounded once to bf16 at the
//   end.
// * Rows are padded by 16 bytes in shared memory, so ldmatrix reads eight
//   rows in eight distinct bank groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kW = 4;             // warps a block
constexpr int kThreads = 32 * kW;
constexpr int kBQ = 16 * kW;      // query rows a dQ block, a dK/dV tile
constexpr int kBK = 16 * kW;      // keys a dK/dV block, a dQ tile
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;     // (B, Sq, H, DV) contiguous
  const __nv_bfloat16* dout;  // (B, Sq, H, DV) contiguous
  const float* lse;           // (B, Sq, H) contiguous, natural log
  __nv_bfloat16* dq;          // (B, Sq, H, D) contiguous
  __nv_bfloat16* dk;          // (B, Skv, KV, D) contiguous
  __nv_bfloat16* dv;          // (B, Skv, KV, DV) contiguous
  float* delta;               // (B, Sq, H): D, written by the dQ kernel
  float* part;                // null, or (2, B, Skv, KV, D + DV): the two
                              // head halves' dK (unscaled) and dV in fp32
  int b, h, kvh, sq, skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal;
  float scale;       // the softmax scale
  float scale_log2;  // scale * log2(e)
};

template <int D, int DV>
struct Tile {
  static_assert(D % 16 == 0 && DV % 16 == 0 && D <= 128 && DV <= D,
                "head dims: multiples of 16, DV <= D <= 128");
  static constexpr int kPitch = 2 * D + 16;    // bytes a shared Q or K row
  static constexpr int kPitchV = 2 * DV + 16;  // bytes a shared V or dO row
  static constexpr int kPieces = D / 8;        // 16-byte pieces a Q/K row
  static constexpr int kPiecesV = DV / 8;      // and a V/dO row
  // dQ: Q and dO of the block's rows, then two stages of K and V
  static constexpr int kStageKV = kBK * (kPitch + kPitchV);
  static constexpr size_t kSmemDq =
      size_t(kBQ) * (kPitch + kPitchV) + 2 * size_t(kStageKV) +
      sizeof(float) * kBQ;
  // dK/dV: K and V of the block's keys, then two stages of Q, dO, lse, D
  static constexpr int kStageQ = kBQ * (kPitch + kPitchV) + 2 * 4 * kBQ;
  static constexpr size_t kSmemDkdv =
      size_t(kBK) * (kPitch + kPitchV) + 2 * size_t(kStageQ);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU op, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// keys j < row_limit count for query row i (0 for a row past Sq)
__device__ __forceinline__ int row_limit(const Args& a, int i) {
  if (i >= a.sq) return 0;
  int lim = a.skv;
  if (a.causal) lim = min(lim, i + (a.skv - a.sq) + 1);
  return max(lim, 0);
}

// the pair (lo, hi) rounded to bf16 in *x, and what the rounding left,
// rounded to bf16, as the result
__device__ __forceinline__ uint32_t split_bf16(float lo, float hi,
                                               uint32_t* x) {
  *x = pack_bf16(lo, hi);
  const float2 r =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
  return pack_bf16(lo - r.x, hi - r.y);
}

// the A operand of the next product from a 16-row C tile of NB column
// blocks, columns 16 kv .. 16 kv + 15: pa rounded to bf16, pr what the
// rounding left; pa + pr carries the fp32 tile to about 16 bits
template <int NB>
__device__ __forceinline__ void to_a_split(uint32_t (&pa)[4],
                                           uint32_t (&pr)[4],
                                           const float (&c)[NB][4], int kv) {
  pr[0] = split_bf16(c[2 * kv][0], c[2 * kv][1], &pa[0]);
  pr[1] = split_bf16(c[2 * kv][2], c[2 * kv][3], &pa[1]);
  pr[2] = split_bf16(c[2 * kv + 1][0], c[2 * kv + 1][1], &pa[2]);
  pr[3] = split_bf16(c[2 * kv + 1][2], c[2 * kv + 1][3], &pa[3]);
}

// acc (16 x 8 NB) += A (16 rows of `arow`, K columns) B^T, B's NB * 8
// rows at `brow` (both row-major in shared memory, pitches in bytes)
template <int K, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4],
                                        const unsigned char* arow, int pa,
                                        const unsigned char* brow, int pb,
                                        int lane) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, arow + (lane % 8 + 8 * ((lane / 8) % 2)) * pa +
                        (16 * ks + 8 * (lane / 16)) * 2);
#pragma unroll
    for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, brow + (16 * nb2 + lane % 8 + 8 * (lane / 16)) * pb +
                          (16 * ks + 8 * ((lane / 8) % 2)) * 2);
      mma(acc[2 * nb2], af, bf[0], bf[1]);
      mma(acc[2 * nb2 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x N) += C (16 x 8 NB, fp32) B, B's 8 NB rows of N columns at
// `brow` (row-major in shared memory, pitch in bytes).  C is rounded to
// bf16 and the rest of the rounding is a second bf16 operand on the same
// B fragments, so C enters the product to about 16 bits
template <int N, int NB>
__device__ __forceinline__ void mma_cb(float (&acc)[N / 8][4],
                                       const float (&c)[NB][4],
                                       const unsigned char* brow, int pb,
                                       int lane) {
#pragma unroll
  for (int kv = 0; kv < NB / 2; ++kv) {
    uint32_t pa[4], pr[4];
    to_a_split<NB>(pa, pr, c, kv);
#pragma unroll
    for (int nd2 = 0; nd2 < N / 16; ++nd2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, brow + (16 * kv + lane % 8 + 8 * ((lane / 8) % 2)) *
                                       pb +
                                8 * (2 * nd2 + lane / 16) * 2);
      mma(acc[2 * nd2], pa, bf[0], bf[1]);
      mma(acc[2 * nd2 + 1], pa, bf[2], bf[3]);
      mma(acc[2 * nd2], pr, bf[0], bf[1]);
      mma(acc[2 * nd2 + 1], pr, bf[2], bf[3]);
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_tc_dq(Args a) {
  using C = Tile<D, DV>;
  constexpr int P = C::kPitch;
  constexpr int PV = C::kPitchV;
  constexpr int NB = kBK / 8;    // 8-key column blocks of S
  extern __shared__ uint4 smem16[];
  __shared__ int block_max[kW];
  unsigned char* qsm = reinterpret_cast<unsigned char*>(smem16);
  unsigned char* dosm = qsm + kBQ * P;
  unsigned char* kvs = dosm + kBQ * PV;   // stage s: K, then V
  float* dsm = reinterpret_cast<float*>(kvs + 2 * C::kStageKV);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bi = blockIdx.y / a.h;
  const int hi = blockIdx.y % a.h;
  const int gi = hi / (a.h / a.kvh);
  const int q0 = qt * kBQ;
  const __nv_bfloat16* qg = a.q + bi * a.q_sb + hi * a.q_sh;
  const __nv_bfloat16* kg = a.k + bi * a.k_sb + gi * a.k_sh;
  const __nv_bfloat16* vg = a.v + bi * a.v_sb + gi * a.v_sh;
  // the contiguous (B, Sq, H, DV) rows of o and dO: row stride H * DV
  const long long orow = (long long)a.h * DV;
  const long long obase = ((long long)bi * a.sq * a.h + hi) * DV;

  // this thread's rows: half e -> q0 + 16 warp + lane / 4 + 8 e
  int lim[2];
  int lmax = 0, lmin = INT_MAX;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    lim[e] = row_limit(a, q0 + 16 * warp + lane / 4 + 8 * e);
    lmax = max(lmax, lim[e]);
    lmin = min(lmin, lim[e]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lmax = max(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    lmin = min(lmin, __shfl_xor_sync(0xffffffffu, lmin, off));
  }
  if (lane == 0) block_max[warp] = lmax;

  auto load_kv = [&](int tile, int stage, int kv_end) {
    unsigned char* kst = kvs + stage * C::kStageKV;
    unsigned char* vst = kst + kBK * P;
    const int j0 = tile * kBK;
    for (int c = tid; c < kBK * C::kPieces; c += kThreads) {
      const int row = c / C::kPieces;
      const int pc = c % C::kPieces;
      const int j = j0 + row;
      const bool in = j < kv_end;
      const long long jj = in ? j : 0;
      cp_async16(kst + row * P + pc * 16, kg + jj * a.k_ss + pc * 8, in);
      if (DV == D || pc < C::kPiecesV)
        cp_async16(vst + row * PV + pc * 16, vg + jj * a.v_ss + pc * 8, in);
    }
  };

  // Q and dO of the block's rows (rows past Sq zero-filled)
  for (int c = tid; c < kBQ * C::kPieces; c += kThreads) {
    const int row = c / C::kPieces;
    const int pc = c % C::kPieces;
    const int i = q0 + row;
    const bool in = i < a.sq;
    cp_async16(qsm + row * P + pc * 16, qg + (in ? i : 0) * a.q_ss + pc * 8,
               in);
  }
  for (int c = tid; c < kBQ * C::kPiecesV; c += kThreads) {
    const int row = c / C::kPiecesV;
    const int pc = c % C::kPiecesV;
    const int i = q0 + row;
    const bool in = i < a.sq;
    cp_async16(dosm + row * PV + pc * 16,
               a.dout + obase + (in ? i : 0) * orow + pc * 8, in);
  }
  __syncthreads();   // block_max
  int kv_end = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) kv_end = max(kv_end, block_max[w]);
  const int ntiles = (kv_end + kBK - 1) / kBK;
  if (ntiles > 0) load_kv(0, 0, kv_end);
  cp_async_commit();

  // D = rowsum(dO * O): two threads a row, DV / 2 columns each by
  // 16-byte loads, then their sum; a fixed order
  {
    const int row = tid / 2;
    const int i = q0 + row;
    float part = 0.f;
    if (i < a.sq) {
      const uint4* og4 = reinterpret_cast<const uint4*>(
          a.o + obase + i * orow + (tid % 2) * (DV / 2));
      const uint4* dg4 = reinterpret_cast<const uint4*>(
          a.dout + obase + i * orow + (tid % 2) * (DV / 2));
#pragma unroll
      for (int c = 0; c < DV / 16; ++c) {
        const uint4 ov = og4[c], dv = dg4[c];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float2 of = __bfloat1622float2(o2[x]);
          const float2 df = __bfloat1622float2(d2[x]);
          part = fmaf(df.x, of.x, part);
          part = fmaf(df.y, of.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (tid % 2 == 0) {
      dsm[row] = part;
      if (i < a.sq) a.delta[((long long)bi * a.sq + i) * a.h + hi] = part;
    }
  }

  float dqa[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int x = 0; x < 4; ++x) dqa[nd][x] = 0.f;

  cp_async_wait<0>();
  __syncthreads();   // Q, dO, D and the first stage
  float lse2[2], dlt[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * warp + lane / 4 + 8 * e;
    const int i = q0 + r;
    lse2[e] = i < a.sq ? a.lse[((long long)bi * a.sq + i) * a.h + hi] * kLog2e
                       : 0.f;
    dlt[e] = dsm[r];
  }
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(qf[ks], qsm + (16 * warp + lane % 8 + 8 * ((lane / 8) % 2)) * P +
                            (16 * ks + 8 * (lane / 16)) * 2);
  const unsigned char* dorow = dosm + 16 * warp * PV;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_kv(it + 1, (it + 1) & 1, kv_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kst = kvs + (it & 1) * C::kStageKV;
    const unsigned char* vst = kst + kBK * P;
    const int kv0 = it * kBK;

    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[nb][x] = dp[nb][x] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kst + (16 * nb2 + lane % 8 + 8 * (lane / 16)) * P +
                            (16 * ks + 8 * ((lane / 8) % 2)) * 2);
        mma(s[2 * nb2], qf[ks], kf[0], kf[1]);
        mma(s[2 * nb2 + 1], qf[ks], kf[2], kf[3]);
      }
    mma_abt<DV, NB>(dp, dorow, PV, vst, PV, lane);

    // dS = P (dP - D) in place of dP; keys past a row's limit give 0
    const bool masked = kv0 + kBK > lmin;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = x / 2;
        float p = ex2(fmaf(s[nb][x], a.scale_log2, -lse2[e]));
        if (masked) {
          const int key = kv0 + 8 * nb + 2 * (lane % 4) + x % 2;
          p = key < lim[e] ? p : 0.f;
        }
        dp[nb][x] = p * (dp[nb][x] - dlt[e]);
      }
    mma_cb<D, NB>(dqa, dp, kst, P, lane);
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = q0 + 16 * warp + lane / 4 + 8 * e;
    if (i >= a.sq) continue;
    __nv_bfloat16* out =
        a.dq + (((long long)bi * a.sq + i) * a.h + hi) * D + 2 * (lane % 4);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * nd) =
          __floats2bfloat162_rn(dqa[nd][2 * e] * a.scale,
                                dqa[nd][2 * e + 1] * a.scale);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_tc_dkdv(Args a) {
  using C = Tile<D, DV>;
  constexpr int P = C::kPitch;
  constexpr int PV = C::kPitchV;
  constexpr int NB = kBQ / 8;    // 8-row column blocks of S^T
  extern __shared__ uint4 smem16[];
  unsigned char* ksm = reinterpret_cast<unsigned char*>(smem16);
  unsigned char* vsm = ksm + kBK * P;
  unsigned char* qst0 = vsm + kBK * PV;   // stage s: Q, dO, lse, D

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // blockIdx.x: (batch, KV head, half of the group's heads when split);
  // blockIdx.y: the key tile, so the tiles with the most queries come
  // first
  const int splits = a.part ? 2 : 1;
  const int sp = blockIdx.x % splits;
  const int bi = blockIdx.x / splits / a.kvh;
  const int gi = blockIdx.x / splits % a.kvh;
  const int g = a.h / a.kvh / splits;     // query heads this block walks
  const int h0 = gi * (g * splits) + sp * g;
  const int k0 = blockIdx.y * kBK;
  const __nv_bfloat16* kg = a.k + bi * a.k_sb + gi * a.k_sh;
  const __nv_bfloat16* vg = a.v + bi * a.v_sb + gi * a.v_sh;
  const long long orow = (long long)a.h * DV;

  // the first query that sees key k0: i + (Skv - Sq) >= k0 when causal
  const int first = a.causal ? max(0, k0 - (a.skv - a.sq)) : 0;
  const int qt0 = first / kBQ;
  const int nit = first < a.sq ? ((a.sq + kBQ - 1) / kBQ - qt0) * g : 0;

  auto load_q = [&](int it, int stage) {
    unsigned char* qst = qst0 + stage * C::kStageQ;
    unsigned char* dost = qst + kBQ * P;
    float* lst = reinterpret_cast<float*>(dost + kBQ * PV);
    const int q0 = (qt0 + it / g) * kBQ;
    const int hi = h0 + it % g;
    const __nv_bfloat16* qg = a.q + bi * a.q_sb + hi * a.q_sh;
    const long long obase = ((long long)bi * a.sq * a.h + hi) * DV;
    for (int c = tid; c < kBQ * C::kPieces; c += kThreads) {
      const int row = c / C::kPieces;
      const int pc = c % C::kPieces;
      const int i = q0 + row;
      const bool in = i < a.sq;
      cp_async16(qst + row * P + pc * 16, qg + (in ? i : 0) * a.q_ss + pc * 8,
                 in);
    }
    for (int c = tid; c < kBQ * C::kPiecesV; c += kThreads) {
      const int row = c / C::kPiecesV;
      const int pc = c % C::kPiecesV;
      const int i = q0 + row;
      const bool in = i < a.sq;
      cp_async16(dost + row * PV + pc * 16,
                 a.dout + obase + (in ? i : 0) * orow + pc * 8, in);
    }
    // lse (rows 0..63), then D (64..127): one 4-byte copy a thread
    const int row = tid % kBQ;
    const int i = q0 + row;
    const bool in = i < a.sq;
    const long long at = ((long long)bi * a.sq + (in ? i : 0)) * a.h + hi;
    cp_async4(lst + tid, tid < kBQ ? a.lse + at : a.delta + at, in);
  };

  for (int c = tid; c < kBK * C::kPieces; c += kThreads) {
    const int row = c / C::kPieces;
    const int pc = c % C::kPieces;
    const int j = k0 + row;
    const bool in = j < a.skv;
    cp_async16(ksm + row * P + pc * 16, kg + (in ? j : 0) * a.k_ss + pc * 8,
               in);
  }
  for (int c = tid; c < kBK * C::kPiecesV; c += kThreads) {
    const int row = c / C::kPiecesV;
    const int pc = c % C::kPiecesV;
    const int j = k0 + row;
    const bool in = j < a.skv;
    cp_async16(vsm + row * PV + pc * 16, vg + (in ? j : 0) * a.v_ss + pc * 8,
               in);
  }
  if (nit > 0) load_q(0, 0);
  cp_async_commit();

  float dka[D / 8][4], dva[DV / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int x = 0; x < 4; ++x) dka[nd][x] = 0.f;
#pragma unroll
  for (int nd = 0; nd < DV / 8; ++nd)
#pragma unroll
    for (int x = 0; x < 4; ++x) dva[nd][x] = 0.f;

  const int kw0 = k0 + 16 * warp;   // this warp's first key
  const unsigned char* krow = ksm + 16 * warp * P;
  const unsigned char* vrow = vsm + 16 * warp * PV;
  for (int it = 0; it < nit; ++it) {
    if (it + 1 < nit) {
      load_q(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* qst = qst0 + (it & 1) * C::kStageQ;
    const unsigned char* dost = qst + kBQ * P;
    const float* lst = reinterpret_cast<const float*>(dost + kBQ * PV);
    const float* dlt = lst + kBQ;
    const int q0 = (qt0 + it / g) * kBQ;

    float st[NB][4], dpt[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int x = 0; x < 4; ++x) st[nb][x] = dpt[nb][x] = 0.f;
    mma_abt<D, NB>(st, krow, P, qst, P, lane);
    mma_abt<DV, NB>(dpt, vrow, PV, dost, PV, lane);

    // P^T in place of S^T, dS^T in place of dP^T; element (key kw0 +
    // lane / 4 + 8 (x / 2), row q0 + 8 nb + 2 (lane % 4) + x % 2).  A warp
    // masks where its keys reach past the tile's smallest limit or the
    // tile past Sq (such rows count no key)
    const bool masked =
        kw0 + 16 > row_limit(a, q0) || q0 + kBQ > a.sq;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = 8 * nb + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lst + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt + col);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float lse2 = (x % 2 ? l2.y : l2.x) * kLog2e;
        const float dl = x % 2 ? d2.y : d2.x;
        float p = ex2(fmaf(st[nb][x], a.scale_log2, -lse2));
        if (masked) {
          const int key = kw0 + lane / 4 + 8 * (x / 2);
          p = key < row_limit(a, q0 + col + x % 2) ? p : 0.f;
        }
        st[nb][x] = p;
        dpt[nb][x] = p * (dpt[nb][x] - dl);
      }
    }
    mma_cb<DV, NB>(dva, st, dost, PV, lane);
    mma_cb<D, NB>(dka, dpt, qst, P, lane);
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = kw0 + lane / 4 + 8 * e;
    if (j >= a.skv) continue;
    const long long at = ((long long)bi * a.skv + j) * a.kvh + gi;
    if (a.part) {   // this half's sums, for flash_bwd_tc_combine
      float* out = a.part +
                   ((long long)sp * a.b * a.skv * a.kvh + at) * (D + DV) +
                   2 * (lane % 4);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(out + 8 * nd) =
            make_float2(dka[nd][2 * e], dka[nd][2 * e + 1]);
#pragma unroll
      for (int nd = 0; nd < DV / 8; ++nd)
        *reinterpret_cast<float2*>(out + D + 8 * nd) =
            make_float2(dva[nd][2 * e], dva[nd][2 * e + 1]);
      continue;
    }
    __nv_bfloat16* kout = a.dk + at * D + 2 * (lane % 4);
    __nv_bfloat16* vout = a.dv + at * DV + 2 * (lane % 4);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(kout + 8 * nd) =
          __floats2bfloat162_rn(dka[nd][2 * e] * a.scale,
                                dka[nd][2 * e + 1] * a.scale);
#pragma unroll
    for (int nd = 0; nd < DV / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(vout + 8 * nd) =
          __floats2bfloat162_rn(dva[nd][2 * e], dva[nd][2 * e + 1]);
  }
}

// dK = scale (half 0 + half 1), dV = half 0 + half 1, in that order,
// rounded to bf16: the two head halves of a split dK/dV launch
template <int D, int DV>
__global__ void __launch_bounds__(256) flash_bwd_tc_combine(Args a) {
  const long long rows = (long long)a.b * a.skv * a.kvh;
  const long long n = rows * (D + DV) / 2;      // pairs of columns
  const float2* p0 = reinterpret_cast<const float2*>(a.part);
  const float2* p1 = p0 + n;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    const float2 x = p0[i], y = p1[i];
    const long long r = i / ((D + DV) / 2);
    const int c = 2 * (int)(i % ((D + DV) / 2));
    if (c < D)
      *reinterpret_cast<__nv_bfloat162*>(a.dk + r * D + c) =
          __floats2bfloat162_rn((x.x + y.x) * a.scale, (x.y + y.y) * a.scale);
    else
      *reinterpret_cast<__nv_bfloat162*>(a.dv + r * DV + c - D) =
          __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
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

template <int D, int DV>
int launch_t(const Args& a, cudaStream_t stream) {
  using C = Tile<D, DV>;
  static bool dq_ready = false, dkdv_ready = false;
  int err = configure(flash_bwd_tc_dq<D, DV>, C::kSmemDq, dq_ready);
  if (err) return err;
  err = configure(flash_bwd_tc_dkdv<D, DV>, C::kSmemDkdv, dkdv_ready);
  if (err) return err;
  const dim3 g1((a.sq + kBQ - 1) / kBQ, a.b * a.h);
  flash_bwd_tc_dq<D, DV><<<g1, kThreads, C::kSmemDq, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 g2(a.b * a.kvh * (a.part ? 2 : 1), (a.skv + kBK - 1) / kBK);
  flash_bwd_tc_dkdv<D, DV><<<g2, kThreads, C::kSmemDkdv, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err || !a.part) return err;
  const long long pairs = (long long)a.b * a.skv * a.kvh * (D + DV) / 2;
  const long long want = (pairs + 255) / 256;
  flash_bwd_tc_combine<D, DV>
      <<<(int)(want < 65535 ? want : 65535), 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments of flash_attention_bwd_launch (flash_attention_bwd.cu):
// q (B, Sq, H, D), k (B, Skv, KV, D), v (B, Skv, KV, DV) strided views
// whose last dimension is contiguous and whose rows start on 16 bytes;
// o and dout (B, Sq, H, DV), lse (B, Sq, H) fp32 and the outputs dq, dk,
// dv contiguous; delta: fp32 scratch of B * Sq * H; part: null, or (H /
// KV even) fp32 scratch of 2 * B * Skv * KV * (D + DV), which splits each
// KV head's query heads over two dK/dV blocks and sums them in a third
// launch.  bfloat16 (dtype 1) only; (D, DV) one of the pairs of the
// tc forward: DV = D at every multiple of 16 up to 128, and MLA's
// (96, 64).  Launches the kernels on `stream` and returns the first
// cudaGetLastError().
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, float* part, int dtype, int b, int h, int kvh, int sq,
    int skv, int d,
    int d_v, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, float scale, void* stream) {
  if (dtype != 1 || d <= 0 || d > 128 || d % 16 != 0 || kvh <= 0 ||
      h % kvh != 0 || (long long)b * h > 65535 ||
      (part && (h / kvh) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || sq <= 0 || skv <= 0) return 0;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const __nv_bfloat16*>(o),
               static_cast<const __nv_bfloat16*>(dout),
               lse,
               static_cast<__nv_bfloat16*>(dq),
               static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv),
               delta, part, b, h, kvh, sq, skv, q_sb, q_ss, q_sh, k_sb, k_ss,
               k_sh, v_sb, v_ss, v_sh, causal, scale, scale * kLog2e};
  const cudaStream_t st = (cudaStream_t)stream;
  if (d == 96 && d_v == 64) return launch_t<96, 64>(a, st);
  if (d_v != d) return (int)cudaErrorInvalidValue;
  switch (d / 16) {
    case 1: return launch_t<16, 16>(a, st);
    case 2: return launch_t<32, 32>(a, st);
    case 3: return launch_t<48, 48>(a, st);
    case 4: return launch_t<64, 64>(a, st);
    case 5: return launch_t<80, 80>(a, st);
    case 6: return launch_t<96, 96>(a, st);
    case 7: return launch_t<112, 112>(a, st);
    case 8: return launch_t<128, 128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
