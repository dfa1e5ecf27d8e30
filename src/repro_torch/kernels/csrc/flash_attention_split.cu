// flash_attention_split: forward attention for calls with few query rows
// per KV head (decode, cross-attention, cached self-attention), split
// over the keys and packed over the query heads that share a KV head; bf16
// on the tensor cores, fp32 on the CUDA cores, and the combine of the
// ranges for both.
//
//   o[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,g,:] * scale) v[b,j,g,:]
//   over keys j < lim(b, i), g = h / (H / KV), q and k of head dim D, v
//   and o of head dim DV <= D (MLA: D 96, DV 64), where
//   lim(b, i) = min(Skv, len[b] or len[b, i], i + (Skv - Sq) + 1 if causal)
//
// Replaces, for these shapes, the TPU kernel
// repro/kernels/flash_attention/kernel.py:77 (flash_attention_pallas),
// and computes the reference oracle's function (flash_attention_ref of
// repro/models/layers/attention.py), as flash_attention.cu does.
//
// What bounds it on an H100: bytes.  With Sq * (H / KV) <= 64 query rows
// per KV head, each K/V element read feeds at most 64 rows, far below the
// ~295 FLOP a byte (bf16; ~20 for fp32 on the CUDA cores) at which the
// card stops being bound by its memory.  A Jamba decode step (B 4, GQA
// 64/8, D 128, 2 080 cached keys) reads 34 MB of K/V in bf16: 10.2 us at
// 3.35 TB/s; whisper's cross-attention at Sq 1 reads 12 MB: 3.7 us.
//
// * Packing.  The Sq * G query rows of one (batch, KV head), G = H / KV,
//   form one tile: row r = t * G + j is query t of head g * G + j.  So
//   each K/V tile is read once for all G heads that share it.
// * Splits.  The keys below the rows' largest limit are cut into
//   `splits` ranges of whole 64-key tiles (ops.choose_path keeps B * KV *
//   splits within one wave of blocks); block (s, b * KV + g) owns range s.
//   A range that starts at or past its rows' largest limit reads nothing.
// * Loads.  Each 64-key tile of K and V comes into shared memory by
//   16-byte cp.async copies, into a ring of two stages: the copy of tile
//   i + 1 runs while tile i is computed.  Rows are padded by 16 bytes, so
//   a warp reading key rows at once hits distinct bank groups.  K rows
//   hold D values and V rows DV, each tile at its own pitch.
// * Arithmetic, bf16 (flash_fwd_split_tc_kernel): mma.sync m16n8k16, bf16
//   in, fp32 accumulate.  Warps (wm, wk): wm over 16-row tiles (WM = 4 /
//   WK of them), wk over a quarter, half or all of each 64-key tile (WK =
//   4, 2, 1 as the rows are <= 16, 32, 64).  So at decode all four warps
//   work, each on its own 16 keys of every tile with its own (m, l, acc),
//   and K and V are read from shared memory once; at the end the warps'
//   states merge in shared memory.  The softmax is fp32 in base 2 and P
//   goes to the P V product as bf16 registers, as in flash_attention_tc.cu.
// * Arithmetic, fp32 (flash_fwd_split_kernel): thread t scores key t % 64
//   against rows t / 64, t / 64 + 2, ...; one warp per row takes the
//   tile's max and sum with shuffles (base 2, log2(e) folded into the
//   scale); then thread (x, y) accumulates pairs of output columns of rows
//   y, y + TY, ... over the tile's keys, all with fmaf, so it holds the
//   reference's 2e-5 (TF32 would not).  Each shared-memory load feeds only
//   a few FMAs, so this kernel is bound by its instruction issue, well
//   above the byte bound.
// * Combine.  Each range writes its fp32 (m, l, acc) to one scratch
//   tensor; flash_fwd_combine_kernel merges the ranges of each row in a
//   fixed order and rounds o once; the same entry launches both, so a
//   call crosses from the host into C once.  The combine is a plain
//   launch: launched as a programmatic dependent of the split kernel it
//   cost more host time a call while the split kernel ran than it saved
//   on the card, in whisper's host-bound decode steps.  No atomics: two
//   runs give the same bits.  With one range (whisper's self-attention
//   against 48 cached keys) the first kernel divides and writes o itself,
//   and no combine is launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;           // keys per tile
constexpr int kSP = kBK + 4;      // row pitch of the score tile (floats)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;          // written when part_m is null (one range)
  float* part_m;    // [splits][B * KV][rows]
  float* part_l;    // [splits][B * KV][rows]
  float* part_acc;  // [splits][B * KV][rows][DV]
  const int* lens;  // null: no length mask
  int b, h, kvh, sq, skv, g, rows, chunk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long len_sb, len_sq;
  int causal;
  float scale_log2;  // scale * log2(e)
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

// 2^x in one MUFU op, subnormal results flushed to 0 (a p below 2^-126
// of its row's largest is below any bf16 output's resolution)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// largest power of two that divides n, at most cap
constexpr int pow2_divisor(int n, int cap) {
  return (n % 2 == 0 && cap > 1) ? 2 * pow2_divisor(n / 2, cap / 2) : 1;
}

template <int D, int DV, int RP>
struct Layout {
  static_assert(DV <= D && DV % 16 == 0, "V's head dim: a multiple of 16 "
                                         "up to Q's and K's");
  static constexpr int kVec = 4;                     // floats a piece
  static constexpr int kPieces = D / kVec;           // pieces a K row
  static constexpr int kPiecesV = DV / kVec;         // pieces a V row
  static constexpr int kPitch = 4 * D + 16;          // bytes a K row
  static constexpr int kPitchV = 4 * DV + 16;        // bytes a V row
  static constexpr int kTile = kBK * kPitch;         // bytes a K tile
  static constexpr int kTileV = kBK * kPitchV;       // bytes a V tile
  static constexpr int kStage = kTile + kTileV;      // bytes a ring stage
  static constexpr int kDQ = D + 4;                  // q row pitch (floats)
  static constexpr int kRH = (RP + 1) / 2;           // score rows a thread
  static constexpr int kTPX = pow2_divisor(DV / 2, 64);  // threads on pairs
  static constexpr int kPPT = DV / 2 / kTPX;         // pairs a thread
  static constexpr int kTY = kThreads / kTPX;        // threads on rows
  static constexpr int kRPT = (RP + kTY - 1) / kTY;  // rows a thread
  static constexpr size_t kSmem =
      size_t(2) * kStage +
      sizeof(float) * (size_t(RP) * kDQ + size_t(RP) * kSP + 3 * RP) +
      sizeof(int) * RP;
};

template <int D, int DV, int RP>
__global__ void __launch_bounds__(kThreads) flash_fwd_split_kernel(Args a) {
  using L = Layout<D, DV, RP>;
  extern __shared__ uint4 smem16[];
  unsigned char* kv = reinterpret_cast<unsigned char*>(smem16);  // 2 x (K, V)
  float* qs = reinterpret_cast<float*>(kv + 2 * L::kStage);      // [RP][kDQ]
  float* ss = qs + RP * L::kDQ;                                  // [RP][kSP]
  float* m_s = ss + RP * kSP;
  float* l_s = m_s + RP;
  float* c_s = l_s + RP;
  int* lim_s = reinterpret_cast<int*>(c_s + RP);

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int pair = blockIdx.y;          // b * KV + g
  const int bi = pair / a.kvh;
  const int gi = pair % a.kvh;
  const float* qg = static_cast<const float*>(a.q) + bi * a.q_sb;
  const float* kg = static_cast<const float*>(a.k) + bi * a.k_sb + gi * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + bi * a.v_sb + gi * a.v_sh;

  if (tid < RP) {
    int lim = 0;
    if (tid < a.rows) {
      const int t = tid / a.g;
      lim = a.skv;
      if (a.lens) lim = min(lim, a.lens[bi * a.len_sb + t * a.len_sq]);
      if (a.causal) lim = min(lim, t + (a.skv - a.sq) + 1);
      lim = max(lim, 0);
    }
    lim_s[tid] = lim;
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  for (int idx = tid; idx < RP * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float x = 0.f;
    if (r < a.rows) {
      const int t = r / a.g;
      const int hh = gi * a.g + r % a.g;
      x = qg[t * a.q_ss + hh * a.q_sh + d];
    }
    qs[r * L::kDQ + d] = x;
  }
  __syncthreads();

  int kv_end = 0;
  for (int r = 0; r < RP; ++r) kv_end = max(kv_end, lim_s[r]);
  const int begin = split * a.chunk;
  const int end = min(begin + a.chunk, kv_end);
  const int ntiles = end > begin ? (end - begin + kBK - 1) / kBK : 0;

  // keys at or past `end` are zero-filled: their p is 0 and never meets
  // garbage
  auto load = [&](int tile, int stage) {
    unsigned char* kst = kv + stage * L::kStage;
    unsigned char* vst = kst + L::kTile;
    const int j0 = begin + tile * kBK;
    for (int c = tid; c < kBK * L::kPieces; c += kThreads) {
      const int row = c / L::kPieces;
      const int pc = c % L::kPieces;
      const int j = j0 + row;
      const bool in = j < end;
      const long long jj = in ? j : 0;
      cp_async16(kst + row * L::kPitch + pc * 16,
                 kg + jj * a.k_ss + pc * L::kVec, in);
      if (DV == D || pc < L::kPiecesV)
        cp_async16(vst + row * L::kPitchV + pc * 16,
                   vg + jj * a.v_ss + pc * L::kVec, in);
    }
    cp_async_commit();
  };

  // pass 2 (output columns): thread (tx, ty)
  const int tx = tid % L::kTPX;
  const int ty = tid / L::kTPX;
  float acc[L::kRPT][L::kPPT][2];
#pragma unroll
  for (int i = 0; i < L::kRPT; ++i)
#pragma unroll
    for (int c = 0; c < L::kPPT; ++c) acc[i][c][0] = acc[i][c][1] = 0.f;

  // pass 1 (scores): thread (key kk, rows rh + 2 i)
  const int kk = tid % kBK;
  const int rh = tid / kBK;
  int lim[L::kRH];
#pragma unroll
  for (int i = 0; i < L::kRH; ++i) {
    const int r = rh + 2 * i;
    lim[i] = r < RP ? lim_s[r] : 0;
  }
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (ntiles > 0) load(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kst = kv + (it & 1) * L::kStage;
    const unsigned char* vst = kst + L::kTile;
    const int j0 = begin + it * kBK;

    // scores of key kk against this thread's rows
    {
      float s[L::kRH];
#pragma unroll
      for (int i = 0; i < L::kRH; ++i) s[i] = 0.f;
      const unsigned char* krow = kst + kk * L::kPitch;
#pragma unroll 2
      for (int pc = 0; pc < L::kPieces; ++pc) {
        const float4 k4 = *reinterpret_cast<const float4*>(krow + pc * 16);
        const float kf[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < L::kRH; ++i) {
          const int r = rh + 2 * i;
          if (r >= RP) continue;
          const float* qrow = qs + r * L::kDQ + pc * L::kVec;
          float x = s[i];
#pragma unroll
          for (int e = 0; e < L::kVec; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qrow + e);
            x = fmaf(qq.x, kf[e], x);
            x = fmaf(qq.y, kf[e + 1], x);
            x = fmaf(qq.z, kf[e + 2], x);
            x = fmaf(qq.w, kf[e + 3], x);
          }
          s[i] = x;
        }
      }
      const int j = j0 + kk;
#pragma unroll
      for (int i = 0; i < L::kRH; ++i) {
        const int r = rh + 2 * i;
        if (r >= RP) continue;
        // padding rows (r >= rows) keep p = 0 and skip the softmax
        ss[r * kSP + kk] = r >= a.rows                ? 0.f
                           : j < lim[i] && j < end ? s[i] * a.scale_log2
                                                    : -INFINITY;
      }
    }
    __syncthreads();

    // the tile's softmax, one warp a row
    for (int r = warp; r < a.rows && r < RP; r += kThreads / 32) {
      float* srow = ss + r * kSP;
      const float x0 = srow[lane];
      const float x1 = srow[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      // a row with no counted key so far keeps p = 0 and corr = 0
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = exp2f(x0 - m_ref);
      const float p1 = exp2f(x1 - m_ref);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = exp2f(m_old - m_ref);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v
#pragma unroll
    for (int i = 0; i < L::kRPT; ++i) {
      const int r = ty + L::kTY * i;
      if (r >= RP) continue;
      const float corr = r < a.rows ? c_s[r] : 1.f;
#pragma unroll
      for (int c = 0; c < L::kPPT; ++c) {
        acc[i][c][0] *= corr;
        acc[i][c][1] *= corr;
      }
    }
#pragma unroll 2
    for (int jb = 0; jb < kBK; jb += 4) {
      float2 vv[4][L::kPPT];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow =
            reinterpret_cast<const float*>(vst + (jb + jj) * L::kPitchV);
#pragma unroll
        for (int c = 0; c < L::kPPT; ++c)
          vv[jj][c] = *reinterpret_cast<const float2*>(
              vrow + 2 * (tx + L::kTPX * c));
      }
#pragma unroll
      for (int i = 0; i < L::kRPT; ++i) {
        const int r = ty + L::kTY * i;
        if (r >= RP) continue;
        const float4 p4 = *reinterpret_cast<const float4*>(ss + r * kSP + jb);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < L::kPPT; ++c) {
            acc[i][c][0] = fmaf(pj[jj], vv[jj][c].x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pj[jj], vv[jj][c].y, acc[i][c][1]);
          }
      }
    }
    __syncthreads();
  }

  const long long nparts = (long long)gridDim.y * a.rows;
  if (a.part_m != nullptr && tid < a.rows) {
    const long long at = split * nparts + (long long)pair * a.rows + tid;
    a.part_m[at] = m_s[tid];
    a.part_l[at] = l_s[tid];
  }
#pragma unroll
  for (int i = 0; i < L::kRPT; ++i) {
    const int r = ty + L::kTY * i;
    if (r >= RP || r >= a.rows) continue;
    if (a.part_m != nullptr) {
      float* prow = a.part_acc +
                    (split * nparts + (long long)pair * a.rows + r) * DV;
#pragma unroll
      for (int c = 0; c < L::kPPT; ++c)
        *reinterpret_cast<float2*>(prow + 2 * (tx + L::kTPX * c)) =
            make_float2(acc[i][c][0], acc[i][c][1]);
    } else {
      const float den = fmaxf(l_s[r], 1e-30f);
      const int t = r / a.g;
      const int hh = gi * a.g + r % a.g;
      float* orow = static_cast<float*>(a.o) +
                    (((long long)bi * a.sq + t) * a.h + hh) * DV;
#pragma unroll
      for (int c = 0; c < L::kPPT; ++c)
        *reinterpret_cast<float2*>(orow + 2 * (tx + L::kTPX * c)) =
            make_float2(acc[i][c][0] / den, acc[i][c][1] / den);
    }
  }
}

template <int D, int DV, int WK>
struct SplitTile {
  static_assert(DV <= D && DV % 16 == 0, "V's head dim: a multiple of 16 "
                                         "up to Q's and K's");
  static constexpr int kWM = 4 / WK;        // warps over 16-row tiles
  static constexpr int kRB = 16 * kWM;      // packed rows a block holds
  static constexpr int kKW = kBK / WK;      // keys of a tile a warp takes
  static constexpr int kPitch = 2 * D + 16;   // bytes a Q or K row
  static constexpr int kPitchV = 2 * DV + 16; // bytes a V row
  static constexpr int kPieces = D / 8;
  static constexpr int kPiecesV = DV / 8;
  static constexpr int kStage = kBK * (kPitch + kPitchV);  // bytes a stage
  static constexpr int kDO = DV + 4;        // row pitch of the merge (floats)
  static constexpr size_t kRing = size_t(2) * kStage;
  static constexpr size_t kMerge = sizeof(float) * WK * kRB * (kDO + 2);
  static constexpr size_t kSmem =
      size_t(kRB) * kPitch + (kRing > kMerge ? kRing : kMerge);
};

template <int D, int DV, int WK>
__global__ void __launch_bounds__(128) flash_fwd_split_tc_kernel(Args a) {
  using C = SplitTile<D, DV, WK>;
  constexpr int RB = C::kRB;
  constexpr int KW = C::kKW;
  constexpr int P = C::kPitch;
  constexpr int PV = C::kPitchV;
  constexpr int KS = D / 16;
  constexpr int NB = KW / 8;     // 8-key column blocks of a warp's scores
  constexpr int ND = DV / 8;
  extern __shared__ uint4 smem16[];
  __shared__ int lim_s[RB];
  unsigned char* qsm = reinterpret_cast<unsigned char*>(smem16);
  unsigned char* kvs = qsm + RB * P;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WK;
  const int wk = warp % WK;
  const int split = blockIdx.x;
  const int pair = blockIdx.y;          // b * KV + g
  const int bi = pair / a.kvh;
  const int gi = pair % a.kvh;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(a.q) + bi * a.q_sb;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(a.k) + bi * a.k_sb + gi * a.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(a.v) + bi * a.v_sb + gi * a.v_sh;

  if (tid < RB) {
    int lim = 0;
    if (tid < a.rows) {
      const int t = tid / a.g;
      lim = a.skv;
      if (a.lens) lim = min(lim, a.lens[bi * a.len_sb + t * a.len_sq]);
      if (a.causal) lim = min(lim, t + (a.skv - a.sq) + 1);
      lim = max(lim, 0);
    }
    lim_s[tid] = lim;
  }
  __syncthreads();
  int kv_end = 0;
#pragma unroll 8
  for (int r = 0; r < RB; ++r) kv_end = max(kv_end, lim_s[r]);
  const int begin = split * a.chunk;
  const int end = min(begin + a.chunk, kv_end);
  const int ntiles = end > begin ? (end - begin + kBK - 1) / kBK : 0;
  // keys this thread's two rows count in this range: j < elim[e]
  int elim[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    elim[e] = min(lim_s[16 * wm + lane / 4 + 8 * e], end);

  // keys at or past `end` are zero-filled and never read from memory
  auto load_kv = [&](int tile, int stage) {
    unsigned char* kst = kvs + stage * C::kStage;
    unsigned char* vst = kst + kBK * P;
    const int j0 = begin + tile * kBK;
    for (int c = tid; c < kBK * C::kPieces; c += 128) {
      const int row = c / C::kPieces;
      const int pc = c % C::kPieces;
      const int j = j0 + row;
      const bool in = j < end;
      const long long jj = in ? j : 0;
      cp_async16(kst + row * P + pc * 16, kg + jj * a.k_ss + pc * 8, in);
      if (DV == D || pc < C::kPiecesV)
        cp_async16(vst + row * PV + pc * 16, vg + jj * a.v_ss + pc * 8, in);
    }
  };

  if (ntiles > 0) {
    for (int c = tid; c < RB * C::kPieces; c += 128) {
      const int row = c / C::kPieces;
      const int pc = c % C::kPieces;
      const bool in = row < a.rows;
      const int t = in ? row / a.g : 0;
      const int hh = gi * a.g + (in ? row % a.g : 0);
      cp_async16(qsm + row * P + pc * 16,
                 qg + t * a.q_ss + hh * a.q_sh + pc * 8, in);
    }
    load_kv(0, 0);
    cp_async_commit();
  }

  float oacc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int x = 0; x < 4; ++x) oacc[nd][x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  uint32_t qf[KS][4];

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_kv(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int row = 16 * wm + lane % 8 + 8 * ((lane / 8) % 2);
        const int col = 16 * ks + 8 * (lane / 16);
        ldmatrix_x4(qf[ks], qsm + row * P + col * 2);
      }
    }
    const unsigned char* kst = kvs + (it & 1) * C::kStage;
    const unsigned char* vst = kst + kBK * P;
    const int k0 = wk * KW;                    // this warp's first tile row
    const int kv0 = begin + it * kBK + k0;     // and its key

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[nb][x] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
        uint32_t kf[4];
        const int row = k0 + 16 * nb2 + lane % 8 + 8 * (lane / 16);
        const int col = 16 * ks + 8 * ((lane / 8) % 2);
        ldmatrix_x4(kf, kst + row * P + col * 2);
        mma(s[2 * nb2], qf[ks], kf[0], kf[1]);
        mma(s[2 * nb2 + 1], qf[ks], kf[2], kf[3]);
      }

#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int key = kv0 + 8 * nb + 2 * (lane % 4) + x;
          const float v = key < elim[e] ? s[nb][2 * e + x] : -INFINITY;
          s[nb][2 * e + x] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[e], mx * a.scale_log2);
      // a row with no counted key so far keeps p = 0 and corr = 0
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      const float corr = ex2(m[e] - m_ref);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float p = ex2(fmaf(s[nb][2 * e + x], a.scale_log2, -m_ref));
          s[nb][2 * e + x] = p;
          sum += p;
        }
      l[e] = l[e] * corr + sum;
      m[e] = m_new;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        oacc[nd][2 * e] *= corr;
        oacc[nd][2 * e + 1] *= corr;
      }
    }

#pragma unroll
    for (int kv = 0; kv < KW / 16; ++kv) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kv][0], s[2 * kv][1]);
      pa[1] = pack_bf16(s[2 * kv][2], s[2 * kv][3]);
      pa[2] = pack_bf16(s[2 * kv + 1][0], s[2 * kv + 1][1]);
      pa[3] = pack_bf16(s[2 * kv + 1][2], s[2 * kv + 1][3]);
#pragma unroll
      for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
        uint32_t vf[4];
        const int row = k0 + 16 * kv + lane % 8 + 8 * ((lane / 8) % 2);
        const int col = 8 * (2 * nd2 + lane / 16);
        ldmatrix_x4_trans(vf, vst + row * PV + col * 2);
        mma(oacc[2 * nd2], pa, vf[0], vf[1]);
        mma(oacc[2 * nd2 + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();
  }

  // merge the WK warps of each row tile (the ring is free now)
  float* mbuf = reinterpret_cast<float*>(kvs);    // [WK][RB]
  float* lbuf = mbuf + WK * RB;                   // [WK][RB]
  float* obuf = lbuf + WK * RB;                   // [WK][RB][kDO]
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float lt = l[e];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = 16 * wm + lane / 4 + 8 * e;
    if (lane % 4 == 0) {
      mbuf[wk * RB + row] = m[e];
      lbuf[wk * RB + row] = lt;
    }
    float* orow = obuf + (wk * RB + row) * C::kDO + 2 * (lane % 4);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<float2*>(orow + 8 * nd) =
          make_float2(oacc[nd][2 * e], oacc[nd][2 * e + 1]);
  }
  __syncthreads();
  const long long nparts = (long long)gridDim.y * a.rows;
  for (int idx = tid; idx < RB * DV; idx += 128) {
    const int r = idx / DV;
    const int c = idx % DV;
    if (r >= a.rows) break;
    float top = -INFINITY;
#pragma unroll
    for (int w = 0; w < WK; ++w) top = fmaxf(top, mbuf[w * RB + r]);
    const float ref = top == -INFINITY ? 0.f : top;
    float acc = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const float wt = exp2f(mbuf[w * RB + r] - ref);
      acc += obuf[(w * RB + r) * C::kDO + c] * wt;
      den += lbuf[w * RB + r] * wt;
    }
    if (a.part_m != nullptr) {
      const long long at = split * nparts + (long long)pair * a.rows + r;
      a.part_acc[at * DV + c] = acc;
      if (c == 0) {
        a.part_m[at] = top;
        a.part_l[at] = den;
      }
    } else {
      const int t = r / a.g;
      const int hh = gi * a.g + r % a.g;
      static_cast<__nv_bfloat16*>(
          a.o)[(((long long)bi * a.sq + t) * a.h + hh) * DV + c] =
          __float2bfloat16_rn(acc / fmaxf(den, 1e-30f));
    }
  }
}

// o[row] = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), M = max_s m_s,
// the ranges taken in order.  Block (row, b * KV + g), threads on columns.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_combine_kernel(
    const float* part_m, const float* part_l, const float* part_acc, T* o,
    int splits, int rows, int g, int h, int sq, int d) {
  const int r = blockIdx.x;
  const int pair = blockIdx.y;
  const int kvh = h / g;
  const long long nparts = (long long)gridDim.y * rows;
  const long long base = (long long)pair * rows + r;
  float top = -INFINITY;
  for (int s = 0; s < splits; ++s) top = fmaxf(top, part_m[s * nparts + base]);
  if (top == -INFINITY) top = 0.f;
  float den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long at = s * nparts + base;
    den += part_l[at] * exp2f(part_m[at] - top);
  }
  den = fmaxf(den, 1e-30f);
  const int bi = pair / kvh;
  const int gi = pair % kvh;
  const int t = r / g;
  const int hh = gi * g + r % g;
  T* orow = o + (((long long)bi * sq + t) * h + hh) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float x = 0.f;
    for (int s = 0; s < splits; ++s) {
      const long long at = s * nparts + base;
      x += part_acc[at * d + c] * exp2f(part_m[at] - top);
    }
    if constexpr (sizeof(T) == 2)
      orow[c] = __float2bfloat16_rn(x / den);
    else
      orow[c] = x / den;
  }
}

template <int D, int DV, int RP>
int launch_t(const Args& a, int splits, cudaStream_t stream) {
  constexpr size_t smem = Layout<D, DV, RP>::kSmem;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_split_kernel<D, DV, RP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(splits, a.b * a.kvh);
  flash_fwd_split_kernel<D, DV, RP><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_rows(const Args& a, int splits, cudaStream_t stream) {
  if (a.rows <= 1) return launch_t<D, DV, 1>(a, splits, stream);
  if (a.rows <= 8) return launch_t<D, DV, 8>(a, splits, stream);
  if (a.rows <= 16) return launch_t<D, DV, 16>(a, splits, stream);
  return launch_t<D, DV, 64>(a, splits, stream);
}

template <int D, int DV, int WK>
int launch_split_t(const Args& a, int splits, cudaStream_t stream) {
  using C = SplitTile<D, DV, WK>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_split_tc_kernel<D, DV, WK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(splits, a.b * a.kvh);
  flash_fwd_split_tc_kernel<D, DV, WK><<<grid, 128, C::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_split_w(const Args& a, int splits, cudaStream_t stream) {
  if (a.rows <= 16) return launch_split_t<D, DV, 4>(a, splits, stream);
  if (a.rows <= 32) return launch_split_t<D, DV, 2>(a, splits, stream);
  return launch_split_t<D, DV, 1>(a, splits, stream);
}

// one (D, DV) instance, bf16 on the tensor cores or fp32 on the CUDA cores
template <int D, int DV>
int launch_dtype(const Args& a, int dtype, int splits, cudaStream_t stream) {
  return dtype == 1 ? launch_split_w<D, DV>(a, splits, stream)
                    : launch_rows<D, DV>(a, splits, stream);
}

// the (D, DV) pairs built: DV = D at every multiple of 16 up to 128, and
// MLA's (96, 64); kernels/flash_attention/ops.py::HEAD_DIMS lists the same
int launch_pair(const Args& a, int dtype, int splits, int d, int dv,
                cudaStream_t stream) {
  if (dv == d) {
    switch (d / 16) {
      case 1: return launch_dtype<16, 16>(a, dtype, splits, stream);
      case 2: return launch_dtype<32, 32>(a, dtype, splits, stream);
      case 3: return launch_dtype<48, 48>(a, dtype, splits, stream);
      case 4: return launch_dtype<64, 64>(a, dtype, splits, stream);
      case 5: return launch_dtype<80, 80>(a, dtype, splits, stream);
      case 6: return launch_dtype<96, 96>(a, dtype, splits, stream);
      case 7: return launch_dtype<112, 112>(a, dtype, splits, stream);
      case 8: return launch_dtype<128, 128>(a, dtype, splits, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (d == 96 && dv == 64)
    return launch_dtype<96, 64>(a, dtype, splits, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_combine(const Args& a, int dtype, int splits, int d,
                   cudaStream_t stream) {
  const dim3 grid(a.rows, a.b * a.kvh);
  const dim3 block(d <= 64 ? 64 : 128);
  if (dtype == 0)
    flash_fwd_combine_kernel<float><<<grid, block, 0, stream>>>(
        a.part_m, a.part_l, a.part_acc, static_cast<float*>(a.o), splits,
        a.rows, a.g, a.h, a.sq, d);
  else
    flash_fwd_combine_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(
        a.part_m, a.part_l, a.part_acc, static_cast<__nv_bfloat16*>(a.o),
        splits, a.rows, a.g, a.h, a.sq, d);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch record of the attention kernels, read by this file's entry
// and by flash_attention_tc_launch (flash_attention_tc.cu); field order
// must match kernels/flash_attention/kernel.py.  q (B, Sq, H, D), k
// (B, Skv, KV, D) and v (B, Skv, KV, DV) are strided views whose last
// dimension is contiguous and whose rows start on 16 bytes (strides in
// elements for batch, sequence, head); o (B, Sq, H, DV) is contiguous;
// all four float32 (dtype 0) or bfloat16 (dtype 1).  lens: null, or int32
// (B,) (len_sq = 0) or (B, Sq) valid key lengths.  (D, DV) one of the
// built pairs (launch_pair), H a multiple of KV.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;       // split scratch (splits > 1), else null
  const int* lens;   // null: no length mask
  float* lse;        // the tensor-core kernel's; null here (inference only)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long len_sb, len_sq;
  int dtype, b, h, kvh, sq, skv, d, dv;
  int splits, chunk;  // key ranges of `chunk` keys (a multiple of 64)
  int causal;
  float scale;
};

// The split path: Sq * (H / KV) <= 64.  With splits > 1, `part` holds
// splits * B * KV * Sq * (H / KV) * (DV + 2) floats: the first kernel
// writes each range's m, l and acc there and the combine, launched here
// too, writes o; with one split `part` is null and the first kernel
// writes o.  Launches on `stream`, returns the first launch error.
extern "C" int flash_attention_split_launch(const void* record,
                                            void* stream) {
  FlashArgs f;
  std::memcpy(&f, record, sizeof f);
  if (f.d <= 0 || f.d > 128 || f.d % 16 != 0 || f.dv <= 0 || f.kvh <= 0 ||
      f.h % f.kvh != 0 || f.splits <= 0 || f.chunk <= 0 ||
      f.chunk % kBK != 0 || (long long)f.b * f.kvh > 65535 ||
      (f.splits > 1) != (f.part != nullptr) || f.lse != nullptr ||
      (f.dtype != 0 && f.dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int g = f.h / f.kvh;
  const int rows = f.sq * g;
  if (rows > 64) return (int)cudaErrorInvalidValue;
  if (f.b <= 0 || f.sq <= 0) return 0;
  const long long n = (long long)f.splits * f.b * f.kvh * rows;
  float* part_l = f.part ? f.part + n : nullptr;
  float* part_acc = f.part ? f.part + 2 * n : nullptr;
  const Args a{f.q,    f.k,      f.v,      f.o,      f.part, part_l, part_acc,
               f.lens, f.b,      f.h,      f.kvh,    f.sq,   f.skv,  g,
               rows,   f.chunk,  f.q_sb,   f.q_ss,   f.q_sh, f.k_sb, f.k_ss,
               f.k_sh, f.v_sb,   f.v_ss,   f.v_sh,   f.len_sb, f.len_sq,
               f.causal, f.scale * 1.4426950408889634f};
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_pair(a, f.dtype, f.splits, f.d, f.dv, st);
  if (err != 0 || f.splits == 1) return err;
  return launch_combine(a, f.dtype, f.splits, f.dv, st);
}

// sizeof(FlashArgs), so the binding can check its record layout.
extern "C" int flash_attention_args_size() { return (int)sizeof(FlashArgs); }
