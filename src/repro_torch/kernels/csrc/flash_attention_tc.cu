// flash_attention_tc: forward attention in bf16 on the tensor cores for
// prefill and the encoder (more than 64 query rows per KV head; fewer
// take the split path, flash_attention_split.cu).
//
//   o[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,g,:] * scale) v[b,j,g,:]
//   over keys j < lim(b, i), g = h / (H / KV), q and k of head dim D, v
//   and o of head dim DV <= D (MLA: D 96, DV 64), where
//   lim(b, i) = min(Skv, len[b] or len[b, i], i + (Skv - Sq) + 1 if causal)
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:77
// (flash_attention_pallas) for bf16, and computes the reference oracle's
// function (flash_attention_ref of repro/models/layers/attention.py), as
// flash_attention.cu does.
//
// What bounds the prefill kernel on an H100: operations.  4 * D FLOP per
// counted (query, key) pair against 2 * D bytes per key row read:
// whisper's encoder (B 4, H 8, 1 500 x 1 500, D 64) is 1.84e10 FLOP, 18.6
// us at the 989e12 bf16 FLOP/s of the tensor cores, against 6 us for its
// 25 MB; Jamba's prefill (B 4, 2 048 queries, GQA 64/8, D 128, causal
// through its lengths) is 2.75e11 FLOP, 278 us.  Each pair also costs one
// exponential, and at D 64 the special-function units take about as long
// for the encoder's 72 M of them as the tensor cores take for the
// products; mma.sync issues in order, so the two add up where wgmma's
// asynchronous issue would let them overlap.
//
// The prefill design (FlashAttention-2 on mma.sync):
// * A block of four warps owns BQ query rows of one (batch, head): each
//   warp owns MT tiles of 16 rows (MT = 2 at D <= 64, 1 above, which keeps
//   a thread's Q fragments, scores and output in registers).  Blocks take
//   the query tiles from the last, so the longest causal rows start first.
// * Tiles of 64 keys of K and V come into shared memory by 16-byte
//   cp.async copies, a ring of two stages: the copy of tile j + 1 runs
//   while the products of tile j do.  Rows are padded by 16 bytes, so
//   ldmatrix reads eight rows in eight distinct bank groups.
// * S = Q K^T and O += P V run as mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate); Q, K and V come to registers by ldmatrix (V transposed).
//   The online softmax is fp32 in base 2: the max runs on the raw scores,
//   p = 2^(s * scale * log2(e) - m) is one FFMA and one ex2, and o is
//   rescaled only in tiles where some row's max moved.  P is rounded to
//   bf16 in registers and fed to the P V product as its A operand, with
//   no trip through shared memory.  l sums the fp32 p; the division is
//   fp32 and o is rounded once.
// * Tiles past every row's limit of the block (above the causal diagonal,
//   past mask_len, past Skv) are never loaded; a warp masks in registers
//   only the tiles that reach past the smallest limit of its rows.
// * Why mma.sync and not wgmma (a choice made at design time): wgmma reads
//   its B operand (and here A) through shared-memory descriptors whose
//   swizzle and layout must match the copy exactly, and a mismatch gives
//   wrong numbers, not a fault; the fragment layouts of mma.sync are fixed
//   and its design well trodden, so this first tensor-core kernel takes
//   it.  It runs at a part of Hopper's tensor-core rate and issues in
//   order; wgmma and TMA are the next step for speed.
// * Training: with a non-null lse pointer the quad's first lane writes
//   each row's natural-log log-sum-exp, ln 2 * (m + log2 l) of the
//   base-2 state (+inf for a row with no counted key), fp32 lse[b, i, h],
//   after the last tile: the backward's residual (flash_attention_bwd.cu).
// No atomics and a fixed order: every run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kBK = 64;         // keys per tile

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int* lens;  // null: no length mask
  float* lse;       // null: no log-sum-exp wanted
  int b, h, kvh, sq, skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long len_sb, len_sq;
  int causal;
  float scale_log2;  // scale * log2(e)
};

template <int D, int DV, int W, int MT>
struct Tile {
  static_assert(DV <= D && DV % 16 == 0, "V's head dim: a multiple of 16 "
                                         "up to Q's and K's");
  static constexpr int kThreads = 32 * W;       // W warps
  static constexpr int kBQ = W * 16 * MT;       // query rows a block
  static constexpr int kPitch = 2 * D + 16;     // bytes a shared Q or K row
  static constexpr int kPitchV = 2 * DV + 16;   // bytes a shared V row
  static constexpr int kPieces = D / 8;         // 16-byte pieces a K row
  static constexpr int kPiecesV = DV / 8;       // and a V row
  static constexpr int kStage = kBK * (kPitch + kPitchV);  // bytes a stage
  static constexpr size_t kSmem = size_t(kBQ) * kPitch + 2 * size_t(kStage);
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

template <int D, int DV, int W, int MT>
__global__ void __launch_bounds__(32 * W) flash_fwd_tc_kernel(Args a) {
  using C = Tile<D, DV, W, MT>;
  constexpr int kThreads = C::kThreads;
  constexpr int BQ = C::kBQ;
  constexpr int P = C::kPitch;
  constexpr int PV = C::kPitchV;
  constexpr int KS = D / 16;     // k-steps of Q K^T
  constexpr int NB = kBK / 8;    // 8-key column blocks of S
  constexpr int ND = DV / 8;     // 8-column blocks of O
  extern __shared__ uint4 smem16[];
  __shared__ int block_max[W];
  unsigned char* qsm = reinterpret_cast<unsigned char*>(smem16);
  unsigned char* kvs = qsm + BQ * P;   // stage s: K, then V, 64 rows each

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bi = blockIdx.y / a.h;
  const int hi = blockIdx.y % a.h;
  const int gi = hi / (a.h / a.kvh);
  const int q0 = qt * BQ;
  const __nv_bfloat16* qg = a.q + bi * a.q_sb + hi * a.q_sh;
  const __nv_bfloat16* kg = a.k + bi * a.k_sb + gi * a.k_sh;
  const __nv_bfloat16* vg = a.v + bi * a.v_sb + gi * a.v_sh;

  // this thread's rows: tile mt, half e -> row q0 + row0(mt) + lane/4 + 8e
  int lim[MT][2];
  int lmax = 0, lmin = INT_MAX;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = q0 + (warp * MT + mt) * 16 + lane / 4 + 8 * e;
      int l = 0;
      if (i < a.sq) {
        l = a.skv;
        if (a.lens) l = min(l, a.lens[bi * a.len_sb + i * a.len_sq]);
        if (a.causal) l = min(l, i + (a.skv - a.sq) + 1);
        l = max(l, 0);
      }
      lim[mt][e] = l;
      lmax = max(lmax, l);
      lmin = min(lmin, l);
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lmax = max(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    lmin = min(lmin, __shfl_xor_sync(0xffffffffu, lmin, off));
  }
  if (lane == 0) block_max[warp] = lmax;
  __syncthreads();
  int kv_end = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) kv_end = max(kv_end, block_max[w]);
  const int ntiles = (kv_end + kBK - 1) / kBK;

  float oacc[MT][ND][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int x = 0; x < 4; ++x) oacc[mt][nd][x] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  // keys at or past kv_end are zero-filled and never read from memory
  auto load_kv = [&](int tile, int stage) {
    unsigned char* kst = kvs + stage * C::kStage;
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

  if (ntiles > 0) {
    for (int c = tid; c < BQ * C::kPieces; c += kThreads) {
      const int row = c / C::kPieces;
      const int pc = c % C::kPieces;
      const int i = q0 + row;
      const bool in = i < a.sq;
      const long long ii = in ? i : 0;
      cp_async16(qsm + row * P + pc * 16, qg + ii * a.q_ss + pc * 8, in);
    }
    load_kv(0, 0);
    cp_async_commit();
  }

  uint32_t qf[MT][KS][4];
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
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int row = (warp * MT + mt) * 16 + lane % 8 + 8 * ((lane / 8) % 2);
          const int col = 16 * ks + 8 * (lane / 16);
          ldmatrix_x4(qf[mt][ks], qsm + row * P + col * 2);
        }
    }
    const unsigned char* kst = kvs + (it & 1) * C::kStage;
    const unsigned char* vst = kst + kBK * P;
    const int kv0 = it * kBK;

    float s[MT][NB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int x = 0; x < 4; ++x) s[mt][nb][x] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
        uint32_t kf[4];
        const int row = 16 * nb2 + lane % 8 + 8 * (lane / 16);
        const int col = 16 * ks + 8 * ((lane / 8) % 2);
        ldmatrix_x4(kf, kst + row * P + col * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * nb2], qf[mt][ks], kf[0], kf[1]);
          mma(s[mt][2 * nb2 + 1], qf[mt][ks], kf[2], kf[3]);
        }
      }

    const bool masked = kv0 + kBK > lmin;
    float corr[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // the max runs on the raw scores (scale > 0 keeps their order);
        // p = 2^(s * scale_log2 - m) is one FFMA and one ex2
        float mx = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float v = s[mt][nb][2 * e + x];
            if (masked) {
              const int key = kv0 + 8 * nb + 2 * (lane % 4) + x;
              v = key < lim[mt][e] ? v : -INFINITY;
              s[mt][nb][2 * e + x] = v;
            }
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][e], mx * a.scale_log2);
        // a row with no counted key so far keeps p = 0 and corr = 0
        const float m_ref = m_new == -INFINITY ? 0.f : m_new;
        corr[mt][e] = ex2(m[mt][e] - m_ref);
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float p =
                ex2(fmaf(s[mt][nb][2 * e + x], a.scale_log2, -m_ref));
            s[mt][nb][2 * e + x] = p;
            sum += p;
          }
        l[mt][e] = l[mt][e] * corr[mt][e] + sum;
        m[mt][e] = m_new;
      }
    // o is rescaled only when a row's max moved (after the first tiles,
    // seldom); a factor of 1 would leave it as it is
    bool moved = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      moved |= corr[mt][0] != 1.f || corr[mt][1] != 1.f;
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
#pragma unroll
          for (int x = 0; x < 4; ++x) oacc[mt][nd][x] *= corr[mt][x / 2];
    }

#pragma unroll
    for (int kv = 0; kv < kBK / 16; ++kv) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kv][0], s[mt][2 * kv][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kv][2], s[mt][2 * kv][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kv + 1][0], s[mt][2 * kv + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kv + 1][2], s[mt][2 * kv + 1][3]);
      }
#pragma unroll
      for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
        uint32_t vf[4];
        const int row = 16 * kv + lane % 8 + 8 * ((lane / 8) % 2);
        const int col = 8 * (2 * nd2 + lane / 16);
        ldmatrix_x4_trans(vf, vst + row * PV + col * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(oacc[mt][2 * nd2], pa[mt], vf[0], vf[1]);
          mma(oacc[mt][2 * nd2 + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float lt = l[mt][e];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float den = fmaxf(lt, 1e-30f);
      const int i = q0 + (warp * MT + mt) * 16 + lane / 4 + 8 * e;
      if (i >= a.sq) continue;
      if (a.lse && lane % 4 == 0)
        a.lse[((long long)bi * a.sq + i) * a.h + hi] =
            lt > 0.f ? (m[mt][e] + log2f(lt)) * 0.6931471805599453f
                     : INFINITY;
      __nv_bfloat16* orow =
          a.o + (((long long)bi * a.sq + i) * a.h + hi) * DV + 2 * (lane % 4);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nd) =
            __floats2bfloat162_rn(oacc[mt][nd][2 * e] / den,
                                  oacc[mt][nd][2 * e + 1] / den);
    }
}

template <int D, int DV, int W, int MT>
int launch_t(const Args& a, cudaStream_t stream) {
  using C = Tile<D, DV, W, MT>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D, DV, W, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((a.sq + C::kBQ - 1) / C::kBQ, a.b * a.h);
  flash_fwd_tc_kernel<D, DV, W, MT>
      <<<grid, C::kThreads, C::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch record; the same layout as in flash_attention_split.cu (see
// its note), field order matching kernels/flash_attention/kernel.py.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;       // unused here
  const int* lens;   // null: no length mask
  float* lse;        // null: no log-sum-exp wanted, else fp32 (B, Sq, H)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long len_sb, len_sq;
  int dtype, b, h, kvh, sq, skv, d, dv;
  int splits, chunk;  // unused here
  int causal;
  float scale;
};

// bfloat16 (dtype 1) only; (D, DV) one of the pairs built below, the
// pairs of flash_attention_split.cu.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int flash_attention_tc_launch(const void* record, void* stream) {
  FlashArgs f;
  std::memcpy(&f, record, sizeof f);
  if (f.dtype != 1 || f.d <= 0 || f.d > 128 || f.d % 16 != 0 || f.kvh <= 0 ||
      f.h % f.kvh != 0 || (long long)f.b * f.h > 65535)
    return (int)cudaErrorInvalidValue;
  if (f.b <= 0 || f.sq <= 0) return 0;
  const Args a{static_cast<const __nv_bfloat16*>(f.q),
               static_cast<const __nv_bfloat16*>(f.k),
               static_cast<const __nv_bfloat16*>(f.v),
               static_cast<__nv_bfloat16*>(f.o),
               f.lens, f.lse, f.b, f.h, f.kvh, f.sq, f.skv, f.q_sb, f.q_ss, f.q_sh,
               f.k_sb, f.k_ss, f.k_sh, f.v_sb, f.v_ss, f.v_sh, f.len_sb,
               f.len_sq, f.causal, f.scale * 1.4426950408889634f};
  const cudaStream_t st = (cudaStream_t)stream;
  if (f.dv == 64 && f.d == 96) return launch_t<96, 64, 4, 1>(a, st);
  if (f.dv != f.d) return (int)cudaErrorInvalidValue;
  switch (f.d / 16) {
    case 1: return launch_t<16, 16, 4, 2>(a, st);
    case 2: return launch_t<32, 32, 4, 2>(a, st);
    case 3: return launch_t<48, 48, 4, 2>(a, st);
    case 4: return launch_t<64, 64, 4, 2>(a, st);
    case 5: return launch_t<80, 80, 4, 1>(a, st);
    case 6: return launch_t<96, 96, 4, 1>(a, st);
    case 7: return launch_t<112, 112, 4, 1>(a, st);
    case 8: return launch_t<128, 128, 4, 1>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// sizeof(FlashArgs), so the binding can check its record layout.
extern "C" int flash_attention_args_size() { return (int)sizeof(FlashArgs); }
