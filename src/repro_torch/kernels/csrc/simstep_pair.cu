// simstep_pair: the flit-level NoC simulator's per-cycle transition as two
// kernels a cycle, for the cells whose lane the chunk kernel (simstep.cu)
// cannot lay out: no divisor of the node count gives both at most 16
// blocks a lane (one thread-block cluster) and a block's per-input state
// and head flits within its shared memory (64x64, 96x96; prime-sided
// meshes such as 17x17).  ops.card_kernel chooses between the two by shape.
//
//   simstep_tile    stages 1-6 of the cycle for one node tile per block:
//                   packet generation, source-queue push, flit injection,
//                   table-routed port selection, eligibility, round-robin
//                   switch allocation, pops, wormhole locks, out_held; it
//                   writes the per-(node, port) `mov` record of the granted
//                   flit and the tile's integer partial sums.
//   simstep_finish  the receive-side pushes of the moved flits and the
//                   statistics, one thread per (lane, node).
//
// Replaces the TPU kernels repro/kernels/simstep/kernel.py:
// make_simstep_pallas (the whole cycle as one single-program kernel) and
// make_simstep_blocked (tile_fn gridded over node tiles, finish_fn outside)
// where the chunk kernel does not fit.  The whole-array kernel is this
// pair with tile_nodes = N; the blocked one is the pair with tile_nodes a
// proper divisor of N.  The draws of each cycle (u, ud) come from the
// host key chain (ref.draw_chunk), made for a whole chunk before its
// first launch.
//
// What bounds it on an H100: latency, not operations.  Every access is a
// dependent gather, so a cycle costs a few launches' worth of latency
// plus, at large N, the statistics' reorder scan (a popcount over each
// node's N reorder words, every measured cycle), the one O(N^2) term:
// at 64x64 and 4 lanes it reads 268 MB a cycle.
//
// What this simple design does about it: one thread per (lane, node)
// carries the node's whole router in registers and local memory, so a
// cycle is two launches with no atomics on the state and no
// synchronisation beyond the kernel boundary.  Blocks of a launch run
// concurrently and a tile pops its own FIFOs while other tiles read
// their credits, so the launch function first copies fifo_size into the
// fs_pre snapshot and every credit check reads only the snapshot (the
// TPU grid ran tiles in order and took fs_pre as a separate operand).
// Receive pushes target distinct inputs within a cycle (one winner per
// channel) and take their slot from the post-pop start and size, so they
// need no atomics; per-lane integer sums use integer atomics, exact in
// any order and wrapping at 2^32 as XLA's int32 sums do.
//
// Float steps round exactly as the reference's: generation compares
// u < p_gen * (rate / packet_len) with the division first, and the
// channel gate is floor((cyc + 1) * bw) - floor(cyc * bw) >= 1, each step
// rounded on its own (__fadd_rn/__fmul_rn; the build also passes
// --fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 10;
constexpr int F_SRC = 0, F_DST = 1, F_INTER = 2, F_SEQ = 3, F_TIME = 4,
              F_HOPS = 5, F_ORDER = 6, F_HEAD = 7, F_TAIL = 8, F_PHASE = 9;
constexpr int NQ = 5;
constexpr int Q_DST = 0, Q_INTER = 1, Q_ORDER = 2, Q_TIME = 3, Q_SEQ = 4;
constexpr int MOV_W = NF + 4;
constexpr int N_PART = 5;
constexpr int PART_GEN = 0, PART_PUSH = 1, PART_SHED = 2, PART_INJ = 3;
constexpr int MAX_PV = 32;
constexpr int MAX_P = 16;
constexpr int ALGO_BIDOR = 6;
constexpr int BIG = 1 << 30;
constexpr int FINISH_THREADS = 128;

}  // namespace

// Field order must match repro_torch/kernels/simstep/kernel.py.
struct PairArgs {
  // tables
  const int* port;        // (O, N, N)
  const int* choice;      // (N, N)
  const int* neighbor;    // (N, P)
  const int* recv_port;   // (N, P)
  const float* cdf;       // (N, N)
  const float* p_gen;     // (N,)
  const int* chan_of;     // (N, P), C where no channel
  const float* chan_bw;   // (C,)
  // this cycle's draws
  const float* u;         // (L, N)
  const float* ud;        // (L, N)
  // lane-batched state
  int* flits;             // (L, NIN, B, NF)
  int* fifo_start;        // (L, NIN)
  int* fifo_size;         // (L, NIN)
  int* fs_pre;            // (L, NIN) pre-cycle snapshot of fifo_size
  int* lock_op;           // (L, NIN)
  int* lock_ov;           // (L, NIN)
  int* out_held;          // (L, N, P, V)
  int* rr;                // (L, N, P)
  int* qpkts;             // (L, N, Q, NQ)
  int* q_start;           // (L, N)
  int* q_size;            // (L, N)
  int* prog;              // (L, N)
  int* next_seq;          // (L, N, N)
  const float* rate;      // (L,)
  const int* cycle0;      // (L,)
  const int* inject_until;   // (L,)
  const int* measure_until;  // (L,)
  int* mov;               // (L, N, P, MOV_W)
  int* parts;             // (L, ntiles, N_PART)
  int* exp_seq;           // (L, N, N)
  int* rbits;             // (L, N, N) uint32 bit patterns
  int* node_fwd;          // (L, N)
  int* eject_flits;       // (L, N)
  int* chan_fwd;          // (L, C)
  int* chan_seen;         // (L, C)
  int* lat_sum;           // (L,)
  int* lat_cnt;           // (L,)
  int* lat_max;           // (L,)
  int* lat_hist;          // (L, lat_bins)
  int* reorder_max;       // (L,)
  int* injected;          // (L,)
  int* offered;           // (L,)
  int* dropped;           // (L,)
  int* eject_total;       // (L,)
  int* meas_cnt;          // (L,)
  // sizes
  int L, N, P, V, NIN, C, O, B, Q, PKT, p_local, algo;
  int tile_nodes, ntiles, cycle, warmup, lat_bins, lat_bin_width;
};

namespace {

__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void __launch_bounds__(1024)
simstep_tile_kernel(const PairArgs a) {
  __shared__ int sparts[N_PART];
  for (int i = threadIdx.x; i < N_PART; i += blockDim.x) sparts[i] = 0;
  __syncthreads();

  const int lane = blockIdx.y;
  const int tile = blockIdx.x;
  const int n = tile * a.tile_nodes + threadIdx.x;
  if ((int)threadIdx.x < a.tile_nodes && n < a.N) {
    const int N = a.N, P = a.P, V = a.V, PV = P * V, NIN = a.NIN;
    const int B = a.B, Q = a.Q, C = a.C;
    const bool bidor = a.algo == ALGO_BIDOR;
    const long long ln = (long long)lane * N + n;      // (lane, node) row
    const long long lin = (long long)lane * NIN;       // lane's input base
    const int cyc = a.cycle0[lane] + a.cycle;

    // ---------------- 1. packet generation (open loop) ---------------- //
    const float u = a.u[ln];
    const float ud = a.ud[ln];
    const float per_flit = __fdiv_rn(a.rate[lane], (float)a.PKT);
    const bool gen = (u < __fmul_rn(a.p_gen[n], per_flit)) &&
                     (cyc < a.inject_until[lane]);
    // upper-bound binary search: the count of CDF entries <= ud (the row
    // is non-decreasing, so this equals the reference's dense count)
    const float* row = a.cdf + (long long)n * N;
    int lo = 0, hi = N;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] <= ud) lo = mid + 1; else hi = mid;
    }
    const int dst = clampi(lo, 0, N - 1);
    const int order = bidor ? a.choice[(long long)n * N + dst] : 0;
    int qs = a.q_size[ln];
    const int qst = a.q_start[ln];
    const bool space = qs < Q;
    const bool push = gen && space;
    int* nseq = a.next_seq + ln * N;
    const int seq = nseq[dst];
    int* qrow = a.qpkts + ln * (long long)Q * NQ;
    if (push) {
      nseq[dst] = seq + 1;
      int* r = qrow + pmod(qst + qs, Q) * NQ;
      r[Q_DST] = dst; r[Q_INTER] = -1; r[Q_ORDER] = order;
      r[Q_TIME] = cyc; r[Q_SEQ] = seq;
      qs += 1;
    }

    // ---------------- 2. flit injection (1/cycle/node) ---------------- //
    const int* h = qrow + qst * NQ;
    const int h_dst = h[Q_DST], h_inter = h[Q_INTER], h_order = h[Q_ORDER];
    const int pr = a.prog[ln];
    const bool phase0 = (h_inter < 0) || (h_inter == n);
    const int vc_in = bidor ? pmod(h_order, V) : pmod(n + h_dst, V);
    const int lf = (n * P + a.p_local) * V + vc_in;
    const int lf_size = a.fifo_size[lin + lf];
    const bool can = (qs > 0) && (lf_size < B);
    if (can) {
      int* r = a.flits +
               ((lin + lf) * B + pmod(a.fifo_start[lin + lf] + lf_size, B)) *
                   NF;
      r[F_SRC] = n; r[F_DST] = h_dst; r[F_INTER] = h_inter;
      r[F_SEQ] = h[Q_SEQ]; r[F_TIME] = h[Q_TIME]; r[F_HOPS] = 0;
      r[F_ORDER] = h_order; r[F_HEAD] = pr == 0; r[F_TAIL] = pr == a.PKT - 1;
      r[F_PHASE] = phase0;
      a.fifo_size[lin + lf] = lf_size + 1;
    }
    int pr2 = can ? pr + 1 : pr;
    const bool done = can && pr2 >= a.PKT;
    if (done) pr2 = 0;
    a.prog[ln] = pr2;
    a.q_start[ln] = done ? (qst + 1) % Q : qst;
    a.q_size[ln] = qs - (done ? 1 : 0);

    // ---------------- 3-4. routing and eligibility per input ---------- //
    int op_[MAX_PV], ov_[MAX_PV], st_[MAX_PV];
    bool elig_[MAX_PV], rph_[MAX_PV];
    const float cf = (float)cyc;
    const float cf1 = __fadd_rn(cf, 1.0f);
    for (int k = 0; k < PV; ++k) {
      const long long gi = lin + (long long)n * PV + k;
      const int st = a.fifo_start[gi];
      st_[k] = st;
      const int* g = a.flits + (gi * B + st) * NF;
      const bool valid = a.fifo_size[gi] > 0;
      const bool rph = g[F_PHASE] != 0 || g[F_INTER] < 0 || g[F_INTER] == n;
      const int target = clampi(rph ? g[F_DST] : g[F_INTER], 0, N - 1);
      const bool at_dest = target == n;
      const int lop = a.lock_op[gi];
      const bool locked = lop >= 0;
      const int eff = bidor ? clampi(g[F_ORDER], 0, a.O - 1) : 0;
      int op = a.port[((long long)eff * N + n) * N + target];
      int ov = bidor ? pmod(g[F_ORDER], V) : k % V;
      if (at_dest) { op = a.p_local; ov = 0; }
      if (locked) { op = lop; ov = a.lock_ov[gi]; }
      const bool is_eject = op == a.p_local;
      const int cop = clampi(op, 0, P - 1);
      const int nei = a.neighbor[n * P + cop];
      const int rp = a.recv_port[n * P + cop];
      const int ridx = clampi((nei * P + rp) * V + ov, 0, NIN - 1);
      const bool credit = is_eject || a.fs_pre[lin + ridx] < B;
      const bool vc_free =
          a.out_held[(ln * P + cop) * V + clampi(ov, 0, V - 1)] == -1;
      const bool needs_alloc = g[F_HEAD] != 0 && !locked && !is_eject;
      const int ch = a.chan_of[n * P + cop];
      bool live = false;
      if (ch >= 0 && ch < C) {
        const float bw = a.chan_bw[ch];
        live = __fsub_rn(floorf(__fmul_rn(cf1, bw)),
                         floorf(__fmul_rn(cf, bw))) >= 1.0f;
      }
      elig_[k] = valid && credit && (is_eject || live) &&
                 (vc_free || !needs_alloc);
      op_[k] = op;
      ov_[k] = ov;
      rph_[k] = rph;
    }

    // ---------------- 5. switch allocation (round-robin) -------------- //
    int grants[MAX_P];
    for (int po = 0; po < P; ++po) {
      const int r = a.rr[ln * P + po];
      int best = BIG, win = 0;
      for (int k = 0; k < PV; ++k) {
        if (elig_[k] && op_[k] == po) {
          const int s = pmod(k - r, PV);
          if (s < best) { best = s; win = k; }
        }
      }
      const bool ok = best < BIG;
      grants[po] = ok ? win : -1;
      if (ok) a.rr[ln * P + po] = (win + 1) % PV;
    }

    // ---------------- 6. pops, locks, out_held, mov ------------------- //
    for (int k = 0; k < PV; ++k) {
      const long long gi = lin + (long long)n * PV + k;
      const bool popped = elig_[k] && grants[clampi(op_[k], 0, P - 1)] == k;
      if (!popped) continue;
      const int* g = a.flits + (gi * B + st_[k]) * NF;
      const bool head = g[F_HEAD] != 0, tail = g[F_TAIL] != 0;
      a.fifo_start[gi] = (st_[k] + 1) % B;
      a.fifo_size[gi] -= 1;
      if (head && !tail) { a.lock_op[gi] = op_[k]; a.lock_ov[gi] = ov_[k]; }
      else if (tail) { a.lock_op[gi] = -1; a.lock_ov[gi] = -1; }
    }
    for (int po = 0; po < P; ++po) {
      int* m = a.mov + (ln * P + po) * MOV_W;
      const int w = grants[po];
      if (w < 0) {
        for (int f = 0; f < MOV_W; ++f) m[f] = 0;
        continue;
      }
      const long long gi = lin + (long long)n * PV + w;
      const int* g = a.flits + (gi * B + st_[w]) * NF;
      for (int f = 0; f < NF; ++f) m[f] = g[f];
      m[NF] = op_[w];
      m[NF + 1] = ov_[w];
      m[NF + 2] = rph_[w];
      m[NF + 3] = 1;
      const bool net = op_[w] != a.p_local;
      const bool w_head = g[F_HEAD] != 0, w_tail = g[F_TAIL] != 0;
      const int wov = ov_[w];
      if (net && (w_tail || w_head) && wov >= 0 && wov < V)
        a.out_held[(ln * P + po) * V + wov] = (w_head && !w_tail) ? w : -1;
    }

    atomicAdd(&sparts[PART_GEN], gen ? 1 : 0);
    atomicAdd(&sparts[PART_PUSH], push ? 1 : 0);
    atomicAdd(&sparts[PART_SHED], (gen && !space) ? 1 : 0);
    atomicAdd(&sparts[PART_INJ], can ? 1 : 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N_PART; i += blockDim.x)
    a.parts[((long long)lane * a.ntiles + tile) * N_PART + i] = sparts[i];
}

__global__ void simstep_finish_kernel(const PairArgs a) {
  const int lane = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const int N = a.N, P = a.P, V = a.V, NIN = a.NIN, B = a.B, C = a.C;
  const long long ln = (long long)lane * N + n;
  const long long lin = (long long)lane * NIN;
  const int cyc = a.cycle0[lane] + a.cycle;
  const bool measuring = cyc >= a.warmup && cyc < a.measure_until[lane];

  if (n == 0) {
    int gen = 0, shed = 0, inj = 0;
    for (int t = 0; t < a.ntiles; ++t) {
      const int* pt = a.parts + ((long long)lane * a.ntiles + t) * N_PART;
      gen += pt[PART_GEN]; shed += pt[PART_SHED]; inj += pt[PART_INJ];
    }
    a.meas_cnt[lane] += measuring ? 1 : 0;
    if (measuring) { a.offered[lane] += gen; a.dropped[lane] += shed; }
    a.injected[lane] += inj;
    atomicMax(&a.lat_max[lane], 0);
    atomicMax(&a.reorder_max[lane], 0);
  }

  // ------------- 6b. receive-side pushes, 7. channel stats ----------- //
  int granted_n = 0;
  for (int po = 0; po < P; ++po) {
    const int* m = a.mov + (ln * P + po) * MOV_W;
    const bool granted = m[NF + 3] != 0;
    granted_n += granted ? 1 : 0;
    const bool net = granted && m[NF] != a.p_local;
    if (net) {
      const int cop = clampi(m[NF], 0, P - 1);
      const int di = (a.neighbor[n * P + cop] * P + a.recv_port[n * P + cop]) *
                         V + m[NF + 1];
      if (di >= 0 && di < NIN) {
        const long long gdi = lin + di;
        const int size = a.fifo_size[gdi];
        int* r = a.flits + (gdi * B + (a.fifo_start[gdi] + size) % B) * NF;
        for (int f = 0; f < NF; ++f) r[f] = m[f];
        r[F_HOPS] = m[F_HOPS] + 1;
        r[F_PHASE] = m[NF + 2];
        a.fifo_size[gdi] = size + 1;
      }
    }
    const int ch = a.chan_of[n * P + po];
    if (ch >= 0 && ch < C) {
      a.chan_seen[(long long)lane * C + ch] += net ? 1 : 0;
      if (measuring) a.chan_fwd[(long long)lane * C + ch] += net ? 1 : 0;
    }
  }
  if (measuring) a.node_fwd[ln] += granted_n;

  // ---------------- 7. eject statistics (local port) ------------------ //
  const int* wl = a.mov + (ln * P + a.p_local) * MOV_W;
  const bool ej = wl[NF + 3] != 0;
  if (ej) {
    atomicAdd(&a.eject_total[lane], 1);
    if (measuring) a.eject_flits[ln] += 1;
  }
  const bool tail_ej = ej && wl[F_TAIL] != 0;
  const int lat = (cyc - wl[F_TIME]) + wl[F_HOPS] + 1;  // +1: eject hop
  if (tail_ej && wl[F_TIME] >= a.warmup) {
    atomicAdd(&a.lat_sum[lane], lat);
    atomicAdd(&a.lat_cnt[lane], 1);
    atomicMax(&a.lat_max[lane], lat);
    const int hbin = min(floordiv(lat, a.lat_bin_width), a.lat_bins - 1);
    if (hbin >= 0) atomicAdd(&a.lat_hist[(long long)lane * a.lat_bins + hbin],
                             1);
  }
  // reorder tracking: this node's row of the per-flow windows
  int* erow = a.exp_seq + ln * N;
  uint32_t* brow = reinterpret_cast<uint32_t*>(a.rbits + ln * N);
  const int src = wl[F_SRC];
  if (tail_ej && src >= 0 && src < N) {
    const int exp = erow[src];
    const uint32_t bits = brow[src];
    const int off = wl[F_SEQ] - exp;
    const bool in_win = off >= 0 && off < 32;
    const uint32_t bits2 =
        in_win ? (bits | (1u << clampi(off, 0, 31))) : bits;
    const uint32_t lowmask = bits2 & ~(bits2 + 1u);     // trailing ones
    const int run = __popc(lowmask);
    if (bits2 & 1u) {
      erow[src] = exp + run;
      brow[src] = run >= 32 ? 0u : (bits2 >> min(run, 31));
    } else {
      brow[src] = bits2;
    }
  }
  if (measuring) {
    int occ = 0;
    for (int j = 0; j < N; ++j) occ += __popc(brow[j]);
    atomicMax(&a.reorder_max[lane], occ * a.PKT);
  }
}

}  // namespace

// Snapshot fifo_size into fs_pre, then one block per (tile, lane) with
// tile_nodes threads.  Returns cudaGetLastError().
extern "C" int simstep_tile_launch(const PairArgs* args, void* stream) {
  const PairArgs a = *args;
  if (a.P * a.V > MAX_PV || a.P > MAX_P) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(a.fs_pre, a.fifo_size,
                                    sizeof(int) * (size_t)a.L * a.NIN,
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.ntiles, a.L);
  simstep_tile_kernel<<<grid, a.tile_nodes, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// One thread per (lane, node).  Returns cudaGetLastError().
extern "C" int simstep_finish_launch(const PairArgs* args, void* stream) {
  const PairArgs a = *args;
  dim3 grid((a.N + FINISH_THREADS - 1) / FINISH_THREADS, a.L);
  simstep_finish_kernel<<<grid, FINISH_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// sizeof(PairArgs), so the binding can check its record layout.
extern "C" int simstep_pair_args_size() { return (int)sizeof(PairArgs); }
