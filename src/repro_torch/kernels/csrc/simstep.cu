// simstep: the flit-level NoC simulator's per-cycle transition, a whole
// chunk of cycles per launch, for every lane of a campaign cell.
//
//   simstep_chunk   one launch advances every lane by `num_cycles` cycles:
//                   the PRNG key chain and the per-node draws, packet
//                   generation, source-queue push, flit injection,
//                   table-routed port selection, eligibility, round-robin
//                   switch allocation, pops, wormhole locks, out_held,
//                   the receive-side pushes and the statistics.  A lane
//                   is one block or one thread-block cluster.
//   simstep_grid    the same chunk for lanes no cluster holds (17x17,
//                   64x64, 96x96: ops.card_kernel decides by shape), as
//                   one cooperative launch over the whole card with the
//                   per-input state in global memory (see the note above
//                   simstep_grid_kernel).
//
// Both replace the TPU kernels repro/kernels/simstep/kernel.py:
// make_simstep_pallas (the whole cycle as one single-program kernel) and
// make_simstep_blocked (tile_fn gridded over node tiles, finish_fn
// outside).  The whole-array kernel is the chunk kernel with tile_nodes =
// N (one block a lane); the blocked one is tile_nodes a proper divisor of
// N (N / tile_nodes blocks a lane, one thread-block cluster, or tiles of
// every lane spread over the grid kernel's blocks).
//
// What bounds it on an H100: latency and instruction issue, not bytes.  A
// cycle moves a few KB per lane (byte bound 0.005 us a cycle at 5x5, 0.21
// at 32x32, 4 lanes), but every step is a short chain of dependent
// accesses (queue head, CDF row, port table, the receiver's credit), and
// each SM issues its warps' chains one instruction at a time.  Measured
// (NVIDIA H100 80GB HBM3, 700 W, PERF.md): ~4.5 us a cycle at 5x5 against
// a 0.04 us floor of the same launch with an empty body, ~11 us at 32x32
// against 1.5 us (the cluster barriers).  The design:
//
// * One launch per chunk.  Lanes are independent, so a lane is one block
//   or one thread-block cluster (up to 16 blocks; past 8 with the
//   non-portable size), and a cycle synchronises only inside it: two
//   barriers (__syncthreads, or the cluster barrier, whose release and
//   acquire order shared and global memory across the cluster).  Phase A
//   (generation, injection, routing, allocation, pops, ejections) runs
//   per node; phase B (the receive-side pushes and the popped inputs'
//   next head flits) after the first barrier; the second ends the cycle.
// * Parallel work within a router.  A node is a segment of P*V lanes of
//   a warp (three nodes a warp at P*V = 10), one lane per input: each
//   lane routes its own head flit, and the round-robin grant of each
//   out-port is one warp ballot plus a rotate-and-find-first-set, so the
//   switch allocation takes P ballots in place of a P x P*V scan.  The
//   destination search of a generated packet is a (P*V + 1)-ary search
//   over the node's CDF row by the segment's lanes.  Spreading a lane
//   over more blocks puts fewer warps on each SM and shortens the cycle
//   (ops.card_tile picks the layout).
// * Hot state on chip.  Each block keeps its nodes' per-input state
//   (FIFO start and size, locks, the credit snapshot, and the head flit
//   of every non-empty input), out_held, rr, the source-queue pointers
//   and the per-node counters in shared memory for the whole chunk and
//   writes them back at its end; a push into another block's input goes
//   through distributed shared memory.  A flit is read from global memory
//   once, when it becomes a head after a pop (or at the chunk's start);
//   an injected or pushed flit that lands in an empty FIFO is the head
//   at once.  Flit payloads, source queues and the N x N arrays stay in
//   global memory; flits are read and written at L2 (ld.cg / st.cg),
//   since another SM of the cluster reads what this one writes.  Per-lane
//   sums accumulate in registers and shared memory and are flushed once,
//   as int32 sums that wrap at 2^32 as the reference's do.
// * The credit snapshot without a copy.  Credits read fs_pre, the FIFO
//   sizes before the cycle.  Two buffers alternate by cycle parity: in
//   phase A each input's owner writes its post-pop size into the next
//   buffer, and a push in phase B adds its flit there, so the next
//   buffer holds the next cycle's snapshot when the cycle ends.
// * The key chain and the draws on the card.  The lane's per-cycle keys
//   come from split(key, 5) (five threefry2x32 blocks on five lanes of a
//   spare warp, one cycle ahead, handed over through shared memory at a
//   barrier the cycle has anyway; warp 0 takes them after its nodes when
//   the block has no spare warp), each block of a cluster deriving its
//   own copy.  Each node hashes its own u and ud as jax.random.uniform
//   lays them out (prng.py: node n < h = ceil(N/2) takes word 0 of block
//   n, the rest word 1 of block n - h; at odd N block h - 1 hashes
//   (h - 1, 0)).
// * Every routing algorithm of the reference (a.algo), each kernel
//   instantiated once for XY, YX, BiDOR and odd-even and once for the
//   three that draw from km, so the in-order ones run the code (and the
//   registers) they had before the others came: XY, YX and BiDOR route by
//   the dimension-order tables; O1TURN (a
//   random order), VALIANT and ROMM (two phases through an intermediate
//   node, random anywhere or in the minimal rectangle) take their draws
//   from the cycle's metadata key km, split once a cycle on the key warp
//   and hashed node by node, on segment lanes 2 and up, only where a
//   packet is generated; odd-even routes adaptively by the free slots of
//   its neighbours' receive FIFOs in the credit snapshot (one read a
//   lane, summed by shuffles).
// * The reorder occupancy in O(1).  A per-node count of set reorder bits
//   is filled once a chunk from the node's rbits row and updated on each
//   tail ejection by popc(new word) - popc(old word); an ejection
//   candidate fetches its flow's reorder words before the allocation.
// * The stall watchdog and the telemetry rings (noc/watchdog.py,
//   obs/probe.py) in one more instance of each kernel, FAM_INSTR, with
//   the algorithm a run-time switch, so the five instances above compile
//   as they did without them.  Stall ages and throttles live in global
//   memory, each read and written by its owner; a runaway flit's source
//   is throttled in phase B, after every owner's decrement of the cycle,
//   as the reference's finish_fn overrides its tile_fn.  Trips and the
//   rings are integer atomics in global memory (sums, so their order
//   changes no bit), and the network's source-queue total of a cycle,
//   which the occupancy ring bins, is summed by atomics into one of two
//   per-lane words by cycle parity and read in phase B.
//
// Float steps round exactly as the reference's: generation compares
// u < p_gen * (rate / packet_len) with the division first, and the
// channel gate is floor((cyc + 1) * bw) - floor(cyc * bw) >= 1, each step
// rounded on its own (__fadd_rn/__fmul_rn; the build also passes
// --fmad=false).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NF = 10;
constexpr int F_SRC = 0, F_DST = 1, F_INTER = 2, F_SEQ = 3, F_TIME = 4,
              F_HOPS = 5, F_ORDER = 6, F_HEAD = 7, F_TAIL = 8, F_PHASE = 9;
constexpr int NQ = 5;
constexpr int Q_DST = 0, Q_INTER = 1, Q_ORDER = 2, Q_TIME = 3, Q_SEQ = 4;
constexpr int MAX_PV = 32;
constexpr int MAX_P = 16;
constexpr int MAX_CLUSTER = 16;
constexpr int WARP = 32;
constexpr int MAX_WARPS = 32;
// repro_torch.noc.simconfig.Algo
constexpr int ALGO_XY = 0, ALGO_YX = 1, ALGO_O1TURN = 2, ALGO_VALIANT = 3,
              ALGO_ROMM = 4, ALGO_ODDEVEN = 5, ALGO_BIDOR = 6;
constexpr int MAX_NDIM = 4;
// The kernels' instances (template FAM): one for each of XY, YX, BiDOR
// and odd-even, whose algorithm is then a constant, and one for O1TURN,
// VALIANT and ROMM (a.algo at run time), the algorithms that draw from km.
constexpr int FAM_XY = 0, FAM_YX = 1, FAM_BIDOR = 2, FAM_DRAWN = 3,
              FAM_ODDEVEN = 4;
// ... and one with the watchdog and the telemetry, every algorithm at run
// time (a.algo).
constexpr int FAM_INSTR = 5;
constexpr unsigned FULL = 0xFFFFFFFFu;
// per-block sums in shared memory
constexpr int S_LAT_SUM = 0, S_LAT_CNT = 1, S_LAT_MAX = 2, S_RMAX = 3,
              S_INJ = 4, S_OFF = 5, S_DROP = 6, S_EJECT = 7, S_MEAS = 8;
constexpr int N_SUMS = 16;
// two cycles of (kg0, kg1, kd0, kd1, x0, x1, x2, x3), the chain: x is the
// algorithm's key from km (O1TURN k1, ROMM k3; VALIANT the two halves of
// split(k2)), see advance_key
constexpr int N_KEYS = 18;
constexpr int KEY_STRIDE = 8, KEY_CHAIN = 16;

}  // namespace

// Field order must match repro_torch/kernels/simstep/kernel.py.
struct SimArgs {
  // tables
  const int* port;        // (O, N, N)
  const int* choice;      // (N, N)
  const int* neighbor;    // (N, P)
  const int* recv_port;   // (N, P)
  const float* cdf;       // (N, N)
  const float* p_gen;     // (N,)
  const int* chan_of;     // (N, P), C where no channel
  const float* chan_bw;   // (C,)
  const int* coords;      // (N, NDIM)
  const int* strides;     // (NDIM,)
  // the PRNG key of each lane, uint32 words; advanced in place
  int* key;               // (L, 2)
  // lane-batched state
  int* flits;             // (L, NIN, B, NF)
  int* fifo_start;        // (L, NIN)
  int* fifo_size;         // (L, NIN)
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
  // the watchdog's escape table, read with the watchdog on
  const int* esc_port;    // (N, N)
  // the telemetry rings (S = tel_slots) and a scratch, with telemetry on
  int* tel_chan;          // (L, S, C)
  int* tel_counts;        // (L, S, 4)
  int* tel_cycles;        // (L, S)
  int* tel_lat;           // (L, S, lat_bins)
  int* tel_qocc;          // (L, S, tel_occ_bins)
  int* tel_qsum;          // (L, 2) a cycle's source-queue total, by parity
  // the watchdog, with the watchdog on
  int* wd_stall;          // (L, NIN)
  int* wd_throttle;       // (L, N)
  int* wd_trips;          // (L, 2)
  // sizes
  int L, N, P, V, NIN, C, O, B, Q, PKT, p_local, algo, NDIM;
  int tile_nodes, ntiles, num_cycles, warmup, lat_bins, lat_bin_width;
  // the watchdog (0 = off) and the telemetry (tel_epoch 0 = off)
  int watchdog, wd_stall_cycles, wd_hop_limit, wd_throttle_cycles;
  int tel_epoch, tel_slots, tel_occ_bins;
};

namespace {

// Shared-memory layout of one block (int32 words), for `tn` nodes.
struct Layout {
  int start, size, lop, lov, fs0, fs1, pop, pov, oh, rl, head;  // per input
  int rr, cseen, cfwd, mov;                            // per (node, port)
  int qstart, qsize, prog, occ, nfwd, ejf;             // per node
  int hist, sums, keys, words;
};

__host__ __device__ inline Layout layout(int tn, int P, int V, int bins) {
  const int ti = tn * P * V, po = tn * P, pm = po * NF, hm = ti * NF;
  Layout s;
  int w = 0;
  s.start = w; w += ti;
  s.size = w; w += ti;
  s.lop = w; w += ti;
  s.lov = w; w += ti;
  s.fs0 = w; w += ti;
  s.fs1 = w; w += ti;
  s.pop = w; w += ti;
  s.pov = w; w += ti;
  s.oh = w; w += ti;
  s.rl = w; w += ti;
  s.head = w; w += hm;        // the head flit of each non-empty input
  s.rr = w; w += po;
  s.cseen = w; w += po;
  s.cfwd = w; w += po;
  s.mov = w; w += pm;         // the flit a granted port pushes
  s.qstart = w; w += tn;
  s.qsize = w; w += tn;
  s.prog = w; w += tn;
  s.occ = w; w += tn;
  s.nfwd = w; w += tn;
  s.ejf = w; w += tn;
  s.hist = w; w += bins;
  s.sums = w; w += N_SUMS;
  s.keys = w; w += N_KEYS;
  s.words = w;
  return s;
}

// Warps that carry nodes: enough segments of P*V lanes for the tile's
// nodes, at most 32 (the rest run in rounds).  A block adds one spare warp
// for the key chain when it has room.
__host__ __device__ inline int node_warps(int tn, int pv) {
  const int per_warp = WARP / pv;
  const int w = (tn + per_warp - 1) / per_warp;
  return w < MAX_WARPS ? w : MAX_WARPS;
}

__host__ __device__ inline int block_threads(int tn, int pv) {
  const int w = node_warps(tn, pv);
  return WARP * (w < MAX_WARPS ? w + 1 : w);
}

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

// threefry2x32, 20 rounds, as JAX lowers it (repro_torch/prng.py).
#define TF_MIX(r)                          \
  x0 += x1;                                \
  x1 = __funnelshift_l(x1, x1, (r));       \
  x1 ^= x0;

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  x0 += k1; x1 += k2 + 1u;
  TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
  x0 += k2; x1 += k0 + 2u;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  x0 += k0; x1 += k1 + 3u;
  TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
  x0 += k1; x1 += k2 + 4u;
  TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
  x0 += k2; x1 += k0 + 5u;
}
#undef TF_MIX

// jax.random.bits(k, (M,))[e] (prng.bits_at): entry e < h = ceil(M/2)
// takes word 0 of count block e, entry e >= h word 1 of block e - h; the
// counts of block b are (b, b + h), except (h - 1, 0) at odd M, where the
// iota is padded with one zero.
__device__ __forceinline__ uint32_t node_bits(uint32_t k0, uint32_t k1,
                                              int e, int M) {
  const int h = (M + 1) >> 1;
  const int b = e < h ? e : e - h;
  uint32_t x0 = (uint32_t)b;
  uint32_t x1 = ((M & 1) && b == h - 1) ? 0u : (uint32_t)(b + h);
  threefry(k0, k1, x0, x1);
  return e < h ? x0 : x1;
}

// float32 in [0, 1) from 32 random bits (jax.random.uniform).
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// jax.random.uniform(k, (N,))[n] (prng.uniform).
__device__ __forceinline__ float node_uniform(uint32_t k0, uint32_t k1,
                                              int n, int N) {
  return unit_float(node_bits(k0, k1, n, N));
}

__host__ __device__ inline int algo_family(int algo) {
  return algo == ALGO_XY ? FAM_XY
         : algo == ALGO_YX ? FAM_YX
         : algo == ALGO_BIDOR ? FAM_BIDOR
         : algo == ALGO_ODDEVEN ? FAM_ODDEVEN
         : FAM_DRAWN;
}

// The algorithm an instance routes: a constant but in the drawn family and
// the instrumented instance.
template <int FAM>
__device__ __forceinline__ int routed_algo(const SimArgs& a) {
  return FAM == FAM_XY ? ALGO_XY
         : FAM == FAM_YX ? ALGO_YX
         : FAM == FAM_BIDOR ? ALGO_BIDOR
         : FAM == FAM_ODDEVEN ? ALGO_ODDEVEN
         : a.algo;
}

// Whether an instance routes the way of algorithm ALGO, whose own instance
// is OWN: it is that instance, or the instrumented one running ALGO.
template <int FAM, int OWN, int ALGO>
__device__ __forceinline__ bool routes_as(const SimArgs& a) {
  return FAM == OWN || (FAM == FAM_INSTR && a.algo == ALGO);
}

__host__ __device__ inline bool draws_km(int algo) {
  return algo == ALGO_O1TURN || algo == ALGO_VALIANT || algo == ALGO_ROMM;
}

// Whether a launch takes the instrumented instance.
__host__ __device__ inline bool instrumented(const SimArgs& a) {
  return a.watchdog != 0 || a.tel_epoch > 0;
}

// Call f(std::integral_constant<int, FAM>) for the instance that routes
// `algo`.
template <typename F>
int by_family(int algo, F f) {
  switch (algo_family(algo)) {
    case FAM_YX: return f(std::integral_constant<int, FAM_YX>{});
    case FAM_BIDOR: return f(std::integral_constant<int, FAM_BIDOR>{});
    case FAM_DRAWN: return f(std::integral_constant<int, FAM_DRAWN>{});
    case FAM_ODDEVEN: return f(std::integral_constant<int, FAM_ODDEVEN>{});
    default: return f(std::integral_constant<int, FAM_XY>{});
  }
}

// ... and for the instrumented instance where `instr` is set.
template <typename F>
int by_instance(int algo, bool instr, F f) {
  if (instr) return f(std::integral_constant<int, FAM_INSTR>{});
  return by_family(algo, f);
}

// The lanes of a router's segment, besides lanes 0 and 1 (u and ud), that
// hash a generated packet's draws (kernel.draw_lanes).
__host__ __device__ inline int algo_draw_lanes(int algo, int ndim) {
  return algo == ALGO_O1TURN ? 1
         : algo == ALGO_VALIANT ? 2
         : algo == ALGO_ROMM ? ndim : 0;
}

// One cycle of the key chain on lanes 0-4 of a warp (all 32 lanes call
// it): split(key, 5) hashes blocks j = 0..4 with counts (j, 5 + j) into
// (a_j, b_j); key' = (a0, a1), kg = (a2, a3), kd = (a4, b0), km = (b1, b2).
// O1TURN, VALIANT and ROMM then split km in three, blocks j = 0..2 with
// counts (j, 3 + j) into (c_j, d_j): k1 = (c0, c1), k2 = (c2, d0),
// k3 = (d1, d2); VALIANT splits k2 in two, blocks j = 0, 1 with counts
// (j, 2 + j) into (e_j, f_j): its high and low words' keys (e0, e1) and
// (f0, f1).  Writes (kg, kd, x) to `out` (x: k1, k3, or the two VALIANT
// keys) and key' to `chain`.
template <int FAM>
__device__ __forceinline__ void advance_key(int* chain, int* out, int algo) {
  const int lane = threadIdx.x & (WARP - 1);
  const uint32_t k0 = (uint32_t)chain[0], k1 = (uint32_t)chain[1];
  uint32_t a = (uint32_t)lane, b = (uint32_t)(lane + 5);
  if (lane < 5) threefry(k0, k1, a, b);
  const uint32_t a0 = __shfl_sync(FULL, a, 0), b0 = __shfl_sync(FULL, b, 0);
  const uint32_t a1 = __shfl_sync(FULL, a, 1), a2 = __shfl_sync(FULL, a, 2);
  const uint32_t a3 = __shfl_sync(FULL, a, 3), a4 = __shfl_sync(FULL, a, 4);
  uint32_t x[4] = {0u, 0u, 0u, 0u};
  if (FAM == FAM_DRAWN || (FAM == FAM_INSTR && draws_km(algo))) {
    const uint32_t m0 = __shfl_sync(FULL, b, 1), m1 = __shfl_sync(FULL, b, 2);
    uint32_t c = (uint32_t)lane, d = (uint32_t)(lane + 3);
    if (lane < 3) threefry(m0, m1, c, d);
    if (algo == ALGO_O1TURN) {
      x[0] = __shfl_sync(FULL, c, 0); x[1] = __shfl_sync(FULL, c, 1);
    } else if (algo == ALGO_ROMM) {
      x[0] = __shfl_sync(FULL, d, 1); x[1] = __shfl_sync(FULL, d, 2);
    } else {
      const uint32_t v0 = __shfl_sync(FULL, c, 2), v1 = __shfl_sync(FULL, d, 0);
      uint32_t e = (uint32_t)lane, f = (uint32_t)(lane + 2);
      if (lane < 2) threefry(v0, v1, e, f);
      x[0] = __shfl_sync(FULL, e, 0); x[1] = __shfl_sync(FULL, e, 1);
      x[2] = __shfl_sync(FULL, f, 0); x[3] = __shfl_sync(FULL, f, 1);
    }
  }
  __syncwarp();
  if (lane == 0) {
    out[0] = (int)a2; out[1] = (int)a3; out[2] = (int)a4; out[3] = (int)b0;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[4 + j] = (int)x[j];
    chain[0] = (int)a0; chain[1] = (int)a1;
  }
}

// A generated packet's (order, inter) under an algorithm that draws from
// km, as the reference's gen_metadata makes them.  Every lane of the warp
// calls it; `gen` and `dst` are uniform over a router's segment (lanes
// base .. base + PV - 1, this lane its k-th), and the draws are hashed
// only where a packet is generated, on segment lanes 2, 3, ...: O1TURN
// bernoulli(k1, 0.5) on lane 2; VALIANT randint(k2, 0, N)'s high and low
// words on lanes 2 and 3; ROMM uniform(k3, (N, NDIM))'s entries
// NDIM * n + d on lanes 2 + d, each lane its dimension's term of the
// intermediate node, summed over the segment.  `x` is the cycle's
// algorithm key words (advance_key).
__device__ __forceinline__ void drawn_meta(const SimArgs& a, int algo,
                                           const int* x, bool gen, int n,
                                           int dst, int k, int base,
                                           int& order, int& inter) {
  if (algo == ALGO_O1TURN) {
    uint32_t w = 0u;
    if (gen && k == 2) w = node_bits((uint32_t)x[0], (uint32_t)x[1], n, a.N);
    w = __shfl_sync(FULL, w, (base + 2) & (WARP - 1));
    order = unit_float(w) < 0.5f ? a.O - 1 : 0;
  } else if (algo == ALGO_VALIANT) {
    uint32_t w = 0u;
    if (gen && (k == 2 || k == 3))
      w = node_bits((uint32_t)x[k == 2 ? 0 : 2], (uint32_t)x[k == 2 ? 1 : 3],
                    n, a.N);
    const uint32_t hi = __shfl_sync(FULL, w, (base + 2) & (WARP - 1));
    const uint32_t lo = __shfl_sync(FULL, w, (base + 3) & (WARP - 1));
    // _randint with span N: ((hi % N) * (2^32 % N) + lo % N) % N, the
    // multiplier as (2^16 % N)^2 % N, all in uint32
    const uint32_t span = (uint32_t)a.N;
    uint32_t mult = 65536u % span;
    mult = (mult * mult) % span;
    inter = (int)(((hi % span) * mult + lo % span) % span);
  } else if (algo == ALGO_ROMM) {
    const int nd = a.NDIM, d = k - 2;
    int term = 0;
    if (gen && d >= 0 && d < nd) {
      const float ur = unit_float(node_bits((uint32_t)x[0], (uint32_t)x[1],
                                            n * nd + d, a.N * nd));
      const int cs = __ldg(a.coords + n * nd + d);
      const int cd = __ldg(a.coords + dst * nd + d);
      const int lo = min(cs, cd), hi = max(cs, cd);
      // a float32 product, truncated toward zero
      const int ic = clampi(lo + (int)__fmul_rn(ur, (float)(hi - lo + 1)),
                            lo, hi);
      term = ic * __ldg(a.strides + d);
    }
    inter = 0;
    for (int j = 0; j < nd; ++j)
      inter += __shfl_sync(FULL, term, (base + 2 + j) & (WARP - 1));
  }
}

// A generated packet's (order, inter), as the reference's gen_metadata
// makes them (BiDOR's order, a table read, is left to the caller); the
// algorithms that draw take them from drawn_meta.  Every lane of the warp
// calls it.
template <int FAM>
__device__ __forceinline__ void packet_meta(const SimArgs& a, const int* x,
                                            bool gen, int n, int dst, int k,
                                            int base, int& order,
                                            int& inter) {
  order = 0;
  inter = -1;
  const int algo = routed_algo<FAM>(a);
  if (FAM == FAM_INSTR) {
    if (algo == ALGO_YX) order = a.O - 1;
    else drawn_meta(a, algo, x, gen, n, dst, k, base, order, inter);
  } else if (FAM != FAM_DRAWN) {
    if (algo == ALGO_YX) order = a.O - 1;
  } else {
    drawn_meta(a, algo, x, gen, n, dst, k, base, order, inter);
  }
}

// Odd-even's route (Chiu's ROUTE, minimal adaptive; ports 0 = +x, 1 = -x,
// 2 = +y, 3 = -y) and its VC, as the reference's oddeven_route and VC
// choice make them.  Every lane of the warp calls it.  `fv` is this lane's
// (port k / V, VC k % V) receiver's free slots in the pre-cycle snapshot;
// `held` returns whether the node's (port, VC) output is held.  For a lane
// with `route` set returns the port (the one whose receive FIFOs hold more
// free slots where both the x and the y step are allowed, x on a tie) and
// the VC at it (the most free slots among the VCs not held, a held one
// scored -1, the first maximum).
template <typename Held>
__device__ __forceinline__ void oddeven(const SimArgs& a, bool route, int n,
                                        int src, int target, int fv, int base,
                                        Held held, int& op, int& ov) {
  const int V = a.V;
  int tot[4];
#pragma unroll
  for (int po = 0; po < 4; ++po) {
    tot[po] = 0;
    for (int v = 0; v < V; ++v)
      tot[po] += __shfl_sync(FULL, fv, (base + po * V + v) & (WARP - 1));
  }
  int port = 0;
  if (route) {
    const int cx = __ldg(a.coords + 2 * n), cy = __ldg(a.coords + 2 * n + 1);
    const int sx = __ldg(a.coords + 2 * src);
    const int tx = __ldg(a.coords + 2 * target);
    const int dx = tx - cx, dy = __ldg(a.coords + 2 * target + 1) - cy;
    const int y_port = dy > 0 ? 2 : 3, x_port = dx > 0 ? 0 : 1;
    const bool east_ok = dx > 0 && (dy == 0 || pmod(tx, 2) == 1 || dx != 1);
    const bool y_ok_east =
        dx > 0 && dy != 0 && (pmod(cx, 2) == 1 || cx == sx);
    const bool west_ok = dx < 0;
    const bool y_ok_west = dx < 0 && dy != 0 && pmod(cx, 2) == 0;
    const bool y_ok_straight = dx == 0 && dy != 0;
    const bool x_ok = east_ok || west_ok;
    const bool y_ok = y_ok_east || y_ok_west || y_ok_straight;
    const bool prefer_y =
        y_ok && (!x_ok || tot[y_port] > tot[x_port]);
    port = prefer_y ? y_port : x_port;
  }
  int best = 0, best_f = 0;
  for (int v = 0; v < V; ++v) {
    int f = __shfl_sync(FULL, fv, (base + port * V + v) & (WARP - 1));
    if (route && held(port, v)) f = -1;
    if (v == 0 || f > best_f) { best = v; best_f = f; }
  }
  op = port;
  ov = best;
}

// The VC a packet's flits enter at its source's local port, for every
// algorithm but odd-even: XY and YX spread flows by (n + dst) % V, O1TURN
// and BiDOR take order % V, VALIANT and ROMM the routing phase % V.
__device__ __forceinline__ int vc_in_of(int algo, int n, const int* h, int V) {
  if (algo == ALGO_XY || algo == ALGO_YX) return pmod(n + h[Q_DST], V);
  if (algo == ALGO_VALIANT || algo == ALGO_ROMM)
    return pmod((h[Q_INTER] < 0 || h[Q_INTER] == n) ? 1 : 0, V);
  return pmod(h[Q_ORDER], V);
}

// The dimension order of a table-routed head flit, returned, and its VC:
// XY and YX take order 0 and O - 1 and keep the input's VC (k % V);
// O1TURN and BiDOR the packet's order (clamped, as the reference's gather
// clamps it) and order % V; VALIANT and ROMM order 0 and their routing
// phase % V.
__device__ __forceinline__ int table_route(const SimArgs& a, int algo,
                                           int order, bool rph, int k,
                                           int& ov) {
  if (algo == ALGO_XY || algo == ALGO_YX) {
    ov = k % a.V;
    return algo == ALGO_XY ? 0 : a.O - 1;
  }
  if (algo == ALGO_VALIANT || algo == ALGO_ROMM) {
    ov = pmod(rph ? 1 : 0, a.V);
    return 0;
  }
  ov = pmod(order, a.V);
  return clampi(order, 0, a.O - 1);
}

// The receiver index behind (port, VC) of node n, as the reference indexes
// its pre-cycle sizes: a port without a neighbour (-1) gives a negative
// index, wrapped by NIN, then clamped.
__device__ __forceinline__ int recv_index(const SimArgs& a, int n, int k) {
  const int po = k / a.V, v = k - po * a.V;
  int idx = (__ldg(a.neighbor + n * a.P + po) * a.P +
             __ldg(a.recv_port + n * a.P + po)) * a.V + v;
  if (idx < 0) idx += a.NIN;
  return clampi(idx, 0, a.NIN - 1);
}

// ---- the watchdog and the telemetry (the instrumented instance) ---- //

// The generation throttle of node `ln` (lane * N + node): the segment's
// lane 0 reads it and writes it back decremented, and the segment takes
// the read (every lane of the warp calls it).  A node generates only while
// its throttle is 0.  Other blocks write throttles (phase B), so they are
// read and written at L2.
__device__ __forceinline__ bool unthrottled(const SimArgs& a, bool lead,
                                            long long ln, int base) {
  int thr = 0;
  if (lead) {
    thr = __ldcg(a.wd_throttle + ln);
    __stcg(a.wd_throttle + ln, max(thr - 1, 0));
  }
  return __shfl_sync(FULL, thr, base & (WARP - 1)) <= 0;
}

// Phase B: a flit moving on past the hop limit (`f` as its receiver holds
// it, the hop counted) throttles its source, over the owner's decrement.
__device__ __forceinline__ void throttle_runaway(const SimArgs& a,
                                                 const int* f, long long lnn) {
  const int src = f[F_SRC];
  if (f[F_HOPS] > a.wd_hop_limit && src >= 0 && src < a.N)
    __stcg(a.wd_throttle + lnn + src, a.wd_throttle_cycles);
}

// A generated packet in telemetry slot `row` (lane * S + slot): offered,
// then accepted or shed.
__device__ __forceinline__ void tel_generated(const SimArgs& a, long long row,
                                              bool space) {
  int* c = a.tel_counts + row * 4;
  atomicAdd(c, 1);
  atomicAdd(c + (space ? 1 : 2), 1);
}

// A tail ejection of latency `lat` in telemetry slot `row`.
__device__ __forceinline__ void tel_delivered(const SimArgs& a, long long row,
                                              int lat) {
  atomicAdd(a.tel_counts + row * 4 + 3, 1);
  atomicAdd(a.tel_lat + row * a.lat_bins +
                min(floordiv(lat, a.lat_bin_width), a.lat_bins - 1),
            1);
}

// Once a lane and cycle c, in phase B: the cycle into slot `row`, and the
// network's source-queue total (summed into the parity word in phase A)
// into its occupancy bin; the other parity word is cleared for cycle c + 1.
__device__ __forceinline__ void tel_cycle(const SimArgs& a, int lane,
                                          long long row, int c) {
  int* qs = a.tel_qsum + 2 * lane;
  const long long tot = atomicAdd(qs + (c & 1), 0);
  const int nb = a.tel_occ_bins;
  const long long ob = tot * nb / ((long long)a.N * a.Q);
  atomicAdd(a.tel_qocc + row * nb + (ob < nb - 1 ? ob : nb - 1), 1);
  atomicAdd(a.tel_cycles + row, 1);
  atomicExch(qs + ((c + 1) & 1), 0);
}

// The telemetry slot row (lane * S + (cyc / epoch) % S) of a cycle.
__device__ __forceinline__ long long tel_row(const SimArgs& a, int lane,
                                             int cyc) {
  return (long long)lane * a.tel_slots + (cyc / a.tel_epoch) % a.tel_slots;
}

template <bool CLUSTERED>
__device__ __forceinline__ void lane_sync() {
  if (CLUSTERED) cg::this_cluster().sync();
  else __syncthreads();
}

// Shared memory of block `rank` of this lane's cluster.
template <bool CLUSTERED>
__device__ __forceinline__ int* rank_ptr(int* p, int rank, int me) {
  if (!CLUSTERED || rank == me) return p;
  return cg::this_cluster().map_shared_rank(p, rank);
}

// MAXT bounds the block size, so a small block gets more registers.
template <bool CLUSTERED, bool EMPTY, int MAXT, int FAM>
__global__ void __launch_bounds__(MAXT, 1)
simstep_chunk_kernel(const SimArgs a) {
  extern __shared__ int sm[];
  const int N = a.N, P = a.P, V = a.V, PV = P * V, NIN = a.NIN;
  const int B = a.B, Q = a.Q, C = a.C;
  const int tn = a.tile_nodes;
  const int ti = tn * PV;
  const int lane = blockIdx.y;
  const int me = CLUSTERED ? (int)cg::this_cluster().block_rank() : 0;
  const int node0 = me * tn;
  const int in0 = node0 * PV;                          // first input owned
  const Layout lay = layout(tn, P, V, a.lat_bins);
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x / WARP, wl = threadIdx.x % WARP;
  const int nwarps = node_warps(tn, PV);               // warps with nodes
  const bool key_warp = warp == nwarps;                // the spare warp
  const int spw = WARP / PV;                           // nodes a warp
  const int g = wl / PV, k = wl - g * PV;              // segment, input
  const bool seg_lane = g < spw;
  const unsigned segmask = PV == 32 ? FULL : ((1u << PV) - 1u);
  const int rounds = (tn + nwarps * spw - 1) / (nwarps * spw);
  // constants in every instance but the instrumented one
  const bool oe = routes_as<FAM, FAM_ODDEVEN, ALGO_ODDEVEN>(a);
  const bool bd = routes_as<FAM, FAM_BIDOR, ALGO_BIDOR>(a);
  const bool WD = FAM == FAM_INSTR && a.watchdog != 0;
  const bool TEL = FAM == FAM_INSTR && a.tel_epoch > 0;

  if (EMPTY) {
    if (CLUSTERED) cg::this_cluster().sync();
    for (int c = 0; c < a.num_cycles; ++c) {
      lane_sync<CLUSTERED>();
      lane_sync<CLUSTERED>();
    }
    return;
  }

  int* s_start = sm + lay.start;
  int* s_size = sm + lay.size;
  int* s_lop = sm + lay.lop;
  int* s_lov = sm + lay.lov;
  int* s_pop = sm + lay.pop;
  int* s_pov = sm + lay.pov;
  int* s_oh = sm + lay.oh;
  int* s_rr = sm + lay.rr;
  int* s_cseen = sm + lay.cseen;
  int* s_cfwd = sm + lay.cfwd;
  int* s_mov = sm + lay.mov;
  int* s_rl = sm + lay.rl;
  int* s_head = sm + lay.head;
  int* s_qstart = sm + lay.qstart;
  int* s_qsize = sm + lay.qsize;
  int* s_prog = sm + lay.prog;
  int* s_occ = sm + lay.occ;
  int* s_nfwd = sm + lay.nfwd;
  int* s_ejf = sm + lay.ejf;
  int* s_hist = sm + lay.hist;
  int* s_sums = sm + lay.sums;
  int* s_keys = sm + lay.keys;

  const long long lin = (long long)lane * NIN;         // lane's input base
  const long long lnn = (long long)lane * N;           // lane's node base

  // ---------------- load the block's hot state ------------------------ //
  for (int i = threadIdx.x; i < ti; i += nthreads) {
    const long long gi = lin + in0 + i;
    const int size = a.fifo_size[gi];
    s_start[i] = a.fifo_start[gi];
    s_size[i] = size;
    sm[lay.fs0 + i] = size;
    s_lop[i] = a.lock_op[gi];
    s_lov[i] = a.lock_ov[gi];
    s_oh[i] = a.out_held[gi];                // (N, P, V) = NIN per lane
    if (size > 0) {
      const int* hf = a.flits + (gi * B + s_start[i]) * NF;
      for (int x = 0; x < NF; ++x) s_head[i * NF + x] = __ldcg(hf + x);
    }
  }
  for (int j = threadIdx.x; j < tn * P; j += nthreads) {
    s_rr[j] = a.rr[lnn * P + node0 * P + j];
    s_cseen[j] = 0;
    s_cfwd[j] = 0;
  }
  for (int t = threadIdx.x; t < tn; t += nthreads) {
    const long long ln = lnn + node0 + t;
    s_qstart[t] = a.q_start[ln];
    s_qsize[t] = a.q_size[ln];
    s_prog[t] = a.prog[ln];
    s_nfwd[t] = a.node_fwd[ln];
    s_ejf[t] = a.eject_flits[ln];
  }
  for (int j = threadIdx.x; j < a.lat_bins; j += nthreads) s_hist[j] = 0;
  for (int j = threadIdx.x; j < N_SUMS; j += nthreads) s_sums[j] = 0;
  // reorder occupancy: one warp a node pop-counts its rbits row
  for (int t = warp; t < tn; t += nthreads / WARP) {
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(a.rbits) + (lnn + node0 + t) * N;
    int occ = 0;
    for (int j = wl; j < N; j += WARP) occ += __popc(row[j]);
    occ = __reduce_add_sync(FULL, occ);
    if (wl == 0) s_occ[t] = occ;
  }
  int* chain = s_keys + KEY_CHAIN;
  if (TEL && me == 0 && threadIdx.x == 0) {   // the queue-total words
    __stcg(a.tel_qsum + 2 * lane, 0);
    __stcg(a.tel_qsum + 2 * lane + 1, 0);
  }
  if (warp == 0) {
    if (wl == 0) {
      chain[0] = a.key[2 * lane];
      chain[1] = a.key[2 * lane + 1];
    }
    __syncwarp();
    advance_key<FAM>(chain, s_keys, a.algo);  // cycle 0's keys
  }

  const int cyc0 = a.cycle0[lane];
  const int inj_until = a.inject_until[lane];
  const int meas_until = a.measure_until[lane];
  const float per_flit = __fdiv_rn(a.rate[lane], (float)a.PKT);
  // per-thread sums over the chunk (uint32: they wrap as int32 sums do)
  uint32_t r_inj = 0, r_off = 0, r_drop = 0, r_eject = 0, r_lat_sum = 0,
           r_lat_cnt = 0, r_meas = 0;
  int r_lat_max = 0, r_rmax = 0;

  if (CLUSTERED) cg::this_cluster().sync();   // every block's state loaded
  else __syncthreads();

  for (int c = 0; c < a.num_cycles; ++c) {
    const int cyc = cyc0 + c;
    const bool measuring = cyc >= a.warmup && cyc < meas_until;
    int* fs_cur = sm + ((c & 1) ? lay.fs1 : lay.fs0);
    int* fs_next = sm + ((c & 1) ? lay.fs0 : lay.fs1);
    const int* kk = s_keys + KEY_STRIDE * (c & 1);
    const uint32_t kg0 = (uint32_t)kk[0], kg1 = (uint32_t)kk[1];
    const uint32_t kd0 = (uint32_t)kk[2], kd1 = (uint32_t)kk[3];
    const float cf = (float)cyc;
    const float cf1 = __fadd_rn(cf, 1.0f);
    const long long trow = TEL ? tel_row(a, lane, cyc) : 0;

    // ====== phase A: per node, generation to pops and ejections ======== //
    if (key_warp) {
      // the next cycle's keys, visible after the barrier
      if (c + 1 < a.num_cycles)
        advance_key<FAM>(chain, s_keys + KEY_STRIDE * ((c + 1) & 1), a.algo);
    } else {
      for (int r = 0; r < rounds; ++r) {
        const int t = (r * nwarps + warp) * spw + g;   // node in the tile
        const bool act = seg_lane && t < tn;
        const int n = node0 + t;
        const long long ln = lnn + n;
        const int base = g * PV;                        // segment's lane 0
        const int i = t * PV + k;                       // tile-local input

        // ---- 0. what needs no draw: the queue head ------------------ //
        int st = 0, size = 0;
        if (act) {
          st = s_start[i];
          size = s_size[i];
        }
        int qs = 0, qst = 0;
        int h[NQ];
#pragma unroll
        for (int x = 0; x < NQ; ++x) h[x] = 0;
        int* qrow = a.qpkts + ln * (long long)Q * NQ;
        if (act && k == 0) {
          qs = s_qsize[t];
          qst = s_qstart[t];
          if (qs > 0) {
#pragma unroll
            for (int x = 0; x < NQ; ++x) h[x] = qrow[qst * NQ + x];
          }
        }

        // ---- 1. packet generation: the draws, then the CDF search -- //
        // lane 0 of the segment hashes u, lane 1 ud, on one path
        float draw = 0.0f;
        if (act && k < 2)
          draw = node_uniform(k ? kd0 : kg0, k ? kd1 : kg1, n, N);
        const float u = __shfl_sync(FULL, draw, base & (WARP - 1));
        const float ud = __shfl_sync(FULL, draw, (base + 1) & (WARP - 1));
        bool gen = act && (u < __fmul_rn(__ldg(a.p_gen + n), per_flit)) &&
                   (cyc < inj_until);
        if (WD) gen = unthrottled(a, act && k == 0, ln, base) && gen;
        // the count of CDF entries <= ud (the row is non-decreasing): a
        // (PV + 1)-ary search, one probe a lane of the segment
        int lo = 0, hi = N;
        const float* row = a.cdf + (long long)n * N;
        while (__any_sync(FULL, gen && lo < hi)) {
          const bool probe = gen && lo < hi;
          const int width = hi - lo;
          bool le = false;
          if (probe)
            le = __ldg(row + lo + ((k + 1) * width) / (PV + 1)) <= ud;
          const unsigned m = __ballot_sync(FULL, le);
          if (probe) {
            const int cnt = __popc((m >> base) & segmask);
            const int nlo = cnt > 0 ? lo + (cnt * width) / (PV + 1) + 1 : lo;
            const int nhi =
                cnt < PV ? lo + ((cnt + 1) * width) / (PV + 1) : hi;
            lo = nlo;
            hi = nhi;
          }
        }
        const int dst = clampi(lo, 0, N - 1);
        int order, inter;
        packet_meta<FAM>(a, kk + 4, gen, n, dst, k, base, order, inter);
        // ---- 1b. source-queue push, 2. flit injection (segment lane 0) //
        int inj_k = -1;                   // the segment lane injected into
        if (act && k == 0) {
          int pr = s_prog[t];
          const bool space = qs < Q;
          if (gen && space) {
            if (bd) order = __ldg(a.choice + (long long)n * N + dst);
            int* nseq = a.next_seq + ln * N + dst;
            const int seq = *nseq;
            *nseq = seq + 1;
            int* rec = qrow + pmod(qst + qs, Q) * NQ;
            rec[Q_DST] = dst; rec[Q_INTER] = inter; rec[Q_ORDER] = order;
            rec[Q_TIME] = cyc; rec[Q_SEQ] = seq;
            if (qs == 0) {                // the new packet is the head
              h[Q_DST] = dst; h[Q_INTER] = inter; h[Q_ORDER] = order;
              h[Q_TIME] = cyc; h[Q_SEQ] = seq;
            }
            qs += 1;
          }
          if (measuring) {
            r_off += gen ? 1u : 0u;
            r_drop += (gen && !space) ? 1u : 0u;
          }
          if (TEL && gen) tel_generated(a, trow, space);
          bool done = false;
          if (qs > 0) {
            int vc_in = 0;
            if (oe) {                       // the local VC with most space
              const int* ls = s_size + t * PV + a.p_local * V;
              for (int j = 1; j < V; ++j)
                if (ls[j] < ls[vc_in]) vc_in = j;
            } else {
              vc_in = vc_in_of(routed_algo<FAM>(a), n, h, V);
            }
            const int lk = a.p_local * V + vc_in;       // segment lane
            const int lf = t * PV + lk;                 // tile-local
            const int lf_size = s_size[lf];             // before the pops
            if (lf_size < B) {
              int jf[NF];
              jf[F_SRC] = n; jf[F_DST] = h[Q_DST]; jf[F_INTER] = h[Q_INTER];
              jf[F_SEQ] = h[Q_SEQ]; jf[F_TIME] = h[Q_TIME]; jf[F_HOPS] = 0;
              jf[F_ORDER] = h[Q_ORDER]; jf[F_HEAD] = pr == 0 ? 1 : 0;
              jf[F_TAIL] = pr == a.PKT - 1 ? 1 : 0;
              jf[F_PHASE] = (h[Q_INTER] < 0 || h[Q_INTER] == n) ? 1 : 0;
              int* rec = a.flits + ((lin + in0 + lf) * B +
                                    pmod(s_start[lf] + lf_size, B)) * NF;
#pragma unroll
              for (int x = 0; x < NF; ++x) __stcg(rec + x, jf[x]);
              if (lf_size == 0) {         // the new flit is the head
#pragma unroll
                for (int x = 0; x < NF; ++x) s_head[lf * NF + x] = jf[x];
              }
              inj_k = lk;
              pr += 1;
              done = pr >= a.PKT;
              if (done) pr = 0;
              r_inj += 1u;
            }
          }
          s_prog[t] = pr;
          s_qstart[t] = done ? (qst + 1) % Q : qst;
          s_qsize[t] = qs - (done ? 1 : 0);
          if (TEL && qs - (done ? 1 : 0) > 0)
            atomicAdd(a.tel_qsum + 2 * lane + (c & 1), qs - (done ? 1 : 0));
        }
        inj_k = __shfl_sync(FULL, inj_k, base & (WARP - 1));
        __syncwarp();
        if (act && k == inj_k) size += 1;
        int f[NF];                        // the head flit, from shared memory
#pragma unroll
        for (int x = 0; x < NF; ++x)
          f[x] = (act && size > 0) ? s_head[i * NF + x] : 0;

        // ---- 3-4. routing and eligibility, one lane per input ------ //
        bool elig = false;
        int op = -1, ov = 0;
        const bool head = f[F_HEAD] != 0, tail = f[F_TAIL] != 0;
        const bool rph = f[F_PHASE] != 0 || f[F_INTER] < 0 || f[F_INTER] == n;
        const int target = clampi(rph ? f[F_DST] : f[F_INTER], 0, N - 1);
        int* erow = a.exp_seq + ln * N;
        uint32_t* brow = reinterpret_cast<uint32_t*>(a.rbits + ln * N);
        int pre_exp = 0;
        uint32_t pre_bits = 0;
        int oe_op = 0, oe_ov = 0;
        if (oe) {
          int fv = 0;                      // this lane's receiver's credits
          if (act) {
            const int ridx = recv_index(a, n, k), rank = ridx / ti;
            fv = B - rank_ptr<CLUSTERED>(fs_cur, rank, me)[ridx - rank * ti];
          }
          oddeven(a, act && size > 0, n, clampi(f[F_SRC], 0, N - 1), target,
                  fv, base,
                  [&](int po, int v) {
                    return s_oh[(t * P + po) * V + v] >= 0;
                  },
                  oe_op, oe_ov);
        }
        int stall = 0;                    // the watchdog's stall age
        if (WD && act) stall = a.wd_stall[lin + in0 + i];
        if (act && size > 0) {
          const int lop = s_lop[i];
          const bool locked = lop >= 0;
          if (locked) {
            op = lop;
            ov = s_lov[i];
          } else if (target == n) {
            op = a.p_local;
            ov = 0;
          } else if (oe) {
            op = oe_op;
            ov = oe_ov;
          } else {
            const int eff =
                table_route(a, routed_algo<FAM>(a), f[F_ORDER], rph, k, ov);
            op = __ldg(a.port + ((long long)eff * N + n) * N + target);
          }
          if (WD && stall >= a.wd_stall_cycles && head && !locked &&
              target != n) {              // escape: one hop, the last VC
            op = __ldg(a.esc_port + (long long)n * N + target);
            ov = V - 1;
          }
          const bool is_eject = op == a.p_local;
          const int cop = clampi(op, 0, P - 1);
          bool live = is_eject;
          if (is_eject) {
            // an ejection candidate: fetch its flow's reorder words now
            const int src = f[F_SRC];
            if (tail && src >= 0 && src < N) {
              pre_exp = erow[src];
              pre_bits = brow[src];
            }
          } else {
            const int ch = __ldg(a.chan_of + n * P + cop);
            if (ch >= 0 && ch < C) {
              const float bw = __ldg(a.chan_bw + ch);
              live = __fsub_rn(floorf(__fmul_rn(cf1, bw)),
                               floorf(__fmul_rn(cf, bw))) >= 1.0f;
            }
          }
          const bool vc_free =
              s_oh[(t * P + cop) * V + clampi(ov, 0, V - 1)] == -1;
          const bool needs_alloc = head && !locked && !is_eject;
          elig = live && (vc_free || !needs_alloc);
          if (elig && !is_eject) {        // the receiver's credit
            const int nei = __ldg(a.neighbor + n * P + cop);
            const int rp = __ldg(a.recv_port + n * P + cop);
            const int ridx = clampi((nei * P + rp) * V + ov, 0, NIN - 1);
            const int rank = ridx / ti;
            elig = rank_ptr<CLUSTERED>(fs_cur, rank, me)[ridx - rank * ti] <
                   B;
          }
        }

        // ---- 5. switch allocation: a ballot per out-port ----------- //
        const int r_own = elig ? s_rr[t * P + clampi(op, 0, P - 1)] : 0;
        unsigned mine = 0;
        for (int po = 0; po < P; ++po) {
          const unsigned m = __ballot_sync(FULL, elig && op == po);
          if (elig && op == po) mine = m;
        }
        __syncwarp();
        bool won = false;
        if (elig) {
          const unsigned bits = (mine >> base) & segmask;
          const unsigned upper = bits & (FULL << pmod(r_own, PV));
          const int win = (upper ? __ffs(upper) : __ffs(bits)) - 1;
          won = win == k;
        }

        // ---- 6. pops, locks, out_held; 7. ejections ---------------- //
        if (act) {
          int push_op = -1;
          bool reload = false;
          const bool valid = size > 0;
          if (won) {
            s_rr[t * P + op] = (k + 1) % PV;
            s_start[i] = (st + 1) % B;
            size -= 1;
            reload = size > 0;            // a new head to fetch
            if (head && !tail) { s_lop[i] = op; s_lov[i] = ov; }
            else if (tail) { s_lop[i] = -1; s_lov[i] = -1; }
            if (op != a.p_local) {
              if ((tail || head) && ov >= 0 && ov < V)
                s_oh[(t * P + op) * V + ov] = (head && !tail) ? k : -1;
              // stage the flit as the receiver will hold it
              int* m = s_mov + (t * P + op) * NF;
#pragma unroll
              for (int x = 0; x < NF; ++x)
                m[x] = x == F_HOPS ? f[x] + 1
                       : x == F_PHASE ? (rph ? 1 : 0) : f[x];
              s_cseen[t * P + op] += 1;
              if (measuring) s_cfwd[t * P + op] += 1;
              push_op = op;
              s_pov[i] = ov;
              if (WD && f[F_HOPS] == a.wd_hop_limit)  // now one past it
                atomicAdd(a.wd_trips + 2 * lane + 1, 1);
              if (TEL) {
                const int ch = __ldg(a.chan_of + n * P + op);
                if (ch >= 0 && ch < C) atomicAdd(a.tel_chan + trow * C + ch, 1);
              }
            } else {
              r_eject += 1u;
              if (measuring) s_ejf[t] += 1;
              const int lat = (cyc - f[F_TIME]) + f[F_HOPS] + 1;  // +1: eject
              if (TEL && tail) tel_delivered(a, trow, lat);
              if (tail && f[F_TIME] >= a.warmup) {
                r_lat_sum += (uint32_t)lat;
                r_lat_cnt += 1u;
                r_lat_max = max(r_lat_max, lat);
                atomicAdd(&s_hist[clampi(floordiv(lat, a.lat_bin_width), 0,
                                         a.lat_bins - 1)], 1);
              }
              // reorder tracking: this node's window of the packet's flow
              const int src = f[F_SRC];
              if (tail && src >= 0 && src < N) {
                const int off = f[F_SEQ] - pre_exp;
                const bool in_win = off >= 0 && off < 32;
                const uint32_t bits2 =
                    in_win ? (pre_bits | (1u << clampi(off, 0, 31)))
                           : pre_bits;
                const uint32_t lowmask = bits2 & ~(bits2 + 1u);  // low 1s
                const int run = __popc(lowmask);
                uint32_t bits3 = bits2;
                if (bits2 & 1u) {
                  erow[src] = pre_exp + run;
                  bits3 = run >= 32 ? 0u : (bits2 >> min(run, 31));
                }
                brow[src] = bits3;
                s_occ[t] += __popc(bits3) - __popc(pre_bits);
              }
            }
          }
          s_size[i] = size;
          s_pop[i] = push_op;
          s_rl[i] = reload ? 1 : 0;
          fs_next[i] = size;
          if (WD) {
            const int ns = (valid && !won) ? stall + 1 : 0;
            a.wd_stall[lin + in0 + i] = ns;
            if (ns == a.wd_stall_cycles) atomicAdd(a.wd_trips + 2 * lane, 1);
          }
        }
        const unsigned granted = __ballot_sync(FULL, won);
        __syncwarp();
        if (act && k == 0 && measuring) {
          s_nfwd[t] += __popc((granted >> base) & segmask);
          r_rmax = max(r_rmax, s_occ[t] * a.PKT);
        }
      }
      // no spare warp: warp 0 carries the key chain after its nodes
      if (nwarps == MAX_WARPS && warp == 0 && c + 1 < a.num_cycles)
        advance_key<FAM>(chain, s_keys + KEY_STRIDE * ((c + 1) & 1), a.algo);
    }
    lane_sync<CLUSTERED>();

    // ====== phase B: the receive-side pushes, the new heads ============ //
    // (one winner per channel, so every target input takes at most one
    // push a cycle; its slot comes from the post-pop start and size, and
    // it is the head if the input is empty after its pop)
    if (!key_warp) {
      for (int r = 0; r < rounds; ++r) {
        const int t = (r * nwarps + warp) * spw + g;
        const int i = t * PV + k;
        if (!(seg_lane && t < tn)) continue;
        if (s_rl[i]) {                    // the popped input's next flit
          const int* hf =
              a.flits + ((lin + in0 + i) * B + s_start[i]) * NF;
#pragma unroll
          for (int x = 0; x < NF; ++x) s_head[i * NF + x] = __ldcg(hf + x);
        }
        const int op = s_pop[i];
        if (op < 0) continue;
        if (WD) throttle_runaway(a, s_mov + (t * P + op) * NF, lnn);
        const int n = node0 + t;
        const int di = (__ldg(a.neighbor + n * P + op) * P +
                        __ldg(a.recv_port + n * P + op)) * V + s_pov[i];
        if (di < 0 || di >= NIN) continue;
        const int rank = di / ti, li = di - rank * ti;
        int* dsize = rank_ptr<CLUSTERED>(s_size, rank, me) + li;
        const int dst_start = rank_ptr<CLUSTERED>(s_start, rank, me)[li];
        const int dsz = *dsize;
        int* rec = a.flits + ((lin + di) * B + (dst_start + dsz) % B) * NF;
        const int* m = s_mov + (t * P + op) * NF;
        int* dh = rank_ptr<CLUSTERED>(s_head, rank, me) + li * NF;
#pragma unroll
        for (int x = 0; x < NF; ++x) {
          const int v = m[x];
          __stcg(rec + x, v);
          if (dsz == 0) dh[x] = v;        // the target was empty
        }
        *dsize = dsz + 1;
        const int fsn_off = (int)(fs_next - sm);
        rank_ptr<CLUSTERED>(sm + fsn_off, rank, me)[li] = dsz + 1;
      }
    }
    if (threadIdx.x == 0 && me == 0) {
      r_meas += measuring ? 1u : 0u;
      if (TEL) tel_cycle(a, lane, trow, c);
    }
    lane_sync<CLUSTERED>();
  }

  // ---------------- flush the chunk ----------------------------------- //
  if (a.num_cycles > 0) {
    r_inj = __reduce_add_sync(FULL, r_inj);
    r_off = __reduce_add_sync(FULL, r_off);
    r_drop = __reduce_add_sync(FULL, r_drop);
    r_eject = __reduce_add_sync(FULL, r_eject);
    r_lat_sum = __reduce_add_sync(FULL, r_lat_sum);
    r_lat_cnt = __reduce_add_sync(FULL, r_lat_cnt);
    r_lat_max = __reduce_max_sync(FULL, r_lat_max);
    r_rmax = __reduce_max_sync(FULL, r_rmax);
    if (wl == 0) {
      atomicAdd(reinterpret_cast<unsigned*>(s_sums + S_INJ), r_inj);
      atomicAdd(reinterpret_cast<unsigned*>(s_sums + S_OFF), r_off);
      atomicAdd(reinterpret_cast<unsigned*>(s_sums + S_DROP), r_drop);
      atomicAdd(reinterpret_cast<unsigned*>(s_sums + S_EJECT), r_eject);
      atomicAdd(reinterpret_cast<unsigned*>(s_sums + S_LAT_SUM), r_lat_sum);
      atomicAdd(reinterpret_cast<unsigned*>(s_sums + S_LAT_CNT), r_lat_cnt);
      atomicMax(s_sums + S_LAT_MAX, r_lat_max);
      atomicMax(s_sums + S_RMAX, r_rmax);
    }
    if (threadIdx.x == 0)
      atomicAdd(reinterpret_cast<unsigned*>(s_sums + S_MEAS), r_meas);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ti; i += nthreads) {
    const long long gi = lin + in0 + i;
    a.fifo_start[gi] = s_start[i];
    a.fifo_size[gi] = s_size[i];
    a.lock_op[gi] = s_lop[i];
    a.lock_ov[gi] = s_lov[i];
    a.out_held[gi] = s_oh[i];
  }
  for (int j = threadIdx.x; j < tn * P; j += nthreads) {
    a.rr[lnn * P + node0 * P + j] = s_rr[j];
    const int ch = __ldg(a.chan_of + node0 * P + j);
    if (ch >= 0 && ch < C) {              // each channel has one source
      a.chan_seen[(long long)lane * C + ch] += s_cseen[j];
      a.chan_fwd[(long long)lane * C + ch] += s_cfwd[j];
    }
  }
  for (int t = threadIdx.x; t < tn; t += nthreads) {
    const long long ln = lnn + node0 + t;
    a.q_start[ln] = s_qstart[t];
    a.q_size[ln] = s_qsize[t];
    a.prog[ln] = s_prog[t];
    a.node_fwd[ln] = s_nfwd[t];
    a.eject_flits[ln] = s_ejf[t];
  }
  if (a.num_cycles > 0) {
    for (int j = threadIdx.x; j < a.lat_bins; j += nthreads)
      if (s_hist[j]) atomicAdd(a.lat_hist + (long long)lane * a.lat_bins + j,
                               s_hist[j]);
    if (threadIdx.x == 0) {
      auto add = [](int* p, int v) {
        atomicAdd(reinterpret_cast<unsigned*>(p), (unsigned)v);
      };
      add(a.lat_sum + lane, s_sums[S_LAT_SUM]);
      add(a.lat_cnt + lane, s_sums[S_LAT_CNT]);
      add(a.injected + lane, s_sums[S_INJ]);
      add(a.offered + lane, s_sums[S_OFF]);
      add(a.dropped + lane, s_sums[S_DROP]);
      add(a.eject_total + lane, s_sums[S_EJECT]);
      add(a.meas_cnt + lane, s_sums[S_MEAS]);
      atomicMax(a.lat_max + lane, s_sums[S_LAT_MAX]);
      atomicMax(a.reorder_max + lane, s_sums[S_RMAX]);
      if (me == 0) {
        a.key[2 * lane] = chain[0];
        a.key[2 * lane + 1] = chain[1];
      }
    }
  }
}

template <bool CLUSTERED, bool EMPTY, int MAXT, int FAM>
int launch(const SimArgs& a, cudaStream_t stream) {
  const int pv = a.P * a.V;
  const size_t smem =
      sizeof(int) * (size_t)layout(a.tile_nodes, a.P, a.V, a.lat_bins).words;
  auto kernel = simstep_chunk_kernel<CLUSTERED, EMPTY, MAXT, FAM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.ntiles > 8) {           // past the portable cluster size
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ntiles, a.L, 1);
  cfg.blockDim = dim3(block_threads(a.tile_nodes, pv), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ntiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The register budget follows the block: 128 a thread up to 512 threads,
// 80 up to 768, else 64.
template <bool CLUSTERED, bool EMPTY, int FAM>
int launch_sized(const SimArgs& a, cudaStream_t stream) {
  const int threads = block_threads(a.tile_nodes, a.P * a.V);
  if (threads <= 512) return launch<CLUSTERED, EMPTY, 512, FAM>(a, stream);
  if (threads <= 768) return launch<CLUSTERED, EMPTY, 768, FAM>(a, stream);
  return launch<CLUSTERED, EMPTY, 1024, FAM>(a, stream);
}

// The empty body (the floor) takes the XY instance: it routes nothing.
template <bool CLUSTERED, bool EMPTY>
int launch_family(const SimArgs& a, cudaStream_t stream) {
  if (EMPTY) return launch_sized<CLUSTERED, true, FAM_XY>(a, stream);
  return by_instance(a.algo, instrumented(a), [&](auto fam) {
    return launch_sized<CLUSTERED, false, decltype(fam)::value>(a, stream);
  });
}

// What the routing algorithms need of a router: its draw lanes within a
// segment, odd-even's four ports of a 2-D mesh, ROMM's coordinates; and
// what the watchdog and the telemetry need: their arrays and sizes.
__host__ __device__ inline bool algo_fits(const SimArgs& a) {
  if (a.algo < ALGO_XY || a.algo > ALGO_BIDOR) return false;
  if (a.P * a.V < 2 + algo_draw_lanes(a.algo, a.NDIM)) return false;
  if (a.algo == ALGO_ODDEVEN && (a.NDIM != 2 || a.P < 4)) return false;
  if (a.algo == ALGO_ROMM && (a.NDIM < 1 || a.NDIM > MAX_NDIM)) return false;
  if (a.watchdog && (!a.esc_port || !a.wd_stall || !a.wd_throttle ||
                     !a.wd_trips || a.wd_stall_cycles < 0))
    return false;
  if (a.tel_epoch < 0 ||
      (a.tel_epoch > 0 &&
       (!a.tel_chan || !a.tel_counts || !a.tel_cycles || !a.tel_lat ||
        !a.tel_qocc || !a.tel_qsum || a.tel_slots <= 0 ||
        a.tel_occ_bins <= 0)))
    return false;
  return true;
}

int checked_launch(const SimArgs* args, void* stream, bool empty) {
  const SimArgs a = *args;
  const int pv = a.P * a.V;
  if (pv < 2 || pv > MAX_PV || a.P > MAX_P || a.tile_nodes <= 0 ||
      a.N % a.tile_nodes != 0 || a.ntiles != a.N / a.tile_nodes ||
      a.ntiles > MAX_CLUSTER || a.num_cycles < 0 || a.lat_bins <= 0 ||
      !algo_fits(a))
    return (int)cudaErrorInvalidValue;
  if (a.num_cycles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.ntiles > 1)
    return empty ? launch_family<true, true>(a, s)
                 : launch_family<true, false>(a, s);
  return empty ? launch_family<false, true>(a, s)
               : launch_family<false, false>(a, s);
}

}  // namespace

// ======================================================================= //
// simstep_grid: the chunk for lanes no cluster holds
// ======================================================================= //
//
// At P*V = 10 a node's per-input state and head flits take 1 084 B of
// shared memory, so a block holds at most 213 nodes and a 16-block
// cluster 3 408; and the node count must split evenly.  17x17 (289, a
// prime square), 64x64 (4 096) and 96x96 (9 216) fail one or both, and
// 96x96 with 4 lanes is 40 MB of such state, more than the card's 132 SMs
// hold in shared memory (~30 MB).  This kernel keeps the chunk kernel's
// arithmetic and its router parallelism (a node is a segment of P*V
// lanes of a warp; the grant of each out-port is one ballot; the CDF
// search is (P*V + 1)-ary) and moves what does not fit:
//
// * The whole card in one cooperative launch.  A tile of `tile_nodes`
//   consecutive nodes of one lane is a unit; the L * N / tile_nodes units
//   are cut into runs of `rounds` consecutive units, one run a block, and
//   a block runs its units one after another (rounds).  The grid is what
//   the card holds at once (SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor,
//   chosen by ops.grid_layout), so any N x L runs.  A cycle is two
//   grid-wide barriers (cg::this_grid().sync(), whose fences order global
//   memory across the card): phase A per node, phase B the pushes.
// * Per-input state in global memory, where the L2 (50 MB) holds the hot
//   part at 64x64 and 4 lanes (~10 MB): FIFO start and size, locks,
//   out_held, rr, the queues and the counters are read and written in
//   place by the one block that owns the node.  What another block wrote
//   in this launch (FIFO sizes, the receiver's start, pushed flits) is
//   read at L2 (ld.cg) and written there (st.cg), never through the
//   read-only path.  A head flit is read where it sits, at its FIFO's
//   start; an injected flit that lands in an empty FIFO is handed to its
//   lane by shuffles.
// * The credit snapshot in two buffers by cycle parity (fs0, fs1): phase
//   A writes each input's post-pop size into the next buffer, a push adds
//   its flit there, and the current buffer is the FIFO size at the start
//   of the cycle, so there is no copy.  A popped flit stays in its slot
//   until the next cycle (a push never lands in the slot just popped:
//   credits keep a full FIFO from receiving), so phase B reads it there
//   and needs only the target input, push_to.
// * The key chain and the draws on the card, as the chunk kernel makes
//   them: each block derives, one cycle ahead, the keys of the lanes its
//   units belong to (a warp a lane, after its nodes), into shared memory.
// * The reorder occupancy in O(1): a per-(lane, node) count in occ,
//   filled once a chunk from the rbits row (only for lanes that measure
//   in the chunk), updated by popc(new) - popc(old) on each tail ejection.
// * Per-lane sums in registers while a thread's units stay in one lane,
//   then in the block's shared memory, flushed once a chunk with integer
//   atomics (wrapping at 2^32 as the reference's int32 sums do).
//
// What bounds it: latency, as the chunk kernel; every dependent access
// that the chunk kernel takes from shared memory is an L2 access here,
// and the two grid barriers a cycle are its floor (FlitStep.floor).

// The grid kernel's scratch and launch size, beside SimArgs.
// Field order must match repro_torch/kernels/simstep/kernel.py.
struct GridArgs {
  int* fs0;               // (L, NIN) FIFO sizes at the start of even cycles
  int* fs1;               // (L, NIN) ... of odd cycles
  int* push_to;           // (L, NIN) the input a popped flit moves to, or -1
  int* occ;               // (L, N) set reorder bits of each node's row
  int grid;               // blocks of the launch
};

namespace {

// per lane slot of a block: the keys (N_KEYS), the sums (N_SUMS), the
// lane's constants (cycle0, inject_until, measure_until, rate / PKT as
// float bits) and the latency histogram
constexpr int G_KEYS = 0, G_SUMS = N_KEYS, G_LANE = N_KEYS + N_SUMS,
              G_HIST = N_KEYS + N_SUMS + 4;

__host__ __device__ inline int grid_slot_words(int bins) {
  return G_HIST + bins;
}

// A block's `rounds` consecutive units of `tpl` units a lane span at
// most this many lanes.
__host__ __device__ inline int grid_lane_slots(int rounds, int tpl, int L) {
  const int s = (rounds - 1) / tpl + 2;
  return s < L ? s : L;
}

// A block carries one unit a round: one segment of P*V lanes a node.
__host__ __device__ inline int grid_threads(int tn, int pv) {
  const int per_warp = WARP / pv;
  return WARP * ((tn + per_warp - 1) / per_warp);
}

__device__ __forceinline__ void load_flit(int* f, const int* p) {
  const int2* q = reinterpret_cast<const int2*>(p);
#pragma unroll
  for (int x = 0; x < NF / 2; ++x) {
    const int2 v = __ldcg(q + x);
    f[2 * x] = v.x;
    f[2 * x + 1] = v.y;
  }
}

__device__ __forceinline__ void store_flit(int* p, const int* f) {
  int2* q = reinterpret_cast<int2*>(p);
#pragma unroll
  for (int x = 0; x < NF / 2; ++x) __stcg(q + x, make_int2(f[2 * x], f[2 * x + 1]));
}

// A thread's sums over the cycles of one lane.
struct Sums {
  uint32_t inj, off, drop, eject, lat_sum, lat_cnt;
  int lat_max, rmax;
};

// Add a warp's sums into a lane slot's shared sums and clear them; the
// whole warp calls it.
__device__ __forceinline__ void flush_sums(Sums& s, int* sums) {
  const bool any = __any_sync(
      FULL, (s.inj | s.off | s.drop | s.eject | s.lat_sum | s.lat_cnt) != 0u ||
                s.lat_max != 0 || s.rmax != 0);
  if (!any) return;
  const uint32_t inj = __reduce_add_sync(FULL, s.inj);
  const uint32_t off = __reduce_add_sync(FULL, s.off);
  const uint32_t drop = __reduce_add_sync(FULL, s.drop);
  const uint32_t eject = __reduce_add_sync(FULL, s.eject);
  const uint32_t lat_sum = __reduce_add_sync(FULL, s.lat_sum);
  const uint32_t lat_cnt = __reduce_add_sync(FULL, s.lat_cnt);
  const int lat_max = __reduce_max_sync(FULL, s.lat_max);
  const int rmax = __reduce_max_sync(FULL, s.rmax);
  if ((threadIdx.x & (WARP - 1)) == 0) {
    atomicAdd(reinterpret_cast<unsigned*>(sums + S_INJ), inj);
    atomicAdd(reinterpret_cast<unsigned*>(sums + S_OFF), off);
    atomicAdd(reinterpret_cast<unsigned*>(sums + S_DROP), drop);
    atomicAdd(reinterpret_cast<unsigned*>(sums + S_EJECT), eject);
    atomicAdd(reinterpret_cast<unsigned*>(sums + S_LAT_SUM), lat_sum);
    atomicAdd(reinterpret_cast<unsigned*>(sums + S_LAT_CNT), lat_cnt);
    atomicMax(sums + S_LAT_MAX, lat_max);
    atomicMax(sums + S_RMAX, rmax);
  }
  s = Sums{0u, 0u, 0u, 0u, 0u, 0u, 0, 0};
}

// Cycles of [cyc0, cyc0 + nc) that measure: cyc >= warmup, cyc < until.
__device__ __forceinline__ int measured_cycles(int cyc0, int until,
                                               int warmup, int nc) {
  const int lo = max(cyc0, warmup), hi = min(cyc0 + nc, until);
  return hi > lo ? hi - lo : 0;
}

// MAXT bounds the block; with 1024 / MAXT blocks an SM the budget is 64
// registers a thread, so 32 warps of the kernel fit on one SM.
template <bool EMPTY, int MAXT, int FAM>
__global__ void __launch_bounds__(MAXT, 1024 / MAXT)
simstep_grid_kernel(const SimArgs a, const GridArgs gr) {
  extern __shared__ int sm[];
  cg::grid_group grid = cg::this_grid();
  const int nc = a.num_cycles;
  if (EMPTY) {
    grid.sync();
    for (int c = 0; c < nc; ++c) {
      grid.sync();
      grid.sync();
    }
    return;
  }
  const int N = a.N, P = a.P, V = a.V, PV = P * V, NIN = a.NIN;
  const int B = a.B, Q = a.Q, C = a.C, bins = a.lat_bins;
  const int tn = a.tile_nodes, tpl = a.ntiles;
  const int units = a.L * tpl;
  const int rounds = (units + (int)gridDim.x - 1) / (int)gridDim.x;
  const int u0 = blockIdx.x * rounds;                  // the block's units
  const int nu = min(u0 + rounds, units) - u0;
  const int lane_lo = u0 / tpl;
  const int nslots = (u0 + nu - 1) / tpl - lane_lo + 1;  // lanes it serves
  const int sw = grid_slot_words(bins);
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x / WARP, wl = threadIdx.x % WARP;
  const int nwarps = nthreads / WARP;
  const int spw = WARP / PV;                           // nodes a warp
  const int g = wl / PV, k = wl - g * PV;              // segment, input
  const int sidx = warp * spw + g;                     // node of a unit
  const bool act = g < spw && sidx < tn;
  const int base = g * PV;                             // segment's lane 0
  const int seg0 = base & (WARP - 1);
  const unsigned segmask = PV == 32 ? FULL : ((1u << PV) - 1u);
  // constants in every instance but the instrumented one
  const bool oe = routes_as<FAM, FAM_ODDEVEN, ALGO_ODDEVEN>(a);
  const bool bd = routes_as<FAM, FAM_BIDOR, ALGO_BIDOR>(a);
  const bool WD = FAM == FAM_INSTR && a.watchdog != 0;
  const bool TEL = FAM == FAM_INSTR && a.tel_epoch > 0;

  // ---------------- the block's lanes: constants, sums, keys ----------- //
  for (int j = threadIdx.x; j < nslots * sw; j += nthreads) sm[j] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < nslots; s += nthreads) {
    const int lane = lane_lo + s;
    int* lw = sm + s * sw + G_LANE;
    lw[0] = a.cycle0[lane];
    lw[1] = a.inject_until[lane];
    lw[2] = a.measure_until[lane];
    lw[3] = __float_as_int(__fdiv_rn(a.rate[lane], (float)a.PKT));
  }
  for (int s = warp; s < nslots; s += nwarps) {
    int* kw = sm + s * sw + G_KEYS;
    if (wl == 0) {
      kw[KEY_CHAIN] = a.key[2 * (lane_lo + s)];
      kw[KEY_CHAIN + 1] = a.key[2 * (lane_lo + s) + 1];
    }
    __syncwarp();
    advance_key<FAM>(kw + KEY_CHAIN, kw, a.algo);      // cycle 0's keys
  }
  // the queue-total words of the lanes whose first unit is the block's
  if (TEL && threadIdx.x == 0) {
    for (int r = 0; r < nu; ++r) {
      if ((u0 + r) % tpl) continue;
      const int lane = (u0 + r) / tpl;
      __stcg(a.tel_qsum + 2 * lane, 0);
      __stcg(a.tel_qsum + 2 * lane + 1, 0);
    }
  }
  __syncthreads();
  // the credit snapshot of cycle 0: the FIFO sizes as they stand
  if (act) {
    for (int r = 0; r < nu; ++r) {
      const int u = u0 + r, lane = u / tpl;
      const int n = (u - lane * tpl) * tn + sidx;
      const long long gi = (long long)lane * NIN + (long long)n * PV + k;
      __stcg(gr.fs0 + gi, a.fifo_size[gi]);
    }
  }
  // reorder occupancy of the lanes that measure in this chunk: one warp a
  // node pop-counts its rbits row
  for (int j = warp; j < nu * tn; j += nwarps) {
    const int u = u0 + j / tn, lane = u / tpl;
    const int* lw = sm + (lane - lane_lo) * sw + G_LANE;
    if (measured_cycles(lw[0], lw[2], a.warmup, nc) == 0) continue;
    const long long ln = (long long)lane * N + (u - lane * tpl) * tn + j % tn;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(a.rbits) + ln * N;
    int cnt = 0;
    for (int x = wl; x < N; x += WARP) cnt += __popc(row[x]);
    cnt = __reduce_add_sync(FULL, cnt);
    if (wl == 0) gr.occ[ln] = cnt;
  }
  Sums sums = {0u, 0u, 0u, 0u, 0u, 0u, 0, 0};
  int cur = 0;                       // the lane slot `sums` belongs to
  grid.sync();

  for (int c = 0; c < nc; ++c) {
    const int* fs_cur = (c & 1) ? gr.fs1 : gr.fs0;
    int* fs_next = (c & 1) ? gr.fs0 : gr.fs1;

    // ====== phase A: per node, generation to pops and ejections ======== //
    for (int r = 0; r < nu; ++r) {
      const int u = u0 + r, lane = u / tpl, slot = lane - lane_lo;
      if (slot != cur) {                                // block-uniform
        flush_sums(sums, sm + cur * sw + G_SUMS);
        cur = slot;
      }
      const int* lw = sm + slot * sw;
      const int cyc = lw[G_LANE] + c;
      const int inj_until = lw[G_LANE + 1];
      const bool measuring = cyc >= a.warmup && cyc < lw[G_LANE + 2];
      const float per_flit = __int_as_float(lw[G_LANE + 3]);
      const int* kk = lw + G_KEYS + KEY_STRIDE * (c & 1);
      const uint32_t kg0 = (uint32_t)kk[0], kg1 = (uint32_t)kk[1];
      const uint32_t kd0 = (uint32_t)kk[2], kd1 = (uint32_t)kk[3];
      const float cf = (float)cyc;
      const float cf1 = __fadd_rn(cf, 1.0f);
      const int n = (u - lane * tpl) * tn + sidx;      // valid where act
      const long long lin = (long long)lane * NIN;
      const long long ln = (long long)lane * N + n;
      const long long gi = lin + (long long)n * PV + k;
      const long long trow = TEL ? tel_row(a, lane, cyc) : 0;

      // ---- 0. the input's state and head flit, the queue head -------- //
      int st = 0, size = 0, lop = -1;
      int f[NF];
#pragma unroll
      for (int x = 0; x < NF; ++x) f[x] = 0;
      if (act) {
        st = a.fifo_start[gi];
        size = __ldcg(fs_cur + gi);
        lop = a.lock_op[gi];
        if (size > 0) load_flit(f, a.flits + (gi * B + st) * NF);
      }
      int qs = 0, qst = 0, pr = 0;
      int h[NQ];
#pragma unroll
      for (int x = 0; x < NQ; ++x) h[x] = 0;
      int* qrow = a.qpkts + ln * (long long)Q * NQ;
      if (act && k == 0) {
        qs = a.q_size[ln];
        qst = a.q_start[ln];
        pr = a.prog[ln];
        if (qs > 0) {
#pragma unroll
          for (int x = 0; x < NQ; ++x) h[x] = qrow[qst * NQ + x];
        }
      }

      // ---- 1. packet generation: the draws, then the CDF search ---- //
      float draw = 0.0f;
      if (act && k < 2)
        draw = node_uniform(k ? kd0 : kg0, k ? kd1 : kg1, n, N);
      const float uu = __shfl_sync(FULL, draw, seg0);
      const float ud = __shfl_sync(FULL, draw, (base + 1) & (WARP - 1));
      bool gen = act && (uu < __fmul_rn(__ldg(a.p_gen + n), per_flit)) &&
                 (cyc < inj_until);
      if (WD) gen = unthrottled(a, act && k == 0, ln, base) && gen;
      int lo = 0, hi = N;
      const float* row = a.cdf + (long long)n * N;
      while (__any_sync(FULL, gen && lo < hi)) {
        const bool probe = gen && lo < hi;
        const int width = hi - lo;
        bool le = false;
        if (probe) le = __ldg(row + lo + ((k + 1) * width) / (PV + 1)) <= ud;
        const unsigned m = __ballot_sync(FULL, le);
        if (probe) {
          const int cnt = __popc((m >> base) & segmask);
          const int nlo = cnt > 0 ? lo + (cnt * width) / (PV + 1) + 1 : lo;
          const int nhi = cnt < PV ? lo + ((cnt + 1) * width) / (PV + 1) : hi;
          lo = nlo;
          hi = nhi;
        }
      }
      const int dst = clampi(lo, 0, N - 1);
      int order, inter;
      packet_meta<FAM>(a, kk + 4, gen, n, dst, k, base, order, inter);
      // odd-even's local VC sizes, from the lanes that hold them
      int local_vc = 0;
      if (oe) {
        int best = 0;
        for (int j = 0; j < V; ++j) {
          const int sz = __shfl_sync(
              FULL, size, (base + a.p_local * V + j) & (WARP - 1));
          if (j == 0 || sz < best) { best = sz; local_vc = j; }
        }
      }
      // ---- 1b. source-queue push (segment lane 0) ------------------- //
      int lk = -1;                      // the input the head packet enters
      if (act && k == 0) {
        const bool space = qs < Q;
        if (gen && space) {
          if (bd) order = __ldg(a.choice + (long long)n * N + dst);
          int* nseq = a.next_seq + ln * N + dst;
          const int seq = *nseq;
          *nseq = seq + 1;
          int* rec = qrow + pmod(qst + qs, Q) * NQ;
          rec[Q_DST] = dst; rec[Q_INTER] = inter; rec[Q_ORDER] = order;
          rec[Q_TIME] = cyc; rec[Q_SEQ] = seq;
          if (qs == 0) {
            h[Q_DST] = dst; h[Q_INTER] = inter; h[Q_ORDER] = order;
            h[Q_TIME] = cyc; h[Q_SEQ] = seq;
          }
          qs += 1;
        }
        if (measuring) {
          sums.off += gen ? 1u : 0u;
          sums.drop += (gen && !space) ? 1u : 0u;
        }
        if (TEL && gen) tel_generated(a, trow, space);
        if (qs > 0)
          lk = a.p_local * V +
               (oe ? local_vc : vc_in_of(routed_algo<FAM>(a), n, h, V));
      }
      // ---- 2. flit injection: the input's size and start from its lane //
      lk = __shfl_sync(FULL, lk, seg0);
      const int from = (base + (lk < 0 ? 0 : lk)) & (WARP - 1);
      const int lf_size = __shfl_sync(FULL, size, from);  // before the pops
      const int lf_start = __shfl_sync(FULL, st, from);
      int jf[NF];
#pragma unroll
      for (int x = 0; x < NF; ++x) jf[x] = 0;
      int inj_k = -1;
      if (act && k == 0) {
        bool done = false;
        if (lk >= 0 && lf_size < B) {
          jf[F_SRC] = n; jf[F_DST] = h[Q_DST]; jf[F_INTER] = h[Q_INTER];
          jf[F_SEQ] = h[Q_SEQ]; jf[F_TIME] = h[Q_TIME]; jf[F_HOPS] = 0;
          jf[F_ORDER] = h[Q_ORDER]; jf[F_HEAD] = pr == 0 ? 1 : 0;
          jf[F_TAIL] = pr == a.PKT - 1 ? 1 : 0;
          jf[F_PHASE] = (h[Q_INTER] < 0 || h[Q_INTER] == n) ? 1 : 0;
          store_flit(a.flits + ((gi + lk) * B + pmod(lf_start + lf_size, B)) * NF,
                     jf);
          inj_k = lk;
          pr += 1;
          done = pr >= a.PKT;
          if (done) pr = 0;
          sums.inj += 1u;
        }
        a.prog[ln] = pr;
        a.q_start[ln] = done ? (qst + 1) % Q : qst;
        a.q_size[ln] = qs - (done ? 1 : 0);
        if (TEL && qs - (done ? 1 : 0) > 0)
          atomicAdd(a.tel_qsum + 2 * lane + (c & 1), qs - (done ? 1 : 0));
      }
      inj_k = __shfl_sync(FULL, inj_k, seg0);
      const bool took = act && k == inj_k;
      if (__any_sync(FULL, took && size == 0)) {   // the new flit is the head
#pragma unroll
        for (int x = 0; x < NF; ++x) {
          const int v = __shfl_sync(FULL, jf[x], seg0);
          if (took && size == 0) f[x] = v;
        }
      }
      if (took) size += 1;

      // ---- 3-4. routing and eligibility, one lane per input -------- //
      bool elig = false;
      int op = -1, ov = 0, nei = 0, rp = 0;
      const bool head = f[F_HEAD] != 0, tail = f[F_TAIL] != 0;
      const bool rph = f[F_PHASE] != 0 || f[F_INTER] < 0 || f[F_INTER] == n;
      const int target = clampi(rph ? f[F_DST] : f[F_INTER], 0, N - 1);
      int* erow = a.exp_seq + ln * N;
      uint32_t* brow = reinterpret_cast<uint32_t*>(a.rbits) + ln * N;
      int pre_exp = 0;
      uint32_t pre_bits = 0;
      int oe_op = 0, oe_ov = 0;
      if (oe) {
        // this lane's receiver's credits, in the pre-cycle snapshot
        const int fv = act ? B - __ldcg(fs_cur + lin + recv_index(a, n, k)) : 0;
        oddeven(a, act && size > 0, n, clampi(f[F_SRC], 0, N - 1), target, fv,
                base,
                [&](int po, int v) {
                  return a.out_held[(ln * P + po) * V + v] >= 0;
                },
                oe_op, oe_ov);
      }
      int stall = 0;                      // the watchdog's stall age
      if (WD && act) stall = a.wd_stall[gi];
      if (act && size > 0) {
        const bool locked = lop >= 0;
        if (locked) {
          op = lop;
          ov = a.lock_ov[gi];
        } else if (target == n) {
          op = a.p_local;
          ov = 0;
        } else if (oe) {
          op = oe_op;
          ov = oe_ov;
        } else {
          const int eff =
              table_route(a, routed_algo<FAM>(a), f[F_ORDER], rph, k, ov);
          op = __ldg(a.port + ((long long)eff * N + n) * N + target);
        }
        if (WD && stall >= a.wd_stall_cycles && head && !locked &&
            target != n) {                // escape: one hop, the last VC
          op = __ldg(a.esc_port + (long long)n * N + target);
          ov = V - 1;
        }
        const bool is_eject = op == a.p_local;
        const int cop = clampi(op, 0, P - 1);
        bool live = is_eject;
        if (is_eject) {
          const int src = f[F_SRC];
          if (tail && src >= 0 && src < N) {
            pre_exp = erow[src];
            pre_bits = brow[src];
          }
        } else {
          const int ch = __ldg(a.chan_of + n * P + cop);
          if (ch >= 0 && ch < C) {
            const float bw = __ldg(a.chan_bw + ch);
            live = __fsub_rn(floorf(__fmul_rn(cf1, bw)),
                             floorf(__fmul_rn(cf, bw))) >= 1.0f;
          }
        }
        const bool vc_free =
            a.out_held[(ln * P + cop) * V + clampi(ov, 0, V - 1)] == -1;
        const bool needs_alloc = head && !locked && !is_eject;
        elig = live && (vc_free || !needs_alloc);
        if (elig && !is_eject) {          // the receiver's credit
          nei = __ldg(a.neighbor + n * P + cop);
          rp = __ldg(a.recv_port + n * P + cop);
          const int ridx = clampi((nei * P + rp) * V + ov, 0, NIN - 1);
          elig = __ldcg(fs_cur + lin + ridx) < B;
        }
      }

      // ---- 5. switch allocation: a ballot per out-port ----------- //
      const int r_own = elig ? a.rr[ln * P + clampi(op, 0, P - 1)] : 0;
      unsigned mine = 0;
      for (int po = 0; po < P; ++po) {
        const unsigned m = __ballot_sync(FULL, elig && op == po);
        if (elig && op == po) mine = m;
      }
      __syncwarp();
      bool won = false;
      if (elig) {
        const unsigned bits = (mine >> base) & segmask;
        const unsigned upper = bits & (FULL << pmod(r_own, PV));
        const int win = (upper ? __ffs(upper) : __ffs(bits)) - 1;
        won = win == k;
      }

      // ---- 6. pops, locks, out_held; 7. ejections ---------------- //
      if (act) {
        int to = -1;
        const bool valid = size > 0;
        if (won) {
          a.rr[ln * P + op] = (k + 1) % PV;
          a.fifo_start[gi] = (st + 1) % B;
          size -= 1;
          if (head && !tail) { a.lock_op[gi] = op; a.lock_ov[gi] = ov; }
          else if (tail) { a.lock_op[gi] = -1; a.lock_ov[gi] = -1; }
          if (op != a.p_local) {
            if ((tail || head) && ov >= 0 && ov < V)
              a.out_held[(ln * P + op) * V + ov] = (head && !tail) ? k : -1;
            const int ch = __ldg(a.chan_of + n * P + op);
            if (ch >= 0 && ch < C) {          // each channel has one source
              a.chan_seen[(long long)lane * C + ch] += 1;
              if (measuring) a.chan_fwd[(long long)lane * C + ch] += 1;
              if (TEL) atomicAdd(a.tel_chan + trow * C + ch, 1);
            }
            if (WD && f[F_HOPS] == a.wd_hop_limit)  // now one past it
              atomicAdd(a.wd_trips + 2 * lane + 1, 1);
            to = (nei * P + rp) * V + ov;
          } else {
            sums.eject += 1u;
            if (measuring) a.eject_flits[ln] += 1;
            const int lat = (cyc - f[F_TIME]) + f[F_HOPS] + 1;  // +1: eject
            if (TEL && tail) tel_delivered(a, trow, lat);
            if (tail && f[F_TIME] >= a.warmup) {
              sums.lat_sum += (uint32_t)lat;
              sums.lat_cnt += 1u;
              sums.lat_max = max(sums.lat_max, lat);
              atomicAdd(sm + slot * sw + G_HIST +
                            clampi(floordiv(lat, a.lat_bin_width), 0, bins - 1),
                        1);
            }
            // reorder tracking: this node's window of the packet's flow
            const int src = f[F_SRC];
            if (tail && src >= 0 && src < N) {
              const int off = f[F_SEQ] - pre_exp;
              const bool in_win = off >= 0 && off < 32;
              const uint32_t bits2 =
                  in_win ? (pre_bits | (1u << clampi(off, 0, 31))) : pre_bits;
              const uint32_t lowmask = bits2 & ~(bits2 + 1u);  // low 1s
              const int run = __popc(lowmask);
              uint32_t bits3 = bits2;
              if (bits2 & 1u) {
                erow[src] = pre_exp + run;
                bits3 = run >= 32 ? 0u : (bits2 >> min(run, 31));
              }
              brow[src] = bits3;
              gr.occ[ln] += __popc(bits3) - __popc(pre_bits);
            }
          }
        }
        gr.push_to[gi] = to;
        __stcg(fs_next + gi, size);
        if (WD) {
          const int ns = (valid && !won) ? stall + 1 : 0;
          a.wd_stall[gi] = ns;
          if (ns == a.wd_stall_cycles) atomicAdd(a.wd_trips + 2 * lane, 1);
        }
      }
      const unsigned granted = __ballot_sync(FULL, won);
      __syncwarp();
      if (act && k == 0 && measuring) {
        a.node_fwd[ln] += __popc((granted >> base) & segmask);
        sums.rmax = max(sums.rmax, gr.occ[ln] * a.PKT);
      }
    }
    // the next cycle's keys of the block's lanes, a warp a lane
    if (c + 1 < nc) {
      for (int s = warp; s < nslots; s += nwarps)
        advance_key<FAM>(sm + s * sw + G_KEYS + KEY_CHAIN,
                    sm + s * sw + G_KEYS + KEY_STRIDE * ((c + 1) & 1),
                    a.algo);
    }
    grid.sync();

    // ====== phase B: the receive-side pushes =========================== //
    // (one winner per channel, so every target input takes at most one
    // push a cycle; its slot comes from the post-pop start and size)
    if (TEL && threadIdx.x == 0) {     // the lanes whose first unit it holds
      for (int r = 0; r < nu; ++r) {
        if ((u0 + r) % tpl) continue;
        const int lane = (u0 + r) / tpl;
        const int cyc = sm[(lane - lane_lo) * sw + G_LANE] + c;
        tel_cycle(a, lane, tel_row(a, lane, cyc), c);
      }
    }
    if (act) {
      for (int r = 0; r < nu; ++r) {
        const int u = u0 + r, lane = u / tpl;
        const int n = (u - lane * tpl) * tn + sidx;
        const long long lin = (long long)lane * NIN;
        const long long gi = lin + (long long)n * PV + k;
        const int to = gr.push_to[gi];
        if (to < 0 || to >= NIN) continue;
        const int st = a.fifo_start[gi];             // one past the popped
        int f[NF];
        load_flit(f, a.flits + (gi * B + (st + B - 1) % B) * NF);
        const bool rph = f[F_PHASE] != 0 || f[F_INTER] < 0 || f[F_INTER] == n;
        f[F_HOPS] += 1;
        f[F_PHASE] = rph ? 1 : 0;
        if (WD) throttle_runaway(a, f, (long long)lane * N);
        const long long gd = lin + to;
        const int dst_start = __ldcg(a.fifo_start + gd);
        const int dsz = __ldcg(fs_next + gd);
        store_flit(a.flits + (gd * B + (dst_start + dsz) % B) * NF, f);
        __stcg(fs_next + gd, dsz + 1);
      }
    }
    grid.sync();
  }

  // ---------------- flush the chunk ----------------------------------- //
  flush_sums(sums, sm + cur * sw + G_SUMS);
  const int* fs_end = (nc & 1) ? gr.fs1 : gr.fs0;
  if (act) {
    for (int r = 0; r < nu; ++r) {
      const int u = u0 + r, lane = u / tpl;
      const int n = (u - lane * tpl) * tn + sidx;
      const long long gi = (long long)lane * NIN + (long long)n * PV + k;
      a.fifo_size[gi] = __ldcg(fs_end + gi);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < nslots; s += nthreads) {
    const int lane = lane_lo + s;
    const int* ss = sm + s * sw + G_SUMS;
    auto add = [](int* p, int v) {
      atomicAdd(reinterpret_cast<unsigned*>(p), (unsigned)v);
    };
    add(a.lat_sum + lane, ss[S_LAT_SUM]);
    add(a.lat_cnt + lane, ss[S_LAT_CNT]);
    add(a.injected + lane, ss[S_INJ]);
    add(a.offered + lane, ss[S_OFF]);
    add(a.dropped + lane, ss[S_DROP]);
    add(a.eject_total + lane, ss[S_EJECT]);
    atomicMax(a.lat_max + lane, ss[S_LAT_MAX]);
    atomicMax(a.reorder_max + lane, ss[S_RMAX]);
    const int first = lane * tpl;                 // the lane's first unit
    if (first >= u0 && first < u0 + nu) {         // one block a lane
      const int* lw = sm + s * sw;
      add(a.meas_cnt + lane,
          measured_cycles(lw[G_LANE], lw[G_LANE + 2], a.warmup, nc));
      a.key[2 * lane] = lw[G_KEYS + KEY_CHAIN];
      a.key[2 * lane + 1] = lw[G_KEYS + KEY_CHAIN + 1];
    }
  }
  for (int j = threadIdx.x; j < nslots * bins; j += nthreads) {
    const int s = j / bins, b = j - s * bins;
    const int v = sm[s * sw + G_HIST + b];
    if (v) atomicAdd(a.lat_hist + (long long)(lane_lo + s) * bins + b, v);
  }
}

template <bool EMPTY, int MAXT, int FAM>
int grid_launch(const SimArgs& a, const GridArgs& gr, cudaStream_t stream) {
  auto kernel = simstep_grid_kernel<EMPTY, MAXT, FAM>;
  const int units = a.L * a.ntiles;
  const int rounds = (units + gr.grid - 1) / gr.grid;
  const size_t smem = sizeof(int) *
                      (size_t)grid_lane_slots(rounds, a.ntiles, a.L) *
                      grid_slot_words(a.lat_bins);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {const_cast<SimArgs*>(&a), const_cast<GridArgs*>(&gr)};
  err = cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3(gr.grid), dim3(grid_threads(a.tile_nodes, a.P * a.V)),
      params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool EMPTY, int FAM>
int grid_launch_sized(const SimArgs& a, const GridArgs& gr,
                      cudaStream_t stream) {
  const int threads = grid_threads(a.tile_nodes, a.P * a.V);
  if (threads <= 128) return grid_launch<EMPTY, 128, FAM>(a, gr, stream);
  if (threads <= 256) return grid_launch<EMPTY, 256, FAM>(a, gr, stream);
  if (threads <= 512) return grid_launch<EMPTY, 512, FAM>(a, gr, stream);
  return grid_launch<EMPTY, 1024, FAM>(a, gr, stream);
}

int checked_grid_launch(const SimArgs* args, const GridArgs* gargs,
                        void* stream, bool empty) {
  const SimArgs a = *args;
  const GridArgs gr = *gargs;
  const int pv = a.P * a.V;
  if (pv < 2 || pv > MAX_PV || a.P > MAX_P || a.tile_nodes <= 0 ||
      a.N % a.tile_nodes != 0 || a.ntiles != a.N / a.tile_nodes ||
      a.tile_nodes > MAX_WARPS * (WARP / pv) || a.L <= 0 ||
      a.num_cycles < 0 || a.lat_bins <= 0 || !algo_fits(a))
    return (int)cudaErrorInvalidValue;
  const int units = a.L * a.ntiles;
  if (gr.grid < 1 || gr.grid > units) return (int)cudaErrorInvalidValue;
  const int rounds = (units + gr.grid - 1) / gr.grid;
  if ((gr.grid - 1) * rounds >= units)     // every block holds a unit
    return (int)cudaErrorInvalidValue;
  if (a.num_cycles == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (empty) return grid_launch_sized<true, FAM_XY>(a, gr, s);
  return by_instance(a.algo, instrumented(a), [&](auto fam) {
    return grid_launch_sized<false, decltype(fam)::value>(a, gr, s);
  });
}

template <int MAXT, int FAM>
int grid_occupancy(int threads, int smem) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, simstep_grid_kernel<false, MAXT, FAM>, threads, (size_t)smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

template <int FAM>
int grid_occupancy_sized(int threads, int smem) {
  if (threads <= 128) return grid_occupancy<128, FAM>(threads, smem);
  if (threads <= 256) return grid_occupancy<256, FAM>(threads, smem);
  if (threads <= 512) return grid_occupancy<512, FAM>(threads, smem);
  return grid_occupancy<1024, FAM>(threads, smem);
}

}  // namespace

// Advance every lane by num_cycles cycles: one block per (lane, tile),
// the tiles of a lane one cluster.  Returns a cudaError_t (0 = launched).
extern "C" int simstep_chunk_launch(const SimArgs* args, void* stream) {
  return checked_launch(args, stream, false);
}

// The same launch shape and per-cycle barriers with an empty body: the
// chunk kernel's latency floor, for measurement only.
extern "C" int simstep_floor_launch(const SimArgs* args, void* stream) {
  return checked_launch(args, stream, true);
}

// Shared-memory bytes of a block of `tile_nodes` nodes, and its threads,
// so the binding can check its own layout arithmetic.
extern "C" int simstep_smem_bytes(int tile_nodes, int P, int V,
                                  int lat_bins) {
  return (int)sizeof(int) * layout(tile_nodes, P, V, lat_bins).words;
}

extern "C" int simstep_block_threads(int tile_nodes, int P, int V) {
  return block_threads(tile_nodes, P * V);
}

// sizeof(SimArgs), so the binding can check its record layout.
extern "C" int simstep_args_size() { return (int)sizeof(SimArgs); }

// Advance every lane by num_cycles cycles in one cooperative launch of
// `gargs->grid` blocks over the card.  Returns a cudaError_t (0 = launched;
// cudaErrorCooperativeLaunchTooLarge if the card cannot hold the grid).
extern "C" int simstep_grid_launch(const SimArgs* args, const GridArgs* gargs,
                                   void* stream) {
  return checked_grid_launch(args, gargs, stream, false);
}

// The same launch with an empty body, its two grid barriers a cycle: the
// grid kernel's latency floor, for measurement only.
extern "C" int simstep_grid_floor_launch(const SimArgs* args,
                                         const GridArgs* gargs, void* stream) {
  return checked_grid_launch(args, gargs, stream, true);
}

// Blocks of `tile_nodes` nodes the grid kernel for `algo` (its
// instrumented instance where `instr` is set) keeps on one SM with `smem`
// bytes of dynamic shared memory each
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative: a cudaError_t).
extern "C" int simstep_grid_blocks_per_sm(int tile_nodes, int P, int V,
                                          int smem, int algo, int instr) {
  const int threads = grid_threads(tile_nodes, P * V);
  return by_instance(algo, instr != 0, [&](auto fam) {
    return grid_occupancy_sized<decltype(fam)::value>(threads, smem);
  });
}

// Shared-memory bytes and threads of a grid-kernel block, so the binding
// can check its own layout arithmetic.
extern "C" int simstep_grid_smem_bytes(int rounds, int tiles_a_lane, int L,
                                       int lat_bins) {
  return (int)sizeof(int) * grid_lane_slots(rounds, tiles_a_lane, L) *
         grid_slot_words(lat_bins);
}

extern "C" int simstep_grid_threads(int tile_nodes, int P, int V) {
  return grid_threads(tile_nodes, P * V);
}

// sizeof(GridArgs), so the binding can check its record layout.
extern "C" int simstep_grid_args_size() { return (int)sizeof(GridArgs); }
