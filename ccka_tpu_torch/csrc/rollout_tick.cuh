// One control tick of one cluster, shared by the rollout kernels.
//
// rollout_profiles.cu (rule profiles, carbon re-rank, plan playback) and
// rollout_mlp.cu (learned policy) differ only in how a cluster picks its
// action; what the action then does to the fleet is this header: tick()
// advances a Fleet held in registers by one 30 s step and folds the
// step's metrics into its accumulators.
//
// Computes, per cluster and tick, exactly what the port's plain rollout
// does (ccka_tpu_torch/sim/dynamics.py::step, folded by
// sim/metrics.py::SummaryAcc): HPA desired pods, the K-deep provisioning
// pipeline, Poisson spot interruptions, scheduling, the softmax
// cheapest-zone split with the per-pool cap, consolidation (sigmoid
// timers, PDB budget), and the cost, carbon, latency and SLO accounting
// into 16 accumulators.
//
// Lanes of a cluster (Group<G>): G adjacent lanes of a warp step one
// cluster. Lane r owns pools [r P/G, (r+1) P/G): their nodes, pipeline
// and consolidation timers, their spot rows' interruptions, their share
// of the provisioning split and of consolidation. The state the pools
// share (running pods, the accumulators, the workload queues, a held
// observation) sits in every lane of the group in the same bits: each
// lane computes it from the same inputs with the same operations. A sum
// over pools is handed from lane to lane (Group::chain), and with two
// lanes a quantity of capacity type c is computed by lane c and swapped
// (Group::per_type). The profile kernel runs pairs (G = 2, a lane per
// pool); the MLP kernel one thread a cluster (G = 1), where every
// exchange is the plain loop.
//
// Two compile-time branches widen the tick (they replace the fault and
// workload specialisations of ccka_tpu/sim/megakernel.py::_make_kernel):
// - FAULTS: the stream carries the fault block (hazard[Z], deny, delay,
//   stale). A delay share of the arrivals goes back to the pipeline's
//   head; the interruption probability is min(p * hazard_z, 1); the spot
//   request is scaled by (1 - deny) and the denied part counted; a policy
//   that observes signals reads the held ones during an outage
//   (observed()).
// - WL_D > 0: the stream carries the workload block (inference, batch,
//   background arrivals); the queues (Queues<WL_D>) drain from the
//   post-step fleet's headroom, inference first, then batch earliest
//   deadline first over the D-deep age pipeline, then background, into
//   5 more accumulators.
// With FAULTS false and WL_D 0 the tick is the program without lanes.
// On neutral lanes (hazard 1, deny, delay 0) and zero arrivals the
// widened tick gives the same bits: x*0, x*(1-0) and min(p*1, 1) are
// exact.
//
// Arithmetic follows the plain version op for op: sums over the pool,
// zone and capacity-type axes are the same left-to-right chains (a chain
// starts from -0.0f, which x + -0.0f == x makes exact for every x); a
// division by a literal is a multiply by its float reciprocal, as
// PyTorch's CUDA division by a Python scalar is; build with -fmad=false
// and without fast math so that no multiply-add is fused and expf, logf,
// cosf, sqrtf are the same library functions PyTorch calls.
//
// Randomness: in stochastic mode each spot row of each (cluster, tick)
// takes one Philox4x32-10 call at counter (cluster, tick, p*Z+z, 0), key
// (seed low, seed high), and uses 3 of its 4 words, bit for bit the
// stream of ccka_tpu_torch/sim/random.py. The coordinates never include
// the policy or the population member, so runs on one seed are paired.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ccka {

constexpr int kParams = 22;
constexpr int kOutRows = 24;
constexpr float kEps = 1e-6f;
constexpr unsigned kWarp = 0xffffffffu;

// Packed scalar params: ccka_tpu_torch/sim/megakernel.py::_PARAM_NAMES.
enum {
  DT_S, PPN, BASE_OD, MAXN0, MAXN1, SA00, SA01, SA10, SA11, INTERRUPT_P,
  PDB, FRAG, UNDERUTIL, WATTS_IDLE, WATTS_FULL, RPS, SLO_FRAC, TAU_S,
  LAT_BASE, LAT_SLO, WL_INF_QMAX, WL_INF_SLO
};

// Latency-proxy curve (ccka_tpu_torch/config.py).
constexpr float kRhoClip = 0.98f;
constexpr float kCurveCoef = 3.0f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_uniform(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// a / b, correctly rounded, for b > 0 and a dividend that is often zero.
// The library division checks its operands' range (FCHK) and takes its
// slow path, a call of some hundred cycles, on a zero dividend, though
// the answer is exact: a zero dividend is answered apart (0 / b = a for
// b > 0, the sign kept) and the division is given 1 instead. The empty
// asm hides that substitute from the compiler, which would otherwise fold
// it back into a / b.
__device__ __forceinline__ float quot(float a, float b) {
  float d = a == 0.0f ? 1.0f : a;
  asm("" : "+f"(d));
  const float q = d / b;
  return a == 0.0f ? a : q;
}

// v[c] for a capacity type c known at run time (a select, not a local
// memory index).
__device__ __forceinline__ float at(const float (&v)[2], int c) {
  return c ? v[1] : v[0];
}

// The lanes that step one cluster (see the header comment). Every lane of
// the warp must reach each exchange: no lane may have returned.
template <int G>
struct Group {
  static_assert(G == 1 || G == 2, "a cluster has one lane, or a pair");
  int r;  // the lane's rank in its group (unused for G = 1)

  __device__ __forceinline__ int rank() const { return G == 1 ? 0 : r; }

  // Continues the chains acc[0..N) by the group's terms in the plain
  // version's order: part(acc) adds the calling lane's own terms (its
  // pools', in order) to acc. The lanes take their turns in rank order,
  // each continuing what its predecessor handed over by a shuffle, so
  // every lane ends with the chains' bits.
  template <int N, typename Part>
  __device__ __forceinline__ void chain(float (&acc)[N], Part part) const {
    if constexpr (G == 1) {
      part(acc);
    } else {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float mine[N];
#pragma unroll
        for (int n = 0; n < N; ++n) mine[n] = acc[n];
        part(mine);
#pragma unroll
        for (int n = 0; n < N; ++n)
          acc[n] = __shfl_sync(kWarp, mine[n], i, G);
      }
    }
  }

  // v[n][c] = the n-th output of f(c, out) for both capacity types c: in
  // a pair lane c computes type c and the two swap; one lane computes
  // both.
  template <int N, typename F>
  __device__ __forceinline__ void per_type(float (&v)[N][2], F f) const {
    float o[N];
    if constexpr (G == 1) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        f(c, o);
#pragma unroll
        for (int n = 0; n < N; ++n) v[n][c] = o[n];
      }
    } else {
      f(r, o);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float other = __shfl_xor_sync(kWarp, o[n], 1);
        v[n][0] = r ? other : o[n];
        v[n][1] = r ? o[n] : other;
      }
    }
  }
};

// The scalar params of a run and what the tick derives from them once;
// the per-pool ones (max_nodes, sa) of the lane's own pools.
template <int P, int Z, int G = 1>
struct Consts {
  static constexpr int PL = P / G;
  float dt_s, ppn, base_od, max_nodes[PL], sa[PL][2], p_int, pdb, frag,
      underutil, w_idle, rps, slo_frac, tau_s, lat_base, lat_slo, dt_hr,
      base_z, base_cap, one_m_pdb, one_p_frag, w_span, wl_qmax, wl_slo;

  __device__ __forceinline__ explicit Consts(const float* p, int rank = 0) {
    static_assert(P == 2, "the packed params carry two pools");
    const int pool0 = G == 1 ? 0 : rank * PL;
    dt_s = p[DT_S], ppn = p[PPN], base_od = p[BASE_OD];
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      max_nodes[j] = p[MAXN0 + pool0 + j];
      sa[j][0] = p[SA00 + 2 * (pool0 + j)];
      sa[j][1] = p[SA00 + 2 * (pool0 + j) + 1];
    }
    p_int = p[INTERRUPT_P], pdb = p[PDB];
    frag = p[FRAG], underutil = p[UNDERUTIL];
    w_idle = p[WATTS_IDLE];
    rps = p[RPS], slo_frac = p[SLO_FRAC];
    tau_s = p[TAU_S], lat_base = p[LAT_BASE], lat_slo = p[LAT_SLO];
    dt_hr = dt_s * (1.0f / 3600.0f);
    base_z = base_od * (1.0f / (float)Z);
    base_cap = base_od * ppn;
    one_m_pdb = 1.0f - pdb;
    one_p_frag = 1.0f + frag;
    w_span = p[WATTS_FULL] - w_idle;
    wl_qmax = p[WL_INF_QMAX], wl_slo = p[WL_INF_SLO];
  }
};

// One tick's signals of one cluster, read from the packed stream
// exo[t][row][b] (rows: spot[Z], od[Z], carbon[Z], demand[2], is_peak).
template <int Z>
struct TickExo {
  float spot[Z], od[Z], carb[Z], demand[2], is_peak;

  TickExo() = default;
  __device__ __forceinline__ TickExo(const float* __restrict__ x, int B) {
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      spot[z] = x[(size_t)z * B];
      od[z] = x[(size_t)(Z + z) * B];
      carb[z] = x[(size_t)(2 * Z + z) * B];
    }
    demand[0] = x[(size_t)(3 * Z) * B];
    demand[1] = x[(size_t)(3 * Z + 1) * B];
    is_peak = x[(size_t)(3 * Z + 2) * B];
  }
};

// One tick's lanes of one cluster: the fault block's rows from row fb
// (FAULTS), the workload block's from row wb (WL); an absent block reads
// as its neutral values.
template <int Z, bool FAULTS, bool WL>
struct TickLanes {
  float haz[Z], deny, delay, stale, inf, bat, bg;

  __device__ __forceinline__ TickLanes(const float* __restrict__ x, int B,
                                       int fb, int wb) {
#pragma unroll
    for (int z = 0; z < Z; ++z) haz[z] = FAULTS ? x[(size_t)(fb + z) * B] : 1.0f;
    deny = FAULTS ? x[(size_t)(fb + Z) * B] : 0.0f;
    delay = FAULTS ? x[(size_t)(fb + Z + 1) * B] : 0.0f;
    stale = FAULTS ? x[(size_t)(fb + Z + 2) * B] : 0.0f;
    inf = WL ? x[(size_t)wb * B] : 0.0f;
    bat = WL ? x[(size_t)(wb + 1) * B] : 0.0f;
    bg = WL ? x[(size_t)(wb + 2) * B] : 0.0f;
  }
};

// What a policy observes under a signal outage: while stale is set (after
// global tick 0) prices, carbon and demand are the held ones of the last
// tick before the outage; is_peak follows the clock. Updates the held rows
// (sim/rollout.py::observed_exo and its carry).
template <int Z>
__device__ __forceinline__ TickExo<Z> observed(const TickExo<Z>& e,
                                               TickExo<Z>& held, float stale,
                                               int t) {
  TickExo<Z> o = e;
  if (stale > 0.5f && t > 0) {
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      o.spot[z] = held.spot[z];
      o.od[z] = held.od[z];
      o.carb[z] = held.carb[z];
    }
    o.demand[0] = held.demand[0];
    o.demand[1] = held.demand[1];
  }
  held = o;
  return o;
}

// The workload families' queues of one cluster and their 5 accumulators
// (D = the batch deadline in ticks; 0 = no workload lanes).
template <int D>
struct Queues {
  float inf_q, batch[D > 0 ? D : 1], bg_q;
  float sums[5];  // inference violations, queue, shed; batch misses, backlog

  __device__ __forceinline__ Queues() {
    inf_q = bg_q = 0.0f;
#pragma unroll
    for (int i = 0; i < (D > 0 ? D : 1); ++i) batch[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 5; ++i) sums[i] = 0.0f;
  }
};

// The canonical action of one cluster for one tick, of the PL pools a
// lane holds (all P with one lane a cluster).
template <int PL, int Z>
struct TickAction {
  float zw[PL][Z], ct[PL][2], aggr[PL], after[PL], hpa[2];
};

// A cluster's state and its episode accumulators, all in registers: the
// lane's own pools' nodes, pipeline and timers, and the shared rest.
template <int P, int Z, int K, int G = 1>
struct Fleet {
  static constexpr int PL = P / G;
  Group<G> grp;
  float nodes[PL][Z][2], pipe[K][PL][Z][2], running[2], timer[PL];
  float acc_cost, acc_carbon, acc_req, acc_slo, acc_evict, nct_sum[2],
      served_sum, capacity_sum, waste_sum, lat_sum, lat_max, queue_sum,
      int_sum, denied_sum, stale_sum;

  __device__ __forceinline__ explicit Fleet(int rank = 0) {
    grp.r = rank;
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      timer[j] = 0.0f;
#pragma unroll
      for (int z = 0; z < Z; ++z)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          nodes[j][z][c] = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) pipe[k][j][z][c] = 0.0f;
        }
    }
    running[0] = running[1] = 0.0f;
    acc_cost = acc_carbon = acc_req = acc_slo = acc_evict = 0.0f;
    nct_sum[0] = nct_sum[1] = 0.0f;
    served_sum = capacity_sum = waste_sum = lat_sum = lat_max = 0.0f;
    queue_sum = int_sum = denied_sum = stale_sum = 0.0f;
  }

  // Capacity in flight of each type c: the chains over (k, p, z) that
  // both the tick's provisioning need and the policy observation use.
  __device__ __forceinline__ void incoming(float (&inc)[2]) const {
    inc[0] = inc[1] = -0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      grp.chain(inc, [&](float (&a)[2]) {
#pragma unroll
        for (int j = 0; j < PL; ++j)
#pragma unroll
          for (int z = 0; z < Z; ++z)
#pragma unroll
            for (int c = 0; c < 2; ++c) a[c] = a[c] + pipe[k][j][z][c];
      });
  }

  // The [24, B] output block's column b: 16 accumulators, the 5 of the
  // workload queues (``wl``, zero without them), rows 21..23 zero.
  __device__ __forceinline__ void store(float* __restrict__ out, int B,
                                        int b, const float (&wl)[5]) const {
    const float vals[21] = {
        acc_cost,  acc_carbon, acc_req,    acc_slo, acc_evict,
        nct_sum[0], nct_sum[1], served_sum, capacity_sum, waste_sum,
        lat_sum,   lat_max,    queue_sum,  int_sum,  denied_sum,
        stale_sum, wl[0],      wl[1],      wl[2],    wl[3],
        wl[4]};
#pragma unroll
    for (int r = 0; r < kOutRows; ++r)
      out[(size_t)r * B + b] = r < 21 ? vals[r] : 0.0f;
  }
};

// A CARRY launch: one time block of a longer rollout. A cluster loads its
// state from in[row][b] at the block's first tick and stores it to
// out[row][b] after its last (rows: CarryRows; a population member m's
// state starts m * rows rows further). t0 is the global tick of the
// block's first row, b0 the global index of the launch's cluster 0: the
// Philox counter and the clocks take (b0 + b, t0 + t).
struct Carry {
  const float* in;
  float* out;
  int rows, t0, b0;
};

// Rows of the carried state [rows][B], batch innermost
// (ccka_tpu_torch/sim/rollout.py::CarryLayout): the 16 accumulators and
// the 5 workload sums in the output block's order, nodes[P][Z][2],
// pipe[K][P][Z][2], running[2], timer[P], then the held observation
// (spot[Z], od[Z], carbon[Z], demand[2], is_peak) when HELD (a policy
// that observes signals, under fault lanes) and the workload queues
// (inference, batch[D], background) when WL_D > 0.
template <int P, int Z, int K, bool HELD, int WL_D>
struct CarryRows {
  static constexpr int nodes = 21;
  static constexpr int pipe = nodes + 2 * P * Z;
  static constexpr int running = pipe + 2 * K * P * Z;
  static constexpr int timer = running + 2;
  static constexpr int held = timer + P;
  static constexpr int queues = held + (HELD ? 3 * Z + 3 : 0);
  static constexpr int used = queues + (WL_D > 0 ? WL_D + 2 : 0);
};

// f(row, value, shared) on every register of the carried state a lane
// holds, in CarryRows' order: its own pools' rows (shared false), then or
// between them the rows every lane of the group holds (shared true).
// Loads with f = read, stores with f = write.
template <int P, int Z, int K, bool HELD, int WL_D, int G, typename F>
__device__ __forceinline__ void carry_fields(Fleet<P, Z, K, G>& s,
                                             Queues<WL_D>& q,
                                             TickExo<Z>& held, F f) {
  using R = CarryRows<P, Z, K, HELD, WL_D>;
  constexpr int PL = P / G;
  const int pool0 = s.grp.rank() * PL;
  f(0, s.acc_cost, true);
  f(1, s.acc_carbon, true);
  f(2, s.acc_req, true);
  f(3, s.acc_slo, true);
  f(4, s.acc_evict, true);
  f(5, s.nct_sum[0], true);
  f(6, s.nct_sum[1], true);
  f(7, s.served_sum, true);
  f(8, s.capacity_sum, true);
  f(9, s.waste_sum, true);
  f(10, s.lat_sum, true);
  f(11, s.lat_max, true);
  f(12, s.queue_sum, true);
  f(13, s.int_sum, true);
  f(14, s.denied_sum, true);
  f(15, s.stale_sum, true);
#pragma unroll
  for (int i = 0; i < 5; ++i) f(16 + i, q.sums[i], true);
#pragma unroll
  for (int j = 0; j < PL; ++j)
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int p = pool0 + j;
        f(R::nodes + (p * Z + z) * 2 + c, s.nodes[j][z][c], false);
#pragma unroll
        for (int k = 0; k < K; ++k)
          f(R::pipe + ((k * P + p) * Z + z) * 2 + c, s.pipe[k][j][z][c],
            false);
      }
  f(R::running, s.running[0], true);
  f(R::running + 1, s.running[1], true);
#pragma unroll
  for (int j = 0; j < PL; ++j) f(R::timer + pool0 + j, s.timer[j], false);
  if constexpr (HELD) {
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      f(R::held + z, held.spot[z], true);
      f(R::held + Z + z, held.od[z], true);
      f(R::held + 2 * Z + z, held.carb[z], true);
    }
    f(R::held + 3 * Z, held.demand[0], true);
    f(R::held + 3 * Z + 1, held.demand[1], true);
    f(R::held + 3 * Z + 2, held.is_peak, true);
  }
  if constexpr (WL_D > 0) {
    f(R::queues, q.inf_q, true);
#pragma unroll
    for (int i = 0; i < WL_D; ++i) f(R::queues + 1 + i, q.batch[i], true);
    f(R::queues + WL_D + 1, q.bg_q, true);
  }
}

template <int P, int Z, int K, bool HELD, int WL_D, int G>
__device__ __forceinline__ void load_carry(const float* __restrict__ in,
                                           int B, int b,
                                           Fleet<P, Z, K, G>& s,
                                           Queues<WL_D>& q,
                                           TickExo<Z>& held) {
  carry_fields<P, Z, K, HELD, WL_D>(
      s, q, held,
      [&](int r, float& v, bool) { v = in[(size_t)r * B + b]; });
}

// Each lane stores its own pools' rows; the first lane of the group
// alone stores the shared ones.
template <int P, int Z, int K, bool HELD, int WL_D, int G>
__device__ __forceinline__ void store_carry(float* __restrict__ out, int B,
                                            int b, Fleet<P, Z, K, G>& s,
                                            Queues<WL_D>& q,
                                            TickExo<Z>& held) {
  const bool first = s.grp.rank() == 0;
  carry_fields<P, Z, K, HELD, WL_D>(
      s, q, held, [&](int r, float& v, bool shared) {
        if (first || !shared) out[(size_t)r * B + b] = v;
      });
}

// Rows a CARRY instantiation uses, for the host's checks.
inline int carry_rows_used(int P, int Z, int K, bool held, int wl_depth) {
  return 21 + 2 * P * Z + 2 * K * P * Z + 2 + P + (held ? 3 * Z + 3 : 0) +
         (wl_depth > 0 ? wl_depth + 2 : 0);
}

// Advance cluster b by global tick t under action a (of the lane's
// pools), on the tick's true signals e and lanes l.
template <int P, int Z, int K, bool STOCH, bool FAULTS, int WL_D, int G>
__device__ __forceinline__ void tick(const Consts<P, Z, G>& k,
                                     Fleet<P, Z, K, G>& s, Queues<WL_D>& q,
                                     const TickAction<P / G, Z>& a,
                                     const TickExo<Z>& e,
                                     const TickLanes<Z, FAULTS, (WL_D > 0)>& l,
                                     int b, int t, uint32_t k0, uint32_t k1) {
  constexpr int PL = P / G;
  const Group<G>& grp = s.grp;
  const int pool0 = grp.rank() * PL;
  const float ppn = k.ppn, dt_s = k.dt_s;
  float (&nodes)[PL][Z][2] = s.nodes;
  float (&pipe)[K][PL][Z][2] = s.pipe;
  float (&running)[2] = s.running;
  const float (&spot)[Z] = e.spot;
  const float (&od)[Z] = e.od;
  const float (&demand)[2] = e.demand;

  // 1. desired pods (HPA lever).
  float desired[2];
  desired[0] = demand[0] * a.hpa[0];
  desired[1] = demand[1] * a.hpa[1];

  // 2. pipeline arrivals and shift; a fault holds a delay share of the
  // arrivals back at the shifted pipeline's head.
#pragma unroll
  for (int j = 0; j < PL; ++j)
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float arr = pipe[0][j][z][c];
        const float held = FAULTS ? arr * l.delay : 0.0f;
        nodes[j][z][c] = FAULTS ? nodes[j][z][c] + (arr - held)
                                : nodes[j][z][c] + arr;
#pragma unroll
        for (int i = 0; i + 1 < K; ++i) pipe[i][j][z][c] = pipe[i + 1][j][z][c];
        pipe[K - 1][j][z][c] = 0.0f;
        if (FAULTS) pipe[0][j][z][c] = pipe[0][j][z][c] + held;
      }

  // 3. spot interruptions, the lane's spot rows p*Z+z.
  float intr[PL][Z];
#pragma unroll
  for (int j = 0; j < PL; ++j)
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      const float spot_n = nodes[j][z][0];
      const float lam =
          spot_n * (FAULTS ? fminf(k.p_int * l.haz[z], 1.0f) : k.p_int);
      float x = lam;
      if (STOCH) {
        const uint4 w = philox4x32_10(
            make_uint4((uint32_t)b, (uint32_t)t,
                       (uint32_t)((pool0 + j) * Z + z), 0u),
            k0, k1);
        const float u = to_uniform(w.x);
        float tt = expf(-lam), cdf = tt, count = 0.0f;
#pragma unroll
        for (int i = 1; i <= 4; ++i) {
          count = count + (u > cdf ? 1.0f : 0.0f);
          tt = tt * lam * (1.0f / (float)i);
          cdf = cdf + tt;
        }
        const float u1 = fmaxf(to_uniform(w.y), 1e-7f);
        const float u2 = to_uniform(w.z);
        const float normal =
            sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958647692f * u2);
        const float gauss = rintf(lam + sqrtf(lam) * normal);
        const float sample = lam < 0.5f ? count : fmaxf(gauss, 0.0f);
        x = fminf(sample, spot_n);
      }
      nodes[j][z][0] = spot_n - x;
      intr[j][z] = x;
    }
  float interrupted[1] = {-0.0f};
  grp.chain(interrupted, [&](float (&acc)[1]) {
#pragma unroll
    for (int j = 0; j < PL; ++j)
#pragma unroll
      for (int z = 0; z < Z; ++z) acc[0] = acc[0] + intr[j][z];
  });

  // 4. scheduling (class c <-> capacity type c).
  float nodes_ct[2] = {-0.0f, -0.0f};
  grp.chain(nodes_ct, [&](float (&acc)[2]) {
#pragma unroll
    for (int j = 0; j < PL; ++j)
#pragma unroll
      for (int z = 0; z < Z; ++z)
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[c] = acc[c] + nodes[j][z][c];
  });
  const float cap_ct[2] = {nodes_ct[0] * ppn, nodes_ct[1] * ppn + k.base_cap};
  float pending[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    running[c] = fminf(desired[c], cap_ct[c]);
    pending[c] = desired[c] - running[c];
  }

  // 5. provisioning: need, cheapest-fit softmax split, per-pool cap.
  float inc[2];
  s.incoming(inc);
  float need[2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
    need[c] = fmaxf(quot(pending[c], ppn) - inc[c], 0.0f);
  float price_sum = spot[0];
  price_sum = price_sum + od[0];
#pragma unroll
  for (int z = 1; z < Z; ++z) {
    price_sum = price_sum + spot[z];
    price_sum = price_sum + od[z];
  }
  const float tau = 0.1f * (price_sum * (1.0f / (float)(2 * Z))) + kEps;
  float cheap[Z][2];
  grp.per_type(cheap, [&](int c, float (&out)[Z]) {
    float xz[Z];
#pragma unroll
    for (int z = 0; z < Z; ++z) xz[z] = -(c == 0 ? spot[z] : od[z]) / tau;
    float m = xz[0];
#pragma unroll
    for (int z = 1; z < Z; ++z) m = fmaxf(m, xz[z]);
    float ex[Z];
#pragma unroll
    for (int z = 0; z < Z; ++z) ex[z] = expf(xz[z] - m);
    float sum = ex[0];
#pragma unroll
    for (int z = 1; z < Z; ++z) sum = sum + ex[z];
#pragma unroll
    for (int z = 0; z < Z; ++z) out[z] = ex[z] / sum;
  });
  float newn[PL][Z][2];
#pragma unroll
  for (int j = 0; j < PL; ++j)
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float allow = a.ct[j][c] * k.sa[j][c];
        newn[j][z][c] = a.zw[j][z] * allow * cheap[z][c];
      }
  float wsum[2] = {-0.0f, -0.0f};
  grp.chain(wsum, [&](float (&acc)[2]) {
#pragma unroll
    for (int j = 0; j < PL; ++j)
#pragma unroll
      for (int z = 0; z < Z; ++z)
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[c] = acc[c] + newn[j][z][c];
  });
#pragma unroll
  for (int j = 0; j < PL; ++j)
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float frac =
            wsum[c] > kEps ? quot(newn[j][z][c], wsum[c] + kEps) : 0.0f;
        newn[j][z][c] = frac * need[c];
      }
  float spot_req[PL][Z];  // the spot request before denial (FAULTS)
  const float one_m_deny = 1.0f - l.deny;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    float now_n = nodes[j][0][0];
    now_n = now_n + nodes[j][0][1];
#pragma unroll
    for (int z = 1; z < Z; ++z) {
      now_n = now_n + nodes[j][z][0];
      now_n = now_n + nodes[j][z][1];
    }
    float now_p = pipe[0][j][0][0];
    now_p = now_p + pipe[0][j][0][1];
#pragma unroll
    for (int i = 1; i < K * Z; ++i) {
      now_p = now_p + pipe[i / Z][j][i % Z][0];
      now_p = now_p + pipe[i / Z][j][i % Z][1];
    }
    const float pool_now = now_n + now_p;
    float pool_new = newn[j][0][0];
    pool_new = pool_new + newn[j][0][1];
#pragma unroll
    for (int z = 1; z < Z; ++z) {
      pool_new = pool_new + newn[j][z][0];
      pool_new = pool_new + newn[j][z][1];
    }
    const float headroom = fmaxf(k.max_nodes[j] - pool_now, 0.0f);
    const float scale =
        pool_new > kEps ? fminf(quot(headroom, pool_new + kEps), 1.0f) : 1.0f;
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float req = newn[j][z][c] * scale;
        if (!FAULTS) {
          pipe[K - 1][j][z][c] = req;
        } else if (c == 0) {  // the spot share is denied, and counted
          spot_req[j][z] = req;
          pipe[K - 1][j][z][c] = pipe[K - 1][j][z][c] + req * one_m_deny;
        } else {
          pipe[K - 1][j][z][c] = pipe[K - 1][j][z][c] + req;
        }
      }
  }

  // 6. consolidation.
  const float used_karp[2] = {running[0],
                              fmaxf(running[1] - k.base_cap, 0.0f)};
  float cons[2][2];  // [empty, aggr_ct][c]
  grp.per_type(cons, [&](int c, float (&out)[2]) {
    const float used = at(used_karp, c), nct = at(nodes_ct, c);
    const float repack = quot(used, ppn);
    const float slack = fmaxf(nct - repack, 0.0f);
    const float empty = fmaxf(nct - repack * k.one_p_frag, 0.0f);
    const float util = quot(used, nct * ppn + kEps);
    const float under = sigmoid((k.underutil - util) * (1.0f / 0.05f));
    const float budget = k.one_m_pdb * used;
    out[0] = empty;
    out[1] = fminf(slack, empty + quot(under * budget, ppn));
  });
  const float (&empty)[2] = cons[0];
  const float (&aggr_ct)[2] = cons[1];
  float removed[PL][Z][2];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const float aggr = a.aggr[j];
    const float after = a.after[j];
    float rem[Z][2];
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float share = quot(nodes[j][z][c], nodes_ct[c] + kEps);
        rem[z][c] = share * (empty[c] * (1.0f - aggr) + aggr_ct[c] * aggr);
      }
    float rem_p = rem[0][0];
    rem_p = rem_p + rem[0][1];
#pragma unroll
    for (int z = 1; z < Z; ++z) {
      rem_p = rem_p + rem[z][0];
      rem_p = rem_p + rem[z][1];
    }
    const float tmr = rem_p > 1e-3f ? s.timer[j] + dt_s : 0.0f;
    const float gate = sigmoid((tmr - after) / k.tau_s);
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        removed[j][z][c] = rem[z][c] * gate;
        nodes[j][z][c] = fmaxf(nodes[j][z][c] - removed[j][z][c], 0.0f);
      }
    s.timer[j] = gate > 0.5f ? 0.0f : tmr;
  }
  float removed_ct[2] = {-0.0f, -0.0f};
  grp.chain(removed_ct, [&](float (&acc)[2]) {
#pragma unroll
    for (int j = 0; j < PL; ++j)
#pragma unroll
      for (int z = 0; z < Z; ++z)
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[c] = acc[c] + removed[j][z][c];
  });
  const float evicted =
      (fmaxf(removed_ct[0] - empty[0], 0.0f) +
       fmaxf(removed_ct[1] - empty[1], 0.0f)) * ppn * 0.5f;

  // 7. accounting on the post-step fleet.
  float nz[2 * Z];  // the pool sums, (z, c) at 2z + c
#pragma unroll
  for (int i = 0; i < 2 * Z; ++i) nz[i] = -0.0f;
  grp.chain(nz, [&](float (&acc)[2 * Z]) {
#pragma unroll
    for (int j = 0; j < PL; ++j)
#pragma unroll
      for (int i = 0; i < 2 * Z; ++i)
        acc[i] = acc[i] + nodes[j][i / 2][i % 2];
  });
  float nzc[Z][2];
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    nzc[z][0] = nz[2 * z];
    nzc[z][1] = nz[2 * z + 1] + k.base_z;
  }
  float cost = nzc[0][0] * spot[0];
  cost = cost + nzc[0][1] * od[0];
#pragma unroll
  for (int z = 1; z < Z; ++z) {
    cost = cost + nzc[z][0] * spot[z];
    cost = cost + nzc[z][1] * od[z];
  }
  cost = cost * k.dt_hr;
  float watts[1][2];
  grp.per_type(watts, [&](int c, float (&out)[1]) {
    float tot = at(nzc[0], c);
#pragma unroll
    for (int z = 1; z < Z; ++z) tot = tot + at(nzc[z], c);
    const float util =
        tot > kEps ? fminf(quot(at(running, c), tot * ppn + kEps), 1.0f)
                   : 0.0f;
    out[0] = k.w_idle + k.w_span * util;
  });
  float carbon = 0.0f;
#pragma unroll
  for (int z = 0; z < Z; ++z)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float kwh = nzc[z][c] * watts[0][c] * (1.0f / 1000.0f) * k.dt_hr;
      const float g = kwh * e.carb[z];
      carbon = (z == 0 && c == 0) ? g : carbon + g;
    }
  const float requests =
      (fminf(running[0], demand[0]) + fminf(running[1], demand[1])) * k.rps *
      dt_s;
  const float load =
      (demand[0] + demand[1]) / ((cap_ct[0] + cap_ct[1]) + kEps);
  const float rho = fminf(fmaxf(load, 0.0f), kRhoClip);
  const float lat =
      k.lat_base * (1.0f + kCurveCoef * rho * rho / (1.0f - rho));
  const float queue = pending[0] + pending[1];
  const bool met = running[0] >= k.slo_frac * demand[0] - kEps &&
                   running[1] >= k.slo_frac * demand[1] - kEps;
  const float lat_ok =
      k.lat_slo > 0.0f ? (lat <= k.lat_slo ? 1.0f : 0.0f) : 1.0f;
  const float slo_ok = (met ? 1.0f : 0.0f) * lat_ok;

  // 7b. workload families, from the post-step fleet's headroom.
  if constexpr (WL_D > 0) {
    float cap_total = nzc[0][0];
    cap_total = cap_total + nzc[0][1];
#pragma unroll
    for (int z = 1; z < Z; ++z) {
      cap_total = cap_total + nzc[z][0];
      cap_total = cap_total + nzc[z][1];
    }
    const float headroom =
        fmaxf(cap_total * ppn - (running[0] + running[1]), 0.0f);
    const float inf_in = q.inf_q + l.inf;
    const float inf_served = fminf(inf_in, headroom);
    const float inf_after = inf_in - inf_served;
    const float inf_dropped = fmaxf(inf_after - k.wl_qmax, 0.0f);
    q.inf_q = inf_after - inf_dropped;
    float rem = headroom - inf_served;
    const float inf_rho =
        fminf(fmaxf(quot(inf_in, headroom + kEps), 0.0f), kRhoClip);
    const float inf_lat =
        k.lat_base *
        (1.0f + quot(kCurveCoef * inf_rho * inf_rho, 1.0f - inf_rho));
    const float inf_viol =
        fmaxf(inf_lat > k.wl_slo ? 1.0f : 0.0f, inf_dropped > 0.0f ? 1.0f : 0.0f);
    // Batch: the pool's slot i is work that has waited i ticks (slot 0
    // arrives now); served oldest first; what reaches slot D-1 unserved
    // is a deadline miss.
    float missed = 0.0f;
#pragma unroll
    for (int i = WL_D - 1; i >= 0; --i) {
      const float pool = i == 0 ? l.bat : q.batch[i - 1];
      const float take = fminf(pool, rem);
      rem = rem - take;
      if (i == WL_D - 1)
        missed = pool - take;
      else
        q.batch[i] = pool - take;
    }
    q.batch[WL_D - 1] = 0.0f;
    float backlog = q.batch[0];
#pragma unroll
    for (int i = 1; i < WL_D; ++i) backlog = backlog + q.batch[i];
    const float bg_in = q.bg_q + l.bg;
    q.bg_q = bg_in - fminf(bg_in, rem);
    q.sums[0] = q.sums[0] + inf_viol;
    q.sums[1] = q.sums[1] + q.inf_q;
    q.sums[2] = q.sums[2] + inf_dropped;
    q.sums[3] = q.sums[3] + missed;
    q.sums[4] = q.sums[4] + backlog;
  }

  // 8. accumulators: episode totals, then SummaryAcc.update.
  s.acc_cost = s.acc_cost + cost;
  s.acc_carbon = s.acc_carbon + carbon;
  s.acc_req = s.acc_req + requests;
  s.acc_slo = s.acc_slo + slo_ok * dt_s;
  s.acc_evict = s.acc_evict + evicted;
  float nbc[2] = {-0.0f, -0.0f};
  grp.chain(nbc, [&](float (&acc)[2]) {
#pragma unroll
    for (int j = 0; j < PL; ++j)
#pragma unroll
      for (int z = 0; z < Z; ++z)
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[c] = acc[c] + nodes[j][z][c];
  });
#pragma unroll
  for (int c = 0; c < 2; ++c) s.nct_sum[c] = s.nct_sum[c] + nbc[c];
  const float capacity = ((nbc[0] + nbc[1]) + k.base_od) * ppn;
  const float served = running[0] + running[1];
  s.served_sum = s.served_sum + served;
  s.capacity_sum = s.capacity_sum + capacity;
  s.waste_sum = s.waste_sum + fmaxf(capacity - served, 0.0f);
  s.lat_sum = s.lat_sum + lat;
  s.lat_max = fmaxf(s.lat_max, lat);
  s.queue_sum = s.queue_sum + queue;
  s.int_sum = s.int_sum + interrupted[0];
  if constexpr (FAULTS) {
    float denied_req[1] = {-0.0f};
    grp.chain(denied_req, [&](float (&acc)[1]) {
#pragma unroll
      for (int j = 0; j < PL; ++j)
#pragma unroll
        for (int z = 0; z < Z; ++z) acc[0] = acc[0] + spot_req[j][z];
    });
    s.denied_sum = s.denied_sum + denied_req[0] * l.deny;
    s.stale_sum = s.stale_sum + l.stale;
  }
}

}  // namespace ccka
