// One control tick of one cluster, shared by the rollout kernels.
//
// rollout_profiles.cu (rule profiles, carbon re-rank) and rollout_mlp.cu
// (learned policy) differ only in how a thread picks its action; what the
// action then does to the fleet is this header: tick() advances a Fleet
// held in the calling thread's registers by one 30 s step and folds the
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
// zone and capacity-type axes are the same left-to-right chains; a
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

// The scalar params of a run and what the tick derives from them once.
template <int P, int Z>
struct Consts {
  float dt_s, ppn, base_od, max_nodes[P], sa[P][2], p_int, pdb, frag,
      underutil, w_idle, rps, slo_frac, tau_s, lat_base, lat_slo, dt_hr,
      base_z, base_cap, one_m_pdb, one_p_frag, w_span, wl_qmax, wl_slo;

  __device__ __forceinline__ explicit Consts(const float* p) {
    static_assert(P == 2, "the packed params carry two pools");
    dt_s = p[DT_S], ppn = p[PPN], base_od = p[BASE_OD];
    max_nodes[0] = p[MAXN0], max_nodes[1] = p[MAXN1];
    sa[0][0] = p[SA00], sa[0][1] = p[SA01];
    sa[1][0] = p[SA10], sa[1][1] = p[SA11];
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
// tick 0) prices, carbon and demand are the held ones of the last tick
// before the outage; is_peak follows the clock. Updates the held rows
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

// The canonical action of one cluster for one tick.
template <int P, int Z>
struct TickAction {
  float zw[P][Z], ct[P][2], aggr[P], after[P], hpa[2];
};

// A cluster's state and its episode accumulators, all in registers.
template <int P, int Z, int K>
struct Fleet {
  float nodes[P][Z][2], pipe[K][P][Z][2], running[2], timer[P];
  float acc_cost, acc_carbon, acc_req, acc_slo, acc_evict, nct_sum[2],
      served_sum, capacity_sum, waste_sum, lat_sum, lat_max, queue_sum,
      int_sum, denied_sum, stale_sum;

  __device__ __forceinline__ Fleet() {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      timer[p] = 0.0f;
#pragma unroll
      for (int z = 0; z < Z; ++z)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          nodes[p][z][c] = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) pipe[k][p][z][c] = 0.0f;
        }
    }
    running[0] = running[1] = 0.0f;
    acc_cost = acc_carbon = acc_req = acc_slo = acc_evict = 0.0f;
    nct_sum[0] = nct_sum[1] = 0.0f;
    served_sum = capacity_sum = waste_sum = lat_sum = lat_max = 0.0f;
    queue_sum = int_sum = denied_sum = stale_sum = 0.0f;
  }

  // Capacity in flight of type c: the chain over (k, p, z) that both the
  // tick's provisioning need and the policy observation use.
  __device__ __forceinline__ float incoming(int c) const {
    float inc = pipe[0][0][0][c];
#pragma unroll
    for (int i = 1; i < K * P * Z; ++i)
      inc = inc + pipe[i / (P * Z)][(i / Z) % P][i % Z][c];
    return inc;
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

// Advance cluster b by global tick t under action a, on the tick's true
// signals e and lanes l.
template <int P, int Z, int K, bool STOCH, bool FAULTS, int WL_D>
__device__ __forceinline__ void tick(const Consts<P, Z>& k, Fleet<P, Z, K>& s,
                                     Queues<WL_D>& q,
                                     const TickAction<P, Z>& a,
                                     const TickExo<Z>& e,
                                     const TickLanes<Z, FAULTS, (WL_D > 0)>& l,
                                     int b, int t, uint32_t k0, uint32_t k1) {
  const float ppn = k.ppn, dt_s = k.dt_s;
  float (&nodes)[P][Z][2] = s.nodes;
  float (&pipe)[K][P][Z][2] = s.pipe;
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
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float arr = pipe[0][p][z][c];
        const float held = FAULTS ? arr * l.delay : 0.0f;
        nodes[p][z][c] = FAULTS ? nodes[p][z][c] + (arr - held)
                                : nodes[p][z][c] + arr;
#pragma unroll
        for (int i = 0; i + 1 < K; ++i) pipe[i][p][z][c] = pipe[i + 1][p][z][c];
        pipe[K - 1][p][z][c] = 0.0f;
        if (FAULTS) pipe[0][p][z][c] = pipe[0][p][z][c] + held;
      }

  // 3. spot interruptions.
  float interrupted_total = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      const float spot_n = nodes[p][z][0];
      const float lam =
          spot_n * (FAULTS ? fminf(k.p_int * l.haz[z], 1.0f) : k.p_int);
      float intr = lam;
      if (STOCH) {
        const uint4 w = philox4x32_10(
            make_uint4((uint32_t)b, (uint32_t)t, (uint32_t)(p * Z + z), 0u),
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
        intr = fminf(sample, spot_n);
      }
      nodes[p][z][0] = spot_n - intr;
      interrupted_total = (p == 0 && z == 0) ? intr : interrupted_total + intr;
    }

  // 4. scheduling (class c <-> capacity type c).
  float nodes_ct[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float sum = nodes[0][0][c];
#pragma unroll
    for (int i = 1; i < P * Z; ++i) sum = sum + nodes[i / Z][i % Z][c];
    nodes_ct[c] = sum;
  }
  const float cap_ct[2] = {nodes_ct[0] * ppn, nodes_ct[1] * ppn + k.base_cap};
  float pending[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    running[c] = fminf(desired[c], cap_ct[c]);
    pending[c] = desired[c] - running[c];
  }

  // 5. provisioning: need, cheapest-fit softmax split, per-pool cap.
  float need[2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
    need[c] = fmaxf(pending[c] / ppn - s.incoming(c), 0.0f);
  float price_sum = spot[0];
  price_sum = price_sum + od[0];
#pragma unroll
  for (int z = 1; z < Z; ++z) {
    price_sum = price_sum + spot[z];
    price_sum = price_sum + od[z];
  }
  const float tau = 0.1f * (price_sum * (1.0f / (float)(2 * Z))) + kEps;
  float cheap[Z][2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
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
    for (int z = 0; z < Z; ++z) cheap[z][c] = ex[z] / sum;
  }
  float newn[P][Z][2];
  float wsum[2];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float allow = a.ct[p][c] * k.sa[p][c];
        newn[p][z][c] = a.zw[p][z] * allow * cheap[z][c];
      }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float sum = newn[0][0][c];
#pragma unroll
    for (int i = 1; i < P * Z; ++i) sum = sum + newn[i / Z][i % Z][c];
    wsum[c] = sum;
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float frac =
            wsum[c] > kEps ? newn[p][z][c] / (wsum[c] + kEps) : 0.0f;
        newn[p][z][c] = frac * need[c];
      }
  float spot_req = 0.0f;  // the spot request before denial (FAULTS)
  const float one_m_deny = 1.0f - l.deny;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float now_n = nodes[p][0][0];
    now_n = now_n + nodes[p][0][1];
#pragma unroll
    for (int z = 1; z < Z; ++z) {
      now_n = now_n + nodes[p][z][0];
      now_n = now_n + nodes[p][z][1];
    }
    float now_p = pipe[0][p][0][0];
    now_p = now_p + pipe[0][p][0][1];
#pragma unroll
    for (int i = 1; i < K * Z; ++i) {
      now_p = now_p + pipe[i / Z][p][i % Z][0];
      now_p = now_p + pipe[i / Z][p][i % Z][1];
    }
    const float pool_now = now_n + now_p;
    float pool_new = newn[p][0][0];
    pool_new = pool_new + newn[p][0][1];
#pragma unroll
    for (int z = 1; z < Z; ++z) {
      pool_new = pool_new + newn[p][z][0];
      pool_new = pool_new + newn[p][z][1];
    }
    const float headroom = fmaxf(k.max_nodes[p] - pool_now, 0.0f);
    const float scale =
        pool_new > kEps ? fminf(headroom / (pool_new + kEps), 1.0f) : 1.0f;
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float req = newn[p][z][c] * scale;
        if (!FAULTS) {
          pipe[K - 1][p][z][c] = req;
        } else if (c == 0) {  // the spot share is denied, and counted
          spot_req = (p == 0 && z == 0) ? req : spot_req + req;
          pipe[K - 1][p][z][c] = pipe[K - 1][p][z][c] + req * one_m_deny;
        } else {
          pipe[K - 1][p][z][c] = pipe[K - 1][p][z][c] + req;
        }
      }
  }

  // 6. consolidation.
  const float used_karp[2] = {running[0],
                              fmaxf(running[1] - k.base_cap, 0.0f)};
  float empty[2], aggr_ct[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float repack = used_karp[c] / ppn;
    const float slack = fmaxf(nodes_ct[c] - repack, 0.0f);
    empty[c] = fmaxf(nodes_ct[c] - repack * k.one_p_frag, 0.0f);
    const float util = used_karp[c] / (nodes_ct[c] * ppn + kEps);
    const float under = sigmoid((k.underutil - util) * (1.0f / 0.05f));
    const float budget = k.one_m_pdb * used_karp[c];
    aggr_ct[c] = fminf(slack, empty[c] + under * budget / ppn);
  }
  float removed_ct[2];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float aggr = a.aggr[p];
    const float after = a.after[p];
    float rem[Z][2];
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float share = nodes[p][z][c] / (nodes_ct[c] + kEps);
        rem[z][c] = share * (empty[c] * (1.0f - aggr) + aggr_ct[c] * aggr);
      }
    float rem_p = rem[0][0];
    rem_p = rem_p + rem[0][1];
#pragma unroll
    for (int z = 1; z < Z; ++z) {
      rem_p = rem_p + rem[z][0];
      rem_p = rem_p + rem[z][1];
    }
    const float tmr = rem_p > 1e-3f ? s.timer[p] + dt_s : 0.0f;
    const float gate = sigmoid((tmr - after) / k.tau_s);
#pragma unroll
    for (int z = 0; z < Z; ++z)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float removed = rem[z][c] * gate;
        nodes[p][z][c] = fmaxf(nodes[p][z][c] - removed, 0.0f);
        removed_ct[c] = (p == 0 && z == 0) ? removed : removed_ct[c] + removed;
      }
    s.timer[p] = gate > 0.5f ? 0.0f : tmr;
  }
  const float evicted =
      (fmaxf(removed_ct[0] - empty[0], 0.0f) +
       fmaxf(removed_ct[1] - empty[1], 0.0f)) * ppn * 0.5f;

  // 7. accounting on the post-step fleet.
  float nzc[Z][2];
#pragma unroll
  for (int z = 0; z < Z; ++z)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float sum = nodes[0][z][c];
#pragma unroll
      for (int p = 1; p < P; ++p) sum = sum + nodes[p][z][c];
      nzc[z][c] = c == 1 ? sum + k.base_z : sum;
    }
  float cost = nzc[0][0] * spot[0];
  cost = cost + nzc[0][1] * od[0];
#pragma unroll
  for (int z = 1; z < Z; ++z) {
    cost = cost + nzc[z][0] * spot[z];
    cost = cost + nzc[z][1] * od[z];
  }
  cost = cost * k.dt_hr;
  float watts[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float tot = nzc[0][c];
#pragma unroll
    for (int z = 1; z < Z; ++z) tot = tot + nzc[z][c];
    const float util =
        tot > kEps ? fminf(running[c] / (tot * ppn + kEps), 1.0f) : 0.0f;
    watts[c] = k.w_idle + k.w_span * util;
  }
  float carbon = 0.0f;
#pragma unroll
  for (int z = 0; z < Z; ++z)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float kwh = nzc[z][c] * watts[c] * (1.0f / 1000.0f) * k.dt_hr;
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
        fminf(fmaxf(inf_in / (headroom + kEps), 0.0f), kRhoClip);
    const float inf_lat =
        k.lat_base *
        (1.0f + kCurveCoef * inf_rho * inf_rho / (1.0f - inf_rho));
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
  float nbc[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float sum = nodes[0][0][c];
#pragma unroll
    for (int i = 1; i < P * Z; ++i) sum = sum + nodes[i / Z][i % Z][c];
    nbc[c] = sum;
    s.nct_sum[c] = s.nct_sum[c] + sum;
  }
  const float capacity = ((nbc[0] + nbc[1]) + k.base_od) * ppn;
  const float served = running[0] + running[1];
  s.served_sum = s.served_sum + served;
  s.capacity_sum = s.capacity_sum + capacity;
  s.waste_sum = s.waste_sum + fmaxf(capacity - served, 0.0f);
  s.lat_sum = s.lat_sum + lat;
  s.lat_max = fmaxf(s.lat_max, lat);
  s.queue_sum = s.queue_sum + queue;
  s.int_sum = s.int_sum + interrupted_total;
  if constexpr (FAULTS) {
    s.denied_sum = s.denied_sum + spot_req * l.deny;
    s.stale_sum = s.stale_sum + l.stale;
  }
}

}  // namespace ccka
