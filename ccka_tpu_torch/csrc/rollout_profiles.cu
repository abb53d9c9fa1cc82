// Profile and plan-playback fleet rollouts on Hopper: two adjacent lanes
// of a warp step one cluster through the whole horizon, one lane per pool,
// under the Peak/Off-Peak rule, under the carbon-aware re-rank of its zone
// weights, or replaying a precomputed plan.
//
// Replaces: ccka_tpu/sim/megakernel.py::_run (the Pallas TPU kernel of
// _make_kernel(policy="profiles") and, with POLICY = kCarbon,
// policy="carbon"; with FAULTS its faults=True specialisation, with WL_D
// its workloads=D one), with its in-kernel sampler _uniform +
// _poisson_small_kernel; with POLICY = kPlan,
// ccka_tpu/sim/megakernel.py::_run_plan (policy="plan", body :332-333,
// :427-441); with CARRY, the carry=True specialisation of both
// (_run(state_in=...) :1010 and _run_plan(state_in=...) :1657, body
// :340-353 and :896-903).
//
// CARRY: one time block of a longer rollout. Each lane loads its
// registers (Fleet, the workload Queues, the carbon re-rank's held
// observation under FAULTS) from the carried state at the block's first
// tick and stores them after its last (rollout_tick.cuh::CarryRows, batch
// innermost, so the loads and stores coalesce). The loop runs the block's
// local ticks over the block's stream; Philox, the held observation's
// first tick and a plan's row (the host passes the plan from the block's
// first row on) take the global tick t0 + t and the global cluster b0 + b.
// The accumulators are part of the state, so only the last block's are
// read. At most 122 floats a cluster cross a boundary (carbon on a fault
// and workload stream, Z = 4), 16 MB at B = 32768: a read and a write
// per block, about 1 % of the block's stream bytes.
//
// Shards: every launch, carried or not, takes b0, the global index of its
// first cluster, into the Philox counter; a launch over clusters
// [b0, b0 + B) of a fleet draws what one launch over the whole fleet draws
// for them (ccka_tpu_torch/parallel/sharded_kernel.py; the JAX package
// offsets the kernel seed instead, sharded_kernel.py::shard_seed).
//
// The action of a tick is a per-cluster select of two constant profiles
// on is_peak (kRule, kCarbon), or row t of a plan (kPlan): plan[t][j][b]
// per cluster, b innermost so a warp's loads of coordinate j coalesce,
// or a broadcast plan[t][j] every thread of the fleet reads (batch
// stride 0). A plan observes nothing, so under FAULTS it keeps no held
// observation. With kCarbon the zone weights of that action are replaced by
// CarbonAwarePolicy.decide (ccka_tpu_torch/policy/carbon.py): per zone
// max(sigmoid(sharpness * rel + stickiness * occupancy), min_weight) from
// this tick's carbon row and the fleet's placement before the step, in
// the plain version's operation order. The three constants are launch
// arguments. What the action then does is rollout_tick.cuh::tick, the
// code the plain rollout (sim/dynamics.py::step, sim/metrics.py) is held
// against; the result is an out[24, B] block of accumulators.
//
// Plan bound, multiregion B = 32768 x T = 2880: the plan adds its 18
// used rows of 24 (4 bytes each) a cluster-tick to the stream's bytes, so
// bytes and operations are about equal (chip_smoke.py prints both).
//
// Bound, at B = 32768 clusters x T = 2880 ticks, default preset: the
// kernel reads 3Z+3 = 12 of the stream's 16 rows (the rest are padding)
// once, 4.53 GB, about 1.35 ms at the H100 SXM's 3.35 TB/s; its float work
// (879 unfused operations per cluster-tick stochastic, 651 deterministic,
// counted by chip_smoke.py) at the 33.5 T/s float32 rate for multiplies and
// adds that are not fused takes about 2.48 ms, so operations bound it.
//
// Lanes: the fault block (FAULTS) and the workload block (WL_D, the
// batch deadline in ticks) are read from rows fb and wb of the same
// stream; kCarbon with FAULTS keeps the held observation (3Z+3 floats) in
// registers. One build of this file holds one (FAULTS, WL_D) pair, named
// by the macros CCKA_FAULTS and CCKA_WL_D (kernels/build.py builds the
// four pairs in parallel, one library each).
//
// Design: a cluster is a pair of lanes (rollout_tick.cuh::Group<2>), lane
// p owning pool p: its nodes, pipeline and timer in registers, its spot
// rows' Philox draws and interruptions, its share of the provisioning
// split and consolidation; lane c computes capacity type c's softmax and
// consolidation terms. The shared state (running pods, accumulators,
// workload queues, the held observation) is in both lanes in the same
// bits; sums over pools are handed over by __shfl_sync in the plain
// version's order. Lane 0 stores the output block and the carried state's
// shared rows, each lane its own pool's rows. A pair past B steps a copy
// of cluster B - 1 and stores nothing, so every lane reaches every
// shuffle. One loop runs over all T ticks inside the pair: no time grid,
// no scratch carried between blocks, no padding ticks. The stream
// exo[t][r][b] has b innermost, so a warp's reads of one row coalesce.
//
// What bounds it (PERF.md, section 6): one thread a cluster was
// latency-bound (time flat in the fleet size, under two warps a
// scheduler at B = 32768); a pair halves each lane's chain of dependent
// operations and doubles the warps. The divisions with a zero dividend
// (most of a rule profile's zone split) took the library's slow path;
// rollout_tick.cuh::quot answers them apart. A B = 32768 fleet is then
// about 1.3x its issue floor (SASS instructions of the tick loop x ticks
// x warps over the 528 schedulers' rate). The register bound keeps the
// fleet in one wave; the heaviest lane and CARRY instantiations spill
// under it, which measured faster than a second wave. A register double
// buffer of the next tick's rows gained little on the main path and made
// the lane instantiations spill, so each tick loads its own rows.
//
// philox_uniform_kernel writes the uniforms of the tick's Philox stream
// for a grid of (tick, row, cluster); it is on no rollout path.

#include "rollout_tick.cuh"

#ifndef CCKA_FAULTS
#define CCKA_FAULTS 0
#endif
#ifndef CCKA_WL_D
#define CCKA_WL_D 0
#endif

namespace {

using namespace ccka;

constexpr int kMaxAct = 32;
constexpr int kGroup = 2;  // lanes a cluster: one per pool
constexpr int kBlock = 64;  // threads a block: 32 clusters

// The policy of a rollout_profiles_kernel instantiation.
constexpr int kRule = 0;
constexpr int kCarbon = 1;
constexpr int kPlan = 2;

// A plan stream: element (t, j, b) at t * ts + j * rs + b * bs; a
// broadcast plan has bs = 0.
struct PlanStream {
  const float* p;
  size_t ts, rs, bs;
};

// The action coordinates of the lane's PL pools from pool0 on, in the
// packed order (zone weights, capacity types, aggressiveness,
// consolidate-after, HPA), from coordinate j's value src(j).
template <int P, int Z, int PL, typename Src>
__device__ __forceinline__ void fill_action(TickAction<PL, Z>& a, int pool0,
                                            Src src) {
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int p = pool0 + j;
#pragma unroll
    for (int z = 0; z < Z; ++z) a.zw[j][z] = src(p * Z + z);
    a.ct[j][0] = src(P * Z + p * 2);
    a.ct[j][1] = src(P * Z + p * 2 + 1);
    a.aggr[j] = src(P * Z + 2 * P + p);
    a.after[j] = src(P * Z + 3 * P + p);
  }
  a.hpa[0] = src(P * Z + 4 * P);
  a.hpa[1] = src(P * Z + 4 * P + 1);
}

struct Profiles {
  float p[kParams];
  float act[2][kMaxAct];  // [off-peak, peak] action coordinates
  float carbon[3];        // sharpness, min_weight, stickiness (kCarbon only)
};

// Register budget: a fleet of 32768 clusters in pairs is 65536 threads,
// 497 a SM, so 8 blocks of kBlock = 64 threads must be resident on each SM
// at once: at most 65536 / (8 * 64) = 128 registers a thread, in every
// instantiation (see the design note above for what that costs).
constexpr int kMinBlocks = 8;

template <int P, int Z, int K, bool STOCH, int POLICY, bool FAULTS,
          int WL_D, bool CARRY>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
rollout_profiles_kernel(const float* __restrict__ exo,
                        float* __restrict__ out, const Profiles pr,
                        const PlanStream plan, int T, int B, int rows, int fb,
                        int wb, uint32_t k0, uint32_t k1, const Carry cs) {
  static_assert(P == kGroup, "a lane per pool");
  constexpr int PL = P / kGroup;
  // The carbon re-rank observes held signals under an outage.
  constexpr bool kHeld = FAULTS && POLICY == kCarbon;
  const int rank = threadIdx.x % kGroup;
  const int b = (blockIdx.x * kBlock + threadIdx.x) / kGroup;
  // Every lane must reach the group's shuffles: a pair past B steps a
  // copy of cluster B - 1 and stores nothing.
  const bool live = b < B;
  const int bv = live ? b : B - 1;
  const int pool0 = rank * PL;

  const Consts<P, Z, kGroup> k(pr.p, rank);
  Fleet<P, Z, K, kGroup> s(rank);
  Queues<WL_D> q;
  TickExo<Z> held{};
  if constexpr (CARRY)
    load_carry<P, Z, K, kHeld, WL_D>(cs.in, B, bv, s, q, held);
  // The global cluster of the Philox counter: b0 is the launch's first
  // cluster in the whole fleet (0 unless the launch is one shard of it).
  const int gb = cs.b0 + bv;
  const size_t plane = (size_t)rows * (size_t)B;
  for (int t = 0; t < T; ++t) {
    const float* x = exo + (size_t)t * plane + bv;
    const TickExo<Z> e(x, B);
    const TickLanes<Z, FAULTS, (WL_D > 0)> l(x, B, fb, wb);

    // The global tick: Philox, the held observation's first tick.
    const int tg = CARRY ? cs.t0 + t : t;
    TickAction<PL, Z> a;
    if constexpr (POLICY == kPlan) {
      // Row t of this cluster's plan (or of the broadcast plan): the
      // lane's pools' coordinates.
      const float* row = plan.p + (size_t)t * plan.ts + (size_t)bv * plan.bs;
      fill_action<P, Z>(a, pool0,
                        [&](int j) { return __ldg(row + j * plan.rs); });
    } else {
      // The rule: per-cluster select of the two profiles on is_peak.
      const bool peak = e.is_peak > 0.5f;
      fill_action<P, Z>(
          a, pool0, [&](int j) { return peak ? pr.act[1][j] : pr.act[0][j]; });
    }

    if constexpr (POLICY == kCarbon) {
      // Zone weight from observed carbon and the pre-step placement.
      const TickExo<Z> o = FAULTS ? observed(e, held, l.stale, tg) : e;
      float csum = o.carb[0];
#pragma unroll
      for (int z = 1; z < Z; ++z) csum = csum + o.carb[z];
      const float cmean = csum * (1.0f / (float)Z);
      float nodes_z[Z];  // chained capacity type, then pool
#pragma unroll
      for (int z = 0; z < Z; ++z) nodes_z[z] = -0.0f;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        s.grp.chain(nodes_z, [&](float (&acc)[Z]) {
#pragma unroll
          for (int j = 0; j < PL; ++j)
#pragma unroll
            for (int z = 0; z < Z; ++z) acc[z] = acc[z] + s.nodes[j][z][c];
        });
      float ntot = nodes_z[0];
#pragma unroll
      for (int z = 1; z < Z; ++z) ntot = ntot + nodes_z[z];
      ntot = ntot + 1e-6f;
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        const float occ = fminf(
            fmaxf(quot(nodes_z[z], ntot) * (float)Z - 1.0f, -1.0f), 1.0f);
        const float rel = (cmean - o.carb[z]) / (cmean + 1e-6f);
        const float w = fmaxf(
            sigmoid(pr.carbon[0] * rel + pr.carbon[2] * occ), pr.carbon[1]);
#pragma unroll
        for (int j = 0; j < PL; ++j) a.zw[j][z] = w;
      }
    }
    tick<P, Z, K, STOCH, FAULTS, WL_D>(k, s, q, a, e, l, gb, tg, k0, k1);
  }
  if (!live) return;
  if constexpr (CARRY)
    store_carry<P, Z, K, kHeld, WL_D>(cs.out, B, b, s, q, held);
  else if (rank == 0)
    s.store(out, B, b, q.sums);
}

__global__ void philox_uniform_kernel(float* __restrict__ out, uint32_t k0,
                                      uint32_t k1, int tick0, int n_ticks,
                                      int n_rows, int n_clusters) {
  const size_t n = (size_t)n_ticks * n_rows * n_clusters;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint32_t b = (uint32_t)(i % n_clusters);
    const uint32_t r = (uint32_t)((i / n_clusters) % n_rows);
    const uint32_t t = (uint32_t)(tick0 + i / ((size_t)n_clusters * n_rows));
    const uint4 w = philox4x32_10(make_uint4(b, t, r, 0u), k0, k1);
    out[i] = to_uniform(w.x);
    out[n + i] = to_uniform(w.y);
    out[2 * n + i] = to_uniform(w.z);
  }
}

template <int P, int Z, int K, int POLICY>
cudaError_t launch(const float* exo, float* out, const Profiles& pr,
                   const PlanStream& plan, int T, int B, int rows, int fb,
                   int wb, uint32_t k0, uint32_t k1, bool stochastic,
                   const Carry* cs, int b0, cudaStream_t s) {
  constexpr bool kFaults = CCKA_FAULTS != 0;
  const dim3 grid((unsigned)(((size_t)B * kGroup + kBlock - 1) / kBlock)),
      block(kBlock);
  auto go = [&](auto kernel, const Carry& c) {
    kernel<<<grid, block, 0, s>>>(exo, out, pr, plan, T, B, rows, fb, wb, k0,
                                  k1, c);
    return cudaGetLastError();
  };
  if (cs != nullptr)
    return stochastic
        ? go(rollout_profiles_kernel<P, Z, K, true, POLICY, kFaults,
                                     CCKA_WL_D, true>, *cs)
        : go(rollout_profiles_kernel<P, Z, K, false, POLICY, kFaults,
                                     CCKA_WL_D, true>, *cs);
  const Carry none{nullptr, nullptr, 0, 0, b0};
  return stochastic
      ? go(rollout_profiles_kernel<P, Z, K, true, POLICY, kFaults, CCKA_WL_D,
                                   false>, none)
      : go(rollout_profiles_kernel<P, Z, K, false, POLICY, kFaults, CCKA_WL_D,
                                   false>, none);
}

// The topologies this file is built for: (P, Z, K) = (2, 3, 3), (2, 4, 3).
template <int POLICY>
cudaError_t dispatch(const float* exo, float* out, const Profiles& pr,
                     const PlanStream& plan, int P, int Z, int K, int T,
                     int B, int rows, int fb, int wb, uint32_t k0,
                     uint32_t k1, bool stochastic, const Carry* cs, int b0,
                     cudaStream_t s) {
  if (P == 2 && Z == 3 && K == 3)
    return launch<2, 3, 3, POLICY>(exo, out, pr, plan, T, B, rows, fb, wb,
                                   k0, k1, stochastic, cs, b0, s);
  if (P == 2 && Z == 4 && K == 3)
    return launch<2, 4, 3, POLICY>(exo, out, pr, plan, T, B, rows, fb, wb,
                                   k0, k1, stochastic, cs, b0, s);
  return cudaErrorInvalidValue;
}

// The lane checks shared by both entries.
bool lanes_ok(int rows, int fault_base, int wl_base, int wl_depth) {
  return (fault_base >= 0) == (CCKA_FAULTS != 0) && wl_depth == CCKA_WL_D &&
         (wl_base >= 0) == (CCKA_WL_D > 0) && fault_base < rows &&
         wl_base + 3 <= rows;
}

}  // namespace

namespace {

// A carried state of the rows the instantiation uses, at non-negative
// offsets (the state's own checks; the rest as for the entries).
bool carry_ok(const Carry& c, int P, int Z, int K, bool held, int wl_depth) {
  return c.in != nullptr && c.out != nullptr && c.in != c.out &&
         c.t0 >= 0 && c.b0 >= 0 &&
         c.rows >= carry_rows_used(P, Z, K, held, wl_depth);
}

int profiles_entry(const float* exo, float* out, const float* params,
                   const float* actions, int n_act, int P, int Z, int K,
                   int T, int B, int rows, unsigned long long seed,
                   int stochastic, const float* carbon, int fault_base,
                   int wl_base, int wl_depth, const Carry* cs, int b0,
                   void* stream) {
  if (n_act != P * Z + 4 * P + 2 || n_act > kMaxAct || T < 1 || B < 1 ||
      b0 < 0 || !lanes_ok(rows, fault_base, wl_base, wl_depth) ||
      (cs != nullptr &&
       !carry_ok(*cs, P, Z, K, carbon != nullptr && fault_base >= 0,
                 wl_depth)))
    return (int)cudaErrorInvalidValue;
  Profiles pr;
  for (int i = 0; i < kParams; ++i) pr.p[i] = params[i];
  for (int j = 0; j < 2; ++j)
    for (int i = 0; i < kMaxAct; ++i)
      pr.act[j][i] = i < n_act ? actions[j * n_act + i] : 0.0f;
  for (int i = 0; i < 3; ++i) pr.carbon[i] = carbon ? carbon[i] : 0.0f;
  const uint32_t k0 = (uint32_t)(seed & 0xFFFFFFFFull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  const cudaStream_t s = (cudaStream_t)stream;
  const PlanStream none{nullptr, 0, 0, 0};
  return (int)(carbon ? dispatch<kCarbon>(exo, out, pr, none, P, Z, K, T, B,
                                          rows, fault_base, wl_base, k0, k1,
                                          stochastic != 0, cs, b0, s)
                      : dispatch<kRule>(exo, out, pr, none, P, Z, K, T, B,
                                        rows, fault_base, wl_base, k0, k1,
                                        stochastic != 0, cs, b0, s));
}

int plan_entry(const float* exo, float* out, const float* params,
               const float* plan, int plan_rows, int plan_batched, int P,
               int Z, int K, int T, int B, int rows, unsigned long long seed,
               int stochastic, int fault_base, int wl_base, int wl_depth,
               const Carry* cs, int b0, void* stream) {
  if (plan == nullptr || plan_rows < P * Z + 4 * P + 2 || T < 1 || B < 1 ||
      b0 < 0 || !lanes_ok(rows, fault_base, wl_base, wl_depth) ||
      (cs != nullptr && !carry_ok(*cs, P, Z, K, false, wl_depth)))
    return (int)cudaErrorInvalidValue;
  Profiles pr{};
  for (int i = 0; i < kParams; ++i) pr.p[i] = params[i];
  const PlanStream ps =
      plan_batched ? PlanStream{plan, (size_t)plan_rows * (size_t)B,
                                (size_t)B, 1}
                   : PlanStream{plan, (size_t)plan_rows, 1, 0};
  return (int)dispatch<kPlan>(exo, out, pr, ps, P, Z, K, T, B, rows,
                              fault_base, wl_base,
                              (uint32_t)(seed & 0xFFFFFFFFull),
                              (uint32_t)(seed >> 32), stochastic != 0, cs,
                              b0, (cudaStream_t)stream);
}

}  // namespace

// exo: device [T_pad >= T, rows, B] float32; out: device [24, B] float32;
// params: host [22] float32; actions: host [2, n_act] float32 (off-peak,
// peak); carbon: null for the rule profiles, else host {sharpness,
// min_weight, stickiness}, which re-rank the zone weights by carbon;
// fault_base / wl_base: first row of the fault / workload block, -1 when
// the stream has none; wl_depth: the batch deadline D (0 without
// workloads); b0: the global index of cluster 0 in the Philox counter (0
// for a whole fleet, the shard's first cluster for one shard of it).
// Returns a cudaError_t; cudaErrorInvalidValue for a topology, size or
// lane layout this build is not made for.
extern "C" int ccka_rollout_profiles(const float* exo, float* out,
                                     const float* params,
                                     const float* actions, int n_act, int P,
                                     int Z, int K, int T, int B, int rows,
                                     unsigned long long seed, int stochastic,
                                     const float* carbon, int fault_base,
                                     int wl_base, int wl_depth, int b0,
                                     void* stream) {
  return profiles_entry(exo, out, params, actions, n_act, P, Z, K, T, B, rows,
                        seed, stochastic, carbon, fault_base, wl_base,
                        wl_depth, nullptr, b0, stream);
}

// The CARRY instantiation: ticks [t0, t0 + T) of a longer rollout, exo the
// block [>= T, rows, B] whose row 0 is global tick t0, from the carried
// state state_in [state_rows, B] into state_out (another buffer of the
// same shape); b0 the global index of cluster 0. The accumulators are
// rows 0..20 of state_out; out is not written. The other arguments as for
// ccka_rollout_profiles.
extern "C" int ccka_rollout_profiles_carry(
    const float* exo, const float* state_in, float* state_out,
    int state_rows, const float* params, const float* actions, int n_act,
    int P, int Z, int K, int T, int B, int rows, unsigned long long seed,
    int stochastic, const float* carbon, int fault_base, int wl_base,
    int wl_depth, int t0, int b0, void* stream) {
  const Carry cs{state_in, state_out, state_rows, t0, b0};
  return profiles_entry(exo, nullptr, params, actions, n_act, P, Z, K, T, B,
                        rows, seed, stochastic, carbon, fault_base, wl_base,
                        wl_depth, &cs, 0, stream);
}

// plan: device float32, [T_pad >= T, plan_rows, B] per cluster
// (plan_batched != 0) or [T_pad, plan_rows] broadcast to every cluster;
// the first P * Z + 4 * P + 2 rows are the action coordinates in
// _pack_action's order. The other arguments as for ccka_rollout_profiles.
extern "C" int ccka_rollout_plan(const float* exo, float* out,
                                 const float* params, const float* plan,
                                 int plan_rows, int plan_batched, int P,
                                 int Z, int K, int T, int B, int rows,
                                 unsigned long long seed, int stochastic,
                                 int fault_base, int wl_base, int wl_depth,
                                 int b0, void* stream) {
  return plan_entry(exo, out, params, plan, plan_rows, plan_batched, P, Z, K,
                    T, B, rows, seed, stochastic, fault_base, wl_base,
                    wl_depth, nullptr, b0, stream);
}

// The plan's CARRY instantiation: plan row 0 is global tick t0 (the host
// passes the plan from that row on); the rest as for
// ccka_rollout_profiles_carry and ccka_rollout_plan.
extern "C" int ccka_rollout_plan_carry(
    const float* exo, const float* state_in, float* state_out,
    int state_rows, const float* params, const float* plan, int plan_rows,
    int plan_batched, int P, int Z, int K, int T, int B, int rows,
    unsigned long long seed, int stochastic, int fault_base, int wl_base,
    int wl_depth, int t0, int b0, void* stream) {
  const Carry cs{state_in, state_out, state_rows, t0, b0};
  return plan_entry(exo, nullptr, params, plan, plan_rows, plan_batched, P,
                    Z, K, T, B, rows, seed, stochastic, fault_base, wl_base,
                    wl_depth, &cs, 0, stream);
}

// out: device [3, n_ticks, n_rows, n_clusters] float32.
extern "C" int ccka_philox_uniforms(float* out, unsigned long long seed,
                                    int tick0, int n_ticks, int n_rows,
                                    int n_clusters, void* stream) {
  if (n_ticks < 1 || n_rows < 1 || n_clusters < 1 || tick0 < 0)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)n_ticks * n_rows * n_clusters;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  philox_uniform_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      out, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32), tick0,
      n_ticks, n_rows, n_clusters);
  return (int)cudaGetLastError();
}
