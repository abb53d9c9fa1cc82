// Rule-profile fleet rollout on Hopper: one thread steps one cluster
// through the whole horizon under the Peak/Off-Peak rule, or under the
// carbon-aware re-rank of its zone weights.
//
// Replaces: ccka_tpu/sim/megakernel.py::_run (the Pallas TPU kernel of
// _make_kernel(policy="profiles") and, with CARBON, policy="carbon";
// plain exo stream, no carried state), with its in-kernel sampler
// _uniform + _poisson_small_kernel.
//
// The action of a tick is a per-cluster select of two constant profiles
// on is_peak. With CARBON the zone weights of that action are replaced by
// CarbonAwarePolicy.decide (ccka_tpu_torch/policy/carbon.py): per zone
// max(sigmoid(sharpness * rel + stickiness * occupancy), min_weight) from
// this tick's carbon row and the fleet's placement before the step, in
// the plain version's operation order. The three constants are launch
// arguments. What the action then does is rollout_tick.cuh::tick, the
// code the plain rollout (sim/dynamics.py::step, sim/metrics.py) is held
// against; the result is an out[24, B] block of accumulators.
//
// Bound, at B = 32768 clusters x T = 2880 ticks, default preset: the
// kernel reads 3Z+3 = 12 of the stream's 16 rows (the rest are padding)
// once, 4.53 GB, about 1.35 ms at the H100 SXM's 3.35 TB/s; its float work
// (879 unfused operations per cluster-tick stochastic, 651 deterministic,
// counted by chip_smoke.py) at the 33.5 T/s float32 rate for multiplies and
// adds that are not fused takes about 2.48 ms, so operations bound it.
//
// Design: the whole state (nodes[P][Z][2], pipe[K][P][Z][2], running[2],
// timer[P], 16 accumulators) lives in registers, and one loop runs over
// all T ticks inside the thread: no time grid, no scratch carried between
// blocks, no padding ticks. The stream exo[t][r][b] has b innermost, so a
// warp's reads of one row coalesce. 32768 threads fill only about 8 of an
// SM's 64 warp slots, so this first version is expected to be latency-
// bound; prefetching exo rows into shared memory (cp.async or TMA) is
// later work.
//
// philox_uniform_kernel writes the uniforms of the tick's Philox stream
// for a grid of (tick, row, cluster); it is on no rollout path.

#include "rollout_tick.cuh"

namespace {

using namespace ccka;

constexpr int kMaxAct = 32;
constexpr int kBlock = 64;

struct Profiles {
  float p[kParams];
  float act[2][kMaxAct];  // [off-peak, peak] action coordinates
  float carbon[3];        // sharpness, min_weight, stickiness (CARBON only)
};

template <int P, int Z, int K, bool STOCH, bool CARBON>
__global__ void __launch_bounds__(kBlock)
rollout_profiles_kernel(const float* __restrict__ exo,
                        float* __restrict__ out, const Profiles pr, int T,
                        int B, int rows, uint32_t k0, uint32_t k1) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const Consts<P, Z> k(pr.p);
  Fleet<P, Z, K> s;
  const size_t plane = (size_t)rows * (size_t)B;
  for (int t = 0; t < T; ++t) {
    const TickExo<Z> e(exo + (size_t)t * plane + b, B);
    // The rule: per-cluster select of the two profiles on is_peak. Every
    // coordinate index below is a compile-time constant, so both loads
    // come from the parameter bank and the select stays in registers.
    const bool peak = e.is_peak > 0.5f;
    auto sel = [&](int j) { return peak ? pr.act[1][j] : pr.act[0][j]; };
    TickAction<P, Z> a;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int z = 0; z < Z; ++z) a.zw[p][z] = sel(p * Z + z);
      a.ct[p][0] = sel(P * Z + p * 2);
      a.ct[p][1] = sel(P * Z + p * 2 + 1);
      a.aggr[p] = sel(P * Z + 2 * P + p);
      a.after[p] = sel(P * Z + 3 * P + p);
    }
    a.hpa[0] = sel(P * Z + 4 * P);
    a.hpa[1] = sel(P * Z + 4 * P + 1);

    if (CARBON) {
      // Zone weight from observed carbon and the pre-step placement.
      float csum = e.carb[0];
#pragma unroll
      for (int z = 1; z < Z; ++z) csum = csum + e.carb[z];
      const float cmean = csum * (1.0f / (float)Z);
      float nodes_z[Z];
#pragma unroll
      for (int z = 0; z < Z; ++z) {  // chained capacity type, then pool
        float n = s.nodes[0][z][0];
#pragma unroll
        for (int i = 1; i < 2 * P; ++i) n = n + s.nodes[i % P][z][i / P];
        nodes_z[z] = n;
      }
      float ntot = nodes_z[0];
#pragma unroll
      for (int z = 1; z < Z; ++z) ntot = ntot + nodes_z[z];
      ntot = ntot + 1e-6f;
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        const float occ = fminf(
            fmaxf(nodes_z[z] / ntot * (float)Z - 1.0f, -1.0f), 1.0f);
        const float rel = (cmean - e.carb[z]) / (cmean + 1e-6f);
        const float w = fmaxf(
            sigmoid(pr.carbon[0] * rel + pr.carbon[2] * occ), pr.carbon[1]);
#pragma unroll
        for (int p = 0; p < P; ++p) a.zw[p][z] = w;
      }
    }
    tick<P, Z, K, STOCH>(k, s, a, e, b, t, k0, k1);
  }
  s.store(out, B, b);
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

template <int P, int Z, int K, bool CARBON>
cudaError_t launch(const float* exo, float* out, const Profiles& pr, int T,
                   int B, int rows, uint32_t k0, uint32_t k1, bool stochastic,
                   cudaStream_t s) {
  const dim3 grid((B + kBlock - 1) / kBlock), block(kBlock);
  if (stochastic)
    rollout_profiles_kernel<P, Z, K, true, CARBON>
        <<<grid, block, 0, s>>>(exo, out, pr, T, B, rows, k0, k1);
  else
    rollout_profiles_kernel<P, Z, K, false, CARBON>
        <<<grid, block, 0, s>>>(exo, out, pr, T, B, rows, k0, k1);
  return cudaGetLastError();
}

}  // namespace

// exo: device [T_pad >= T, rows, B] float32; out: device [24, B] float32;
// params: host [22] float32; actions: host [2, n_act] float32 (off-peak,
// peak); carbon: null for the rule profiles, else host {sharpness,
// min_weight, stickiness}, which re-rank the zone weights by carbon.
// Returns a cudaError_t; cudaErrorInvalidValue for a topology or size the
// kernel is not built for.
extern "C" int ccka_rollout_profiles(const float* exo, float* out,
                                     const float* params,
                                     const float* actions, int n_act, int P,
                                     int Z, int K, int T, int B, int rows,
                                     unsigned long long seed, int stochastic,
                                     const float* carbon, void* stream) {
  if (n_act != P * Z + 4 * P + 2 || n_act > kMaxAct || T < 1 || B < 1)
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
  const bool st = stochastic != 0;
  if (P == 2 && Z == 3 && K == 3)
    return (int)(carbon
                     ? launch<2, 3, 3, true>(exo, out, pr, T, B, rows, k0, k1, st, s)
                     : launch<2, 3, 3, false>(exo, out, pr, T, B, rows, k0, k1, st, s));
  if (P == 2 && Z == 4 && K == 3)
    return (int)(carbon
                     ? launch<2, 4, 3, true>(exo, out, pr, T, B, rows, k0, k1, st, s)
                     : launch<2, 4, 3, false>(exo, out, pr, T, B, rows, k0, k1, st, s));
  return (int)cudaErrorInvalidValue;
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
