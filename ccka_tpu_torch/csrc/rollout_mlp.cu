// Learned-policy fleet rollout on Hopper: one thread steps one cluster
// through the whole horizon, deciding every tick with a small bf16 MLP.
//
// Replaces: ccka_tpu/sim/megakernel.py::_run_mlp (the Pallas TPU kernel of
// _make_kernel(policy="mlp"), with FAULTS its faults=True specialisation,
// with WL_D its workloads=D one, with CARRY its carry=True one,
// _run_mlp(state_in=...)), the deterministic
// policy latent_to_action(actor_mean(observe(state, exo))) fused into the
// rollout, over a population of nets. Under a signal outage (FAULTS) the
// observation reads the held signals (rollout_tick.cuh::observed). One
// build of this file holds one (FAULTS, WL_D) pair, named by the macros
// CCKA_FAULTS and CCKA_WL_D.
//
// Per population member (blockIdx.y), cluster (one thread) and tick:
//   observation, F = 2PZ+3Z+8 features in observe().flatten() order
//     (nodes [P][Z][2], capacity in flight per type, running, demand,
//     spot, on-demand and carbon per zone, is_peak, time of day), from the
//     state BEFORE the step;
//   x = bf16(sign(o) * log1p(|o|));
//   two torso layers h = gelu(bf16(bf16(sum_k w[k][j] * h[k]) + b[j])):
//     a float32 sum over k in ascending order (a product of two bf16
//     values is exact in float32, so the fused multiply-add below rounds
//     exactly as a multiply and an add would), rounded once to bf16, the
//     bias added in bf16, GELU in its tanh form with every operation
//     rounded to bf16, as JAX computes it on a bf16 array;
//   the actor head u = sum_k h[k] * w3[k][j] + b3[j] in float32;
//   the latent -> Action codec with the feasibility projection (zone-mass
//     floor, static capacity types, SLO pools always offer on-demand);
//   then rollout_tick.cuh::tick, the code the rule-profile kernel runs.
// The plain version is sim/megakernel.py::kernel_numerics_action_fn under
// sim/rollout.py::batched_rollout_summary, which chains the same sums in
// the same order in PyTorch.
//
// CARRY: one time block of a longer rollout, as in rollout_profiles.cu;
// the held observation is carried under FAULTS, and member m's state is
// the m-th [rows, B] plane of the state [NP, rows, B]. The observation's
// time of day is the global tick's.
//
// Design: the rule-profile kernel's layout: one thread per cluster, the
// fleet in registers, the horizon a loop in the thread. The block's
// member's weights (w1, w2, b1, b2 bf16; w3, b3 float32; about 52 KB for
// F=36, H=128, A=18) are loaded into shared memory once before the time
// loop. A thread's activations are its own column of two shared arrays
// h[H][kBlock] (bf16), so no thread reads another's column and the tick
// loop needs no __syncthreads(). A weight read is a broadcast (all threads
// of a warp read one address); eight outputs share one 16-byte weight load
// and one activation load. 84 KB of dynamic shared memory a block: two
// blocks fit an SM.
//
// Bound: the torso's 2*(F*H + H*H) operations per cluster-tick could run
// on the tensor cores (bf16, dense), the head's 2*H*A and the tick's own
// float operations at the float32 rate, the stream rows read once over
// HBM; chip_smoke.py states each term for the run's shapes. This kernel
// uses no tensor core: it issues about 23 K dependent fused multiply-adds
// per cluster-tick from four warps an SM, so it is far from that bound.
// Tensor cores over a tile of clusters (mma.sync or wgmma) are later work.

#include <cuda_bf16.h>

#include "rollout_tick.cuh"

#ifndef CCKA_FAULTS
#define CCKA_FAULTS 0
#endif
#ifndef CCKA_WL_D
#define CCKA_WL_D 0
#endif

namespace {

using namespace ccka;
using bf16 = __nv_bfloat16;

constexpr int kBlock = 64;   // threads (clusters) a block
constexpr int kJ = 8;        // torso outputs sharing one weight load

struct MlpParams {
  float p[kParams];
  float slo[2];    // per-pool SLO flag (projection rule 3)
  float codec[4];  // AFTER_MAX_S, HPA_LO, HPA_HI - HPA_LO, HPA_BIAS
};

constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Byte offsets of a block's dynamic shared memory.
template <int F, int H, int A>
struct Smem {
  static constexpr size_t w1 = 0;
  static constexpr size_t w2 = w1 + align16((size_t)F * H * sizeof(bf16));
  static constexpr size_t b1 = w2 + align16((size_t)H * H * sizeof(bf16));
  static constexpr size_t b2 = b1 + align16((size_t)H * sizeof(bf16));
  static constexpr size_t w3 = b2 + align16((size_t)H * sizeof(bf16));
  static constexpr size_t b3 = w3 + align16((size_t)H * A * sizeof(float));
  static constexpr size_t col0 = b3 + align16((size_t)A * sizeof(float));
  static constexpr size_t col1 =
      col0 + align16((size_t)H * kBlock * sizeof(bf16));
  static constexpr size_t bytes =
      col1 + align16((size_t)H * kBlock * sizeof(bf16));
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// A float32 value rounded to bf16 (nearest even), as a float again.
__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// GELU, tanh form, on a bf16 value, every operation rounded to bf16 as
// an operation on a bf16 array rounds in JAX and in PyTorch
// (ccka_tpu_torch/models/nets.py::gelu_tanh).
__device__ __forceinline__ float gelu_tanh_bf16(float x) {
  const float beta = rb(0.7978845608028654f);  // sqrt(2 / pi)
  const float kappa = rb(0.044715f);
  const float x_cube = rb(rb(x * x) * x);
  const float inner = rb(beta * rb(x + rb(kappa * x_cube)));
  const float cdf = rb(0.5f * rb(1.0f + rb(tanhf(inner))));
  return rb(x * cdf);
}

// out[j] = gelu(bf16(bf16(sum_k w[k][j] * in[k]) + bias[j])) for this
// thread's column: in and out point at the thread's element of row 0.
template <int IN, int H>
__device__ __forceinline__ void dense_gelu(const bf16* __restrict__ w,
                                           const bf16* __restrict__ bias,
                                           const bf16* in, bf16* out) {
  for (int j0 = 0; j0 < H; j0 += kJ) {
    float acc[kJ];
#pragma unroll
    for (int i = 0; i < kJ; ++i) acc[i] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < IN; ++k) {
      const float x = __bfloat162float(in[k * kBlock]);
      const uint4 wv = *reinterpret_cast<const uint4*>(w + k * H + j0);
      acc[0] = fmaf(bf16_lo(wv.x), x, acc[0]);
      acc[1] = fmaf(bf16_hi(wv.x), x, acc[1]);
      acc[2] = fmaf(bf16_lo(wv.y), x, acc[2]);
      acc[3] = fmaf(bf16_hi(wv.y), x, acc[3]);
      acc[4] = fmaf(bf16_lo(wv.z), x, acc[4]);
      acc[5] = fmaf(bf16_hi(wv.z), x, acc[5]);
      acc[6] = fmaf(bf16_lo(wv.w), x, acc[6]);
      acc[7] = fmaf(bf16_hi(wv.w), x, acc[7]);
    }
#pragma unroll
    for (int i = 0; i < kJ; ++i) {
      const bf16 pre = __float2bfloat16_rn(acc[i]);
      const bf16 biased = __float2bfloat16_rn(
          __bfloat162float(pre) + __bfloat162float(bias[j0 + i]));
      out[(j0 + i) * kBlock] =
          __float2bfloat16_rn(gelu_tanh_bf16(__bfloat162float(biased)));
    }
  }
}

__device__ __forceinline__ bf16 normalize_obs(float o) {
  const float sign = (float)(o > 0.0f) - (float)(o < 0.0f);
  return __float2bfloat16_rn(sign * log1pf(fabsf(o)));
}

template <int P, int Z, int K, int H, bool STOCH, bool FAULTS, int WL_D,
          bool CARRY>
__global__ void __launch_bounds__(kBlock)
rollout_mlp_kernel(const float* __restrict__ exo, float* __restrict__ out,
                   const MlpParams pr, const bf16* __restrict__ w1g,
                   const bf16* __restrict__ b1g, const bf16* __restrict__ w2g,
                   const bf16* __restrict__ b2g, const float* __restrict__ w3g,
                   const float* __restrict__ b3g, int T, int B, int rows,
                   int fb, int wb, uint32_t k0, uint32_t k1, const Carry cs) {
  constexpr int F = 2 * P * Z + 3 * Z + 8;
  constexpr int A = P * Z + 4 * P + 2;
  static_assert(H % kJ == 0, "torso width must be a multiple of kJ");
  using L = Smem<F, H, A>;
  extern __shared__ uint4 smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_raw);
  bf16* w1 = reinterpret_cast<bf16*>(smem + L::w1);
  bf16* w2 = reinterpret_cast<bf16*>(smem + L::w2);
  bf16* b1 = reinterpret_cast<bf16*>(smem + L::b1);
  bf16* b2 = reinterpret_cast<bf16*>(smem + L::b2);
  float* w3 = reinterpret_cast<float*>(smem + L::w3);
  float* b3 = reinterpret_cast<float*>(smem + L::b3);
  bf16* col0 = reinterpret_cast<bf16*>(smem + L::col0) + threadIdx.x;
  bf16* col1 = reinterpret_cast<bf16*>(smem + L::col1) + threadIdx.x;

  // This block's population member's weights, once.
  const size_t m = blockIdx.y;
  for (int i = threadIdx.x; i < F * H; i += kBlock) w1[i] = w1g[m * F * H + i];
  for (int i = threadIdx.x; i < H * H; i += kBlock) w2[i] = w2g[m * H * H + i];
  for (int i = threadIdx.x; i < H; i += kBlock) {
    b1[i] = b1g[m * H + i];
    b2[i] = b2g[m * H + i];
  }
  for (int i = threadIdx.x; i < H * A; i += kBlock) w3[i] = w3g[m * H * A + i];
  for (int i = threadIdx.x; i < A; i += kBlock) b3[i] = b3g[m * A + i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const Consts<P, Z> k(pr.p);
  Fleet<P, Z, K> s;
  Queues<WL_D> q;
  TickExo<Z> held{};
  const size_t cplane = (size_t)cs.rows * (size_t)B;  // a member's state
  if constexpr (CARRY)
    load_carry<P, Z, K, FAULTS, WL_D>(cs.in + m * cplane, B, b, s, q, held);
  // The global cluster of the Philox counter.
  const int gb = CARRY ? cs.b0 + b : b;
  const size_t plane = (size_t)rows * (size_t)B;
  for (int t = 0; t < T; ++t) {
    // The global tick: Philox, the clock, the held observation.
    const int tg = CARRY ? cs.t0 + t : t;
    const float* x = exo + (size_t)t * plane + b;
    const TickExo<Z> e(x, B);
    const TickLanes<Z, FAULTS, (WL_D > 0)> l(x, B, fb, wb);
    const TickExo<Z> o = FAULTS ? observed(e, held, l.stale, tg) : e;

    // Observation of the pre-step state, normalized, as bf16 in col1.
    {
      int f = 0;
      auto put = [&](float o) { col1[(f++) * kBlock] = normalize_obs(o); };
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int z = 0; z < Z; ++z) {
          put(s.nodes[p][z][0]);
          put(s.nodes[p][z][1]);
        }
      put(s.incoming(0));
      put(s.incoming(1));
      put(s.running[0]);
      put(s.running[1]);
      put(o.demand[0]);
      put(o.demand[1]);
#pragma unroll
      for (int z = 0; z < Z; ++z) put(o.spot[z]);
#pragma unroll
      for (int z = 0; z < Z; ++z) put(o.od[z]);
#pragma unroll
      for (int z = 0; z < Z; ++z) put(o.carb[z]);
      put(e.is_peak);
      put(fmodf((float)tg * k.dt_s, 86400.0f) * (1.0f / 86400.0f));
    }

    dense_gelu<F, H>(w1, b1, col1, col0);
    dense_gelu<H, H>(w2, b2, col0, col1);

    // Actor head in float32.
    float u[A];
#pragma unroll
    for (int j = 0; j < A; ++j) u[j] = 0.0f;
#pragma unroll 2
    for (int i = 0; i < H; ++i) {
      const float h = __bfloat162float(col1[i * kBlock]);
#pragma unroll
      for (int j = 0; j < A; ++j) u[j] = fmaf(h, w3[i * A + j], u[j]);
    }
#pragma unroll
    for (int j = 0; j < A; ++j) u[j] = u[j] + b3[j];

    // Latent -> Action codec with the feasibility projection.
    TickAction<P, Z> a;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float mass = 0.0f;
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        a.zw[p][z] = sigmoid(u[p * Z + z]);
        mass = z == 0 ? a.zw[p][z] : mass + a.zw[p][z];
      }
      if (mass < 1e-3f) {
#pragma unroll
        for (int z = 0; z < Z; ++z) a.zw[p][z] = 1.0f;
      }
      a.ct[p][0] = sigmoid(u[P * Z + p * 2]) * k.sa[p][0];
      a.ct[p][1] =
          fmaxf(sigmoid(u[P * Z + p * 2 + 1]) * k.sa[p][1], pr.slo[p]);
      a.aggr[p] = sigmoid(u[P * Z + 2 * P + p]);
      a.after[p] = pr.codec[0] * sigmoid(u[P * Z + 3 * P + p]);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
      a.hpa[c] = pr.codec[1] +
                 pr.codec[2] * sigmoid(u[P * Z + 4 * P + c] + pr.codec[3]);

    tick<P, Z, K, STOCH, FAULTS, WL_D>(k, s, q, a, e, l, gb, tg, k0, k1);
  }
  if constexpr (CARRY)
    store_carry<P, Z, K, FAULTS, WL_D>(cs.out + m * cplane, B, b, s, q, held);
  else
    s.store(out + m * (size_t)kOutRows * B, B, b, q.sums);
}

template <int P, int Z, int K, int H>
cudaError_t launch(const float* exo, float* out, const MlpParams& pr,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, const float* w3, const float* b3, int NP,
                   int T, int B, int rows, int fb, int wb, uint32_t k0,
                   uint32_t k1, bool stochastic, const Carry* cs,
                   cudaStream_t s) {
  constexpr int F = 2 * P * Z + 3 * Z + 8;
  constexpr int A = P * Z + 4 * P + 2;
  constexpr size_t bytes = Smem<F, H, A>::bytes;
  const dim3 grid((B + kBlock - 1) / kBlock, NP), block(kBlock);
  auto go = [&](auto kernel, const Carry& c) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, block, bytes, s>>>(
        exo, out, pr, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2,
        (const bf16*)b2, w3, b3, T, B, rows, fb, wb, k0, k1, c);
    return cudaGetLastError();
  };
  constexpr bool kFaults = CCKA_FAULTS != 0;
  if (cs != nullptr)
    return stochastic
        ? go(rollout_mlp_kernel<P, Z, K, H, true, kFaults, CCKA_WL_D, true>,
             *cs)
        : go(rollout_mlp_kernel<P, Z, K, H, false, kFaults, CCKA_WL_D, true>,
             *cs);
  const Carry none{nullptr, nullptr, 0, 0, 0};
  return stochastic
      ? go(rollout_mlp_kernel<P, Z, K, H, true, kFaults, CCKA_WL_D, false>,
           none)
      : go(rollout_mlp_kernel<P, Z, K, H, false, kFaults, CCKA_WL_D, false>,
           none);
}

int mlp_entry(const float* exo, float* out, const float* params,
              const float* slo, const float* codec, const void* w1,
              const void* b1, const void* w2, const void* b2, const float* w3,
              const float* b3, int NP, int F, int H, int A, int P, int Z,
              int K, int T, int B, int rows, unsigned long long seed,
              int stochastic, int fault_base, int wl_base, int wl_depth,
              const Carry* cs, void* stream) {
  if (P != 2 || F != 2 * P * Z + 3 * Z + 8 || A != P * Z + 4 * P + 2 ||
      H != 128 || NP < 1 || NP > 65535 || T < 1 || B < 1 ||
      (fault_base >= 0) != (CCKA_FAULTS != 0) || wl_depth != CCKA_WL_D ||
      (wl_base >= 0) != (CCKA_WL_D > 0) || fault_base >= rows ||
      wl_base + 3 > rows ||
      (cs != nullptr &&
       (cs->in == nullptr || cs->out == nullptr || cs->in == cs->out ||
        cs->t0 < 0 || cs->b0 < 0 ||
        cs->rows < carry_rows_used(P, Z, K, fault_base >= 0, wl_depth))))
    return (int)cudaErrorInvalidValue;
  MlpParams pr;
  for (int i = 0; i < kParams; ++i) pr.p[i] = params[i];
  for (int i = 0; i < 2; ++i) pr.slo[i] = slo[i];
  for (int i = 0; i < 4; ++i) pr.codec[i] = codec[i];
  const uint32_t k0 = (uint32_t)(seed & 0xFFFFFFFFull);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  const cudaStream_t s = (cudaStream_t)stream;
  if (Z == 3 && K == 3)
    return (int)launch<2, 3, 3, 128>(exo, out, pr, w1, b1, w2, b2, w3, b3, NP,
                                     T, B, rows, fault_base, wl_base, k0, k1,
                                     stochastic != 0, cs, s);
  if (Z == 4 && K == 3)
    return (int)launch<2, 4, 3, 128>(exo, out, pr, w1, b1, w2, b2, w3, b3, NP,
                                     T, B, rows, fault_base, wl_base, k0, k1,
                                     stochastic != 0, cs, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// exo: device [T_pad >= T, rows, B] float32; out: device [NP, 24, B]
// float32; params: host [22], slo: host [P], codec: host [4] float32;
// w1 [NP, F, H], b1 [NP, H], w2 [NP, H, H], b2 [NP, H]: device bf16;
// w3 [NP, H, A], b3 [NP, A]: device float32, with F = 2PZ+3Z+8 and
// A = PZ+4P+2; fault_base / wl_base: first row of the fault / workload
// block, -1 when the stream has none; wl_depth: the batch deadline D (0
// without workloads). Returns a cudaError_t; cudaErrorInvalidValue for a
// topology, width, size or lane layout this build is not made for.
extern "C" int ccka_rollout_mlp(const float* exo, float* out,
                                const float* params, const float* slo,
                                const float* codec, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, const float* w3,
                                const float* b3, int NP, int F, int H, int A,
                                int P, int Z, int K, int T, int B, int rows,
                                unsigned long long seed, int stochastic,
                                int fault_base, int wl_base, int wl_depth,
                                void* stream) {
  return mlp_entry(exo, out, params, slo, codec, w1, b1, w2, b2, w3, b3, NP,
                   F, H, A, P, Z, K, T, B, rows, seed, stochastic, fault_base,
                   wl_base, wl_depth, nullptr, stream);
}

// The CARRY instantiation: ticks [t0, t0 + T) of a longer rollout, exo the
// block [>= T, rows, B] whose row 0 is global tick t0, from the carried
// state state_in [NP, state_rows, B] into state_out (another buffer of
// the same shape); b0 the global index of cluster 0. The accumulators are
// rows 0..20 of each member's state; out is not written. The other
// arguments as for ccka_rollout_mlp.
extern "C" int ccka_rollout_mlp_carry(
    const float* exo, const float* state_in, float* state_out,
    int state_rows, const float* params, const float* slo,
    const float* codec, const void* w1, const void* b1, const void* w2,
    const void* b2, const float* w3, const float* b3, int NP, int F, int H,
    int A, int P, int Z, int K, int T, int B, int rows,
    unsigned long long seed, int stochastic, int fault_base, int wl_base,
    int wl_depth, int t0, int b0, void* stream) {
  const Carry cs{state_in, state_out, state_rows, t0, b0};
  return mlp_entry(exo, nullptr, params, slo, codec, w1, b1, w2, b2, w3, b3,
                   NP, F, H, A, P, Z, K, T, B, rows, seed, stochastic,
                   fault_base, wl_base, wl_depth, &cs, stream);
}
