// Learned-policy fleet rollout on Hopper: one thread steps one cluster
// through the whole horizon, deciding every tick with a small bf16 MLP
// whose torso runs on the tensor cores over the warp's 32 clusters.
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
//     the sum by mma.sync (bf16 products, float32 accumulation in the
//     tensor core's own order over each k-step of 16, the k-steps in
//     ascending order), rounded once to bf16 to the same side as the plain
//     version's ascending float32 chain (below), the bias added in bf16,
//     GELU in its tanh form with every operation rounded to bf16, as JAX
//     computes it on a bf16 array (tanhf in float32);
//   the actor head u = sum_k h[k] * w3[k][j] + b3[j] in float32, one fused
//     multiply-add chain over k in ascending order;
//   the latent -> Action codec with the feasibility projection (zone-mass
//     floor, static capacity types, SLO pools always offer on-demand);
//   then rollout_tick.cuh::tick, the code the rule-profile kernel runs.
// The plain version is sim/megakernel.py::kernel_numerics_action_fn under
// sim/rollout.py::batched_rollout_summary. Its torso sums are ascending
// float32 chains: the tensor cores' sums differ from them in the last
// bits of most units, and a unit's rounding to bf16 differs where a
// rounding boundary lies between the two. Through the policy's feedback
// a single such step can move a cluster's trajectory (a node more, a
// tick's SLO flag), so each layer also sums the terms' magnitudes on the
// tensor cores, and a unit whose sum lies within 2^-20 of them of a
// boundary (near_tie; 0.1 to 4 % of a layer's units for the shipped
// flagship, chip_smoke.py phase 5e) is summed again as the plain chain on
// the float32 pipes and rounded from that. Every hidden unit then rounds
// as the plain version's does wherever the two sums differ by less than
// 2^-20 of the magnitudes, a premise that is measured, not guaranteed
// (any two orders of a 128-term float32 sum may differ by up to 2^-16):
// chip_smoke.py phase 5e measured at most 2^-21.3 for the shipped
// flagship, a margin of 2.5x, and fails when it exceeds 2^-20 or any
// unit differs. The epilogue and the head are bitwise the plain ones
// given the same inputs. ccka_mlp_forward below lets a caller check this
// layer by layer (sim/megakernel.py::check_mlp_forward).
//
// CARRY: one time block of a longer rollout, as in rollout_profiles.cu;
// the held observation is carried under FAULTS, and member m's state is
// the m-th [rows, B] plane of the state [NP, rows, B]. The observation's
// time of day is the global tick's. Every launch takes b0, the global
// index of its first cluster, as rollout_profiles.cu's do (a shard's
// launch draws the whole fleet's numbers for its clusters).
//
// Design: a block is 8 warps, a warp owns 32 clusters. Each thread keeps
// its cluster's fleet in registers and runs the tick alone; each tick it
// writes its normalized observation as one bf16 row of its warp's tile in
// shared memory, and the warp multiplies its own 32 rows: layer 1
// [32 x K1] x [K1 x H] (K1 = F padded to 16), layer 2 [32 x H] x [H x H],
// mma.sync.m16n8k16 on fragments that ldmatrix loads from the tile (A)
// and, transposed, from the member's weights (B), 16 output columns a pass
// (16 float32 sums and 16 sums of magnitudes a thread). The epilogue
// rounds, adds the bias and applies the GELU on packed bf16 pairs
// (mul/add.rn.bf16x2: a correctly rounded bf16 operation equals the
// float32 one rounded to bf16, as 24 >= 2 * 8 + 2) and writes the layer's
// output tile; the warp queues its near-tie units in shared memory and
// sums them again 32 at a time, each lane taking any unit (a unit summed
// in a divergent branch would hold the warp once per call site, and a
// lane's own list once per unit of the busiest lane). The head then reads
// the thread's own row. Tiles and weights in shared memory have
// rows of H + 8 bf16 (272 bytes), so the eight rows an ldmatrix phase
// reads, and the rows a fragment store writes, fall in distinct banks.
// Only __syncwarp() orders the tick loop; the weights (about 57 KB), the
// 8 x 2 tiles (136 KB) and the queues (8 KB) take one block an SM, so
// B = 32768 is 128 blocks.
// Lanes past B in the last warp step a copy of cluster B - 1 and store
// nothing: mma.sync needs the whole warp.
//
// Bound: the torso's 2*(F*H + H*H) operations per cluster-tick at the
// dense bf16 tensor-core rate, the head's 2*H*A and the tick's own float
// operations at the float32 rate, the stream rows read once over HBM;
// chip_smoke.py states each term for the run's shapes. The float32 pipes
// set it: the tick, the 2 x H GELUs (each a tanhf and eight bf16
// operations), the head's H*A fused multiply-adds and the few chains
// summed again per cluster-tick stay on them.

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

constexpr int kWarps = 8;             // warps a block
constexpr int kBlock = 32 * kWarps;   // threads (clusters) a block
constexpr int kPass = 16;             // torso output columns a pass
constexpr int kQueue = 32 * kPass;    // a warp's queue of near-tie units

struct MlpParams {
  float p[kParams];
  float slo[2];    // per-pool SLO flag (projection rule 3)
  float codec[4];  // AFTER_MAX_S, HPA_LO, HPA_HI - HPA_LO, HPA_BIAS
};

constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// The first layer's depth: F zero-padded to the mma's k-step of 16.
constexpr int pad16(int f) { return (f + 15) / 16 * 16; }

// Byte offsets of a block's dynamic shared memory. w1 [K1][LD] and w2
// [H][LD] bf16 keep the [in, out] layout with rows of LD = H + 8; each
// warp has two tiles [32][LD] bf16 (tile 0: the observation, then h2;
// tile 1: h1) and a queue [kQueue] of near-tie units.
template <int F, int H, int A>
struct Smem {
  static constexpr int K1 = pad16(F);
  static constexpr int LD = H + 8;
  static constexpr size_t w1 = 0;
  static constexpr size_t w2 = w1 + align16((size_t)K1 * LD * sizeof(bf16));
  static constexpr size_t b1 = w2 + align16((size_t)H * LD * sizeof(bf16));
  static constexpr size_t b2 = b1 + align16((size_t)H * sizeof(bf16));
  static constexpr size_t w3 = b2 + align16((size_t)H * sizeof(bf16));
  static constexpr size_t b3 = w3 + align16((size_t)H * A * sizeof(float));
  static constexpr size_t tiles = b3 + align16((size_t)A * sizeof(float));
  static constexpr size_t tile = (size_t)32 * LD * sizeof(bf16);
  static constexpr size_t queue = tiles + (size_t)kWarps * 2 * tile;
  static constexpr size_t queue_warp = (size_t)kQueue * sizeof(uint16_t);
  static constexpr size_t bytes = queue + (size_t)kWarps * queue_warp;
};

// A block's view of its shared memory.
template <int F, int H, int A>
struct Net {
  using L = Smem<F, H, A>;
  bf16 *w1, *w2, *b1, *b2;
  float *w3, *b3;
  unsigned char* tiles;

  __device__ __forceinline__ explicit Net(unsigned char* s)
      : w1(reinterpret_cast<bf16*>(s + L::w1)),
        w2(reinterpret_cast<bf16*>(s + L::w2)),
        b1(reinterpret_cast<bf16*>(s + L::b1)),
        b2(reinterpret_cast<bf16*>(s + L::b2)),
        w3(reinterpret_cast<float*>(s + L::w3)),
        b3(reinterpret_cast<float*>(s + L::b3)),
        tiles(s + L::tiles) {}

  // Tile i (0 or 1) of warp w.
  __device__ __forceinline__ bf16* tile(int w, int i) const {
    return reinterpret_cast<bf16*>(tiles + (size_t)(2 * w + i) * L::tile);
  }

  // Warp w's queue of near-tie units.
  __device__ __forceinline__ uint16_t* queue(int w) const {
    return reinterpret_cast<uint16_t*>(tiles + (L::queue - L::tiles) +
                                       (size_t)w * L::queue_warp);
  }

  // Member m's weights from device memory, rows F..K1-1 of w1 zero; the
  // whole block takes part, then synchronizes.
  __device__ __forceinline__ void load(
      size_t m, const bf16* __restrict__ w1g, const bf16* __restrict__ b1g,
      const bf16* __restrict__ w2g, const bf16* __restrict__ b2g,
      const float* __restrict__ w3g, const float* __restrict__ b3g) {
    const bf16 zero = __float2bfloat16_rn(0.0f);
    for (int i = threadIdx.x; i < L::K1 * H; i += kBlock) {
      const int r = i / H, c = i % H;
      w1[r * L::LD + c] = r < F ? w1g[m * F * H + i] : zero;
    }
    for (int i = threadIdx.x; i < H * H; i += kBlock)
      w2[(i / H) * L::LD + i % H] = w2g[m * H * H + i];
    for (int i = threadIdx.x; i < H; i += kBlock) {
      b1[i] = b1g[m * H + i];
      b2[i] = b2g[m * H + i];
    }
    for (int i = threadIdx.x; i < H * A; i += kBlock)
      w3[i] = w3g[m * H * A + i];
    for (int i = threadIdx.x; i < A; i += kBlock) b3[i] = b3g[m * A + i];
    __syncthreads();
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices from shared memory, each lane addressing one
// row; .trans hands each lane a column pair instead of a row pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a [16 x 16] x b [16 x 8], bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Packed bf16 pairs (low half: the lower column). Each operation rounds
// once to bf16 (.rn: never contracted into a fused multiply-add).
__device__ __forceinline__ uint32_t bmul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t badd(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// (lo, hi) float32 -> one bf16 pair, each rounded to nearest even.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ uint32_t splat(float c) { return pack_rn(c, c); }

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// GELU, tanh form, on a pair of bf16 values, every operation rounded to
// bf16 as an operation on a bf16 array rounds in JAX and in PyTorch
// (ccka_tpu_torch/models/nets.py::gelu_tanh); tanh in float32.
__device__ __forceinline__ uint32_t gelu_tanh_bf16x2(uint32_t x) {
  const uint32_t beta = splat(0.7978845608028654f);  // sqrt(2 / pi)
  const uint32_t kappa = splat(0.044715f);
  const uint32_t x_cube = bmul(bmul(x, x), x);
  const uint32_t inner = bmul(beta, badd(x, bmul(kappa, x_cube)));
  const uint32_t th = pack_rn(tanhf(bf16_lo(inner)), tanhf(bf16_hi(inner)));
  const uint32_t cdf = bmul(splat(0.5f), badd(splat(1.0f), th));
  return bmul(x, cdf);
}

__device__ __forceinline__ uint16_t normalize_obs(float o) {
  const float sign = (float)(o > 0.0f) - (float)(o < 0.0f);
  return __bfloat16_as_ushort(__float2bfloat16_rn(sign * log1pf(fabsf(o))));
}

// The thread's row of its warp's observation tile: o normalized, as bf16,
// zero from column F to K1.
template <int F, int K1>
__device__ __forceinline__ void store_obs_row(bf16* row, const float (&o)[F]) {
  uint32_t w[K1 / 2];
#pragma unroll
  for (int i = 0; i < K1 / 2; ++i) {
    const uint32_t lo = 2 * i < F ? normalize_obs(o[2 * i]) : 0u;
    const uint32_t hi = 2 * i + 1 < F ? normalize_obs(o[2 * i + 1]) : 0u;
    w[i] = lo | (hi << 16);
  }
#pragma unroll
  for (int c = 0; c < K1 / 8; ++c)
    reinterpret_cast<uint4*>(row)[c] =
        make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
}

// The plain version's sum of one torso output, sum_k x[k] * w[k * LD]
// over k = 0 .. N-1 in ascending order from zero: one fused multiply-add a
// term (a product of two bf16 values is exact in float32, so each step
// rounds as the plain version's separate multiply and add do). N may run
// into zero padding: a zero term leaves a nonzero sum as it is and a zero
// one +0, which is all the chain can hold, so the padding changes no bit.
template <int N, int LD>
__device__ __forceinline__ float chained_sum(const bf16* x, const bf16* w) {
  static_assert(N % 8 == 0, "x is read 8 terms at a time");
  float acc = 0.0f;
#pragma unroll 2
  for (int k0 = 0; k0 < N; k0 += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + k0);
    const uint32_t xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float xk = q & 1 ? __uint_as_float(xs[q / 2] & 0xFFFF0000u)
                             : __uint_as_float(xs[q / 2] << 16);
      acc = fmaf(xk, __bfloat162float(w[(k0 + q) * LD]), acc);
    }
  }
  return acc;
}

// Whether a bf16 rounding boundary lies within kNearTie * a of m, a
// tensor-core sum whose terms' magnitudes add up to a: there the plain
// version's ascending chain may round to the other side, and the unit is
// summed again as the chain. Both sums are within (n - 1) 2^-24 a of the
// exact one; their difference was measured below kNearTie * a, which
// nothing guarantees: chip_smoke.py phase 5e reports its largest share
// of 2^-16 a (sum_bound_use: 0.025, so 2^-21.3 a, for the shipped
// multiregion flagship on an NVIDIA H100 80GB HBM3 at 700 W) and fails
// above 2^-20 a (sim/megakernel.py::mlp_forward_departures).
constexpr float kNearTie = 1.0f / 1048576.0f;  // 2^-20

__device__ __forceinline__ bool near_tie(float m, float a) {
  const float d = __fmul_ru(a, kNearTie);
  return __bfloat16_as_ushort(__float2bfloat16_rn(__fsub_rd(m, d))) !=
         __bfloat16_as_ushort(__float2bfloat16_rn(__fadd_ru(m, d)));
}

// Unit `unit` (row * H + column) of a torso layer from the plain chain:
// its sum, rounded and biased, through the GELU into out (with PRE the sum
// into pre, for rows < pre_rows).
template <int KIN, int H, int LD, bool PRE>
__device__ __forceinline__ void chained_unit(int unit, const bf16* w,
                                             const bf16* __restrict__ bias,
                                             const bf16* in, bf16* out,
                                             float* __restrict__ pre,
                                             int pre_rows) {
  const int r = unit / H, j = unit % H;
  const float v = chained_sum<KIN, LD>(in + r * LD, w + j);
  const uint32_t b = __bfloat16_as_ushort(bias[j]);
  const uint32_t h = gelu_tanh_bf16x2(badd(pack_rn(v, v), b | (b << 16)));
  out[r * LD + j] = __ushort_as_bfloat16((unsigned short)(h & 0xFFFFu));
  if constexpr (PRE) {
    if (r < pre_rows) pre[r * H + j] = v;
  }
}

// The warp's queued units (queue[0 .. n)) summed again as the plain chain,
// each lane taking every 32nd.
template <int KIN, int H, int LD, bool PRE>
__device__ __forceinline__ void chain_queued(const uint16_t* queue, int n,
                                             const bf16* w,
                                             const bf16* __restrict__ bias,
                                             const bf16* in, bf16* out,
                                             int lane, float* pre,
                                             int pre_rows) {
  __syncwarp();
  for (int i = lane; i < n; i += 32)
    chained_unit<KIN, H, LD, PRE>(queue[i], w, bias, in, out, pre, pre_rows);
  __syncwarp();
}

// One torso layer for the warp's 32 rows: out[r][j] = gelu(bf16(bf16(
// sum_k in[r][k] * w[k][j]) + bias[j])), in [32][KIN] and out [32][H] the
// warp's tiles, w [KIN][H] (all rows LD bf16), zero past the inputs. Each
// pass of kPass columns runs two products on the tensor cores, the sums
// and the sums of the terms' magnitudes (the same fragments with their
// sign bits cleared), writes each unit from its tensor-core sum, and
// appends the units near a tie (near_tie) to the warp's queue (kQueue
// entries, one pass's worth at most); the queue is summed again as the
// plain chain (chain_queued) when the next pass's units might not fit and
// after the last pass, the queued units overwritten. With PRE, the float32
// sums so rounded, of rows < pre_rows, also go to pre [32][H] in device
// memory.
template <int KIN, int H, int LD, bool PRE>
__device__ __forceinline__ void torso_layer(const bf16* w,
                                            const bf16* __restrict__ bias,
                                            const bf16* in, bf16* out,
                                            uint16_t* queue, int lane,
                                            float* __restrict__ pre = nullptr,
                                            int pre_rows = 0) {
  static_assert(KIN % 16 == 0 && H % kPass == 0 && kPass == 16 &&
                    32 * H <= 65536,
                "mma tile shape");
  // ldmatrix.x4: lanes 0-15 address rows 0-15 of the first 8 columns,
  // lanes 16-31 the same rows 8 columns on (A: a 16 x 16 block of rows by
  // k; B: a 16 x 16 block of k by outputs, two n-tiles).
  const uint32_t frag = ((lane & 15) * LD + (lane >> 4) * 8) * 2;
  const uint32_t a_s = smem_addr(in) + frag, w_s = smem_addr(w) + frag;
  const int g = lane >> 2, t = lane & 3;
  constexpr uint32_t kMag = 0x7FFF7FFFu;  // clears both bf16 sign bits
  int queued = 0;                         // the same in every lane
#pragma unroll 1
  for (int n0 = 0; n0 < H; n0 += kPass) {
    float acc[2][2][4], mag[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = mag[m][n][i] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < KIN; k0 += 16) {
      uint32_t a[2][4], am[2][4], b[4], bm[4];
      ldsm_x4(a[0], a_s + k0 * 2);
      ldsm_x4(a[1], a_s + (16 * LD + k0) * 2);
      ldsm_x4_trans(b, w_s + (k0 * LD + n0) * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        am[0][i] = a[0][i] & kMag;
        am[1][i] = a[1][i] & kMag;
        bm[i] = b[i] & kMag;
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(acc[m][0], a[m], b[0], b[1]);
        mma_bf16(acc[m][1], a[m], b[2], b[3]);
        mma_bf16(mag[m][0], am[m], bm[0], bm[1]);
        mma_bf16(mag[m][1], am[m], bm[2], bm[3]);
      }
    }
    // Accumulator (m, n, 2h + e) is row 16m + g + 8h, column
    // n0 + 8n + 2t + e; bit 8m + 4n + 2h + e of ties marks it near a tie.
    uint32_t ties = 0;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int j = n0 + 8 * n + 2 * t;
      const uint32_t b2 = *reinterpret_cast<const uint32_t*>(bias + j);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * m + g + 8 * h;
          const float lo = acc[m][n][2 * h], hi = acc[m][n][2 * h + 1];
          *reinterpret_cast<uint32_t*>(out + r * LD + j) =
              gelu_tanh_bf16x2(badd(pack_rn(lo, hi), b2));
          if constexpr (PRE) {
            if (r < pre_rows) {
              pre[r * H + j] = lo;
              pre[r * H + j + 1] = hi;
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ties |= (uint32_t)near_tie(acc[m][n][2 * h + e],
                                       mag[m][n][2 * h + e])
                    << (8 * m + 4 * n + 2 * h + e);
        }
    }
    // The pass's near ties into the queue, in lane order.
    const int mine = __popc(ties);
    int upto = mine;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, upto, d);
      if (lane >= d) upto += v;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, upto, 31);
    if (total == 0) continue;
    if (queued + total > kQueue) {
      chain_queued<KIN, H, LD, PRE>(queue, queued, w, bias, in, out, lane,
                                    pre, pre_rows);
      queued = 0;
    }
    for (int at = queued + upto - mine; ties; ties &= ties - 1) {
      const int bit = __ffs(ties) - 1;
      const int r = 16 * (bit >> 3) + g + 8 * ((bit >> 1) & 1);
      const int j = n0 + 8 * ((bit >> 2) & 1) + 2 * t + (bit & 1);
      queue[at++] = (uint16_t)(r * H + j);
    }
    queued += total;
  }
  if (queued > 0)
    chain_queued<KIN, H, LD, PRE>(queue, queued, w, bias, in, out, lane, pre,
                                  pre_rows);
}

// The actor head on the thread's own row of h2: u[j] = sum_k h[k] *
// w3[k][j] + b3[j], one fused multiply-add chain over ascending k.
template <int H, int A>
__device__ __forceinline__ void head(const bf16* row,
                                     const float* __restrict__ w3,
                                     const float* __restrict__ b3,
                                     float (&u)[A]) {
#pragma unroll
  for (int j = 0; j < A; ++j) u[j] = 0.0f;
#pragma unroll 1
  for (int i = 0; i < H; i += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + i);
    const float h[8] = {bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y),
                        bf16_hi(v.y), bf16_lo(v.z), bf16_hi(v.z),
                        bf16_lo(v.w), bf16_hi(v.w)};
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int j = 0; j < A; ++j)
        u[j] = fmaf(h[q], w3[(i + q) * A + j], u[j]);
  }
#pragma unroll
  for (int j = 0; j < A; ++j) u[j] = u[j] + b3[j];
}

// Observation tile -> torso -> head for the warp: each lane has written
// its row of tile 0; returns its latent. Tile 1 then holds h1, tile 0 h2.
// With PRE, each layer's float32 sums of rows < pre_rows go to pre1 and
// pre2 ([32][H] in device memory).
template <int F, int H, int A, bool PRE>
__device__ __forceinline__ void forward_warp(const Net<F, H, A>& net,
                                             int warp, int lane,
                                             float (&u)[A],
                                             float* pre1 = nullptr,
                                             float* pre2 = nullptr,
                                             int pre_rows = 0) {
  using L = Smem<F, H, A>;
  bf16* tile0 = net.tile(warp, 0);
  bf16* tile1 = net.tile(warp, 1);
  __syncwarp();
  torso_layer<L::K1, H, L::LD, PRE>(net.w1, net.b1, tile0, tile1,
                                    net.queue(warp), lane, pre1, pre_rows);
  __syncwarp();
  torso_layer<H, H, L::LD, PRE>(net.w2, net.b2, tile1, tile0,
                                net.queue(warp), lane, pre2, pre_rows);
  __syncwarp();
  head<H, A>(tile0 + lane * L::LD, net.w3, net.b3, u);
}

template <int P, int Z, int K, int H, bool STOCH, bool FAULTS, int WL_D,
          bool CARRY>
__global__ void __launch_bounds__(kBlock, 1)
rollout_mlp_kernel(const float* __restrict__ exo, float* __restrict__ out,
                   const MlpParams pr, const bf16* __restrict__ w1g,
                   const bf16* __restrict__ b1g, const bf16* __restrict__ w2g,
                   const bf16* __restrict__ b2g, const float* __restrict__ w3g,
                   const float* __restrict__ b3g, int T, int B, int rows,
                   int fb, int wb, uint32_t k0, uint32_t k1, const Carry cs) {
  constexpr int F = 2 * P * Z + 3 * Z + 8;
  constexpr int A = P * Z + 4 * P + 2;
  using L = Smem<F, H, A>;
  extern __shared__ uint4 smem_raw[];
  Net<F, H, A> net(reinterpret_cast<unsigned char*>(smem_raw));

  // This block's population member's weights, once.
  const size_t m = blockIdx.y;
  net.load(m, w1g, b1g, w2g, b2g, w3g, b3g);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * kBlock + warp * 32;
  if (first >= B) return;  // a whole warp past B
  const bool live = first + lane < B;
  const int b = live ? first + lane : B - 1;
  bf16* tile0 = net.tile(warp, 0);

  const Consts<P, Z> k(pr.p);
  Fleet<P, Z, K> s;
  Queues<WL_D> q;
  TickExo<Z> held{};
  const size_t cplane = (size_t)cs.rows * (size_t)B;  // a member's state
  if constexpr (CARRY)
    load_carry<P, Z, K, FAULTS, WL_D>(cs.in + m * cplane, B, b, s, q, held);
  // The global cluster of the Philox counter: b0 is the launch's first
  // cluster in the whole fleet (0 unless the launch is one shard of it).
  const int gb = cs.b0 + b;
  const size_t plane = (size_t)rows * (size_t)B;
  for (int t = 0; t < T; ++t) {
    // The global tick: Philox, the clock, the held observation.
    const int tg = CARRY ? cs.t0 + t : t;
    const float* x = exo + (size_t)t * plane + b;
    const TickExo<Z> e(x, B);
    const TickLanes<Z, FAULTS, (WL_D > 0)> l(x, B, fb, wb);
    const TickExo<Z> o = FAULTS ? observed(e, held, l.stale, tg) : e;

    // Observation of the pre-step state, as the thread's row of tile 0.
    {
      float ob[F];
      int f = 0;
      auto put = [&](float v) { ob[f++] = v; };
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int z = 0; z < Z; ++z) {
          put(s.nodes[p][z][0]);
          put(s.nodes[p][z][1]);
        }
      float inc[2];
      s.incoming(inc);
      put(inc[0]);
      put(inc[1]);
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
      store_obs_row<F, L::K1>(tile0 + lane * L::LD, ob);
    }

    float u[A];
    forward_warp<F, H, A, false>(net, warp, lane, u);

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
  if (!live) return;
  if constexpr (CARRY)
    store_carry<P, Z, K, FAULTS, WL_D>(cs.out + m * cplane, B, b, s, q, held);
  else
    s.store(out + m * (size_t)kOutRows * B, B, b, q.sums);
}

// The rollout kernel's forward on given observations: obs [N][F] float32
// in, the layers out (x [N][F], h1, h2 [N][H] bf16; pre1, pre2 [N][H],
// u [N][A] float32), through the same device functions as the rollout.
template <int F, int H, int A>
__global__ void __launch_bounds__(kBlock, 1)
mlp_forward_kernel(const float* __restrict__ obs, bf16* __restrict__ x_out,
                   float* __restrict__ pre1, bf16* __restrict__ h1_out,
                   float* __restrict__ pre2, bf16* __restrict__ h2_out,
                   float* __restrict__ u_out, const bf16* __restrict__ w1g,
                   const bf16* __restrict__ b1g, const bf16* __restrict__ w2g,
                   const bf16* __restrict__ b2g, const float* __restrict__ w3g,
                   const float* __restrict__ b3g, int N) {
  using L = Smem<F, H, A>;
  extern __shared__ uint4 smem_raw[];
  Net<F, H, A> net(reinterpret_cast<unsigned char*>(smem_raw));
  net.load(0, w1g, b1g, w2g, b2g, w3g, b3g);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * kBlock + warp * 32;
  if (first >= N) return;
  const bool live = first + lane < N;
  const size_t n = live ? first + lane : N - 1;
  bf16* tile0 = net.tile(warp, 0);
  bf16* tile1 = net.tile(warp, 1);
  bf16* row0 = tile0 + lane * L::LD;
  bf16* row1 = tile1 + lane * L::LD;

  float ob[F];
#pragma unroll
  for (int f = 0; f < F; ++f) ob[f] = obs[n * F + f];
  store_obs_row<F, L::K1>(row0, ob);
  if (live)
    for (int f = 0; f < F; ++f) x_out[n * F + f] = row0[f];
  const int rows = min(32, N - first);
  float u[A];
  forward_warp<F, H, A, true>(net, warp, lane, u, pre1 + (size_t)first * H,
                              pre2 + (size_t)first * H, rows);
  if (!live) return;
  for (int j = 0; j < H; ++j) {
    h1_out[n * H + j] = row1[j];
    h2_out[n * H + j] = row0[j];
  }
#pragma unroll
  for (int j = 0; j < A; ++j) u_out[n * A + j] = u[j];
}

template <int P, int Z, int K, int H>
cudaError_t launch(const float* exo, float* out, const MlpParams& pr,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, const float* w3, const float* b3, int NP,
                   int T, int B, int rows, int fb, int wb, uint32_t k0,
                   uint32_t k1, bool stochastic, const Carry* cs, int b0,
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
  const Carry none{nullptr, nullptr, 0, 0, b0};
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
              const Carry* cs, int b0, void* stream) {
  if (P != 2 || F != 2 * P * Z + 3 * Z + 8 || A != P * Z + 4 * P + 2 ||
      H != 128 || NP < 1 || NP > 65535 || T < 1 || B < 1 || b0 < 0 ||
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
                                     stochastic != 0, cs, b0, s);
  if (Z == 4 && K == 3)
    return (int)launch<2, 4, 3, 128>(exo, out, pr, w1, b1, w2, b2, w3, b3, NP,
                                     T, B, rows, fault_base, wl_base, k0, k1,
                                     stochastic != 0, cs, b0, s);
  return (int)cudaErrorInvalidValue;
}

template <int F, int H, int A>
cudaError_t launch_forward(const float* obs, void* x, float* pre1, void* h1,
                           float* pre2, void* h2, float* u, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           const float* w3, const float* b3, int N,
                           cudaStream_t s) {
  constexpr size_t bytes = Smem<F, H, A>::bytes;
  auto kernel = mlp_forward_kernel<F, H, A>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(N + kBlock - 1) / kBlock, kBlock, bytes, s>>>(
      obs, (bf16*)x, pre1, (bf16*)h1, pre2, (bf16*)h2, u, (const bf16*)w1,
      (const bf16*)b1, (const bf16*)w2, (const bf16*)b2, w3, b3, N);
  return cudaGetLastError();
}

}  // namespace

// exo: device [T_pad >= T, rows, B] float32; out: device [NP, 24, B]
// float32; params: host [22], slo: host [P], codec: host [4] float32;
// w1 [NP, F, H], b1 [NP, H], w2 [NP, H, H], b2 [NP, H]: device bf16;
// w3 [NP, H, A], b3 [NP, A]: device float32, with F = 2PZ+3Z+8 and
// A = PZ+4P+2; fault_base / wl_base: first row of the fault / workload
// block, -1 when the stream has none; wl_depth: the batch deadline D (0
// without workloads); b0: the global index of cluster 0 in the Philox
// counter (0 for a whole fleet, the shard's first cluster for one shard of
// it). Returns a cudaError_t; cudaErrorInvalidValue for a topology, width,
// size or lane layout this build is not made for.
extern "C" int ccka_rollout_mlp(const float* exo, float* out,
                                const float* params, const float* slo,
                                const float* codec, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, const float* w3,
                                const float* b3, int NP, int F, int H, int A,
                                int P, int Z, int K, int T, int B, int rows,
                                unsigned long long seed, int stochastic,
                                int fault_base, int wl_base, int wl_depth,
                                int b0, void* stream) {
  return mlp_entry(exo, out, params, slo, codec, w1, b1, w2, b2, w3, b3, NP,
                   F, H, A, P, Z, K, T, B, rows, seed, stochastic, fault_base,
                   wl_base, wl_depth, nullptr, b0, stream);
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
                   fault_base, wl_base, wl_depth, &cs, 0, stream);
}

// The rollout kernel's observation -> torso -> head on N given
// observations (one net: member 0 of the weights, laid out as for
// ccka_rollout_mlp): obs [N, F] float32 in; x [N, F] (the normalized
// observation), h1 and h2 [N, H] bf16, pre1 and pre2 [N, H] (each layer's
// float32 sum before rounding) and u [N, A] float32 out, all on the
// device. F and A of one of the built topologies (29 and 16, 36 and 18),
// H = 128.
extern "C" int ccka_mlp_forward(const float* obs, void* x, float* pre1,
                                void* h1, float* pre2, void* h2, float* u,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const float* w3, const float* b3, int N,
                                int F, int H, int A, void* stream) {
  if (N < 1 || H != 128) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (F == 29 && A == 16)
    return (int)launch_forward<29, 128, 16>(obs, x, pre1, h1, pre2, h2, u,
                                            w1, b1, w2, b2, w3, b3, N, s);
  if (F == 36 && A == 18)
    return (int)launch_forward<36, 128, 18>(obs, x, pre1, h1, pre2, h2, u,
                                            w1, b1, w2, b2, w3, b3, N, s);
  return (int)cudaErrorInvalidValue;
}
