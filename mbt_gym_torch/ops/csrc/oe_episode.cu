// Optimal-execution episode kernel K6 for Hopper (sm_90a).
//
// Replaces the TPU kernel oe_episode_pallas
// (mbt_gym_tpu/ops/pallas_episode.py:720, pallas_call at :747 and :760):
// one whole optimal-execution episode per env — trading-speed dynamics
// against temporary and permanent impact, the speed read from a per-step
// schedule shared by every env — and only the terminal (cash, inventory,
// price, permanent impact, sum q_t^2, sum speed_t * q_{t-1}) leaves the
// chip; the CJ execution reward telescopes to those sums.
//
// Design: the warp-specialised step pipeline of step_pipeline.cuh (K1's,
// K5's and K8's) with one draw channel.  A CTA owns E envs: E / 32
// consumer warps step the envs, one thread per env with the six carries in
// registers, and P producer warps fill a ring of shared-memory slots with
// the midprice normals of the steps ahead (philox_normal in native mode;
// in noise mode the bulk-copy engine copies each step's run of the (T, N)
// normals).  The consumers' chain per step is a shared-memory load, the
// schedule's uniform load (every thread reads the same float) and the
// bookkeeping; the Philox chain and Box-Muller's logf/cosf/sqrtf run ahead
// in other warps.  From step_pipeline.py's WIDE_MIN_ENVS on (one thread per
// env fills the card) the wide shape runs instead: no producers, each
// thread draws its own normals.
//
// Bounds on the H100: 24 bytes written per env and nothing read per step
// in native mode, so it is bound by operations: one Philox4x32-10 call
// plus logf/cosf/sqrtf per env-step for the midprice normal.  At 8,192 envs
// one thread per env left half of the card's schedulers without a warp and
// each thread's steps on one dependent chain; on the pipeline the
// producers' draws, spread over several warps per env group, set the pace.
//
// Numerics: every float op follows the plain PyTorch version's order
// (mbt_gym_torch/ops/oe_episode.py) under --fmad=false.  Noise mode reads
// (T, N) midprice normals (the JAX kernel's noise layout); native mode
// draws the normal of draws.cuh's philox_normal.
//
// TPU-only parts not ported: the (rows, 128) tiling and the 1e-42 carry
// jitter that worked around a Mosaic layout limit.

#include <cstdint>
#include <cuda_runtime.h>

#include "draws.cuh"
#include "step_pipeline.cuh"

// Mirrors OeKernelParams in mbt_gym_torch/ops/oe_episode.py (ctypes).
struct OeKernelParams {
  int run_steps;
  float dt;
  float temporary_impact;
  float permanent_impact;
  float max_inventory;
  float max_cash;
  float drift_dt;
  float vol_sqrt_dt;
  float initial_cash;
  float initial_inventory;
  float initial_price;
  mbt::PipeGeometry pipe;
};

namespace {

struct OeState {
  float cash, inv, price, perm, sumq2, sum_sq;
};

struct OeOut {
  float* cash;
  float* inv;
  float* price;
  float* perm;
  float* sumq2;
  float* sum_sq;
};

// One OE step on register state: execute at mid + temporary impact +
// permanent state, all PRE-update (env.step order, ModelDynamics.py:262-267;
// pallas_episode.py:649-664), then the clips, the sums and the BM move.
__device__ __forceinline__ void oe_step(const OeKernelParams& p, float speed, float normal, OeState& s) {
  const float exec_price = s.price + p.temporary_impact * speed + s.perm;
  s.cash = s.cash - speed * p.dt * exec_price;
  s.sum_sq = s.sum_sq + speed * s.inv;  // speed * PRE-step inventory (the CjOe term)
  s.inv = s.inv + speed * p.dt;
  s.inv = fminf(fmaxf(s.inv, -p.max_inventory), p.max_inventory);
  s.cash = fminf(fmaxf(s.cash, -p.max_cash), p.max_cash);
  s.sumq2 = s.sumq2 + s.inv * s.inv;  // post-update inventory
  s.perm = s.perm + p.permanent_impact * speed * p.dt;
  s.price = s.price + p.drift_dt + p.vol_sqrt_dt * normal;
}

template <bool kNoise, bool kWide>
__global__ void __launch_bounds__(kWide ? mbt::kWideEnvs : mbt::kMaxPipeThreads)
oe_episode_kernel(const OeKernelParams p, int n, uint32_t seed, const float* __restrict__ noise,
                  const float* __restrict__ speed_table, const OeOut out) {
  OeState s{p.initial_cash, p.initial_inventory, p.initial_price, 0.0f, 0.0f, 0.0f};
  int env;
  if constexpr (kWide) {
    env = blockIdx.x * mbt::kWideEnvs + threadIdx.x;
    if (env >= n) return;
    for (int i = 0; i < p.run_steps; ++i) {
      float normal;
      if constexpr (kNoise) {
        normal = noise[static_cast<size_t>(i) * n + env];
      } else {
        normal = mbt::philox_normal(seed, static_cast<uint32_t>(env), static_cast<uint32_t>(i));
      }
      oe_step(p, __ldg(speed_table + i), normal, s);
    }
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    const mbt::StepRing ring(p.pipe, smem);
    const int warp = threadIdx.x >> 5;
    const int env0 = blockIdx.x * p.pipe.envs;
    if (warp >= ring.consumer_warps()) {
      ring.produce<kNoise, 1, 1>(warp - ring.consumer_warps(), p.run_steps, env0, n, seed, noise,
                                 [](int, int) { return static_cast<const float*>(nullptr); });  // no table
      return;
    }
    env = env0 + static_cast<int>(threadIdx.x);
    ring.consume(p.run_steps, [&](int slot, int c0, int steps) {
      const mbt::SlotDraws<kNoise, 1, 1> draws{ring.draws(slot) + threadIdx.x, noise + env0, n,
                                               mbt::draw_stride(p.pipe)};
      for (int j = 0; j < steps; ++j) oe_step(p, __ldg(speed_table + c0 + j), draws.at(j, c0 + j, 0), s);
    });
    if (env >= n) return;
  }
  out.cash[env] = s.cash;
  out.inv[env] = s.inv;
  out.price[env] = s.price;
  out.perm[env] = s.perm;
  out.sumq2[env] = s.sumq2;
  out.sum_sq[env] = s.sum_sq;
}

// The geometry the wrapper chose, checked against what the kernel assumes:
// the midprice normal alone, no table.
bool pipe_ok(const mbt::PipeGeometry& g) { return mbt::pipe_shape_ok(g, 1) && g.table_rows == 0 && !g.staged; }

template <bool kNoise>
cudaError_t launch(const OeKernelParams& p, int n, uint32_t seed, const float* noise, const float* speed_table,
                   const OeOut& out, cudaStream_t s) {
  return mbt::is_wide(p.pipe)
             ? mbt::launch_pipeline(oe_episode_kernel<kNoise, true>, p.pipe, n, s, p, n, seed, noise, speed_table, out)
             : mbt::launch_pipeline(oe_episode_kernel<kNoise, false>, p.pipe, n, s, p, n, seed, noise, speed_table, out);
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing and returns a CUDA error code (0 on success).  `noise`
// is NULL in native (Philox) mode.
extern "C" int mbt_oe_episode(const OeKernelParams* p, int device, int n, uint32_t seed,
                              const float* noise, const float* speed_table, float* cash, float* inv,
                              float* price, float* perm, float* sumq2, float* sum_sq, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (!pipe_ok(p->pipe)) return static_cast<int>(cudaErrorInvalidValue);
  const OeOut out{cash, inv, price, perm, sumq2, sum_sq};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = noise ? launch<true>(*p, n, seed, noise, speed_table, out, s)
              : launch<false>(*p, n, seed, noise, speed_table, out, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
