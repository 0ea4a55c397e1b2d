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
// Design: one thread per env, the step loop inside the thread, the six
// carries in registers; the schedule is a uniform load (every thread reads
// the same float per step).
//
// Bounds on the H100: 24 bytes written per env and nothing read per step
// in native mode, so it is bound by operations: one Philox4x32-10 call
// plus logf/cosf/sqrtf per env-step for the midprice normal.  At 8,192 envs
// only ~3% of the card's thread slots are busy, so it is latency-bound
// there; the wide shape (1,048,576 envs) fills the card.
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
};

namespace {

constexpr int kBlock = 128;

template <bool kNoise>
__global__ void __launch_bounds__(kBlock)
oe_episode_kernel(const OeKernelParams p, int n, uint32_t seed, const float* __restrict__ noise,
                  const float* __restrict__ speed_table, float* __restrict__ cash_out,
                  float* __restrict__ inv_out, float* __restrict__ price_out,
                  float* __restrict__ perm_out, float* __restrict__ sumq2_out,
                  float* __restrict__ sum_sq_out) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= n) return;
  float cash = p.initial_cash, inv = p.initial_inventory, price = p.initial_price;
  float perm = 0.0f, sumq2 = 0.0f, sum_sq = 0.0f;
  for (int i = 0; i < p.run_steps; ++i) {
    const float speed = __ldg(speed_table + i);
    float normal;
    if constexpr (kNoise) {
      normal = noise[static_cast<size_t>(i) * n + env];
    } else {
      normal = mbt::philox_normal(seed, static_cast<uint32_t>(env), static_cast<uint32_t>(i));
    }
    // execute at mid + temporary impact + permanent state, all PRE-update
    // (env.step order, ModelDynamics.py:262-267; pallas_episode.py:649-664)
    const float exec_price = price + p.temporary_impact * speed + perm;
    cash = cash - speed * p.dt * exec_price;
    sum_sq = sum_sq + speed * inv;  // speed * PRE-step inventory (the CjOe term)
    inv = inv + speed * p.dt;
    inv = fminf(fmaxf(inv, -p.max_inventory), p.max_inventory);
    cash = fminf(fmaxf(cash, -p.max_cash), p.max_cash);
    sumq2 = sumq2 + inv * inv;  // post-update inventory
    perm = perm + p.permanent_impact * speed * p.dt;
    price = price + p.drift_dt + p.vol_sqrt_dt * normal;
  }
  cash_out[env] = cash;
  inv_out[env] = inv;
  price_out[env] = price;
  perm_out[env] = perm;
  sumq2_out[env] = sumq2;
  sum_sq_out[env] = sum_sq;
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (0 on success).  `noise`
// is NULL in native (Philox) mode.
extern "C" int mbt_oe_episode(const OeKernelParams* p, int device, int n, uint32_t seed,
                              const float* noise, const float* speed_table, float* cash, float* inv,
                              float* price, float* perm, float* sumq2, float* sum_sq, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const dim3 grid((n + kBlock - 1) / kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise) {
    oe_episode_kernel<true><<<grid, kBlock, 0, s>>>(*p, n, seed, noise, speed_table, cash, inv, price,
                                                   perm, sumq2, sum_sq);
  } else {
    oe_episode_kernel<false><<<grid, kBlock, 0, s>>>(*p, n, seed, noise, speed_table, cash, inv, price,
                                                    perm, sumq2, sum_sq);
  }
  return static_cast<int>(cudaGetLastError());
}
