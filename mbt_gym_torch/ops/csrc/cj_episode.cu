// CJP market-making episode kernel K8 for Hopper (sm_90a).
//
// Replaces the TPU kernel cj_episode_pallas
// (mbt_gym_tpu/ops/pallas_episode.py:409, pallas_call at :428): one whole
// CJP 2015 market-making episode per env, quoting from the closed-form
// depth table at each step, and only the terminal (cash, inventory, price,
// sum q_t^2) leaves the chip; the CjMm reward telescopes to those.
//
// Design: one thread per env, the step loop inside the thread, the state in
// registers.  The depth table is (T, 2Q+1, 2) floats (1.6 MB at the CJP
// shape, more than a block's shared memory); each step every thread of the
// card reads the same (2Q+1, 2) row through the read-only path (__ldg), so
// the row sits in L1/L2 and only the clipped inventory index varies per
// thread.  The TPU kernel's one-hot MXU contraction against the row selects
// the same single entry, so the gather is exact.
//
// Bounds on the H100: 16 bytes written per env and nothing read per step
// in native mode beyond the cached table row, so it is bound by
// operations: two Philox4x32-10 calls, logf/cosf/sqrtf and two expf per
// env-step.  At 16,384 envs only ~6% of the card's thread slots are busy,
// so it is latency-bound there.
//
// Numerics: every float op follows the plain PyTorch version's order
// (mbt_gym_torch/ops/cj_episode.py) under --fmad=false.  The JAX kernel
// draws the TPU's hardware bits only; this one takes K1's draws
// (draws.cuh): injected (T, 5, N) channels or native Philox, so on the same
// noise its terminal state equals K5's table stats mode on the same config.

#include <cstdint>
#include <cuda_runtime.h>

#include "draws.cuh"

// Mirrors CjKernelParams in mbt_gym_torch/ops/cj_episode.py (ctypes).
struct CjKernelParams {
  int n_steps;
  int q_cap;
  float p_arr_bid;
  float p_arr_ask;
  float neg_k;
  float max_inventory;  // fill mask: the env's bound, not q_cap
  float drift_dt;
  float vol_sqrt_dt;
  float initial_price;
};

namespace {

constexpr int kBlock = 128;

template <bool kNoise>
__global__ void __launch_bounds__(kBlock)
cj_episode_kernel(const CjKernelParams p, int n, uint32_t seed, const float* __restrict__ noise,
                  const float* __restrict__ table, float* __restrict__ cash_out,
                  float* __restrict__ inv_out, float* __restrict__ price_out,
                  float* __restrict__ sumq2_out) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= n) return;
  const int size = 2 * p.q_cap + 1;
  float cash = 0.0f, inv = 0.0f, price = p.initial_price, sumq2 = 0.0f;
  for (int i = 0; i < p.n_steps; ++i) {
    const mbt::Draws d = mbt::draws_for<kNoise>(noise, n, seed, env, i);
    const float qf = fminf(fmaxf(inv + static_cast<float>(p.q_cap), 0.0f), 2.0f * p.q_cap);
    const size_t at = (static_cast<size_t>(i) * size + static_cast<int>(qf)) * 2;
    const float bid = __ldg(table + at);
    const float ask = __ldg(table + at + 1);
    const float arr_bid = d.u_ab < p.p_arr_bid ? 1.0f : 0.0f;
    const float arr_ask = d.u_aa < p.p_arr_ask ? 1.0f : 0.0f;
    const float fill_bid = (d.u_fb < expf(p.neg_k * bid) ? 1.0f : 0.0f) * (inv < p.max_inventory ? 1.0f : 0.0f);
    const float fill_ask = (d.u_fa < expf(p.neg_k * ask) ? 1.0f : 0.0f) * (inv > -p.max_inventory ? 1.0f : 0.0f);
    const float hit_bid = arr_bid * fill_bid;
    const float hit_ask = arr_ask * fill_ask;
    inv = inv + hit_bid - hit_ask;
    cash = cash - hit_bid * (price - bid) + hit_ask * (price + ask);
    sumq2 = sumq2 + inv * inv;  // post-update inventory (RewardFunctions.py:103)
    price = price + p.drift_dt + p.vol_sqrt_dt * d.normal;
  }
  cash_out[env] = cash;
  inv_out[env] = inv;
  price_out[env] = price;
  sumq2_out[env] = sumq2;
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (0 on success).  `noise`
// is NULL in native (Philox) mode.
extern "C" int mbt_cj_episode(const CjKernelParams* p, int device, int n, uint32_t seed,
                              const float* noise, const float* table, float* cash, float* inv,
                              float* price, float* sumq2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const dim3 grid((n + kBlock - 1) / kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise) {
    cj_episode_kernel<true><<<grid, kBlock, 0, s>>>(*p, n, seed, noise, table, cash, inv, price, sumq2);
  } else {
    cj_episode_kernel<false><<<grid, kBlock, 0, s>>>(*p, n, seed, noise, table, cash, inv, price, sumq2);
  }
  return static_cast<int>(cudaGetLastError());
}
