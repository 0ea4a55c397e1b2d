// Avellaneda-Stoikov whole-episode kernels for Hopper (sm_90a).
//
// K1 as_episode_kernel replaces the TPU kernel as_episode_pallas
//    (mbt_gym_tpu/ops/pallas_episode.py:233, pallas_call at :260 and :272):
//    one whole AS episode per env, only the terminal (cash, inventory,
//    price) leaves the chip.
// K2 as_traj_kernel replaces as_episode_trajectories_pallas
//    (mbt_gym_tpu/ops/pallas_episode.py:1074, pallas_call at :1173 and
//    :1211): the same episode, streaming the post-step state of every step
//    (emit state / full / container).  The TPU kernel has no noise mode;
//    this one does, so it can be held to K1 and to the engine.
//
// Design: one thread per env, the run_steps loop inside the thread, the
// state (cash, inventory, price and, for K2, the previous mark-to-market
// value) in registers.  Streams are (T, N) with envs minor, so each warp's
// store of one step is one coalesced 128-byte line per plane.
//
// Bounds on the H100: K1 in native mode moves 12 bytes per env, so it is
// bound by operations — two Philox4x32-10 calls (about 200 integer ops)
// plus logf/cosf/sqrtf/2x expf per env-step.  K2 emit="full" writes 24
// bytes per env-step and is bound by bytes once enough envs are in flight
// (at 16k envs only ~12% of the card's thread slots are busy, so both are
// latency-bound there).  The design keeps every intermediate in registers,
// reads nothing per step in native mode, and writes each output once.
//
// Numerics: every float op follows the plain PyTorch version's order
// (mbt_gym_torch/ops/episode.py), and the build passes --fmad=false so no
// multiply-add is contracted.  Kernel and plain version therefore agree up
// to the libm functions, which are the same CUDA ones on the card.
//
// Native noise: Philox4x32-10 keyed by (seed, env) with counter
// (step, draw, 0, 0); draw 0 gives the four arrival/fill uniforms, draw 1
// the two Box-Muller uniforms.  Uniforms keep the top 24 bits.
// Noise mode reads (T, 5, N) float32 channels: arrival-bid u, arrival-ask
// u, fill-bid u, fill-ask u, midprice normal.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

// Mirrors AsKernelParams in mbt_gym_torch/ops/episode.py (ctypes).  Every
// float is the float32 rounding of the double the host computed, as the
// JAX kernel's Python-float constants are.
struct AsKernelParams {
  int run_steps;
  int risk_averse;     // risk_aversion > 0
  float start_time;
  float dt;
  float terminal_time;
  float p_arr_bid;     // intensity_bid * dt
  float p_arr_ask;     // intensity_ask * dt
  float neg_k;         // -fill_exponent
  float max_inventory;
  float max_cash;
  float drift_dt;      // drift * dt
  float vol_sqrt_dt;   // volatility * sqrt(dt)
  float initial_cash;
  float initial_inventory;
  float initial_price;
  float gss;           // gamma * sigma * sigma
  float half_gss;      // 0.5 * gamma * sigma * sigma
  float const_half;    // (1/gamma) log(1 + gamma/k), or 1/k when gamma == 0
};

namespace {

constexpr int kBlock = 128;
using mbt::kTwoPi;
using mbt::philox4x32_10;
using mbt::uniform24;

struct Draws {
  float u_ab, u_aa, u_fb, u_fa, normal;
};

__device__ __forceinline__ Draws philox_draws(uint32_t seed, uint32_t env, uint32_t step) {
  const uint2 key = make_uint2(seed, env);
  const uint4 a = philox4x32_10(make_uint4(step, 0u, 0u, 0u), key);
  const uint4 b = philox4x32_10(make_uint4(step, 1u, 0u, 0u), key);
  Draws d;
  d.u_ab = uniform24(a.x);
  d.u_aa = uniform24(a.y);
  d.u_fb = uniform24(a.z);
  d.u_fa = uniform24(a.w);
  const float u1 = 1.0f - uniform24(b.x);  // (0, 1] so logf is finite
  const float u2 = uniform24(b.y);
  d.normal = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
  return d;
}

__device__ __forceinline__ Draws noise_draws(const float* __restrict__ noise, int n, int env, int step) {
  const size_t base = static_cast<size_t>(step) * 5 * n + env;
  Draws d;
  d.u_ab = noise[base];
  d.u_aa = noise[base + n];
  d.u_fb = noise[base + 2 * static_cast<size_t>(n)];
  d.u_fa = noise[base + 3 * static_cast<size_t>(n)];
  d.normal = noise[base + 4 * static_cast<size_t>(n)];
  return d;
}

template <bool kNoise>
__device__ __forceinline__ Draws draws_for(const float* noise, int n, uint32_t seed, int env, int step) {
  if constexpr (kNoise) {
    return noise_draws(noise, n, env, step);
  } else {
    return philox_draws(seed, static_cast<uint32_t>(env), static_cast<uint32_t>(step));
  }
}

// One AS step on register state (pallas_episode.py:133-173): closed-form
// quotes, Bernoulli arrivals, exponential fills masked at +/-max_inventory,
// bookkeeping at the pre-step price, cash clip, BM price move.
__device__ __forceinline__ void as_step(const AsKernelParams& p, float t, const Draws& d,
                                        float& cash, float& inv, float& price,
                                        float& bid, float& ask) {
  if (p.risk_averse) {
    const float tau = p.terminal_time - t;
    const float skew = inv * p.gss * tau;
    const float half_spread = p.half_gss * tau + p.const_half;
    bid = skew + half_spread;
    ask = -skew + half_spread;
  } else {
    bid = p.const_half;
    ask = p.const_half;
  }
  const float arr_bid = d.u_ab < p.p_arr_bid ? 1.0f : 0.0f;
  const float arr_ask = d.u_aa < p.p_arr_ask ? 1.0f : 0.0f;
  float fill_bid = d.u_fb < expf(p.neg_k * bid) ? 1.0f : 0.0f;
  float fill_ask = d.u_fa < expf(p.neg_k * ask) ? 1.0f : 0.0f;
  fill_bid = fill_bid * (inv < p.max_inventory ? 1.0f : 0.0f);
  fill_ask = fill_ask * (inv > -p.max_inventory ? 1.0f : 0.0f);
  const float hit_bid = arr_bid * fill_bid;
  const float hit_ask = arr_ask * fill_ask;
  inv = inv + hit_bid - hit_ask;
  cash = cash - hit_bid * (price - bid) + hit_ask * (price + ask);
  cash = fminf(fmaxf(cash, -p.max_cash), p.max_cash);
  price = price + p.drift_dt + p.vol_sqrt_dt * d.normal;
}

__device__ __forceinline__ float step_time(const AsKernelParams& p, int i) {
  return p.start_time + static_cast<float>(i) * p.dt;
}

template <bool kNoise>
__global__ void __launch_bounds__(kBlock)
as_episode_kernel(const AsKernelParams p, int n, uint32_t seed, const float* __restrict__ noise,
                  float* __restrict__ cash_out, float* __restrict__ inv_out,
                  float* __restrict__ price_out) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= n) return;
  float cash = p.initial_cash, inv = p.initial_inventory, price = p.initial_price;
  for (int i = 0; i < p.run_steps; ++i) {
    float bid, ask;
    as_step(p, step_time(p, i), draws_for<kNoise>(noise, n, seed, env, i), cash, inv, price, bid, ask);
  }
  cash_out[env] = cash;
  inv_out[env] = inv;
  price_out[env] = price;
}

// Output planes of K2, in the container's plane order.  emit="state" fills
// cash/inv/price; "full" adds reward/bid/ask; "container" adds time.
struct TrajOut {
  float* cash;
  float* inv;
  float* time;
  float* price;
  float* bid;
  float* ask;
  float* reward;
};

enum Emit { kState = 0, kFull = 1, kContainer = 2 };

template <bool kNoise, int kEmit>
__global__ void __launch_bounds__(kBlock)
as_traj_kernel(const AsKernelParams p, int n, uint32_t seed, const float* __restrict__ noise,
               TrajOut out) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= n) return;
  float cash = p.initial_cash, inv = p.initial_inventory, price = p.initial_price;
  float prev_value = cash + inv * price;
  for (int i = 0; i < p.run_steps; ++i) {
    const float t = step_time(p, i);
    float bid, ask;
    as_step(p, t, draws_for<kNoise>(noise, n, seed, env, i), cash, inv, price, bid, ask);
    const size_t o = static_cast<size_t>(i) * n + env;
    out.cash[o] = cash;
    out.inv[o] = inv;
    out.price[o] = price;
    if constexpr (kEmit != kState) {
      const float value = cash + inv * price;
      out.reward[o] = value - prev_value;
      out.bid[o] = bid;
      out.ask[o] = ask;
      prev_value = value;
    }
    if constexpr (kEmit == kContainer) {
      out.time[o] = t + p.dt;
    }
  }
}

template <bool kNoise>
void launch_traj(const AsKernelParams& p, int n, uint32_t seed, const float* noise, int emit,
                 const TrajOut& out, cudaStream_t stream) {
  const dim3 grid((n + kBlock - 1) / kBlock);
  switch (emit) {
    case kState:
      as_traj_kernel<kNoise, kState><<<grid, kBlock, 0, stream>>>(p, n, seed, noise, out);
      break;
    case kFull:
      as_traj_kernel<kNoise, kFull><<<grid, kBlock, 0, stream>>>(p, n, seed, noise, out);
      break;
    default:
      as_traj_kernel<kNoise, kContainer><<<grid, kBlock, 0, stream>>>(p, n, seed, noise, out);
      break;
  }
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (0 on success).  `noise`
// is NULL in native (Philox) mode.
extern "C" int mbt_as_episode(const AsKernelParams* p, int device, int n, uint32_t seed,
                              const float* noise, float* cash, float* inv, float* price,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const dim3 grid((n + kBlock - 1) / kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise) {
    as_episode_kernel<true><<<grid, kBlock, 0, s>>>(*p, n, seed, noise, cash, inv, price);
  } else {
    as_episode_kernel<false><<<grid, kBlock, 0, s>>>(*p, n, seed, noise, cash, inv, price);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mbt_as_episode_trajectories(const AsKernelParams* p, int device, int n,
                                           uint32_t seed, const float* noise, int emit,
                                           float* cash, float* inv, float* time, float* price,
                                           float* bid, float* ask, float* reward, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const TrajOut out{cash, inv, time, price, bid, ask, reward};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise) {
    launch_traj<true>(*p, n, seed, noise, emit, out, s);
  } else {
    launch_traj<false>(*p, n, seed, noise, emit, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
