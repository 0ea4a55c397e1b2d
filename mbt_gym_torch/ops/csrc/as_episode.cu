// Avellaneda-Stoikov whole-episode kernels for Hopper (sm_90a).
//
// K1 as_episode_kernel replaces the TPU kernel as_episode_pallas
//    (mbt_gym_tpu/ops/pallas_episode.py:233, pallas_call at :260 and :272):
//    one whole AS episode per env, only the terminal (cash, inventory,
//    price) leaves the chip.
// K2 as_traj_kernel replaces as_episode_trajectories_pallas
//    (mbt_gym_tpu/ops/pallas_episode.py:1074, pallas_call at :1173 and
//    :1211): the same episode, streaming the post-step state of every step
//    (emit state / full / container), or writing the rollout's time-major
//    Trajectory, which as_trajectory_from_pallas_full (:1224) assembles
//    from the full streams on the TPU.  The TPU kernel has no noise mode;
//    this one does, so it can be held to K1 and to the engine.
//
// Design: both run the warp-specialised step pipeline of step_pipeline.cuh
// (K5's, K6's and K8's too): per CTA, E / 32 consumer warps step the envs,
// one thread per env with the state (cash, inventory, price) in registers,
// while P producer warps compute the draws of the steps ahead into a ring
// of shared-memory slots (in noise mode the bulk-copy engine copies the
// (T, 5, N) channels' runs instead), so the consumers' chain per step is
// the closed-form quotes, two expf, the bookkeeping and, for K2, the
// step's stores; the geometry comes from step_pipeline.py::pipeline_geometry
// (K1 its "stats" mode, K2 its "as streams" mode, 16-step slots).  From the
// mode's threshold on (K1 65,536 envs, K2 20,480: wide_min_envs), where one
// thread per env fills the card and producers only add work, the wide
// shape runs: no ring, each thread draws its own draws in the same
// operation order, so the bits are the pipeline's.  One device function,
// run_episode, holds both shapes; K1 keeps the terminal state, K2 stores
// every step.  K2's streams are (T, N) with envs minor, so each warp's store
// of one step is one coalesced 128-byte line per plane.  Its fourth layout,
// which the rollout alone reaches, is the time-major Trajectory itself:
// per step one 16-byte (cash, inventory, time, price) of observations
// (T+1, N, 4) — 512 contiguous bytes a warp —, one 8-byte (bid, ask) of
// actions (T, N, 2) and the reward (T, N); each env's thread writes its
// initial row first.  No copy follows the kernel.
//
// Bounds on the H100: K1 in native mode moves 12 bytes per env, so it is
// bound by operations — two Philox4x32-10 calls (about 200 integer ops)
// plus logf/cosf/sqrtf/2x expf per env-step.  K2 writes 24 bytes per
// env-step (emit="full"; 28 in the trajectory layout) and is bound by
// bytes.  At 16,384 envs one thread per env leaves the card latency-bound
// on the draw chain; the pipeline moves that chain into the producers.  The
// design keeps every intermediate in registers, reads nothing per step in
// native mode, and writes each output once.
//
// Numerics: every float op follows the plain PyTorch version's order
// (mbt_gym_torch/ops/episode.py), and the build passes --fmad=false so no
// multiply-add is contracted.  Kernel and plain version therefore agree up
// to the libm functions, which are the same CUDA ones on the card.  The
// trajectory layout's time column is start_time + i * dt, the float32 ops
// the plain layout (episode.py::_observation_planes) takes, not the
// container plane's t + dt.
//
// Draws: native Philox4x32-10 or injected (T, 5, N) channels, in the
// layout of draws.cuh.

#include <cstdint>
#include <cuda_runtime.h>

#include "draws.cuh"
#include "step_pipeline.cuh"

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
  mbt::PipeGeometry pipe;  // the step pipeline's geometry (or the wide shape)
};

namespace {

using mbt::Draws;
using mbt::draws_for;

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

// One AS episode per env, in the shape the geometry picks.  The calling
// thread's env starts at (cash, inv, price); a thread that holds an env
// (env < n) calls first(env) before step 0 and after_step(env, i, t, bid,
// ask) once step i has moved the state to its post-step values.  Returns
// the env, or -1 for a thread that holds none (a producer warp's, or one
// past the last env).  In the pipeline every consumer thread runs the
// steps, with an env or without, since its warp hands each slot back as
// one.
template <bool kNoise, bool kWide, class First, class AfterStep>
__device__ __forceinline__ int run_episode(const AsKernelParams& p, int n, uint32_t seed,
                                           const float* __restrict__ noise, float& cash, float& inv,
                                           float& price, First first, AfterStep after_step) {
  if constexpr (kWide) {
    const int env = blockIdx.x * mbt::kWideEnvs + threadIdx.x;
    if (env >= n) return -1;
    first(env);
    for (int i = 0; i < p.run_steps; ++i) {
      const float t = step_time(p, i);
      float bid, ask;
      as_step(p, t, draws_for<kNoise>(noise, n, seed, env, i), cash, inv, price, bid, ask);
      after_step(env, i, t, bid, ask);
    }
    return env;
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    const mbt::StepRing ring(p.pipe, smem);
    const int warp = threadIdx.x >> 5;
    const int env0 = blockIdx.x * p.pipe.envs;
    if (warp >= ring.consumer_warps()) {
      ring.produce<kNoise, 5>(warp - ring.consumer_warps(), p.run_steps, env0, n, seed, noise,
                              [](int, int) { return static_cast<const float*>(nullptr); });  // no table
      return -1;
    }
    const int env = env0 + static_cast<int>(threadIdx.x);
    const bool active = env < n;
    if (active) first(env);
    ring.consume(p.run_steps, [&](int slot, int c0, int steps) {
      const mbt::SlotDraws<kNoise, 5> draws{ring.draws(slot) + threadIdx.x, noise + env0, n,
                                            mbt::draw_stride(p.pipe)};
      for (int j = 0; j < steps; ++j) {
        const int i = c0 + j;
        const float t = step_time(p, i);
        float bid, ask;
        as_step(p, t, draws.limit(j, i), cash, inv, price, bid, ask);
        if (active) after_step(env, i, t, bid, ask);
      }
    });
    return active ? env : -1;
  }
}

template <bool kNoise, bool kWide>
__global__ void __launch_bounds__(kWide ? mbt::kWideEnvs : mbt::kMaxPipeThreads)
as_episode_kernel(const AsKernelParams p, int n, uint32_t seed, const float* __restrict__ noise,
                  float* __restrict__ cash_out, float* __restrict__ inv_out,
                  float* __restrict__ price_out) {
  float cash = p.initial_cash, inv = p.initial_inventory, price = p.initial_price;
  const int env = run_episode<kNoise, kWide>(p, n, seed, noise, cash, inv, price, [](int) {},
                                             [](int, int, float, float, float) {});
  if (env < 0) return;
  cash_out[env] = cash;
  inv_out[env] = inv;
  price_out[env] = price;
}

// K1's and K2's geometry as the wrapper chose it, checked against what the
// kernels assume: draws only, five channels.
bool pipe_ok(const mbt::PipeGeometry& g) { return mbt::pipe_shape_ok(g, 5) && !g.staged; }

// Output buffers of K2.  emit="state" fills cash/inv/price; "full" adds
// reward/bid/ask; "container" adds time (the container's planes); the
// trajectory layout fills obs, actions and reward.
struct TrajOut {
  float* cash;
  float* inv;
  float* time;
  float* price;
  float* bid;
  float* ask;
  float* reward;
  float4* obs;      // (T+1, N): cash, inventory, time, price
  float2* actions;  // (T, N): bid, ask
};

enum Emit { kState = 0, kFull = 1, kContainer = 2, kTrajectory = 3 };

template <bool kNoise, bool kWide, int kEmit>
__global__ void __launch_bounds__(kWide ? mbt::kWideEnvs : mbt::kMaxPipeThreads)
as_traj_kernel(const AsKernelParams p, int n, uint32_t seed, const float* __restrict__ noise,
               const TrajOut out) {
  float cash = p.initial_cash, inv = p.initial_inventory, price = p.initial_price;
  float prev_value = cash + inv * price;
  const size_t sn = static_cast<size_t>(n);
  run_episode<kNoise, kWide>(
      p, n, seed, noise, cash, inv, price,
      [&](int env) {
        if constexpr (kEmit == kTrajectory) out.obs[env] = make_float4(cash, inv, step_time(p, 0), price);
      },
      [&](int env, int i, float t, float bid, float ask) {
        const size_t o = static_cast<size_t>(i) * sn + env;
        if constexpr (kEmit == kTrajectory) {
          const float value = cash + inv * price;
          out.obs[o + sn] = make_float4(cash, inv, step_time(p, i + 1), price);
          out.actions[o] = make_float2(bid, ask);
          out.reward[o] = value - prev_value;
          prev_value = value;
        } else {
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
          if constexpr (kEmit == kContainer) out.time[o] = t + p.dt;
        }
      });
}

template <int kEmit>
cudaError_t launch_traj(const AsKernelParams& p, int n, uint32_t seed, const float* noise, const TrajOut& out,
                        cudaStream_t s) {
  const bool wide = mbt::is_wide(p.pipe);
  if (noise) {
    return wide ? mbt::launch_pipeline(as_traj_kernel<true, true, kEmit>, p.pipe, n, s, p, n, seed, noise, out)
                : mbt::launch_pipeline(as_traj_kernel<true, false, kEmit>, p.pipe, n, s, p, n, seed, noise, out);
  }
  return wide ? mbt::launch_pipeline(as_traj_kernel<false, true, kEmit>, p.pipe, n, s, p, n, seed, noise, out)
              : mbt::launch_pipeline(as_traj_kernel<false, false, kEmit>, p.pipe, n, s, p, n, seed, noise, out);
}

int run_traj(const AsKernelParams* p, int device, int n, uint32_t seed, const float* noise, int emit,
             const TrajOut& out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (!pipe_ok(p->pipe)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (emit) {
    case kState: err = launch_traj<kState>(*p, n, seed, noise, out, s); break;
    case kFull: err = launch_traj<kFull>(*p, n, seed, noise, out, s); break;
    case kContainer: err = launch_traj<kContainer>(*p, n, seed, noise, out, s); break;
    case kTrajectory: err = launch_traj<kTrajectory>(*p, n, seed, noise, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's stream,
// allocates nothing and returns a CUDA error code (0 on success).  `noise`
// is NULL in native (Philox) mode.
extern "C" int mbt_as_episode(const AsKernelParams* p, int device, int n, uint32_t seed,
                              const float* noise, float* cash, float* inv, float* price,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (!pipe_ok(p->pipe)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = mbt::is_wide(p->pipe);
  if (noise) {
    err = wide ? mbt::launch_pipeline(as_episode_kernel<true, true>, p->pipe, n, s, *p, n, seed, noise, cash, inv, price)
               : mbt::launch_pipeline(as_episode_kernel<true, false>, p->pipe, n, s, *p, n, seed, noise, cash, inv, price);
  } else {
    err = wide ? mbt::launch_pipeline(as_episode_kernel<false, true>, p->pipe, n, s, *p, n, seed, noise, cash, inv, price)
               : mbt::launch_pipeline(as_episode_kernel<false, false>, p->pipe, n, s, *p, n, seed, noise, cash, inv, price);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K2's public emit modes (0 state, 1 full, 2 container): the (T, N) planes
// the mode fills, NULL for the others.
extern "C" int mbt_as_episode_trajectories(const AsKernelParams* p, int device, int n,
                                           uint32_t seed, const float* noise, int emit,
                                           float* cash, float* inv, float* time, float* price,
                                           float* bid, float* ask, float* reward, void* stream) {
  if (emit < kState || emit > kContainer) return static_cast<int>(cudaErrorInvalidValue);
  return run_traj(p, device, n, seed, noise, emit, TrajOut{cash, inv, time, price, bid, ask, reward, nullptr, nullptr},
                  stream);
}

// K2's trajectory layout: observations (T+1, N, 4), actions (T, N, 2) and
// rewards (T, N), each 16-byte aligned.
extern "C" int mbt_as_episode_trajectory(const AsKernelParams* p, int device, int n, uint32_t seed,
                                         const float* noise, float* obs, float* actions, float* rewards,
                                         void* stream) {
  const TrajOut out{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, rewards,
                    reinterpret_cast<float4*>(obs), reinterpret_cast<float2*>(actions)};
  return run_traj(p, device, n, seed, noise, kTrajectory, out, stream);
}
