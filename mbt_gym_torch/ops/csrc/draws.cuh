// One env-step's draws in the episode kernels' channel layout, shared by
// K1/K2 (as_episode.cu), K5 (det_rollout.cu), K6 (oe_episode.cu) and K8
// (cj_episode.cu).
//
// Noise mode reads (T, 5, N) float32 channels: arrival-bid u, arrival-ask u,
// fill-bid u, fill-ask u, midprice normal.  Native mode draws Philox4x32-10
// keyed by (seed, env) at counter (step, draw, 0, 0): draw 0 gives the four
// arrival/fill uniforms, draw 1 the Box-Muller pair of the midprice normal.
// mbt_gym_torch/ops/episode.py::philox_noise / philox_normal reproduce both
// bit for bit in PyTorch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace mbt {

struct Draws {
  float u_ab, u_aa, u_fb, u_fa, normal;
};

// The midprice normal alone (channel 4); the speed-dynamics kernels draw
// nothing else.
__device__ __forceinline__ float philox_normal(uint32_t seed, uint32_t env, uint32_t step) {
  const uint4 b = philox4x32_10(make_uint4(step, 1u, 0u, 0u), make_uint2(seed, env));
  const float u1 = 1.0f - uniform24(b.x);  // (0, 1] so logf is finite
  const float u2 = uniform24(b.y);
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

__device__ __forceinline__ Draws philox_draws(uint32_t seed, uint32_t env, uint32_t step) {
  const uint4 a = philox4x32_10(make_uint4(step, 0u, 0u, 0u), make_uint2(seed, env));
  Draws d;
  d.u_ab = uniform24(a.x);
  d.u_aa = uniform24(a.y);
  d.u_fb = uniform24(a.z);
  d.u_fa = uniform24(a.w);
  d.normal = philox_normal(seed, env, step);
  return d;
}

// The general process kinds' extra normals (K5, det_rollout.cu), from the
// midprice normal's own Philox call at counter (step, 1): its first pair
// (r0, theta0), words x and y, gives the midprice normal r0 cos theta0 (the
// bits of philox_normal) and the exogenous bid's r0 sin theta0; its second
// pair (r1, theta1), words z and w, the exogenous ask's r1 cos theta1 and
// the second midprice column's r1 sin theta1.
// mbt_gym_torch/ops/det_rollout.py::philox_noise reproduces them.
struct ExtraNormals {
  float normal, exo_bid, exo_ask, mid2;
};

__device__ __forceinline__ ExtraNormals philox_extra_normals(uint32_t seed, uint32_t env, uint32_t step) {
  const uint4 b = philox4x32_10(make_uint4(step, 1u, 0u, 0u), make_uint2(seed, env));
  const float r0 = sqrtf(-2.0f * logf(1.0f - uniform24(b.x)));
  const float th0 = kTwoPi * uniform24(b.y);
  const float r1 = sqrtf(-2.0f * logf(1.0f - uniform24(b.z)));
  const float th1 = kTwoPi * uniform24(b.w);
  return ExtraNormals{r0 * cosf(th0), r0 * sinf(th0), r1 * cosf(th1), r1 * sinf(th1)};
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

// The midprice normal of one step in either mode.
template <bool kNoise>
__device__ __forceinline__ float normal_for(const float* noise, int n, uint32_t seed, int env, int step) {
  if constexpr (kNoise) {
    return noise[static_cast<size_t>(step) * 5 * n + 4 * static_cast<size_t>(n) + env];
  } else {
    return philox_normal(seed, static_cast<uint32_t>(env), static_cast<uint32_t>(step));
  }
}

}  // namespace mbt
