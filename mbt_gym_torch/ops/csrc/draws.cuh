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
