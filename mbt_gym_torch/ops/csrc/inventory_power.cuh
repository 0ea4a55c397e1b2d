// The inventory power of the Cartea-Jaimungal rewards, shared by K3 and K5:
// the JAX kernels' q_pow (mbt_gym_tpu/ops/pallas_rollout.py:1142-1149),
// x * x at exponent 2, x at 1 and powf otherwise (reference semantics: NaN
// on a negative base with a fractional exponent).  The plain versions
// branch the same way (mbt_gym_torch/ops/det_rollout.py::q_pow).
#pragma once

#include <cuda_runtime.h>

namespace mbt {

__device__ __forceinline__ float q_pow(float x, float e) {
  if (e == 2.0f) return x * x;
  if (e == 1.0f) return x;
  return powf(x, e);
}

}  // namespace mbt
