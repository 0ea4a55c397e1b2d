// Philox4x32-10 (Salmon et al., SC'11) and the 24-bit uniform, shared by
// the port's kernels.  mbt_gym_torch/ops/episode.py::philox4x32_10
// reproduces the same stream in PyTorch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mbt {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The top 24 bits as a float in [0, 1).
__device__ __forceinline__ float uniform24(uint32_t x) {
  return static_cast<float>(x >> 8) * 0x1.0p-24f;
}

}  // namespace mbt
