// Register-tiled dense products on CUDA cores, shared by the port's MLP
// kernels (mlp_rollout.cu, fused_ppo.cu).
//
// Activations live in shared memory feature-major, ``x[k * ldx + env]``;
// weights are read as ``w[k * ldw + row]`` (the layer's (in, out) matrix,
// or (out, in) for a product with the transpose).  A thread owns an
// RT x ET tile of (rows, envs) and sums k = 0 .. k_dim-1 in order with
// explicit fused multiply-adds.  With bf16 operands (values already rounded
// to bf16) every product is exact in float32, so the FMA equals the
// separately rounded multiply and add of the plain PyTorch versions; only
// the order of the sum differs from theirs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mbt {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x rounded to the matmul operand type: bf16 (kept in a float) or float.
template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (kBf16) {
    return round_bf16(x);
  } else {
    return x;
  }
}

__device__ __forceinline__ void load_w4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void load_w4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = lo.x;
  w[1] = lo.y;
  w[2] = hi.x;
  w[3] = hi.y;
}

template <int ET>
__device__ __forceinline__ void load_x(const float* p, float (&x)[ET]) {
  if constexpr (ET % 4 == 0) {
#pragma unroll
    for (int e = 0; e < ET; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + e);
      x[e] = v.x;
      x[e + 1] = v.y;
      x[e + 2] = v.z;
      x[e + 3] = v.w;
    }
  } else if constexpr (ET == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int e = 0; e < ET; ++e) x[e] = p[e];
  }
}

// acc[r][e] = sum_k w[k * ldw + r] * x[k * ldx + e], r < 4, e < ET.
// ``w`` is 8-byte (bf16) or 16-byte (float) aligned; ``x`` is aligned to
// ET floats (at most 16 bytes).
template <int ET, typename TW>
__device__ __forceinline__ void dense_tile(const TW* __restrict__ w, int ldw, const float* x,
                                           int ldx, int k_dim, float (&acc)[4][ET]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int e = 0; e < ET; ++e) acc[r][e] = 0.0f;
  }
#pragma unroll 4
  for (int k = 0; k < k_dim; ++k) {
    float wr[4];
    float xe[ET];
    load_w4(w + static_cast<size_t>(k) * ldw, wr);
    load_x<ET>(x + k * ldx, xe);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int e = 0; e < ET; ++e) acc[r][e] = __fmaf_rn(wr[r], xe[e], acc[r][e]);
    }
  }
}

}  // namespace mbt
