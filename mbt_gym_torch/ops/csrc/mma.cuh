// Warp-level tensor-core building blocks shared by the port's bf16 MLP
// kernels (fused_ppo.cu, mlp_rollout.cu): mma.sync.m16n8k16 with bf16
// operands and float32 sums.
//
// Activation tiles sit in shared memory feature-major, row k holding the
// tile's samples at a row stride of kLd bf16, a template parameter of each
// function that reads them.  kLd = (samples per tile) + 8 puts the 8 rows
// one ldmatrix phase reads in 8 distinct 16-byte bank groups (fused_ppo.cu:
// 32 samples, kLd = 40; mlp_rollout.cu: 128 envs, kLd = 136).
//
// Weight matrices come in mma fragment order (ops/mlp_rollout.py::
// pack_mma_a): the 16 x 16 A block (row block rb, k block kb) of an (R, K)
// matrix is 32 x 8 bf16 at (rb K / 16 + kb) kBlock, lane l's four registers
// the 16 bytes at 8 l, so each A fragment is one 16-byte load.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mbt {

constexpr int kBlock = 256;  // bf16 values of one 16 x 16 A block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and r[q] receives matrix q in the mma operand layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two 8x8 bf16 matrices, transposed: lanes 0-7 give the rows of matrix 0,
// lanes 8-15 those of matrix 1 (the other lanes' addresses are not read);
// r[q] receives matrix q in the mma operand layout.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void frag_from(uint32_t (&a)[4], const uint4 v) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    }
  }
}

// The ldmatrix.trans row address of this lane in a feature-major activation
// tile `act` (rows of stride kLd, offset to the first sample): matrices
// (k 0-7, samples 0-7), (k 8-15, 0-7), (k 0-7, 8-15), (k 8-15, 8-15) give
// the B fragments of two 8-sample tiles.
template <int kLd>
__device__ __forceinline__ const __nv_bfloat16* act_b_row(const __nv_bfloat16* act) {
  const int lane = threadIdx.x % 32, q = lane / 8;
  return act + ((q % 2) * 8 + lane % 8) * kLd + (q / 2) * 8;
}

// acc[mt][nt] += a[mt] * (NT 8-sample tiles of one 16-row k block), the k
// block's B fragments read at `b` (act_b_row of its first row).
template <int MT, int NT>
__device__ __forceinline__ void mma_k_block(const uint32_t (&a)[MT][4], const __nv_bfloat16* b,
                                            float (&acc)[MT][NT][4]) {
  static_assert(NT % 2 == 0, "ldmatrix.x4 gives two sample tiles");
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t f[4];
    ldmatrix_x4_trans(f, b + np * 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][2 * np], a[mt], f[0], f[1]);
      mma_bf16(acc[mt][2 * np + 1], a[mt], f[2], f[3]);
    }
  }
}

}  // namespace mbt
