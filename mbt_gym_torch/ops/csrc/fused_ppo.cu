// K4 and K7: the fused PPO minibatch gradient for Hopper (sm_90a).
//
// Replaces two TPU kernels of mbt_gym_tpu/ops/fused_ppo.py:
//   K4 ppo_fused_grads_T (_kernel_T, :174 and :392, pallas_call at :570):
//      feature-major inputs, obs (T, S, nb), actions (T, A, nb), old
//      log-prob, advantage and return (T, nb), each a strided view of one
//      env slice (envs minor, unit stride), so a minibatch is never copied;
//      both actor-critic layouts, the shared trunk and the separate pi/vf
//      towers (the JAX kernel's stacked-trunk split_at mode, :210-222,
//      :328-353 and :453-478).
//   K7 ppo_fused_grads (_kernel, :48 and :634, pallas_call at :716):
//      row-major inputs, obs (M, S), actions (M, A), old log-prob,
//      advantage and return (M,), the shared trunk.
// Both compute the forward pass, the PPO clipped surrogate with
// jnp.minimum's tie-splitting gradient, the value error, and from them
// every weight, bias and log_std gradient plus the pg/vf/kl sums, each
// gradient scaled by 1/M, M the minibatch's sample count
// (fused_ppo.py:108-160, :250-385).  The two share every line below but the
// input addressing, the kRowMajor template parameter: a K7 tile is 32
// consecutive samples of S (A) contiguous floats each, a K4 tile 32
// consecutive envs of one step.  Neither has the TPU kernels' 128-lane
// metrics row, lane-tile divisibility or VMEM tiling.
//
// Stacked towers (towers = 2, per-tower widths h0, h1): the carries are
// 2 h0 and 2 h1 wide, pi block first.  Layer 0 is one product over the
// stacked rows, since both towers read the observation; layer 1 and its
// transpose are one product per tower, row block t reading only block t of
// the layer below, so no block-diagonal padding is computed.  The merged
// (A+1, 2 h1) head holds the pi rows over the pi block and the vf row over
// the vf block with exact zeros elsewhere (the wrapper builds it): mean and
// value come from their own tower, the zero blocks add exact zeros to every
// in-block value, and the wrapper keeps only the in-block head gradients.
//
// Design: the float32 accumulator of a 256x256 weight gradient (256 KB;
// two of them with towers) exceeds the 227 KB of shared memory a block may
// hold, so the JAX kernels' one-program accumulation does not carry over;
// atomics into device memory would make the sum order change from run to
// run.  Three deterministic passes instead, over tiles of 32 samples:
//   pass 1, 256 CTAs, each a fixed contiguous range of tiles: the full
//     forward (activations of the tile in shared memory), the loss, and the
//     backward down to the input layer.  Per-CTA partial sums of every
//     gradient except dW1 (dW0, db0, db1, the head, log_std, metrics) and
//     the head-output gradient dmv (4 (A+1) B/sample) written to device
//     memory.
//   pass 2, (stacked h1 / 64) x 64 CTAs: each owns 64 rows of layer 1 (of
//     one tower) and a fixed range of tiles; it recomputes its tower's
//     layer-0 activations and its 64 rows of layer 1 (the same ordered sums
//     as pass 1, so the same values), forms its rows of dz2 from dmv and
//     holds its 64 x h0 slice of dW1 in registers.
//   pass 3: partial sums reduced over the CTAs in a fixed order.
// The recomputation costs ~1.35x the minimum FLOPs.  Every product runs on
// CUDA cores with explicit FMAs (dense.cuh); per-row sums over the 32
// samples of a tile are warp butterflies, also in a fixed order.
//
// Bound on the H100: operations.  Per sample at S = 4, 256x256, A = 2:
// forward 2*(4*256 + 256*256 + 3*256), backward the same again for dh and
// the weight gradients (~4.0e5 FLOP; about twice that with towers).  A
// 3,276,800-sample minibatch is 1.32 TFLOP: 1.33 ms at the bf16
// tensor-core peak, against 118 MB read (0.035 ms).  On CUDA cores at the
// 67 TFLOP/s float32 peak the floor is ~20 ms; tensor cores (wgmma) are
// later work.
//
// Numerics follow the plain PyTorch versions (ops/fused_ppo.py) in both
// compute dtypes.  bf16: every matmul operand rounded to bf16 with a
// float32 sum; the saved activations rounded to bf16 (fused_ppo.py:276);
// tanh' = 1 - h*h evaluated in bf16 (h*h rounded, then 1 - that rounded)
// before it multiplies the float32 dh (:314).  float32: no rounding.
// Bias gradients and metrics sum the unrounded float32 values.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense.cuh"

constexpr int kMaxObs = 8;
constexpr int kMaxAct = 4;

// Mirrors PpoKernelParams in mbt_gym_torch/ops/fused_ppo.py (ctypes).
struct PpoKernelParams {
  int n_steps;   // T (1 for row-major inputs)
  int n_envs;    // nb, envs of the minibatch (M for row-major inputs)
  int s_dim;
  int a_dim;
  int h0;        // per-tower widths
  int h1;
  int towers;    // 1: shared trunk; 2: stacked pi/vf towers
  float inv_m;        // 1 / M
  float clip_lo;      // 1 - clip_eps
  float clip_hi;      // 1 + clip_eps
  float vf_coef;
  float half_log_2pi; // 0.5 * log(2 pi)
};

// Strided float views.  Feature-major: element (t, c, env) at
// t * st + c * sc + env.  Row-major: element (sample, c) at
// sample * sc + c (st unused).
struct View {
  const float* ptr;
  long long st;
  long long sc;
};

struct PpoInputs {
  View obs, act, old_logp, adv, ret;
};

namespace {

constexpr int kThreads = 256;
constexpr int kE = 32;          // samples per tile
constexpr int kPass1Ctas = 256;
constexpr int kPass2Parts = 64;
constexpr int kRowBlock = 64;   // layer-1 rows per pass-2 CTA
constexpr int kRowsPerSweep = 4 * (kThreads / 4);  // rows one dense sweep covers (8 envs/thread)

template <bool kRowMajor>
__device__ __forceinline__ float load(const View& v, int t, int c, int env) {
  if constexpr (kRowMajor) {
    return v.ptr[static_cast<long long>(env) * v.sc + c];
  } else {
    return v.ptr[t * v.st + c * v.sc + env];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kBf16>
__device__ __forceinline__ float tanh_grad(float h) {
  if constexpr (kBf16) {
    return mbt::round_bf16(1.0f - mbt::round_bf16(h * h));
  } else {
    return 1.0f - h * h;
  }
}

__device__ __forceinline__ void tile_range(int n_tiles, int parts, int part, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(n_tiles) * part / parts);
  hi = static_cast<int>(static_cast<long long>(n_tiles) * (part + 1) / parts);
}

// Layout of one pass-1 partial over the stacked widths H0 = towers h0,
// H1 = towers h1: dW0 (H0, s) | db0 (H0) | db1 (H1) | dWh (a+1, H1) |
// dbh (a+1) | dlog_std (a) | metrics (3).
struct Part1Layout {
  int dw0, db0, db1, dwh, dbh, dlstd, metrics, total;
  __host__ __device__ explicit Part1Layout(const PpoKernelParams& p) {
    const int H0 = p.towers * p.h0, H1 = p.towers * p.h1;
    dw0 = 0;
    db0 = dw0 + H0 * p.s_dim;
    db1 = db0 + H0;
    dwh = db1 + H1;
    dbh = dwh + (p.a_dim + 1) * H1;
    dlstd = dbh + p.a_dim + 1;
    metrics = dlstd + p.a_dim;
    total = metrics + 3;
  }
};

// Loads a tile's observations, rounded to the operand type, into x[s][e].
// Row-major tiles are one contiguous run of 32 s floats, read in order.
template <bool kBf16, bool kRowMajor>
__device__ __forceinline__ void load_obs(const PpoKernelParams& p, const View& obs, int t, int env0,
                                         float* x) {
  for (int i = threadIdx.x; i < p.s_dim * kE; i += kThreads) {
    int s, e;
    if constexpr (kRowMajor) {
      e = i / p.s_dim;
      s = i % p.s_dim;
    } else {
      s = i / kE;
      e = i % kE;
    }
    x[s * kE + e] = mbt::operand<kBf16>(load<kRowMajor>(obs, t, s, env0 + e));
  }
}

// Layer 0 for the tile over `rows` rows of the stacked (s, ldw) matrix
// `wf0` (already offset to the first row): h1[k][e] = op(tanh(W0 x + b0));
// also h1t[e][k] when given.
template <bool kBf16, typename TW>
__device__ __forceinline__ void layer0(const PpoKernelParams& p, const TW* wf0, int ldw, const float* b0,
                                       int rows, const float* x, float* h1, float* h1t) {
  const int rg = threadIdx.x % 64, eg = threadIdx.x / 64;
  for (int r0 = rg * 4; r0 < rows; r0 += kRowsPerSweep) {
    float acc[4][8];
    mbt::dense_tile<8>(wf0 + r0, ldw, x + eg * 8, kE, p.s_dim, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = r0 + r;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float h = mbt::operand<kBf16>(tanhf(acc[r][e] + b0[k]));
        h1[k * kE + eg * 8 + e] = h;
        if (h1t) h1t[(eg * 8 + e) * rows + k] = h;
      }
    }
  }
}

template <bool kBf16, bool kRowMajor, typename TW>
__global__ void __launch_bounds__(kThreads, 2)
ppo_pass1(const PpoKernelParams p, const PpoInputs in, const TW* __restrict__ wf0,
          const TW* __restrict__ wf1, const TW* __restrict__ wb1, const float* __restrict__ bias,
          const float* __restrict__ w_head, const float* __restrict__ b_head,
          const float* __restrict__ log_std, float* __restrict__ dmv_out, float* __restrict__ part1) {
  extern __shared__ __align__(16) float sm[];
  const Part1Layout lay(p);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_head = p.a_dim + 1;
  const int H0 = p.towers * p.h0, H1 = p.towers * p.h1;
  float* x = sm;                          // [s][kE]
  float* h1 = x + kMaxObs * kE;           // [H0][kE]; later dz1
  float* h2 = h1 + H0 * kE;               // [H1][kE]; later dz2
  float* mv = h2 + H1 * kE;               // [a+1][kE]; later dmv
  float* hw = mv + n_head * kE;           // [a+1][H1] head weights (operands)
  float* acc = hw + n_head * H1;          // Part1Layout
  const float* b0 = bias;
  const float* b1 = bias + H0;

  for (int i = tid; i < n_head * H1; i += kThreads) hw[i] = w_head[i];
  for (int i = tid; i < lay.total; i += kThreads) acc[i] = 0.0f;

  float lstd[kMaxAct], inv_std[kMaxAct];
  for (int a = 0; a < p.a_dim; ++a) {
    lstd[a] = log_std[a];
    inv_std[a] = expf(-lstd[a]);
  }
  const float cv = p.vf_coef * p.inv_m;
  const int tiles_per_step = p.n_envs / kE;
  int lo, hi;
  tile_range(p.n_steps * tiles_per_step, gridDim.x, blockIdx.x, lo, hi);
  __syncthreads();

  const int rg = tid % 64, eg = tid / 64;
  for (int q = lo; q < hi; ++q) {
    const int t = q / tiles_per_step, env0 = (q % tiles_per_step) * kE;
    load_obs<kBf16, kRowMajor>(p, in.obs, t, env0, x);
    __syncthreads();
    layer0<kBf16>(p, wf0, H0, b0, H0, x, h1, nullptr);
    __syncthreads();
    // layer 1, one product per tower: rows [tw h1, (tw+1) h1) read h1 rows
    // [tw h0, (tw+1) h0)
    for (int j0 = rg * 4; j0 < H1; j0 += kRowsPerSweep) {
      const int tw = j0 / p.h1;
      float a4[4][8];
      mbt::dense_tile<8>(wf1 + static_cast<size_t>(tw) * p.h0 * p.h1 + (j0 - tw * p.h1), p.h1,
                         h1 + tw * p.h0 * kE + eg * 8, kE, p.h0, a4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + r;
#pragma unroll
        for (int e = 0; e < 8; ++e) h2[j * kE + eg * 8 + e] = mbt::operand<kBf16>(tanhf(a4[r][e] + b1[j]));
      }
    }
    __syncthreads();
    if (tid < n_head * kE) {  // merged head
      const int a = tid / kE, e = tid % kE;
      float s = 0.0f;
      for (int k = 0; k < H1; ++k) s = __fmaf_rn(hw[a * H1 + k], h2[k * kE + e], s);
      mv[a * kE + e] = s + b_head[a];
    }
    __syncthreads();

    if (warp == 0) {  // loss and its gradient, one lane per sample
      const int env = env0 + lane;
      float z[kMaxAct];
      float logp = 0.0f;
      for (int a = 0; a < p.a_dim; ++a) {
        const float act = load<kRowMajor>(in.act, t, a, env);
        z[a] = (act - mv[a * kE + lane]) * inv_std[a];
        logp = logp + (((-0.5f * z[a]) * z[a] - lstd[a]) - p.half_log_2pi);
      }
      const float v = mv[p.a_dim * kE + lane];
      const float old = load<kRowMajor>(in.old_logp, t, 0, env);
      const float adv = load<kRowMajor>(in.adv, t, 0, env);
      const float ret = load<kRowMajor>(in.ret, t, 0, env);
      const float ratio = expf(logp - old);
      const float pg1 = ratio * adv;
      const float pg2 = fminf(fmaxf(ratio, p.clip_lo), p.clip_hi) * adv;
      const float vf_err = v - ret;
      const float inside = (ratio > p.clip_lo && ratio < p.clip_hi) ? 1.0f : 0.0f;
      const float take1 = pg1 < pg2 ? 1.0f : 0.0f;
      const float tie = pg1 == pg2 ? 1.0f : 0.0f;
      const float branch = take1 + (1.0f - take1 - tie) * inside + 0.5f * tie * (1.0f + inside);
      const float dratio = -(adv * p.inv_m) * branch;
      const float dlogp = dratio * ratio;
      const float dv = cv * vf_err;
      float sums[2 * kMaxAct + 4];
      for (int a = 0; a < p.a_dim; ++a) {
        const float dmean = dlogp * (z[a] * inv_std[a]);
        mv[a * kE + lane] = dmean;
        dmv_out[(static_cast<size_t>(a) * p.n_steps + t) * p.n_envs + env] = dmean;
        sums[a] = dmean;
        sums[n_head + a] = dlogp * (z[a] * z[a] - 1.0f);
      }
      mv[p.a_dim * kE + lane] = dv;
      dmv_out[(static_cast<size_t>(p.a_dim) * p.n_steps + t) * p.n_envs + env] = dv;
      sums[p.a_dim] = dv;
      const int m0 = n_head + p.a_dim;
      sums[m0] = -fminf(pg1, pg2);
      sums[m0 + 1] = (0.5f * vf_err) * vf_err;
      sums[m0 + 2] = old - logp;
      for (int i = 0; i < m0 + 3; ++i) {
        const float s = warp_sum(sums[i]);
        if (lane == 0) acc[lay.dbh + i] += s;  // dbh | dlstd | metrics are contiguous
      }
    }
    __syncthreads();

    // head grads, dh2 -> dz2 (rows of layer 1, one warp per row)
    for (int j = warp; j < H1; j += kThreads / 32) {
      const float h = h2[j * kE + lane];
      float dh = 0.0f;
      for (int a = 0; a < n_head; ++a) {
        const float d = mbt::operand<kBf16>(mv[a * kE + lane]);
        const float s = warp_sum(d * h);
        if (lane == 0) acc[lay.dwh + a * H1 + j] += s;
        dh = __fmaf_rn(hw[a * H1 + j], d, dh);
      }
      const float dz = dh * tanh_grad<kBf16>(h);
      const float s = warp_sum(dz);
      if (lane == 0) acc[lay.db1 + j] += s;
      h2[j * kE + lane] = mbt::operand<kBf16>(dz);
    }
    __syncthreads();

    // dh1 = W1^T dz2 per tower, then dz1 = dh1 * tanh'(h1) in place of h1
    for (int k0 = rg * 4; k0 < H0; k0 += kRowsPerSweep) {
      const int tw = k0 / p.h0;
      float a4[4][8];
      mbt::dense_tile<8>(wb1 + static_cast<size_t>(tw) * p.h1 * p.h0 + (k0 - tw * p.h0), p.h0,
                         h2 + tw * p.h1 * kE + eg * 8, kE, p.h1, a4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + r;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float* cell = h1 + k * kE + eg * 8 + e;
          *cell = a4[r][e] * tanh_grad<kBf16>(*cell);
        }
      }
    }
    __syncthreads();

    // layer-0 grads, one warp per row
    for (int k = warp; k < H0; k += kThreads / 32) {
      const float dz = h1[k * kE + lane];
      const float s = warp_sum(dz);
      if (lane == 0) acc[lay.db0 + k] += s;
      const float d = mbt::operand<kBf16>(dz);
      for (int c = 0; c < p.s_dim; ++c) {
        const float w = warp_sum(d * x[c * kE + lane]);
        if (lane == 0) acc[lay.dw0 + k * p.s_dim + c] += w;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < lay.total; i += kThreads) part1[static_cast<size_t>(blockIdx.x) * lay.total + i] = acc[i];
}

template <bool kBf16, bool kRowMajor, typename TW>
__global__ void __launch_bounds__(kThreads, 2)
ppo_pass2(const PpoKernelParams p, const PpoInputs in, const TW* __restrict__ wf0,
          const TW* __restrict__ wf1, const float* __restrict__ bias,
          const float* __restrict__ w_head, const float* __restrict__ dmv_in,
          float* __restrict__ part2) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int n_head = p.a_dim + 1;
  const int H0 = p.towers * p.h0, H1 = p.towers * p.h1;
  const int row0 = blockIdx.x * kRowBlock;  // stacked layer-1 row
  const int tw = row0 / p.h1;               // its tower
  const int part = blockIdx.y;
  float* x = sm;                        // [s][kE]
  float* h1 = x + kMaxObs * kE;         // [h0][kE], the tower's layer-0 rows
  float* h1t = h1 + p.h0 * kE;          // [kE][h0]
  float* dmv = h1t + kE * p.h0;         // [a+1][kE], operands
  float* dz2t = dmv + n_head * kE;      // [kE][64]
  float* hw = dz2t + kE * kRowBlock;    // [a+1][64] head weights of these rows
  const float* b0 = bias + tw * p.h0;
  const float* b1 = bias + H0;
  const TW* w1 = wf1 + static_cast<size_t>(tw) * p.h0 * p.h1 + (row0 - tw * p.h1);

  for (int i = tid; i < n_head * kRowBlock; i += kThreads) {
    hw[i] = w_head[(i / kRowBlock) * H1 + row0 + i % kRowBlock];
  }
  const int kq = p.h0 / 4;  // dW1 columns per thread
  const int r_own = tid % kRowBlock, kb = tid / kRowBlock;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  const int tiles_per_step = p.n_envs / kE;
  int lo, hi;
  tile_range(p.n_steps * tiles_per_step, gridDim.y, part, lo, hi);
  const int rg = tid % 16, eg = tid / 16;  // layer-1 rows 4 x 16 groups, envs 2 x 16 groups
  __syncthreads();
  for (int q = lo; q < hi; ++q) {
    const int t = q / tiles_per_step, env0 = (q % tiles_per_step) * kE;
    load_obs<kBf16, kRowMajor>(p, in.obs, t, env0, x);
    for (int i = tid; i < n_head * kE; i += kThreads) {
      const int a = i / kE, e = i % kE;
      dmv[i] = mbt::operand<kBf16>(dmv_in[(static_cast<size_t>(a) * p.n_steps + t) * p.n_envs + env0 + e]);
    }
    __syncthreads();
    layer0<kBf16>(p, wf0 + tw * p.h0, H0, b0, p.h0, x, h1, h1t);
    __syncthreads();
    {
      float a4[4][2];
      mbt::dense_tile<2>(w1 + rg * 4, p.h1, h1 + eg * 2, kE, p.h0, a4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jl = rg * 4 + r, j = row0 + jl;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int el = eg * 2 + e;
          const float h = mbt::operand<kBf16>(tanhf(a4[r][e] + b1[j]));
          float dh = 0.0f;
          for (int a = 0; a < n_head; ++a) dh = __fmaf_rn(hw[a * kRowBlock + jl], dmv[a * kE + el], dh);
          dz2t[el * kRowBlock + jl] = mbt::operand<kBf16>(dh * tanh_grad<kBf16>(h));
        }
      }
    }
    __syncthreads();
    for (int e = 0; e < kE; ++e) {
      const float d = dz2t[e * kRowBlock + r_own];
      const float* hrow = h1t + e * p.h0 + kb * kq;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        if (i < kq) {
          const float4 hv = *reinterpret_cast<const float4*>(hrow + i);
          acc[i] = __fmaf_rn(d, hv.x, acc[i]);
          acc[i + 1] = __fmaf_rn(d, hv.y, acc[i + 1]);
          acc[i + 2] = __fmaf_rn(d, hv.z, acc[i + 2]);
          acc[i + 3] = __fmaf_rn(d, hv.w, acc[i + 3]);
        }
      }
    }
    __syncthreads();
  }
  float* out = part2 + (static_cast<size_t>(part) * H1 + row0 + r_own) * p.h0 + kb * kq;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i < kq) out[i] = acc[i];
  }
}

// out[i] = sum over parts p (in order) of part[p * n + i]
__global__ void reduce_parts(const float* __restrict__ part, int parts, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int q = 0; q < parts; ++q) s += part[static_cast<size_t>(q) * n + i];
  out[i] = s;
}

template <bool kBf16, bool kRowMajor>
int launch(const PpoKernelParams& p, const PpoInputs& in, const void* wf0, const void* wf1,
           const void* wb1, const float* bias, const float* w_head, const float* b_head,
           const float* log_std, float* dmv, float* part1, float* part2, float* out_small,
           float* out_dw1, cudaStream_t stream) {
  using TW = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  const int n_head = p.a_dim + 1;
  const int H0 = p.towers * p.h0, H1 = p.towers * p.h1;
  const Part1Layout lay(p);
  const size_t smem1 = sizeof(float) * (kMaxObs * kE + (H0 + H1 + n_head) * kE + n_head * H1 + lay.total);
  const size_t smem2 = sizeof(float) * (kMaxObs * kE + 2 * p.h0 * kE + n_head * kE + kE * kRowBlock + n_head * kRowBlock);
  auto* pass1 = ppo_pass1<kBf16, kRowMajor, TW>;
  auto* pass2 = ppo_pass2<kBf16, kRowMajor, TW>;
  cudaError_t err = cudaFuncSetAttribute(pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(pass2, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  pass1<<<kPass1Ctas, kThreads, smem1, stream>>>(
      p, in, static_cast<const TW*>(wf0), static_cast<const TW*>(wf1), static_cast<const TW*>(wb1),
      bias, w_head, b_head, log_std, dmv, part1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pass2<<<dim3(H1 / kRowBlock, kPass2Parts), kThreads, smem2, stream>>>(
      p, in, static_cast<const TW*>(wf0), static_cast<const TW*>(wf1), bias, w_head, dmv, part2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_parts<<<(lay.total + 255) / 256, 256, 0, stream>>>(part1, kPass1Ctas, lay.total, out_small);
  const int n_dw1 = H1 * p.h0;
  reduce_parts<<<(n_dw1 + 255) / 256, 256, 0, stream>>>(part2, kPass2Parts, n_dw1, out_dw1);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRowMajor>
int launch_dtype(const PpoKernelParams* p, int device, const PpoInputs* in, int bf16, const void* wf0,
                 const void* wf1, const void* wb1, const float* bias, const float* w_head,
                 const float* b_head, const float* log_std, float* dmv, float* part1, float* part2,
                 float* out_small, float* out_dw1, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<true, kRowMajor>(*p, *in, wf0, wf1, wb1, bias, w_head, b_head, log_std, dmv, part1,
                                   part2, out_small, out_dw1, s);
  }
  return launch<false, kRowMajor>(*p, *in, wf0, wf1, wb1, bias, w_head, b_head, log_std, dmv, part1,
                                  part2, out_small, out_dw1, s);
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's
// stream, allocates nothing and returns the first CUDA error (0 on
// success).  Weights, with H0 = towers h0 and H1 = towers h1: `wf0`
// (s, H0) layer 0's stacked (in, out) matrix; `wf1` (towers, h0, h1) each
// tower's layer-1 (in, out) matrix; `wb1` (towers, h1, h0) each tower's
// layer-1 (out, in) matrix; all bf16 when `bf16` is set and float
// otherwise.  `bias` is b0 (H0) then b1 (H1); `w_head` (a+1, H1) is float,
// already rounded to bf16 in bf16 mode, zero off its towers' blocks.
// Scratch: `dmv` (a+1, M), `part1` (256, Part1Layout), `part2`
// (64, H1, h0).  Results: `out_small` in Part1Layout order and `out_dw1`
// (H1, h0).  The minibatch's sample count must be a multiple of 32, h0 and
// h1 multiples of 64 and at most 256.

// K4: feature-major views, p->n_steps = T, p->n_envs = nb.
extern "C" int mbt_ppo_fused_grads_T(const PpoKernelParams* p, int device, const PpoInputs* in,
                                     int bf16, const void* wf0, const void* wf1, const void* wb1,
                                     const float* bias, const float* w_head, const float* b_head,
                                     const float* log_std, float* dmv, float* part1, float* part2,
                                     float* out_small, float* out_dw1, void* stream) {
  return launch_dtype<false>(p, device, in, bf16, wf0, wf1, wb1, bias, w_head, b_head, log_std, dmv,
                             part1, part2, out_small, out_dw1, stream);
}

// K7: row-major views, p->n_steps = 1, p->n_envs = M.
extern "C" int mbt_ppo_fused_grads(const PpoKernelParams* p, int device, const PpoInputs* in,
                                   int bf16, const void* wf0, const void* wf1, const void* wb1,
                                   const float* bias, const float* w_head, const float* b_head,
                                   const float* log_std, float* dmv, float* part1, float* part2,
                                   float* out_small, float* out_dw1, void* stream) {
  return launch_dtype<true>(p, device, in, bf16, wf0, wf1, wb1, bias, w_head, b_head, log_std, dmv,
                            part1, part2, out_small, out_dw1, stream);
}
