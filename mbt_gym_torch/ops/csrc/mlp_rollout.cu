// K3: the fused PPO collection episode for Hopper (sm_90a).
//
// Replaces the TPU kernel mlp_rollout_pallas
// (mbt_gym_tpu/ops/pallas_rollout.py:1514, pallas_call at :1634) for the
// MLP policy on the "limit" family: BM midprice, Poisson arrivals,
// exponential fills, limit-order dynamics, PnL reward, fixed start time
// and initial inventory, both actor-critic layouts.  Each step, per env:
// the (normalised) observation, the trunk h = tanh(W h + b) layer by
// layer, the merged (A+1)-row head giving mean and value, the Gaussian
// sample and its log-prob, the clipped and denormalised action, then the
// env step (pallas_rollout.py:724-754, 849-897, 992-1006, 1078-1153).
// Outputs: obs (T, S, N) as the policy saw it, the unclipped action
// (T, A, N), log-prob, value and reward (T, N).
//
// Design: one CTA of 256 threads owns a tile of 32 envs for all steps; the
// env state lives in the registers of the first warp (one lane per env).
// Per step the activations of the tile sit in shared memory feature-major
// ([width][32] floats) and each layer is a register-tiled product on CUDA
// cores (dense.cuh): a thread computes 4 output rows x 8 envs.  The head
// (A+1 rows) and the env step follow; only the ~36 B/env-step outputs are
// written to device memory, each warp's store one coalesced 128-B line.
//
// Bound on the H100: operations.  At config 5 (262,144 envs x 200 steps,
// 256x256 trunk) the matmuls are 134,656 FLOP per env-step (7.06 TFLOP),
// 7.1 ms at the bf16 tensor-core peak, against 1.89 GB of outputs
// (0.56 ms).  This kernel runs those FLOPs on CUDA cores (67 TFLOP/s
// float32 peak, ~105 ms at best); moving the trunk to wgmma is later work.
// In bf16 mode the weights are staged once per CTA in shared memory as
// bf16 (133 KB at 256x256), so the per-step products read no device
// memory; in float32 mode (raw observations) they are read through L1/L2.
//
// Separate pi/vf towers (the JAX kernel's stacked-trunk split_at mode,
// pallas_rollout.py:668-712 and :858-873): the bf16 weights of two 256x256
// towers (266 KB) do not fit the 227 KB of shared memory an H100 block may
// hold, and the env step needs only the pi tower's mean.  So a CTA runs its
// episode in two phases: phase 1 stages the pi tower and runs the steps
// above with the pi head's A rows (the value is not written); phase 2
// restages the same buffers with the vf tower and, step by step, reads
// back the observations its own threads wrote in phase 1 and writes the vf
// head's value.  Each tower's products are those of the JAX kernel's
// stacked trunk (layer 0's stacked rows are independent dot products, the
// inner layers per-tower products, the merged head's zero blocks add exact
// zeros), so the values are the same sums.  Both phases are one launch.
//
// Numerics follow the plain PyTorch version (ops/mlp_rollout.py):
// with normalised observations every matmul operand is rounded to bf16
// (round to nearest even) with a float32 sum; otherwise all float32.
// Biases, tanh and everything after are float32.  A layer's output is
// stored rounded to the operand type; its only uses are as the next
// product's operand, which rounds it anyway.  The env step repeats the
// plain version's float32 op order (build flag --fmad=false; the products
// use explicit FMAs, exact on bf16 operands).
//
// Noise: noise mode reads (T, 7, N) channels in the JAX order (u_arr_bid,
// u_arr_ask, u_fill_bid, u_fill_ask, eps0, eps1, mid normal).  Native mode
// draws Philox4x32-10 keyed by (seed, env) with counter (step, draw, 0, 0):
// draw 0 gives the four uniforms, draw 1 four Box-Muller uniforms
// u0..u3 -> r_j = sqrt(-2 log(1 - u_j)), theta_j = 2 pi u_{2+j};
// eps0 = r0 cos theta0, eps1 = r1 cos theta1, mid = r0 sin theta0.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense.cuh"
#include "philox.cuh"

constexpr int kMaxLayers = 8;
constexpr int kMaxObs = 8;
constexpr int kMaxAct = 4;

// Mirrors MlpKernelParams in mbt_gym_torch/ops/mlp_rollout.py (ctypes).
struct MlpKernelParams {
  int run_steps;
  int n_layers;
  int s_dim;
  int a_dim;
  int normalise_obs;
  int normalise_act;
  int widths[kMaxLayers];
  float start_time;
  float dt;
  float obs_low[kMaxObs];
  float obs_grad[kMaxObs];
  float act_low[kMaxAct];
  float act_grad[kMaxAct];
  float act_high[kMaxAct];
  float p_arr_bid;
  float p_arr_ask;
  float neg_k;
  float max_inventory;
  float max_cash;
  float drift_dt;
  float vol_sqrt_dt;
  float initial_cash;
  float initial_inventory;
  float initial_price;
  float logp_const;  // 0.5 * log(2 pi) * a_dim
};

struct RolloutOut {
  float* obs;
  float* act;
  float* logp;
  float* value;
  float* reward;
};

namespace {

constexpr int kThreads = 256;
constexpr int kE = 32;   // envs per CTA
constexpr int kET = 8;   // envs per thread in a layer
constexpr int kRowGroups = kThreads / (kE / kET);  // 64 groups of 4 rows
constexpr int kNoiseChannels = 7;

struct Draws {
  float u_ab, u_aa, u_fb, u_fa, eps0, eps1, mid;
};

__device__ __forceinline__ Draws draws_at(const float* noise, int n, uint32_t seed, int env, int step) {
  Draws d;
  if (noise) {
    const size_t base = static_cast<size_t>(step) * kNoiseChannels * n + env;
    d.u_ab = noise[base];
    d.u_aa = noise[base + static_cast<size_t>(n)];
    d.u_fb = noise[base + 2 * static_cast<size_t>(n)];
    d.u_fa = noise[base + 3 * static_cast<size_t>(n)];
    d.eps0 = noise[base + 4 * static_cast<size_t>(n)];
    d.eps1 = noise[base + 5 * static_cast<size_t>(n)];
    d.mid = noise[base + 6 * static_cast<size_t>(n)];
    return d;
  }
  const uint2 key = make_uint2(seed, static_cast<uint32_t>(env));
  const uint4 a = mbt::philox4x32_10(make_uint4(static_cast<uint32_t>(step), 0u, 0u, 0u), key);
  const uint4 b = mbt::philox4x32_10(make_uint4(static_cast<uint32_t>(step), 1u, 0u, 0u), key);
  d.u_ab = mbt::uniform24(a.x);
  d.u_aa = mbt::uniform24(a.y);
  d.u_fb = mbt::uniform24(a.z);
  d.u_fa = mbt::uniform24(a.w);
  const float r0 = sqrtf(-2.0f * logf(1.0f - mbt::uniform24(b.x)));
  const float r1 = sqrtf(-2.0f * logf(1.0f - mbt::uniform24(b.y)));
  const float th0 = mbt::kTwoPi * mbt::uniform24(b.z);
  const float th1 = mbt::kTwoPi * mbt::uniform24(b.w);
  d.eps0 = r0 * cosf(th0);
  d.eps1 = r1 * cosf(th1);
  d.mid = r0 * sinf(th0);
  return d;
}

// One tower's weights: each layer's (in, out) matrix and bias, layers
// concatenated, then the head rows it feeds.
template <typename TW>
struct TowerWeights {
  const TW* w_t;
  const float* bias;
  const float* w_head;  // (head_rows, h_last)
  const float* b_head;  // (head_rows,)
  int head_rows;
};

// Buffers of one CTA in shared memory.
struct Smem {
  float* act0;
  float* act1;
  float* head_w;
  float* head_o;
  float* bias_s;
};

// Stages a tower's head and biases (and, when `w_s`, its weights) into
// shared memory; returns the weights the products read.
template <typename TW>
__device__ const TW* stage(const TowerWeights<TW>& tw, const Smem& sm, TW* w_s, int w_total, int b_total,
                           int h_last) {
  for (int i = threadIdx.x; i < tw.head_rows * h_last; i += kThreads) sm.head_w[i] = tw.w_head[i];
  for (int i = threadIdx.x; i < b_total; i += kThreads) sm.bias_s[i] = tw.bias[i];
  if (w_s) {
    for (int i = threadIdx.x; i < w_total; i += kThreads) w_s[i] = tw.w_t[i];
    return w_s;
  }
  return tw.w_t;
}

// The trunk h = tanh(W h + b), layer by layer, from act0 (the tile's
// observation, operand-rounded) through the ping-pong buffers, then the
// head's rows into head_o.  Ends after a barrier.
template <bool kBf16, typename TW>
__device__ void forward(const MlpKernelParams& p, const TW* w, const Smem& sm, int head_rows,
                        const float* b_head) {
  const int tid = threadIdx.x;
  const int rg = tid % kRowGroups;
  const int eg = tid / kRowGroups;
  float* in = sm.act0;
  float* o = sm.act1;
  int k_dim = p.s_dim;
  size_t w_off = 0;
  int b_off = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const int out_dim = p.widths[l];
    if (rg * 4 < out_dim) {
      float acc[4][kET];
      mbt::dense_tile<kET>(w + w_off + rg * 4, out_dim, in + eg * kET, kE, k_dim, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float b = sm.bias_s[b_off + rg * 4 + r];
#pragma unroll
        for (int e = 0; e < kET; ++e) {
          o[(rg * 4 + r) * kE + eg * kET + e] = mbt::operand<kBf16>(tanhf(acc[r][e] + b));
        }
      }
    }
    __syncthreads();
    w_off += static_cast<size_t>(k_dim) * out_dim;
    b_off += out_dim;
    k_dim = out_dim;
    float* tmp = in;
    in = o;
    o = tmp;
  }
  if (tid < head_rows * kE) {
    const int a = tid / kE, e = tid % kE;
    float s = 0.0f;
    for (int k = 0; k < k_dim; ++k) s = __fmaf_rn(sm.head_w[a * k_dim + k], in[k * kE + e], s);
    sm.head_o[a * kE + e] = s + b_head[a];
  }
  __syncthreads();
}

// `vf.w_t` is NULL for the shared trunk, whose merged head (A+1 rows, the
// value last) is `pi`'s; with towers `pi` holds the pi tower and its A head
// rows and `vf` the vf tower and its value row.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
mlp_rollout_kernel(const MlpKernelParams p, int n, int h_max, uint32_t seed,
                   const float* __restrict__ noise,
                   const TowerWeights<typename std::conditional<kBf16, __nv_bfloat16, float>::type> pi,
                   const TowerWeights<typename std::conditional<kBf16, __nv_bfloat16, float>::type> vf,
                   int w_total, int stage_w, int b_total, const float* __restrict__ log_std,
                   RolloutOut out) {
  using TW = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int h_last = p.widths[p.n_layers - 1];
  const int n_head = p.a_dim + 1;

  Smem sm;
  sm.act0 = reinterpret_cast<float*>(smem_raw);
  sm.act1 = sm.act0 + h_max * kE;
  sm.head_w = sm.act1 + h_max * kE;
  sm.head_o = sm.head_w + n_head * h_last;
  sm.bias_s = sm.head_o + n_head * kE;
  // 16-byte aligned start of the staged weights
  size_t off = reinterpret_cast<size_t>(sm.bias_s + b_total);
  off = (off + 15) & ~static_cast<size_t>(15);
  TW* w_s = stage_w ? reinterpret_cast<TW*>(off) : nullptr;

  const TW* w = stage(pi, sm, w_s, w_total, b_total, h_last);
  const int env = blockIdx.x * kE + tid;
  float cash = p.initial_cash, inv = p.initial_inventory, price = p.initial_price;
  float lstd[kMaxAct], stdv[kMaxAct];
  for (int a = 0; a < p.a_dim; ++a) {
    lstd[a] = log_std[a];
    stdv[a] = expf(lstd[a]);
  }
  __syncthreads();

  // ---- phase 1: the episode with the pi tower (or the shared trunk)
  for (int i = 0; i < p.run_steps; ++i) {
    // ---- observation (pre-step), pallas_rollout.py:724-754
    if (tid < kE) {
      const float t = p.start_time + static_cast<float>(i) * p.dt;
      const float planes[4] = {cash, inv, t, price};
      for (int c = 0; c < p.s_dim; ++c) {
        float x = planes[c];
        if (p.normalise_obs) x = (x - p.obs_low[c]) / p.obs_grad[c] - 1.0f;
        out.obs[(static_cast<size_t>(i) * p.s_dim + c) * n + env] = x;
        sm.act0[c * kE + tid] = mbt::operand<kBf16>(x);
      }
    }
    __syncthreads();
    // ---- trunk and head: mean rows, then (shared trunk) the value row
    forward<kBf16>(p, w, sm, pi.head_rows, pi.b_head);

    // ---- sample, log-prob, action, env step (one lane per env)
    if (tid < kE) {
      const Draws d = draws_at(noise, n, seed, env, i);
      const float eps[2] = {d.eps0, d.eps1};
      float action[kMaxAct], exec[kMaxAct];
      float lp = 0.0f;
      for (int a = 0; a < p.a_dim; ++a) {
        action[a] = sm.head_o[a * kE + tid] + stdv[a] * eps[a];
        lp = lp + ((-0.5f * eps[a]) * eps[a] - lstd[a]);
        if (p.normalise_act) {
          const float c = fminf(fmaxf(action[a], -1.0f), 1.0f);
          exec[a] = (c + 1.0f) * p.act_grad[a] + p.act_low[a];
        } else {
          exec[a] = fminf(fmaxf(action[a], p.act_low[a]), p.act_high[a]);
        }
      }
      lp = lp - p.logp_const;

      const float bid = exec[0], ask = exec[1];
      const float arr_bid = d.u_ab < p.p_arr_bid ? 1.0f : 0.0f;
      const float arr_ask = d.u_aa < p.p_arr_ask ? 1.0f : 0.0f;
      float fill_bid = d.u_fb < expf(p.neg_k * bid) ? 1.0f : 0.0f;
      float fill_ask = d.u_fa < expf(p.neg_k * ask) ? 1.0f : 0.0f;
      fill_bid = fill_bid * (inv < p.max_inventory ? 1.0f : 0.0f);
      fill_ask = fill_ask * (inv > -p.max_inventory ? 1.0f : 0.0f);
      const float hit_bid = arr_bid * fill_bid;
      const float hit_ask = arr_ask * fill_ask;
      float new_inv = inv + hit_bid - hit_ask;
      float new_cash = cash - hit_bid * (price - bid) + hit_ask * (price + ask);
      new_inv = fminf(fmaxf(new_inv, -p.max_inventory), p.max_inventory);
      new_cash = fminf(fmaxf(new_cash, -p.max_cash), p.max_cash);
      const float new_price = price + p.drift_dt + p.vol_sqrt_dt * d.mid;
      const float reward = (new_cash + new_inv * new_price) - (cash + inv * price);

      const size_t o1 = static_cast<size_t>(i) * n + env;
      for (int a = 0; a < p.a_dim; ++a) {
        out.act[(static_cast<size_t>(i) * p.a_dim + a) * n + env] = action[a];
      }
      out.logp[o1] = lp;
      if (!vf.w_t) out.value[o1] = sm.head_o[p.a_dim * kE + tid];
      out.reward[o1] = reward;
      cash = new_cash;
      inv = new_inv;
      price = new_price;
    }
    // the next step's observation writes act0 only after this step's head
    // has read the trunk output (the barrier that ends forward), and its
    // head runs after the barrier that follows those writes
  }
  if (!vf.w_t) return;

  // ---- phase 2: the vf tower's value of each observation of phase 1
  __syncthreads();
  w = stage(vf, sm, w_s, w_total, b_total, h_last);
  __syncthreads();
  for (int i = 0; i < p.run_steps; ++i) {
    if (tid < kE) {  // this thread wrote these observations in phase 1
      for (int c = 0; c < p.s_dim; ++c) {
        sm.act0[c * kE + tid] = mbt::operand<kBf16>(out.obs[(static_cast<size_t>(i) * p.s_dim + c) * n + env]);
      }
    }
    __syncthreads();
    forward<kBf16>(p, w, sm, vf.head_rows, vf.b_head);
    if (tid < kE) out.value[static_cast<size_t>(i) * n + env] = sm.head_o[tid];
  }
}

template <bool kBf16>
int launch(const MlpKernelParams& p, int n, uint32_t seed, const float* noise, const void* const* pi,
           const void* const* vf, const float* log_std, const RolloutOut& out, cudaStream_t stream) {
  using TW = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  int h_max = p.s_dim, w_total = 0, b_total = 0, k_dim = p.s_dim;
  for (int l = 0; l < p.n_layers; ++l) {
    h_max = p.widths[l] > h_max ? p.widths[l] : h_max;
    w_total += k_dim * p.widths[l];
    b_total += p.widths[l];
    k_dim = p.widths[l];
  }
  const int n_head = p.a_dim + 1;
  const bool towers = vf[0] != nullptr;
  auto tower = [&](const void* const* t, int rows) {
    return TowerWeights<TW>{static_cast<const TW*>(t[0]), static_cast<const float*>(t[1]),
                            static_cast<const float*>(t[2]), static_cast<const float*>(t[3]), rows};
  };
  const TowerWeights<TW> pi_w = tower(pi, towers ? p.a_dim : n_head);
  const TowerWeights<TW> vf_w = tower(vf, 1);
  const size_t base = sizeof(float) * (2 * static_cast<size_t>(h_max) * kE + n_head * k_dim + n_head * kE + b_total) + 16;
  const size_t staged = base + sizeof(TW) * static_cast<size_t>(w_total);
  int max_optin = 0, device = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const int stage_w = kBf16 && staged <= static_cast<size_t>(max_optin);
  const size_t smem = stage_w ? staged : base;
  cudaError_t err = cudaFuncSetAttribute(mlp_rollout_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / kE);
  mlp_rollout_kernel<kBf16><<<grid, kThreads, smem, stream>>>(
      p, n, h_max, seed, noise, pi_w, vf_w, w_total, stage_w, b_total, log_std, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (0 on success).
// `noise` is NULL in native (Philox) mode.  A tower is {w_t, bias, w_head,
// b_head}: each layer's (in, out) weight matrix, layers concatenated, as
// bf16 when `bf16` is set and float otherwise; the biases concatenated;
// the head rows (float, already rounded to bf16 in bf16 mode) and their
// biases.  Shared trunk: `pi` is the trunk with the merged (A+1)-row head
// and `vf` is four NULLs.  Towers: `pi` is the pi tower with its A rows,
// `vf` the vf tower with its value row, of equal widths.  n must be a
// multiple of 32, every width a multiple of 4 and at most 256.
extern "C" int mbt_mlp_rollout(const MlpKernelParams* p, int device, int n, uint32_t seed,
                               const float* noise, int bf16, const void* const* pi, const void* const* vf,
                               const float* log_std, float* obs, float* act, float* logp, float* value,
                               float* reward, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const RolloutOut out{obs, act, logp, value, reward};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<true>(*p, n, seed, noise, pi, vf, log_std, out, s);
  return launch<false>(*p, n, seed, noise, pi, vf, log_std, out, s);
}
