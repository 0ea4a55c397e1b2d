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
// Depth.  The JAX kernels loop over any number of trunk layers; here a
// depth is an instantiation, not a runtime branch of one kernel:
//   L = 2, the repo's production trunk: ppo_pass1 / ppo_pass2 below, whose
//     pass 2 recomputes layers 0 and 1 from the observation and dmv;
//   L = 1 and L = 3-8: ppo_deep_pass1 / ppo_deep_pass2 (the second half of
//     this file), which stage what pass 2 reads instead of recomputing it.
//     They take L = 2 as well, so that the two can be timed side by side
//     (fused_ppo.py _TWO_LAYER_KERNELS).
// Widths reach the kernels as multiples of 64 (the wrapper pads each hidden
// width with exact zeros, ops/fused_ppo.py): a pass-2 CTA owns 64 rows of
// a layer, and its dW warp tiles split the layer's input width into four
// runs of 16-column mma tiles.
//
// Design: the float32 accumulator of a 256x256 weight gradient (256 KB;
// two of them with towers) exceeds the 227 KB of shared memory a block may
// hold, so the JAX kernels' one-program accumulation does not carry over;
// atomics into device memory would make the sum order change from run to
// run.  Three deterministic passes instead, over tiles of 32 samples:
//   pass 1, 256 CTAs, each a fixed contiguous range of tiles: the full
//     forward (activations of the tile in shared memory), the loss, and the
//     backward down to the input layer.  Per-CTA partial sums of every
//     gradient except the hidden-to-hidden dW (dW0, every db, the head,
//     log_std, metrics); at L = 2 the head-output gradient dmv (4 (A+1)
//     B/sample) written to device memory, at L = 1 and 3-8 each tile's
//     inputs of the hidden-to-hidden layers (h_0 .. h_{L-2}) and their
//     gradients (dz_1 .. dz_{L-1}), bf16 (float in the float32
//     instantiations), staged in device memory.
//   pass 2, (row blocks of 64) x 64 CTAs: each owns 64 rows of one
//     hidden-to-hidden layer (of one tower) and a fixed range of tiles, and
//     holds its 64 x h_in slice of that layer's dW in registers.  At L = 2
//     it recomputes its tower's layer-0 activations and its 64 rows of
//     layer 1 and forms its rows of dz2 from dmv; at L = 3-8 it reads the
//     staged planes.  L = 1 has no pass 2.
//   pass 3: partial sums reduced over the CTAs in a fixed order.
// At L = 3-8 the staged planes of a whole minibatch would not fit (1.68 GB
// a 256-wide plane at 3,276,800 samples), so passes 1 and 2 run in turn
// over chunks of tiles, the scratch bounded by the wrapper (fused_ppo.py
// _STAGE_BYTES), every CTA adding each chunk to its own partial sums in
// chunk order.  A repeated launch therefore gives bitwise-equal grads.
//
// Bound on the H100: operations.  Per sample, with per-tower widths h_l,
// T towers, S inputs and A actions, forward 2 T (S h_0 + sum_{l>=1}
// h_{l-1} h_l) + 2 (A+1) T h_{L-1}, backward the same again for dh and the
// weight gradients.  At S = 4, 256x256, A = 2: forward 2*(4*256 + 256*256
// + 3*256) (4.0e5 FLOP with the backward; 8.0e5 with towers); a
// 3,276,800-sample minibatch is 1.32 TFLOP (2.62 with towers): 1.332 ms
// (2.648 ms) at the 989 TFLOP/s bf16 tensor-core peak, against 118 MB read
// (0.035 ms).  At 256x256x256, 7.96e5 FLOP a sample, 2.61 TFLOP, 2.638 ms;
// at 256 (L = 1), 8.7e3 FLOP a sample, 0.029 ms, so there the 0.035 ms of
// reading the samples binds.  The staged planes (none at L = 1; 2 KB a
// sample at 256x256x256 in bf16) add traffic that the bound leaves out.
//
// What the design does about it.  In the bf16 instantiations the three
// 256-wide products run on the tensor cores as warp-level
// mma.sync.m16n8k16 (bf16 operands, float32 sums): layer 1's forward
// Z2 = W1 H1 (pass 1, and pass 2's recompute of its 64 rows), its
// transpose dH1 = W1^T dZ2 (pass 1), and dW1 += dZ2 H1^T over a tile's
// samples (pass 2).  Activation tiles are bf16 in shared memory (they are
// bf16 operands already, so storing them so changes no value) and reach the
// mma through ldmatrix.  The W1 operands come in mma fragment order (the
// wrapper packs wb1 for the forward and wf1 for the transpose): pass 1
// reads them from device memory through L2, one 16-byte load per lane and
// 16x16 block with two k blocks in flight (at most 256 KB of bf16, resident
// in the 50 MB L2); a pass-2 CTA stages its 64 rows (32 KB) in shared
// memory once.  Layer 0 (k = S <= 8), the merged head (A+1 <= 5 rows), the
// loss, the bias, dW0 and log_std gradients and the metrics stay on CUDA
// cores; there the per-row sums over a tile's samples are one thread per
// row (float32: warp butterflies), in a fixed order.  The float32
// instantiations keep every product on CUDA cores with explicit FMAs
// (dense.cuh): TF32 would break their rtol of 1e-4.
// What still holds it back (chip_smoke.py, PERF.md): CUDA-core work, above
// all the tanh of layer 0, which pass 2 recomputes in each of its 64-row
// CTAs, and of layer 1 (~1.35x the minimum FLOPs in all); the per-tile L2
// reads of W1 in pass 1; mma.sync, which issues a 16x8 product per warp
// where wgmma issues 64xN per warpgroup with operands from shared memory.
// wgmma with TMA-staged weights is the next step.
//
// Numerics follow the plain PyTorch versions (ops/fused_ppo.py) in both
// compute dtypes.  bf16: every matmul operand rounded to bf16 with a
// float32 sum; the saved activations rounded to bf16 (fused_ppo.py:276);
// tanh' = 1 - h*h evaluated in bf16 (h*h rounded, then 1 - that rounded)
// before it multiplies the float32 dh (:314).  float32: no rounding.
// Bias gradients and metrics sum the unrounded float32 values (db0 in the
// transpose's epilogue, before dz1 is stored as a bf16 operand).  The
// tensor cores sum in another order than an FMA chain, so a rare bf16
// rounding of a saved value may differ from the plain version's.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense.cuh"
#include "mma.cuh"

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

constexpr int kMaxLayers = 8;

// Mirrors DeepKernelParams in mbt_gym_torch/ops/fused_ppo.py (ctypes),
// which computes every offset.  Widths are per tower and multiples of 64;
// "rows" count stacked rows (towers x width).
struct DeepParams {
  PpoKernelParams base;  // h0, h1 unused
  int n_layers;
  int h_max;        // the widest stacked layer
  int stage_rows;   // staged rows per tile
  int chunk_tiles;  // tiles per chunk
  int p1_db;        // pass-1 partials: dW0 (H0, s) at 0 | db of every layer | dWh | dbh | dlog_std | metrics
  int p1_dwh;
  int p1_dbh;
  int p1_total;
  int dw_total;     // the hidden-to-hidden dW, layers 1 .. L-1 in order
  int widths[kMaxLayers];
  int w_off[kMaxLayers];    // layer l >= 1: its matrices in wf and wb (and its dW in the dW output)
  int b_off[kMaxLayers];    // layer l's bias and db
  int sh_off[kMaxLayers];   // staged rows of h_l, l <= L-2, within a tile
  int sdz_off[kMaxLayers];  // staged rows of dz_l, l >= 1
  int rb_start[kMaxLayers + 1];  // pass-2 row blocks of layer l: [rb_start[l], rb_start[l + 1])
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

// ---- tensor-core building blocks of the bf16 instantiations (mma.cuh)
//
// Activation tiles hold the tile's 32 samples at a row stride of kLdA bf16
// (80 bytes): the 8 rows one ldmatrix phase reads then fall in 8 distinct
// 16-byte bank groups.
constexpr int kWarps = kThreads / 32;
constexpr int kLdA = kE + 8;

using mbt::frag_from;
using mbt::kBlock;
using mbt::ldmatrix_x4;
using mbt::mma_bf16;
using mbt::mma_k_block;
using mbt::zero_acc;

// The A fragments of MT row blocks (a row-block stride apart) at `p`,
// this lane's 16 bytes of the first one, in device memory: one 16-byte
// load through L2 each.
template <int MT>
__device__ __forceinline__ void load_a_global(uint32_t (&a)[MT][4], const __nv_bfloat16* p, size_t rb_stride) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) frag_from(a[mt], __ldg(reinterpret_cast<const uint4*>(p + mt * rb_stride)));
}

// acc[mt][nt] = sum over k < k_dim of w[16 mt + m][k] * act[k][8 nt + n]
// for one warp: MT 16-row blocks of a bf16 matrix in fragment order (`w`
// at the first row block's first k block, in device memory) times NT
// 8-sample tiles of the feature-major activation tile `act` (k_dim rows of
// stride kLdA in shared memory, offset to the first sample).  k_dim is a
// multiple of 64.  The A fragments of D = 2 k blocks are in flight at once:
// a block's registers are refilled with the block D ahead as soon as they
// have been multiplied.
template <int MT, int NT>
__device__ __forceinline__ void mma_weights_act(const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* act,
                                                int k_dim, float (&acc)[MT][NT][4]) {
  constexpr int D = 2;
  const __nv_bfloat16* b_row = mbt::act_b_row<kLdA>(act);
  const __nv_bfloat16* a_frag = w + (threadIdx.x % 32) * 8;
  const size_t rb_stride = static_cast<size_t>(k_dim) * 16;
  zero_acc(acc);
  uint32_t a[D][MT][4];
#pragma unroll
  for (int s = 0; s < D; ++s) load_a_global<MT>(a[s], a_frag + s * kBlock, rb_stride);
  for (int k0 = 0; k0 < k_dim; k0 += 16 * D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int kk = k0 + 16 * s;
      mma_k_block(a[s], b_row + kk * kLdA, acc);
      if (kk + 16 * D < k_dim) load_a_global<MT>(a[s], a_frag + (kk / 16 + D) * kBlock, rb_stride);
    }
  }
}

// mma_weights_act with each k block's products summed in a fresh fragment
// and added to `acc` by IEEE float32 adds, for the deep instantiations: a
// tensor-core accumulator truncates, and down a chain of up to seven such
// products and their transposes that bias flips bf16 roundings of the
// saved activations and of dz (1.5e-2 of a bias gradient at 8 x 256 with
// towers over 81,920 samples, against 1.8e-3 with these adds).
template <int MT, int NT>
__device__ __forceinline__ void mma_weights_act_ieee(const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* act,
                                                     int k_dim, float (&acc)[MT][NT][4]) {
  constexpr int D = 2;
  const __nv_bfloat16* b_row = mbt::act_b_row<kLdA>(act);
  const __nv_bfloat16* a_frag = w + (threadIdx.x % 32) * 8;
  const size_t rb_stride = static_cast<size_t>(k_dim) * 16;
  zero_acc(acc);
  uint32_t a[D][MT][4];
#pragma unroll
  for (int s = 0; s < D; ++s) load_a_global<MT>(a[s], a_frag + s * kBlock, rb_stride);
  for (int k0 = 0; k0 < k_dim; k0 += 16 * D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int kk = k0 + 16 * s;
      float u[MT][NT][4];
      zero_acc(u);
      mma_k_block(a[s], b_row + kk * kLdA, u);
      if (kk + 16 * D < k_dim) load_a_global<MT>(a[s], a_frag + (kk / 16 + D) * kBlock, rb_stride);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += u[mt][nt][i];
        }
      }
    }
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

// Eight consecutive samples of a bf16 activation row (one 16-byte access;
// a warp's 8-lane phases read 8 rows at the kLdA stride without conflict).
__device__ __forceinline__ void load_row8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_row8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  auto* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Layer 0 for the tile over `rows` rows of the stacked (s, ldw) matrix
// `wf0` (already offset to the first row): h1[k][e] = op(tanh(W0 x + b0)),
// row stride ldh; also h1t[e][k] when given.  A thread computes 4 rows x
// ET samples per sweep (ET = 2 where registers hold a live accumulator).
// Into bf16 tiles, neighbouring lanes take neighbouring sample runs and a
// thread stores its run of a row at once (ET = 8 or 2), so the stores
// meet no bank conflict.
template <bool kBf16, int ET = 8, typename TW, typename TA>
__device__ __forceinline__ void layer0(const PpoKernelParams& p, const TW* wf0, int ldw, const float* b0,
                                       int rows, const float* x, TA* h1, int ldh, float* h1t) {
  constexpr bool kPacked = !std::is_same<TA, float>::value;
  constexpr int kGroups = kE / ET, kRowGroups = kThreads / kGroups;
  const int rg = kPacked ? threadIdx.x / kGroups : threadIdx.x % kRowGroups;
  const int eg = kPacked ? threadIdx.x % kGroups : threadIdx.x / kRowGroups;
  for (int r0 = rg * 4; r0 < rows; r0 += 4 * kRowGroups) {
    float acc[4][ET];
    mbt::dense_tile<ET>(wf0 + r0, ldw, x + eg * ET, kE, p.s_dim, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = r0 + r;
      float h[ET];
#pragma unroll
      for (int e = 0; e < ET; ++e) {
        h[e] = mbt::operand<kBf16>(tanhf(acc[r][e] + b0[k]));
        if constexpr (!kPacked) {
          h1[k * ldh + eg * ET + e] = h[e];
          if (h1t) h1t[(eg * ET + e) * rows + k] = h[e];
        }
      }
      if constexpr (kPacked) {
        static_assert(ET == 8 || ET == 2, "a packed run is 16 or 4 bytes");
        if constexpr (ET == 8) {
          store_row8(h1 + k * ldh + eg * ET, h);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(h1 + k * ldh + eg * ET) = __floats2bfloat162_rn(h[0], h[1]);
        }
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
  using TA = TW;                          // activations: bf16 operand tiles or float
  constexpr int kLd = kBf16 ? kLdA : kE;  // their row stride
  float* x = sm;                          // [s][kE]
  TA* h1 = reinterpret_cast<TA*>(x + kMaxObs * kE);     // [H0][kLd]; later dz1
  TA* h2 = h1 + H0 * kLd;                               // [H1][kLd]; later dz2
  float* mv = reinterpret_cast<float*>(h2 + H1 * kLd);  // [a+1][kE]; later dmv
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
    layer0<kBf16>(p, wf0, H0, b0, H0, x, h1, kLd, nullptr);
    __syncthreads();
    // layer 1, one product per tower: rows [tw h1, (tw+1) h1) read h1 rows
    // [tw h0, (tw+1) h0)
    if constexpr (kBf16) {
      // on the tensor cores: warp w takes the 32-row blocks w, w + 8, ...,
      // each inside one tower, W1 fragments from wb1 (out, in)
      const int g = lane / 4, t4 = lane % 4;
      for (int jb = warp * 32; jb < H1; jb += kWarps * 32) {
        const int tw = jb / p.h1;
        float z[2][4][4];
        mma_weights_act<2, 4>(wb1 + static_cast<size_t>(jb) * p.h0, h1 + tw * p.h0 * kLd, p.h0, z);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = jb + mt * 16 + g + half * 8;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              *reinterpret_cast<__nv_bfloat162*>(h2 + j * kLd + nt * 8 + t4 * 2) = __floats2bfloat162_rn(
                  tanhf(z[mt][nt][half * 2] + b1[j]), tanhf(z[mt][nt][half * 2 + 1] + b1[j]));
            }
          }
        }
      }
    } else {
      for (int j0 = rg * 4; j0 < H1; j0 += kRowsPerSweep) {
        const int tw = j0 / p.h1;
        float a4[4][8];
        mbt::dense_tile<8>(wf1 + static_cast<size_t>(tw) * p.h0 * p.h1 + (j0 - tw * p.h1), p.h1,
                           h1 + tw * p.h0 * kE + eg * 8, kE, p.h0, a4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = j0 + r;
#pragma unroll
          for (int e = 0; e < 8; ++e) h2[j * kE + eg * 8 + e] = tanhf(a4[r][e] + b1[j]);
        }
      }
    }
    __syncthreads();
    if (tid < n_head * kE) {  // merged head
      const int a = tid / kE, e = tid % kE;
      float s = 0.0f;
      if constexpr (kBf16) {  // four independent FMA chains
        float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = 0; k < H1; k += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) s4[u] = __fmaf_rn(hw[a * H1 + k + u], __bfloat162float(h2[(k + u) * kLd + e]), s4[u]);
        }
        s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      } else {
        for (int k = 0; k < H1; ++k) s = __fmaf_rn(hw[a * H1 + k], h2[k * kE + e], s);
      }
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

    // head grads, dh2 -> dz2 (rows of layer 1)
    if constexpr (kBf16) {
      // one thread per row, over the tile's samples in order: no shuffles
      for (int j = tid; j < H1; j += kThreads) {
        float wj[kMaxAct + 1], dwh[kMaxAct + 1];
#pragma unroll
        for (int a = 0; a <= kMaxAct; ++a) {
          wj[a] = a < n_head ? hw[a * H1 + j] : 0.0f;
          dwh[a] = 0.0f;
        }
        float db = 0.0f;
        __nv_bfloat16* row = h2 + j * kLd;
        // rolled: unrolled, the tile's mv reads are hoisted out of the row
        // loop and spill
#pragma unroll 1
        for (int e0 = 0; e0 < kE; e0 += 8) {
          float h[8];
          load_row8(row + e0, h);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float dh = 0.0f;
#pragma unroll
            for (int a = 0; a <= kMaxAct; ++a) {
              if (a < n_head) {
                const float d = mbt::round_bf16(mv[a * kE + e0 + i]);
                dwh[a] = __fmaf_rn(d, h[i], dwh[a]);
                dh = __fmaf_rn(wj[a], d, dh);
              }
            }
            const float dz = dh * tanh_grad<true>(h[i]);
            db = db + dz;
            h[i] = dz;
          }
          store_row8(row + e0, h);
        }
#pragma unroll
        for (int a = 0; a <= kMaxAct; ++a) {
          if (a < n_head) acc[lay.dwh + a * H1 + j] += dwh[a];
        }
        acc[lay.db1 + j] += db;
      }
    } else {  // one warp per row
      for (int j = warp; j < H1; j += kWarps) {
        const float h = h2[j * kE + lane];
        float dh = 0.0f;
        for (int a = 0; a < n_head; ++a) {
          const float d = mv[a * kE + lane];
          const float s = warp_sum(d * h);
          if (lane == 0) acc[lay.dwh + a * H1 + j] += s;
          dh = __fmaf_rn(hw[a * H1 + j], d, dh);
        }
        const float dz = dh * tanh_grad<false>(h);
        const float s = warp_sum(dz);
        if (lane == 0) acc[lay.db1 + j] += s;
        h2[j * kE + lane] = dz;
      }
    }
    __syncthreads();

    // dh1 = W1^T dz2 per tower, then dz1 = dh1 * tanh'(h1) in place of h1
    if constexpr (kBf16) {
      // on the tensor cores, W1^T fragments from wf1 (in, out); db0 sums
      // the unrounded dz1 here, before it is stored as a bf16 operand
      const int g = lane / 4, t4 = lane % 4;
      for (int kb = warp * 32; kb < H0; kb += kWarps * 32) {
        const int tw = kb / p.h0;
        float z[2][4][4];
        mma_weights_act<2, 4>(wf1 + static_cast<size_t>(kb) * p.h1, h2 + tw * p.h1 * kLd, p.h1, z);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int k = kb + mt * 16 + g + half * 8;
            float s = 0.0f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              auto* cell = reinterpret_cast<__nv_bfloat162*>(h1 + k * kLd + nt * 8 + t4 * 2);
              const float2 h = __bfloat1622float2(*cell);
              const float d0 = z[mt][nt][half * 2] * tanh_grad<true>(h.x);
              const float d1 = z[mt][nt][half * 2 + 1] * tanh_grad<true>(h.y);
              s = s + d0;
              s = s + d1;
              *cell = __floats2bfloat162_rn(d0, d1);
            }
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if (t4 == 0) acc[lay.db0 + k] += s;
          }
        }
      }
    } else {
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
    }
    __syncthreads();

    // layer-0 grads
    if constexpr (kBf16) {
      // one thread per row, over the tile's samples in order; dz1 is the
      // bf16 operand already and db0 was summed above
      for (int k = tid; k < H0; k += kThreads) {
        float dw[kMaxObs];
#pragma unroll
        for (int c = 0; c < kMaxObs; ++c) dw[c] = 0.0f;
#pragma unroll 1  // as above, for the x reads
        for (int e0 = 0; e0 < kE; e0 += 8) {
          float d[8];
          load_row8(h1 + k * kLd + e0, d);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int c = 0; c < kMaxObs; ++c) {
              if (c < p.s_dim) dw[c] = __fmaf_rn(d[i], x[c * kE + e0 + i], dw[c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kMaxObs; ++c) {
          if (c < p.s_dim) acc[lay.dw0 + k * p.s_dim + c] += dw[c];
        }
      }
    } else {  // one warp per row
      for (int k = warp; k < H0; k += kWarps) {
        const float dz = h1[k * kE + lane];
        const float s = warp_sum(dz);
        if (lane == 0) acc[lay.db0 + k] += s;
        for (int c = 0; c < p.s_dim; ++c) {
          const float w = warp_sum(dz * x[c * kE + lane]);
          if (lane == 0) acc[lay.dw0 + k * p.s_dim + c] += w;
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < lay.total; i += kThreads) part1[static_cast<size_t>(blockIdx.x) * lay.total + i] = acc[i];
}

// Pass 2 on CUDA cores (float32): thread (r_own, kb) holds row r_own of
// the CTA's dW1 slice, columns [kb kq, (kb+1) kq), in registers.
template <bool kRowMajor>
__device__ __forceinline__ void pass2_cuda_cores(const PpoKernelParams& p, const PpoInputs& in,
                                                 const float* __restrict__ wf0, const float* __restrict__ wf1,
                                                 const float* __restrict__ bias, const float* __restrict__ w_head,
                                                 const float* __restrict__ dmv_in, float* __restrict__ part2) {
  constexpr bool kBf16 = false;
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
  const float* w1 = wf1 + static_cast<size_t>(tw) * p.h0 * p.h1 + (row0 - tw * p.h1);

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
    layer0<kBf16>(p, wf0 + tw * p.h0, H0, b0, p.h0, x, h1, kE, h1t);
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

// Pass 2 on tensor cores (bf16).  Per tile: layer 0 of the tower on CUDA
// cores into a bf16 operand tile; the CTA's 64 rows of layer 1 as one
// mma product (warp w: rows [16 (w / 2), +16) x samples [16 (w % 2), +16),
// A fragments from the CTA's 64 rows of W1, staged in shared memory once
// per CTA: 32 KB at 256 wide), whose epilogue forms dz2 in bf16; then
// dW1 += dz2 h1^T over the tile's 32 samples, warp w holding rows
// [32 (w % 2), +32) x columns [(w / 2) h0 / 4, +h0 / 4) of the slice as
// mma accumulator fragments (at most 64 floats a thread).
template <bool kRowMajor>
__device__ __forceinline__ void pass2_tensor_cores(const PpoKernelParams& p, const PpoInputs& in,
                                                   const __nv_bfloat16* __restrict__ wf0,
                                                   const __nv_bfloat16* __restrict__ wb1,
                                                   const float* __restrict__ bias, const float* __restrict__ w_head,
                                                   const float* __restrict__ dmv_in, float* __restrict__ part2) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4, q = lane / 8, r = lane % 8;
  const int n_head = p.a_dim + 1;
  const int H0 = p.towers * p.h0, H1 = p.towers * p.h1;
  const int row0 = blockIdx.x * kRowBlock;  // stacked layer-1 row
  const int tw = row0 / p.h1;               // its tower
  const int part = blockIdx.y;
  float* x = sm;                            // [s][kE]
  float* dmv = x + kMaxObs * kE;            // [a+1][kE], operands
  float* hw = dmv + n_head * kE;            // [a+1][64] head weights of these rows
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(hw + n_head * kRowBlock);  // [h0][kLdA]
  __nv_bfloat16* dz2 = h1 + p.h0 * kLdA;    // [64][kLdA]
  __nv_bfloat16* w1 = dz2 + kRowBlock * kLdA;  // these 64 rows of W1, fragment order
  const float* b0 = bias + tw * p.h0;
  const float* b1 = bias + H0;

  for (int i = tid; i < n_head * kRowBlock; i += kThreads) {
    hw[i] = w_head[(i / kRowBlock) * H1 + row0 + i % kRowBlock];
  }
  // the CTA's 64 x h0 slice of W1 (4 row blocks, contiguous), staged once
  for (int i = tid; i < kRowBlock * p.h0 / 8; i += kThreads) {
    reinterpret_cast<uint4*>(w1)[i] = __ldg(reinterpret_cast<const uint4*>(wb1 + static_cast<size_t>(row0) * p.h0) + i);
  }
  const int rm = (warp / 2) * 16, re = (warp % 2) * 16;  // the layer-1 product's warp tile
  const int nq = p.h0 / 4, dm = (warp % 2) * 32, dn = (warp / 2) * nq;  // the dW1 warp tile
  float acc[2][8][4];
  zero_acc(acc);

  const int tiles_per_step = p.n_envs / kE;
  int lo, hi;
  tile_range(p.n_steps * tiles_per_step, gridDim.y, part, lo, hi);
  __syncthreads();
  for (int qt = lo; qt < hi; ++qt) {
    const int t = qt / tiles_per_step, env0 = (qt % tiles_per_step) * kE;
    load_obs<true, kRowMajor>(p, in.obs, t, env0, x);
    for (int i = tid; i < n_head * kE; i += kThreads) {
      const int a = i / kE, e = i % kE;
      dmv[i] = mbt::round_bf16(dmv_in[(static_cast<size_t>(a) * p.n_steps + t) * p.n_envs + env0 + e]);
    }
    __syncthreads();
    layer0<true, 2>(p, wf0 + tw * p.h0, H0, b0, p.h0, x, h1, kLdA, nullptr);
    __syncthreads();
    {
      float z[1][2][4];
      mbt::mma_staged_act<1, 2, kLdA>(w1 + rm * p.h0, h1 + re, p.h0, z);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int jl = rm + g + half * 8, j = row0 + jl;
          const int el = re + nt * 8 + t4 * 2;
          float dz[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float h = mbt::round_bf16(tanhf(z[0][nt][half * 2 + c] + b1[j]));
            float dh = 0.0f;
            for (int a = 0; a < n_head; ++a) dh = __fmaf_rn(hw[a * kRowBlock + jl], dmv[a * kE + el + c], dh);
            dz[c] = dh * tanh_grad<true>(h);
          }
          *reinterpret_cast<__nv_bfloat162*>(dz2 + jl * kLdA + el) = __floats2bfloat162_rn(dz[0], dz[1]);
        }
      }
    }
    __syncthreads();
    // dW1 += dz2 h1^T over the tile's 32 samples.  The tile's products are
    // summed in fresh fragments and added to the accumulator by IEEE float32
    // adds: a tensor-core accumulator truncates, and over a CTA's ~1,600
    // tiles that bias would add up (3.6e-4 of dW1 at config 5).
    {
      uint32_t a[2][2][4];  // [k block][row tile]
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          ldmatrix_x4(a[kb][mt], dz2 + (dm + mt * 16 + lane % 16) * kLdA + kb * 16 + (lane / 16) * 8);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 < nq) {
          float u[2][2][4];
          zero_acc(u);
#pragma unroll
          for (int kb = 0; kb < 2; ++kb) {
            uint32_t b[4];
            ldmatrix_x4(b, h1 + (dn + np * 16 + (q / 2) * 8 + r) * kLdA + kb * 16 + (q % 2) * 8);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(u[mt][0], a[kb][mt], b[0], b[1]);
              mma_bf16(u[mt][1], a[kb][mt], b[2], b[3]);
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[mt][2 * np][i] += u[mt][0][i];
              acc[mt][2 * np + 1][i] += u[mt][1][i];
            }
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = part2 + (static_cast<size_t>(part) * H1 + row0) * p.h0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt * 8 < nq) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = dm + mt * 16 + g + half * 8, col = dn + nt * 8 + t4 * 2;
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * p.h0 + col) =
              make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
        }
      }
    }
  }
}

// Pass 2: grid (stacked h1 / 64, 64); the CTA's 64 layer-1 rows x part y's
// tiles, its dW1 slice written to part2[y].
template <bool kBf16, bool kRowMajor, typename TW>
__global__ void __launch_bounds__(kThreads, 2)
ppo_pass2(const PpoKernelParams p, const PpoInputs in, const TW* __restrict__ wf0,
          const TW* __restrict__ wf1, const TW* __restrict__ wb1, const float* __restrict__ bias,
          const float* __restrict__ w_head, const float* __restrict__ dmv_in, float* __restrict__ part2) {
  if constexpr (kBf16) {
    pass2_tensor_cores<kRowMajor>(p, in, wf0, wb1, bias, w_head, dmv_in, part2);
  } else {
    pass2_cuda_cores<kRowMajor>(p, in, wf0, wf1, bias, w_head, dmv_in, part2);
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
  const size_t smem1 = sizeof(float) * (kMaxObs * kE + n_head * kE + n_head * H1 + lay.total) +
                       sizeof(TW) * (H0 + H1) * (kBf16 ? kLdA : kE);
  const size_t smem2 =
      kBf16 ? sizeof(float) * (kMaxObs * kE + n_head * kE + n_head * kRowBlock) +
                  sizeof(__nv_bfloat16) * ((p.h0 + kRowBlock) * kLdA + kRowBlock * p.h0)
            : sizeof(float) * (kMaxObs * kE + 2 * p.h0 * kE + n_head * kE + kE * kRowBlock + n_head * kRowBlock);
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
      p, in, static_cast<const TW*>(wf0), static_cast<const TW*>(wf1), static_cast<const TW*>(wb1), bias,
      w_head, dmv, part2);
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

// ---------------------------------------------------------------- any depth
// L = 1 and L = 3-8 (see the header).  Pass 1 keeps two activation tiles
// in shared memory and stages every input of a hidden-to-hidden layer and
// every such layer's dz in device memory; the backward reads h_{l-1} back
// from there (through L2, where this CTA has just written it).  Pass 2
// reads the staged planes; it depends on neither the input layout nor the
// observation.

// `rows` rows of an activation tile (row stride kLdA bf16 or kE floats in
// shared memory) to or from a staged plane in device memory ([rows][kE]
// contiguous), 16 bytes an access.
template <typename TA>
__device__ __forceinline__ void stage_out(const TA* tile, int rows, TA* plane) {
  constexpr int kLd = std::is_same<TA, float>::value ? kE : kLdA;
  constexpr int kVec = 16 / sizeof(TA), kPerRow = kE / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = i % kPerRow;
    reinterpret_cast<uint4*>(plane)[i] = *reinterpret_cast<const uint4*>(tile + r * kLd + c * kVec);
  }
}

template <typename TA>
__device__ __forceinline__ void stage_in(const TA* plane, int rows, TA* tile) {
  constexpr int kLd = std::is_same<TA, float>::value ? kE : kLdA;
  constexpr int kVec = 16 / sizeof(TA), kPerRow = kE / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = i % kPerRow;
    *reinterpret_cast<uint4*>(tile + r * kLd + c * kVec) = reinterpret_cast<const uint4*>(plane)[i];
  }
}

template <bool kBf16, bool kRowMajor, typename TW>
__global__ void __launch_bounds__(kThreads, 2)
ppo_deep_pass1(const DeepParams p, const PpoInputs in, int tile0, int n_tiles, int accumulate,
               const TW* __restrict__ wf0, const TW* __restrict__ wf, const TW* __restrict__ wb,
               const float* __restrict__ bias, const float* __restrict__ w_head,
               const float* __restrict__ b_head, const float* __restrict__ log_std, TW* __restrict__ stage,
               float* __restrict__ part1) {
  extern __shared__ __align__(16) float sm[];
  const PpoKernelParams& bp = p.base;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_head = bp.a_dim + 1, L = p.n_layers, towers = bp.towers;
  const int H0 = towers * p.widths[0], HL = towers * p.widths[L - 1];
  using TA = TW;                          // activations: bf16 operand tiles or float
  constexpr int kLd = kBf16 ? kLdA : kE;  // their row stride
  float* x = sm;                          // [s][kE]
  TA* cur = reinterpret_cast<TA*>(x + kMaxObs * kE);     // [h_max][kLd]: this layer
  TA* nxt = cur + p.h_max * kLd;                          // [h_max][kLd]: the next
  float* mv = reinterpret_cast<float*>(nxt + p.h_max * kLd);  // [a+1][kE]; later dmv
  float* hw = mv + n_head * kE;           // [a+1][HL] head weights (operands)
  float* acc = hw + n_head * HL;          // the pass-1 partials (p1_total)
  float* mine = part1 + static_cast<size_t>(blockIdx.x) * p.p1_total;

  for (int i = tid; i < n_head * HL; i += kThreads) hw[i] = w_head[i];
  for (int i = tid; i < p.p1_total; i += kThreads) acc[i] = accumulate ? mine[i] : 0.0f;

  float lstd[kMaxAct], inv_std[kMaxAct];
  for (int a = 0; a < bp.a_dim; ++a) {
    lstd[a] = log_std[a];
    inv_std[a] = expf(-lstd[a]);
  }
  const float cv = bp.vf_coef * bp.inv_m;
  const int tiles_per_step = bp.n_envs / kE;
  int lo, hi;
  tile_range(n_tiles, gridDim.x, blockIdx.x, lo, hi);
  __syncthreads();

  const int rg = tid % 64, eg = tid / 64;
  const int g = lane / 4, t4 = lane % 4;
  for (int q = lo; q < hi; ++q) {
    const int qg = tile0 + q;
    const int t = qg / tiles_per_step, env0 = (qg % tiles_per_step) * kE;
    TA* st = stage + static_cast<size_t>(q) * p.stage_rows * kE;  // this tile's staged planes
    load_obs<kBf16, kRowMajor>(bp, in.obs, t, env0, x);
    __syncthreads();
    layer0<kBf16>(bp, wf0, H0, bias, H0, x, cur, kLd, nullptr);
    __syncthreads();
    // hidden-to-hidden layers: rows [tw ho, (tw+1) ho) read rows [tw hi, (tw+1) hi)
    for (int l = 1; l < L; ++l) {
      const int wi = p.widths[l - 1], wo = p.widths[l];
      const float* bl = bias + p.b_off[l];
      stage_out(cur, towers * wi, st + static_cast<size_t>(p.sh_off[l - 1]) * kE);
      if constexpr (kBf16) {
        for (int jb = warp * 32; jb < towers * wo; jb += kWarps * 32) {
          const int tw = jb / wo;
          float z[2][4][4];
          mma_weights_act_ieee<2, 4>(wb + p.w_off[l] + static_cast<size_t>(jb) * wi, cur + tw * wi * kLd, wi, z);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int j = jb + mt * 16 + g + half * 8;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                *reinterpret_cast<__nv_bfloat162*>(nxt + j * kLd + nt * 8 + t4 * 2) = __floats2bfloat162_rn(
                    tanhf(z[mt][nt][half * 2] + bl[j]), tanhf(z[mt][nt][half * 2 + 1] + bl[j]));
              }
            }
          }
        }
      } else {
        for (int j0 = rg * 4; j0 < towers * wo; j0 += kRowsPerSweep) {
          const int tw = j0 / wo;
          float a4[4][8];
          mbt::dense_tile<8>(wf + p.w_off[l] + static_cast<size_t>(tw) * wi * wo + (j0 - tw * wo), wo,
                             cur + tw * wi * kE + eg * 8, kE, wi, a4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int j = j0 + r;
#pragma unroll
            for (int e = 0; e < 8; ++e) nxt[j * kE + eg * 8 + e] = tanhf(a4[r][e] + bl[j]);
          }
        }
      }
      __syncthreads();
      TA* swap = cur;
      cur = nxt;
      nxt = swap;
    }
    if (tid < n_head * kE) {  // merged head
      const int a = tid / kE, e = tid % kE;
      float s = 0.0f;
      if constexpr (kBf16) {  // four independent FMA chains
        float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = 0; k < HL; k += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) s4[u] = __fmaf_rn(hw[a * HL + k + u], __bfloat162float(cur[(k + u) * kLd + e]), s4[u]);
        }
        s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      } else {
        for (int k = 0; k < HL; ++k) s = __fmaf_rn(hw[a * HL + k], cur[k * kE + e], s);
      }
      mv[a * kE + e] = s + b_head[a];
    }
    __syncthreads();

    if (warp == 0) {  // loss and its gradient, one lane per sample
      const int env = env0 + lane;
      float z[kMaxAct];
      float logp = 0.0f;
      for (int a = 0; a < bp.a_dim; ++a) {
        const float act = load<kRowMajor>(in.act, t, a, env);
        z[a] = (act - mv[a * kE + lane]) * inv_std[a];
        logp = logp + (((-0.5f * z[a]) * z[a] - lstd[a]) - bp.half_log_2pi);
      }
      const float v = mv[bp.a_dim * kE + lane];
      const float old = load<kRowMajor>(in.old_logp, t, 0, env);
      const float adv = load<kRowMajor>(in.adv, t, 0, env);
      const float ret = load<kRowMajor>(in.ret, t, 0, env);
      const float ratio = expf(logp - old);
      const float pg1 = ratio * adv;
      const float pg2 = fminf(fmaxf(ratio, bp.clip_lo), bp.clip_hi) * adv;
      const float vf_err = v - ret;
      const float inside = (ratio > bp.clip_lo && ratio < bp.clip_hi) ? 1.0f : 0.0f;
      const float take1 = pg1 < pg2 ? 1.0f : 0.0f;
      const float tie = pg1 == pg2 ? 1.0f : 0.0f;
      const float branch = take1 + (1.0f - take1 - tie) * inside + 0.5f * tie * (1.0f + inside);
      const float dratio = -(adv * bp.inv_m) * branch;
      const float dlogp = dratio * ratio;
      const float dv = cv * vf_err;
      float sums[2 * kMaxAct + 4];
      for (int a = 0; a < bp.a_dim; ++a) {
        const float dmean = dlogp * (z[a] * inv_std[a]);
        mv[a * kE + lane] = dmean;
        sums[a] = dmean;
        sums[n_head + a] = dlogp * (z[a] * z[a] - 1.0f);
      }
      mv[bp.a_dim * kE + lane] = dv;
      sums[bp.a_dim] = dv;
      const int m0 = n_head + bp.a_dim;
      sums[m0] = -fminf(pg1, pg2);
      sums[m0 + 1] = (0.5f * vf_err) * vf_err;
      sums[m0 + 2] = old - logp;
      for (int i = 0; i < m0 + 3; ++i) {
        const float s = warp_sum(sums[i]);
        if (lane == 0) acc[p.p1_dbh + i] += s;  // dbh | dlstd | metrics are contiguous
      }
    }
    __syncthreads();

    // head grads, dh -> dz of the last layer, in place
    {
      float* db_last = acc + p.p1_db + p.b_off[L - 1];
      if constexpr (kBf16) {
        // one thread per row, over the tile's samples in order: no shuffles
        for (int j = tid; j < HL; j += kThreads) {
          float wj[kMaxAct + 1], dwh[kMaxAct + 1];
#pragma unroll
          for (int a = 0; a <= kMaxAct; ++a) {
            wj[a] = a < n_head ? hw[a * HL + j] : 0.0f;
            dwh[a] = 0.0f;
          }
          float db = 0.0f;
          __nv_bfloat16* row = cur + j * kLd;
#pragma unroll 1
          for (int e0 = 0; e0 < kE; e0 += 8) {
            float h[8];
            load_row8(row + e0, h);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              float dh = 0.0f;
#pragma unroll
              for (int a = 0; a <= kMaxAct; ++a) {
                if (a < n_head) {
                  const float d = mbt::round_bf16(mv[a * kE + e0 + i]);
                  dwh[a] = __fmaf_rn(d, h[i], dwh[a]);
                  dh = __fmaf_rn(wj[a], d, dh);
                }
              }
              const float dz = dh * tanh_grad<true>(h[i]);
              db = db + dz;
              h[i] = dz;
            }
            store_row8(row + e0, h);
          }
#pragma unroll
          for (int a = 0; a <= kMaxAct; ++a) {
            if (a < n_head) acc[p.p1_dwh + a * HL + j] += dwh[a];
          }
          db_last[j] += db;
        }
      } else {  // one warp per row
        for (int j = warp; j < HL; j += kWarps) {
          const float h = cur[j * kE + lane];
          float dh = 0.0f;
          for (int a = 0; a < n_head; ++a) {
            const float d = mv[a * kE + lane];
            const float s = warp_sum(d * h);
            if (lane == 0) acc[p.p1_dwh + a * HL + j] += s;
            dh = __fmaf_rn(hw[a * HL + j], d, dh);
          }
          const float dz = dh * tanh_grad<false>(h);
          const float s = warp_sum(dz);
          if (lane == 0) db_last[j] += s;
          cur[j * kE + lane] = dz;
        }
      }
    }
    __syncthreads();

    // dh_{l-1} = W_l^T dz_l per tower, then dz_{l-1} = dh_{l-1} * tanh'(h_{l-1})
    for (int l = L - 1; l >= 1; --l) {
      const int wi = p.widths[l - 1], wo = p.widths[l];
      float* db = acc + p.p1_db + p.b_off[l - 1];
      stage_out(cur, towers * wo, st + static_cast<size_t>(p.sdz_off[l]) * kE);
      stage_in(st + static_cast<size_t>(p.sh_off[l - 1]) * kE, towers * wi, nxt);
      __syncthreads();
      if constexpr (kBf16) {
        // on the tensor cores, W_l^T fragments from wf (in, out); db sums
        // the unrounded dz here, before it is stored as a bf16 operand
        for (int kb = warp * 32; kb < towers * wi; kb += kWarps * 32) {
          const int tw = kb / wi;
          float z[2][4][4];
          mma_weights_act_ieee<2, 4>(wf + p.w_off[l] + static_cast<size_t>(kb) * wo, cur + tw * wo * kLd, wo, z);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int k = kb + mt * 16 + g + half * 8;
              float s = 0.0f;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                auto* cell = reinterpret_cast<__nv_bfloat162*>(nxt + k * kLd + nt * 8 + t4 * 2);
                const float2 h = __bfloat1622float2(*cell);
                const float d0 = z[mt][nt][half * 2] * tanh_grad<true>(h.x);
                const float d1 = z[mt][nt][half * 2 + 1] * tanh_grad<true>(h.y);
                s = s + d0;
                s = s + d1;
                *cell = __floats2bfloat162_rn(d0, d1);
              }
              s += __shfl_xor_sync(0xffffffffu, s, 1);
              s += __shfl_xor_sync(0xffffffffu, s, 2);
              if (t4 == 0) db[k] += s;
            }
          }
        }
      } else {
        for (int k0 = rg * 4; k0 < towers * wi; k0 += kRowsPerSweep) {
          const int tw = k0 / wi;
          float a4[4][8];
          mbt::dense_tile<8>(wb + p.w_off[l] + static_cast<size_t>(tw) * wo * wi + (k0 - tw * wi), wi,
                             cur + tw * wo * kE + eg * 8, kE, wo, a4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int k = k0 + r;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              float* cell = nxt + k * kE + eg * 8 + e;
              *cell = a4[r][e] * tanh_grad<false>(*cell);
            }
          }
        }
        __syncthreads();
        for (int k = warp; k < towers * wi; k += kWarps) {  // db, one warp per row
          const float s = warp_sum(nxt[k * kE + lane]);
          if (lane == 0) db[k] += s;
        }
      }
      __syncthreads();
      TA* swap = cur;
      cur = nxt;
      nxt = swap;
    }

    // layer-0 weight grads from dz_0 (in cur); db0 was summed above
    if constexpr (kBf16) {
      for (int k = tid; k < H0; k += kThreads) {
        float dw[kMaxObs];
#pragma unroll
        for (int c = 0; c < kMaxObs; ++c) dw[c] = 0.0f;
#pragma unroll 1
        for (int e0 = 0; e0 < kE; e0 += 8) {
          float d[8];
          load_row8(cur + k * kLd + e0, d);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int c = 0; c < kMaxObs; ++c) {
              if (c < bp.s_dim) dw[c] = __fmaf_rn(d[i], x[c * kE + e0 + i], dw[c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kMaxObs; ++c) {
          if (c < bp.s_dim) acc[k * bp.s_dim + c] += dw[c];
        }
      }
    } else {  // one warp per row
      for (int k = warp; k < H0; k += kWarps) {
        const float dz = cur[k * kE + lane];
        for (int c = 0; c < bp.s_dim; ++c) {
          const float w = warp_sum(dz * x[c * kE + lane]);
          if (lane == 0) acc[k * bp.s_dim + c] += w;
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < p.p1_total; i += kThreads) mine[i] = acc[i];
}

// Pass 2 of the deep instantiations: CTA (x, y) owns the 64 rows [row0,
// row0 + 64) of hidden-to-hidden layer l (those of tower tw) and part y's
// tiles of the chunk; its slice dW_l[rows, 0 .. wi) (float32) is added to
// part2[y] in place.
__device__ __forceinline__ int deep_layer_of(const DeepParams& p, int block) {
  int l = 1;
  while (block >= p.rb_start[l + 1]) ++l;
  return l;
}

// On tensor cores (bf16): per tile, the 64 dz rows and the tower's wi rows
// of h_{l-1} staged into shared memory, then dW += dz h^T as in
// pass2_tensor_cores: warp w holds rows [32 (w % 2), +32) x columns
// [(w / 2) wi / 4, +wi / 4) as mma accumulator fragments.
__device__ __forceinline__ void deep_pass2_tensor_cores(const DeepParams& p, int n_tiles, int accumulate,
                                                        const __nv_bfloat16* __restrict__ stage,
                                                        float* __restrict__ part2) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4, q = lane / 8, r = lane % 8;
  const int l = deep_layer_of(p, blockIdx.x);
  const int wi = p.widths[l - 1], wo = p.widths[l];
  const int row0 = (blockIdx.x - p.rb_start[l]) * kRowBlock;  // stacked row of layer l
  const int tw = row0 / wo;
  __nv_bfloat16* dz = reinterpret_cast<__nv_bfloat16*>(sm);  // [64][kLdA]
  __nv_bfloat16* h = dz + kRowBlock * kLdA;                  // [wi][kLdA]
  const int nq = wi / 4, dm = (warp % 2) * 32, dn = (warp / 2) * nq;
  float* out = part2 + static_cast<size_t>(blockIdx.y) * p.dw_total + p.w_off[l] + static_cast<size_t>(row0) * wi;
  float acc[2][8][4];
  zero_acc(acc);
  if (accumulate) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 < nq) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = dm + mt * 16 + g + half * 8, col = dn + nt * 8 + t4 * 2;
            const float2 v = *reinterpret_cast<const float2*>(out + static_cast<size_t>(row) * wi + col);
            acc[mt][nt][half * 2] = v.x;
            acc[mt][nt][half * 2 + 1] = v.y;
          }
        }
      }
    }
  }
  int lo, hi;
  tile_range(n_tiles, gridDim.y, blockIdx.y, lo, hi);
  for (int qt = lo; qt < hi; ++qt) {
    const __nv_bfloat16* st = stage + static_cast<size_t>(qt) * p.stage_rows * kE;
    stage_in(st + static_cast<size_t>(p.sdz_off[l] + row0) * kE, kRowBlock, dz);
    stage_in(st + static_cast<size_t>(p.sh_off[l - 1] + tw * wi) * kE, wi, h);
    __syncthreads();
    // the tile's products summed in fresh fragments, then added to the
    // accumulator by IEEE float32 adds (a tensor-core accumulator truncates)
    {
      uint32_t a[2][2][4];  // [k block][row tile]
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          ldmatrix_x4(a[kb][mt], dz + (dm + mt * 16 + lane % 16) * kLdA + kb * 16 + (lane / 16) * 8);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 < nq) {
          float u[2][2][4];
          zero_acc(u);
#pragma unroll
          for (int kb = 0; kb < 2; ++kb) {
            uint32_t b[4];
            ldmatrix_x4(b, h + (dn + np * 16 + (q / 2) * 8 + r) * kLdA + kb * 16 + (q % 2) * 8);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(u[mt][0], a[kb][mt], b[0], b[1]);
              mma_bf16(u[mt][1], a[kb][mt], b[2], b[3]);
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[mt][2 * np][i] += u[mt][0][i];
              acc[mt][2 * np + 1][i] += u[mt][1][i];
            }
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt * 8 < nq) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = dm + mt * 16 + g + half * 8, col = dn + nt * 8 + t4 * 2;
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * wi + col) =
              make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
        }
      }
    }
  }
}

// On CUDA cores (float32): thread (r_own, kb) holds row r_own of the
// slice, columns [kb kq, (kb+1) kq), in registers, as pass2_cuda_cores;
// the staged planes are read into sample-major tiles.
__device__ __forceinline__ void deep_pass2_cuda_cores(const DeepParams& p, int n_tiles, int accumulate,
                                                      const float* __restrict__ stage, float* __restrict__ part2) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int l = deep_layer_of(p, blockIdx.x);
  const int wi = p.widths[l - 1], wo = p.widths[l];
  const int row0 = (blockIdx.x - p.rb_start[l]) * kRowBlock;
  const int tw = row0 / wo;
  float* dzt = sm;                    // [kE][64]
  float* ht = dzt + kE * kRowBlock;   // [kE][wi]
  const int kq = wi / 4;              // dW columns per thread
  const int r_own = tid % kRowBlock, kb = tid / kRowBlock;
  float* out = part2 + static_cast<size_t>(blockIdx.y) * p.dw_total + p.w_off[l] +
               static_cast<size_t>(row0 + r_own) * wi + kb * kq;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = (accumulate && i < kq) ? out[i] : 0.0f;
  int lo, hi;
  tile_range(n_tiles, gridDim.y, blockIdx.y, lo, hi);
  for (int qt = lo; qt < hi; ++qt) {
    const float* st = stage + static_cast<size_t>(qt) * p.stage_rows * kE;
    const float* sdz = st + static_cast<size_t>(p.sdz_off[l] + row0) * kE;
    const float* sh = st + static_cast<size_t>(p.sh_off[l - 1] + tw * wi) * kE;
    for (int i = tid; i < kRowBlock * kE; i += kThreads) dzt[(i % kE) * kRowBlock + i / kE] = sdz[i];
    for (int i = tid; i < wi * kE; i += kThreads) ht[(i % kE) * wi + i / kE] = sh[i];
    __syncthreads();
    for (int e = 0; e < kE; ++e) {
      const float d = dzt[e * kRowBlock + r_own];
      const float* hrow = ht + e * wi + kb * kq;
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
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i < kq) out[i] = acc[i];
  }
}

template <bool kBf16, typename TW>
__global__ void __launch_bounds__(kThreads, 2)
ppo_deep_pass2(const DeepParams p, int n_tiles, int accumulate, const TW* __restrict__ stage,
               float* __restrict__ part2) {
  if constexpr (kBf16) {
    deep_pass2_tensor_cores(p, n_tiles, accumulate, stage, part2);
  } else {
    deep_pass2_cuda_cores(p, n_tiles, accumulate, stage, part2);
  }
}

template <bool kBf16, bool kRowMajor>
int launch_deep(const DeepParams& p, const PpoInputs& in, const void* wf0, const void* wf, const void* wb,
                const float* bias, const float* w_head, const float* b_head, const float* log_std, void* stage,
                float* part1, float* part2, float* out_small, float* out_dw, cudaStream_t stream) {
  using TW = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  const int n_head = p.base.a_dim + 1, L = p.n_layers;
  const int HL = p.base.towers * p.widths[L - 1];
  int wi_max = 0;
  for (int l = 1; l < L; ++l) wi_max = wi_max > p.widths[l - 1] ? wi_max : p.widths[l - 1];
  const size_t smem1 = sizeof(float) * (kMaxObs * kE + n_head * kE + n_head * HL + p.p1_total) +
                       sizeof(TW) * 2 * p.h_max * (kBf16 ? kLdA : kE);
  const size_t smem2 = kBf16 ? sizeof(__nv_bfloat16) * (kRowBlock + wi_max) * kLdA
                             : sizeof(float) * kE * (kRowBlock + wi_max);
  auto* pass1 = ppo_deep_pass1<kBf16, kRowMajor, TW>;
  auto* pass2 = ppo_deep_pass2<kBf16, TW>;
  cudaError_t err = cudaFuncSetAttribute(pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(pass2, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = p.base.n_steps * (p.base.n_envs / kE);
  const int row_blocks = p.rb_start[L];
  for (int c0 = 0; c0 < n_tiles; c0 += p.chunk_tiles) {
    const int nc = n_tiles - c0 < p.chunk_tiles ? n_tiles - c0 : p.chunk_tiles;
    pass1<<<kPass1Ctas, kThreads, smem1, stream>>>(
        p, in, c0, nc, c0 > 0, static_cast<const TW*>(wf0), static_cast<const TW*>(wf), static_cast<const TW*>(wb),
        bias, w_head, b_head, log_std, static_cast<TW*>(stage), part1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (row_blocks > 0) {
      pass2<<<dim3(row_blocks, kPass2Parts), kThreads, smem2, stream>>>(p, nc, c0 > 0, static_cast<const TW*>(stage),
                                                                      part2);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  reduce_parts<<<(p.p1_total + 255) / 256, 256, 0, stream>>>(part1, kPass1Ctas, p.p1_total, out_small);
  if (p.dw_total > 0) {
    reduce_parts<<<(p.dw_total + 255) / 256, 256, 0, stream>>>(part2, kPass2Parts, p.dw_total, out_dw);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kRowMajor>
int launch_deep_dtype(const DeepParams* p, int device, const PpoInputs* in, int bf16, const void* wf0,
                      const void* wf, const void* wb, const float* bias, const float* w_head, const float* b_head,
                      const float* log_std, void* stage, float* part1, float* part2, float* out_small,
                      float* out_dw, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p->n_layers < 1 || p->n_layers > kMaxLayers || p->chunk_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_deep<true, kRowMajor>(*p, *in, wf0, wf, wb, bias, w_head, b_head, log_std, stage, part1, part2,
                                        out_small, out_dw, s);
  }
  return launch_deep<false, kRowMajor>(*p, *in, wf0, wf, wb, bias, w_head, b_head, log_std, stage, part1, part2,
                                       out_small, out_dw, s);
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's
// stream, allocates nothing and returns the first CUDA error (0 on
// success).  Weights, with H0 = towers h0 and H1 = towers h1: `wf0`
// (s, H0) layer 0's stacked (in, out) matrix; `wf1` (towers, h0, h1) each
// tower's layer-1 (in, out) matrix; `wb1` (towers, h1, h0) each tower's
// layer-1 (out, in) matrix; all bf16 when `bf16` is set and float
// otherwise, and with `bf16` set `wf1` and `wb1` are the stacked (H0, h1)
// and (H1, h0) matrices in mma fragment order (ops/mlp_rollout.py::
// pack_mma_a).  `bias` is b0 (H0) then b1 (H1); `w_head` (a+1, H1) is float,
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

// Any depth, 1-8 layers (the wrapper sends two layers to the entry points
// above): `p` from fused_ppo.py's DeepKernelParams; `wf0` (s, H0) as
// above; `wf` and `wb` every
// hidden-to-hidden layer l's stacked (in, out) and (out, in) matrices at
// p->w_off[l] (bf16 in mma fragment order with `bf16` set; float (towers,
// in, out) and (towers, out, in) otherwise); `bias` every layer's stacked
// bias at p->b_off[l]; `w_head` (a+1, stacked last width) as above.
// Scratch: `stage` (p->chunk_tiles, p->stage_rows, 32) of the operand type,
// `part1` (256, p->p1_total), `part2` (64, p->dw_total).  Results:
// `out_small` in the pass-1 partials' order and `out_dw` (p->dw_total), the
// hidden-to-hidden dW at p->w_off[l].
extern "C" int mbt_ppo_deep_grads_T(const DeepParams* p, int device, const PpoInputs* in, int bf16,
                                    const void* wf0, const void* wf, const void* wb, const float* bias,
                                    const float* w_head, const float* b_head, const float* log_std, void* stage,
                                    float* part1, float* part2, float* out_small, float* out_dw, void* stream) {
  return launch_deep_dtype<false>(p, device, in, bf16, wf0, wf, wb, bias, w_head, b_head, log_std, stage, part1,
                                  part2, out_small, out_dw, stream);
}

extern "C" int mbt_ppo_deep_grads(const DeepParams* p, int device, const PpoInputs* in, int bf16,
                                  const void* wf0, const void* wf, const void* wb, const float* bias,
                                  const float* w_head, const float* b_head, const float* log_std, void* stage,
                                  float* part1, float* part2, float* out_small, float* out_dw, void* stream) {
  return launch_deep_dtype<true>(p, device, in, bf16, wf0, wf, wb, bias, w_head, b_head, log_std, stage, part1,
                                 part2, out_small, out_dw, stream);
}
