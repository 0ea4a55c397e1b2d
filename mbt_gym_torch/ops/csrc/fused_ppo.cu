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
// input addressing and K7's float32 saved activations (below), the
// kRowMajor template parameter: a K7 tile is 32 consecutive samples of S
// (A) contiguous floats each, a K4 tile 32 consecutive envs of one step.
// Neither has the TPU kernels' 128-lane metrics row, lane-tile
// divisibility or VMEM tiling.
//
// Shapes.  Like the JAX kernels, any depth of 1-8 trunk layers (one
// instantiation serves every depth: the layer loop runs over DeepParams'
// widths), S <= 16 observation columns (K3's limit) and A <= 4 actions.
// Widths reach the kernels as multiples of 64 (the wrapper pads each hidden
// width with exact zeros, ops/fused_ppo.py): a pass-2 CTA owns 64 rows of
// a layer, and its dW warp tiles split the layer's input width into four
// runs of 16-column mma tiles.
//
// Stacked towers (towers = 2): each carry is 2 h_l wide, pi block first.
// Layer 0 is one product over the stacked rows, since both towers read the
// observation; every later layer and its transpose are one product per
// tower, row block t reading only block t of the layer below, so no
// block-diagonal padding is computed.  The merged (A+1, 2 h_{L-1}) head
// holds the pi rows over the pi block and the vf row over the vf block with
// exact zeros elsewhere (the wrapper builds it): mean and value come from
// their own tower, the zero blocks add exact zeros to every in-block value,
// and the wrapper keeps only the in-block head gradients.
//
// Design: the float32 accumulator of a 256x256 weight gradient (256 KB;
// two of them with towers) exceeds the 227 KB of shared memory a block may
// hold, so the JAX kernels' one-program accumulation does not carry over;
// atomics into device memory would make the sum order change from run to
// run.  Three deterministic passes instead, over tiles of 32 samples:
//   pass 1, 256 CTAs, each a fixed contiguous range of tiles: the full
//     forward (two activation tiles in shared memory), the loss, and the
//     backward down to the input layer.  Per-CTA partial sums of every
//     gradient except the hidden-to-hidden dW (dW0, every db, the head,
//     log_std, metrics); each tile's inputs of the hidden-to-hidden layers
//     (h_0 .. h_{L-2}) and their gradients (dz_1 .. dz_{L-1}) staged in
//     device memory.
//   pass 2, (row blocks of 64) x 64 CTAs: each owns 64 rows of one
//     hidden-to-hidden layer (of one tower) and a fixed range of tiles,
//     holds its 64 x h_in slice of that layer's dW in registers and reads
//     the staged planes.  L = 1 has no pass 2.
//   pass 3: partial sums reduced over the CTAs in a fixed order.
// The staged planes of a whole minibatch would not fit (1.68 GB a 256-wide
// bf16 plane at 3,276,800 samples), so passes 1 and 2 run in turn over
// chunks of tiles, the scratch bounded by the wrapper (fused_ppo.py
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
// reading the samples binds.  The staged planes (none at L = 1 in K4; 1 KB
// a sample at 256x256 and 2 KB at 256x256x256 in bf16; in K7's bf16
// instantiation 1 KB at 256, 2.5 KB and 4 KB) add traffic that the bound
// leaves out.
//
// What the design does about it.  In the bf16 instantiations every
// hidden-to-hidden product runs on the tensor cores as warp-level
// mma.sync.m16n8k16 (bf16 operands, float32 sums): the forward Z_l =
// W_l H_{l-1} and the transpose dH_{l-1} = W_l^T dZ_l (pass 1), and dW_l +=
// dZ_l H_{l-1}^T over a tile's samples (pass 2).  Activation tiles are bf16
// in shared memory (they are bf16 operands already, so storing them so
// changes no value) and reach the mma through ldmatrix.  The weights come
// in mma fragment order (the wrapper packs wb for the forward and wf for the
// transpose), read from device memory through L2, one 16-byte load per lane
// and 16x16 block with two k blocks in flight (at most 256 KB of bf16 a
// layer, resident in the 50 MB L2).  Each k block's products are summed in
// a fresh fragment and added to the accumulator by IEEE float32 adds: a
// tensor-core accumulator truncates, and down a chain of products that bias
// flips bf16 roundings of the saved activations and of dz.  Layer 0 (k = S
// <= 16), the merged head (A+1 <= 5 rows), the loss, the bias, dW0 and
// log_std gradients and the metrics stay on CUDA cores; there the per-row
// sums over a tile's samples are one thread per row (float32: warp
// butterflies), in a fixed order.  dW0's thread keeps one float32 sum per
// observation column in registers, in sweeps of 8 columns (a second sweep
// re-reads the tile's dz row from shared memory at S > 8), so that every
// instantiation stays inside the 128 registers of __launch_bounds__(256,
// 2).  The float32 instantiations keep every product on CUDA cores with
// explicit FMAs (dense.cuh): TF32 would break their rtol of 1e-4.
// What still holds it back (chip_smoke.py, PERF.md): CUDA-core work (layer
// 0's tanh and the head), the staged planes' traffic, the per-tile L2 reads
// of the weights in pass 1, and mma.sync, which issues a 16x8 product per
// warp where wgmma issues 64xN per warpgroup with operands from shared
// memory.  wgmma with TMA-staged weights is the next step.
//
// Numerics follow the plain PyTorch versions (ops/fused_ppo.py) in both
// compute dtypes.  bf16: every matmul operand rounded to bf16 with a
// float32 sum.  K4 (the JAX _kernel_T's points, fused_ppo.py:276 and :314)
// also rounds the saved activations to bf16 and evaluates tanh' = 1 - h*h
// in bf16 (h*h rounded, then 1 - that rounded) before it multiplies the
// float32 dh.  K7 (the JAX _kernel's points, :90-94 and :141-142) keeps
// the saved activations and 1 - h*h in float32: its bf16 instantiation
// writes each layer's float32 h to a staged plane in device memory beside
// the bf16 operand tile (h_0 .. h_{L-1}, the last layer's too, which the
// head's backward reads), reads tanh' from there, and pass 2 rounds those
// planes to bf16 operands as it loads them.  dz is staged as K4 stages it,
// a bf16 plane: it is a matmul operand only, rounded in the tile already.
// Staging, rather than a float32 tile in shared memory (64 KB at 8 x 256
// with towers) or a recompute, keeps the shared-memory request and the
// instantiation's registers as K4's, at the price of two bytes more a
// staged h value.  float32: no rounding.  Bias gradients and metrics sum the
// unrounded float32 values (db in the transpose's epilogue, before dz is
// stored as a bf16 operand).  The tensor cores sum in another order than
// an FMA chain, so a rare bf16 rounding of a saved value may differ from
// the plain version's.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense.cuh"
#include "mma.cuh"

constexpr int kMaxObs = 16;
constexpr int kMaxAct = 4;
constexpr int kMaxLayers = 8;

// Mirrors PpoKernelParams in mbt_gym_torch/ops/fused_ppo.py (ctypes).
struct PpoKernelParams {
  int n_steps;   // T (1 for row-major inputs)
  int n_envs;    // nb, envs of the minibatch (M for row-major inputs)
  int s_dim;
  int a_dim;
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

// Mirrors DeepKernelParams in mbt_gym_torch/ops/fused_ppo.py (ctypes),
// which computes every offset.  Widths are per tower and multiples of 64;
// "rows" count stacked rows (towers x width).
struct DeepParams {
  PpoKernelParams base;
  int n_layers;
  int h_max;        // the widest stacked layer
  int tile_bytes;   // staged bytes per tile
  int chunk_tiles;  // tiles per chunk
  int p1_db;        // pass-1 partials: dW0 (H0, s) at 0 | db of every layer | dWh | dbh | dlog_std | metrics
  int p1_dwh;
  int p1_dbh;
  int p1_total;
  int dw_total;     // the hidden-to-hidden dW, layers 1 .. L-1 in order
  int widths[kMaxLayers];
  int w_off[kMaxLayers];    // layer l >= 1: its matrices in wf and wb (and its dW in the dW output)
  int b_off[kMaxLayers];    // layer l's bias and db
  int sh_off[kMaxLayers];   // byte offset of h_l's plane within a tile: l <= L-2 (K7 in bf16: l <= L-1)
  int sdz_off[kMaxLayers];  // byte offset of dz_l's plane, l >= 1
  int rb_start[kMaxLayers + 1];  // pass-2 row blocks of layer l: [rb_start[l], rb_start[l + 1])
};

namespace {

constexpr int kThreads = 256;
constexpr int kE = 32;          // samples per tile
constexpr int kPass1Ctas = 256;
constexpr int kPass2Parts = 64;
constexpr int kRowBlock = 64;   // layer rows per pass-2 CTA
constexpr int kRowsPerSweep = 4 * (kThreads / 4);  // rows one dense sweep covers (8 envs/thread)
constexpr int kObsSweep = 8;    // observation columns one dW0 sweep sums in registers

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

// tanh' = 1 - h*h: in bf16 at K4's rounding points (kRound), else float32
template <bool kRound>
__device__ __forceinline__ float tanh_grad(float h) {
  if constexpr (kRound) {
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
// have been multiplied.  Each k block's products are summed in a fresh
// fragment and added to `acc` by IEEE float32 adds: a tensor-core
// accumulator truncates, and down a chain of up to seven such products and
// their transposes that bias flips bf16 roundings of the saved activations
// and of dz (1.5e-2 of a bias gradient at 8 x 256 with towers over 81,920
// samples, against 1.8e-3 with these adds).
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

// Eight consecutive floats of a staged float32 plane in device memory (two
// 16-byte accesses), and their store.
__device__ __forceinline__ void load_f8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store_f8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Layer 0 for the tile over the `rows` rows of the stacked (s, rows)
// matrix `wf0`: h[k][e] = op(tanh(W0 x + b0)), row stride kLd; with `hf`
// (K7's bf16 instantiation) also the unrounded float32 values, [rows][kE]
// in device memory.  A thread computes 4 rows x 8 samples per sweep.  Into
// bf16 tiles, neighbouring lanes take neighbouring sample runs and a thread
// stores its run of a row at once, so the stores meet no bank conflict.
template <bool kBf16, typename TW, typename TA>
__device__ __forceinline__ void layer0(const PpoKernelParams& p, const TW* wf0, const float* b0, int rows,
                                       const float* x, TA* h, float* hf) {
  constexpr bool kPacked = !std::is_same<TA, float>::value;
  constexpr int ET = 8, kGroups = kE / ET, kRowGroups = kThreads / kGroups;
  constexpr int kLd = kPacked ? kLdA : kE;
  const int rg = kPacked ? threadIdx.x / kGroups : threadIdx.x % kRowGroups;
  const int eg = kPacked ? threadIdx.x % kGroups : threadIdx.x / kRowGroups;
  for (int r0 = rg * 4; r0 < rows; r0 += 4 * kRowGroups) {
    float acc[4][ET];
    mbt::dense_tile<ET>(wf0 + r0, rows, x + eg * ET, kE, p.s_dim, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = r0 + r;
      float v[ET];
#pragma unroll
      for (int e = 0; e < ET; ++e) v[e] = tanhf(acc[r][e] + b0[k]);
      if constexpr (kPacked) {
        if (hf) store_f8(hf + k * kE + eg * ET, v);
        store_row8(h + k * kLd + eg * ET, v);  // rounds to the bf16 operand
      } else {
#pragma unroll
        for (int e = 0; e < ET; ++e) h[k * kLd + eg * ET + e] = mbt::operand<kBf16>(v[e]);
      }
    }
  }
}

// `rows` rows of an activation tile (row stride kLdA bf16 or kE floats in
// shared memory) to a staged plane of the same type in device memory
// ([rows][kE] contiguous), 16 bytes a read.
template <typename TA>
__device__ __forceinline__ void stage_out(const TA* tile, int rows, TA* plane) {
  constexpr int kLd = std::is_same<TA, float>::value ? kE : kLdA;
  constexpr int kVec = 16 / sizeof(TA), kPerRow = kE / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = i % kPerRow;
    reinterpret_cast<uint4*>(plane)[i] = *reinterpret_cast<const uint4*>(tile + r * kLd + c * kVec);
  }
}

// The converse: a staged plane to a tile, a float plane rounded to bf16
// operands where the tile is bf16 (K7's h planes in its bf16 pass 2).
template <typename TS, typename TA>
__device__ __forceinline__ void stage_in(const TS* plane, int rows, TA* tile) {
  constexpr int kLd = std::is_same<TA, float>::value ? kE : kLdA;
  constexpr int kVec = 16 / sizeof(TA), kPerRow = kE / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = i % kPerRow;
    if constexpr (std::is_same<TA, TS>::value) {
      *reinterpret_cast<uint4*>(tile + r * kLd + c * kVec) = reinterpret_cast<const uint4*>(plane)[i];
    } else {
      static_assert(std::is_same<TS, float>::value && kVec == 8, "a float plane to a bf16 tile");
      float v[8];
      load_f8(plane + r * kE + c * 8, v);
      store_row8(tile + r * kLd + c * kVec, v);
    }
  }
}

// Pass 1 keeps two activation tiles in shared memory and stages every input
// of a hidden-to-hidden layer and every such layer's dz in device memory;
// the backward reads h_{l-1} back from there (through L2, where this CTA
// has just written it).  A tile's planes lie p.tile_bytes apart, each at
// its byte offset: the h planes of type TH, the dz planes of the operand
// type TW.  kF32H (K7 in bf16): TH is float, and h_0 .. h_{L-1} are
// written by the forward's epilogues (see the header).
template <bool kBf16, bool kRowMajor, typename TW, typename TH>
__global__ void __launch_bounds__(kThreads, 2)
ppo_deep_pass1(const DeepParams p, const PpoInputs in, int tile0, int n_tiles, int accumulate,
               const TW* __restrict__ wf0, const TW* __restrict__ wf, const TW* __restrict__ wb,
               const float* __restrict__ bias, const float* __restrict__ w_head,
               const float* __restrict__ b_head, const float* __restrict__ log_std, char* __restrict__ stage,
               float* __restrict__ part1) {
  constexpr bool kF32H = kBf16 && kRowMajor;
  static_assert(std::is_same<TH, typename std::conditional<kF32H, float, TW>::type>::value, "h plane type");
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
    char* st = stage + static_cast<size_t>(q) * p.tile_bytes;  // this tile's staged planes
    auto h_plane = [&](int l) { return reinterpret_cast<TH*>(st + p.sh_off[l]); };
    auto dz_plane = [&](int l) { return reinterpret_cast<TW*>(st + p.sdz_off[l]); };
    // h_l's float32 plane (K7 in bf16), else none
    auto hf = [&](int l) -> float* {
      if constexpr (kF32H) {
        return h_plane(l);
      } else {
        return nullptr;
      }
    };
    load_obs<kBf16, kRowMajor>(bp, in.obs, t, env0, x);
    __syncthreads();
    layer0<kBf16>(bp, wf0, bias, H0, x, cur, hf(0));
    __syncthreads();
    // hidden-to-hidden layers: rows [tw ho, (tw+1) ho) read rows [tw hi, (tw+1) hi)
    for (int l = 1; l < L; ++l) {
      const int wi = p.widths[l - 1], wo = p.widths[l];
      const float* bl = bias + p.b_off[l];
      if constexpr (!kF32H) stage_out(cur, towers * wi, h_plane(l - 1));
      if constexpr (kBf16) {
        float* hf_l = hf(l);
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
                const float v0 = tanhf(z[mt][nt][half * 2] + bl[j]), v1 = tanhf(z[mt][nt][half * 2 + 1] + bl[j]);
                *reinterpret_cast<__nv_bfloat162*>(nxt + j * kLd + nt * 8 + t4 * 2) = __floats2bfloat162_rn(v0, v1);
                if constexpr (kF32H) *reinterpret_cast<float2*>(hf_l + j * kE + nt * 8 + t4 * 2) = make_float2(v0, v1);
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
        const float* hf_last = hf(L - 1);
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
            // h: the bf16 operand, and tanh' from the float32 h in K7
            float h[8];
            if constexpr (kF32H) {
              load_f8(hf_last + j * kE + e0, h);
            } else {
              load_row8(row + e0, h);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float hop = kF32H ? mbt::round_bf16(h[i]) : h[i];
              float dh = 0.0f;
#pragma unroll
              for (int a = 0; a <= kMaxAct; ++a) {
                if (a < n_head) {
                  const float d = mbt::round_bf16(mv[a * kE + e0 + i]);
                  dwh[a] = __fmaf_rn(d, hop, dwh[a]);
                  dh = __fmaf_rn(wj[a], d, dh);
                }
              }
              const float dz = dh * tanh_grad<!kF32H>(h[i]);
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
      stage_out(cur, towers * wo, dz_plane(l));
      if constexpr (!kF32H) stage_in(h_plane(l - 1), towers * wi, nxt);
      __syncthreads();
      if constexpr (kBf16) {
        // on the tensor cores, W_l^T fragments from wf (in, out); db sums
        // the unrounded dz here, before it is stored as a bf16 operand
        const float* hf_in = hf(l - 1);
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
                float2 h;
                if constexpr (kF32H) {
                  h = *reinterpret_cast<const float2*>(hf_in + k * kE + nt * 8 + t4 * 2);
                } else {
                  h = __bfloat1622float2(*cell);
                }
                const float d0 = z[mt][nt][half * 2] * tanh_grad<!kF32H>(h.x);
                const float d1 = z[mt][nt][half * 2 + 1] * tanh_grad<!kF32H>(h.y);
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
      // one thread per row, kObsSweep columns a sweep over the tile's samples
      for (int k = tid; k < H0; k += kThreads) {
        for (int c0 = 0; c0 < bp.s_dim; c0 += kObsSweep) {
          float dw[kObsSweep];
#pragma unroll
          for (int c = 0; c < kObsSweep; ++c) dw[c] = 0.0f;
#pragma unroll 1
          for (int e0 = 0; e0 < kE; e0 += 8) {
            float d[8];
            load_row8(cur + k * kLd + e0, d);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
              for (int c = 0; c < kObsSweep; ++c) {
                if (c0 + c < bp.s_dim) dw[c] = __fmaf_rn(d[i], x[(c0 + c) * kE + e0 + i], dw[c]);
              }
            }
          }
#pragma unroll
          for (int c = 0; c < kObsSweep; ++c) {
            if (c0 + c < bp.s_dim) acc[k * bp.s_dim + c0 + c] += dw[c];
          }
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

// Pass 2: CTA (x, y) owns the 64 rows [row0, row0 + 64) of hidden-to-hidden
// layer l (those of tower tw) and part y's tiles of the chunk; its slice
// dW_l[rows, 0 .. wi) (float32) is added to part2[y] in place.
__device__ __forceinline__ int deep_layer_of(const DeepParams& p, int block) {
  int l = 1;
  while (block >= p.rb_start[l + 1]) ++l;
  return l;
}

// On tensor cores (bf16): per tile, the 64 dz rows and the tower's wi rows
// of h_{l-1} staged into shared memory (h rounded to bf16 operands from
// K7's float32 planes), then dW += dz h^T: warp w holds rows [32 (w % 2), +32) x
// columns [(w / 2) wi / 4, +wi / 4) of the slice as mma accumulator
// fragments (at most 64 floats a thread).  The tile's products are summed
// in fresh fragments and added to the accumulator by IEEE float32 adds (a
// tensor-core accumulator truncates, and over a CTA's ~1,600 tiles that
// bias would add up: 3.6e-4 of dW1 at config 5).
template <typename TH>
__device__ __forceinline__ void deep_pass2_tensor_cores(const DeepParams& p, int n_tiles, int accumulate,
                                                        const char* __restrict__ stage, float* __restrict__ part2) {
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
    const char* st = stage + static_cast<size_t>(qt) * p.tile_bytes;
    stage_in(reinterpret_cast<const __nv_bfloat16*>(st + p.sdz_off[l]) + row0 * kE, kRowBlock, dz);
    stage_in(reinterpret_cast<const TH*>(st + p.sh_off[l - 1]) + tw * wi * kE, wi, h);
    __syncthreads();
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
// slice, columns [kb kq, (kb+1) kq), in registers; the staged planes are
// read into sample-major tiles.
__device__ __forceinline__ void deep_pass2_cuda_cores(const DeepParams& p, int n_tiles, int accumulate,
                                                      const char* __restrict__ stage, float* __restrict__ part2) {
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
    const char* st = stage + static_cast<size_t>(qt) * p.tile_bytes;
    const float* sdz = reinterpret_cast<const float*>(st + p.sdz_off[l]) + row0 * kE;
    const float* sh = reinterpret_cast<const float*>(st + p.sh_off[l - 1]) + tw * wi * kE;
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

// Instantiations: <true, bf16> (K4 in bf16), <true, float> (K7 in bf16,
// float32 h planes), <false, float> (both in float32).
template <bool kBf16, typename TH>
__global__ void __launch_bounds__(kThreads, 2)
ppo_deep_pass2(const DeepParams p, int n_tiles, int accumulate, const char* __restrict__ stage,
               float* __restrict__ part2) {
  if constexpr (kBf16) {
    deep_pass2_tensor_cores<TH>(p, n_tiles, accumulate, stage, part2);
  } else {
    deep_pass2_cuda_cores(p, n_tiles, accumulate, stage, part2);
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
int launch_deep(const DeepParams& p, const PpoInputs& in, const void* wf0, const void* wf, const void* wb,
                const float* bias, const float* w_head, const float* b_head, const float* log_std, void* stage,
                float* part1, float* part2, float* out_small, float* out_dw, cudaStream_t stream) {
  using TW = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  using TH = typename std::conditional<kBf16 && kRowMajor, float, TW>::type;  // the staged h planes
  const int n_head = p.base.a_dim + 1, L = p.n_layers;
  const int HL = p.base.towers * p.widths[L - 1];
  int wi_max = 0;
  for (int l = 1; l < L; ++l) wi_max = wi_max > p.widths[l - 1] ? wi_max : p.widths[l - 1];
  const size_t smem1 = sizeof(float) * (kMaxObs * kE + n_head * kE + n_head * HL + p.p1_total) +
                       sizeof(TW) * 2 * p.h_max * (kBf16 ? kLdA : kE);
  const size_t smem2 = kBf16 ? sizeof(__nv_bfloat16) * (kRowBlock + wi_max) * kLdA
                             : sizeof(float) * kE * (kRowBlock + wi_max);
  auto* pass1 = ppo_deep_pass1<kBf16, kRowMajor, TW, TH>;
  auto* pass2 = ppo_deep_pass2<kBf16, TH>;
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
        bias, w_head, b_head, log_std, static_cast<char*>(stage), part1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (row_blocks > 0) {
      pass2<<<dim3(row_blocks, kPass2Parts), kThreads, smem2, stream>>>(p, nc, c0 > 0,
                                                                      static_cast<const char*>(stage), part2);
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
  if (p->n_layers < 1 || p->n_layers > kMaxLayers || p->chunk_tiles < 1 || p->base.s_dim < 1 ||
      p->base.s_dim > kMaxObs || p->base.a_dim < 1 || p->base.a_dim > kMaxAct) {
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
// success).  `p` from fused_ppo.py's DeepKernelParams (1-8 layers, S <=
// 16, A <= 4, a multiple of 32 samples per step, widths multiples of 64 up
// to 256 per tower).  Weights: `wf0` (s, H0) layer 0's stacked (in, out)
// matrix; `wf` and `wb` every hidden-to-hidden layer l's stacked (in, out)
// and (out, in) matrices at p->w_off[l] (bf16 in mma fragment order,
// ops/mlp_rollout.py::pack_mma_a, with `bf16` set; float (towers, in, out)
// and (towers, out, in) otherwise); `bias` every layer's stacked bias at
// p->b_off[l]; `w_head` (a+1, stacked last width) float, already rounded
// to bf16 in bf16 mode, zero off its towers' blocks.  Scratch: `stage`,
// p->chunk_tiles tiles of p->tile_bytes, each tile's planes (32 samples a
// row) at the byte offsets p->sh_off and p->sdz_off, of the operand type
// (h float in K7's bf16 mode), `part1` (256, p->p1_total), `part2` (64,
// p->dw_total).
// Results: `out_small` in the pass-1 partials' order and `out_dw`
// (p->dw_total), the hidden-to-hidden dW at p->w_off[l].

// K4: feature-major views, p->base.n_steps = T, p->base.n_envs = nb.
extern "C" int mbt_ppo_deep_grads_T(const DeepParams* p, int device, const PpoInputs* in, int bf16,
                                    const void* wf0, const void* wf, const void* wb, const float* bias,
                                    const float* w_head, const float* b_head, const float* log_std, void* stage,
                                    float* part1, float* part2, float* out_small, float* out_dw, void* stream) {
  return launch_deep_dtype<false>(p, device, in, bf16, wf0, wf, wb, bias, w_head, b_head, log_std, stage, part1,
                                  part2, out_small, out_dw, stream);
}

// K7: row-major views, p->base.n_steps = 1, p->base.n_envs = M.
extern "C" int mbt_ppo_deep_grads(const DeepParams* p, int device, const PpoInputs* in, int bf16,
                                  const void* wf0, const void* wf, const void* wb, const float* bias,
                                  const float* w_head, const float* b_head, const float* log_std, void* stage,
                                  float* part1, float* part2, float* out_small, float* out_dw, void* stream) {
  return launch_deep_dtype<true>(p, device, in, bf16, wf0, wf, wb, bias, w_head, b_head, log_std, stage, part1,
                                 part2, out_small, out_dw, stream);
}
