// K3: the fused PPO collection episode for Hopper (sm_90a).
//
// Replaces the TPU kernel mlp_rollout_pallas
// (mbt_gym_tpu/ops/pallas_rollout.py:1514, pallas_call at :1634) for the
// MLP policy on four dynamics kinds, each its own instantiation (template
// parameter kDyn): "limit" (exponential fills, limit-order dynamics,
// A = 2), "lam" (limit orders plus unit market orders, A = 4), "touch"
// (post-or-not at a fixed half-spread, A = 2) and "speed" (trading speed
// against price impact, A = 1); the PnL, pathwise CJ market-making (CjMm),
// running-penalty or, on speed, CJ execution (CjOe) reward at any inventory
// exponent, or the terminal exponential utility; a fixed or random (the t0
// plane) start time, a fixed or per-env (inv0) initial inventory, the
// optional terminal observation, both actor-critic layouts.
// Each step, per env:
// the (normalised) observation, the trunk h = tanh(W h + b) layer by
// layer, the merged (A+1)-row head giving mean and value, the Gaussian
// sample and its log-prob, the clipped and denormalised action, then the
// env step (pallas_rollout.py:724-754, 849-897, 992-1052, 1078-1153).
// Outputs: obs (T, S, N) as the policy saw it, the unclipped action
// (T, A, N), log-prob, value and reward (T, N).
//
// Bound on the H100: operations.  At config 5 (262,144 envs x 200 steps,
// 256x256 trunk) the matmuls are 134,656 FLOP per env-step (7.06 TFLOP),
// 7.1 ms at the bf16 tensor-core peak, against 1.89 GB of outputs
// (0.56 ms).  Below that sits a CUDA-core floor the tensor cores do not
// touch: every env-step evaluates 512 accurate tanhf (1,024 with towers).
//
// bf16 instantiation (normalised observations), on the tensor cores.  A CTA
// of 512 threads (16 warps) owns a tile of 128 envs for all steps (the last
// tile masked: envs past n compute on zeros and store nothing).  The
// weights are staged once per CTA in shared memory in mma fragment order
// (the wrapper packs them, ops/mlp_rollout.py::pack_tower_bf16, and pads
// every width to a multiple of 16 with exact zeros), so each A fragment is
// one 16-byte load.  Per step the layer's input sits in shared memory
// feature-major as bf16 at a row stride of 136 (128 envs + 8:
// conflict-free ldmatrix and epilogue stores), and every layer is
// mma.sync.m16n8k16 (mma.cuh) with the (out, in) matrix as A and the
// activation tile as B through ldmatrix.trans: layer 0 reads the
// observation tile, its k = S padded to 16 with zero rows and columns, each
// inner layer the one activation tile.  Warp w holds rows [32 (w / 2), +32)
// x envs [64 (w % 2), +64) of a layer's output as 64 float accumulators; a
// second activation tile does not fit beside W1, so the epilogue (bias,
// tanhf, round to bf16) overwrites the layer's input after a barrier.  The
// head is one more product over the last layer's output in the activation
// tile: its A+1 <= 3 rows zero-padded to one 16-row block, staged in
// fragment order, warp w taking envs [8 w, +8), its k blocks summed in four
// accumulators added in a fixed order.  Shared memory at 256x256: 136 KB of
// weights (layer 0 8 KB, W1 128 KB), 2 KB biases, 8 KB head, 4 KB
// observation tile, 68 KB activation tile, 1.5 KB head output: 220 KB of
// the 227 KB a block may hold, so one CTA per SM.  A trunk whose inner
// layers do not fit reads their fragments from device memory (through L2)
// instead.  The env step runs one thread per env on the first 128 threads
// (warps 0-3, one per SM sub-partition).  Five barriers per step at two
// layers.
// Tried on the card and not kept (probe runs, not part of the repository):
// the head from the last layer's accumulators (tanh, round, multiply by
// the head rows, a shuffle reduce-scatter over a column's lanes, row-group
// partials in shared memory) cost several times the mma head, its
// register arrays going to local memory; two halves of 8 warps with their
// own named barriers, with or without taking turns on the products, gained
// nothing (a half's product alone runs at half the rate); 256 threads with
// 32 x 128 warp tiles were no faster.  What the time goes to, in order: the
// two tanhf epilogues (each tanhf runs a MUFU.EX2 and a MUFU.RCP, and the
// special-function units are the busiest pipe there), the inner product on
// mma.sync, the env step on 4 of the 16 warps, the head.
//
// Separate pi/vf towers (the JAX kernel's stacked-trunk split_at mode,
// pallas_rollout.py:668-712 and :858-873): the weights of two 256x256
// towers do not fit in shared memory, and the env step needs only the pi
// tower's mean.  So a CTA runs its episode in two phases: phase 1 stages
// the pi tower and runs the steps above with the pi head's A rows (the
// value is not written); phase 2 restages the same buffers with the vf
// tower and, step by step, reads back the observations its own threads
// wrote in phase 1 and writes the vf head's value.  Each tower's products
// are those of the JAX kernel's stacked trunk (layer 0's stacked rows are
// independent dot products, the inner layers per-tower products, the
// merged head's zero blocks add exact zeros), so the values are the same
// sums.  Both phases are one launch.
//
// Trunks past 256 rows (the wide route, Layout::scratch).  The JAX kernel
// takes any trunk, sizing its tile to the width; so does this one.  A
// layer wider than the 256 rows the 16 warps cover needs its input tile
// beside its output tile, and two 512-row tiles of 128 envs (278 KB) do
// not fit in shared memory; nor do any trunk's weights past 256 x 256.  So
// on the wide route each CTA keeps two activation tiles ([rows][128] bf16)
// in device memory (`scratch`, L2-resident while the CTA works on them),
// and every layer is computed in passes of 256 output rows; a layer past
// layer 0 streams its input back through one 256-row tile in shared
// memory, chunk by chunk, every warp adding each chunk's products to its
// accumulators before the next chunk is copied, and the head reads the
// last layer the same way.  Weights, biases and the head are read from
// device memory through L2.  The k blocks are summed in the narrow route's
// order, so at a width both routes take they give the same bits.  The
// route is a kernel of its own (mlp_rollout_wide_kernel, one per bf16
// instantiation): beside the narrow route in one kernel its loop state
// pushed the narrow instantiations past their 128 registers into spills.
// It is also a library of its own (mlp_rollout_wide.cu: this file with
// MBT_K3_WIDE set, which instantiates mlp_rollout_wide_kernel alone), so
// that its twelve instantiations compile beside the narrow ones.
// It costs the tiles' L2 traffic, the per-chunk barriers and every weight
// read twice a step, once for each half of a warp's envs (at 512 x 512,
// 1 MB a step for each CTA).
//
// float32 instantiation (raw observations), on CUDA cores: a CTA of 256
// threads owns 32 envs; per step the activations sit in shared memory
// feature-major ([width][32] floats; past what shared memory holds, in a
// device-memory scratch, two per CTA, the head and biases then read where
// they are) and each layer is a register tile (dense.cuh, 4 rows x 8 envs
// a thread, 256 rows a sweep) reading the weights through L1/L2; the head
// is one thread per (row, env); the env state lives in warp 0.
//
// Numerics follow the plain PyTorch version (ops/mlp_rollout.py):
// with normalised observations every matmul operand is rounded to bf16
// (round to nearest even) with a float32 sum; otherwise all float32.
// Biases, tanhf and everything after are float32.  A layer's output is
// stored rounded to the operand type; its only uses are as the next
// product's operand, which rounds it anyway.  The tensor cores sum a
// product in another order than the plain version's matmul.  Zero-padded
// rows and columns add exact zeros.  The env step repeats the plain
// version's float32 op order (build flag --fmad=false; the CUDA-core
// products use explicit FMAs, exact on bf16 operands).  Fixed warp tiles
// and a fixed reduction order make a repeated launch bitwise equal.
//
// Dynamics kinds (pallas_rollout.py:992-1052): one instantiation each, so
// the limit kind's code and bits stay those of the kernel before the other
// kinds came (a runtime branch in one kernel had cost K5 11-64%).  "lam"
// fires a unit market order where its column, clipped to [0, 1], exceeds
// 0.5, buying at mid + half-spread and selling at mid - half-spread before
// the limit bookkeeping; with mask_mo set, a buy is blocked at +max
// inventory and a sell at -max, on the pre-step inventory.  "touch" takes
// the clipped post columns as the fills (continuous, as the engine does)
// at mid -/+ half-spread.  The lam kind's head has A + 1 = 5 rows.
// Initial inventory: the per-env inv0 plane when given (a random initial
// inventory), else the constant; the CjMm constant (alpha dt / ep_len)
// q(inv0) is formed per env at the start, the float32 product of the
// wrapper's float32 coefficient and q(inv0), the constant's bits.
//
// Speed dynamics (pallas_rollout.py:1056-1072): the executed speed trades
// speed * dt at the mid plus the impact of the pre-update state, then the
// impact state steps; the impact state is observed after the price (S = 5,
// 4 with the stateless power impact).  The head has A + 1 = 2 rows; the
// draws are the limit kind's, eps1 unread.  Temporary-and-permanent impact
// on the BM midprice (bench_suite config 6) runs the speed kind's plain
// instantiation, the other impact and midprice models its general one
// (proc_kinds.cuh: speed_impact, midprice_step, as K5 runs them).
//
// Extras (template parameter kExtra, on the general instantiations only,
// whose bits on the plain processes are the plain instantiations'): the t0
// plane of a random start (pallas_rollout.py:1303-1320, :1352-1358) and the
// terminal observation (:1432-1438), so the main paths' instantiations do
// not carry them.  Under t0 the episode spans the full horizon: step i
// observes the time min(t0 + i dt, terminal); a step starting at or past
// terminal - dt / 2 is post-done (state frozen, reward 0) and one at or
// past terminal - 1.5 dt the last; each env's CjMm constant is
// (alpha dt / (terminal - t0)) q(inv0) and its CjOe constant
// q(inv0) (terminal - t0).  The terminal observation is the final state's
// at start + T dt.
//
// Rewards (pallas_rollout.py:1136-1191): the reward kind and the exponent
// are fields of the kernel's parameters, not template arguments.  The
// exponential utility, -exp(-gamma (cash + inventory price)) at the last
// step and 0 before (times the terminal flag, as JAX multiplies), is one
// more branch beside the inventory terms; CjOe runs in the speed kind.  The PnL
// kind takes one uniform branch past the inventory terms and computes what
// it computed before (its bits unchanged; at config 5 within 0.1% of the
// kernel without the branch, measured on the H100); CjMm and the running
// penalty add q(new_inv) (and CjMm q(inv)), where q is x * x at exponent
// 2, x at 1 and powf otherwise, as the plain version branches, with the
// wrapper's float32 constants dt * phi, alpha and alpha * dt / ep_len.  The env step runs on 128 of the CTA's
// 512 threads, so the longer branch costs the step little (CjMm +0.6% at
// config 5).
//
// Process kinds (template parameter kProc, proc_kinds.cuh): the plain
// processes (BM midprice, linear Poisson arrivals, exponential fills) run
// the instantiations above (kProcPlain), whose code is the kernel's from
// before the other kinds came; every other midprice model, the
// exact-probability Poisson and Hawkes arrivals, the triangular, power and
// exogenous-market-maker fills run each dynamics kind's general
// instantiation (kProcGeneral), the kinds runtime fields of p.proc (the
// same choice as K5's inventory exponent: a new kind is a new
// instantiation, not a branch in the old code).  The composite stress
// family (bench_suite config 10) runs the lam kind's general instantiation
// too: one with its kinds fixed at compile time saved 2.2% of K3's time on
// the H100, too little to pay for two more kernels.  These carry the
// process states (the second midprice column, the Hawkes intensities,
// the exogenous depths) in the env threads' registers and observe them
// after the price, S up to 16 (layer 0's padded k).
//
// Noise: noise mode reads (T, 7, N) channels in the JAX order (u_arr_bid,
// u_arr_ask, u_fill_bid, u_fill_ask, eps0, eps1, mid normal); the lam kind
// reads (T, 9, N), eps0..eps3 then the mid normal; the general kinds add the
// exogenous normals and the second midprice normal after it
// (p.proc.channels a step, at p.proc.ch_exo and p.proc.ch_mid2).  Native mode draws
// Philox4x32-10 keyed by (seed, env) with counter (step, draw, 0, 0):
// draw 0 gives the four uniforms, draw 1 four Box-Muller uniforms
// u0..u3 -> r_j = sqrt(-2 log(1 - u_j)), theta_j = 2 pi u_{2+j};
// eps0 = r0 cos theta0, eps1 = r1 cos theta1, mid = r0 sin theta0.  The
// lam kind takes draw 2 as well, one more pair: r2 from its first word,
// theta2 from its second, eps2 = r2 cos theta2, eps3 = r2 sin theta2.
// The general kinds' extra normals: the exogenous bid's is draw 1's spare
// r1 sin theta1, and draw 3 gives one more pair (r3 from its first word,
// theta3 from its second): the exogenous ask's r3 cos theta3 and the second
// midprice column's r3 sin theta3.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense.cuh"
#include "inventory_power.cuh"
#include "mma.cuh"
#include "philox.cuh"
#include "proc_kinds.cuh"

constexpr int kMaxLayers = 64;  // MlpKernelParams' widths (ops/mlp_rollout.py MAX_LAYERS)
constexpr int kMaxObs = 16;
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
  int reward;        // 0 pnl, 1 cjmm, 2 running
  float dt_phi;      // dt * phi
  float alpha;
  float cjmm_coef;   // alpha * dt / episode_length
  float inv_exp;     // inventory exponent
  int dynamics;      // 0 limit, 1 lam, 2 touch
  int mask_mo;       // lam: block market orders at +/- max_inventory
  float half_spread; // lam and touch: the fixed market half-spread
  int proc_mode;     // mbt::ProcMode: the plain or the general instantiation
  mbt::ProcParams proc;
  float temporary_impact;  // speed: temp_perm
  float permanent_impact;
  float dt_alpha;          // dt * alpha (cjoe)
  float ep_len;            // terminal_time - start_time (cjoe, fixed start)
  float neg_gamma;         // -risk_aversion (exp_utility)
  int random_start;        // the t0 plane is read (the extras instantiations)
  float terminal_time;
  float alpha_dt;          // alpha * dt (cjmm under the t0 plane)
  float t_done;            // terminal_time - dt / 2
  float t_last;            // terminal_time - 1.5 dt
  float t_term;            // start_time + run_steps * dt: the terminal observation's time
};

struct RolloutOut {
  float* obs;
  float* act;
  float* logp;
  float* value;
  float* reward;
};

// The extras instantiations' input and output: NULL where unused.
struct Extras {
  const float* t0;  // (n,) start times under a random start
  float* fin;       // (S, n) terminal observation
};

#ifndef MBT_K3_WIDE
#define MBT_K3_WIDE 0
#endif

namespace {

// This library's instantiations: the bf16 wide route's alone, or every
// other (the narrow bf16 route and the float32 kernel).
constexpr bool kWideLib = MBT_K3_WIDE != 0;

enum Reward { kPnl = 0, kCjMm = 1, kRunning = 2, kCjOe = 3, kExpUtility = 4 };
enum Dynamics { kLimit = 0, kLam = 1, kTouch = 2, kSpeed = 3 };

// Noise-mode channels per step: 4 uniforms, max(A, 2) normals, the mid normal
// (speed reads eps0 of the two).
template <int kDyn>
constexpr int kNoiseChannels = kDyn == kLam ? 9 : 7;

struct Draws {
  float u_ab, u_aa, u_fb, u_fa, eps0, eps1, mid;
  float eps2, eps3;             // lam only
  float exo_b, exo_a, mid2;     // the general kinds only
};

template <int kDyn, int kProc>
__device__ __forceinline__ Draws draws_at(const MlpKernelParams& p, const float* noise, int n, uint32_t seed, int env,
                                          int step) {
  Draws d;
  if (noise) {
    const int kCh = kProc != mbt::kProcPlain ? p.proc.channels : kNoiseChannels<kDyn>;
    const size_t base = static_cast<size_t>(step) * kCh * n + env;
    d.u_ab = noise[base];
    d.u_aa = noise[base + static_cast<size_t>(n)];
    d.u_fb = noise[base + 2 * static_cast<size_t>(n)];
    d.u_fa = noise[base + 3 * static_cast<size_t>(n)];
    d.eps0 = noise[base + 4 * static_cast<size_t>(n)];
    d.eps1 = noise[base + 5 * static_cast<size_t>(n)];
    if constexpr (kDyn == kLam) {
      d.eps2 = noise[base + 6 * static_cast<size_t>(n)];
      d.eps3 = noise[base + 7 * static_cast<size_t>(n)];
    }
    if constexpr (kProc != mbt::kProcPlain) {
      d.mid = noise[base + (4 + (kDyn == kLam ? 4 : 2)) * static_cast<size_t>(n)];
      if (p.proc.ch_exo >= 0) {
        d.exo_b = noise[base + p.proc.ch_exo * static_cast<size_t>(n)];
        d.exo_a = noise[base + (p.proc.ch_exo + 1) * static_cast<size_t>(n)];
      }
      if (p.proc.ch_mid2 >= 0) d.mid2 = noise[base + p.proc.ch_mid2 * static_cast<size_t>(n)];
    } else {
      d.mid = noise[base + (kCh - 1) * static_cast<size_t>(n)];
    }
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
  if constexpr (kDyn == kLam) {
    const uint4 c = mbt::philox4x32_10(make_uint4(static_cast<uint32_t>(step), 2u, 0u, 0u), key);
    const float r2 = sqrtf(-2.0f * logf(1.0f - mbt::uniform24(c.x)));
    const float th2 = mbt::kTwoPi * mbt::uniform24(c.y);
    d.eps2 = r2 * cosf(th2);
    d.eps3 = r2 * sinf(th2);
  }
  if constexpr (kProc != mbt::kProcPlain) {
    if (p.proc.ch_exo >= 0 || p.proc.ch_mid2 >= 0) {
      const uint4 e = mbt::philox4x32_10(make_uint4(static_cast<uint32_t>(step), 3u, 0u, 0u), key);
      const float r3 = sqrtf(-2.0f * logf(1.0f - mbt::uniform24(e.x)));
      const float th3 = mbt::kTwoPi * mbt::uniform24(e.y);
      d.exo_b = r1 * sinf(th1);
      d.exo_a = r3 * cosf(th3);
      d.mid2 = r3 * sinf(th3);
    }
  }
  return d;
}

// One env's state and its policy constants, in the registers of its thread.
struct EnvState {
  float cash, inv, price;
  // CjMm: (alpha * dt / episode_length) * q(initial inventory); CjOe
  // (speed): q(initial inventory) * episode_length
  float reward_const;
  float lstd[kMaxAct], stdv[kMaxAct];
};

template <int kDyn>
__device__ __forceinline__ EnvState initial_state(const MlpKernelParams& p, const float* log_std,
                                                  const float* inv0, int env) {
  EnvState s;
  s.cash = p.initial_cash;
  s.inv = inv0 ? inv0[env] : p.initial_inventory;
  if constexpr (kDyn == kSpeed) {
    s.reward_const = mbt::q_pow(s.inv, p.inv_exp) * p.ep_len;
  } else {
    s.reward_const = p.cjmm_coef * mbt::q_pow(s.inv, p.inv_exp);
  }
  s.price = p.initial_price;
  for (int a = 0; a < p.a_dim; ++a) {
    s.lstd[a] = log_std[a];
    s.stdv[a] = expf(s.lstd[a]);
  }
  return s;
}

// Under a random start, the time at which step i of this env starts,
// t0 + i dt, its t0 read from device memory at each use: a register held
// across the episode for it spilled the lam kind's bf16 extras variant.
__device__ __forceinline__ float started(const MlpKernelParams& p, const Extras& ex, int env, int i) {
  float t0;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(t0) : "l"(ex.t0 + env));
  return t0 + static_cast<float>(i) * p.dt;
}

// The extras instantiations' per-env reward constant under a random start,
// of the episode length terminal - t0.
template <int kDyn, bool kExtra>
__device__ __forceinline__ void start_episode(const MlpKernelParams& p, const Extras& ex, EnvState& s, bool active,
                                              int env) {
  if constexpr (kExtra) {
    if (p.random_start && active) {
      const float ep_len = p.terminal_time - ex.t0[env];
      const float q0 = mbt::q_pow(s.inv, p.inv_exp);
      if constexpr (kDyn == kSpeed) {
        s.reward_const = q0 * ep_len;
      } else {
        s.reward_const = (p.alpha_dt / ep_len) * q0;
      }
    }
  }
}

// The time step i observes (pallas_rollout.py:1303-1320): clamped at the
// terminal time under a random start.
template <bool kExtra>
__device__ __forceinline__ float step_time(const MlpKernelParams& p, const Extras& ex, bool active, int env, int i) {
  if constexpr (kExtra) {
    if (p.random_start && active) return fminf(started(p, ex, env, i), p.terminal_time);
  }
  return p.start_time + static_cast<float>(i) * p.dt;
}

// Observation channel c at time t (pallas_rollout.py:724-754); the
// general kinds' process states follow the price, as does the speed
// kind's impact state.
template <int kDyn, int kProc>
__device__ __forceinline__ float observation(const MlpKernelParams& p, const EnvState& s, const mbt::ProcState& ps,
                                             float t, int c) {
  float x;
  if constexpr (kProc != mbt::kProcPlain) {
    x = c == 0 ? s.cash : c == 1 ? s.inv : c == 2 ? t : c == 3 ? s.price : mbt::proc_plane<kProc>(p.proc, ps, c - 4);
  } else if constexpr (kDyn == kSpeed) {
    const float planes[5] = {s.cash, s.inv, t, s.price, ps.imp};
    x = planes[c];
  } else {
    const float planes[4] = {s.cash, s.inv, t, s.price};
    x = planes[c];
  }
  if (p.normalise_obs) x = (x - p.obs_low[c]) / p.obs_grad[c] - 1.0f;
  return x;
}

// Step i of one env from its head output `mean`: the sample, its log-prob,
// the executed action and the env step of the dynamics kind; writes the
// action, log-prob and reward of the step and advances the state.  Under a
// random start a post-done step takes no env step: the state stays, the
// reward is 0, what JAX's step-then-freeze leaves.
template <int kDyn, int kProc, bool kExtra>
__device__ __forceinline__ void env_step(const MlpKernelParams& p, const Draws& d, const float* mean, EnvState& s,
                                         mbt::ProcState& ps, const RolloutOut& out, int n, int env, int i,
                                         const Extras& ex) {
  float eps[kDyn == kLam ? 4 : 2];
  eps[0] = d.eps0;
  eps[1] = d.eps1;
  if constexpr (kDyn == kLam) {
    eps[2] = d.eps2;
    eps[3] = d.eps3;
  }
  float action[kMaxAct], exec[kMaxAct];
  float lp = 0.0f;
  for (int a = 0; a < p.a_dim; ++a) {
    action[a] = mean[a] + s.stdv[a] * eps[a];
    lp = lp + ((-0.5f * eps[a]) * eps[a] - s.lstd[a]);
    if (p.normalise_act) {
      const float c = fminf(fmaxf(action[a], -1.0f), 1.0f);
      exec[a] = (c + 1.0f) * p.act_grad[a] + p.act_low[a];
    } else {
      exec[a] = fminf(fmaxf(action[a], p.act_low[a]), p.act_high[a]);
    }
  }
  lp = lp - p.logp_const;
  // the step's action, log-prob and reward
  auto store = [&](float reward) {
    const size_t o1 = static_cast<size_t>(i) * n + env;
    for (int a = 0; a < p.a_dim; ++a) {
      out.act[(static_cast<size_t>(i) * p.a_dim + a) * n + env] = action[a];
    }
    out.logp[o1] = lp;
    out.reward[o1] = reward;
  };
  if constexpr (kExtra) {
    if (p.random_start && started(p, ex, env, i) >= p.t_done) {
      store(0.0f);
      return;
    }
  }

  float new_inv, new_cash, new_price;
  if constexpr (kDyn == kSpeed) {  // the impact at the pre-update state, then its state's step
    const float speed = exec[0];
    float impact;
    if constexpr (kProc != mbt::kProcPlain) {
      impact = mbt::speed_impact(p.proc, p.temporary_impact, p.permanent_impact, ps, speed);
    } else {  // temporary and permanent impact
      impact = p.temporary_impact * speed + ps.imp;
      ps.imp = ps.imp + p.permanent_impact * speed * p.dt;
    }
    const float volume = speed * p.dt;
    new_inv = fminf(fmaxf(s.inv + volume, -p.max_inventory), p.max_inventory);
    new_cash = fminf(fmaxf(s.cash - volume * (s.price + impact), -p.max_cash), p.max_cash);
    if constexpr (kProc != mbt::kProcPlain) {  // no fills for a jump kind to react to
      new_price = mbt::midprice_step<kProc>(p.proc, p.drift_dt, p.vol_sqrt_dt, ps, s.price, d.mid, d.mid2, 0.0f, 0.0f);
    } else {
      new_price = s.price + p.drift_dt + p.vol_sqrt_dt * d.mid;
    }
  } else if constexpr (kProc != mbt::kProcPlain) {  // the process kinds of p.proc
    constexpr int kMarket = kDyn == kLam ? mbt::kMarketLam : kDyn == kTouch ? mbt::kMarketTouch : mbt::kMarketLimit;
    const float u[4] = {d.u_ab, d.u_aa, d.u_fb, d.u_fa};
    const mbt::MarketOut m =
        mbt::market_step<kMarket, kProc>(p, ps, u, d.exo_b, d.exo_a, exec, s.cash, s.inv, s.price);
    new_inv = fminf(fmaxf(m.inv, -p.max_inventory), p.max_inventory);
    new_cash = fminf(fmaxf(m.cash, -p.max_cash), p.max_cash);
    new_price = mbt::midprice_step<kProc>(p.proc, p.drift_dt, p.vol_sqrt_dt, ps, s.price, d.mid, d.mid2, m.hit_bid,
                                          m.hit_ask);
  } else {
    const float arr_bid = d.u_ab < p.p_arr_bid ? 1.0f : 0.0f;
    const float arr_ask = d.u_aa < p.p_arr_ask ? 1.0f : 0.0f;
    if constexpr (kDyn == kTouch) {  // the fills are the clipped post columns
      const float hit_bid = arr_bid * (exec[0] * (s.inv < p.max_inventory ? 1.0f : 0.0f));
      const float hit_ask = arr_ask * (exec[1] * (s.inv > -p.max_inventory ? 1.0f : 0.0f));
      new_inv = s.inv + hit_bid - hit_ask;
      new_cash = s.cash - hit_bid * (s.price - p.half_spread) + hit_ask * (s.price + p.half_spread);
    } else {
      const float bid = exec[0], ask = exec[1];
      float fill_bid = d.u_fb < expf(p.neg_k * bid) ? 1.0f : 0.0f;
      float fill_ask = d.u_fa < expf(p.neg_k * ask) ? 1.0f : 0.0f;
      fill_bid = fill_bid * (s.inv < p.max_inventory ? 1.0f : 0.0f);
      fill_ask = fill_ask * (s.inv > -p.max_inventory ? 1.0f : 0.0f);
      const float hit_bid = arr_bid * fill_bid;
      const float hit_ask = arr_ask * fill_ask;
      if constexpr (kDyn == kLam) {  // unit market orders before the limit bookkeeping
        float mo_buy = exec[2] > 0.5f ? 1.0f : 0.0f;
        float mo_sell = exec[3] > 0.5f ? 1.0f : 0.0f;
        if (p.mask_mo) {
          mo_buy = mo_buy * (s.inv < p.max_inventory ? 1.0f : 0.0f);
          mo_sell = mo_sell * (s.inv > -p.max_inventory ? 1.0f : 0.0f);
        }
        new_inv = s.inv + (mo_buy - mo_sell) + hit_bid - hit_ask;
        new_cash = s.cash + mo_sell * (s.price - p.half_spread) - mo_buy * (s.price + p.half_spread) -
                   hit_bid * (s.price - bid) + hit_ask * (s.price + ask);
      } else {
        new_inv = s.inv + hit_bid - hit_ask;
        new_cash = s.cash - hit_bid * (s.price - bid) + hit_ask * (s.price + ask);
      }
    }
    new_inv = fminf(fmaxf(new_inv, -p.max_inventory), p.max_inventory);
    new_cash = fminf(fmaxf(new_cash, -p.max_cash), p.max_cash);
    new_price = s.price + p.drift_dt + p.vol_sqrt_dt * d.mid;
  }
  float reward = (new_cash + new_inv * new_price) - (s.cash + s.inv * s.price);
  if (p.reward != kPnl) {
    bool last = i == p.run_steps - 1;
    if constexpr (kExtra) {
      if (p.random_start) last = started(p, ex, env, i) >= p.t_last;
    }
    if (p.reward == kExpUtility) {  // terminal * -exp(-gamma * value), as JAX multiplies
      const float terminal = last ? 1.0f : 0.0f;
      reward = terminal * -expf(p.neg_gamma * (new_cash + new_inv * new_price));
    } else {
      const float q_new = mbt::q_pow(new_inv, p.inv_exp);
      if constexpr (kDyn == kSpeed) {  // CjOe: e * speed * q(inv, e - 1) + q(inv0) * episode length
        reward = reward - p.dt_phi * q_new -
                 p.dt_alpha * (p.inv_exp * exec[0] * mbt::q_pow(s.inv, p.inv_exp - 1.0f) + s.reward_const);
      } else if (p.reward == kCjMm) {
        reward = reward - p.dt_phi * q_new - p.alpha * (q_new - mbt::q_pow(s.inv, p.inv_exp)) - s.reward_const;
      } else {  // the running penalty's terminal term at the last step only
        const float terminal = last ? 1.0f : 0.0f;
        reward = reward - p.dt_phi * q_new - (p.alpha * terminal) * q_new;
      }
    }
  }
  store(reward);
  s.cash = new_cash;
  s.inv = new_inv;
  s.price = new_price;
}

// One tower's weights: the layers' weights and biases, concatenated, then
// the head rows it feeds (C entry point below).
template <typename TW>
struct TowerWeights {
  const TW* w;
  const float* bias;
  const TW* w_head;     // float: (head_rows, h_last); bf16: one packed 16-row block
  const float* b_head;  // (head_rows,)
  int head_rows;
};

// Sizes and shared-memory offsets (bytes) of a launch, from the host.
struct Layout {
  int w0_size;   // bf16: layer 0's packed weights, in values
  int w_size;    // bf16: every layer's packed weights, in values
  int staged;    // bf16: the inner layers are staged in shared memory
  int scratch;   // float32: the activation tiles live in device memory
  int b_total;   // every layer's bias
  int act_rows;  // bf16: rows of the activation tile (the wide route: of each scratch tile)
  int h_max;     // float32: widest activation
  size_t off_bias, off_head, off_x, off_act, off_head_o, bytes;
};

// ============================================================ float32 path
namespace cc {

constexpr int kThreads = 256;
constexpr int kE = 32;   // envs per CTA
constexpr int kET = 8;   // envs per thread in a layer
constexpr int kRowGroups = kThreads / (kE / kET);  // 64 groups of 4 rows

// Buffers of one CTA: in shared memory, or (the scratch route) the
// activations in device memory and the head and biases where they are.
struct Smem {
  float* act0;
  float* act1;
  const float* head_w;
  float* head_o;
  const float* bias_s;
};

// Points `sm` at a tower's head and biases: staged into shared memory at
// `head_s` and `bias_s`, or on the scratch route read where they are.
__device__ void stage(const TowerWeights<float>& tw, Smem& sm, float* head_s, float* bias_s, int b_total, int h_last,
                      bool scratch) {
  if (scratch) {
    sm.head_w = tw.w_head;
    sm.bias_s = tw.bias;
    return;
  }
  for (int i = threadIdx.x; i < tw.head_rows * h_last; i += kThreads) head_s[i] = tw.w_head[i];
  for (int i = threadIdx.x; i < b_total; i += kThreads) bias_s[i] = tw.bias[i];
  sm.head_w = head_s;
  sm.bias_s = bias_s;
}

// The trunk h = tanh(W h + b), layer by layer, from act0 (the tile's
// observation) through the ping-pong buffers, then the head's rows into
// head_o.  Each layer's (in, out) matrix is read through L1/L2.  Ends
// after a barrier.
__device__ void forward(const MlpKernelParams& p, const float* w, const Smem& sm, int head_rows,
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
    for (int r0 = rg * 4; r0 < out_dim; r0 += 4 * kRowGroups) {  // 256 rows a sweep
      float acc[4][kET];
      mbt::dense_tile<kET>(w + w_off + r0, out_dim, in + eg * kET, kE, k_dim, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float b = sm.bias_s[b_off + r0 + r];
#pragma unroll
        for (int e = 0; e < kET; ++e) o[(r0 + r) * kE + eg * kET + e] = tanhf(acc[r][e] + b);
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

// `vf.w` is NULL for the shared trunk, whose merged head (A+1 rows, the
// value last) is `pi`'s; with towers `pi` holds the pi tower and its A head
// rows and `vf` the vf tower and its value row.
template <int kDyn, int kProc, bool kExtra>
__device__ void rollout(const MlpKernelParams& p, int n, uint32_t seed, const float* __restrict__ noise,
                        const float* __restrict__ inv0, const TowerWeights<float>& pi, const TowerWeights<float>& vf,
                        const Layout& lay, const float* __restrict__ log_std, const RolloutOut& out,
                        const Extras& ex, float* scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int h_last = p.widths[p.n_layers - 1];
  const int n_head = p.a_dim + 1;

  Smem sm;
  float* head_s = nullptr;
  float* bias_s = nullptr;
  if (lay.scratch) {
    sm.act0 = scratch + static_cast<size_t>(blockIdx.x) * 2 * lay.h_max * kE;
    sm.act1 = sm.act0 + lay.h_max * kE;
    sm.head_o = reinterpret_cast<float*>(smem_raw);
  } else {
    sm.act0 = reinterpret_cast<float*>(smem_raw);
    sm.act1 = sm.act0 + lay.h_max * kE;
    head_s = sm.act1 + lay.h_max * kE;
    sm.head_o = head_s + n_head * h_last;
    bias_s = sm.head_o + n_head * kE;
  }

  stage(pi, sm, head_s, bias_s, lay.b_total, h_last, lay.scratch);
  const int env = blockIdx.x * kE + tid;
  EnvState s = initial_state<kDyn>(p, log_std, tid < kE ? inv0 : nullptr, env);
  start_episode<kDyn, kExtra>(p, ex, s, tid < kE, env);
  mbt::ProcState ps = mbt::proc_initial(p.proc);
  __syncthreads();

  // ---- phase 1: the episode with the pi tower (or the shared trunk)
  for (int i = 0; i < p.run_steps; ++i) {
    if (tid < kE) {
      const float t = step_time<kExtra>(p, ex, true, env, i);
      for (int c = 0; c < p.s_dim; ++c) {
        const float x = observation<kDyn, kProc>(p, s, ps, t, c);
        out.obs[(static_cast<size_t>(i) * p.s_dim + c) * n + env] = x;
        sm.act0[c * kE + tid] = x;
      }
    }
    __syncthreads();
    // ---- trunk and head: mean rows, then (shared trunk) the value row
    forward(p, pi.w, sm, pi.head_rows, pi.b_head);

    // ---- sample, log-prob, action, env step (one lane per env)
    if (tid < kE) {
      float mean[kMaxAct];
      for (int a = 0; a < p.a_dim; ++a) mean[a] = sm.head_o[a * kE + tid];
      if (!vf.w) out.value[static_cast<size_t>(i) * n + env] = sm.head_o[p.a_dim * kE + tid];
      env_step<kDyn, kProc, kExtra>(p, draws_at<kDyn, kProc>(p, noise, n, seed, env, i), mean, s, ps, out, n, env,
                                    i, ex);
    }
    // the next step's observation writes act0 only after this step's head
    // has read the trunk output (the barrier that ends forward), and its
    // head runs after the barrier that follows those writes
  }
  if constexpr (kExtra) {  // the terminal observation
    if (ex.fin && tid < kE) {
      for (int c = 0; c < p.s_dim; ++c) ex.fin[static_cast<size_t>(c) * n + env] = observation<kDyn, kProc>(
          p, s, ps, p.t_term, c);
    }
  }
  if (!vf.w) return;

  // ---- phase 2: the vf tower's value of each observation of phase 1
  __syncthreads();
  stage(vf, sm, head_s, bias_s, lay.b_total, h_last, lay.scratch);
  __syncthreads();
  for (int i = 0; i < p.run_steps; ++i) {
    if (tid < kE) {  // this thread wrote these observations in phase 1
      for (int c = 0; c < p.s_dim; ++c) {
        sm.act0[c * kE + tid] = out.obs[(static_cast<size_t>(i) * p.s_dim + c) * n + env];
      }
    }
    __syncthreads();
    forward(p, vf.w, sm, vf.head_rows, vf.b_head);
    if (tid < kE) out.value[static_cast<size_t>(i) * n + env] = sm.head_o[tid];
  }
}

// The launch's layout; on the scratch route shared memory holds the head's
// output alone (ops/mlp_rollout.py k3_scratch_bytes computes the same).
Layout layout(const MlpKernelParams& p, bool scratch) {
  Layout lay{};
  int k_dim = p.s_dim;
  lay.h_max = p.s_dim;
  for (int l = 0; l < p.n_layers; ++l) {
    lay.h_max = p.widths[l] > lay.h_max ? p.widths[l] : lay.h_max;
    lay.b_total += p.widths[l];
    k_dim = p.widths[l];
  }
  const int n_head = p.a_dim + 1;
  lay.scratch = scratch;
  lay.bytes = scratch ? sizeof(float) * n_head * kE
                      : sizeof(float) * (2 * static_cast<size_t>(lay.h_max) * kE + n_head * k_dim + n_head * kE +
                                         lay.b_total);
  return lay;
}

}  // namespace cc

// ============================================================ bf16 path
namespace tc {

using mbt::frag_from;
using mbt::mma_bf16;
using mbt::mma_k_block;
using mbt::zero_acc;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 128;        // envs per CTA
constexpr int kLd = kE + 8;    // activation row stride (bf16)
constexpr int kK0 = 16;        // layer 0's k: S rows of the observation, then zeros
// head rows the env step reads (A + 1): 3, 5 in the lam instantiation and 2
// in the speed one
template <int kDyn>
constexpr int kHead = kDyn == kLam ? 5 : kDyn == kSpeed ? 2 : 3;
constexpr int kRows = 32;      // warp tile: two 16-row blocks
constexpr int kEnvs = 64;      //            x eight 8-env tiles
constexpr int kNT = kEnvs / 8;
static_assert(kWarps * kEnvs == 8 * kE, "warp w: rows [32 (w / 2), +32) x envs [64 (w % 2), +64)");
static_assert(kWarps * 8 == kE, "the head product gives each warp 8 envs");
constexpr int kPassRows = kWarps / 2 * kRows;  // output rows one pass of the 16 warps covers
constexpr int kChunk = 256;    // the wide route: input rows streamed through shared memory at a time

struct Smem {
  __nv_bfloat16* w;       // layer 0's packed weights, then (staged) the inner layers'
  float* bias;            // every layer's bias
  __nv_bfloat16* head_w;  // the head as a packed (16, h_last) matrix
  __nv_bfloat16* x;       // [kK0][kLd] observation tile (layer 0's input)
  __nv_bfloat16* act;     // [act_rows][kLd] activation tile
  float* head_o;          // [kHead<kDyn>][kE] the head's output
};

__device__ __forceinline__ uint4 lds128(const __nv_bfloat16* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(mbt::smem_u32(p)));
  return v;
}

// Stages a tower into shared memory: layer 0's packed weights (and, when
// the layout stages them, the inner layers'), the biases and the head.
__device__ void stage(const TowerWeights<__nv_bfloat16>& tw, const Smem& sm, const Layout& lay, int h_last) {
  const int n16 = (lay.staged ? lay.w_size : lay.w0_size) / 8;
  for (int i = threadIdx.x; i < n16; i += kThreads) {
    reinterpret_cast<uint4*>(sm.w)[i] = __ldg(reinterpret_cast<const uint4*>(tw.w) + i);
  }
  for (int i = threadIdx.x; i < lay.b_total; i += kThreads) sm.bias[i] = tw.bias[i];
  for (int i = threadIdx.x; i < 2 * h_last; i += kThreads) {  // 16 h_last bf16
    reinterpret_cast<uint4*>(sm.head_w)[i] = __ldg(reinterpret_cast<const uint4*>(tw.w_head) + i);
  }
}

// This warp's tile of one layer's product over its k blocks [kb0, kb0 +
// nkb): acc[mt][nt] += rows [32 rg + 16 mt, +16) of the (r_dim, k_dim)
// matrix `w` (fragment order; in shared memory or, when `in_smem` is
// false, device memory) times envs [e0 + 8 nt, +8) of the feature-major
// tile `src`, whose first row is k block kb0's.  A row block at or past
// r_dim (r_dim % 32 == 16) multiplies zeros.
template <int NT>
__device__ __forceinline__ void product_blocks(const __nv_bfloat16* w, bool in_smem, int k_dim, int r_dim,
                                               const __nv_bfloat16* src, int rg, int e0, int kb0, int nkb,
                                               float (&acc)[2][NT][4]) {
  const bool two = rg * kRows + 16 < r_dim;
  const size_t rb_stride = static_cast<size_t>(k_dim) * 16;
  const __nv_bfloat16* a_frag = w + 2 * rg * rb_stride + (threadIdx.x % 32) * 8;
  const __nv_bfloat16* b_row = mbt::act_b_row<kLd>(src + e0);
  uint32_t a[2][4] = {};
  for (int kb = 0; kb < nkb; ++kb) {
    const __nv_bfloat16* pa = a_frag + (kb0 + kb) * mbt::kBlock;
    if (in_smem) {
      frag_from(a[0], lds128(pa));
      if (two) frag_from(a[1], lds128(pa + rb_stride));
    } else {
      frag_from(a[0], __ldg(reinterpret_cast<const uint4*>(pa)));
      if (two) frag_from(a[1], __ldg(reinterpret_cast<const uint4*>(pa + rb_stride)));
    }
    mma_k_block(a, b_row + kb * 16 * kLd, acc);
  }
}

// The whole product: acc = product_blocks over every k block.
__device__ __forceinline__ void product(const __nv_bfloat16* w, bool in_smem, int k_dim, int r_dim,
                                        const __nv_bfloat16* src, int rg, int eh, float (&acc)[2][kNT][4]) {
  zero_acc(acc);
  product_blocks(w, in_smem, k_dim, r_dim, src, rg, eh * kEnvs, 0, k_dim / 16, acc);
}

// Epilogue of a layer: act[row][env] = bf16(tanh(acc + b[row])) for envs
// [e0, e0 + 8 NT), rows of stride kLdOut (kLd in shared memory, kE in a
// wide-route scratch tile).
template <int NT = kNT, int kLdOut = kLd>
__device__ __forceinline__ void store_layer(const float (&acc)[2][NT][4], const float* bias, int r_dim, int rg,
                                            int e0, __nv_bfloat16* act) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = rg * kRows + mt * 16 + half * 8 + g;
      if (row < r_dim) {
        const float b = bias[row];
        __nv_bfloat16* d = act + row * kLdOut + e0 + t4 * 2;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          *reinterpret_cast<__nv_bfloat162*>(d + nt * 8) = __floats2bfloat162_rn(
              tanhf(acc[mt][nt][half * 2] + b), tanhf(acc[mt][nt][half * 2 + 1] + b));
        }
      }
    }
  }
}

// The head over the last layer's output in the activation tile (k_dim
// rows): warp w computes the (16, k_dim) packed head `w` times envs
// [8 w, +8) as one mma row block, the k blocks summed round-robin in four
// accumulators (shorter dependency chains) added in a fixed order, and
// writes rows 0..kRowsOut-1 to head_o.
// The head's k blocks [kb0, kb0 + nkb) (kb0 a multiple of 4) over the
// tile `act` whose first row is block kb0's: block kb adds to d[kb % 4].
__device__ __forceinline__ void head_blocks(const __nv_bfloat16* w, bool in_smem, const __nv_bfloat16* act, int kb0,
                                            int nkb, float (&d)[4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* a_frag = w + lane * 8;
  const __nv_bfloat16* b_row = act + (lane % 16) * kLd + warp * 8;
  for (int kb = 0; kb < nkb; kb += 4) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (kb + c < nkb) {
        uint32_t a[4], f[2];
        const __nv_bfloat16* pa = a_frag + (kb0 + kb + c) * mbt::kBlock;
        frag_from(a, in_smem ? lds128(pa) : __ldg(reinterpret_cast<const uint4*>(pa)));
        mbt::ldmatrix_x2_trans(f, b_row + (kb + c) * 16 * kLd);
        mma_bf16(d[c], a, f[0], f[1]);
      }
    }
  }
}

// Rows 0..kRowsOut-1 of the head's four accumulators, added in a fixed
// order, to head_o.
template <int kRowsOut>
__device__ __forceinline__ void head_store(const float (&d)[4][4], float* head_o) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  if (g < kRowsOut) {  // row g: envs 2 t4, 2 t4 + 1
    *reinterpret_cast<float2*>(head_o + g * kE + warp * 8 + t4 * 2) =
        make_float2((d[0][0] + d[1][0]) + (d[2][0] + d[3][0]), (d[0][1] + d[1][1]) + (d[2][1] + d[3][1]));
  }
}

template <int kRowsOut>
__device__ __forceinline__ void head_product(const __nv_bfloat16* w, int k_dim, const __nv_bfloat16* act,
                                             float* head_o) {
  float d[4][4] = {};
  head_blocks(w, true, act, 0, k_dim / 16, d);
  head_store<kRowsOut>(d, head_o);
}

// The trunk and the head of one step, from the observation tile.  Ends
// with head_o written, before a barrier.
template <int kDyn>
__device__ void forward(const MlpKernelParams& p, const Smem& sm, const Layout& lay, const __nv_bfloat16* w_dev) {
  const int warp = threadIdx.x / 32, rg = warp / 2, eh = warp % 2;
  float acc[2][kNT][4];
  int r_dim = p.widths[0];
  bool has_rows = rg * kRows < r_dim;
  if (has_rows) product(sm.w, true, kK0, r_dim, sm.x, rg, eh, acc);
  size_t w_off = lay.w0_size;
  int b_off = 0;
  for (int l = 1; l < p.n_layers; ++l) {
    if (has_rows) store_layer(acc, sm.bias + b_off, r_dim, rg, eh * kEnvs, sm.act);
    __syncthreads();
    const int k_dim = r_dim;
    b_off += k_dim;
    r_dim = p.widths[l];
    has_rows = rg * kRows < r_dim;
    if (has_rows) {
      const __nv_bfloat16* w = lay.staged ? sm.w + w_off : w_dev + w_off;
      product(w, lay.staged, k_dim, r_dim, sm.act, rg, eh, acc);
    }
    w_off += static_cast<size_t>(k_dim) * r_dim;
    __syncthreads();  // every read of act before the epilogue overwrites it
  }
  if (has_rows) store_layer(acc, sm.bias + b_off, r_dim, rg, eh * kEnvs, sm.act);
  __syncthreads();
  head_product<kHead<kDyn>>(sm.head_w, r_dim, sm.act, sm.head_o);
}

// `rows` rows of a wide-route scratch tile ([rows][kE] in device memory)
// into the shared-memory tile `dst` (row stride kLd), 16 bytes a copy.
__device__ __forceinline__ void copy_rows(const __nv_bfloat16* src, int rows, __nv_bfloat16* dst) {
  constexpr int kPerRow = kE / 8;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = i % kPerRow;
    *reinterpret_cast<uint4*>(dst + r * kLd + c * 8) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * kE + c * 8);
  }
}

// The wide route's trunk and head of one step (see the header): layer by
// layer into this CTA's scratch tiles `act0` / `act1`, kPassRows output
// rows a pass and each warp's 64 envs in two halves of 32 (32 accumulators
// a thread: with the route's loop state beside 64, ten of the twelve wide
// instantiations spilled), the input streamed through sm.act kChunk rows
// at a time for each half; then the head the same way.  Ends with head_o
// written, before a barrier.
template <int kDyn>
__device__ __forceinline__ void forward_wide(const MlpKernelParams& p, const Smem& sm,
                                          const TowerWeights<__nv_bfloat16>& tw, __nv_bfloat16* act0,
                                          __nv_bfloat16* act1) {
  const int warp = threadIdx.x / 32, rg = warp / 2, eh = warp % 2;
  const __nv_bfloat16* in = nullptr;  // layer 0 reads the observation tile
  __nv_bfloat16* out = act0;
  size_t w_off = 0;
  int b_off = 0, k_dim = kK0;
  for (int l = 0; l < p.n_layers; ++l) {
    const int r_dim = p.widths[l];
    for (int r0 = 0; r0 < r_dim; r0 += kPassRows) {
      const int g = r0 / kRows + rg;  // this warp's row group
      const bool has_rows = g * kRows < r_dim;
#pragma unroll 1
      for (int e0 = eh * kEnvs; e0 < (eh + 1) * kEnvs; e0 += kEnvs / 2) {
        float acc[2][kNT / 2][4];
        zero_acc(acc);
        if (l == 0) {
          if (has_rows) product_blocks(tw.w, false, kK0, r_dim, sm.x, g, e0, 0, kK0 / 16, acc);
        } else {
          for (int k0 = 0; k0 < k_dim; k0 += kChunk) {
            const int kc = k_dim - k0 < kChunk ? k_dim - k0 : kChunk;
            __syncthreads();  // the chunk tile's last reads are done
            copy_rows(in + static_cast<size_t>(k0) * kE, kc, sm.act);
            __syncthreads();
            if (has_rows) product_blocks(tw.w + w_off, false, k_dim, r_dim, sm.act, g, e0, k0 / 16, kc / 16, acc);
          }
        }
        if (has_rows) store_layer<kNT / 2, kE>(acc, tw.bias + b_off, r_dim, g, e0, out);
      }
    }
    __syncthreads();  // the layer's output is whole before it is read
    w_off += static_cast<size_t>(k_dim) * r_dim;
    b_off += r_dim;
    k_dim = r_dim;
    in = out;
    out = out == act0 ? act1 : act0;
  }
  float d[4][4] = {};
  for (int k0 = 0; k0 < k_dim; k0 += kChunk) {
    const int kc = k_dim - k0 < kChunk ? k_dim - k0 : kChunk;
    __syncthreads();
    copy_rows(in + static_cast<size_t>(k0) * kE, kc, sm.act);
    __syncthreads();
    head_blocks(tw.w_head, false, sm.act, k0 / 16, kc / 16, d);
  }
  head_store<kHead<kDyn>>(d, sm.head_o);
}

template <int kDyn, int kProc, bool kExtra, bool kWide>
__device__ void rollout(const MlpKernelParams& p, int n, uint32_t seed, const float* __restrict__ noise,
                        const float* __restrict__ inv0, const TowerWeights<__nv_bfloat16>& pi,
                        const TowerWeights<__nv_bfloat16>& vf, const Layout& lay,
                        const float* __restrict__ log_std, const RolloutOut& out, const Extras& ex,
                        __nv_bfloat16* scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int h_last = p.widths[p.n_layers - 1];
  Smem sm;
  sm.w = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  sm.bias = reinterpret_cast<float*>(smem_raw + lay.off_bias);
  sm.head_w = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.off_head);
  sm.x = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.off_x);
  sm.act = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.off_act);
  sm.head_o = reinterpret_cast<float*>(smem_raw + lay.off_head_o);
  __nv_bfloat16* act0 = nullptr;  // the wide route's scratch tiles
  __nv_bfloat16* act1 = nullptr;
  if constexpr (kWide) {
    act0 = scratch + static_cast<size_t>(blockIdx.x) * 2 * lay.act_rows * kE;
    act1 = act0 + static_cast<size_t>(lay.act_rows) * kE;
  }
  auto step = [&](const TowerWeights<__nv_bfloat16>& tw) {
    if constexpr (kWide) {
      forward_wide<kDyn>(p, sm, tw, act0, act1);
    } else {
      forward<kDyn>(p, sm, lay, tw.w);
    }
  };

  // the observation tile's rows past S stay zero: layer 0's padded k
  for (int i = tid; i < kK0 * kLd / 2; i += kThreads) {
    reinterpret_cast<__nv_bfloat162*>(sm.x)[i] = __floats2bfloat162_rn(0.0f, 0.0f);
  }
  __syncthreads();
  if constexpr (!kWide) stage(pi, sm, lay, h_last);
  const bool env_thread = tid < kE;
  const int env = blockIdx.x * kE + tid;
  const bool active = env_thread && env < n;  // the last tile may be ragged
  EnvState s = initial_state<kDyn>(p, log_std, active ? inv0 : nullptr, env);
  start_episode<kDyn, kExtra>(p, ex, s, active, env);
  mbt::ProcState ps = mbt::proc_initial(p.proc);
  // this thread's column of the observation tile before step i; envs past
  // n take zeros and store nothing
  auto load_obs = [&](int i, bool from_out) {
    const float t = step_time<kExtra>(p, ex, active, env, i);
    for (int c = 0; c < p.s_dim; ++c) {
      float x = 0.0f;
      if (active) {
        const size_t o = (static_cast<size_t>(i) * p.s_dim + c) * n + env;
        if (from_out) {
          x = out.obs[o];  // this thread wrote it in phase 1
        } else {
          x = observation<kDyn, kProc>(p, s, ps, t, c);
          out.obs[o] = x;
        }
      }
      sm.x[c * kLd + tid] = __float2bfloat16_rn(x);
    }
  };
  if (env_thread) load_obs(0, false);
  __syncthreads();

  // ---- phase 1: the episode with the pi tower (or the shared trunk)
  for (int i = 0; i < p.run_steps; ++i) {
    step(pi);
    __syncthreads();
    if (active) {
      float mean[kMaxAct];
      for (int a = 0; a < p.a_dim; ++a) mean[a] = sm.head_o[a * kE + tid] + pi.b_head[a];
      if (!vf.w) out.value[static_cast<size_t>(i) * n + env] = sm.head_o[p.a_dim * kE + tid] + pi.b_head[p.a_dim];
      env_step<kDyn, kProc, kExtra>(p, draws_at<kDyn, kProc>(p, noise, n, seed, env, i), mean, s, ps, out, n, env,
                                    i, ex);
    }
    if (env_thread && i + 1 < p.run_steps) load_obs(i + 1, false);
    __syncthreads();  // the observation tile and the head are read before they are rewritten
  }
  if constexpr (kExtra) {  // the terminal observation
    if (ex.fin && active) {
      for (int c = 0; c < p.s_dim; ++c) ex.fin[static_cast<size_t>(c) * n + env] = observation<kDyn, kProc>(
          p, s, ps, p.t_term, c);
    }
  }
  if (!vf.w) return;

  // ---- phase 2: the vf tower's value of each observation of phase 1
  if constexpr (!kWide) stage(vf, sm, lay, h_last);
  if (env_thread) load_obs(0, true);
  __syncthreads();
  for (int i = 0; i < p.run_steps; ++i) {
    step(vf);
    __syncthreads();
    if (active) out.value[static_cast<size_t>(i) * n + env] = sm.head_o[tid] + vf.b_head[0];
    if (env_thread && i + 1 < p.run_steps) load_obs(i + 1, true);
    __syncthreads();
  }
}

size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// The launch's layout, the inner layers staged when `staged`, with
// `head_rows` rows of head output.
Layout layout(const MlpKernelParams& p, bool staged, int head_rows) {
  Layout lay{};
  lay.w0_size = p.widths[0] * kK0;
  lay.w_size = lay.w0_size;
  for (int l = 0; l < p.n_layers; ++l) {
    lay.b_total += p.widths[l];
    if (l > 0) lay.w_size += p.widths[l] * p.widths[l - 1];
    if (p.widths[l] > lay.act_rows) lay.act_rows = p.widths[l];
  }
  const int h_last = p.widths[p.n_layers - 1];
  lay.staged = staged;
  lay.off_bias = align16(sizeof(__nv_bfloat16) * (staged ? lay.w_size : lay.w0_size));
  lay.off_head = lay.off_bias + align16(sizeof(float) * lay.b_total);
  lay.off_x = lay.off_head + sizeof(__nv_bfloat16) * 16 * h_last;
  lay.off_act = lay.off_x + sizeof(__nv_bfloat16) * kK0 * kLd;
  lay.off_head_o = lay.off_act + sizeof(__nv_bfloat16) * lay.act_rows * kLd;
  lay.bytes = lay.off_head_o + sizeof(float) * head_rows * kE;
  return lay;
}

// The wide route's layout: shared memory holds the observation tile, one
// kChunk-row activation tile and the head's output; `act_rows` is each
// scratch tile's rows, the widest layer (ops/mlp_rollout.py
// k3_scratch_bytes sizes the scratch from it).
Layout layout_wide(const MlpKernelParams& p, int head_rows) {
  Layout lay{};
  for (int l = 0; l < p.n_layers; ++l) {
    if (p.widths[l] > lay.act_rows) lay.act_rows = p.widths[l];
  }
  lay.off_x = 0;
  lay.off_act = sizeof(__nv_bfloat16) * kK0 * kLd;
  lay.off_head_o = lay.off_act + sizeof(__nv_bfloat16) * kChunk * kLd;
  lay.bytes = lay.off_head_o + sizeof(float) * head_rows * kE;
  return lay;
}

}  // namespace tc

template <bool kBf16>
using Weight = typename std::conditional<kBf16, __nv_bfloat16, float>::type;

template <bool kBf16, int kDyn, int kProc, bool kExtra>
__global__ void __launch_bounds__(kBf16 ? tc::kThreads : cc::kThreads, 1)
mlp_rollout_kernel(const MlpKernelParams p, int n, uint32_t seed, const float* __restrict__ noise,
                   const float* __restrict__ inv0, const TowerWeights<Weight<kBf16>> pi,
                   const TowerWeights<Weight<kBf16>> vf, const Layout lay, const float* __restrict__ log_std,
                   RolloutOut out, Extras ex, Weight<kBf16>* scratch) {
  if constexpr (kBf16) {
    tc::rollout<kDyn, kProc, kExtra, false>(p, n, seed, noise, inv0, pi, vf, lay, log_std, out, ex, scratch);
  } else {
    cc::rollout<kDyn, kProc, kExtra>(p, n, seed, noise, inv0, pi, vf, lay, log_std, out, ex, scratch);
  }
}

// The bf16 instantiations' wide route (trunks past 256 rows; see the header).
template <int kDyn, int kProc, bool kExtra>
__global__ void __launch_bounds__(tc::kThreads, 1)
mlp_rollout_wide_kernel(const MlpKernelParams p, int n, uint32_t seed, const float* __restrict__ noise,
                        const float* __restrict__ inv0, const TowerWeights<__nv_bfloat16> pi,
                        const TowerWeights<__nv_bfloat16> vf, const Layout lay, const float* __restrict__ log_std,
                        RolloutOut out, Extras ex, __nv_bfloat16* scratch) {
  tc::rollout<kDyn, kProc, kExtra, true>(p, n, seed, noise, inv0, pi, vf, lay, log_std, out, ex, scratch);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, int blocks, int threads, size_t smem, cudaStream_t stream, const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16, int kDyn, int kProc, bool kExtra>
int launch(const MlpKernelParams& p, int n, uint32_t seed, const float* noise, const float* inv0,
           const void* const* pi, const void* const* vf, const float* log_std, const RolloutOut& out,
           const Extras& ex, void* scratch, cudaStream_t stream) {
  using TW = Weight<kBf16>;
  const bool towers = vf[0] != nullptr;
  auto tower = [&](const void* const* t, int rows) {
    return TowerWeights<TW>{static_cast<const TW*>(t[0]), static_cast<const float*>(t[1]),
                            static_cast<const TW*>(t[2]), static_cast<const float*>(t[3]), rows};
  };
  const TowerWeights<TW> pi_w = tower(pi, towers ? p.a_dim : p.a_dim + 1);
  const TowerWeights<TW> vf_w = tower(vf, 1);
  Layout lay;
  int threads, tile, width = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    if (p.widths[l] % (kBf16 ? 16 : 4)) return static_cast<int>(cudaErrorInvalidValue);
    width = p.widths[l] > width ? p.widths[l] : width;
  }
  int max_optin = 0, device = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  // the wide route (this library with kWideLib) takes a scratch, the narrow one none
  if (kBf16 && (scratch != nullptr) != kWideLib) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kBf16) {
    if (p.a_dim + 1 > tc::kHead<kDyn> || p.s_dim > tc::kK0) return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (kWideLib) {
      lay = tc::layout_wide(p, tc::kHead<kDyn>);
    } else {  // the narrow route: every layer within one pass of the warps
      if (width > tc::kPassRows) return static_cast<int>(cudaErrorInvalidValue);
      lay = tc::layout(p, true, tc::kHead<kDyn>);
      if (lay.bytes > static_cast<size_t>(max_optin)) lay = tc::layout(p, false, tc::kHead<kDyn>);
    }
    threads = tc::kThreads;
    tile = tc::kE;
  } else {
    lay = cc::layout(p, scratch != nullptr);
    threads = cc::kThreads;
    tile = cc::kE;
  }
  if (lay.bytes > static_cast<size_t>(max_optin)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + tile - 1) / tile;
  if constexpr (kWideLib) {  // only this library's route is instantiated
    return launch_kernel(mlp_rollout_wide_kernel<kDyn, kProc, kExtra>, blocks, threads, lay.bytes, stream, p, n,
                         seed, noise, inv0, pi_w, vf_w, lay, log_std, out, ex, static_cast<TW*>(scratch));
  } else {
    return launch_kernel(mlp_rollout_kernel<kBf16, kDyn, kProc, kExtra>, blocks, threads, lay.bytes, stream, p, n,
                         seed, noise, inv0, pi_w, vf_w, lay, log_std, out, ex, static_cast<TW*>(scratch));
  }
}

// K3 in bf16 or float32; the wide library has no float32 kernel.
template <int kDyn, int kProc, bool kExtra>
int launch_dtype(const MlpKernelParams& p, int n, uint32_t seed, const float* noise, const float* inv0, int bf16,
                 const void* const* pi, const void* const* vf, const float* log_std, const RolloutOut& out,
                 const Extras& ex, void* scratch, cudaStream_t s) {
  if (bf16) return launch<true, kDyn, kProc, kExtra>(p, n, seed, noise, inv0, pi, vf, log_std, out, ex, scratch, s);
  if constexpr (kWideLib) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return launch<false, kDyn, kProc, kExtra>(p, n, seed, noise, inv0, pi, vf, log_std, out, ex, scratch, s);
  }
}

template <int kDyn>
int launch_dyn(const MlpKernelParams& p, int n, uint32_t seed, const float* noise, const float* inv0, int bf16,
               const void* const* pi, const void* const* vf, const float* log_std, const RolloutOut& out,
               const Extras& ex, void* scratch, cudaStream_t s) {
  if (p.a_dim != (kDyn == kLam ? 4 : kDyn == kSpeed ? 1 : 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.random_start != (ex.t0 != nullptr) || (ex.t0 && ex.fin)) return static_cast<int>(cudaErrorInvalidValue);
  if (ex.t0 || ex.fin) {  // the extras run the general instantiation's extras variant
    if (p.proc_mode != mbt::kProcGeneral) return static_cast<int>(cudaErrorInvalidValue);
    return launch_dtype<kDyn, mbt::kProcGeneral, true>(p, n, seed, noise, inv0, bf16, pi, vf, log_std, out, ex,
                                                      scratch, s);
  }
  if (p.proc_mode == mbt::kProcGeneral) {
    return launch_dtype<kDyn, mbt::kProcGeneral, false>(p, n, seed, noise, inv0, bf16, pi, vf, log_std, out, ex,
                                                       scratch, s);
  }
  // the plain processes observe S = 4, and the impact state too on speed
  if (p.proc_mode != mbt::kProcPlain || p.s_dim != (kDyn == kSpeed ? 5 : 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_dtype<kDyn, mbt::kProcPlain, false>(p, n, seed, noise, inv0, bf16, pi, vf, log_std, out, ex, scratch,
                                                   s);
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (0 on success).
// `noise` is NULL in native (Philox) mode; `inv0` is NULL for a fixed
// initial inventory, else the (n,) per-env initial inventories.  A tower is {w, bias, w_head,
// b_head}.  float32 (`bf16` clear): each layer's (in, out) weight matrix,
// layers concatenated; the biases concatenated; the head rows and their
// biases.  bf16 (`bf16` set): every width a multiple of 16 (the wrapper
// zero-pads); each layer's (out, in) matrix as bf16 in mma fragment order
// (ops/mlp_rollout.py::pack_mma_a), layer 0's k padded from S to 16 with
// zero columns, layers concatenated; the biases concatenated; the head
// rows zero-padded to 16 as bf16 in fragment order, and their biases
// (float).  Shared trunk: `pi` is the trunk with the merged (A+1)-row head
// and `vf` is four NULLs.  Towers: `pi` is the pi tower with its A rows,
// `vf` the vf tower with its value row, of equal widths.  n must be a
// multiple of 32, 1-64 layers, every width a multiple of 16 (bf16) or 4
// (float32); A is 4 on lam dynamics, 1 on speed and 2 on the others; S is
// 4 on the plain processes (5 on speed), at most 16 on the general kinds
// (p.proc_mode).  `t0` (the (n,) start times, exactly when p.random_start)
// and `fin` (the (S, n) terminal observation; not with t0) are NULL unless
// used, and need p.proc_mode general.  `scratch` is NULL, or the
// activation tiles of the wide (bf16) or scratch (float32) route, two per
// CTA (ops/mlp_rollout.py k3_scratch_bytes), which a bf16 trunk wider than
// 256 needs; that trunk goes to the wide library (mlp_rollout_wide.cu,
// bf16 with a scratch only), every other call to this one.
extern "C" int mbt_mlp_rollout(const MlpKernelParams* p, int device, int n, uint32_t seed,
                               const float* noise, const float* inv0, int bf16, const void* const* pi,
                               const void* const* vf, const float* log_std, float* obs, float* act, float* logp,
                               float* value, float* reward, const float* t0, float* fin, void* scratch,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (p->n_layers < 1 || p->n_layers > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  // CjOe is the speed kind's reward, CjMm and the running penalty the market-making kinds'
  const bool own = p->dynamics == kSpeed ? p->reward == kCjOe : p->reward == kCjMm || p->reward == kRunning;
  if (!(p->reward == kPnl || p->reward == kExpUtility || own)) return static_cast<int>(cudaErrorInvalidValue);
  const RolloutOut out{obs, act, logp, value, reward};
  const Extras ex{t0, fin};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->dynamics) {
    case kLimit: return launch_dyn<kLimit>(*p, n, seed, noise, inv0, bf16, pi, vf, log_std, out, ex, scratch, s);
    case kLam: return launch_dyn<kLam>(*p, n, seed, noise, inv0, bf16, pi, vf, log_std, out, ex, scratch, s);
    case kTouch: return launch_dyn<kTouch>(*p, n, seed, noise, inv0, bf16, pi, vf, log_std, out, ex, scratch, s);
    case kSpeed: return launch_dyn<kSpeed>(*p, n, seed, noise, inv0, bf16, pi, vf, log_std, out, ex, scratch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
