// CJP market-making episode kernel K8 for Hopper (sm_90a).
//
// Replaces the TPU kernel cj_episode_pallas
// (mbt_gym_tpu/ops/pallas_episode.py:409, pallas_call at :428): one whole
// CJP 2015 market-making episode per env, quoting from the closed-form
// depth table at each step, and only the terminal (cash, inventory, price,
// sum q_t^2) leaves the chip; the CjMm reward telescopes to those.
//
// Design: the warp-specialised step pipeline of step_pipeline.cuh (K1's,
// K5's and K6's).  A CTA owns E envs: E / 32 consumer warps step the envs,
// one thread per env with (cash, inventory, price, sum q^2) in registers,
// and P producer warps fill a ring of shared-memory slots with the inputs
// of the steps ahead: the draws (Philox in native mode, the (T, 5, N)
// channels copied by the bulk-copy engine in noise mode) and, for each of
// the slot's C steps, the step's interleaved (2Q+1, 2) row of the depth
// table and the same-shaped row of its fill probabilities exp(-k * depth)
// (402 floats each at the CJP's Q = 100).  The rows of consecutive steps
// lie one after the other, so each table's slot is one bulk copy, landed
// at its granule shift.  The fill probabilities are computed once per call
// by fill_table_kernel, the expf the step would take of the same float, so
// the bits agree.  The consumers' chain per step is then two pairs of
// shared-memory loads at the clipped inventory and the bookkeeping.  A
// table too wide for the ring is read from global memory through the
// read-only path (every thread of the card reads the same row).  The TPU
// kernel's one-hot MXU contraction against the row selects the same single
// entry, so the gather is exact.  From step_pipeline.py's WIDE_MIN_ENVS on
// (one thread per env fills the card) the wide shape runs instead: no
// producers, each thread draws its own draws and reads the tables from
// global memory.
//
// Bounds on the H100: 16 bytes written per env and nothing read per step
// in native mode beyond the table rows, so it is bound by operations: two
// Philox4x32-10 calls, logf/cosf/sqrtf and the fill test per env-step.  On
// the pipeline the producers' Philox products (IMAD.WIDE.U32) are the
// limit at 16,384 envs, as for K5's table stats mode.
//
// Numerics: every float op follows the plain PyTorch version's order
// (mbt_gym_torch/ops/cj_episode.py) under --fmad=false.  The JAX kernel
// draws the TPU's hardware bits only; this one takes K1's draws
// (draws.cuh): injected (T, 5, N) channels or native Philox, so on the same
// noise its terminal state equals K5's table stats mode on the same config.

#include <algorithm>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "draws.cuh"
#include "step_pipeline.cuh"

// Mirrors CjKernelParams in mbt_gym_torch/ops/cj_episode.py (ctypes).
struct CjKernelParams {
  int n_steps;
  int q_cap;
  float p_arr_bid;
  float p_arr_ask;
  float neg_k;
  float max_inventory;  // fill mask: the env's bound, not q_cap
  float drift_dt;
  float vol_sqrt_dt;
  float initial_price;
  mbt::PipeGeometry pipe;
};

namespace {

struct CjState {
  float cash, inv, price, sumq2;
};

// One CJP step on register state: the quotes and their fill probabilities
// at the clipped inventory, Bernoulli arrivals, fills masked at
// +/-max_inventory, bookkeeping at the pre-step price, BM price move.
__device__ __forceinline__ void cj_step(const CjKernelParams& p, const mbt::Draws& d, float bid, float ask,
                                        float fill_p_bid, float fill_p_ask, CjState& s) {
  const float arr_bid = d.u_ab < p.p_arr_bid ? 1.0f : 0.0f;
  const float arr_ask = d.u_aa < p.p_arr_ask ? 1.0f : 0.0f;
  const float fill_bid = (d.u_fb < fill_p_bid ? 1.0f : 0.0f) * (s.inv < p.max_inventory ? 1.0f : 0.0f);
  const float fill_ask = (d.u_fa < fill_p_ask ? 1.0f : 0.0f) * (s.inv > -p.max_inventory ? 1.0f : 0.0f);
  const float hit_bid = arr_bid * fill_bid;
  const float hit_ask = arr_ask * fill_ask;
  s.inv = s.inv + hit_bid - hit_ask;
  s.cash = s.cash - hit_bid * (s.price - bid) + hit_ask * (s.price + ask);
  s.sumq2 = s.sumq2 + s.inv * s.inv;  // post-update inventory (RewardFunctions.py:103)
  s.price = s.price + p.drift_dt + p.vol_sqrt_dt * d.normal;
}

// The (bid, ask) entry of a step's interleaved row at the clipped inventory.
__device__ __forceinline__ int quote_at(const CjKernelParams& p, float inv) {
  const float qf = fminf(fmaxf(inv + static_cast<float>(p.q_cap), 0.0f), 2.0f * p.q_cap);
  return 2 * static_cast<int>(qf);
}

// exp(neg_k * depth) of every table entry, computed once per call: the expf
// the step would take of the same float, so the bits agree.
__global__ void fill_table_kernel(float neg_k, const float* __restrict__ table, float* __restrict__ fill,
                                  size_t count) {
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; k < count;
       k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    fill[k] = expf(neg_k * table[k]);
  }
}

template <bool kNoise, bool kWide>
__global__ void __launch_bounds__(kWide ? mbt::kWideEnvs : mbt::kMaxPipeThreads)
cj_episode_kernel(const CjKernelParams p, int n, uint32_t seed, const float* __restrict__ noise,
                  const float* __restrict__ table, const float* __restrict__ fill, float* __restrict__ cash_out,
                  float* __restrict__ inv_out, float* __restrict__ price_out, float* __restrict__ sumq2_out) {
  const int row = 2 * (2 * p.q_cap + 1);  // floats from one step's row to the next
  CjState s{0.0f, 0.0f, p.initial_price, 0.0f};
  int env;
  if constexpr (kWide) {
    env = blockIdx.x * mbt::kWideEnvs + threadIdx.x;
    if (env >= n) return;
    for (int i = 0; i < p.n_steps; ++i) {
      const mbt::Draws d = mbt::draws_for<kNoise>(noise, n, seed, env, i);
      const size_t at = static_cast<size_t>(i) * row + quote_at(p, s.inv);
      cj_step(p, d, __ldg(table + at), __ldg(table + at + 1), __ldg(fill + at), __ldg(fill + at + 1), s);
    }
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    const mbt::StepRing ring(p.pipe, smem);
    const int warp = threadIdx.x >> 5;
    const int env0 = blockIdx.x * p.pipe.envs;
    if (warp >= ring.consumer_warps()) {
      // a step's rows of the two tables: the depths and their fill probabilities
      ring.produce<kNoise, 5>(warp - ring.consumer_warps(), p.n_steps, env0, n, seed, noise,
                              [=](int r, int i) { return (r == 0 ? table : fill) + static_cast<size_t>(i) * row; });
      return;
    }
    env = env0 + static_cast<int>(threadIdx.x);
    const int ts = mbt::table_stride(p.pipe);
    ring.consume(p.n_steps, [&](int slot, int c0, int steps) {
      const mbt::SlotDraws<kNoise, 5> draws{ring.draws(slot) + threadIdx.x, noise + env0, n,
                                            mbt::draw_stride(p.pipe)};
      // the slot's rows of the two tables, each run landed at its granule shift
      const size_t first = static_cast<size_t>(c0) * row;
      const float* depth_rows = ring.table(slot) + mbt::granule_shift(table + first);
      const float* fill_rows = ring.table(slot) + ts + mbt::granule_shift(fill + first);
      // the slot's steps, with the staged-table branch taken once per slot
      auto step_slot = [&](auto staged) {
        for (int j = 0; j < steps; ++j) {
          const int i = c0 + j;
          const int q = quote_at(p, s.inv);
          if constexpr (decltype(staged)::value) {
            const int at = j * row + q;
            cj_step(p, draws.limit(j, i), depth_rows[at], depth_rows[at + 1], fill_rows[at], fill_rows[at + 1], s);
          } else {
            const size_t at = static_cast<size_t>(i) * row + q;
            cj_step(p, draws.limit(j, i), __ldg(table + at), __ldg(table + at + 1), __ldg(fill + at),
                    __ldg(fill + at + 1), s);
          }
        }
      };
      if (p.pipe.staged) {
        step_slot(std::true_type{});
      } else {
        step_slot(std::false_type{});
      }
    });
    if (env >= n) return;
  }
  cash_out[env] = s.cash;
  inv_out[env] = s.inv;
  price_out[env] = s.price;
  sumq2_out[env] = s.sumq2;
}

// The geometry the wrapper chose, checked against what the kernel assumes:
// five draw channels; a staged table is the two interleaved tables.
bool pipe_ok(const CjKernelParams& p) {
  const mbt::PipeGeometry& g = p.pipe;
  const bool table_ok = g.table_rows == 2 && g.row_floats == 2 * (2 * p.q_cap + 1);
  return mbt::pipe_shape_ok(g, 5) && table_ok;
}

template <bool kNoise>
cudaError_t launch(const CjKernelParams& p, int n, uint32_t seed, const float* noise, const float* table,
                   const float* fill, float* cash, float* inv, float* price, float* sumq2, cudaStream_t s) {
  return mbt::is_wide(p.pipe)
             ? mbt::launch_pipeline(cj_episode_kernel<kNoise, true>, p.pipe, n, s, p, n, seed, noise, table, fill,
                                    cash, inv, price, sumq2)
             : mbt::launch_pipeline(cj_episode_kernel<kNoise, false>, p.pipe, n, s, p, n, seed, noise, table, fill,
                                    cash, inv, price, sumq2);
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on the caller's stream,
// allocates nothing and returns a CUDA error code (0 on success).

// fill[k] = expf(neg_k * table[k]) for the `count` floats of a depth table.
extern "C" int mbt_cj_fill_table(float neg_k, int device, const float* table, float* fill, size_t count,
                                 void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count == 0) return 0;
  const int blocks = static_cast<int>(std::min<size_t>((count + 255) / 256, 1024));
  fill_table_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(neg_k, table, fill, count);
  return static_cast<int>(cudaGetLastError());
}

// The episode.  `noise` is NULL in native (Philox) mode; `fill` holds
// mbt_cj_fill_table's probabilities of `table`.
extern "C" int mbt_cj_episode(const CjKernelParams* p, int device, int n, uint32_t seed, const float* noise,
                              const float* table, const float* fill, float* cash, float* inv, float* price,
                              float* sumq2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (!pipe_ok(*p)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = noise ? launch<true>(*p, n, seed, noise, table, fill, cash, inv, price, sumq2, s)
              : launch<false>(*p, n, seed, noise, table, fill, cash, inv, price, sumq2, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
