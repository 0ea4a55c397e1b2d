// Deterministic-policy rollout kernel K5 for Hopper (sm_90a).
//
// Replaces the TPU kernel _det_rollout_pallas
// (mbt_gym_tpu/ops/pallas_rollout.py:1876, pallas_call at :2017), which
// table_rollout_pallas (:1652), fixed_rollout_pallas (:1739) and
// schedule_rollout_pallas (:1790) reach: one whole episode per env with a
// deterministic policy (the CJ depth table, a constant action, or one
// action row per step) fused into the env step and reward.
//
// Ported scope: limit-order dynamics (Poisson arrivals, exponential fills)
// with the PnL, pathwise CJ or running-penalty reward, and trading-speed
// dynamics with temporary + permanent impact and the PnL or CJ execution
// reward; BM midprice; any inventory exponent; fixed start; optional
// per-env initial inventory (inv0); the terminal exponential utility on
// every dynamics kind.  The fixed and schedule kinds also run the
// limit-and-market-order ("lam": 4 columns, a unit market order where a
// trigger column exceeds 0.5 at mid -/+ the half-spread before the limit
// bookkeeping, optionally blocked at +/- max inventory on the pre-step
// inventory) and at-the-touch ("touch": the 2 post columns are the fills,
// at mid -/+ the half-spread) dynamics with the market-making rewards,
// each dynamics kind its own instantiation (template parameter kDyn), so
// the limit and speed kinds keep their code and bits; both draw the limit
// kind's five channels (touch leaves the fill uniforms unread).  The
// exponential utility, terminal * -exp(-gamma (cash + inventory price))
// (pallas_rollout.py:1173-1179), runs kernels of its own
// (det_rollout_kernel_utility), on the general processes, whose bits on the
// plain processes are the plain ones', so every other instantiation keeps
// its code.
//
// Design: a warp-specialised step pipeline (step_pipeline.cuh).  A CTA
// owns E envs: E / 32 consumer warps run the env step, one thread per env
// with the state (cash, inventory, price, impact, the reward and spread
// sums) in registers, and P producer warps fill a ring of shared-memory
// slots with the inputs of the steps ahead: the draws (Philox in native
// mode, the (T, 5, N) channels in noise mode, copied by the bulk-copy
// engine where 16-byte aligned) and, for the table kind, the bid and ask
// rows of the depth tables ((T+1) x (2Q+1) floats per side, 0.8 MB each at
// the CJP shape) that those steps read.  The consumers' chain per step is
// then a shared-memory load of the table entry at the clipped inventory,
// two expf and the bookkeeping; the Philox chains, the libm calls of
// Box-Muller and the table rows' L2 trips run in other warps, ahead.  A
// table too wide for the ring stays in global memory, read through the
// read-only path (__ldg) as every thread of the card reads the same row.
// The TPU kernel's one-hot MXU contraction selects the same single entry,
// so the gather is exact.  The schedule and fixed actions are uniform
// loads.  Streams are (T, S, N) / (T, A, N) / (T, N) with envs minor, so a
// consumer warp's store of one plane of one step is one 128-byte line.
// The geometry (E, P, the slot's C steps, the R slots, whether the table is
// staged) comes from step_pipeline.py::pipeline_geometry.
//
// Bounds on the H100: stats mode writes 20 bytes per env and reads nothing
// per step in native mode, so it is bound by operations (two Philox calls
// and the libm calls per env-step, one Philox call on speed dynamics).
// Streams mode writes (S + A + 1) floats per env-step (obs, actions,
// reward; the zero log-prob and value planes are written by the wrapper),
// and is bound by bytes once enough envs are in flight.
//
// Numerics: every float op follows the plain PyTorch version's order
// (mbt_gym_torch/ops/det_rollout.py), --fmad=false keeps every multiply
// and add separately rounded, and normalisation divides.  Draws: native
// Philox4x32-10 or injected (T, 5, N) channels, in the layout of
// draws.cuh.  Inventory exponents: exponent 2 runs its own instantiation
// (kAnyExp false), q(x) = x * x as before any other exponent was taken, so
// its code, bits and time stay those of the exponent-2 kernel; any other
// exponent runs the kAnyExp instantiation, q(x) = x * x at 2, x at 1 and
// powf otherwise (pallas_rollout.py:1142-1149).  One kernel with a runtime
// branch on the exponent cost the exponent-2 runs 11-64% (measured on the
// H100): the inlined powf raised the register count, and the speed
// dynamics took a 32-byte stack frame.
//
// Process kinds (template parameter kProc, proc_kinds.cuh): the plain
// processes (BM midprice, linear Poisson arrivals, exponential fills,
// temporary and permanent impact) run the instantiations above
// (kProcPlain), whose code is the kernel's from before the other kinds
// came.  Every other midprice model, the exact-probability Poisson and
// Hawkes arrivals, the triangular, power and exogenous-market-maker fills
// and the power and transient impacts run the general instantiation
// (kProcGeneral) of each (dynamics, policy) pair the kernel takes, the
// kinds runtime fields of p.proc, the inventory power the kAnyExp one; the
// composite stress family's fixed quotes on lam dynamics (bench_suite
// config 14: Hawkes arrivals, exogenous-MM fills with OU sides, BM
// midprice) run an instantiation with those kinds fixed at compile time
// (kProcComposite).  Its consumers carry the process states
// (second midprice column, Hawkes intensities, exogenous depths, impact
// state) in registers; its ring stages 8 draw channels a step on the
// market-making dynamics (the five, the two exogenous normals, the second
// midprice normal) and 2 on speed dynamics (the midprice normal and the
// second midprice normal), the extra normals drawn from the midprice
// normal's Philox call (draws.cuh: philox_extra_normals), so the five keep
// their bits.  In noise mode the injected (T, p.proc.channels, N) noise is
// placed by a noise map (step_pipeline.cuh).  The table kind's fill
// probabilities come from the fill kind of the raw depth, not from the fill
// tables.
//
// TPU-only parts not ported: the sublane `rows` packing, the VMEM tile
// search, pltpu.prng_seed and the 1e-42 carry jitter.

#include <algorithm>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "draws.cuh"
#include "inventory_power.cuh"
#include "proc_kinds.cuh"
#include "step_pipeline.cuh"

constexpr int kMaxS = 16;
constexpr int kPlainS = 5;  // the plain processes' observation: cash, inventory, time, price[, impact]
constexpr int kMaxA = 4;

// Mirrors DetKernelParams in mbt_gym_torch/ops/det_rollout.py (ctypes).
struct DetKernelParams {
  int run_steps;
  int t_off;          // round(start_time / dt): first table/schedule row
  int dynamics;       // 0 limit, 1 speed, 2 lam, 3 touch
  int policy;         // 0 table, 1 fixed, 2 schedule
  int reward;         // 0 pnl, 1 cjmm, 2 running, 3 cjoe
  int normalise_obs;
  int normalise_act;
  int s_dim;
  int a_dim;
  int q_max;
  int table_width;    // row stride of the depth tables
  float start_time;
  float dt;
  float t_term;       // start_time + run_steps * dt (the terminal obs time)
  float obs_low[kMaxS];
  float obs_grad[kMaxS];
  float act_low[kMaxA];
  float act_grad[kMaxA];
  float fixed_action[kMaxA];
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
  float temporary_impact;
  float permanent_impact;
  float dt_phi;       // dt * phi; -risk_aversion under the exponential utility, which has no inventory terms
  float alpha;
  float dt_alpha;     // dt * alpha
  float cjmm_const;   // alpha * dt / episode_length
  float ep_len;       // terminal_time - start_time
  float inv_exp;      // inventory exponent
  float half_spread;  // lam and touch: the fixed market half-spread
  int mask_mo;        // lam: block market orders at +/- max_inventory
  int proc_mode;      // mbt::ProcMode: the plain, general or composite instantiation
  mbt::ProcParams proc;
  mbt::PipeGeometry pipe;
};

// Mirrors _DetBuffers: NULL where a mode does not use a buffer.
struct DetBuffers {
  const float* noise;     // (T, 5, N) ((T, p.proc.channels, N) general) or NULL (native Philox)
  const float* inv0;      // (N,) or NULL (initial_inventory for all)
  const float* bid;       // table policy: (rows, table_width)
  const float* ask;
  float* fill_bid;        // table policy: expf(neg_k * bid), the rows the episode reads
  float* fill_ask;        //   (written by fill_table_kernel before the episode)
  const float* schedule;  // schedule policy: (rows, a_dim)
  float* obs;             // streams: (T, S, N)
  float* act;             // streams: (T, A, N)
  float* rew;             // streams: (T, N)
  float* fin;             // streams, optional: (S, N)
  float* cash;            // stats: (N,) each
  float* inv;
  float* price;
  float* rsum;
  float* ssum;
};

namespace {

enum Dynamics { kLimit = 0, kSpeed = 1, kLam = 2, kTouch = 3 };
enum Policy { kTable = 0, kFixed = 1, kSchedule = 2 };
enum Reward { kPnl = 0, kCjMm = 1, kRunning = 2, kCjOe = 3, kExpUtility = 4 };

// q(x) at the kernel's exponent: x * x in the exponent-2 instantiation.
template <bool kAnyExp>
__device__ __forceinline__ float q_exp(float x, float e) {
  if constexpr (kAnyExp) {
    return mbt::q_pow(x, e);
  } else {
    return x * x;
  }
}

// The observation planes of a state, normalised per the config.
__device__ __forceinline__ void write_obs(const DetKernelParams& p, float* out, size_t stride,
                                          float cash, float inv, float t, float price, float imp) {
  const float planes[kPlainS] = {cash, inv, t, price, imp};
#pragma unroll
  for (int c = 0; c < kPlainS; ++c) {
    if (c < p.s_dim) {
      float x = planes[c];
      if (p.normalise_obs) x = (x - p.obs_low[c]) / p.obs_grad[c] - 1.0f;
      out[c * stride] = x;
    }
  }
}

// The general kinds' observation planes: the process states follow the price.
template <int kProc>
__device__ __forceinline__ void write_obs_general(const DetKernelParams& p, float* out, size_t stride, float cash,
                                                  float inv, float t, float price, const mbt::ProcState& ps) {
  for (int c = 0; c < p.s_dim; ++c) {
    float x = c == 0 ? cash : c == 1 ? inv : c == 2 ? t : c == 3 ? price : mbt::proc_plane<kProc>(p.proc, ps, c - 4);
    if (p.normalise_obs) x = (x - p.obs_low[c]) / p.obs_grad[c] - 1.0f;
    out[c * stride] = x;
  }
}

// The general kinds' noise map (step_pipeline.cuh), read from the params:
// ring channels 0-4 are the five, then the exogenous normals and the second
// midprice normal where the config has them (on speed dynamics the ring
// holds the midprice normal and the second midprice normal).  A channel the
// config lacks maps to the midprice normal's, never read.
template <int kDyn>
struct ProcNoiseMap {
  const mbt::ProcParams& q;
  __device__ int channels() const { return q.channels; }
  __device__ bool extras() const { return q.ch_exo >= 0 || q.ch_mid2 >= 0; }
  __device__ int of(int c) const {
    const int mid2 = q.ch_mid2 >= 0 ? q.ch_mid2 : 4;
    if (kDyn == kSpeed) return c == 0 ? 4 : mid2;
    if (c < 5) return c;
    if (c < 7) return q.ch_exo >= 0 ? q.ch_exo + (c - 5) : 4;
    return mid2;
  }
};

// The table kind's fill probabilities exp(-k * depth) of every table entry
// the episode's rows hold, computed once per call (the expf the env step
// would take of the same float, so the bits agree): the consumers' chain
// per step then reads them instead of calling expf.
__global__ void fill_table_kernel(float neg_k, const float* __restrict__ bid, const float* __restrict__ ask,
                                  float* __restrict__ fill_bid, float* __restrict__ fill_ask, size_t count) {
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; k < count;
       k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    fill_bid[k] = expf(neg_k * bid[k]);
    fill_ask[k] = expf(neg_k * ask[k]);
  }
}

// One CTA's episodes (the kernels below).
template <bool kNoise, int kDyn, int kPol, bool kStats, bool kAnyExp, int kProc, bool kUtility>
__device__ __forceinline__ void det_rollout_cta(const DetKernelParams& p, const DetBuffers& b, int n, uint32_t seed) {
  extern __shared__ __align__(16) unsigned char smem[];
  const mbt::StepRing ring(p.pipe, smem);
  const int warp = threadIdx.x >> 5;
  const int env0 = blockIdx.x * p.pipe.envs;
  constexpr bool kGen = kProc != mbt::kProcPlain;
  constexpr int kChannels = kGen ? (kDyn == kSpeed ? 2 : 8) : (kDyn == kSpeed ? 1 : 5);
  if (warp >= ring.consumer_warps()) {
    const float* bid = b.bid;
    const float* ask = b.ask;
    const float* fill_bid = b.fill_bid;
    const float* fill_ask = b.fill_ask;
    const int t_off = p.t_off, width = p.table_width;
    // a step's rows of the four tables: bid, ask and their fill probabilities
    auto table_row = [=](int r, int i) {
      const float* table = r == 0 ? bid : r == 1 ? ask : r == 2 ? fill_bid : fill_ask;
      return table + static_cast<size_t>(t_off + i) * width;
    };
    if constexpr (kGen) {
      ring.produce<kNoise, kChannels, 5>(warp - ring.consumer_warps(), p.run_steps, env0, n, seed, b.noise, table_row,
                                         ProcNoiseMap<kDyn>{p.proc});
    } else {
      ring.produce<kNoise, kChannels>(warp - ring.consumer_warps(), p.run_steps, env0, n, seed, b.noise, table_row);
    }
    return;
  }
  const int ts = mbt::table_stride(p.pipe);
  const int e_local = threadIdx.x;
  const int env = env0 + e_local;
  const bool active = env < n;
  const size_t sn = static_cast<size_t>(n);
  float cash = p.initial_cash;
  float inv = b.inv0 && active ? b.inv0[env] : p.initial_inventory;
  const float q0_pow = q_exp<kAnyExp>(inv, p.inv_exp);
  float price = p.initial_price;
  float imp = 0.0f;
  float rsum = 0.0f, ssum = 0.0f;
  [[maybe_unused]] mbt::ProcState ps{};
  if constexpr (kGen) ps = mbt::proc_initial(p.proc);
  ring.consume(p.run_steps, [&](int slot, int c0, int steps) {
    using SlotDraws = std::conditional_t<kGen, mbt::MappedSlotDraws<kNoise, kChannels, ProcNoiseMap<kDyn>>,
                                         mbt::SlotDraws<kNoise, kChannels>>;
    const SlotDraws draws = [&] {
      if constexpr (kGen) {
        return SlotDraws{ring.draws(slot) + e_local, b.noise + env0, n, mbt::draw_stride(p.pipe),
                         ProcNoiseMap<kDyn>{p.proc}};
      } else {
        return SlotDraws{ring.draws(slot) + e_local, b.noise + env0, n, mbt::draw_stride(p.pipe)};
      }
    }();
    // the slot's rows of the four tables, each run landed at its granule shift
    const size_t first_row = static_cast<size_t>(p.t_off + c0) * p.table_width;
    const float* bid_rows = ring.table(slot) + mbt::granule_shift(b.bid + first_row);
    const float* ask_rows = ring.table(slot) + ts + mbt::granule_shift(b.ask + first_row);
    const float* fill_bid_rows = ring.table(slot) + 2 * ts + mbt::granule_shift(b.fill_bid + first_row);
    const float* fill_ask_rows = ring.table(slot) + 3 * ts + mbt::granule_shift(b.fill_ask + first_row);
    // the slot's steps, with the staged-table branch taken once per slot
    auto step_slot = [&](auto staged) {
      [[maybe_unused]] constexpr bool kStaged = decltype(staged)::value;
      for (int j = 0; j < steps; ++j) {
        const int i = c0 + j;
        [[maybe_unused]] const int row = p.t_off + i;
        // ---- policy: the raw action columns (what the stream records)
        float raw0, raw1 = 0.0f;
        [[maybe_unused]] float raw2 = 0.0f, raw3 = 0.0f;  // lam's market-order columns
        [[maybe_unused]] float fill_p0, fill_p1;  // exp(neg_k * depth): the table kind's from its fill tables
        if constexpr (kPol == kTable) {
          const float qf = fminf(fmaxf(static_cast<float>(p.q_max) + inv, 0.0f), 2.0f * p.q_max);
          const int q = static_cast<int>(qf);
          if constexpr (kStaged) {
            const int at = j * p.table_width + q;
            fill_p0 = fill_bid_rows[at];
            fill_p1 = fill_ask_rows[at];
            raw0 = bid_rows[at];
            raw1 = ask_rows[at];
          } else {
            const size_t at = static_cast<size_t>(row) * p.table_width + q;
            fill_p0 = __ldg(b.fill_bid + at);
            fill_p1 = __ldg(b.fill_ask + at);
            raw0 = __ldg(b.bid + at);
            raw1 = __ldg(b.ask + at);
          }
        } else if constexpr (kPol == kSchedule) {
          const float* sched = b.schedule + static_cast<size_t>(row) * p.a_dim;
          raw0 = __ldg(sched);
          if constexpr (kDyn != kSpeed) raw1 = __ldg(sched + 1);
          if constexpr (kDyn == kLam) {
            raw2 = __ldg(sched + 2);
            raw3 = __ldg(sched + 3);
          }
        } else {
          raw0 = p.fixed_action[0];
          raw1 = p.fixed_action[1];
          if constexpr (kDyn == kLam) {
            raw2 = p.fixed_action[2];
            raw3 = p.fixed_action[3];
          }
        }
        float exe0 = raw0, exe1 = raw1;
        [[maybe_unused]] float exe2 = raw2, exe3 = raw3;
        if constexpr (kPol != kTable) {  // the table kind quotes raw depths (pipe_ok)
          if (p.normalise_act) {
            exe0 = (raw0 + 1.0f) * p.act_grad[0] + p.act_low[0];
            exe1 = (raw1 + 1.0f) * p.act_grad[1] + p.act_low[1];
            if constexpr (kDyn == kLam) {
              exe2 = (raw2 + 1.0f) * p.act_grad[2] + p.act_low[2];
              exe3 = (raw3 + 1.0f) * p.act_grad[3] + p.act_low[3];
            }
          }
        }
        if constexpr (!kStats) {
          if (active) {
            const float t = p.start_time + static_cast<float>(i) * p.dt;
            const size_t o = static_cast<size_t>(i) * p.s_dim * sn + env;
            if constexpr (kGen) {
              write_obs_general<kProc>(p, b.obs + o, sn, cash, inv, t, price, ps);
            } else {
              write_obs(p, b.obs + o, sn, cash, inv, t, price, imp);
            }
            const size_t a = static_cast<size_t>(i) * p.a_dim * sn + env;
            b.act[a] = raw0;
            if constexpr (kDyn != kSpeed) b.act[a + sn] = raw1;
            if constexpr (kDyn == kLam) {
              b.act[a + 2 * sn] = raw2;
              b.act[a + 3 * sn] = raw3;
            }
          }
        }
        // ---- env step (TradingEnvironment.py:198-216 order)
        float new_cash, new_inv, normal;
        [[maybe_unused]] float hit_bid = 0.0f, hit_ask = 0.0f, n_mid2 = 0.0f;
        if constexpr (kGen) {  // the process kinds of p.proc (proc_kinds.cuh)
          if constexpr (kDyn == kSpeed) {
            normal = draws.at(j, i, 0);
            if (p.proc.has_mid2) n_mid2 = draws.at(j, i, 1);
            const float impact = mbt::speed_impact(p.proc, p.temporary_impact, p.permanent_impact, ps, exe0);
            const float volume = exe0 * p.dt;
            new_inv = inv + volume;
            new_cash = cash - volume * (price + impact);
          } else {
            constexpr int kMarket = kDyn == kLam ? mbt::kMarketLam : kDyn == kTouch ? mbt::kMarketTouch
                                                                                     : mbt::kMarketLimit;
            const mbt::Draws d = draws.limit(j, i);
            const mbt::Kinds<kProc> kinds{p.proc};
            float exo_nb = 0.0f, exo_na = 0.0f;
            if (kinds.fill() == mbt::kFillExoMm) {
              exo_nb = draws.at(j, i, 5);
              exo_na = draws.at(j, i, 6);
            }
            if (kinds.has_mid2()) n_mid2 = draws.at(j, i, 7);
            const float u[4] = {d.u_ab, d.u_aa, d.u_fb, d.u_fa};
            const float exe[4] = {exe0, exe1, exe2, exe3};
            const mbt::MarketOut m =
                mbt::market_step<kMarket, kProc>(p, ps, u, exo_nb, exo_na, exe, cash, inv, price);
            new_inv = m.inv;
            new_cash = m.cash;
            hit_bid = m.hit_bid;
            hit_ask = m.hit_ask;
            normal = d.normal;
          }
        } else if constexpr (kDyn == kLimit) {
          const mbt::Draws d = draws.limit(j, i);
          if constexpr (kPol != kTable) {
            fill_p0 = expf(p.neg_k * exe0);
            fill_p1 = expf(p.neg_k * exe1);
          }
          const float arr_bid = d.u_ab < p.p_arr_bid ? 1.0f : 0.0f;
          const float arr_ask = d.u_aa < p.p_arr_ask ? 1.0f : 0.0f;
          const float fill_bid = (d.u_fb < fill_p0 ? 1.0f : 0.0f) * (inv < p.max_inventory ? 1.0f : 0.0f);
          const float fill_ask = (d.u_fa < fill_p1 ? 1.0f : 0.0f) * (inv > -p.max_inventory ? 1.0f : 0.0f);
          const float hit_bid = arr_bid * fill_bid;
          const float hit_ask = arr_ask * fill_ask;
          new_inv = inv + hit_bid - hit_ask;
          new_cash = cash - hit_bid * (price - exe0) + hit_ask * (price + exe1);
          normal = d.normal;
        } else if constexpr (kDyn == kLam) {
          const mbt::Draws d = draws.limit(j, i);
          const float can_buy = inv < p.max_inventory ? 1.0f : 0.0f;
          const float can_sell = inv > -p.max_inventory ? 1.0f : 0.0f;
          float mo_buy = exe2 > 0.5f ? 1.0f : 0.0f;
          float mo_sell = exe3 > 0.5f ? 1.0f : 0.0f;
          if (p.mask_mo) {
            mo_buy = mo_buy * can_buy;
            mo_sell = mo_sell * can_sell;
          }
          const float arr_bid = d.u_ab < p.p_arr_bid ? 1.0f : 0.0f;
          const float arr_ask = d.u_aa < p.p_arr_ask ? 1.0f : 0.0f;
          const float fill_bid = (d.u_fb < expf(p.neg_k * exe0) ? 1.0f : 0.0f) * can_buy;
          const float fill_ask = (d.u_fa < expf(p.neg_k * exe1) ? 1.0f : 0.0f) * can_sell;
          const float hit_bid = arr_bid * fill_bid;
          const float hit_ask = arr_ask * fill_ask;
          new_inv = inv + (mo_buy - mo_sell) + hit_bid - hit_ask;
          new_cash = cash + mo_sell * (price - p.half_spread) - mo_buy * (price + p.half_spread) -
                     hit_bid * (price - exe0) + hit_ask * (price + exe1);
          normal = d.normal;
        } else if constexpr (kDyn == kTouch) {
          const mbt::Draws d = draws.limit(j, i);
          const float arr_bid = d.u_ab < p.p_arr_bid ? 1.0f : 0.0f;
          const float arr_ask = d.u_aa < p.p_arr_ask ? 1.0f : 0.0f;
          const float hit_bid = arr_bid * (exe0 * (inv < p.max_inventory ? 1.0f : 0.0f));
          const float hit_ask = arr_ask * (exe1 * (inv > -p.max_inventory ? 1.0f : 0.0f));
          new_inv = inv + hit_bid - hit_ask;
          new_cash = cash - hit_bid * (price - p.half_spread) + hit_ask * (price + p.half_spread);
          normal = d.normal;
        } else {
          // impact at the pre-update state, then the permanent-impact recursion
          const float impact = p.temporary_impact * exe0 + imp;
          const float new_imp = imp + p.permanent_impact * exe0 * p.dt;
          const float volume = exe0 * p.dt;
          new_inv = inv + volume;
          new_cash = cash - volume * (price + impact);
          imp = new_imp;
          normal = draws.at(j, i, 0);
        }
        new_inv = fminf(fmaxf(new_inv, -p.max_inventory), p.max_inventory);
        new_cash = fminf(fmaxf(new_cash, -p.max_cash), p.max_cash);
        const float new_price = [&] {
          if constexpr (kGen) {
            return mbt::midprice_step<kProc>(p.proc, p.drift_dt, p.vol_sqrt_dt, ps, price, normal, n_mid2, hit_bid,
                                             hit_ask);
          } else {
            return price + p.drift_dt + p.vol_sqrt_dt * normal;
          }
        }();
        // ---- reward at the post-step state (RewardFunctions.py)
        float reward = (new_cash + new_inv * new_price) - (cash + inv * price);
        if constexpr (kUtility) {  // the exponential utility: terminal * -exp(-gamma * value)
          const float terminal = i == p.run_steps - 1 ? 1.0f : 0.0f;
          reward = terminal * -expf(p.dt_phi * (new_cash + new_inv * new_price));
        } else {
          const float q_new = q_exp<kAnyExp>(new_inv, p.inv_exp);
          if (p.reward == kCjMm) {
            reward = reward - p.dt_phi * q_new - p.alpha * (q_new - q_exp<kAnyExp>(inv, p.inv_exp)) -
                     p.cjmm_const * q0_pow;
          } else if (p.reward == kRunning) {
            const float terminal = i == p.run_steps - 1 ? 1.0f : 0.0f;
            reward = reward - p.dt_phi * q_new - (p.alpha * terminal) * q_new;
          } else if (p.reward == kCjOe) {
            // e * speed * q(inv, e - 1): 2 * speed * inv at exponent 2
            const float dq = kAnyExp ? p.inv_exp * exe0 * mbt::q_pow(inv, p.inv_exp - 1.0f) : 2.0f * exe0 * inv;
            reward = reward - p.dt_phi * q_new - p.dt_alpha * (dq + q0_pow * p.ep_len);
          }
        }
        if constexpr (kStats) {
          rsum = rsum + reward;
          if constexpr (kDyn != kSpeed) ssum = ssum + (raw0 + raw1);
        } else if (active) {
          b.rew[static_cast<size_t>(i) * sn + env] = reward;
        }
        cash = new_cash;
        inv = new_inv;
        price = new_price;
      }
    };
    if (kPol == kTable && p.pipe.staged) {
      step_slot(std::true_type{});
    } else {
      step_slot(std::false_type{});
    }
  });
  if (!active) return;
  if constexpr (kStats) {
    b.cash[env] = cash;
    b.inv[env] = inv;
    b.price[env] = price;
    b.rsum[env] = rsum;
    b.ssum[env] = ssum;
  } else {
    if (b.fin) {
      if constexpr (kGen) {
        write_obs_general<kProc>(p, b.fin + env, sn, cash, inv, p.t_term, price, ps);
      } else {
        write_obs(p, b.fin + env, sn, cash, inv, p.t_term, price, imp);
      }
    }
  }
}

template <bool kNoise, int kDyn, int kPol, bool kStats, bool kAnyExp, int kProc = mbt::kProcPlain>
__global__ void __launch_bounds__(mbt::kMaxPipeThreads)
det_rollout_kernel(const DetKernelParams p, const DetBuffers b, int n, uint32_t seed) {
  det_rollout_cta<kNoise, kDyn, kPol, kStats, kAnyExp, kProc, false>(p, b, n, seed);
}

// The exponential utility's kernels, on the general processes: one block
// per SM at most, so ptxas may hold the env's state in registers (with the
// first kernel's launch bounds it spilled the table kind's native streams).
template <bool kNoise, int kDyn, int kPol, bool kStats>
__global__ void __launch_bounds__(mbt::kMaxPipeThreads, 1)
det_rollout_kernel_utility(const DetKernelParams p, const DetBuffers b, int n, uint32_t seed) {
  det_rollout_cta<kNoise, kDyn, kPol, kStats, true, mbt::kProcGeneral, true>(p, b, n, seed);
}

template <bool kNoise, int kDyn, int kPol, bool kAnyExp>
cudaError_t launch_exp(const DetKernelParams& p, const DetBuffers& b, int n, uint32_t seed, bool stats,
                       cudaStream_t s) {
  return stats ? mbt::launch_pipeline(det_rollout_kernel<kNoise, kDyn, kPol, true, kAnyExp>, p.pipe, n, s, p, b, n,
                                      seed)
               : mbt::launch_pipeline(det_rollout_kernel<kNoise, kDyn, kPol, false, kAnyExp>, p.pipe, n, s, p, b, n,
                                      seed);
}

// The general kinds (and the composite family's): one instantiation per
// (dynamics, policy, mode), at any inventory exponent.
template <bool kNoise, int kDyn, int kPol, int kProc>
cudaError_t launch_general(const DetKernelParams& p, const DetBuffers& b, int n, uint32_t seed, bool stats,
                           cudaStream_t s) {
  return stats ? mbt::launch_pipeline(det_rollout_kernel<kNoise, kDyn, kPol, true, true, kProc>, p.pipe, n, s, p, b, n,
                                      seed)
               : mbt::launch_pipeline(det_rollout_kernel<kNoise, kDyn, kPol, false, true, kProc>, p.pipe, n, s, p, b,
                                      n, seed);
}

// The exponential utility: one instantiation per (dynamics, policy, mode)
// on the general processes.
template <bool kNoise, int kDyn, int kPol>
cudaError_t launch_utility(const DetKernelParams& p, const DetBuffers& b, int n, uint32_t seed, bool stats,
                           cudaStream_t s) {
  return stats ? mbt::launch_pipeline(det_rollout_kernel_utility<kNoise, kDyn, kPol, true>, p.pipe, n, s, p, b, n,
                                      seed)
               : mbt::launch_pipeline(det_rollout_kernel_utility<kNoise, kDyn, kPol, false>, p.pipe, n, s,
                                      p, b, n, seed);
}

template <bool kNoise, int kDyn, int kPol>
cudaError_t launch_mode(const DetKernelParams& p, const DetBuffers& b, int n, uint32_t seed, bool stats,
                        cudaStream_t s) {
  if (p.reward == kExpUtility) return launch_utility<kNoise, kDyn, kPol>(p, b, n, seed, stats, s);
  if constexpr (kDyn == kLam && kPol == kFixed) {
    if (p.proc_mode == mbt::kProcComposite) {
      return launch_general<kNoise, kDyn, kPol, mbt::kProcComposite>(p, b, n, seed, stats, s);
    }
  }
  if (p.proc_mode == mbt::kProcGeneral) {
    return launch_general<kNoise, kDyn, kPol, mbt::kProcGeneral>(p, b, n, seed, stats, s);
  }
  if (p.proc_mode != mbt::kProcPlain) return cudaErrorInvalidValue;
  return p.inv_exp == 2.0f ? launch_exp<kNoise, kDyn, kPol, false>(p, b, n, seed, stats, s)
                           : launch_exp<kNoise, kDyn, kPol, true>(p, b, n, seed, stats, s);
}

template <bool kNoise>
cudaError_t launch(const DetKernelParams& p, const DetBuffers& b, int n, uint32_t seed, bool stats,
                   cudaStream_t s) {
  if (p.dynamics == kLimit) {
    switch (p.policy) {
      case kTable: {
        const size_t first = static_cast<size_t>(p.t_off) * p.table_width;
        const size_t count = static_cast<size_t>(p.run_steps) * p.table_width;
        if (count > 0) {
          const int blocks = static_cast<int>(std::min<size_t>((count + 255) / 256, 1024));
          fill_table_kernel<<<blocks, 256, 0, s>>>(p.neg_k, b.bid + first, b.ask + first, b.fill_bid + first,
                                                   b.fill_ask + first, count);
        }
        return launch_mode<kNoise, kLimit, kTable>(p, b, n, seed, stats, s);
      }
      case kFixed: return launch_mode<kNoise, kLimit, kFixed>(p, b, n, seed, stats, s);
      case kSchedule: return launch_mode<kNoise, kLimit, kSchedule>(p, b, n, seed, stats, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (p.dynamics == kSpeed) {
    switch (p.policy) {
      case kFixed: return launch_mode<kNoise, kSpeed, kFixed>(p, b, n, seed, stats, s);
      case kSchedule: return launch_mode<kNoise, kSpeed, kSchedule>(p, b, n, seed, stats, s);
      default: return cudaErrorInvalidValue;  // the depth table quotes limit depths
    }
  }
  // lam and touch: the fixed and schedule kinds (the depth table quotes limit depths)
  const bool fixed = p.policy == kFixed;
  if (!fixed && p.policy != kSchedule) return cudaErrorInvalidValue;
  if (p.dynamics == kLam) {
    return fixed ? launch_mode<kNoise, kLam, kFixed>(p, b, n, seed, stats, s)
                 : launch_mode<kNoise, kLam, kSchedule>(p, b, n, seed, stats, s);
  }
  if (p.dynamics == kTouch) {
    return fixed ? launch_mode<kNoise, kTouch, kFixed>(p, b, n, seed, stats, s)
                 : launch_mode<kNoise, kTouch, kSchedule>(p, b, n, seed, stats, s);
  }
  return cudaErrorInvalidValue;
}

// The geometry the wrapper chose, checked against what the kernel assumes.
bool pipe_ok(const DetKernelParams& p) {
  const mbt::PipeGeometry& g = p.pipe;
  // the table kind's fill tables hold exp(neg_k * depth) of the raw depth,
  // which is what the step exponentiates only when actions are not rescaled
  if (p.policy == kTable && p.normalise_act) return false;
  const bool table_ok = !g.staged || (p.policy == kTable && g.table_rows == 4 && g.row_floats == p.table_width);
  const int channels = p.proc_mode ? (p.dynamics == kSpeed ? 2 : 8) : (p.dynamics == kSpeed ? 1 : 5);
  // the plain processes observe at most kPlainS planes
  return mbt::pipe_shape_ok(g, channels) && table_ok && (p.proc_mode || p.s_dim <= kPlainS);
}

}  // namespace

// C entry point, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing and returns a CUDA error code (0 on success).
extern "C" int mbt_det_rollout(const DetKernelParams* p, const DetBuffers* b, int device, int n,
                               uint32_t seed, int stats_only, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  // the exponential utility runs the general instantiations
  const bool reward_ok = p->reward >= kPnl && p->reward <= kExpUtility &&
                         (p->reward != kExpUtility || p->proc_mode == mbt::kProcGeneral);
  if (p->s_dim > kMaxS || p->a_dim < 1 || p->a_dim > kMaxA || !reward_ok || !pipe_ok(*p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = b->noise ? launch<true>(*p, *b, n, seed, stats_only != 0, s)
                 : launch<false>(*p, *b, n, seed, stats_only != 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
