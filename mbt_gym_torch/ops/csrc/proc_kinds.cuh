// The process kinds of the rollout kernels K3 (mlp_rollout.cu) and K5
// (det_rollout.cu) beyond the plain ones: every midprice model, linear and
// exact-probability Poisson and Hawkes arrivals, exponential, triangular,
// power and exogenous-market-maker fills, the four impact models
// (pallas_rollout.py:900-1140).  The plain processes (BM, linear Poisson,
// exponential, temporary and permanent impact) keep the kernels' original
// instantiations, whose code does not include this.  The functions here are
// templated on kProc: kProcGeneral reads the kinds from ProcParams at run
// time; kProcComposite (K5's fixed kind on lam) fixes the composite stress
// family's (BM midprice, Hawkes arrivals, exogenous-MM fills with OU sides,
// no second midprice column) at compile time, so its instantiations carry
// only that code.
//
// Numerics: every function repeats the float32 operation order of
// mbt_gym_torch/ops/proc_kinds.py, itself the JAX kernel's, with the
// constants ProcParams holds (each the float32 rounding of the double the
// JAX kernel forms from its Python floats).  --fmad=false keeps every
// multiply and add separately rounded; powf is what the plain version's
// tensor-exponent torch.pow calls on the card.
#pragma once

#include <cuda_runtime.h>

namespace mbt {

enum MidpriceKind { kMidBm = 0, kMidConstant, kMidGbm, kMidOu, kMidCev, kMidBmJump, kMidOuJump, kMidHeston,
                    kMidStOu, kMidStJump };
enum ArrivalKind { kArrPoisson = 0, kArrPoissonNl, kArrHawkes };
enum FillKind { kFillExp = 0, kFillTriangular, kFillPower, kFillExoMm };
enum ExoKind { kExoOu = 0, kExoBm, kExoGbm };
enum ImpactKind { kImpTempPerm = 0, kImpPower, kImpTransient, kImpTempTransient };
// The market-making dynamics a general step runs.
enum MarketKind { kMarketLimit = 0, kMarketLam, kMarketTouch };
// How an instantiation takes its process kinds (the kernels' template
// argument kProc; 0 is the plain processes' instantiation).
enum ProcMode { kProcPlain = 0, kProcGeneral = 1, kProcComposite = 2 };

// Mirrors ProcParams in mbt_gym_torch/ops/proc_kinds.py (ctypes).
struct ProcParams {
  int midprice;
  int arrival;
  int fill;
  int impact;
  int has_mid2;
  int channels;  // noise-mode channels per step
  int ch_exo;    // the first exogenous normal's channel (-1: none)
  int ch_mid2;   // the second-midprice normal's channel (-1: none)
  float dt;
  float drift;
  float mid_rev;    // ou, oujump: -speed * (dt if dt-scaled else 1)
  float mid_level;  // ou, oujump: level; cev: gamma
  float mid_jump;
  float mid2_initial;
  float mid2_level;
  float mid2_speed;
  float mid2_vol;
  float mid2_rev;
  float mid2_vol_sqrt_dt;
  float mid2_corr;
  float mid2_corr_c;  // sqrt(1 - corr^2)
  float hawkes_base[2];
  float hawkes_mr;
  float hawkes_jump;
  float fill_param;  // triangular: max depth; power: multiplier
  float fill_k;      // power: exponent
  float exo_base;
  int exo_kind[2];
  float exo_level[2];
  float exo_rev[2];
  float exo_drift_dt[2];
  float exo_vol_sqrt_dt[2];
  float exo_initial[2];
  float impact_exp;
  float impact_kappa;
  float impact_rho;
  float impact_gamma;
  float impact_initial;
};

// The kinds an instantiation runs: fixed under kProcComposite.
template <int kProc> struct Kinds;
template <> struct Kinds<kProcGeneral> {
  const ProcParams& q;
  __device__ int midprice() const { return q.midprice; }
  __device__ int arrival() const { return q.arrival; }
  __device__ int fill() const { return q.fill; }
  __device__ int exo(int i) const { return q.exo_kind[i]; }
  __device__ bool has_mid2() const { return q.has_mid2; }
};
template <> struct Kinds<kProcComposite> {
  const ProcParams& q;
  __device__ int midprice() const { return kMidBm; }
  __device__ int arrival() const { return kArrHawkes; }
  __device__ int fill() const { return kFillExoMm; }
  __device__ int exo(int) const { return kExoOu; }
  __device__ bool has_mid2() const { return false; }
};

// One env's process states past the price.
struct ProcState {
  float mid2, lam_b, lam_a, exo_b, exo_a, imp;
};

__device__ __forceinline__ ProcState proc_initial(const ProcParams& q) {
  return ProcState{q.mid2_initial, q.hawkes_base[0], q.hawkes_base[1], q.exo_initial[0], q.exo_initial[1],
                   q.impact_initial};
}

// Observation plane k (0-based, after cash, inventory, time and price) of
// the process states, in the carry order: the second midprice column, the
// two Hawkes intensities, the two exogenous depths, the impact state.
template <int kProc>
__device__ __forceinline__ float proc_plane(const ProcParams& q, const ProcState& s, int k) {
  const Kinds<kProc> kinds{q};
  if (kinds.has_mid2()) {
    if (k == 0) return s.mid2;
    --k;
  }
  if (kinds.arrival() == kArrHawkes) {
    if (k == 0) return s.lam_b;
    if (k == 1) return s.lam_a;
    k -= 2;
  }
  if (kinds.fill() == kFillExoMm) {
    if (k == 0) return s.exo_b;
    if (k == 1) return s.exo_a;
  }
  return s.imp;
}

// The fill probability at `depth` (pallas_rollout.py:959-988); `best` is
// the side's exogenous depth.
template <int kProc>
__device__ __forceinline__ float fill_probability(const ProcParams& q, float neg_k, float depth, float best) {
  switch (Kinds<kProc>{q}.fill()) {
    case kFillExoMm: return depth > best ? q.exo_base * expf(neg_k * (depth - best)) : 1.0f;
    case kFillTriangular: return fmaxf(1.0f - fmaxf(depth, 0.0f) / q.fill_param, 0.0f);
    case kFillPower: return 1.0f / (1.0f + powf(q.fill_param * fmaxf(depth, 0.0f), q.fill_k));
    default: return expf(neg_k * depth);
  }
}

// One exogenous best depth's step by its side's kind (pallas_rollout.py:991-1029).
template <int kProc>
__device__ __forceinline__ float exo_step(const ProcParams& q, int i, float x, float n) {
  switch (Kinds<kProc>{q}.exo(i)) {
    case kExoBm: return x + q.exo_drift_dt[i] + q.exo_vol_sqrt_dt[i] * n;
    case kExoGbm: return x + q.exo_level[i] * x * q.dt + q.exo_vol_sqrt_dt[i] * x * n;
    default: return x + q.exo_rev[i] * (x - q.exo_level[i]) + q.exo_vol_sqrt_dt[i] * n;
  }
}

// The new price by the midprice kind, advancing the second midprice column
// (pallas_rollout.py:1083-1134); the jump kinds react to the agent's own
// limit fills.
template <int kProc>
__device__ __forceinline__ float midprice_step(const ProcParams& q, float drift_dt, float vol_sqrt_dt, ProcState& s,
                                               float price, float n_mid, float n_mid2, float hit_bid, float hit_ask) {
  const float diffusion = vol_sqrt_dt * n_mid;
  switch (Kinds<kProc>{q}.midprice()) {
    case kMidHeston: {
      const float var = s.mid2;
      const float vol_t = sqrtf(fmaxf(var, 0.0f) * q.dt);
      const float w1 = q.mid2_corr * n_mid + q.mid2_corr_c * n_mid2;
      const float new_price = price + q.drift * price * q.dt + vol_t * price * n_mid;
      s.mid2 = fabsf(var + q.mid2_speed * (q.mid2_level - var) * q.dt + q.mid2_vol * vol_t * w1);
      return new_price;
    }
    case kMidStOu:
    case kMidStJump: {
      const float alpha = s.mid2;
      const float new_price = price + alpha * q.dt + diffusion;
      float new_alpha = alpha + q.mid2_rev * (alpha - q.mid2_level) + q.mid2_vol_sqrt_dt * n_mid2;
      if (q.midprice == kMidStJump) new_alpha = new_alpha + q.mid_jump * (hit_ask - hit_bid);
      s.mid2 = new_alpha;
      return new_price;
    }
    case kMidConstant: return price;
    case kMidBm: return price + drift_dt + diffusion;
    case kMidGbm: return price + q.drift * price * q.dt + price * diffusion;
    case kMidCev: return price + q.drift * price * q.dt + powf(price, q.mid_level) * diffusion;
    case kMidBmJump: return price + drift_dt + diffusion + q.mid_jump * (hit_ask - hit_bid);
    case kMidOuJump: return price + q.mid_rev * (price - q.mid_level) + diffusion + q.mid_jump * (hit_ask - hit_bid);
    default: return price + q.mid_rev * (price - q.mid_level) + diffusion;  // kMidOu
  }
}

// Speed dynamics: the impact at the pre-update state, advancing the impact
// state (pallas_rollout.py:1057-1076).
__device__ __forceinline__ float speed_impact(const ProcParams& q, float temporary, float permanent, ProcState& s,
                                              float speed) {
  const float imp = s.imp;
  switch (q.impact) {
    case kImpPower: return temporary * powf(speed, q.impact_exp);
    case kImpTempPerm:
      s.imp = imp + permanent * speed * q.dt;
      return temporary * speed + imp;
    default:
      s.imp = imp - q.impact_rho * imp * q.dt + q.impact_gamma * speed * q.dt;
      return q.impact == kImpTransient ? q.impact_kappa * imp : temporary * speed + q.impact_kappa * imp;
  }
}

struct MarketOut {
  float inv, cash, hit_bid, hit_ask;
};

// One step of the market-making dynamics kMarket with the process kinds of
// p.proc (pallas_rollout.py:992-1052): arrivals at the current intensity,
// the Hawkes step, the fill probabilities at the current exogenous depths,
// their step, the fills masked on the pre-step inventory, the bookkeeping.
// `exe` holds the executed action columns; `u` the arrival-bid, arrival-ask,
// fill-bid and fill-ask uniforms; `exo_n` the exogenous normals.  Returns
// the unclipped inventory and cash; advances `s`.  P is a kernel's params
// struct (p_arr_bid, p_arr_ask, neg_k, max_inventory, half_spread, mask_mo,
// proc).
template <int kMarket, int kProc, class P>
__device__ __forceinline__ MarketOut market_step(const P& p, ProcState& s, const float (&u)[4], float exo_nb,
                                                 float exo_na, const float* exe, float cash, float inv, float price) {
  const ProcParams& q = p.proc;
  const Kinds<kProc> kinds{q};
  float arr_bid, arr_ask;
  if (kinds.arrival() == kArrHawkes) {
    arr_bid = u[0] < s.lam_b * q.dt ? 1.0f : 0.0f;
    arr_ask = u[1] < s.lam_a * q.dt ? 1.0f : 0.0f;
    s.lam_b = s.lam_b + q.hawkes_mr * (q.hawkes_base[0] - s.lam_b) * q.dt + q.hawkes_jump * arr_bid;
    s.lam_a = s.lam_a + q.hawkes_mr * (q.hawkes_base[1] - s.lam_a) * q.dt + q.hawkes_jump * arr_ask;
  } else {
    arr_bid = u[0] < p.p_arr_bid ? 1.0f : 0.0f;
    arr_ask = u[1] < p.p_arr_ask ? 1.0f : 0.0f;
  }
  const float can_buy = inv < p.max_inventory ? 1.0f : 0.0f;
  const float can_sell = inv > -p.max_inventory ? 1.0f : 0.0f;
  MarketOut m;
  if constexpr (kMarket == kMarketTouch) {
    m.hit_bid = arr_bid * (exe[0] * can_buy);
    m.hit_ask = arr_ask * (exe[1] * can_sell);
    m.inv = inv + m.hit_bid - m.hit_ask;
    m.cash = cash - m.hit_bid * (price - p.half_spread) + m.hit_ask * (price + p.half_spread);
    return m;
  } else {
    const float bid = exe[0], ask = exe[1];
    const float pb = fill_probability<kProc>(q, p.neg_k, bid, s.exo_b);
    const float pa = fill_probability<kProc>(q, p.neg_k, ask, s.exo_a);
    if (kinds.fill() == kFillExoMm) {
      s.exo_b = exo_step<kProc>(q, 0, s.exo_b, exo_nb);
      s.exo_a = exo_step<kProc>(q, 1, s.exo_a, exo_na);
    }
    m.hit_bid = arr_bid * ((u[2] < pb ? 1.0f : 0.0f) * can_buy);
    m.hit_ask = arr_ask * ((u[3] < pa ? 1.0f : 0.0f) * can_sell);
    if constexpr (kMarket == kMarketLimit) {
      m.inv = inv + m.hit_bid - m.hit_ask;
      m.cash = cash - m.hit_bid * (price - bid) + m.hit_ask * (price + ask);
    } else {
      float mo_buy = exe[2] > 0.5f ? 1.0f : 0.0f;
      float mo_sell = exe[3] > 0.5f ? 1.0f : 0.0f;
      if (p.mask_mo) {
        mo_buy = mo_buy * can_buy;
        mo_sell = mo_sell * can_sell;
      }
      m.inv = inv + (mo_buy - mo_sell) + m.hit_bid - m.hit_ask;
      m.cash = cash + mo_sell * (price - p.half_spread) - mo_buy * (price + p.half_spread) -
               m.hit_bid * (price - bid) + m.hit_ask * (price + ask);
    }
    return m;
  }
}

}  // namespace mbt
