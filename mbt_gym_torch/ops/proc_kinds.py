"""The process kinds of the rollout kernels K3 and K5: the midprice,
arrival, fill and impact models beyond the plain one (BM midprice, linear
Poisson arrivals, exponential fills, temporary-and-permanent impact), as
``pallas_rollout.py:277-665`` reads them from a config and
``pallas_rollout.py:900-1140`` steps them.

- :func:`process_fields` gives the JAX ``MlpRolloutParams`` process fields
  of a dynamics object, with the same names, values and assertion texts;
- :class:`ProcParams` is their float32 step constants, shared by the plain
  versions and the kernels (``struct mbt::ProcParams`` in
  ``csrc/proc_kinds.cuh``), each float the float32 rounding of the double
  the JAX kernel forms from its Python floats;
- the plain step functions (:func:`market_step` with :func:`arrivals`,
  :func:`hawkes_update`, :func:`fill_probs` and :func:`exo_update`;
  :func:`midprice_update`, :func:`speed_impact`) repeat the JAX kernel's
  float32 operation order, as ``csrc/proc_kinds.cuh`` does.

Carry and observation order (pallas_rollout.py:724-754): price, then the
second midprice column (Heston variance or short-term alpha), the two
Hawkes intensities, the two exogenous best depths, the impact state.
Noise channels (pallas_rollout.py:98-111): 4 env uniforms, the eps normals
(none for the deterministic policies), the midprice normal, 2 exogenous
normals, 1 second-midprice normal.
"""
from __future__ import annotations

import ctypes
import math

import torch

MIDPRICE_KINDS = ("bm", "constant", "gbm", "ou", "cev", "bmjump", "oujump", "heston", "st_ou_alpha",
                  "st_jump_alpha")
ARRIVAL_KINDS = ("poisson", "poisson_nl", "hawkes")
FILL_KINDS = ("exp", "triangular", "power", "exomm")
EXO_KINDS = ("ou", "bm", "gbm")
IMPACT_KINDS = ("temp_perm", "power", "transient", "temp_transient")
MID2_KINDS = ("heston", "st_ou_alpha", "st_jump_alpha")
# speed dynamics have no fills for a midprice jump to react to
SPEED_MIDPRICE_KINDS = ("constant", "bm", "gbm", "ou", "cev", "heston", "st_ou_alpha")

_NO_MID2 = dict(mid2_initial=0.0, mid2_level=0.0, mid2_speed=0.0, mid2_vol=0.0, mid2_dt_scaled=False,
                mid2_corr=0.0)
NO_EXO = dict(exo_kind=(), exo_level=(), exo_speed=(), exo_vol=(), exo_initial=(), exo_dt_scaled=(),
              exo_base_fill=1.0)


def _midprice(m) -> dict:
    from mbt_gym_torch.processes import midprice as mp

    def out(kind, drift, vol, s0, level=0.0, speed=0.0, scaled=False, jump=0.0, **mid2):
        return dict(midprice_kind=kind, drift=drift, volatility=vol, initial_price=s0, mid_level=float(level),
                    mid_speed=float(speed), mid_dt_scaled=bool(scaled), mid_jump=float(jump),
                    **(mid2 or _NO_MID2))

    def inner(ou, corr=0.0):
        return dict(mid2_initial=float(ou.initial_price), mid2_level=float(ou.mean_reversion_level),
                    mid2_speed=float(ou.mean_reversion_speed), mid2_vol=float(ou.volatility),
                    mid2_dt_scaled=bool(ou.dt_scaled_drift), mid2_corr=corr)

    if isinstance(m, mp.HestonMidprice):
        return out("heston", m.drift, 0.0, m.initial_price, mid2_initial=float(m.initial_variance),
                   mid2_level=float(m.volatility_mean_reversion_level),
                   mid2_speed=float(m.volatility_mean_reversion_rate), mid2_vol=float(m.volatility_of_volatility),
                   mid2_dt_scaled=False, mid2_corr=float(m.weiner_correlation))
    if isinstance(m, mp.ShortTermOuAlphaMidprice):
        return out("st_ou_alpha", 0.0, m.volatility, m.initial_price, **inner(m.ou))
    if isinstance(m, mp.ShortTermJumpAlphaMidprice):
        return out("st_jump_alpha", 0.0, m.volatility, m.initial_price, jump=m.ou_jump.jump_size,
                   **inner(m.ou_jump))
    if isinstance(m, mp.ConstantMidprice):
        return out("constant", 0.0, 0.0, m.initial_price)
    if isinstance(m, mp.BrownianMotionJumpMidprice):
        return out("bmjump", m.drift, m.volatility, m.initial_price, jump=m.jump_size)
    if isinstance(m, mp.OuJumpMidprice):
        return out("oujump", 0.0, m.volatility, m.initial_price, m.mean_reversion_level, m.mean_reversion_speed,
                   m.dt_scaled_drift, m.jump_size)
    if isinstance(m, mp.OuMidprice):
        return out("ou", 0.0, m.volatility, m.initial_price, m.mean_reversion_level, m.mean_reversion_speed,
                   m.dt_scaled_drift)
    if isinstance(m, mp.CevMidprice):  # the elasticity gamma travels in mid_level
        return out("cev", m.drift, m.volatility, m.initial_price, m.gamma)
    if isinstance(m, mp.GeometricBrownianMotionMidprice):
        return out("gbm", m.drift, m.volatility, m.initial_price)
    assert isinstance(m, mp.BrownianMotionMidprice), (
        f"fused rollout midprice: all ten reference models are supported (constant/BM/GBM/OU/CEV/jump "
        f"variants/short-term alphas/Heston); got unrecognised {m}"
    )
    return out("bm", m.drift, m.volatility, m.initial_price)


def _arrivals(m) -> dict:
    from mbt_gym_torch.processes import arrivals as ar

    if isinstance(m, ar.HawkesArrivals):
        kind, rates = "hawkes", m.baseline_arrival_rate
        jump, mr = m.jump_size, m.mean_reversion_speed
    elif isinstance(m, ar.PoissonArrivalsNonLinear):
        kind, rates, jump, mr = "poisson_nl", m.intensity, 0.0, 0.0
    else:
        assert isinstance(m, ar.PoissonArrivals), (
            f"fused rollout arrivals: Poisson (linear or exact-probability) or Hawkes only; got {m}"
        )
        kind, rates, jump, mr = "poisson", m.intensity, 0.0, 0.0
    return dict(arrival_kind=kind, intensity_bid=rates[0], intensity_ask=rates[1], hawkes_jump=float(jump),
                hawkes_mean_reversion=float(mr))


def _fills(m) -> dict:
    from mbt_gym_torch.processes import fills as fl
    from mbt_gym_torch.processes import midprice as mp

    strict = "strict_reference_bug fills are an engine-path compat feature"
    if isinstance(m, fl.TriangularFill):
        assert not m.strict_reference_bug, strict
        return dict(fill_kind="triangular", fill_exponent=0.0, fill_param=float(m.max_fill_depth), **NO_EXO)
    if isinstance(m, fl.PowerFill):
        assert not m.strict_reference_bug, strict
        return dict(fill_kind="power", fill_exponent=m.fill_exponent, fill_param=float(m.fill_multiplier), **NO_EXO)
    if isinstance(m, fl.ExogenousMmFill):
        assert not m.strict_reference_bug, strict

        def side(q):
            if isinstance(q, mp.OuMidprice):
                return ("ou", q.mean_reversion_level, q.mean_reversion_speed, q.volatility, q.initial_price,
                        bool(q.dt_scaled_drift))
            if isinstance(q, mp.BrownianMotionMidprice):
                return "bm", q.drift, 0.0, q.volatility, q.initial_price, True
            if isinstance(q, mp.GeometricBrownianMotionMidprice):
                return "gbm", q.drift, 0.0, q.volatility, q.initial_price, True
            raise AssertionError(
                "fused rollout (exomm fills): Ou/BrownianMotion/GeometricBrownianMotion best-depth processes "
                f"only; got {q} (multi-state inner processes run on the engine)"
            )

        sides = list(zip(side(m.bid_process), side(m.ask_process)))
        return dict(fill_kind="exomm", fill_exponent=m.fill_exponent, fill_param=0.0,
                    exo_kind=tuple(str(x) for x in sides[0]), exo_level=tuple(float(x) for x in sides[1]),
                    exo_speed=tuple(float(x) for x in sides[2]), exo_vol=tuple(float(x) for x in sides[3]),
                    exo_initial=tuple(float(x) for x in sides[4]), exo_dt_scaled=tuple(bool(x) for x in sides[5]),
                    exo_base_fill=float(m.base_fill_probability))
    assert isinstance(m, fl.ExponentialFill), (
        f"fused rollout fills: Exponential / Triangular / Power / ExogenousMm only; got {m}"
    )
    return dict(fill_kind="exp", fill_exponent=m.fill_exponent, fill_param=0.0, **NO_EXO)


def _impact(im) -> dict:
    from mbt_gym_torch.processes import impact as ip

    out = dict(impact_kind="temp_perm", impact_exponent=1.0, impact_kappa=0.0, impact_rho=0.0, impact_gamma=0.0,
               impact_initial=0.0, temporary_impact=0.0, permanent_impact=0.0)
    if isinstance(im, ip.TemporaryAndPermanentImpact):
        out.update(temporary_impact=im.temporary_impact_coefficient, permanent_impact=im.permanent_impact_coefficient)
    elif isinstance(im, ip.TemporaryPowerImpact):
        out.update(impact_kind="power", temporary_impact=im.temporary_impact_coefficient,
                   impact_exponent=float(im.temporary_impact_exponent))
    elif isinstance(im, (ip.TemporaryAndTransientImpact, ip.TransientImpact)):
        temporary = isinstance(im, ip.TemporaryAndTransientImpact)
        out.update(impact_kind="temp_transient" if temporary else "transient",
                   temporary_impact=im.temporary_impact_coefficient if temporary else 0.0,
                   impact_kappa=float(im.transient_impact_coefficient), impact_rho=float(im.resilience_coefficient),
                   impact_gamma=float(im.linear_kernel_coefficient),
                   impact_initial=float(im.initial_transient_impact))
    else:
        raise AssertionError(f"fused rollout (speed dynamics): unsupported impact model {im}")
    return out


def process_fields(d, dynamics_kind: str) -> dict:
    """The JAX ``MlpRolloutParams`` process fields of dynamics ``d`` of
    kind ``dynamics_kind`` (pallas_rollout.py:314-565): the midprice
    kind and its constants; on the market-making kinds the arrival kind
    and (limit, lam) the fill kind; on speed the impact kind."""
    out = _midprice(d.midprice_model)
    out.update(arrival_kind="poisson", intensity_bid=0.0, intensity_ask=0.0, hawkes_jump=0.0,
               hawkes_mean_reversion=0.0, fill_kind="exp", fill_exponent=0.0, fill_param=0.0, **NO_EXO)
    if dynamics_kind == "speed":
        assert out["midprice_kind"] in SPEED_MIDPRICE_KINDS, (
            "fused rollout (speed dynamics): fill-driven midprice jumps have no fills to react to (the "
            "reference crashes there too, midprice_models.py:220)"
        )
        out.update(_impact(d.price_impact_model))
        return out
    out.update(_arrivals(d.arrival_model))
    if dynamics_kind != "touch":
        out.update(_fills(d.fill_probability_model))
    return out


def has_mid2(p) -> bool:
    return p.midprice_kind in MID2_KINDS


def is_plain(p) -> bool:
    """Whether ``p``'s processes are the plain ones (BM, linear Poisson,
    exponential fills, temporary-and-permanent impact): the kernels'
    original instantiations."""
    return (p.midprice_kind, p.arrival_kind, p.fill_kind, getattr(p, "impact_kind", "temp_perm")) == (
        "bm", "poisson", "exp", "temp_perm")


# The instantiation a call runs (mbt::ProcMode in csrc/proc_kinds.cuh): the
# plain processes' original one, the general one (the kinds read at run
# time), or the composite stress family's (its kinds fixed at compile time).
PROC_PLAIN, PROC_GENERAL, PROC_COMPOSITE = 0, 1, 2


def is_composite(p) -> bool:
    """Whether ``p``'s processes are the composite stress family's: BM
    midprice, Hawkes arrivals, exogenous-MM fills with OU sides
    (``composite_env_config``)."""
    return (p.midprice_kind, p.arrival_kind, p.fill_kind, tuple(p.exo_kind)) == ("bm", "hawkes", "exomm", ("ou", "ou"))


def proc_mode(p, composite_ok: bool) -> int:
    """The instantiation ``p`` runs: PROC_PLAIN on the plain processes,
    PROC_COMPOSITE on the composite family where the kernel has that
    instantiation (``composite_ok``), else PROC_GENERAL."""
    if is_plain(p):
        return PROC_PLAIN
    return PROC_COMPOSITE if composite_ok and is_composite(p) else PROC_GENERAL


def extra_channels(p) -> int:
    """Noise channels past the midprice normal: 2 exogenous normals, 1
    second-midprice normal."""
    return (2 if p.fill_kind == "exomm" else 0) + (1 if has_mid2(p) else 0)


def state_planes(p, speed: bool) -> tuple:
    """Names of the carry planes after (cash, inventory, price), in order."""
    names = ("mid2",) if has_mid2(p) else ()
    if p.arrival_kind == "hawkes":
        names += ("lam_b", "lam_a")
    if p.fill_kind == "exomm":
        names += ("exo_b", "exo_a")
    if speed and getattr(p, "impact_kind", "temp_perm") != "power":
        names += ("imp",)
    return names


# ------------------------------------------------------------ constants
class ProcParams(ctypes.Structure):
    """float32 step constants of the process kinds (``struct
    mbt::ProcParams`` in ``csrc/proc_kinds.cuh``)."""

    _fields_ = [
        ("midprice", ctypes.c_int),
        ("arrival", ctypes.c_int),
        ("fill", ctypes.c_int),
        ("impact", ctypes.c_int),
        ("has_mid2", ctypes.c_int),
        ("channels", ctypes.c_int),  # noise-mode channels per step
        ("ch_exo", ctypes.c_int),    # the first exogenous normal's channel (-1: none)
        ("ch_mid2", ctypes.c_int),   # the second-midprice normal's channel (-1: none)
        ("dt", ctypes.c_float),
        ("drift", ctypes.c_float),        # gbm, cev, heston: drift
        ("mid_rev", ctypes.c_float),      # ou, oujump: -speed * (dt if dt-scaled else 1)
        ("mid_level", ctypes.c_float),    # ou, oujump: level; cev: gamma
        ("mid_jump", ctypes.c_float),
        ("mid2_initial", ctypes.c_float),
        ("mid2_level", ctypes.c_float),
        ("mid2_speed", ctypes.c_float),   # heston: the variance's mean-reversion rate
        ("mid2_vol", ctypes.c_float),     # heston: vol of vol
        ("mid2_rev", ctypes.c_float),     # alphas: -speed * (dt if dt-scaled else 1)
        ("mid2_vol_sqrt_dt", ctypes.c_float),
        ("mid2_corr", ctypes.c_float),
        ("mid2_corr_c", ctypes.c_float),  # sqrt(1 - corr^2)
        ("hawkes_base", ctypes.c_float * 2),
        ("hawkes_mr", ctypes.c_float),
        ("hawkes_jump", ctypes.c_float),
        ("fill_param", ctypes.c_float),   # triangular: max depth; power: multiplier
        ("fill_k", ctypes.c_float),       # power: exponent
        ("exo_base", ctypes.c_float),
        ("exo_kind", ctypes.c_int * 2),
        ("exo_level", ctypes.c_float * 2),
        ("exo_rev", ctypes.c_float * 2),  # ou: -speed * (dt if dt-scaled else 1)
        ("exo_drift_dt", ctypes.c_float * 2),  # bm: drift * dt
        ("exo_vol_sqrt_dt", ctypes.c_float * 2),
        ("exo_initial", ctypes.c_float * 2),
        ("impact_exp", ctypes.c_float),
        ("impact_kappa", ctypes.c_float),
        ("impact_rho", ctypes.c_float),
        ("impact_gamma", ctypes.c_float),
        ("impact_initial", ctypes.c_float),
    ]


def proc_params(p, n_eps: int) -> ProcParams:
    """The step constants of ``p``'s process kinds; ``n_eps`` policy
    normals precede the midprice normal in the noise channels."""
    dt = p.dt
    sq = math.sqrt(dt)
    exomm = p.fill_kind == "exomm"
    mid2 = has_mid2(p)
    ch_mid = 4 + n_eps
    exo = [(EXO_KINDS.index(p.exo_kind[i]), p.exo_level[i],
            -p.exo_speed[i] * (dt if p.exo_dt_scaled[i] else 1.0), p.exo_level[i] * dt, p.exo_vol[i] * sq,
            p.exo_initial[i]) for i in range(2)] if exomm else [(0, 0.0, 0.0, 0.0, 0.0, 0.0)] * 2
    ints = ctypes.c_int * 2
    floats = ctypes.c_float * 2
    heston = p.midprice_kind == "heston"
    return ProcParams(
        midprice=MIDPRICE_KINDS.index(p.midprice_kind),
        arrival=ARRIVAL_KINDS.index(p.arrival_kind),
        fill=FILL_KINDS.index(p.fill_kind),
        impact=IMPACT_KINDS.index(getattr(p, "impact_kind", "temp_perm")),
        has_mid2=int(mid2),
        channels=ch_mid + 1 + extra_channels(p),
        ch_exo=ch_mid + 1 if exomm else -1,
        ch_mid2=ch_mid + 1 + (2 if exomm else 0) if mid2 else -1,
        dt=dt,
        drift=p.drift,
        mid_rev=-p.mid_speed * (dt if p.mid_dt_scaled else 1.0),
        mid_level=p.mid_level,
        mid_jump=p.mid_jump,
        mid2_initial=p.mid2_initial,
        mid2_level=p.mid2_level,
        mid2_speed=p.mid2_speed,
        mid2_vol=p.mid2_vol,
        mid2_rev=0.0 if heston else -p.mid2_speed * (dt if p.mid2_dt_scaled else 1.0),
        mid2_vol_sqrt_dt=p.mid2_vol * sq,
        mid2_corr=p.mid2_corr,
        mid2_corr_c=math.sqrt(1.0 - p.mid2_corr**2),
        hawkes_base=floats(p.intensity_bid, p.intensity_ask),
        hawkes_mr=p.hawkes_mean_reversion,
        hawkes_jump=p.hawkes_jump,
        fill_param=p.fill_param,
        fill_k=p.fill_exponent,
        exo_base=p.exo_base_fill,
        exo_kind=ints(*(e[0] for e in exo)),
        exo_level=floats(*(e[1] for e in exo)),
        exo_rev=floats(*(e[2] for e in exo)),
        exo_drift_dt=floats(*(e[3] for e in exo)),
        exo_vol_sqrt_dt=floats(*(e[4] for e in exo)),
        exo_initial=floats(*(e[5] for e in exo)),
        impact_exp=getattr(p, "impact_exponent", 1.0),
        impact_kappa=getattr(p, "impact_kappa", 0.0),
        impact_rho=getattr(p, "impact_rho", 0.0),
        impact_gamma=getattr(p, "impact_gamma", 0.0),
        impact_initial=getattr(p, "impact_initial", 0.0),
    )


def arrival_probability(p) -> tuple:
    """The (bid, ask) per-step arrival probabilities of the Poisson kinds,
    in double (the kernels round them to float32): ``intensity * dt``, or
    ``1 - exp(-intensity * dt)`` for the exact-probability kind
    (arrival_models.py:81-83)."""
    if p.arrival_kind == "poisson_nl":
        return 1.0 - math.exp(-p.intensity_bid * p.dt), 1.0 - math.exp(-p.intensity_ask * p.dt)
    return p.intensity_bid * p.dt, p.intensity_ask * p.dt


# ------------------------------------------------------------ plain steps
def initial_planes(pp: ProcParams, names, like: torch.Tensor) -> dict:
    """The carry planes ``names`` at the start of an episode."""
    start = {"mid2": pp.mid2_initial, "lam_b": pp.hawkes_base[0], "lam_a": pp.hawkes_base[1],
             "exo_b": pp.exo_initial[0], "exo_a": pp.exo_initial[1], "imp": pp.impact_initial}
    return {name: torch.full_like(like, start[name]) for name in names}


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """``x ** e`` through a tensor exponent: torch special-cases some
    scalar exponents (0.5 as a square root, 2 and 3 as products), the
    kernels call powf."""
    return torch.pow(x, torch.full_like(x, e))


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, the kernels divide
    return x / torch.full_like(x, c)


def arrivals(pp: ProcParams, kp, s: dict, u_ab, u_aa):
    """(arr_bid, arr_ask): thinning at the current Hawkes intensity, or at
    the Poisson kinds' probabilities ``kp.p_arr_bid``/``kp.p_arr_ask``."""
    f32 = torch.float32
    if ARRIVAL_KINDS[pp.arrival] == "hawkes":
        return (u_ab < s["lam_b"] * pp.dt).to(f32), (u_aa < s["lam_a"] * pp.dt).to(f32)
    return (u_ab < kp.p_arr_bid).to(f32), (u_aa < kp.p_arr_ask).to(f32)


def hawkes_update(pp: ProcParams, s: dict, arr_bid, arr_ask) -> None:
    """Mean reversion to the baseline plus the self-excitation
    (pallas_rollout.py:949-956), in place in ``s``."""
    if ARRIVAL_KINDS[pp.arrival] != "hawkes":
        return
    for name, base, arr in (("lam_b", pp.hawkes_base[0], arr_bid), ("lam_a", pp.hawkes_base[1], arr_ask)):
        lam = s[name]
        s[name] = lam + pp.hawkes_mr * (base - lam) * pp.dt + pp.hawkes_jump * arr


def fill_probs(pp: ProcParams, kp, s: dict, bid, ask):
    """The fill probabilities at the quoted depths and the current
    exogenous depths (pallas_rollout.py:959-988)."""
    kind = FILL_KINDS[pp.fill]
    if kind == "exomm":
        def side(d, best):
            return torch.where(d > best, pp.exo_base * torch.exp(kp.neg_k * (d - best)), torch.ones_like(d))

        return side(bid, s["exo_b"]), side(ask, s["exo_a"])
    if kind == "triangular":
        return tuple(torch.clamp(1.0 - _div(torch.clamp(d, min=0.0), pp.fill_param), min=0.0) for d in (bid, ask))
    if kind == "power":
        return tuple(1.0 / (1.0 + _pow(pp.fill_param * torch.clamp(d, min=0.0), pp.fill_k)) for d in (bid, ask))
    return torch.exp(kp.neg_k * bid), torch.exp(kp.neg_k * ask)


def exo_update(pp: ProcParams, s: dict, n_bid, n_ask) -> None:
    """The exogenous best depths' step, each side by its kind
    (pallas_rollout.py:991-1029), in place in ``s``."""
    if FILL_KINDS[pp.fill] != "exomm":
        return
    for i, (name, n) in enumerate((("exo_b", n_bid), ("exo_a", n_ask))):
        x = s[name]
        kind = EXO_KINDS[pp.exo_kind[i]]
        if kind == "bm":
            s[name] = x + pp.exo_drift_dt[i] + pp.exo_vol_sqrt_dt[i] * n
        elif kind == "gbm":
            s[name] = x + pp.exo_level[i] * x * pp.dt + pp.exo_vol_sqrt_dt[i] * x * n
        else:
            s[name] = x + pp.exo_rev[i] * (x - pp.exo_level[i]) + pp.exo_vol_sqrt_dt[i] * n


def midprice_update(pp: ProcParams, kp, s: dict, price, n_mid, n_mid2, hit_bid, hit_ask):
    """The new price (and, in place in ``s``, the second midprice column)
    by the midprice kind (pallas_rollout.py:1083-1134); the jump kinds
    react to the agent's own limit fills."""
    kind = MIDPRICE_KINDS[pp.midprice]
    diffusion = kp.vol_sqrt_dt * n_mid
    if kind == "heston":
        var = s["mid2"]
        vol_t = torch.sqrt(torch.clamp(var, min=0.0) * pp.dt)
        w1 = pp.mid2_corr * n_mid + pp.mid2_corr_c * n_mid2
        new_price = price + pp.drift * price * pp.dt + vol_t * price * n_mid
        s["mid2"] = torch.abs(var + pp.mid2_speed * (pp.mid2_level - var) * pp.dt + pp.mid2_vol * vol_t * w1)
        return new_price
    if kind in ("st_ou_alpha", "st_jump_alpha"):
        alpha = s["mid2"]
        new_price = price + alpha * pp.dt + diffusion
        new_alpha = alpha + pp.mid2_rev * (alpha - pp.mid2_level) + pp.mid2_vol_sqrt_dt * n_mid2
        if kind == "st_jump_alpha":
            new_alpha = new_alpha + pp.mid_jump * (hit_ask - hit_bid)
        s["mid2"] = new_alpha
        return new_price
    if kind == "constant":
        return price
    if kind == "bm":
        return price + kp.drift_dt + diffusion
    if kind == "gbm":
        return price + pp.drift * price * pp.dt + price * diffusion
    if kind == "cev":
        return price + pp.drift * price * pp.dt + _pow(price, pp.mid_level) * diffusion
    if kind == "bmjump":
        new_price = price + kp.drift_dt + diffusion
    else:
        new_price = price + pp.mid_rev * (price - pp.mid_level) + diffusion
    if kind in ("bmjump", "oujump"):
        new_price = new_price + pp.mid_jump * (hit_ask - hit_bid)
    return new_price


def speed_impact(pp: ProcParams, kp, s: dict, speed):
    """The impact at the pre-update state and, in place in ``s``, the
    impact state's step (pallas_rollout.py:1057-1076)."""
    kind = IMPACT_KINDS[pp.impact]
    if kind == "power":
        return kp.temporary_impact * _pow(speed, pp.impact_exp)
    imp = s["imp"]
    if kind == "temp_perm":
        s["imp"] = imp + kp.permanent_impact * speed * pp.dt
        return kp.temporary_impact * speed + imp
    s["imp"] = imp - pp.impact_rho * imp * pp.dt + pp.impact_gamma * speed * pp.dt
    if kind == "transient":
        return pp.impact_kappa * imp
    return kp.temporary_impact * speed + pp.impact_kappa * imp


def market_step(kind: str, kp, pp: ProcParams, s: dict, d, exe, cash, inv, price):
    """One step of the market-making dynamics ``kind`` with the process
    kinds of ``pp`` (pallas_rollout.py:992-1052): arrivals at the current
    intensity, then the Hawkes step, the fill probabilities at the current
    exogenous depths, then their step, the fills masked on the pre-step
    inventory, the bookkeeping.  ``d`` is the step's channels.  Returns
    the unclipped ``(inventory, cash)`` and the (hit_bid, hit_ask) fills;
    advances ``s`` in place."""
    f32 = torch.float32
    arr_bid, arr_ask = arrivals(pp, kp, s, d[0], d[1])
    hawkes_update(pp, s, arr_bid, arr_ask)
    can_buy = (inv < kp.max_inventory).to(f32)
    can_sell = (inv > -kp.max_inventory).to(f32)
    if kind == "touch":
        hit_bid = arr_bid * (exe[0] * can_buy)
        hit_ask = arr_ask * (exe[1] * can_sell)
        new_cash = cash - hit_bid * (price - kp.half_spread) + hit_ask * (price + kp.half_spread)
        return inv + hit_bid - hit_ask, new_cash, hit_bid, hit_ask
    bid, ask = exe[0], exe[1]
    pb, pa = fill_probs(pp, kp, s, bid, ask)
    if pp.ch_exo >= 0:
        exo_update(pp, s, d[pp.ch_exo], d[pp.ch_exo + 1])
    hit_bid = arr_bid * ((d[2] < pb).to(f32) * can_buy)
    hit_ask = arr_ask * ((d[3] < pa).to(f32) * can_sell)
    if kind == "limit":
        return inv + hit_bid - hit_ask, cash - hit_bid * (price - bid) + hit_ask * (price + ask), hit_bid, hit_ask
    mo_buy = (exe[2] > 0.5).to(f32)
    mo_sell = (exe[3] > 0.5).to(f32)
    if kp.mask_mo:
        mo_buy = mo_buy * can_buy
        mo_sell = mo_sell * can_sell
    new_cash = (cash + mo_sell * (price - kp.half_spread) - mo_buy * (price + kp.half_spread)
                - hit_bid * (price - bid) + hit_ask * (price + ask))
    return inv + (mo_buy - mo_sell) + hit_bid - hit_ask, new_cash, hit_bid, hit_ask


def philox_extras(seed: int, run_steps: int, n: int, device, counter: int, words: str) -> list:
    """The native draws of the extra normals, ``[exo_bid, exo_ask, mid2]``
    as ``(run_steps, N)`` float32 each: Box-Muller on Philox4x32-10 keyed
    by ``(seed, env)`` at counter ``(step, counter)``.  ``words="zw"``
    (K5, counter 1, whose first two words give the midprice normal): the
    pair (r0, theta0) of words x, y gives exo_bid = r0 sin theta0, the pair
    (r1, theta1) of words z, w exo_ask = r1 cos theta1 and mid2 = r1 sin
    theta1.  ``words="xy"`` (K3, counter 3, a call of its own) gives
    exo_ask and mid2 from its words x, y the same way, exo_bid being K3's
    spare sine of its counter-1 pair (computed by the caller)."""
    from mbt_gym_torch.ops.episode import _philox_draw, _uniform24

    b = _philox_draw(seed, run_steps, n, counter, device)

    def pair(w_r, w_t):
        r = torch.sqrt(-2.0 * torch.log(1.0 - _uniform24(b[w_r])))
        th = (2.0 * math.pi) * _uniform24(b[w_t])
        return r * torch.cos(th), r * torch.sin(th)

    if words == "zw":
        _, exo_bid = pair(0, 1)
        exo_ask, mid2 = pair(2, 3)
        return [exo_bid, exo_ask, mid2]
    exo_ask, mid2 = pair(0, 1)
    return [None, exo_ask, mid2]
