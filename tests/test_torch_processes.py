"""Every stochastic-process class of mbt_gym_torch against its JAX
counterpart on the CPU: the static contract (initial state, bounds, noise
spec, max depth, max speed) and every step function (update, arrivals,
fill probabilities and fills, impact) on the same float64 inputs and
noise, made from a numpy seed, at the golden tolerances of
tests/test_golden.py; then tests/test_composition_fuzz.py's 20 random
compositions, with the port's engine rollout held against the JAX
engine's on the same injected noise."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import mbt_gym_tpu.processes as jp
from mbt_gym_tpu.agents.baseline import fixed_action_policy as jax_fixed_action_policy
from mbt_gym_tpu.dynamics import (
    AtTheTouchDynamics,
    LimitAndMarketOrderDynamics,
    LimitOrderDynamics,
    TradingWithSpeedDynamics,
)
from mbt_gym_tpu.env import EnvConfig
from mbt_gym_tpu.rewards import CjMmCriterion, CjOeCriterion, ExponentialUtility, PnL, RunningInventoryPenalty
from mbt_gym_tpu.rollout import rollout as jax_rollout
from mbt_gym_tpu.types import SlotNoise as JaxSlotNoise

import mbt_gym_torch.processes as tp
from mbt_gym_torch import convert
from mbt_gym_torch.agents.baseline import fixed_action_policy
from mbt_gym_torch.rollout import rollout
from mbt_gym_torch.types import SlotNoise
from tests.test_torch_env import jax_spec, torch_config

N = 64
DT = 0.005
ATOL = 1e-12  # tests/test_golden.py: prices to 1e-12 in float64

_OU_SIDE = jp.OuMidprice(initial_price=0.8, mean_reversion_level=0.8, volatility=0.1, dt_scaled_drift=True)

CASES = {
    "ProcessBase": jp.ProcessBase(),
    "ConstantMidprice": jp.ConstantMidprice(initial_price=101.0),
    "BrownianMotionMidprice": jp.BrownianMotionMidprice(drift=0.3),
    "GeometricBrownianMotionMidprice": jp.GeometricBrownianMotionMidprice(drift=0.2),
    "GeometricBrownianMotionMidprice-negative-drift": jp.GeometricBrownianMotionMidprice(drift=-2.0),
    "OuMidprice": jp.OuMidprice(mean_reversion_level=99.0, mean_reversion_speed=0.3),
    "OuMidprice-dt-scaled": jp.OuMidprice(mean_reversion_level=99.0, dt_scaled_drift=True),
    "ShortTermOuAlphaMidprice": jp.ShortTermOuAlphaMidprice(ou=jp.OuMidprice(initial_price=0.1, volatility=0.5)),
    "ShortTermOuAlphaMidprice-dt-scaled": jp.ShortTermOuAlphaMidprice(
        ou=jp.OuMidprice(initial_price=0.0, dt_scaled_drift=True)),
    "BrownianMotionJumpMidprice": jp.BrownianMotionJumpMidprice(jump_size=0.5),
    "OuJumpMidprice": jp.OuJumpMidprice(mean_reversion_level=100.0, jump_size=0.7),
    "OuJumpMidprice-dt-scaled": jp.OuJumpMidprice(dt_scaled_drift=True),
    "ShortTermJumpAlphaMidprice": jp.ShortTermJumpAlphaMidprice(
        ou_jump=jp.OuJumpMidprice(initial_price=0.0, jump_size=0.3)),
    "HestonMidprice": jp.HestonMidprice(),
    "HestonMidprice-positive-correlation": jp.HestonMidprice(weiner_correlation=0.3, initial_variance=0.09),
    "CevMidprice": jp.CevMidprice(gamma=0.9),
    "PoissonArrivals": jp.PoissonArrivals((120.0, 90.0)),
    "PoissonArrivalsNonLinear": jp.PoissonArrivalsNonLinear((120.0, 90.0)),
    "HawkesArrivals": jp.HawkesArrivals(baseline_arrival_rate=(10.0, 14.0)),
    "ExponentialFill": jp.ExponentialFill(fill_exponent=1.2),
    "TriangularFill": jp.TriangularFill(max_fill_depth=1.3),
    "TriangularFill-strict": jp.TriangularFill(max_fill_depth=1.3, strict_reference_bug=True),
    "PowerFill": jp.PowerFill(fill_exponent=1.7, fill_multiplier=1.2),
    "PowerFill-strict": jp.PowerFill(strict_reference_bug=True),
    "ExogenousMmFill": jp.ExogenousMmFill(bid_process=_OU_SIDE, ask_process=_OU_SIDE, base_fill_probability=0.8),
    "ExogenousMmFill-strict": jp.ExogenousMmFill(bid_process=_OU_SIDE, ask_process=_OU_SIDE,
                                                 strict_reference_bug=True),
    "ExogenousMmFill-bm-gbm": jp.ExogenousMmFill(
        bid_process=jp.BrownianMotionMidprice(initial_price=0.7, volatility=0.2, drift=0.1),
        ask_process=jp.GeometricBrownianMotionMidprice(initial_price=0.9, volatility=0.2)),
    "ExogenousMmFill-heston-sides": jp.ExogenousMmFill(
        bid_process=jp.HestonMidprice(initial_price=0.8), ask_process=jp.ShortTermOuAlphaMidprice(initial_price=0.6)),
    "TemporaryPowerImpact": jp.TemporaryPowerImpact(temporary_impact_exponent=0.5),
    "TemporaryAndPermanentImpact": jp.TemporaryAndPermanentImpact(permanent_impact_coefficient=0.02),
    "TemporaryAndTransientImpact": jp.TemporaryAndTransientImpact(resilience_coefficient=0.5),
    "TransientImpact": jp.TransientImpact(linear_kernel_coefficient=0.3),
}


def _port(obj):
    if type(obj) is jp.ProcessBase:
        return tp.ProcessBase()
    return convert._component(jax_spec(obj))


def _inputs(proc, seed):
    """float64 state (the initial state, perturbed), arrivals, fills,
    speeds, depths and noise columns, from a numpy seed."""
    rng = np.random.default_rng(seed)
    with enable_x64():
        state = np.asarray(proc.initial_state(N, jnp.float64))
    state = state * (1.0 + 0.1 * rng.normal(size=state.shape)) + 0.01 * rng.normal(size=state.shape)
    n_norm, n_unif = proc.noise_spec()
    return dict(
        state=state,
        arrivals=(rng.uniform(size=(N, 2)) < 0.5).astype(np.float64),
        fills=(rng.uniform(size=(N, 2)) < 0.5).astype(np.float64),
        action=rng.uniform(0.0, 3.0, size=(N, 1)),
        depths=rng.uniform(-0.5, 2.5, size=(N, 2)),
        normal=rng.normal(size=(N, n_norm)) if n_norm else None,
        uniform=rng.uniform(size=(N, n_unif)) if n_unif else None,
    )


def _both(jproc, proc, method, x, *args):
    """``method`` of the JAX process in float64 and of the port's on the
    same arrays (args naming keys of ``x``; None passes through)."""
    def arg(cls, name, lib):
        if name is None:
            return None
        if name == "noise":
            return cls(*(None if x[k] is None else lib(x[k]) for k in ("normal", "uniform")))
        if name == "dt":
            return DT
        return None if x[name] is None else lib(x[name])

    with enable_x64():
        want = np.asarray(getattr(jproc, method)(*(arg(JaxSlotNoise, a, jnp.asarray) for a in args)))
    got = getattr(proc, method)(*(arg(SlotNoise, a, torch.from_numpy) for a in args))
    return got.numpy(), want


@pytest.mark.parametrize("name", list(CASES))
def test_process_matches_jax(name):
    jproc = CASES[name]
    proc = _port(jproc)
    assert type(proc).__name__ == type(jproc).__name__
    assert proc.state_dim == jproc.state_dim
    assert proc.noise_spec() == jproc.noise_spec()
    assert proc.bounds() == jproc.bounds()
    for prop in ("max_depth", "max_speed"):
        assert getattr(proc, prop, None) == getattr(jproc, prop, None), prop
    with enable_x64():
        want0 = np.asarray(jproc.initial_state(N, jnp.float64))
    got0 = proc.initial_state(N, torch.float64, "cpu")
    assert got0.dtype == torch.float64
    np.testing.assert_array_equal(got0.numpy(), want0)

    x = _inputs(jproc, seed=len(name))
    checks = [("update", ("state", "arrivals", "fills", "action", "noise", "dt"))]
    if name.endswith("Midprice") or "Midprice-" in name:
        # fill-less dynamics (trading speed): the jump term is 0
        checks.append(("update", ("state", None, None, "action", "noise", "dt")))
    if hasattr(jproc, "get_arrivals"):
        x["uniform2"] = np.random.default_rng(3).uniform(size=(N, 2))
        checks.append(("get_arrivals", ("state", "uniform2", "dt")))
    if hasattr(jproc, "fill_probability"):
        checks += [("fill_probability", ("state", "depths")), ("get_fills", ("state", "depths", "uniform"))]
    if hasattr(jproc, "get_impact"):
        checks.append(("get_impact", ("state", "action")))
    for method, args in checks:
        got, want = _both(jproc, proc, method, x, *args)
        assert got.shape == want.shape, (method, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=method)
    if name == "ExogenousMmFill-strict":  # the reference's frozen depths
        np.testing.assert_array_equal(_both(jproc, proc, *checks[0][:1], x, *checks[0][1])[0], x["state"])


def test_cev_negative_price_is_nan_as_in_jax():
    """CEV raises the state to gamma as is: a negative price gives NaN in
    both packages."""
    jproc = jp.CevMidprice(gamma=0.9)
    x = _inputs(jproc, 5)
    x["state"] = -np.abs(x["state"])
    got, want = _both(jproc, _port(jproc), "update", x, "state", "arrivals", "fills", "action", "noise", "dt")
    assert np.isnan(want).all() and np.isnan(got).all()


def test_strict_fills_reduce_across_envs():
    """The strict_reference_bug fills take the maximum over all envs
    (torch.amax), so one env's depth changes every env's probability."""
    depths = torch.tensor([[0.1, 0.2], [0.4, 0.3], [0.0, 0.1]], dtype=torch.float64)
    tri = tp.TriangularFill(max_fill_depth=1.0, strict_reference_bug=True)
    np.testing.assert_allclose(tri.fill_probability(None, depths).numpy(), np.full((3, 2), 0.7))
    power = tp.PowerFill(fill_exponent=1.0, fill_multiplier=1.0, strict_reference_bug=True)
    want = 1.0 / (1.0 + np.array([0.4, 0.3]))
    np.testing.assert_allclose(power.fill_probability(None, depths).numpy(), np.broadcast_to(want, (3, 2)))


def test_package_exports_the_jax_names():
    names = {n for n in dir(jp) if n[0].isupper()}
    assert names == {n for n in dir(tp) if n[0].isupper()}
    assert len(names - {"ProcessBase"}) == 21  # 10 midprice, 3 arrival, 4 fill, 4 impact models


# ------------------------------------------------------------ composition fuzz
MIDPRICES = [
    jp.ConstantMidprice(), jp.BrownianMotionMidprice(), jp.GeometricBrownianMotionMidprice(), jp.OuMidprice(),
    jp.ShortTermOuAlphaMidprice(), jp.BrownianMotionJumpMidprice(), jp.OuJumpMidprice(),
    jp.ShortTermJumpAlphaMidprice(), jp.HestonMidprice(), jp.CevMidprice(gamma=0.9),
]
ARRIVALS = [jp.PoissonArrivals((50.0, 50.0)), jp.PoissonArrivalsNonLinear((50.0, 50.0)), jp.HawkesArrivals()]
FILLS = [
    jp.ExponentialFill(), jp.TriangularFill(), jp.PowerFill(),
    jp.ExogenousMmFill(bid_process=jp.OuMidprice(initial_price=0.7, dt_scaled_drift=True),
                       ask_process=jp.OuMidprice(initial_price=0.7, dt_scaled_drift=True)),
]
IMPACTS = [jp.TemporaryPowerImpact(), jp.TemporaryAndPermanentImpact(), jp.TemporaryAndTransientImpact(),
           jp.TransientImpact()]
MM_REWARDS = [PnL(), RunningInventoryPenalty(0.01, 0.001), CjMmCriterion(0.01, 0.001), ExponentialUtility()]


def _composition(trial):
    """tests/test_composition_fuzz.py's draw for ``trial``, in float64."""
    rng = random.Random(trial)
    kind = rng.choice(["limit", "touch", "limit_and_market", "speed"])
    mid = rng.choice(MIDPRICES)
    if kind == "limit":
        dyn = LimitOrderDynamics(midprice_model=mid, arrival_model=rng.choice(ARRIVALS),
                                 fill_probability_model=rng.choice(FILLS))
        reward = rng.choice(MM_REWARDS)
    elif kind == "touch":
        dyn = AtTheTouchDynamics(midprice_model=mid, arrival_model=rng.choice(ARRIVALS))
        reward = rng.choice(MM_REWARDS)
    elif kind == "limit_and_market":
        dyn = LimitAndMarketOrderDynamics(midprice_model=mid, arrival_model=rng.choice(ARRIVALS),
                                          fill_probability_model=rng.choice(FILLS))
        reward = rng.choice(MM_REWARDS)
    else:
        dyn = TradingWithSpeedDynamics(midprice_model=mid, price_impact_model=rng.choice(IMPACTS))
        reward = rng.choice([PnL(), CjOeCriterion(2e-4, 0.01)])
    cfg = EnvConfig(dynamics=dyn, reward_function=reward, n_steps=16, num_trajectories=16,
                    initial_inventory=rng.choice([0, 2, (-2, 3)]), dtype="float64")
    action = {1: [-1.0], 2: [0.4, 0.4], 4: [0.4, 0.4, 0.0, 0.0]}[dyn.action_dim]
    return cfg, action


@pytest.mark.parametrize("trial", range(20))
def test_random_composition_matches_jax_engine(trial):
    """The same composition, fixed action, per-env initial inventory and
    injected noise (every slot's columns from one numpy seed) through both
    engines: every observation, action and reward agrees to the golden
    tolerances (and to 1e-12 relative), and the trajectory is finite with time reaching 1."""
    jcfg, action = _composition(trial)
    cfg = torch_config(jcfg)
    rng = np.random.default_rng(100 + trial)
    n, steps = jcfg.num_trajectories, jcfg.n_steps
    inv0 = rng.integers(-2, 3, size=n).astype(np.float64)
    cols = []
    for _, proc in jcfg.dynamics.processes():
        n_norm, n_unif = proc.noise_spec()
        cols.append((rng.normal(size=(steps, n, n_norm)) if n_norm else None,
                     rng.uniform(size=(steps, n, n_unif)) if n_unif else None))
    with enable_x64():
        jres = jax_rollout(jcfg, jax_fixed_action_policy(action), None, jax.random.PRNGKey(0),
                           noise=tuple(JaxSlotNoise(*c) for c in cols), initial_inventory=jnp.asarray(inv0))
        want = {k: np.asarray(v) for k, v in jres.trajectory._asdict().items()}
    res = rollout(cfg, fixed_action_policy(action), None, 0, noise=tuple(SlotNoise(*c) for c in cols),
                  initial_inventory=torch.from_numpy(inv0), backend="engine", device="cpu")
    got = {k: v.numpy() for k, v in res.trajectory._asdict().items()}
    assert got["observations"].shape == (steps + 1, n, jcfg.state_dim)
    assert np.isfinite(got["observations"]).all() and np.isfinite(got["rewards"]).all()
    np.testing.assert_allclose(got["observations"][-1, :, 2], 1.0, atol=1e-9)
    np.testing.assert_array_equal(got["observations"][..., 1], want["observations"][..., 1])
    np.testing.assert_allclose(got["observations"], want["observations"], rtol=1e-12, atol=1e-9)
    np.testing.assert_array_equal(got["actions"], want["actions"])
    # rtol: the exponential utility's rewards reach 1e9, where libm's exp
    # and XLA's differ in the last bit
    np.testing.assert_allclose(got["rewards"], want["rewards"], rtol=1e-12, atol=1e-9)
