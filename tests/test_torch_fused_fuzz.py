"""The port's counterpart of tests/test_fused_fuzz.py: random
parameterisations of every fused family (``_random_env``: limit, lam,
touch, speed and limit with exogenous-MM fills, each with a random
midprice, arrival, fill or impact model, reward, inventory and spaces),
each with a random trunk that includes widths off a multiple of 4 and
past 256: K3's plain version against ``mlp_rollout_pallas(interpret=True)``
and K5's fixed kind against ``fixed_rollout_pallas(interpret=True)``
(``_det_rollout_pallas``) on the same injected noise, at the tolerances of
tests/test_pallas_rollout.py:851-854, unwidened: the draws include OU
midprices stepped without dt in their drift (the reference's step, which
multiplies a price difference by |1 - speed|, up to 4, each step), and
they hold there too.  The seeds are the JAX fuzz test's scheme, offset;
none was chosen."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu.agents import networks as jnet
from mbt_gym_tpu.ops import pallas_rollout as pr

from mbt_gym_torch import convert
from mbt_gym_torch.ops import det_rollout as det
from mbt_gym_torch.ops import mlp_rollout as mr
from tests.test_fused_fuzz import _FAMILY_SEED, N, T, _random_env
from tests.test_torch_env import torch_config
from tests.test_torch_networks import jax_numpy_tree

FAMILIES = ["limit", "lam", "touch", "speed", "limit_exo"]
# K3's outputs (obs, actions, log-probs, values, rewards): (rtol, atol)
K3_TOL = ((1e-4, 2e-4), (1e-4, 1e-3), (1e-4, 1e-3), (1e-4, 1e-3), (1e-4, 5e-3))
WIDTHS = (6, 30, 52, 100, 260, 300)  # off a multiple of 4, and past 256


def _random_trunk(rng):
    """1-3 layers of widths from WIDTHS (at least one off a multiple of 4
    or past 256), and either layout."""
    depth = int(rng.integers(1, 4))
    hidden = tuple(int(w) for w in rng.choice(WIDTHS, size=depth))
    return hidden, bool(rng.integers(0, 2))


def _channels(rng, n_ch):
    channels = rng.uniform(size=(T, n_ch, N)).astype(np.float32)
    channels[:, 4:n_ch] = rng.normal(size=(T, n_ch - 4, N)).astype(np.float32)
    return channels


def _assert_inventory_exact(got, want, p, family, msg=""):
    """Integer inventories agree exactly; at the touch (fills are the
    clipped post columns) and on speed (speed x dt) the inventory is
    continuous and held with the observations instead."""
    if family in ("touch", "speed"):
        return
    plane = lambda obs: (np.rint((obs[:, 1] + 1.0) * p.obs_grad[1] + p.obs_low[1])  # noqa: E731
                         if p.normalise_obs else obs[:, 1])
    np.testing.assert_array_equal(plane(got), plane(want), err_msg=msg)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("trial", range(3))
def test_k3_plain_fuzz_matches_jax_interpret_kernel(family, trial):
    rng = np.random.default_rng(5000 + 1000 * trial + _FAMILY_SEED[family])
    jcfg = _random_env(rng, family)
    hidden, shared = _random_trunk(rng)
    cfg = torch_config(jcfg)
    jp = pr.rollout_params_from_config(jcfg)
    p = mr.rollout_params_from_config(cfg)
    assert {f: getattr(jp, f) for f in p._fields} == p._asdict()
    params = jnet.init_actor_critic(jax.random.PRNGKey(int(rng.integers(0, 1 << 30))), jcfg.state_dim,
                                    jcfg.action_dim, hidden=hidden, shared_trunk=shared)
    model = convert.actor_critic_from_numpy(jax_numpy_tree(params), device="cpu")
    channels = _channels(rng, p.n_channels)
    inv0 = None
    if p.inventory_range:
        inv0 = rng.integers(*p.inventory_range, size=N).astype(np.float32)
    want = pr.mlp_rollout_pallas(jp, params, 0, N, tile=128, interpret=True, noise=jnp.asarray(channels),
                                 inv0=None if inv0 is None else jnp.asarray(inv0))
    got = mr.mlp_rollout(p, model, 0, N, noise=torch.from_numpy(channels), device="cpu",
                         inv0=None if inv0 is None else torch.from_numpy(inv0))
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    _assert_inventory_exact(got[0], want[0], p, family, str((hidden, shared)))
    for name, g, w, (rtol, atol) in zip(("obs", "actions", "log_probs", "values", "rewards"), got, want, K3_TOL):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{name} {hidden} {'shared' if shared else 'towers'}")


_FIXED = {("limit", False): [1.0, 0.5], ("limit", True): [-0.6, -0.4], ("lam", False): [0.6, 0.6, 0.0, 1.0],
          ("lam", True): [-0.6, -0.4, 0.5, -0.5], ("touch", False): [1.0, 0.5], ("speed", False): [-2.5]}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("trial", range(3))
def test_k5_fixed_plain_fuzz_matches_jax_interpret_kernel(family, trial):
    rng = np.random.default_rng(7000 + 1000 * trial + _FAMILY_SEED[family])
    jcfg = _random_env(rng, family)
    kind = "limit" if family == "limit_exo" else family
    action = _FIXED[(kind, bool(jcfg.normalise_action_space))]
    jp = pr.fixed_rollout_params(jcfg, action)
    p = det.fixed_rollout_params(torch_config(jcfg), action)
    channels = _channels(rng, p.n_channels)
    inv0 = None
    if p.inventory_range:
        inv0 = rng.integers(*p.inventory_range, size=N).astype(np.float32)
    want = pr.fixed_rollout_pallas(jp, 0, N, tile=128, interpret=True, noise=jnp.asarray(channels),
                                   inv0=None if inv0 is None else jnp.asarray(inv0), final_obs=True)
    got = det.fixed_rollout(p, 0, N, noise=torch.from_numpy(channels), final_obs=True,
                            inv0=None if inv0 is None else torch.from_numpy(inv0))
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    _assert_inventory_exact(got[0], want[0], p, family)
    (obs_r, obs_a), (act_r, act_a), _, _, (rew_r, rew_a) = K3_TOL
    np.testing.assert_allclose(got[0], want[0], rtol=obs_r, atol=obs_a)
    np.testing.assert_allclose(got[1], want[1], rtol=act_r, atol=act_a)
    assert not got[2].any() and not got[3].any()
    np.testing.assert_allclose(got[4], want[4], rtol=rew_r, atol=rew_a)
    np.testing.assert_allclose(got[5], want[5], rtol=obs_r, atol=obs_a)  # the terminal observation
