"""mbt_gym_torch.checkpoint against the JAX package's checkpoint module:
the round trip of an env state, a train state and a generator, the
mid-training resume bitwise equal to the uninterrupted run (engine path
and the fused path's plain versions, as tests/test_ppo.py::_resume_equivalence
holds the JAX learner), and the mismatch error's three lists on the drifts
of tests/test_reset_draws.py::test_checkpoint_structure_mismatch_raises."""
import dataclasses
import hashlib
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu import checkpoint as jckpt

from mbt_gym_torch import env as env_lib
from mbt_gym_torch.agents import ppo
from mbt_gym_torch.checkpoint import CheckpointMismatchError, restore_checkpoint, save_checkpoint
from mbt_gym_torch.processes.arrivals import PoissonArrivals
from mbt_gym_torch.utils.config import as_env_config


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def params_digest(model) -> str:
    return _digest(*[v for _, v in sorted(model.state_dict().items())])


def adam_digest(opt) -> str:
    """Every parameter's step and moments, in parameter order."""
    parts = []
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state[p]
            parts += [state["step"].reshape(1), state["exp_avg"], state["exp_avg_sq"]]
    return _digest(*parts)


def _env_cfg(n=64, steps=10):
    return dataclasses.replace(
        as_env_config(num_trajectories=n, n_steps=steps),
        normalise_observation_space=True, normalise_action_space=True,
    )


def test_round_trip_of_env_state_train_state_and_generator(tmp_path):
    """Every leaf comes back bitwise, the zero-size process state from the
    template, the generator continuing the saved stream, the train
    state's optimizer bound to its module."""
    cfg = as_env_config(num_trajectories=8, n_steps=5)
    assert PoissonArrivals().initial_state(8, torch.float32, "cpu").shape == (8, 0)  # a zero-size leaf
    state, obs = env_lib.reset(cfg, 3, device="cpu")
    state = env_lib.step(cfg, state, torch.ones(8, 2)).state
    ppo_cfg = ppo.PPOConfig(hidden=(16, 16), n_epochs=1, n_minibatches=2)
    ts, _ = ppo.train_iteration(_env_cfg(), ppo_cfg, ppo.init_train_state(_env_cfg(), ppo_cfg, 0, device="cpu"), 1)
    key = torch.Generator().manual_seed(11)
    torch.rand(3, generator=key)
    bundle = {"env_state": state, "train_state": ts, "key": key, "step": 7, "lr": np.float32(0.5)}
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, bundle)
    want_draw = torch.rand(4, generator=key)  # the saved stream's next draws

    fresh_state, _ = env_lib.reset(cfg, 99, device="cpu")
    template = {
        "env_state": fresh_state,
        "train_state": ppo.init_train_state(_env_cfg(), ppo_cfg, 5, device="cpu"),
        "key": torch.Generator().manual_seed(0),
        "step": 0,
        "lr": np.float32(0.0),
    }
    out = restore_checkpoint(path, template)
    assert isinstance(out["env_state"], env_lib.EnvState)
    for name, a, b in zip(state._fields, state, out["env_state"]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
    assert out["env_state"].process_states[1] is fresh_state.process_states[1]  # zero-size: the template's
    assert out["env_state"].key is fresh_state.key  # loaded in place
    assert torch.equal(out["env_state"].key.get_state(), state.key.get_state())
    assert out["step"] == 7 and out["lr"] == np.float32(0.5)
    assert torch.equal(torch.rand(4, generator=out["key"]), want_draw)
    rts = out["train_state"]
    assert rts.params is template["train_state"].params and rts.update_count == ts.update_count == 1
    assert params_digest(rts.params) == params_digest(ts.params)
    assert adam_digest(rts.opt_state) == adam_digest(ts.opt_state)
    bound = {id(p) for p in rts.params.parameters()}
    assert all(id(p) in bound for g in rts.opt_state.param_groups for p in g["params"])


def test_file_loads_with_weights_only(tmp_path):
    """The file holds tensors, Python scalars and a JSON string only."""
    cfg = _env_cfg()
    ppo_cfg = ppo.PPOConfig(hidden=(16, 16))
    path = str(tmp_path / "ckpt.pt")
    ts = ppo.init_train_state(cfg, ppo_cfg, 0, device="cpu")
    save_checkpoint(path, {"train_state": ts, "key": 3})
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert set(raw) == {"fingerprint", "leaves"} and isinstance(raw["fingerprint"], str)
    leaves = raw["leaves"]
    assert leaves["key"] == 3
    assert leaves["train_state/params/pi/0/weight"].shape == (16, cfg.state_dim)
    first = next(ts.params.parameters())  # Adam has not stepped: zero moments, step 0
    assert torch.equal(leaves["train_state/opt_state/state/0/exp_avg"], torch.zeros_like(first))
    assert float(leaves["train_state/opt_state/state/0/step"]) == 0.0
    fp = json.loads(raw["fingerprint"])
    lr = next(leaf for leaf in fp["leaves"] if leaf["name"] == "train_state/opt_state/param_groups/0/lr")
    assert lr["value"] == ppo_cfg.learning_rate


def _resume_equivalence(env_cfg, ppo_cfg, tmp_path, n_iters=4):
    """train 4 == train 2 -> save -> restore into a template from another
    init seed -> train 2, bitwise (tests/test_ppo.py:103-135)."""
    keys = [100 + i for i in range(n_iters)]
    ts0 = ppo.init_train_state(env_cfg, ppo_cfg, 0, device="cpu")
    straight = ts0
    for k in keys:
        straight, m_straight = ppo.train_iteration(env_cfg, ppo_cfg, straight, k)
    half = ts0
    for k in keys[: n_iters // 2]:
        half, _ = ppo.train_iteration(env_cfg, ppo_cfg, half, k)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, {"train_state": half})
    template = ppo.init_train_state(env_cfg, ppo_cfg, 7, device="cpu")
    assert params_digest(template.params) != params_digest(half.params)
    resumed = restore_checkpoint(path, {"train_state": template})["train_state"]
    assert params_digest(resumed.params) == params_digest(half.params)
    for k in keys[n_iters // 2:]:
        resumed, m_resumed = ppo.train_iteration(env_cfg, ppo_cfg, resumed, k)
    assert resumed.update_count == straight.update_count == n_iters
    assert params_digest(resumed.params) == params_digest(straight.params)
    assert adam_digest(resumed.opt_state) == adam_digest(straight.opt_state)
    assert {k: float(v) for k, v in m_resumed.items()} == {k: float(v) for k, v in m_straight.items()}


def test_resume_equivalence_engine(tmp_path):
    _resume_equivalence(_env_cfg(), ppo.PPOConfig(hidden=(16, 16), n_epochs=1, n_minibatches=2), tmp_path)


def test_resume_equivalence_fused_plain_versions(tmp_path):
    """The fully fused path (K3 and K4's plain versions on the CPU)."""
    cfg = ppo.PPOConfig(hidden=(64, 64), n_epochs=1, n_minibatches=2, shuffle=False, shared_trunk=True,
                        fused_rollout=True, fused_update=True, fused_compute_dtype="float32")
    _resume_equivalence(_env_cfg(n=256, steps=8), cfg, tmp_path)


def _lists(message: str):
    """(only in checkpoint, only in template, drift) from either package's
    mismatch message."""
    found = re.search(r"only in checkpoint=(\[.*?\]), only in template=(\[.*?\]), shape/dtype drift=(\[.*?\])",
                      message)
    return tuple(eval(x) for x in found.groups())  # noqa: S307 - lists of names this test made


@pytest.mark.parametrize("drift", ["renamed", "reshaped", "extra", "missing"])
def test_mismatch_lists_match_jax(tmp_path, drift):
    """The drifts of tests/test_reset_draws.py:250-290 (and an extra and a
    missing leaf): both packages raise and name the same leaves in the
    same three lists."""
    def bundle(lib, w_name="w", w_shape=(3, 2), extra=False, drop_b=False):
        params = {w_name: lib.ones(w_shape, dtype=lib.float32)}
        if not drop_b:
            params["b"] = lib.zeros((2,), dtype=lib.float32)
        if extra:
            params["c"] = lib.zeros((1,), dtype=lib.float32)
        return {"params": params, "step": 5}

    kw = {"renamed": {"w_name": "w2"}, "reshaped": {"w_shape": (2, 3)}, "extra": {"extra": True},
          "missing": {"drop_b": True}}[drift]
    got = {}
    for name, lib, save, restore, err in (
        ("jax", jnp, jckpt.save_checkpoint, jckpt.restore_checkpoint, jckpt.CheckpointMismatchError),
        ("torch", torch, save_checkpoint, restore_checkpoint, CheckpointMismatchError),
    ):
        path = str(tmp_path / f"{name}.ckpt")
        save(path, bundle(lib))
        with pytest.raises(err) as info:
            restore(path, bundle(lib, **kw))
        got[name] = _lists(str(info.value))
        assert int(restore(path, bundle(lib))["step"]) == 5  # the exact template still loads
    assert got["torch"] == got["jax"]
    assert any(got["torch"])


def test_optimizer_hyperparameter_drift_is_named(tmp_path):
    """Adam's hyperparameters are in the fingerprint: a template with
    another learning rate is refused by name."""
    cfg = _env_cfg()
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, ppo.init_train_state(cfg, ppo.PPOConfig(hidden=(16, 16)), 0, device="cpu"))
    other = ppo.init_train_state(cfg, ppo.PPOConfig(hidden=(16, 16), learning_rate=1e-3), 0, device="cpu")
    with pytest.raises(CheckpointMismatchError, match="opt_state/param_groups/0/lr"):
        restore_checkpoint(path, other)


def test_restore_moves_tensors_to_the_template_device(tmp_path):
    """A tensor restores onto the template leaf's device and dtype (here
    the CPU; chip_smoke.py phase 25a restores a CPU file onto the card),
    and a dtype drift is refused by name."""
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, {"x": torch.arange(4, dtype=torch.float32)})
    out = restore_checkpoint(path, {"x": torch.zeros(4, dtype=torch.float32)})
    assert torch.equal(out["x"], torch.arange(4, dtype=torch.float32))
    with pytest.raises(CheckpointMismatchError, match="drift"):
        restore_checkpoint(path, {"x": torch.zeros(4, dtype=torch.float64)})
