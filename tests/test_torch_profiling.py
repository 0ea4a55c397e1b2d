"""mbt_gym_torch.utils.profiling and utils.tblog against the JAX
package's: trace writes a Chrome trace, throughput returns JAX's four
keys, finite, scaling_report runs at width 1 over a Gloo group, and the
TensorBoard logger tests of tests/test_components.py:249-290 on the port
(with card-style tensors read back in one transfer)."""
import glob
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mbt_gym_tpu.agents.baseline import fixed_action_policy as jfixed
from mbt_gym_tpu.utils import profiling as jprofiling
from mbt_gym_tpu.utils.config import as_env_config as jas_env_config

from mbt_gym_torch.agents.baseline import fixed_action_policy
from mbt_gym_torch.parallel import mesh as mesh_lib
from mbt_gym_torch.utils import profiling, tblog
from mbt_gym_torch.utils.config import as_env_config


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as d:
        assert d == log_dir
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_throughput_returns_jax_keys_finite():
    cfg = as_env_config(num_trajectories=32, n_steps=5)
    got = profiling.throughput(cfg, fixed_action_policy([0.5, 0.5]), episodes_per_call=2, iters=2, device="cpu")
    want = jprofiling.throughput(jas_env_config(num_trajectories=32, n_steps=5), jfixed([0.5, 0.5]),
                                 episodes_per_call=1, iters=1)
    assert got.keys() == want.keys()
    assert all(math.isfinite(v) for v in got.values()) and got["env_steps_per_s"] > 0
    again = profiling.throughput(cfg, fixed_action_policy([0.5, 0.5]), episodes_per_call=2, iters=2, device="cpu")
    assert again["checksum"] == got["checksum"]  # the same seeds, the same episodes


def test_scaling_report_width_one_over_gloo():
    assert not dist.is_initialized()
    mesh_lib.init_distributed(device="cpu")
    try:
        rows = profiling.scaling_report(as_env_config(num_trajectories=32, n_steps=5), fixed_action_policy([0.5, 0.5]),
                                        episodes_per_call=1, iters=1)
    finally:
        dist.destroy_process_group()
    assert len(rows) == 1 and rows[0]["devices"] == 1 and rows[0]["efficiency"] == 1.0
    assert rows[0]["env_steps_per_s"] > 0


def test_host_values_reads_each_device_once():
    metrics = {"a": torch.tensor(1.5), "b": torch.arange(3, dtype=torch.float32), "c": 2, "d": np.float32(0.25)}
    out = tblog.host_values(metrics)
    assert list(out) == ["a", "b", "c", "d"]
    assert out["a"].shape == () and float(out["a"]) == 1.5
    np.testing.assert_array_equal(out["b"], [0.0, 1.0, 2.0])
    assert float(out["c"]) == 2.0 and float(out["d"]) == 0.25


def _scalars(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(run_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_tensorboard_logger(tmp_path):
    """Event files from learner metric dicts; non-finite values skipped;
    the None-dir factory is a no-op."""
    pytest.importorskip("torch.utils.tensorboard")
    logger = tblog.TensorboardLogger(str(tmp_path / "run"))
    for i in range(3):
        logger.log(i, {"pg_loss": torch.tensor(0.1 * i), "reward": i * 1.0, "bad": float("nan")})
    logger.close()
    files = list((tmp_path / "run").glob("events.out.tfevents.*"))
    assert files and files[0].stat().st_size > 0
    scalars = _scalars(str(tmp_path / "run"))
    assert "train/bad" not in scalars
    assert [s for s, _ in scalars["train/pg_loss"]] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in scalars["train/reward"]], [0.0, 1.0, 2.0])
    noop = tblog.maybe_logger(None)
    noop.log(0, {"x": 1.0})
    noop.flush()
    noop.close()


def test_tensorboard_logger_chunked_metrics(tmp_path):
    """Stacked (n_iterations,) values from ppo.train_chunk log element by
    element at consecutive steps; values of two or more dims raise."""
    pytest.importorskip("torch.utils.tensorboard")
    logger = tblog.maybe_logger(str(tmp_path / "run"))
    logger.log(4, {"pg_loss": torch.arange(3, dtype=torch.float32)})
    with pytest.raises(ValueError, match="1-D"):
        logger.log(7, {"bad": torch.zeros(2, 2)})
    logger.close()
    assert _scalars(str(tmp_path / "run"))["train/pg_loss"] == [(4, 0.0), (5, 1.0), (6, 2.0)]


def test_tensorboard_logger_without_tensorboard(monkeypatch):
    """Where torch.utils.tensorboard does not import, constructing the
    logger raises ImportError naming the package."""
    import builtins

    real_import = builtins.__import__

    def fake_import(name, *args, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", fake_import)
    with pytest.raises(ImportError, match="tensorboard"):
        tblog.TensorboardLogger("unused")
