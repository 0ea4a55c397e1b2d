"""mbt_gym_torch.utils.profiling and utils.tblog: the host spans (off, a
span is one flag check and records nothing; under the profiler it is a
user annotation and a record with its parent and call; a call's host
time; the bounded buffer; the schedule's warm-up step records nothing;
the capture's and the build's spans record always; one thread's spans
never parent another's; the CPU entry points' span trees, their outputs
bit for bit alike with recording on and off), trace writes a Chrome
trace, scaling_report runs at width 1 over a Gloo group, and the
TensorBoard logger tests of tests/test_components.py:249-290 on the port
(with card-style tensors read back in one transfer)."""
import dataclasses
import glob
import json
import os
import subprocess
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mbt_gym_torch import dispatch
from mbt_gym_torch.agents import ppo
from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent, fixed_action_policy
from mbt_gym_torch.ops import _build
from mbt_gym_torch.parallel import mesh as mesh_lib
from mbt_gym_torch.rollout import mc_episode_stats
from mbt_gym_torch.utils import profiling, tblog
from mbt_gym_torch.utils.config import as_env_config
from mbt_gym_torch.utils.profiling import SpanRecord, span


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _names(records):
    return [r.name for r in records]


def test_span_off_is_one_flag_check_and_records_nothing(monkeypatch):
    checks, entered = [], []
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: checks.append(1) or False)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", lambda name: entered.append(name))

    @span("mbt.test.decorated")
    def add(a, b):
        return a + b

    assert add(2, 3) == 5
    with span("mbt.test.block"):
        pass
    assert len(checks) == 2  # one flag check a span
    assert entered == [] and profiling.spans() == []
    with profiling.recording():  # recording without a profiler enters no record_function
        assert add(1, 1) == 2
    assert entered == [] and _names(profiling.spans()) == ["mbt.test.decorated"]


def test_span_under_the_profiler_is_a_user_annotation_and_a_record():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("mbt.test.root"):
            with span("mbt.test.child"):
                torch.ones(4) + 1
            with span("mbt.sync.test"):
                pass
        with span("mbt.test.second_root"):
            pass
    events = {e.name: e for e in prof.events() if e.name.startswith("mbt.")}
    assert set(events) == {"mbt.test.root", "mbt.test.child", "mbt.sync.test", "mbt.test.second_root"}
    assert all(e.is_user_annotation and e.device_type == torch.autograd.DeviceType.CPU for e in events.values())
    assert events["mbt.test.child"].cpu_parent.name == "mbt.test.root"
    recs = {r.name: r for r in profiling.spans()}
    root, second = recs["mbt.test.root"], recs["mbt.test.second_root"]
    assert root.parent_id == 0 and root.call_id == root.span_id
    for name in ("mbt.test.child", "mbt.sync.test"):
        assert recs[name].parent_id == root.span_id and recs[name].call_id == root.span_id
        assert root.start_ns <= recs[name].start_ns <= recs[name].end_ns <= root.end_ns
    assert second.parent_id == 0 and second.call_id == second.span_id != root.span_id
    assert _names(profiling.spans()).index("mbt.test.child") < _names(profiling.spans()).index("mbt.test.root")


def _rec(name, start, end, span_id, parent_id, call_id=1):
    return SpanRecord(name, start, end, span_id, parent_id, call_id)


def test_host_time_is_the_root_less_its_sync_descendants():
    """A synthetic nest (times in ns): a sync child, a sync under a plain
    child, a sync inside that sync (counted once), a plain grandchild."""
    records = [
        _rec("mbt.sync.a", 10, 30, 2, 1),
        _rec("mbt.sync.inner", 52, 55, 5, 4),
        _rec("mbt.sync.b", 50, 60, 4, 3),
        _rec("mbt.work", 62, 80, 6, 3),
        _rec("mbt.child", 40, 90, 3, 1),
        _rec("mbt.root", 0, 100, 1, 0),
        _rec("mbt.root", 200, 260, 7, 0, 7),
        _rec("mbt.sync.c", 210, 250, 8, 7, 7),
    ]
    assert profiling.host_seconds("mbt.root", records) == pytest.approx([70e-9, 20e-9], rel=1e-12)
    assert profiling.host_seconds("mbt.child", records) == pytest.approx([40e-9], rel=1e-12)


def test_the_buffer_stays_bounded():
    with profiling.recording():
        for i in range(profiling.MAX_SPANS + 25):
            with span(f"mbt.test.{i % 3}"):
                pass
    records = profiling.spans()
    assert len(records) == profiling.MAX_SPANS
    assert records[-1].span_id - records[0].span_id == profiling.MAX_SPANS - 1  # the oldest went
    profiling.reset_spans()
    assert profiling.spans() == []


def test_the_profilers_warmup_step_records_nothing():
    """Under a schedule's warm-up step the profiler's flag is down, so a
    traced window's spans cover its active step alone."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        with span("mbt.test.warmup"):
            pass
        prof.step()
        with span("mbt.test.active"):
            pass
        prof.step()
    with span("mbt.test.after"):
        pass
    assert _names(profiling.spans()) == ["mbt.test.active"]


def test_always_spans_record_with_tracing_off(monkeypatch, tmp_path):
    """``always=True`` records with tracing off, as the graph capture and
    the kernel build do; a plain span inside it does not.  The build's
    span, with ``nvcc`` and its run stood in for."""
    with span("mbt.test.always", always=True) as timer:
        with span("mbt.test.inside"):
            pass
    assert _names(profiling.spans()) == ["mbt.test.always"] and timer.record.seconds >= 0

    def fake_run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\0")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    path = _build.build("as_episode.cu")
    assert path.exists() and _names(profiling.spans()) == ["mbt.test.always", "mbt.build"]
    _build.build("as_episode.cu")  # built already: no nvcc run, no span
    assert _names(profiling.spans()).count("mbt.build") == 1


def test_threads_keep_their_own_span_stacks():
    barrier = threading.Barrier(4)
    errors = []

    def work(tag):
        try:
            for _ in range(50):
                with span(f"mbt.test.root{tag}"):
                    barrier.wait(timeout=30)
                    with span(f"mbt.test.child{tag}"):
                        pass
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    with profiling.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and errors == []
    by_id = {r.span_id: r for r in profiling.spans()}
    children = [r for r in by_id.values() if ".child" in r.name]
    assert len(children) == 200
    for child in children:
        parent = by_id[child.parent_id]
        assert parent.name == child.name.replace("child", "root") and child.call_id == parent.span_id


# ------------------------------------------------------------ the entry points on the CPU
def _lift_dispatch(monkeypatch):
    """The dispatch as it decides for a card, so that ``backend="auto"``
    takes the kernel family on the CPU, where its plain version runs."""
    real = dispatch.dispatch_report
    monkeypatch.setattr(dispatch, "dispatch_report", lambda cfg, policy, mode="rollout", platform=None,
                        policy_params=None: real(cfg, policy, mode, "cuda", policy_params))


def _learning_cfg():
    cfg = as_env_config(num_trajectories=64, n_steps=8)
    return dataclasses.replace(cfg, normalise_observation_space=True, normalise_action_space=True)


def _evaluate():
    env_cfg = _learning_cfg()
    ts = ppo.init_train_state(env_cfg, ppo.PPOConfig(hidden=(16, 16)), 0, device="cpu")
    return lambda: ppo.evaluate_policy(env_cfg, ts.params, 7, n_episodes=2)


def _mc():
    cfg = as_env_config(num_trajectories=256, n_steps=10)
    policy = AvellanedaStoikovAgent.from_config(cfg, risk_aversion=0.1).policy()
    return lambda: mc_episode_stats(cfg, policy, None, 11, episodes=2, device="cpu")


def _train(fused):
    env_cfg = _learning_cfg()
    ppo_cfg = ppo.PPOConfig(hidden=(16, 16), n_epochs=1, n_minibatches=2, shared_trunk=fused, fused_update=fused,
                            fused_rollout=fused, shuffle=not fused)
    ts = ppo.init_train_state(env_cfg, ppo_cfg, 0, device="cpu")
    return lambda: ppo.jit_train_iteration(env_cfg, ppo_cfg, ts, 3)


CASES = {
    # name: (call, lift the dispatch, root, spans beneath it)
    "evaluate-engine": (_evaluate, False, "mbt.evaluate_policy", {"mbt.dispatch", "mbt.mem_query", "mbt.rollout"}),
    "evaluate-k3": (_evaluate, True, "mbt.evaluate_policy",
                    {"mbt.dispatch", "mbt.mem_query", "mbt.eval.params_copy", "mbt.k3.prepare", "mbt.sync.seed",
                     "mbt.k3.gae"}),
    "mc-engine": (_mc, False, "mbt.mc_episode_stats", {"mbt.dispatch"}),
    "mc-k1": (_mc, True, "mbt.mc_episode_stats",
              {"mbt.dispatch", "mbt.sync.seed", "mbt.k1.launch", "mbt.k1.moments", "mbt.sync.mean_spread"}),
    "train-engine": (lambda: _train(False), False, "mbt.train_iteration", {"mbt.learner.check"}),
    "train-fused": (lambda: _train(True), False, "mbt.train_iteration",
                    {"mbt.learner.check", "mbt.k3.prepare", "mbt.sync.seed"}),
}


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _flat(v)]
    if isinstance(out, torch.nn.Module):
        return list(out.state_dict().values())
    if isinstance(out, torch.optim.Optimizer):
        return [t for state in out.state.values() for t in _flat(state)]
    return [torch.tensor(out)]


@pytest.mark.parametrize("case", list(CASES))
def test_entry_points_open_their_span_trees_on_the_cpu(case, monkeypatch):
    make, lift, root_name, beneath = CASES[case]
    if lift:
        _lift_dispatch(monkeypatch)
    call = make()
    off = call()
    assert profiling.spans() == []
    with profiling.recording():
        on = call()
    for a, b in zip(_flat(off), _flat(on), strict=True):
        assert torch.equal(a, b)  # bit for bit: the spans change nothing
    records = profiling.spans()
    roots = [r for r in records if r.parent_id == 0]
    assert [r.name for r in roots] == [root_name]
    root = roots[0]
    assert all(r.call_id == root.span_id for r in records)
    assert beneath <= {r.name for r in records if r is not root}
    assert all(r.name.startswith("mbt.") for r in records)
    (host,) = profiling.host_seconds(root_name, records)
    assert 0 < host <= root.seconds


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
