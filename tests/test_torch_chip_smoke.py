"""chip_smoke.py's host-side arithmetic, which the CPU can check: the
device busy time of a profile (the union of the device events'
intervals) and the FLOP counts behind the update kernels' bounds."""
import pytest

import chip_smoke


@pytest.mark.parametrize("intervals,want_us", [
    ([], 0.0),
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),  # apart
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),  # overlapping: a kernel beside a copy
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 5.0)], 10.0),  # nested: an op's span and its kernels
    ([(4.0, 5.0), (0.0, 1.0), (0.5, 4.5)], 5.0),  # unsorted
])
def test_busy_time_is_the_union_of_intervals(intervals, want_us):
    """Time covered by any interval, none counted twice, so busy time is
    at most the span of the events (and the wall time around them)."""
    got = chip_smoke.busy_ms(intervals)
    assert got == want_us / 1e3
    if intervals:
        span = max(e for _, e in intervals) - min(s for s, _ in intervals)
        assert got <= span / 1e3


def test_towers_flop_counts():
    """Separate towers do the trunk's work twice and the heads' once.  At
    S=4, 256x256, A=2, per sample: forward 2(4*256 + 256*256 + 3*256) =
    134,656 (towers 2(2*4*256 + 2*256*256 + 3*256) = 267,776); backward
    dh2, dW_head, dW1, dh1, dW0 2(2*3*256 + 2*256*256 + 4*256) = 267,264
    (towers 2(2*3*256 + 4*256*256 + 2*4*256) = 531,456)."""
    assert chip_smoke.mlp_flops_per_sample(4, 256, 256, 2) == 134_656
    assert chip_smoke.mlp_flops_per_sample(4, 256, 256, 2, towers=2) == 267_776
    assert chip_smoke.ppo_grad_flops_per_sample(4, 256, 256, 2) == 134_656 + 267_264
    assert chip_smoke.ppo_grad_flops_per_sample(4, 256, 256, 2, towers=2) == 267_776 + 531_456


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN4_GLOBAL9ppo_pass2ILb1ELb0E13__nv_bfloat16EEv' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL9ppo_pass2ILb1ELb0E13__nv_bfloat16EEv
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN4_GLOBAL12reduce_partsEPKfiiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL12reduce_partsEPKfiiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers
ptxas info    : Compiling entry function '_ZN4_GLOBAL9ppo_pass1ILb0ELb0EfEEv' for 'sm_90a'
ptxas info    : Used 107 registers, used 1 barriers, 96 bytes cumulative stack size
"""


def test_register_report_keeps_each_kernels_spill_line():
    """Phase 18's rows: each matching entry's register line with its own
    spill line (none where ptxas printed none), other entries skipped."""
    rows = chip_smoke.kernel_registers(_PTXAS, ("ppo_pass1", "ppo_pass2"))
    assert rows == [
        ("_ZN4_GLOBAL9ppo_pass2ILb1ELb0E13__nv_bfloat16EEv",
         "Used 128 registers, used 1 barriers, 8 bytes cumulative stack size; "
         "8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads"),
        ("_ZN4_GLOBAL9ppo_pass1ILb0ELb0EfEEv", "Used 107 registers, used 1 barriers, 96 bytes cumulative stack size"),
    ]


_SASS = """\
        Function : _ZN4_GLOBAL9ppo_pass1ILb1ELb0E13__nv_bfloat16EEv
        /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/  LDSM.16.MT88.4 R8, [R2] ;
        /*0120*/  HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
        Function : _ZN4_GLOBAL9ppo_pass1ILb0ELb0EfEEv
        /*0100*/  FFMA R4, R8, R12, R4 ;
        Function : _ZN4_GLOBAL18mlp_rollout_kernelILb1EEEv15MlpKernelParams12TowerWeightsI13__nv_bfloat16E
        /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/  MUFU.EX2 R3, R3 ;
        Function : _ZN4_GLOBAL18mlp_rollout_kernelILb0EEEv15MlpKernelParams12TowerWeightsIfE
        /*0100*/  MUFU.EX2 R3, R3 ;
        /*0110*/  MUFU.RCP R5, R3 ;
"""


@pytest.mark.parametrize("names, opcode, want", [
    (None, "HMMA", {
        "_ZN4_GLOBAL9ppo_pass1ILb1ELb0E13__nv_bfloat16EEv": 2,
        "_ZN4_GLOBAL9ppo_pass1ILb0ELb0EfEEv": 0,
        "_ZN4_GLOBAL18mlp_rollout_kernelILb1EEEv15MlpKernelParams12TowerWeightsI13__nv_bfloat16E": 1,
        "_ZN4_GLOBAL18mlp_rollout_kernelILb0EEEv15MlpKernelParams12TowerWeightsIfE": 0,
    }),
    (("mlp_rollout_kernel",), "MUFU", {
        "_ZN4_GLOBAL18mlp_rollout_kernelILb1EEEv15MlpKernelParams12TowerWeightsI13__nv_bfloat16E": 1,
        "_ZN4_GLOBAL18mlp_rollout_kernelILb0EEEv15MlpKernelParams12TowerWeightsIfE": 2,
    }),
], ids=["every-kernel", "name-filter"])
def test_sass_counts_per_kernel(names, opcode, want):
    """Phase 18 counts an opcode per kernel of ``cuobjdump -sass`` output;
    a kernel without it counts 0, and a name filter keeps only the kernels
    it names (K3's instantiations beside the update passes)."""
    assert chip_smoke.sass_counts(_SASS, opcode, names) == want


_K3_F32 = ("_ZN47_GLOBAL__N__ac7b1fe6_14_mlp_rollout_cu_f500ab6c18mlp_rollout_kernelILb0EEEv15MlpKernelParamsijPKfNS_"
           "12TowerWeightsINSt11conditionalIXT_E13__nv_bfloat16fE4typeEEES9_NS_6LayoutES3_10RolloutOut")


@pytest.mark.parametrize("entry, bf16", [
    ("_ZN4_GLOBAL9ppo_pass1ILb1ELb0E13__nv_bfloat16EEv", True),
    ("_ZN4_GLOBAL9ppo_pass2ILb0ELb1EfEEv", False),
    (_K3_F32.replace("kernelILb0E", "kernelILb1E"), True),
    (_K3_F32, False),
], ids=["update-bf16", "update-float32-rows", "k3-bf16", "k3-float32"])
def test_bf16_instantiation_reads_the_first_template_argument(entry, bf16):
    """Phase 18 tells the instantiations apart by their first template
    argument (kBf16): K3's float32 kernel mangles __nv_bfloat16 into its
    parameter types, as seen in the SASS of a build on the H100."""
    assert chip_smoke.bf16_instantiation(entry) is bf16


def test_rank_by_gap_orders_by_lost_device_time():
    """launches x (ms - bound_ms), largest first: many launches of a small
    gap can outrank one launch of a large one."""
    entries = [
        {"name": "one slow launch", "launches": 1, "ms": 0.50, "bound_ms": 0.05},  # 0.45
        {"name": "eight short launches", "launches": 8, "ms": 0.40, "bound_ms": 0.07},  # 2.64
        {"name": "at its bound", "launches": 100, "ms": 1.0, "bound_ms": 1.0},  # 0
        {"name": "two launches", "launches": 2, "ms": 0.11, "bound_ms": 0.003},  # 0.214
    ]
    ranked = [e["name"] for e in chip_smoke.rank_by_gap(entries)]
    assert ranked == ["eight short launches", "one slow launch", "two launches", "at its bound"]


def test_spill_bytes_reads_the_spill_line():
    rows = dict(chip_smoke.kernel_registers(_PTXAS, ("ppo_pass1", "ppo_pass2")))
    assert chip_smoke.spill_bytes(rows["_ZN4_GLOBAL9ppo_pass2ILb1ELb0E13__nv_bfloat16EEv"]) == 12
    assert chip_smoke.spill_bytes(rows["_ZN4_GLOBAL9ppo_pass1ILb0ELb0EfEEv"]) == 0


@pytest.mark.parametrize("n, shape", [(16_384, "pipeline"), (1_048_576, "wide")])
def test_pipeline_entry_names_the_geometry_that_ran(n, shape):
    """The kernels line's pipeline entry says which shape a kernel's
    geometry is: K8's step pipeline at the CJP's 16,384 envs (with its
    ring's bytes), the wide shape (no producers, no ring) at 1,048,576."""
    from mbt_gym_torch.ops import cj_episode as cj
    from mbt_gym_torch.utils.config import cj_env_config

    p = cj.cj_params_from_config(cj_env_config(num_trajectories=16, max_inventory=100.0))
    entry = chip_smoke.pipeline_entry(cj.kernel_geometry(p, 100, n))
    assert entry["shape"] == shape and set(entry) == {"shape", "envs", "producers", "chunk", "slots", "smem_bytes"}
    assert (entry["producers"] == 0) == (shape == "wide") and (entry["smem_bytes"] == 0) == (shape == "wide")


@pytest.mark.parametrize("layout,n,want_ms,by", [
    ("terminal", 16_384, 257 * 16_384 * 200 / 67e12 * 1e3, "operations"),
    ("full", 16_384, 6 * 4 * 16_384 * 200 / 3.35e12 * 1e3, "bytes"),
    ("trajectory", 16_384, 16_384 * (201 * 16 + 200 * 12) / 3.35e12 * 1e3, "bytes"),
    ("trajectory", 1_048_576, 1_048_576 * (201 * 16 + 200 * 12) / 3.35e12 * 1e3, "bytes"),
])
def test_as_bounds_count_each_layouts_bytes(layout, n, want_ms, by):
    """K1 is bound by its operations (257 a native env-step at the float32
    peak), K2's full streams by their 24 bytes per env-step, its trajectory
    layout by 28 bytes per env-step plus the 16-byte initial row: 92.0 MB,
    0.0275 ms at 16,384 x 200."""
    got_ms, got_by = chip_smoke.as_bound(layout, n)
    assert got_by == by and got_ms == pytest.approx(want_ms, rel=1e-12)


def test_two_action_copy_keeps_the_trunk_and_the_first_pi_rows():
    """Phase 23c times K3's PnL kind on the lam params' trunk: the copy
    holds every trunk and value weight as it is and the first two rows of
    the pi head and log_std, in both layouts."""
    import torch

    from mbt_gym_torch.agents.networks import init_actor_critic

    for shared_trunk in (True, False):
        lam = init_actor_critic(3, 4, 4, hidden=(16, 16), shared_trunk=shared_trunk, device="cpu")
        two = chip_smoke.two_action_copy(torch, lam, torch.device("cpu"))
        assert two.action_dim == 2 and two.shared_trunk == shared_trunk
        source = dict(lam.named_parameters())
        for name, t in two.named_parameters():
            want = source[name] if t.shape == source[name].shape else source[name][:2]
            assert torch.equal(t, want), name


def test_continuous_compare_holds_touch_streams_to_the_tolerance():
    """At the touch the fills are the post columns, so every inventory
    stream carries the action's rounding: compare_rollouts(continuous=True)
    takes a stream within rtol 1e-4 / atol 1e-3 as the same and still fails
    on a wrong one."""
    import torch

    n, steps = 2000, 3
    want = [torch.zeros((steps, 4, n)), torch.zeros((steps, 2, n)), *(torch.zeros((steps, n)) for _ in range(3))]
    want[0][:, 1] = torch.linspace(-3, 3, n)
    got = [w.clone() for w in want]
    got[0][:, 1] += 2e-4
    with pytest.raises(chip_smoke.PhaseFailed, match="inventory stream differs"):
        chip_smoke.compare_rollouts(torch, got, want, n, "exact")
    assert chip_smoke.compare_rollouts(torch, got, want, n, "touch", continuous=True) == pytest.approx(2e-4, rel=1e-3)
    got[0][:, 1, :10] += 0.5
    with pytest.raises(chip_smoke.PhaseFailed, match="differs on 10 of"):
        chip_smoke.compare_rollouts(torch, got, want, n, "touch", continuous=True)


def test_a_decision_flipped_at_the_last_step_counts_as_a_flip():
    """The streams hold pre-step inventories, so a fill or market order
    decided the other way at the last step shows only in the last reward:
    compare_rollouts counts that env among the flips (within the 0.1% bar)
    instead of failing the tolerance, and fails past the bar."""
    import torch

    n, steps = 2000, 3
    want = [torch.zeros((steps, 4, n)), torch.zeros((steps, 4, n)), *(torch.zeros((steps, n)) for _ in range(3))]
    got = [w.clone() for w in want]
    got[4][-1, 7] = 0.6
    assert chip_smoke.compare_rollouts(torch, got, want, n, "lam") == 0.0
    got[4][-1, :3] = 0.6
    with pytest.raises(chip_smoke.PhaseFailed, match="differs on 4 of"):
        chip_smoke.compare_rollouts(torch, got, want, n, "lam")


def test_hawkes_fixed_point_of_the_composite_config():
    """Phase 24b's target: 10 * 60 / (60 - 40) = 30 on the composite
    config."""
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.utils.config import composite_env_config

    p = mr.rollout_params_from_config(composite_env_config(num_trajectories=256))
    assert chip_smoke.hawkes_fixed_point(p) == 30.0


def test_narrow_copy_keeps_the_inner_trunk():
    """Phase 24c's K3 lam run beside the composite one: layer 0 reads the
    first four observation columns, the inner layers and the value row are
    the same tensors' values, the pi rows the first four."""
    import torch

    from mbt_gym_torch.agents.networks import init_actor_critic

    wide = init_actor_critic(3, 8, 4, hidden=(32, 32), shared_trunk=False, device="cpu")
    narrow = chip_smoke.narrow_copy(torch, wide, 4, 4, torch.device("cpu"))
    assert (narrow.obs_dim, narrow.action_dim, narrow.hidden) == (4, 4, (32, 32))
    src = dict(wide.named_parameters())
    for name, t in narrow.named_parameters():
        want = src[name][:t.shape[0]]
        torch.testing.assert_close(t, want[:, :t.shape[1]] if t.dim() == 2 else want, rtol=0, atol=0)


def test_kind_configs_cover_every_process_kind():
    """Phase 24a's configurations: every midprice kind but BM, the
    exact-probability arrivals, the triangular and power fills, the
    exogenous-MM fills with BM and GBM sides and the all-axes config, each
    on a general instantiation of K3 and K5, at 16,384 x 200."""
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.ops import proc_kinds as pk

    kinds = chip_smoke.kind_configs()
    seen = set()
    for name, cfg in kinds.items():
        assert (cfg.num_trajectories, cfg.n_steps) == (chip_smoke.KIND_N, 200)
        p = mr.rollout_params_from_config(cfg)
        assert not pk.is_plain(p), name
        seen |= {p.midprice_kind, p.arrival_kind, p.fill_kind, *p.exo_kind}
        q = det.fixed_rollout_params(cfg, chip_smoke.COMPOSITE_ACTION if cfg.action_dim == 4 else (0.6, 0.6))
        assert q.n_channels == 5 + pk.extra_channels(q)
    assert seen >= set(pk.MIDPRICE_KINDS) - {"bm"} | set(pk.ARRIVAL_KINDS) | set(pk.FILL_KINDS) | set(pk.EXO_KINDS)
    assert kinds["all axes"].state_dim == 9


def test_composite_bounds_count_the_wider_streams():
    """K3's composite bound at config 10: (8 + 4 + 3) floats per env-step
    of streams against the S = 8, A = 4 forward's operations; K5's fixed
    composite stats mode is bound by its operations."""
    n, t = chip_smoke.COMPOSITE_N, 200
    flops = chip_smoke.mlp_flops_per_sample(8, 256, 256, 4)
    assert flops == 2 * (8 * 256 + 256 * 256 + 5 * 256)
    ms, by = chip_smoke.bound_ms(15 * 4 * n * t, flops * n * t, chip_smoke.BF16_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(flops * n * t / 989e12 * 1e3)
    ms, by = chip_smoke.bound_ms(4 * 5 * 65_536, chip_smoke.OPS_PER_ENV_STEP_K5_COMPOSITE * 65_536 * t,
                                 chip_smoke.FP32_OPS_PER_S)
    assert by == "operations" and chip_smoke.OPS_PER_ENV_STEP_K5_COMPOSITE == 329


def test_state_digest_reads_params_adam_state_and_count():
    """Phase 25a's digest: equal for equal states, moved by any param, any
    Adam moment and the update count; an optimizer that has not stepped
    digests as Adam's starting state (step 0, zero moments), which a
    restored checkpoint of it holds."""
    import copy

    import torch

    from mbt_gym_torch.agents import ppo
    from mbt_gym_torch.utils.config import as_env_config

    cfg = as_env_config(num_trajectories=32, n_steps=4)
    ppo_cfg = ppo.PPOConfig(hidden=(8, 8), n_epochs=1, n_minibatches=1)
    fresh = ppo.init_train_state(cfg, ppo_cfg, 0, device="cpu")
    stepped, _ = ppo.train_iteration(cfg, ppo_cfg, fresh, 1)
    digest = chip_smoke.state_digest(torch, stepped)
    assert digest == chip_smoke.state_digest(torch, copy.deepcopy(stepped))
    assert digest != chip_smoke.state_digest(torch, stepped._replace(update_count=2))
    moved = copy.deepcopy(stepped)
    next(iter(moved.opt_state.state.values()))["exp_avg"].add_(1e-7)
    assert digest != chip_smoke.state_digest(torch, moved)
    zeroed = copy.deepcopy(fresh)
    for group in zeroed.opt_state.param_groups:
        for p in group["params"]:
            zeroed.opt_state.state[p] = {"step": torch.zeros(()), "exp_avg": torch.zeros_like(p),
                                         "exp_avg_sq": torch.zeros_like(p)}
    assert chip_smoke.state_digest(torch, zeroed) == chip_smoke.state_digest(torch, fresh)


def test_step_split_puts_the_rest_of_a_step_on_the_host():
    """Phase 25c: the median wall time of a step, the profiled busy time
    per step on the device, the host's share the difference."""
    split = chip_smoke.step_split([2.0, 3.0, 2.5, 9.0], busy_ms=10.0, steps=20)
    assert split == {"step_ms": 2.75, "device_ms": 0.5, "host_ms": 2.25, "host_share": 2.25 / 2.75}
    assert chip_smoke.step_split([1.0], busy_ms=40.0, steps=20)["host_ms"] == 0.0


def test_as_numpy_predict_is_the_agents_closed_form():
    """Phase 25c's host model: the AS quotes in numpy float32 equal the
    agent's torch policy to 1e-6."""
    import numpy as np
    import torch

    from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
    from mbt_gym_torch.utils.config import as_env_config

    agent = AvellanedaStoikovAgent.from_config(as_env_config(num_trajectories=8), risk_aversion=0.1)
    rng = np.random.default_rng(2)
    obs = np.stack([rng.normal(size=64), rng.integers(-5, 6, size=64), rng.uniform(size=64),
                    100 + rng.normal(size=64)], axis=1).astype(np.float32)
    got = chip_smoke.as_numpy_predict(agent)(obs)
    assert got.dtype == np.float32 and got.shape == (64, 2)
    np.testing.assert_allclose(got, agent.policy()(None, torch.from_numpy(obs), None).numpy(), rtol=1e-6, atol=1e-6)


def test_launch_deltas():
    """Phase 25's per-run launch counts: what each counter gained."""
    assert chip_smoke.counts_since({"k3": 2, "k4": 5}, {"k3": 3, "k4": 5, "k2": 1}) == {"k3": 1, "k2": 1}


def test_metric_bands_are_the_entry_modules():
    """chip_smoke's bands are mbt_gym_torch.entry's; outside them the phase
    fails."""
    good = {"pg_loss": 0.01, "vf_loss": 2.0, "approx_kl": 0.001, "mean_episode_reward": 10.0}
    assert chip_smoke.assert_metric_bands(good, "ok") == good
    with pytest.raises(chip_smoke.PhaseFailed, match="bands"):
        chip_smoke.assert_metric_bands(dict(good, vf_loss=0.0), "bad")


def test_oe_saving_is_the_share_of_the_closed_form_saving():
    """tests/test_convergence.py:357: holding scores 0, the closed-form
    schedule 1; phase 26b's bar is 0.9."""
    hold, cf = -10.0, -1.3873921632766724
    assert chip_smoke.oe_saving(hold, cf, hold) == 0.0
    assert chip_smoke.oe_saving(cf, cf, hold) == 1.0
    assert chip_smoke.oe_saving(-1.4022302627563477, cf, hold) == pytest.approx(0.998277, abs=1e-6)
    assert chip_smoke.oe_saving(-5.0, cf, hold) < chip_smoke.OE_GATE_BAR


def test_speed_bounds_at_one_action_and_five_columns():
    """K3's speed kind at bench_suite config 6 (S = 5, A = 1, 256x256):
    per env-step 2(5*256 + 256*256 + 2*256) = 134,656 FLOP, the same as
    config 5's S = 4, A = 2 (towers 2(2*5*256 + 2*256*256 + 2*256) =
    268,288), bound by operations at the bf16 peak; the (5 + 1 + 3)-float
    streams are 0.56 ms of bytes.  K4 at S = 5, A = 1: forward plus
    backward 2(2*2*256 + 2*256*256 + 5*256) = 401,408 a sample."""
    assert chip_smoke.mlp_flops_per_sample(5, 256, 256, 1) == 134_656
    assert chip_smoke.mlp_flops_per_sample(5, 256, 256, 1, towers=2) == 268_288
    assert chip_smoke.ppo_grad_flops_per_sample(5, 256, 256, 1) == 134_656 + 266_752
    n, steps = chip_smoke.SPEED_N, chip_smoke.STEPS
    ms, by = chip_smoke.k3_bound(n, steps, 5, 1)
    assert by == "operations" and ms == pytest.approx(134_656 * n * steps / 989e12 * 1e3)
    assert chip_smoke.k3_bound(n, steps, 5, 1, towers=2)[0] == pytest.approx(268_288 * n * steps / 989e12 * 1e3)
    assert 9 * 4 * n * steps / 3.35e12 * 1e3 == pytest.approx(0.5634, abs=1e-4)


def test_speed_figures_fill_the_kernels_line():
    """Phase 26's kernels-line fields: K3's speed times per layout beside
    PnL's on the same trunk, K4's at S = 5, A = 1, K5's new kinds, each
    with launches and its largest error, through a JSON round trip."""
    import json

    err = {"K3": 7.6e-4, "K4": 5.8e-8, "K5": 0.0}
    launches = {"mlp_rollout": 212, "ppo_fused_grads_T": 896, "det_rollout": 2}
    k3 = {"shared trunk": (44.49, 47.19, 669.9, 7.138, 43.01), "towers": (86.75, 92.99, 1220.4, 14.22, 84.42)}
    k5 = {"schedule_lam": (0.153, 0.370, 211.4, 0.0431)}
    extra = {"t0": (45.0, 47.0, 700.0, 7.138)}
    figures = json.loads(json.dumps(chip_smoke.speed_figures(err, launches, k3, (20.92, 21.89, 102.1, 1.33), k5,
                                                             extra)))
    assert set(figures) == {"K3", "K4", "K5"}
    assert figures["K3"]["speed_launches"] == 212 and figures["K3"]["speed_max_abs_err"] == 7.6e-4
    assert figures["K3"]["speed_shared_ms"] == 44.49 and figures["K3"]["speed_towers_pnl_same_call_ms"] == 84.42
    assert figures["K3"]["speed_towers_bound_ms"] == 14.22 and figures["K3"]["speed_shared_plain_ms"] == 669.9
    assert figures["K4"] == {"s5a1_launches": 896, "s5a1_max_abs_err": 5.8e-8, "s5a1_ms": 20.92,
                             "s5a1_call_ms": 21.89, "s5a1_plain_ms": 102.1, "s5a1_bound_ms": 1.33}
    assert figures["K5"]["slice15_launches"] == 2
    assert (figures["K5"]["schedule_lam_ms"], figures["K5"]["schedule_lam_bound_ms"]) == (0.153, 0.0431)
    assert (figures["K3"]["t0_ms"], figures["K3"]["t0_plain_ms"]) == (45.0, 700.0)


@pytest.mark.parametrize("entry,k3,k5", [
    ("_ZN4anon18mlp_rollout_kernelILb1ELi3ELi0ELb0EEEv15MlpKernelParams", True, False),  # speed, plain
    ("_ZN4anon18mlp_rollout_kernelILb0ELi3ELi1ELb0EEEv15MlpKernelParams", True, False),  # speed, general
    ("_ZN4anon18mlp_rollout_kernelILb1ELi1ELi1ELb1EEEv15MlpKernelParams", True, False),  # lam extras
    ("_ZN4anon18mlp_rollout_kernelILb1ELi1ELi1ELb0EEEv15MlpKernelParams", False, False),  # lam general, earlier
    ("_ZN4anon18mlp_rollout_kernelILb1ELi0ELi0ELb0EEEv15MlpKernelParams", False, False),  # limit plain
    ("_ZN4anon18det_rollout_kernelILb0ELi2ELi2ELb1ELb0ELi0EEEv15DetKernelParams", False, True),  # lam schedule
    ("_ZN4anon18det_rollout_kernelILb0ELi3ELi2ELb0ELb1ELi1EEEv15DetKernelParams", False, True),  # touch, general
    ("_ZN4anon26det_rollout_kernel_utilityILb1ELi0ELi0ELb0EEEv15DetKernelParams", False, True),  # utility
    ("_ZN4anon18det_rollout_kernelILb0ELi2ELi1ELb1ELb0ELi0EEEv15DetKernelParams", False, False),  # lam fixed
    ("_ZN4anon18det_rollout_kernelILb0ELi1ELi2ELb1ELb0ELi0EEEv15DetKernelParams", False, False),  # speed schedule
])
def test_new_instantiation_names(entry, k3, k5):
    """Phase 26e picks exactly the instantiations this slice adds by their
    mangled template arguments."""
    import re

    assert bool(re.search(chip_smoke.K3_NEW_INSTANTIATIONS, entry)) == k3
    assert bool(re.search(chip_smoke.K5_NEW_INSTANTIATIONS, entry)) == k5


def test_narrow_copy_widens_the_head_too():
    """K3 PnL beside K3 speed on the same trunk: the copy reads the first
    four of the five observation columns and keeps the one pi row in the
    first of two."""
    import torch

    from mbt_gym_torch.agents.networks import init_actor_critic

    speed = init_actor_critic(3, 5, 1, hidden=(32, 32), shared_trunk=True, device="cpu")
    pnl = chip_smoke.narrow_copy(torch, speed, 4, 2, torch.device("cpu"))
    assert (pnl.obs_dim, pnl.action_dim) == (4, 2)
    assert torch.equal(pnl.shared[0].weight, speed.shared[0].weight[:, :4])
    assert torch.equal(pnl.shared[1].weight, speed.shared[1].weight)
    assert torch.equal(pnl.pi_head.weight[:1], speed.pi_head.weight) and torch.equal(pnl.log_std[:1], speed.log_std)


def test_same_bits_reads_every_leaf_of_phase_27s_results():
    """Phase 27's bitwise compare: equal tensors (NaN where the other is
    NaN), generators in one state, a module's state and an Adam's state in
    parameter order, nested containers; any one bit, dtype or state apart
    is a difference."""
    import copy

    import torch

    from mbt_gym_torch.agents import ppo
    from mbt_gym_torch.utils.config import as_env_config

    x = torch.tensor([1.0, float("nan"), -0.0])
    assert chip_smoke.same_bits(torch, x, x.clone())
    assert not chip_smoke.same_bits(torch, x, x.double())
    assert not chip_smoke.same_bits(torch, x, torch.tensor([1.0, 2.0, -0.0]))
    assert not chip_smoke.same_bits(torch, x, torch.nextafter(x, torch.full_like(x, 2.0)))
    gen = torch.Generator().manual_seed(3)
    twin = torch.Generator().manual_seed(3)
    assert chip_smoke.same_bits(torch, {"g": gen, "t": (x, [x])}, {"g": twin, "t": (x, [x])})
    torch.rand(1, generator=twin)
    assert not chip_smoke.same_bits(torch, gen, twin)
    cfg = as_env_config(num_trajectories=32, n_steps=4)
    ppo_cfg = ppo.PPOConfig(hidden=(8, 8), n_epochs=1, n_minibatches=1)
    ts, _ = ppo.train_iteration(cfg, ppo_cfg, ppo.init_train_state(cfg, ppo_cfg, 0, device="cpu"), 1)
    other = copy.deepcopy(ts)
    assert chip_smoke.same_bits(torch, ts.params, other.params)
    assert chip_smoke.same_bits(torch, ts.opt_state, other.opt_state)
    next(iter(other.opt_state.state.values()))["exp_avg_sq"].add_(1e-9)
    assert not chip_smoke.same_bits(torch, ts.opt_state, other.opt_state)


def test_wall_ms_times_each_call_after_an_untimed_one():
    """Phase 27d's host-clock times: the untimed calls, then one time per
    timed call, the card synchronised around each."""
    import types

    calls, syncs = [], []
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(synchronize=lambda: syncs.append(1)))
    times = chip_smoke.wall_ms(fake, lambda: calls.append(1), calls=3)
    assert len(times) == 3 and len(calls) == 4 and len(syncs) == 4
    assert all(t >= 0.0 for t in times)
    assert len(chip_smoke.wall_ms(fake, lambda: calls.append(1), calls=2, warmup=0)) == 2 and len(calls) == 6


def test_eager_timing_times_every_path_at_small_shapes_on_the_cpu():
    """tree_timing.py's engine paths run at small shapes on the CPU (the
    card's are 27d's): each of the five is timed, in the order phase 27d
    lists them; without a card its command line exits 1 and prints no
    result."""
    import io
    from contextlib import redirect_stdout

    import torch

    import tree_timing

    got = tree_timing.time_paths(torch, "cpu", 2, 1, n_main=128, ppo_n=256, eval_n=128, n_steps=4,
                                 hidden=(8, 8), minibatches=2)
    assert list(got) == ["AS engine rollout 128x4", "config 14's 8 engine episodes (128x4)",
                         "engine iteration, config 5 (256x4)", "engine iteration, config 6 (256x4)",
                         "engine iteration, config 10 (256x4)"]
    for row in got.values():
        assert len(row["calls_ms"]) == 2 and row["ms"] > 0 and row["env_steps_per_s"] > 0
    out = io.StringIO()
    with redirect_stdout(out):
        assert tree_timing.main([]) == 1
        assert tree_timing.main(["--suite", "update"]) == 1
    assert out.getvalue() == ""


def test_tree_timing_digests_the_update_cases_on_the_cpu():
    """tree_timing.py's update suite at a small shape on the CPU (the plain
    versions): every case digested (K4 on both layouts and dtypes at
    configs 5 and 10, K4 beside K7 at S = 8 and 16 and at four trunks, K4
    at the card edge test's S = 5, A = 1 towers case), a
    bf16 case's error against the plain version zero (on the CPU the
    wrapper is the plain version), K4 and K7 on the same samples apart in
    bf16 (their rounding points differ), and a repeated run gives the same
    digests."""
    import torch

    import tree_timing

    shapes = dict(ppo_n=256, n_steps=4, minibatches=2)
    got = tree_timing.run_update(torch, torch.device("cpu"), 1, **shapes)
    again = tree_timing.run_update(torch, torch.device("cpu"), 1, **shapes)
    assert got == again
    assert sorted(got) == sorted([f"config {c} K4 {layout} {dtype}" for c in (5, 10) for layout in ("shared", "towers")
                                  for dtype in ("bfloat16", "float32")]
                                 + [f"config 5 {case} {k} shared bfloat16" for k in ("K4", "K7")
                                    for case in ("S=8", "S=16", "32x32", "64", "256x256", "256x256x256")]
                                 + ["edge S=5 A=1 K4 towers bfloat16"])
    for label, row in got.items():
        assert "refused" not in row, label
        assert row["ms"] is None and len(row["grads"]) == 16
        assert row.get("rel_vs_plain", 0.0) == 0.0 and ("rel_vs_plain" in row) == ("bfloat16" in label)
    for case in ("S=16", "256x256x256"):
        k4, k7 = got[f"config 5 {case} K4 shared bfloat16"], got[f"config 5 {case} K7 shared bfloat16"]
        assert k4["inputs"] != k7["inputs"] and k4["grads"] != k7["grads"]


@pytest.mark.parametrize("widths,towers,forward,backward", [
    ((256, 256), 1, 134_656, 267_264),  # test_towers_flop_counts's figures at two layers
    ((256,), 1, 2 * (4 * 256 + 3 * 256), 2 * (2 * 3 * 256 + 4 * 256)),
    ((256, 256, 256), 1, 2 * (4 * 256 + 2 * 256 * 256 + 3 * 256), 2 * (2 * 3 * 256 + 4 * 256 * 256 + 4 * 256)),
    ((256, 256, 256), 2, 2 * (2 * 4 * 256 + 4 * 256 * 256 + 3 * 256),
     2 * (2 * 3 * 256 + 8 * 256 * 256 + 2 * 4 * 256)),
])
def test_flop_counts_at_any_depth(widths, towers, forward, backward):
    """Phase 28's bounds: every hidden-to-hidden layer adds its product to
    the forward and its transpose and weight gradient to the backward; the
    heads read their own tower.  The two-layer counts are the same
    functions."""
    assert chip_smoke.mlp_flops_at(4, widths, 2, towers) == forward
    assert chip_smoke.ppo_grad_flops_at(4, widths, 2, towers) == forward + backward
    if len(widths) == 2:
        assert chip_smoke.ppo_grad_flops_per_sample(4, *widths, 2, towers) == forward + backward


def test_compare_bf16_bounds_by_the_trunks_float32_drift():
    """Phase 28a's bf16 check beyond two layers holds each leaf and metric
    at fixed bounds, whatever the plain version's own float32 drift: a
    leaf's relative Frobenius error within the bound given, a metric within
    rtol 1e-4 plus the given share of its terms' mean magnitude plus 1e-7.
    The limits by depth are DEEP_BF16_LIMITS's: 1e-3 per leaf up to three
    layers, the bound the shallower trunks are held to."""
    import torch

    want = {"a": torch.ones(4, dtype=torch.float64), "b": torch.full((2,), 2.0, dtype=torch.float64)}
    metrics = {"pg_loss": torch.tensor(0.5, dtype=torch.float64)}
    scales = {"pg_loss": 1.0}  # the terms' mean magnitude: the 0.5 average cancels half of it
    near = {"a": torch.ones(4) * (1 + 9e-4), "b": want["b"].float()}
    drifted = ({"a": want["a"] * (1 + 4e-3), "b": want["b"]}, metrics)  # the plain version drifts 4e-3
    worst = chip_smoke.compare_bf16(torch, near, {"pg_loss": torch.tensor(0.5 + 1.4e-4)}, (want, metrics), scales,
                                    1e-3, 1e-4, "tight", plain=drifted)
    assert worst == pytest.approx(9e-4, rel=1e-3)
    with pytest.raises(chip_smoke.PhaseFailed, match="b: relative Frobenius error"):
        chip_smoke.compare_bf16(torch, {"a": want["a"], "b": want["b"] * (1 + 2e-3)}, metrics, (want, metrics),
                                scales, 1e-3, 1e-4, "tight", plain=drifted)
    with pytest.raises(chip_smoke.PhaseFailed, match="pg_loss"):
        chip_smoke.compare_bf16(torch, want, {"pg_loss": torch.tensor(0.5 + 1.6e-4)}, (want, metrics), scales,
                                1e-3, 1e-4, "tight")
    assert chip_smoke.deep_bf16_limits(3) == chip_smoke.DEEP_BF16_LIMITS[3]
    assert chip_smoke.deep_bf16_limits(5) == chip_smoke.deep_bf16_limits(8) == chip_smoke.DEEP_BF16_LIMITS[8]
    assert chip_smoke.DEEP_BF16_LIMITS[3][0] == 1e-3


def test_feature_major_reblocks_rows_by_step():
    """Row-major samples ordered (t, env) as K4's (T, C, nb) and (T, nb)."""
    import torch

    rows = [torch.arange(24.0).reshape(12, 2), torch.arange(12.0)]
    obs, flat = chip_smoke.feature_major(rows, 3, 4)
    assert tuple(obs.shape) == (3, 2, 4) and tuple(flat.shape) == (3, 4)
    assert float(obs[1, 0, 2]) == float(rows[0][6, 0]) and float(flat[2, 3]) == float(rows[1][11])


def test_metric_scales_are_the_terms_mean_magnitudes():
    """vf_loss's terms are all positive, so its scale is the float32 plain
    version's vf_loss; the cancelling means sit below their scales."""
    import numpy as np
    import torch

    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import fused_ppo

    model = init_actor_critic(3, 4, 2, hidden=(32, 32), shared_trunk=True, device="cpu")
    rows = chip_smoke.update_samples(torch, np, model, 4, 32, 5, torch.device("cpu"))
    scales = chip_smoke.metric_scales(torch, model, rows)
    _, metrics = fused_ppo.ppo_fused_grads_plain(model, *rows, compute_dtype="float32")
    assert scales["vf_loss"] == pytest.approx(float(metrics["vf_loss"]), rel=1e-5)
    for name in ("pg_loss", "approx_kl"):
        assert 0.0 < abs(float(metrics[name])) < scales[name]
