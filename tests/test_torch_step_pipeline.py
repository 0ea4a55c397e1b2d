"""The step pipeline's geometry (mbt_gym_torch/ops/step_pipeline.py) as the
kernels on it take it: K1 (as_episode), K2 (as_episode_trajectories),
K5 (det_rollout), K6 (oe_episode) and K8 (cj_episode).  The geometry is pure host arithmetic; here it is held
to transcriptions of what csrc/step_pipeline.cuh computes and checks
(ring_bytes, pipe_shape_ok), and to the wide-shape rule.  The kernels
themselves run on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import pytest

from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent
from mbt_gym_torch.ops import cj_episode as cj
from mbt_gym_torch.ops import det_rollout as det
from mbt_gym_torch.ops import episode as ep
from mbt_gym_torch.ops import oe_episode as oe
from mbt_gym_torch.ops import step_pipeline as sp
from mbt_gym_torch.utils.config import as_env_config, cj_env_config, oe_env_config

MAX_PIPE_THREADS = 512  # mbt::kMaxPipeThreads
WIDE_ENVS = 128  # mbt::kWideEnvs


def _padded_cpp(floats):
    return (floats + 3 + 3) & ~3


def _ring_bytes_cpp(g):
    """mbt::ring_slot_floats and mbt::ring_bytes of a geometry."""
    draw_stride = g.envs + 4
    table_stride = _padded_cpp(g.chunk * g.row_floats)
    slot_floats = g.chunk * g.channels * draw_stride + (g.table_rows * table_stride if g.staged else 0)
    return 16 * g.slots + 4 * g.slots * slot_floats


def _pipe_shape_ok_cpp(g, channels):
    """mbt::pipe_shape_ok."""
    if g.channels != channels or g.smem_bytes != _ring_bytes_cpp(g):
        return False
    if g.producers == 0:
        return g.envs == WIDE_ENVS and g.slots == 0 and not g.staged
    groups = g.envs // 32
    return (g.envs >= 32 and g.envs % 32 == 0 and g.producers >= groups and g.producers % groups == 0
            and g.envs + 32 * g.producers <= MAX_PIPE_THREADS and g.chunk >= 1 and g.slots >= 1)


def _geometry(kernel, n):
    """The geometry each kernel's wrapper takes for ``n`` envs at its main
    path's config (K5: the CJP table stats mode)."""
    if kernel in ("K1", "K2"):
        p = ep.params_from_config(as_env_config(num_trajectories=16), 0.1)
        return (ep.kernel_geometry if kernel == "K1" else ep.trajectory_geometry)(p, n)
    if kernel == "K6":
        return oe.kernel_geometry(oe.oe_params_from_config(oe_env_config(num_trajectories=16)), n)
    cfg = cj_env_config(num_trajectories=16, max_inventory=100.0)
    if kernel == "K8":
        return cj.kernel_geometry(cj.cj_params_from_config(cfg), 100, n)
    return det.kernel_geometry(det.cj_rollout_params(cfg, CarteaJaimungalMmAgent.from_config(cfg, max_inventory=100)),
                               n, True)


CHANNELS = {"K1": 5, "K2": 5, "K5": 5, "K6": 1, "K8": 5}
# where each kernel's wide shape starts: K2's own threshold, the others'
# WIDE_MIN_ENVS
WIDE_FROM = {"K1": sp.WIDE_MIN_ENVS, "K2": sp.wide_min_envs("as streams"), "K6": sp.WIDE_MIN_ENVS,
             "K8": sp.WIDE_MIN_ENVS}


@pytest.mark.parametrize("kernel", ["K1", "K2", "K6", "K8"])
def test_wide_shape_from_the_threshold_on(kernel):
    """K1, K6 and K8 take the wide shape from WIDE_MIN_ENVS envs on, K2 from
    its own threshold: no producers, no ring, one 128-thread CTA per 128
    envs; one env fewer keeps the pipeline."""
    below = _geometry(kernel, WIDE_FROM[kernel] - 1)
    assert below.shape == "pipeline" and below.producers > 0 and below.slots > 0
    for n in (WIDE_FROM[kernel], 1_048_576):
        g = _geometry(kernel, n)
        assert g.shape == "wide" and g.producers == 0 and g.slots == 0 and g.staged == 0
        assert g.smem_bytes == 0 and g.envs == g.threads == sp.WIDE_ENVS == WIDE_ENVS
        assert g.channels == CHANNELS[kernel] and g.table_path in ("none", "global")


def test_k5_keeps_the_pipeline_at_every_size():
    """K5 has no wide shape: its geometry stays a pipeline past the
    threshold."""
    for n in (sp.WIDE_MIN_ENVS, 1_048_576):
        g = _geometry("K5", n)
        assert g.shape == "pipeline" and g.producers > 0 and g.table_path == "staged"


@pytest.mark.parametrize("kernel", ["K1", "K2", "K5", "K6", "K8"])
@pytest.mark.parametrize("n", [1, 4_099, 8_192, 16_384, sp.wide_min_envs("as streams") - 1, 131_072,
                               sp.WIDE_MIN_ENVS, 1_048_576])
def test_ring_bytes_agrees_with_the_kernels_formula(kernel, n):
    """Every geometry a wrapper takes passes the kernels' own check, and its
    shared memory is what the C++ ring_bytes computes from it."""
    g = _geometry(kernel, n)
    assert g.smem_bytes == _ring_bytes_cpp(g)
    assert g.smem_bytes == sp.ring_bytes(g.envs, g.chunk, g.slots, g.channels, g.table_rows * g.staged, g.row_floats)
    assert g.smem_bytes <= sp.SMEM_BUDGET and g.threads <= MAX_PIPE_THREADS
    assert _pipe_shape_ok_cpp(g, CHANNELS[kernel])


def test_with_shape_pins_the_wide_shape_and_back():
    """A tuning pin with no producers is the wide shape whatever the rest;
    a pin with producers is a pipeline again, its ring recomputed."""
    g = _geometry("K8", 16_384)
    wide = g.with_shape(64, 0, 4, 3)
    assert wide == sp.wide_geometry(5, 2, 402) and wide.shape == "wide" and _pipe_shape_ok_cpp(wide, 5)
    back = wide.with_shape(128, 12, 8, 2)
    assert back == g and _pipe_shape_ok_cpp(back, 5)


def test_k2_threshold_and_mode_are_its_own():
    """K2's "as streams" mode and threshold leave the other kernels'
    geometries as they were: K5's streams mode keeps its slots, and K1
    keeps the pipeline between K2's threshold and WIDE_MIN_ENVS."""
    assert sp.wide_min_envs("stats") == sp.wide_min_envs("streams") == sp.WIDE_MIN_ENVS
    assert sp.wide_min_envs("as streams") <= sp.WIDE_MIN_ENVS
    n = sp.wide_min_envs("as streams")
    assert _geometry("K2", n).shape == "wide"
    assert _geometry("K1", n).shape == "pipeline" or n == sp.WIDE_MIN_ENVS
    k5 = sp.pipeline_geometry(16_384, 1000, "limit", "table", False, 201, 4, wide=False)
    assert k5.chunk == sp.MAX_CHUNK["streams"] and k5.producers == sp.PRODUCERS_PER_CONSUMER["streams"] * 4
