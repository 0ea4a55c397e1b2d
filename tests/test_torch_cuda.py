"""The CUDA episode kernels K1 and K2 against their plain PyTorch versions
on the card.  They have no CPU mode, so every test here skips on a host
without a GPU.  This file imports neither JAX nor the JAX package, so it
runs on the GPU machine too, without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

from mbt_gym_torch.ops import _build
from mbt_gym_torch.ops import episode as ep
from mbt_gym_torch.utils.config import as_env_config


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the episode kernels run only on the card")
    return torch.device("cuda")


def _channels(seed, steps, n, device):
    rng = np.random.default_rng(seed)
    channels = rng.uniform(size=(steps, 5, n)).astype(np.float32)
    channels[:, 4] = rng.normal(size=(steps, n)).astype(np.float32)
    return torch.from_numpy(channels).to(device)


@pytest.mark.parametrize("risk_aversion", [0.1, 0.0], ids=["as-quotes", "fixed-1/k"])
def test_kernels_match_plain_on_the_card(cuda_device, risk_aversion):
    """K1 and K2 (every emit mode, native and noise mode) against their
    plain versions on the same inputs.  Same float32 op order and
    --fmad=false, so the only differences are libm ULPs: inventory may flip
    on at most 1e-4 of envs; cash to rtol=1e-6/atol=1e-3, price to 1e-3."""
    n = 4096
    cfg = dataclasses.replace(as_env_config(num_trajectories=n, n_steps=200), initial_inventory=3)
    p = ep.params_from_config(cfg, risk_aversion)
    before = dict(_build.launch_counts)
    for kw in ({"noise": _channels(1, 200, n, cuda_device)}, {"seed": 5, "device": cuda_device}):
        got = ep.as_episode(p, num_trajectories=n, **kw)
        want = ep.as_episode_plain(p, num_trajectories=n, **kw)
        torch.cuda.synchronize()
        same = got[1] == want[1]
        assert int((~same).sum()) <= n // 10_000
        torch.testing.assert_close(got[0][same], want[0][same], rtol=1e-6, atol=1e-3)
        torch.testing.assert_close(got[2][same], want[2][same], rtol=0, atol=1e-3)
        for emit in ("state", "full", "container"):
            k2 = ep.as_episode_trajectories(p, num_trajectories=n, emit=emit, **kw)
            plain = ep.as_episode_trajectories_plain(p, num_trajectories=n, emit=emit, **kw)
            for a, b in zip(k2, plain):
                torch.testing.assert_close(a[:, same], b[:, same], rtol=1e-6, atol=1e-3)
    assert _build.launch_counts["as_episode"] == before["as_episode"] + 2
    assert _build.launch_counts["as_episode_trajectories"] == before["as_episode_trajectories"] + 6
