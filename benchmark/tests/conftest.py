"""The benchmark's own tests: on the CPU at tiny sizes, with the port's
plain kernel versions standing in for the kernels."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cpu_kernels(monkeypatch):
    """Lift the dispatch's device rule, so that ``backend="auto"`` takes the
    kernel family on the CPU, where its plain version runs: the CPU stands
    in for the card."""
    from mbt_gym_torch import dispatch

    real = dispatch.dispatch_report

    def report(cfg, policy, mode="rollout", platform=None, policy_params=None):
        return real(cfg, policy, mode, "cuda", policy_params)

    monkeypatch.setattr(dispatch, "dispatch_report", report)
    return report
