"""Post-rollout analytics (counterpart of ``mbt_gym_tpu/analytics/``):
backtest statistics, diagnostics, info dicts and plotting.  Each takes the
time-major :class:`~mbt_gym_torch.types.Trajectory` that
:func:`mbt_gym_torch.rollout.rollout` returns, or a feature-major
:class:`~mbt_gym_torch.types.TrajectoryT`, read through its time-major
view."""
from mbt_gym_torch.types import Trajectory, TrajectoryT


def time_major(traj) -> Trajectory:
    """``traj`` as a time-major :class:`Trajectory` (a view, no copy)."""
    return traj.to_time_major() if isinstance(traj, TrajectoryT) else traj
