"""TensorBoard metric logging (counterpart of ``mbt_gym_tpu/utils/tblog.py``;
the reference's SB3 ``tensorboard_log`` wiring, experiments/helpers.py:73-80).

The learners return metric dicts per iteration (:func:`jit_train_iteration`)
or per chunk (:func:`jit_train_chunk`'s ``(n_iterations,)`` stacks); this
module streams them to TensorBoard event files through
``torch.utils.tensorboard.SummaryWriter``, which needs the ``tensorboard``
package: ``TensorboardLogger(...)`` raises ``ImportError`` without it, and
:func:`maybe_logger` returns a no-op logger for ``log_dir=None``.

Usage::

    logger = TensorboardLogger("runs/canonical")
    for i in range(iters):
        ts, metrics = ppo.jit_train_iteration(env_cfg, ppo_cfg, ts, i)
        logger.log(i, metrics)
    logger.close()
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def host_values(metrics: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """Every value of ``metrics`` as a float64 numpy array.  The tensors of
    each device are copied to the host in ONE transfer (flattened and
    concatenated there first), so a dict of card scalars costs one sync,
    not one per metric."""
    out: Dict[str, np.ndarray] = {}
    by_device: Dict[torch.device, list] = {}
    for key, value in metrics.items():
        if isinstance(value, torch.Tensor):
            by_device.setdefault(value.device, []).append((key, value.detach()))
        else:
            out[key] = np.asarray(value, dtype=np.float64)
    for items in by_device.values():
        flat = torch.cat([v.reshape(-1).to(torch.float64) for _, v in items]).cpu().numpy()
        start = 0
        for key, v in items:
            out[key] = flat[start:start + v.numel()].reshape(tuple(v.shape))
            start += v.numel()
    return {key: out[key] for key in metrics}


class TensorboardLogger:
    """Stream per-iteration scalar metrics to a TensorBoard event file.

    Values may be Python numbers, NumPy values or tensors on any device, 0-d
    or ``(n,)``, so a learner's metric dict goes in as it is.  ``prefix``
    namespaces the tags (``train/pg_loss``), the SB3 layout the
    reference's dashboards expect."""

    def __init__(self, log_dir: str, prefix: str = "train"):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as exc:
            raise ImportError(
                "TensorboardLogger needs torch.utils.tensorboard, which needs the "
                "tensorboard package (pip install tensorboard)"
            ) from exc
        self._writer = SummaryWriter(log_dir=log_dir)
        self.prefix = prefix

    def log(self, step: int, metrics: Mapping[str, object]) -> None:
        """Log one iteration's scalar metrics at ``step``.  Values with a
        leading axis (the stacked ``(n_iterations,)`` metrics of
        :func:`mbt_gym_torch.agents.ppo.train_chunk`) are logged element by
        element at steps ``step .. step+n-1``."""
        for key, arr in host_values(metrics).items():
            if arr.ndim == 0:
                self._scalar(key, float(arr), step)
            elif arr.ndim == 1:
                for j, v in enumerate(arr):
                    self._scalar(key, float(v), step + j)
            else:
                raise ValueError(
                    f"metric {key!r} has shape {arr.shape}; TensorboardLogger "
                    "takes scalars or 1-D per-iteration stacks"
                )

    def _scalar(self, key: str, v: float, step: int) -> None:
        if math.isfinite(v):
            self._writer.add_scalar(f"{self.prefix}/{key}", v, int(step))

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


def maybe_logger(log_dir: Optional[str], prefix: str = "train"):
    """A no-op logger when ``log_dir`` is None (so call sites need no
    branching), else a :class:`TensorboardLogger`."""
    if log_dir is None:
        return _NoopLogger()
    return TensorboardLogger(log_dir, prefix=prefix)


class _NoopLogger:
    def log(self, step: int, metrics: Mapping[str, object]) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
