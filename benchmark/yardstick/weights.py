"""The actor-critic weights a cell runs, made from ``--seed`` on the device
in one draw, under the names ``torch.nn`` gives the port's actor-critic
(``shared.{i}``, ``pi_head`` and ``vf_head`` for a shared trunk;
``pi.{i}`` and ``vf.{i}`` for separate towers; ``log_std``).

Hidden layers draw normals scaled by ``sqrt(gain / fan_in)``, the output
layers by ``head_std``, as the learner initialises them (mbt_gym's
experiments take ``gain`` 2 and ``head_std`` 0.01); biases are zero except
where ``head_bias`` gives the policy head's; ``log_std`` is
``init_log_std``.  Both the program and the reference are handed these
tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch


def layout(s_dim: int, a_dim: int, hidden: Sequence[int], shared_trunk: bool) -> List[tuple]:
    """``[(name, (out, in), is_output, is_policy_head)]`` of every layer."""
    sizes = (s_dim, *hidden)
    rows = []
    if shared_trunk:
        for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            rows.append((f"shared.{i}", (fan_out, fan_in), False, False))
        rows.append(("pi_head", (a_dim, hidden[-1]), True, True))
        rows.append(("vf_head", (1, hidden[-1]), True, False))
        return rows
    for tower, out_dim in (("pi", a_dim), ("vf", 1)):
        for i, (fan_in, fan_out) in enumerate(zip(sizes, (*hidden, out_dim))):
            last = i == len(hidden)
            rows.append((f"{tower}.{i}", (fan_out, fan_in), last, last and tower == "pi"))
    return rows


def actor_critic(seed: int, s_dim: int, a_dim: int, policy: dict, device,
                 head_std: Optional[float] = None, head_bias: Optional[Sequence[float]] = None
                 ) -> Dict[str, torch.Tensor]:
    """The weights of ``policy`` (a configuration's ``policy`` section:
    ``hidden``, ``shared_trunk``, ``gain``, ``head_std``, ``init_log_std``)
    from ``seed``, float32 on ``device``."""
    rows = layout(s_dim, a_dim, policy["hidden"], policy["shared_trunk"])
    head_std = policy["head_std"] if head_std is None else head_std
    total = sum(o * i for _, (o, i), _, _ in rows)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, start = {}, 0
    for name, (o, i), is_output, is_policy in rows:
        scale = head_std if is_output else math.sqrt(policy["gain"] / i)
        out[f"{name}.weight"] = draw[start:start + o * i].view(o, i) * scale
        start += o * i
        bias = torch.zeros(o, dtype=torch.float32, device=device)
        if is_policy and head_bias is not None:
            bias += torch.tensor(head_bias, dtype=torch.float32, device=device)
        out[f"{name}.bias"] = bias
    out["log_std"] = torch.full((a_dim,), float(policy["init_log_std"]), dtype=torch.float32, device=device)
    return out
