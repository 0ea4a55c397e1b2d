"""Fused PPO update K4 (counterpart of ``ppo_fused_grads_T`` in
``mbt_gym_tpu/ops/fused_ppo.py``), beside its plain PyTorch version.

:func:`ppo_fused_grads_T` replaces ``ppo_fused_grads_T`` (``_kernel_T``,
``ops/fused_ppo.py:392``): the gradient of the PPO clipped-surrogate +
value loss over one minibatch of the K3 rollout's feature-major buffers,
forward and backward in one CUDA kernel launch sequence
(``csrc/fused_ppo.cu``; its source note gives the bound and the
deterministic three-pass design), with the loss metrics.  Inputs: obs
``(T, S, nb)``, actions ``(T, A, nb)``, old log-probs, advantages (already
normalised by the caller) and returns ``(T, nb)``; each may be a strided
view of an env slice of the full ``(.., N)`` buffers (envs minor, unit
stride), which the kernel reads in place.  Grads come back in the model's
own parameter layout: a ``{parameter name: tensor}`` dict in
``model.named_parameters()``'s names.

Ported scope: the shared-trunk actor-critic.  The CUDA kernel takes a
two-layer trunk with widths a multiple of 64 up to 256 (the repo's
256x256 production model) and ``nb`` a multiple of 32; the wrapper raises
``ValueError`` otherwise.  The separate pi/vf towers (the JAX kernel's
``split_at`` mode) are not ported to CUDA yet.  TPU-only parts are
dropped: the T padding to a multiple of 8 and its mask, ``swap_dw0`` and
the VMEM tile search.

CPU tensors run :func:`ppo_fused_grads_T_plain`; CUDA tensors launch the
kernel or raise.  The plain version repeats the kernel's arithmetic in
both ``compute_dtype``s: with ``"bfloat16"`` every matmul operand is
rounded to bf16, the saved activations are rounded to bf16, and
``1 - h*h`` is evaluated in bf16 before it multiplies the float32 ``dh``;
with ``"float32"`` nothing is rounded.  Its matmuls run with TF32 off.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from mbt_gym_torch.ops import _build
from mbt_gym_torch.ops.mlp_rollout import bf16_round, full_float32_matmul, transpose_params

_LOG_2PI = math.log(2.0 * math.pi)
_ENV_TILE = 32
_PASS1_CTAS = 256
_PASS2_PARTS = 64


def _grads_dict(n_layers: int, a_dim: int, dws, dbs, dwh, dbh, dlstd) -> Dict[str, torch.Tensor]:
    grads = {}
    for i in range(n_layers):
        grads[f"shared.{i}.weight"] = dws[i]
        grads[f"shared.{i}.bias"] = dbs[i]
    grads["pi_head.weight"] = dwh[:a_dim]
    grads["pi_head.bias"] = dbh[:a_dim]
    grads["vf_head.weight"] = dwh[a_dim:]
    grads["vf_head.bias"] = dbh[a_dim:]
    grads["log_std"] = dlstd
    return grads


def ppo_fused_grads_T_plain(params, obs_t: torch.Tensor, actions_t: torch.Tensor,
                            old_logp: torch.Tensor, adv: torch.Tensor, returns: torch.Tensor,
                            clip_eps: float = 0.2, vf_coef: float = 0.5,
                            compute_dtype: str = "bfloat16") -> Tuple[Dict, Dict]:
    """Plain PyTorch K4 on any device; returns what
    :func:`ppo_fused_grads_T` returns."""
    assert compute_dtype in ("bfloat16", "float32"), compute_dtype
    T, S, nb = obs_t.shape
    A = actions_t.shape[1]
    m = T * nb
    inv_m = 1.0 / m
    rnd = bf16_round if compute_dtype == "bfloat16" else (lambda x: x)

    def tanh_grad(h):  # 1 - h*h, in bf16 when the activations are
        return rnd(1.0 - rnd(h * h))

    trunk, w_head, b_head, log_std = transpose_params(params)
    x = obs_t.permute(1, 0, 2).reshape(S, m)  # samples ordered (t, env)
    act = actions_t.permute(1, 0, 2).reshape(A, m)
    old, adv, ret = (v.reshape(m) for v in (old_logp, adv, returns))
    with full_float32_matmul():
        hs = [rnd(x)]
        for w, b in trunk:
            hs.append(rnd(torch.tanh(rnd(w) @ hs[-1] + b[:, None])))
        mv = rnd(w_head) @ hs[-1] + b_head[:, None]
        inv_std = torch.exp(-log_std)[:, None]
        z = (act - mv[:A]) * inv_std
        terms = ((-0.5 * z) * z - log_std[:, None]) - 0.5 * _LOG_2PI
        logp = terms[0]
        for a in range(1, A):
            logp = logp + terms[a]
        ratio = torch.exp(logp - old)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
        vf_err = mv[A] - ret
        f32 = torch.float32
        inside = ((ratio > 1.0 - clip_eps) & (ratio < 1.0 + clip_eps)).to(f32)
        take1 = (pg1 < pg2).to(f32)
        tie = (pg1 == pg2).to(f32)
        branch = take1 + (1.0 - take1 - tie) * inside + 0.5 * tie * (1.0 + inside)
        dratio = -(adv * inv_m) * branch
        dlogp = dratio * ratio
        cv = float(torch.tensor(vf_coef, dtype=f32) * torch.tensor(inv_m, dtype=f32))
        dmv = torch.cat([dlogp * (z * inv_std), (cv * vf_err)[None]], dim=0)  # (A+1, M)
        dh = rnd(w_head).T @ rnd(dmv)
        dwh = rnd(dmv) @ hs[-1].T
        dbh = dmv.sum(dim=1)
        dlstd = (dlogp * (z * z - 1.0)).sum(dim=1)
        dws, dbs = [None] * len(trunk), [None] * len(trunk)
        for li in range(len(trunk) - 1, -1, -1):
            dz = dh * tanh_grad(hs[li + 1])
            dws[li] = rnd(dz) @ hs[li].T
            dbs[li] = dz.sum(dim=1)
            if li > 0:
                dh = rnd(trunk[li][0]).T @ rnd(dz)
    metrics = {
        "pg_loss": torch.sum(-torch.minimum(pg1, pg2)) / m,
        "vf_loss": torch.sum((0.5 * vf_err) * vf_err) / m,
        "approx_kl": torch.sum(old - logp) / m,
    }
    return _grads_dict(len(trunk), A, dws, dbs, dwh, dbh, dlstd), metrics


# ------------------------------------------------------------ kernel wrapper
class PpoKernelParams(ctypes.Structure):
    """``struct PpoKernelParams`` in ``csrc/fused_ppo.cu``."""

    _fields_ = [
        ("n_steps", ctypes.c_int),
        ("n_envs", ctypes.c_int),
        ("s_dim", ctypes.c_int),
        ("a_dim", ctypes.c_int),
        ("h0", ctypes.c_int),
        ("h1", ctypes.c_int),
        ("inv_m", ctypes.c_float),
        ("clip_lo", ctypes.c_float),
        ("clip_hi", ctypes.c_float),
        ("vf_coef", ctypes.c_float),
        ("half_log_2pi", ctypes.c_float),
    ]


class _View(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("st", ctypes.c_longlong), ("sc", ctypes.c_longlong)]


class _Inputs(ctypes.Structure):
    _fields_ = [("obs", _View), ("act", _View), ("old_logp", _View), ("adv", _View), ("ret", _View)]


def _view(x: torch.Tensor, name: str) -> _View:
    if x.dtype != torch.float32 or x.device.type != "cuda":
        raise ValueError(f"{name} must be a float32 CUDA tensor; got {x.dtype} on {x.device}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride over envs; got strides {x.stride()}")
    if x.dim() == 3:
        return _View(x.data_ptr(), x.stride(0), x.stride(1))
    return _View(x.data_ptr(), x.stride(0), 0)


def _kernels() -> ctypes.CDLL:
    lib = _build.load("fused_ppo.cu")
    if not getattr(lib, "_mbt_declared", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mbt_ppo_fused_grads_T.argtypes = [ptr, i32, ptr, i32] + [ptr] * 12 + [ptr]
        lib.mbt_ppo_fused_grads_T.restype = i32
        lib._mbt_declared = True
    return lib


def ppo_fused_grads_T(params, obs_t: torch.Tensor, actions_t: torch.Tensor, old_logp: torch.Tensor,
                      adv: torch.Tensor, returns: torch.Tensor, clip_eps: float = 0.2,
                      vf_coef: float = 0.5, compute_dtype: str = "bfloat16") -> Tuple[Dict, Dict]:
    """K4: grads of the PPO loss over one minibatch (each scaled by
    ``1/(T*nb)``) as a ``{parameter name: tensor}`` dict, and the metrics
    ``pg_loss``, ``vf_loss``, ``approx_kl`` (0-d tensors).  On CPU tensors
    this is :func:`ppo_fused_grads_T_plain`; on CUDA it launches the
    kernel."""
    assert compute_dtype in ("bfloat16", "float32"), compute_dtype
    device = obs_t.device
    if device.type == "cpu":
        return ppo_fused_grads_T_plain(params, obs_t, actions_t, old_logp, adv, returns,
                                       clip_eps, vf_coef, compute_dtype)
    if device.type != "cuda":
        raise ValueError(f"the update kernel runs on CUDA devices, not {device}")
    T, S, nb = obs_t.shape
    A = actions_t.shape[1]
    trunk, w_head, b_head, log_std = transpose_params(params)
    widths = [w.shape[0] for w, _ in trunk]
    if len(trunk) != 2 or any(w % 64 or not 0 < w <= 256 for w in widths):
        raise ValueError(
            f"the K4 kernel takes a two-layer trunk with widths a multiple of 64 up to 256; "
            f"got {tuple(widths)}"
        )
    if nb % _ENV_TILE or S > 8 or A > 4:
        raise ValueError(f"the K4 kernel takes nb a multiple of {_ENV_TILE}, S <= 8, A <= 4; got {nb}, {S}, {A}")
    for name, x, shape in (("actions_t", actions_t, (T, A, nb)), ("old_logp", old_logp, (T, nb)),
                           ("adv", adv, (T, nb)), ("returns", returns, (T, nb))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}; got {tuple(x.shape)}")
    inputs = _Inputs(_view(obs_t, "obs_t"), _view(actions_t, "actions_t"), _view(old_logp, "old_logp"),
                     _view(adv, "adv"), _view(returns, "returns"))
    h0, h1 = widths
    m = T * nb
    kp = PpoKernelParams(
        n_steps=T, n_envs=nb, s_dim=S, a_dim=A, h0=h0, h1=h1, inv_m=1.0 / m,
        clip_lo=1.0 - clip_eps, clip_hi=1.0 + clip_eps, vf_coef=vf_coef, half_log_2pi=0.5 * _LOG_2PI,
    )
    bf16 = compute_dtype == "bfloat16"
    wdt = torch.bfloat16 if bf16 else torch.float32
    (w0, b0), (w1, b1) = trunk
    wf0 = w0.T.contiguous().to(wdt)  # (S, h0)
    wf1 = w1.T.contiguous().to(wdt)  # (h0, h1)
    wb1 = w1.contiguous().to(wdt)  # (h1, h0)
    bias = torch.cat([b0, b1]).contiguous()
    w_head = (bf16_round(w_head) if bf16 else w_head).contiguous()
    b_head, log_std = b_head.contiguous(), log_std.contiguous()
    n_small = h0 * S + h0 + h1 + (A + 1) * h1 + (A + 1) + A + 3
    f32 = torch.float32
    dmv = torch.empty((A + 1, T, nb), dtype=f32, device=device)
    part1 = torch.empty((_PASS1_CTAS, n_small), dtype=f32, device=device)
    part2 = torch.empty((_PASS2_PARTS, h1, h0), dtype=f32, device=device)
    small = torch.empty(n_small, dtype=f32, device=device)
    dw1 = torch.empty((h1, h0), dtype=f32, device=device)
    index, stream = _build.device_stream(device)
    rc = _kernels().mbt_ppo_fused_grads_T(
        ctypes.byref(kp), index, ctypes.byref(inputs), int(bf16),
        wf0.data_ptr(), wf1.data_ptr(), wb1.data_ptr(), bias.data_ptr(), w_head.data_ptr(),
        b_head.data_ptr(), log_std.data_ptr(), dmv.data_ptr(), part1.data_ptr(), part2.data_ptr(),
        small.data_ptr(), dw1.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"ppo_fused_grads_T kernel launch failed: CUDA error {rc}")
    _build.count_launch("ppo_fused_grads_T")
    sizes = [h0 * S, h0, h1, (A + 1) * h1, A + 1, A, 3]
    dw0, db0, db1, dwh, dbh, dlstd, sums = torch.split(small, sizes)
    grads = _grads_dict(2, A, [dw0.view(h0, S), dw1], [db0, db1], dwh.view(A + 1, h1), dbh, dlstd)
    metrics = {"pg_loss": sums[0] / m, "vf_loss": sums[1] / m, "approx_kl": sums[2] / m}
    return grads, metrics
