"""Fused PPO updates K4 and K7 (counterparts of ``ppo_fused_grads_T`` and
``ppo_fused_grads`` in ``mbt_gym_tpu/ops/fused_ppo.py``), beside their
plain PyTorch versions.

Both compute the gradient of the PPO clipped-surrogate + value loss over
one minibatch, forward and backward in one CUDA kernel launch sequence
(``csrc/fused_ppo.cu``; its source note gives the bound and the
deterministic three-pass design), with the loss metrics.  Advantages
arrive already normalised by the caller.  Grads come back in the model's
own parameter layout: a ``{parameter name: tensor}`` dict in
``model.named_parameters()``'s names, each scaled by ``1/M`` (M samples).

- :func:`ppo_fused_grads_T` replaces ``ppo_fused_grads_T`` (``_kernel_T``,
  ``ops/fused_ppo.py:392``), K4: feature-major inputs, obs ``(T, S, nb)``,
  actions ``(T, A, nb)``, old log-probs, advantages and returns ``(T, nb)``;
  each may be a strided view of an env slice of the full ``(.., N)``
  buffers (envs minor, unit stride), which the kernel reads in place.  Both
  actor-critic layouts: the shared trunk, and the separate pi/vf towers run
  as a stacked trunk (the JAX kernel's ``split_at`` mode, ``:453-478``),
  whose grads come back under ``pi.{i}.*``, ``vf.{i}.*`` and ``log_std``.
- :func:`ppo_fused_grads` replaces ``ppo_fused_grads`` (``_kernel``,
  ``ops/fused_ppo.py:634``), K7: row-major inputs, obs ``(M, S)``, actions
  ``(M, A)``, old log-probs, advantages and returns ``(M,)``, the shared
  trunk (the JAX kernel's contract).

The CUDA kernels take a two-layer trunk with per-tower widths a multiple of
64 up to 256 (the repo's 256x256 production model; a stacked carry of 512
with towers), ``S <= 8``, ``A <= 4`` and a sample count per step (``nb``,
or ``M``) a multiple of 32; the wrappers raise ``ValueError`` naming the
limit otherwise.  TPU-only parts are dropped: the T padding to a multiple
of 8 and its mask, ``swap_dw0``, the 128-lane metrics row and the VMEM tile
search.

CPU tensors run the plain versions; CUDA tensors launch the kernel or
raise.  The plain versions take any trunk depth and repeat the kernels'
arithmetic in both ``compute_dtype``s: with ``"bfloat16"`` every matmul
operand is rounded to bf16, the saved activations are rounded to bf16, and
``1 - h*h`` is evaluated in bf16 before it multiplies the float32 ``dh``;
with ``"float32"`` nothing is rounded.  Their matmuls run with TF32 off.
(The JAX row-major kernel keeps its saved activations and ``1 - h*h`` in
float32; both ports round at K4's points, so K7 and K4 agree on the same
samples.)
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from mbt_gym_torch.ops import _build
from mbt_gym_torch.ops.mlp_rollout import bf16_round, full_float32_matmul, pack_mma_a, transpose_params

_LOG_2PI = math.log(2.0 * math.pi)
_SAMPLE_TILE = 32
# observation columns K4 and K7 take (csrc/fused_ppo.cu)
MAX_S = 8
_PASS1_CTAS = 256
_PASS2_PARTS = 64


def _grads_dict(split_at: Optional[tuple], a_dim: int, dws, dbs, dwh, dbh, dlstd) -> Dict[str, torch.Tensor]:
    """The named grads from the stacked-layout ones: ``dws[i]`` ``(out, in)``
    per trunk layer (stacked pi then vf rows with towers), ``dwh`` ``(A+1,
    H)`` of the merged head; with towers only the head's in-block parts."""
    grads = {}
    if split_at is None:
        for i, (dw, db) in enumerate(zip(dws, dbs)):
            grads[f"shared.{i}.weight"] = dw
            grads[f"shared.{i}.bias"] = db
        grads["pi_head.weight"] = dwh[:a_dim]
        grads["pi_head.bias"] = dbh[:a_dim]
        grads["vf_head.weight"] = dwh[a_dim:]
        grads["vf_head.bias"] = dbh[a_dim:]
    else:
        for i, (dw, db, wo) in enumerate(zip(dws, dbs, split_at)):
            for tower, rows in (("pi", slice(0, wo)), ("vf", slice(wo, 2 * wo))):
                grads[f"{tower}.{i}.weight"] = dw[rows]
                grads[f"{tower}.{i}.bias"] = db[rows]
        n, h = len(split_at), split_at[-1]
        grads[f"pi.{n}.weight"] = dwh[:a_dim, :h].contiguous()
        grads[f"pi.{n}.bias"] = dbh[:a_dim]
        grads[f"vf.{n}.weight"] = dwh[a_dim:, h:].contiguous()
        grads[f"vf.{n}.bias"] = dbh[a_dim:]
    grads["log_std"] = dlstd
    return grads


def _tower_blocks(x: torch.Tensor, split_at: tuple, li: int):
    """The (pi, vf) row blocks of the stacked carry that layer ``li`` > 0
    reads."""
    wi = split_at[li - 1]
    return x[:wi], x[wi:]


def _plain_grads(params, x: torch.Tensor, act: torch.Tensor, old: torch.Tensor, adv: torch.Tensor,
                 ret: torch.Tensor, clip_eps: float, vf_coef: float, compute_dtype: str) -> Tuple[Dict, Dict]:
    """The plain kernel on feature-major samples: ``x (S, M)``, ``act (A,
    M)``, ``old``/``adv``/``ret`` ``(M,)``, either layout."""
    assert compute_dtype in ("bfloat16", "float32"), compute_dtype
    A, m = act.shape
    inv_m = 1.0 / m
    rnd = bf16_round if compute_dtype == "bfloat16" else (lambda x: x)

    def tanh_grad(h):  # 1 - h*h, in bf16 when the activations are
        return rnd(1.0 - rnd(h * h))

    trunk, w_head, b_head, log_std, split_at = transpose_params(params)
    trunk = [(w.to(x.device), b.to(x.device)) for w, b in trunk]
    w_head, b_head, log_std = w_head.to(x.device), b_head.to(x.device), log_std.to(x.device)

    def blocks_mm(w, h, li):
        """Layer ``li``'s product: one for the shared trunk and for layer 0,
        else one per tower on its row blocks."""
        if split_at is None or li == 0:
            return rnd(w) @ h
        wo = split_at[li]
        h_pi, h_vf = _tower_blocks(h, split_at, li)
        return torch.cat([rnd(w[:wo]) @ h_pi, rnd(w[wo:]) @ h_vf])

    with full_float32_matmul():
        hs = [rnd(x)]
        for li, (w, b) in enumerate(trunk):
            hs.append(rnd(torch.tanh(blocks_mm(w, hs[-1], li) + b[:, None])))
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
            if split_at is None or li == 0:
                dws[li] = rnd(dz) @ hs[li].T
            else:
                wo = split_at[li]
                h_pi, h_vf = _tower_blocks(hs[li], split_at, li)
                dws[li] = torch.cat([rnd(dz[:wo]) @ h_pi.T, rnd(dz[wo:]) @ h_vf.T])
            dbs[li] = dz.sum(dim=1)
            if li > 0:
                w = trunk[li][0]
                if split_at is None:
                    dh = rnd(w).T @ rnd(dz)
                else:
                    wo = split_at[li]
                    dh = torch.cat([rnd(w[:wo]).T @ rnd(dz[:wo]), rnd(w[wo:]).T @ rnd(dz[wo:])])
    metrics = {
        "pg_loss": torch.sum(-torch.minimum(pg1, pg2)) / m,
        "vf_loss": torch.sum((0.5 * vf_err) * vf_err) / m,
        "approx_kl": torch.sum(old - logp) / m,
    }
    return _grads_dict(split_at, A, dws, dbs, dwh, dbh, dlstd), metrics


def ppo_fused_grads_T_plain(params, obs_t: torch.Tensor, actions_t: torch.Tensor,
                            old_logp: torch.Tensor, adv: torch.Tensor, returns: torch.Tensor,
                            clip_eps: float = 0.2, vf_coef: float = 0.5,
                            compute_dtype: str = "bfloat16") -> Tuple[Dict, Dict]:
    """Plain PyTorch K4 on any device; returns what
    :func:`ppo_fused_grads_T` returns."""
    T, S, nb = obs_t.shape
    A = actions_t.shape[1]
    m = T * nb
    x = obs_t.permute(1, 0, 2).reshape(S, m)  # samples ordered (t, env)
    act = actions_t.permute(1, 0, 2).reshape(A, m)
    old, adv, ret = (v.reshape(m) for v in (old_logp, adv, returns))
    return _plain_grads(params, x, act, old, adv, ret, clip_eps, vf_coef, compute_dtype)


def ppo_fused_grads_plain(params, obs: torch.Tensor, actions: torch.Tensor, old_logp: torch.Tensor,
                          adv: torch.Tensor, returns: torch.Tensor, clip_eps: float = 0.2,
                          vf_coef: float = 0.5, compute_dtype: str = "bfloat16") -> Tuple[Dict, Dict]:
    """Plain PyTorch K7 on any device; returns what
    :func:`ppo_fused_grads` returns."""
    _require_shared(params)
    return _plain_grads(params, obs.T, actions.T, old_logp, adv, returns, clip_eps, vf_coef, compute_dtype)


def _require_shared(params) -> None:
    if not params.shared_trunk:
        raise ValueError(
            "ppo_fused_grads (K7) takes the shared-trunk layout, as the JAX kernel does; the "
            "separate pi/vf towers go through ppo_fused_grads_T's stacked-trunk mode"
        )


# ------------------------------------------------------------ kernel wrappers
class PpoKernelParams(ctypes.Structure):
    """``struct PpoKernelParams`` in ``csrc/fused_ppo.cu``."""

    _fields_ = [
        ("n_steps", ctypes.c_int),
        ("n_envs", ctypes.c_int),
        ("s_dim", ctypes.c_int),
        ("a_dim", ctypes.c_int),
        ("h0", ctypes.c_int),
        ("h1", ctypes.c_int),
        ("towers", ctypes.c_int),
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


def _check_float32_cuda(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32 or x.device.type != "cuda":
        raise ValueError(f"{name} must be a float32 CUDA tensor; got {x.dtype} on {x.device}")


def _view_T(x: torch.Tensor, name: str) -> _View:
    """A feature-major ``(T, C, nb)`` or ``(T, nb)`` view, envs unit-stride."""
    _check_float32_cuda(x, name)
    if x.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride over envs; got strides {x.stride()}")
    if x.dim() == 3:
        return _View(x.data_ptr(), x.stride(0), x.stride(1))
    return _View(x.data_ptr(), x.stride(0), 0)


def _view_rows(x: torch.Tensor, name: str) -> _View:
    """A row-major ``(M, C)`` or ``(M,)`` tensor: ``sc`` is the row stride,
    channels contiguous."""
    _check_float32_cuda(x, name)
    if x.dim() == 2 and x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError(f"{name} must have contiguous rows; got strides {x.stride()}")
    return _View(x.data_ptr(), 0, x.stride(0))


def _kernels() -> ctypes.CDLL:
    lib = _build.load("fused_ppo.cu")
    if not getattr(lib, "_mbt_declared", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.mbt_ppo_fused_grads_T, lib.mbt_ppo_fused_grads):
            fn.argtypes = [ptr, i32, ptr, i32] + [ptr] * 12 + [ptr]
            fn.restype = i32
        lib._mbt_declared = True
    return lib


def check_kernel_limits(params, samples_per_step: int, s_dim: int, a_dim: int, label: str) -> tuple:
    """``(towers, h0, h1)`` of ``params`` if the CUDA kernels take it with
    ``samples_per_step`` (``nb``, or ``M`` for K7), ``S`` and ``A``; else
    ``ValueError`` naming the limit."""
    tp = transpose_params(params)
    widths = tuple(tp.split_at) if tp.split_at is not None else tuple(w.shape[0] for w, _ in tp.trunk)
    if len(widths) != 2 or any(w % 64 or not 0 < w <= 256 for w in widths):
        raise ValueError(
            f"the {label} kernel takes a two-layer trunk with widths (per tower) a multiple of 64 "
            f"up to 256; got {widths}"
        )
    if samples_per_step % _SAMPLE_TILE or s_dim > MAX_S or a_dim > 4:
        raise ValueError(
            f"the {label} kernel takes a multiple of {_SAMPLE_TILE} samples per step, S <= {MAX_S} and "
            f"A <= 4; got {samples_per_step}, {s_dim}, {a_dim}"
        )
    return (1 if tp.split_at is None else 2, *widths)


def _launch(entry: str, params, n_steps: int, n_envs: int, s_dim: int, a_dim: int, inputs: _Inputs,
            clip_eps: float, vf_coef: float, compute_dtype: str, device: torch.device,
            label: str) -> Tuple[Dict, Dict]:
    """Check the layout against the kernel's limits, pack the weights,
    launch ``entry`` and unpack the grads."""
    towers, h0, h1 = check_kernel_limits(params, n_envs, s_dim, a_dim, label)
    trunk, w_head, b_head, log_std, split_at = transpose_params(params)
    H0, H1 = towers * h0, towers * h1
    m = n_steps * n_envs
    kp = PpoKernelParams(
        n_steps=n_steps, n_envs=n_envs, s_dim=s_dim, a_dim=a_dim, h0=h0, h1=h1, towers=towers,
        inv_m=1.0 / m, clip_lo=1.0 - clip_eps, clip_hi=1.0 + clip_eps, vf_coef=vf_coef,
        half_log_2pi=0.5 * _LOG_2PI,
    )
    bf16 = compute_dtype == "bfloat16"
    wdt = torch.bfloat16 if bf16 else torch.float32
    (w0, b0), (w1, b1) = ((w.to(device), b.to(device)) for w, b in trunk)
    wf0 = w0.T.contiguous().to(wdt)  # (S, H0), stacked (in, out)
    wb1 = w1.reshape(towers, h1, h0).contiguous().to(wdt)  # per tower (out, in)
    wf1 = wb1.transpose(1, 2).contiguous()  # per tower (in, out)
    if bf16:  # the tensor-core passes read both in mma fragment order
        wb1, wf1 = pack_mma_a(wb1.reshape(H1, h0)), pack_mma_a(wf1.reshape(H0, h1))
    bias = torch.cat([b0, b1]).contiguous()
    w_head = w_head.to(device)
    w_head = (bf16_round(w_head) if bf16 else w_head).contiguous()
    b_head, log_std = b_head.to(device).contiguous(), log_std.to(device).contiguous()
    sizes = [H0 * s_dim, H0, H1, (a_dim + 1) * H1, a_dim + 1, a_dim, 3]
    f32 = torch.float32
    dmv = torch.empty((a_dim + 1, m), dtype=f32, device=device)
    part1 = torch.empty((_PASS1_CTAS, sum(sizes)), dtype=f32, device=device)
    part2 = torch.empty((_PASS2_PARTS, H1, h0), dtype=f32, device=device)
    small = torch.empty(sum(sizes), dtype=f32, device=device)
    dw1 = torch.empty((H1, h0), dtype=f32, device=device)
    index, stream = _build.device_stream(device)
    rc = getattr(_kernels(), entry)(
        ctypes.byref(kp), index, ctypes.byref(inputs), int(bf16),
        wf0.data_ptr(), wf1.data_ptr(), wb1.data_ptr(), bias.data_ptr(), w_head.data_ptr(),
        b_head.data_ptr(), log_std.data_ptr(), dmv.data_ptr(), part1.data_ptr(), part2.data_ptr(),
        small.data_ptr(), dw1.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    dw0, db0, db1, dwh, dbh, dlstd, sums = torch.split(small, sizes)
    grads = _grads_dict(split_at, a_dim, [dw0.view(H0, s_dim), dw1], [db0, db1], dwh.view(a_dim + 1, H1),
                        dbh, dlstd)
    metrics = {"pg_loss": sums[0] / m, "vf_loss": sums[1] / m, "approx_kl": sums[2] / m}
    return grads, metrics


def _device_of(x: torch.Tensor, what: str) -> torch.device:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the {what} kernel runs on CUDA devices, not {x.device}")
    return x.device


def ppo_fused_grads_T(params, obs_t: torch.Tensor, actions_t: torch.Tensor, old_logp: torch.Tensor,
                      adv: torch.Tensor, returns: torch.Tensor, clip_eps: float = 0.2,
                      vf_coef: float = 0.5, compute_dtype: str = "bfloat16") -> Tuple[Dict, Dict]:
    """K4: grads of the PPO loss over one feature-major minibatch (each
    scaled by ``1/(T*nb)``) as a ``{parameter name: tensor}`` dict, and the
    metrics ``pg_loss``, ``vf_loss``, ``approx_kl`` (0-d tensors), for
    either actor-critic layout.  On CPU tensors this is
    :func:`ppo_fused_grads_T_plain`; on CUDA it launches the kernel."""
    assert compute_dtype in ("bfloat16", "float32"), compute_dtype
    device = _device_of(obs_t, "update")
    if device.type == "cpu":
        return ppo_fused_grads_T_plain(params, obs_t, actions_t, old_logp, adv, returns,
                                       clip_eps, vf_coef, compute_dtype)
    T, S, nb = obs_t.shape
    A = actions_t.shape[1]
    for name, x, shape in (("actions_t", actions_t, (T, A, nb)), ("old_logp", old_logp, (T, nb)),
                           ("adv", adv, (T, nb)), ("returns", returns, (T, nb))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}; got {tuple(x.shape)}")
    inputs = _Inputs(_view_T(obs_t, "obs_t"), _view_T(actions_t, "actions_t"), _view_T(old_logp, "old_logp"),
                     _view_T(adv, "adv"), _view_T(returns, "returns"))
    out = _launch("mbt_ppo_fused_grads_T", params, T, nb, S, A, inputs, clip_eps, vf_coef, compute_dtype,
                  device, "K4")
    _build.count_launch("ppo_fused_grads_T")
    return out


def ppo_fused_grads(params, obs: torch.Tensor, actions: torch.Tensor, old_logp: torch.Tensor,
                    adv: torch.Tensor, returns: torch.Tensor, clip_eps: float = 0.2,
                    vf_coef: float = 0.5, compute_dtype: str = "bfloat16") -> Tuple[Dict, Dict]:
    """K7: grads of the PPO loss over one row-major minibatch (each scaled
    by ``1/M``) as a ``{parameter name: tensor}`` dict, and the metrics, for
    the shared trunk.  On CPU tensors this is
    :func:`ppo_fused_grads_plain`; on CUDA it launches the kernel."""
    assert compute_dtype in ("bfloat16", "float32"), compute_dtype
    device = _device_of(obs, "update")
    if device.type == "cpu":
        return ppo_fused_grads_plain(params, obs, actions, old_logp, adv, returns,
                                     clip_eps, vf_coef, compute_dtype)
    _require_shared(params)
    M, S = obs.shape
    A = actions.shape[1]
    for name, x, shape in (("actions", actions, (M, A)), ("old_logp", old_logp, (M,)),
                           ("adv", adv, (M,)), ("returns", returns, (M,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}; got {tuple(x.shape)}")
    inputs = _Inputs(_view_rows(obs, "obs"), _view_rows(actions, "actions"), _view_rows(old_logp, "old_logp"),
                     _view_rows(adv, "adv"), _view_rows(returns, "returns"))
    out = _launch("mbt_ppo_fused_grads", params, 1, M, S, A, inputs, clip_eps, vf_coef, compute_dtype,
                  device, "K7")
    _build.count_launch("ppo_fused_grads")
    return out
