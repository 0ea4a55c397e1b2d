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

The CUDA kernels take what the JAX kernels take: any trunk up to
``MAX_LAYERS`` (64) layers, a cap far past any trunk either package
trains, any per-tower width, any ``S``, ``A <= 4`` and a sample count per
step (``nb``, or ``M``) a multiple of 32; the wrappers raise
``ValueError`` naming the limit otherwise (:func:`check_kernel_limits`),
and :func:`memory_refusal` names a trunk whose weights and scratch exceed
the card's free memory.  One instantiation of each pass and route serves
every depth (``csrc/fused_ppo.cu``): pass 1 keeps its activation tiles in
shared memory where they fit (:func:`pass1_smem_bytes`) and in a
device-memory scratch otherwise, and pass 2 splits a layer's input width
into blocks of 256 columns.  Before a launch every
hidden width is padded to a multiple of 64 (:func:`pad_transposed`; a
pass-2 CTA owns 64 rows of a layer, and its dW warp tiles split its
columns into four runs of 16-column mma tiles), each tower
inside its own block: the new rows of a layer's weight
and bias are zero, and so are the columns of the next layer or head that
read them.  The padding is exact: a padded unit computes tanh(0) = 0,
every term it adds to a sum downstream is an exact zero, its own dz is
zero (its dh reads only zero columns), so its weight and bias gradients
are exact zeros, and the gradients of the real entries are unchanged;
:func:`unpad_transposed` slices them back to the caller's shapes.
TPU-only parts are dropped: the T padding to a multiple of 8 and its mask,
``swap_dw0``, the 128-lane metrics row and the VMEM tile search.

CPU tensors run the plain versions; CUDA tensors launch the kernel or
raise.  The plain versions take any trunk depth and S and repeat the
kernels' arithmetic in both ``compute_dtype``s, each at its JAX kernel's
rounding points.  With ``"bfloat16"`` every matmul operand is rounded to
bf16 and summed in float32; K4 (JAX's ``_kernel_T``, ``:276`` and
``:314``) also rounds the saved activations to bf16 and evaluates
``1 - h*h`` in bf16 before it multiplies the float32 ``dh``, where K7
(JAX's ``_kernel``, ``:90-94`` and ``:141-142``) keeps both in float32
(:func:`plain_grads_stacked`'s ``row_major`` mode).  With ``"float32"``
nothing is rounded, and K7 and K4 compute the same bits on the same
samples.  Their matmuls run with TF32 off.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from mbt_gym_torch.ops import _build
from mbt_gym_torch.ops import mlp_rollout
from mbt_gym_torch.ops.mlp_rollout import (SMEM_OPTIN, TransposedParams, bf16_round, full_float32_matmul,
                                           pack_mma_a, transpose_params)

_LOG_2PI = math.log(2.0 * math.pi)
_SAMPLE_TILE = 32
# trunk layers the kernels take: the size of DeepParams' offset arrays
# (csrc/fused_ppo.cu kMaxLayers), far past any trunk either package trains
MAX_LAYERS = mlp_rollout.MAX_LAYERS
_PASS1_CTAS = 256
_PASS2_PARTS = 64
_ROW_BLOCK = 64  # a pass-2 CTA's rows (csrc/fused_ppo.cu kRowBlock), the multiple each width is padded to
_COL_BLOCK = 256  # at most this many input columns a pass-2 CTA (kColBlock)
_LD_BF16 = _SAMPLE_TILE + 8  # a bf16 activation tile's row stride (kLdA)
# the staged planes (h_0 .. h_{L-2}, dz_1 .. dz_{L-1}; K7 in bf16 also h_{L-1})
# are bounded by this many bytes: passes 1 and 2 run in turn over chunks of tiles
_STAGE_BYTES = 1 << 30


def _grads_dict(g: TransposedParams) -> Dict[str, torch.Tensor]:
    """The named grads from the stacked-layout ones, held in a
    :class:`TransposedParams` (``trunk`` the ``(dW (out, in), db)`` of each
    layer, stacked pi then vf rows with towers; ``w_head`` the ``(A+1, H)``
    merged head's); with towers only the head's in-block parts."""
    split_at, a_dim = g.split_at, g.log_std.shape[0]
    dwh, dbh = g.w_head, g.b_head
    grads = {}
    if split_at is None:
        for i, (dw, db) in enumerate(g.trunk):
            grads[f"shared.{i}.weight"] = dw
            grads[f"shared.{i}.bias"] = db
        grads["pi_head.weight"] = dwh[:a_dim]
        grads["pi_head.bias"] = dbh[:a_dim]
        grads["vf_head.weight"] = dwh[a_dim:]
        grads["vf_head.bias"] = dbh[a_dim:]
    else:
        for i, ((dw, db), wo) in enumerate(zip(g.trunk, split_at)):
            for tower, rows in (("pi", slice(0, wo)), ("vf", slice(wo, 2 * wo))):
                grads[f"{tower}.{i}.weight"] = dw[rows]
                grads[f"{tower}.{i}.bias"] = db[rows]
        n, h = len(split_at), split_at[-1]
        grads[f"pi.{n}.weight"] = dwh[:a_dim, :h].contiguous()
        grads[f"pi.{n}.bias"] = dbh[:a_dim]
        grads[f"vf.{n}.weight"] = dwh[a_dim:, h:].contiguous()
        grads[f"vf.{n}.bias"] = dbh[a_dim:]
    grads["log_std"] = g.log_std
    return grads


def pad_transposed(tp: TransposedParams, padded: tuple) -> TransposedParams:
    """``tp`` with each hidden (per-tower) width rounded up to ``padded``,
    exactly: every new entry is zero, each tower padded inside its own
    block, so the merged head's off-block zeros stay off-block.  Also takes
    stacked grads (the same layout).  Tensor ops only, so it runs inside a
    CUDA-graph capture; returns ``tp`` itself when nothing is padded."""
    towers = 1 if tp.split_at is None else 2
    widths = tuple(w.shape[0] // towers for w, _ in tp.trunk)
    if widths == tuple(padded):
        return tp
    trunk = []
    for li, ((w, b), wo, po) in enumerate(zip(tp.trunk, widths, padded)):
        wi, pi = (w.shape[1], w.shape[1]) if li == 0 else (widths[li - 1], padded[li - 1])
        wp = w.new_zeros((towers, po, pi))
        wp[:, :wo, :wi] = w.reshape(towers, wo, wi)
        bp = b.new_zeros((towers, po))
        bp[:, :wo] = b.reshape(towers, wo)
        trunk.append((wp.reshape(towers * po, pi), bp.reshape(-1)))
    rows = tp.w_head.shape[0]
    head = tp.w_head.new_zeros((rows, towers, padded[-1]))
    head[:, :, :widths[-1]] = tp.w_head.reshape(rows, towers, widths[-1])
    split_at = None if tp.split_at is None else tuple(padded)
    return TransposedParams(trunk, head.reshape(rows, -1), tp.b_head, tp.log_std, split_at)


def unpad_transposed(tp: TransposedParams, widths: tuple) -> TransposedParams:
    """The inverse of :func:`pad_transposed`: ``tp`` (padded params or their
    stacked grads) sliced back to the per-tower ``widths``."""
    towers = 1 if tp.split_at is None else 2
    padded = tuple(w.shape[0] // towers for w, _ in tp.trunk)
    if padded == tuple(widths):
        return tp
    trunk = []
    for li, ((w, b), wo, po) in enumerate(zip(tp.trunk, widths, padded)):
        wi, pi = (w.shape[1], w.shape[1]) if li == 0 else (widths[li - 1], padded[li - 1])
        trunk.append((w.reshape(towers, po, pi)[:, :wo, :wi].reshape(towers * wo, wi),
                      b.reshape(towers, po)[:, :wo].reshape(-1)))
    rows = tp.w_head.shape[0]
    head = tp.w_head.reshape(rows, towers, padded[-1])[:, :, :widths[-1]].reshape(rows, -1)
    split_at = None if tp.split_at is None else tuple(widths)
    return TransposedParams(trunk, head, tp.b_head, tp.log_std, split_at)


def _tower_blocks(x: torch.Tensor, split_at: tuple, li: int):
    """The (pi, vf) row blocks of the stacked carry that layer ``li`` > 0
    reads."""
    wi = split_at[li - 1]
    return x[:wi], x[wi:]


def _plain_grads(params, x: torch.Tensor, act: torch.Tensor, old: torch.Tensor, adv: torch.Tensor,
                 ret: torch.Tensor, clip_eps: float, vf_coef: float, compute_dtype: str,
                 sum_dtype: torch.dtype, row_major: bool = False) -> Tuple[Dict, Dict]:
    """The plain kernel on feature-major samples: ``x (S, M)``, ``act (A,
    M)``, ``old``/``adv``/``ret`` ``(M,)``, either layout, summing in
    ``sum_dtype``, at K7's rounding points with ``row_major``."""
    tp = transpose_params(params)
    if sum_dtype != torch.float32:
        cast = lambda v: v.to(sum_dtype)  # noqa: E731
        tp = TransposedParams([(cast(w), cast(b)) for w, b in tp.trunk], cast(tp.w_head), cast(tp.b_head),
                              cast(tp.log_std), tp.split_at)
        x, act, old, adv, ret = (cast(v) for v in (x, act, old, adv, ret))
    grads, metrics = plain_grads_stacked(tp, x, act, old, adv, ret, clip_eps, vf_coef, compute_dtype, row_major)
    return _grads_dict(grads), metrics


def plain_grads_stacked(tp: TransposedParams, x: torch.Tensor, act: torch.Tensor, old: torch.Tensor,
                        adv: torch.Tensor, ret: torch.Tensor, clip_eps: float, vf_coef: float,
                        compute_dtype: str, row_major: bool = False) -> Tuple[TransposedParams, Dict]:
    """The plain kernel on the kernels' view of the params (``tp``, any
    depth and widths): the grads in the same stacked layout, and the
    metrics.  In bf16 every matmul operand is rounded; K4's mode also
    rounds the saved activations and ``1 - h*h``, where ``row_major`` (K7,
    as JAX's ``_kernel``) keeps both in float32."""
    assert compute_dtype in ("bfloat16", "float32"), compute_dtype
    A, m = act.shape
    inv_m = 1.0 / m
    # bf16 rounding that keeps the dtype (bf16_round for float32 sums)
    rnd = (lambda v: v.to(torch.bfloat16).to(v.dtype)) if compute_dtype == "bfloat16" else (lambda v: v)
    saved = (lambda v: v) if row_major else rnd  # the saved activations
    operand = rnd if row_major else (lambda v: v)  # and as matmul operands (K4 saved them rounded)

    def tanh_grad(h):  # 1 - h*h, in bf16 when the saved activations are
        return 1.0 - h * h if row_major else rnd(1.0 - rnd(h * h))

    trunk, w_head, b_head, log_std, split_at = tp
    trunk = [(w.to(x.device), b.to(x.device)) for w, b in trunk]
    w_head, b_head, log_std = w_head.to(x.device), b_head.to(x.device), log_std.to(x.device)

    def blocks_mm(w, h, li):
        """Layer ``li``'s product: one for the shared trunk and for layer 0,
        else one per tower on its row blocks."""
        h = operand(h)
        if split_at is None or li == 0:
            return rnd(w) @ h
        wo = split_at[li]
        h_pi, h_vf = _tower_blocks(h, split_at, li)
        return torch.cat([rnd(w[:wo]) @ h_pi, rnd(w[wo:]) @ h_vf])

    with full_float32_matmul():
        hs = [rnd(x)]
        for li, (w, b) in enumerate(trunk):
            hs.append(saved(torch.tanh(blocks_mm(w, hs[-1], li) + b[:, None])))
        mv = rnd(w_head) @ operand(hs[-1]) + b_head[:, None]
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
        dwh = rnd(dmv) @ operand(hs[-1]).T
        dbh = dmv.sum(dim=1)
        dlstd = (dlogp * (z * z - 1.0)).sum(dim=1)
        dws, dbs = [None] * len(trunk), [None] * len(trunk)
        for li in range(len(trunk) - 1, -1, -1):
            dz = dh * tanh_grad(hs[li + 1])
            if split_at is None or li == 0:
                dws[li] = rnd(dz) @ operand(hs[li]).T
            else:
                wo = split_at[li]
                h_pi, h_vf = _tower_blocks(operand(hs[li]), split_at, li)
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
    return TransposedParams(list(zip(dws, dbs)), dwh, dbh, dlstd, split_at), metrics


def ppo_fused_grads_T_plain(params, obs_t: torch.Tensor, actions_t: torch.Tensor,
                            old_logp: torch.Tensor, adv: torch.Tensor, returns: torch.Tensor,
                            clip_eps: float = 0.2, vf_coef: float = 0.5, compute_dtype: str = "bfloat16",
                            sum_dtype: torch.dtype = torch.float32) -> Tuple[Dict, Dict]:
    """Plain PyTorch K4 on any device; returns what
    :func:`ppo_fused_grads_T` returns.  ``sum_dtype=torch.float64`` keeps
    the bf16 rounding points and sums in float64: the reference against
    which the card's checks measure how far two float32 summation orders
    may drift apart on deep bf16 trunks."""
    T, S, nb = obs_t.shape
    A = actions_t.shape[1]
    m = T * nb
    x = obs_t.permute(1, 0, 2).reshape(S, m)  # samples ordered (t, env)
    act = actions_t.permute(1, 0, 2).reshape(A, m)
    old, adv, ret = (v.reshape(m) for v in (old_logp, adv, returns))
    return _plain_grads(params, x, act, old, adv, ret, clip_eps, vf_coef, compute_dtype, sum_dtype)


def ppo_fused_grads_plain(params, obs: torch.Tensor, actions: torch.Tensor, old_logp: torch.Tensor,
                          adv: torch.Tensor, returns: torch.Tensor, clip_eps: float = 0.2,
                          vf_coef: float = 0.5, compute_dtype: str = "bfloat16",
                          sum_dtype: torch.dtype = torch.float32) -> Tuple[Dict, Dict]:
    """Plain PyTorch K7 on any device, at JAX K7's rounding points; returns
    what :func:`ppo_fused_grads` returns (``sum_dtype`` as for K4's)."""
    _require_shared(params)
    return _plain_grads(params, obs.T, actions.T, old_logp, adv, returns, clip_eps, vf_coef, compute_dtype,
                        sum_dtype, row_major=True)


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


class DeepKernelParams(ctypes.Structure):
    """``struct DeepParams`` in ``csrc/fused_ppo.cu``: the kernels' shapes
    and every offset they address by (see :func:`deep_layout`)."""

    _fields_ = [
        ("base", PpoKernelParams),
        ("n_layers", ctypes.c_int),
        ("h_max", ctypes.c_int),
        ("tile_bytes", ctypes.c_int),
        ("chunk_tiles", ctypes.c_int),
        ("p1_db", ctypes.c_int),
        ("p1_dwh", ctypes.c_int),
        ("p1_dbh", ctypes.c_int),
        ("p1_total", ctypes.c_int),
        ("dw_total", ctypes.c_int),
        ("scratch", ctypes.c_int),
        ("widths", ctypes.c_int * MAX_LAYERS),
        ("w_off", ctypes.c_int * MAX_LAYERS),
        ("b_off", ctypes.c_int * MAX_LAYERS),
        ("sh_off", ctypes.c_int * MAX_LAYERS),
        ("sdz_off", ctypes.c_int * MAX_LAYERS),
        ("rb_start", ctypes.c_int * (MAX_LAYERS + 1)),
    ]


def _kernels() -> ctypes.CDLL:
    lib = _build.load("fused_ppo.cu")
    if not getattr(lib, "_mbt_declared", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.mbt_ppo_deep_grads_T, lib.mbt_ppo_deep_grads):
            fn.argtypes = [ptr, i32, ptr, i32] + [ptr] * 13 + [ptr]
            fn.restype = i32
        lib._mbt_declared = True
    return lib


class KernelShape(NamedTuple):
    """What :func:`check_kernel_limits` finds the kernels take: the
    layout (1 shared trunk, 2 stacked towers), the caller's per-tower
    widths and the widths the kernels run, each padded to a multiple of 64."""

    towers: int
    widths: tuple
    padded: tuple


def kernel_shape(params) -> KernelShape:
    """The :class:`KernelShape` of ``params`` (its ``hidden`` and
    ``shared_trunk``; no tensor is read), whatever the kernels' limits."""
    widths = tuple(params.hidden)
    padded = tuple(-(-w // _ROW_BLOCK) * _ROW_BLOCK for w in widths)
    return KernelShape(1 if params.shared_trunk else 2, widths, padded)


def check_kernel_limits(params, samples_per_step: int, a_dim: int, label: str) -> KernelShape:
    """The :class:`KernelShape` of ``params`` if the CUDA kernels take it
    with ``samples_per_step`` (``nb``, or ``M`` for K7) and ``A``; else
    ``ValueError`` naming the limit.  Every width and every S is taken;
    what remains is the depth cap, the 32-sample tile and JAX's action
    widths."""
    shape = kernel_shape(params)
    if not 1 <= len(shape.widths) <= MAX_LAYERS:
        raise ValueError(f"the {label} kernel takes 1-{MAX_LAYERS} trunk layers; got {len(shape.widths)}")
    if samples_per_step % _SAMPLE_TILE or a_dim > 4:
        raise ValueError(
            f"the {label} kernel takes a multiple of {_SAMPLE_TILE} samples per step and A <= 4; got "
            f"{samples_per_step}, {a_dim}"
        )
    return shape


def _prefix(sizes) -> list:
    out, total = [], 0
    for n in sizes:
        out.append(total)
        total += n
    return out


def deep_layout(shape: KernelShape, n_tiles: int, s_dim: int, a_dim: int, bf16: bool,
                row_major: bool = False) -> Dict[str, object]:
    """The kernels' offsets for ``shape``'s padded widths and a minibatch of
    ``n_tiles`` tiles of 32 samples (the fields of :class:`DeepKernelParams`
    but ``base``), and ``stage_bytes``, the staged planes of one chunk of
    ``chunk_tiles`` tiles (at most ``_STAGE_BYTES``); ``scratch``, whether
    pass 1 takes the scratch route (its shared-memory route past
    :data:`SMEM_OPTIN`), and ``scratch_bytes``, that route's buffer.
    Pass 2's blocks (``rb_start``) are a layer's row blocks times its
    column blocks of up to 256.  A tile's planes,
    ``tile_bytes`` in all, are the h planes then the dz planes, each at its
    byte offset (``sh_off``, ``sdz_off``), 32 samples a row of the operand
    type.  K7 in bf16 (``row_major``) stages its h planes in float32 and
    h_{L-1} as well, since its tanh' reads the float32 activations."""
    t, w = shape.towers, shape.padded
    n_layers = len(w)
    rows = [t * h for h in w]
    mats = [0] + [rows[li] * w[li - 1] for li in range(1, n_layers)]  # layer li's (stacked out, in) matrix
    f32_h = bf16 and row_major
    n_h = n_layers if f32_h else n_layers - 1
    value_bytes = 2 if bf16 else 4
    h_bytes = [r * _SAMPLE_TILE * (4 if f32_h else value_bytes) for r in rows[:n_h]]
    dz_bytes = [r * _SAMPLE_TILE * value_bytes for r in rows[1:]]
    stage_offsets = _prefix(h_bytes + dz_bytes)  # h_0 .. h_{n_h - 1}, then dz_1 .. dz_{L-1}
    tile_bytes = sum(h_bytes) + sum(dz_bytes)
    chunk = n_tiles if tile_bytes == 0 else max(1, min(n_tiles, _STAGE_BYTES // tile_bytes))
    p1_db = rows[0] * s_dim
    p1_dwh = p1_db + sum(rows)
    p1_dbh = p1_dwh + (a_dim + 1) * rows[-1]
    blocks = [rows[li] // _ROW_BLOCK * -(-w[li - 1] // _COL_BLOCK) for li in range(1, n_layers)]
    lay = dict(
        n_layers=n_layers, h_max=max(rows), tile_bytes=tile_bytes, chunk_tiles=chunk,
        p1_db=p1_db, p1_dwh=p1_dwh, p1_dbh=p1_dbh, p1_total=p1_dbh + (a_dim + 1) + a_dim + 3,
        dw_total=sum(mats), widths=list(w), w_off=_prefix(mats), b_off=_prefix(rows),
        sh_off=stage_offsets[:n_h], sdz_off=[0] + stage_offsets[n_h:],
        rb_start=[0] + _prefix(blocks + [0]),
        stage_bytes=chunk * tile_bytes,
    )
    scratch = pass1_smem_bytes(lay, s_dim, a_dim, shape.towers, bf16) > SMEM_OPTIN
    lay["scratch"] = int(scratch)
    lay["scratch_bytes"] = _PASS1_CTAS * 2 * lay["h_max"] * (_LD_BF16 * 2 if bf16 else _SAMPLE_TILE * 4) * scratch
    return lay


def pass1_smem_bytes(lay: Dict[str, object], s_dim: int, a_dim: int, towers: int, bf16: bool) -> int:
    """Pass 1's dynamic shared memory on its shared-memory route
    (``csrc/fused_ppo.cu`` ``pass1_smem``): the observation tile and the
    head's output, the two activation tiles, the head's weights and the
    partial sums."""
    n_head = a_dim + 1
    base = 4 * (s_dim + n_head) * _SAMPLE_TILE
    tile_row = 2 * _LD_BF16 if bf16 else 4 * _SAMPLE_TILE
    return base + 4 * (n_head * towers * lay["widths"][-1] + lay["p1_total"]) + tile_row * 2 * lay["h_max"]


def kernel_bytes(shape: KernelShape, samples: int, s_dim: int, a_dim: int, bf16: bool,
                 row_major: bool = False) -> int:
    """The device bytes one launch of K4 (K7 with ``row_major``) holds
    besides its inputs at ``shape`` and ``samples`` samples: the padded
    float32 params, their operand copies, the staged planes, the pass-1
    scratch and the partial sums."""
    lay = deep_layout(shape, samples // _SAMPLE_TILE, s_dim, a_dim, bf16, row_major)
    rows = [shape.towers * h for h in shape.padded]
    params = s_dim * rows[0] + lay["dw_total"] + sum(rows) + (a_dim + 1) * (rows[-1] + 1) + a_dim
    operands = (s_dim * rows[0] + 2 * lay["dw_total"]) * (2 if bf16 else 4)
    partials = 4 * ((_PASS1_CTAS + 1) * lay["p1_total"] + (_PASS2_PARTS + 1) * lay["dw_total"])
    return 2 * 4 * params + operands + lay["stage_bytes"] + lay["scratch_bytes"] + partials


def memory_refusal(shape: KernelShape, samples: int, s_dim: int, a_dim: int, compute_dtype: str, row_major: bool,
                   label: str, free: int) -> "str | None":
    """Why the ``label`` kernel cannot run a trunk of ``shape`` at
    ``samples`` samples a launch on a card with ``free`` bytes free, or
    None: its weights and scratch (:func:`kernel_bytes`) exceed them."""
    need = kernel_bytes(shape, samples, s_dim, a_dim, compute_dtype == "bfloat16", row_major)
    if need > free:
        return (f"the {label} kernel's weights and scratch at the trunk {shape.widths} "
                f"({'shared' if shape.towers == 1 else 'towers'}, {samples} samples a minibatch) take {need} "
                f"bytes; the card has {free} free")
    return None


def _base_params(n_steps: int, n_envs: int, s_dim: int, a_dim: int, shape: KernelShape, clip_eps: float,
                 vf_coef: float) -> PpoKernelParams:
    return PpoKernelParams(
        n_steps=n_steps, n_envs=n_envs, s_dim=s_dim, a_dim=a_dim, towers=shape.towers,
        inv_m=1.0 / (n_steps * n_envs), clip_lo=1.0 - clip_eps, clip_hi=1.0 + clip_eps, vf_coef=vf_coef,
        half_log_2pi=0.5 * _LOG_2PI,
    )


def _launch(row_major: bool, params, n_steps: int, n_envs: int, s_dim: int, a_dim: int, inputs: _Inputs,
            clip_eps: float, vf_coef: float, compute_dtype: str, device: torch.device,
            label: str) -> Tuple[Dict, Dict]:
    """Check the layout against the kernels' limits, pad the widths, launch
    K7 (``row_major``) or K4 and slice the grads back."""
    shape = check_kernel_limits(params, n_envs, a_dim, label)
    tp = pad_transposed(transpose_params(params), shape.padded)
    kp = _base_params(n_steps, n_envs, s_dim, a_dim, shape, clip_eps, vf_coef)
    grads, sums = _launch_passes(row_major, tp, shape, kp, inputs, compute_dtype == "bfloat16", device)
    m = n_steps * n_envs
    metrics = {"pg_loss": sums[0] / m, "vf_loss": sums[1] / m, "approx_kl": sums[2] / m}
    return _grads_dict(unpad_transposed(grads, shape.widths)), metrics


def _launch_passes(row_major: bool, tp: TransposedParams, shape: KernelShape, kp: PpoKernelParams,
                   inputs: _Inputs, bf16: bool, device: torch.device) -> Tuple[TransposedParams, torch.Tensor]:
    """The three passes of K7 (``row_major``) or K4 on the padded ``tp``:
    the stacked grads and the metric sums."""
    towers, w = shape.towers, shape.padded
    a_dim, s_dim = kp.a_dim, kp.s_dim
    entry = "mbt_ppo_deep_grads" if row_major else "mbt_ppo_deep_grads_T"
    lay = deep_layout(shape, kp.n_steps * kp.n_envs // _SAMPLE_TILE, s_dim, a_dim, bf16, row_major)
    wdt = torch.bfloat16 if bf16 else torch.float32
    trunk = [(wl.to(device), bl.to(device)) for wl, bl in tp.trunk]
    wf0 = trunk[0][0].T.contiguous().to(wdt)  # (S, H0), stacked (in, out)
    wbs, wfs = [], []
    for li in range(1, len(w)):
        wb = trunk[li][0].reshape(towers, w[li], w[li - 1]).to(wdt)  # per tower (out, in)
        wf = wb.transpose(1, 2).contiguous()  # per tower (in, out)
        if bf16:  # in mma fragment order: the tensor-core passes read them so
            wbs.append(pack_mma_a(wb.reshape(towers * w[li], w[li - 1])))
            wfs.append(pack_mma_a(wf.reshape(towers * w[li - 1], w[li])))
        else:
            wbs.append(wb.reshape(-1))
            wfs.append(wf.reshape(-1))
    none = torch.zeros(1, dtype=wdt, device=device)  # a valid pointer where L = 1 has no such layer
    wb_all = torch.cat(wbs) if wbs else none
    wf_all = torch.cat(wfs) if wfs else none
    bias = torch.cat([bl for _, bl in trunk]).contiguous()
    w_head = tp.w_head.to(device)
    w_head = (bf16_round(w_head) if bf16 else w_head).contiguous()
    b_head, log_std = tp.b_head.to(device).contiguous(), tp.log_std.to(device).contiguous()
    f32 = torch.float32
    stage = torch.empty(max(16, lay["stage_bytes"]), dtype=torch.uint8, device=device)  # the staged planes
    part1 = torch.empty((_PASS1_CTAS, lay["p1_total"]), dtype=f32, device=device)
    part2 = torch.empty((_PASS2_PARTS, max(1, lay["dw_total"])), dtype=f32, device=device)
    small = torch.empty(lay["p1_total"], dtype=f32, device=device)
    dw = torch.empty(max(1, lay["dw_total"]), dtype=f32, device=device)
    scratch = torch.empty(lay["scratch_bytes"], dtype=torch.uint8, device=device) if lay["scratch"] else None
    dp = DeepKernelParams(base=kp, **{k: lay[k] for k in ("n_layers", "h_max", "tile_bytes", "chunk_tiles", "p1_db",
                                                          "p1_dwh", "p1_dbh", "p1_total", "dw_total", "scratch")})
    for name in ("widths", "w_off", "b_off", "sh_off", "sdz_off", "rb_start"):
        getattr(dp, name)[:len(lay[name])] = lay[name]
    index, stream = _build.device_stream(device)
    rc = getattr(_kernels(), entry)(
        ctypes.byref(dp), index, ctypes.byref(inputs), int(bf16),
        wf0.data_ptr(), wf_all.data_ptr(), wb_all.data_ptr(), bias.data_ptr(), w_head.data_ptr(),
        b_head.data_ptr(), log_std.data_ptr(), stage.data_ptr(), part1.data_ptr(), part2.data_ptr(),
        small.data_ptr(), dw.data_ptr(), None if scratch is None else scratch.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    rows = [towers * h for h in w]
    dw0 = small[:lay["p1_db"]].view(rows[0], s_dim)
    dbs = torch.split(small[lay["p1_db"]:lay["p1_dwh"]], rows)
    dws = [dw0] + [dw[lay["w_off"][li]:lay["w_off"][li] + rows[li] * w[li - 1]].view(rows[li], w[li - 1])
                   for li in range(1, len(w))]
    dwh = small[lay["p1_dwh"]:lay["p1_dbh"]].view(a_dim + 1, rows[-1])
    dbh, dlstd, sums = torch.split(small[lay["p1_dbh"]:], [a_dim + 1, a_dim, 3])
    return TransposedParams(list(zip(dws, dbs)), dwh, dbh, dlstd, tp.split_at), sums


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
    out = _launch(False, params, T, nb, S, A, inputs, clip_eps, vf_coef, compute_dtype, device, "K4")
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
    out = _launch(True, params, 1, M, S, A, inputs, clip_eps, vf_coef, compute_dtype, device, "K7")
    _build.count_launch("ppo_fused_grads")
    return out
