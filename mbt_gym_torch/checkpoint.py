"""Checkpoint / resume (counterpart of ``mbt_gym_tpu/checkpoint.py``; the
reference has none of its own, its models were saved through SB3
callbacks).

Saves and restores a bundle — typically
``{"env_state": EnvState, "train_state": PPOTrainState, "key": key}`` — as
one ``torch.save`` file that loads under ``torch.load(weights_only=True)``,
so a long training run survives preemption with its exact RNG state.

The bundle is flattened into leaves named by their path
(``train_state/params/shared/0/weight``).  Besides tensors, numpy arrays
and Python scalars, the flattener names the leaves of the objects a port
bundle holds where the JAX package holds pytrees:

- an ``nn.Module``: its ``state_dict()`` entries;
- a ``torch.optim.Adam`` (or ``AdamW``): per parameter, in the order of its
  parameter groups, ``step``, ``exp_avg`` and ``exp_avg_sq`` (and
  ``max_exp_avg_sq`` under ``amsgrad``) — zeros and step 0 where the
  optimizer has not stepped yet, which is the state Adam starts from — and
  its groups' hyperparameters, which enter the fingerprint;
- a ``torch.Generator`` (``EnvState.key``): ``get_state()``;
- NamedTuples, dataclasses, dicts, lists and tuples, field by field.

A structure fingerprint — a hash of the structure string plus every leaf's
name, shape and dtype — is stored in the file as plain JSON.  Restoring into
a template whose structure, shapes, dtypes or optimizer hyperparameters
drifted from the saved bundle raises :class:`CheckpointMismatchError`
naming the leaves only in the checkpoint, only in the template, and those
that drifted.

:func:`restore_checkpoint` loads modules, optimizers and generators in
place, into the template's own objects, so an optimizer stays bound to its
module's parameters (Adam keys its state by parameter identity); tensor
and array leaves come back as new objects on the template leaf's device
and dtype, so a file saved from the CPU restores onto a card template and
back.  A generator's state is device-specific (a CUDA generator's state
is 16 bytes, a CPU one's 5,056), so a generator restores onto a generator
of the same device type.  Zero-size leaves (the ``(N, 0)`` states of
stateless processes) are not stored: the template supplies them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

# Adam's hyperparameters that change its arithmetic; other group keys
# (foreach, fused, capturable, ...) select an implementation.
_ADAM_HYPER = ("lr", "betas", "eps", "weight_decay", "amsgrad", "maximize")


class CheckpointMismatchError(RuntimeError):
    """Saved bundle and restore template have different structure."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _adam_keys(opt: torch.optim.Optimizer, group: dict) -> Tuple[str, ...]:
    if not isinstance(opt, torch.optim.Adam):  # AdamW subclasses Adam
        raise TypeError(f"checkpoint flattens Adam optimizers; got {type(opt).__name__}")
    return ("step", "exp_avg", "exp_avg_sq") + (("max_exp_avg_sq",) if group.get("amsgrad") else ())


def _optimizer_leaves(opt: torch.optim.Optimizer, prefix: str) -> List[Tuple[str, Any]]:
    """``(name, value)`` of every state entry, in canonical form: a parameter
    Adam has not stepped yet reads step 0 and zero moments."""
    out = []
    index = 0
    for g, group in enumerate(opt.param_groups):
        for key in _ADAM_HYPER:
            if key in group:
                out.append((f"{prefix}/param_groups/{g}/{key}", ("hyper", group[key])))
        for p in group["params"]:
            state = opt.state.get(p, {})
            for key in _adam_keys(opt, group):
                if key in state:
                    value = state[key]
                elif key == "step":
                    value = torch.zeros((), dtype=torch.float32)
                else:
                    value = torch.zeros_like(p, memory_format=torch.preserve_format)
                out.append((f"{prefix}/state/{index}/{key}", value))
            index += 1
    return out


def _flatten(obj, prefix: str, leaves: List[Tuple[str, Any]]) -> str:
    """Append ``(name, leaf)`` pairs for ``obj`` to ``leaves`` and return the
    structure string of ``obj``."""
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        leaves.append((prefix or "<root>", obj))
        return "*"
    if isinstance(obj, bool) or isinstance(obj, (int, float)):
        leaves.append((prefix or "<root>", obj))
        return type(obj).__name__
    if obj is None or isinstance(obj, str):
        return repr(obj)
    if isinstance(obj, torch.Generator):
        leaves.append((prefix or "<root>", obj))
        return "Generator"
    if isinstance(obj, nn.Module):
        sd = obj.state_dict()
        for key, value in sd.items():
            leaves.append((join(key.replace(".", "/")), value))
        return f"{type(obj).__name__}[{','.join(sd)}]"
    if isinstance(obj, torch.optim.Optimizer):
        leaves.extend(_optimizer_leaves(obj, prefix))
        sizes = [len(g["params"]) for g in obj.param_groups]
        return f"{type(obj).__name__}{sizes}"
    if _is_namedtuple(obj):
        parts = [f"{f}={_flatten(getattr(obj, f), join(f), leaves)}" for f in obj._fields]
        return f"{type(obj).__name__}({', '.join(parts)})"
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        parts = [f"{f.name}={_flatten(getattr(obj, f.name), join(f.name), leaves)}"
                 for f in dataclasses.fields(obj)]
        return f"{type(obj).__name__}({', '.join(parts)})"
    if isinstance(obj, dict):
        parts = [f"{k!r}: {_flatten(obj[k], join(k), leaves)}" for k in sorted(obj, key=str)]
        return "{" + ", ".join(parts) + "}"
    if isinstance(obj, (list, tuple)):
        parts = [_flatten(v, join(i), leaves) for i, v in enumerate(obj)]
        return ("[" + ", ".join(parts) + "]") if isinstance(obj, list) else ("(" + ", ".join(parts) + ",)")
    raise TypeError(f"checkpoint cannot flatten {type(obj).__name__} at {prefix or '<root>'}")


def _is_hyper(leaf) -> bool:
    return isinstance(leaf, tuple) and len(leaf) == 2 and leaf[0] == "hyper"


def _describe(leaf) -> dict:
    if _is_hyper(leaf):
        value = leaf[1]
        return {"shape": [], "dtype": "hyperparameter", "value": list(value) if isinstance(value, tuple) else value}
    if isinstance(leaf, torch.Generator):
        state = leaf.get_state()
        return {"shape": list(state.shape), "dtype": f"generator({leaf.device.type})"}
    if isinstance(leaf, torch.Tensor):
        return {"shape": list(leaf.shape), "dtype": str(leaf.dtype).replace("torch.", "")}
    if isinstance(leaf, (np.ndarray, np.generic)):
        return {"shape": list(np.shape(leaf)), "dtype": str(np.asarray(leaf).dtype)}
    return {"shape": [], "dtype": type(leaf).__name__}


def _fingerprint(bundle) -> Tuple[dict, List[Tuple[str, Any]]]:
    leaves: List[Tuple[str, Any]] = []
    structure = _flatten(bundle, "", leaves)
    names = [name for name, _ in leaves]
    if len(set(names)) != len(names):
        raise ValueError(f"checkpoint leaf names collide: {sorted(n for n in set(names) if names.count(n) > 1)}")
    fp = {
        "treedef_sha256": hashlib.sha256(structure.encode()).hexdigest(),
        "treedef": structure,
        "leaves": [{"name": name, **_describe(leaf)} for name, leaf in leaves],
    }
    return fp, leaves


def _size(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel()
    if isinstance(leaf, (np.ndarray, np.generic)):
        return int(np.size(leaf))
    return 1


def _stored(leaf):
    """What the file holds for a leaf: CPU tensors and Python scalars only,
    so the file loads under ``weights_only=True`` anywhere."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(leaf, copy=True))
    return leaf


def _gathered(obj, mesh):
    """``obj`` with every PPO train state (a NamedTuple with ``params`` and
    ``opt_state``) and every actor-critic split over the mesh's ``model``
    axis replaced by its whole counterpart
    (:func:`mbt_gym_torch.parallel.mesh.gather_train_state`,
    :func:`~mbt_gym_torch.parallel.mesh.gather_params`)."""
    from mbt_gym_torch.parallel.mesh import gather_params, gather_train_state

    if _is_namedtuple(obj) and {"params", "opt_state"} <= set(obj._fields):
        return gather_train_state(mesh, obj)
    if isinstance(obj, nn.Module) and getattr(obj, "model_shards", (0, 1))[1] > 1:
        return gather_params(mesh, obj)
    if _is_namedtuple(obj):
        return type(obj)(*(_gathered(v, mesh) for v in obj))
    if isinstance(obj, dict):
        return {k: _gathered(v, mesh) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_gathered(v, mesh) for v in obj)
    return obj


def save_checkpoint(path: str, bundle: Any, mesh=None) -> None:
    """Write ``bundle`` to the file ``path`` (overwritten; written to a
    temporary file first and renamed, so a crash leaves the old file).

    With a ``mesh`` whose ``model`` axis splits the bundle's towers, every
    rank of the mesh calls this: the train states and models are gathered
    whole (a collective) and the mesh's rank 0 writes the file, which then
    restores into a one-process template."""
    if mesh is not None and mesh.model > 1:
        bundle = _gathered(bundle, mesh)
        if mesh.rank != 0:
            return
    path = os.path.abspath(path)
    fp, leaves = _fingerprint(bundle)
    stored = {name: (None if _size(leaf) == 0 else _stored(leaf)) for name, leaf in leaves
              if not _is_hyper(leaf)}  # the fingerprint holds the hyperparameters
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save({"fingerprint": json.dumps(fp), "leaves": stored}, tmp)
    os.replace(tmp, path)


def _mismatch(path: str, saved: dict, want: dict) -> CheckpointMismatchError:
    saved_names = {leaf["name"]: leaf for leaf in saved["leaves"]}
    want_names = {leaf["name"]: leaf for leaf in want["leaves"]}
    missing = sorted(set(saved_names) - set(want_names))
    extra = sorted(set(want_names) - set(saved_names))
    changed = sorted(n for n in set(saved_names) & set(want_names) if saved_names[n] != want_names[n])
    return CheckpointMismatchError(
        f"Checkpoint/template structure mismatch ({path}): "
        f"leaves only in checkpoint={missing}, only in template={extra}, "
        f"shape/dtype drift={changed}"
        + ("; treedef differs" if saved["treedef_sha256"] != want["treedef_sha256"] else "")
    )


def restore_checkpoint(path: str, template: Any) -> Any:
    """Restore the bundle at ``path`` into ``template``'s structure.

    Modules, optimizers and generators in the template are loaded in place
    and returned; tensors and arrays come back on the template leaf's
    device and dtype; Python scalars as saved; zero-size leaves are the
    template's.  Raises :class:`CheckpointMismatchError` when the template's
    fingerprint (leaf paths, shapes, dtypes, optimizer hyperparameters)
    differs from the saved one, so a positional misload cannot happen."""
    path = os.path.abspath(path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(raw, dict) or "fingerprint" not in raw:
        raise CheckpointMismatchError(
            f"{path} has no structure fingerprint — not a checkpoint written by mbt_gym_torch.checkpoint."
        )
    saved = json.loads(raw["fingerprint"])
    want, _ = _fingerprint(template)
    if saved["treedef_sha256"] != want["treedef_sha256"] or saved["leaves"] != want["leaves"]:
        raise _mismatch(path, saved, want)
    stored: Dict[str, Any] = raw["leaves"]
    return _rebuild(template, "", stored)


def _tensor_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return value.to(device=like.device, dtype=like.dtype)


def _restore_optimizer(opt: torch.optim.Optimizer, prefix: str, stored: Dict[str, Any]) -> None:
    state: Dict[int, dict] = {}
    index = 0
    for group in opt.param_groups:
        for _ in group["params"]:
            state[index] = {key: stored[f"{prefix}/state/{index}/{key}"] for key in _adam_keys(opt, group)}
            index += 1
    sd = opt.state_dict()
    # load_state_dict casts the moments to each parameter's device and
    # dtype and keeps ``step`` as given (a CPU float32 scalar, as Adam
    # keeps it unless capturable or fused)
    opt.load_state_dict({"state": state, "param_groups": sd["param_groups"]})


def _rebuild(obj, prefix: str, stored: Dict[str, Any]):
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    name = prefix or "<root>"
    if isinstance(obj, torch.Tensor):
        value = stored[name]
        return obj if value is None else _tensor_like(value, obj)
    if isinstance(obj, (np.ndarray, np.generic)):
        value = stored[name]
        if value is None:
            return obj
        arr = value.numpy().astype(np.asarray(obj).dtype, copy=False)
        return arr if isinstance(obj, np.ndarray) else arr[()]
    if isinstance(obj, bool) or isinstance(obj, (int, float)):
        return type(obj)(stored[name])
    if obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, torch.Generator):
        obj.set_state(stored[name])
        return obj
    if isinstance(obj, nn.Module):
        sd = obj.state_dict()
        new = {}
        for key, value in sd.items():
            v = stored[join(key.replace(".", "/"))]
            new[key] = value if v is None else v
        obj.load_state_dict(new)  # copies into the existing tensors
        return obj
    if isinstance(obj, torch.optim.Optimizer):
        _restore_optimizer(obj, prefix, stored)
        return obj
    if _is_namedtuple(obj):
        return type(obj)(*(_rebuild(getattr(obj, f), join(f), stored) for f in obj._fields))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: _rebuild(getattr(obj, f.name), join(f.name), stored) for f in dataclasses.fields(obj)
                    if f.init})
    if isinstance(obj, dict):
        return type(obj)((k, _rebuild(v, join(k), stored)) for k, v in obj.items())
    if isinstance(obj, list):
        return [_rebuild(v, join(i), stored) for i, v in enumerate(obj)]
    if isinstance(obj, tuple):
        return tuple(_rebuild(v, join(i), stored) for i, v in enumerate(obj))
    raise TypeError(f"checkpoint cannot restore {type(obj).__name__} at {name}")
