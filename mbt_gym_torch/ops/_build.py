"""Build, load and count the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface; ``csrc/*.cuh`` are the
headers they share.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/mbt_gym_torch/`` at the repository root (git-ignored), named by a
hash of its source and flags so an edit rebuilds it, then loaded with
``ctypes``.  Nothing here runs at import time: the CPU tests import every
module and have no ``nvcc``.

``--fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions compute them; ``--use_fast_math`` is deliberately
absent, so ``expf``/``logf``/``cosf``/``sqrtf`` are the accurate CUDA ones.

The launch counters are plain integers: a wrapper adds one where it
launches its kernel and nowhere else, and a replay of a captured graph
adds the launches its capture recorded, so a run can show that its main
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mbt_gym_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

launch_counts: Dict[str, int] = {
    "as_episode": 0,
    "as_episode_trajectories": 0,
    "mlp_rollout": 0,
    "ppo_fused_grads_T": 0,
    "det_rollout": 0,
    "oe_episode": 0,
    "cj_episode": 0,
    "ppo_fused_grads": 0,
}

# The compiler's register and spill report of each source built with
# ``ptxas_verbose``.
ptxas_reports: Dict[str, str] = {}

# Every kernel source, in the order the kernels were ported.
SOURCES = ("as_episode.cu", "mlp_rollout.cu", "fused_ppo.cu", "det_rollout.cu", "oe_episode.cu", "cj_episode.cu")

_LOADED: Dict[str, ctypes.CDLL] = {}


def count_launch(kernel: str, n: int = 1) -> None:
    """Add ``n`` launches of ``kernel``: one where a wrapper launches it,
    or the launches a CUDA graph's capture recorded, at each replay
    (:mod:`mbt_gym_torch.compiled`)."""
    launch_counts[kernel] += n


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def device_stream(device: torch.device) -> Tuple[int, int]:
    """(index, current stream handle) of a CUDA device: what every C entry
    point takes to launch on PyTorch's current stream."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built on the machine with the card"
        )
    return path


def build(source: str, ptxas_verbose: bool = False) -> Path:
    """Compile ``csrc/<source>`` into a shared library unless a build of
    the same source and flags exists; return the library's path.  With
    ``ptxas_verbose`` the compiler's register and spill report is printed."""
    src = CSRC / source
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if ptxas_verbose else ())
    # the shared headers are part of every source's build key
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.exists() and not ptxas_verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [nvcc(), *flags, "-o", str(tmp), str(src)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{proc.stderr}")
    if ptxas_verbose:
        print(proc.stderr, end="")
        ptxas_reports[source] = proc.stderr
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built at first use."""
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(str(build(source)))
    return _LOADED[source]
