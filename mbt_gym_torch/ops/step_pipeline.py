"""Geometry of the warp-specialised step pipeline that K5
(``csrc/det_rollout.cu``) and K1 (``csrc/as_episode.cu``) run
(``csrc/step_pipeline.cuh``).

A CTA owns ``envs`` envs: ``envs / 32`` consumer warps run the env step,
one thread per env, and ``producers`` warps fill a ring of ``slots``
shared-memory slots, each holding the draws of ``chunk`` consecutive steps
(``channels`` floats per env and step) and, where it fits, the depth-table
rows those steps read (a row of each of ``table_rows`` tables per step,
``row_floats`` floats apart).
:func:`pipeline_geometry` chooses all of it from the call's shape; it is
pure and runs on the host, so the CPU tests check its arithmetic.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

H100_SMS = 132
# 227 KB of shared memory a CTA can take on the H100; the ring keeps to half
# of it, so that two CTAs can share an SM.
SMEM_PER_CTA = 232_448
SMEM_BUDGET = SMEM_PER_CTA // 2
MAX_THREADS = 512  # mbt::kMaxPipeThreads
MAX_CONSUMER_WARPS = 4
# The share of the SMs that must get a CTA before a wider CTA is taken: at
# 16,384 envs 128 CTAs of 128 envs on 128 of the 132 SMs ran faster on the
# H100 than 256 CTAs of 64 (scripts/episode_kernel_times.py --geometry).
SM_SHARE = 0.95
MAX_CHUNK = 8
SLOTS = 2
# Producer warps per consumer warp: the draws of a step (two Philox calls
# and Box-Muller on limit dynamics) cost several times the consumers' step;
# streams mode adds the consumers' stores.
PRODUCERS_PER_CONSUMER = {"stats": 3, "streams": 2}


class PipelineGeometry(ctypes.Structure):
    """``struct mbt::PipeGeometry`` in ``csrc/step_pipeline.cuh``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "envs", "producers", "chunk", "slots", "channels", "table_rows", "row_floats", "staged", "smem_bytes",
    )]


def padded(floats: int) -> int:
    """Floats of a slot row that holds a run of ``floats`` landed up to 3
    floats into its first 16-byte granule (``mbt::padded``)."""
    return (floats + 3 + 3) & ~3


def ring_bytes(envs: int, chunk: int, slots: int, channels: int, table_rows: int = 0, row_floats: int = 0) -> int:
    """Dynamic shared memory of a CTA (``mbt::ring_bytes``): ``slots``
    mbarrier pairs, then the slots, each ``chunk`` steps of ``channels``
    draw rows of ``envs + 4`` floats, then, for each of ``table_rows``
    tables, the ``chunk`` consecutive rows of ``row_floats`` in one padded
    run (none when the table is not staged)."""
    slot_floats = chunk * channels * (envs + 4) + table_rows * padded(chunk * row_floats)
    return 16 * slots + 4 * slots * slot_floats


class Geometry(NamedTuple):
    envs: int
    producers: int
    chunk: int
    slots: int
    channels: int
    table_rows: int  # tables a step reads a row of: K5's bid, ask and fill tables (0: no table)
    row_floats: int  # floats from one step's row to the next
    staged: int  # 1: the rows are staged in the ring; 0: read from global memory
    smem_bytes: int

    @property
    def table_path(self) -> str:
        """Where the consumers read the depth table: "staged" in the ring,
        "global" memory, or "none" for a policy without a table."""
        if not self.table_rows:
            return "none"
        return "staged" if self.staged else "global"

    @property
    def threads(self) -> int:
        return self.envs + 32 * self.producers

    def with_shape(self, envs: int, producers: int, chunk: int, slots: int, staged: bool = True) -> "Geometry":
        """The same call at another shape (for tuning), the table staged
        unless ``staged`` is false or the ring would not fit a CTA's shared
        memory."""
        staged = int(staged and bool(self.table_rows)
                     and ring_bytes(envs, chunk, slots, self.channels, self.table_rows, self.row_floats) <= SMEM_PER_CTA)
        smem = ring_bytes(envs, chunk, slots, self.channels, self.table_rows * staged, self.row_floats)
        return self._replace(envs=envs, producers=producers, chunk=chunk, slots=slots, staged=staged, smem_bytes=smem)

    def ctypes(self) -> PipelineGeometry:
        return PipelineGeometry(*self)


def pipeline_geometry(n: int, run_steps: int, dynamics: str, policy: str, stats_only: bool,
                      row_floats: int = 0, table_rows: int = 0) -> Geometry:
    """The pipeline geometry of one K5 or K1 call of ``n`` envs over
    ``run_steps`` steps.

    - Envs per CTA: the widest of 128, 64 and 32 that still gives
      ``SM_SHARE`` of the SMs a CTA (16,384 envs: 128 per CTA, 128 CTAs;
      8,192: 64; 4,100: 32).
    - Producer warps: ``PRODUCERS_PER_CONSUMER[mode]`` per consumer warp.
    - Channels: five on limit dynamics, the midprice normal alone on speed.
    - The table kind reads a row of each of ``table_rows`` tables a step,
      ``row_floats`` apart (K5: the bid and ask tables and their fill
      probabilities, the tables' width apart).  A slot's consecutive rows of a table are
      staged as one run, ``chunk`` steps per slot, at most ``MAX_CHUNK``,
      halved until the ring fits ``SMEM_BUDGET``; where one step's rows do
      not fit even so, the table stays in global memory.
    """
    assert n >= 1 and run_steps >= 0
    assert dynamics in ("limit", "speed") and policy in ("table", "fixed", "schedule")
    rows = table_rows if policy == "table" else 0
    width = row_floats if rows else 0
    consumers = MAX_CONSUMER_WARPS
    while consumers > 1 and -(-n // (32 * consumers)) < SM_SHARE * H100_SMS:
        consumers //= 2
    envs = 32 * consumers
    producers = PRODUCERS_PER_CONSUMER["stats" if stats_only else "streams"] * consumers
    channels = 5 if dynamics == "limit" else 1
    chunk = max(1, min(MAX_CHUNK, run_steps))
    while chunk > 1 and ring_bytes(envs, chunk, SLOTS, channels, rows, width) > SMEM_BUDGET:
        chunk //= 2
    staged = int(bool(rows) and ring_bytes(envs, chunk, SLOTS, channels, rows, width) <= SMEM_BUDGET)
    if rows and not staged:
        chunk = max(1, min(MAX_CHUNK, run_steps))
    return Geometry(envs, producers, chunk, SLOTS, channels, rows, width, staged,
                    ring_bytes(envs, chunk, SLOTS, channels, rows * staged, width))
