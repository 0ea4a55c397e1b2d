"""Geometry of the warp-specialised step pipeline that K1 and K2
(``csrc/as_episode.cu``), K5 (``csrc/det_rollout.cu``), K6
(``csrc/oe_episode.cu``) and K8 (``csrc/cj_episode.cu``) run
(``csrc/step_pipeline.cuh``).

A CTA owns ``envs`` envs: ``envs / 32`` consumer warps run the env step,
one thread per env, and ``producers`` warps fill a ring of ``slots``
shared-memory slots, each holding the draws of ``chunk`` consecutive steps
(``channels`` floats per env and step) and, where it fits, the depth-table
rows those steps read (a row of each of ``table_rows`` tables per step,
``row_floats`` floats apart).  The wide shape (``producers == 0``) has no
ring: each thread steps one env and draws its own draws, for calls with
enough envs to fill the card one thread per env.
:func:`pipeline_geometry` chooses all of it from the call's shape; it is
pure and runs on the host, so the CPU tests check its arithmetic.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

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
SLOTS = 2
# Producer warps per consumer warp, and the most steps a slot holds, by
# mode: the draws of a step on limit dynamics (two Philox calls and
# Box-Muller) cost several times the consumers' step, and streams mode adds
# the consumers' stores.  On speed dynamics a step draws one normal and the
# stats consumers' chain is a few float ops, so the producers set the pace:
# as many as the CTA holds (up to 7 a consumer warp) and long slots.  K6 at
# 8,192 x 200 on an NVIDIA H100 80GB HBM3 at 700.00 W
# (scripts/episode_kernel_times.py --geometry, one call; 64-env CTAs):
# 0.0275 ms with 6 producer warps and 8-step slots, 0.0235 with 14 and 8,
# 0.0205 with 14 and 16, 0.0192 with 14 and 32, 0.0194 with 14 and 50;
# K5's fixed-action stats mode on the same config 0.0277 and 0.0260 ms.
# K2's streams ("as streams", every output layout of as_episode.cu) keep
# the streams mode's producers and take 16-step slots.  Its trajectory
# layout at 16,384 x 200 on an NVIDIA H100 80GB HBM3 at 700.00 W
# (scripts/episode_kernel_times.py --geometry, one call; 128-env CTAs):
# 0.0530 ms with 8 producer warps and 8-step slots, 0.0513 with 16, 0.0514
# with 32 (but 8% slower than 16 at 24,576 envs), 0.0512 with 16 and three
# slots, 0.0525 with 12 producer warps and 16.
PRODUCERS_PER_CONSUMER = {"stats": 3, "streams": 2, "speed stats": 7, "as streams": 2}
MAX_CHUNK = {"stats": 8, "streams": 8, "speed stats": 32, "as streams": 16}
# The wide shape: CTAs of WIDE_ENVS threads, one env each (mbt::kWideEnvs),
# taken by the kernels that have it (K1, K6, K8; K2 below) from WIDE_MIN_ENVS envs on,
# where one thread per env fills the card and the producers' warps only add
# work.  Device times on an NVIDIA H100 80GB HBM3 at 700.00 W
# (scripts/episode_kernel_times.py --sweep, --geometry pipeline against
# --geometry wide, one call): at 32,768 envs the pipeline ran K1, K6 and K8
# in 0.0811 / 0.0544 / 0.3935 ms against the wide shape's 0.0877 / 0.0631 /
# 0.5296; at 49,152 the two were within 2% of each other; at 65,536 the
# wide shape was ahead on all three (0.1527 / 0.0979 / 0.7425 against
# 0.1538 / 0.1003 / 0.7628 ms); at 1,048,576, in another call, by 9-14%.
WIDE_ENVS = 128
WIDE_MIN_ENVS = 65_536
# K2 stores every step, and its wide shape overtakes its pipeline at fewer
# envs than K1's, K6's and K8's: its trajectory layout (--sweep, --geometry
# pipeline against wide, one call, the same card) ran 0.0514 against
# 0.0691 ms at 16,384 envs, 0.0902 against 0.0889 at 20,480, 0.0904 against
# 0.0894 at 32,768 and 0.1332 against 0.1251 at 49,152.  Sizes between
# 16,384 and 20,480 were not timed; from 16,897 envs on the pipeline's
# 128-env CTAs no longer fit one to an SM.
WIDE_MIN_ENVS_BY_MODE = {"as streams": 20_480}


def wide_min_envs(mode: str) -> int:
    """The env count from which a kernel with the wide shape takes it, by
    pipeline mode."""
    return WIDE_MIN_ENVS_BY_MODE.get(mode, WIDE_MIN_ENVS)


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
    def shape(self) -> str:
        """"wide" (one thread per env, no ring) or "pipeline"."""
        return "wide" if self.producers == 0 else "pipeline"

    @property
    def threads(self) -> int:
        return self.envs + 32 * self.producers

    def with_shape(self, envs: int, producers: int, chunk: int, slots: int, staged: bool = True) -> "Geometry":
        """The same call at another shape (for tuning), the table staged
        unless ``staged`` is false or the ring would not fit a CTA's shared
        memory; ``producers == 0`` is the wide shape, whatever the rest."""
        if producers == 0:
            return wide_geometry(self.channels, self.table_rows, self.row_floats)
        staged = int(staged and bool(self.table_rows)
                     and ring_bytes(envs, chunk, slots, self.channels, self.table_rows, self.row_floats) <= SMEM_PER_CTA)
        smem = ring_bytes(envs, chunk, slots, self.channels, self.table_rows * staged, self.row_floats)
        return self._replace(envs=envs, producers=producers, chunk=chunk, slots=slots, staged=staged, smem_bytes=smem)

    def ctypes(self) -> PipelineGeometry:
        return PipelineGeometry(*self)


def wide_geometry(channels: int, table_rows: int = 0, row_floats: int = 0) -> Geometry:
    """The wide shape: CTAs of ``WIDE_ENVS`` threads, no producers, no ring;
    a table is read from global memory."""
    return Geometry(WIDE_ENVS, 0, 1, 0, channels, table_rows, row_floats, 0, 0)


def pipeline_geometry(n: int, run_steps: int, dynamics: str, policy: str, stats_only: bool,
                      row_floats: int = 0, table_rows: int = 0, wide: bool = True,
                      mode: Optional[str] = None, channels: Optional[int] = None) -> Geometry:
    """The pipeline geometry of one K1, K2, K5, K6 or K8 call of ``n`` envs
    over ``run_steps`` steps.

    - Mode: "stats", "streams", or "speed stats" for the stats mode of
      speed dynamics, from ``stats_only`` and ``dynamics``, unless ``mode``
      names one (K2: "as streams").
    - From :func:`wide_min_envs` of the mode on, a kernel with the wide
      shape (``wide``: K1, K2, K6 and K8; K5 has none) takes it.
    - Envs per CTA: the widest of 128, 64 and 32 that still gives
      ``SM_SHARE`` of the SMs a CTA (16,384 envs: 128 per CTA, 128 CTAs;
      8,192: 64; 4,100: 32).
    - Producer warps: ``PRODUCERS_PER_CONSUMER[mode]`` per consumer warp,
      as far as ``MAX_THREADS`` allows.
    - Channels: five on limit dynamics, the midprice normal alone on speed,
      unless ``channels`` names another count (K5's general process kinds:
      8 on the market-making dynamics, 2 on speed).
    - The table kind reads a row of each of ``table_rows`` tables a step,
      ``row_floats`` apart (K5: the bid and ask tables and their fill
      probabilities, the tables' width apart).  A slot's consecutive rows of a table are
      staged as one run, ``chunk`` steps per slot, at most ``MAX_CHUNK[mode]``,
      halved until the ring fits ``SMEM_BUDGET``; where one step's rows do
      not fit even so, the table stays in global memory.
    """
    assert n >= 1 and run_steps >= 0
    assert dynamics in ("limit", "speed") and policy in ("table", "fixed", "schedule")
    rows = table_rows if policy == "table" else 0
    width = row_floats if rows else 0
    channels = channels or (5 if dynamics == "limit" else 1)
    mode = mode or ("streams" if not stats_only else "speed stats" if dynamics == "speed" else "stats")
    if wide and n >= wide_min_envs(mode):
        return wide_geometry(channels, rows, width)
    consumers = MAX_CONSUMER_WARPS
    while consumers > 1 and -(-n // (32 * consumers)) < SM_SHARE * H100_SMS:
        consumers //= 2
    envs = 32 * consumers
    room = (MAX_THREADS - envs) // 32 // consumers * consumers  # producer warps the CTA holds
    producers = min(PRODUCERS_PER_CONSUMER[mode] * consumers, room)
    max_chunk = MAX_CHUNK[mode]
    chunk = max(1, min(max_chunk, run_steps))
    while chunk > 1 and ring_bytes(envs, chunk, SLOTS, channels, rows, width) > SMEM_BUDGET:
        chunk //= 2
    staged = int(bool(rows) and ring_bytes(envs, chunk, SLOTS, channels, rows, width) <= SMEM_BUDGET)
    if rows and not staged:
        chunk = max(1, min(max_chunk, run_steps))
    return Geometry(envs, producers, chunk, SLOTS, channels, rows, width, staged,
                    ring_bytes(envs, chunk, SLOTS, channels, rows * staged, width))
