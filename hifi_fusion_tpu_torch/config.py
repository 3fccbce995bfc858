"""FusionConfig for the PyTorch port: a verbatim copy of the JAX package's.

The port must not import JAX, so it cannot import ``hifi_fusion_tpu.config``
(importing any ``hifi_fusion_tpu`` submodule runs that package's
``__init__``, which imports ``jax``).  ``tests/test_torch_config_synthetic.py``
holds this copy equal to the original: same fields, same defaults, same
derived properties, so a JAX config carries across unchanged.

The port reads the geometry, filter, normal-estimation, capacity and
behaviour fields.  It ignores the fields that exist only to shape static
TPU programs: ``max_unique_per_frame``, ``max_hit_voxels``,
``max_replay_active``, ``max_replay_hits``, ``batch_unique_lanes``,
``batch_hit_lanes`` (lane budgets), ``dep_width_tiers``,
``dep_resid_cells``, ``dep_resid_pairs`` (the stratified residual),
``refine_tiers``, ``replay_tiers`` (budget tiers), ``extract_cap``
(the port sizes extraction from the live count), ``shard_x_cells``
(sharding is not ported) and the ``scatter_tail`` property (the port's
tensors have no scratch tail).  Their overflow counters therefore stay 0
in the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def _dim(lo: float, hi: float, res: float) -> int:
    """Number of cells along one axis.

    Matches the reference's ``xdim_ = (xmax_-xmin_)/xres_`` C++ double->int
    truncation (OccupancyGrid.hpp:623-625) with a tiny epsilon so that exact
    multiples (e.g. 2.6/0.005) don't truncate down due to binary rounding.
    """
    return int(math.floor((hi - lo) / res + 1e-9))


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    # ---- geometry (reference launch:7 bounding_box, FUSION.cpp:161-164) ----
    bbox: Tuple[float, float, float, float, float, float] = (
        -0.80, 1.80, -1.5, 1.5, 0.0, 1.0)  # xmin,xmax,ymin,ymax,zmin,zmax
    resolution: Tuple[float, float, float] = (0.005, 0.005, 0.005)

    # ---- filter parameters (OccupancyGrid.hpp:34-36, FUSION.cpp:91-93) ----
    cylinder_radius: float = 0.001    # kCylinderRadius
    bball_radius: float = 0.015       # kBballRadius (normal line half-length)
    good_points_threshold: int = 100  # kGoodPointsThreshold
    z_clip: Tuple[float, float] = (0.28, 0.6)  # kZmin, kZmax (camera frame)

    # ---- normal estimation (FUSION.cpp:163 setK(2); GRID.hpp:334,352) ----
    k_neighborhood: int = 2           # PCA window half-width -> (2k+1)^3 cells
    min_neighbors: int = 21           # gate is "total > 20"
    line_k: int = 3                   # dependant line half-length in voxels (K)

    # ---- static shapes (TPU: fixed shapes, masks for variable counts) ----
    capacity_log2: int = 20           # hash table slots C = 2**capacity_log2
    max_probes: int = 64              # linear-probe bound before overflow
    max_points: int = 307200          # N_max per frame (640x480)
    max_active_points: int = 307200   # NA: static bound on VALID (clip+bbox
                                      # surviving) points per frame; the
                                      # sorted frame is compacted to this
                                      # prefix so every downstream lane
                                      # space scales with real occupancy.
                                      # Excess valid points are dropped and
                                      # counted in overflow_active.
    buffer_capacity_log2: int = 21    # global pre-normal point buffer B
    max_dependants: int = 12          # per-voxel dependant fan-in bound D
    max_refine_candidates: int = 65536  # voxels refined per pass (U_max)
    # sort-compaction bounds (see ops/scatter.py for why these exist):
    max_unique_per_frame: int = 1 << 17  # distinct cells hit per frame
    max_hit_voxels: int = 1 << 17        # distinct owners hit per frame
                                         # (the dependant stream never
                                         # expands pair lanes physically —
                                         # stats aggregate per (cell, dep
                                         # lane) over the existing cell
                                         # segments, ops/integrate.py —
                                         # so the only pair-path budget is
                                         # this owner-constant dedup bound)
    max_replay_active: int = 1 << 22     # distinct buffered-slot runs a
                                         # refine pass can replay (RB)
    max_replay_hits: int = 1 << 22       # replay pair-point lanes (R2):
                                         # Σ over new dependant links of
                                         # the link slot's buffered points
    max_batch_frames: int = 8            # K-frame batched integrate bound:
                                         # sizes the scatter scratch tail
                                         # for K*unique / K*hit lane budgets
                                         # (ops/integrate.py batched mode)

    # ---- behavior ----
    store_color: bool = True          # accumulate per-voxel mean color
                                      # (reference decodes RGB but drops it:
                                      #  FUSION.cpp:204-212 vs GRID.hpp:456-601)
    shard_x_cells: int = 0            # when > 0: this grid is one x-slab
                                      # shard — cell ids, coord validity and
                                      # all capacity sizing use this LOCAL
                                      # x-extent (slab+halo, in cells) while
                                      # world->coord geometry stays in
                                      # GLOBAL coordinates (bit-identical
                                      # across shards); kernels receive a
                                      # dynamic (3,) coord offset.  Lifts the
                                      # int32 cell-id cap from the domain to
                                      # the shard (parallel/sharding.py).
    refine_every: int = 16            # frames between refine passes (the
                                      # reference refines on a 5s wall-clock
                                      # timer, FUSION.cpp:323; we use a frame
                                      # cadence so results are deterministic)
    refine_first: int = 0             # when > 0, the refine marks are
                                      # refine_first, refine_first + e,
                                      # refine_first + 2e, ... instead of
                                      # multiples of e: an early first pass
                                      # seeds normals/dependants while the
                                      # steady cadence stays sparse.  The
                                      # reference's 5 s timer at its 31 Hz
                                      # feed refines every ~150 frames
                                      # (FUSION.cpp:323,453) — a sparse
                                      # steady cadence is CLOSER to its
                                      # semantics than every-8.  0 = marks
                                      # at multiples of e (legacy).
    reclaim_buffer: bool = True       # after each refine pass, drop buffer
                                      # lanes whose voxel has normal_found.
                                      # The reference keeps buffers forever
                                      # (unbounded RAM, GRID.hpp:70,211) and
                                      # replays a FROZEN buffer when a late
                                      # owner registers a dependant on an
                                      # already-normal-found voxel
                                      # (GRID.hpp:412-442); with reclamation
                                      # that late replay is skipped — the
                                      # only divergence.  Both oracles honor
                                      # this flag, so parity is exact either
                                      # way.  False = reference-exact,
                                      # unbounded-buffer semantics.
    bug_compat_blue_shift: bool = False  # reproduce FUSION.cpp:174 blue>>1 bug
    # device-side budget tiers (ops/integrate.py dep_width_tiers /
    # ops/refine.py tiers): when set, the pipeline's fused step dispatches
    # the tiered variants — live counts picked ON DEVICE via lax.switch,
    # zero host round-trips.  () = always the full static budgets.
    dep_width_tiers: Tuple[int, ...] = ()
    # Stratified dependant residual (ops/integrate.py _resid_block): when
    # dep_resid_pairs > 0, the pair block's dense (point x dep-lane) scan
    # space runs at the FIRST dep_width_tiers width only, and lanes
    # [width, dep_count) of deeper cells go through a compact side path
    # sized by these budgets — the lane audit measured >=99.9% of point
    # lanes in cells with <= 4 dependants, so the dense width drops from
    # the batch max (6) to 4 while a few thousand residual pairs ride a
    # 2^15-lane replay-style block.  Exact: every (point, lane) pair is
    # computed exactly once, integer counts stay bit-identical (f32 sums
    # commute).  Overruns are counted in overflow_hits, never silent.
    dep_resid_cells: int = 0     # distinct deep cells per batch (RC)
    dep_resid_pairs: int = 0     # residual pair-point lanes (NR); 0 = off
    refine_tiers: Tuple[Tuple[int, int, int, int], ...] = ()
    # inner replay-expansion tiers (ops/refine.py replay_tiers): the replay
    # block lax.switches on the LIVE replayed-point total, so a steady pass
    # with a near-empty replay runs thousands of lanes, not millions.
    replay_tiers: Tuple[int, ...] = ()
    # static emission bound for extraction (ops/extract.py cap): the
    # compacted-prefix gathers run over this many lanes instead of the full
    # hash capacity (~4x cheaper at the bench config, PERF.md §5).  The
    # pipeline falls back to an UNCAPPED extract when n_valid exceeds it —
    # never a silent truncation.  0 = always uncapped.
    extract_cap: int = 0
    # K-frame batched-integrate lane budgets (ops/integrate.py batched
    # mode).  Consecutive frames of a sweep hit nearly the same cells, so
    # the UNION of K frames' unique cells / hit owners is ~1.3-1.7x ONE
    # frame's, not Kx (PERF.md §5) — these cap the batch lane spaces below
    # the pessimistic K * per-frame budgets.  0 = K * the per-frame budget.
    # Overflow counters guard the bounds exactly as in the per-frame path.
    batch_unique_lanes: int = 0
    batch_hit_lanes: int = 0

    # ------------------------------------------------------------------
    @property
    def dims(self) -> Tuple[int, int, int]:
        """Grid dimensions in cells; valid cells are [0, dim) per axis
        (reference validCoord, OccupancyGrid.hpp:647-650).  For a shard
        (shard_x_cells > 0) the x extent is the LOCAL slab+halo width."""
        dx = self.shard_x_cells if self.shard_x_cells > 0 else _dim(
            self.bbox[0], self.bbox[1], self.resolution[0])
        return (
            dx,
            _dim(self.bbox[2], self.bbox[3], self.resolution[1]),
            _dim(self.bbox[4], self.bbox[5], self.resolution[2]),
        )

    @property
    def global_x_cells(self) -> int:
        """x extent of the full (unsharded) domain in cells."""
        return _dim(self.bbox[0], self.bbox[1], self.resolution[0])

    @property
    def n_cells(self) -> int:
        dx, dy, dz = self.dims
        return dx * dy * dz

    @property
    def capacity(self) -> int:
        return 1 << self.capacity_log2

    @property
    def buffer_capacity(self) -> int:
        return 1 << self.buffer_capacity_log2

    @property
    def origin(self) -> Tuple[float, float, float]:
        return (self.bbox[0], self.bbox[2], self.bbox[4])

    @property
    def scatter_tail(self) -> int:
        """Scratch-tail slots appended to every scatter-target grid array;
        must cover the largest masked-scatter batch (ops/scatter.py),
        including the direct per-hit-lane cylinder scatter (H lanes).
        The stratified-residual cyl_stats scatter is a SEPARATE call from
        the dense one (ops/integrate.py — duplicate owners across the two
        streams forbid concatenating them), so dep_resid_pairs needs only
        its own lane count covered, not added to the hit-lane term."""
        return max(self.max_points,
                   self.n_line * self.max_refine_candidates,
                   self.max_batch_frames * self.max_unique_per_frame,
                   self.max_batch_frames * self.max_hit_voxels,
                   min(self.max_replay_active, self.buffer_capacity),
                   self.max_replay_hits // 4,
                   self.dep_resid_pairs)

    @property
    def n_occ_words(self) -> int:
        """Words in the packed cell-occupancy bitmap (32 cells/word).
        Bounded by n_cells < 2^31 -> <= 256 MB; typically a few MB."""
        return (self.n_cells + 31) // 32

    @property
    def n_offsets(self) -> int:
        k = self.k_neighborhood
        return (2 * k + 1) ** 3

    @property
    def n_line(self) -> int:
        return 2 * self.line_k + 1

    def validate(self) -> "FusionConfig":
        if self.n_cells >= 2 ** 31:
            raise ValueError(
                f"grid has {self.n_cells} cells; dense int32 cell ids require "
                f"< 2^31. Shrink the bbox or coarsen the resolution (or shard "
                f"the grid over a mesh, see hifi_fusion_tpu.parallel).")
        if self.capacity_log2 > 24:
            # ops/integrate.py round-trips owner slot ids through f32 in the
            # segment-fill gate (exact only to 2^24); a bigger table would
            # let stale fills pass silently (advisor, round 1)
            raise ValueError(
                f"capacity_log2={self.capacity_log2} > 24: slot ids must "
                f"stay f32-exact (ops/integrate.py fill gate). Shard the "
                f"grid instead (hifi_fusion_tpu.parallel).")
        if self.bbox[0] >= self.bbox[1] or self.bbox[2] >= self.bbox[3] \
                or self.bbox[4] >= self.bbox[5]:
            raise ValueError(f"degenerate bbox {self.bbox}")
        if self.refine_first < 0:
            raise ValueError(
                f"refine_first={self.refine_first} must be >= 0 "
                f"(0 = marks at multiples of refine_every)")
        return self


def small_test_config(**overrides) -> FusionConfig:
    """A tiny config for unit tests (CPU-friendly shapes)."""
    base = dict(
        bbox=(-0.32, 0.32, -0.32, 0.32, -0.32, 0.32),
        resolution=(0.01, 0.01, 0.01),
        capacity_log2=14,
        max_probes=32,
        max_points=4096,
        buffer_capacity_log2=15,
        max_dependants=12,
        max_refine_candidates=4096,
        z_clip=(-10.0, 10.0),
        # generous compaction bounds: tests must never truncate, so that
        # oracle parity stays exact
        max_unique_per_frame=4096,
        max_hit_voxels=1 << 14,
        max_replay_active=1 << 15,     # == buffer capacity: full coverage
        max_replay_hits=1 << 17,
    )
    base.update(overrides)
    return FusionConfig(**base).validate()
