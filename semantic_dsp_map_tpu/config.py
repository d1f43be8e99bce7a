"""Static configuration for the semantic DSP map.

This replaces the reference's three-tier config system
(compile-time ``include/settings/settings.h`` macros, runtime YAML read by
``src/mapping.cpp:96-132``, and the four mutable global flags of
``include/settings/external_settings.h:14-17``) with a single frozen dataclass.

All shape-bearing fields (grid exponents, slots/voxel, image size) are Python
ints captured at trace time, so every jitted kernel specializes on them exactly
like the reference specializes at compile time via ``#define SETTING``.

Reference parity notes (file:line cites into the reference repository):
  - grid exponents / voxel size / camera intrinsics per dataset mode:
    include/settings/settings.h:32-124
  - BOOST half-resolution mode: include/settings/settings.h:135-144
  - newborn weight / min-rightly-updated pdf / depth-noise stddev constants:
    include/settings/settings.h:147-150
  - runtime filter parameters (YAML keys): src/mapping.cpp:96-132 and
    cfg/options*.yaml
  - runtime feature flags: include/settings/external_settings.h:14-17
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# ---------------------------------------------------------------------------
# Constants shared with the reference
# ---------------------------------------------------------------------------

#: Initial weight of a newborn occupancy particle (settings.h:147).
PARTICLE_OCC_INIT_WEIGHT = 0.05

#: Minimum pdf value for a particle to count as "rightly updated" by an
#: observation with matching track id; drives the forgetting reset
#: (settings.h:149, semantic_dsp_map.h:1094).
MIN_RIGHTLY_UPDATED_PDF = 0.1

#: The reference's Gaussian "PDF" table is built with
#: ``1/sqrt(2*M_PI_2f32) * exp(-x^2/2)`` where ``M_PI_2f32`` is pi/2, i.e. the
#: normalizing constant is 1/sqrt(pi), not 1/sqrt(2*pi)
#: (basic_algorithms.h:456-459).  The constant matters relative to the additive
#: clutter term ``noise_number`` and the missed-detection term, so we reproduce
#: it faithfully instead of "fixing" it.
GAUSSIAN_PDF_COEF = 1.0 / math.sqrt(math.pi)

#: |z| beyond which the reference LUT returns 1e-9 (basic_algorithms.h:420).
GAUSSIAN_PDF_Z_CLIP = 9.9
GAUSSIAN_PDF_FLOOR = 1e-9

#: Weight given to particles re-added from point-cloud matching
#: (operations.h:136).
MATCHED_PARTICLE_WEIGHT = 0.2

#: Hard cap used when incrementing a particle's forget counter
#: (semantic_dsp_map.h:1111 uses a literal 5 independent of max_forget_count).
FORGET_COUNT_INCREMENT_CAP = 5

#: Movement modes for the object-layer Bayesian moving/static decision.
#: The reference hardwires these per dataset mode (object_layer.h:483-511):
#: SETTING 0 -> never moving, SETTING 1 -> always moving, 2/3 -> Bayesian.
MOVEMENT_NEVER = 0
MOVEMENT_ALWAYS = 1
MOVEMENT_BAYESIAN = 2

#: Keypoint interpretation for the object layer (semantic_dsp_map.h:338-342):
#: superpoint = matched feature points (>=5 needed, RANSAC 100 iters);
#: bbox3d = 4 corners of a 3D detection (ZED2 path, 2 RANSAC iters,
#: movement observed from reference-corner drift).
KEYPOINTS_SUPERPOINT = 0
KEYPOINTS_BBOX3D = 1


@dataclasses.dataclass(frozen=True)
class FilterParams:
    """Runtime (non-shape) parameters of the SMC-PHD filter.

    Mirrors the YAML-tunable parameters of the reference
    (src/mapping.cpp:109-132, defaults semantic_dsp_map.h:25-43).
    These are baked into the jitted step as Python floats; changing them
    retraces (cheap, and matches the reference's restart-to-change workflow).
    """

    detection_probability: float = 0.95
    noise_number: float = 0.1
    nb_ptc_num_per_point: int = 3
    occupancy_threshold: float = 0.2
    max_observation_lost_time: int = 5
    forgetting_rate: float = 1.0
    max_forget_count: int = 5
    id_transition_probability: float = 0.1
    match_score_threshold: float = 0.3
    bayesian_movement_distance_threshold: float = 0.1
    bayesian_movement_probability_threshold: float = 0.69
    bayesian_movement_increment: float = 0.1
    bayesian_movement_decrement: float = 0.15
    prediction_stddev: float = 0.05
    depth_noise_model_first_order: float = 0.0
    depth_noise_model_zero_order: float = 0.1

    # Feature flags (external_settings.h:14-17).
    if_consider_depth_noise: bool = False
    if_use_independent_filter: bool = False
    if_use_template_matching: bool = False
    #: Use the 4-neighborhood denoise/inference occupancy reduction
    #: (operations.h:457-600).  The reference ships this variant as dead code
    #: (no call site, no YAML key); exposed here for parity/experiments.
    if_use_neighbor_smoothed_occupancy: bool = False
    # Pignistic probability is effectively dead in the reference (aborted as
    # "TOO SLOW", semantic_dsp_map.h:1250-1253); kept for config parity only.
    if_use_pignistic_probability: bool = False

    # Output options (semantic_dsp_map.h:130-134).
    if_out_evaluation_format: bool = False
    visualize_with_zero_center: bool = False
    if_output_freespace: bool = False


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Static (shape-bearing) map configuration — the SETTING analog."""

    # Grid exponents: the grid is 2^nx x 2^ny x 2^nz voxels
    # (settings.h:33-35 et al).
    voxel_num_axis_x_n: int = 8
    voxel_num_axis_y_n: int = 8
    voxel_num_axis_z_n: int = 8

    # log2 slots per voxel, including the implicit "time particle" slot the
    # reference reserves at index 0 (buffer.h:43-79).  We store the time
    # particle as a separate dense ``voxel_stamp`` array, so the number of
    # *real* particle slots is ``2^n - 1`` exactly like the reference.
    max_particle_num_per_voxel_n: int = 3

    voxel_size: float = 0.15

    # Camera intrinsics at full sensor resolution (settings.h:41-47 etc).
    camera_fx: float = 552.554261
    camera_fy: float = 552.554261
    camera_cx: float = 682.049453
    camera_cy: float = 238.769549
    image_width: int = 1408
    image_height: int = 376

    consider_instance: bool = False
    depth_range_min: float = 0.3
    depth_range_max: float = 30.0

    #: Depth-error 1-sigma coefficient used in the occlusion test
    #: (settings.h:150, operations.h:1387).
    depth_error_stddev_at_one_meter: float = 0.1

    #: BOOST half-resolution mode (settings.h:135-144): the effective camera
    #: is scaled by ``image_rescale`` and inputs are nearest-neighbor resized.
    boost_mode: bool = False
    image_rescale: float = 0.5

    #: PHD update neighborhood half-width in pixels (semantic_dsp_map.h:964-970:
    #: 5, or 3 in BOOST mode).
    phd_neighbor_half: Optional[int] = None

    #: Object-layer movement decision mode (see MOVEMENT_*).
    movement_mode: int = MOVEMENT_BAYESIAN

    #: Keypoint interpretation (see KEYPOINTS_*).
    keypoint_mode: int = KEYPOINTS_SUPERPOINT

    # ---- Capacity knobs (no reference analog; these bound the compacted
    # work buffers so shapes stay static under jit) ----

    #: Max visible (projected, unoccluded) particles processed per frame.
    max_visible_particles: int = 1 << 20

    #: Capacity of the per-frame active-block working set (ops/blocks.py):
    #: blocks of consecutive voxels holding any projectable particle are
    #: row-gathered into an [A, block_slots] working set.  Overflow is
    #: counted in StepDiagnostics (no silent loss).
    max_active_blocks: int = 8192

    #: Capacity of the pixel-sorted compact entry array feeding the PHD
    #: pixel table (candidates beyond this are dropped and counted).
    max_table_entries: int = 1 << 20

    #: Capacity of the insertion staging working set (ops/birth.py), in voxel
    #: blocks.  Separate from ``max_active_blocks`` (the observe-side knob) so
    #: the two caps can be tuned — and tested — independently.
    max_birth_blocks: int = 8192

    #: Capacity (in 512-voxel blocks) of the empty-voxel observation pass
    #: (the reference's "imaginary center particle" rule,
    #: operations.h:1414-1431).
    corner_gather_blocks: int = 4096

    #: Capacity of the rigid-move working set, in voxel blocks.  Movable
    #: particles live only where movable-label instances have been observed
    #: (round-4 probe: 48 blocks at VKITTI2 scale) — far below the observe
    #: working set.  Overflow is surfaced in StepDiagnostics.move_overflow.
    max_moving_blocks: int = 256

    #: Per-pixel particle-table slots for the PHD stencil (the reference's
    #: pyramid lists are unbounded; overflow drops the lightest particles for
    #: one frame — see ops/phd.py docstring).
    phd_pixel_table_slots: int = 12

    #: Sharded-step capacity model (parallel/shard_step.shard_caps).  The
    #: grid is split into z-slabs and a camera looks along its own axis, so
    #: one slab can hold the whole frustum: a forward-looking camera sends
    #: most of a frame's points to one or two slabs.  ``None`` (the
    #: default) gives every device the single-chip working sets and every
    #: (src, dst) route bucket its source's whole volume, so the sharded
    #: step drops nothing that the single-chip step keeps.  A float
    #: ``headroom`` instead sizes them at ``headroom_eff/D`` of that volume,
    #: ``headroom_eff = 1 + (headroom - 1) * (1 - 1/D)``: per-device work
    #: shrinks with the mesh, but only a scene that spreads evenly over the
    #: slabs fits, and the excess is dropped for one frame and counted in
    #: the overflow diagnostics.
    shard_route_headroom: Optional[float] = None

    #: Minimum sharded route-bucket capacity (entries per (src, dst) pair).
    #: Small grids take the full route volume up to this floor so tests can
    #: never overflow; lowering it (with a small headroom) deliberately
    #: undersizes the buckets — tests/test_shard_step.py uses that to assert
    #: the overflow counters fire and the map stays sane under bucket
    #: pressure.
    shard_route_floor: int = 1024

    #: Max per-frame newborn candidates actually considered is
    #: H*W*nb_ptc_num_per_point (dense, no cap needed); this caps the number
    #: of *moving-object* particles gathered for rigid moves per frame.
    #: Kept modest: the per-candidate compaction gathers are element
    #: gathers, and a frame rarely moves more than a few cars' particles.
    max_moving_particles: int = 1 << 16

    #: Object table capacity (the reference uses unbounded hash maps over
    #: tens of objects; object_layer.h:345-373).
    max_objects: int = 64

    #: Transform window length (object_layer.h:206 max_window_size=5).
    transform_window: int = 5

    #: Max observed instances per frame and max keypoints per instance for the
    #: fixed-shape ingest arrays.
    max_instances_per_frame: int = 32
    max_keypoints: int = 64

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------

    def __post_init__(self):
        # Mirrors runSystemChecking (operations.h:54-58): particle indices
        # must fit in 31 bits.
        total_bits = (
            self.voxel_num_axis_x_n
            + self.voxel_num_axis_y_n
            + self.voxel_num_axis_z_n
            + self.max_particle_num_per_voxel_n
        )
        if total_bits > 31:
            raise ValueError(
                "grid exponents + particle exponent must be <= 31 bits, got %d"
                % total_bits
            )

    @property
    def nx(self) -> int:
        return 1 << self.voxel_num_axis_x_n

    @property
    def ny(self) -> int:
        return 1 << self.voxel_num_axis_y_n

    @property
    def nz(self) -> int:
        return 1 << self.voxel_num_axis_z_n

    @property
    def num_voxels(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def slots_per_voxel(self) -> int:
        """Number of real particle slots per voxel (2^n - 1; slot 0 of the
        reference's layout is the time particle, held separately here)."""
        return (1 << self.max_particle_num_per_voxel_n) - 1

    @property
    def fx(self) -> float:
        return self.camera_fx * self.image_rescale if self.boost_mode else self.camera_fx

    @property
    def fy(self) -> float:
        return self.camera_fy * self.image_rescale if self.boost_mode else self.camera_fy

    @property
    def cx(self) -> float:
        return self.camera_cx * self.image_rescale if self.boost_mode else self.camera_cx

    @property
    def cy(self) -> float:
        return self.camera_cy * self.image_rescale if self.boost_mode else self.camera_cy

    @property
    def width(self) -> int:
        return int(self.image_width * self.image_rescale) if self.boost_mode else self.image_width

    @property
    def height(self) -> int:
        return int(self.image_height * self.image_rescale) if self.boost_mode else self.image_height

    @property
    def neighbor_half(self) -> int:
        if self.phd_neighbor_half is not None:
            return self.phd_neighbor_half
        return 3 if self.boost_mode else 5

    @property
    def map_half_extent(self):
        """Half map extent per axis in meters (operations.h:735-737)."""
        return (
            (self.nx >> 1) * self.voxel_size,
            (self.ny >> 1) * self.voxel_size,
            (self.nz >> 1) * self.voxel_size,
        )

    @property
    def biggest_axis_n(self) -> int:
        return max(self.voxel_num_axis_x_n, self.voxel_num_axis_y_n, self.voxel_num_axis_z_n)

    @property
    def tan_half_fov_x(self) -> float:
        # operations.h:1249: tan(atan2(w/2, fx)) == (w/2)/fx.
        return (self.width / 2.0) / self.fx

    @property
    def tan_half_fov_y(self) -> float:
        return (self.height / 2.0) / self.fy


# ---------------------------------------------------------------------------
# Dataset presets — the four SETTING modes of settings.h:32-124
# ---------------------------------------------------------------------------


def kitti360_config(**overrides) -> MapConfig:
    """SETTING 0 (settings.h:32-52): static KITTI-360 mode, no instances."""
    base = dict(
        voxel_num_axis_x_n=8, voxel_num_axis_y_n=8, voxel_num_axis_z_n=8,
        max_particle_num_per_voxel_n=3, voxel_size=0.15,
        camera_fx=552.554261, camera_fy=552.554261,
        camera_cx=682.049453, camera_cy=238.769549,
        image_width=1408, image_height=376,
        consider_instance=False,
        depth_range_min=0.3, depth_range_max=30.0,
        movement_mode=MOVEMENT_NEVER,
    )
    base.update(overrides)
    return MapConfig(**base)


def coda_config(**overrides) -> MapConfig:
    """SETTING 1 (settings.h:55-77)."""
    base = dict(
        voxel_num_axis_x_n=8, voxel_num_axis_y_n=8, voxel_num_axis_z_n=7,
        max_particle_num_per_voxel_n=2, voxel_size=0.15,
        camera_fx=569.8286, camera_fy=565.4818,
        camera_cx=439.2660, camera_cy=360.5810,
        image_width=960, image_height=540,
        consider_instance=True,
        depth_range_min=0.3, depth_range_max=10.0,
        movement_mode=MOVEMENT_ALWAYS,
    )
    base.update(overrides)
    return MapConfig(**base)


def virtual_kitti2_config(**overrides) -> MapConfig:
    """SETTING 2 (settings.h:79-98): Virtual KITTI 2 / superpoint mode."""
    base = dict(
        voxel_num_axis_x_n=8, voxel_num_axis_y_n=7, voxel_num_axis_z_n=8,
        max_particle_num_per_voxel_n=3, voxel_size=0.2,
        camera_fx=725.0087, camera_fy=725.0087,
        camera_cx=620.5, camera_cy=187.0,
        image_width=1242, image_height=375,
        consider_instance=True,
        depth_range_min=0.3, depth_range_max=30.0,
        movement_mode=MOVEMENT_BAYESIAN,
        keypoint_mode=KEYPOINTS_SUPERPOINT,
        # Right-sized work buffers (counts on the 20-frame warmed bench
        # scene: 1944 active blocks, 912 birth-target blocks, 50 movable
        # blocks, 490k compact entries).  Element gathers/scatters and the
        # observe sort scale with the working set, so oversizing costs
        # time.  Overflow is never silent (StepDiagnostics.*_overflow); the
        # hostile bench scene (bench.py clip1-shaped workload) validates
        # headroom.  2048 overflowed by 33 blocks once the bench scene grew
        # past ~23 frames (the ego keeps driving into fresh ground), so the
        # active cap carries ~25% headroom over that peak.
        max_active_blocks=2560,
        max_table_entries=1 << 19,
        max_birth_blocks=1536,
        max_moving_blocks=128,
        # corner_gather_blocks stays at the default 4096: on an empty map
        # the first frame's whole frustum needs the empty-voxel pass (2172
        # blocks in the bench scene; 2048 dropped 124 of them).
    )
    base.update(overrides)
    return MapConfig(**base)


def zed2_config(**overrides) -> MapConfig:
    """SETTING 3 (settings.h:100-119): ZED2 BOOST mode with 3D bbox tracks."""
    base = dict(
        voxel_num_axis_x_n=7, voxel_num_axis_y_n=5, voxel_num_axis_z_n=7,
        max_particle_num_per_voxel_n=2, voxel_size=0.15,
        camera_fx=527.8191528320312, camera_fy=527.8191528320312,
        camera_cx=633.9357299804688, camera_cy=366.3338623046875,
        image_width=1280, image_height=720,
        consider_instance=True,
        depth_range_min=0.3, depth_range_max=15.0,
        boost_mode=True,
        movement_mode=MOVEMENT_BAYESIAN,
        keypoint_mode=KEYPOINTS_BBOX3D,
        # Right-sized work buffers for the 524k-voxel grid: element
        # gathers/scatters scale with the compact-entry cap, and the
        # default 8192-block cap would gather the ENTIRE 4096-block grid
        # every frame (386 active blocks on the bench scene).
        # Overflow is never silent (StepDiagnostics.*_overflow).
        max_table_entries=1 << 18,
        max_active_blocks=1024,
        max_birth_blocks=1024,
    )
    base.update(overrides)
    return MapConfig(**base)


def tiny_test_config(**overrides) -> MapConfig:
    """A tiny grid + image for unit tests and oracles (no reference analog)."""
    base = dict(
        voxel_num_axis_x_n=4, voxel_num_axis_y_n=3, voxel_num_axis_z_n=4,
        max_particle_num_per_voxel_n=2, voxel_size=0.25,
        camera_fx=20.0, camera_fy=20.0, camera_cx=16.0, camera_cy=12.0,
        image_width=32, image_height=24,
        consider_instance=True,
        depth_range_min=0.3, depth_range_max=8.0,
        movement_mode=MOVEMENT_BAYESIAN,
        max_visible_particles=1 << 12,
        max_active_blocks=16,
        max_table_entries=1 << 12,
        max_birth_blocks=16,
        corner_gather_blocks=8,
        max_moving_blocks=8,
        max_moving_particles=1 << 10,
        max_objects=8,
        max_instances_per_frame=8,
        max_keypoints=16,
    )
    base.update(overrides)
    return MapConfig(**base)


# ---------------------------------------------------------------------------
# YAML loader — format-compatible with the reference cfg/options*.yaml
# ---------------------------------------------------------------------------

_YAML_TO_FIELD = {
    "detection_probability": "detection_probability",
    "noise_number": "noise_number",
    "nb_ptc_num_per_point": "nb_ptc_num_per_point",
    "occupancy_threshold": "occupancy_threshold",
    "max_obersevation_lost_time": "max_observation_lost_time",  # sic (reference spelling)
    "forgetting_rate": "forgetting_rate",
    "max_forget_count": "max_forget_count",
    "id_transition_probability": "id_transition_probability",
    "match_score_threshold": "match_score_threshold",
    "beyesian_movement_distance_threshold": "bayesian_movement_distance_threshold",
    "beyesian_movement_probability_threshold": "bayesian_movement_probability_threshold",
    "beyesian_movement_increment": "bayesian_movement_increment",
    "beyesian_movement_decrement": "bayesian_movement_decrement",
    "depth_noise_model_first_order": "depth_noise_model_first_order",
    "depth_noise_model_zero_order": "depth_noise_model_zero_order",
    "if_consider_depth_noise": "if_consider_depth_noise",
    "if_use_independent_filter": "if_use_independent_filter",
    "if_out_evaluation_format": "if_out_evaluation_format",
    "if_output_freespace": "if_output_freespace",
    "visualize_with_zero_center": "visualize_with_zero_center",
}


def filter_params_from_yaml(path: str) -> FilterParams:
    """Load a reference-format options YAML (cfg/options*.yaml) into
    :class:`FilterParams`.

    Mirrors src/mapping.cpp:96-132 including the quirk that the five
    detection/noise/birth/occupancy/lost-time parameters are only honored when
    ``if_consider_depth_noise`` is true; otherwise the node's hardcoded
    defaults (mapping.cpp:109-110) are used.
    """
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)

    fields = {}
    for key, field in _YAML_TO_FIELD.items():
        if key in cfg:
            fields[field] = cfg[key]

    if not cfg.get("if_consider_depth_noise", False):
        fields["detection_probability"] = 1.0
        fields["noise_number"] = 0.001
        fields["nb_ptc_num_per_point"] = 3
        fields["occupancy_threshold"] = 0.1
        fields["max_observation_lost_time"] = 10

    return FilterParams(**fields)
