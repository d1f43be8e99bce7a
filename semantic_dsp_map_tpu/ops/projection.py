"""Depth back-projection (labeled point cloud) and particle visibility.

These are hot loops #1 and #2 of the reference frame kernel:
  - generateLabeledPointCloud (pointcloud_tools.h:88-310): per-pixel K^-1
    back-projection with mask fusion -> here a fully vectorized [H, W] map.
  - updateVisibleParitlcesWithBFS / getIdxOfVisibleParitlces
    (operations.h:653-667, 1297-1457): the reference walks frustum voxels
    with a vertex BFS purely to avoid scanning all voxels on a CPU.  The
    production path is the fused block pipeline in
    ops/observe.py; the :class:`VisibleSet` container kept here is the
    test/diagnostic surface for the PHD oracle tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import FilterParams, MapConfig
from ..labels import BACKGROUND_INSTANCE_ID
from .geometry import mm


class LabeledCloud(NamedTuple):
    """Dense per-pixel observation grid (the reference's
    vector<vector<LabeledPoint>>, data_base.h:78-92)."""

    pos: jax.Array     # f32[H, W, 3] global-frame point
    sigma: jax.Array   # f32[H, W] noise stddev
    label: jax.Array   # i32[H, W]
    track: jax.Array   # i32[H, W]
    valid: jax.Array   # bool[H, W]


def generate_labeled_cloud(
    cfg: MapConfig,
    params: FilterParams,
    depth: jax.Array,           # f32[H, W], already BOOST-resized if needed
    track_raster: jax.Array,    # i32[H, W] per-pixel instance/track id
    track_label_table: jax.Array,  # i32[65536] track id -> label id
    r_wc: jax.Array,
    t_wc: jax.Array,
    max_movable_instance_id: int,
    sky_instance_id: int = -1,
    inst_bbox_min: jax.Array | None = None,  # f32[65536?]-free: see below
    inst_bbox_max: jax.Array | None = None,
    row_offset=0,
) -> LabeledCloud:
    """Vectorized generateLabeledPointCloud (pointcloud_tools.h:217-307).

    ``track_raster`` is the fused static+instance mask built by the frontend
    (mirroring pointcloud_tools.h:116-215).  ``track_label_table`` maps any
    instance id (movable track ids and reserved static ids alike) to its
    label id, replacing the two-way branch at pointcloud_tools.h:275-282.

    ZED2-mode extras (enabled by passing the optional args):
      - sky culling (pointcloud_tools.h:234-241);
      - per-instance 3D-bbox gating of mask pixels with a 1 m margin, which
        demotes out-of-box points to Background (pointcloud_tools.h:254-273).
        ``inst_bbox_min/max`` are dense [T, 3] tables indexed by track id
        (T = max_movable_instance_id+1-safe size chosen by caller) already
        including the margin.
    """
    # Shapes derive from the depth raster: an image-row slab (+halo) under
    # row sharding passes sliced inputs plus its global ``row_offset``.
    H, W = depth.shape
    rows = (
        jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
        + jnp.float32(row_offset)
    )
    cols = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)

    valid = (
        jnp.isfinite(depth)
        & (depth >= cfg.depth_range_min)
        & (depth <= cfg.depth_range_max)
    )

    track = track_raster.astype(jnp.int32)
    if sky_instance_id >= 0:
        valid &= track != sky_instance_id

    # K^-1 back-projection then camera->world (pointcloud_tools.h:243-249).
    x_cam = (cols - cfg.cx) / cfg.fx * depth
    y_cam = (rows - cfg.cy) / cfg.fy * depth
    cam = jnp.stack([x_cam, y_cam, depth], axis=-1)
    pos = mm(cam, r_wc.T) + t_wc

    # ZED2 bbox gating: movable-instance pixels whose 3D point falls outside
    # the instance's keypoint bbox (+margin) become Background.
    if inst_bbox_min is not None:
        movable = track <= max_movable_instance_id
        tid = jnp.clip(track, 0, inst_bbox_min.shape[0] - 1)
        bmin = inst_bbox_min[tid]
        bmax = inst_bbox_max[tid]
        outside = jnp.any((pos < bmin) | (pos > bmax), axis=-1)
        demote = movable & outside
        track = jnp.where(demote, BACKGROUND_INSTANCE_ID, track)

    label = track_label_table[jnp.clip(track, 0, track_label_table.shape[0] - 1)]

    if params.if_consider_depth_noise:
        sigma = (
            params.depth_noise_model_zero_order
            + params.depth_noise_model_first_order * depth
        )
    else:
        sigma = jnp.full((H, W), 0.1, jnp.float32)
    # The reference leaves sigma uninitialized for invalid pixels
    # (pointcloud_tools.h:228-231); we define it everywhere from the noise
    # model (benign: invalid pixels are masked in every consumer).
    sigma = jnp.where(jnp.isfinite(sigma), sigma, params.depth_noise_model_zero_order)

    return LabeledCloud(
        pos=pos.astype(jnp.float32),
        sigma=sigma.astype(jnp.float32),
        label=label,
        track=track,
        valid=valid,
    )


class VisibleSet(NamedTuple):
    """Compacted candidate-particle buffer (replaces the pixel pyramid maps,
    buffer.h:89-93).  Entries beyond the real count are padding with
    vox == -1; particles are addressed by their 2-D (voxel, slot) coordinates
    so scatters back into the [V, K] arrays never need a flat relayout.
    ``visible`` distinguishes truly visible entries (in the reference's
    pyramid) from far-free/occluded candidates that were compacted only for
    their side effects."""

    vox: jax.Array      # i32[P] voxel index, -1 pad
    slot: jax.Array     # i32[P] slot index within the voxel
    row: jax.Array      # i32[P]
    col: jax.Array      # i32[P]
    pos: jax.Array      # f32[P, 3]
    weight: jax.Array   # f32[P]
    track: jax.Array    # i32[P]
    forget: jax.Array   # i32[P]
    visible: jax.Array  # bool[P] in-pyramid (unoccluded, not far-free)
    count: jax.Array    # i32 scalar, number of visible entries
