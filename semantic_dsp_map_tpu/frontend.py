"""Host-side frame ingest: MaskKpts-style inputs -> dense device arrays.

This is the process boundary of the reference system: the ROS node converts
``mask_kpts_msgs/MaskGroup`` into ``vector<MaskKpts>`` (src/mapping.cpp:203-251)
and ``generateLabeledPointCloud`` fuses the masks into a per-pixel track-id
raster (pointcloud_tools.h:116-215).  Here the fusion produces fixed-shape
numpy arrays ready to ship to the device; everything downstream is jitted.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from .config import KEYPOINTS_BBOX3D, MapConfig
from .labels import BACKGROUND_INSTANCE_ID, LabelRegistry


@dataclasses.dataclass
class MaskKpts:
    """Python mirror of the reference's MaskKpts input struct
    (tracking_result_handler.h:15-26; wire schema
    script/mmseg/mask_kpts_msgs/msg/_MaskKpts.py:17-24).

    The static background is one entry with label == "static" and
    track_id == 65535 whose mask pixels hold (label_id - 1)
    (docs/custom_files.md:43-47).
    """

    track_id: int
    label: str
    mask: Optional[np.ndarray] = None          # uint8 [H, W]
    kpts_current: Optional[np.ndarray] = None  # f64/f32 [n, 3]
    kpts_previous: Optional[np.ndarray] = None # f64/f32 [n, 3]
    bbox: Optional[tuple] = None               # (x1, y1, x2, y2)


class FrameInput(NamedTuple):
    """Device-ready arrays for one frame."""

    depth: np.ndarray              # f32[H, W] (BOOST-resized)
    track_raster: np.ndarray       # i32[H, W]
    track_label_table: np.ndarray  # i32[65536]
    inst_valid: np.ndarray         # bool[I]
    inst_track: np.ndarray         # i32[I]
    inst_label: np.ndarray         # i32[I]
    kpts_curr: np.ndarray          # f32[I, Kp, 3]
    kpts_prev: np.ndarray          # f32[I, Kp, 3]
    kpts_count: np.ndarray         # i32[I]
    inst_bbox_min: np.ndarray      # f32[65536, 3] (only used in bbox3d mode)
    inst_bbox_max: np.ndarray      # f32[65536, 3]
    cam_pos: np.ndarray            # f32[3]
    cam_quat: np.ndarray           # f32[4] (w, x, y, z)
    time: np.ndarray               # f32 scalar (seconds, relative epoch)


def manual_resize(src: np.ndarray, scale: float) -> np.ndarray:
    """Nearest-neighbor resize matching manualResize
    (pointcloud_tools.h:1104-1133, the Jetson cv::resize workaround):
    dst[i, j] = src[int(i/scale), int(j/scale)] with bounds clamping."""
    new_rows = int(src.shape[0] * scale)
    new_cols = int(src.shape[1] * scale)
    inv = 1.0 / scale
    ri = np.minimum((np.arange(new_rows) * inv).astype(np.int64), src.shape[0] - 1)
    ci = np.minimum((np.arange(new_cols) * inv).astype(np.int64), src.shape[1] - 1)
    return src[np.ix_(ri, ci)]


def rasterize_masks(
    cfg: MapConfig,
    registry: LabelRegistry,
    masks: Sequence[MaskKpts],
) -> np.ndarray:
    """Fuse static + instance masks into the per-pixel track-id raster
    (pointcloud_tools.h:116-215).  Returns i32[H, W]."""
    H, W = cfg.height, cfg.width
    raster = np.full((H, W), BACKGROUND_INSTANCE_ID, dtype=np.int32)

    static_table = registry.static_pixel_value_to_instance_table()

    # Static mask first (there should be only one, pointcloud_tools.h:122-143).
    for mk in masks:
        if mk.label == "static" and mk.mask is not None:
            m = mk.mask
            if cfg.boost_mode and m.shape != (H, W):
                m = manual_resize(m, cfg.image_rescale)
            pixel_label = m.astype(np.int32) + 1
            raster = static_table[np.clip(pixel_label, 0, 255)]
            break

    # Movable instances overlay wherever their mask is positive
    # (pointcloud_tools.h:202-212).
    if cfg.consider_instance:
        for mk in masks:
            if mk.label != "static" and mk.mask is not None:
                m = mk.mask
                if cfg.boost_mode and m.shape != (H, W):
                    m = manual_resize(m, cfg.image_rescale)
                raster = np.where(m > 0, np.int32(mk.track_id), raster)

    return raster


def _ingest(
    cfg: MapConfig,
    registry: LabelRegistry,
    depth: np.ndarray,
    masks: Sequence[MaskKpts],
):
    """Shared host-side ingest: BOOST resize, track-id modulo reallocation
    (semantic_dsp_map.h:178-186), mask fusion, fixed-shape instance arrays.

    Returns (depth f32[H,W], raster i32[H,W], inst dict with track/label/
    kpts_curr/kpts_prev/kpts_count/bbox_min/bbox_max — the bboxes PER
    INSTANCE [I, 3], margin applied)."""
    max_movable = registry.max_movable_instance_id
    masks = list(masks)
    for mk in masks:
        if mk.label != "static" and mk.track_id > max_movable:
            mk.track_id = mk.track_id % max_movable

    if cfg.boost_mode and depth.shape != (cfg.height, cfg.width):
        depth = manual_resize(depth, cfg.image_rescale)
    depth = np.ascontiguousarray(depth, dtype=np.float32)

    raster = rasterize_masks(cfg, registry, masks)

    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
    inst = dict(
        track=np.full(I, -1, np.int32),
        label=np.full(I, -1, np.int32),
        kpts_curr=np.zeros((I, Kp, 3), np.float32),
        kpts_prev=np.zeros((I, Kp, 3), np.float32),
        kpts_count=np.zeros(I, np.int32),
        bbox_min=np.zeros((I, 3), np.float32),
        bbox_max=np.zeros((I, 3), np.float32),
        has_bbox=np.zeros(I, bool),
    )
    slot = 0
    for mk in masks:
        if mk.label == "static":
            continue
        lid = registry.label_to_id.get(mk.label, -1)
        # kpts size sanity (src/mapping.cpp:243-247): drop mismatched entries.
        kc = np.asarray(mk.kpts_current, np.float32).reshape(-1, 3) if mk.kpts_current is not None else np.zeros((0, 3), np.float32)
        kp = np.asarray(mk.kpts_previous, np.float32).reshape(-1, 3) if mk.kpts_previous is not None else np.zeros((0, 3), np.float32)
        if cfg.keypoint_mode != KEYPOINTS_BBOX3D and kc.shape[0] != kp.shape[0]:
            continue
        if slot >= I:
            continue
        n = min(kc.shape[0], Kp)
        inst["track"][slot] = mk.track_id
        inst["label"][slot] = lid
        inst["kpts_curr"][slot, :n] = kc[:n]
        inst["kpts_prev"][slot, : min(kp.shape[0], Kp)] = kp[:Kp]
        inst["kpts_count"][slot] = n
        # ZED2 bbox gate (pointcloud_tools.h:178-199): keypoint AABB with a
        # 1 m margin, keyed by track id.
        if cfg.keypoint_mode == KEYPOINTS_BBOX3D and n > 0 and 0 <= mk.track_id < 65536:
            inst["bbox_min"][slot] = kc[:n].min(axis=0) - 1.0
            inst["bbox_max"][slot] = kc[:n].max(axis=0) + 1.0
            inst["has_bbox"][slot] = True
        slot += 1
    return depth, raster, inst


def static_label_table(registry: LabelRegistry) -> np.ndarray:
    """track -> label base table: reserved static ids map via the registry,
    everything else Background (pointcloud_tools.h:275-282)."""
    table = np.zeros(65536, dtype=np.int32)
    for label, instid in registry.static_label_to_instance.items():
        lid = registry.label_to_id.get(label, 0)
        table[instid] = lid
    return table


def build_frame_input(
    cfg: MapConfig,
    registry: LabelRegistry,
    depth: np.ndarray,
    masks: Sequence[MaskKpts],
    cam_pos,
    cam_quat,
    time: float = 0.0,
) -> FrameInput:
    """Full per-frame ingest to the unpacked FrameInput (dense tables on
    host).  The production transfer path is :func:`pack_frame` — one
    contiguous buffer, with the dense tables rebuilt on device."""
    depth, raster, inst = _ingest(cfg, registry, depth, masks)

    table = static_label_table(registry)
    bbox_min = np.full((65536, 3), -np.inf, np.float32)
    bbox_max = np.full((65536, 3), np.inf, np.float32)
    I = cfg.max_instances_per_frame
    for slot in range(I):
        tid = int(inst["track"][slot])
        if tid < 0:
            continue
        if inst["label"][slot] >= 0 and 0 <= tid < 65536:
            table[tid] = inst["label"][slot]
        if inst["has_bbox"][slot]:
            bbox_min[tid] = inst["bbox_min"][slot]
            bbox_max[tid] = inst["bbox_max"][slot]

    return FrameInput(
        depth=depth,
        track_raster=raster,
        track_label_table=table,
        inst_valid=inst["track"] >= 0,
        inst_track=np.maximum(inst["track"], 0),
        inst_label=inst["label"],
        kpts_curr=inst["kpts_curr"],
        kpts_prev=inst["kpts_prev"],
        kpts_count=inst["kpts_count"],
        inst_bbox_min=bbox_min,
        inst_bbox_max=bbox_max,
        cam_pos=np.asarray(cam_pos, np.float32).reshape(3),
        cam_quat=np.asarray(cam_quat, np.float32).reshape(4),
        time=np.float32(time),
    )


# ---------------------------------------------------------------------------
# Packed single-buffer transfer path
# ---------------------------------------------------------------------------
#
# Every host -> device transfer pays a fixed latency, and the 14-leaf
# FrameInput would pay it 14 times per frame (plus 1.8 MB of dense lookup
# tables).  The production path therefore ships ONE contiguous int32 buffer
# per frame and rebuilds the dense lookup tables on device (ops in
# map.unpack_frame).
#
# Word layout (all 4-byte words; f32 values bitcast):
#   [0:3]   cam_pos, [3:7] cam_quat, [7] time
#   [8 : 8+HW]            depth f32 bits
#   [.. : ..+ceil(HW/2)]  track raster, two u16 per word (lo, hi)
#   [.. : ..+I]           inst_track (-1 = empty slot)
#   [.. : ..+I]           inst_label
#   [.. : ..+I]           kpts_count
#   [.. : ..+I]           has_bbox (0/1)
#   [.. : ..+I*3]         bbox_min f32 bits   (margin applied)
#   [.. : ..+I*3]         bbox_max f32 bits
#   [.. : ..+I*Kp*3]      kpts_curr f32 bits
#   [.. : ..+I*Kp*3]      kpts_prev f32 bits


def packed_frame_words(cfg: MapConfig) -> int:
    HW = cfg.height * cfg.width
    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
    return 8 + HW + (HW + 1) // 2 + 4 * I + 6 * I + 2 * I * Kp * 3


def pack_frame(
    cfg: MapConfig,
    registry: LabelRegistry,
    depth: np.ndarray,
    masks: Sequence[MaskKpts],
    cam_pos,
    cam_quat,
    time: float = 0.0,
) -> np.ndarray:
    """One-buffer frame encoding (int32[packed_frame_words])."""
    depth, raster, inst = _ingest(cfg, registry, depth, masks)
    HW = cfg.height * cfg.width
    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints

    head = np.empty(8, np.float32)
    head[0:3] = np.asarray(cam_pos, np.float32).reshape(3)
    head[3:7] = np.asarray(cam_quat, np.float32).reshape(4)
    head[7] = np.float32(time)

    r = raster.reshape(-1).astype(np.uint32)
    if HW % 2:
        r = np.concatenate([r, np.zeros(1, np.uint32)])
    rp = (r[0::2] | (r[1::2] << 16)).astype(np.uint32)

    parts = [
        head.view(np.int32),
        depth.reshape(-1).view(np.int32),
        rp.view(np.int32),
        inst["track"],
        inst["label"],
        inst["kpts_count"],
        inst["has_bbox"].astype(np.int32),
        inst["bbox_min"].reshape(-1).view(np.int32),
        inst["bbox_max"].reshape(-1).view(np.int32),
        inst["kpts_curr"].reshape(-1).view(np.int32),
        inst["kpts_prev"].reshape(-1).view(np.int32),
    ]
    buf = np.concatenate(parts)
    assert buf.size == packed_frame_words(cfg), (buf.size, packed_frame_words(cfg))
    return buf
