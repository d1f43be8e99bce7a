"""Real-format dataset readers exercised on synthesized on-disk sequences.

Kitti360Sequence / VirtualKitti2Sequence implement
the reference feeders' formats (script/tools/kitti360_data_reader.py:120-157,
225-244; VKITTI2 official layout) but had never parsed real-format files.
These tests write tiny sequences in the OFFICIAL layouts — KITTI-360
17-/13-number pose txt + float32 depth .npy + mono label PNG; VKITTI2
16-bit-centimeter depth PNG + class-color PNG + instance PNG +
extrinsic.txt — and replay them end-to-end through the map engine via the
replay CLI path.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from semantic_dsp_map_tpu.config import tiny_test_config
from semantic_dsp_map_tpu.datasets import (
    KITTI360_CAM_TO_IMU,
    Kitti360Sequence,
    VirtualKitti2Sequence,
    _read_png,
    read_kitti360_poses,
    rotation_to_quat_wxyz,
)
from semantic_dsp_map_tpu.labels import LabelRegistry


# ---------------------------------------------------------------------------
# Dependency-free PNG writer (tests only).  Rows cycle through filter types
# 0/1/2 so the reader's None/Sub/Up reconstruction paths are all exercised.
# ---------------------------------------------------------------------------

def _png_chunk(ctype: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", crc)


def write_png(path: str, arr: np.ndarray):
    """8-bit gray/RGB or 16-bit gray non-interlaced PNG."""
    if arr.dtype == np.uint16:
        bitdepth, colortype = 16, 0
        data = arr[..., None]
    elif arr.ndim == 2:
        bitdepth, colortype = 8, 0
        data = arr[..., None]
    else:
        bitdepth, colortype = 8, 2
        data = arr
    h, w, ch = data.shape
    bpp = ch * (bitdepth // 8)

    rows = []
    prev = np.zeros(w * bpp, np.uint8)
    for r in range(h):
        if bitdepth == 16:
            rb = np.empty(w * 2, np.uint8)
            rb[0::2] = (data[r, :, 0] >> 8).astype(np.uint8)
            rb[1::2] = (data[r, :, 0] & 0xFF).astype(np.uint8)
        else:
            rb = data[r].reshape(-1).astype(np.uint8)
        ft = r % 3  # cycle None/Sub/Up
        if ft == 0:
            enc = rb
        elif ft == 1:
            shifted = np.concatenate([np.zeros(bpp, np.uint8), rb[:-bpp]])
            enc = (rb.astype(np.int32) - shifted).astype(np.uint8)
        else:
            enc = (rb.astype(np.int32) - prev).astype(np.uint8)
        rows.append(bytes([ft]) + enc.tobytes())
        prev = rb
    raw = b"".join(rows)

    ihdr = struct.pack(">IIBBBBB", w, h, bitdepth, colortype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw)))
        f.write(_png_chunk(b"IEND", b""))


def test_png_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    g8 = rng.randint(0, 256, (24, 32)).astype(np.uint8)
    write_png(str(tmp_path / "g8.png"), g8)
    np.testing.assert_array_equal(_read_png(str(tmp_path / "g8.png")), g8)

    g16 = rng.randint(0, 65536, (24, 32)).astype(np.uint16)
    write_png(str(tmp_path / "g16.png"), g16)
    np.testing.assert_array_equal(_read_png(str(tmp_path / "g16.png")), g16)

    rgb = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    write_png(str(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(_read_png(str(tmp_path / "rgb.png")), rgb)


# ---------------------------------------------------------------------------
# KITTI-360 pose formats (kitti360_data_reader.py:120-157)
# ---------------------------------------------------------------------------

def test_kitti360_pose_formats(tmp_path):
    rng = np.random.RandomState(1)
    # a modest rotation + translation
    a = 0.3
    rot = np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    )
    t = np.array([1.5, -2.0, 0.7])
    cam0_to_world = np.eye(4)
    cam0_to_world[:3, :3] = rot
    cam0_to_world[:3, 3] = t

    # 17-number cam0-to-world format
    p17 = tmp_path / "cam0_to_world.txt"
    with open(p17, "w") as f:
        f.write("5 " + " ".join(str(v) for v in cam0_to_world.reshape(-1)) + "\n")
    poses = read_kitti360_poses(str(p17))
    assert poses[0][0] == 5
    np.testing.assert_allclose(poses[0][1], t, atol=1e-6)
    np.testing.assert_allclose(
        poses[0][2], rotation_to_quat_wxyz(rot), atol=1e-6
    )

    # 13-number IMU-to-world format: composed with the cam->IMU extrinsic
    imu_to_world = cam0_to_world @ np.linalg.inv(KITTI360_CAM_TO_IMU)
    p13 = tmp_path / "poses.txt"
    with open(p13, "w") as f:
        f.write("5 " + " ".join(str(v) for v in imu_to_world[:3].reshape(-1)) + "\n")
    poses13 = read_kitti360_poses(str(p13))
    np.testing.assert_allclose(poses13[0][1], t, atol=1e-5)
    np.testing.assert_allclose(poses13[0][2], poses[0][2], atol=1e-5)


# ---------------------------------------------------------------------------
# End-to-end replays at the tiny map size (files in the OFFICIAL layouts)
# ---------------------------------------------------------------------------

def _tiny_depth(cfg, t):
    H, W = cfg.image_height, cfg.image_width
    v = np.arange(H, dtype=np.float32)[:, None]
    depth = np.full((H, W), 3.0, np.float32)
    ground = cfg.camera_fy * 0.8 / np.maximum(v - cfg.camera_cy, 1e-3)
    depth = np.minimum(depth, np.where(v > cfg.camera_cy, ground, depth))
    return depth


def test_kitti360_sequence_end_to_end(tmp_path):
    cfg = tiny_test_config(consider_instance=False)
    H, W = cfg.image_height, cfg.image_width
    ddir = tmp_path / "depth"
    sdir = tmp_path / "semantic"
    os.makedirs(ddir), os.makedirs(sdir)

    lines = []
    for t in range(4):
        name = str(t).zfill(10)
        np.save(str(ddir / (name + ".npy")), _tiny_depth(cfg, t))
        sem = np.full((H, W), 5, np.uint8)  # label_id - 1 per pixel
        sem[: H // 2] = 4
        write_png(str(sdir / (name + ".png")), sem)
        pose = np.eye(4)
        pose[:3, 3] = [0, 0, 0.1 * t]
        lines.append(f"{t} " + " ".join(str(v) for v in pose.reshape(-1)))
    with open(tmp_path / "poses.txt", "w") as f:
        f.write("\n".join(lines) + "\n")

    seq = Kitti360Sequence(str(ddir), str(sdir), str(tmp_path / "poses.txt"))
    frames = list(seq)
    # repeat_first=2 initialization frames (kitti360_data_reader.py:217-220)
    assert len(frames) == 6
    assert frames[0].index == frames[1].index == 0
    np.testing.assert_allclose(frames[3].cam_pos, [0, 0, 0.1], atol=1e-6)
    assert frames[0].masks[0].track_id == 65535
    assert frames[0].masks[0].mask[H - 1, 0] == 5

    # full map replay through the CLI path (tiny preset)
    from semantic_dsp_map_tpu import replay as replay_mod
    from semantic_dsp_map_tpu.config import FilterParams
    from semantic_dsp_map_tpu.map import SemanticDSPMap

    dsp = SemanticDSPMap(cfg, FilterParams(), LabelRegistry.default())
    summary, result = replay_mod.run_replay(
        dsp, seq, out_dir=str(tmp_path / "out"), ply_every=0, verbose=False
    )
    assert summary["frames"] == 4
    occ = np.asarray(result.occ)
    assert (occ == 1).sum() > 0  # the ground plane mapped
    assert os.path.exists(tmp_path / "out" / "final_occupied.ply")


def test_vkitti2_sequence_end_to_end(tmp_path):
    cfg = tiny_test_config()
    H, W = cfg.image_height, cfg.image_width
    scene = tmp_path / "Scene01" / "clone"
    cam = "Camera_0"
    for sub in ["depth", "classSegmentation", "instanceSegmentation"]:
        os.makedirs(scene / "frames" / sub / cam)

    ext_lines = ["frame cameraID r1,1 r1,2 ..."]
    for t in range(4):
        depth = _tiny_depth(cfg, t)
        depth_cm = np.clip(depth * 100.0, 0, 65535).astype(np.uint16)
        write_png(
            str(scene / "frames" / "depth" / cam / f"depth_{t:05d}.png"),
            depth_cm,
        )
        cls = np.zeros((H, W, 3), np.uint8)
        cls[:, :] = (100, 60, 100)     # Road
        cls[: H // 2] = (90, 200, 255)  # Sky
        car = np.zeros((H, W), bool)
        car[H // 3 : H // 3 + 10, 8 + t : 20 + t] = True
        cls[car] = (255, 127, 80)      # Car
        inst = np.zeros((H, W), np.uint8)
        inst[car] = 3  # instance id 2 + 1
        write_png(
            str(scene / "frames" / "classSegmentation" / cam / f"classgt_{t:05d}.png"),
            cls,
        )
        write_png(
            str(scene / "frames" / "instanceSegmentation" / cam / f"instancegt_{t:05d}.png"),
            inst,
        )
        w2c = np.eye(4)
        w2c[:3, 3] = [0, 0, -0.1 * t]  # camera at +0.1t (world->cam)
        ext_lines.append(
            f"{t} 0 " + " ".join(str(v) for v in w2c.reshape(-1))
        )
        # a second camera's rows must be skipped
        ext_lines.append(f"{t} 1 " + " ".join(str(v) for v in np.eye(4).reshape(-1)))
    with open(scene / "extrinsic.txt", "w") as f:
        f.write("\n".join(ext_lines) + "\n")

    reg = LabelRegistry.default()
    seq = VirtualKitti2Sequence(str(scene), registry=reg)
    frames = list(seq)
    assert len(frames) == 4

    f0 = frames[0]
    # 16-bit cm -> meters
    assert abs(float(f0.depth[H - 1, 0]) - _tiny_depth(cfg, 0)[H - 1, 0]) < 0.011
    np.testing.assert_allclose(frames[2].cam_pos, [0, 0, 0.2], atol=1e-6)
    # class colors -> (label_id - 1) static mask
    road_lid = reg.label_to_id["Road"]
    assert f0.masks[0].mask[H - 1, 0] == road_lid - 1
    # instance mask with synthesized bbox keypoints
    inst_masks = [m for m in f0.masks if m.label != "static"]
    assert len(inst_masks) == 1 and inst_masks[0].track_id == 3
    assert inst_masks[0].kpts_current.shape == (5, 3)

    from semantic_dsp_map_tpu.config import FilterParams
    from semantic_dsp_map_tpu.map import SemanticDSPMap
    from semantic_dsp_map_tpu.replay import run_replay

    dsp = SemanticDSPMap(cfg, FilterParams(), reg)
    summary, result = run_replay(dsp, seq, verbose=False)
    assert summary["frames"] == 2  # 4 frames - drop_first 2
    assert (np.asarray(result.occ) == 1).sum() > 0
