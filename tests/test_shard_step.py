"""shard_map pipeline vs the single-device step (exact equality).

The explicit shard_map step (parallel/shard_step.py) partitions the voxel
grid into z-slabs and the image into row-slabs, coupling them with
all_to_all entry routing.  With the noise paths off (the full-frame oracle
conditions) and no camera-depth ties, the routed pipeline reproduces the
single-device step bit-for-bit: identical pixel-table slot assignment,
identical insertion order per voxel, identical reductions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from semantic_dsp_map_tpu.config import (
    KEYPOINTS_BBOX3D,
    FilterParams,
    tiny_test_config,
)
from semantic_dsp_map_tpu.frontend import MaskKpts, build_frame_input, pack_frame
from semantic_dsp_map_tpu.labels import LabelRegistry
from semantic_dsp_map_tpu.map import build_frame_step
from semantic_dsp_map_tpu.parallel.shard_step import build_shard_map_step
from semantic_dsp_map_tpu.parallel.sharding import make_mesh, shard_state
from semantic_dsp_map_tpu.state import init_map_state

from test_sharding import _frames


def _raw_frames(cfg, n, bbox3d=False, sky_rows=0):
    """Raw (depth, masks, pos, quat, t) tuples: a static wall + a tracked
    car whose keypoints are either superpoint-style features or the 4
    corners of a 3D bbox (ZED2 mode)."""
    H, W = cfg.height, cfg.width
    out = []
    for t in range(n):
        depth = np.full((H, W), 1.6, np.float32)
        static = np.full((H, W), 6, np.uint8)
        if sky_rows:
            # label 2 = "Sky" in the default registry (value+1 convention)
            static[:sky_rows] = 1
            depth[:sky_rows] = 7.5
        car = np.zeros((H, W), np.uint8)
        car[8:16, 4 + t : 12 + t] = 1
        depth[car > 0] = 1.2
        if bbox3d:
            x0 = 0.2 + 0.05 * t
            kpts = np.array(
                [[x0, -0.3, 1.1], [x0 + 0.5, -0.3, 1.1],
                 [x0, 0.2, 1.4], [x0 + 0.5, 0.2, 1.4]],
                np.float32,
            )
        else:
            kpts = np.array(
                [[0.2 + 0.05 * t, 0, 1.2], [0.6 + 0.05 * t, 0, 1.2],
                 [0.2 + 0.05 * t, -0.3, 1.2], [0.6 + 0.05 * t, -0.3, 1.2],
                 [0.2 + 0.05 * t, 0, 1.5]],
                np.float32,
            )
        masks = [
            MaskKpts(track_id=65535, label="static", mask=static),
            MaskKpts(track_id=3, label="Car", mask=car, kpts_current=kpts,
                     kpts_previous=kpts - np.array([0.05, 0, 0], np.float32)),
        ]
        out.append((depth, masks, np.array([0, 0, 0.05 * t], np.float32),
                    np.array([1, 0, 0, 0], np.float32), 0.15 * t))
    return out


@pytest.mark.parametrize("packed", [False, True])
def test_shard_map_step_matches_single_device(packed):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU platform")
    cfg = tiny_test_config()
    params = FilterParams(
        detection_probability=0.9,
        noise_number=0.01,
        nb_ptc_num_per_point=1,
        prediction_stddev=0.0,
        occupancy_threshold=0.3,
        if_consider_depth_noise=False,
        # movement filter tuned so the tracked car turns moving by frame 3,
        # exercising the cross-slab move-routing all_to_all
        bayesian_movement_increment=0.4,
        bayesian_movement_decrement=0.05,
        bayesian_movement_probability_threshold=0.3,
    )
    registry = LabelRegistry.default()
    frames = _frames(cfg, registry, 4)

    step1 = build_frame_step(cfg, params, registry)
    s1 = init_map_state(cfg, seed=7)
    tot1 = dict(visible=0, born=0, moved=0)
    for f in frames:
        s1, r1, d1 = step1(s1, f)
        tot1["visible"] += int(np.asarray(d1.visible_count))
        tot1["born"] += int(np.asarray(d1.born_count))
        tot1["moved"] += int(np.asarray(d1.moved_count))
    # the scenario must exercise every routed path
    assert tot1["visible"] > 0 and tot1["born"] > 0 and tot1["moved"] > 0

    mesh = make_mesh(8)
    stepN = build_shard_map_step(cfg, params, registry, mesh, packed=packed)
    sN = shard_state(cfg, mesh, init_map_state(cfg, seed=7))
    if packed:
        # The one-buffer transfer path: same raw scene,
        # packed host-side and decoded device-side inside the shard_map.
        raw = _raw_frames(cfg, 4)
        inputsN = [
            pack_frame(cfg, registry, d, m, p, q, t) for d, m, p, q, t in raw
        ]
    else:
        inputsN = frames
    totN = dict(visible=0, born=0, moved=0)
    for f in inputsN:
        sN, rN, dN = stepN(sN, f)
        totN["visible"] += int(np.asarray(dN.visible_count))
        totN["born"] += int(np.asarray(dN.born_count))
        totN["moved"] += int(np.asarray(dN.moved_count))
    assert tot1 == totN

    # particle state
    for name in ["px", "py", "pz", "weight", "label", "track", "status",
                 "forget", "stamp"]:
        a = np.asarray(getattr(s1.particles, name))
        b = np.asarray(getattr(sN.particles, name))
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)

    np.testing.assert_array_equal(
        np.asarray(s1.voxel_stamp), np.asarray(sN.voxel_stamp)
    )
    np.testing.assert_array_equal(np.asarray(r1.occ), np.asarray(rN.occ))
    np.testing.assert_array_equal(np.asarray(r1.label), np.asarray(rN.label))
    np.testing.assert_array_equal(np.asarray(r1.track), np.asarray(rN.track))
    np.testing.assert_allclose(
        np.asarray(r1.weight_sum), np.asarray(rN.weight_sum), atol=1e-5
    )

    # object layer (replicated compute must agree with single-device)
    np.testing.assert_array_equal(
        np.asarray(s1.objects.valid), np.asarray(sN.objects.valid)
    )
    np.testing.assert_allclose(
        np.asarray(s1.objects.moved_probability),
        np.asarray(sN.objects.moved_probability), atol=1e-6,
    )

    # headline diagnostics agree; overflows zero (capacities not exceeded)
    assert int(np.asarray(d1.visible_count)) == int(np.asarray(dN.visible_count))
    assert int(np.asarray(d1.born_count)) == int(np.asarray(dN.born_count))
    for fld in ["block_overflow", "entry_overflow", "move_overflow",
                "birth_overflow"]:
        assert int(np.asarray(getattr(dN, fld))) == 0, fld


def test_shard_map_step_zed2_mode_matches_single_device():
    """ZED2 path sharded: 3D-bbox keypoints, per-instance bbox gating and
    sky culling in the cloud build (pointcloud_tools.h:158-273,234-241),
    exact vs the single-device step."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU platform")
    cfg = tiny_test_config(keypoint_mode=KEYPOINTS_BBOX3D)
    params = FilterParams(
        detection_probability=0.9,
        noise_number=0.01,
        nb_ptc_num_per_point=1,
        prediction_stddev=0.0,
        occupancy_threshold=0.3,
        if_consider_depth_noise=False,
        bayesian_movement_increment=0.4,
        bayesian_movement_decrement=0.05,
        bayesian_movement_probability_threshold=0.3,
    )
    registry = LabelRegistry.default()
    raw = _raw_frames(cfg, 4, bbox3d=True, sky_rows=4)
    frames = [
        build_frame_input(cfg, registry, d, m, p, q, t)
        for d, m, p, q, t in raw
    ]

    step1 = build_frame_step(cfg, params, registry)
    s1 = init_map_state(cfg, seed=5)
    for f in frames:
        s1, r1, d1 = step1(s1, f)
    assert int(np.asarray(d1.visible_count)) > 0

    mesh = make_mesh(8)
    stepN = build_shard_map_step(cfg, params, registry, mesh)
    sN = shard_state(cfg, mesh, init_map_state(cfg, seed=5))
    for f in frames:
        sN, rN, dN = stepN(sN, f)

    np.testing.assert_array_equal(np.asarray(r1.occ), np.asarray(rN.occ))
    np.testing.assert_array_equal(np.asarray(r1.label), np.asarray(rN.label))
    np.testing.assert_allclose(
        np.asarray(s1.particles.weight), np.asarray(sN.particles.weight),
        atol=1e-6,
    )
    assert int(np.asarray(d1.visible_count)) == int(np.asarray(dN.visible_count))
    assert int(np.asarray(d1.born_count)) == int(np.asarray(dN.born_count))
    # the sky rows must actually have culled something: fewer valid cloud
    # points than image pixels with finite depth
    assert int(np.asarray(dN.born_count)) < cfg.height * cfg.width


def test_shard_map_step_noise_birth_statistical():
    """nb_ptc_num_per_point=3 (the depth-noise jitter branch): per-device
    rng streams differ from the single-device draw, so compare
    statistically — same candidate volume, similar accepted births and
    occupancy mass."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU platform")
    cfg = tiny_test_config()
    params = FilterParams(
        detection_probability=0.9,
        noise_number=0.01,
        nb_ptc_num_per_point=3,
        prediction_stddev=0.0,
        occupancy_threshold=0.3,
        if_consider_depth_noise=True,
        depth_noise_model_zero_order=0.05,
        depth_noise_model_first_order=0.01,
    )
    registry = LabelRegistry.default()
    frames = _frames(cfg, registry, 4)

    step1 = build_frame_step(cfg, params, registry)
    s1 = init_map_state(cfg, seed=11)
    born1 = 0
    for f in frames:
        s1, r1, d1 = step1(s1, f)
        born1 += int(np.asarray(d1.born_count))

    mesh = make_mesh(8)
    stepN = build_shard_map_step(cfg, params, registry, mesh)
    sN = shard_state(cfg, mesh, init_map_state(cfg, seed=11))
    bornN = 0
    for f in frames:
        sN, rN, dN = stepN(sN, f)
        bornN += int(np.asarray(dN.born_count))

    assert born1 > 0 and bornN > 0
    assert abs(bornN - born1) / born1 < 0.15, (born1, bornN)
    occ1 = int((np.asarray(r1.occ) == 1).sum())
    occN = int((np.asarray(rN.occ) == 1).sum())
    assert occ1 > 0
    assert abs(occN - occ1) / occ1 < 0.25, (occ1, occN)
    for fld in ["block_overflow", "entry_overflow", "move_overflow",
                "birth_overflow"]:
        assert int(np.asarray(getattr(dN, fld))) == 0, fld


def test_shard_map_step_overflow_counters_fire():
    """Deliberately undersized route buckets: the overflow counters must
    fire and the map must stay sane (finite state, valid occupancy codes,
    subsequent frames keep running) — bucket pressure defers work, never
    corrupts (shard_step.py module docstring contract)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU platform")
    cfg = tiny_test_config(shard_route_floor=16, shard_route_headroom=0.05)
    params = FilterParams(
        detection_probability=0.9,
        noise_number=0.01,
        nb_ptc_num_per_point=1,
        prediction_stddev=0.0,
        occupancy_threshold=0.3,
        if_consider_depth_noise=False,
    )
    registry = LabelRegistry.default()
    frames = _frames(cfg, registry, 3)

    mesh = make_mesh(8)
    stepN = build_shard_map_step(cfg, params, registry, mesh)
    sN = shard_state(cfg, mesh, init_map_state(cfg, seed=2))
    overflow_seen = 0
    for f in frames:
        sN, rN, dN = stepN(sN, f)
        overflow_seen += int(np.asarray(dN.entry_overflow)) + int(
            np.asarray(dN.birth_overflow)
        )
    assert overflow_seen > 0, "undersized buckets must be counted"

    occ = np.asarray(rN.occ)
    assert set(np.unique(occ)) <= {-1, 0, 1, 2}
    for name in ["px", "py", "pz", "weight"]:
        arr = np.asarray(getattr(sN.particles, name))
        assert np.isfinite(arr).all(), name
    # births still land despite the pressure
    assert int(np.asarray(dN.born_count)) >= 0
    assert int(np.asarray(dN.visible_count)) > 0


def test_shard_caps_default_holds_the_single_chip_volume():
    """By default a device can take the whole frustum (z-slabs meet a
    forward camera): single-chip working sets, and each route bucket its
    source's whole volume.  A float headroom sizes them ~1/D."""
    from semantic_dsp_map_tpu.config import virtual_kitti2_config
    from semantic_dsp_map_tpu.parallel.shard_step import shard_caps

    params = FilterParams(if_consider_depth_noise=True, nb_ptc_num_per_point=1)
    cfg = virtual_kitti2_config()
    D = 4
    c = shard_caps(cfg, params, D)
    rpd = -(-cfg.height // D)
    assert c["A_loc"] == cfg.max_active_blocks
    assert c["A_birth"] == cfg.max_birth_blocks
    assert c["A_move"] == cfg.max_moving_blocks
    assert c["BCAP"] == rpd * cfg.width
    assert c["ECAP"] == c["n_work"] and c["MCAP"] == c["n_move"]
    assert c["C_loc"] == cfg.max_table_entries

    s = shard_caps(virtual_kitti2_config(shard_route_headroom=1.2), params, D)
    assert s["hroom"] == pytest.approx(1.15)
    assert s["A_loc"] == int(s["hroom"] * cfg.max_active_blocks) // D
    assert s["BCAP"] == int(s["hroom"] * rpd * cfg.width) // D
    assert s["C_loc"] < c["C_loc"]
