"""End-to-end: the production jitted frame step vs the independent scalar
oracle (tests/oracle_full.py) over 10 frames of a dynamic scene with ego
motion, a moving tracked car, depth noise sigma, occlusion, and out-of-range
(far free-space) regions.  This is the full-update() validation the round-2
verdict required — every stage participates, compared at the state level.
"""

import numpy as np

from semantic_dsp_map_tpu import FilterParams, MaskKpts, SemanticDSPMap
from semantic_dsp_map_tpu.config import tiny_test_config
from semantic_dsp_map_tpu.frontend import build_frame_input

from oracle_full import FullOracle


def _frame(cfg, registry, t):
    """Dynamic scene with deliberately IRRATIONAL-ish constants.

    Round numbers (0.15 m motion, 1.2 m depth, fx = 20) conspire to land
    moved particles on exact pixel/voxel boundaries, where the ~1e-7
    difference between the jitted f32 Kabsch transform and the oracle's f64
    one flips C truncation (observed: a moved particle at u == 6.0 exactly).
    Ugly constants make such coincidences measure-zero.
    """
    H, W = cfg.height, cfg.width
    depth = np.full((H, W), 1.5873, np.float32)
    # far region (beyond depth_range_max=8) -> free-space resets
    depth[:4, :] = 9.5111
    static = np.full((H, W), 6, np.uint8)
    car = np.zeros((H, W), np.uint8)
    car[8:16, 4 + t : 12 + t] = 1
    depth[car > 0] = 1.2157
    dx, dy = 0.15131, 0.02071
    kpts = np.array(
        [
            [0.2071 + dx * t, dy * t, 1.2157],
            [0.6113 + dx * t, dy * t, 1.2157],
            [0.2071 + dx * t, -0.3041 + dy * t, 1.2157],
            [0.6113 + dx * t, -0.3041 + dy * t, 1.2157],
            [0.2071 + dx * t, dy * t, 1.5119],
        ],
        np.float32,
    )
    masks = [
        MaskKpts(track_id=65535, label="static", mask=static),
        MaskKpts(
            track_id=3, label="Car", mask=car, kpts_current=kpts,
            kpts_previous=kpts - np.array([dx, dy, 0], np.float32),
        ),
    ]
    cam_pos = np.array([0.02133 * t, 0, 0.26177 * t], np.float32)
    cam_quat = np.array([1, 0, 0, 0], np.float32)
    return build_frame_input(cfg, registry, depth, masks, cam_pos, cam_quat, 0.15 * t)


def test_full_frame_matches_oracle():
    cfg = tiny_test_config()
    params = FilterParams(
        if_consider_depth_noise=True,
        nb_ptc_num_per_point=1,
        depth_noise_model_zero_order=0.2,
        prediction_stddev=0.0,  # determinism: no rigid-move jitter
    )
    dsp = SemanticDSPMap(cfg, params)
    oracle = FullOracle(cfg, params, dsp.registry)

    for t in range(10):
        f = _frame(cfg, dsp.registry, t)
        result, diag = dsp.update_from_frame(f)
        ores, odiag = oracle.update(f)

        # capacity caps must not bind, or the comparison is meaningless
        assert int(diag.block_overflow) == 0
        assert int(diag.entry_overflow) == 0
        assert int(diag.birth_overflow) == 0
        assert int(diag.move_overflow) == 0
        assert int(diag.table_dropped) == 0

        assert int(diag.visible_count) == odiag["visible"], f"frame {t}"
        assert int(diag.born_count) == odiag["born"], f"frame {t}"
        assert int(diag.moved_count) == odiag["moved"], f"frame {t}"

        np.testing.assert_array_equal(
            np.asarray(dsp.state.voxel_stamp), oracle.voxel_stamp,
            err_msg=f"voxel_stamp frame {t}",
        )
        np.testing.assert_array_equal(
            np.asarray(result.occ), ores["occ"], err_msg=f"occ frame {t}"
        )
        np.testing.assert_array_equal(
            np.asarray(result.track), ores["track"], err_msg=f"track frame {t}"
        )
        np.testing.assert_array_equal(
            np.asarray(result.label), ores["label"], err_msg=f"label frame {t}"
        )
        np.testing.assert_allclose(
            np.asarray(result.weight_sum), ores["weight_sum"],
            rtol=2e-4, atol=1e-5, err_msg=f"weight_sum frame {t}",
        )
        np.testing.assert_array_equal(
            np.asarray(dsp.state.particles.status).reshape(oracle.status.shape),
            oracle.status, err_msg=f"status frame {t}",
        )
        np.testing.assert_allclose(
            np.asarray(dsp.state.particles.weight).reshape(oracle.w.shape),
            oracle.w, rtol=2e-4, atol=1e-6, err_msg=f"weight frame {t}",
        )

    # the dynamic object must actually have been tracked and moved
    assert 3 in oracle.objects and oracle.objects[3]["moving"]
    assert odiag["moved"] > 0


def _zed2_frame(cfg, registry, t):
    """ZED2-mode scene: sky band (culled), mask bleed onto a far wall
    (bbox-gated to Background), a moving 4-corner-bbox car."""
    import numpy as np

    H, W = cfg.height, cfg.width
    depth = np.full((H, W), 1.5873, np.float32)
    depth[:3, :] = 9.5111          # beyond range -> far free-space
    depth[:, 26:] = 3.0873         # far wall (valid depth)
    static = np.full((H, W), 6, np.uint8)   # Road (label 7 - 1)
    static[3:7, :] = 2                       # Sky band (label 3 - 1)

    car = np.zeros((H, W), np.uint8)
    car[9:16, 6 + t : 13 + t] = 1
    # mask bleed onto the far wall: >1 m behind the bbox -> demoted
    car[9:16, 26:29] = 1
    depth[9:16, 6 + t : 13 + t] = 1.2157

    # modest motion so the LAST corner stays inside the 5-px FOV margin
    # (the bbox3d path gates on it, semantic_dsp_map.h:1421-1442) while the
    # key-corner drift still overtakes the ~0.21 m bbox width by mid-run
    dx, dy = 0.05131, 0.01071
    kpts = np.array(
        [
            [0.0071 + dx * t, dy * t, 1.2157],
            [0.2184 + dx * t, dy * t, 1.2157],
            [0.0071 + dx * t, -0.2041 + dy * t, 1.2157],
            [0.2184 + dx * t, -0.2041 + dy * t, 1.2157],
        ],
        np.float32,
    )
    masks = [
        MaskKpts(track_id=65535, label="static", mask=static),
        MaskKpts(
            track_id=4, label="Car", mask=car, kpts_current=kpts,
            kpts_previous=kpts - np.array([dx, dy, 0], np.float32),
        ),
    ]
    cam_pos = np.array([0.01133 * t, 0, 0.03177 * t], np.float32)
    cam_quat = np.array([1, 0, 0, 0], np.float32)
    # 0.35 s frames: the 2 s key-corner refresh timer fires mid-sequence
    return build_frame_input(cfg, registry, depth, masks, cam_pos, cam_quat, 0.35 * t)


def test_full_frame_matches_oracle_zed2():
    """ZED2 (bbox3d) mode end-to-end vs the oracle:
    sky culling, bbox gating, last/key keypoint caches with the 2 s refresh,
    drift-vs-width movement evidence, FOV gate — plus the independent-filter
    PHD variant (semantic_dsp_map.h:1009-1027)."""
    import itertools

    from semantic_dsp_map_tpu.config import KEYPOINTS_BBOX3D

    for independent in [False, True]:
        cfg = tiny_test_config(keypoint_mode=KEYPOINTS_BBOX3D)
        params = FilterParams(
            if_consider_depth_noise=True,
            nb_ptc_num_per_point=1,
            depth_noise_model_zero_order=0.2,
            prediction_stddev=0.0,
            if_use_independent_filter=independent,
            bayesian_movement_distance_threshold=0.2,
            bayesian_movement_increment=0.4,
            bayesian_movement_decrement=0.05,
            bayesian_movement_probability_threshold=0.3,
        )
        dsp = SemanticDSPMap(cfg, params)
        oracle = FullOracle(cfg, params, dsp.registry)

        for t in range(10):
            f = _zed2_frame(cfg, dsp.registry, t)
            result, diag = dsp.update_from_frame(f)
            ores, odiag = oracle.update(f)

            assert int(diag.block_overflow) == 0
            assert int(diag.entry_overflow) == 0
            assert int(diag.table_dropped) == 0

            msg = f"independent={independent} frame {t}"
            assert int(diag.visible_count) == odiag["visible"], msg
            assert int(diag.born_count) == odiag["born"], msg
            assert int(diag.moved_count) == odiag["moved"], msg
            np.testing.assert_array_equal(
                np.asarray(result.occ), ores["occ"], err_msg=msg
            )
            np.testing.assert_array_equal(
                np.asarray(result.track), ores["track"], err_msg=msg
            )
            np.testing.assert_array_equal(
                np.asarray(result.label), ores["label"], err_msg=msg
            )
            np.testing.assert_allclose(
                np.asarray(result.weight_sum), ores["weight_sum"],
                rtol=2e-4, atol=1e-5, err_msg=msg,
            )
            np.testing.assert_array_equal(
                np.asarray(dsp.state.particles.status).reshape(oracle.status.shape),
                oracle.status, err_msg=msg,
            )

        # the bbox3d object must have turned moving (drift > bbox width)
        assert 4 in oracle.objects and oracle.objects[4]["moving"]
        assert odiag["moved"] > 0
        # the 2 s key-corner refresh must have fired (0.35 s frames:
        # first refresh lands at t=2.45 s, frame 7)
        assert oracle.objects[4]["key_t"] > 2.0
