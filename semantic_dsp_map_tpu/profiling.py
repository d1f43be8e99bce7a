"""Per-stage timing harness — the analog of the reference's VERBOSE_MODE
chrono spans (semantic_dsp_map.h:916-952), with the same stage breakdown:
objects / labeled cloud / prediction / observe (visibility+PHD) /
birth+resample / render.

Stages are timed as *cumulative prefixes* of the real frame step (each prefix
jitted with donation, exactly like production): the delta between prefix k and
prefix k-1 is the cost of stage k including everything XLA can fuse into it.
Each timing loop ends in ``jax.block_until_ready`` on the step's outputs.

Usage:
    python -m semantic_dsp_map_tpu.profiling [--config vkitti2] [--iters 5]
"""

from __future__ import annotations

import argparse
import time

import jax
import numpy as np

STAGES = [
    "objects",
    "labeled_cloud",
    "prediction",
    "observe_phd",
    "birth_resample",
    "render",
]


def build_prefix_step(cfg, params, registry, stop_after: int):
    """The frame step truncated after STAGES[stop_after]; mirrors
    map.build_frame_step stage for stage."""
    from .frontend import FrameInput
    from .map import _move_and_cleanup
    from .objects import ObservedInstances, expire_objects, object_level_update
    from .ops import codecs
    from .ops.birth import birth_and_resample
    from .ops.geometry import camera_matrices
    from .ops.observe import observe_and_update
    from .ops.projection import generate_labeled_cloud
    from .ops.render import render_occupancy
    from .state import MapState

    max_movable = registry.max_movable_instance_id

    def step(state: MapState, f: FrameInput):
        gt = state.global_time + 1
        rng, k_obj, k_move, k_birth = jax.random.split(state.rng, 4)
        r_wc, t_wc, r_cw, t_cw = camera_matrices(f.cam_pos, f.cam_quat)

        objects = state.objects
        if cfg.consider_instance:
            obs = ObservedInstances(
                valid=f.inst_valid, track=f.inst_track, label=f.inst_label,
                kpts_curr=f.kpts_curr, kpts_prev=f.kpts_prev, kpts_count=f.kpts_count,
            )
            objects = object_level_update(
                cfg, params, objects, obs, f.cam_pos, r_cw, t_cw,
                f.time, state.prev_frame_time, gt, k_obj,
            )
        if stop_after == 0:
            return state.replace(objects=objects, rng=rng)

        cloud = generate_labeled_cloud(
            cfg, params, f.depth, f.track_raster, f.track_label_table,
            r_wc, t_wc, max_movable,
        )
        if stop_after == 1:
            return state.replace(objects=objects, rng=rng), cloud

        scroll = codecs.update_ego_center(cfg, state.scroll, f.cam_pos, gt)
        objects, _ = expire_objects(params, objects, gt)
        particles, moved, _mov = _move_and_cleanup(
            cfg, params, state.particles, scroll, objects, gt, k_move, max_movable
        )
        state = state.replace(
            particles=particles, scroll=scroll, objects=objects,
            global_time=gt, rng=rng,
        )
        if stop_after == 2:
            return state, cloud

        particles, voxel_stamp, odiag = observe_and_update(
            cfg, params, state.particles, state.scroll, state.voxel_stamp,
            cloud, f.depth, r_cw, t_cw, gt,
        )
        state = state.replace(particles=particles, voxel_stamp=voxel_stamp)
        if stop_after == 3:
            return state, odiag.visible_count

        particles, born, _bov, _cand = birth_and_resample(
            cfg, params, state.particles, state.scroll, cloud, gt, k_birth
        )
        state = state.replace(particles=particles, prev_frame_time=f.time)
        if stop_after == 4:
            return state

        particles, result = render_occupancy(cfg, state, params.occupancy_threshold)
        return state.replace(particles=particles), result

    return jax.jit(step, donate_argnums=0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="vkitti2",
                    choices=["vkitti2", "zed2", "kitti360", "tiny"])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--stages", default=None,
                    help="comma list of stage indices to time (default: all)")
    args = ap.parse_args()

    from .config import (
        FilterParams, kitti360_config, tiny_test_config,
        virtual_kitti2_config, zed2_config,
    )
    from .frontend import MaskKpts, build_frame_input
    from .labels import LabelRegistry
    from .state import init_map_state

    cfg = {
        "vkitti2": virtual_kitti2_config, "zed2": zed2_config,
        "kitti360": kitti360_config, "tiny": tiny_test_config,
    }[args.config]()
    params = FilterParams(nb_ptc_num_per_point=3, if_consider_depth_noise=True,
                          depth_noise_model_zero_order=0.2,
                          depth_noise_model_first_order=0.01)
    registry = LabelRegistry.default()

    H, W = cfg.height, cfg.width
    rng = np.random.RandomState(0)
    depth = np.full((H, W), 8.0, np.float32) + rng.rand(H, W).astype(np.float32)
    static = np.full((H, W), 6, np.uint8)
    frame = build_frame_input(
        cfg, registry, depth,
        [MaskKpts(track_id=65535, label="static", mask=static)],
        np.zeros(3, np.float32), np.array([1, 0, 0, 0], np.float32), 0.0,
    )
    frame = jax.device_put(frame)

    print(f"config={args.config} grid={cfg.nx}x{cfg.ny}x{cfg.nz} "
          f"K={cfg.slots_per_voxel} img={W}x{H} V={cfg.num_voxels}")

    sel = (
        [int(s) for s in args.stages.split(",")]
        if args.stages else list(range(len(STAGES)))
    )
    prev_ms = 0.0
    for k in sel:
        step = build_prefix_step(cfg, params, registry, k)
        # Fresh state per prefix; run once to warm the map + compile.
        state = init_map_state(cfg, seed=0)
        out = step(state, frame)
        state = out[0] if isinstance(out, tuple) else out
        jax.block_until_ready(out)

        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = step(state, frame)
            state = out[0] if isinstance(out, tuple) else out
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"prefix<={STAGES[k]:<15} {ms:9.2f} ms   (+{ms - prev_ms:8.2f})", flush=True)
        prev_ms = ms
        del state, step, out


if __name__ == "__main__":
    main()
