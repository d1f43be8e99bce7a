"""Benchmark: full-frame map update rate on the reference's own headline
workload.

Headline metric: ZED2-mode mapping rate.  The reference's published 10 Hz
number (BASELINE.md; docs/3dbbox_mode.md:118-127) is ZED2 mode: grid
2^7 x 2^5 x 2^7 @ 0.15 m, 4 particles/voxel, BOOST half-res 640x360 input,
runtime params from cfg/options_zed2.yaml (nb_ptc_num_per_point=1,
detection_probability=0.8, noise_number=0.2, depth noise 0.3+0.02z — note
both reference YAMLs set nb_ptc_num_per_point to 1, overriding the header
default of 3 via the mapping.cpp:109-132 load path, so nb=1 IS the reference
workload).  The synthetic scene has a ground plane, a wall, and a moving
tracked object with 3D-bbox keypoints, with ego motion — every pipeline
stage (object layer, scroll, rigid moves, PHD, birth, render) is exercised.

Every configuration runs in this one process.  Prints ONE JSON line; the
per-configuration detail goes to BENCH_DETAILS.json (git-ignored).  Each
result names the device it ran on.

Usage: python bench.py   (BENCH_ITERS=N sets the timed frames)
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def nvidia_smi_card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def device_info() -> dict:
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def zed2_params():
    """cfg/options_zed2.yaml runtime parameters."""
    from semantic_dsp_map_tpu.config import FilterParams

    return FilterParams(
        detection_probability=0.8, noise_number=0.2, nb_ptc_num_per_point=1,
        occupancy_threshold=0.15, max_observation_lost_time=20,
        forgetting_rate=1.0, max_forget_count=5, id_transition_probability=0.5,
        bayesian_movement_distance_threshold=0.2,
        bayesian_movement_probability_threshold=0.3,
        bayesian_movement_increment=0.2, bayesian_movement_decrement=0.05,
        if_consider_depth_noise=True,
        depth_noise_model_first_order=0.02, depth_noise_model_zero_order=0.3,
    )


def vk_params(**overrides):
    """cfg/options.yaml semantics with depth noise on (VKITTI2)."""
    from semantic_dsp_map_tpu.config import FilterParams

    base = dict(
        detection_probability=0.98, noise_number=0.001, nb_ptc_num_per_point=1,
        occupancy_threshold=0.5, max_observation_lost_time=5,
        forgetting_rate=1.0, max_forget_count=3, id_transition_probability=0.2,
        if_consider_depth_noise=True,
        depth_noise_model_first_order=0.01, depth_noise_model_zero_order=0.2,
    )
    base.update(overrides)
    return FilterParams(**base)


def tpl_params():
    """VKITTI2 with template matching (semantic_dsp_map.h:806-894)."""
    return vk_params(
        forgetting_rate=1.0, max_forget_count=5, id_transition_probability=0.1,
        if_use_template_matching=True, match_score_threshold=0.2,
    )


def synth_template_frame(cfg, t):
    """The VKITTI2 scene with a smaller car, so the observed point count sits
    in the 1500..8000 template-birth window."""
    return synth_vkitti2_frame(cfg, t, car_h_div=8, car_w_div=14)


TEMPLATES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "templates")


def synth_zed2_frame(cfg, t):
    """ZED2-like frame at full sensor res (update() BOOST-resizes)."""
    from semantic_dsp_map_tpu.frontend import MaskKpts

    H, W = cfg.image_height, cfg.image_width
    rng = np.random.RandomState(t)

    v = np.arange(H, dtype=np.float32)[:, None]
    depth = np.full((H, W), 9.0, np.float32)
    ground = cfg.camera_fy * 1.2 / np.maximum(v - cfg.camera_cy, 1e-3)
    depth = np.minimum(depth, np.where(v > cfg.camera_cy, ground, depth))
    depth += rng.randn(H, W).astype(np.float32) * 0.03

    static = np.full((H, W), 6, np.uint8)  # Road-ish everywhere
    static[: H // 2] = 5                   # Building above horizon

    person = np.zeros((H, W), np.uint8)
    cx0 = int((0.15 + 0.015 * t) * W) % W
    person[H // 3 : H // 3 + H // 4, cx0 : cx0 + W // 10] = 1
    pz = 4.0
    depth[person > 0] = pz

    xl = (cx0 - cfg.camera_cx) / cfg.camera_fx * pz
    kpts = np.array(
        [[xl, -0.9, pz], [xl + 0.5, -0.9, pz], [xl, 0.9, pz], [xl + 0.5, 0.9, pz]],
        np.float32,
    )
    masks = [
        MaskKpts(track_id=65535, label="static", mask=static),
        MaskKpts(track_id=7, label="Person", mask=person, kpts_current=kpts,
                 kpts_previous=kpts - np.array([0.1, 0, 0], np.float32)),
    ]
    pos = np.array([0.02 * t, 0.0, 0.2 * t], np.float32)
    quat = np.array([1.0, 0, 0, 0], np.float32)
    return depth, masks, pos, quat


def synth_vkitti2_frame(cfg, t, car_h_div=6, car_w_div=8):
    """VKITTI2-like frame: ground + buildings + a moving car."""
    from semantic_dsp_map_tpu.frontend import MaskKpts

    H, W = cfg.height, cfg.width
    rng = np.random.RandomState(t)

    v = np.arange(H, dtype=np.float32)[:, None]
    depth = np.full((H, W), 25.0, np.float32)
    ground = cfg.fy * 1.6 / np.maximum(v - cfg.cy, 1e-3)
    depth = np.minimum(depth, np.where(v > cfg.cy, ground, depth))
    depth += rng.randn(H, W).astype(np.float32) * 0.05

    static = np.where(v > cfg.cy, 6, 5).astype(np.uint8) * np.ones((1, W), np.uint8)

    car = np.zeros((H, W), np.uint8)
    cx0 = int((0.2 + 0.02 * t) * W) % W
    car[H // 2 : H // 2 + H // car_h_div, cx0 : cx0 + W // car_w_div] = 1
    car_z = 12.0
    depth[car > 0] = car_z

    xl = (cx0 - cfg.cx) / cfg.fx * car_z
    kpts = np.array(
        [[xl, 0, car_z], [xl + 2, 0, car_z], [xl, -1.5, car_z],
         [xl + 2, -1.5, car_z], [xl, 0, car_z + 4], [xl + 2, 0, car_z + 4]],
        np.float32,
    )
    masks = [
        MaskKpts(track_id=65535, label="static", mask=static),
        MaskKpts(track_id=3, label="Car", mask=car, kpts_current=kpts,
                 kpts_previous=kpts - np.array([0.02 * W / cfg.fx * car_z, 0, 0], np.float32)),
    ]
    pos = np.array([0.0, 0.0, 0.35 * t], np.float32)
    quat = np.array([1.0, 0, 0, 0], np.float32)
    return depth, masks, pos, quat


def synth_hostile_frame(cfg, t):
    """The clip1-shaped stress workload: 20 moving tracked
    cars at staggered depths, a dense near-field wall (heavy birth front),
    buildings/ground, ego yaw rotation + forward motion.  Sized so the
    static caps are NEARLY binding — run_config records the peak
    StepDiagnostics so cap pressure is visible in BENCH_DETAILS.json."""
    from semantic_dsp_map_tpu.frontend import MaskKpts

    H, W = cfg.height, cfg.width
    rng = np.random.RandomState(t)

    v = np.arange(H, dtype=np.float32)[:, None]
    depth = np.full((H, W), 28.0, np.float32)
    ground = cfg.fy * 1.6 / np.maximum(v - cfg.cy, 1e-3)
    depth = np.minimum(depth, np.where(v > cfg.cy, ground, depth))
    depth += rng.randn(H, W).astype(np.float32) * 0.05

    static = np.where(v > cfg.cy, 6, 5).astype(np.uint8) * np.ones((1, W), np.uint8)

    # dense near-field structure: a wall strip at 3.5 m sweeping with t
    w0 = int((0.05 + 0.01 * t) * W) % (W // 2)
    depth[: H // 3, w0 : w0 + W // 5] = 3.5 + rng.randn(H // 3, W // 5) * 0.02

    masks = [MaskKpts(track_id=65535, label="static", mask=static)]
    n_cars = 20
    for i in range(n_cars):
        car = np.zeros((H, W), np.uint8)
        col = (i % 5) / 5.0
        row = (i // 5) / 4.0
        cz = 8.0 + 2.0 * (i % 7)
        cw, ch = W // 14, H // 10
        cx0 = int((col + 0.01 * t * (1 + i % 3)) * W) % (W - cw)
        cy0 = int(H // 2 + row * H // 3) % (H - ch)
        car[cy0 : cy0 + ch, cx0 : cx0 + cw] = 1
        depth[car > 0] = cz
        xl = (cx0 - cfg.cx) / cfg.fx * cz
        yt = (cy0 - cfg.cy) / cfg.fy * cz
        kpts = np.array(
            [[xl, yt, cz], [xl + 1.8, yt, cz], [xl, yt + 1.2, cz],
             [xl + 1.8, yt + 1.2, cz], [xl + 0.9, yt + 0.6, cz],
             [xl, yt, cz + 3.5]],
            np.float32,
        )
        dx = 0.01 * W / cfg.fx * cz * (1 + i % 3)
        masks.append(
            MaskKpts(track_id=10 + i, label="Car", mask=car,
                     kpts_current=kpts,
                     kpts_previous=kpts - np.array([dx, 0, 0], np.float32))
        )

    yaw = 0.008 * t  # ~0.46 deg/frame ego rotation
    quat = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0], np.float32)
    pos = np.array([0.05 * t, 0.0, 0.3 * t], np.float32)
    return depth, masks, pos, quat


def run_config(name, cfg, params, synth, iters, warmup=3, template_path=None):
    """Frames/s of SemanticDSPMap.update over ``iters`` frames after
    ``warmup`` compile-and-settle frames, with the peak diagnostics."""
    import jax

    from semantic_dsp_map_tpu import SemanticDSPMap
    from semantic_dsp_map_tpu.labels import LabelRegistry

    dsp = SemanticDSPMap(cfg, params, LabelRegistry.default())
    if template_path:
        n_tpl = dsp.set_template_path(template_path)
        assert n_tpl > 0, "no templates loaded"
    frames = [synth(cfg, t) for t in range(warmup + iters)]

    for t in range(warmup):
        d, m, p, q = frames[t]
        out = dsp.update(d, m, p, q, time=t * 0.1)
    jax.block_until_ready(out)

    # The timed loop issues only the steps; the diagnostics stay on the
    # device until the window ends.
    diags = []
    t0 = time.perf_counter()
    for t in range(warmup, warmup + iters):
        d, m, p, q = frames[t]
        result, diag = dsp.update(d, m, p, q, time=t * 0.1)
        diags.append(diag)
    jax.block_until_ready((result, diags))
    dt = time.perf_counter() - t0

    host = [{k: int(v) for k, v in d._asdict().items()} for d in jax.device_get(diags)]
    peak_diag = {k: max(d[k] for d in host) for k in host[0]}
    total_updates = sum(d["visible_count"] for d in host)
    return {
        "config": name,
        "device": device_info(),
        "frames": iters,
        "fps": iters / dt,
        "particle_updates_per_sec": total_updates / dt,
        "sec_per_frame": dt / iters,
        "peak_diag": peak_diag,
    }


def run_sharded_check(iters=8, cfg=None):
    """Run the explicit shard_map pipeline on a mesh of every local device
    and compare its render output with the plain single-device step.

    Static scene (no moving objects): the sharded move path draws its
    prediction jitter from a per-device folded key, so only a mover-free
    scene is comparable render for render across the two step builds."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from semantic_dsp_map_tpu.config import zed2_config
    from semantic_dsp_map_tpu.frontend import build_frame_input
    from semantic_dsp_map_tpu.labels import LabelRegistry
    from semantic_dsp_map_tpu.map import build_frame_step
    from semantic_dsp_map_tpu.parallel.shard_step import build_shard_map_step
    from semantic_dsp_map_tpu.parallel.sharding import make_mesh, shard_state
    from semantic_dsp_map_tpu.state import init_map_state

    cfg = cfg or zed2_config()
    params = zed2_params()
    registry = LabelRegistry.default()
    mesh = make_mesh(len(jax.devices()))
    replicated = NamedSharding(mesh, PartitionSpec())

    def frame(t):
        d, masks, pos, quat = synth_zed2_frame(cfg, t)
        masks = [m for m in masks if m.label == "static"]
        return build_frame_input(cfg, registry, d, masks, pos, quat, t * 0.1)

    frames = [jax.device_put(frame(t), replicated) for t in range(iters)]

    plain = build_frame_step(cfg, params, registry)
    s1 = init_map_state(cfg, seed=0)
    outs_plain = []
    for f in frames:
        s1, r1, _ = plain(s1, f)
        outs_plain.append(jax.device_get(r1))

    sharded = build_shard_map_step(cfg, params, registry, mesh)
    s2 = shard_state(cfg, mesh, init_map_state(cfg, seed=0))
    outs_sh = []
    for f in frames:
        s2, r2, _ = sharded(s2, f)
        outs_sh.append(jax.device_get(r2))
    equal = all(
        np.array_equal(a.occ, b.occ)
        and np.array_equal(a.label, b.label)
        and np.array_equal(a.track, b.track)
        for a, b in zip(outs_plain, outs_sh)
    )

    # The step donates its state: keep the returned one.
    s2, r2, d2 = sharded(s2, frames[0])
    jax.block_until_ready((s2, r2, d2))
    t0 = time.perf_counter()
    for t in range(iters):
        s2, r2, d2 = sharded(s2, frames[t % len(frames)])
    jax.block_until_ready((s2, r2, d2))
    dt = time.perf_counter() - t0
    return {
        "config": "zed2_sharded_mesh%d" % len(jax.devices()),
        "device": device_info(),
        "frames": iters,
        "fps": iters / dt,
        "render_equal_vs_plain": bool(equal),
    }


def main():
    import jax

    from semantic_dsp_map_tpu.compile_cache import enable_compile_cache
    from semantic_dsp_map_tpu.config import virtual_kitti2_config, zed2_config

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench.py measures the GPU; JAX found %r" % jax.devices())
    card = nvidia_smi_card()
    iters = int(os.environ.get("BENCH_ITERS", "50"))

    # ZED2: the reference's published 10 Hz workload.
    zed2 = run_config("zed2", zed2_config(), zed2_params(), synth_zed2_frame, iters)

    # VKITTI2: the reference maps it at ~10 Hz (docs/superpoint_mode.md:79-81).
    vkitti2 = run_config(
        "vkitti2", virtual_kitti2_config(), vk_params(), synth_vkitti2_frame,
        max(10, iters // 2),
    )

    tpl = run_config(
        "vkitti2_template", virtual_kitti2_config(), tpl_params(),
        synth_template_frame, max(20, iters // 2), template_path=TEMPLATES,
    )

    # Hostile clip1-shaped stress scene: 20 movers, dense near-field birth,
    # ego rotation; peak diagnostics recorded.
    hostile = run_config(
        "vkitti2_hostile", virtual_kitti2_config(), vk_params(),
        synth_hostile_frame, max(10, iters // 2),
    )

    details = {"card": card, "zed2": zed2, "vkitti2": vkitti2,
               "vkitti2_template": tpl, "vkitti2_hostile": hostile,
               "zed2_sharded": run_sharded_check()}
    for name, res in details.items():
        print(name, json.dumps(res), file=sys.stderr)
    details_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BENCH_DETAILS.json")
    with open(details_path, "w") as f:
        json.dump(details, f, indent=1)

    # vs_baseline is fps over the reference's ~10 Hz mapping rate.
    baseline_fps = 10.0
    print(card)
    print(
        json.dumps(
            {
                "metric": "vkitti2_frames_per_sec",
                "value": vkitti2["fps"],
                "unit": "frames/s",
                "vs_baseline": vkitti2["fps"] / baseline_fps,
                "zed2_fps": zed2["fps"],
                "device": device_info(),
            }
        )
    )


if __name__ == "__main__":
    main()
