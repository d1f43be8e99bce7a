"""Smoke test of the map on one GPU: the quickest proof that the system still
starts and computes the right thing on the card.

    python chip_smoke.py               # every phase below, on one GPU
    python chip_smoke.py --four-cards  # only the sharded step on 4 GPUs

Phases (any failure ends the run with a non-zero exit and no result line):

  device    refuse to run unless JAX's devices are GPUs; print the card's name
            and power limit as nvidia-smi reports them.
  update    a few frames of SemanticDSPMap.update at full width for VKITTI2
            with a moving car, ZED2, and VKITTI2 with template matching;
            the diagnostics must be plausible, the weights finite and
            every overflow counter zero.
  replay    data/replay_tiny replayed on the GPU, compared with
            data/replay_tiny/EXPECTED.json (the tests' CPU comparison).
  precision the camera-transform products pinned to HIGHEST against a
            float64 reference, beside the same products at default precision.
  kernels   each Pallas kernel against its plain XLA form at the VKITTI2
            and ZED2 shapes: errors against stated tolerances, and times.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Tolerances of the kernel comparison.  The kernels and the XLA stencils
#: evaluate the same float32 expressions in another summation order (the
#: kernels sum slot by slot, XLA offset by offset), with each compiler's own
#: exp; neither uses a matrix product, so TF32 plays no part.  The forget
#: counters are compared exactly: a mismatch needs COEF^3 * exp(...) to
#: straddle 0.1 within an ulp.
KERNEL_RTOL = 1e-4
KERNEL_ATOL = 1e-6


def require_gpu(devices) -> None:
    """Raise unless ``devices`` is a non-empty list of GPUs."""
    if not devices or any(d.platform != "gpu" for d in devices):
        raise RuntimeError(
            "chip_smoke.py runs on GPUs only; JAX found %r" % (list(devices),)
        )


def _timed(fn, *args, reps: int = 10):
    """(result, ms per call) of ``fn(*args)``, compiled and warmed first."""
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / reps * 1e3


# ---------------------------------------------------------------------------
# update: the main path at full width
# ---------------------------------------------------------------------------


def run_update(name, cfg, params, synth, frames=10, warmup=3,
               template_path=None, card=""):
    """Drive ``frames`` frames through SemanticDSPMap.update and check the
    diagnostics; returns the per-run summary."""
    import jax

    from semantic_dsp_map_tpu import SemanticDSPMap
    from semantic_dsp_map_tpu.labels import LabelRegistry

    dsp = SemanticDSPMap(cfg, params, LabelRegistry.default())
    if template_path and dsp.set_template_path(template_path) == 0:
        raise RuntimeError(f"no templates loaded from {template_path}")
    inputs = [synth(cfg, t) for t in range(frames)]

    diags = []
    t_start = time.perf_counter()
    for t, (d, m, p, q) in enumerate(inputs):
        if t == warmup:
            jax.block_until_ready(dsp.state)
            t0 = time.perf_counter()
        result, diag = dsp.update(d, m, p, q, time=t * 0.1)
        diags.append(diag)
    jax.block_until_ready((dsp.state, result, diags))
    t_end = time.perf_counter()
    fps = (frames - warmup) / (t_end - t0)

    host = [{k: int(v) for k, v in d._asdict().items()} for d in jax.device_get(diags)]
    weights = np.asarray(dsp.state.particles.weight)
    occ = np.asarray(result.occ)
    after = host[warmup:]
    checks = {
        "visible_count>0 from frame 2": all(d["visible_count"] > 0 for d in host[1:]),
        "born_count>0": host[0]["born_count"] > 0,
        "moved_count>0 after warm-up": any(d["moved_count"] > 0 for d in after),
        "weights finite": bool(np.isfinite(weights).all()),
        "occupied voxels": bool((occ == 1).any()),
    }
    overflow = {k: max(d[k] for d in host) for k in host[0] if "overflow" in k or k == "table_dropped"}
    checks["no overflow"] = not any(overflow.values())
    summary = {
        "config": name,
        "frames": frames,
        "fps_after_warmup": fps,
        "first_frames_s": t0 - t_start,
        "visible_count": [d["visible_count"] for d in host],
        "born_count": [d["born_count"] for d in host],
        "moved_count": [d["moved_count"] for d in host],
        "peak_overflow": overflow,
        "checks": checks,
    }
    print(
        f"[update] {name} on {card}: {fps:.3f} frames/s after {warmup} warm-up "
        f"frames; overflow {overflow}; checks {checks}",
        flush=True,
    )
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name}: implausible diagnostics {failed}: {summary}")
    return summary


def phase_update(card):
    import bench
    from semantic_dsp_map_tpu.config import virtual_kitti2_config, zed2_config

    return [
        run_update("vkitti2", virtual_kitti2_config(), bench.vk_params(),
                   bench.synth_vkitti2_frame, card=card),
        run_update("zed2", zed2_config(), bench.zed2_params(),
                   bench.synth_zed2_frame, card=card),
        run_update("vkitti2_template", virtual_kitti2_config(), bench.tpl_params(),
                   bench.synth_template_frame, template_path=bench.TEMPLATES,
                   card=card),
    ]


# ---------------------------------------------------------------------------
# replay: semantics against the committed expectation
# ---------------------------------------------------------------------------


def phase_replay():
    """Exact equality with EXPECTED.json is required; any difference is
    printed frame by frame before the phase fails."""
    from semantic_dsp_map_tpu import SemanticDSPMap
    from semantic_dsp_map_tpu.config import tiny_test_config
    from semantic_dsp_map_tpu.datasets import NpzSequence
    from semantic_dsp_map_tpu.replay import replay_tiny_params, summarize_replay

    data = os.path.join(ROOT, "data", "replay_tiny")
    with open(os.path.join(data, "EXPECTED.json")) as f:
        expected = json.load(f)
    dsp = SemanticDSPMap(tiny_test_config(), replay_tiny_params())
    got = summarize_replay(dsp, NpzSequence(data), expected["drop_first"])
    diffs = [
        {k: (e[k], g[k]) for k in e if e[k] != g[k]} | {"index": e["index"]}
        for e, g in zip(expected["frames"], got)
        if e != g
    ]
    print(f"[replay] data/replay_tiny: {len(got)} frames, tolerance: exact; "
          f"differences: {diffs}", flush=True)
    if len(got) != len(expected["frames"]) or diffs:
        raise AssertionError(f"replay differs from EXPECTED.json: {diffs}")
    return {"frames": len(got), "differences": diffs}


# ---------------------------------------------------------------------------
# precision: the camera-transform products, pinned and at default precision
# ---------------------------------------------------------------------------

#: Share of points whose voxel may differ from the float64 reference with the
#: pinned products: float32 rounding of coordinates up to ~40 m (ulp ~4e-6 m)
#: flips a 0.2 m voxel for ~1e-4 of the points.
PINNED_VOXEL_SHARE = 1e-3


def phase_precision(card):
    """Each pixel centre of the VKITTI2 scene's depth frame is lifted to the
    world through a rotated, translated camera (the labeled cloud's product,
    ops/projection.py) and projected back (ops/geometry.project_to_image),
    once with the products pinned to HIGHEST (ops/geometry.mm) and once at
    JAX's default matmul precision.  With the pin, every point must come back
    to its own pixel, and its voxel must agree with a float64 reference but
    for float32 rounding ties; the default-precision counts are reported."""
    import jax
    import jax.numpy as jnp

    import bench
    from semantic_dsp_map_tpu.config import virtual_kitti2_config
    from semantic_dsp_map_tpu.ops.geometry import (
        camera_matrices, mm, project_to_image, quat_to_rot,
    )

    cfg = virtual_kitti2_config()
    depth = bench.synth_vkitti2_frame(cfg, 0)[0]
    H, W = depth.shape
    rows, cols = np.mgrid[0:H, 0:W]
    cam = np.stack([(cols + 0.5 - cfg.cx) / cfg.fx * depth,
                    (rows + 0.5 - cfg.cy) / cfg.fy * depth, depth], -1)
    cam = cam.reshape(-1, 3).astype(np.float32)
    axis = np.array([0.1, 1.0, 0.05]) / np.linalg.norm([0.1, 1.0, 0.05])
    quat = np.r_[np.cos(0.35), np.sin(0.35) * axis].astype(np.float32)
    pos = np.array([3.3, 1.7, 12.9], np.float32)

    def lift_and_project(cam, pos, quat, pinned):
        r_wc, t_wc, r_cw, t_cw = camera_matrices(pos, quat)
        if pinned:
            world = mm(cam, r_wc.T) + t_wc
            row, col, _, ok = project_to_image(cfg, r_cw, t_cw, world)
        else:
            world = jnp.matmul(cam, r_wc.T) + t_wc
            back = jnp.matmul(world, r_cw.T) + t_cw
            col = (cfg.fx * back[:, 0] / back[:, 2] + cfg.cx).astype(jnp.int32)
            row = (cfg.fy * back[:, 1] / back[:, 2] + cfg.cy).astype(jnp.int32)
            ok = jnp.ones_like(row, bool)
        return jnp.floor(world / cfg.voxel_size).astype(jnp.int32), row, col, ok

    r64 = np.asarray(jax.device_get(quat_to_rot(jnp.asarray(quat))), np.float64)
    vox64 = np.floor((cam.astype(np.float64) @ r64.T + pos) / cfg.voxel_size)
    res = {"points": int(cam.shape[0])}
    for name, pinned in (("highest", True), ("default", False)):
        vox, row, col, ok = jax.device_get(jax.jit(
            lift_and_project, static_argnums=3)(cam, pos, quat, pinned))
        res[name] = {
            "voxel_differs": int(np.any(vox != vox64, axis=1).sum()),
            "pixel_differs": int(np.sum((row != rows.ravel()) | (col != cols.ravel()) | ~ok)),
        }
    print(f"[precision] camera transforms at {W}x{H} on {card}; tolerance with "
          f"the pin: pixel exact, voxel share <= {PINNED_VOXEL_SHARE}: "
          f"{json.dumps(res)}", flush=True)
    if (res["highest"]["pixel_differs"]
            or res["highest"]["voxel_differs"] > PINNED_VOXEL_SHARE * res["points"]):
        raise AssertionError(f"pinned camera transforms lose points: {res}")
    return res


# ---------------------------------------------------------------------------
# kernels: each Pallas kernel against its plain XLA form
# ---------------------------------------------------------------------------


def synth_stencil_inputs(cfg, seed=0, mean_depth=1.0):
    """A front-filled PHD pixel table and observation cloud at ``cfg``'s
    image size, on the device: about ``mean_depth`` particles per pixel
    (the bench scenes hold about one), scattered around a wall 10 m away."""
    import jax
    import jax.numpy as jnp

    from semantic_dsp_map_tpu.ops.phd import PixelTable
    from semantic_dsp_map_tpu.ops.projection import LabeledCloud

    H, W, S = cfg.height, cfg.width, cfg.phd_pixel_table_slots
    k = jax.random.split(jax.random.PRNGKey(seed), 8)
    rows = jnp.arange(H, dtype=jnp.float32)[:, None]
    cols = jnp.arange(W, dtype=jnp.float32)[None, :]
    z = 10.0 + 0.5 * jax.random.normal(k[0], (H, W))
    obs = jnp.stack(
        [(cols - cfg.cx) / cfg.fx * z, (rows - cfg.cy) / cfg.fy * z, z], axis=-1
    )
    cloud = LabeledCloud(
        pos=obs,
        sigma=0.2 + 0.01 * z,
        label=jnp.zeros((H, W), jnp.int32),
        track=jax.random.randint(k[1], (H, W), 0, 3),
        valid=jax.random.uniform(k[2], (H, W)) < 0.9,
    )
    depth = jax.random.poisson(k[3], mean_depth, (1, H, W))
    occ = jnp.arange(S)[:, None, None] < depth
    jit = 0.1 * jax.random.normal(k[4], (3, S, H, W))
    meta = (jax.random.randint(k[5], (S, H, W), 0, 3) << 8) | jax.random.randint(
        k[6], (S, H, W), 0, 6
    )
    t = PixelTable(
        px=jnp.where(occ, obs[..., 0] + jit[0], 0.0),
        py=jnp.where(occ, obs[..., 1] + jit[1], 0.0),
        pz=jnp.where(occ, obs[..., 2] + jit[2], 0.0),
        weight=jnp.where(occ, jax.random.uniform(k[7], (S, H, W)), 0.0),
        meta=jnp.where(occ, meta, -1).astype(jnp.int32),
        dropped=jnp.int32(0),
    )
    return t, cloud


def _errors(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    err = np.abs(ref - got)
    rel = err / np.maximum(np.abs(ref), KERNEL_ATOL)
    ok = bool(np.all(err <= KERNEL_ATOL + KERNEL_RTOL * np.abs(ref)))
    return {"max_abs": float(err.max()), "max_rel": float(rel.max()), "ok": ok}


def phase_kernels(card):
    """PHD passes A and B: the Triton kernels against the XLA stencils."""
    import jax

    from semantic_dsp_map_tpu.config import virtual_kitti2_config, zed2_config
    from semantic_dsp_map_tpu.ops import phd, phd_pallas

    import bench

    out = []
    for name, cfg, params in (
        ("vkitti2", virtual_kitti2_config(), bench.vk_params()),
        ("zed2", zed2_config(), bench.zed2_params()),
    ):
        t, cloud = synth_stencil_inputs(cfg)
        xla_a = jax.jit(lambda t, c: phd.stencil_pass_a(cfg, params, t, c))
        xla_b = jax.jit(lambda t, c, k: phd.stencil_pass_b(cfg, params, t, c, k))
        ker_a = jax.jit(lambda t, c: phd_pallas.pass_a(cfg, params, t, c))
        ker_b = jax.jit(lambda t, c, k: phd_pallas.pass_b(cfg, params, t, c, k))

        ck_x, ms_xa = _timed(xla_a, t, cloud)
        ck_k, ms_ka = _timed(ker_a, t, cloud)
        (nw_x, nf_x), ms_xb = _timed(xla_b, t, cloud, ck_x)
        (nw_k, nf_k), ms_kb = _timed(ker_b, t, cloud, ck_x)
        res = {
            "shape": f"S={cfg.phd_pixel_table_slots} H={cfg.height} "
                     f"W={cfg.width} R={cfg.neighbor_half}",
            "pass_a_ck": _errors(ck_x, ck_k),
            "pass_b_weight": _errors(nw_x, nw_k),
            "pass_b_forget_mismatches": int(np.sum(np.asarray(nf_x) != np.asarray(nf_k))),
            "ms": {"xla_a": ms_xa, "kernel_a": ms_ka, "xla_b": ms_xb, "kernel_b": ms_kb},
        }
        print(
            f"[kernels] phd {name} ({res['shape']}) on {card}; float32, no "
            f"matrix products; tolerance rtol {KERNEL_RTOL} atol {KERNEL_ATOL}, "
            f"forget exact: {json.dumps(res)}",
            flush=True,
        )
        if not (res["pass_a_ck"]["ok"] and res["pass_b_weight"]["ok"]
                and res["pass_b_forget_mismatches"] == 0):
            raise AssertionError(f"PHD kernel differs from the XLA stencil: {res}")
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# --four-cards: the sharded step across a 4-card mesh
# ---------------------------------------------------------------------------


def phase_four_cards(card, cfg=None, frames=6, timed=10):
    """build_shard_map_step at VKITTI2 width (or ``cfg``), as shipped, on a
    4-card mesh against the single-card step: a static scene compared render
    for render, and a scene with a moving car compared by diagnostics (the
    sharded move draws its jitter from per-device keys, so its particles
    differ).  Every overflow counter of both steps must stay zero, so that no
    dropped work can make them differ.  Then ``timed`` more frames of the
    movers scene are timed on each step."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    import bench
    from semantic_dsp_map_tpu.config import virtual_kitti2_config
    from semantic_dsp_map_tpu.frontend import build_frame_input
    from semantic_dsp_map_tpu.labels import LabelRegistry
    from semantic_dsp_map_tpu.map import build_frame_step
    from semantic_dsp_map_tpu.parallel.shard_step import build_shard_map_step
    from semantic_dsp_map_tpu.parallel.sharding import make_mesh, shard_state
    from semantic_dsp_map_tpu.state import init_map_state

    if len(jax.devices()) < 4:
        raise RuntimeError("--four-cards needs 4 devices, found %d" % len(jax.devices()))
    D = 4
    cfg = cfg or virtual_kitti2_config()
    params = bench.vk_params()
    registry = LabelRegistry.default()
    mesh = make_mesh(D)
    replicated = NamedSharding(mesh, PartitionSpec())
    plain = build_frame_step(cfg, params, registry)
    sharded = build_shard_map_step(cfg, params, registry, mesh)

    def run(step, state, inputs):
        renders, diags = [], []
        for f in inputs:
            state, r, d = step(state, f)
            renders.append(jax.device_get(r))
            diags.append({k: int(v) for k, v in jax.device_get(d)._asdict().items()})
        return state, renders, diags

    def frames_per_s(step, state, inputs):
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for f in inputs:
            state, r, d = step(state, f)
        jax.block_until_ready((state, r, d))
        return len(inputs) / (time.perf_counter() - t0)

    results = {}
    for scene, keep in (("static", lambda m: m.label == "static"),
                        ("movers", lambda m: True)):
        n = frames + (timed if scene == "movers" else 0)
        host = []
        for t in range(n):
            d, masks, pos, quat = bench.synth_vkitti2_frame(cfg, t)
            host.append(build_frame_input(
                cfg, registry, d, [m for m in masks if keep(m)], pos, quat, t * 0.1))
        on_card0 = [jax.device_put(f, jax.devices()[0]) for f in host]
        on_mesh = [jax.device_put(f, replicated) for f in host]
        if not all(
            leaf.sharding.is_fully_replicated and len(leaf.sharding.device_set) == 4
            for f in on_mesh for leaf in jax.tree_util.tree_leaves(f)
        ):
            raise AssertionError("frame inputs must be replicated over the mesh")

        s1, r1, d1 = run(plain, init_map_state(cfg, seed=0), on_card0[:frames])
        t0 = time.perf_counter()
        s4, r4, d4 = run(sharded, shard_state(cfg, mesh, init_map_state(cfg, seed=0)),
                         on_mesh[:frames])
        dt = time.perf_counter() - t0
        overflow = {k: max(d[k] for d in d1 + d4) for k in d4[0]
                    if "overflow" in k or k == "table_dropped"}
        res = {"frames": frames, "sharded_s_with_compile": dt,
               "peak_overflow_both_steps": overflow,
               "diag_plain": d1, "diag_sharded": d4}
        ok = not any(overflow.values()) and all(
            d["visible_count"] > 0 and d["born_count"] > 0 for d in d4[1:]
        )
        if scene == "static":
            res["occ_voxels_differing"] = [int(np.sum(a.occ != b.occ)) for a, b in zip(r1, r4)]
            ok = ok and all(
                np.array_equal(a.occ, b.occ) and np.array_equal(a.label, b.label)
                and np.array_equal(a.track, b.track) for a, b in zip(r1, r4)
            )
        else:
            ok = ok and any(d["moved_count"] > 0 for d in d4[3:])
            res["frames_per_s"] = {
                "timed_frames": timed,
                "plain_1_card": frames_per_s(plain, s1, on_card0[frames:]),
                "sharded_4_cards": frames_per_s(sharded, s4, on_mesh[frames:]),
            }
        res["ok"] = ok
        print(f"[four-cards] {scene} scene, grid {cfg.nx}x{cfg.ny}x{cfg.nz}, "
              f"image {cfg.width}x{cfg.height}, shard_route_headroom "
              f"{cfg.shard_route_headroom}, on {D}x {card.splitlines()[0]}: "
              f"{json.dumps(res)}",
              flush=True)
        results[scene] = res
    failed = [scene for scene, res in results.items() if not res["ok"]]
    if failed:
        raise AssertionError(f"sharded step disagrees with the plain step: {failed}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded step on a 4-card mesh")
    args = ap.parse_args(argv)

    import jax

    require_gpu(jax.devices())
    sys.path.insert(0, ROOT)
    import bench
    from semantic_dsp_map_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = bench.nvidia_smi_card()
    print(f"card: {card}", flush=True)
    if args.four_cards:
        phase_four_cards(card)
    else:
        phase_update(card)
        phase_replay()
        phase_precision(card)
        phase_kernels(card)
    print(json.dumps({"ok": True, "device": bench.device_info()}))


if __name__ == "__main__":
    main()
