"""Multi-host runtime: jax.distributed bring-up + weak-scaling measurement.

The reference is a single ROS process (SURVEY section 2.3); multi-host
operation is a new capability of this framework.  The design follows the
grid-sharding layout of sharding.py: the voxel grid's leading (z-major) axis
is split over the global mesh so each host holds a contiguous slab of
z-columns in its local HBM; the per-frame inputs (depth image, masks, pose)
are tiny and replicated from every host's feeder; XLA SPMD inserts the
cross-slab collectives (the pixel-table reduction and the render gather ride
NVLink within a host and the network across hosts).

Entry points:
  - :func:`initialize` — one call per process before any jax use.
  - :func:`global_mesh` — a 1-D mesh over every device of every host.
  - :func:`weak_scaling_report` — particle-updates/sec at n devices vs 1
    device with per-device problem size held constant (runnable on the
    8-virtual-device CPU platform or on the GPUs of one host, and unchanged
    across hosts).

Run as a module for the report:
    python -m semantic_dsp_map_tpu.parallel.distributed [--devices 8]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """jax.distributed.initialize wrapper.

    Initializes only when a cluster is configured (more than one process);
    a single process leaves jax.devices() as it is.  Nothing is
    autodetected, and a failure to join the cluster propagates.
    """
    import jax

    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def global_mesh(axis: str = "grid"):
    """A 1-D mesh spanning every device of every participating host."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def _bench_one(cfg, params, n_devices: int, frames: int):
    """(particle updates/sec, per-device compiled GFLOP/frame) of the frame
    step sharded over n devices (the explicit shard_map pipeline)."""
    import jax

    from ..frontend import MaskKpts, build_frame_input
    from ..labels import LabelRegistry
    from ..map import build_frame_step
    from ..state import init_map_state
    from .shard_step import build_shard_map_step
    from .sharding import make_mesh, shard_state

    registry = LabelRegistry.default()
    H, W = cfg.height, cfg.width
    depth = (1.0 + np.arange(H, dtype=np.float32)[:, None] / H) * np.ones(
        (1, W), np.float32
    )
    f = build_frame_input(
        cfg, registry, depth,
        [MaskKpts(track_id=65535, label="static", mask=np.full((H, W), 5, np.uint8))],
        np.zeros(3, np.float32), np.array([1, 0, 0, 0], np.float32), 0.0,
    )

    if n_devices == 1:
        step = build_frame_step(cfg, params, registry)
        state = init_map_state(cfg, seed=0)
    else:
        mesh = make_mesh(n_devices)
        state = shard_state(cfg, mesh, init_map_state(cfg, seed=0))
        step = build_shard_map_step(cfg, params, registry, mesh)

    try:
        compiled = step.lower(state, f).compile()
        gflop = compiled.cost_analysis()["flops"] / 1e9
    except Exception:
        gflop = -1.0

    state, result, diag = step(state, f)  # warm + fill
    _ = float(np.asarray(result.occ[:1])[0])

    updates = 0
    t0 = time.perf_counter()
    for _i in range(frames):
        state, result, diag = step(state, f)
        updates += diag.visible_count
    total = int(np.asarray(updates))
    _ = float(np.asarray(result.occ[:1])[0])
    dt = time.perf_counter() - t0
    return (total / dt if dt > 0 else 0.0), gflop


def _base_config(preset: str):
    """Weak-scaling base (per-device) problem size.

    ``tiny`` is CI-fast but so small that routing fixed costs and dispatch
    dominate; ``medium`` gives each device a 65k-voxel slab and a 192x256
    image slice so the measured scaling reflects real work."""
    from ..config import tiny_test_config

    if preset == "tiny":
        return tiny_test_config()
    if preset == "medium":
        return tiny_test_config(
            voxel_num_axis_x_n=6, voxel_num_axis_y_n=4, voxel_num_axis_z_n=6,
            voxel_size=0.15,
            image_width=256, image_height=192,
            camera_fx=120.0, camera_fy=120.0, camera_cx=128.0, camera_cy=96.0,
            depth_range_min=0.3, depth_range_max=8.0,
            max_visible_particles=1 << 16,
            max_active_blocks=512,
            max_birth_blocks=512,
            max_moving_blocks=64,
            max_table_entries=1 << 16,
            corner_gather_blocks=128,
        )
    raise ValueError(preset)


def weak_scaling_report(n_devices: int, frames: int = 10,
                        preset: str = "tiny") -> dict:
    """Weak scaling: the WHOLE workload grows n-fold with the device count —
    the voxel grid's z-axis AND the image rows both scale by n, so each
    device holds a constant z-slab of voxels and a constant row-slab of
    pixels (fy/cy scale with the rows: the same world surface covers n x the
    pixels, so the visible-particle workload really is n x).

    Efficiency = updates/sec at n devices / (n x updates/sec at 1 device on
    the base workload).  ``flops_ratio`` is the per-device compiled-FLOP
    ratio (grown-n-dev / base-1-dev): ~1.0 means per-device work is constant
    (the 'per-device FLOPs ~ 1/N of single-device' criterion).

    CAVEAT: on the virtual-CPU mesh all "devices" share the host's cores, so
    wall-clock efficiency under-reports what real chips would show; the
    flops_ratio is the contention-free signal."""
    import dataclasses

    from ..config import FilterParams

    if n_devices & (n_devices - 1):
        raise ValueError(
            f"weak_scaling_report requires a power-of-two n_devices (got "
            f"{n_devices}): the workload grows via voxel_num_axis_z_n += "
            f"log2(n) and build_shard_map_step requires D to divide the "
            f"power-of-two grid axes"
        )

    params = FilterParams(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                          depth_noise_model_zero_order=0.2)
    base_cfg = _base_config(preset)
    ups1, gflop1 = _bench_one(base_cfg, params, 1, frames)

    grown = dataclasses.replace(
        base_cfg,
        voxel_num_axis_z_n=base_cfg.voxel_num_axis_z_n
        + int(np.log2(n_devices)),
        image_height=base_cfg.image_height * n_devices,
        camera_fy=base_cfg.camera_fy * n_devices,
        camera_cy=base_cfg.camera_cy * n_devices,
        max_active_blocks=base_cfg.max_active_blocks * n_devices,
        max_birth_blocks=base_cfg.max_birth_blocks * n_devices,
        max_moving_blocks=base_cfg.max_moving_blocks * n_devices,
        max_table_entries=base_cfg.max_table_entries * n_devices,
        corner_gather_blocks=base_cfg.corner_gather_blocks * n_devices,
        # Per-device caps of ~1/D: what weak scaling measures (the test
        # scene spreads over the slabs; shard_step.shard_caps).
        shard_route_headroom=1.2,
    )
    upsN, gflopN = _bench_one(grown, params, n_devices, frames)

    eff = upsN / (ups1 * n_devices) if ups1 > 0 else 0.0
    return {
        "devices": n_devices,
        "updates_per_sec_1dev": int(ups1),
        "updates_per_sec_ndev": int(upsN),
        "weak_scaling_efficiency": round(eff, 3),
        "per_device_gflop_1dev": round(gflop1, 3),
        "per_device_gflop_ndev": round(gflopN, 3),
        "flops_ratio": round(gflopN / gflop1, 3) if gflop1 > 0 else -1.0,
        "preset": preset,
        "host_cores": __import__("os").cpu_count(),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument(
        "--cpu", action="store_true",
        help="emulate the mesh on virtual CPU devices (single-chip hosts)",
    )
    ap.add_argument("--preset", default="tiny", choices=["tiny", "medium"])
    ap.add_argument("--out", help="also write the report JSON to this path")
    args = ap.parse_args()

    import json
    import os
    import sys

    if args.cpu:
        # Importing this module already imported the package (and jax), so
        # env/config tweaks are too late here — re-exec with the environment
        # set before the interpreter starts.
        n = args.devices or 8
        if os.environ.get("_DSP_CPU_REEXEC") != "1":
            env = dict(os.environ)
            flags = env.get("XLA_FLAGS", "")
            if "xla_force_host_platform_device_count" not in flags:
                env["XLA_FLAGS"] = (
                    flags + f" --xla_force_host_platform_device_count={n}"
                ).strip()
            env["JAX_PLATFORMS"] = "cpu"
            env["_DSP_CPU_REEXEC"] = "1"
            # Bootstrap via -c so jax.config forces the CPU platform BEFORE
            # the package import (any device use at import time would pin
            # the wrong backend).
            code = (
                "import jax; jax.config.update('jax_platforms', 'cpu'); "
                "import runpy; runpy.run_module("
                f"'{__spec__.name}', run_name='__main__')"
            )
            os.execve(
                sys.executable,
                [sys.executable, "-c", code] + sys.argv[1:],
                env,
            )
        import jax
    else:
        import jax

        initialize()

    n = args.devices or len(jax.devices())
    report = weak_scaling_report(n, args.frames, args.preset)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
