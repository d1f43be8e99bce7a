"""Two-process distributed smoke test.

Exercises the multi-controller code path that the single-process virtual
mesh cannot: 2 OS processes x 4 virtual CPU devices each, brought up with
``jax.distributed.initialize(coordinator_address=...)``, stepping the
shard_map frame pipeline 3 frames on an 8-way global mesh.  Every collective
(the observe/birth/move all_to_alls, the diagnostic psum) then crosses the
process boundary for half its peers — the DCN analog on this host.

Run:  python tools/distributed_smoke.py            (spawns both workers)
      python tools/distributed_smoke.py --worker I (one worker, internal)

Writes DISTRIBUTED_SMOKE.json (git-ignored) with both workers' per-frame diagnostics.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PORT = 45677


def worker(process_id: int):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=2,
        process_id=process_id,
    )
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, REPO)
    from semantic_dsp_map_tpu.config import FilterParams, tiny_test_config
    from semantic_dsp_map_tpu.labels import LabelRegistry
    from semantic_dsp_map_tpu.parallel.shard_step import build_shard_map_step
    from semantic_dsp_map_tpu.parallel.sharding import state_shardings
    from semantic_dsp_map_tpu.state import init_map_state
    from semantic_dsp_map_tpu.frontend import MaskKpts, build_frame_input

    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == 4

    cfg = tiny_test_config()
    params = FilterParams(nb_ptc_num_per_point=1, prediction_stddev=0.0)
    registry = LabelRegistry.default()
    mesh = Mesh(np.array(jax.devices()), ("grid",))

    # Build the global sharded state ON DEVICE (identical computation in
    # both processes; no host->global transfer needed).
    st_sh = state_shardings(cfg, mesh, init_map_state(cfg, seed=0))
    state = jax.jit(lambda: init_map_state(cfg, seed=0), out_shardings=st_sh)()

    step = build_shard_map_step(cfg, params, registry, mesh)

    H, W = cfg.height, cfg.width
    repl = NamedSharding(mesh, P())

    def replicate(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.make_array_from_callback(
                np.shape(x), repl, lambda idx: np.asarray(x)[idx]
            ),
            tree,
        )

    diags = []
    for t in range(3):
        depth = np.full((H, W), 1.6, np.float32)
        depth[H // 2 :, :] = 1.1 + 0.01 * t
        masks = [MaskKpts(track_id=65535, label="static",
                          mask=np.full((H, W), 6, np.uint8))]
        f = build_frame_input(
            cfg, registry, depth, masks,
            np.array([0, 0, 0.05 * t], np.float32),
            np.array([1, 0, 0, 0], np.float32), 0.1 * t,
        )
        f = replicate(f)
        state, result, diag = step(state, f)
        diags.append({k: int(np.asarray(v)) for k, v in diag._asdict().items()})

    out = {"process": process_id, "devices": len(jax.devices()),
           "local_devices": len(jax.local_devices()), "diags": diags}
    print("SMOKE_RESULT " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO,
        )
        for i in range(2)
    ]
    outs = []
    ok = True
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=1200)
        except subprocess.TimeoutExpired:
            p.kill()
            out = "(timeout)"
            ok = False
        outs.append(out)
        if p.returncode != 0:
            ok = False

    results = []
    for out in outs:
        for line in out.splitlines():
            if line.startswith("SMOKE_RESULT "):
                results.append(json.loads(line[len("SMOKE_RESULT "):]))
    if ok and len(results) == 2:
        # both processes must compute identical (replicated) diagnostics
        same = results[0]["diags"] == results[1]["diags"]
        born = results[0]["diags"][-1]["born_count"]
        report = {
            "ok": bool(same and born > 0),
            "identical_diags": same,
            "born_last_frame": born,
            "results": results,
        }
    else:
        report = {"ok": False, "results": results,
                  "stdout_tails": [o[-1500:] for o in outs]}
    with open(os.path.join(REPO, "DISTRIBUTED_SMOKE.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({k: report[k] for k in report if k != "results"
                      and k != "stdout_tails"}))
    sys.exit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
