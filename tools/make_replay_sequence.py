"""Generate the committed tiny replay sequence + its expected occupancy
summary.

The reference's validation loop is bag replay (README.md:49-70); this is the
framework's committed equivalent: a 12-frame dynamic scene (static wall, far
free-space band, moving tracked car, ego motion) in NpzSequence format at the
tiny-config scale (~10 KB/frame), plus EXPECTED.json holding the per-frame
occupied/free counts and diagnostics that tests/test_replay.py asserts.

Regenerate (after an intentional semantics change) with:
    python tools/make_replay_sequence.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from semantic_dsp_map_tpu import MaskKpts, SemanticDSPMap  # noqa: E402
from semantic_dsp_map_tpu.config import tiny_test_config  # noqa: E402
from semantic_dsp_map_tpu.datasets import Frame, NpzSequence, save_npz_frame  # noqa: E402
from semantic_dsp_map_tpu.replay import replay_tiny_params, summarize_replay  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "data", "replay_tiny")
N_FRAMES = 12


def make_frame(cfg, t: int) -> Frame:
    H, W = cfg.height, cfg.width
    depth = np.full((H, W), 1.5873, np.float32)
    depth[:4, :] = 9.5111  # beyond depth_range_max -> free space
    static = np.full((H, W), 6, np.uint8)
    car = np.zeros((H, W), np.uint8)
    car[8:16, (4 + t) % W : (12 + t) % W] = 1
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
        MaskKpts(track_id=3, label="Car", mask=car, kpts_current=kpts,
                 kpts_previous=kpts - np.array([dx, dy, 0], np.float32)),
    ]
    return Frame(
        depth=depth,
        masks=masks,
        cam_pos=np.array([0.02133 * t, 0, 0.26177 * t], np.float32),
        cam_quat=np.array([1, 0, 0, 0], np.float32),
        time=0.15 * t,
        index=t,
    )


def main():
    cfg = tiny_test_config()
    os.makedirs(OUT, exist_ok=True)
    for t in range(N_FRAMES):
        save_npz_frame(OUT, t, make_frame(cfg, t))

    # replay it and record the expected per-frame summary
    dsp = SemanticDSPMap(cfg, replay_tiny_params())
    frames = summarize_replay(dsp, NpzSequence(OUT), drop_first=2)
    expected = dict(n_frames=N_FRAMES, drop_first=2, frames=frames)
    with open(os.path.join(OUT, "EXPECTED.json"), "w") as f:
        json.dump(expected, f, indent=1)
    print(json.dumps(expected["frames"][-1]))
    print(f"wrote {N_FRAMES} frames + EXPECTED.json to {OUT}")


if __name__ == "__main__":
    main()
