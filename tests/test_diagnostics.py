"""Every capacity cap must fire its StepDiagnostics counter when exceeded —
no silent truncation anywhere in the frame."""

import numpy as np
import pytest

from semantic_dsp_map_tpu import FilterParams, MaskKpts, SemanticDSPMap
from semantic_dsp_map_tpu.config import tiny_test_config


def _run(cfg, n_frames=3, params=None):
    dsp = SemanticDSPMap(cfg, params or FilterParams(nb_ptc_num_per_point=1))
    H, W = cfg.height, cfg.width
    # Slanted wall: depth 1.0..2.0 across rows, so occupied voxels span
    # several z-layers (= several storage blocks).
    depth = (1.0 + np.arange(H, dtype=np.float32)[:, None] / H) * np.ones(
        (1, W), np.float32
    )
    mask = MaskKpts(
        track_id=65535, label="static",
        mask=np.full((H, W), 5, np.uint8),
    )
    pos = np.zeros(3, np.float32)
    quat = np.array([1.0, 0, 0, 0], np.float32)
    diag = None
    peak = None
    for t in range(n_frames):
        _, diag = dsp.update(depth, [mask], pos, quat, t * 0.1)
        d = {k: int(np.asarray(v)) for k, v in diag._asdict().items()}
        peak = d if peak is None else {k: max(peak[k], d[k]) for k in d}
    _run.peak = peak
    return diag


def test_no_overflow_at_default_capacity():
    diag = _run(tiny_test_config())
    assert int(diag.block_overflow) == 0
    assert int(diag.entry_overflow) == 0
    assert int(diag.corner_overflow) == 0
    assert int(diag.birth_overflow) == 0
    assert int(diag.visible_count) > 0


def test_block_overflow_counter_fires():
    # One observe-side active block allowed: the birth path (its own
    # max_birth_blocks cap) still populates many blocks with particles, so
    # the observe working set must overflow.
    diag = _run(tiny_test_config(max_active_blocks=1))
    assert int(diag.block_overflow) > 0


def test_entry_overflow_counter_fires():
    diag = _run(tiny_test_config(max_table_entries=64))
    assert int(diag.entry_overflow) > 0


def test_table_dropped_counter_fires():
    # One slot per pixel; several birth frames stack >1 visible particle on
    # the wall pixels.
    diag = _run(tiny_test_config(phd_pixel_table_slots=1), n_frames=4)
    assert int(diag.table_dropped) > 0


def test_corner_overflow_counter_fires():
    # The validity-filtered corner pass (round 5) drains its working set
    # over frames — an undersized cap fires on the EARLY frames while the
    # frustum is still being stamped, then the backlog clears.  Check the
    # peak across frames, not the final (drained) frame.
    _run(tiny_test_config(corner_gather_blocks=1))
    assert _run.peak["corner_overflow"] > 0


def test_birth_overflow_counter_fires():
    diag = _run(tiny_test_config(max_birth_blocks=1))
    assert int(diag.birth_overflow) > 0
