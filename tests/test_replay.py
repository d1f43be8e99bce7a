"""Replay the committed npz sequence (data/replay_tiny) and assert the
occupancy summary matches the committed EXPECTED.json — the framework's
analog of the reference's bag-replay validation (README.md:49-70), kept
in-tree so full-frame semantic regressions are visible in CI.

Regenerate the artifact after an intentional semantics change with
``python tools/make_replay_sequence.py``.
"""

import json
import os

from semantic_dsp_map_tpu import SemanticDSPMap
from semantic_dsp_map_tpu.config import tiny_test_config
from semantic_dsp_map_tpu.datasets import NpzSequence
from semantic_dsp_map_tpu.replay import replay_tiny_params, summarize_replay

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "replay_tiny")


def test_committed_replay_matches_expected():
    with open(os.path.join(DATA, "EXPECTED.json")) as f:
        expected = json.load(f)

    dsp = SemanticDSPMap(tiny_test_config(), replay_tiny_params())
    seq = NpzSequence(DATA)
    assert len(seq) == expected["n_frames"]
    got = summarize_replay(dsp, seq, expected["drop_first"])
    assert got == expected["frames"]
