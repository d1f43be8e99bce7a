"""Checkpoint / resume for the map state.

The reference has NO persistence — state is reset-only
(SemanticDSPMap::clear, semantic_dsp_map.h:73-81).  Because the
map state is one pytree of dense arrays (state.MapState), checkpointing is a
single orbax save/restore; this enables long KITTI-360 sequences to survive
restarts (SURVEY.md section 5 "Checkpoint / resume").

Orbax is used when available; a numpy .npz fallback covers minimal
environments.  Both formats store the same flat leaf dict.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import jax
import numpy as np

from .config import MapConfig
from .state import MapState, init_map_state


def _flatten(state: MapState):
    leaves, treedef = jax.tree_util.tree_flatten(state)
    return leaves, treedef


def save_checkpoint(path: str, state: MapState, step: Optional[int] = None):
    """Save the full map state under ``path`` (a directory)."""
    os.makedirs(path, exist_ok=True)
    leaves, _ = _flatten(state)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    meta = {"num_leaves": len(leaves), "step": step}

    try:
        import orbax.checkpoint as ocp

        ckpt_dir = os.path.join(os.path.abspath(path), "orbax")
        ckptr = ocp.PyTreeCheckpointer()
        ckptr.save(ckpt_dir, arrays, force=True)
        meta["format"] = "orbax"
    except ImportError:
        np.savez_compressed(os.path.join(path, "state.npz"), **arrays)
        meta["format"] = "npz"

    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, cfg: MapConfig) -> MapState:
    """Restore a map state saved by :func:`save_checkpoint`.

    ``cfg`` must match the saved configuration (shapes are validated by the
    tree structure)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    if meta["format"] == "orbax":
        import orbax.checkpoint as ocp

        ckptr = ocp.PyTreeCheckpointer()
        arrays = ckptr.restore(os.path.join(os.path.abspath(path), "orbax"))
    else:
        with np.load(os.path.join(path, "state.npz")) as z:
            arrays = {k: z[k] for k in z.files}

    template = init_map_state(cfg)
    leaves, treedef = _flatten(template)
    if meta["num_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {meta['num_leaves']} leaves; config produces "
            f"{len(leaves)} — config mismatch?"
        )
    restored = []
    for i, ref in enumerate(leaves):
        arr = np.asarray(arrays[f"leaf_{i}"])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != config shape {ref.shape}"
            )
        restored.append(jax.numpy.asarray(arr, dtype=ref.dtype))
    return jax.tree_util.tree_unflatten(treedef, restored)
