"""End-to-end smoke: a few frames on a tiny config run without error and
produce sane occupancy."""

import numpy as np
import pytest

from semantic_dsp_map_tpu import FilterParams, MaskKpts, SemanticDSPMap
from semantic_dsp_map_tpu.config import tiny_test_config


def make_depth(cfg, wall_z=1.5):
    """A flat fronto-parallel wall at distance wall_z."""
    return np.full((cfg.height, cfg.width), wall_z, np.float32)


def static_mask(cfg, label_value=6):
    """One static MaskKpts whose pixels hold label_id - 1
    (docs/custom_files.md:43-47)."""
    m = np.full((cfg.height, cfg.width), label_value - 1, np.uint8)
    return MaskKpts(track_id=65535, label="static", mask=m)


def test_smoke_static_wall():
    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, FilterParams(nb_ptc_num_per_point=1))

    pos = np.zeros(3, np.float32)
    quat = np.array([1.0, 0, 0, 0], np.float32)  # identity: camera looks +z

    for t in range(5):
        result, diag = dsp.update(
            make_depth(cfg), [static_mask(cfg)], pos, quat, time=t * 0.1
        )

    occ = np.asarray(result.occ)
    assert (occ == 1).sum() > 0, "wall voxels should become occupied"
    # The wall is at z=3, voxel size 0.25 -> occupied voxels near z=3.
    from semantic_dsp_map_tpu.viz import voxel_positions

    vp = voxel_positions(cfg, dsp.state.scroll)
    occ_z = vp[occ == 1][:, 2]
    assert np.all(occ_z > 1.0) and np.all(occ_z < 2.0)
    # Building label (6) should dominate the occupied voxels.
    lab = np.asarray(result.label)[occ == 1]
    assert (lab == 6).mean() > 0.9


def test_smoke_freespace_and_unknown():
    cfg = tiny_test_config()
    dsp = SemanticDSPMap(cfg, FilterParams(nb_ptc_num_per_point=1))
    pos = np.zeros(3, np.float32)
    quat = np.array([1.0, 0, 0, 0], np.float32)
    for t in range(3):
        result, _ = dsp.update(make_depth(cfg), [static_mask(cfg)], pos, quat, t * 0.1)
    occ = np.asarray(result.occ)
    # Space between camera and wall should be observed free; behind camera unknown.
    from semantic_dsp_map_tpu.viz import voxel_positions

    vp = voxel_positions(cfg, dsp.state.scroll)
    behind = vp[:, 2] < -0.5
    assert (occ[behind] == -1).all(), "voxels behind the camera stay unknown"
    assert (occ == 0).sum() > 0, "free voxels in front of the wall"


def test_map_state_pytree_round_trip_under_jit():
    """MapState and its parts are registered dataclasses: they flatten and
    rebuild as pytrees, and ``.replace`` works inside jit."""
    import jax
    import jax.numpy as jnp

    from semantic_dsp_map_tpu.config import tiny_test_config
    from semantic_dsp_map_tpu.state import MapState, init_map_state

    state = init_map_state(tiny_test_config(), seed=3)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    rebuilt = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(rebuilt, MapState)

    @jax.jit
    def bump(s):
        return s.replace(
            global_time=s.global_time + 1,
            scroll=s.scroll.replace(ego_pos=s.scroll.ego_pos + 2.0),
            particles=s.particles.replace(weight=s.particles.weight + 0.5),
        )

    out = bump(rebuilt)
    assert int(out.global_time) == 1
    np.testing.assert_array_equal(np.asarray(out.scroll.ego_pos), [2.0, 2.0, 2.0])
    assert float(jnp.min(out.particles.weight)) == 0.5
    assert jax.tree_util.tree_structure(out) == treedef
    with pytest.raises(Exception):
        state.global_time = jnp.int32(5)  # frozen
