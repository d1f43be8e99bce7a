"""Statistical end-to-end checks of the stochastic paths.

The full-frame oracle deliberately pins the noise paths off
(oracle_full.py: prediction_stddev=0, nb=1); these tests cover the excluded
corner DISTRIBUTIONALLY: nb=3 jittered births (semantic_dsp_map.h:1177-1230)
and the rigid-move prediction jitter (operations.h:279-313) must produce
samples whose mean/std match the configured Gaussians.

Tolerances: each check pools n >= 400 samples, so the sample std has
relative error ~1/sqrt(2n) < 4 % and the sample mean error ~sigma/sqrt(n);
the asserted 15 % / 4-sigma bounds leave >3x headroom, making flakes
(false alarms) vanishingly rare while still catching wrong-by-a-factor
noise wiring (e.g. sigma applied twice, or not at all)."""

import jax
import jax.numpy as jnp
import numpy as np

from semantic_dsp_map_tpu import FilterParams, MaskKpts, SemanticDSPMap
from semantic_dsp_map_tpu.config import tiny_test_config
from semantic_dsp_map_tpu.labels import LabelRegistry
from semantic_dsp_map_tpu.map import _move_and_cleanup
from semantic_dsp_map_tpu.ops import codecs
from semantic_dsp_map_tpu.state import (
    STATUS_REGULAR_BORN,
    init_map_state,
)


def test_jittered_birth_distribution():
    """nb_ptc_num_per_point=3 births spread as N(surface, sigma^2) per axis.

    Scene design notes (each avoids a way the surviving-particle sample
    would NOT be the candidate distribution):
      - the wall sits at z=1.1234, >4 sigma inside the map's z extent
        (births outside the torus are dropped, truncating the Gaussian);
      - only a sparse dot-grid of pixels is valid and K=7 slots/voxel, so
        per-voxel slot capacity essentially never binds (capacity keeps the
        first K by sweep priority — position-independent, but a binding cap
        flattens the per-voxel z profile)."""
    cfg = tiny_test_config(max_particle_num_per_voxel_n=3)
    sigma = 0.2
    params = FilterParams(
        if_consider_depth_noise=True,
        nb_ptc_num_per_point=3,
        depth_noise_model_zero_order=sigma,
        depth_noise_model_first_order=0.0,
    )
    wall_z = 1.1234

    zs = []
    for seed in range(6):
        dsp = SemanticDSPMap(cfg, params, LabelRegistry.default(), seed=seed)
        H, W = cfg.height, cfg.width
        depth = np.zeros((H, W), np.float32)  # 0 < depth_range_min: invalid
        depth[::4, ::4] = wall_z
        masks = [MaskKpts(track_id=65535, label="static",
                          mask=np.full((H, W), 6, np.uint8))]
        dsp.update(depth, masks, np.zeros(3, np.float32),
                   np.array([1, 0, 0, 0], np.float32), 0.0)
        p = dsp.state.particles
        born = np.asarray(p.status) == STATUS_REGULAR_BORN
        zs.append(np.asarray(p.pz)[born])
    z = np.concatenate(zs)
    assert z.size >= 400, z.size

    # identity pose: world z of an unjittered birth == its pixel's depth
    assert abs(z.mean() - wall_z) < 4 * sigma / np.sqrt(z.size)
    assert abs(z.std() - sigma) / sigma < 0.15

    # x must be jittered too (isotropic), around per-pixel backprojections:
    # compare against the binned expectation is overkill; the marginal std
    # of x = backprojected spread (+) jitter, so it must EXCEED sigma.
    # (Catches 'jitter only applied to depth' wiring bugs.)
    xs = np.asarray(p.px)[born]
    assert xs.std() > sigma


def test_move_prediction_jitter_distribution():
    """Rigid moves add N(0, prediction_stddev^2) per axis
    (operations.h:279-313 preset-sigma jitter): place particles on a coarse
    lattice, move the owning object by a pure translation, and check the
    residuals to the nearest translated lattice point."""
    cfg = tiny_test_config()
    stddev = 0.1
    params = FilterParams(prediction_stddev=stddev)
    registry = LabelRegistry.default()
    spacing = 0.8   # nearest-lattice pairing residual cap at 4 sigma:
    # P(|r| > 0.4) ~ 7e-4, so pairing truncation no longer deflates the std
    # measurably (at 0.6 spacing the 3-sigma cap deflated it ~5 %)
    shift = np.array([0.35113, 0.0, 0.25071], np.float32)

    res = []
    for seed in range(8):
        state = init_map_state(cfg, seed=seed)
        # lattice of track-3 particles (spacing >> stddev), inside the
        # +-2 m tiny map extent even after the shift
        grid = np.arange(-1.2, 1.21, spacing, dtype=np.float32)
        gx, gy, gz = np.meshgrid(grid, grid * 0.5, grid + 0.2)
        pos = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)
        n = pos.shape[0]
        K = cfg.slots_per_voxel
        p = state.particles
        px = np.asarray(p.px).copy(); py = np.asarray(p.py).copy()
        pz = np.asarray(p.pz).copy()
        st = np.asarray(p.status).copy(); trk = np.asarray(p.track).copy()
        w = np.asarray(p.weight).copy(); stmp = np.asarray(p.stamp).copy()
        import oracle_full  # noqa: F401  (sys.path already has tests/)
        from semantic_dsp_map_tpu.ops.codecs import global_pos_to_voxel

        vox, _, _, _, ok = global_pos_to_voxel(
            cfg, state.scroll, jnp.asarray(pos)
        )
        vox = np.asarray(vox); ok = np.asarray(ok)
        for i in range(n):
            if not ok[i]:
                continue
            slot = vox[i] * K  # slot 0 of the voxel (lattice: no collisions)
            px[slot], py[slot], pz[slot] = pos[i]
            st[slot] = STATUS_REGULAR_BORN
            trk[slot] = 3
            w[slot] = 0.4
            stmp[slot] = 1
        state = state.replace(particles=p.replace(
            px=jnp.asarray(px), py=jnp.asarray(py), pz=jnp.asarray(pz),
            status=jnp.asarray(st), track=jnp.asarray(trk),
            weight=jnp.asarray(w), stamp=jnp.asarray(stmp),
        ))
        objects = state.objects
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = shift
        objects = objects.replace(
            valid=objects.valid.at[0].set(True),
            track_id=objects.track_id.at[0].set(3),
            moving=objects.moving.at[0].set(True),
            has_moved_record=objects.has_moved_record.at[0].set(True),
            has_tmatrix=objects.has_tmatrix.at[0].set(True),
            tmatrix=objects.tmatrix.at[0].set(jnp.asarray(T)),
            last_obs_step=objects.last_obs_step.at[0].set(2),
        )
        particles, moved, _ovf = jax.jit(
            _move_and_cleanup, static_argnums=(0, 1, 7)
        )(cfg, params, state.particles, state.scroll, objects,
          jnp.int32(2), jax.random.PRNGKey(100 + seed),
          registry.max_movable_instance_id)
        assert int(moved) > 40

        vax = np.asarray(codecs.axis_stamps_per_voxel(cfg, state.scroll))
        alive = (
            (np.asarray(particles.status) != 0)
            & (np.asarray(particles.stamp) >= np.repeat(vax, K))
        )
        sel = alive & (np.asarray(particles.track) == 3)
        new = np.stack(
            [np.asarray(particles.px)[sel], np.asarray(particles.py)[sel],
             np.asarray(particles.pz)[sel]], -1,
        )
        # nearest translated lattice point = the particle's origin
        tgt = pos[None, :, :] + shift[None, None, :]
        d = np.linalg.norm(new[:, None, :] - tgt, axis=-1)
        j = np.argmin(d, axis=1)
        res.append(new - (pos[j] + shift))
    r = np.concatenate(res)
    assert r.shape[0] >= 400, r.shape
    for axis in range(3):
        assert abs(r[:, axis].mean()) < 4 * stddev / np.sqrt(r.shape[0])
        assert abs(r[:, axis].std() - stddev) / stddev < 0.15
