"""Pallas PHD stencil kernels vs the XLA stencils (the tested oracle).

Runs the Triton-route kernels in interpreter mode on the CPU backend at tiny
shapes; chip_smoke.py compares the compiled kernels with the XLA stencils on
the GPU at the VKITTI2 and ZED2 shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from semantic_dsp_map_tpu.config import FilterParams, tiny_test_config
from semantic_dsp_map_tpu.ops import phd_pallas
from semantic_dsp_map_tpu.ops.phd import PixelTable, stencil_pass_a, stencil_pass_b
from semantic_dsp_map_tpu.ops.projection import LabeledCloud


def _inputs(cfg, seed=0, fill=0.4, front_fill=False):
    rng = np.random.RandomState(seed)
    H, W, S = cfg.height, cfg.width, cfg.phd_pixel_table_slots
    if front_fill:
        # Realistic front-filled table: slot s occupied only if s-1 is, so
        # high slot planes are empty — exercises the kernels' slot-group
        # liveness skip (dead planes must contribute exact zeros / keep
        # their weight).
        depth_per_pixel = rng.poisson(fill * S, (1, H, W))
        occ = np.arange(S)[:, None, None] < depth_per_pixel
    else:
        occ = rng.rand(S, H, W) < fill
    track = rng.randint(0, 5, (S, H, W)).astype(np.int32)
    forget = rng.randint(0, 6, (S, H, W)).astype(np.int32)
    meta = np.where(occ, (track << 8) | forget, -1).astype(np.int32)
    t = PixelTable(
        px=jnp.asarray(np.where(occ, rng.randn(S, H, W), 0).astype(np.float32)),
        py=jnp.asarray(np.where(occ, rng.randn(S, H, W), 0).astype(np.float32)),
        pz=jnp.asarray(np.where(occ, rng.rand(S, H, W) * 4 + 1, 0).astype(np.float32)),
        weight=jnp.asarray(np.where(occ, rng.rand(S, H, W), 0).astype(np.float32)),
        meta=jnp.asarray(meta),
        dropped=jnp.int32(0),
    )
    cloud = LabeledCloud(
        pos=jnp.asarray(
            (rng.randn(H, W, 3) + np.array([0, 0, 2.5])).astype(np.float32)
        ),
        sigma=jnp.asarray((0.2 + rng.rand(H, W) * 0.2).astype(np.float32)),
        label=jnp.asarray(rng.randint(0, 10, (H, W)).astype(np.int32)),
        track=jnp.asarray(rng.randint(0, 5, (H, W)).astype(np.int32)),
        valid=jnp.asarray(rng.rand(H, W) < 0.85),
    )
    return t, cloud


@pytest.mark.parametrize(
    "independent,front_fill,fill,R,tile",
    [
        (False, False, 0.4, None, (8, 16)),
        (True, False, 0.4, None, (8, 16)),
        (False, True, 0.12, None, (8, 16)),
        # 24x32 image against a 16x64 tile: neither side is a multiple.
        (False, True, 0.3, 3, (16, 64)),
    ],
)
def test_pallas_stencils_match_xla(independent, front_fill, fill, R, tile):
    cfg = tiny_test_config(phd_pixel_table_slots=4, phd_neighbor_half=R)
    params = FilterParams(
        detection_probability=0.9,
        noise_number=0.1,
        if_use_independent_filter=independent,
        if_consider_depth_noise=True,
    )
    t, cloud = _inputs(cfg, fill=fill, front_fill=front_fill)

    ck_x = stencil_pass_a(cfg, params, t, cloud)
    nw_x, nf_x = stencil_pass_b(cfg, params, t, cloud, ck_x)

    kw = dict(interpret=True, tile=tile)
    ck_p = phd_pallas.pass_a(cfg, params, t, cloud, **kw)
    np.testing.assert_allclose(np.asarray(ck_x), np.asarray(ck_p), rtol=2e-5, atol=1e-6)

    nw_p, nf_p = phd_pallas.pass_b(cfg, params, t, cloud, ck_p, **kw)
    np.testing.assert_allclose(np.asarray(nw_x), np.asarray(nw_p), rtol=2e-5, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(nf_x), np.asarray(nf_p))


def test_pallas_tile_must_be_power_of_two():
    cfg = tiny_test_config(phd_pixel_table_slots=4)
    t, cloud = _inputs(cfg)
    with pytest.raises(ValueError, match="powers of two"):
        phd_pallas.pass_a(cfg, FilterParams(), t, cloud, interpret=True, tile=(12, 16))


@pytest.mark.gpu
def test_compiled_kernels_match_xla_on_gpu():
    """The compiled (not interpreted) kernels at the VKITTI2 shape."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this comparison on the card")
    import chip_smoke

    chip_smoke.phase_kernels(jax.devices()[0].device_kind)
