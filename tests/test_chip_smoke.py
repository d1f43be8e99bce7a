"""The parts of chip_smoke.py and of the shared entry-point helpers that the
CPU can check: the refusal to run without a GPU, the compile-cache location,
and the kernel comparison's inputs and error measure."""

import jax
import numpy as np
import pytest

import chip_smoke
from semantic_dsp_map_tpu import compile_cache
from semantic_dsp_map_tpu.config import tiny_test_config


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(RuntimeError, match="GPUs only"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(RuntimeError, match="GPUs only"):
        chip_smoke.require_gpu([])

    class Gpu:
        platform = "gpu"

    chip_smoke.require_gpu([Gpu(), Gpu()])


def test_compile_cache_uses_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = compile_cache.os.path.dirname(compile_cache.os.path.dirname(compile_cache.__file__))
    assert compile_cache.cache_dir() == compile_cache.os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == compile_cache.enable_compile_cache(0.1)


def test_stencil_inputs_are_front_filled():
    cfg = tiny_test_config(phd_pixel_table_slots=4)
    t, cloud = chip_smoke.synth_stencil_inputs(cfg, mean_depth=1.0)
    occ = np.asarray(t.meta) >= 0
    assert occ.shape == (4, cfg.height, cfg.width)
    # A slot is occupied only where every slot in front of it is.
    assert not np.any(occ[1:] & ~occ[:-1])
    assert 0.1 < occ[0].mean() < 0.9
    assert np.all(np.asarray(t.weight)[~occ] == 0)
    assert np.isfinite(np.asarray(cloud.pos)).all()


def test_kernel_error_measure():
    ref = np.array([1.0, 2.0, 0.0])
    assert chip_smoke._errors(ref, ref)["ok"]
    assert chip_smoke._errors(ref, ref * (1 + 0.5 * chip_smoke.KERNEL_RTOL))["ok"]
    bad = chip_smoke._errors(ref, ref * (1 + 2 * chip_smoke.KERNEL_RTOL))
    assert not bad["ok"] and bad["max_rel"] > chip_smoke.KERNEL_RTOL


def test_four_card_phase_on_virtual_mesh():
    """The --four-cards comparison on 4 of the virtual CPU devices, at a
    small grid whose map still holds the bench scene (2 m voxels)."""
    cfg = tiny_test_config(
        voxel_size=2.0, depth_range_max=30.0, image_width=64, image_height=32,
        camera_fx=40.0, camera_fy=40.0, camera_cx=32.0, camera_cy=16.0,
    )
    res = chip_smoke.phase_four_cards("cpu", cfg=cfg, frames=6)
    assert res["static"]["ok"] and res["movers"]["ok"]
    assert res["static"]["occ_voxels_differing"] == [0] * 6


def test_precision_phase_pins_hold_on_this_backend(capsys):
    """The precision phase's own check: with the pinned products every
    pixel centre of the VKITTI2 frame returns to its pixel."""
    res = chip_smoke.phase_precision("cpu")
    assert res["points"] == 1242 * 375
    assert res["highest"]["pixel_differs"] == 0
    assert "[precision]" in capsys.readouterr().out


def test_bench_sharded_check_keeps_the_donated_state():
    """bench.run_sharded_check on the 8-device mesh: the sharded step
    donates its state, so the timed loop must carry the returned one."""
    import bench

    res = bench.run_sharded_check(iters=2, cfg=tiny_test_config())
    assert res["render_equal_vs_plain"]
    assert res["frames"] == 2 and res["fps"] > 0
