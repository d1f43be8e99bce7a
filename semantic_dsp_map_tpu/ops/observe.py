"""The fused per-frame observation update: visibility + PHD + write-back.

This is the production implementation of the reference's weight-update phase
(semantic_dsp_map.h:742-764): updateVisibleParitlcesWithBFS
(operations.h:1297-1457) followed by updateParticles
(semantic_dsp_map.h:960-1121), re-designed around the cost model of
ops/blocks.py:

  - no full-state compaction (no jnp.nonzero over [V, K]);
  - active voxel *blocks* are row-gathered into a dense working set
    (ops/blocks.py), where all per-particle math is dense;
  - one multi-operand sort by (pixel, camera depth) produces the compact
    entry array for the PHD pixel table; closest-to-camera particles win the
    per-pixel slots, so occluded particles lose slot competition naturally;
  - occlusion / far-free classification happens on the compact entries with
    a single small depth gather — never a [V, K]-wide one;
  - all particle-state mutations (stale prune, far-free weight reset, PHD
    weight/status/stamp/forget, voxel observation stamps) are merged into the
    working set and written back with whole-row scatters.

Reference semantics preserved (file:line cites):
  - stale-slot pruning on visit           operations.h:1374-1377
  - far-depth free-space weight reset     operations.h:1389-1395
  - one-sigma occlusion slack             operations.h:1397-1400
  - voxel stamp refresh incl. the empty-voxel "imaginary center particle"
    rule                                  operations.h:1414-1431
  - PHD passes: see ops/phd.py docstring.

Capacity caps (active blocks, entries, table slots, corner blocks) are all
surfaced in :class:`ObserveDiag` — no silent loss anywhere.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import FilterParams, MapConfig, PARTICLE_OCC_INIT_WEIGHT
from ..state import Particles, STATUS_INVALID, STATUS_UPDATED, particles_vk
from . import codecs
from .blocks import (
    block_layout,
    gather_rows_flat,
    mask_to_block_mask,
    row_valid,
    scatter_rows_flat,
    select_blocks,
)
from .geometry import project_to_image, project_to_image_xyz
from .phd import stencil_passes, table_from_entries
from .projection import LabeledCloud


class ObserveDiag(NamedTuple):
    visible_count: jax.Array    # i32 particles in the pixel table domain
    block_overflow: jax.Array   # i32 active blocks beyond capacity
    entry_overflow: jax.Array   # i32 candidate entries beyond capacity
    table_dropped: jax.Array    # i32 visible entries that lost slot competition
    corner_overflow: jax.Array  # i32 empty-voxel blocks beyond capacity


def _seg_cumsum(vals: jax.Array, is_start: jax.Array) -> jax.Array:
    """Inclusive cumulative sum that resets at segment starts."""

    def comb(a, b):
        va, sa = a
        vb, sb = b
        return jnp.where(sb, vb, va + vb), sa | sb

    out, _ = jax.lax.associative_scan(comb, (vals, is_start))
    return out


@partial(jax.jit, static_argnums=(0, 1))
def observe_and_update(
    cfg: MapConfig,
    params: FilterParams,
    particles: Particles,
    scroll,
    voxel_stamp: jax.Array,
    cloud: LabeledCloud,
    depth: jax.Array,
    r_cw: jax.Array,
    t_cw: jax.Array,
    global_time,
):
    """Returns (particles', voxel_stamp', ObserveDiag)."""
    H, W, S = cfg.height, cfg.width, cfg.phd_pixel_table_slots
    HW = H * W
    K = cfg.slots_per_voxel
    bv, nb, spb = block_layout(cfg)
    A = min(cfg.max_active_blocks, nb)
    C = min(cfg.max_table_entries, A * spb)

    flat = particles          # flat storage (linear layout)
    particles = particles_vk(cfg, particles)  # [V, K] views, free inside jit

    # ---- dense [V, K] pass: who can project into the image ----
    vox_axis = codecs.axis_stamps_per_voxel(cfg, scroll)
    alive = codecs.particle_alive(particles.status, particles.stamp, vox_axis)
    _, _, _, proj_ok = project_to_image_xyz(
        cfg, r_cw, t_cw, particles.px, particles.py, particles.pz
    )
    cand = proj_ok & alive
    has_alive = jnp.any(alive, axis=1)
    block_mask = mask_to_block_mask(cand, bv)

    # ---- active-block working set ----
    blocks = select_blocks(block_mask, A)
    rv = row_valid(blocks)

    # Flat sliced gathers: only the working set's rows move (the
    # reshape-based row gather relayouts the WHOLE state per field).
    g = lambda f: gather_rows_flat(f, blocks, spb)
    bpx, bpy, bpz = g(flat.px), g(flat.py), g(flat.pz)
    bw = g(flat.weight)
    bst = g(flat.status).astype(jnp.int32)
    bstamp = g(flat.stamp).astype(jnp.int32)
    bforget = g(flat.forget).astype(jnp.int32)
    btrack = g(flat.track).astype(jnp.int32)
    baxis = jnp.repeat(gather_rows_flat(vox_axis, blocks, bv), K, axis=1)

    not_invalid = bst != STATUS_INVALID
    fresh = bstamp >= baxis
    balive = not_invalid & fresh & rv[:, None]
    # Stale-slot pruning on visit (operations.h:1374-1377): the reference
    # invalidates stale slots of BFS-visited voxels; visited == active blocks.
    bst = jnp.where(not_invalid & ~fresh & rv[:, None], STATUS_INVALID, bst)

    brow, bcol, bcamz, bok = project_to_image_xyz(cfg, r_cw, t_cw, bpx, bpy, bpz)
    bcand = bok & balive
    pix = jnp.where(bcand, brow * W + bcol, HW)
    n_work = A * spb
    src = jax.lax.broadcasted_iota(jnp.int32, (n_work, 1), 0).squeeze(-1)
    # (btrack/bforget were widened to i32 at gather time: the storage dtypes
    # are u16/u8 and would overflow the shift.)
    meta = (btrack << 8) | (bforget & 0xFF)

    # ---- one multi-operand sort by (pixel, camera depth) ----
    (pix_s, _camz_s, px_s, py_s, pz_s, w_s, meta_s, src_s) = jax.lax.sort(
        (
            pix.reshape(-1),
            bcamz.reshape(-1),
            bpx.reshape(-1),
            bpy.reshape(-1),
            bpz.reshape(-1),
            bw.reshape(-1),
            meta.reshape(-1),
            src,
        ),
        num_keys=2,
    )
    pix_s, camz_s = pix_s[:C], _camz_s[:C]
    px_s, py_s, pz_s, w_s = px_s[:C], py_s[:C], pz_s[:C], w_s[:C]
    meta_s, src_s = meta_s[:C], src_s[:C]

    entry_total = jnp.sum(bcand.astype(jnp.int32))
    entry_overflow = jnp.maximum(entry_total - C, 0)

    # ---- classification on the compact entries ----
    real = pix_s < HW
    depth_at = depth.reshape(-1)[jnp.minimum(pix_s, HW - 1)]
    one_sigma = 1.0 + cfg.depth_error_stddev_at_one_meter
    far_free = real & (depth_at > cfg.depth_range_max)
    occluded = real & ~far_free & (camz_s > depth_at * one_sigma)
    visible = real & ~far_free & ~occluded

    # ---- rank among visible entries of the same pixel (front-most first) ----
    is_start = jnp.concatenate([jnp.ones(1, bool), pix_s[1:] != pix_s[:-1]])
    vrank = _seg_cumsum(visible.astype(jnp.int32), is_start) - 1
    keep = visible & (vrank < S)

    # ---- PHD stencil over the dense pixel table ----
    table = table_from_entries(
        cfg, jnp.where(visible, pix_s, HW), vrank, keep,
        px_s, py_s, pz_s, w_s, meta_s >> 8, meta_s & 0xFF,
    )
    ck_kappa, new_w_t, new_f_t = stencil_passes(cfg, params, table, cloud)

    dest = jnp.where(keep, jnp.minimum(vrank, S - 1) * HW + pix_s, 0)
    # ONE row-gather for both result planes instead of two element gathers;
    # forget counts (<= 255) are exact in f32.
    res_t = jnp.stack(
        [new_w_t.reshape(-1), new_f_t.reshape(-1).astype(jnp.float32)], axis=-1
    )
    res_e = res_t[dest]
    nw_e = res_e[:, 0]
    nf_e = res_e[:, 1].astype(jnp.int32)

    # ---- per-entry results, unsorted back into the working set ----
    w_out = jnp.where(
        keep, nw_e, jnp.where(far_free, PARTICLE_OCC_INIT_WEIGHT, w_s)
    )
    touched_w = keep | far_free
    observed = visible | far_free
    meta_out = (
        (jnp.where(keep, nf_e, 0) & 0xFF)
        | (keep.astype(jnp.int32) << 8)
        | (touched_w.astype(jnp.int32) << 9)
        | (observed.astype(jnp.int32) << 10)
    )
    iota_c = jax.lax.broadcasted_iota(jnp.int32, (C, 1), 0).squeeze(-1)
    back_idx = jnp.where(real, src_s, n_work + iota_c)  # unique OOR pads
    w_back = jnp.zeros(n_work, jnp.float32).at[back_idx].set(
        w_out, mode="drop", unique_indices=True
    ).reshape(A, spb)
    m_back = jnp.zeros(n_work, jnp.int32).at[back_idx].set(
        meta_out, mode="drop", unique_indices=True
    ).reshape(A, spb)

    upd = (m_back >> 8) & 1
    touched = (m_back >> 9) & 1
    obs_e = (m_back >> 10) & 1

    bw = jnp.where(touched == 1, w_back, bw)
    bst = jnp.where(upd == 1, STATUS_UPDATED, bst)
    bstamp = jnp.where(upd == 1, global_time, bstamp)
    bforget = jnp.where(upd == 1, m_back & 0xFF, bforget)

    # ---- write back particle rows (flat sliced scatters) ----
    out_particles = flat.replace(
        weight=scatter_rows_flat(flat.weight, blocks, spb, bw),
        status=scatter_rows_flat(flat.status, blocks, spb, bst),
        stamp=scatter_rows_flat(flat.stamp, blocks, spb, bstamp),
        forget=scatter_rows_flat(flat.forget, blocks, spb, bforget),
    )

    # ---- voxel observation stamps from particle evidence ----
    obs_vox = jnp.any((obs_e == 1).reshape(A, bv, K), axis=2)
    bvst = gather_rows_flat(voxel_stamp, blocks, bv)
    bvst = jnp.where(obs_vox & rv[:, None], global_time, bvst)
    voxel_stamp = scatter_rows_flat(voxel_stamp, blocks, bv, bvst)

    # ---- empty-voxel stamps (imaginary center particle rule) ----
    voxel_stamp, corner_overflow = refresh_empty_voxel_stamps(
        cfg, scroll, voxel_stamp, has_alive, depth, r_cw, t_cw, global_time,
        vox_axis=vox_axis,
    )

    diag = ObserveDiag(
        visible_count=jnp.sum(visible.astype(jnp.int32)),
        block_overflow=blocks.overflow,
        entry_overflow=entry_overflow,
        table_dropped=table.dropped,
        corner_overflow=corner_overflow,
    )
    return out_particles, voxel_stamp, diag


def refresh_empty_voxel_stamps(
    cfg: MapConfig,
    scroll,
    voxel_stamp: jax.Array,
    has_alive: jax.Array,
    depth: jax.Array,
    r_cw: jax.Array,
    t_cw: jax.Array,
    global_time,
    vox_base=0,
    vox_axis=None,
):
    """Stamp voxels with no live particles whose corner point projects in
    front of the measured surface (operations.h:1414-1431).

    The corner (not center) is the reference's actual sample point — its
    "imaginary particle in the central of the voxel" uses idx*size + p_min
    (operations.h:969-983).  Runs over 512-voxel blocks of the frustum, the
    only element gather being the depth lookup on the needed voxels.

    Bounded deviation (round 5): voxels whose stamp is ALREADY VALID
    (voxel_valid: stamp != 0 and >= the per-axis scroll stamp) are skipped.
    The reference re-stamps every visited empty voxel every frame, but the
    stamp VALUE is only ever consumed through the validity test — skipping
    the refresh is render-equivalent and shrinks the working set from "the
    whole observed frustum" to "newly wrapped-in or still-occluded voxels".
    The scalar oracle (tests/oracle_full.py) mirrors the same rule.

    ``vox_base`` offsets local voxel ids to global ones (voxel-slab sharding,
    parallel/shard_step.py); sizes derive from ``voxel_stamp``.
    """
    V = voxel_stamp.shape[0]
    H, W = cfg.height, cfg.width
    bs = min(512, V)
    nb2 = V // bs
    A2 = min(cfg.corner_gather_blocks, nb2)

    corner = codecs.voxel_to_global_pos(
        cfg, scroll,
        vox_base
        + jax.lax.broadcasted_iota(jnp.int32, (V, 1), 0).squeeze(-1),
    )
    crow, ccol, cz, cok = project_to_image(cfg, r_cw, t_cw, corner)
    need = ~has_alive & cok
    if vox_axis is not None:
        need = need & ~codecs.voxel_valid(voxel_stamp, vox_axis)

    blocks = select_blocks(need.reshape(nb2, bs).any(axis=1), A2)
    rv = row_valid(blocks)

    bneed = gather_rows_flat(need, blocks, bs) & rv[:, None]
    brow = gather_rows_flat(crow, blocks, bs)
    bcol = gather_rows_flat(ccol, blocks, bs)
    bcz = gather_rows_flat(cz, blocks, bs)

    pixd = (
        jnp.clip(brow, 0, H - 1) * W + jnp.clip(bcol, 0, W - 1)
    ).reshape(-1)
    depth_at = depth.reshape(-1)[pixd].reshape(A2, bs)
    observed = bneed & (bcz <= depth_at)

    bvst = gather_rows_flat(voxel_stamp, blocks, bs)
    bvst = jnp.where(observed, global_time, bvst)
    return scatter_rows_flat(voxel_stamp, blocks, bs, bvst), blocks.overflow
