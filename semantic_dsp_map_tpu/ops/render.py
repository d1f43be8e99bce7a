"""Occupancy + semantics rendering (hot loop #4).

Reimplements getOccupancyResult / determineIfVoxelOccupied /
calculateWeightAndSemanticsInVoxel (semantic_dsp_map.h:1239-1383,
operations.h:390-448, 606-639) as dense per-voxel segment reductions.

The reference's reduction has *side effects* that are load-bearing and kept:
  - weights above 1 are clamped in storage (operations.h:417-419);
  - live UPDATED particles with weight below the newborn weight are
    garbage-collected to INVALID and excluded from the semantics argmax
    (operations.h:423-427) — note their weight still entered weight_sum.

Occupancy code per voxel (operations.h:623-639):
  -1 unknown (voxel never observed / wrapped out), 0 free, 1 occupied
  (weight_sum > threshold), 2 guessed-occupied (guessed weight >= newborn
  weight).  Semantics are the (label, track) of the track id with the largest
  summed weight; ties resolve to the lowest track id (std::map iteration
  order with a strict '>' update, operations.h:439-448).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MapConfig, PARTICLE_OCC_INIT_WEIGHT
from ..state import (
    MapState,
    Particles,
    STATUS_GUESSED_BORN,
    STATUS_INVALID,
    STATUS_UPDATED,
    particles_flat,
    particles_vk,
)
from . import codecs


class RenderResult(NamedTuple):
    occ: jax.Array         # i32[V]: -1 unknown, 0 free, 1 occupied, 2 guessed
    label: jax.Array       # i32[V]
    track: jax.Array       # i32[V]
    weight_sum: jax.Array  # f32[V] (−1 for unknown voxels)
    # NOTE: voxel positions are pure scroll-state index arithmetic and are
    # computed HOST-side (viz.voxel_positions) — materializing an [V, 3]
    # array on device pays a tiny-minor-dim layout penalty every frame.


def _render_chunk(cfg: MapConfig, occupancy_threshold: float,
                  weight_f, label_f, track_f, status_f, stamp_f, vax, vst):
    """Per-voxel reduction over one contiguous chunk of voxels.

    All render math is voxel-local, so big grids stream through fixed-size
    chunks (lax.map in render_core_xla), which bounds the temporaries of the
    fused whole-grid program at KITTI-360 scale.  Returns (occ, label, track,
    weight_sum, new_weight_flat, new_status_flat)."""
    K = cfg.slots_per_voxel
    Vc = vax.shape[0]

    class _P:
        weight = weight_f.reshape(Vc, K)
        label = label_f.reshape(Vc, K)
        track = track_f.reshape(Vc, K)
        status = status_f.reshape(Vc, K)
        stamp = stamp_f.reshape(Vc, K)

    p = _P
    alive = (p.status != STATUS_INVALID) & (p.stamp >= vax[:, None])
    vvalid = (vst != 0) & (vst >= vax)

    w = p.weight
    # weight_sum accumulates the *pre-clamp* weights (operations.h:414).
    weight_sum = jnp.sum(jnp.where(alive, w, 0.0), axis=1)

    w_clamped = jnp.minimum(w, 1.0)
    guessed = alive & (p.status == STATUS_GUESSED_BORN)
    gc = alive & (p.status == STATUS_UPDATED) & (w_clamped < PARTICLE_OCC_INIT_WEIGHT)

    guessed_weight = jnp.sum(jnp.where(guessed, w_clamped, 0.0), axis=1)

    # Per-(voxel, track) weight accumulation over the K slots: each slot
    # sums the contributions of the slots carrying its track (a [Vc, K, K]
    # compare that XLA fuses into the reduction).
    contrib_mask = alive & ~gc
    contrib = jnp.where(contrib_mask, w_clamped, 0.0)
    same = p.track[:, :, None] == p.track[:, None, :]
    track_sum = jnp.sum(jnp.where(same, contrib[:, None, :], 0.0), axis=2)

    # Argmax by (track weight, then lowest track id), restricted to
    # contributing slots with positive summed weight (max_weight starts at 0
    # with a strict '>', operations.h:440-447).
    big = jnp.int32(1 << 30)
    score_ok = contrib_mask & (track_sum > 0.0)
    best_w = jnp.max(jnp.where(score_ok, track_sum, -1.0), axis=1)
    found = best_w > 0.0
    is_best = score_ok & (track_sum == best_w[:, None])
    best_track = jnp.min(jnp.where(is_best, p.track, big), axis=1)

    # Label of the winning track = label of the highest-index contributing
    # slot carrying that track (last writer wins in the reference's map,
    # operations.h:435): encode (slot << 8 | label) and max-reduce.
    slot_idx = jax.lax.broadcasted_iota(jnp.int32, (Vc, K), 1)
    match = contrib_mask & (p.track == best_track[:, None])
    pick = jnp.max(jnp.where(match, (slot_idx << 8) | (p.label & 0xFF), -1), axis=1)
    best_label = jnp.where(pick >= 0, pick & 0xFF, 0)

    best_track = jnp.where(found, best_track, 0)
    best_label = jnp.where(found, best_label, 0)

    weight_sum = jnp.where(vvalid, weight_sum, -1.0)
    guessed_weight = jnp.where(vvalid, guessed_weight, 0.0)
    best_track = jnp.where(vvalid, best_track, 0)
    best_label = jnp.where(vvalid, best_label, 0)

    occ = jnp.where(
        weight_sum > occupancy_threshold,
        1,
        jnp.where(
            weight_sum < 0,
            -1,
            jnp.where(guessed_weight >= PARTICLE_OCC_INIT_WEIGHT, 2, 0),
        ),
    ).astype(jnp.int32)

    # Side effects: clamp stored weights, GC feeble UPDATED particles — but
    # only in *valid* voxels: the reference's reduction early-returns before
    # touching particles when the voxel is invalid (operations.h:401-407).
    touched = alive & vvalid[:, None]
    new_weight = jnp.where(touched, w_clamped, w)
    new_status = jnp.where(gc & vvalid[:, None], STATUS_INVALID, p.status)

    return (occ, best_label, best_track, weight_sum,
            new_weight.reshape(-1), new_status.reshape(-1))


#: Voxels per render chunk; bounds the temporaries of the per-voxel
#: reduction so KITTI-360-scale grids fit in HBM.
RENDER_CHUNK_VOXELS = 1 << 20


@partial(jax.jit, static_argnums=(0, 2))
def render_occupancy(
    cfg: MapConfig,
    state: MapState,
    occupancy_threshold: float,
):
    """Returns (particles_after_gc, RenderResult)."""
    vox_axis_stamp = codecs.axis_stamps_per_voxel(cfg, state.scroll)
    return render_core_xla(
        cfg, state.particles, state.voxel_stamp, vox_axis_stamp,
        occupancy_threshold,
    )


def render_core_xla(
    cfg: MapConfig,
    p,
    voxel_stamp: jax.Array,
    vox_axis_stamp: jax.Array,
    occupancy_threshold: float,
):
    """Size-agnostic render body: works on the full grid or a voxel slab
    (sizes derive from the arrays; parallel/shard_step.py passes slabs)."""
    K = cfg.slots_per_voxel
    V = voxel_stamp.shape[0]

    chunk = min(V, RENDER_CHUNK_VOXELS)
    n_chunks = V // chunk

    if n_chunks == 1:
        occ, lab, trk, ws, nw, ns = _render_chunk(
            cfg, occupancy_threshold, p.weight, p.label, p.track,
            p.status, p.stamp, vox_axis_stamp, voxel_stamp,
        )
    else:
        rs = lambda a: a.reshape(n_chunks, -1)

        def body(args):
            return _render_chunk(cfg, occupancy_threshold, *args)

        occ, lab, trk, ws, nw, ns = jax.lax.map(
            body,
            (rs(p.weight), rs(p.label), rs(p.track), rs(p.status),
             rs(p.stamp), rs(vox_axis_stamp), rs(voxel_stamp)),
        )
        occ, lab, trk, ws = (a.reshape(-1) for a in (occ, lab, trk, ws))
        nw, ns = nw.reshape(-1), ns.reshape(-1)

    particles = p.replace(weight=nw, status=ns.astype(p.status.dtype))
    return particles, RenderResult(
        occ=occ, label=lab, track=trk, weight_sum=ws,
    )


@partial(jax.jit, static_argnums=(0, 2))
def render_occupancy_smoothed(
    cfg: MapConfig,
    state: MapState,
    occupancy_threshold: float,
):
    """calculateWeightAndSemanticsInVoxelConsiderNeighbors
    (operations.h:457-600): the 4-neighborhood denoise/inference variant of
    the reduction.  Dead code in the reference engine (no call site;
    semantic_dsp_map.h:1253 uses the plain variant) — provided here behind
    ``FilterParams.if_use_neighbor_smoothed_occupancy`` for parity.

    Reference quirks preserved:
      - neighborhood is taken in RING indices with NO torus wrap and
        asymmetric bounds (x-1 >= 1 and x+1 < Nx-1, :486-516), so the
        smoothing seam sits wherever the scroll currently wraps;
      - an occupied voxel with *no* valid neighbors counts as isolated and is
        suppressed to weight 0 (all_empty starts true, :563-575);
      - an empty voxel with >= 2 occupied neighbors is inferred occupied at
        weight (threshold + 0.1) (:577-588);
      - guessed particles contribute their RAW weight to the per-track
        semantics sums but not to the occupancy weight (:532-556);
      - the semantics argmax spans the voxel AND its neighbors.
    """
    p = particles_vk(cfg, state.particles)
    K = cfg.slots_per_voxel
    V = cfg.num_voxels
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    thr = occupancy_threshold

    vox_axis_stamp = codecs.axis_stamps_per_voxel(cfg, state.scroll)
    alive = codecs.particle_alive(p.status, p.stamp, vox_axis_stamp)
    vvalid = codecs.voxel_valid(state.voxel_stamp, vox_axis_stamp)

    w = p.weight
    w_clamped = jnp.minimum(w, 1.0)
    guessed = alive & (p.status == STATUS_GUESSED_BORN)
    gc = alive & (p.status == STATUS_UPDATED) & (w_clamped < PARTICLE_OCC_INIT_WEIGHT)
    contrib_mask = alive & ~gc

    # Per-voxel pieces of weight_sum_vec / guessed_weight (:524-546).
    wv = jnp.sum(jnp.where(contrib_mask & ~guessed, w_clamped, 0.0), axis=1)
    gw = jnp.sum(jnp.where(guessed, w, 0.0), axis=1)
    # Per-slot track-map contributions (guessed at raw weight, :549-556).
    wct = jnp.where(contrib_mask, jnp.where(guessed, w, w_clamped), 0.0)
    trk = jnp.where(contrib_mask, p.track, -1)
    lab = p.label

    g3 = lambda a: a.reshape(nz, ny, nx)
    xi = jax.lax.broadcasted_iota(jnp.int32, (nz, ny, nx), 2)
    yi = jax.lax.broadcasted_iota(jnp.int32, (nz, ny, nx), 1)
    vv3 = g3(vvalid)

    # Neighbor presence masks at each CENTER voxel (ring space, no wrap).
    def shifted(a3, dx, dy):
        return jnp.roll(jnp.roll(a3, dx, axis=2), dy, axis=1)

    offsets = [
        (0, 0, jnp.ones((nz, ny, nx), bool)),                       # self
        (1, 0, (xi >= 2) & shifted(vv3, 1, 0)),                      # x-1
        (-1, 0, (xi < nx - 2) & shifted(vv3, -1, 0)),                # x+1
        (0, 1, (yi >= 2) & shifted(vv3, 0, 1)),                      # y-1
        (0, -1, (yi < ny - 2) & shifted(vv3, 0, -1)),                # y+1
    ]

    # Smoothing decision (:563-588).
    wv3 = g3(wv)
    nb_big = []
    nb_present_any_big = jnp.zeros((nz, ny, nx), bool)
    big_count = jnp.zeros((nz, ny, nx), jnp.int32)
    for dx, dy, present in offsets[1:]:
        nbw = shifted(wv3, dx, dy)
        is_big = present & (nbw > thr)
        nb_present_any_big = nb_present_any_big | is_big
        big_count = big_count + is_big.astype(jnp.int32)
    ws_sm = jnp.where(
        wv3 > thr,
        jnp.where(nb_present_any_big, wv3, 0.0),
        jnp.where(big_count >= 2, thr + jnp.float32(0.1), wv3),
    ).reshape(-1)

    gw3 = g3(gw)
    gw_total = gw3
    for dx, dy, present in offsets[1:]:
        gw_total = gw_total + jnp.where(present, shifted(gw3, dx, dy), 0.0)
    gw_total = gw_total.reshape(-1)

    # Neighborhood-wide per-track argmax.  Candidates = every (offset, slot);
    # quadratic in (5K)^2 fused passes — acceptable for the flag-gated path.
    cand_trk, cand_wct, cand_lab = [], [], []
    for dx, dy, present in offsets:
        pr = present.reshape(-1)
        for j in range(K):
            t3 = shifted(g3(trk[:, j]), dx, dy).reshape(-1)
            w3_ = shifted(g3(wct[:, j]), dx, dy).reshape(-1)
            l3 = shifted(g3(lab[:, j]), dx, dy).reshape(-1)
            cand_trk.append(jnp.where(pr, t3, -1))
            cand_wct.append(jnp.where(pr, w3_, 0.0))
            cand_lab.append(l3)

    n_cand = len(cand_trk)
    big = jnp.int32(1 << 30)
    best_w = jnp.zeros(V, jnp.float32)
    best_track = jnp.full(V, big, jnp.int32)
    found = jnp.zeros(V, bool)
    for i in range(n_cand):
        ti = cand_trk[i]
        okc = ti >= 0
        tot = jnp.zeros(V, jnp.float32)
        for k in range(n_cand):
            tot = tot + jnp.where(cand_trk[k] == ti, cand_wct[k], 0.0)
        better = okc & (tot > 0.0) & (
            ~found | (tot > best_w) | ((tot == best_w) & (ti < best_track))
        )
        best_w = jnp.where(better, tot, best_w)
        best_track = jnp.where(better, ti, best_track)
        found = found | (okc & (tot > 0.0))

    best_label = jnp.zeros(V, jnp.int32)
    for i in range(n_cand):  # last writer in visit order (:556)
        match = (cand_trk[i] >= 0) & (cand_trk[i] == best_track)
        best_label = jnp.where(match, cand_lab[i], best_label)
    best_track = jnp.where(found, best_track, 0)
    best_label = jnp.where(found, best_label, 0)

    weight_sum = jnp.where(vvalid, ws_sm, -1.0)
    gw_total = jnp.where(vvalid, gw_total, 0.0)
    best_track = jnp.where(vvalid, best_track, 0)
    best_label = jnp.where(vvalid, best_label, 0)

    occ = jnp.where(
        weight_sum > thr,
        1,
        jnp.where(
            weight_sum < 0,
            -1,
            jnp.where(gw_total >= PARTICLE_OCC_INIT_WEIGHT, 2, 0),
        ),
    ).astype(jnp.int32)

    # Same storage side effects as the plain reduction (:533-543).
    touched = alive & vvalid[:, None]
    new_weight = jnp.where(touched, w_clamped, w)
    new_status = jnp.where(gc & vvalid[:, None], STATUS_INVALID, p.status)
    particles = state.particles.replace(
        weight=new_weight.reshape(-1), status=new_status.reshape(-1)
    )

    return particles, RenderResult(
        occ=occ,
        label=best_label,
        track=best_track,
        weight_sum=weight_sum,
    )
