"""SMC-PHD particle weight update (hot loop #3 of the reference).

Reimplements SemanticDSPMap::updateParticles (semantic_dsp_map.h:960-1121).

Accelerator formulation: the reference's per-pixel "pyramid" particle lists
(buffer.h:89-93) become a dense per-pixel particle table ``[H, W, S]``
(S = slots per pixel) holding the *visible* particles, built once per frame
from a pixel-sorted compact entry array (see ops/observe.py for how entries
are produced without any full-state compaction).  Both PHD passes are then
pure dense stencils: for each of the (2R+1)^2 static neighborhood offsets, a
shifted window of the padded table (pass A) or of the padded observation
grids (pass B) is combined elementwise and reduced.  No gathers or scatters
execute inside the loops.

  Pass A (normalizer): ck[q] = sum over particles p within +-R pixels of q of
      w_p * N^3(pos_p; obs_q, sigma_q) * [forgetting, id-transition]
  giving ck_kappa = ck * P_d + kappa          (semantic_dsp_map.h:973-1037).

  Pass B (update): each particle accumulates gk / ck_kappa over the same
  neighborhood of *valid* observation pixels; weight *= (acc * P_d + 1 - P_d);
  the forgetting counter resets iff some same-track observation matched with
  pdf > 0.1 (semantic_dsp_map.h:1041-1119).

Reference quirks preserved:
  - pass A evaluates the Gaussian with the *observation* pixel's sigma while
    pass B uses the sigma at the *particle's own* pixel
    (semantic_dsp_map.h:985 vs :1047);
  - the per-axis pdf uses the 1/sqrt(pi) constant (ops.geometry.gaussian_pdf1);
  - "rightly updated" is tested on the raw pdf before the id-transition and
    forgetting factors are applied (semantic_dsp_map.h:1091-1096);
  - forget-count increments saturate at the literal 5
    (semantic_dsp_map.h:1111) independently of max_forget_count;
  - with the independent-filter flag, particles only interact with
    observations of their own track id and skip the forgetting/transition
    terms entirely (semantic_dsp_map.h:1009-1027, 1076-1097).

Documented deviations (all bounded below the filter's stochastic tolerance):
  - the per-pixel table holds at most ``cfg.phd_pixel_table_slots`` particles
    (the reference's lists are unbounded); closest-to-camera particles win a
    slot; overflow leaves a particle un-updated for one frame (equivalent to
    one frame of occlusion) and is counted in the diagnostics;
  - the 3-axis Gaussian is evaluated as one fused exp of the squared radius;
    when any axis exceeds the reference LUT's 9.9-sigma clamp the product is
    0 instead of the reference's 1e-9-floored product (both below 3.2e-10,
    i.e. orders of magnitude under the additive clutter term kappa and the
    reference LUT's own 1e-3 z-quantization).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import (
    FORGET_COUNT_INCREMENT_CAP,
    FilterParams,
    GAUSSIAN_PDF_COEF,
    GAUSSIAN_PDF_Z_CLIP,
    MIN_RIGHTLY_UPDATED_PDF,
    MapConfig,
)
from ..state import Particles, STATUS_UPDATED
from .blocks import group_rank
from .geometry import forgetting_factor
from .projection import LabeledCloud, VisibleSet

_COEF3 = GAUSSIAN_PDF_COEF ** 3


class PixelTable(NamedTuple):
    """Dense per-pixel particle table, all [S, H, W].

    The slot dimension leads so the image dims are minor-most: each slot
    plane is a contiguous image, and a shifted window of it is a strided
    2-D tile.
    ``meta`` packs (track << 8) | forget; -1 marks an empty slot.
    """

    px: jax.Array      # f32 particle position x
    py: jax.Array      # f32
    pz: jax.Array      # f32
    weight: jax.Array  # f32 raw particle weight
    meta: jax.Array    # i32 (track << 8) | forget; -1 empty
    dropped: jax.Array # i32 scalar: entries that overflowed their pixel


def gauss3(dx, dy, dz, inv_sigma):
    """Fused 3-axis reference 'pdf': COEF^3 * exp(-(zx^2+zy^2+zz^2)/2), zero
    when any axis passes the LUT clamp (see module docstring)."""
    zx = dx * inv_sigma
    zy = dy * inv_sigma
    zz = dz * inv_sigma
    s = zx * zx + zy * zy + zz * zz
    amax = jnp.maximum(jnp.maximum(jnp.abs(zx), jnp.abs(zy)), jnp.abs(zz))
    val = _COEF3 * jnp.exp(-0.5 * s)
    return jnp.where(amax > GAUSSIAN_PDF_Z_CLIP, 0.0, val)


def table_from_entries(
    cfg: MapConfig,
    pix: jax.Array,     # i32[C] pixel id (row*W+col); >= H*W = padding
    rank: jax.Array,    # i32[C] rank within pixel (0 = front)
    keep: jax.Array,    # bool[C] goes into the table
    px, py, pz, weight, track, forget,
    n_rows: int = 0,
) -> PixelTable:
    """Scatter compact entries into the dense table.  (pix, rank) pairs are
    unique among kept entries, so the scatters vectorize.

    ``n_rows`` overrides the table row count (a sharded image-row slab with
    halo, parallel/shard_step.py); ``pix`` is then slab-local."""
    H, W, S = cfg.height, cfg.width, cfg.phd_pixel_table_slots
    if n_rows:
        H = n_rows
    n = H * W * S
    iota_c = jax.lax.broadcasted_iota(jnp.int32, (pix.shape[0], 1), 0).squeeze(-1)
    # Unique out-of-range pads: duplicate dropped indices under
    # unique_indices=True are undefined behaviour.
    dest = jnp.where(keep, jnp.minimum(rank, S - 1) * (H * W) + pix, n + iota_c)

    def scat(fill, vals, dtype):
        base = jnp.full((n,), fill, dtype)
        return base.at[dest].set(
            vals.astype(dtype), mode="drop", unique_indices=True
        ).reshape(S, H, W)

    real = pix < H * W
    dropped = jnp.sum((real & ~keep).astype(jnp.int32))
    meta = (track.astype(jnp.int32) << 8) | (forget.astype(jnp.int32) & 0xFF)
    return PixelTable(
        px=scat(0.0, px, jnp.float32),
        py=scat(0.0, py, jnp.float32),
        pz=scat(0.0, pz, jnp.float32),
        weight=scat(0.0, weight, jnp.float32),
        meta=scat(-1, meta, jnp.int32),
        dropped=dropped,
    )


def _pad_hw(a, r, fill):
    """Halo pad on the two leading (H, W) dims."""
    cfgpad = [(r, r)] * 2 + [(0, 0)] * (a.ndim - 2)
    return jnp.pad(a, cfgpad, constant_values=fill)


def _pad_shw(a, r, fill):
    """Halo pad on the trailing (H, W) dims of an [S, H, W] array."""
    return jnp.pad(a, [(0, 0), (r, r), (r, r)], constant_values=fill)


def stencil_pass_a(
    cfg: MapConfig, params: FilterParams, t: PixelTable, cloud: LabeledCloud
) -> jax.Array:
    """Pass A: the per-pixel PHD normalizer ck*P_d + kappa, f32[H, W].

    H/W derive from the table (may be an image-row slab with halo)."""
    _, H, W = t.px.shape
    R = cfg.neighbor_half
    side = 2 * R + 1
    independent = params.if_use_independent_filter

    track_t = t.meta >> 8
    if independent:
        weff = jnp.where(t.meta >= 0, t.weight, 0.0)
    else:
        ff = forgetting_factor(
            t.meta & 0xFF, params.forgetting_rate, params.max_forget_count
        )
        weff = jnp.where(t.meta >= 0, t.weight * ff, 0.0)

    pad_px = _pad_shw(t.px, R, 0.0)
    pad_py = _pad_shw(t.py, R, 0.0)
    pad_pz = _pad_shw(t.pz, R, 0.0)
    pad_w = _pad_shw(weff, R, 0.0)
    pad_trk = _pad_shw(track_t, R, -1)

    obs_x = cloud.pos[..., 0][None]
    obs_y = cloud.pos[..., 1][None]
    obs_z = cloud.pos[..., 2][None]
    inv_sigma = (1.0 / jnp.maximum(cloud.sigma, 1e-6))[None]
    obs_valid = cloud.valid
    obs_trk = cloud.track[None]
    S = t.px.shape[0]

    def body_a(off, ck):
        dm, dn = off // side, off % side
        win = lambda a: jax.lax.dynamic_slice(a, (0, dm, dn), (S, H, W))
        gk = gauss3(
            win(pad_px) - obs_x,
            win(pad_py) - obs_y,
            win(pad_pz) - obs_z,
            inv_sigma,
        )
        w = win(pad_w)
        if not independent:
            gk = jnp.where(
                win(pad_trk) != obs_trk, gk * params.id_transition_probability, gk
            )
            contrib = w * gk
        else:
            contrib = jnp.where(win(pad_trk) == obs_trk, w * gk, 0.0)
        return ck + jnp.sum(contrib, axis=0)

    ck = jax.lax.fori_loop(0, side * side, body_a, jnp.zeros((H, W), jnp.float32))
    ck = jnp.where(obs_valid, ck, 0.0)
    return ck * params.detection_probability + params.noise_number


def stencil_pass_b(
    cfg: MapConfig,
    params: FilterParams,
    t: PixelTable,
    cloud: LabeledCloud,
    ck_kappa: jax.Array,
):
    """Pass B: per-table-entry (new_weight, new_forget) as [H, W, S] arrays.

    Entries not in the table keep their weight by construction
    (new_weight == weight where meta < 0).  H/W derive from the table."""
    S, H, W = t.px.shape
    R = cfg.neighbor_half
    side = 2 * R + 1
    independent = params.if_use_independent_filter

    occupied = t.meta >= 0
    track_t = t.meta >> 8
    forget_t = t.meta & 0xFF
    if not independent:
        ff = forgetting_factor(forget_t, params.forgetting_rate, params.max_forget_count)

    pad_ox = _pad_hw(cloud.pos[..., 0], R, 0.0)
    pad_oy = _pad_hw(cloud.pos[..., 1], R, 0.0)
    pad_oz = _pad_hw(cloud.pos[..., 2], R, 0.0)
    pad_ov = _pad_hw(cloud.valid, R, False)
    pad_otrk = _pad_hw(cloud.track, R, -1)
    pad_ck = _pad_hw(ck_kappa, R, 1.0)

    inv_sigma_p = (1.0 / jnp.maximum(cloud.sigma, 1e-6))[None]

    def body_b(off, carry):
        acc, right = carry
        dm, dn = off // side, off % side
        win = lambda a: jax.lax.dynamic_slice(a, (dm, dn), (H, W))[None]
        gk_raw = gauss3(
            t.px - win(pad_ox),
            t.py - win(pad_oy),
            t.pz - win(pad_oz),
            inv_sigma_p,
        )
        ov = win(pad_ov)
        otrk = win(pad_otrk)
        ckk = win(pad_ck)
        mask = occupied & ov
        if independent:
            gk = jnp.where(mask & (otrk == track_t), gk_raw, 0.0)
        else:
            same = otrk == track_t
            right = right | (mask & same & (gk_raw > MIN_RIGHTLY_UPDATED_PDF))
            gk = jnp.where(same, gk_raw, gk_raw * params.id_transition_probability)
            gk = jnp.where(mask, gk * ff, 0.0)
        return acc + gk / ckk, right

    S = t.px.shape[0]
    acc, right = jax.lax.fori_loop(
        0, side * side, body_b,
        (jnp.zeros((S, H, W), jnp.float32), jnp.zeros((S, H, W), bool)),
    )

    new_weight = t.weight * (
        acc * params.detection_probability + 1.0 - params.detection_probability
    )
    if independent:
        new_forget = forget_t
    else:
        new_forget = jnp.where(
            right,
            0,
            jnp.where(forget_t < FORGET_COUNT_INCREMENT_CAP, forget_t + 1, forget_t),
        )
    new_weight = jnp.where(occupied, new_weight, t.weight)
    return new_weight, new_forget


# ---------------------------------------------------------------------------
# Backend dispatch: Pallas kernels on the GPU, XLA stencils elsewhere
# ---------------------------------------------------------------------------


def _use_pallas_phd() -> bool:
    return jax.default_backend() == "gpu"


def stencil_pass_a_any(
    cfg: MapConfig, params: FilterParams, t: PixelTable, cloud: LabeledCloud
) -> jax.Array:
    """Pass A with backend dispatch: ck_kappa f32[H, W].  Split from
    :func:`stencil_passes` so the sharded path can exchange the ck halo rows
    between the passes (parallel/shard_step.py)."""
    if _use_pallas_phd():
        from .phd_pallas import pass_a

        return pass_a(cfg, params, t, cloud)
    return stencil_pass_a(cfg, params, t, cloud)


def stencil_pass_b_any(
    cfg: MapConfig,
    params: FilterParams,
    t: PixelTable,
    cloud: LabeledCloud,
    ck_kappa: jax.Array,
):
    """Pass B with backend dispatch: (new_weight, new_forget) [S, H, W]."""
    if _use_pallas_phd():
        from .phd_pallas import pass_b

        return pass_b(cfg, params, t, cloud, ck_kappa)
    return stencil_pass_b(cfg, params, t, cloud, ck_kappa)


def stencil_passes(
    cfg: MapConfig,
    params: FilterParams,
    t: PixelTable,
    cloud: LabeledCloud,
):
    """Both PHD passes: returns (ck_kappa f32[H,W], new_weight, new_forget
    [S,H,W]).  Numerically equivalent between backends (tests/test_phd_pallas)."""
    ck_kappa = stencil_pass_a_any(cfg, params, t, cloud)
    new_w, new_f = stencil_pass_b_any(cfg, params, t, cloud, ck_kappa)
    return ck_kappa, new_w, new_f


# ---------------------------------------------------------------------------
# VisibleSet-based wrappers (the unit-test / oracle surface; the production
# frame path builds its entries in ops/observe.py instead)
# ---------------------------------------------------------------------------


def _rank_in_pixel(key, weight, P):
    """Rank among same-pixel entries, higher weight first (legacy ranking for
    the VisibleSet path; production ranks by camera depth in observe.py)."""
    order = jnp.lexsort((-weight, key))
    sk = key[order]
    rank_sorted = group_rank(sk)
    return jnp.zeros(P, jnp.int32).at[order].set(rank_sorted)


def build_pixel_table(cfg: MapConfig, vis: VisibleSet) -> PixelTable:
    """Scatter a VisibleSet into the dense table (tests/diagnostics)."""
    H, W, S = cfg.height, cfg.width, cfg.phd_pixel_table_slots
    P = vis.vox.shape[0]
    real = (vis.vox >= 0) & vis.visible
    key = jnp.where(real, vis.row * W + vis.col, H * W)
    rank = _rank_in_pixel(key, vis.weight, P)
    keep = real & (rank < S)
    return table_from_entries(
        cfg, key, rank, keep,
        vis.pos[:, 0], vis.pos[:, 1], vis.pos[:, 2],
        vis.weight, vis.track, vis.forget,
    )


@partial(jax.jit, static_argnums=(0, 1))
def compute_ck_kappa(
    cfg: MapConfig, params: FilterParams, vis: VisibleSet, cloud: LabeledCloud
) -> jax.Array:
    """Standalone pass A (for tests/diagnostics)."""
    return stencil_pass_a(cfg, params, build_pixel_table(cfg, vis), cloud)


@partial(jax.jit, static_argnums=(0, 1))
def phd_weight_update(
    cfg: MapConfig,
    params: FilterParams,
    vis: VisibleSet,
    cloud: LabeledCloud,
    particles: Particles,
    global_time,
):
    """Both PHD passes + write-back by (voxel, slot) scatter.

    Test/diagnostic surface over the VisibleSet container; the production
    frame path fuses this into ops/observe.py's block write-back instead.
    """
    t = build_pixel_table(cfg, vis)
    ck_kappa = stencil_pass_a(cfg, params, t, cloud)
    new_weight, new_forget = stencil_pass_b(cfg, params, t, cloud, ck_kappa)

    occupied = t.meta >= 0
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    N = V * K
    # Recover each table entry's (voxel, slot): rebuild the same destinations.
    H, W, S = cfg.height, cfg.width, cfg.phd_pixel_table_slots
    P = vis.vox.shape[0]
    real = (vis.vox >= 0) & vis.visible
    key = jnp.where(real, vis.row * W + vis.col, H * W)
    rank = _rank_in_pixel(key, vis.weight, P)
    keep = real & (rank < S)
    iota_p = jax.lax.broadcasted_iota(jnp.int32, (P, 1), 0).squeeze(-1)
    dest = jnp.where(
        keep, jnp.minimum(rank, S - 1) * (H * W) + key, H * W * S + iota_p
    )
    vox_t = jnp.full((H * W * S,), -1, jnp.int32).at[dest].set(
        vis.vox, mode="drop", unique_indices=True
    ).reshape(S, H, W)
    slot_t = jnp.zeros((H * W * S,), jnp.int32).at[dest].set(
        vis.slot, mode="drop", unique_indices=True
    ).reshape(S, H, W)

    iota_t = jax.lax.broadcasted_iota(
        jnp.int32, (H * W * S, 1), 0
    ).squeeze(-1).reshape(S, H, W)
    # Flat slot indices into the [V*K] storage; unique OOR pads drop.
    fi = jnp.where(
        occupied & (vox_t >= 0), vox_t * K + slot_t, N + iota_t
    ).reshape(-1)
    nw = new_weight.reshape(-1)
    nf = new_forget.reshape(-1)

    return particles.replace(
        weight=particles.weight.at[fi].set(nw, mode="drop", unique_indices=True),
        status=particles.status.at[fi].set(
            jnp.asarray(STATUS_UPDATED, particles.status.dtype),
            mode="drop", unique_indices=True,
        ),
        stamp=particles.stamp.at[fi].set(
            global_time, mode="drop", unique_indices=True
        ),
        forget=particles.forget.at[fi].set(
            nf.astype(particles.forget.dtype), mode="drop", unique_indices=True
        ),
    )
