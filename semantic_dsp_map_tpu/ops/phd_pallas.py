"""Pallas kernels (Triton route) for the PHD stencil passes (hot loop #3).

The XLA stencils in ops/phd.py run one loop iteration per neighbourhood
offset, and each iteration streams the whole [S, H, W] particle table (pass A)
or carry (pass B) through device memory: (2R+1)^2 = 49 (ZED2) or 121
(VKITTI2) full passes per frame, over a table larger than the L2 cache.
These kernels give each program one power-of-two output tile and run the
offset loop inside it: the shifted windows of neighbouring offsets overlap,
so after the first offset they are served from L1/L2 and device memory sees
each input about once.

Layout: inputs are halo-padded by R on each side (plus whatever a liveness
window needs past the last tile) and held in ``pl.ANY`` memory; the kernel
reads each shifted [TH, TW] window with :func:`triton.load`.

  - Pass A (per-pixel normalizer ck) loops over the S slot planes inside the
    program, because ck sums over them.  A slot plane is skipped when its
    effective weight is zero over the tile's halo-included window: every
    skipped contribution is ``w_eff * gk`` with ``w_eff == 0``, so the skip
    is lossless.
  - Pass B (per-entry accumulation) puts the slot plane in the grid: one
    program per (slot, tile).  A program whose tile holds no occupied slot
    (track sentinel -2) writes zeros.  Occupancy, not the forgetting factor,
    is the test: a fully forgotten particle (ff == 0) adds nothing to ``acc``
    but must still compute ``right`` so that a new same-track observation
    can revive it (semantic_dsp_map.h:1091-1096).

The table is front-filled and sparsely occupied at map scale, so most slot
planes of most tiles are empty and the skip removes most of the work.

Inner-loop arithmetic (the offset loops are the frame's arithmetic budget):

  - the per-axis 9.9-sigma clip of the XLA oracle is dropped: whenever any
    |z| > 9.9 the fused exp(-0.5 * s2) <= e^-49, far below the additive
    clutter term kappa, and it cannot flip pass B's "rightly updated" test,
    whose threshold is 0.1;
  - COEF^3 and (pass B) the forgetting factor are folded into per-entry
    planes outside the offset loop;
  - pass B multiplies by a per-pixel reciprocal of ck_kappa, which also
    carries the observation-valid mask (0 at invalid pixels), and invalid
    pixels carry track -1, which equals neither a real track nor the empty
    sentinel, so no separate validity plane is loaded.

Pass B's "rightly updated" comparison keeps the oracle's expression
(COEF^3 * exp(...) > 0.1) so the forget output rounds identically and is
asserted bit-equal.  ck and the weights differ from the oracle only in f32
summation order (tests/test_phd_pallas.py: rtol 2e-5).

Semantics are those of ops/phd.py (semantic_dsp_map.h:960-1121).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import (
    FORGET_COUNT_INCREMENT_CAP,
    FilterParams,
    GAUSSIAN_PDF_COEF,
    MIN_RIGHTLY_UPDATED_PDF,
    MapConfig,
)
from .geometry import forgetting_factor

_COEF3 = GAUSSIAN_PDF_COEF ** 3

#: Output tile (rows, columns; powers of two, as the Triton route requires),
#: warps and pipeline stages per program, per pass.  Chosen by a sweep on an
#: H100 at the VKITTI2 and ZED2 shapes (PERF.md): the best sum of the two
#: shapes' times among 8 tiles x {2, 4, 8} warps x {1, 2} stages.
TILE_A, WARPS_A, STAGES_A = (8, 32), 8, 2
TILE_B, WARPS_B, STAGES_B = (8, 64), 2, 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _check_tile(th: int, tw: int):
    for v in (th, tw):
        if v <= 0 or v & (v - 1):
            raise ValueError(f"PHD kernel tile {th}x{tw}: sides must be powers of two")


def _halo_pad(a, R: int, rows: int, cols: int, fill):
    """Pad the trailing (H, W) dims by R in front and up to (rows, cols)."""
    H, W = a.shape[-2:]
    cfg = [(0, 0)] * (a.ndim - 2) + [(R, rows - H - R), (R, cols - W - R)]
    return jnp.pad(a, cfg, constant_values=fill)


def _tile_pad(a, rows: int, cols: int, fill):
    H, W = a.shape[-2:]
    cfg = [(0, 0)] * (a.ndim - 2) + [(0, rows - H), (0, cols - W)]
    return jnp.pad(a, cfg, constant_values=fill)


# ---------------------------------------------------------------------------
# Pass A: per-pixel normalizer ck
# ---------------------------------------------------------------------------


def _pass_a_kernel(
    tab_ref,      # ANY [5, S, Hp, Wp]: px, py, pz, w_eff * COEF^3, track
    obs_ref,      # ANY [5, HT, WT]: ox, oy, oz, inv_sigma, track
    ck_ref,       # out [TH, TW]
    *, S: int, R: int, th: int, tw: int, lh: int, lw: int,
    id_p: float, independent: bool,
):
    r0 = pl.program_id(0) * th
    c0 = pl.program_id(1) * tw
    side = 2 * R + 1
    tile = lambda p: pltriton.load(obs_ref.at[p, pl.ds(r0, th), pl.ds(c0, tw)])
    ox, oy, oz, inv_sig, otrk = (tile(p) for p in range(5))

    def slot(s, ck):
        live = jnp.max(
            pltriton.load(tab_ref.at[3, s, pl.ds(r0, lh), pl.ds(c0, lw)])
        ) > 0.0

        def offsets(ck):
            def offset(o, ck):
                dm = o // side
                dn = o - dm * side
                win = lambda p: pltriton.load(
                    tab_ref.at[p, s, pl.ds(r0 + dm, th), pl.ds(c0 + dn, tw)]
                )
                zx = (win(0) - ox) * inv_sig
                zy = (win(1) - oy) * inv_sig
                zz = (win(2) - oz) * inv_sig
                gk = jnp.exp(-0.5 * (zx * zx + zy * zy + zz * zz))
                wtrk = win(4)
                weff = win(3)
                if independent:
                    return ck + jnp.where(wtrk == otrk, weff * gk, 0.0)
                return ck + weff * jnp.where(wtrk != otrk, gk * id_p, gk)

            return jax.lax.fori_loop(0, side * side, offset, ck)

        return jax.lax.cond(live, offsets, lambda ck: ck, ck)

    ck_ref[...] = jax.lax.fori_loop(
        0, S, slot, jnp.zeros((th, tw), jnp.float32)
    )


def pass_a(
    cfg: MapConfig, params: FilterParams, t, cloud,
    *, interpret: bool = False, tile=TILE_A, num_warps: int = WARPS_A,
    num_stages: int = STAGES_A,
):
    """Pass A on the kernel: ck_kappa f32[H, W], as ops/phd.stencil_pass_a.
    H/W derive from the table (may be an image-row slab with halo)."""
    th, tw = tile
    _check_tile(th, tw)
    S, H, W = t.px.shape
    R = cfg.neighbor_half
    HT, WT = _cdiv(H, th) * th, _cdiv(W, tw) * tw
    # The liveness window covers the tile and its halo.
    lh, lw = _pow2_at_least(th + 2 * R), _pow2_at_least(tw + 2 * R)

    occupied = t.meta >= 0
    if params.if_use_independent_filter:
        weff = jnp.where(occupied, t.weight, 0.0)
    else:
        ff = forgetting_factor(
            t.meta & 0xFF, params.forgetting_rate, params.max_forget_count
        )
        weff = jnp.where(occupied, t.weight * ff, 0.0)
    # All-zero padding: the zero weight plane kills every halo contribution
    # whatever the other planes hold there.
    tab = _halo_pad(
        jnp.stack([
            t.px, t.py, t.pz, weff * _COEF3,
            (t.meta >> 8).astype(jnp.float32),
        ]),
        R, HT - th + lh, WT - tw + lw, 0.0,
    )
    obs = _tile_pad(
        jnp.stack([
            cloud.pos[..., 0], cloud.pos[..., 1], cloud.pos[..., 2],
            1.0 / jnp.maximum(cloud.sigma, 1e-6),
            cloud.track.astype(jnp.float32),
        ]),
        HT, WT, 0.0,
    )
    kernel = functools.partial(
        _pass_a_kernel, S=S, R=R, th=th, tw=tw, lh=lh, lw=lw,
        id_p=float(params.id_transition_probability),
        independent=bool(params.if_use_independent_filter),
    )
    ck = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((HT, WT), jnp.float32),
        grid=(HT // th, WT // tw),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_specs=pl.BlockSpec((th, tw), lambda i, j: (i, j)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="phd_pass_a",
    )(tab, obs)[:H, :W]
    ck = jnp.where(cloud.valid, ck, 0.0)
    return ck * params.detection_probability + params.noise_number


# ---------------------------------------------------------------------------
# Pass B: per-table-entry accumulation
# ---------------------------------------------------------------------------


def _pass_b_kernel(
    obs_ref,      # ANY [5, Hp, Wp]: ox, oy, oz, track (-1 invalid), 1/ck_kappa
    px_ref, py_ref, pz_ref, trk_ref, ffc_ref,  # [TH, TW] of one slot plane
    sig_ref,      # [TH, TW]: inv sigma at the particle's own pixel
    acc_ref, right_ref,                        # out [TH, TW] of one slot plane
    *, R: int, th: int, tw: int, id_p: float, independent: bool,
):
    r0 = pl.program_id(1) * th
    c0 = pl.program_id(2) * tw
    side = 2 * R + 1
    ptrk = trk_ref[...]
    zero = jnp.zeros((th, tw), jnp.float32)

    def offsets():
        ppx, ppy, ppz = px_ref[...], py_ref[...], pz_ref[...]
        inv_sig = sig_ref[...]

        def offset(o, carry):
            acc, rmax = carry
            dm = o // side
            dn = o - dm * side
            win = lambda p: pltriton.load(
                obs_ref.at[p, pl.ds(r0 + dm, th), pl.ds(c0 + dn, tw)]
            )
            zx = (ppx - win(0)) * inv_sig
            zy = (ppy - win(1)) * inv_sig
            zz = (ppz - win(2)) * inv_sig
            e = jnp.exp(-0.5 * (zx * zx + zy * zy + zz * zz))
            same = ptrk == win(3)
            ick = win(4)
            if independent:
                return acc + jnp.where(same, e, 0.0) * ick, rmax
            rmax = jnp.maximum(rmax, jnp.where(same, _COEF3 * e, 0.0))
            return acc + jnp.where(same, e, e * id_p) * ick, rmax

        acc, rmax = jax.lax.fori_loop(0, side * side, offset, (zero, zero))
        return acc * ffc_ref[...], rmax

    acc, rmax = jax.lax.cond(
        jnp.max(ptrk) > -1.5, offsets, lambda: (zero, zero)
    )
    acc_ref[...] = acc
    right_ref[...] = jnp.where(rmax > MIN_RIGHTLY_UPDATED_PDF, 1.0, 0.0)


def pass_b(
    cfg: MapConfig, params: FilterParams, t, cloud, ck_kappa,
    *, interpret: bool = False, tile=TILE_B, num_warps: int = WARPS_B,
    num_stages: int = STAGES_B,
):
    """Pass B on the kernel: (new_weight, new_forget) [S, H, W], as
    ops/phd.stencil_pass_b.  H/W derive from the table."""
    th, tw = tile
    _check_tile(th, tw)
    S, H, W = t.px.shape
    R = cfg.neighbor_half
    HT, WT = _cdiv(H, th) * th, _cdiv(W, tw) * tw
    independent = params.if_use_independent_filter

    occupied = t.meta >= 0
    track_t = t.meta >> 8
    forget_t = t.meta & 0xFF
    if independent:
        ff_eff = occupied.astype(jnp.float32)
    else:
        ff = forgetting_factor(forget_t, params.forgetting_rate, params.max_forget_count)
        ff_eff = jnp.where(occupied, ff, 0.0)

    # Padding beyond the image reads as an invalid pixel: track -1, zero
    # reciprocal, zero position.
    valid = cloud.valid
    planes = [
        (cloud.pos[..., 0], 0.0), (cloud.pos[..., 1], 0.0),
        (cloud.pos[..., 2], 0.0),
        (jnp.where(valid, cloud.track, -1).astype(jnp.float32), -1.0),
        (jnp.where(valid, 1.0 / ck_kappa, 0.0), 0.0),
    ]
    obs = jnp.stack([
        _halo_pad(a, R, HT + 2 * R, WT + 2 * R, fill) for a, fill in planes
    ])
    # Tile padding of the table: the track plane pads with the empty
    # sentinel so padding reads as dead.
    tabs = [
        _tile_pad(t.px, HT, WT, 0.0),
        _tile_pad(t.py, HT, WT, 0.0),
        _tile_pad(t.pz, HT, WT, 0.0),
        _tile_pad(jnp.where(occupied, track_t, -2).astype(jnp.float32), HT, WT, -2.0),
        _tile_pad(ff_eff * _COEF3, HT, WT, 0.0),
    ]
    sig = _tile_pad(1.0 / jnp.maximum(cloud.sigma, 1e-6), HT, WT, 1.0)

    slab = pl.BlockSpec((None, th, tw), lambda s, i, j: (s, i, j))
    kernel = functools.partial(
        _pass_b_kernel, R=R, th=th, tw=tw,
        id_p=float(params.id_transition_probability),
        independent=bool(independent),
    )
    acc, right = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((S, HT, WT), jnp.float32),) * 2,
        grid=(S, HT // th, WT // tw),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] + [slab] * 5
        + [pl.BlockSpec((th, tw), lambda s, i, j: (i, j))],
        out_specs=(slab, slab),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="phd_pass_b",
    )(obs, *tabs, sig)
    acc, right = acc[:, :H, :W], right[:, :H, :W]

    new_weight = t.weight * (
        acc * params.detection_probability + 1.0 - params.detection_probability
    )
    new_weight = jnp.where(occupied, new_weight, t.weight)
    if independent:
        return new_weight, forget_t
    new_forget = jnp.where(
        right > 0.0,
        0,
        jnp.where(forget_t < FORGET_COUNT_INCREMENT_CAP, forget_t + 1, forget_t),
    )
    return new_weight, new_forget
