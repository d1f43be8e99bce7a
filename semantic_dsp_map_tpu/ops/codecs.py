"""Index codecs and ego-centric ring-buffer scroll.

Array reformulation of the reference's ring-buffer index machinery
(include/mc_ring/operations.h).  The grid is a fixed torus; the ego recenter
is pure index arithmetic — per-axis offsets plus lazy invalidation stamps —
and never moves particle data (operations.h:68-96, 1111-1191).

Index spaces (operations.h:864-1033):
  - *map index*  (mx,my,mz): position quantized relative to the current map
    center; range [0, N) per axis.
  - *ring index* (xi,yi,zi): map index shifted by the accumulated scroll
    offset, modulo the axis length.  This is the index into storage.
  - *voxel index* v: flat row-major storage index
    ``(((zi << Ny_n) | yi) << Nx_n) | xi`` (operations.h:900, STORAGE_TYPE 0).

Quirks preserved on purpose:
  - float->int conversions truncate toward zero, matching C ``static_cast<int>``
    (operations.h:1115-1117, 867-869);
  - voxel positions refer to the voxel *corner* ``idx*size + p_min``, not the
    center (operations.h:969-983) — the reference's "imaginary particle in the
    central of the voxel" (operations.h:1419-1423) actually uses this corner;
  - C-style truncated modulo for the equivalent scroll steps
    (operations.h:1196-1230).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import MapConfig
from ..state import ScrollState

# Plain int, not jnp.int32: a module-level device constant would initialize
# the JAX backend at package import, before callers can force a platform.
INVALID_VOXEL = -1


# ---------------------------------------------------------------------------
# Flat voxel index <-> per-axis ring indices (row-major, STORAGE_TYPE 0)
# ---------------------------------------------------------------------------

def ring_to_voxel(cfg: MapConfig, xi, yi, zi):
    """operations.h:899-901: v = (((z << Ny_n) | y) << Nx_n) | x."""
    return (((zi << cfg.voxel_num_axis_y_n) | yi) << cfg.voxel_num_axis_x_n) | xi


def voxel_to_ring(cfg: MapConfig, v):
    """operations.h:961-965."""
    xi = v & (cfg.nx - 1)
    yi = (v >> cfg.voxel_num_axis_x_n) & (cfg.ny - 1)
    zi = v >> (cfg.voxel_num_axis_x_n + cfg.voxel_num_axis_y_n)
    return xi, yi, zi


# ---------------------------------------------------------------------------
# Map index <-> ring index (scroll offset, operations.h:994-1033)
# ---------------------------------------------------------------------------

def map_to_ring(cfg: MapConfig, equiv_steps, mx, my, mz):
    xi = jnp.remainder(mx + equiv_steps[0], cfg.nx)
    yi = jnp.remainder(my + equiv_steps[1], cfg.ny)
    zi = jnp.remainder(mz + equiv_steps[2], cfg.nz)
    return xi, yi, zi


def ring_to_map(cfg: MapConfig, equiv_steps, xi, yi, zi):
    mx = jnp.remainder(xi - equiv_steps[0], cfg.nx)
    my = jnp.remainder(yi - equiv_steps[1], cfg.ny)
    mz = jnp.remainder(zi - equiv_steps[2], cfg.nz)
    return mx, my, mz


# ---------------------------------------------------------------------------
# Positions <-> indices
# ---------------------------------------------------------------------------

def global_pos_to_voxel(cfg: MapConfig, scroll: ScrollState, pos):
    """Global-frame position [..., 3] -> (voxel index, ring xi/yi/zi, valid).

    Mirrors globalFramePostoVoxelIdx + mapFramePostoVoxelIdx
    (operations.h:848-883).  Positions outside the map get valid=False and
    voxel index INVALID_VOXEL.
    """
    half = jnp.asarray(cfg.map_half_extent, jnp.float32)
    recip = jnp.float32(1.0 / cfg.voxel_size)
    n = jnp.asarray([cfg.nx, cfg.ny, cfg.nz], jnp.int32)

    map_frame = pos - scroll.map_center
    f = (map_frame + half) * recip
    midx = f.astype(jnp.int32)  # truncation toward zero (operations.h:867-869)
    valid = jnp.all((f >= 0) & (midx < n), axis=-1)

    xi, yi, zi = map_to_ring(
        cfg, scroll.equiv_steps, midx[..., 0], midx[..., 1], midx[..., 2]
    )
    v = jnp.where(valid, ring_to_voxel(cfg, xi, yi, zi), INVALID_VOXEL)
    return v, xi, yi, zi, valid


def voxel_to_map_pos(cfg: MapConfig, equiv_steps, v):
    """Voxel index -> map-frame corner position (operations.h:969-983)."""
    xi, yi, zi = voxel_to_ring(cfg, v)
    mx, my, mz = ring_to_map(cfg, equiv_steps, xi, yi, zi)
    half = cfg.map_half_extent
    x = mx.astype(jnp.float32) * cfg.voxel_size - half[0]
    y = my.astype(jnp.float32) * cfg.voxel_size - half[1]
    z = mz.astype(jnp.float32) * cfg.voxel_size - half[2]
    return jnp.stack([x, y, z], axis=-1)


def voxel_to_global_pos(cfg: MapConfig, scroll: ScrollState, v):
    """operations.h:939-944."""
    return voxel_to_map_pos(cfg, scroll.equiv_steps, v) + scroll.map_center


# ---------------------------------------------------------------------------
# Validity / vacancy checks (lazy scroll invalidation)
# ---------------------------------------------------------------------------

def axis_stamps_per_voxel(cfg: MapConfig, scroll: ScrollState):
    """max(stamp_x[xi], stamp_y[yi], stamp_z[zi]) for every voxel -> i32[V].

    A particle/voxel stamp below this value means the voxel column wrapped
    out of the map since then (operations.h:810-837).

    Because the flat voxel index is (((zi << Ny_n) | yi) << Nx_n) | xi, the
    per-axis lookup is a pure broadcast over the [nz, ny, nx] view — no
    gather.
    """
    sx = scroll.axis_stamp_x[None, None, :]
    sy = scroll.axis_stamp_y[None, :, None]
    sz = scroll.axis_stamp_z[:, None, None]
    out = jnp.maximum(jnp.maximum(sx, sy), sz)
    return jnp.broadcast_to(out, (cfg.nz, cfg.ny, cfg.nx)).reshape(-1)


def axis_stamps_per_voxel_slab(cfg: MapConfig, scroll: ScrollState, z0, nz_loc: int):
    """axis_stamps_per_voxel for a z-slab [z0, z0 + nz_loc) of the grid —
    the per-device view under voxel-slab sharding (the flat voxel index is
    z-major, so an even split of [V] is a z-slab).  ``z0`` may be traced."""
    sz = jax.lax.dynamic_slice(scroll.axis_stamp_z, (z0,), (nz_loc,))
    sx = scroll.axis_stamp_x[None, None, :]
    sy = scroll.axis_stamp_y[None, :, None]
    out = jnp.maximum(jnp.maximum(sx, sy), sz[:, None, None])
    return jnp.broadcast_to(out, (nz_loc, cfg.ny, cfg.nx)).reshape(-1)


def particle_alive(particles_status, particles_stamp, voxel_axis_stamp):
    """isParticleVacant negation (operations.h:810-816): a slot holds a live
    particle iff status != INVALID and its stamp is not older than the last
    wrap-out of its voxel column.

    Args:
      particles_status: i32[V, K]
      particles_stamp:  i32[V, K]
      voxel_axis_stamp: i32[V] from :func:`axis_stamps_per_voxel`.
    """
    from ..state import STATUS_INVALID

    not_invalid = particles_status != STATUS_INVALID
    fresh = particles_stamp >= voxel_axis_stamp[:, None]
    return not_invalid & fresh


def voxel_valid(voxel_stamp, voxel_axis_stamp):
    """isVoxelValid (operations.h:824-837): observed at least once and not
    wrapped out since."""
    return (voxel_stamp != 0) & (voxel_stamp >= voxel_axis_stamp)


# ---------------------------------------------------------------------------
# Ego recenter (scroll)
# ---------------------------------------------------------------------------

def _c_mod(steps, n):
    """C-style truncated modulo (operations.h:1196-1230)."""
    return jnp.where(
        steps >= 0,
        jnp.remainder(steps, n),
        -jnp.remainder(-steps, n),
    )


def _stamp_axis(n_axis: int, axis_stamp, equiv_old, delta, global_time):
    """Stamp the voxel columns that wrapped out of the map on one axis.

    Equivalent to the reference's stamping loops (operations.h:1132-1181):
    moving +d stamps ring columns (i + equiv_old) mod N for i in [0, d);
    moving -d stamps (N-1-i + equiv_old) mod N for i in [0, d).  The
    reference reaches |delta| >= N only through its multi-sub-step loop
    (operations.h:81-90), whose union of stamped columns (all with the same
    global_time_stamp value) equals clamping the count to N — so a single
    clamped pass is exact.
    """
    idx = jnp.arange(n_axis, dtype=jnp.int32)
    rel = jnp.remainder(idx - equiv_old, n_axis)
    d = jnp.clip(delta, -n_axis, n_axis)
    stamped = jnp.where(
        d >= 0,
        rel < d,
        rel >= n_axis + d,
    )
    return jnp.where(stamped, global_time, axis_stamp)


@partial(jax.jit, static_argnums=0)
def update_ego_center(cfg: MapConfig, scroll: ScrollState, new_pos, global_time) -> ScrollState:
    """updateEgoCenterPos + updateRingbufferIndexParams
    (operations.h:68-96, 1111-1191) as one pure function.

    Quantizes the ego position to voxel steps with C truncation, stamps the
    wrapped-out columns of each axis with the current global time, and updates
    the scroll offsets.  O(Nx+Ny+Nz) work; no particle data moves.
    """
    recip = jnp.float32(1.0 / cfg.voxel_size)
    center_steps = (new_pos * recip).astype(jnp.int32)  # trunc toward zero
    map_center = center_steps.astype(jnp.float32) * cfg.voxel_size

    delta = center_steps - scroll.moved_steps

    stamp_x = _stamp_axis(cfg.nx, scroll.axis_stamp_x, scroll.equiv_steps[0], delta[0], global_time)
    stamp_y = _stamp_axis(cfg.ny, scroll.axis_stamp_y, scroll.equiv_steps[1], delta[1], global_time)
    stamp_z = _stamp_axis(cfg.nz, scroll.axis_stamp_z, scroll.equiv_steps[2], delta[2], global_time)

    n = jnp.asarray([cfg.nx, cfg.ny, cfg.nz], jnp.int32)
    equiv = _c_mod(center_steps, n)

    return scroll.replace(
        ego_pos=new_pos.astype(jnp.float32),
        map_center=map_center,
        moved_steps=center_steps,
        equiv_steps=equiv,
        axis_stamp_x=stamp_x,
        axis_stamp_y=stamp_y,
        axis_stamp_z=stamp_z,
    )
