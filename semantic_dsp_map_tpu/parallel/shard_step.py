"""Explicit shard_map frame pipeline: the grid-sharding design of SURVEY
section 2.3, built so every large domain actually divides across devices.

Round-3's auto-SPMD step (parallel/sharding.py) replicated all image-space
work — the [S, H, W] pixel table, both PHD stencils, the H x W birth
candidate build — on every device, so weak scaling measured 1.3%.  This
module partitions BOTH of the frame's big domains:

  * the voxel grid, as z-slabs: the flat voxel index is z-major
    (codecs.ring_to_voxel), so splitting every [V]/[V*K] array on dim 0
    gives each device nz/D whole z-planes.  Particle state, visibility
    masks, block working sets, insertion/resampling and the render
    reduction are all voxel-local and never communicate.
  * the image, as row-slabs: each device owns H/D pixel rows (plus a 2R-row
    halo; R = the PHD stencil half-width) of the labeled point cloud, the
    pixel table and both stencil passes.

The voxel and image domains are coupled by per-particle/per-pixel routing
over ICI (the distributed analog of the reference's shared-memory pixel
pyramid, buffer.h:89-93):

  observe   visible particle entries route voxel-slab -> pixel-row owner
            (duplicated into neighbor halos), are ranked/stencilled there,
            and the per-entry weight results route back — two
            ``all_to_all`` exchanges of fixed-capacity buckets;
  birth     newborn candidates build on the pixel-row owner (its cloud
            slab) and route to the voxel-slab owner for slot-constrained
            insertion — one ``all_to_all``;
  move      rigid-moved particles re-insert across slab boundaries — one
            ``all_to_all``;
  objects   the object table is tiny and replicated; every device runs the
            identical object-level update (no communication at all).

Fixed bucket capacities keep every shape static (shard_caps).  By default
each device gets the single-chip working sets and each route bucket its
source's whole volume: a z-slab can hold a camera's whole frustum, so no
smaller static size is safe.  ``config.shard_route_headroom`` trades that
for per-device capacities of ~1/D (per-device work shrinks with the mesh);
skew beyond a bucket then drops work for ONE frame and is surfaced in
StepDiagnostics (entry/birth/move overflow counters) — never silent.

Equality with the single-device step is asserted by
tests/test_shard_step.py on the 8-virtual-device CPU mesh (noise paths off,
as in the full-frame oracle).  Tie-breaking note: the pixel-table rank sort
uses the same stable (pix, camz) 2-key sort as the single-device path, but
the input stream order is (src device bucket, send slot) instead of
working-set index — entries with bitwise-equal camera depth in the same
pixel may land in swapped table slots; all downstream sums are
order-independent, so results only differ if such a tie straddles the
rank-S cutoff.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import FilterParams, KEYPOINTS_BBOX3D, MapConfig, PARTICLE_OCC_INIT_WEIGHT
from ..labels import LabelRegistry
from ..map import StepDiagnostics
from ..objects import ObservedInstances, expire_objects, object_level_update
from ..ops import codecs
from ..ops.birth import Candidates, _insert_core
from ..ops.blocks import (
    block_layout,
    gather_rows_flat,
    group_rank,
    mask_to_block_mask,
    row_valid,
    scatter_rows_flat,
    select_blocks,
)
from ..ops.geometry import camera_matrices, project_to_image_xyz
from ..ops.observe import refresh_empty_voxel_stamps
from ..ops.phd import stencil_pass_a_any, stencil_pass_b_any, table_from_entries
from ..ops.projection import generate_labeled_cloud
from ..ops.render import RenderResult, render_core_xla
from ..state import MapState, Particles, STATUS_INVALID, STATUS_REGULAR_BORN, STATUS_UPDATED, particles_vk_sized
from ..frontend import FrameInput

AXIS = "grid"


# ---------------------------------------------------------------------------
# Fixed-capacity bucket routing (the all_to_all shuffle)
# ---------------------------------------------------------------------------


class Routed(NamedTuple):
    fields: dict          # each [D*cap] received values
    recv_valid: jax.Array  # bool[D*cap]
    send_slot: jax.Array   # i32[N] send-buffer slot of each entry (-1 dropped)
    overflow: jax.Array    # i32 entries beyond bucket capacity


def _pack_i32(fields: dict, names):
    """Stack 32-bit fields into one [N, F] i32 matrix (f32 via bitcast)."""
    cols = []
    for k in names:
        v = fields[k]
        if v.dtype == jnp.float32:
            cols.append(jax.lax.bitcast_convert_type(v, jnp.int32))
        else:
            cols.append(v.astype(jnp.int32))
    return jnp.stack(cols, axis=1)


def _unpack_i32(mat, names, dtypes):
    out = {}
    for j, k in enumerate(names):
        v = mat[:, j]
        if dtypes[k] == jnp.float32:
            v = jax.lax.bitcast_convert_type(v, jnp.float32)
        out[k] = v
    return out


def _a2a(x):
    return jax.lax.all_to_all(
        x, axis_name=AXIS, split_axis=0, concat_axis=0, tiled=True
    )


def _route(fields: dict, valid: jax.Array, dest: jax.Array, n_dev: int, cap: int) -> Routed:
    """Bin entries into [n_dev, cap] buckets by ``dest`` and all_to_all them.

    ``dest`` < 0 or valid == False drops the entry.  Deterministic: bucket
    order is ascending original index (stable sort).  All fields ride ONE
    collective (packed to an i32 matrix, f32 via bitcast) and one row
    scatter — collective count is latency-critical on both ICI and the
    virtual-CPU mesh."""
    N = dest.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
    dkey = jnp.where(valid & (dest >= 0) & (dest < n_dev), dest, n_dev)
    s_dest, s_idx = jax.lax.sort((dkey, iota), num_keys=1)
    rank_sorted = group_rank(s_dest)
    ok_sorted = (s_dest < n_dev) & (rank_sorted < cap)
    slot_sorted = jnp.where(ok_sorted, s_dest * cap + rank_sorted, -1)
    # send_slot in original order (scatter by s_idx, unique)
    send_slot = jnp.zeros(N, jnp.int32).at[s_idx].set(
        slot_sorted, unique_indices=True
    )
    overflow = jnp.sum((dkey < n_dev).astype(jnp.int32)) - jnp.sum(
        (slot_sorted >= 0).astype(jnp.int32)
    )

    scat_idx = jnp.where(send_slot >= 0, send_slot, n_dev * cap + iota)

    names = sorted(fields)
    dtypes = {k: fields[k].dtype for k in names}
    mat = _pack_i32(fields, names)
    mat = jnp.concatenate([mat, (send_slot >= 0).astype(jnp.int32)[:, None]], 1)
    buf = (
        jnp.zeros((n_dev * cap, len(names) + 1), jnp.int32)
        .at[scat_idx]
        .set(mat, mode="drop", unique_indices=True)
    )
    recv = _a2a(buf)
    out = _unpack_i32(recv, names, dtypes)
    recv_valid = recv[:, -1] != 0
    return Routed(fields=out, recv_valid=recv_valid, send_slot=send_slot,
                  overflow=overflow)


def _route_back(result_fields: dict, send_slot: jax.Array):
    """Return per-received-slot results to the senders; gather each original
    entry's result at its send slot.  Returns dict of [N] arrays (zeros for
    dropped entries).  One collective total."""
    names = sorted(result_fields)
    dtypes = {k: result_fields[k].dtype for k in names}
    ret = _a2a(_pack_i32(result_fields, names))
    idx = jnp.maximum(send_slot, 0)
    got = _unpack_i32(ret[idx], names, dtypes)
    return {
        k: jnp.where(send_slot >= 0, v, jnp.zeros_like(v))
        for k, v in got.items()
    }


def _exchange_table_halo(cfg, t_loc, D: int, rpd: int, ext0: int):
    """Extend an owned-rows pixel table [S, rpd, W] to [S, rpd + 2*ext0, W]
    with dense halo rows from neighbor devices (two ppermute chains).

    Replaces round-4's per-entry halo duplication: each visible entry is now
    routed to its owner exactly once, and the stencil's boundary needs are
    met by exchanging the assembled table's edge rows — a fixed-size dense
    transfer (2 * ext0 rows x W x S x 5 planes) with no skew sensitivity and
    no duplicated sort/table work.

    Round 5 halved the halo: ext0 = R (one stencil radius) instead of 2R.
    With a 2R halo each device recomputed its neighbors' edge ck rows from
    scratch; with R, pass A's halo-row cks are incomplete and are instead
    OVERWRITTEN with the neighbor's correct owned rows by _exchange_ck_halo
    between the passes — R rows of one f32 plane versus R rows of 5*S table
    planes.

    Encoding: all planes ride ONE i32 collective per hop/direction (f32 via
    bitcast); the meta plane ships as meta+1 so ppermute's zero-fill at the
    image edges (devices without a neighbor) decodes to the empty sentinel
    -1.  Hops > 1 cover halos that span multiple row slabs (tiny grids).
    """
    from ..ops.phd import PixelTable

    S = t_loc.px.shape[0]
    W = t_loc.px.shape[2]
    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)
    packed = jnp.stack(
        [bc(t_loc.px), bc(t_loc.py), bc(t_loc.pz), bc(t_loc.weight),
         t_loc.meta + 1],
        axis=0,
    )  # i32[5, S, rpd, W]

    # Only the needed edge rows ride the wire: hop q contributes
    # min(rpd, ext0 - (q-1)*rpd) rows (permuting whole owned slabs cost
    # rpd/ext0 ~ 38x the bytes at VKITTI2 shapes).
    ns = min(-(-ext0 // rpd), D - 1)
    ups, downs = [], []
    for q in range(1, ns + 1):
        need_q = min(rpd, ext0 - (q - 1) * rpd)
        perm_from_up = [(d, d + q) for d in range(D - q)]
        perm_from_dn = [(d + q, d) for d in range(D - q)]
        ups.append(jax.lax.ppermute(
            packed[:, :, rpd - need_q :], AXIS, perm_from_up))
        downs.append(jax.lax.ppermute(
            packed[:, :, :need_q], AXIS, perm_from_dn))

    rows_have = min(ns * rpd, ext0)
    zrows = jnp.zeros((5, S, ext0 - rows_have, W), jnp.int32)
    if ns:
        top = jnp.concatenate([zrows] + ups[::-1], axis=2)
        bot = jnp.concatenate(downs + [zrows], axis=2)
    else:
        top = bot = jnp.zeros((5, S, ext0, W), jnp.int32)

    ext = jnp.concatenate([top, packed, bot], axis=2)
    fc = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
    return PixelTable(
        px=fc(ext[0]), py=fc(ext[1]), pz=fc(ext[2]), weight=fc(ext[3]),
        meta=ext[4] - 1, dropped=t_loc.dropped,
    )


def _exchange_ck_halo(ck: jax.Array, D: int, rpd: int, ext0: int):
    """Overwrite the ``ext0`` halo rows of a pass-A output plane
    [rpd + 2*ext0, W] with the neighbors' CORRECT owned edge rows.

    Pass A over the R-halo table computes complete cks only for the owned
    rows (a halo-row ck would need table support up to 2R away); the halo
    rows' cks that pass B reads come from the devices that own them.

    Halo rows with no owner (beyond the image edges; ppermute zero-fills
    devices outside the permutation) decode to 1.0 — the same value pass B's
    out-of-array padding uses.  Those rows are observation-invalid so their
    ck is never a real contribution, but it must not be 0: the XLA pass B
    computes gk/ckk before masking, and 0/0 would poison the accumulator
    with NaN.  Encoding: ck+1 rides the wire (ck >= 0 so a legit row is
    >= 1; a zero-filled row decodes via the == 0 test)."""
    ns = min(-(-ext0 // rpd), D - 1)
    if ns == 0:
        return ck
    own = ck[ext0 : ext0 + rpd] + 1.0
    ups, downs = [], []
    for q in range(1, ns + 1):
        need_q = min(rpd, ext0 - (q - 1) * rpd)
        perm_from_up = [(d, d + q) for d in range(D - q)]
        perm_from_dn = [(d + q, d) for d in range(D - q)]
        ups.append(jax.lax.ppermute(own[rpd - need_q :], AXIS, perm_from_up))
        downs.append(jax.lax.ppermute(own[:need_q], AXIS, perm_from_dn))
    rows_have = min(ns * rpd, ext0)
    W = ck.shape[1]
    zrows = jnp.zeros((ext0 - rows_have, W), jnp.float32)
    top = jnp.concatenate([zrows] + ups[::-1], axis=0)
    bot = jnp.concatenate(downs + [zrows], axis=0)
    halo_dec = lambda x: jnp.where(x == 0.0, 1.0, x - 1.0)
    return jnp.concatenate(
        [halo_dec(top), ck[ext0 : ext0 + rpd], halo_dec(bot)], axis=0
    )


# ---------------------------------------------------------------------------
# The sharded step builder
# ---------------------------------------------------------------------------


def shard_caps(cfg: MapConfig, params: FilterParams, D: int) -> dict:
    """Per-device working-set and route-bucket capacities.

    The grid's z-slabs meet a camera that looks along its own axis: a
    forward-looking camera sends most of a frame's points to one or two
    slabs (on four H100s at VKITTI2 width, buckets at 1.15/4 of a source's
    volume dropped 284,716 births in one frame).  So by default
    (``shard_route_headroom=None``) every device gets the single-chip
    working sets and every (src, dst) bucket the source's whole volume:
    the effective headroom is D, and nothing the single-chip step keeps
    can overflow.  A float headroom sizes everything at ``headroom_eff/D``
    of that, with the margin scaled by a slab's relative load variance
    (1 - 1/D) — see config.shard_route_headroom.

    Each _insert_core gathers, merges and scatters ~9 fields over its whole
    [A, spb] working set, so EVERY per-device buffer here scales with
    headroom_eff/D.
    """
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    V_loc = V // D
    H, W = cfg.height, cfg.width
    rpd = -(-H // D)
    bv, _nb_full, spb = block_layout(cfg)
    nb_loc = V_loc // bv
    if cfg.shard_route_headroom is None:
        hroom = float(D)
    else:
        hroom = 1.0 + (float(cfg.shard_route_headroom) - 1.0) * (1.0 - 1.0 / D)
    floor = int(cfg.shard_route_floor)

    def scaled(knob, lo):
        a = max(min(knob, nb_loc), min(lo, nb_loc))
        if D > 1:
            a = max(min(int(hroom * knob) // D, nb_loc), min(lo, nb_loc))
        return a

    def _cap(total, full_floor):
        # Route bucket per (src, dst) pair: FULL volume when small (up to
        # the configurable floor — tests / small grids: overflow
        # impossible), headroom_eff/D of it when large.
        return max(1, min(total, min(full_floor, floor)),
                   int(hroom * total) // D)

    A_loc = scaled(cfg.max_active_blocks, 64)
    n_work = A_loc * spb
    nb_pp = params.nb_ptc_num_per_point if params.if_consider_depth_noise else 1
    n_cand = rpd * W * nb_pp
    A_move = scaled(cfg.max_moving_blocks, 16)
    A_birth = scaled(cfg.max_birth_blocks, 64)
    n_move = A_move * spb
    return dict(
        hroom=hroom, A_loc=A_loc, n_work=n_work,
        ECAP=_cap(n_work, 1024), BCAP=_cap(n_cand, 512),
        MCAP=_cap(n_move, 1024),
        A_move=A_move, A_birth=A_birth, n_move=n_move,
        C_loc=max(1, min(
            D * _cap(n_work, 1024), cfg.max_table_entries,
            max(floor, int(hroom * cfg.max_table_entries) // D),
        )),
    )


def ici_bytes_per_frame(cfg: MapConfig, params: FilterParams, D: int) -> int:
    """Per-device ICI traffic of one sharded frame, in bytes (both
    directions): the three all_to_all routes (+ observe's result
    route-back), the dense table/ck halo ppermutes, and the diagnostics
    psum.  Everything is a fixed-capacity buffer, so this is exact for the
    compiled program (actual occupancy does not change wire bytes)."""
    c = shard_caps(cfg, params, D)
    S = cfg.phd_pixel_table_slots
    R = cfg.neighbor_half
    H, W = cfg.height, cfg.width
    rpd = -(-H // D)
    ext0 = R
    ns = min(-(-ext0 // rpd), D - 1)
    rows = min(ns * rpd, ext0)          # halo rows actually on the wire
    b = 0
    b += D * c["ECAP"] * 8 * 4          # observe route out (7 fields + valid)
    b += D * c["ECAP"] * 2 * 4          # observe results back (w, meta)
    b += D * c["BCAP"] * 7 * 4          # birth route (6 fields + valid)
    b += D * c["MCAP"] * 9 * 4          # move route (8 fields + valid)
    b += 2 * 5 * S * rows * W * 4       # table halo (2 dirs, 5 planes)
    b += 2 * rows * W * 4               # ck halo (2 dirs, 1 plane)
    b += 9 * 4                          # diagnostics psum
    return b


def build_shard_map_step(
    cfg: MapConfig,
    params: FilterParams,
    registry: LabelRegistry,
    mesh: Mesh,
    packed: bool = False,
):
    """Returns the jitted sharded step: (MapState, FrameInput) ->
    (MapState, RenderResult, StepDiagnostics).

    State arrays are sharded on their voxel dimension (z-slabs).  With
    ``packed=True`` the step instead takes the ONE-BUFFER packed frame
    (frontend.pack_frame) and decodes it device-side exactly like the
    single-chip path (map.unpack_frame) — one host->device array per frame
    instead of 14 replicated leaves (each transfer pays a fixed latency).
    The buffer
    is replicated; the decode is a cheap dense pass that every device runs
    identically."""
    D = int(mesh.devices.size)
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    if V % D or cfg.nz % D:
        raise ValueError(
            f"grid ({cfg.nz} z-planes, {V} voxels) not divisible by "
            f"{D} devices"
        )
    V_loc, nz_loc = V // D, cfg.nz // D
    H, W = cfg.height, cfg.width
    S = cfg.phd_pixel_table_slots
    R = cfg.neighbor_half
    rpd = -(-H // D)                    # image rows per device
    ext0 = R                            # halo rows above the owned slab
    Hext = rpd + 2 * R                  # cloud/table rows incl. halos
    Hpad = rpd * D + 2 * R              # padded full-image rows

    bv, _nb_full, spb = block_layout(cfg)
    nb_loc = V_loc // bv
    caps = shard_caps(cfg, params, D)
    hroom = caps["hroom"]
    A_loc, n_work, ECAP = caps["A_loc"], caps["n_work"], caps["ECAP"]
    BCAP, MCAP = caps["BCAP"], caps["MCAP"]
    A_move, A_birth, n_move = caps["A_move"], caps["A_birth"], caps["n_move"]
    nb_pp = params.nb_ptc_num_per_point if params.if_consider_depth_noise else 1

    max_movable = registry.max_movable_instance_id
    sky_instance = registry.static_label_to_instance.get(
        "Sky", registry.static_label_to_instance.get("sky", -1)
    )
    use_zed2 = cfg.keypoint_mode == KEYPOINTS_BBOX3D
    HW = H * W

    # ------------------------------------------------------------------
    def _cloud_slab(frame, r_wc, t_wc, dev):
        """Labeled cloud on this device's extended row slab."""
        r0 = dev * rpd
        pad_rows = ((ext0, Hpad - H - ext0), (0, 0))
        dpad = jnp.pad(frame.depth, pad_rows)
        rpad = jnp.pad(frame.track_raster, pad_rows)
        depth_slab = jax.lax.dynamic_slice(dpad, (r0, 0), (Hext, W))
        raster_slab = jax.lax.dynamic_slice(rpad, (r0, 0), (Hext, W))
        return generate_labeled_cloud(
            cfg, params, depth_slab, raster_slab, frame.track_label_table,
            r_wc, t_wc, max_movable,
            sky_instance_id=sky_instance if use_zed2 else -1,
            inst_bbox_min=frame.inst_bbox_min if use_zed2 else None,
            inst_bbox_max=frame.inst_bbox_max if use_zed2 else None,
            row_offset=r0 - ext0,
        )

    # ------------------------------------------------------------------
    def _observe_sharded(dev, particles, scroll, vox_axis, voxel_stamp,
                         cloud_ext, depth_full, r_cw, t_cw, gt):
        """Distributed observe: local candidates -> route to pixel owners ->
        rank/table/stencil -> results route home -> local write-back."""
        flat = particles
        pv = particles_vk_sized(particles, V_loc, K)

        # -- local candidate masks (front) --
        alive_d = codecs.particle_alive(pv.status, pv.stamp, vox_axis)
        _, _, _, proj_ok = project_to_image_xyz(
            cfg, r_cw, t_cw, pv.px, pv.py, pv.pz
        )
        cand_d = proj_ok & alive_d
        has_alive = jnp.any(alive_d, axis=1)
        block_mask = mask_to_block_mask(cand_d, bv)

        blocks = select_blocks(block_mask, A_loc)
        rv = row_valid(blocks)
        # flat sliced gathers (ops/blocks.py): only working-set rows move
        g = lambda f: gather_rows_flat(f, blocks, bv * K)
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
        # stale-slot prune on visit (operations.h:1374-1377)
        bst = jnp.where(not_invalid & ~fresh & rv[:, None], STATUS_INVALID, bst)

        brow, bcol, bcamz, bok = project_to_image_xyz(cfg, r_cw, t_cw, bpx, bpy, bpz)
        bcand = (bok & balive).reshape(-1)
        row_f = brow.reshape(-1)
        pix = jnp.where(bcand, row_f * W + bcol.reshape(-1), HW)
        camz = bcamz.reshape(-1)

        # -- classification against the (replicated) depth raster --
        depth_at = depth_full.reshape(-1)[jnp.minimum(pix, HW - 1)]
        one_sigma = 1.0 + cfg.depth_error_stddev_at_one_meter
        real = bcand
        far_free = real & (depth_at > cfg.depth_range_max)
        occluded = real & ~far_free & (camz > depth_at * one_sigma)
        visible = real & ~far_free & ~occluded

        meta = ((btrack << 8) | (bforget & 0xFF)).reshape(-1)

        # -- route visible entries to their pixel-row OWNER only --
        # Routing halo copies too (an entry near a slab boundary going to
        # up to 2*n_side neighbors) would triple the _route input and
        # duplicate the receiver-side sort/table work.  Each entry is
        # routed once, and the stencil's dense 2R-row table halo is
        # exchanged between neighbors instead (_exchange_table_halo).
        owner = jnp.minimum(row_f // rpd, D - 1)
        fields = {
            "pix": pix, "camz": camz,
            "px": bpx.reshape(-1), "py": bpy.reshape(-1),
            "pz": bpz.reshape(-1), "w": bw.reshape(-1),
            "meta": meta,
        }
        routed = _route(fields, visible, owner, D, ECAP)

        # -- local rank + table on the OWNED row slab --
        # (pix, camz) 2-key sort exactly like the single-device path:
        # lax.sort is stable and the received bucket order (src device, send
        # slot) is deterministic, so no explicit tie-break key is needed.
        M = D * ECAP
        r0 = dev * rpd
        pix_r = jnp.where(routed.recv_valid, routed.fields["pix"], HW)
        iota_m = jax.lax.broadcasted_iota(jnp.int32, (M, 1), 0).squeeze(-1)
        (pix_s, _cz, px_s, py_s, pz_s, w_s, meta_s, slot_s) = jax.lax.sort(
            (pix_r, routed.fields["camz"],
             routed.fields["px"], routed.fields["py"], routed.fields["pz"],
             routed.fields["w"], routed.fields["meta"], iota_m),
            num_keys=2,
        )
        # The per-device share of the single-chip compact-entry cap
        # (observe.py slices its sorted stream to max_table_entries; without
        # this the receiver-side table pipeline ran on the FULL bucket
        # volume — ~3x the base per-device stream, a large share of the
        # weak-scaling FLOP overhead).  Dropped-entry accounting below.
        C_loc = caps["C_loc"]
        n_real_full = jnp.sum((pix_s < HW).astype(jnp.int32))
        pix_s, px_s, py_s, pz_s = pix_s[:C_loc], px_s[:C_loc], py_s[:C_loc], pz_s[:C_loc]
        w_s, meta_s, slot_s = w_s[:C_loc], meta_s[:C_loc], slot_s[:C_loc]
        real_s = pix_s < HW
        cap_dropped = n_real_full - jnp.sum(real_s.astype(jnp.int32))
        rank_s = group_rank(pix_s)
        keep_s = real_s & (rank_s < S)
        # owned-slab-local pixel ids (all received entries are owned rows)
        pix_own = pix_s - r0 * W
        pix_own = jnp.where(keep_s, pix_own, rpd * W)
        t_loc = table_from_entries(
            cfg, pix_own, rank_s, keep_s,
            px_s, py_s, pz_s, w_s, meta_s >> 8, meta_s & 0xFF,
            n_rows=rpd,
        )
        # -- dense halo exchange + stencils on the extended row slab --
        # R-row table halo for pass A's owned rows; pass A's (incomplete)
        # halo-row cks are then overwritten with the owners' correct rows
        # before pass B reads them (_exchange_ck_halo docstring).
        table = _exchange_table_halo(cfg, t_loc, D, rpd, ext0)
        # table-ext-local pixel ids of the owned entries (for result gather)
        pix_loc = jnp.where(keep_s, pix_s - (r0 - ext0) * W, Hext * W)
        ck_kappa = stencil_pass_a_any(cfg, params, table, cloud_ext)
        ck_kappa = _exchange_ck_halo(ck_kappa, D, rpd, ext0)
        new_w_t, new_f_t = stencil_pass_b_any(cfg, params, table, cloud_ext, ck_kappa)

        dest_t = jnp.where(keep_s, jnp.minimum(rank_s, S - 1) * (Hext * W) + pix_loc, 0)
        # One row-gather for both result planes (see ops/observe.py).
        res_t = jnp.stack(
            [new_w_t.reshape(-1), new_f_t.reshape(-1).astype(jnp.float32)],
            axis=-1,
        )
        res_e = res_t[dest_t]
        nw_e = res_e[:, 0]
        nf_e = res_e[:, 1].astype(jnp.int32)

        res_w = jnp.zeros(M, jnp.float32).at[slot_s].set(
            jnp.where(keep_s, nw_e, 0.0), unique_indices=True
        )
        res_m = jnp.zeros(M, jnp.int32).at[slot_s].set(
            jnp.where(keep_s, (nf_e & 0xFF) | (1 << 8), 0), unique_indices=True
        )
        back = _route_back({"w": res_w, "m": res_m}, routed.send_slot[:n_work])

        # -- merge results into the working set (home side) --
        upd = (back["m"] >> 8) & 1
        w_upd = jnp.where(
            upd == 1, back["w"],
            jnp.where(far_free, PARTICLE_OCC_INIT_WEIGHT, bw.reshape(-1)),
        )
        touched = (upd == 1) | far_free
        observed = visible | far_free

        shp = (A_loc, spb)
        bw = jnp.where(touched.reshape(shp), w_upd.reshape(shp), bw)
        bst = jnp.where(upd.reshape(shp) == 1, STATUS_UPDATED, bst)
        bstamp = jnp.where(upd.reshape(shp) == 1, gt, bstamp)
        bforget = jnp.where(
            upd.reshape(shp) == 1, (back["m"] & 0xFF).reshape(shp), bforget
        )

        out_particles = flat.replace(
            weight=scatter_rows_flat(flat.weight, blocks, bv * K, bw),
            status=scatter_rows_flat(flat.status, blocks, bv * K, bst),
            stamp=scatter_rows_flat(flat.stamp, blocks, bv * K, bstamp),
            forget=scatter_rows_flat(flat.forget, blocks, bv * K, bforget),
        )

        obs_vox = jnp.any(observed.reshape(A_loc, bv, K), axis=2)
        bvst = gather_rows_flat(voxel_stamp, blocks, bv)
        bvst = jnp.where(obs_vox & rv[:, None], gt, bvst)
        voxel_stamp = scatter_rows_flat(voxel_stamp, blocks, bv, bvst)

        voxel_stamp, corner_overflow = refresh_empty_voxel_stamps(
            cfg, scroll, voxel_stamp, has_alive, depth_full, r_cw, t_cw, gt,
            vox_base=dev * V_loc, vox_axis=vox_axis,
        )

        diag = dict(
            visible_count=jnp.sum(visible.astype(jnp.int32)),
            block_overflow=blocks.overflow,
            entry_overflow=routed.overflow + cap_dropped,
            # Owner-only routing: every received entry competes exactly
            # once, so the psum'd drop count matches the single-device
            # ObserveDiag semantics directly.
            table_dropped=jnp.sum((real_s & ~keep_s).astype(jnp.int32)),
            corner_overflow=corner_overflow,
        )
        return out_particles, voxel_stamp, diag

    # ------------------------------------------------------------------
    def _birth_sharded(dev, particles, scroll, vox_axis, cloud_ext, gt, rng):
        """Newborn candidates from the owned row slab, routed to voxel-slab
        owners, inserted with resampling."""
        # owned rows of the extended cloud
        own = lambda a: jax.lax.dynamic_slice_in_dim(a, ext0, rpd, axis=0)
        pos = own(cloud_ext.pos).reshape(-1, 3)
        valid = own(cloud_ext.valid).reshape(-1)
        label = own(cloud_ext.label).reshape(-1)
        track = own(cloud_ext.track).reshape(-1)
        sigma = own(cloud_ext.sigma).reshape(-1)

        r0 = dev * rpd
        rows = (
            jax.lax.broadcasted_iota(jnp.int32, (rpd, W), 0) + r0
        )
        cols = jax.lax.broadcasted_iota(jnp.int32, (rpd, W), 1)
        valid = valid & (rows < H).reshape(-1)
        phase = (rows % 3) * 3 + cols % 3
        pri = ((phase * H + rows) * W + cols).reshape(-1)

        if nb_pp > 1:
            rep = lambda a: jnp.repeat(a, nb_pp, axis=0)
            pos, valid, label, track, sigma = (
                rep(pos), rep(valid), rep(label), rep(track), rep(sigma)
            )
            pri = rep(pri) * nb_pp + jnp.tile(
                jnp.arange(nb_pp, dtype=jnp.int32), rpd * W
            )
            noise = (
                jax.random.normal(jax.random.fold_in(rng, dev),
                                  pos.shape, jnp.float32)
                * sigma[:, None]
            )
            pos = pos + noise
        elif params.if_consider_depth_noise:
            pri = pri * nb_pp

        vox_g, _, _, _, in_map = codecs.global_pos_to_voxel(cfg, scroll, pos)
        valid = valid & in_map
        dest = jnp.where(valid, vox_g // V_loc, -1)
        meta = (label.astype(jnp.int32) << 16) | (track.astype(jnp.int32) & 0xFFFF)

        routed = _route(
            {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
             "pri": pri, "meta": meta, "vox": vox_g},
            valid, dest, D, BCAP,
        )
        M = D * BCAP
        f = routed.fields
        rvalid = routed.recv_valid
        cand = Candidates(
            pos=jnp.stack([f["x"], f["y"], f["z"]], axis=-1),
            weight=jnp.full(M, PARTICLE_OCC_INIT_WEIGHT, jnp.float32),
            label=(f["meta"] >> 16) & 0xFF,
            track=f["meta"] & 0xFFFF,
            status=jnp.full(M, STATUS_REGULAR_BORN, jnp.int32),
            stamp=jnp.full(M, 0, jnp.int32),
            forget=jnp.zeros(M, jnp.int32),
            priority=jnp.where(rvalid, f["pri"], jnp.int32(1 << 30)),
            valid=rvalid,
        )
        vox_local = jnp.where(rvalid, f["vox"] - dev * V_loc, V_loc)
        res = _insert_core(
            cfg, particles, scroll, cand, resample_targets=True,
            need_src=False,
            uniform_weight=PARTICLE_OCC_INIT_WEIGHT, uniform_stamp=gt,
            vox=vox_local, valid=rvalid, vox_axis=vox_axis,
            max_target_blocks=A_birth,
        )
        return res.particles, res.accepted_count, res.block_overflow, routed.overflow

    # ------------------------------------------------------------------
    def _move_sharded(dev, particles, scroll, vox_axis, objects, gt, rng):
        """Rigid moves + floating cleanup, with cross-slab re-insertion."""
        flat = particles
        pv = particles_vk_sized(particles, V_loc, K)

        mv_obj = (
            objects.valid & objects.has_moved_record & objects.moving
            & objects.has_tmatrix
        )
        if params.if_use_template_matching:
            mv_obj = mv_obj & ~objects.to_match_previous

        alive = codecs.particle_alive(pv.status, pv.stamp, vox_axis)
        track = pv.track
        movable_p = alive & (track <= max_movable)
        blocks = select_blocks(mask_to_block_mask(movable_p, bv), A_move)
        rv = row_valid(blocks)
        g = lambda f: gather_rows_flat(f, blocks, bv * K)
        btrk = g(flat.track).astype(jnp.int32)
        bst = g(flat.status).astype(jnp.int32)
        bstamp = g(flat.stamp).astype(jnp.int32)
        baxis = jnp.repeat(gather_rows_flat(vox_axis, blocks, bv), K, axis=1)
        balive = (bst != STATUS_INVALID) & (bstamp >= baxis)
        bmovable = balive & (btrk <= max_movable) & rv[:, None]

        O = objects.valid.shape[0]
        CH = 8
        n_chunks = (O + CH - 1) // CH
        pad = n_chunks * CH - O
        ids_p = jnp.concatenate([objects.track_id, jnp.full(pad, -2, jnp.int32)])
        own_p = jnp.concatenate([objects.valid, jnp.zeros(pad, bool)])
        mv_p = jnp.concatenate([mv_obj, jnp.zeros(pad, bool)])

        def chunk_body(i, carry):
            owned, moving = carry
            ids = jax.lax.dynamic_slice(ids_p, (i * CH,), (CH,))
            ow = jax.lax.dynamic_slice(own_p, (i * CH,), (CH,))
            mv = jax.lax.dynamic_slice(mv_p, (i * CH,), (CH,))
            eq = btrk[:, :, None] == ids
            owned = owned | jnp.any(eq & ow, axis=-1)
            moving = moving | jnp.any(eq & mv, axis=-1)
            return owned, moving

        zero = jnp.zeros(btrk.shape, bool)
        owned, moving_mask = jax.lax.fori_loop(0, n_chunks, chunk_body, (zero, zero))

        floating = bmovable & ~owned
        bst_clean = jnp.where(floating, STATUS_INVALID, bst)
        flat = flat.replace(
            status=scatter_rows_flat(flat.status, blocks, bv * K, bst_clean)
        )
        bmove = bmovable & moving_mask & ~floating

        # NOTE: unlike the single-device path this branch always executes
        # (lax.cond would still trace both sides under shard_map, and the
        # routing collectives must run on every device every frame).
        bpx, bpy, bpz = g(flat.px), g(flat.py), g(flat.pz)
        bw2 = g(flat.weight)
        blabel = g(flat.label).astype(jnp.int32)

        def obj_body(o, pos):
            nx, ny, nz = pos
            T = objects.tmatrix[o]
            match = bmove & (btrk == objects.track_id[o]) & mv_obj[o]
            tx = T[0, 0] * bpx + T[0, 1] * bpy + T[0, 2] * bpz + T[0, 3]
            ty = T[1, 0] * bpx + T[1, 1] * bpy + T[1, 2] * bpz + T[1, 3]
            tz = T[2, 0] * bpx + T[2, 1] * bpy + T[2, 2] * bpz + T[2, 3]
            return (
                jnp.where(match, tx, nx),
                jnp.where(match, ty, ny),
                jnp.where(match, tz, nz),
            )

        nx, ny, nz = jax.lax.fori_loop(0, O, obj_body, (bpx, bpy, bpz))
        if params.prediction_stddev > 0:
            noise = jax.random.normal(
                jax.random.fold_in(rng, dev), (3,) + bpx.shape, jnp.float32
            ) * params.prediction_stddev
            nx, ny, nz = nx + noise[0], ny + noise[1], nz + noise[2]

        bst_del = jnp.where(bmove, STATUS_INVALID, bst_clean)
        flat = flat.replace(
            status=scatter_rows_flat(flat.status, blocks, bv * K, bst_del)
        )

        meta = (
            (jnp.clip(g(flat.forget).astype(jnp.int32), 0, 7) << 27)
            | (jnp.clip(bst_clean.astype(jnp.int32), 0, 7) << 24)
            | ((blabel.astype(jnp.int32) & 0xFF) << 16)
            | (btrk.astype(jnp.int32) & 0xFFFF)
        ).reshape(-1)

        pos = jnp.stack([nx.reshape(-1), ny.reshape(-1), nz.reshape(-1)], axis=-1)
        vox_g, _, _, _, in_map = codecs.global_pos_to_voxel(cfg, scroll, pos)
        valid = bmove.reshape(-1) & in_map
        dest = jnp.where(valid, vox_g // V_loc, -1)
        pri = dev * n_move + jax.lax.broadcasted_iota(
            jnp.int32, (n_move, 1), 0
        ).squeeze(-1)

        routed = _route(
            {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
             "w": bw2.reshape(-1), "stamp": bstamp.reshape(-1),
             "meta": meta, "vox": vox_g, "pri": pri},
            valid, dest, D, MCAP,
        )
        M = D * MCAP
        f = routed.fields
        rvalid = routed.recv_valid
        cand = Candidates(
            pos=jnp.stack([f["x"], f["y"], f["z"]], axis=-1),
            weight=f["w"],
            label=(f["meta"] >> 16) & 0xFF,
            track=f["meta"] & 0xFFFF,
            status=(f["meta"] >> 24) & 0x7,
            stamp=f["stamp"],
            forget=(f["meta"] >> 27) & 0x7,
            priority=jnp.where(rvalid, f["pri"], jnp.int32(1 << 30)),
            valid=rvalid,
        )
        vox_local = jnp.where(rvalid, f["vox"] - dev * V_loc, V_loc)
        res = _insert_core(
            cfg, flat, scroll, cand, resample_targets=False, need_src=False,
            vox=vox_local, valid=rvalid, vox_axis=vox_axis,
            max_target_blocks=2 * A_move,
        )
        moved = res.accepted_count
        return res.particles, moved, (blocks.overflow + routed.overflow
                                      + res.block_overflow)

    # ------------------------------------------------------------------
    def body(state: MapState, frame: FrameInput):
        dev = jax.lax.axis_index(AXIS)
        gt = state.global_time + 1
        rng, k_obj, k_move, k_birth = jax.random.split(state.rng, 4)
        r_wc, t_wc, r_cw, t_cw = camera_matrices(frame.cam_pos, frame.cam_quat)

        objects = state.objects
        if cfg.consider_instance:
            obs = ObservedInstances(
                valid=frame.inst_valid,
                track=frame.inst_track,
                label=frame.inst_label,
                kpts_curr=frame.kpts_curr,
                kpts_prev=frame.kpts_prev,
                kpts_count=frame.kpts_count,
            )
            objects = object_level_update(
                cfg, params, objects, obs, frame.cam_pos, r_cw, t_cw,
                frame.time, state.prev_frame_time, gt, k_obj,
            )

        cloud_ext = _cloud_slab(frame, r_wc, t_wc, dev)

        scroll = codecs.update_ego_center(cfg, state.scroll, frame.cam_pos, gt)
        objects, _expired = expire_objects(params, objects, gt)
        vox_axis = codecs.axis_stamps_per_voxel_slab(
            cfg, scroll, dev * nz_loc, nz_loc
        )

        particles, moved, move_overflow = _move_sharded(
            dev, state.particles, scroll, vox_axis, objects, gt, k_move
        )

        particles, voxel_stamp, odiag = _observe_sharded(
            dev, particles, scroll, vox_axis, state.voxel_stamp,
            cloud_ext, frame.depth, r_cw, t_cw, gt,
        )

        particles, born, birth_overflow, route_overflow = _birth_sharded(
            dev, particles, scroll, vox_axis, cloud_ext, gt, k_birth
        )

        particles, result = render_core_xla(
            cfg, particles, voxel_stamp, vox_axis,
            params.occupancy_threshold,
        )

        new_state = state.replace(
            particles=particles,
            voxel_stamp=voxel_stamp,
            scroll=scroll,
            objects=objects,
            global_time=gt,
            prev_frame_time=frame.time,
            rng=rng,
        )
        # one fused psum for all nine counters (collective count matters)
        stacked = jax.lax.psum(
            jnp.stack([
                odiag["visible_count"], born, moved,
                odiag["block_overflow"], odiag["entry_overflow"],
                odiag["table_dropped"], odiag["corner_overflow"],
                move_overflow, birth_overflow + route_overflow,
            ]),
            AXIS,
        )
        diag = StepDiagnostics(*[stacked[i] for i in range(9)])
        return new_state, result, diag

    # ------------------------------------------------------------------
    # shard_map specs: voxel-dim arrays split, everything else replicated.
    def _state_spec(leaf):
        shape = getattr(leaf, "shape", ())
        vk = V * K
        for d, size in enumerate(shape):
            if size in (V, vk):
                spec = [None] * len(shape)
                spec[d] = AXIS
                return P(*spec)
        return P()

    from ..state import init_map_state

    example = jax.eval_shape(lambda: init_map_state(cfg))
    state_specs = jax.tree_util.tree_map(_state_spec, example)
    # scroll/object state stays replicated: _state_spec only matches
    # voxel-sized dims (V or V*K).
    frame_specs = jax.tree_util.tree_map(lambda _: P(), _frame_struct(cfg))

    out_state_specs = state_specs
    render_specs = RenderResult(occ=P(AXIS), label=P(AXIS), track=P(AXIS),
                                weight_sum=P(AXIS))
    diag_specs = StepDiagnostics(*([P()] * len(StepDiagnostics._fields)))

    if packed:
        from ..frontend import static_label_table
        from ..map import unpack_frame

        stable = static_label_table(registry)

        def body_packed(state: MapState, buf):
            return body(state, unpack_frame(cfg, stable, buf))

        fn = shard_map(
            body_packed,
            mesh=mesh,
            in_specs=(state_specs, P()),
            out_specs=(out_state_specs, render_specs, diag_specs),
            check_vma=False,
        )
        return jax.jit(fn, donate_argnums=0)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(state_specs, frame_specs),
        out_specs=(out_state_specs, render_specs, diag_specs),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=0)


def _frame_struct(cfg: MapConfig):
    from .sharding import _example_frame_struct

    return _example_frame_struct(cfg)
