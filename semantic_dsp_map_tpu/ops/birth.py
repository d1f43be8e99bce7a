"""Particle birth, slot-constrained insertion, and per-voxel resampling.

The reference inserts newborn particles point-by-point into the first vacant
slot of the target voxel, resampling a voxel (at most once per frame) when an
insertion finds it full (semantic_dsp_map.h:1148-1230, 1448-1519;
operations.h:782-803).  That retry loop is inherently serial; the array
reformulation is:

  1. resample every voxel that is targeted by at least one birth candidate
     this frame (the resampling decision only involves UPDATED particles, so
     it is independent of the interleaved insertions and can run first);
  2. rank all candidates per voxel by the reference's deterministic sweep
     order (the 3x3-interleaved pixel sweep, semantic_dsp_map.h:777-800) and
     place the top (vacancy) candidates of each voxel into its vacant slots
     in first-vacant order — exactly the slots the serial loop would fill.

Implementation shape (ops/blocks.py cost model): one multi-operand sort of
the candidates by (target voxel, priority) — sorts are cheap, full-state
compaction and element gathers are not — then per-element scatters into a
*block-compacted staging buffer* (the active target blocks only), a dense
K x K merge inside the block working set, and whole-row write-back.  The
same insertion core serves newborn particles, rigid-moved particles of
dynamic objects (operations.h:321-362), and guessed/template births.

Stale slots count as vacant and are overwritten (isParticleVacant,
operations.h:810-816).
"""

from __future__ import annotations

from typing import NamedTuple

from functools import partial

import jax
import jax.numpy as jnp

from ..config import FilterParams, MapConfig, PARTICLE_OCC_INIT_WEIGHT
from ..state import (
    Particles,
    ScrollState,
    STATUS_INVALID,
    STATUS_REGULAR_BORN,
    STATUS_UPDATED,
    particles_vk,
    particles_vk_sized,
)
from . import codecs
from .blocks import (
    ActiveBlocks,
    block_layout,
    gather_rows_flat,
    group_rank,
    scatter_rows_flat,
)
from .projection import LabeledCloud


class Candidates(NamedTuple):
    """A batch of particles to insert (padding rows have valid=False)."""

    pos: jax.Array      # f32[N, 3] global frame
    weight: jax.Array   # f32[N]
    label: jax.Array    # i32[N]
    track: jax.Array    # i32[N]
    status: jax.Array   # i32[N]
    stamp: jax.Array    # i32[N]
    forget: jax.Array   # i32[N]
    priority: jax.Array # i32[N] smaller = inserted earlier
    valid: jax.Array    # bool[N]


# ---------------------------------------------------------------------------
# Per-voxel systematic resampling
# ---------------------------------------------------------------------------

def resample_slots(cfg: MapConfig, status, weight, target):
    """resampleParticlesInVoxel (semantic_dsp_map.h:1448-1519) on arrays of
    shape [..., K] with a target mask [...] — used both on the full [V, K]
    state and on block working sets.

    Only UPDATED particles participate (the reference checks status alone,
    without the staleness test).  A voxel resamples iff more than half its
    total slot count (including the time slot: trigger = 2^n >> 1,
    semantic_dsp_map.h:1463) is UPDATED:
      - if their weight sum < 0.01, all UPDATED particles are wiped
        (:1466-1481);
      - else the serial keep/delete walk with threshold steps of
        weight_sum/trigger is applied in slot order (:1483-1513); kept
        particles get the equalized weight.
    """
    K = cfg.slots_per_voxel
    trigger = (1 << cfg.max_particle_num_per_voxel_n) >> 1

    updated = status == STATUS_UPDATED
    # Sequential f32 accumulation in slot order, matching the reference's
    # ``weight_sum +=`` loop bit-for-bit.
    wsum = jnp.zeros(status.shape[:-1], jnp.float32)
    for k in range(K):
        wsum = wsum + jnp.where(updated[..., k], weight[..., k], 0.0)
    count = jnp.sum(updated.astype(jnp.int32), axis=-1)

    do_resample = target & (count > trigger)
    wipe = do_resample & (wsum < 0.01)
    walk = do_resample & ~wipe

    wpp = jnp.minimum(wsum / trigger, 1.0)

    new_status = []
    new_weight = []
    csum = jnp.zeros(status.shape[:-1], jnp.float32)
    thresh = wpp
    for k in range(K):
        upd_k = updated[..., k]
        w_k = weight[..., k]
        csum_k = csum + jnp.where(upd_k, w_k, 0.0)
        delete = csum_k < thresh
        # Kept particle: weight -> wpp; the threshold advances by repeated
        # f32 additions of wpp until it is >= csum, reproducing the
        # reference's inner while loop exactly (semantic_dsp_map.h:1505-1510).
        thresh_kept = thresh + wpp
        for _ in range(K + 8):
            thresh_kept = jnp.where(csum_k > thresh_kept, thresh_kept + wpp, thresh_kept)
        active = walk & upd_k
        new_status.append(
            jnp.where((wipe & upd_k) | (active & delete), STATUS_INVALID, status[..., k])
        )
        new_weight.append(jnp.where(active & ~delete, wpp, w_k))
        csum = jnp.where(walk & upd_k, csum_k, csum)
        thresh = jnp.where(active & ~delete, thresh_kept, thresh)

    return jnp.stack(new_status, axis=-1), jnp.stack(new_weight, axis=-1)


@partial(jax.jit, static_argnums=0)
def resample_voxels(cfg: MapConfig, particles: Particles, target: jax.Array) -> Particles:
    """Full-state resampling wrapper (tests/diagnostics)."""
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    status, weight = resample_slots(
        cfg, particles.status.reshape(V, K), particles.weight.reshape(V, K), target
    )
    return particles.replace(status=status.reshape(-1), weight=weight.reshape(-1))


# ---------------------------------------------------------------------------
# Capacity-constrained batched insertion (block-staged)
# ---------------------------------------------------------------------------

class InsertResult(NamedTuple):
    particles: Particles
    accepted_count: jax.Array   # i32 scalar
    accepted_staged: jax.Array  # bool[A, spb] staged-candidate acceptance
    staged_src: jax.Array       # i32[A, spb] original candidate index (or N);
                                # None unless need_src
    block_overflow: jax.Array   # i32 scalar


def _insert_core(
    cfg: MapConfig,
    particles: Particles,
    scroll: ScrollState,
    cand: Candidates,
    resample_targets: bool,
    need_src: bool = True,
    uniform_weight=None,
    uniform_stamp=None,
    vox=None,
    valid=None,
    vox_axis=None,
    max_target_blocks=None,
) -> InsertResult:
    """Sort candidates by (voxel, priority), stage the first K per voxel into
    the active target blocks, optionally resample the targeted voxels, then
    merge staged candidates into first-vacant slots and write rows back.

    Works on a voxel SLAB as well as the full grid: sizes derive from the
    particle arrays, and callers may pass precomputed (vox, valid, vox_axis)
    in slab-local voxel ids (parallel/shard_step.py does; the full-grid
    wrappers below leave them None and they are derived from ``scroll``)."""
    K = cfg.slots_per_voxel
    N = cand.pos.shape[0]
    V = particles.px.shape[0] // K
    bv, _nb_full, spb = block_layout(cfg)
    nb = V // bv
    A = min(max_target_blocks or cfg.max_birth_blocks, nb)
    bv_n = bv.bit_length() - 1

    flat = particles          # flat storage (linear layout)
    particles = particles_vk_sized(particles, V, K)

    if vox is None:
        vox, _, _, _, in_map = codecs.global_pos_to_voxel(cfg, scroll, cand.pos)
        valid = cand.valid & in_map
    if vox_axis is None:
        vox_axis = codecs.axis_stamps_per_voxel(cfg, scroll)
    vox = jnp.where(valid, vox, V)

    # Candidate fields may arrive in the narrow storage dtypes (u8/u16, e.g.
    # from the rigid-move gather); cast before the shifts.
    meta = (
        (jnp.clip(cand.forget.astype(jnp.int32), 0, 7) << 27)
        | (jnp.clip(cand.status.astype(jnp.int32), 0, 7) << 24)
        | ((cand.label.astype(jnp.int32) & 0xFF) << 16)
        | (cand.track.astype(jnp.int32) & 0xFFFF)
    )

    # One multi-operand sort orders candidates by (voxel, priority) and
    # carries every field along.  Payload operands are NOT free (each adds
    # a full per-pass data stream), so uniform fields (newborns share one
    # weight and one stamp) and unused fields are excluded up front.
    ops = [vox, cand.priority, cand.pos[:, 0], cand.pos[:, 1],
           cand.pos[:, 2], meta]
    if uniform_weight is None:
        ops.append(cand.weight)
    if uniform_stamp is None:
        ops.append(cand.stamp)
    if need_src:
        ops.append(jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1))
    sorted_ops = list(jax.lax.sort(tuple(ops), num_keys=2))
    sv, _pri, spx, spy, spz, smeta = sorted_ops[:6]
    pos6 = 6
    sw = sstamp = ssrc = None
    if uniform_weight is None:
        sw = sorted_ops[pos6]; pos6 += 1
    if uniform_stamp is None:
        sstamp = sorted_ops[pos6]; pos6 += 1
    if need_src:
        ssrc = sorted_ops[pos6]
    rank = group_rank(sv)
    stage_ok = (sv < V) & (rank < K)

    # Active target blocks, listed from the sorted stream (ascending, unique).
    sblock = sv >> bv_n
    new_block = jnp.concatenate([jnp.ones(1, bool), sblock[1:] != sblock[:-1]])
    new_block &= sv < V
    block_rank = jnp.cumsum(new_block.astype(jnp.int32)) - 1
    n_blocks = jnp.maximum(block_rank[-1] + 1, 0)
    # Pad ids are nb+row (unique, out of range); see blocks.select_blocks.
    ids = (nb + jax.lax.broadcasted_iota(jnp.int32, (A, 1), 0).squeeze(-1)).at[
        jnp.where(new_block & (block_rank < A), block_rank, A)
    ].set(jnp.minimum(sblock, nb - 1), mode="drop")
    blocks = ActiveBlocks(
        ids=ids, count=jnp.minimum(n_blocks, A), overflow=jnp.maximum(n_blocks - A, 0)
    )

    # Stage the first K candidates of each voxel at
    # (block_rank, voxel-within-block, rank) — unique destinations.
    dest_ok = stage_ok & (block_rank < A)
    iota_n = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
    dest = jnp.where(
        dest_ok,
        block_rank * spb + (sv & (bv - 1)) * K + rank,
        A * spb + iota_n,  # unique out-of-range pads (duplicates are UB)
    )

    def stage(fill, vals, dtype):
        return (
            jnp.full(A * spb, fill, dtype)
            .at[dest]
            .set(vals.astype(dtype), mode="drop", unique_indices=True)
            .reshape(A, spb)
        )

    in_px = stage(0.0, spx, jnp.float32)
    in_py = stage(0.0, spy, jnp.float32)
    in_pz = stage(0.0, spz, jnp.float32)
    in_meta = stage(-1, smeta, jnp.int32)
    occupied_stage = in_meta >= 0
    if uniform_weight is None:
        in_w = stage(0.0, sw, jnp.float32)
    else:
        in_w = jnp.where(occupied_stage, jnp.float32(uniform_weight), 0.0)
    if uniform_stamp is None:
        in_stamp = stage(0, sstamp, jnp.int32)
    else:
        in_stamp = jnp.where(occupied_stage, uniform_stamp, 0)
    staged_src = stage(N, ssrc, jnp.int32) if need_src else None

    # ---- working set of the target blocks (flat sliced gathers) ----
    g = lambda f: gather_rows_flat(f, blocks, bv * K)
    bpx, bpy, bpz = g(flat.px), g(flat.py), g(flat.pz)
    bw = g(flat.weight)
    blab = g(flat.label).astype(jnp.int32)
    btrk = g(flat.track).astype(jnp.int32)
    bst = g(flat.status).astype(jnp.int32)
    bstamp = g(flat.stamp).astype(jnp.int32)
    bfg = g(flat.forget).astype(jnp.int32)

    baxis = jnp.repeat(gather_rows_flat(vox_axis, blocks, bv), K, axis=1)
    # Stale slots count as vacant (operations.h:810-816); also prune them so
    # downstream status checks (e.g. resampling) cannot see stale UPDATED
    # particles, matching the reference's prune-on-visit.
    stale = (bst != STATUS_INVALID) & (bstamp < baxis)
    bst = jnp.where(stale, STATUS_INVALID, bst)
    alive = bst != STATUS_INVALID

    if resample_targets:
        K3 = (blocks.ids.shape[0], bv, K)
        targeted = jnp.any((in_meta >= 0).reshape(K3), axis=2)
        rst, rw = resample_slots(
            cfg, bst.reshape(K3), bw.reshape(K3), targeted
        )
        bst = rst.reshape(bst.shape)
        bw = rw.reshape(bw.shape)
        alive = bst != STATUS_INVALID

    # ---- first-vacant merge: vacant slot with vacant-rank r takes staged
    # candidate r of its voxel.  All ops stay on the 2-D [A, spb] layout —
    # the earlier [A, bv, K] formulation put the size-K axis on the 128-lane
    # dimension and cost ~100 ms/frame in relayouts (round-3 bisection).
    a_rows = blocks.ids.shape[0]

    def lane_shift(x, s):
        """out[:, j] = x[:, j - s]; pad values are never selected (shifts
        only ever read within the same voxel's K lanes)."""
        if s == 0:
            return x
        pad = jnp.zeros((a_rows, abs(s)), x.dtype)
        if s > 0:
            return jnp.concatenate([pad, x[:, : spb - s]], axis=1)
        return jnp.concatenate([x[:, -s:], pad], axis=1)

    d_lane = jax.lax.broadcasted_iota(jnp.int32, (a_rows, spb), 1) % K
    vac = ~alive
    vc = vac.astype(jnp.int32)
    run = vc
    for o in range(1, K):
        run = run + jnp.where(d_lane >= o, lane_shift(vc, o), 0)
    vrank = run - 1  # vacant-rank of lane j within its voxel (where vac)

    # A vacant lane at in-voxel slot dd with vacant-rank c takes staged
    # candidate c of its voxel, i.e. the value shifted by s = dd - c; since
    # the vacant-rank counts vacancies at slots <= dd, c <= dd always, so
    # only the K non-negative shifts are reachable — one hit mask per shift
    # (the round-<=4 K x K (dd, c) enumeration built 49 masks of which 42
    # were identically false).
    shifts = {s: {} for s in range(K)}
    staged = dict(px=in_px, py=in_py, pz=in_pz, w=in_w, stamp=in_stamp, meta=in_meta)
    shift_sel = d_lane - vrank  # the one shift each vacant lane can take
    hits = []  # (hit mask, shift) per shift
    for s in range(K):
        shifts[s]["meta"] = lane_shift(in_meta, s)
        hit = vac & (shift_sel == s) & (shifts[s]["meta"] >= 0)
        hits.append((hit, s))

    took = jnp.zeros((a_rows, spb), bool)
    for hit, _ in hits:
        took = took | hit

    def merge(field_name):
        sel = jnp.zeros((a_rows, spb), staged[field_name].dtype)
        for hit, s in hits:
            if field_name not in shifts[s]:
                shifts[s][field_name] = lane_shift(staged[field_name], s)
            sel = jnp.where(hit, shifts[s][field_name], sel)
        return sel

    m_px, m_py, m_pz = merge("px"), merge("py"), merge("pz")
    m_w, m_stamp, m_meta = merge("w"), merge("stamp"), merge("meta")

    n_px = jnp.where(took, m_px, bpx)
    n_py = jnp.where(took, m_py, bpy)
    n_pz = jnp.where(took, m_pz, bpz)
    n_w = jnp.where(took, m_w, bw)
    n_stamp = jnp.where(took, m_stamp, bstamp)
    n_trk = jnp.where(took, m_meta & 0xFFFF, btrk)
    n_lab = jnp.where(took, (m_meta >> 16) & 0xFF, blab)
    n_st = jnp.where(took, (m_meta >> 24) & 0x7, bst)
    n_fg = jnp.where(took, (m_meta >> 27) & 0x7, bfg)

    sc = lambda f, v: scatter_rows_flat(f, blocks, bv * K, v)
    new = flat.replace(
        px=sc(flat.px, n_px),
        py=sc(flat.py, n_py),
        pz=sc(flat.pz, n_pz),
        weight=sc(flat.weight, n_w),
        label=sc(flat.label, n_lab),
        track=sc(flat.track, n_trk),
        status=sc(flat.status, n_st),
        stamp=sc(flat.stamp, n_stamp),
        forget=sc(flat.forget, n_fg),
    )

    # Staged candidate r (= its lane's slot index) is accepted iff
    # r < the voxel's vacancy count (run at the voxel's last lane).
    vcount = jnp.zeros((a_rows, spb), jnp.int32)
    for dd in range(K):
        vcount = jnp.where(
            d_lane == dd, lane_shift(run, -(K - 1 - dd)), vcount
        )
    accepted_staged = (in_meta >= 0) & (d_lane < vcount)
    accepted_count = jnp.sum(accepted_staged.astype(jnp.int32))

    return InsertResult(
        particles=new,
        accepted_count=accepted_count,
        accepted_staged=accepted_staged,
        staged_src=staged_src,
        block_overflow=blocks.overflow,
    )


@partial(jax.jit, static_argnums=0)
def insert_particles(
    cfg: MapConfig,
    particles: Particles,
    scroll: ScrollState,
    cand: Candidates,
):
    """Insert candidates into first-vacant slots of their target voxels.

    Returns (particles', accepted bool[N], target_voxel i32[N]).  The
    per-candidate ``accepted`` mask costs an extra scatter; the production
    frame path uses :func:`insert_with_resample`, which only needs the count.
    """
    res = _insert_core(cfg, particles, scroll, cand, resample_targets=False)
    N = cand.pos.shape[0]
    accepted = (
        jnp.zeros(N, bool)
        .at[res.staged_src.reshape(-1)]
        .set(res.accepted_staged.reshape(-1), mode="drop")
    )
    vox, _, _, _, in_map = codecs.global_pos_to_voxel(cfg, scroll, cand.pos)
    vox = jnp.where(cand.valid & in_map, vox, cfg.num_voxels)
    return res.particles, accepted, vox


def insert_with_resample(
    cfg: MapConfig,
    particles: Particles,
    scroll: ScrollState,
    cand: Candidates,
    uniform_weight=None,
    uniform_stamp=None,
):
    """Production insertion: resample targeted voxels first, then insert.

    Returns (particles', accepted_count, block_overflow)."""
    res = _insert_core(
        cfg, particles, scroll, cand, resample_targets=True,
        need_src=False, uniform_weight=uniform_weight,
        uniform_stamp=uniform_stamp,
    )
    return res.particles, res.accepted_count, res.block_overflow


# ---------------------------------------------------------------------------
# Newborn candidates from the labeled cloud
# ---------------------------------------------------------------------------

def newborn_candidates(
    cfg: MapConfig,
    params: FilterParams,
    cloud: LabeledCloud,
    global_time,
    rng: jax.Array,
) -> Candidates:
    """Build the per-frame newborn candidate batch.

    One candidate per valid pixel (no-noise path, semantic_dsp_map.h:1148-1171)
    or nb_ptc_num_per_point jittered copies (noise path, :1177-1230; zero
    noise when nb == 1, :1183-1188).  Priority encodes the reference's
    3x3-interleaved sweep order (semantic_dsp_map.h:777-800).
    """
    H, W = cfg.height, cfg.width
    nb = params.nb_ptc_num_per_point if params.if_consider_depth_noise else 1

    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    phase = (rows % 3) * 3 + cols % 3
    pixel_pri = (phase * H + rows) * W + cols

    pos = cloud.pos.reshape(-1, 3)
    valid = cloud.valid.reshape(-1)
    label = cloud.label.reshape(-1)
    track = cloud.track.reshape(-1)
    sigma = cloud.sigma.reshape(-1)
    pri = pixel_pri.reshape(-1)

    if nb > 1:
        pos = jnp.repeat(pos, nb, axis=0)
        valid = jnp.repeat(valid, nb)
        label = jnp.repeat(label, nb)
        track = jnp.repeat(track, nb)
        sigma = jnp.repeat(sigma, nb)
        pri = jnp.repeat(pri, nb) * nb + jnp.tile(
            jnp.arange(nb, dtype=jnp.int32), H * W
        )
        noise = jax.random.normal(rng, pos.shape, jnp.float32) * sigma[:, None]
        pos = pos + noise
    elif params.if_consider_depth_noise:
        pri = pri * nb

    n = pos.shape[0]
    return Candidates(
        pos=pos,
        weight=jnp.full(n, PARTICLE_OCC_INIT_WEIGHT, jnp.float32),
        label=label,
        track=track,
        status=jnp.full(n, STATUS_REGULAR_BORN, jnp.int32),
        stamp=jnp.full(n, global_time, jnp.int32),
        forget=jnp.zeros(n, jnp.int32),
        priority=pri,
        valid=valid,
    )


def birth_and_resample(
    cfg: MapConfig,
    params: FilterParams,
    particles: Particles,
    scroll: ScrollState,
    cloud: LabeledCloud,
    global_time,
    rng: jax.Array,
):
    """Resample birth-target voxels, then insert newborn particles.

    Returns (particles', born_count, block_overflow, candidates).
    """
    cand = newborn_candidates(cfg, params, cloud, global_time, rng)
    # Newborns share one weight and one stamp — passing them as uniforms
    # drops two sort payloads and two N-sized staging scatters.
    particles, born, overflow = insert_with_resample(
        cfg, particles, scroll, cand,
        uniform_weight=PARTICLE_OCC_INIT_WEIGHT,
        uniform_stamp=global_time,
    )
    return particles, born, overflow, cand
