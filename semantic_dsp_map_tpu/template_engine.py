"""Template-matching frame stages (flag ``if_use_template_matching``).

Implements the two template paths of the reference frame kernel:

  1. **Rematch** (semantic_dsp_map.h:616-669): objects flagged
     ``to_match_with_previous`` get their particles re-aligned to the observed
     object cloud (alignPointCloudToSource = center + non-FS PHD sweep); on a
     good match the old particles are deleted and the aligned cloud re-added
     at weight 0.2 (operations.h:125-146).  Runs in the PREDICTION phase
     (between scroll/expiry and the rigid moves), so re-matched particles
     participate in the PHD update the same frame — the reference's order.
  2. **Template birth** (semantic_dsp_map.h:806-894): newly-observed Cars with
     1500..8000 observed points and a >=1 m bbox are matched against the CAD
     template bank (FS-considered sweep, best template wins); on a good match,
     3 noise-jittered GUESSED_BORN particles are added per template point.
     Runs after regular birth and before render.

Both stages are FULLY JITTED and inlined into the frame step
(map.build_frame_step(template_stages=...)).  Orchestrating them host-side
would cost one device->host gate sync per frame plus two more per eligible
object.  Here the data-dependent "which objects have work" decision becomes
a fixed number of per-slot ``lax.cond`` branches (XLA conditionals execute
only the taken branch, so idle slots cost nothing), and the state mutations
are masked-unconditional:

  - the per-slot sweep branches return only SMALL outputs (aligned cloud,
    validity, a do-flag) — the particle state never threads through a
    conditional (a state-carrying lax.cond forces XLA to copy the whole
    58.7M-slot state through the branch, map.py);
  - deletes are one masked status pass, inserts are one fixed-capacity
    _insert_core call per stage with every slot's candidates concatenated.

Capacity bound (documented deviation): at most ``RM_MAX`` rematches and
``TB_MAX`` template births execute per frame (the reference loops over all
eligible objects).  Eligibility beyond the cap is deferred: ``to_match_*``
flags stay set, so the object retries next frame.  Realistic frames have
0-1 eligible objects.

Randomness deviation (documented): guessed-birth jitter uses ``jax.random``
normals instead of the reference's precomputed 1M-entry preset-sigma table
(basic_algorithms.h:384-461) — same distribution, different stream.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .config import FilterParams, MapConfig, PARTICLE_OCC_INIT_WEIGHT
from .labels import LabelRegistry
from .ops import codecs
from .ops.birth import Candidates, _insert_core
from .ops.templates import (
    GUESSED_BIRTH_COPIES,
    GUESSED_BIRTH_NOISE,
    MATCHED_WEIGHT,
    MatchGridConfig,
    TM_MIN_BBOX_XY,
    TM_MIN_POINTS,
    TM_MAX_POINTS,
    REMATCH_MIN_POINTS,
    TemplateBank,
    template_match,
    template_match_bank,
)
from .state import STATUS_GUESSED_BORN, STATUS_INVALID

#: Per-frame slot capacities (see module docstring).
RM_MAX = 2
TB_MAX = 1

#: Target-block capacity of each stage's single insert call: an aligned car
#: at 0.15 m voxels covers ~60-120 of the 64-voxel storage blocks; overflow
#: is surfaced via the step's birth_overflow counter.
TM_INSERT_BLOCKS = 256


def template_gate(car_label: int, objects, cloud) -> jax.Array:
    """The i32[O, 8] eligibility array, computed on device once per frame.

    Columns: [valid, rematch_ok, birth_ok, track_id, label,
    cloud_point_count, bbox_extent_x_mm, bbox_extent_y_mm].  The count is the
    UNCAPPED per-track cloud count (the reference's points_num size gate,
    semantic_dsp_map.h:815, tests the full observed count); the mm columns
    are the getBoundingBox x/y extents (semantic_dsp_map.h:1388-1412)."""
    O = objects.valid.shape[0]
    flat_trk = cloud.track.reshape(-1)
    flat_ok = cloud.valid.reshape(-1)
    flat_x = cloud.pos[..., 0].reshape(-1)
    flat_y = cloud.pos[..., 1].reshape(-1)
    big = jnp.float32(3.4e38)

    def body(o, carry):
        c, ex, ey = carry
        m = (flat_trk == objects.track_id[o]) & flat_ok
        n = jnp.sum(m.astype(jnp.int32))
        mx = jnp.where(m, flat_x, big)
        my = jnp.where(m, flat_y, big)
        sx = jnp.max(jnp.where(m, flat_x, -big)) - jnp.min(mx)
        sy = jnp.max(jnp.where(m, flat_y, -big)) - jnp.min(my)
        ok = objects.valid[o] & (n > 0)
        return (
            c.at[o].set(jnp.where(objects.valid[o], n, 0)),
            ex.at[o].set(jnp.where(ok, sx, 0.0)),
            ey.at[o].set(jnp.where(ok, sy, 0.0)),
        )

    cnt, ext_x, ext_y = jax.lax.fori_loop(
        0, O, body,
        (jnp.zeros(O, jnp.int32), jnp.zeros(O, jnp.float32),
         jnp.zeros(O, jnp.float32)),
    )
    rem = (
        objects.valid & objects.to_match_previous & objects.moving
        & objects.has_moved_record
    )
    tb = (
        objects.valid & objects.to_match_templates
        & (objects.label == car_label)
    )
    return jnp.stack(
        [
            objects.valid.astype(jnp.int32),
            rem.astype(jnp.int32),
            tb.astype(jnp.int32),
            objects.track_id,
            objects.label,
            cnt,
            (ext_x * 1000.0).astype(jnp.int32),
            (ext_y * 1000.0).astype(jnp.int32),
        ],
        axis=1,
    )


def _top_rows(mask: jax.Array, cap: int):
    """Indices of the first ``cap`` True rows (ascending object index, the
    reference's iteration order) plus a validity mask."""
    O = mask.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (O, 1), 0).squeeze(-1)
    key = jnp.where(mask, iota, O + iota)
    srt = jnp.sort(key)[:cap]
    valid = srt < O
    return jnp.where(valid, srt, 0), valid


def _compact_by_sort(mask_flat, xs, ys, zs, n_max: int):
    """Stable compaction of masked points into a fixed buffer via one
    multi-operand sort (the ops/blocks.py pattern: never jnp.nonzero on a
    big domain).  Selected points keep ascending source order."""
    key = (~mask_flat).astype(jnp.int32)
    ks, sx, sy, sz = jax.lax.sort((key, xs, ys, zs), num_keys=1)
    ok = ks[:n_max] == 0
    pts = jnp.stack([sx[:n_max], sy[:n_max], sz[:n_max]], axis=-1)
    return jnp.where(ok[:, None], pts, 0.0), ok


def _extract_track_points(n_max: int, cloud, tid):
    """Compact the labeled-cloud points of one track id into a fixed buffer.

    The reference gathers mask pixels without checking point validity
    (semantic_dsp_map.h:625-638 takes every mask pixel's labeled point);
    we keep only valid points — strictly less noise fed to the matcher."""
    m = ((cloud.track == tid) & cloud.valid).reshape(-1)
    pts, ok = _compact_by_sort(
        m,
        cloud.pos[..., 0].reshape(-1),
        cloud.pos[..., 1].reshape(-1),
        cloud.pos[..., 2].reshape(-1),
        n_max,
    )
    return pts, ok


def _extract_particle_points(cfg: MapConfig, n_max: int, particles, scroll,
                             tid, weight_threshold):
    """getParticlesAsPointCloud (operations.h:242-255) for one track id:
    alive particles with weight > threshold, block-compacted (never a
    jnp.nonzero over [V, K], ops/blocks.py)."""
    from .ops.blocks import (
        block_layout, gather_rows_flat, mask_to_block_mask, row_valid,
        select_blocks,
    )
    from .state import particles_vk

    flat = particles
    p = particles_vk(cfg, flat)
    vox_axis = codecs.axis_stamps_per_voxel(cfg, scroll)
    alive = codecs.particle_alive(p.status, p.stamp, vox_axis)
    m = alive & (p.track == tid) & (p.weight > weight_threshold)

    bv, nb, spb = block_layout(cfg)
    A = min(cfg.max_moving_blocks, nb)
    K = cfg.slots_per_voxel
    blocks = select_blocks(mask_to_block_mask(m, bv), A)
    rv = row_valid(blocks)
    bm = (gather_rows_flat(m.reshape(-1), blocks, bv * K) & rv[:, None]).reshape(-1)
    bx = gather_rows_flat(flat.px, blocks, bv * K).reshape(-1)
    by = gather_rows_flat(flat.py, blocks, bv * K).reshape(-1)
    bz = gather_rows_flat(flat.pz, blocks, bv * K).reshape(-1)
    pts, ok = _compact_by_sort(bm, bx, by, bz, min(n_max, A * spb))
    if pts.shape[0] < n_max:
        pad = n_max - pts.shape[0]
        pts = jnp.pad(pts, ((0, pad), (0, 0)))
        ok = jnp.pad(ok, (0, pad))
    return pts, ok, jnp.sum(m.astype(jnp.int32))


def _masked_center(ppts, pok):
    """alignPointCloudToXYZCenter (pointcloud_tools.h:365-380) under a mask."""
    big = jnp.float32(3.4e38)
    lo = jnp.min(jnp.where(pok[:, None], ppts, big), axis=0)
    hi = jnp.max(jnp.where(pok[:, None], ppts, -big), axis=0)
    c = (lo + hi) * 0.5
    return jnp.where(pok[:, None], ppts - c, 0.0)


class TemplateStages(NamedTuple):
    """Jittable closures built once per (config, params, bank)."""

    gate: object      # (objects, cloud) -> i32[O, 8]
    rematch: object   # (particles, scroll, cloud, cam_pos, gate, gt) -> (particles, overflow)
    birth: object     # (particles, scroll, objects, cloud, cam_pos, gate, gt, rng)
                      #   -> (particles, objects, overflow)


def build_template_stages(
    cfg: MapConfig,
    params: FilterParams,
    registry: LabelRegistry,
    grid: MatchGridConfig,
    bank: Optional[TemplateBank],
) -> TemplateStages:
    """Build the fused per-frame template stages (see module docstring)."""
    car_label = registry.label_to_id.get("Car", -1)
    thr = jnp.float32(params.match_score_threshold)
    Pt = grid.max_template_points

    if bank is not None:
        tpls_np, tvalids_np = bank.of_label(car_label)
        have_bank = tpls_np.shape[0] > 0
    else:
        have_bank = False
    if have_bank:
        tpls = jnp.asarray(tpls_np)
        tvalids = jnp.asarray(tvalids_np)

    def gate_fn(objects, cloud):
        return template_gate(car_label, objects, cloud)

    # ------------------------------------------------------------------
    def rematch(particles, scroll, cloud, cam_pos, gate, gt):
        rows, rvalid = _top_rows(gate[:, 1] == 1, RM_MAX)

        outs = []
        for i in range(RM_MAX):
            row = rows[i]
            tid = gate[row, 3]
            eligible = rvalid[i] & (gate[row, 5] >= REMATCH_MIN_POINTS)

            def do_match(_):
                pts, ok = _extract_track_points(grid.max_source_points, cloud, tid)
                ppts, pok, pcount = _extract_particle_points(
                    cfg, Pt, particles, scroll, tid, jnp.float32(0.1)
                )
                ppts_c = _masked_center(ppts, pok)
                res = template_match(
                    grid, False, pts, ok, cam_pos, ppts_c, pok
                )
                good = (res.score > thr) & (pcount > 0)
                return res.aligned, pok, good

            def no_match(_):
                return (
                    jnp.zeros((Pt, 3), jnp.float32),
                    jnp.zeros(Pt, bool),
                    jnp.array(False),
                )

            aligned, pok, good = jax.lax.cond(eligible, do_match, no_match, 0)
            outs.append((aligned, pok, good, tid, gate[row, 4]))

        # deleteParticlesInSet for matched objects (one masked pass).
        trk = particles.track.astype(jnp.int32)
        del_mask = jnp.zeros(trk.shape, bool)
        for aligned, pok, good, tid, _lab in outs:
            del_mask = del_mask | (good & (trk == tid))
        particles = particles.replace(
            status=jnp.where(
                del_mask,
                jnp.asarray(STATUS_INVALID, particles.status.dtype),
                particles.status,
            )
        )

        # One fixed-capacity insert of every slot's aligned cloud.
        n = RM_MAX * Pt
        pos = jnp.concatenate([o[0] for o in outs], axis=0)
        valid = jnp.concatenate([o[1] & o[2] for o in outs])
        track = jnp.concatenate(
            [jnp.full(Pt, 1, jnp.int32) * o[3] for o in outs]
        )
        label = jnp.concatenate(
            [jnp.full(Pt, 1, jnp.int32) * o[4] for o in outs]
        )
        cand = Candidates(
            pos=pos,
            weight=jnp.full(n, MATCHED_WEIGHT, jnp.float32),
            label=label,
            track=track,
            status=jnp.full(n, STATUS_GUESSED_BORN, jnp.int32),
            stamp=jnp.full(n, 1, jnp.int32) * gt,
            forget=jnp.zeros(n, jnp.int32),
            priority=jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1),
            valid=valid,
        )
        res = _insert_core(
            cfg, particles, scroll, cand, resample_targets=False,
            need_src=False, max_target_blocks=TM_INSERT_BLOCKS,
        )
        return res.particles, res.block_overflow

    # ------------------------------------------------------------------
    def birth(particles, scroll, objects, cloud, cam_pos, gate, gt, rng):
        if not have_bank:
            return particles, objects, jnp.int32(0)
        rows, rvalid = _top_rows(gate[:, 2] == 1, TB_MAX)

        outs = []
        new_flags = objects.to_match_templates
        for i in range(TB_MAX):
            row = rows[i]
            tid = gate[row, 3]
            n_pts = gate[row, 5]
            attempted = (
                rvalid[i]
                & (n_pts > TM_MIN_POINTS) & (n_pts < TM_MAX_POINTS)
                & (gate[row, 6] >= int(TM_MIN_BBOX_XY * 1000))
                & (gate[row, 7] >= int(TM_MIN_BBOX_XY * 1000))
            )

            def do_match(_):
                pts, ok = _extract_track_points(grid.max_source_points, cloud, tid)
                best_idx, best_score, aligned = template_match_bank(
                    grid, True, pts, ok, cam_pos, tpls, tvalids
                )
                return aligned, tvalids[best_idx], best_score

            def no_match(_):
                return (
                    jnp.zeros((Pt, 3), jnp.float32),
                    jnp.zeros(Pt, bool),
                    jnp.float32(-1.0),
                )

            aligned, best_ok, score = jax.lax.cond(attempted, do_match, no_match, 0)
            good = attempted & (score >= thr)
            # Flag bookkeeping (semantic_dsp_map.h:842, :873-875): attempted
            # rows match once; a below-threshold score retries next frame.
            new_flags = new_flags.at[row].set(
                jnp.where(attempted, score < thr, new_flags[row])
            )
            outs.append((aligned, best_ok, good, tid, gate[row, 4]))

        # 3 jittered GUESSED_BORN copies per template point
        # (semantic_dsp_map.h:878-891).
        reps = jnp.concatenate(
            [jnp.repeat(o[0], GUESSED_BIRTH_COPIES, axis=0) for o in outs],
            axis=0,
        )
        noise = jax.random.normal(rng, reps.shape, jnp.float32) * GUESSED_BIRTH_NOISE
        reps = reps + noise
        n = TB_MAX * Pt * GUESSED_BIRTH_COPIES
        valid = jnp.concatenate(
            [jnp.repeat(o[1] & o[2], GUESSED_BIRTH_COPIES) for o in outs]
        )
        track = jnp.concatenate(
            [jnp.full(Pt * GUESSED_BIRTH_COPIES, 1, jnp.int32) * o[3] for o in outs]
        )
        label = jnp.concatenate(
            [jnp.full(Pt * GUESSED_BIRTH_COPIES, 1, jnp.int32) * o[4] for o in outs]
        )
        cand = Candidates(
            pos=reps,
            weight=jnp.full(n, PARTICLE_OCC_INIT_WEIGHT, jnp.float32),
            label=label,
            track=track,
            status=jnp.full(n, STATUS_GUESSED_BORN, jnp.int32),
            stamp=jnp.full(n, 1, jnp.int32) * gt,
            forget=jnp.zeros(n, jnp.int32),
            priority=jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1),
            valid=valid,
        )
        res = _insert_core(
            cfg, particles, scroll, cand, resample_targets=False,
            need_src=False, max_target_blocks=TM_INSERT_BLOCKS,
        )
        objects = objects.replace(to_match_templates=new_flags)
        return res.particles, objects, res.block_overflow

    return TemplateStages(gate=gate_fn, rematch=rematch, birth=birth)


class TemplateEngine:
    """Template-bank holder + build-time context for the fused stages.

    Rounds 3-4 orchestrated per-object matching from the host through this
    class; round 5 moved the whole path into the jitted frame step (module
    docstring).  The class remains as the bank/grid holder behind
    ``SemanticDSPMap.set_template_path`` and builds the fused stages on
    demand."""

    def __init__(
        self,
        cfg: MapConfig,
        params: FilterParams,
        registry: LabelRegistry,
        bank: Optional[TemplateBank] = None,
        grid: Optional[MatchGridConfig] = None,
    ):
        self.cfg = cfg
        self.params = params
        self.registry = registry
        self.grid = grid or MatchGridConfig()
        self.bank = bank

    def set_template_path(self, folder: str) -> int:
        """setTemplatePath (semantic_dsp_map.h:163-166)."""
        self.bank = TemplateBank.from_folder(folder, self.grid)
        return int(self.bank.label.size)

    def stages(self) -> TemplateStages:
        return build_template_stages(
            self.cfg, self.params, self.registry, self.grid, self.bank
        )
