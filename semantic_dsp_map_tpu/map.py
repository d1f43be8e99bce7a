"""The map engine: SemanticDSPMap.

Array-program re-design of the reference engine (include/semantic_dsp_map.h:21).
One frame is one jitted pure function over the :class:`MapState` pytree,
mirroring the reference's frame kernel ``update()``
(semantic_dsp_map.h:170-251) stage for stage:

  1. object-level update               (objectLevelUpdate, :306-566)
  2. labeled point cloud               (generateLabeledPointCloud)
  3. prediction: ego scroll, object expiry/cleanup, rigid particle moves
                                       (subObjectLevelUpdate, :579-737)
  4. visibility + PHD weight update    (updateVisibleParitlcesWithBFS, :749;
                                        updateParticles, :960-1121 — fused in
                                        ops/observe.py)
  5. birth + resampling                (:768-801, 1148-1230, 1448-1519)
  6. occupancy render                  (getOccupancyResult, :1239-1383)

Every capacity cap in the pipeline is surfaced in :class:`StepDiagnostics`;
nothing is silently truncated.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import FilterParams, KEYPOINTS_BBOX3D, MapConfig
from .frontend import (
    FrameInput,
    MaskKpts,
    build_frame_input,
    pack_frame,
    static_label_table,
)
from .labels import LabelRegistry
from .objects import (
    ObservedInstances,
    expire_objects,
    object_level_update,
)
from .ops import codecs
from .ops.birth import Candidates, birth_and_resample, _insert_core
from .ops.blocks import (
    block_layout,
    gather_rows_flat,
    mask_to_block_mask,
    row_valid,
    scatter_rows_flat,
    select_blocks,
)
from .ops.geometry import camera_matrices
from .ops.observe import observe_and_update
from .ops.projection import generate_labeled_cloud
from .ops.render import RenderResult, render_occupancy, render_occupancy_smoothed
from .state import (
    MapState,
    Particles,
    STATUS_INVALID,
    clear_map_state,
    init_map_state,
    particles_vk,
)


class StepDiagnostics(NamedTuple):
    """Per-frame counters.  The *_overflow fields expose every static
    capacity cap: nonzero means work was
    deferred/dropped that frame and the corresponding config knob is too
    small for the scene."""

    visible_count: jax.Array     # particles in the pixel table this frame
    born_count: jax.Array        # accepted newborn particles
    moved_count: jax.Array       # rigid-moved particles re-inserted
    block_overflow: jax.Array    # observe: active blocks beyond capacity
    entry_overflow: jax.Array    # observe: entries beyond max_table_entries
    table_dropped: jax.Array     # observe: visible entries past S per pixel
    corner_overflow: jax.Array   # observe: empty-voxel blocks beyond capacity
    move_overflow: jax.Array     # move: blocks beyond max_moving_blocks
    birth_overflow: jax.Array    # birth: target blocks beyond capacity


def _move_and_cleanup(
    cfg: MapConfig,
    params: FilterParams,
    particles: Particles,
    scroll,
    objects,
    global_time,
    rng,
    max_movable: int,
):
    """Prediction-phase particle maintenance (semantic_dsp_map.h:587-737):

      - "floating" particles whose movable track id has no live object are
        invalidated (:712-737; also covers particles of just-expired objects,
        whose rows were removed by expire_objects — the reference invalidates
        them via removeObjectByTrackID, object_layer.h:414-425);
      - particles of moving objects are rigidly transformed by the object's
        current/predicted transform with preset-sigma Gaussian jitter, then
        re-inserted in one batch (:672-693; operations.h:321-362).

    All heavy work runs on block working sets; when no object is moving the
    whole move branch is skipped by a real conditional.
    """
    K = cfg.slots_per_voxel
    bv, nb, spb = block_layout(cfg)
    A = min(cfg.max_moving_blocks, nb)
    O = objects.valid.shape[0]

    flat = particles          # flat storage (linear layout)
    particles = particles_vk(cfg, particles)  # [V, K] views

    vox_axis = codecs.axis_stamps_per_voxel(cfg, scroll)

    mv_obj = objects.valid & objects.has_moved_record & objects.moving & objects.has_tmatrix
    if params.if_use_template_matching:
        # Objects flagged for cloud re-matching skip the rigid move; the
        # matching path re-seeds their particles separately
        # (semantic_dsp_map.h:616-669).
        mv_obj = mv_obj & ~objects.to_match_previous

    # Ownership / moving only matter for particles carrying a MOVABLE track
    # id — a tiny subset of the state — so the object-id comparisons run on
    # a block working set, not the full [V, K] domain (a dense [V, K, 8]
    # broadcast cost ~160 ms/frame at VKITTI2 scale, round-3 bisection).
    alive = codecs.particle_alive(particles.status, particles.stamp, vox_axis)
    track = particles.track
    movable_p = alive & (track >= 0) & (track <= max_movable)
    block_mask = mask_to_block_mask(movable_p, bv)

    blocks = select_blocks(block_mask, A)
    rv = row_valid(blocks)
    # Flat sliced gathers (ops/blocks.py): only the working set's rows move.
    g = lambda f: gather_rows_flat(f, blocks, bv * K)
    btrk = g(flat.track).astype(jnp.int32)
    bst = g(flat.status).astype(jnp.int32)
    bstamp = g(flat.stamp).astype(jnp.int32)
    baxis = jnp.repeat(gather_rows_flat(vox_axis, blocks, bv), K, axis=1)
    balive = (bst != STATUS_INVALID) & (bstamp >= baxis)
    bmovable = balive & (btrk >= 0) & (btrk <= max_movable) & rv[:, None]

    # Chunked object-id compare on the working set ([A, spb, 8] broadcast).
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

    # NOTE: this always runs, even when no object is moving.  A lax.cond
    # around it makes XLA copy the ENTIRE particle state through the
    # conditional every frame, while the unconditional math runs on the
    # small movable-block working set.
    if True:
        flat_p = flat
        bpx, bpy, bpz = g(flat_p.px), g(flat_p.py), g(flat_p.pz)
        bw = g(flat_p.weight)
        blab = g(flat_p.label).astype(jnp.int32)
        bst, bfg = bst_clean, g(flat_p.forget).astype(jnp.int32)

        # Apply each moving object's transform where the track matches —
        # a loop over the (tiny) object table, dense over the working set.
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
        noise = jax.random.normal(rng, (3,) + bpx.shape, jnp.float32) * params.prediction_stddev
        nx, ny, nz = nx + noise[0], ny + noise[1], nz + noise[2]

        # Delete the sources first (batched copy-delete-readd,
        # operations.h:321-362), then re-insert as candidates.
        bst_del = jnp.where(bmove, STATUS_INVALID, bst)
        flat_p = flat_p.replace(
            status=scatter_rows_flat(flat_p.status, blocks, bv * K, bst_del)
        )

        n = A * spb
        cand = Candidates(
            pos=jnp.stack([nx.reshape(-1), ny.reshape(-1), nz.reshape(-1)], axis=-1),
            weight=bw.reshape(-1),
            label=blab.reshape(-1),
            track=btrk.reshape(-1),
            status=bst.reshape(-1),
            stamp=bstamp.reshape(-1),
            forget=bfg.reshape(-1),
            priority=jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1),
            valid=bmove.reshape(-1),
        )
        res = _insert_core(
            cfg, flat_p, scroll, cand, resample_targets=False, need_src=False,
            max_target_blocks=2 * A,
        )
        out, moved, overflow = (
            res.particles, res.accepted_count, blocks.overflow + res.block_overflow
        )
    return out, moved, overflow


def unpack_frame(cfg: MapConfig, static_table: np.ndarray, buf) -> FrameInput:
    """Device-side decode of the packed frame buffer (frontend.pack_frame).

    Rebuilds the dense track->label and bbox-gate tables ON DEVICE from the
    per-instance arrays, so they never ride the host->device link (the dense
    tables alone are 1.8 MB/frame)."""
    H, W = cfg.height, cfg.width
    HW = H * W
    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
    f32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.float32)

    head = f32(buf[0:8])
    cam_pos, cam_quat, time = head[0:3], head[3:7], head[7]
    o = 8
    depth = f32(buf[o : o + HW]).reshape(H, W)
    o += HW
    nr = (HW + 1) // 2
    rp = buf[o : o + nr]
    o += nr
    lo = rp & 0xFFFF
    hi = (rp >> 16) & 0xFFFF
    raster = jnp.stack([lo, hi], axis=-1).reshape(-1)[:HW].reshape(H, W)

    inst_track = buf[o : o + I]; o += I
    inst_label = buf[o : o + I]; o += I
    kpts_count = buf[o : o + I]; o += I
    has_bbox = buf[o : o + I]; o += I
    bbox_min_i = f32(buf[o : o + 3 * I]).reshape(I, 3); o += 3 * I
    bbox_max_i = f32(buf[o : o + 3 * I]).reshape(I, 3); o += 3 * I
    kc = f32(buf[o : o + I * Kp * 3]).reshape(I, Kp, 3); o += I * Kp * 3
    kp = f32(buf[o : o + I * Kp * 3]).reshape(I, Kp, 3)

    valid = inst_track >= 0
    # label overlay: only valid instances with a known label write the table
    tid_l = jnp.where(valid & (inst_label >= 0) & (inst_track < 65536), inst_track, 65536)
    table = jnp.asarray(static_table).at[tid_l].set(
        jnp.maximum(inst_label, 0), mode="drop"
    )
    tid_b = jnp.where(valid & (has_bbox == 1) & (inst_track < 65536), inst_track, 65536)
    bbox_min = jnp.full((65536, 3), -jnp.inf, jnp.float32).at[tid_b].set(
        bbox_min_i, mode="drop"
    )
    bbox_max = jnp.full((65536, 3), jnp.inf, jnp.float32).at[tid_b].set(
        bbox_max_i, mode="drop"
    )

    return FrameInput(
        depth=depth,
        track_raster=raster,
        track_label_table=table,
        inst_valid=valid,
        inst_track=jnp.maximum(inst_track, 0),
        inst_label=inst_label,
        kpts_curr=kc,
        kpts_prev=kp,
        kpts_count=kpts_count,
        inst_bbox_min=bbox_min,
        inst_bbox_max=bbox_max,
        cam_pos=cam_pos,
        cam_quat=cam_quat,
        time=time,
    )


def build_frame_step(
    cfg: MapConfig,
    params: FilterParams,
    registry: LabelRegistry,
    split_render: bool = False,
    packed: bool = False,
    template_stages=None,
):
    """Returns the jitted per-frame update: (MapState, FrameInput) ->
    (MapState, RenderResult, StepDiagnostics).

    With ``split_render=True`` returns (core, render) jitted separately:
    core: (MapState, FrameInput) -> (MapState, LabeledCloud, StepDiagnostics)
    render: MapState -> (MapState, RenderResult).

    ``template_stages`` (a template_engine.TemplateStages) inlines the fused
    template-matching stages into the step: rematch in the prediction phase
    (semantic_dsp_map.h:616-669) and template birth between regular birth and
    render (:806-894) — fully jitted, no host orchestration (round-5
    redesign; the round-4 host-driven split cost a ~25 ms gate sync per
    frame, see template_engine docstring)."""

    max_movable = registry.max_movable_instance_id
    sky_instance = registry.static_label_to_instance.get(
        "Sky", registry.static_label_to_instance.get("sky", -1)
    )
    use_sky_cull = cfg.keypoint_mode == KEYPOINTS_BBOX3D  # ZED2-only, pointcloud_tools.h:234-241
    use_bbox_gate = cfg.keypoint_mode == KEYPOINTS_BBOX3D

    def core(state: MapState, f: FrameInput):
        gt = state.global_time + 1
        rng, k_obj, k_move, k_birth = jax.random.split(state.rng, 4)
        r_wc, t_wc, r_cw, t_cw = camera_matrices(f.cam_pos, f.cam_quat)

        # 1. Object layer (only with instances, semantic_dsp_map.h:189-191).
        objects = state.objects
        if cfg.consider_instance:
            obs = ObservedInstances(
                valid=f.inst_valid,
                track=f.inst_track,
                label=f.inst_label,
                kpts_curr=f.kpts_curr,
                kpts_prev=f.kpts_prev,
                kpts_count=f.kpts_count,
            )
            objects = object_level_update(
                cfg, params, objects, obs, f.cam_pos, r_cw, t_cw,
                f.time, state.prev_frame_time, gt, k_obj,
            )

        # 2. Labeled point cloud.
        cloud = generate_labeled_cloud(
            cfg, params, f.depth, f.track_raster, f.track_label_table,
            r_wc, t_wc, max_movable,
            sky_instance_id=sky_instance if use_sky_cull else -1,
            inst_bbox_min=f.inst_bbox_min if use_bbox_gate else None,
            inst_bbox_max=f.inst_bbox_max if use_bbox_gate else None,
        )

        # 3. Prediction: scroll, expiry, cleanup, rigid moves.
        scroll = codecs.update_ego_center(cfg, state.scroll, f.cam_pos, gt)
        objects, _expired = expire_objects(params, objects, gt)

        tmpl_overflow = jnp.int32(0)
        if template_stages is not None:
            rng, k_tpl = jax.random.split(rng)
            gate = template_stages.gate(objects, cloud)
            # Rematch in the prediction phase, BEFORE the rigid moves
            # (semantic_dsp_map.h:616-669; matched objects skip the move via
            # to_match_previous in _move_and_cleanup).
            particles, rm_ov = template_stages.rematch(
                state.particles, scroll, cloud, f.cam_pos, gate, gt
            )
            tmpl_overflow = tmpl_overflow + rm_ov
        else:
            particles = state.particles

        particles, moved, move_overflow = _move_and_cleanup(
            cfg, params, particles, scroll, objects, gt, k_move, max_movable
        )

        # 4+5. Visibility + PHD weight update (fused, ops/observe.py).
        particles, voxel_stamp, odiag = observe_and_update(
            cfg, params, particles, scroll, state.voxel_stamp,
            cloud, f.depth, r_cw, t_cw, gt,
        )

        # 6. Birth + resampling.
        particles, born, birth_overflow, _cand = birth_and_resample(
            cfg, params, particles, scroll, cloud, gt, k_birth
        )

        # 6b. Template birth (after birth, before render,
        # semantic_dsp_map.h:806-894).
        if template_stages is not None:
            particles, objects, tb_ov = template_stages.birth(
                particles, scroll, objects, cloud, f.cam_pos, gate, gt, k_tpl
            )
            tmpl_overflow = tmpl_overflow + tb_ov

        state = state.replace(
            particles=particles,
            voxel_stamp=voxel_stamp,
            scroll=scroll,
            objects=objects,
            global_time=gt,
            prev_frame_time=f.time,
            rng=rng,
        )

        diag = StepDiagnostics(
            visible_count=odiag.visible_count,
            born_count=born,
            moved_count=moved,
            block_overflow=odiag.block_overflow,
            entry_overflow=odiag.entry_overflow,
            table_dropped=odiag.table_dropped,
            corner_overflow=odiag.corner_overflow,
            move_overflow=move_overflow,
            # template-stage insert overflow rides the birth counter
            birth_overflow=birth_overflow + tmpl_overflow,
        )
        return state, cloud, diag

    def render(state: MapState):
        # 7. Occupancy render (with its in-reduction GC side effects).
        render_fn = (
            render_occupancy_smoothed
            if params.if_use_neighbor_smoothed_occupancy
            else render_occupancy
        )
        particles, result = render_fn(cfg, state, params.occupancy_threshold)
        return state.replace(particles=particles), result

    if split_render:
        return (
            jax.jit(core, donate_argnums=0),
            jax.jit(render, donate_argnums=0),
        )

    if packed:
        stable = static_label_table(registry)

        # Large grids compile the fused step over XLA's HBM budget (the
        # VKITTI2 program plans 17+ GB fused); split core and render into two
        # chained executables so their peaks don't stack.  Two dispatches
        # pipeline through the async queue, costing nothing measurable.
        if cfg.num_voxels * cfg.slots_per_voxel >= (1 << 25):
            def core_packed(state: MapState, buf):
                f = unpack_frame(cfg, stable, buf)
                return core(state, f)

            core_j = jax.jit(core_packed, donate_argnums=0)
            render_j = jax.jit(render, donate_argnums=0)

            def step_split(state: MapState, buf):
                state, _cloud, diag = core_j(state, buf)
                state, result = render_j(state)
                return state, result, diag

            return step_split

        def step_packed(state: MapState, buf):
            f = unpack_frame(cfg, stable, buf)
            state, _cloud, diag = core(state, f)
            state, result = render(state)
            return state, result, diag

        return jax.jit(step_packed, donate_argnums=0)

    def step(state: MapState, f: FrameInput):
        state, _cloud, diag = core(state, f)
        state, result = render(state)
        return state, result, diag

    return jax.jit(step, donate_argnums=0)


class SemanticDSPMap:
    """User-facing map engine (reference: class SemanticDSPMap,
    semantic_dsp_map.h:21).

    Typical use::

        dsp = SemanticDSPMap(virtual_kitti2_config(), FilterParams(...))
        for frame in frames:
            result = dsp.update(depth, masks, cam_pos, cam_quat, t)
    """

    def __init__(
        self,
        cfg: MapConfig,
        params: Optional[FilterParams] = None,
        registry: Optional[LabelRegistry] = None,
        seed: int = 0,
        log_diagnostics: bool = False,
    ):
        self.cfg = cfg
        self.params = params or FilterParams()
        self.registry = registry or LabelRegistry.default()
        self.state = init_map_state(cfg, seed)
        self.log_diagnostics = log_diagnostics
        self._time_origin: Optional[float] = None
        self._templates = None
        self._step = None         # built lazily (template path: the bank
        self._packed_step = None  # must be loaded before the stages close
                                  # over it; see _frame_step)
        if self.params.if_use_template_matching:
            from .template_engine import TemplateEngine

            self._templates = TemplateEngine(cfg, self.params, self.registry)
        else:
            self._step = build_frame_step(cfg, self.params, self.registry)

    # ------------------------------------------------------------------
    def set_template_path(self, folder: str) -> int:
        """setTemplatePath (semantic_dsp_map.h:163-166): load the CAD
        template bank (.pcd files grouped by label-id directory)."""
        if self._templates is None:
            raise ValueError(
                "set_template_path requires FilterParams(if_use_template_matching=True)"
            )
        return self._templates.set_template_path(folder)

    def clear(self):
        """semantic_dsp_map.h:74-81."""
        self.state = clear_map_state(self.state, self.cfg)

    def _frame_step(self, packed: bool):
        """The jitted step, built on first use.  Template mode builds the
        fused template stages from the (by now loaded) bank — fully jitted,
        no host orchestration (template_engine docstring)."""
        stages = self._templates.stages() if self._templates else None
        return build_frame_step(
            self.cfg, self.params, self.registry, packed=packed,
            template_stages=stages,
        )

    def update_from_frame(self, frame: FrameInput):
        """Run one frame from pre-built arrays; returns (RenderResult, diag)."""
        if self._step is None:
            self._step = self._frame_step(packed=False)
        self.state, result, diag = self._step(self.state, frame)
        if self.log_diagnostics:
            d = {k: int(np.asarray(v)) for k, v in diag._asdict().items()}
            print(f"[dsp] t={int(np.asarray(self.state.global_time))} {d}", flush=True)
        return result, diag

    def update(
        self,
        depth: np.ndarray,
        masks,
        cam_pos,
        cam_quat,
        time: float = 0.0,
    ):
        """Reference-parity entry (semantic_dsp_map.h:170): depth image,
        MaskKpts list, camera pose -> occupancy render result.

        Uses the packed single-buffer transfer path (frontend.pack_frame):
        one host->device array per frame instead of 14."""
        if self._time_origin is None:
            self._time_origin = float(time)
        t = float(time) - self._time_origin
        buf = pack_frame(
            self.cfg, self.registry, depth, masks, cam_pos, cam_quat, t
        )
        if self._packed_step is None:
            self._packed_step = self._frame_step(packed=True)
        self.state, result, diag = self._packed_step(self.state, buf)
        if self.log_diagnostics:
            d = {k: int(np.asarray(v)) for k, v in diag._asdict().items()}
            print(f"[dsp] t={int(np.asarray(self.state.global_time))} {d}", flush=True)
        return result, diag
