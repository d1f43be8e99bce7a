"""Object-level update: tracking table, Bayesian moving/static filter,
transform windows and constant-velocity prediction.

Vectorized re-design of objectLevelUpdate (semantic_dsp_map.h:306-566) and
ObjectSet / ObjectTransformations / MotionEstimation
(object_layer.h:57-648).  All per-object hash maps become fixed-capacity
masked arrays (state.ObjectTable); per-frame observations arrive as the
fixed-shape :class:`ObservedInstances` batch.

Reference quirks preserved:
  - the Bayesian moving decision compares the *pre-clamp* probability to the
    threshold, then clamps to [0, 1] (object_layer.h:489-514);
  - the superpoint path calls updateObject without a time interval, so the
    velocity window receives the default dt = 0.15 s (object_layer.h:470,
    semantic_dsp_map.h:503);
  - MotionEstimation divides the summed per-entry velocities by
    (window_size - 1) even though it sums window_size entries
    (object_layer.h:158);
  - prediction uses a pure translation (identity rotation) regardless of the
    estimated angular velocity (object_layer.h:185-198), so only the
    translational velocity is tracked;
  - the ZED2 out-of-FOV test overwrites its flag in a loop, so only the LAST
    keypoint decides (semantic_dsp_map.h:419-422);
  - new objects are range-gated by the Chebyshev distance of their closest
    keypoint against 1.2x the half map size (semantic_dsp_map.h:348-360).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import (
    FilterParams,
    KEYPOINTS_BBOX3D,
    MapConfig,
    MOVEMENT_ALWAYS,
    MOVEMENT_NEVER,
)
from .state import ObjectTable
from .ops.geometry import HIGHEST, mm
from .ops.transforms import ransac_transform

#: Window entries older than this many steps age out (object_layer.h:233).
WINDOW_MAX_AGE = 10

#: Default dt fed to the transform window by the superpoint path
#: (object_layer.h:470 default argument).
DEFAULT_TIME_INTERVAL = 0.15

#: Default dt for coasting prediction of re-matched objects
#: (object_layer.h:556 default argument).
DEFAULT_PREDICT_DT = 0.2


class ObservedInstances(NamedTuple):
    """Fixed-shape batch of this frame's observed movable instances."""

    valid: jax.Array       # bool[I]
    track: jax.Array       # i32[I]
    label: jax.Array       # i32[I] label id; -1 if the label is unknown
    kpts_curr: jax.Array   # f32[I, Kp, 3]
    kpts_prev: jax.Array   # f32[I, Kp, 3]
    kpts_count: jax.Array  # i32[I]


def _match_objects(objects: ObjectTable, track):
    """For each instance, the object-table row with the same track id."""
    eq = (track[:, None] == objects.track_id[None, :]) & objects.valid[None, :]
    has = jnp.any(eq, axis=1)
    idx = jnp.argmax(eq, axis=1)
    return has, jnp.where(has, idx, 0)


def _translation_matrix(v):
    T = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), v.shape[:-1] + (4, 4))
    return T.at[..., :3, 3].set(v)


def _window_push_and_estimate(
    objects: ObjectTable,
    push_mask,     # bool[O]
    T_new,         # f32[O, 4, 4]
    dt_new,        # f32[O]
    ref_new,       # f32[O, 3]
    global_time,
):
    """ObjectTransformations::update (object_layer.h:218-259) for all objects
    with push_mask at once, followed by the velocity estimate
    (MotionEstimation::estimate, object_layer.h:137-160).
    """
    O, W = objects.win_dt.shape

    # Append the new entry at virtual position W of a W+1 buffer.
    stamps = jnp.concatenate([objects.win_stamp, jnp.full((O, 1), global_time, jnp.int32)], axis=1)
    pos = jnp.arange(W + 1, dtype=jnp.int32)[None, :]
    occupied = (pos < objects.win_count[:, None]) | (pos == W)

    # Entries age out from the front; stamps are nondecreasing so the aged
    # set is a prefix.  Also cap to the newest W entries.
    aged = occupied & ((global_time - stamps) > WINDOW_MAX_AGE)
    n_aged_front = jnp.sum(aged, axis=1)

    # Compact: logical order is [old entries 0..count-1, new entry]; drop the
    # first `drop` of them.
    count1 = objects.win_count + 1
    drop = jnp.maximum(n_aged_front, count1 - W)
    new_count = count1 - drop

    # Source logical position for destination j: j + drop; logical position
    # c maps to physical old index c (c < count) or the new entry (c == count).
    dst = jnp.arange(W, dtype=jnp.int32)[None, :]
    src = dst + drop[:, None]
    from_new = src == objects.win_count[:, None]
    src_old = jnp.clip(src, 0, W - 1)

    def compact(old, new):
        gathered = jnp.take_along_axis(
            old, src_old.reshape(src_old.shape + (1,) * (old.ndim - 2)), axis=1
        )
        sel = from_new.reshape(from_new.shape + (1,) * (old.ndim - 2))
        return jnp.where(sel, new[:, None], gathered)

    win_t = compact(objects.win_tmatrix, T_new)
    win_dt = jnp.where(from_new, dt_new[:, None], jnp.take_along_axis(objects.win_dt, src_old, axis=1))
    win_stamp = jnp.where(
        from_new,
        jnp.full((O, W), global_time, jnp.int32),
        jnp.take_along_axis(objects.win_stamp, src_old, axis=1),
    )
    win_ref = compact(objects.win_ref, ref_new)

    pm = push_mask
    win_t = jnp.where(pm[:, None, None, None], win_t, objects.win_tmatrix)
    win_dt = jnp.where(pm[:, None], win_dt, objects.win_dt)
    win_stamp = jnp.where(pm[:, None], win_stamp, objects.win_stamp)
    win_ref = jnp.where(pm[:, None, None], win_ref, objects.win_ref)
    win_count = jnp.where(pm, new_count, objects.win_count)

    # Velocity estimate over the window (object_layer.h:94-160): the centroid
    # of {ref, ref+x_hat, ref+y_hat} is ref + (1/3, 1/3, 0); its displacement
    # under T is (R - I) @ centroid + t.
    entry_valid = jnp.arange(W, dtype=jnp.int32)[None, :] < win_count[:, None]
    centroid = win_ref + jnp.array([1.0 / 3.0, 1.0 / 3.0, 0.0], jnp.float32)
    R = win_t[..., :3, :3]
    t = win_t[..., :3, 3]
    disp = jnp.einsum("owij,owj->owi", R, centroid, precision=HIGHEST) - centroid + t
    dt_safe = jnp.where(win_dt == 0, 1e-9, win_dt)
    per_entry_v = disp / dt_safe[..., None]
    vsum = jnp.sum(jnp.where(entry_valid[..., None], per_entry_v, 0.0), axis=1)
    denom = jnp.maximum(win_count - 1, 1).astype(jnp.float32)
    velocity = vsum / denom[:, None]

    can_estimate = pm & (win_count >= 2)
    velocity = jnp.where(can_estimate[:, None], velocity, objects.velocity)
    # updated_ is (re)set on every push: True iff window >= 2
    # (object_layer.h:251-258).
    vel_valid = jnp.where(pm, win_count >= 2, objects.vel_valid)

    return objects.replace(
        win_tmatrix=win_t,
        win_dt=win_dt,
        win_stamp=win_stamp,
        win_ref=win_ref,
        win_count=win_count,
        velocity=velocity,
        vel_valid=vel_valid,
    )


@partial(jax.jit, static_argnums=(0, 1))
def object_level_update(
    cfg: MapConfig,
    params: FilterParams,
    objects: ObjectTable,
    obs: ObservedInstances,
    cam_pos,
    r_cw,
    t_cw,
    time_now,
    prev_frame_time,
    global_time,
    rng: jax.Array,
) -> ObjectTable:
    """One frame of objectLevelUpdate (semantic_dsp_map.h:306-566)."""
    I = obs.valid.shape[0]
    Kp = obs.kpts_curr.shape[1]

    relevant = obs.valid & (obs.label >= 0)
    has, oidx = _match_objects(objects, obs.track)

    # ---------------- Case 1: new objects ------------------------------
    kmask = jnp.arange(Kp, dtype=jnp.int32)[None, :] < obs.kpts_count[:, None]
    cheb = jnp.max(jnp.abs(obs.kpts_curr - cam_pos[None, None, :]), axis=-1)
    cheb = jnp.where(kmask, cheb, jnp.inf)
    closest = jnp.min(cheb, axis=1)
    map_half_scaled = cfg.voxel_size * (1 << (cfg.biggest_axis_n - 1)) * 1.2
    range_ok = closest <= map_half_scaled

    new_mask = relevant & ~has & range_ok

    free = ~objects.valid
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    n_free = jnp.sum(free.astype(jnp.int32))
    new_rank = jnp.cumsum(new_mask.astype(jnp.int32)) - 1
    placeable = new_mask & (new_rank < n_free)
    # slot for instance i: the row whose free_rank equals new_rank[i]
    slot_match = free[None, :] & (free_rank[None, :] == new_rank[:, None])
    new_slot = jnp.argmax(slot_match, axis=1)
    placeable &= jnp.any(slot_match, axis=1)
    O = objects.valid.shape[0]
    # NOTE: negative indices WRAP in jnp scatters even with mode="drop";
    # the drop sentinel must be an out-of-bounds positive index (here O).
    tgt = jnp.where(placeable, new_slot, O)

    def place(arr, vals):
        return arr.at[tgt].set(vals, mode="drop")

    objects = objects.replace(
        valid=place(objects.valid, jnp.ones(I, bool)),
        track_id=place(objects.track_id, obs.track),
        label=place(objects.label, obs.label),
        last_obs_step=place(objects.last_obs_step, jnp.full(I, global_time, jnp.int32)),
        obs_count=place(objects.obs_count, jnp.ones(I, jnp.int32)),
        moved_probability=place(objects.moved_probability, jnp.full(I, 0.5, jnp.float32)),
        moving=place(objects.moving, jnp.zeros(I, bool)),
        has_moved_record=place(objects.has_moved_record, jnp.zeros(I, bool)),
        has_tmatrix=place(objects.has_tmatrix, jnp.zeros(I, bool)),
        to_match_templates=place(objects.to_match_templates, jnp.ones(I, bool)),
        to_match_previous=place(objects.to_match_previous, jnp.zeros(I, bool)),
        win_count=place(objects.win_count, jnp.zeros(I, jnp.int32)),
        vel_valid=place(objects.vel_valid, jnp.zeros(I, bool)),
        last_kpts=place(objects.last_kpts, obs.kpts_curr[:, :4]),
        last_kpts_time=place(objects.last_kpts_time, jnp.full(I, time_now, jnp.float32)),
        has_last_kpts=place(objects.has_last_kpts, jnp.ones(I, bool)),
        key_kpts=place(objects.key_kpts, obs.kpts_curr[:, :4]),
        key_kpts_time=place(objects.key_kpts_time, jnp.full(I, time_now, jnp.float32)),
    )
    # Re-match now that new rows exist.
    has, oidx = _match_objects(objects, obs.track)

    # ---------------- Case 2: keypoint transform update ----------------
    min_kpts = 4 if cfg.keypoint_mode == KEYPOINTS_BBOX3D else 5
    exist_obs = relevant & has & ~new_mask & (obs.kpts_count >= min_kpts)

    rngs = jax.random.split(rng, I)

    if cfg.keypoint_mode == KEYPOINTS_BBOX3D:
        # ZED2: transform from the stored last-frame keypoints to current
        # (semantic_dsp_map.h:408-481).
        last_k = objects.last_kpts[oidx]          # f32[I, 4, 3]
        has_last = objects.has_last_kpts[oidx]
        key_k = objects.key_kpts[oidx]
        key_t = objects.key_kpts_time[oidx]
        last_t = objects.last_kpts_time[oidx]

        # Out-of-FOV: only the last keypoint's verdict survives the loop.
        last_idx = jnp.maximum(obs.kpts_count - 1, 0)
        last_pt = jnp.take_along_axis(obs.kpts_curr, last_idx[:, None, None], axis=1)[:, 0]
        out_fov = _point_out_of_fov(cfg, r_cw, t_cw, last_pt, margin=5)

        def per_inst(key, P, Q):
            return ransac_transform(key, P, Q, jnp.ones(4, bool), 2, 0.5, False)

        T2, _, _, _, _ = jax.vmap(per_inst)(rngs, last_k, obs.kpts_curr[:, :4])

        time_diff = time_now - last_t
        width = jnp.linalg.norm(obs.kpts_curr[:, 1] - obs.kpts_curr[:, 0], axis=-1)
        key_thr = jnp.maximum(params.bayesian_movement_distance_threshold, width)
        drift = jnp.linalg.norm(obs.kpts_curr[:, 0] - key_k[:, 0], axis=-1)
        moved_obs = (drift > key_thr).astype(jnp.int32)

        success2 = exist_obs & ~out_fov & has_last
        ref_pt = last_k[:, 0]
        dt_window = time_diff

        # Keypoint cache maintenance (for all exist_obs with valid last data,
        # and the missing-cache repair path, semantic_dsp_map.h:431-478).
        store_mask = exist_obs & ~out_fov
        refresh_key = store_mask & has_last & ((time_now - key_t) > 2.0)
        set_key = (store_mask & ~has_last) | refresh_key
        tgt2 = jnp.where(store_mask, oidx, objects.valid.shape[0])
        tgt_key = jnp.where(set_key, oidx, objects.valid.shape[0])
        objects = objects.replace(
            last_kpts=objects.last_kpts.at[tgt2].set(obs.kpts_curr[:, :4], mode="drop"),
            last_kpts_time=objects.last_kpts_time.at[tgt2].set(
                jnp.full(I, time_now, jnp.float32), mode="drop"
            ),
            has_last_kpts=objects.has_last_kpts.at[tgt2].set(True, mode="drop"),
            key_kpts=objects.key_kpts.at[tgt_key].set(obs.kpts_curr[:, :4], mode="drop"),
            key_kpts_time=objects.key_kpts_time.at[tgt_key].set(
                jnp.full(I, time_now, jnp.float32), mode="drop"
            ),
        )
    else:
        # Superpoint: matched keypoint pairs, 100-iteration RANSAC with refit
        # and the mse/inlier validity gate (semantic_dsp_map.h:381-407).
        km = kmask

        def per_inst(key, P, Q, m):
            return ransac_transform(key, P, Q, m, 100, 0.5, True)

        T2, inl_mask, n_inl, mse, first_inl = jax.vmap(per_inst)(
            rngs, obs.kpts_prev, obs.kpts_curr, km
        )
        ratio = n_inl.astype(jnp.float32) / jnp.maximum(obs.kpts_count, 1)
        tf_ok = (mse <= 0.2) & (n_inl >= 5) & (ratio >= 0.5)
        success2 = exist_obs & tf_ok
        ref_pt = jnp.take_along_axis(obs.kpts_prev, first_inl[:, None, None], axis=1)[:, 0]
        moved_obs = jnp.full(I, -1, jnp.int32)
        dt_window = jnp.full(I, DEFAULT_TIME_INTERVAL, jnp.float32)

    # ---------------- updateObject (object_layer.h:470-539) ------------
    disp = jnp.einsum("iab,ib->ia", T2[:, :3, :3], ref_pt, precision=HIGHEST) + T2[:, :3, 3] - ref_pt
    disp_norm = jnp.linalg.norm(disp, axis=-1)
    if cfg.movement_mode == MOVEMENT_NEVER:
        moving_now = jnp.zeros(I, bool)
        prob_new = objects.moved_probability[oidx]
    elif cfg.movement_mode == MOVEMENT_ALWAYS:
        moving_now = jnp.ones(I, bool)
        prob_new = objects.moved_probability[oidx]
    else:
        evidence = jnp.where(
            moved_obs == -1,
            disp_norm > params.bayesian_movement_distance_threshold,
            moved_obs == 1,
        )
        prob_old = objects.moved_probability[oidx]
        prob_raw = jnp.where(
            evidence,
            prob_old + params.bayesian_movement_increment,
            prob_old - params.bayesian_movement_decrement,
        )
        # Threshold compare happens before the clamp (object_layer.h:506-514).
        moving_now = prob_raw > params.bayesian_movement_probability_threshold
        prob_new = jnp.clip(prob_raw, 0.0, 1.0)

    tgt3 = jnp.where(success2, oidx, objects.valid.shape[0])
    objects = objects.replace(
        label=objects.label.at[tgt3].set(obs.label, mode="drop"),
        tmatrix=objects.tmatrix.at[tgt3].set(T2, mode="drop"),
        has_tmatrix=objects.has_tmatrix.at[tgt3].set(True, mode="drop"),
        last_obs_step=objects.last_obs_step.at[tgt3].set(
            jnp.full(I, global_time, jnp.int32), mode="drop"
        ),
        obs_count=objects.obs_count.at[tgt3].add(1, mode="drop"),
        to_match_previous=objects.to_match_previous.at[tgt3].set(False, mode="drop"),
        moved_probability=objects.moved_probability.at[tgt3].set(prob_new, mode="drop"),
        moving=objects.moving.at[tgt3].set(moving_now, mode="drop"),
        has_moved_record=objects.has_moved_record.at[tgt3].set(True, mode="drop"),
        reference_point=objects.reference_point.at[tgt3].set(ref_pt, mode="drop"),
    )

    # Window push for moving objects (object_layer.h:535-537).  Scatter the
    # per-instance values to per-object slots first.
    O = objects.valid.shape[0]
    push_sel = success2 & moving_now
    tgt4 = jnp.where(push_sel, oidx, O)
    push_mask = jnp.zeros(O, bool).at[tgt4].set(True, mode="drop")
    T_o = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (O, 4, 4))
    T_o = T_o.at[tgt4].set(T2, mode="drop")
    dt_o = jnp.ones(O, jnp.float32).at[tgt4].set(dt_window, mode="drop")
    ref_o = jnp.zeros((O, 3), jnp.float32).at[tgt4].set(ref_pt, mode="drop")
    objects = _window_push_and_estimate(objects, push_mask, T_o, dt_o, ref_o, global_time)

    # ---------------- Case 3 (superpoint): rematch / coast -------------
    if cfg.keypoint_mode != KEYPOINTS_BBOX3D:
        fail = relevant & has & ~new_mask & ~success2
        fail &= objects.has_moved_record[oidx] & objects.moving[oidx]
        can_predict = objects.vel_valid[oidx]

        coast = fail & can_predict
        T_pred = _translation_matrix(objects.velocity[oidx] * DEFAULT_PREDICT_DT)
        tgt5 = jnp.where(coast, oidx, objects.valid.shape[0])
        objects = objects.replace(
            tmatrix=objects.tmatrix.at[tgt5].set(T_pred, mode="drop"),
            has_tmatrix=objects.has_tmatrix.at[tgt5].set(True, mode="drop"),
            to_match_previous=objects.to_match_previous.at[tgt5].set(False, mode="drop"),
        )

        rematch = fail & ~can_predict
        tgt6 = jnp.where(rematch, oidx, objects.valid.shape[0])
        objects = objects.replace(
            last_obs_step=objects.last_obs_step.at[tgt6].set(
                jnp.full(I, global_time, jnp.int32), mode="drop"
            ),
            to_match_previous=objects.to_match_previous.at[tgt6].set(True, mode="drop"),
            to_match_templates=objects.to_match_templates.at[tgt6].set(False, mode="drop"),
        )

    # ---------------- Unobserved objects: coasting prediction ----------
    observed = jnp.zeros(O, bool).at[jnp.where(relevant, oidx, O)].set(True, mode="drop")
    unobs = objects.valid & ~observed & objects.has_moved_record & objects.moving
    td = time_now - prev_frame_time
    td = jnp.where(jnp.abs(td) > 1.0, 1.0, td)
    T_pred_u = _translation_matrix(objects.velocity * td)
    upd_T = unobs & objects.vel_valid
    objects = objects.replace(
        tmatrix=jnp.where(upd_T[:, None, None], T_pred_u, objects.tmatrix),
        has_tmatrix=objects.has_tmatrix | upd_T,
        to_match_previous=jnp.where(unobs, False, objects.to_match_previous),
    )

    return objects


def _point_out_of_fov(cfg: MapConfig, r_cw, t_cw, pts, margin: int):
    """isPointOutOfFOV (semantic_dsp_map.h:1421-1442)."""
    cam = mm(pts, r_cw.T) + t_cw
    z = cam[..., 2]
    behind = z <= 0
    zs = jnp.where(z == 0, 1e-9, z)
    u = cfg.fx * cam[..., 0] / zs + cfg.cx
    v = cfg.fy * cam[..., 1] / zs + cfg.cy
    outside = (
        (u < margin)
        | (u >= cfg.width - margin)
        | (v < margin)
        | (v >= cfg.height - margin)
    )
    return behind | outside


@partial(jax.jit, static_argnums=0)
def expire_objects(
    params: FilterParams,
    objects: ObjectTable,
    global_time,
):
    """Expiry of moving objects unseen for too long
    (semantic_dsp_map.h:600-606): returns (objects', expired bool[O])."""
    expired = (
        objects.valid
        & objects.has_moved_record
        & objects.moving
        & ((global_time - objects.last_obs_step) >= params.max_observation_lost_time)
    )
    objects = objects.replace(
        valid=objects.valid & ~expired,
        has_last_kpts=objects.has_last_kpts & ~expired,
    )
    return objects, expired


@partial(jax.jit, static_argnums=1)
def track_lookup_table(objects: ObjectTable, size: int = 65536):
    """Dense track id -> object row table (replaces ObjectParticleHashMap's
    keying, object_layer.h:20-52).  -1 where no live object owns the id."""
    table = jnp.full(size, -1, jnp.int32)
    tid = jnp.where(
        objects.valid & (objects.track_id >= 0) & (objects.track_id < size),
        objects.track_id,
        size,  # out-of-bounds drop sentinel (negatives would wrap)
    )
    rows = jnp.arange(objects.valid.shape[0], dtype=jnp.int32)
    return table.at[tid].set(rows, mode="drop")
