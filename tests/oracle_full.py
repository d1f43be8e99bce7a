"""Independent scalar/numpy model of the COMPLETE per-frame update.

This is the full-frame oracle the round-2 verdict asked for: a second
implementation of the specified frame semantics (the reference's
SemanticDSPMap::update, semantic_dsp_map.h:170-251, re-specified for the
array-program design as documented in the package docstrings), written with
python loops and per-entry scatter/gather structure — deliberately different
program shape from the vectorized JAX stencil/sort pipeline — so end-to-end
wiring bugs in either implementation surface as mismatches.

Determinism requirements for exact comparison (the test sets these):
  - FilterParams.prediction_stddev == 0 (no rigid-move jitter),
  - nb_ptc_num_per_point == 1 (no birth jitter),
  - keypoints that are exact rigid displacements (every RANSAC hypothesis
    yields the same transform).

Capacity caps (active blocks, entries) must not bind — the test asserts the
overflow diagnostics stay zero.
"""

from __future__ import annotations

import math

import numpy as np

from semantic_dsp_map_tpu.config import (
    FORGET_COUNT_INCREMENT_CAP,
    GAUSSIAN_PDF_COEF,
    GAUSSIAN_PDF_Z_CLIP,
    MIN_RIGHTLY_UPDATED_PDF,
    PARTICLE_OCC_INIT_WEIGHT,
)
from semantic_dsp_map_tpu.objects import (
    DEFAULT_PREDICT_DT,
    DEFAULT_TIME_INTERVAL,
    WINDOW_MAX_AGE,
)
from semantic_dsp_map_tpu.state import (
    STATUS_GUESSED_BORN,
    STATUS_INVALID,
    STATUS_REGULAR_BORN,
    STATUS_UPDATED,
)

F32 = np.float32

INVALID = STATUS_INVALID
UPDATED = STATUS_UPDATED


def quat_to_rot(q):
    w, x, y, z = [F32(v) for v in q]
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        F32,
    )


def gauss1(z):
    if abs(z) > GAUSSIAN_PDF_Z_CLIP:
        return 0.0
    return F32(GAUSSIAN_PDF_COEF) * np.exp(F32(-0.5) * F32(z) * F32(z))


def gauss3(dx, dy, dz, inv_sigma):
    zx, zy, zz = F32(dx * inv_sigma), F32(dy * inv_sigma), F32(dz * inv_sigma)
    if max(abs(zx), abs(zy), abs(zz)) > GAUSSIAN_PDF_Z_CLIP:
        return F32(0.0)
    s = zx * zx + zy * zy + zz * zz
    return F32(GAUSSIAN_PDF_COEF ** 3) * np.exp(F32(-0.5) * s)


def forgetting_factor(n, rate, max_count):
    if n >= max_count:
        return F32(0.0)
    return F32(np.power(F32(2.5), F32(-n / rate)))


def kabsch(P, Q):
    """Rigid fit Q ~ R P + t over all points (numpy, f64 SVD)."""
    cp, cq = P.mean(0), Q.mean(0)
    H = (P - cp).T @ (Q - cq)
    U, _, Vt = np.linalg.svd(H)
    V = Vt.T
    R = V @ U.T
    if np.linalg.det(R) < 0:
        V = V.copy()
        V[:, 2] *= -1
        R = V @ U.T
    t = cq - R @ cp
    T = np.eye(4, dtype=F32)
    T[:3, :3] = R.astype(F32)
    T[:3, 3] = t.astype(F32)
    return T


class FullOracle:
    def __init__(self, cfg, params, registry):
        self.cfg = cfg
        self.params = params
        self.registry = registry
        V, K = cfg.num_voxels, cfg.slots_per_voxel
        self.px = np.zeros((V, K), F32)
        self.py = np.zeros((V, K), F32)
        self.pz = np.zeros((V, K), F32)
        self.w = np.zeros((V, K), F32)
        self.label = np.zeros((V, K), np.int32)
        self.track = np.zeros((V, K), np.int32)
        self.status = np.zeros((V, K), np.int32)
        self.forget = np.zeros((V, K), np.int32)
        self.stamp = np.zeros((V, K), np.int32)
        self.voxel_stamp = np.zeros(V, np.int32)
        self.moved_steps = np.zeros(3, np.int64)
        self.equiv = np.zeros(3, np.int64)
        self.map_center = np.zeros(3, F32)
        self.sx = np.zeros(cfg.nx, np.int32)
        self.sy = np.zeros(cfg.ny, np.int32)
        self.sz = np.zeros(cfg.nz, np.int32)
        self.gt = 0
        self.prev_time = 0.0
        self.objects = {}  # track_id -> dict

        # block layout (ops/blocks.block_layout)
        bv = 1
        while bv * 2 * K <= 512 and bv * 2 <= V:
            bv *= 2
        self.bv = bv
        self.nb = V // bv

    # ---------------- codecs ----------------
    def _n(self):
        return np.array([self.cfg.nx, self.cfg.ny, self.cfg.nz], np.int64)

    def global_to_voxel(self, p):
        cfg = self.cfg
        half = np.array(cfg.map_half_extent, F32)
        recip = F32(1.0 / cfg.voxel_size)
        mf = np.asarray(p, F32) - self.map_center
        f = (mf + half) * recip
        m = np.trunc(f).astype(np.int64)
        n = self._n()
        if np.any(f < 0) or np.any(m >= n):
            return None
        ring = (m + self.equiv) % n
        return int(
            ((ring[2] << cfg.voxel_num_axis_y_n | ring[1]) << cfg.voxel_num_axis_x_n)
            | ring[0]
        )

    def voxel_ring(self, v):
        cfg = self.cfg
        xi = v & (cfg.nx - 1)
        yi = (v >> cfg.voxel_num_axis_x_n) & (cfg.ny - 1)
        zi = v >> (cfg.voxel_num_axis_x_n + cfg.voxel_num_axis_y_n)
        return xi, yi, zi

    def voxel_corner(self, v):
        cfg = self.cfg
        xi, yi, zi = self.voxel_ring(v)
        n = self._n()
        m = (np.array([xi, yi, zi], np.int64) - self.equiv) % n
        half = np.array(cfg.map_half_extent, F32)
        return m.astype(F32) * F32(cfg.voxel_size) - half + self.map_center

    def axis_stamp(self, v):
        xi, yi, zi = self.voxel_ring(v)
        return max(self.sx[xi], self.sy[yi], self.sz[zi])

    def alive(self, v, k):
        return self.status[v, k] != INVALID and self.stamp[v, k] >= self.axis_stamp(v)

    # ---------------- scroll ----------------
    def scroll(self, cam_pos, gt):
        cfg = self.cfg
        recip = F32(1.0 / cfg.voxel_size)
        steps = np.trunc(np.asarray(cam_pos, F32) * recip).astype(np.int64)
        self.map_center = steps.astype(F32) * F32(cfg.voxel_size)
        delta = steps - self.moved_steps
        for a, (n, st) in enumerate(
            [(cfg.nx, self.sx), (cfg.ny, self.sy), (cfg.nz, self.sz)]
        ):
            d = int(np.clip(delta[a], -n, n))
            idx = np.arange(n)
            rel = (idx - self.equiv[a]) % n
            if d >= 0:
                st[rel < d] = gt
            else:
                st[rel >= n + d] = gt
        self.moved_steps = steps
        n = self._n()
        self.equiv = np.where(steps >= 0, steps % n, -((-steps) % n))

    # ---------------- camera ----------------
    def camera(self, cam_pos, cam_quat):
        r_wc = quat_to_rot(cam_quat)
        t_wc = np.asarray(cam_pos, F32)
        r_cw = r_wc.T
        t_cw = -(r_cw @ t_wc)
        return r_wc, t_wc, r_cw, t_cw

    def project(self, r_cw, t_cw, p):
        cfg = self.cfg
        cam = r_cw @ np.asarray(p, F32) + t_cw
        z = cam[2]
        in_depth = cfg.depth_range_min <= z <= cfg.depth_range_max
        zs = z if z != 0 else 1e-6
        u = F32(cfg.fx) * cam[0] / F32(zs) + F32(cfg.cx)
        v = F32(cfg.fy) * cam[1] / F32(zs) + F32(cfg.cy)
        col = int(np.trunc(u))
        row = int(np.trunc(v))
        ok = in_depth and 0 <= row < cfg.height and 0 <= col < cfg.width
        return row, col, F32(z), ok

    # ---------------- labeled cloud ----------------
    def labeled_cloud(self, f, r_wc, t_wc):
        cfg, params = self.cfg, self.params
        H, W = cfg.height, cfg.width
        depth = np.asarray(f.depth, F32)
        rows = np.arange(H, dtype=F32)[:, None]
        cols = np.arange(W, dtype=F32)[None, :]
        valid = (
            np.isfinite(depth)
            & (depth >= cfg.depth_range_min)
            & (depth <= cfg.depth_range_max)
        )
        track = np.asarray(f.track_raster, np.int32)
        zed2 = self._zed2()
        if zed2:
            # sky culling (pointcloud_tools.h:234-241)
            sky = self.registry.static_label_to_instance.get(
                "Sky", self.registry.static_label_to_instance.get("sky", -1)
            )
            if sky >= 0:
                valid &= track != sky
        x_cam = (cols - F32(cfg.cx)) / F32(cfg.fx) * depth
        y_cam = (rows - F32(cfg.cy)) / F32(cfg.fy) * depth
        cam = np.stack([x_cam, y_cam, depth], -1)
        pos = cam @ r_wc.T.astype(F32) + t_wc
        if zed2:
            # per-instance 3D-bbox gating with margin: out-of-box movable
            # pixels demote to Background (pointcloud_tools.h:254-273)
            from semantic_dsp_map_tpu.labels import BACKGROUND_INSTANCE_ID

            movable = track <= self.registry.max_movable_instance_id
            tid = np.clip(track, 0, 65535)
            bmin = np.asarray(f.inst_bbox_min)[tid]
            bmax = np.asarray(f.inst_bbox_max)[tid]
            outside = np.any((pos < bmin) | (pos > bmax), axis=-1)
            track = np.where(movable & outside, BACKGROUND_INSTANCE_ID, track)
        label = np.asarray(f.track_label_table)[np.clip(track, 0, 65535)]
        if params.if_consider_depth_noise:
            sigma = (
                F32(params.depth_noise_model_zero_order)
                + F32(params.depth_noise_model_first_order) * depth
            )
        else:
            sigma = np.full((H, W), 0.1, F32)
        sigma = np.where(np.isfinite(sigma), sigma, params.depth_noise_model_zero_order)
        return dict(pos=pos.astype(F32), sigma=sigma.astype(F32), label=label,
                    track=track, valid=valid)

    def _zed2(self):
        from semantic_dsp_map_tpu.config import KEYPOINTS_BBOX3D

        return self.cfg.keypoint_mode == KEYPOINTS_BBOX3D

    def _out_of_fov(self, r_cw, t_cw, p, margin=5):
        """isPointOutOfFOV (semantic_dsp_map.h:1421-1442)."""
        cfg = self.cfg
        cam = r_cw @ np.asarray(p, F32) + t_cw
        z = cam[2]
        if z <= 0:
            return True
        u = F32(cfg.fx) * cam[0] / F32(z) + F32(cfg.cx)
        v = F32(cfg.fy) * cam[1] / F32(z) + F32(cfg.cy)
        return (
            u < margin or u >= cfg.width - margin
            or v < margin or v >= cfg.height - margin
        )

    # ---------------- object layer ----------------
    def object_update(self, f, cam_pos, r_cw, t_cw, time_now, gt):
        cfg, params = self.cfg, self.params
        zed2 = self._zed2()
        I = f.inst_valid.shape[0]
        for i in range(I):
            if not f.inst_valid[i] or f.inst_label[i] < 0:
                continue
            tid = int(f.inst_track[i])
            nk = int(f.kpts_count[i])
            kc = np.asarray(f.kpts_curr[i][:nk], F32)
            kp = np.asarray(f.kpts_prev[i][:nk], F32)
            obj = self.objects.get(tid)
            if obj is None:
                # range gate (Chebyshev of closest keypoint)
                if nk == 0:
                    continue
                cheb = np.max(np.abs(kc - np.asarray(cam_pos, F32)), axis=1)
                gate = cfg.voxel_size * (1 << (cfg.biggest_axis_n - 1)) * 1.2
                if cheb.min() > gate:
                    continue
                self.objects[tid] = dict(
                    label=int(f.inst_label[i]), last_obs=gt, obs_count=1,
                    prob=0.5, moving=False, has_moved_record=False,
                    T=np.eye(4, dtype=F32), has_T=False,
                    ref=np.zeros(3, F32), window=[], velocity=np.zeros(3, F32),
                    vel_valid=False, to_match_prev=False,
                    # ZED2 keypoint caches (semantic_dsp_map.h:267-271)
                    last_kpts=np.asarray(f.kpts_curr[i][:4], F32),
                    last_t=float(time_now), has_last=True,
                    key_kpts=np.asarray(f.kpts_curr[i][:4], F32),
                    key_t=float(time_now),
                )
                continue
            if nk < (4 if zed2 else 5):
                continue
            if zed2:
                # bbox3d path (semantic_dsp_map.h:408-481): transform from
                # the STORED last-frame corners; movement evidence is key-
                # corner drift vs max(threshold, bbox width); only the LAST
                # keypoint's FOV verdict matters; key corners refresh on a
                # 2 s timer.
                last_k = obj["last_kpts"]
                key_k = obj["key_kpts"]
                has_last = obj["has_last"]
                out_fov = self._out_of_fov(r_cw, t_cw, kc[nk - 1])
                T2 = kabsch(last_k.astype(np.float64), kc[:4].astype(np.float64))
                time_diff = float(time_now) - obj["last_t"]
                width = float(np.linalg.norm(kc[1] - kc[0]))
                key_thr = max(
                    params.bayesian_movement_distance_threshold, width
                )
                drift = float(np.linalg.norm(kc[0] - key_k[0]))
                evid = drift > key_thr
                success = (not out_fov) and has_last
                ref = last_k[0].copy()
                dt_window = time_diff
                # cache maintenance (store regardless of success)
                if not out_fov:
                    refresh_key = has_last and (
                        float(time_now) - obj["key_t"] > 2.0
                    )
                    if (not has_last) or refresh_key:
                        obj["key_kpts"] = kc[:4].copy()
                        obj["key_t"] = float(time_now)
                    obj["last_kpts"] = kc[:4].copy()
                    obj["last_t"] = float(time_now)
                    obj["has_last"] = True
                if not success:
                    continue
            else:
                # superpoint: exact rigid keypoints -> Kabsch over all
                # points; always valid
                T2 = kabsch(kp.astype(np.float64), kc.astype(np.float64))
                ref = kp[0]
                disp = T2[:3, :3] @ ref + T2[:3, 3] - ref
                evid = (
                    np.linalg.norm(disp)
                    > params.bayesian_movement_distance_threshold
                )
                dt_window = DEFAULT_TIME_INTERVAL
            # f32 accumulation: moved_probability is a C++ float in the
            # reference (object_layer.h:331) and f32 in production; f64 here
            # flips the strict '>' threshold compare at exact boundaries.
            praw = F32(obj["prob"]) + (
                F32(params.bayesian_movement_increment)
                if evid
                else F32(-params.bayesian_movement_decrement)
            )
            moving = praw > F32(params.bayesian_movement_probability_threshold)
            obj["prob"] = F32(min(max(praw, F32(0.0)), F32(1.0)))
            obj["moving"] = bool(moving)
            obj["has_moved_record"] = True
            obj["label"] = int(f.inst_label[i])
            obj["T"] = T2
            obj["has_T"] = True
            obj["last_obs"] = gt
            obj["obs_count"] += 1
            obj["to_match_prev"] = False
            obj["ref"] = ref
            if moving:
                self._window_push(obj, T2, dt_window, ref, gt)
        # unobserved moving objects coast
        observed = {int(f.inst_track[i]) for i in range(I)
                    if f.inst_valid[i] and f.inst_label[i] >= 0}
        td = time_now - self.prev_time
        if abs(td) > 1.0:
            td = 1.0
        for tid, obj in self.objects.items():
            if tid in observed or not (obj["has_moved_record"] and obj["moving"]):
                continue
            if obj["vel_valid"]:
                T = np.eye(4, dtype=F32)
                T[:3, 3] = obj["velocity"] * F32(td)
                obj["T"] = T
                obj["has_T"] = True
            obj["to_match_prev"] = False

    def _window_push(self, obj, T, dt, ref, gt):
        win = obj["window"]
        win.append(dict(T=T, dt=dt, ref=ref, stamp=gt))
        # age out from the front, cap length
        W = self.cfg.transform_window
        win = [e for e in win if (gt - e["stamp"]) <= WINDOW_MAX_AGE]
        win = win[-W:]
        obj["window"] = win
        if len(win) >= 2:
            vsum = np.zeros(3, F32)
            for e in win:
                centroid = e["ref"] + np.array([1 / 3, 1 / 3, 0], F32)
                d = e["T"][:3, :3] @ centroid - centroid + e["T"][:3, 3]
                vsum += d / F32(e["dt"])
            obj["velocity"] = vsum / F32(max(len(win) - 1, 1))
            obj["vel_valid"] = True
        else:
            obj["vel_valid"] = len(win) >= 2

    def expire(self, gt):
        for tid in list(self.objects):
            o = self.objects[tid]
            if (
                o["has_moved_record"]
                and o["moving"]
                and (gt - o["last_obs"]) >= self.params.max_observation_lost_time
            ):
                del self.objects[tid]

    # ---------------- move + cleanup ----------------
    def move_and_cleanup(self, gt, max_movable):
        cfg = self.cfg
        V, K = cfg.num_voxels, cfg.slots_per_voxel
        owned = {tid for tid in self.objects}
        mv = {
            tid
            for tid, o in self.objects.items()
            if o["has_moved_record"] and o["moving"] and o["has_T"]
        }
        if self.params.if_use_template_matching:
            mv = {t for t in mv if not self.objects[t]["to_match_prev"]}

        movers = []  # (voxel, slot) in storage order
        for v in range(V):
            for k in range(K):
                if not self.alive(v, k):
                    continue
                t = int(self.track[v, k])
                if 0 <= t <= max_movable and t not in owned:
                    self.status[v, k] = INVALID  # floating
                    continue
                if t in mv:
                    movers.append((v, k))

        if not mv:
            return 0

        # working set = blocks containing any mover, ascending; entries in
        # (block, voxel, slot) order — matching the production working-set
        # iota priority (map._move_and_cleanup).
        blocks = sorted({v // self.bv for v, _ in movers})
        cands = []
        pri = 0
        mset = set(movers)
        for b in blocks:
            for vv in range(b * self.bv, (b + 1) * self.bv):
                for k in range(K):
                    pri += 1
                    if (vv, k) not in mset:
                        continue
                    t = int(self.track[vv, k])
                    T = self.objects[t]["T"]
                    p = np.array([self.px[vv, k], self.py[vv, k], self.pz[vv, k]], F32)
                    np_ = T[:3, :3] @ p + T[:3, 3]
                    cands.append(
                        dict(
                            pos=np_.astype(F32),
                            w=F32(self.w[vv, k]),
                            label=int(self.label[vv, k]),
                            track=t,
                            status=int(self.status[vv, k]),
                            stamp=int(self.stamp[vv, k]),
                            forget=min(int(self.forget[vv, k]), 7),
                            pri=pri,
                        )
                    )
                    self.status[vv, k] = INVALID  # delete source
        return self._insert(cands, resample=False)

    # ---------------- insertion core ----------------
    def _insert(self, cands, resample, count_only=True):
        cfg = self.cfg
        K = cfg.slots_per_voxel
        by_vox = {}
        for c in cands:
            v = self.global_to_voxel(c["pos"])
            if v is None:
                continue
            by_vox.setdefault(v, []).append(c)
        for v in by_vox:
            by_vox[v].sort(key=lambda c: c["pri"])
            by_vox[v] = by_vox[v][:K]

        # stale prune in all target blocks
        blocks = sorted({v // self.bv for v in by_vox})
        for b in blocks:
            for vv in range(b * self.bv, (b + 1) * self.bv):
                ax = self.axis_stamp(vv)
                for k in range(K):
                    if self.status[vv, k] != INVALID and self.stamp[vv, k] < ax:
                        self.status[vv, k] = INVALID

        accepted = 0
        for v, lst in by_vox.items():
            if resample:
                self._resample_voxel(v)
            vacant = [k for k in range(K) if self.status[v, k] == INVALID]
            for c, k in zip(lst, vacant):
                self.px[v, k] = c["pos"][0]
                self.py[v, k] = c["pos"][1]
                self.pz[v, k] = c["pos"][2]
                self.w[v, k] = c["w"]
                self.label[v, k] = c["label"] & 0xFF
                self.track[v, k] = c["track"] & 0xFFFF
                self.status[v, k] = min(max(c["status"], 0), 7)
                self.stamp[v, k] = c["stamp"]
                self.forget[v, k] = min(max(c["forget"], 0), 7)
                accepted += 1
        return accepted

    def _resample_voxel(self, v):
        cfg = self.cfg
        K = cfg.slots_per_voxel
        trigger = (1 << cfg.max_particle_num_per_voxel_n) >> 1
        upd = [k for k in range(K) if self.status[v, k] == STATUS_UPDATED]
        wsum = F32(0.0)
        for k in upd:
            wsum = F32(wsum + self.w[v, k])
        if len(upd) <= trigger:
            return
        if wsum < 0.01:
            for k in upd:
                self.status[v, k] = INVALID
            return
        wpp = F32(min(wsum / trigger, 1.0))
        csum = F32(0.0)
        thresh = F32(wpp)
        for k in upd:
            csum = F32(csum + self.w[v, k])
            if csum < thresh:
                self.status[v, k] = INVALID
            else:
                self.w[v, k] = wpp
                thresh = F32(thresh + wpp)
                for _ in range(K + 8):
                    if csum > thresh:
                        thresh = F32(thresh + wpp)
        return

    # ---------------- observe (visibility + PHD) ----------------
    def observe(self, cloud, depth, r_cw, t_cw, gt):
        cfg, params = self.cfg, self.params
        V, K = cfg.num_voxels, cfg.slots_per_voxel
        H, W, S = cfg.height, cfg.width, cfg.phd_pixel_table_slots
        R = cfg.neighbor_half
        depth = np.asarray(depth, F32)

        # dense candidate pass + has_alive (pre-prune)
        has_alive = np.zeros(V, bool)
        cand = []
        active_blocks = set()
        for v in range(V):
            ax = self.axis_stamp(v)
            for k in range(K):
                if self.status[v, k] == INVALID or self.stamp[v, k] < ax:
                    continue
                has_alive[v] = True
                p = (self.px[v, k], self.py[v, k], self.pz[v, k])
                row, col, cz, ok = self.project(r_cw, t_cw, p)
                if ok:
                    active_blocks.add(v // self.bv)

        # stale prune within active blocks; collect entries in working-set order
        entries = []
        for b in sorted(active_blocks):
            for vv in range(b * self.bv, (b + 1) * self.bv):
                ax = self.axis_stamp(vv)
                for k in range(K):
                    if self.status[vv, k] == INVALID:
                        continue
                    if self.stamp[vv, k] < ax:
                        self.status[vv, k] = INVALID
                        continue
                    p = (self.px[vv, k], self.py[vv, k], self.pz[vv, k])
                    row, col, cz, ok = self.project(r_cw, t_cw, p)
                    if not ok:
                        continue
                    entries.append(dict(v=vv, k=k, row=row, col=col, cz=cz))

        one_sigma = F32(1.0 + cfg.depth_error_stddev_at_one_meter)
        visible_entries = []
        observed_voxels = set()
        n_visible = 0
        # classification + per-pixel closest-S competition
        entries.sort(key=lambda e: (e["row"] * W + e["col"], e["cz"]))
        per_pixel = {}
        for e in entries:
            d_at = depth[e["row"], e["col"]]
            if d_at > cfg.depth_range_max:
                # far free-space: weight reset
                self.w[e["v"], e["k"]] = F32(PARTICLE_OCC_INIT_WEIGHT)
                observed_voxels.add(e["v"])
                continue
            if e["cz"] > d_at * one_sigma:
                continue  # occluded
            n_visible += 1
            pix = e["row"] * W + e["col"]
            lst = per_pixel.setdefault(pix, [])
            if len(lst) < S:
                lst.append(e)
                visible_entries.append(e)
                observed_voxels.add(e["v"])
            else:
                observed_voxels.add(e["v"])

        # NOTE: in the production pipeline, entries that lose the S-slot
        # competition still count as "observed" for the voxel stamp (the
        # `observed` bit is visible | far_free), as above.

        # pass A: scatter side
        ck = np.zeros((H, W), F32)
        for e in visible_entries:
            v, k = e["v"], e["k"]
            wgt = F32(self.w[v, k])
            if not params.if_use_independent_filter:
                ff = forgetting_factor(
                    self.forget[v, k], params.forgetting_rate, params.max_forget_count
                )
                weff = F32(wgt * ff)
            else:
                weff = wgt
            trk = self.track[v, k]
            for dr in range(-R, R + 1):
                for dc in range(-R, R + 1):
                    q_r, q_c = e["row"] + dr, e["col"] + dc
                    if not (0 <= q_r < H and 0 <= q_c < W):
                        continue
                    inv_sig = F32(1.0 / max(cloud["sigma"][q_r, q_c], 1e-6))
                    g = gauss3(
                        self.px[v, k] - cloud["pos"][q_r, q_c, 0],
                        self.py[v, k] - cloud["pos"][q_r, q_c, 1],
                        self.pz[v, k] - cloud["pos"][q_r, q_c, 2],
                        inv_sig,
                    )
                    if params.if_use_independent_filter:
                        if trk == cloud["track"][q_r, q_c]:
                            ck[q_r, q_c] += weff * g
                    else:
                        if trk != cloud["track"][q_r, q_c]:
                            g = F32(g * F32(params.id_transition_probability))
                        ck[q_r, q_c] += weff * g
        ck = np.where(cloud["valid"], ck, 0.0).astype(F32)
        ck_kappa = ck * F32(params.detection_probability) + F32(params.noise_number)

        # pass B: gather side per kept entry
        for e in visible_entries:
            v, k = e["v"], e["k"]
            trk = self.track[v, k]
            inv_sig_p = F32(1.0 / max(cloud["sigma"][e["row"], e["col"]], 1e-6))
            if not params.if_use_independent_filter:
                ff = forgetting_factor(
                    self.forget[v, k], params.forgetting_rate, params.max_forget_count
                )
            acc = F32(0.0)
            right = False
            for dr in range(-R, R + 1):
                for dc in range(-R, R + 1):
                    q_r, q_c = e["row"] + dr, e["col"] + dc
                    if not (0 <= q_r < H and 0 <= q_c < W):
                        continue
                    if not cloud["valid"][q_r, q_c]:
                        continue
                    g_raw = gauss3(
                        self.px[v, k] - cloud["pos"][q_r, q_c, 0],
                        self.py[v, k] - cloud["pos"][q_r, q_c, 1],
                        self.pz[v, k] - cloud["pos"][q_r, q_c, 2],
                        inv_sig_p,
                    )
                    same = trk == cloud["track"][q_r, q_c]
                    if params.if_use_independent_filter:
                        if same:
                            acc += g_raw / ck_kappa[q_r, q_c]
                    else:
                        if same and g_raw > MIN_RIGHTLY_UPDATED_PDF:
                            right = True
                        g = g_raw if same else F32(g_raw * F32(params.id_transition_probability))
                        acc += F32(g * ff) / ck_kappa[q_r, q_c]
            pd = F32(params.detection_probability)
            self.w[v, k] = F32(self.w[v, k] * (acc * pd + F32(1.0) - pd))
            self.status[v, k] = STATUS_UPDATED
            self.stamp[v, k] = gt
            if not params.if_use_independent_filter:
                if right:
                    self.forget[v, k] = 0
                elif self.forget[v, k] < FORGET_COUNT_INCREMENT_CAP:
                    self.forget[v, k] += 1

        for v in observed_voxels:
            self.voxel_stamp[v] = gt

        # empty-voxel corner rule.  Round-5 deviation (mirrored by
        # ops/observe.py refresh_empty_voxel_stamps): voxels whose stamp is
        # already VALID are not re-stamped — the stamp value is only ever
        # consumed through the validity test (stamp != 0 and >= axis stamp),
        # so this is render-equivalent to the reference's re-stamp-on-visit
        # while shrinking the production working set dramatically.
        for v in range(V):
            if has_alive[v]:
                continue
            ax = self.axis_stamp(v)
            if self.voxel_stamp[v] != 0 and self.voxel_stamp[v] >= ax:
                continue
            row, col, cz, ok = self.project(r_cw, t_cw, self.voxel_corner(v))
            if not ok:
                continue
            d_at = depth[min(max(row, 0), H - 1), min(max(col, 0), W - 1)]
            if cz <= d_at:
                self.voxel_stamp[v] = gt

        return n_visible

    # ---------------- birth ----------------
    def birth(self, cloud, gt):
        cfg = self.cfg
        H, W = cfg.height, cfg.width
        cands = []
        for r in range(H):
            for c in range(W):
                if not cloud["valid"][r, c]:
                    continue
                phase = (r % 3) * 3 + c % 3
                pri = (phase * H + r) * W + c
                cands.append(
                    dict(
                        pos=cloud["pos"][r, c],
                        w=F32(PARTICLE_OCC_INIT_WEIGHT),
                        label=int(cloud["label"][r, c]),
                        track=int(cloud["track"][r, c]),
                        status=STATUS_REGULAR_BORN,
                        stamp=gt,
                        forget=0,
                        pri=pri,
                    )
                )
        return self._insert(cands, resample=True)

    # ---------------- render ----------------
    def render(self, occupancy_threshold):
        cfg = self.cfg
        V, K = cfg.num_voxels, cfg.slots_per_voxel
        occ = np.full(V, -1, np.int32)
        out_label = np.zeros(V, np.int32)
        out_track = np.zeros(V, np.int32)
        weight_sum = np.full(V, -1.0, F32)
        for v in range(V):
            ax = self.axis_stamp(v)
            vvalid = self.voxel_stamp[v] != 0 and self.voxel_stamp[v] >= ax
            alive = [
                k
                for k in range(K)
                if self.status[v, k] != INVALID and self.stamp[v, k] >= ax
            ]
            ws = F32(0.0)
            for k in alive:
                ws = F32(ws + self.w[v, k])
            if not vvalid:
                continue
            guessed_w = F32(0.0)
            contrib = {}
            label_of = {}
            for k in alive:
                wc = F32(min(self.w[v, k], 1.0))
                self.w[v, k] = wc
                if self.status[v, k] == STATUS_GUESSED_BORN:
                    guessed_w = F32(guessed_w + wc)
                if self.status[v, k] == STATUS_UPDATED and wc < PARTICLE_OCC_INIT_WEIGHT:
                    self.status[v, k] = INVALID  # GC
                    continue
            # per-track sums over contributing slots (post-GC mask)
            for k in alive:
                if self.status[v, k] == INVALID:
                    continue
                t = int(self.track[v, k])
                contrib[t] = F32(contrib.get(t, F32(0.0)) + min(self.w[v, k], 1.0))
                label_of[t] = int(self.label[v, k])
            best_t, best_w = 0, 0.0
            found = False
            for k in alive:
                if self.status[v, k] == INVALID:
                    continue
                t = int(self.track[v, k])
                ts = contrib[t]
                if ts <= 0.0:
                    continue
                if not found or ts > best_w or (ts == best_w and t < best_t):
                    best_t, best_w = t, ts
                    found = True
            weight_sum[v] = ws
            if found:
                out_track[v] = best_t
                out_label[v] = label_of[best_t]
            if ws > occupancy_threshold:
                occ[v] = 1
            elif guessed_w >= PARTICLE_OCC_INIT_WEIGHT:
                occ[v] = 2
            else:
                occ[v] = 0
        return dict(occ=occ, label=out_label, track=out_track, weight_sum=weight_sum)

    # ---------------- frame ----------------
    def update(self, f, occupancy_threshold=None):
        cfg, params = self.cfg, self.params
        self.gt += 1
        gt = self.gt
        r_wc, t_wc, r_cw, t_cw = self.camera(f.cam_pos, f.cam_quat)
        if cfg.consider_instance:
            self.object_update(f, f.cam_pos, r_cw, t_cw, float(f.time), gt)
        cloud = self.labeled_cloud(f, r_wc, t_wc)
        self.scroll(f.cam_pos, gt)
        self.expire(gt)
        moved = self.move_and_cleanup(gt, self.registry.max_movable_instance_id)
        visible = self.observe(cloud, f.depth, r_cw, t_cw, gt)
        born = self.birth(cloud, gt)
        res = self.render(
            occupancy_threshold
            if occupancy_threshold is not None
            else params.occupancy_threshold
        )
        self.prev_time = float(f.time)
        return res, dict(moved=moved, visible=visible, born=born)
