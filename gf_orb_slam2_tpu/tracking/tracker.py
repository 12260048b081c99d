"""Front-end tracking: per-frame pose estimation + keyframe policy.

JAX replacement for the Tracking class (reference: src/Tracking.cc:594
Track, include/Tracking.h). The reference's per-frame flow — motion-model
matching, reference-KF fallback, local-map tracking, KF decision — is kept,
but each stage is one fused jitted device program over fixed-capacity masked
arrays; host code only gathers map snapshots and applies the results
(SURVEY.md §7.1 "host orchestration").

Stage → reference mapping:
- `_motion_step`   ← TrackWithMotionModel (Tracking.cc:1495): project last
  frame's points under the constant-velocity prediction, windowed descriptor
  match, motion-only BA.
- `_refkf_step`    ← TrackReferenceKeyFrame (Tracking.cc:1331): brute-force
  descriptor match vs the reference KF (replaces SearchByBoW pruning), BA.
- `_local_step`    ← TrackLocalMap + SearchLocalPoints (Tracking.cc:1572/2174):
  frustum-check the local-map candidate pool, projection-match the unmatched
  keypoints, re-optimize, final inlier gate.
- KF policy        ← NeedNewKeyFrame/CreateNewKeyFrame (Tracking.cc:1914/2008).
- Stereo bootstrap ← StereoInitialization (Tracking.cc:1078).
- Velocity model   ← mVelocity update (Tracking.cc:796).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from gf_orb_slam2_tpu.config import SystemConfig, Sensor
from gf_orb_slam2_tpu.geometry import lie
from gf_orb_slam2_tpu.matching import matcher
from gf_orb_slam2_tpu.optim import pose_opt
from gf_orb_slam2_tpu.slammap.store import MapStore
from gf_orb_slam2_tpu.tracking import projection
from gf_orb_slam2_tpu.tracking.frame import Frame
from gf_orb_slam2_tpu.utils import precision


class TrackState(enum.Enum):
    """Reference: Tracking.h:189-195 eTrackingState."""

    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclasses.dataclass
class TrackStats:
    """Per-frame tracking log (reference: TrackingLog Util.hpp:187-280)."""

    frame_id: int = 0
    state: str = "OK"
    n_features: int = 0
    n_motion_matches: int = 0
    n_local_points: int = 0
    n_local_matches: int = 0
    n_inliers: int = 0
    created_kf: bool = False


def _scatter_matches(m_idx, m_valid, src_rows, n_cols):
    """Per-keypoint view of row→col matches: for each col (keypoint), the
    matching row index or -1."""
    cols = jnp.where(m_valid, m_idx, n_cols)
    out = jnp.full((n_cols + 1,), -1, jnp.int32)
    out = out.at[cols].set(jnp.where(m_valid, src_rows, -1))
    return out[:n_cols]


class Tracker:
    def __init__(self, cfg: SystemConfig, store: MapStore, n_kp: int, level_scales):
        self.cfg = cfg
        self.store = store
        self.n_kp = n_kp
        self.level_scales = np.asarray(level_scales, np.float32)
        self._scales_dev = jnp.asarray(self.level_scales)
        self.log_scale = float(np.log(cfg.orb.scale_factor))
        cam = cfg.camera
        self._cam_scalars = (
            jnp.float32(cam.fx), jnp.float32(cam.fy),
            jnp.float32(cam.cx), jnp.float32(cam.cy), jnp.float32(cam.bf),
        )
        self.state = TrackState.NO_IMAGES_YET
        self.last_frame: Optional[Frame] = None
        self.velocity: Optional[np.ndarray] = None  # 4x4 Tcl
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self.n_lost = 0
        self.relative_poses: list = []  # (frame_id, ts, T_c_refkf, ref_kf, state)
        self.stats: list = []
        L = cfg.capacity.max_local_points
        self._jit_motion = jax.jit(self._motion_step_impl)
        self._jit_refkf = jax.jit(self._refkf_step_impl)
        self._jit_local = jax.jit(self._local_step_impl)
        self._jit_reloc = jax.jit(self._reloc_step_impl)
        self._jit_fused = jax.jit(self._fused_track_impl)
        self._jit_fused_packed = jax.jit(self._fused_packed_impl)
        # single-buffer transfer layouts: the per-frame upload and fetch are
        # packed into one uint32 array each (utils/packing.py)
        from gf_orb_slam2_tpu.utils.packing import Layout

        N = n_kp
        self._up_layout = Layout([
            ("R0", (3, 3), "f32"), ("t0", (3,), "f32"),
            ("R_init", (3, 3), "f32"), ("t_init", (3,), "f32"),
            ("pt_pos", (N, 3), "f32"), ("pt_oct", (N,), "i32"),
            ("pt_valid", (N,), "bool"), ("pt_desc", (N, 8), "u32"),
            ("loc_pos", (L, 3), "f32"), ("loc_normal", (L, 3), "f32"),
            ("loc_mind", (L,), "f32"), ("loc_maxd", (L,), "f32"),
            ("loc_desc", (L, 8), "u32"), ("loc_valid", (L,), "bool"),
            ("loc_life", (L,), "f32"),
            ("radius", (), "f32"), ("extra", (), "f32"), ("seed", (), "i32"),
        ])
        self._out_layout = Layout([
            ("uv", (N, 2), "f32"), ("octave", (N,), "i32"),
            ("angle", (N,), "f32"), ("desc", (N, 8), "u32"),
            ("response", (N,), "f32"), ("valid", (N,), "bool"),
            ("u_right", (N,), "f32"), ("depth", (N,), "f32"),
            ("kp_row_m", (N,), "i32"), ("m_inl", (N,), "bool"),
            ("kp_row_l", (N,), "i32"), ("kp_row_add", (N,), "i32"),
            ("l_inl", (N,), "bool"),
            ("R", (3, 3), "f32"), ("t", (3,), "f32"),
            ("n_inliers", (), "i32"), ("n_vis", (), "i32"),
        ])
        # streaming pipeline: per-frame upload carries ONLY the (stale) local
        # pool INDICES + per-point lifetimes — point data (pos/normal/dists/
        # desc) is gathered on device from the resident map mirror
        # (slammap/device_mirror.py); pose prediction and last-frame match
        # state chain across frames as device arrays (no host round trip in
        # the dependency path)
        self._stream_up_layout = Layout([
            ("pool_ids", (L,), "i32"), ("loc_life", (L,), "f32"),
            ("radius", (), "f32"), ("extra", (), "f32"), ("seed", (), "i32"),
        ])
        self._stream_out_layout = Layout([
            ("uv", (N, 2), "f32"), ("octave", (N,), "i32"),
            ("angle", (N,), "f32"), ("desc", (N, 8), "u32"),
            ("response", (N,), "f32"), ("valid", (N,), "bool"),
            ("u_right", (N,), "f32"), ("depth", (N,), "f32"),
            ("kp_row_m", (N,), "i32"), ("m_inl", (N,), "bool"),
            ("kp_row_l", (N,), "i32"),
            ("mp", (N,), "i32"), ("mp_extra", (N,), "i32"),
            ("R", (3, 3), "f32"), ("t", (3,), "f32"),
            ("n_inliers", (), "i32"), ("n_vis", (), "i32"),
        ])
        self._jit_stream = jax.jit(self._stream_step_impl)
        self._chain = None  # device-resident chained tracking state
        self._cached_pool = None  # (ids, device loc arrays) for the fused path
        # rigid world-frame rebase pending from a loop correction / GBA
        # write-back (X_new = R_D X_old + t_D); applied to the tracking state
        # (last pose, device chain) before the next dispatch
        self.pending_map_rebase = None
        self._rebase_jit = None
        self._last_reloc_frame = -10**9
        self.kfdb = None  # set by System once place recognition is up
        self.mih = None   # set by System when hashing is enabled
        from gf_orb_slam2_tpu.tracking.kinematics import OdometryBuffer

        self.odom = OdometryBuffer()  # planner-predicted motion (opt-in)

    # ================================================== device programs
    def _motion_step_impl(
        self, R0, t0, R_init, t_init, pt_pos, pt_oct, pt_valid, pt_desc,
        kp_uv, kp_oct, kp_ur, kp_valid, kp_desc, radius,
    ):
        """(R0,t0): extrapolated prediction — used ONLY to center the search
        windows. (R_init,t_init): last frame's pose — the optimizer start.
        Initializing the solve from the extrapolation compounds the weakly
        observable lateral↔yaw valley error ×2 per frame (measured: ×2.4
        divergence); the last pose carries it unamplified."""
        fx, fy, cx, cy, bf = self._cam_scalars
        pc = lie.transform(R0, t0, pt_pos)
        z = jnp.where(jnp.abs(pc[..., 2]) < 1e-8, 1e-8, pc[..., 2])
        uv = jnp.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], -1)
        m = matcher.search_by_projection(
            uv, pt_oct, pt_valid & (pc[..., 2] > 0), pt_desc,
            kp_uv, kp_oct, kp_valid, kp_desc,
            radius=radius, level_scales=self._scales_dev,
        )
        n = self.n_kp
        kp_row = _scatter_matches(m.idx, m.valid, jnp.arange(pt_pos.shape[0], dtype=jnp.int32), n)
        kp_mp_pos = jnp.where((kp_row >= 0)[:, None], pt_pos[jnp.maximum(kp_row, 0)], 0.0)
        kp_mp_valid = kp_row >= 0
        inv_sigma2 = 1.0 / self._scales_dev[jnp.clip(kp_oct, 0, len(self.level_scales) - 1)] ** 2
        res = pose_opt.pose_optimization(
            R_init, t_init, kp_mp_pos, kp_uv, jnp.where(kp_mp_valid, kp_ur, -1.0),
            inv_sigma2, kp_mp_valid, fx, fy, cx, cy, bf,
            rounds=self.cfg.tracking.pose_opt_rounds,
            iters=self.cfg.tracking.pose_opt_iters,
        )
        return res, kp_row, kp_mp_valid

    def _refkf_step_impl(
        self, R0, t0, ref_desc, ref_valid, ref_angle, pt_pos, pt_valid,
        kp_uv, kp_oct, kp_ur, kp_valid, kp_desc, kp_angle,
    ):
        """ref rows (KF keypoints with map points) → current keypoints."""
        m = matcher.match_all(ref_desc, ref_valid & pt_valid, kp_desc, kp_valid,
                              th=matcher.TH_LOW, nn_ratio=0.7, mutual=False)
        m = matcher.rotation_consistency(ref_angle, kp_angle, m)
        n = self.n_kp
        kp_row = _scatter_matches(m.idx, m.valid, jnp.arange(ref_desc.shape[0], dtype=jnp.int32), n)
        kp_mp_pos = jnp.where((kp_row >= 0)[:, None], pt_pos[jnp.maximum(kp_row, 0)], 0.0)
        kp_mp_valid = kp_row >= 0
        fx, fy, cx, cy, bf = self._cam_scalars
        inv_sigma2 = 1.0 / self._scales_dev[jnp.clip(kp_oct, 0, len(self.level_scales) - 1)] ** 2
        res = pose_opt.pose_optimization(
            R0, t0, kp_mp_pos, kp_uv, jnp.where(kp_mp_valid, kp_ur, -1.0),
            inv_sigma2, kp_mp_valid, fx, fy, cx, cy, bf,
        )
        return res, kp_row, kp_mp_valid

    def _reloc_step_impl(
        self, ref_desc, ref_valid, pt_pos,
        kp_uv, kp_oct, kp_ur, kp_valid, kp_desc, rng_key,
    ):
        """Relocalization against one candidate KF: descriptor match → PnP
        RANSAC → LM polish (reference: Relocalization Tracking.cc:2615 —
        SearchByBoW + PnPsolver::iterate + PoseOptimization)."""
        from gf_orb_slam2_tpu.tracking.pnp import pnp_ransac

        fx, fy, cx, cy, bf = self._cam_scalars
        m = matcher.match_all(ref_desc, ref_valid, kp_desc, kp_valid,
                              th=matcher.TH_LOW, nn_ratio=0.75, mutual=False)
        n = self.n_kp
        kp_row = _scatter_matches(m.idx, m.valid, jnp.arange(ref_desc.shape[0], dtype=jnp.int32), n)
        kp_mp_pos = jnp.where((kp_row >= 0)[:, None], pt_pos[jnp.maximum(kp_row, 0)], 0.0)
        kp_mp_valid = kp_row >= 0
        pnp = pnp_ransac(kp_mp_pos, kp_uv, kp_mp_valid, fx, fy, cx, cy, rng_key)
        inv_sigma2 = 1.0 / self._scales_dev[jnp.clip(kp_oct, 0, len(self.level_scales) - 1)] ** 2
        res = pose_opt.pose_optimization(
            pnp.R, pnp.t, kp_mp_pos, kp_uv, jnp.where(kp_mp_valid, kp_ur, -1.0),
            inv_sigma2, kp_mp_valid, fx, fy, cx, cy, bf,
        )
        return res, kp_row, pnp.ok

    def _fused_track_impl(
        self, R0, t0, R_init, t_init, pt_pos, pt_oct, pt_valid, pt_desc,
        loc_pos, loc_normal, loc_mind, loc_maxd, loc_desc, loc_valid, loc_life,
        kp_uv, kp_oct, kp_ur, kp_valid, kp_desc, radius, extra_radius, seed,
    ):
        """Motion-model step + local-map step chained in ONE device program.

        The local candidate pool is the one gathered after the PREVIOUS frame
        (one frame stale — at tracking frame rates the covisible set barely
        moves). Removes two host↔device synchronizations per frame.
        """
        res_m, kp_row_m, kp_mp_valid_m = self._motion_step_impl(
            R0, t0, R_init, t_init, pt_pos, pt_oct, pt_valid, pt_desc,
            kp_uv, kp_oct, kp_ur, kp_valid, kp_desc, radius,
        )
        kp_mp_pos = jnp.where(
            (kp_row_m >= 0)[:, None], pt_pos[jnp.maximum(kp_row_m, 0)], 0.0
        )
        kp_mp_valid = kp_mp_valid_m & res_m.inliers
        rng_key = jax.random.PRNGKey(seed)  # built on-device (no extra upload)
        loc_already = jnp.zeros(loc_pos.shape[0], bool)
        res_l, kp_row_l, kp_row_add, new_valid, n_vis = self._local_step_impl(
            res_m.R, res_m.t,
            loc_pos, loc_normal, loc_mind, loc_maxd, loc_desc, loc_valid,
            loc_life, loc_already,
            kp_uv, kp_oct, kp_ur, kp_valid, kp_desc,
            kp_mp_pos, kp_mp_valid, extra_radius, rng_key,
        )
        return (res_m, kp_row_m, res_l, kp_row_l, kp_row_add, n_vis)

    def _local_step_impl(
        self, R0, t0,
        loc_pos, loc_normal, loc_mind, loc_maxd, loc_desc, loc_valid,
        loc_life, loc_already,
        kp_uv, kp_oct, kp_ur, kp_valid, kp_desc,
        kp_mp_pos, kp_mp_valid, extra_radius, rng_key,
    ):
        from gf_orb_slam2_tpu.config import GFMatchingMode

        fx, fy, cx, cy, bf = self._cam_scalars
        cam = self.cfg.camera
        proj = projection.project_points(
            R0, t0, loc_pos, loc_normal, loc_mind, loc_maxd, loc_valid,
            fx, fy, cx, cy, cam.width, cam.height,
            n_levels=len(self.level_scales), log_scale=self.log_scale,
        )
        pool = proj.visible & ~loc_already
        full_pool = pool
        gf_cfg = self.cfg.good_feature
        mode = gf_cfg.matching_mode
        if gf_cfg.enabled and mode != GFMatchingMode.ALL:
            from gf_orb_slam2_tpu.selection import good_feature, observability

            if mode == GFMatchingMode.GOOD_FEATURE:
                # GOOD FEATURE branch (reference: Tracking.cc:2348-2377 →
                # Observability::runActiveMapMatching): restrict the search
                # to the Max-logDet subset when the pool is large.
                R_wc = R0.T
                q_wc = lie.rot_to_quat(R_wc)
                center = -precision.matmul(R_wc, t0)
                inv2_pt = 1.0 / self._scales_dev[
                    jnp.clip(proj.pred_octave, 0, len(self.level_scales) - 1)
                ] ** 2
                is_stereo_sensor = self.cfg.sensor != Sensor.MONOCULAR
                stereo_mask = jnp.full(loc_pos.shape[0], is_stereo_sensor)
                if gf_cfg.info_mat_size == 13:
                    # hybrid full-state mode (reference: Tracking.cc:271-274
                    # USE_HYBRID_INFO_MATRIX → 13x13 over [p,q,v,ω])
                    obs_mats = observability.info_matrices_13(
                        q_wc, center, loc_pos, fx, fy, bf, stereo_mask,
                        inv2_pt, pool,
                    )
                    base = jnp.sum(observability.info_matrices_13(
                        q_wc, center, kp_mp_pos, fx, fy, bf,
                        jnp.full(kp_mp_pos.shape[0], is_stereo_sensor),
                        jnp.ones(kp_mp_pos.shape[0], obs_mats.dtype),
                        kp_mp_valid, kine_prior=0.0,
                    ), axis=0)
                else:
                    obs_mats = observability.info_matrices(
                        q_wc, center, loc_pos, fx, fy, bf, stereo_mask,
                        inv2_pt, pool,
                    )
                    base = observability.pose_info_from_frame(
                        q_wc, center, kp_mp_pos, fx, fy, bf,
                        jnp.full(kp_mp_pos.shape[0], is_stereo_sensor),
                        jnp.ones(kp_mp_pos.shape[0], obs_mats.dtype),
                        kp_mp_valid,
                    )
                sel, _ = good_feature.lazier_greedy_select(
                    obs_mats, pool, gf_cfg.constr_per_frame, rng_key,
                    lazier_factor=gf_cfg.lazier_factor, base_mat=base,
                )
            elif mode == GFMatchingMode.RANDOM:
                sel, _ = good_feature.random_select(
                    pool, gf_cfg.constr_per_frame, rng_key)
            elif mode == GFMatchingMode.LONG_LIVED:
                sel, _ = good_feature.long_lived_select(
                    loc_life, pool, gf_cfg.constr_per_frame)
            else:  # BUCKETING
                sel, _ = good_feature.bucketing_select(
                    proj.uv, loc_life, pool, gf_cfg.constr_per_frame,
                    float(cam.width), float(cam.height))
            use_sel = jnp.sum(pool.astype(jnp.int32)) >= gf_cfg.min_pool
            pool = jnp.where(use_sel, pool & sel, pool)
        radius = jnp.where(proj.view_cos > 0.998, 2.5, 4.0) * extra_radius
        m = matcher.search_by_projection(
            proj.uv, proj.pred_octave, pool, loc_desc,
            kp_uv, kp_oct, kp_valid & ~kp_mp_valid, kp_desc,
            radius=radius, level_scales=self._scales_dev,
            th=matcher.TH_HIGH, nn_ratio=0.8,
        )
        n = self.n_kp
        kp_row = _scatter_matches(m.idx, m.valid, jnp.arange(loc_pos.shape[0], dtype=jnp.int32), n)
        new_valid = kp_mp_valid | (kp_row >= 0)
        new_pos = jnp.where(
            (kp_row >= 0)[:, None], loc_pos[jnp.maximum(kp_row, 0)], kp_mp_pos
        )
        inv_sigma2 = 1.0 / self._scales_dev[jnp.clip(kp_oct, 0, len(self.level_scales) - 1)] ** 2
        res = pose_opt.pose_optimization(
            R0, t0, new_pos, kp_uv, jnp.where(new_valid, kp_ur, -1.0),
            inv_sigma2, new_valid, fx, fy, cx, cy, bf,
            rounds=self.cfg.tracking.pose_opt_rounds,
            iters=self.cfg.tracking.pose_opt_iters,
        )
        kp_row_add = jnp.full((n,), -1, jnp.int32)
        if gf_cfg.enabled and gf_cfg.search_additional and mode != GFMatchingMode.ALL:
            # Reference: Tracking::SearchAdditionalMatchesInFrame
            # (src/Tracking.cc:2119) — after the pose solve, match the
            # LEFTOVER (unselected) candidates to still-free keypoints. In
            # the reference this runs AFTER the keyframe decision, so the
            # extra matches only enrich the next frame's motion model — they
            # are returned SEPARATELY here and merged host-side post-KF-policy
            # (merging early inflates n_tracked and starves KF creation).
            leftover = full_pool & ~pool
            # reference searches at HALF the usual window (th=0.5,
            # Tracking.cc:2160): the refined pose is trusted and a tight
            # window keeps aliased associations out of the map
            m2 = matcher.search_by_projection(
                proj.uv, proj.pred_octave, leftover, loc_desc,
                kp_uv, kp_oct, kp_valid & ~new_valid & ~kp_mp_valid, kp_desc,
                radius=radius * 0.5, level_scales=self._scales_dev,
                th=matcher.TH_HIGH, nn_ratio=0.8,
            )
            kp_row2 = _scatter_matches(
                m2.idx, m2.valid, jnp.arange(loc_pos.shape[0], dtype=jnp.int32), n)
            add = (kp_row < 0) & ~kp_mp_valid & (kp_row2 >= 0)
            pos2 = loc_pos[jnp.maximum(kp_row2, 0)]
            pc = lie.transform(res.R, res.t, pos2)
            z = jnp.maximum(pc[..., 2], 1e-8)
            du = fx * pc[..., 0] / z + cx - kp_uv[:, 0]
            dv = fy * pc[..., 1] / z + cy - kp_uv[:, 1]
            chi2 = (du * du + dv * dv) * inv_sigma2
            add = add & (chi2 <= 5.991) & (pc[..., 2] > 1e-4)
            kp_row_add = jnp.where(add, kp_row2, -1)
        n_visible = jnp.sum(proj.visible.astype(jnp.int32))
        return res, kp_row, kp_row_add, new_valid, n_visible

    def _fused_packed_impl(self, upload, uv, octv, ang, desc, resp, val, ur, dep):
        """Packed-transfer wrapper of the fused step: ONE uint32 upload in,
        ONE uint32 result (frame block + tracking block) out."""
        u = self._up_layout.unpack_jnp(upload)
        res_m, kp_row_m, res_l, kp_row_l, kp_row_add, n_vis = self._fused_track_impl(
            u["R0"], u["t0"], u["R_init"], u["t_init"],
            u["pt_pos"], u["pt_oct"], u["pt_valid"], u["pt_desc"],
            u["loc_pos"], u["loc_normal"], u["loc_mind"], u["loc_maxd"],
            u["loc_desc"], u["loc_valid"], u["loc_life"],
            uv, octv, ur, val, desc, u["radius"], u["extra"], u["seed"],
        )
        return self._out_layout.pack_jnp(dict(
            uv=uv, octave=octv, angle=ang, desc=desc, response=resp,
            valid=val, u_right=ur, depth=dep,
            kp_row_m=kp_row_m, m_inl=res_m.inliers, kp_row_l=kp_row_l,
            kp_row_add=kp_row_add, l_inl=res_l.inliers,
            R=res_l.R, t=res_l.t, n_inliers=res_l.n_inliers, n_vis=n_vis,
        ))

    def _stream_step_impl(self, upload, uv, octv, ang, desc, resp, val, ur,
                          dep, chain, mirror):
        """Streaming tracking step: the pose prediction AND the previous
        frame's match state arrive as device arrays chained from the previous
        step — the host never sits in the frame-to-frame dependency path, so
        steps for consecutive frames pipeline on the device while the host
        fetches results a few frames behind. The candidate pool's point data
        is gathered from the device-resident map `mirror` by index.

        JAX replacement for the reference's tracking-thread pipeline
        (Tracking::Track per frame + thread_Predict overlap, Tracking.cc:594,
        868-873): instead of overlapping host threads, the recurrent state
        (pose, velocity, matched-landmark set) stays device-resident.
        """
        u = self._stream_up_layout.unpack_jnp(upload)
        pool_idx = u["pool_ids"]
        pool_ok = pool_idx >= 0
        pool_c = jnp.maximum(pool_idx, 0)
        u = dict(
            u,
            loc_pos=mirror["pos"][pool_c],
            loc_normal=mirror["normal"][pool_c],
            loc_mind=mirror["mind"][pool_c],
            loc_maxd=mirror["maxd"][pool_c],
            loc_desc=mirror["desc"][pool_c],
            loc_valid=pool_ok,
            loc_ids=pool_idx,
        )
        R1, t1 = chain["R1"], chain["t1"]      # pose of frame N-1
        R2, t2 = chain["R2"], chain["t2"]      # pose of frame N-2
        # constant-velocity prediction on device: V = T1·T2⁻¹, Tpred = V·T1
        # (mirrors Tracker._predict_pose / _update_velocity)
        Rv = precision.matmul(R1, R2.T)
        tv = t1 - precision.matmul(Rv, t2)
        R0 = precision.matmul(Rv, R1)
        t0 = precision.matmul(Rv, t1) + tv
        res_m, kp_row_m, res_l, kp_row_l, kp_row_add, n_vis = \
            self._fused_track_impl(
                R0, t0, R1, t1,
                chain["pt_pos"], chain["pt_oct"], chain["pt_valid"],
                chain["pt_desc"],
                u["loc_pos"], u["loc_normal"], u["loc_mind"], u["loc_maxd"],
                u["loc_desc"], u["loc_valid"], u["loc_life"],
                uv, octv, ur, val, desc, u["radius"], u["extra"], u["seed"],
            )
        n = self.n_kp
        BIG = jnp.int32(np.iinfo(np.int32).max)
        # association combine ON DEVICE (mirrors the host _track_fused):
        # motion matches claim first, local-map matches fill the rest,
        # id-level dedup via sorted membership, BA-style outlier clearing
        ids_m = jnp.where((kp_row_m >= 0) & res_m.inliers,
                          chain["pt_ids"][jnp.maximum(kp_row_m, 0)], -1)
        loc_g = jnp.where(kp_row_l >= 0,
                          u["loc_ids"][jnp.maximum(kp_row_l, 0)], -1)
        claimed = jnp.sort(jnp.where(ids_m >= 0, ids_m, BIG))
        j = jnp.clip(jnp.searchsorted(claimed, loc_g), 0, n - 1)
        dup = claimed[j] == loc_g
        fill = (ids_m < 0) & (loc_g >= 0) & ~dup
        mp = jnp.where(fill, loc_g, ids_m)
        mp = jnp.where((mp >= 0) & ~res_l.inliers, -1, mp)
        # leftover-candidate matches (SearchAdditionalMatchesInFrame): they
        # enrich the NEXT frame's motion model only, so they enter the chain
        # here but reach the host separately (merged post-KF-policy there)
        add_g = jnp.where(kp_row_add >= 0,
                          u["loc_ids"][jnp.maximum(kp_row_add, 0)], -1)
        claimed2 = jnp.sort(jnp.where(mp >= 0, mp, BIG))
        j2 = jnp.clip(jnp.searchsorted(claimed2, add_g), 0, n - 1)
        dup2 = claimed2[j2] == add_g
        use_a = (mp < 0) & (add_g >= 0) & ~dup2
        mp_chain = jnp.where(use_a, add_g, mp)
        pos_m = chain["pt_pos"][jnp.maximum(kp_row_m, 0)]
        desc_m = chain["pt_desc"][jnp.maximum(kp_row_m, 0)]
        pos_l = u["loc_pos"][jnp.maximum(kp_row_l, 0)]
        desc_l = u["loc_desc"][jnp.maximum(kp_row_l, 0)]
        pos_a = u["loc_pos"][jnp.maximum(kp_row_add, 0)]
        desc_a = u["loc_desc"][jnp.maximum(kp_row_add, 0)]
        pos_c = jnp.where(use_a[:, None], pos_a,
                          jnp.where(fill[:, None], pos_l, pos_m))
        desc_c = jnp.where(use_a[:, None], desc_a,
                           jnp.where(fill[:, None], desc_l, desc_m))
        next_chain = dict(
            R1=res_l.R, t1=res_l.t, R2=R1, t2=t1,
            pt_pos=pos_c, pt_oct=octv, pt_valid=mp_chain >= 0,
            pt_desc=desc_c, pt_ids=mp_chain,
        )
        packed = self._stream_out_layout.pack_jnp(dict(
            uv=uv, octave=octv, angle=ang, desc=desc, response=resp,
            valid=val, u_right=ur, depth=dep,
            kp_row_m=kp_row_m, m_inl=res_m.inliers, kp_row_l=kp_row_l,
            mp=mp, mp_extra=jnp.where(use_a, add_g, -1),
            R=res_l.R, t=res_l.t, n_inliers=res_l.n_inliers, n_vis=n_vis,
        ))
        return packed, next_chain

    # ================================================== host orchestration
    def _frame_dev(self, frame: Frame):
        """Per-frame device arrays, converted once (the kp set is used by
        motion, refkf, local and reloc steps — repeated np→device conversion
        dominated the host profile)."""
        if getattr(frame, "_dev", None) is None:
            frame._dev = (
                jnp.asarray(frame.uv), jnp.asarray(frame.octave),
                jnp.asarray(frame.u_right), jnp.asarray(frame.valid),
                jnp.asarray(frame.desc), jnp.asarray(frame.angle),
            )
        return frame._dev

    # ------------------------------------------------- map-rebase protocol
    def notify_map_rebase(self, R_D, t_D):
        """Record that the map region around the tracker was rigidly moved:
        X_new = R_D·X_old + t_D (callers: loop correction, GBA write-back —
        both hold store.lock). Without this, a correction mid-stream leaves
        the tracker's last pose / device chain in the OLD world frame while
        the mirrored map points move: projections land outside the search
        radius and tracking silently degrades (reference analogue: after
        CorrectLoop the tracker recovers via TrackReferenceKeyFrame against
        the corrected ref KF pose; the streaming chain has no such fallback
        so the state is rebased explicitly)."""
        R_D = np.asarray(R_D, np.float32)
        t_D = np.asarray(t_D, np.float32)
        if self.pending_map_rebase is None:
            self.pending_map_rebase = (R_D.copy(), t_D.copy())
        else:
            R0, t0 = self.pending_map_rebase
            self.pending_map_rebase = (R_D @ R0, R_D @ t0 + t_D)

    def apply_pending_rebase(self):
        """Apply a pending rigid map rebase to the tracking state: last-frame
        pose (T ← T∘D⁻¹) and, in streaming mode, the device chain's poses and
        cached point positions."""
        pend = self.pending_map_rebase
        if pend is None:
            return
        self.pending_map_rebase = None
        R_D, t_D = pend
        lf = self.last_frame
        if lf is not None and lf.R is not None:
            R_new = (lf.R @ R_D.T).astype(np.float32)
            lf.t = (lf.t - R_new @ t_D).astype(np.float32)
            lf.R = R_new
        if self._chain is not None:
            if self._rebase_jit is None:
                from gf_orb_slam2_tpu.utils.precision import einsum as _es
                from gf_orb_slam2_tpu.utils.precision import matmul as _mm

                def reb(chain, Rd, td):
                    out = dict(chain)
                    for k in ("1", "2"):
                        Rn = _mm(chain["R" + k], Rd.T)
                        out["R" + k] = Rn
                        out["t" + k] = chain["t" + k] - _mm(
                            Rn, td[:, None])[:, 0]
                    out["pt_pos"] = _es("ni,ji->nj", chain["pt_pos"], Rd) + td
                    return out

                self._rebase_jit = jax.jit(reb)
            self._chain = self._rebase_jit(
                self._chain, jnp.asarray(R_D), jnp.asarray(t_D))
        # host-cached pool data carries positions/normals in the old world
        # frame (the sync fused path uploads them verbatim): rebase in place
        # (streaming gathers point data from the mirror by id — unaffected)
        if self._cached_pool is not None:
            pts, loc = self._cached_pool
            loc = ((loc[0] @ R_D.T + t_D).astype(np.float32),
                   (loc[1] @ R_D.T).astype(np.float32)) + loc[2:]
            self._cached_pool = (pts, loc)

    def process_frame(self, frame: Frame) -> TrackStats:
        fusable = (
            self.state == TrackState.OK and self.velocity is not None
            and self._cached_pool is not None
            and getattr(frame, "_predispatched", None) is not None
        )
        if not fusable:
            frame.ensure_host()
        st = TrackStats(frame_id=frame.frame_id)
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            self.state = TrackState.NOT_INITIALIZED
            if self.cfg.sensor in (Sensor.STEREO, Sensor.RGBD):
                if self._stereo_initialization(frame):
                    self.state = TrackState.OK
                    st.created_kf = True
            else:
                if self._monocular_initialization(frame):
                    self.state = TrackState.OK
                    st.created_kf = True
            st.state = self.state.name
            st.n_features = frame.n_kp
            self._finish_frame(frame, st)
            return st

        ok = False
        used_fused = False
        if self.state == TrackState.OK:
            if self.velocity is not None and self._cached_pool is not None:
                ok = self._track_fused(frame, st, predispatched=getattr(frame, "_predispatched", None))
                used_fused = ok
                if not ok:
                    frame.ensure_host()
            if not ok and self.velocity is not None:
                ok = self._track_with_motion_model(frame, st)
                if not ok:
                    ok = self._track_reference_kf(frame, st)
            elif not ok:
                ok = self._track_reference_kf(frame, st)
        else:  # LOST
            ok = self._relocalize(frame, st)

        if ok and not used_fused:
            ok = self._track_local_map(frame, st)
        if ok:
            self._refresh_cached_pool(frame)

        if ok:
            self.state = TrackState.OK
            self.n_lost = 0
            if self.last_frame is not None:
                self._update_velocity(frame)
            if self._need_new_keyframe(frame):
                self._create_keyframe(frame)
                st.created_kf = True
            self._merge_additional_matches(frame)
        else:
            self.state = TrackState.LOST
            self.n_lost += 1
            self.velocity = None
        st.state = self.state.name
        st.n_features = frame.n_kp
        st.n_inliers = frame.n_matched
        self._finish_frame(frame, st)
        return st

    def _feed_ots(self, frame: Frame):
        """Per-table retrieval-utility update from this frame's matches
        (reference OTS: Tracking::UpdateQueryNumByHashTable Tracking.cc:3111)."""
        if self.mih is None or not self.cfg.hashing.enabled:
            return
        has = frame.mp_ids >= 0
        if not has.any():
            return
        self.mih.update_query_scores(
            frame.desc[has], self.store.point_desc[frame.mp_ids[has]])

    def _merge_additional_matches(self, frame: Frame):
        """Merge the leftover-candidate matches into the frame AFTER the KF
        policy ran (reference order: SearchAdditionalMatchesInFrame is called
        after CreateNewKeyFrame, Tracking.cc:878-969 → 2119 — the extra
        matches feed the next frame's motion model, not the KF decision)."""
        extra = getattr(frame, "_extra_assign", None)
        if extra is None:
            return
        claimed = set(frame.mp_ids[frame.mp_ids >= 0].tolist())
        fill = (frame.mp_ids < 0) & (extra >= 0)
        for j in np.nonzero(fill)[0]:
            e = int(extra[j])
            if e in claimed:
                continue
            frame.mp_ids[j] = e
            claimed.add(e)
        frame._extra_assign = None

    # ---------------------------------------------------------- stages
    def _predict_pose(self, ts: Optional[float] = None):
        """Search-window prediction: planner odometry when buffered
        (reference: ENABLE_PLANNER_PREDICTION README.md:87-101 +
        PredictRelMotionFromBuffer Tracking.cc:1448), else constant
        velocity."""
        T_last = self.last_frame.pose_matrix()
        rel = None
        if self.odom is not None and ts is not None and self.last_frame.timestamp is not None:
            rel = self.odom.relative_motion(self.last_frame.timestamp, ts)
        T_pred = (rel if rel is not None else self.velocity) @ T_last
        return T_pred[:3, :3].copy(), T_pred[:3, 3].copy()

    def _track_with_motion_model(self, frame: Frame, st: TrackStats) -> bool:
        lf = self.last_frame
        ids = self.store.resolve_replaced(lf.mp_ids)
        rows = ids >= 0
        pt_pos = np.zeros((self.n_kp, 3), np.float32)
        pt_desc = np.zeros((self.n_kp, 8), np.uint32)
        pt_oct = lf.octave.astype(np.int32)
        pt_pos[rows] = self.store.point_pos[ids[rows]]
        pt_desc[rows] = self.store.point_desc[ids[rows]]
        R0, t0 = self._predict_pose(frame.timestamp)
        radius = 7.0 if self.cfg.sensor != Sensor.MONOCULAR else 15.0
        kp_uv, kp_oct, kp_ur, kp_val, kp_desc, _ = self._frame_dev(frame)
        dev_in = jax.device_put((R0, t0, lf.R, lf.t, pt_pos, pt_oct, rows, pt_desc))
        res, kp_row, kp_valid0 = self._jit_motion(
            *dev_in, kp_uv, kp_oct, kp_ur, kp_val, kp_desc, jnp.float32(radius),
        )
        kp_row, inl, R_h, t_h, n_inl = jax.device_get(
            (kp_row, res.inliers, res.R, res.t, res.n_inliers)
        )
        frame.mp_ids = np.where(kp_row >= 0, ids[np.maximum(kp_row, 0)], -1).astype(np.int32)
        frame.mp_ids[~inl] = -1
        frame.R = R_h
        frame.t = t_h
        st.n_motion_matches = int((kp_row >= 0).sum())
        return int(n_inl) >= 20

    def _track_reference_kf(self, frame: Frame, st: TrackStats) -> bool:
        if self.ref_kf < 0:
            return False
        k = self.ref_kf
        s = self.store
        ref_ids = s.resolve_replaced(s.kf_point[k])
        rows = ref_ids >= 0
        pt_pos = np.zeros((self.n_kp, 3), np.float32)
        pt_pos[rows] = s.point_pos[ref_ids[rows]]
        R0 = self.last_frame.R if self.last_frame is not None else np.eye(3, dtype=np.float32)
        t0 = self.last_frame.t if self.last_frame is not None else np.zeros(3, np.float32)
        kp_uv, kp_oct, kp_ur, kp_val, kp_desc, kp_ang = self._frame_dev(frame)
        dev_in = jax.device_put((R0, t0, s.kf_desc[k], rows, s.kf_angle[k], pt_pos, rows))
        res, kp_row, _ = self._jit_refkf(
            *dev_in, kp_uv, kp_oct, kp_ur, kp_val, kp_desc, kp_ang,
        )
        kp_row, inl, R_h, t_h, n_inl = jax.device_get(
            (kp_row, res.inliers, res.R, res.t, res.n_inliers)
        )
        frame.mp_ids = np.where(kp_row >= 0, ref_ids[np.maximum(kp_row, 0)], -1).astype(np.int32)
        frame.mp_ids[~inl] = -1
        frame.R = R_h
        frame.t = t_h
        return int(n_inl) >= 15

    def _refresh_cached_pool(self, frame: Frame):
        """Build next frame's local-map candidate pool from this frame's
        matches and push it to the device asynchronously (the fused tracking
        step consumes it — one frame stale by design)."""
        s = self.store
        pts = self._gather_local_map(frame)
        if pts is None or pts.size == 0:
            # transient empty gather (post-KF bookkeeping can momentarily
            # orphan the frame's matches): KEEP the previous pool for up to
            # two frames — its ids are re-resolved against the live store at
            # completion anyway, and nulling it forced a full pipeline flush
            # + sync fallback (~0.3-1 s with the mapper queue drained). A
            # PERSISTENTLY empty gather means the track is genuinely failing:
            # drop the pool so tracking falls back to its robust paths.
            self._pool_stale_frames = getattr(self, "_pool_stale_frames", 0) + 1
            if self._pool_stale_frames > 2:
                self._cached_pool = None
            return
        self._pool_stale_frames = 0
        L = self.cfg.capacity.max_local_points
        n_loc = min(pts.size, L)
        pts = pts[:n_loc]
        pad = L - n_loc
        loc = (
            np.concatenate([s.point_pos[pts], np.zeros((pad, 3), np.float32)]),
            np.concatenate([s.point_normal[pts], np.zeros((pad, 3), np.float32)]),
            np.concatenate([s.point_min_dist[pts], np.zeros(pad, np.float32)]),
            np.concatenate([s.point_max_dist[pts], np.ones(pad, np.float32)]),
            np.concatenate([s.point_desc[pts], np.zeros((pad, 8), np.uint32)]),
            np.concatenate([np.ones(n_loc, bool), np.zeros(pad, bool)]),
            np.concatenate([s.point_found[pts].astype(np.float32),
                            np.zeros(pad, np.float32)]),
        )
        # kept as NUMPY: uploaded as part of the NEXT frame's single
        # device_put
        self._cached_pool = (pts, loc)

    def prepare_fused_host_inputs(self, ts: Optional[float], frame_id: int):
        """Build the fused step's entire host-side input as ONE packed uint32
        buffer before any device work — the caller ships it together with the
        images in a single device_put. Returns (packed_np, meta) or None."""
        if (self.state != TrackState.OK or self.velocity is None
                or self._cached_pool is None or self.last_frame is None):
            return None
        lf = self.last_frame
        s = self.store
        pool_ids, loc_np = self._cached_pool
        ids = s.resolve_replaced(lf.mp_ids)
        rows = ids >= 0
        pt_pos = np.zeros((self.n_kp, 3), np.float32)
        pt_desc = np.zeros((self.n_kp, 8), np.uint32)
        pt_pos[rows] = s.point_pos[ids[rows]]
        pt_desc[rows] = s.point_desc[ids[rows]]
        R0, t0 = self._predict_pose(ts)
        radius = 7.0 if self.cfg.sensor != Sensor.MONOCULAR else 15.0
        packed = self._up_layout.pack_np(dict(
            R0=R0, t0=t0, R_init=lf.R, t_init=lf.t,
            pt_pos=pt_pos, pt_oct=lf.octave.astype(np.int32),
            pt_valid=rows, pt_desc=pt_desc,
            loc_pos=loc_np[0], loc_normal=loc_np[1], loc_mind=loc_np[2],
            loc_maxd=loc_np[3], loc_desc=loc_np[4], loc_valid=loc_np[5],
            loc_life=loc_np[6],
            radius=np.float32(radius), extra=np.float32(1.0),
            seed=np.int32(frame_id),
        ))
        return packed, (ids, pool_ids)

    def fused_dispatch_uploaded(self, frontend_out, upload_dev, meta):
        """Dispatch the packed fused step on the frontend's DEVICE outputs
        (uv, octave, angle, desc, response, valid, u_right, depth) and the
        already-uploaded packed input buffer."""
        ids, pool_ids = meta
        uv, octv, ang, desc, resp, val, ur, dep = frontend_out
        out = self._jit_fused_packed(upload_dev, uv, octv, ang, desc, resp,
                                     val, ur, dep)
        return (out, ids, pool_ids)

    def fused_dispatch(self, frame_dev, frame_id: int, ts: Optional[float] = None):
        """Upload + dispatch from a host-materialized frame (feature-level
        entry / tests; the System image path batches the upload with the
        images instead)."""
        prep = self.prepare_fused_host_inputs(ts, frame_id)
        if prep is None:
            return None
        packed, meta = prep
        kp_uv, kp_oct, kp_ur, kp_val, kp_desc, kp_ang = frame_dev
        zeros = jnp.zeros(kp_ur.shape, jnp.float32)
        up_d = jax.device_put(packed)
        return self.fused_dispatch_uploaded(
            (kp_uv, kp_oct, kp_ang, kp_desc, zeros, kp_val, kp_ur, zeros),
            up_d, meta)

    # ---------------------------------------------------- streaming pipeline
    def stream_ready(self) -> bool:
        """Streaming needs an OK track, a velocity estimate and a pool."""
        return (self.state == TrackState.OK and self.velocity is not None
                and self._cached_pool is not None
                and self.last_frame is not None
                and self.last_frame.uv is not None)

    def stream_prepare_upload(self, frame_id: int):
        """Packed per-frame upload for the streaming step: the (stale) local
        pool ids + lifetimes + search scalars (point data lives in the device
        map mirror). Returns (packed, pool_ids)."""
        pool_ids, loc_np = self._cached_pool
        L = self.cfg.capacity.max_local_points
        ids_pad = np.full(L, -1, np.int32)
        ids_pad[: pool_ids.size] = pool_ids
        radius = 7.0 if self.cfg.sensor != Sensor.MONOCULAR else 15.0
        packed = self._stream_up_layout.pack_np(dict(
            pool_ids=ids_pad, loc_life=loc_np[6],
            radius=np.float32(radius), extra=np.float32(1.0),
            seed=np.int32(frame_id),
        ))
        return packed, pool_ids

    def stream_bootstrap_chain(self):
        """Build the initial device-resident chain state from the last
        synchronously tracked frame (one device_put; afterwards the chain
        never touches the host)."""
        lf = self.last_frame
        s = self.store
        with s.lock:
            ids = s.resolve_replaced(lf.mp_ids)
            rows = ids >= 0
            pt_pos = np.zeros((self.n_kp, 3), np.float32)
            pt_desc = np.zeros((self.n_kp, 8), np.uint32)
            pt_pos[rows] = s.point_pos[ids[rows]]
            pt_desc[rows] = s.point_desc[ids[rows]]
        T1 = lf.pose_matrix()
        V = self.velocity
        Vinv = np.eye(4, dtype=np.float32)
        Vinv[:3, :3] = V[:3, :3].T
        Vinv[:3, 3] = -V[:3, :3].T @ V[:3, 3]
        T2 = (Vinv @ T1).astype(np.float32)
        return jax.device_put(dict(
            R1=T1[:3, :3].astype(np.float32), t1=T1[:3, 3].astype(np.float32),
            R2=T2[:3, :3], t2=T2[:3, 3],
            pt_pos=pt_pos, pt_oct=lf.octave.astype(np.int32),
            pt_valid=rows, pt_desc=pt_desc,
            pt_ids=np.where(rows, ids, -1).astype(np.int32),
        ))

    def stream_dispatch(self, frontend_out, upload_dev):
        """Dispatch one streaming step; advances the device-resident chain."""
        uv, octv, ang, desc, resp, val, ur, dep = frontend_out
        packed_out, chain = self._jit_stream(
            upload_dev, uv, octv, ang, desc, resp, val, ur, dep, self._chain,
            self.store.mirror.arrays)
        self._chain = chain
        return packed_out

    def stream_complete(self, frame: Frame, raw: np.ndarray,
                        pool_ids) -> TrackStats:
        """Host bookkeeping for a pipelined frame given its fetched packed
        result buffer (the counterpart of _track_fused's post-fetch section
        plus process_frame's OK branch)."""
        s = self.store
        st = TrackStats(frame_id=frame.frame_id)
        d = self._stream_out_layout.unpack_np(raw)
        s.lock.acquire()  # host bookkeeping races the async mapping worker
        try:
            return self._stream_complete_locked(frame, d, pool_ids, st)
        finally:
            s.lock.release()

    def _stream_complete_locked(self, frame, d, pool_ids, st) -> TrackStats:
        s = self.store
        if frame.uv is None:
            frame.fill_host((d["uv"], d["octave"], d["angle"], d["desc"],
                             d["response"], d["valid"], d["u_right"],
                             d["depth"]))
        # device-side ids can be stale (points replaced/culled since the pool
        # shipped): re-resolve and drop dead ids
        mp = s.resolve_replaced(d["mp"])
        alive = (mp >= 0) & s.point_valid[np.maximum(mp, 0)]
        frame.mp_ids = np.where(alive, mp, -1).astype(np.int32)
        frame.is_outlier = np.zeros(self.n_kp, bool)
        frame.R = d["R"]
        frame.t = d["t"]
        st.n_motion_matches = int((d["kp_row_m"] >= 0).sum())
        st.n_local_points = int(pool_ids.size)
        st.n_local_matches = int((d["kp_row_l"] >= 0).sum())
        tracked = frame.mp_ids[frame.mp_ids >= 0]
        s.point_found[tracked] += 1
        s.point_visible[pool_ids] += 1
        self._feed_ots(frame)
        n_inl = int(d["n_inliers"])
        recently_reloc = (
            frame.frame_id - self._last_reloc_frame
            < self.cfg.tracking.max_frames_between_kf
        )
        thr = (self.cfg.tracking.min_inliers_after_reloc if recently_reloc
               else self.cfg.tracking.min_inliers_local_map)
        ok = n_inl >= thr
        if ok:
            self.state = TrackState.OK
            self.n_lost = 0
            self._refresh_cached_pool(frame)
            if self.last_frame is not None:
                self._update_velocity(frame)
            if self._need_new_keyframe(frame):
                self._create_keyframe(frame)
                st.created_kf = True
            extra = s.resolve_replaced(d["mp_extra"])
            extra_alive = (extra >= 0) & s.point_valid[np.maximum(extra, 0)]
            frame._extra_assign = np.where(extra_alive, extra, -1)
            self._merge_additional_matches(frame)
        else:
            self.state = TrackState.LOST
            self.n_lost += 1
            self.velocity = None
            self._chain = None
        st.state = self.state.name
        st.n_features = frame.n_kp
        st.n_inliers = frame.n_matched
        self._finish_frame(frame, st)
        return st

    def _track_fused(self, frame: Frame, st: TrackStats,
                     predispatched=None) -> bool:
        """One-synchronization tracking: motion + local map in one device
        program against the cached (previous-frame) candidate pool."""
        s = self.store
        if predispatched is None:
            kp_dev = self._frame_dev(frame)
            predispatched = self.fused_dispatch(kp_dev, frame.frame_id,
                                                frame.timestamp)
            if predispatched is None:
                return False
        packed_out, ids, pool_ids = predispatched
        # ONE blocking sync, ONE leaf: the packed buffer carries the frame
        # host arrays AND the tracking results
        d = self._out_layout.unpack_np(np.asarray(jax.device_get(packed_out)))
        if frame.uv is None:
            frame.fill_host((d["uv"], d["octave"], d["angle"], d["desc"],
                             d["response"], d["valid"], d["u_right"],
                             d["depth"]))
        kp_row_m, m_inl = d["kp_row_m"], d["m_inl"]
        kp_row_l, kp_row_add, l_inl = d["kp_row_l"], d["kp_row_add"], d["l_inl"]
        R_h, t_h, n_inl_d = d["R"], d["t"], d["n_inliers"]
        st.n_motion_matches = int((kp_row_m >= 0).sum())
        # combine associations: motion first, then local fills the rest
        mp = np.where(kp_row_m >= 0, ids[np.maximum(kp_row_m, 0)], -1).astype(np.int32)
        mp[~m_inl] = -1
        L = self.cfg.capacity.max_local_points
        pool_pad = np.full(L, -1, np.int64)
        pool_pad[: pool_ids.size] = pool_ids
        loc_assign = np.where(kp_row_l >= 0, pool_pad[np.maximum(kp_row_l, 0)], -1)
        fill = (mp < 0) & (loc_assign >= 0)
        # drop duplicate map ids already claimed via the motion step
        claimed = set(mp[mp >= 0].tolist())
        for j in np.nonzero(fill)[0]:
            if loc_assign[j] in claimed:
                fill[j] = False
        mp[fill] = loc_assign[fill]
        frame.mp_ids = mp
        frame.is_outlier = (frame.mp_ids >= 0) & ~l_inl
        frame.mp_ids[frame.is_outlier] = -1
        # additional (leftover) matches: merged only AFTER the KF policy
        # (reference runs SearchAdditionalMatchesInFrame after
        # CreateNewKeyFrame — see _merge_additional_matches)
        frame._extra_assign = np.where(
            kp_row_add >= 0, pool_pad[np.maximum(kp_row_add, 0)], -1
        )
        frame.R = R_h
        frame.t = t_h
        st.n_local_points = int(pool_ids.size)
        st.n_local_matches = int((kp_row_l >= 0).sum())
        tracked = frame.mp_ids[frame.mp_ids >= 0]
        s.point_found[tracked] += 1
        s.point_visible[pool_ids] += 1
        self._feed_ots(frame)
        n_inl = int(n_inl_d)
        recently_reloc = (
            frame.frame_id - self._last_reloc_frame
            < self.cfg.tracking.max_frames_between_kf
        )
        thr = (self.cfg.tracking.min_inliers_after_reloc if recently_reloc
               else self.cfg.tracking.min_inliers_local_map)
        return n_inl >= thr

    def _gather_local_map(self, frame: Frame):
        """Local map = KFs sharing points with the frame (K1) + their best
        covisible neighbors (K2), then their points
        (reference: UpdateLocalKeyFrames/UpdateLocalPoints Tracking.cc:2513/2485)."""
        s = self.store
        matched = frame.mp_ids[frame.mp_ids >= 0]
        if matched.size == 0:
            return None
        obs = s.obs_kf[matched]  # [M,O]
        flat = obs[obs >= 0]
        if flat.size == 0:
            return None
        counts = np.bincount(flat, minlength=s.cap.max_keyframes)
        k1 = np.nonzero(counts)[0]
        # K2: neighbors of K1 in covisibility (cap 10 each, reference cap 80 total)
        k2 = set(k1.tolist())
        for k in k1[np.argsort(-counts[k1])][:20]:
            for nb in s.covisible_kfs(int(k), 10):
                k2.add(int(nb))
            if len(k2) >= self.cfg.capacity.max_local_kfs:
                break
        kfs = np.fromiter(k2, int)
        kfs = kfs[s.kf_valid[kfs]]
        # reference keyframe := max-covis KF (Tracking.cc:2601)
        self.ref_kf = int(k1[np.argmax(counts[k1])])
        # local-map assembly: covisibility traversal, hash retrieval, or both
        # (reference: UpdateLocalPointsByHashing Tracking.cc:2895, modes
        # CovisOnly/HashOnly/Combined Tracking.h:197-201, trigger
        # MAP_SIZE_TRIGGER_HASHING Tracking.h:66)
        from gf_orb_slam2_tpu.config import LocalMapMode

        mode = self.cfg.tracking.local_map_mode
        use_hash = (
            self.mih is not None
            and self.cfg.hashing.enabled
            and s.n_points > self.cfg.hashing.map_size_trigger
            and mode in (LocalMapMode.HASH_ONLY, LocalMapMode.COMBINED)
        )
        if use_hash:
            hpts = self.mih.query(frame.desc[frame.valid])
            hpts = hpts[(hpts >= 0) & (hpts < s.point_valid.shape[0])]
            hpts = hpts[s.point_valid[hpts]]
            self.mih.update_dynamics(len(hpts))
            if mode == LocalMapMode.HASH_ONLY:
                pts = np.unique(hpts)
            else:
                cpts = np.unique(s.kf_point[kfs])
                pts = np.unique(np.concatenate([cpts[cpts >= 0], hpts]))
        else:
            pts = np.unique(s.kf_point[kfs])
        pts = pts[pts >= 0]
        pts = pts[s.point_valid[pts]]
        L = self.cfg.capacity.max_local_points
        if pts.size > L:
            # keep the most-observed points
            order = np.argsort(-s.point_nobs[pts], kind="stable")
            pts = pts[order[:L]]
        return pts

    def _track_local_map(self, frame: Frame, st: TrackStats) -> bool:
        s = self.store
        pts = self._gather_local_map(frame)
        if pts is None:
            return False
        L = self.cfg.capacity.max_local_points
        n_loc = pts.size
        st.n_local_points = int(n_loc)
        pad = L - n_loc
        loc_pos = np.concatenate([s.point_pos[pts], np.zeros((pad, 3), np.float32)])
        loc_normal = np.concatenate([s.point_normal[pts], np.zeros((pad, 3), np.float32)])
        loc_mind = np.concatenate([s.point_min_dist[pts], np.zeros(pad, np.float32)])
        loc_maxd = np.concatenate([s.point_max_dist[pts], np.ones(pad, np.float32)])
        loc_desc = np.concatenate([s.point_desc[pts], np.zeros((pad, 8), np.uint32)])
        loc_valid = np.concatenate([np.ones(n_loc, bool), np.zeros(pad, bool)])
        loc_life = np.concatenate([s.point_found[pts].astype(np.float32),
                                   np.zeros(pad, np.float32)])
        already = np.concatenate([np.isin(pts, frame.mp_ids[frame.mp_ids >= 0]), np.zeros(pad, bool)])
        # mark visible (reference IncreaseVisible in SearchLocalPoints)
        kp_mp_pos = np.zeros((self.n_kp, 3), np.float32)
        has = frame.mp_ids >= 0
        kp_mp_pos[has] = s.point_pos[frame.mp_ids[has]]
        extra_r = 2.0 if self.state == TrackState.LOST else 1.0
        kp_uv, kp_oct, kp_ur, kp_val, kp_desc, _ = self._frame_dev(frame)
        dev_in = jax.device_put(
            (frame.R, frame.t, loc_pos, loc_normal, loc_mind, loc_maxd,
             loc_desc, loc_valid, loc_life, already, kp_mp_pos, has)
        )
        (R0_d, t0_d, lp_d, ln_d, lmi_d, lma_d, ld_d, lv_d, ll_d, la_d,
         kmp_d, has_d) = dev_in
        res, kp_row, kp_row_add, new_valid, n_vis = self._jit_local(
            R0_d, t0_d, lp_d, ln_d, lmi_d, lma_d, ld_d, lv_d, ll_d, la_d,
            kp_uv, kp_oct, kp_ur, kp_val, kp_desc,
            kmp_d, has_d, jnp.float32(extra_r),
            jax.random.PRNGKey(frame.frame_id),
        )
        kp_row, kp_row_add, inl, R_h, t_h, n_inl_d = jax.device_get(
            (kp_row, kp_row_add, res.inliers, res.R, res.t, res.n_inliers)
        )
        pts_pad = np.concatenate([pts, np.full(pad, -1, np.int64)])
        new_ids = np.where(kp_row >= 0, pts_pad[np.maximum(kp_row, 0)], frame.mp_ids)
        frame.mp_ids = new_ids.astype(np.int32)
        frame.is_outlier = (frame.mp_ids >= 0) & ~inl
        frame.mp_ids[frame.is_outlier] = -1
        frame._extra_assign = np.where(
            kp_row_add >= 0, pts_pad[np.maximum(kp_row_add, 0)], -1
        )
        frame.R = R_h
        frame.t = t_h
        st.n_local_matches = int((kp_row >= 0).sum())
        # found/visible counters (reference IncreaseFound, Tracking.cc:1600)
        tracked = frame.mp_ids[frame.mp_ids >= 0]
        s.point_found[tracked] += 1
        s.point_visible[pts] += 1
        self._feed_ots(frame)
        n_inl = int(n_inl_d)
        recently_reloc = (
            frame.frame_id - self._last_reloc_frame
            < self.cfg.tracking.max_frames_between_kf
        )
        thr = (self.cfg.tracking.min_inliers_after_reloc if recently_reloc
               else self.cfg.tracking.min_inliers_local_map)
        return n_inl >= thr

    def _relocalize(self, frame: Frame, st: TrackStats) -> bool:
        """Relocalization (reference: Tracking.cc:2615): KF-database BoW
        candidates (when the vocabulary is up) → per-candidate descriptor
        matching + pose solve; falls back to the most recent KFs otherwise."""
        if not self.cfg.tracking.enable_reloc:
            return False
        cands: list = []
        kfdb = getattr(self, "kfdb", None)
        if kfdb is not None:
            cands = kfdb.detect_reloc_candidates(frame.desc, frame.valid)
        if not cands:
            cands = list(reversed(self.store.valid_kf_ids()[-5:].tolist()))
        s = self.store
        for k in cands:
            k = int(k)
            ref_ids = s.resolve_replaced(s.kf_point[k])
            rows = ref_ids >= 0
            if rows.sum() < 15:
                continue
            pt_pos = np.zeros((self.n_kp, 3), np.float32)
            pt_pos[rows] = s.point_pos[ref_ids[rows]]
            kp_uv, kp_oct, kp_ur, kp_val, kp_desc, _ = self._frame_dev(frame)
            dev_in = jax.device_put((s.kf_desc[k], rows & s.kf_kp_valid[k], pt_pos))
            res, kp_row, pnp_ok = self._jit_reloc(
                *dev_in, kp_uv, kp_oct, kp_ur, kp_val, kp_desc,
                jax.random.PRNGKey(frame.frame_id),
            )
            kp_row, inl, R_h, t_h, n_inl, pnp_ok_h = jax.device_get(
                (kp_row, res.inliers, res.R, res.t, res.n_inliers, pnp_ok)
            )
            if not bool(pnp_ok_h) or int(n_inl) < 15:
                continue
            frame.mp_ids = np.where(kp_row >= 0, ref_ids[np.maximum(kp_row, 0)], -1).astype(np.int32)
            frame.mp_ids[~inl] = -1
            frame.R = R_h
            frame.t = t_h
            self.ref_kf = k
            self._last_reloc_frame = frame.frame_id
            return True
        return False

    # ---------------------------------------------------------- lifecycle
    def _charuco_anchor(self, frame: Frame):
        """World-frame anchor from a ChArUco board in the first frame
        (reference: INIT_WITH_ARUCHO — Tracking uses ChArUco::process to
        set the initial pose instead of the identity, src/ChArUco.cc:92).
        Returns (R_cw, t_cw) or None."""
        if not self.cfg.charuco.enabled:
            return None
        raw = getattr(frame, "_raw_img", None)
        if raw is None:
            return None
        from gf_orb_slam2_tpu.io.charuco import CharucoBoard, detect_board_pose

        cc = self.cfg.charuco
        cam = self.cfg.camera
        K = np.asarray([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                       np.float64)
        board = CharucoBoard(cc.squares_x, cc.squares_y, cc.square_len,
                             cc.marker_len, cc.dictionary)
        try:
            return detect_board_pose(np.asarray(raw), board, K,
                                     np.zeros(5))
        except Exception:
            return None

    def _stereo_initialization(self, frame: Frame) -> bool:
        if frame.n_kp < 500:
            return False
        s = self.store
        anchor = self._charuco_anchor(frame)
        if anchor is not None:
            frame.R, frame.t = anchor
        else:
            frame.R = np.eye(3, dtype=np.float32)
            frame.t = np.zeros(3, np.float32)
        k = s.add_keyframe(
            frame.R, frame.t, frame.uv, frame.octave, frame.angle, frame.desc,
            frame.u_right, frame.depth, frame.valid, frame.frame_id, frame.timestamp,
        )
        cam = self.cfg.camera
        good = frame.valid & (frame.depth > 0)
        idxs = np.nonzero(good)[0]
        z = frame.depth[idxs]
        pc = np.stack([
            (frame.uv[idxs, 0] - cam.cx) * z / cam.fx,
            (frame.uv[idxs, 1] - cam.cy) * z / cam.fy,
            z,
        ], -1).astype(np.float32)
        # camera → world through the (possibly board-anchored) first pose
        pts = (pc - frame.t) @ frame.R
        ids = s.add_points_batch(pts, frame.desc[idxs], k, k, idxs)
        frame.mp_ids[idxs] = ids
        s.update_normals_batch(ids, self.level_scales)
        s.update_connections(k)
        self.ref_kf = k
        self.last_kf_frame_id = frame.frame_id
        return True

    def _monocular_initialization(self, frame: Frame) -> bool:
        """Reference: MonocularInitialization + CreateInitialMapMonocular
        (Tracking.cc:1141/1206): hold a reference frame, window-match, run
        the batched H/F RANSAC bootstrap, build the two-KF map, normalize
        scale to unit median depth."""
        from gf_orb_slam2_tpu.matching.matcher import match_window
        from gf_orb_slam2_tpu.tracking.initializer import initialize

        if not hasattr(self, "_mono_init_frame"):
            self._mono_init_frame = None
        if self._mono_init_frame is None or self._mono_init_frame.n_kp < 100:
            self._mono_init_frame = frame if frame.n_kp >= 100 else None
            return False
        f0 = self._mono_init_frame
        m = match_window(
            jnp.asarray(f0.uv), jnp.asarray(f0.desc), jnp.asarray(f0.valid),
            jnp.asarray(frame.uv), jnp.asarray(frame.desc), jnp.asarray(frame.valid),
            window=100.0,
        )
        n_matches = int(m.valid.sum())
        if n_matches < 100:
            self._mono_init_frame = frame if frame.n_kp >= 100 else None
            return False
        idx = np.asarray(m.idx)
        mval = np.asarray(m.valid)
        uv2 = frame.uv[np.maximum(idx, 0)]
        cam = self.cfg.camera
        K = jnp.asarray(
            [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], jnp.float32
        )
        res = initialize(
            jnp.asarray(f0.uv), jnp.asarray(uv2), jnp.asarray(mval), K,
            jax.random.PRNGKey(frame.frame_id),
        )
        if not bool(res.ok):
            return False
        # ---- build the initial map
        s = self.store
        inl = np.asarray(res.is_inlier)
        X = np.asarray(res.points)
        # scale: unit median depth (reference: ComputeSceneMedianDepth → 1)
        med = float(np.median(X[inl][:, 2]))
        if med <= 0:
            return False
        X = X / med
        R2, t2 = np.asarray(res.R), np.asarray(res.t) / med
        k0 = s.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            f0.uv, f0.octave, f0.angle, f0.desc, f0.u_right, f0.depth,
            f0.valid, f0.frame_id, f0.timestamp,
        )
        k1 = s.add_keyframe(
            R2, t2, frame.uv, frame.octave, frame.angle, frame.desc,
            frame.u_right, frame.depth, frame.valid, frame.frame_id,
            frame.timestamp,
        )
        rows = np.nonzero(inl)[0]
        cols = idx[rows].astype(np.int64)
        ids = s.add_points_batch(X[rows].astype(np.float32),
                                 frame.desc[cols], k0, k0, rows)
        s.add_observations_batch(ids, k1, cols)
        s.update_normals_batch(ids, self.level_scales)
        frame.mp_ids[cols] = ids
        s.update_connections(k0)
        s.update_connections(k1)
        frame.R, frame.t = R2, t2
        self.ref_kf = k1
        self.last_kf_frame_id = frame.frame_id
        self._mono_init_frame = None
        return True

    def _update_velocity(self, frame: Frame):
        T_cur = frame.pose_matrix()
        T_last = self.last_frame.pose_matrix()
        T_last_inv = np.eye(4, dtype=np.float32)
        T_last_inv[:3, :3] = T_last[:3, :3].T
        T_last_inv[:3, 3] = -T_last[:3, :3].T @ T_last[:3, 3]
        self.velocity = T_cur @ T_last_inv

    def _need_new_keyframe(self, frame: Frame) -> bool:
        """Reference: Tracking.cc:1914. Conditions adapted: covisibility
        ratio vs reference KF, close-point bookkeeping for stereo, frame gap."""
        tcfg = self.cfg.tracking
        if self.cfg.localization_only:
            return False
        n_kfs = len(self.store.valid_kf_ids())
        # tracked points in reference KF (min obs 2/3)
        s = self.store
        min_obs = 3 if n_kfs > 2 else 2
        ref_pts = s.kf_point[self.ref_kf]
        ref_pts = ref_pts[ref_pts >= 0]
        n_ref = int((s.point_nobs[ref_pts] >= min_obs).sum()) if ref_pts.size else 0
        if n_ref == 0:
            # degenerate early-map case (single KF: all nobs==1): fall back to
            # the ref KF's full point count so the overlap-ratio clause works
            n_ref = int(ref_pts.size)
        n_tracked = frame.n_matched
        frames_since_kf = frame.frame_id - self.last_kf_frame_id
        if self.cfg.sensor != Sensor.MONOCULAR:
            close_ok = (frame.depth > 0) & (frame.depth < self.close_depth_th)
            tracked_close = int((close_ok & (frame.mp_ids >= 0)).sum())
            untracked_close = int((close_ok & (frame.mp_ids < 0) & frame.valid).sum())
            # reference thresholds 100/70 assume ~1000-feature budgets
            # (Tracking.cc:1914); scale with the configured budget
            n_feat = self.cfg.orb.n_features
            need_close = (
                tracked_close < max(40, int(0.1 * n_feat))
                and untracked_close > max(25, int(0.07 * n_feat))
            )
        else:
            need_close = False
        ratio = 0.75 if n_kfs > 2 else 0.4
        if self.cfg.sensor == Sensor.MONOCULAR:
            ratio = 0.9
        c1a = frames_since_kf >= tcfg.max_frames_between_kf
        c1b = frames_since_kf >= tcfg.min_frames_between_kf
        # c1c (reference Tracking.cc:1984): tracking is weak — insert now
        c1c = (self.cfg.sensor != Sensor.MONOCULAR
               and n_tracked < n_ref * 0.25)
        # Starvation guard (an addition to the reference): on sweeping/yaw-dominant motion
        # with few close points, n_ref (nobs>=3 points of the ref KF) can be
        # so small that 0.75*n_ref sits BELOW the LOST threshold — tracking
        # dies before c2 ever fires. The reference leans on
        # bNeedToInsertClose for exactly this ("the key condition for stereo
        # keyframe insertion ... resolves track loss", Tracking.cc:1952-1960),
        # but that clause needs close-depth geometry; this floor generalizes
        # it: insert a KF before the inlier count decays to the LOST floor.
        starving = n_tracked < 2 * tcfg.min_inliers_local_map
        c2 = (n_tracked < n_ref * ratio or need_close) and n_tracked > 15
        return bool((c1a or (c1b and c2) or c1c or need_close or starving)
                    and n_tracked > 15)

    @property
    def close_depth_th(self) -> float:
        cam = self.cfg.camera
        return cam.th_depth * cam.baseline if cam.bf > 0 else 1e9

    def _create_keyframe(self, frame: Frame):
        """Reference: CreateNewKeyFrame Tracking.cc:2008 — register KF, bind
        tracked points, spawn new close stereo points (≤100 nearest)."""
        s = self.store
        k = s.add_keyframe(
            frame.R, frame.t, frame.uv, frame.octave, frame.angle, frame.desc,
            frame.u_right, frame.depth, frame.valid, frame.frame_id, frame.timestamp,
        )
        has = np.nonzero(frame.mp_ids >= 0)[0]
        s.add_observations_batch(frame.mp_ids[has], k, has)
        if self.cfg.sensor != Sensor.MONOCULAR:
            cand = np.nonzero(frame.valid & (frame.depth > 0) & (frame.mp_ids < 0))[0]
            if cand.size:
                order = cand[np.argsort(frame.depth[cand])]
                z = frame.depth[order]
                # reference: create ALL close points, plus the 100 nearest
                # beyond the close threshold (depth-sorted loop with break)
                keep = (z <= self.close_depth_th) | (np.arange(order.size) < 100)
                order, z = order[keep], z[keep]
                Rwc = frame.R.T
                tw = frame.center()
                cam = self.cfg.camera
                pc = np.stack([
                    (frame.uv[order, 0] - cam.cx) * z / cam.fx,
                    (frame.uv[order, 1] - cam.cy) * z / cam.fy,
                    z,
                ], -1).astype(np.float32)
                pw = pc @ Rwc.T + tw
                ids = s.add_points_batch(pw, frame.desc[order], k, k, order)
                s.update_normals_batch(ids, self.level_scales)
                frame.mp_ids[order] = ids
        s.update_connections(k)
        self.ref_kf = k
        self.last_kf_frame_id = frame.frame_id

    def _finish_frame(self, frame: Frame, st: TrackStats):
        # store relative pose to reference KF for trajectory recomposition
        # (reference: Tracking.cc:1029-1053)
        if self.ref_kf >= 0 and frame.R is not None and self.state == TrackState.OK:
            s = self.store
            T_ref = np.eye(4, dtype=np.float32)
            T_ref[:3, :3] = s.kf_R[self.ref_kf]
            T_ref[:3, 3] = s.kf_t[self.ref_kf]
            T_ref_inv = np.eye(4, dtype=np.float32)
            T_ref_inv[:3, :3] = T_ref[:3, :3].T
            T_ref_inv[:3, 3] = -T_ref[:3, :3].T @ T_ref[:3, 3]
            T_rel = frame.pose_matrix() @ T_ref_inv
            self.relative_poses.append(
                (frame.frame_id, frame.timestamp, T_rel, self.ref_kf, self.state.name)
            )
        self.stats.append(st)
        self.last_frame = frame
