"""Loop closing: detection, Sim3 verification, loop correction.

JAX replacement for the LoopClosing thread (reference:
src/LoopClosing.cc:65 Run): BoW candidate retrieval with
covisibility-consistency over 3 consecutive KFs (DetectLoop :125),
Sim3 RANSAC + guided verification (ComputeSim3 :253), and loop correction —
pose propagation to the covisible neighborhood, point fusion, essential-graph
Sim3 optimization, asynchronous global BA (CorrectLoop :424,
RunGlobalBundleAdjustment :667). Runs as a host pipeline stage per KF with
device programs for matching/Sim3/pose-graph (SURVEY.md §2.3 P1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gf_orb_slam2_tpu.config import Sensor, SystemConfig
from gf_orb_slam2_tpu.geometry import lie
from gf_orb_slam2_tpu.loopclosing.sim3solver import solve_sim3
from gf_orb_slam2_tpu.matching import matcher
from gf_orb_slam2_tpu.optim.pose_graph import PoseGraphProblem, optimize_pose_graph
from gf_orb_slam2_tpu.place.keyframe_db import KeyFrameDatabase
from gf_orb_slam2_tpu.slammap.store import MapStore


def _np_sim3_inv(s, R, t):
    """(s,R,t)⁻¹ = (1/s, Rᵀ, -(1/s)·Rᵀt) — float64-free numpy Sim3."""
    si = 1.0 / s
    Ri = R.T
    return si, Ri, (-si * (Ri @ t)).astype(np.float32)


def _np_sim3_compose(s1, R1, t1, s2, R2, t2):
    """(s1,R1,t1)∘(s2,R2,t2): x ↦ s1·R1(s2·R2 x + t2) + t1."""
    return (float(s1 * s2), (R1 @ R2).astype(np.float32),
            (s1 * (R1 @ t2) + t1).astype(np.float32))


@dataclasses.dataclass
class LoopStats:
    kf: int = -1
    n_candidates: int = 0
    loop_kf: int = -1
    n_sim3_inliers: int = 0
    corrected: bool = False
    pg_cost: float = 0.0
    n_fused: int = 0


class LoopCloser:
    def __init__(self, cfg: SystemConfig, store: MapStore, kfdb: KeyFrameDatabase):
        self.cfg = cfg
        self.store = store
        self.kfdb = kfdb
        # consistency groups: list of (set_of_kfs, count) (reference:
        # mvConsistentGroups LoopClosing.cc:216)
        self._consistent: List[Tuple[Set[int], int]] = []
        self.last_loop_kf: int = -1
        self.fix_scale = cfg.sensor != Sensor.MONOCULAR
        self._match_jit = None
        self._sim3_jit = None
        self._guided_jit = None
        self.stats: List[LoopStats] = []
        # detached global BA (reference: LoopClosing.cc:601 spawns a thread;
        # mbStopGBA aborts it when a new loop arrives)
        self._gba_thread = None
        self._gba_abort = False
        self._fuse_jit = None
        # diagnostics hook (tools/debug_loop_gate.py): called with the Sim3
        # stage inputs/outputs at each candidate evaluation; None in production
        self.sim3_debug_hook = None
        # set by System: tracker.notify_map_rebase — informs live tracking
        # that the world frame around it rigidly moved (store.lock held)
        self.map_rebase_cb = None
        self.gba_writeback_cb = None
        # set by System in async mode: pause/resume the mapping worker around
        # a correction (reference: LocalMapping::RequestStop/Release from
        # CorrectLoop, LoopClosing.cc:439/604) — a mapper BA/triangulation
        # interleaving with the correction's phases mixes world frames
        self.pause_mapping_cb = None
        self.resume_mapping_cb = None

    # ------------------------------------------------------------- pipeline
    def process_keyframe(self, kf: int) -> LoopStats:
        """Takes store.lock internally, in phases: host reads/mutations lock
        briefly; DEVICE dispatches, blocking fetches and (worst-case) jit
        compiles run UNLOCKED — in r5 the essential-graph solve compiling
        under the lock stalled the frame path 13-28 s (the tracker's per-frame
        bookkeeping needs the same lock). This matches the reference's
        protocol of stopping LocalMapping during CorrectLoop while TRACKING
        continues (LoopClosing.cc:430-460). Callers (sync pipeline or the
        async mapping worker) must NOT wrap this in the store lock."""
        st = LoopStats(kf=kf)
        self.stats.append(st)
        with self.store.lock:
            cands = self._detect_loop(kf, st)
            self.kfdb.add(kf)
        if not cands:
            return st
        hit = self._compute_sim3(kf, cands, st)
        if hit is None:
            return st
        loop_kf, s12, R12, t12, n_inl = hit
        st.loop_kf = loop_kf
        st.n_sim3_inliers = n_inl
        self._correct_loop(kf, loop_kf, s12, R12, t12, st)
        return st

    # ------------------------------------------------------------ detection
    def _detect_loop(self, kf: int, st: LoopStats) -> List[int]:
        s = self.store
        if kf < 10 or (self.last_loop_kf >= 0 and kf - self.last_loop_kf < 10):
            return []
        min_score = self.kfdb.min_covis_score(kf)
        cands = self.kfdb.detect_loop_candidates(kf, max(min_score, 1e-3))
        # temporal exclusion (see LoopClosingConfig.min_frame_gap): a loop
        # partner must be genuinely old, not a weakly-covisible neighbor
        gap = self.cfg.loop.min_frame_gap
        cands = [c for c in cands
                 if s.kf_frame_id[kf] - s.kf_frame_id[c] >= gap]
        st.n_candidates = len(cands)
        if not cands:
            self._consistent = []
            return []
        # covisibility-consistency over consecutive detections
        # (reference: LoopClosing.cc:160-250, threshold 3)
        th = self.cfg.loop.covisibility_consistency_th
        enough: List[int] = []
        new_groups: List[Tuple[Set[int], int]] = []
        for c in cands:
            group = set(int(x) for x in s.covisible_kfs(c))
            group.add(c)
            matched = False
            for prev_group, count in self._consistent:
                if group & prev_group:
                    new_groups.append((group, count + 1))
                    matched = True
                    if count + 1 >= th:
                        enough.append(c)
                    break
            if not matched:
                new_groups.append((group, 1))
        self._consistent = new_groups
        return enough

    # ----------------------------------------------------------- sim3 stage
    def _ensure_jits(self):
        """Jit the per-candidate device stages ONCE with fixed shapes
        (desc [n_kp,8], pairs padded to 256). Running them eagerly cost
        ~160 tiny compiles on the first loop event and hundreds of eager
        dispatches per candidate afterwards."""
        if self._match_jit is not None:
            return
        cam = self.cfg.camera
        fix = self.fix_scale
        mi = self.cfg.loop.min_sim3_inliers

        self._match_jit = jax.jit(lambda da, va, db, vb: matcher.match_all(
            da, va, db, vb, th=matcher.TH_LOW, nn_ratio=0.75, mutual=True))

        def sim3_full(pc1, pc2, val, key):
            res = solve_sim3(pc1, pc2, val, cam.fx, cam.fy, cam.cx, cam.cy,
                             key, fix_scale=fix, min_inliers=mi)
            # GN polish (reference: OptimizeSim3 between RANSAC and the
            # guided-projection verification, LoopClosing.cc:380) — always
            # computed (its cost is one fused program); gated on the host
            from gf_orb_slam2_tpu.loopclosing.sim3solver import optimize_sim3

            s_o, R_o, t_o, inl_o = optimize_sim3(
                res.s, res.R, res.t, pc1, pc2, res.inliers,
                cam.fx, cam.fy, cam.cx, cam.cy, fix_scale=fix)
            return res.ok, s_o, R_o, t_o, inl_o

        self._sim3_jit = jax.jit(sim3_full)

        def cam_project(p):
            z = jnp.maximum(p[..., 2], 1e-6)
            return (
                jnp.stack([cam.fx * p[..., 0] / z + cam.cx,
                           cam.fy * p[..., 1] / z + cam.cy], -1),
                p[..., 2],
            )

        def guided(s12, R12, t12, pc1, pc2, d1, d2, v1, v2):
            m = matcher.search_by_sim3(
                s12, R12, t12, pc1, pc2, d1, d2, v1, v2, cam_project)
            # the guided matches feed a SECOND Sim3 GN refinement over the
            # full mapped-keypoint correspondence set (reference: SearchBySim3
            # then OptimizeSim3 with the enlarged set, LoopClosing.cc:380-420)
            # — the RANSAC+polish estimate above it came from only the BoW
            # descriptor matches
            from gf_orb_slam2_tpu.loopclosing.sim3solver import optimize_sim3

            p2m = pc2[jnp.maximum(m.idx, 0)]
            s_r, R_r, t_r, inl = optimize_sim3(
                s12, R12, t12, pc1, p2m, m.valid,
                cam.fx, cam.fy, cam.cx, cam.cy, fix_scale=fix)
            return jnp.sum(m.valid), s_r, R_r, t_r, jnp.sum(inl)

        self._guided_jit = jax.jit(guided)

    def _ensure_fuse_jit(self):
        if self._fuse_jit is not None:
            return
        from gf_orb_slam2_tpu.matching import matcher as _m

        cam = self.cfg.camera
        scales_dev = jnp.asarray(
            np.asarray([self.cfg.orb.scale_factor ** i
                        for i in range(self.cfg.orb.n_levels)], np.float32))

        def fuse_one(dst, ids, kfm, ptm):
            ok = ids >= 0
            idc = jnp.maximum(ids, 0)
            R, t = kfm["R"][dst], kfm["t"][dst]
            pos = ptm["pos"][idc]
            pc = lie.transform(R, t, pos)
            z = jnp.where(jnp.abs(pc[..., 2]) < 1e-8, 1e-8, pc[..., 2])
            uv = jnp.stack([cam.fx * pc[..., 0] / z + cam.cx,
                            cam.fy * pc[..., 1] / z + cam.cy], -1)
            in_img = ((uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
                      & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height)
                      & (pc[..., 2] > 0))
            m = _m.search_by_projection(
                uv, jnp.zeros_like(ids), ok & in_img, ptm["desc"][idc],
                kfm["uv"][dst], kfm["oct"][dst], kfm["kpv"][dst],
                kfm["desc"][dst],
                radius=4.0, level_scales=scales_dev, th=_m.TH_LOW,
            )
            return m.idx, m.valid

        self._fuse_jit = jax.jit(
            lambda d, i, kfm, ptm: jax.vmap(
                lambda dd, ii: fuse_one(dd, ii, kfm, ptm))(d, i))

    # -------------------------------------------------------------- prewarm
    def prewarm_async(self):
        """AOT-compile (or cache-load) the loop-closing jit family on a
        daemon thread at startup — match/Sim3/guided verification, fuse,
        pose-graph buckets, and the detached-GBA segment programs — so none
        of them compiles at the FIRST loop event, mid-sequence. The
        reference spawns its LoopClosing thread at System construction
        (System.cc:117-118); this is the compile-ahead analogue."""
        from gf_orb_slam2_tpu.slammap.device_mirror import _prewarm_async

        _prewarm_async(self._prewarm)

    def prewarm_programs(self, include_gba: bool = True):
        """[(name, jitted fn, arg specs)] for the loop-closing jit family:
        what _prewarm compiles, and what the precision test lowers."""
        self._ensure_jits()
        spec = jax.ShapeDtypeStruct
        f32, b8 = jnp.float32, jnp.bool_
        n_kp = self.store.kf_desc.shape[1]
        dw = self.store.kf_desc.shape[2]
        du = jnp.dtype(self.store.kf_desc.dtype)  # u32 words, NOT u8
        progs = [
            ("match", self._match_jit, (
                spec((n_kp, dw), du), spec((n_kp,), b8),
                spec((n_kp, dw), du), spec((n_kp,), b8))),
            ("sim3", self._sim3_jit, (
                spec((256, 3), f32), spec((256, 3), f32), spec((256,), b8),
                spec((2,), jnp.uint32))),
            ("guided", self._guided_jit, (
                spec((), f32), spec((3, 3), f32), spec((3,), f32),
                spec((n_kp, 3), f32), spec((n_kp, 3), f32),
                spec((n_kp, dw), du), spec((n_kp, dw), du),
                spec((n_kp,), b8), spec((n_kp,), b8))),
        ]
        # fuse program needs the device mirrors' shapes
        s = self.store
        with s.lock:
            if s.mirror is None or s.kf_mirror is None:
                from gf_orb_slam2_tpu.slammap.device_mirror import (
                    DeviceKFMirror, DeviceMapMirror,
                )

                if s.mirror is None:
                    s.mirror = DeviceMapMirror(s)
                if s.kf_mirror is None:
                    s.kf_mirror = DeviceKFMirror(s)
        kfm = {k: spec(v.shape, v.dtype) for k, v in s.kf_mirror.arrays.items()}
        ptm = {k: spec(v.shape, v.dtype) for k, v in s.mirror.arrays.items()}
        self._ensure_fuse_jit()
        B, P = 20, self.store.n_kp
        progs.append(("loop_fuse", self._fuse_jit, (
            spec((B,), jnp.int32), spec((B, P), jnp.int32), kfm, ptm)))
        # pose-graph buckets: the dense vertex remap keeps K in the first
        # bucket for any realistically culled map; warm the two smallest
        # E buckets (rendered tour: E≈3·K)
        from gf_orb_slam2_tpu.optim.pose_graph import pose_graph_programs

        progs += pose_graph_programs(
            [(64, 256), (64, 512), (64, 1024), (64, 2048), (128, 512),
             (128, 1024)], self.fix_scale)
        if include_gba:
            from gf_orb_slam2_tpu.optim.global_ba import gba_programs

            progs += gba_programs(self.cfg)
        return progs

    def _prewarm(self, force: bool = False):
        try:
            # CPU backend (tests / CI): a BACKGROUND thread tracing and
            # compiling the pose-graph/GBA family steals most of a small
            # host's cores for minutes mid-sequence (measured: async circuit
            # inliers 230→130, ATE 0.17→1.4 with the prewarm running), so CPU
            # callers (rendered async gates) invoke _prewarm(force=True)
            # SYNCHRONOUSLY before tracking starts. On a GPU the compiles run
            # on the host CPUs too, but skipping them puts every first-use
            # compile at the first loop event, mid-sequence, so the
            # background prewarm runs there (bench.py joins it before the
            # timed loop via System.wait_prewarm).
            on_cpu = jax.default_backend() == "cpu"
            if on_cpu and not force:
                return
            # the detached-GBA segment programs are the largest compiles in
            # the family, and test maps are too small to reach their shapes
            for _, fn, args in self.prewarm_programs(include_gba=not on_cpu):
                fn.lower(*args).compile()
        except Exception:  # prewarm is best-effort; real use recompiles
            import logging

            logging.getLogger(__name__).exception("loop-closer prewarm failed")

    # ------------------------------------------------------ sim3 computation
    def _compute_sim3(self, kf: int, cands: List[int], st: LoopStats):
        s = self.store
        self._ensure_jits()
        for c in cands:
            # host-array snapshot under the lock; device work unlocked
            with s.lock:
                has_k = s.kf_point[kf] >= 0
                has_c = s.kf_point[c] >= 0
                desc_k = s.kf_desc[kf].copy()
                desc_c = s.kf_desc[c].copy()
                val_k = (has_k & s.kf_kp_valid[kf]).copy()
                val_c = (has_c & s.kf_kp_valid[c]).copy()
                kfp_k = s.kf_point[kf].copy()
                kfp_c = s.kf_point[c].copy()
            # descriptor matches between map-point-bearing keypoints
            m = self._match_jit(
                jnp.asarray(desc_k), jnp.asarray(val_k),
                jnp.asarray(desc_c), jnp.asarray(val_c),
            )
            idx, ok = jax.device_get((m.idx, m.valid))
            idx = np.asarray(idx)
            rows = np.nonzero(np.asarray(ok))[0]
            if rows.size < self.cfg.loop.min_sim3_inliers:
                continue
            N = 256
            pc1 = np.zeros((N, 3), np.float32)
            pc2 = np.zeros((N, 3), np.float32)
            val = np.zeros(N, bool)
            with s.lock:
                p1 = kfp_k[rows]
                p2 = kfp_c[idx[rows]]
                good = s.point_valid[p1] & s.point_valid[p2]
                rows, p1, p2 = rows[good], p1[good], p2[good]
                if rows.size < self.cfg.loop.min_sim3_inliers:
                    continue
                n = min(rows.size, N)
                pc1[:n] = s.point_pos[p1[:n]] @ s.kf_R[kf].T + s.kf_t[kf]
                pc2[:n] = s.point_pos[p2[:n]] @ s.kf_R[c].T + s.kf_t[c]
                val[:n] = True
            dev_in = jax.device_put((pc1, pc2, val))
            res_ok, s_o, R_o, t_o, inl_o = jax.device_get(self._sim3_jit(
                *dev_in, jax.random.PRNGKey(kf * 1000 + c)))
            if bool(res_ok):
                n_o = int(np.asarray(inl_o).sum())
                if n_o < self.cfg.loop.min_sim3_inliers:
                    continue
                # guided cross-projection verification over ALL mapped
                # keypoints of both KFs + second GN refinement on that
                # enlarged match set (reference: SearchBySim3 + OptimizeSim3
                # + the ≥40 total-matches gate, LoopClosing.cc:380-422)
                n_total, s_r, R_r, t_r, n_inl2 = self._guided_refine(
                    kf, c, s_o, R_o, t_o)
                if self.sim3_debug_hook is not None:
                    self.sim3_debug_hook(
                        kf=kf, c=c, pc1=pc1, pc2=pc2, val=val,
                        ransac=(float(s_o), np.asarray(R_o), np.asarray(t_o),
                                np.asarray(inl_o)),
                        refined=(float(s_r), np.asarray(R_r), np.asarray(t_r),
                                 int(n_inl2), int(n_total)))
                if n_total < self.cfg.loop.min_total_matches:
                    continue
                # Sim3 maps kf-camera coords → candidate-camera coords
                return (c, float(s_r), np.asarray(R_r), np.asarray(t_r),
                        max(n_o, int(n_inl2)))
        return None

    def _guided_refine(self, kf: int, c: int, s12, R12, t12):
        """Guided two-way Sim3 matching over all mapped keypoints + GN
        refinement on the match set (reference: ORBmatcher::SearchBySim3
        ORBmatcher.cc:406 + the second OptimizeSim3, LoopClosing.cc:389-399).
        Returns (n_matches, s, R, t, n_refine_inliers)."""
        s = self.store
        cam = self.cfg.camera

        def kf_points(k):
            slots = s.kf_point[k]
            valid = (slots >= 0) & s.kf_kp_valid[k]
            ids = np.maximum(slots, 0)
            pw = s.point_pos[ids]
            pc = pw @ s.kf_R[k].T + s.kf_t[k]
            valid = valid & s.point_valid[ids]
            return pc.astype(np.float32), s.kf_desc[k].copy(), valid

        with s.lock:
            pc1, d1, v1 = kf_points(kf)
            pc2, d2, v2 = kf_points(c)
        self._ensure_jits()
        dev_in = jax.device_put(
            (np.float32(s12), np.asarray(R12, np.float32),
             np.asarray(t12, np.float32), pc1, pc2, d1, d2, v1, v2))
        n, s_r, R_r, t_r, n_inl = jax.device_get(self._guided_jit(*dev_in))
        return int(n), float(s_r), np.asarray(R_r), np.asarray(t_r), int(n_inl)

    # ----------------------------------------------------- loop correction
    def _correct_loop(self, kf: int, loop_kf: int, s12, R12, t12, st: LoopStats):
        """Reference: CorrectLoop (LoopClosing.cc:424) + OptimizeEssentialGraph.

        Convention (pinned by tests/test_sim3.py::test_correct_loop_convention):
        (s12, R12, t12) maps CURRENT-KF camera coords into LOOP-KF camera
        coords (solve_sim3's pc2 ≈ s·R·pc1 + t with pc1 from kf, pc2 from
        loop_kf). The corrected world→camera Sim3 of the current KF is

            S_cw(kf) = S12⁻¹ ∘ T_cw(loop_kf)

        — a world point lands in the loop KF's camera via its (trusted) pose,
        then S12⁻¹ carries it into the current KF's camera. This equals the
        reference's mScw = gScm · T_cw(matched) with gScm mapping matched→
        current camera, i.e. gScm = our S12⁻¹ (LoopClosing.cc:300-420).
        """
        s = self.store
        # a running detached GBA solves against the PRE-correction map; its
        # write-back after this correction would clobber the corrected poses.
        # Abort it FIRST (reference: CorrectLoop stops a running GBA,
        # LoopClosing.cc:437 mbStopGBA) — and outside the lock (see the
        # join-deadlock note at _launch_global_ba below)
        self.abort_gba()
        # stop mapping for the duration of the correction (must NOT hold
        # store.lock here: the mapper's current batch needs it to finish)
        paused = False
        if self.pause_mapping_cb is not None:
            self.pause_mapping_cb()
            paused = True
        try:
            self._correct_loop_impl(kf, loop_kf, s12, R12, t12, st)
        finally:
            if paused and self.resume_mapping_cb is not None:
                self.resume_mapping_cb()

    def _correct_loop_impl(self, kf, loop_kf, s12, R12, t12, st):
        s = self.store
        with s.lock:
            # pre-correction pose snapshot: essential-graph edge measurements
            # are taken from the poses AS THEY WERE before this correction
            # (reference: NonCorrectedSim3 in OptimizeEssentialGraph,
            # Optimizer.cc:2338) — measuring from post-correction poses makes
            # every edge consistent with the current state and turns the
            # optimization into a no-op
            snap_R = s.kf_R.copy()
            snap_t = s.kf_t.copy()
            # host-side Sim3 algebra: these are a handful of 3x3 products per
            # neighborhood KF — running them as eager jnp ops paid a device
            # dispatch and fetch EACH; numpy is exact
            si, Ri, ti = _np_sim3_inv(float(s12), np.asarray(R12),
                                      np.asarray(t12))
            s_corr, R_corr, t_corr = _np_sim3_compose(
                si, Ri, ti, 1.0, s.kf_R[loop_kf], s.kf_t[loop_kf])

            # --- propagate correction to the covisible neighborhood
            neighborhood = [kf] + [int(x) for x in s.covisible_kfs(kf)]
            old_R = {k: s.kf_R[k].copy() for k in neighborhood}
            old_t = {k: s.kf_t[k].copy() for k in neighborhood}
            corr_s: Dict[int, float] = {}
            moved_mask = np.zeros(s.cap.max_map_points, bool)
            for k in neighborhood:
                # relative pose to kf (pre-correction): T_k_kf = T_k ∘ T_kf⁻¹
                R_rel = old_R[k] @ old_R[kf].T
                t_rel = old_t[k] - R_rel @ old_t[kf]
                sk, Rk_np, tk_np = _np_sim3_compose(
                    1.0, R_rel, t_rel, s_corr, R_corr, t_corr)
                corr_s[k] = sk
                # correct this KF's points: X_new = T_new⁻¹( s·T_old(X) )
                pts = s.kf_point[k]
                pts = np.unique(pts[pts >= 0])
                pts = pts[s.point_valid[pts] & ~moved_mask[pts]]
                if pts.size:
                    pc = s.point_pos[pts] @ old_R[k].T + old_t[k]
                    # X_new = S_new⁻¹(pc): re-anchor through corrected Sim3
                    s_inv, R_inv, t_inv = _np_sim3_inv(sk, Rk_np, tk_np)
                    s.point_pos[pts] = s_inv * (pc @ R_inv.T) + t_inv
                    s.mark_dirty(pts)
                    moved_mask[pts] = True
                s.set_kf_pose(k, Rk_np, tk_np / sk)
            s.kf_loop_edges.setdefault(kf, set()).add(loop_kf)
            s.kf_loop_edges.setdefault(loop_kf, set()).add(kf)
            # invalidate in-flight solves assembled against the old world
            # (mapper BA / triangulation write-backs check this version —
            # the reference's mbAbortBA)
            s.big_change_idx += 1
            # rebase live tracking onto the rigidly corrected neighborhood
            # IN THE SAME lock hold — the tracker must never observe moved
            # points with an un-rebased chain (see tracker.notify_map_rebase)
            if self.map_rebase_cb is not None:
                R_old, t_old = snap_R[kf], snap_t[kf]
                R_new, t_new = s.kf_R[kf], s.kf_t[kf]
                self.map_rebase_cb(R_new.T @ R_old,
                                   R_new.T @ (t_old - t_new))

        # --- project the loop side's points into the corrected neighborhood
        # and fuse duplicates (reference: SearchAndFuse LoopClosing.cc:609)
        st.n_fused = self._search_and_fuse(kf, loop_kf, neighborhood)
        # --- essential-graph optimization over all valid KFs (locks per
        # phase internally; notifies an incremental rebase on write-back)
        self._optimize_essential_graph(kf, loop_kf, corr_s, st,
                                       snap_R, snap_t,
                                       (float(s12), np.asarray(R12),
                                        np.asarray(t12)))
        # --- full BA in a detached, abortable thread (reference:
        # LoopClosing.cc:601 RunGlobalBundleAdjustment + mbStopGBA). Launched
        # OUTSIDE the store lock: abort_gba JOINS the previous GBA thread,
        # which may itself be blocked on store.lock inside write_back —
        # joining while holding the lock deadlocks
        self._launch_global_ba()
        self.last_loop_kf = kf
        st.corrected = True

    # --------------------------------------------------------- search & fuse
    def _search_and_fuse(self, kf: int, loop_kf: int,
                         neighborhood: List[int]) -> int:
        """Project loop-side map points into each corrected-neighborhood KF
        and merge duplicates, keeping the LOOP point (reference: SearchAndFuse
        LoopClosing.cc:609 → ORBmatcher::Fuse Scw variant ORBmatcher.cc:1089,
        pRep->Replace(pLoopMP)). Batched device program over the mirrors —
        the upload is KF indices + loop point ids."""
        s = self.store
        with s.lock:
            # loop-side point pool: loop KF + its covisible neighborhood
            loop_side = ([loop_kf]
                         + [int(x) for x in s.covisible_kfs(loop_kf, 10)])
            pts = np.unique(s.kf_point[loop_side])
            pts = pts[pts >= 0]
            pts = pts[s.point_valid[pts]]
            if pts.size == 0:
                return 0
            P = s.n_kp
            if pts.size > P:
                order = np.argsort(-s.point_nobs[pts], kind="stable")
                pts = np.sort(pts[order[:P]])
            # mirrors must see the corrected poses/positions
            if s.mirror is None or s.kf_mirror is None:
                from gf_orb_slam2_tpu.slammap.device_mirror import (
                    DeviceKFMirror, DeviceMapMirror,
                )

                if s.mirror is None:
                    s.mirror = DeviceMapMirror(s)
                if s.kf_mirror is None:
                    s.kf_mirror = DeviceKFMirror(s)
            B = 20
            dsts = (list(neighborhood) + [kf] * B)[:B]
            src_ids = np.full((B, P), -1, np.int32)
            n_dst = min(len(neighborhood), B)
            src_ids[:n_dst, : pts.size] = pts
        # device phase — UNLOCKED (syncs take their own locks)
        s.mirror.sync()
        s.kf_mirror.sync()
        self._ensure_fuse_jit()
        dev = jax.device_put((np.asarray(dsts, np.int32), src_ids))
        idx_b, ok_b = jax.device_get(
            self._fuse_jit(*dev, s.kf_mirror.arrays, s.mirror.arrays))
        fused = 0
        with s.lock:
            for bi in range(n_dst):
                dst = dsts[bi]
                rows = np.nonzero(ok_b[bi])[0]
                for r in rows:
                    p = int(src_ids[bi, r])
                    if p < 0 or not s.point_valid[p]:
                        continue
                    j = int(idx_b[bi, r])
                    q = int(s.kf_point[dst, j])
                    if q >= 0 and s.point_valid[q]:
                        if q != p:
                            # reference keeps the loop point
                            s.replace_point(q, p)
                            fused += 1
                    else:
                        s.add_observation(p, dst, j)
            for k in neighborhood:
                s.update_connections(k)
        return fused

    # ----------------------------------------------------------- global BA
    def _launch_global_ba(self):
        """Detached abortable full-map BA (reference: LoopClosing.cc:601)."""
        import threading

        from gf_orb_slam2_tpu.optim.global_ba import GlobalBARunner

        self.abort_gba()  # a new loop supersedes a running GBA
        runner = GlobalBARunner(self.store, self.cfg)
        if not runner.build():
            return
        self._gba_abort = False

        def run():
            if runner.solve(lambda: self._gba_abort):
                runner.write_back(post_cb=self.gba_writeback_cb)

        if self.cfg.loop.synchronous_gba:
            run()
            return
        self._gba_thread = threading.Thread(target=run, daemon=True)
        self._gba_thread.start()

    def abort_gba(self):
        if self._gba_thread is not None and self._gba_thread.is_alive():
            self._gba_abort = True
            self._gba_thread.join()
        self._gba_thread = None

    def wait_gba(self):
        if self._gba_thread is not None:
            self._gba_thread.join()
            self._gba_thread = None

    # pose-graph jit buckets: vertices are densely remapped (valid KFs only),
    # so K_pad stays in the small bucket for any realistic map and the
    # prewarmed programs are the ones that actually run
    PG_K_BUCKETS = (64, 128, 256)
    PG_E_BUCKETS = (256, 512, 1024, 2048, 4096)

    def _optimize_essential_graph(self, kf: int, loop_kf: int, corr_s,
                                  st: LoopStats, snap_R=None, snap_t=None,
                                  loop_sim3=None):
        """Sim3 essential-graph optimization (reference:
        Optimizer::OptimizeEssentialGraph Optimizer.cc:2338, called from
        CorrectLoop LoopClosing.cc:532).

        Reference semantics reproduced here:
        - edge MEASUREMENTS come from the PRE-correction pose snapshot
          (NonCorrectedSim3) — they encode the odometry/covisibility
          constraints as observed, so the loop-vs-odometry inconsistency is
          distributed over the whole graph;
        - VERTICES initialize at the CURRENT (corrected) poses; the corrected
          neighborhood is seeded with its per-KF Sim3 scale `corr_s`
          (CorrectedSim3, LoopClosing.cc:462-530) — inert for stereo/RGB-D
          where fix_scale pins s=1, load-bearing for monocular scale drift;
        - the NEW loop edge carries the Sim3-solver measurement S12⁻¹
          (= S_kf ∘ S_loop⁻¹), scale included;
        - the loop KF is fixed.
        """
        s = self.store
        if snap_R is None:
            snap_R, snap_t = s.kf_R, s.kf_t
        s.lock.acquire()  # build phase; released around the device solve
        kfs = np.asarray(s.valid_kf_ids(), np.int64)
        K = int(kfs.size)
        if K < 2:
            s.lock.release()
            return
        # dense remap: vertex v <- kfs[v] (slot ids grow without bound as KFs
        # are created/culled; indexing vertices by slot id walks K_pad through
        # ever-larger buckets and forces mid-sequence recompiles)
        lut = np.full(int(kfs.max()) + 2, -1, np.int32)
        lut[kfs] = np.arange(K, dtype=np.int32)
        e_i, e_j, e_R, e_t, e_s, e_w = [], [], [], [], [], []

        def add_edge(i, j, w=1.0, meas=None):
            """meas = (s_rel, R_rel, t_rel) Sim3 i←j; default from snapshot."""
            if meas is None:
                R_rel = snap_R[i] @ snap_R[j].T
                t_rel = snap_t[i] - R_rel @ snap_t[j]
                meas = (1.0, R_rel, t_rel)
            e_i.append(lut[i])
            e_j.append(lut[j])
            e_s.append(meas[0])
            e_R.append(meas[1])
            e_t.append(meas[2])
            e_w.append(w)

        new_loop_pair = (min(kf, loop_kf), max(kf, loop_kf))
        seen = {new_loop_pair}
        # the new loop edge: S_kf ∘ S_loop⁻¹ = S12⁻¹ (see _correct_loop's
        # convention note), measured by the Sim3 solver — scale included
        if loop_sim3 is not None:
            s12, R12, t12 = loop_sim3
            add_edge(kf, loop_kf, 5.0,
                     meas=_np_sim3_inv(s12, R12, t12))
        else:
            add_edge(kf, loop_kf, 5.0)
        min_w = self.cfg.loop.essential_graph_min_weight
        for k in kfs:
            k = int(k)
            parent = int(s.kf_parent[k])
            if parent >= 0 and s.kf_valid[parent]:
                if (min(k, parent), max(k, parent)) not in seen:
                    add_edge(k, parent, 1.0)
                    seen.add((min(k, parent), max(k, parent)))
            for nb in s.covisible_kfs(k):
                nb = int(nb)
                if s.covis[k, nb] >= min_w and (min(k, nb), max(k, nb)) not in seen:
                    add_edge(k, nb, 1.0)
                    seen.add((min(k, nb), max(k, nb)))
            for le in s.kf_loop_edges.get(k, ()):  # loop edges, strong weight
                if (min(k, le), max(k, le)) not in seen and s.kf_valid[le]:
                    add_edge(k, le, 5.0)
                    seen.add((min(k, le), max(k, le)))
        if not e_i:
            s.lock.release()
            return
        # bucket K and E to stable shapes so optimize_pose_graph's compiled
        # program is reused across loop events (padding: invalid vertices +
        # zero-weight self-edges at vertex 0 contribute nothing)
        K_pad = next((b for b in self.PG_K_BUCKETS if K <= b),
                     1 << int(np.ceil(np.log2(K))))
        E = len(e_i)
        E_pad = next((b for b in self.PG_E_BUCKETS if E <= b),
                     1 << int(np.ceil(np.log2(E))))
        pad = E_pad - E
        e_i = np.asarray(e_i + [0] * pad, np.int32)
        e_j = np.asarray(e_j + [0] * pad, np.int32)
        e_s = np.asarray(e_s + [1.0] * pad, np.float32)
        e_R = np.concatenate(
            [np.stack(e_R), np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))]
        ) if pad else np.stack(e_R)
        e_R = e_R.astype(np.float32)
        e_t = np.concatenate(
            [np.stack(e_t), np.zeros((pad, 3), np.float32)]
        ) if pad else np.stack(e_t)
        e_t = e_t.astype(np.float32)
        e_w = np.asarray(e_w + [0.0] * pad, np.float32)
        valid = np.zeros(K_pad, bool)
        valid[:K] = True
        fixed = np.zeros(K_pad, bool)
        fixed[lut[loop_kf]] = True  # reference fixes the loop KF
        R_pad = np.tile(np.eye(3, dtype=np.float32), (K_pad, 1, 1))
        t_pad = np.zeros((K_pad, 3), np.float32)
        s_init = np.ones(K_pad, np.float32)
        R_pad[:K] = s.kf_R[kfs]
        t_pad[:K] = s.kf_t[kfs]
        if not self.fix_scale:
            # CorrectedSim3 seed: the stored SE3 of a corrected KF is
            # (R, t/s_k); its Sim3 vertex is (s_k, R, t) — restore t = t·s_k
            for k, sk in corr_s.items():
                v = lut[k] if k < lut.size else -1
                if v >= 0:
                    s_init[v] = np.float32(sk)
                    t_pad[v] = s.kf_t[k] * np.float32(sk)
        dev = jax.device_put((s_init, R_pad, t_pad, fixed, valid, e_i, e_j,
                              e_s, e_R, e_t, e_w))
        prob = PoseGraphProblem(
            s=dev[0], R=dev[1], t=dev[2], fixed=dev[3], valid=dev[4],
            e_i=dev[5], e_j=dev[6], e_s=dev[7], e_R=dev[8],
            e_t=dev[9], e_w=dev[10],
            fix_scale=self.fix_scale,
        )
        # device solve (and worst-case its compile) runs UNLOCKED — with the
        # lock held it stalls the tracker's per-frame bookkeeping for the
        # whole solve
        s.lock.release()
        try:
            s_np, R_np, t_np, cost = jax.device_get(
                optimize_pose_graph(prob, iters=15))
        finally:
            s.lock.acquire()
        try:
            st.pg_cost = float(cost)
            pre_R_kf = s.kf_R[kf].copy()
            pre_t_kf = s.kf_t[kf].copy()
            # transform points with their reference KF's correction
            moved_mask = np.zeros(s.cap.max_map_points, bool)
            for v, k in enumerate(kfs):
                k = int(k)
                if not s.kf_valid[k]:
                    continue  # culled while the solve ran
                R_old, t_old = s.kf_R[k].copy(), s.kf_t[k].copy()
                R_new, t_new = R_np[v], t_np[v] / max(s_np[v], 1e-9)
                pts = s.kf_point[k]
                pts = np.unique(pts[pts >= 0])
                pts = pts[s.point_valid[pts] & ~moved_mask[pts]]
                if pts.size:
                    pc = s.point_pos[pts] @ R_old.T + t_old
                    pw = (pc - t_new) @ R_new
                    s.point_pos[pts] = pw
                    s.mark_dirty(pts)
                    moved_mask[pts] = True
                s.set_kf_pose(k, R_new, t_new)
            s.big_change_idx += 1  # invalidate in-flight solves (mbAbortBA)
            # incremental rebase: the essential graph moved the anchor KF a
            # bit further — notify tracking of the delta on top of the rigid
            # correction already applied
            if self.map_rebase_cb is not None:
                R_new, t_new = s.kf_R[kf], s.kf_t[kf]
                self.map_rebase_cb(R_new.T @ pre_R_kf,
                                   R_new.T @ (pre_t_kf - t_new))
        finally:
            s.lock.release()
