"""Full-map (global) bundle adjustment — abortable, all keyframes.

JAX replacement for Optimizer::GlobalBundleAdjustemnt /
BundleAdjustment (reference: src/Optimizer.cc:51/:58) and the post-loop
RunGlobalBundleAdjustment thread (src/LoopClosing.cc:601,667-780):

- covers ALL keyframes: when the map exceeds the dense-solve window, the
  trajectory is chunked into overlapping windows solved sequentially
  (poses shared with an already-solved window enter fixed — a domain
  decomposition of the pose graph; the reference solves one huge sparse
  system instead).
- abortable between device segments (reference: mbStopGBA checked inside
  g2o iterations) — `solve(should_abort)` runs each window as short LM
  segments and bails out between them.
- snapshot/write-back protocol: `build()` snapshots poses under the store
  lock; `solve()` runs WITHOUT the lock (tracking/mapping continue);
  `write_back()` re-takes the lock and re-anchors keyframes created during
  the solve through the spanning tree and un-optimized points via their
  reference KF — exactly the reference's post-GBA propagation
  (LoopClosing.cc:720-780).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from gf_orb_slam2_tpu.optim.local_ba import LocalBAProblem, local_bundle_adjustment
from gf_orb_slam2_tpu.slammap.store import MapStore

import jax
import jax.numpy as jnp

import functools


@functools.lru_cache(maxsize=None)
def _segment_jit(fx, fy, cx, cy, bf, first, second):
    """Jitted GBA segment (cached per camera + iteration split; jax.jit's
    own cache keys the problem shapes) — one dispatch per segment instead
    of hundreds of eager ops per LM iteration."""

    def run(prob):
        return local_bundle_adjustment(prob, fx, fy, cx, cy, bf,
                                       iters_first=first, iters_second=second)

    return jax.jit(run)


def gba_programs(cfg, window_kfs: int = 96, obs_cap: int = 12,
                 p_pads=(8192, 16384), segment_iters: int = 5):
    """[(name, jitted fn, arg specs)] for the GBA segment programs at the
    bench-typical window shapes, compiled ahead so the first post-loop
    global BA doesn't compile mid-run. Shapes not covered here still compile
    lazily in the detached GBA thread (which never blocks tracking)."""
    cam = cfg.camera
    spec = jax.ShapeDtypeStruct
    f32, i32, b8 = jnp.float32, jnp.int32, jnp.bool_
    K, O = window_kfs, obs_cap
    progs = []
    for P in p_pads:
        prob = LocalBAProblem(
            kf_R=spec((K, 3, 3), f32), kf_t=spec((K, 3), f32),
            kf_fixed=spec((K,), b8), kf_valid=spec((K,), b8),
            pt_pos=spec((P, 3), f32), pt_valid=spec((P,), b8),
            obs_kf=spec((P, O), i32), obs_uv=spec((P, O, 2), f32),
            obs_ur=spec((P, O), f32), obs_inv_sigma2=spec((P, O), f32),
            obs_valid=spec((P, O), b8),
        )
        for first, second in ((segment_iters, 0), (0, segment_iters)):
            progs.append((f"gba_{P}_{first}_{second}",
                          _segment_jit(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                                       first, second), (prob,)))
    return progs


class GlobalBARunner:
    def __init__(self, store: MapStore, cfg, iters: int = 20,
                 window_kfs: int = 96, max_points: int = 24576,
                 obs_cap: int = 12, segment_iters: int = 5):
        self.store = store
        self.cfg = cfg
        self.iters = iters
        self.window_kfs = window_kfs
        self.max_points = max_points
        self.obs_cap = obs_cap
        self.segment_iters = segment_iters
        self.aborted = False
        self._windows = []  # list of (kfs, pts, prob) built lazily per window
        self._results = {}  # kf id -> (R, t); point id -> pos kept separately
        self._pt_results = {}

    # ------------------------------------------------------------------ build
    def build(self) -> bool:
        """Snapshot the map (under store.lock) and partition keyframes into
        overlapping dense windows."""
        s = self.store
        with s.lock:
            # world version at snapshot: if a NEW loop correction lands while
            # this GBA solves, write_back must not clobber it (the normal
            # path aborts the GBA first — this guards the abort race)
            self._build_version = s.big_change_idx
            kfs_all = s.valid_kf_ids()
            if kfs_all.size < 2:
                return False
            W = self.window_kfs
            if kfs_all.size <= W:
                chunks = [kfs_all]
            else:
                # overlapping trajectory windows (25% overlap): each window
                # after the first holds its leading overlap fixed to stitch
                step = max(1, int(W * 0.75))
                chunks = [kfs_all[i: i + W]
                          for i in range(0, kfs_all.size - W // 4, step)]
            self._windows = [self._build_window(np.asarray(c)) for c in chunks]
        self._windows = [w for w in self._windows if w is not None]
        return bool(self._windows)

    def _build_window(self, kfs):
        s = self.store
        kf_index = {int(k): i for i, k in enumerate(kfs)}
        K = len(kfs)
        K_pad = self.window_kfs
        pts = np.unique(s.kf_point[kfs])
        pts = pts[pts >= 0]
        pts = pts[s.point_valid[pts]]
        if pts.size > self.max_points:
            order = np.argsort(-s.point_nobs[pts], kind="stable")
            pts = np.sort(pts[order[: self.max_points]])
        P = int(pts.size)
        if P == 0:
            return None
        P_pad = 1 << int(np.ceil(np.log2(max(P, 256))))
        O = self.obs_cap
        # vectorized observation packing (global-KF → window-index LUT)
        lut = np.full(s.cap.max_keyframes, -1, np.int32)
        lut[kfs] = np.arange(K, dtype=np.int32)
        okf_all = s.obs_kf[pts]
        oidx_all = s.obs_idx[pts]
        ki_all = np.where(okf_all >= 0, lut[np.maximum(okf_all, 0)], -1)
        in_win = ki_all >= 0
        order = np.argsort(~in_win, axis=1, kind="stable")[:, :O]
        obs_kf = np.take_along_axis(ki_all, order, 1).astype(np.int32)
        obs_valid = np.take_along_axis(in_win, order, 1)
        okf_sel = np.maximum(np.take_along_axis(okf_all, order, 1), 0)
        oidx_sel = np.maximum(np.take_along_axis(oidx_all, order, 1), 0)
        obs_kf[~obs_valid] = -1
        cfg = self.cfg
        scale = cfg.orb.scale_factor
        inv_sig = 1.0 / np.asarray(
            [scale ** (2 * i) for i in range(cfg.orb.n_levels)], np.float32
        )
        obs_uv = s.kf_uv[okf_sel, oidx_sel].astype(np.float32)
        obs_ur = np.where(obs_valid, s.kf_u_right[okf_sel, oidx_sel],
                          -1.0).astype(np.float32)
        obs_inv2 = inv_sig[
            np.clip(s.kf_octave[okf_sel, oidx_sel], 0, len(inv_sig) - 1)
        ].astype(np.float32)
        obs_uv[~obs_valid] = 0.0
        obs_inv2[~obs_valid] = 1.0

        def pad_to(a, n, fill=0):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: a.shape[0]] = a
            return out

        fixed = np.zeros(K_pad, bool)
        if 0 in kf_index:
            fixed[kf_index[0]] = True  # anchor KF0 (reference fixes id 0)
        # overlap stitching: KFs already solved by a previous window stay
        # fixed in this one (handled in solve(): _results membership)
        kf_valid = np.zeros(K_pad, bool)
        kf_valid[:K] = True
        prob = LocalBAProblem(
            kf_R=jnp.asarray(pad_to(s.kf_R[kfs], K_pad)),
            kf_t=jnp.asarray(pad_to(s.kf_t[kfs], K_pad)),
            kf_fixed=jnp.asarray(fixed), kf_valid=jnp.asarray(kf_valid),
            pt_pos=jnp.asarray(pad_to(s.point_pos[pts], P_pad)),
            pt_valid=jnp.asarray(pad_to(np.ones(P, bool), P_pad)),
            obs_kf=jnp.asarray(pad_to(obs_kf, P_pad, -1)),
            obs_uv=jnp.asarray(pad_to(obs_uv, P_pad)),
            obs_ur=jnp.asarray(pad_to(obs_ur, P_pad, -1.0)),
            obs_inv_sigma2=jnp.asarray(pad_to(obs_inv2, P_pad, 1.0)),
            obs_valid=jnp.asarray(pad_to(obs_valid, P_pad)),
        )
        return (kfs, pts, fixed, prob)

    # ------------------------------------------------------------------ solve
    def solve(self, should_abort: Optional[callable] = None) -> bool:
        """Run all windows as short LM segments; abort between segments
        (reference: mbStopGBA). Returns False if aborted."""
        cam = self.cfg.camera
        for (kfs, pts, fixed, prob) in self._windows:
            # freeze poses solved by earlier windows (overlap stitching)
            if self._results:
                solved = np.asarray(
                    [int(k) in self._results for k in kfs], bool)
                if solved.any():
                    fx2 = np.array(prob.kf_fixed)
                    fx2[: len(kfs)] |= solved
                    R0 = np.array(prob.kf_R)
                    t0 = np.array(prob.kf_t)
                    for i, k in enumerate(kfs):
                        if solved[i]:
                            R0[i], t0[i] = self._results[int(k)]
                    prob = prob._replace(
                        kf_fixed=jnp.asarray(fx2), kf_R=jnp.asarray(R0),
                        kf_t=jnp.asarray(t0))
            n_seg = max(1, self.iters // self.segment_iters)
            res = None
            for seg in range(n_seg):
                if should_abort is not None and should_abort():
                    self.aborted = True
                    return False
                first = self.segment_iters if seg == 0 else 0
                second = 0 if seg == 0 else self.segment_iters
                res = _segment_jit(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                                   first, second)(prob)
                prob = prob._replace(kf_R=res.kf_R, kf_t=res.kf_t,
                                     pt_pos=res.pt_pos)
            R_np = np.asarray(res.kf_R)
            t_np = np.asarray(res.kf_t)
            pt_np = np.asarray(res.pt_pos)
            for i, k in enumerate(kfs):
                if not fixed[i] and int(k) not in self._results:
                    self._results[int(k)] = (R_np[i], t_np[i])
            for i, p in enumerate(pts):
                self._pt_results[int(p)] = pt_np[i]
        return True

    # ------------------------------------------------------------- write back
    def write_back(self, post_cb=None):
        """Apply results under the store lock; keyframes/points created during
        the solve are propagated via spanning tree / reference-KF re-anchoring
        (reference: LoopClosing.cc:720-780). `post_cb(before_R, before_t)` is
        invoked at the end, lock still held — System uses it to rebase live
        tracking onto the moved world frame."""
        s = self.store
        with s.lock:
            if getattr(self, "_build_version", None) is not None and \
                    s.big_change_idx != self._build_version:
                self.aborted = True
                return  # superseded by a loop correction during the solve
            kfs_now = s.valid_kf_ids()
            # pre-correction snapshot of CURRENT poses (reference: mTcwBefGBA,
            # LoopClosing.cc:720-780). Relative child→parent transforms must
            # be computed from poses as they stand NOW — using the build-time
            # snapshot (_old_R/_old_t) breaks when the parent is itself a
            # post-snapshot KF (its slot held stale/identity contents then) or
            # was moved by local BA during the solve.
            before_R = s.kf_R.copy()
            before_t = s.kf_t.copy()
            optimized = set()
            for k in kfs_now:
                k = int(k)
                if k in self._results:
                    R, t = self._results[k]
                    s.set_kf_pose(k, R, t)
                    optimized.add(k)
            # new / unsolved KFs: child = T_child_parent_before ∘ parent_new,
            # walking the spanning tree root-ward to the nearest solved KF
            for k in kfs_now:
                k = int(k)
                if k in optimized:
                    continue
                parent = int(s.kf_parent[k])
                hops = 0
                while parent >= 0 and parent not in optimized and hops < 64:
                    parent = int(s.kf_parent[parent])
                    hops += 1
                if parent < 0 or parent not in optimized:
                    continue
                R_rel = before_R[k] @ before_R[parent].T
                t_rel = before_t[k] - R_rel @ before_t[parent]
                s.set_kf_pose(k, R_rel @ s.kf_R[parent],
                              R_rel @ s.kf_t[parent] + t_rel)
                optimized.add(k)
            # points: solved ones take their BA positions; the rest re-anchor
            # through their first observing KF's pose delta
            moved = np.zeros(s.cap.max_map_points, bool)
            solved_ids = np.asarray(
                [p for p in self._pt_results if s.point_valid[p]], np.int64)
            if solved_ids.size:
                s.point_pos[solved_ids] = np.stack(
                    [self._pt_results[int(p)] for p in solved_ids])
                s.mark_dirty(solved_ids)
                moved[solved_ids] = True
            for k in kfs_now:
                k = int(k)
                if k not in optimized:
                    continue  # no corrected pose to anchor through
                p_list = s.kf_point[k]
                p_list = np.unique(p_list[p_list >= 0])
                p_list = p_list[s.point_valid[p_list] & ~moved[p_list]]
                if not p_list.size:
                    continue
                # positions are consistent with the PRE-correction pose (even
                # for KFs created or locally-BA'd during the solve): express
                # in that camera frame, re-emit through the corrected pose
                pc = s.point_pos[p_list] @ before_R[k].T + before_t[k]
                s.point_pos[p_list] = (pc - s.kf_t[k]) @ s.kf_R[k]
                s.mark_dirty(p_list)
                moved[p_list] = True
            s.big_change_idx += 1
            if post_cb is not None:
                post_cb(before_R, before_t)


def global_bundle_adjustment(store: MapStore, cfg, iters: int = 20,
                             should_abort=None, **kw):
    """Synchronous convenience wrapper (tests / small maps): build → solve →
    write_back. Returns True if it ran to completion."""
    runner = GlobalBARunner(store, cfg, iters=iters, **kw)
    if not runner.build():
        return False
    if not runner.solve(should_abort):
        return False
    runner.write_back()
    return True
