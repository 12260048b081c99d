"""Local mapping: per-keyframe map maintenance + local BA.

JAX replacement for the LocalMapping thread (reference:
src/LocalMapping.cc:120 Run loop). The reference runs this concurrently with
tracking under the map mutex; here it runs as a host-side pipeline stage
invoked per inserted keyframe (SURVEY.md §2.3 P1 → host pipeline), with all
heavy math in jitted device programs.

Stage → reference mapping:
- process_keyframe        ← ProcessNewKeyFrame (:272): point-KF association,
  distinctive descriptors, normals, covisibility update.
- cull_recent_points      ← MapPointCulling (:325): found-ratio < 0.25 or
  too few observations after a KF grace period.
- create_new_points       ← CreateNewMapPoints (:370): epipolar-guided
  matching vs covisible KFs + DLT triangulation + acceptance checks
  (batched device program per KF pair).
- fuse_neighbors          ← SearchInNeighbors (:634): project-and-fuse
  duplicates in both directions.
- run_local_ba            ← Optimizer::LocalBundleAdjustment (Optimizer.cc:618)
  via optim/local_ba.py; good-graph KF selection plugs in here.
- cull_keyframes          ← KeyFrameCulling (:820): ≥90% redundancy rule.
"""
from __future__ import annotations

import dataclasses
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from gf_orb_slam2_tpu.config import SystemConfig, Sensor
from gf_orb_slam2_tpu.geometry import lie, triangulate
from gf_orb_slam2_tpu.matching import matcher, hamming
from gf_orb_slam2_tpu.optim.local_ba import LocalBAProblem, local_bundle_adjustment
from gf_orb_slam2_tpu.slammap.store import MapStore
from gf_orb_slam2_tpu.utils.precision import einsum


@dataclasses.dataclass
class MappingStats:
    """Per-KF mapping log (reference: MappingLog Util.hpp:282)."""

    kf: int = -1
    n_culled_points: int = 0
    n_new_points: int = 0
    n_fused: int = 0
    n_culled_kfs: int = 0
    ba_cost: float = 0.0
    ba_kfs: int = 0
    ba_points: int = 0


class LocalMapper:
    def __init__(self, cfg: SystemConfig, store: MapStore, n_kp: int, level_scales):
        self.cfg = cfg
        self.store = store
        self.n_kp = n_kp
        self.level_scales = np.asarray(level_scales, np.float32)
        self._scales_dev = jnp.asarray(self.level_scales)
        self.recent_points: List[tuple] = []  # (point_id, birth_kf)
        cam = cfg.camera
        self._K = np.array(
            [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32
        )
        self._jit_triangulate = jax.jit(self._triangulate_pair_impl)
        self._jit_fuse = jax.jit(self._fuse_impl)
        self._ba_shapes = {}
        self.stats: List[MappingStats] = []
        # dispatch→fetch wall time of each stage's device program (includes
        # the host round trip); feeds tools/mapper_timer.py
        from collections import defaultdict
        self.device_ms = defaultdict(list)
        # accumulated sub-threshold BA corrections not yet mirror-synced
        self._unsynced_drift = np.zeros(cfg.capacity.max_map_points, np.float32)

    # ------------------------------------------------------------- pipeline
    def process_keyframe(self, kf: int, skip_ba: bool = False) -> MappingStats:
        """One keyframe through the mapping stages (reference:
        LocalMapping::Run LocalMapping.cc:120). Host-side store access inside
        each stage takes store.lock so this can run on the async mapping
        worker while tracking continues; device waits release it. `skip_ba`
        mirrors the reference's BA abort when more KFs are queued
        (LocalMapping.cc mbAbortBA / CheckNewKeyFrames gate)."""
        lk = self.store.lock
        st = MappingStats(kf=kf)
        with lk:
            self._refresh_point_stats(kf)
            st.n_culled_points = self.cull_recent_points(kf)
        st.n_new_points, st.n_fused = self.create_and_fuse(kf)
        if not skip_ba:
            self.run_local_ba(kf, st)
        with lk:
            st.n_culled_kfs = self.cull_keyframes(kf)
            self.update_hash_tables(kf)
        self.stats.append(st)
        return st

    def update_hash_tables(self, kf: int):
        """Insert this KF's (possibly new/updated) points into the MIH tables
        (reference: UpdateHashTables LocalMapping.cc:948)."""
        mih = getattr(self, "mih", None)
        if mih is None or not self.cfg.hashing.enabled:
            return
        s = self.store
        pts = s.kf_point[kf]
        pts = np.unique(pts[pts >= 0])
        pts = pts[s.point_valid[pts]]
        if pts.size:
            mih.insert(s.point_desc[pts], pts.astype(np.int32))
        if self.cfg.hashing.online_table_selection:
            mih.update_table_selection()

    def _refresh_point_stats(self, kf: int):
        from gf_orb_slam2_tpu.mapping.batch_ops import refresh_points_batch

        s = self.store
        refresh_points_batch(s, s.kf_point[kf], self.level_scales)
        s.update_connections(kf)

    # -------------------------------------------------------------- culling
    def cull_recent_points(self, kf: int) -> int:
        """Reference: MapPointCulling (LocalMapping.cc:325): recently created
        points must keep found/visible ≥ 0.25 and reach ≥3 observations
        within 2-3 KFs of creation."""
        s = self.store
        n_culled = 0
        keep = []
        for p, birth in self.recent_points:
            if not s.point_valid[p]:
                continue
            age = kf - birth
            ratio = s.point_found[p] / max(1, s.point_visible[p])
            if ratio < 0.25:
                s.erase_point(p)
                n_culled += 1
            elif age >= 2 and s.point_nobs[p] <= 2:
                s.erase_point(p)
                n_culled += 1
            elif age >= 3:
                pass  # graduated
            else:
                keep.append((p, birth))
        self.recent_points = keep
        return n_culled

    # -------------------------------------------------------- triangulation
    def _triangulate_pair_impl(
        self, R1, t1, R2, t2,
        uv1, oct1, desc1, free1, ur1, uv2, oct2, desc2, free2, ur2,
    ):
        """Epipolar-guided matching + DLT for one KF pair, fully batched.

        Reference: SearchForTriangulation (ORBmatcher.cc:770) + the DLT and
        acceptance gates in CreateNewMapPoints (LocalMapping.cc:450-560).
        """
        # fundamental matrix F12 = K^-T [t]x R K^-1 with relative pose 1→2.
        # ALL matmuls here go through utils.precision (f32): at reduced
        # precision (TF32/bf16 products) the epipolar line coefficients
        # carry ~pixel-scale error and the 3.84·σ gate rejects every
        # candidate pair — the map starves.
        from gf_orb_slam2_tpu.utils.precision import matmul

        K = jnp.asarray(self._K)
        R12 = matmul(R1, R2.T)
        t12 = t1 - matmul(R12, t2[..., None])[..., 0]
        # closed-form inverse of the upper-triangular K (exact, and no
        # LAPACK call for a 3x3)
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        Kinv = jnp.asarray([[1.0 / fx, 0.0, -cx / fx],
                            [0.0, 1.0 / fy, -cy / fy],
                            [0.0, 0.0, 1.0]], K.dtype)
        E = matmul(lie.hat(t12), R12)
        F = matmul(matmul(Kinv.T, E), Kinv)
        # epipolar distance of kp2 to line of kp1: l2 = F^T? (x1' F x2 = 0)
        ones1 = jnp.concatenate([uv1, jnp.ones_like(uv1[:, :1])], -1)
        ones2 = jnp.concatenate([uv2, jnp.ones_like(uv2[:, :1])], -1)
        l2 = einsum("ni,ij->nj", ones1, F)  # [N1,3] line in image 2
        num = jnp.abs(jnp.sum(l2[:, None, :] * ones2[None, :, :], -1))
        den = jnp.sqrt(l2[:, None, 0] ** 2 + l2[:, None, 1] ** 2 + 1e-12)
        epi_d = num / den  # [N1,N2]
        sigma2 = self._scales_dev[jnp.clip(oct2, 0, len(self.level_scales) - 1)] ** 2
        epi_ok = epi_d < 3.84 * jnp.sqrt(sigma2)[None, :]
        mask = epi_ok & free1[:, None] & free2[None, :]
        dist = hamming.distance_matrix(desc1, desc2)
        best_idx, best, _ = hamming.masked_best2(dist, mask)
        accept = best <= matcher.TH_LOW
        accept = hamming.resolve_duplicates(best_idx, best, accept, uv2.shape[0])
        # triangulate accepted pairs
        P1 = triangulate.projection_matrix(K, R1, t1)
        P2 = triangulate.projection_matrix(K, R2, t2)
        uv2m = uv2[jnp.maximum(best_idx, 0)]
        Xw = triangulate.triangulate_dlt(P1, P2, uv1, uv2m)
        s1 = self._scales_dev[jnp.clip(oct1, 0, len(self.level_scales) - 1)] ** 2
        s2m = sigma2[jnp.maximum(best_idx, 0)]
        ok = triangulate.triangulation_checks(
            Xw, R1, t1, R2, t2, uv1, uv2m, K, s1, s2m,
        )
        return Xw, best_idx, accept & ok

    TRI_BATCH = 10  # padded neighbor-pair batch (one device call per KF)

    def _ensure_mirrors(self):
        """Device-resident map/KF mirrors: mapper programs gather point and
        keyframe data ON DEVICE by index, so per-KF-event uploads are a few
        KB of ids/masks instead of MBs of gathered arrays."""
        s = self.store
        # creation under the store lock: the prewarm daemon thread and the
        # pipeline may race here
        with s.lock:
            if s.mirror is None:
                from gf_orb_slam2_tpu.slammap.device_mirror import (
                    DeviceMapMirror,
                )

                s.mirror = DeviceMapMirror(s)
            if s.kf_mirror is None:
                from gf_orb_slam2_tpu.slammap.device_mirror import (
                    DeviceKFMirror,
                )

                s.kf_mirror = DeviceKFMirror(s)
        import time as _time
        _t0 = _time.perf_counter()
        s.mirror.sync()
        _t1 = _time.perf_counter()
        s.kf_mirror.sync()
        _t2 = _time.perf_counter()
        self.device_ms["mirror_pt_sync"].append((_t1 - _t0) * 1e3)
        self.device_ms["mirror_kf_sync"].append((_t2 - _t1) * 1e3)

    def _triangulate_mirror_impl(self, kf_id, kns, free_k, free_n, kfm):
        R1, t1 = kfm["R"][kf_id], kfm["t"][kf_id]
        uv1, oct1 = kfm["uv"][kf_id], kfm["oct"][kf_id]
        desc1, ur1 = kfm["desc"][kf_id], kfm["ur"][kf_id]

        def pair(kn, fn):
            return self._triangulate_pair_impl(
                R1, t1, kfm["R"][kn], kfm["t"][kn],
                uv1, oct1, desc1, free_k, ur1,
                kfm["uv"][kn], kfm["oct"][kn], kfm["desc"][kn], fn,
                kfm["ur"][kn],
            )

        return jax.vmap(pair)(kns, free_n)

    def _tri_prepare(self, kf: int):
        """Host inputs for the batched triangulation program (under lock)."""
        s = self.store
        with s.lock:
            neighbors = [int(k) for k in s.covisible_kfs(kf, self.TRI_BATCH)]
            if self.cfg.sensor != Sensor.MONOCULAR:
                # baseline check (reference: LocalMapping.cc:410)
                neighbors = [
                    kn for kn in neighbors
                    if np.linalg.norm(s.kf_center(kf) - s.kf_center(kn))
                    >= self.cfg.camera.baseline
                ]
            free_k = (s.kf_point[kf] < 0) & s.kf_kp_valid[kf]
            if not neighbors or free_k.sum() == 0:
                return None
            B = self.TRI_BATCH
            kns = (neighbors + [kf] * B)[:B]  # pad w/ self-pairs (masked)
            pair_mask = np.asarray([kn != kf for kn in kns])
            free_n = np.stack(
                [(s.kf_point[kn] < 0) & s.kf_kp_valid[kn] & (kn != kf)
                 for kn in kns]
            )
        return kns, pair_mask, free_k, free_n

    def create_new_points(self, kf: int) -> int:
        """Triangulate new points between kf and its best covisible KFs.

        All neighbor pairs run as ONE vmapped device program (a per-pair call
        would cost a host↔device round trip each); KF
        feature data is gathered on device from the KF mirror — the upload is
        just indices + free masks. Cross-pair duplicate claims are resolved
        in the host write-back.
        """
        import time as _time
        _ta = _time.perf_counter()
        s = self.store
        self._ensure_mirrors()
        prep = self._tri_prepare(kf)
        if prep is None:
            return 0
        kns, pair_mask, free_k, free_n = prep
        dev_in = jax.device_put(
            (np.int32(kf), np.asarray(kns, np.int32), free_k, free_n))
        if not hasattr(self, "_jit_triangulate_batch"):
            self._jit_triangulate_batch = jax.jit(self._triangulate_mirror_impl)
        _t0 = _time.perf_counter()
        self.device_ms["tri_pre_host"].append((_t0 - _ta) * 1e3)
        Xw_b, idx2_b, ok_b = jax.device_get(
            self._jit_triangulate_batch(*dev_in, s.kf_mirror.arrays))
        _tw = _time.perf_counter()
        self.device_ms["triangulate"].append((_tw - _t0) * 1e3)
        created = self._tri_writeback(kf, kns, pair_mask, Xw_b, idx2_b, ok_b)
        self.device_ms["tri_writeback_host"].append(
            (_time.perf_counter() - _tw) * 1e3)
        return created

    def _tri_writeback(self, kf, kns, pair_mask, Xw_b, idx2_b, ok_b,
                       v0=None) -> int:
        s = self.store
        B = self.TRI_BATCH
        created = 0
        new_ids: List[int] = []
        with s.lock:
            if v0 is not None and s.big_change_idx != v0:
                return 0  # world moved mid-solve (loop correction): discard
            for b in range(B):
                if not pair_mask[b]:
                    continue
                kn = kns[b]
                i1s = np.nonzero(ok_b[b])[0]
                if i1s.size == 0:
                    continue
                i2s = idx2_b[b, i1s].astype(np.int64)
                # skip slots claimed by an earlier pair this round (or before)
                keep = (s.kf_point[kf, i1s] < 0) & (s.kf_point[kn, i2s] < 0)
                i1s, i2s = i1s[keep], i2s[keep]
                if i1s.size == 0:
                    continue
                ids = s.add_points_batch(
                    Xw_b[b, i1s], s.kf_desc[kf, i1s], kf, kf, i1s)
                s.add_observations_batch(ids, kn, i2s)
                self.recent_points.extend((int(p), kf) for p in ids)
                new_ids.extend(int(p) for p in ids)
                created += int(i1s.size)
            if created:
                # one batched descriptor+normal/depth refresh for all new
                # points (reference: ComputeDistinctiveDescriptors +
                # UpdateNormalAndDepth per point, LocalMapping.cc:370)
                from gf_orb_slam2_tpu.mapping.batch_ops import (
                    refresh_points_batch,
                )

                refresh_points_batch(s, np.asarray(new_ids), self.level_scales)
                s.update_connections(kf)
        return created

    # ------------------------------------------------------------- fusion
    def _fuse_impl(self, R, t, pt_pos, pt_oct_hint, pt_valid, pt_desc,
                   kp_uv, kp_oct, kp_valid, kp_desc):
        """Project points into a KF and find fusion candidates
        (reference: ORBmatcher::Fuse ORBmatcher.cc:937, radius 3.0)."""
        fx = jnp.float32(self.cfg.camera.fx)
        fy = jnp.float32(self.cfg.camera.fy)
        cx = jnp.float32(self.cfg.camera.cx)
        cy = jnp.float32(self.cfg.camera.cy)
        pc = lie.transform(R, t, pt_pos)
        z = jnp.where(jnp.abs(pc[..., 2]) < 1e-8, 1e-8, pc[..., 2])
        uv = jnp.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], -1)
        in_img = (
            (uv[..., 0] >= 0) & (uv[..., 0] < self.cfg.camera.width)
            & (uv[..., 1] >= 0) & (uv[..., 1] < self.cfg.camera.height)
            & (pc[..., 2] > 0)
        )
        m = matcher.search_by_projection(
            uv, pt_oct_hint, pt_valid & in_img, pt_desc,
            kp_uv, kp_oct, kp_valid, kp_desc,
            radius=3.0, level_scales=self._scales_dev, th=matcher.TH_LOW,
        )
        return m.idx, m.valid

    FUSE_BATCH = 20  # padded (src,dst)-pair batch: one device call per KF

    def _fuse_mirror_impl(self, dsts, src_ids, kfm, ptm):
        """Gather src points from the point mirror and dst keypoints from the
        KF mirror; project-and-match per pair (vmapped)."""

        def one(dst, ids):
            ok = ids >= 0
            idc = jnp.maximum(ids, 0)
            return self._fuse_impl(
                kfm["R"][dst], kfm["t"][dst],
                ptm["pos"][idc], jnp.zeros_like(ids), ok, ptm["desc"][idc],
                kfm["uv"][dst], kfm["oct"][dst], kfm["kpv"][dst],
                kfm["desc"][dst],
            )

        return jax.vmap(one)(dsts, src_ids)

    def _fuse_prepare(self, kf: int):
        """Host inputs for the batched fuse program (under lock)."""
        s = self.store
        with s.lock:
            neighbors = [int(k)
                         for k in s.covisible_kfs(kf, self.FUSE_BATCH // 2)]
            if not neighbors:
                return None
            pairs = ([(kf, kn) for kn in neighbors]
                     + [(kn, kf) for kn in neighbors])
            B = self.FUSE_BATCH
            pairs = pairs[:B]
            P = self.n_kp
            src_ids = np.full((B, P), -1, np.int32)
            dst_list = []
            pts_list = []
            for bi, (src, dst) in enumerate(pairs):
                pts = s.kf_point[src]
                pts = np.unique(pts[pts >= 0])
                pts = pts[s.point_valid[pts]][:P]
                pts_list.append(pts)
                dst_list.append(dst)
                src_ids[bi, : pts.size] = pts
            n_pairs = len(pairs)
            if n_pairs < B:  # pad with masked dummies against kf itself
                dst_list += [kf] * (B - n_pairs)
            dsts = np.asarray(dst_list, np.int32)
        return dsts, src_ids, pts_list, dst_list, n_pairs

    def fuse_neighbors(self, kf: int) -> int:
        """Reference: SearchInNeighbors (LocalMapping.cc:634) — project kf's
        points into neighbors and vice versa; merge duplicates. All pairs run
        as one vmapped device program; the upload is point IDS + KF indices
        (data gathered from the device mirrors)."""
        import time as _time
        _ta = _time.perf_counter()
        s = self.store
        self._ensure_mirrors()
        prep = self._fuse_prepare(kf)
        if prep is None:
            return 0
        dsts, src_ids, pts_list, dst_list, n_pairs = prep
        dev_in = jax.device_put((dsts, src_ids))
        if not hasattr(self, "_jit_fuse_batch"):
            self._jit_fuse_batch = jax.jit(self._fuse_mirror_impl)
        _t0 = _time.perf_counter()
        self.device_ms["fuse_pre_host"].append((_t0 - _ta) * 1e3)
        idx_b, ok_b = jax.device_get(self._jit_fuse_batch(
            *dev_in, s.kf_mirror.arrays, s.mirror.arrays))
        _tw = _time.perf_counter()
        self.device_ms["fuse"].append((_tw - _t0) * 1e3)
        fused = self._fuse_writeback(kf, pts_list, dst_list, n_pairs,
                                     src_ids, idx_b, ok_b)
        self.device_ms["fuse_writeback_host"].append(
            (_time.perf_counter() - _tw) * 1e3)
        return fused

    def _fuse_writeback(self, kf, pts_list, dst_list, n_pairs, src_ids,
                        idx_b, ok_b, v0=None) -> int:
        s = self.store
        fused = 0
        with s.lock:
            if v0 is not None and s.big_change_idx != v0:
                return 0  # world moved mid-solve (loop correction): discard
            for bi in range(n_pairs):
                pts = pts_list[bi]
                dst = dst_list[bi]
                for r in np.nonzero(ok_b[bi])[0]:
                    p = int(pts[r]) if r < pts.size else -1
                    if p < 0 or not s.point_valid[p]:
                        continue
                    j = int(idx_b[bi, r])
                    q = int(s.kf_point[dst, j])
                    if q >= 0 and s.point_valid[q]:
                        if q != p:
                            # keep the more-observed point (reference Fuse)
                            if s.point_nobs[p] >= s.point_nobs[q]:
                                s.replace_point(q, p)
                            else:
                                s.replace_point(p, q)
                            fused += 1
                    else:
                        s.add_observation(p, dst, j)
            s.update_connections(kf)
        return fused

    # ------------------------------------------- combined triangulate+fuse
    def _tri_fuse_impl(self, kf_id, kns, free_k, free_n, dsts, src_ids,
                       kfm, ptm):
        tri = self._triangulate_mirror_impl(kf_id, kns, free_k, free_n, kfm)
        fuse = self._fuse_mirror_impl(dsts, src_ids, kfm, ptm)
        return tri, fuse

    def create_and_fuse(self, kf: int):
        """Triangulation + neighbor fusion as ONE device program / ONE
        blocking round trip / ONE mirror sync. The fusion pass covers the map as of
        this KF's insertion; points triangulated in this same call are fused
        at the NEXT KF event (the reference fuses them immediately —
        LocalMapping.cc:634 — but a one-KF fusion delay only postpones
        duplicate merging, it never loses it). Returns (created, fused)."""
        import time as _time
        _ta = _time.perf_counter()
        s = self.store
        self._ensure_mirrors()
        with s.lock:
            v0 = s.big_change_idx
        tri_prep = self._tri_prepare(kf)
        fuse_prep = self._fuse_prepare(kf)
        if tri_prep is None and fuse_prep is None:
            return 0, 0
        if tri_prep is None:
            return 0, self._fuse_finish(kf, fuse_prep, _ta)
        if fuse_prep is None:
            kns, pair_mask, free_k, free_n = tri_prep
            dev_in = jax.device_put(
                (np.int32(kf), np.asarray(kns, np.int32), free_k, free_n))
            if not hasattr(self, "_jit_triangulate_batch"):
                self._jit_triangulate_batch = jax.jit(
                    self._triangulate_mirror_impl)
            _t0 = _time.perf_counter()
            self.device_ms["tri_pre_host"].append((_t0 - _ta) * 1e3)
            Xw_b, idx2_b, ok_b = jax.device_get(
                self._jit_triangulate_batch(*dev_in, s.kf_mirror.arrays))
            _tw = _time.perf_counter()
            self.device_ms["triangulate"].append((_tw - _t0) * 1e3)
            created = self._tri_writeback(kf, kns, pair_mask, Xw_b, idx2_b,
                                          ok_b, v0=v0)
            self.device_ms["tri_writeback_host"].append(
                (_time.perf_counter() - _tw) * 1e3)
            return created, 0
        kns, pair_mask, free_k, free_n = tri_prep
        dsts, src_ids, pts_list, dst_list, n_pairs = fuse_prep
        dev_in = jax.device_put(
            (np.int32(kf), np.asarray(kns, np.int32), free_k, free_n,
             dsts, src_ids))
        if not hasattr(self, "_jit_tri_fuse"):
            self._jit_tri_fuse = jax.jit(self._tri_fuse_impl)
        _t0 = _time.perf_counter()
        self.device_ms["tri_pre_host"].append((_t0 - _ta) * 1e3)
        (Xw_b, idx2_b, ok_b), (fidx_b, fok_b) = jax.device_get(
            self._jit_tri_fuse(*dev_in, s.kf_mirror.arrays, s.mirror.arrays))
        _tw = _time.perf_counter()
        self.device_ms["triangulate"].append((_tw - _t0) * 1e3)
        created = self._tri_writeback(kf, kns, pair_mask, Xw_b, idx2_b, ok_b,
                                      v0=v0)
        fused = self._fuse_writeback(kf, pts_list, dst_list, n_pairs,
                                     src_ids, fidx_b, fok_b, v0=v0)
        self.device_ms["tri_writeback_host"].append(
            (_time.perf_counter() - _tw) * 1e3)
        return created, fused

    def _fuse_finish(self, kf, fuse_prep, _ta):
        import time as _time
        s = self.store
        dsts, src_ids, pts_list, dst_list, n_pairs = fuse_prep
        dev_in = jax.device_put((dsts, src_ids))
        if not hasattr(self, "_jit_fuse_batch"):
            self._jit_fuse_batch = jax.jit(self._fuse_mirror_impl)
        _t0 = _time.perf_counter()
        self.device_ms["fuse_pre_host"].append((_t0 - _ta) * 1e3)
        idx_b, ok_b = jax.device_get(self._jit_fuse_batch(
            *dev_in, s.kf_mirror.arrays, s.mirror.arrays))
        _tw = _time.perf_counter()
        self.device_ms["fuse"].append((_tw - _t0) * 1e3)
        fused = self._fuse_writeback(kf, pts_list, dst_list, n_pairs,
                                     src_ids, idx_b, ok_b)
        self.device_ms["fuse_writeback_host"].append(
            (_time.perf_counter() - _tw) * 1e3)
        return fused

    # ------------------------------------------------------------ local BA
    def run_local_ba(self, kf: int, st: MappingStats, good_graph_select=None):
        """Assemble the covisibility-window BA problem and solve on device.

        Reference: Optimizer::LocalBundleAdjustment (Optimizer.cc:618):
        window = kf + covisible KFs; fixed = other KFs observing the window's
        points. `good_graph_select` optionally reduces the free-KF set
        (good-graph subgraph selection, selection/good_graph.py).
        """
        import time as _time
        _ta = _time.perf_counter()
        s = self.store
        self._ensure_mirrors()
        # host assembly + dispatch run under the map lock; the lock is
        # RELEASED while the device solves (the blocking device_get below),
        # so async-mode tracking keeps its store access during the solve
        s.lock.acquire()
        # world version at assembly: a loop correction while the solve is in
        # flight moves the whole map — writing this solve back afterwards
        # would clobber corrected poses with pre-correction ones (the
        # reference aborts the BA instead: LocalMapping mbAbortBA,
        # LoopClosing.cc:437)
        v0 = s.big_change_idx
        # reference pool parity: up to 60 covisible KFs (Optimizer.h:45)
        K_CAP = min(max(self.cfg.good_graph.max_pool, 8), 60)
        O_CAP = 12
        window = [kf] + [int(k) for k in s.covisible_kfs(kf, K_CAP - 1)]
        window = window[:K_CAP]
        # points seen by window
        pts = np.unique(s.kf_point[window])
        pts = pts[pts >= 0]
        pts = pts[s.point_valid[pts]]
        P_CAP = min(self.cfg.capacity.max_local_points,
                    self.cfg.local_ba.max_points)
        if pts.size > P_CAP:
            order = np.argsort(-s.point_nobs[pts], kind="stable")
            pts = pts[order[:P_CAP]]
        if pts.size == 0 or len(window) < 2:
            s.lock.release()
            return
        # fixed KFs: observe window points but not in window (cap K_CAP)
        obs_kfs = s.obs_kf[pts]
        all_kfs = np.unique(obs_kfs[obs_kfs >= 0])
        fixed_kfs = [int(k) for k in all_kfs if k not in set(window)][: K_CAP]
        kfs = window + fixed_kfs
        K = len(kfs)
        kf_index = {k: i for i, k in enumerate(kfs)}

        P = int(pts.size)
        inv_sig = 1.0 / self.level_scales**2
        # vectorized observation packing: map global KF id -> local index via
        # a lookup table, stable-compact valid entries to the front, cap O_CAP
        lut = np.full(int(s.obs_kf[pts].max(initial=0)) + 2, -1, np.int32)
        lut[np.asarray(kfs, np.int64)] = np.arange(K, dtype=np.int32)
        okf_all = s.obs_kf[pts]                         # [P,O_store]
        oidx_all = s.obs_idx[pts]
        ki_all = np.where(okf_all >= 0, lut[np.maximum(okf_all, 0)], -1)
        in_win = ki_all >= 0
        order = np.argsort(~in_win, axis=1, kind="stable")[:, :O_CAP]
        obs_kf_arr = np.take_along_axis(ki_all, order, 1).astype(np.int32)
        obs_valid = np.take_along_axis(in_win, order, 1)
        obs_slot = np.take_along_axis(oidx_all, order, 1).astype(np.int32)
        obs_kf_arr[~obs_valid] = -1
        obs_slot[~obs_valid] = -1

        # pad P to a jit-stable bucket — only TWO buckets (1024 and the BA
        # point cap) so steady state never sees a fresh compile mid-sequence
        P_pad = min(1024, P_CAP) if P <= 1024 else P_CAP
        # K likewise: small maps use the small bucket (padding to the 60-KF
        # reference pool costs ~2.4x BA compute for nothing early on)
        K_pad = 48 if K <= 24 else 2 * K_CAP  # window + fixed

        def pad_to(arr, n, fill=0):
            out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
            out[: arr.shape[0]] = arr
            return out

        fixed_mask = np.zeros(K_pad, bool)
        fixed_mask[len(window): K] = True
        # reference: KF 0 always fixed (Optimizer.cc: pKF->mnId==0)
        for i, k in enumerate(window):
            if k == 0:
                fixed_mask[i] = True
        kf_valid = np.zeros(K_pad, bool)
        kf_valid[:K] = True

        # upload = ids + masks only; poses, positions and per-obs uv/ur/octave
        # are gathered from the device mirrors inside the jitted program
        upload = (
            pad_to(np.asarray(kfs, np.int32), K_pad, -1),
            fixed_mask, kf_valid,
            pad_to(pts.astype(np.int32), P_pad, -1),
            pad_to(obs_kf_arr, P_pad, -1),
            pad_to(obs_slot, P_pad, -1),
            pad_to(obs_valid, P_pad),
        )
        dev_up = jax.device_put(upload)
        import os as _os
        if _os.environ.get("GF_BA_DEBUG"):  # tools-only: stash assembly inputs
            self._last_ba_upload = upload
        cam = self.cfg.camera
        gg = self.cfg.good_graph
        use_gg = gg.enabled and len(window) > gg.kf_thres
        n_sel = gg.subgraph_size
        if use_gg and gg.anticipation:
            # virtual-future-KF visibility → BA budget → subgraph size
            # (reference: Optimizer.cc:648-1131)
            from gf_orb_slam2_tpu.selection.anticipation import (
                anticipated_subgraph_size,
            )

            vel = (self.velocity_provider()
                   if getattr(self, "velocity_provider", None) else None)
            n_sel = anticipated_subgraph_size(
                s, self.cfg, s.kf_R[kf], s.kf_t[kf], vel)
        # free poses ⊆ window (fixed KFs enter with fixed_mask set), so the
        # compaction cap derives from the ACTUAL window size, bucketed to two
        # shapes to avoid per-size recompiles (ADVICE r3: a hardcoded 64 would
        # silently freeze poses if the pool cap were ever raised)
        free_cap = 32 if len(window) <= 32 else ((K_CAP + 4 + 7) // 8) * 8
        assert len(window) <= free_cap, (
            f"local BA window {len(window)} exceeds free-pose cap {free_cap}")
        try:
            mirrors = (s.kf_mirror.arrays, s.mirror.arrays)
            if use_gg:
                # GOOD GRAPH: reduce the free-KF set to the Max-logDet
                # subgraph (reference: Find_Subgraph call, Optimizer.cc:1156;
                # unselected free KFs become fixed — the reduced-list rebuild
                # of Optimizer.cc:1171-1237 collapses to a mask update here).
                # Schur + lazier-greedy selection + the BA itself run as ONE
                # device program: one blocking sync instead of three.
                handle = self._run_gg_ba_jit(dev_up, mirrors,
                                             jax.random.PRNGKey(kf), cam,
                                             jnp.int32(n_sel), free_cap)
            else:
                handle = self._run_ba_jit(dev_up, mirrors, cam, free_cap)
        finally:
            s.lock.release()
        # blocking device solve — OUTSIDE the map lock
        _t0 = _time.perf_counter()
        self.device_ms["ba_assemble_host"].append((_t0 - _ta) * 1e3)
        if use_gg:
            res, sel_np = jax.device_get(handle)
            fixed_mask = fixed_mask | (~sel_np & ~fixed_mask & kf_valid)
            st.ba_kfs = int((~fixed_mask & kf_valid).sum())
        else:
            res = jax.device_get(handle)
        self.device_ms["ba_solve"].append((_time.perf_counter() - _t0) * 1e3)
        _tw = _time.perf_counter()
        # ---- write back (one batched transfer)
        with s.lock:
            if s.big_change_idx != v0:
                return  # superseded by a loop correction mid-solve
            kf_R = np.asarray(res.kf_R)[:K]
            kf_t = np.asarray(res.kf_t)[:K]
            for i, k in enumerate(kfs):
                if not fixed_mask[i]:
                    s.set_kf_pose(k, kf_R[i], kf_t[i])
            live = s.point_valid[pts]  # points culled during the solve stay dead
            new_pos = np.asarray(res.pt_pos)[:P][live]
            # only mirror-sync points that actually moved: converged BA leaves
            # most positions within noise, and each moved point costs delta
            # upload bytes (slammap/device_mirror.py). Sub-threshold
            # corrections ACCUMULATE per point (vs a compare against the
            # already-updated host value, under which repeated small BA nudges
            # would drift the device copy away without bound).
            ids_live = pts[live]
            delta = np.abs(new_pos - s.point_pos[ids_live]).max(axis=1)
            self._unsynced_drift[ids_live] += delta
            moved = self._unsynced_drift[ids_live] > 1e-4
            s.point_pos[ids_live] = new_pos
            s.mark_dirty(ids_live[moved])
            self._unsynced_drift[ids_live[moved]] = 0.0
            # outlier observation removal (reference: Optimizer.cc:1490-1520)
            inl = np.asarray(res.obs_inlier)[:P]
            bad_p, bad_o = np.nonzero(obs_valid & ~inl & live[:, None])
            for pi, o in zip(bad_p, bad_o):
                ki = obs_kf_arr[pi, o]
                s.remove_observation(int(pts[pi]), int(kfs[ki]))
        self.device_ms["ba_writeback_host"].append(
            (_time.perf_counter() - _tw) * 1e3)
        st.ba_cost = float(res.final_cost)
        if not use_gg:
            st.ba_kfs = len(window)
        st.ba_points = P

    def _build_problem_on_device(self, up, kfm, ptm) -> LocalBAProblem:
        """Assemble the LocalBAProblem INSIDE the jitted program: poses,
        positions and per-observation uv/u_right/octave are gathered from the
        device mirrors — the host uploads only ids and masks."""
        kfs_pad, fixed_mask, kf_valid, pts_pad, obs_kf_arr, obs_slot, obs_valid = up
        kcl = jnp.maximum(kfs_pad, 0)
        pcl = jnp.maximum(pts_pad, 0)
        okf_g = kcl[jnp.maximum(obs_kf_arr, 0)]          # [P,O] global KF ids
        slot = jnp.maximum(obs_slot, 0)
        inv_sig = 1.0 / self._scales_dev ** 2
        oct_ = jnp.clip(kfm["oct"][okf_g, slot], 0, len(self.level_scales) - 1)
        return LocalBAProblem(
            kf_R=kfm["R"][kcl], kf_t=kfm["t"][kcl],
            kf_fixed=fixed_mask, kf_valid=kf_valid & (kfs_pad >= 0),
            pt_pos=ptm["pos"][pcl], pt_valid=pts_pad >= 0,
            obs_kf=jnp.where(obs_valid, obs_kf_arr, -1),
            obs_uv=jnp.where(obs_valid[..., None], kfm["uv"][okf_g, slot], 0.0),
            obs_ur=jnp.where(obs_valid, kfm["ur"][okf_g, slot], -1.0),
            obs_inv_sigma2=jnp.where(obs_valid, inv_sig[oct_], 1.0),
            obs_valid=obs_valid,
        )

    def _get_ba_jit(self, P_pad, K_pad, O, free_cap):
        key = ("ba", P_pad, K_pad, O, free_cap)
        if key not in self._ba_shapes:
            lb = self.cfg.local_ba
            cam = self.cfg.camera

            def run(u, kfm, ptm):
                pr = self._build_problem_on_device(u, kfm, ptm)
                return local_bundle_adjustment(
                    pr, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                    iters_first=lb.iters_first, iters_second=lb.iters_second,
                    free_cap=free_cap,
                )

            self._ba_shapes[key] = jax.jit(run)
        return self._ba_shapes[key]

    def _run_ba_jit(self, up, mirrors, cam, free_cap):
        fn = self._get_ba_jit(up[3].shape[0], up[0].shape[0],
                              up[4].shape[1], free_cap)
        return fn(up, *mirrors)

    def _get_gg_ba_jit(self, P_pad, K_pad, O, free_cap):
        """Good-graph selection + local BA fused into one device program
        (one dispatch, one blocking fetch). `n_sel` is a traced scalar so the
        anticipation budget varies per KF event without recompiling.
        Returns (ba_result, sel_mask)."""
        cam = self.cfg.camera
        key = ("ggba", P_pad, K_pad, O, free_cap)
        if key not in self._ba_shapes:
            from gf_orb_slam2_tpu.optim.local_ba import pose_schur_blocks
            from gf_orb_slam2_tpu.selection.good_graph import select_subgraph

            lb = self.cfg.local_ba
            gg = self.cfg.good_graph
            # selection scan bound = the FULL pool (reference parity:
            # Optimizer.h:44-45 pool cap 60); anticipation budgets in
            # [2, max_pool] are honored without truncation
            n_max = int(gg.max_pool)

            def run(u, kfm, ptm, k, ns):
                pr = self._build_problem_on_device(u, kfm, ptm)
                S = pose_schur_blocks(pr, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
                free = ~pr.kf_fixed & pr.kf_valid
                keep = jnp.zeros(pr.kf_R.shape[0], bool).at[0].set(True)
                sel = select_subgraph(
                    S, free, ns, k,
                    lazier_factor=gg.lazier_factor, always_keep=keep,
                    n_max=n_max,
                )
                pr = pr._replace(kf_fixed=pr.kf_fixed | (~sel & free))
                res = local_bundle_adjustment(
                    pr, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                    iters_first=lb.iters_first, iters_second=lb.iters_second,
                    free_cap=free_cap,
                )
                return res, sel

            self._ba_shapes[key] = jax.jit(run)
        return self._ba_shapes[key]

    def _run_gg_ba_jit(self, up, mirrors, rng, cam, n_sel, free_cap):
        fn = self._get_gg_ba_jit(up[3].shape[0], up[0].shape[0],
                                 up[4].shape[1], free_cap)
        return fn(up, *mirrors, rng, n_sel)

    def prewarm_async(self):
        """AOT-compile (or cache-load) every fixed-shape mapper program on a
        daemon thread at startup: first use of the triangulation / fusion /
        BA programs otherwise stalls the pipeline 0.5-10 s MID-SEQUENCE."""
        from gf_orb_slam2_tpu.slammap.device_mirror import _prewarm_async

        _prewarm_async(self._prewarm)

    def prewarm_programs(self):
        """[(name, jitted fn, arg specs)] for every fixed-shape mapper
        program: what _prewarm compiles, and what the precision test
        lowers."""
        self._ensure_mirrors()
        s = self.store
        spec = jax.ShapeDtypeStruct
        kfm = {k: spec(v.shape, v.dtype) for k, v in s.kf_mirror.arrays.items()}
        ptm = {k: spec(v.shape, v.dtype) for k, v in s.mirror.arrays.items()}
        B, N = self.TRI_BATCH, self.n_kp
        FB = self.FUSE_BATCH
        # the combined triangulate+fuse program is what process_keyframe
        # actually runs; the standalone variants cover the degenerate
        # first-KF events (no neighbors yet → tri-only / fuse-only)
        if not hasattr(self, "_jit_tri_fuse"):
            self._jit_tri_fuse = jax.jit(self._tri_fuse_impl)
        if not hasattr(self, "_jit_triangulate_batch"):
            self._jit_triangulate_batch = jax.jit(
                self._triangulate_mirror_impl)
        if not hasattr(self, "_jit_fuse_batch"):
            self._jit_fuse_batch = jax.jit(self._fuse_mirror_impl)
        progs = [
            ("tri_fuse", self._jit_tri_fuse, (
                spec((), jnp.int32), spec((B,), jnp.int32),
                spec((N,), jnp.bool_), spec((B, N), jnp.bool_),
                spec((FB,), jnp.int32), spec((FB, N), jnp.int32), kfm, ptm)),
            ("triangulate", self._jit_triangulate_batch, (
                spec((), jnp.int32), spec((B,), jnp.int32),
                spec((N,), jnp.bool_), spec((B, N), jnp.bool_), kfm)),
            ("fuse", self._jit_fuse_batch, (
                spec((FB,), jnp.int32), spec((FB, N), jnp.int32), kfm, ptm)),
        ]
        # BA shape buckets (must mirror run_local_ba's bucketing)
        O = 12
        P_CAP = min(self.cfg.capacity.max_local_points,
                    self.cfg.local_ba.max_points)
        K_CAP = min(max(self.cfg.good_graph.max_pool, 8), 60)
        fc_big = ((K_CAP + 4 + 7) // 8) * 8
        P_small = min(1024, P_CAP)

        def up_spec(P_pad, K_pad):
            return (
                spec((K_pad,), jnp.int32), spec((K_pad,), jnp.bool_),
                spec((K_pad,), jnp.bool_), spec((P_pad,), jnp.int32),
                spec((P_pad, O), jnp.int32), spec((P_pad, O), jnp.int32),
                spec((P_pad, O), jnp.bool_),
            )

        for (P_pad, K_pad, fc) in sorted({(P_small, 48, 32), (P_CAP, 48, 32),
                                          (P_small, 2 * K_CAP, fc_big),
                                          (P_CAP, 2 * K_CAP, fc_big)}):
            progs.append((f"ba_{P_pad}x{K_pad}",
                          self._get_ba_jit(P_pad, K_pad, O, fc),
                          (up_spec(P_pad, K_pad), kfm, ptm)))
        if self.cfg.good_graph.enabled:
            key_spec = spec((2,), jnp.uint32)
            for (P_pad, K_pad, fc) in sorted({(P_small, 2 * K_CAP, fc_big),
                                              (P_CAP, 2 * K_CAP, fc_big)}):
                progs.append((f"gg_ba_{P_pad}x{K_pad}",
                              self._get_gg_ba_jit(P_pad, K_pad, O, fc),
                              (up_spec(P_pad, K_pad), kfm, ptm, key_spec,
                               spec((), jnp.int32))))
        return progs

    def _prewarm(self):
        try:
            for _, fn, args in self.prewarm_programs():
                fn.lower(*args).compile()
        except Exception:  # prewarm is best-effort; real use recompiles
            import logging

            logging.getLogger(__name__).exception("mapper prewarm failed")

    # --------------------------------------------------------- KF culling
    def cull_keyframes(self, kf: int) -> int:
        """Reference: KeyFrameCulling (LocalMapping.cc:820) — erase local KFs
        whose points are ≥90% observed by ≥3 other KFs at same/finer scale."""
        from gf_orb_slam2_tpu.mapping.batch_ops import redundant_keyframes

        s = self.store
        victims = redundant_keyframes(s, s.covisible_kfs(kf))
        for k in victims:
            s.erase_keyframe(k)
        return len(victims)
