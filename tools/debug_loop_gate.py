#!/usr/bin/env python
"""Instrumented loop-gate arms: run the rendered circuit with loop closing
ON under stage ablations and print ATE per arm + loop diagnostics.

Arms: full (essential graph + sync GBA), no_eg (skip essential graph),
no_gba (skip global BA), rigid (neither — neighborhood correction only),
gbaN (N GBA iterations), probe (jit-vs-eager Sim3 diagnostics).
Async (pipelined streaming + async mapping worker, the BENCH config) arms:
a_noloop (loop closing off), a_nocorr (detect but never correct),
a_rigid (correction without essential graph / GBA), a_full.

Usage: python tools/debug_loop_gate.py [arms...]
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

# jax may already be imported before this line runs, so the env var alone
# can be too late — update the live config as well (same as conftest.py)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def run_arm(arm: str):
    from tests.test_loop_rendered import BF, CX, CY, FX, FY, _rendered_frames

    from gf_orb_slam2_tpu.config import (
        CameraConfig, CapacityConfig, LoopClosingConfig, ORBConfig, Sensor,
        SystemConfig,
    )
    from gf_orb_slam2_tpu.io.evaluation import ate_rmse
    from gf_orb_slam2_tpu.io.trajectory import recompose_trajectory
    from gf_orb_slam2_tpu.loopclosing.loop_closer import LoopCloser
    from gf_orb_slam2_tpu.system import System

    poses, frames = _rendered_frames()
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, th_depth=40.0)
    is_async = arm.startswith("a_")
    if is_async:
        from gf_orb_slam2_tpu.config import TrackingConfig

        cfg = SystemConfig(
            sensor=Sensor.STEREO, camera=cam, orb=ORBConfig(n_features=800),
            capacity=CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                    max_keyframes=160, max_local_points=2048),
            tracking=TrackingConfig(async_mapping=True),
            loop=LoopClosingConfig(enabled=arm != "a_noloop"),
        )
    else:
        cfg = SystemConfig(
            sensor=Sensor.STEREO, camera=cam, orb=ORBConfig(n_features=800),
            capacity=CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                    max_keyframes=160, max_local_points=2048),
            loop=LoopClosingConfig(enabled=True, synchronous_gba=True),
        )
    slam = System(cfg)
    lc = slam.loop_closer
    dumps = []
    if lc is not None:
        if arm in ("no_eg", "rigid", "a_rigid", "a_noeg"):
            lc._optimize_essential_graph = lambda *a, **k: None
        if arm in ("no_gba", "rigid", "a_rigid"):
            lc._launch_global_ba = lambda *a, **k: None
        if arm == "a_nocorr":
            lc._correct_loop = lambda *a, **k: None
        if arm.endswith("probe"):
            st_ = slam.store

            def _hook(**kw):
                kw["fi"] = int(st_.kf_frame_id[kw["kf"]])
                kw["fc"] = int(st_.kf_frame_id[kw["c"]])
                dumps.append(kw)

            lc.sim3_debug_hook = _hook
        if is_async:  # compile ahead, as bench/gates do (cache-served later)
            lc._prewarm(force=True)
        if arm.startswith("gba"):  # e.g. gba40 → GlobalBARunner(iters=40)
            import gf_orb_slam2_tpu.optim.global_ba as gba_mod

            iters = int(arm[3:] or 40)
            Orig = gba_mod.GlobalBARunner

            class Patched(Orig):
                def __init__(self, store, cfg, **kw):
                    kw.setdefault("iters", iters)
                    super().__init__(store, cfg, **kw)

            gba_mod.GlobalBARunner = Patched
    throttle = not os.environ.get("GF_NO_THROTTLE")
    gt = {}
    for i, ((R_cw, t_cw), (l, r)) in enumerate(zip(poses, frames)):
        if is_async:
            slam.track_stereo_pipelined(l, r, i / 20.0)
            # bounded-lag throttle (see tests/test_loop_rendered.py): the
            # 2-core host can't sustain the exploration rate unthrottled
            mw = slam._map_worker
            if throttle and mw is not None and mw._q.qsize() >= 2:
                mw.wait_idle()
            lw = slam._loop_worker
            if throttle and lw is not None and lw._q.qsize() >= 2:
                lw.wait_idle()
        else:
            slam.track_stereo(l, r, i / 20.0)
        gt[i / 20.0] = -R_cw.T @ t_cw
    mw_counts = (None if slam._map_worker is None else
                 [slam._map_worker.n_ba_runs, slam._map_worker.n_ba_merged,
                  slam._map_worker.n_kf_events])
    slam.shutdown()
    est, g = [], []
    for ts, T_cw in recompose_trajectory(slam.tracker.relative_poses,
                                         slam.store):
        est.append(-T_cw[:3, :3].T @ T_cw[:3, 3])
        g.append(gt[ts])
    ate = float(ate_rmse(np.stack(est), np.stack(g)))
    events = [st.__dict__ for st in (slam.loop_closer.stats if
                                     slam.loop_closer else [])
              if st.corrected]
    out = {"arm": arm, "ate": round(ate, 4), "events": events}
    if os.environ.get("GF_DEBUG_FRAMES"):
        tr = []
        for st2 in slam.tracker.stats:
            tr.append((st2.frame_id, st2.state,
                       getattr(st2, "n_inliers", -1),
                       getattr(st2, "n_local_matches", -1),
                       1 if getattr(st2, "created_kf", False) else 0))
        out["frames"] = tr
        out["fallbacks"] = int(getattr(slam, "n_stream_fallbacks", 0))
        out["ba"] = mw_counts
    if arm.endswith("probe") and dumps:
        out["probe"] = [_probe_one(slam, poses, d) for d in dumps]
    return out


def _rot_angle_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _probe_one(slam, poses, d):
    """Compare the production (jitted) Sim3 against an EAGER recompute on
    identical inputs, and both against the ground-truth relative pose."""
    import jax
    import jax.numpy as jnp

    from gf_orb_slam2_tpu.loopclosing.sim3solver import (
        optimize_sim3, solve_sim3,
    )

    s = slam.store
    cam = slam.cfg.camera
    kf, c = d["kf"], d["c"]
    key = jax.random.PRNGKey(kf * 1000 + c)
    res = solve_sim3(
        jnp.asarray(d["pc1"]), jnp.asarray(d["pc2"]), jnp.asarray(d["val"]),
        cam.fx, cam.fy, cam.cx, cam.cy, key, fix_scale=slam.loop_closer.fix_scale,
        min_inliers=slam.cfg.loop.min_sim3_inliers)
    s_e, R_e, t_e, inl_e = optimize_sim3(
        res.s, res.R, res.t, jnp.asarray(d["pc1"]), jnp.asarray(d["pc2"]),
        res.inliers, cam.fx, cam.fy, cam.cx, cam.cy,
        fix_scale=slam.loop_closer.fix_scale)
    s_e, R_e, t_e = float(s_e), np.asarray(R_e), np.asarray(t_e)
    # ground-truth relative: S12_true maps kf cam -> loop cam (frame ids
    # captured AT HOOK TIME — slots may be culled/reused by run end)
    fi = d.get("fi", int(s.kf_frame_id[kf]))
    fc = d.get("fc", int(s.kf_frame_id[c]))
    R1g, t1g = poses[fi]
    R2g, t2g = poses[fc]
    R_true = R2g @ R1g.T
    t_true = t2g - R_true @ t1g
    s_j, R_j, t_j, _ = d["ransac"]
    s_r, R_r, t_r, n_inl2, n_total = d["refined"]
    return {
        "kf": kf, "c": c,
        "jit_ransac": {"rot_err_deg": _rot_angle_deg(R_j, R_true),
                       "t_err": float(np.linalg.norm(t_j - t_true)),
                       "s": s_j},
        "eager": {"rot_err_deg": _rot_angle_deg(R_e, R_true),
                  "t_err": float(np.linalg.norm(t_e - t_true)),
                  "s": s_e,
                  "vs_jit_rot_deg": _rot_angle_deg(R_e, R_j),
                  "vs_jit_t": float(np.linalg.norm(t_e - t_j))},
        "refined": {"rot_err_deg": _rot_angle_deg(R_r, R_true),
                    "t_err": float(np.linalg.norm(t_r - t_true)),
                    "s": s_r, "n_inl2": n_inl2, "n_total": n_total},
    }


def main():
    arms = sys.argv[1:] or ["full", "no_eg", "no_gba", "rigid"]
    for arm in arms:
        r = run_arm(arm)
        print(json.dumps(r, default=str), flush=True)


if __name__ == "__main__":
    main()
