"""Loop closing on a textured rendered revisit.

The acceptance test for loop closing: a closed circular trajectory in the
ray-cast room (tests/rendered_world.py) must (a) detect the loop on
revisit, (b) fuse duplicate landmarks (SearchAndFuse), and (c) end with a
consistent map — measured as ATE not degrading versus the loop-disabled
run of the same sequence (drift on this short loop is small, so the gate is
detection + fusion + no-harm rather than a large ATE delta)."""
import dataclasses

import numpy as np

from tests.rendered_world import RoomWorld, cached_frames, trajectory_loop

from gf_orb_slam2_tpu.config import (
    CameraConfig, CapacityConfig, LoopClosingConfig, ORBConfig, Sensor,
    SystemConfig,
)
from gf_orb_slam2_tpu.io.evaluation import ate_rmse
from gf_orb_slam2_tpu.system import System

FX = FY = 450.0
CX, CY = 320.0, 240.0
BASELINE = 0.1
BF = FX * BASELINE
N_FRAMES = 140


_FRAMES_CACHE = {}


def _rendered_frames():
    """Render the circuit ONCE per process; both the loop-on and loop-off
    arms consume the same frames (the render is ~2/3 of each arm's cost).
    Frames are also disk-cached (tests/rendered_world.cached_frames)."""
    if "frames" in _FRAMES_CACHE:
        return _FRAMES_CACHE["poses"], _FRAMES_CACHE["frames"]
    poses = trajectory_loop(N_FRAMES, radius=2.2, center=(0.0, 0.0, 7.0),
                            loops=1.27)
    gt = np.stack([np.concatenate([R.ravel(), t]) for R, t in poses])

    def render():
        world = RoomWorld(width=9.0, height=5.0, length=14.0)
        return np.stack([
            np.clip(np.stack(world.render_stereo(
                R_cw, t_cw, baseline=BASELINE, fx=FX, fy=FY, cx=CX, cy=CY)),
                0, 255).astype(np.uint8)
            for R_cw, t_cw in poses
        ])

    imgs = cached_frames("loop_circuit_v1.npz", gt, render)
    frames = [(imgs[i, 0].astype(np.float32), imgs[i, 1].astype(np.float32))
              for i in range(imgs.shape[0])]
    _FRAMES_CACHE["frames"] = frames
    _FRAMES_CACHE["poses"] = poses
    return poses, frames


def _run(loop_enabled: bool):
    poses, frames = _rendered_frames()
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, th_depth=40.0)
    cfg = SystemConfig(
        sensor=Sensor.STEREO, camera=cam, orb=ORBConfig(n_features=800),
        capacity=CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                max_keyframes=160, max_local_points=2048),
        # synchronous GBA: the post-correction full BA runs inline, so the
        # result does not depend on host load (detached-GBA write-back timing
        # made this gate flaky: 0.10 m solo vs 0.12 m under full-suite load)
        loop=LoopClosingConfig(enabled=loop_enabled, synchronous_gba=True),
    )
    slam = System(cfg)
    gt = {}
    for i, ((R_cw, t_cw), (l, r)) in enumerate(zip(poses, frames)):
        slam.track_stereo(l, r, i / 20.0)
        gt[i / 20.0] = -R_cw.T @ t_cw
    slam.shutdown()
    # evaluate the RECOMPOSED trajectory (T_rel × corrected ref-KF pose) —
    # this is what the reference's SaveTrajectoryTUM emits (System.cc:591):
    # loop/BA corrections propagate retroactively to every frame
    from gf_orb_slam2_tpu.io.trajectory import recompose_trajectory

    est, g = [], []
    for ts, T_cw in recompose_trajectory(slam.tracker.relative_poses,
                                         slam.store):
        est.append(-T_cw[:3, :3].T @ T_cw[:3, 3])
        g.append(gt[ts])
    return ate_rmse(np.stack(est), np.stack(g)), slam


def test_async_headline_config():
    """The EXACT configuration the driver benches (bench.py): pipelined
    streaming tracking + async mapping worker + loop closing with DETACHED
    (asynchronous, abortable) global BA — gated on accuracy and on BA
    coverage (VERDICT r4 #6: this config was accuracy-untested anywhere, and
    the official bench shipped ATE 0.486 m as green)."""
    from gf_orb_slam2_tpu.config import TrackingConfig
    from gf_orb_slam2_tpu.io.trajectory import recompose_trajectory

    poses, frames = _rendered_frames()
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, th_depth=40.0)
    cfg = SystemConfig(
        sensor=Sensor.STEREO, camera=cam, orb=ORBConfig(n_features=800),
        capacity=CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                max_keyframes=160, max_local_points=2048),
        tracking=TrackingConfig(async_mapping=True),
        loop=LoopClosingConfig(enabled=True),  # detached GBA (bench default)
    )
    slam = System(cfg)
    # compile the loop-closing jit family BEFORE tracking starts, exactly as
    # bench.py does via wait_prewarm(): on this 2-core CI host a mid-run
    # compile steals the CPU the async pipeline needs and the degradation
    # masquerades as an accuracy bug (the persistent compile cache makes
    # this a one-time cost per machine)
    if slam.loop_closer is not None:
        slam.loop_closer._prewarm(force=True)
    slam.wait_prewarm()
    gt = {}
    est = {}
    for i, ((R_cw, t_cw), (l, r)) in enumerate(zip(poses, frames)):
        for fid, T in slam.track_stereo_pipelined(l, r, i / 20.0):
            est[fid] = T
        gt[i / 20.0] = -R_cw.T @ t_cw
        # bounded-lag throttle: on a small CPU host the workers cannot
        # keep up with the exploration rate at full frame speed (bench.py
        # and chip_smoke.py gate that config on the accelerator);
        # letting the queues grow unboundedly starves the local map and the
        # test measures host speed, not correctness. Real concurrency is
        # still exercised — workers run while the next frames track.
        mw = slam._map_worker
        if mw is not None and mw._q.qsize() >= 1:
            mw.wait_idle()
        lw = slam._loop_worker
        if lw is not None and lw._q.qsize() >= 1:
            lw.wait_idle()
    for fid, T in slam.flush_pipeline():
        est[fid] = T
    mw = slam._map_worker
    slam.shutdown()
    e, g = [], []
    for ts, T_cw in recompose_trajectory(slam.tracker.relative_poses,
                                         slam.store):
        e.append(-T_cw[:3, :3].T @ T_cw[:3, 3])
        g.append(gt[ts])
    ate = ate_rmse(np.stack(e), np.stack(g))
    # Accuracy bound: single-device solo runs measure 0.07-0.13; under the
    # suite's 8-virtual-device conftest env thread-timing jitter adds up to
    # ~0.1 (measured 0.186 solo-under-8vdev). Bound at 0.25: comfortably
    # above environment jitter, far below every real failure mode this gate
    # exists to catch (mirror-race corruption / stale-solve clobbering /
    # un-rebased chains measured 0.7-1.4 before the r5 fixes).
    assert ate < 0.25, f"headline-config ATE {ate:.3f} m"
    # BA coverage: the worker merges backlogged KFs into one window solve —
    # no KF event may be silently dropped (r4 shed 62% of local BAs)
    if mw is not None and mw.n_kf_events:
        assert mw.n_ba_runs + mw.n_ba_merged == mw.n_kf_events, (
            mw.n_ba_runs, mw.n_ba_merged, mw.n_kf_events)
        assert mw.n_ba_runs > 0


def test_loop_detected_fused_and_consistent():
    ate_on, slam = _run(loop_enabled=True)
    # (a) the revisit must be detected and corrected
    stats = [] if slam.loop_closer is None else slam.loop_closer.stats
    corrected = [s for s in stats if s.corrected]
    assert corrected, "no loop closure fired on a closed circular revisit"
    # (b) SearchAndFuse must deduplicate landmarks
    assert sum(s.n_fused for s in corrected) > 0, "no landmarks fused"
    # (c) the corrected (recomposed) trajectory stays accurate. This number
    # is HOST-DEPENDENT at the ±30% level: the same code measured 0.10 m on
    # the r3 host and 0.133 m on the r5 host (f32 fusion/rounding differences
    # flip RANSAC tie-breaks → different matches → a different but equally
    # converged map; r5 verified the r4-HEAD and fed1ce1 loop closers land on
    # the IDENTICAL 0.1331 on this host, and 40 GBA iterations move it only
    # to 0.1323 — it is the converged BA optimum for this scene's stereo
    # noise at 0.1 m baseline / ~9 m depths, not uncorrected drift). Gate at
    # the absolute noise-floor ceiling...
    assert ate_on < 0.15, f"ATE with loop closing {ate_on:.3f} m"
    # (d) ...AND require the correction to have done real work: the same
    # frames with loop closing OFF must drift ≥25% more (measured: OFF
    # ≈ 0.19 m on both hosts — loop-off fails (c) outright)
    ate_off, _ = _run(loop_enabled=False)
    assert ate_on < 0.75 * ate_off, (
        f"loop closing must cut drift: on={ate_on:.3f} off={ate_off:.3f}")
