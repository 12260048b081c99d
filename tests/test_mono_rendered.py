"""Monocular end-to-end on the textured rendered circuit (the reference's
headline evaluation regime is EuRoC MONO with scale-drifting loop closure —
README.md:26-29, LoopClosing.cc:253 ComputeSim3 with scale,
Optimizer.cc:2338 OptimizeEssentialGraph seeded from CorrectedSim3).

The same closed circuit as tests/test_loop_rendered.py, tracked MONOCULAR:
init from parallax, constant-velocity tracking, keyframe mapping, loop
closure with fix_scale=False (the Sim3 solver estimates relative scale and
the essential graph distributes it). Monocular ATE is evaluated after
7-DoF (Sim3/Umeyama-with-scale) alignment — absolute scale is unobservable.
"""
import numpy as np

from tests.test_loop_rendered import (  # noqa: E402  (shared render cache)
    BF, CX, CY, FX, FY, _rendered_frames,
)

from gf_orb_slam2_tpu.config import (
    CameraConfig, CapacityConfig, LoopClosingConfig, ORBConfig, Sensor,
    SystemConfig,
)
from gf_orb_slam2_tpu.io.evaluation import ate_rmse
from gf_orb_slam2_tpu.system import System


def _run_mono(loop_enabled: bool):
    poses, frames = _rendered_frames()
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=0.0, th_depth=0.0)
    cfg = SystemConfig(
        sensor=Sensor.MONOCULAR, camera=cam, orb=ORBConfig(n_features=800),
        capacity=CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                max_keyframes=160, max_local_points=2048),
        loop=LoopClosingConfig(enabled=loop_enabled, synchronous_gba=True),
    )
    slam = System(cfg)
    gt = {}
    for i, ((R_cw, t_cw), (left, _)) in enumerate(zip(poses, frames)):
        slam.track_monocular(left, i / 20.0)
        gt[i / 20.0] = -R_cw.T @ t_cw
    slam.shutdown()
    from gf_orb_slam2_tpu.io.trajectory import recompose_trajectory

    est, g = [], []
    for ts, T_cw in recompose_trajectory(slam.tracker.relative_poses,
                                         slam.store):
        est.append(-T_cw[:3, :3].T @ T_cw[:3, 3])
        g.append(gt[ts])
    assert len(est) >= 100, f"mono tracked only {len(est)} of 140 frames"
    ate = ate_rmse(np.stack(est), np.stack(g), with_scale=True)
    return ate, slam


def test_mono_circuit_loop_closure():
    ate_on, slam = _run_mono(loop_enabled=True)
    stats = [] if slam.loop_closer is None else slam.loop_closer.stats
    corrected = [s for s in stats if s.corrected]
    # (a) the revisit must be detected and corrected with a free scale
    assert corrected, "no mono loop closure fired on the circuit revisit"
    assert slam.loop_closer.fix_scale is False
    # (b) scale-drift-corrected trajectory accuracy (7-DoF-aligned ATE)
    assert ate_on < 0.15, f"mono ATE (Sim3-aligned) {ate_on:.3f} m"
    # (c) no-harm bound: on THIS short circuit the Sim3-aligned mono drift
    # is tiny (measured loop-off ≈ 0.05 m — the free gauge absorbs most
    # scale drift), below the correction's own noise floor, so strict
    # improvement is not observable; what the gate must catch is a BROKEN
    # correction (wrong Sim3 convention / bad scale seed teleports the map:
    # 0.5-1.4 m). Improvement-under-drift is asserted by the stereo gate,
    # where drift exceeds the floor.
    ate_off, _ = _run_mono(loop_enabled=False)
    assert ate_on < max(1.5 * ate_off, 0.12), (
        f"mono loop closing degraded ATE: on={ate_on:.3f} off={ate_off:.3f}")
