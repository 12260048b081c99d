"""Map hashing ACTIVE end-to-end on the rendered circuit (VERDICT r4 #7).

The reference's ICRA19 behavior: once the map exceeds MAP_SIZE_TRIGGER_HASHING
(2000 points, Tracking.h:66), TrackLocalMap assembles the local map by
multi-index-hash retrieval instead of (or combined with) covisibility
traversal (UpdateLocalPointsByHashing Tracking.cc:2895), under the 20 ms
OTS feedback controller (Hashing.h:74-79). Here: the same textured
circuit as the loop gate, tracked with local_map_mode=COMBINED and hashing
enabled — asserting the hash path actually RAN (map crosses the trigger,
queries issued, OTS re-selection exercised) and that accuracy stays at
parity with the covisibility-only arm.
"""
import dataclasses

import numpy as np

from tests.test_loop_rendered import (  # noqa: E402  (shared render cache)
    BF, CX, CY, FX, FY, _rendered_frames,
)

from gf_orb_slam2_tpu.config import (
    CameraConfig, CapacityConfig, HashingConfig, LocalMapMode,
    LoopClosingConfig, ORBConfig, Sensor, SystemConfig, TrackingConfig,
)
from gf_orb_slam2_tpu.io.evaluation import ate_rmse
from gf_orb_slam2_tpu.system import System

_ATE_CACHE = {}


def _run(mode: LocalMapMode, hashing: bool):
    poses, frames = _rendered_frames()
    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, th_depth=40.0)
    cfg = SystemConfig(
        sensor=Sensor.STEREO, camera=cam, orb=ORBConfig(n_features=800),
        capacity=CapacityConfig(max_keypoints=1024, max_map_points=30000,
                                max_keyframes=160, max_local_points=2048),
        tracking=TrackingConfig(local_map_mode=mode),
        hashing=HashingConfig(enabled=hashing),
        loop=LoopClosingConfig(enabled=False),  # isolate the local-map path
    )
    slam = System(cfg)
    gt, est = [], []
    for i, ((R_cw, t_cw), (left, right)) in enumerate(zip(poses, frames)):
        T = slam.track_stereo(left, right, i / 20.0)
        est.append(-T[:3, :3].T @ T[:3, 3])
        gt.append(-R_cw.T @ t_cw)
    mih = slam.tracker.mih
    n_points = slam.store.n_points
    slam.shutdown()
    return ate_rmse(np.stack(est), np.stack(gt)), mih, n_points


def test_hash_local_map_active_and_accurate():
    ate_h, mih, n_points = _run(LocalMapMode.COMBINED, hashing=True)
    # the map must actually cross the reference's hashing trigger
    assert n_points > 2000, f"map too small to trigger hashing: {n_points}"
    assert mih is not None
    # the hash retrieval path must have served local-map queries
    assert getattr(mih, "n_queries", 0) > 20, mih and mih.n_queries
    # online table selection kept an active subset
    assert len(mih.active_tables) == mih.n_active
    # accuracy parity with the covisibility-only arm (reference claim: hashed
    # local maps trade assembly cost, not accuracy — ICRA19 / README.md:35)
    if "covis" not in _ATE_CACHE:
        _ATE_CACHE["covis"] = _run(LocalMapMode.COVIS_ONLY, hashing=False)[0]
    ate_c = _ATE_CACHE["covis"]
    assert ate_h < max(ate_c * 1.2, ate_c + 0.02), (
        f"hash-combined ATE {ate_h:.3f} vs covis {ate_c:.3f}")
