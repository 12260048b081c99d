"""Per-stage wall-clock breakdown of LocalMapper.process_keyframe on the
device, over a live bench sequence. Run from repo root."""
from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ACC = defaultdict(float)
CNT = defaultdict(int)


def timed(name, fn):
    def wrap(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        dt = time.perf_counter() - t0
        ACC[name] += dt
        CNT[name] += 1
        if dt > 0.2:
            print(f"    [{name} call #{CNT[name]}: {1e3 * dt:.0f} ms]",
                  flush=True)
        return out
    return wrap


def main():
    sys.argv = [sys.argv[0]]
    import bench

    n_frames = 120
    frames, _ = bench.render_sequence()
    n_frames = min(n_frames, len(frames))

    from gf_orb_slam2_tpu.config import (
        CameraConfig, CapacityConfig, ORBConfig, Sensor, SystemConfig,
    )
    from gf_orb_slam2_tpu.system import System
    from gf_orb_slam2_tpu.mapping import local_mapping as lm_mod

    M = lm_mod.LocalMapper
    for m in ["_refresh_point_stats", "cull_recent_points",
              "create_new_points", "fuse_neighbors", "run_local_ba",
              "cull_keyframes", "update_hash_tables"]:
        setattr(M, m, timed(m, getattr(M, m)))

    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0,
                       th_depth=60.0)
    cfg = SystemConfig(
        sensor=Sensor.STEREO,
        camera=cam,
        orb=ORBConfig(n_features=800),
        capacity=CapacityConfig(max_keypoints=1024, max_map_points=40000,
                                max_keyframes=300, max_local_points=4096),
    )
    slam = System(cfg)
    t0 = time.perf_counter()
    for i in range(n_frames):
        slam.track_stereo(frames[i][0], frames[i][1], i / 20.0)
    total = time.perf_counter() - t0

    nkf = max(CNT.get("run_local_ba", 1), 1)
    print(f"\n{n_frames} frames ({1e3 * total / n_frames:.1f} ms/frame), "
          f"{nkf} keyframes")
    for k in sorted(ACC, key=lambda k: -ACC[k]):
        print(f"  {k:24s} {1e3 * ACC[k] / max(CNT[k], 1):8.1f} ms/call "
              f"({CNT[k]} calls, {ACC[k]:.2f} s total)")
    print("\ndevice dispatch→fetch per stage (median ms; incl the host "
          "round trip):")
    for k, v in sorted(slam.mapper.device_ms.items()):
        v = np.asarray(v)
        print(f"  {k:24s} med {np.median(v):7.1f}  mean {v.mean():7.1f}  "
              f"p90 {np.percentile(v, 90):7.1f}  max {v.max():7.1f}  "
              f"(n={v.size})")


if __name__ == "__main__":
    main()
