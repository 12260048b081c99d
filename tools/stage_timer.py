"""Per-frame wall-clock stage breakdown of the live System on the device.

Wraps the tracker/system stage methods with perf_counter timers (no library
changes) and separately accounts the blocking device_get inside the fused
step, so host bookkeeping vs device-wait is split. Run from repo root:

    python tools/stage_timer.py --frames 48
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ACC = defaultdict(float)
CNT = defaultdict(int)
ENABLED = False


def timed(name, fn):
    def wrap(*a, **k):
        if not ENABLED:
            return fn(*a, **k)
        t0 = time.perf_counter()
        out = fn(*a, **k)
        ACC[name] += time.perf_counter() - t0
        CNT[name] += 1
        return out
    return wrap


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    args = ap.parse_args()

    sys.argv = [sys.argv[0]]
    import bench
    import jax

    frames, _ = bench.render_sequence()
    frames = frames[:args.frames + 16]

    from gf_orb_slam2_tpu.config import (
        CameraConfig, CapacityConfig, ORBConfig, Sensor, SystemConfig,
    )
    from gf_orb_slam2_tpu.system import System
    from gf_orb_slam2_tpu.tracking import tracker as tr_mod
    from gf_orb_slam2_tpu.mapping import local_mapping as lm_mod

    # split the blocking fetch out of _track_fused
    real_get = jax.device_get
    jax.device_get = timed("  device_get(block)", real_get)
    tr_mod.jax.device_get = jax.device_get

    T = tr_mod.Tracker
    for m in ["prepare_fused_host_inputs", "_track_fused",
              "_refresh_cached_pool", "_gather_local_map",
              "_need_new_keyframe", "_create_keyframe", "_finish_frame",
              "_merge_additional_matches", "_predict_pose"]:
        setattr(T, m, timed(m, getattr(T, m)))
    lm_mod.LocalMapper.process_keyframe = timed(
        "mapper.process_keyframe", lm_mod.LocalMapper.process_keyframe)

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
    slam._build_stereo_frame = timed("build_frame(upload+dispatch)",
                                     slam._build_stereo_frame)

    for i in range(16):  # warmup: init + compile
        slam.track_stereo(frames[i][0], frames[i][1], i / 20.0)
    print("state after warmup:", slam.state.name, flush=True)

    global ENABLED
    ENABLED = True
    t0 = time.perf_counter()
    for i in range(16, 16 + args.frames):
        slam.track_stereo(frames[i][0], frames[i][1], i / 20.0)
    total = time.perf_counter() - t0
    ENABLED = False

    n = args.frames
    print(f"\n{n} frames, {1e3 * total / n:.1f} ms/frame total")
    shown = 0.0
    for k in sorted(ACC, key=lambda k: -ACC[k]):
        ms = 1e3 * ACC[k] / n
        print(f"  {k:32s} {ms:8.2f} ms/frame  ({CNT[k] / n:.2f} calls)")
        if not k.startswith("  "):
            shown += ms
    print(f"  {'(sum of top-level stages)':32s} {shown:8.2f}")


if __name__ == "__main__":
    main()
