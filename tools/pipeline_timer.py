"""Wall-clock breakdown of the pipelined tracking loop on the device:
complete (fetch-wait + bookkeeping) / prepare / upload / dispatch segments,
split into frames WITH and WITHOUT keyframe events (the mapper runs inline
on KF frames and dominates them; the no-KF median is the steady-state
latency floor). Run from repo root."""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    sys.argv = [sys.argv[0]]
    import bench
    import jax

    frames, _ = bench.render_sequence()
    frames = frames[:140]

    from gf_orb_slam2_tpu.config import (
        CameraConfig, CapacityConfig, ORBConfig, Sensor, SystemConfig,
    )
    from gf_orb_slam2_tpu.system import System, _to_u8

    cam = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=45.0,
                       th_depth=40.0)
    cfg = SystemConfig(
        sensor=Sensor.STEREO, camera=cam, orb=ORBConfig(n_features=800),
        capacity=CapacityConfig(max_keypoints=1024, max_map_points=40000,
                                max_keyframes=300, max_local_points=4096),
    )
    slam = System(cfg)
    for i in range(16):
        slam.track_stereo(frames[i][0], frames[i][1], i / 20.0)

    tr = slam.tracker
    rows = []  # (kf_events, dict of segment ms)
    for i in range(16, len(frames)):
        l, r = frames[i]
        ts = i / 20.0
        if not tr.stream_ready():
            slam.flush_pipeline()
            slam.track_stereo(l, r, ts)
            continue
        if slam.store.mirror is None:
            from gf_orb_slam2_tpu.slammap.device_mirror import DeviceMapMirror

            slam.store.mirror = DeviceMapMirror(slam.store)
        if tr._chain is None:
            tr._chain = tr.stream_bootstrap_chain()
        seg = {}
        t0 = time.perf_counter()
        kf_events = 0
        fetchw = bookk = mapt = 0.0
        while len(slam._inflight) >= slam._pipeline_depth:
            frame, pool_ids = slam._inflight.popleft()
            tw0 = time.perf_counter()
            raw = slam._fetcher.get(frame.frame_id)
            tw1 = time.perf_counter()
            st = tr.stream_complete(frame, raw, pool_ids)
            tw2 = time.perf_counter()
            if st.created_kf:
                slam._on_keyframe(tr.ref_kf)
                kf_events += 1
            fetchw += tw1 - tw0
            bookk += tw2 - tw1
            mapt += time.perf_counter() - tw2
        seg["fetch_wait"] = fetchw
        seg["bookkeeping"] = bookk
        seg["mapper+loop"] = mapt
        t1 = time.perf_counter()
        slam.store.mirror.sync()
        t1b = time.perf_counter()
        seg["mirror_sync"] = t1b - t1
        packed, pool_ids = tr.stream_prepare_upload(slam.frame_id)
        imgs = np.stack([_to_u8(l), _to_u8(r)])
        t2 = time.perf_counter()
        seg["prepare+stack"] = t2 - t1b
        imgs_d, up_d = jax.device_put((imgs, packed))
        t3 = time.perf_counter()
        seg["device_put"] = t3 - t2
        out = slam._get_frontend("stereo")(imgs_d)
        packed_out = tr.stream_dispatch(out, up_d)
        t4 = time.perf_counter()
        seg["dispatch"] = t4 - t3
        f = slam._make_frame(out, ts)
        if slam._fetcher is None:
            from gf_orb_slam2_tpu.system import _PipelineFetcher

            slam._fetcher = _PipelineFetcher()
        slam._fetcher.submit(f.frame_id, packed_out)
        slam._inflight.append((f, pool_ids))
        slam.frame_id += 1
        seg["total"] = time.perf_counter() - t0
        if i >= 30:
            rows.append((kf_events, seg))
    slam.flush_pipeline()

    keys = ["total", "fetch_wait", "bookkeeping", "mapper+loop", "mirror_sync",
            "prepare+stack", "device_put", "dispatch"]
    for label, sel in [("no-KF frames", [s for k, s in rows if k == 0]),
                       ("KF frames", [s for k, s in rows if k > 0])]:
        print(f"\n{label}: {len(sel)}  (median / p90 ms)")
        for k in keys:
            v = np.asarray([s[k] for s in sel]) * 1e3
            if v.size:
                print(f"  {k:16s} {np.median(v):8.2f}  {np.percentile(v, 90):8.2f}")


if __name__ == "__main__":
    main()
