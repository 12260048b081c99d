"""Headline benchmark: end-to-end stereo SLAM latency on one GPU, 6-DoF scene.

Measures the SUSTAINED per-frame processing time of the streaming pipelined
stereo tracker (image-in → pose-out: ORB pyramid extraction ×2, stereo
matching, motion-model + local-map tracking with pose optimization, KF
creation/local mapping/loop closing when triggered) on a rendered textured
6-DoF room sequence (tests/rendered_world.py: ray-cast box room with seeded
procedural textures — multi-depth geometry, continuous yaw/pitch/roll, no
fronto-parallel episodes), and compares against the reference's best
published number: 19.1 ms/frame CPU total tracking latency with all
accelerations (GF-ORB-SLAM2 README.md:15-17; BASELINE.md). The reference's
number is also a pipelined-tracking-thread measure (its mapping/loop threads
run concurrently), so the quantities match.

300-frame sequence, first 40 frames excluded (compile + pipeline fill + map
bootstrap), mean/median/p90 over the remaining ~260 frames, and the exact-GT
ATE of the produced trajectory printed in the same line — the latency is
only meaningful if the tracking is good.

Needs a GPU: exits non-zero on any other backend. Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ..., "platform", "device_kind",
"device_count", "card"}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_MS = 19.1
N_FRAMES = 300
WARM = 40  # frames excluded from the steady-state window
N_SYNC = 16  # synchronous bootstrap frames before the pipelined section
FX = FY = 450.0
CX, CY = 320.0, 240.0
BASELINE_M = 0.1
BF = FX * BASELINE_M
ATE_LIMIT = 0.20  # 2x the rendered-gate bound (tests/test_rendered_ate.py)

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)


def _load_renderer():
    """tests/rendered_world.py of this checkout, loaded by path: a `tests`
    package installed elsewhere on sys.path would shadow this checkout's
    `tests` directory (it has no __init__.py)."""
    import importlib.util

    name = "gf_slam_rendered_world"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(_HERE, "tests", "rendered_world.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


rendered_world = _load_renderer()


def card_identity() -> str:
    """The first card's name and power limit as nvidia-smi reports them
    (e.g. "NVIDIA H100 80GB HBM3, 700.00 W")."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def device_identity() -> dict:
    """platform/kind/count as JAX reports them, plus the card string."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card_identity()}


def tour_poses(n_frames=N_FRAMES):
    poses = rendered_world.trajectory_tour(n_frames)
    return poses, np.stack([-R.T @ t for R, t in poses])


def render_frame(world, R_cw, t_cw) -> np.ndarray:
    """One rendered stereo pair as uint8 [2,480,640]."""
    lr = world.render_stereo(R_cw, t_cw, baseline=BASELINE_M,
                             fx=FX, fy=FY, cx=CX, cy=CY)
    return np.clip(np.stack(lr), 0, 255).astype(np.uint8)


def make_world():
    return rendered_world.RoomWorld(width=9.0, height=5.5, length=13.0)


def render_sequence(n_frames=N_FRAMES):
    """Rendered 6-DoF stereo sequence (uint8 [F,2,480,640]) + ground-truth
    camera centers. Ray-casting costs ~0.1 s/frame on the host, so the
    frames are cached in the checkout's render cache
    (tests/rendered_world.cached_frames). Requests for a prefix
    (n_frames < N_FRAMES, e.g. quick profiling tools) are served as a slice
    of the full cached sequence — a miss always renders the full length so
    the cache stays shared."""
    assert n_frames <= N_FRAMES, "render_sequence serves prefixes of the tour"
    poses, gt = tour_poses()

    def render():
        world = make_world()
        return np.stack([render_frame(world, R, t) for R, t in poses])

    imgs = rendered_world.cached_frames("tour6dof_v2.npz", gt, render)
    return imgs[:n_frames], gt[:n_frames]


def make_config():
    """The benchmarked deployment: stereo 640x480, 800 ORB features, async
    local mapping + loop closing, pipeline depth 3."""
    from gf_orb_slam2_tpu.config import (
        CameraConfig, CapacityConfig, ORBConfig, Sensor, SystemConfig,
        TrackingConfig,
    )

    cam = CameraConfig(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, th_depth=40.0)
    return SystemConfig(
        sensor=Sensor.STEREO,
        camera=cam,
        orb=ORBConfig(n_features=800),
        capacity=CapacityConfig(max_keypoints=1024, max_map_points=40000,
                                max_keyframes=300, max_local_points=4096),
        # mapping + loop closing on the background worker (the reference's
        # LocalMapping/LoopClosing THREADS, System.cc:113-124): keyframe
        # events no longer stall the frame path, which is what the
        # reference's 19.1 ms tracking-thread number also assumes
        tracking=TrackingConfig(async_mapping=True, pipeline_depth=3),
    )


def run_tour(sys_, imgs, gt):
    """Drive the System through the tour the way a user would: wait for
    the background compiles, N_SYNC synchronous frames, the rest pipelined,
    flush, shutdown. Returns the per-frame poses and timings."""
    from gf_orb_slam2_tpu.io.evaluation import ate_rmse

    # join the background compile threads BEFORE the timed loop: every
    # fixed-shape program (mapper buckets + loop-closer family + GBA) is then
    # compiled or cache-loaded up front instead of at its first use
    # mid-sequence
    t_warm0 = time.perf_counter()
    sys_.wait_prewarm()
    prewarm_s = time.perf_counter() - t_warm0
    poses = {}

    def note(fid, T):
        poses[fid] = np.asarray(T)

    # warmup: synchronous frames bootstrap the map and pay the frontend/fused
    # compiles; the pipelined section pays the streaming compile on its first
    # dispatch (cached across runs by the persistent compile cache)
    sync_times = []
    n = imgs.shape[0]
    for i in range(N_SYNC):
        t0 = time.perf_counter()
        note(i, sys_.track_stereo(imgs[i, 0], imgs[i, 1], i / 20.0))
        dt = (time.perf_counter() - t0) * 1e3
        if i >= 10:
            sync_times.append(dt)
    times = []
    trace = []  # (frame, ms, kf_count_so_far) for BENCH_TRACE.json
    for i in range(N_SYNC, n):
        t0 = time.perf_counter()
        for fid, T in sys_.track_stereo_pipelined(imgs[i, 0], imgs[i, 1],
                                                  i / 20.0):
            note(fid, T)
        dt = (time.perf_counter() - t0) * 1e3
        trace.append((i, round(dt, 2), int(sys_.store.n_keyframes)))
        if i >= WARM:
            times.append(dt)
    for fid, T in sys_.flush_pipeline():
        note(fid, T)
    mw = sys_._map_worker
    out = dict(
        poses=poses, times=times, sync_times=sync_times, trace=trace,
        prewarm_s=prewarm_s,
        n_keyframes=int(sys_.store.n_keyframes),
        n_kf_events=mw.n_kf_events if mw is not None else 0,
        n_ba_runs=mw.n_ba_runs if mw is not None else 0,
        n_ba_merged=mw.n_ba_merged if mw is not None else 0,
        n_stream_fallbacks=int(getattr(sys_, "n_stream_fallbacks", 0)),
        n_delta_syncs=(sys_.store.mirror.n_delta_syncs
                       if sys_.store.mirror is not None else 0),
    )
    sys_.shutdown()
    common = sorted(poses)
    est = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in common])
    out["ate_m"] = float(ate_rmse(est, gt[common]))
    return out


def main():
    import jax

    if jax.default_backend() != "gpu":
        print(f"BENCH FAILED: needs a GPU, JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        raise SystemExit(2)
    ident = device_identity()
    from gf_orb_slam2_tpu.system import System

    imgs, gt = render_sequence()
    sys_ = System(make_config())
    r = run_tour(sys_, imgs, gt)
    times = r["times"]
    mean = float(np.mean(times))
    # headline = the MEAN: the sustained number a robot experiences, and the
    # apples-to-apples match for the reference's 19.1 ms tracking-thread
    # average (its mapping/loop threads run concurrently, as ours now do)
    print(json.dumps({
        "metric": "stereo_tracking_ms_per_frame_mean",
        "value": round(mean, 3),
        "unit": "ms/frame",
        "vs_baseline": round(BASELINE_MS / mean, 3),
        "median_ms": round(float(np.median(times)), 3),
        "p90_ms": round(float(np.percentile(times, 90)), 3),
        "sync_latency_ms": round(float(np.median(r["sync_times"])), 3),
        "n_frames_measured": len(times),
        "n_keyframes": r["n_keyframes"],
        "n_stream_fallbacks": r["n_stream_fallbacks"],
        "ate_m": round(r["ate_m"], 4),
        "n_ba_runs": r["n_ba_runs"],
        "n_ba_merged": r["n_ba_merged"],
        "prewarm_s": round(r["prewarm_s"], 1),
        "scene": "rendered 6-DoF room tour (procedural textures), 300 frames",
        **ident,
    }))
    if os.environ.get("BENCH_TRACE"):
        with open("BENCH_TRACE.json", "w") as f:
            json.dump({"trace": r["trace"],
                       "mapper_device_ms": {
                           k: [round(x, 1) for x in v]
                           for k, v in sys_.mapper.device_ms.items()}}, f)
    # accuracy self-check: a latency number from a diverged trajectory is
    # meaningless — fail the bench outright so a collapsed run never
    # records as rc=0
    ate = r["ate_m"]
    if not np.isfinite(ate) or ate > ATE_LIMIT:
        print(f"BENCH FAILED: ate_m={ate:.4f} exceeds {ATE_LIMIT}",
              file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
