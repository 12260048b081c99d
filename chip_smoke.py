"""Smoke test: the stereo SLAM main path on one NVIDIA GPU.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --multichip  # four GPUs: distributed BA only

Phases, in order. Each one asserts; the first failure raises, the process
exits non-zero and no result line is printed.

  device    JAX's default backend is "gpu". Prints the device kind, the JAX
            version, the compile-cache directory and the card's name and
            power limit (nvidia-smi). Every time printed later carries the
            card beside it.
  kernels   matching.hamming.distance_matrix on the GPU equals a NumPy
            popcount reference exactly, at 4096x1024 (local map vs
            keypoints), 1024x1024 (stereo, KF pair), 800x1000 (ragged) and
            1x1000 (one row against many).
  frontend  one rendered stereo pair through the jitted stereo frontend on
            the GPU and on the CPU device of the same process: share of
            identical keypoints, mean Hamming distance of their descriptors,
            largest depth difference of their stereo matches, each against
            the tolerance in FRONTEND_TOL.
  e2e       bench.py's configuration (stereo 640x480, 800 features, async
            mapping + loop closing, pipeline depth 3) over the 300-frame
            rendered tour through System: every frame gets a finite pose,
            keyframes and local BA ran, the point mirror's delta-scatter
            sync ran, ATE < bench.ATE_LIMIT.
  --multichip  both distributed-BA layouts on a 1-D mesh of 4 GPUs and on
            one GPU: both converge and their poses agree within
            MULTICHIP_POSE_TOL. No other phase runs.

The last line of stdout is {"ok": true, "device": {"platform", "kind",
"count"}}, printed only when every phase passed.
"""
import argparse
import json
import os
import sys
import threading

import numpy as np

# the frontend phase compares against the CPU device of this same process
_plat = os.environ.get("JAX_PLATFORMS")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

SEED = 0
# frontend parity, GPU vs CPU, on one rendered pair. Precision: every f32
# contraction in the frontend is HIGHEST (true f32, no TF32) or an explicit
# bf16 product with f32 accumulation (the rBRIEF sampling matmul); patch
# reads are direct gathers. What may still differ is f32 summation order.
FRONTEND_TOL = dict(
    # FAST/NMS/top-N run on the same integer images; only a tie in a pyramid
    # level's resampled value (one ulp) can move a keypoint
    min_identical_keypoints=0.99,
    # a descriptor bit flips only where its two bf16-product sums lie within
    # accumulation-order rounding of each other; a whole-descriptor change
    # needs the IC angle to cross a 11.25-degree bin edge
    max_mean_desc_hamming=1.0,
    # SAD sums over integer images are exact; the sub-pixel parabola and
    # bf/disparity are elementwise f32 (≈1e-6 relative at 4 m)
    max_depth_diff_m=1e-3,
)
# 1 GPU vs 4 GPUs, same problem, 8 LM iterations: psum order differs
MULTICHIP_POSE_TOL = 2e-3  # metres, max over keyframe translations


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


# ----------------------------------------------------------------- device
def phase_device():
    import jax

    backend = jax.default_backend()
    check(backend == "gpu", f"needs a GPU; JAX's default backend is "
                            f"{backend!r}")
    import bench
    import gf_orb_slam2_tpu  # noqa: F401  (places the compile cache)

    dev = jax.devices()[0]
    card = bench.card_identity()
    print(f"[device] kind={dev.device_kind} count={len(jax.devices())} "
          f"jax={jax.__version__}")
    print(f"[device] compile cache: {jax.config.jax_compilation_cache_dir}")
    print(f"[device] card: {card}")
    return card


# ---------------------------------------------------------------- kernels
def popcount_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,8]x[M,8] uint32 → [N,M] Hamming distances via a byte lookup
    table — independent of the code under test."""
    lut = np.array([bin(i).count("1") for i in range(256)], np.uint8)
    out = np.empty((a.shape[0], b.shape[0]), np.int32)
    for lo in range(0, a.shape[0], 256):
        x = a[lo:lo + 256, None, :] ^ b[None, :, :]
        out[lo:lo + 256] = lut[x.view(np.uint8)].sum(-1, dtype=np.int32)
    return out


def phase_kernels(card):
    import jax

    from gf_orb_slam2_tpu.matching.hamming import distance_matrix

    rng = np.random.default_rng(SEED)
    fn = jax.jit(distance_matrix)
    for n, m in ((4096, 1024), (1024, 1024), (800, 1000), (1, 1000)):
        a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
        b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
        a_d, b_d = jax.device_put((a, b))
        got = np.asarray(fn(a_d, b_d))
        check(np.array_equal(got, popcount_distances(a, b)),
              f"distance_matrix {n}x{m} differs from the popcount reference")
        print(f"[kernels] distance_matrix {n}x{m}: equal to the popcount "
              f"reference [{card}]")


# --------------------------------------------------------------- frontend
def phase_frontend(card, sys_, pair):
    import jax

    fe = sys_._get_frontend("stereo")
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    out_g = [np.asarray(x) for x in fe(jax.device_put(pair, gpu))]
    out_c = [np.asarray(x) for x in fe(jax.device_put(pair, cpu))]

    def keyed(out):
        uv, octv, _, desc, _, valid, _, depth = out
        return {(float(uv[i, 0]), float(uv[i, 1]), int(octv[i])):
                (desc[i], float(depth[i]))
                for i in np.nonzero(valid)[0]}

    kg, kc = keyed(out_g), keyed(out_c)
    common = sorted(set(kg) & set(kc))
    check(len(kc) > 0, "the CPU frontend found no keypoints")
    share = len(common) / len(kc)
    ham = [popcount_distances(kg[k][0][None], kc[k][0][None])[0, 0]
           for k in common]
    mean_ham = float(np.mean(ham)) if ham else float("nan")
    both = [k for k in common if kg[k][1] > 0 and kc[k][1] > 0]
    depth_diff = max((abs(kg[k][1] - kc[k][1]) for k in both), default=0.0)
    n_stereo_g = sum(1 for k in common if kg[k][1] > 0)
    n_stereo_c = sum(1 for k in common if kc[k][1] > 0)
    bit_exact = all(np.array_equal(g, c) for g, c in zip(out_g, out_c))
    print(f"[frontend] keypoints gpu={len(kg)} cpu={len(kc)} "
          f"identical={len(common)} share={share:.4f} "
          f"(min {FRONTEND_TOL['min_identical_keypoints']})")
    print(f"[frontend] mean descriptor Hamming on identical keypoints "
          f"{mean_ham:.4f} bits (max {FRONTEND_TOL['max_mean_desc_hamming']})"
          f"; descriptors differing: {sum(1 for h in ham if h)}")
    print(f"[frontend] stereo matches gpu={n_stereo_g} cpu={n_stereo_c} "
          f"both={len(both)} largest depth diff {depth_diff:.3e} m "
          f"(max {FRONTEND_TOL['max_depth_diff_m']})")
    print(f"[frontend] outputs bit-identical: {bit_exact}; precision: "
          f"f32 HIGHEST contractions + bf16 sampling matmul [{card}]")
    check(share >= FRONTEND_TOL["min_identical_keypoints"],
          f"identical keypoint share {share:.4f}")
    check(mean_ham <= FRONTEND_TOL["max_mean_desc_hamming"],
          f"mean descriptor Hamming {mean_ham:.4f}")
    check(depth_diff <= FRONTEND_TOL["max_depth_diff_m"],
          f"largest depth difference {depth_diff:.3e} m")


# -------------------------------------------------------------------- e2e
def phase_e2e(card, sys_, imgs, gt):
    import bench

    r = bench.run_tour(sys_, imgs, gt)
    n = imgs.shape[0]
    poses = r["poses"]
    times = r["times"]
    print(f"[e2e] frames={len(poses)}/{n} keyframes={r['n_keyframes']} "
          f"kf_events={r['n_kf_events']} ba_runs={r['n_ba_runs']} "
          f"ba_merged={r['n_ba_merged']} "
          f"stream_fallbacks={r['n_stream_fallbacks']} "
          f"mirror_delta_syncs={r['n_delta_syncs']} ate={r['ate_m']:.4f} m")
    print(f"[e2e] ms/frame mean {np.mean(times):.3f} median "
          f"{np.median(times):.3f} p90 {np.percentile(times, 90):.3f} over "
          f"{len(times)} frames; prewarm {r['prewarm_s']:.1f} s [{card}]")
    check(sorted(poses) == list(range(n)), "not every frame got a pose")
    check(all(np.isfinite(T).all() for T in poses.values()),
          "a frame has a non-finite pose")
    check(r["n_kf_events"] > 0, "no keyframe reached the mapper")
    check(r["n_ba_runs"] + r["n_ba_merged"] > 0, "local BA never ran")
    check(r["n_delta_syncs"] > 0,
          "the point mirror's delta-scatter sync never ran")
    check(np.isfinite(r["ate_m"]) and r["ate_m"] < bench.ATE_LIMIT,
          f"ATE {r['ate_m']:.4f} m >= {bench.ATE_LIMIT}")


# -------------------------------------------------------------- multichip
def phase_multichip(card):
    import jax

    from __graft_entry__ import ba_dryrun_problem, run_ba_layouts
    from gf_orb_slam2_tpu.parallel.mesh import make_mesh

    check(len(jax.devices()) >= 4,
          f"--multichip needs 4 GPUs, found {len(jax.devices())}")
    prob, gt_t, init_terr = ba_dryrun_problem(4, seed=SEED)
    r4 = run_ba_layouts(make_mesh(4), prob, gt_t, init_terr)
    r1 = run_ba_layouts(make_mesh(1), prob, gt_t, init_terr)
    for name in r4:
        d = float(np.abs(r4[name][0] - r1[name][0]).max())
        print(f"[multichip] {name}: pose err 4 GPUs {r4[name][1]:.5f} m, "
              f"1 GPU {r1[name][1]:.5f} m, max |dt| {d:.2e} m "
              f"(max {MULTICHIP_POSE_TOL}); 8 LM iters "
              f"{r4[name][2] * 1e3:.1f} ms on 4, {r1[name][2] * 1e3:.1f} ms "
              f"on 1 [{card}]")
        check(d <= MULTICHIP_POSE_TOL, f"{name}: 4-GPU and 1-GPU poses "
                                       f"differ by {d:.2e} m")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the 4-GPU distributed-BA phase")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    card = phase_device()
    import jax

    if args.multichip:
        phase_multichip(card)
    else:
        import bench
        from gf_orb_slam2_tpu.system import System

        # the 300-frame render runs on the host while the GPU phases and the
        # System's background compiles proceed
        rendered = {}
        render = threading.Thread(
            target=lambda: rendered.update(zip(("imgs", "gt"),
                                               bench.render_sequence())))
        render.start()
        phase_kernels(card)
        sys_ = System(bench.make_config())
        poses, _ = bench.tour_poses()
        pair = bench.render_frame(bench.make_world(), *poses[0])
        phase_frontend(card, sys_, pair)
        render.join()
        check("imgs" in rendered, "rendering the tour failed")
        phase_e2e(card, sys_, rendered["imgs"], rendered["gt"])
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
