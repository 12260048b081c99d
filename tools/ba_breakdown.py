"""Device-time decomposition of the per-KF local-BA program on the device:
(a) pose-Schur blocks, (b) good-graph selection scan, (c) the LM BA itself,
(d) the fused gg+BA program local_mapping actually dispatches — all warm,
timed with blocking jax.device_get. Run from repo root."""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(name, fn, *args, n=5):
    fn(*args)  # warm/compile
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.device_get(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    print(f"  {name:34s} {np.median(ts):8.1f} ms   (min {min(ts):.1f})")
    return np.median(ts)


def build(K_pad, P_pad, O, n_free):
    rng = np.random.default_rng(0)
    from gf_orb_slam2_tpu.optim.local_ba import LocalBAProblem

    K, P = K_pad, P_pad
    pts = np.stack([rng.uniform(-4, 4, P), rng.uniform(-3, 3, P),
                    rng.uniform(4, 15, P)], -1).astype(np.float32)
    kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    kf_t = np.zeros((K, 3), np.float32)
    kf_t[:, 0] = np.linspace(0, 3, K)
    obs_kf = rng.integers(0, max(n_free + 8, 1), (P, O)).astype(np.int32)
    uv = rng.uniform(0, 640, (P, O, 2)).astype(np.float32)
    fixed = np.ones(K, bool)
    fixed[:n_free] = False
    prob = LocalBAProblem(
        kf_R=jnp.asarray(kf_R), kf_t=jnp.asarray(kf_t),
        kf_fixed=jnp.asarray(fixed), kf_valid=jnp.ones(K, bool),
        pt_pos=jnp.asarray(pts), pt_valid=jnp.ones(P, bool),
        obs_kf=jnp.asarray(obs_kf), obs_uv=jnp.asarray(uv),
        obs_ur=jnp.full((P, O), -1.0, jnp.float32),
        obs_inv_sigma2=jnp.ones((P, O), jnp.float32),
        obs_valid=jnp.ones((P, O), bool),
    )
    return prob


def main():
    from gf_orb_slam2_tpu.optim.local_ba import (
        local_bundle_adjustment, pose_schur_blocks,
    )
    from gf_orb_slam2_tpu.selection.good_graph import select_subgraph

    fx = fy = 450.0
    cx, cy, bf = 320.0, 240.0, 45.0

    for (K_pad, P_pad, free_cap, n_free, n_max) in [
        (48, 1024, 32, 20, 60),
        (120, 4096, 64, 56, 60),
    ]:
        print(f"\nshapes: K_pad={K_pad} P_pad={P_pad} free={n_free} "
              f"free_cap={free_cap} n_max={n_max}")
        prob = build(K_pad, P_pad, 12, n_free)

        schur = jax.jit(lambda p: pose_schur_blocks(p, fx, fy, cx, cy, bf))
        timeit("pose_schur_blocks", schur, prob)

        S = schur(prob)
        free = ~prob.kf_fixed & prob.kf_valid
        keep = jnp.zeros(K_pad, bool).at[0].set(True)
        sel_fn = jax.jit(lambda S, f, k: select_subgraph(
            S, f, jnp.int32(20), k, lazier_factor=4, always_keep=keep,
            n_max=n_max))
        timeit("select_subgraph (60-round scan)", sel_fn, S, free,
               jax.random.PRNGKey(0))

        ba = jax.jit(lambda p: local_bundle_adjustment(
            p, fx, fy, cx, cy, bf, iters_first=5, iters_second=10,
            free_cap=free_cap))
        timeit("LM BA 15 iters (free_cap)", ba, prob)

        ba8 = jax.jit(lambda p: local_bundle_adjustment(
            p, fx, fy, cx, cy, bf, iters_first=3, iters_second=5,
            free_cap=free_cap))
        timeit("LM BA 8 iters (free_cap)", ba8, prob)

        def fused(p, k):
            S = pose_schur_blocks(p, fx, fy, cx, cy, bf)
            f = ~p.kf_fixed & p.kf_valid
            sel = select_subgraph(S, f, jnp.int32(20), k, lazier_factor=4,
                                  always_keep=keep, n_max=n_max)
            p2 = p._replace(kf_fixed=p.kf_fixed | (~sel & f))
            return local_bundle_adjustment(
                p2, fx, fy, cx, cy, bf, iters_first=5, iters_second=10,
                free_cap=free_cap), sel

        timeit("FUSED schur+select+BA (production)", jax.jit(fused), prob,
               jax.random.PRNGKey(0))


if __name__ == "__main__":
    main()


def extra():
    """A/B: P bucket 2048 and 3+5 iters at the big-window shape."""
    from gf_orb_slam2_tpu.optim.local_ba import local_bundle_adjustment
    fx = fy = 450.0
    cx, cy, bf = 320.0, 240.0, 45.0
    for (K_pad, P_pad, free_cap, n_free) in [
        (120, 2048, 64, 56),
        (120, 4096, 64, 56),
    ]:
        print(f"\nextra shapes: K_pad={K_pad} P_pad={P_pad}")
        prob = build(K_pad, P_pad, 12, n_free)
        for (i1, i2) in [(5, 10), (3, 5)]:
            ba = jax.jit(lambda p, a=i1, b=i2: local_bundle_adjustment(
                p, fx, fy, cx, cy, bf, iters_first=a, iters_second=b,
                free_cap=free_cap))
            timeit(f"LM BA {i1}+{i2} P={P_pad}", ba, prob)
