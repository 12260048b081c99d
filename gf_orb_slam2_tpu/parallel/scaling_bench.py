"""Distributed-BA scaling harness.

Measures per-iteration time of the point-sharded BA (parallel/dist_ba.py)
across mesh sizes. On a multi-GPU host the mesh spans the cards; on the
virtual CPU mesh the numbers measure harness overhead, not hardware scaling
(it still validates the collective program at every size). Sizes larger
than the number of devices present are skipped.

  python -m gf_orb_slam2_tpu.parallel.scaling_bench --devices 1 2 4 \
      --points 16384              # strong scaling (fixed problem)
  python -m gf_orb_slam2_tpu.parallel.scaling_bench --devices 1 2 4 \
      --points-per-device 4096    # weak scaling
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_problem(P, K=32, O=8, seed=0):
    import jax.numpy as jnp

    from gf_orb_slam2_tpu.geometry import lie
    from gf_orb_slam2_tpu.optim.local_ba import LocalBAProblem

    rng = np.random.default_rng(seed)
    gt_pts = np.stack(
        [rng.uniform(-10, 10, P), rng.uniform(-5, 5, P), rng.uniform(4, 40, P)], -1
    ).astype(np.float32)
    kf_R, kf_t = [], []
    for k in range(K):
        xi = np.zeros(6, np.float32)
        xi[0] = 0.5 * k
        xi[4] = 0.002 * k
        R, t = lie.se3_exp(jnp.asarray(xi))
        kf_R.append(np.asarray(R))
        kf_t.append(np.asarray(t))
    kf_R, kf_t = np.stack(kf_R), np.stack(kf_t)
    obs_kf = rng.integers(0, K, (P, O)).astype(np.int32)
    pos = gt_pts[:, None, :]
    Rk = kf_R[obs_kf]
    tk = kf_t[obs_kf]
    pck = np.einsum("poij,poj->poi", Rk, np.broadcast_to(pos, (P, O, 3))) + tk
    z = np.maximum(pck[..., 2], 0.5)
    u = 450.0 * pck[..., 0] / z + 320.0 + rng.normal(0, 0.3, (P, O))
    v = 450.0 * pck[..., 1] / z + 240.0 + rng.normal(0, 0.3, (P, O))
    obs_uv = np.stack([u, v], -1).astype(np.float32)
    obs_ur = (u - 45.0 / z).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    valid = pck[..., 2] > 0.5
    return LocalBAProblem(
        kf_R=jnp.asarray(kf_R), kf_t=jnp.asarray(kf_t + rng.normal(0, 0.02, (K, 3)).astype(np.float32) * ~fixed[:, None]),
        kf_fixed=jnp.asarray(fixed), kf_valid=jnp.ones(K, bool),
        pt_pos=jnp.asarray(gt_pts + rng.normal(0, 0.05, (P, 3)).astype(np.float32)),
        pt_valid=jnp.ones(P, bool),
        obs_kf=jnp.asarray(obs_kf), obs_uv=jnp.asarray(obs_uv),
        obs_ur=jnp.asarray(obs_ur),
        obs_inv_sigma2=jnp.ones((P, O), jnp.float32),
        obs_valid=jnp.asarray(valid),
    )


def main():
    import jax

    from gf_orb_slam2_tpu.parallel.dist_ba import distributed_ba
    from gf_orb_slam2_tpu.parallel.mesh import make_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--points-per-device", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ablate-collectives", action="store_true",
                    help="run identical per-device compute with the "
                         "cross-device reductions removed (timing-only; "
                         "separates collective cost from host "
                         "oversubscription on the virtual mesh)")
    args = ap.parse_args()

    n_avail = len(jax.devices())
    rows = []
    base = None
    for n_dev in args.devices:
        if n_dev > n_avail:
            print(f"# skipping {n_dev} devices ({n_avail} available)")
            continue
        P = (args.points_per_device * n_dev if args.points_per_device
             else args.points)
        P = ((P + n_dev - 1) // n_dev) * n_dev
        prob = build_problem(P)
        mesh = make_mesh(n_dev)
        # warm (compile)
        distributed_ba(mesh, prob, 450.0, 450.0, 320.0, 240.0, 45.0,
                       iters=1, ablate_collectives=args.ablate_collectives)
        t0 = time.perf_counter()
        out = distributed_ba(mesh, prob, 450.0, 450.0, 320.0, 240.0, 45.0,
                             iters=args.iters,
                             ablate_collectives=args.ablate_collectives)
        jax.block_until_ready(out[:3])
        dt = (time.perf_counter() - t0) / args.iters * 1e3
        row = {"devices": n_dev, "points": P, "ms_per_iter": round(dt, 2),
               "cost": round(float(out[3]), 2)}
        if base is None:
            base = dt * (1 if args.points_per_device else 1)
        if args.points_per_device:
            row["weak_efficiency"] = round(base / dt, 3)
        else:
            row["strong_speedup"] = round(base / dt, 3)
        rows.append(row)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
