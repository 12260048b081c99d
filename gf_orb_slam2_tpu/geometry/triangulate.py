"""Two-view triangulation + quality checks, fully batched.

Replaces the reference's per-point DLT in LocalMapping::CreateNewMapPoints
(src/LocalMapping.cc:370, SVD on a 4x4 A) and Initializer::Triangulate
(src/Initializer.cc:740) with a batched closed-form midpoint/DLT solve.
"""
from __future__ import annotations

import jax.numpy as jnp

from gf_orb_slam2_tpu.utils.precision import einsum

from gf_orb_slam2_tpu.geometry import lie


def triangulate_dlt(P1, P2, x1, x2):
    """Batched linear (DLT) triangulation.

    P1, P2: [3,4] (or batched [..,3,4]) projection matrices.
    x1, x2: [..,2] normalized or pixel coords consistent with P.
    Returns homogeneous-normalized 3D points [..,3].

    Solves the inhomogeneous normal equations (w=1 gauge): minimize
    ||A[X;1]||² → (A₃ᵀA₃)X = -A₃ᵀa₄, a batched closed-form 3x3 solve
    (utils/linalg3.py) — the reference's per-point 4x4 SVD
    (LocalMapping.cc:~500) would be a batched [10k×4×4] SVD call; the
    closed form fuses into elementwise work. Genuinely-at-infinity points fail the cheirality gate anyway.
    """
    from gf_orb_slam2_tpu.utils.linalg3 import solve3

    rows = []
    for P, x in ((P1, x1), (P2, x2)):
        rows.append(x[..., 0, None] * P[..., 2, :] - P[..., 0, :])
        rows.append(x[..., 1, None] * P[..., 2, :] - P[..., 1, :])
    A = jnp.stack(rows, axis=-2)  # [..,4,4]
    A3 = A[..., :3]
    a4 = A[..., 3]
    AtA = einsum("...ki,...kj->...ij", A3, A3)
    rhs = -einsum("...ki,...k->...i", A3, a4)
    return solve3(AtA, rhs)


def projection_matrix(K, R, t):
    """P = K [R|t] for world→camera (R, t)."""
    Rt = jnp.concatenate([R, t[..., None]], -1)
    return einsum("...ij,...jk->...ik", K, Rt)


def triangulation_checks(
    Xw, R1, t1, R2, t2, uv1, uv2, K, sigma2_1, sigma2_2,
    min_parallax_cos=0.9998, chi2=5.991,
):
    """Cheirality + parallax + reprojection gates.

    Mirrors the acceptance tests of CreateNewMapPoints
    (reference: src/LocalMapping.cc:450-560): positive depth in both views,
    parallax cos < threshold, reprojection chi2 within per-octave sigma.
    Returns boolean mask.
    """
    pc1 = lie.transform(R1, t1, Xw)
    pc2 = lie.transform(R2, t2, Xw)
    z_ok = (pc1[..., 2] > 0) & (pc2[..., 2] > 0)

    o1 = -einsum("...ji,...j->...i", R1, t1)  # camera centers in world
    o2 = -einsum("...ji,...j->...i", R2, t2)
    r1 = Xw - o1
    r2 = Xw - o2
    cosp = jnp.sum(r1 * r2, -1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-9
    )
    parallax_ok = cosp < min_parallax_cos

    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]

    def reproj_err2(pc, uv):
        iz = 1.0 / jnp.maximum(pc[..., 2], 1e-8)
        u = fx * pc[..., 0] * iz + cx
        v = fy * pc[..., 1] * iz + cy
        return (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2

    r_ok = (reproj_err2(pc1, uv1) < chi2 * sigma2_1) & (
        reproj_err2(pc2, uv2) < chi2 * sigma2_2
    )
    return z_ok & parallax_ok & r_ok
