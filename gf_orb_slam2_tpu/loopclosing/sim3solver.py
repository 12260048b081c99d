"""Sim3 RANSAC between two keyframes' matched map points.

JAX replacement for Sim3Solver (reference: src/Sim3Solver.cc —
sequential RANSAC, 3-point Horn absolute orientation per hypothesis
(ComputeSim3 :~229), reprojection inlier check (CheckInliers :335),
fixed-scale mode for stereo/RGB-D). All hypotheses run as ONE batched
program: [S,3] samples → vmapped Horn → [S,N] two-way reprojection inlier
counts → argmax → all-inlier refit.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam2_tpu.geometry import lie


class Sim3Result(NamedTuple):
    ok: jnp.ndarray
    s: jnp.ndarray          # scale 1→2
    R: jnp.ndarray          # [3,3]
    t: jnp.ndarray          # [3]
    inliers: jnp.ndarray    # [N] bool
    n_inliers: jnp.ndarray


def optimize_sim3(
    s0, R0, t0, pc1, pc2, inliers, fx, fy, cx, cy,
    fix_scale: bool = False, iters: int = 8, th2_px: float = 9.21,
):
    """GN polish of a relative Sim3 with two-way reprojection residuals.

    Replaces Optimizer::OptimizeSim3 (reference: src/Optimizer.cc, decl
    Optimizer.h:100 — g2o over one Sim3 vertex with inverse/forward
    projection edges and Huber gating). 7-dof left-mult update via autodiff
    Jacobians, fixed iterations, chi2 re-gate at the end.
    """
    import jax

    from gf_orb_slam2_tpu.utils.precision import einsum

    def residuals(xi, s, R, t):
        ds, dR, dt = lie.sim3_exp(xi)
        s_, R_, t_ = lie.sim3_compose(ds, dR, dt, s, R, t)
        p1in2 = lie.sim3_apply(s_[None], R_, t_, pc1)
        si, Ri, ti = lie.sim3_inv(s_, R_, t_)
        p2in1 = lie.sim3_apply(si[None], Ri, ti, pc2)

        def proj(p):
            z = jnp.maximum(p[..., 2], 1e-6)
            return jnp.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1)

        r2 = proj(p1in2) - proj(pc2)
        r1 = proj(p2in1) - proj(pc1)
        return jnp.concatenate([r1, r2], -1)  # [N,4]

    w0 = inliers.astype(pc1.dtype)
    s, R, t = s0, R0, t0
    mask7 = jnp.ones(7)
    if fix_scale:
        mask7 = mask7.at[6].set(0.0)
    for _ in range(iters):
        zero = jnp.zeros(7)
        r = residuals(zero, s, R, t)  # [N,4]
        J = jax.jacfwd(residuals)(zero, s, R, t)  # [N,4,7]
        H = einsum("n,nri,nrj->ij", w0, J, J) + 1e-4 * jnp.eye(7)
        b = einsum("n,nri,nr->i", w0, J, r)
        xi = -jnp.linalg.solve(H, b) * mask7
        ds, dR, dt = lie.sim3_exp(xi)
        s, R, t = lie.sim3_compose(ds, dR, dt, s, R, t)
    r = residuals(jnp.zeros(7), s, R, t)
    e2 = jnp.sum(r[..., :2] ** 2, -1) + jnp.sum(r[..., 2:] ** 2, -1)
    inl = inliers & (e2 < 2 * th2_px)
    return s, R, t, inl


def solve_sim3(
    pc1, pc2, valid, fx, fy, cx, cy, key,
    fix_scale: bool = False, n_hyp: int = 128,
    th2_px: float = 9.21, min_inliers: int = 20,
):
    """pc1/pc2: [N,3] corresponding points in each camera frame.

    th2_px: chi2-ish squared-pixel gate (reference uses 9.21·sigma²).
    Returns Sim3Result with (s,R,t) mapping cam1 points into cam2? —
    convention: pc2 ≈ s·R·pc1 + t (Sim3 T21).
    """
    N = pc1.shape[0]
    idx_valid = jnp.argsort(~valid)
    n_valid = jnp.sum(valid)
    draws = jax.random.randint(key, (n_hyp, 3), 0, jnp.maximum(n_valid, 3))
    samples = idx_valid[draws]  # [S,3]

    def hyp(sample):
        a = pc1[sample]
        b = pc2[sample]
        s, R, t = lie.horn_sim3(a, b, fix_scale=fix_scale)
        return s, R, t

    ss, Rs, ts = jax.vmap(hyp)(samples)

    def project(p):
        z = jnp.maximum(p[..., 2], 1e-6)
        return jnp.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1)

    uv1_obs = project(pc1)
    uv2_obs = project(pc2)

    def count(s, R, t):
        p1in2 = lie.sim3_apply(s[None], R, t, pc1)
        si, Ri, ti = lie.sim3_inv(s, R, t)
        p2in1 = lie.sim3_apply(si[None], Ri, ti, pc2)
        e2 = jnp.sum((project(p1in2) - uv2_obs) ** 2, -1)
        e1 = jnp.sum((project(p2in1) - uv1_obs) ** 2, -1)
        inl = valid & (e1 < th2_px) & (e2 < th2_px) & (p1in2[..., 2] > 0) & (p2in1[..., 2] > 0)
        return inl

    inls = jax.vmap(count)(ss, Rs, ts)  # [S,N]
    votes = jnp.sum(inls, -1)
    best = jnp.argmax(votes)
    # refit on the winning inlier set (masked Horn via weighted means)
    w = inls[best].astype(pc1.dtype)

    def weighted_horn(a, b, w):
        n = jnp.maximum(jnp.sum(w), 1.0)
        mu_a = jnp.sum(a * w[:, None], 0) / n
        mu_b = jnp.sum(b * w[:, None], 0) / n
        from gf_orb_slam2_tpu.utils.precision import einsum as _es
        from gf_orb_slam2_tpu.utils.precision import matmul as _mm

        ac = (a - mu_a) * w[:, None]
        bc = (b - mu_b) * w[:, None]
        # f32-pinned contractions: reduced-precision (TF32/bf16) products
        # corrupt the 3x3 Horn covariance / rotation recovery (same hazard class as the epipolar
        # F in local_mapping — see utils/precision.py)
        H = _es("ni,nj->ij", ac, b - mu_b)
        U, S, Vt = jnp.linalg.svd(H)
        d = jnp.sign(jnp.linalg.det(_mm(Vt.T, U.T)))
        D = jnp.array([1.0, 1.0, 1.0]) * jnp.array([1.0, 1.0, 1.0]).at[2].set(d)
        R = _es("ji,j,jk->ik", Vt, D, U.T)
        var = jnp.sum(ac * ac) / jnp.maximum(n, 1e-9)
        scale = jnp.where(fix_scale, 1.0, jnp.sum(S * D) / jnp.maximum(var * n, 1e-9))
        t = mu_b - scale * _mm(R, mu_a[:, None])[:, 0]
        return scale, R, t

    s_f, R_f, t_f = weighted_horn(pc1, pc2, w)
    inl_f = count(s_f, R_f, t_f)
    n_f = jnp.sum(inl_f)
    use_refit = n_f >= votes[best]
    s_out = jnp.where(use_refit, s_f, ss[best])
    R_out = jnp.where(use_refit, R_f, Rs[best])
    t_out = jnp.where(use_refit, t_f, ts[best])
    inl_out = jnp.where(use_refit, inl_f, inls[best])
    n_out = jnp.maximum(n_f, votes[best])
    return Sim3Result(
        ok=n_out >= min_inliers,
        s=s_out, R=R_out, t=t_out,
        inliers=inl_out, n_inliers=n_out,
    )
