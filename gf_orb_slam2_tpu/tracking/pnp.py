"""PnP RANSAC: camera pose from 3D-2D matches without a prior pose.

JAX replacement for PnPsolver (reference: src/PnPsolver.cc — EPnP
control-point parametrization inside a sequential RANSAC loop with
Gauss-Newton beta refinement, used by Tracking::Relocalization
Tracking.cc:2615). Here the WHOLE RANSAC runs as one device program:
[S] 6-point EPnP hypotheses solved as a batched eigh (control points from
the sample's PCA frame with a degeneracy floor, so near-planar scenes stay
well-conditioned — the regime where a DLT solver fails), beta cases N=1/N=2
refined by a fixed-iteration Gauss-Newton on the 6 control-point distance
constraints (reference: compute_pose PnPsolver.cc:480, gauss_newton :861),
batched reprojection scoring, and a weighted EPnP refit on the winning
inliers. The caller polishes with the LM pose optimizer (optim/pose_opt.py).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam2_tpu.utils.precision import einsum, matmul

# numpy, NOT jnp: this module is imported lazily, sometimes INSIDE a jit
# trace (tracker._reloc_step_impl) — a module-level jnp constant created
# under tracing is a DynamicJaxprTracer that outlives the trace and poisons
# every later call (UnexpectedTracerError on the first real relocalization)
import numpy as _np

_PAIR_I = _np.asarray([0, 0, 0, 1, 1, 2])
_PAIR_J = _np.asarray([1, 2, 3, 2, 3, 3])


class PnPResult(NamedTuple):
    ok: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


def _kabsch(X, Y, w=None):
    """R, t with Y ≈ R X + t (Horn absolute orientation, no scale)."""
    if w is None:
        w = jnp.ones(X.shape[0], X.dtype)
    ws = jnp.maximum(w.sum(), 1e-9)
    cx = (X * w[:, None]).sum(0) / ws
    cy = (Y * w[:, None]).sum(0) / ws
    H = einsum("ni,nj->ij", (X - cx) * w[:, None], Y - cy)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(matmul(Vt.T, U.T)))
    Dm = jnp.diag(jnp.asarray([1.0, 1.0, 1.0], X.dtype)).at[2, 2].set(d)
    R = matmul(Vt.T, matmul(Dm, U.T))
    t = cy - R @ cx
    return R, t


def _epnp_pose(Xw, uv_n, w=None):
    """EPnP for one sample: Xw [S,3] world points, uv_n [S,2] normalized
    image coords (optionally weighted) → (R, t).

    Control points: sample centroid + PCA axes scaled by the point spread,
    floored at 5% of the largest axis — a valid affine frame even for planar
    samples (barycentric coordinates are exact for ANY non-degenerate
    tetrahedron; the floor only conditions the inversion).
    """
    n = Xw.shape[0]
    if w is None:
        w = jnp.ones(n, Xw.dtype)
    ws = jnp.maximum(w.sum(), 1e-9)
    c0 = (Xw * w[:, None]).sum(0) / ws
    A = Xw - c0
    cov = einsum("ni,nj->ij", A * w[:, None], A) / ws
    lam, D = jnp.linalg.eigh(cov)  # ascending; columns = axes
    sc = jnp.sqrt(jnp.maximum(lam, 0.0))
    floor = jnp.maximum(0.05 * jnp.max(sc), 1e-3)
    sc = jnp.maximum(sc, floor)
    Cw = jnp.concatenate([c0[None], c0[None] + sc[:, None] * D.T], 0)  # [4,3]
    B = (Cw[1:] - Cw[0]).T
    a123 = matmul(jnp.linalg.inv(B), A.T).T                   # [n,3]
    alpha = jnp.concatenate(
        [1.0 - a123.sum(-1, keepdims=True), a123], -1)        # [n,4]
    u, v = uv_n[:, 0], uv_n[:, 1]
    sw = jnp.sqrt(jnp.maximum(w, 0.0))[:, None]
    Mu = jnp.reshape(
        jnp.stack([alpha, jnp.zeros_like(alpha), -u[:, None] * alpha], -1),
        (n, 12)) * sw
    Mv = jnp.reshape(
        jnp.stack([jnp.zeros_like(alpha), alpha, -v[:, None] * alpha], -1),
        (n, 12)) * sw
    M = jnp.concatenate([Mu, Mv], 0)
    MtM = einsum("ki,kj->ij", M, M)
    _, vecs = jnp.linalg.eigh(MtM)
    V = vecs[:, :4]                                           # 4 smallest
    Vr = V.T.reshape(4, 4, 3)                                 # [k, ctrl, 3]
    dCw = Cw[_PAIR_I] - Cw[_PAIR_J]                           # [6,3]
    rho = jnp.sum(dCw * dCw, -1)                              # [6]
    dv = Vr[:, _PAIR_I] - Vr[:, _PAIR_J]                      # [4,6,3]
    dot = einsum("kpa,lpa->pkl", dv, dv)                      # [6,4,4]

    # ---- beta initializations (reference cases N=1 / N=2)
    d11 = dot[:, 0, 0]
    b1_n1 = jnp.sqrt(jnp.maximum(
        jnp.sum(rho * d11) / jnp.maximum(jnp.sum(d11 * d11), 1e-12), 0.0))
    beta_n1 = jnp.zeros(4, Xw.dtype).at[0].set(b1_n1)
    # N=2: LS on [b11, b12, b22]
    L2 = jnp.stack([dot[:, 0, 0], 2.0 * dot[:, 0, 1], dot[:, 1, 1]], -1)
    sol2 = jnp.linalg.lstsq(L2, rho)[0]
    b1 = jnp.sqrt(jnp.maximum(jnp.abs(sol2[0]), 1e-12))
    b2 = jnp.sqrt(jnp.maximum(jnp.abs(sol2[2]), 1e-12))
    b2 = b2 * jnp.sign(sol2[1]) * jnp.sign(sol2[0])
    beta_n2 = jnp.zeros(4, Xw.dtype).at[0].set(b1).at[1].set(b2)

    def gn_refine(beta):
        """Gauss-Newton on the 6 distance constraints (reference
        gauss_newton PnPsolver.cc:861), fixed 5 iterations."""

        def step(beta, _):
            Lb = einsum("pkl,l->pk", dot, beta)              # [6,4]
            r = einsum("pk,k->p", Lb, beta) - rho            # residual
            J = 2.0 * Lb
            JtJ = einsum("pa,pb->ab", J, J) + 1e-9 * jnp.eye(4, dtype=J.dtype)
            g = einsum("pa,p->a", J, r)
            return beta - jnp.linalg.solve(JtJ, g), None

        beta, _ = jax.lax.scan(step, beta, None, length=5)
        return beta

    def pose_from_beta(beta):
        Cc = einsum("k,kca->ca", beta, Vr)                    # [4,3]
        Xc = matmul(alpha, Cc)                                # [n,3]
        sgn = jnp.sign(jnp.sum(Xc[:, 2] * w))
        Xc = Xc * jnp.where(sgn == 0, 1.0, sgn)
        return _kabsch(Xw, Xc, w)

    def reproj_err(R, t):
        pc = matmul(Xw, R.T) + t
        z = jnp.maximum(pc[:, 2], 1e-6)
        e = jnp.stack([pc[:, 0] / z - u, pc[:, 1] / z - v], -1)
        return jnp.sum(jnp.sum(e * e, -1) * w)

    cands = jnp.stack([gn_refine(beta_n1), gn_refine(beta_n2)], 0)
    Rs, ts = jax.vmap(pose_from_beta)(cands)
    errs = jax.vmap(reproj_err)(Rs, ts)
    best = jnp.argmin(errs)
    return Rs[best], ts[best]


def pnp_ransac(
    Xw, uv, valid, fx, fy, cx, cy, key,
    n_hyp: int = 256, th_px: float = 5.0, min_inliers: int = 12,
):
    """Xw [N,3] world points matched to pixels uv [N,2]; valid [N]."""
    uv_n = jnp.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
    idx_valid = jnp.argsort(~valid)
    n_valid = jnp.sum(valid)
    draws = jax.random.randint(key, (n_hyp, 6), 0, jnp.maximum(n_valid, 6))
    samples = idx_valid[draws]

    Rs, ts = jax.vmap(lambda s: _epnp_pose(Xw[s], uv_n[s]))(samples)

    def score(R, t):
        pc = Xw @ R.T + t
        z = jnp.maximum(pc[:, 2], 1e-6)
        u = fx * pc[:, 0] / z + cx
        v = fy * pc[:, 1] / z + cy
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        return valid & (e2 < th_px * th_px) & (pc[:, 2] > 0)

    inls = jax.vmap(score)(Rs, ts)
    votes = jnp.sum(inls, -1)
    best = jnp.argmax(votes)
    # weighted EPnP refit on the winning inliers (all points, masked)
    w = inls[best].astype(Xw.dtype)
    R_f, t_f = _epnp_pose(Xw, uv_n, w)
    inl_f = score(R_f, t_f)
    better = jnp.sum(inl_f) >= votes[best]
    R_out = jnp.where(better, R_f, Rs[best])
    t_out = jnp.where(better, t_f, ts[best])
    inl_out = jnp.where(better, inl_f, inls[best])
    n_out = jnp.sum(inl_out)
    return PnPResult(ok=n_out >= min_inliers, R=R_out, t=t_out,
                     inliers=inl_out, n_inliers=n_out)
