"""Motion-only pose optimization (per-frame bundle adjustment).

JAX replacement for Optimizer::PoseOptimization (reference:
src/Optimizer.cc:248): g2o LM over one SE3 vertex with mono/stereo unary
edges, 4 rounds × 10 iterations with chi2 outlier gating between rounds
(chi2 5.991 mono / 7.815 stereo, Huber kernel).

Here: batched analytic Jacobians over ALL observations at once (vmap-free
einsum forms), Gauss-Newton on the 6-dof left-multiplicative se(3) update
with Tikhonov damping, fixed iteration counts (jit-static), and the same
round/gating structure. The entire solve is one XLA program — the reference's
per-edge virtual dispatch and sparse assembly collapse into dense [N,·]
tensor ops.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam2_tpu.geometry import lie
from gf_orb_slam2_tpu.utils.precision import einsum

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = 2.4477  # sqrt(5.991)
HUBER_STEREO = 2.7955  # sqrt(7.815)


class PoseOptResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray    # [N] bool — final chi2 gate
    n_inliers: jnp.ndarray  # int32
    chi2: jnp.ndarray       # [N] final per-point chi2 (for diagnostics)


def _residuals_jacobians(R, t, Xw, uv, u_right, fx, fy, cx, cy, bf):
    """Residuals [N,3] (3rd row = stereo, zeroed for mono) and J [N,3,6].

    se(3) update convention: T ← exp([rho, phi]) ∘ T (left multiplicative),
    so ∂pc/∂xi = [ I | -hat(pc) ].
    """
    pc = lie.transform(R, t, Xw)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = jnp.where(z < 1e-6, 1e-6, z)
    iz = 1.0 / z
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    is_stereo = u_right >= 0
    ur_pred = u - bf * iz
    r = jnp.stack(
        [u - uv[..., 0], v - uv[..., 1], jnp.where(is_stereo, ur_pred - u_right, 0.0)],
        -1,
    )  # [N,3]
    zero = jnp.zeros_like(x)
    # ∂(u,v,ur)/∂pc  [N,3,3]
    d_pc = jnp.stack(
        [
            jnp.stack([fx * iz, zero, -fx * x * iz2], -1),
            jnp.stack([zero, fy * iz, -fy * y * iz2], -1),
            jnp.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], -1),
        ],
        -2,
    )
    d_pc = d_pc * jnp.stack([jnp.ones_like(x), jnp.ones_like(x), is_stereo.astype(x.dtype)], -1)[..., None]
    # ∂pc/∂xi = [I | -hat(pc)]  [N,3,6]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3))
    d_xi = jnp.concatenate([eye, -lie.hat(pc)], -1)
    J = einsum("...ij,...jk->...ik", d_pc, d_xi)  # [N,3,6]
    return r, J, pc[..., 2]


def _chi2(r, inv_sigma2, is_stereo):
    e2 = jnp.sum(r[..., :2] ** 2, -1) + jnp.where(is_stereo, r[..., 2] ** 2, 0.0)
    return e2 * inv_sigma2


def pose_optimization(
    R0, t0, Xw, uv, u_right, inv_sigma2, valid,
    fx, fy, cx, cy, bf,
    rounds: int = 4, iters: int = 10, damping: float = 1e-5,
):
    """Optimize Tcw from 3D-2D(+disparity) correspondences.

    Xw: [N,3] world points; uv: [N,2] observed pixels; u_right: [N] observed
    right-cam u (<0 ⇒ monocular observation); inv_sigma2: [N] per-octave
    information; valid: [N] initial correspondence mask.
    Mirrors the reference's 4×10 structure: each round re-gates outliers by
    chi2 and Huber-weights the survivors.
    """
    is_stereo = u_right >= 0
    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = jnp.where(is_stereo, HUBER_STEREO, HUBER_MONO)

    def robust_cost(R, t, inlier):
        """Σ huber_rho(chi2) over active observations."""
        r, _, depth = _residuals_jacobians(R, t, Xw, uv, u_right, fx, fy, cx, cy, bf)
        c2 = _chi2(r, inv_sigma2, is_stereo)
        e = jnp.sqrt(jnp.maximum(c2, 1e-12))
        rho = jnp.where(e <= delta, c2, 2.0 * delta * e - delta * delta)
        return jnp.sum(jnp.where(inlier & (depth > 1e-4), rho, 0.0))

    def lm_iter(carry, step):
        """Levenberg-Marquardt with step acceptance (mirrors g2o's LM loop):
        reject cost-increasing steps and raise lambda — plain GN can stall on
        robust-cost plateaus/local basins. The reference's 4-round × 10-iter
        structure with chi2 re-gating between rounds runs as ONE scan so the
        compiled body exists once. Exactly TWO residual passes per step: the
        Jacobian pass at the current pose doubles as the round-boundary
        re-gate (gating at the start of round k+1 sees the same pose as the
        reference's gate after round k), and the candidate pass prices the
        LM step."""
        R, t, inlier, lam, cost = carry
        r, J, depth = _residuals_jacobians(R, t, Xw, uv, u_right, fx, fy, cx, cy, bf)
        c2 = _chi2(r, inv_sigma2, is_stereo)
        e = jnp.sqrt(jnp.maximum(c2, 1e-12))
        rho = jnp.where(e <= delta, c2, 2.0 * delta * e - delta * delta)
        # round-boundary chi2 re-gate (reference: between-round outlier gate),
        # reusing this step's residuals — no extra pass
        gate = (step % iters == 0) & (step > 0)
        gated = valid & (c2 <= chi2_th) & (depth > 1e-4)
        inlier = jnp.where(gate, gated, inlier)
        active = inlier & (depth > 1e-4)
        cost = jnp.where(gate, jnp.sum(jnp.where(active, rho, 0.0)), cost)
        lam = jnp.where(gate, 1e-3, lam)
        w_huber = jnp.where(e <= delta, 1.0, delta / e)
        w = inv_sigma2 * w_huber * active.astype(r.dtype)
        H = einsum("n,nri,nrj->ij", w, J, J)
        b = einsum("n,nri,nr->i", w, J, r)
        D = jnp.eye(6, dtype=H.dtype) * (damping + jnp.diag(H))
        xi = -jnp.linalg.solve(H + lam * D, b)
        dR, dt = lie.se3_exp(xi)
        R_new, t_new = lie.se3_compose(dR, dt, R, t)
        cost_new = robust_cost(R_new, t_new, inlier)
        # explicit finiteness guard: a NaN candidate pose NaN-masks every
        # depth gate, making robust_cost 0.0 — which the plain comparison
        # would "accept" (same failure class as local_ba.py:254)
        finite = jnp.isfinite(xi).all() & jnp.isfinite(cost_new)
        accept = (cost_new < cost) & finite
        R = jnp.where(accept, R_new, R)
        t = jnp.where(accept, t_new, t)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e6)
        return (R, t, inlier, lam, cost), None

    R, t = R0, t0
    inlier = valid
    cost0 = robust_cost(R, t, inlier)
    (R, t, inlier, _, _), _ = jax.lax.scan(
        lm_iter, (R, t, inlier, jnp.float32(1e-3), cost0),
        jnp.arange(rounds * iters),
    )

    r, _, depth = _residuals_jacobians(R, t, Xw, uv, u_right, fx, fy, cx, cy, bf)
    c2 = _chi2(r, inv_sigma2, is_stereo)
    inliers = valid & (c2 <= chi2_th) & (depth > 1e-4)
    return PoseOptResult(R, t, inliers, jnp.sum(inliers.astype(jnp.int32)), c2)
