"""Local bundle adjustment: Schur-complement Levenberg-Marquardt, fully batched.

JAX replacement for Optimizer::LocalBundleAdjustment (reference:
src/Optimizer.cc:618/1248-1545 — g2o BlockSolver_6_3 LM over ≤60 covisible
KFs + their points, 5+10 iterations with chi2 gating) and for the SLAM++
block-sparse machinery underneath (CUberBlockMatrix, Schur ordering,
block Cholesky — Thirdparty/SLAM++, SURVEY.md §2.2). At local-BA scale
(K ≤ 32 poses, P ≤ 4096 points) the reduced camera system is a tiny dense
matrix, so 130k LoC of sparse block algebra collapses into a few einsums:

  Hll (3x3 per point) → batched inverse →
  S = Hpp - Σ_p T_p Hll_p⁻¹ T_pᵀ  (dense [6K,6K] via one-hot einsum) →
  dense solve → back-substitution for points.

Observations are a fixed-capacity [P, O] table (point-major), poses enter
via a one-hot assignment tensor — no sparse indexing anywhere, everything
is dense batched contractions.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam2_tpu.geometry import lie
from gf_orb_slam2_tpu.utils.precision import einsum

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = 2.4477
HUBER_STEREO = 2.7955


class LocalBAProblem(NamedTuple):
    """Fixed-capacity local BA problem (SoA, masked).

    K keyframes (optimized unless fixed_mask), P points, O obs slots/point.
    """

    kf_R: jnp.ndarray        # [K,3,3]
    kf_t: jnp.ndarray        # [K,3]
    kf_fixed: jnp.ndarray    # [K] bool — pose held constant
    kf_valid: jnp.ndarray    # [K] bool
    pt_pos: jnp.ndarray      # [P,3]
    pt_valid: jnp.ndarray    # [P] bool
    obs_kf: jnp.ndarray      # [P,O] int32 index into K (-1 empty)
    obs_uv: jnp.ndarray      # [P,O,2]
    obs_ur: jnp.ndarray      # [P,O] (<0 mono)
    obs_inv_sigma2: jnp.ndarray  # [P,O]
    obs_valid: jnp.ndarray   # [P,O] bool


class LocalBAResult(NamedTuple):
    kf_R: jnp.ndarray
    kf_t: jnp.ndarray
    pt_pos: jnp.ndarray
    obs_inlier: jnp.ndarray  # [P,O] bool — post-gating
    final_cost: jnp.ndarray


def _residuals(prob: LocalBAProblem, kf_R, kf_t, pt_pos, fx, fy, cx, cy, bf):
    """Per-obs residual [P,O,3] + Jacobians J_pose [P,O,3,6], J_pt [P,O,3,3]."""
    k = jnp.maximum(prob.obs_kf, 0)
    R = kf_R[k]          # [P,O,3,3]
    t = kf_t[k]          # [P,O,3]
    pc = einsum("poij,pj->poi", R, pt_pos) + t
    x, y = pc[..., 0], pc[..., 1]
    z = jnp.where(pc[..., 2] < 1e-6, 1e-6, pc[..., 2])
    iz = 1.0 / z
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    is_stereo = prob.obs_ur >= 0
    ur_pred = u - bf * iz
    r = jnp.stack(
        [u - prob.obs_uv[..., 0], v - prob.obs_uv[..., 1],
         jnp.where(is_stereo, ur_pred - prob.obs_ur, 0.0)],
        -1,
    )
    zero = jnp.zeros_like(x)
    d_pc = jnp.stack(
        [
            jnp.stack([fx * iz, zero, -fx * x * iz2], -1),
            jnp.stack([zero, fy * iz, -fy * y * iz2], -1),
            jnp.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], -1)
            * is_stereo[..., None].astype(x.dtype),
        ],
        -2,
    )  # [P,O,3,3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3))
    d_xi = jnp.concatenate([eye, -lie.hat(pc)], -1)  # [P,O,3,6]
    J_pose = einsum("poij,pojk->poik", d_pc, d_xi)
    J_pt = einsum("poij,pojk->poik", d_pc, R)  # ∂pc/∂X = R
    return r, J_pose, J_pt, pc[..., 2]


def _chi2(r, inv_sigma2, is_stereo):
    e2 = jnp.sum(r[..., :2] ** 2, -1) + jnp.where(is_stereo, r[..., 2] ** 2, 0.0)
    return e2 * inv_sigma2


def pose_schur_blocks(prob: LocalBAProblem, fx, fy, cx, cy, bf, eps=1e-2):
    """Pose-block Schur complement S = Hpp - T Hll⁻¹ Tᵀ as [K,K,6,6].

    The good-graph selection input (reference: SLAM++ builds this as the
    'SC' matrix, NonlinearSolver_GoodGraph.h:978-1047). Computed at the
    current linearization point with plain (non-robust) weights.
    """
    K = prob.kf_R.shape[0]
    r, J_pose, J_pt, depth = _residuals(
        prob, prob.kf_R, prob.kf_t, prob.pt_pos, fx, fy, cx, cy, bf
    )
    valid = prob.obs_valid & (prob.obs_kf >= 0) & prob.pt_valid[:, None] & (depth > 1e-4)
    w = prob.obs_inv_sigma2 * valid.astype(r.dtype)
    onehot = jax.nn.one_hot(prob.obs_kf, K, dtype=prob.kf_R.dtype)
    wJp = w[..., None, None] * J_pose
    M = einsum("poab,poac->pobc", wJp, J_pose)
    Hpp = einsum("pok,pobc->kbc", onehot, M)
    wJl = w[..., None, None] * J_pt
    Hll = einsum("poab,poac->pbc", wJl, J_pt)
    C = einsum("poab,poac->pobc", wJp, J_pt)
    T1 = einsum("pok,pobc->pkbc", onehot, C)
    from gf_orb_slam2_tpu.utils.linalg3 import inv3

    Vinv = inv3(
        Hll + eps * jnp.eye(3, dtype=Hll.dtype)
    ) * prob.pt_valid[:, None, None]
    T1V = einsum("pkab,pbc->pkac", T1, Vinv)
    S_cross = einsum("pkac,pmdc->kmad", T1V, T1)  # [K,K,6,6]
    S = -S_cross
    S = S.at[jnp.arange(K), jnp.arange(K)].add(Hpp)
    return S


def local_bundle_adjustment(
    prob: LocalBAProblem, fx, fy, cx, cy, bf,
    iters_first: int = 5, iters_second: int = 10, damping: float = 1e-4,
    free_cap: int = None,
):
    """Run the reference's 5-iter → gate → 10-iter LM schedule
    (Optimizer.cc:1390-1470) with step acceptance.

    `free_cap`: if set, the pose system is COMPACTED to the first `free_cap`
    free poses before the solve — fixed poses contribute residuals but no
    rows, so the reduced camera system is [6F,6F] instead of [6K,6K]. With
    the good-graph subgraph active, F≈n_sel≈20-60 while K_pad=120: the
    per-iteration Schur einsums shrink ~(K/F)² and the dense solve ~(K/F)³.
    Free poses beyond the cap are held fixed (the good-graph pool bound —
    reference Optimizer.h:45 — keeps the real count below it).
    """
    K = prob.kf_R.shape[0]
    is_stereo = prob.obs_ur >= 0
    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = jnp.where(is_stereo, HUBER_STEREO, HUBER_MONO)
    opt_mask = (~prob.kf_fixed) & prob.kf_valid  # poses that move
    if free_cap is not None and free_cap < K:
        F = free_cap
        # stable compaction: free poses first, then a [K]→[F] slot lut
        order = jnp.argsort(~opt_mask, stable=True)
        free_idx = order[:F]                       # [F] global slots
        f_valid = opt_mask[free_idx]
        lut = jnp.full((K,), -1, jnp.int32).at[free_idx].set(
            jnp.where(f_valid, jnp.arange(F, dtype=jnp.int32), -1))
        obs_slot = jnp.where(prob.obs_kf >= 0,
                             lut[jnp.maximum(prob.obs_kf, 0)], -1)  # [P,O]
    else:
        F = K
        free_idx = jnp.arange(K)
        f_valid = opt_mask
        obs_slot = jnp.where(opt_mask[jnp.maximum(prob.obs_kf, 0)]
                             & (prob.obs_kf >= 0), prob.obs_kf, -1)
    onehot = jax.nn.one_hot(obs_slot, F, dtype=prob.kf_R.dtype)  # [P,O,F]

    base_valid = prob.obs_valid & (prob.obs_kf >= 0) & prob.pt_valid[:, None]

    def robust_cost(kf_R, kf_t, pt_pos, active):
        r, _, _, depth = _residuals(prob, kf_R, kf_t, pt_pos, fx, fy, cx, cy, bf)
        c2 = _chi2(r, prob.obs_inv_sigma2, is_stereo)
        e = jnp.sqrt(jnp.maximum(c2, 1e-12))
        rho = jnp.where(e <= delta, c2, 2.0 * delta * e - delta * delta)
        return jnp.sum(jnp.where(active & (depth > 1e-4), rho, 0.0))

    def lm_iter(carry, step):
        kf_R, kf_t, pt_pos, active, lam, cost = carry
        r, J_pose, J_pt, depth = _residuals(prob, kf_R, kf_t, pt_pos, fx, fy, cx, cy, bf)
        c2 = _chi2(r, prob.obs_inv_sigma2, is_stereo)
        e = jnp.sqrt(jnp.maximum(c2, 1e-12))
        # mid-schedule outlier gate (reference 5-iter → gate → 10-iter),
        # applied at the START of the following step from this step's
        # residuals — same pose as gating after step iters_first-1, but no
        # extra residual pass (two passes per LM step total)
        gate = step == iters_first
        gated = base_valid & (c2 <= chi2_th) & (depth > 1e-4)
        active = jnp.where(gate, gated, active)
        rho = jnp.where(e <= delta, c2, 2.0 * delta * e - delta * delta)
        cost = jnp.where(
            gate,
            jnp.sum(jnp.where(active & (depth > 1e-4), rho, 0.0)),
            cost,
        )
        lam = jnp.where(gate, 1e-4, lam)
        w_huber = jnp.where(e <= delta, 1.0, delta / e)
        w = prob.obs_inv_sigma2 * w_huber * (active & (depth > 1e-4)).astype(r.dtype)
        # zero out fixed/invalid/over-cap pose Jacobians
        pose_on = obs_slot >= 0                                          # [P,O]
        Jp = J_pose * pose_on[..., None, None].astype(r.dtype)

        # ---- blocks (einsums staged so no [P,O,F,6,6] intermediate exists)
        wJp = w[..., None, None] * Jp                                    # [P,O,3,6]
        M = einsum("poab,poac->pobc", wJp, Jp)                           # [P,O,6,6]
        Hpp = einsum("pok,pobc->kbc", onehot, M)                         # [F,6,6]
        vb = einsum("poab,poa->pob", wJp, r)                             # [P,O,6]
        bp = einsum("pok,pob->kb", onehot, vb)                           # [F,6]
        wJl = w[..., None, None] * J_pt                                  # [P,O,3,3]
        Hll = einsum("poab,poac->pbc", wJl, J_pt)                        # [P,3,3]
        bl = einsum("poab,poa->pb", wJl, r)                              # [P,3]
        C = einsum("poab,poac->pobc", wJp, J_pt)                         # [P,O,6,3]
        T1 = einsum("pok,pobc->pkbc", onehot, C)                         # [P,F,6,3]

        lamHll = Hll + (damping + lam) * jnp.eye(3, dtype=Hll.dtype) * (
            1.0 + einsum("pii->p", Hll)[:, None, None] / 3.0
        )
        from gf_orb_slam2_tpu.utils.linalg3 import inv3

        Vinv = inv3(lamHll) * prob.pt_valid[:, None, None]              # [P,3,3]

        T1V = einsum("pkab,pbc->pkac", T1, Vinv)                         # [P,F,6,3]
        S_cross = einsum("pkac,pmdc->kmad", T1V, T1)                     # [F,F,6,6]
        S = Hpp_mat(Hpp, lam, damping) - S_cross.transpose(0, 2, 1, 3).reshape(F * 6, F * 6)
        bs = bp.reshape(-1) - einsum("pkac,pc->ka", T1V, bl).reshape(-1)
        # inactive slots: identity rows
        act6 = jnp.repeat(f_valid, 6)
        S = jnp.where(act6[:, None] & act6[None, :], S, 0.0)
        S = S + jnp.diag(jnp.where(act6, 0.0, 1.0))
        bs = jnp.where(act6, bs, 0.0)
        # S is SPD (damped): Cholesky solve (half the cost of the LU path)
        Lchol = jnp.linalg.cholesky(S)
        y = jax.scipy.linalg.solve_triangular(Lchol, bs, lower=True)
        xi_f = -jax.scipy.linalg.solve_triangular(
            Lchol.T, y, lower=False).reshape(F, 6)
        xi_f = xi_f * f_valid[:, None]
        # back-substitute points: Hll dx = -(bl + T1ᵀ xi)
        rhs_l = bl + einsum("pkab,ka->pb", T1, xi_f)
        dx = -einsum("pbc,pc->pb", Vinv, rhs_l)
        # scatter the compacted update back to the full pose set
        xi_p = jnp.zeros((K, 6), xi_f.dtype).at[free_idx].set(xi_f)

        dR, dt = lie.se3_exp(xi_p)  # [K,3,3],[K,3]
        kf_R_new, kf_t_new = lie.se3_compose(dR, dt, kf_R, kf_t)
        pt_new = pt_pos + dx * prob.pt_valid[:, None]
        cost_new = robust_cost(kf_R_new, kf_t_new, pt_new, active)
        # reject non-finite steps EXPLICITLY: cholesky returns NaN (not an
        # error) on an S driven indefinite by f32 roundoff, and a NaN pose
        # NaN-masks every depth test so robust_cost returns 0.0 — which
        # would be "accepted" by the plain cost comparison and poison the
        # whole window (the r3 rendered-loop NaN trajectory regression)
        finite = (jnp.isfinite(xi_f).all() & jnp.isfinite(dx).all()
                  & jnp.isfinite(cost_new))
        accept = (cost_new < cost) & finite
        kf_R = jnp.where(accept, kf_R_new, kf_R)
        kf_t = jnp.where(accept, kf_t_new, kf_t)
        pt_pos = jnp.where(accept, pt_new, pt_pos)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e6)
        return (kf_R, kf_t, pt_pos, active, lam, cost), None

    def Hpp_mat(Hpp, lam, damping):
        K_ = Hpp.shape[0]
        D = jnp.eye(6, dtype=Hpp.dtype)[None] * (
            damping + lam + einsum("kii->k", Hpp)[:, None, None] / 6.0 * lam
        )
        blocks = Hpp + D
        return (
            jnp.zeros((K_, K_, 6, 6), Hpp.dtype)
            .at[jnp.arange(K_), jnp.arange(K_)]
            .set(blocks)
            .transpose(0, 2, 1, 3)
            .reshape(K_ * 6, K_ * 6)
        )

    kf_R, kf_t, pt_pos = prob.kf_R, prob.kf_t, prob.pt_pos
    active = base_valid
    cost0 = robust_cost(kf_R, kf_t, pt_pos, active)
    lam0 = jnp.float32(1e-4)
    (kf_R, kf_t, pt_pos, active, lam, cost), _ = jax.lax.scan(
        lm_iter, (kf_R, kf_t, pt_pos, active, lam0, cost0),
        jnp.arange(iters_first + iters_second),
    )
    r, _, _, depth = _residuals(prob, kf_R, kf_t, pt_pos, fx, fy, cx, cy, bf)
    c2 = _chi2(r, prob.obs_inv_sigma2, is_stereo)
    inlier = base_valid & (c2 <= chi2_th) & (depth > 1e-4)
    return LocalBAResult(kf_R, kf_t, pt_pos, inlier, cost)
