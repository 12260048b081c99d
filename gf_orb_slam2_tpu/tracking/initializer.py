"""Monocular map initialization: batched H/F RANSAC + motion recovery.

JAX replacement for the Initializer class (reference:
src/Initializer.cc — launches two std::threads computing a homography and a
fundamental matrix RANSAC in parallel (Initializer.cc:44), scores them,
picks by the SH/(SH+SF) ratio, and recovers motion via Faugeras (H) or the
essential matrix (F)).

Device design (SURVEY.md §2.3 P4): ALL RANSAC hypotheses of BOTH models run as
one batched program — [S,8]-sampled minimal sets, batched normalized DLT via
eigh of AᵀA, batched symmetric-transfer scoring, argmax. Motion recovery:
- from F: E = KᵀFK, SVD → 4 (R,t) candidates, cheirality vote (batched
  triangulation of all inliers under all 4).
- from H: SVD decomposition (Faugeras/Malis) → 8 candidates, same vote.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam2_tpu.geometry import lie, triangulate
from gf_orb_slam2_tpu.utils.precision import einsum, matmul

SIGMA = 1.0
CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # reference: both scores accumulate (th - chi2) capped


class InitResult(NamedTuple):
    ok: jnp.ndarray          # bool
    R: jnp.ndarray           # [3,3] cam2←cam1 (world = cam1)
    t: jnp.ndarray           # [3] unit-norm translation
    points: jnp.ndarray      # [N,3] triangulated in cam1 frame
    is_inlier: jnp.ndarray   # [N] bool (triangulated + checks)
    used_h: jnp.ndarray      # bool — which model won


def _normalize(uv, valid):
    """Isotropic normalization (reference: Initializer::Normalize)."""
    n = jnp.maximum(jnp.sum(valid), 1)
    mean = jnp.sum(jnp.where(valid[:, None], uv, 0.0), 0) / n
    d = jnp.where(valid[:, None], uv - mean, 0.0)
    mean_dev = jnp.sum(jnp.abs(d), 0) / n
    s = 1.0 / jnp.maximum(mean_dev, 1e-6)
    uvn = d * s
    T = jnp.array(
        [[s[0], 0.0, -mean[0] * s[0]], [0.0, s[1], -mean[1] * s[1]], [0.0, 0.0, 1.0]]
    )
    return uvn, T


def _dlt_homography(p1, p2, w=None):
    """[N,2]×[N,2] (opt. weights) → H (p2 ≈ H p1) via eigh of AᵀA."""
    x, y = p1[:, 0], p1[:, 1]
    u, v = p2[:, 0], p2[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    r2 = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    A = jnp.concatenate([r1, r2], 0)
    if w is not None:
        A = A * jnp.concatenate([w, w])[:, None]
    AtA = einsum("ki,kj->ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    return vecs[:, 0].reshape(3, 3)


def _dlt_fundamental(p1, p2, w=None):
    """Normalized 8-point (or weighted all-point refit): F, rank-2 enforced."""
    x, y = p1[:, 0], p1[:, 1]
    u, v = p2[:, 0], p2[:, 1]
    o = jnp.ones_like(x)
    A = jnp.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], -1)
    if w is not None:
        A = A * w[:, None]
    AtA = einsum("ki,kj->ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    F = vecs[:, 0].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    return (U * S[None, :]) @ Vt


def _score_h(H, uv1, uv2, valid, sigma2=SIGMA**2):
    """Symmetric transfer error score (reference: CheckHomography)."""
    Hinv = jnp.linalg.inv(H + 1e-12 * jnp.eye(3))

    def transfer(M, a):
        ah = jnp.concatenate([a, jnp.ones_like(a[:, :1])], -1)
        b = matmul(ah, M.T)
        return b[:, :2] / jnp.where(jnp.abs(b[:, 2:]) < 1e-9, 1e-9, b[:, 2:])

    e12 = jnp.sum((transfer(H, uv1) - uv2) ** 2, -1) / sigma2
    e21 = jnp.sum((transfer(Hinv, uv2) - uv1) ** 2, -1) / sigma2
    in12 = e12 < CHI2_H
    in21 = e21 < CHI2_H
    score = jnp.where(valid & in12, SCORE_TH - e12, 0.0) + jnp.where(
        valid & in21, SCORE_TH - e21, 0.0
    )
    return jnp.sum(score), valid & in12 & in21


def _score_f(F, uv1, uv2, valid, sigma2=SIGMA**2):
    """Epipolar distance score (reference: CheckFundamental)."""
    ah1 = jnp.concatenate([uv1, jnp.ones_like(uv1[:, :1])], -1)
    ah2 = jnp.concatenate([uv2, jnp.ones_like(uv2[:, :1])], -1)
    l2 = ah1 @ F.T  # lines in image 2
    d2 = jnp.sum(l2 * ah2, -1) ** 2 / jnp.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12) / sigma2
    l1 = ah2 @ F
    d1 = jnp.sum(l1 * ah1, -1) ** 2 / jnp.maximum(l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12) / sigma2
    in2 = d2 < CHI2_F
    in1 = d1 < CHI2_F
    score = jnp.where(valid & in2, SCORE_TH - d2, 0.0) + jnp.where(
        valid & in1, SCORE_TH - d1, 0.0
    )
    return jnp.sum(score), valid & in1 & in2


def _decompose_E(E):
    """E → 4 candidate (R, t) (reference: DecomposeE Initializer.cc:917)."""
    U, _, Vt = jnp.linalg.svd(E)
    d = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    U = U * jnp.where(d < 0, -1.0, 1.0)
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _decompose_H(H, K):
    """H → 8 candidate (R, t) via the SVD method (Faugeras; reference:
    ReconstructH Initializer.cc:577)."""
    A = matmul(matmul(jnp.linalg.inv(K), H), K)
    U, w, Vt = jnp.linalg.svd(A)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    # x1/x3 magnitudes
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.array([aux1, aux1, -aux1, -aux1])
    x3s = jnp.array([aux3, -aux3, aux3, -aux3])
    # case d' > 0
    sin_t = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum((d1 + d3) * d2, 1e-12)
    cos_t = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    st = jnp.array([sin_t, -sin_t, -sin_t, sin_t])

    def make_case_pos(i):
        Rp = jnp.array(
            [[cos_t, 0.0, -st[i]], [0.0, 1.0, 0.0], [st[i], 0.0, cos_t]]
        )
        R = s * matmul(matmul(U, Rp), Vt)
        tp = jnp.array([x1s[i], 0.0, -x3s[i]]) * (d1 - d3)
        t = matmul(U, tp[:, None])[:, 0]
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-9)

    # case d' < 0
    sin_p = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / jnp.maximum((d1 - d3) * d2, 1e-12)
    cos_p = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sp = jnp.array([sin_p, -sin_p, -sin_p, sin_p])

    def make_case_neg(i):
        Rp = jnp.array(
            [[cos_p, 0.0, sp[i]], [0.0, -1.0, 0.0], [sp[i], 0.0, -cos_p]]
        )
        R = s * matmul(matmul(U, Rp), Vt)
        tp = jnp.array([x1s[i], 0.0, x3s[i]]) * (d1 + d3)
        t = matmul(U, tp[:, None])[:, 0]
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-9)

    Rs, ts = [], []
    for i in range(4):
        R, t = make_case_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = make_case_neg(i)
        Rs.append(R)
        ts.append(t)
    return jnp.stack(Rs), jnp.stack(ts)


def _cheirality_vote(Rs, ts, K, uv1, uv2, valid, min_parallax_cos=0.99995):
    """Triangulate all inliers under each candidate, count points that are in
    front of both cameras with parallax (reference: CheckRT Initializer.cc:805).
    Returns (best_idx, votes [C], points [C,N,3], good [C,N])."""
    eye = jnp.eye(3)
    zero = jnp.zeros(3)
    P1 = triangulate.projection_matrix(K, eye, zero)

    def check_one(R, t):
        P2 = triangulate.projection_matrix(K, R, t)
        X = triangulate.triangulate_dlt(P1, P2, uv1, uv2)
        ok = triangulate.triangulation_checks(
            X, eye, zero, R, t, uv1, uv2, K,
            jnp.ones(uv1.shape[0]), jnp.ones(uv1.shape[0]),
            min_parallax_cos=min_parallax_cos, chi2=4.0 * CHI2_H,
        )
        ok = ok & valid
        return X, ok

    X, good = jax.vmap(check_one)(Rs, ts)
    votes = jnp.sum(good, -1)
    best = jnp.argmax(votes)
    return best, votes, X, good


def initialize(
    uv1, uv2, valid, K, key, n_hyp: int = 256,
    min_inliers: int = 50, min_triangulated: int = 50,
):
    """Full two-view bootstrap (reference: Initializer::Initialize
    Initializer.cc:44). uv1/uv2: matched undistorted pixels [N,2]; valid: [N].

    Returns InitResult. The winning model follows the reference's
    RH = SH/(SH+SF) > 0.40 rule (Initializer.cc:105).
    """
    N = uv1.shape[0]
    n1, T1 = _normalize(uv1, valid)
    n2, T2 = _normalize(uv2, valid)
    T2inv = jnp.linalg.inv(T2)

    # minimal-set sampling restricted to valid entries: sample from a
    # precomputed valid-index list (invalid rows fall back to index 0)
    idx_valid = jnp.argsort(~valid)  # valid first
    n_valid = jnp.sum(valid)
    draws = jax.random.randint(key, (n_hyp, 8), 0, jnp.maximum(n_valid, 8))
    samples = idx_valid[draws]  # [S,8]

    p1s = n1[samples]  # [S,8,2]
    p2s = n2[samples]

    Hs_n = jax.vmap(_dlt_homography)(p1s, p2s)
    Fs_n = jax.vmap(_dlt_fundamental)(p1s, p2s)
    # denormalize
    Hs = einsum("ij,sjk,kl->sil", T2inv, Hs_n, T1)
    Fs = einsum("ji,sjk,kl->sil", T2, Fs_n, T1)

    h_scores, h_inl = jax.vmap(lambda H: _score_h(H, uv1, uv2, valid))(Hs)
    f_scores, f_inl = jax.vmap(lambda F: _score_f(F, uv1, uv2, valid))(Fs)
    bh = jnp.argmax(h_scores)
    bf_ = jnp.argmax(f_scores)
    # refit each winning model on all of its inliers (reference refines by
    # re-scoring; an inlier least-squares refit is strictly better)
    H_ref = einsum("ij,jk,kl->il", T2inv,
                   _dlt_homography(n1, n2, h_inl[bh].astype(n1.dtype)), T1)
    F_ref = einsum("ji,jk,kl->il", T2,
                   _dlt_fundamental(n1, n2, f_inl[bf_].astype(n1.dtype)), T1)
    SH, h_inl_ref = _score_h(H_ref, uv1, uv2, valid)
    SF, f_inl_ref = _score_f(F_ref, uv1, uv2, valid)
    RH = SH / jnp.maximum(SH + SF, 1e-9)
    use_h = RH > 0.40

    Rs_h, ts_h = _decompose_H(H_ref, K)
    E = matmul(matmul(K.T, F_ref), K)
    Rs_f, ts_f = _decompose_E(E)
    # pad F's 4 candidates to 8 with degenerate (zero-baseline) entries that
    # collect no cheirality votes — duplication would defeat the
    # clear-winner test below
    Rs_pad = jnp.broadcast_to(jnp.eye(3), (4, 3, 3))
    ts_pad = jnp.zeros((4, 3))
    Rs_f8 = jnp.concatenate([Rs_f, Rs_pad], 0)
    ts_f8 = jnp.concatenate([ts_f, ts_pad], 0)
    Rs = jnp.where(use_h, Rs_h, Rs_f8)
    ts = jnp.where(use_h, ts_h, ts_f8)
    model_inl = jnp.where(use_h, h_inl_ref, f_inl_ref)

    best, votes, X, good = _cheirality_vote(Rs, ts, K, uv1, uv2, model_inl)
    n_good = votes[best]
    # acceptance (reference: nGood > 0.9*nInliers-ish, second-best clearly
    # worse, enough triangulated)
    votes_sorted = jnp.sort(votes)
    second = votes_sorted[-2]
    distinct = n_good > 1.5 * second  # a clear winner among candidates
    ok = (
        (jnp.sum(model_inl) >= min_inliers)
        & (n_good >= min_triangulated)
        & distinct
    )
    return InitResult(
        ok=ok,
        R=Rs[best],
        t=ts[best],
        points=X[best],
        is_inlier=good[best],
        used_h=use_h,
    )
