"""Good-graph selection: budget-aware KF subset for local BA.

JAX replacement for the SLAM++ good-graph solver (reference:
Thirdparty/SLAM++/include/slam/NonlinearSolver_GoodGraph.h — builds lambda,
Schur-complements landmarks to the pose-only SC matrix (:978-1047), then
LazierGreedy_Selection (:1056) picks the KF subset maximizing logDet via
incremental multi-threaded block Cholesky (:1181-1218); driven from
Optimizer::LocalBundleAdjustment via CBAOptimizer::Find_Subgraph
(Optimizer.cc:1156)).

Here the pose-block Schur complement S comes straight from the batched BA
assembly (optim/local_ba.py einsums), and greedy scoring evaluates ALL
candidates per round with one batched slogdet over mask-collapsed [6K,6K]
matrices — the incremental-Cholesky + thread machinery (SURVEY.md §2.3 P7)
becomes a vmapped dense op.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from gf_orb_slam2_tpu.selection.observability import logdet_psd


def masked_logdet(S_blocks, mask, eps=1e-3):
    """logdet of S restricted to selected KFs.

    S_blocks: [K,K,6,6]; mask: [..,K] bool. Unselected rows/cols are zeroed
    and their diagonal set to identity, so the determinant equals that of the
    selected submatrix.
    """
    K = S_blocks.shape[0]
    m = mask.astype(S_blocks.dtype)
    Sm = S_blocks * m[..., :, None, None, None] * m[..., None, :, None, None]
    eyeK = jnp.eye(6, dtype=S_blocks.dtype)
    diag_fix = (1.0 - m)[..., :, None, None] * eyeK
    Sm = Sm.at[..., jnp.arange(K), jnp.arange(K), :, :].add(diag_fix)
    M = jnp.swapaxes(Sm, -3, -2).reshape(mask.shape[:-1] + (K * 6, K * 6))
    return logdet_psd(M, eps)


def _chol6(M, eps=1e-9):
    """Unrolled 6x6 Cholesky (batched). Returns lower-triangular L and
    Σ log diag(L) (half the logdet)."""
    d = M.shape[-1]
    L = jnp.zeros_like(M)
    logdiag = jnp.zeros(M.shape[:-2], M.dtype)
    for j in range(d):
        s = M[..., j, j] - jnp.sum(L[..., j, :j] ** 2, -1)
        dj = jnp.sqrt(jnp.maximum(s, eps))
        L = L.at[..., j, j].set(dj)
        logdiag = logdiag + jnp.log(dj)
        if j + 1 < d:
            r = (
                M[..., j + 1:, j]
                - jnp.sum(L[..., j + 1:, :j] * L[..., None, j, :j], -1)
            ) / dj[..., None]
            L = L.at[..., j + 1:, j].set(r)
    return L, logdiag


def _solve_lower6(L, rhs):
    """Unrolled forward substitution: y = L⁻¹ rhs for a 6x6 lower L and
    [6, M] rhs (six fused FMA rows instead of a library triangular-solve
    call on a tiny matrix)."""
    ys = []
    for j in range(6):
        acc = rhs[j]
        for i in range(j):
            acc = acc - L[j, i] * ys[i]
        ys.append(acc / L[j, j])
    return jnp.stack(ys)


def select_subgraph(
    S_blocks, free_mask, n_select, key, lazier_factor: int = 4,
    always_keep=None, eps: float = 1e-3, n_max: int = None,
):
    """Greedy Max-logDet selection of `n_select` keyframes via INCREMENTAL
    block Cholesky — the reference's GetLogDetInc scheme
    (SLAM++ NonlinearSolver_GoodGraph.h:1181-1218) as fixed-shape scan.

    Maintains X = L⁻¹ S[A,:] directly across rounds (L = chol(S[A,A]) over
    the selected ordering A). Appending KF j extends X by six rows
    Lc⁻¹(S[j,:] − X_jᵀX) — one [6,6n]×[6n,6K] matmul and an unrolled 6×6
    substitution — and existing rows never change, so no per-round
    triangular re-solve exists (an earlier version re-ran a [6n,6n]×[6n,6K]
    solve_triangular every round: sequential back-substitution, the dominant
    selection cost at the 60-KF pool). Scoring stays one batched 6×6
    Cholesky over all K candidates per round: Δ_j = S_jj − X_jᵀX_j.

    S_blocks: [K,K,6,6] pose-Schur information; free_mask: [K] selectable;
    always_keep: [K] bool — pre-selected (slot 0 of the ordering).
    `n_select` may be a TRACED scalar (anticipation budgets vary per KF
    event without recompiling) as long as `n_max` bounds it statically.
    Returns selected mask [K].
    """
    K = S_blocks.shape[0]
    if n_max is None:
        n_max = int(n_select)
    if always_keep is None:
        always_keep = jnp.zeros(K, bool)
    dt = S_blocks.dtype
    N6 = 6 * n_max
    # diagonal scale-normalization (f32: info diagonals span ~1e5..1e8)
    dscale = jnp.sqrt(jnp.maximum(
        jnp.diagonal(S_blocks[jnp.arange(K), jnp.arange(K)], axis1=-2, axis2=-1),
        eps))  # [K,6]
    Sn = S_blocks / (dscale[:, None, :, None] * dscale[None, :, None, :])
    Sn = Sn.at[jnp.arange(K), jnp.arange(K)].add(
        1e-5 * jnp.eye(6, dtype=dt))
    # S as [6K,6K] (row-major over KFs)
    Sfull = jnp.swapaxes(Sn, 1, 2).reshape(K * 6, K * 6)
    Sdiag = Sn[jnp.arange(K), jnp.arange(K)]

    selected0 = jnp.zeros(K, bool)
    X0 = jnp.zeros((N6, K * 6), dt)  # L⁻¹ S[A,:] rows in selection order
    # seed the ordering with always_keep & free (at most one expected: the
    # anchor KF); handled as round 0 with forced argmax
    forced = always_keep & free_mask

    from gf_orb_slam2_tpu.utils.precision import einsum as p_einsum
    from gf_orb_slam2_tpu.utils.precision import matmul as p_matmul

    def round_fn(carry, inp):
        selected, X, n_sel = carry
        r6 = 6 * inp["r"]
        k = inp["key"]
        Xb = X.reshape(N6, K, 6)
        # Δ_j = S_jj - X_jᵀ X_j for all candidates j (f32 contraction:
        # bf16 here corrupts the logdet ranking — utils/precision.py)
        G = p_einsum("nka,nkb->kab", Xb, Xb)
        Delta = Sdiag - G
        Lc, logd = _chol6(Delta)     # [K,6,6], [K] (½ logdet gains)
        u = jax.random.uniform(k, (K,))
        cand = free_mask & ~selected & (u < 1.0 / max(lazier_factor, 1))
        cand = jnp.where(jnp.any(cand), cand, free_mask & ~selected)
        cand = jnp.where(jnp.any(forced & ~selected), forced & ~selected, cand)
        score = jnp.where(cand, logd, -jnp.inf)
        best = jnp.argmax(score)
        ok = jnp.isfinite(score[best]) & (n_sel < n_select)
        # extend the factor solution: rows [r6:r6+6] of X become
        # Lc_best⁻¹ (S[best,:] − X_bestᵀ X); earlier rows are unchanged
        Xbest = Xb[:, best]                       # [N6,6]
        Brow = jax.lax.dynamic_slice(Sfull, (best * 6, 0), (6, K * 6))
        rhs = Brow - p_matmul(Xbest.T, X)         # [6, 6K]
        newrow = _solve_lower6(Lc[best], rhs)
        X = jnp.where(ok, jax.lax.dynamic_update_slice(X, newrow, (r6, 0)), X)
        selected = selected.at[best].set(selected[best] | ok)
        n_sel = n_sel + ok.astype(jnp.int32)
        return (selected, X, n_sel), None

    keys = jax.random.split(key, n_max)
    inps = {"r": jnp.arange(n_max), "key": keys}
    (selected, _, _), _ = jax.lax.scan(
        round_fn, (selected0, X0, jnp.int32(0)), inps)
    return selected


def estimate_kf_budget(time_budget_ms: float, c3=0.0028, c2=0.0, c1=0.7, c0=2.0) -> int:
    """Budget → subgraph-size predictor (reference: Optimizer::estimateKFNum
    Optimizer.cc:566 — cubic time model t(n) = c3·n³+c2·n²+c1·n+c0 in ms,
    inverted by scan). Coefficients are calibration knobs."""
    n = 2
    while n < 64:
        t = c3 * n**3 + c2 * n**2 + c1 * n + c0
        if t > time_budget_ms:
            break
        n += 1
    return max(2, n - 1)
