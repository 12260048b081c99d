"""Good-feature selection: lazier-greedy Max-logDet active matching.

JAX replacement for Observability::runActiveMapMatching (reference:
src/Observability.cc:830, IROS18/TRO20 "Good Feature Matching"): instead of
matching every local map point, actively pick the subset that maximizes the
log-determinant of the pose information matrix, under a per-frame budget
(reference: constraints-per-frame, System::SetConstrPerFrame System.cc:444).

Reference mechanics → device design:
- per-round random subset of size ~P/k (lazier greedy, Observability.cc:902)
  → masked uniform sampling with a jax PRNG key;
- per-candidate logDet(curMat + ObsMat_i) scoring on 7x7 matrices (:956)
  → one batched slogdet over the whole subset per round (vmap);
- match-then-update sequencing (match argmax point via
  SearchByProjection_OnePoint, add its stereo row, repeat :982-1025)
  → selection is fully device-side over predicted info matrices; the
  selected subset is then matched in ONE batched projection search. The
  wall-clock budget becomes the fixed round count (SURVEY.md §7.3).

The greedy round loop is a lax.scan of `n_select` rounds — sequential by
nature (each pick conditions the next score) but each round is fully
parallel over candidates.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from gf_orb_slam2_tpu.selection.observability import logdet_psd
from gf_orb_slam2_tpu.utils.precision import einsum


def lazier_greedy_select(
    obs_mats, valid, n_select: int, key, lazier_factor: int = 10,
    base_mat=None, eps: float = 1e-3, batch: int = 8,
):
    """Select `n_select` landmarks maximizing logdet(Σ selected ObsMat).

    obs_mats: [P,D,D] per-landmark info matrices; valid: [P] candidate mask;
    base_mat: optional [D,D] prior information (current matched set).
    Returns (selected_mask [P] bool, order [n_select] int32 — -1 padding).

    BATCHED greedy: each round scores a random candidate subset once and
    takes the top-`batch` picks before re-conditioning. The greedy loop is
    inherently sequential, so its cost is the scan length, not the
    per-round FLOPs; batching cuts rounds 8x for a
    negligible logdet gap (the reference's lazier subsampling is already an
    approximation of the same submodular objective, Observability.cc:902).
    """
    P, D, _ = obs_mats.shape
    if base_mat is None:
        base_mat = jnp.zeros((D, D), obs_mats.dtype)
    eye = jnp.eye(D, dtype=obs_mats.dtype)
    B = max(1, min(batch, n_select))
    rounds = -(-n_select // B)
    inv_l = 1.0 / max(lazier_factor, 1)

    traces = jnp.einsum("pii->p", obs_mats)  # cheap fallback score tier
    # per-round slot activity: exactly n_select picks across all rounds
    slot_active = (jnp.arange(rounds * B) < n_select).reshape(rounds, B)

    def round_fn(carry, xs):
        k, active = xs
        cur, selected = carry
        cand = valid & ~selected
        # lazier sampling as a MASK (no gathers/sorts — per-round cost is
        # the kernel-chain length, not the candidate count)
        sampled = cand & (jax.random.uniform(k, (P,)) < inv_l)
        sampled = jnp.where(jnp.any(sampled), sampled, cand)
        trial = cur[None] + obs_mats + eps * eye[None]
        ld = logdet_psd(trial, eps)
        score = jnp.where(sampled, ld, -jnp.inf)
        # fallback tier: rounds whose sample misses every remaining candidate
        # still fill their budget by trace (strictly below any real score)
        fb = jnp.where(cand, traces - 1e12, -jnp.inf)
        vals, pick = jax.lax.top_k(jnp.maximum(score, fb), B)
        ok = jnp.isfinite(vals) & active
        selected = selected.at[pick].max(ok)  # top_k picks are distinct
        cur = cur + einsum(
            "b,bij->ij", ok.astype(obs_mats.dtype), obs_mats[pick]
        )
        return (cur, selected), jnp.where(ok, pick, -1)

    keys = jax.random.split(key, rounds)
    (cur, selected), order = jax.lax.scan(
        round_fn, (base_mat, jnp.zeros(P, bool)), (keys, slot_active)
    )
    return selected, order.reshape(-1)[:n_select].astype(jnp.int32)


def greedy_select_exact(obs_mats, valid, n_select: int, base_mat=None, eps=1e-3):
    """Exact greedy (lazier_factor=1 equivalent): scores ALL candidates every
    round. Baseline for the statistical quality tests (reference:
    test/test_Greedy.cpp runs exact as method 1)."""
    key = jax.random.PRNGKey(0)
    P = obs_mats.shape[0]
    return lazier_greedy_select(
        obs_mats, valid, n_select, key, lazier_factor=1, base_mat=base_mat, eps=eps
    )


def selection_logdet(obs_mats, selected_mask, base_mat=None, eps=1e-3):
    """logdet of the information accumulated by a selection."""
    D = obs_mats.shape[-1]
    M = jnp.sum(obs_mats * selected_mask[:, None, None], axis=0)
    if base_mat is not None:
        M = M + base_mat
    return logdet_psd(M, eps)


def random_select(valid, n_select: int, key):
    """Baseline: random subset (reference: runBaselineMapMatching
    Observability.cc:1171, RANDOM_MAP_MATCHING)."""
    P = valid.shape[0]
    scores = jax.random.uniform(key, (P,)) + (~valid) * -1e9
    _, idx = jax.lax.top_k(scores, n_select)
    mask = jnp.zeros(P, bool).at[idx].set(True) & valid
    return mask, idx.astype(jnp.int32)


def long_lived_select(lifetime, valid, n_select: int):
    """Baseline: the n longest-tracked landmarks (reference:
    Tracking::LongLivedMatches src/Tracking.cc:1771 /
    LONGLIVED_MAP_MATCHING). lifetime: [P] found-counter or age."""
    P = valid.shape[0]
    scores = jnp.where(valid, lifetime.astype(jnp.float32), -jnp.inf)
    _, idx = jax.lax.top_k(scores, n_select)
    mask = jnp.zeros(P, bool).at[idx].set(True) & valid
    return mask, idx.astype(jnp.int32)


def bucketing_select(
    uv, lifetime, valid, n_select: int, width: float, height: float,
    grid: int = 8,
):
    """Baseline: spatially-bucketed budget fill (reference:
    Tracking::BucketingMatches src/Tracking.cc:1666 / BUCKETING_MAP_MATCHING):
    the image is split into grid×grid buckets and every bucket contributes
    its longest-lived candidate before any bucket contributes a second —
    spatial uniformity under the budget.

    uv: [P,2] predicted pixel positions. Fully batched: the within-bucket
    rank is computed by one argsort (bucket-major, lifetime-descending) and
    a segmented position count — no per-bucket loops.
    """
    P = valid.shape[0]
    bx = jnp.clip((uv[:, 0] * grid / width).astype(jnp.int32), 0, grid - 1)
    by = jnp.clip((uv[:, 1] * grid / height).astype(jnp.int32), 0, grid - 1)
    bucket = by * grid + bx
    life = jnp.clip(lifetime.astype(jnp.float32), 0.0, 1e5)
    # sort bucket-major, longest-lived first within a bucket
    skey = bucket.astype(jnp.float32) * 2e5 - life + (~valid) * 1e9
    order = jnp.argsort(skey)
    sb = bucket[order]
    pos = jnp.arange(P)
    new_grp = jnp.concatenate([jnp.ones(1, bool), sb[1:] != sb[:-1]])
    grp_start = jax.lax.associative_scan(jnp.maximum, jnp.where(new_grp, pos, 0))
    rank_sorted = pos - grp_start  # in-bucket rank
    rank = jnp.zeros(P, jnp.int32).at[order].set(rank_sorted.astype(jnp.int32))
    prio = jnp.where(valid, -rank.astype(jnp.float32) * 2e5 + life, -jnp.inf)
    _, idx = jax.lax.top_k(prio, n_select)
    mask = jnp.zeros(P, bool).at[idx].set(True) & valid
    return mask, idx.astype(jnp.int32)
