"""Hamming distance over 256-bit binary descriptors (uint32[...,8]).

Replaces ORBmatcher::DescriptorDistance (reference: src/ORBmatcher.cc:1768 —
the classic popcount bit-trick on 8 words) with whole-matrix XOR+popcount:
one [N,M] distance matrix per call instead of per-pair scalar loops.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

MAX_DIST = 256


def distance_matrix(da, db):
    """da: [N,8] uint32, db: [M,8] uint32 → [N,M] int32 Hamming distances.

    Plain XOR → popcount → sum over the 8 words; XLA fuses the chain into
    its reduction, so the [N,M,8] intermediate never reaches device memory."""
    x = jnp.bitwise_xor(da[:, None, :], db[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def distance_pairs(da, db):
    """Row-wise distances for aligned pairs: [N,8] × [N,8] → [N]."""
    x = jnp.bitwise_xor(da, db)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def masked_best2(dist, mask):
    """Best and second-best per row under mask.

    dist: [N,M] int32; mask: [N,M] bool.
    Returns (best_idx [N], best [N], second [N]); masked-out rows get
    best = MAX_DIST.
    """
    d = jnp.where(mask, dist, MAX_DIST)
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.min(d, axis=1)
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(MAX_DIST)
    second = jnp.min(d2, axis=1)
    return best_idx.astype(jnp.int32), best, second


def resolve_duplicates(best_idx, best, accept, n_cols: int):
    """Enforce one-to-one: if several rows claim the same column, keep the row
    with the smallest distance (reference keeps best per keypoint slot,
    ORBmatcher.cc:155 region bestDist bookkeeping).

    Returns updated accept mask.
    """
    big = MAX_DIST + 1
    col_min = jnp.full((n_cols,), big, best.dtype)
    col_min = col_min.at[best_idx].min(jnp.where(accept, best, big))
    keep = accept & (best <= col_min[best_idx])
    # tie-break duplicate equal distances: first row wins
    n_rows = best.shape[0]
    order = jnp.arange(n_rows)
    col_first = jnp.full((n_cols,), n_rows, order.dtype)
    col_first = col_first.at[best_idx].min(jnp.where(keep, order, n_rows))
    return keep & (order == col_first[best_idx])
