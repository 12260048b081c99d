"""Spatially-uniform keypoint selection: per-cell top-K + ranked global top-N.

JAX replacement for the reference's recursive quadtree redistribution
(src/ORBextractor.cc DistributeOctTree, called from ComputeKeyPointsOctTree
:767) and the per-30px-cell FAST with threshold fallback 20→7. The quadtree
is inherently sequential; instead we:

1. split the score map into fixed cells and take the top-K responses per cell
   (one reshape + one `top_k` — fully parallel);
2. rank candidates by (rank-within-cell, -score) so every cell contributes
   its best corner before any cell contributes its second — the same spatial
   uniformity the quadtree buys — and take the global top-N.

The ini/min threshold fallback (reference keeps weak corners only in cells
with no strong ones) falls out for free: weak corners have high in-cell rank
only if their cell lacks strong ones.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def cell_topk(score, keep_mask, cell: int, k: int):
    """Per-cell top-K.

    score: [H,W] f32; keep_mask: [H,W] bool (NMS+threshold+border).
    Returns (scores [C*k], ys [C*k], xs [C*k], rank [C*k]) where C is the
    number of cells; invalid entries have score = -inf.
    """
    h, w = score.shape
    gh, gw = -(-h // cell), -(-w // cell)
    ph, pw = gh * cell - h, gw * cell - w
    s = jnp.where(keep_mask, score, -jnp.inf)
    s = jnp.pad(s, ((0, ph), (0, pw)), constant_values=-jnp.inf)
    # [gh, cell, gw, cell] -> [gh*gw, cell*cell]
    s = s.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    vals, idx = jax.lax.top_k(s, k)  # [C, k]
    cy = jnp.arange(gh * gw) // gw
    cx = jnp.arange(gh * gw) % gw
    iy = idx // cell
    ix = idx % cell
    ys = cy[:, None] * cell + iy
    xs = cx[:, None] * cell + ix
    rank = jnp.broadcast_to(jnp.arange(k)[None, :], vals.shape)
    return vals.reshape(-1), ys.reshape(-1), xs.reshape(-1), rank.reshape(-1)


def ranked_topn(scores, ys, xs, rank, n: int, max_score: float = 512.0):
    """Global top-N by (cell-rank asc, score desc).

    Returns (ys [n], xs [n], scores [n], valid [n]).
    """
    valid = jnp.isfinite(scores)
    # priority: higher is better. rank dominates; score breaks ties.
    prio = jnp.where(valid, -rank.astype(jnp.float32) * (2.0 * max_score) + scores, -jnp.inf)
    top, idx = jax.lax.top_k(prio, n)
    return ys[idx], xs[idx], scores[idx], jnp.isfinite(top)
