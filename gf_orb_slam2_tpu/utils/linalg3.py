"""Closed-form batched 3x3 linear algebra (adjugate / Cramer).

Library decompositions (eigh/svd/lu) carry large fixed costs on tiny batched
matrices. A 3x3 inverse/solve is nine fused multiply-adds — elementwise work
that XLA folds into the surrounding program.
"""
from __future__ import annotations

import jax.numpy as jnp


def adjugate3(M):
    """Batched [..,3,3] adjugate (transpose of cofactor matrix)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    row0 = jnp.stack([c00, c01, c02], -1)
    row1 = jnp.stack([c10, c11, c12], -1)
    row2 = jnp.stack([c20, c21, c22], -1)
    return jnp.stack([row0, row1, row2], -2)


def det3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3(M, eps: float = 1e-12):
    """Batched 3x3 inverse via adjugate/determinant."""
    det = det3(M)
    det = jnp.where(jnp.abs(det) < eps, jnp.where(det < 0, -eps, eps), det)
    return adjugate3(M) / det[..., None, None]


def solve3(M, b, eps: float = 1e-12):
    """Batched 3x3 solve M x = b (Cramer via adjugate). The contraction is
    written as an elementwise multiply-sum so it can NOT lower to a bf16
    dot_general (pose/point math must stay f32 — utils/precision.py)."""
    det = det3(M)
    det = jnp.where(jnp.abs(det) < eps, jnp.where(det < 0, -eps, eps), det)
    return (adjugate3(M) * b[..., None, :]).sum(-1) / det[..., None]
