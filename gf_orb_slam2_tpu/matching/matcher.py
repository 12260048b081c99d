"""Descriptor matching: projection search, frame↔frame, rotation consistency.

JAX replacement for ORBmatcher (reference: src/ORBmatcher.cc). The
reference prunes candidates through a 64x48 per-frame grid
(Frame::GetFeaturesInArea, src/Frame.cc:593) then loops per point; on the
device we evaluate the FULL masked [P,N] Hamming matrix in one shot — the grid
bookkeeping costs more than the brute-force matrix at these sizes.

Covered reference entry points:
- SearchByProjection (map→frame, ORBmatcher.cc:155) → `search_by_projection`
- SearchByProjection (last-frame→frame, :1440)      → same fn, caller preps
- SearchForInitialization (:520)                    → `match_window`
- SearchByBoW (:270/:635)                           → `match_all` (brute force
  replaces BoW-node pruning; the vocabulary is only needed for loop/reloc
  retrieval, not match pruning, here)
- rotation-histogram filter ComputeThreeMaxima (:1723) → `rotation_consistency`
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam2_tpu.matching import hamming

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30


class Matches(NamedTuple):
    """Row i (query) matched to col idx[i] (train); -1 if unmatched."""

    idx: jnp.ndarray   # [P] int32
    dist: jnp.ndarray  # [P] int32
    valid: jnp.ndarray  # [P] bool


def search_by_projection(
    pred_uv, pred_octave, pred_valid, point_desc,
    kp_uv, kp_octave, kp_valid, kp_desc,
    radius, level_scales, th=TH_HIGH, nn_ratio=None, octave_window=1,
):
    """Match map points (projected into the frame) against frame keypoints.

    pred_uv: [P,2] predicted pixel positions; pred_octave: [P] predicted
    pyramid level (from distance/scale-invariance, reference
    MapPoint::PredictScale src/MapPoint.cc:542); radius: [P] or scalar base
    search radius in level-0 px (reference r=2.5/4.0 × level scale,
    ORBmatcher.cc:155); level_scales: [L] per-level scale factors.
    Returns Matches over P rows into keypoint columns (one-to-one).
    """
    P = pred_uv.shape[0]
    N = kp_uv.shape[0]
    r = radius * level_scales[jnp.clip(pred_octave, 0, level_scales.shape[0] - 1)]
    d2 = jnp.sum((pred_uv[:, None, :] - kp_uv[None, :, :]) ** 2, -1)  # [P,N]
    in_window = d2 <= (r[:, None] ** 2)
    oct_ok = jnp.abs(kp_octave[None, :] - pred_octave[:, None]) <= octave_window
    mask = in_window & oct_ok & pred_valid[:, None] & kp_valid[None, :]
    dist = hamming.distance_matrix(point_desc, kp_desc)
    best_idx, best, second = hamming.masked_best2(dist, mask)
    accept = best <= th
    if nn_ratio is not None:
        accept = accept & (best.astype(jnp.float32) <= nn_ratio * second.astype(jnp.float32))
    accept = hamming.resolve_duplicates(best_idx, best, accept, N)
    return Matches(jnp.where(accept, best_idx, -1), best, accept)


def match_all(
    desc_a, valid_a, desc_b, valid_b,
    th=TH_LOW, nn_ratio=0.9, mutual=True,
):
    """Brute-force best match a→b with ratio test (and optional mutual check).

    Replaces SearchByBoW's vocabulary-node-pruned loops (ORBmatcher.cc:270):
    on the device the full Hamming matrix is cheaper than FeatureVector
    bookkeeping.
    """
    mask = valid_a[:, None] & valid_b[None, :]
    dist = hamming.distance_matrix(desc_a, desc_b)
    best_idx, best, second = hamming.masked_best2(dist, mask)
    accept = (best <= th) & (
        best.astype(jnp.float32) <= nn_ratio * second.astype(jnp.float32)
    )
    if mutual:
        bi_b, _, _ = hamming.masked_best2(dist.T, mask.T)
        accept = accept & (bi_b[best_idx] == jnp.arange(desc_a.shape[0]))
    accept = accept & hamming.resolve_duplicates(best_idx, best, accept, desc_b.shape[0])
    return Matches(jnp.where(accept, best_idx, -1), best, accept)


def match_window(
    uv_a, desc_a, valid_a, uv_b, desc_b, valid_b,
    window=100.0, th=TH_LOW, nn_ratio=0.9,
):
    """Window-constrained matching for monocular initialization
    (reference: SearchForInitialization ORBmatcher.cc:520, window=100px)."""
    d2 = jnp.sum((uv_a[:, None, :] - uv_b[None, :, :]) ** 2, -1)
    mask = (d2 <= window * window) & valid_a[:, None] & valid_b[None, :]
    dist = hamming.distance_matrix(desc_a, desc_b)
    best_idx, best, second = hamming.masked_best2(dist, mask)
    accept = (best <= th) & (
        best.astype(jnp.float32) <= nn_ratio * second.astype(jnp.float32)
    )
    accept = hamming.resolve_duplicates(best_idx, best, accept, desc_b.shape[0])
    return Matches(jnp.where(accept, best_idx, -1), best, accept)


def rotation_consistency(angle_a, angle_b, matches: Matches, n_keep_bins=3):
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (reference: ComputeThreeMaxima ORBmatcher.cc:1723 +
    mbCheckOrientation loops; 30 bins over 360°).

    angle_a: [P] query angles (radians); angle_b: [N] train angles.
    """
    idx = jnp.clip(matches.idx, 0, angle_b.shape[0] - 1)
    rot = angle_a - angle_b[idx]
    deg = jnp.rad2deg(rot) % 360.0
    bins = jnp.clip((deg / (360.0 / HISTO_LENGTH)).astype(jnp.int32), 0, HISTO_LENGTH - 1)
    counts = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bins].add(matches.valid.astype(jnp.int32))
    top_vals, top_bins = jax.lax.top_k(counts, n_keep_bins)
    # reference drops bins 2/3 when much smaller than bin 1 (<0.1×max)
    keep_bin = top_vals >= jnp.maximum(1, (0.1 * top_vals[0]).astype(jnp.int32))
    in_top = jnp.any((bins[:, None] == top_bins[None, :]) & keep_bin[None, :], -1)
    valid = matches.valid & in_top
    return Matches(jnp.where(valid, matches.idx, -1), matches.dist, valid)


def search_by_sim3(
    s12, R12, t12, pc1, pc2, desc1, desc2, valid1, valid2,
    cam_project, th_px=7.5, th=TH_HIGH,
):
    """Cross-projection matching between two keyframes under a Sim3 guess
    (reference: SearchBySim3 ORBmatcher.cc:406). pc1/pc2 are camera-frame
    points of each KF; (s12,R12,t12) maps cam1 coords INTO cam2 coords
    (pc2 ≈ s·R·pc1 + t, the Sim3Result convention of sim3solver.solve_sim3);
    cam_project(pc)→(uv,z). Returns Matches 1→2."""
    from gf_orb_slam2_tpu.geometry import lie

    p1in2 = lie.sim3_apply(s12, R12, t12, pc1)  # map KF1 points into cam2
    uv1in2, z1 = cam_project(p1in2)
    s21, R21, t21 = lie.sim3_inv(s12, R12, t12)
    p2in1 = lie.sim3_apply(s21, R21, t21, pc2)  # map KF2 points into cam1
    uv2in1, z2 = cam_project(p2in1)
    uv1, _ = cam_project(pc1)
    uv2, _ = cam_project(pc2)
    # match 1→2 in image 2 and 2→1 in image 1; accept agreement
    d2_a = jnp.sum((uv1in2[:, None, :] - uv2[None, :, :]) ** 2, -1)
    d2_b = jnp.sum((uv2in1[:, None, :] - uv1[None, :, :]) ** 2, -1).T
    mask = (
        (d2_a <= th_px * th_px) & (d2_b <= th_px * th_px)
        & valid1[:, None] & valid2[None, :]
        & (z1[:, None] > 0) & (z2[None, :] > 0)
    )
    dist = hamming.distance_matrix(desc1, desc2)
    best_idx, best, _ = hamming.masked_best2(dist, mask)
    accept = best <= th
    accept = hamming.resolve_duplicates(best_idx, best, accept, desc2.shape[0])
    return Matches(jnp.where(accept, best_idx, -1), best, accept)
