"""Rectified stereo matching: row-band descriptor match + SAD subpixel refine.

JAX replacement for Frame::ComputeStereoMatches (reference:
src/Frame.cc:889) and the delayed/alternative per-point variants
(`ComputeStereoMatch_OnePoint` Frame.cc:1080, `ComputeStereoMatches_Undistorted`
:1167, `PrepareStereoCandidates` Frame.h:230). The reference's "delayed"
machinery exists because CPU stereo matching is expensive enough to amortize
per-point; on the device the whole frame's [N_l, N_r] masked Hamming matrix plus a
batched SAD refinement is a single cheap program, so we always match all
features at once — the delayed path collapses into this kernel (cited for
capability parity, not copied).

RGB-D depth→disparity (`ComputeStereoFromRGBD`, Frame.cc:1606) lives here too.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from gf_orb_slam2_tpu.matching import hamming

SAD_HALF = 5     # 11x11 SAD window (reference w=5)
SAD_RANGE = 5    # ±5 px sliding search (reference L=5)


class StereoMatches(NamedTuple):
    u_right: jnp.ndarray    # [N] float32; <0 if unmatched (reference mvuRight)
    depth: jnp.ndarray      # [N] float32; <0 if unmatched (reference mvDepth)
    valid: jnp.ndarray      # [N] bool


def match_stereo(
    kp_l_uv, kp_l_oct, kp_l_desc, kp_l_valid,
    kp_r_uv, kp_r_oct, kp_r_desc, kp_r_valid,
    img_l, img_r, level_scales, bf,
    min_z=0.1, th_desc=(hamming.MAX_DIST + 2 * 75) // 3,
):
    """Full-frame stereo matching on rectified pairs.

    img_l/img_r: [H,W] float32 level-0 images (blurred or raw) for SAD.
    Returns StereoMatches aligned with left keypoints.
    """
    n_l = kp_l_uv.shape[0]
    max_d = bf / min_z
    scale_l = level_scales[jnp.clip(kp_l_oct, 0, level_scales.shape[0] - 1)]

    dv = jnp.abs(kp_l_uv[:, None, 1] - kp_r_uv[None, :, 1])
    row_ok = dv <= 2.0 * scale_l[:, None]
    disp = kp_l_uv[:, None, 0] - kp_r_uv[None, :, 0]
    disp_ok = (disp >= -1.0) & (disp <= max_d)
    oct_ok = jnp.abs(kp_l_oct[:, None] - kp_r_oct[None, :]) <= 1
    mask = row_ok & disp_ok & oct_ok & kp_l_valid[:, None] & kp_r_valid[None, :]

    dist = hamming.distance_matrix(kp_l_desc, kp_r_desc)
    best_idx, best, _ = hamming.masked_best2(dist, mask)
    accept = best < th_desc

    # ---- SAD subpixel refinement around the matched right keypoint column
    u_r0 = kp_r_uv[best_idx, 0]
    v_r0 = kp_r_uv[best_idx, 1]
    sads = _sad_curve(img_l, img_r, kp_l_uv, jnp.stack([u_r0, v_r0], -1))
    k = jnp.argmin(sads, axis=-1)  # [N], in [0, 2*SAD_RANGE]
    smin = jnp.min(sads, axis=-1)
    # parabola fit over (k-1, k, k+1)
    km = jnp.clip(k - 1, 0, 2 * SAD_RANGE)
    kp_ = jnp.clip(k + 1, 0, 2 * SAD_RANGE)
    s_m = jnp.take_along_axis(sads, km[:, None], 1)[:, 0]
    s_p = jnp.take_along_axis(sads, kp_[:, None], 1)[:, 0]
    denom = s_m + s_p - 2.0 * smin
    delta = jnp.where(denom > 1e-6, (s_m - s_p) / (2.0 * jnp.maximum(denom, 1e-6)), 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    interior = (k > 0) & (k < 2 * SAD_RANGE)
    delta = jnp.where(interior, delta, 0.0)
    u_r = u_r0 + (k.astype(jnp.float32) - SAD_RANGE) + delta

    disparity = kp_l_uv[:, 0] - u_r
    accept = accept & (disparity > 0.01) & (disparity <= max_d)
    # MAD-style outlier rejection on SAD values (reference: median*1.5*1.4826,
    # Frame.cc:1030 region)
    sad_sorted = jnp.sort(jnp.where(accept, smin, jnp.inf))
    n_ok = jnp.sum(accept)
    med = sad_sorted[jnp.clip(n_ok // 2, 0, n_l - 1)]
    accept = accept & (smin <= 1.5 * 1.4826 * jnp.maximum(med, 1e-3) + 1e-3)

    accept = hamming.resolve_duplicates(best_idx, best, accept, kp_r_uv.shape[0])
    depth = jnp.where(accept, bf / jnp.maximum(disparity, 1e-6), -1.0)
    return StereoMatches(
        u_right=jnp.where(accept, u_r, -1.0),
        depth=depth,
        valid=accept,
    )


def _sad_curve(img_l, img_r, uv_l, uv_r):
    """SAD of 11x11 patches at uv_l (left) vs sliding window ±SAD_RANGE around
    uv_r (right). Returns [N, 2*SAD_RANGE+1]."""
    h, w = img_l.shape
    W = SAD_HALF

    def patch(img, yc, xc, half_w):
        # direct element gather (bit-exact; see ops/orb.py patches_at_flat)
        ys = jnp.clip(yc[:, None] + jnp.arange(-W, W + 1)[None, :], 0, h - 1)
        xs = jnp.clip(xc[:, None] + jnp.arange(-half_w, half_w + 1)[None, :], 0, w - 1)
        return img[ys[:, :, None], xs[:, None, :]]  # [N, 11, 2*half_w+1]

    yl = jnp.round(uv_l[:, 1]).astype(jnp.int32)
    xl = jnp.round(uv_l[:, 0]).astype(jnp.int32)
    yr = jnp.round(uv_r[:, 1]).astype(jnp.int32)
    xr = jnp.round(uv_r[:, 0]).astype(jnp.int32)
    pl = patch(img_l, yl, xl, W)  # [N,11,11]
    strip = patch(img_r, yr, xr, W + SAD_RANGE)  # [N,11,11+2*R]
    # mean-normalize like the reference's IL - center offset trick
    pl = pl - pl[:, W : W + 1, W : W + 1]
    sads = []
    for s in range(2 * SAD_RANGE + 1):
        pr = strip[:, :, s : s + 2 * W + 1]
        pr = pr - pr[:, W : W + 1, W : W + 1]
        sads.append(jnp.sum(jnp.abs(pl - pr), axis=(1, 2)))
    return jnp.stack(sads, -1)


def depth_to_disparity(kp_uv, kp_valid, depth_map, bf, depth_factor=1.0):
    """RGB-D: sample the depth map at keypoints → virtual right coords
    (reference: ComputeStereoFromRGBD Frame.cc:1606)."""
    x = jnp.round(kp_uv[:, 0]).astype(jnp.int32)
    y = jnp.round(kp_uv[:, 1]).astype(jnp.int32)
    h, w = depth_map.shape
    d = depth_map[jnp.clip(y, 0, h - 1), jnp.clip(x, 0, w - 1)] * depth_factor
    ok = kp_valid & (d > 0)
    u_r = kp_uv[:, 0] - bf / jnp.maximum(d, 1e-6)
    return StereoMatches(
        u_right=jnp.where(ok, u_r, -1.0),
        depth=jnp.where(ok, d, -1.0),
        valid=ok,
    )
