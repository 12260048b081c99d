"""FAST-9/16 corner detection as dense fused-elementwise XLA ops.

JAX replacement for the reference's three FAST backends: plain OpenCV
CPU FAST (src/ORBextractor.cc:767 ComputeKeyPointsOctTree), the CUDA tiled
kernel `tileCalcKeypoints_kernel` (src/cuda/Fast_gpu.cu:284) and the NEON
SIMD path (src/FAST_NEON.cc). The segment test is evaluated for EVERY pixel
of EVERY (padded) pyramid level at once.

Formulation notes:
- neighbors come from STATIC SLICES of a once-padded image — `jnp.roll`
  lowers to concats that break XLA fusion and each unfused kernel carries
  fixed overhead; slices feeding elementwise chains fuse into one kernel;
- the circular min-over-9-consecutive test is an unrolled elementwise
  min/max tree over the 16 neighbor arrays — pure elementwise, fully fused;
- the per-pixel score is the OpenCV-compatible "max threshold for which the
  pixel stays a corner" (V-score), so NMS ordering matches the reference's
  cornerScore semantics.
"""
from __future__ import annotations

import jax.numpy as jnp

# Bresenham circle of radius 3 — the standard FAST-16 ring, clockwise from
# 12 o'clock. (dy, dx) offsets.
CIRCLE16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

_PAD = 3


def _shifted(padded, dy, dx, h, w):
    """Static slice of the (+3)-padded image ≡ neighbor at offset (dy, dx)."""
    return padded[..., _PAD + dy : _PAD + dy + h, _PAD + dx : _PAD + dx + w]


def fast_score(img):
    """Per-pixel FAST-9/16 corner V-score.

    img: [..., H, W] float32; leading dims batched (whole pyramid at once).
    Returns score [..., H, W]: the largest threshold t for which the pixel
    passes the segment test; <= 0 means not a corner.
    """
    h, w = img.shape[-2:]
    pad_width = ((0, 0),) * (img.ndim - 2) + ((_PAD, _PAD), (_PAD, _PAD))
    padded = jnp.pad(img, pad_width)
    diffs = [_shifted(padded, dy, dx, h, w) - img for dy, dx in CIRCLE16]

    def arc_score(ds):
        # max over the 16 arc starts of (min over 9 consecutive ring diffs)
        best = None
        for s in range(16):
            m = ds[s]
            for k in range(1, 9):
                m = jnp.minimum(m, ds[(s + k) % 16])
            best = m if best is None else jnp.maximum(best, m)
        return best

    v_bright = arc_score(diffs)
    v_dark = arc_score([-d for d in diffs])
    return jnp.maximum(v_bright, v_dark)


def nms3(score):
    """3x3 non-maximum suppression via padded static slices; ties broken
    toward the raster-order-first pixel so plateaus yield one winner."""
    h, w = score.shape[-2:]
    pad_width = ((0, 0),) * (score.ndim - 2) + ((_PAD, _PAD), (_PAD, _PAD))
    padded = jnp.pad(score, pad_width, constant_values=-jnp.inf)
    nmax = None
    pmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = _shifted(padded, dy, dx, h, w)
            nmax = nb if nmax is None else jnp.maximum(nmax, nb)
            if (dy, dx) in ((-1, -1), (-1, 0), (-1, 1), (0, -1)):
                pmax = nb if pmax is None else jnp.maximum(pmax, nb)
    return (score >= nmax) & (score > pmax)


def detect(img, threshold, border, hw_valid=None):
    """Scores + NMS + border/threshold mask.

    img: [..., H, W]; hw_valid: optional ([...], [...]) per-level valid
    heights/widths for padded pyramid stacks. Returns (score, keep).
    """
    s = fast_score(img)
    h, w = img.shape[-2:]
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    if hw_valid is None:
        in_border = (
            (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
        )
    else:
        hl, wl = hw_valid
        hl = hl[..., None, None]
        wl = wl[..., None, None]
        in_border = (
            (ys >= border) & (ys < hl - border) & (xs >= border) & (xs < wl - border)
        )
    keep = nms3(s) & (s > threshold) & in_border
    return s, keep
