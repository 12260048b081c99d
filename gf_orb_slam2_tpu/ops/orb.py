"""ORB orientation (intensity centroid) and rBRIEF descriptors, batched.

JAX replacement for the reference's IC_Angle / computeOrbDescriptor
(src/ORBextractor.cc:76/:107) and their CUDA twins `IC_Angle_kernel`
(src/cuda/Fast_gpu.cu:403, warp-reduced patch moments) and `calcOrb_kernel`
(src/cuda/Orb_gpu.cu:67, 32 threads/keypoint).

Design differences (see SURVEY.md §7.1):
- IC angle: the production path (angles_and_descriptors_flat) reduces one
  gathered patch per selected keypoint; the dense variant (moment_maps)
  computes m10/m01 for EVERY pixel as two 31x31 convolutions and samples
  them at keypoint locations. No per-keypoint loops, no warp reductions.
- rBRIEF: the reference rotates a fixed 256-pair pattern per keypoint and
  reads pixels with nearest rounding. We do the same math as one batched
  gather of [N, 512] nearest-neighbor samples from the blurred image, then a
  vectorized compare + bit-pack into uint32[8]. The 256-pair pattern is OUR
  OWN (seeded Gaussian pairs, not the OpenCV learned table) — descriptors
  are self-consistent within this framework, which is all SLAM needs.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gf_orb_slam2_tpu.utils.precision import einsum

PATCH = 31
HALF = PATCH // 2  # 15


@functools.lru_cache()
def _ic_kernels():
    """31x31 circular-mask moment kernels (x*mask, y*mask) as numpy."""
    ys, xs = np.mgrid[-HALF : HALF + 1, -HALF : HALF + 1]
    # per-row circular extent, as in the reference's u_max table
    # (src/ORBextractor.cc ctor): points within radius HALF
    mask = (xs * xs + ys * ys) <= HALF * HALF
    kx = (xs * mask).astype(np.float32)
    ky = (ys * mask).astype(np.float32)
    return kx, ky


def moment_maps(img):
    """Dense m10/m01 maps via two 31x31 convolutions.

    img: [..., H, W] f32 — leading dims (pyramid levels) are conv batch, so
    the whole pyramid is ONE conv kernel launch."""
    kx, ky = _ic_kernels()
    k = jnp.stack([jnp.asarray(kx), jnp.asarray(ky)], 0)[:, None]  # [2,1,31,31]
    batch = img.shape[:-2]
    h, w = img.shape[-2:]
    x = img.reshape((-1, 1, h, w))
    out = jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST,
    )
    out = out.reshape(batch + (2, h, w))
    return out[..., 0, :, :], out[..., 1, :, :]  # m10, m01


def ic_angles(img, yx):
    """Orientation (radians) for keypoints yx [N,2] (row, col) on one level."""
    m10, m01 = moment_maps(img)
    y = yx[..., 0].astype(jnp.int32)
    x = yx[..., 1].astype(jnp.int32)
    return jnp.arctan2(m01[y, x], m10[y, x])


def ic_angles_batched(imgs, yx):
    """Batched orientation: imgs [L,H,W], yx [L,N,2] → [L,N]."""
    m10, m01 = moment_maps(imgs)  # [L,H,W] each
    L = imgs.shape[0]
    li = jnp.arange(L)[:, None]
    y = yx[..., 0].astype(jnp.int32)
    x = yx[..., 1].astype(jnp.int32)
    return jnp.arctan2(m01[li, y, x], m10[li, y, x])


# ------------------------------------------------------------------- pattern
@functools.lru_cache()
def brief_pattern(n_pairs=256, seed=7, sigma=None):
    """Our rBRIEF sampling pattern: n_pairs of (p, q) offsets in the patch.

    Gaussian-distributed around the center (BRIEF's G(0, S^2/25) recipe),
    clamped to the disc so rotations up to 45° stay inside a 31x31 patch.
    Fixed seed → identical descriptors across runs/devices.
    """
    if sigma is None:
        sigma = PATCH / 5.0
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n_pairs, 2, 2))
    lim = HALF - 2  # leave room for rotation + nearest rounding
    r = np.sqrt((pts**2).sum(-1, keepdims=True))
    scale = np.minimum(1.0, lim / np.maximum(r, 1e-9))
    pts = pts * scale
    return pts.astype(np.float32)  # [256, 2(p/q), 2(dy,dx)]


def brief_descriptors(img_blur, yx, angles):
    """256-bit rBRIEF → uint32[N, 8].

    img_blur: [H,W] f32 Gaussian-blurred level image.
    yx: [N,2] float (row, col) keypoint positions in level coords.
    angles: [N] radians.
    """
    pat = jnp.asarray(brief_pattern())  # [256,2,2] (dy,dx)
    c, s = jnp.cos(angles), jnp.sin(angles)  # [N]
    # rotate offsets: dy' = dx*s + dy*c ; dx' = dx*c - dy*s (image coords)
    dy = pat[None, :, :, 0]  # [1,256,2]
    dx = pat[None, :, :, 1]
    ry = dx * s[:, None, None] + dy * c[:, None, None]  # [N,256,2]
    rx = dx * c[:, None, None] - dy * s[:, None, None]
    py = jnp.round(yx[:, None, None, 0] + ry).astype(jnp.int32)
    px = jnp.round(yx[:, None, None, 1] + rx).astype(jnp.int32)
    h, w = img_blur.shape
    py = jnp.clip(py, 0, h - 1)
    px = jnp.clip(px, 0, w - 1)
    vals = img_blur[py, px]  # [N,256,2]
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint32)  # [N,256]
    bits = bits.reshape(bits.shape[0], 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None]
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)  # [N,8]


@functools.lru_cache()
def _gauss_kernel(ksize=7, sigma=2.0):
    ax = np.arange(ksize) - ksize // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    g = (g / g.sum()).astype(np.float32)
    return g


def gaussian_blur(img, ksize=7, sigma=2.0):
    """Separable Gaussian blur (reference blurs each level before rBRIEF,
    src/ORBextractor.cc:1148 GaussianBlur(…,7,7,2,2)). Batched over leading
    dims."""
    g = jnp.asarray(_gauss_kernel(ksize, sigma))
    batch = img.shape[:-2]
    h, w = img.shape[-2:]
    x = img.reshape((-1, 1, h, w))
    kx = g[None, None, None, :]
    ky = g[None, None, :, None]
    x = jax.lax.conv_general_dilated(
        x, kx, (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)
    x = jax.lax.conv_general_dilated(
        x, ky, (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)
    return x.reshape(batch + (h, w))


def brief_descriptors_batched(imgs_blur, yx, angles):
    """Batched rBRIEF: imgs_blur [L,H,W], yx [L,N,2], angles [L,N] →
    uint32 [L,N,8] (one gather for the whole pyramid)."""
    pat = jnp.asarray(brief_pattern())  # [256,2,2]
    c, s = jnp.cos(angles), jnp.sin(angles)  # [L,N]
    dy = pat[None, None, :, :, 0]  # [1,1,256,2]
    dx = pat[None, None, :, :, 1]
    ry = dx * s[..., None, None] + dy * c[..., None, None]  # [L,N,256,2]
    rx = dx * c[..., None, None] - dy * s[..., None, None]
    py = jnp.round(yx[..., None, None, 0] + ry).astype(jnp.int32)
    px = jnp.round(yx[..., None, None, 1] + rx).astype(jnp.int32)
    h, w = imgs_blur.shape[-2:]
    py = jnp.clip(py, 0, h - 1)
    px = jnp.clip(px, 0, w - 1)
    L = imgs_blur.shape[0]
    li = jnp.arange(L)[:, None, None, None]
    vals = imgs_blur[li, py, px]  # [L,N,256,2]
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint32)  # [L,N,256]
    bits = bits.reshape(bits.shape[:-1] + (8, 32))
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)  # [L,N,8]


# ---------------------------------------------------------------------------
# Patch-based fused path: one [n,37,37] patch extraction feeds IC-angle
# moments and rBRIEF sampling, so only the selected keypoints pay — no
# full-image 31x31 moment convolutions or pyramid-wide blurs.
PATCH_R = 18  # 37x37 raw patch: 15 (moments) + blur margin 3
N_ANGLE_BINS = 32  # rotation quantization for the descriptor lookup table


def _blur_patch(patch, ksize=7, sigma=2.0):
    """Separable 7-tap Gaussian via shifted slices (fused elementwise)."""
    g = _gauss_kernel(ksize, sigma)
    half = ksize // 2
    size = patch.shape[-1]
    out = None
    for i, w_ in enumerate(g):
        sl = patch[..., :, i : size - 2 * half + i]
        out = w_ * sl if out is None else out + w_ * sl
    patch_r = out  # rows blurred: [..., 37, 31]
    out = None
    for i, w_ in enumerate(g):
        sl = patch_r[..., i : size - 2 * half + i, :]
        out = w_ * sl if out is None else out + w_ * sl
    return out  # [..., 31, 31]


def patches_at_flat(stack, li, yx):
    """Extract [n,37,37] raw patches for keypoints with per-item level li:
    one direct element gather, bit-exact on every backend."""
    h, w = stack.shape[-2:]
    d = jnp.arange(-PATCH_R, PATCH_R + 1)
    y = jnp.clip(yx[:, 0:1].astype(jnp.int32) + d[None, :], 0, h - 1)  # [n,37]
    x = jnp.clip(yx[:, 1:2].astype(jnp.int32) + d[None, :], 0, w - 1)
    return stack[li[:, None, None], y[:, :, None], x[:, None, :]]


@functools.lru_cache()
def _sample_matrix(n_bins=N_ANGLE_BINS):
    """Descriptor sampling matrix S [37*37, n_bins*512] (numpy f32).

    Folds the 7x7 Gaussian blur AND the rotated-pattern nearest-neighbor
    sampling into one linear map: raw 37x37 patch → blurred intensity at
    every rBRIEF sample point for every quantized rotation. The descriptor
    read then becomes a single [n,1369]x[1369,n_bins*512] matmul plus
    a per-keypoint bin select — no data-dependent gathers. The ORB paper
    itself quantizes orientation into 12° steps with a pattern lookup table;
    n_bins=32 (11.25°) matches that design.
    """
    pat = brief_pattern()  # [256,2,2]
    g = _gauss_kernel()
    G = np.outer(g, g)  # [7,7] separable blur taps
    th = 2 * np.pi * np.arange(n_bins) / n_bins
    c, s = np.cos(th)[:, None], np.sin(th)[:, None]
    dy = pat[:, :, 0].reshape(-1)[None]  # [1,512]
    dx = pat[:, :, 1].reshape(-1)[None]
    # blurred-image sample coords per bin (blurred (a,b) ≡ raw (a+3, b+3))
    py = np.clip(np.round(15.0 + dx * s + dy * c), 0, 30).astype(np.int64)
    px = np.clip(np.round(15.0 + dx * c - dy * s), 0, 30).astype(np.int64)
    S = np.zeros((37 * 37, n_bins * 512), np.float32)
    col = (np.arange(n_bins)[:, None] * 512 + np.arange(512)[None]).reshape(-1)
    for u in range(7):
        for v in range(7):
            row = ((py + u) * 37 + (px + v)).reshape(-1)
            np.add.at(S, (row, col), G[u, v])
    return S


def angles_and_descriptors_flat(stack, li, yx):
    """Fused IC-angle + rBRIEF for a FLAT selected keypoint set.

    stack: [L,H,W] pyramid; li: [n] level index; yx: [n,2] (row, col) in
    level coords. Gathering only the selected keypoints (post top-N) costs
    ~2x less than gathering every per-level candidate slot.
    Returns (angles [n], desc uint32 [n,8]).
    """
    patch = patches_at_flat(stack, li, yx)  # [n,37,37]
    center31 = patch[..., 3:34, 3:34]
    kx, ky = _ic_kernels()
    m10 = einsum("nab,ab->n", center31, jnp.asarray(kx))
    m01 = einsum("nab,ab->n", center31, jnp.asarray(ky))
    angles = jnp.arctan2(m01, m10)

    # blur + rotated sampling as ONE matmul against the lookup matrix
    # (bf16 operands: ≤1 gray-level rounding on 0..255 data, deterministic,
    # and the binary compare below is robust to it; halves the matrix bytes)
    n = angles.shape[0]
    S = jnp.asarray(_sample_matrix(), jnp.bfloat16)
    vals_all = jnp.dot(
        patch.reshape(n, 37 * 37).astype(jnp.bfloat16), S,
        preferred_element_type=jnp.float32,
    )  # [n, A*512]
    A = N_ANGLE_BINS
    bins = jnp.mod(jnp.round(angles / (2 * jnp.pi / A)).astype(jnp.int32), A)
    vals = vals_all.reshape(n, A, 512)[jnp.arange(n), bins]
    vals = vals.reshape(n, 256, 2)
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint32)
    bits = bits.reshape(n, 8, 32)
    weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    desc = jnp.sum(bits * weights, axis=-1, dtype=jnp.uint32)
    return angles, desc
