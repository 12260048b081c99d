"""ORB pyramid feature extraction — the full front-end in one jitted program.

JAX replacement for ORBextractor (reference: src/ORBextractor.cc:982
CUDA operator() / :1112 CPU operator(), include/ORBextractor.h). The CUDA
path software-pipelines FAST/IC-angle/blur/rBRIEF kernels across pyramid
levels with streams (ORBextractor.cc:940-1063); here the whole pyramid is one
XLA program — the compiler overlaps and fuses everything, no manual streams.

Pipeline per level (all static shapes):
  resize → FAST score+NMS (ops/fast.py) → per-cell top-K + ranked top-N
  (ops/select.py, replaces DistributeOctTree) → IC-angle (ops/orb.py, dense
  moment convs) → Gaussian blur → rBRIEF (batched gather) → scale to level-0.

Outputs are fixed-capacity masked SoA arrays (SURVEY.md §7.1).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gf_orb_slam2_tpu.config import ORBConfig
from gf_orb_slam2_tpu.ops import fast, orb, select


class Features(NamedTuple):
    """Per-frame keypoint set (SoA, fixed capacity N, masked by `valid`)."""

    uv: jnp.ndarray        # [N,2] float32 — (x, y) in level-0 pixel coords
    response: jnp.ndarray  # [N] float32 FAST V-score
    octave: jnp.ndarray    # [N] int32 pyramid level
    angle: jnp.ndarray     # [N] float32 radians
    desc: jnp.ndarray      # [N,8] uint32 — 256-bit rBRIEF
    valid: jnp.ndarray     # [N] bool

    @property
    def n(self):
        return jnp.sum(self.valid.astype(jnp.int32))


def level_sizes(h: int, w: int, n_levels: int, scale: float) -> Tuple[Tuple[int, int], ...]:
    out = []
    for lv in range(n_levels):
        f = scale ** lv
        out.append((max(32, int(round(h / f))), max(32, int(round(w / f)))))
    return tuple(out)


def features_per_level(n: int, n_levels: int, scale: float) -> Tuple[int, ...]:
    """Geometric distribution of the feature budget over levels
    (reference: ORBextractor ctor, src/ORBextractor.cc:~450)."""
    inv = 1.0 / scale
    base = n * (1 - inv) / (1 - inv ** n_levels)
    counts = [int(round(base * inv ** lv)) for lv in range(n_levels - 1)]
    counts.append(max(0, n - sum(counts)))
    return tuple(counts)


class ORBExtractor:
    """Stateless extractor: config in, jitted callable out.

    Unlike the reference's stateful class (pyramid buffers, CUDA streams),
    all state is in the XLA program; `__call__` is pure.
    """

    def __init__(self, cfg: ORBConfig, height: int, width: int):
        self.cfg = cfg
        self.height = height
        self.width = width
        self.sizes = level_sizes(height, width, cfg.n_levels, cfg.scale_factor)
        self.counts = features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)
        self.n_total = sum(self.counts)
        self.scales = tuple(cfg.scale_factor ** lv for lv in range(cfg.n_levels))
        self._jit = jax.jit(self._extract)

    def __call__(self, img) -> Features:
        """img: [H,W] uint8 or float32 grayscale → Features."""
        return self._jit(img)

    def _extract(self, img) -> Features:
        """Level-VECTORIZED extraction: all pyramid levels are padded into one
        [L, H0, W0] stack and every stage (FAST, NMS, cell top-K, moment
        convs, blur, rBRIEF) runs as ONE batched kernel set. A per-level
        python loop emits ~8x the kernel launches; the batched form trades
        ~3x the FLOPs (padding) for one launch per stage."""
        cfg = self.cfg
        img = img.astype(jnp.float32)
        border = cfg.edge_threshold - 3  # reference: EDGE_THRESHOLD-3 = 16
        L = cfg.n_levels
        H0, W0 = self.sizes[0]

        # pyramid: every level resized directly from level-0 — independent
        # ops the scheduler can overlap (the reference's chained resize
        # serializes; direct resize also avoids compounding interpolation)
        level_imgs = [img]
        for lv in range(1, L):
            h, w = self.sizes[lv]
            level_imgs.append(jax.image.resize(img, (h, w), "linear"))
        stack = jnp.stack([
            jnp.pad(li, ((0, H0 - li.shape[0]), (0, W0 - li.shape[1])))
            for li in level_imgs
        ])  # [L, H0, W0]
        hl = jnp.asarray([h for h, w in self.sizes], jnp.int32)
        wl = jnp.asarray([w for h, w in self.sizes], jnp.int32)

        score, keep = fast.detect(stack, float(cfg.min_th_fast), border, (hl, wl))
        if cfg.ini_th_fast > cfg.min_th_fast:
            # two-tier threshold (reference: iniThFAST per 30x30 cell with
            # minThFAST fallback, ORBextractor.cc:767): cells holding a
            # strong corner keep ONLY strong corners; weak ones fill cells
            # with none. The V-score ≥ t test IS the corner-at-t test.
            cs = cfg.cell_size
            strong = keep & (score >= float(cfg.ini_th_fast))
            Hp = -(-H0 // cs) * cs
            Wp = -(-W0 // cs) * cs
            sp = jnp.pad(strong, ((0, 0), (0, Hp - H0), (0, Wp - W0)))
            cells = sp.reshape(L, Hp // cs, cs, Wp // cs, cs).any((2, 4))
            cell_any = jnp.broadcast_to(
                cells[:, :, None, :, None],
                (L, Hp // cs, cs, Wp // cs, cs),
            ).reshape(L, Hp, Wp)[:, :H0, :W0]
            keep = keep & (strong | ~cell_any)
        vals, ys, xs, rank = jax.vmap(
            lambda s, k: select.cell_topk(s, k, cfg.cell_size, cfg.per_cell_k)
        )(score, keep)
        N_CAP = max(self.counts)
        ys_l, xs_l, sc_l, valid_l = jax.vmap(
            lambda v, y, x, r: select.ranked_topn(v, y, x, r, N_CAP)
        )(vals, ys, xs, rank)  # each [L, N_CAP]
        quota = jnp.asarray(self.counts, jnp.int32)[:, None] > jnp.arange(N_CAP)[None, :]
        valid_l = valid_l & quota

        scales = jnp.asarray(self.scales, jnp.float32)[:, None]
        uv = jnp.stack(
            [xs_l.astype(jnp.float32) * scales, ys_l.astype(jnp.float32) * scales], -1
        )
        octv = jnp.broadcast_to(
            jnp.arange(L, dtype=jnp.int32)[:, None], (L, N_CAP)
        )
        resp = jnp.where(valid_l, sc_l, 0.0)

        # flatten and keep exactly n_total slots (valid-first, stable order)
        # BEFORE the descriptor patch gather — only selected keypoints pay
        flat = lambda a: a.reshape((L * N_CAP,) + a.shape[2:])
        validf = flat(valid_l)
        prio = validf.astype(jnp.float32) * 1e9 - jnp.arange(L * N_CAP, dtype=jnp.float32)
        _, sel = jax.lax.top_k(prio, self.n_total)
        li = flat(octv)[sel]
        yx_sel = jnp.stack([flat(ys_l)[sel], flat(xs_l)[sel]], -1).astype(jnp.float32)
        ang, desc = orb.angles_and_descriptors_flat(stack, li, yx_sel)
        return Features(
            uv=flat(uv)[sel],
            response=flat(resp)[sel],
            octave=li,
            angle=ang,
            desc=desc,
            valid=validf[sel],
        )

    # ------------------------------------------------------------ utilities
    @functools.cached_property
    def sigma2(self) -> np.ndarray:
        """Per-octave measurement variance (scale^2l), reference
        ORBextractor mvLevelSigma2."""
        return np.asarray([s * s for s in self.scales], np.float32)

    @functools.cached_property
    def inv_sigma2(self) -> np.ndarray:
        return 1.0 / self.sigma2
