"""Textured 3D rendered stereo sequences with exact ground truth.

The closest possible stand-in for real benchmark sequences without any
dataset: a box room whose faces carry seeded procedural textures (two-octave
bicubic noise), rendered by ray casting with genuine perspective, depth
variation, parallax and rotation. Unlike the bench's fronto-parallel plane,
features here live at many depths and orientations, so rBRIEF repeatability,
stereo matching and the KF policy face realistic image-domain conditions.
Ground truth is exact → ATE gates are meaningful. Needs only NumPy.
"""
from __future__ import annotations

import hashlib
import os
from typing import Callable, List, Tuple

import numpy as np

# rendered-frame cache: a fixed, gitignored directory inside the checkout
RENDER_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".render_cache")


def cached_frames(name: str, gt: np.ndarray,
                  render: Callable[[], np.ndarray]) -> np.ndarray:
    """uint8 frames [F,2,H,W] for a rendered sequence, from the render cache
    when the cached ground truth matches `gt` (a trajectory change shifts gt
    and invalidates the entry; a change to this file renames it), else from
    `render()`, which is then cached. The write goes through a rename, so a
    concurrent reader never sees a partial file."""
    with open(__file__, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:10]
    stem, ext = os.path.splitext(name)
    path = os.path.join(RENDER_CACHE_DIR, f"{stem}-{tag}{ext}")
    if os.path.exists(path):
        z = np.load(path)
        if (z["gt"].shape == gt.shape
                and np.allclose(z["gt"], gt, atol=1e-6)):
            return z["imgs"]
    imgs = render()
    os.makedirs(RENDER_CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, imgs=imgs, gt=gt)
    os.replace(tmp, path)
    return imgs


def _cubic_weights(n_src: int, n_dst: int) -> np.ndarray:
    """[n_dst, n_src] bicubic resampling matrix: Keys kernel with a=-0.75,
    half-pixel centres and replicated borders — the INTER_CUBIC convention
    of the usual image libraries."""
    a = -0.75
    f = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
    s = np.floor(f)
    x = (f - s).astype(np.float32)
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    taps = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :],
                   0, n_src - 1)
    w = np.zeros((n_dst, n_src), np.float32)
    np.add.at(w, (np.repeat(np.arange(n_dst), 4), taps.reshape(-1)),
              np.stack([c0, c1, c2, c3], -1).reshape(-1))
    return w


def _resize_cubic(img: np.ndarray, size: int) -> np.ndarray:
    """Bicubic up-sampling of a square float32 image to [size, size]."""
    h, w = img.shape
    return (_cubic_weights(h, size) @ img.astype(np.float32)
            @ _cubic_weights(w, size).T).astype(np.float32)


def _load_textures(size=1024) -> List[np.ndarray]:
    """Six face textures from seed 0: coarse noise plus finer detail, each
    up-sampled bicubically (the floor and ceiling reuse texture 0)."""
    rng = np.random.default_rng(0)
    texs = []
    for _ in range(4):
        t = _resize_cubic(rng.uniform(0, 255, (size // 8, size // 8)), size)
        t += _resize_cubic(rng.uniform(-60, 60, (size // 2, size // 2)), size)
        texs.append(np.clip(t, 0, 255))
    return texs + [texs[0], texs[0]]


class RoomWorld:
    """Axis-aligned box room [−W/2,W/2]×[−H/2,H/2]×[0,L] with textured faces.

    Faces: z=L (front), z=0 (back), x=±W/2 (sides), y=±H/2 (floor/ceiling).
    """

    def __init__(self, width=8.0, height=5.0, length=12.0, tex_size=1024):
        self.W, self.H, self.L = width, height, length
        self.texs = _load_textures(tex_size)
        self.ts = tex_size

    def _sample(self, tex_id, u, v):
        """Bilinear texture sample; u,v in [0,1]."""
        t = self.texs[tex_id]
        ts = self.ts
        x = np.clip(u, 0, 1) * (ts - 1)
        y = np.clip(v, 0, 1) * (ts - 1)
        x0 = np.floor(x).astype(np.int64)
        y0 = np.floor(y).astype(np.int64)
        x1 = np.minimum(x0 + 1, ts - 1)
        y1 = np.minimum(y0 + 1, ts - 1)
        fx = (x - x0).astype(np.float32)
        fy = (y - y0).astype(np.float32)
        v00 = t[y0, x0]
        v01 = t[y0, x1]
        v10 = t[y1, x0]
        v11 = t[y1, x1]
        return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
                + v10 * (1 - fx) * fy + v11 * fx * fy)

    def render(self, R_wc: np.ndarray, t_wc: np.ndarray,
               fx=450.0, fy=450.0, cx=320.0, cy=240.0,
               w=640, h=480) -> np.ndarray:
        """Ray-cast one view. (R_wc, t_wc): camera-to-world pose."""
        us, vs = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        d_cam = np.stack([(us - cx) / fx, (vs - cy) / fy,
                          np.ones_like(us)], -1).reshape(-1, 3)
        d = d_cam @ R_wc.T            # world-frame ray directions
        o = t_wc                      # origin
        best_t = np.full(d.shape[0], np.inf, np.float32)
        out = np.zeros(d.shape[0], np.float32)
        W2, H2, L = self.W / 2, self.H / 2, self.L
        # plane list: (axis, value, tex_id, (u_axis, u_lo, u_hi), (v_axis,...))
        planes = [
            (2, L, 0, (0, -W2, W2), (1, -H2, H2)),      # front wall
            (2, 0.0, 1, (0, -W2, W2), (1, -H2, H2)),    # back wall
            (0, -W2, 2, (2, 0.0, L), (1, -H2, H2)),     # left wall
            (0, W2, 3, (2, 0.0, L), (1, -H2, H2)),      # right wall
            (1, H2, 4, (0, -W2, W2), (2, 0.0, L)),      # floor
            (1, -H2, 5, (0, -W2, W2), (2, 0.0, L)),     # ceiling
        ]
        for ax, val, tid, (ua, ulo, uhi), (va, vlo, vhi) in planes:
            dz = d[:, ax]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_hit = (val - o[ax]) / dz
                pu = o[ua] + t_hit * d[:, ua]
                pv = o[va] + t_hit * d[:, va]
            ok = (np.abs(dz) > 1e-9) & (t_hit > 0.05) & (t_hit < best_t)
            ok &= (pu >= ulo) & (pu <= uhi) & (pv >= vlo) & (pv <= vhi)
            if not ok.any():
                continue
            uu = (pu[ok] - ulo) / (uhi - ulo)
            vv = (pv[ok] - vlo) / (vhi - vlo)
            out[ok] = self._sample(tid, uu, vv)
            best_t[ok] = t_hit[ok]
        return out.reshape(h, w)

    def render_stereo(self, R_cw, t_cw, baseline=0.1, **kw):
        """World→cam pose (R_cw,t_cw) → (left, right) grayscale frames."""
        R_wc = R_cw.T
        t_wc = -R_cw.T @ t_cw
        left = self.render(R_wc, t_wc, **kw)
        right_center = t_wc + R_wc @ np.asarray([baseline, 0, 0], np.float32)
        right = self.render(R_wc, right_center, **kw)
        return left, right


def yaw_pose(yaw: float, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """World→cam pose for a camera at world `pos` yawed by `yaw` (about y)."""
    c, s = np.cos(yaw), np.sin(yaw)
    R_wc = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    R_cw = R_wc.T
    t_cw = -R_cw @ pos.astype(np.float32)
    return R_cw, t_cw


def rpy_pose(yaw: float, pitch: float, roll: float,
             pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """World→cam pose with full rotation: yaw (about y), pitch (about x),
    roll (about z), camera at world `pos`."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    Rx = np.asarray([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    Rz = np.asarray([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], np.float32)
    R_wc = Ry @ Rx @ Rz
    R_cw = R_wc.T
    t_cw = -R_cw @ pos.astype(np.float32)
    return R_cw, t_cw


def trajectory_tour(n_frames: int, center=(0.0, 0.0, 4.0), x_amp=1.5,
                    y_amp=0.3, z_amp=2.0, yaw_amp=0.5, pitch_amp=0.12,
                    roll_amp=0.06, cycles=2.0):
    """Sustained 6-DoF room tour for benchmarking: the camera weaves through
    the room on a Lissajous path with simultaneous yaw/pitch/roll sweeps —
    continuous rotation, depth change on every axis, no fronto-parallel
    episodes. Frequencies are INCOMMENSURATE (×1, ×e/2, ×√2…) so the path
    never exactly revisits an earlier pose: loop closing stays active (its
    per-KF detection work is part of the measured load) without actual loop
    events turning the latency benchmark into a loop-correction benchmark.
    Per-frame motion is set by (amplitude × cycles / n_frames): the defaults
    at n_frames=300 give ~4-7 cm and ~0.7-1.2°/frame, the same regime as a
    brisk handheld EuRoC sequence at 20 fps."""
    poses = []
    c = np.asarray(center, np.float32)
    r2, r3 = np.sqrt(2.0), np.e / 2
    for i in range(n_frames):
        a = cycles * i / max(n_frames - 1, 1)
        pos = c + np.asarray([
            x_amp * np.sin(2 * np.pi * a),
            y_amp * np.sin(2 * np.pi * r3 * a),
            z_amp * np.sin(np.pi * r2 * a / 2),
        ], np.float32)
        yaw = yaw_amp * np.sin(2 * np.pi * a / r2 + 0.7)
        pitch = pitch_amp * np.sin(2 * np.pi * r3 * a + 0.3)
        roll = roll_amp * np.sin(2 * np.pi * a + 1.9)
        poses.append(rpy_pose(yaw, pitch, roll, pos))
    return poses


def trajectory_arc(n_frames: int, radius=1.2, yaw_amp=0.35,
                   center=(0.0, 0.0, 3.5), advance=2.5):
    """Smooth 6-DoF trajectory: forward advance + lateral arc + yaw sweep.
    Returns [(R_cw, t_cw)] world→cam poses with exact ground truth."""
    poses = []
    c = np.asarray(center, np.float32)
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        pos = c + np.asarray([
            radius * np.sin(2 * np.pi * a),
            0.3 * np.sin(4 * np.pi * a),
            advance * a,
        ], np.float32)
        yaw = yaw_amp * np.sin(2 * np.pi * a)
        poses.append(yaw_pose(yaw, pos))
    return poses


def trajectory_loop(n_frames: int, radius=2.0, center=(0.0, 0.0, 5.0),
                    loops=1.0):
    """Closed circular trajectory: the camera orbits the room center FACING
    INWARD (scene points stay several meters away, so the rotational optical
    flow is trackable). `loops` > 1 continues past the full circle so the
    revisit overlap spans several keyframes — loop detection needs 3
    consecutive consistent KFs (reference: LoopClosing.cc:216)."""
    poses = []
    c = np.asarray(center, np.float32)
    for i in range(n_frames):
        a = 2 * np.pi * loops * i / n_frames
        pos = c + np.asarray([radius * np.sin(a), 0.0,
                              -radius * np.cos(a)], np.float32)
        d = c - pos  # look at the orbit center
        yaw = float(np.arctan2(d[0], d[2]))
        poses.append(yaw_pose(yaw, pos))
    return poses
