"""No f32 contraction in the jitted device programs runs at default
precision.

On a GPU an f32 dot_general or convolution left at DEFAULT precision may run
in TF32 (a 10-bit mantissa), which breaks pose math and turns one-hot picks
into roundings (utils/precision.py). This lowers the hot programs on the CPU
and rejects any such op in their StableHLO, naming its source line.
"""
import os
import re

import jax
import jax.numpy as jnp
import pytest

from gf_orb_slam2_tpu.config import (
    CameraConfig, CapacityConfig, ORBConfig, Sensor, SystemConfig,
)

_CONTRACTION = re.compile(r"stablehlo\.(dot_general|convolution)")
_LOC_DEF = re.compile(r"^(#loc\d+) = (.*)$")
_FILE_LOC = re.compile(r'"([^"]+\.py)":(\d+)')


def default_precision_f32_ops(lowered):
    """[(op line, first repo source location)] for every f32 dot_general or
    convolution whose precision is not HIGHEST."""
    text = lowered.as_text(debug_info=True)
    locs = {}
    for line in text.splitlines():
        m = _LOC_DEF.match(line)
        if m:
            locs[m.group(1)] = m.group(2)

    def source(ref, depth=0):
        v = locs.get(ref, "")
        for path, ln in _FILE_LOC.findall(v):
            if "gf_orb_slam2_tpu" in path:
                return f"{path.split('gf_orb_slam2_tpu')[-1]}:{ln}"
        for r in re.findall(r"#loc\d+", v):
            if depth < 12:
                found = source(r, depth + 1)
                if found:
                    return found
        return None

    bad = []
    for line in text.splitlines():
        if not _CONTRACTION.search(line):
            continue
        operands = line.rsplit(") -> ", 1)[0].rsplit(": (", 1)[-1]
        if "xf32>" in operands and "HIGHEST" not in line:
            ref = re.search(r"loc\((#loc\d+)\)\s*$", line)
            bad.append((line.strip()[:160],
                        source(ref.group(1)) if ref else None))
    return bad


@pytest.fixture(scope="module")
def small_system():
    """A small stereo System with place recognition, no background
    prewarm."""
    from gf_orb_slam2_tpu.system import System

    vocab = os.path.join(os.path.dirname(__file__), "..", "gf_orb_slam2_tpu",
                         "assets", "vocab10k.npz")
    cam = CameraConfig(width=320, height=240, fx=225.0, fy=225.0, cx=160.0,
                       cy=120.0, bf=22.5)
    cfg = SystemConfig(
        sensor=Sensor.STEREO, camera=cam,
        orb=ORBConfig(n_features=200, n_levels=4),
        capacity=CapacityConfig(max_keypoints=256, max_map_points=2048,
                                max_keyframes=16, max_local_points=512),
        vocabulary_path=vocab,
    )
    old = os.environ.get("GF_SLAM_NO_PREWARM")
    os.environ["GF_SLAM_NO_PREWARM"] = "1"
    try:
        yield System(cfg)
    finally:
        if old is None:
            os.environ.pop("GF_SLAM_NO_PREWARM", None)
        else:
            os.environ["GF_SLAM_NO_PREWARM"] = old


def _programs(sys_, group):
    spec = jax.ShapeDtypeStruct
    h, w = sys_.cfg.camera.height, sys_.cfg.camera.width
    imgs = spec((2, h, w), jnp.uint8)
    fe = sys_._get_frontend("stereo")
    if group == "frontend":
        return [("stereo_frontend", fe, (imgs,))]
    fe_out = jax.eval_shape(fe, imgs)
    tr = sys_.tracker
    if group == "stream":
        N, P = sys_.n_kp, sys_.cfg.capacity.max_map_points
        f32, i32 = jnp.float32, jnp.int32
        chain = dict(
            R1=spec((3, 3), f32), t1=spec((3,), f32),
            R2=spec((3, 3), f32), t2=spec((3,), f32),
            pt_pos=spec((N, 3), f32), pt_oct=spec((N,), i32),
            pt_valid=spec((N,), jnp.bool_), pt_desc=spec((N, 8), jnp.uint32),
            pt_ids=spec((N,), i32))
        mirror = dict(
            pos=spec((P, 3), f32), normal=spec((P, 3), f32),
            mind=spec((P,), f32), maxd=spec((P,), f32),
            desc=spec((P, 8), jnp.uint32))
        up = spec((tr._stream_up_layout.total,), jnp.uint32)
        return [("stream_step", tr._jit_stream, (up, *fe_out, chain, mirror))]
    if group == "fused":
        up = spec((tr._up_layout.total,), jnp.uint32)
        return [("fused_step", tr._jit_fused_packed, (up, *fe_out))]
    if group == "mapper":
        return sys_.mapper.prewarm_programs()
    assert group == "loop"
    assert sys_.loop_closer is not None
    return sys_.loop_closer.prewarm_programs()


@pytest.mark.parametrize("group", ["frontend", "stream", "fused", "mapper",
                                   "loop"])
def test_no_default_precision_f32_contraction(small_system, group):
    progs = _programs(small_system, group)
    assert progs
    found = {}
    for name, fn, args in progs:
        bad = default_precision_f32_ops(fn.lower(*args))
        if bad:
            found[name] = bad
    assert not found, found


def test_checker_flags_a_default_precision_dot():
    """The checker itself: a bare f32 matmul is flagged, HIGHEST and a bf16
    product are not."""
    from gf_orb_slam2_tpu.utils.precision import matmul

    a = jax.ShapeDtypeStruct((4, 4), jnp.float32)
    assert default_precision_f32_ops(jax.jit(lambda x, y: x @ y).lower(a, a))
    assert not default_precision_f32_ops(jax.jit(matmul).lower(a, a))
    assert not default_precision_f32_ops(jax.jit(
        lambda x, y: jnp.dot(x.astype(jnp.bfloat16), y.astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32)).lower(a, a))
