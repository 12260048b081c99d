"""Device mirrors' packed-delta scatter path, run on the CPU.

On the CPU the mirrors refresh with a full device_put; every accelerator
takes the delta-scatter path. These tests force the delta path on a
small-capacity store and check that padded slots are dropped: the last point
row and the last keyframe row must never be overwritten by padding.
"""
import numpy as np
import pytest

from gf_orb_slam2_tpu.config import CapacityConfig
from gf_orb_slam2_tpu.slammap import device_mirror
from gf_orb_slam2_tpu.slammap.device_mirror import (
    DeviceKFMirror, DeviceMapMirror,
)
from gf_orb_slam2_tpu.slammap.store import MapStore

N = 16  # keypoints per keyframe
P = 64  # point capacity
K = 8   # keyframe capacity


@pytest.fixture
def delta_path(monkeypatch):
    monkeypatch.setenv("GF_SLAM_NO_PREWARM", "1")
    monkeypatch.setattr(device_mirror, "_cpu_backend", lambda: False)


def make_store():
    cap = CapacityConfig(max_keypoints=N, max_map_points=P, max_keyframes=K,
                         max_obs_per_point=4)
    s = MapStore(cap, N)
    rng = np.random.default_rng(0)
    # every row, the last ones included, holds distinctive data
    s.point_pos[:] = rng.normal(size=(P, 3)).astype(np.float32)
    s.point_desc[:] = rng.integers(1, 2**32, (P, 8), dtype=np.uint32)
    s.point_normal[:] = 1.0
    s.point_min_dist[:] = 0.5
    s.point_max_dist[:] = 9.0
    s.kf_R[:] = np.eye(3, dtype=np.float32) * 2.0
    s.kf_t[:] = rng.normal(size=(K, 3)).astype(np.float32)
    s.kf_uv[:] = rng.uniform(0, 640, (K, N, 2)).astype(np.float32)
    s.kf_desc[:] = rng.integers(1, 2**32, (K, N, 8), dtype=np.uint32)
    return s


def assert_points_mirrored(m, s):
    np.testing.assert_array_equal(np.asarray(m.arrays["pos"]), s.point_pos)
    np.testing.assert_array_equal(np.asarray(m.arrays["desc"]), s.point_desc)
    np.testing.assert_array_equal(np.asarray(m.arrays["maxd"]),
                                  s.point_max_dist)


def test_point_delta_sync_drops_padding(delta_path):
    s = make_store()
    m = DeviceMapMirror(s)
    assert_points_mirrored(m, s)
    s.point_pos[[3, 5]] += 1.0
    s.point_desc[[3, 5]] ^= np.uint32(0xFFFF)
    m.mark([3, 5, -1])
    m.sync()  # 2 live ids in a 1024-slot bucket: 1022 padded slots
    assert m.n_delta_syncs == 1
    assert not m.dirty.any()
    assert_points_mirrored(m, s)  # the last row P-1 included


def test_point_delta_sync_chunks_large_deltas(delta_path, monkeypatch):
    monkeypatch.setattr(device_mirror, "_BUCKETS", (8, 16))
    s = make_store()
    m = DeviceMapMirror(s)
    s.point_pos[:] *= -1.0
    m.mark(np.arange(P))
    m.sync()  # 64 ids through 16-slot chunks
    assert m.n_delta_syncs == P // 16
    assert_points_mirrored(m, s)


def test_kf_row_and_pose_delta_sync_drops_padding(delta_path):
    s = make_store()
    m = DeviceKFMirror(s)
    s.kf_uv[2] += 3.0
    s.kf_desc[2] ^= np.uint32(1)
    s.kf_t[4] += 1.0
    m.mark_row(2)
    m.mark_pose(4)
    m.sync()  # one row in a 4-slot bucket, one pose in a 4-slot bucket
    for k, host in (("uv", s.kf_uv), ("desc", s.kf_desc), ("R", s.kf_R),
                    ("t", s.kf_t)):
        np.testing.assert_array_equal(np.asarray(m.arrays[k]), host, k)


def test_update_program_drops_out_of_range_ids(delta_path):
    """The scatter program itself: ids == P are dropped, -1 is not."""
    s = make_store()
    m = DeviceMapMirror(s)
    D = 4
    m._ensure_jit(D)
    lay = m._layouts[D]

    def run(ids):
        buf = lay.pack_np(dict(
            ids=np.asarray(ids, np.int32),
            pos=np.full((D, 3), 7.0, np.float32),
            normal=np.zeros((D, 3), np.float32),
            mind=np.zeros(D, np.float32), maxd=np.zeros(D, np.float32),
            desc=np.zeros((D, 8), np.uint32)))
        return np.asarray(m._jits[D](m.arrays, buf)["pos"])

    pos = run([0, P, P, P])
    np.testing.assert_array_equal(pos[0], 7.0)
    np.testing.assert_array_equal(pos[1:], s.point_pos[1:])
    # the sentinel the mirror used to pad with: normalised to the last row
    assert (run([0, -1, -1, -1])[P - 1] == 7.0).all()
