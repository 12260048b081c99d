"""Device-resident mirror of the map-point arrays.

The mirror keeps the point arrays (pos/normal/dists/desc) ON DEVICE at full
capacity (~2.6 MB at 40k points), so the streaming tracker's per-frame upload
carries only candidate-pool INDICES and the stream step gathers on device.

Host writes (triangulation, BA, fusion, loop corrections) mark points dirty;
`sync()` ships one packed delta buffer and scatters it in a tiny jitted
update program. This realizes the SURVEY §2.3-P8 design: device-resident
SoA map owned by a host coordinator, versioned snapshots instead of locks —
a dispatched step keeps whichever snapshot it was given; `sync` swaps the
array references atomically (GIL) for subsequent dispatches.

Reference parity note: the reference shares MapPoint objects between
threads under per-object mutexes (MapPoint.h); the mirror is the device-side
equivalent with relaxed (snapshot) consistency — stale pool entries are
re-validated host-side at frame completion (tracker.stream_complete).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from gf_orb_slam2_tpu.utils.packing import Layout

# delta-size buckets (points per sync). Kept SMALL IN NUMBER: every bucket
# size is a separate scatter program that must be compiled before first use
# — two sizes bound the padding waste at ~1 MB, and both are AOT-prewarmed
# in a background thread at mirror creation.
_BUCKETS = (1024, 4096)


def _cpu_backend() -> bool:
    """XLA:CPU runs a large scatter slowly: a single [4k]→[40k,8] .at[].set
    measured 367 s of execution on a CPU host. On CPU the mirror therefore
    refreshes with plain device_put (a memcpy in the same address space);
    accelerators take the packed-delta scatter path."""
    return jax.default_backend() == "cpu"


_PREWARM_THREADS = []


def _prewarm_async(fn):
    """Run compile-prewarming on a daemon thread: compiles/cache loads take
    0.5-10 s each and must not stall construction or, worse, land in the
    middle of the tracked sequence."""
    import os
    import threading

    if os.environ.get("GF_SLAM_NO_PREWARM"):
        return None

    def safe():
        try:
            fn()
        except Exception:
            import logging

            logging.getLogger(__name__).exception("mirror prewarm failed")

    t = threading.Thread(target=safe, daemon=True)
    t.start()
    _PREWARM_THREADS.append(t)
    return t


def wait_prewarm(timeout=None):
    """Block until all background compile-prewarm threads finish. Benchmarks
    call this between System construction and the timed loop so compiles
    count as startup (like the reference's vocabulary load), never as
    mid-sequence stalls."""
    for t in list(_PREWARM_THREADS):
        t.join(timeout)


class DeviceMapMirror:
    FIELDS = ("pos", "normal", "mind", "maxd", "desc")

    def __init__(self, store):
        import threading

        self.store = store
        P = store.cap.max_map_points
        self.P = P
        self.dirty = np.zeros(P, bool)
        # serializes whole sync() calls: the pipelined tracker (per frame)
        # and the async mapping worker (per KF event) sync concurrently, and
        # two interleaved read-clear-scatter sequences each chain
        # `self.arrays = update(self.arrays, delta)` from the SAME snapshot —
        # the later assignment silently DROPS the earlier delta while its
        # dirty bits are already cleared (the CPU full-refresh path can't
        # lose updates, so only the delta path shows it)
        self._sync_lock = threading.Lock()
        with store.lock:
            self.arrays = jax.device_put(dict(
                pos=store.point_pos.copy(), normal=store.point_normal.copy(),
                mind=store.point_min_dist.copy(),
                maxd=store.point_max_dist.copy(),
                desc=store.point_desc.copy(),
            ))
        self._layouts = {}
        self._jits = {}
        self.n_delta_syncs = 0  # packed-delta scatter dispatches
        # defense in depth vs creation races: re-ship everything that already
        # exists at the first sync (a row written concurrently with this
        # constructor would otherwise stay stale forever on the delta path;
        # CPU full-refresh self-heals)
        with store.lock:
            live = np.nonzero(store.point_valid)[0]
            if live.size:
                self.dirty[live] = True
        _prewarm_async(self._prewarm)

    def _prewarm(self):
        """Compile every bucket's scatter program ahead of use (background
        thread; AOT lower+compile touches no live buffers)."""
        if _cpu_backend():
            return
        for D in _BUCKETS:
            self._ensure_jit(D)
            lay = self._layouts[D]
            specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                     for k, v in self.arrays.items()}
            buf = jax.ShapeDtypeStruct((lay.total,), jnp.uint32)
            self._jits[D].lower(specs, buf).compile()

    def _ensure_jit(self, D):
        if D in self._jits:
            return

        lay = Layout([
            ("ids", (D,), "i32"),
            ("pos", (D, 3), "f32"), ("normal", (D, 3), "f32"),
            ("mind", (D,), "f32"), ("maxd", (D,), "f32"),
            ("desc", (D, 8), "u32"),
        ])
        self._layouts[D] = lay

        def update(arrays, buf):
            u = lay.unpack_jnp(buf)
            idx = u["ids"]

            # padding slots carry the out-of-range id P and are DROPPED by
            # the scatter. Never pad with -1: indices are normalised before
            # mode="drop" applies, so -1 writes the LAST row. Never
            # clamp-and-merge either: `.at[max(idx,0)].set(...)` writes row 0
            # once with fresh data and once per padding slot with the stale
            # row, and duplicate-index set() is last-write-wins in
            # unspecified order.
            def scat(cur, new):
                return cur.at[idx].set(new.astype(cur.dtype), mode="drop")

            return {k: scat(arrays[k], u[k]) for k in self.FIELDS}

        self._jits[D] = jax.jit(update)

    def mark(self, ids):
        ids = np.asarray(ids)
        if ids.size:
            self.dirty[ids[ids >= 0]] = True

    def _bucket(self, n: int) -> int:
        for b in _BUCKETS:
            if n <= b:
                return b
        return self.P

    def sync(self):
        """Ship dirty points to the device as packed delta buffers. Deltas
        larger than the biggest bucket go as CHUNKS through the same
        prewarmed scatter program. The read-and-clear of the dirty mask and
        the host gather run under the store lock (the async mapping worker
        marks concurrently)."""
        if not self.dirty.any():
            return
        s = self.store
        with self._sync_lock:
            with s.lock:
                ids = np.nonzero(self.dirty)[0]
                if ids.size == 0:
                    return
                self.dirty[ids] = False
                if _cpu_backend():  # see _cpu_backend: scatters are emulated
                    self.arrays = jax.device_put(dict(
                        pos=s.point_pos.copy(), normal=s.point_normal.copy(),
                        mind=s.point_min_dist.copy(),
                        maxd=s.point_max_dist.copy(),
                        desc=s.point_desc.copy(),
                    ))
                    return
                host = dict(
                    ids=ids,
                    pos=s.point_pos[ids], normal=s.point_normal[ids],
                    mind=s.point_min_dist[ids], maxd=s.point_max_dist[ids],
                    desc=s.point_desc[ids],
                )
            big = _BUCKETS[-1]
            for lo in range(0, ids.size, big):
                hi = min(lo + big, ids.size)
                D = self._bucket(hi - lo)
                self._ensure_jit(D)
                lay = self._layouts[D]

                def padf(a, fill=0):
                    out = np.full((D,) + a.shape[1:], fill, a.dtype)
                    out[: hi - lo] = a[lo:hi]
                    return out

                buf = lay.pack_np(dict(
                    ids=padf(host["ids"].astype(np.int32), self.P),
                    pos=padf(host["pos"]), normal=padf(host["normal"]),
                    mind=padf(host["mind"]), maxd=padf(host["maxd"]),
                    desc=padf(host["desc"]),
                ))
                self.arrays = self._jits[D](self.arrays, jax.device_put(buf))
                self.n_delta_syncs += 1


# keyframe-row delta buckets (rows per sync) — two sizes, prewarmed (see
# _BUCKETS note above)
_KF_BUCKETS = (4, 64)


class DeviceKFMirror:
    """Device-resident mirror of the keyframe FEATURE arrays (pose, keypoints,
    descriptors). The mapper's triangulation and fusion programs upload only
    KF indices + masks and gather the KF data on device.

    Two delta granularities: full rows (new keyframes — ~50 KB each) and
    pose-only updates (local BA / loop corrections — 48 B each). Same
    snapshot semantics as DeviceMapMirror.
    """

    FIELDS = ("R", "t", "uv", "oct", "desc", "ur", "kpv")

    def __init__(self, store):
        import threading

        self.store = store
        K, N = store.cap.max_keyframes, store.n_kp
        self.K, self.N = K, N
        self.dirty_row = np.zeros(K, bool)
        self.dirty_pose = np.zeros(K, bool)
        self._sync_lock = threading.Lock()  # see DeviceMapMirror._sync_lock
        with store.lock:
            self.arrays = jax.device_put(dict(
                R=store.kf_R.copy(), t=store.kf_t.copy(),
                uv=store.kf_uv.copy(),
                oct=store.kf_octave.copy(), desc=store.kf_desc.copy(),
                ur=store.kf_u_right.copy(), kpv=store.kf_kp_valid.copy(),
            ))
        self._row_layouts = {}
        self._row_jits = {}
        self._pose_jit = None
        with store.lock:  # see DeviceMapMirror: re-ship pre-existing rows
            live = np.nonzero(store.kf_valid)[0]
            if live.size:
                self.dirty_row[live] = True
        _prewarm_async(self._prewarm)

    def _prewarm(self):
        if _cpu_backend():
            return
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in self.arrays.items()}
        for D in _KF_BUCKETS:
            self._ensure_row_jit(D)
            lay = self._row_layouts[D]
            buf = jax.ShapeDtypeStruct((lay.total,), jnp.uint32)
            self._row_jits[D].lower(specs, buf).compile()
        self._ensure_pose_jit()
        for D in _KF_BUCKETS:
            self._pose_jit.lower(
                specs, jax.ShapeDtypeStruct((D,), jnp.int32),
                jax.ShapeDtypeStruct((D, 3, 3), jnp.float32),
                jax.ShapeDtypeStruct((D, 3), jnp.float32)).compile()

    def mark_row(self, k):
        self.dirty_row[k] = True

    def mark_pose(self, k):
        self.dirty_pose[k] = True

    def _bucket(self, n: int) -> int:
        for b in _KF_BUCKETS:
            if n <= b:
                return b
        return self.K

    def sync(self):
        s = self.store
        with self._sync_lock, s.lock:
            rows = np.nonzero(self.dirty_row)[0]
            poses = np.nonzero(self.dirty_pose & ~self.dirty_row)[0]
            self.dirty_row[:] = False
            self.dirty_pose[:] = False
            if _cpu_backend() and (rows.size or poses.size):
                self.arrays = jax.device_put(dict(
                    R=s.kf_R.copy(), t=s.kf_t.copy(), uv=s.kf_uv.copy(),
                    oct=s.kf_octave.copy(), desc=s.kf_desc.copy(),
                    ur=s.kf_u_right.copy(), kpv=s.kf_kp_valid.copy(),
                ))
                return
            if rows.size:
                self._sync_rows(rows)
            if poses.size:
                self._sync_poses(poses)

    def _ensure_pose_jit(self):
        if self._pose_jit is not None:
            return

        def upd(arrays, ids, R, t):
            # padding ids are K and dropped — see the point-mirror scatter
            # note (-1 would write the last row)
            out = dict(arrays)
            out["R"] = arrays["R"].at[ids].set(R, mode="drop")
            out["t"] = arrays["t"].at[ids].set(t, mode="drop")
            return out

        self._pose_jit = jax.jit(upd)

    def _sync_poses(self, ids):
        s = self.store
        self._ensure_pose_jit()
        big = _KF_BUCKETS[-1]
        for lo in range(0, ids.size, big):
            hi = min(lo + big, ids.size)
            D = self._bucket(hi - lo)

            def padf(a, fill=0):
                out = np.full((D,) + a.shape[1:], fill, a.dtype)
                out[: hi - lo] = a[lo:hi]
                return out

            dev = jax.device_put((padf(ids.astype(np.int32), self.K),
                                  padf(s.kf_R[ids]), padf(s.kf_t[ids])))
            self.arrays = self._pose_jit(self.arrays, *dev)

    def _ensure_row_jit(self, D):
        if D in self._row_jits:
            return
        N = self.N
        lay = Layout([
            ("ids", (D,), "i32"), ("R", (D, 3, 3), "f32"),
            ("t", (D, 3), "f32"), ("uv", (D, N, 2), "f32"),
            ("oct", (D, N), "i32"), ("desc", (D, N, 8), "u32"),
            ("ur", (D, N), "f32"), ("kpv", (D, N), "bool"),
        ])
        self._row_layouts[D] = lay

        def update(arrays, buf):
            u = lay.unpack_jnp(buf)
            idx = u["ids"]

            # padding ids are K and dropped — see the point-mirror scatter
            # note (-1 would write the last row)
            def scat(cur, new):
                return cur.at[idx].set(new.astype(cur.dtype), mode="drop")

            return {k: scat(arrays[k], u[k]) for k in self.FIELDS}

        self._row_jits[D] = jax.jit(update)

    def _sync_rows(self, ids):
        s = self.store
        big = _KF_BUCKETS[-1]
        for lo in range(0, ids.size, big):
            hi = min(lo + big, ids.size)
            D = self._bucket(hi - lo)
            self._ensure_row_jit(D)
            lay = self._row_layouts[D]

            def padf(a, fill=0):
                out = np.full((D,) + a.shape[1:], fill, a.dtype)
                out[: hi - lo] = a[lo:hi]
                return out

            buf = lay.pack_np(dict(
                ids=padf(ids.astype(np.int32), self.K),
                R=padf(s.kf_R[ids]), t=padf(s.kf_t[ids]),
                uv=padf(s.kf_uv[ids]),
                oct=padf(s.kf_octave[ids]), desc=padf(s.kf_desc[ids]),
                ur=padf(s.kf_u_right[ids]), kpv=padf(s.kf_kp_valid[ids]),
            ))
            self.arrays = self._row_jits[D](self.arrays, jax.device_put(buf))
