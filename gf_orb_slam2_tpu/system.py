"""System facade: the user-facing SLAM engine API.

JAX replacement for ORB_SLAM2::System (reference: include/System.h:69,
src/System.cc:43): constructs the map, tracker and mapper, exposes per-frame
TrackStereo/TrackRGBD/TrackMonocular, mode switches, reset, and trajectory
savers. The reference spawns LocalMapping/LoopClosing threads
(System.cc:113-124); here the pipeline is an explicit host-side sequence per
frame — tracking always runs, mapping runs when a keyframe is inserted
(SURVEY.md §2.3 P1: thread parallelism → host pipeline feeding fused device
programs; the jitted stages internally overlap on the device).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from gf_orb_slam2_tpu.config import Sensor, SystemConfig
from gf_orb_slam2_tpu.features.extractor import ORBExtractor
from gf_orb_slam2_tpu.geometry import camera as cam_mod
from gf_orb_slam2_tpu.io import trajectory as traj_io
from gf_orb_slam2_tpu.mapping.local_mapping import LocalMapper
from gf_orb_slam2_tpu.matching import stereo as stereo_mod
from gf_orb_slam2_tpu.slammap.store import MapStore
from gf_orb_slam2_tpu.tracking.frame import Frame
from gf_orb_slam2_tpu.tracking.tracker import Tracker, TrackState


class _PipelineFetcher:
    """Background threads that device_get pipelined results: each blocking
    fetch overlaps the main thread's dispatch and host bookkeeping instead
    of serializing with them (the GIL releases inside the wait). Several
    workers run CONCURRENT fetches."""

    def __init__(self, n_workers: int = 3):
        import queue
        import threading

        self._q = queue.Queue()
        self._results = {}
        self._cv = threading.Condition()
        self._threads = [
            threading.Thread(target=self._run, daemon=True)
            for _ in range(n_workers)
        ]
        for t in self._threads:
            t.start()

    def submit(self, seq: int, dev_arr):
        self._q.put((seq, dev_arr))

    def _run(self):
        import jax as _jax

        while True:
            item = self._q.get()
            if item is None:
                return
            seq, dev_arr = item
            try:
                buf = np.asarray(_jax.device_get(dev_arr))
            except Exception as e:  # surface device errors at get()
                buf = e
            with self._cv:
                self._results[seq] = buf
                self._cv.notify_all()

    def get(self, seq: int) -> np.ndarray:
        with self._cv:
            while seq not in self._results:
                self._cv.wait()
            buf = self._results.pop(seq)
        if isinstance(buf, Exception):
            raise buf
        return buf

    def stop(self):
        for _ in self._threads:
            self._q.put(None)


class _MappingWorker:
    """Async local-mapping + loop-closing worker: the device-side analogue of
    the reference's LocalMapping/LoopClosing threads (System.cc:113-124).
    Keyframes queue here from the pipelined tracker; mapper stages take the
    store lock for host mutations and release it during device solves, so
    tracking bookkeeping interleaves. When keyframes pile up, local BA is
    skipped for the older ones (reference: mbAbortBA)."""

    def __init__(self, system: "System"):
        import queue
        import threading

        self.sys = system
        self._q = queue.Queue()
        self._error = None
        # BA merge accounting (VERDICT r4 #4: silent shedding was invisible;
        # gates assert n_ba_runs covers every batch)
        self.n_kf_events = 0
        self.n_ba_runs = 0
        self.n_ba_merged = 0
        # held while a batch is processed; pause() acquires it — the loop
        # closer stops mapping during a correction exactly like the
        # reference's LocalMapping::RequestStop (LoopClosing.cc:439)
        self._work_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def pause(self):
        """Block until the current batch finishes; hold mapping paused."""
        self._work_lock.acquire()

    def resume(self):
        self._work_lock.release()

    def submit(self, kf: int):
        self._q.put(kf)

    def _run(self):
        import queue as _queue

        while True:
            kf = self._q.get()
            if kf is None:
                self._q.task_done()
                return
            # drain the backlog into ONE batch: older KFs run their map
            # maintenance (association/triangulation/fusion) but the window
            # BA runs ONCE on the newest KF — its covisibility window covers
            # the whole batch. This is the reference's abort-and-re-enter
            # local BA (LocalMapping.cc:155,815 mbAbortBA) rather than the
            # r4 behavior of silently dropping 62% of BAs under load.
            batch = [kf]
            stop = False
            while True:
                try:
                    nxt = self._q.get_nowait()
                except _queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            try:
                with self._work_lock:  # released between batches → pause()
                    for i, k in enumerate(batch):
                        last = i == len(batch) - 1
                        self.sys._on_keyframe(k, skip_ba=not last)
                        self.n_kf_events += 1
                        if last:
                            self.n_ba_runs += 1
                        else:
                            self.n_ba_merged += 1
            except Exception as e:  # surfaced at the next wait_idle()
                self._error = e
            finally:
                for _ in batch:
                    self._q.task_done()
                if stop:
                    self._q.task_done()
            if stop:
                return

    def wait_idle(self):
        self._q.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def stop(self):
        self._q.put(None)
        self._q.join()


class _LoopWorker:
    """Dedicated loop-closing thread (reference: System.cc:117 spawns
    LoopClosing SEPARATELY from LocalMapping). Running detection/Sim3 on the
    mapping worker serialized them per KF event: during the revisit stretch
    the Sim3 candidate evaluations starved triangulation/BA and tracking
    drifted into unmapped territory (measured: async circuit ATE 1.23 m with
    loop detection inline on the mapping worker vs 0.17 m without loop)."""

    def __init__(self, system: "System"):
        import queue
        import threading

        self.sys = system
        self._q = queue.Queue()
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, kf: int):
        self._q.put(kf)

    def _run(self):
        while True:
            kf = self._q.get()
            if kf is None:
                self._q.task_done()
                return
            try:
                if self.sys.loop_closer is not None:
                    self.sys.loop_closer.process_keyframe(kf)
            except Exception as e:  # surfaced at the next wait_idle()
                self._error = e
            finally:
                self._q.task_done()

    def wait_idle(self):
        self._q.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def stop(self):
        self._q.put(None)
        self._q.join()


def _to_u8(im) -> np.ndarray:
    """Grayscale image → uint8 (upload bandwidth: u8 ships 4x smaller than
    f32; intensities are 0-255 integers in the reference pipeline anyway)."""
    im = np.asarray(im)
    if im.dtype == np.uint8:
        return im
    return np.clip(im, 0, 255).astype(np.uint8)


class System:
    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        cam = cfg.camera
        n_kp = cfg.capacity.max_keypoints
        self.extractor = ORBExtractor(cfg.orb, cam.height, cam.width)
        # pad feature capacity to the configured keypoint capacity
        assert self.extractor.n_total <= n_kp, "orb.n_features > capacity.max_keypoints"
        self.n_kp = n_kp
        self.store = MapStore(cfg.capacity, n_kp)
        scales = np.asarray(self.extractor.scales, np.float32)
        self.tracker = Tracker(cfg, self.store, n_kp, scales)
        self.mapper = LocalMapper(cfg, self.store, n_kp, scales)
        # anticipation budgeting reads the tracker's motion model
        self.mapper.velocity_provider = lambda: self.tracker.velocity
        # background-compile the mapper's fixed-shape programs so first KF
        # events don't stall the live pipeline on compiles
        self.mapper.prewarm_async()
        self.frame_id = 0
        # streaming pipeline state (track_stereo_pipelined)
        from collections import deque

        self._inflight = deque()
        self._pipeline_depth = cfg.tracking.pipeline_depth
        if cfg.tracking.async_mapping and cfg.loop.synchronous_gba:
            import warnings

            warnings.warn(
                "loop.synchronous_gba is a test/gate-only setting: combined "
                "with tracking.async_mapping the inline global BA stalls "
                "tracking for its whole duration", stacklevel=2)
        self._fetcher: Optional[_PipelineFetcher] = None
        self._map_worker: Optional[_MappingWorker] = None
        self._loop_worker: Optional[_LoopWorker] = None
        # place recognition: load the pretrained vocabulary asset (reference:
        # System loads the DBoW2 file up front, System.cc:78-84); lazy
        # self-training remains only as a fallback when no asset exists
        self.voc = None
        self.kfdb = None
        self.loop_closer = None
        self._vocab_min_kfs = 8
        self._load_vocabulary()
        if cfg.loop.enabled and self.voc is not None:
            # stand up place recognition + loop closing NOW and background-
            # compile its jit family: in r4 these programs compiled at the
            # FIRST loop event, mid-sequence (the reference instead spawns
            # its LoopClosing thread at construction, System.cc:117-118)
            self._ensure_place_recognition()
            if self.loop_closer is not None:
                self.loop_closer.prewarm_async()
        self._rectify_left: Optional[cam_mod.RectifyMap] = None
        self._rectify_right: Optional[cam_mod.RectifyMap] = None
        if cam.left_K is not None:
            self._rectify_left = cam_mod.RectifyMap.from_np(
                cam.left_K, cam.left_D, cam.left_R, cam.left_P, cam.fisheye
            )
            self._rectify_right = cam_mod.RectifyMap.from_np(
                cam.right_K, cam.right_D, cam.right_R, cam.right_P, cam.fisheye
            )
        self._pin = cam_mod.PinholeCamera.from_config(cam)
        if cfg.hashing.enabled:
            from gf_orb_slam2_tpu.hashing.mih import MultiIndexHashing

            mih = MultiIndexHashing(cfg.hashing, cfg.capacity.max_map_points)
            self.tracker.mih = mih
            self.mapper.mih = mih

    # ------------------------------------------------------------ tracking
    def track_stereo(self, im_left, im_right, timestamp: float) -> np.ndarray:
        """Reference: System::TrackStereo (System.cc:144) → 4x4 Tcw."""
        assert self.cfg.sensor == Sensor.STEREO
        # rebase BEFORE the frame build: it pre-dispatches the fused step
        # against the last pose + cached pool, which must share one world
        with self.store.lock:
            self.tracker.apply_pending_rebase()
        frame = self._build_stereo_frame(im_left, im_right, timestamp)
        return self._track(frame)

    def track_stereo_pipelined(self, im_left, im_right, timestamp: float):
        """Streaming stereo tracking: submit this frame, return the list of
        (frame_id, Tcw) results that completed THIS call — normally one,
        `pipeline_depth` frames behind; empty while the pipeline fills.

        The per-frame dependency chain (pose prediction, last-frame match
        state) lives on the device (tracker._stream_step_impl), so
        consecutive frames' programs pipeline; the host only uploads images
        + the stale local pool and fetches results late. Sustained
        throughput ≈ device compute instead of round-trip latency. Call
        `flush_pipeline()` to drain at end of sequence.
        """
        assert self.cfg.sensor == Sensor.STEREO
        tr = self.tracker
        if not tr.stream_ready():
            done = self.flush_pipeline()
            pose = self.track_stereo(im_left, im_right, timestamp)
            return done + [(self.frame_id - 1, pose)]
        if self.store.mirror is None:
            from gf_orb_slam2_tpu.slammap.device_mirror import DeviceMapMirror

            with self.store.lock:  # vs prewarm-thread creation (TOCTOU)
                if self.store.mirror is None:
                    self.store.mirror = DeviceMapMirror(self.store)
        if tr._chain is None:
            tr._chain = tr.stream_bootstrap_chain()
        # complete the oldest in-flight frame FIRST so its bookkeeping (pool
        # refresh, keyframes) feeds this dispatch with the freshest state
        done = []
        while len(self._inflight) >= self._pipeline_depth:
            done.append(self._complete_one())
        # a completion can invalidate streaming state (empty local-map gather
        # after KF bookkeeping nulls _cached_pool, or the track went LOST) —
        # re-check and fall back to the synchronous path for this frame
        if not tr.stream_ready():
            self.n_stream_fallbacks = getattr(self, "n_stream_fallbacks", 0) + 1
            done += self.flush_pipeline()
            pose = self.track_stereo(im_left, im_right, timestamp)
            return done + [(self.frame_id - 1, pose)]
        # a completed KF event may have loop-corrected the world: complete
        # the frames still in flight FIRST (they were dispatched against the
        # old world — their fetched poses/velocity must not mix frames), then
        # rebase the device chain / last pose BEFORE dispatching against the
        # (also corrected) mirror
        if tr.pending_map_rebase is not None:
            while self._inflight:
                done.append(self._complete_one())
            with self.store.lock:
                self.tracker.apply_pending_rebase()
            if not tr.stream_ready():
                self.n_stream_fallbacks = getattr(
                    self, "n_stream_fallbacks", 0) + 1
                done += self.flush_pipeline()
                pose = self.track_stereo(im_left, im_right, timestamp)
                return done + [(self.frame_id - 1, pose)]
        # ship map deltas AFTER completions so points created/adjusted by
        # their keyframes are device-visible to this dispatch (no-op if clean)
        self.store.mirror.sync()
        packed, pool_ids = tr.stream_prepare_upload(self.frame_id)
        imgs = np.stack([_to_u8(im_left), _to_u8(im_right)])
        imgs_d, up_d = jax.device_put((imgs, packed))
        out = self._get_frontend("stereo")(imgs_d)
        packed_out = tr.stream_dispatch(out, up_d)
        f = self._make_frame(out, timestamp)
        if self._fetcher is None:
            self._fetcher = _PipelineFetcher()
        self._fetcher.submit(f.frame_id, packed_out)
        self._inflight.append((f, pool_ids))
        self.frame_id += 1
        return done

    def flush_pipeline(self):
        """Drain in-flight pipelined frames (and any queued mapping work);
        returns [(frame_id, Tcw), ...]."""
        done = []
        while self._inflight:
            done.append(self._complete_one())
        self.tracker._chain = None
        if self._map_worker is not None:
            self._map_worker.wait_idle()
        if self._loop_worker is not None:
            self._loop_worker.wait_idle()
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()
        return done

    def _complete_one(self):
        frame, pool_ids = self._inflight.popleft()
        raw = self._fetcher.get(frame.frame_id)
        st = self.tracker.stream_complete(frame, raw, pool_ids)
        rt = getattr(self, "_rt_stream", None)
        if rt is not None and frame.R is not None:
            from gf_orb_slam2_tpu.io.trajectory import _pose_to_twc, _quat_wxyz

            Rwc, twc = _pose_to_twc(frame.pose_matrix())
            q = _quat_wxyz(Rwc)
            rt.write(f"{frame.timestamp:.6f} {twc[0]:.7f} {twc[1]:.7f} "
                     f"{twc[2]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f} "
                     f"{q[0]:.7f}\n")
            rt.flush()
        if st.created_kf and not self.cfg.localization_only:
            kf = self.tracker.ref_kf
            if self.cfg.tracking.async_mapping:
                if self._map_worker is None:
                    self._map_worker = _MappingWorker(self)
                self._map_worker.submit(kf)
            else:
                self._on_keyframe(kf)
        return (frame.frame_id, frame.pose_matrix())

    def _on_keyframe(self, kf: int, skip_ba: bool = False):
        """KF post-processing: local mapping stages then loop closing.
        The single definition shared by the sync pipeline, the async mapping
        worker and the profiling tools (ADVICE r3: tools re-implementing this
        drift from production). Stages take store.lock internally around host
        mutations and release it across device solves. In async mode loop
        closing hands off to its OWN worker (reference: LocalMapping and
        LoopClosing are separate threads, System.cc:113-118) so Sim3
        candidate evaluation never delays triangulation/BA of the next KF."""
        self.mapper.process_keyframe(kf, skip_ba=skip_ba)
        if self.cfg.loop.enabled:
            self._ensure_place_recognition()
            if self.loop_closer is not None:
                if self.cfg.tracking.async_mapping:
                    if self._loop_worker is None:
                        self._loop_worker = _LoopWorker(self)
                    self._loop_worker.submit(kf)
                else:
                    self.loop_closer.process_keyframe(kf)

    def track_rgbd(self, im, depth_map, timestamp: float) -> np.ndarray:
        """Reference: System::TrackRGBD (System.cc:214)."""
        assert self.cfg.sensor == Sensor.RGBD
        with self.store.lock:
            self.tracker.apply_pending_rebase()
        frame = self._build_rgbd_frame(im, depth_map, timestamp)
        return self._track(frame)

    def track_monocular(self, im, timestamp: float) -> np.ndarray:
        """Reference: System::TrackMonocular (System.cc:282)."""
        assert self.cfg.sensor == Sensor.MONOCULAR
        with self.store.lock:
            self.tracker.apply_pending_rebase()
        frame = self._build_mono_frame(im, timestamp)
        return self._track(frame)

    def track_frame(self, frame: Frame) -> np.ndarray:
        """Feature-level entry (synthetic/testing): bypass image pipeline."""
        return self._track(frame)

    def _track(self, frame: Frame) -> np.ndarray:
        if self._map_worker is not None:
            # synchronous tracking interleaved with async mapping: settle the
            # map first (sync path reads the store without fine-grained locks)
            self._map_worker.wait_idle()
        if self._loop_worker is not None:
            self._loop_worker.wait_idle()
        st = self.tracker.process_frame(frame)
        # hard reset when lost right after init (reference: Tracking.cc:813 —
        # lost with <=5 KFs → System::Reset) or lost far too long
        if self.tracker.state.name == "LOST" and not self.cfg.localization_only:
            if self.store.n_keyframes <= 5 and self.cfg.sensor.name == "MONOCULAR":
                self.reset()
            elif self.tracker.n_lost > self.cfg.tracking.max_lost_frames:
                self.reset()
        rt = getattr(self, "_rt_stream", None)
        if rt is not None and frame.R is not None:
            from gf_orb_slam2_tpu.io.trajectory import _pose_to_twc, _quat_wxyz

            Rwc, twc = _pose_to_twc(frame.pose_matrix())
            q = _quat_wxyz(Rwc)
            rt.write(f"{frame.timestamp:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                     f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")
            rt.flush()
        if st.created_kf and not self.cfg.localization_only:
            self._on_keyframe(self.tracker.ref_kf)
        self.frame_id += 1
        return frame.pose_matrix()

    def _load_vocabulary(self):
        """Load the pretrained BoW vocabulary (reference: System.cc:78-84).
        cfg.vocabulary_path: None → shipped asset; "" → disabled (lazy
        training fallback); path → that file."""
        import os

        path = self.cfg.vocabulary_path
        if path == "":
            return
        if path is None:
            adir = os.path.join(os.path.dirname(__file__), "assets")
            # prefer the largest shipped vocabulary (reference ships a 1M-word
            # tree, TemplatedVocabulary.h:1469; retrieval precision grows with
            # word count)
            for name in ("vocab100k.npz", "vocab10k.npz"):
                cand = os.path.join(adir, name)
                if os.path.exists(cand):
                    path = cand
                    break
            else:
                return
        from gf_orb_slam2_tpu.place.vocabulary import Vocabulary

        self.voc = Vocabulary.load(path)

    def _ensure_place_recognition(self):
        """Activate the KF database + loop closing once the vocabulary is up
        (reference wiring: System.cc:96-118). Falls back to training a
        vocabulary from early map descriptors when no asset was loaded."""
        if self.voc is not None or self.store.n_keyframes < self._vocab_min_kfs:
            if self.kfdb is not None:
                return
            if self.voc is None:
                return
        if self.voc is None:
            from gf_orb_slam2_tpu.place.vocabulary import Vocabulary

            s = self.store
            with s.lock:  # snapshot descriptors; training runs lock-free
                descs = []
                for k in s.valid_kf_ids():
                    d = s.kf_desc[k][s.kf_kp_valid[k]]
                    descs.append(d)
                data = np.concatenate(descs, 0)
            if len(data) < 512:
                return
            if len(data) > 20000:
                data = data[np.random.default_rng(0).choice(len(data), 20000, replace=False)]
            self.voc = Vocabulary.train(data, k=8, levels=3, iters=4)
        from gf_orb_slam2_tpu.loopclosing.loop_closer import LoopCloser
        from gf_orb_slam2_tpu.place.keyframe_db import KeyFrameDatabase

        self.kfdb = KeyFrameDatabase(self.voc, self.store)
        for k in self.store.valid_kf_ids()[:-1]:
            self.kfdb.add(int(k))
        self.loop_closer = LoopCloser(self.cfg, self.store, self.kfdb)
        self.loop_closer.map_rebase_cb = self.tracker.notify_map_rebase
        self.loop_closer.gba_writeback_cb = self._on_gba_writeback
        self.loop_closer.pause_mapping_cb = self._pause_mapping
        self.loop_closer.resume_mapping_cb = self._resume_mapping
        self.tracker.kfdb = self.kfdb

    def _pause_mapping(self):
        if self._map_worker is not None:
            self._map_worker.pause()

    def _resume_mapping(self):
        if self._map_worker is not None:
            self._map_worker.resume()

    def _on_gba_writeback(self, before_R, before_t):
        """GBA write-back rebases live tracking by the ref KF's pose delta
        (called with store.lock held; see tracker.notify_map_rebase)."""
        k = self.tracker.ref_kf
        s = self.store
        if k is None or k < 0 or not s.kf_valid[k]:
            return
        R_old, t_old = before_R[k], before_t[k]
        R_new, t_new = s.kf_R[k], s.kf_t[k]
        R_D = R_new.T @ R_old
        t_D = R_new.T @ (t_old - t_new)
        ang = float(np.arccos(np.clip((np.trace(R_D) - 1) / 2, -1.0, 1.0)))
        if ang > 1e-4 or float(np.linalg.norm(t_D)) > 1e-4:
            self.tracker.notify_map_rebase(R_D, t_D)

    # ------------------------------------------------------- frame builders
    #
    # Each frontend is ONE fused jitted program (extract [+ rectify/undistort
    # + stereo/depth]) and its results reach the host in ONE device_get.

    def _pad_feats(self, f):
        n = self.extractor.n_total
        pad = self.n_kp - n

        def p(a, fill=0.0):
            if pad == 0:
                return a
            width = ((0, pad),) + ((0, 0),) * (a.ndim - 1)
            return jnp.pad(a, width, constant_values=fill)

        return (p(f.uv), p(f.octave), p(f.angle), p(f.desc), p(f.response),
                p(f.valid, False))

    def _frontend_stereo_impl(self, imgs):
        """imgs: [2,H,W] stacked (left, right) — one upload leaf."""
        import jax

        im_left, im_right = imgs[0], imgs[1]
        # one vmapped extraction for BOTH images: same kernel count as a
        # single image, twice the data per kernel
        f2 = jax.vmap(self.extractor._extract)(imgs)
        fl = jax.tree_util.tree_map(lambda a: a[0], f2)
        fr = jax.tree_util.tree_map(lambda a: a[1], f2)
        uv_l, oct_l, ang_l, desc_l, resp_l, val_l = self._pad_feats(fl)
        uv_r, oct_r, ang_r, desc_r, resp_r, val_r = self._pad_feats(fr)
        if self._rectify_left is not None:
            uv_l = cam_mod.rectify_keypoints(self._rectify_left, uv_l)
            uv_r = cam_mod.rectify_keypoints(self._rectify_right, uv_r)
        elif any(self.cfg.camera.dist):
            uv_l = cam_mod.undistort_keypoints(self._pin, uv_l)
            uv_r = cam_mod.undistort_keypoints(self._pin, uv_r)
        sm = stereo_mod.match_stereo(
            uv_l, oct_l, desc_l, val_l, uv_r, oct_r, desc_r, val_r,
            im_left.astype(jnp.float32), im_right.astype(jnp.float32),
            jnp.asarray(np.asarray(self.extractor.scales, np.float32)),
            self.cfg.camera.bf,
        )
        return uv_l, oct_l, ang_l, desc_l, resp_l, val_l, sm.u_right, sm.depth

    def _frontend_mono_impl(self, im, depth_map=None):
        f = self.extractor._extract(im)
        uv, octv, ang, desc, resp, valid = self._pad_feats(f)
        if any(self.cfg.camera.dist):
            uv = cam_mod.undistort_keypoints(self._pin, uv)
        if depth_map is None:
            n = self.n_kp
            ur = jnp.full((n,), -1.0, jnp.float32)
            dep = jnp.full((n,), -1.0, jnp.float32)
        else:
            factor = (1.0 / self.cfg.camera.depth_map_factor
                      if self.cfg.camera.depth_map_factor not in (0, 1) else 1.0)
            sm = stereo_mod.depth_to_disparity(
                uv, valid, depth_map.astype(jnp.float32), self.cfg.camera.bf, factor
            )
            ur, dep = sm.u_right, sm.depth
        return uv, octv, ang, desc, resp, valid, ur, dep

    def _get_frontend(self, kind):
        if not hasattr(self, "_frontends"):
            self._frontends = {}
        if kind not in self._frontends:
            import jax

            if kind == "stereo":
                self._frontends[kind] = jax.jit(self._frontend_stereo_impl)
            elif kind == "mono":
                self._frontends[kind] = jax.jit(lambda im: self._frontend_mono_impl(im))
            else:
                self._frontends[kind] = jax.jit(
                    lambda im, dm: self._frontend_mono_impl(im, dm)
                )
        return self._frontends[kind]

    def _make_frame(self, dev_out, ts) -> Frame:
        dev_sub = (dev_out[0], dev_out[1], dev_out[6], dev_out[5], dev_out[3],
                   dev_out[2])
        return Frame.deferred(self.frame_id, ts, dev_out, dev_sub)

    def _build_stereo_frame(self, im_left, im_right, ts) -> Frame:
        import jax

        # TWO upload leaves for the whole frame: the stacked image pair and
        # the packed fused-step buffer (inputs + local pool + scalars).
        # Images ship as uint8 (4x smaller than f32) and are cast on device.
        imgs = np.stack([_to_u8(im_left), _to_u8(im_right)])
        prep = self.tracker.prepare_fused_host_inputs(ts, self.frame_id)
        if prep is None:
            out = self._get_frontend("stereo")(jax.device_put(imgs))
            f = self._make_frame(out, ts)
            f._predispatched = None
            return f
        packed, meta = prep
        imgs_d, up_d = jax.device_put((imgs, packed))
        out = self._get_frontend("stereo")(imgs_d)
        # dispatch the fused tracking step on the DEVICE outputs — the whole
        # frame then needs a single one-leaf blocking device_get (tracker).
        pre = self.tracker.fused_dispatch_uploaded(out, up_d, meta)
        f = self._make_frame(out, ts)
        f._predispatched = pre
        if self.cfg.charuco.enabled and self.state.name in (
                "NO_IMAGES_YET", "NOT_INITIALIZED"):
            f._raw_img = np.asarray(im_left)
        return f

    # NOTE: frames are DEFERRED — host arrays are fetched inside the tracker
    # (batched with the tracking results: one blocking sync per frame).

    def _build_rgbd_frame(self, im, depth_map, ts) -> Frame:
        out = self._get_frontend("rgbd")(
            jnp.asarray(_to_u8(im)), jnp.asarray(depth_map, jnp.float32))
        return self._make_frame(out, ts)

    def _build_mono_frame(self, im, ts) -> Frame:
        out = self._get_frontend("mono")(jnp.asarray(_to_u8(im)))
        return self._make_frame(out, ts)

    # ------------------------------------------------------------ lifecycle
    def wait_prewarm(self, timeout=None):
        """Join the background compile-prewarm threads (mapper + loop
        closer). Call before a timed run so every fixed-shape program is
        compiled/cache-loaded up front — compile time is startup cost, like
        the reference's vocabulary load (System.cc:78-84)."""
        from gf_orb_slam2_tpu.slammap.device_mirror import wait_prewarm

        wait_prewarm(timeout)

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    def set_realtime_stream(self, path):
        """Per-frame TUM-format pose stream appended as tracking runs
        (reference: System::SetRealTimeFileStream System.cc:415)."""
        self._rt_stream = open(path, "w")

    def buffer_odometry(self, timestamp: float, R, t):
        """Push a planner-predicted world→cam pose for `timestamp`
        (reference: System/Tracking BufferingOdom Tracking.cc:503, fed from
        the /desired_path topic in ros_stereo.cc:171). When the buffer covers
        the tracked timestamps, the motion-model prediction uses it instead
        of constant velocity (PredictRelMotionFromBuffer Tracking.cc:1448)."""
        import numpy as _np

        self.tracker.odom.push(timestamp, _np.asarray(R, _np.float32),
                               _np.asarray(t, _np.float32))

    def save_lmk_log(self, path):
        """Landmark-lifetime log (reference: System::SaveLmkLog System.cc:479,
        LmkLog Util.hpp:384): per-landmark visible/found counters, observation
        count, and first keyframe."""
        import json

        s = self.store
        with open(path, "w") as f:
            for p in s.valid_point_ids():
                f.write(json.dumps({
                    "id": int(p),
                    "first_kf": int(s.point_first_kf[p]),
                    "n_obs": int(s.point_nobs[p]),
                    "visible": int(s.point_visible[p]),
                    "found": int(s.point_found[p]),
                }) + "\n")

    def force_reloc(self):
        """Reference: System::ForceRelocTracker (System.cc:798)."""
        from gf_orb_slam2_tpu.tracking.tracker import TrackState

        self.tracker.state = TrackState.LOST
        self.tracker.velocity = None

    def force_reinit(self):
        """Reference: System::ForceInitTracker (System.cc:802) — full reset
        and re-initialization from scratch."""
        self.reset()

    def set_constr_per_frame(self, n: int):
        """Good-feature budget: number of actively matched constraints/frame
        (reference: System::SetConstrPerFrame System.cc:444)."""
        import dataclasses

        gf = dataclasses.replace(self.cfg.good_feature, constr_per_frame=int(n))
        self.cfg = self.cfg.replace(good_feature=gf)
        self.tracker.cfg = self.cfg
        # budget is jit-static (greedy round count): rebuild the local step
        self.tracker._jit_local = __import__("jax").jit(self.tracker._local_step_impl)

    def set_budget_per_frame(self, budget_ms: float):
        """Map good-graph time budget → subgraph size via the cubic model
        (reference: System::SetBudgetPerFrame System.cc:433 +
        estimateKFNum Optimizer.cc:566)."""
        import dataclasses

        from gf_orb_slam2_tpu.selection.good_graph import estimate_kf_budget

        gg = dataclasses.replace(
            self.cfg.good_graph, subgraph_size=estimate_kf_budget(budget_ms)
        )
        self.cfg = self.cfg.replace(good_graph=gg)
        self.mapper.cfg = self.cfg

    def activate_localization_mode(self):
        """Reference: System::ActivateLocalizationMode (System.cc:~340)."""
        self.cfg = self.cfg.replace(localization_only=True)
        self.tracker.cfg = self.cfg

    def deactivate_localization_mode(self):
        self.cfg = self.cfg.replace(localization_only=False)
        self.tracker.cfg = self.cfg

    def reset(self):
        """Reference: System::Reset (System.cc:376) → Tracking::Reset."""
        if self._map_worker is not None:
            self._map_worker.wait_idle()
        if self._loop_worker is not None:
            self._loop_worker.wait_idle()
        if self.loop_closer is not None:
            # a GBA launched before the reset must not write old-map poses
            # onto reused slot ids of the fresh map (reference: Tracking::Reset
            # calls LoopClosing::RequestReset which joins the GBA thread)
            self.loop_closer.abort_gba()
            self.loop_closer._consistent.clear()
            self.loop_closer.last_loop_kf = -1
        if self.kfdb is not None:
            self.kfdb.clear()
        self._inflight.clear()
        self.tracker._chain = None
        self.tracker.pending_map_rebase = None
        self.store.clear()
        self.tracker.state = TrackState.NO_IMAGES_YET
        self.tracker.last_frame = None
        self.tracker.velocity = None
        self.tracker.ref_kf = -1
        self.tracker.relative_poses.clear()
        self.mapper.recent_points.clear()

    def shutdown(self):
        """Drain the streaming pipeline and stop its fetcher thread
        (reference: System::Shutdown System.cc:382 joins its threads and
        waits for a running global BA — isRunningGBA loop). Also joins the
        background compile-prewarm threads: a prewarm mid-compile when the
        interpreter exits aborts XLA ("FATAL: exception not rethrown",
        SIGABRT — the r4 test_examples_cli teardown crash)."""
        self.wait_prewarm()
        self.flush_pipeline()
        if self._fetcher is not None:
            self._fetcher.stop()
            self._fetcher = None
        if self._map_worker is not None:
            self._map_worker.stop()
            self._map_worker = None
        if self._loop_worker is not None:
            self._loop_worker.stop()
            self._loop_worker = None
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()

    # ----------------------------------------------------------- map io
    def save_map(self, path):
        """Reference: System::SaveMap (System.cc:1315)."""
        from gf_orb_slam2_tpu.io.map_io import save_map

        save_map(path, self.store)
        if self.voc is not None:
            self.voc.save(str(path) + ".voc.npz")

    def load_map(self, path):
        """Reference: System::LoadMap (System.cc:907). Typically followed by
        activate_localization_mode()."""
        from gf_orb_slam2_tpu.io.map_io import load_map

        load_map(path, self.store)
        import os

        voc_path = str(path) + ".voc.npz"
        if os.path.exists(voc_path):
            from gf_orb_slam2_tpu.place.vocabulary import Vocabulary

            self.voc = Vocabulary.load(voc_path)
            self._ensure_place_recognition()
        # tracking restarts lost → relocalize against the loaded map
        self.tracker.state = TrackState.LOST
        if self.store.n_keyframes:
            self.tracker.ref_kf = int(self.store.valid_kf_ids()[-1])

    # ----------------------------------------------------------- trajectory
    def save_trajectory_tum(self, path):
        traj_io.save_trajectory_tum(path, self.tracker.relative_poses, self.store)

    def save_keyframe_trajectory_tum(self, path):
        traj_io.save_keyframe_trajectory_tum(path, self.store)

    def save_trajectory_kitti(self, path):
        traj_io.save_trajectory_kitti(path, self.tracker.relative_poses, self.store)

    def save_tracking_log(self, path):
        """Reference: System::SaveTrackingLog (System.cc:501)."""
        import json

        with open(path, "w") as f:
            for st in self.tracker.stats:
                f.write(json.dumps(st.__dict__) + "\n")

    def save_loop_log(self, path):
        """Per-KF loop-closing log (detection/sim3/correction stats)."""
        import json

        with open(path, "w") as f:
            if self.loop_closer is not None:
                for st in self.loop_closer.stats:
                    f.write(json.dumps(st.__dict__) + "\n")

    def save_mapping_log(self, path):
        """Reference: System::SaveMappingLog (System.cc:542) — per-KF BA
        stage log (MappingLog Util.hpp:282)."""
        import json

        with open(path, "w") as f:
            for st in self.mapper.stats:
                f.write(json.dumps(st.__dict__) + "\n")
