"""Multi-index hashing of the local map — ctypes binding + OTS controller.

JAX-side replacement for MultiIndexHashing (reference: src/Hashing.cc,
include/Hashing.h — 32 tables × 256 buckets over 256-bit descriptors,
bounded buckets of 20, NUM_ACTIVE_HASHTABLES=8 with online table selection
and a latency feedback controller `updateDynamics` against the
MAX_TRACK_LOCALMAP_TIME=20ms target, Hashing.h:74-79). The table machinery
is native C++ (native/mih.cpp, hash mutation is host work); candidates are
re-ranked on device by the Hamming matcher.

The wall-clock feedback controller becomes a candidate-count controller
(SURVEY.md §7.3: time budgets → count budgets): `update_dynamics` grows or
shrinks the per-query candidate budget toward `target_candidates`.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB = None


def _build_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(pkg, "native", "mih.cpp")
    build = os.path.join(os.path.dirname(pkg), "build")
    os.makedirs(build, exist_ok=True)
    lib_path = os.path.join(build, "libmih.so")
    if (not os.path.exists(lib_path)
            or os.path.getmtime(lib_path) < os.path.getmtime(src)):
        # build beside the target and rename: concurrent builders (test
        # workers) never load a half-written library
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        subprocess.check_call(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
        )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    lib.mih_create.restype = ctypes.c_void_p
    lib.mih_create.argtypes = [ctypes.c_int] * 3
    lib.mih_destroy.argtypes = [ctypes.c_void_p]
    lib.mih_clear.argtypes = [ctypes.c_void_p]
    lib.mih_insert.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.mih_erase.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.mih_query.restype = ctypes.c_int
    lib.mih_query.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.mih_table_sizes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    _LIB = lib
    return lib


def _u32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class MultiIndexHashing:
    def __init__(self, cfg, max_points: int):
        self.cfg = cfg
        self.max_points = max_points
        self._lib = _build_lib()
        self._h = self._lib.mih_create(
            cfg.n_tables, cfg.bits_per_substring, cfg.max_bucket_size
        )
        self.n_active = cfg.n_active_tables
        self.active_tables = np.arange(cfg.n_tables, dtype=np.int32)[: self.n_active]
        # candidate budget controller (replaces the 20ms time controller)
        self.candidate_budget = 2048
        # per-table retrieval-utility EMA (reference: per-point
        # mnQueriedScore/mvbActiveHashTables accumulated into table scores,
        # Tracking::UpdateQueryNumByHashTable Tracking.cc:3111)
        self.table_utility = np.zeros(cfg.n_tables, np.float64)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.mih_destroy(self._h)
        except Exception:
            pass

    def insert(self, desc: np.ndarray, ids: np.ndarray):
        desc = np.ascontiguousarray(desc, np.uint32)
        ids = np.ascontiguousarray(ids, np.int32)
        self._lib.mih_insert(self._h, _u32ptr(desc), _i32ptr(ids), len(ids))

    def erase(self, point_id: int):
        self._lib.mih_erase(self._h, int(point_id))

    def clear(self):
        self._lib.mih_clear(self._h)

    def query(self, desc: np.ndarray, max_out: Optional[int] = None) -> np.ndarray:
        """Candidate map-point ids for frame descriptors [N,8]."""
        self.n_queries = getattr(self, "n_queries", 0) + 1
        desc = np.ascontiguousarray(desc, np.uint32)
        max_out = max_out or self.candidate_budget
        out = np.empty(max_out, np.int32)
        seen = np.zeros(self.max_points, np.uint8)
        tbl = np.ascontiguousarray(self.active_tables, np.int32)
        n = self._lib.mih_query(
            self._h, _u32ptr(desc), len(desc), _i32ptr(tbl), len(tbl),
            _i32ptr(out), max_out,
            seen.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), self.max_points,
        )
        return out[:n]

    # ------------------------------------------------ online table selection
    def update_query_scores(self, kp_desc: np.ndarray, pt_desc: np.ndarray,
                            ema: float = 0.9):
        """Accumulate per-table retrieval utility from ACTUAL matches
        (reference: Tracking::UpdateQueryNumByHashTable Tracking.cc:3111 —
        tables that would have retrieved the matched landmarks score up).

        Table t retrieves point p for query q iff their t-th 8-bit substring
        agrees; with [M,8]-u32 descriptors that is a bytewise comparison —
        which only matches the native substring() extraction (mih.cpp) when
        bits_per_substring == 8, so other geometries skip the utility update
        (OTS then falls back to load-based table selection)."""
        if len(kp_desc) == 0 or self.cfg.bits_per_substring != 8:
            return
        qa = np.ascontiguousarray(kp_desc, np.uint32).view(np.uint8)
        pa = np.ascontiguousarray(pt_desc, np.uint32).view(np.uint8)
        hits = (qa == pa).reshape(len(kp_desc), -1)  # [M, 32] per-substring
        util = hits[:, : self.cfg.n_tables].sum(0).astype(np.float64)
        self.table_utility = ema * self.table_utility + (1.0 - ema) * util

    def update_table_selection(self):
        """Activate the `n_active` highest-utility tables; load (table size)
        breaks ties / drives the cold start (reference OTS:
        Tracking.cc:3111 + Hashing.h NUM_ACTIVE_HASHTABLES)."""
        sizes = np.empty(self.cfg.n_tables, np.int64)
        self._lib.mih_table_sizes(
            self._h, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        if self.table_utility.max() > 0:
            # utility first; prefer lighter tables among equals
            key = self.table_utility - 1e-9 * sizes
            self.active_tables = np.argsort(-key)[: self.n_active].astype(np.int32)
        else:
            self.active_tables = np.argsort(sizes)[: self.n_active].astype(np.int32)

    def update_dynamics(self, n_candidates_used: int, target: int = 2048):
        """Feedback controller on the candidate budget (reference:
        updateDynamics vs MAX_TRACK_LOCALMAP_TIME, Hashing.h:78)."""
        if n_candidates_used > target:
            self.candidate_budget = max(512, int(self.candidate_budget * 0.9))
        else:
            self.candidate_budget = min(8192, int(self.candidate_budget * 1.1))
