"""Flat uint32 packing of fixed-shape pytrees for single-buffer transfers.

Packing the per-frame upload and the per-frame fetch into ONE uint32 buffer
collapses 16-20 per-leaf `device_put`/`device_get` transactions into one.

A `Layout` is an ordered spec of (name, shape, dtype) with static offsets.
Host side packs/unpacks with numpy views (zero-copy where possible); device
side uses slices + bitcasts that XLA fuses into the producing/consuming
programs.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_U32_OK = {"float32", "int32", "uint32"}


class Layout:
    def __init__(self, fields: Sequence[Tuple[str, Tuple[int, ...], str]]):
        """fields: (name, shape, dtype-name); dtype in f32/i32/u32/bool."""
        self.fields: List[Tuple[str, Tuple[int, ...], str]] = []
        self.offsets: Dict[str, int] = {}
        off = 0
        for name, shape, dt in fields:
            shape = tuple(int(x) for x in shape)
            n = int(np.prod(shape)) if shape else 1
            self.fields.append((name, shape, dt))
            self.offsets[name] = off
            off += n
        self.total = off

    # ------------------------------------------------------------- host side
    def pack_np(self, values: Dict[str, np.ndarray]) -> np.ndarray:
        out = np.empty(self.total, np.uint32)
        for name, shape, dt in self.fields:
            v = np.ascontiguousarray(values[name])
            o = self.offsets[name]
            n = int(np.prod(shape)) if shape else 1
            if dt == "bool":
                out[o : o + n] = v.astype(np.uint32).reshape(-1)
            else:
                out[o : o + n] = v.reshape(-1).view(np.uint32)
        return out

    def unpack_np(self, buf: np.ndarray) -> Dict[str, np.ndarray]:
        out = {}
        for name, shape, dt in self.fields:
            o = self.offsets[name]
            n = int(np.prod(shape)) if shape else 1
            raw = buf[o : o + n]
            if dt == "bool":
                v = raw.astype(bool)
            elif dt == "f32":
                v = raw.view(np.float32)
            elif dt == "i32":
                v = raw.view(np.int32)
            else:
                v = raw
            out[name] = v.reshape(shape) if shape else v[0]
        return out

    # ----------------------------------------------------------- device side
    def pack_jnp(self, values: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        parts = []
        for name, shape, dt in self.fields:
            v = values[name]
            if dt == "bool":
                p = v.astype(jnp.uint32)
            elif dt == "f32":
                p = jax.lax.bitcast_convert_type(v.astype(jnp.float32), jnp.uint32)
            elif dt == "i32":
                p = jax.lax.bitcast_convert_type(v.astype(jnp.int32), jnp.uint32)
            else:
                p = v.astype(jnp.uint32)
            parts.append(p.reshape(-1))
        return jnp.concatenate(parts)

    def unpack_jnp(self, buf: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        out = {}
        for name, shape, dt in self.fields:
            o = self.offsets[name]
            n = int(np.prod(shape)) if shape else 1
            raw = jax.lax.dynamic_slice_in_dim(buf, o, n)
            if dt == "bool":
                v = raw != 0
            elif dt == "f32":
                v = jax.lax.bitcast_convert_type(raw, jnp.float32)
            elif dt == "i32":
                v = jax.lax.bitcast_convert_type(raw, jnp.int32)
            else:
                v = raw
            out[name] = v.reshape(shape) if shape else v.reshape(())
        return out


def _dt_name(dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return "bool"
    if dtype == np.float32:
        return "f32"
    if dtype in (np.int32, np.int64):
        return "i32"
    if dtype in (np.uint32, np.uint8):
        return "u32"
    raise TypeError(f"unsupported packing dtype {dtype}")


def _coerce(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v)
    if v.dtype == np.int64:
        return v.astype(np.int32)
    if v.dtype == np.uint8:
        return v.astype(np.uint32)
    if v.dtype == np.float64:
        return v.astype(np.float32)
    return v


class PackedFn:
    """Wrap `fn(dict[str, jnp.ndarray]) -> dict[str, jnp.ndarray]` into a
    single-uint32-buffer-in / single-uint32-buffer-out jitted call.

    This collapses a many-array device call into exactly one upload and one
    fetch. Layouts
    are derived from the first call's shapes and cached per signature.
    """

    def __init__(self, fn):
        self.fn = fn
        self._cache = {}

    def _build(self, sig, arrays):
        in_layout = Layout([(k, arrays[k].shape, _dt_name(arrays[k].dtype))
                            for k in sorted(arrays)])
        holder = {}

        def wrapped(buf):
            vals = in_layout.unpack_jnp(buf)
            out = self.fn(vals)
            out_layout = Layout([
                (k, tuple(out[k].shape), _dt_name(out[k].dtype))
                for k in sorted(out)
            ])
            holder["out"] = out_layout
            return out_layout.pack_jnp(out)

        jitted = jax.jit(wrapped)
        self._cache[sig] = (in_layout, holder, jitted)
        return self._cache[sig]

    def dispatch(self, **arrays):
        """Pack + upload + dispatch; returns a handle for `fetch`."""
        arrays = {k: _coerce(v) for k, v in arrays.items()}
        sig = tuple(sorted((k, v.shape, str(v.dtype)) for k, v in arrays.items()))
        if sig not in self._cache:
            self._build(sig, arrays)
        in_layout, holder, jitted = self._cache[sig]
        buf = jax.device_put(in_layout.pack_np(arrays))
        out_buf = jitted(buf)
        return (out_buf, holder)

    def fetch(self, handle):
        out_buf, holder = handle
        return holder["out"].unpack_np(np.asarray(jax.device_get(out_buf)))

    def __call__(self, **arrays):
        """Blocking pack→run→unpack."""
        return self.fetch(self.dispatch(**arrays))
