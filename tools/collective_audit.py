#!/usr/bin/env python
"""Audit the distributed-BA collectives per LM iteration.

Lowers both BA layouts on a virtual 1-D mesh of 4 devices (the cards of one
host) and parses the optimized HLO for collective ops (all-reduce /
reduce-scatter / all-gather), summing payload bytes per op kind. This is the
per-iteration traffic table for SCALING.md.

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python tools/collective_audit.py
"""
import os
import re
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "pred": 1, "f64": 8, "bf16": 2,
               "u8": 1, "s8": 1}

COLL_RE = re.compile(
    r"(\w+) = \S+ (all-reduce|reduce-scatter|all-gather|all-to-all)"
    r"(?:-start)?\(", re.I)
SHAPE_RE = re.compile(r"(f32|bf16|f64|s32|u32|pred|u8|s8)\[([\d,]*)\]")


def collective_table(hlo: str):
    """[(op, shape_bytes, groups)] from optimized HLO text. Handles tupled
    (variadic) collectives: `%x = (f32[..], f32[..]) all-reduce(...)`."""
    out = []
    op_re = re.compile(
        r"=\s*(.*?)\s*(all-reduce|reduce-scatter|all-gather)(?:-start)?\(")
    for line in hlo.splitlines():
        m = op_re.search(line)
        if m is None:
            continue
        op = m.group(2)
        nbytes = 0
        for sh in SHAPE_RE.finditer(m.group(1)):
            dims = [int(x) for x in sh.group(2).split(",") if x]
            nbytes += DTYPE_BYTES.get(sh.group(1), 4) * int(
                np.prod(dims or [1]))
        if nbytes == 0:
            continue
        g = re.search(r"replica_groups=\{(.+?)\}\}?,", line)
        groups = g.group(1) if g else "?"
        out.append((op, nbytes, groups))
    return out


def group_size(groups: str) -> int:
    """Number of devices in the first replica group."""
    first = re.search(r"\{([\d,]+)\}", "{" + groups + "}")
    return len(first.group(1).split(",")) if first else 0


def lower_and_audit(kf_sharded, mesh, prob, tag):
    from gf_orb_slam2_tpu.parallel.dist_ba import (
        build_distributed_ba_step, build_pcg_ba_step,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    fx = fy = 450.0
    if kf_sharded:
        step = build_pcg_ba_step(mesh, fx, fy, 320.0, 240.0, 45.0)
    else:
        step = build_distributed_ba_step(mesh, fx, fy, 320.0, 240.0, 45.0)
    psh = NamedSharding(mesh, P(mesh.axis_names[0]))
    rsh = NamedSharding(mesh, P())
    args = (
        jax.device_put(prob["kf_R"], rsh), jax.device_put(prob["kf_t"], rsh),
        jax.device_put(prob["kf_fixed"], rsh),
        jax.device_put(prob["kf_valid"], rsh),
        jax.device_put(prob["pt_pos"], psh),
        jax.device_put(prob["pt_valid"], psh),
        jax.device_put(prob["obs_kf"], psh),
        jax.device_put(prob["obs_uv"], psh),
        jax.device_put(prob["obs_ur"], psh),
        jax.device_put(prob["obs_inv2"], psh),
        jax.device_put(prob["obs_valid"], psh),
        jnp.float32(1e-4),
    )
    hlo = jax.jit(step).lower(*args).compile().as_text()
    rows = collective_table(hlo)
    per_axis = {}
    for op, nbytes, groups in rows:
        key = (f"group{group_size(groups)}", op)
        per_axis[key] = per_axis.get(key, (0, 0))
        per_axis[key] = (per_axis[key][0] + 1, per_axis[key][1] + nbytes)
    print(f"\n== {tag} (per LM iteration, per device) ==")
    for (ax, op), (n, b) in sorted(per_axis.items()):
        print(f"  {ax:10s} {op:15s} x{n:3d}  {b/1024:10.1f} KB")
    total = sum(b for _, b in per_axis.values())
    print(f"  {'TOTAL':10s} {'':15s}      {total/1024:10.1f} KB")
    return per_axis


def main():
    from gf_orb_slam2_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    K, P, O = 64, 32768, 6
    prob = dict(
        kf_R=np.broadcast_to(np.eye(3, dtype=np.float32), (K, 3, 3)).copy(),
        kf_t=np.zeros((K, 3), np.float32),
        kf_fixed=np.zeros(K, bool), kf_valid=np.ones(K, bool),
        pt_pos=rng.uniform(-5, 5, (P, 3)).astype(np.float32),
        pt_valid=np.ones(P, bool),
        obs_kf=rng.integers(0, K, (P, O)).astype(np.int32),
        obs_uv=rng.uniform(0, 640, (P, O, 2)).astype(np.float32),
        obs_ur=np.full((P, O), -1.0, np.float32),
        obs_inv2=np.ones((P, O), np.float32),
        obs_valid=np.ones((P, O), bool),
    )
    mesh = make_mesh(4)
    lower_and_audit(False, mesh, prob, "point-sharded, 4-device mesh")
    lower_and_audit(True, mesh, prob, "kf-sharded PCG, 4-device mesh")


if __name__ == "__main__":
    main()
