"""Essential-graph Sim3 pose-graph optimization.

JAX replacement for Optimizer::OptimizeEssentialGraph (reference:
src/Optimizer.cc:2338 — g2o BlockSolver_7_3 LM over Sim3 vertices with
edges from the spanning tree, strong-covisibility (≥100) links, and loop
edges; scale fixed for stereo/RGB-D). Design:

- vertices: [K] Sim3 as (s, R, t) SoA; update S ← exp(δ)∘S, δ∈ℝ⁷;
- edges: [E] index pairs + measured relative Sim3 (S_ij = S_i·S_j⁻¹ at
  graph-build time, loop edges carry the Sim3-solver estimate);
- residual r_e = log_sim3(S_meas_ij ∘ S_j ∘ S_i⁻¹) ∈ ℝ⁷, Jacobians via
  batched autodiff (vmap·jacfwd over the 14 dof of the edge);
- one dense [7K,7K] normal-equation solve per iteration (K ≤ a few hundred →
  trivially small), Tikhonov-damped GN with step acceptance.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam2_tpu.geometry import lie
from gf_orb_slam2_tpu.utils.precision import einsum


class PoseGraphProblem(NamedTuple):
    s: jnp.ndarray         # [K] scales
    R: jnp.ndarray         # [K,3,3]
    t: jnp.ndarray         # [K,3]
    fixed: jnp.ndarray     # [K] bool
    valid: jnp.ndarray     # [K] bool
    e_i: jnp.ndarray       # [E] int32
    e_j: jnp.ndarray       # [E] int32
    e_s: jnp.ndarray       # [E] measured relative scale
    e_R: jnp.ndarray       # [E,3,3]
    e_t: jnp.ndarray       # [E,3]
    e_w: jnp.ndarray       # [E] weight (0 = padding)
    fix_scale: bool = True


def _edge_residual(si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """log( S_meas ∘ S_j ∘ S_i⁻¹ )."""
    s_inv, R_inv, t_inv = lie.sim3_inv(si, Ri, ti)
    s1, R1, t1 = lie.sim3_compose(sj, Rj, tj, s_inv, R_inv, t_inv)
    s2, R2, t2 = lie.sim3_compose(sm, Rm, tm, s1, R1, t1)
    return lie.sim3_log(s2, R2, t2)


def _edge_residual_delta(delta, si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """Residual after applying perturbations δi, δj (= delta[:7], delta[7:])."""
    di, dj = delta[:7], delta[7:]
    dsi, dRi, dti = lie.sim3_exp(di)
    dsj, dRj, dtj = lie.sim3_exp(dj)
    si2, Ri2, ti2 = lie.sim3_compose(dsi, dRi, dti, si, Ri, ti)
    sj2, Rj2, tj2 = lie.sim3_compose(dsj, dRj, dtj, sj, Rj, tj)
    return _edge_residual(si2, Ri2, ti2, sj2, Rj2, tj2, sm, Rm, tm)


_JIT_CACHE = {}


def _get_jit(K: int, E: int, fs: bool, iters: int, damping: float):
    key = (K, E, fs, iters, float(damping))
    fn = _JIT_CACHE.get(key)
    if fn is None:
        def run(s, R, t, fixed, valid, e_i, e_j, e_s, e_R, e_t, e_w):
            p = PoseGraphProblem(s, R, t, fixed, valid,
                                 e_i, e_j, e_s, e_R, e_t, e_w, fs)
            return _optimize_pose_graph_impl(p, iters, damping)

        fn = _JIT_CACHE[key] = jax.jit(run)
    return fn


def optimize_pose_graph(
    prob: PoseGraphProblem, iters: int = 15, damping: float = 1e-6,
):
    """Jitted entry (cached per shape): callers bucket K/E so steady state
    reuses one compiled program instead of compiling per loop event."""
    fn = _get_jit(prob.s.shape[0], prob.e_i.shape[0], bool(prob.fix_scale),
                  iters, damping)
    return fn(prob.s, prob.R, prob.t, prob.fixed, prob.valid, prob.e_i,
              prob.e_j, prob.e_s, prob.e_R, prob.e_t, prob.e_w)


def pose_graph_programs(shapes, fix_scale: bool, iters: int = 15,
                        damping: float = 1e-6):
    """[(name, jitted fn, arg specs)] for the bucketed pose-graph programs,
    `shapes` = [(K_pad, E_pad), ...] — compiled ahead by the loop closer's
    prewarm so the FIRST loop event never compiles mid-sequence."""
    spec = jax.ShapeDtypeStruct
    f32, i32, b8 = jnp.float32, jnp.int32, jnp.bool_
    return [
        (f"pose_graph_{K}x{E}", _get_jit(K, E, bool(fix_scale), iters, damping),
         (spec((K,), f32), spec((K, 3, 3), f32), spec((K, 3), f32),
          spec((K,), b8), spec((K,), b8),
          spec((E,), i32), spec((E,), i32), spec((E,), f32),
          spec((E, 3, 3), f32), spec((E, 3), f32), spec((E,), f32)))
        for K, E in shapes
    ]


def _optimize_pose_graph_impl(
    prob: PoseGraphProblem, iters: int = 15, damping: float = 1e-6,
):
    """Returns (s, R, t) optimized. Vertices with fixed/invalid are pinned."""
    K = prob.s.shape[0]
    n = 7 * K

    jac_fn = jax.vmap(
        jax.jacfwd(_edge_residual_delta),
        in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    )
    res_fn = jax.vmap(_edge_residual)

    free = prob.valid & ~prob.fixed
    dof_mask = jnp.repeat(free, 7).astype(prob.s.dtype)
    if prob.fix_scale:
        # zero the scale dof (index 6 of each 7-block)
        scale_sel = (jnp.arange(n) % 7) == 6
        dof_mask = dof_mask * (~scale_sel).astype(prob.s.dtype)

    def total_cost(s, R, t):
        r = res_fn(
            s[prob.e_i], R[prob.e_i], t[prob.e_i],
            s[prob.e_j], R[prob.e_j], t[prob.e_j],
            prob.e_s, prob.e_R, prob.e_t,
        )
        return jnp.sum(prob.e_w * jnp.sum(r * r, -1))

    def gn_iter(carry, _):
        s, R, t, lam, cost = carry
        zeros = jnp.zeros((prob.e_i.shape[0], 14), s.dtype)
        r = res_fn(
            s[prob.e_i], R[prob.e_i], t[prob.e_i],
            s[prob.e_j], R[prob.e_j], t[prob.e_j],
            prob.e_s, prob.e_R, prob.e_t,
        )  # [E,7]
        J = jac_fn(
            zeros,
            s[prob.e_i], R[prob.e_i], t[prob.e_i],
            s[prob.e_j], R[prob.e_j], t[prob.e_j],
            prob.e_s, prob.e_R, prob.e_t,
        )  # [E,7,14]
        Ji = J[..., :7]
        Jj = J[..., 7:]
        w = prob.e_w
        # dense assembly via scatter-add of 7x7 blocks
        H = jnp.zeros((K, 7, K, 7), s.dtype)
        b = jnp.zeros((K, 7), s.dtype)
        Hii = einsum("e,era,erb->eab", w, Ji, Ji)
        Hjj = einsum("e,era,erb->eab", w, Jj, Jj)
        Hij = einsum("e,era,erb->eab", w, Ji, Jj)
        bi = einsum("e,era,er->ea", w, Ji, r)
        bj = einsum("e,era,er->ea", w, Jj, r)
        H = H.at[prob.e_i, :, prob.e_i, :].add(Hii)
        H = H.at[prob.e_j, :, prob.e_j, :].add(Hjj)
        H = H.at[prob.e_i, :, prob.e_j, :].add(Hij)
        H = H.at[prob.e_j, :, prob.e_i, :].add(jnp.swapaxes(Hij, -1, -2))
        b = b.at[prob.e_i].add(bi)
        b = b.at[prob.e_j].add(bj)
        Hm = H.reshape(n, n) * dof_mask[:, None] * dof_mask[None, :]
        Hm = Hm + jnp.diag(jnp.where(dof_mask > 0, damping + lam * (1.0 + jnp.diag(H.reshape(n, n))), 1.0))
        bm = b.reshape(n) * dof_mask
        delta = -jnp.linalg.solve(Hm, bm).reshape(K, 7) * dof_mask.reshape(K, 7)
        ds, dR, dt = lie.sim3_exp(delta)
        s_new, R_new, t_new = lie.sim3_compose(ds, dR, dt, s, R, t)
        cost_new = total_cost(s_new, R_new, t_new)
        # explicit finiteness guard: a singular Hm makes the solve emit
        # inf/NaN, and a NaN candidate must never be accepted (same failure
        # class as local_ba's cholesky-NaN step — see local_ba.py:254)
        finite = jnp.isfinite(delta).all() & jnp.isfinite(cost_new)
        accept = (cost_new < cost) & finite
        s = jnp.where(accept, s_new, s)
        R = jnp.where(accept, R_new, R)
        t = jnp.where(accept, t_new, t)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        return (s, R, t, lam, cost), None

    cost0 = total_cost(prob.s, prob.R, prob.t)
    (s, R, t, lam, cost), _ = jax.lax.scan(
        gn_iter, (prob.s, prob.R, prob.t, jnp.float32(1e-4), cost0), None, length=iters
    )
    return s, R, t, cost
