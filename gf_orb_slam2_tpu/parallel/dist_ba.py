"""Distributed bundle adjustment: point-sharded Schur reduction over a mesh.

NEW capability with no reference counterpart (the reference is single-
process; SURVEY.md §2.3 row '—'): scale BA beyond one chip by sharding map
points (and their observation tables) across devices. Per LM iteration:

  each device: residuals/Jacobians for ITS point shard → local Hpp, bp,
  point-block inverses, T·Hll⁻¹·Tᵀ Schur contributions
  → `psum` over the mesh builds the global reduced camera system S [6K,6K]
  → every device solves the (replicated, tiny) S and back-substitutes ITS
  points locally. No point data ever crosses chips — only [6K,6K]+[6K]
  per iteration (~150 KB at K=64), so weak scaling is communication-light.

Built with shard_map over a 1-D Mesh; the same code runs on a virtual CPU
mesh (tests / multi-device dry run) and on the GPUs of one host.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gf_orb_slam2_tpu.geometry import lie
from gf_orb_slam2_tpu.optim.local_ba import LocalBAProblem, _residuals, _chi2
from gf_orb_slam2_tpu.utils.precision import einsum, matmul

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = 2.4477
HUBER_STEREO = 2.7955


def _mesh_axis(mesh: Mesh) -> str:
    """The mesh's one axis — point-major arrays shard over it."""
    if len(mesh.axis_names) != 1:
        raise ValueError(f"distributed BA needs a 1-D mesh, got "
                         f"{mesh.axis_names}")
    return mesh.axis_names[0]


def build_distributed_ba_step(mesh: Mesh, fx, fy, cx, cy, bf, damping=1e-4,
                              ablate_collectives: bool = False):
    """Returns a jitted function performing `iters` LM iterations of
    point-sharded BA. Point-major arrays must be sharded over the mesh
    (leading dim divisible by mesh size); KF arrays are replicated."""

    axes = _mesh_axis(mesh)
    point_spec = P(axes)
    rep = P()
    # ablation harness (SCALING.md): identical per-device compute with the
    # cross-device reductions REMOVED — separates collective cost from host
    # oversubscription on the virtual CPU mesh. Numerically wrong; timing-only.
    psum = (lambda x, a: x) if ablate_collectives else jax.lax.psum

    def shard_body(kf_R, kf_t, kf_fixed, kf_valid,
                   pt_pos, pt_valid, obs_kf, obs_uv, obs_ur, obs_inv2, obs_valid,
                   lam):
        K = kf_R.shape[0]
        prob = LocalBAProblem(
            kf_R, kf_t, kf_fixed, kf_valid, pt_pos, pt_valid,
            obs_kf, obs_uv, obs_ur, obs_inv2, obs_valid,
        )
        is_stereo = obs_ur >= 0
        delta = jnp.where(is_stereo, HUBER_STEREO, HUBER_MONO)
        onehot = jax.nn.one_hot(obs_kf, K, dtype=kf_R.dtype)
        opt_mask = (~kf_fixed) & kf_valid

        r, J_pose, J_pt, depth = _residuals(prob, kf_R, kf_t, pt_pos, fx, fy, cx, cy, bf)
        c2 = _chi2(r, obs_inv2, is_stereo)
        e = jnp.sqrt(jnp.maximum(c2, 1e-12))
        w_huber = jnp.where(e <= delta, 1.0, delta / e)
        active = obs_valid & (obs_kf >= 0) & pt_valid[:, None] & (depth > 1e-4)
        w = obs_inv2 * w_huber * active.astype(r.dtype)
        pose_on = opt_mask[jnp.maximum(obs_kf, 0)]
        Jp = J_pose * pose_on[..., None, None].astype(r.dtype)

        wJp = w[..., None, None] * Jp
        M = einsum("poab,poac->pobc", wJp, Jp)
        Hpp_loc = einsum("pok,pobc->kbc", onehot, M)
        vb = einsum("poab,poa->pob", wJp, r)
        bp_loc = einsum("pok,pob->kb", onehot, vb)
        wJl = w[..., None, None] * J_pt
        Hll = einsum("poab,poac->pbc", wJl, J_pt)
        bl = einsum("poab,poa->pb", wJl, r)
        C = einsum("poab,poac->pobc", wJp, J_pt)
        T1 = einsum("pok,pobc->pkbc", onehot, C)
        lamHll = Hll + (damping + lam) * jnp.eye(3, dtype=Hll.dtype) * (
            1.0 + einsum("pii->p", Hll)[:, None, None] / 3.0
        )
        from gf_orb_slam2_tpu.utils.linalg3 import inv3

        Vinv = inv3(lamHll) * pt_valid[:, None, None]
        T1V = einsum("pkab,pbc->pkac", T1, Vinv)
        S_cross_loc = einsum("pkac,pmdc->kmad", T1V, T1)
        bs_corr_loc = einsum("pkac,pc->ka", T1V, bl)

        # ---- THE collective: reduce the camera system over the mesh
        Hpp = psum(Hpp_loc, axes)
        bp = psum(bp_loc, axes)
        S_cross = psum(S_cross_loc, axes)
        bs_corr = psum(bs_corr_loc, axes)

        D6 = jnp.eye(6, dtype=Hpp.dtype)[None] * (
            damping + lam + einsum("kii->k", Hpp)[:, None, None] / 6.0 * lam
        )
        S_blocks = -S_cross
        S_blocks = S_blocks.at[jnp.arange(K), jnp.arange(K)].add(Hpp + D6)
        S = S_blocks.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
        bs = (bp - bs_corr).reshape(-1)
        act6 = jnp.repeat(opt_mask, 6)
        S = jnp.where(act6[:, None] & act6[None, :], S, 0.0)
        S = S + jnp.diag(jnp.where(act6, 0.0, 1.0))
        bs = jnp.where(act6, bs, 0.0)
        xi_p = -jnp.linalg.solve(S, bs).reshape(K, 6)
        rhs_l = bl + einsum("pkab,ka->pb", T1, xi_p)
        dx = -einsum("pbc,pc->pb", Vinv, rhs_l)

        dR, dt = lie.se3_exp(xi_p)
        kf_R_new, kf_t_new = lie.se3_compose(dR, dt, kf_R, kf_t)
        pt_new = pt_pos + dx * pt_valid[:, None]
        # global robust cost for accept/reject (psum over shards)
        def cost_of(Rk, tk, pts):
            rr, _, _, dd = _residuals(prob, Rk, tk, pts, fx, fy, cx, cy, bf)
            cc = _chi2(rr, obs_inv2, is_stereo)
            ee = jnp.sqrt(jnp.maximum(cc, 1e-12))
            rho = jnp.where(ee <= delta, cc, 2.0 * delta * ee - delta * delta)
            return psum(jnp.sum(jnp.where(active, rho, 0.0)), axes)

        cost_old = cost_of(kf_R, kf_t, pt_pos)
        cost_new = cost_of(kf_R_new, kf_t_new, pt_new)
        accept = cost_new < cost_old
        kf_R = jnp.where(accept, kf_R_new, kf_R)
        kf_t = jnp.where(accept, kf_t_new, kf_t)
        pt_pos = jnp.where(accept, pt_new, pt_pos)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e6)
        return kf_R, kf_t, pt_pos, lam, cost_new

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep,
                  point_spec, point_spec, point_spec, point_spec, point_spec,
                  point_spec, point_spec, rep),
        out_specs=(rep, rep, point_spec, rep, rep),
        check_vma=False,
    )

    @jax.jit
    def step(kf_R, kf_t, kf_fixed, kf_valid,
             pt_pos, pt_valid, obs_kf, obs_uv, obs_ur, obs_inv2, obs_valid, lam):
        return sharded(kf_R, kf_t, kf_fixed, kf_valid,
                       pt_pos, pt_valid, obs_kf, obs_uv, obs_ur, obs_inv2,
                       obs_valid, lam)

    return step


def build_pcg_ba_step(mesh: Mesh, fx, fy, cx, cy, bf, damping=1e-4,
                      pcg_iters: int = 48):
    """KF-SHARDED distributed BA step: points sharded as in
    build_distributed_ba_step, but the reduced camera system is never
    replicated — `psum_scatter` hands each device a ROW BLOCK of S
    [K/D, K, 6, 6], and the pose update solves S x = b with preconditioned
    conjugate gradients whose matvec all-gathers only the [K,6] iterate.
    Per-device memory for the camera system drops D-fold, so K scales with
    the mesh instead of capping at what one chip can factor (the round-1
    limitation called out in VERDICT §6).

    Collective budget per LM iteration: one psum_scatter of [K,K,6,6]/D +
    pcg_iters × all_gather([K,6]).
    """
    axes = _mesh_axis(mesh)
    point_spec = P(axes)
    rep = P()
    n_scatter = mesh.shape[axes]

    def shard_body(kf_R, kf_t, kf_fixed, kf_valid,
                   pt_pos, pt_valid, obs_kf, obs_uv, obs_ur, obs_inv2,
                   obs_valid, lam):
        K = kf_R.shape[0]
        prob = LocalBAProblem(
            kf_R, kf_t, kf_fixed, kf_valid, pt_pos, pt_valid,
            obs_kf, obs_uv, obs_ur, obs_inv2, obs_valid,
        )
        is_stereo = obs_ur >= 0
        delta = jnp.where(is_stereo, HUBER_STEREO, HUBER_MONO)
        onehot = jax.nn.one_hot(obs_kf, K, dtype=kf_R.dtype)
        opt_mask = (~kf_fixed) & kf_valid

        r, J_pose, J_pt, depth = _residuals(prob, kf_R, kf_t, pt_pos, fx, fy, cx, cy, bf)
        c2 = _chi2(r, obs_inv2, is_stereo)
        e = jnp.sqrt(jnp.maximum(c2, 1e-12))
        w_huber = jnp.where(e <= delta, 1.0, delta / e)
        active = obs_valid & (obs_kf >= 0) & pt_valid[:, None] & (depth > 1e-4)
        w = obs_inv2 * w_huber * active.astype(r.dtype)
        pose_on = opt_mask[jnp.maximum(obs_kf, 0)]
        Jp = J_pose * pose_on[..., None, None].astype(r.dtype)

        wJp = w[..., None, None] * Jp
        M = einsum("poab,poac->pobc", wJp, Jp)
        Hpp_loc = einsum("pok,pobc->kbc", onehot, M)
        vb = einsum("poab,poa->pob", wJp, r)
        bp_loc = einsum("pok,pob->kb", onehot, vb)
        wJl = w[..., None, None] * J_pt
        Hll = einsum("poab,poac->pbc", wJl, J_pt)
        bl = einsum("poab,poa->pb", wJl, r)
        C = einsum("poab,poac->pobc", wJp, J_pt)
        T1 = einsum("pok,pobc->pkbc", onehot, C)
        lamHll = Hll + (damping + lam) * jnp.eye(3, dtype=Hll.dtype) * (
            1.0 + einsum("pii->p", Hll)[:, None, None] / 3.0
        )
        from gf_orb_slam2_tpu.utils.linalg3 import inv3

        Vinv = inv3(lamHll) * pt_valid[:, None, None]
        T1V = einsum("pkab,pbc->pkac", T1, Vinv)
        S_cross_loc = einsum("pkac,pmdc->kmad", T1V, T1)
        bs_corr_loc = einsum("pkac,pc->ka", T1V, bl)

        # small replicated pieces (diagonal + rhs) by psum; the O(K²) body
        # by reduce-scatter → each device owns rows [K/D, K, 6, 6]
        Hpp = jax.lax.psum(Hpp_loc, axes)
        bp = jax.lax.psum(bp_loc, axes)
        bs_corr = jax.lax.psum(bs_corr_loc, axes)
        # camera-system rows: reduce-scatter — each device owns a row block
        S_rows = jax.lax.psum_scatter(
            -S_cross_loc, axes, scatter_dimension=0, tiled=True)
        Kb = K // n_scatter
        idx = jax.lax.axis_index(axes)
        row_ids = idx * Kb + jnp.arange(Kb)
        D6 = jnp.eye(6, dtype=Hpp.dtype)[None] * (
            damping + lam + einsum("kii->k", Hpp)[:, None, None] / 6.0 * lam
        )
        diag_blocks = Hpp + D6                       # [K,6,6] replicated
        S_rows = S_rows.at[jnp.arange(Kb), row_ids].add(diag_blocks[row_ids])
        act = opt_mask
        # inactive poses: identity rows (consistent with the dense variant)
        S_rows = S_rows * (act[row_ids][:, None, None, None]
                           & act[None, :, None, None])
        S_rows = S_rows.at[jnp.arange(Kb), row_ids].add(
            jnp.eye(6, dtype=Hpp.dtype)[None]
            * (~act[row_ids])[:, None, None])
        b = (bp - bs_corr) * act[:, None]            # [K,6] replicated

        # block-Jacobi preconditioner from the replicated diagonal
        Pre = inv3_6(diag_blocks, act)

        def matvec(x):                               # x [K,6] replicated
            y_loc = einsum("rkab,kb->ra", S_rows, x)  # my rows
            return jax.lax.all_gather(
                y_loc, axes, axis=0, tiled=True)   # [K,6]

        def pcg(b):
            x = jnp.zeros_like(b)
            rr = b - matvec(x)
            z = einsum("kab,kb->ka", Pre, rr)
            p = z
            rz = jnp.sum(rr * z)

            def body(_, st):
                x, rr, p, rz = st
                Ap = matvec(p)
                alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-20)
                x = x + alpha * p
                rr = rr - alpha * Ap
                z = einsum("kab,kb->ka", Pre, rr)
                rz_new = jnp.sum(rr * z)
                beta = rz_new / jnp.maximum(rz, 1e-20)
                p = z + beta * p
                return (x, rr, p, rz_new)

            x, _, _, _ = jax.lax.fori_loop(0, pcg_iters, body, (x, rr, p, rz))
            return x

        xi_p = -pcg(b)                               # xi = -S⁻¹ b
        xi_p = xi_p * act[:, None]
        rhs_l = bl + einsum("pkab,ka->pb", T1, xi_p)
        dx = -einsum("pbc,pc->pb", Vinv, rhs_l)

        dR, dt = lie.se3_exp(xi_p)
        kf_R_new, kf_t_new = lie.se3_compose(dR, dt, kf_R, kf_t)
        pt_new = pt_pos + dx * pt_valid[:, None]

        def cost_of(Rk, tk, pts):
            rr2, _, _, _ = _residuals(prob, Rk, tk, pts, fx, fy, cx, cy, bf)
            cc = _chi2(rr2, obs_inv2, is_stereo)
            ee = jnp.sqrt(jnp.maximum(cc, 1e-12))
            rho = jnp.where(ee <= delta, cc, 2.0 * delta * ee - delta * delta)
            return jax.lax.psum(jnp.sum(jnp.where(active, rho, 0.0)), axes)

        cost_old = cost_of(kf_R, kf_t, pt_pos)
        cost_new = cost_of(kf_R_new, kf_t_new, pt_new)
        accept = cost_new < cost_old
        kf_R = jnp.where(accept, kf_R_new, kf_R)
        kf_t = jnp.where(accept, kf_t_new, kf_t)
        pt_pos = jnp.where(accept, pt_new, pt_pos)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e6)
        return kf_R, kf_t, pt_pos, lam, jnp.minimum(cost_new, cost_old)

    def inv3_6(blocks, act):
        """Inverse of SPD 6x6 blocks via two-level Schur on 3x3 corners
        (closed form — no LAPACK; utils/linalg3.py)."""
        from gf_orb_slam2_tpu.utils.linalg3 import inv3 as i3

        A = blocks[..., :3, :3]
        B = blocks[..., :3, 3:]
        Ct = blocks[..., 3:, :3]
        Dm = blocks[..., 3:, 3:]
        Ai = i3(A)
        AiB = matmul(Ai, B)
        CtAi = matmul(Ct, Ai)
        Sc = Dm - matmul(Ct, AiB)
        Sci = i3(Sc)
        TL = Ai + matmul(matmul(AiB, Sci), CtAi)
        TR = -matmul(AiB, Sci)
        BL = -matmul(Sci, CtAi)
        out = jnp.concatenate([
            jnp.concatenate([TL, TR], -1),
            jnp.concatenate([BL, Sci], -1),
        ], -2)
        return out * act[:, None, None]

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep,
                  point_spec, point_spec, point_spec, point_spec, point_spec,
                  point_spec, point_spec, rep),
        out_specs=(rep, rep, point_spec, rep, rep),
        check_vma=False,
    )
    return jax.jit(sharded)


def distributed_ba(mesh, prob: LocalBAProblem, fx, fy, cx, cy, bf, iters=10,
                   kf_sharded: bool = False, ablate_collectives: bool = False):
    """Run `iters` distributed LM iterations on a 1-D mesh. Arrays are placed
    with the right shardings; returns updated (kf_R, kf_t, pt_pos, cost).
    kf_sharded=True uses the reduce-scatter + PCG camera solve (K must be
    divisible by the mesh size)."""
    step = (build_pcg_ba_step(mesh, fx, fy, cx, cy, bf) if kf_sharded
            else build_distributed_ba_step(
                mesh, fx, fy, cx, cy, bf,
                ablate_collectives=ablate_collectives))
    point_sharding = NamedSharding(mesh, P(_mesh_axis(mesh)))
    rep_sharding = NamedSharding(mesh, P())
    kf_R = jax.device_put(prob.kf_R, rep_sharding)
    kf_t = jax.device_put(prob.kf_t, rep_sharding)
    kf_fixed = jax.device_put(prob.kf_fixed, rep_sharding)
    kf_valid = jax.device_put(prob.kf_valid, rep_sharding)
    pt_pos = jax.device_put(prob.pt_pos, point_sharding)
    pt_valid = jax.device_put(prob.pt_valid, point_sharding)
    obs_kf = jax.device_put(prob.obs_kf, point_sharding)
    obs_uv = jax.device_put(prob.obs_uv, point_sharding)
    obs_ur = jax.device_put(prob.obs_ur, point_sharding)
    obs_inv2 = jax.device_put(prob.obs_inv_sigma2, point_sharding)
    obs_valid = jax.device_put(prob.obs_valid, point_sharding)
    lam = jnp.float32(1e-4)
    cost = jnp.float32(0.0)
    for _ in range(iters):
        kf_R, kf_t, pt_pos, lam, cost = step(
            kf_R, kf_t, kf_fixed, kf_valid, pt_pos, pt_valid,
            obs_kf, obs_uv, obs_ur, obs_inv2, obs_valid, lam,
        )
    return kf_R, kf_t, pt_pos, cost
