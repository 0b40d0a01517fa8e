"""Distributed Schur-complement + chain + Woodbury LM on the device mesh.

Round 3 closed the accuracy gap on victoriaPark with a single-device solver
(solvers/schur_pcg.py: exact landmark Schur elimination, global chain
tridiagonal by cyclic reduction, full landmark arrow via a Woodbury
correction — chi2 21,660 vs the float64 control's 22,573). This module puts
that exact machinery on the mesh, so scaling out no longer gives up the
optimum (VERDICT r3 Missing 1 / Next 1):

- **State stays partitioned** exactly as parallel/partitioned_pose_graph.py:
  pose blocks in trajectory order, landmarks owned by the most-observing
  block, ghost directories + O(boundary) halo exchanges (parallel/halo.py).
- **The chain preconditioner goes distributed via SPIKE**
  (parallel/spike.py): each device cyclic-reduction-factors its local block
  tridiagonal; the (D-1) boundary couplings form a replicated
  (2D*3)^2 interface system assembled with one psum. The distributed
  ``T^-1`` equals the single-device one exactly.
- **The landmark arrow stays exact**: the 2NL x 2NL Woodbury matrix
  ``K = A - V^T T^-1 V`` is psum-assembled from per-device dense V-slices
  (each device holds the rows of its OWN poses) and LU-factored replicated —
  landmarks are few (victoriaPark: 151), poses are many; this is the same
  small-dense/large-sharded split as Schur-complement bundle adjustment.

Per CG iteration the preconditioner is then **exactly** the single-device
``M = T - V A^-1 V^T`` (Woodbury), so convergence is iteration-for-iteration
identical; per-matvec communication stays O(ghosts) halo bytes plus O(D + NL)
replicated psum floats (interface rhs + arrow vector) — nothing O(N).

Reference parity target: the g2o+CHOLMOD backend accuracy
(``boss_map_building/map_g2o_reflector.h:50-74``) over the reference's map
partitions (``boss_map/map_utils.cpp:167``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..graph.store import PoseGraph2D
from ..solvers import pose_graph as pg
from ..solvers.pcg import pcg
from ..utils import lie
from .halo import halo_gather, halo_reduce
from .mesh import EDGE_AXIS
from .partitioned_pose_graph import (PartitionedSE2, comm_volume,
                                     partition_se2, partition_stats)
from .spike import spike_factor, spike_solve, spike_solve_bytes


def _damped_or_eye(Dblk, lam, free, d):
    """D + lam*diag(D) + 1e-10 I on free blocks, identity elsewhere —
    mirrors solvers/schur_pcg._damped_blocks so optima match exactly."""
    eye = jnp.eye(d, dtype=Dblk.dtype)
    diag = jnp.einsum("kii->ki", Dblk)
    Dd = Dblk + lam * jax.vmap(jnp.diag)(diag) + 1e-10 * eye
    return jnp.where(free[:, None, None] > 0, Dd, eye)


def optimize_se2_schur_partitioned(
    g: PoseGraph2D,
    mesh,
    iters: int = 100,
    cg_iters: int = 50,
    lm_lambda0: float = 1e-6,
    huber_delta: float | None = None,
    tol: float = 1e-9,
    cg_rtol: float = 1e-6,
    halo_mode: str = "auto",
):
    """LM to convergence on the landmark-eliminated system, fully sharded.

    Returns (graph, chi2_trace, stats). chi2_trace[-1] is the converged
    value; stats carries partition/communication accounting including the
    extra replicated psum floats this solver adds over the block-Jacobi one.
    """
    program, operands, part = schur_partitioned_program(
        g, mesh, iters, cg_iters, lm_lambda0, huber_delta, tol, cg_rtol,
        halo_mode)
    pb, lb, trace, cg_tot, lm_k_done = program(*operands)

    n_dev = mesh.devices.size
    NL = g.landmarks.shape[0]
    NP_full = g.poses.shape[0]
    poses_flat = np.asarray(pb).reshape(-1, 3)[:NP_full]
    if len(poses_flat) < NP_full:
        poses_flat = np.concatenate(
            [poses_flat, np.asarray(g.poses)[len(poses_flat):]], axis=0
        )
    lms = jnp.asarray(np.asarray(lb)[part.lm_owner, part.lm_local])
    g_out = g.with_poses(jnp.asarray(poses_flat), lms)

    cg_total = int(np.asarray(cg_tot))
    lm_iters = int(np.asarray(lm_k_done))
    stats = {
        "partition": partition_stats(part),
        "comm": comm_volume(part, lm_iters, cg_total),
        "cg_total": cg_total,
        "lm_iters": lm_iters,
        # replicated psum floats this solver adds beyond the halo bytes:
        # per CG iter: interface rhs (2D*3) [precond] + arrow w (2NL);
        # per LM iter: interface assembly (~(2D*3)^2), X interface rhs
        # (2D*3*2NL), K psum ((2NL)^2), A_diag (4NL)
        "spike_bytes_per_solve": spike_solve_bytes(n_dev, 3),
        "replicated_psum_floats_per_cg_iter": 2 * n_dev * 3 + 2 * NL,
        "replicated_psum_floats_per_lm_iter": (
            (2 * n_dev * 3) ** 2 + 2 * n_dev * 3 * 2 * NL
            + (2 * NL) ** 2 + 4 * NL
        ),
    }
    return g_out, trace, stats


def schur_partitioned_program(
    g: PoseGraph2D,
    mesh,
    iters: int = 100,
    cg_iters: int = 50,
    lm_lambda0: float = 1e-6,
    huber_delta: float | None = None,
    tol: float = 1e-9,
    cg_rtol: float = 1e-6,
    halo_mode: str = "auto",
):
    """The partitioned Schur LM as one jitted program, its operands and the
    partition: `program(*operands)` returns the per-device pose and
    landmark blocks, the chi2 trace and the CG and LM iteration counts."""
    n_dev = mesh.devices.size
    # The Woodbury arrow replicates a (2NL)^2 landmark matrix K and dense
    # per-device (B, 3, 2NL) V slices — the few-landmarks regime of graphs
    # like victoriaPark (NL=151) / world1000 (NL~600). Fail loudly instead
    # of silently exploding memory/compile time on landmark-rich graphs
    # (ADVICE r4); use the edge-sharded block-Jacobi path there.
    _nl = int(g.landmarks.shape[0])
    if _nl > 4096:
        raise ValueError(
            f"optimize_se2_schur_partitioned replicates a ({2 * _nl})^2 "
            "Woodbury arrow; NL > 4096 is out of its regime — use "
            "parallel.partitioned_pose_graph (block-Jacobi) instead"
        )
    part = partition_se2(g, n_dev, halo_mode=halo_mode)
    B = part.poses_blk.shape[1]
    G = part.ghost_ids.shape[1]
    BL = part.lms_blk.shape[1]
    GL = part.lm_ghost_ids.shape[1]
    NL = g.landmarks.shape[0]
    spec = part.halo
    spec_l = part.halo_l
    dtype = jnp.float32
    has_pl = part.pl_ij.shape[1] > 0 and NL > 0

    # free mask of the NEXT device's first pose (gauges the boundary
    # coupling); static host data — the fixed set does not change mid-solve
    free_next0 = np.zeros((n_dev, 1), np.float32)
    for s in range(n_dev - 1):
        free_next0[s, 0] = part.free_p_blk[s + 1, 0]
    # replicated landmark validity (identity rows of the global arrow A)
    lm_free_global = np.asarray(g.landmark_mask, np.float32)[:NL]

    shard = P(EDGE_AXIS)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(shard,) * 20 + (P(),),
        out_specs=(shard, shard, P(), P(), P()),
    )
    def run(poses_blk, free_p_blk, free_next0, h_send, h_recv, hl_send,
            hl_recv, pp_ij, pp_meas, pp_info, pp_mask, pp_chain, pp_bnd,
            pl_ij, pl_meas, pl_info, pl_mask, lms_blk0, free_l_blk, lm_gid,
            lm_free):
        poses_blk = poses_blk[0]
        free_p = free_p_blk[0]
        fnext0 = free_next0[0, 0]
        sidx, rpos = h_send[0], h_recv[0]
        lsidx, lrpos = hl_send[0], hl_recv[0]
        pp_ij_l, pp_meas_l = pp_ij[0], pp_meas[0]
        pp_info_l, pp_mask_l = pp_info[0], pp_mask[0]
        pp_chain_l, pp_bnd_l = pp_chain[0], pp_bnd[0]
        pl_ij_l, pl_meas_l = pl_ij[0], pl_meas[0]
        pl_info_l, pl_mask_l = pl_info[0], pl_mask[0]
        lms_blk0 = lms_blk0[0]
        free_l = free_l_blk[0]
        lm_gid_l = lm_gid[0]

        pose_k = pl_ij_l[:, 0]  # always own slots (< B) by construction
        lm_k = pl_ij_l[:, 1]  # own or ghost landmark slots
        gid_k = lm_gid_l[lm_k]  # global landmark column ids

        def gather_aug(v_blk):
            gh = halo_gather(v_blk, sidx, rpos, spec, EDGE_AXIS)
            return jnp.concatenate([v_blk, gh], axis=0)

        def ghost_reduce(contrib):
            return halo_reduce(contrib[:B], contrib[B:], sidx, rpos, spec,
                               EDGE_AXIS)

        def gather_aug_l(v_blk):
            gh = halo_gather(v_blk, lsidx, lrpos, spec_l, EDGE_AXIS)
            return jnp.concatenate([v_blk, gh], axis=0)

        def ghost_reduce_l(contrib):
            return halo_reduce(contrib[:BL], contrib[BL:], lsidx, lrpos,
                               spec_l, EDGE_AXIS)

        def local_graph(aug_poses, aug_lms):
            return PoseGraph2D(
                poses=aug_poses,
                pose_mask=jnp.ones(B + G, bool),
                landmarks=aug_lms,
                landmark_mask=jnp.ones(BL + GL, bool),
                pp_ij=pp_ij_l, pp_meas=pp_meas_l, pp_info=pp_info_l,
                pp_mask=pp_mask_l,
                pl_ij=pl_ij_l, pl_meas=pl_meas_l, pl_info=pl_info_l,
                pl_mask=pl_mask_l,
                fixed=jnp.zeros(B + G, bool),
            )

        def chi2_of(pb, lb):
            gk = local_graph(gather_aug(pb), gather_aug_l(lb))
            return jax.lax.psum(
                pg.linearize_se2(gk, huber_delta).chi2, EDGE_AXIS
            )

        def build_system(gk, lin, lam):
            """Distributed analog of schur_pcg.build_schur_system."""
            gp_aug, gl_aug = pg._grad_se2(gk, lin)
            gp = ghost_reduce(gp_aug)
            gl = ghost_reduce_l(gl_aug)
            Dp_aug, Dl_aug = pg._diag_blocks_se2(gk, lin)
            Dp = ghost_reduce(Dp_aug)
            Dl = ghost_reduce_l(Dl_aug)
            bp = -gp * free_p[:, None]
            edge_hvp = pg._hvp_edges_se2(gk, lin)
            diagDp = jnp.einsum("kii->ki", Dp)
            zeros_l_aug = jnp.zeros((BL + GL, 2), dtype)

            if has_pl:
                C = jnp.einsum(
                    "kdi,kde,kej->kij", lin.Jp_pl, lin.w_pl, lin.Jl_pl
                )
                Hll_inv = jnp.linalg.inv(_damped_or_eye(Dl, lam, free_l, 2))
                bl = -gl * free_l[:, None]
                ybl = jnp.einsum("lij,lj->li", Hll_inv, bl)
                ybl_aug = gather_aug_l(ybl)
                bs = bp - free_p[:, None] * jax.ops.segment_sum(
                    jnp.einsum("kij,kj->ki", C, ybl_aug[lm_k]), pose_k, B
                )
            else:
                C = Hll_inv = ybl = None
                bs = bp

            def smv(v):
                (vp,) = v
                vp = vp * free_p[:, None]
                aug = gather_aug(vp)
                hp_aug, _ = edge_hvp((aug, zeros_l_aug))
                hp = ghost_reduce(hp_aug)
                hp = hp + lam * diagDp * vp
                if has_pl:
                    t = jax.ops.segment_sum(
                        jnp.einsum("kji,kj->ki", C, vp[pose_k]), lm_k,
                        BL + GL,
                    )
                    t_own = ghost_reduce_l(t)
                    y = jnp.einsum("lij,lj->li", Hll_inv, t_own)
                    y_aug = gather_aug_l(y)
                    hp = hp - jax.ops.segment_sum(
                        jnp.einsum("kij,kj->ki", C, y_aug[lm_k]), pose_k, B
                    )
                hp = hp * free_p[:, None] + (1.0 - free_p)[:, None] * v[0]
                return (hp,)

            # --- distributed chain + Woodbury-arrow preconditioner ---
            ci = jnp.where(pp_chain_l, pp_ij_l[:, 0], B - 1)
            U_chain = jax.ops.segment_sum(
                jnp.einsum(
                    "kdi,kde,kej->kij", lin.Ji_pp,
                    lin.w_pp * pp_chain_l[:, None, None], lin.Jj_pp,
                ),
                ci, B,
            )
            fnext = jnp.concatenate([free_p[1:], jnp.zeros(1, dtype)])
            U_pre = U_chain * (free_p * fnext)[:, None, None]
            L_pre = jnp.concatenate(
                [jnp.zeros((1, 3, 3), dtype), jnp.swapaxes(U_pre, 1, 2)[:-1]]
            )
            Dpre = _damped_or_eye(Dp, lam, free_p, 3)
            U_bnd = jnp.einsum(
                "kdi,kde,kej->ij", lin.Ji_pp,
                lin.w_pp * pp_bnd_l[:, None, None], lin.Jj_pp,
            ) * (free_p[B - 1] * fnext0)
            sf = spike_factor(L_pre, Dpre, U_pre, U_bnd, EDGE_AXIS, n_dev)

            if has_pl:
                # dense V rows of OWN poses: (B, 3, 2NL), global lm columns
                Vd = jax.ops.segment_sum(
                    C.reshape(-1, 6), pose_k * NL + gid_k, B * NL
                ).reshape(B, NL, 3, 2)
                Vd = jnp.transpose(Vd, (0, 2, 1, 3)).reshape(B, 3, 2 * NL)
                Vd = Vd * free_p[:, None, None]
                X = spike_solve(sf, Vd, EDGE_AXIS)  # distributed T^-1 V
                # global arrow diag A: psum of owners' damped blocks on
                # free rows + identity on invalid rows (added replicated)
                contrib = jnp.where(
                    free_l[:, None, None] > 0,
                    _damped_or_eye(Dl, lam, free_l, 2), 0.0
                )
                A_diag = jax.lax.psum(
                    jax.ops.segment_sum(contrib, lm_gid_l[:BL], NL),
                    EDGE_AXIS,
                )
                A_diag = A_diag + (1.0 - lm_free[:, None, None]) * jnp.eye(
                    2, dtype=dtype
                )
                A = jnp.zeros((NL, 2, NL, 2), dtype)
                A = A.at[jnp.arange(NL), :, jnp.arange(NL), :].set(A_diag)
                K = A.reshape(2 * NL, 2 * NL) - jax.lax.psum(
                    jnp.einsum("pdm,pdn->mn", Vd, X), EDGE_AXIS
                )
                K_lu = jax.scipy.linalg.lu_factor(K)

                def precond(r):
                    z = spike_solve(sf, r[0], EDGE_AXIS)
                    w = jax.lax.psum(
                        jnp.einsum("pdm,pd->m", Vd, z), EDGE_AXIS
                    )
                    u = jax.scipy.linalg.lu_solve(K_lu, w)
                    return (z + jnp.einsum("pdm,m->pd", X, u),)
            else:

                def precond(r):
                    return (spike_solve(sf, r[0], EDGE_AXIS),)

            def recover_dl(dp):
                if not has_pl:
                    return jnp.zeros((BL, 2), dtype)
                t = jax.ops.segment_sum(
                    jnp.einsum("kji,kj->ki", C, dp[pose_k]), lm_k, BL + GL
                )
                t_own = ghost_reduce_l(t)
                return (
                    ybl - jnp.einsum("lij,lj->li", Hll_inv, t_own)
                ) * free_l[:, None]

            return smv, precond, bs, recover_dl

        def tree_dot(a, b):
            return jax.lax.psum(jnp.vdot(a[0], b[0]), EDGE_AXIS)

        def lm_step(state):
            k, pb, lb, lam, nu, trace, cg_tot, done = state
            gk = local_graph(gather_aug(pb), gather_aug_l(lb))
            lin = pg.linearize_se2(gk, huber_delta)
            chi2 = jax.lax.psum(lin.chi2, EDGE_AXIS)
            smv, precond, bs, recover_dl = build_system(gk, lin, lam)
            (dp,), cg_k, _ = pcg(
                smv, (bs,), precond, max_iters=cg_iters, rtol=cg_rtol,
                tree_dot=tree_dot,
            )
            dp = dp * free_p[:, None]
            dl = recover_dl(dp)
            new_pb = pb + dp
            new_pb = new_pb.at[:, 2].set(lie.wrap_angle(new_pb[:, 2]))
            new_lb = lb + dl
            new_chi2 = chi2_of(new_pb, new_lb)
            accept = jnp.isfinite(new_chi2) & (new_chi2 < chi2)
            lam_new = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-12),
                                jnp.minimum(lam * nu, 1e10))
            nu_new = jnp.where(accept, 2.0, jnp.minimum(nu * 2.0, 64.0))
            rel_drop = (chi2 - new_chi2) / jnp.maximum(chi2, 1e-30)
            done_new = accept & (rel_drop < tol)
            done_new = done_new | ((~accept) & (lam >= 1e10))
            pb = jnp.where(accept, new_pb, pb)
            lb = jnp.where(accept, new_lb, lb)
            trace = trace.at[k + 1].set(jnp.where(accept, new_chi2, chi2))
            return (k + 1, pb, lb, lam_new, nu_new, trace, cg_tot + cg_k,
                    done_new)

        def cond(state):
            k, *_, done = state
            return jnp.logical_and(k < iters, jnp.logical_not(done))

        trace0 = jnp.zeros(iters + 1, dtype).at[0].set(
            chi2_of(poses_blk, lms_blk0)
        )
        init = (
            jnp.asarray(0, jnp.int32), poses_blk, lms_blk0,
            jnp.asarray(lm_lambda0, dtype), jnp.asarray(2.0, dtype),
            trace0, jnp.asarray(0, jnp.int32), jnp.asarray(False),
        )
        k, pb, lb, lam, nu, trace, cg_tot, done = jax.lax.while_loop(
            cond, lm_step, init
        )
        idx = jnp.arange(iters + 1)
        trace = jnp.where(idx <= k, trace, trace[k])
        return pb[None], lb[None], trace, cg_tot, k

    args = (
        jnp.asarray(part.poses_blk),
        jnp.asarray(part.free_p_blk),
        jnp.asarray(free_next0),
        jnp.asarray(part.halo.send_idx),
        jnp.asarray(part.halo.recv_pos),
        jnp.asarray(part.halo_l.send_idx),
        jnp.asarray(part.halo_l.recv_pos),
        jnp.asarray(part.pp_ij), jnp.asarray(part.pp_meas),
        jnp.asarray(part.pp_info), jnp.asarray(part.pp_mask),
        jnp.asarray(part.pp_chain), jnp.asarray(part.pp_bnd),
        jnp.asarray(part.pl_ij), jnp.asarray(part.pl_meas),
        jnp.asarray(part.pl_info), jnp.asarray(part.pl_mask),
        jnp.asarray(part.lms_blk), jnp.asarray(part.free_l_blk),
        jnp.asarray(part.lm_gid),
        jnp.asarray(lm_free_global),
    )
    # reduced-precision matmuls (TF32 on a GPU) would wreck the repeated 3x3
    # eliminations (see solvers/schur_pcg.py) — pin full float32 for the
    # whole program
    def program(*operands):
        with jax.default_matmul_precision("highest"):
            return run(*operands)

    return jax.jit(program), args, part
