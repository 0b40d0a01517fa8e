"""Distributed Schur-complement BA: observations sharded over the mesh.

The BASELINE.json target architecture: keyframe/observation blocks
partitioned across devices; each device linearizes its observation shard and
produces partial (NP,6)/(NL,3) reduction vectors and partial block
diagonals; `psum` across devices assembles the global quantities; the Schur-PCG
then iterates replicated with two psums per matvec. Landmark elimination
(H_pp^-1) is computed redundantly on every device from the psum'ed point
blocks — O(NL) 3x3 inverses, negligible vs. communication.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..solvers.ba import BAProblem, _linearize
from ..solvers.pcg import pcg
from ..solvers.pose_graph import _pose7_to_T, _T_to_pose7
from ..utils import lie
from .mesh import EDGE_AXIS, pad_to_multiple


def _psum(x):
    return jax.lax.psum(x, EDGE_AXIS)


def optimize_ba_sharded(ba: BAProblem, mesh, iters: int = 10, cg_iters: int = 50,
                        lm_lambda0: float = 1e-4):
    """Observation-sharded LM-BA; returns (problem, chi2 trace)."""
    n_dev = mesh.devices.size
    obs_ij = pad_to_multiple(ba.obs_ij, n_dev)
    obs_z = pad_to_multiple(ba.obs_z, n_dev)
    obs_info = pad_to_multiple(ba.obs_info, n_dev)
    obs_mask = pad_to_multiple(ba.obs_mask, n_dev)

    NP, NL = ba.poses.shape[0], ba.points.shape[0]
    free_c = (ba.pose_mask & ~ba.fixed).astype(ba.poses.dtype)
    free_p = ba.point_mask.astype(ba.poses.dtype)

    e_spec = P(EDGE_AXIS)
    rep = P()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(rep, rep, e_spec, e_spec, e_spec, e_spec, rep, rep),
        out_specs=(rep, rep, rep),
    )
    def run(poses0, points0, obs_ij, obs_z, obs_info, obs_mask, free_c, free_p):
        ci = obs_ij[:, 0]
        pi = obs_ij[:, 1]

        def local_lin(poses, points):
            bak = BAProblem(
                poses, ba.pose_mask, points, ba.point_mask,
                obs_ij, obs_z, obs_info, obs_mask, ba.fixed,
            )
            return _linearize(bak)

        def chi2_of(poses, points):
            return _psum(local_lin(poses, points)[4])

        def step(k, state):
            poses, points, lam, trace = state
            e, Jc, Jp, w, chi2_l = local_lin(poses, points)
            chi2 = _psum(chi2_l)

            we = jnp.einsum("kij,kj->ki", w, e)
            g_c = _psum(jax.ops.segment_sum(jnp.einsum("kdi,kd->ki", Jc, we), ci, NP))
            g_p = _psum(jax.ops.segment_sum(jnp.einsum("kdi,kd->ki", Jp, we), pi, NL))
            D_c = _psum(
                jax.ops.segment_sum(jnp.einsum("kdi,kde,kej->kij", Jc, w, Jc), ci, NP)
            )
            H_pp = _psum(
                jax.ops.segment_sum(jnp.einsum("kdi,kde,kej->kij", Jp, w, Jp), pi, NL)
            )
            eye3 = jnp.eye(3, dtype=poses.dtype)
            H_pp_d = H_pp + (lam * H_pp * eye3 + 1e-6 * eye3)
            H_pp_d = jnp.where(free_p[:, None, None] > 0, H_pp_d, eye3)
            H_pp_inv = jnp.linalg.inv(H_pp_d)

            def Hcp_apply(vp):
                Jv = jnp.einsum("kdi,ki->kd", Jp, vp[pi])
                WJv = jnp.einsum("kde,ke->kd", w, Jv)
                return _psum(
                    jax.ops.segment_sum(jnp.einsum("kdi,kd->ki", Jc, WJv), ci, NP)
                )

            def Hpc_apply(vc):
                Jv = jnp.einsum("kdi,ki->kd", Jc, vc[ci])
                WJv = jnp.einsum("kde,ke->kd", w, Jv)
                return _psum(
                    jax.ops.segment_sum(jnp.einsum("kdi,kd->ki", Jp, WJv), pi, NL)
                )

            hinv_gp = jnp.einsum("kij,kj->ki", H_pp_inv, g_p)
            b_s = (-g_c + Hcp_apply(hinv_gp)) * free_c[:, None]
            lam_D = lam * D_c * jnp.eye(6, dtype=poses.dtype)

            def schur_hvp(v):
                (vc,) = v
                vc = vc * free_c[:, None]
                Jv = jnp.einsum("kdi,ki->kd", Jc, vc[ci])
                WJv = jnp.einsum("kde,ke->kd", w, Jv)
                hcc = _psum(
                    jax.ops.segment_sum(jnp.einsum("kdi,kd->ki", Jc, WJv), ci, NP)
                ) + jnp.einsum("kij,kj->ki", lam_D, vc)
                hpc = Hpc_apply(vc)
                hcorr = Hcp_apply(jnp.einsum("kij,kj->ki", H_pp_inv, hpc))
                out = hcc - hcorr
                return (out * free_c[:, None] + (1.0 - free_c)[:, None] * v[0],)

            eye6 = jnp.eye(6, dtype=poses.dtype)
            D_prec = D_c + lam_D + 1e-6 * eye6
            D_prec = jnp.where(free_c[:, None, None] > 0, D_prec, eye6)
            D_inv = jnp.linalg.inv(D_prec)

            def precond(r):
                return (jnp.einsum("kij,kj->ki", D_inv, r[0]),)

            (dc,), _, _ = pcg(schur_hvp, (b_s,), precond, max_iters=cg_iters,
                              rtol=1e-8)
            dc = dc * free_c[:, None]
            dp = jnp.einsum("kij,kj->ki", H_pp_inv, -g_p - Hpc_apply(dc))
            dp = dp * free_p[:, None]

            new_poses = jax.vmap(
                lambda p, d: _T_to_pose7(_pose7_to_T(p) @ lie.se3_exp(d))
            )(poses, dc)
            new_points = points + dp
            new_chi2 = chi2_of(new_poses, new_points)
            accept = new_chi2 < chi2
            poses = jnp.where(accept, new_poses, poses)
            points = jnp.where(accept, new_points, points)
            lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-10),
                            jnp.minimum(lam * 4.0, 1e8))
            trace = trace.at[k + 1].set(jnp.where(accept, new_chi2, chi2))
            return poses, points, lam, trace

        trace0 = jnp.zeros(iters + 1, poses0.dtype).at[0].set(
            chi2_of(poses0, points0)
        )
        poses, points, lam, trace = jax.lax.fori_loop(
            0, iters, step,
            (poses0, points0, jnp.asarray(lm_lambda0, poses0.dtype), trace0),
        )
        return poses, points, trace

    poses, points, trace = jax.jit(run)(
        ba.poses, ba.points, obs_ij, obs_z, obs_info, obs_mask, free_c, free_p
    )
    return ba._replace(poses=poses, points=points), trace
