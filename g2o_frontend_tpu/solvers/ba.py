"""Schur-complement bundle adjustment (RGB-D 3D-observation form).

The BASELINE north star backend: poses + 3D point landmarks, LM with the
reduced camera system, never materializing any sparse matrix:

- observation: point landmark p_w seen from pose X as a local 3D point
  ``z = X^-1 p_w`` with 3x3 information (the RGB-D / PWN-keyframe geometry;
  a projective-2D variant is a drop-in residual swap),
- per-observation residual/Jacobians via vmap(jacfwd) in the local twist
  chart (pose) and R^3 (point),
- LM normal system partitioned [camera | point]; the point block H_pp is
  3x3-block-diagonal -> inverted in closed form; the SCHUR complement
  ``S = H_cc - H_cp H_pp^-1 H_pc`` acts matrix-free inside PCG:
  every S@v is four segment_sum passes over the observation array,
- landmark update by back-substitution, joint accept/reject.

`optimize_ba_sharded` runs the same algorithm with observations sharded over
a device mesh: the only communication is a `psum` of the (NP,6)/(NL,3)
reduction vectors and the block diagonals per matvec — the distributed
Schur-BA design from BASELINE.json (boundary reductions are collectives).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import lie
from .pcg import pcg
from .pose_graph import _pose7_to_T, _T_to_pose7


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem (pytree)."""

    poses: jnp.ndarray  # (NP, 7)
    pose_mask: jnp.ndarray  # (NP,)
    points: jnp.ndarray  # (NL, 3) world points
    point_mask: jnp.ndarray  # (NL,)
    obs_ij: jnp.ndarray  # (M, 2) (pose idx, point idx)
    obs_z: jnp.ndarray  # (M, 3) local 3D observation
    obs_info: jnp.ndarray  # (M, 3, 3)
    obs_mask: jnp.ndarray  # (M,)
    fixed: jnp.ndarray  # (NP,)


def _obs_residual(dpose, dpoint, T, p_w, z):
    X = T @ lie.se3_exp(dpose)
    p = p_w + dpoint
    Ri = X[:3, :3].T
    return Ri @ (p - X[:3, 3]) - z


def _linearize(ba: BAProblem):
    T = jax.vmap(_pose7_to_T)(ba.poses[ba.obs_ij[:, 0]])
    P = ba.points[ba.obs_ij[:, 1]]

    def one(T, p, z):
        z6 = jnp.zeros(6, T.dtype)
        z3 = jnp.zeros(3, T.dtype)
        e = _obs_residual(z6, z3, T, p, z)
        Jc = jax.jacfwd(lambda d: _obs_residual(d, z3, T, p, z))(z6)
        Jp = jax.jacfwd(lambda d: _obs_residual(z6, d, T, p, z))(z3)
        return e, Jc, Jp

    e, Jc, Jp = jax.vmap(one)(T, P, ba.obs_z)
    w = ba.obs_info * ba.obs_mask[:, None, None]
    chi2 = jnp.sum(
        jnp.where(ba.obs_mask, jnp.einsum("ki,kij,kj->k", e, ba.obs_info, e), 0.0)
    )
    return e, Jc, Jp, w, chi2


def optimize_ba(ba: BAProblem, iters: int = 10, cg_iters: int = 50,
                lm_lambda0: float = 1e-4):
    """LM-BA with matrix-free Schur-reduced camera solves (f32-pinned
    matmuls: a reduced-precision default corrupts the pose-product
    residuals)."""
    with jax.default_matmul_precision("highest"):
        return _optimize_ba_jit(ba, iters, cg_iters, lm_lambda0)


@partial(jax.jit, static_argnames=("iters", "cg_iters"))
def _optimize_ba_jit(ba: BAProblem, iters: int = 10, cg_iters: int = 50,
                     lm_lambda0: float = 1e-4):
    NP, NL = ba.poses.shape[0], ba.points.shape[0]
    free_c = (ba.pose_mask & ~ba.fixed).astype(ba.poses.dtype)
    free_p = ba.point_mask.astype(ba.poses.dtype)
    ci = ba.obs_ij[:, 0]
    pi = ba.obs_ij[:, 1]

    def chi2_of(poses, points):
        return _linearize(ba._replace(poses=poses, points=points))[4]

    def step(k, state):
        poses, points, lam, trace = state
        bak = ba._replace(poses=poses, points=points)
        e, Jc, Jp, w, chi2 = _linearize(bak)

        we = jnp.einsum("kij,kj->ki", w, e)
        g_c = jax.ops.segment_sum(jnp.einsum("kdi,kd->ki", Jc, we), ci, NP)
        g_p = jax.ops.segment_sum(jnp.einsum("kdi,kd->ki", Jp, we), pi, NL)

        D_c = jax.ops.segment_sum(
            jnp.einsum("kdi,kde,kej->kij", Jc, w, Jc), ci, NP
        )
        H_pp = jax.ops.segment_sum(
            jnp.einsum("kdi,kde,kej->kij", Jp, w, Jp), pi, NL
        )
        eye3 = jnp.eye(3, dtype=poses.dtype)
        H_pp_d = H_pp + (lam * H_pp * eye3 + 1e-6 * eye3)
        H_pp_d = jnp.where(free_p[:, None, None] > 0, H_pp_d, eye3)
        H_pp_inv = jnp.linalg.inv(H_pp_d)

        # Schur RHS: b_s = -g_c + H_cp H_pp^-1 g_p
        hinv_gp = jnp.einsum("kij,kj->ki", H_pp_inv, g_p)

        def Hcp_apply(vp):  # (NL,3) -> (NP,6): sum_obs Jc^T W Jp vp
            Jv = jnp.einsum("kdi,ki->kd", Jp, vp[pi])
            WJv = jnp.einsum("kde,ke->kd", w, Jv)
            return jax.ops.segment_sum(jnp.einsum("kdi,kd->ki", Jc, WJv), ci, NP)

        def Hpc_apply(vc):  # (NP,6) -> (NL,3)
            Jv = jnp.einsum("kdi,ki->kd", Jc, vc[ci])
            WJv = jnp.einsum("kde,ke->kd", w, Jv)
            return jax.ops.segment_sum(jnp.einsum("kdi,kd->ki", Jp, WJv), pi, NL)

        b_s = (-g_c + Hcp_apply(hinv_gp)) * free_c[:, None]

        lam_D = lam * D_c * jnp.eye(6, dtype=poses.dtype)

        def schur_hvp(v):
            (vc,) = v
            vc = vc * free_c[:, None]
            # H_cc vc
            Jv = jnp.einsum("kdi,ki->kd", Jc, vc[ci])
            WJv = jnp.einsum("kde,ke->kd", w, Jv)
            hcc = jax.ops.segment_sum(
                jnp.einsum("kdi,kd->ki", Jc, WJv), ci, NP
            ) + jnp.einsum("kij,kj->ki", lam_D, vc)
            # - H_cp H_pp^-1 H_pc vc
            hpc = Hpc_apply(vc)
            hcorr = Hcp_apply(jnp.einsum("kij,kj->ki", H_pp_inv, hpc))
            out = hcc - hcorr
            out = out * free_c[:, None] + (1.0 - free_c)[:, None] * v[0]
            return (out,)

        eye6 = jnp.eye(6, dtype=poses.dtype)
        D_prec = D_c + lam_D + 1e-6 * eye6
        D_prec = jnp.where(free_c[:, None, None] > 0, D_prec, eye6)
        D_inv = jnp.linalg.inv(D_prec)

        def precond(r):
            return (jnp.einsum("kij,kj->ki", D_inv, r[0]),)

        (dc,), _, _ = pcg(schur_hvp, (b_s,), precond, max_iters=cg_iters, rtol=1e-8)
        dc = dc * free_c[:, None]
        # back-substitute points: dp = H_pp^-1 (-g_p - H_pc dc)
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

    trace0 = jnp.zeros(iters + 1, ba.poses.dtype).at[0].set(
        chi2_of(ba.poses, ba.points)
    )
    poses, points, lam, trace = jax.lax.fori_loop(
        0, iters, step,
        (ba.poses, ba.points, jnp.asarray(lm_lambda0, ba.poses.dtype), trace0),
    )
    return ba._replace(poses=poses, points=points), trace


def make_ba_problem(poses7, points, observations, fixed_idx=(0,), dtype=jnp.float32):
    """observations: list of (pose_idx, point_idx, z(3,), info(3,3))."""
    from ..graph.store import _cap

    n, nl, m = len(poses7), len(points), len(observations)
    NP, NL, M = _cap(max(n, 1)), _cap(max(nl, 1)), _cap(max(m, 1))
    poses = np.zeros((NP, 7)); poses[:, 6] = 1.0
    poses[:n] = poses7
    pts = np.zeros((NL, 3))
    pts[:nl] = points
    ij = np.zeros((M, 2), np.int32)
    z = np.zeros((M, 3))
    wi = np.zeros((M, 3, 3))
    for k, (i, l, zz, ww) in enumerate(observations):
        ij[k] = (i, l); z[k] = zz; wi[k] = ww
    fixed = np.zeros(NP, bool)
    for i in fixed_idx:
        if i < n:
            fixed[i] = True
    return BAProblem(
        poses=jnp.asarray(poses, dtype),
        pose_mask=jnp.asarray(np.arange(NP) < n),
        points=jnp.asarray(pts, dtype),
        point_mask=jnp.asarray(np.arange(NL) < nl),
        obs_ij=jnp.asarray(ij),
        obs_z=jnp.asarray(z, dtype),
        obs_info=jnp.asarray(wi, dtype),
        obs_mask=jnp.asarray(np.arange(M) < m),
        fixed=jnp.asarray(fixed),
    )
