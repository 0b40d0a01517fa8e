"""Batched Gauss-Newton / Levenberg-Marquardt pose-graph optimization.

JAX replacement for the reference's g2o backend usage
(``boss_map_building/map_g2o_reflector.h:50-74`` `optimize()`, and the legacy
direct g2o graphs in ``slam/tracker_test.cpp:365-436``):

- per-edge residual/Jacobian via `vmap`(`jacfwd`) — no hand-rolled sparse
  workspace; every edge linearizes in parallel,
- gradient and block-diagonal assembled with `segment_sum`,
- the Newton system is solved matrix-free with block-Jacobi PCG (`pcg.py`),
- gauge freedom handled by projecting fixed-pose DOFs out of the system,
- LM damping with accept/reject under `lax.while_loop` — the whole optimize
  call is one compiled XLA program.

Residual conventions match g2o:
  SE2 pose-pose:      e = t2v(Z^-1 (Xi^-1 Xj))           (3,)
  SE2 pose-landmark:  e = R_i^T (l - t_i) - z            (2,)
  SE3 pose-pose:      e = log(Z^-1 (Xi^-1 Xj))           (6,) twist chart
with local updates: SE2 additive (x,y,theta), SE3 right-multiplicative
``X <- X * exp(dx)``.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..graph.store import PoseGraph2D, PoseGraph3D
from ..utils import lie
from .pcg import pcg

# ---------------------------------------------------------------------------
# Residuals
# ---------------------------------------------------------------------------


def se2_pp_residual(xi, xj, z):
    pred = lie.se2_relative(xi, xj)
    e = pred - z
    return e.at[2].set(lie.wrap_angle(e[2]))


def se2_pl_residual(xi, l, z):
    c, s = jnp.cos(xi[2]), jnp.sin(xi[2])
    dx, dy = l[0] - xi[0], l[1] - xi[1]
    return jnp.array([c * dx + s * dy, -s * dx + c * dy]) - z


def se3_pp_residual_local(dxi, dxj, Ti, Tj, Zinv):
    """Residual as a function of local twists (for Jacobians at 0)."""
    Xi = Ti @ lie.se3_exp(dxi)
    Xj = Tj @ lie.se3_exp(dxj)
    return lie.se3_log(Zinv @ (lie.se3_inverse(Xi) @ Xj))


# ---------------------------------------------------------------------------
# Linearization (batched)
# ---------------------------------------------------------------------------


class Linearization(NamedTuple):
    """Per-edge residuals and Jacobians, plus weights (robust-scaled)."""

    e_pp: jnp.ndarray  # (EP, D)
    Ji_pp: jnp.ndarray  # (EP, D, D)
    Jj_pp: jnp.ndarray  # (EP, D, D)
    w_pp: jnp.ndarray  # (EP, D, D)  info (robust-scaled, masked)
    e_pl: jnp.ndarray | None  # (EL, 2)
    Jp_pl: jnp.ndarray | None  # (EL, 2, D)
    Jl_pl: jnp.ndarray | None  # (EL, 2, 2)
    w_pl: jnp.ndarray | None  # (EL, 2, 2)
    chi2: jnp.ndarray  # scalar (robust chi2, masked)


def _robust_scale(chi2, huber_delta):
    """Huber weight factor on the information matrix; delta<=0 disables."""
    if huber_delta is None:
        return 1.0
    d2 = huber_delta * huber_delta
    return jnp.where(chi2 > d2, jnp.sqrt(d2 / jnp.maximum(chi2, 1e-30)), 1.0)


def linearize_se2(g: PoseGraph2D, huber_delta=None) -> Linearization:
    xi = g.poses[g.pp_ij[:, 0]]
    xj = g.poses[g.pp_ij[:, 1]]

    def one_pp(xi, xj, z):
        e = se2_pp_residual(xi, xj, z)
        Ji = jax.jacfwd(lambda a: se2_pp_residual(a, xj, z))(xi)
        Jj = jax.jacfwd(lambda b: se2_pp_residual(xi, b, z))(xj)
        return e, Ji, Jj

    e_pp, Ji_pp, Jj_pp = jax.vmap(one_pp)(xi, xj, g.pp_meas)
    chi2_pp = jnp.einsum("ki,kij,kj->k", e_pp, g.pp_info, e_pp)
    s_pp = _robust_scale(chi2_pp, huber_delta)
    w_pp = g.pp_info * (s_pp * g.pp_mask)[:, None, None]
    total = jnp.sum(jnp.where(g.pp_mask, s_pp * chi2_pp, 0.0))

    has_pl = g.pl_ij.shape[0] > 0
    e_pl = Jp_pl = Jl_pl = w_pl = None
    if has_pl:
        xp = g.poses[g.pl_ij[:, 0]]
        ll = g.landmarks[g.pl_ij[:, 1]]

        def one_pl(xp, ll, z):
            e = se2_pl_residual(xp, ll, z)
            Jp = jax.jacfwd(lambda a: se2_pl_residual(a, ll, z))(xp)
            Jl = jax.jacfwd(lambda b: se2_pl_residual(xp, b, z))(ll)
            return e, Jp, Jl

        e_pl, Jp_pl, Jl_pl = jax.vmap(one_pl)(xp, ll, g.pl_meas)
        chi2_pl = jnp.einsum("ki,kij,kj->k", e_pl, g.pl_info, e_pl)
        s_pl = _robust_scale(chi2_pl, huber_delta)
        w_pl = g.pl_info * (s_pl * g.pl_mask)[:, None, None]
        total = total + jnp.sum(jnp.where(g.pl_mask, s_pl * chi2_pl, 0.0))

    return Linearization(e_pp, Ji_pp, Jj_pp, w_pp, e_pl, Jp_pl, Jl_pl, w_pl, total)


def linearize_se3(g: PoseGraph3D, huber_delta=None) -> Linearization:
    Ti = jax.vmap(_pose7_to_T)(g.poses[g.pp_ij[:, 0]])
    Tj = jax.vmap(_pose7_to_T)(g.poses[g.pp_ij[:, 1]])
    Zinv = jax.vmap(lambda z: lie.se3_inverse(_pose7_to_T(z)))(g.pp_meas)

    def one(Ti, Tj, Zinv):
        zero = jnp.zeros(6, dtype=Ti.dtype)
        e = se3_pp_residual_local(zero, zero, Ti, Tj, Zinv)
        Ji = jax.jacfwd(lambda d: se3_pp_residual_local(d, zero, Ti, Tj, Zinv))(zero)
        Jj = jax.jacfwd(lambda d: se3_pp_residual_local(zero, d, Ti, Tj, Zinv))(zero)
        return e, Ji, Jj

    e, Ji, Jj = jax.vmap(one)(Ti, Tj, Zinv)
    chi2 = jnp.einsum("ki,kij,kj->k", e, g.pp_info, e)
    s = _robust_scale(chi2, huber_delta)
    w = g.pp_info * (s * g.pp_mask)[:, None, None]
    total = jnp.sum(jnp.where(g.pp_mask, s * chi2, 0.0))
    return Linearization(e, Ji, Jj, w, None, None, None, None, total)


def _pose7_to_T(p):
    """[t(3), qx qy qz qw] -> 4x4."""
    q = jnp.concatenate([p[6:7], p[3:6]])  # wxyz
    q = q / jnp.maximum(jnp.linalg.norm(q), 1e-12)
    w, x, y, z = q[0], q[1], q[2], q[3]
    R = jnp.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=p.dtype,
    )
    T = jnp.eye(4, dtype=p.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(p[:3])
    return T


def _T_to_pose7(T):
    q = lie.mat2quat_full(T[:3, :3])  # wxyz
    return jnp.concatenate([T[:3, 3], q[1:], q[0:1]])


# ---------------------------------------------------------------------------
# System operators (gradient, Hv, block-diagonal)
# ---------------------------------------------------------------------------


def _grad_se2(g: PoseGraph2D, lin: Linearization):
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    we_pp = jnp.einsum("kij,kj->ki", lin.w_pp, lin.e_pp)
    gp = jax.ops.segment_sum(
        jnp.einsum("kdi,kd->ki", lin.Ji_pp, we_pp), g.pp_ij[:, 0], NP
    )
    gp = gp + jax.ops.segment_sum(
        jnp.einsum("kdi,kd->ki", lin.Jj_pp, we_pp), g.pp_ij[:, 1], NP
    )
    gl = jnp.zeros((NL, 2), dtype=g.poses.dtype)
    if lin.e_pl is not None:
        we_pl = jnp.einsum("kij,kj->ki", lin.w_pl, lin.e_pl)
        gp = gp + jax.ops.segment_sum(
            jnp.einsum("kdi,kd->ki", lin.Jp_pl, we_pl), g.pl_ij[:, 0], NP
        )
        gl = jax.ops.segment_sum(
            jnp.einsum("kdi,kd->ki", lin.Jl_pl, we_pl), g.pl_ij[:, 1], NL
        )
    return gp, gl


def _diag_blocks_se2(g: PoseGraph2D, lin: Linearization):
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    Hii = jnp.einsum("kdi,kde,kej->kij", lin.Ji_pp, lin.w_pp, lin.Ji_pp)
    Hjj = jnp.einsum("kdi,kde,kej->kij", lin.Jj_pp, lin.w_pp, lin.Jj_pp)
    Dp = jax.ops.segment_sum(Hii, g.pp_ij[:, 0], NP)
    Dp = Dp + jax.ops.segment_sum(Hjj, g.pp_ij[:, 1], NP)
    Dl = jnp.zeros((NL, 2, 2), dtype=g.poses.dtype)
    if lin.e_pl is not None:
        Hpp = jnp.einsum("kdi,kde,kej->kij", lin.Jp_pl, lin.w_pl, lin.Jp_pl)
        Hll = jnp.einsum("kdi,kde,kej->kij", lin.Jl_pl, lin.w_pl, lin.Jl_pl)
        Dp = Dp + jax.ops.segment_sum(Hpp, g.pl_ij[:, 0], NP)
        Dl = jax.ops.segment_sum(Hll, g.pl_ij[:, 1], NL)
    return Dp, Dl


def _hvp_edges_se2(g: PoseGraph2D, lin: Linearization):
    """Pure per-edge Gauss-Newton Hv contribution: sum_e J^T W J v.

    No damping, no gauge handling — so the distributed solver can `psum`
    exactly this term across edge shards (parallel/sharded_pose_graph.py).
    """
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]

    def hvp(v):
        vp, vl = v
        # pose-pose edges
        vi = vp[g.pp_ij[:, 0]]
        vj = vp[g.pp_ij[:, 1]]
        Jv = jnp.einsum("kdi,ki->kd", lin.Ji_pp, vi) + jnp.einsum(
            "kdi,ki->kd", lin.Jj_pp, vj
        )
        WJv = jnp.einsum("kde,ke->kd", lin.w_pp, Jv)
        hp = jax.ops.segment_sum(
            jnp.einsum("kdi,kd->ki", lin.Ji_pp, WJv), g.pp_ij[:, 0], NP
        )
        hp = hp + jax.ops.segment_sum(
            jnp.einsum("kdi,kd->ki", lin.Jj_pp, WJv), g.pp_ij[:, 1], NP
        )
        hl = jnp.zeros((NL, 2), dtype=vp.dtype)
        if lin.e_pl is not None:
            vpp = vp[g.pl_ij[:, 0]]
            vll = vl[g.pl_ij[:, 1]]
            Jv2 = jnp.einsum("kdi,ki->kd", lin.Jp_pl, vpp) + jnp.einsum(
                "kdi,ki->kd", lin.Jl_pl, vll
            )
            WJv2 = jnp.einsum("kde,ke->kd", lin.w_pl, Jv2)
            hp = hp + jax.ops.segment_sum(
                jnp.einsum("kdi,kd->ki", lin.Jp_pl, WJv2), g.pl_ij[:, 0], NP
            )
            hl = jax.ops.segment_sum(
                jnp.einsum("kdi,kd->ki", lin.Jl_pl, WJv2), g.pl_ij[:, 1], NL
            )
        return (hp, hl)

    return hvp


def _hvp_se2(g: PoseGraph2D, lin: Linearization, free_p, free_l, lm_lambda, Dp, Dl):
    """Damped, gauge-projected Hessian-vector product closure.

    Composes the pure edge term with LM damping on the diagonal blocks and an
    identity action on fixed/invalid DOFs (gauge projection).
    """
    edge_hvp = _hvp_edges_se2(g, lin)
    return _compose_hvp(edge_hvp, free_p, free_l, lm_lambda, Dp, Dl)


def _compose_hvp(edge_hvp, free_p, free_l, lm_lambda, Dp, Dl):
    def hvp(v):
        vp, vl = v
        vp = vp * free_p[:, None]
        vl = vl * free_l[:, None]
        hp, hl = edge_hvp((vp, vl))
        # LM damping on the diagonal blocks
        hp = hp + lm_lambda * jnp.einsum("kij,kj->ki", Dp, vp)
        hl = hl + lm_lambda * jnp.einsum("kij,kj->ki", Dl, vl)
        # gauge projection: fixed/invalid DOFs behave as identity
        hp = hp * free_p[:, None] + (1.0 - free_p)[:, None] * v[0]
        hl = hl * free_l[:, None] + (1.0 - free_l)[:, None] * v[1]
        return (hp, hl)

    return hvp


def _block_jacobi_precond(Dp, Dl, free_p, free_l, lm_lambda):
    eye3 = jnp.eye(3, dtype=Dp.dtype)
    eye2 = jnp.eye(2, dtype=Dp.dtype)
    Dp_d = (1.0 + lm_lambda) * Dp + 1e-6 * eye3
    Dl_d = (1.0 + lm_lambda) * Dl + 1e-6 * eye2
    Dp_d = jnp.where(free_p[:, None, None] > 0, Dp_d, eye3)
    Dl_d = jnp.where(free_l[:, None, None] > 0, Dl_d, eye2)
    Dp_inv = jnp.linalg.inv(Dp_d)
    Dl_inv = jnp.linalg.inv(Dl_d)

    def precond(r):
        rp, rl = r
        return (
            jnp.einsum("kij,kj->ki", Dp_inv, rp),
            jnp.einsum("kij,kj->ki", Dl_inv, rl),
        )

    return precond


# ---------------------------------------------------------------------------
# Full LM optimization (jitted end-to-end)
# ---------------------------------------------------------------------------


class OptStats(NamedTuple):
    chi2: jnp.ndarray  # (iters+1,) robust chi2 trace (padded with last value)
    lm_lambda: jnp.ndarray  # final lambda
    cg_iters: jnp.ndarray  # total CG iterations


@partial(jax.jit,
         static_argnames=("iters", "cg_iters", "huber_delta", "precond"))
def optimize_se2(
    g: PoseGraph2D,
    iters: int = 10,
    cg_iters: int = 100,
    lm_lambda0: float = 1e-4,
    huber_delta: float | None = None,
    precond: str = "jacobi",
) -> tuple[PoseGraph2D, OptStats]:
    """LM-optimize an SE2 pose graph (poses + landmarks) in one XLA program.

    precond: "jacobi" (point-block diagonal, the default) or "chain"
    (block-tridiagonal odometry-chain factor via cyclic reduction on the
    pose block + block-Jacobi on landmarks — captures the chain's long-range
    stiffness that stalls plain block-Jacobi on victoriaPark-class graphs;
    solvers/tridiag.py, same preconditioner family as schur_pcg.py).
    """
    free_p = (g.pose_mask & ~g.fixed).astype(g.poses.dtype)
    free_l = g.landmark_mask.astype(g.poses.dtype)
    NP = g.poses.shape[0]
    dtype = g.poses.dtype
    if precond == "chain":
        from .tridiag import cr_factor, cr_solve

        chain = (g.pp_ij[:, 1] == g.pp_ij[:, 0] + 1) & g.pp_mask
        chain_i = jnp.where(chain, g.pp_ij[:, 0], NP - 1)
        prec_ctx = jax.default_matmul_precision("highest")
        prec_ctx.__enter__()
    else:
        prec_ctx = None

    lin0 = linearize_se2(g, huber_delta)
    chi2_trace = jnp.zeros(iters + 1, dtype=g.poses.dtype).at[0].set(lin0.chi2)

    def _chain_precond(lin, Dp, Dl, lam):
        U_chain = jax.ops.segment_sum(
            jnp.einsum("kdi,kde,kej->kij", lin.Ji_pp,
                       lin.w_pp * chain[:, None, None], lin.Jj_pp),
            chain_i, NP,
        )
        fnext = jnp.concatenate([free_p[1:], jnp.zeros(1, dtype)])
        U_pre = U_chain * (free_p * fnext)[:, None, None]
        L_pre = jnp.concatenate(
            [jnp.zeros((1, 3, 3), dtype), jnp.swapaxes(U_pre, 1, 2)[:-1]]
        )
        eye3 = jnp.eye(3, dtype=dtype)
        Dp_d = (1.0 + lam) * Dp + 1e-6 * eye3
        Dp_d = jnp.where(free_p[:, None, None] > 0, Dp_d, eye3)
        fac = cr_factor(L_pre, Dp_d, U_pre)
        eye2 = jnp.eye(2, dtype=dtype)
        Dl_d = (1.0 + lam) * Dl + 1e-6 * eye2
        Dl_d = jnp.where(free_l[:, None, None] > 0, Dl_d, eye2)
        Dl_inv = jnp.linalg.inv(Dl_d)

        def apply(r):
            rp, rl = r
            return (cr_solve(fac, rp),
                    jnp.einsum("kij,kj->ki", Dl_inv, rl))

        return apply

    def step(k, state):
        poses, lms, lam, trace, cg_total = state
        gk = g.with_poses(poses, lms)
        lin = linearize_se2(gk, huber_delta)
        gp, gl = _grad_se2(gk, lin)
        Dp, Dl = _diag_blocks_se2(gk, lin)
        b = (-gp * free_p[:, None], -gl * free_l[:, None])
        hvp = _hvp_se2(gk, lin, free_p, free_l, lam, Dp, Dl)
        if precond == "chain":
            pre = _chain_precond(lin, Dp, Dl, lam)
        else:
            pre = _block_jacobi_precond(Dp, Dl, free_p, free_l, lam)
        (dp, dl), cg_k, _ = pcg(hvp, b, pre, max_iters=cg_iters, rtol=1e-8)

        new_poses = poses + dp * free_p[:, None]
        new_poses = new_poses.at[:, 2].set(lie.wrap_angle(new_poses[:, 2]))
        new_lms = lms + dl * free_l[:, None]
        lin_new = linearize_se2(g.with_poses(new_poses, new_lms), huber_delta)
        accept = lin_new.chi2 < lin.chi2
        poses = jnp.where(accept, new_poses, poses)
        lms = jnp.where(accept, new_lms, lms)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-10), jnp.minimum(lam * 4.0, 1e8))
        trace = trace.at[k + 1].set(jnp.where(accept, lin_new.chi2, lin.chi2))
        return poses, lms, lam, trace, cg_total + cg_k

    try:
        poses, lms, lam, trace, cg_total = jax.lax.fori_loop(
            0,
            iters,
            step,
            (g.poses, g.landmarks, jnp.asarray(lm_lambda0, g.poses.dtype),
             chi2_trace, 0),
        )
    finally:
        if prec_ctx is not None:
            prec_ctx.__exit__(None, None, None)
    return g.with_poses(poses, lms), OptStats(trace, lam, cg_total)


@partial(jax.jit, static_argnames=("iters", "huber_delta"))
def optimize_se2_direct(
    g: PoseGraph2D,
    iters: int = 30,
    lm_lambda0: float = 1e-6,
    huber_delta: float | None = None,
) -> tuple[PoseGraph2D, OptStats]:
    """LM with DENSE Cholesky solves — exact Newton steps.

    The PCG solver's truncated steps converge slowly on long-chain graphs
    with sparse loop closures (victoriaPark: 6x the control optimum after
    100 LM iterations). On an accelerator a dense factorization of the full reduced
    system is cheap for tens of thousands of DOF (victoriaPark: 21,209 DOF
    -> 1.8 GB f32 Hessian, O(D^3/3) f32 work per step), matching the
    exact-step trajectory of the CHOLMOD control (solvers/control.py; the
    reference's backend, ``map_g2o_reflector.h:50-74``). Use for global
    optimization on graphs whose dense Hessian fits HBM; PCG remains the
    scalable path.
    """
    NP = g.poses.shape[0]
    NL = g.landmarks.shape[0]
    D = 3 * NP + 2 * NL
    dtype = g.poses.dtype
    free_p = (g.pose_mask & ~g.fixed).astype(dtype)
    free_l = g.landmark_mask.astype(dtype)
    free = jnp.concatenate(
        [jnp.repeat(free_p, 3), jnp.repeat(free_l, 2)]
    )  # (D,)

    # flat DOF indices per edge endpoint
    i0 = 3 * g.pp_ij[:, 0]
    j0 = 3 * g.pp_ij[:, 1]
    p0 = 3 * g.pl_ij[:, 0]
    l0 = 3 * NP + 2 * g.pl_ij[:, 1]
    d3 = jnp.arange(3)
    d2 = jnp.arange(2)

    def dense_system(lin: Linearization):
        H = jnp.zeros((D, D), dtype)
        b = jnp.zeros(D, dtype)

        def add(H, r0, c0, blk):
            rd = d3 if blk.shape[-2] == 3 else d2
            cd = d3 if blk.shape[-1] == 3 else d2
            rows, cols = jnp.broadcast_arrays(
                r0[:, None, None] + rd[None, :, None],
                c0[:, None, None] + cd[None, None, :],
            )
            return H.at[rows.reshape(-1), cols.reshape(-1)].add(blk.reshape(-1))

        WJi = jnp.einsum("kde,kei->kdi", lin.w_pp, lin.Ji_pp)
        WJj = jnp.einsum("kde,kei->kdi", lin.w_pp, lin.Jj_pp)
        H = add(H, i0, i0, jnp.einsum("kdi,kdj->kij", lin.Ji_pp, WJi))
        H = add(H, i0, j0, jnp.einsum("kdi,kdj->kij", lin.Ji_pp, WJj))
        H = add(H, j0, i0, jnp.einsum("kdi,kdj->kij", lin.Jj_pp, WJi))
        H = add(H, j0, j0, jnp.einsum("kdi,kdj->kij", lin.Jj_pp, WJj))
        We = jnp.einsum("kde,ke->kd", lin.w_pp, lin.e_pp)
        b = b.at[(i0[:, None] + d3[None]).reshape(-1)].add(
            jnp.einsum("kdi,kd->ki", lin.Ji_pp, We).reshape(-1)
        )
        b = b.at[(j0[:, None] + d3[None]).reshape(-1)].add(
            jnp.einsum("kdi,kd->ki", lin.Jj_pp, We).reshape(-1)
        )
        if lin.e_pl is not None:
            WJp = jnp.einsum("kde,kei->kdi", lin.w_pl, lin.Jp_pl)
            WJl = jnp.einsum("kde,kei->kdi", lin.w_pl, lin.Jl_pl)

            H = add(H, p0, p0, jnp.einsum("kdi,kdj->kij", lin.Jp_pl, WJp))
            H = add(H, p0, l0, jnp.einsum("kdi,kdj->kij", lin.Jp_pl, WJl))
            H = add(H, l0, p0, jnp.einsum("kdi,kdj->kij", lin.Jl_pl, WJp))
            H = add(H, l0, l0, jnp.einsum("kdi,kdj->kij", lin.Jl_pl, WJl))
            Wep = jnp.einsum("kde,ke->kd", lin.w_pl, lin.e_pl)
            b = b.at[(p0[:, None] + d3[None]).reshape(-1)].add(
                jnp.einsum("kdi,kd->ki", lin.Jp_pl, Wep).reshape(-1)
            )
            b = b.at[(l0[:, None] + d2[None]).reshape(-1)].add(
                jnp.einsum("kdi,kd->ki", lin.Jl_pl, Wep).reshape(-1)
            )
        return H, b

    chi2_trace = jnp.zeros(iters + 1, dtype).at[0].set(
        linearize_se2(g, huber_delta).chi2
    )

    # pin dots to full f32: a reduced-precision default (TF32 on a GPU)
    # poisons the dense
    # assembly/refinement on chain-conditioned systems (see schur_pcg.py)
    prec_ctx = jax.default_matmul_precision("highest")
    prec_ctx.__enter__()

    def step(state):
        k, poses, lms, lam, nu, trace, done = state
        gk = g.with_poses(poses, lms)
        lin = linearize_se2(gk, huber_delta)
        H, b = dense_system(lin)
        # gauge/mask projection: fixed or padded DOFs become identity rows
        H = H * (free[:, None] * free[None, :])
        Hd = H + jnp.diag(lam * jnp.diag(H) + (1.0 - free) + 1e-6 * free)
        L = jnp.linalg.cholesky(Hd)
        rhs = -b * free
        # f32 Cholesky of a chain-conditioned (cond ~ N^2) system loses the
        # step at small lambda (eps*cond ~ 1 at victoriaPark scale); a few
        # rounds of refinement through the factor recover it — the factor
        # acts as an exact-shape preconditioner whose rounding error the
        # residual correction removes (the role CHOLMOD's float64 plays in
        # the reference backend, ``map_g2o_reflector.h:50-74``).
        dx = jax.scipy.linalg.cho_solve((L, True), rhs)
        for _ in range(2):
            r = rhs - Hd @ dx
            dx = dx + jax.scipy.linalg.cho_solve((L, True), r)
        dx = dx * free
        dp = dx[: 3 * NP].reshape(NP, 3)
        dl = dx[3 * NP :].reshape(NL, 2)

        new_poses = poses + dp
        new_poses = new_poses.at[:, 2].set(lie.wrap_angle(new_poses[:, 2]))
        new_lms = lms + dl
        lin_new = linearize_se2(g.with_poses(new_poses, new_lms), huber_delta)
        ok = jnp.isfinite(lin_new.chi2) & (lin_new.chi2 < lin.chi2)
        poses = jnp.where(ok, new_poses, poses)
        lms = jnp.where(ok, new_lms, lms)
        # Nielsen-style schedule: gentle shrink on accept, doubling penalty
        # streak on reject (same as solvers/schur_pcg.py)
        lam = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-12),
                        jnp.minimum(lam * nu, 1e10))
        nu = jnp.where(ok, 2.0, jnp.minimum(nu * 2.0, 64.0))
        rel_drop = (lin.chi2 - lin_new.chi2) / jnp.maximum(lin.chi2, 1e-30)
        done = (ok & (rel_drop < 1e-9)) | ((~ok) & (lam >= 1e10))
        trace = trace.at[k + 1].set(jnp.where(ok, lin_new.chi2, lin.chi2))
        return k + 1, poses, lms, lam, nu, trace, done

    def cond(state):
        k, *_, done = state
        return jnp.logical_and(k < iters, jnp.logical_not(done))

    try:
        k, poses, lms, lam, nu, trace, done = jax.lax.while_loop(
            cond, step,
            (jnp.asarray(0, jnp.int32), g.poses, g.landmarks,
             jnp.asarray(lm_lambda0, dtype), jnp.asarray(2.0, dtype),
             chi2_trace, jnp.asarray(False)),
        )
    finally:
        prec_ctx.__exit__(None, None, None)
    # pad trace tail with the final chi2 so trace[-1] is always the result
    idx = jnp.arange(iters + 1)
    trace = jnp.where(idx <= k, trace, trace[k])
    return g.with_poses(poses, lms), OptStats(trace, lam, k)


def optimize_se3(
    g: PoseGraph3D,
    iters: int = 10,
    cg_iters: int = 100,
    lm_lambda0: float = 1e-4,
    huber_delta: float | None = None,
    precond: str = "jacobi",
) -> tuple[PoseGraph3D, OptStats]:
    """LM-optimize an SE3 pose graph; updates are right-multiplied twists.

    precond: "jacobi" or "chain" (block-tridiagonal odometry-chain factor
    via cyclic reduction — see optimize_se2).

    The whole program is pinned to f32 matmul accumulation: under a
    reduced-precision default (bf16 or TF32), the 4x4 products feeding ``se3_log`` leave R slightly
    off-orthogonal, (1 - cos th) rounds to zero, and the V^-1 cotangent
    term explodes (measured on graphSE3: residual 1.7e23 / chi2 Inf at the
    dataset init; f32-pinned: 3.57e-7).
    """
    with jax.default_matmul_precision("highest"):
        return _optimize_se3_jit(g, iters, cg_iters, lm_lambda0,
                                 huber_delta, precond)


@partial(jax.jit,
         static_argnames=("iters", "cg_iters", "huber_delta", "precond"))
def _optimize_se3_jit(
    g: PoseGraph3D,
    iters: int = 10,
    cg_iters: int = 100,
    lm_lambda0: float = 1e-4,
    huber_delta: float | None = None,
    precond: str = "jacobi",
) -> tuple[PoseGraph3D, OptStats]:
    free_p = (g.pose_mask & ~g.fixed).astype(g.poses.dtype)
    NP = g.poses.shape[0]
    if precond == "chain":
        from .tridiag import cr_factor, cr_solve

        chain = (g.pp_ij[:, 1] == g.pp_ij[:, 0] + 1) & g.pp_mask
        chain_i = jnp.where(chain, g.pp_ij[:, 0], NP - 1)
    zeros_l = jnp.zeros((1, 2), dtype=g.poses.dtype)  # dummy landmark block
    free_l = jnp.zeros(1, dtype=g.poses.dtype)

    lin0 = linearize_se3(g, huber_delta)
    chi2_trace = jnp.zeros(iters + 1, dtype=g.poses.dtype).at[0].set(lin0.chi2)

    def apply_update(poses, dp):
        def one(p, d):
            T = _pose7_to_T(p) @ lie.se3_exp(d)
            return _T_to_pose7(T)

        return jax.vmap(one)(poses, dp)

    def step(k, state):
        poses, lam, trace, cg_total = state
        gk = g.with_poses(poses)
        lin = linearize_se3(gk, huber_delta)
        we = jnp.einsum("kij,kj->ki", lin.w_pp, lin.e_pp)
        gp = jax.ops.segment_sum(
            jnp.einsum("kdi,kd->ki", lin.Ji_pp, we), g.pp_ij[:, 0], NP
        )
        gp = gp + jax.ops.segment_sum(
            jnp.einsum("kdi,kd->ki", lin.Jj_pp, we), g.pp_ij[:, 1], NP
        )
        Hii = jnp.einsum("kdi,kde,kej->kij", lin.Ji_pp, lin.w_pp, lin.Ji_pp)
        Hjj = jnp.einsum("kdi,kde,kej->kij", lin.Jj_pp, lin.w_pp, lin.Jj_pp)
        Dp = jax.ops.segment_sum(Hii, g.pp_ij[:, 0], NP) + jax.ops.segment_sum(
            Hjj, g.pp_ij[:, 1], NP
        )

        def hvp(v):
            vp, _ = v
            vp = vp * free_p[:, None]
            vi = vp[g.pp_ij[:, 0]]
            vj = vp[g.pp_ij[:, 1]]
            Jv = jnp.einsum("kdi,ki->kd", lin.Ji_pp, vi) + jnp.einsum(
                "kdi,ki->kd", lin.Jj_pp, vj
            )
            WJv = jnp.einsum("kde,ke->kd", lin.w_pp, Jv)
            hp = jax.ops.segment_sum(
                jnp.einsum("kdi,kd->ki", lin.Ji_pp, WJv), g.pp_ij[:, 0], NP
            )
            hp = hp + jax.ops.segment_sum(
                jnp.einsum("kdi,kd->ki", lin.Jj_pp, WJv), g.pp_ij[:, 1], NP
            )
            hp = hp + lam * jnp.einsum("kij,kj->ki", Dp, vp)
            hp = hp * free_p[:, None] + (1.0 - free_p)[:, None] * vp
            return (hp, jnp.zeros_like(zeros_l))

        eye6 = jnp.eye(6, dtype=Dp.dtype)
        Dp_d = (1.0 + lam) * Dp + 1e-6 * eye6
        Dp_d = jnp.where(free_p[:, None, None] > 0, Dp_d, eye6)
        if precond == "chain":
            U_chain = jax.ops.segment_sum(
                jnp.einsum("kdi,kde,kej->kij", lin.Ji_pp,
                           lin.w_pp * chain[:, None, None], lin.Jj_pp),
                chain_i, NP,
            )
            fnext = jnp.concatenate(
                [free_p[1:], jnp.zeros(1, free_p.dtype)]
            )
            U_pre = U_chain * (free_p * fnext)[:, None, None]
            L_pre = jnp.concatenate(
                [jnp.zeros((1, 6, 6), Dp.dtype),
                 jnp.swapaxes(U_pre, 1, 2)[:-1]]
            )
            fac = cr_factor(L_pre, Dp_d, U_pre)

            def pre(r):
                rp, rl = r
                return (cr_solve(fac, rp), rl)
        else:
            Dp_inv = jnp.linalg.inv(Dp_d)

            def pre(r):
                rp, rl = r
                return (jnp.einsum("kij,kj->ki", Dp_inv, rp), rl)

        b = (-gp * free_p[:, None], jnp.zeros_like(zeros_l))
        (dp, _), cg_k, _ = pcg(hvp, b, pre, max_iters=cg_iters, rtol=1e-8)

        new_poses = apply_update(poses, dp * free_p[:, None])
        lin_new = linearize_se3(g.with_poses(new_poses), huber_delta)
        accept = lin_new.chi2 < lin.chi2
        poses = jnp.where(accept, new_poses, poses)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-10), jnp.minimum(lam * 4.0, 1e8))
        trace = trace.at[k + 1].set(jnp.where(accept, lin_new.chi2, lin.chi2))
        return poses, lam, trace, cg_total + cg_k

    poses, lam, trace, cg_total = jax.lax.fori_loop(
        0,
        iters,
        step,
        (g.poses, jnp.asarray(lm_lambda0, g.poses.dtype), chi2_trace, 0),
    )
    return g.with_poses(poses), OptStats(trace, lam, cg_total)


def chi2_se2(g: PoseGraph2D) -> jnp.ndarray:
    return linearize_se2(g).chi2


def chi2_se3(g: PoseGraph3D) -> jnp.ndarray:
    return linearize_se3(g).chi2
