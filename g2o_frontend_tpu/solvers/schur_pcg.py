"""Schur-complement + chain-preconditioned LM for SE2 landmark graphs.

The role of the reference's g2o+CHOLMOD backend
(``boss_map_building/map_g2o_reflector.h:50-74``, ``CMakeLists.txt:105-112``)
on its hardest bundled problem (victoriaPark: ~7k-pose odometry chain + 151
XY landmarks, loop closures only through co-observed landmarks). Plain
block-Jacobi PCG stalls there (chi2 6.4x above the float64 control optimum
for two rounds): the chain gives the Hessian an O(N^2) condition number that
a point-block preconditioner cannot touch.

The cure here exploits the problem structure instead of a sparse
factorization:

1. **Exact Schur elimination of landmarks.** Hll is block-diagonal (2x2 per
   landmark — landmarks never connect), so the reduced pose system
   ``S = Hpp - Hpl Hll^-1 Hlp`` is applied matrix-free with batched
   segment-sums; landmark increments are recovered exactly afterwards.
   The Schur correction has rank <= 2*NL, so CG on S converges in at most
   ~2*NL iterations beyond what the chain part needs.
2. **Block-tridiagonal chain preconditioner** solved by cyclic reduction
   (solvers/tridiag.py): captures the full long-range stiffness of the
   odometry chain in O(log N) parallel depth per application.
3. **Gain-ratio (Nielsen) LM schedule** with convergence-based early exit
   under `lax.while_loop` — runs as long as needed, not a fixed trip count.

Everything is one jitted XLA program per call.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.store import PoseGraph2D
from ..utils import lie
from . import pose_graph as pg
from .pcg import pcg
from .tridiag import cr_factor, cr_solve


class SchurStats(NamedTuple):
    chi2: jnp.ndarray  # (iters+1,) trace padded with the final value
    lm_lambda: jnp.ndarray
    cg_iters: jnp.ndarray  # total CG iterations
    lm_iters: jnp.ndarray  # LM iterations actually executed


def _damped_blocks(D, lam, free, d):
    """D + lam*diag(D) elementwise (g2o/control convention); identity on
    fixed/padded blocks so they act as gauge."""
    eye = jnp.eye(d, dtype=D.dtype)
    diag = jnp.einsum("kii->ki", D)
    Dd = D + lam * jax.vmap(jnp.diag)(diag) + 1e-10 * eye
    return jnp.where(free[:, None, None] > 0, Dd, eye)


def build_schur_system(gk: PoseGraph2D, lin, lam, consts):
    """Build (smv, precond, bs, recover_dl) for one damped linearization.

    smv applies the landmark-eliminated damped Schur operator
    ``S_d = Hpp + lam*diag(Hpp) - Hpl Hll_d^-1 Hlp`` to pose block-vectors;
    precond applies ``M^-1`` where M is either T - V A^-1 V^T (chain
    tridiagonal + exact landmark arrow, via Woodbury) or the Schur-corrected
    chain tridiagonal; bs is the reduced rhs; recover_dl back-substitutes the
    landmark increments. Factored out of the LM loop so each piece is unit-
    testable against dense float64 oracles (tests/test_schur_pcg.py).
    """
    NP, NL = consts["NP"], consts["NL"]
    dtype = consts["dtype"]
    free_p, free_l = consts["free_p"], consts["free_l"]
    has_pl = consts["has_pl"]
    pose_k, lm_k = consts["pose_k"], consts["lm_k"]
    use_woodbury = consts["use_woodbury"]
    chain, chain_i = consts["chain"], consts["chain_i"]

    gp, gl = pg._grad_se2(gk, lin)
    Dp, Dl = pg._diag_blocks_se2(gk, lin)
    bp = -gp * free_p[:, None]

    if has_pl:
        # per-edge cross block Jp^T W Jl (3x2) and landmark-block inverse
        C = jnp.einsum("kdi,kde,kej->kij", lin.Jp_pl, lin.w_pl, lin.Jl_pl)
        Hll_inv = jnp.linalg.inv(_damped_blocks(Dl, lam, free_l, 2))
        bl = -gl * free_l[:, None]
        ybl = jnp.einsum("lij,lj->li", Hll_inv, bl)
        # Schur rhs: bp - Hpl Hll^-1 bl
        bs = bp - free_p[:, None] * jax.ops.segment_sum(
            jnp.einsum("kij,kj->ki", C, ybl[lm_k]), pose_k, NP
        )
        if use_woodbury:
            corr = None
        else:
            # per-pose Schur diagonal correction (exact when each (pose,
            # landmark) pair has a single observation edge — g2o graphs)
            corr = jax.ops.segment_sum(
                jnp.einsum("kij,kjl,kml->kim", C, Hll_inv[lm_k], C),
                pose_k,
                NP,
            )
    else:
        C = Hll_inv = ybl = None
        bs = bp
        corr = jnp.zeros_like(Dp)

    edge_hvp = pg._hvp_edges_se2(gk, lin)
    zeros_l = jnp.zeros((max(NL, 1), 2), dtype)
    diagDp = jnp.einsum("kii->ki", Dp)

    def smv(v):
        (vp,) = v
        vp = vp * free_p[:, None]
        # Hpp v: all pp-edge terms + pl edges' pose-diagonal part.
        # _hvp_edges_se2 with vl=0 yields exactly Hpp v in its hp slot.
        hp, _ = edge_hvp((vp, zeros_l))
        # += lam * diag(Dp) v (elementwise damping, control convention)
        hp = hp + lam * diagDp * vp
        if has_pl:
            t = jax.ops.segment_sum(
                jnp.einsum("kji,kj->ki", C, vp[pose_k]), lm_k, NL
            )
            y = jnp.einsum("lij,lj->li", Hll_inv, t)
            hp = hp - jax.ops.segment_sum(
                jnp.einsum("kij,kj->ki", C, y[lm_k]), pose_k, NP
            )
        hp = hp * free_p[:, None] + (1.0 - free_p)[:, None] * v[0]
        return (hp,)

    # --- preconditioner ---
    # T = block-tridiag(Hpp_d): the damped odometry chain, factored by
    # cyclic reduction once per LM iteration.
    U_chain = jax.ops.segment_sum(
        jnp.einsum(
            "kdi,kde,kej->kij",
            lin.Ji_pp,
            lin.w_pp * chain[:, None, None],
            lin.Jj_pp,
        ),
        chain_i,
        NP,
    )
    # zero couplings into fixed/padded blocks (they act as identity)
    fnext = jnp.concatenate([free_p[1:], jnp.zeros(1, dtype)])
    U_pre = U_chain * (free_p * fnext)[:, None, None]
    L_pre = jnp.concatenate(
        [jnp.zeros((1, 3, 3), dtype), jnp.swapaxes(U_pre, 1, 2)[:-1]]
    )

    if use_woodbury:
        # M = T - V A^-1 V^T: chain + FULL landmark arrow — exactly S
        # when Hpp has no off-chain blocks (victoriaPark's structure;
        # loop closures ride co-observed landmarks). Applied via
        # Woodbury: M^-1 = T^-1 + T^-1 V K^-1 V^T T^-1 with
        # K = A - V^T T^-1 V (2NL x 2NL dense — landmarks are few).
        Dpre = _damped_blocks(Dp, lam, free_p, 3)
        fac = cr_factor(L_pre, Dpre, U_pre)
        # dense V: (NP, 3, 2NL), rows gauge-projected
        Vd = jax.ops.segment_sum(
            C.reshape(-1, 6), pose_k * NL + lm_k, NP * NL
        ).reshape(NP, NL, 3, 2)
        Vd = jnp.transpose(Vd, (0, 2, 1, 3)).reshape(NP, 3, 2 * NL)
        Vd = Vd * free_p[:, None, None]
        X = cr_solve(fac, Vd)  # T^-1 V, multi-rhs CR (batched matmuls)
        A = jnp.zeros((NL, 2, NL, 2), dtype)
        A = A.at[jnp.arange(NL), :, jnp.arange(NL), :].set(
            _damped_blocks(Dl, lam, free_l, 2)
        )
        K = A.reshape(2 * NL, 2 * NL) - jnp.einsum("pdm,pdn->mn", Vd, X)
        K_lu = jax.scipy.linalg.lu_factor(K)

        def precond(r):
            z = cr_solve(fac, r[0])
            w = jnp.einsum("pdm,pd->m", Vd, z)
            u = jax.scipy.linalg.lu_solve(K_lu, w)
            return (z + jnp.einsum("pdm,m->pd", X, u),)

    else:
        # tridiag + per-pose Schur-corrected diagonal only
        Dpre = _damped_blocks(Dp - corr, lam, free_p, 3)
        fac = cr_factor(L_pre, Dpre, U_pre)

        def precond(r):
            return (cr_solve(fac, r[0]),)

    def recover_dl(dp):
        if not has_pl:
            return jnp.zeros((NL, 2), dtype)
        t = jax.ops.segment_sum(
            jnp.einsum("kji,kj->ki", C, dp[pose_k]), lm_k, NL
        )
        return (ybl - jnp.einsum("lij,lj->li", Hll_inv, t)) * free_l[:, None]

    return smv, precond, bs, recover_dl


def landmark_covariance_se2(g: PoseGraph2D, lam: float = 1e-6,
                            huber_delta: float | None = None):
    """Joint landmark covariance blocks via the chain + Woodbury arrow.

    Returns (NL, 2, NL, 2): ``cov[l, :, m, :]`` is the (l, m) block of the
    landmark marginal covariance ``(Hll - Hlp T^-1 Hpl)^-1`` where T is the
    block-tridiagonal (odometry-chain) part of Hpp. Exact when Hpp has no
    off-chain pose-pose blocks (victoriaPark-type graphs, where loop
    closures ride co-observed landmarks); otherwise off-chain pose coupling
    is dropped and covariances are mildly underestimated.

    The reference extracts the same quantity from g2o's
    ``computeMarginals`` (CHOLMOD backend role); here it feeds the
    Mahalanobis-gated landmark merge (slam/feature_tracker.py).
    Landmarks without observations get an identity block (and must be
    excluded by the caller via their mask).
    """
    NP = g.poses.shape[0]
    NL = g.landmarks.shape[0]
    dtype = g.poses.dtype
    free_p = (g.pose_mask & ~g.fixed).astype(dtype)
    free_l = g.landmark_mask.astype(dtype)
    if g.pl_ij.shape[0] == 0 or NL == 0:
        return np.zeros((NL, 2, NL, 2), np.float32)
    pose_k = g.pl_ij[:, 0]
    lm_k = g.pl_ij[:, 1]
    chain = (g.pp_ij[:, 1] == g.pp_ij[:, 0] + 1) & g.pp_mask
    chain_i = jnp.where(chain, g.pp_ij[:, 0], NP - 1)

    @jax.jit
    def compute():
        lin = pg.linearize_se2(g, huber_delta)
        Dp, Dl = pg._diag_blocks_se2(g, lin)
        C = jnp.einsum("kdi,kde,kej->kij", lin.Jp_pl, lin.w_pl, lin.Jl_pl)
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
        Dpre = _damped_blocks(Dp, lam, free_p, 3)
        fac = cr_factor(L_pre, Dpre, U_pre)
        Vd = jax.ops.segment_sum(
            C.reshape(-1, 6), pose_k * NL + lm_k, NP * NL
        ).reshape(NP, NL, 3, 2)
        Vd = jnp.transpose(Vd, (0, 2, 1, 3)).reshape(NP, 3, 2 * NL)
        Vd = Vd * free_p[:, None, None]
        X = cr_solve(fac, Vd)
        A = jnp.zeros((NL, 2, NL, 2), dtype)
        A = A.at[jnp.arange(NL), :, jnp.arange(NL), :].set(
            _damped_blocks(Dl, lam, free_l, 2)
        )
        K = A.reshape(2 * NL, 2 * NL) - jnp.einsum("pdm,pdn->mn", Vd, X)
        return jnp.linalg.inv(K).reshape(NL, 2, NL, 2)

    with jax.default_matmul_precision("highest"):
        return np.asarray(compute())


@partial(jax.jit, static_argnames=("iters", "cg_iters", "huber_delta", "woodbury"))
def optimize_se2_schur(
    g: PoseGraph2D,
    iters: int = 200,
    cg_iters: int = 250,
    lm_lambda0: float = 1e-6,
    huber_delta: float | None = None,
    tol: float = 1e-9,
    cg_rtol: float = 1e-6,
    woodbury: bool | None = None,
) -> tuple[PoseGraph2D, SchurStats]:
    """LM to convergence on the Schur-reduced pose system (see module doc)."""
    NP = g.poses.shape[0]
    NL = g.landmarks.shape[0]
    dtype = g.poses.dtype
    free_p = (g.pose_mask & ~g.fixed).astype(dtype)
    free_l = g.landmark_mask.astype(dtype)
    has_pl = g.pl_ij.shape[0] > 0
    pose_k = g.pl_ij[:, 0] if has_pl else None
    lm_k = g.pl_ij[:, 1] if has_pl else None
    # Woodbury arrow correction only pays off while the dense K stays small
    # (`woodbury` forces a branch in tests; None = size heuristic)
    use_woodbury = (
        (has_pl and 2 * NL <= 2048) if woodbury is None else (woodbury and has_pl)
    )

    # chain off-diagonal slots: pp edge k contributes to U[i] iff j == i+1
    # (odometry edges; all other couplings are handled by CG itself)
    chain = (g.pp_ij[:, 1] == g.pp_ij[:, 0] + 1) & g.pp_mask
    chain_i = jnp.where(chain, g.pp_ij[:, 0], NP - 1)  # masked -> harmless slot

    # A reduced-precision matmul default (bf16, or TF32 on a GPU): the
    # repeated 3x3 eliminations of the cyclic reduction and the Woodbury
    # products amplify its rounding
    # catastrophically on the chain-conditioned system (measured: chi2
    # stalls at 394k vs 21.9k with f32 accumulation). Pin every dot in this
    # program to full f32.
    prec_ctx = jax.default_matmul_precision("highest")
    prec_ctx.__enter__()
    try:
        return _optimize_se2_schur_body(
            g, iters, cg_iters, lm_lambda0, huber_delta, tol, cg_rtol,
            use_woodbury, NP, NL, dtype, free_p, free_l, has_pl, pose_k,
            lm_k, chain, chain_i,
        )
    finally:
        prec_ctx.__exit__(None, None, None)


def _optimize_se2_schur_body(g, iters, cg_iters, lm_lambda0, huber_delta,
                             tol, cg_rtol, use_woodbury, NP, NL, dtype,
                             free_p, free_l, has_pl, pose_k, lm_k, chain,
                             chain_i):
    lin0 = pg.linearize_se2(g, huber_delta)
    trace0 = jnp.zeros(iters + 1, dtype).at[0].set(lin0.chi2)

    consts = dict(
        NP=NP, NL=NL, dtype=dtype, free_p=free_p, free_l=free_l,
        has_pl=has_pl, pose_k=pose_k, lm_k=lm_k, use_woodbury=use_woodbury,
        chain=chain, chain_i=chain_i,
    )

    def lm_step(state):
        k, poses, lms, lam, nu, trace, cg_tot, done = state
        gk = g.with_poses(poses, lms)
        lin = pg.linearize_se2(gk, huber_delta)
        smv, precond, bs, recover_dl = build_schur_system(gk, lin, lam, consts)

        (dp,), cg_k, _ = pcg(
            smv, (bs,), precond, max_iters=cg_iters, rtol=cg_rtol
        )
        dp = dp * free_p[:, None]
        dl = recover_dl(dp)

        new_poses = poses + dp
        new_poses = new_poses.at[:, 2].set(lie.wrap_angle(new_poses[:, 2]))
        new_lms = lms + dl if NL else lms
        lin_new = pg.linearize_se2(g.with_poses(new_poses, new_lms), huber_delta)
        accept = jnp.isfinite(lin_new.chi2) & (lin_new.chi2 < lin.chi2)

        # Nielsen-style schedule: gentle shrink on accept, doubling penalty
        # streak on reject (recovers faster than fixed multipliers)
        lam_new = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-12),
                            jnp.minimum(lam * nu, 1e10))
        nu_new = jnp.where(accept, 2.0, jnp.minimum(nu * 2.0, 64.0))

        rel_drop = (lin.chi2 - lin_new.chi2) / jnp.maximum(lin.chi2, 1e-30)
        done_new = accept & (rel_drop < tol)
        done_new = done_new | ((~accept) & (lam >= 1e10))

        poses = jnp.where(accept, new_poses, poses)
        lms = jnp.where(accept, new_lms, lms) if NL else lms
        trace = trace.at[k + 1].set(jnp.where(accept, lin_new.chi2, lin.chi2))
        return (k + 1, poses, lms, lam_new, nu_new, trace, cg_tot + cg_k,
                done_new)

    def cond(state):
        k, *_, done = state
        return jnp.logical_and(k < iters, jnp.logical_not(done))

    init = (
        jnp.asarray(0, jnp.int32), g.poses, g.landmarks,
        jnp.asarray(lm_lambda0, dtype), jnp.asarray(2.0, dtype),
        trace0, jnp.asarray(0, jnp.int32), jnp.asarray(False),
    )
    k, poses, lms, lam, nu, trace, cg_tot, done = jax.lax.while_loop(
        cond, lm_step, init
    )
    # pad trace tail with the final chi2 so trace[-1] is always the result
    idx = jnp.arange(iters + 1)
    final = trace[k]
    trace = jnp.where(idx <= k, trace, final)
    return g.with_poses(poses, lms), SchurStats(trace, lam, cg_tot, k)
