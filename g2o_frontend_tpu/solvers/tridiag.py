"""Block-tridiagonal solves via cyclic reduction — the chain preconditioner.

Pose graphs are odometry chains plus sparse off-chain couplings (loop
closures / co-observed landmarks). The block-tridiagonal part of the
(Schur-reduced) Hessian captures the chain's long-range stiffness that makes
plain block-Jacobi PCG stall (victoriaPark: chi2 stuck 6.4x above the
optimum for two rounds). The reference sidesteps the issue with a sparse
direct factorization (g2o + CHOLMOD, ``boss_map_building/map_g2o_reflector.h:50-74``,
``CMakeLists.txt:105-112``); on a device a sequential block-Thomas sweep would
serialize ~N tiny 3x3 ops, so we use **block cyclic reduction**: log2(N)
levels, each a fully-parallel batched 3x3 elimination over the remaining
even-indexed blocks — O(N) work, O(log N) depth, all batched
matmuls. Factor once per LM iteration, apply per CG iteration.

System: L[i] x[i-1] + D[i] x[i] + U[i] x[i+1] = r[i], with U[i] = L[i+1]^T
for symmetric problems (not assumed — L and U are stored independently).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CRFactor(NamedTuple):
    """Per-level elimination state (lists indexed by level, coarse last)."""

    dinv_odd: tuple  # level l: (N_l/2, d, d) inverses of odd diagonal blocks
    l_odd: tuple  # odd-row lower blocks (N_l/2, d, d)
    u_odd: tuple  # odd-row upper blocks (N_l/2, d, d)
    a: tuple  # even-row left multipliers  -L_even Dinv_{left odd}
    c: tuple  # even-row right multipliers -U_even Dinv_{right odd}
    dinv_root: jnp.ndarray  # (d, d)
    n: int  # original (padded) block count, power of two


def _pad_pow2(L, D, U):
    n = D.shape[0]
    m = 1 << max(1, (n - 1).bit_length())
    if m == n:
        return L, D, U, n
    d = D.shape[1]
    eye = jnp.broadcast_to(jnp.eye(d, dtype=D.dtype), (m - n, d, d))
    zero = jnp.zeros((m - n, d, d), D.dtype)
    return (
        jnp.concatenate([L, zero]),
        jnp.concatenate([D, eye]),
        jnp.concatenate([U, zero]),
        m,
    )


def cr_factor(L, D, U) -> CRFactor:
    """Factor a block-tridiagonal system for repeated solves.

    Args:
      L: (N, d, d) lower blocks; L[0] is ignored (no x[-1]).
      D: (N, d, d) diagonal blocks, assumed invertible (damped SPD in use).
      U: (N, d, d) upper blocks; U[N-1] is ignored.
    """
    L, D, U, n = _pad_pow2(L, D, U)
    dinv_odd, l_odd, u_odd, aa, cc = [], [], [], [], []
    d = D.shape[1]
    while D.shape[0] > 1:
        Do, Lo, Uo = D[1::2], L[1::2], U[1::2]
        De, Le, Ue = D[0::2], L[0::2], U[0::2]
        Dinv = jnp.linalg.inv(Do)
        m = De.shape[0]
        zero = jnp.zeros((1, d, d), D.dtype)
        # even row 2k: left odd neighbor is odd-index k-1, right is k
        dinv_left = jnp.concatenate([zero, Dinv[:-1]]) if m > 1 else zero
        a = -jnp.einsum("kij,kjl->kil", Le, dinv_left)
        c = -jnp.einsum("kij,kjl->kil", Ue, Dinv)
        u_left = jnp.concatenate([zero, Uo[:-1]]) if m > 1 else zero
        l_left = jnp.concatenate([zero, Lo[:-1]]) if m > 1 else zero
        Dn = De + jnp.einsum("kij,kjl->kil", a, u_left) + jnp.einsum(
            "kij,kjl->kil", c, Lo
        )
        Ln = jnp.einsum("kij,kjl->kil", a, l_left)
        Un = jnp.einsum("kij,kjl->kil", c, Uo)
        dinv_odd.append(Dinv)
        l_odd.append(Lo)
        u_odd.append(Uo)
        aa.append(a)
        cc.append(c)
        L, D, U = Ln, Dn, Un
    return CRFactor(
        tuple(dinv_odd), tuple(l_odd), tuple(u_odd), tuple(aa), tuple(cc),
        jnp.linalg.inv(D[0]), n,
    )


def cr_solve(f: CRFactor, r):
    """Solve the factored system.

    Args:
      r: rhs of shape (N0, d) or (N0, d, m) for m simultaneous right-hand
         sides (batched matmuls — used to build low-rank Woodbury
         corrections); N0 <= f.n.
    """
    squeeze = r.ndim == 2
    if squeeze:
        r = r[..., None]
    n0, d, m = r.shape
    if n0 < f.n:
        r = jnp.concatenate([r, jnp.zeros((f.n - n0, d, m), r.dtype)])
    # down-sweep: reduce rhs level by level (keep each level's odd rhs)
    r_odds = []
    for a, c in zip(f.a, f.c):
        ro, re = r[1::2], r[0::2]
        r_odds.append(ro)
        zero = jnp.zeros((1, d, m), r.dtype)
        ro_left = jnp.concatenate([zero, ro[:-1]]) if re.shape[0] > 1 else zero
        r = re + jnp.einsum("kij,kjm->kim", a, ro_left) + jnp.einsum(
            "kij,kjm->kim", c, ro
        )
    x = (f.dinv_root @ r[0])[None]
    # up-sweep: recover odd unknowns, interleave with even
    for dinv, lo, uo, ro in zip(
        reversed(f.dinv_odd), reversed(f.l_odd), reversed(f.u_odd),
        reversed(r_odds),
    ):
        # odd 2k+1: left even neighbor x[k], right even neighbor x[k+1]
        x_right = jnp.concatenate([x[1:], jnp.zeros((1, d, m), x.dtype)])
        xo = jnp.einsum(
            "kij,kjm->kim",
            dinv,
            ro
            - jnp.einsum("kij,kjm->kim", lo, x)
            - jnp.einsum("kij,kjm->kim", uo, x_right),
        )
        x = jnp.stack([x, xo], axis=1).reshape(-1, d, m)
    x = x[:n0]
    return x[..., 0] if squeeze else x


def tridiag_solve(L, D, U, r):
    """One-shot factor + solve (N, d) rhs."""
    return cr_solve(cr_factor(L, D, U), r)
