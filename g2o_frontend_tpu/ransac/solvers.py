"""Closed-form weighted alignment solvers (minimal sets AND refinement fits).

JAX rework of the reference's ``ransac/alignment_*.h`` solver family
(``alignment_horn2d.h:12-24``, ``alignment_horn3d.h:10-23``,
``alignment_se2.h:9-17``, ``alignment_se3.h:9-16``,
``alignment_line2d_linear.h:21-30``, ``alignment_plane_linear.h:10-17``).
Each solver here is a *weighted* least-squares fit over a fixed-size batch of
correspondences: with a one-hot weight over a minimal set it reproduces the
reference's minimal-set solve; with inlier weights it is the refinement step.
All are branchless and `vmap`-able over a leading hypothesis axis — that is
what turns the reference's serial `computeMinimalSet` enumeration
(``ransac.h:130-158``) into a single batched kernel.

Each ``fit_*`` returns the transform mapping frame-2 quantities onto frame-1
(``p1 ≈ T ⊕ p2``), matching the reference convention (remapping the second
set, ``ransac.h`` error computation / ``alignment_test.cpp``).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils import lie

_EPS = 1e-9


def _top_eigvec4(M):
    """Dominant eigenvector of a symmetric PSD-shifted 4x4 via repeated
    squaring: M^(2^8) concentrates the spectrum far faster than plain power
    iteration (the shift needed for PSD-ness makes eigenvalue ratios ~1, so
    plain iteration stalls). Normalized after each squaring to avoid overflow."""
    for _ in range(8):
        M = M @ M
        M = M / jnp.maximum(jnp.sqrt(jnp.sum(M * M)), _EPS)
    q = M @ jnp.ones(4, M.dtype)
    # one more multiply for safety, then normalize
    q = M @ q
    return q / jnp.maximum(jnp.linalg.norm(q), _EPS)


# ---------------------------------------------------------------------------
# Point correspondences
# ---------------------------------------------------------------------------


def fit_se2_points(p1, p2, w):
    """Weighted Horn alignment in 2D: find [x,y,th] s.t. p1 ~ R(th) p2 + t.

    p1, p2: (N, 2); w: (N,). Closed form via centroids + atan2 of the
    weighted cross/dot sums (2-point minimal set = reference Horn2D).
    """
    wsum = jnp.maximum(jnp.sum(w), _EPS)
    c1 = jnp.sum(w[:, None] * p1, 0) / wsum
    c2 = jnp.sum(w[:, None] * p2, 0) / wsum
    q1 = p1 - c1
    q2 = p2 - c2
    s = jnp.sum(w * (q2[:, 0] * q1[:, 1] - q2[:, 1] * q1[:, 0]))
    c = jnp.sum(w * (q2[:, 0] * q1[:, 0] + q2[:, 1] * q1[:, 1]))
    th = jnp.arctan2(s, c)
    R = jnp.array([[jnp.cos(th), -jnp.sin(th)], [jnp.sin(th), jnp.cos(th)]])
    t = c1 - R @ c2
    return jnp.array([t[0], t[1], th])


def err_se2_points(x, p1, p2):
    """Squared residuals of p1 - (R p2 + t); (N,)."""
    pred = lie.se2_apply(x, p2)
    return jnp.sum((p1 - pred) ** 2, -1)


def fit_se3_points(p1, p2, w):
    """Weighted Kabsch/Horn in 3D -> 4x4 transform with p1 ~ R p2 + t.

    Uses the quaternion (Horn) method: largest eigenvector of the 4x4 N
    matrix via a few power iterations — avoids XLA's general SVD inside vmap.
    """
    wsum = jnp.maximum(jnp.sum(w), _EPS)
    c1 = jnp.sum(w[:, None] * p1, 0) / wsum
    c2 = jnp.sum(w[:, None] * p2, 0) / wsum
    q1 = p1 - c1
    q2 = p2 - c2
    S = jnp.einsum("n,ni,nj->ij", w, q2, q1)  # correlation (2 -> 1)
    tr = jnp.trace(S)
    A = S - S.T
    delta = jnp.array([A[1, 2], A[2, 0], A[0, 1]])
    N = jnp.zeros((4, 4), p1.dtype)
    N = N.at[0, 0].set(tr)
    N = N.at[0, 1:].set(delta)
    N = N.at[1:, 0].set(delta)
    N = N.at[1:, 1:].set(S + S.T - tr * jnp.eye(3, dtype=p1.dtype))
    # power iteration on (N + c I) to find the max eigenvector; eigenvalues
    # of N are within +-2*||S||, shift guarantees dominance.
    shift = 2.0 * jnp.sqrt(jnp.sum(S * S)) + 1e-6
    M = N + shift * jnp.eye(4, dtype=p1.dtype)
    q = _top_eigvec4(M)
    q = jnp.where(q[0] < 0, -q, q)
    R = lie.quat2mat(q[1:] / jnp.maximum(jnp.linalg.norm(q), _EPS))
    t = c1 - R @ c2
    T = jnp.eye(4, dtype=p1.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    return T


def err_se3_points(T, p1, p2):
    pred = p2 @ T[:3, :3].T + T[:3, 3]
    return jnp.sum((p1 - pred) ** 2, -1)


# ---------------------------------------------------------------------------
# Pose (vertex) correspondences
# ---------------------------------------------------------------------------


def fit_se2_poses(x1, x2, w):
    """SE2 from pose-pose correspondences: T s.t. x1_i ~ T ⊕ x2_i.

    Weighted chart average of the per-pair transforms T_i = x1_i ⊕ x2_i^{-1}
    (minimal set = 1, reference AlignmentAlgorithmSE2)."""
    import jax

    Ti = jax.vmap(lambda a, b: lie.se2_compose(a, lie.se2_inverse(b)))(x1, x2)
    wsum = jnp.maximum(jnp.sum(w), _EPS)
    t = jnp.sum(w[:, None] * Ti[:, :2], 0) / wsum
    s = jnp.sum(w * jnp.sin(Ti[:, 2])) / wsum
    c = jnp.sum(w * jnp.cos(Ti[:, 2])) / wsum
    return jnp.array([t[0], t[1], jnp.arctan2(s, c)])


def err_se2_poses(x, x1, x2):
    """Weighted chart distance of x1 vs x ⊕ x2 (rotation weighted 1:1)."""
    import jax

    pred = jax.vmap(lambda b: lie.se2_compose(x, b))(x2)
    d = x1 - pred
    dth = lie.wrap_angle(d[:, 2])
    return d[:, 0] ** 2 + d[:, 1] ** 2 + dth**2


def fit_se3_poses(T1, T2, w):
    """SE3 from pose-pose correspondences: T s.t. T1_i ~ T @ T2_i.

    Weighted average of T_i = T1_i T2_i^{-1}: translation arithmetic mean,
    rotation via the quaternion M-matrix eigenvector (power iteration)."""
    import jax

    Ti = jax.vmap(lambda A, B: A @ lie.se3_inverse(B))(T1, T2)
    wsum = jnp.maximum(jnp.sum(w), _EPS)
    t = jnp.sum(w[:, None] * Ti[:, :3, 3], 0) / wsum
    qs = jax.vmap(lambda T: lie.mat2quat_full(T[:3, :3]))(Ti)  # (N,4) wxyz
    Mq = jnp.einsum("n,ni,nj->ij", w, qs, qs)
    q = _top_eigvec4(Mq)
    q = jnp.where(q[0] < 0, -q, q)
    T = jnp.eye(4, dtype=T1.dtype)
    T = T.at[:3, :3].set(lie.quat2mat(q[1:]))
    T = T.at[:3, 3].set(t)
    return T


def err_se3_poses(T, T1, T2):
    import jax

    pred = jnp.einsum("ij,njk->nik", T, T2)
    d = jax.vmap(lambda A, B: lie.se3_log(lie.se3_inverse(A) @ B))(T1, pred)
    return jnp.sum(d * d, -1)


# ---------------------------------------------------------------------------
# Line2D correspondences (lines as [cos a, sin a, rho]: n.p = rho)
# ---------------------------------------------------------------------------


def fit_se2_lines(l1, l2, w):
    """SE2 from 2D line correspondences (reference RansacLine2DLinear).

    Lines are (nx, ny, rho) with unit normal, n.p = rho. Under x (R, t):
    n1 = R n2, rho1 = rho2 + n1 . t. Rotation from weighted normal average;
    translation from the weighted 2x2 normal system.
    """
    s = jnp.sum(w * (l2[:, 0] * l1[:, 1] - l2[:, 1] * l1[:, 0]))
    c = jnp.sum(w * (l2[:, 0] * l1[:, 0] + l2[:, 1] * l1[:, 1]))
    th = jnp.arctan2(s, c)
    R = jnp.array([[jnp.cos(th), -jnp.sin(th)], [jnp.sin(th), jnp.cos(th)]])
    n1_pred = l2[:, :2] @ R.T  # rotated normals
    # solve sum w n n^T t = sum w n (rho1 - rho2)
    A = jnp.einsum("n,ni,nj->ij", w, n1_pred, n1_pred) + _EPS * jnp.eye(2, dtype=l1.dtype)
    b = jnp.sum((w * (l1[:, 2] - l2[:, 2]))[:, None] * n1_pred, 0)
    t = jnp.linalg.solve(A, b)
    return jnp.array([t[0], t[1], th])


def err_se2_lines(x, l1, l2):
    """Angle + offset residual of remapped lines."""
    c, s = jnp.cos(x[2]), jnp.sin(x[2])
    R = jnp.array([[c, -s], [s, c]])
    n_pred = l2[:, :2] @ R.T
    rho_pred = l2[:, 2] + n_pred @ x[:2]
    # sign-invariant normal mismatch + rho difference
    dn = jnp.sum((l1[:, :2] - n_pred) ** 2, -1)
    drho = (l1[:, 2] - rho_pred) ** 2
    return dn + drho


# ---------------------------------------------------------------------------
# Plane correspondences (planes as [nx, ny, nz, d]: n.p = d)
# ---------------------------------------------------------------------------


def fit_se3_planes(pl1, pl2, w):
    """SE3 from plane correspondences (reference AlignmentAlgorithmPlaneLinear).

    Planes (n, d), unit n, n.p = d. Under T=(R,t): n1 = R n2,
    d1 = d2 + n1 . t. Rotation = weighted Wahba on normals via the
    quaternion method; translation from the weighted 3x3 normal system
    (needs >= 3 non-parallel planes; regularized otherwise).
    """
    n1 = pl1[:, :3]
    n2 = pl2[:, :3]
    S = jnp.einsum("n,ni,nj->ij", w, n2, n1)
    tr = jnp.trace(S)
    A = S - S.T
    delta = jnp.array([A[1, 2], A[2, 0], A[0, 1]])
    N = jnp.zeros((4, 4), pl1.dtype)
    N = N.at[0, 0].set(tr)
    N = N.at[0, 1:].set(delta)
    N = N.at[1:, 0].set(delta)
    N = N.at[1:, 1:].set(S + S.T - tr * jnp.eye(3, dtype=pl1.dtype))
    shift = 2.0 * jnp.sqrt(jnp.sum(S * S)) + 1e-6
    M = N + shift * jnp.eye(4, dtype=pl1.dtype)
    q = _top_eigvec4(M)
    q = jnp.where(q[0] < 0, -q, q)
    R = lie.quat2mat(q[1:] / jnp.maximum(jnp.linalg.norm(q), _EPS))
    n1_pred = n2 @ R.T
    A3 = jnp.einsum("n,ni,nj->ij", w, n1_pred, n1_pred) + 1e-6 * jnp.eye(
        3, dtype=pl1.dtype
    )
    b3 = jnp.sum((w * (pl1[:, 3] - pl2[:, 3]))[:, None] * n1_pred, 0)
    t = jnp.linalg.solve(A3, b3)
    T = jnp.eye(4, dtype=pl1.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    return T


def err_se3_planes(T, pl1, pl2):
    n_pred = pl2[:, :3] @ T[:3, :3].T
    d_pred = pl2[:, 3] + n_pred @ T[:3, 3]
    dn = jnp.sum((pl1[:, :3] - n_pred) ** 2, -1)
    dd = (pl1[:, 3] - d_pred) ** 2
    return dn + dd


# ---------------------------------------------------------------------------
# Line3D correspondences (Pluecker-lite: direction + a point on the line)
# ---------------------------------------------------------------------------


def fit_se3_lines(l1, l2, w):
    """SE3 from 3D line correspondences (reference alignment_line3d_linear).

    Lines given as (dir(3), point(3)); rotation aligns directions (Wahba),
    translation minimizes point-to-line distances of remapped points:
    sum w (I - d d^T) (p2' + t - p1) = 0.
    """
    d1 = l1[:, :3]
    d2 = l2[:, :3]
    p1 = l1[:, 3:6]
    p2 = l2[:, 3:6]
    S = jnp.einsum("n,ni,nj->ij", w, d2, d1)
    tr = jnp.trace(S)
    A = S - S.T
    delta = jnp.array([A[1, 2], A[2, 0], A[0, 1]])
    N = jnp.zeros((4, 4), l1.dtype)
    N = N.at[0, 0].set(tr)
    N = N.at[0, 1:].set(delta)
    N = N.at[1:, 0].set(delta)
    N = N.at[1:, 1:].set(S + S.T - tr * jnp.eye(3, dtype=l1.dtype))
    shift = 2.0 * jnp.sqrt(jnp.sum(S * S)) + 1e-6
    M = N + shift * jnp.eye(4, dtype=l1.dtype)
    q = _top_eigvec4(M)
    q = jnp.where(q[0] < 0, -q, q)
    R = lie.quat2mat(q[1:] / jnp.maximum(jnp.linalg.norm(q), _EPS))
    # projector onto the plane orthogonal to line-1 direction
    P = jnp.eye(3, dtype=l1.dtype)[None] - jnp.einsum("ni,nj->nij", d1, d1)
    A3 = jnp.einsum("n,nij->ij", w, P) + 1e-6 * jnp.eye(3, dtype=l1.dtype)
    rhs = jnp.einsum("n,nij,nj->i", w, P, p1 - p2 @ R.T)
    t = jnp.linalg.solve(A3, rhs)
    T = jnp.eye(4, dtype=l1.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    return T


def err_se3_lines(T, l1, l2):
    d_pred = l2[:, :3] @ T[:3, :3].T
    p_pred = l2[:, 3:6] @ T[:3, :3].T + T[:3, 3]
    # direction mismatch (sign-sensitive, directions assumed consistent)
    dd = jnp.sum((l1[:, :3] - d_pred) ** 2, -1)
    # point-to-line distance of predicted point to line 1
    dp = p_pred - l1[:, 3:6]
    along = jnp.sum(dp * l1[:, :3], -1)
    perp2 = jnp.sum(dp * dp, -1) - along**2
    return dd + jnp.maximum(perp2, 0.0)
