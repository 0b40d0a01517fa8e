"""Closed-form symmetric 3x3 eigendecomposition, batched and jit-safe.

The reference computes per-pixel surface normals/curvatures by an
eigendecomposition of 3x3 point-covariance matrices
(``pwn_core/statscalculatorintegralimage.cpp:14-84`` uses Eigen's
SelfAdjointEigenSolver per pixel). Calling XLA's general `eigh` per pixel
would serialize; instead we use the analytic trigonometric solution
(Smith's method) for eigenvalues plus cross-product eigenvectors — pure
element-wise math that vmaps/fuses over entire images.

All functions take (..., 3, 3) symmetric inputs and are fully branchless.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "eigh3x3",
    "eigvals3x3",
    "smallest_eigenvector3x3",
    "eigvals3x3_planar",
    "eigh3x3_planar",
]

_EPS = 1e-12


def eigvals3x3(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending: (..., 3).

    Analytic method: shift by mean, scale, then the trigonometric solution of
    the characteristic cubic. Accurate to ~1e-6 relative for well-scaled
    inputs, exact for diagonal matrices.
    """
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0 + (
        a01 * a01 + a02 * a02 + a12 * a12
    ) / 3.0
    p = jnp.sqrt(p2 + _EPS)

    # det(B)/2 with B = A - q I
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = jnp.clip(detB / (2.0 * p * p * p + _EPS), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0

    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return jnp.stack([e_lo, e_mid, e_hi], axis=-1)


def _eigenvector_for(A, lam, fallback):
    """Eigenvector of symmetric A for eigenvalue lam via row cross products.

    For B = A - lam I (rank 2 generically), the eigenvector is the null
    direction, computed as the largest cross product among B's row pairs.
    `fallback` is used if all cross products vanish (isotropic A).
    """
    B = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    # branchless 3-way max select: two where-selects instead of a
    # take_along_axis gather
    v = jnp.where((n01 >= n02)[..., None], c01, c02)
    nbest = jnp.maximum(n01, n02)
    v = jnp.where((n12 > nbest)[..., None], c12, v)
    nrm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    ok = nrm[..., 0] > 1e-10
    v = jnp.where(ok[..., None], v / jnp.maximum(nrm, _EPS), fallback)
    return v


def smallest_eigenvector3x3(A):
    """(eigenvalues asc, unit eigenvector of the smallest eigenvalue).

    This is the normal-extraction primitive: for a local point covariance the
    smallest-eigenvalue direction is the surface normal and
    ``lam0 / (lam0+lam1+lam2)`` the curvature (reference
    ``statscalculatorintegralimage.cpp:69-84``).
    """
    lam = eigvals3x3(A)
    fallback = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], dtype=A.dtype), A.shape[:-2] + (3,)
    )
    v0 = _eigenvector_for(A, lam[..., 0], fallback)
    return lam, v0


def eigh3x3(A):
    """Full decomposition: (eigenvalues asc (...,3), eigenvectors (...,3,3)).

    Columns of the returned matrix are unit eigenvectors matching the
    ascending eigenvalue order. The third vector is the cross product of the
    first two, guaranteeing a right-handed orthonormal frame.
    """
    lam = eigvals3x3(A)
    ex = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], A.dtype), A.shape[:-2] + (3,))
    ez = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], A.dtype), A.shape[:-2] + (3,))
    v0 = _eigenvector_for(A, lam[..., 0], ez)
    v1 = _eigenvector_for(A, lam[..., 1], ex)
    # Orthogonalize v1 against v0 (analytic vectors can drift when
    # eigenvalues are close), then complete the frame.
    v1 = v1 - jnp.sum(v1 * v0, axis=-1, keepdims=True) * v0
    n1 = jnp.linalg.norm(v1, axis=-1, keepdims=True)
    # Degenerate case: pick any vector orthogonal to v0.
    alt = jnp.cross(v0, ez)
    alt_n = jnp.linalg.norm(alt, axis=-1, keepdims=True)
    alt2 = jnp.cross(v0, ex)
    alt = jnp.where(alt_n > 1e-6, alt, alt2)
    alt = alt / jnp.maximum(jnp.linalg.norm(alt, axis=-1, keepdims=True), _EPS)
    v1 = jnp.where(n1 > 1e-6, v1 / jnp.maximum(n1, _EPS), alt)
    v2 = jnp.cross(v0, v1)
    V = jnp.stack([v0, v1, v2], axis=-1)
    return lam, V


# ---- channel-planar variants (sym6 layout: (6, ...) upper triangle) --------
# Same math as above, but all per-pixel quantities are leading-channel
# planes — the planar layout (see ops/sym6.py): no trailing dims of
# 3/(3,3) are ever materialized.


def _cross_t(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _dot_t(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def eigvals3x3_planar(o):
    """Eigenvalues of sym6 channels (6, ...) -> 3 ascending scalar planes."""
    xx, xy, xz, yy, yz, zz = (o[k] for k in range(6))
    q = (xx + yy + zz) / 3.0
    b00, b11, b22 = xx - q, yy - q, zz - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0 + (
        xy * xy + xz * xz + yz * yz
    ) / 3.0
    p = jnp.sqrt(p2 + _EPS)
    detB = (
        b00 * (b11 * b22 - yz * yz)
        - xy * (xy * b22 - yz * xz)
        + xz * (xy * yz - b11 * xz)
    )
    r = jnp.clip(detB / (2.0 * p * p * p + _EPS), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return e_lo, e_mid, e_hi


def _eigenvector_for_planar(o, lam, fallback):
    """Null direction of (A - lam I) via row cross products, channel-planar."""
    xx, xy, xz, yy, yz, zz = (o[k] for k in range(6))
    r0 = (xx - lam, xy, xz)
    r1 = (xy, yy - lam, yz)
    r2 = (xz, yz, zz - lam)
    c01 = _cross_t(r0, r1)
    c02 = _cross_t(r0, r2)
    c12 = _cross_t(r1, r2)
    n01 = _dot_t(c01, c01)
    n02 = _dot_t(c02, c02)
    n12 = _dot_t(c12, c12)
    sel = n01 >= n02
    v = tuple(jnp.where(sel, a, b) for a, b in zip(c01, c02))
    nbest = jnp.maximum(n01, n02)
    sel2 = n12 > nbest
    v = tuple(jnp.where(sel2, a, b) for a, b in zip(c12, v))
    nrm = jnp.sqrt(_dot_t(v, v))
    ok = nrm > 1e-10
    inv = 1.0 / jnp.maximum(nrm, _EPS)
    return tuple(jnp.where(ok, vk * inv, fk) for vk, fk in zip(v, fallback))


def eigh3x3_planar(o):
    """Full decomposition of sym6 channels (6, ...).

    Returns (lam, V_cols): lam = 3 ascending eigenvalue planes; V_cols =
    three 3-channel eigenvector tuples (right-handed orthonormal frame).
    """
    lam = eigvals3x3_planar(o)
    z = jnp.zeros_like(o[0])
    one = jnp.ones_like(o[0])
    ez = (z, z, one)
    ex = (one, z, z)
    v0 = _eigenvector_for_planar(o, lam[0], ez)
    v1 = _eigenvector_for_planar(o, lam[1], ex)
    # orthogonalize v1 against v0, with a degenerate-case fallback
    d = _dot_t(v1, v0)
    v1 = tuple(v1[k] - d * v0[k] for k in range(3))
    n1 = jnp.sqrt(_dot_t(v1, v1))
    alt = _cross_t(v0, ez)
    alt_n = jnp.sqrt(_dot_t(alt, alt))
    alt2 = _cross_t(v0, ex)
    alt = tuple(jnp.where(alt_n > 1e-6, a, b) for a, b in zip(alt, alt2))
    alt_inv = 1.0 / jnp.maximum(jnp.sqrt(_dot_t(alt, alt)), _EPS)
    alt = tuple(a * alt_inv for a in alt)
    ok1 = n1 > 1e-6
    inv1 = 1.0 / jnp.maximum(n1, _EPS)
    v1 = tuple(jnp.where(ok1, v1[k] * inv1, alt[k]) for k in range(3))
    v2 = _cross_t(v0, v1)
    return lam, (v0, v1, v2)
