"""Symmetric 3x3 matrices as 6 leading channels — the planar layout.

Per-pixel matrices stored as trailing (3, 3) dims make every elementwise
op stride over tiny minor dims.
Per-pixel symmetric matrices are therefore kept CHANNEL-PLANAR: a (6, H, W)
array whose leading channels are the upper triangle (xx, xy, xz, yy, yz, zz),
so all per-pixel algebra is elementwise over well-tiled (H, W) planes.

All functions below take/return leading-channel arrays (any trailing shape)
or tuples of channel planes; rotations are small dense (3, 3) matrices.
"""
from __future__ import annotations

import jax.numpy as jnp

# upper-triangle index pairs in channel order
IDX = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def sym_pack(M):
    """(..., 3, 3) symmetric -> (6, ...) channels."""
    return jnp.stack([M[..., i, j] for i, j in IDX], axis=0)


def sym_mat(o):
    """(6, ...) channels -> (..., 3, 3) full matrix."""
    xx, xy, xz, yy, yz, zz = (o[k] for k in range(6))
    row0 = jnp.stack([xx, xy, xz], axis=-1)
    row1 = jnp.stack([xy, yy, yz], axis=-1)
    row2 = jnp.stack([xz, yz, zz], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def sym_apply(o, v):
    """(6, ...) @ 3-channel vector -> 3-channel tuple."""
    xx, xy, xz, yy, yz, zz = (o[k] for k in range(6))
    return (
        xx * v[0] + xy * v[1] + xz * v[2],
        xy * v[0] + yy * v[1] + yz * v[2],
        xz * v[0] + yz * v[1] + zz * v[2],
    )


def sym_rotate(R, o):
    """R O R^T for a (3, 3) rotation and (6, ...) channels -> (6, ...)."""
    # w_l = O @ R[l, :] (3 channel-tuples), then O'_il = R[i, :] . w_l
    w = [sym_apply(o, (R[l, 0], R[l, 1], R[l, 2])) for l in range(3)]

    def entry(i, l):
        return R[i, 0] * w[l][0] + R[i, 1] * w[l][1] + R[i, 2] * w[l][2]

    return jnp.stack([entry(i, l) for i, l in IDX], axis=0)


def sym_from_diag_frame(V_cols, diag):
    """U diag(d) U^T -> (6, ...) channels.

    V_cols: three eigenvector 3-channel tuples (columns of U);
    diag: three scalar channels.
    """
    def entry(i, j):
        return sum(diag[k] * V_cols[k][i] * V_cols[k][j] for k in range(3))

    return jnp.stack([entry(i, j) for i, j in IDX], axis=0)


def rot_apply(R, v):
    """(3, 3) matrix applied to a 3-channel tuple -> 3-channel tuple."""
    return tuple(R[i, 0] * v[0] + R[i, 1] * v[1] + R[i, 2] * v[2] for i in range(3))
