"""Image-organized point-with-normal clouds, stored channel-planar.

The reference `pwn::Cloud` (``pwn_core/cloud.h:20-171``) is a compacted
array-of-structs: points, normals, per-point Stats (eigenvectors/values,
curvature), and two information-matrix vectors, with an index image mapping
pixels to array slots. Here the cloud stays *image-organized*: every
per-point quantity is an array aligned with the depth image, and invalid
pixels are masked instead of compacted (SURVEY.md §7 hard-part 2).

Storage is CHANNEL-PLANAR: trailing dims of 3 or (3, 3) would make every
elementwise op stride over tiny minor dims. Vectors live as (3, H, W) planes, symmetric matrices
as their (6, H, W) upper triangle (see ops/sym6.py), eigenvector frames as
(9, H, W) with channel 3*k+i = component i of eigenvector k. Trailing-layout
views (``points`` (H, W, 3), ``omega_p`` (H, W, 3, 3), ...) are provided as
properties for host-side consumers; the hot paths read the planes directly.

A `Cloud` is a pytree and flows through jit/vmap; `transform()` returns a new
cloud (the analog of ``Cloud::transformInPlace``, ``cloud.cpp``).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..ops import sym6


class Cloud(NamedTuple):
    """Per-pixel point-with-normal data (channel-planar).

    Attributes:
      p:     (3, H, W) 3D points in the cloud frame.
      n:     (3, H, W) unit normals; zero where undefined (the reference
             zeroes normals of high-curvature points,
             ``statscalculatorintegralimage.cpp:75-80``).
      curv:  (H, W) lam0/(lam0+lam1+lam2) surface curvature.
      ev:    (3, H, W) ascending local-covariance eigenvalues.
      evec:  (9, H, W) eigenvector frame; channel 3*k+i = component i of the
             k-th (ascending-eigenvalue) eigenvector.
      op:    (6, H, W) sym6 point information matrices
             (``informationmatrixcalculator.cpp:9-37``).
      on:    (6, H, W) sym6 normal information matrices (``:39-59``).
      valid: (H, W) bool — pixel has a valid unprojected point.
    """

    p: jnp.ndarray
    n: jnp.ndarray
    curv: jnp.ndarray
    ev: jnp.ndarray
    evec: jnp.ndarray
    op: jnp.ndarray
    on: jnp.ndarray
    valid: jnp.ndarray

    # -- trailing-layout compatibility views --------------------------------
    @property
    def points(self):
        """(H, W, 3) points (trailing-layout view)."""
        return jnp.moveaxis(self.p, 0, -1)

    @property
    def normals(self):
        """(H, W, 3) normals (trailing-layout view)."""
        return jnp.moveaxis(self.n, 0, -1)

    @property
    def curvature(self):
        """(H, W) curvature."""
        return self.curv

    @property
    def eigenvalues(self):
        """(H, W, 3) ascending eigenvalues (trailing-layout view)."""
        return jnp.moveaxis(self.ev, 0, -1)

    @property
    def eigenvectors(self):
        """(H, W, 3, 3) columns = eigenvectors (trailing-layout view)."""
        V = self.evec.reshape((3, 3) + self.evec.shape[1:])  # [k, i, H, W]
        return jnp.moveaxis(V, (0, 1), (-1, -2))

    @property
    def omega_p(self):
        """(H, W, 3, 3) point information matrices (trailing-layout view)."""
        return sym6.sym_mat(self.op)

    @property
    def omega_n(self):
        """(H, W, 3, 3) normal information matrices (trailing-layout view)."""
        return sym6.sym_mat(self.on)

    @property
    def shape(self):
        return self.p.shape[1:]

    def transform(self, T) -> "Cloud":
        """Apply a 4x4 rigid transform to all geometric quantities."""
        R = T[:3, :3]
        t = T[:3, 3]
        pts = jnp.stack(sym6.rot_apply(R, self.p)) + t[:, None, None]
        nrm = jnp.stack(sym6.rot_apply(R, self.n))
        evec = jnp.concatenate(
            [jnp.stack(sym6.rot_apply(R, self.evec[3 * k : 3 * k + 3]))
             for k in range(3)]
        )
        op = sym6.sym_rotate(R, self.op)
        on = sym6.sym_rotate(R, self.on)
        return self._replace(p=pts, n=nrm, evec=evec, op=op, on=on)

    def n_valid(self):
        return jnp.sum(self.valid)
