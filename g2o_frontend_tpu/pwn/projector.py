"""Pinhole (and cylindrical) point projectors.

JAX analog of ``pwn_core/pinholepointprojector.{h,cpp}`` and
``cylindricalpointprojector.h``:

- `unproject`: depth image -> (H, W, 3) points + validity (vectorized version
  of ``pinholepointprojector.cpp:69-108`` unProject).
- `project`: point set -> depth + pixel "index image" with z-buffering.  The
  reference resolves depth collisions with a serial min race
  (``pinholepointprojector.cpp:52-65``); here it is two deterministic
  scatter passes: scatter-min of depth, then winner election by equality —
  race-free and O(N) on chip (SURVEY.md §7 hard-part 1).
- `project_intervals`: per-pixel integration radius for a world-space radius
  at each depth (``pinholepointprojector.cpp:110-150`` projectIntervals).

The projector is a frozen dataclass of static floats so it can close over
jitted functions without retracing on value changes that matter (image size)
while camera parameters stay traced arrays where useful.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class PinholeProjector:
    """Intrinsics + depth gates. fx, fy, cx, cy in pixels; distances meters."""

    rows: int
    cols: int
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    min_distance: float = 0.01
    max_distance: float = 6.0

    def scaled(self, s: int) -> "PinholeProjector":
        """Downscale intrinsics by integer factor s (reference
        ``pinholepointprojector.h`` scale(), used by PwnMatcherBase scale=4)."""
        return PinholeProjector(
            rows=self.rows // s,
            cols=self.cols // s,
            fx=self.fx / s,
            fy=self.fy / s,
            cx=self.cx / s,
            cy=self.cy / s,
            min_distance=self.min_distance,
            max_distance=self.max_distance,
        )

    # -- depth -> points ----------------------------------------------------
    def unproject(self, depth):
        """depth (H, W) -> points (H, W, 3), valid (H, W)."""
        H, W = self.rows, self.cols
        v = jnp.arange(H, dtype=depth.dtype)[:, None]
        u = jnp.arange(W, dtype=depth.dtype)[None, :]
        z = depth
        x = (u - self.cx) / self.fx * z
        y = (v - self.cy) / self.fy * z
        pts = jnp.stack([jnp.broadcast_to(x, (H, W)), jnp.broadcast_to(y, (H, W)), z], -1)
        valid = (z > self.min_distance) & (z < self.max_distance) & jnp.isfinite(z)
        return jnp.where(valid[..., None], pts, 0.0), valid

    # -- points -> pixels ---------------------------------------------------
    def pixel_of(self, points):
        """points (..., 3) -> (u, v, d) continuous pixel coords + depth."""
        d = points[..., 2]
        u = points[..., 0] / d * self.fx + self.cx
        v = points[..., 1] / d * self.fy + self.cy
        return u, v, d

    def project(self, points, valid):
        """Render a point set to (depth (H,W), index (H,W) int32).

        index[i,j] = flat index (into points.reshape(-1,3)) of the nearest
        point hitting that pixel, or -1.  Two-pass deterministic z-buffer:
        scatter-min depths, then scatter the max point-id among depth winners.
        """
        H, W = self.rows, self.cols
        pts = points.reshape(-1, 3)
        ok = valid.reshape(-1)
        u, v, d = self.pixel_of(pts)
        ui = jnp.round(u).astype(jnp.int32)
        vi = jnp.round(v).astype(jnp.int32)
        inside = (
            ok
            & (d > self.min_distance)
            & (d < self.max_distance)
            & (ui >= 0)
            & (ui < W)
            & (vi >= 0)
            & (vi < H)
        )
        flat_pix = jnp.where(inside, vi * W + ui, H * W)  # overflow slot
        big = jnp.asarray(jnp.inf, d.dtype)
        dmin = jnp.full(H * W + 1, big, d.dtype).at[flat_pix].min(
            jnp.where(inside, d, big)
        )
        # winner election: the largest point index whose depth equals the min
        is_winner = inside & (d <= dmin[flat_pix] * (1.0 + 1e-7))
        ids = jnp.arange(pts.shape[0], dtype=jnp.int32)
        idx = jnp.full(H * W + 1, -1, jnp.int32).at[flat_pix].max(
            jnp.where(is_winner, ids, -1)
        )
        depth_img = jnp.where(jnp.isfinite(dmin[: H * W]), dmin[: H * W], 0.0)
        return depth_img.reshape(H, W), idx[: H * W].reshape(H, W)

    def project_intervals(self, depth, world_radius):
        """Per-pixel half-window (pixels) covering world_radius at each depth.

        Reference ``projectIntervals`` maps a metric ball to its pixel
        footprint; -1 (here: 0 radius) where depth invalid."""
        r = jnp.where(
            depth > self.min_distance,
            jnp.ceil(world_radius * self.fx / jnp.maximum(depth, 1e-6)),
            0.0,
        )
        return r.astype(jnp.int32)


@dataclass(frozen=True)
class MultiProjector:
    """Composite projector: sub-projectors stacked along image columns.

    Analog of ``pwn_core/multipointprojector.h:7-14`` (a rig of cameras
    rendered side-by-side). Each child owns a column band of the composite
    image and a rigid mounting transform (child <- rig frame).
    `projectors` is a tuple of (projector, transform 4x4 tuple) pairs; all
    children must share `rows`.
    """

    projectors: tuple  # ((PinholeProjector, 16-float transform tuple), ...)

    @property
    def rows(self):
        return self.projectors[0][0].rows

    @property
    def cols(self):
        return sum(p.cols for p, _ in self.projectors)

    def _transforms(self):
        import numpy as np

        return [np.asarray(t, float).reshape(4, 4) for _, t in self.projectors]

    def unproject(self, depth):
        """Composite depth -> points in the RIG frame."""
        outs, vals = [], []
        c0 = 0
        for (p, t) in self.projectors:
            T = jnp.asarray(jnp.reshape(jnp.asarray(t), (4, 4)), depth.dtype)
            pts, valid = p.unproject(depth[:, c0 : c0 + p.cols])
            pts = jnp.einsum("ij,hwj->hwi", T[:3, :3], pts) + T[:3, 3]
            pts = jnp.where(valid[..., None], pts, 0.0)
            outs.append(pts)
            vals.append(valid)
            c0 += p.cols
        return jnp.concatenate(outs, axis=1), jnp.concatenate(vals, axis=1)

    def project(self, points, valid):
        """Rig-frame points -> composite (depth, index) image."""
        depths, idxs = [], []
        for (p, t) in self.projectors:
            T = jnp.reshape(jnp.asarray(t, points.dtype), (4, 4))
            Ri = T[:3, :3].T
            ti = -Ri @ T[:3, 3]
            local = jnp.einsum("ij,...j->...i", Ri, points) + ti
            d, idx = p.project(local, valid)
            depths.append(d)
            idxs.append(idx)
        return jnp.concatenate(depths, axis=1), jnp.concatenate(idxs, axis=1)

    def project_intervals(self, depth, world_radius):
        outs = []
        c0 = 0
        for (p, _) in self.projectors:
            outs.append(p.project_intervals(depth[:, c0 : c0 + p.cols], world_radius))
            c0 += p.cols
        return jnp.concatenate(outs, axis=1)


@dataclass(frozen=True)
class CylindricalProjector:
    """Cylindrical projector (reference ``cylindricalpointprojector.h:13``):
    columns map to azimuth, rows to elevation-scaled y/r."""

    rows: int
    cols: int
    angular_fov: float = float(np.pi)  # half-fov in radians
    angular_resolution: float = 0.0  # cols per radian; 0 -> cols/(2*fov)
    vertical_focal: float = 200.0
    vertical_center: float = 0.5  # fraction of rows
    min_distance: float = 0.01
    max_distance: float = 6.0

    def _ares(self):
        return self.angular_resolution or self.cols / (2 * self.angular_fov)

    def pixel_of(self, points):
        x, y, z = points[..., 0], points[..., 1], points[..., 2]
        theta = jnp.arctan2(x, z)
        r = jnp.sqrt(x * x + z * z)
        u = theta * self._ares() + self.cols * 0.5
        v = y / jnp.maximum(r, 1e-9) * self.vertical_focal + self.rows * self.vertical_center
        return u, v, r

    def unproject(self, depth):
        H, W = self.rows, self.cols
        vv = jnp.arange(H, dtype=depth.dtype)[:, None]
        uu = jnp.arange(W, dtype=depth.dtype)[None, :]
        theta = (uu - W * 0.5) / self._ares()
        r = depth
        x = jnp.broadcast_to(jnp.sin(theta), (H, W)) * r
        z = jnp.broadcast_to(jnp.cos(theta), (H, W)) * r
        y = (vv - H * self.vertical_center) / self.vertical_focal * r
        pts = jnp.stack([x, y, z], -1)
        valid = (r > self.min_distance) & (r < self.max_distance) & jnp.isfinite(r)
        return jnp.where(valid[..., None], pts, 0.0), valid

    def project(self, points, valid):
        H, W = self.rows, self.cols
        pts = points.reshape(-1, 3)
        ok = valid.reshape(-1)
        u, v, d = self.pixel_of(pts)
        ui = jnp.round(u).astype(jnp.int32)
        vi = jnp.round(v).astype(jnp.int32)
        inside = (
            ok
            & (d > self.min_distance)
            & (d < self.max_distance)
            & (ui >= 0)
            & (ui < W)
            & (vi >= 0)
            & (vi < H)
        )
        flat_pix = jnp.where(inside, vi * W + ui, H * W)
        big = jnp.asarray(jnp.inf, d.dtype)
        dmin = jnp.full(H * W + 1, big, d.dtype).at[flat_pix].min(
            jnp.where(inside, d, big)
        )
        is_winner = inside & (d <= dmin[flat_pix] * (1.0 + 1e-7))
        ids = jnp.arange(pts.shape[0], dtype=jnp.int32)
        idx = jnp.full(H * W + 1, -1, jnp.int32).at[flat_pix].max(
            jnp.where(is_winner, ids, -1)
        )
        depth_img = jnp.where(jnp.isfinite(dmin[: H * W]), dmin[: H * W], 0.0)
        return depth_img.reshape(H, W), idx[: H * W].reshape(H, W)

    def project_intervals(self, depth, world_radius):
        r = jnp.where(
            depth > self.min_distance,
            jnp.ceil(world_radius * self._ares() / jnp.maximum(depth, 1e-6)),
            0.0,
        )
        return r.astype(jnp.int32)
