"""Grid maps and correlative scan matching as batched cross-correlation.

JAX re-design of ``mapper/matcher/``:

- `GridMap` (``matcher/structures/gridmap.h``): dense (H, W) occupancy /
  likelihood array with world<->grid transforms.
- `ScanMatcher`'s kernel-convolved likelihood map
  (``matching/scan_matcher.h:14-82``): scatter scan hits, then a Gaussian
  smear — here a separable XLA convolution.
- `CorrelativeMatcher` (``matching/correlative_matcher.h:8-68``): the
  reference enumerates candidate (x, y, theta) cells in nested loops and
  scores each by walking scan points. Here the whole translational search
  for one rotation is ONE FFT cross-correlation (score(dx, dy) =
  sum_p map[p + d]), and rotations are a vmapped batch: K_theta FFTs replace
  millions of scalar probes. Multi-resolution refinement = rerun on a
  finer grid around the coarse argmax.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class GridSpec:
    """Dense world-anchored grid: world = origin + resolution * (col, row)."""

    rows: int
    cols: int
    resolution: float  # meters / cell
    origin_x: float
    origin_y: float

    def world_to_grid(self, pts):
        """(..., 2) world -> continuous (col, row)."""
        u = (pts[..., 0] - self.origin_x) / self.resolution
        v = (pts[..., 1] - self.origin_y) / self.resolution
        return u, v


def build_likelihood_map(points, valid, spec: GridSpec, sigma_cells: float = 1.0):
    """Scatter scan points into the grid and Gaussian-smear.

    The reference convolves a kernel around each hit
    (``scan_matcher.cpp`` convolve); here: one scatter-add + separable
    Gaussian blur (two small convs), normalized to max 1.
    """
    u, v = spec.world_to_grid(points)
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    inside = valid & (ui >= 0) & (ui < spec.cols) & (vi >= 0) & (vi < spec.rows)
    flat = jnp.where(inside, vi * spec.cols + ui, spec.rows * spec.cols)
    hits = (
        jnp.zeros(spec.rows * spec.cols + 1, points.dtype)
        .at[flat]
        .add(jnp.where(inside, 1.0, 0.0))[: spec.rows * spec.cols]
        .reshape(spec.rows, spec.cols)
    )
    hits = jnp.minimum(hits, 1.0)
    # separable Gaussian blur
    radius = max(1, int(3 * sigma_cells))
    x = jnp.arange(-radius, radius + 1, dtype=points.dtype)
    k = jnp.exp(-0.5 * (x / sigma_cells) ** 2)
    k = k / jnp.max(k)

    def blur_axis(img, axis):
        kernel = k.reshape((-1, 1) if axis == 0 else (1, -1))
        return jax.lax.conv_general_dilated(
            img[None, None],
            kernel[None, None],
            window_strides=(1, 1),
            padding="SAME",
        )[0, 0]

    m = blur_axis(hits, 0)
    m = blur_axis(m, 1)
    return jnp.minimum(m, 1.0)


class MatchResult(NamedTuple):
    pose: jnp.ndarray  # (3,) [x, y, theta] of scan frame in map frame
    score: jnp.ndarray  # () best correlation score
    scores_theta: jnp.ndarray  # (K,) best score per rotation


def _render_scan(points, valid, spec: GridSpec):
    u, v = spec.world_to_grid(points)
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    inside = valid & (ui >= 0) & (ui < spec.cols) & (vi >= 0) & (vi < spec.rows)
    flat = jnp.where(inside, vi * spec.cols + ui, spec.rows * spec.cols)
    img = (
        jnp.zeros(spec.rows * spec.cols + 1, points.dtype)
        .at[flat]
        .add(jnp.where(inside, 1.0, 0.0))[: spec.rows * spec.cols]
        .reshape(spec.rows, spec.cols)
    )
    return jnp.minimum(img, 1.0)


@partial(jax.jit, static_argnames=("spec", "search_radius_cells"))
def correlative_match(
    likelihood_map,
    scan_points,
    scan_valid,
    spec: GridSpec,
    thetas,
    search_radius_cells: int = 32,
    translation_prior=None,
):
    """Exhaustive (x, y, theta) search via FFT correlation per rotation.

    Args:
      likelihood_map: (H, W) from `build_likelihood_map` (reference scan/map).
      scan_points: (N, 2) current scan in its own frame.
      thetas: (K,) candidate rotations.
      search_radius_cells: max |dx|,|dy| in cells considered valid.
      translation_prior: optional (2,) predicted translation; the shift
        search then covers prior +- radius instead of 0 +- radius (needed
        when the scan pose is far from the map frame origin).

    Returns MatchResult with the best [x, y, theta].
    """
    H, W = spec.rows, spec.cols
    Fmap = jnp.fft.rfft2(likelihood_map)
    prior = (
        jnp.zeros(2, likelihood_map.dtype)
        if translation_prior is None
        else jnp.asarray(translation_prior, likelihood_map.dtype)
    )

    def score_theta(th):
        c, s = jnp.cos(th), jnp.sin(th)
        R = jnp.array([[c, -s], [s, c]])
        pts = scan_points @ R.T + prior
        img = _render_scan(pts, scan_valid, spec)
        # circular cross-correlation: corr[dy, dx] = sum img[y, x] map[y+dy, x+dx]
        corr = jnp.fft.irfft2(Fmap * jnp.conj(jnp.fft.rfft2(img)), s=(H, W))
        return corr

    corrs = jax.vmap(score_theta)(thetas)  # (K, H, W)
    # restrict shifts to +-search_radius (wrap-around indices)
    r = search_radius_cells
    dy = jnp.concatenate([jnp.arange(0, r + 1), jnp.arange(H - r, H)])
    dx = jnp.concatenate([jnp.arange(0, r + 1), jnp.arange(W - r, W)])
    sub = corrs[:, dy[:, None], dx[None, :]]  # (K, 2r+1, 2r+1)
    scores_theta = jnp.max(sub, axis=(1, 2))
    k_best = jnp.argmax(scores_theta)
    flat = jnp.argmax(sub[k_best])
    ny, nx = sub.shape[1], sub.shape[2]
    iy, ix = flat // nx, flat % nx
    sy = jnp.where(dy[iy] > H // 2, dy[iy] - H, dy[iy])
    sx = jnp.where(dx[ix] > W // 2, dx[ix] - W, dx[ix])
    # map[y+dy, x+dx] pairing img[y, x]: scan cell (x, y) matches map cell
    # (x+sx, y+sy) -> scan frame is translated by +s in grid units
    tx = sx * spec.resolution + prior[0]
    ty = sy * spec.resolution + prior[1]
    pose = jnp.array([tx, ty, thetas[k_best]], likelihood_map.dtype)
    return MatchResult(pose, scores_theta[k_best], scores_theta)


@partial(
    jax.jit,
    static_argnames=("spec", "search_radius_cells", "coarse_factor"),
)
def correlative_match_multires(
    likelihood_map,
    scan_points,
    scan_valid,
    spec: GridSpec,
    thetas,
    search_radius_cells: int = 32,
    translation_prior=None,
    coarse_factor: int = 4,
):
    """Coarse-to-fine correlative search (the reference's multi-level
    ``CorrelativeMatcher`` idea, ``matching/correlative_matcher.h:8-68``).

    Level 1: the FFT sweep of `correlative_match` on a max-pooled grid at
    `coarse_factor` x the resolution — 1/f^2 of the FFT work, and max-pool
    guarantees the coarse score upper-bounds the fine score (no lost peak).
    Level 2: exact fine scores in a (2f+3)-cell window around the coarse
    argmax, per rotation, computed directly as sum img[c] * map[c + s] over
    the scan's occupied cells (identical semantics to the FFT correlation,
    including duplicate-cell collapsing). Returns the same MatchResult.
    """
    f = coarse_factor
    H, W = spec.rows, spec.cols
    Hc, Wc = H // f, W // f
    prior = (
        jnp.zeros(2, likelihood_map.dtype)
        if translation_prior is None
        else jnp.asarray(translation_prior, likelihood_map.dtype)
    )
    coarse_spec = GridSpec(rows=Hc, cols=Wc, resolution=spec.resolution * f,
                           origin_x=spec.origin_x, origin_y=spec.origin_y)
    coarse_map = jax.lax.reduce_window(
        likelihood_map[: Hc * f, : Wc * f], -jnp.inf, jax.lax.max,
        (f, f), (f, f), "VALID",
    )
    coarse = correlative_match(
        coarse_map, scan_points, scan_valid, coarse_spec, thetas,
        search_radius_cells=max(1, -(-search_radius_cells // f)),
        translation_prior=prior,
    )

    # ---- fine refinement around the coarse translation, all rotations ----
    # half-width 2f+1: the max-pool peak localizes to one coarse cell, but
    # the true fine peak can sit in a neighbouring coarse cell when the
    # pooled maxima tie — cover a full coarse cell on each side
    w = 2 * f + 1
    base = coarse.pose[:2]

    # occupied-cell weights: img[c] = min(hits[c], 1) shared among the
    # points that hit c -> per-point weight 1/hits[c]
    def fine_theta(th):
        c, s = jnp.cos(th), jnp.sin(th)
        R = jnp.array([[c, -s], [s, c]])
        pts = scan_points @ R.T + base
        u, v = spec.world_to_grid(pts)
        ui = jnp.round(u).astype(jnp.int32)
        vi = jnp.round(v).astype(jnp.int32)
        ins = scan_valid & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        flat = jnp.where(ins, vi * W + ui, H * W)
        hits = jnp.zeros(H * W + 1, likelihood_map.dtype).at[flat].add(
            jnp.where(ins, 1.0, 0.0)
        )
        wgt = jnp.where(ins, 1.0 / jnp.maximum(hits[flat], 1.0), 0.0)

        def score_shift(dv, du):
            uu = jnp.clip(ui + du, 0, W - 1)
            vv = jnp.clip(vi + dv, 0, H - 1)
            ok = ins & (ui + du >= 0) & (ui + du < W) & (vi + dv >= 0) & (
                vi + dv < H
            )
            return jnp.sum(
                jnp.where(ok, wgt * likelihood_map[vv, uu], 0.0)
            )

        dvs = jnp.arange(-w, w + 1)
        return jax.vmap(
            lambda dv: jax.vmap(lambda du: score_shift(dv, du))(dvs)
        )(dvs)

    scores = jax.vmap(fine_theta)(thetas)  # (K, 2w+1, 2w+1)
    scores_theta = jnp.max(scores, axis=(1, 2))
    k_best = jnp.argmax(scores_theta)
    flat = jnp.argmax(scores[k_best])
    n = 2 * w + 1
    iy, ix = flat // n, flat % n
    tx = base[0] + (ix - w) * spec.resolution
    ty = base[1] + (iy - w) * spec.resolution
    pose = jnp.array([tx, ty, thetas[k_best]], likelihood_map.dtype)
    return MatchResult(pose, scores_theta[k_best], scores_theta)
