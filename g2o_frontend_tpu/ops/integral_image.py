"""Integral images (summed-area tables) for windowed point statistics.

JAX analog of ``pwn_core/pointintegralimage.{h,cpp}`` +
``statscalculatorintegralimage.cpp``: the reference accumulates, per pixel, a
9-channel integral image of (p, p p^T outer products, count) and reads
rectangular window sums to get local point means/covariances in O(1).

Here the integral image is two `cumsum`s (row + column) — a memory-bound
XLA op that fuses well — and the windowed sum is a 4-corner gather expressed
as static slices of the padded table, which XLA lowers to cheap dynamic
slices instead of scatter/gather.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["integral_image", "window_sums", "window_sums_fixed", "window_sums_quantized", "window_moments"]


def integral_image(x):
    """Summed-area table with a leading zero row/col.

    x: (H, W, C) -> (H+1, W+1, C) with
    ``I[i, j] = sum(x[:i, :j])`` so window sums are exclusive-inclusive.
    """
    s = jnp.cumsum(jnp.cumsum(x, axis=0), axis=1)
    H, W = x.shape[0], x.shape[1]
    out = jnp.zeros((H + 1, W + 1) + x.shape[2:], dtype=x.dtype)
    return out.at[1:, 1:].set(s)


def window_sums(I, radii):
    """Per-pixel windowed sums from an integral image.

    Args:
      I: (H+1, W+1, C) integral image.
      radii: (H, W) int32 per-pixel half-window (the reference uses a
        per-pixel radius shrinking with depth, ``statscalculator...cpp:33-50``)
        OR a scalar int for a uniform window.

    Returns:
      (H, W, C) sums over the clipped window ``[i-r, i+r] x [j-r, j+r]``.
    """
    H, W = I.shape[0] - 1, I.shape[1] - 1
    rows = jnp.arange(H)[:, None]
    cols = jnp.arange(W)[None, :]
    r = jnp.asarray(radii)
    r0 = jnp.clip(rows - r, 0, H)
    r1 = jnp.clip(rows + r + 1, 0, H)
    c0 = jnp.clip(cols - r, 0, W)
    c1 = jnp.clip(cols + r + 1, 0, W)
    r0b, r1b = jnp.broadcast_to(r0, (H, W)), jnp.broadcast_to(r1, (H, W))
    c0b, c1b = jnp.broadcast_to(c0, (H, W)), jnp.broadcast_to(c1, (H, W))
    # 4-corner lookup
    a = I[r1b, c1b]
    b = I[r0b, c1b]
    c = I[r1b, c0b]
    d = I[r0b, c0b]
    return a - b - c + d


def window_sums_fixed(I, r: int):
    """Window sums for a single static radius via shifted slices (no gather).

    Clamped-window semantics identical to `window_sums` but expressed as four
    statically-shifted slices of an edge-padded table — pure elementwise
    adds, no gather.
    """
    H, W = I.shape[0] - 1, I.shape[1] - 1
    pad = [(r, r), (r, r)] + [(0, 0)] * (I.ndim - 2)
    Ip = jnp.pad(I, pad, mode="edge")
    s = 2 * r + 1
    c1 = Ip[s : s + H, s : s + W]
    c2 = Ip[0:H, s : s + W]
    c3 = Ip[s : s + H, 0:W]
    c4 = Ip[0:H, 0:W]
    return c1 - c2 - c3 + c4


def window_sums_quantized(I, radii, levels):
    """Per-pixel window sums with radii quantized to static `levels`.

    Each pixel uses the smallest level >= its requested radius (largest level
    if none). Replaces the per-pixel-exact gather path with
    len(levels) shifted-slice passes + a select — the gather-free tradeoff
    (the reference's radius is itself a clamped heuristic,
    ``statscalculatorintegralimage.cpp:45-49``).
    """
    levels = tuple(sorted(int(l) for l in levels))
    stack = [window_sums_fixed(I, r) for r in levels]
    r = jnp.asarray(radii)
    out = stack[-1]
    for lev, S in zip(levels[-2::-1], stack[-2::-1]):
        out = jnp.where((r <= lev)[..., None], S, out)
    return out


def window_moments(points, valid, radii, levels=None):
    """Local first/second moments of valid 3D points in a window.

    Args:
      points: (H, W, 3) unprojected 3D points.
      valid:  (H, W) bool validity.
      radii:  per-pixel or scalar half-window.

    Returns:
      (count (H,W), mean (H,W,3), cov (H,W,3,3)) where cov is the sample
      covariance of window points (uncentered accumulation, centered here).
    """
    v = valid.astype(points.dtype)
    p = points * v[..., None]
    # channels: [count, px, py, pz, xx, xy, xz, yy, yz, zz]
    outer = jnp.stack(
        [
            p[..., 0] * points[..., 0],
            p[..., 0] * points[..., 1],
            p[..., 0] * points[..., 2],
            p[..., 1] * points[..., 1],
            p[..., 1] * points[..., 2],
            p[..., 2] * points[..., 2],
        ],
        axis=-1,
    )
    acc = jnp.concatenate([v[..., None], p, outer], axis=-1)  # (H, W, 10)
    I = integral_image(acc)
    if levels is not None:
        S = window_sums_quantized(I, radii, levels)
    else:
        S = window_sums(I, radii)
    n = S[..., 0]
    n_safe = jnp.maximum(n, 1.0)
    mean = S[..., 1:4] / n_safe[..., None]
    xx, xy, xz, yy, yz, zz = (S[..., 4 + k] for k in range(6))
    m = mean
    cov = jnp.stack(
        [
            jnp.stack([xx, xy, xz], -1),
            jnp.stack([xy, yy, yz], -1),
            jnp.stack([xz, yz, zz], -1),
        ],
        axis=-2,
    ) / n_safe[..., None, None] - jnp.einsum("...i,...j->...ij", m, m)
    return n, mean, cov


# ---- channel-planar variants ((C, H, W) leading channels) ------------------
# The trailing-channel versions above materialize (H, W, C) tables whose
# minor dims are tiny; the planar twins below keep every channel a
# contiguous (H, W) plane.


def integral_image_planar(x):
    """(C, H, W) -> (C, H+1, W+1) summed-area table (leading zero row/col)."""
    s = jnp.cumsum(jnp.cumsum(x, axis=1), axis=2)
    return jnp.pad(s, ((0, 0), (1, 0), (1, 0)))


def window_sums_fixed_planar(I, r: int):
    """Clamped-window sums for a static radius, planar twin of
    `window_sums_fixed`: four statically-shifted slices of the edge-padded
    table — pure elementwise adds."""
    H, W = I.shape[1] - 1, I.shape[2] - 1
    Ip = jnp.pad(I, ((0, 0), (r, r), (r, r)), mode="edge")
    s = 2 * r + 1
    c1 = Ip[:, s : s + H, s : s + W]
    c2 = Ip[:, 0:H, s : s + W]
    c3 = Ip[:, s : s + H, 0:W]
    c4 = Ip[:, 0:H, 0:W]
    return c1 - c2 - c3 + c4


def window_sums_quantized_planar(I, radii, levels):
    """Planar twin of `window_sums_quantized` (radii quantized to static
    levels, smallest level >= requested)."""
    levels = tuple(sorted(int(l) for l in levels))
    stack = [window_sums_fixed_planar(I, r) for r in levels]
    r = jnp.asarray(radii)
    out = stack[-1]
    for lev, S in zip(levels[-2::-1], stack[-2::-1]):
        out = jnp.where((r <= lev)[None], S, out)
    return out


def window_moments_planar(p, valid, radii, levels=None):
    """Planar twin of `window_moments`.

    Args:
      p: (3, H, W) unprojected 3D points (channel planes).
      valid: (H, W) bool.
      radii: per-pixel (H, W) or scalar half-window.
      levels: static radius levels (see `window_sums_quantized`).

    Returns:
      (count (H, W), mean (3, H, W), cov6 (6, H, W)) — cov6 is the sym6
      upper triangle of the sample covariance.
    """
    v = valid.astype(p.dtype)
    pm = p * v[None]
    acc = jnp.stack(
        [
            v,
            pm[0],
            pm[1],
            pm[2],
            pm[0] * p[0],
            pm[0] * p[1],
            pm[0] * p[2],
            pm[1] * p[1],
            pm[1] * p[2],
            pm[2] * p[2],
        ]
    )  # (10, H, W)
    I = integral_image_planar(acc)
    if levels is not None:
        S = window_sums_quantized_planar(I, radii, levels)
    else:
        # exact per-pixel radii need a 4-corner gather; reuse the
        # trailing-layout path (rare: levels=None is the parity mode)
        S = jnp.moveaxis(window_sums(jnp.moveaxis(I, 0, -1), radii), -1, 0)
    n = S[0]
    n_safe = jnp.maximum(n, 1.0)
    mean = S[1:4] / n_safe[None]
    m0, m1, m2 = mean[0], mean[1], mean[2]
    cov6 = jnp.stack(
        [
            S[4] / n_safe - m0 * m0,
            S[5] / n_safe - m0 * m1,
            S[6] / n_safe - m0 * m2,
            S[7] / n_safe - m1 * m1,
            S[8] / n_safe - m1 * m2,
            S[9] / n_safe - m2 * m2,
        ]
    )
    return n, mean, cov6
