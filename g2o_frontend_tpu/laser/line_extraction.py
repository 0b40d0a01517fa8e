"""2D laser line extraction: clustering + split-merge, fully vectorized.

JAX re-design of ``line_extraction/line_extraction2d.{h,cpp}``
(`Point2DClusterer` + `Line2DExtractor` split/merge) and the
``IEdgesExtractor``/``SplitMergeEE`` family (``SplitMergeEE.h:11-21``):

The reference recursively splits an index map of segments and merges
neighbors with a per-segment std::map — inherently serial. Here a scan is a
fixed-length masked array and segmentation state is a per-point *breakpoint
mask*; each split round processes ALL segments at once:

  1. cluster: breakpoints at range jumps (`Point2DClusterer::compute`),
  2. split (fixed rounds): per-segment chord endpoints via segment min/max,
     per-point chord distance, per-segment argmax; split where above
     threshold — one `segment_*` pass per round instead of recursion,
  3. merge (fixed rounds): per-segment total-least-squares line fit via
     segment moments + closed-form 2x2 eigendirection; adjacent segments
     with compatible (normal, rho) merge (`Line2DExtractor::merge`
     semantics),
  4. emit fixed-capacity line set (endpoints, normal/rho, #points, mask).

Everything is O(N log-ish) in fixed passes, jit-safe, and vmaps over a batch
of scans.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class LineExtractorConfig:
    """Defaults follow ``Line2DExtractor`` constructor + clusterer."""

    cluster_squared_distance: float = 0.09  # clusterer break threshold (0.3m)^2
    split_threshold: float = 0.03**2  # squared chord distance
    min_points_in_line: int = 6
    split_rounds: int = 10
    merge_rounds: int = 3
    normal_merge_threshold: float = 0.05  # 1 - |n1.n2|
    rho_merge_threshold: float = 0.07
    max_lines: int = 64
    max_range: float = 30.0


class LineSet(NamedTuple):
    """Fixed-capacity extracted lines.

    p0, p1: (L, 2) endpoints; normal: (L, 2) unit; rho: (L,) with n.p = rho;
    n_points: (L,); mask: (L,) bool.
    """

    p0: jnp.ndarray
    p1: jnp.ndarray
    normal: jnp.ndarray
    rho: jnp.ndarray
    n_points: jnp.ndarray
    mask: jnp.ndarray


def scan_to_points(ranges, angles, valid_mask=None, max_range=30.0):
    """Polar scan -> (N, 2) cartesian points + validity."""
    pts = jnp.stack([ranges * jnp.cos(angles), ranges * jnp.sin(angles)], -1)
    valid = (ranges > 1e-3) & (ranges < max_range) & jnp.isfinite(ranges)
    if valid_mask is not None:
        valid = valid & valid_mask
    return pts, valid


def _segment_endpoints(seg_id, pts, valid, n_seg):
    """First/last valid point per segment (by scan order)."""
    n = pts.shape[0]
    order = jnp.arange(n)
    big = n + 1
    first_idx = jax.ops.segment_min(
        jnp.where(valid, order, big), seg_id, n_seg
    )
    last_idx = jax.ops.segment_max(jnp.where(valid, order, -1), seg_id, n_seg)
    first_idx = jnp.clip(first_idx, 0, n - 1)
    last_idx = jnp.clip(last_idx, 0, n - 1)
    return pts[first_idx], pts[last_idx], first_idx, last_idx


def _chord_distance(p, a, b):
    """Squared distance from p to the chord a-b (degenerate -> dist to a)."""
    d = b - a
    L2 = jnp.sum(d * d, -1)
    t = jnp.where(L2 > 1e-12, jnp.sum((p - a) * d, -1) / jnp.maximum(L2, 1e-12), 0.0)
    t = jnp.clip(t, 0.0, 1.0)
    proj = a + t[..., None] * d
    return jnp.sum((p - proj) ** 2, -1)


def _tls_fit(seg_id, pts, valid, n_seg):
    """Per-segment total-least-squares lines via moment accumulation.

    Returns (normal (S,2), rho (S,), count (S,), mean (S,2)). Normal is the
    smaller-eigenvalue direction of the 2x2 scatter (closed form).
    """
    w = valid.astype(pts.dtype)
    cnt = jax.ops.segment_sum(w, seg_id, n_seg)
    sx = jax.ops.segment_sum(w * pts[:, 0], seg_id, n_seg)
    sy = jax.ops.segment_sum(w * pts[:, 1], seg_id, n_seg)
    sxx = jax.ops.segment_sum(w * pts[:, 0] * pts[:, 0], seg_id, n_seg)
    sxy = jax.ops.segment_sum(w * pts[:, 0] * pts[:, 1], seg_id, n_seg)
    syy = jax.ops.segment_sum(w * pts[:, 1] * pts[:, 1], seg_id, n_seg)
    c = jnp.maximum(cnt, 1.0)
    mx, my = sx / c, sy / c
    cxx = sxx / c - mx * mx
    cxy = sxy / c - mx * my
    cyy = syy / c - my * my
    # smaller eigenvalue of [[cxx, cxy], [cxy, cyy]] and its eigenvector
    tr = cxx + cyy
    det_h = jnp.sqrt(jnp.maximum(((cxx - cyy) * 0.5) ** 2 + cxy * cxy, 0.0))
    lam_small = tr * 0.5 - det_h
    # eigenvector for lam_small: (cxy, lam_small - cxx) or (lam_small - cyy, cxy)
    v1 = jnp.stack([cxy, lam_small - cxx], -1)
    v2 = jnp.stack([lam_small - cyy, cxy], -1)
    use1 = jnp.sum(v1 * v1, -1) > jnp.sum(v2 * v2, -1)
    nvec = jnp.where(use1[:, None], v1, v2)
    nn = jnp.linalg.norm(nvec, axis=-1, keepdims=True)
    # degenerate (isotropic): fall back to radial direction of the mean
    mean = jnp.stack([mx, my], -1)
    fallback = mean / jnp.maximum(jnp.linalg.norm(mean, axis=-1, keepdims=True), 1e-9)
    nvec = jnp.where(nn > 1e-9, nvec / jnp.maximum(nn, 1e-9), fallback)
    rho = jnp.sum(nvec * mean, -1)
    # canonical sign: rho >= 0
    flip = rho < 0
    nvec = jnp.where(flip[:, None], -nvec, nvec)
    rho = jnp.abs(rho)
    return nvec, rho, cnt, mean


@partial(jax.jit, static_argnames=("config",))
def extract_lines(
    ranges, angles, config: LineExtractorConfig = LineExtractorConfig()
) -> LineSet:
    """Extract line segments from one laser scan (fixed-length arrays)."""
    cfg = config
    pts, valid = scan_to_points(ranges, angles, max_range=cfg.max_range)
    n = pts.shape[0]
    fdt = pts.dtype

    # --- 1. clustering: break where consecutive valid points jump ---
    prev = jnp.roll(pts, 1, 0)
    prev_valid = jnp.roll(valid, 1)
    gap = jnp.sum((pts - prev) ** 2, -1)
    brk = (~prev_valid) | (gap > cfg.cluster_squared_distance)
    brk = brk.at[0].set(True)
    brk = brk | (~valid)  # invalid points isolate segments

    # --- 2. split rounds ---
    def split_round(b, _):
        seg = jnp.cumsum(b.astype(jnp.int32)) - 1
        seg = jnp.clip(seg, 0, n - 1)
        a, bb, _, _ = _segment_endpoints(seg, pts, valid, n)
        d2 = _chord_distance(pts, a[seg], bb[seg])
        d2 = jnp.where(valid, d2, -1.0)
        seg_max = jax.ops.segment_max(d2, seg, n)
        is_max = (d2 >= seg_max[seg]) & (d2 > cfg.split_threshold) & valid
        # break ties: lowest index wins within segment
        order = jnp.arange(n)
        first_max = jax.ops.segment_min(
            jnp.where(is_max, order, n + 1), seg, n
        )
        has_split = first_max <= n - 1  # per-segment: found a split point
        idx = jnp.clip(first_max, 0, n - 1)
        new_break = (
            jnp.zeros(n, jnp.int32).at[idx].max(has_split.astype(jnp.int32)) > 0
        )
        return b | new_break, None

    brk, _ = jax.lax.scan(split_round, brk, None, length=cfg.split_rounds)

    # --- 3. merge rounds (adjacent segments with compatible TLS lines) ---
    def merge_round(b, _):
        seg = jnp.clip(jnp.cumsum(b.astype(jnp.int32)) - 1, 0, n - 1)
        nvec, rho, cnt, _ = _tls_fit(seg, pts, valid, n)
        # for each breakpoint at position i (i>0): compare segment seg[i]-1, seg[i]
        sid = seg
        left = jnp.clip(sid - 1, 0, n - 1)
        ndot = jnp.abs(jnp.sum(nvec[sid] * nvec[left], -1))
        drho = jnp.abs(rho[sid] - rho[left])
        both_ok = (cnt[sid] > 0) & (cnt[left] > 0)
        compatible = (
            (1.0 - ndot < cfg.normal_merge_threshold)
            & (drho < cfg.rho_merge_threshold)
            & both_ok
        )
        # a breakpoint may be removed only if the point itself is valid and
        # its predecessor is valid (i.e. not a cluster/validity gap)
        prev_ok = jnp.roll(valid, 1) & valid
        removable = b & compatible & prev_ok
        removable = removable.at[0].set(False)
        # alternate odd/even segment parity to avoid merging chains at once
        parity = (sid % 2).astype(bool)
        removable = removable & parity
        return b & ~removable, None

    brk, _ = jax.lax.scan(merge_round, brk, None, length=cfg.merge_rounds)

    # --- 4. emit fixed-capacity line set ---
    seg = jnp.clip(jnp.cumsum(brk.astype(jnp.int32)) - 1, 0, n - 1)
    nvec, rho, cnt, mean = _tls_fit(seg, pts, valid, n)
    a, bpt, fi, li = _segment_endpoints(seg, pts, valid, n)
    good = cnt >= cfg.min_points_in_line

    # rank segments by point count, take top max_lines
    L = cfg.max_lines
    score = jnp.where(good, cnt, -1.0)
    top = jax.lax.top_k(score, L)[1]
    sel_ok = score[top] > 0
    # project endpoints onto the TLS line for clean segment geometry
    tvec = jnp.stack([-nvec[:, 1], nvec[:, 0]], -1)  # line direction

    def proj(p, s):
        foot = nvec[s] * rho[s][..., None]
        t = jnp.sum((p - foot) * tvec[s], -1)
        return foot + t[..., None] * tvec[s]

    p0 = proj(a, jnp.arange(n))[top]
    p1 = proj(bpt, jnp.arange(n))[top]
    return LineSet(
        p0=jnp.where(sel_ok[:, None], p0, 0.0),
        p1=jnp.where(sel_ok[:, None], p1, 0.0),
        normal=jnp.where(sel_ok[:, None], nvec[top], 0.0),
        rho=jnp.where(sel_ok, rho[top], 0.0),
        n_points=jnp.where(sel_ok, cnt[top], 0.0),
        mask=sel_ok,
    )
