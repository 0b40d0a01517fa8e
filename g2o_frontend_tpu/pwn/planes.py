"""Plane extraction from organized clouds (PlaneEx equivalent).

The reference extracts planes per RGB-D frame with PCL's sequential
SAC-RANSAC (``PlaneEx/plane_g2o.cpp:216-241``: segment, remove inliers,
repeat). That loop is serial and compaction-heavy; the redesign uses the
cloud's per-pixel normals (already computed by the converter):

1. per-pixel plane parameters (n, d = n.p) for pixels with valid normals,
2. Hough voting: quantize (n, d) into a (azimuth, elevation, distance)
   histogram with one scatter-add; non-maximum-suppressed top-K bins are
   plane hypotheses,
3. masked refinement per hypothesis (vmapped): inlier mask by angular +
   distance gates, then a weighted least-squares plane re-fit via the 3x3
   covariance eigenvector (closed form) — two rounds,
4. fixed-capacity `PlaneSet` output (normal, d, inlier count, centroid).

Planes use the Hessian form n.p = d with unit n and d >= 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.eigh3x3 import smallest_eigenvector3x3
from .cloud import Cloud


@dataclass(frozen=True)
class PlaneExtractorConfig:
    n_azimuth_bins: int = 18
    n_elevation_bins: int = 9
    n_distance_bins: int = 20
    max_distance: float = 8.0
    max_planes: int = 8
    angle_threshold: float = 0.1745  # rad (10 deg) inlier gate
    distance_threshold: float = 0.05  # m
    min_inliers: int = 300
    refine_rounds: int = 2


class PlaneSet(NamedTuple):
    normal: jnp.ndarray  # (K, 3) unit normals
    d: jnp.ndarray  # (K,) offsets, n.p = d
    n_inliers: jnp.ndarray  # (K,)
    centroid: jnp.ndarray  # (K, 3)
    mask: jnp.ndarray  # (K,) bool


@partial(jax.jit, static_argnames=("config",))
def extract_planes(cloud: Cloud, config: PlaneExtractorConfig = PlaneExtractorConfig()) -> PlaneSet:
    cfg = config
    n = cloud.normals.reshape(-1, 3)
    p = cloud.points.reshape(-1, 3)
    has_n = jnp.sum(n * n, -1) > 0.5
    d = jnp.sum(n * p, -1)
    # canonicalize: d >= 0 (flip normal)
    flip = d < 0
    n = jnp.where(flip[:, None], -n, n)
    d = jnp.abs(d)

    az = jnp.arctan2(n[:, 1], n[:, 0])  # [-pi, pi]
    el = jnp.arccos(jnp.clip(n[:, 2], -1, 1))  # [0, pi]
    A, E, D = cfg.n_azimuth_bins, cfg.n_elevation_bins, cfg.n_distance_bins
    ia = jnp.clip(((az + jnp.pi) / (2 * jnp.pi) * A).astype(jnp.int32), 0, A - 1)
    ie = jnp.clip((el / jnp.pi * E).astype(jnp.int32), 0, E - 1)
    # azimuth is undefined near the +-z poles: collapse pole rings into a
    # single cell so a fronto-parallel wall doesn't smear over all azimuths
    ia = jnp.where((ie == 0) | (ie == E - 1), 0, ia)
    idd = jnp.clip((d / cfg.max_distance * D).astype(jnp.int32), 0, D - 1)
    bin_idx = jnp.where(has_n, (ia * E + ie) * D + idd, A * E * D)
    B = A * E * D
    hist = jnp.zeros(B + 1, jnp.float32).at[bin_idx].add(1.0)[:-1]
    # per-bin vote means give exact hypothesis parameters (bin centers are
    # too coarse for the refinement gates)
    wn = jnp.where(has_n[:, None], n, 0.0)
    sum_n = jnp.zeros((B + 1, 3), jnp.float32).at[bin_idx].add(wn)[:-1]
    sum_d = jnp.zeros(B + 1, jnp.float32).at[bin_idx].add(
        jnp.where(has_n, d, 0.0)
    )[:-1]

    # top-K bins with a crude NMS: after picking a bin, zero its neighbors
    # in distance (same normal cell) to avoid duplicate hypotheses
    K = cfg.max_planes

    def pick(carry, _):
        h = carry
        b = jnp.argmax(h)
        cnt = h[b]
        cell = b // D
        # suppress the whole normal cell +- 1 distance bin around b
        db = b % D
        sup = jnp.arange(D)
        supmask = jnp.abs(sup - db) <= 1
        h = h.at[cell * D + sup].set(jnp.where(supmask, 0.0, h[cell * D + sup]))
        return h, (b, cnt)

    _, (bins, counts) = jax.lax.scan(pick, hist, None, length=K)

    # hypothesis parameters = mean of the bin's votes
    cnt_b = jnp.maximum(hist[bins], 1.0)
    n_h = sum_n[bins] / cnt_b[:, None]
    n_h = n_h / jnp.maximum(jnp.linalg.norm(n_h, axis=-1, keepdims=True), 1e-9)
    d_h = sum_d[bins] / cnt_b

    cos_gate = jnp.cos(cfg.angle_threshold)

    def refine(nh, dh):
        def round_fn(carry, _):
            nh, dh = carry
            ang_ok = jnp.sum(n * nh, -1) > cos_gate
            dist_ok = jnp.abs(jnp.sum(p * nh, -1) - dh) < cfg.distance_threshold
            w = (has_n & ang_ok & dist_ok).astype(p.dtype)
            cnt = jnp.sum(w)
            c = jnp.maximum(cnt, 1.0)
            mean = jnp.sum(w[:, None] * p, 0) / c
            q = p - mean
            cov = jnp.einsum("n,ni,nj->ij", w, q, q) / c
            lam, v0 = smallest_eigenvector3x3(cov[None])
            nn = v0[0]
            dd = jnp.dot(nn, mean)
            nn = jnp.where(dd < 0, -nn, nn)
            dd = jnp.abs(dd)
            # keep previous if degenerate
            ok = cnt >= 3
            nn = jnp.where(ok, nn, nh)
            dd = jnp.where(ok, dd, dh)
            return (nn, dd), (cnt, mean)

        (nh, dh), (cnts, means) = jax.lax.scan(
            round_fn, (nh, dh), None, length=cfg.refine_rounds
        )
        return nh, dh, cnts[-1], means[-1]

    n_ref, d_ref, cnt, cent = jax.vmap(refine)(n_h, d_h)
    ok = cnt >= cfg.min_inliers

    # dedupe: suppress hypothesis j if a higher-count i has same plane
    sim_n = jnp.einsum("ki,ji->kj", n_ref, n_ref) > cos_gate
    sim_d = jnp.abs(d_ref[:, None] - d_ref[None, :]) < 2 * cfg.distance_threshold
    dup = sim_n & sim_d & (cnt[:, None] > cnt[None, :])
    # also suppress ties by index order
    tie = sim_n & sim_d & (cnt[:, None] == cnt[None, :]) & (
        jnp.arange(len(cnt))[:, None] < jnp.arange(len(cnt))[None, :]
    )
    suppressed = jnp.any(dup | tie, axis=0)
    ok = ok & ~suppressed
    return PlaneSet(
        normal=n_ref, d=d_ref, n_inliers=cnt, centroid=cent, mask=ok
    )


def planes_to_array(ps: PlaneSet):
    """(K, 4) [n, d] array + mask, the RANSAC plane-solver input format."""
    return jnp.concatenate([ps.normal, ps.d[:, None]], -1), ps.mask
