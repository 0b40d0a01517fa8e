"""Distance maps and Voronoi partitions via the jump-flood algorithm.

JAX replacement for ``voronoi/``'s distance-map + Voronoi machinery
(``voronoi_diagram.h:40-49``, ``distance_map_extractor.cpp``): the reference
propagates nearest-obstacle information with queue-based wavefronts; here a
jump-flood pass (log2(max(H,W)) rounds of 9-neighbor shifted min-selects)
computes, for every cell, the exact-ish nearest seed and squared distance —
pure shift/compare ops, no data-dependent control flow.

Outputs:
- `distance_transform`: per-cell nearest seed index + Euclidean distance,
- `voronoi_edges`: cells where 4-neighbors disagree on (sufficiently
  separated) nearest seeds — the generalized Voronoi diagram of the free
  space (the reference's `VoronoiDiagram` vertices),
- `skeletonize`: ridge cells of the distance field (local maxima along the
  gradient-orthogonal direction).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["distance_transform", "voronoi_edges", "skeletonize"]

_BIG = jnp.inf


@partial(jax.jit, static_argnames=("max_rounds",))
def distance_transform(occupied, max_rounds: int = 0):
    """Jump-flood nearest-seed transform.

    Args:
      occupied: (H, W) bool — obstacle/seed cells.
      max_rounds: number of JFA rounds; 0 -> ceil(log2(max(H, W))) + 2.

    Returns:
      (dist (H, W) float32 Euclidean distance to the nearest seed,
       nearest (H, W, 2) int32 row/col of the nearest seed, -1 where none).
    """
    import math

    H, W = occupied.shape
    if max_rounds == 0:
        max_rounds = int(math.ceil(math.log2(max(H, W)))) + 2
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    seed_r = jnp.where(occupied, rows, -1)
    seed_c = jnp.where(occupied, cols, -1)

    def dist2_to(sr, sc):
        d2 = (rows - sr) ** 2 + (cols - sc) ** 2
        return jnp.where(sr >= 0, d2.astype(jnp.float32), _BIG)

    # One compiled round body under fori_loop with a traced step size; the
    # shifts use wrap-around jnp.roll — safe for JFA because every candidate
    # carries its ABSOLUTE seed coordinates, so wrapped candidates are just
    # extra (valid) seeds and the min can only improve.
    step0 = 1 << (max_rounds - 1)

    def round_body(r, state):
        sr, sc, best_d = state
        k = jnp.maximum(step0 >> r, 1)
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if dr == 0 and dc == 0:
                    continue
                nsr = jnp.roll(sr, (dr * k, dc * k), (0, 1))
                nsc = jnp.roll(sc, (dr * k, dc * k), (0, 1))
                nd = dist2_to(nsr, nsc)
                take = nd < best_d
                sr = jnp.where(take, nsr, sr)
                sc = jnp.where(take, nsc, sc)
                best_d = jnp.where(take, nd, best_d)
        return sr, sc, best_d

    sr, sc, best_d = jax.lax.fori_loop(
        0,
        max_rounds,
        round_body,
        (seed_r, seed_c, dist2_to(seed_r, seed_c)),
    )
    d = jnp.sqrt(jnp.where(jnp.isfinite(best_d), best_d, _BIG))
    nearest = jnp.stack([sr, sc], -1)
    return d, nearest


def voronoi_edges(nearest, min_seed_separation: float = 2.0):
    """Cells whose 4-neighbors are claimed by a DIFFERENT, distant seed.

    `min_seed_separation` (cells) suppresses spurious boundaries between
    adjacent seeds of the same obstacle (the reference merges such vertices
    into components, ``voronoi_diagram.cpp``)."""
    sr = nearest[..., 0]
    sc = nearest[..., 1]
    H, W = sr.shape
    edge = jnp.zeros((H, W), bool)
    for dr, dc in ((0, 1), (1, 0)):
        nsr = jnp.roll(sr, -dr, 0) if dc == 0 else jnp.roll(sr, -dc, 1)
        nsc = jnp.roll(sc, -dr, 0) if dc == 0 else jnp.roll(sc, -dc, 1)
        sep2 = (sr - nsr) ** 2 + (sc - nsc) ** 2
        differs = sep2 > min_seed_separation**2
        # mask the wrap-around row/col
        if dc == 0:
            differs = differs.at[H - 1, :].set(False)
        else:
            differs = differs.at[:, W - 1].set(False)
        edge = edge | differs
    valid = sr >= 0
    return edge & valid


def skeletonize(dist, threshold: float = 1.0):
    """Ridge cells of the distance field: >= 6 of 8 neighbors not larger.

    A cheap, branchless medial-axis approximation (the reference thins the
    diagram iteratively); cells below `threshold` distance are excluded."""
    H, W = dist.shape
    cnt = jnp.zeros((H, W), jnp.int32)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue
            n = jnp.full_like(dist, -1.0)
            rs = slice(max(dr, 0), H + min(dr, 0))
            rsrc = slice(max(-dr, 0), H + min(-dr, 0))
            cs = slice(max(dc, 0), W + min(dc, 0))
            csrc = slice(max(-dc, 0), W + min(-dc, 0))
            n = n.at[rs, cs].set(dist[rsrc, csrc])
            cnt = cnt + (n <= dist).astype(jnp.int32)
    return (cnt >= 6) & (dist > threshold)
