"""Manifold Voronoi extraction: top-down traversability grids from keyframe
clouds, feeding the Voronoi diagram machinery.

JAX re-design of ``pwn_tracker2/manifold_voronoi_extractor.{h,cpp}``:
the reference walks the last ``dequeSize`` cached keyframe clouds point by
point, projecting each into a 2D grid around the current key node and keeping
per cell the deepest point (height-coded ``pz = 10000 - 1000*z``,
``manifold_voronoi_extractor.cpp:100``), marking cells whose winning point has
a wall-like normal (``n.z() < normalThreshold``) as obstacles
(``manifold_voronoi_extractor.cpp:110-120``); the grid then seeds a Voronoi
diagram of the free space.

Here the sequential per-point loop becomes one scatter-min with a packed
key — quantized height in the high bits, the floor/wall classification of
that very point in the low bit — so the winner per cell and its class come
out of a single deterministic ``min`` reduction (no visit-order dependence,
unlike the reference's sticky-obstacle loop). The diagram is the jump-flood
distance transform + Voronoi boundary from ``ops.distance_transform``.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.distance_transform import distance_transform, skeletonize, voronoi_edges
from ..utils import lie

# reference constants (manifold_voronoi_extractor.cpp:40-46,74-78,100)
_FREE_INIT = 30000
_Z_SCALE = 1000.0
_Z_OFFSET = 10000.0


@dataclass(frozen=True)
class ManifoldVoronoiConfig:
    """Defaults = reference constructor (``manifold_voronoi_extractor.cpp:37-46``)."""

    resolution: float = 0.2
    x_size: int = 100
    y_size: int = 100
    normal_threshold: float = 0.64
    deque_size: int = 30


class ManifoldVoronoiData(NamedTuple):
    """The reference's ``ManifoldVoronoiData`` (grid + resolution + node)."""

    height: jnp.ndarray  # (x_size, y_size) int32, pz code; _FREE_INIT = empty
    obstacle: jnp.ndarray  # (x_size, y_size) bool
    resolution: float
    node_id: int = -1


@partial(jax.jit, static_argnames=("x_size", "y_size"))
def manifold_grid(
    points,  # (K, 3, H, W) channel-planar cloud points, key-node frame
    normals,  # (K, 3, H, W)
    valid,  # (K, H, W) bool
    x_size: int = 100,
    y_size: int = 100,
    resolution: float = 0.2,
    normal_threshold: float = 0.64,
):
    """Scatter K clouds into the reference's top-down height/obstacle grid.

    Points must already be mapped into the key node frame (the reference
    transforms each cached cloud by ``keyNode^-1 @ cloudNode``,
    ``manifold_voronoi_extractor.cpp:80-90``). Returns (height int32 grid,
    obstacle bool grid); empty cells hold ``_FREE_INIT``.
    """
    cx, cy = x_size * 0.5, y_size * 0.5
    ires = 1.0 / resolution
    px = points[:, 0].reshape(-1)
    py = points[:, 1].reshape(-1)
    pz = points[:, 2].reshape(-1)
    nz = normals[:, 2].reshape(-1)
    nsq = (normals**2).sum(1).reshape(-1)
    ok = valid.reshape(-1) & (nsq >= 0.1)  # normal gate (cpp:109-112)

    gx = (cx + px * ires).astype(jnp.int32)
    gy = (cy + py * ires).astype(jnp.int32)
    inside = (gx >= 0) & (gx < x_size) & (gy >= 0) & (gy < y_size) & ok
    zq = jnp.clip(
        (_Z_OFFSET - _Z_SCALE * pz).astype(jnp.int32), 0, _FREE_INIT - 1
    )
    is_floor = (nz >= normal_threshold).astype(jnp.int32)
    # packed key: winner = min pz; low bit carries the winner's class
    # (floor=1 so that among equal heights, obstacle wins the min)
    key = zq * 2 + is_floor
    key = jnp.where(inside, key, _FREE_INIT * 2 + 1)
    cell = jnp.where(inside, gx * y_size + gy, 0)

    flat = jnp.full((x_size * y_size,), _FREE_INIT * 2 + 1, jnp.int32)
    flat = flat.at[cell].min(key, mode="drop")
    grid = flat.reshape(x_size, y_size)
    height = grid // 2
    obstacle = (grid % 2 == 0) & (height < _FREE_INIT)
    return height, obstacle


@partial(jax.jit, static_argnames=("squared_resolution",))
def manifold_diagram(obstacle, squared_resolution: int = 4):
    """Distance map + Voronoi boundary + skeleton of the free space.

    The reference's ``ManifoldVoronoi`` builds a distance map and extracts
    the diagram graph by wavefront expansion (``diagram2graph``); here the
    jump-flood transform gives nearest-obstacle assignments and the diagram
    is the set of cells where assignments change between distant seeds.
    """
    dist, nearest = distance_transform(obstacle)
    edges = voronoi_edges(nearest, min_seed_separation=float(squared_resolution))
    skel = skeletonize(dist)
    return dist, edges, skel


class ManifoldVoronoiExtractor:
    """Host-side driver mirroring the reference StreamProcessor: keeps the
    last ``deque_size`` keyframe clouds, and on each new key node emits a
    `ManifoldVoronoiData` for the grid around it (plus the diagram)."""

    def __init__(self, config: ManifoldVoronoiConfig = ManifoldVoronoiConfig()):
        self.config = config
        self._entries: list[tuple[int, object, jnp.ndarray]] = []  # (id, cloud, T)

    def add_keyframe(self, node_id: int, cloud, transform):
        self._entries.append((node_id, cloud, jnp.asarray(transform)))
        if len(self._entries) > self.config.deque_size:
            self._entries.pop(0)

    def extract(self, key_node_id: int | None = None) -> ManifoldVoronoiData:
        if not self._entries:
            raise ValueError("no keyframes cached")
        if key_node_id is None:
            key_node_id = self._entries[-1][0]
        T_key = next(T for i, _, T in self._entries if i == key_node_id)
        inT = lie.se3_inverse(T_key)
        cfg = self.config
        pts, nrm, val = [], [], []
        for _, cloud, T in self._entries:
            rel = inT @ T
            c = cloud.transform(rel)
            pts.append(c.p)
            nrm.append(c.n)
            val.append(c.valid)
        height, obstacle = manifold_grid(
            jnp.stack(pts),
            jnp.stack(nrm),
            jnp.stack(val),
            x_size=cfg.x_size,
            y_size=cfg.y_size,
            resolution=cfg.resolution,
            normal_threshold=cfg.normal_threshold,
        )
        return ManifoldVoronoiData(height, obstacle, cfg.resolution, key_node_id)
