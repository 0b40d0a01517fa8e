"""Device-mesh helpers for multi-chip execution.

The reference is single-process (OpenMP threads + optional single GPU,
SURVEY.md §2 parallelism inventory); the multi-chip axis is new in this
framework. We use one 1-D logical mesh axis ``"shard"`` for the edge/keyframe
partition dimension — the device analog of the reference's map partitions
(``boss_map/map_utils.cpp:167`` makePartitions): each device owns a block of
edges (later: keyframe blocks), poses are replicated, and reductions are
`psum` collectives.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

EDGE_AXIS = "shard"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (EDGE_AXIS,))


def pad_to_multiple(x, multiple: int, axis: int = 0, fill=0):
    """Pad a numpy/jax array so shape[axis] % multiple == 0."""
    import jax.numpy as jnp

    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return jnp.pad(x, widths, constant_values=fill)
