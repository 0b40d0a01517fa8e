"""Synthetic scene generation for tests and benchmarks.

Plays the role of the reference's simulators-as-fixtures
(``graph_merge/graph_simulator.h``, ``planeDatasetGenerator/``; SURVEY.md §4):
analytic plane-scene depth rendering with exact ground truth.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..pwn.aligner import AlignerConfig
from ..pwn.converter import ConverterConfig
from ..pwn.projector import PinholeProjector

# A closed "room" of 6 axis-aligned planes (normals point inward).
# Deliberately ASYMMETRIC wall distances: a symmetric box admits a 180-deg
# yaw ambiguity that lets dense alignment lock onto the mirrored basin.
ROOM_PLANES = [
    (np.array([0.0, 0.0, -1.0]), -2.5),  # back wall z = 2.5
    (np.array([0.0, 0.0, 1.0]), -2.0),  # front wall z = -2.0
    (np.array([-1.0, 0.0, 0.0]), -1.8),  # right wall x = 1.8
    (np.array([1.0, 0.0, 0.0]), -1.3),  # left wall x = -1.3
    (np.array([0.0, -1.0, 0.0]), -1.0),  # floor y = 1.0
    (np.array([0.0, 1.0, 0.0]), -0.8),  # ceiling y = -0.8
]

# Three walls of a room corner, seen head-on: the aligner benchmark's scene.
CORNER_PLANES = [
    (np.array([0.0, 0.0, -1.0]), -2.5),  # back wall z = 2.5
    (np.array([-1.0, 0.0, 0.0]), -1.2),  # right wall x = 1.2
    (np.array([0.0, -1.0, 0.0]), -0.9),  # floor y = 0.9
]
# the corner pair's known motion, a twist [t | r] for `lie.se3_exp`
CORNER_MOTION = (0.04, -0.02, 0.05, 0.01, 0.03, -0.02)


def render_planes_depth(T_wc, projector: PinholeProjector, planes=None):
    """Ray-cast a set of planes (n, d) with n.p = d from camera pose T_wc."""
    planes = planes if planes is not None else ROOM_PLANES
    H, W = projector.rows, projector.cols
    vs, us = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dirs = np.stack(
        [
            (us - projector.cx) / projector.fx,
            (vs - projector.cy) / projector.fy,
            np.ones_like(us, float),
        ],
        -1,
    )
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    dirs_w = dirs @ R.T
    depth = np.full((H, W), np.inf)
    for n, d in planes:
        denom = dirs_w @ n
        z = np.where(np.abs(denom) > 1e-9, (d - t @ n) / denom, np.inf)
        depth = np.minimum(depth, np.where(z > 0.05, z, np.inf))
    depth[~np.isfinite(depth)] = 0.0
    return jnp.asarray(depth, jnp.float32)


def default_projector(H=120, W=160):
    return PinholeProjector(
        rows=H,
        cols=W,
        fx=131.25 * W / 160,
        fy=131.25 * W / 160,
        cx=W / 2 - 0.5,
        cy=H / 2 - 0.5,
        min_distance=0.1,
        max_distance=10.0,
    )


class CornerAlignProblem(NamedTuple):
    depth_ref: jnp.ndarray
    depth_cur: jnp.ndarray  # seen from T_gt
    projector: PinholeProjector
    T_gt: np.ndarray
    converter: ConverterConfig
    aligner: AlignerConfig


def corner_align_problem(H=480, W=640) -> CornerAlignProblem:
    """The aligner benchmark's problem: a room-corner depth pair with a known
    small motion T_gt = se3_exp(CORNER_MOTION), kinect focal length scaled
    to W, and the reference's compute envelope of 10 outer x 1 inner
    iterations (``pwn_core/aligner.cpp:19-20``). Below 240 rows the
    converter takes the reference's scale-4 statistics radii
    (``pwn_slam_catacombs_gui.conf``).
    """
    from . import lie

    fx = 525.0 * (W / 640.0)
    proj = PinholeProjector(rows=H, cols=W, fx=fx, fy=fx,
                            cx=W / 2 - 0.5, cy=H / 2 - 0.5,
                            min_distance=0.1, max_distance=10.0)
    T_gt = np.asarray(lie.se3_exp(jnp.asarray(CORNER_MOTION, jnp.float32)))
    if H >= 240:
        ccfg = ConverterConfig()
    else:
        ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8,
                               min_points=12)
    return CornerAlignProblem(
        render_planes_depth(np.eye(4), proj, CORNER_PLANES),
        render_planes_depth(T_gt, proj, CORNER_PLANES), proj, T_gt, ccfg,
        AlignerConfig(outer_iterations=10, inner_iterations=1))
