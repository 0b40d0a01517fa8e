"""Cloud-pair matching with image-overlap statistics (PwnMatcherBase analog).

Re-design of ``pwn_tracker/pwn_matcher_base.{h,cpp}``: wraps the jitted
aligner and adds the depth-image comparison statistics the tracker/closer
gate on (``pwn_matcher_base.cpp:130-182``): render both clouds at the final
transform, count overlapping pixels (nonZeros), pixels whose depth agrees
within `frame_inlier_depth_threshold` millimeters (image_inliers), and their
complement (image_outliers). The closure information matrix follows the
reference's own choice of 100*I (``pwn_matcher_base.cpp:146-149``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..pwn.aligner import AlignerConfig, align
from ..pwn.cloud import Cloud
from ..pwn.projector import PinholeProjector


class MatcherResult(NamedTuple):
    transform: jnp.ndarray  # (4, 4) to -> from
    information: jnp.ndarray  # (6, 6)
    cloud_inliers: jnp.ndarray  # aligner inliers
    image_nonzeros: jnp.ndarray
    image_inliers: jnp.ndarray
    image_outliers: jnp.ndarray
    reprojection_distance: jnp.ndarray  # mean |depth diff| (mm) over overlap
    valid: jnp.ndarray  # aligner validity gates


def _overlap_stats(res, reference, current, projector) -> MatcherResult:
    """Image-overlap statistics at the matched pose
    (``pwn_matcher_base.cpp:130-182``). Pure jnp — vmapped by the batch."""
    invT = jnp.linalg.inv(res.T)
    R, t = invT[:3, :3], invT[:3, 3]
    ref_in_cur = jnp.einsum("ij,hwj->hwi", R, reference.points) + t
    ref_depth, _ = projector.project(ref_in_cur, reference.valid)
    cur_depth, _ = projector.project(current.points, current.valid)

    # 16UC1 conversion in the reference = millimeters
    ref_mm = ref_depth * 1000.0
    cur_mm = cur_depth * 1000.0
    mask = (ref_mm > 0) & (cur_mm > 0)
    diff = jnp.abs(cur_mm - ref_mm)
    nonzeros = jnp.sum(mask)
    inliers = jnp.sum(mask & (diff < 50.0))
    rep = jnp.sum(jnp.where(mask, diff, 0.0)) / jnp.maximum(nonzeros, 1)

    info = jnp.eye(6, dtype=res.T.dtype) * 100.0  # reference's closure HACK
    return MatcherResult(
        transform=res.T,
        information=info,
        cloud_inliers=res.inliers,
        image_nonzeros=nonzeros,
        image_inliers=inliers,
        image_outliers=nonzeros - inliers,
        reprojection_distance=rep,
        valid=res.valid,
    )


@partial(jax.jit, static_argnames=("projector", "config"))
def match_clouds(
    reference: Cloud,
    current: Cloud,
    projector: PinholeProjector,
    initial_guess=None,
    config: AlignerConfig = AlignerConfig(),
) -> MatcherResult:
    """Align + image-overlap statistics, all on-chip."""
    res = align(reference, current, projector, initial_guess, config)
    return _overlap_stats(res, reference, current, projector)


@partial(jax.jit, static_argnames=("projector", "config"))
def match_clouds_batch(
    references: Cloud,
    current: Cloud,
    projector: PinholeProjector,
    initial_guesses,
    config: AlignerConfig = AlignerConfig(),
) -> MatcherResult:
    """Match K candidate reference clouds against one current cloud in ONE
    program: `align_batch` over a stacked-leading-axis `Cloud` pytree and
    (K, 4, 4) initial guesses, then vmapped overlap statistics.

    This inverts the reference closer's serial candidate loop
    (``pwn_closer.cpp:92-110`` calls ``matchFrames`` per candidate): all K
    alignments share one compiled program instead of K dispatches. Callers
    pad K to a bucket size to bound recompiles (see
    `MapCloser._process_partition`).
    """
    from ..pwn.aligner import align_batch

    res = align_batch(references, current, projector, initial_guesses, config)
    return jax.vmap(
        lambda r, ref: _overlap_stats(r, ref, current, projector)
    )(res, references)


def stack_clouds(clouds) -> Cloud:
    """Stack a list of same-shape `Cloud`s along a new leading axis."""
    import jax.tree_util as jtu

    return jtu.tree_map(lambda *xs: jnp.stack(xs), *clouds)


@partial(jax.jit, static_argnames=("projector", "scale"))
def make_thumbnails(cloud: Cloud, projector: PinholeProjector, scale: int = 4):
    """Depth + normal thumbnails of a cloud (``pwn_matcher_base.h:48-53``).

    The reference renders a scaled-down depth image and an RGB normal image
    (channels = 127*(1 - n)) used by closers/viewers for cheap overlap
    screening and debugging. Returns (depth (h, w) float32 meters,
    normals (h, w, 3) uint8).
    """
    sp = projector.scaled(scale)
    depth, idx = sp.project(cloud.points, cloud.valid)
    flat_n = cloud.normals.reshape(-1, 3)
    n_img = jnp.where(
        (idx >= 0)[..., None], flat_n[jnp.maximum(idx, 0)], jnp.zeros(3)
    )
    n_rgb = (127.0 * (1.0 - n_img)).astype(jnp.uint8)
    return depth, n_rgb


@dataclass(frozen=True)
class MatcherConfig:
    """PwnMatcherBase knobs (scale applied by the caller's projector)."""

    scale: int = 4
    frame_inlier_depth_threshold: float = 50.0  # mm
