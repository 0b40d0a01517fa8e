"""Depth image -> point-with-normal cloud (the DepthImageConverter analog).

One fused jitted pipeline replacing the reference's multi-object chain
``DepthImageConverterIntegralImage::compute``
(``depthimageconverterintegralimage.cpp:16-57``):

  unproject -> per-pixel interval radii -> integral-image window moments
  -> closed-form 3x3 eigendecomposition -> normals/curvature
  -> point & normal information matrices -> optional sensor-offset transform

Semantics preserved from the reference:
- per-pixel window radius clamped to [min_image_radius, max_image_radius]
  (``statscalculatorintegralimage.cpp:45-49``),
- windows with fewer than min_points valid points produce no normal (``:53``),
- normals flipped toward the viewpoint, and ZEROED where curvature exceeds
  curvature_threshold (``:72-80``),
- point omegas U diag(flat | 1/eigenvalues) U^T, normal omegas flat/non-flat
  diagonal, zero where the normal is zero
  (``informationmatrixcalculator.cpp:9-59``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..ops import sym6
from ..ops.eigh3x3 import eigh3x3_planar
from ..ops.integral_image import window_moments_planar
from .cloud import Cloud
from .projector import PinholeProjector


@dataclass(frozen=True)
class ConverterConfig:
    """Defaults follow ``StatsCalculatorIntegralImage`` /
    ``InformationMatrixCalculator`` constructors and the reference conf files
    (``pwn_core/conf/pwn_aligner_1_1.conf``)."""

    world_radius: float = 0.1
    min_image_radius: int = 10
    max_image_radius: int = 30
    min_points: int = 50
    curvature_threshold: float = 0.02
    # Number of static window-radius levels (geometric between min/max image
    # radius). Per-pixel-exact radii need an arbitrary gather; a few
    # shifted-slice passes + select are pure elementwise work. 0 = exact.
    # The level count was chosen on another machine: the GPU, which gathers
    # through its L2, should re-decide it by measurement.
    n_radius_levels: int = 4
    # point information (tangent-frame diagonal): strong along normal
    point_flat_info: tuple = (1000.0, 1.0, 1.0)
    # normal information diagonals
    normal_flat_info: tuple = (100.0, 100.0, 100.0)
    normal_nonflat_info: tuple = (1.0, 1.0, 1.0)


@partial(jax.jit, static_argnames=("projector", "config"))
def depth_to_cloud(
    depth,
    projector: PinholeProjector,
    config: ConverterConfig = ConverterConfig(),
    sensor_offset=None,
) -> Cloud:
    """Convert a (H, W) depth image to an image-organized Cloud."""
    cfg = config
    points, valid = projector.unproject(depth)
    p = jnp.moveaxis(points, -1, 0)  # (3, H, W) channel planes

    radii = projector.project_intervals(depth, cfg.world_radius)
    radii = jnp.clip(radii, cfg.min_image_radius, cfg.max_image_radius)

    levels = None
    if cfg.n_radius_levels > 0:
        lo, hi = cfg.min_image_radius, cfg.max_image_radius
        n_lev = min(cfg.n_radius_levels, hi - lo + 1)
        levels = tuple(
            sorted(
                {
                    int(round(lo * (hi / lo) ** (k / max(n_lev - 1, 1))))
                    for k in range(n_lev)
                }
            )
        )
    n, mean, cov6 = window_moments_planar(p, valid, radii, levels=levels)
    enough = valid & (n >= cfg.min_points)

    lam, V = eigh3x3_planar(cov6)  # 3 eigenvalue planes, 3 column tuples
    lam = tuple(jnp.maximum(l, 0.0) for l in lam)
    v0 = V[0]  # smallest-eigenvalue direction = surface normal
    # flip toward the viewpoint (camera at origin): n . p < 0
    flip = v0[0] * p[0] + v0[1] * p[1] + v0[2] * p[2] > 0
    sgn = jnp.where(flip, -1.0, 1.0)
    normal = tuple(sgn * v0[k] for k in range(3))
    # (omega = U diag U^T is invariant to eigenvector sign; V left as-is)

    curv = lam[0] / jnp.maximum(lam[0] + lam[1] + lam[2], 1e-12)
    flat = curv < cfg.curvature_threshold
    has_normal = enough & flat  # reference zeroes normals on curved areas
    hn = has_normal.astype(depth.dtype)
    normal = tuple(hn * nk for nk in normal)

    # point information matrices: U diag(info) U^T in the local frame
    inv_lam = tuple(1.0 / jnp.maximum(l, 1e-7) for l in lam)
    diag = tuple(
        jnp.where(flat, cfg.point_flat_info[k], inv_lam[k]) for k in range(3)
    )
    omega_p = hn[None] * sym6.sym_from_diag_frame(V, diag)

    # normal information: per-pixel diagonal (flat vs non-flat)
    z = jnp.zeros_like(curv)
    nf, nn = cfg.normal_flat_info, cfg.normal_nonflat_info
    on_diag = tuple(jnp.where(flat, nf[k], nn[k]) * hn for k in range(3))
    omega_n = jnp.stack([on_diag[0], z, z, on_diag[1], z, on_diag[2]])

    eg = enough.astype(depth.dtype)
    cloud = Cloud(
        p=p,
        n=jnp.stack(normal),
        curv=jnp.where(enough, curv, 1.0),
        ev=jnp.stack([eg * l for l in lam]),
        evec=jnp.stack([V[k][i] for k in range(3) for i in range(3)]),
        op=omega_p,
        on=omega_n,
        valid=valid,
    )
    if sensor_offset is not None:
        cloud = cloud.transform(sensor_offset)
    return cloud
