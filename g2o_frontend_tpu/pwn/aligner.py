"""PWN dense point-with-normal alignment — the flagship compute path.

JAX re-design of ``pwn_core/aligner.cpp`` + ``pwn_cuda/cudaaligner.cu``:
the reference's OpenMP/CUDA loop (project reference -> per-pixel gated
correspondences -> accumulate 6x6 H and 6-vector b -> damped solve) becomes
one jitted XLA program per outer iteration:

- projective association: by default each current pixel is mapped into
  the reference image and the reference attributes are fetched with one
  gather; ``association="zbuffer"`` re-renders the reference with the
  deterministic two-pass z-buffer (projector.project) instead, replacing
  the serial depth race (``pinholepointprojector.cpp:52-65``) and the CUDA
  atomic-free kernel (``cudaaligner.cu:476-557``),
- per-pixel correspondence gates exactly as ``correspondencefinder.cpp:20-118``
  (both normals nonzero, angular dot >= threshold, squared distance, clamped
  curvature ratio) evaluated as one fused mask — no compaction,
- per-pixel 4D point+normal error with the reference's robust clamp
  (chi2 > inlierMaxChi2 -> scale b by sqrt(maxChi2/chi2), H unscaled —
  preserving the reference's asymmetric robustification,
  ``linearizer.cpp:67-89``),
- H/b reduction is a masked sum over the image (XLA emits the tiled
  reduction that ``Aligner_coolIterationKernel`` does in shared memory,
  ``cudaaligner.cu:361-406``),
- damped 6x6 solve ``dx = -(H + I + 1000 I)^-1 b`` and chart update
  ``invT <- v2t(dx) * invT`` (``aligner.cpp:88-116``),
- solution statistics: re-linearize at the optimum, unscented remap of the
  local covariance through T, information matrix + translational/rotational
  eigenratio validity gates (``aligner.cpp:128-199``).

The local perturbation chart is the reference's quaternion chart
(``bm_se3.h``): J = [I | -2 skew(p)] for points, [0 | -2 skew(n)] for
normals — the factor 2 is the d(quat2mat)/dq at identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import sym6
from ..utils import lie
from .cloud import Cloud
from .projector import PinholeProjector


ASSOCIATIONS = ("gather", "zbuffer")


@dataclass(frozen=True)
class AlignerConfig:
    """Defaults = reference constructor values (``aligner.cpp:14-37``,
    ``correspondencefinder.cpp:9-18``, ``linearizer.cpp:9-15``)."""

    outer_iterations: int = 10
    inner_iterations: int = 1
    # correspondence gates
    inlier_distance_threshold: float = 0.5
    inlier_normal_angular_threshold: float = 0.866025  # cos(pi/6)
    flat_curvature_threshold: float = 0.02
    inlier_curvature_ratio_threshold: float = 1.3
    # robust kernel
    inlier_max_chi2: float = 9e3
    robust_kernel: bool = True
    # damping (reference adds I + 1000 I to H, aligner.cpp:92-94)
    damping: float = 1001.0
    # validity gates (aligner.cpp:29-30)
    translational_min_eigen_ratio: float = 50.0
    rotational_min_eigen_ratio: float = 50.0
    min_inliers: int = 100
    # projective association:
    #   "gather"  - cur->ref projective lookup, one packed XLA gather per
    #               outer iteration (the production path)
    #   "zbuffer" - reference-parity re-render of the reference cloud
    #               (two-pass z-buffer, ``correspondencefinder.cpp:20-118``);
    #               the tests' reference for the gather path
    association: str = "gather"

    def __post_init__(self):
        if self.association not in ASSOCIATIONS:
            raise ValueError(
                f"association must be one of {ASSOCIATIONS}, "
                f"got {self.association!r}"
            )


class SE3Prior(NamedTuple):
    """Gaussian prior on the transform being estimated (``se3_prior.h:28-107``).

    The reference's two variants both reduce to an error
    ``e(invT) = t2v(invT @ mean_matrix)`` with a constant mean matrix:
    relative prior -> ``mean_matrix = priorMean`` (``se3_prior.cpp:59``),
    absolute prior -> ``mean_matrix = referenceTransform^-1 @ priorMean``
    (``se3_prior.cpp:69``). Jacobians are exact forward-mode derivatives
    through the quaternion chart instead of the reference's central
    differences (``se3_prior.cpp:8-46``).
    """

    mean: jnp.ndarray  # (4, 4) the constant mean matrix M above
    information: jnp.ndarray  # (6, 6) prior information in the chart at M


def absolute_prior(reference_transform, prior_mean, information) -> SE3Prior:
    """`SE3AbsolutePrior` (``se3_prior.h:85-106``) as an `SE3Prior`."""
    return SE3Prior(lie.se3_inverse(reference_transform) @ prior_mean,
                    jnp.asarray(information))


def _prior_system(prior: SE3Prior, invT):
    """H, b contributions of one prior at invT (``aligner.cpp:96-108``)."""
    e = lie.se3_t2v(invT @ prior.mean)

    def err_left(eps):  # perturbation of the estimate: v2t(eps) * invT
        return lie.se3_t2v(lie.se3_v2t(eps) @ invT @ prior.mean)

    def err_mean(eps):  # perturbation of the prior mean: M * v2t(eps)
        return lie.se3_t2v(invT @ prior.mean @ lie.se3_v2t(eps))

    zero = jnp.zeros(6, invT.dtype)
    J = jax.jacfwd(err_left)(zero)
    Jz = jax.jacfwd(err_mean)(zero)
    # information remapped into the error space: Jz^-T Omega Jz^-1
    iJz = jnp.linalg.inv(Jz)
    omega_e = iJz.T @ prior.information @ iJz
    JtO = J.T @ omega_e
    return JtO @ J, JtO @ e


class AlignResult(NamedTuple):
    T: jnp.ndarray  # (4, 4) current -> reference transform (reference `_T`)
    mean: jnp.ndarray  # (6,) t2v mean of the solution distribution
    omega: jnp.ndarray  # (6, 6) information of T in the t2v chart
    inliers: jnp.ndarray  # () int
    chi2: jnp.ndarray  # () robust error at optimum
    translational_ratio: jnp.ndarray  # () eigenratio validity stats
    rotational_ratio: jnp.ndarray
    valid: jnp.ndarray  # () bool (eigenratio + min-inlier gates)


def _pixel_of_planar(projector, x, y, z):
    """projector.pixel_of on channel planes (pinhole / cylindrical)."""
    if hasattr(projector, "fx"):
        d = z
        safe = jnp.where(d == 0, 1e-9, d)
        u = x / safe * projector.fx + projector.cx
        v = y / safe * projector.fy + projector.cy
        return u, v, d
    # cylindrical (projector.pixel_of, cylindricalpointprojector.h)
    theta = jnp.arctan2(x, z)
    r = jnp.sqrt(x * x + z * z)
    u = theta * projector._ares() + projector.cols * 0.5
    v = (
        y / jnp.maximum(r, 1e-9) * projector.vertical_focal
        + projector.rows * projector.vertical_center
    )
    return u, v, r


def _correspondences_gather(ref: Cloud, cur: Cloud, invT, projector, cfg):
    """Gather-based projective association (the production path).

    For every *current* pixel: map its point into the reference frame
    (T = invT^-1), project into the reference image, and fetch the reference
    point/normal/curvature stored at that pixel — one packed 2D gather, no
    scatter. This is the KinectFusion-style inversion of the reference's
    render-the-reference z-buffer association
    (``correspondencefinder.cpp:20-118``): behaviorally equivalent under the
    same gates (the distance gate subsumes occlusion rejection), but maps to
    a single vectorized gather instead of two scatters + gather. All math is
    channel-planar (Cloud storage layout).
    """
    Rinv = invT[:3, :3].T
    tinv = -Rinv @ invT[:3, 3]
    cx, cy, cz = sym6.rot_apply(Rinv, (cur.p[0], cur.p[1], cur.p[2]))
    cx, cy, cz = cx + tinv[0], cy + tinv[1], cz + tinv[2]
    u, v, d = _pixel_of_planar(projector, cx, cy, cz)
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    H, W = projector.rows, projector.cols
    inside = (
        cur.valid
        & (d > projector.min_distance)
        & (d < projector.max_distance)
        & (ui >= 0)
        & (ui < W)
        & (vi >= 0)
        & (vi < H)
    )
    idx = jnp.clip(vi, 0, H - 1) * W + jnp.clip(ui, 0, W - 1)
    # one packed gather: [points(3), normals(3), curvature, valid]
    table = jnp.concatenate(
        [ref.p, ref.n, ref.curv[None], ref.valid[None].astype(ref.p.dtype)], 0
    ).reshape(8, -1)
    got = jnp.take(table, idx.reshape(-1), axis=1).reshape(8, H, W)
    rp, rn = got[0:3], got[3:6]
    ref_curv, ref_ok = got[6], got[7] > 0

    R, t = invT[:3, :3], invT[:3, 3]
    rpc = sym6.rot_apply(R, (rp[0], rp[1], rp[2]))
    rpc = (rpc[0] + t[0], rpc[1] + t[1], rpc[2] + t[2])
    rnc = sym6.rot_apply(R, (rn[0], rn[1], rn[2]))
    cur_has_n = cur.n[0] ** 2 + cur.n[1] ** 2 + cur.n[2] ** 2 > 0
    ref_has_n = rn[0] ** 2 + rn[1] ** 2 + rn[2] ** 2 > 0
    dot = cur.n[0] * rnc[0] + cur.n[1] * rnc[1] + cur.n[2] * rnc[2]
    dist2 = sum((cur.p[k] - rpc[k]) ** 2 for k in range(3))
    cthr = cfg.flat_curvature_threshold
    rc = jnp.maximum(ref_curv, cthr)
    cc = jnp.maximum(cur.curv, cthr)
    ratio = (rc + 1e-5) / (cc + 1e-5)
    mask = (
        inside
        & ref_ok
        & cur_has_n
        & ref_has_n
        & (dot >= cfg.inlier_normal_angular_threshold)
        & (dist2 <= cfg.inlier_distance_threshold**2)
        & (ratio >= 1.0 / cfg.inlier_curvature_ratio_threshold)
        & (ratio <= cfg.inlier_curvature_ratio_threshold)
    )
    return mask, rp, rn


def _linearize_planar(mask, rp, rn, cur: Cloud, invT, cfg):
    """Planar-layout twin of `_linearize`: all per-pixel algebra is
    elementwise over (H, W) planes; H/b/chi2/inliers come out of 29 plane
    reductions (one fused XLA loop over the image)."""
    dtype = rp.dtype
    R, t = invT[:3, :3], invT[:3, 3]
    p = sym6.rot_apply(R, (rp[0], rp[1], rp[2]))
    p = (p[0] + t[0], p[1] + t[1], p[2] + t[2])
    n = sym6.rot_apply(R, (rn[0], rn[1], rn[2]))
    op, on = cur.op, cur.on
    ep = tuple(p[k] - cur.p[k] for k in range(3))
    en = tuple(n[k] - cur.n[k] for k in range(3))
    wp = sym6.sym_apply(op, ep)
    wn = sym6.sym_apply(on, en)
    local_chi2 = sum(ep[k] * wp[k] for k in range(3)) + sum(
        en[k] * wn[k] for k in range(3)
    )
    kscale = jnp.where(
        local_chi2 > cfg.inlier_max_chi2,
        jnp.sqrt(cfg.inlier_max_chi2 / jnp.maximum(local_chi2, 1e-12)),
        1.0,
    )
    if not cfg.robust_kernel:
        mask = mask & (local_chi2 <= cfg.inlier_max_chi2)
        kscale = jnp.ones_like(kscale)
    m = mask.astype(dtype)
    mk = m * kscale

    # columns of S(p) = -2 hat(p) and S(n) (the quaternion-chart jacobian)
    z = jnp.zeros_like(p[0])
    s = [(z, -2 * p[2], 2 * p[1]), (2 * p[2], z, -2 * p[0]), (-2 * p[1], 2 * p[0], z)]
    tn = [(z, -2 * n[2], 2 * n[1]), (2 * n[2], z, -2 * n[0]), (-2 * n[1], 2 * n[0], z)]
    c = [sym6.sym_apply(op, sj) for sj in s]  # columns of omega_p @ S(p)
    d = [sym6.sym_apply(on, tj) for tj in tn]

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    rows = []
    rows += [m * ch for ch in op]  # Htt upper triangle (6)
    rows += [m * c[j][i] for i in range(3) for j in range(3)]  # Htr (9)
    rows += [
        m * (dot3(s[i], c[j]) + dot3(tn[i], d[j]))
        for i in range(3)
        for j in range(i, 3)
    ]  # Hrr upper triangle (6)
    rows += [mk * wp[k] for k in range(3)]  # b_t
    crx = p[1] * wp[2] - p[2] * wp[1] + n[1] * wn[2] - n[2] * wn[1]
    cry = p[2] * wp[0] - p[0] * wp[2] + n[2] * wn[0] - n[0] * wn[2]
    crz = p[0] * wp[1] - p[1] * wp[0] + n[0] * wn[1] - n[1] * wn[0]
    rows += [2 * mk * crx, 2 * mk * cry, 2 * mk * crz]  # b_r = S^T w sums
    rows += [mk * local_chi2, m]
    sums = jnp.stack([r.sum() for r in rows])  # (29,)

    def sym(v):
        return jnp.stack(
            [
                jnp.stack([v[0], v[1], v[2]]),
                jnp.stack([v[1], v[3], v[4]]),
                jnp.stack([v[2], v[4], v[5]]),
            ]
        )

    Htt, Htr, Hrr = sym(sums[0:6]), sums[6:15].reshape(3, 3), sym(sums[15:21])
    Hm = jnp.block([[Htt, Htr], [Htr.T, Hrr]])
    return Hm, sums[21:27], sums[27], sums[28].astype(jnp.int32)


def _correspondences(ref: Cloud, cur: Cloud, invT, projector: PinholeProjector, cfg):
    """Per-pixel correspondence fields aligned with the current image.

    Projects the reference cloud (mapped by invT into the current frame) with
    the z-buffer, then gathers the winning reference attributes per pixel and
    applies the four reference gates. Returns (mask, ref_pts, ref_nrm,
    ref_curv) in the *reference frame* (ungated values arbitrary where
    mask=False).
    """
    R, t = invT[:3, :3], invT[:3, 3]
    ref_in_cur = jnp.einsum("ij,hwj->hwi", R, ref.points) + t
    _, idx = projector.project(ref_in_cur, ref.valid)
    hit = idx >= 0
    idx_safe = jnp.maximum(idx, 0)
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    ref_pts = flat(ref.points)[idx_safe]
    ref_nrm = flat(ref.normals)[idx_safe]
    ref_curv = flat(ref.curvature)[idx_safe]

    # gates (correspondencefinder.cpp:60-103), evaluated in the current frame
    ref_pts_cur = jnp.einsum("ij,hwj->hwi", R, ref_pts) + t
    ref_nrm_cur = jnp.einsum("ij,hwj->hwi", R, ref_nrm)
    cur_has_n = jnp.sum(cur.normals * cur.normals, -1) > 0
    ref_has_n = jnp.sum(ref_nrm * ref_nrm, -1) > 0
    dot = jnp.sum(cur.normals * ref_nrm_cur, -1)
    dist2 = jnp.sum((cur.points - ref_pts_cur) ** 2, -1)
    cthr = cfg.flat_curvature_threshold
    rc = jnp.maximum(ref_curv, cthr)
    cc = jnp.maximum(cur.curvature, cthr)
    ratio = (rc + 1e-5) / (cc + 1e-5)
    mask = (
        hit
        & cur.valid
        & cur_has_n
        & ref_has_n
        & (dot >= cfg.inlier_normal_angular_threshold)
        & (dist2 <= cfg.inlier_distance_threshold**2)
        & (ratio >= 1.0 / cfg.inlier_curvature_ratio_threshold)
        & (ratio <= cfg.inlier_curvature_ratio_threshold)
    )
    return mask, ref_pts, ref_nrm


def _linearize(mask, ref_pts, ref_nrm, cur: Cloud, invT, cfg):
    """Masked H (6,6), b (6,), chi2, inliers for e = invT*ref - cur.

    Mirrors ``linearizer.cpp:17-115`` including the asymmetric robust
    scaling (kscale on b/error only).
    """
    R, t = invT[:3, :3], invT[:3, 3]
    p = jnp.einsum("ij,hwj->hwi", R, ref_pts) + t  # remapped reference point
    n = jnp.einsum("ij,hwj->hwi", R, ref_nrm)

    ep = p - cur.points  # (H, W, 3)
    en = n - cur.normals
    wp = jnp.einsum("hwij,hwj->hwi", cur.omega_p, ep)
    wn = jnp.einsum("hwij,hwj->hwi", cur.omega_n, en)
    local_chi2 = jnp.sum(ep * wp, -1) + jnp.sum(en * wn, -1)

    kscale = jnp.where(
        local_chi2 > cfg.inlier_max_chi2,
        jnp.sqrt(cfg.inlier_max_chi2 / jnp.maximum(local_chi2, 1e-12)),
        1.0,
    )
    if not cfg.robust_kernel:
        mask = mask & (local_chi2 <= cfg.inlier_max_chi2)
        kscale = jnp.ones_like(kscale)
    m = mask.astype(p.dtype)

    # J_p = [I | -2 skew(p)]; J_n = [0 | -2 skew(n)]  (quaternion chart)
    # Using S(v) x = -2 v × x  (the reference's skew has the -2 baked in,
    # bm_se3.h:53-65 with transposed sign convention).
    def S_apply(v, x):  # S(v) @ x = -2 cross(v, x)
        return -2.0 * jnp.cross(v, x)

    # b_t = sum m*kscale * wp ; b_r = sum m*kscale * (S(p)^T wp + S(n)^T wn)
    # S^T y = +2 cross(v, y)
    bt = jnp.sum((m * kscale)[..., None] * wp, (0, 1))
    br_terms = 2.0 * jnp.cross(p, wp) + 2.0 * jnp.cross(n, wn)
    br = jnp.sum((m * kscale)[..., None] * br_terms, (0, 1))
    b = jnp.concatenate([bt, br])

    # H blocks (unscaled by kscale, as in the reference):
    # Htt = sum omega_p
    Htt = jnp.sum(m[..., None, None] * cur.omega_p, (0, 1))
    # Htr = sum omega_p S(p): columns = omega_p @ S e_k -> compute via basis
    eye = jnp.eye(3, dtype=p.dtype)
    # S(p) as explicit matrix: S[i, j] = -2 * cross(p)[i, j] => build batched
    def skew2(v):  # (-2 * hat(v)) with hat(v) x = v × x
        z = jnp.zeros_like(v[..., 0])
        return -2.0 * jnp.stack(
            [
                jnp.stack([z, -v[..., 2], v[..., 1]], -1),
                jnp.stack([v[..., 2], z, -v[..., 0]], -1),
                jnp.stack([-v[..., 1], v[..., 0], z], -1),
            ],
            -2,
        )

    Sp = skew2(p)
    Sn = skew2(n)
    mw = m[..., None, None]
    OmSp = jnp.einsum("hwij,hwjk->hwik", cur.omega_p, Sp)
    Htr = jnp.sum(mw * OmSp, (0, 1))
    Hrr = jnp.sum(
        mw
        * (
            jnp.einsum("hwji,hwjk->hwik", Sp, OmSp)
            + jnp.einsum(
                "hwji,hwjk->hwik",
                Sn,
                jnp.einsum("hwij,hwjk->hwik", cur.omega_n, Sn),
            )
        ),
        (0, 1),
    )
    H = jnp.zeros((6, 6), p.dtype)
    H = H.at[:3, :3].set(Htt)
    H = H.at[:3, 3:].set(Htr)
    H = H.at[3:, :3].set(Htr.T)
    H = H.at[3:, 3:].set(Hrr)

    chi2 = jnp.sum(m * kscale * local_chi2)
    inliers = jnp.sum(mask)
    return H, b, chi2, inliers


@partial(jax.jit, static_argnames=("projector", "config"))
def align(
    reference: Cloud,
    current: Cloud,
    projector: PinholeProjector,
    initial_guess=None,
    config: AlignerConfig = AlignerConfig(),
    priors: SE3Prior | None = None,
) -> AlignResult:
    """Estimate T (current -> reference) between two clouds.

    The outer loop is a `lax.fori_loop` over `outer_iterations`; each body
    recomputes gated correspondences (``config.association``) and runs
    `inner_iterations` Gauss-Newton updates, all on the device.

    `priors` optionally adds Gaussian transform priors to every Gauss-Newton
    system (``aligner.cpp:96-108``); pass an `SE3Prior` with leading batch
    dims for multiple priors.

    Every contraction is pinned to full float32: a GPU may otherwise run
    float32 matmuls (the z-buffer path's einsums, the statistics) in TF32.
    """
    with jax.default_matmul_precision("highest"):
        return _align(reference, current, projector, initial_guess, config,
                      priors)


def _align(reference, current, projector, initial_guess, cfg, priors):
    dtype = reference.points.dtype
    T0 = jnp.eye(4, dtype=dtype) if initial_guess is None else initial_guess

    if cfg.association == "gather":
        # channel-planar hot path (the Cloud storage layout)

        def assoc_fn(invT):
            return _correspondences_gather(reference, current, invT, projector, cfg)

        def lin_fn(mask, rp, rn, invT):
            return _linearize_planar(mask, rp, rn, current, invT, cfg)

    else:

        def assoc_fn(invT):
            return _correspondences(reference, current, invT, projector, cfg)

        def lin_fn(mask, rp, rn, invT):
            return _linearize(mask, rp, rn, current, invT, cfg)

    def add_priors(H, b, invT):
        if priors is None:
            return H, b
        if priors.mean.ndim == 2:
            Hp, bp = _prior_system(priors, invT)
            return H + Hp, b + bp
        Hp, bp = jax.vmap(lambda m, o: _prior_system(SE3Prior(m, o), invT))(
            priors.mean, priors.information
        )
        return H + jnp.sum(Hp, 0), b + jnp.sum(bp, 0)

    def gn_step(H, b, invT):
        H = H + cfg.damping * jnp.eye(6, dtype=dtype)
        H, b = add_priors(H, b, invT)
        dx = jnp.linalg.solve(H, -b)
        return lie.se3_v2t(dx) @ invT

    def outer(i, invT):
        mask, ref_pts, ref_nrm = assoc_fn(invT)

        def inner(k, invT):
            H, b, _, _ = lin_fn(mask, ref_pts, ref_nrm, invT)
            return gn_step(H, b, invT)

        invT = jax.lax.fori_loop(0, cfg.inner_iterations, inner, invT)
        # re-orthonormalize through the chart (aligner.cpp:117)
        return lie.se3_v2t(lie.se3_t2v(invT))

    invT0 = lie.se3_inverse(T0)
    invT = jax.lax.fori_loop(0, cfg.outer_iterations, outer, invT0)
    T = lie.se3_inverse(invT)

    # ---- statistics at the optimum (aligner.cpp:152-199) ----
    mask, ref_pts, ref_nrm = assoc_fn(invT)
    H, b, chi2, inliers = lin_fn(mask, ref_pts, ref_nrm, invT)
    return _finalize_stats(T, H, chi2, inliers, cfg)


def _finalize_stats(T, H, chi2, inliers, cfg) -> AlignResult:
    """Post-loop statistics (aligner.cpp:152-199): unscented remap of the
    local information to the chart at T, eigenratio validity gates."""
    dtype = T.dtype
    H = H + jnp.eye(6, dtype=dtype)
    # H is PD after the +I regularization: a solve instead of pinv's SVD
    local_sigma = jnp.linalg.solve(H, jnp.eye(6, dtype=dtype))

    # unscented remap of N(0, local_sigma) through p -> t2v(T * v2t(p)^-1)
    dim = 6
    alpha, beta = 1e-3, 2.0
    lam_u = alpha * alpha * dim
    w0 = lam_u / (dim + lam_u)
    wi = 1.0 / (2.0 * (dim + lam_u))
    w0_cov = w0 + (1.0 - alpha * alpha + beta)
    L = jnp.linalg.cholesky(
        (dim + lam_u) * local_sigma + 1e-9 * jnp.eye(6, dtype=dtype)
    )
    cols = L.T  # rows are scaled columns of L
    pts = jnp.concatenate([jnp.zeros((1, 6), dtype), cols, -cols], 0)  # (13, 6)

    def remap(p):
        return lie.se3_t2v(T @ lie.se3_inverse(lie.se3_v2t(p)))

    samples = jax.vmap(remap)(pts)
    wi_vec = jnp.concatenate([jnp.array([w0], dtype), jnp.full((12,), wi, dtype)])
    wp_vec = jnp.concatenate([jnp.array([w0_cov], dtype), jnp.full((12,), wi, dtype)])
    mean = jnp.sum(wi_vec[:, None] * samples, 0)
    delta = samples - mean
    sigma = jnp.einsum("k,ki,kj->ij", wp_vec, delta, delta)
    omega = jnp.linalg.solve(
        sigma + 1e-9 * jnp.eye(6, dtype=dtype), jnp.eye(6, dtype=dtype)
    )

    # eigenratio gates via the analytic symmetric-3x3 eigenvalues (ascending;
    # omega blocks are PSD so singular values == eigenvalues) — replaces two
    # tiny SVDs
    from ..ops.eigh3x3 import eigvals3x3

    st = eigvals3x3(omega[:3, :3])
    sr = eigvals3x3(omega[3:, 3:])
    tr_ratio = st[2] / jnp.maximum(st[0], 1e-12)
    rr_ratio = sr[2] / jnp.maximum(sr[0], 1e-12)
    valid = (
        (tr_ratio <= cfg.translational_min_eigen_ratio)
        & (rr_ratio <= cfg.rotational_min_eigen_ratio)
        & (inliers >= cfg.min_inliers)
    )
    return AlignResult(T, mean, omega, inliers, chi2, tr_ratio, rr_ratio, valid)


@partial(jax.jit, static_argnames=("projector", "config"))
def align_batch(
    references: Cloud,
    current: Cloud,
    projector: PinholeProjector,
    initial_guesses,
    config: AlignerConfig = AlignerConfig(),
) -> AlignResult:
    """K alignments of stacked candidate reference clouds against ONE shared
    current cloud (the closer's batched candidate matching,
    ``pwn_closer.cpp:92-110`` done as one program — SURVEY §7 Phase 5), as
    `vmap(align)`. Returns an AlignResult with leading dim K.
    """
    return jax.vmap(
        lambda ref, g: align(ref, current, projector, g, config)
    )(references, initial_guesses)
