"""The aligner's two association paths against each other, on a small scene.

"gather" (the production path: cur->ref projective lookup) and "zbuffer"
(the reference-parity re-render of the reference cloud) must build the same
Gauss-Newton system and converge to the same motion; the batched closer's
`align_batch` must reproduce per-pair `align`.
"""
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

from g2o_frontend_tpu.pwn.aligner import (
    AlignerConfig,
    _correspondences,
    _correspondences_gather,
    _linearize,
    _linearize_planar,
    align,
    align_batch,
)
from g2o_frontend_tpu.pwn.converter import ConverterConfig, depth_to_cloud
from g2o_frontend_tpu.utils import lie
from g2o_frontend_tpu.utils.synth import default_projector, render_planes_depth

_CCFG = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
_XI = [0.02, -0.01, 0.03, 0.01, -0.008, 0.006]
# Five walls of an asymmetric box, all in view of the 96x128 camera: with
# a side wall missing, yaw and lateral translation are nearly degenerate
# (and pitch and vertical translation without floor and ceiling).
_BOX = [
    (np.array([0.0, 0.0, -1.0]), -2.5),  # back wall z = 2.5
    (np.array([-1.0, 0.0, 0.0]), -1.2),  # right wall x = 1.2
    (np.array([1.0, 0.0, 0.0]), -1.0),  # left wall x = -1.0
    (np.array([0.0, -1.0, 0.0]), -0.9),  # floor y = 0.9
    (np.array([0.0, 1.0, 0.0]), -0.7),  # ceiling y = -0.7
]


def _scene(xi=_XI, H=96, W=128):
    proj = default_projector(H=H, W=W)
    T = np.asarray(lie.se3_v2t(jnp.asarray(xi, jnp.float32)))
    ref = depth_to_cloud(render_planes_depth(np.eye(4), proj, _BOX), proj,
                         _CCFG)
    cur = depth_to_cloud(render_planes_depth(T, proj, _BOX), proj, _CCFG)
    return proj, ref, cur, T


def test_gather_system_matches_zbuffer_system():
    """At the true motion both associations find nearly the same
    correspondences, so H, b, chi2 and the inlier count agree. They differ
    at occlusion edges and in pixel rounding: the z-buffer rounds reference
    points into the current image, the gather current points into the
    reference image."""
    proj, ref, cur, T = _scene()
    cfg = AlignerConfig()
    invT = jnp.asarray(np.linalg.inv(T), jnp.float32)
    mask, rp, rn = _correspondences_gather(ref, cur, invT, proj, cfg)
    Hg, bg, chi2g, inlg = _linearize_planar(mask, rp, rn, cur, invT, cfg)
    mask, rp, rn = _correspondences(ref, cur, invT, proj, cfg)
    Hz, bz, chi2z, inlz = _linearize(mask, rp, rn, cur, invT, cfg)

    assert int(inlg) > 1000
    assert abs(int(inlg) - int(inlz)) <= 0.05 * int(inlz), (int(inlg), int(inlz))
    np.testing.assert_allclose(float(chi2g), float(chi2z), rtol=0.1)
    nH = float(jnp.linalg.norm(Hz))
    assert float(jnp.linalg.norm(Hg - Hz)) / nH < 0.05
    nb = float(jnp.linalg.norm(bz)) + 1.0
    assert float(jnp.linalg.norm(bg - bz)) / nb < 0.1


@pytest.mark.parametrize("name,xi", [
    ("small_mixed", _XI),
    ("translation_fwd", [0.0, 0.0, 0.12, 0.0, 0.0, 0.0]),
    ("rotation_yaw_5deg", [0.0, 0.0, 0.0, 0.0, 0.087, 0.0]),
    ("rotation_roll_5deg", [0.0, 0.0, 0.0, 0.0, 0.0, 0.087]),
    ("rotation_pitch_4deg_parallax", [0.0, 0.05, 0.0, 0.07, 0.0, 0.0]),
])
def test_gather_align_converges_across_motion_sweep(name, xi):
    """The motion envelope the keyframe tracker sees: translation, 5-degree
    rotations about each axis, and pitch with depth parallax."""
    proj, ref, cur, T_gt = _scene(xi)
    cfg = AlignerConfig(outer_iterations=10, inner_iterations=1)
    res = align(ref, cur, proj, config=cfg)
    t_err = float(np.linalg.norm(np.asarray(res.T)[:3, 3] - T_gt[:3, 3]))
    assert t_err < 5e-3, (name, t_err)
    assert int(res.inliers) > 1000, (name, int(res.inliers))


def test_align_batch_matches_align():
    """align_batch (the closer's K-candidate program) vs per-pair align."""
    proj, ref, cur, T_gt = _scene()
    cfg = AlignerConfig(outer_iterations=4, inner_iterations=1)
    refs = jtu.tree_map(lambda x: jnp.stack([x, x]), ref)
    guesses = jnp.stack([jnp.eye(4, dtype=jnp.float32),
                         jnp.asarray(T_gt, jnp.float32)])
    res_b = align_batch(refs, cur, proj, guesses, cfg)
    for k in range(2):
        res_1 = align(ref, cur, proj, initial_guess=guesses[k], config=cfg)
        np.testing.assert_allclose(np.asarray(res_b.T[k]), np.asarray(res_1.T),
                                   rtol=1e-4, atol=1e-5)
        assert int(res_b.inliers[k]) == int(res_1.inliers)


@pytest.mark.parametrize("association", ["fused", "auto"])
def test_config_rejects_removed_associations(association):
    with pytest.raises(ValueError, match="association"):
        AlignerConfig(association=association)
