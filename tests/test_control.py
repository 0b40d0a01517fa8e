"""Accuracy control: float64 sparse-Cholesky host solver vs the device solvers.

BASELINE.md requires accuracy claims to be grounded in a control run of the
reference protocol; solvers/control.py plays the g2o+CHOLMOD role
(``map_g2o_reflector.h:50-74``). These tests pin the bundled graphs' optima
and assert the jitted solvers reach them.
"""
import os

import numpy as np
import pytest

from g2o_frontend_tpu.graph.store import graph2d_from_log
from g2o_frontend_tpu.io.g2o import read_g2o
from g2o_frontend_tpu.solvers.control import control_optimize_se2
from g2o_frontend_tpu.solvers.pose_graph import optimize_se2, optimize_se2_direct

from tests.test_partitioned import _ring_graph

DATA = "/root/reference/datasets/2D"


def test_control_matches_pcg_and_direct_on_ring():
    g = _ring_graph()
    ctl = control_optimize_se2(g, max_iters=100)
    g1, s1 = optimize_se2(g, iters=15, cg_iters=100)
    g2, s2 = optimize_se2_direct(g, iters=15)
    chi_pcg = float(np.asarray(s1.chi2)[-1])
    chi_dir = float(np.asarray(s2.chi2)[-1])
    assert chi_pcg == pytest.approx(ctl["chi2"], rel=1e-2)
    assert chi_dir == pytest.approx(ctl["chi2"], rel=1e-3)


@pytest.mark.skipif(not os.path.isdir(DATA), reason="reference datasets missing")
def test_world2000_full_optimum():
    """The bundled world-2000-full graph's optimum chi2 (control-established:
    7657.55; round-1 EVAL's 'stall' at 7658 was in fact convergence)."""
    log = read_g2o(os.path.join(DATA, "world-2000-full.g2o.gz"))
    g, _ = graph2d_from_log(log)
    ctl = control_optimize_se2(g, max_iters=30)
    assert ctl["chi2"] == pytest.approx(7657.55, rel=1e-3)
    gd, sd = optimize_se2_direct(g, iters=8)
    assert float(np.asarray(sd.chi2)[-1]) == pytest.approx(ctl["chi2"], rel=1e-4)


@pytest.mark.skipif(not os.path.isdir(DATA), reason="reference datasets missing")
def test_graphse2_optimum_near_zero():
    log = read_g2o(os.path.join(DATA, "graphSE2.g2o"))
    g, _ = graph2d_from_log(log)
    ctl = control_optimize_se2(g, max_iters=50)
    g1, s1 = optimize_se2(g, iters=10, cg_iters=100)
    assert ctl["chi2"] < 1e-6
    assert float(np.asarray(s1.chi2)[-1]) < 1e-6


# ---------------------------------------------------------------------------
# SE3 + BA controls (VERDICT r3 Next 2): pin the optima, clear them on-chip
# ---------------------------------------------------------------------------


def _se3_ring(n=48, n_loop=6, noise=0.02, seed=0):
    """Noisy SE3 ring with loop closures — nonzero pinned optimum."""
    import jax.numpy as jnp

    from g2o_frontend_tpu.graph.store import PoseGraph3D, _cap
    from g2o_frontend_tpu.solvers.control import (_se3_exp64, _T_to_pose7_64)

    rng = np.random.default_rng(seed)
    T_gt = [np.eye(4)]
    for i in range(1, n):
        step = np.concatenate([[0.5, 0.0, 0.05], [0.0, 0.0, 2 * np.pi / n]])
        T_gt.append(T_gt[-1] @ _se3_exp64(step))
    T_gt = np.asarray(T_gt)

    ij, z = [], []
    for i in range(n - 1):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
        ij.append([i, i + 1])
        z.append(rel @ _se3_exp64(rng.normal(0, noise, 6)))
    for _ in range(n_loop):
        i = int(rng.integers(0, n))
        j = (i + n // 2) % n
        i, j = min(i, j), max(i, j)
        rel = np.linalg.inv(T_gt[i]) @ T_gt[j]
        ij.append([i, j])
        z.append(rel @ _se3_exp64(rng.normal(0, noise, 6)))
    E = len(ij)
    NP, EP = _cap(n), _cap(E)
    poses = np.zeros((NP, 7))
    poses[:, 6] = 1.0
    T_init = T_gt @ _se3_exp64(rng.normal(0, 0.05, (n, 6)))
    T_init[0] = T_gt[0]
    poses[:n] = _T_to_pose7_64(T_init)
    meas = np.zeros((EP, 7))
    meas[:, 6] = 1.0
    meas[:E] = _T_to_pose7_64(np.asarray(z))
    info = np.zeros((EP, 6, 6))
    info[:E] = np.diag([100.0] * 3 + [400.0] * 3)
    pp_ij = np.zeros((EP, 2), np.int32)
    pp_ij[:E] = ij
    fixed = np.zeros(NP, bool)
    fixed[0] = True
    return PoseGraph3D(
        poses=jnp.asarray(poses, jnp.float32),
        pose_mask=jnp.asarray(np.arange(NP) < n),
        pp_ij=jnp.asarray(pp_ij),
        pp_meas=jnp.asarray(meas, jnp.float32),
        pp_info=jnp.asarray(info, jnp.float32),
        pp_mask=jnp.asarray(np.arange(EP) < E),
        fixed=jnp.asarray(fixed),
    )


def test_control_se3_ring_pins_optimum_and_device_path_reaches_it():
    from g2o_frontend_tpu.solvers.control import control_optimize_se3
    from g2o_frontend_tpu.solvers.pose_graph import optimize_se3

    g = _se3_ring()
    ctl = control_optimize_se3(g, max_iters=60)
    assert ctl["chi2"] > 1.0  # noisy closures: genuinely nonzero optimum
    # float64 LM must strictly improve and converge
    assert ctl["chi2"] < 0.01 * ctl["trace"][0]
    g1, s1 = optimize_se3(g, iters=25, cg_iters=150, precond="chain")
    chi = float(np.asarray(s1.chi2)[-1])
    assert chi <= 1.01 * ctl["chi2"], (chi, ctl["chi2"])


@pytest.mark.skipif(not os.path.isdir(DATA), reason="reference datasets missing")
def test_control_se3_graphse3_chain_optimum_zero():
    """graphSE3.g2o is a pure odometry chain (451 edges, no closures): its
    optimum is exactly 0; both control and the chain-preconditioned f32
    solver must drive chi2 to the numerical floor."""
    from g2o_frontend_tpu.graph.store import graph3d_from_log
    from g2o_frontend_tpu.solvers.control import control_optimize_se3
    from g2o_frontend_tpu.solvers.pose_graph import optimize_se3

    log = read_g2o(os.path.join(DATA, "graphSE3.g2o"))
    g, _ = graph3d_from_log(log)
    ctl = control_optimize_se3(g, max_iters=30)
    chi0 = ctl["trace"][0]
    assert ctl["chi2"] < 1e-9 * max(chi0, 1.0), ctl["chi2"]
    g1, s1 = optimize_se3(g, iters=10, cg_iters=100, precond="chain")
    chi = float(np.asarray(s1.chi2)[-1])
    # f32 device path: floor is ~1e-7 relative on this graph
    assert chi < 1e-5 * max(chi0, 1.0), (chi, chi0)


def test_control_se3_reflector_graph():
    """Reflector-built PWN-SLAM-style graph (keyframe chain + accepted
    closures, graph/reflector.py) has a pinned optimum the device path hits."""
    from g2o_frontend_tpu.graph.map_manager import MapManager, MapRelation
    from g2o_frontend_tpu.graph.reflector import MapReflector
    from g2o_frontend_tpu.solvers.control import (_se3_exp64,
                                                  control_optimize_se3)
    from g2o_frontend_tpu.solvers.pose_graph import optimize_se3

    rng = np.random.default_rng(3)
    mgr = MapManager()
    T_gt = [np.eye(4)]
    n = 30
    for i in range(1, n):
        step = np.concatenate([[0.4, 0, 0], [0, 0, 2 * np.pi / n]])
        T_gt.append(T_gt[-1] @ _se3_exp64(step))
    nodes = []
    for i in range(n):
        T_noisy = T_gt[i] @ _se3_exp64(rng.normal(0, 0.03, 6)) \
            if i else T_gt[0]
        nodes.append(mgr.add_node(T_noisy))
    info = np.diag([100.0] * 3 + [400.0] * 3)
    for i in range(n - 1):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
        rel = rel @ _se3_exp64(rng.normal(0, 0.01, 6))
        mgr.add_relation(MapRelation(nodes[i], nodes[i + 1], rel, info))
    # two accepted closures (the PwnCloser consensus output shape)
    for i, j in [(0, n // 2), (2, n // 2 + 3)]:
        rel = np.linalg.inv(T_gt[i]) @ T_gt[j]
        rel = rel @ _se3_exp64(rng.normal(0, 0.01, 6))
        mgr.add_relation(MapRelation(nodes[i], nodes[j], rel, info,
                                     is_closure=True, accepted=True))
    g = MapReflector(mgr).build_graph(gauge_node=nodes[0])
    ctl = control_optimize_se3(g, max_iters=60)
    assert ctl["chi2"] < 0.05 * ctl["trace"][0]
    g1, s1 = optimize_se3(g, iters=25, cg_iters=150, precond="chain")
    chi = float(np.asarray(s1.chi2)[-1])
    assert chi <= 1.01 * ctl["chi2"] + 1e-8, (chi, ctl["chi2"])


def test_control_ba_pins_optimum_and_device_path_reaches_it():
    from g2o_frontend_tpu.solvers.ba import make_ba_problem, optimize_ba
    from g2o_frontend_tpu.solvers.control import (_se3_exp64,
                                                  _T_to_pose7_64,
                                                  control_optimize_ba)

    rng = np.random.default_rng(5)
    n_pose, n_pt = 6, 40
    T_gt = [np.eye(4)]
    for i in range(1, n_pose):
        T_gt.append(T_gt[-1] @ _se3_exp64(
            np.concatenate([[0.3, 0.1, 0], rng.normal(0, 0.1, 3)])))
    pts = rng.uniform(-3, 3, (n_pt, 3)) + [0, 0, 4.0]
    obs = []
    for i, T in enumerate(T_gt):
        Ti = np.linalg.inv(T)
        for l, p in enumerate(pts):
            zl = Ti[:3, :3] @ p + Ti[:3, 3]
            obs.append((i, l, zl + rng.normal(0, 0.01, 3), np.eye(3) * 100))
    poses7 = _T_to_pose7_64(
        np.asarray(T_gt) @ _se3_exp64(
            np.concatenate([np.zeros((1, 6)),
                            rng.normal(0, 0.05, (n_pose - 1, 6))]))
    )
    ba = make_ba_problem(poses7, pts + rng.normal(0, 0.1, pts.shape), obs)
    ctl = control_optimize_ba(ba, max_iters=60)
    assert 0 < ctl["chi2"] < 0.05 * ctl["trace"][0]
    ba_out, tr = optimize_ba(ba, iters=25, cg_iters=60)
    chi = float(np.asarray(tr)[-1])
    assert chi <= 1.01 * ctl["chi2"], (chi, ctl["chi2"])
