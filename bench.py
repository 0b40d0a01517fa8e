"""Benchmark harness. Prints ONE JSON line with the headline metric.

Headline: PWN dense aligner frames/s at the reference's compute envelope —
640x480 depth, 10 outer x 1 inner iterations (``pwn_core/aligner.cpp:19-20``,
BASELINE.md "Aligner compute envelope") — on the XLA gather path.

``vs_baseline`` compares aligner frames/s against the same workload on the
host CPU backend (the reference's platform class; the reference publishes no
numbers — BASELINE.md).

Consistency is asserted, not assumed: the end-to-end tracker fps must be
strictly below the bare aligner fps (each tracker frame contains a full
align + a depth->cloud conversion), and every timing consumes all outputs
through the loop carry so XLA cannot dead-code-eliminate work (round-1's
tracker_fps_e2e=24,793 at align_fps=73 was exactly that failure mode).

It needs a GPU and exits non-zero without one. Every result names the
device it ran on (platform, device kind, device count).
"""
import json
import os
import sys
import time
from functools import partial

import numpy as np

import jax

from g2o_frontend_tpu.solvers.control import cached_control
from g2o_frontend_tpu.utils.synth import corner_align_problem

DATA = "/root/reference/datasets/2D"
EVAL_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "eval_out")


def _two_point(fn, lo, hi, tries=3):
    """Median of ((t_hi - t_lo) / (hi - lo)) over `tries` pairs.

    Both chain lengths are warmed first; the subtraction cancels dispatch
    constants, leaving per-step device time."""
    jax.block_until_ready(fn(n=lo))
    jax.block_until_ready(fn(n=hi))
    deltas = []
    for _ in range(tries):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(n=lo))
        t1 = time.perf_counter()
        jax.block_until_ready(fn(n=hi))
        t2 = time.perf_counter()
        deltas.append(((t2 - t1) - (t1 - t0)) / (hi - lo))
    return float(np.median(deltas))


def bench_pwn_aligner(device=None, H=480, W=640, reps=5):
    import jax.numpy as jnp

    from g2o_frontend_tpu.pwn.aligner import align
    from g2o_frontend_tpu.pwn.converter import depth_to_cloud

    d_ref, d_cur, proj, T_gt, ccfg, acfg = corner_align_problem(H, W)
    if device is not None:
        d_ref = jax.device_put(d_ref, device)
        d_cur = jax.device_put(d_cur, device)

    ref = depth_to_cloud(d_ref, proj, ccfg)
    cur = depth_to_cloud(d_cur, proj, ccfg)
    jax.block_until_ready(align(ref, cur, proj, config=acfg))  # compile

    # On-device chained loops: each align warm-starts from the previous
    # estimate (the tracker's steady-state pattern). The 1e-30-scaled stats
    # feed the loop carry so no output can be dead-code-eliminated.
    @partial(jax.jit, static_argnames=("n",))
    def align_chain(ref, cur, n):
        def body(i, T_guess):
            r = align(ref, cur, proj, initial_guess=T_guess, config=acfg)
            stats = (
                jnp.sum(r.omega) + r.chi2 + r.inliers
                + r.translational_ratio + r.rotational_ratio + jnp.sum(r.mean)
            )
            return r.T + (1e-30 * stats).astype(r.T.dtype)

        return jax.lax.fori_loop(0, n, body, jnp.eye(4, dtype=ref.p.dtype))

    @partial(jax.jit, static_argnames=("n",))
    def convert_chain(depth, n):
        def body(i, carry):
            c = depth_to_cloud(depth + 1e-30 * carry, proj, ccfg)
            return sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(c))

        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    dt_align = _two_point(partial(align_chain, ref, cur), 2, 2 + 4 * reps)
    dt_conv = _two_point(partial(convert_chain, d_cur), 5, 5 + 24 * reps)
    res = align(ref, cur, proj, config=acfg)

    T_est = np.asarray(res.T)
    err = np.linalg.inv(T_gt) @ T_est
    t_err = float(np.linalg.norm(err[:3, 3]))
    return {
        "align_fps": 1.0 / dt_align,
        "convert_fps": 1.0 / dt_conv,
        "t_err_m": t_err,
        "inliers": int(res.inliers),
    }


def bench_tracker(H=480, W=640, lo=4, hi=44):
    """End-to-end odometry frames/s: depth->cloud + 10-outer align +
    keyframe policy per frame, as one jitted on-device scan."""
    import jax.numpy as jnp

    from g2o_frontend_tpu.slam.pwn_tracker import odometry_scan

    d_ref, _, proj, _, ccfg, acfg = corner_align_problem(H, W)

    base = np.asarray(d_ref)

    def seq(n):
        frames = [base * (1.0 + 0.002 * (k % 5)) for k in range(n)]
        return jnp.asarray(np.stack(frames), jnp.float32)

    @jax.jit
    def run(depths):
        traj, m = odometry_scan(depths, proj, ccfg, acfg)
        # consume every output through the return value (incl. the omega /
        # eigenratio statistics — same work a bare align() performs)
        return (traj, m["inliers"].sum(), m["fraction"].sum(),
                m["omega_trace"].sum())

    s_lo, s_hi = seq(lo), seq(hi)

    def chain(s):
        jax.block_until_ready(run(s))

    chain(s_lo)
    chain(s_hi)
    deltas = []
    for _ in range(5):
        t0 = time.perf_counter()
        chain(s_lo)
        t1 = time.perf_counter()
        chain(s_hi)
        t2 = time.perf_counter()
        deltas.append(((t2 - t1) - (t1 - t0)) / (hi - lo))
    dt = float(np.median(deltas))
    spread = float(np.max(deltas) - np.min(deltas))
    return {"tracker_fps": 1.0 / dt, "tracker_dt_spread": spread / dt}


def victoria_control_chi2():
    def compute():
        from g2o_frontend_tpu.graph.store import graph2d_from_log
        from g2o_frontend_tpu.io.g2o import read_g2o
        from g2o_frontend_tpu.solvers.control import control_optimize_se2

        log = read_g2o(os.path.join(DATA, "victoriaPark-full.g2o.gz"))
        g, _ = graph2d_from_log(log)
        return control_optimize_se2(g, max_iters=300)["chi2"]

    return cached_control("victoria", compute, EVAL_OUT)


def bench_se3(device=None):
    """graphSE3 (452 poses, pure odometry chain) vs its float64 control.

    The chain's optimum is exactly 0; the gate is relative to the initial
    chi2 (the f32 floor sits ~1e-7 relative; control reaches ~1e-12).
    """
    from g2o_frontend_tpu.graph.store import graph3d_from_log
    from g2o_frontend_tpu.io.g2o import read_g2o
    from g2o_frontend_tpu.solvers.pose_graph import optimize_se3

    log = read_g2o(os.path.join(DATA, "graphSE3.g2o"))
    g, _ = graph3d_from_log(log)
    if device is not None:
        g = jax.device_put(g, device)

    def compute():
        from g2o_frontend_tpu.solvers.control import control_optimize_se3

        return control_optimize_se3(g, max_iters=30)["chi2"]

    control = cached_control("graphse3", compute, EVAL_OUT)

    def run():
        return jax.block_until_ready(
            optimize_se3(g, iters=10, cg_iters=100, precond="chain"))

    run()
    t0 = time.perf_counter()
    _, st = run()
    dt = time.perf_counter() - t0
    tr = np.asarray(st.chi2)
    return {
        "se3_chi2_init": float(tr[0]),
        "se3_chi2_final": float(tr[-1]),
        "se3_chi2_control": control,
        "se3_lm_iters_per_s": 10 / dt,
    }


def bench_pose_graph(device=None):
    """victoriaPark (7,120 poses + 151 landmarks): the hardest bundled graph.

    Headline chi2 comes from the Schur-complement + chain-preconditioned LM
    solver (solvers/schur_pcg.py) — the device path that reaches the float64
    control optimum (it in fact finds a better basin: ~21.9k vs the cold
    control's 22,572.55; warm-starting the control from its output converges
    to 21,814.9). The dense-Cholesky direct mode and plain block-Jacobi PCG
    are reported alongside.
    """
    from g2o_frontend_tpu.graph.store import graph2d_from_log
    from g2o_frontend_tpu.io.g2o import read_g2o
    from g2o_frontend_tpu.solvers.pose_graph import optimize_se2_direct
    from g2o_frontend_tpu.solvers.schur_pcg import optimize_se2_schur

    log = read_g2o(os.path.join(DATA, "victoriaPark-full.g2o.gz"))
    g, _ = graph2d_from_log(log)
    if device is not None:
        g = jax.device_put(g, device)

    # Schur solver: runs to convergence (early exit inside while_loop)
    SCHUR_ITERS = 150

    def run_schur():
        return jax.block_until_ready(
            optimize_se2_schur(g, iters=SCHUR_ITERS, cg_iters=200))

    run_schur()
    t0 = time.perf_counter()
    _, st = run_schur()
    dt_schur = time.perf_counter() - t0
    chi2 = float(np.asarray(st.chi2)[-1])
    lm_done = int(np.asarray(st.lm_iters))

    # exact-Newton mode (dense Cholesky + refinement through the factor);
    # victoriaPark has 21,209 DOF.
    DIRECT_ITERS = 80
    t0 = time.perf_counter()
    g_dir, st_dir = jax.block_until_ready(
        optimize_se2_direct(g, iters=DIRECT_ITERS))
    chi2_dir = float(np.asarray(st_dir.chi2)[-1])
    dt_dir = time.perf_counter() - t0
    dir_done = max(1, int(np.asarray(st_dir.cg_iters)))
    return {
        "lm_iters_per_s": max(lm_done, 1) / dt_schur,
        "chi2_final": chi2,
        "direct_chi2_final": chi2_dir,
        "direct_iters_per_s": dir_done / dt_dir,
        # float64 CHOLMOD-role control optimum — from the control solver's
        # own cached output, not a code constant (VERDICT r3 Next 4)
        "chi2_control": victoria_control_chi2(),
    }


def main():
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {jax.default_backend()!r}")
    from g2o_frontend_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    pwn = bench_pwn_aligner()
    pwn4 = bench_pwn_aligner(H=120, W=160, reps=10)
    trk = bench_tracker()
    pgo = bench_pose_graph()
    se3 = bench_se3()

    # internal consistency: e2e tracker cannot beat the bare aligner — each
    # tracker frame is a full align + a depth->cloud conversion. STRICT: no
    # tolerance factor; chain lengths/reps are sized so the measured spread
    # sits below the expected gap (the convert step alone is ~15-20% of a
    # frame), and the spread is reported alongside.
    assert trk["tracker_fps"] < pwn["align_fps"], (
        f"impossible: tracker_fps {trk['tracker_fps']:.1f} >= "
        f"align_fps {pwn['align_fps']:.1f} "
        f"(spread {trk['tracker_dt_spread']:.3f}) — timing harness is broken"
    )
    assert pwn["t_err_m"] < 0.01, f"aligner accuracy broke: {pwn['t_err_m']}"
    # accuracy gate: both global-optimization paths must reach the float64
    # control optimum on the hardest bundled graph (VERDICT r2 #1).
    assert pgo["chi2_final"] <= 1.01 * pgo["chi2_control"], pgo
    assert pgo["direct_chi2_final"] <= 1.01 * pgo["chi2_control"], pgo
    # SE3 gate: graphSE3 is a chain (optimum 0, control ~1e-28) — require
    # the f32 path to cut chi2 by >=100x toward that floor. Finiteness is
    # asserted explicitly: a reduced-precision matmul once produced Inf init
    # AND final, which sails through the relative gate (Inf <= Inf).
    assert np.isfinite(se3["se3_chi2_init"]), se3
    assert np.isfinite(se3["se3_chi2_final"]), se3
    assert se3["se3_chi2_final"] <= max(
        1.01 * se3["se3_chi2_control"], 0.01 * se3["se3_chi2_init"]
    ), se3

    vs = 1.0
    if "--no-cpu-control" not in sys.argv:
        cpu_dev = jax.local_devices(backend="cpu")[0]
        pwn_cpu = bench_pwn_aligner(device=cpu_dev, reps=2)
        vs = pwn["align_fps"] / pwn_cpu["align_fps"]

    out = {
        "metric": "pwn_align_fps_640x480_10outer",
        "value": round(pwn["align_fps"], 3),
        "unit": "aligner frames/s (640x480, 10 outer x 1 inner, ref envelope, XLA gather path)",
        "vs_baseline": round(vs, 3),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "align_fps_scale4": round(pwn4["align_fps"], 3),
        "convert_fps": round(pwn["convert_fps"], 3),
        "tracker_fps_e2e": round(trk["tracker_fps"], 3),
        "align_t_err_m": round(pwn["t_err_m"], 5),
        "align_inliers": pwn["inliers"],
        "pose_graph_lm_iters_per_s": round(pgo["lm_iters_per_s"], 3),
        "pose_graph_chi2_final": round(pgo["chi2_final"], 1),
        "pose_graph_direct_chi2": round(pgo["direct_chi2_final"], 1),
        "pose_graph_direct_iters_per_s": round(pgo["direct_iters_per_s"], 3),
        "pose_graph_chi2_control": round(pgo["chi2_control"], 2),
        "se3_chi2_final": se3["se3_chi2_final"],
        "se3_chi2_control": se3["se3_chi2_control"],
        "se3_chi2_init": se3["se3_chi2_init"],
        "se3_lm_iters_per_s": round(se3["se3_lm_iters_per_s"], 3),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
