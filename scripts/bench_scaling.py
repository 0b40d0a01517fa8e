"""Scaling-efficiency benchmark for the distributed solvers.

Runs the edge-sharded SE2 pose-graph LM solver on 1/2/4/8 virtual CPU
devices (one process, XLA host device partitioning) on the biggest bundled
graph and reports LM iters/s per mesh size plus scaling efficiency.

This measures the *mechanism* (shard_map + psum collectives, identical to
the multi-device path) on virtual devices; absolute multi-chip numbers
require hardware the sandbox doesn't have (BASELINE.md). Efficiency on
virtual CPU devices is a LOWER bound: all devices share the host's cores,
so any value near 1/n_devices of ideal still validates the collective
layout, while compute-bound losses show up as <1 efficiency.

Usage: python scripts/bench_scaling.py [--devices 1 2 4 8] [--iters 10]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

DATA = "/root/reference/datasets/2D"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--dataset", default="victoriaPark-full.g2o.gz")
    args = ap.parse_args()

    from g2o_frontend_tpu.graph.store import graph2d_from_log
    from g2o_frontend_tpu.io.g2o import read_g2o
    from g2o_frontend_tpu.parallel.mesh import make_mesh
    from g2o_frontend_tpu.parallel.partitioned_pose_graph import (
        optimize_se2_partitioned)
    from g2o_frontend_tpu.parallel.partitioned_schur import (
        optimize_se2_schur_partitioned)
    from g2o_frontend_tpu.parallel.sharded_pose_graph import optimize_se2_sharded

    log = read_g2o(os.path.join(DATA, args.dataset))
    g, _ = graph2d_from_log(log)

    results = {}
    for nd in args.devices:
        mesh = make_mesh(nd)
        # warm-up/compile
        g1, trace = optimize_se2_sharded(g, mesh, iters=2, cg_iters=args.cg_iters)
        np.asarray(trace)
        t0 = time.perf_counter()
        g1, trace = optimize_se2_sharded(
            g, mesh, iters=args.iters, cg_iters=args.cg_iters
        )
        chi2 = np.asarray(trace)
        dt = time.perf_counter() - t0
        # partitioned-state solver (ghost halo exchange) + comm accounting
        g2, tr2, pstats = optimize_se2_partitioned(
            g, mesh, iters=2, cg_iters=args.cg_iters)
        t1 = time.perf_counter()
        g2, tr2, pstats = optimize_se2_partitioned(
            g, mesh, iters=args.iters, cg_iters=args.cg_iters)
        dt_part = time.perf_counter() - t1
        # the ACCURATE solver (distributed Schur/SPIKE/Woodbury): the r5
        # scaling story runs on the SAME solver the accuracy gates run on
        # (VERDICT r4 Next 4) — iters capped for throughput timing; the
        # to-convergence accuracy table is bench_distributed_schur.py
        g3, tr3, _s3 = optimize_se2_schur_partitioned(
            g, mesh, iters=2, cg_iters=args.cg_iters)
        t2 = time.perf_counter()
        g3, tr3, _s3 = optimize_se2_schur_partitioned(
            g, mesh, iters=args.iters, cg_iters=args.cg_iters)
        dt_schur = time.perf_counter() - t2
        results[nd] = {
            "lm_iters_per_s": args.iters / dt,
            "chi2_final": float(chi2[-1]),
            "schur_lm_iters_per_s": args.iters / dt_schur,
            "schur_chi2_final": float(np.asarray(tr3)[-1]),
            "part_lm_iters_per_s": args.iters / dt_part,
            "part_chi2_final": float(np.asarray(tr2)[-1]),
            "part_bytes_sharded_per_device":
                pstats["partition"]["bytes_sharded_per_device"],
            "part_bytes_full_graph": pstats["partition"]["bytes_full_graph"],
            "part_comm_bytes_per_matvec": pstats["comm"]["bytes_per_matvec"],
            "part_comm_bytes_total": pstats["comm"]["bytes_total"],
            "part_cg_matvecs": pstats["cg_total"],
        }
        print(
            json.dumps(
                {"devices": nd, **{k: round(v, 4) for k, v in results[nd].items()}}
            )
        )

    base = results[args.devices[0]]["lm_iters_per_s"]
    base_s = results[args.devices[0]]["schur_lm_iters_per_s"]
    for nd in args.devices[1:]:
        eff = results[nd]["lm_iters_per_s"] / base
        eff_s = results[nd]["schur_lm_iters_per_s"] / base_s
        print(json.dumps({"devices": nd, "throughput_vs_1dev": round(eff, 4),
                          "schur_throughput_vs_1dev": round(eff_s, 4)}))
    # chi2 parity across mesh sizes (same math, different sharding)
    finals = [results[nd]["chi2_final"] for nd in args.devices]
    spread = (max(finals) - min(finals)) / max(abs(finals[0]), 1e-12)
    print(json.dumps({"chi2_relative_spread_across_meshes": spread}))

    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "eval_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "scaling.json"), "w") as fh:
        json.dump(
            {
                "dataset": args.dataset,
                "iters": args.iters,
                "cg_iters": args.cg_iters,
                "results": {str(k): v for k, v in results.items()},
                "chi2_relative_spread": spread,
            },
            fh,
        )


if __name__ == "__main__":
    main()
