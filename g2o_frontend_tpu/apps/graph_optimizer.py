"""Pose-graph optimizer CLI: load .g2o, optimize, write back.

The standalone backend entry (replacing a `g2o` binary invocation for the
reference's datasets). Handles SE2 (+XY landmarks) and SE3 graphs.

Usage:
  python -m g2o_frontend_tpu.apps.graph_optimizer IN.g2o[.gz] [-o OUT.g2o]
      [--iters 15] [--cg-iters 100] [--huber D] [--devices N]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default="optimized.g2o")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--huber", type=float, default=None)
    ap.add_argument("--devices", type=int, default=0,
                    help="shard edges over N devices (0 = single)")
    args = ap.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ..graph.store import graph2d_from_log, graph3d_from_log
    from ..io.g2o import read_g2o, write_g2o
    from ..solvers import pose_graph as pg

    log = read_g2o(args.input)
    is3d = len(log.se3_ids) > 0
    if is3d:
        g, maps = graph3d_from_log(log)
        chi2_0 = float(pg.chi2_se3(g))
        g_opt, stats = pg.optimize_se3(
            g, iters=args.iters, cg_iters=args.cg_iters, huber_delta=args.huber
        )
        n = len(log.se3_ids)
        log.se3_poses = np.asarray(g_opt.poses, np.float64)[:n]
    else:
        g, maps = graph2d_from_log(log)
        chi2_0 = float(pg.chi2_se2(g))
        if args.devices > 1:
            from ..parallel.mesh import make_mesh
            from ..parallel.sharded_pose_graph import optimize_se2_sharded

            mesh = make_mesh(args.devices)
            g_opt, trace = optimize_se2_sharded(
                g, mesh, iters=args.iters, cg_iters=args.cg_iters
            )
            chi2_end = float(np.asarray(trace)[-1])
        else:
            g_opt, stats = pg.optimize_se2(
                g, iters=args.iters, cg_iters=args.cg_iters, huber_delta=args.huber
            )
            chi2_end = float(np.asarray(stats.chi2)[-1])
        n, nl = len(log.se2_ids), len(log.xy_ids)
        log.se2_poses = np.asarray(g_opt.poses, np.float64)[:n]
        if nl:
            log.xy_points = np.asarray(g_opt.landmarks, np.float64)[:nl]
    if is3d:
        chi2_end = float(np.asarray(stats.chi2)[-1])
    write_g2o(args.output, log)
    print(
        json.dumps(
            {
                "dim": 3 if is3d else 2,
                "chi2_initial": chi2_0,
                "chi2_final": chi2_end,
                "output": args.output,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
