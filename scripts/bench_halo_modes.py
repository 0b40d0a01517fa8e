"""Measure ppermute-per-shift vs fused all_to_all halo exchange (VERDICT r3
Next 8): the auto heuristic picked ppermute everywhere on a 25% wire-padding
rule of thumb, while the collective count grows with D (6 -> 18 per matvec
from 2 -> 8 devices). This measures wall per CG matvec for both wire modes
on victoriaPark partitions at D=2/4/8 (virtual CPU mesh: informative for
launch overhead, recorded as such) and updates eval_out/halo_modes.json.

Run on a quiet host: python scripts/bench_halo_modes.py
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

DATA = "/root/reference/datasets/2D"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "eval_out")


def main():
    from g2o_frontend_tpu.graph.store import graph2d_from_log
    from g2o_frontend_tpu.io.g2o import read_g2o
    from g2o_frontend_tpu.parallel.mesh import make_mesh
    from g2o_frontend_tpu.parallel.partitioned_pose_graph import (
        comm_volume, optimize_se2_partitioned, partition_se2)

    g, _ = graph2d_from_log(
        read_g2o(os.path.join(DATA, "victoriaPark-full.g2o.gz"))
    )
    rows = []
    ITERS, CG = 3, 60
    for nd in (2, 4, 8):
        mesh = make_mesh(nd)
        for mode in ("ppermute", "a2a"):
            part = partition_se2(g, nd, halo_mode=mode)
            cv = comm_volume(part, 1, 1)
            # warm (compile), then timed
            optimize_se2_partitioned(g, mesh, iters=ITERS, cg_iters=CG,
                                     halo_mode=mode)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                _, _, stats = optimize_se2_partitioned(
                    g, mesh, iters=ITERS, cg_iters=CG, halo_mode=mode
                )
                ts.append(time.perf_counter() - t0)
            mv = max(stats["cg_total"], 1)
            rows.append({
                "devices": nd,
                "mode": mode,
                "collectives_per_matvec": cv["collectives_per_matvec"],
                "bytes_per_matvec": cv["bytes_per_matvec"],
                "wall_per_matvec_ms": round(min(ts) / mv * 1e3, 3),
                "cg_matvecs": mv,
            })
            print(json.dumps(rows[-1]), flush=True)
    with open(os.path.join(OUT, "halo_modes.json"), "w") as fh:
        json.dump({"note": "virtual CPU mesh: wall reflects collective "
                           "launch overhead, not interconnect wire time",
                   "rows": rows}, fh)


if __name__ == "__main__":
    main()
