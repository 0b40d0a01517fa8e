"""Device time of one PWN aligner outer iteration, from a profiler trace.

Traces `align` on the gather path on the aligner benchmark's problem
(`utils/synth.corner_align_problem`: 640x480, 10 outer x 1 inner) twice:
as configured and with no outer iteration (the statistics pass alone).
Each trace is reduced to the device's busy time per call (the union of the
kernel intervals on the device's stream lines), and the difference over
the outer iterations is the time of one. The least bytes an outer
iteration must move, over that time, give its share of the card's peak
memory bandwidth. It also prints the device ops that took the most time.

Usage (on a GPU):
  python scripts/trace_aligner.py [--out traces/aligner]
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import shutil
import sys
from collections import defaultdict

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Peak device-memory bandwidth (bytes/s) by `device_kind`: NVIDIA's H100 SXM
# data sheet. A card that is not in the table is an error.
PEAK_HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
# `align` calls traced per configuration
CALLS = 5


def min_bytes_per_outer(H, W):
    """Bytes one gather-path outer iteration must move at the least: the
    current cloud's p, n, curv, op, on (19 float32 planes) and valid (1
    byte) read once, and the 8 float32 reference channels gathered per
    pixel. Reductions write 29 floats: negligible."""
    return H * W * (27 * 4 + 1)


def device_busy_ns(xplane_path):
    """(busy ns, {op name: total ns}) over the device planes of a trace."""
    from jax.profiler import ProfileData

    busy, per_op = 0, defaultdict(float)
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:"):
            continue
        spans = []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_op[ev.name] += ev.duration_ns
        spans.sort()
        end = None
        for a, b in spans:  # union of intervals
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
    return busy, per_op


def trace_calls(fn, calls, out_dir):
    jax.block_until_ready(fn())  # compile outside the trace
    shutil.rmtree(out_dir, ignore_errors=True)
    with jax.profiler.trace(out_dir):
        for _ in range(calls):
            jax.block_until_ready(fn())
    (path,) = glob.glob(os.path.join(out_dir, "plugins", "profile", "*",
                                     "*.xplane.pb"))
    return device_busy_ns(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="traces/aligner",
                    help="directory for the profiler traces")
    args = ap.parse_args(argv)

    from g2o_frontend_tpu.pwn.aligner import align
    from g2o_frontend_tpu.pwn.converter import depth_to_cloud
    from g2o_frontend_tpu.utils.compile_cache import enable_compile_cache
    from g2o_frontend_tpu.utils.synth import corner_align_problem

    enable_compile_cache()
    dev = jax.devices()[0]
    prob = corner_align_problem()
    ref = depth_to_cloud(prob.depth_ref, prob.projector, prob.converter)
    cur = depth_to_cloud(prob.depth_cur, prob.projector, prob.converter)
    outer = prob.aligner.outer_iterations

    per_call = {}
    for n in (outer, 0):
        cfg = dataclasses.replace(prob.aligner, outer_iterations=n)
        busy, per_op = trace_calls(
            lambda: align(ref, cur, prob.projector, config=cfg), CALLS,
            os.path.join(args.out, f"outer{n}"))
        per_call[n] = busy / CALLS
        print(f"outer={n}: device busy {per_call[n] / 1e3:.2f} us "
              f"per align ({CALLS} calls traced)")
        top = sorted(per_op.items(), key=lambda kv: -kv[1])[:12]
        for name, ns in top:
            print(f"    {ns / CALLS / 1e3:10.2f} us/call  {name[:100]}")

    it_s = (per_call[outer] - per_call[0]) / outer / 1e9
    H, W = prob.projector.rows, prob.projector.cols
    nbytes = min_bytes_per_outer(H, W)
    peak = PEAK_HBM_BYTES_PER_S[dev.device_kind]
    print(f"{dev.device_kind}: one outer iteration {it_s * 1e6:.2f} us at "
          f"{H}x{W}; least bytes {nbytes / 1e6:.2f} MB -> "
          f"{nbytes / it_s / 1e9:.1f} GB/s, {nbytes / peak / it_s:.3f} of "
          f"{peak / 1e12:.2f} TB/s")


if __name__ == "__main__":
    main()
