"""PWN RGB-D odometry CLI (pwn_odometry equivalent, BASELINE config 3).

Runs the keyframe tracker over a TUM-style sequence (depth.txt + 16-bit
PNGs) or a synthetic sequence, writes the TUM trajectory, and evaluates ATE
against groundtruth.txt when present (reference protocol:
``pwn_odometry/pwn_odometry.cpp:20-46``).

Usage:
  python -m g2o_frontend_tpu.apps.pwn_odometry SEQ_DIR [--out traj.txt]
      [--scale 2] [--sensor kinectFreiburg1] [--max-frames N] [--conf FILE]
  python -m g2o_frontend_tpu.apps.pwn_odometry --synthetic [--frames 30]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("seq_dir", nargs="?", help="TUM sequence directory")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--sensor", default="kinect")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--conf", help="boss pipeline .conf (reference format)")
    ap.add_argument("--kf-fraction", type=float, default=None)
    ap.add_argument(
        "--scan",
        action="store_true",
        help="whole-sequence on-device mode: stack all depths and run the "
        "keyframe loop as one lax.scan program (no per-frame host round "
        "trips); trajectory only, no map graph",
    )
    ap.add_argument(
        "--benchmark-out",
        help="per-frame benchmark file in the reference format: "
        "'inliers error error/inliers time dist angle score x y z qx qy qz qw' "
        "(pwn_benchmark.cpp:417-421, pwn_odometry.cpp:43-46)",
    )
    args = ap.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import time as _time

    import jax.numpy as jnp

    from ..io import tum
    from ..pwn.aligner import AlignerConfig
    from ..pwn.converter import ConverterConfig
    from ..pwn.projector import PinholeProjector
    from ..slam.pwn_tracker import PwnTracker, PwnTrackerConfig
    from ..utils import evaluation, lie

    if args.conf:
        from ..pwn.pipeline import load_pipeline

        pipe = load_pipeline(args.conf)
        proj = pipe.scaled_projector()
        ccfg = pipe.converter_config
        acfg = pipe.aligner_config
        if pipe.tracker_config is not None and args.kf_fraction is None:
            args.kf_fraction = pipe.tracker_config.new_frame_inliers_fraction
    elif args.synthetic:
        from ..utils.synth import default_projector

        proj = default_projector(H=120, W=160)
        ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
        acfg = AlignerConfig(outer_iterations=6)
    else:
        fx, fy, cx, cy = tum.kinect_presets[args.sensor]
        s = args.scale
        proj = PinholeProjector(
            rows=480 // s, cols=640 // s, fx=fx / s, fy=fy / s,
            cx=cx / s, cy=cy / s, min_distance=0.3, max_distance=6.0,
        )
        ccfg = ConverterConfig(
            min_image_radius=max(2, 10 // s),
            max_image_radius=max(4, 30 // s),
            min_points=max(10, 50 // (s * s)),
        )
        acfg = AlignerConfig(outer_iterations=10)

    if args.kf_fraction is None:
        args.kf_fraction = 0.4
    tracker = PwnTracker(
        proj, ccfg, acfg,
        PwnTrackerConfig(
            new_frame_inliers_fraction=args.kf_fraction,
            min_cloud_inliers=max(
                50, int(3000 * (proj.rows * proj.cols) / (480 * 640))
            ),
        ),
    )

    timestamps = []
    frame_times = []
    scan_depths = [] if args.scan else None

    def step(depth, ts):
        if scan_depths is not None:
            scan_depths.append(np.asarray(depth, np.float32))
            timestamps.append(ts)
            return
        t0 = _time.perf_counter()
        tracker.process_frame(depth)
        frame_times.append(_time.perf_counter() - t0)
        timestamps.append(ts)

    if args.synthetic:
        from ..utils.synth import render_planes_depth

        for k in range(args.frames):
            a = 2 * np.pi * k / args.frames
            T = np.eye(4)
            T[:3, 3] = [0.4 * np.cos(a), 0.0, 0.25 * np.sin(a)]
            step(render_planes_depth(T, proj), k / 30.0)
    else:
        index = tum.read_depth_index(args.seq_dir)
        if args.max_frames:
            index = index[: args.max_frames]
        for ts, rel in index:
            if args.scan:
                # scan mode ships RAW uint16 (half the H2D bytes; the
                # float conversion runs on device)
                depth = tum.load_depth_png_raw(
                    os.path.join(args.seq_dir, rel))
                if args.scale > 1:
                    depth = depth[:: args.scale, :: args.scale]
                scan_depths.append(depth)
                timestamps.append(ts)
                continue
            depth = tum.load_depth_png(os.path.join(args.seq_dir, rel))
            if args.scale > 1:
                depth = depth[:: args.scale, :: args.scale]
            step(jnp.asarray(depth, jnp.float32), ts)

    if scan_depths is not None:
        from ..slam.pwn_tracker import odometry_scan

        t0 = _time.perf_counter()
        batch = np.stack(scan_depths)
        traj_dev, scan_metrics = odometry_scan(
            batch, proj, ccfg, acfg,
            kf_fraction=args.kf_fraction,
            depth_scale=(1.0 / 5000.0 if batch.dtype == np.uint16
                         else None),
        )
        traj = np.asarray(traj_dev, np.float64)
        wall = _time.perf_counter() - t0
        frame_times = [wall / max(len(traj), 1)] * len(traj)
        tracker.trajectory = list(traj)
        tracker.n_keyframes = int(np.asarray(scan_metrics["keyframe"]).sum())
        tracker.metrics = [
            {
                "keyframe": bool(k),
                "inliers": int(i),
                "fraction": float(f),
                "chi2": 0.0,
            }
            for k, i, f in zip(
                np.asarray(scan_metrics["keyframe"]),
                np.asarray(scan_metrics["inliers"]),
                np.asarray(scan_metrics["fraction"]),
            )
        ]

    # trajectory out (TUM format)
    traj = tracker.trajectory_array()
    poses7 = []
    for T in traj:
        q = np.asarray(lie.mat2quat_full(jnp.asarray(T[:3, :3], jnp.float32)))
        poses7.append(np.concatenate([T[:3, 3], q[1:], q[:1]]))
    tum.write_trajectory(args.out, timestamps, poses7)

    if args.benchmark_out:
        # per-frame: inliers error error/inliers time dist angle score pose7
        with open(args.benchmark_out, "w") as fh:
            for k, m in enumerate(tracker.metrics):
                inl = m.get("inliers", 0)
                err = m.get("chi2", 0.0)
                epi = err / inl if inl else 0.0
                if k > 0:
                    d = np.linalg.inv(traj[k - 1]) @ traj[k]
                    dist = float(np.linalg.norm(d[:3, 3]))
                    ca = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
                    angle = float(np.arccos(ca))
                else:
                    dist = angle = 0.0
                p = poses7[k]
                fh.write(
                    f"{inl} {err:.6f} {epi:.6f} {frame_times[k]:.6f} "
                    f"{dist:.6f} {angle:.6f} {m.get('fraction', 0.0):.6f} "
                    + " ".join(f"{v:.6f}" for v in p)
                    + "\n"
                )

    result = {
        "frames": len(traj),
        "keyframes": tracker.n_keyframes,
        "trajectory": args.out,
        "mean_frame_time_s": float(np.mean(frame_times)) if frame_times else 0.0,
    }
    gt_file = args.seq_dir and os.path.join(args.seq_dir, "groundtruth.txt")
    if gt_file and os.path.isfile(gt_file):
        ts_gt, gt7 = tum.read_trajectory(gt_file)
        result["ate"] = evaluation.ate(np.asarray(timestamps), np.asarray(poses7), ts_gt, gt7)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
