"""Full PWN SLAM pipeline CLI (pwn_slam_app equivalent, BASELINE config 5).

Composes the whole stack per frame — depth -> cloud -> keyframe tracking ->
partitioned loop-closure search with consensus -> periodic reflected
optimization (the ``pwn_tracker2/pwn_slam_app.cpp:31`` flow) — and writes
the map checkpoint + TUM trajectory.

Usage:
  python -m g2o_frontend_tpu.apps.pwn_slam SEQ_DIR [--conf FILE] [...]
  python -m g2o_frontend_tpu.apps.pwn_slam --synthetic --frames 48
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("seq_dir", nargs="?")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--conf", help="reference-format boss pipeline conf")
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--sensor", default="kinect")
    ap.add_argument("--out-map", default="pwn_slam_map.npz")
    ap.add_argument("--out-traj", default="pwn_slam_traj.txt")
    ap.add_argument("--kf-fraction", type=float, default=None)
    ap.add_argument("--optimize-each-n-keyframes", type=int, default=5)
    ap.add_argument("--max-frames", type=int, default=0)
    args = ap.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from ..graph.reflector import MapReflector
    from ..io import tum
    from ..io.checkpoint import save_map
    from ..pwn.aligner import AlignerConfig
    from ..pwn.converter import ConverterConfig
    from ..pwn.projector import PinholeProjector
    from ..slam.map_closer import CloserConfig, MapCloser
    from ..slam.pwn_tracker import PwnTracker, PwnTrackerConfig
    from ..utils import lie

    closer_cfg = CloserConfig()
    if args.conf:
        from ..pwn.pipeline import load_pipeline

        pipe = load_pipeline(args.conf)
        proj = pipe.scaled_projector()
        ccfg = pipe.converter_config
        acfg = pipe.aligner_config
        if pipe.closer_config is not None:
            closer_cfg = pipe.closer_config
        if pipe.tracker_config is not None and args.kf_fraction is None:
            args.kf_fraction = pipe.tracker_config.new_frame_inliers_fraction
    elif args.synthetic:
        from ..utils.synth import default_projector

        proj = default_projector(H=96, W=128)
        ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
        acfg = AlignerConfig(outer_iterations=6)
        closer_cfg = CloserConfig(
            translational_distance=0.45,
            frame_min_nonzero_threshold=2000,
            frame_max_outliers_threshold=6000,
            frame_min_inliers_threshold=2000,
            consensus_min_times_checked=1,
        )
    else:
        fx, fy, cx, cy = tum.kinect_presets[args.sensor]
        s = args.scale
        proj = PinholeProjector(rows=480 // s, cols=640 // s, fx=fx / s,
                                fy=fy / s, cx=cx / s, cy=cy / s,
                                min_distance=0.3, max_distance=6.0)
        ccfg = ConverterConfig(min_image_radius=max(2, 10 // s),
                               max_image_radius=max(4, 30 // s),
                               min_points=max(10, 50 // (s * s)))
        acfg = AlignerConfig(outer_iterations=10)

    # synthetic orbits keep high overlap; the reference's 0.4 keyframe gate
    # would never fire there
    kf_fraction = args.kf_fraction
    if kf_fraction is None:
        kf_fraction = 0.7 if args.synthetic else 0.4
    # minCloudInliers is a 640x480 scale-1 value (conf PwnTracker line);
    # scale it with the image area
    min_inl = max(50, int(3000 * (proj.rows * proj.cols) / (480 * 640)))
    tracker = PwnTracker(
        proj, ccfg, acfg,
        PwnTrackerConfig(new_frame_inliers_fraction=kf_fraction,
                         min_cloud_inliers=min_inl),
    )
    closer = MapCloser(tracker.manager, tracker.cache, proj, acfg, closer_cfg)
    reflector = MapReflector(tracker.manager)
    # level-1 big-node layer (MapMerger stream grouping, map_merger.cpp:43):
    # feeds the coarse pass of optimize_hierarchical below
    from ..slam.map_merger import MapMerger

    merger = MapMerger(tracker.manager, list_size=5)

    # frame source
    frames = []
    if args.synthetic:
        from ..utils.synth import render_planes_depth

        for k in range(args.frames):
            a = 2 * np.pi * k / args.frames
            T = np.eye(4)
            T[:3, 3] = [0.6 * np.cos(a), 0.0, 0.3 * np.sin(a)]
            yaw = 0.35 * np.sin(a)
            c, s = np.cos(yaw), np.sin(yaw)
            T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            frames.append((k / 30.0, render_planes_depth(T, proj)))
    else:
        index = tum.read_depth_index(args.seq_dir)
        if args.max_frames:
            index = index[: args.max_frames]
        for ts, rel in index:
            depth = tum.load_depth_png(os.path.join(args.seq_dir, rel))
            if args.scale > 1:
                depth = depth[:: args.scale, :: args.scale]
            frames.append((ts, jnp.asarray(depth, jnp.float32)))

    timestamps = []
    n_closures = 0
    kf_at_last_opt = 0
    for ts, depth in frames:
        m = tracker.process_frame(depth)
        timestamps.append(ts)
        if m["keyframe"] and tracker.n_keyframes > 2:
            key_node = tracker.manager.nodes[-1]
            rels = closer.process_key_node(key_node)
            merger.process_key_node(key_node)
            n_closures += len(rels)
            if (
                rels
                or tracker.n_keyframes - kf_at_last_opt
                >= args.optimize_each_n_keyframes
            ):
                # coarse level-1 solve + rigid warp + warm fine solve —
                # after a closure the coarse pass removes the long-
                # wavelength error at ~list_size^2 x cheaper matvecs
                reflector.optimize_hierarchical(iters=5, cg_iters=40)
                kf_at_last_opt = tracker.n_keyframes
                # keep the tracker's frame anchored to the optimized map
                tracker.global_T = tracker.prev_kf_node.transform.copy()
                tracker.prev_kf_T = tracker.global_T.copy()

    chi2, _ = reflector.optimize_hierarchical(iters=10, cg_iters=60)
    save_map(args.out_map, tracker.manager)

    poses7 = []
    for T in tracker.trajectory_array():
        q = np.asarray(lie.mat2quat_full(jnp.asarray(T[:3, :3], jnp.float32)))
        poses7.append(np.concatenate([T[:3, 3], q[1:], q[:1]]))
    tum.write_trajectory(args.out_traj, timestamps, poses7)

    print(
        json.dumps(
            {
                "frames": len(frames),
                "keyframes": tracker.n_keyframes,
                "closures": n_closures,
                "final_chi2": chi2,
                "map": args.out_map,
                "trajectory": args.out_traj,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
