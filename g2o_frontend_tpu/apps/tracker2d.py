"""2D unknown-data-association SLAM CLI (tracker_test equivalent).

Runs the feature tracker over a .g2o dataset carrying DATA_FEATURE_POINTXY
observations (the bundled *noassoc* worlds), mirrors the reference driver
``slam/tracker_test.cpp:155`` and its flags (``:185-214``,
``datasets/2D/params.txt`` recipes), writes the optimized graph.

Usage:
  python -m g2o_frontend_tpu.apps.tracker2d INPUT.g2o[.gz] [-o out.g2o]
      [-minLandmarkCreationFrames 0] [-localMapSize 10]
      [-incrementalRansacInlierThreshold 0.5] [-loopRansacInlierThreshold 0.2]
      [-loopLandmarkMergeDistance 0.5] [-optimizeEachN 10] [-maxFrames N]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, prefix_chars="-")
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default="tracker2d_out.g2o")
    ap.add_argument("-minLandmarkCreationFrames", type=int, default=2)
    ap.add_argument("-localMapSize", type=int, default=10)
    ap.add_argument("-incrementalRansacInlierThreshold", type=float, default=0.5)
    ap.add_argument("-incrementalGuessMaxFeatureDistance", type=float, default=1.0)
    ap.add_argument("-loopRansacInlierThreshold", type=float, default=0.2)
    ap.add_argument("-loopGuessMaxFeatureDistance", type=float, default=2.0)
    ap.add_argument("-loopLandmarkMergeDistance", type=float, default=0.5)
    ap.add_argument("-optimizeEachN", type=int, default=10)
    ap.add_argument("-closeEachN", type=int, default=20)
    ap.add_argument("-maxFrames", type=int, default=0)
    ap.add_argument("-odometryIsGood", action="store_true")
    args = ap.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()



    from ..io.g2o import G2OLog, read_g2o, write_g2o
    from ..slam.feature_tracker import FeatureTracker2D, Tracker2DConfig


    log = read_g2o(args.input)
    feats: dict[int, list] = {}
    infos: dict[int, list] = {}
    for row in log.features:
        feats.setdefault(int(row[0]), []).append(row[1:3])
        infos.setdefault(int(row[0]), []).append(
            [[row[3], row[4]], [row[4], row[5]]]
        )
    cfg = Tracker2DConfig(
        min_landmark_creation_frames=args.minLandmarkCreationFrames,
        incremental_ransac_inlier_threshold=args.incrementalRansacInlierThreshold,
        incremental_guess_max_feature_distance=args.incrementalGuessMaxFeatureDistance,
        loop_ransac_inlier_threshold=args.loopRansacInlierThreshold,
        loop_guess_max_feature_distance=args.loopGuessMaxFeatureDistance,
        loop_landmark_merge_distance=args.loopLandmarkMergeDistance,
        local_map_size=args.localMapSize,
        optimize_each_n=args.optimizeEachN,
        odometry_is_good=args.odometryIsGood,
    )
    tr = FeatureTracker2D(cfg)

    def rel_np(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        dth = (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi
        return np.array(
            [c * d[0] + s * d[1], -s * d[0] + c * d[1], dth], np.float32
        )

    n_frames = len(log.se2_ids)
    if args.maxFrames:
        n_frames = min(n_frames, args.maxFrames)
    prev = None
    for k in range(n_frames):
        vid = int(log.se2_ids[k])
        pose = log.se2_poses[k]
        delta = (
            np.zeros(3, np.float32)
            if prev is None
            else rel_np(np.asarray(prev), np.asarray(pose))
        )
        prev = pose
        obs = np.asarray(feats.get(vid, np.zeros((0, 2))), np.float32)
        inf = (
            np.asarray(infos.get(vid), np.float32)
            if vid in infos
            else None
        )
        tr.process_frame(delta, obs, inf)
        if args.closeEachN and (k + 1) % args.closeEachN == 0:
            tr.close_loops()
    tr.merge_nearby_landmarks()
    chi2 = tr.optimize(local=False)

    st = tr.stats()
    # write the optimized graph in g2o format
    est = tr.trajectory()
    lm_ids = np.where(tr.lm_alive)[0]
    out = G2OLog(
        se2_ids=np.arange(len(est)),
        se2_poses=est.astype(np.float64),
        xy_ids=np.asarray([100000 + i for i in lm_ids]),
        xy_points=tr.landmarks[lm_ids].astype(np.float64),
        edge_se2_ij=np.asarray([[i, j] for (i, j, _, _) in tr.odom_edges]).reshape(-1, 2),
        edge_se2_meas=np.asarray([z for (_, _, z, _) in tr.odom_edges]).reshape(-1, 3),
        edge_se2_info=np.asarray([w for (_, _, _, w) in tr.odom_edges]).reshape(-1, 3, 3),
        edge_se2xy_ij=np.asarray(
            [[i, 100000 + l] for (i, l, _, _) in tr.obs_edges]
        ).reshape(-1, 2),
        edge_se2xy_meas=np.asarray([z for (_, _, z, _) in tr.obs_edges]).reshape(-1, 2),
        edge_se2xy_info=np.asarray([w for (_, _, _, w) in tr.obs_edges]).reshape(-1, 2, 2),
        fixed_ids=np.array([0]),
    )
    write_g2o(args.output, out)
    print(json.dumps({"chi2": chi2, "output": args.output, **st}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
