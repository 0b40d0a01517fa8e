"""Generate a TUM-format RGB-D sequence from the synthetic stress world.

The environment ships no recorded TUM sequence (BASELINE.md), so the
odometry app has only ever seen its built-in synthetic orbit. This script
renders a *kinect-intrinsics, full 640x480* depth sequence over the
stress-run's wandering-loop trajectory (revisits, yaw sweeps, vertical bob
— the hardest synthetic motion profile in the repo) and writes a complete
TUM directory:

  depth/<ts>.png     16-bit grayscale PNGs, 1/5000 m (TUM convention)
  depth.txt          timestamp -> path index
  groundtruth.txt    timestamp x y z qx qy qz qw

so ``apps/pwn_odometry.py SEQ_DIR --benchmark-out ...`` exercises the FULL
reference protocol end-to-end: PNG decode -> scaled projector -> keyframe
tracker -> TUM trajectory + per-frame benchmark emission
(``pwn_odometry.cpp:20-46``, ``pwn/pwn_benchmark.cpp:417-421``) -> ATE vs
ground truth.

Usage: python scripts/make_tum_sequence.py [OUT_DIR] [--frames 150]
(or call `make_sequence` from Python).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def wander_pose(k, n_frames):
    """The eval_pwn_slam_long wandering loop (3 laps)."""
    a = 2 * np.pi * (3.0 * k / n_frames)
    T = np.eye(4)
    T[:3, 3] = [0.55 * np.cos(a) + 0.05 * np.sin(5 * a),
                0.06 * np.sin(2 * a),
                0.3 * np.sin(a)]
    yaw = 0.3 * np.sin(a) + 0.08 * np.cos(3 * a)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return T


def make_sequence(out_dir, frames=150, fps=30.0):
    """Render `frames` kinect-intrinsics 640x480 depth frames of the
    wandering loop into a TUM directory at `out_dir`; returns `out_dir`."""
    import jax.numpy as jnp

    from g2o_frontend_tpu.io.image_codec import encode_image
    from g2o_frontend_tpu.io.tum import kinect_presets
    from g2o_frontend_tpu.pwn.projector import PinholeProjector
    from g2o_frontend_tpu.utils import lie
    from g2o_frontend_tpu.utils.synth import render_planes_depth

    fx, fy, cx, cy = kinect_presets["kinect"]
    proj = PinholeProjector(rows=480, cols=640, fx=fx, fy=fy, cx=cx, cy=cy,
                            min_distance=0.3, max_distance=6.0)

    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    depth_lines = ["# timestamp filename"]
    gt_lines = ["# timestamp tx ty tz qx qy qz qw"]
    for k in range(frames):
        ts = k / fps
        T = wander_pose(k, frames)
        depth = np.asarray(render_planes_depth(T, proj))
        d16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
        rel = f"depth/{ts:.6f}.png"
        with open(os.path.join(out_dir, rel), "wb") as fh:
            fh.write(encode_image(d16, "png"))
        depth_lines.append(f"{ts:.6f} {rel}")
        q = np.asarray(lie.mat2quat_full(jnp.asarray(T[:3, :3], jnp.float32)))
        gt_lines.append(
            f"{ts:.6f} " + " ".join(
                f"{v:.6f}"
                for v in [T[0, 3], T[1, 3], T[2, 3], q[1], q[2], q[3], q[0]]
            )
        )
    with open(os.path.join(out_dir, "depth.txt"), "w") as fh:
        fh.write("\n".join(depth_lines) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as fh:
        fh.write("\n".join(gt_lines) + "\n")
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default="eval_out/tum_seq")
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--fps", type=float, default=30.0)
    args = ap.parse_args(argv)
    make_sequence(args.out_dir, args.frames, args.fps)
    print(f"wrote {args.frames} frames to {args.out_dir}")


if __name__ == "__main__":
    import jax

    # rendering is host work: keep this process off the accelerator
    jax.config.update("jax_platforms", "cpu")
    main()
