"""Pairwise cloud/depth alignment CLI (pwn_apps/pwn_cloud_aligner analog).

Aligns two depth images (16-bit TUM PNGs, .npy float meters, or reference
`.pwn` cloud files — re-rendered through the projector like the reference
app), prints the transform + statistics, optionally writes visualizations.

Usage:
  python -m g2o_frontend_tpu.apps.cloud_aligner REF CUR [--scale 2]
      [--fx 525 --fy 525 --cx 319.5 --cy 239.5] [--rows 480 --cols 640]
      [--viz-prefix out]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_depth(path):
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    from ..io.tum import load_depth_png

    return load_depth_png(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("reference")
    ap.add_argument("current")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--fx", type=float, default=525.0)
    ap.add_argument("--fy", type=float, default=525.0)
    ap.add_argument("--cx", type=float, default=319.5)
    ap.add_argument("--cy", type=float, default=239.5)
    ap.add_argument("--outer-iterations", type=int, default=10)
    ap.add_argument("--rows", type=int, default=480)
    ap.add_argument("--cols", type=int, default=640)
    ap.add_argument("--viz-prefix", default=None)
    args = ap.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from ..pwn.aligner import AlignerConfig, align
    from ..pwn.converter import ConverterConfig, depth_to_cloud
    from ..pwn.projector import PinholeProjector
    from ..utils import lie

    def load_any(path):
        if path.endswith(".pwn"):
            # re-render the stored cloud as a depth image (the reference app
            # converts .pwn clouds through the projector the same way)
            from ..pwn.cloud_io import load_pwn

            d = load_pwn(path)
            import numpy as _np

            # host-side z-buffer render (IO path, not perf-critical)
            p = d["points"]
            u = _np.round(p[:, 0] / _np.maximum(p[:, 2], 1e-9) * args.fx + args.cx).astype(int)
            v = _np.round(p[:, 1] / _np.maximum(p[:, 2], 1e-9) * args.fy + args.cy).astype(int)
            z = p[:, 2]
            okm = (z > 0.1) & (u >= 0) & (u < args.cols) & (v >= 0) & (v < args.rows)
            img = _np.zeros((args.rows, args.cols), _np.float32)
            order = _np.argsort(-z[okm])  # far to near: near wins
            img[v[okm][order], u[okm][order]] = z[okm][order]
            return img
        return _load_depth(path)

    d_ref = load_any(args.reference)
    d_cur = load_any(args.current)
    s = args.scale
    if s > 1:
        d_ref = d_ref[::s, ::s]
        d_cur = d_cur[::s, ::s]
    H, W = d_ref.shape
    proj = PinholeProjector(rows=H, cols=W, fx=args.fx / s, fy=args.fy / s,
                            cx=args.cx / s, cy=args.cy / s,
                            min_distance=0.1, max_distance=10.0)
    ccfg = ConverterConfig(
        min_image_radius=max(2, 10 // s), max_image_radius=max(4, 30 // s),
        min_points=max(10, 50 // (s * s)),
    )
    ref = depth_to_cloud(jnp.asarray(d_ref), proj, ccfg)
    cur = depth_to_cloud(jnp.asarray(d_cur), proj, ccfg)
    res = align(ref, cur, proj,
                config=AlignerConfig(outer_iterations=args.outer_iterations))
    T = np.asarray(res.T, float)

    if args.viz_prefix:
        from ..utils.viz import plot_cloud_topdown, plot_depth

        plot_depth(args.viz_prefix + "_ref_depth.png", d_ref, "reference depth")
        plot_depth(args.viz_prefix + "_cur_depth.png", d_cur, "current depth")
        merged = np.concatenate(
            [
                np.asarray(ref.points).reshape(-1, 3),
                np.asarray(cur.points).reshape(-1, 3) @ T[:3, :3].T + T[:3, 3],
            ]
        )
        mvalid = np.concatenate(
            [np.asarray(ref.valid).reshape(-1), np.asarray(cur.valid).reshape(-1)]
        )
        plot_cloud_topdown(args.viz_prefix + "_merged.png", merged, mvalid,
                           title="aligned clouds (top-down)")

    print(
        json.dumps(
            {
                "transform": T.tolist(),
                "t2v": np.asarray(lie.se3_t2v(jnp.asarray(T, jnp.float32))).tolist(),
                "inliers": int(res.inliers),
                "chi2": float(res.chi2),
                "translational_ratio": float(res.translational_ratio),
                "rotational_ratio": float(res.rotational_ratio),
                "valid": bool(res.valid),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
