"""Headless visualization: trajectories / maps / clouds to PNG.

Takes the role of the reference's Qt/OpenGL viewers (``pwn_viewer/``,
``mapper/graph_viewer/``, GUI apps) in a batch world: matplotlib (Agg)
renderings written to files for inspection and reports.
"""
from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory_2d(path, trajectories: dict, landmarks=None, lines=None,
                       title=""):
    """trajectories: name -> (N, >=2) arrays; landmarks: (L, 2);
    lines: iterable of (p0, p1) segments."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    for name, tr in trajectories.items():
        tr = np.asarray(tr)
        ax.plot(tr[:, 0], tr[:, 1], label=name, linewidth=1.2)
    if landmarks is not None and len(landmarks):
        lm = np.asarray(landmarks)
        ax.scatter(lm[:, 0], lm[:, 1], s=6, c="k", marker="x", label="landmarks")
    if lines:
        for p0, p1 in lines:
            ax.plot([p0[0], p1[0]], [p0[1], p1[1]], "g-", linewidth=0.8)
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_grid_map(path, grid, spec=None, trajectory=None, title=""):
    """(H, W) likelihood/occupancy grid + optional trajectory overlay."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    extent = None
    if spec is not None:
        extent = [
            spec.origin_x,
            spec.origin_x + spec.cols * spec.resolution,
            spec.origin_y,
            spec.origin_y + spec.rows * spec.resolution,
        ]
    ax.imshow(np.asarray(grid), origin="lower", cmap="gray_r", extent=extent)
    if trajectory is not None and len(trajectory):
        tr = np.asarray(trajectory)
        ax.plot(tr[:, 0], tr[:, 1], "r-", linewidth=1.0)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_cloud_topdown(path, points, valid=None, color_axis=1, title="",
                       max_points=100000):
    """Top-down (x, z) scatter of a 3D cloud colored by height."""
    plt = _plt()
    pts = np.asarray(points).reshape(-1, 3)
    if valid is not None:
        pts = pts[np.asarray(valid).reshape(-1)]
    if len(pts) > max_points:
        pts = pts[:: len(pts) // max_points + 1]
    fig, ax = plt.subplots(figsize=(8, 8))
    sc = ax.scatter(pts[:, 0], pts[:, 2], c=pts[:, color_axis], s=1, cmap="viridis")
    fig.colorbar(sc, ax=ax, shrink=0.7)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_depth(path, depth, title=""):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(np.asarray(depth), cmap="turbo")
    fig.colorbar(im, ax=ax, shrink=0.7)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
