"""PWN keyframe tracker: RGB-D odometry over the map model.

Re-design of ``pwn_tracker/pwn_tracker.{h,cpp}`` / ``pwn_tracker2``'s
`PwnTracker: public BaseTracker`:

- every incoming depth frame is converted (jitted depth->cloud) and aligned
  against the PREVIOUS KEYFRAME's cloud with initial guess
  ``prevKF_T^-1 * globalT`` (``pwn_tracker.cpp:132-135``),
- on success ``globalT = prevKF_T * T``; on failure (zero inliers) fall back
  to the odometry guess (``pwn_tracker.cpp:146-152``),
- rotation re-orthonormalized every 50 frames (``pwn_tracker.cpp:154-159``),
- keyframe rule: inlier fraction below `new_frame_inliers_fraction` spawns a
  new keyframe node and a binary relation prevKF->KF with the aligner's
  transform/information (``pwn_tracker.cpp:164-170``),
- keyframe clouds live in an LRU `CloudCache` (the BLOB-backed
  ``pwn_tracker_cache.h`` / `PwnCloudCache`): entries hold the depth image
  (cheap) and rebuild clouds on demand, bounding device memory.

The tracker populates a `MapManager`; optimization happens through the
reflector (graph/reflector.py).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..graph.map_manager import MapManager, MapNode, MapRelation
from ..pwn.aligner import AlignerConfig, align
from ..pwn.converter import ConverterConfig, depth_to_cloud
from ..pwn.projector import PinholeProjector


class CloudCache:
    """LRU keyframe->cloud cache (reference ``cache.h:17-95`` semantics:
    bounded slots, get() recomputes evicted entries from the stored depth)."""

    def __init__(self, projector, converter_config, max_slots=50):
        self.projector = projector
        self.ccfg = converter_config
        self.max_slots = max_slots
        self._depths: dict[int, np.ndarray] = {}
        self._clouds: OrderedDict[int, object] = OrderedDict()
        self.evictions = 0  # observability: cache pressure counter
        self.recomputes = 0  # get() calls that had to rebuild a cloud

    def put(self, key: int, depth):
        self._depths[key] = np.asarray(depth)

    def get(self, key: int):
        if key in self._clouds:
            self._clouds.move_to_end(key)
            return self._clouds[key]
        self.recomputes += 1
        cloud = depth_to_cloud(
            jnp.asarray(self._depths[key], jnp.float32), self.projector, self.ccfg
        )
        self._clouds[key] = cloud
        if len(self._clouds) > self.max_slots:
            self._clouds.popitem(last=False)
            self.evictions += 1
        return cloud

    def __contains__(self, key):
        return key in self._depths


@dataclass
class PwnTrackerConfig:
    new_frame_inliers_fraction: float = 0.4  # pwn_tracker.h:58 default
    min_cloud_inliers: int = 3000  # conf PwnTracker minCloudInliers
    renormalize_every: int = 50
    cache_slots: int = 50


class PwnTracker:
    """Host driver: feed depth images, get keyframes + relations in a map."""

    def __init__(
        self,
        projector: PinholeProjector,
        converter_config: ConverterConfig = ConverterConfig(),
        aligner_config: AlignerConfig = AlignerConfig(),
        config: PwnTrackerConfig = PwnTrackerConfig(),
        manager: MapManager | None = None,
    ):
        self.projector = projector
        self.ccfg = converter_config
        self.acfg = aligner_config
        self.cfg = config
        self.manager = manager or MapManager()
        self.cache = CloudCache(projector, converter_config, config.cache_slots)

        self.global_T = np.eye(4)
        self.prev_kf_T = np.eye(4)
        self.prev_kf_node: MapNode | None = None
        self.prev_kf_key: int | None = None
        self.frame_count = 0
        self.n_keyframes = 0
        self.trajectory: list[np.ndarray] = []
        # per-frame metrics (observability, SURVEY.md §5 logging)
        self.metrics: list[dict] = []

    def process_frame(self, depth, initial_guess=None):
        """Ingest one depth image; returns dict of frame metrics."""
        cfg = self.cfg
        depth = jnp.asarray(depth, jnp.float32)
        current = depth_to_cloud(depth, self.projector, self.ccfg)
        frame_key = self.frame_count
        self.frame_count += 1

        if self.prev_kf_node is None:
            # bootstrap: first frame is the first keyframe
            self.cache.put(frame_key, depth)
            node = self.manager.add_node(self.global_T, payload={"frame": frame_key})
            self.prev_kf_node = node
            self.prev_kf_key = frame_key
            self.prev_kf_T = self.global_T.copy()
            self.n_keyframes = 1
            self.trajectory.append(self.global_T.copy())
            m = {"keyframe": True, "inliers": 0, "fraction": 1.0, "fallback": False}
            self.metrics.append(m)
            return m

        reference = self.cache.get(self.prev_kf_key)
        guess = np.linalg.inv(self.prev_kf_T) @ self.global_T
        if initial_guess is not None:
            guess = guess @ np.asarray(initial_guess)
        res = align(
            reference,
            current,
            self.projector,
            jnp.asarray(guess, jnp.float32),
            self.acfg,
        )
        inliers = int(res.inliers)
        T = np.asarray(res.T, np.float64)

        # minCloudInliers gate (conf PwnTracker minCloudInliers; the tracker
        # falls back to the odometry guess on a failed alignment,
        # pwn_tracker.cpp:146-152)
        fallback = inliers < max(1, cfg.min_cloud_inliers)
        if fallback:
            self.global_T = self.global_T @ guess  # odometry fallback
        else:
            self.global_T = self.prev_kf_T @ T

        if self.frame_count % cfg.renormalize_every == 0:
            # re-orthonormalize the rotation (pwn_tracker.cpp:154-159)
            U, _, Vt = np.linalg.svd(self.global_T[:3, :3])
            self.global_T[:3, :3] = U @ Vt
        self.trajectory.append(self.global_T.copy())

        max_inliers = self.projector.rows * self.projector.cols
        fraction = inliers / max_inliers
        new_keyframe = fraction < cfg.new_frame_inliers_fraction and not fallback
        if fallback:
            new_keyframe = True  # lost track: anchor a new keyframe

        if new_keyframe:
            self.cache.put(frame_key, depth)
            node = self.manager.add_node(self.global_T, payload={"frame": frame_key})
            info = np.asarray(res.omega, np.float64)
            if fallback or not np.isfinite(info).all():
                info = np.eye(6) * 100.0
            else:
                # keep the f32 solver in range: bound the information scale
                # (the unscented omega of a well-conditioned dense alignment
                # can reach 1e7+; only its relative anisotropy matters)
                info = 0.5 * (info + info.T)
                mx = np.abs(info).max()
                if mx > 1e4:
                    info *= 1e4 / mx
            rel = MapRelation(
                node_from=self.prev_kf_node,
                node_to=node,
                transform=np.linalg.inv(self.prev_kf_T) @ self.global_T,
                information=info,
            )
            self.manager.add_relation(rel)
            self.prev_kf_node = node
            self.prev_kf_key = frame_key
            self.prev_kf_T = self.global_T.copy()
            self.n_keyframes += 1

        m = {
            "keyframe": bool(new_keyframe),
            "inliers": inliers,
            "fraction": float(fraction),
            "fallback": bool(fallback),
            "chi2": float(res.chi2),
        }
        self.metrics.append(m)
        return m

    def trajectory_array(self):
        return np.stack(self.trajectory) if self.trajectory else np.zeros((0, 4, 4))


def odometry_scan(
    depths,
    projector: PinholeProjector,
    ccfg: ConverterConfig = ConverterConfig(),
    acfg: AlignerConfig = AlignerConfig(),
    kf_fraction: float = 0.4,
    min_cloud_inliers: int = 3000,
    depth_scale: float | None = None,
):
    """Whole-sequence odometry as ONE device program (`lax.scan`).

    The host-loop tracker pays a host<->device round trip per frame; here the
    entire keyframe loop — convert, align against the carried keyframe cloud,
    keyframe switch — runs on-chip over a stacked (K, H, W) depth batch. The
    keyframe policy (``pwn_tracker.cpp:164-170``) becomes a `jnp.where`
    tree-select on the carried reference cloud: fixed shapes, no host sync.

    ``depth_scale``: pass the TUM raw uint16 batch with its meters-per-unit
    scale and the float conversion happens ON DEVICE — halving the
    host->device bytes.

    Returns (trajectory (K, 4, 4) world poses, metrics dict of (K,) arrays:
    inliers, fraction, keyframe flags).
    """
    import jax

    if depth_scale is not None:
        depths = jnp.asarray(depths)  # uint16 on the wire
        depths = depths.astype(jnp.float32) * jnp.float32(depth_scale)
    else:
        depths = jnp.asarray(depths, jnp.float32)
    cloud0 = depth_to_cloud(depths[0], projector, ccfg)
    eye = jnp.eye(4, dtype=jnp.float32)
    max_inliers = projector.rows * projector.cols

    def step(carry, depth):
        ref, kf_T, global_T = carry
        cur = depth_to_cloud(depth, projector, ccfg)
        guess = jnp.linalg.solve(kf_T, global_T)  # prevKF_T^-1 @ globalT
        res = align(ref, cur, projector, guess, acfg)
        # minCloudInliers fallback gate, matching PwnTracker.process_frame
        ok = res.inliers >= max(1, min_cloud_inliers)
        global_T = jnp.where(ok, kf_T @ res.T, global_T @ guess)
        fraction = res.inliers / max_inliers
        new_kf = (fraction < kf_fraction) | ~ok
        ref = jax.tree_util.tree_map(
            lambda a, b: jnp.where(new_kf, b, a), ref, cur
        )
        kf_T = jnp.where(new_kf, global_T, kf_T)
        # omega trace + eigenratio gates are emitted per frame so the full
        # statistics pass (``aligner.cpp:152-199``) is live in the scan —
        # the host tracker consumes them and so must the on-chip one
        # (also keeps e2e timing honest vs the bare-align benchmark)
        omega_tr = jnp.trace(res.omega) + res.translational_ratio + (
            res.rotational_ratio
        )
        out = (global_T, res.inliers, fraction, new_kf, omega_tr)
        return (ref, kf_T, global_T), out

    (_, _, _), (traj, inliers, fraction, kf, omega_tr) = jax.lax.scan(
        step, (cloud0, eye, eye), depths[1:]
    )
    traj = jnp.concatenate([eye[None], traj], 0)
    pad = lambda x, v: jnp.concatenate([jnp.asarray([v], x.dtype), x])
    return traj, {
        "inliers": pad(inliers, 0),
        "fraction": pad(fraction, 1.0),
        "keyframe": pad(kf, True),
        "omega_trace": pad(omega_tr, 0.0),
    }
