"""Flat-array pose-graph store — the device-side `MapManager`/graph model.

The reference keeps the map as a pointer graph (`MapManager` + `MapNode` +
`MapNodeBinaryRelation`, ``boss_map/map_manager.h:9-56``, ``map_core.h``) and
mirrors it into g2o vertices/edges for optimization
(``boss_map_building/map_g2o_reflector.h:15-48``). Here the graph *is* the
array form from the start: struct-of-arrays with static capacity and validity
masks, so the whole optimizer runs under `jit` with fixed shapes while the
graph grows (capacity doubling = the only recompile point).

`PoseGraph2D` holds SE2 poses + XY landmarks + three edge families
(odometry/loop SE2-SE2 edges, pose-landmark SE2-XY edges). `PoseGraph3D`
holds SE3 poses (x y z qx qy qz qw) + SE3-SE3 edges. Both are registered as
pytrees so they can flow through jitted functions.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np

from ..io.g2o import G2OLog


def _cap(n: int, minimum: int = 8) -> int:
    """Next power-of-two capacity >= n."""
    c = minimum
    while c < n:
        c *= 2
    return c


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class PoseGraph2D:
    """SE2 pose graph with XY landmarks, fixed-capacity masked arrays.

    Pose ``i`` is the chart vector [x, y, theta]; landmark ``l`` is [x, y].
    Edge measurements follow g2o conventions: for a pose-pose edge,
    ``z = x_i^{-1} x_j``; for a pose-landmark edge, ``z = R_i^T (l - t_i)``.
    """

    poses: jnp.ndarray  # (NP, 3) f32/f64
    pose_mask: jnp.ndarray  # (NP,) bool
    landmarks: jnp.ndarray  # (NL, 2)
    landmark_mask: jnp.ndarray  # (NL,) bool
    # pose-pose edges
    pp_ij: jnp.ndarray  # (EP, 2) int32 (indices into poses)
    pp_meas: jnp.ndarray  # (EP, 3)
    pp_info: jnp.ndarray  # (EP, 3, 3)
    pp_mask: jnp.ndarray  # (EP,) bool
    # pose-landmark edges
    pl_ij: jnp.ndarray  # (EL, 2) int32 (pose idx, landmark idx)
    pl_meas: jnp.ndarray  # (EL, 2)
    pl_info: jnp.ndarray  # (EL, 2, 2)
    pl_mask: jnp.ndarray  # (EL,) bool
    # gauge: True where the pose is held fixed
    fixed: jnp.ndarray  # (NP,) bool

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        children = (
            self.poses,
            self.pose_mask,
            self.landmarks,
            self.landmark_mask,
            self.pp_ij,
            self.pp_meas,
            self.pp_info,
            self.pp_mask,
            self.pl_ij,
            self.pl_meas,
            self.pl_info,
            self.pl_mask,
            self.fixed,
        )
        return children, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- convenience --------------------------------------------------------
    @property
    def n_poses(self) -> int:
        return int(np.asarray(jnp.sum(self.pose_mask)))

    @property
    def n_landmarks(self) -> int:
        return int(np.asarray(jnp.sum(self.landmark_mask)))

    @property
    def n_pp_edges(self) -> int:
        return int(np.asarray(jnp.sum(self.pp_mask)))

    @property
    def n_pl_edges(self) -> int:
        return int(np.asarray(jnp.sum(self.pl_mask)))

    def with_poses(self, poses, landmarks=None) -> "PoseGraph2D":
        new = replace(self, poses=poses)
        if landmarks is not None:
            new = replace(new, landmarks=landmarks)
        return new


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class PoseGraph3D:
    """SE3 pose graph; poses stored as [t(3), q_xyzw(4)] like g2o VERTEX_SE3:QUAT."""

    poses: jnp.ndarray  # (NP, 7)
    pose_mask: jnp.ndarray  # (NP,) bool
    pp_ij: jnp.ndarray  # (EP, 2) int32
    pp_meas: jnp.ndarray  # (EP, 7)
    pp_info: jnp.ndarray  # (EP, 6, 6)
    pp_mask: jnp.ndarray  # (EP,) bool
    fixed: jnp.ndarray  # (NP,) bool

    def tree_flatten(self):
        return (
            self.poses,
            self.pose_mask,
            self.pp_ij,
            self.pp_meas,
            self.pp_info,
            self.pp_mask,
            self.fixed,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_poses(self) -> int:
        return int(np.asarray(jnp.sum(self.pose_mask)))

    @property
    def n_pp_edges(self) -> int:
        return int(np.asarray(jnp.sum(self.pp_mask)))

    def with_poses(self, poses) -> "PoseGraph3D":
        return replace(self, poses=poses)


# ---------------------------------------------------------------------------
# Construction from parsed logs
# ---------------------------------------------------------------------------


def graph2d_from_log(
    log: G2OLog,
    dtype=jnp.float32,
    pose_capacity: int | None = None,
    edge_capacity: int | None = None,
) -> tuple[PoseGraph2D, dict]:
    """Build a PoseGraph2D from a parsed .g2o; returns (graph, id maps).

    The id maps (`pose_id2idx`, `lm_id2idx`) translate g2o vertex ids to array
    rows, for writing results back out with the original ids.
    """
    np_, nl = len(log.se2_ids), len(log.xy_ids)
    ep, el = len(log.edge_se2_ij), len(log.edge_se2xy_ij)
    NP = pose_capacity or _cap(np_)
    NL = _cap(max(nl, 1))
    EP = edge_capacity or _cap(max(ep, 1))
    EL = _cap(max(el, 1))

    pose_id2idx = {int(v): i for i, v in enumerate(log.se2_ids)}
    lm_id2idx = {int(v): i for i, v in enumerate(log.xy_ids)}

    poses = np.zeros((NP, 3))
    poses[:np_] = log.se2_poses
    lms = np.zeros((NL, 2))
    if nl:
        lms[:nl] = log.xy_points

    pp_ij = np.zeros((EP, 2), np.int32)
    pp_z = np.zeros((EP, 3))
    pp_w = np.zeros((EP, 3, 3))
    if ep:
        pp_ij[:ep, 0] = [pose_id2idx[int(i)] for i in log.edge_se2_ij[:, 0]]
        pp_ij[:ep, 1] = [pose_id2idx[int(j)] for j in log.edge_se2_ij[:, 1]]
        pp_z[:ep] = log.edge_se2_meas
        pp_w[:ep] = log.edge_se2_info

    pl_ij = np.zeros((EL, 2), np.int32)
    pl_z = np.zeros((EL, 2))
    pl_w = np.zeros((EL, 2, 2))
    if el:
        pl_ij[:el, 0] = [pose_id2idx[int(i)] for i in log.edge_se2xy_ij[:, 0]]
        pl_ij[:el, 1] = [lm_id2idx[int(j)] for j in log.edge_se2xy_ij[:, 1]]
        pl_z[:el] = log.edge_se2xy_meas
        pl_w[:el] = log.edge_se2xy_info

    fixed = np.zeros(NP, bool)
    for vid in log.fixed_ids:
        if int(vid) in pose_id2idx:
            fixed[pose_id2idx[int(vid)]] = True
    if ep and not fixed.any():
        fixed[0] = True  # default gauge: fix the first pose

    g = PoseGraph2D(
        poses=jnp.asarray(poses, dtype),
        pose_mask=jnp.asarray(np.arange(NP) < np_),
        landmarks=jnp.asarray(lms, dtype),
        landmark_mask=jnp.asarray(np.arange(NL) < nl),
        pp_ij=jnp.asarray(pp_ij),
        pp_meas=jnp.asarray(pp_z, dtype),
        pp_info=jnp.asarray(pp_w, dtype),
        pp_mask=jnp.asarray(np.arange(EP) < ep),
        pl_ij=jnp.asarray(pl_ij),
        pl_meas=jnp.asarray(pl_z, dtype),
        pl_info=jnp.asarray(pl_w, dtype),
        pl_mask=jnp.asarray(np.arange(EL) < el),
        fixed=jnp.asarray(fixed),
    )
    return g, {"pose_id2idx": pose_id2idx, "lm_id2idx": lm_id2idx}


def graph3d_from_log(log: G2OLog, dtype=jnp.float32) -> tuple[PoseGraph3D, dict]:
    np_ = len(log.se3_ids)
    ep = len(log.edge_se3_ij)
    npr = len(getattr(log, "prior_se3_ids", ()))
    # EDGE_SE3_PRIOR edges (e.g. IMU orientation priors from the add_imu
    # app) become binary edges to one extra FIXED identity anchor pose —
    # mathematically identical to the unary prior, no special solver path.
    np_tot = np_ + (1 if npr else 0)
    NP, EP = _cap(np_tot), _cap(max(ep + npr, 1))
    id2idx = {int(v): i for i, v in enumerate(log.se3_ids)}

    poses = np.zeros((NP, 7))
    poses[:, 6] = 1.0
    poses[:np_] = log.se3_poses
    pp_ij = np.zeros((EP, 2), np.int32)
    pp_z = np.zeros((EP, 7))
    pp_z[:, 6] = 1.0
    pp_w = np.zeros((EP, 6, 6))
    if ep:
        pp_ij[:ep, 0] = [id2idx[int(i)] for i in log.edge_se3_ij[:, 0]]
        pp_ij[:ep, 1] = [id2idx[int(j)] for j in log.edge_se3_ij[:, 1]]
        pp_z[:ep] = log.edge_se3_meas
        pp_w[:ep] = log.edge_se3_info
    if npr:
        anchor = np_  # identity pose appended after the real ones
        pp_ij[ep : ep + npr, 0] = anchor
        pp_ij[ep : ep + npr, 1] = [id2idx[int(v)] for v in log.prior_se3_ids]
        pp_z[ep : ep + npr] = log.prior_se3_meas
        pp_w[ep : ep + npr] = log.prior_se3_info

    fixed = np.zeros(NP, bool)
    for vid in log.fixed_ids:
        if int(vid) in id2idx:
            fixed[id2idx[int(vid)]] = True
    if npr:
        fixed[np_] = True
    if (ep or npr) and not fixed.any():
        fixed[0] = True

    g = PoseGraph3D(
        poses=jnp.asarray(poses, dtype),
        pose_mask=jnp.asarray(np.arange(NP) < np_tot),
        pp_ij=jnp.asarray(pp_ij),
        pp_meas=jnp.asarray(pp_z, dtype),
        pp_info=jnp.asarray(pp_w, dtype),
        pp_mask=jnp.asarray(np.arange(EP) < ep + npr),
        fixed=jnp.asarray(fixed),
    )
    return g, {"pose_id2idx": id2idx}
