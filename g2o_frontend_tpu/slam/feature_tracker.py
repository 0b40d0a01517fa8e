"""2D landmark SLAM with unknown data association — the `slam/` equivalent.

Re-design of the reference feature-tracker stack
(``slam/feature_tracker.h:326-430``: MapperState / Tracker /
CorrespondenceFinder + RANSAC matcher; driver ``slam/tracker_test.cpp:155``)
for batched device execution:

- the *map* is the flat-array `PoseGraph2D` (poses, XY landmarks,
  odometry + observation edges, masks) growing by capacity doubling,
- per-frame *data association* is one batched kernel: an (O, L) distance
  matrix between world-predicted observations and landmark estimates, gated
  mutual-nearest-neighbor assignment, then vectorized RANSAC
  (`ransac.engine` with the Horn2D solver) to reject wrong matches and
  correct the predicted pose — replacing `PointXYInitialGuessCorrespondence
  Finder` + `PointXYRansacMatcher` (``feature_tracker_pointxy.h:13-133``),
- landmark lifecycle follows `MapperState::updateTracksAndLandmarks`
  (``feature_tracker.h:340-393``): unmatched observations become pending
  tracks; a track seen `min_landmark_creation_frames` times is promoted to a
  landmark with its accumulated observation edges,
- periodic local optimization freezes poses outside the sliding window
  (`localMapSize`/`optimizeEachN` of ``tracker_test.cpp:185-214``), global
  optimization at the end; both are the jitted LM-PCG solver,
- loop closing (`LoopClosureManager`, ``feature_tracker_closure.h:170``):
  when the pose re-enters a previously mapped region, current-window
  landmarks are RANSAC-matched against older landmarks and accepted matches
  merge landmark pairs (edge re-targeting + mask-out, the
  `LandmarkCorrespondenceManager` merge).

Host Python orchestrates (like the reference's main loop); every numerical
step is a fixed-shape jitted kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ransac import solvers as rsolvers
from ..ransac.engine import ransac
from ..utils import lie

# ---------------------------------------------------------------------------
# jitted kernels
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=())
def _associate_nn(obs_world, obs_mask, lms, lm_mask, gate):
    """Gated mutual-NN assignment between observations and landmarks.

    Returns (match_idx (O,) int32 landmark index or -1, dists (O,)).
    """
    d2 = jnp.sum((obs_world[:, None, :] - lms[None, :, :]) ** 2, -1)
    big = jnp.asarray(1e12, d2.dtype)
    d2 = jnp.where(obs_mask[:, None] & lm_mask[None, :], d2, big)
    nn_of_obs = jnp.argmin(d2, axis=1)  # (O,)
    nn_of_lm = jnp.argmin(d2, axis=0)  # (L,)
    best = d2[jnp.arange(d2.shape[0]), nn_of_obs]
    mutual = nn_of_lm[nn_of_obs] == jnp.arange(d2.shape[0])
    ok = mutual & (best < gate * gate) & obs_mask
    return jnp.where(ok, nn_of_obs, -1), best


@partial(jax.jit, static_argnames=())
def _associate_nn_mahal(obs_world, obs_mask, lms, lm_mask, Sinv, chi2_gate,
                        eucl_cap):
    """Mahalanobis-gated mutual-NN assignment (VERDICT r3 Next 3).

    ``Sinv[l]`` is the inverse of the landmark's association covariance
    ``S_l = C_ll + R + sigma_drift^2 I`` (marginal + measurement + pose
    drift since the last global optimize). Distance to landmark l is
    ``(o - l)^T Sinv_l (o - l)`` tested against a chi-square(2) gate —
    duplicates created under drift sit meters apart yet gate IN (large
    drift-aligned covariance), while distinct nearby trees gate OUT.
    `eucl_cap` bounds the search radius in meters (keeps gross outliers
    out even when covariances are huge).
    """
    diff = obs_world[:, None, :] - lms[None, :, :]
    d2m = jnp.einsum("olj,ljk,olk->ol", diff, Sinv, diff)
    d2e = jnp.sum(diff * diff, -1)
    big = jnp.asarray(1e12, d2m.dtype)
    valid = obs_mask[:, None] & lm_mask[None, :] & (
        d2e < eucl_cap * eucl_cap
    )
    d2m = jnp.where(valid, d2m, big)
    nn_of_obs = jnp.argmin(d2m, axis=1)
    nn_of_lm = jnp.argmin(d2m, axis=0)
    best = d2m[jnp.arange(d2m.shape[0]), nn_of_obs]
    mutual = nn_of_lm[nn_of_obs] == jnp.arange(d2m.shape[0])
    ok = mutual & (best < chi2_gate) & obs_mask
    return jnp.where(ok, nn_of_obs, -1), best


def _ransac_verify(key, obs_local, lm_world, pairs_mask, pose_guess, thresh):
    """RANSAC over tentative pairs: returns corrected pose + inlier mask.

    Solves for the robot pose x s.t. lm_world ~ x ⊕ obs_local.
    """
    res = ransac(
        key,
        lm_world,
        obs_local,
        pairs_mask,
        fit_fn=rsolvers.fit_se2_points,
        err_fn=rsolvers.err_se2_points,
        minimal_size=2,
        inlier_threshold=thresh * thresh,
        n_hypotheses=128,
        min_inliers=2,
    )
    return res


# ---------------------------------------------------------------------------
# tracker
# ---------------------------------------------------------------------------


@dataclass
class Tracker2DConfig:
    """Parameter names mirror the ``tracker_test.cpp:185-214`` flags."""

    min_landmark_creation_frames: int = 2
    incremental_ransac_inlier_threshold: float = 0.5
    incremental_guess_max_feature_distance: float = 1.0
    loop_ransac_inlier_threshold: float = 0.2
    loop_guess_max_feature_distance: float = 2.0
    loop_landmark_merge_distance: float = 0.5
    local_map_size: int = 10
    optimize_each_n: int = 10
    local_optimize_iters: int = 3
    global_optimize_iters: int = 15
    # "pcg" (online default) | "schur" (offline polish; see optimize())
    global_solver: str = "pcg"
    # robust (Huber) kernel width in whitened-residual units for GLOBAL
    # optimization; None = quadratic. Under unknown DA the surviving
    # mis-associations otherwise distort the whole trajectory (the
    # reference attaches g2o robust kernels the same way).
    huber_delta: float | None = None
    cg_iters: int = 60
    local_cg_iters: int = 30
    odom_info: tuple = (100.0, 100.0, 1000.0)
    obs_default_info: float = 300.0
    # -odometryIsGood (tracker_test.cpp:187): trust the odometry prediction
    # as the pose estimate; RANSAC only validates correspondences and never
    # overrides the pose (optimization corrects it instead)
    odometry_is_good: bool = False
    # Mahalanobis incremental association (VERDICT r3 Next 3): when
    # refresh_landmark_covariances() has run, the NN gate becomes
    # chi-square on ``C_ll + R + sigma_drift^2 I`` instead of Euclidean.
    # sigma_drift grows per frame since the last refresh (odometry drift);
    # mahal_eucl_cap bounds the search radius in meters.
    mahal_chi2_gate: float = 9.21  # chi2(2) 99%
    mahal_drift_sigma: float = 0.05  # m / frame since last refresh
    mahal_drift_cap: float = 1.5  # cap on the drift inflation (m) — without
    # it the gate degenerates to a eucl_cap-radius accept-anything long
    # after a refresh (measured: ATE 35.8 m, worse than raw odometry)
    mahal_eucl_cap: float = 10.0
    # Per-frame relocalization closure (the reference's
    # LoopClosureCandidateDetector + FrameClusterer,
    # ``feature_tracker_closure.h:9-202``): a single frame's observation
    # set is the only constellation that is PERFECTLY rigid under drift, so
    # it is matched pose-free (distance-consistent hypotheses) against the
    # old map within a drift-budget radius; two consecutive frames must
    # imply the same world correction before the closure is accepted.
    frame_closure: bool = False
    closure_min_obs: int = 5
    closure_old_age: int = 150  # frames unseen before a landmark is "old"
    closure_drift_base: float = 10.0  # m, search radius floor
    closure_drift_rate: float = 0.05  # m per frame since last localization
    closure_drift_cap: float = 100.0
    closure_rot_gate: float = 1.2  # rad, hypothesis gate around prediction
    closure_dist_tol: float = 0.4
    closure_inlier_threshold: float = 1.0
    closure_min_inliers: int = 5
    closure_cluster_tol: float = 3.0  # consecutive-proposal agreement (m)
    closure_cluster_rot_tol: float = 0.15
    # minimum graph capacities: reserving the final size up front means the
    # jitted global solvers compile ONCE for the whole run instead of at
    # every capacity doubling (long-run wall-clock is compile-dominated on
    # the host; the padded rows are masked out)
    reserve_poses: int = 0
    reserve_landmarks: int = 0
    reserve_odom_edges: int = 0
    reserve_obs_edges: int = 0
    seed: int = 0


def _np_cap(n: int, minimum: int = 8) -> int:
    c = minimum
    while c < n:
        c *= 2
    return c


def _se2_compose_np(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array(
        [a[0] + c * b[0] - s * b[1],
         a[1] + s * b[0] + c * b[1],
         (a[2] + b[2] + np.pi) % (2 * np.pi) - np.pi],
        np.float32,
    )


def _se2_rel_np(a, b):
    """SE2 relative chart a^{-1} b (float64 in, float64 out)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    dth = (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], dth],
                    np.float64)


def _se2_apply_np(x, pts):
    c, s = np.cos(x[2]), np.sin(x[2])
    R = np.array([[c, -s], [s, c]], np.float32)
    return pts @ R.T + x[:2]


class FeatureTracker2D:
    """Incremental 2D landmark SLAM over a growing flat-array graph."""

    def __init__(self, config: Tracker2DConfig = Tracker2DConfig()):
        self.cfg = config
        self.key = jax.random.PRNGKey(config.seed)
        # growing host-side arrays (device kernels see padded snapshots)
        self.poses: list[np.ndarray] = []  # [x, y, th]
        self.landmarks = np.zeros((0, 2), np.float32)
        self.lm_alive = np.zeros(0, bool)
        self.lm_seen = np.zeros(0, np.int32)
        self.odom_edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self.obs_edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        # pending tracks: pos (world), count, history [(pose_idx, local_xy, info)]
        self.pending: list[dict] = []
        self.frame = 0
        # per-landmark 2x2 marginal covariances for Mahalanobis association
        # (None until refresh_landmark_covariances() runs)
        self.lm_cov: np.ndarray | None = None
        self._cov_frame = 0  # frame at last covariance refresh
        # per-frame relocalization state
        self.lm_last_seen = np.zeros(0, np.int32)
        self._drift_frames = 0  # frames since last accepted relocalization
        self._pending_closure: tuple | None = None  # (frame, world corr)
        self.n_relocalizations = 0  # accepted frame-closure count

    # -- graph snapshot -----------------------------------------------------
    def graph(self, window_fix_before: int | None = None):
        """Build a PoseGraph2D snapshot (optionally freezing old poses)."""
        from ..graph.store import PoseGraph2D, _cap

        n = len(self.poses)
        nl = len(self.landmarks)
        ep = len(self.odom_edges)
        el = len(self.obs_edges)
        cfg = self.cfg
        NP = _cap(max(n, 1, cfg.reserve_poses))
        NL = _cap(max(nl, 1, cfg.reserve_landmarks))
        EP = _cap(max(ep, 1, cfg.reserve_odom_edges))
        EL = _cap(max(el, 1, cfg.reserve_obs_edges))

        poses = np.zeros((NP, 3), np.float32)
        if n:
            poses[:n] = np.asarray(self.poses)
        lms = np.zeros((NL, 2), np.float32)
        if nl:
            lms[:nl] = self.landmarks
        pp_ij = np.zeros((EP, 2), np.int32)
        pp_z = np.zeros((EP, 3), np.float32)
        pp_w = np.zeros((EP, 3, 3), np.float32)
        for k, (i, j, z, w) in enumerate(self.odom_edges):
            pp_ij[k] = (i, j)
            pp_z[k] = z
            pp_w[k] = w
        pl_ij = np.zeros((EL, 2), np.int32)
        pl_z = np.zeros((EL, 2), np.float32)
        pl_w = np.zeros((EL, 2, 2), np.float32)
        for k, (i, l, z, w) in enumerate(self.obs_edges):
            pl_ij[k] = (i, l)
            pl_z[k] = z
            pl_w[k] = w
        fixed = np.zeros(NP, bool)
        fixed[0] = True
        if window_fix_before is not None:
            fixed[: min(window_fix_before, n)] = True
        lm_mask = np.zeros(NL, bool)
        lm_mask[:nl] = self.lm_alive
        return PoseGraph2D(
            poses=jnp.asarray(poses),
            pose_mask=jnp.asarray(np.arange(NP) < n),
            landmarks=jnp.asarray(lms),
            landmark_mask=jnp.asarray(lm_mask),
            pp_ij=jnp.asarray(pp_ij),
            pp_meas=jnp.asarray(pp_z),
            pp_info=jnp.asarray(pp_w),
            pp_mask=jnp.asarray(np.arange(EP) < ep),
            pl_ij=jnp.asarray(pl_ij),
            pl_meas=jnp.asarray(pl_z),
            pl_info=jnp.asarray(pl_w),
            pl_mask=jnp.asarray(np.arange(EL) < el),
            fixed=jnp.asarray(fixed),
        )

    def _sync_from_graph(self, g):
        n = len(self.poses)
        nl = len(self.landmarks)
        poses = np.asarray(g.poses)[:n]
        for i in range(n):
            self.poses[i] = poses[i]
        if nl:
            self.landmarks = np.array(np.asarray(g.landmarks)[:nl])

    # -- main entry ---------------------------------------------------------
    def process_frame(self, odom_delta, obs_local, obs_info=None):
        """Ingest one frame.

        Args:
          odom_delta: (3,) relative odometry from the previous pose
            (ignored for the first frame; pass zeros).
          obs_local: (O, 2) feature observations in the robot frame.
          obs_info: optional (O, 2, 2) information matrices.
        """
        cfg = self.cfg
        obs_local = np.asarray(obs_local, np.float32).reshape(-1, 2)
        O = len(obs_local)
        if obs_info is None:
            obs_info = np.tile(
                np.eye(2, dtype=np.float32) * cfg.obs_default_info, (O, 1, 1)
            )

        # 1. pose prediction
        if not self.poses:
            pose = np.zeros(3, np.float32)
            self.poses.append(pose)
        else:
            prev = self.poses[-1]
            pose = _se2_compose_np(
                np.asarray(prev, np.float32), np.asarray(odom_delta, np.float32)
            )
            self.poses.append(pose)
            info = np.diag(np.asarray(cfg.odom_info, np.float32))
            self.odom_edges.append(
                (len(self.poses) - 2, len(self.poses) - 1,
                 np.asarray(odom_delta, np.float32), info)
            )
        pose_idx = len(self.poses) - 1

        # 2a. per-frame relocalization (drift-tolerant closure proposal)
        forced: dict[int, int] = {}
        self._drift_frames += 1
        if (
            cfg.frame_closure
            and O >= cfg.closure_min_obs
            and self.lm_alive.any()
        ):
            reloc = self._propose_frame_closure(pose, obs_local)
            if reloc is not None:
                pose, forced = reloc
                self.poses[-1] = pose

        matched_lm = np.full(O, -1, np.int64)
        if O and self.lm_alive.any():
            matched_lm = self._associate(pose, obs_local)
        for oi, li in forced.items():
            matched_lm[oi] = li

        # 3. record observation edges for matches
        for oi in range(O):
            li = matched_lm[oi]
            if li >= 0:
                self.obs_edges.append((pose_idx, int(li), obs_local[oi], obs_info[oi]))
                self.lm_seen[li] += 1
                self.lm_last_seen[li] = self.frame

        # 4. pending-track management for unmatched observations
        self._update_pending(pose, pose_idx, obs_local, obs_info, matched_lm)

        # 5. periodic local optimization
        self.frame += 1
        if cfg.optimize_each_n and self.frame % cfg.optimize_each_n == 0:
            self.optimize(local=True)

        return matched_lm

    # -- per-frame relocalization ------------------------------------------
    def _propose_frame_closure(self, pose_pred, obs_local):
        """Match THIS frame's observation constellation (robot frame,
        rigid by construction) against the old map, pose-free.

        Returns (corrected_pose (3,), {obs_idx: landmark_idx}) when two
        consecutive eligible frames imply the same world correction
        (FrameClusterer acceptance), else None.
        """
        from .constellation import match_constellations

        cfg = self.cfg
        R = min(
            cfg.closure_drift_base + cfg.closure_drift_rate
            * self._drift_frames,
            cfg.closure_drift_cap,
        )
        old = np.where(
            self.lm_alive
            & (self.frame - self.lm_last_seen > cfg.closure_old_age)
        )[0]
        if len(old) < cfg.closure_min_inliers:
            return None
        sense_r = float(np.linalg.norm(obs_local, axis=1).max())
        d = np.linalg.norm(
            self.landmarks[old] - np.asarray(pose_pred[:2]), axis=1
        )
        B_idx = old[d < R + sense_r + 5.0]
        if len(B_idx) < cfg.closure_min_inliers:
            return None
        m = match_constellations(
            obs_local,
            self.landmarks[B_idx],
            dist_tol=cfg.closure_dist_tol,
            inlier_threshold=cfg.closure_inlier_threshold,
            min_inliers=cfg.closure_min_inliers,
            min_pair_sep=1.0,
            max_pair_sep=2.0 * sense_r + 1.0,
            trans_gate=R,
            rot_gate=cfg.closure_rot_gate,
            prior=np.asarray(pose_pred, np.float64),
            seed=self.frame,
        )
        if not m.ok:
            return None
        T = np.asarray(m.transform, np.float32)
        corr = np.array(
            [T[0] - pose_pred[0], T[1] - pose_pred[1],
             (T[2] - pose_pred[2] + np.pi) % (2 * np.pi) - np.pi],
            np.float64,
        )
        prev = self._pending_closure
        self._pending_closure = (self.frame, corr)
        if prev is None or self.frame - prev[0] > 3:
            return None
        dcorr = corr - prev[1]
        if (
            np.hypot(dcorr[0], dcorr[1]) > cfg.closure_cluster_tol
            or abs((dcorr[2] + np.pi) % (2 * np.pi) - np.pi)
            > cfg.closure_cluster_rot_tol
        ):
            return None
        self._pending_closure = None
        self._drift_frames = 0
        self.n_relocalizations += 1
        pairs = {int(ia): int(B_idx[ib]) for ia, ib in m.pairs}
        return T, pairs

    def propose_window_closure(self, window=60, dist_tol=0.4,
                               inlier_threshold=1.0, min_inliers=6,
                               old_age=150, drift_base=10.0,
                               drift_rate=0.05, drift_cap=100.0,
                               rot_gate=1.2, apply=True):
        """Drift-tolerant ONLINE closure: match the recent window's
        constellation against the old map, pose-free, and merge matches.

        Victoria-style logs see at most ~2 landmarks per frame, so the
        rigid matching unit is the last `window` poses' observation set
        (near-rigid because the tracking loop keeps re-solving it), played
        against landmarks unseen for `old_age` frames within a drift-budget
        radius (`drift_base + drift_rate * frames_since_localized`). The
        hypothesis space is gated around identity by that budget — the
        pose-free matching lives INSIDE the gate, which is what makes the
        quasi-regular tree pattern unambiguous (measured: precision 0.21
        without the gate). Callers should follow an accepted merge with a
        validated solve and roll back on a chi2 jump (the
        ``map_closer`` consensus pattern). Returns merged pair count.
        """
        from .constellation import match_constellations

        n = len(self.poses)
        start = max(0, n - window)
        acc: dict[int, list] = {}
        for (p, l, z, _w) in self.obs_edges:
            if p >= start and self.lm_alive[l]:
                acc.setdefault(int(l), []).append(
                    _se2_apply_np(
                        np.asarray(self.poses[p], np.float32),
                        np.asarray(z, np.float32)[None],
                    )[0]
                )
        if len(acc) < min_inliers:
            return 0
        ids_a = np.array(sorted(acc), np.int64)
        pos_a = np.stack([np.mean(acc[int(l)], 0) for l in ids_a])
        R = min(drift_base + drift_rate * self._drift_frames, drift_cap)
        in_window = set(ids_a.tolist())
        old = np.array(
            [
                l for l in np.where(self.lm_alive)[0]
                if l not in in_window
                and self.frame - int(self.lm_last_seen[l]) > old_age
            ],
            np.int64,
        )
        if len(old) < min_inliers:
            return 0
        centroid = pos_a.mean(0)
        span = float(np.linalg.norm(pos_a - centroid, axis=1).max())
        d = np.linalg.norm(self.landmarks[old] - centroid, axis=1)
        B_idx = old[d < R + span + 5.0]
        if len(B_idx) < min_inliers:
            return 0
        m = match_constellations(
            pos_a,
            self.landmarks[B_idx],
            dist_tol=dist_tol,
            inlier_threshold=inlier_threshold,
            min_inliers=min_inliers,
            min_pair_sep=1.0,
            max_pair_sep=2.0 * span + 5.0,
            trans_gate=R,
            rot_gate=rot_gate,
            seed=self.frame,
        )
        if not m.ok:
            return None if not apply else 0
        pairs = [
            (int(ids_a[ia]), int(B_idx[ib]))
            for ia, ib in m.pairs
            if int(ids_a[ia]) != int(B_idx[ib])
            and self.lm_alive[int(ids_a[ia])]
            and self.lm_alive[int(B_idx[ib])]
        ]
        if not apply:
            # transform + window range let the absorber warp the trajectory
            # into the closure's basin before solving (the fine solver
            # alone converges to a kinked stationary point on large
            # corrections — measured chi2 4e5 vs true optimum ~1e2)
            return {"pairs": pairs,
                    "transform": np.asarray(m.transform, np.float64),
                    "window_start": start}
        merged = 0
        for la, lb in pairs:
            if self.lm_alive[la] and self.lm_alive[lb]:
                self._merge_landmarks(lb, la)  # keep the old landmark
                merged += 1
        if merged:
            self.n_relocalizations += 1
        return merged

    def obs_edge_chi2(self):
        """Per-observation-edge chi2 at the current estimate (E,)."""
        if not self.obs_edges:
            return np.zeros(0)
        poses = np.asarray(self.poses, np.float64)
        E = len(self.obs_edges)
        P = np.fromiter((e[0] for e in self.obs_edges), np.int64, E)
        Li = np.fromiter((e[1] for e in self.obs_edges), np.int64, E)
        Z = np.stack([np.asarray(e[2], np.float64) for e in self.obs_edges])
        Wm = np.stack([np.asarray(e[3], np.float64) for e in self.obs_edges])
        c, s = np.cos(poses[P, 2]), np.sin(poses[P, 2])
        dd = self.landmarks[Li].astype(np.float64) - poses[P, :2]
        e = np.stack([c * dd[:, 0] + s * dd[:, 1],
                      -s * dd[:, 0] + c * dd[:, 1]], 1) - Z
        return np.einsum("ki,kij,kj->k", e, Wm, e)

    # -- association --------------------------------------------------------
    def _associate(self, pose, obs_local):
        """Gated NN + RANSAC association with capacity-padded (compile-stable)
        shapes: observations pad to a power-of-two bucket, landmarks to their
        capacity — the kernels recompile only at capacity doublings."""
        cfg = self.cfg
        O = len(obs_local)
        OC = _np_cap(max(O, 1))
        L = len(self.landmarks)
        LC = _np_cap(max(L, 1))
        obs_world = _se2_apply_np(np.asarray(pose, np.float32), obs_local)
        obs_pad = np.zeros((OC, 2), np.float32)
        obs_pad[:O] = obs_world
        obs_mask = np.arange(OC) < O
        lms_pad = np.zeros((LC, 2), np.float32)
        lms_pad[:L] = self.landmarks
        alive_pad = np.zeros(LC, bool)
        alive_pad[:L] = self.lm_alive
        if self.lm_cov is not None:
            # Mahalanobis gate: S_l = C_ll + R + sigma_drift^2 I, with the
            # drift term growing since the last covariance refresh. R is
            # derived from the dataset's observation information matrices
            # (ADVICE r4: a hardcoded R mis-calibrates the chi2(2) gate on
            # datasets with different sensor noise).
            sig2 = min(
                cfg.mahal_drift_sigma * max(self.frame - self._cov_frame, 1),
                cfg.mahal_drift_cap,
            ) ** 2
            r2 = 1.0 / max(float(cfg.obs_default_info), 1e-6)
            S = np.tile((r2 + sig2) * np.eye(2, dtype=np.float32),
                        (LC, 1, 1))
            ncov = min(len(self.lm_cov), L)
            S[:ncov] += self.lm_cov[:ncov]
            det = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
            det = np.maximum(det, 1e-12)
            Sinv = np.empty_like(S)
            Sinv[:, 0, 0] = S[:, 1, 1] / det
            Sinv[:, 1, 1] = S[:, 0, 0] / det
            Sinv[:, 0, 1] = -S[:, 0, 1] / det
            Sinv[:, 1, 0] = -S[:, 1, 0] / det
            m_idx, _ = _associate_nn_mahal(
                jnp.asarray(obs_pad),
                jnp.asarray(obs_mask),
                jnp.asarray(lms_pad),
                jnp.asarray(alive_pad),
                jnp.asarray(Sinv),
                cfg.mahal_chi2_gate,
                cfg.mahal_eucl_cap,
            )
        else:
            m_idx, _ = _associate_nn(
                jnp.asarray(obs_pad),
                jnp.asarray(obs_mask),
                jnp.asarray(lms_pad),
                jnp.asarray(alive_pad),
                cfg.incremental_guess_max_feature_distance,
            )
        m_idx = np.asarray(m_idx)[:O]
        pairs = m_idx >= 0
        if pairs.sum() < 3:
            return np.where(pairs, m_idx, -1)

        # RANSAC verification of the tentative set (+ pose correction)
        lm_w = np.zeros((OC, 2), np.float32)
        lm_w[:O][pairs] = self.landmarks[m_idx[pairs]]
        obs_local_pad = np.zeros((OC, 2), np.float32)
        obs_local_pad[:O] = obs_local
        pairs_pad = np.zeros(OC, bool)
        pairs_pad[:O] = pairs
        self.key, sub = jax.random.split(self.key)
        res = _ransac_verify(
            sub,
            jnp.asarray(obs_local_pad),
            jnp.asarray(lm_w),
            jnp.asarray(pairs_pad),
            jnp.asarray(pose),
            cfg.incremental_ransac_inlier_threshold,
        )
        if not bool(res.ok):
            return np.full(O, -1, np.int64)
        inl = np.asarray(res.inliers)[:O]
        if not cfg.odometry_is_good:
            # corrected pose from the RANSAC transform
            self.poses[-1] = np.asarray(res.transform, np.float32)
        return np.where(pairs & inl, m_idx, -1)

    # -- landmark lifecycle -------------------------------------------------
    def _update_pending(self, pose, pose_idx, obs_local, obs_info, matched_lm):
        cfg = self.cfg
        obs_world = (
            _se2_apply_np(np.asarray(pose, np.float32), obs_local)
            if len(obs_local)
            else np.zeros((0, 2), np.float32)
        )
        unmatched = [
            oi for oi in range(len(obs_local)) if matched_lm[oi] < 0
        ]
        used = set()
        # match pending tracks by NN
        for p in self.pending:
            best, bd = -1, cfg.incremental_guess_max_feature_distance**2
            for oi in unmatched:
                if oi in used:
                    continue
                d = float(np.sum((obs_world[oi] - p["pos"]) ** 2))
                if d < bd:
                    best, bd = oi, d
            if best >= 0:
                used.add(best)
                p["count"] += 1
                p["pos"] = 0.5 * (p["pos"] + obs_world[best])
                p["hist"].append((pose_idx, obs_local[best], obs_info[best]))
            else:
                p["count"] = -1  # lost -> drop
        self.pending = [p for p in self.pending if p["count"] >= 0]

        # promote mature tracks
        promoted = []
        for p in self.pending:
            if p["count"] + 1 >= max(cfg.min_landmark_creation_frames, 1):
                li = len(self.landmarks)
                self.landmarks = np.vstack(
                    [self.landmarks, p["pos"][None].astype(np.float32)]
                )
                self.lm_alive = np.append(self.lm_alive, True)
                self.lm_seen = np.append(self.lm_seen, len(p["hist"]))
                self.lm_last_seen = np.append(
                    self.lm_last_seen, np.int32(self.frame)
                )
                for (pi, z, w) in p["hist"]:
                    self.obs_edges.append((pi, li, z, w))
                promoted.append(id(p))
        self.pending = [p for p in self.pending if id(p) not in promoted]

        # new tracks for remaining unmatched
        for oi in unmatched:
            if oi in used:
                continue
            self.pending.append(
                {
                    "pos": obs_world[oi].copy(),
                    "count": 0,
                    "hist": [(pose_idx, obs_local[oi], obs_info[oi])],
                }
            )

    # -- optimization -------------------------------------------------------
    def optimize(self, local=False, iters=None):
        if local:
            return self._optimize_window()
        cfg = self.cfg
        iters = cfg.global_optimize_iters if iters is None else iters
        g = self.graph()
        if cfg.global_solver == "control":
            # float64 exact LM (host sparse Cholesky). In-loop strong solves
            # are what keep drift bounded enough for association gates to
            # work on rotation-burst odometry (Victoria: 197 steps with
            # >0.1 rad heading error — a 5-iter PCG solve leaves kinks that
            # -odometryIsGood composes from, the measured r4 dead end; the
            # exact solve has no kink to compose from).
            from ..solvers.control import control_optimize_se2

            ctl = control_optimize_se2(self.graph(), max_iters=iters)
            n = len(self.poses)
            for i in range(n):
                self.poses[i] = np.asarray(ctl["poses"][i], np.float32)
            nl = len(self.landmarks)
            if nl:
                self.landmarks = np.asarray(ctl["landmarks"][:nl], np.float32)
            return float(ctl["chi2"])
        if cfg.global_solver == "schur":
            # Schur + chain-preconditioned LM (solvers/schur_pcg.py):
            # reaches the control optimum where block-Jacobi PCG stalls,
            # but costs a Woodbury factor per LM iteration — opt-in for
            # final offline polishing (measured on victoria unknown-DA:
            # same chi2 basin as PCG, 14x slower in the online loop)
            from ..solvers.schur_pcg import optimize_se2_schur

            g_opt, stats = optimize_se2_schur(
                g, iters=iters, cg_iters=cfg.cg_iters,
                huber_delta=cfg.huber_delta,
            )
        else:
            from ..solvers.pose_graph import optimize_se2

            g_opt, stats = optimize_se2(
                g, iters=iters, cg_iters=cfg.cg_iters,
                huber_delta=cfg.huber_delta,
            )
        self._sync_from_graph(g_opt)
        return float(np.asarray(stats.chi2)[-1])

    def refresh_landmark_covariances(self):
        """Recompute per-landmark 2x2 marginal covariances from the current
        graph (Schur/Woodbury arrow, solvers/schur_pcg.landmark_covariance_
        se2 — the reference's computeMarginals role) and reset the drift
        clock. Call after a global optimize; _associate then switches to the
        Mahalanobis gate (VERDICT r3 Next 3: use the covariance machinery
        DURING tracking, not just at merge time)."""
        from ..solvers.schur_pcg import landmark_covariance_se2

        nl = len(self.landmarks)
        if nl == 0 or not self.lm_alive.any():
            return
        cov = landmark_covariance_se2(self.graph())
        self.lm_cov = np.asarray(
            cov[np.arange(nl), :, np.arange(nl), :], np.float32
        )
        self._cov_frame = self.frame

    def _optimize_window(self):
        """Local optimization over the sliding window as a FIXED-CAPACITY
        subgraph (the `OptimizationManager` local map of
        ``feature_tracker_closure.h`` / localMapSize of tracker_test): only
        the last `local_map_size` poses and the landmarks they observe enter
        the solver; landmarks already observed before the window are held
        fixed (established map). Shapes depend only on the capacity buckets,
        so the solver compiles a handful of times over a whole run."""
        from ..graph.store import PoseGraph2D
        from ..solvers.pose_graph import optimize_se2

        cfg = self.cfg
        n = len(self.poses)
        W = min(cfg.local_map_size, n)
        if W < 2:
            return 0.0
        start = n - W
        # window odometry edges
        odo = [(i, j, z, w) for (i, j, z, w) in self.odom_edges if i >= start]
        # window observation edges + involved landmarks
        obs = [(p, l, z, w) for (p, l, z, w) in self.obs_edges if p >= start]
        lm_ids = sorted({l for (_, l, _, _) in obs})
        lmap = {l: k for k, l in enumerate(lm_ids)}
        # landmarks with observations before the window stay fixed
        seen_before = {l for (p, l, _, _) in self.obs_edges if p < start}

        WP = _np_cap(cfg.local_map_size)
        EO = _np_cap(max(len(odo), 1))
        EB = _np_cap(max(len(obs), 1))
        LW = _np_cap(max(len(lm_ids), 1))

        poses = np.zeros((WP, 3), np.float32)
        poses[:W] = np.asarray(self.poses[start:])
        lms = np.zeros((LW, 2), np.float32)
        if lm_ids:
            lms[: len(lm_ids)] = self.landmarks[lm_ids]
        pp_ij = np.zeros((EO, 2), np.int32)
        pp_z = np.zeros((EO, 3), np.float32)
        pp_w = np.zeros((EO, 3, 3), np.float32)
        for k, (i, j, z, w) in enumerate(odo):
            pp_ij[k] = (i - start, j - start)
            pp_z[k] = z
            pp_w[k] = w
        pl_ij = np.zeros((EB, 2), np.int32)
        pl_z = np.zeros((EB, 2), np.float32)
        pl_w = np.zeros((EB, 2, 2), np.float32)
        for k, (p, l, z, w) in enumerate(obs):
            pl_ij[k] = (p - start, lmap[l])
            pl_z[k] = z
            pl_w[k] = w
        fixed = np.zeros(WP, bool)
        fixed[0] = True  # gauge: anchor the window's first pose
        lm_free = np.zeros(LW, bool)
        for l in lm_ids:
            lm_free[lmap[l]] = l not in seen_before
        g = PoseGraph2D(
            poses=jnp.asarray(poses),
            pose_mask=jnp.asarray(np.arange(WP) < W),
            landmarks=jnp.asarray(lms),
            landmark_mask=jnp.asarray(lm_free),
            pp_ij=jnp.asarray(pp_ij),
            pp_meas=jnp.asarray(pp_z),
            pp_info=jnp.asarray(pp_w),
            pp_mask=jnp.asarray(np.arange(EO) < len(odo)),
            pl_ij=jnp.asarray(pl_ij),
            pl_meas=jnp.asarray(pl_z),
            pl_info=jnp.asarray(pl_w),
            pl_mask=jnp.asarray(np.arange(EB) < len(obs)),
            fixed=jnp.asarray(fixed),
        )
        g_opt, stats = optimize_se2(
            g, iters=cfg.local_optimize_iters, cg_iters=cfg.local_cg_iters
        )
        new_poses = np.asarray(g_opt.poses)[:W]
        for k in range(W):
            self.poses[start + k] = new_poses[k]
        new_lms = np.asarray(g_opt.landmarks)
        for l in lm_ids:
            if lm_free[lmap[l]]:
                self.landmarks[l] = new_lms[lmap[l]]
        return float(np.asarray(stats.chi2)[-1])

    # -- loop closing -------------------------------------------------------
    def close_loops(self):
        """RANSAC-match recent landmarks against older ones; merge accepted.

        The reference's detector gates candidates by pose distance then
        RANSACs landmark correspondences (``feature_tracker_closure.h``).
        Here: landmarks first seen in the recent window vs the rest, gated
        NN + RANSAC; accepted pairs are merged (edges re-targeted).
        """
        cfg = self.cfg
        nl = len(self.landmarks)
        if nl < 8:
            return 0
        # recent = landmarks observed from window poses
        window_start = max(0, len(self.poses) - cfg.local_map_size)
        recent_set = {
            l for (p, l, _, _) in self.obs_edges if p >= window_start
        }
        recent = np.array(sorted(recent_set), np.int64)
        old = np.array(
            [l for l in range(nl) if self.lm_alive[l] and l not in recent_set],
            np.int64,
        )
        if len(recent) < 3 or len(old) < 3:
            return 0
        RC = _np_cap(len(recent))
        OC = _np_cap(len(old))
        rec_pad = np.zeros((RC, 2), np.float32)
        rec_pad[: len(recent)] = self.landmarks[recent]
        rec_mask = np.arange(RC) < len(recent)
        old_pad = np.zeros((OC, 2), np.float32)
        old_pad[: len(old)] = self.landmarks[old]
        old_mask = np.arange(OC) < len(old)
        m_idx, _ = _associate_nn(
            jnp.asarray(rec_pad),
            jnp.asarray(rec_mask),
            jnp.asarray(old_pad),
            jnp.asarray(old_mask),
            cfg.loop_guess_max_feature_distance,
        )
        m_idx = np.asarray(m_idx)[: len(recent)]
        pairs = m_idx >= 0
        if pairs.sum() < 3:
            return 0
        tgt = np.zeros((RC, 2), np.float32)
        tgt[: len(recent)][pairs] = self.landmarks[old[m_idx[pairs]]]
        pairs_pad = np.zeros(RC, bool)
        pairs_pad[: len(recent)] = pairs
        self.key, sub = jax.random.split(self.key)
        res = ransac(
            sub,
            jnp.asarray(tgt),
            jnp.asarray(rec_pad),
            jnp.asarray(pairs_pad),
            fit_fn=rsolvers.fit_se2_points,
            err_fn=rsolvers.err_se2_points,
            minimal_size=2,
            inlier_threshold=cfg.loop_ransac_inlier_threshold**2,
            n_hypotheses=256,
            min_inliers=3,
        )
        if not bool(res.ok):
            return 0
        inl = np.asarray(res.inliers)[: len(recent)]
        merged = 0
        for k in range(len(recent)):
            if pairs[k] and inl[k]:
                keep = int(old[m_idx[k]])
                drop = int(recent[k])
                if keep == drop or not self.lm_alive[drop]:
                    continue
                self._merge_landmarks(keep, drop)
                merged += 1
        return merged

    def close_loops_global(self, segment=200, gate=4.0, inlier_threshold=0.3):
        """Whole-trajectory closure sweep: merge drift-separated duplicates.

        The per-call `close_loops` only compares the *current* window's
        landmarks against the rest (the online closure of
        ``feature_tracker_closure.h:170``). After the run, duplicated
        landmarks created under drift can sit several meters apart — too far
        for `merge_nearby_landmarks`, but still related by a locally rigid
        SE2. This sweep plays the reference's batch closure role
        (``tracker_test.cpp`` final optimize + merge): for every `segment`
        -pose stretch of the trajectory, RANSAC-fit an SE2 from that
        segment's landmarks to their nearest non-segment neighbours (gated
        at `gate` meters) and merge the consensus pairs.

        Returns the number of merged landmark pairs.
        """
        merged_total = 0
        n = len(self.poses)
        nl = len(self.landmarks)
        if nl < 8:
            return 0
        for s0 in range(0, n, segment):
            window = set(range(s0, min(s0 + segment, n)))
            seg_set = {
                l for (p, l, _, _) in self.obs_edges
                if p in window and self.lm_alive[l]
            }
            other = [
                l for l in range(nl) if self.lm_alive[l] and l not in seg_set
            ]
            seg_l = np.array(sorted(seg_set), np.int64)
            if len(seg_l) < 3 or len(other) < 3:
                continue
            L_seg = self.landmarks[seg_l]
            L_oth = self.landmarks[np.array(other)]
            d2 = np.sum((L_seg[:, None] - L_oth[None, :]) ** 2, -1)
            # candidate pairs = ALL (segment, other) pairs within the gate —
            # a nearest-neighbour-only pairing starves RANSAC of the true
            # consensus when drift is comparable to landmark spacing
            si, oi = np.nonzero(d2 < gate * gate)
            if len(si) < 3:
                continue
            RC = _np_cap(len(si))
            src = np.zeros((RC, 2), np.float32)
            src[: len(si)] = L_seg[si]
            tgt = np.zeros((RC, 2), np.float32)
            tgt[: len(si)] = L_oth[oi]
            pm = np.zeros(RC, bool)
            pm[: len(si)] = True
            self.key, sub = jax.random.split(self.key)
            res = ransac(
                sub,
                jnp.asarray(tgt),
                jnp.asarray(src),
                jnp.asarray(pm),
                fit_fn=rsolvers.fit_se2_points,
                err_fn=rsolvers.err_se2_points,
                minimal_size=2,
                inlier_threshold=inlier_threshold**2,
                n_hypotheses=256,
                min_inliers=4,
            )
            if not bool(res.ok):
                continue
            # consensus gate (ADVICE r2): a fit supported by only a handful
            # of landmarks is a spurious alignment — merging through it
            # would corrupt the landmark map irreversibly. Require the
            # RANSAC consensus to cover a meaningful fraction of the
            # DISTINCT segment landmarks that had any gated candidate (the
            # pair count itself grows combinatorially with the gate and
            # would starve true consensus).
            n_inl = int(np.asarray(res.inliers)[: len(si)].sum())
            n_src = len(set(si.tolist()))
            if n_inl < max(4, 0.25 * n_src):
                continue
            # re-match ALL segment landmarks through the fitted SE2 (the
            # reference closure re-binds correspondences after the transform,
            # not just the RANSAC inliers) — NN under the drift-corrected
            # positions, accepted at the inlier threshold
            T = np.asarray(res.transform)
            warped = _se2_apply_np(T, L_seg)
            d2w = np.sum((warped[:, None] - L_oth[None, :]) ** 2, -1)
            jw = np.argmin(d2w, 1)
            dw = d2w[np.arange(len(seg_l)), jw]
            for k in range(len(seg_l)):
                if dw[k] < inlier_threshold * inlier_threshold:
                    keep = int(other[jw[k]])
                    drop = int(seg_l[k])
                    if keep != drop and self.lm_alive[drop] and self.lm_alive[keep]:
                        self._merge_landmarks(keep, drop)
                        merged_total += 1
        return merged_total

    def close_loops_constellation(self, segment=250, dist_tol=0.3,
                                  inlier_threshold=1.0, min_inliers=6,
                                  min_pair_sep=2.0, max_pair_sep=40.0,
                                  require_anchor_ratio=0.0):
        """Drift-tolerant loop-closure proposal via constellation matching.

        The pose-gated sweeps (`close_loops`, `close_loops_global`) cannot
        propose a revisit once drift exceeds their gates. This sweep matches
        landmark *patterns* with no pose prior (the
        ``graph_merge/graph_matcher.h:19-66`` role, candidate detection of
        ``feature_tracker_closure.h:9-202``): the trajectory is cut into
        `segment`-pose stretches, each stretch's constellation is rebuilt
        from its OWN observations (locally rigid under drift), and every
        segment pair is rigidly matched through pairwise-distance-consistent
        hypotheses scored in one batched kernel. Accepted matches merge the
        corresponding landmark pairs; callers should `reassociate` +
        `optimize` afterwards (the existing verification EM).

        `require_anchor_ratio` > 0 additionally demands that a fraction of
        the supporting correspondences are already-shared landmarks (anchor
        evidence) before accepting brand-new merges from a pair.

        Returns the number of merged landmark pairs.
        """
        from .constellation import (match_constellations,
                                    segment_constellations)

        segs = segment_constellations(
            self.poses, self.obs_edges, self.lm_alive, segment
        )
        merged = 0
        for j in range(len(segs)):
            ids_a, pos_a = segs[j]
            if len(ids_a) < min_inliers:
                continue
            for i in range(j):
                ids_b, pos_b = segs[i]
                if len(ids_b) < min_inliers:
                    continue
                m = match_constellations(
                    pos_a,
                    pos_b,
                    dist_tol=dist_tol,
                    inlier_threshold=inlier_threshold,
                    min_inliers=min_inliers,
                    min_pair_sep=min_pair_sep,
                    max_pair_sep=max_pair_sep,
                    seed=i * 10007 + j,
                )
                if not m.ok:
                    continue
                new_pairs = [
                    (int(ids_a[ia]), int(ids_b[ib]))
                    for ia, ib in m.pairs
                    if int(ids_a[ia]) != int(ids_b[ib])
                ]
                n_anchor = m.n_inliers - len(new_pairs)
                if not new_pairs:
                    continue
                if require_anchor_ratio > 0.0 and (
                    n_anchor < require_anchor_ratio * m.n_inliers
                ):
                    continue
                for la, lb in new_pairs:
                    if (
                        la != lb
                        and self.lm_alive[la]
                        and self.lm_alive[lb]
                    ):
                        # keep the earlier-created landmark
                        keep, drop = (lb, la) if lb < la else (la, lb)
                        self._merge_landmarks(keep, drop)
                        merged += 1
        return merged

    def close_loops_hierarchical(self, segment=250, dist_tol=0.3,
                                 inlier_threshold=1.0, min_inliers=6,
                                 min_pair_sep=2.0, max_pair_sep=40.0,
                                 coarse_iters=100,
                                 odom_info=(0.1, 0.1, 1.0),
                                 closure_info=(25.0, 25.0, 100.0)):
        """Constellation proposal + coarse-to-fine drift absorption.

        `close_loops_constellation` alone leaves the fine landmark graph in
        a kinked local minimum: merging one tree pair across tens of meters
        of drift while the surrounding duplicates stay separate gives LM a
        27 m correction it cannot absorb (measured: chi2 stalls ~10x above
        the reachable basin). This method does what the reference's
        hierarchical layers do (``map_core.h`` MapNodeAlias levels; the
        repo's ``graph/reflector.optimize_hierarchical`` for SE3): every
        accepted constellation match becomes a *segment-level* SE2 closure
        edge; the tiny coarse pose graph (one anchor per segment) is solved
        exactly in float64, each segment is rigidly warped by its anchor's
        correction, landmarks are re-anchored from the corrected poses, and
        only then are the matched landmark pairs merged — handing the fine
        solver an initialization inside the right basin.

        Returns the number of merged landmark pairs (0 = no accepted match).
        """
        from .constellation import (match_constellations,
                                    segment_constellations)
        from ..graph.store import PoseGraph2D
        from ..solvers.control import control_optimize_se2

        segs = segment_constellations(
            self.poses, self.obs_edges, self.lm_alive, segment
        )
        S = len(segs)
        n = len(self.poses)
        if S < 2:
            return 0
        matches = []  # (i, j, T_world, [(lm_a, lm_b)])
        for j in range(S):
            ids_a, pos_a = segs[j]
            if len(ids_a) < min_inliers:
                continue
            for i in range(j):
                ids_b, pos_b = segs[i]
                if len(ids_b) < min_inliers:
                    continue
                m = match_constellations(
                    pos_a, pos_b, dist_tol=dist_tol,
                    inlier_threshold=inlier_threshold,
                    min_inliers=min_inliers, min_pair_sep=min_pair_sep,
                    max_pair_sep=max_pair_sep, seed=i * 10007 + j,
                )
                if not m.ok:
                    continue
                pairs = [
                    (int(ids_a[ia]), int(ids_b[ib])) for ia, ib in m.pairs
                ]
                matches.append((i, j, np.asarray(m.transform, np.float64),
                                pairs))
        new_pairs_total = sum(
            1 for (_, _, _, ps) in matches for (a, b) in ps if a != b
        )
        if new_pairs_total == 0:
            return 0

        # --- coarse segment pose graph (float64 exact solve) -----------
        anchors = [min(s0 * segment, n - 1) for s0 in range(S)]
        X_old = np.asarray([self.poses[a] for a in anchors], np.float64)
        pp_ij, pp_z, pp_w = [], [], []
        w_odo = np.diag(np.asarray(odom_info, np.float64))
        w_cls = np.diag(np.asarray(closure_info, np.float64))
        for s in range(S - 1):
            pp_ij.append((s, s + 1))
            pp_z.append(_se2_rel_np(X_old[s], X_old[s + 1]))
            pp_w.append(w_odo)
        for (i, j, T, _pairs) in matches:
            if i == j:
                continue
            aj_corr = _se2_compose_np(T.astype(np.float32),
                                      X_old[j].astype(np.float32))
            pp_ij.append((i, j))
            pp_z.append(_se2_rel_np(X_old[i], aj_corr.astype(np.float64)))
            pp_w.append(w_cls)
        E = len(pp_ij)
        fixed = np.zeros(S, bool)
        fixed[0] = True
        gc = PoseGraph2D(
            poses=jnp.asarray(X_old, jnp.float32),
            pose_mask=jnp.ones(S, bool),
            landmarks=jnp.zeros((1, 2), jnp.float32),
            landmark_mask=jnp.zeros(1, bool),
            pp_ij=jnp.asarray(np.asarray(pp_ij, np.int32)),
            pp_meas=jnp.asarray(np.asarray(pp_z, np.float32)),
            pp_info=jnp.asarray(np.asarray(pp_w, np.float32)),
            pp_mask=jnp.ones(E, bool),
            pl_ij=jnp.zeros((1, 2), jnp.int32),
            pl_meas=jnp.zeros((1, 2), jnp.float32),
            pl_info=jnp.zeros((1, 2, 2), jnp.float32),
            pl_mask=jnp.zeros(1, bool),
            fixed=jnp.asarray(fixed),
        )
        ctl = control_optimize_se2(gc, max_iters=coarse_iters)
        X_new = np.asarray(ctl["poses"], np.float64)[:S]

        # --- rigid per-segment warp of the level-0 trajectory -----------
        for s in range(S):
            lo = s * segment
            hi = min(lo + segment, n)
            for p in range(lo, hi):
                local = _se2_rel_np(X_old[s], np.asarray(self.poses[p],
                                                         np.float64))
                self.poses[p] = _se2_compose_np(
                    X_new[s].astype(np.float32), local.astype(np.float32)
                )

        # --- re-anchor landmarks from the corrected poses ---------------
        poses_np = np.asarray(self.poses, np.float32)
        acc = np.zeros((len(self.landmarks), 2), np.float64)
        cnt = np.zeros(len(self.landmarks), np.int64)
        for (p, l, z, _w) in self.obs_edges:
            acc[l] += _se2_apply_np(poses_np[p], np.asarray(z, np.float32)[None])[0]
            cnt[l] += 1
        upd = (cnt > 0) & self.lm_alive
        self.landmarks[upd] = (acc[upd] / cnt[upd, None]).astype(np.float32)

        # --- merge the matched landmark pairs ---------------------------
        merged = 0
        for (_i, _j, _T, pairs) in matches:
            for la, lb in pairs:
                if la != lb and self.lm_alive[la] and self.lm_alive[lb]:
                    keep, drop = (lb, la) if lb < la else (la, lb)
                    self._merge_landmarks(keep, drop)
                    merged += 1
        return merged

    def reassociate(self, gate=1.0):
        """EM re-association: re-target each observation edge to the nearest
        alive landmark (within `gate` m) under the current pose estimates,
        killing landmarks left with no observations.

        The expectation step to `optimize()`'s maximization — iterate the
        pair until `moved == 0`. Plays the reference's
        `LandmarkCorrespondenceManager` re-binding role after large loop
        corrections. Returns the number of re-targeted edges.
        """
        poses = np.asarray(self.poses, np.float64)
        alive = np.where(self.lm_alive)[0]
        if len(alive) == 0 or not self.obs_edges:
            return 0
        L = self.landmarks[alive].astype(np.float64)
        E = len(self.obs_edges)
        P = np.fromiter((e[0] for e in self.obs_edges), np.int64, E)
        Z = np.stack([np.asarray(e[2], np.float64) for e in self.obs_edges])
        cur = np.fromiter((e[1] for e in self.obs_edges), np.int64, E)
        c, s = np.cos(poses[P, 2]), np.sin(poses[P, 2])
        W = np.stack(
            [poses[P, 0] + c * Z[:, 0] - s * Z[:, 1],
             poses[P, 1] + s * Z[:, 0] + c * Z[:, 1]], 1
        )
        # chunked NN (E x L distance matrix can be hundreds of MB)
        tgt = np.empty(E, np.int64)
        ok = np.empty(E, bool)
        g2 = gate * gate
        step = max(1, int(4e6 // max(len(L), 1)))
        for a in range(0, E, step):
            b = min(a + step, E)
            d2 = np.sum((W[a:b, None] - L[None]) ** 2, -1)
            j = d2.argmin(1)
            tgt[a:b] = alive[j]
            ok[a:b] = d2[np.arange(b - a), j] < g2
        move = ok & (tgt != cur)
        moved = int(move.sum())
        if moved:
            for k in np.where(move)[0]:
                p, _l, z, w = self.obs_edges[k]
                self.obs_edges[k] = (p, int(tgt[k]), z, w)
        final = np.where(move, tgt, cur)
        counts = np.bincount(final, minlength=len(self.landmarks))
        self.lm_alive[alive[counts[alive] == 0]] = False
        return moved

    def merge_landmarks_mahalanobis(self, chi2_gate=9.21,
                                    prefilter_distance=8.0):
        """Covariance-gated duplicate merge (the principled version of
        ``loopLandmarkMergeDistance``'s Euclidean gate).

        Two landmark estimates are duplicates of one physical landmark when
        their separation is small RELATIVE TO THEIR JOINT UNCERTAINTY:
        ``d2 = diff^T (C_ll + C_mm - C_lm - C_ml)^-1 diff`` tested against a
        chi-square(2) gate (9.21 = 99%). Under drift, duplicates can sit
        meters apart yet be statistically identical (large correlated
        covariance along the drift direction), while genuinely distinct
        trees half a meter apart have tight covariances and survive — the
        failure mode of the Euclidean gate in both directions. Joint
        covariances come from the Schur/Woodbury arrow
        (solvers/schur_pcg.landmark_covariance_se2, the
        ``computeMarginals`` role of the reference's g2o backend).

        Merges are applied best-first with a union guard; callers should
        re-run ``optimize`` + ``reassociate`` afterwards. Returns the number
        of merged pairs.
        """
        from ..solvers.schur_pcg import landmark_covariance_se2

        alive = np.where(self.lm_alive)[0]
        if len(alive) < 2:
            return 0
        g = self.graph()
        cov = landmark_covariance_se2(g)  # (NL_pad, 2, NL_pad, 2)
        P = self.landmarks[alive]
        d2 = np.sum((P[:, None] - P[None, :]) ** 2, -1)
        iu, ju = np.triu_indices(len(alive), k=1)
        near = d2[iu, ju] < prefilter_distance * prefilter_distance
        cand = []
        for a, b in zip(iu[near], ju[near]):
            l, m = int(alive[a]), int(alive[b])
            diff = P[a] - P[b]
            S = cov[l, :, l, :] + cov[m, :, m, :] - cov[l, :, m, :] - (
                cov[m, :, l, :]
            )
            # guard: S must be PD (masked/degenerate landmarks are excluded
            # by alive, but keep the solve safe)
            det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
            if det <= 1e-12 or S[0, 0] <= 0:
                continue
            Sinv = np.array([[S[1, 1], -S[0, 1]], [-S[1, 0], S[0, 0]]]) / det
            m2 = float(diff @ Sinv @ diff)
            if m2 < chi2_gate:
                cand.append((m2, l, m))
        merged = 0
        gone = set()
        for m2, l, m in sorted(cand):
            if l in gone or m in gone:
                continue
            # keep the better-observed landmark
            keep, drop = (l, m) if self.lm_seen[l] >= self.lm_seen[m] else (m, l)
            self._merge_landmarks(keep, drop)
            gone.add(drop)
            merged += 1
        return merged

    def split_inconsistent_landmarks(self, spread_gate=4.0,
                                     cluster_eps=2.5):
        """Split chimera landmarks (wrong merges) back apart.

        A landmark whose own observations, projected through the CURRENT
        pose estimates, form multiple well-separated clusters is a fusion
        of distinct physical landmarks — an earlier wrong merge (measured
        on Victoria: 19 of 188 landmarks, with obs spreads up to 35 m; each
        one poisons every later closure batch that touches it). The split
        re-targets each non-dominant cluster's edges to a fresh landmark —
        the retraction half of the reference's
        ``LandmarkCorrespondenceManager`` merge bookkeeping. Returns the
        number of new landmarks created.
        """
        poses = np.asarray(self.poses, np.float32)
        by_lm: dict[int, list] = {}
        for k, (p, l, z, _w) in enumerate(self.obs_edges):
            if self.lm_alive[l]:
                by_lm.setdefault(int(l), []).append(k)
        created = 0
        for l, idxs in by_lm.items():
            if len(idxs) < 2:
                continue
            pts = np.stack([
                _se2_apply_np(poses[self.obs_edges[k][0]],
                              np.asarray(self.obs_edges[k][2],
                                         np.float32)[None])[0]
                for k in idxs
            ])
            d = np.linalg.norm(pts - pts.mean(0), axis=1)
            if d.max() < spread_gate:
                continue
            # single-linkage clustering at cluster_eps
            m = len(idxs)
            parent = list(range(m))

            def find(a):
                while parent[a] != a:
                    parent[a] = parent[parent[a]]
                    a = parent[a]
                return a

            d2 = np.sum((pts[:, None] - pts[None, :]) ** 2, -1)
            for a in range(m):
                for b in range(a + 1, m):
                    if d2[a, b] < cluster_eps * cluster_eps:
                        ra, rb = find(a), find(b)
                        if ra != rb:
                            parent[rb] = ra
            roots: dict[int, list] = {}
            for a in range(m):
                roots.setdefault(find(a), []).append(a)
            if len(roots) < 2:
                continue
            clusters = sorted(roots.values(), key=len, reverse=True)
            # dominant cluster keeps the landmark; others split off
            self.landmarks[l] = pts[clusters[0]].mean(0)
            self.lm_seen[l] = len(clusters[0])
            for cl in clusters[1:]:
                li = len(self.landmarks)
                self.landmarks = np.vstack(
                    [self.landmarks, pts[cl].mean(0)[None]]
                )
                self.lm_alive = np.append(self.lm_alive, True)
                self.lm_seen = np.append(self.lm_seen, len(cl))
                self.lm_last_seen = np.append(
                    self.lm_last_seen,
                    np.int32(max(self.obs_edges[idxs[a]][0] for a in cl)),
                )
                for a in cl:
                    k = idxs[a]
                    p, _l, z, w = self.obs_edges[k]
                    self.obs_edges[k] = (p, li, z, w)
                created += 1
        return created

    def cull_weak_landmarks(self, min_obs=2):
        """Drop landmarks supported by fewer than `min_obs` observations
        (and their observation edges). Single-observation landmarks are
        either spurious detections or fragments an association failure split
        off an existing landmark — both inflate the landmark count and add
        unconstrained residuals (the reference prunes the same way through
        its correspondence manager's track-length threshold,
        ``feature_tracker.h:340-393``). Returns the number culled."""
        counts = np.zeros(len(self.landmarks), np.int64)
        for (_, l, _, _) in self.obs_edges:
            counts[l] += 1
        weak = {
            l for l in np.where(self.lm_alive)[0] if counts[l] < min_obs
        }
        if not weak:
            return 0
        self.obs_edges = [e for e in self.obs_edges if e[1] not in weak]
        for l in weak:
            self.lm_alive[l] = False
        return len(weak)

    def merge_nearby_landmarks(self, distance=None):
        """Post-optimization duplicate merge (loopLandmarkMergeDistance)."""
        d = distance or self.cfg.loop_landmark_merge_distance
        nl = len(self.landmarks)
        if nl < 2:
            return 0
        alive_idx = np.where(self.lm_alive)[0]
        P = self.landmarks[alive_idx]
        d2 = np.sum((P[:, None] - P[None, :]) ** 2, -1)
        np.fill_diagonal(d2, 1e12)
        merged = 0
        done = set()
        for a in range(len(alive_idx)):
            if a in done:
                continue
            b = int(np.argmin(d2[a]))
            if d2[a, b] < d * d and b not in done:
                self._merge_landmarks(int(alive_idx[a]), int(alive_idx[b]))
                done.add(b)
                merged += 1
        return merged

    def _merge_landmarks(self, keep: int, drop: int):
        for k, (p, l, z, w) in enumerate(self.obs_edges):
            if l == drop:
                self.obs_edges[k] = (p, keep, z, w)
        self.lm_seen[keep] += self.lm_seen[drop]
        if len(self.lm_last_seen) > max(keep, drop):
            self.lm_last_seen[keep] = max(
                self.lm_last_seen[keep], self.lm_last_seen[drop]
            )
        self.lm_alive[drop] = False

    # -- state snapshot / restore (closure-validation rollback) -------------
    def snapshot(self):
        """Copy of the mutable map state, for validated-closure rollback."""
        return (
            [np.asarray(p).copy() for p in self.poses],
            self.landmarks.copy(),
            self.lm_alive.copy(),
            self.lm_seen.copy(),
            list(self.obs_edges),
            self.lm_last_seen.copy(),
        )

    def restore(self, snap):
        (poses, lms, alive, seen, obs, last_seen) = snap
        self.poses = [p.copy() for p in poses]
        self.landmarks = lms.copy()
        self.lm_alive = alive.copy()
        self.lm_seen = seen.copy()
        self.obs_edges = list(obs)
        self.lm_last_seen = last_seen.copy()

    # -- results ------------------------------------------------------------
    def trajectory(self):
        return np.asarray(self.poses)

    def stats(self):
        return {
            "n_poses": len(self.poses),
            "n_landmarks": int(self.lm_alive.sum()),
            "n_obs_edges": len(self.obs_edges),
            "n_odom_edges": len(self.odom_edges),
            "n_pending": len(self.pending),
        }
