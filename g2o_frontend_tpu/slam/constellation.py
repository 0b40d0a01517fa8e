"""Pose-free landmark constellation matching (loop-closure *proposal*).

The reference separates loop-closure candidate *detection* from verification
(``slam/feature_tracker_closure.h:9-202``: LoopClosureCandidateDetector +
FrameClusterer + LandmarkCorrespondenceManager) and its graph matcher aligns
landmark *patterns* independent of the pose estimate
(``graph_merge/graph_matcher.h:19-66``). The repo's pose-gated NN proposal
cannot see a revisit once odometry drift exceeds the gate — at Victoria
scale (tens of meters of drift) every remaining meter of ATE is an
un-proposed association (EVAL §5 ablation: ground-truth association reaches
ATE ~ 0 through the same solvers).

This module proposes correspondences with NO pose prior at all:

1. hypothesis generation from *pairwise-distance consistency* — a pair of
   landmarks in constellation A whose separation matches a pair in B within
   `dist_tol` votes for the two rigid SE2s aligning them (direct + swapped
   assignment); distances are invariant to the drift between the maps,
2. all K hypotheses are scored in ONE batched device kernel (warp A, NN
   into B, count inliers) — the batched replacement for the reference's
   serial correspondence ranking,
3. the best hypothesis is refined by mutual-NN re-fit rounds and gated on
   inlier count + mean error; survivors return explicit landmark pairs for
   the caller's merge + reassociate + optimize EM loop (verification stays
   where it already lives).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ransac import solvers as rsolvers


def _cap(n: int, minimum: int = 8) -> int:
    c = minimum
    while c < n:
        c *= 2
    return c


@partial(jax.jit, static_argnames=())
def _score_hypotheses(T, A, a_mask, B, b_mask, thr2):
    """Inlier count + mean NN error for K SE2 hypotheses at once.

    T: (K, 3) SE2 charts mapping A into B's frame; A: (NA, 2); B: (NB, 2).
    Returns (counts (K,), mean_err (K,)).
    """
    c, s = jnp.cos(T[:, 2]), jnp.sin(T[:, 2])
    # warp: (K, NA, 2)
    wx = c[:, None] * A[None, :, 0] - s[:, None] * A[None, :, 1] + T[:, None, 0]
    wy = s[:, None] * A[None, :, 0] + c[:, None] * A[None, :, 1] + T[:, None, 1]
    d2 = (wx[:, :, None] - B[None, None, :, 0]) ** 2 + (
        wy[:, :, None] - B[None, None, :, 1]
    ) ** 2
    big = jnp.asarray(1e12, d2.dtype)
    d2 = jnp.where(b_mask[None, None, :], d2, big)
    nn = jnp.min(d2, axis=2)  # (K, NA)
    inl = (nn < thr2) & a_mask[None, :]
    cnt = jnp.sum(inl, axis=1)
    err = jnp.sum(jnp.where(inl, nn, 0.0), axis=1) / jnp.maximum(cnt, 1)
    return cnt, err


@dataclass
class ConstellationMatch:
    transform: np.ndarray  # (3,) SE2 chart mapping A into B's frame
    pairs: list  # [(idx_a, idx_b)] mutual-NN inliers under the transform
    n_inliers: int
    mean_err: float
    ok: bool


def _se2_apply_np(x, pts):
    c, s = np.cos(x[2]), np.sin(x[2])
    R = np.array([[c, -s], [s, c]], np.float64)
    return pts @ R.T + x[:2]


def _mutual_nn_pairs(WA, B, thr):
    """Mutual-NN pairs between warped A and B within `thr` meters."""
    d2 = np.sum((WA[:, None] - B[None, :]) ** 2, -1)
    nn_a = d2.argmin(1)
    nn_b = d2.argmin(0)
    pairs = []
    for ia in range(len(WA)):
        ib = nn_a[ia]
        if nn_b[ib] == ia and d2[ia, ib] < thr * thr:
            pairs.append((ia, int(ib)))
    return pairs


def match_constellations(
    A,
    B,
    *,
    dist_tol: float = 0.3,
    inlier_threshold: float = 1.0,
    min_inliers: int = 6,
    min_pair_sep: float = 2.0,
    max_pair_sep: float = 40.0,
    max_hypotheses: int = 4096,
    trans_gate: float | None = None,
    rot_gate: float | None = None,
    prior: np.ndarray | None = None,
    seed: int = 0,
) -> ConstellationMatch:
    """Rigidly match 2D landmark constellation A onto B with no pose prior.

    A, B: (nA, 2) / (nB, 2) landmark positions, each internally consistent
    (e.g. rebuilt from one trajectory segment's own observations). Returns
    the SE2 aligning A into B's frame plus the mutual-NN correspondence
    pairs, gated on `min_inliers` supporting landmarks.

    `trans_gate` / `rot_gate` optionally bound the hypothesis space around
    the identity: when A and B live in the same (drifted) world frame, the
    true aligning transform is bounded by the odometry drift accumulated
    between the two traversals — a generous drift prior prunes the
    geometrically-plausible-but-impossible alignments that an ambiguous
    (quasi-regular) landmark pattern otherwise produces. Measured on
    Victoria: precision 0.21 ungated, the drift gate is what makes the
    proposal usable.
    """
    A = np.asarray(A, np.float64).reshape(-1, 2)
    B = np.asarray(B, np.float64).reshape(-1, 2)
    nA, nB = len(A), len(B)
    fail = ConstellationMatch(np.zeros(3), [], 0, 0.0, False)
    if nA < min_inliers or nB < min_inliers:
        return fail

    # --- hypothesis generation: distance-consistent pairs (host) ---------
    def _pairs_with_sep(P):
        iu, ju = np.triu_indices(len(P), k=1)
        d = np.linalg.norm(P[iu] - P[ju], axis=1)
        keep = (d > min_pair_sep) & (d < max_pair_sep)
        return iu[keep], ju[keep], d[keep]

    ai, aj, da = _pairs_with_sep(A)
    bi, bj, db = _pairs_with_sep(B)
    if len(da) == 0 or len(db) == 0:
        return fail
    order = np.argsort(db)
    db_s, bi_s, bj_s = db[order], bi[order], bj[order]
    lo = np.searchsorted(db_s, da - dist_tol)
    hi = np.searchsorted(db_s, da + dist_tol)
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return fail
    # flatten (a-pair, b-pair) match list
    a_rep = np.repeat(np.arange(len(da)), counts)
    b_idx = np.concatenate(
        [np.arange(l, h) for l, h in zip(lo, hi) if h > l]
    ) if total else np.zeros(0, np.int64)
    if total > max_hypotheses // 2:
        rng = np.random.default_rng(seed)
        sel = rng.choice(total, max_hypotheses // 2, replace=False)
        a_rep, b_idx = a_rep[sel], b_idx[sel]

    # each distance match -> 2 hypotheses (direct + swapped assignment)
    a1 = np.concatenate([ai[a_rep], ai[a_rep]])
    a2 = np.concatenate([aj[a_rep], aj[a_rep]])
    b1 = np.concatenate([bi_s[b_idx], bj_s[b_idx]])
    b2 = np.concatenate([bj_s[b_idx], bi_s[b_idx]])
    va = A[a2] - A[a1]
    vb = B[b2] - B[b1]
    th = np.arctan2(vb[:, 1], vb[:, 0]) - np.arctan2(va[:, 1], va[:, 0])
    c, s = np.cos(th), np.sin(th)
    tx = B[b1, 0] - (c * A[a1, 0] - s * A[a1, 1])
    ty = B[b1, 1] - (s * A[a1, 0] + c * A[a1, 1])
    T = np.stack([tx, ty, th], 1).astype(np.float32)

    # drift-prior gate on the hypothesis space. `prior` is the expected
    # transform (identity when A and B share a drifted world frame; the
    # predicted robot pose when A is a single frame's robot-frame obs set
    # and B is the map) — the true alignment deviates from it by at most
    # the accumulated odometry drift.
    p = np.zeros(3) if prior is None else np.asarray(prior, np.float64)
    if trans_gate is not None or rot_gate is not None:
        keep = np.ones(len(T), bool)
        if trans_gate is not None:
            keep &= np.hypot(tx - p[0], ty - p[1]) < trans_gate
        if rot_gate is not None:
            dth = (th - p[2] + np.pi) % (2 * np.pi) - np.pi
            keep &= np.abs(dth) < rot_gate
        T = T[keep]
        if len(T) == 0:
            return fail

    # --- batched scoring (device, padded shapes) -------------------------
    K = len(T)
    KC = _cap(K, 64)
    NA, NB = _cap(nA), _cap(nB)
    T_pad = np.zeros((KC, 3), np.float32)
    T_pad[:K] = T
    T_pad[K:, :2] = 1e6  # park padding hypotheses far away
    A_pad = np.zeros((NA, 2), np.float32)
    A_pad[:nA] = A
    B_pad = np.zeros((NB, 2), np.float32)
    B_pad[:nB] = B
    a_mask = np.arange(NA) < nA
    b_mask = np.arange(NB) < nB
    cnt, err = _score_hypotheses(
        jnp.asarray(T_pad),
        jnp.asarray(A_pad),
        jnp.asarray(a_mask),
        jnp.asarray(B_pad),
        jnp.asarray(b_mask),
        np.float32(inlier_threshold**2),
    )
    cnt = np.asarray(cnt)[:K]
    err = np.asarray(err)[:K]
    best = int(np.argmax(cnt.astype(np.float64) - 1e-3 * err / (1.0 + err)))
    if cnt[best] < min_inliers:
        return fail

    # --- refinement: mutual-NN re-fit rounds (host, tiny) ----------------
    Tb = T[best].astype(np.float64)
    pairs = []
    for _ in range(3):
        WA = _se2_apply_np(Tb, A)
        pairs = _mutual_nn_pairs(WA, B, inlier_threshold)
        if len(pairs) < min_inliers:
            return fail
        ia = np.array([p[0] for p in pairs])
        ib = np.array([p[1] for p in pairs])
        w = np.zeros(nA, np.float32)
        w[ia] = 1.0
        tgt = np.zeros((nA, 2), np.float32)
        tgt[ia] = B[ib]
        Tb = np.asarray(
            rsolvers.fit_se2_points(
                jnp.asarray(tgt), jnp.asarray(A, jnp.float32), jnp.asarray(w)
            ),
            np.float64,
        )
    WA = _se2_apply_np(Tb, A)
    pairs = _mutual_nn_pairs(WA, B, inlier_threshold)
    if len(pairs) < min_inliers:
        return fail
    if trans_gate is not None and np.hypot(
        Tb[0] - p[0], Tb[1] - p[1]
    ) > trans_gate:
        return fail
    if rot_gate is not None and abs(
        (Tb[2] - p[2] + np.pi) % (2 * np.pi) - np.pi
    ) > rot_gate:
        return fail
    resid = [float(np.sum((WA[ia] - B[ib]) ** 2)) for ia, ib in pairs]
    return ConstellationMatch(
        transform=Tb.astype(np.float32),
        pairs=pairs,
        n_inliers=len(pairs),
        mean_err=float(np.mean(resid)),
        ok=True,
    )


def segment_constellations(poses, obs_edges, lm_alive, segment: int):
    """Per-segment landmark constellations rebuilt from the segment's OWN
    observations (FrameClusterer role, ``feature_tracker_closure.h:105``).

    Each landmark's position inside a segment is the mean of pose ⊕ z over
    that segment's observation edges — locally rigid under drift because a
    `segment`-pose stretch accumulates little relative error even when the
    global estimate is tens of meters off.

    Returns [(lm_ids (M,), positions (M, 2))] per segment (possibly empty).
    """
    poses = np.asarray(poses, np.float64)
    n = len(poses)
    out = []
    for s0 in range(0, n, segment):
        s1 = min(s0 + segment, n)
        acc: dict[int, list] = {}
        for (p, l, z, _w) in obs_edges:
            if s0 <= p < s1 and lm_alive[l]:
                acc.setdefault(int(l), []).append(
                    _se2_apply_np(poses[p], np.asarray(z, np.float64)[None])[0]
                )
        if acc:
            ids = np.array(sorted(acc), np.int64)
            pos = np.stack([np.mean(acc[int(l)], 0) for l in ids])
            out.append((ids, pos))
        else:
            out.append((np.zeros(0, np.int64), np.zeros((0, 2))))
    return out
