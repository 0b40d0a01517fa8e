"""Edge-sharded distributed pose-graph optimization via shard_map.

Distribution model (the device counterpart of the reference's partition
machinery, SURVEY.md §5 "long-context" analog): the edge set is block-
partitioned across a 1-D device mesh; pose/landmark state is replicated.
Every Hessian-vector product and gradient is computed as per-device
`segment_sum` scatters over the local edge block followed by a `psum`. The PCG iteration then proceeds identically (replicated) on all
devices — communication is exactly two f32 all-reduces of size (NP*3 + NL*2)
per CG matvec, the minimum for a row-partitioned sparse matrix with
replicated state.

This scales the dominant cost (per-edge linearization + scatters, O(E)) with
device count while keeping convergence bit-identical to the single-chip
solver (up to reduction order).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..graph.store import PoseGraph2D
from ..solvers import pose_graph as pg
from ..solvers.pcg import pcg
from ..utils import lie
from .mesh import EDGE_AXIS, pad_to_multiple


def _psum_tree(tree):
    return jax.tree_util.tree_map(lambda x: jax.lax.psum(x, EDGE_AXIS), tree)


def optimize_se2_sharded(
    g: PoseGraph2D,
    mesh,
    iters: int = 10,
    cg_iters: int = 100,
    lm_lambda0: float = 1e-4,
):
    """LM-optimize with edges sharded over `mesh`; returns (graph, chi2_trace).

    Works on any mesh size that divides the (padded) edge capacity; tested on
    virtual CPU meshes and on four GPUs (``chip_smoke.py --four-gpus``).
    """
    program, operands = sharded_se2_program(g, mesh, iters, cg_iters,
                                            lm_lambda0)
    poses, lms, trace = program(*operands)
    return g.with_poses(poses, lms), trace


def sharded_se2_program(
    g: PoseGraph2D,
    mesh,
    iters: int = 10,
    cg_iters: int = 100,
    lm_lambda0: float = 1e-4,
):
    """The edge-sharded LM as one jitted program and its operands:
    `program(*operands)` returns (poses, landmarks, chi2_trace)."""
    n_dev = mesh.devices.size
    pp_ij = pad_to_multiple(g.pp_ij, n_dev)
    pp_meas = pad_to_multiple(g.pp_meas, n_dev)
    pp_info = pad_to_multiple(g.pp_info, n_dev)
    pp_mask = pad_to_multiple(g.pp_mask, n_dev)
    pl_ij = pad_to_multiple(g.pl_ij, n_dev)
    pl_meas = pad_to_multiple(g.pl_meas, n_dev)
    pl_info = pad_to_multiple(g.pl_info, n_dev)
    pl_mask = pad_to_multiple(g.pl_mask, n_dev)

    free_p = (g.pose_mask & ~g.fixed).astype(g.poses.dtype)
    free_l = g.landmark_mask.astype(g.poses.dtype)

    edge_spec = P(EDGE_AXIS)
    rep = P()

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            rep,  # poses
            rep,  # landmarks
            edge_spec,
            edge_spec,
            edge_spec,
            edge_spec,  # pp
            edge_spec,
            edge_spec,
            edge_spec,
            edge_spec,  # pl
            rep,
            rep,  # free masks
        ),
        out_specs=(rep, rep, rep),
    )
    def run(
        poses0,
        lms0,
        pp_ij,
        pp_meas,
        pp_info,
        pp_mask,
        pl_ij,
        pl_meas,
        pl_info,
        pl_mask,
        free_p,
        free_l,
    ):
        def local_graph(poses, lms):
            return PoseGraph2D(
                poses=poses,
                pose_mask=g.pose_mask,
                landmarks=lms,
                landmark_mask=g.landmark_mask,
                pp_ij=pp_ij,
                pp_meas=pp_meas,
                pp_info=pp_info,
                pp_mask=pp_mask,
                pl_ij=pl_ij,
                pl_meas=pl_meas,
                pl_info=pl_info,
                pl_mask=pl_mask,
                fixed=g.fixed,
            )

        def chi2_of(poses, lms):
            return jax.lax.psum(pg.linearize_se2(local_graph(poses, lms)).chi2, EDGE_AXIS)

        def step(k, state):
            poses, lms, lam, trace = state
            gk = local_graph(poses, lms)
            lin = pg.linearize_se2(gk)
            chi2 = jax.lax.psum(lin.chi2, EDGE_AXIS)
            gp, gl = _psum_tree(pg._grad_se2(gk, lin))
            Dp, Dl = _psum_tree(pg._diag_blocks_se2(gk, lin))
            local_edge_hvp = pg._hvp_edges_se2(gk, lin)
            # psum only the per-edge term; damping/gauge are replicated.
            sharded_edge_hvp = lambda v: _psum_tree(local_edge_hvp(v))
            hvp = pg._compose_hvp(sharded_edge_hvp, free_p, free_l, lam, Dp, Dl)
            precond = pg._block_jacobi_precond(Dp, Dl, free_p, free_l, lam)
            b = (-gp * free_p[:, None], -gl * free_l[:, None])
            (dp, dl), _, _ = pcg(hvp, b, precond, max_iters=cg_iters, rtol=1e-8)

            new_poses = poses + dp * free_p[:, None]
            new_poses = new_poses.at[:, 2].set(lie.wrap_angle(new_poses[:, 2]))
            new_lms = lms + dl * free_l[:, None]
            new_chi2 = chi2_of(new_poses, new_lms)
            accept = new_chi2 < chi2
            poses = jnp.where(accept, new_poses, poses)
            lms = jnp.where(accept, new_lms, lms)
            lam = jnp.where(
                accept, jnp.maximum(lam * 0.5, 1e-10), jnp.minimum(lam * 4.0, 1e8)
            )
            trace = trace.at[k + 1].set(jnp.where(accept, new_chi2, chi2))
            return poses, lms, lam, trace

        trace0 = jnp.zeros(iters + 1, dtype=poses0.dtype).at[0].set(
            chi2_of(poses0, lms0)
        )
        poses, lms, lam, trace = jax.lax.fori_loop(
            0,
            iters,
            step,
            (poses0, lms0, jnp.asarray(lm_lambda0, poses0.dtype), trace0),
        )
        return poses, lms, trace

    return jax.jit(run), (
        g.poses,
        g.landmarks,
        pp_ij,
        pp_meas,
        pp_info,
        pp_mask,
        pl_ij,
        pl_meas,
        pl_info,
        pl_mask,
        free_p,
        free_l,
    )
