"""Matrix-free preconditioned conjugate gradient over pytree block vectors.

This is the device-side replacement for the reference's external sparse
Cholesky backend (g2o + CHOLMOD/CSparse, reference ``CMakeLists.txt:105-112``,
used through ``boss_map_building/map_g2o_reflector.h:50-74``): instead of
factorizing a sparse Hessian on the host, we never materialize H — the solver
only needs `H @ v` products, which are computed as batched per-edge
contributions with `segment_sum` scatters, and a block-Jacobi preconditioner.
Everything is fixed-shape and runs under `jit`.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp


def _tree_dot(a, b):
    leaves = jax.tree_util.tree_map(lambda x, y: jnp.vdot(x, y), a, b)
    return jax.tree_util.tree_reduce(jnp.add, leaves)


def _tree_axpy(alpha, x, y):
    """alpha * x + y"""
    return jax.tree_util.tree_map(lambda xl, yl: alpha * xl + yl, x, y)


def _tree_scale(alpha, x):
    return jax.tree_util.tree_map(lambda xl: alpha * xl, x)


def pcg(
    hvp: Callable,
    b,
    precond: Callable,
    *,
    max_iters: int = 100,
    rtol: float = 1e-6,
    tree_dot: Callable | None = None,
):
    """Solve ``H x = b`` with preconditioned CG.

    Args:
      hvp: function v -> H @ v on the block-vector pytree.
      b: right-hand side pytree.
      precond: function r -> M^{-1} r (e.g. block-Jacobi).
      max_iters: fixed trip count (static for jit); early exit via while_loop.
      rtol: relative residual tolerance on sqrt(r.z).
      tree_dot: optional replacement inner product — a distributed solver
        passes a psum-reducing dot over sharded block vectors
        (parallel/partitioned_pose_graph.py).

    Returns:
      (x, iters, final_rz)
    """
    if tree_dot is None:
        tree_dot = _tree_dot
    x0 = jax.tree_util.tree_map(jnp.zeros_like, b)
    r0 = b  # r = b - H x0 with x0 = 0
    z0 = precond(r0)
    p0 = z0
    rz0 = tree_dot(r0, z0)
    tol2 = rtol * rtol * jnp.maximum(rz0, 1e-30)

    def cond(state):
        k, _, _, _, rz = state
        return jnp.logical_and(k < max_iters, rz > tol2)

    def body(state):
        k, x, r, p, rz = state
        hp = hvp(p)
        php = tree_dot(p, hp)
        alpha = rz / jnp.where(php > 0, php, 1e-30)
        # Guard against a non-PD direction (should not happen with LM damping).
        alpha = jnp.where(php > 0, alpha, 0.0)
        x = _tree_axpy(alpha, p, x)
        r = _tree_axpy(-alpha, hp, r)
        z = precond(r)
        rz_new = tree_dot(r, z)
        beta = rz_new / jnp.where(rz > 0, rz, 1e-30)
        p = _tree_axpy(beta, p, z)
        return k + 1, x, r, p, rz_new

    k, x, r, p, rz = jax.lax.while_loop(cond, body, (0, x0, r0, p0, rz0))
    return x, k, rz


@partial(jax.jit, static_argnums=(0,))
def _noop(f):  # pragma: no cover
    return f
