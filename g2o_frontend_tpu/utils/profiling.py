"""Tracing and on-device timing utilities.

The reference's observability is ad-hoc wall-clock brackets
(``pwn_core/aligner.cpp:56-57,120-123``, ``pwn_matcher_base.h:54-55``
cumTime/numCalls). The device equivalents here:

- `device_time`: honest per-call device time of a jittable function. Timing
  individual small dispatches is dominated by dispatch latency, so the
  function is run inside an on-device
  ``lax.fori_loop`` with (a) a loop-carried 1e-30 data dependence into the
  first input so XLA cannot hoist the body, (b) a reduction over every
  output leaf so dead-code elimination cannot shrink the computation, and
  (c) two loop sizes timed so the slope cancels dispatch latency exactly.
- `trace`: context manager around ``jax.profiler`` emitting a TensorBoard
  trace directory.
- `CumulativeTimer`: cumTime/numCalls accumulator (PwnMatcherBase parity).
"""
from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["device_time", "trace", "CumulativeTimer"]


def device_time(f, inputs, n: int = 20, reps: int = 3) -> float:
    """Mean seconds per call of ``f(*inputs)`` measured inside device loops.

    The first input must be a float array (the loop-carried dependence is
    threaded into it). Returns the slope between an n-iteration and an
    n//4-iteration loop — pure device time, dispatch latency cancelled.
    """
    inputs = [jax.device_put(x) for x in inputs]
    n_small = max(n // 4, 1)

    def _loop(k):
        @jax.jit
        def run(first, *rest):
            def body(i, carry):
                out = f(first + (1e-30 * carry).astype(first.dtype), *rest)
                return carry + sum(
                    jnp.sum(l).astype(jnp.float32)
                    for l in jax.tree_util.tree_leaves(out)
                )

            return jax.lax.fori_loop(0, k, body, jnp.float32(0))

        return run

    big, small = _loop(n), _loop(n_small)
    np.asarray(big(*inputs))  # compile + execute once
    np.asarray(small(*inputs))
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(small(*inputs))
        t1 = time.perf_counter()
        np.asarray(big(*inputs))
        t2 = time.perf_counter()
        best = min(best, ((t2 - t1) - (t1 - t0)) / (n - n_small))
    return best


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/tb'):`` — profile the block into a TensorBoard dir."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class CumulativeTimer:
    """cumTime/numCalls accumulator (``pwn_matcher_base.h:54-55``)."""

    def __init__(self):
        self.cum_time = 0.0
        self.num_calls = 0

    @contextlib.contextmanager
    def __call__(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.cum_time += time.perf_counter() - t0
            self.num_calls += 1

    @property
    def mean(self) -> float:
        return self.cum_time / self.num_calls if self.num_calls else 0.0
