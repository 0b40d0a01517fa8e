"""g2o_frontend_tpu — a SLAM/SfM engine in JAX.

A from-scratch re-design of the capability surface of grisetti/g2o_frontend
(sensor ingestion, 2D laser SLAM, PWN RGB-D dense registration, RANSAC data
association, plane/line landmarks, loop closing, pose-graph / BA backend) as an
idiomatic JAX/XLA/Pallas framework:

- immutable struct-of-arrays state, pure jitted kernels,
- `vmap` over edges/correspondences/hypotheses instead of OpenMP loops,
- matrix-free block-preconditioned CG instead of CHOLMOD,
- `shard_map` over device meshes instead of single-process execution.

Subpackages
-----------
utils     Lie-group math (SE2/SE3), config registry, timing.
io        .g2o log reader/writer, boss-style JSON logs, TUM trajectories.
graph     Flat-array pose-graph / landmark store (MapManager analog).
solvers   Batched GN/LM, matrix-free PCG, Schur complement.
ops       Pallas/XLA compute kernels (integral images, eigh3x3, z-buffer, ...).
pwn       Point-with-normal RGB-D registration (pwn_core analog).
ransac    Vectorized generalized RANSAC with minimal-set solvers.
laser     2D line extraction and correlative scan matching.
slam      Trackers, loop closers, map management.
parallel  Mesh / sharding helpers for multi-chip execution.
"""

__version__ = "0.1.0"
