"""O(boundary) ghost halo exchange for block-partitioned pose graphs.

The round-2 partitioned solver read ghosts from an ``all_gather`` of the
FULL pose field and pushed ghost contributions back through a FULL-field
``psum`` — per-device communication O(N) and *growing* with mesh size
(EVAL r2 §7: 127 KB -> 223 KB/matvec from 2 -> 8 devices). This module
replaces both directions with point-to-point ``ppermute`` rounds that move
ONLY the boundary pose blocks the ghost directory names — the structural
analog of the reference partitioner's boundary-gauge handling
(``boss_map/map_utils.cpp:167`` makePartitions + the per-partition gauge
nodes), done as a static exchange schedule compiled into the XLA program:
point-to-point transfers instead of ring all-reduces.

Schedule construction (host side, once per partition):
  ghost g of shard s owned by shard t  ->  ring shift k = (s - t) mod D.
  For every active shift k, each owner packs the pose blocks its (t+k)-th
  neighbor needs into a dense buffer (padded to the max count over owners
  for that shift) and one ``ppermute`` moves all of them in parallel. The
  reverse direction (scatter-reducing ghost Hessian/gradient contributions
  back to their owners) runs the same schedule backwards.

Per-matvec bytes per device = sum_k S_k * d * 4 per direction — O(ghosts),
independent of N, and *shrinking* as D grows at fixed N (each device owns
fewer edges, hence fewer loop-closure ghosts). No O(N) transient buffers.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class HaloSpec(NamedTuple):
    """Static exchange schedule. Arrays lead with the device axis D so they
    shard with the rest of the problem; everything else is static python
    metadata baked into the compiled program.

    Two wire modes, chosen at build time from the schedule's shape:
      "ppermute": one point-to-point round per active ring shift — minimal
        bytes (sum_k S_k), best when ghosts touch few neighbor blocks
        (odometry chains: a single shift).
      "a2a": ONE fused ``all_to_all`` per direction regardless of partner
        count — collective count stays constant as the partner set grows
        (loop-closure-rich graphs), at the cost of padding every partner
        lane to the max pairwise count.
    """

    mode: str  # "ppermute" | "a2a"
    shifts: tuple  # ppermute: (K,) active ring shifts, each in [1, D)
    sizes: tuple  # ppermute: per-shift max slot count over devices
    pair_size: int  # a2a: max slots exchanged by any (src, dst) pair
    send_idx: np.ndarray  # ppermute (D, K, Smax) / a2a (D, D, S); pad 0
    recv_pos: np.ndarray  # same shape; ghost slots to fill, pad G = dropped
    n_ghost: int  # G: ghost-slot capacity per device
    n_dev: int


def build_halo_spec(ghosts: list, B: int, n_dev: int, G: int,
                    mode: str = "auto", owner=None, local=None) -> HaloSpec:
    """Build the schedule from per-shard sorted ghost-id lists.

    Args:
      ghosts: ghosts[s] = sorted global ids shard s reads but does not own
        (the ghost directory; ghost slot r on s holds ghosts[s][r]).
      B: block size (owner of id p is p // B) — ignored when owner/local
        lookup arrays are given (arbitrary ownership, e.g. landmarks
        assigned to the pose block that observes them most).
      G: padded ghost capacity per device (recv positions use G as "drop").
      mode: "ppermute", "a2a", or "auto" (ppermute while the active-shift
        count stays small, a2a beyond that).
      owner/local: optional arrays mapping global id -> owning device /
        owner-local slot.
    """
    if owner is None:
        owner = lambda gid: gid // B  # noqa: E731
        local = lambda gid: gid % B  # noqa: E731
    else:
        _own, _loc = owner, local
        owner = lambda gid: int(_own[gid])  # noqa: E731
        local = lambda gid: int(_loc[gid])  # noqa: E731
    # (shift k) -> (sender t) -> ordered [(t-local idx, ghost slot on s)]
    by_shift: dict = {}
    for s in range(n_dev):
        for pos, gid in enumerate(ghosts[s]):
            t = owner(gid)
            assert t != s, (s, gid)
            k = (s - t) % n_dev
            by_shift.setdefault(k, {}).setdefault(t, []).append(
                (local(gid), pos)
            )
    shifts = tuple(sorted(by_shift))
    sizes = tuple(
        max(len(v) for v in by_shift[k].values()) for k in shifts
    )
    if mode == "auto":
        # a2a cuts the collective count to 1 regardless of partner count,
        # at the cost of padding every partner lane to the max pairwise
        # count. Measured on virtual CPU meshes only
        # (scripts/bench_halo_modes.py, victoriaPark partitions): a2a won
        # 12-15% wall per matvec at D=4/8 even carrying 1.3-1.4x the wire
        # bytes — launch count dominated at these O(KB) payloads. Prefer
        # a2a whenever >2 shifts are active, unless its lane padding would
        # more than double the bytes. NVLink cards should re-decide this.
        pair = max(
            (len(e) for k in by_shift for e in by_shift[k].values()),
            default=1,
        )
        a2a_slots = (n_dev - 1) * pair
        mode = (
            "a2a"
            if len(shifts) > 2 and a2a_slots <= 2.0 * sum(sizes)
            else "ppermute"
        )

    if mode == "ppermute":
        Smax = max(sizes, default=1)
        K = max(len(shifts), 1)
        send_idx = np.zeros((n_dev, K, Smax), np.int32)
        recv_pos = np.full((n_dev, K, Smax), G, np.int32)
        for i, k in enumerate(shifts):
            for t, entries in by_shift[k].items():
                s = (t + k) % n_dev
                for j, (loc, pos) in enumerate(entries):
                    send_idx[t, i, j] = loc
                    recv_pos[s, i, j] = pos
        return HaloSpec(mode, shifts, sizes, 0, send_idx, recv_pos, G, n_dev)

    # a2a: lane [t, u] on device t holds what t sends to u
    S = 1
    for k in by_shift:
        for entries in by_shift[k].values():
            S = max(S, len(entries))
    send_idx = np.zeros((n_dev, n_dev, S), np.int32)
    recv_pos = np.full((n_dev, n_dev, S), G, np.int32)
    for k in shifts:
        for t, entries in by_shift[k].items():
            s = (t + k) % n_dev
            for j, (loc, pos) in enumerate(entries):
                send_idx[t, s, j] = loc
                recv_pos[s, t, j] = pos
    return HaloSpec(mode, shifts, sizes, S, send_idx, recv_pos, G, n_dev)


def halo_bytes_per_exchange(spec: HaloSpec, d: int, itemsize: int = 4) -> int:
    """Worst-case per-device bytes sent for ONE direction of the exchange."""
    if spec.mode == "a2a":
        # the self-lane [t, t] never leaves the device
        return int((spec.n_dev - 1) * spec.pair_size * d * itemsize)
    return int(sum(spec.sizes) * d * itemsize)


def halo_collectives_per_exchange(spec: HaloSpec) -> int:
    """Collective launches for ONE direction of the exchange."""
    if spec.mode == "a2a":
        return 1 if spec.n_dev > 1 else 0
    return len(spec.shifts)


# ---------------------------------------------------------------------------
# device-side exchange (call inside shard_map; send_idx/recv_pos are the
# per-device rows of THIS device)
# ---------------------------------------------------------------------------


def halo_gather(v_blk, send_idx, recv_pos, spec: HaloSpec, axis: str):
    """(B, ...) own block -> (G, ...) ghost values.

    Unfilled ghost slots (padding beyond a device's true ghost count) come
    back zero; edges referencing them are masked out upstream.
    """
    G = spec.n_ghost
    out = jnp.zeros((G + 1,) + v_blk.shape[1:], v_blk.dtype)
    if spec.mode == "a2a":
        if spec.n_dev > 1:
            buf = v_blk[send_idx]  # (D, S, ...)
            rec = jax.lax.all_to_all(buf, axis, split_axis=0, concat_axis=0)
            out = out.at[recv_pos.reshape(-1)].set(
                rec.reshape((-1,) + rec.shape[2:])
            )
        return out[:G]
    for i, k in enumerate(spec.shifts):
        S = spec.sizes[i]
        buf = v_blk[send_idx[i, :S]]
        perm = [(t, (t + k) % spec.n_dev) for t in range(spec.n_dev)]
        rec = jax.lax.ppermute(buf, axis, perm)
        out = out.at[recv_pos[i, :S]].set(rec)
    return out[:G]


def halo_reduce(own, ghost_contrib, send_idx, recv_pos, spec: HaloSpec,
                axis: str):
    """Reverse exchange: (G, ...) ghost contributions -> scatter-added into
    their owners' (B, ...) blocks. Returns the updated own block."""
    pad = jnp.zeros((1,) + ghost_contrib.shape[1:], ghost_contrib.dtype)
    ext = jnp.concatenate([ghost_contrib, pad])
    if spec.mode == "a2a":
        if spec.n_dev > 1:
            buf = ext[recv_pos]  # (D, S, ...); padded slots pick the zero row
            rec = jax.lax.all_to_all(buf, axis, split_axis=0, concat_axis=0)
            own = own.at[send_idx.reshape(-1)].add(
                rec.reshape((-1,) + rec.shape[2:])
            )
        return own
    for i, k in enumerate(spec.shifts):
        S = spec.sizes[i]
        buf = ext[recv_pos[i, :S]]  # padded slots pick the zero row
        perm = [((t + k) % spec.n_dev, t) for t in range(spec.n_dev)]
        rec = jax.lax.ppermute(buf, axis, perm)
        own = own.at[send_idx[i, :S]].add(rec)
    return own
