"""Padded cell-major particle storage.

Every hot interaction in PSE (near-field pair sums, NUFFT spread/contract)
runs on a *dense, regular* representation: particles binned into a
fractional-space cell grid, each cell padded to a fixed capacity.  Cell
neighborhoods become 3-D rolls of small arrays or contiguous rank windows;
pair interactions become batched matrix blocks or matrix-free kernel tiles;
the only irregular memory ops left are O(N) permutation scatters/gathers at
step boundaries.

Binning is done in fractional coordinates, so the cell grid stays regular
under box tilt (the physics uses true minimum-image distances, computed
component-wise from the raw deltas).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from .box import Box, make_fraction


class BinSpec(NamedTuple):
    """Static binning configuration (hashable, baked into jit)."""

    n_cells: tuple      # (ncx, ncy, ncz)
    cap: int            # padded slots per cell

    @property
    def n_cells_total(self) -> int:
        ncx, ncy, ncz = self.n_cells
        return ncx * ncy * ncz


class CellBins(NamedTuple):
    """Particles in padded cell-major layout.

    All (C, cap) arrays are cell-flat: C = ncx*ncy*ncz with z fastest.
    Padded slots have mask 0, pid == N, and positions 0 (callers fold the
    mask into interaction coefficients, so padded values are never read
    meaningfully)."""

    px: jax.Array       # (C, cap) f32 absolute positions
    py: jax.Array
    pz: jax.Array
    mask: jax.Array     # (C, cap) f32 — 1 valid / 0 pad
    pid: jax.Array      # (C, cap) i32 — original particle index, N for pad
    cell_of: jax.Array  # (N,) i32 — flat cell of each particle
    rank_of: jax.Array  # (N,) i32 — slot within the cell (may exceed cap-1
                        #            only when overflow is set)
    overflow: jax.Array  # () bool


def _invert_perm_payload(order: jax.Array, payload: jax.Array) -> jax.Array:
    """out[order[i]] = payload[i] — inverse permutation via one keyed sort
    (deterministic, no scatter)."""
    return jax.lax.sort((order, payload), num_keys=1)[1]


def _scatter_fields(pos_sorted, order, sorted_cid, rank_clip, c_total, cap):
    """All padded per-slot fields in ONE windowed scatter: (px, py, pz,
    pid) scatter together as a 4-wide column window into a (4, C·cap)
    target; mask and the int pid are derived from the pid lane (exact as
    f32 for N < 2²⁴)."""
    n = order.shape[0]
    assert n < (1 << 24), "pid-as-f32 scatter packing requires N < 2^24"
    dtype = pos_sorted.dtype
    slot = sorted_cid * cap + rank_clip
    vals = jnp.stack(
        [pos_sorted[:, 0], pos_sorted[:, 1], pos_sorted[:, 2],
         order.astype(dtype)],
        axis=0,
    )                                                   # (4, N)
    init = jnp.concatenate(
        [jnp.zeros((3, c_total * cap), dtype),
         jnp.full((1, c_total * cap), n, dtype)]
    )
    out = init.at[:, slot].set(vals, mode="drop")       # one scatter
    px = out[0].reshape(c_total, cap)
    py = out[1].reshape(c_total, cap)
    pz = out[2].reshape(c_total, cap)
    pidf = out[3].reshape(c_total, cap)
    mask = jnp.where(pidf < n, jnp.ones((), dtype), jnp.zeros((), dtype))
    return px, py, pz, mask, pidf.astype(jnp.int32)


def _scatter_values(vals_t, sorted_cid, rank_clip, c_total, cap):
    """(3, N) cid-sorted values -> (3, C, cap) (same placement as
    vec_to_cells)."""
    slot = sorted_cid * cap + rank_clip
    out = jnp.zeros((3, c_total * cap), vals_t.dtype)
    out = out.at[:, slot].set(vals_t, mode="drop")
    return out.reshape(3, c_total, cap)


def _cell_ranks(sorted_cid, cap):
    """Within-cell ranks of the cid-sorted array (rank_of payloads) and the
    capacity overflow flag."""
    n = sorted_cid.shape[0]
    arange = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_cid[1:] != sorted_cid[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(is_start, arange, 0))
    rank_sorted = arange - seg_start
    overflow = (rank_sorted >= cap).any()
    return rank_sorted, overflow


def choose_cap(mean_occupancy: float, multiple: int = 8, slack_sigmas: float = 5.0) -> int:
    """Capacity covering Poisson occupancy tails, rounded to a tile multiple."""
    mu = max(mean_occupancy, 1e-3)
    cap = mu + slack_sigmas * math.sqrt(mu) + 4.0
    return int(math.ceil(cap / multiple)) * multiple


@partial(jax.jit, static_argnames=("spec",))
def bin_particles(pos: jax.Array, box: Box, spec: BinSpec,
                  values: jax.Array | None = None):
    """Bin particles into (C, cap) slot layout.

    ``values``: optional (N, 3) per-particle values (the step's forces) to
    carry through the SAME binning — they ride the rank sort as payloads,
    so the slot-layout force array needs no separate vec_to_cells.
    Returns (bins, (3, C, cap) values) when given.
    """
    n = pos.shape[0]
    ncx, ncy, ncz = spec.n_cells
    cap = spec.cap
    c_total = spec.n_cells_total

    frac = make_fraction(box, pos)
    frac = frac - jnp.floor(frac)
    nc = jnp.array([ncx, ncy, ncz], dtype=pos.dtype)
    cxyz = jnp.clip(
        jnp.floor(frac * nc).astype(jnp.int32),
        0,
        jnp.array([ncx - 1, ncy - 1, ncz - 1], jnp.int32),
    )
    cid = (cxyz[:, 0] * ncy + cxyz[:, 1]) * ncz + cxyz[:, 2]

    # Rank within cell via sort + segment offsets (deterministic: arange is
    # the tie-break key).  Positions ride the sort as payloads instead of a
    # separate pos[order]/cid[order] gather.
    arange = jnp.arange(n, dtype=jnp.int32)
    payloads = (cid, arange, pos[:, 0], pos[:, 1], pos[:, 2])
    if values is not None:
        payloads += (values[:, 0], values[:, 1], values[:, 2])
    sorted_all = jax.lax.sort(payloads, num_keys=2)
    sorted_cid, order, sx, sy, sz = sorted_all[:5]
    vals_t = jnp.stack(sorted_all[5:8], axis=0) if values is not None else None
    rank_sorted, overflow = _cell_ranks(sorted_cid, cap)
    rank_clip = jnp.minimum(rank_sorted, cap - 1)
    rank_of = _invert_perm_payload(order, rank_sorted)

    px, py, pz, mask, pid = _scatter_fields(
        jnp.stack([sx, sy, sz], axis=1), order, sorted_cid, rank_clip,
        c_total, cap,
    )
    fcells = (_scatter_values(vals_t, sorted_cid, rank_clip, c_total, cap)
              if values is not None else None)

    bins = CellBins(
        px=px, py=py, pz=pz, mask=mask, pid=pid,
        cell_of=cid, rank_of=rank_of, overflow=overflow,
    )
    return bins if values is None else (bins, fcells)


@partial(jax.jit, static_argnames=("spec",))
def bin_columns(pos: jax.Array, box: Box, spec: BinSpec,
                values: jax.Array | None = None):
    """Bin into (x, y) columns and sort by z WITHIN each column.

    ``values``: optional (N, 3) per-particle values carried through the
    same binning (see bin_particles) — returns (bins, (3, C, cap) values).

    Same padded layout/contract as ``bin_particles`` but with
    ``spec.n_cells = (ncx, ncy, 1)`` and slots ordered by ascending z inside
    every column — the layout the banded near-field engine
    (ops/banded_nearfield.py) needs: for a z-sorted column, the particles
    within ``rcut`` of a slot form a contiguous rank band, so the mobility
    blocks can store only that band instead of dense (cap x cap) tiles.

    Padded slots sort last (z key = +inf) and have mask 0 / pid N / pos 0.

    Stored positions are CANONICALIZED: each particle's binning image
    (kx·a1 + ky·a2 + kz·a3 lattice vectors) is subtracted, so every stored
    coordinate lies in the primary tilted cell and agrees with its column
    index.  The banded kernels' scalar-shift minimum image (no per-pair
    rounds) and the z-sorted band contract both rely on this; callers may
    pass positions that are wrapped only approximately (or not at all).
    """
    n = pos.shape[0]
    ncx, ncy, ncz = spec.n_cells
    assert ncz == 1, "bin_columns bins in (x, y) only"
    cap = spec.cap
    c_total = ncx * ncy

    L = box.L
    frac = make_fraction(box, pos)
    k = jnp.floor(frac)
    frac = frac - k
    x_c = pos[:, 0] - k[:, 0] * L[0] - k[:, 1] * box.tilt_xy * L[1]
    y_c = pos[:, 1] - k[:, 1] * L[1]
    z_c = pos[:, 2] - k[:, 2] * L[2]
    cx = jnp.clip((frac[:, 0] * ncx).astype(jnp.int32), 0, ncx - 1)
    cy = jnp.clip((frac[:, 1] * ncy).astype(jnp.int32), 0, ncy - 1)
    cid = cx * ncy + cy

    # Lexicographic sort by (column, z, id): deterministic three-key device
    # sort; x/y positions ride as payloads (see bin_particles).
    arange = jnp.arange(n, dtype=jnp.int32)
    payloads = (cid, z_c, arange, x_c, y_c)
    if values is not None:
        payloads += (values[:, 0], values[:, 1], values[:, 2])
    sorted_all = jax.lax.sort(payloads, num_keys=3)
    sorted_cid, sz, order, sx, sy = sorted_all[:5]
    vals_t = jnp.stack(sorted_all[5:8], axis=0) if values is not None else None
    rank_sorted, overflow = _cell_ranks(sorted_cid, cap)
    rank_clip = jnp.minimum(rank_sorted, cap - 1)
    rank_of = _invert_perm_payload(order, rank_sorted)

    px, py, pz, mask, pid = _scatter_fields(
        jnp.stack([sx, sy, sz], axis=1), order, sorted_cid, rank_clip,
        c_total, cap,
    )
    fcells = (_scatter_values(vals_t, sorted_cid, rank_clip, c_total, cap)
              if values is not None else None)

    bins = CellBins(
        px=px, py=py, pz=pz, mask=mask, pid=pid,
        cell_of=cid, rank_of=rank_of, overflow=overflow,
    )
    return bins if values is None else (bins, fcells)


def to_cells(bins: CellBins, spec: BinSpec, values: jax.Array, fill=0.0) -> jax.Array:
    """Scatter per-particle values (N,) into (C, cap) cell layout."""
    out = jnp.full((spec.n_cells_total, spec.cap), fill, values.dtype)
    return out.at[bins.cell_of, jnp.minimum(bins.rank_of, spec.cap - 1)].set(
        values, mode="drop"
    )


def from_cells(bins: CellBins, spec: BinSpec, cell_values: jax.Array) -> jax.Array:
    """Gather per-particle values (N,) back from (C, cap) cell layout."""
    return cell_values[bins.cell_of, jnp.minimum(bins.rank_of, spec.cap - 1)]


def vec_to_cells(bins: CellBins, spec: BinSpec, values: jax.Array) -> jax.Array:
    """(N, 3) particle vectors -> (3, C, cap) in ONE scatter (the per-
    component version costs 3 serialized scatters)."""
    slot = bins.cell_of * spec.cap + jnp.minimum(bins.rank_of, spec.cap - 1)
    flat = jnp.zeros((spec.n_cells_total * spec.cap, 3), values.dtype)
    flat = flat.at[slot].set(values, mode="drop")
    return flat.T.reshape(3, spec.n_cells_total, spec.cap)


def vec_from_cells(bins: CellBins, spec: BinSpec, cells: jax.Array) -> jax.Array:
    """(3, C, cap) -> (N, 3) in one gather."""
    slot = bins.cell_of * spec.cap + jnp.minimum(bins.rank_of, spec.cap - 1)
    flat = cells.reshape(3, -1).T                  # (C*cap, 3)
    return flat[slot]


def roll_cells(arr: jax.Array, spec: BinSpec, offset) -> jax.Array:
    """View of ``arr`` (C, ...) where flat-cell c holds the data of cell
    c + offset (periodic).  offset = (ox, oy, oz)."""
    ncx, ncy, ncz = spec.n_cells
    a = arr.reshape((ncx, ncy, ncz) + arr.shape[1:])
    a = jnp.roll(a, (-offset[0], -offset[1], -offset[2]), axis=(0, 1, 2))
    return a.reshape(arr.shape)


def half_space_offsets(reach: int = 1):
    """(0,0,0) plus the lexicographically-positive half of the stencil.

    Pair blocks for -o are transposes of those for +o, so only half are
    built; the matvec applies each block in both directions.
    """
    offs = [(0, 0, 0)]
    rng = range(-reach, reach + 1)
    for ox in rng:
        for oy in rng:
            for oz in rng:
                if (ox, oy, oz) > (0, 0, 0):
                    offs.append((ox, oy, oz))
    return tuple(offs)


def full_offsets(reach: int = 1):
    rng = range(-reach, reach + 1)
    return tuple((ox, oy, oz) for ox in rng for oy in rng for oz in rng)
