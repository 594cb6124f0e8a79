"""Cell-list neighbor search with fixed-capacity (static-shape) arrays.

Replaces HOOMD's CellListGPU + NeighborListGPUBinned (reference
integrate.py:58-82, rebuilt every step via ``setEvery(1, True)``).  The
design is the standard JAX static-shape pattern:

  * particles are binned into cells of side >= rcut (conservatively shrunk by
    the maximum xy tilt so the fractional-space stencil still covers rcut),
  * each cell stores up to ``cell_capacity`` occupants,
  * per particle, the 27 surrounding cells provide a candidate set which is
    distance-filtered and compacted into an (N, max_neighbors) index array
    padded with the sentinel ``N``.

Capacity overflow is reported via boolean flags so the host can rebuild with
larger capacities (jax-md-style two-phase allocate/reuse).  For boxes too
small to fit a 3x3x3 stencil the implementation falls back to dense all-pairs
candidates, which is also the fast path for small N.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .box import Box, make_fraction, min_image_components


class NeighborSpec(NamedTuple):
    """Static neighbor-search configuration (hashable, baked into jit)."""

    rcut: float
    n_cells: tuple          # (ncx, ncy, ncz); (1,1,1) => all-pairs mode
    cell_capacity: int
    max_neighbors: int
    # Cells per rcut: 1 = classic 27-stencil of rcut-sized cells; k > 1 =
    # cells of side >= rcut/k searched with a (2k+1)^3 stencil — the
    # analogue of the reference's CellListStencil backend
    # (integrate.py:69-74): tighter candidate sets (the stencil volume
    # over-covers the rcut sphere ~6.4x at k=1 but ~3.7x at k=2) at the
    # cost of more gather descriptors per particle.
    subdiv: int = 1

    @property
    def all_pairs(self) -> bool:
        return self.n_cells == (1, 1, 1)


class NeighborList(NamedTuple):
    """Fixed-shape neighbor list; ``idx[i, :]`` are neighbor particle ids of
    particle i, padded with N (the sentinel)."""

    idx: jax.Array          # (N, max_neighbors) int32
    overflow: jax.Array     # bool — any capacity exceeded; rebuild bigger


def _cell_dims(L, rcut: float, max_tilt: float, subdiv: int = 1):
    """Cells per axis so a (2·subdiv+1)-wide stencil covers rcut in the
    tilted box (cell side >= rcut/subdiv per axis).

    In fractional coordinates the x-extent of a physical displacement with
    |dx|,|dy| <= rcut is up to rcut*(1+|tilt|)/Lx, so the x-cells are sized
    conservatively by that factor.
    """
    ncx = int(math.floor(L[0] * subdiv / (rcut * (1.0 + abs(max_tilt)))))
    ncy = int(math.floor(L[1] * subdiv / rcut))
    ncz = int(math.floor(L[2] * subdiv / rcut))
    return ncx, ncy, ncz


def make_spec(
    n_particles: int,
    L,
    rcut: float,
    max_tilt: float = 0.5,
    capacity_factor: float = 1.6,
    max_neighbors: int | None = None,
    avg_density: float | None = None,
    subdiv: int = 1,
) -> NeighborSpec:
    """Host-side sizing heuristic for the static neighbor-search shapes."""
    L = tuple(float(x) for x in L)
    subdiv = max(1, int(subdiv))
    ncx, ncy, ncz = _cell_dims(L, rcut, max_tilt, subdiv)
    volume = L[0] * L[1] * L[2]
    density = avg_density if avg_density is not None else n_particles / volume

    if min(ncx, ncy, ncz) < 2 * subdiv + 1:
        # Box too small for the cell stencil: dense all-pairs candidates.
        return NeighborSpec(
            rcut=float(rcut),
            n_cells=(1, 1, 1),
            cell_capacity=n_particles,
            max_neighbors=(
                max_neighbors if max_neighbors is not None else max(1, n_particles - 1)
            ),
        )

    def _poisson_pad(mu: float) -> int:
        # mean + 5 sigma + slack: keeps the overflow-rebuild path rare even
        # for Poisson-fluctuating occupancies at small means.
        return int(math.ceil((mu + 5.0 * math.sqrt(mu) + 4.0) * capacity_factor))

    cell_vol = volume / (ncx * ncy * ncz)
    cap = max(4, _poisson_pad(density * cell_vol))
    if max_neighbors is None:
        sphere = 4.0 / 3.0 * math.pi * rcut ** 3 * density
        max_neighbors = max(8, _poisson_pad(sphere))
        max_neighbors = min(max_neighbors, max(1, n_particles - 1))
    return NeighborSpec(
        rcut=float(rcut),
        n_cells=(ncx, ncy, ncz),
        cell_capacity=cap,
        max_neighbors=int(max_neighbors),
        subdiv=subdiv,
    )


def _compact_rows(cand, mask, n_particles: int, max_neighbors: int):
    """Compact masked candidates left-wards into (N, K) padded with N.

    cumsum-based scatter (no per-row sort): element j of row i goes to column
    cumsum(mask)[i, j] - 1 when masked-in, to a dump column otherwise.
    """
    n_rows = cand.shape[0]
    cols = jnp.cumsum(mask, axis=1, dtype=jnp.int32) - 1
    count = jnp.where(mask.any(axis=1), cols[:, -1] + 1, 0)
    overflow = (count > max_neighbors).any()
    cols = jnp.where(mask, jnp.minimum(cols, max_neighbors), max_neighbors)
    rows = jnp.broadcast_to(jnp.arange(n_rows, dtype=jnp.int32)[:, None], cand.shape)
    out = jnp.full((n_rows, max_neighbors + 1), n_particles, dtype=jnp.int32)
    out = out.at[rows, cols].set(cand.astype(jnp.int32), mode="drop")
    return out[:, :max_neighbors], overflow


from functools import partial


@partial(jax.jit, static_argnames=("spec",))
def build_neighbor_list(pos: jax.Array, box: Box, spec: NeighborSpec) -> NeighborList:
    """Build the (N, max_neighbors) neighbor list.  jit-safe, static shapes."""
    n = pos.shape[0]
    rcut2 = jnp.asarray(spec.rcut * spec.rcut, pos.dtype)

    if spec.all_pairs:
        cand = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (n, n))
        dx, dy, dz = min_image_components(
            box,
            pos[:, 0][:, None] - pos[:, 0][None, :],
            pos[:, 1][:, None] - pos[:, 1][None, :],
            pos[:, 2][:, None] - pos[:, 2][None, :],
        )
        d2 = dx * dx + dy * dy + dz * dz
        mask = (d2 < rcut2) & ~jnp.eye(n, dtype=bool)
        return NeighborList(*_compact_rows(cand, mask, n, spec.max_neighbors))

    ncx, ncy, ncz = spec.n_cells
    n_cell_total = ncx * ncy * ncz
    cap = spec.cell_capacity

    frac = make_fraction(box, pos)
    frac = frac - jnp.floor(frac)  # robust against boundary rounding
    nc = jnp.array([ncx, ncy, ncz], dtype=pos.dtype)
    cxyz = jnp.clip(
        jnp.floor(frac * nc).astype(jnp.int32),
        0,
        jnp.array([ncx - 1, ncy - 1, ncz - 1], dtype=jnp.int32),
    )
    cid = (cxyz[:, 0] * ncy + cxyz[:, 1]) * ncz + cxyz[:, 2]

    # Rank of each particle within its cell, via sort + segment offsets.
    order = jnp.argsort(cid).astype(jnp.int32)
    sorted_cid = cid[order]
    arange = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_cid[1:] != sorted_cid[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(is_start, arange, 0))
    rank = arange - seg_start
    cell_overflow = (rank >= cap).any()

    cell_table = jnp.full((n_cell_total, cap), n, dtype=jnp.int32)
    cell_table = cell_table.at[sorted_cid, jnp.minimum(rank, cap - 1)].set(
        order, mode="drop"
    )
    # overflowing ranks were clamped onto slot cap-1; that only matters when
    # cell_overflow is already flagged, so correctness is preserved on rebuild.

    # (2·subdiv+1)^3 stencil (static shifts), gather candidate occupants.
    s = spec.subdiv
    rng = tuple(range(-s, s + 1))
    shifts = jnp.asarray(
        np.array(
            [(dx, dy, dz) for dx in rng for dy in rng for dz in rng],
            dtype=np.int32,
        )
    )
    n_stencil = (2 * s + 1) ** 3
    ncell_arr = jnp.array([ncx, ncy, ncz], dtype=jnp.int32)
    nbr_cells = (cxyz[:, None, :] + shifts[None, :, :]) % ncell_arr  # (N, St, 3)
    nbr_cids = (nbr_cells[..., 0] * ncy + nbr_cells[..., 1]) * ncz + nbr_cells[..., 2]
    cand = cell_table[nbr_cids].reshape(n, n_stencil * cap)

    # Component-wise (SoA) distance check: no (n, 27*cap, 3) intermediate
    # with a 3-wide minor dimension.
    pos_pad_t = jnp.concatenate([pos, jnp.zeros((1, 3), pos.dtype)], axis=0).T
    dx = pos[:, 0][:, None] - pos_pad_t[0][cand]
    dy = pos[:, 1][:, None] - pos_pad_t[1][cand]
    dz = pos[:, 2][:, None] - pos_pad_t[2][cand]
    dx, dy, dz = min_image_components(box, dx, dy, dz)
    d2 = dx * dx + dy * dy + dz * dz
    mask = (cand != n) & (cand != arange[:, None]) & (d2 < rcut2)

    idx, list_overflow = _compact_rows(cand, mask, n, spec.max_neighbors)
    return NeighborList(idx, cell_overflow | list_overflow)


def grow_spec(spec: NeighborSpec, factor: float = 1.5) -> NeighborSpec:
    """Enlarge capacities after an overflow (host-side, triggers recompile)."""
    return spec._replace(
        cell_capacity=int(math.ceil(spec.cell_capacity * factor)) + 1,
        max_neighbors=int(math.ceil(spec.max_neighbors * factor)) + 1,
    )


def build_neighbor_list_auto(pos, box, spec: NeighborSpec, max_tries: int = 6):
    """Host-side build that grows capacities until nothing overflows.

    Returns (nlist, spec).  Use at setup or whenever a jitted step reports
    overflow; each growth changes static shapes (recompile), so specs should
    be sized generously up front via ``make_spec``.
    """
    for _ in range(max_tries):
        nlist = build_neighbor_list(pos, box, spec)
        if not bool(nlist.overflow):
            return nlist, spec
        spec = grow_spec(spec)
    raise RuntimeError(
        "Neighbor list capacity still overflowing after "
        f"{max_tries} growth steps (spec={spec})."
    )


def neighbor_count_stats(nlist: NeighborList, n_particles: int):
    """(max, mean) neighbor counts — observability/sizing helper."""
    counts = jnp.sum(nlist.idx < n_particles, axis=1)
    return jnp.max(counts), jnp.mean(counts.astype(jnp.float32))
