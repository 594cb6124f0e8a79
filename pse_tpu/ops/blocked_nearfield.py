"""Cell-blocked dense near-field: U = M_real · F without gathers.

Gather-free re-design of the neighbor-list matvec (gpu_stokes_Mreal_kernel,
Mobility.cu:594-687): instead of gathering neighbors, particles live in
padded cell-major arrays (cellbins) and the mobility becomes dense
(cap × cap) pair blocks between each cell and its 27-stencil neighbors:

    A[o, c] ∈ R^{cap×cap} per tensor component, c a cell, o a stencil offset.

Per step the blocks are BUILT once (geometry + Chebyshev pair functions —
elementwise math, no table gathers), then every Lanczos matvec is a
batched (cap×cap)·cap GEMV sweep of streaming reads.  Only the
half-stencil is stored: the −o block is the +o block's transpose, applied as
a second (transposed) GEMV.

The padded-pair overcompute is the price for regularity.  The banded
engine (ops/banded_nearfield.py) avoids it at large N.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..box import Box, min_image_components
from ..cellbins import BinSpec, CellBins, half_space_offsets, roll_cells
from .chebyshev import ChebPair, eval_pair_functions


class NfSpec(NamedTuple):
    """Static blocked-near-field configuration."""

    bins: BinSpec
    offsets: tuple          # half-space stencil offsets, (0,0,0) first
    block_dtype: str = "float32"   # storage dtype for the pair blocks


# Pair blocks are stored as ONE stacked array (noff, 6, C, cap, cap); axis 1
# holds the symmetric tensor components in order (xx, xy, xz, yy, yz, zz).
# A single buffer lets the Pallas kernel stream blocks with one BlockSpec.


def make_nf_spec(
    n_particles: int,
    L,
    rcut: float,
    max_tilt: float = 0.5,
    target_cap: int = 128,
    block_dtype: str = "float32",
) -> NfSpec:
    """Choose cell counts / capacity.

    Cells must be at least rcut wide (tilt-inflated along x) so a 27-stencil
    covers all pairs; beyond that, cells are coarsened until the padded
    capacity approaches the 128-lane tile, which minimizes total padded
    storage (~ C·cap_i·128 = N·pad_factor·128, so the larger the mean
    occupancy the smaller the Poisson padding factor).
    """
    L = tuple(float(x) for x in L)
    nc_max = [
        max(3, int(math.floor(L[0] / (rcut * (1.0 + abs(max_tilt)))))),
        max(3, int(math.floor(L[1] / rcut))),
        max(3, int(math.floor(L[2] / rcut))),
    ]

    def cap_for(nc):
        mu = n_particles / (nc[0] * nc[1] * nc[2])
        cap = mu + 5.0 * math.sqrt(mu) + 4.0
        return max(8, int(math.ceil(cap / 8.0)) * 8)

    nc = list(nc_max)
    best = (tuple(nc), cap_for(nc))
    f = 1.0
    while cap_for(nc) < target_cap * 0.75 and max(nc) > 3:
        f *= 1.3
        nc = [max(3, int(math.floor(m / f))) for m in nc_max]
        best = (tuple(nc), cap_for(nc))
        if min(nc) == 3:
            break
    n_cells, cap = best
    cap = min(cap, max(8, int(math.ceil(n_particles / 8.0)) * 8))
    return NfSpec(
        bins=BinSpec(n_cells=n_cells, cap=cap),
        offsets=half_space_offsets(1),
        block_dtype=block_dtype,
    )


def build_pair_blocks(
    bins: CellBins,
    box: Box,
    spec: NfSpec,
    cheb: ChebPair,
    ewald_cut: float,
    ewald_dr: float,
) -> jax.Array:
    """One dense sweep over the half stencil building the 6 tensor blocks."""
    cap = spec.bins.cap
    dtype = jnp.dtype(spec.block_dtype)
    cut2 = ewald_cut * ewald_cut
    dr2 = ewald_dr * ewald_dr

    per_offset = []
    eye = jnp.eye(cap, dtype=bool)

    for o in spec.offsets:
        xj = roll_cells(bins.px, spec.bins, o)
        yj = roll_cells(bins.py, spec.bins, o)
        zj = roll_cells(bins.pz, spec.bins, o)
        mj = roll_cells(bins.mask, spec.bins, o)

        dx = bins.px[:, :, None] - xj[:, None, :]       # (C, cap_i, cap_j)
        dy = bins.py[:, :, None] - yj[:, None, :]
        dz = bins.pz[:, :, None] - zj[:, None, :]
        dx, dy, dz = min_image_components(box, dx, dy, dz)
        d2 = dx * dx + dy * dy + dz * dz

        valid = (
            (bins.mask[:, :, None] * mj[:, None, :]) > 0
        ) & (d2 < cut2) & (d2 >= dr2)
        if o == (0, 0, 0):
            valid &= ~eye[None, :, :]

        d2_safe = jnp.where(valid, d2, 1.0)
        dist = jnp.sqrt(d2_safe)
        uf1, uf2 = eval_pair_functions(cheb, dist)
        imrr = jnp.where(valid, uf1, 0.0)
        bco = jnp.where(valid, uf2 - uf1, 0.0)
        inv_d = 1.0 / dist
        ex = dx * inv_d
        ey = dy * inv_d
        ez = dz * inv_d

        per_offset.append(
            jnp.stack(
                [
                    (imrr + bco * ex * ex).astype(dtype),
                    (bco * ex * ey).astype(dtype),
                    (bco * ex * ez).astype(dtype),
                    (imrr + bco * ey * ey).astype(dtype),
                    (bco * ey * ez).astype(dtype),
                    (imrr + bco * ez * ez).astype(dtype),
                ],
                axis=0,
            )
        )

    return jnp.stack(per_offset, axis=0)       # (noff, 6, C, cap, cap)


def matvec_cells(
    blocks: jax.Array,         # (noff, 6, C, cap, cap) stacked pair blocks
    spec: NfSpec,
    bins: CellBins,
    f_cells: jax.Array,        # (3, C, cap) — padded slots MUST be zero
    self_mobility,
) -> jax.Array:
    """u = M_real · f in cell layout: batched GEMV sweep over the stencil."""
    fx, fy, fz = f_cells[0], f_cells[1], f_cells[2]
    dtype = f_cells.dtype

    ux = self_mobility * fx * bins.mask
    uy = self_mobility * fy * bins.mask
    uz = self_mobility * fz * bins.mask

    # f32 blocks promise f32 accuracy: force full-precision products (a GPU
    # runs default-precision f32 contractions in TF32, ~1e-3 relative).
    # bf16 blocks already cap accuracy, so they keep the fast default.
    precision = (
        jax.lax.Precision.HIGHEST
        if blocks.dtype == jnp.float32
        else None
    )

    def gemv(A, v):
        # (C, cap, cap) @ (C, cap) -> (C, cap)
        return jnp.einsum(
            "bij,bj->bi", A, v, preferred_element_type=jnp.float32,
            precision=precision,
        ).astype(dtype)

    def gemv_t(A, v):
        return jnp.einsum(
            "bij,bi->bj", A, v, preferred_element_type=jnp.float32,
            precision=precision,
        ).astype(dtype)

    for oi, o in enumerate(spec.offsets):
        axx, axy, axz = blocks[oi, 0], blocks[oi, 1], blocks[oi, 2]
        ayy, ayz, azz = blocks[oi, 3], blocks[oi, 4], blocks[oi, 5]
        if o == (0, 0, 0):
            ux += gemv(axx, fx) + gemv(axy, fy) + gemv(axz, fz)
            uy += gemv(axy, fx) + gemv(ayy, fy) + gemv(ayz, fz)
            uz += gemv(axz, fx) + gemv(ayz, fy) + gemv(azz, fz)
            continue

        fxr = roll_cells(fx, spec.bins, o)
        fyr = roll_cells(fy, spec.bins, o)
        fzr = roll_cells(fz, spec.bins, o)
        # forward: u(c) += A(c) f(c+o)
        ux += gemv(axx, fxr) + gemv(axy, fyr) + gemv(axz, fzr)
        uy += gemv(axy, fxr) + gemv(ayy, fyr) + gemv(ayz, fzr)
        uz += gemv(axz, fxr) + gemv(ayz, fyr) + gemv(azz, fzr)
        # reverse: u(c+o) += A(c)^T f(c)
        wx = gemv_t(axx, fx) + gemv_t(axy, fy) + gemv_t(axz, fz)
        wy = gemv_t(axy, fx) + gemv_t(ayy, fy) + gemv_t(ayz, fz)
        wz = gemv_t(axz, fx) + gemv_t(ayz, fy) + gemv_t(azz, fz)
        mo = (-o[0], -o[1], -o[2])
        ux += roll_cells(wx, spec.bins, mo)
        uy += roll_cells(wy, spec.bins, mo)
        uz += roll_cells(wz, spec.bins, mo)

    return jnp.stack([ux, uy, uz], axis=0)
