"""Cell-blocked NUFFT spread/contract: gather/scatter-free Gaussian spreading.

Gather-free re-design of gpu_stokes_Spread/Contract (Mobility.cu:114-477).
The CUDA version scatter-adds P³ Gaussian taps per particle with atomics
(run to run, the summation order changes).  Here the FFT grid is
partitioned into node blocks of
(sx, sy, sz) nodes aligned with a particle cell grid of the same geometry,
and spreading is formulated as a GATHER over a regular stencil:

    grid[block b] = Σ_{offset o} W(b, o) · F[cell b+o]

where W(b, o) ∈ R^{s³ × cap} holds the Gaussian weights between the block's
nodes and the (padded) particles of the neighboring cell — a batched dense
matmul.  Contraction is the transpose sweep with the same weights.  No
scatters, no gathers; the weight build is separable (exp count ∝ s²·cap per
block, not s³·cap).

Because every node sums over ALL particles within the stencil reach (≥ the
P-point support half-width), the effective support is a superset of the
reference's P³ window — the extra far taps carry exp(-expfac r²) ≲ error and
only move the quadrature closer to the untruncated Gaussian.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..box import Box
from ..cellbins import BinSpec, CellBins, full_offsets, roll_cells
from ..params import PSEParams
from .column_farfield import ff_matmul_precision, ff_weight_choice


class FfSpec(NamedTuple):
    """Static blocked-NUFFT configuration."""

    bins: BinSpec           # particle cells == node blocks
    s: tuple                # (sx, sy, sz) nodes per block per axis
    offsets: tuple          # full stencil (reach 1)
    store_weights: bool = True   # build W once per step, share spread/contract
    full_precision: bool = False  # HIGHEST-precision W contractions
    weight_dtype: str = "float32"  # stored-W dtype (ff_weight_choice)


def _axis_divisors(n_grid: int, p: int):
    """Divisors s of the grid dim with s >= P/2 + 1 (reach-1 support cover)
    and at least 3 cells."""
    need = p // 2 + 1
    return [s for s in range(need, n_grid // 3 + 1) if n_grid % s == 0]


def make_ff_spec(
    params: PSEParams,
    n_particles: int,
    weight_dtype: str | None = None,
) -> FfSpec | None:
    """Choose per-axis block sizes keeping s³ near a multiple of 128.

    The weight blocks are stored/streamed as (C, cap, s³); (sx·sy·sz) is
    chosen to sit just at or above a multiple of 128 (e.g. 8·4·4=128
    exactly, 5³=125→128), which keeps the GEMM tiles full.
    Returns None when the grid is too small to block (fallback: gather taps).
    """
    dims = (params.Nx, params.Ny, params.Nz)
    cands = [_axis_divisors(ng, params.gauss_P) for ng in dims]
    if any(not c for c in cands):
        return None

    best = None
    for sx in cands[0]:
        for sy in cands[1]:
            for sz in cands[2]:
                s3 = sx * sy * sz
                if s3 > 1024 and best is not None:
                    continue  # giant blocks explode the per-block capacity
                padded = -(-s3 // 128) * 128
                waste = padded / s3
                # blocks far above ~128 nodes inflate the weight compute and
                # capacities; weight the pad waste by a soft size penalty.
                size_penalty = max(1.0, s3 / 256.0)
                key = (round(waste * size_penalty, 3), s3)
                if best is None or key < best[0]:
                    best = (key, (sx, sy, sz))
    s = best[1]
    nc = (dims[0] // s[0], dims[1] // s[1], dims[2] // s[2])
    mu = n_particles / (nc[0] * nc[1] * nc[2])
    cap = max(8, int(math.ceil((mu + 5.0 * math.sqrt(mu) + 4.0) / 8.0)) * 8)
    cap = min(cap, max(8, int(math.ceil(n_particles / 8.0)) * 8))
    # dtype and precision follow the requested error alone
    full_precision, weight_dtype = ff_weight_choice(params.error, weight_dtype)
    return FfSpec(
        bins=BinSpec(n_cells=nc, cap=cap), s=s, offsets=full_offsets(1),
        full_precision=full_precision, weight_dtype=weight_dtype,
    )


def _block_coords(spec: FfSpec):
    """Static (C,) arrays of block coordinates (z-fastest flat order)."""
    ncx, ncy, ncz = spec.bins.n_cells
    bx, by, bz = np.meshgrid(
        np.arange(ncx), np.arange(ncy), np.arange(ncz), indexing="ij"
    )
    return (
        jnp.asarray(bx.reshape(-1), jnp.int32),
        jnp.asarray(by.reshape(-1), jnp.int32),
        jnp.asarray(bz.reshape(-1), jnp.int32),
    )


def _particle_node_fractions(bins: CellBins, box: Box, params: PSEParams):
    """Node-space particle coordinates pf = frac * N_grid, per axis (C, cap)."""
    L = box.L
    lo = box.lo
    fx = (bins.px - lo[0] - box.tilt_xy * bins.py) / L[0]
    fy = (bins.py - lo[1]) / L[1]
    fz = (bins.pz - lo[2]) / L[2]
    fx = fx - jnp.floor(fx)
    fy = fy - jnp.floor(fy)
    fz = fz - jnp.floor(fz)
    return fx * params.Nx, fy * params.Ny, fz * params.Nz


def _offset_weights(
    spec: FfSpec,
    params: PSEParams,
    box: Box,
    pf,                      # (pfx, pfy, pfz) each (C, cap)
    mask_r,                  # (C, cap) — rolled mask
    o,
    bcoords,
):
    """W (C, s³, cap) for one stencil offset (weights already mask-folded)."""
    sx, sy, sz = spec.s
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    L = params.L
    expfac = params.spread_expfac
    bx, by, bz = bcoords
    pfx, pfy, pfz = pf

    node_x = (bx[:, None] * sx + jnp.arange(sx, dtype=jnp.int32)[None, :]).astype(
        pfx.dtype
    )                                                     # (C, sx)
    node_y = (by[:, None] * sy + jnp.arange(sy, dtype=jnp.int32)[None, :]).astype(
        pfx.dtype
    )
    node_z = (bz[:, None] * sz + jnp.arange(sz, dtype=jnp.int32)[None, :]).astype(
        pfx.dtype
    )

    def red(fd):
        return fd - jnp.round(fd)

    fdx = red((node_x[:, :, None] - pfx[:, None, :]) / Nx)   # (C, sx, cap)
    fdy = red((node_y[:, :, None] - pfy[:, None, :]) / Ny)   # (C, sy, cap)
    fdz = red((node_z[:, :, None] - pfz[:, None, :]) / Nz)   # (C, sz, cap)

    dyu = L[1] * fdy
    dz = L[2] * fdz
    dx = (L[0] * fdx)[:, :, None, :] + box.tilt_xy * dyu[:, None, :, :]  # (C,sx,sy,cap)

    # Layout: particle slot (cap) on the sublane side, node index (s³) minor
    # — s³ is chosen near a multiple of 128 so the lane tiles are ~full.
    w_xy = jnp.exp(-expfac * (dx * dx + (dyu * dyu)[:, None, :, :]))     # (C,sx,sy,cap)
    w_z = jnp.exp(-expfac * dz * dz) * mask_r[:, None, :]                # (C,sz,cap)
    w_xy = w_xy.transpose(0, 3, 1, 2)                                    # (C,cap,sx,sy)
    w_z = w_z.transpose(0, 2, 1)                                         # (C,cap,sz)
    W = w_xy[:, :, :, :, None] * w_z[:, :, None, None, :]                # (C,cap,sx,sy,sz)
    return W.reshape(W.shape[0], spec.bins.cap, sx * sy * sz).astype(
        jnp.dtype(spec.weight_dtype)
    )


def build_weights(
    bins: CellBins, box: Box, spec: FfSpec, params: PSEParams
) -> jax.Array:
    """All stencil weights (noff, C, cap, s³), built once per step and shared
    by spread and contract (same Gaussian both directions)."""
    bcoords = _block_coords(spec)
    pf = _particle_node_fractions(bins, box, params)
    ws = []
    for o in spec.offsets:
        pfo = tuple(roll_cells(p, spec.bins, o) for p in pf)
        mo = roll_cells(bins.mask, spec.bins, o)
        ws.append(_offset_weights(spec, params, box, pfo, mo, o, bcoords))
    return jnp.stack(ws, axis=0)


def _grid_to_blocks(grid: jax.Array, spec: FfSpec) -> jax.Array:
    """(3, Nx, Ny, Nz) -> (C, 3, s³)."""
    ncx, ncy, ncz = spec.bins.n_cells
    sx, sy, sz = spec.s
    g = grid.reshape(3, ncx, sx, ncy, sy, ncz, sz)
    g = g.transpose(1, 3, 5, 0, 2, 4, 6)
    return g.reshape(ncx * ncy * ncz, 3, sx * sy * sz)


def _blocks_to_grid(blocks: jax.Array, spec: FfSpec, params: PSEParams) -> jax.Array:
    """(C, 3, s³) -> (3, Nx, Ny, Nz)."""
    ncx, ncy, ncz = spec.bins.n_cells
    sx, sy, sz = spec.s
    g = blocks.reshape(ncx, ncy, ncz, 3, sx, sy, sz)
    g = g.transpose(3, 0, 4, 1, 5, 2, 6)
    return g.reshape(3, params.Nx, params.Ny, params.Nz)


def spread_blocked(
    bins: CellBins,
    f_cells: jax.Array,          # (3, C, cap) — padded slots zero
    box: Box,
    spec: FfSpec,
    params: PSEParams,
    weights: jax.Array | None = None,   # (noff, C, cap, s³) from build_weights
) -> jax.Array:
    """Force-moment grid (3, Nx, Ny, Nz) by per-node gathers (no scatter)."""
    if weights is None:
        bcoords = _block_coords(spec)
        pf = _particle_node_fractions(bins, box, params)
    c_total = spec.bins.n_cells_total
    s3 = spec.s[0] * spec.s[1] * spec.s[2]

    acc = jnp.zeros((c_total, 3, s3), f_cells.dtype)
    for oi, o in enumerate(spec.offsets):
        if weights is None:
            pfo = tuple(roll_cells(p, spec.bins, o) for p in pf)
            mo = roll_cells(bins.mask, spec.bins, o)
            W = _offset_weights(spec, params, box, pfo, mo, o, bcoords)
        else:
            W = weights[oi]                                 # (C, cap, s³)
        fr = jnp.stack(
            [roll_cells(f_cells[c], spec.bins, o) for c in range(3)], axis=1
        ).astype(W.dtype)                                   # (C, 3, cap)
        acc = acc + jnp.einsum(
            "bpn,bcp->bcn", W, fr, preferred_element_type=jnp.float32,
            precision=ff_matmul_precision(spec.full_precision),
        ).astype(acc.dtype)

    acc = acc * jnp.asarray(params.spread_prefac, acc.dtype)
    return _blocks_to_grid(acc, spec, params)


def contract_blocked(
    bins: CellBins,
    grid_real: jax.Array,        # (3, Nx, Ny, Nz)
    box: Box,
    spec: FfSpec,
    params: PSEParams,
    weights: jax.Array | None = None,   # (noff, C, cap, s³) from build_weights
) -> jax.Array:
    """Particle velocities in cell layout (3, C, cap): transpose sweep."""
    if weights is None:
        bcoords = _block_coords(spec)
        pf = _particle_node_fractions(bins, box, params)
    v = _grid_to_blocks(grid_real, spec)                    # (C, 3, s³)
    c_total = spec.bins.n_cells_total
    cap = spec.bins.cap

    u = jnp.zeros((c_total, 3, cap), grid_real.dtype)
    for oi, o in enumerate(spec.offsets):
        if weights is None:
            pfo = tuple(roll_cells(p, spec.bins, o) for p in pf)
            mo = roll_cells(bins.mask, spec.bins, o)
            W = _offset_weights(spec, params, box, pfo, mo, o, bcoords)
        else:
            W = weights[oi]                                 # (C, cap, s³)
        contrib = jnp.einsum(
            "bpn,bcn->bcp", W, v.astype(W.dtype),
            preferred_element_type=jnp.float32,
            precision=ff_matmul_precision(spec.full_precision),
        ).astype(u.dtype)
        u = u + roll_cells(contrib, spec.bins, (-o[0], -o[1], -o[2]))

    scale = params.quadW * params.spread_prefac
    return (scale * u).transpose(1, 0, 2)                   # (3, C, cap)
