"""Z-column NUFFT spread/contract: bilinear-form matmuls, no z windows.

The production far field.  Its predecessor, the stored-W einsum
(ops/blocked_farfield.py), moves W = (27, C, cap, s³) — GBs per step — and
contracts it with N=3 GEMVs.  This formulation keeps every array's minor
dimension at ~Nz or wider and turns both directions into batched GEMMs.
Cells are full-height columns of (sx, sy, Nz) grid nodes.  For a particle
p in column c and its 3×3 xy-neighborhood window G (9·sx·sy xy-nodes ×
Nz z-nodes), the Gaussian quadrature is a bilinear form

    u[p, comp] = wxy[p, :] · G[:, :, comp] · wz[p, :]ᵀ

evaluated as two dense matmuls with the particle axis batched per column:
H = wxy @ G (K = 9·sx·sy), then a z contraction against wz.  Contracting
ALL Nz z-nodes instead of a ±rcut window trades ~5× matmul overcompute
(the far field is bandwidth-bound) for the entire z-extension machinery; the z Gaussian decays below ``error`` inside the
column (same superset-support quadrature argument as blocked_farfield.py).
Spread is the exact transpose: out = wxyᵀ @ (f ⊗ wz), overlap-added onto
the grid along x and y only (3×3 rolls of arrays whose minor dim is Nz).

Reference semantics: gpu_stokes_Spread_kernel / gpu_stokes_Contract_kernel
(Mobility.cu:114-252, 325-477) — same Gaussian, same prefac/quadW scales,
same xy tilt handling (the xy factor is joint because tilt mixes x into y).
Cross-validated against the stored-W sweep in tests/test_farfield_paths.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..box import Box
from ..cellbins import BinSpec, CellBins
from ..params import PSEParams


class ColFfSpec(NamedTuple):
    """Static z-column far-field configuration (hashable)."""

    bins: BinSpec            # n_cells = (ncx, ncy, 1); cap per column
    s: tuple                 # (sx, sy) nodes per column per axis
    full_precision: bool = False
    weight_dtype: str = "float32"


class ColFactors(NamedTuple):
    """Per-step Gaussian factors shared by spread and contract, both with
    CAP as the minor dimension (the particle axis the einsums batch over
    per column)."""

    wxy: jax.Array   # (C, 9·sx·sy, cap) joint xy window factor (tilt-aware)
    wz: jax.Array    # (C, Nz, cap) full-column z factor, mask folded


def make_col_spec(
    params: PSEParams,
    n_particles: int,
    weight_dtype: str | None = None,
) -> ColFfSpec | None:
    """Choose (sx, sy) as grid divisors covering the Gaussian reach.

    Needs sx, sy ≥ P/2 + 1 so the 3×3 window is a superset of the P-point
    support, and ≥ 3 columns per axis so the periodic stencil has distinct
    neighbors.  Returns None when the grid is too small (fallback paths).
    """
    need = params.gauss_P // 2 + 1

    def best_axis(ng):
        cands = [s for s in range(need, ng // 3 + 1) if ng % s == 0]
        return min(cands) if cands else None

    sx = best_axis(params.Nx)
    sy = best_axis(params.Ny)
    if sx is None or sy is None:
        return None
    ncx, ncy = params.Nx // sx, params.Ny // sy

    mu = n_particles / (ncx * ncy)
    cap = int(math.ceil((mu + 5.0 * math.sqrt(mu) + 4.0) / 8.0)) * 8
    cap = min(cap, max(8, int(math.ceil(n_particles / 8.0)) * 8))

    full_precision, weight_dtype = ff_weight_choice(params.error, weight_dtype)
    return ColFfSpec(
        bins=BinSpec(n_cells=(ncx, ncy, 1), cap=cap),
        s=(sx, sy),
        full_precision=full_precision,
        weight_dtype=weight_dtype,
    )


# Far-field matmul dtype at error >= 1e-3 (see ff_weight_choice): f32
# factors with TF32 products.  Measured on one H100 at the N=100k
# phi=0.45 bench geometry (PERF.md): bf16 factors ran the brownian step
# 1.7% faster (2 of 2 pairs, inside the run-to-run spread) at twice the
# oracle error (1.84e-3 vs 8.86e-4, gate 5e-3); the far field is ~2% of
# the step, so f32/TF32 keeps the accuracy.
FAST_FF_WEIGHT_DTYPE = "float32"


def ff_weight_choice(error: float, weight_dtype: str | None = None):
    """(full_precision, weight_dtype) of the far-field factors, from the
    requested ``error`` alone — never from the backend.

    error < 1e-3: f32 factors, every contraction at Precision.HIGHEST (a
    GPU would otherwise run f32 products in TF32, ~1e-3 relative).
    error >= 1e-3: FAST_FF_WEIGHT_DTYPE at Precision.DEFAULT — "float32"
    runs the products in TF32 on the GPU, "bfloat16" stores the factors in
    bf16 with f32 accumulation.  Both sit at or under the method's error
    target; an explicit ``weight_dtype`` overrides the choice."""
    full_precision = error < 1e-3
    if weight_dtype is None:
        weight_dtype = "float32" if full_precision else FAST_FF_WEIGHT_DTYPE
    elif full_precision and weight_dtype == "bfloat16":
        raise ValueError(
            "bfloat16 far-field factors are incompatible with "
            f"error={error:g} < 1e-3 (full-precision passes)"
        )
    return full_precision, weight_dtype


def ff_matmul_precision(full_precision: bool):
    """Precision of the far-field contractions: HIGHEST where the error
    target needs true f32 products, DEFAULT (TF32 for f32 operands on the
    GPU, native for bf16) otherwise."""
    if full_precision:
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


def _node_fractions_xy(bins: CellBins, box: Box, params: PSEParams):
    """Node-space particle coordinates per axis (C, cap), tilt-reduced x."""
    L = box.L
    lo = box.lo
    fx = (bins.px - lo[0] - box.tilt_xy * bins.py) / L[0]
    fy = (bins.py - lo[1]) / L[1]
    fz = (bins.pz - lo[2]) / L[2]
    fx = fx - jnp.floor(fx)
    fy = fy - jnp.floor(fy)
    fz = fz - jnp.floor(fz)
    return fx * params.Nx, fy * params.Ny, fz * params.Nz


def build_col_factors(
    bins: CellBins, box: Box, spec: ColFfSpec, params: PSEParams
) -> ColFactors:
    sx, sy = spec.s
    ncx, ncy, _ = spec.bins.n_cells
    C = ncx * ncy
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    L = params.L
    expfac = params.spread_expfac
    pfx, pfy, pfz = _node_fractions_xy(bins, box, params)

    import numpy as np

    bx, by = np.meshgrid(np.arange(ncx), np.arange(ncy), indexing="ij")
    bx = jnp.asarray(bx.reshape(-1), jnp.int32)
    by = jnp.asarray(by.reshape(-1), jnp.int32)

    def ext_frac_delta(b, s, pf, N):
        node = (b[:, None] - 1) * s + jnp.arange(3 * s, dtype=jnp.int32)
        fd = node[:, :, None].astype(pf.dtype) / N - (pf / N)[:, None, :]
        return fd - jnp.round(fd)                     # (C, 3s, cap)

    fdx = ext_frac_delta(bx, sx, pfx, Nx)
    fdy = ext_frac_delta(by, sy, pfy, Ny)
    # full z column: nodes 0..Nz-1, minimum-image reduced
    nodez = jnp.arange(Nz, dtype=pfz.dtype)
    fdz = nodez[None, :, None] / Nz - (pfz / Nz)[:, None, :]
    fdz = fdz - jnp.round(fdz)                        # (C, Nz, cap)

    dyu = L[1] * fdy                                  # (C, 3sy, cap)
    dz = L[2] * fdz
    # Node order within 9·sx·sy is OFFSET-MAJOR: (ox, oy, sx, sy).  The
    # spread fold (_windows_to_grid) then slices whole per-offset blocks
    # off the einsum output and overlap-adds BEFORE the minor-dim relayout
    # — with offsets interleaved ((ox, sx, oy, sy)) the relayout would run
    # on the full 9x window array.
    dxo = (L[0] * fdx).reshape(C, 3, sx, spec.bins.cap)
    dyo = dyu.reshape(C, 3, sy, spec.bins.cap)
    dx = dxo[:, :, None, :, None, :] + box.tilt_xy * dyo[:, None, :, None]
    # Factors are STORED in the matmul dtype: both consumers cast them at
    # the einsum anyway, so a wider store would only add write + read
    # traffic.  The cast is fused into the exp fusions.
    dtype, _ = _matmul_dtype(spec)
    wxy = jnp.exp(
        -expfac * (dx * dx + (dyo * dyo)[:, None, :, None])
    )                                # (C, 3ox, 3oy, sx, sy, cap)
    wz = jnp.exp(-expfac * dz * dz) * bins.mask[:, None, :]

    return ColFactors(
        wxy=wxy.reshape(C, 9 * sx * sy, spec.bins.cap).astype(dtype),
        wz=wz.astype(dtype),
    )


def _matmul_dtype(spec: ColFfSpec):
    dtype = jnp.float32 if spec.full_precision else jnp.dtype(spec.weight_dtype)
    return dtype, ff_matmul_precision(spec.full_precision)


def _grid_to_windows(grid: jax.Array, spec: ColFfSpec, params: PSEParams,
                     dtype=None):
    """(3, Nx, Ny, Nz) -> (C, 9·sx·sy, 3·Nz) xy-windows, minor dim Nz.

    ``dtype``: cast BEFORE the 9x window duplication so the materialized
    window array is built in the matmul dtype (casting after costs a
    separate relayout copy)."""
    sx, sy = spec.s
    ncx, ncy, _ = spec.bins.n_cells
    if dtype is not None:
        grid = grid.astype(dtype)
    g = grid.reshape(3, ncx, sx, ncy, sy, params.Nz)
    g = g.transpose(1, 2, 3, 4, 0, 5)            # (ncx, sx, ncy, sy, 3, Nz)
    # V[b, o] = blocks[b + o - 1] per axis (adjoint of the spread fold)
    gx = jnp.stack([jnp.roll(g, 1 - o, axis=0) for o in range(3)], axis=1)
    gxy = jnp.stack([jnp.roll(gx, 1 - o, axis=3) for o in range(3)], axis=4)
    # (ncx, 3ox, sx, ncy, 3oy, sy, 3, Nz) -> offset-major node order
    # (ox, oy, sx, sy), matching build_col_factors' wxy
    gxy = gxy.transpose(0, 3, 1, 4, 2, 5, 6, 7)
    return gxy.reshape(ncx * ncy, 9 * sx * sy, 3 * params.Nz)


def _windows_to_grid(out: jax.Array, spec: ColFfSpec, params: PSEParams):
    """(C, 9·sx·sy, 3·Nz) -> (3, Nx, Ny, Nz) overlap-add on x and y.

    The node order is offset-major (build_col_factors), so each of the 9
    offset contributions is a whole contiguous block of ``out`` — the fold
    runs on layout-preserving slices of the 9x window array and only the
    9x-smaller folded result pays the minor-dim relayout (splitting the
    3·Nz dim)."""
    sx, sy = spec.s
    ncx, ncy, _ = spec.bins.n_cells
    out = out.reshape(ncx, ncy, 9, sx * sy, 3 * params.Nz)
    acc = None
    for o in range(9):
        ox, oy = o // 3 - 1, o % 3 - 1
        t = jnp.roll(out[:, :, o], (ox, oy), axis=(0, 1))
        acc = t if acc is None else acc + t
    acc = acc.reshape(ncx, ncy, sx, sy, 3, params.Nz)
    grid = acc.transpose(4, 0, 2, 1, 3, 5)       # (3, ncx, sx, ncy, sy, Nz)
    return grid.reshape(3, params.Nx, params.Ny, params.Nz)


def spread_col(
    bins: CellBins,
    f_cells: jax.Array,          # (3, C, cap) — padded slots zero
    box: Box,
    spec: ColFfSpec,
    params: PSEParams,
    factors: ColFactors,
) -> jax.Array:
    """Force-moment grid: out = wxyᵀ @ (f ⊗ wz) per column + xy overlap-add."""
    sx, sy = spec.s
    C = spec.bins.n_cells_total
    cap = spec.bins.cap
    dtype, precision = _matmul_dtype(spec)

    # X is built directly in the matmul dtype (the cast fuses into the
    # outer-product fusion; materializing f32 and casting at the einsum
    # would add a second full-size pass).
    # X[c, (k,z), p] = f[k,c,p]·wz[c,z,p] — cap-minor like the factors.
    # prefac rides the small force operand, not the large einsum output.
    fp = f_cells * jnp.float32(params.spread_prefac)
    X = (
        fp.transpose(1, 0, 2)[:, :, None, :]
        * factors.wz[:, None, :, :]
    ).reshape(C, 3 * params.Nz, cap).astype(dtype)
    out = jnp.einsum(
        "cnp,cmp->cnm", factors.wxy.astype(dtype), X,
        preferred_element_type=jnp.float32, precision=precision,
    )                                            # (C, 9·sx·sy, 3·Nz)
    return _windows_to_grid(out, spec, params)


def contract_col(
    bins: CellBins,
    grid_real: jax.Array,        # (3, Nx, Ny, Nz)
    box: Box,
    spec: ColFfSpec,
    params: PSEParams,
    factors: ColFactors,
) -> jax.Array:
    """Particle velocities (3, C, cap): exact transpose of spread_col."""
    C = spec.bins.n_cells_total
    cap = spec.bins.cap
    dtype, precision = _matmul_dtype(spec)

    v = _grid_to_windows(grid_real, spec, params, dtype)  # (C, 9sxsy, 3Nz)
    H = jnp.einsum(
        "cnp,cnm->cmp", factors.wxy.astype(dtype), v,
        preferred_element_type=jnp.float32, precision=precision,
    )                                                # (C, 3·Nz, cap)
    # H is rounded to the matmul dtype before the z-contraction: its f32
    # write+read dominates the contract's memory traffic, and at bf16 the
    # rounding (~0.4% per element, averaged over the ~P significant
    # z-terms) sits an order below the bf16 matmul-input rounding already
    # accepted at error >= 1e-3 (pinned by test_farfield_paths).
    # Accumulation stays f32 via preferred_element_type.
    H = H.reshape(C, 3, params.Nz, cap).astype(dtype)
    u = jnp.einsum(
        "ckzp,czp->kcp", H, factors.wz,
        preferred_element_type=jnp.float32, precision=precision,
    )                                                # (3, C, cap) directly
    scale = jnp.float32(params.quadW * params.spread_prefac)
    return scale * u
