"""Wave-space (far-field) spectral-Ewald mobility on the FFT grid.

Vectorized re-design of the NUFFT pipeline of Mobility.cu:114-575:

  spread (Gaussian scatter-add)  →  FFT×3  →  Green/transverse scale
  [→ + Hermitian noise]          →  IFFT×3 →  contract (Gaussian gather)

Key departures from the CUDA design:
  * The per-particle P³ Gaussian taps are generated by index arithmetic with
    a partially separable weight product (exp count P²+P instead of P³) —
    no atomics; the scatter-add is a single XLA scatter with flat indices.
  * FFTs are batched ``jnp.fft.fftn`` over a (3, Nx, Ny, Nz) array (XLA FFT,
    shardable over a device mesh).
  * jnp's normalized ifftn means the Green scale carries no 1/(Nx·Ny·Nz)
    factor (unlike gridk.w in Helper.cu:326 which bakes in cuFFT's
    unnormalized inverse).

The tilted (sheared) box enters through the fractional-coordinate tap
geometry exactly as in Mobility.cu:230-237: physical tap displacement
Δr = f_x·a1 + f_y·a2 + f_z·a3 with lattice vectors a1=(Lx,0,0),
a2=(xy·Ly, Ly, 0), a3=(0,0,Lz) and per-axis round-reduced fractional deltas
(equivalent to BoxDim::minImage for taps within half a box).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..box import Box, make_fraction
from ..params import PSEParams


class SpreadTaps(NamedTuple):
    """Per-particle Gaussian tap indices and weights, shared by spread and
    contract (same Gaussian both ways).

    Layout: (P³, N) with the particle dimension minor — the large,
    contiguous one."""

    flat_idx: jax.Array   # (P^3, N) int32 — flattened grid node index
    weights: jax.Array    # (P^3, N) f32 — exp(-expfac * |Δr|²)


def compute_taps(pos: jax.Array, box: Box, params: PSEParams) -> SpreadTaps:
    """Tap geometry for all particles (Mobility.cu:180-246 index arithmetic)."""
    P = params.gauss_P
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    L = params.L
    n = pos.shape[0]
    expfac = jnp.asarray(params.spread_expfac, pos.dtype)

    frac = make_fraction(box, pos)            # (N, 3) in [0,1)
    frac = frac - jnp.floor(frac)

    dims = (Nx, Ny, Nz)
    offs = jnp.arange(P, dtype=jnp.int32)

    wrapped = []
    fdelta = []
    for ax in range(3):
        pf = frac[:, ax] * dims[ax]
        base = jnp.floor(pf).astype(jnp.int32)
        # Center the support on the particle (Mobility.cu:212-214).
        shift = (P % 2) * ((pf - base.astype(pf.dtype)) < 0.5).astype(jnp.int32)
        node = base[None, :] + offs[:, None] - (P // 2) + 1 - shift[None, :]
        wrapped.append(jnp.remainder(node, dims[ax]))        # (P, N)
        # Fractional delta, round-reduced to (-1/2, 1/2] (minimum image).
        fd = (node.astype(pf.dtype) - pf[None, :]) / dims[ax]
        fdelta.append(fd - jnp.round(fd))                    # (P, N)

    # Physical displacements via the (possibly tilted) lattice vectors.
    dy = L[1] * fdelta[1]                         # (P, N)
    dz = L[2] * fdelta[2]                         # (P, N)
    dx = (L[0] * fdelta[0])[:, None, :] + box.tilt_xy * dy[None, :, :]  # (Px,Py,N)

    w_xy = jnp.exp(-expfac * (dx * dx + (dy * dy)[None, :, :]))  # (Px, Py, N)
    w_z = jnp.exp(-expfac * dz * dz)                             # (Pz, N)
    weights = (w_xy[:, :, None, :] * w_z[None, None, :, :]).reshape(P * P * P, n)

    flat = (
        (wrapped[0][:, None, None, :] * Ny + wrapped[1][None, :, None, :]) * Nz
        + wrapped[2][None, None, :, :]
    ).reshape(P * P * P, n)

    return SpreadTaps(flat, weights)


def spread(taps: SpreadTaps, forces: jax.Array, params: PSEParams) -> jax.Array:
    """Scatter forces onto the grid (gpu_stokes_Spread_kernel analogue).

    Returns a real (3, Nx, Ny, Nz) force-moment grid.  One scatter-add per
    component: no combined (N·P³, 3) value array with a 3-wide minor
    dimension.
    """
    n_total = params.n_grid_total
    prefac = jnp.asarray(params.spread_prefac, forces.dtype)
    w = prefac * taps.weights                            # (P³, N)
    flat = taps.flat_idx.reshape(-1)
    comps = []
    for c in range(3):
        vals = (forces[:, c][None, :] * w).reshape(-1)
        comps.append(jnp.zeros((n_total,), forces.dtype).at[flat].add(vals))
    return jnp.stack(comps, axis=0).reshape(3, params.Nx, params.Ny, params.Nz)


def contract(taps: SpreadTaps, grid_real: jax.Array, params: PSEParams) -> jax.Array:
    """Interpolate grid velocities back to particles
    (gpu_stokes_Contract_kernel analogue).  ``grid_real``: (3, Nx, Ny, Nz).
    """
    flatg = grid_real.reshape(3, params.n_grid_total)
    scale = params.quadW * params.spread_prefac
    comps = [
        scale * jnp.sum(flatg[c][taps.flat_idx] * taps.weights, axis=0)
        for c in range(3)
    ]
    return jnp.stack(comps, axis=1)                # (N, 3)


def apply_green(ghat: jax.Array, kvec: jax.Array, W: jax.Array) -> jax.Array:
    """Transverse-project and scale the FFT'd force grid
    (gpu_stokes_Green_kernel, Mobility.cu:264-299).

    ghat: (3, Nx, Ny, Nz) complex.  B(k) = W(k)·(sin k / k)² with the a=1
    finite-size factor; k=0 term excluded (W(0)=0).
    """
    k2 = jnp.sum(kvec * kvec, axis=-1)
    k2_safe = jnp.where(k2 > 0, k2, 1.0)
    k = jnp.sqrt(k2_safe)
    sinc = jnp.sin(k) / k
    B = (W * sinc * sinc).astype(ghat.real.dtype)

    kv = jnp.moveaxis(kvec, -1, 0).astype(ghat.real.dtype)   # (3, Nx, Ny, Nz)
    kdF = jnp.sum(kv * ghat, axis=0) / k2_safe
    return (ghat - kv * kdF[None]) * B[None]


def wave_space_velocity(
    pos: jax.Array,
    forces: jax.Array,
    box: Box,
    params: PSEParams,
    kvec: jax.Array,
    W: jax.Array,
    noise_hat: jax.Array | None = None,
    taps: SpreadTaps | None = None,
) -> jax.Array:
    """Full wave-space pipeline U_wave = M_wave·F [+ sqrt(M_wave)·noise].

    Mirrors gpu_stokes_Mwave_wrap (Mobility.cu:515-575) with the noise
    injection point of the fused step (Brownian.cu:849-872): the stochastic
    k-space increment is added after Green scaling so the inverse FFTs and
    the contraction are shared between the deterministic and Brownian parts.
    """
    if taps is None:
        taps = compute_taps(pos, box, params)
    grid = spread(taps, forces, params)
    ghat = jnp.fft.fftn(grid.astype(jnp.complex64), axes=(1, 2, 3))
    ghat = apply_green(ghat, kvec, W)
    if noise_hat is not None:
        ghat = ghat + noise_hat
    grid_v = jnp.fft.ifftn(ghat, axes=(1, 2, 3)).real.astype(forces.dtype)
    return contract(taps, grid_v, params)
