"""Real-space (near-field) Ewald RPY mobility: U = M_real · F.

Vectorized re-design of gpu_stokes_Mreal_kernel (Mobility.cu:594-687): the
CUDA thread-per-particle neighbor loop with texture-table lookups becomes a
fully vectorized gather over a fixed-capacity neighbor array.

Because the Lanczos square root applies M_real to many vectors at fixed
positions (Brownian.cu:473-521), the position-dependent pair coefficients
(table-interpolated UF1/UF2 and pair unit vectors) are precomputed once per
step (``precompute_pair_coeffs``) so each matvec is just one force gather +
fused multiply-adds — the analogue of the reference's texture cache.

Layout: all large per-pair arrays are stored structure-of-arrays, (N, K) per
component — no (N, K, 3) arrays with a 3-wide minor dimension.  Velocity/force vectors cross this module as
(N, 3) at the API boundary but are transposed to (3, N) internally.

Invalid (padded / out-of-range) pairs are encoded as zero coefficients, so
the matvec needs no masks.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..box import Box, min_image_components


class PairCoeffs(NamedTuple):
    """Per-pair mobility coefficients for repeated M_real matvecs (SoA)."""

    nbr: jax.Array      # (N, K) int32, padded with N
    imrr: jax.Array     # (N, K) f32 — UF1, zero for invalid pairs
    bcoef: jax.Array    # (N, K) f32 — UF2-UF1, zero for invalid pairs
    ex: jax.Array       # (N, K) f32 — unit pair vector components (i - j)
    ey: jax.Array
    ez: jax.Array


def precompute_pair_coeffs(
    pos: jax.Array,
    nbr_idx: jax.Array,
    box: Box,
    table: jax.Array,
    ewald_cut: float,
    ewald_dr: float,
    ewald_n: int,
) -> PairCoeffs:
    """Table-interpolate UF1/UF2 for every neighbor pair (Mobility.cu:655-670).

    Pairs outside [ewald_dr, ewald_cut) — including the padded sentinel
    entries — get zero coefficients.
    """
    n = pos.shape[0]
    pos_pad_t = jnp.concatenate([pos, jnp.zeros((1, 3), pos.dtype)], axis=0).T
    dx = pos[:, 0][:, None] - pos_pad_t[0][nbr_idx]
    dy = pos[:, 1][:, None] - pos_pad_t[1][nbr_idx]
    dz = pos[:, 2][:, None] - pos_pad_t[2][nbr_idx]
    dx, dy, dz = min_image_components(box, dx, dy, dz)
    d2 = dx * dx + dy * dy + dz * dz

    valid = (
        (nbr_idx < n)
        & (d2 < ewald_cut * ewald_cut)
        & (d2 >= ewald_dr * ewald_dr)
    )
    d2_safe = jnp.where(valid, d2, 1.0)
    dist = jnp.sqrt(d2_safe)

    # Table index + linear interpolation factor (Mobility.cu:661-667).
    r_ind_f = jnp.floor(ewald_n * (dist - ewald_dr) / (ewald_cut - ewald_dr))
    r_ind = jnp.clip(r_ind_f.astype(jnp.int32), 0, table.shape[0] - 1)
    fac = dist / ewald_dr - r_ind.astype(dist.dtype) - 1.0

    # Per-column gathers ((N, K) each) instead of one (N, K, 4) gather with
    # a 4-wide minor dimension.
    table_t = table.T                             # (4, nR)
    t_uf1 = table_t[0][r_ind]
    t_uf2 = table_t[1][r_ind]
    t_uf1_next = table_t[2][r_ind]
    t_uf2_next = table_t[3][r_ind]
    imrr = t_uf1 + (t_uf1_next - t_uf1) * fac
    rr = t_uf2 + (t_uf2_next - t_uf2) * fac

    imrr = jnp.where(valid, imrr, 0.0)
    rr = jnp.where(valid, rr, 0.0)
    inv_d = jnp.where(valid, 1.0 / dist, 0.0)

    return PairCoeffs(
        nbr=nbr_idx,
        imrr=imrr,
        bcoef=rr - imrr,
        ex=dx * inv_d,
        ey=dy * inv_d,
        ez=dz * inv_d,
    )


def mreal_matvec_t(coeffs: PairCoeffs, ft: jax.Array, self_mobility) -> jax.Array:
    """U = M_real · F in transposed (3, N) layout — the Lanczos hot matvec.

    u_i = self·F_i + Σ_j [ UF1 F_j + (UF2−UF1)(r̂·F_j) r̂ ]
    (Mobility.cu:632, 673-677).
    """
    n = ft.shape[1]
    zero = jnp.zeros((3, 1), ft.dtype)
    ft_pad = jnp.concatenate([ft, zero], axis=1)       # (3, N+1)
    fx = ft_pad[0][coeffs.nbr]                          # (N, K)
    fy = ft_pad[1][coeffs.nbr]
    fz = ft_pad[2][coeffs.nbr]
    rdotf = coeffs.ex * fx + coeffs.ey * fy + coeffs.ez * fz
    brf = coeffs.bcoef * rdotf
    ux = jnp.sum(coeffs.imrr * fx + brf * coeffs.ex, axis=1)
    uy = jnp.sum(coeffs.imrr * fy + brf * coeffs.ey, axis=1)
    uz = jnp.sum(coeffs.imrr * fz + brf * coeffs.ez, axis=1)
    return self_mobility * ft + jnp.stack([ux, uy, uz], axis=0)


def mreal_matvec(coeffs: PairCoeffs, forces: jax.Array, self_mobility) -> jax.Array:
    """U = M_real · F with (N, 3) in/out (API-boundary wrapper)."""
    return mreal_matvec_t(coeffs, forces.T, self_mobility).T


def mreal_apply(
    pos, forces, nbr_idx, box, table, ewald_cut, ewald_dr, ewald_n, self_mobility
):
    """One-shot U = M_real·F (precompute + matvec)."""
    coeffs = precompute_pair_coeffs(
        pos, nbr_idx, box, table, ewald_cut, ewald_dr, ewald_n
    )
    return mreal_matvec(coeffs, forces, self_mobility)
