"""Stochastic increments: per-particle ψ and Hermitian wave-space grid noise.

Replacement for the Saru counter-based RNG kernels
(Brownian.cu:99-345).  Randomness is keyed as fold_in(key(seed), timestep),
preserving the reference's determinism contract: the draw at a given
(seed, timestep) is independent of simulation history (Brownian.cu:117, 176).

The wave-space noise is built on the full complex grid by construction-level
Hermitization (no conjugate-index scatter): every node gets a uniform draw,
then each node either keeps its draw (canonical generator), takes the
conjugate of its partner's draw, or — if self-conjugate (Nyquist combos) —
keeps a real-only draw scaled by √2 so the per-mode variance stays 1
(Brownian.cu:255-288).  See params.hermitian_noise_maps for the (documented)
deviation from the reference's racy Nyquist-plane handling.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..params import PSEParams, hermitian_noise_maps

SQRT3 = math.sqrt(3.0)
SQRT3D2 = math.sqrt(1.5)
SQRT2 = math.sqrt(2.0)


def particle_noise(key: jax.Array, n: int, dtype=jnp.float32) -> jax.Array:
    """ψ ~ U(-√3, √3)³ per particle: unit variance per component
    (gpu_stokes_BrownianGenerate_kernel, Brownian.cu:99-130).

    The production step draws in the engine-native layout via
    ``particle_noise_t``; this (N, 3) variant is kept for external use and
    the determinism tooling (tools/check_determinism.py)."""
    return jax.random.uniform(key, (n, 3), dtype=dtype, minval=-SQRT3, maxval=SQRT3)


def particle_noise_t(key: jax.Array, shape, dtype=jnp.float32) -> jax.Array:
    """ψ in the engine-native transposed layout: (3, *shape) — same
    distribution as ``particle_noise``; the draw→slot association differs
    (different RNG shape), so trajectories re-randomize across this layout
    version while every statistic is unchanged."""
    return jax.random.uniform(
        key, (3,) + tuple(shape), dtype=dtype, minval=-SQRT3, maxval=SQRT3
    )


def _project_and_scale(f, kvec, W, params, T, dt):
    """Transverse-project the random field and apply the B^{1/2} amplitude
    (shared by the full- and half-spectrum constructions)."""
    n_total = params.n_grid_total
    k2 = jnp.sum(kvec * kvec, axis=-1)
    k2_safe = jnp.where(k2 > 0, k2, 1.0)
    kv = jnp.moveaxis(kvec, -1, 0)
    kdF = jnp.sum(kv * f, axis=0) / k2_safe
    f = f - kv * kdF[None]

    k = jnp.sqrt(k2_safe)
    sinc = jnp.sin(k) / k
    fac = jnp.sqrt(2.0 * T / (dt * params.quadW) * n_total)
    b12 = jnp.sqrt(W) * sinc
    amp = jnp.where(k2 > 0, fac * b12, 0.0)
    return (f * amp[None]).astype(jnp.complex64)


def wave_space_noise_hat_half(
    key: jax.Array,
    params: PSEParams,
    kvec: jax.Array,    # (Nx, Ny, Nzh, 3) from gridk_arrays(..., half=True)
    W: jax.Array,       # (Nx, Ny, Nzh)
    T,
    dt,
) -> jax.Array:
    """Half-spectrum (rfft) random k-space velocity increment.

    Returns (3, Nx, Ny, Nz//2+1) complex64 to add to the Green-scaled rfft
    spectrum before ``irfftn``.  Modes with 0 < kz < Nz/2 are free complex
    draws (their conjugates live in the discarded half-spectrum); the kz=0
    plane — and the kz=Nz/2 plane for even Nz — must be self-Hermitian under
    (i,j) → (−i,−j), which reuses the 3-D conjugate-pair maps with Nz=1.
    Per-mode variances match the full-grid construction exactly.
    """
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    nzh = Nz // 2 + 1
    u = jax.random.uniform(
        key, (6, Nx, Ny, nzh), dtype=jnp.float32, minval=-SQRT3D2, maxval=SQRT3D2
    )
    re, im = u[:3], u[3:]

    conj2, gen2, selfc2, origin2 = hermitian_noise_maps(Nx, Ny, 1)
    conj2 = jnp.asarray(conj2[:, :, 0])           # (Nx, Ny) flat idx = i*Ny+j
    gen2 = jnp.asarray(gen2[:, :, 0])
    selfc2 = jnp.asarray(selfc2[:, :, 0])
    origin2 = jnp.asarray(origin2[:, :, 0])

    def hermitize_plane(re_p, im_p, is_kz0):      # (3, Nx, Ny) each
        re_flat = re_p.reshape(3, -1)
        im_flat = im_p.reshape(3, -1)
        re_h = jnp.where(gen2[None], re_p, re_flat[:, conj2].reshape(3, Nx, Ny))
        im_h = jnp.where(gen2[None], im_p, -im_flat[:, conj2].reshape(3, Nx, Ny))
        # The plane's (0,0) element is the true k=0 mode only on the kz=0
        # plane (zeroed, Brownian.cu:210-215); on the kz=Nz/2 Nyquist plane
        # it is the self-conjugate (0,0,Nz/2) mode — a √2 real draw like the
        # other Nyquist combos (Brownian.cu:255-288).
        selfc_m = selfc2 if is_kz0 else (selfc2 | origin2)
        re_h = jnp.where(selfc_m[None], SQRT2 * re_p, re_h)
        im_h = jnp.where(selfc_m[None], 0.0, im_h)
        if is_kz0:
            re_h = jnp.where(origin2[None], 0.0, re_h)
            im_h = jnp.where(origin2[None], 0.0, im_h)
        return re_h, im_h

    planes = [(0, True)] + ([(nzh - 1, False)] if Nz % 2 == 0 and Nz > 1 else [])
    for pz, is_kz0 in planes:
        rh, ih = hermitize_plane(re[..., pz], im[..., pz], is_kz0)
        re = re.at[..., pz].set(rh)
        im = im.at[..., pz].set(ih)

    f = re + 1j * im
    return _project_and_scale(f, kvec, W, params, T, dt)


def wave_space_noise_hat(
    key: jax.Array,
    params: PSEParams,
    kvec: jax.Array,
    W: jax.Array,
    T,
    dt,
) -> jax.Array:
    """Hermitian random k-space velocity increment, Green^{1/2}-scaled.

    Returns (3, Nx, Ny, Nz) complex64 to be added to the Green-scaled
    deterministic spectrum before the inverse FFTs
    (gpu_stokes_BrownianGridGenerate_kernel, Brownian.cu:153-345).

    Scaling notes: with jnp's normalized ifftn the amplitude carries an extra
    √(Nx·Ny·Nz) relative to the reference's per-mode factor
    sqrt(2T/(dt·quadW))·sqrt(gridk.w)·sinc(k) (which relied on cuFFT's
    unnormalized inverse and gridk.w's baked-in 1/(NxNyNz)).
    """
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    shape = (Nx, Ny, Nz)
    n_total = params.n_grid_total

    conj_np, gen_np, selfc_np, origin_np = hermitian_noise_maps(Nx, Ny, Nz)
    conj_idx = jnp.asarray(conj_np.reshape(-1))
    gen = jnp.asarray(gen_np)
    selfc = jnp.asarray(selfc_np)
    origin = jnp.asarray(origin_np)

    u = jax.random.uniform(
        key, (6,) + shape, dtype=jnp.float32, minval=-SQRT3D2, maxval=SQRT3D2
    )
    re, im = u[:3], u[3:]

    # Hermitize by construction: value at a non-generator node is the
    # conjugate of its partner's draw; self-conjugate nodes are real-only ×√2.
    re_flat = re.reshape(3, n_total)
    im_flat = im.reshape(3, n_total)
    re_part = jnp.where(gen[None], re, re_flat[:, conj_idx].reshape((3,) + shape))
    im_part = jnp.where(gen[None], im, -im_flat[:, conj_idx].reshape((3,) + shape))
    re_part = jnp.where(selfc[None], SQRT2 * re, re_part)
    im_part = jnp.where(selfc[None] | origin[None], 0.0, im_part)
    re_part = jnp.where(origin[None], 0.0, re_part)

    f = re_part + 1j * im_part                       # (3, Nx, Ny, Nz) complex
    return _project_and_scale(f, kvec, W, params, T, dt)
