"""Derived-parameter computation for the PSE method.

Reproduces the derivations of the reference ``Stokes::setParams``
(Stokes.cc:129-424) exactly:

  * real-space cutoff        rcut = sqrt(-ln error) / ξ
  * FFT grid dimensions      from kmax = int(2 sqrt(-ln error) ξ) + 1,
                             rounded up to 2^a·3^b·5^c in [8, 4096]
  * spectral-Ewald Gaussian  (m, P, η) with the shear safety factor
                             λ(max_strain) = 1 + γ²/2 + γ sqrt(1 + γ²/4)
  * self mobility and the float64-generated real-space pair table

plus host-side static helpers the device step needs (spreading prefactors,
Hermitian-noise index maps).  Everything here runs once at setup on the host;
the outputs are immutable numpy/jnp arrays and python scalars baked into the
jitted step as constants.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import jax.numpy as jnp
from scipy.special import erfc

from . import tables

TWO_PI = 2.0 * math.pi


@lru_cache(maxsize=1)
def _grid_size_candidates():
    """All 2^a·3^b·5^c in [8, 4096], ascending (Stokes.cc:147-177)."""
    vals = set()
    p2 = 1
    for _ in range(13):
        p23 = p2
        for _ in range(8):
            p235 = p23
            for _ in range(6):
                if 8 <= p235 <= 4096:
                    vals.add(p235)
                p235 *= 5
            p23 *= 3
        p2 *= 2
    return tuple(sorted(vals))


def round_up_grid_size(n: int) -> int:
    for c in _grid_size_candidates():
        if n <= c:
            return c
    raise ValueError(
        f"Requested grid dimension {n} exceeds the maximum supported size 4096; "
        "reduce xi and try again."
    )


@dataclasses.dataclass(frozen=True)
class PSEParams:
    """Static, host-computed parameters of one PSE configuration.

    Hashable/frozen so it can be a static argument of jitted functions; the
    large table array lives in ``ewald_table`` as a numpy array and is
    converted to a device constant at trace time.
    """

    # user inputs
    xi: float
    error: float
    L: tuple  # (Lx, Ly, Lz)
    max_strain: float
    radius: float = 1.0

    # derived — real space
    ewald_cut: float = 0.0
    ewald_dr: float = 1e-3
    ewald_n: int = 0
    self_mobility: float = 0.0

    # derived — wave space
    Nx: int = 0
    Ny: int = 0
    Nz: int = 0
    gridh: tuple = (0.0, 0.0, 0.0)
    gauss_m: float = 0.0
    gauss_P: int = 0
    eta: float = 0.0

    # tables (not part of hash/eq: deterministic function of the above)
    ewald_table: np.ndarray = dataclasses.field(
        default=None, compare=False, hash=False, repr=False
    )

    def __hash__(self):
        return hash(
            (self.xi, self.error, self.L, self.max_strain, self.radius,
             self.Nx, self.Ny, self.Nz, self.gauss_P)
        )

    @property
    def n_grid_total(self) -> int:
        return self.Nx * self.Ny * self.Nz

    @property
    def quadW(self) -> float:
        return self.gridh[0] * self.gridh[1] * self.gridh[2]

    @property
    def spread_prefac(self) -> float:
        """(2ξ²/(πη))^{3/2} (Mobility.cu:548)."""
        x = 2.0 * self.xi * self.xi / math.pi / self.eta
        return x * math.sqrt(x)

    @property
    def spread_expfac(self) -> float:
        """2ξ²/η (Mobility.cu:549)."""
        return 2.0 * self.xi * self.xi / self.eta

    def summary(self) -> str:
        """Derived-parameter block mirroring the reference's one-time notice
        (Stokes.cc:238-254)."""
        L = self.L
        lines = [
            "--- NUFFT Hydrodynamics Statistics ---",
            f"Mx: {self.Nx}",
            f"My: {self.Ny}",
            f"Mz: {self.Nz}",
            f"rcut: {self.ewald_cut}",
            f"Points per radius (x,y,z): {self.Nx / L[0]}, {self.Ny / L[1]}, {self.Nz / L[2]}",
            "--- Gaussian Spreading Parameters ---",
            f"gauss_m: {self.gauss_m}",
            f"gauss_P: {self.gauss_P}",
            f"gauss_eta: {self.eta}",
            f"gauss_w: {self.gauss_P * self.gridh[0] / 2.0}",
            f"gauss_gridh (x,y,z): {L[0] / self.Nx}, {L[1] / self.Ny}, {L[2] / self.Nz}",
        ]
        return "\n".join(lines)


def make_params(
    xi: float,
    error: float,
    L,
    max_strain: float = 0.5,
    radius: float = 1.0,
    max_grid_total: int = 512 ** 3 * 8,
) -> PSEParams:
    """Compute all derived PSE parameters (mirrors Stokes.cc:129-424).

    ``max_grid_total`` guards pathological configs; the reference caps at
    512³ for cuFFT (Stokes.cc:203-214) — XLA FFT has no such limit, so the
    default allows 8× more before erroring with the same remedy hint.
    """
    if np.isscalar(L):
        L = (float(L),) * 3
    L = tuple(float(x) for x in L)
    xi = float(xi)
    error = float(error)

    # Real space cutoff (Stokes.cc:135)
    ewald_cut = math.sqrt(-math.log(error)) / xi

    # Grid sizing (Stokes.cc:138-199)
    kmax = int(2.0 * math.sqrt(-math.log(error)) * xi) + 1
    dims = []
    for ax in range(3):
        n = int(kmax * L[ax] / TWO_PI * 2.0) + 1
        dims.append(round_up_grid_size(n))
    Nx, Ny, Nz = dims

    if Nx * Ny * Nz > max_grid_total:
        raise ValueError(
            f"Requested number of Fourier nodes {Nx}x{Ny}x{Nz} exceeds "
            f"max_grid_total={max_grid_total}. Reduce xi and try again."
        )

    # Shear safety factor λ(max_strain) (Stokes.cc:216-219)
    gamma = float(max_strain)
    lam = 1.0 + gamma * gamma / 2.0 + gamma * math.sqrt(1.0 + gamma * gamma / 4.0)

    gridh = (L[0] / Nx, L[1] / Ny, L[2] / Nz)

    # Spectral-Ewald Gaussian parameters (Lindbo & Tornberg; Stokes.cc:224-236)
    gauss_m = 1.0
    while erfc(gauss_m / math.sqrt(2.0 * lam)) > error:
        gauss_m += 0.01
    gauss_P = int(gauss_m * gauss_m / math.pi) + 1
    gauss_P = min(gauss_P, Nx, Ny, Nz)  # can't support beyond the grid
    w = gauss_P * gridh[0] / 2.0
    eta = (2.0 * w / gauss_m) ** 2 * (xi * xi)

    # Real-space table (float64 generation, float32 storage)
    ewald_dr = 1e-3
    table, ewald_n = tables.build_ewald_table(xi, ewald_cut, ewald_dr, radius)

    return PSEParams(
        xi=xi,
        error=error,
        L=L,
        max_strain=float(max_strain),
        radius=float(radius),
        ewald_cut=ewald_cut,
        ewald_dr=ewald_dr,
        ewald_n=ewald_n,
        self_mobility=tables.self_mobility(xi, radius),
        Nx=Nx,
        Ny=Ny,
        Nz=Nz,
        gridh=gridh,
        gauss_m=gauss_m,
        gauss_P=gauss_P,
        eta=eta,
        ewald_table=table,
    )


# ---------------------------------------------------------------------------
# Static index maps for the Hermitian wave-space noise (host, once per grid).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def hermitian_noise_maps(Nx: int, Ny: int, Nz: int):
    """Precompute the conjugate-index permutation and node-class masks.

    Vectorized equivalent of the conjugate-pair bookkeeping in
    Brownian.cu:205-261:

      * ``conj_idx``: flat index of the Hermitian partner of each node,
        conj(i,j,k) = ((-i) mod Nx, (-j) mod Ny, (-k) mod Nz).
      * ``is_generator``: nodes in a canonical half-space that carry an
        independent random draw, EXCLUDING the origin.
      * ``is_self_conj``: nodes equal to their own conjugate (Nyquist
        combinations) — these carry a real-only draw scaled by √2.

    Intentional deviation from the reference: the reference's half-space
    condition (Brownian.cu:210-215) admits BOTH members of a conjugate pair
    lying inside a Nyquist plane (e.g. (i, j, Nz/2) and (-i, -j, Nz/2) for
    even Nz), so both threads write both nodes — a data race that doubles the
    variance of those modes when the writes don't collide.  We instead pick
    exactly one generator per pair: the member with the smaller flat index.

    Returns numpy arrays shaped (Nx, Ny, Nz).
    """
    ii = np.arange(Nx)[:, None, None]
    jj = np.arange(Ny)[None, :, None]
    kk = np.arange(Nz)[None, None, :]

    ii_c = (-ii) % Nx
    jj_c = (-jj) % Ny
    kk_c = (-kk) % Nz
    conj_idx = (ii_c * Ny * Nz + jj_c * Nz + kk_c).astype(np.int32)
    conj_idx = np.broadcast_to(conj_idx, (Nx, Ny, Nz)).copy()

    origin = (ii == 0) & (jj == 0) & (kk == 0)
    is_self_conj = (ii == ii_c) & (jj == jj_c) & (kk == kk_c) & ~origin
    is_self_conj = np.broadcast_to(is_self_conj, (Nx, Ny, Nz)).copy()

    # Exactly one generator per conjugate pair: the smaller flat index.
    flat_idx = (ii * Ny * Nz + jj * Nz + kk).astype(np.int64)
    flat_idx = np.broadcast_to(flat_idx, (Nx, Ny, Nz))
    gen = ((flat_idx < conj_idx) | is_self_conj) & ~origin

    origin = np.broadcast_to(origin, (Nx, Ny, Nz)).copy()
    return conj_idx, gen, is_self_conj, origin


def gridk_arrays(params: PSEParams, tilt_xy, dtype=jnp.float32, half: bool = False):
    """Sheared reciprocal-lattice vectors and Green's-function scale.

    Device-side equivalent of gpu_stokes_SetGridk_kernel (Helper.cu:284-332),
    with the reference's 2*3.1416926536 π typo (Helper.cu:313-315) corrected.
    ``tilt_xy`` may be a traced value (changes every step under shear).

    Returns (kvec (Nx,Ny,Nz,3), W (Nx,Ny,Nz)) where W(k) =
    6π (1 + k²/4ξ²) exp(−(1−η) k²/4ξ²) / k², W(0) = 0.  NOTE: unlike the
    reference we do NOT fold the 1/(Nx·Ny·Nz) FFT normalization into W —
    jnp.fft.ifftn is already normalized.

    With ``half=True`` the z axis covers only the rfft half-spectrum
    kz ∈ [0, Nz/2] (length Nz//2 + 1).
    """
    Nx, Ny, Nz = params.Nx, params.Ny, params.Nz
    L = params.L
    xisq = params.xi * params.xi

    def _wrapped(n, N):
        i = jnp.arange(N)
        return jnp.where(i < (N + 1) // 2, i, i - N).astype(dtype)

    wi = _wrapped(Nx, Nx)[:, None, None]
    wj = _wrapped(Ny, Ny)[None, :, None]
    if half:
        Nz_out = Nz // 2 + 1
        wk = jnp.arange(Nz_out, dtype=dtype)[None, None, :]
        Nz = Nz_out
    else:
        wk = _wrapped(Nz, Nz)[None, None, :]

    tilt = jnp.asarray(tilt_xy, dtype=dtype)
    kx = TWO_PI * wi / L[0]
    ky = TWO_PI * (wj - tilt * wi * (L[1] / L[0])) / L[1]
    kz = TWO_PI * wk / L[2]

    kx = jnp.broadcast_to(kx, (Nx, Ny, Nz))
    ky = jnp.broadcast_to(ky, (Nx, Ny, Nz))
    kz = jnp.broadcast_to(kz, (Nx, Ny, Nz))
    k2 = kx * kx + ky * ky + kz * kz

    k2_safe = jnp.where(k2 > 0, k2, 1.0)
    W = (
        6.0
        * jnp.pi
        * (1.0 + k2 / (4.0 * xisq))
        * jnp.exp(-(1.0 - params.eta) * k2 / (4.0 * xisq))
        / k2_safe
    )
    W = jnp.where(k2 > 0, W, 0.0)
    kvec = jnp.stack([kx, ky, kz], axis=-1)
    return kvec, W
