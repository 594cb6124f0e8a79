"""Chebyshev evaluation of the real-space Ewald RPY pair functions.

The reference (and our gather path) tabulates UF1/UF2 and interpolates via a
texture/gather (Stokes.cc:309-422, Mobility.cu:661-670).  The blocked and
banded engines instead evaluate piecewise Chebyshev fits — a pure FMA
chain in registers with a two-way coefficient select at the r = 2a branch
point (where the functions lose smoothness) — so the pair functions need no
table loads inside a kernel.

Fits are computed host-side in float64 from the exact formulas and certified
against a dense sample; degree is chosen automatically for ~1e-6 absolute
error (well below the table resolution of ~5e-5 and the method's `error`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import tables


class ChebPair(NamedTuple):
    """Static container of piecewise-Chebyshev coefficients (hashable)."""

    lo: float            # domain start (= ewald_dr)
    mid: float           # branch point (min(2a, rcut))
    hi: float            # domain end (= ewald_cut)
    coeffs: tuple        # tuple of 4 coefficient tuples:
                         # (uf1_lo, uf2_lo, uf1_hi, uf2_hi), padded equal len

    @property
    def degree(self) -> int:
        return len(self.coeffs[0]) - 1


def _fit_piece(fn, a: float, b: float, max_deg: int = 48, tol: float = 1e-6):
    """Chebyshev fit of fn on [a, b] in float64 with certified max error."""
    for deg in range(8, max_deg + 1, 4):
        nodes = np.cos(np.pi * (np.arange(deg + 1) + 0.5) / (deg + 1))
        r = 0.5 * (b - a) * (nodes + 1.0) + a
        series = np.polynomial.chebyshev.Chebyshev.fit(
            r, fn(r), deg, domain=[a, b]
        )
        check = np.linspace(a, b, 4001)
        err = np.abs(series(check) - fn(check)).max()
        if err < tol:
            return series.coef, err
    return series.coef, err  # best effort; caller may assert


@lru_cache(maxsize=16)
def fit_pair_functions(
    xi: float, ewald_dr: float, ewald_cut: float, radius: float = 1.0,
    tol: float = 1e-6,
) -> ChebPair:
    """Fit UF1/UF2 on [ewald_dr, 2a] ∪ [2a, ewald_cut] (or one piece if the
    cutoff is inside the overlap region)."""
    mid = min(2.0 * radius, ewald_cut)

    def uf1(r):
        return tables.real_space_pair_functions(r, xi, radius)[0]

    def uf2(r):
        return tables.real_space_pair_functions(r, xi, radius)[1]

    pieces = []
    errs = []
    for fn in (uf1, uf2):
        c, err = _fit_piece(fn, ewald_dr, mid, tol=tol)
        pieces.append(c)
        errs.append(err)
    if ewald_cut > mid:
        for fn in (uf1, uf2):
            c, err = _fit_piece(fn, mid, ewald_cut, tol=tol)
            pieces.append(c)
            errs.append(err)
    else:
        pieces.extend(pieces[:2])

    max_err = float(np.max(errs))
    if max_err > 10 * tol:
        raise RuntimeError(
            f"Chebyshev fit of real-space pair functions failed: err={max_err}"
        )

    deg = max(len(c) for c in pieces)
    padded = tuple(
        tuple(float(x) for x in np.pad(c, (0, deg - len(c)))) for c in pieces
    )
    return ChebPair(lo=float(ewald_dr), mid=float(mid), hi=float(ewald_cut),
                    coeffs=padded)


def eval_pair_functions(cheb: ChebPair, r: jax.Array):
    """(UF1(r), UF2(r)) via Clenshaw recurrence with a branch select.

    Out-of-domain r (r < lo or r >= hi) must be masked by the caller; values
    returned there are extrapolations.
    """
    lo, mid, hi = cheb.lo, cheb.mid, cheb.hi
    in_lo = r < mid

    # Map r -> t in [-1, 1] for the active piece.
    t_lo = (2.0 * r - (lo + mid)) / (mid - lo)
    t_hi = (2.0 * r - (mid + hi)) / (hi - mid) if hi > mid else t_lo
    t = jnp.where(in_lo, t_lo, t_hi)
    t2 = 2.0 * t

    # Coefficients stay python floats (indexed statically): XLA folds them
    # into the kernel as immediates, and Pallas kernels reject captured
    # constant arrays, so no jnp arrays are built here.
    c1_lo, c2_lo, c1_hi, c2_hi = cheb.coeffs

    def clenshaw(c_lo_arr, c_hi_arr):
        deg = len(c_lo_arr) - 1
        b1 = jnp.zeros_like(t)
        b2 = jnp.zeros_like(t)
        for k in range(deg, 0, -1):
            ck = jnp.where(in_lo, c_lo_arr[k], c_hi_arr[k])
            b1, b2 = ck + t2 * b1 - b2, b1
        c0 = jnp.where(in_lo, c_lo_arr[0], c_hi_arr[0])
        return c0 + t * b1 - b2

    return clenshaw(c1_lo, c1_hi), clenshaw(c2_lo, c2_hi)
