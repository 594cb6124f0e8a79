"""Banded near-field: z-sorted columns, rank-band windows, matrix-free matvec.

GPU design of the neighbor-list matvec (gpu_stokes_Mreal_kernel,
Mobility.cu:594-687).  After sorting each (x, y) column of particles by z,
the partners of a particle within ``rcut`` occupy a CONTIGUOUS RANK BAND of
each neighboring column.  So the interactions between a row tile of column c
and column c' = c + o are one (rows x W) window whose W lanes start at a
per-(offset, column, tile) rank ``j0`` computed from the sorted z values
(compute_windows).

Like the reference, the matvec re-evaluates the pair functions on every
call instead of storing pair blocks: each program of the Triton kernel
(matvec_banded) owns one (column, row tile), walks the 9 xy stencil offsets
and the window in 32-lane chunks, gathers the window's coordinates and
forces, evaluates the piecewise-Chebyshev pair functions (ops/chebyshev.py)
in registers and reduces the 3x3 blocks against 1 or 2 right-hand sides.
Every output tile is written once by its own program (forward stencil only,
no atomics), so results are bitwise reproducible per (seed, step).

Layout contract (all built by cellbins.bin_columns):
  * columns are (x, y) cells >= rcut wide (x tilt-inflated), z-sorted;
  * padded slots sort last (mask 0, positions 0);
  * window lanes are CYCLIC ranks of the neighbor column: rank k < n_valid
    is slot k, rank n_valid + k is slot k one period up, so a z-band that
    wraps the periodic box stays contiguous (minimum image handles the
    physics).

matvec_banded_reference is the plain-XLA implementation of the same
semantics: the CPU execution path and the oracle the kernel is tested
against.  Window coverage is checked in compute_windows: any band wider
than W sets a sticky overflow flag, reusing the rewind+regrow machinery of
the other engines (api.Simulation.run).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..box import Box
from ..cellbins import BinSpec, CellBins, roll_cells
from .chebyshev import ChebPair, eval_pair_functions

# Near-field implementations, chosen per platform by select_nf_impl.
NF_TRITON = "triton"          # Pallas kernel compiled through Triton (GPU)
NF_REFERENCE = "reference"    # plain-XLA matvec_banded_reference (CPU)

# Kernel launch shape, measured per call at the N=100k phi=0.45 bench
# geometry on one H100 (PERF.md): 32-lane chunks with 8 warps beat 64-lane
# chunks with 4 warps 1.43x (1 RHS) and 1.63x (2 RHS) — a (32 x 32) tile
# keeps the pair math in registers.
LANE_CHUNK = 32               # window lanes per kernel inner iteration
NUM_WARPS = 8


def select_nf_impl(platform: str | None = None) -> str:
    """The banded near-field implementation for ``platform`` (default: JAX's
    default backend): the Triton kernel on "gpu", the plain-XLA reference on
    "cpu".  Any other platform is an error, never a silent fallback."""
    if platform is None:
        platform = jax.default_backend()
    if platform == "gpu":
        return NF_TRITON
    if platform == "cpu":
        return NF_REFERENCE
    raise ValueError(
        f"no banded near-field implementation for platform {platform!r} "
        "(supported: 'gpu', 'cpu')"
    )


def full_xy_offsets():
    """The 3x3 xy stencil, (0,0) first."""
    half = [(0, 1), (1, -1), (1, 0), (1, 1)]
    return tuple([(0, 0)] + half + [(-ox, -oy) for (ox, oy) in half])


class BandSpec(NamedTuple):
    """Static banded-near-field configuration (hashable, baked into jit)."""

    bins: BinSpec            # n_cells = (ncx, ncy, 1); cap = slots per column
    offsets: tuple           # xy stencil offsets, (0, 0) first
    window: int              # W — band window width (multiple of 64, <= 256)
    rows: int                # R — row-tile height (power of two)


def make_band_spec(
    n_particles: int,
    L,
    rcut: float,
    max_tilt: float = 0.5,
    rows: int = 32,
    ncx_multiple: int = 1,
) -> BandSpec | None:
    """Choose column counts / capacity / window, or None when the geometry
    doesn't support the banded layout (small boxes or sparse columns fall
    back to the dense blocked engine).

    ``ncx_multiple``: round the x column count down to this multiple so the
    column grid divides into equal x-slabs (parallel/halo.py shards one slab
    per device)."""
    L = tuple(float(x) for x in L)
    ncx = int(math.floor(L[0] / (rcut * (1.0 + abs(max_tilt)))))
    ncy = int(math.floor(L[1] / rcut))
    ncx = (ncx // ncx_multiple) * ncx_multiple
    if ncx < max(3, ncx_multiple) or ncy < 3:
        return None

    mu = n_particles / (ncx * ncy)            # mean column occupancy

    # Expected band: ranks within 2*rcut of z, plus the tile extent, plus
    # slack for occupancy fluctuations between neighboring columns
    # (~5 sigma + 10).  Windows are multiples of 64: the matvec's pair
    # evaluations scale with W.
    band = 2.0 * rcut / L[2] * mu

    def w_of(r):
        need = band + r + 5.0 * math.sqrt(max(band, 1.0)) + 10.0
        w = max(64, int(math.ceil(need / 64.0)) * 64)
        # A window that only just fits trips the per-step band fluctuation
        # check (band > W, compute_windows) and regrows mid-run; demand a
        # further ~10-lane margin before accepting a size.
        if w - need < 10.0:
            w += 64
        return w, need

    # rows=32 takes the rows=16 window whenever the 5-sigma need still fits
    # it (one 64-lane chunk saved per tile); grow_config's
    # widen-window-first fallback handles the case where the margin loses.
    if rows == 32:
        w16, _ = w_of(16)
        window, need = w_of(32)
        if window > w16 and need <= w16:
            window = w16
    else:
        window, _ = w_of(rows)

    # 4-sigma Poisson slack: overflow is recoverable (sticky flag ->
    # regrow), so the tail can be tighter than 5 sigma.
    cap = int(math.ceil((mu + 4.0 * math.sqrt(mu) + 8.0) / rows)) * rows
    if window > 256 or cap < window:
        return None                            # banded layout not profitable
    return BandSpec(
        bins=BinSpec(n_cells=(ncx, ncy, 1), cap=cap),
        offsets=full_xy_offsets(),
        window=window,
        rows=rows,
    )


def compute_windows(
    bins: CellBins, spec: BandSpec, box: Box, rcut: float, col_mask=None,
):
    """Per-(offset, column, tile) band window starts in CYCLIC rank
    coordinates.

    For tile t of column c and neighbor column c' = c + o, ranks are counted
    on the cyclic axis [0, n_valid(c') + ...): index k < n_valid is rank k,
    index n_valid + k is rank k again one period up (z + Lz).  Pad slots
    (which sort last) do not exist on this axis, so a z-band that wraps the
    periodic seam stays contiguous.

    Returns (j0 (O, C, T) int32, n_valid (C,) int32, band_overflow bool):
    overflow is set when a tile's band exceeds the effective window
    min(W, n_valid) — the regrow path widens W.
    """
    S = spec.bins.cap
    R = spec.rows
    W = spec.window
    T = S // R
    Lz = box.L[2]
    lo_z = box.lo[2]

    z = jnp.where(bins.mask > 0, bins.pz, jnp.inf)        # (C, S) sorted asc
    n_valid = jnp.sum(bins.mask > 0, axis=1).astype(jnp.int32)   # (C,)
    z_lo = z[:, ::R]                                       # (C, T)
    zt = z.reshape(z.shape[0], T, R)
    z_hi = jnp.max(jnp.where(jnp.isfinite(zt), zt, -jnp.inf), axis=2)

    zb = z_lo - rcut
    shift = jnp.where(zb < lo_z, Lz, 0.0)                  # wrap the band
    zb = zb + shift
    ze = z_hi + rcut + shift
    valid_tile = jnp.isfinite(z_lo)
    if col_mask is not None:
        # halo decomposition (parallel/halo.py): only interior columns'
        # windows are consumed; halo rows may see wrong rolled data
        valid_tile = valid_tile & col_mask[:, None]

    j0s = []
    overflow = jnp.asarray(False)
    for (ox, oy) in spec.offsets:
        zn = roll_cells(z, spec.bins, (ox, oy, 0))         # neighbor column z
        nv = roll_cells(n_valid[:, None], spec.bins, (ox, oy, 0))[:, 0]

        def count_below(thr, zn=zn):
            main = jnp.sum(zn[:, None, :] < thr[:, :, None], axis=2)
            wrap = jnp.sum(zn[:, None, :] + Lz < thr[:, :, None], axis=2)
            return (main + wrap).astype(jnp.int32)

        j0 = count_below(zb)
        j1 = count_below(ze)
        # Cyclic coverage is min(W, n_valid) distinct slots; a band interval
        # longer than Lz double-counts ranks, hence the min with n_valid.
        band = jnp.minimum(j1 - j0, nv[:, None])
        overflow = overflow | jnp.any(valid_tile & (band > W))
        # A window starting past one full period aliases cyclically.
        j0 = jnp.where(j0 >= nv[:, None], j0 - nv[:, None], j0)
        j0s.append(jnp.clip(j0, 0, S))
    return jnp.stack(j0s, axis=0), n_valid, overflow


def neighbor_columns(spec: BandSpec) -> np.ndarray:
    """(O, C) int32: the flat id of column c + offsets[o] (periodic)."""
    ncx, ncy, _ = spec.bins.n_cells
    cols = np.arange(ncx * ncy).reshape(ncx, ncy)
    return np.stack([
        np.roll(cols, (-ox, -oy), axis=(0, 1)).reshape(-1)
        for (ox, oy) in spec.offsets
    ]).astype(np.int32)


def extend_slots(arr: jax.Array, spec: BandSpec) -> jax.Array:
    """(..., C, S) -> (..., C, S + W + 128): append wrap copies of slots
    [0, W + 128), so the reference matvec reads every cyclic window as one
    contiguous slice of the extended slot axis."""
    pad = spec.window + 128
    reps = -(-pad // arr.shape[-1])
    tail = jnp.concatenate([arr] * reps, axis=-1)[..., :pad] if reps > 1 else arr[..., :pad]
    return jnp.concatenate([arr, tail], axis=-1)


def _min_image(dx, dy, dz, tilt, L):
    """Minimum image in the xy-tilted box (box.min_image_components), with
    round-half-up so the Triton kernel (which has no round primitive) and
    the reference evaluate the same expression."""
    img_z = jnp.floor(dz / L[2] + 0.5)
    dz = dz - L[2] * img_z
    img_y = jnp.floor(dy / L[1] + 0.5)
    dy = dy - L[1] * img_y
    dx = dx - tilt * L[1] * img_y
    img_x = jnp.floor(dx / L[0] + 0.5)
    dx = dx - L[0] * img_x
    return dx, dy, dz


def _pair_components(
    xi, yi, zi, mi,            # (..., R, 1) tile coordinates / mask
    xj, yj, zj, mj,            # (..., 1, W) window coordinates
    tilt,                      # scalar
    *,
    L, cheb: ChebPair, cut2: float, dr2: float, same_slot,
):
    """The symmetric RPY-Ewald 3x3 pair tensor's 6 components for one
    (tile, window): blocked_nearfield.build_pair_blocks' formulas
    (Mobility.cu:661-677 semantics with Chebyshev pair functions instead
    of the texture table)."""
    dx, dy, dz = _min_image(xi - xj, yi - yj, zi - zj, tilt, L)
    d2 = dx * dx + dy * dy + dz * dz
    valid = (mi * mj > 0.0) & (d2 < cut2) & (d2 >= dr2) & ~same_slot

    d2_safe = jnp.where(valid, d2, 1.0)
    dist = jnp.sqrt(d2_safe)
    uf1, uf2 = eval_pair_functions(cheb, dist)
    imrr = jnp.where(valid, uf1, 0.0)
    bco = jnp.where(valid, uf2 - uf1, 0.0)
    inv_d = 1.0 / dist
    ex = dx * inv_d
    ey = dy * inv_d
    ez = dz * inv_d
    return (
        imrr + bco * ex * ex,
        bco * ex * ey,
        bco * ex * ez,
        imrr + bco * ey * ey,
        bco * ey * ez,
        imrr + bco * ez * ez,
    )


@partial(
    jax.jit,
    static_argnames=("spec", "cheb", "L", "ewald_cut", "ewald_dr",
                     "self_mobility"),
)
def matvec_banded_reference(
    bins: CellBins,
    tilt_xy,
    spec: BandSpec,
    cheb: ChebPair,
    L: tuple,
    ewald_cut: float,
    ewald_dr: float,
    j0: jax.Array,             # (O, C, T) int32 from compute_windows
    n_valid: jax.Array,        # (C,) int32
    f_cells: jax.Array,        # (3, C, S) — padded slots zero
    self_mobility,
) -> jax.Array:
    """Plain-XLA banded matvec: the same cyclic-window math as the Triton
    kernel, windows materialized with gathers.

    The CPU execution path (select_nf_impl) and the independent oracle the
    kernel is checked against.  Rebuilds pair functions per call.
    """
    ncx, ncy, _ = spec.bins.n_cells
    C = ncx * ncy
    S = spec.bins.cap
    R = spec.rows
    W = spec.window
    T = S // R
    O = len(spec.offsets)
    tilt = jnp.asarray(tilt_xy, jnp.float32)

    posm = jnp.stack([bins.px, bins.py, bins.pz, bins.mask], axis=0)
    posm_ext = extend_slots(posm, spec)                    # (4, C, S_ext)
    f_ext = extend_slots(f_cells.astype(jnp.float32), spec)

    nbr_cols = jnp.asarray(neighbor_columns(spec))         # (O, C)
    nv_nbr = n_valid[nbr_cols]                             # (O, C)
    own = posm.reshape(4, C, T, R)                         # (comp, C, T, R)
    islot = (
        jnp.arange(T, dtype=jnp.int32)[:, None] * R
        + jnp.arange(R, dtype=jnp.int32)
    )                                                      # (T, R)
    SYM = ((0, 1, 2), (1, 3, 4), (2, 4, 5))

    # One offset at a time, and tiles in z-chunks of Tc: the full
    # (O, C, T, R, W) intermediate set is ~10x the per-offset working set,
    # and even one offset's (C, T, R, W) set is ~200 GB at N=1M — chunking
    # the tile axis bounds peak memory to ~6 x C*Tc*R*W floats regardless
    # of N.
    budget = 2 ** 27                                       # ~128M f32 ~ 512MB
    Tc = max(1, min(T, budget // max(1, 6 * C * R * W)))

    def offset_chunk(oi, t0, tc):
        """u contribution (3, C, tc*R) of offset oi, tiles [t0, t0+tc)."""
        nvo = nv_nbr[oi][:, None, None]                    # (C, 1, 1)
        j0c = jax.lax.dynamic_slice_in_dim(j0[oi], t0, tc, axis=1)
        jw = j0c[..., None] + jnp.arange(W, dtype=jnp.int32)   # (C, tc, W)
        use_main = jw < nvo
        idx = jnp.where(use_main, jw, S + jw - nvo)
        lane_ok = jnp.arange(W, dtype=jnp.int32) < nvo
        jslot = jnp.where(use_main, jw, jw - nvo)

        col_idx = nbr_cols[oi][:, None, None]              # (C, 1, 1)
        win = posm_ext[:, col_idx, idx]                    # (4, C, tc, W)
        fw = f_ext[:, col_idx, idx]                        # (3, C, tc, W)
        mj = jnp.where(lane_ok, win[3], 0.0)
        islot_c = jax.lax.dynamic_slice_in_dim(islot, t0, tc, axis=0)
        same = (oi == 0) & (
            jslot[:, :, None, :] == islot_c[None, :, :, None]
        )                                                  # (C, tc, R, W)

        def tile(k):
            o = jax.lax.dynamic_slice_in_dim(own[k], t0, tc, axis=1)
            return o[:, :, :, None]                        # (C, tc, R, 1)

        comps = _pair_components(
            tile(0), tile(1), tile(2), tile(3),
            win[0][:, :, None, :], win[1][:, :, None, :],
            win[2][:, :, None, :], mj[:, :, None, :],
            tilt,
            L=tuple(float(x) for x in L), cheb=cheb,
            cut2=float(ewald_cut) ** 2, dr2=float(ewald_dr) ** 2,
            same_slot=same,
        )                                                  # 6 x (C, tc, R, W)

        fw_b = fw[:, :, :, None, :]                        # (3, C, tc, 1, W)
        uo = []
        for r in range(3):
            acc = (
                comps[SYM[r][0]] * fw_b[0]
                + comps[SYM[r][1]] * fw_b[1]
                + comps[SYM[r][2]] * fw_b[2]
            )
            uo.append(jnp.sum(acc, axis=3).reshape(C, tc * R))
        return jnp.stack(uo, axis=0)                       # (3, C, tc*R)

    u = jnp.zeros((3, C, S), jnp.float32)
    for oi in range(O):
        parts = [
            offset_chunk(oi, t0, min(Tc, T - t0)) for t0 in range(0, T, Tc)
        ]
        u = u + (parts[0] if len(parts) == 1
                 else jnp.concatenate(parts, axis=2))
    return u + self_mobility * f_cells.astype(jnp.float32)


def _matvec_kernel(
    nbr_ref, nv_ref, j0_ref, tilt_ref, px_ref, py_ref, pz_ref, pm_ref, f_ref,
    u_ref, *, spec: BandSpec, cheb: ChebPair, L, cut2: float, dr2: float,
    self_mobility: float, nrhs: int, lanes: int,
):
    """One program = one (column c, row tile t).

    Refs are flat: positions/mask (C·S,), forces/result (3·nrhs·C·S,)
    component-major, the window table (O·C·T,), the neighbor-column table
    (O·C,).  A tile with no particle (t·R >= n_valid[c]) runs no offset and
    stores zeros (its forces are zero, so the self term is too).

    Per offset, the window's W cyclic ranks are walked in ``lanes``-wide
    chunks: rank k maps to slot k (k < n_valid of the neighbor column) or
    slot k - n_valid one period up; lanes past n_valid are masked.  The
    pair block acts as M·f = imrr·f + (bco/d²)·d·(d·f), so neither the unit
    vectors nor the 3x3 tensor are formed.  The self pair (same slot at
    offset 0) is excluded by slot equality, like the reference.
    """
    ncx, ncy, _ = spec.bins.n_cells
    C = ncx * ncy
    S = spec.bins.cap
    R = spec.rows
    W = spec.window
    T = S // R
    O = len(spec.offsets)
    CS = C * S
    NR = 3 * nrhs

    c = pl.program_id(0)
    t = pl.program_id(1)
    base = c * S + t * R
    islot = t * R + jnp.arange(R, dtype=jnp.int32)             # (R,)
    xi = px_ref[pl.ds(base, R)][:, None]
    yi = py_ref[pl.ds(base, R)][:, None]
    zi = pz_ref[pl.ds(base, R)][:, None]
    mi = pm_ref[pl.ds(base, R)][:, None]
    f_own = [f_ref[pl.ds(k * CS + base, R)] for k in range(NR)]
    tilt = tilt_ref[0]
    active = t * R < nv_ref[c]

    def offset_body(o, accs):
        nbr = nbr_ref[o * C + c]
        nvn = nv_ref[nbr]
        j0 = j0_ref[(o * C + c) * T + t]
        accs = list(accs)
        for k0 in range(0, W, lanes):
            w = k0 + jnp.arange(lanes, dtype=jnp.int32)        # (lanes,)
            jw = j0 + w
            jslot = jnp.where(jw < nvn, jw, jw - nvn)
            jslot = jnp.minimum(jnp.maximum(jslot, 0), S - 1)
            idx = nbr * S + jslot
            xj = px_ref[idx][None, :]
            yj = py_ref[idx][None, :]
            zj = pz_ref[idx][None, :]
            mj = jnp.where(w < nvn, pm_ref[idx], 0.0)[None, :]
            dx, dy, dz = _min_image(xi - xj, yi - yj, zi - zj, tilt, L)
            d2 = dx * dx + dy * dy + dz * dz
            same = (o == 0) & (jslot[None, :] == islot[:, None])
            valid = (mi * mj > 0.0) & (d2 < cut2) & (d2 >= dr2) & ~same
            d2s = jnp.where(valid, d2, 1.0)
            uf1, uf2 = eval_pair_functions(cheb, jnp.sqrt(d2s))
            imrr = jnp.where(valid, uf1, 0.0)                  # (R, lanes)
            g = jnp.where(valid, (uf2 - uf1) / d2s, 0.0)
            for r in range(nrhs):
                fx = f_ref[(3 * r) * CS + idx][None, :]
                fy = f_ref[(3 * r + 1) * CS + idx][None, :]
                fz = f_ref[(3 * r + 2) * CS + idx][None, :]
                s = g * (dx * fx + dy * fy + dz * fz)
                accs[3 * r] += jnp.sum(imrr * fx + s * dx, axis=1)
                accs[3 * r + 1] += jnp.sum(imrr * fy + s * dy, axis=1)
                accs[3 * r + 2] += jnp.sum(imrr * fz + s * dz, axis=1)
        return tuple(accs)

    zeros = tuple(jnp.zeros((R,), jnp.float32) for _ in range(NR))
    accs = jax.lax.cond(
        active, lambda: jax.lax.fori_loop(0, O, offset_body, zeros),
        lambda: zeros,
    )
    for k in range(NR):
        u_ref[pl.ds(k * CS + base, R)] = accs[k] + self_mobility * f_own[k]


@partial(
    jax.jit,
    static_argnames=("spec", "cheb", "L", "ewald_cut", "ewald_dr",
                     "self_mobility", "interpret", "lanes", "num_warps"),
)
def matvec_banded(
    bins: CellBins,
    tilt_xy,
    spec: BandSpec,
    cheb: ChebPair,
    L: tuple,
    ewald_cut: float,
    ewald_dr: float,
    j0: jax.Array,             # (O, C, T) int32 from compute_windows
    n_valid: jax.Array,        # (C,) int32
    f_cells: jax.Array,        # (3·nrhs, C, S) — padded slots MUST be zero
    self_mobility,
    interpret: bool = False,
    lanes: int = LANE_CHUNK,
    num_warps: int = NUM_WARPS,
) -> jax.Array:
    """u = M_real · f in column layout (3·nrhs, C, S) through the Triton
    kernel: the pair functions are evaluated in registers on every call
    and shared by the nrhs <= 2 stacked right-hand sides.

    ``interpret=True`` runs the kernel through the Pallas interpreter
    (CPU tests); it is never the default.  ``lanes`` / ``num_warps`` are
    the launch shape (tools/nearfield_ab.py --tune sweeps them)."""
    ncx, ncy, _ = spec.bins.n_cells
    C = ncx * ncy
    S = spec.bins.cap
    R = spec.rows
    W = spec.window
    T = S // R
    NR = f_cells.shape[0]
    nrhs = NR // 3
    assert NR in (3, 6), "matvec_banded takes 1 or 2 right-hand sides"
    assert W % lanes == 0 and S % R == 0

    kernel = partial(
        _matvec_kernel, spec=spec, cheb=cheb, L=tuple(float(x) for x in L),
        cut2=float(ewald_cut) ** 2, dr2=float(ewald_dr) ** 2,
        self_mobility=float(self_mobility), nrhs=nrhs, lanes=lanes,
    )
    u = pl.pallas_call(
        kernel,
        grid=(C, T),
        out_shape=jax.ShapeDtypeStruct((NR * C * S,), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="pse_banded_matvec",
    )(
        jnp.asarray(neighbor_columns(spec).reshape(-1)),
        n_valid.astype(jnp.int32),
        j0.astype(jnp.int32).reshape(-1),
        jnp.asarray(tilt_xy, jnp.float32).reshape(1),
        bins.px.reshape(-1), bins.py.reshape(-1), bins.pz.reshape(-1),
        bins.mask.reshape(-1),
        f_cells.astype(jnp.float32).reshape(-1),
    )
    return u.reshape(NR, C, S)
