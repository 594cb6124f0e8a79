"""The PSE Brownian-dynamics step: one jitted XLA program per timestep.

Fuses the full pipeline of the reference's hot path (SURVEY.md §3.2;
Stokes.cu:234-365 + Brownian.cu:772-923):

  binning → pair-block build → [spread → FFT → Green (+ Hermitian wave
  noise) → IFFT → contract] + near-field matvec (+ Lanczos real-space noise)
  → Euler update with shear advection → PBC wrap

Two interchangeable engines compute the particle-space operators:

  * "banded": z-sorted columns with a matrix-free near-field matvec
    (ops/banded_nearfield: a Triton kernel on the GPU, the plain-XLA
    reference on the CPU) and the z-column far field — the large-N path.
  * "blocked" (API default): cell-blocked dense math (ops/blocked_*) —
    stencil rolls + batched GEMVs, no large gathers/scatters.
  * "gather": the direct neighbor-list formulation (ops/nearfield,
    ops/farfield) — fewer FLOPs, fine on CPU and for small N; kept as the
    cross-validation reference for the blocked engine.

Shared design notes:
  * Deterministic and stochastic wave-space parts share the FFTs and the
    contraction, exactly like the fused CUDA wrapper (Brownian.cu:831-872).
  * Near-field pair data is computed once per step and reused by the
    deterministic matvec and every Lanczos iteration.
  * Whether the thermal branch exists is a static (compile-time) choice;
    T itself stays a traced runtime value so temperature ramps don't
    recompile.
  * The Lanczos warm-start m and the RNG step counter live in the State
    pytree; randomness is keyed (seed, timestep) — reproducible per step
    regardless of history (Brownian.cu:117, 176).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .box import Box, wrap
from .cellbins import bin_columns, bin_particles, vec_from_cells, vec_to_cells
from .neighbors import NeighborSpec, build_neighbor_list
from .params import PSEParams, gridk_arrays
from .ops import farfield, lanczos, nearfield, noise
from .ops import banded_nearfield as bdn
from .ops import blocked_farfield as bff
from .ops import blocked_nearfield as bnf
from .ops import column_farfield as cff
from .ops.chebyshev import ChebPair, fit_pair_functions


# Lanczos m shrink probe period: the warm-start floor runs >= m_start
# iterations, so m alone is a RATCHET (the reference has the same one-way
# behavior, Brownian.cu:604-736) — one transient spike makes every later
# step pay the spiked iteration count (one near-field matvec each).
# Every K-th step passes m_start-1 instead: if the convergence test passes
# one iteration earlier, the persisted m drops (and can keep dropping on
# later probes); if not, the step runs the same matvec count as before and
# only pays one extra tridiagonal assembly.  K=16 bounds the shrink latency
# at 16 steps per level.
M_SHRINK_PERIOD = 16

# Sticky-overflow bitmask (State.nbr_overflow): which capacity blew, so
# grow_config enlarges only that one (a band-window overflow must not also
# double m_max, and a cell-cap overflow must not widen the band window —
# the near-field matvec's work scales with the window).

OVF_NF = 1        # near-field cell/column capacity
OVF_BAND = 2      # banded window width
OVF_FF = 4        # far-field cell capacity
OVF_LANCZOS = 8   # Lanczos m_max hit unconverged
OVF_NBR = 16      # gather-engine neighbor capacity


def _ovf(flag, bit: int):
    """() bool -> () i32 overflow bit."""
    return jnp.where(flag, jnp.int32(bit), jnp.int32(0))


class State(NamedTuple):
    """Integration state pytree (replaces HOOMD ParticleData for PSE needs)."""

    pos: jax.Array        # (N, 3) f32 — wrapped positions
    images: jax.Array     # (N, 3) i32 — PBC image flags
    step: jax.Array       # () i32 — timestep counter
    tilt_xy: jax.Array    # () f32 — current box xy tilt (strain)
    m_lanczos: jax.Array  # () i32 — Lanczos warm start (Stokes.h:157; init 2)
    nbr_overflow: jax.Array  # () i32 — sticky capacity-overflow bitmask
                             #          (OVF_*; 0 = clean, truthy = overflow)


def make_state(pos, step: int = 0, tilt_xy: float = 0.0) -> State:
    pos = jnp.asarray(pos, jnp.float32)
    return State(
        pos=pos,
        images=jnp.zeros(pos.shape, jnp.int32),
        step=jnp.asarray(step, jnp.int32),
        tilt_xy=jnp.asarray(tilt_xy, jnp.float32),
        m_lanczos=jnp.asarray(2, jnp.int32),
        nbr_overflow=jnp.asarray(0, jnp.int32),
    )


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration baked into the compiled step."""

    params: PSEParams
    nbr_spec: NeighborSpec                 # gather-engine neighbor shapes
    thermal: bool = True                   # compile the Brownian branches
    m_max: int = 100                       # Lanczos cap (Brownian.cu:397)
    seed: int = 0
    engine: str = "gather"                 # "banded" | "blocked" | "gather"
    nf_spec: Optional[bnf.NfSpec] = None
    ff_spec: Optional[bff.FfSpec] = None
    cheb: Optional[ChebPair] = None
    has_forces: bool = True                # compile the deterministic M·F path
    band_spec: Optional[bdn.BandSpec] = None
    colff_spec: Optional[cff.ColFfSpec] = None   # z-column far field (preferred)

    def __post_init__(self):
        # Invariant: a step must compile at least one of the two branches.
        # make_config falls back to has_forces=True for athermal zero-force
        # runs; constructing the bad combo directly (e.g. via
        # dataclasses.replace) must fail loudly rather than silently build
        # a noise-only wave branch with thermal=False.
        if not self.thermal and not self.has_forces:
            raise ValueError(
                "StepConfig with thermal=False requires has_forces=True "
                "(an athermal zero-force step is M·0, like the reference)"
            )

    def __hash__(self):
        return hash(
            (self.params, self.nbr_spec, self.thermal, self.m_max, self.seed,
             self.engine, self.nf_spec, self.ff_spec, self.has_forces,
             self.band_spec, self.colff_spec)
        )


def make_config(
    params: PSEParams,
    n_particles: int,
    thermal: bool = True,
    seed: int = 0,
    m_max: int = 24,
    engine: str = "blocked",
    max_tilt: float | None = None,
    max_neighbors: int | None = None,
    block_dtype: str | None = None,
    has_forces: bool = True,
    shard_slabs: int = 1,
    ff_weight_dtype: str | None = None,
    nbr_subdiv: int = 1,
) -> StepConfig:
    """Build a StepConfig, choosing engine shapes from the density.

    Falls back banded -> blocked -> gather when the box/grid is too small.
    ``shard_slabs``: round the banded column grid to this many x-slabs
    (parallel/halo.py shards one slab per device).
    """
    from .neighbors import make_spec

    if block_dtype is None:
        # bf16 pair blocks (blocked engine) deliver ~5e-4 relative accuracy
        # on U = M·F (f32 self term + f32 accumulation dominate): within
        # error >= 1e-3.  A stricter requested error gets f32 blocks
        # instead of a silent cap at the bf16 floor.  The banded engine
        # stores no blocks; block_dtype only sets its pair-function fit
        # tolerance (_cheb_tol).
        block_dtype = "bfloat16" if params.error >= 1e-3 else "float32"
    elif block_dtype == "bfloat16" and params.error < 1e-3:
        import warnings

        warnings.warn(
            f"bfloat16 pair blocks cap near-field accuracy at ~5e-4, above "
            f"the requested error={params.error:g}; pass "
            f"block_dtype='float32' for full float32 accuracy",
            stacklevel=2,
        )

    max_tilt = params.max_strain if max_tilt is None else max_tilt
    nbr_spec = make_spec(
        n_particles, params.L, params.ewald_cut, max_tilt=max_tilt,
        max_neighbors=max_neighbors, subdiv=nbr_subdiv,
    )

    nf_spec = ff_spec = cheb = band_spec = None
    if engine == "banded":
        # Banded near-field (ops/banded_nearfield.py) + z-column far field
        # (ff_spec kept as the stored-W cross-validation / fallback path).
        ff_spec = bff.make_ff_spec(params, n_particles, ff_weight_dtype)
        band_spec = bdn.make_band_spec(
            n_particles, params.L, params.ewald_cut, max_tilt=max_tilt,
            ncx_multiple=shard_slabs,
        )
        if ff_spec is None or band_spec is None:
            engine = "blocked"                 # geometry too small to band
            ff_spec = band_spec = None
        else:
            cheb = fit_pair_functions(
                params.xi, params.ewald_dr, params.ewald_cut, params.radius,
                tol=_cheb_tol(block_dtype),
            )
    if engine == "blocked":
        ff_spec = bff.make_ff_spec(params, n_particles, ff_weight_dtype)
        nf_spec = bnf.make_nf_spec(
            n_particles, params.L, params.ewald_cut, max_tilt=max_tilt,
            block_dtype=block_dtype,
        )
        if ff_spec is None:
            engine = "gather"
            nf_spec = None
        else:
            cheb = fit_pair_functions(
                params.xi, params.ewald_dr, params.ewald_cut, params.radius,
                tol=_cheb_tol(block_dtype),
            )

    if not thermal and not has_forces:
        # A step with neither forces nor temperature is a no-op; keep the
        # deterministic path (M·0, like the reference) so the step is still
        # well-defined for zero-force athermal runs.
        has_forces = True

    # The z-column far field is the production spread/contract wherever its
    # geometry fits; ff_spec stays as the cross-validation / fallback path.
    colff_spec = None
    if engine in ("banded", "blocked") and ff_spec is not None:
        colff_spec = cff.make_col_spec(params, n_particles, ff_weight_dtype)

    return StepConfig(
        params=params, nbr_spec=nbr_spec, thermal=thermal, m_max=m_max,
        seed=seed, engine=engine, nf_spec=nf_spec, ff_spec=ff_spec, cheb=cheb,
        has_forces=has_forces, band_spec=band_spec, colff_spec=colff_spec,
    )


def _cheb_tol(block_dtype: str) -> float:
    """Pair-function fit tolerance matched to the accuracy class: at
    error >= 1e-3 (bf16 blocks quantize every entry at ~4e-3 relative) a
    3e-5 absolute fit (typically degree 8 instead of 12) adds nothing
    measurable end-to-end and cuts the Clenshaw work per pair."""
    return 3e-5 if block_dtype == "bfloat16" else 1e-6


def grow_config(
    config: StepConfig, factor: float = 1.4, flags: int | None = None
) -> StepConfig:
    """Enlarge the capacities named by the overflow bitmask ``flags``
    (State.nbr_overflow; None grows everything) — host-side; recompiles.

    Selective growth matters: widening the band window grows every
    near-field matvec and doubling m_max inflates every Lanczos eigh, so a
    far-field cell-cap overflow must not trigger them.
    """
    from .neighbors import grow_spec

    if flags is None:
        flags = OVF_NF | OVF_BAND | OVF_FF | OVF_LANCZOS | OVF_NBR
    flags = int(flags)

    changes = {}
    if flags & OVF_NBR:
        changes["nbr_spec"] = grow_spec(config.nbr_spec, factor)
    if flags & OVF_LANCZOS and config.thermal:
        # The per-iteration eigh is O(m_max³) and the basis O(m_max·3N), so
        # the default cap is tight and growth is the recovery path.  100 is
        # the reference's fixed cap (Brownian.cu:397).
        changes["m_max"] = min(max(config.m_max * 2, config.m_max + 8), 100)
    if flags & OVF_NF and config.nf_spec is not None:
        bins = config.nf_spec.bins
        changes["nf_spec"] = config.nf_spec._replace(
            bins=bins._replace(cap=int(-(-bins.cap * factor // 8)) * 8)
        )
    if flags & OVF_FF and config.ff_spec is not None:
        bins = config.ff_spec.bins
        changes["ff_spec"] = config.ff_spec._replace(
            bins=bins._replace(cap=int(-(-bins.cap * factor // 8)) * 8)
        )
    if flags & OVF_FF and config.colff_spec is not None:
        bins = config.colff_spec.bins
        changes["colff_spec"] = config.colff_spec._replace(
            bins=bins._replace(cap=int(-(-bins.cap * factor // 8)) * 8)
        )
    if config.band_spec is not None and flags & (OVF_NF | OVF_BAND):
        bs = config.band_spec
        rows, window = bs.rows, bs.window
        cap = bs.bins.cap
        if flags & OVF_BAND:
            # Preserve the make_band_spec invariant: window <= 256 and
            # cap >= window.  Widen the window first and keep the row
            # tile; shrink rows only when the limits block widening (a
            # persistent overflow then surfaces via Simulation.run's
            # retry limit).
            if window + 64 <= 256 and cap >= window + 64:
                window += 64
            elif rows > 16:
                rows = 16
        if flags & OVF_NF:
            cap = int(-(-cap * factor // rows)) * rows
        cap = max(-(-cap // rows) * rows, window)
        changes["band_spec"] = bs._replace(
            bins=bs.bins._replace(cap=cap), rows=rows, window=window,
        )
    return dataclasses.replace(config, **changes)


def hash_seed(seed: int) -> int:
    """The reference's seed hash (Stokes.cc:102), for parity of spirit."""
    s = (seed * 0x12345677 + 0x12345) & 0xFFFFFFFF
    s ^= s >> 16
    s = (s * 0x45679) & 0xFFFFFFFF
    return s


def _box_of(config: StepConfig, tilt) -> Box:
    return Box(jnp.asarray(config.params.L, jnp.float32), jnp.asarray(tilt, jnp.float32))


# ---------------------------------------------------------------------------
# Engine plumbing: each engine exposes
#   prepare(pos, box)        -> ctx (pair data + binnings), overflow
#   mreal_matvec_t(ctx, ft)  -> (3, n_slots) near-field matvec (flat layout)
#   f_to_slots / u_from_slots: particle (N,3) <-> engine slot layout
#   spread/contract          : particle forces <-> FFT grid
# ---------------------------------------------------------------------------


class _GatherCtx(NamedTuple):
    coeffs: nearfield.PairCoeffs
    taps: farfield.SpreadTaps


class _BlockedCtx(NamedTuple):
    nf_bins: object
    ff_bins: object
    blocks: jax.Array      # (noff, 6, C, cap, cap) stacked pair blocks
    ff_weights: object     # (noff, C, cap, s³) shared NUFFT weights, or None
    nf_f: object = None    # (3, C, cap) forces binned with the positions
    ff_f: object = None    # (3, C_ff, cap_ff) ditto on the far-field grid


class _BandedCtx(NamedTuple):
    nf_bins: object        # z-sorted column bins (cellbins.bin_columns)
    ff_bins: object
    j0: jax.Array          # (O, C, T) i32 band window starts
    n_valid: jax.Array     # (C,) i32 occupied slots per column
    ff_weights: object
    tilt: jax.Array        # () f32 box tilt
    nf_f: object = None    # (3, C, cap) forces binned with the positions
    ff_f: object = None    # (3, C_ff, cap_ff) ditto on the far-field grid


def _rfft3(grid):
    """Forward 3-D rfft over axes (1,2,3) (cuFFT on the GPU)."""
    return jnp.fft.rfftn(grid, axes=(1, 2, 3))


def _irfft3(ghat, s):
    return jnp.fft.irfftn(ghat, s=s, axes=(1, 2, 3))


def _prepare_gather(config, pos, box, forces=None):
    # ``forces`` ignored: the gather engine works in particle layout (its
    # f_slots_t is a transpose), nothing to pre-bin.
    p = config.params
    nlist = build_neighbor_list(pos, box, config.nbr_spec)
    coeffs = nearfield.precompute_pair_coeffs(
        pos, nlist.idx, box, jnp.asarray(p.ewald_table),
        p.ewald_cut, p.ewald_dr, p.ewald_n,
    )
    taps = farfield.compute_taps(pos, box, p)
    return _GatherCtx(coeffs, taps), _ovf(nlist.overflow, OVF_NBR)


def _ff_bin_spec(config):
    """The BinSpec the far-field path bins particles with."""
    if config.colff_spec is not None:
        return config.colff_spec.bins
    return config.ff_spec.bins


def _ff_shared(config, ff_bins, box):
    """Per-step far-field data shared by spread and contract: z-column
    factors (production) or stored-W blocks (fallback/cross-check)."""
    if config.colff_spec is not None:
        return cff.build_col_factors(
            ff_bins, box, config.colff_spec, config.params
        )
    spec = config.ff_spec
    if spec.store_weights:
        return bff.build_weights(ff_bins, box, spec, config.params)
    return None


def _ff_spread(config, ctx, box, forces):
    """Particle forces (N, 3) -> force-moment grid (3, Nx, Ny, Nz).

    ``forces=None`` is the EXPLICIT opt-in for the slot-layout copy
    prepare binned alongside the positions (ctx.ff_f); passing a vector
    always spreads that vector (vec_to_cells), so ad-hoc callers can never
    silently get prepare's forces instead of their own."""
    if forces is None:
        f_cells = ctx.ff_f
        assert f_cells is not None, "spread(None) needs prepare(forces=...)"
    else:
        f_cells = vec_to_cells(ctx.ff_bins, _ff_bin_spec(config), forces)
    if config.colff_spec is not None:
        return cff.spread_col(
            ctx.ff_bins, f_cells, box, config.colff_spec, config.params,
            ctx.ff_weights,
        )
    return bff.spread_blocked(
        ctx.ff_bins, f_cells, box, config.ff_spec, config.params,
        weights=ctx.ff_weights,
    )


def _ff_contract(config, ctx, box, grid_v):
    """Velocity grid -> particle velocities (N, 3)."""
    if config.colff_spec is not None:
        spec = config.colff_spec
        u_cells = cff.contract_col(
            ctx.ff_bins, grid_v, box, spec, config.params, ctx.ff_weights
        )
        return vec_from_cells(ctx.ff_bins, spec.bins, u_cells)
    spec = config.ff_spec
    u_cells = bff.contract_blocked(
        ctx.ff_bins, grid_v, box, spec, config.params,
        weights=ctx.ff_weights,
    )
    return vec_from_cells(ctx.ff_bins, spec.bins, u_cells)


def _prepare_blocked(config, pos, box, forces=None):
    p = config.params
    nf_bins, ff_bins, nf_f, ff_f = _bin_both(
        config, pos, box, config.nf_spec.bins, bin_particles, forces
    )
    blocks = bnf.build_pair_blocks(
        nf_bins, box, config.nf_spec, config.cheb, p.ewald_cut, p.ewald_dr
    )
    ff_weights = _ff_shared(config, ff_bins, box)
    overflow = _ovf(nf_bins.overflow, OVF_NF) | _ovf(ff_bins.overflow, OVF_FF)
    return (
        _BlockedCtx(nf_bins, ff_bins, blocks, ff_weights, nf_f, ff_f),
        overflow,
    )


def _bin_both(config, pos, box, nf_binspec, nf_binner, forces):
    """The two per-step binnings (near-field layout + far-field grid),
    with the step's forces riding each binning sort when given — the
    slot-layout force arrays then come out of the binnings' own scatters
    instead of a separate N-row scatter each (vec_to_cells)."""
    if forces is None:
        nf_bins = nf_binner(pos, box, nf_binspec)
        ff_bins = bin_particles(pos, box, _ff_bin_spec(config))
        return nf_bins, ff_bins, None, None
    nf_bins, nf_f = nf_binner(pos, box, nf_binspec, values=forces)
    ff_bins, ff_f = bin_particles(pos, box, _ff_bin_spec(config),
                                  values=forces)
    return nf_bins, ff_bins, nf_f, ff_f


def _prepare_banded(config, pos, box, forces=None):
    p = config.params
    bs = config.band_spec
    nf_bins, ff_bins, nf_f, ff_f = _bin_both(
        config, pos, box, bs.bins, bin_columns, forces
    )
    j0, n_valid, band_overflow = bdn.compute_windows(
        nf_bins, bs, box, p.ewald_cut
    )
    ff_weights = _ff_shared(config, ff_bins, box)
    overflow = (
        _ovf(nf_bins.overflow, OVF_NF)
        | _ovf(ff_bins.overflow, OVF_FF)
        | _ovf(band_overflow, OVF_BAND)
    )
    return (
        _BandedCtx(nf_bins, ff_bins, j0, n_valid, ff_weights,
                   jnp.asarray(box.tilt_xy, jnp.float32), nf_f, ff_f),
        overflow,
    )


def _nf_cells_of(config, ctx, values):
    """(N, 3) particle values -> (3, C, cap) near-field cell layout."""
    return vec_to_cells(ctx.nf_bins, config.nf_spec.bins, values)


def _nf_cells_back(config, ctx, cells):
    return vec_from_cells(ctx.nf_bins, config.nf_spec.bins, cells)   # (N, 3)


def _engine(config: StepConfig):
    p = config.params

    if config.engine == "gather":

        def mreal_t(ctx, ft):
            return nearfield.mreal_matvec_t(ctx.coeffs, ft, p.self_mobility)

        def mreal_particles(ctx, forces):
            return nearfield.mreal_matvec(ctx.coeffs, forces, p.self_mobility)

        def spread(ctx, box, forces):
            return farfield.spread(ctx.taps, forces, p)

        def contract(ctx, box, grid_v):
            return farfield.contract(ctx.taps, grid_v, p)

        def slots_of_psi(ctx, key, n):
            return noise.particle_noise_t(key, (n,))        # (3, N)

        def psi_result_to_particles(ctx, u):
            return u.T

        def f_slots_t(ctx, values):
            return values.T                                 # (3, N)
    elif config.engine == "banded":
        bs = config.band_spec
        nf_matvec = banded_matvec(config, bdn.select_nf_impl())

        def mreal_t(ctx, cells):
            """(3·nrhs, C, cap) -> same, nrhs <= 2: one pair evaluation
            serves both right-hand sides (step_impl's fused M·F path)."""
            return nf_matvec(ctx.nf_bins, ctx.tilt, bs, ctx.j0, ctx.n_valid,
                             cells)

        def f_slots_t(ctx, values):
            """(N, 3) particle values -> (3, C, cap) slot layout."""
            return vec_to_cells(ctx.nf_bins, bs.bins, values)

        def mreal_particles(ctx, forces):
            cells = vec_to_cells(ctx.nf_bins, bs.bins, forces)
            return vec_from_cells(ctx.nf_bins, bs.bins, mreal_t(ctx, cells))

        def spread(ctx, box, forces):
            return _ff_spread(config, ctx, box, forces)

        def contract(ctx, box, grid_v):
            return _ff_contract(config, ctx, box, grid_v)

        def slots_of_psi(ctx, key, n):
            spec = bs.bins
            C = spec.n_cells[0] * spec.n_cells[1]
            u = noise.particle_noise_t(key, (C, spec.cap))
            return u * ctx.nf_bins.mask.reshape(1, C, spec.cap)

        def psi_result_to_particles(ctx, u):
            return vec_from_cells(ctx.nf_bins, bs.bins, u)   # u: (3, C, cap)
    else:
        nf_spec = config.nf_spec
        ff_spec = config.ff_spec

        def _nf_matvec(ctx, cells):
            return bnf.matvec_cells(
                ctx.blocks, nf_spec, ctx.nf_bins, cells, p.self_mobility
            )

        def mreal_t(ctx, cells):
            return _nf_matvec(ctx, cells)                  # (3, C, cap)

        def mreal_particles(ctx, forces):
            cells = _nf_cells_of(config, ctx, forces)
            return _nf_cells_back(config, ctx, _nf_matvec(ctx, cells))

        def spread(ctx, box, forces):
            return _ff_spread(config, ctx, box, forces)

        def contract(ctx, box, grid_v):
            return _ff_contract(config, ctx, box, grid_v)

        def slots_of_psi(ctx, key, n):
            spec = config.nf_spec.bins
            u = noise.particle_noise_t(key, (spec.n_cells_total, spec.cap))
            return u * ctx.nf_bins.mask.reshape(
                1, spec.n_cells_total, spec.cap
            )

        def psi_result_to_particles(ctx, u):
            return _nf_cells_back(config, ctx, u)          # u: (3, C, cap)

        def f_slots_t(ctx, values):
            return _nf_cells_of(config, ctx, values)       # (3, C, cap)

    class E:
        pass

    e = E()
    e.prepare = {
        "gather": _prepare_gather,
        "banded": _prepare_banded,
        "blocked": _prepare_blocked,
    }[config.engine]
    e.mreal_t = mreal_t
    e.mreal_particles = mreal_particles
    e.spread = spread
    e.contract = contract
    e.slots_of_psi = slots_of_psi
    e.psi_result_to_particles = psi_result_to_particles
    e.f_slots_t = f_slots_t
    # forces pre-binned by prepare(..., forces=...), or None — step_impl /
    # mobility_impl prefer this over the f_slots_t scatter
    e.prepared_f = lambda ctx: getattr(ctx, "nf_f", None)
    if config.engine == "banded":
        e.mreal_t2 = mreal_t                         # takes 2 stacked RHS
    return e


def banded_matvec(config: StepConfig, impl: str):
    """The banded near-field matvec for implementation ``impl``
    (bdn.NF_TRITON or bdn.NF_REFERENCE): a function
    (bins, tilt, spec, j0, n_valid, f (3·nrhs, C, S)) -> u, with the
    physics constants of ``config`` bound.  ``spec`` is passed per call so
    the halo engine can run it on its slab-local grid."""
    p = config.params
    consts = (config.cheb, p.L, p.ewald_cut, p.ewald_dr)
    if impl == bdn.NF_TRITON:
        def matvec(bins, tilt, spec, j0, n_valid, cells):
            return bdn.matvec_banded(bins, tilt, spec, *consts, j0, n_valid,
                                     cells, p.self_mobility)
    elif impl == bdn.NF_REFERENCE:
        def matvec(bins, tilt, spec, j0, n_valid, cells):
            # the reference is single-RHS: one call per stacked 3-row block
            return jnp.concatenate([
                bdn.matvec_banded_reference(
                    bins, tilt, spec, *consts, j0, n_valid, cells[r:r + 3],
                    p.self_mobility,
                )
                for r in range(0, cells.shape[0], 3)
            ], axis=0)
    else:
        raise ValueError(f"unknown banded near-field implementation {impl!r}")
    return matvec


# ---------------------------------------------------------------------------
# Public operators
# ---------------------------------------------------------------------------


def _f_cells(eng, ctx, forces):
    """Forces in near-field slot layout: the copy prepare binned alongside
    the positions when available, else the f_slots_t scatter."""
    pf = getattr(eng, "prepared_f", None)
    cells = pf(ctx) if pf is not None else None
    return eng.f_slots_t(ctx, forces) if cells is None else cells


@partial(jax.jit, static_argnames=("config",))
def mobility(config: StepConfig, pos, forces, tilt_xy=0.0):
    """Deterministic U = M·F — the public validation matvec
    (gpu_stokes_Mobility_wrap, Mobility.cu:729-782).

    Returns (velocities (N,3), capacity_overflow bool).
    """
    return mobility_impl(config, _engine(config), pos, forces, tilt_xy)


def mobility_impl(config: StepConfig, eng, pos, forces, tilt_xy=0.0):
    """``mobility`` body with an injectable engine (parallel/halo.py swaps in
    a shard_map near-field)."""
    p = config.params
    pos = jnp.asarray(pos, jnp.float32)
    forces = jnp.asarray(forces, jnp.float32)
    box = _box_of(config, tilt_xy)

    ctx, overflow = eng.prepare(config, pos, box, forces)
    u0 = eng.mreal_t(ctx, _f_cells(eng, ctx, forces))
    u_real = eng.psi_result_to_particles(ctx, u0)

    kvec, W = gridk_arrays(p, box.tilt_xy, half=True)
    grid = eng.spread(
        ctx, box,
        None if getattr(ctx, "ff_f", None) is not None else forces,
    )
    ghat = _rfft3(grid)
    ghat = farfield.apply_green(ghat, kvec, W)
    grid_v = _irfft3(ghat, (p.Nx, p.Ny, p.Nz))
    u_wave = eng.contract(ctx, box, grid_v.astype(jnp.float32))
    return u_real + u_wave, overflow


@partial(jax.jit, static_argnames=("config",))
def brownian_displacement(config: StepConfig, pos, tilt_xy, step, m_start, T, dt):
    """sqrt(2T/dt)·M^{1/2}·ψ via the positive split: wave part through the
    shared FFT pipeline, real part through Lanczos.  Standalone helper for
    covariance tests; the fused step inlines the same pieces.
    """
    p = config.params
    pos = jnp.asarray(pos, jnp.float32)
    box = _box_of(config, tilt_xy)
    eng = _engine(config)
    key = jax.random.fold_in(
        jax.random.PRNGKey(hash_seed(config.seed)), jnp.asarray(step, jnp.int32)
    )
    k_psi, k_grid = jax.random.split(key)

    ctx, overflow = eng.prepare(config, pos, box)

    kvec, W = gridk_arrays(p, box.tilt_xy, half=True)
    noise_hat = noise.wave_space_noise_hat_half(k_grid, p, kvec, W, T, dt)
    grid_v = _irfft3(noise_hat, (p.Nx, p.Ny, p.Nz))
    u_wave = eng.contract(ctx, box, grid_v.astype(jnp.float32))

    psi = eng.slots_of_psi(ctx, k_psi, pos.shape[0])
    vnorm = jnp.sqrt(jnp.sum(psi * psi))       # matches sqrt_mreal's v₀
    w0 = eng.mreal_t(ctx, psi / vnorm)
    u_sqrt, m_used, hit_cap = lanczos.sqrt_mreal(
        lambda vt: eng.mreal_t(ctx, vt), psi, p.error, m_start,
        config.m_max, w0=w0,
    )
    u_real = jnp.sqrt(2.0 * T / dt) * eng.psi_result_to_particles(ctx, u_sqrt)
    return u_wave + u_real, m_used, overflow | _ovf(hit_cap, OVF_LANCZOS)


@partial(jax.jit, static_argnames=("config",))
def step(
    config: StepConfig,
    state: State,
    forces: jax.Array,
    T,
    dt,
    shear_rate,
    new_tilt=None,
):
    """Advance one Euler-Maruyama step (Stokes.cu:137-192 update semantics).

    Args:
      forces: (N, 3) external/interparticle forces at the current positions.
      T: temperature (traced; the thermal *branch* is config.thermal).
      dt: timestep.
      shear_rate: current shear rate γ̇(t) — adds affine velocity γ̇·y x̂.
      new_tilt: next-step box tilt (wrapped strain); None keeps the current.

    Returns (new_state, info dict with velocities / overflow / m_lanczos).
    """
    return step_impl(
        config, _engine(config), state, forces, T, dt, shear_rate, new_tilt
    )


def step_impl(
    config: StepConfig,
    eng,
    state: State,
    forces: jax.Array,
    T,
    dt,
    shear_rate,
    new_tilt=None,
):
    """``step`` body with an injectable engine (see parallel/halo.py)."""
    p = config.params
    pos = state.pos
    box = _box_of(config, state.tilt_xy)
    n = pos.shape[0]
    T = jnp.asarray(T, jnp.float32)
    dt = jnp.asarray(dt, jnp.float32)

    key = jax.random.fold_in(
        jax.random.PRNGKey(hash_seed(config.seed)), state.step
    )
    k_psi, k_grid = jax.random.split(key)

    # --- pair data + binnings (shared by everything) -----------------------
    with jax.named_scope("pse_prepare"):
        ctx, overflow = eng.prepare(
            config, pos, box, forces if config.has_forces else None
        )

    # --- wave space: spread -> FFT -> Green (+noise) -> IFFT -> contract ---
    # Without external forces (pure Brownian runs, the reference's canonical
    # examples/run.py workload) the deterministic spread, forward FFT, and
    # near-field matvec are all M·0 — skipped statically (the reference
    # computes them anyway, Brownian.cu:836-882).
    kvec, W = gridk_arrays(p, box.tilt_xy, half=True)
    if config.has_forces:
        with jax.named_scope("pse_spread"):
            # None = spread the pre-binned prepare(forces) slots (engines
            # without pre-binning, e.g. gather, have no ctx.ff_f)
            grid = eng.spread(
                ctx, box,
                None if getattr(ctx, "ff_f", None) is not None else forces,
            )
        with jax.named_scope("pse_fft"):
            ghat = _rfft3(grid)
        with jax.named_scope("pse_green"):
            ghat = farfield.apply_green(ghat, kvec, W)
        if config.thermal:
            ghat = ghat + noise.wave_space_noise_hat_half(k_grid, p, kvec, W, T, dt)
    else:
        with jax.named_scope("pse_green"):
            ghat = noise.wave_space_noise_hat_half(k_grid, p, kvec, W, T, dt)
    with jax.named_scope("pse_ifft"):
        grid_v = _irfft3(ghat, (p.Nx, p.Ny, p.Nz))
    with jax.named_scope("pse_contract"):
        u = eng.contract(ctx, box, grid_v.astype(jnp.float32))

    # --- real space: deterministic matvec (+ Lanczos noise) ----------------
    # With forces AND thermal on the banded engine the deterministic M·F
    # rides the step's first Lanczos matvec as a second RHS: one pair
    # evaluation covers both.  v₀ normalization matches
    # lanczos.sqrt_mreal exactly (same expression, same trace).
    fuse2 = (
        config.has_forces
        and config.thermal
        and getattr(eng, "mreal_t2", None) is not None
    )
    m_used = state.m_lanczos
    if config.thermal:
        psi = eng.slots_of_psi(ctx, k_psi, n)
        with jax.named_scope("pse_nearfield"):
            vnorm = jnp.sqrt(jnp.sum(psi * psi))           # psi: (3, C, cap)
            if fuse2:
                ft = jnp.concatenate(
                    [_f_cells(eng, ctx, forces), psi / vnorm], axis=0
                )
            else:
                ft = psi / vnorm
            u0 = (eng.mreal_t2 if fuse2 else eng.mreal_t)(ctx, ft)
            if fuse2:
                u = u + eng.psi_result_to_particles(ctx, u0[0:3])
                w0 = u0[3:6]
            else:
                w0 = u0
                if config.has_forces:
                    # engines without a multi-RHS matvec (gather/blocked);
                    # blocked still consumes the pre-binned force slots
                    # (mreal_particles would redo the vec_to_cells scatter)
                    fc = getattr(eng, "prepared_f", lambda c: None)(ctx)
                    if fc is not None:
                        u = u + eng.psi_result_to_particles(
                            ctx, eng.mreal_t(ctx, fc)
                        )
                    else:
                        u = u + eng.mreal_particles(ctx, forces)
        with jax.named_scope("pse_lanczos"):
            # Shrink probe (see M_SHRINK_PERIOD): every K-th step starts
            # the convergence test one iteration early so the persisted m
            # can DECREASE after a transient spike.
            probe = (state.step % M_SHRINK_PERIOD == 0).astype(jnp.int32)
            u_sqrt, m_used, hit_cap = lanczos.sqrt_mreal(
                lambda vt: eng.mreal_t(ctx, vt),
                psi,
                p.error,
                jnp.maximum(state.m_lanczos - probe, 2),
                config.m_max,
                w0=w0,
            )
        # An unconverged-at-m_max Lanczos is a capacity problem like any
        # other: fold it into the sticky overflow mask so Simulation.run
        # rewinds and regrows (grow_config doubles m_max).
        overflow = overflow | _ovf(hit_cap, OVF_LANCZOS)
        u = u + jnp.sqrt(2.0 * T / dt) * eng.psi_result_to_particles(ctx, u_sqrt)
    elif config.has_forces:
        with jax.named_scope("pse_nearfield"):
            uF = eng.mreal_t(ctx, _f_cells(eng, ctx, forces))
            u = u + eng.psi_result_to_particles(ctx, uF)

    # --- Euler update with shear advection + PBC wrap ----------------------
    vel = u.at[:, 0].add(jnp.asarray(shear_rate, jnp.float32) * pos[:, 1])
    new_pos = pos + vel * dt

    tilt = state.tilt_xy if new_tilt is None else jnp.asarray(new_tilt, jnp.float32)
    new_box = _box_of(config, tilt)
    new_pos, new_images = wrap(new_box, new_pos, state.images)

    new_state = State(
        pos=new_pos,
        images=new_images,
        step=state.step + 1,
        tilt_xy=tilt,
        m_lanczos=jnp.asarray(m_used, jnp.int32),
        nbr_overflow=state.nbr_overflow | overflow,
    )
    info = {"velocities": vel, "nbr_overflow": overflow, "m_lanczos": m_used}
    return new_state, info
