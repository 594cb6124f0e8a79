"""Explicit x-slab decomposition of the banded near-field (shard_map + halo).

GSPMD auto-sharding (parallel/sharding.py) runs the whole step but inserts
all-gathers around the cell-layout rolls; this module shards the COLUMN GRID
of the banded engine (ops/banded_nearfield.py) into contiguous x-slabs, one
per device, and exchanges exactly one column layer per side per matvec with
``jax.lax.ppermute`` (NCCL over NVLink on GPUs) — the analog of an MPI
halo exchange: every near-field matvec runs shard-local on its slab.

Decomposition:
  * columns (C = ncx*ncy, x-major) split along x into D slabs;
  * each device computes windows for its slab PLUS one halo layer per
    side (halo rows are throwaway duplicates — they cost 2/ncx_local extra
    work and keep every kernel call purely local);
  * per matvec, only the slab-boundary position and force columns move
    between devices (2 * ncy * cap * (4 + 3·nrhs) floats per device);
  * far field (blocked NUFFT + FFT) and binning stay GSPMD-global;
  * Lanczos runs on the global sharded vectors — XLA turns its dot products
    into psums.

The reference has no counterpart (single GPU only, Stokes.cc:104-109).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import integrator
from ..box import Box
from ..cellbins import CellBins, bin_columns, bin_particles
from ..ops import banded_nearfield as bdn
from .sharding import particle_sharding, replicated


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


class _HaloCtx(NamedTuple):
    nf_bins: object        # global z-sorted column bins
    ff_bins: object
    j0e: jax.Array         # (O, D*(nxl+2)*ncy, T) windows, slab-extended
    nve: jax.Array         # (D*(nxl+2)*ncy,) valid counts, slab-extended
    ff_weights: object
    tilt: jax.Array        # () f32
    nf_f: object = None    # (3, C, S) forces binned with the positions
    ff_f: object = None    # (3, C_ff, cap_ff) ditto on the far-field grid


def make_halo_engine(config: integrator.StepConfig, mesh: Mesh, axis="dp"):
    """An integrator engine whose near-field runs shard_map'd over x-slabs.

    Requires config.engine == "banded" with ncx divisible by the mesh size
    (make_config(..., shard_slabs=D) rounds the column grid accordingly).
    """
    if config.engine != "banded":
        raise ValueError("halo engine requires the banded near-field")
    # The far field stays GSPMD-global (plain-XLA z-column path); only the
    # near field runs shard_map'd on per-shard arrays.
    bs = config.band_spec
    p = config.params
    ncx, ncy, _ = bs.bins.n_cells
    D = mesh.shape[axis]
    if ncx % D != 0:
        raise ValueError(
            f"ncx={ncx} not divisible by mesh size {D}; build the config "
            f"with make_config(..., shard_slabs={D})"
        )
    nxl = ncx // D
    S = bs.bins.cap
    spec_loc = bs._replace(bins=bs.bins._replace(n_cells=(nxl + 2, ncy, 1)))
    nf_matvec = integrator.banded_matvec(config, bdn.select_nf_impl())
    C_loc = (nxl + 2) * ncy
    perm_fwd = [(i, (i + 1) % D) for i in range(D)]
    perm_bwd = [(i, (i - 1) % D) for i in range(D)]

    def exchange_x(arr, seam_shift=False):
        """(..., nxl*ncy, S) local -> (..., (nxl+2)*ncy, S) with halos.

        ``seam_shift``: for x-COORDINATE arrays — the devices at the
        periodic seam add ∓Lx to the received halo layer so local slab
        coordinates are physically contiguous."""
        a = arr.reshape(arr.shape[:-2] + (nxl, ncy, S))
        left = jax.lax.ppermute(a[..., -1:, :, :], axis, perm_fwd)
        right = jax.lax.ppermute(a[..., :1, :, :], axis, perm_bwd)
        if seam_shift:
            i = jax.lax.axis_index(axis)
            Lx = jnp.float32(p.L[0])
            left = left - jnp.where(i == 0, Lx, 0.0)
            right = right + jnp.where(i == D - 1, Lx, 0.0)
        ext = jnp.concatenate([left, a, right], axis=-3)
        return ext.reshape(arr.shape[:-2] + (C_loc, S))

    def local_bins(px, py, pz, mask):
        return CellBins(
            px=exchange_x(px, seam_shift=True), py=exchange_x(py),
            pz=exchange_x(pz), mask=exchange_x(mask),
            pid=None, cell_of=None, rank_of=None, overflow=None,
        )

    col_spec = P(None, axis, None)

    # ---- shard-local prepare: windows on the extended slab ----------------
    def _local_prepare(px, py, pz, mask, tilt):
        bins_loc = local_bins(px, py, pz, mask)
        box = Box(jnp.asarray(p.L, jnp.float32), tilt)
        # Interior columns are local x in [1, nxl]; halo rows get windows
        # too (their rolls wrap wrongly at slab edges) but their outputs
        # are discarded, so gate the overflow check on the interior.
        cx = jnp.arange(C_loc, dtype=jnp.int32) // ncy
        col_ok = (cx >= 1) & (cx <= nxl)
        j0, nv, ovf = bdn.compute_windows(
            bins_loc, spec_loc, box, p.ewald_cut, col_mask=col_ok,
        )
        return j0, nv, ovf.reshape(1)

    local_prepare = _shard_map(
        _local_prepare, mesh,
        in_specs=(P(axis, None),) * 4 + (P(),),
        out_specs=(col_spec, P(axis), P(axis)),
    )

    # ---- shard-local matvec: halo-exchange f, matvec, slice interior ------
    def _local_matvec(j0_l, nv_l, f_l, px, py, pz, mask, tilt):
        NR = f_l.shape[0]                      # 3·nrhs stacked RHS rows
        u = nf_matvec(local_bins(px, py, pz, mask), tilt, spec_loc, j0_l,
                      nv_l, exchange_x(f_l))
        u = u.reshape(NR, nxl + 2, ncy, S)[:, 1:-1]
        return u.reshape(NR, nxl * ncy, S)

    local_matvec = _shard_map(
        _local_matvec, mesh,
        in_specs=(col_spec, P(axis), col_spec) + (P(axis, None),) * 4
        + (P(),),
        out_specs=col_spec,
    )

    base = integrator._engine(config)

    def prepare(config_, pos, box, forces=None):
        if forces is None:
            nf_bins = bin_columns(pos, box, bs.bins)
            ff_bins = bin_particles(pos, box,
                                    integrator._ff_bin_spec(config))
            nf_f = ff_f = None
        else:
            nf_bins, nf_f = bin_columns(pos, box, bs.bins, values=forces)
            ff_bins, ff_f = bin_particles(
                pos, box, integrator._ff_bin_spec(config), values=forces
            )
        tilt = jnp.asarray(box.tilt_xy, jnp.float32)
        j0e, nve, ovf = local_prepare(
            nf_bins.px, nf_bins.py, nf_bins.pz, nf_bins.mask, tilt
        )
        ff_weights = integrator._ff_shared(config, ff_bins, box)
        overflow = (
            integrator._ovf(nf_bins.overflow, integrator.OVF_NF)
            | integrator._ovf(ff_bins.overflow, integrator.OVF_FF)
            | integrator._ovf(jnp.any(ovf), integrator.OVF_BAND)
        )
        return (
            _HaloCtx(nf_bins, ff_bins, j0e, nve, ff_weights, tilt, nf_f,
                     ff_f),
            overflow,
        )

    def _matvec(ctx, cells):
        b = ctx.nf_bins
        return local_matvec(ctx.j0e, ctx.nve, cells, b.px, b.py, b.pz,
                            b.mask, ctx.tilt)

    def f_slots_t(ctx, values):
        from ..cellbins import vec_to_cells

        return vec_to_cells(ctx.nf_bins, bs.bins, values)

    def mreal_particles(ctx, forces):
        from ..cellbins import vec_from_cells, vec_to_cells

        cells = vec_to_cells(ctx.nf_bins, bs.bins, forces)
        u = _matvec(ctx, cells)
        return vec_from_cells(ctx.nf_bins, bs.bins, u)

    class E:
        pass

    e = E()
    e.prepare = prepare
    e.prepared_f = lambda ctx: ctx.nf_f
    # native (3·nrhs, ncx*ncy, S) in/out, matching base.slots_of_psi; the
    # (6, ...) two-RHS form enables step_impl's fused M·F path
    e.mreal_t = _matvec
    e.mreal_t2 = _matvec
    e.f_slots_t = f_slots_t
    e.mreal_particles = mreal_particles
    e.spread = base.spread
    e.contract = base.contract
    e.slots_of_psi = base.slots_of_psi
    e.psi_result_to_particles = base.psi_result_to_particles
    return e


def make_halo_step(config: integrator.StepConfig, mesh: Mesh, axis="dp"):
    """Jit the full PSE step with the halo near-field engine.

    Same call surface as parallel.sharding.make_sharded_step."""
    eng = make_halo_engine(config, mesh, axis)
    ps = particle_sharding(mesh, axis)
    rs = replicated(mesh)
    state_shardings = integrator.State(
        pos=ps, images=ps, step=rs, tilt_xy=rs, m_lanczos=rs, nbr_overflow=rs
    )

    @partial(
        jax.jit,
        in_shardings=(state_shardings, ps, rs, rs, rs, rs),
        out_shardings=(state_shardings, None),
    )
    def halo_step(state, forces, T, dt, shear_rate, new_tilt):
        return integrator.step_impl(
            config, eng, state, forces, T, dt, shear_rate, new_tilt
        )

    def run(state, forces, T, dt, shear_rate, new_tilt=None):
        tilt = state.tilt_xy if new_tilt is None else jnp.float32(new_tilt)
        return halo_step(
            state, forces, jnp.float32(T), jnp.float32(dt),
            jnp.float32(shear_rate), tilt,
        )

    return run


def make_halo_mobility(config: integrator.StepConfig, mesh: Mesh, axis="dp"):
    """Jit U = M·F with the halo near-field engine."""
    eng = make_halo_engine(config, mesh, axis)
    ps = particle_sharding(mesh, axis)
    rs = replicated(mesh)

    @partial(jax.jit, in_shardings=(ps, ps, rs), out_shardings=(ps, None))
    def halo_mobility(pos, forces, tilt_xy):
        return integrator.mobility_impl(config, eng, pos, forces, tilt_xy)

    def run(pos, forces, tilt_xy=0.0):
        return halo_mobility(pos, forces, jnp.float32(tilt_xy))

    return run
