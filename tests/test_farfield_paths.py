"""Cross-validation of the two far-field factorizations.

The z-column path (ops/column_farfield.py, production) and the stored-W
sweep (ops/blocked_farfield.py, fallback/cross-check) compute the same
Gaussian quadrature (Mobility.cu:114-252 spread, 325-477 contract) through
different factorizations, so they must agree to f32 round-off — tilted
boxes included (the xy factor is kept joint exactly because tilt mixes x
into y).  Also pins the adjointness relation spread/contract share one
kernel for in the reference: ⟨spread(f), g⟩ = ⟨f, contract(g)⟩/quadW.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import pse_tpu as pse
from pse_tpu.box import Box
from pse_tpu.cellbins import bin_particles, vec_from_cells, vec_to_cells
from pse_tpu.ops import blocked_farfield as bff
from pse_tpu.ops import column_farfield as cff


def _setup(n=600, L=24.0, seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    spec = bff.make_ff_spec(params, n, dtype)
    return pos, params, spec, rng


@pytest.mark.parametrize("tilt", [0.0, 0.3, -0.45])
def test_column_farfield_matches_storedw(tilt):
    """z-column far field vs the stored-W sweep, compared in grid space
    (spread) and particle space (contract) — the two paths use different
    binnings, so particle space is the common frame for contract."""
    pos, params, spec_w, rng = _setup(seed=11)
    spec_c = cff.make_col_spec(params, pos.shape[0], "float32")
    assert spec_c is not None
    L = params.L
    box = Box(jnp.asarray(L, jnp.float32), jnp.asarray(tilt, jnp.float32))
    f = rng.normal(size=(pos.shape[0], 3)).astype(np.float32)

    bins_w = bin_particles(jnp.asarray(pos), box, spec_w.bins)
    fc_w = vec_to_cells(bins_w, spec_w.bins, jnp.asarray(f))
    W = bff.build_weights(bins_w, box, spec_w, params)
    g_ref = bff.spread_blocked(bins_w, fc_w, box, spec_w, params, weights=W)

    bins_c = bin_particles(jnp.asarray(pos), box, spec_c.bins)
    fc_c = vec_to_cells(bins_c, spec_c.bins, jnp.asarray(f))
    fac = cff.build_col_factors(bins_c, box, spec_c, params)
    g_col = cff.spread_col(bins_c, fc_c, box, spec_c, params, fac)
    scale = float(jnp.max(jnp.abs(g_ref)))
    np.testing.assert_allclose(
        np.asarray(g_col), np.asarray(g_ref), atol=2e-5 * scale
    )

    gv = jnp.asarray(rng.normal(size=g_ref.shape).astype(np.float32))
    up_ref = vec_from_cells(
        bins_w, spec_w.bins,
        bff.contract_blocked(bins_w, gv, box, spec_w, params, weights=W),
    )
    up_col = vec_from_cells(
        bins_c, spec_c.bins,
        cff.contract_col(bins_c, gv, box, spec_c, params, fac),
    )
    scale = float(jnp.max(jnp.abs(up_ref)))
    np.testing.assert_allclose(
        np.asarray(up_col), np.asarray(up_ref), atol=5e-5 * scale
    )


def test_spread_contract_adjoint():
    """⟨spread(f), g⟩ = ⟨f, contract(g)⟩/quadW for the production column
    path (contract folds quadW·prefac; spread folds prefac only)."""
    pos, params, _, rng = _setup(seed=3)
    spec = cff.make_col_spec(params, pos.shape[0], "float32")
    assert spec is not None
    L = params.L
    box = Box(jnp.asarray(L, jnp.float32), jnp.asarray(0.2, jnp.float32))
    bins = bin_particles(jnp.asarray(pos), box, spec.bins)
    f = rng.normal(size=(pos.shape[0], 3)).astype(np.float32)
    f_cells = vec_to_cells(bins, spec.bins, jnp.asarray(f))
    fac = cff.build_col_factors(bins, box, spec, params)

    grid = cff.spread_col(bins, f_cells, box, spec, params, fac)
    gv = jnp.asarray(rng.normal(size=grid.shape).astype(np.float32))
    u = cff.contract_col(bins, gv, box, spec, params, fac)

    lhs = float(jnp.vdot(grid, gv))
    rhs = float(jnp.vdot(f_cells, u)) / params.quadW
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


def test_column_bf16_grade():
    """Pin the bf16-weight column far field (one of the two dtypes allowed
    at error >= 1e-3, incl. the bf16-rounded H intermediate in
    contract_col) against the f32 path: end-to-end spread/contract error
    must stay at bf16-matmul grade (~1e-3), well inside the error=1e-3
    budget the dtype is gated on (ff_weight_choice)."""
    pos, params, _, rng = _setup(seed=5)
    spec32 = cff.make_col_spec(params, pos.shape[0], "float32")
    spec16 = spec32._replace(weight_dtype="bfloat16")
    L = params.L
    box = Box(jnp.asarray(L, jnp.float32), jnp.asarray(0.25, jnp.float32))
    bins = bin_particles(jnp.asarray(pos), box, spec32.bins)
    f = rng.normal(size=(pos.shape[0], 3)).astype(np.float32)
    f_cells = vec_to_cells(bins, spec32.bins, jnp.asarray(f))
    gv = jnp.asarray(
        rng.normal(size=(3, params.Nx, params.Ny, params.Nz)).astype(np.float32)
    )

    fac32 = cff.build_col_factors(bins, box, spec32, params)
    fac16 = cff.build_col_factors(bins, box, spec16, params)
    assert fac16.wxy.dtype == jnp.bfloat16 and fac16.wz.dtype == jnp.bfloat16

    # Bounds are a GRADE pin on a white-noise grid (the harshest input: no
    # smoothness for roundings to average over).  Measured 2026-08-19:
    # spread max 4.0e-3 / rms 2.7e-3, contract max 5.1e-3 / rms 3.2e-3 —
    # ~15-30% above the pre-H-rounding bf16 path (2.9e-3/4.1e-3 max), same
    # grade.  Smooth physical grids average the per-element roundings down
    # an order (the oracle gate in chip_smoke.py bounds the composed
    # end-to-end error).
    g32 = cff.spread_col(bins, f_cells, box, spec32, params, fac32)
    g16 = cff.spread_col(bins, f_cells, box, spec16, params, fac16)
    err = float(jnp.max(jnp.abs(g16 - g32)) / jnp.max(jnp.abs(g32)))
    assert err < 6e-3, f"bf16 spread error {err:.2e}"
    err = float(jnp.linalg.norm(g16 - g32) / jnp.linalg.norm(g32))
    assert err < 4e-3, f"bf16 spread rms error {err:.2e}"

    u32 = cff.contract_col(bins, gv, box, spec32, params, fac32)
    u16 = cff.contract_col(bins, gv, box, spec16, params, fac16)
    err = float(jnp.max(jnp.abs(u16 - u32)) / jnp.max(jnp.abs(u32)))
    assert err < 6e-3, f"bf16 contract error {err:.2e}"
    err = float(jnp.linalg.norm(u16 - u32) / jnp.linalg.norm(u32))
    assert err < 4e-3, f"bf16 contract rms error {err:.2e}"


@pytest.mark.parametrize("error,full,dtype", [
    (1e-4, True, "float32"),
    (1e-3, False, cff.FAST_FF_WEIGHT_DTYPE),
    (1e-2, False, cff.FAST_FF_WEIGHT_DTYPE),
])
def test_ff_dtype_precision_from_error(error, full, dtype):
    """Far-field dtype and precision come from ``error`` alone: below 1e-3
    f32 at HIGHEST (a GPU would otherwise run f32 products in TF32), at or
    above it the chosen fast dtype at DEFAULT — identically for both
    far-field factorizations."""
    import jax

    params = pse.make_params(xi=0.5, error=error, L=24.0)
    assert cff.ff_weight_choice(error) == (full, dtype)
    for spec in (cff.make_col_spec(params, 600), bff.make_ff_spec(params, 600)):
        assert spec.full_precision == full and spec.weight_dtype == dtype
    assert cff.ff_matmul_precision(full) == (
        jax.lax.Precision.HIGHEST if full else jax.lax.Precision.DEFAULT
    )


def test_ff_dtype_never_asks_the_backend(monkeypatch):
    """Spec construction must not consult the backend; bf16 is refused
    where the error target needs full precision."""
    import jax

    def no_backend(*a, **k):
        raise AssertionError("far-field spec consulted the backend")

    monkeypatch.setattr(jax, "default_backend", no_backend)
    params = pse.make_params(xi=0.5, error=1e-3, L=24.0)
    assert cff.make_col_spec(params, 600, "bfloat16").weight_dtype == "bfloat16"
    assert cff.make_col_spec(params, 600, "float32").weight_dtype == "float32"
    with pytest.raises(ValueError):
        cff.ff_weight_choice(1e-4, "bfloat16")
    params4 = pse.make_params(xi=0.5, error=1e-4, L=24.0)
    with pytest.raises(ValueError):
        bff.make_ff_spec(params4, 600, "bfloat16")


def test_column_is_default_ff_path():
    """make_config wires the z-column far field for banded/blocked engines;
    end-to-end U = M·F agrees with the stored-W fallback."""
    import dataclasses

    from pse_tpu import integrator

    pos, params, _, rng = _setup(n=400, L=26.0)
    cfg = integrator.make_config(params, 400, thermal=False, engine="blocked")
    assert cfg.colff_spec is not None
    f = rng.normal(size=(400, 3)).astype(np.float32)
    u_col, _ = integrator.mobility(cfg, pos, f)

    cfg_no = dataclasses.replace(cfg, colff_spec=None)
    u_w, _ = integrator.mobility(cfg_no, pos, f)
    scale = float(jnp.max(jnp.abs(u_w)))
    np.testing.assert_allclose(
        np.asarray(u_col), np.asarray(u_w), atol=5e-5 * scale
    )
