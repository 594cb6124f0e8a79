"""Blocked (cell-dense) engine validation against the gather engine and the
float64 oracle.  The blocked engine is the API's default path; the gather
engine is the independently-validated reference formulation."""

import numpy as np
import jax.numpy as jnp
import pytest

import pse_tpu as pse
from pse_tpu import integrator

import oracles


def _setup(n, L, xi=0.5, tilt=0.0, seed=0, thermal=False):
    rng = np.random.default_rng(seed)
    params = pse.make_params(xi=xi, error=1e-3, L=L)
    box = pse.make_box(L, tilt)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    pos, _ = pse.box.wrap(box, jnp.asarray(pos), jnp.zeros((n, 3), jnp.int32))
    pos = np.asarray(pos)
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    cfg_g = integrator.make_config(params, n, thermal=thermal, engine="gather")
    cfg_b = integrator.make_config(params, n, thermal=thermal, engine="blocked")
    return cfg_g, cfg_b, pos, forces


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def test_blocked_requires_blockable_grid():
    # Large enough box: blocked engine engages.
    _, cfg_b, _, _ = _setup(64, 24.0)
    assert cfg_b.engine == "blocked"
    assert cfg_b.nf_spec is not None and cfg_b.ff_spec is not None


def test_blocked_matches_gather_cubic():
    cfg_g, cfg_b, pos, forces = _setup(128, 26.0, seed=1)
    ug, og = integrator.mobility(cfg_g, pos, forces)
    ub, ob = integrator.mobility(cfg_b, pos, forces)
    assert not bool(og) and not bool(ob)
    assert _rel(ub, ug) < 5e-4


def test_blocked_matches_gather_tilted():
    tilt = 0.35
    cfg_g, cfg_b, pos, forces = _setup(96, 25.0, tilt=tilt, seed=2)
    ug, _ = integrator.mobility(cfg_g, pos, forces, tilt_xy=tilt)
    ub, _ = integrator.mobility(cfg_b, pos, forces, tilt_xy=tilt)
    assert _rel(ub, ug) < 5e-4


def test_blocked_vs_direct_ewald_oracle():
    cfg_g, cfg_b, pos, forces = _setup(48, 18.0, seed=3)
    u, overflow = integrator.mobility(cfg_b, pos, forces)
    assert not bool(overflow)
    u_ref = oracles.direct_ewald_velocity(pos, forces, cfg_b.params.L, cfg_b.params.xi)
    assert _rel(u, u_ref) < 5e-3


def test_blocked_xi_invariance():
    us = []
    for xi in (0.4, 0.6):
        _, cfg_b, pos, forces = _setup(96, 22.0, xi=xi, seed=4)
        u, overflow = integrator.mobility(cfg_b, pos, forces)
        assert not bool(overflow)
        us.append(np.asarray(u))
    assert _rel(us[0], us[1]) < 4e-3


def test_blocked_brownian_matches_gather_statistics():
    """Blocked sqrt(M)·ψ has the same covariance target; spot check the
    deterministic Lanczos machinery by comparing against the gather engine's
    dense M_real (same positions, same operator)."""
    cfg_g, cfg_b, pos, _ = _setup(40, 20.0, seed=5, thermal=True)
    # Dense M via both engines' public matvec must agree, so covariance
    # equality follows from the gather-engine covariance test; here just
    # verify the blocked brownian path runs and is deterministic.
    u1, m1, of1 = integrator.brownian_displacement(cfg_b, pos, 0.0, 3, 2, 1.0, 1e-3)
    u2, m2, of2 = integrator.brownian_displacement(cfg_b, pos, 0.0, 3, 2, 1.0, 1e-3)
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u2))
    assert not bool(of1)
    u3, _, _ = integrator.brownian_displacement(cfg_b, pos, 0.0, 4, 2, 1.0, 1e-3)
    assert np.abs(np.asarray(u1) - np.asarray(u3)).max() > 1e-3


def test_blocked_brownian_covariance():
    """Direct first-class evidence for the production (blocked + thermal)
    path: ⟨uuᵀ⟩ → (2T/dt)·M through the blocked engine's own slot-noise and
    Lanczos plumbing — a slot-masking or ψ-layout bug would show up here
    even though blocked M·F matches gather M·F."""
    _, cfg_b, pos, _ = _setup(32, 18.0, seed=8, thermal=True)
    assert cfg_b.engine == "blocked"
    T, dt = 1.0, 1.0
    n = pos.shape[0]

    cols = []
    for j in range(n):
        for c in range(3):
            e = np.zeros((n, 3), np.float32)
            e[j, c] = 1.0
            u, _ = integrator.mobility(cfg_b, pos, jnp.asarray(e))
            cols.append(np.asarray(u).reshape(-1))
    M = np.stack(cols, axis=1)

    nsamp = 3000
    us = np.stack(
        [
            np.asarray(
                integrator.brownian_displacement(cfg_b, pos, 0.0, s, 2, T, dt)[0]
            ).reshape(-1)
            for s in range(nsamp)
        ]
    )
    cov = us.T @ us / nsamp
    target = 2.0 * T / dt * M
    scale = np.abs(np.diag(target)).max()
    err = np.abs(cov - target).max() / scale
    assert err < 0.12, f"max covariance error {err}"


def test_blocked_step_runs_and_matches_gather_athermal():
    cfg_g, cfg_b, pos, forces = _setup(96, 25.0, seed=6)
    sg = integrator.make_state(pos)
    sb = integrator.make_state(pos)
    fj = jnp.asarray(forces)
    for _ in range(3):
        sg, _ = integrator.step(cfg_g, sg, fj, 0.0, 1e-3, 0.0)
        sb, _ = integrator.step(cfg_b, sb, fj, 0.0, 1e-3, 0.0)
    assert not bool(sb.nbr_overflow)
    np.testing.assert_allclose(
        np.asarray(sb.pos), np.asarray(sg.pos), atol=5e-5
    )


def test_blocked_overflow_flag():
    """Overfull cells must raise the sticky overflow flag."""
    from pse_tpu.cellbins import BinSpec, bin_particles

    rng = np.random.default_rng(7)
    pos = rng.uniform(-5, 5, size=(200, 3)).astype(np.float32)
    box = pse.make_box(10.0)
    bins = bin_particles(jnp.asarray(pos), box, BinSpec(n_cells=(3, 3, 3), cap=8))
    assert bool(bins.overflow)


def test_cellbins_roundtrip():
    from pse_tpu.cellbins import BinSpec, bin_particles, from_cells, to_cells

    rng = np.random.default_rng(8)
    n = 150
    pos = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    box = pse.make_box(20.0)
    spec = BinSpec(n_cells=(4, 4, 4), cap=16)
    bins = bin_particles(jnp.asarray(pos), box, spec)
    assert not bool(bins.overflow)
    vals = rng.normal(size=(n,)).astype(np.float32)
    cells = to_cells(bins, spec, jnp.asarray(vals))
    back = from_cells(bins, spec, cells)
    np.testing.assert_array_equal(np.asarray(back), vals)
    # mask bookkeeping: total valid slots == n
    assert int(np.asarray(bins.mask).sum()) == n


def test_bin_columns_fields_and_values():
    """bin_columns' single windowed scatter: every particle lands in its
    column's slots in ascending z, pad slots carry mask 0 / pid N /
    positions 0, and values riding the binning match vec_to_cells."""
    from pse_tpu.box import make_box
    from pse_tpu.cellbins import BinSpec, bin_columns, vec_to_cells

    rng = np.random.default_rng(11)
    n, L = 400, 24.0
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    vals = rng.normal(size=(n, 3)).astype(np.float32)
    spec = BinSpec(n_cells=(4, 4, 1), cap=48)
    box = make_box((L, L, L), 0.2)
    bins, fcells = bin_columns(jnp.asarray(pos), box, spec,
                               values=jnp.asarray(vals))
    assert not bool(bins.overflow)
    mask = np.asarray(bins.mask) > 0
    assert int(mask.sum()) == n
    pid = np.asarray(bins.pid)
    assert sorted(pid[mask].tolist()) == list(range(n))
    assert (pid[~mask] == n).all()
    assert (np.asarray(bins.px)[~mask] == 0).all()
    for c in range(mask.shape[0]):
        k = int(mask[c].sum())
        assert mask[c, :k].all()                   # valid slots: a prefix
        assert (np.diff(np.asarray(bins.pz)[c, :k]) >= 0).all()
    np.testing.assert_array_equal(
        np.asarray(fcells), np.asarray(vec_to_cells(bins, spec,
                                                    jnp.asarray(vals)))
    )


def test_no_forces_path_matches_zero_forces():
    """The static has_forces=False step (skips det spread/FFT/matvec) must
    reproduce the full step with zero forces."""
    import dataclasses

    _, cfg, pos, _ = _setup(96, 25.0, seed=9, thermal=True)
    cfg0 = dataclasses.replace(cfg, has_forces=False)
    f0 = jnp.zeros((96, 3), jnp.float32)
    s_a = integrator.make_state(pos)
    s_b = integrator.make_state(pos)
    for _ in range(3):
        s_a, _ = integrator.step(cfg, s_a, f0, 1.0, 1e-3, 0.0)
        s_b, _ = integrator.step(cfg0, s_b, f0, 1.0, 1e-3, 0.0)
    np.testing.assert_allclose(
        np.asarray(s_b.pos), np.asarray(s_a.pos), atol=1e-5
    )
