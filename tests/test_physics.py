"""End-to-end statistical physics validation (SURVEY §4.4).

These are the integration-level oracles the reference relied on its paper
for: the full thermal step must reproduce known equilibrium/transport
physics, not just operator identities.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import pse_tpu as pse
from pse_tpu import box as boxlib


@pytest.mark.parametrize("engine", ["gather", "blocked"])
def test_dilute_self_diffusion(engine):
    """Per-step displacement variance of a dilute thermal suspension matches
    2·D·dt with the periodic-corrected self-diffusion
    D = kT·(1 − 2.837297 a/L + ...) (Hasimoto correction; units 6πηa = a = 1).

    Per-step increments are independent (Euler-Maruyama is memoryless), so
    N·steps·3 ≈ 5e4 square samples give ~1% statistics; E[x²] is unbiased by
    inter-particle correlations.  Runs through BOTH engines so the production
    (blocked + thermal) configuration has end-to-end physics evidence.
    """
    N_side, L, dt, T = 3, 30.0, 5e-3, 1.0
    n = N_side ** 3
    n_steps = 600

    sim = pse.Simulation(
        positions=pse.create_lattice(N_side, L), L=L, dt=dt, sync_every=1
    )
    sim.set_integrator(
        pse.integrate.PSEv1(T=T, seed=7, xi=0.5, error=1e-3),
        verbose=False, engine=engine,
    )
    assert sim.config.engine == engine
    traj = [np.asarray(boxlib.unwrap(sim.box, sim.state.pos, sim.state.images))]

    def collect(s):
        traj.append(
            np.asarray(boxlib.unwrap(s.box, s.state.pos, s.state.images))
        )

    sim.run(n_steps, callback=collect)
    steps = np.diff(np.stack(traj), axis=0)        # (n_steps, n, 3)
    var = (steps ** 2).mean()
    d_meas = var / (2.0 * dt)

    d_expected = T * 1.0 * (1.0 - 2.837297 / L)
    rel = abs(d_meas - d_expected) / d_expected
    assert rel < 0.05, f"D={d_meas:.4f} vs {d_expected:.4f} (rel {rel:.3f})"


def test_harmonic_trap_equilibrium():
    """Particles in a harmonic trap equilibrate to Boltzmann variance kT/k
    (validates the fluctuation-dissipation balance of drift vs noise)."""
    n, L, dt, T, k_spring = 27, 25.0, 2e-3, 0.8, 2.0
    # relaxation time tau = 1/(k·M) ≈ 250 steps: burn 4 tau, sample 8 tau
    n_steps, burn = 2000, 1000

    # One trap per particle, centers 8.3a apart: hydrodynamic coupling is
    # weak, so every mode relaxes at ~tau.  (A tight overlapping cluster
    # would NOT equilibrate: RPY relative mobility vanishes at contact and
    # the relative modes freeze.)
    import jax.numpy as jnp
    centers = jnp.asarray(pse.create_lattice(3, L))
    force_fn = lambda p, t: -k_spring * (p - centers)

    sim = pse.Simulation(
        positions=np.asarray(centers), L=L, dt=dt,
        force_fn=force_fn, sync_every=100,
    )
    sim.set_integrator(
        pse.integrate.PSEv1(T=T, seed=11, xi=0.5, error=1e-3),
        verbose=False, engine="gather",
    )
    sim.run(burn)
    samples = []

    def collect(s):
        samples.append(np.asarray(s.state.pos).copy())

    sim.run(n_steps, callback=collect)
    centers_np = np.asarray(centers)
    pos = np.concatenate([s - centers_np for s in samples], axis=0)
    var = (pos ** 2).mean()

    # Euler-Maruyama with mobility M has stationary variance
    # kT/k · 1/(1 − k·M·dt/2) per component; the correction is tiny here.
    expected = T / k_spring
    rel = abs(var - expected) / expected
    assert rel < 0.15, f"var={var:.4f} vs {expected:.4f} (rel {rel:.3f})"


def test_custom_shear_function_subclass():
    """User-defined ShearFunction subclasses drive the integrator
    (ShearFunctionWrap trampoline parity, ShearFunctionWrap.h:21-38)."""

    class RampShear(pse.shear_function.ShearFunction):
        offset = 0

        def shear_rate(self, timestep):
            return 1e-3 * timestep

        def strain(self, timestep):
            return 0.5e-3 * timestep ** 2 * 1e-3

    sim = pse.Simulation(positions=pse.create_lattice(3, 20.0), L=20.0, dt=1e-3)
    sim.set_integrator(
        pse.integrate.PSEv1(T=0.0, seed=0, xi=0.5, error=1e-3,
                            function_form=RampShear()),
        verbose=False, engine="gather",
    )
    sim.run(5)
    assert int(sim.state.step) == 5


def test_temperature_variant_ramp():
    """T may be a function of the timestep (HOOMD Variant parity)."""
    T_fn = lambda t: 0.5 + 0.5 * jnp.minimum(t / 10.0, 1.0)
    sim = pse.Simulation(positions=pse.create_lattice(3, 20.0), L=20.0, dt=1e-3)
    sim.set_integrator(
        pse.integrate.PSEv1(T=T_fn, seed=2, xi=0.5, error=1e-3),
        verbose=False, engine="gather",
    )
    p0 = np.asarray(sim.state.pos).copy()
    sim.run(8)
    assert np.abs(np.asarray(sim.state.pos) - p0).max() > 1e-4


def test_sedimentation_hasimoto_lattice():
    """Literature pin: sedimentation mobility of a simple-cubic array vs
    Hasimoto's lattice series U/U0 = 1 − 1.7601·φ^{1/3} + φ − 1.5593·φ²
    (H. Hasimoto, J. Fluid Mech. 5, 317 (1959)), the classic dilute-array
    result the Ewald k=0 exclusion (Helper.cu:326 / Brownian.cu:210-215
    semantics) must reproduce.

    Velocities are in the reference's units of F/(6πηa) (self mobility → 1
    as ξ→0, Stokes.cc:315-319), so U/U0 is just the mean z-velocity under
    unit z-forces.  RPY converges to the point-force lattice result from
    above as φ→0; measured agreement: 0.05% at φ=0.01, ~0.3% at φ=0.02
    (and the identity U(N-particle lattice, L) == U(1 particle, L/n_side)
    holds to round-off, checked once during development).
    """
    import math

    from pse_tpu import integrator

    phi = 0.02
    n_side = 4
    n = n_side ** 3
    a_lat = (4.0 / 3.0 * math.pi / phi) ** (1.0 / 3.0)
    L = a_lat * n_side
    g = (np.arange(n_side) + 0.5) * a_lat - L / 2.0
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1).astype(
        np.float32
    )
    f = np.zeros((n, 3), np.float32)
    f[:, 2] = 1.0

    params = pse.make_params(xi=0.7, error=1e-3, L=L)
    cfg = integrator.make_config(
        params, n, thermal=False, engine="blocked", max_tilt=0.0
    )
    u, overflow = integrator.mobility(cfg, pos, f)
    assert not bool(overflow)
    u_sed = float(np.mean(np.asarray(u)[:, 2]))
    c = phi ** (1.0 / 3.0)
    hasimoto = 1.0 - 1.7601 * c + phi - 1.5593 * phi * phi
    assert abs(u_sed - hasimoto) < 0.01 * hasimoto, (
        f"U/U0={u_sed:.4f} vs Hasimoto {hasimoto:.4f}"
    )


def test_dense_suspension_phi045():
    """Dense-suspension pin at the bench regime (φ=0.45): the PRODUCTION
    banded engine against the float64 direct-Ewald oracle and the
    independent gather engine, plus physical-range windows on
    sedimentation hindrance and short-time self-diffusion.

    The reference publishes no numbers (BASELINE.md), so the oracle (exact
    Ewald-summed RPY — the physics the method approximates, Stokes.cc:334-412
    formulas) is the quantitative anchor.  At φ=0.45 the Ewald truncation
    budget (error=1e-3 at the pair level) amplifies through ~65 near-contact
    neighbors per particle: measured engine-vs-oracle deviation is ~1.5e-2
    relative (both engines deviate identically), while the two independent
    engine formulations agree to ~1.6e-3 — so the tight tolerance is on the
    engine cross-check and the looser one on the shared parametrization.
    """
    import math

    import oracles
    from pse_tpu import integrator

    n = 2000
    phi = 0.45
    L = (n * (4.0 / 3.0) * math.pi / phi) ** (1.0 / 3.0)
    rng = np.random.default_rng(12)
    # vacancy-diluted SC lattice: non-overlapping φ=0.45 configuration
    n_side = int(math.ceil(n ** (1.0 / 3.0)))
    a = L / n_side
    g = (np.arange(n_side) + 0.5) * a - L / 2.0
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    keep = np.sort(rng.choice(pos.shape[0], size=n, replace=False))
    pos = (pos[keep] + rng.normal(scale=0.05 * a, size=(n, 3))).astype(
        np.float32
    )

    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    # max_tilt=0: no shear here, and the untilted column width is what
    # lets the banded geometry engage at this small N
    cfg = integrator.make_config(
        params, n, thermal=False, engine="banded", block_dtype="float32",
        max_tilt=0.0,
    )
    assert cfg.engine == "banded", "pin must exercise the production engine"
    cfg_g = integrator.make_config(
        params, n, thermal=False, engine="gather", max_neighbors=256
    )

    # --- sedimentation: uniform unit force on every particle --------------
    f_sed = np.zeros((n, 3), np.float32)
    f_sed[:, 2] = 1.0
    u, overflow = integrator.mobility(cfg, pos, f_sed)
    assert not bool(overflow)
    u_g, overflow_g = integrator.mobility(cfg_g, pos, f_sed)
    assert not bool(overflow_g)
    u_ref = oracles.direct_ewald_velocity(pos, f_sed, params.L, params.xi)
    scale = np.max(np.abs(u_ref))
    # engine cross-check (independent formulations): tight
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(u_g), atol=3e-3 * scale
    )
    # shared Ewald parametrization vs exact float64 sum: dense amplification
    np.testing.assert_allclose(np.asarray(u), u_ref, atol=2.5e-2 * scale)

    # U/U0 in units of F/(6πηa): strong hindrance at φ=0.45 (RPY keeps the
    # far-field part only, so weaker than lubricated Stokes but well < 1).
    u_sed = float(np.mean(np.asarray(u)[:, 2]))
    assert 0.05 < u_sed < 0.4, f"sedimentation U/U0={u_sed:.3f} unphysical"

    # --- short-time self-diffusion: D_s/D0 = ⟨M_ii⟩ (same units) ----------
    # probe particles with unit forces per axis through the oracle-
    # validated production matvec
    probes = rng.choice(n, size=8, replace=False)
    diag = []
    for i in probes[:6]:          # 6 probes x 3 axes keeps CPU time sane
        for k in range(3):
            f = np.zeros((n, 3), np.float32)
            f[i, k] = 1.0
            ui, _ = integrator.mobility(cfg, pos, f)
            diag.append(float(np.asarray(ui)[i, k]))
    # RPY keeps only far-field hydrodynamics, so the suppression is mild
    # compared to lubricated Stokes (measured 0.893 ± 0.001 here); the
    # window pins "hindered but not wildly" and catches sign/scale slips.
    ds = float(np.mean(diag))
    assert 0.75 < ds < 0.97, f"D_s/D0={ds:.3f} out of the RPY dense range"


def test_dense_error_knob_scales_accuracy():
    """End-to-end accuracy must TIGHTEN when the user requests error=1e-4:
    the stricter parametrization (larger rcut/grid, Stokes.cc:135-236
    derivation chain) plus the machinery it flips (tight pair-function
    fit, full-precision far-field dots — integrator.make_config /
    ColFfSpec.full_precision) has to beat the documented ~1.5e-2 dense deviation of
    the error=1e-3 config (test_dense_suspension_phi045) by several× at
    the same φ=0.45 geometry.  Pins that the `error` knob actually buys
    accuracy through the PRODUCTION banded path, not just in unit tests.

    Measured ladder on this geometry (max-abs vs the f64 oracle, 2026-08):
    error=1e-3 → ~1.5e-2, error=1e-4 → 3.4e-3, error=1e-5 → 4.3e-4 — no
    floor; the 1e-4 point is asserted (the 1e-5 config costs another ~5 min
    of CPU for no additional coverage class).
    """
    import math

    import oracles
    from pse_tpu import integrator

    n = 2000
    phi = 0.45
    L = (n * (4.0 / 3.0) * math.pi / phi) ** (1.0 / 3.0)
    rng = np.random.default_rng(12)
    n_side = int(math.ceil(n ** (1.0 / 3.0)))
    a = L / n_side
    g = (np.arange(n_side) + 0.5) * a - L / 2.0
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    keep = np.sort(rng.choice(pos.shape[0], size=n, replace=False))
    pos = (pos[keep] + rng.normal(scale=0.05 * a, size=(n, 3))).astype(
        np.float32
    )
    f_sed = np.zeros((n, 3), np.float32)
    f_sed[:, 2] = 1.0

    params = pse.make_params(xi=0.5, error=1e-4, L=L)
    cfg = integrator.make_config(
        params, n, thermal=False, engine="banded", max_tilt=0.0
    )
    assert cfg.engine == "banded", "must exercise the production engine"
    # error < 1e-3 must auto-select the full-precision far field (f32 at
    # Precision.HIGHEST — no TF32/bf16 floor) and the tight pair-function fit
    assert cfg.colff_spec.full_precision
    assert cfg.colff_spec.weight_dtype == "float32"
    assert cfg.cheb == integrator.fit_pair_functions(
        params.xi, params.ewald_dr, params.ewald_cut, params.radius,
        tol=integrator._cheb_tol("float32"),
    )
    u, overflow = integrator.mobility(cfg, pos, f_sed)
    assert not bool(overflow)
    u_ref = oracles.direct_ewald_velocity(pos, f_sed, params.L, params.xi)
    scale = np.max(np.abs(u_ref))
    dev = float(np.max(np.abs(np.asarray(u) - u_ref))) / scale
    assert dev < 5e-3, (
        f"error=1e-4 config deviates {dev:.2e} from the f64 oracle — no "
        f"better than the error=1e-3 config's ~1.5e-2"
    )
