"""Headline benchmark: particle-steps/sec, dense suspension, one GPU.

Config 4 of BASELINE.json: N=100k spheres at volume fraction φ=0.45, kT>0,
positions drawn as a vacancy-diluted simple-cubic lattice (non-overlapping,
the physically meaningful φ=0.45 configuration).  Two workloads are measured:

  * brownian     — no external forces (the reference's canonical
                   examples/run.py workload; the M·0 deterministic path is
                   compiled out, exactly as a user would run it);
  * with-forces  — has_forces=True with a fixed random force array, which
                   exercises the full fused pipeline: spread + forward FFT +
                   near-field M·F on top of the Brownian machinery.

Steps run as device-side lax.scan chunks of 200 (launch overhead
amortized, like Simulation.run).  Prints ONE JSON line (the brownian
headline); the breakdown, including the with-forces number and an optional
ξ sweep (--sweep), goes to stderr with the card's name and power limit.
Fails on a non-GPU device.

Baseline: the reference publishes no numbers (BASELINE.md); the north-star
target is 1e7 particle-steps/sec, so vs_baseline = value / 1e7.
"""

import argparse
import json
import math
import sys
import time

import numpy as np


def make_positions(n, phi, seed=0):
    """Vacancy-diluted SC lattice at volume fraction φ (non-overlapping)."""
    vol = n * (4.0 / 3.0) * math.pi / phi
    L = vol ** (1.0 / 3.0)
    n_side = int(math.ceil(n ** (1.0 / 3.0)))
    a = L / n_side
    grid = (np.arange(n_side) + 0.5) * a - L / 2.0
    x, y, z = np.meshgrid(grid, grid, grid, indexing="ij")
    pos = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    rng = np.random.default_rng(seed)
    keep = rng.choice(pos.shape[0], size=n, replace=False)
    pos = pos[np.sort(keep)]
    pos += rng.normal(scale=0.05 * a, size=pos.shape)   # break lattice symmetry
    return pos.astype(np.float32), L


def run_bench(n=100_000, phi=0.45, xi=0.5, has_forces=False, n_warm=1,
              n_steps=400, chunk=200, seed=0, engine="banded"):
    import jax
    import jax.numpy as jnp
    import pse_tpu as pse
    from pse_tpu import integrator
    from pse_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    pos, L = make_positions(n, phi, seed)
    params = pse.make_params(xi=xi, error=1e-3, L=L)
    config = integrator.make_config(
        params, n, thermal=True, seed=1, engine=engine,
        has_forces=has_forces,
    )
    state = integrator.make_state(pos)
    rng = np.random.default_rng(seed + 1)
    forces = (
        jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
        if has_forces
        else jnp.zeros((n, 3), jnp.float32)
    )

    T = jnp.float32(1.0)
    dt = jnp.float32(1e-3)
    rate = jnp.float32(0.0)

    def make_chunk(cfg):
        @jax.jit
        def run_chunk(state):
            def body(s, _):
                new_s, _info = integrator.step(cfg, s, forces, T, dt, rate)
                return new_s, None
            final, _ = jax.lax.scan(body, state, None, length=chunk)
            return final
        return run_chunk

    run_chunk = make_chunk(config)
    n_chunks = max(1, n_steps // chunk)
    for grow in range(4):
        for _ in range(n_warm):
            state = run_chunk(state)
        np.asarray(state.pos)  # materialize before timing
        phase = "warmup"
        if not bool(state.nbr_overflow):
            t0 = time.perf_counter()
            for _ in range(n_chunks):
                state = run_chunk(state)
            np.asarray(state.pos)
            elapsed = time.perf_counter() - t0
            # an overflow first hit DURING the timed steps means windows
            # clipped (dropped pairs) — the timing is of a wrong program;
            # regrow and re-time like a warmup overflow
            if not bool(state.nbr_overflow):
                break
            phase = "timed steps"
        # lattice commensuration or drift can exceed the capacity slack at
        # some xi; grow like Simulation.run (fresh compile per retry), only
        # the capacities the overflow mask names
        flags = int(state.nbr_overflow)
        config = integrator.grow_config(config, flags=flags)
        state = integrator.make_state(pos)
        run_chunk = make_chunk(config)
        print(f"# capacity overflow at xi={xi} in {phase} (mask={flags:#x}): "
              "grew spec, retrying", file=sys.stderr)
    else:
        raise RuntimeError("capacity overflow persists after growth")

    steps_per_sec = n_chunks * chunk / elapsed
    return {
        "workload": "with-forces" if has_forces else "brownian",
        "xi": xi,
        "grid": (params.Nx, params.Ny, params.Nz),
        "rcut": params.ewald_cut,
        "engine": config.engine,
        "nf_spec": config.nf_spec and (config.nf_spec.bins.n_cells, config.nf_spec.bins.cap),
        "steps_per_sec": steps_per_sec,
        "particle_steps_per_sec": steps_per_sec * n,
        "m_lanczos": int(state.m_lanczos),
    }


def correctness_check(rel_tol=2e-3):
    """Assert the banded engine (Triton near-field kernel) against the
    independent blocked engine ON THE CARD before any timing — a kernel
    regression fails the bench, not a human reading its output:

      * untilted + TILTED box (tilt is traced — same compiled program);
        uniform fill guarantees bands that wrap the z seam at the
        boundary tiles (cyclic window + aliased-j0 paths);
      * a W=192 window (the regrow path: three lane chunks per offset);
      * the 2-RHS matvec vs two single matvecs (the step's fuse2 path);
      * the composed end-to-end error vs the float64 direct-Ewald oracle
        (tests/data/oracle_gate.npz, made by tools/make_oracle_gate.py).
    """
    import dataclasses
    import os

    import jax
    import jax.numpy as jnp
    import pse_tpu as pse
    from pse_tpu import integrator
    from pse_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    n, L = 5300, 40.0
    rng = np.random.default_rng(42)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg_b = integrator.make_config(params, n, thermal=False, engine="banded")
    assert cfg_b.engine == "banded", "check config too small for banded"
    cfg_d = integrator.make_config(params, n, thermal=False, engine="blocked")

    def cross_check(name, cfg, p, f, tilt, tol=rel_tol):
        u_b, ov_b = integrator.mobility(cfg, p, f, tilt)
        u_d, ov_d = integrator.mobility(cfg_d, p, f, tilt)
        # an overflowed program dropped pairs — comparing it is meaningless
        assert not int(ov_b) and not int(ov_d), (
            f"gate config [{name}] overflowed (banded={int(ov_b):#x}, "
            f"blocked={int(ov_d):#x}) — fix the gate geometry"
        )
        err = float(jnp.max(jnp.abs(u_b - u_d)) / jnp.max(jnp.abs(u_d)))
        print(f"# correctness [{name}]: banded vs blocked rel err "
              f"{err:.2e} (tol {tol:g})", file=sys.stderr)
        if not err < tol:
            raise AssertionError(
                f"banded engine disagrees with the blocked engine "
                f"[{name}]: rel err {err:.3e} > {tol:g}"
            )

    cross_check("untilted", cfg_b, pos, forces, 0.0)
    cross_check("tilted", cfg_b, pos, forces, 0.3)
    bs = cfg_b.band_spec
    assert bs.bins.cap >= 192, "W=192 gate config needs cap >= window"
    cfg_w = dataclasses.replace(cfg_b, band_spec=bs._replace(window=192))
    cross_check("W=192", cfg_w, pos, forces, 0.0)

    eng = integrator._engine(cfg_b)

    @jax.jit
    def two_vs_single(p, fa, fb):
        box = integrator._box_of(cfg_b, 0.0)
        ctx, ovf = eng.prepare(cfg_b, p, box)
        ca = eng.f_slots_t(ctx, fa)
        cb = eng.f_slots_t(ctx, fb)
        u2 = eng.mreal_t2(ctx, jnp.concatenate([ca, cb], axis=0))
        return u2, eng.mreal_t(ctx, ca), eng.mreal_t(ctx, cb), ovf

    forces_b = rng.normal(size=(n, 3)).astype(np.float32)
    u2, ua, ub, ovf = two_vs_single(
        jnp.asarray(pos), jnp.asarray(forces), jnp.asarray(forces_b)
    )
    u1 = jnp.concatenate([ua, ub], axis=0)
    err = float(jnp.max(jnp.abs(u2 - u1)) / jnp.max(jnp.abs(u1)))
    print(f"# correctness [2-RHS]: two-RHS vs singles rel err {err:.2e} "
          "(tol 1e-6)", file=sys.stderr)
    if not err < 1e-6:
        raise AssertionError(
            f"2-RHS matvec disagrees with two singles: rel err {err:.3e}"
        )

    data = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "data", "oracle_gate.npz"))
    pos_o = np.asarray(data["pos"], np.float32)
    params_o = pse.make_params(xi=float(data["xi"]), error=1e-3,
                               L=float(data["L"]))
    cfg_o = integrator.make_config(params_o, int(data["n"]), thermal=False,
                                   engine="banded")
    u_o, ov_o = integrator.mobility(cfg_o, pos_o,
                                    np.asarray(data["forces"], np.float32))
    assert not int(ov_o), "oracle gate config overflowed"
    u_ref = np.asarray(data["u_ref"])
    rel = float(np.linalg.norm(np.asarray(u_o) - u_ref)
                / np.linalg.norm(u_ref))
    print(f"# correctness [f64 oracle]: composed end-to-end rel err "
          f"{rel:.2e} (tol 5e-3, engine={cfg_o.engine})", file=sys.stderr)
    if not rel < 5e-3:
        raise AssertionError(
            f"composed mobility disagrees with the f64 direct-Ewald "
            f"oracle: rel err {rel:.3e} > 5e-3"
        )


def sweep_residual(xi, n=5000, phi=0.45, rel_tol=2e-3):
    """Small-N banded-vs-blocked residual at a sweep point's OWN ξ/geometry
    (the gate runs only ξ=0.5): a config-dependent kernel bug (the
    roll-hazard class) must fail the sweep point, not silently time a
    wrong program.  Returns the residual for BENCH_DETAILS.json."""
    import jax.numpy as jnp
    import pse_tpu as pse
    from pse_tpu import integrator

    pos, L = make_positions(n, phi, seed=7)
    rng = np.random.default_rng(11)
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    params = pse.make_params(xi=xi, error=1e-3, L=L)
    cfg_b = integrator.make_config(params, n, thermal=False, engine="banded")
    if cfg_b.engine != "banded":
        return None                     # geometry too small to band at this ξ
    cfg_d = integrator.make_config(params, n, thermal=False, engine="blocked")
    u_b, _ = integrator.mobility(cfg_b, pos, forces)
    u_d, _ = integrator.mobility(cfg_d, pos, forces)
    err = float(jnp.max(jnp.abs(u_b - u_d)) / jnp.max(jnp.abs(u_d)))
    print(f"# sweep residual xi={xi}: banded vs blocked rel err {err:.2e}",
          file=sys.stderr)
    if not err < rel_tol:
        raise AssertionError(
            f"banded kernels disagree with blocked at xi={xi}: "
            f"rel err {err:.3e} > {rel_tol:g}"
        )
    return err


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep xi (each point is a fresh compile)")
    ap.add_argument("--skip-check", action="store_true",
                    help="skip the on-card correctness assert")
    args = ap.parse_args()

    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "nvidia_smi": smi}
    print(f"# device: {json.dumps(device)}", file=sys.stderr)

    if not args.skip_check:
        correctness_check()

    results = []
    for has_forces in (False, True):
        r = run_bench(has_forces=has_forces)
        results.append(r)
        print(f"# {r['workload']:12s} xi={r['xi']}: "
              f"{r['particle_steps_per_sec']:.3g} particle-steps/s "
              f"(m={r['m_lanczos']})", file=sys.stderr)
    if args.sweep:
        for xi in (0.55, 0.6, 0.65, 0.7, 0.75):
            rel = sweep_residual(xi)
            r = run_bench(xi=xi)
            r["rel_err"] = rel
            results.append(r)
            print(f"# {r['workload']:12s} xi={r['xi']}: "
                  f"{r['particle_steps_per_sec']:.3g} particle-steps/s",
                  file=sys.stderr)
    print("# details: " + json.dumps({"device": device, "results": results}),
          file=sys.stderr)

    headline = results[0]
    print(
        json.dumps(
            {
                "metric": "particle-steps/sec @ N=100k phi=0.45 kT>0",
                "value": round(headline["particle_steps_per_sec"]),
                "unit": "particle-steps/s",
                "vs_baseline": round(headline["particle_steps_per_sec"] / 1e7, 4),
                "device": {k: device[k] for k in ("platform", "kind", "count")},
            }
        )
    )


if __name__ == "__main__":
    main()
