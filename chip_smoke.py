#!/usr/bin/env python3
"""Smoke test of the PSE Brownian step on NVIDIA GPUs.

    python chip_smoke.py            # one card: the phases below
    python chip_smoke.py --four     # four cards: the multi-card path only

Drives the main path through the user entry points (pse.Simulation ->
integrator.step with the banded engine) at full width, and checks every
kernel of that path as compiled for the card against its plain reference.
Runs in ONE process (all phases share one compile cache); a JAX process
reserves most of the card's memory, so the card-only tests run first, as a
child, before this process touches the card.

Phases (one JSON line each):
  0 device      platform, kind, count, nvidia-smi, versions, cache dir
  1 kernel      Triton near-field matvec vs matvec_banded_reference at the
                N=100k phi=0.45 geometry (nrhs 1/2, tilt 0/0.3, W 128/192),
                plus per-call times of both
  2 physics     mobility vs the float64 direct-Ewald oracle (both engines,
                error=1e-3) and the error=1e-4 dense case
  3 main_path   pse.Simulation N=100k phi=0.45 T=1, 400 steps in chunks of
                200; then with a constant force, 200 steps in chunks of 100
                (two chunks each, so compile and steady time separate)
  4 example     examples/run_pse.py's scene for 100 steps
  5 gpu_tests   pytest -m gpu, as a child process

Exits non-zero, with no result line, when JAX finds no GPU or the repo is
not beside this script; exits 1 when any phase failed.  Times printed here
are information only (card and power limit beside them).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def nvidia_smi() -> str | None:
    """The cards' name and power limit, from a child that stays off JAX."""
    try:
        out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def make_positions(n, phi, seed=0):
    """Vacancy-diluted SC lattice at volume fraction phi (bench.py's)."""
    sys.path.insert(0, ROOT)
    from bench import make_positions as mp

    return mp(n, phi, seed)


def _max_rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _time_call(fn, *args, reps=10):
    """Median wall seconds of fn(*args) after one warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_kernel(n=100_000, phi=0.45, tol=1e-5, timing=True):
    """Triton kernel vs the plain-XLA reference at the bench geometry."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import pse_tpu as pse
    from pse_tpu import integrator
    from pse_tpu.box import make_box
    from pse_tpu.cellbins import bin_columns, vec_to_cells
    from pse_tpu.ops import banded_nearfield as bdn

    impl = bdn.select_nf_impl()
    pos, L = make_positions(n, phi)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg = integrator.make_config(params, n, thermal=True, engine="banded")
    assert cfg.engine == "banded", cfg.engine
    kern = integrator.banded_matvec(cfg, bdn.NF_TRITON)
    ref = integrator.banded_matvec(cfg, bdn.NF_REFERENCE)
    rng = np.random.default_rng(1)
    forces = jnp.asarray(rng.normal(size=(n, 2, 3)).astype(np.float32))

    def setup(pos, forces, tilt, spec):
        box = make_box(params.L, tilt)
        bins = bin_columns(pos, box, spec.bins)
        j0, nv, ovf = bdn.compute_windows(bins, spec, box, params.ewald_cut)
        f = jnp.concatenate([vec_to_cells(bins, spec.bins, forces[:, r])
                             for r in range(2)], axis=0)
        return bins, j0, nv, ovf | bins.overflow, f

    setup = jax.jit(setup, static_argnums=3)
    cases = []
    times = {}
    for window in (128, 192):
        spec = cfg.band_spec._replace(window=window)
        for tilt in (0.0, 0.3):
            bins, j0, nv, ovf, f6 = setup(jnp.asarray(pos), forces,
                                          jnp.float32(tilt), spec)
            for nrhs in (1, 2):
                f = f6[:3 * nrhs]
                uk = kern(bins, tilt, spec, j0, nv, f)
                ur = ref(bins, tilt, spec, j0, nv, f)
                err = _max_rel(uk, ur)
                cases.append({"W": window, "tilt": tilt, "nrhs": nrhs,
                              "overflow": bool(ovf), "max_rel": err})
                if timing and tilt == 0.0:
                    kj = jax.jit(kern, static_argnums=2)
                    rj = jax.jit(ref, static_argnums=2)
                    args = (bins, jnp.float32(tilt), spec, j0, nv, f)
                    times[f"W{window}_nrhs{nrhs}"] = {
                        "triton_ms": 1e3 * _time_call(kj, *args),
                        "xla_reference_ms": 1e3 * _time_call(rj, *args),
                    }
    worst = max(c["max_rel"] for c in cases)
    ok = worst <= tol and impl == bdn.NF_TRITON
    # the step that users run must contain the Triton kernel, not the
    # reference: look for the kernel in the step's lowered program
    state = integrator.make_state(pos)
    step_txt = integrator.step.lower(
        cfg, state, jnp.zeros((n, 3), jnp.float32), 1.0, 1e-3, 0.0
    ).as_text()
    in_step = "pse_banded_matvec" in step_txt
    ok = ok and in_step
    return ok, {
        "impl": {"near_field": impl, "near_field_in_step": in_step,
                 "far_field": "xla einsum (z-column)",
                 "far_field_dtype": cfg.colff_spec.weight_dtype,
                 "fft": "jnp.fft (cuFFT)", "binning": "xla sort+scatter"},
        "spec": {"n_cells": cfg.band_spec.bins.n_cells,
                 "cap": cfg.band_spec.bins.cap, "rows": cfg.band_spec.rows,
                 "window": cfg.band_spec.window},
        "tol": tol, "worst_max_rel": worst, "cases": cases,
        "per_call": times,
    }


def phase_physics():
    """Oracle gates: both engines at error=1e-3, the dense error=1e-4 case."""
    import numpy as np

    import pse_tpu as pse
    from pse_tpu import integrator

    d = np.load(os.path.join(ROOT, "tests", "data", "oracle_gate.npz"))
    pos = np.asarray(d["pos"], np.float32)
    f = np.asarray(d["forces"], np.float32)
    u_ref = np.asarray(d["u_ref"])
    params = pse.make_params(xi=float(d["xi"]), error=1e-3, L=float(d["L"]))
    gate = {}
    ok = True
    for engine in ("banded", "blocked"):
        cfg = integrator.make_config(params, pos.shape[0], thermal=False,
                                     engine=engine)
        u, ovf = integrator.mobility(cfg, pos, f)
        rel = float(np.linalg.norm(np.asarray(u) - u_ref)
                    / np.linalg.norm(u_ref))
        gate[engine] = {"engine_used": cfg.engine, "rel": rel,
                        "overflow": int(ovf)}
        ok = ok and rel <= 5e-3 and not int(ovf) and cfg.engine == engine

    # test_physics.test_dense_error_knob_scales_accuracy's configuration,
    # its float64 oracle cached by tools/make_oracle_gate.py --dense
    d4 = np.load(os.path.join(ROOT, "tests", "data", "oracle_dense.npz"))
    p = np.asarray(d4["pos"], np.float32)
    params4 = pse.make_params(xi=float(d4["xi"]), error=float(d4["error"]),
                              L=float(d4["L"]))
    cfg4 = integrator.make_config(params4, p.shape[0], thermal=False,
                                  engine="banded", max_tilt=0.0)
    u4, ovf4 = integrator.mobility(cfg4, p, np.asarray(d4["forces"]))
    u4_ref = d4["u_ref"]
    dev = float(np.max(np.abs(np.asarray(u4) - u4_ref))
                / np.max(np.abs(u4_ref)))
    ok = ok and dev < 5e-3 and not int(ovf4) and cfg4.engine == "banded"
    return ok, {"oracle_gate_error_1e-3": gate,
                "dense_error_1e-4": {"max_dev": dev, "tol": 5e-3,
                                     "overflow": int(ovf4)}}


def _run_sim(sim, n_steps):
    """Run and summarize: compile seconds (first chunk minus a steady one),
    steady wall steps/s, final-state checks."""
    import numpy as np

    sim.run(n_steps)
    timing = sim.step_timing
    steady = timing[-1]
    sps = steady[0] / steady[1]
    compile_s = timing[0][1] - timing[0][0] / sps if len(timing) > 1 else None
    s = sim.snapshot()
    m = s["m_lanczos"]
    checks = {
        "finite": bool(np.all(np.isfinite(s["pos"]))),
        "no_overflow": int(sim.state.nbr_overflow) == 0,
        "m_in_range": 2 <= m < sim.config.m_max,
        "steps": s["step"] == n_steps,
    }
    return all(checks.values()), {
        "checks": checks, "m_lanczos": m, "m_max": sim.config.m_max,
        "overflow_retries": sim.metrics["overflow_retries"],
        "compile_s": compile_s, "wall_steps_per_s": sps,
        "wall_particle_steps_per_s": sps * sim.n,
    }


def phase_main_path(n=100_000, phi=0.45, steps=400, steps_forces=200):
    import jax
    import jax.numpy as jnp

    import pse_tpu as pse

    pos, L = make_positions(n, phi)
    out = {}
    ok = True
    for label, force_fn, n_steps in (
        ("brownian", None, steps),
        ("with_forces",
         lambda p, t: jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0],
                                                   jnp.float32), p.shape),
         steps_forces),
    ):
        sim = pse.Simulation(positions=pos, L=L, dt=1e-3,
                             sync_every=max(1, n_steps // 2),
                             force_fn=force_fn)
        sim.set_integrator(pse.integrate.PSEv1(T=1.0, seed=1, xi=0.5,
                                               error=1e-3),
                           engine="banded", verbose=False)
        assert sim.config.engine == "banded"
        assert sim.config.has_forces == (force_fn is not None)
        ok_i, res = _run_sim(sim, n_steps)
        ok = ok and ok_i
        out[label] = res
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    out["n"] = n
    return ok, out


def phase_example(steps=100):
    import importlib.util

    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "run_pse", os.path.join(ROOT, "examples", "run_pse.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sim, positions = mod.make_simulation(steps, verbose=False)
    sim.run(steps)
    s = sim.snapshot()
    checks = {
        "finite": bool(np.all(np.isfinite(s["pos"]))),
        "steps": s["step"] == steps,
        "tilted": s["tilt_xy"] != 0.0,
        "moved": float(np.abs(s["pos"] - positions).mean()) > 0.0,
        "no_overflow": int(sim.state.nbr_overflow) == 0,
    }
    return all(checks.values()), {"engine": sim.config.engine,
                                  "checks": checks, "tilt": s["tilt_xy"],
                                  "m_lanczos": s["m_lanczos"]}


def run_gpu_tests():
    """pytest -m gpu in a child, before this process touches the card."""
    env = dict(os.environ, PSE_TESTS_ON_GPU="1")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "-rs"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = out.stdout.strip().splitlines()[-3:]
    skipped = "skipped" in (tail[-1] if tail else "")
    ok = out.returncode == 0 and not skipped
    if not ok:
        sys.stderr.write(out.stdout[-6000:] + out.stderr[-3000:])
    return ok, {"rc": out.returncode, "summary": tail}


def _settled(cfg, pos, f, max_grow=6):
    """(cfg, u, overflow, regrows): one-card mobility, growing the
    capacities its overflow flags name (as Simulation.run does) until the
    lattice's column-occupancy spread fits."""
    import numpy as np

    from pse_tpu import integrator

    for grown in range(max_grow + 1):
        u, ovf = integrator.mobility(cfg, pos, f)
        if not int(ovf):
            break
        cfg = integrator.grow_config(cfg, flags=int(ovf))
    return cfg, np.asarray(u), ovf, grown


def _uniform(n, phi, seed):
    """n uniform random centres at volume fraction phi: a relaxed
    suspension's column occupancy (no lattice aliasing, so the Poisson
    capacities hold without regrow recompiles)."""
    import numpy as np

    L = (n * (4.0 / 3.0) * math.pi / phi) ** (1.0 / 3.0)
    rng = np.random.default_rng(seed)
    return rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32), L


def phase_four(n_halo=1_000_000, n_sharded=100_000, phi=0.45, steps=2,
               devices=None):
    """Multi-card path only: the halo-decomposed banded engine and the
    GSPMD-sharded blocked engine on a 1-D mesh, each compared with the
    one-card mobility at the same positions."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import pse_tpu as pse
    from pse_tpu import integrator
    from pse_tpu.parallel import halo, sharding as sh

    devices = devices if devices is not None else jax.devices()
    D = len(devices)
    mesh = sh.make_mesh(devices)
    one = devices[0]
    out = {"count": D}
    ok = True
    rng = np.random.default_rng(3)

    def stage(name):
        print(f"# four: {name} at {time.perf_counter() - t_start:.1f}s",
              file=sys.stderr, flush=True)

    t_start = time.perf_counter()
    # halo (banded) at N=1M: mobility vs one card, then a few thermal steps
    pos, L = _uniform(n_halo, phi, seed=2)
    f = rng.normal(size=(n_halo, 3)).astype(np.float32)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg = integrator.make_config(params, n_halo, thermal=True, seed=1,
                                 engine="banded", shard_slabs=D)
    assert cfg.engine == "banded", cfg.engine
    with jax.default_device(one):
        cfg, u1, ov1, grown = _settled(cfg, pos, f)
    stage("one-card banded mobility")
    ps = sh.particle_sharding(mesh)
    pos_s = jax.device_put(jnp.asarray(pos), ps)
    f_s = jax.device_put(jnp.asarray(f), ps)
    t0 = time.perf_counter()
    uD, ovD = halo.make_halo_mobility(cfg, mesh)(pos_s, f_s)
    uD = np.asarray(uD)
    t_mob = time.perf_counter() - t0
    rel = float(np.linalg.norm(uD - u1) / np.linalg.norm(u1))
    out["halo_mobility"] = {"n": n_halo, "rel": rel, "tol": 1e-4,
                            "overflow": [int(ov1), int(ovD)],
                            "regrows": grown,
                            "first_call_s": t_mob,
                            "n_cells": cfg.band_spec.bins.n_cells}
    ok = ok and rel <= 1e-4 and not int(ov1) and not int(ovD)

    stage("halo mobility")
    hstep = halo.make_halo_step(cfg, mesh)
    state = sh.shard_state(integrator.make_state(pos), mesh)
    for _ in range(steps):
        state, _info = hstep(state, f_s, 1.0, 1e-3, 0.0, new_tilt=0.0)
    fin = bool(jnp.all(jnp.isfinite(state.pos)))
    out["halo_steps"] = {"steps": steps, "finite": fin,
                         "overflow": int(state.nbr_overflow),
                         "m_lanczos": int(state.m_lanczos)}
    ok = ok and fin and not int(state.nbr_overflow)
    stage("halo steps")

    # GSPMD-sharded blocked engine at N=100k: mobility vs one card
    pos, L = _uniform(n_sharded, phi, seed=4)
    f = rng.normal(size=(n_sharded, 3)).astype(np.float32)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg_b = integrator.make_config(params, n_sharded, thermal=False,
                                   engine="blocked")
    with jax.default_device(one):
        cfg_b, v1, w1, grown_b = _settled(cfg_b, pos, f)
    stage("one-card blocked mobility")
    vD, wD = sh.make_sharded_mobility(cfg_b, mesh)(
        jax.device_put(jnp.asarray(pos), ps),
        jax.device_put(jnp.asarray(f), ps))
    rel_b = float(np.linalg.norm(np.asarray(vD) - v1) / np.linalg.norm(v1))
    out["sharded_blocked_mobility"] = {"n": n_sharded, "rel": rel_b,
                                       "tol": 1e-4,
                                       "overflow": [int(w1), int(wD)],
                                       "regrows": grown_b}
    ok = ok and rel_b <= 1e-4 and not int(w1) and not int(wD)
    return ok, out


# ---------------------------------------------------------------------------


def _phase(name, fn, failures, **kw):
    t0 = time.perf_counter()
    try:
        ok, res = fn(**kw)
    except Exception as e:  # noqa: BLE001 — recorded; the run exits 1
        traceback.print_exc()
        ok, res = False, {"error": f"{type(e).__name__}: {str(e)[:500]}"}
    if not ok:
        failures.append(name)
    emit(name, ok=ok, seconds=time.perf_counter() - t0, **res)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path (halo + sharded "
                         "engines vs one card)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "pse_tpu")):
        print("chip_smoke: the pse_tpu package is not beside this script",
              file=sys.stderr)
        return 2
    smi = nvidia_smi()
    if smi is None:
        print("chip_smoke: nvidia-smi found no NVIDIA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    failures = []
    if not args.four:
        _phase("gpu_tests", run_gpu_tests, failures)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devs[0].platform!r})", file=sys.stderr)
        return 3
    from pse_tpu.utils.cache import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 3
    emit("device", ok=True, platform=devs[0].platform,
         kind=devs[0].device_kind, count=len(devs), nvidia_smi=smi,
         jax=jax.__version__, python=sys.version.split()[0],
         xla_flags=os.environ.get("XLA_FLAGS", ""), cache_dir=cache_dir)

    if args.four:
        _phase("four", phase_four, failures, devices=devs[:4])
    else:
        _phase("kernel", phase_kernel, failures)
        _phase("physics", phase_physics, failures)
        _phase("main_path", phase_main_path, failures)
        _phase("example", phase_example, failures)

    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
