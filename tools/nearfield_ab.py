"""Near-field implementation A/B and per-scope device times of the step.

    python tools/nearfield_ab.py [--n 100000] [--chunk 100] [--reps 3]
                                 [--trace-dir chiprun_out/trace] [--ff-ab]

On one GPU, at bench.py's geometry (vacancy-diluted lattice, phi=0.45):

  * end to end: steps/s of the banded step over a lax.scan chunk with the
    Triton near-field kernel and with the plain-XLA reference, in turns
    (triton, reference, reference, triton) so drift shows (--impls picks
    which are built);
  * one jax.profiler trace of a steady chunk (Triton near field), reduced
    to device time per named scope of integrator.step_impl (pse_prepare,
    pse_spread, pse_fft, pse_green, pse_ifft, pse_contract, pse_nearfield,
    pse_lanczos) and the device's busy share of the window;
  * with --ff-ab, instead: the far-field dtype at error=1e-3 — f32 factors
    with TF32 products vs bf16 factors with f32 accumulation — end to end
    (Triton near field, in turns) and against the float64 direct-Ewald
    oracle (tests/data/oracle_gate.npz);
  * with --tune, instead: per-call times of the Triton matvec over its
    lane-chunk width and warp count.

Per-scope attribution needs the kernels' HLO names in the trace: run the
trace with XLA_FLAGS=--xla_gpu_enable_command_buffer= (command buffers
report one opaque op for a whole captured graph).

Prints one JSON line with the card's name and power limit beside the
numbers.  Fails on a non-GPU device.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCOPES = ("pse_prepare", "pse_spread", "pse_fft", "pse_green", "pse_ifft",
          "pse_contract", "pse_nearfield", "pse_lanczos")


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def build(n, has_forces, impl, chunk, ff_dtype=None):
    """(config, run_chunk, state0) with the near field forced to ``impl``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import pse_tpu as pse
    from bench import make_positions
    from pse_tpu import integrator
    from pse_tpu.ops import banded_nearfield as bdn

    pos, L = make_positions(n, 0.45)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg = integrator.make_config(params, n, thermal=True, seed=1,
                                 engine="banded", has_forces=has_forces,
                                 ff_weight_dtype=ff_dtype)
    forces = (jnp.asarray(np.random.default_rng(1).normal(size=(n, 3))
                          .astype(np.float32)) if has_forces
              else jnp.zeros((n, 3), jnp.float32))

    def make(cfg):
        orig = bdn.select_nf_impl
        bdn.select_nf_impl = lambda platform=None: impl
        try:
            eng = integrator._engine(cfg)
        finally:
            bdn.select_nf_impl = orig

        @jax.jit
        def run_chunk(state):
            def body(s, _):
                s2, _ = integrator.step_impl(cfg, eng, s, forces, 1.0, 1e-3,
                                             0.0)
                return s2, None
            return jax.lax.scan(body, state, None, length=chunk)[0]
        return run_chunk

    state = integrator.make_state(pos)
    for _ in range(6):                     # grow like Simulation.run
        run_chunk = make(cfg)
        out = run_chunk(state)
        if not int(out.nbr_overflow):
            return cfg, run_chunk, out
        cfg = integrator.grow_config(cfg, flags=int(out.nbr_overflow))
    raise RuntimeError("capacity overflow persists")


def time_chunks(run_chunk, state, reps, chunk):
    import numpy as np

    t0 = time.perf_counter()
    for _ in range(reps):
        state = run_chunk(state)
    np.asarray(state.pos)
    dt = time.perf_counter() - t0
    return reps * chunk / dt, state


def oracle_rel(ff_dtype):
    """Banded-engine mobility vs the float64 oracle at error=1e-3."""
    import numpy as np

    import pse_tpu as pse
    from pse_tpu import integrator

    d = np.load(os.path.join(ROOT, "tests", "data", "oracle_gate.npz"))
    params = pse.make_params(xi=float(d["xi"]), error=1e-3, L=float(d["L"]))
    cfg = integrator.make_config(params, int(d["n"]), thermal=False,
                                 engine="banded", ff_weight_dtype=ff_dtype)
    u, ovf = integrator.mobility(cfg, np.asarray(d["pos"], np.float32),
                                 np.asarray(d["forces"], np.float32))
    assert not int(ovf)
    return float(np.linalg.norm(np.asarray(u) - d["u_ref"])
                 / np.linalg.norm(d["u_ref"]))


def ff_ab(args, res):
    from pse_tpu.ops import banded_nearfield as bdn

    runs = {dt: build(args.n, args.forces, bdn.NF_TRITON, args.chunk, dt)
            for dt in ("float32", "bfloat16")}
    sps = collections.defaultdict(list)
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        cfg, run_chunk, state = runs[dt]
        v, state = time_chunks(run_chunk, state, args.reps, args.chunk)
        runs[dt] = (cfg, run_chunk, state)
        sps[dt].append(v)
    res["ff_steps_per_s"] = dict(sps)
    res["ff_oracle_rel"] = {dt: oracle_rel(dt) for dt in runs}
    return res


def tune(args, res):
    """Per-call Triton matvec times over (lanes, num_warps)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import pse_tpu as pse
    from bench import make_positions
    from pse_tpu import integrator
    from pse_tpu.box import make_box
    from pse_tpu.cellbins import bin_columns, vec_to_cells
    from pse_tpu.ops import banded_nearfield as bdn

    pos, L = make_positions(args.n, 0.45)
    p = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg = integrator.make_config(p, args.n, thermal=True, engine="banded")
    bs = cfg.band_spec
    box = make_box(p.L, 0.0)
    bins = bin_columns(jnp.asarray(pos), box, bs.bins)
    j0, nv, _ = bdn.compute_windows(bins, bs, box, p.ewald_cut)
    rng = np.random.default_rng(0)
    f6 = jnp.concatenate([vec_to_cells(bins, bs.bins, jnp.asarray(
        rng.normal(size=(args.n, 3)).astype(np.float32))) for _ in range(2)])
    out = {}
    for lanes in (32, 64):
        for warps in (2, 4, 8):
            for nrhs in (1, 2):
                def mv(f, lanes=lanes, warps=warps):
                    return bdn.matvec_banded(
                        bins, 0.0, bs, cfg.cheb, p.L, p.ewald_cut,
                        p.ewald_dr, j0, nv, f, p.self_mobility,
                        lanes=lanes, num_warps=warps)
                f = f6[:3 * nrhs]
                jax.block_until_ready(mv(f))
                t0 = time.perf_counter()
                for _ in range(20):
                    u = mv(f)
                jax.block_until_ready(u)
                out[f"lanes{lanes}_warps{warps}_nrhs{nrhs}"] = (
                    (time.perf_counter() - t0) / 20 * 1e3)
    res["tune_ms_per_call"] = out
    return res


def reduce_trace(trace_dir, window_s):
    """Device time per named scope from the newest .xplane.pb."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    pd = ProfileData.from_file(path)
    per_scope = collections.defaultdict(collections.Counter)
    per_name = collections.Counter()
    busy = []
    lines_seen = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines_seen.append({
                "plane": plane.name, "line": line.name, "events": len(evs),
                "sample": [[e.name, [[k, str(v)[:160]] for k, v in e.stats]]
                           for e in evs[:2]],
            })
            kind = "ops" if "XLA Ops" in line.name else (
                "stream" if "Stream" in line.name else None)
            if kind is None:
                continue
            for ev in evs:
                text = " ".join(str(v) for _, v in ev.stats) + " " + ev.name
                hit = next((s for s in SCOPES if s in text), "other")
                per_scope[kind][hit] += ev.duration_ns
                if kind == "stream":
                    busy.append((ev.start_ns, ev.end_ns))
                    per_name[ev.name] += ev.duration_ns
    busy.sort()
    union, cur = 0, None
    for s, e in busy:
        if cur is None or s > cur[1]:
            if cur is not None:
                union += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        union += cur[1] - cur[0]
    span = (busy[-1][1] - busy[0][0]) if busy else 0
    return {
        "xplane": os.path.relpath(path, ROOT),
        "device_ms_per_scope": {
            kind: {k: v / 1e6 for k, v in c.items()}
            for kind, c in per_scope.items()},
        "lines": lines_seen,
        "top_kernels_ms": {k: v / 1e6 for k, v in per_name.most_common(25)},
        "busy_ms": union / 1e6, "span_ms": span / 1e6,
        "host_window_ms": window_s * 1e3,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--forces", action="store_true")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--ff-ab", action="store_true")
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--impls", default="triton,reference")
    args = ap.parse_args()

    import jax

    from pse_tpu.ops import banded_nearfield as bdn
    from pse_tpu.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    enable_compilation_cache()
    res = {"card": card(), "device_kind": dev.device_kind, "n": args.n,
           "chunk": args.chunk, "forces": args.forces}
    if args.ff_ab:
        print(json.dumps(ff_ab(args, res)))
        return
    if args.tune:
        print(json.dumps(tune(args, res)))
        return
    impls = args.impls.split(",")
    runs = {}
    for impl in impls:
        t0 = time.perf_counter()
        runs[impl] = build(args.n, args.forces, impl, args.chunk)
        res[f"build_s_{impl}"] = time.perf_counter() - t0
    sps = collections.defaultdict(list)
    for impl in impls + impls[::-1]:
        cfg, run_chunk, state = runs[impl]
        v, state = time_chunks(run_chunk, state, args.reps, args.chunk)
        runs[impl] = (cfg, run_chunk, state)
        sps[impl].append(v)
    res["steps_per_s"] = dict(sps)
    cfg, run_chunk, state = runs[bdn.NF_TRITON]
    res["m_lanczos"] = int(state.m_lanczos)
    res["spec"] = {"n_cells": cfg.band_spec.bins.n_cells,
                   "cap": cfg.band_spec.bins.cap,
                   "window": cfg.band_spec.window,
                   "ff_dtype": cfg.colff_spec.weight_dtype}
    if args.trace_dir:
        state = run_chunk(state)
        jax.block_until_ready(state.pos)
        t0 = time.perf_counter()
        with jax.profiler.trace(args.trace_dir):
            state = run_chunk(state)
            jax.block_until_ready(state.pos)
        res["trace"] = reduce_trace(args.trace_dir, time.perf_counter() - t0)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
