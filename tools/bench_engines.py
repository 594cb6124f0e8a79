"""Measured engine comparison: banded (cell-list analogue) vs blocked vs
gather (explicit neighbor enumeration, the closest analogue here of the
reference's tree/stencil nlist backends).

Closes SURVEY/VERDICT item "nlist_type parity needs one measurement": the
reference offers cell/tree/stencil neighbor backends as GPU space/time
tradeoffs (integrate.py:60-74); this tool quantifies the gap between the
engines on identical physics (deterministic U = M·F, timed as a chained
scan).

Run alone (one process per card):
    python tools/bench_engines.py [--n 20000]
"""

import argparse
import math
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--phi", type=float, default=0.45)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--engines", default="banded,blocked,gather")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import pse_tpu as pse
    from pse_tpu import integrator
    from pse_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    n = args.n
    vol = n * (4.0 / 3.0) * math.pi / args.phi
    L = vol ** (1.0 / 3.0)
    rng = np.random.default_rng(0)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    forces = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    params = pse.make_params(xi=0.5, error=1e-3, L=L)

    staged = []
    for engine in args.engines.split(","):
        config = integrator.make_config(
            params, n, thermal=False, engine=engine,
            max_neighbors=512 if engine == "gather" else None,
        )
        if config.engine != engine:
            print(f"[{engine}] unavailable at this size "
                  f"(fell back to {config.engine}); skipping", flush=True)
            continue

        def make(config=config):
            @jax.jit
            def many(pos_, f):
                def body(v, _):
                    u, ovf = integrator.mobility(config, pos_, v)
                    scale = 1.0 / jnp.maximum(jnp.max(jnp.abs(u)), 1e-30)
                    return u * scale, ovf
                v, ovfs = jax.lax.scan(body, f, None, length=args.iters)
                return v, jnp.any(ovfs)
            return many

        many = make()
        t0 = time.perf_counter()
        v, ovf = many(pos, forces)
        np.asarray(v)
        print(f"[{engine}] compile+warm {time.perf_counter()-t0:.0f}s "
              f"overflow={bool(ovf)}", flush=True)
        staged.append((engine, many))

    for _ in range(args.reps):
        for engine, many in staged:
            t0 = time.perf_counter()
            v, _ = many(pos, forces)
            np.asarray(v)
            dt = (time.perf_counter() - t0) / args.iters
            print(f"[{engine}] U=M·F: {dt*1e3:.2f} ms "
                  f"({n/dt:.3g} particle-matvecs/s)", flush=True)


if __name__ == "__main__":
    main()
