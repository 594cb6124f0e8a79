"""Measured cell-vs-stencil neighbor-backend comparison on the GPU.

The reference offers NeighborListGPUBinned (cell) and CellListStencil
(stencil) as GPU space/time tradeoffs (integrate.py:60-74).  Our gather
engine has both: subdiv=1 (27-stencil of rcut cells) and subdiv=2 (rcut/2
cells, 125-stencil, ~2.4x tighter candidate sets at ~4.6x the gather
descriptors).  This times the neighbor-list build and the gather-engine
U = M·F on the same configuration to settle which default the card wants
(run alone; one process per card):

    python tools/bench_stencil.py --n 20000
"""

import argparse
import math
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--phi", type=float, default=0.45)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import pse_tpu as pse
    from pse_tpu import integrator, neighbors
    from pse_tpu.box import make_box
    from pse_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    n = args.n
    L = (n * (4.0 / 3.0) * math.pi / args.phi) ** (1.0 / 3.0)
    rng = np.random.default_rng(0)
    pos = jnp.asarray(
        rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    )
    forces = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    box = make_box(params.L, 0.0)

    for subdiv in (1, 2):
        spec = neighbors.make_spec(
            n, params.L, params.ewald_cut, max_tilt=0.0, subdiv=subdiv
        )
        stencil = (2 * spec.subdiv + 1) ** 3
        print(f"subdiv={subdiv}: n_cells={spec.n_cells} "
              f"cap={spec.cell_capacity} maxnbr={spec.max_neighbors} "
              f"candidates/particle={stencil * spec.cell_capacity}",
              flush=True)

        @jax.jit
        def build_many(p):
            def body(x, _):
                nl = neighbors.build_neighbor_list(x, box, spec)
                # fold a data dependence so the scan can't collapse
                return x + 1e-12 * nl.idx[0, 0].astype(jnp.float32), None
            out, _ = jax.lax.scan(body, p, None, length=args.iters)
            return out

        t0 = time.perf_counter()
        np.asarray(build_many(pos))
        print(f"  nlist build: compile+run {time.perf_counter()-t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        np.asarray(build_many(pos))
        dt_build = (time.perf_counter() - t0) / args.iters
        print(f"  nlist build: {1e3*dt_build:.2f} ms", flush=True)

        cfg = integrator.make_config(
            params, n, thermal=False, engine="gather", nbr_subdiv=subdiv
        )

        @jax.jit
        def mob_many(f):
            def body(x, _):
                u, _ovf = integrator.mobility(cfg, pos, x)
                return x + 1e-12 * u, None
            out, _ = jax.lax.scan(body, f, None, length=args.iters)
            return out

        t0 = time.perf_counter()
        np.asarray(mob_many(forces))
        print(f"  gather mobility: compile+run {time.perf_counter()-t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        np.asarray(mob_many(forces))
        dt_mob = (time.perf_counter() - t0) / args.iters
        print(f"  gather mobility: {1e3*dt_mob:.2f} ms", flush=True)


if __name__ == "__main__":
    main()
