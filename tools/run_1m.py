"""BASELINE config 5: N=1M over an x-slab halo mesh (parallel/halo.py).

The halo decomposition runs the banded near field shard-local, exchanging
one column layer of positions and forces per matvec between devices.  On
GPUs it uses the first --devices cards (the Triton near-field kernel per
slab); without GPUs it runs on that many virtual CPU devices, where the
banded engine runs its plain-XLA reference (processed in z-chunks so large
N fits in host RAM; N=1M is compile-dominated there).  chip_smoke.py --four
checks the same path against one card.

Usage: python tools/run_1m.py --n 1000000 --devices 4 [--thermal --steps 3]
"""

import argparse
import math
import os
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--thermal", action="store_true")
    ap.add_argument("--steps", type=int, default=0,
                    help="TIMED repeats after the compile call — a halo-"
                    "engine perf regression shows up as a number, not just "
                    "non-green (VERDICT r3).  Suggested regression config: "
                    "--n 200000 --thermal --steps 3 (minutes on the 8-CPU "
                    "mesh; N=1M is compile-dominated, ~1 h).")
    args = ap.parse_args()

    if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()

    import numpy as np
    import jax

    if jax.default_backend() != "gpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import pse_tpu as pse
    from pse_tpu import integrator
    from pse_tpu.parallel import halo, sharding as sh

    n = args.n
    phi = 0.45
    L = (n * (4.0 / 3.0) * math.pi / phi) ** (1.0 / 3.0)
    rng = np.random.default_rng(0)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)

    devices = jax.devices()[: args.devices]
    mesh = sh.make_mesh(devices)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    config = integrator.make_config(
        params, n, thermal=args.thermal, seed=1, engine="banded",
        shard_slabs=args.devices, has_forces=True,
    )
    assert config.engine == "banded", config.engine
    bs = config.band_spec
    print(f"N={n:,} L={L:.0f} grid={params.Nx}^3 columns={bs.bins.n_cells} "
          f"cap={bs.bins.cap} W={bs.window} on {args.devices}x"
          f"{jax.devices()[0].platform}")

    ps = sh.particle_sharding(mesh)
    pos_s = jax.device_put(jnp.asarray(pos), ps)
    forces = jax.device_put(
        jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)), ps
    )

    if args.thermal:
        hstep = halo.make_halo_step(config, mesh)
        state = sh.shard_state(integrator.make_state(pos), mesh)
        t0 = time.perf_counter()
        state, info = hstep(state, forces, 1.0, 1e-3, 0.0)
        jax.block_until_ready(state.pos)
        print(f"thermal step (incl. compile): {time.perf_counter()-t0:.1f}s "
              f"(m={int(state.m_lanczos)}, "
              f"overflow={bool(state.nbr_overflow)})")
        assert bool(jnp.all(jnp.isfinite(state.pos)))
        if args.steps:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                state, info = hstep(state, forces, 1.0, 1e-3, 0.0)
            np.asarray(state.pos)
            dt_step = (time.perf_counter() - t0) / args.steps
            print(f"TIMED halo thermal step: {dt_step:.2f} s/step "
                  f"({n/dt_step:.3g} particle-steps/s on "
                  f"{args.devices}x{jax.devices()[0].platform})")
    else:
        hmob = halo.make_halo_mobility(config, mesh)
        t0 = time.perf_counter()
        u, overflow = hmob(pos_s, forces)
        jax.block_until_ready(u)
        print(f"mobility U = M·F (incl. compile): "
              f"{time.perf_counter()-t0:.1f}s (overflow={bool(overflow)})")
        us = np.asarray(u[:1000])
        assert np.all(np.isfinite(us))
        print("U sample rms:", float(np.sqrt((us ** 2).mean())))
        if args.steps:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                u, overflow = hmob(pos_s, forces)
            jax.block_until_ready(u)
            dt_mv = (time.perf_counter() - t0) / args.steps
            print(f"TIMED halo mobility: {dt_mv:.2f} s/call "
                  f"({n/dt_mv:.3g} particle-matvecs/s on "
                  f"{args.devices}x{jax.devices()[0].platform})")
    print("OK")


if __name__ == "__main__":
    main()
