"""Cross-backend determinism audit (ROADMAP item 8).

The determinism contract (reference Brownian.cu:117,176: Saru keyed
(idx, timestep+seed) — bitwise reproducible per (seed, step) regardless of
history) maps here to threefry keyed (hash_seed(seed), step).  This tool
measures what IS and is NOT bitwise identical between the CPU backend and
the GPU:

  1. raw threefry random draws (particle psi): expected bitwise equal —
     threefry is integer math and the uniform->float conversion is exact;
  2. one full Brownian step from the same state: expected bitwise equal
     PER BACKEND across reruns (the restart contract), but only
     statistically equal ACROSS backends (sum reassociation, bf16 pair
     blocks and TF32 far-field products on the GPU vs f32 on the CPU).

The CPU leg runs in a JAX_PLATFORMS=cpu subprocess (backend selection is
process-wide), which never touches the card; it writes its arrays to a
temp npz, and the GPU process compares.  Run alone (one process per card):

    python tools/check_determinism.py
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))


def compute(npz_path):
    import jax
    import jax.numpy as jnp
    import pse_tpu as pse
    from pse_tpu import integrator
    from pse_tpu.ops import noise
    from pse_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    backend = jax.default_backend()

    key = jax.random.fold_in(jax.random.PRNGKey(integrator.hash_seed(1)), 7)
    draws = np.asarray(jax.jit(noise.particle_noise,
                               static_argnums=1)(key, 4096))

    # same tiny scenario as __graft_entry__.entry() (warm compile cache)
    n_side, L = 8, 24.0
    n = n_side ** 3
    pos = pse.create_lattice(n_side, L)
    rng = np.random.default_rng(0)
    forces = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    config = integrator.make_config(params, n, thermal=True, seed=1,
                                    engine="blocked")

    @jax.jit
    def one(state, forces):
        s, _ = integrator.step(config, state, forces, jnp.float32(1.0),
                               jnp.float32(1e-3), jnp.float32(0.0))
        return s.pos

    runs = [np.asarray(one(integrator.make_state(pos), forces))
            for _ in range(2)]
    rerun_bitwise = bool((runs[0] == runs[1]).all())
    print(f"{backend}: step rerun bitwise reproducible = {rerun_bitwise}")
    np.savez(npz_path, draws=draws, pos0=np.asarray(pos), stepped=runs[0],
             rerun_bitwise=rerun_bitwise)


def main():
    with tempfile.TemporaryDirectory() as td:
        cpu_npz = os.path.join(td, "cpu.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--compute", cpu_npz],
            env=env, check=True,
        )
        cpu = np.load(cpu_npz)

        gpu_npz = os.path.join(td, "gpu.npz")
        compute(gpu_npz)
        gpu = np.load(gpu_npz)

    import jax
    print(f"accel backend: {jax.default_backend()}")
    bitwise = bool((cpu["draws"] == gpu["draws"]).all())
    dmax = np.abs(cpu["draws"] - gpu["draws"]).max()
    ulps = np.abs(
        cpu["draws"].view(np.int32) - gpu["draws"].view(np.int32)
    ).max()
    print(f"psi draws (threefry, n=4096): cpu==gpu bitwise = {bitwise} "
          f"(max abs delta {dmax:.3e}, max ulp distance {ulps})")
    assert bool(cpu["rerun_bitwise"]) and bool(gpu["rerun_bitwise"]), \
        "restart contract broken: same (seed, step, backend) must be bitwise"

    disp_c = cpu["stepped"] - cpu["pos0"]
    disp_t = gpu["stepped"] - gpu["pos0"]
    rel = np.abs(disp_t - disp_c).max() / np.abs(disp_c).max()
    print(f"cross-backend displacement delta: max rel {rel:.2e} "
          f"(expected ~<=1e-2: bf16 blocks + TF32 far field on the GPU vs "
          f"f32 on the CPU; the error budget is the Ewald 'error')")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--compute":
        compute(sys.argv[2])
    else:
        main()
