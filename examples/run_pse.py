"""Port of the reference example (examples/run.py): 1000-particle SC lattice
in an L=64 box, sinusoidal oscillatory shear, kT=1 Brownian dynamics."""

import math

import pse_tpu as pse
from pse_tpu.utils.cache import enable_compilation_cache

# Time stepping information (run.py:10-12)
dt = 1e-3      # time step
tf = 1e-1      # final time (shortened from 1e0 for a quick demo)
NRUN = int(tf / dt)


def make_simulation(nrun: int = NRUN, verbose: bool = True):
    """(sim, positions): the reference example's scene, ready to run."""
    # Simple cubic crystal of 1000 particles (run.py:27-34)
    N = 1000
    L = 64
    n = math.ceil(N ** (1.0 / 3.0))
    positions = pse.create_lattice(n, L)

    # Sinusoidal oscillatory shear (run.py:36-42)
    function_form = pse.shear_function.sine(dt=dt, shear_rate=1.0,
                                            shear_freq=1.0)

    # Set up PSE integrator (run.py:44-54)
    sim = pse.Simulation(positions=positions, L=L, dt=dt, sync_every=20)
    sim.set_integrator(
        pse.integrate.PSEv1(
            T=1.0, seed=1, xi=0.5, error=1e-3, function_form=function_form
        ),
        verbose=verbose,
    )
    sim.enable_shear_box(total_timesteps=nrun)
    return sim, positions


def main():
    enable_compilation_cache()
    sim, positions = make_simulation()
    sim.run(NRUN)                                  # run.py:57
    s = sim.snapshot()
    print(sim.metrics_summary())
    print(f"done: step={s['step']} tilt={s['tilt_xy']:.4f} "
          f"m_lanczos={s['m_lanczos']}")
    print(f"mean |displacement| = {abs(s['pos'] - positions).mean():.4f}")


if __name__ == "__main__":
    main()
