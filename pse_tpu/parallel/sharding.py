"""Multi-device execution over a jax.sharding.Mesh.

The reference is single-GPU only (Stokes.cc:104-109); this module is new
capability (SURVEY.md §5 "long-context analog"): the particle arrays and the
FFT grid are sharded over a 1-D device mesh and the step is jitted once —
XLA GSPMD inserts the collectives (all-to-all for the distributed FFT
transposes, all-gathers for the neighbor candidate gathers, psums for the
Lanczos reductions).

Sharding layout ("dp" axis):
  * particle arrays (pos, images, forces, ψ, neighbor rows): sharded on the
    particle dimension — each device owns N/d particles' pair sums, spread
    taps, and contraction;
  * the 3 FFT grids: sharded on the x grid axis;
  * the derived k-space arrays and small scalars: replicated.

This gives data-parallel near-field + spread/contract with a distributed FFT
— the natural decomposition for this workload class on a few devices of
one host (on GPUs XLA hands the collectives to NCCL).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..integrator import State, StepConfig, mobility as _mobility, step as _step


def make_mesh(devices=None, axis: str = "dp") -> Mesh:
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def particle_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    return NamedSharding(mesh, P(axis, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state(state: State, mesh: Mesh, axis: str = "dp") -> State:
    """Place a State pytree: particle arrays sharded, scalars replicated."""
    ps = particle_sharding(mesh, axis)
    rs = replicated(mesh)
    return State(
        pos=jax.device_put(state.pos, ps),
        images=jax.device_put(state.images, ps),
        step=jax.device_put(state.step, rs),
        tilt_xy=jax.device_put(state.tilt_xy, rs),
        m_lanczos=jax.device_put(state.m_lanczos, rs),
        nbr_overflow=jax.device_put(state.nbr_overflow, rs),
    )


def make_sharded_step(config: StepConfig, mesh: Mesh, axis: str = "dp"):
    """Jit the full PSE step with sharded inputs/outputs over ``mesh``.

    Returns step_fn(state, forces, T, dt, shear_rate, new_tilt) with particle
    arrays sharded along the particle dimension.  GSPMD propagates the
    sharding through neighbor search, pair gathers, scatter-add spreading,
    the batched 3D FFTs, and the Lanczos while_loop.
    """
    ps = particle_sharding(mesh, axis)
    rs = replicated(mesh)

    state_shardings = State(
        pos=ps, images=ps, step=rs, tilt_xy=rs, m_lanczos=rs, nbr_overflow=rs
    )

    @partial(
        jax.jit,
        in_shardings=(state_shardings, ps, rs, rs, rs, rs),
        out_shardings=(state_shardings, None),
    )
    def sharded_step(state, forces, T, dt, shear_rate, new_tilt):
        return _step(config, state, forces, T, dt, shear_rate, new_tilt)

    def run(state, forces, T, dt, shear_rate, new_tilt=None):
        # new_tilt=None keeps the current tilt (same semantics as step()).
        tilt = state.tilt_xy if new_tilt is None else jnp.float32(new_tilt)
        return sharded_step(
            state, forces, jnp.float32(T), jnp.float32(dt),
            jnp.float32(shear_rate), tilt,
        )

    return run


def make_sharded_mobility(config: StepConfig, mesh: Mesh, axis: str = "dp"):
    """Jit the public U = M·F matvec with particle-sharded inputs/outputs."""
    ps = particle_sharding(mesh, axis)
    rs = replicated(mesh)

    @partial(
        jax.jit,
        in_shardings=(ps, ps, rs),
        out_shardings=(ps, None),
    )
    def sharded_mobility(pos, forces, tilt_xy):
        return _mobility(config, pos, forces, tilt_xy)

    def run(pos, forces, tilt_xy=0.0):
        return sharded_mobility(pos, forces, jnp.float32(tilt_xy))

    return run
