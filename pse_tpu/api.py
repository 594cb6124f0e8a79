"""User-facing scene/simulation API, shaped like the reference's Python layer.

The reference's user surface is ``PSEv1.integrate.PSEv1(group, T, seed, xi,
error, function_form, max_strain, nlist_type)`` driving a HOOMD system
(integrate.py:32, examples/run.py).  Here the same vocabulary drives a pure
JAX engine:

    import pse_tpu as pse

    sim = pse.Simulation(positions=pos, L=64.0, dt=1e-3)
    method = pse.integrate.PSEv1(
        T=1.0, seed=1, xi=0.5, error=1e-3,
        function_form=pse.shear_function.sine(dt=1e-3, shear_rate=1.0, shear_freq=1.0),
    )
    sim.set_integrator(method)
    sim.enable_shear_box(total_timesteps=...)   # the box_resize analogue
    sim.run(1000)

Inside ``run`` the whole step — neighbor rebuild, far/near field, Lanczos
noise, Euler update — executes as one jitted ``lax.scan`` chunk on device;
the host only syncs at chunk boundaries to check the neighbor-overflow flag
(and rewinds + regrows capacities if it tripped, the jax-md allocate/reuse
pattern).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import shear as shear_function
from .box import Box
from .integrator import (
    State, StepConfig, grow_config, make_config, make_state, mobility,
    step as _step,
)
from .params import make_params


@dataclasses.dataclass
class PSEv1:
    """Integration-method description (mirrors integrate.PSEv1 args,
    integrate.py:32).  ``nlist_type``: "cell" is the rcut-sized 27-stencil
    cell list; "stencil" is a genuine finer-cell backend (rcut/2 cells,
    125-stencil — the analogue of the reference's CellListStencil,
    integrate.py:69-74) used by the gather engine's neighbor enumeration;
    "tree" has no analogue here (the engines bin particles into regular
    cells) and maps to "cell" with a warning."""

    T: float | Callable = 1.0
    seed: int = 0
    xi: float = 0.5
    error: float = 1e-3
    function_form: Optional[shear_function.ShearFunction] = None
    max_strain: float = 0.5
    nlist_type: str = "cell"
    # Particle group (integrate.py:32, Stokes.cc:85-111): the reference
    # integrates a HOOMD group — only group members move, and the
    # hydrodynamic system (spreading, near field, noise) is built from group
    # members only.  Here: None = all particles (the canonical group.all
    # usage), or an index array selecting the subset to integrate.
    group: object = None

    def __post_init__(self):
        if self.nlist_type.upper() not in ("CELL", "TREE", "STENCIL"):
            raise ValueError(
                "Invalid neighborlist method. Valid options are: cell, tree, stencil."
            )
        if self.nlist_type.upper() == "TREE":
            import warnings

            # The reference's tree backend (integrate.py:60-68:
            # NeighborListGPUTree) is a space/time tradeoff around
            # irregular memory access; every engine here bins particles
            # into regular cells instead.  Accepted for API parity, mapped
            # to the cell backend.
            warnings.warn(
                "nlist_type='tree' has no analogue here; using the "
                "cell-list backend (results identical, performance "
                "characteristics differ from the reference's GPU backend)",
                stacklevel=2,
            )

    def temperature(self, timestep):
        if callable(self.T):
            return self.T(timestep)
        return self.T

    def shear_rate(self, timestep):
        if self.function_form is None:
            return 0.0
        return self.function_form.shear_rate(timestep)


class Simulation:
    """Owns the state pytree, the compiled step, and the host run loop."""

    def __init__(
        self,
        positions,
        L,
        dt: float,
        images=None,
        tilt_xy: float = 0.0,
        force_fn: Optional[Callable] = None,
        sync_every: int = 100,
    ):
        # force_fn(pos, timestep) -> (N, 3) runs inside jit/scan: it must be
        # written with jax.numpy (traceable), not numpy.
        self.positions0 = np.asarray(positions, np.float32)
        self.n = self.positions0.shape[0]
        self.L = (float(L),) * 3 if np.isscalar(L) else tuple(float(x) for x in L)
        self.dt = float(dt)
        self.force_fn = force_fn
        self.sync_every = int(sync_every)
        self.method: Optional[PSEv1] = None
        self.config: Optional[StepConfig] = None
        self._group = None
        self.shear_variant: Optional[shear_function.ShearVariant] = None
        self.state = make_state(self.positions0, tilt_xy=tilt_xy)
        if images is not None:
            self.state = self.state._replace(images=jnp.asarray(images, jnp.int32))
        self._run_chunk_cache = {}
        self.step_timing = []
        # Per-step observability (SURVEY.md §5: "step timing and Lanczos m"):
        # m_lanczos histogram {m: count}, overflow regrow retries, total steps.
        self.metrics = {"m_lanczos_hist": {}, "overflow_retries": 0, "steps": 0}

    # -- setup ------------------------------------------------------------

    def set_integrator(
        self,
        method: PSEv1,
        max_neighbors: int | None = None,
        verbose: bool = True,
        engine: str = "blocked",
    ):
        # zero='now' protocols resolve against the sim's current step (the
        # reference resolves against the global HOOMD step counter).
        if method.function_form is not None:
            method = dataclasses.replace(
                method,
                function_form=shear_function.resolve_now(
                    method.function_form, int(self.state.step)
                ),
            )
        self.method = method
        params = make_params(
            xi=method.xi, error=method.error, L=self.L, max_strain=method.max_strain
        )
        thermal = True
        if not callable(method.T) and float(method.T) == 0.0:
            thermal = False
        if method.group is None:
            self._group = None
            n_hydro = self.n
        else:
            g = np.unique(np.asarray(method.group, np.int32).ravel())
            if g.size == 0 or g.min() < 0 or g.max() >= self.n:
                raise ValueError(
                    f"group indices must be unique and in [0, {self.n})"
                )
            # None when the group is everything — skip the subset plumbing.
            self._group = jnp.asarray(g) if g.size < self.n else None
            n_hydro = int(g.size) if self._group is not None else self.n
        self.config = make_config(
            params, n_hydro, thermal=thermal, seed=method.seed, engine=engine,
            max_tilt=method.max_strain, max_neighbors=max_neighbors,
            has_forces=self.force_fn is not None,
            # "stencil" = rcut/2 cells with a 125-stencil (CellListStencil
            # analogue); only the gather engine enumerates neighbors, the
            # blocked/banded engines bin directly.
            nbr_subdiv=2 if method.nlist_type.upper() == "STENCIL" else 1,
        )
        # Cell sizes and the spreading-Gaussian safety factor λ(γ) are built
        # for THIS worst-case tilt; set_params must not silently exceed it.
        self._built_max_strain = float(method.max_strain)
        if verbose:
            # One-time derived-parameter notice, as the reference prints
            # (Stokes.cc:238-254).
            print(params.summary())
        return self

    def set_params(self, T=None, function_form=None, max_strain: float = 0.5):
        """Change T / shear protocol on the fly (integrate.py:108-118).

        Like the reference, ξ/error cannot be changed after construction
        (no re-setParams path is exposed; build a new Simulation for that).
        """
        if self.method is None:
            raise RuntimeError("set_integrator first")
        if T is not None:
            self.method = dataclasses.replace(self.method, T=T)
            thermal = True
            if not callable(T) and float(T) == 0.0:
                thermal = False
            if thermal != self.config.thermal:
                # Keep the StepConfig invariant: going athermal on a
                # zero-force Simulation re-enables the (M·0) deterministic
                # path, exactly as make_config would have built it.
                changes = {"thermal": thermal}
                if not thermal and not self.config.has_forces:
                    changes["has_forces"] = True
                self.config = dataclasses.replace(self.config, **changes)
        if function_form is not None:
            if float(max_strain) > self._built_max_strain:
                # The neighbor/blocked cell sizes were tilt-inflated by the
                # max_strain passed at set_integrator time, and λ(γ) in the
                # spreading params likewise; a larger strain would silently
                # under-cover the tilted-box stencil.  Rebuild instead.
                raise ValueError(
                    f"max_strain={max_strain:g} exceeds the value the "
                    f"integrator was built with ({self._built_max_strain:g}); "
                    "call set_integrator again to rebuild for a larger strain"
                )
            self.method = dataclasses.replace(
                self.method,
                function_form=shear_function.resolve_now(
                    function_form, int(self.state.step)
                ),
                max_strain=max_strain,
            )
        # chunk closures capture self.method — invalidate them on any change
        self._run_chunk_cache.clear()
        return self

    def stop_shear(self, max_strain: float | None = None):
        """Replace the shear protocol with zero steady shear
        (integrate.py:121-123).  Defaults to the max_strain the integrator
        was built with (a larger value would be rejected by set_params)."""
        if max_strain is None:
            max_strain = self._built_max_strain
        return self.set_params(
            function_form=shear_function.steady(dt=0.0), max_strain=max_strain
        )

    def enable_shear_box(self, total_timesteps: int, max_strain: float = 0.5):
        """Register the box-tilting variant (variant.py:15-32 +
        hoomd.update.box_resize analogue)."""
        if self.method is None or self.method.function_form is None:
            raise RuntimeError("set_integrator with a function_form first")
        self.shear_variant = shear_function.ShearVariant(
            self.method.function_form, total_timesteps, max_strain
        )
        return self

    # -- compiled chunk runner -------------------------------------------

    def _chunk_fn(self, n_steps: int):
        key = (
            n_steps, self.config, id(self.force_fn), id(self.shear_variant),
            id(self._group),
        )
        if key in self._run_chunk_cache:
            return self._run_chunk_cache[key]

        config = self.config
        method = self.method
        dt = self.dt
        force_fn = self.force_fn
        variant = self.shear_variant
        group = self._group

        def body(state: State, _):
            t = state.step
            forces = (
                force_fn(state.pos, t)
                if force_fn is not None
                else jnp.zeros_like(state.pos)
            )
            shear_rate = method.shear_rate(t)
            new_tilt = variant.value(t + 1) if variant is not None else None
            if group is None:
                new_state, info = _step(
                    config, state, forces, method.temperature(t), dt,
                    shear_rate, new_tilt,
                )
                return new_state, {
                    "m_lanczos": info["m_lanczos"],
                    "overflow": info["nbr_overflow"],
                }
            # Group subset (Stokes.cc:85-111 semantics): the hydrodynamic
            # system consists of group members only; non-members are frozen
            # scenery (they can still exert forces via force_fn, which sees
            # the full position array).
            sub = State(
                pos=state.pos[group],
                images=state.images[group],
                step=state.step,
                tilt_xy=state.tilt_xy,
                m_lanczos=state.m_lanczos,
                nbr_overflow=state.nbr_overflow,
            )
            new_sub, info = _step(
                config, sub, forces[group], method.temperature(t), dt,
                shear_rate, new_tilt,
            )
            new_state = State(
                pos=state.pos.at[group].set(new_sub.pos),
                images=state.images.at[group].set(new_sub.images),
                step=new_sub.step,
                tilt_xy=new_sub.tilt_xy,
                m_lanczos=new_sub.m_lanczos,
                nbr_overflow=new_sub.nbr_overflow,
            )
            return new_state, {
                "m_lanczos": info["m_lanczos"],
                "overflow": info["nbr_overflow"],
            }

        @jax.jit
        def run_chunk(state: State):
            final, ys = jax.lax.scan(body, state, None, length=n_steps)
            return final, ys

        self._run_chunk_cache[key] = run_chunk
        return run_chunk

    # -- host loop --------------------------------------------------------

    def run(
        self,
        n_steps: int,
        callback: Optional[Callable] = None,
        max_regrow: int = 8,
    ):
        """Advance n_steps (hoomd.run analogue) with overflow-safe chunking."""
        if self.config is None:
            raise RuntimeError("set_integrator first")
        remaining = int(n_steps)
        regrows = 0
        while remaining > 0:
            chunk = min(self.sync_every, remaining)
            snapshot = self.state
            t0 = time.perf_counter()
            new_state, ys = self._chunk_fn(chunk)(self.state)
            overflow = bool(new_state.nbr_overflow)
            elapsed = time.perf_counter() - t0
            if overflow:
                # Rewind, grow capacities, recompile, retry this chunk.
                regrows += 1
                if regrows > max_regrow:
                    raise RuntimeError(
                        f"capacity overflow persists after {max_regrow} "
                        "regrows; the configuration density is outside what "
                        "the engine's layout can absorb (try engine='blocked'"
                        " or a larger initial capacity)"
                    )
                flags = int(new_state.nbr_overflow)
                self.config = grow_config(self.config, flags=flags)
                self.state = snapshot
                self.metrics["overflow_retries"] += 1
                continue
            self.state = new_state
            self.step_timing.append((chunk, elapsed))
            for m in np.asarray(ys["m_lanczos"]).tolist():
                hist = self.metrics["m_lanczos_hist"]
                hist[int(m)] = hist.get(int(m), 0) + 1
            self.metrics["steps"] += chunk
            remaining -= chunk
            if callback is not None:
                callback(self)
        return self

    def metrics_summary(self) -> str:
        """One-line run statistics (the reference logs nothing per-step;
        SURVEY.md §5 sets this bar: step timing + Lanczos m)."""
        m = self.metrics
        hist = " ".join(
            f"m={k}:{v}" for k, v in sorted(m["m_lanczos_hist"].items())
        )
        wall = sum(e for _, e in self.step_timing)
        sps = m["steps"] / wall if wall > 0 else float("nan")
        return (
            f"steps={m['steps']} wall={wall:.3f}s ({sps:.1f} steps/s) "
            f"overflow_retries={m['overflow_retries']} lanczos[{hist}]"
        )

    # -- observables ------------------------------------------------------

    @property
    def box(self) -> Box:
        return Box(jnp.asarray(self.L, jnp.float32), self.state.tilt_xy)

    def mobility_matvec(self, forces):
        """Public deterministic U = M·F at the current configuration."""
        u, overflow = mobility(
            self.config, self.state.pos, jnp.asarray(forces, jnp.float32),
            self.state.tilt_xy,
        )
        if bool(overflow):
            raise RuntimeError("neighbor overflow in mobility; enlarge spec")
        return u

    def snapshot(self) -> dict:
        """Checkpoint payload: everything needed to resume (SURVEY.md §5)."""
        return {
            "pos": np.asarray(self.state.pos),
            "images": np.asarray(self.state.images),
            "step": int(self.state.step),
            "tilt_xy": float(self.state.tilt_xy),
            "m_lanczos": int(self.state.m_lanczos),
            "L": np.asarray(self.L),
            "dt": self.dt,
        }

    def save(self, path: str):
        np.savez(path, **self.snapshot())

    def restore(self, path: str):
        d = np.load(path)
        self.state = State(
            pos=jnp.asarray(d["pos"]),
            images=jnp.asarray(d["images"]),
            step=jnp.asarray(int(d["step"]), jnp.int32),
            tilt_xy=jnp.asarray(float(d["tilt_xy"]), jnp.float32),
            m_lanczos=jnp.asarray(int(d["m_lanczos"]), jnp.int32),
            nbr_overflow=jnp.asarray(0, jnp.int32),
        )
        # A 'now'-anchored protocol attached before restore re-anchors to the
        # restored step (explicit-int offsets are left alone).
        if self.method is not None and self.method.function_form is not None:
            ff = shear_function.resolve_now(
                self.method.function_form, int(self.state.step)
            )
            if ff is not self.method.function_form:
                self.method = dataclasses.replace(self.method, function_form=ff)
                if self.shear_variant is not None:
                    self.shear_variant = dataclasses.replace(
                        self.shear_variant, func=ff
                    )
                self._run_chunk_cache.clear()
        return self


def create_lattice(n_per_side: int, L: float) -> np.ndarray:
    """Simple-cubic lattice positions (examples/run.py:27-34 analogue)."""
    a = L / n_per_side
    grid = (np.arange(n_per_side) + 0.5) * a - L / 2.0
    x, y, z = np.meshgrid(grid, grid, grid, indexing="ij")
    return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1).astype(np.float32)
