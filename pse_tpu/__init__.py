"""pse_tpu — Positively Split Ewald (PSE) Brownian dynamics in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
stochasticHydroTools/PSE HOOMD plugin (Fiore, Balboa Usabiaga, Donev & Swan,
J. Chem. Phys. 146, 124116 (2017)): one-step overdamped Brownian dynamics of
monodisperse spheres with full many-body hydrodynamic interactions via the
Ewald-split Rotne-Prager-Yamakawa mobility, with the positively-split
square root (Lanczos for the real-space part, per-mode rescale for the
wave-space part), under optional time-dependent linear shear.

Everything compiles to a single XLA program per step; the FFT grid and
particle arrays shard over a ``jax.sharding.Mesh`` for multi-chip runs.
"""

from . import box
from . import neighbors
from . import params
from . import tables
from . import shear as shear_function
from . import integrator
from . import integrate
from . import variant
from .api import PSEv1, Simulation, create_lattice
from .box import Box, make_box
from .integrator import State, StepConfig, make_state, mobility, step
from .params import PSEParams, make_params

__version__ = "0.1.0"
