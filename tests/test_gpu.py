"""Card-only tests: the compiled Triton near-field kernel and the GPU step.

Collected everywhere, skipped off the card by the ``gpu_device`` fixture
(conftest.py).  Run on the card with

    PSE_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu
"""

import numpy as np
import jax.numpy as jnp
import pytest

import pse_tpu as pse
from pse_tpu import integrator
from pse_tpu.ops import banded_nearfield as bdn

pytestmark = pytest.mark.gpu


def _case(n, L, tilt, nrhs, seed):
    from pse_tpu.box import make_box
    from pse_tpu.cellbins import bin_columns, vec_to_cells

    rng = np.random.default_rng(seed)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg = integrator.make_config(params, n, thermal=False, engine="banded")
    assert cfg.engine == "banded"
    bs = cfg.band_spec
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    box = make_box(params.L, tilt)
    bins = bin_columns(jnp.asarray(pos), box, bs.bins)
    j0, nv, _ = bdn.compute_windows(bins, bs, box, params.ewald_cut)
    f = jnp.concatenate([
        vec_to_cells(bins, bs.bins, jnp.asarray(
            rng.normal(size=(n, 3)).astype(np.float32)))
        for _ in range(nrhs)
    ], axis=0)
    return cfg, bins, j0, nv, f


@pytest.mark.parametrize("nrhs", [1, 2])
@pytest.mark.parametrize("tilt", [0.0, 0.3])
def test_triton_kernel_matches_reference_on_card(gpu_device, tilt, nrhs):
    assert bdn.select_nf_impl() == bdn.NF_TRITON
    cfg, bins, j0, nv, f = _case(5000, 40.0, tilt, nrhs, seed=3)
    kern = integrator.banded_matvec(cfg, bdn.NF_TRITON)
    ref = integrator.banded_matvec(cfg, bdn.NF_REFERENCE)
    uk = np.asarray(kern(bins, tilt, cfg.band_spec, j0, nv, f))
    ur = np.asarray(ref(bins, tilt, cfg.band_spec, j0, nv, f))
    assert np.abs(uk - ur).max() / np.abs(ur).max() < 1e-5


def test_banded_step_on_card(gpu_device):
    """Banded and blocked engines agree on U = M·F on the card, and a
    thermal step is finite and overflow-free."""
    rng = np.random.default_rng(5)
    n, L = 5000, 40.0
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    cfg_b = integrator.make_config(params, n, thermal=True, engine="banded")
    cfg_d = integrator.make_config(params, n, thermal=False, engine="blocked")
    ub, ob = integrator.mobility(cfg_b, pos, forces, 0.2)
    ud, od = integrator.mobility(cfg_d, pos, forces, 0.2)
    assert not int(ob) and not int(od)
    err = float(jnp.max(jnp.abs(ub - ud)) / jnp.max(jnp.abs(ud)))
    assert err < 2e-3
    s, _ = integrator.step(cfg_b, integrator.make_state(pos),
                           jnp.asarray(forces), 1.0, 1e-3, 0.0)
    assert not int(s.nbr_overflow)
    assert bool(jnp.all(jnp.isfinite(s.pos)))
