"""Binning value-payload path: forces riding the binning sort must land in
exactly the slots vec_to_cells scatters them to (same cell_of/rank_of
placement), through the binnings' _scatter_values."""

import numpy as np
import jax.numpy as jnp

import pse_tpu as pse
from pse_tpu.box import Box
from pse_tpu.cellbins import (
    BinSpec, bin_columns, bin_particles, vec_to_cells,
)


def _setup(seed=0, n=4000, L=24.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    vals = rng.normal(size=(n, 3)).astype(np.float32)
    box = Box(jnp.asarray([L, L, L], jnp.float32), jnp.float32(0.1))
    return jnp.asarray(pos), jnp.asarray(vals), box


def test_bin_columns_values_match_vec_to_cells():
    pos, vals, box = _setup()
    spec = BinSpec(n_cells=(5, 5, 1), cap=256)
    bins, fcells = bin_columns(pos, box, spec, values=vals)
    bins2 = bin_columns(pos, box, spec)
    assert not bool(bins.overflow)
    ref = vec_to_cells(bins2, spec, vals)
    assert fcells.shape == ref.shape == (3, 25, 256)
    np.testing.assert_array_equal(np.asarray(fcells), np.asarray(ref))


def test_bin_particles_values_match_vec_to_cells():
    pos, vals, box = _setup(seed=3)
    spec = BinSpec(n_cells=(4, 4, 4), cap=128)
    bins, fcells = bin_particles(pos, box, spec, values=vals)
    bins2 = bin_particles(pos, box, spec)
    assert not bool(bins.overflow)
    ref = vec_to_cells(bins2, spec, vals)
    np.testing.assert_array_equal(np.asarray(fcells), np.asarray(ref))
