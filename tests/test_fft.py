"""The step's FFT wrappers (integrator._rfft3 / _irfft3, cuFFT on the GPU)
against numpy.fft in float64.

Covers the 2^a·3^b·5^c grid sizes params chooses (Stokes.cc:147-199
semantics) including odd z (irfft length recovery) and non-cubic boxes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pse_tpu.integrator import _irfft3, _rfft3

DIMS = [(96, 96, 96), (32, 48, 60), (8, 9, 10), (12, 12, 15), (25, 27, 16)]


@pytest.mark.parametrize("dims", DIMS)
def test_rfft3_matches_numpy(dims):
    rng = np.random.default_rng(sum(dims))
    g = rng.normal(size=(3,) + dims).astype(np.float32)
    ref = np.fft.rfftn(g.astype(np.float64), axes=(1, 2, 3))
    got = np.asarray(_rfft3(jnp.asarray(g)))
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dims", DIMS)
def test_irfft3_matches_numpy(dims):
    rng = np.random.default_rng(sum(dims) + 1)
    nh = dims[2] // 2 + 1
    gh = (rng.normal(size=(3,) + dims[:2] + (nh,))
          + 1j * rng.normal(size=(3,) + dims[:2] + (nh,))).astype(np.complex64)
    ref = np.fft.irfftn(gh.astype(np.complex128), s=dims, axes=(1, 2, 3))
    got = np.asarray(_irfft3(jnp.asarray(gh), dims))
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())


def test_roundtrip_identity():
    rng = np.random.default_rng(7)
    dims = (24, 30, 32)
    g = jnp.asarray(rng.normal(size=(3,) + dims).astype(np.float32))
    back = _irfft3(_rfft3(g), dims)
    np.testing.assert_allclose(np.asarray(back), np.asarray(g), atol=1e-5)


def test_jit_safe():
    """The transforms must trace cleanly inside jit (used in the step)."""
    dims = (12, 12, 12)
    g = jnp.ones((3,) + dims, jnp.float32)

    @jax.jit
    def f(g):
        return jnp.sum(jnp.abs(_rfft3(g)) ** 2)

    assert np.isfinite(float(f(g)))
