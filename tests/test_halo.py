"""x-slab halo decomposition (parallel/halo.py) vs the single-device banded
engine, on the 8-virtual-CPU-device mesh (conftest provisions the devices).

The halo engine must be numerically IDENTICAL in structure to the banded
engine (the same matvec on extended slabs), so tolerances here are
f32-noise level, not physics level.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pse_tpu as pse
from pse_tpu import integrator
from pse_tpu.parallel import halo, sharding as sh


def _setup(n, L, seed=0, thermal=False, slabs=4, **kw):
    rng = np.random.default_rng(seed)
    params = pse.make_params(xi=0.5, error=1e-3, L=L)
    pos = rng.uniform(-L / 2, L / 2, size=(n, 3)).astype(np.float32)
    forces = rng.normal(size=(n, 3)).astype(np.float32)
    cfg = integrator.make_config(
        params, n, thermal=thermal, seed=5, engine="banded",
        shard_slabs=slabs, **kw
    )
    assert cfg.engine == "banded", "test geometry must support banding"
    assert cfg.band_spec.bins.n_cells[0] % slabs == 0
    return cfg, pos, forces


def _mesh(d=4):
    # 4 of the 8 virtual devices: full halo semantics at half the cost of
    # 8 (the 8-way case runs in __graft_entry__.dryrun_multichip)
    return sh.make_mesh(jax.devices("cpu")[:d])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_halo_mobility_matches_single_device():
    # 4 slabs of >= rcut wide columns needs L_x >= 4*rcut*1.5;
    # occupancy high enough that cap (4-sigma slack) >= the band window
    n, L = 4_800, 33.0
    cfg, pos, forces = _setup(n, L, seed=1, block_dtype="float32")
    mesh = _mesh()
    u1, ov1 = integrator.mobility(cfg, pos, forces)
    hm = halo.make_halo_mobility(cfg, mesh)
    u8, ov8 = hm(pos, forces)
    assert not bool(ov1) and not bool(ov8)
    assert _rel(u8, u1) < 2e-5


def test_halo_step_matches_single_device_thermal():
    n, L = 4_800, 33.0
    cfg, pos, forces = _setup(n, L, seed=2, thermal=True)
    mesh = _mesh()
    state = integrator.make_state(pos)
    s1, info1 = integrator.step(cfg, state, jnp.asarray(forces),
                                1.0, 1e-3, 0.1, new_tilt=0.01)

    hstep = halo.make_halo_step(cfg, mesh)
    state8 = sh.shard_state(state, mesh)
    f8 = jax.device_put(jnp.asarray(forces), sh.particle_sharding(mesh))
    s8, info8 = hstep(state8, f8, 1.0, 1e-3, 0.1, new_tilt=0.01)

    assert not bool(s8.nbr_overflow)
    assert int(s8.m_lanczos) == int(s1.m_lanczos)
    # same RNG stream, same operators; f32 reduction orders differ across
    # the slab boundary (and feed Lanczos), hence the loose-ish tolerance
    d1 = np.asarray(s1.pos) - pos
    d8 = np.asarray(s8.pos) - pos
    assert np.linalg.norm(d8 - d1) / np.linalg.norm(d1) < 5e-3


def test_halo_mreal_t2_matches_two_singles():
    """The halo engine's 2-RHS matvec under shard_map must equal two single
    matvecs — the plumbing the step's fuse2 path rides (exchange_x with 6
    rows, NR-generic interior slicing)."""
    n, L = 4_800, 33.0
    cfg, pos, forces = _setup(n, L, seed=3, thermal=True)
    mesh = _mesh()
    eng = halo.make_halo_engine(cfg, mesh)
    box = integrator._box_of(cfg, 0.0)
    ctx, ovf = eng.prepare(cfg, jnp.asarray(pos), box)
    assert not bool(jnp.any(ovf))
    fa = eng.f_slots_t(ctx, jnp.asarray(forces))
    fb = eng.f_slots_t(ctx, jnp.asarray(forces[::-1].copy()))
    u2 = eng.mreal_t2(ctx, jnp.concatenate([fa, fb], axis=0))
    ua = eng.mreal_t(ctx, fa)
    ub = eng.mreal_t(ctx, fb)
    assert _rel(u2[0:3], ua) < 1e-6
    assert _rel(u2[3:6], ub) < 1e-6


def test_halo_requires_banded():
    params = pse.make_params(xi=0.5, error=1e-3, L=24.0)
    cfg = integrator.make_config(params, 128, engine="gather")
    with pytest.raises(ValueError):
        halo.make_halo_engine(cfg, _mesh())


def test_halo_mobility_triton_kernel_interpret(monkeypatch):
    """The halo engine with the Triton near-field kernel (interpret mode)
    under shard_map agrees with the single-device reference engine: the
    kernel runs on each slab's local extended grid."""
    from functools import partial

    from pse_tpu.ops import banded_nearfield as bdn

    n, L = 4_800, 33.0
    cfg, pos, forces = _setup(n, L, seed=4, block_dtype="float32")
    u1, ov1 = integrator.mobility(cfg, pos, forces)
    monkeypatch.setattr(bdn, "select_nf_impl",
                        lambda platform=None: bdn.NF_TRITON)
    monkeypatch.setattr(bdn, "matvec_banded",
                        partial(bdn.matvec_banded, interpret=True))
    u4, ov4 = halo.make_halo_mobility(cfg, _mesh())(pos, forces)
    assert not bool(ov1) and not bool(ov4)
    assert _rel(u4, u1) < 2e-5
