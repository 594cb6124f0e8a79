"""Lanczos square root of the near-field mobility: u = M_real^{1/2} · ψ.

Chow & Saad Krylov sampling (SIAM J. Sci. Comput. 36(2), A588), re-designed
for XLA from the host-driven loop of gpu_stokes_BrealLanczos_wrap
(Brownian.cu:357-765):

  * the reference round-trips two scalars to the host and calls
    LAPACKE_spteqr per iteration; here the whole adaptive iteration is ONE
    on-device ``lax.while_loop`` with a jnp.linalg.eigh of the (zero-padded)
    tridiagonal each round — no host sync anywhere.
  * the zero-padding trick: the m_max×m_max tridiagonal with α, β beyond the
    active m left at zero is block-diagonal [T_m ⊕ 0]; its extra eigenpairs
    have zero first component, so T^{1/2}e₁ computed on the padded matrix
    equals the active-block result exactly — no dynamic shapes.
  * the convergence test runs in COEFFICIENT space: with an orthonormal
    Krylov basis, ‖vel_j − vel_{j−1}‖ = ‖f_j − f_{j−1}‖ where
    f = T^{1/2}e₁ is the (m_max,) coefficient vector — so the loop never
    touches the (m_max, *S) basis, and the basis contraction runs ONCE
    after the loop instead of every iteration.  (The reference recomputes
    the full-length vector per iteration, Brownian.cu:604-736, because its
    loop lives on the host anyway; numerically the two tests agree to the
    basis' loss of orthogonality, far below the 1e-3-ish target here.)
  * adaptive m with warm start (reference persists m across steps,
    Stokes.h:157): at least ``max(m_start-1,1)+1`` iterations run, then
    iterations continue until the relative step norm drops below ``error``
    (Brownian.cu:604-736) or m reaches m_max or the basis collapses
    (‖v‖ < 1e-8, Brownian.cu:507-510).
  * m_max is a STATIC cap but small by default (integrator.make_config):
    the per-iteration eigh is O(m_max³) and the basis O(m_max·3N), so a
    tight cap is real time and memory; hitting the cap unconverged sets the
    returned ``hit_cap`` flag, which the step folds into the sticky
    overflow flag — api.Simulation.run rewinds and regrows (m_max ×2, like
    any capacity overflow) instead of silently accepting the m_max result
    the way the reference's fixed 100 cap does (Brownian.cu:397).

Returns (M_real^{1/2}ψ, m_used, hit_cap).  The caller applies the thermal
scale √(2T/dt) (Brownian.cu:739 keeps it inside — split out here so
covariance tests read ⟨uuᵀ⟩ = M_real directly).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class _LanczosState(NamedTuple):
    j: jax.Array            # iterations completed
    V: jax.Array            # (m_max, *S) basis — engine-native layout
    alpha: jax.Array        # (m_max,)
    beta: jax.Array         # (m_max,)  beta[i] pairs V[i-1], V[i]
    vj: jax.Array           # (*S,)
    vjm1: jax.Array         # (*S,)
    tempbeta: jax.Array     # scalar: next beta to store
    f: jax.Array            # (m_max,) current T^{1/2}e1 coefficients
    stepnorm: jax.Array     # scalar
    breakdown: jax.Array    # bool


def _dot(a, b):
    return jnp.sum(a * b)


def _sqrt_tridiag_e1(alpha, beta, m_max):
    """f = T^{1/2} e₁ for the zero-padded symmetric tridiagonal (m_max,)."""
    T = (
        jnp.diag(alpha)
        + jnp.diag(beta[1:m_max], 1)
        + jnp.diag(beta[1:m_max], -1)
    )
    lam, Q = jnp.linalg.eigh(T)
    slam = jnp.sqrt(jnp.maximum(lam, 0.0))
    return Q @ (slam * Q[0, :])


def sqrt_mreal(
    matvec_t: Callable[[jax.Array], jax.Array],
    psi_t: jax.Array,
    error: float,
    m_start: jax.Array,
    m_max: int = 48,
    w0=None,
):
    """Compute (M_real^{1/2} ψ, m_used, hit_cap).

    ``matvec_t`` applies M_real in the ENGINE-NATIVE transposed layout —
    (3, N) for the gather engine, (3, C, cap) cell slots for the banded and
    blocked engines — and ``psi_t`` is a vector in that same layout; the
    whole Krylov iteration (basis storage included) runs in that layout, so
    no flat↔tiled reshape copies happen around the matvec custom calls
    (each would cost one full-vector copy per iteration).  Returns u in the
    same native layout.

    ``w0``: optional precomputed M·v₀ (native layout), v₀ = ψ/‖ψ‖ — the
    step passes this to ride the deterministic M·F on the first Lanczos
    matvec (one 2-RHS A stream instead of two single ones); the first
    iteration then runs unrolled outside the while_loop.
    """
    S = psi_t.shape
    dtype = psi_t.dtype
    eps_breakdown = 1e-8

    matvec = matvec_t

    vnorm = jnp.sqrt(_dot(psi_t, psi_t))
    psinorm = vnorm
    # ψ·Mψ/‖ψ‖² (the step-norm normalizer, Brownian.cu:452-457) equals α₀ of
    # the Lanczos recurrence (v₀·Mv₀ with v₀ = ψ/‖ψ‖), so unlike the
    # reference we don't spend an extra matvec on it — the convergence check
    # reads alpha[0] once the first iteration has stored it.

    v0 = psi_t / vnorm
    warm = jnp.clip(jnp.asarray(m_start, jnp.int32) - 1, 1, m_max - 1)

    def iter_with_w(state: _LanczosState, w_raw, assemble: bool) -> _LanczosState:
        j = state.j
        V = jax.lax.dynamic_update_index_in_dim(state.V, state.vj, j, axis=0)
        beta = state.beta.at[j].set(state.tempbeta)

        w = w_raw - state.tempbeta * state.vjm1
        a = _dot(state.vj, w)
        alpha = state.alpha.at[j].set(a)
        w = w - a * state.vj
        nb = jnp.sqrt(_dot(w, w))
        breakdown = nb < eps_breakdown
        vnext = w / jnp.where(breakdown, 1.0, nb)

        # ``assemble``: the T^{1/2}e1 coefficient assembly (eigh + its
        # small-op storm) runs only in iterations whose stepnorm can reach
        # the stopping test — the warm-start phase skips it (its stepnorms
        # are overridden by the `j < warm + 1` floor anyway), and the final
        # result vector is assembled ONCE after the loops from the stored
        # (alpha, beta).  Within an assembling iteration the math is
        # unconditional — a lax.cond here would materialize its captured
        # operands (the whole Krylov basis) every iteration.
        if assemble:
            f = _sqrt_tridiag_e1(alpha, beta, state.V.shape[0])
            psi_m_psi = alpha[0]
            df = f - state.f
            stepnorm = jnp.sqrt(_dot(df, df) / psi_m_psi)
        else:
            f, stepnorm = state.f, state.stepnorm

        return _LanczosState(
            j=j + 1,
            V=V,
            alpha=alpha,
            beta=beta,
            vj=vnext,
            vjm1=state.vj,
            tempbeta=nb,
            f=f,
            stepnorm=stepnorm,
            breakdown=breakdown,
        )

    def warm_iter(state: _LanczosState) -> _LanczosState:
        return iter_with_w(state, matvec(state.vj), assemble=False)

    def lanczos_iter(state: _LanczosState) -> _LanczosState:
        return iter_with_w(state, matvec(state.vj), assemble=True)

    def warm_cond(state: _LanczosState):
        # Iterations 0..warm-2 never decide convergence: the stopping test
        # below keeps iterating while j < warm + 1 regardless of stepnorm,
        # and the deciding stepnorm |f_warm - f_{warm-1}| only needs f from
        # iterations warm-1 and warm — so everything earlier can skip the
        # assembly entirely (f stays 0; the first assembling iteration's
        # stepnorm is then ||f|| >> error, which the j-floor overrides).
        return (state.j < warm - 1) & ~state.breakdown

    def cond(state: _LanczosState):
        need_more = (state.j < warm + 1) | (state.stepnorm > error)
        return (state.j < m_max) & ~state.breakdown & need_more

    init = _LanczosState(
        j=jnp.asarray(0, jnp.int32),
        V=jnp.zeros((m_max,) + S, dtype),
        alpha=jnp.zeros((m_max,), dtype),
        beta=jnp.zeros((m_max,), dtype),
        vj=v0,
        vjm1=jnp.zeros_like(v0),
        tempbeta=jnp.asarray(0.0, dtype),
        f=jnp.zeros((m_max,), dtype),
        stepnorm=jnp.asarray(jnp.inf, dtype),
        breakdown=jnp.asarray(False),
    )

    # First iteration unrolled: its matvec result may be precomputed (w0,
    # the 2-RHS fusion) — at j=0, tempbeta=0 and vjm1=0, so w_raw = M·v₀
    # exactly.  It runs assembly-free like the rest of the warm phase (the
    # only case where iteration 0 could decide is a cold m_start ≤ 2 that
    # converges immediately — then one extra iteration runs; never fewer).
    first_w = (
        matvec(v0) if w0 is None
        else jnp.asarray(w0, dtype)
    )
    state1 = iter_with_w(init, first_w, assemble=False)
    state_w = jax.lax.while_loop(warm_cond, warm_iter, state1)
    final = jax.lax.while_loop(cond, lanczos_iter, state_w)
    # The result coefficients come from the LAST assembling iteration's f:
    # that iteration computed _sqrt_tridiag_e1 over the same stored
    # (alpha, beta) arrays the final state carries, so recomputing it here
    # would duplicate the eigh — a storm of ~100 small ops whose launch
    # latency dwarfs the 24×24 math.  The only path on which final.f
    # is stale is a breakdown BEFORE the first assembling iteration (the
    # main loop then runs zero iterations and the warm-phase f is still
    # 0); the cond's captured operands are (m_max,) vectors, so the
    # materialization cost that rules lax.cond out inside the iteration
    # (the big basis captured) does not apply here.
    # Breakdown truncation stays exact either way: zero-padded trailing
    # blocks decouple, Brownian.cu:507-510 semantics.
    f_final = jax.lax.cond(
        final.j == state_w.j,          # no assembling iteration ran
        lambda ab: _sqrt_tridiag_e1(ab[0], ab[1], m_max),
        lambda ab: final.f,
        (final.alpha, final.beta),
    )
    vel = jnp.einsum(
        "m,m...->...", f_final, final.V, preferred_element_type=jnp.float32
    ).astype(dtype)
    u = vel * psinorm
    hit_cap = (
        (final.j >= m_max) & ~final.breakdown & (final.stepnorm > error)
    )
    return u, final.j, hit_cap
