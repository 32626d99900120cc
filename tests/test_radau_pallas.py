"""Radau Pallas kernel vs the vmap Radau path (interpreter mode)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.integrate import solve_ivp

from tests.test_model204 import NB_PARAMS
from tiger_tpu.forcing import ForcingSet
from tiger_tpu.kernels.radau_pallas import radau_solve_pallas
from tiger_tpu.models import Model204
from tiger_tpu.solver import SolverConfig, radau_solve

CFG = SolverConfig(rtol=1e-4, atol=1e-6, max_steps=20_000)


@dataclasses.dataclass(frozen=True)
class Decay2:
    """y0' = lam*(y0 - cos t), y1' = -0.5*y1 — stiff for large |lam|."""

    N_EQ: int = 2
    UID: int = 97

    def rhs_tuple(self, t, y, p, f=None):
        return (p["lam"] * (y[0] - jnp.cos(t)), -0.5 * y[1])

    def rhs(self, t, y, p, f=None):
        return jnp.stack(self.rhs_tuple(t, y, p, f))


def test_stiff_decay_matches_scipy():
    s = 8
    lam = -1e4
    params = {"lam": jnp.full((s,), lam, jnp.float32)}
    y0 = jnp.tile(jnp.asarray([2.0, 1.0], jnp.float32), (s, 1))
    h0 = jnp.full((s,), 1e-4, jnp.float32)
    qt = jnp.asarray([5.0, 10.0], jnp.float32)
    res = radau_solve_pallas(
        Decay2(), y0, 0.0, 10.0, qt, params, h0=h0, config=CFG, interpret=True
    )
    assert not bool(np.asarray(res.failed).any())
    sol = solve_ivp(
        lambda t, y: [lam * (y[0] - np.cos(t)), -0.5 * y[1]],
        (0, 10.0), [2.0, 1.0], method="Radau", rtol=1e-6, atol=1e-9, dense_output=True,
    )
    # float32 implicit integration at rtol 1e-4.
    np.testing.assert_allclose(
        np.asarray(res.y_final[0]), sol.y[:, -1], rtol=5e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(res.dense[0, 0]), sol.sol(5.0), rtol=5e-3, atol=1e-4
    )


def test_matches_vmap_radau_on_mild_problem():
    s = 8
    params = {"lam": jnp.full((s,), -2.0, jnp.float32)}
    y0 = jnp.tile(jnp.asarray([2.0, 1.0], jnp.float32), (s, 1))
    h0 = jnp.full((s,), 0.01, jnp.float32)
    qt = jnp.asarray([1.0, 3.0], jnp.float32)
    ker = radau_solve_pallas(
        Decay2(), y0, 0.0, 3.0, qt, params, h0=h0, config=CFG, interpret=True
    )
    ref = radau_solve(Decay2(), y0, 0.0, 3.0, qt, params, h0=h0, config=CFG)
    # Same controller but kernel uses standard simplified Newton (J once per
    # step) vs the reference's per-stage-per-iteration refresh — tolerance
    # level agreement, not step-for-step.
    np.testing.assert_allclose(
        np.asarray(ker.y_final), np.asarray(ref.y_final), rtol=1e-3, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(ker.dense), np.asarray(ref.dense), rtol=1e-2, atol=1e-4
    )


def test_model204_kernel_radau_runs():
    s = 8
    rng = np.random.default_rng(5)
    params = {k: jnp.full((s,), v, jnp.float32) for k, v in NB_PARAMS.items()}
    pr = np.full((24, s), 0.001, np.float32)
    t2m = np.full((1, s), 5.0, np.float32)
    forc = ForcingSet.from_series([pr, t2m], [60.0, 1440.0])
    y0 = jnp.tile(jnp.asarray([0.01, 0.3, 0.0, 5.0, 0.2], jnp.float32), (s, 1))
    h0 = jnp.full((s,), 1e-3, jnp.float32)
    res = radau_solve_pallas(
        Model204(), y0, 0.0, 360.0, None, params, forc, h0=h0, config=CFG, interpret=True
    )
    assert not bool(np.asarray(res.failed).any())
    ref = radau_solve(Model204(), y0, 0.0, 360.0, None, params, forc, h0=h0, config=CFG)
    np.testing.assert_allclose(
        np.asarray(res.y_final), np.asarray(ref.y_final), rtol=5e-3, atol=1e-5
    )


def test_radau5_error_mode_kernel_matches_vmap():
    # The fused kernel's 'radau5' smoothed estimate (reusing the real
    # eigenbasis Newton factor, mu == gamma) vs the vmap implementation of
    # the same algorithm: tolerance-level trajectory agreement and a
    # comparable attempt budget on a genuinely stiff problem.
    cfg = SolverConfig(
        rtol=1e-4, atol=1e-6, max_steps=20_000, radau_error_mode="radau5"
    )
    s = 8
    lam = -1e4
    params = {"lam": jnp.full((s,), lam, jnp.float32)}
    y0 = jnp.tile(jnp.asarray([2.0, 1.0], jnp.float32), (s, 1))
    h0 = jnp.full((s,), 1e-4, jnp.float32)
    qt = jnp.asarray([5.0, 10.0], jnp.float32)
    ker = radau_solve_pallas(
        Decay2(), y0, 0.0, 10.0, qt, params, h0=h0, config=cfg, interpret=True
    )
    ref = radau_solve(Decay2(), y0, 0.0, 10.0, qt, params, h0=h0, config=cfg)
    assert not bool(np.asarray(ker.failed).any())
    assert not bool(np.asarray(ref.failed).any())
    np.testing.assert_allclose(
        np.asarray(ker.y_final), np.asarray(ref.y_final), rtol=5e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(ker.dense), np.asarray(ref.dense), rtol=5e-3, atol=1e-4
    )
    att_k = int(np.asarray(ker.stats.n_attempts).sum())
    att_v = int(np.asarray(ref.stats.n_attempts).sum())
    assert att_k < 2 * att_v + 100, (att_k, att_v)


def test_factor_reuse_optin_matches_default():
    """radau_factor_reuse (opt-in; DESIGN.md round-5 negative): stale factors
    are a quasi-Newton whose fixed point is the collocation solution, so the
    trajectory must agree with the refactorize-every-attempt default to
    controller tolerance, and RadauStats.n_fact must record genuine reuse
    (factorizations < attempts)."""
    s = 16
    params = {"lam": jnp.full((s,), -80.0, jnp.float32)}
    y0 = jnp.tile(jnp.asarray([2.0, 1.0], jnp.float32), (s, 1))
    h0 = jnp.full((s,), 0.01, jnp.float32)
    base = radau_solve_pallas(
        Decay2(), y0, 0.0, 5.0, None, params, h0=h0, config=CFG, interpret=True
    )
    cfg_r = dataclasses.replace(CFG, radau_factor_reuse=True)
    res = radau_solve_pallas(
        Decay2(), y0, 0.0, 5.0, None, params, h0=h0, config=cfg_r, interpret=True
    )
    assert not bool(np.asarray(res.failed).any())
    np.testing.assert_allclose(
        np.asarray(res.y_final), np.asarray(base.y_final), rtol=5e-3, atol=1e-5
    )
    att = np.asarray(res.stats.n_attempts).sum()
    fct = np.asarray(res.stats.n_fact).sum()
    assert 0 < fct < att, (fct, att)
    # The default path factorizes every attempt by construction.
    np.testing.assert_array_equal(
        np.asarray(base.stats.n_fact), np.asarray(base.stats.n_attempts)
    )
