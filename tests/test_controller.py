"""PI (Lund-stabilized) step-size controller: accuracy + rejection savings.

The reference uses plain integral control h *= safety*err^(-1/5)
(src/solver/rk45_kernel.cu:118-127); ``SolverConfig(controller='pi')`` adds
the DOPRI5 stabilization (Hairer & Wanner II.4): exponent 1/5 - 0.75*beta on
the current error, +beta on the previous ACCEPTED error.  Non-parity opt-in:
results must agree at controller tolerance while rejected attempts drop.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tiger_tpu.forcing import ForcingSet
from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
from tiger_tpu.models import DummyModel, Model204
from tiger_tpu.solver import SolverConfig, rk45_solve

CFG_I = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=50_000)
CFG_PI = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=50_000, controller="pi")


def _model204_scenario(s_count, dtype=jnp.float64, hours=48):
    from tests.test_model204 import NB_PARAMS

    rng = np.random.default_rng(7)
    params = {
        k: jnp.asarray(np.full(s_count, v) * rng.uniform(0.9, 1.1, s_count), dtype)
        for k, v in NB_PARAMS.items()
    }
    # Hour-to-hour varying rain: every ZOH boundary is a slope kink, the
    # regime where controller oscillation costs rejections.
    pr = rng.uniform(0, 0.0015, (hours, s_count)).astype(np.float32)
    t2m = rng.uniform(-2, 10, (max(hours // 24, 1), s_count)).astype(np.float32)
    forc = ForcingSet.from_series([pr, t2m], [60.0, 1440.0])
    y0 = jnp.tile(jnp.asarray([0.01, 3.0, 0.0, 5.0, 0.2], dtype), (s_count, 1))
    return y0, params, forc


def test_pi_matches_i_at_tolerance_dummy():
    rng = np.random.default_rng(0)
    y0 = jnp.asarray(rng.uniform(0.5, 2.0, (32, 5)))
    qt = jnp.linspace(0.5, 5.0, 10)
    a = rk45_solve(DummyModel(), y0, 0.0, 5.0, qt, config=CFG_I)
    b = rk45_solve(DummyModel(), y0, 0.0, 5.0, qt, config=CFG_PI)
    np.testing.assert_allclose(
        np.asarray(a.y_final), np.asarray(b.y_final), rtol=1e-5, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(a.dense), np.asarray(b.dense), rtol=1e-4, atol=1e-7
    )
    assert not bool(np.asarray(b.stiff).any())


def test_pi_reduces_rejections_on_forcing_kinks():
    """PI pays for itself on kinky forcing without costing accuracy.

    Accuracy is judged against a tight-tolerance ground truth, NOT controller
    vs controller: Model 204's melt threshold and min() kinks make the RHS
    non-smooth, so two valid step sequences at rtol 1e-6 legitimately diverge
    by ~1% in h_snow (local error control does not bound global error across
    discontinuity crossings).  Stiff-flagging of borderline lanes is likewise
    controller-dependent handoff policy (the full two-phase solve finishes
    them via Radau), so flagged lanes are excluded from the value comparison
    and only their count is bounded.  The truth run disables the stiffness
    heuristics (they trip spuriously at rtol 1e-9: consecutive-rejection
    streaks at ZOH kinks, h under span*1e-6).
    """
    s = 48
    y0, params, forc = _model204_scenario(s)
    tf = 48 * 60.0
    qt = jnp.arange(0.0, tf + 1, 360.0)
    a = rk45_solve(
        Model204(), y0, 0.0, tf, qt, params=params, forcings=forc, config=CFG_I
    )
    b = rk45_solve(
        Model204(), y0, 0.0, tf, qt, params=params, forcings=forc, config=CFG_PI
    )
    truth_cfg = SolverConfig(
        rtol=1e-9, atol=1e-12, max_steps=500_000,
        max_rejects=10**6, min_step_fraction=1e-14,
    )
    t = rk45_solve(
        Model204(), y0, 0.0, tf, qt, params=params, forcings=forc, config=truth_cfg
    )
    sa, sb, st = (np.asarray(r.stiff) for r in (a, b, t))
    assert not st.any(), "truth run must complete every lane"
    # Borderline lanes may flag under one controller and not the other.
    assert sa.sum() <= 1 and sb.sum() <= 1, (np.where(sa)[0], np.where(sb)[0])
    ok = ~(sa | sb)
    yt = np.asarray(t.y_final)

    def gerr(r):
        y = np.asarray(r.y_final)
        return (np.abs(y[ok] - yt[ok]) / (1e-7 + np.abs(yt[ok]))).max(axis=1)

    err_i, err_pi = gerr(a), gerr(b)
    # The stabilized controller must not cost accuracy: its global error vs
    # truth stays within 2x of the plain controller's (measured: PI is
    # actually slightly MORE accurate here — max 2.6% vs 3.4%).
    assert err_pi.max() <= max(2.0 * err_i.max(), 1e-2), (err_pi.max(), err_i.max())
    assert np.median(err_pi) <= 2.0 * np.median(err_i)
    # ...and must pay for itself: strictly fewer rejections AND no blow-up in
    # total attempts (smaller accepted steps would be a hidden cost).
    rej_i = int(np.asarray(a.stats.n_rejected).sum())
    rej_pi = int(np.asarray(b.stats.n_rejected).sum())
    att_i = int(np.asarray(a.stats.n_attempts).sum())
    att_pi = int(np.asarray(b.stats.n_attempts).sum())
    assert rej_pi < rej_i, (rej_pi, rej_i)
    assert att_pi <= 1.05 * att_i, (att_pi, att_i)


def test_pi_kernel_matches_vmap_pi():
    cfg = SolverConfig(rtol=1e-5, atol=1e-7, max_steps=20_000, controller="pi")
    rng = np.random.default_rng(0)
    y0 = jnp.asarray(rng.uniform(0.5, 2.0, (96, 5)), jnp.float32)
    qt = jnp.linspace(0.5, 5.0, 10, dtype=jnp.float32)
    h0 = jnp.full((96,), 0.05, jnp.float32)
    ref = rk45_solve(DummyModel(), y0, 0.0, 5.0, qt, h0=h0, config=cfg)
    ker = rk45_solve_pallas(
        DummyModel(), y0, 0.0, 5.0, qt, h0=h0, config=cfg, interpret=True
    )
    np.testing.assert_allclose(
        np.asarray(ker.y_final), np.asarray(ref.y_final), rtol=2e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(ker.dense), np.asarray(ref.dense), rtol=2e-5, atol=1e-6
    )
    # Same controller on both paths: attempt counts track closely.
    a = np.asarray(ker.stats.n_attempts).astype(np.int64)
    b = np.asarray(ref.stats.n_attempts).astype(np.int64)
    assert (np.abs(a - b) <= np.maximum(5, 0.25 * b)).all()


def test_controller_validation():
    with pytest.raises(ValueError, match="controller"):
        SolverConfig(controller="pid")
    with pytest.raises(ValueError, match="pi_beta"):
        SolverConfig(controller="pi", pi_beta=0.5)
