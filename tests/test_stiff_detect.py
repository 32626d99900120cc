"""Hairer stability-boundary stiffness detector (SolverConfig.stiff_detect).

The reference's criteria fire only on REJECTIONS (streak / h collapse,
rk45_kernel.cu:160-170) and miss two grinder classes the detector catches:
slope-cut treadmills (the absolute slope-jump guard halves h and discards the
step on 60%+ of attempts, 5x the useful work) and pinned accept-cruisers.
One such lane dilates its whole SIMD tile in the fused kernel (measured 3x
wall on the 131k bench) — flagging it early hands it to Radau, which
finishes it properly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tiger_tpu.forcing import ForcingSet
from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
from tiger_tpu.models import Model204
from tiger_tpu.solver import SolverConfig, rk45_solve


def _grinder_batch(s_count=4):
    """Model-204 lanes with near-zero static capacity Hu and warm (T>0)
    forcing: a fast stable ET drain (~1e5/min) that RK45 can only integrate
    at the stability boundary — the marginal ones never trip the reject-only
    criteria and grind thousands of slope-cut attempts."""
    rng = np.random.default_rng(0)
    base = dict(
        c1=0.001 / 60.0, infil=0.0001 * (0.001 / 60.0),
        perco=0.00005 * (0.001 / 60.0), Hu=1e-6, lat=41.5, sw=0.2, ss=0.8,
        n_mann=0.03, slope=0.05, L=1.0, A_h=10.0, alpha3=2880.0,
        alpha4=7200.0, melt_f=1e-5, temp_thr=0.0,
    )
    params = {
        k: jnp.asarray(np.full(s_count, v) * rng.uniform(0.9, 1.1, s_count), jnp.float32)
        for k, v in base.items()
    }
    pr = rng.uniform(0, 0.0015, (8, s_count)).astype(np.float32)
    t2m = rng.uniform(2.0, 10.0, (1, s_count)).astype(np.float32)  # warm
    forc = ForcingSet.from_series([pr, t2m], [60.0, 1440.0])
    y0 = jnp.tile(jnp.asarray([0.01, 3.0, 0.0, 5.0, 0.2], jnp.float32), (s_count, 1))
    return y0, params, forc


def test_slope_cut_grinder_flags_fast():
    y0, params, forc = _grinder_batch()
    h0 = jnp.full((y0.shape[0],), 1e-6, jnp.float32)
    on = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=30_000, stiff_detect=True)
    off = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=30_000, stiff_detect=False)
    r_on = rk45_solve(Model204(), y0, 0.0, 480.0, None, params, forc, h0=h0, config=on)
    assert bool(np.asarray(r_on.stiff).all())
    # Trips are uncadenced on slope cuts: flags within ~stiff_streak
    # treadmill cycles, not after thousands of attempts.
    assert int(np.asarray(r_on.stats.n_attempts).max()) < 500
    r_off = rk45_solve(Model204(), y0, 0.0, 480.0, None, params, forc, h0=h0, config=off)
    grind = np.asarray(r_off.stats.n_attempts)[~np.asarray(r_off.stiff)]
    if len(grind):  # any lane the reject-only criteria missed ground instead
        assert grind.min() > 1_000


def test_no_false_positives_on_kink_heavy_nonstiff_batch():
    """Harmless large |h*lambda| (positive / kink-bounded eigenvalues, e.g.
    Model 204 with T<0 ET sign flip) must NOT flag: lanes that finish in a
    few hundred steps never accumulate a cadenced streak."""
    from tests.test_model204 import NB_PARAMS

    s_count = 16
    rng = np.random.default_rng(3)
    params = {
        k: jnp.asarray(np.full(s_count, v) * rng.uniform(0.9, 1.1, s_count), jnp.float32)
        for k, v in NB_PARAMS.items()
    }
    pr = np.tile(rng.uniform(0, 0.0015, (1, s_count)), (24, 1)).astype(np.float32)
    t2m = rng.uniform(-2, -0.5, (1, s_count)).astype(np.float32)  # all cold
    forc = ForcingSet.from_series([pr, t2m], [60.0, 1440.0])
    y0 = jnp.tile(jnp.asarray([0.01, 3.0, 0.0, 5.0, 0.2], jnp.float32), (s_count, 1))
    h0 = jnp.full((s_count,), 1e-3, jnp.float32)
    cfg = SolverConfig(rtol=1e-5, atol=1e-7, max_steps=20_000, stiff_detect=True)
    r = rk45_solve(Model204(), y0, 0.0, 1440.0, None, params, forc, h0=h0, config=cfg)
    assert not bool(np.asarray(r.stiff).any())
    assert not bool(np.asarray(r.failed).any())


def test_kernel_matches_vmap_flags():
    y0, params, forc = _grinder_batch()
    h0 = jnp.full((y0.shape[0],), 1e-6, jnp.float32)
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=30_000, stiff_detect=True)
    rv = rk45_solve(Model204(), y0, 0.0, 480.0, None, params, forc, h0=h0, config=cfg)
    rk = rk45_solve_pallas(
        Model204(), y0, 0.0, 480.0, None, params, forc, h0=h0, config=cfg,
        interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(rv.stiff), np.asarray(rk.stiff))
    assert int(np.asarray(rk.stats.n_attempts).max()) < 500


def test_reference_parity_disables_detector():
    assert SolverConfig.reference_parity().stiff_detect is False
    with pytest.raises(ValueError, match="power of two"):
        SolverConfig(stiff_test_every=48)
