"""Compensated (Kahan) float32 state accumulation — SolverConfig.compensated.

The tight-tolerance f32 path: plain f32 commits round at ~6e-8*|y| per step
and random-walk past rtol 1e-6 / atol 1e-9 (the reference's own artifact
tolerances, src/main.cpp:621) over thousand-step runs; the compensated commit
carries the lost low word (same TwoSum pattern the kernel uses for t).
"""

import numpy as np
import jax
import jax.numpy as jnp

from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
from tiger_tpu.models import DummyModel
from tiger_tpu.solver import SolverConfig, rk45_solve

TIGHT = dict(rtol=1e-6, atol=1e-9, max_steps=400_000, min_step_fraction=1e-9)


def _batch(s=6):
    rng = np.random.default_rng(5)
    return rng.uniform(0.5, 2.0, (s, 5))


def test_commit_formula_is_benign_in_f64():
    """In f64 the compensation perturbs only the sub-ulp accumulation (it
    carries f64's own low bits): results agree far below the tolerance and
    step counts match to within controller chatter."""
    y0 = jnp.asarray(_batch(), jnp.float64)
    a = rk45_solve(DummyModel(), y0, 0.0, 500.0, config=SolverConfig(**TIGHT))
    b = rk45_solve(
        DummyModel(), y0, 0.0, 500.0,
        config=SolverConfig(compensated=True, **TIGHT),
    )
    np.testing.assert_allclose(
        np.asarray(a.y_final), np.asarray(b.y_final), rtol=1e-8, atol=1e-12
    )
    assert (
        np.abs(
            np.asarray(a.stats.n_attempts).astype(np.int64)
            - np.asarray(b.stats.n_attempts)
        ).max()
        <= 5
    )


def test_f32_compensated_holds_tight_tolerances():
    """Long smooth run against the f64 truth.  At the reference tolerances
    (rtol 1e-6 / atol 1e-9) both f32 commits hold ~tolerance now that the
    committed time is compensated too (plain f32 measured 4.5e-6 when t was
    not).  At rtol 3e-7 the per-step rounding of y (~6e-8*|y|) dominates:
    compensated f32 stays at ~tolerance and plain f32 is measurably worse
    (1.9e-7 vs 3.1e-6 measured on this scenario)."""
    y0_np = _batch()
    rel = {}
    for rtol, atol in ((1e-6, 1e-9), (3e-7, 1e-10)):
        tight = dict(TIGHT, rtol=rtol, atol=atol)
        y64 = np.asarray(
            rk45_solve(
                DummyModel(), jnp.asarray(y0_np, jnp.float64), 0.0, 2000.0,
                config=SolverConfig(**tight),
            ).y_final
        )
        for comp in (False, True):
            r = rk45_solve(
                DummyModel(), jnp.asarray(y0_np, jnp.float32), 0.0, 2000.0,
                config=SolverConfig(compensated=comp, **tight),
            )
            assert not bool(np.asarray(r.stiff).any())
            rel[rtol, comp] = float(
                (np.abs(np.asarray(r.y_final) - y64) / np.maximum(np.abs(y64), 1e-12)).max()
            )
    assert rel[1e-6, True] < 2e-6, rel
    assert rel[1e-6, False] < 2e-6, rel
    assert rel[3e-7, True] < 6e-7, rel
    assert rel[3e-7, False] > 2.0 * rel[3e-7, True], rel


def test_kernel_matches_vmap_compensated():
    y0 = jnp.asarray(_batch(), jnp.float32)
    h0 = jnp.full((y0.shape[0],), 0.01, jnp.float32)
    qt = jnp.asarray([100.0, 900.0, 1800.0], jnp.float32)
    cfg = SolverConfig(compensated=True, **TIGHT)
    rv = rk45_solve(DummyModel(), y0, 0.0, 2000.0, qt, h0=h0, config=cfg)
    rk = rk45_solve_pallas(
        DummyModel(), y0, 0.0, 2000.0, qt, h0=h0, config=cfg, interpret=True
    )
    np.testing.assert_allclose(
        np.asarray(rk.y_final), np.asarray(rv.y_final), rtol=3e-6, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(rk.dense), np.asarray(rv.dense), rtol=2e-5, atol=1e-6
    )


def test_config_wiring():
    from tiger_tpu.config import SimulationConfig, SolverInfo

    cfg = SimulationConfig(solver=SolverInfo(precision="f32c"))
    assert cfg.solver_config().compensated is True
    assert SimulationConfig(solver=SolverInfo(precision="f32")).solver_config().compensated is False
