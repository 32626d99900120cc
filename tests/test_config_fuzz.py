"""Config-interaction fuzz: the fused RK45 kernel vs the vmap path across
random SolverConfig knob combinations.

The config surface has knobs whose pairwise interactions are easy to break
silently (controller x compensated, step-align x detector cadences...).
Each seeded sample draws a legal config, integrates the same small
Model-204 batch through BOTH paths, and requires tolerance-level agreement
plus identical failure flags.  Interpret-mode kernel (CPU).

Reference anchor: the CUDA reference has exactly one configuration
(hard-coded, main.cpp:610-657); this suite is the price of making all of it
configurable.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from __graft_entry__ import _scenario
from tiger_tpu.models import Model204
from tiger_tpu.solver import SolverConfig
from tiger_tpu.solver.rk45 import rk45_solve
from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas


def _draw(rng) -> SolverConfig:
    controller = rng.choice(["i", "pi"])
    compensated = bool(rng.integers(0, 2))
    # Two draws of retired kernel-only knobs (fsal, dense_lockstep) stay in
    # the sequence, so every seed keeps drawing the same configuration.
    rng.integers(0, 2)
    rtol = float(rng.choice([1e-4, 1e-5]))
    atol = float(rng.choice([1e-7, 1e-8]))
    rng.integers(0, 2)
    return SolverConfig(
        rtol=rtol,
        atol=atol,
        max_steps=50_000,
        controller=controller,
        compensated=compensated,
        forcing_step_align=bool(rng.integers(0, 2)),
        stiff_detect=bool(rng.integers(0, 2)),
        nan_shrink=float(rng.choice([0.2, 0.5])),
        max_scale=float(rng.choice([5.0, 10.0])),
    )


@pytest.mark.parametrize("seed", range(6))
def test_kernel_matches_vmap_under_random_config(seed):
    rng = np.random.default_rng(100 + seed)
    cfg = _draw(rng)
    s, tf = 8, 1440.0
    y0, params, forc = _scenario(s, jnp.float32, days=1.0, stiff_frac=0.0)
    qt = jnp.arange(0.0, tf + 1e-9, 360.0, dtype=jnp.float32)
    h0 = jnp.full((s,), 1e-3, jnp.float32)

    ker = rk45_solve_pallas(
        Model204(), y0, 0.0, tf, qt, params, forc, h0=h0, config=cfg,
        interpret=True,
    )
    ref = rk45_solve(
        Model204(), y0, 0.0, tf, qt, params, forc, h0=h0, config=cfg
    )
    assert not np.asarray(ker.failed).any(), cfg
    assert not np.asarray(ref.failed).any(), cfg
    np.testing.assert_array_equal(
        np.asarray(ker.stiff), np.asarray(ref.stiff), err_msg=str(cfg)
    )
    # Tolerance is config-aware: with forcing_step_align OFF, both paths
    # integrate stale frozen forcing across ZOH boundaries and the crossing
    # error is STEP-SEQUENCE-dependent (the documented reference-parity
    # regime, SolverConfig.forcing_step_align) — paths with different step
    # sequences legitimately diverge at the percent level, same band as
    # tests/test_chunked.py uses for window-restart perturbations.
    rt_f, at_f = (5e-4, 5e-6) if cfg.forcing_step_align else (6e-2, 1e-3)
    rt_d, at_d = (5e-3, 5e-5) if cfg.forcing_step_align else (8e-2, 2e-3)
    np.testing.assert_allclose(
        np.asarray(ker.y_final), np.asarray(ref.y_final),
        rtol=rt_f, atol=at_f, err_msg=str(cfg),
    )
    np.testing.assert_allclose(
        np.asarray(ker.dense), np.asarray(ref.dense),
        rtol=rt_d, atol=at_d, err_msg=str(cfg),
    )


@pytest.mark.parametrize("seed", range(4))
def test_radau_kernel_matches_vmap_under_random_config(seed):
    """Implicit-path knob interactions (error mode x freeze x reuse x
    predictor): fused Radau kernel vs vmap Radau on a stiff decay batch."""
    from tiger_tpu.kernels.radau_pallas import radau_solve_pallas
    from tiger_tpu.solver.radau import radau_solve

    @dataclasses.dataclass(frozen=True)
    class Decay2:
        N_EQ: int = 2
        UID: int = 96

        def rhs_tuple(self, t, y, p, f=None):
            return (p["lam"] * (y[0] - jnp.cos(t)), -0.5 * y[1])

        def rhs(self, t, y, p, f=None):
            return jnp.stack(self.rhs_tuple(t, y, p, f))

    rng = np.random.default_rng(200 + seed)
    cfg = SolverConfig(
        rtol=1e-4, atol=1e-6, max_steps=20_000,
        radau_error_mode=str(rng.choice(["embedded3", "radau5"])),
        radau_h_freeze_hi=float(rng.choice([1.0, 1.2])),
        radau_factor_reuse=bool(rng.integers(0, 2)),
        radau_predictor=bool(rng.integers(0, 2)),
    )
    s = 8
    params = {"lam": jnp.full((s,), float(rng.choice([-50.0, -1e3])), jnp.float32)}
    y0 = jnp.tile(jnp.asarray([2.0, 1.0], jnp.float32), (s, 1))
    h0 = jnp.full((s,), 1e-3, jnp.float32)
    qt = jnp.asarray([2.0, 5.0], jnp.float32)
    ker = radau_solve_pallas(
        Decay2(), y0, 0.0, 5.0, qt, params, h0=h0, config=cfg, interpret=True
    )
    cfg_v = dataclasses.replace(cfg, radau_factor_reuse=False)
    ref = radau_solve(Decay2(), y0, 0.0, 5.0, qt, params, h0=h0, config=cfg_v)
    assert not np.asarray(ker.failed).any(), cfg
    assert not np.asarray(ref.failed).any(), cfg
    np.testing.assert_allclose(
        np.asarray(ker.y_final), np.asarray(ref.y_final),
        rtol=5e-3, atol=1e-4, err_msg=str(cfg),
    )
    np.testing.assert_allclose(
        np.asarray(ker.dense), np.asarray(ref.dense),
        rtol=1e-2, atol=1e-4, err_msg=str(cfg),
    )
