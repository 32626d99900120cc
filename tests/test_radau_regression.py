"""Stiff-rung economics regression guard (round-3 incident).

Round 3 shipped ``radau_predictor=True`` as the default, which blew the
attempt counts of genuinely stiff lanes up ~30x (15k-82k attempts/lane vs
~2k from the f0 tile start) and cut the two-phase headline benchmark ~14x
(BENCH_r03: vs_baseline 0.07).  The correctness suite stayed green because
the RESULTS were still right — only the WORK exploded.  These tests pin the
economics, not the numerics: the bench's own stiff scenario must finish
within an attempts/sweeps budget on the default config, so a solver change
that silently multiplies the step or Newton work fails CI instead of
shipping.

Reference anchor: the Radau rung replaces radau_kernel.cu:20-140, whose
f(t, y) Newton start (radau_step_dense.cuh:80-87) is the baseline these
budgets encode.
"""

import jax.numpy as jnp
import numpy as np

from __graft_entry__ import _scenario
from tiger_tpu.models import Model204
from tiger_tpu.solver import SolverConfig
from tiger_tpu.solver.radau import radau_solve

# Budgets calibrated against the healthy (predictor-off) operating point of
# the 2-day fully-stiff scenario: 1.9k-2.6k attempts/lane at ~3.2 Newton
# sweeps/attempt (round-3 verdict experiment, reproduced here).  The round-3
# regression measured 15k-82k attempts/lane at ~9.9 sweeps — far outside.
ATTEMPTS_BUDGET = 5_000
SWEEPS_PER_ATTEMPT_BUDGET = 6.0


def _stiff_scenario(s_count=8, days=2.0):
    y0, params, forcings = _scenario(
        s_count, jnp.float32, days=days, stiff_frac=1.0
    )
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    return y0, params, forcings, cfg, days * 1440.0


def test_stiff_lane_attempts_budget():
    y0, params, forcings, cfg, tf = _stiff_scenario()
    res = radau_solve(
        Model204(), y0, 0.0, tf, None, params, forcings, config=cfg
    )
    assert not bool(res.failed.any())
    att = np.asarray(res.stats.n_attempts)
    assert att.max() <= ATTEMPTS_BUDGET, (
        f"stiff-lane attempts blew the budget: max {att.max()}/lane "
        f"(budget {ATTEMPTS_BUDGET}); round-3-style work regression"
    )
    sweeps = np.asarray(res.stats.n_newton).sum() / max(att.sum(), 1)
    assert sweeps <= SWEEPS_PER_ATTEMPT_BUDGET, (
        f"Newton sweeps/attempt {sweeps:.2f} exceed budget "
        f"{SWEEPS_PER_ATTEMPT_BUDGET}: bad Newton starts or broken reuse"
    )




def test_model200_radau_attempts_budget():
    """Model 200 through the Radau path: the implicit-kernel economics guard
    for the second model family (its throughput record is
    bench.py --solver radau --model 200).

    Model 200 has NO genuinely stiff scenario to pin: every flux in its RHS
    is rate-capped by design — ETactual's ramp is bounded by Emax ~ 4e-7
    m/min (ETmethods.cpp:47-59), Manning drainage is min-capped at the full
    store per minute (model_204.hpp:99-104), melt at the snow store, and
    alpha3/alpha4 drains at 1/min — so eigenvalues stay ~ -1/min.  Driving
    the ET ramp stiff requires (ss-sw)*Hu below the f32 solve tolerance
    (~1e-8 in state units), where the ramp is a knife-edge KINK, not a
    smooth stiff term: measured 100k-attempt Newton death-spirals, a
    pathological input rather than a stiff hillslope.  This test pins the
    MILD-lane implicit economics instead: calibrated max ~8.7k
    attempts/lane at ~5.0 sweeps/attempt (the kink-rich hourly-PET RHS
    costs Newton ~2.3x Model 204's).
    """
    from tiger_tpu.models import Model200

    y0, params, forcings = _scenario(8, jnp.float32, days=2.0, stiff_frac=0.0)
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    res = radau_solve(
        Model200(), y0, 0.0, 2880.0, None, params, forcings, config=cfg
    )
    assert not bool(res.failed.any())
    att = np.asarray(res.stats.n_attempts)
    assert att.max() <= 14_000, (
        f"Model-200 implicit attempts blew the budget: max {att.max()}/lane"
    )
    sweeps = np.asarray(res.stats.n_newton).sum() / max(att.sum(), 1)
    assert sweeps <= 7.0, f"Model-200 Newton sweeps/attempt {sweeps:.2f} > 7"
