"""Fused RK45 kernel (Triton route) vs the vmap reference path, in the Pallas
interpreter; plus the wrapper's padding and dense layout, and the kernels'
lowering for the GPU.

The kernel and the vmap path run the same float32 arithmetic in the same
order, so in the interpreter they agree bit for bit
(test_kernel_runs_the_vmap_arithmetic); on the GPU, FMA contraction and the
math library's last bits let a lane whose error estimate sits on the accept
boundary diverge by a step, which is why the other tests compare step counts
within a band and states to f32 tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tiger_tpu.forcing import ForcingSet
from tiger_tpu.kernels.rk45_pallas import BLOCK, rk45_solve_pallas
from tiger_tpu.models import DummyModel, Model200, Model204
from tiger_tpu.solver import SolverConfig, rk45_solve

CFG = SolverConfig(rtol=1e-5, atol=1e-7, max_steps=20_000)


def _assert_steps_close(a, b, rel=0.25, mask=None):
    # Step-count agreement: one boundary-rounding flip cascades through the
    # controller (and 204's min/max kinks amplify it), so compare counts
    # within a relative band, not exactly.  ``mask`` excludes lanes that sit
    # on a physical kink (e.g. melt threshold) where the two paths may even
    # disagree on the stiffness flag.
    a = np.asarray(a).astype(np.int64)
    b = np.asarray(b).astype(np.int64)
    if mask is not None:
        a, b = a[mask], b[mask]
    bad = np.abs(a - b) > np.maximum(5, rel * b)
    assert not bad.any(), (a[bad], b[bad])


def _dummy_batch(s_count):
    rng = np.random.default_rng(0)
    return jnp.asarray(rng.uniform(0.5, 2.0, (s_count, 5)), jnp.float32)


def test_dummy_matches_vmap_path():
    y0 = _dummy_batch(96)
    qt = jnp.linspace(0.5, 5.0, 10, dtype=jnp.float32)
    h0 = jnp.full((96,), 0.05, jnp.float32)
    ref = rk45_solve(DummyModel(), y0, 0.0, 5.0, qt, h0=h0, config=CFG)
    ker = rk45_solve_pallas(
        DummyModel(), y0, 0.0, 5.0, qt, h0=h0, config=CFG, interpret=True
    )
    _assert_steps_close(ker.stats.n_attempts, ref.stats.n_attempts)
    np.testing.assert_allclose(
        np.asarray(ker.y_final), np.asarray(ref.y_final), rtol=2e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(ker.dense), np.asarray(ref.dense), rtol=2e-5, atol=1e-6
    )
    assert not bool(np.asarray(ker.stiff).any())


@pytest.mark.parametrize("forcing", ["steady", "varying"])
@pytest.mark.parametrize("model", [Model204(), Model200()], ids=["m204", "m200"])
def test_kernel_runs_the_vmap_arithmetic(model, forcing):
    """Same stage sums, error norm, stiffness tests, compensated time commit
    and dense interpolant, in the same order: flags, step counts, states and
    dense rows agree bit for bit in the interpreter, Model 204's genuinely
    stiff lanes and hourly-varying forcing included.  Model 200 runs on
    ordinary lanes: on near-zero-capacity lanes its Hamon terms amplify the
    last bits of transcendentals that the two programs fuse differently."""
    from __graft_entry__ import _scenario
    from chip_smoke import steady

    s_count = 256
    stiff_frac = 0.01 if isinstance(model, Model204) else 0.0
    y0, params, forc = _scenario(s_count, jnp.float32, days=1.0, stiff_frac=stiff_frac)
    if forcing == "steady":
        forc = steady(forc)
    qt = jnp.arange(0.0, 1441.0, 60.0, dtype=jnp.float32)
    h0 = jnp.full((s_count,), 1e-3, jnp.float32)
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=20_000)
    ref = rk45_solve(model, y0, 0.0, 1440.0, qt, params, forc, h0=h0, config=cfg)
    ker = rk45_solve_pallas(
        model, y0, 0.0, 1440.0, qt, params, forc, h0=h0, config=cfg, interpret=True
    )
    assert np.asarray(ref.stiff).sum() >= (2 if stiff_frac else 0)
    for a, b in ((ker.stiff, ref.stiff), (ker.failed, ref.failed),
                 (ker.stats.n_attempts, ref.stats.n_attempts),
                 (ker.stats.n_accepted, ref.stats.n_accepted),
                 (ker.y_final, ref.y_final), (ker.dense, ref.dense)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_model204_with_forcings_matches_vmap_path():
    from tests.test_model204 import NB_PARAMS

    s_count = 64
    rng = np.random.default_rng(3)
    params = {
        k: jnp.asarray(np.full(s_count, v) * rng.uniform(0.9, 1.1, s_count), jnp.float32)
        for k, v in NB_PARAMS.items()
    }
    # Time-CONSTANT forcings (varying across systems): divergent-but-valid
    # step sequences then see identical forcing values, so the two paths
    # agree to integration accuracy.  (Time-varying forcing adds an O(h)
    # ZOH sampling difference whenever step sequences differ — covered by
    # test_time_varying_forcing_smoke.)
    pr = np.tile(rng.uniform(0, 0.0015, (1, s_count)), (24, 1)).astype(np.float32)
    t2m = rng.uniform(-2, 10, (1, s_count)).astype(np.float32)
    forc = ForcingSet.from_series([pr, t2m], [60.0, 1440.0])
    y0 = jnp.tile(jnp.asarray([0.01, 3.0, 0.0, 5.0, 0.2], jnp.float32), (s_count, 1))
    qt = jnp.arange(0.0, 1441.0, 120.0, dtype=jnp.float32)
    h0 = jnp.full((s_count,), 1e-3, jnp.float32)

    ref = rk45_solve(
        Model204(), y0, 0.0, 1440.0, qt, params, forc, h0=h0, config=CFG
    )
    ker = rk45_solve_pallas(
        Model204(), y0, 0.0, 1440.0, qt, params, forc, h0=h0, config=CFG, interpret=True
    )
    mask = ~(np.asarray(ref.stiff) | np.asarray(ker.stiff))
    # At most a couple of melt-threshold lanes may disagree on stiffness.
    assert (np.asarray(ref.stiff) != np.asarray(ker.stiff)).sum() <= 2
    # Lanes with temperature at the melt threshold integrate across a
    # discontinuity every step; their step counts are chaotic (though both
    # trajectories remain tolerance-valid) — exclude them from step parity.
    off_kink = np.abs(t2m[0]) > 0.5
    _assert_steps_close(ker.stats.n_attempts, ref.stats.n_attempts, mask=mask & off_kink)
    # Different (both tolerance-valid) step sequences accumulate global error
    # well above the local rtol through 204's min/max kinks.
    np.testing.assert_allclose(
        np.asarray(ker.y_final)[mask], np.asarray(ref.y_final)[mask], rtol=5e-3, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(ker.dense)[mask], np.asarray(ref.dense)[mask], rtol=5e-3, atol=1e-5
    )


def test_time_varying_forcing_smoke():
    # With hourly-varying rain the two paths' step sequences sample the ZOH
    # forcing differently; assert only physical-level agreement.
    from tests.test_model204 import NB_PARAMS

    s_count = 32
    rng = np.random.default_rng(4)
    params = {k: jnp.full((s_count,), v, jnp.float32) for k, v in NB_PARAMS.items()}
    pr = rng.uniform(0, 0.0015, (24, s_count)).astype(np.float32)
    t2m = np.full((1, s_count), 8.0, np.float32)
    forc = ForcingSet.from_series([pr, t2m], [60.0, 1440.0])
    y0 = jnp.tile(jnp.asarray([0.01, 3.0, 0.0, 5.0, 0.2], jnp.float32), (s_count, 1))
    h0 = jnp.full((s_count,), 1e-3, jnp.float32)
    ref = rk45_solve(Model204(), y0, 0.0, 1440.0, None, params, forc, h0=h0, config=CFG)
    ker = rk45_solve_pallas(
        Model204(), y0, 0.0, 1440.0, None, params, forc, h0=h0, config=CFG, interpret=True
    )
    mask = ~(np.asarray(ref.stiff) | np.asarray(ker.stiff))
    np.testing.assert_allclose(
        np.asarray(ker.y_final)[mask], np.asarray(ref.y_final)[mask], rtol=0.08, atol=1e-5
    )


def test_no_queries_path():
    y0 = _dummy_batch(32)
    ker = rk45_solve_pallas(DummyModel(), y0, 0.0, 5.0, None, config=CFG, interpret=True)
    ref = rk45_solve(DummyModel(), y0, 0.0, 5.0, None, config=CFG)
    np.testing.assert_allclose(
        np.asarray(ker.y_final), np.asarray(ref.y_final), rtol=2e-5, atol=1e-7
    )
    assert ker.dense.shape == (32, 0, 5)


def test_non_default_state_dimension():
    # Kernel is generic over N_EQ (tuple-of-2D state); 2-equation model.
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Osc2:
        N_EQ: int = 2
        UID: int = 96

        def rhs_tuple(self, t, y, p, f=None):
            return (y[1], -y[0] - 0.1 * y[1])

        def rhs(self, t, y, p, f=None):
            return jnp.stack(self.rhs_tuple(t, y, p, f))

    y0 = jnp.tile(jnp.asarray([1.0, 0.0], jnp.float32), (40, 1))
    h0 = jnp.full((40,), 0.01, jnp.float32)
    qt = jnp.asarray([5.0, 10.0], jnp.float32)
    ker = rk45_solve_pallas(Osc2(), y0, 0.0, 10.0, qt, h0=h0, config=CFG, interpret=True)
    ref = rk45_solve(Osc2(), y0, 0.0, 10.0, qt, h0=h0, config=CFG)
    np.testing.assert_allclose(
        np.asarray(ker.y_final), np.asarray(ref.y_final), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(ker.dense), np.asarray(ref.dense), rtol=1e-4, atol=1e-6
    )


def test_failed_vs_stiff_semantics_match_vmap():
    # Contract (solver/rk45.py:259-261): max_steps-capped lanes report
    # failed=True AND stiff=True; criteria-stiff lanes report failed=False.
    # Round 1 folded kernel failures into stiff (failed always False).
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Decay2:
        N_EQ: int = 2
        UID: int = 97

        def rhs_tuple(self, t, y, p, f=None):
            return (p["lam"] * (y[0] - 1.0), -0.5 * y[1])

        def rhs(self, t, y, p, f=None):
            return jnp.stack(self.rhs_tuple(t, y, p, f))

    # Case 1: smooth lanes that cannot finish within max_steps -> failed.
    cfg_cap = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=5, max_scale=1.0)
    y0 = jnp.full((8, 2), 2.0, jnp.float32)
    params = {"lam": jnp.full((8,), -0.2, jnp.float32)}
    h0 = jnp.full((8,), 1e-3, jnp.float32)
    ref = rk45_solve(Decay2(), y0, 0.0, 50.0, None, params, h0=h0, config=cfg_cap)
    ker = rk45_solve_pallas(
        Decay2(), y0, 0.0, 50.0, None, params, h0=h0, config=cfg_cap, interpret=True
    )
    for r in (ref, ker):
        assert np.asarray(r.failed).all(), "max_steps cap must set failed"
        assert np.asarray(r.stiff).all(), "failed lanes also feed the Radau pass"

    # Case 2: genuinely stiff lanes (reject streak) -> stiff but NOT failed.
    cfg = SolverConfig(rtol=1e-6, atol=1e-9, max_steps=20_000)
    params_stiff = {"lam": jnp.asarray([-1e6, -0.2, -1e6, -0.3], jnp.float32)}
    y0s = jnp.full((4, 2), 2.0, jnp.float32)
    h0s = jnp.full((4,), 1e-3, jnp.float32)
    refs = rk45_solve(Decay2(), y0s, 0.0, 50.0, None, params_stiff, h0=h0s, config=cfg)
    kers = rk45_solve_pallas(
        Decay2(), y0s, 0.0, 50.0, None, params_stiff, h0=h0s, config=cfg, interpret=True
    )
    for r in (refs, kers):
        np.testing.assert_array_equal(np.asarray(r.stiff), [True, False, True, False])
        assert not np.asarray(r.failed).any(), "criteria-stiff lanes are not failures"


@pytest.mark.parametrize("s_count", [3, 2 * BLOCK + 5], ids=["below-one-block", "ragged"])
def test_padding_to_whole_blocks(s_count):
    # Lanes are padded to a whole number of blocks (replicating row 0) and
    # sliced off again: every real lane matches the vmap path, whatever S.
    y0 = _dummy_batch(s_count)
    qt = jnp.asarray([1.0, 2.5, 5.0], jnp.float32)
    h0 = jnp.full((s_count,), 0.05, jnp.float32)
    ker = rk45_solve_pallas(DummyModel(), y0, 0.0, 5.0, qt, h0=h0, config=CFG,
                            interpret=True)
    ref = rk45_solve(DummyModel(), y0, 0.0, 5.0, qt, h0=h0, config=CFG)
    assert ker.y_final.shape == (s_count, 5)
    assert ker.dense.shape == (s_count, 3, 5)
    for field in ("stiff", "failed"):
        assert getattr(ker, field).shape == (s_count,)
    assert ker.stats.n_attempts.shape == (s_count,)
    np.testing.assert_allclose(np.asarray(ker.y_final), np.asarray(ref.y_final),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ker.dense), np.asarray(ref.dense),
                               rtol=2e-5, atol=1e-6)


def test_dense_layout_with_many_queries_per_step():
    # A fine query grid under long steps: each accepted step stores several
    # rows per lane (the cursor loop), and the [Q*N, S] kernel buffer must
    # land in the API's [S, Q, N] order — checked against the vmap path and
    # against lanes that start from different states.
    y0 = _dummy_batch(40)
    qt = jnp.linspace(0.01, 5.0, 300, dtype=jnp.float32)
    h0 = jnp.full((40,), 0.05, jnp.float32)
    ker = rk45_solve_pallas(DummyModel(), y0, 0.0, 5.0, qt, h0=h0, config=CFG,
                            interpret=True)
    ref = rk45_solve(DummyModel(), y0, 0.0, 5.0, qt, h0=h0, config=CFG)
    assert int(np.asarray(ker.stats.n_accepted).max()) < 300 // 4
    assert ker.dense.shape == (40, 300, 5)
    np.testing.assert_allclose(np.asarray(ker.dense), np.asarray(ref.dense),
                               rtol=2e-5, atol=1e-6)
    # Row q of lane s is lane s's state at qt[q]: lanes differ, times differ.
    d = np.asarray(ker.dense)
    assert not np.allclose(d[0], d[1]) and not np.allclose(d[:, 0], d[:, -1])
    np.testing.assert_allclose(d[:, -1], np.asarray(ker.y_final), rtol=1e-6)


@pytest.mark.parametrize("kernel", ["rk45", "radau"])
@pytest.mark.parametrize("model", ["m204", "m200"])
def test_kernels_lower_for_the_gpu(kernel, model):
    # Lowering to Triton IR for CUDA runs on any host: it catches primitives
    # the Triton route cannot express before the card ever sees the kernel.
    import dataclasses

    from __graft_entry__ import _scenario
    from tiger_tpu.kernels import radau_pallas, rk45_pallas
    from tiger_tpu.models import Model200

    m = Model204() if model == "m204" else Model200()
    y0, params, forc = _scenario(2 * BLOCK, jnp.float32, days=1.0)
    qt = jnp.arange(0.0, 1441.0, 60.0, dtype=jnp.float32)
    h0 = jnp.full((2 * BLOCK,), 1e-3, jnp.float32)
    cfg = dataclasses.replace(CFG, controller="pi", compensated=kernel == "rk45",
                              radau_error_mode="radau5", radau_factor_reuse=True,
                              radau_predictor=True)
    pipe = rk45_pallas.rk45_pipeline if kernel == "rk45" else radau_pallas._pipeline
    lowered = pipe.trace(
        m, y0, h0, params, forc.data, qt, 0.0, 1440.0, forc.meta, cfg,
        tuple(sorted(params)), False, jnp.float32(0.0),
    ).lower(lowering_platforms=("cuda",))
    assert "__gpu$xla.gpu.triton" in lowered.as_text()
