"""The on-device Radau rung for small stiff counts (api.solve).

On kernel runs, ANY flagged lanes are re-integrated by the fused Radau
kernel padded to a 256-lane bucket; only kernel failures fall through to the
host float64 pipeline.  backend='pallas' with interpret=True exercises the
same branches here on CPU via the Pallas interpreter, pinning the
pad/merge/mask bookkeeping that a year-scale streamed run exercises on the
card (reference analog: the host-side stiff compaction in
rk45_api.hpp:190-247).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tiger_tpu.models import DummyModel
from tiger_tpu.solver import SolverConfig, solve


class StiffMix(DummyModel):
    """Dummy dynamics with per-lane linear-decay rate: lam << 0 lanes are
    stiff for RK45 and flag out; the rest integrate normally."""

    def rhs(self, t, y, params, forcings=None):
        return params["lam"][..., None] * y

    def rhs_tuple(self, t, y, params, forcings=None):
        return tuple(params["lam"] * yi for yi in y)


@pytest.fixture
def mix():
    s = 12
    lam = np.full(s, -0.1, np.float32)
    lam[[3, 7]] = -1e6  # two stiff lanes, like a streamed window's flags
    y0 = jnp.ones((s, 5), jnp.float32)
    params = {"lam": jnp.asarray(lam)}
    return y0, params, lam


def test_device_rung_resolves_small_stiff_subset(mix, monkeypatch):
    monkeypatch.setenv("TT_NO_SPECULATIVE_RUNG", "1")
    y0, params, lam = mix
    qt = jnp.asarray([25.0, 50.0])
    res = solve(StiffMix(), y0, 0.0, 50.0, qt, params=params,
                config=SolverConfig(rtol=1e-5, atol=1e-8),
                backend="pallas", interpret=True)
    assert res.n_stiff == 2
    assert res.n_host == 0
    assert not np.asarray(res.failed).any()
    expect_final = np.exp(lam.astype(np.float64) * 50.0)
    got = np.asarray(res.y_final)
    assert np.isfinite(got).all()
    # Stiff lanes: exact answer is ~e^-5e7 == 0; Radau must land there.
    np.testing.assert_allclose(got[[3, 7]], 0.0, atol=1e-6)
    # Non-stiff lanes unperturbed by the merge.
    np.testing.assert_allclose(
        got[lam > -1e5],
        np.broadcast_to(expect_final[lam > -1e5, None], (10, 5)),
        rtol=1e-4,
    )
    # Dense rows for the stiff lanes come from the rung's kernel too.
    dense = np.asarray(res.dense)
    np.testing.assert_allclose(dense[[3, 7], 0], 0.0, atol=1e-6)


def test_device_rung_failures_fall_through_to_cpu(mix, monkeypatch):
    """Lanes the kernel cannot finish are retried by the f64 host pipeline."""
    monkeypatch.setenv("TT_NO_SPECULATIVE_RUNG", "1")
    y0, params, lam = mix
    # A Radau bail-out is hard to force with linear decay; instead cap the
    # kernel's Newton budget so hard lanes reject until radau_max_rejects.
    cfg = SolverConfig(rtol=1e-5, atol=1e-8, newton_max_iter=1,
                       radau_max_rejects=1)
    res = solve(StiffMix(), y0, 0.0, 50.0, None, params=params, config=cfg,
                backend="pallas", interpret=True)
    # Whatever the kernel failed, the CPU pass must leave nothing failed
    # unless it also bailed; in either case the result is finite and sane.
    got = np.asarray(res.y_final)
    ok = ~np.asarray(res.failed)
    assert ok.any()
    assert np.isfinite(got[ok]).all()


def test_speculative_rung_matches_blocking_path(mix, monkeypatch):
    """The speculative rung dispatch (device-side compaction, round 5) must
    produce the same results as the blocking pull-then-dispatch path, fill
    sentinel lanes with NaN working sets that scatter nowhere, and report
    the same stiff bookkeeping.  Exercised on CPU via backend='pallas' in
    the interpreter."""
    y0, params, lam = mix
    qt = jnp.asarray([25.0, 50.0])
    cfg = SolverConfig(rtol=1e-5, atol=1e-8)

    monkeypatch.setenv("TT_NO_SPECULATIVE_RUNG", "1")
    base = solve(StiffMix(), y0, 0.0, 50.0, qt, params=params, config=cfg,
                 backend="pallas", interpret=True)

    monkeypatch.delenv("TT_NO_SPECULATIVE_RUNG")
    spec = solve(StiffMix(), y0, 0.0, 50.0, qt, params=params, config=cfg,
                 backend="pallas", interpret=True)

    assert spec.n_stiff == base.n_stiff == 2
    assert not np.asarray(spec.failed).any()
    np.testing.assert_array_equal(
        np.asarray(spec.y_final), np.asarray(base.y_final)
    )
    np.testing.assert_array_equal(np.asarray(spec.dense), np.asarray(base.dense))
    # Per-lane rung stats land on exactly the flagged lanes.
    att = np.asarray(spec.radau_stats.n_attempts)
    assert (att[[3, 7]] > 0).all() and att.sum() == att[[3, 7]].sum()


def test_speculative_rung_zero_stiff_is_clean(monkeypatch):
    """No flagged lanes: the wasted speculative kernel call must leave the
    outputs bit-identical to the RK pass and report n_stiff == 0."""
    s = 8
    y0 = jnp.ones((s, 5), jnp.float32)
    params = {"lam": jnp.full((s,), -0.1, jnp.float32)}
    qt = jnp.asarray([25.0, 50.0])
    res = solve(StiffMix(), y0, 0.0, 50.0, qt, params=params,
                config=SolverConfig(rtol=1e-5, atol=1e-8), backend="pallas",
                interpret=True)
    assert res.n_stiff == 0
    assert res.radau_stats is None
    assert not np.asarray(res.failed).any()
    expect = np.exp(-0.1 * 50.0)
    np.testing.assert_allclose(np.asarray(res.y_final), expect, rtol=1e-4)


def test_speculative_rung_overflow_beyond_bucket(monkeypatch):
    """More flagged lanes than the speculative bucket: the first ``bucket``
    are resolved by the speculative kernel, the overflow goes through the
    exact-size device rung, and every lane still lands on the Radau answer."""
    monkeypatch.setenv("TT_SPEC_BUCKET", "4")
    s = 12
    lam = np.full(s, -0.1, np.float32)
    stiff_rows = [1, 3, 5, 7, 9, 11]  # 6 > bucket of 4
    lam[stiff_rows] = -1e6
    y0 = jnp.ones((s, 5), jnp.float32)
    params = {"lam": jnp.asarray(lam)}
    res = solve(StiffMix(), y0, 0.0, 50.0, jnp.asarray([25.0, 50.0]),
                params=params, config=SolverConfig(rtol=1e-5, atol=1e-8),
                backend="pallas", interpret=True)
    assert res.n_stiff == 6
    assert res.n_host == 0
    assert not np.asarray(res.failed).any()
    got = np.asarray(res.y_final)
    np.testing.assert_allclose(got[stiff_rows], 0.0, atol=1e-6)
    np.testing.assert_allclose(
        got[lam > -1e5], np.exp(-0.1 * 50.0), rtol=1e-4
    )
    att = np.asarray(res.radau_stats.n_attempts)
    assert (att[stiff_rows] > 0).all(), "overflow lanes missing rung stats"
    assert att.sum() == att[stiff_rows].sum()
