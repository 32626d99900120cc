"""Cross-backend contracts: identical inputs must behave identically on the
vmap (XLA), fused-kernel (Pallas) and sharded backends — same accept/reject
of inputs, same error behavior, same stats shapes — and solve() picks the
kernels by the observed platform and input only.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
from tiger_tpu.models import DummyModel
from tiger_tpu.solver import SolverConfig, rk45_solve
from tiger_tpu.solver.api import solve

CFG = SolverConfig(rtol=1e-5, atol=1e-7, max_steps=20_000)


def _batch(s_count=16):
    rng = np.random.default_rng(7)
    y0 = jnp.asarray(rng.uniform(0.5, 2.0, (s_count, 5)), jnp.float32)
    h0 = jnp.full((s_count,), 0.05, jnp.float32)
    return y0, h0


# Duplicates at t0, mid-run, and a triple — sorted ascending.
QT_DUP = jnp.asarray(
    [0.0, 0.0, 1.0, 2.5, 2.5, 2.5, 4.0, 5.0], jnp.float32
)


def _dense_all(backend_name, y0, h0):
    if backend_name == "vmap":
        return rk45_solve(DummyModel(), y0, 0.0, 5.0, QT_DUP, h0=h0, config=CFG)
    return rk45_solve_pallas(
        DummyModel(), y0, 0.0, 5.0, QT_DUP, h0=h0, config=CFG, interpret=True
    )


@pytest.mark.parametrize("backend", ["vmap", "pallas"])
def test_duplicate_queries_accepted_everywhere(backend):
    y0, h0 = _batch()
    res = _dense_all(backend, y0, h0)
    dense = np.asarray(res.dense)
    qt = np.asarray(QT_DUP)
    # Duplicate rows are bit-identical to their first copy.
    for i in range(1, len(qt)):
        if qt[i] == qt[i - 1]:
            np.testing.assert_array_equal(dense[:, i], dense[:, i - 1])
    # All backends agree to integration tolerance.
    ref = np.asarray(
        rk45_solve(DummyModel(), y0, 0.0, 5.0, QT_DUP, h0=h0, config=CFG).dense
    )
    np.testing.assert_allclose(dense, ref, rtol=2e-5, atol=1e-6)


def test_duplicate_queries_accepted_on_sharded_backend():
    from tiger_tpu.dist import rk45_solve_sharded, systems_mesh

    y0, h0 = _batch()
    mesh = systems_mesh(jax.devices("cpu")[:4])
    res = rk45_solve_sharded(
        DummyModel(), y0, 0.0, 5.0, QT_DUP, h0=h0, config=CFG, mesh=mesh
    )
    qt = np.asarray(QT_DUP)
    dense = np.asarray(res.dense)
    assert dense.shape[1] == len(qt)
    for i in range(1, len(qt)):
        if qt[i] == qt[i - 1]:
            np.testing.assert_array_equal(dense[:, i], dense[:, i - 1])


@pytest.mark.parametrize("backend", ["vmap", "pallas"])
def test_unsorted_queries_rejected_everywhere(backend):
    y0, h0 = _batch(4)
    bad = jnp.asarray([1.0, 0.5, 2.0], jnp.float32)
    with pytest.raises(ValueError, match="sorted ascending"):
        if backend == "vmap":
            # api.solve front-ends the vmap path's validation.
            solve(DummyModel(), y0, 0.0, 5.0, bad, config=CFG, backend="xla")
        else:
            rk45_solve_pallas(
                DummyModel(), y0, 0.0, 5.0, bad, h0=h0, config=CFG, interpret=True
            )


def _mixed_batch():
    from tests.test_solve_device_rung import StiffMix

    s = 12
    lam = np.full(s, -0.1, np.float32)
    lam[[3, 7]] = -1e6  # two genuinely stiff lanes
    y0 = jnp.ones((s, 5), jnp.float32)
    params = {"lam": jnp.asarray(lam)}
    return StiffMix(), y0, params, SolverConfig(rtol=1e-5, atol=1e-8)


def test_radau_stats_full_batch_shaped(monkeypatch):
    """radau_stats is [S]-shaped with zeros on never-stiff lanes — consumers
    need no knowledge of bucket padding."""
    monkeypatch.setenv("TT_NO_SPECULATIVE_RUNG", "1")
    model, y0, params, cfg = _mixed_batch()
    res = solve(model, y0, 0.0, 50.0, None, params, config=cfg,
                backend="pallas", interpret=True)
    assert res.n_stiff == 2
    st = res.radau_stats
    s_count = y0.shape[0]
    stiff = np.asarray(res.stiff)
    for field in (st.n_accepted, st.n_rejected, st.n_attempts, st.n_newton):
        assert np.asarray(field).shape == (s_count,)
    assert (np.asarray(st.n_attempts)[~stiff] == 0).all()
    assert (np.asarray(st.n_attempts)[stiff] > 0).all()
    assert (np.asarray(st.n_newton)[stiff] > 0).all()


def test_radau_stats_full_batch_shaped_cpu_pipeline():
    """Same contract when the stiff pass runs the host f64 pipeline (no
    device rung): per-lane counters for the lanes Radau actually stepped."""
    model, y0, params, cfg = _mixed_batch()
    res = solve(model, y0, 0.0, 50.0, None, params, config=cfg, backend="xla")
    assert res.n_stiff == 2
    assert res.n_host == 2
    stiff = np.asarray(res.stiff)
    if res.radau_stats is None:
        pytest.skip("f64 RK retry resolved all flagged lanes before Radau")
    st = res.radau_stats
    assert np.asarray(st.n_attempts).shape == (y0.shape[0],)
    assert (np.asarray(st.n_attempts)[~stiff] == 0).all()


class _NoTuple:
    """A model with only the stacked rhs: the kernels cannot trace it."""

    N_EQ = 5
    UID = 0


@pytest.mark.parametrize(
    "backend,platform,dtype,model,interpret,want",
    [
        ("auto", "gpu", jnp.float32, DummyModel(), False, True),
        ("auto", "cpu", jnp.float32, DummyModel(), False, False),
        ("auto", "gpu", jnp.float64, DummyModel(), False, False),
        ("auto", "gpu", jnp.float32, _NoTuple(), False, False),
        ("xla", "gpu", jnp.float32, DummyModel(), False, False),
        ("pallas", "gpu", jnp.float32, DummyModel(), False, True),
        ("pallas", "cpu", jnp.float32, DummyModel(), True, True),
        ("auto", "cpu", jnp.float32, DummyModel(), True, False),
    ],
    ids=["auto-gpu", "auto-cpu", "auto-gpu-f64", "auto-gpu-no-rhs_tuple",
         "xla-gpu", "pallas-gpu", "pallas-cpu-interpret", "auto-cpu-interpret"],
)
def test_kernel_selection(backend, platform, dtype, model, interpret, want):
    from tiger_tpu.solver.api import select_kernels

    assert select_kernels(backend, platform, dtype, model, interpret) is want


@pytest.mark.parametrize("platform,dtype", [("cpu", jnp.float32), ("gpu", jnp.float64)])
def test_pallas_backend_refuses_what_the_kernels_cannot_run(platform, dtype):
    from tiger_tpu.solver.api import select_kernels

    with pytest.raises(ValueError, match=platform):
        select_kernels("pallas", platform, dtype, DummyModel(), False)


def test_solve_on_cpu_takes_the_vmap_path(monkeypatch):
    """On a CPU device 'auto' never enters the kernel modules, and an
    explicit 'pallas' without interpret raises naming the platform."""
    import tiger_tpu.kernels.rk45_pallas as kp

    def boom(*a, **k):
        raise AssertionError("kernel called on the CPU")

    monkeypatch.setattr(kp, "rk45_solve_pallas", boom)
    y0, _ = _batch(4)
    res = solve(DummyModel(), y0, 0.0, 5.0, QT_DUP, config=CFG)
    assert res.y_final.shape == (4, 5)
    with pytest.raises(ValueError, match="'cpu'"):
        solve(DummyModel(), y0, 0.0, 5.0, QT_DUP, config=CFG, backend="pallas")
