"""Card-only checks: the fused kernels compiled for the GPU (no interpreter)
against the vmap reference, and solve()'s kernel dispatch on a GPU device.

Marked ``gpu``; the gpu_device fixture skips them where JAX finds no GPU.
Run on the card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
(chip_smoke.py does).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from __graft_entry__ import _scenario
from tiger_tpu.models import Model200, Model204
from tiger_tpu.solver import SolverConfig, radau_solve, rk45_solve, solve

pytestmark = pytest.mark.gpu

CFG = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
QT = np.arange(0.0, 1441.0, 60.0, dtype=np.float32)


def _on(dev, s_count, stiff_frac=0.0):
    """Scenario on the card; forcing held at each record's first sample, as
    in tests/test_pallas_kernel.py (chip_smoke.steady says why)."""
    from chip_smoke import steady

    y0, params, forc = _scenario(s_count, jnp.float32, days=1.0, stiff_frac=stiff_frac)
    put = lambda a: jax.device_put(a, dev)
    return put(y0), {k: put(v) for k, v in params.items()}, steady(forc), put(QT)


@pytest.mark.parametrize("model", [Model204(), Model200()], ids=["m204", "m200"])
def test_rk45_kernel_on_gpu_matches_vmap(gpu_device, model):
    from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas

    y0, params, forc, qt = _on(gpu_device, 4096)
    h0 = jnp.full((4096,), 1e-3, jnp.float32)
    ker = rk45_solve_pallas(model, y0, 0.0, 1440.0, qt, params, forc, h0=h0, config=CFG)
    ref = rk45_solve(model, y0, 0.0, 1440.0, qt, params, forc, h0=h0, config=CFG)
    ok = ~(np.asarray(ker.stiff) | np.asarray(ref.stiff))
    # chip_smoke's bound, flags differ on <= 0.01% of lanes: none of 4096.
    assert (np.asarray(ker.stiff) != np.asarray(ref.stiff)).sum() == 0
    np.testing.assert_allclose(np.asarray(ker.y_final)[ok], np.asarray(ref.y_final)[ok],
                               rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ker.dense)[ok], np.asarray(ref.dense)[ok],
                               rtol=5e-3, atol=1e-5)


def test_radau_kernel_on_gpu_matches_vmap(gpu_device):
    from tiger_tpu.kernels.radau_pallas import radau_solve_pallas

    y0, params, forc, qt = _on(gpu_device, 64, stiff_frac=1.0)
    h0 = jnp.full((64,), 1e-3, jnp.float32)
    ker = radau_solve_pallas(Model204(), y0, 0.0, 1440.0, qt, params, forc, h0=h0, config=CFG)
    ref = radau_solve(Model204(), y0, 0.0, 1440.0, qt, params, forc, h0=h0, config=CFG)
    assert not np.asarray(ker.failed).any()
    np.testing.assert_allclose(np.asarray(ker.y_final), np.asarray(ref.y_final),
                               rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ker.dense), np.asarray(ref.dense),
                               rtol=5e-3, atol=1e-5)


def test_solve_keeps_the_stiff_phase_on_the_card(gpu_device):
    y0, params, forc = _scenario(8192, jnp.float32, days=1.0, stiff_frac=0.01)
    qt = jnp.asarray(QT)
    res = solve(Model204(), y0, 0.0, 1440.0, qt, params, forc, config=CFG)
    assert res.n_stiff > 0
    assert res.n_host == 0
    assert not np.asarray(res.failed).any()
    assert np.isfinite(np.asarray(res.y_final)).all()
