"""Coverage for controller parity modes, metrics, and BASELINE config #2."""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from tests.test_model204 import NB_PARAMS
from tiger_tpu.forcing import ForcingSet
from tiger_tpu.models import DummyModel, Model204, Y0_COMMON
from tiger_tpu.profiling import Metrics
from tiger_tpu.solver import SolverConfig, initial_step, solve


def test_h0_global_zero_parity_mode():
    # Reference: one h0 for every system, computed from a ZERO state
    # (main.cpp:615-641).  For Model 204 d0 == 0 so h0 is the 1e-6 floor —
    # the value behind every committed 204 artifact.
    params = {k: jnp.full((3,), v) for k, v in NB_PARAMS.items()}
    y0 = jnp.tile(jnp.asarray(Y0_COMMON), (3, 1))
    cfg = SolverConfig(h0_mode="global-zero-y0")
    h0 = initial_step(Model204(), y0, 0.0, params, None, cfg)
    np.testing.assert_allclose(np.asarray(h0), 1e-6)

    # Per-system mode uses the actual y0 and is larger here.
    h0_ps = initial_step(Model204(), y0, 0.0, params, None, SolverConfig())
    assert float(h0_ps[0]) > 1e-6

    # Explicit initial_step wins over both.
    h0_fix = initial_step(Model204(), y0, 0.0, params, None, SolverConfig(initial_step=0.25))
    np.testing.assert_allclose(np.asarray(h0_fix), 0.25)


def test_dummy_model_h0_matches_reference_formula():
    # d0/d1 with plain 2-norm (NOT SciPy's RMS): scale = atol + rtol*|y0|.
    y0 = jnp.ones((1, 5), jnp.float64)
    h0 = float(initial_step(DummyModel(), y0, 0.0, None, None, SolverConfig())[0])
    scale = 1e-9 + 1e-6 * 1.0
    d0 = np.sqrt(5) / scale
    f0 = np.array([0.5, 0.4, 0.1, -0.1, 0.3])
    d1 = np.linalg.norm(f0 / scale)
    np.testing.assert_allclose(h0, max(1e-6, 0.01 * d0 / (d1 + 1e-16)), rtol=1e-12)


def test_dummy_driven_through_forcing_pipeline():
    # BASELINE config #2: DummyModel with NetCDF-style forcings attached.
    # The dummy physics ignores them; the plumbing (packed set, per-lane
    # columns, ZOH gather inside the solver loop) must run regardless and
    # reproduce the unforced trajectory exactly.
    rng = np.random.default_rng(12)
    n_sys = 4
    pr = rng.uniform(0, 1, (48, n_sys)).astype(np.float32)
    t2m = rng.uniform(-5, 5, (2, n_sys)).astype(np.float32)
    forc = ForcingSet.from_series([pr, t2m], [60.0, 1440.0])
    y0 = jnp.ones((n_sys, 5), jnp.float64)
    forced = solve(DummyModel(), y0, 0.0, 5.0, forcings=forc)
    unforced = solve(DummyModel(), y0, 0.0, 5.0)
    np.testing.assert_array_equal(np.asarray(forced.y_final), np.asarray(unforced.y_final))


def test_metrics_counters():
    import json

    m = Metrics()
    with m.phase("solve"):
        res = solve(DummyModel(), jnp.ones((2, 5), jnp.float64), 0.0, 5.0)
    m.record_solve(res, m.phases["solve"])
    s = m.summary()
    assert s["num_systems"] == 2
    assert s["rk_attempted_steps"] >= s["rk_accepted_steps"] > 0
    assert s["system_steps_per_s"] > 0
    assert s["n_stiff"] == 0
    json.loads(m.dump())  # serializable


def test_reference_parity_preset():
    cfg = SolverConfig.reference_parity()
    assert cfg.h0_mode == "global-zero-y0"
    assert cfg.fill_t0_queries is False
    assert cfg.nan_shrink == 1.0
    assert cfg.max_rejects == 5
    assert cfg.radau_error_mode == "reference"
    # Overrides compose.
    cfg2 = SolverConfig.reference_parity(rtol=1e-4)
    assert cfg2.rtol == 1e-4 and cfg2.max_rejects == 5
    # Parity h0 for Model 204 is the 1e-6 floor (every committed artifact).
    params = {k: jnp.full((2,), v) for k, v in NB_PARAMS.items()}
    y0 = jnp.tile(jnp.asarray(Y0_COMMON), (2, 1))
    h0 = initial_step(Model204(), y0, 0.0, params, None, cfg)
    np.testing.assert_allclose(np.asarray(h0), 1e-6)


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache(tmp_path, monkeypatch, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache goes to the fixed, git-ignored .jax_cache of the checkout."""
    import pathlib

    import jax

    from tiger_tpu.profiling import enable_compile_cache

    repo = pathlib.Path(__file__).resolve().parent.parent
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        if env_set:
            d = str(tmp_path / "xla_cache")
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
            assert enable_compile_cache() == d
            assert jax.config.jax_compilation_cache_dir == saved[0]
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = str(repo / ".jax_cache")
            assert enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
            assert ".jax_cache/" in (repo / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_gpu_scripts_refuse_a_cpu_only_process(script):
    """The measurement scripts fail, printing no result, when JAX finds no
    GPU (bench.py runs on the CPU only when asked with --cpu)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, script], capture_output=True, text=True, timeout=120,
        cwd=repo, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"value"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory, chip_smoke.py cannot import the program and
    must exit non-zero without a result line."""
    import shutil
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copy(os.path.join(repo, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=120, cwd=tmp_path, env={**env, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_calibration_example_runs(tmp_path):
    """The ensemble-calibration example must run end to end and improve the
    hydrograph objective over the prior."""
    import re
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "examples/calibration.py", "--links", "8",
         "--members", "8"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    m = re.search(r"RMSE ([0-9.e-]+) -> ([0-9.e-]+)", proc.stdout)
    assert m, proc.stdout
    assert float(m.group(2)) <= float(m.group(1))
