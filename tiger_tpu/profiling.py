"""Profiling / metrics: phase timers, systems*steps/s counters, jax.profiler.

The reference has no in-code metrics beyond one chrono timer around the dense
NetCDF write (src/main.cpp:809-823); external nsys/ncu invocations are its
whole profiling story (README.md:122, job.slurm:19-21).  Here: lightweight
phase timers, the north-star throughput counter (hillslope-systems x
RK-steps/s, from the solver's per-system attempt stats), and optional
jax.profiler trace capture.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class Metrics:
    phases: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def record_solve(self, result, wall_s: float) -> None:
        """Derive throughput counters from a SolveResult/RK45Result."""
        stats = getattr(result, "rk_stats", None) or getattr(result, "stats", None)
        n_att = int(np.sum(np.asarray(stats.n_attempts)))
        n_acc = int(np.sum(np.asarray(stats.n_accepted)))
        s_count = int(np.asarray(stats.n_attempts).shape[0])
        self.counters.update(
            {
                "num_systems": s_count,
                "rk_attempted_steps": n_att,
                "rk_accepted_steps": n_acc,
                "solve_wall_s": wall_s,
                # North-star metric (BASELINE.json): system-steps per second.
                "system_steps_per_s": (n_att / wall_s) if wall_s > 0 else 0.0,
            }
        )
        rd = getattr(result, "radau_stats", None)
        if rd is not None:
            self.counters["radau_attempted_steps"] = int(np.sum(np.asarray(rd.n_attempts)))
        n_stiff = getattr(result, "n_stiff", None)
        if n_stiff is not None:
            self.counters["n_stiff"] = int(n_stiff)

    def summary(self) -> dict:
        return {"phases_s": dict(self.phases), **self.counters}

    def dump(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)


def solver_phase_times() -> dict:
    """Per-phase wall seconds recorded by the solver when TT_PHASE_PROFILE=1
    (see tiger_tpu.solver.api._phase_mark) — the public accessor, so
    benchmarks don't reach into the solver's private module state."""
    from tiger_tpu.solver import api as _api

    return dict(_api._phase_times)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    The adaptive while-loop solvers and the fused kernels take seconds to
    minutes to compile; with the cache a fresh process re-running the same
    shapes loads the serialized executable instead (the reference pays the
    analogous nvcc cost once at build time).  Where ``JAX_COMPILATION_CACHE_DIR``
    is set, JAX already uses it and nothing is changed here; otherwise the
    cache lives in ``.jax_cache`` at the root of the checkout, a fixed path
    (the path is part of the cache key) that git ignores.
    """
    import os

    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    cache_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
    )
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache everything that took a noticeable compile: the default 1 s
    # threshold already skips trivial kernels.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """jax.profiler trace context (no-op when log_dir is falsy)."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
