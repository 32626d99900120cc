"""Segmented dense output: integrate query-to-query instead of interpolating.

The vmap solvers' interpolated dense output costs ~10x the bare integration
(per-lane cursor scatters dominate); the fused kernels store rows per lane,
but the host stiff pass (f64 retry + Radau on the compacted subset,
tiger_tpu.solver.api) still needs dense rows.  This module produces them by
integrating each [q_k, q_{k+1}] segment with NO dense machinery and recording
the state at each query time — exact sampling (the solver lands exactly on
the query, no interpolation error), at the cost of restarting the step size
each segment.  Measured ~50x faster than the interpolated path for the stiff
subset.

One jitted segment function with TRACED time bounds (one compile for all
segments); the host loop carries the state forward.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tiger_tpu.forcing import ForcingSet, gather_forcings_column
from tiger_tpu.solver.config import SolverConfig
from tiger_tpu.solver.radau import _radau_system
from tiger_tpu.solver.rk45 import _rk45_system, vmap_system_solve


class SegmentedResult(NamedTuple):
    y_final: jax.Array  # [S, N]
    dense: jax.Array  # [S, Q, N]
    stiff: jax.Array  # [S] bool — flagged in ANY segment (rk45 only)
    failed: jax.Array  # [S] bool
    n_attempts: jax.Array  # [S] summed over segments


@functools.partial(
    jax.jit, static_argnames=("model", "method", "meta", "config")
)
def _segment(model, method, y0, h0, t0v, t1v, params, forc_data, meta, config,
             t_shift=0.0):
    """One segment [t0v, t1v] (traced bounds), no dense output."""

    sys_fn = _rk45_system if method == "rk45" else _radau_system
    return vmap_system_solve(
        model, sys_fn, y0, h0, params, forc_data, meta,
        t0v, t1v, None, config, t_shift,
    )


def segmented_solve(
    model,
    method: str,  # 'rk45' | 'radau'
    y0: jax.Array,
    t0: float,
    tf: float,
    query_times,
    params=None,
    forcings: Optional[ForcingSet] = None,
    h0=None,
    config: SolverConfig = SolverConfig(),
    t_shift=0.0,
) -> SegmentedResult:
    y0 = jnp.asarray(y0)
    s_count, n_eq = y0.shape
    dtype = y0.dtype
    if h0 is None:
        from tiger_tpu.solver.controller import initial_step

        h0 = initial_step(model, y0, t0, params, forcings, config)
    h0 = jnp.broadcast_to(jnp.asarray(h0, dtype), (s_count,))
    forc_data = None if forcings is None else forcings.data
    meta = None if forcings is None else forcings.meta

    qt = np.asarray(query_times, np.float64) if query_times is not None else np.zeros(0)
    q_total = len(qt)
    dense = np.zeros((s_count, q_total, n_eq), dtype)

    # Keep every array this host loop touches COMMITTED to y0's device: in
    # an accelerator process this path runs on the CPU backend, and any
    # uncommitted jnp creation would land on the accelerator, one stray
    # transfer per segment.  Segment bounds are passed as plain floats
    # (traced).
    dev = next(iter(y0.devices())) if hasattr(y0, "devices") else None
    put = lambda a: jax.device_put(a, dev)

    y = y0
    t_prev = float(t0)
    stiff_any = put(np.zeros((s_count,), bool))
    failed_any = put(np.zeros((s_count,), bool))
    n_att = put(np.zeros((s_count,), np.int32))

    def advance(y, t_a, t_b):
        nonlocal stiff_any, failed_any, n_att
        res = _segment(
            model, method, y, h0,
            float(t_a), float(t_b),
            params, forc_data, meta, config,
            jnp.asarray(t_shift, dtype),
        )
        if method == "rk45":
            stiff_any = stiff_any | res.stiff
        failed_any = failed_any | res.failed
        n_att = n_att + res.stats.n_attempts
        # Lanes that did not finish the segment keep their entry state
        # (they are stiff-flagged and re-done by the Radau pass anyway).
        return jnp.where(jnp.isnan(res.y_final), y, res.y_final)

    # Queries at/below t0 take the initial state (fill_t0_queries semantics).
    k = 0
    while k < q_total and qt[k] <= t0 + 0.0:
        if config.fill_t0_queries:
            dense[:, k] = np.asarray(y)
        k += 1
    for q in range(k, q_total):
        t_next = min(float(qt[q]), float(tf))
        if t_next > t_prev:
            y = advance(y, t_prev, t_next)
            t_prev = t_next
        dense[:, q] = np.asarray(y)
    if t_prev < float(tf):
        y = advance(y, t_prev, float(tf))

    # NaN-on-failure contract (matches RK45Result/RadauResult): failed lanes
    # must not report the plausible-looking state frozen at their last
    # successful query.
    y = jnp.where(failed_any[:, None], jnp.full_like(y, jnp.nan), y)
    return SegmentedResult(
        y_final=y,
        dense=put(dense),
        stiff=stiff_any,
        failed=failed_any,
        n_attempts=n_att,
    )
