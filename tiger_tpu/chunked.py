"""Time-chunked solving: stream long forcing records through bounded memory.

The reference loads a fixed 2-day forcing window (main.cpp:525) and provides
``loadTimeChunk(start, n)`` precisely for windowed streaming it never wires up
(SURVEY.md section 5, "long-context analog").  A year of hourly forcing for
1M systems is ~35 GB — it cannot sit in HBM next to the solver state, so:

  - the simulation span [t0, tf] is split into windows of ``chunk_days``;
  - each window's forcing block is read from NetCDF (or sliced from a
    preloaded array), remapped, and shipped to the device while the previous
    window integrates (the host read/remap naturally overlaps device compute
    because JAX dispatch is asynchronous);
  - the solver runs each window as a hot start from the previous window's
    final state; window boundaries land exactly on query times so dense
    output is seamless.

Semantics note: forcing gathers inside window k index time RELATIVE to the
window start, which matches the absolute zero-order-hold series exactly when
``chunk_days*1440`` is a multiple of every forcing dt (enforced), because ZOH
sample boundaries then align with window boundaries.  Step sequences differ
slightly from an unchunked run (integration restarts at window edges), which
is within controller tolerance — the reference's 2-day-at-a-time operation
has the same property.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tiger_tpu.forcing import ForcingSet
from tiger_tpu.solver.api import SolveResult, _phase_mark, solve
from tiger_tpu.solver.config import SolverConfig


@jax.jit
def _carry_update_jit(y_prev, y_final, stiff_any, stiff, failed_any, failed,
                      rk_stats, new_stats):
    """Per-window carry bookkeeping fused into one device program."""
    y = jnp.where(jnp.isnan(y_final), y_prev, y_final)
    return (
        y,
        stiff_any | stiff,
        failed_any | failed,
        jax.tree.map(lambda a, b: a + b, rk_stats, new_stats),
    )


def solve_chunked(
    model,
    y0: jax.Array,
    t0: float,
    tf: float,
    chunk_minutes: float,
    load_window: Callable[[float, float], Optional[ForcingSet]],
    query_interval: Optional[float] = None,
    params=None,
    config: SolverConfig = SolverConfig(),
    mesh=None,
    backend: str = "auto",
    topology=None,
    routed_fn=None,
    dense_sink=None,
    state_sink=None,
):
    """Integrate [t0, tf] in windows of ``chunk_minutes``.

    ``load_window(w_start, w_end)`` returns the ForcingSet covering that
    absolute window (its block index 0 must correspond to time ``w_start``),
    or None for unforced runs.  ``query_interval`` (minutes) produces dense
    output exactly like an unchunked run with queries every interval.

    With ``topology`` (a routing.Topology), the downstream-routing exchange
    for window k is dispatched right after its solve and left UNBLOCKED —
    JAX's async dispatch overlaps it with the host-side forcing load and the
    solve of window k+1 (the BASELINE north-star "routing exchange overlapped
    with step compute").  Returns (SolveResult, routed [S, Q]) in that case,
    else just the SolveResult.

    ``routed_fn(dense_w) -> [S_local, Q_w]`` replaces the local-topology
    routing when given (multi-process runs: run.py wires a per-window
    cross-rank allgather + full-topology accumulation here, since downstream
    links cross rank boundaries).  It may block on a collective — every rank
    reaches the call once per window, in window order.

    ``dense_sink(q0, qt_abs, dense_w, routed_w)`` — when given, each window's
    dense block (and routed block, if topology is set) is handed off instead
    of accumulated on device, so the full [S, Q_total, N] output never
    exists in HBM (year-scale runs; pair with io.output.WindowedVarWriter).
    ``q0`` is the window's starting index on the global query grid, ``qt_abs``
    its absolute query times; ``routed_w`` is None without topology.  The
    returned result then has empty ``dense`` (and routed) arrays.

    ``state_sink(t_abs, y)`` — called after each window with the absolute end
    time and the carried state [S, N]; runs on the output worker thread AFTER
    that window's ``dense_sink`` completes, so a checkpoint written inside it
    never claims a time whose dense output is still in flight.
    """
    if chunk_minutes <= 0:
        raise ValueError("chunk_minutes must be positive")
    n_windows = max(1, math.ceil((tf - t0) / chunk_minutes - 1e-9))

    y = jnp.asarray(y0)
    s_count, n_eq = y.shape
    all_dense = []
    all_routed = []
    stiff_any = jnp.zeros((s_count,), bool)
    failed_any = jnp.zeros((s_count,), bool)
    n_stiff_total = n_host_total = 0
    rk_stats = None

    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    def _bounds(w):
        w_start = t0 + w * chunk_minutes
        return w_start, min(tf, w_start + chunk_minutes)

    # Window k+1's forcing (NetCDF slab read + remap + device upload) loads
    # on a worker thread while window k integrates: the solve blocks the main
    # thread on the stiff-count sync, so a serial load adds its full cost per
    # window.
    # Symmetrically, window k's dense/routed device->host pull + NetCDF write
    # (dense_sink) runs on its own worker thread: issued from the main thread
    # it lands exactly in the gap where the device is idle between windows.
    # One worker each keeps both pipelines FIFO-ordered.
    executor = ThreadPoolExecutor(max_workers=1)
    sink_executor = ThreadPoolExecutor(max_workers=1)
    sink_futs: list = []

    def _submit_sink(fn, *args):
        # FIFO on the single worker preserves write order; completed futures
        # are drained non-blockingly so an output error surfaces within a
        # window or two instead of only at the end barrier.  The queue is
        # BOUNDED (a few windows in flight): each queued window pins its
        # device dense/routed blocks in HBM (~56 MB/window at 1M systems),
        # so a stalled writer must throttle the solve, not OOM the device.
        while sink_futs and sink_futs[0].done():
            sink_futs.pop(0).result()
        while len(sink_futs) >= 4:
            sink_futs.pop(0).result()
        sink_futs.append(sink_executor.submit(fn, *args))

    try:
        fut = executor.submit(load_window, *_bounds(0))
        for w in range(n_windows):
            w_start, w_end = _bounds(w)
            t_ph = _time.perf_counter()
            forcings = fut.result()
            if w + 1 < n_windows:
                fut = executor.submit(load_window, *_bounds(w + 1))
            _phase_mark("window_forcing_wait", t_ph)

            if w == 0 and forcings is not None:
                # The window-relative gather equals the absolute ZOH series
                # only when window boundaries land on forcing-sample
                # boundaries (module docstring); validate rather than
                # silently shifting.  t0 must itself be dt-aligned — a
                # custom load_window with an off-grid t0 would silently
                # shift every sample (netcdf_window_loader re-checks per
                # window, arbitrary callables do not).
                for dt_min in forcings.meta.dt_min:
                    for what, val in (("chunk_minutes", chunk_minutes), ("t0", t0)):
                        if abs(val / dt_min - round(val / dt_min)) > 1e-9:
                            raise ValueError(
                                f"{what}={val} is not a multiple of forcing "
                                f"dt={dt_min} min; window-relative forcing "
                                "gathers would diverge from the unchunked series"
                            )

            qt = None
            if query_interval is not None:
                # Queries in (w_start, w_end], expressed window-relative; the
                # w == 0 window also carries the t0 query (fill_t0_queries).
                # First index = first multiple of query_interval strictly
                # greater than w_start (NOT w_start + query_interval, which
                # skips queries when chunk_minutes is not a multiple of
                # query_interval).
                lo_idx = (
                    0 if w == 0
                    else math.floor((w_start - t0) / query_interval + 1e-9) + 1
                )
                hi_idx = math.floor((w_end - t0) / query_interval + 1e-9)
                qt_abs = np.arange(lo_idx, hi_idx + 1) * query_interval + t0
                # Keep qt on the HOST: api.solve validates it with np.asarray,
                # which for a device array is a blocking pull every window.
                qt = qt_abs - w_start

            res = solve(
                model,
                y,
                0.0,
                w_end - w_start,
                qt,
                params=params,
                forcings=forcings,
                config=config,
                mesh=mesh,
                backend=backend,
                # Window time is relative; time-dependent physics (Model
                # 200's day-of-year) must see ABSOLUTE simulation time.
                t_shift=w_start,
            )
            # ONE jitted bookkeeping step instead of several eager
            # where/or/add dispatches per window.
            if rk_stats is None:
                rk_stats = jax.tree.map(jnp.zeros_like, res.rk_stats)
            y, stiff_any, failed_any, rk_stats = _carry_update_jit(
                y, res.y_final, stiff_any, res.stiff, failed_any, res.failed,
                rk_stats, res.rk_stats,
            )
            if qt is not None:
                routed_w = None
                if routed_fn is not None:
                    # Caller-supplied routing (e.g. run.py's cross-rank
                    # per-window allgather + full-topology accumulation for
                    # multi-process runs).  May block on a collective —
                    # every rank reaches this point once per window.
                    t_ph = _time.perf_counter()
                    routed_w = routed_fn(res.dense)
                    _phase_mark("window_routing_dispatch", t_ph)
                elif topology is not None:
                    # Dispatch the routing exchange for THIS window now; do
                    # not block — it executes while the next window's forcing
                    # loads and its solve is traced/dispatched.
                    from tiger_tpu.routing import routed_discharge

                    t_ph = _time.perf_counter()
                    routed_w = routed_discharge(res.dense, params, topology)
                    _phase_mark("window_routing_dispatch", t_ph)
                if dense_sink is not None:
                    t_ph = _time.perf_counter()
                    _submit_sink(dense_sink, lo_idx, qt_abs, res.dense, routed_w)
                    _phase_mark("window_dense_sink", t_ph)
                else:
                    all_dense.append(res.dense)
                    if routed_w is not None:
                        all_routed.append(routed_w)
            if state_sink is not None:
                _submit_sink(state_sink, w_end, y)
            n_stiff_total += res.n_stiff
            n_host_total += res.n_host
        for f in sink_futs:
            f.result()
    finally:
        executor.shutdown(wait=True)
        sink_executor.shutdown(wait=True)

    dense = (
        jnp.concatenate(all_dense, axis=1)
        if all_dense
        else jnp.zeros((s_count, 0, n_eq), y.dtype)
    )
    result = SolveResult(
        y_final=y,
        dense=dense,
        stiff=stiff_any,
        failed=failed_any,
        rk_stats=rk_stats,
        radau_stats=None,
        n_stiff=n_stiff_total,
        n_host=n_host_total,
    )
    if topology is not None or routed_fn is not None:
        routed = (
            jnp.concatenate(all_routed, axis=1)
            if all_routed
            else jnp.zeros((s_count, 0), y.dtype)
        )
        return result, routed
    return result


def netcdf_window_loader(
    specs: Sequence,
    stream_ids: np.ndarray,
    lookup_csv: str,
) -> Callable[[float, float], ForcingSet]:
    """Window loader over NetCDF files: reads only the needed time steps.

    Returns a ``load_window`` for solve_chunked; each call does an
    ``nc_get_vara``-style windowed read (NetCDFReader.load_time_chunk) plus
    the vectorized remap — the reference's loadTimeChunk streaming design
    actually wired up.
    """
    from tiger_tpu.io.lookup import LookupTable
    from tiger_tpu.io.netcdf import NetCDFReader

    luts = {
        p: LookupTable.load(p)
        for p in {getattr(s, "lookup", None) or lookup_csv for s in specs}
    }
    flat_cache: dict = {}  # (lookup, lon_size) -> [S] device index (uploaded once)

    from tiger_tpu.forcing import _check_flat_bounds, _check_remap_finite

    def load_window(w_start: float, w_end: float) -> ForcingSet:
        grids, dts, flats = [], [], []
        for spec in specs:
            lut_key = getattr(spec, "lookup", None) or lookup_csv
            lut = luts[lut_key]
            dt_min = spec.dt_hours * 60.0
            if abs((w_start / dt_min) - round(w_start / dt_min)) > 1e-9:
                raise ValueError(
                    f"window start {w_start} min not aligned to forcing dt {dt_min} min"
                )
            k0 = int(round(w_start / dt_min))
            k1 = int(math.ceil(w_end / dt_min - 1e-9))
            with NetCDFReader(spec.path, spec.var) as rd:
                k0c = min(k0, rd.time_size - 1)
                k1c = min(max(k1, k0c + 1), rd.time_size)
                chunk = rd.load_time_chunk(k0c, k1c - k0c)
                cache_key = (lut_key, rd.lon_size)
                if cache_key not in flat_cache:
                    flat_np = lut.flat_index(np.asarray(stream_ids), rd.lon_size)
                    flat_cache[cache_key] = (
                        flat_np, jnp.asarray(flat_np, jnp.int32)
                    )
                flat_np, flat_dev = flat_cache[cache_key]
                # Validate EVERY spec and EVERY window (the host check is two
                # [S] gathers): grids sharing a cache key can still differ in
                # extent/missing cells, and fill values can appear mid-record.
                _check_flat_bounds(flat_np, chunk.shape[1] * chunk.shape[2], spec)
                _check_remap_finite(chunk, flat_np, spec)
                flats.append(flat_dev)
                # Ship the grid, remap on device (ForcingSet.from_grid_series):
                # per window this is n_cells values per step over the link
                # instead of S — the upload no longer scales with basin size.
                grids.append(chunk.reshape(chunk.shape[0], -1))
                dts.append(dt_min)
        return ForcingSet.from_grid_series(grids, flats, dts)

    return load_window
