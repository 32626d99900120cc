"""CLI driver: config -> load -> shard -> solve -> write.

Replaces the reference's hard-coded main.cpp (src/main.cpp:255-828): every
path, time span, y0, tolerance and output location the reference bakes in is
driven by the YAML config (tiger_tpu.config implements the schema the
reference specified in data/config.yaml but never wired up).

Multi-process layout: instead of MPI rank 0 scattering SpatialParams blobs
(main.cpp:257-310), every process slices its own contiguous row range of the
parameter table and writes per-process output shards — the same per-rank file
convention as the reference (main.cpp:796-797).  Launch one process per host
with jax.distributed (use --distributed).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np

#: Cold-start defaults per model uid (reference main.cpp:377 for 204).
COLD_STATE_DEFAULTS = {
    204: (0.01, 3.0, 0.0, 5.0, 0.2),
    1: (1.0, 1.0, 1.0, 1.0, 1.0),
}


def run(cfg, devices=None, metrics=None, use_mesh: bool = True, backend: str = "auto") -> dict:
    """Execute one simulation described by a SimulationConfig; returns summary."""
    import jax
    import jax.numpy as jnp

    from tiger_tpu import checkpoint as ckpt
    from tiger_tpu import params as params_mod
    from tiger_tpu.config import parse_interval_minutes
    from tiger_tpu.dist import shard_rows_for_process, systems_mesh
    from tiger_tpu.forcing import ForcingSpec, load_forcings
    from tiger_tpu.io import (
        write_dense_csv,
        write_dense_netcdf,
        write_dense_netcdf_packed,
        write_final_csv,
        write_final_netcdf,
    )
    from tiger_tpu.models import get_model
    from tiger_tpu.profiling import Metrics
    from tiger_tpu.solver import solve

    if cfg.solver.precision == "f64":
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if cfg.solver.precision == "f64" else jnp.float32

    metrics = metrics or Metrics()
    # doy anchored to time.start (config.yaml:40): models that use day-of-year
    # (Model 200's Hamon PET) receive the start date's doy.
    doy0 = float(cfg.time.start.timetuple().tm_yday)
    model = get_model(cfg.model.uid, doy0=doy0)

    # ---- load & shard spatial parameters -------------------------------
    with metrics.phase("load_params"):
        sp_full = params_mod.load_spatial_params(
            cfg.params_file, columns=cfg.params_columns
        )
        s_total = params_mod.num_systems(sp_full)
        rows = shard_rows_for_process(s_total)
        sp = params_mod.slice_rows(sp_full, rows)
        n_sys = params_mod.num_systems(sp)
        link_ids = sp["stream"]
        model_params = {
            k: jnp.asarray(v, dtype) for k, v in params_mod.model_params(sp).items()
        }
        # global_params (config.yaml:20-22): scalars broadcast to every
        # system; per-link CSV fields win on collision.
        for name, value in cfg.global_params.items():
            if name not in model_params:
                model_params[name] = jnp.full((n_sys,), value, dtype)

    # ---- time span / queries -------------------------------------------
    t0, tf = 0.0, cfg.time.duration_minutes
    interval = parse_interval_minutes(cfg.output.print_interval)
    query_times = np.arange(t0, tf + 1e-9, interval)

    # ---- forcings -------------------------------------------------------
    forcings = None
    specs = None
    chunked = cfg.time.chunk_days > 0
    if cfg.forcings.files or (cfg.forcings.type == "folder_nc" and cfg.forcings.path):
        if cfg.forcings.files:
            def _resolve(p):
                return (
                    p if p is None or os.path.isabs(p)
                    else os.path.join(cfg.forcings.path, p)
                )

            specs = [
                ForcingSpec(
                    path=_resolve(f["file"]),
                    var=f["var"],
                    dt_hours=float(f["dt_hours"]),
                    # Per-forcing lookup CSV (grids of different resolution;
                    # the reference loads one lookup per grid, main.cpp:494).
                    lookup=_resolve(f.get("lookup")),
                )
                for f in cfg.forcings.files
            ]
        else:
            # folder_nc discovery (config.yaml:33-40): scan the folder
            # for the named variables, infer dt from time coordinates.
            from tiger_tpu.forcing import discover_forcings

            specs = discover_forcings(
                cfg.forcings.path,
                [cfg.forcings.vars.precipitation, cfg.forcings.vars.temperature],
            )
        if not chunked:
            # Chunked runs never materialize the full record: each window's
            # rows are read on demand (netcdf_window_loader below).
            with metrics.phase("load_forcings"):
                forcings = load_forcings(
                    specs,
                    link_ids,
                    cfg.forcings.lookup,
                    duration_days=tf / 1440.0,
                )

    # ---- initial conditions --------------------------------------------
    resume_t = None
    with metrics.phase("init_state"):
        if cfg.initial.mode == "hot":
            # {rank} templating: multi-process runs checkpoint per rank, so
            # resume must load each rank's own shard file.
            state_file = cfg.initial.file.replace("{rank}", str(jax.process_index()))
            y0, _, t_ckpt = ckpt.load_state(
                state_file, link_ids, require_time=cfg.initial.resume
            )
            if y0.shape[1] != model.N_EQ:
                raise ValueError(
                    f"Hot-start state has {y0.shape[1]} vars, model needs {model.N_EQ}"
                )
            if cfg.initial.resume:
                # Continue the ORIGINAL run from the checkpoint's sim time
                # (chunked only: output files are re-opened, not recreated).
                if not chunked:
                    raise ValueError(
                        "initial.resume requires time.chunk_days > 0 "
                        "(windowed output that can be re-opened)"
                    )
                resume_t = t_ckpt
        else:
            cold = cfg.initial.cold_state or COLD_STATE_DEFAULTS.get(
                cfg.model.uid, (0.0,) * model.N_EQ
            )
            if len(cold) != model.N_EQ:
                raise ValueError(
                    f"initial.cold_state has {len(cold)} vars, model needs "
                    f"{model.N_EQ}"
                )
            y0 = ckpt.cold_state(cold, n_sys)
        y0 = jnp.asarray(y0, dtype)

    # ---- solve ----------------------------------------------------------
    # Multi-process runs mesh over LOCAL devices only: each process owns its
    # row slice end to end (the reference's independent ranks, main.cpp:310+);
    # no global mesh means every array stays addressable for the two-phase
    # stiff compaction.  Single-process: local == global devices.
    mesh = None
    if use_mesh:
        devs = devices or jax.local_devices()
        if len(devs) > 1:
            mesh = systems_mesh(devs)
    if chunked:
        return _run_chunked(
            cfg, model, y0, t0, tf, query_times, model_params, specs,
            link_ids, sp, mesh, backend, metrics, dtype, resume_t=resume_t,
            sp_full=sp_full, rows=rows,
        )
    t_solve = time.perf_counter()
    with metrics.phase("solve"):
        res = solve(
            model,
            y0,
            t0,
            tf,
            jnp.asarray(query_times),
            params=model_params,
            forcings=forcings,
            config=cfg.solver_config(),
            mesh=mesh,
            backend=backend,
        )
        jax.block_until_ready(res.y_final)
    metrics.record_solve(res, time.perf_counter() - t_solve)

    # ---- select output states ------------------------------------------
    # dense stays ON DEVICE: the NetCDF writer streams it to disk slab by
    # slab, overlapping the (slow, multi-GB) device->host pull with the HDF5
    # write instead of first duplicating it in host memory.
    y_final = np.asarray(res.y_final)
    dense = res.dense
    state_ids = np.arange(model.N_EQ, dtype=np.int32)
    if cfg.output.states is not None:
        state_ids = np.asarray(cfg.output.states, np.int32)
        y_final = y_final[:, state_ids]
        dense = dense[:, :, jnp.asarray(state_ids)]

    # ---- write outputs (per-process shards, like per-rank files) -------
    proc = jax.process_index()
    prefix = cfg.output.prefix
    outdir = cfg.output.path
    os.makedirs(outdir, exist_ok=True)
    with metrics.phase("write_output"):
        if cfg.output.format == "csv":
            final_path = os.path.join(outdir, f"final_{prefix}_rank_{proc}.csv")
            dense_path = os.path.join(outdir, f"dense_{prefix}_rank_{proc}.csv")
            write_final_csv(final_path, y_final)
            write_dense_csv(dense_path, dense, query_times)
        else:
            final_path = os.path.join(outdir, f"final_{prefix}_rank_{proc}.nc")
            dense_path = os.path.join(outdir, f"dense_{prefix}_rank_{proc}.nc")
            out_dtype = {None: None, "f32": np.float32, "f64": np.float64,
                         "i16": None}[cfg.output.precision]
            write_final_netcdf(
                final_path, y_final, link_ids, state_ids, cfg.output.compression_level,
                dtype=out_dtype,
            )
            if cfg.output.precision == "i16":
                # CF int16 packing, quantized on device: 2 bytes/sample over
                # the interconnect and on disk (the final file above is tiny
                # and stays at solve precision).
                write_dense_netcdf_packed(
                    dense_path, dense, query_times, link_ids, state_ids,
                    cfg.output.compression_level,
                )
            else:
                write_dense_netcdf(
                    dense_path, dense, query_times, link_ids, state_ids,
                    cfg.output.compression_level, dtype=out_dtype,
                )
        # Routed discharge hydrograph over the next_stream topology (the
        # routing output the reference carries data for but never computes).
        if cfg.output.routed_discharge:
            from tiger_tpu import routing
            from tiger_tpu.io.netcdf import NetCDFWriter

            if jax.process_count() > 1:
                routed_fn = _make_cross_rank_routed(cfg, sp_full, dtype, rows)
                q_routed = np.asarray(routed_fn(res.dense))
            else:
                topo = routing.build_topology(sp["stream"], sp["next_stream"])
                q_routed = np.asarray(
                    routing.routed_discharge(res.dense, model_params, topo)
                )
            discharge_path = os.path.join(outdir, f"discharge_{prefix}_rank_{proc}.nc")
            from tiger_tpu.io.output import _def_output_dims

            with NetCDFWriter(discharge_path) as w:
                _def_output_dims(w, link_ids, query_times)
                w.def_var(
                    "discharge", q_routed.astype(np.float64), ("system", "time"),
                    cfg.output.compression_level,
                    attrs={"long_name": "routed downstream-accumulated outflow"},
                )

        # Checkpoint for hot restart of the NEXT run.
        state_path = os.path.join(outdir, f"state_{prefix}_rank_{proc}.nc")
        ckpt.save_state(state_path, np.asarray(res.y_final), link_ids, tf)

    return {
        "num_systems": n_sys,
        "n_stiff": res.n_stiff,
        "n_host": res.n_host,
        "n_failed": int(np.asarray(res.failed).sum()),
        "final_path": final_path,
        "dense_path": dense_path,
        "state_path": state_path,
        **metrics.summary(),
    }


def _make_cross_rank_routed(cfg, sp_full, dtype, rows):
    """Dense -> routed-discharge fn that is correct across rank boundaries.

    Downstream links cross rank boundaries, so a local-slice topology would
    silently drop upstream contributions at shard edges.  Two exchanges
    (cfg.output.routed_exchange):

    - ``ring`` (default): each rank computes ITS rows' link runoff locally,
      then the sharded-topology ring exchange (routing.exchange_sharded:
      shard_map + ppermute outbox delivery, the reference's never-built MPI
      neighbor transfer, stream.hpp:31) accumulates across ranks — only the
      cross-shard outbox travels, O(M * log depth * ranks) bytes per window.
    - ``allgather`` (oracle): every rank receives the FULL [S_total, Q, N]
      dense block (jax.experimental.multihost_utils.process_allgather) and
      redundantly accumulates the whole basin — O(S_total * Q * N) bytes to
      every rank per window; kept for verification and for backends without
      cross-process collectives.

    Shared by the unchunked path and the chunked per-window path
    (solve_chunked's ``routed_fn``); topology, plan and parameters are built
    ONCE, each call moves only one window's data.
    """
    import jax
    import jax.numpy as jnp

    from tiger_tpu import params as params_mod
    from tiger_tpu import routing
    from tiger_tpu.params import split_even

    topo = routing.build_topology(sp_full["stream"], sp_full["next_stream"])
    s_total = params_mod.num_systems(sp_full)
    slices = split_even(s_total, jax.process_count())

    def _params_for(sp_rows, n):
        out = {
            k: jnp.asarray(v, dtype)
            for k, v in params_mod.model_params(sp_rows).items()
        }
        # global_params broadcast like the local slice got: link_runoff
        # needs the same fields.
        for name, value in cfg.global_params.items():
            if name not in out:
                out[name] = jnp.full((n,), value, dtype)
        return out

    if cfg.output.routed_exchange == "ring":
        import numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec

        n_proc = jax.process_count()
        plan = routing.plan_sharded_topology(topo, n_proc, bounds=slices)
        # One shard per PROCESS: the exchange mesh takes each process's
        # first device (the solve may use its own local mesh; the routed
        # window is small next to the solve, so one device per rank is the
        # right grain for the ICI/DCN exchange).
        by_proc = {}
        for d in jax.devices():
            by_proc.setdefault(d.process_index, d)
        ring_mesh = Mesh(
            np.array([by_proc[i] for i in range(n_proc)]), ("shards",)
        )
        sharding = NamedSharding(ring_mesh, PartitionSpec("shards"))
        me = jax.process_index()
        my_rows = slices[me]
        n_local = my_rows.stop - my_rows.start
        local_params = _params_for(params_mod.slice_rows(sp_full, my_rows), n_local)

        @jax.jit
        def _local_runoff(dense):
            def per_time(y_slice):  # [S_local, N]
                return routing.link_runoff_204(
                    jnp.nan_to_num(y_slice), local_params
                )

            return jax.vmap(per_time, in_axes=1, out_axes=1)(dense)

        def routed(dense_local):
            q_local = np.asarray(_local_runoff(jnp.asarray(dense_local)))
            blk = np.zeros((1, plan.block, q_local.shape[1]), q_local.dtype)
            blk[0, :n_local] = q_local
            q_g = jax.make_array_from_process_local_data(sharding, blk)
            out = routing.exchange_sharded(q_g, plan, ring_mesh)
            mine = np.asarray(out.addressable_shards[0].data)
            return mine[0, :n_local]

        return routed

    from jax.experimental import multihost_utils

    full_params = _params_for(sp_full, s_total)
    max_len = max(sl.stop - sl.start for sl in slices)

    def routed(dense_local):
        local = jnp.asarray(dense_local)
        local = jnp.pad(local, ((0, max_len - local.shape[0]), (0, 0), (0, 0)))
        gath = multihost_utils.process_allgather(local, tiled=True)
        dense_full = jnp.concatenate(
            [
                gath[i * max_len : i * max_len + (sl.stop - sl.start)]
                for i, sl in enumerate(slices)
            ],
            axis=0,
        )
        return routing.routed_discharge(dense_full, full_params, topo)[rows]

    return routed


def _run_chunked(
    cfg, model, y0, t0, tf, query_times, model_params, specs,
    link_ids, sp, mesh, backend, metrics, dtype, resume_t=None,
    sp_full=None, rows=None,
) -> dict:
    """Windowed (streaming) execution: ``time.chunk_days`` at a time.

    Forcing rows are read per window (netcdf_window_loader) and dense/routed
    output is written incrementally (WindowedVarWriter), so memory stays
    bounded regardless of the record length — a year of hourly forcing at 1M
    systems streams through a few hundred MB of HBM.  The reference's
    loadTimeChunk streaming design (forcing_loader.cpp:164), operational.

    ``resume_t`` (crash recovery, initial.resume): continue the original run
    from this simulated minute — output files are re-opened and filled from
    that point; ``output.checkpoint_interval`` writes the state file along
    the way so such a resume point always exists.
    """
    import jax
    import jax.numpy as jnp

    from tiger_tpu import checkpoint as ckpt
    from tiger_tpu.chunked import netcdf_window_loader, solve_chunked
    from tiger_tpu.config import parse_interval_minutes
    from tiger_tpu.io import write_final_csv, write_final_netcdf
    from tiger_tpu.io.output import (
        WindowedCSVWriter,
        WindowedPackedWriter,
        WindowedVarWriter,
    )

    csv = cfg.output.format == "csv"
    if csv and cfg.output.precision == "i16":
        raise ValueError("output.precision i16 needs output.format: netcdf")
    if cfg.output.precision == "i16" and cfg.output.i16_ranges is None:
        raise ValueError(
            "output.precision i16 with chunked runs needs DECLARED per-state "
            "packing ranges (the global min/max cannot be derived from "
            "windows not yet solved): set output.i16_ranges "
            "{state_id: [min, max], ...}, or use f32/f64 / solve unchunked"
        )
    # Multi-process routed discharge: per-window cross-rank allgather +
    # accumulation on the FULL topology (the same machinery the unchunked
    # path uses, applied window by window).  Built once; solve_chunked calls
    # it per window in place of the local-topology routing.
    routed_fn = None
    if cfg.output.routed_discharge and jax.process_count() > 1:
        routed_fn = _make_cross_rank_routed(cfg, sp_full, dtype, rows)

    interval = parse_interval_minutes(cfg.output.print_interval)
    chunk_minutes = cfg.time.chunk_days * 1440.0
    t_start = t0 if resume_t is None else float(resume_t)
    if resume_t is not None:
        for name, step in (("chunk_days", chunk_minutes), ("print_interval", interval)):
            if abs((t_start - t0) / step - round((t_start - t0) / step)) > 1e-9:
                raise ValueError(
                    f"resume time {t_start} min is not aligned to {name} "
                    f"({step} min); checkpoints are written at window ends"
                )
        if not (t0 <= t_start < tf):
            raise ValueError(
                f"resume time {t_start} min outside the run span [{t0}, {tf})"
            )
    base_q = int(round((t_start - t0) / interval))
    loader = (
        netcdf_window_loader(specs, link_ids, cfg.forcings.lookup)
        if specs
        else (lambda w_start, w_end: None)
    )

    topo = None
    if cfg.output.routed_discharge and routed_fn is None:
        from tiger_tpu import routing

        topo = routing.build_topology(sp["stream"], sp["next_stream"])

    state_ids = np.arange(model.N_EQ, dtype=np.int32)
    state_sel = None
    if cfg.output.states is not None:
        state_ids = np.asarray(cfg.output.states, np.int32)
        state_sel = jnp.asarray(state_ids)

    proc = jax.process_index()
    prefix = cfg.output.prefix
    outdir = cfg.output.path
    os.makedirs(outdir, exist_ok=True)
    ext = "csv" if csv else "nc"
    final_path = os.path.join(outdir, f"final_{prefix}_rank_{proc}.{ext}")
    dense_path = os.path.join(outdir, f"dense_{prefix}_rank_{proc}.{ext}")
    out_dtype = {None: np.dtype(dtype), "f32": np.float32,
                 "f64": np.float64, "i16": np.int16}[cfg.output.precision]
    if cfg.output.precision == "i16":
        missing = [int(v) for v in state_ids if int(v) not in cfg.output.i16_ranges]
        if missing:
            raise ValueError(
                f"output.i16_ranges is missing output states {missing}"
            )

    import contextlib

    t_solve = time.perf_counter()
    resume = resume_t is not None
    state_path = os.path.join(outdir, f"state_{prefix}_rank_{proc}.nc")
    with contextlib.ExitStack() as stack, metrics.phase("solve"):
        if csv:
            dense_w = stack.enter_context(WindowedCSVWriter(
                dense_path,
                [f"var{i}_sys{s}" for s in range(len(link_ids)) for i in state_ids],
                query_times, resume=resume,
            ))
        elif cfg.output.precision == "i16":
            dense_w = stack.enter_context(
                WindowedPackedWriter(
                    dense_path, link_ids, query_times, state_ids,
                    cfg.output.i16_ranges,
                    compression_level=cfg.output.compression_level,
                    resume=resume,
                )
            )
        else:
            dense_w = stack.enter_context(
                WindowedVarWriter(
                    dense_path, "outputs", link_ids, query_times,
                    state_ids=state_ids,
                    compression_level=cfg.output.compression_level,
                    dtype=out_dtype, resume=resume,
                )
            )
        disc_w = None
        if topo is not None or routed_fn is not None:
            discharge_path = os.path.join(
                outdir, f"discharge_{prefix}_rank_{proc}.{ext}"
            )
            disc_w = stack.enter_context(
                WindowedCSVWriter(
                    discharge_path,
                    [f"discharge_sys{s}" for s in range(len(link_ids))],
                    query_times, resume=resume,
                )
                if csv
                else WindowedVarWriter(
                    discharge_path, "discharge", link_ids, query_times,
                    compression_level=cfg.output.compression_level,
                    dtype=np.float64,
                    attrs={"long_name": "routed downstream-accumulated outflow"},
                    resume=resume,
                )
            )

        def sink(q0, qt_abs, dense_blk, routed_blk):
            if resume and q0 == 0 and len(qt_abs) and abs(qt_abs[0] - t_start) < 1e-9:
                # The resume-boundary row was already written by the original
                # run (as the last window's dense INTERPOLANT); rewriting it
                # with the checkpoint state would perturb it by rounding.
                q0, dense_blk = 1, dense_blk[:, 1:]
                routed_blk = None if routed_blk is None else routed_blk[:, 1:]
            if state_sel is not None:
                dense_blk = dense_blk[:, :, state_sel]
            dense_w.write(base_q + q0, dense_blk)
            if disc_w is not None:
                disc_w.write(base_q + q0, routed_blk)

        state_cb = None
        if cfg.output.checkpoint_interval is not None:
            ckpt_every = parse_interval_minutes(cfg.output.checkpoint_interval)
            # Checkpoints land at window ends (k * chunk_minutes); resume
            # requires those times to sit on the query grid.  Refuse up front
            # rather than writing checkpoints that can never be resumed.
            if abs(chunk_minutes / interval - round(chunk_minutes / interval)) > 1e-9:
                raise ValueError(
                    f"output.checkpoint_interval needs time.chunk_days*1440 "
                    f"({chunk_minutes} min) to be a multiple of "
                    f"output.print_interval ({interval} min): checkpoints are "
                    "written at window ends, and resume must land on the "
                    "query grid"
                )
            next_mark = [t_start + ckpt_every]

            def state_cb(t_abs, y):
                # Runs on the output worker thread AFTER this window's dense
                # writes: flush first, so the checkpoint never claims a time
                # whose output could be lost by a crash right after it.
                if t_abs + 1e-9 < next_mark[0]:
                    return
                dense_w.flush()
                if disc_w is not None:
                    disc_w.flush()
                ckpt.save_state(state_path, np.asarray(y), link_ids, float(t_abs))
                while next_mark[0] <= t_abs + 1e-9:
                    next_mark[0] += ckpt_every

        res = solve_chunked(
            model, y0, t_start, tf, chunk_minutes, loader,
            query_interval=interval, params=model_params,
            config=cfg.solver_config(), mesh=mesh, backend=backend,
            topology=topo, routed_fn=routed_fn,
            dense_sink=sink, state_sink=state_cb,
        )
        if topo is not None or routed_fn is not None:
            res = res[0]
        jax.block_until_ready(res.y_final)
    metrics.record_solve(res, time.perf_counter() - t_solve)

    with metrics.phase("write_output"):
        y_final = np.asarray(res.y_final)
        if csv:
            write_final_csv(final_path, y_final[:, state_ids])
        else:
            write_final_netcdf(
                final_path, y_final[:, state_ids], link_ids, state_ids,
                cfg.output.compression_level,
                # i16 packs only the (huge) dense record; the final state
                # stays at solve precision (same rule as the unchunked path).
                dtype={None: None, "f32": np.float32, "f64": np.float64,
                       "i16": None}[cfg.output.precision],
            )
        ckpt.save_state(state_path, y_final, link_ids, tf)

    return {
        "num_systems": len(link_ids),
        "n_stiff": res.n_stiff,
        "n_host": res.n_host,
        "n_failed": int(np.asarray(res.failed).sum()),
        "n_windows": max(1, int(np.ceil((tf - t_start) / chunk_minutes - 1e-9))),
        "final_path": final_path,
        "dense_path": dense_path,
        "state_path": state_path,
        **metrics.summary(),
    }


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tiger-tpu", description="Tiger-HLM hydrologic engine in JAX"
    )
    p.add_argument("--config", required=True, help="YAML simulation config")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument(
        "--distributed", action="store_true", help="jax.distributed.initialize()"
    )
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (else auto-detected)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--profile-dir", default=None, help="jax.profiler trace directory")
    p.add_argument(
        "--backend",
        default="auto",
        choices=["auto", "pallas", "xla"],
        help="RK45 backend: auto picks the fused GPU kernels on f32 GPU runs",
    )
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.distributed:
        import jax

        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    from tiger_tpu.config import load_config
    from tiger_tpu.profiling import Metrics, enable_compile_cache, trace

    enable_compile_cache()
    cfg = load_config(args.config)
    metrics = Metrics()
    with trace(args.profile_dir):
        summary = run(cfg, metrics=metrics, backend=args.backend)
    import json

    print(json.dumps(summary, sort_keys=True, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
