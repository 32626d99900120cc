"""Operational year-scale benchmark: 131k systems x 365 days, streamed.

Exercises the production serving path end to end: a full year of hourly
precipitation / daily temperature on an ERA5-shaped grid is synthesized on
disk, then the CLI's chunked executor (time.chunk_days) streams it through
bounded memory — per-window NetCDF forcing reads, fused-kernel solves,
routed-discharge exchange, and incremental dense/discharge NetCDF writes
(the whole [S, Q, N] output never exists in HBM or host RAM).

This is the scale the reference aspires to but cannot reach with its fixed
2-day in-memory window (src/main.cpp:525, loadTimeChunk never wired):
a year at 131k systems is ~4.3 GB of forcing and ~1 GB of dense output.

Prints one JSON line; not part of bench.py.

Usage: python benchmarks/year_run.py [--systems 131072] [--days 365]
                                     [--chunk-days 2] [--cpu] [--keep]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


#: Declared CF-packing ranges for the synthetic basin's states (generous:
#: the stores stay well inside these for the seasonal forcing used here).
I16_RANGES = "{0: [0.0, 1.0], 1: [0.0, 5.0], 2: [0.0, 0.1], 3: [0.0, 10.0], 4: [0.0, 2.0]}"


def synthesize(base: str, s_count: int, days: int, chunk_days: float, seed: int = 0,
               out_precision: str = "f32") -> str:
    """Year of seasonal forcing on a shared grid + tree-topology params."""
    from tiger_tpu.io import write_grid_forcing

    rng = np.random.default_rng(seed)
    # Shared grid (many links per cell, like ERA5-Land over a real basin):
    # keeps the forcing files ~300 MB for the year.
    n_lat, n_lon = 64, 128
    hours = days * 24
    t_h = np.arange(hours, dtype=np.float32)
    season = 0.5 * (1.0 - np.cos(2 * np.pi * t_h / (365.25 * 24)))  # 0..1, min in Jan
    # mm/hr-scale intermittent rain (the unit regime recovered from the
    # reference's own artifact run, PARITY_204.md: states in mm, pr ~1-15).
    pr = (
        rng.gamma(0.15, 2.0, (hours, n_lat, n_lon)).astype(np.float32)
        * (0.3 + season[:, None, None])
    ).astype(np.float32)
    t_d = np.arange(days, dtype=np.float32)
    t2m = (
        -8.0
        + 25.0 * 0.5 * (1.0 - np.cos(2 * np.pi * t_d / 365.25))[:, None, None]
        + rng.normal(0, 3, (days, n_lat, n_lon))
    ).astype(np.float32)  # winter below the melt threshold, summer above
    write_grid_forcing(os.path.join(base, "pr.nc"), "pr", pr)
    write_grid_forcing(os.path.join(base, "t2m.nc"), "t2m", t2m)

    streams = np.arange(1, s_count + 1, dtype=np.int64)
    cell = rng.integers(0, n_lat * n_lon, s_count)
    np.savetxt(
        os.path.join(base, "lookup.csv"),
        np.column_stack([streams, cell // n_lon, cell % n_lon]),
        fmt="%d", delimiter=",", header="stream,lat_index,lon_index", comments="",
    )

    # Tree topology with realistic depth (~S/256 hops to the outlet): each
    # link drains to a random link up to 512 positions downstream.
    jump = rng.integers(1, 513, s_count)
    nxt = np.minimum(np.arange(s_count) + jump, s_count - 1) + 1
    nxt[-1] = -1
    # Parameter magnitudes bracket the reference's small_test.csv row
    # (hu=178, i2=4, i3=1.6, n=0.1, slope=0.02, res_ss=2, res_gw=55,
    # melt=3.7): the regime the artifact run integrates.  length ~ area keeps
    # the Manning coefficient L/A_h near the reference's ~0.8.
    area = rng.uniform(0.1, 2.0, s_count)
    cols = {
        "stream": streams,
        "next_stream": nxt,
        "drainage_area_km2": area,
        "length_km": area * rng.uniform(0.5, 1.5, s_count),
        "area_sqkm": area,
        "centroid_lon": np.zeros(s_count),
        "centroid_lat": np.full(s_count, 41.5),
        "hu": rng.uniform(150, 250, s_count),
        "i2": rng.uniform(3, 6, s_count),
        "i3": rng.uniform(1, 2.5, s_count),
        "sw": np.full(s_count, 0.11),
        "ss": np.full(s_count, 0.33),
        "n": rng.uniform(0.05, 0.15, s_count),
        "slope": rng.uniform(0.01, 0.05, s_count),
        "res_ss": np.full(s_count, 2.0),
        "res_gw": np.full(s_count, 55.0),
        "melt": rng.uniform(3.0, 4.5, s_count),
        "t_thres": np.zeros(s_count),
    }
    np.savetxt(
        os.path.join(base, "params.csv"), np.column_stack(list(cols.values())),
        fmt=["%d", "%d"] + ["%.6g"] * (len(cols) - 2), delimiter=",",
        header=",".join(cols), comments="",
    )

    end_day = np.datetime64("2019-01-01") + np.timedelta64(days, "D")
    cfg = f"""
model: {{uid: 204, name: Model204}}
time:
  start: "2019-01-01T00:00:00"
  end: "{end_day}T00:00:00"
  chunk_days: {chunk_days}
initial: {{mode: cold}}
local_params: {{file: "{base}/params.csv"}}
forcings:
  type: files
  path: "{base}"
  lookup: "{base}/lookup.csv"
  vars: {{precipitation: pr, temperature: t2m}}
  files:
    - {{file: pr.nc, var: pr, dt_hours: 1.0}}
    - {{file: t2m.nc, var: t2m, dt_hours: 24.0}}
output:
  print_interval: "1d"
  path: "{base}/out"
  prefix: year
  routed_discharge: true
  precision: {out_precision if out_precision != 'solve' else 'null'}
  i16_ranges: {I16_RANGES if out_precision == 'i16' else 'null'}
solver:
  method: RK45
  tolerances: {{rtol: 1.0e-5, atol: 1.0e-6, safety: 0.9, min_scale: 0.2, max_scale: 10.0}}
  precision: f32
"""
    cfg_path = os.path.join(base, "config.yaml")
    with open(cfg_path, "w") as f:
        f.write(cfg)
    return cfg_path


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--systems", type=int, default=131_072)
    p.add_argument("--days", type=int, default=365)
    p.add_argument("--chunk-days", type=float, default=2.0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--keep", action="store_true")
    p.add_argument("--workdir", default=None)
    p.add_argument(
        "--out-precision", default="solve",
        choices=["solve", "f32", "f64", "i16"],
        help="dense NetCDF precision; i16 streams CF-packed output with the "
        "declared I16_RANGES (4x smaller than f64 on wire and disk)",
    )
    args = p.parse_args()
    if abs(args.chunk_days - round(args.chunk_days)) > 1e-9:
        # Daily t2m forcing makes only whole-day windows valid; fail BEFORE
        # synthesizing ~300 MB of forcing, not at window 2.
        p.error(f"--chunk-days must be a whole number of days (t2m dt = 1 day), got {args.chunk_days}")

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from tiger_tpu.profiling import Metrics, enable_compile_cache

    enable_compile_cache()

    base = args.workdir or tempfile.mkdtemp(prefix="tiger_year_")
    os.makedirs(base, exist_ok=True)
    try:
        t0 = time.perf_counter()
        cfg_path = synthesize(
            base, args.systems, args.days, args.chunk_days,
            out_precision=args.out_precision,
        )
        setup_s = time.perf_counter() - t0

        from tiger_tpu.config import load_config
        from tiger_tpu.run import run

        cfg = load_config(cfg_path)
        metrics = Metrics()
        t0 = time.perf_counter()
        summary = run(cfg, metrics=metrics)
        wall = time.perf_counter() - t0

        import jax

        from tiger_tpu.profiling import solver_phase_times

        out = os.path.join(base, "out")
        extra = {}
        if os.environ.get("TT_PHASE_PROFILE"):
            extra["solver_phases"] = {
                k: round(v, 3) for k, v in solver_phase_times().items()
            }
        print(json.dumps({
            **extra,
            "metric": "year_run_wall_s",
            "value": round(wall, 3),
            "unit": "s",
            "systems": args.systems,
            "days": args.days,
            "out_precision": args.out_precision,
            "n_windows": summary.get("n_windows"),
            "setup_s": round(setup_s, 3),
            "phases": {k: round(v, 3) for k, v in metrics.phases.items()},
            "system_steps_per_s": metrics.counters.get("system_steps_per_s"),
            "n_stiff": summary.get("n_stiff"),
            "n_failed": summary.get("n_failed"),
            "forcing_nc_bytes": os.path.getsize(os.path.join(base, "pr.nc"))
            + os.path.getsize(os.path.join(base, "t2m.nc")),
            "dense_nc_bytes": os.path.getsize(os.path.join(out, "dense_year_rank_0.nc")),
            "discharge_nc_bytes": os.path.getsize(
                os.path.join(out, "discharge_year_rank_0.nc")
            ),
            "backend": jax.devices()[0].platform,
        }))
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    main()
