"""Full-framework CLI benchmark at production scale.

Synthesizes a realistic basin ON DISK — 1M-link parameter CSV in the
reference schema, ERA5-shaped pr/t2m forcing grids, stream->grid lookup —
then drives tiger_tpu.run.run() end to end (load -> remap -> solve -> NetCDF
write) and prints one JSON line with the per-phase wall seconds the CLI's
Metrics already collects.  This is the analog of the reference's
full `mpirun ./rk45_solver` workflow (src/main.cpp:255-828) at the "millions
of systems" scale it aspires to; the reference's only recorded metric is the
dense-write timer (main.cpp:809-823), reported here as `write_output`.

Setup (CSV/NetCDF synthesis) is NOT timed; phases are.

Usage: python benchmarks/cli_e2e.py [--systems 1048576] [--days 2] [--keep]
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


def synthesize(base: str, s_count: int, seed: int = 0, precision: str | None = None) -> str:
    """Write params.csv, lookup.csv, pr.nc, t2m.nc, config.yaml; return cfg path."""
    from tiger_tpu.io import write_grid_forcing

    rng = np.random.default_rng(seed)
    # Grid sized so every link gets its own-ish cell (ERA5-Land 0.1 deg scale).
    n_lat = max(int(np.ceil(np.sqrt(s_count / 2))), 4)
    n_lon = max((s_count + n_lat - 1) // n_lat, 4)
    pr = rng.uniform(0, 0.0015, (48, n_lat, n_lon)).astype(np.float32)
    t2m = rng.uniform(-2, 10, (2, n_lat, n_lon)).astype(np.float32)
    write_grid_forcing(os.path.join(base, "pr.nc"), "pr", pr)
    write_grid_forcing(os.path.join(base, "t2m.nc"), "t2m", t2m)

    streams = np.arange(1, s_count + 1, dtype=np.int64)
    cell = rng.permutation(n_lat * n_lon)[:s_count] if n_lat * n_lon >= s_count \
        else rng.integers(0, n_lat * n_lon, s_count)
    lat_idx, lon_idx = cell // n_lon, cell % n_lon

    lk = np.column_stack([streams, lat_idx, lon_idx])
    header = "stream,lat_index,lon_index"
    np.savetxt(os.path.join(base, "lookup.csv"), lk, fmt="%d", delimiter=",",
               header=header, comments="")

    # Params in the reference CSV schema (small_test.csv columns), values in
    # the plausible ranges the Model-204 bench scenario uses.
    cols = {
        "stream": streams,
        "next_stream": np.concatenate([streams[1:], [-1]]),
        "drainage_area_km2": rng.uniform(5, 20, s_count),
        "length_km": rng.uniform(0.5, 2.0, s_count),
        "area_sqkm": np.zeros(s_count),
        "centroid_lon": np.zeros(s_count),
        "centroid_lat": np.full(s_count, 41.5),
        "hu": rng.uniform(0.3, 0.7, s_count),
        "i2": rng.uniform(3, 8, s_count),
        "i3": rng.uniform(1, 4, s_count),
        "sw": np.full(s_count, 0.2),
        "ss": np.full(s_count, 0.8),
        "n": rng.uniform(0.02, 0.05, s_count),
        "slope": rng.uniform(0.01, 0.1, s_count),
        "res_ss": np.full(s_count, 2.0),
        "res_gw": np.full(s_count, 5.0),
        "melt": np.full(s_count, 1e-4),
        "t_thres": np.zeros(s_count),
    }
    mat = np.column_stack(list(cols.values()))
    np.savetxt(os.path.join(base, "params.csv"), mat,
               fmt=["%d", "%d"] + ["%.6g"] * (len(cols) - 2), delimiter=",",
               header=",".join(cols), comments="")

    cfg = f"""
model: {{uid: 204, name: Model204}}
time: {{start: "2019-01-01T00:00:00", end: "2019-01-03T00:00:00"}}
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
  print_interval: "1h"
  path: "{base}/out"
  prefix: bench{f'''
  precision: {precision}''' if precision else ''}
solver:
  method: RK45
  tolerances: {{rtol: 1.0e-5, atol: 1.0e-8, safety: 0.9, min_scale: 0.2, max_scale: 10.0}}
  precision: f32
"""
    cfg_path = os.path.join(base, "config.yaml")
    with open(cfg_path, "w") as f:
        f.write(cfg)
    return cfg_path


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--systems", type=int, default=1_048_576)
    p.add_argument("--days", type=float, default=2.0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--precision", default=None, choices=["f32", "f64", "i16"])
    p.add_argument("--keep", action="store_true", help="keep the synthesized dir")
    p.add_argument("--workdir", default=None)
    args = p.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from tiger_tpu.profiling import Metrics, enable_compile_cache

    enable_compile_cache()

    base = args.workdir or tempfile.mkdtemp(prefix="tiger_cli_e2e_")
    os.makedirs(base, exist_ok=True)
    try:
        t0 = time.perf_counter()
        cfg_path = synthesize(base, args.systems, precision=args.precision)
        setup_s = time.perf_counter() - t0

        from tiger_tpu.config import load_config
        from tiger_tpu.run import run

        cfg = load_config(cfg_path)
        metrics = Metrics()
        t0 = time.perf_counter()
        summary = run(cfg, metrics=metrics)
        wall = time.perf_counter() - t0

        import jax

        dense_path = os.path.join(base, "out", "dense_bench_rank_0.nc")
        print(json.dumps({
            "metric": "cli_e2e_wall_s",
            "value": round(wall, 3),
            "unit": "s",
            "systems": args.systems,
            "setup_s": round(setup_s, 3),
            "phases": {k: round(v, 3) for k, v in metrics.phases.items()},
            "system_steps_per_s": metrics.counters.get("system_steps_per_s"),
            "n_stiff": metrics.counters.get("n_stiff"),
            "dense_nc_bytes": os.path.getsize(dense_path)
            if os.path.exists(dense_path) else None,
            "backend": jax.devices()[0].platform,
        }))
        _ = summary
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    main()
