"""Smoke test of the production path on an NVIDIA GPU.

Drives the system once through the entry points a user calls, at full size,
on the card, and checks every kernel of that path against the plain vmap
reference:

  gpu_tests      tests/test_gpu.py (marker ``gpu``), in a child process that
                 ends before this one opens the card;
  two_phase_1m   solve() on 1,048,576 Model-204 systems (f32, rtol 1e-5 /
                 atol 1e-8, 2 days, hourly dense output, ~0.1% genuinely
                 stiff lanes): RK45 kernel -> stiff flags -> Radau kernel on
                 the card -> merge; the RK45 kernel against the vmap path at
                 the same width (flags differ on <= 0.01% of lanes), and the
                 f64 truth on the lanes the two disagree on most and on the
                 lanes whose flags differ;
  radau_rung     the Radau kernel against the vmapped Radau solver on the
                 flagged subset;
  rk45_vs_f64    the f32 kernel against the f64 vmap path, 131,072 systems,
                 on steady forcing and on hourly-varying rain;
  model200       Model 200 (Hamon PET: inverse trig in-kernel), 131,072
                 systems, kernel against vmap and through solve();
  cli            the ``python -m tiger_tpu.run`` entry point (``main``, in
                 this process, which holds the card) on the reference
                 basin's 41,274 links (gridded forcing + lookup remap, two
                 1-day windows, routed discharge, checkpoint at the window
                 boundary), then a resume from that checkpoint, which must
                 reproduce the straight run's final state bitwise.

``--chips 4`` runs only the four-GPU phase: solve() sharded over a 4-device
mesh against one card, and the chunked run over the mesh, routed through the
ppermute ring (routing.exchange_sharded) and resumed, against one card.

Each phase prints one line of numbers; any exception, compare past its
tolerance, or lane left to the host float64 pipeline fails the run.  With no
GPU, or on any failure, the script exits non-zero and prints no result.  The
last line of a passing run is the device JSON.

Usage:  python chip_smoke.py [--chips 4]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import NamedTuple

import numpy as np

RTOL, ATOL = 5e-3, 1e-5  # kernel-vs-reference bound (tests/test_pallas_kernel.py)
RTOL_VARYING = 0.08  # tests/test_pallas_kernel.py::test_time_varying_forcing_smoke
FLAG_FRAC = 1e-4  # stiff flags of kernel and vmap path differ on <= 0.01% of lanes
FLAG_FRAC_F64 = 1e-3  # the same, f32 kernel against the f64 path (see phase_f64)
SPAN = 2880.0  # 2 days, minutes
CFG_KW = dict(rtol=1e-5, atol=1e-8, max_steps=100_000)


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def lane_errors(a, b, rtol=RTOL, atol=ATOL):
    """[S, K] |a - b| in units of the allclose tolerance (<= 1 passes) for
    arrays with lanes on axis 0; non-finite entries count as inf."""
    a, b = np.asarray(a), np.asarray(b)
    out = np.empty((a.shape[0], a[0].size), np.float32)
    step = 1 << 17
    for i in range(0, a.shape[0], step):
        x = a[i:i + step].reshape(-1, out.shape[1]).astype(np.float64)
        y = b[i:i + step].reshape(-1, out.shape[1]).astype(np.float64)
        e = np.abs(x - y) / (atol + rtol * np.abs(y))
        out[i:i + step] = np.where(np.isfinite(e), e, np.inf)
    return out


def err_summary(e, rtol=RTOL, atol=ATOL):
    e = np.asarray(e).ravel()
    if e.size == 0:
        e = np.zeros(1)
    return {
        "err_p50": float(np.percentile(e, 50)),
        "err_p99": float(np.percentile(e, 99)),
        "err_max": float(np.max(e)),
        "tol": f"rtol={rtol:g},atol={atol:g}",
    }


def emit(phase, **fields):
    parts = [f"phase={phase}"]
    for k, v in fields.items():
        parts.append(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}")
    print(" ".join(parts), flush=True)


def peak_bytes(dev=None):
    import jax

    dev = dev or jax.devices()[0]
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def timed(fn):
    """(result, seconds) with the result's arrays ready."""
    import jax

    t = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t


def hourly(span=SPAN):
    import jax.numpy as jnp

    return jnp.arange(0.0, span + 1e-9, 60.0, dtype=jnp.float32)


class Compare(NamedTuple):
    differ: np.ndarray  # lanes whose stiff flags differ
    summary: dict  # error distribution on lanes neither flagged
    worst: np.ndarray  # the lanes neither flagged with the largest errors
    within: float  # share of lanes neither flagged that meet the bound


def compare_rk(ker, ref, rtol=RTOL, atol=ATOL, n_worst=16):
    """Kernel vs reference on lanes neither flagged (states and dense).

    The kernel and the vmap path run the same arithmetic in the same order
    (bitwise equal in the Pallas interpreter on the CPU); on the card they
    differ by FMA contraction and the math library's last bits, so only
    lanes that sit on a stiffness threshold may flag differently."""
    ks, rs = np.asarray(ker.stiff), np.asarray(ref.stiff)
    ok = ~(ks | rs)
    e = np.concatenate([
        lane_errors(ker.y_final, ref.y_final, rtol, atol),
        lane_errors(ker.dense, ref.dense, rtol, atol),
    ], axis=1)[ok]
    lane_max = e.max(axis=1)
    worst = np.nonzero(ok)[0][np.argsort(lane_max)[-n_worst:]]
    return Compare(np.nonzero(ks != rs)[0], err_summary(e, rtol, atol), worst,
                   float(np.mean(lane_max <= 1.0)) if lane_max.size else 1.0)


def f64_truth(model, rows, y0, params, forc, qt, cfg, n_pad=64):
    """(y_final, dense) of the float64 Radau solve of lanes ``rows`` on the
    card: a stiff-safe reference that says which of two float32 answers is
    right.  The subset is padded to ``n_pad`` lanes, so that each phase
    compiles it once."""
    import jax
    import jax.numpy as jnp

    from tiger_tpu.forcing import ForcingSet
    from tiger_tpu.solver import radau_solve

    rows = np.asarray(rows, np.int64)
    idx = np.concatenate([rows, np.zeros(max(n_pad - len(rows), 0), np.int64)])
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(np.asarray(a)[idx], jnp.float64)
        res = radau_solve(
            model, f64(y0), 0.0, SPAN, jnp.asarray(np.asarray(qt), jnp.float64),
            {k: f64(v) for k, v in params.items()},
            ForcingSet(data=forc.data[:, jnp.asarray(idx)], meta=forc.meta),
            config=cfg)
        check(not np.asarray(res.failed)[:len(rows)].any(), "f64 reference failed lanes")
        return np.asarray(res.y_final)[:len(rows)], np.asarray(res.dense)[:len(rows)]


def err_vs_truth(rows, truth, result):
    """Largest error (tolerance units) of ``result`` on ``rows`` against the
    f64 truth, over the lanes it finished (a lane it flagged is NaN)."""
    y = np.asarray(result.y_final)[rows]
    d = np.asarray(result.dense)[rows]
    done = np.isfinite(y).all(axis=1)
    if not done.any():
        return 0.0
    return float(max(lane_errors(y[done], truth[0][done]).max(),
                     lane_errors(d[done], truth[1][done]).max()))


def steady(forc, records=None):
    """The same forcing with each record in ``records`` (default: all) held
    at its first sample.  Kernel-vs-reference compares at the tight bound
    use it, as tests/test_pallas_kernel.py does: two valid step sequences
    that cross a forcing jump at different points (the ZOH gather snaps to
    the next sample within 5e-4*dt of it) differ there by far more than the
    solver tolerance on fast-draining lanes."""
    import jax.numpy as jnp

    from tiger_tpu.forcing import ForcingSet

    m = forc.meta
    keep = range(len(m.offsets)) if records is None else records
    rows = np.concatenate([
        np.full(n, off) if k in keep else np.arange(off, off + n)
        for k, (off, n) in enumerate(zip(m.offsets, m.n_steps))
    ])
    return ForcingSet(data=forc.data[jnp.asarray(rows)], meta=m)


def solve_checked(label, model, y0, params, forc, qt, cfg):
    """solve() twice (compile, then timed); the stiff phase must stay on the
    card and every lane must finish."""
    from tiger_tpu.solver.api import solve

    run = lambda: solve(model, y0, 0.0, SPAN, qt, params, forc, config=cfg)
    res, first_s = timed(run)
    res, wall = timed(run)
    n_att = int(np.asarray(res.rk_stats.n_attempts).sum())
    if res.radau_stats is not None:
        n_att += int(np.asarray(res.radau_stats.n_attempts).sum())
    n_failed = int(np.asarray(res.failed).sum())
    fields = dict(
        wall_s=wall, compile_s=max(first_s - wall, 0.0),
        system_steps_per_s=n_att / wall, n_stiff=res.n_stiff,
        n_failed=n_failed, host_lanes=res.n_host,
    )
    check(res.n_host == 0, f"{label}: {res.n_host} lanes reached the host pipeline")
    check(n_failed == 0, f"{label}: {n_failed} lanes failed")
    check(np.isfinite(np.asarray(res.y_final)).all(), f"{label}: non-finite states")
    return res, fields


def phase_two_phase(s_count=1_048_576, stiff_frac=0.001):
    """solve() at full width; RK45 kernel vs vmap RK45 at the same width
    (steady forcing), and the f64 truth on the lanes the two disagree on
    most and on the lanes whose flags differ.  Returns the flagged working
    set for the Radau phase."""
    import jax.numpy as jnp

    from __graft_entry__ import _scenario
    from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
    from tiger_tpu.models import Model204
    from tiger_tpu.solver import SolverConfig, rk45_solve
    from tiger_tpu.solver.api import solve
    from tiger_tpu.solver.controller import initial_step

    model, cfg, qt = Model204(), SolverConfig(**CFG_KW), hourly()
    y0, params, forc = _scenario(s_count, jnp.float32, days=2.0, stiff_frac=stiff_frac)
    res, fields = solve_checked("two_phase_1m", model, y0, params, forc, qt, cfg)
    check(res.n_stiff > 256, f"only {res.n_stiff} stiff lanes: overflow rung unexercised")
    forc = steady(forc)
    h0 = initial_step(model, y0, 0.0, params, forc, cfg)
    ker, ker_s = timed(lambda: rk45_solve_pallas(
        model, y0, 0.0, SPAN, qt, params, forc, h0=h0, config=cfg))
    ref, ref_s = timed(lambda: rk45_solve(
        model, y0, 0.0, SPAN, qt, params, forc, h0=h0, config=cfg))
    cmp = compare_rk(ker, ref)
    # Same shapes as the timed solve(): no new compile.
    res_st = solve(model, y0, 0.0, SPAN, qt, params, forc, config=cfg)
    rows = np.concatenate([cmp.worst, cmp.differ])
    truth = f64_truth(model, rows, y0, params, forc, qt, cfg)
    w, d = slice(0, len(cmp.worst)), slice(len(cmp.worst), len(rows))
    f64 = dict(
        worst_kernel_vs_f64=err_vs_truth(cmp.worst, (truth[0][w], truth[1][w]), ker),
        worst_vmap_vs_f64=err_vs_truth(cmp.worst, (truth[0][w], truth[1][w]), ref),
        flag_lanes_solve_vs_f64=err_vs_truth(cmp.differ, (truth[0][d], truth[1][d]), res_st),
    )
    emit("two_phase_1m", systems=s_count, **fields, peak_bytes=peak_bytes(),
         rk45_kernel_first_s=ker_s, rk45_vmap_first_s=ref_s,
         flags_differ=len(cmp.differ), **cmp.summary, **f64)
    check(len(cmp.differ) <= FLAG_FRAC * s_count,
          f"stiff flags differ on {len(cmp.differ)} of {s_count} lanes")
    check(cmp.summary["err_max"] <= 1.0, f"rk45 kernel vs vmap past tolerance {cmp.summary}")
    check(max(f64.values()) <= 1.0, f"f32 answers vs the f64 truth past tolerance {f64}")
    stiff = np.nonzero(np.asarray(ker.stiff))[0]
    return model, cfg, qt, y0, params, forc, ker.h0, stiff


def phase_radau(model, cfg, qt, y0, params, forc, h0, rows):
    """Radau kernel vs vmapped radau_solve on the flagged subset (f32)."""
    import jax.numpy as jnp

    from tiger_tpu.forcing import ForcingSet
    from tiger_tpu.kernels.radau_pallas import radau_solve_pallas
    from tiger_tpu.solver import radau_solve

    idx = jnp.asarray(rows)
    y_s, h_s = y0[idx], jnp.asarray(h0)[idx]
    p_s = {k: v[idx] for k, v in params.items()}
    f_s = ForcingSet(data=forc.data[:, idx], meta=forc.meta)
    args = (model, y_s, 0.0, SPAN, qt, p_s, f_s)
    ker, ker_first = timed(lambda: radau_solve_pallas(*args, h0=h_s, config=cfg))
    ker, ker_s = timed(lambda: radau_solve_pallas(*args, h0=h_s, config=cfg))
    ref, ref_s = timed(lambda: radau_solve(*args, h0=h_s, config=cfg))
    check(not np.asarray(ker.failed).any(), "radau kernel failed lanes")
    check(not np.asarray(ref.failed).any(), "vmap radau failed lanes")
    s = err_summary(np.concatenate([
        lane_errors(ker.y_final, ref.y_final), lane_errors(ker.dense, ref.dense),
    ], axis=1))
    check(s["err_max"] <= 1.0, f"radau kernel vs vmap past tolerance {s}")
    att = np.asarray(ker.stats.n_attempts)
    emit("radau_rung", lanes=len(rows), n_failed=0, kernel_s=ker_s,
         compile_s=max(ker_first - ker_s, 0.0), vmap_first_s=ref_s,
         system_steps_per_s=float(att.sum()) / ker_s, max_lane_attempts=int(att.max()),
         peak_bytes=peak_bytes(), **s)


def phase_f64(s_count=131_072):
    """f32 kernel vs the f64 vmap path on the card: on steady forcing at the
    tight bound, and on hourly-varying rain (the per-lane forcing index) at
    the time-varying bound.

    Flags are compared across precisions here, so lanes near a threshold
    flip with the precision itself; each lane whose flags differ must get
    the f64 answer from solve() (the two-phase path a user runs)."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _scenario
    from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
    from tiger_tpu.models import Model204
    from tiger_tpu.solver import SolverConfig, rk45_solve
    from tiger_tpu.solver.api import solve

    model, cfg, qt = Model204(), SolverConfig(**CFG_KW), hourly()
    y0, params, forc_real = _scenario(s_count, jnp.float32, days=2.0)
    h0 = jnp.full((s_count,), 1e-3, jnp.float32)
    f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)
    fields, out = {}, {}
    for name, forc in (("steady", steady(forc_real)), ("rain", steady(forc_real, (1,)))):
        ker, ker_s = timed(lambda: rk45_solve_pallas(
            model, y0, 0.0, SPAN, qt, params, forc, h0=h0, config=cfg))
        n_failed = int(np.asarray(ker.failed).sum())
        check(n_failed == 0, f"rk45 kernel: {n_failed} lanes hit max_steps")
        with jax.enable_x64(True):
            ref, ref_s = timed(lambda: rk45_solve(
                model, f64(y0), 0.0, SPAN, f64(qt), {k: f64(v) for k, v in params.items()},
                forc, h0=f64(h0), config=cfg))
        out[name] = (forc, compare_rk(ker, ref), compare_rk(ker, ref, RTOL_VARYING))
        fields[f"{name}_kernel_first_s"] = ker_s
        fields[f"{name}_f64_vmap_first_s"] = ref_s
        fields[f"{name}_n_stiff"] = int(np.asarray(ker.stiff).sum())
    forc, tight, _ = out["steady"]
    res_st = solve(model, y0, 0.0, SPAN, qt, params, forc, config=cfg)
    truth = f64_truth(model, tight.differ, y0, params, forc, qt, cfg)
    flag_err = err_vs_truth(tight.differ, truth, res_st)
    _, rain, rain_loose = out["rain"]
    emit("rk45_vs_f64", systems=s_count, **fields,
         flags_differ=len(tight.differ), flag_lanes_solve_vs_f64=flag_err,
         peak_bytes=peak_bytes(), **tight.summary,
         rain_flags_differ=len(rain.differ), rain_lanes_within_tight=rain.within,
         **{f"rain_{k}": v for k, v in rain.summary.items()},
         **{f"rain_loose_{k}": v for k, v in rain_loose.summary.items()})
    for name, cmp in (("steady", tight), ("rain", rain)):
        check(len(cmp.differ) <= FLAG_FRAC_F64 * s_count,
              f"{name}: stiff flags differ on {len(cmp.differ)} of {s_count} lanes")
    check(tight.summary["err_max"] <= 1.0, f"steady: past tolerance {tight.summary}")
    check(flag_err <= 1.0, f"solve() vs the f64 truth on flag lanes: {flag_err}")
    check(rain_loose.summary["err_max"] <= 1.0, f"rain: past tolerance {rain_loose.summary}")
    # Varying rain at the tight bound: a snapped sample boundary moves a few
    # lanes past it, a forcing index off by one sample would move most.
    check(rain.within >= 0.999, f"rain: only {rain.within:.6f} of lanes within the tight bound")


def phase_model200(s_count=131_072):
    """Model 200 (inverse trig in-kernel): kernel vs vmap, and solve()."""
    import jax.numpy as jnp

    from __graft_entry__ import _scenario
    from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
    from tiger_tpu.models import Model200
    from tiger_tpu.solver import SolverConfig, rk45_solve
    from tiger_tpu.solver.api import solve

    model, cfg, qt = Model200(), SolverConfig(**CFG_KW), hourly()
    y0, params, forc = _scenario(s_count, jnp.float32, days=2.0)
    _, fields = solve_checked("model200", model, y0, params, forc, qt, cfg)
    forc = steady(forc)
    h0 = jnp.full((s_count,), 1e-3, jnp.float32)
    ker = rk45_solve_pallas(model, y0, 0.0, SPAN, qt, params, forc, h0=h0, config=cfg)
    ref = rk45_solve(model, y0, 0.0, SPAN, qt, params, forc, h0=h0, config=cfg)
    cmp = compare_rk(ker, ref)
    res_st = solve(model, y0, 0.0, SPAN, qt, params, forc, config=cfg)
    truth = f64_truth(model, cmp.differ, y0, params, forc, qt, cfg)
    flag_err = err_vs_truth(cmp.differ, truth, res_st)
    emit("model200", systems=s_count, **fields, flags_differ=len(cmp.differ),
         flag_lanes_solve_vs_f64=flag_err, peak_bytes=peak_bytes(), **cmp.summary)
    check(len(cmp.differ) <= FLAG_FRAC * s_count,
          f"stiff flags differ on {len(cmp.differ)} of {s_count} lanes")
    check(cmp.summary["err_max"] <= 1.0, f"model 200 kernel vs vmap past tolerance {cmp.summary}")
    check(flag_err <= 1.0, f"solve() vs the f64 truth on flag lanes: {flag_err}")


def write_basin(base, n_links=41_274, days=2, seed=0):
    """Reference-sized basin on disk: params CSV in the reference schema, a
    deep chain-of-subbasins topology, ERA5-Land-shaped hourly pr and daily
    t2m grids (classic NetCDF) and the stream -> grid lookup CSV."""
    from tiger_tpu.io.netcdf import write_grid_forcing

    rng = np.random.default_rng(seed)
    n_lat, n_lon = 64, 128
    hours = {"units": "hours since 2019-01-01 00:00:00"}
    write_grid_forcing(os.path.join(base, "pr.nc"), "pr",
                       rng.uniform(0, 0.0015, (24 * days, n_lat, n_lon)),
                       time_attrs=hours, classic=True)
    write_grid_forcing(os.path.join(base, "t2m.nc"), "t2m",
                       rng.uniform(2.0, 10.0, (days, n_lat, n_lon)),
                       time_attrs=hours, classic=True)
    streams = np.arange(1, n_links + 1, dtype=np.int64)
    # ~100 independent chains of ~411 links: the reference basin's depth.
    nxt = np.where(streams % 411 == 0, -1, streams + 1)
    nxt[-1] = -1
    cell = rng.integers(0, n_lat * n_lon, n_links)
    np.savetxt(os.path.join(base, "lookup.csv"),
               np.column_stack([streams, cell // n_lon, cell % n_lon]),
               fmt="%d", delimiter=",", header="stream,lat_index,lon_index",
               comments="")
    cols = {
        "stream": streams, "next_stream": nxt,
        "drainage_area_km2": rng.uniform(5, 20, n_links),
        "length_km": rng.uniform(0.5, 2.0, n_links),
        "area_sqkm": np.zeros(n_links), "centroid_lon": np.zeros(n_links),
        "centroid_lat": np.full(n_links, 41.5),
        "hu": rng.uniform(0.3, 0.7, n_links), "i2": rng.uniform(3, 8, n_links),
        "i3": rng.uniform(1, 4, n_links), "sw": np.full(n_links, 0.2),
        "ss": np.full(n_links, 0.8), "n": rng.uniform(0.02, 0.05, n_links),
        "slope": rng.uniform(0.01, 0.1, n_links), "res_ss": np.full(n_links, 2.0),
        "res_gw": np.full(n_links, 5.0), "melt": np.full(n_links, 1e-4),
        "t_thres": np.zeros(n_links),
    }
    np.savetxt(os.path.join(base, "params.csv"), np.column_stack(list(cols.values())),
               fmt=["%d", "%d"] + ["%.6g"] * (len(cols) - 2), delimiter=",",
               header=",".join(cols), comments="")


def cli_config(base, out, days, initial="{mode: cold}"):
    path = os.path.join(base, f"config_{out}.yaml")
    with open(path, "w") as f:
        f.write(f"""
model: {{uid: 204, name: Model204}}
time: {{start: "2019-01-01T00:00:00", end: "2019-01-0{1 + days}T00:00:00", chunk_days: 1}}
initial: {initial}
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
  path: "{base}/{out}"
  prefix: basin
  format: csv
  routed_discharge: true
  checkpoint_interval: "1d"
solver:
  method: RK45
  tolerances: {{rtol: 1.0e-5, atol: 1.0e-8}}
  precision: f32
""")
    return path


def phase_cli(n_links=41_274):
    """The CLI on the reference basin, straight and resumed."""
    import contextlib
    import io

    from tiger_tpu import run as cli
    from tiger_tpu.checkpoint import load_state

    base = tempfile.mkdtemp(prefix="tiger_smoke_cli_")
    try:
        write_basin(base, n_links)

        def main(cfg_path):
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--config", cfg_path])
            check(rc == 0, f"CLI exited {rc}")
            return json.loads(buf.getvalue().strip().splitlines()[-1]), \
                time.perf_counter() - t

        straight, first_s = main(cli_config(base, "straight", 2))
        # The first half alone ends on the window boundary, whose state file
        # is the checkpoint the straight run passed through at t=1440.
        half, _ = main(cli_config(base, "resumed", 1))
        state = os.path.join(base, "resumed", "state_basin_rank_0.nc")
        _, _, t_ck = load_state(state)
        check(t_ck == 1440.0, f"checkpoint at t={t_ck}, expected 1440")
        resumed, _ = main(cli_config(
            base, "resumed", 2, f"{{mode: hot, file: \"{state}\", resume: true}}"))
        straight2, wall = main(cli_config(base, "straight", 2))
        y_a, _, t_a = load_state(os.path.join(base, "straight", "state_basin_rank_0.nc"))
        y_b, _, t_b = load_state(state)
        check(t_a == t_b == SPAN, f"final times {t_a}, {t_b}")
        check(np.array_equal(y_a, y_b), "resumed final state differs from the straight run")
        for name in ("dense_basin_rank_0.csv", "discharge_basin_rank_0.csv"):
            with open(os.path.join(base, "straight", name)) as fa, \
                    open(os.path.join(base, "resumed", name)) as fb:
                check(fa.read() == fb.read(), f"resumed {name} differs")
        for s in (straight, half, resumed, straight2):
            check(s["n_failed"] == 0, f"CLI run failed {s['n_failed']} lanes")
            check(s["n_host"] == 0, f"CLI run left {s['n_host']} lanes to the host")
        emit("cli", links=n_links, wall_s=wall, compile_s=max(first_s - wall, 0.0),
             system_steps_per_s=float(straight2.get("system_steps_per_s", 0.0)),
             n_stiff=straight2["n_stiff"], n_failed=straight2["n_failed"],
             host_lanes=straight2["n_host"], windows=straight2["n_windows"],
             resume_bitwise=True,
             peak_bytes=peak_bytes())
    finally:
        shutil.rmtree(base, ignore_errors=True)


def phase_four_cards(per_card=262_144):
    """solve() over a 4-device mesh vs one card; chunked + ring-routed +
    resumed over the mesh vs one card (__graft_entry__.dryrun_multichip's
    checks at full width)."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _scenario
    from tiger_tpu import routing
    from tiger_tpu.chunked import solve_chunked
    from tiger_tpu.dist import systems_mesh
    from tiger_tpu.forcing import ForcingSet
    from tiger_tpu.models import Model204
    from tiger_tpu.solver import SolverConfig
    from tiger_tpu.solver.api import solve

    devs = jax.devices()
    check(len(devs) >= 4, f"need 4 GPUs, have {len(devs)}")
    mesh = systems_mesh(devs[:4])
    s_count = 4 * per_card
    model, cfg, qt = Model204(), SolverConfig(**CFG_KW), hourly()
    y0, params, forc = _scenario(s_count, jnp.float32, days=2.0, stiff_frac=0.001)
    run_sh = lambda: solve(model, y0, 0.0, SPAN, qt, params, forc, config=cfg, mesh=mesh)
    res_sh, first_s = timed(run_sh)
    res_sh, wall_sh = timed(run_sh)
    res_1, first_1 = timed(lambda: solve(model, y0, 0.0, SPAN, qt, params, forc, config=cfg))
    st_sh, st_1 = np.asarray(res_sh.stiff), np.asarray(res_1.stiff)
    check(st_sh.any(), "no stiff lane in the sharded run")
    check((st_sh == st_1).all(), "stiff flags differ sharded vs single card")
    for r in (res_sh, res_1):
        check(not np.asarray(r.failed).any() and r.n_host == 0,
              "failed lanes or host-pipeline lanes")
    y_sh, y_1 = np.asarray(res_sh.y_final), np.asarray(res_1.y_final)
    bound = 1e-5 * float(np.max(np.abs(y_1))) + 1e-7
    d_y = float(np.max(np.abs(y_sh - y_1)))
    d_d = float(np.nanmax(np.abs(np.asarray(res_sh.dense) - np.asarray(res_1.dense))))
    check(d_y <= bound and d_d <= bound, f"sharded vs single: {d_y}, {d_d} > {bound}")
    rung_dev = jax.local_devices()[0]
    emit("four_card_solve", systems=s_count, wall_s=wall_sh, compile_s=max(first_s - wall_sh, 0.0),
         single_card_first_s=first_1, n_stiff=res_sh.n_stiff, max_y_diff=d_y,
         max_dense_diff=d_d, bound=bound, stiff_rung_device=str(rung_dev),
         peak_bytes=",".join(str(peak_bytes(d)) for d in devs[:4]))

    # Chunked + ring-routed + resume, over the mesh and on one card.
    stream = np.arange(1, s_count + 1)
    nxt = np.where(stream % 411 == 0, -1, stream + 1)
    nxt[-1] = -1
    topo = routing.build_topology(stream, nxt)
    data = np.asarray(forc.data)
    n_pr = forc.meta.n_steps[0]

    def load_window(w_start, w_end):
        k0, k1 = int(w_start // 60), int(np.ceil(w_end / 60.0))
        d0, d1 = int(w_start // 1440), int(np.ceil(w_end / 1440.0))
        return ForcingSet.from_series(
            [data[k0:k1], data[n_pr + d0:n_pr + d1]], [60.0, 1440.0])

    # The sharded run routes each window through the ppermute ring: every
    # card accumulates its own rows and only cross-card outboxes travel.
    # The single-card run routes the whole basin with routing.routed_discharge.
    ring_fn, plan = ring_routed(topo, params, mesh)
    ck = {}
    kw = dict(query_interval=60.0, params=params, config=cfg)
    (r_sh, q_sh), first_c = timed(lambda: solve_chunked(
        model, y0, 0.0, SPAN, 1440.0, load_window, mesh=mesh, routed_fn=ring_fn,
        state_sink=lambda t, y: ck.__setitem__(float(t), np.asarray(y)), **kw))
    r_1, q_1 = solve_chunked(model, y0, 0.0, SPAN, 1440.0, load_window, topology=topo, **kw)
    yc_sh, yc_1 = np.asarray(r_sh.y_final), np.asarray(r_1.y_final)
    bound_c = 1e-5 * float(np.max(np.abs(yc_1))) + 1e-7
    d_c = float(np.max(np.abs(yc_sh - yc_1)))
    q_sh, q_1 = np.asarray(q_sh), np.asarray(q_1)
    check(q_sh.shape == q_1.shape == (s_count, len(qt)), f"routed shapes {q_sh.shape}, {q_1.shape}")
    bound_q = 1e-5 * float(np.max(np.abs(q_1))) + 1e-7
    d_q = float(np.max(np.abs(q_sh - q_1)))
    check(d_c <= bound_c, f"chunked sharded vs single: {d_c} > {bound_c}")
    check(d_q <= bound_q, f"ring-routed vs single-card routed: {d_q} > {bound_q}")
    check(1440.0 in ck, f"no checkpoint at the window boundary: {sorted(ck)}")
    (r_res, q_res), _ = timed(lambda: solve_chunked(
        model, jnp.asarray(ck[1440.0]), 1440.0, SPAN, 1440.0, load_window, mesh=mesh,
        routed_fn=ring_fn, **kw))
    check(np.array_equal(np.asarray(r_res.y_final), yc_sh),
          "resume did not reproduce the straight sharded run bitwise")
    q_res = np.asarray(q_res)
    check(np.array_equal(q_res, q_sh[:, -q_res.shape[1]:]),
          "resumed routed window differs from the straight run's")
    for r in (r_sh, r_1, r_res):
        check(not np.asarray(r.failed).any() and r.n_host == 0,
              "chunked run: failed lanes or host-pipeline lanes")
    emit("four_card_chunked", systems=s_count, first_s=first_c, windows=2,
         max_y_diff=d_c, bound=bound_c, ring_rounds=plan.n_rounds,
         ring_bytes_per_window=routing.ring_bytes_per_exchange(plan, 24),
         max_routed_diff=d_q, routed_bound=bound_q, resume_bitwise=True,
         n_stiff=r_sh.n_stiff, host_lanes=r_sh.n_host,
         peak_bytes=",".join(str(peak_bytes(d)) for d in devs[:4]))


def ring_routed(topo, params, mesh):
    """(routed_fn for solve_chunked, plan): each window's routed discharge
    through the sharded-topology ppermute ring (routing.exchange_sharded)
    over ``mesh``, one contiguous block of links per device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from tiger_tpu import routing

    n = mesh.devices.size
    plan = routing.plan_sharded_topology(topo, n)
    s_count = len(topo.next_idx)
    check(plan.block * n == s_count, f"{s_count} links do not split evenly over {n} devices")
    sharding = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))

    @jax.jit
    def runoff(dense):  # [S, Q, N] -> [S, Q]
        return jax.vmap(
            lambda y: routing.link_runoff_204(jnp.nan_to_num(y), params),
            in_axes=1, out_axes=1)(dense)

    def routed(dense):
        q = runoff(dense)
        q_g = jax.device_put(q.reshape(n, plan.block, q.shape[1]), sharding)
        return routing.exchange_sharded(q_g, plan, mesh).reshape(s_count, -1)

    return routed, plan


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, default=1, choices=[1, 4],
                   help="4: run only the four-GPU sharded phase")
    args = p.parse_args(argv)

    # The card's name and power limit, from a child that stays off JAX.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ) if shutil.which("nvidia-smi") else None
    print(smi.stdout.strip() if smi else "nvidia-smi: absent", flush=True)

    failed = []
    if smi is not None and args.chips == 1:
        # The card-only tests, in a child that ends before this process
        # opens the card (one JAX process per card at a time).
        t = time.perf_counter()
        here = os.path.dirname(os.path.abspath(__file__))
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p", "no:cacheprovider",
             os.path.join(here, "tests", "test_gpu.py")],
            capture_output=True, text=True, cwd=here,
            env={**os.environ, "JAX_PLATFORMS": "cuda"},
        )
        summary = (tests.stdout.strip().splitlines() or ["no output"])[-1]
        emit("gpu_tests", rc=tests.returncode, wall_s=time.perf_counter() - t,
             summary=summary.replace(" ", "_"))
        if tests.returncode != 0:
            print(tests.stdout[-4000:] + tests.stderr[-4000:], file=sys.stderr)
            failed.append("gpu_tests")

    import jax

    from tiger_tpu.profiling import enable_compile_cache

    devs = jax.devices()
    dev = devs[0]
    print(f"jax {jax.__version__} devices={devs} kind={dev.device_kind!r}", flush=True)
    if dev.platform != "gpu":
        print(f"no GPU: JAX platform is {dev.platform!r}", file=sys.stderr)
        return 2
    for mod in ("h5py", "yaml"):
        try:
            __import__(mod)
            print(f"{mod}: importable")
        except ImportError:
            print(f"{mod}: missing")
    print("compile cache:", enable_compile_cache(), flush=True)

    if args.chips == 4:
        phases = [("four_cards", phase_four_cards)]
    else:
        state = {}

        def two_phase():
            state["rung"] = phase_two_phase()

        def radau():
            check("rung" in state, "two_phase_1m did not run")
            phase_radau(*state["rung"])

        phases = [("two_phase_1m", two_phase), ("radau_rung", radau),
                  ("rk45_vs_f64", phase_f64), ("model200", phase_model200),
                  ("cli", phase_cli)]
    for name, fn in phases:
        t = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — reported, and the run fails
            traceback.print_exc()
            failed.append(name)
            print(f"phase={name} FAILED after {time.perf_counter() - t:.1f}s", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
