"""Benchmark: hillslope system-steps per second on one GPU.

Runs the flagship Model-204 scenario (synthetic ERA5-shaped forcings, 2-day
integration, hourly dense queries — the reference's artifact configuration,
main.cpp:610-657; float32 at rtol 1e-5 / atol 1e-8) and prints the device,
then ONE JSON line with the median wall of 5 timed runs after a warm-up (compile time is reported separately as set-up).

Modes:
  default          the two-phase solve(): RK45 kernel, stiff flags, Radau
                   rung on the device, merge;
  --rk-only        the RK45 phase alone: the fused kernel, or with
                   ``--backend xla`` the vmap path it replaces;
  --solver radau   the Radau phase alone over genuinely stiff lanes (the
                   scenario with ``--stiff-frac 1``): the fused kernel, or
                   with ``--backend xla`` the vmapped solver/radau.py.

Exits non-zero when JAX finds no GPU, unless ``--cpu`` is given; CPU runs
use the Pallas interpreter and are labelled ``cpu``.  Single process.

Usage: python bench.py [--systems 131072] [--rk-only | --solver radau]
                       [--backend auto|pallas|xla] [--model 204|200]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time

import numpy as np


def gpu_name_and_power() -> str:
    """``name, power.limit`` of the card, from a child that stays off JAX."""
    if not shutil.which("nvidia-smi"):
        return "nvidia-smi absent"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--systems", type=int, default=131_072)
    p.add_argument("--days", type=float, default=2.0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (kernels in the Pallas interpreter)")
    p.add_argument("--backend", default="auto", choices=["auto", "pallas", "xla"],
                   help="auto/pallas = fused GPU kernels; xla = vmap reference path")
    p.add_argument("--solver", default="rk45", choices=["rk45", "radau"])
    p.add_argument("--rk-only", action="store_true",
                   help="time the RK45 phase alone (no stiff second phase)")
    p.add_argument("--model", type=int, default=204, choices=[204, 200])
    p.add_argument(
        "--stiff-frac", type=float, default=None,
        help="fraction of systems made genuinely stiff (near-zero Hu); default "
        "0.001 for the two-phase solve, 1 for --solver radau, 0 for --rk-only",
    )
    args = p.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu" and not args.cpu:
        print(f"no GPU (JAX platform {dev.platform!r}); pass --cpu to run on the CPU",
              file=sys.stderr)
        return 2
    gpu = gpu_name_and_power() if not args.cpu else "none"
    print(f"platform={dev.platform} device_kind={dev.device_kind!r} "
          f"devices={len(devs)} gpu={gpu!r}", flush=True)

    from tiger_tpu.profiling import enable_compile_cache

    enable_compile_cache()

    from __graft_entry__ import _scenario
    from tiger_tpu.kernels.radau_pallas import radau_solve_pallas
    from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
    from tiger_tpu.models import Model200, Model204
    from tiger_tpu.solver import SolverConfig, radau_solve, rk45_solve
    from tiger_tpu.solver.api import solve

    kernels = args.backend != "xla"
    interpret = bool(args.cpu and kernels)
    two_phase = args.solver == "rk45" and not args.rk_only
    stiff_frac = args.stiff_frac
    if stiff_frac is None:
        stiff_frac = 0.001 if two_phase else float(args.solver == "radau")

    s_count = args.systems
    tf = args.days * 1440.0
    model = Model204() if args.model == 204 else Model200()
    config = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    y0, params, forcings = _scenario(
        s_count, jnp.float32, days=args.days, stiff_frac=stiff_frac
    )
    qt = jnp.arange(0.0, tf + 1e-9, 60.0, dtype=jnp.float32)
    h0 = jnp.full((s_count,), 1e-3, jnp.float32)

    if two_phase:
        backend = "pallas" if args.backend == "auto" and args.cpu else args.backend
        run = lambda y: solve(model, y, 0.0, tf, qt, params, forcings,
                              config=config, backend=backend, interpret=interpret)
        label = f"two-phase-{'kernels' if kernels else 'xla'}"
    else:
        if args.solver == "radau":
            fn = radau_solve_pallas if kernels else radau_solve
        else:
            fn = rk45_solve_pallas if kernels else rk45_solve
        kw = {"interpret": True} if interpret else {}
        run = lambda y: fn(model, y, 0.0, tf, qt, params, forcings, h0=h0,
                           config=config, **kw)
        label = f"{args.solver}-{'kernel' if kernels else 'vmap'}"

    def once(eps: float):
        # Perturb the input per call so each timed call is real device work.
        t = time.perf_counter()
        res = run(y0 + eps)
        jax.block_until_ready(res.y_final)
        return res, time.perf_counter() - t

    res, first = once(0.0)
    walls = [once(i * 1e-7)[1] for i in range(1, 6)]
    wall = float(np.median(walls))

    stats = res.rk_stats if two_phase else res.stats
    n_attempts = int(np.asarray(stats.n_attempts).sum())
    extra = {}
    if two_phase:
        extra.update(n_stiff=res.n_stiff, host_lanes=res.n_host)
        if res.radau_stats is not None:
            n_radau = int(np.asarray(res.radau_stats.n_attempts).sum())
            extra["radau_attempts"] = n_radau
            n_attempts += n_radau
    elif args.solver == "rk45":
        extra["n_stiff"] = int(np.asarray(res.stiff).sum())
    extra["n_failed"] = int(np.asarray(res.failed).sum())
    if getattr(stats, "n_newton", None) is not None:
        extra["newton_sweeps_per_attempt"] = round(
            int(np.asarray(stats.n_newton).sum()) / max(n_attempts, 1), 3
        )
        extra["max_lane_attempts"] = int(np.asarray(stats.n_attempts).max())

    print(json.dumps({
        "metric": f"model{args.model}_{label}_system_steps_per_s",
        "value": n_attempts / wall,
        "unit": "system-steps/s",
        "systems": s_count,
        "steps_total": n_attempts,
        "wall_s": wall,
        "wall_s_min": float(np.min(walls)),
        "wall_s_max": float(np.max(walls)),
        "compile_s": max(first - wall, 0.0),
        "platform": "cpu" if args.cpu else dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(devs),
        "gpu": gpu,
        **extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
