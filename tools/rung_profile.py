"""Stiff-rung micro-profiler: time the fused Radau kernel on the headline
bench's own stiff subset, isolating each suspected latency contributor.

The two-phase headline's Radau rung runs ~131 genuinely-stiff lanes padded
to 256 — tiny parallelism, so the kernel is latency-bound on its per-
while-iteration dependent chain (FD Jacobian -> 15x15 LU -> Newton sweeps
-> dense fill); this tool breaks the iteration down by ablation so
optimization effort lands where the time is:

    python tools/rung_profile.py                 # full configuration
    python tools/rung_profile.py --no-queries    # drop the dense fill
    python tools/rung_profile.py --no-forcings   # drop the ZOH gather

Prints one JSON line per invocation.  Uses the exact lanes bench.py's
scenario marks stiff (reference anchor: the subset compaction mirrors
rk45_api.hpp:190-203).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--systems", type=int, default=131_072)
    p.add_argument("--stiff-frac", type=float, default=0.001)
    p.add_argument("--days", type=float, default=2.0)
    p.add_argument("--pad", type=int, default=256, help="bucket size (api.solve floors at 256)")
    p.add_argument("--no-queries", action="store_true")
    p.add_argument("--no-forcings", action="store_true")
    p.add_argument("--predictor", action="store_true")
    p.add_argument(
        "--error-mode", default="embedded3",
        choices=["embedded3", "radau5", "reference"],
        help="SolverConfig.radau_error_mode for the rung",
    )
    p.add_argument(
        "--factor-reuse", action="store_true",
        help="SolverConfig.radau_factor_reuse (opt-in; re-test it here on "
        "new hardware/models)",
    )
    p.add_argument("--cpu", action="store_true", help="interpreter smoke run")
    args = p.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from tiger_tpu.profiling import enable_compile_cache

    enable_compile_cache()

    from __graft_entry__ import _scenario
    from tiger_tpu.forcing import ForcingSet
    from tiger_tpu.kernels.radau_pallas import radau_solve_pallas
    from tiger_tpu.models import Model204
    from tiger_tpu.solver.config import SolverConfig

    s_count = args.systems
    tf = args.days * 1440.0
    y0, params, forcings = _scenario(
        s_count, jnp.float32, days=args.days, stiff_frac=args.stiff_frac
    )
    n_stiff = int(round(s_count * args.stiff_frac))
    rows = np.linspace(0, s_count - 1, n_stiff).astype(np.int64)  # = _scenario's
    pad = np.concatenate([rows, np.full(max(args.pad - n_stiff, 0), rows[0])])

    y0_sub = jnp.asarray(np.asarray(y0)[pad])
    params_sub = {k: jnp.asarray(np.asarray(v)[pad]) for k, v in params.items()}
    forc = None
    if not args.no_forcings:
        forc = ForcingSet(
            data=jnp.asarray(np.asarray(forcings.data)[:, pad]), meta=forcings.meta
        )
    qt = None
    if not args.no_queries:
        qt = jnp.arange(0.0, tf + 1e-9, 60.0, dtype=jnp.float32)
    h0 = jnp.full((len(pad),), 1e-3, jnp.float32)
    cfg = SolverConfig(
        rtol=1e-5, atol=1e-8, max_steps=100_000, radau_predictor=args.predictor,
        radau_error_mode=args.error_mode, radau_factor_reuse=args.factor_reuse,
    )

    def run():
        res = radau_solve_pallas(
            Model204(), y0_sub, 0.0, tf, qt, params_sub, forc,
            h0=h0, config=cfg, interpret=args.cpu,
        )
        jax.block_until_ready(res.y_final)
        return res

    res = run()  # compile
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    att = np.asarray(res.stats.n_attempts)[:n_stiff]
    swp = np.asarray(res.stats.n_newton)[:n_stiff]
    n_att = int(att.sum())
    print(
        json.dumps(
            {
                "metric": "radau_rung_attempts_per_s",
                "value": n_att / wall,
                "unit": "attempts/s",
                "wall_s": wall,
                "wall_s_min": float(np.min(walls)),
                "wall_s_max": float(np.max(walls)),
                "n_lanes": n_stiff,
                "pad": len(pad),
                "attempts_total": n_att,
                "attempts_per_lane_max": int(att.max()),
                "iterations_est": int(att.max()),
                "us_per_iteration": 1e6 * wall / max(int(att.max()), 1),
                "sweeps_per_attempt": round(float(swp.sum()) / max(n_att, 1), 3),
                "n_failed": int(np.asarray(res.failed)[:n_stiff].sum()),
                "factorizations_per_attempt": (
                    None
                    if res.stats.n_fact is None
                    else round(
                        float(np.asarray(res.stats.n_fact)[:n_stiff].sum())
                        / max(n_att, 1),
                        3,
                    )
                ),
                "queries": 0 if qt is None else int(qt.shape[0]),
                "forcings": not args.no_forcings,
                "predictor": args.predictor,
                "error_mode": args.error_mode,
                "backend": jax.devices()[0].platform,
            }
        )
    )


if __name__ == "__main__":
    main()
