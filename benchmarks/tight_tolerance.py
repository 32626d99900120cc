"""Tight-tolerance (reference-regime) benchmark: compensated f32 at scale.

The reference produces its artifacts in double precision at rtol 1e-6 /
atol 1e-9 (src/main.cpp:621; all-double kernel buffers,
src/solver/rk45_kernel.cu:17-30).  This path serves them from the fused
f32 kernel with compensated (Kahan) state accumulation
(SolverConfig.compensated / solver.precision 'f32c'): the commit carries the
low word that plain f32 rounds away, keeping thousand-step trajectory
accumulation at f64-equivalent level; what remains vs f64 is the METHOD's
kink-dominated global error, which is the same in both precisions
(tests/test_compensated.py pins the smooth-regime claim).

Measures on the 2-day Model-204 scenario at the reference tolerances:
  - steps/s of the compensated kernel over --systems lanes (GPU);
  - max |y_f32c - y_f64| / (atol/rtol tol vector) over a --sample-lanes
    subsample re-integrated in float64 on the CPU (the reference's own
    configuration), plus the same bound for PLAIN f32 as the counterfactual.

Prints one JSON line.

Usage: python benchmarks/tight_tolerance.py [--systems 131072]
                                            [--sample-lanes 512] [--cpu]
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
    p.add_argument("--sample-lanes", type=int, default=512)
    p.add_argument("--days", type=float, default=2.0)
    p.add_argument("--cpu", action="store_true", help="kernel interpreter (smoke)")
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
    from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas
    from tiger_tpu.models import Model204
    from tiger_tpu.solver.config import SolverConfig
    from tiger_tpu.solver.rk45 import rk45_solve

    s_count = args.systems
    tf = args.days * 1440.0
    model = Model204()
    # The reference's artifact tolerances.  min_step_fraction is lowered from
    # the span-relative default: at tight tolerances legitimate step sizes
    # pass through span*1e-6 while ramping up from the tiny initial h, and
    # the collapse criterion must not misread that as stiffness.
    tol = dict(rtol=1e-6, atol=1e-9, max_steps=400_000, min_step_fraction=1e-9)
    y0, params, forcings = _scenario(s_count, jnp.float32, days=args.days)
    qt = jnp.arange(0.0, tf + 1e-9, 60.0, dtype=jnp.float32)
    h0 = jnp.full((s_count,), 1e-3, jnp.float32)
    interp = args.cpu

    def run_kernel(comp: bool):
        cfg = SolverConfig(compensated=comp, **tol)
        res = rk45_solve_pallas(
            model, y0, 0.0, tf, qt, params, forcings, h0=h0, config=cfg,
            interpret=interp,
        )
        jax.block_until_ready(res.y_final)
        return res

    res = run_kernel(True)  # compile
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = run_kernel(True)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    n_att = int(np.asarray(res.stats.n_attempts).sum())

    # f64 CPU reference on a lane subsample (the reference's own regime).
    rng = np.random.default_rng(0)
    pick = np.sort(rng.choice(s_count, size=min(args.sample_lanes, s_count), replace=False))
    cpu = jax.devices("cpu")[0]
    take = lambda a, ax=0: jax.device_put(np.asarray(a).take(pick, axis=ax), cpu)
    with jax.enable_x64(True):
        y0s = jax.device_put(np.asarray(y0)[pick].astype(np.float64), cpu)
        params_s = {k: take(v).astype(jnp.float64) for k, v in params.items()}
        forc_s = ForcingSet(
            data=take(forcings.data, ax=1), meta=forcings.meta
        )
        r64 = rk45_solve(
            model, y0s, 0.0, tf, None, params_s, forc_s,
            h0=jnp.full((len(pick),), 1e-3, jnp.float64),
            config=SolverConfig(**tol),
        )
        y64 = np.asarray(r64.y_final)
        # Tighter f64 run: quantifies the METHOD's own global error at
        # rtol 1e-6 (the yardstick the f32c distances must be read against —
        # Model 204's min/max kinks make global error >> local tolerance).
        r64t = rk45_solve(
            model, y0s, 0.0, tf, None, params_s, forc_s,
            h0=jnp.full((len(pick),), 1e-3, jnp.float64),
            config=SolverConfig(
                rtol=1e-8, atol=1e-11, max_steps=1_000_000,
                min_step_fraction=1e-9,
            ),
        )
        y64t = np.asarray(r64t.y_final)
    ok64 = ~np.asarray(r64.stiff) & ~np.asarray(r64t.stiff)

    def lane_err(ys_all, mask):
        """Per-lane error in tolerance units: max_i |y - y64t| /
        (atol + rtol*|y64t|), against the TIGHT f64 run (the best available
        truth) over ``mask`` lanes."""
        tolv = 1e-9 + 1e-6 * np.abs(y64t[mask])
        return np.max(np.abs(ys_all[mask] - y64t[mask]) / tolv, axis=1)

    def quantiles(e):
        return {
            "p50": float(np.quantile(e, 0.50)),
            "p90": float(np.quantile(e, 0.90)),
            "p99": float(np.quantile(e, 0.99)),
            "max": float(np.max(e)),
        }

    # Distributions over the SAME lane set, all against the tight-f64 truth:
    #   f64_self — the f64 method rerun at the production tolerance: its
    #              per-lane error IS the method's step-size sensitivity band
    #              (kink/ZOH-crossing errors re-randomize with the step
    #              sequence and dwarf the local tolerance on Model 204);
    #   f32c/f32 — the kernel runs.  The claim "f32c holds the reference's
    #              f64 regime" is quantile-wise: each f32c quantile within
    #              CLAIM_MARGIN of the f64-self band's.  Per-lane pairing
    #              would be wrong — a different step sequence re-rolls each
    #              lane's kink errors, so only distributions are comparable.
    res_plain = run_kernel(False)
    m_c = ok64 & ~np.asarray(res.stiff)[pick]
    m_p = ok64 & ~np.asarray(res_plain.stiff)[pick]
    m_all = m_c & m_p
    e64 = quantiles(lane_err(y64, m_all))
    e_c = quantiles(lane_err(np.asarray(res.y_final)[pick], m_all))
    e_p = quantiles(lane_err(np.asarray(res_plain.y_final)[pick], m_all))

    CLAIM_MARGIN = 2.0
    claim = {
        f"f32c_within_band_{q}": bool(e_c[q] <= CLAIM_MARGIN * max(e64[q], 1.0))
        for q in ("p50", "p90", "p99")
    }
    claim["f32c_holds_f64_regime"] = all(claim.values())

    out = {
        "metric": "model204_tight_tol_steps_per_s",
        "value": n_att / wall,
        "unit": "system-steps/s",
        "systems": s_count,
        "rtol": 1e-6,
        "atol": 1e-9,
        "wall_s": wall,
        "steps_total": n_att,
        "backend": jax.devices()[0].platform,
        "n_stiff": int(np.asarray(res.stiff).sum()),
        "n_failed": int(np.asarray(res.failed).sum()),
        "sample_lanes_compared_f64": int(m_all.sum()),
        # Per-lane error quantiles in tolerance units vs the tight-f64 truth.
        "err_tol_units_f64_self": e64,
        "err_tol_units_f32c": e_c,
        "err_tol_units_f32_plain": e_p,
        # The README claim, literally checked: every f32c quantile within
        # CLAIM_MARGIN of the f64 method's own rerun-sensitivity band.  The
        # max is reported above but not claimed on: a single order statistic
        # of a kink-dominated distribution is sampling noise.
        "claim_margin": CLAIM_MARGIN,
        **claim,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
