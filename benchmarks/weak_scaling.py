"""Weak-scaling harness: systems/s efficiency from 1 to N shards.

North-star target (BASELINE.json): >= 90% weak-scaling efficiency on
systems/s from 1 host to N hosts.  On real multi-host hardware run this under
``jax.distributed``; without a pod slice it measures the shard_map path over
however many devices exist (or virtual CPU devices via
XLA_FLAGS=--xla_force_host_platform_device_count=8).

On VIRTUAL CPU devices the naive efficiency (vs 1 shard x N) conflates two
things: sharding/collective overhead (what would survive on real ICI) and
host-core oversubscription (N virtual devices split the same cores, so even
perfectly-sharded work cannot scale).  This harness separates them with a
controlled comparison: for every N it also solves the SAME TOTAL BATCH on
ONE device (same machine, same cores, same FLOPs — XLA multithreads the
single-device batch across all cores).  ``efficiency_net`` =
wall_1dev(N*B) / wall_Ndev(N*B) then prices ONLY what sharding adds
(shard_map dispatch, per-shard compile shape, load imbalance across the
batched while-loop) — cores cancel out.  ``imbalance`` reports
max-shard/mean-shard attempted steps: the sharded wall is governed by the
slowest shard, which is a property of the workload split, not the backend.

Usage:  python benchmarks/weak_scaling.py [--per-shard 4096] [--days 0.5]
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
    p.add_argument("--per-shard", type=int, default=4096)
    p.add_argument("--days", type=float, default=0.5)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--backend", default="xla", choices=["xla", "pallas"],
                   help="pallas = fused GPU kernel per shard")
    args = p.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _scenario
    from tiger_tpu.dist import rk45_solve_sharded, systems_mesh
    from tiger_tpu.models import Model204
    from tiger_tpu.solver.config import SolverConfig
    from tiger_tpu.solver.rk45 import rk45_solve

    devs = jax.devices()
    config = SolverConfig(rtol=1e-5, atol=1e-8, max_steps=100_000)
    tf = args.days * 1440.0
    model = Model204()

    def timed(fn):
        fn(0.0)  # compile
        walls = []
        for i in (1, 2, 3):
            t = time.perf_counter()
            res = fn(i * 1e-7)
            walls.append(time.perf_counter() - t)
        return float(np.median(walls)), res

    results = []
    n = 1
    while n <= len(devs):
        s_count = args.per_shard * n
        y0, params, forcings = _scenario(s_count, jnp.float32)
        h0 = jnp.full((s_count,), 1e-3, jnp.float32)
        mesh = systems_mesh(devs[:n])

        def sharded(eps):
            res = rk45_solve_sharded(
                model, y0 + eps, 0.0, tf, None, params, forcings,
                h0=h0, config=config, mesh=mesh, backend=args.backend,
            )
            float(jnp.nansum(res.y_final))
            return res

        def single(eps):
            # Same total batch, ONE device: the oversubscription control —
            # identical FLOPs on identical cores, no sharding.
            res = rk45_solve(
                model, y0 + eps, 0.0, tf, None, params, forcings,
                h0=h0, config=config,
            )
            float(jnp.nansum(res.y_final))
            return res

        wall, res = timed(sharded)
        wall_1dev, _ = timed(single)
        att = np.asarray(res.stats.n_attempts)
        per_shard_att = att.reshape(n, -1).sum(axis=1)
        results.append({
            "devices": n,
            "systems": s_count,
            "wall_s": wall,
            "steps_per_s": int(att.sum()) / wall,
            "wall_1dev_same_batch_s": wall_1dev,
            # Sharding-only cost (cores cancel): what survives on real ICI.
            "efficiency_net": wall_1dev / wall,
            # Slowest shard governs the wall; property of the batch split.
            "imbalance": float(per_shard_att.max() / per_shard_att.mean()),
        })
        n *= 2

    base = results[0]["steps_per_s"]
    for r in results:
        # Naive weak-scaling number (conflates cores on virtual devices).
        r["efficiency"] = r["steps_per_s"] / (base * r["devices"])

    # Collective audit: compile the largest sharded solve and count inter-
    # device communication ops in the HLO.  The solve is pure domain
    # decomposition — ZERO collectives means real-ICI weak scaling is
    # limited only by load imbalance (reported above, ~1-2%), not by
    # communication; the only collectives in the system live in the routing
    # exchange (O(log depth) ppermutes, benchmarked separately).
    n_max = results[-1]["devices"]
    s_count = args.per_shard * n_max
    y0, params, forcings = _scenario(s_count, jnp.float32)
    lowered = rk45_solve_sharded(
        model, y0, 0.0, tf, None, params, forcings,
        h0=jnp.full((s_count,), 1e-3, jnp.float32), config=config,
        mesh=systems_mesh(devs[:n_max]), backend=args.backend,
        lower_only=True,
    )
    hlo = lowered.compile().as_text()
    n_coll = sum(
        hlo.count(op)
        for op in ("all-reduce", "all-gather", "collective-permute",
                   "all-to-all", "reduce-scatter")
    )

    print(json.dumps({
        "host_cpu_count": os.cpu_count(),
        "backend_platform": devs[0].platform,
        "collective_ops_in_sharded_solve_hlo": n_coll,
        "results": results,
    }))


if __name__ == "__main__":
    main()
