"""Routed-discharge benchmark: synthetic 41k-link basin, realistic depth.

The reference basin has 41,274 links (data/small_example_pr_lookup.csv) and
never computes routing; this measures the O(log depth) pointer-doubling
accumulation (tiger_tpu.routing) at that scale for the full [S, Q] routed
hydrograph.  Honest-timing rules: inputs are perturbed per repeat and a
checksum is materialized, so no repeat can reuse an earlier result.

Usage: python benchmarks/routing_bench.py [--links 41274] [--queries 49]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_basin(n_links: int, target_depth: int, seed: int = 0):
    """Random tree whose trunk is a chain of ``target_depth`` links; the rest
    attach at random points (row order is downstream-sorted)."""
    rng = np.random.default_rng(seed)
    next_row = np.full(n_links, -1, np.int64)
    # Trunk: last `target_depth+1` rows form the outlet chain.
    trunk0 = n_links - target_depth - 1
    for i in range(trunk0, n_links - 1):
        next_row[i] = i + 1
    # Tributaries drain to a random strictly-downstream row.
    for i in range(trunk0):
        next_row[i] = rng.integers(i + 1, n_links)
    ids = np.arange(1, n_links + 1)
    nxt = np.where(next_row >= 0, ids[np.clip(next_row, 0, None)], -1)
    return ids, nxt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--links", type=int, default=41274)
    ap.add_argument("--queries", type=int, default=49)
    ap.add_argument("--depth", type=int, default=400)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tiger_tpu import routing

    ids, nxt = synthetic_basin(args.links, args.depth)
    topo = routing.build_topology(ids, nxt)
    assert topo.depth >= args.depth, topo.depth
    n_rounds = topo.ptr_tables.shape[0]

    rng = np.random.default_rng(1)
    s, q_n = args.links, args.queries
    params = {
        "n_mann": jnp.asarray(np.full(s, 0.03), jnp.float32),
        "slope": jnp.asarray(rng.uniform(0.01, 0.1, s), jnp.float32),
        "L": jnp.asarray(rng.uniform(0.5, 3.0, s), jnp.float32),
        "A_h": jnp.asarray(rng.uniform(5, 50, s), jnp.float32),
        "alpha3": jnp.asarray(np.full(s, 2880.0), jnp.float32),
        "alpha4": jnp.asarray(np.full(s, 7200.0), jnp.float32),
    }
    dense = jnp.asarray(rng.uniform(0, 0.5, (s, q_n, 5)), jnp.float32)

    fn = jax.jit(lambda d: routing.routed_discharge(d, params, topo))
    out = jax.block_until_ready(fn(dense))  # compile
    assert bool(jnp.isfinite(out).all())

    times = []
    checksum = 0.0
    for r in range(args.repeats):
        d_r = dense * (1.0 + 1e-6 * (r + 1))  # perturb: defeat relay caching
        jax.block_until_ready(d_r)
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(d_r))
        times.append(time.perf_counter() - t0)
        checksum += float(out[-1, -1])
    wall = float(np.median(times))

    print(json.dumps({
        "metric": "routed_discharge_links_x_queries_per_s",
        "value": s * q_n / wall,
        "unit": "link-queries/s",
        "links": s,
        "queries": q_n,
        "depth": int(topo.depth),
        "doubling_rounds": int(n_rounds),
        "wall_s_median": wall,
        "backend": jax.devices()[0].platform,
        "checksum": checksum,
    }))


if __name__ == "__main__":
    main()
