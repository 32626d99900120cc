"""Ensemble parameter calibration on the batch axis.

The solver's system axis is just a batch dimension — so a K-member parameter
ensemble for an S-link basin is ONE solve of S*K lanes: tile the links K
times, perturb each copy's parameters, integrate everything in a single
fused-kernel invocation, score each member against observed discharge, and
keep the argmin per link.  A 64-member ensemble for a 41k-link basin is
one 2.6M-system solve.  (The reference has no calibration machinery at
all; its batch axis is welded to "links", main.cpp:677.)

Run:  python examples/calibration.py          (CPU, ~20 s)
      python examples/calibration.py --gpu    (fused kernel path on a GPU)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

# Runnable straight from a git checkout, no install needed.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--gpu", action="store_true", help="run on the default (GPU) backend")
    p.add_argument("--links", type=int, default=64)
    p.add_argument("--members", type=int, default=32)
    args = p.parse_args()

    import jax

    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tiger_tpu import Model204, SolverConfig, solve
    from tiger_tpu.forcing import ForcingSet
    from tiger_tpu.routing import link_runoff_204

    S, K = args.links, args.members
    rng = np.random.default_rng(0)

    # --- "truth": a basin with per-link parameters we pretend not to know --
    base = dict(
        c1=0.001 / 60.0, infil=7.0e-5, perco=2.7e-5, Hu=178.0, lat=41.5,
        sw=0.11, ss=0.33, n_mann=0.1, slope=0.02, L=0.6, A_h=0.76,
        alpha3=2880.0, alpha4=79200.0, melt_f=3.7, temp_thr=0.0,
    )
    truth = {
        k: jnp.asarray(np.full(S, v) * rng.uniform(0.7, 1.4, S), jnp.float32)
        for k, v in base.items()
    }
    hours = 48
    pr = rng.gamma(0.15, 2.0, (hours, S)).astype(np.float32)
    t2m = rng.uniform(2.0, 12.0, (2, S)).astype(np.float32)
    forc = ForcingSet.from_series([pr, t2m], [60.0, 1440.0])
    y0 = jnp.tile(jnp.asarray([0.01, 3.0, 0.0, 5.0, 0.2], jnp.float32), (S, 1))
    qt = jnp.arange(0.0, 2881.0, 60.0, dtype=jnp.float32)
    cfg = SolverConfig(rtol=1e-5, atol=1e-6)

    obs_run = solve(Model204(), y0, 0.0, 2880.0, qt, params=truth,
                    forcings=forc, config=cfg)
    q_obs = np.stack([
        np.asarray(link_runoff_204(np.nan_to_num(obs_run.dense[:, i, :]), truth))
        for i in range(qt.shape[0])
    ], axis=1)  # [S, Q] "observed" hydrograph

    # --- ensemble: K perturbed copies of every link, ONE batched solve -----
    # The calibration PRIOR is the uncalibrated parameter table (the `base`
    # constants); members perturb the prior, and observations decide which
    # member each link keeps.  Lane layout [K*S]: member k of link s at row
    # k*S + s.
    tile = lambda a: jnp.tile(a, (K,))
    pert_fields = ("Hu", "n_mann", "infil", "melt_f")
    prior = {
        k: jnp.asarray(np.full(S, v), jnp.float32) for k, v in base.items()
    }
    ens = {k: tile(v) for k, v in prior.items()}
    for name in pert_fields:
        factors = rng.uniform(0.5, 2.0, (K, S)).astype(np.float32)
        factors[0] = 1.0  # member 0 = the unperturbed prior, the baseline
        ens[name] = tile(prior[name]) * jnp.asarray(factors.reshape(K * S))
    forc_ens = ForcingSet(
        data=jnp.tile(forc.data, (1, K)), meta=forc.meta
    )
    y0_ens = jnp.tile(y0, (K, 1))

    t0 = time.perf_counter()
    run = solve(Model204(), y0_ens, 0.0, 2880.0, qt, params=ens,
                forcings=forc_ens, config=cfg)
    jax.block_until_ready(run.y_final)
    wall = time.perf_counter() - t0

    q_ens = np.stack([
        np.asarray(link_runoff_204(np.nan_to_num(run.dense[:, i, :]), ens))
        for i in range(qt.shape[0])
    ], axis=1).reshape(K, S, -1)

    # --- score and select ---------------------------------------------------
    rmse = np.sqrt(((q_ens - q_obs[None]) ** 2).mean(axis=2))  # [K, S]
    best = rmse.argmin(axis=0)  # member index per link
    best_rmse = rmse[best, np.arange(S)]
    prior_rmse = rmse[0]  # member 0 = the unperturbed prior guess
    hu = np.asarray(ens["Hu"]).reshape(K, S)[best, np.arange(S)]
    hu_err = float(np.median(np.abs(hu / np.asarray(truth["Hu"]) - 1.0)))
    print(
        f"{K}-member ensemble x {S} links = {K * S} lanes in {wall:.2f} s; "
        f"median hydrograph RMSE {np.median(prior_rmse):.3g} -> "
        f"{np.median(best_rmse):.3g}; "
        f"median |Hu err| of selected members: {hu_err:.1%}"
    )


if __name__ == "__main__":
    main()
