"""Distribution layer: shard_map domain decomposition over a 'systems' mesh.

Replaces the reference's MPI layer (SURVEY.md 2.10): rank 0 splitting the
SpatialParams table into MPI_BYTE blobs (main.cpp:257-310) becomes per-shard
row slicing of the SoA; one-GPU-per-rank becomes a 1-D ``jax.sharding.Mesh``
over all local (or multi-host) devices.

Why shard_map and not plain batch-dim sharding: the adaptive integration is a
``lax.while_loop`` whose continuation predicate reduces over lanes.  Under
global SPMD sharding that reduction becomes a cross-device collective every
step and forces *global* termination (every device steps until the slowest
lane anywhere finishes).  ``shard_map`` instead gives each shard its own loop with
local termination — the distributed analog of the reference's independent
ranks — and needs zero collectives during integration because systems are
independent (routing exchange, when enabled, rides ``jax.lax.ppermute``; see
tiger_tpu.routing).

Multi-host: each host constructs its local shard of the arrays
(jax.make_array_from_process_local_data) — there is no rank-0 scatter at all.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tiger_tpu.forcing import ForcingSet
from tiger_tpu.solver.config import SolverConfig
from tiger_tpu.solver.controller import initial_step
from tiger_tpu.solver.rk45 import RK45Result, rk45_solve_traced


def systems_mesh(devices=None) -> Mesh:
    """1-D mesh over the 'systems' axis (all local devices by default)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), ("systems",))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_batch(arr, n_pad, axis=0):
    if n_pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, n_pad)
    return jnp.pad(arr, widths, mode="edge")  # padded lanes replicate real rows


@functools.partial(
    jax.jit,
    static_argnames=("model", "t0", "tf", "meta", "config", "mesh", "backend",
                     "interpret"),
)
def _sharded_rk45(
    model, y0, t0, tf, qt, params, forc_data, meta, h0, config, mesh,
    backend="xla", t_shift=0.0, interpret=False,
):
    spec_b = P("systems")  # batch-major shards
    spec_forc = P(None, "systems")  # forcing is [T, S]
    in_specs = (
        spec_b,
        spec_b,
        None if params is None else spec_b,
        None if forc_data is None else spec_forc,
    )
    out_specs = jax.tree.map(lambda _: spec_b, _result_structure())

    def shard_body(y0_s, h0_s, params_s, forc_s):
        if backend == "pallas":
            # The fused kernel composes under shard_map: each shard runs its
            # own grid of blocks on its own device.
            from tiger_tpu.kernels.rk45_pallas import rk45_pipeline

            param_fields = () if params_s is None else tuple(sorted(params_s))
            return rk45_pipeline(
                model, y0_s, h0_s, params_s, forc_s, qt,
                t0, tf, meta, config, param_fields, interpret,
                t_shift,  # closure capture: replicated scalar per shard
            )
        return rk45_solve_traced(
            model, y0_s, t0, tf, qt, params_s, forc_s, meta, h0_s, config,
            t_shift,
        )

    # check_vma=False: the while-loop carries start replicated (t0, cursors)
    # and become shard-varying; there are no collectives inside, so the
    # varying-manual-axis type check is pure friction here.
    fn = jax.shard_map(
        shard_body, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )
    return fn(y0, h0, params, forc_data)


def _result_structure():
    """Pytree prefix token for RK45Result out_specs (leaves all batch-sharded)."""
    from tiger_tpu.solver.rk45 import RKStats

    return RK45Result(
        y_final=0, dense=0, stiff=0, failed=0, h0=0,
        stats=RKStats(n_accepted=0, n_rejected=0, n_attempts=0),
    )


def rk45_solve_sharded(
    model,
    y0: jax.Array,
    t0,
    tf,
    query_times=None,
    params=None,
    forcings: Optional[ForcingSet] = None,
    h0=None,
    config: SolverConfig = SolverConfig(),
    mesh: Optional[Mesh] = None,
    backend: str = "xla",
    t_shift=0.0,
    lower_only: bool = False,
    interpret: bool = False,
) -> RK45Result:
    """RK45 over a device mesh: systems split evenly across devices.

    The batch is padded (edge-replicated rows) to a multiple of the mesh size
    and un-padded on return.  Stiff systems are still handled by the host
    two-phase pipeline (tiger_tpu.solver.api.solve) on the gathered flags.
    ``backend='pallas'`` runs the fused GPU kernel per shard (``interpret``
    runs it in the Pallas interpreter); the per-shard batch is padded to the
    kernel block size internally.

    ``lower_only=True`` returns the jax.stages.Lowered sharded solve instead
    of executing it — collective audits (benchmarks/weak_scaling.py) compile
    it and grep the HLO to prove the solve is pure domain decomposition (no
    inter-device communication exists to slow weak scaling).
    """
    if mesh is None:
        mesh = systems_mesh()
    n_dev = mesh.devices.size
    y0 = jnp.asarray(y0)
    s_count = y0.shape[0]
    s_padded = pad_to_multiple(s_count, n_dev)
    n_pad = s_padded - s_count

    if h0 is None:
        h0 = initial_step(model, y0, t0, params, forcings, config, t_shift=t_shift)
    h0 = jnp.broadcast_to(jnp.asarray(h0, y0.dtype), (s_count,))

    y0p = _pad_batch(y0, n_pad)
    h0p = _pad_batch(h0, n_pad)
    params_p = None if params is None else jax.tree.map(
        lambda a: _pad_batch(jnp.asarray(a), n_pad), params
    )
    forc_data = None if forcings is None else _pad_batch(forcings.data, n_pad, axis=1)
    meta = None if forcings is None else forcings.meta
    from tiger_tpu.kernels.rk45_pallas import check_sorted_queries

    qt = check_sorted_queries(query_times, y0.dtype)

    if lower_only:
        return _sharded_rk45.lower(
            model, y0p, float(t0), float(tf), qt, params_p, forc_data, meta,
            h0p, config, mesh, backend, jnp.asarray(t_shift, y0.dtype),
            interpret,
        )
    res = _sharded_rk45(
        model, y0p, float(t0), float(tf), qt, params_p, forc_data, meta, h0p,
        config, mesh, backend, jnp.asarray(t_shift, y0.dtype), interpret,
    )
    if n_pad:
        res = jax.tree.map(lambda a: a[:s_count], res)
    return res


def shard_rows_for_process(n_rows: int) -> slice:
    """This process's row range in a multi-host run (even split, remainder
    spread over the first processes) — the shard_map analog of the reference's
    rank-0 row scatter (main.cpp:269-308)."""
    from tiger_tpu.params import split_even

    return split_even(n_rows, jax.process_count())[jax.process_index()]
