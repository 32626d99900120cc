"""Initial step-size estimation (SciPy-style d0/d1 ratio).

The reference computes ONE initial step on the host from system 0 with a ZERO
state vector (src/main.cpp:615-641):

    scale_i = atol + rtol * |y0_i|
    d0 = ||y0 / scale||_2, d1 = ||f(t0, y0) / scale||_2
    h0 = max(1e-6, 0.01 * d0 / (d1 + 1e-16))

(no 1/sqrt(n): plain 2-norm, not SciPy's RMS) and uses it for every system.
With y0 = 0 this degenerates to h0 = 1e-6, which is what every Model-204
artifact was produced with.  ``h0_mode='global-zero-y0'`` reproduces that;
the default ``'per-system'`` evaluates the same formula from each system's
actual initial state (vectorized — an intended improvement, SURVEY.md 7).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tiger_tpu.forcing import ForcingSet, gather_forcings_column
from tiger_tpu.solver.config import SolverConfig

_H_FLOOR = 1e-6


def _estimate(model, t0, y0_row, p_row, f_vals, rtol, atol, t_shift=0.0):
    # t_shift: absolute-time offset for the model rhs (see rk45) — the
    # estimate must sample the same physics regime the solver integrates.
    f0 = model.rhs(jnp.asarray(t0, y0_row.dtype) + t_shift, y0_row, p_row, f_vals)
    scale = atol + rtol * jnp.abs(y0_row)
    d0 = jnp.sqrt(jnp.sum((y0_row / scale) ** 2))
    d1 = jnp.sqrt(jnp.sum((f0 / scale) ** 2))
    return jnp.maximum(_H_FLOOR, 0.01 * d0 / (d1 + 1e-16))


@functools.partial(jax.jit, static_argnames=("model", "t0", "meta", "config"))
def _initial_step_impl(model, y0, t0, params, forc_data, meta, config, t_shift=0.0):
    s_count = y0.shape[0]
    dtype = y0.dtype

    if config.h0_mode == "global-zero-y0":
        # Reference parity: zero state for "system 0".  (The reference also
        # feeds a nonsensical forcing slice here — first two entries of the
        # packed array, main.cpp:622 — but with y0 = 0 the result is the 1e-6
        # floor regardless, so we use the proper t0 forcings of system 0.)
        zero = jnp.zeros_like(y0[0])
        p_row = None if params is None else jax.tree.map(lambda a: a[0], params)
        f_vals = None
        if forc_data is not None:
            f_vals = gather_forcings_column(
                forc_data[:, 0], meta, jnp.asarray(t0, dtype)
            )
        h = _estimate(model, t0, zero, p_row, f_vals, config.rtol, config.atol, t_shift)
        return jnp.full((s_count,), h, dtype)

    # per-system
    def one(y0_row, p_row, forc_col):
        f_vals = None
        if forc_col is not None:
            f_vals = gather_forcings_column(forc_col, meta, jnp.asarray(t0, dtype))
        return _estimate(model, t0, y0_row, p_row, f_vals, config.rtol, config.atol, t_shift)

    in_axes = (0, None if params is None else 0, None if forc_data is None else 1)
    return jax.vmap(one, in_axes=in_axes)(y0, params, forc_data)


def initial_step(
    model,
    y0: jax.Array,
    t0,
    params=None,
    forcings: ForcingSet | None = None,
    config: SolverConfig = SolverConfig(),
    t_shift=0.0,
) -> jax.Array:
    """Per-system initial steps [S] according to ``config``.

    ``config.initial_step`` (explicit scalar) wins; otherwise ``h0_mode``
    selects the reference-parity global estimate or the per-system one.
    Jitted internally (one dispatch instead of several eager ones).
    """
    if config.initial_step is not None:
        return jnp.full((y0.shape[0],), config.initial_step, y0.dtype)
    forc_data = None if forcings is None else forcings.data
    meta = None if forcings is None else forcings.meta
    return _initial_step_impl(
        model, y0, float(t0), params, forc_data, meta, config,
        jnp.asarray(t_shift, y0.dtype),
    )
