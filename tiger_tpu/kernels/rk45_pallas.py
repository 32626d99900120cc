"""Pallas kernel (Triton route): fused batched adaptive RK45 with dense output.

One ``pallas_call`` runs the ENTIRE t0->tf adaptive integration, one system
per GPU thread, in 1-D blocks of ``BLOCK`` lanes — the reference's own shape
(rk45_then_radau_multi, src/solver/rk45_kernel.cu:17-176: one CUDA thread per
system, 128 threads per block):

  - the adaptive loop is a ``lax.while_loop`` whose carry (t, h, y, stage
    slopes, counters) lives in registers — the vmap/XLA path re-reads and
    re-writes its loop carry from device memory on every attempted step;
  - each block exits as soon as ITS lanes are done, so one slow system stalls
    only its own block instead of the whole batch (the vmap path iterates
    every lane until the global laggard finishes);
  - forcings stay resident in device memory as ``[T, S]``; each lane reads
    the zero-order-hold sample at its own step-start time (a per-lane gather
    that coalesces while a block's lanes sit in the same forcing interval);
  - dense output: each lane keeps a monotone query cursor and stores its own
    rows straight into a ``[Q*N, S]`` buffer with masked per-lane stores,
    transposed once by XLA to the API's ``[S, Q, N]``.

Numerics are those of tiger_tpu.solver.rk45's float32 path, operation for
operation (same tableau module, stage sums in the same order, the same
controller, stiffness logic and Kahan-compensated time commit);
``test_pallas_kernel.py`` asserts bit-for-bit agreement with the vmap path
in interpret mode.  The kernel is float32; float64 batches take the vmap path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tiger_tpu.forcing import ForcingMeta, ForcingSet, ZOH_SNAP, zoh_step_cap
from tiger_tpu.solver import tableau
from tiger_tpu.solver.config import SolverConfig
from tiger_tpu.solver.rk45 import RK45Result, RKStats

#: Lanes (systems) per block; PERF.md has the measurement behind the choice.
BLOCK = 32


def compiler_params(block: int):
    """Triton-route parameters for blocks of ``block`` lanes.

    Two threads per lane: XLA's Triton pipeline (jaxlib 0.9, sm_90) crashes
    compiling a ``while`` loop over 1-D blocks that give every thread its
    own element, while layouts that replicate each lane over two threads
    compile (PERF.md, bring-up findings).  One pipeline stage: the kernels
    stream no tiles, so software pipelining has nothing to overlap."""
    return plgpu.CompilerParams(num_warps=max(block // 16, 1), num_stages=1)


def nan_max(a, b):
    """Elementwise maximum that propagates NaN, as XLA's does.  The Triton
    route lowers ``jnp.maximum`` to ``maxnum``, which drops a NaN operand:
    an error norm taken with it would accept a NaN step."""
    return jnp.where((a != a) | (b != b), a + b, jnp.maximum(a, b))


def pad_lanes(a, s_pad: int, axis: int):
    """Pad the lane axis to ``s_pad`` by replicating row 0 (padded lanes
    integrate a real system and are sliced off afterwards)."""
    pad_n = s_pad - a.shape[axis]
    if pad_n == 0:
        return a
    idx = jnp.zeros((pad_n,), jnp.int32)
    return jnp.concatenate([a, jnp.take(a, idx, axis=axis)], axis=axis)


def block_lanes(block: int):
    """(slice, lane-index vector) of this program's block of systems."""
    pid = pl.program_id(0)
    return pl.ds(pid * block, block), pid * block + lax.iota(jnp.int32, block)


def gather_forcings(forc_ref, meta: ForcingMeta, t, lanes, snap: float):
    """Per-lane ZOH gather: tuple of forcing values at each lane's own t
    (same snapped index as forcing.gather_forcings_column)."""
    vals = []
    for off, n_t, dt in zip(meta.offsets, meta.n_steps, meta.dt_min):
        idx = jnp.clip(jnp.floor(t / dt + snap).astype(jnp.int32), 0, n_t - 1)
        vals.append(forc_ref[off + idx, lanes])
    return tuple(vals)


def init_dense(dense_ref, qt_ref, sl, y0, t0, q_total, fill_t0: bool):
    """Rows with qt <= t0 start as y0 (fill_t0_queries), all others 0."""
    n_eq = len(y0)

    def row(q, carry):
        pre = (qt_ref[q] <= t0) if fill_t0 else False
        for i in range(n_eq):
            dense_ref[q * n_eq + i, sl] = jnp.where(pre, y0[i], 0.0)
        return carry

    lax.fori_loop(0, q_total, row, None)


def fill_dense(dense_ref, qt_ref, lanes, q_total, n_eq, accept, t, t1, h,
               nq, nqt, interp):
    """Store the interpolant at every query in (t, t1] of each accepting lane.

    Per-lane monotone cursor ``nq`` with its cached time ``nqt`` (inf past
    the end), as in solver/rk45.fill_dense_queries: queries <= t are
    consumed but not written (they were prefilled).  ``interp(theta)``
    returns the N interpolated components.  The loop runs while any lane of
    the block has a query left in its step, so a step that spans several
    queries stores them one per iteration."""

    def cond(s):
        return s[0] > 0

    def body(s):
        _, nq, nqt = s
        pend = accept & (nqt <= t1)
        write = pend & (nqt > t)
        theta = jnp.where(write, (nqt - t) / h, 0.0)
        vals = interp(theta)
        row0 = jnp.minimum(nq, q_total - 1) * n_eq
        for i in range(n_eq):
            plgpu.store(dense_ref.at[row0 + i, lanes], vals[i], mask=write)
        nq = nq + pend.astype(jnp.int32)
        nqt = jnp.where(
            nq < q_total, qt_ref[jnp.minimum(nq, q_total - 1)], jnp.inf
        )
        return jnp.max((accept & (nqt <= t1)).astype(jnp.int32)), nq, nqt

    alive = jnp.max((accept & (nqt <= t1)).astype(jnp.int32))
    _, nq, nqt = lax.while_loop(cond, body, (alive, nq, nqt))
    return nq, nqt


class _Carry(NamedTuple):
    alive: jax.Array  # scalar i32: any lane of the block still active
    t: jax.Array  # (B,)
    t_c: jax.Array  # Kahan compensation for t: f32 t += h over ~1e3 steps
    #                 otherwise drifts ~1e2 ulps, skewing forcing/dense times
    h: jax.Array
    y: tuple  # N_EQ arrays of (B,)
    reject: jax.Array  # consecutive rejections, i32
    facold: jax.Array  # PI-controller state (last committed error norm)
    stiff: jax.Array  # bool
    iasti: jax.Array  # Hairer detector: tested steps beyond the boundary
    nonsti: jax.Array  # calm tested steps since the last trip
    fstreak: jax.Array  # consecutive attempts with h below the collapse floor
    y_c: tuple  # Kahan compensation of y (empty unless cfg.compensated)
    n_acc: jax.Array
    n_rej: jax.Array
    n_att: jax.Array
    nq: jax.Array  # dense-output cursor: next query index
    nqt: jax.Array  # cached query time at the cursor (inf past the end)


def _make_kernel(model, param_fields, meta, t0, tf, n_eq, q_total, block,
                 cfg: SolverConfig):
    span = tf - t0
    snap = ZOH_SNAP if (cfg.forcing_step_align and meta is not None) else 0.0
    dp_a, dp_c, dp_b, dp_e, dp_p = (
        tableau.DP_A, tableau.DP_C, tableau.DP_B, tableau.DP_E, tableau.DP_P
    )
    i32 = jnp.int32

    def kernel(shift_ref, qt_ref, y0_ref, h0_ref, params_ref, forc_ref,
               yf_ref, flags_ref, stats_ref, *dense):
        dense_ref = dense[0] if dense else None
        sl, lanes = block_lanes(block)
        y0 = tuple(y0_ref[i, sl] for i in range(n_eq))
        h0 = h0_ref[sl]
        shift = shift_ref[0]
        # Params are read once; loop-invariant derived quantities (Manning
        # coefficient, reciprocal storages) are hoisted out of the loop.
        p_base = {name: params_ref[k, sl] for k, name in enumerate(param_fields)}
        if param_fields and hasattr(model, "derived_params"):
            p_base = model.derived_params(p_base)

        def rhs(t, y, f_vals):
            return model.rhs_tuple(t + shift, y, p_base, f_vals)

        if q_total > 0:
            init_dense(dense_ref, qt_ref, sl, y0, t0, q_total, cfg.fill_t0_queries)

        zf = jnp.zeros((block,), jnp.float32)
        zi = jnp.zeros((block,), i32)
        carry0 = _Carry(
            alive=jnp.ones((), i32),
            t=zf + t0,
            t_c=zf,
            h=h0,
            y=y0,
            reject=zi,
            facold=zf + 1e-4,
            stiff=zi > 0,
            iasti=zi,
            nonsti=zi,
            fstreak=zi,
            y_c=tuple(zf for _ in range(n_eq)) if cfg.compensated else (),
            n_acc=zi,
            n_rej=zi,
            n_att=zi,
            nq=zi,
            nqt=(zf + qt_ref[0]) if q_total > 0 else zf + jnp.inf,
        )

        def body(c):
            act = (c.t < tf) & ~c.stiff & (c.n_att < cfg.max_steps)
            t, y = c.t, c.y
            clamped = t + c.h > tf
            h_eff = jnp.where(clamped, tf - t, c.h)
            if snap:
                # ZOH boundary alignment (SolverConfig.forcing_step_align).
                h_eff = zoh_step_cap(meta, t, h_eff)
            f_vals = None
            if meta is not None:
                f_vals = gather_forcings(forc_ref, meta, t, lanes, snap)

            # Forcing frozen at step-start t for every stage (reference
            # parity, rk45_kernel.cu:84-116).
            ks = [rhs(t, y, f_vals)]
            g6 = y  # stage-6 argument (Hairer hlamb test)
            for s in range(1, 7):
                acc = list(y)
                for j in range(s):
                    if dp_a[s, j] != 0.0:
                        w = float(dp_a[s, j])
                        acc = [acc[i] + (h_eff * w) * ks[j][i] for i in range(n_eq)]
                if s == 5:
                    g6 = tuple(acc)
                ks.append(rhs(t + float(dp_c[s]) * h_eff, tuple(acc), f_vals))

            err_c = [zf for _ in range(n_eq)]
            dys = [zf for _ in range(n_eq)]
            for s in range(7):
                if dp_b[s] != 0.0:
                    w = float(dp_b[s])
                    dys = [dys[i] + (h_eff * w) * ks[s][i] for i in range(n_eq)]
                if dp_e[s] != 0.0:
                    w = float(dp_e[s])
                    err_c = [err_c[i] + (h_eff * w) * ks[s][i] for i in range(n_eq)]
            y_out = [y[i] + dys[i] for i in range(n_eq)]
            err = zf
            for i in range(n_eq):
                tol = cfg.atol + cfg.rtol * jnp.maximum(jnp.abs(y[i]), jnp.abs(y_out[i]))
                err = nan_max(err, jnp.abs(err_c[i] / tol))

            accept = err <= 1.0  # NaN err => False, as in CUDA
            jump_mag = zf
            for i in range(n_eq):
                jump_mag = nan_max(jump_mag, jnp.abs(ks[0][i] - ks[1][i]))
            jump = jump_mag > cfg.slope_jump_thresh
            advance = act & accept & ~jump
            slope_cut = act & accept & jump
            rejected = act & ~accept

            # Kahan-compensated committed time; also the dense fill's upper
            # bound (filling to t + h_eff while committing t + (h_eff - t_c)
            # would leave a ~1-ulp gap of queries that are never filled).
            kh = h_eff - c.t_c
            t1 = t + kh

            nq, nqt = c.nq, c.nqt
            if q_total > 0:
                def interp(theta):
                    qm = [[None] * n_eq for _ in range(4)]
                    for m in range(4):
                        for i in range(n_eq):
                            acc = zf
                            for j in range(7):
                                if dp_p[j, m] != 0.0:
                                    acc = acc + float(dp_p[j, m]) * ks[j][i]
                            qm[m][i] = acc
                    th2 = theta * theta
                    return [
                        y[i] + h_eff * (qm[0][i] * theta + qm[1][i] * th2
                                        + qm[2][i] * th2 * theta
                                        + qm[3][i] * th2 * th2)
                        for i in range(n_eq)
                    ]

                nq, nqt = fill_dense(
                    dense_ref, qt_ref, lanes, q_total, n_eq, advance, t, t1,
                    h_eff, nq, nqt, interp,
                )

            if cfg.controller == "pi":
                # Lund-stabilized PI (mirror of solver/rk45.py); clamped
                # landing steps don't feed the stabilization state.
                expo = 0.2 - cfg.pi_beta * 0.75
                base_fac = cfg.safety * (1.0 / (err + 1e-16)) ** expo
                raw_fac = base_fac * c.facold ** cfg.pi_beta
                facold_new = jnp.where(
                    advance & ~clamped, jnp.maximum(err, 1e-4), c.facold
                )
            else:
                base_fac = cfg.safety * (1.0 / (err + 1e-16)) ** 0.2
                raw_fac = base_fac
                facold_new = c.facold
            fac_acc = jnp.clip(raw_fac, cfg.min_scale, cfg.max_scale)
            fac_rej = jnp.where(
                jnp.isnan(base_fac), cfg.nan_shrink, jnp.minimum(base_fac, 1.0)
            )
            fac_rej = jnp.clip(fac_rej, cfg.min_scale, cfg.max_scale)

            h_slope = jnp.maximum(h_eff * 0.5, h0 * cfg.min_step_fraction)
            # A clamped landing step never shrinks the carried h below its
            # pre-clamp value (solver/rk45.py has the same rule).
            h_adv = jnp.where(clamped, jnp.maximum(h_eff * fac_acc, c.h), h_eff * fac_acc)
            h_new = jnp.where(
                advance, h_adv, jnp.where(slope_cut, h_slope, h_eff * fac_rej)
            )
            reject_new = jnp.where(accept, 0, c.reject + 1)
            h_floor = span * cfg.min_step_fraction
            if cfg.stiff_detect:
                # h-collapse = PERSISTENTLY below the span-proportional floor
                # (SolverConfig.stiff_floor_streak); only active attempts
                # advance the streak.
                fs1 = jnp.where(
                    act & (h_new < h_floor), c.fstreak + 1,
                    jnp.where(act, 0, c.fstreak),
                )
                stiff_new = (rejected & (reject_new > cfg.max_rejects)) | (
                    act & (fs1 >= cfg.stiff_floor_streak)
                )
                # Hairer stability-boundary detector (SolverConfig.stiff_*,
                # mirror of solver/rk45.py): |h*lambda| from the two t+h
                # stages, tested every stiff_test_every-th committed step;
                # slope-cut attempts trip uncadenced.
                stnum, stden = zf, zf
                for i in range(n_eq):
                    stnum = nan_max(stnum, jnp.abs(ks[6][i] - ks[5][i]))
                    stden = nan_max(stden, jnp.abs(y_out[i] - g6[i]))
                hlamb = jnp.where(stden > 0, h_eff * stnum / stden, 0.0)
                n_acc_i = c.n_acc + advance.astype(i32)
                tested = advance & ((n_acc_i & (cfg.stiff_test_every - 1)) == 0)
                beyond = hlamb > cfg.stiff_hlamb
                trip = slope_cut | (tested & beyond)
                calm = tested & ~beyond
                iasti = jnp.where(trip, c.iasti + 1, c.iasti)
                nonsti = jnp.where(trip, 0, jnp.where(calm, c.nonsti + 1, c.nonsti))
                iasti = jnp.where(calm & (nonsti >= cfg.stiff_forgive), 0, iasti)
                stiff_new = stiff_new | (iasti >= cfg.stiff_streak)
            else:
                fs1, iasti, nonsti = c.fstreak, c.iasti, c.nonsti
                stiff_new = rejected & (
                    (reject_new > cfg.max_rejects) | (h_new < h_floor)
                )

            if cfg.compensated:
                # Kahan commit (mirror of solver/rk45.py): the carried low
                # word folds back into the addend; the error test used y+dy.
                khs = [dys[i] - c.y_c[i] for i in range(n_eq)]
                y_kah = [y[i] + khs[i] for i in range(n_eq)]
                y_next = tuple(jnp.where(advance, y_kah[i], y[i]) for i in range(n_eq))
                y_c_new = tuple(
                    jnp.where(advance, (y_kah[i] - y[i]) - khs[i], c.y_c[i])
                    for i in range(n_eq)
                )
            else:
                y_next = tuple(jnp.where(advance, y_out[i], y[i]) for i in range(n_eq))
                y_c_new = ()

            t_new = jnp.where(advance, t1, t)
            stiff_acc = c.stiff | stiff_new
            n_att_new = c.n_att + act.astype(i32)
            still = (t_new < tf) & ~stiff_acc & (n_att_new < cfg.max_steps)
            return _Carry(
                alive=jnp.max(still.astype(i32)),
                t=t_new,
                t_c=jnp.where(advance, (t1 - t) - kh, c.t_c),
                h=jnp.where(act, h_new, c.h),
                y=y_next,
                reject=jnp.where(act, reject_new, c.reject),
                facold=facold_new,
                stiff=stiff_acc,
                iasti=iasti,
                nonsti=nonsti,
                fstreak=fs1,
                y_c=y_c_new,
                n_acc=c.n_acc + advance.astype(i32),
                n_rej=c.n_rej + rejected.astype(i32),
                n_att=n_att_new,
                nq=nq,
                nqt=nqt,
            )

        out = lax.while_loop(lambda c: c.alive > 0, body, carry0)

        completed = out.t >= tf
        for i in range(n_eq):
            yf_ref[i, sl] = jnp.where(completed, out.y[i], jnp.nan)
        # Same contract as the vmap path (solver/rk45.py): lanes that hit
        # max_steps without tripping the stiffness criteria report failed
        # AND stiff (they go to the Radau pass too).
        failed = ~completed & ~out.stiff
        flags_ref[0, sl] = (out.stiff | failed).astype(i32)
        flags_ref[1, sl] = failed.astype(i32)
        stats_ref[0, sl] = out.n_acc
        stats_ref[1, sl] = out.n_rej
        stats_ref[2, sl] = out.n_att

    return kernel


def check_sorted_queries(query_times, dtype):
    """Validated query grid (or None).  Duplicates are fine everywhere (each
    copy is filled identically in the same accepted step); unsorted input is
    an error everywhere — the monotone query cursors would silently skip
    rows."""
    if query_times is None:
        return None
    qt_np = np.asarray(query_times)
    if (np.diff(qt_np) < 0).any():
        raise ValueError("query_times must be sorted ascending")
    return jnp.asarray(qt_np, dtype)


def rk45_solve_pallas(
    model,
    y0: jax.Array,
    t0,
    tf,
    query_times: Optional[jax.Array] = None,
    params=None,
    forcings: Optional[ForcingSet] = None,
    h0: Optional[jax.Array] = None,
    config: SolverConfig = SolverConfig(),
    interpret: bool = False,
    t_shift=0.0,
) -> RK45Result:
    """Fused-kernel RK45 over ``y0[S, N]`` (float32 path).

    Drop-in for tiger_tpu.solver.rk45.rk45_solve (same result structure).
    ``params`` must contain every field the model reads.  ``interpret=True``
    runs the kernel in the Pallas interpreter (CPU tests).  ``t_shift``
    (traced scalar, minutes) offsets the time seen by the MODEL's rhs —
    chunked runs integrate window-relative time, but time-dependent physics
    (Model 200's doy) must see absolute time; forcing gathers stay
    window-relative.
    """
    y0 = jnp.asarray(y0, jnp.float32)
    s_count = y0.shape[0]
    if h0 is None and config.initial_step is not None:
        h0 = config.initial_step
    if h0 is not None:
        # h0=None stays None: the estimate is then traced into the
        # pipeline's jit (one device program instead of two).
        h0 = jnp.broadcast_to(jnp.asarray(h0, jnp.float32), (s_count,))
    param_fields = tuple(sorted(params.keys())) if params is not None else ()
    return rk45_pipeline(
        model, y0, h0, params,
        None if forcings is None else forcings.data,
        check_sorted_queries(query_times, jnp.float32),
        float(t0), float(tf), None if forcings is None else forcings.meta,
        config, param_fields, bool(interpret),
        jnp.asarray(t_shift, jnp.float32),
    )


@functools.partial(
    jax.jit,
    static_argnames=("model", "t0", "tf", "meta", "config", "param_fields", "interpret"),
)
def rk45_pipeline(
    model, y0, h0, params, forc_data, query_times,
    t0, tf, meta, config, param_fields, interpret,
    t_shift=0.0,
):
    """Layout + kernel + un-layout under ONE jit (traceable under shard_map,
    where dist.py calls it per shard)."""
    s_count, n_eq = y0.shape
    if h0 is None:
        from tiger_tpu.solver.controller import _initial_step_impl

        h0 = _initial_step_impl.__wrapped__(
            model, y0, t0, params, forc_data, meta, config,
            jnp.asarray(t_shift, jnp.float32),
        ).astype(jnp.float32)
    q_total = 0 if query_times is None else query_times.shape[0]
    s_pad = -(-s_count // BLOCK) * BLOCK
    f32 = jnp.float32

    y0_m = pad_lanes(y0.T, s_pad, 1)
    h0_m = pad_lanes(h0, s_pad, 0)
    if params is not None:
        p_m = pad_lanes(
            jnp.stack([jnp.asarray(params[k], f32) for k in param_fields]), s_pad, 1
        )
    else:
        p_m = jnp.zeros((1, s_pad), f32)
    f_m = pad_lanes(forc_data.astype(f32), s_pad, 1) if forc_data is not None \
        else jnp.zeros((1, s_pad), f32)
    qt_m = query_times if q_total > 0 else jnp.zeros((1,), f32)

    out_shape = [
        jax.ShapeDtypeStruct((n_eq, s_pad), f32),
        jax.ShapeDtypeStruct((2, s_pad), jnp.int32),
        jax.ShapeDtypeStruct((3, s_pad), jnp.int32),
    ]
    if q_total > 0:
        out_shape.append(jax.ShapeDtypeStruct((q_total * n_eq, s_pad), f32))
    outs = pl.pallas_call(
        _make_kernel(model, param_fields, meta, t0, tf, n_eq, q_total, BLOCK, config),
        grid=(s_pad // BLOCK,),
        out_shape=out_shape,
        backend="triton",
        compiler_params=compiler_params(BLOCK),
        interpret=interpret,
        name="rk45_dense",
    )(jnp.reshape(jnp.asarray(t_shift, f32), (1,)), qt_m, y0_m, h0_m, p_m, f_m)
    yf, flags, stats = outs[:3]
    if q_total > 0:
        dense = outs[3].reshape(q_total, n_eq, s_pad)[:, :, :s_count]
        dense = dense.transpose(2, 0, 1)
    else:
        dense = jnp.zeros((s_count, 0, n_eq), f32)
    return RK45Result(
        y_final=yf[:, :s_count].T,
        dense=dense,
        stiff=flags[0, :s_count] > 0,
        failed=flags[1, :s_count] > 0,
        h0=h0,
        stats=RKStats(
            n_accepted=stats[0, :s_count],
            n_rejected=stats[1, :s_count],
            n_attempts=stats[2, :s_count],
        ),
    )
