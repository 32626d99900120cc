"""Batched adaptive Dormand-Prince RK45 with dense output and stiffness flags.

Vectorized re-design of the reference CUDA path (src/solver/rk45_kernel.cu:17-176,
src/solver/rk45_step_dense.cuh:34-244): the reference gives every ODE system its
own CUDA thread with private divergent control flow; here every system is one
*vectorized lane*.  A single per-system adaptive loop is written as
``lax.while_loop`` and ``jax.vmap``-ed over the batch — JAX's while-loop
batching rule masks carry updates per lane, so finished / stiff-flagged systems
automatically become no-ops while the rest keep stepping.  Under ``jit`` the
whole integration is one fused XLA computation: each attempted step is a
handful of [S]-wide vector ops (7 RHS evaluations, tableau accumulations, the
infinity-norm error test) plus a masked scatter for dense output.

Numerics reproduced exactly (see SURVEY.md section 2.2):
  - infinity-norm error: max_i |h * sum_j (b-b_alt)_j k_j,i| / (atol + rtol *
    max(|y_i|, |y_out_i|))  — NOT SciPy's RMS norm (rk45_step_dense.cuh:123-142);
  - accept if err <= 1; h *= clip(safety * (1/(err+1e-16))^0.2, minScale,
    maxScale), with the factor additionally capped at 1 on rejection
    (rk45_kernel.cu:150-163);
  - last step clamped to land exactly on tf (rk45_kernel.cu:54);
  - slope-jump guard after an accepted error test: if max_i|k0_i - k1_i| > 100
    halve h (floor initialStep * 1e-6) and retry (rk45_kernel.cu:131-136);
  - stiffness flag: > max_rejects consecutive rejections OR h < (tf-t0) * 1e-6;
    the system is abandoned for the Radau pass (rk45_kernel.cu:160-170).
    Additionally (non-parity, SolverConfig.stiff_detect) Hairer's DOPRI5
    stability-boundary test flags "accept-cruisers" the reference's
    reject-only criteria miss — lanes pinned at the explicit stability limit
    that accept tiny steps indefinitely without ever rejecting;
  - forcing sampled once per attempted step at step-start t, frozen across all
    7 stages (rk45_kernel.cu:84-116);
  - dense output: quartic DP interpolant fills all sorted query times in
    (t, t+h] per accepted step via a monotone cursor (rk45_kernel.cu:138-148);
    k[0] is recomputed each attempt (no FSAL), 7 RHS evals per attempt.

NaN semantics match CUDA: a NaN error norm fails ``err <= 1.0`` (reject), and
the rejection factor ``fmin(NaN, 1.0) == 1.0`` in CUDA is reproduced with an
explicit isnan select, so NaN steps shrink-retry/stiff-flag identically.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from tiger_tpu.forcing import ForcingSet, gather_forcings_column
from tiger_tpu.solver import tableau
from tiger_tpu.solver.config import SolverConfig
from tiger_tpu.solver.controller import initial_step


class RKStats(NamedTuple):
    n_accepted: jax.Array  # [S] accepted steps
    n_rejected: jax.Array  # [S] rejected attempts
    n_attempts: jax.Array  # [S] total attempted steps


class RK45Result(NamedTuple):
    y_final: jax.Array  # [S, N]; NaN for systems that did not finish (stiff/failed)
    dense: jax.Array  # [S, Q, N]
    stiff: jax.Array  # [S] bool — flagged for the Radau pass (includes failed)
    failed: jax.Array  # [S] bool — hit the max_steps safety cap
    h0: jax.Array  # [S] initial step actually used (needed by the Radau pass)
    stats: RKStats


def dp_step(rhs_t, t, y, h, k0, rtol, atol):
    """One attempted Dormand-Prince 5(4) step for a single system.

    ``rhs_t(t, y) -> dy`` already closes over spatial params and the frozen
    forcing values.  Returns (y_out, err_norm, k[7, N], hlamb).  Mirrors
    rk45_step_dense.cuh:34-145 (stages, 5th-order update, inf-norm error).

    ``hlamb`` is Hairer's |h*lambda| estimate from the two t+h stages
    (DOPRI5 stiffness test, H&W vol II IV.2): both stage 6 and stage 7
    evaluate the RHS at t+h, so h*|k7-k6|/|g7-g6| is a Rayleigh-quotient
    estimate of |h*lambda| for the dominant eigenvalue (0 when the stage
    arguments coincide).  Consumed by SolverConfig.stiff_detect.
    """
    dtype = y.dtype
    a = tableau.DP_A
    c = tableau.DP_C
    ks = [k0]
    g6 = y
    for s in range(1, 7):
        acc = y
        for j in range(s):
            if a[s, j] != 0.0:
                # float(): weak-typed constants so f32 states stay f32 under x64.
                acc = acc + (h * float(a[s, j])) * ks[j]
        if s == 5:
            g6 = acc  # stage-6 argument (the other t+h evaluation point)
        ks.append(rhs_t(t + float(c[s]) * h, acc))
    k = jnp.stack(ks)  # [7, N]

    # Weighted stage sums as explicit multiply-adds in stage order: the
    # fused kernel's exact float32 arithmetic, so that the two agree bit for
    # bit wherever the device's elementary math agrees.
    dy = jnp.zeros_like(y)
    y_err = jnp.zeros_like(y)
    for s in range(7):
        if tableau.DP_B[s] != 0.0:
            dy = dy + (h * float(tableau.DP_B[s])) * ks[s]
        if tableau.DP_E[s] != 0.0:
            y_err = y_err + (h * float(tableau.DP_E[s])) * ks[s]
    y_out = y + dy
    tol = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_out))
    err = jnp.max(jnp.abs(y_err / tol))
    # DP's a7-row == b-row, so the stage-7 argument is exactly y_out.
    stnum = jnp.max(jnp.abs(k[6] - k[5]))
    stden = jnp.max(jnp.abs(y_out - g6))
    hlamb = jnp.where(stden > 0, h * stnum / stden, jnp.zeros((), dtype))
    # ``dy`` is returned separately so compensated commits (cfg.compensated)
    # can Kahan-accumulate it; y_out - y would lose exactly the bits the
    # compensation exists to keep.
    return y_out, err, k, hlamb, dy


def dp_dense(y, k, h, theta):
    """Quartic DP dense-output interpolant (rk45_step_dense.cuh:193-243).

    ``theta`` may be a scalar or a vector [W]; returns y(t_n + theta*h) with
    shape theta.shape + [N].
    """
    qm = []  # [4] x [N], summed like dp_step's stage sums
    for m in range(4):
        acc = jnp.zeros_like(y)
        for j in range(7):
            if tableau.DP_P[j, m] != 0.0:
                acc = acc + float(tableau.DP_P[j, m]) * k[j]
        qm.append(acc)
    th = jnp.asarray(theta)[..., None]
    th2 = th * th
    poly = qm[0] * th + qm[1] * th2 + qm[2] * th2 * th + qm[3] * th2 * th2
    return y + h * poly


class _Carry(NamedTuple):
    t: jax.Array
    t_c: jax.Array  # Kahan compensation of t (f32 t += h drifts ~1e2 ulps
    #                 over ~1e3 steps, skewing forcing and dense times)
    h: jax.Array
    y: jax.Array
    next_q: jax.Array
    next_qt: jax.Array  # cached qt[next_q] (inf past the end): lets the
    #                     common nothing-to-fill case skip all gathers
    reject: jax.Array
    stiff: jax.Array
    n_acc: jax.Array
    n_rej: jax.Array
    n_att: jax.Array
    facold: jax.Array  # last accepted error norm (Lund stabilization state;
    #                    carried but unused under controller='i')
    iasti: jax.Array  # consecutive accepted steps with hlamb > stiff_hlamb
    nonsti: jax.Array  # calm accepted steps since the last trip (forgiveness)
    fstreak: jax.Array  # consecutive attempts with carried h below the
    #                     collapse floor (stiff_floor_streak criterion)
    y_c: jax.Array  # Kahan compensation of y (zeros unless cfg.compensated)
    dense: jax.Array


def fill_dense_queries(cfg, qt, dense, next_q, next_qt, t, h, dense_eval, active,
                       t1=None):
    """Consume all sorted queries in (t, t+h], chunked ``cfg.dense_chunk`` wide.

    Per-system monotone cursor (rk45_kernel.cu:138-148); queries exactly at the
    current t are consumed but not written (the t0-skip that makes the
    reference's dense.csv start at 0.00049995).  ``active`` gates the whole
    fill so rejected/slope-cut attempts write nothing.  ``dense_eval(theta)``
    maps a [W] vector of step fractions to interpolated states [W, N] — shared
    by the RK45 (DP quartic) and Radau (collocation) phases.  ``t1`` (default
    ``t + h``) is the step's committed end time.

    ``next_qt`` is the CACHED value of qt[next_q] (inf past the end), carried
    by the solver so the no-fill fast path — the overwhelmingly common case,
    steps being much shorter than the query spacing — is a single elementwise
    compare with no per-lane gather (gathers under vmap dominate the
    batched solvers' runtime otherwise).  Returns (dense, next_q, next_qt).

    The chunk width scales with Q: under ``vmap`` every inner iteration
    costs one masking select over the WHOLE [S, Q, N] dense carry (the
    batched-while lane mask), so query-dominated runs (Q >> accepted steps,
    e.g. the 10k-query DummyModel grid) must consume many queries per
    iteration — W=8 there measured ~50x slower than W=512 at S=1024 on CPU.
    Step-dominated runs (hourly hydrology queries) keep the small
    ``cfg.dense_chunk``.
    """
    q_total = qt.shape[0]
    w = cfg.dense_chunk
    if q_total // 16 > w:
        # Auto-widen only: never shrink an explicitly larger dense_chunk.
        w = max(w, min(512, 1 << (q_total // 16).bit_length()))
    t1 = t + h if t1 is None else t1
    i32 = next_q.dtype

    def q_time(q):
        return jnp.where(q < q_total, qt[jnp.clip(q, 0, q_total - 1)], jnp.inf)

    def cond(state):
        _, _, nqt = state
        return active & (nqt <= t1)

    def body(state):
        d, q, _ = state
        idxs = q + jnp.arange(w, dtype=i32)
        tq = jnp.where(idxs < q_total, qt[jnp.clip(idxs, 0, q_total - 1)], jnp.inf)
        in_window = tq <= t1
        valid = in_window & (tq > t)
        theta = jnp.where(valid, (tq - t) / h, 0.0).astype(d.dtype)
        yd = dense_eval(theta)  # [W, N]
        # Invalid slots scatter OUT OF RANGE and are dropped: reading the old
        # rows to blend instead (gather + scatter) forces XLA to materialize
        # a copy of the whole dense carry per inner iteration, which at
        # Q=10k/S=1k measured ~1000x slower on CPU.
        d = d.at[jnp.where(valid, idxs, q_total)].set(yd, mode="drop")
        q = q + jnp.sum(in_window, dtype=q.dtype)
        return d, q, q_time(q)

    return lax.while_loop(cond, body, (dense, next_q, next_qt))


def _rk45_system(rhs, gather, t0, tf, qt, y0, h0, cfg: SolverConfig,
                 step_cap=None):
    """Integrate ONE system t0 -> tf (vmapped over the batch by the caller).

    ``rhs(t, y, F)`` is the model RHS closed over this system's parameters;
    ``gather(t) -> F`` returns the zero-order-hold forcing vector, or None.
    """
    dtype = y0.dtype
    n = y0.shape[0]
    q_total = 0 if qt is None else qt.shape[0]
    t0 = jnp.asarray(t0, dtype)
    tf = jnp.asarray(tf, dtype)
    span = tf - t0
    i32 = jnp.int32

    if q_total > 0 and cfg.fill_t0_queries:
        dense0 = jnp.where((qt <= t0)[:, None], y0[None, :], jnp.zeros((q_total, n), dtype))
    else:
        dense0 = jnp.zeros((q_total, n), dtype)

    carry0 = _Carry(
        t=t0,
        t_c=jnp.zeros((), dtype),
        h=jnp.asarray(h0, dtype),
        y=y0,
        next_q=jnp.zeros((), i32),
        next_qt=(qt[0] if q_total > 0 else jnp.asarray(jnp.inf, dtype)),
        reject=jnp.zeros((), i32),
        stiff=jnp.zeros((), bool),
        n_acc=jnp.zeros((), i32),
        n_rej=jnp.zeros((), i32),
        n_att=jnp.zeros((), i32),
        facold=jnp.asarray(1e-4, dtype),
        iasti=jnp.zeros((), i32),
        nonsti=jnp.zeros((), i32),
        fstreak=jnp.zeros((), i32),
        y_c=jnp.zeros_like(y0),
        dense=dense0,
    )

    def cond(c: _Carry):
        return (c.t < tf) & (~c.stiff) & (c.n_att < cfg.max_steps)

    def body(c: _Carry):
        clamped = c.t + c.h > tf
        h_eff = jnp.where(clamped, tf - c.t, c.h)
        if step_cap is not None:
            # ZOH boundary alignment (SolverConfig.forcing_step_align).
            h_eff = step_cap(c.t, h_eff)
        f_vals = gather(c.t) if gather is not None else None

        def rhs_t(tt, yy):
            return rhs(tt, yy, f_vals)

        k0 = rhs_t(c.t, c.y)
        y_next, err, k, hlamb, dy = dp_step(
            rhs_t, c.t, c.y, h_eff, k0, cfg.rtol, cfg.atol
        )
        if cfg.compensated:
            # Kahan commit (see SolverConfig.compensated): the error test
            # above used the plain y + dy; the committed state additionally
            # folds the carried low bits back in.
            kh = dy - c.y_c
            y_next = c.y + kh
            y_c_new = (y_next - c.y) - kh
        else:
            y_c_new = c.y_c

        accept = err <= 1.0  # NaN err => False, as in CUDA
        jump = jnp.max(jnp.abs(k[0] - k[1])) > cfg.slope_jump_thresh
        advance = accept & ~jump
        slope_cut = accept & jump

        # float32: Kahan-compensated committed time, as the fused kernel
        # commits it; also the dense fill's upper bound (filling to t + h_eff
        # while committing t + (h_eff - t_c) would leave a ~1-ulp gap of
        # queries that are never filled).  float64 keeps the reference's
        # plain t += h, whose drift is far below any tolerance.
        compensate_t = dtype == jnp.float32
        kt = h_eff - c.t_c if compensate_t else h_eff
        t1 = c.t + kt

        if q_total > 0:
            dense_eval = lambda th: dp_dense(c.y, k, h_eff, th)
            dense, next_q, next_qt = fill_dense_queries(
                cfg, qt, c.dense, c.next_q, c.next_qt, c.t, h_eff, dense_eval,
                advance, t1=t1,
            )
        else:
            dense, next_q, next_qt = c.dense, c.next_q, c.next_qt

        if cfg.controller == "pi":
            # Lund-stabilized PI (Hairer & Wanner DOPRI5): accept factor
            # safety * err^-(1/5 - 0.75*beta) * facold^beta; rejections use
            # the unstabilized factor (no previous-error credit).  facold is
            # updated only on COMMITTED steps (advance) — a slope-cut attempt
            # passes the error test but is discarded and retried, and Hairer's
            # DOPRI5 seeds the stabilization state from committed steps only.
            expo = 0.2 - cfg.pi_beta * 0.75
            base_fac = cfg.safety * (1.0 / (err + 1e-16)) ** expo
            raw_fac = base_fac * c.facold**cfg.pi_beta
            # Clamped landing steps (h cut to hit tf — or a window boundary in
            # the kernel's query-windowed mode) don't feed the stabilization
            # state: their artificially small error would floor facold to 1e-4
            # and damp post-boundary growth ~31% for no numerical reason.
            facold_new = jnp.where(
                advance & ~clamped, jnp.maximum(err, 1e-4), c.facold
            )
        else:
            base_fac = cfg.safety * (1.0 / (err + 1e-16)) ** 0.2
            raw_fac = base_fac
            facold_new = c.facold
        fac_acc = jnp.clip(raw_fac, cfg.min_scale, cfg.max_scale)
        # NaN error: cfg.nan_shrink (1.0 == CUDA parity: fmin(NaN,1) is 1.0
        # so the reference retries at the SAME h; default shrinks instead).
        fac_rej = jnp.where(jnp.isnan(base_fac), cfg.nan_shrink, jnp.minimum(base_fac, 1.0))
        fac_rej = jnp.clip(fac_rej, cfg.min_scale, cfg.max_scale)

        # A clamped landing step must not shrink the carried h either: the
        # controller's intent is h_eff*fac, but never below the pre-clamp h
        # (matters only when h is consumed after the landing — the kernel's
        # window scan; here the final h is unused, so parity is unaffected).
        h_adv = jnp.where(clamped, jnp.maximum(h_eff * fac_acc, c.h), h_eff * fac_acc)
        h_slope = jnp.maximum(h_eff * 0.5, jnp.asarray(h0, dtype) * cfg.min_step_fraction)
        h_rej = h_eff * fac_rej
        h_new = jnp.where(advance, h_adv, jnp.where(slope_cut, h_slope, h_rej))

        reject_new = jnp.where(accept, 0, c.reject + 1)
        h_floor = span * cfg.min_step_fraction
        if cfg.stiff_detect:
            # h-collapse = PERSISTENTLY below the span-proportional floor
            # (see SolverConfig.stiff_floor_streak).  The raw reference rule
            # flags the first rejection below it, which on long records
            # trips on every transient kink-resolution dip — a 9-month run
            # of the reference's own config flags EVERY lane that way.
            fstreak_new = jnp.where(h_new < h_floor, c.fstreak + 1, 0)
            stiff_new = ((~accept) & (reject_new > cfg.max_rejects)) | (
                fstreak_new >= cfg.stiff_floor_streak
            )
        else:
            fstreak_new = c.fstreak
            stiff_new = (~accept) & (
                (reject_new > cfg.max_rejects) | (h_new < h_floor)
            )

        if cfg.stiff_detect:
            # Hairer stability-boundary detector (see SolverConfig.stiff_*).
            # Two trip sources:
            #  - every stiff_test_every-th COMMITTED step whose |h*lambda|
            #    estimate exceeds the DP5 stability bound (cadenced, so
            #    lanes that finish cheaply never accumulate a streak);
            #  - every slope-cut attempt, UNCADENCED: the slope-jump guard's
            #    absolute threshold (reference units, rk45_kernel.cu:131) is
            #    orders of magnitude above healthy RHS magnitudes and fires
            #    only when the RHS is stiff-mode-dominated, so each cut is
            #    unambiguous stiffness evidence — and a throttling treadmill
            #    (h halved, step discarded; measured 63-67% of all attempts
            #    on marginally-stiff Model-204 lanes, 5x their useful work).
            n_acc_new = c.n_acc + advance.astype(i32)
            tested = advance & (
                (n_acc_new & (cfg.stiff_test_every - 1)) == 0
            )
            trip = slope_cut | (tested & (hlamb > cfg.stiff_hlamb))
            calm = tested & ~(hlamb > cfg.stiff_hlamb)
            iasti_new = jnp.where(trip, c.iasti + 1, c.iasti)
            nonsti_new = jnp.where(
                trip, 0, jnp.where(calm, c.nonsti + 1, c.nonsti)
            )
            iasti_new = jnp.where(
                calm & (nonsti_new >= cfg.stiff_forgive), 0, iasti_new
            )
            stiff_new = stiff_new | (iasti_new >= cfg.stiff_streak)
        else:
            iasti_new, nonsti_new = c.iasti, c.nonsti

        return _Carry(
            t=jnp.where(advance, t1, c.t),
            t_c=jnp.where(advance, (t1 - c.t) - kt, c.t_c) if compensate_t else c.t_c,
            h=h_new,
            y=jnp.where(advance, y_next, c.y),
            next_q=next_q,
            next_qt=next_qt,
            reject=reject_new,
            stiff=c.stiff | stiff_new,
            n_acc=c.n_acc + advance.astype(i32),
            n_rej=c.n_rej + (~accept).astype(i32),
            n_att=c.n_att + 1,
            facold=facold_new,
            iasti=iasti_new,
            nonsti=nonsti_new,
            fstreak=fstreak_new,
            y_c=jnp.where(advance, y_c_new, c.y_c),
            dense=dense,
        )

    out = lax.while_loop(cond, body, carry0)

    completed = out.t >= tf
    failed = (~completed) & (~out.stiff)
    stiff = out.stiff | failed  # failed systems also go to the Radau pass
    nan = jnp.full_like(out.y, jnp.nan)
    y_final = jnp.where(completed, out.y, nan)
    stats = RKStats(n_accepted=out.n_acc, n_rejected=out.n_rej, n_attempts=out.n_att)
    return RK45Result(
        y_final=y_final,
        dense=out.dense,
        stiff=stiff,
        failed=failed,
        h0=jnp.asarray(h0, dtype),
        stats=stats,
    )


import functools


def vmap_system_solve(model, sys_fn, y0, h0, params, forc_data, meta,
                      t0, tf, qt, config, t_shift=0.0):
    """Shared batched-solve wrapper: the rhs/gather closures, the
    loop-invariant parameter hoist, and the vmap axes used identically by
    the RK45, Radau and segmented solvers (one source of truth — these were
    three hand-kept copies that had already diverged on the hoist).

    ``t_shift`` (traced scalar) offsets the time the MODEL rhs sees —
    chunked runs integrate window-relative time, but time-dependent physics
    (Model 200's day-of-year) must see absolute time.  Forcing gathers stay
    window-relative.
    """
    if params is not None and hasattr(model, "derived_params"):
        # Hoist loop-invariant parameter math (reciprocals, Manning
        # coefficient) out of the per-step RHS — computed once over the
        # whole [S] batch before the vmap.
        params = model.derived_params(params)

    from tiger_tpu.forcing import ZOH_SNAP, zoh_step_cap

    snap = ZOH_SNAP if (config.forcing_step_align and forc_data is not None) else 0.0

    def single(y0_row, h0_row, p_row, forc_col):
        def rhs(t, y, f_vals):
            return model.rhs(t + t_shift, y, p_row, f_vals)

        gather = None
        if forc_col is not None:
            gather = lambda t: gather_forcings_column(forc_col, meta, t, snap)
        step_cap = (lambda t, h: zoh_step_cap(meta, t, h)) if snap else None
        return sys_fn(rhs, gather, t0, tf, qt, y0_row, h0_row, config, step_cap)

    in_axes = (0, 0, None if params is None else 0, None if forc_data is None else 1)
    return jax.vmap(single, in_axes=in_axes)(y0, h0, params, forc_data)


def rk45_solve_traced(model, y0, t0, tf, qt, params, forc_data, meta, h0, config,
                      t_shift=0.0):
    """Traceable (un-jitted) batched solve — composes under shard_map/pjit."""
    return vmap_system_solve(
        model, _rk45_system, y0, h0, params, forc_data, meta,
        t0, tf, qt, config, t_shift,
    )


_rk45_solve_impl = functools.partial(
    jax.jit, static_argnames=("model", "t0", "tf", "meta", "config")
)(rk45_solve_traced)


def rk45_solve(
    model,
    y0: jax.Array,
    t0,
    tf,
    query_times: Optional[jax.Array] = None,
    params=None,
    forcings: Optional[ForcingSet] = None,
    h0: Optional[jax.Array] = None,
    config: SolverConfig = SolverConfig(),
    t_shift=0.0,
) -> RK45Result:
    """Batched RK45 integration of ``y0[S, N]`` from t0 to tf.

    Clean-API analog of the reference's ``run_rk45<Model>``
    (src/solver/rk45_api.hpp:273-313) minus the Radau phase — see
    tiger_tpu.solver.api.solve for the full two-phase pipeline.  Jitted
    internally (model, time span, forcing layout and config are static;
    repeated calls with the same structure hit the compile cache).

    ``params``: dict of [S] arrays (SpatialParams SoA) or None.
    ``forcings``: ForcingSet with data [T_total, S] or None.
    ``h0``: explicit per-system initial steps [S]; None => config-driven
    estimate (see SolverConfig.h0_mode).
    """
    y0 = jnp.asarray(y0)
    s_count, _ = y0.shape
    if h0 is None:
        h0 = initial_step(model, y0, t0, params, forcings, config)
    h0 = jnp.broadcast_to(jnp.asarray(h0, y0.dtype), (s_count,))
    qt = None if query_times is None else jnp.asarray(query_times, y0.dtype)
    forc_data = None if forcings is None else forcings.data
    meta = None if forcings is None else forcings.meta
    return _rk45_solve_impl(
        model, y0, float(t0), float(tf), qt, params, forc_data, meta, h0, config,
        jnp.asarray(t_shift, y0.dtype),
    )
