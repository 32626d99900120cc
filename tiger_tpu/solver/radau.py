"""Batched implicit 3-stage Radau IIA (order 5) for stiff systems.

Second-phase solver: systems the RK45 pass flagged stiff are RESTARTED from t0
and fully re-integrated, rewriting their dense output from the first query —
mirroring the reference orchestration (src/solver/radau_kernel.cu:20-140,
src/solver/rk45_api.hpp:189-247) but vectorized: one lane per stiff system,
simplified-Newton on the stacked 3Nx3N system solved with a batched
``jnp.linalg.solve`` instead of one unpivoted 15x15 LU per CUDA thread
(small_lu.cuh:13-40).

Numerics (SURVEY.md 2.3): stage increments initialized to f(t, y); Jacobian
refreshed by forward finite differences at every stage point on every Newton
iteration (radau_step_dense.cuh:14-31, eps = sqrt(1e-16), h_eps = eps *
max(1, |y_j|)); at most 10 iterations, converged when max|delta| < 1e-8;
accept test err <= 1 with the embedded b_alt weights; power-law step control
with exponent 1/5 and the same clamp/cap rules as RK45 (radau_kernel.cu:123-135).

Deliberate divergences from the reference (its Radau path has unexercised
bugs; SURVEY.md 2.4 says to fix them):
  - forcing gather uses the correct minutes conversion and cumulative block
    base (the reference kernel divides t by dt in HOURS and uses a wrong base,
    radau_kernel.cu:71,84), and the Newton RHS evaluations see the properly
    gathered step-start forcing vector (the reference passes the raw packed
    array pointer as the forcing values, radau_kernel.cu:104);
  - dense output uses the true collocation interpolant on the converged stage
    slopes Z (the reference interpolates a garbage buffer; tableau.RADAU_DENSE).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from tiger_tpu.forcing import ForcingSet, gather_forcings_column
from tiger_tpu.solver import tableau
from tiger_tpu.solver.config import SolverConfig
from tiger_tpu.solver.rk45 import fill_dense_queries

#: Full-precision contractions: under vmap the small stage products become
#: batched matrix products, which an NVIDIA GPU otherwise rounds to TF32
#: (~1e-3 relative; measured on an H100).
_EXACT = lax.Precision.HIGHEST


class RadauStats(NamedTuple):
    n_accepted: jax.Array
    n_rejected: jax.Array
    n_attempts: jax.Array
    # Newton sweeps each lane sat through — tracked on both the fused-kernel
    # and vmap paths (same contract everywhere, so consumers never need to
    # know which backend produced the result).
    n_newton: Optional[jax.Array] = None
    # Jacobian+LU factorizations each lane paid for (fused kernel only —
    # SolverConfig.radau_factor_reuse makes this < n_attempts; the vmap twin
    # mirrors the reference's refactorize-every-iteration and reports None).
    n_fact: Optional[jax.Array] = None


class RadauResult(NamedTuple):
    y_final: jax.Array  # [S, N]; NaN where the max_steps cap was hit
    dense: jax.Array  # [S, Q, N]
    failed: jax.Array  # [S] bool
    stats: RadauStats


def _fd_jacobian_and_f(rhs_t, ts, y_s):
    """f(ts, y_s) and forward-difference Jacobian J[i, j] = df_i/dy_j.

    Matches approx_jacobian (radau_step_dense.cuh:14-31).
    """
    f_s = rhs_t(ts, y_s)
    # dtype-aware step: the reference's sqrt(1e-16)=1e-8
    # (radau_step_dense.cuh:20) is below float32 resolution — the
    # perturbation would round away and the Jacobian degenerate to zero
    # (Newton then becomes a diverging fixed-point iteration for stiff
    # systems).  The fused kernel applies the same correction.
    eps = jnp.sqrt(jnp.asarray(max(float(jnp.finfo(y_s.dtype).eps), 1e-16), y_s.dtype))
    h_eps = eps * jnp.maximum(1.0, jnp.abs(y_s))  # [N]
    y_pert = y_s[None, :] + jnp.diag(h_eps)  # row j perturbs component j
    f_pert = jax.vmap(lambda yy: rhs_t(ts, yy))(y_pert)  # [N(j), N(i)]
    jac = ((f_pert - f_s[None, :]) / h_eps[:, None]).T  # [i, j]
    return f_s, jac


def lagrange_on_radau_nodes(theta):
    """L_j(theta) for the degree-2 Lagrange basis on the RADAU_C nodes.

    ``theta`` scalar or array; returns a 3-tuple.  Used by the Newton
    predictor (SolverConfig.radau_predictor): the previous attempt's
    collocation slopes evaluated at the new stage times."""
    c = tableau.RADAU_C
    out = []
    for j in range(3):
        # float(): weak-typed constants so f32 inputs stay f32 under x64.
        ca, cb = (float(c[k]) for k in range(3) if k != j)
        out.append(
            ((theta - ca) * (theta - cb))
            * (1.0 / float((c[j] - ca) * (c[j] - cb)))
        )
    return tuple(out)


def radau_step(rhs_t, t, y, h, rtol, atol, cfg: SolverConfig, z0=None,
               retry_on_reject=False, was_rejected=False):
    """One attempted Radau IIA step; returns (y_out, err_norm, Z, n_newton,
    converged).

    ``z0`` [3, N]: Newton starting slopes (default: f(t, y) tiled, the
    reference's choice).  ``retry_on_reject``/``was_rejected``: enable and
    arm RADAU5's rejected-step error correction ('radau5' mode only)."""
    dtype = y.dtype
    n = y.shape[0]
    a_mat = jnp.asarray(tableau.RADAU_A, dtype)
    c_vec = jnp.asarray(tableau.RADAU_C, dtype)
    b_vec = jnp.asarray(tableau.RADAU_B, dtype)

    e_np = tableau.RADAU_E if cfg.radau_error_mode == "reference" else tableau.RADAU_E3
    e_vec = jnp.asarray(e_np, dtype)  # unused in 'radau5' mode

    if z0 is None:
        f0 = rhs_t(t, y)
        z0 = jnp.tile(f0, (3, 1))  # [3, N]
    eye = jnp.eye(3 * n, dtype=dtype)

    # Convergence test, two exits OR-ed (either means "converged"):
    #   (a) raw max|delta| < newton_tol — the reference's absolute criterion
    #       (radau_step_dense.cuh:141), kept for continuity; for stiff lanes
    #       whose slopes are O(1/h) this is unreachable in float32 (the
    #       delta rounding floor is ~eps*|z|), so alone it death-spirals
    #       under newton_reject_unconverged;
    #   (b) the SCALED solution-units criterion (RADAU5's FNEWT, H&W vol II
    #       IV.8): Newton error enters the committed step only through
    #       h * sum_s b_s z_s, so require max_{s,i} h|delta_si| /
    #       (atol + rtol|y_i|) < kappa with kappa = max(10*eps/rtol,
    #       min(0.03, sqrt(rtol))) — dtype- and scale-aware, bounding the
    #       step's Newton-induced error at kappa*tolerance.
    kappa = max(
        10.0 * float(jnp.finfo(dtype).eps) / cfg.rtol,
        min(0.03, float(np.sqrt(cfg.rtol))),
    )
    tol_y = atol + rtol * jnp.abs(y)  # [N]

    def newton_cond(state):
        _, it, done = state
        return (it < cfg.newton_max_iter) & (~done)

    def newton_body(state):
        z, it, _ = state
        y_stage = y[None, :] + h * jnp.matmul(a_mat, z, precision=_EXACT)  # [3, N]
        ts = t + c_vec * h
        f_st, j_st = jax.vmap(lambda tt, yy: _fd_jacobian_and_f(rhs_t, tt, yy))(ts, y_stage)
        # Block (s, i), (sp, j) of the Newton matrix: delta - h*A[s,sp]*J_s[i,j]
        # (block-row s uses the Jacobian evaluated at stage s, as the reference
        # does, radau_step_dense.cuh:96-129).
        blocks = a_mat[:, :, None, None] * j_st[:, None, :, :]  # [s, sp, i, j]
        m_mat = eye - h * blocks.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n)
        rhs_vec = (-z + f_st).reshape(3 * n)
        delta = jnp.linalg.solve(m_mat, rhs_vec).reshape(3, n)
        z = z + delta
        maxd = jnp.max(jnp.abs(delta))
        scaled = jnp.max(h * jnp.abs(delta) / tol_y[None, :])
        done = (maxd < cfg.newton_tol) | (scaled < kappa) | jnp.isnan(maxd)
        return z, it + 1, done

    z, n_newton, done = lax.while_loop(
        newton_cond, newton_body, (z0, jnp.zeros((), jnp.int32), jnp.asarray(False))
    )
    converged = done & jnp.isfinite(z).all()

    y_out = y + h * jnp.tensordot(b_vec, z, 1, precision=_EXACT)
    tol = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_out))
    if cfg.radau_error_mode == "radau5":
        # RADAU5's smoothed estimate (tableau.RADAU_MU_REAL note; SciPy
        # radau.py): e = (mu/h I - J)^{-1} (f(t,y) + sum_s EA_s Z_s).  The
        # (mu/h I - J)^{-1} smoothing is what permits running the method at
        # its real order-5 step sizes; the raw embedded difference forces
        # h ~ tol^(1/3).
        f0e, j_base = _fd_jacobian_and_f(rhs_t, t, y)
        mu = jnp.asarray(tableau.RADAU_MU_REAL, dtype)
        ea_vec = jnp.asarray(tableau.RADAU_ERR_EA, dtype)
        m2 = (mu / h) * jnp.eye(n, dtype=dtype) - j_base
        defect = f0e + jnp.tensordot(ea_vec, z, 1, precision=_EXACT)
        e = jnp.linalg.solve(m2, defect)
        err = jnp.max(jnp.abs(e / tol))
        if retry_on_reject:
            # RADAU5's rejected-step correction (SciPy radau.py, H&W): when
            # a previous attempt at this t already rejected and the raw
            # estimate still reads > 1, re-evaluate the defect's f at the
            # PERTURBED state y + e — on stiff components the raw estimate
            # overestimates by O(h*lambda) and the corrected one collapses
            # to the true size, avoiding futile h-halving spirals.
            e2 = jnp.linalg.solve(m2, rhs_t(t, y + e) + defect - f0e)
            err2 = jnp.max(jnp.abs(e2 / tol))
            err = jnp.where((err > 1.0) & was_rejected, err2, err)
    else:
        y_err = h * jnp.tensordot(e_vec, z, 1, precision=_EXACT)
        err = jnp.max(jnp.abs(y_err / tol))
    return y_out, err, z, n_newton, converged


def radau_dense(y, z, h, theta):
    """Collocation dense output: y + h * sum_s I_s(theta) Z_s (see tableau)."""
    w = jnp.asarray(tableau.RADAU_DENSE, y.dtype)  # [3, 3]
    qm = jnp.tensordot(w.T, z, 1, precision=_EXACT)  # [3, N]; row m multiplies theta^(m+1)
    th = jnp.asarray(theta)[..., None]
    poly = qm[0] * th + qm[1] * th**2 + qm[2] * th**3
    return y + h * poly


class _Carry(NamedTuple):
    t: jax.Array
    h: jax.Array
    y: jax.Array
    next_q: jax.Array
    next_qt: jax.Array  # cached qt[next_q] (see rk45.fill_dense_queries)
    reject: jax.Array  # consecutive rejections (bail-out; no reference analog)
    n_acc: jax.Array
    n_rej: jax.Array
    n_att: jax.Array
    n_newt: jax.Array
    z_prev: jax.Array  # [3, N] last attempt's converged stage slopes
    h_prev: jax.Array  # step size the slopes belong to
    z_base: jax.Array  # theta offset of the new step vs that poly (1=accept)
    have_z: jax.Array  # bool: z_prev is valid (False before the 1st attempt)
    dense: jax.Array


def _radau_system(rhs, gather, t0, tf, qt, y0, h0, cfg: SolverConfig,
                  step_cap=None):
    dtype = y0.dtype
    n = y0.shape[0]
    q_total = 0 if qt is None else qt.shape[0]
    t0 = jnp.asarray(t0, dtype)
    tf = jnp.asarray(tf, dtype)
    i32 = jnp.int32

    if q_total > 0 and cfg.fill_t0_queries:
        dense0 = jnp.where((qt <= t0)[:, None], y0[None, :], jnp.zeros((q_total, n), dtype))
    else:
        dense0 = jnp.zeros((q_total, n), dtype)

    carry0 = _Carry(
        t=t0,
        h=jnp.asarray(h0, dtype),
        y=y0,
        next_q=jnp.zeros((), i32),
        next_qt=(qt[0] if q_total > 0 else jnp.asarray(jnp.inf, dtype)),
        reject=jnp.zeros((), i32),
        n_acc=jnp.zeros((), i32),
        n_rej=jnp.zeros((), i32),
        n_att=jnp.zeros((), i32),
        n_newt=jnp.zeros((), i32),
        z_prev=jnp.zeros((3, n), dtype),
        h_prev=jnp.ones((), dtype),
        z_base=jnp.zeros((), dtype),
        have_z=jnp.zeros((), bool),
        dense=dense0,
    )

    def cond(c: _Carry):
        return (
            (c.t < tf)
            & (c.n_att < cfg.max_steps)
            & (c.reject <= cfg.radau_max_rejects)
        )

    def body(c: _Carry):
        h_eff = jnp.where(c.t + c.h > tf, tf - c.t, c.h)
        if step_cap is not None:
            # ZOH boundary alignment (SolverConfig.forcing_step_align).
            h_eff = step_cap(c.t, h_eff)
        f_vals = gather(c.t) if gather is not None else None

        def rhs_t(tt, yy):
            return rhs(tt, yy, f_vals)

        if cfg.radau_predictor:
            # RADAU5's extrapolated Newton start (H&W vol II IV.8), done in
            # VALUE space: predict the stage VALUES from the previous
            # attempt's collocation polynomial P, then map the increments
            # through A^{-1} to the slope unknowns,
            #     Z0_i = (1/h) * sum_j A^{-1}[i,j] * (P(theta_j) - y).
            # Round 3 extrapolated the SLOPES directly, which is
            # ill-conditioned for stiff lanes (slope error ~ ||J|| * value
            # error): attempts blew up ~30x.  theta is measured
            # in the previous polynomial's coordinates: base 1 after an
            # accept (y = P(1), extrapolation), base 0 after a reject
            # (y = P(0), interpolation inside the failed step).
            ratio = h_eff / c.h_prev
            theta = c.z_base + jnp.asarray(tableau.RADAU_C, dtype) * ratio  # [3]
            w = jnp.asarray(tableau.RADAU_DENSE, dtype)  # [3, 3]
            pw = jnp.stack([theta, theta**2, theta**3])  # [m, i]
            pw0 = jnp.stack([c.z_base, c.z_base**2, c.z_base**3])  # [m]
            i_th = jnp.matmul(w, pw - pw0[:, None], precision=_EXACT)  # [s, i]: I_s(theta_i) - I_s(base)
            v = c.h_prev * jnp.einsum("si,sn->in", i_th, c.z_prev, precision=_EXACT)  # [i, N]
            inv_a = jnp.asarray(tableau.RADAU_A_INV, dtype)
            z_pred = jnp.matmul(inv_a, v, precision=_EXACT) / h_eff  # [3, N]
            f0 = rhs_t(c.t, c.y)
            use = c.have_z & (ratio <= 2.0)
            z0 = jnp.where(use, z_pred, jnp.tile(f0, (3, 1)))
        else:
            z0 = None

        y_next, err, z, n_newt, newt_ok = radau_step(
            rhs_t, c.t, c.y, h_eff, cfg.rtol, cfg.atol, cfg, z0=z0,
            retry_on_reject=cfg.radau_error_mode == "radau5",
            was_rejected=c.reject > 0,
        )
        # A step whose Newton iteration did NOT converge is rejected
        # unconditionally with h/2 (RADAU5's rule): its Z is not the
        # collocation solution, so the embedded error estimate computed from
        # it is meaningless and can pass the accept test with arbitrarily
        # wrong states — measured 0.28 absolute error (5e4 tolerance units)
        # in h_snow on the stiff bench scenario before this guard, from
        # silently accepted unconverged steps at large h.
        accept = (err <= 1.0) & (newt_ok | (not cfg.newton_reject_unconverged))

        if q_total > 0:
            dense_eval = lambda th: radau_dense(c.y, z, h_eff, th)
            dense, next_q, next_qt = fill_dense_queries(
                cfg, qt, c.dense, c.next_q, c.next_qt, c.t, h_eff, dense_eval, accept
            )
        else:
            dense, next_q, next_qt = c.dense, c.next_q, c.next_qt

        # Step-control exponent: 1/(est_order + 1).  'reference' uses the
        # reference's 1/5 (radau_kernel.cu:123); 'embedded3' pairs 1/3 with
        # the order-2-embedded estimate; 'radau5' pairs 1/4 with the
        # smoothed estimate plus RADAU5's Newton-effort-aware safety
        # 0.9*(2M+1)/(2M+n_iter) (a step that worked Newton hard gets less
        # growth headroom, keeping h clear of the convergence boundary).
        if cfg.radau_error_mode == "radau5":
            expo = 0.25
            m_it = cfg.newton_max_iter
            safety = cfg.safety * (2.0 * m_it + 1.0) / (
                2.0 * m_it + n_newt.astype(c.y.dtype)
            )
        else:
            expo = 1.0 / 3.0 if cfg.radau_error_mode == "embedded3" else 0.2
            safety = cfg.safety
        raw_fac = safety * (1.0 / (err + 1e-16)) ** expo
        fac_acc = jnp.clip(raw_fac, cfg.min_scale, cfg.max_scale)
        fac_rej = jnp.where(jnp.isnan(raw_fac), cfg.nan_shrink, jnp.minimum(raw_fac, 1.0))
        fac_rej = jnp.clip(fac_rej, cfg.min_scale, cfg.max_scale)
        if cfg.newton_reject_unconverged:
            # Newton failure says nothing about the error — halve (RADAU5).
            fac_rej = jnp.where(newt_ok, fac_rej, 0.5)
        h_new = h_eff * jnp.where(accept, fac_acc, fac_rej)
        if cfg.radau_h_freeze_hi > 1.0:
            # RADAU5's step freeze (quot1/quot2): an accepted step whose
            # proposed growth lands in [1, hi] keeps h EXACTLY — damps the
            # few-percent h oscillation that re-rolls the error estimate
            # across the accept threshold near the boundary.
            freeze = accept & (fac_acc >= 1.0) & (fac_acc <= cfg.radau_h_freeze_hi)
            h_new = jnp.where(freeze, h_eff, h_new)

        return _Carry(
            t=jnp.where(accept, c.t + h_eff, c.t),
            h=h_new,
            y=jnp.where(accept, y_next, c.y),
            next_q=next_q,
            next_qt=next_qt,
            reject=jnp.where(accept, 0, c.reject + 1),
            n_acc=c.n_acc + accept.astype(i32),
            n_rej=c.n_rej + (~accept).astype(i32),
            n_att=c.n_att + 1,
            n_newt=c.n_newt + n_newt,
            # Only a CONVERGED Newton solution may seed the next attempt's
            # predictor (RADAU5 semantics): an unconverged z poisons the
            # start, which makes the next Newton fail too — a self-
            # sustaining loop that pinned sweeps at max_iter and blew
            # attempts ~30x before this gate.
            z_prev=z,
            h_prev=h_eff,
            z_base=jnp.where(accept, 1.0, 0.0).astype(dtype),
            have_z=newt_ok & jnp.isfinite(z).all(),
            dense=dense,
        )

    out = lax.while_loop(cond, body, carry0)
    completed = out.t >= tf
    failed = ~completed
    y_final = jnp.where(completed, out.y, jnp.full_like(out.y, jnp.nan))
    stats = RadauStats(
        n_accepted=out.n_acc, n_rejected=out.n_rej, n_attempts=out.n_att,
        n_newton=out.n_newt,
    )
    return RadauResult(y_final=y_final, dense=out.dense, failed=failed, stats=stats)


import functools


@functools.partial(jax.jit, static_argnames=("model", "t0", "tf", "meta", "config"))
def _radau_solve_impl(model, y0, t0, tf, qt, params, forc_data, meta, h0, config,
                      t_shift=0.0):
    from tiger_tpu.solver.rk45 import vmap_system_solve

    return vmap_system_solve(
        model, _radau_system, y0, h0, params, forc_data, meta,
        t0, tf, qt, config, t_shift,
    )


def radau_solve(
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
) -> RadauResult:
    """Batched Radau IIA integration of ``y0[S, N]`` from t0 to tf.

    Called by tiger_tpu.solver.api.solve on the compacted stiff subset; also
    usable standalone.  Jitted internally.  ``h0`` defaults to the RK45
    initial step (the reference reuses devParams.initialStep,
    radau_kernel.cu:50).
    """
    y0 = jnp.asarray(y0)
    s_count, _ = y0.shape
    if h0 is None:
        from tiger_tpu.solver.controller import initial_step

        h0 = initial_step(model, y0, t0, params, forcings, config)
    h0 = jnp.broadcast_to(jnp.asarray(h0, y0.dtype), (s_count,))
    qt = None if query_times is None else jnp.asarray(query_times, y0.dtype)
    forc_data = None if forcings is None else forcings.data
    meta = None if forcings is None else forcings.meta
    return _radau_solve_impl(
        model, y0, float(t0), float(tf), qt, params, forc_data, meta, h0, config,
        jnp.asarray(t_shift, y0.dtype),
    )
