"""Pallas kernel (Triton route): fused batched Radau IIA (implicit) integration.

Companion to rk45_pallas for the stiff subset, in the reference's shape
(radau_kernel.cu:20-140: one CUDA thread per stiff system with a per-thread
LU solve): one lane per system in 1-D blocks, the ENTIRE t0->tf implicit
integration in one kernel with the state in registers.  The 3N x 3N
simplified-Newton system is solved in the eigenbasis of A^{-1} (RADAU5's
linear algebra, tableau._radau_eig): one real and one complex N x N unpivoted
Doolittle LU per attempt, unrolled per lane — ~5x fewer factorization FLOPs
than the (3N)^2 LU the reference factors (small_lu.cuh:13-40).

Numerics follow tiger_tpu.solver.radau with ONE deliberate divergence: the
Jacobian is evaluated ONCE per attempted step at (t, y) — the standard
simplified Newton of production Radau codes (Hairer's RADAU5) — rather than
at every stage point on every Newton iteration (radau_step_dense.cuh:96-129).
The embedded error weights and step controller match
SolverConfig.radau_error_mode.  Cross-step factor reuse
(SolverConfig.radau_factor_reuse) carries the factors across attempts and
refreshes them when any lane of the block votes for it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl

from tiger_tpu.forcing import ForcingSet, ZOH_SNAP, zoh_step_cap
from tiger_tpu.kernels.rk45_pallas import (
    block_lanes,
    check_sorted_queries,
    compiler_params,
    fill_dense,
    gather_forcings,
    init_dense,
    nan_max,
    pad_lanes,
)
from tiger_tpu.solver import tableau
from tiger_tpu.solver.config import SolverConfig
from tiger_tpu.solver.radau import RadauResult, RadauStats

#: Lanes per block: a lane holds >150 live f32 values, so blocks are kept
#: small enough that a stiff straggler holds back few neighbours; see
#: PERF.md for the measurement behind the choice.
BLOCK = 8
_F32_EPS = float(np.finfo(np.float32).eps)


class _Carry(NamedTuple):
    alive: jax.Array  # scalar i32
    t: jax.Array
    t_c: jax.Array  # Kahan compensation
    h: jax.Array
    y: tuple  # N_EQ x (B,)
    reject: jax.Array  # consecutive rejections (bail-out -> failed)
    failed: jax.Array  # bool
    n_acc: jax.Array
    n_rej: jax.Array
    n_att: jax.Array
    n_swp: jax.Array  # Newton sweeps each lane sat through
    n_fct: jax.Array  # factorizations paid
    nq: jax.Array  # dense-output cursor
    nqt: jax.Array
    fact: tuple  # carried eigenbasis factors (cfg.radau_factor_reuse only)
    refresh: jax.Array  # lane wants fresh factors next attempt
    pred: tuple  # Newton-predictor state (cfg.radau_predictor, else empty):
    #              (h_prev, z_base, have, *z_prev[3N])


def _make_kernel(model, param_fields, meta, t0, tf, n_eq, q_total, block,
                 cfg: SolverConfig):
    ra, rc, rb = tableau.RADAU_A, tableau.RADAU_C, tableau.RADAU_B
    re = tableau.RADAU_E3 if cfg.radau_error_mode == "embedded3" else tableau.RADAU_E
    rw = tableau.RADAU_DENSE  # (3,3): I_s(theta) monomial coefficients
    expo = {"embedded3": 1.0 / 3.0, "radau5": 0.25, "reference": 0.2}[
        cfg.radau_error_mode
    ]
    radau5_err = cfg.radau_error_mode == "radau5"
    n_stack = 3 * n_eq
    nsq = n_eq * n_eq
    snap = ZOH_SNAP if (cfg.forcing_step_align and meta is not None) else 0.0
    i32 = jnp.int32
    gam = float(tableau.RADAU_EIG_GAMMA)
    alp = float(tableau.RADAU_EIG_ALPHA)
    bet = float(tableau.RADAU_EIG_BETA)
    v1 = [float(tableau.RADAU_EIG_V[s, 0].real) for s in range(3)]
    v2r = [float(tableau.RADAU_EIG_V[s, 1].real) for s in range(3)]
    v2i = [float(tableau.RADAU_EIG_V[s, 1].imag) for s in range(3)]
    p1 = [float(tableau.RADAU_EIG_P[0, j].real) for j in range(3)]
    p2r = [float(tableau.RADAU_EIG_P[1, j].real) for j in range(3)]
    p2i = [float(tableau.RADAU_EIG_P[1, j].imag) for j in range(3)]
    # Convergence: the reference's absolute max|delta| < newton_tol OR
    # RADAU5's scaled solution-units criterion (mirror of solver/radau.py);
    # the absolute exit alone is unreachable in float32 for stiff lanes.
    kappa = max(10.0 * _F32_EPS / cfg.rtol, min(0.03, float(np.sqrt(cfg.rtol))))
    # dtype-aware FD step: the reference's sqrt(1e-16)=1e-8
    # (radau_step_dense.cuh:20) is below float32 resolution.
    fd_eps = float(np.sqrt(_F32_EPS))

    def kernel(shift_ref, qt_ref, y0_ref, h0_ref, params_ref, forc_ref,
               yf_ref, failed_ref, stats_ref, *dense):
        dense_ref = dense[0] if dense else None
        sl, lanes = block_lanes(block)
        y0 = tuple(y0_ref[i, sl] for i in range(n_eq))
        shift = shift_ref[0]
        p_base = {name: params_ref[k, sl] for k, name in enumerate(param_fields)}
        if param_fields and hasattr(model, "derived_params"):
            p_base = model.derived_params(p_base)  # hoisted loop invariants

        def rhs(t, y, f_vals):
            return model.rhs_tuple(t + shift, y, p_base, f_vals)

        if q_total > 0:
            init_dense(dense_ref, qt_ref, sl, y0, t0, q_total, cfg.fill_t0_queries)

        zf = jnp.zeros((block,), jnp.float32)
        zi = jnp.zeros((block,), i32)

        def compute_factors(t, y, f0, f_vals, h_eff):
            """FD Jacobian at (t, y) + the transformed Newton factorization
            (RADAU5 linear algebra, H&W vol II IV.8): (I - h A (x) J) is
            similar to blockdiag(gamma I - h J, (alpha+beta i) I - h J,
            conj), so ONE real and ONE complex n x n unpivoted LU replace
            the (3N)^2 one.  Returns the flat factor tuple (h_fact,
            mr[N*N], mr_inv_diag[N], cre[N*N], cim[N*N], c_invd_re[N],
            c_invd_im[N])."""
            jac = [[None] * n_eq for _ in range(n_eq)]
            for j in range(n_eq):
                h_eps = fd_eps * jnp.maximum(1.0, jnp.abs(y[j]))
                y_pert = tuple(y[i] + h_eps if i == j else y[i] for i in range(n_eq))
                f_p = rhs(t, y_pert, f_vals)
                for i in range(n_eq):
                    jac[i][j] = (f_p[i] - f0[i]) / h_eps
            mr = [
                [(gam - h_eff * jac[i][j]) if i == j else (-h_eff) * jac[i][j]
                 for j in range(n_eq)]
                for i in range(n_eq)
            ]
            mr_inv = [None] * n_eq
            for k in range(n_eq):
                mr_inv[k] = 1.0 / mr[k][k]
                for i in range(k + 1, n_eq):
                    m_ik = mr[i][k] * mr_inv[k]
                    mr[i][k] = m_ik
                    for j in range(k + 1, n_eq):
                        mr[i][j] = mr[i][j] - m_ik * mr[k][j]
            cre = [
                [(alp - h_eff * jac[i][j]) if i == j else (-h_eff) * jac[i][j]
                 for j in range(n_eq)]
                for i in range(n_eq)
            ]
            cim = [[(zf + bet) if i == j else zf for j in range(n_eq)]
                   for i in range(n_eq)]
            c_invd = [None] * n_eq  # (re, im) of 1 / diag
            for k in range(n_eq):
                inv_den = 1.0 / (cre[k][k] * cre[k][k] + cim[k][k] * cim[k][k])
                c_invd[k] = (cre[k][k] * inv_den, -cim[k][k] * inv_den)
                for i in range(k + 1, n_eq):
                    m_re = cre[i][k] * c_invd[k][0] - cim[i][k] * c_invd[k][1]
                    m_im = cre[i][k] * c_invd[k][1] + cim[i][k] * c_invd[k][0]
                    cre[i][k], cim[i][k] = m_re, m_im
                    for j in range(k + 1, n_eq):
                        cre[i][j] = cre[i][j] - (m_re * cre[k][j] - m_im * cim[k][j])
                        cim[i][j] = cim[i][j] - (m_re * cim[k][j] + m_im * cre[k][j])
            flat = [h_eff + zf]
            flat += [mr[i][j] for i in range(n_eq) for j in range(n_eq)]
            flat += mr_inv
            flat += [cre[i][j] for i in range(n_eq) for j in range(n_eq)]
            flat += [cim[i][j] for i in range(n_eq) for j in range(n_eq)]
            flat += [c_invd[k][0] for k in range(n_eq)]
            flat += [c_invd[k][1] for k in range(n_eq)]
            return tuple(flat)

        n_fact = 1 + 3 * nsq + 3 * n_eq
        carry0 = _Carry(
            alive=jnp.ones((), i32),
            t=zf + t0,
            t_c=zf,
            h=h0_ref[sl],
            y=y0,
            reject=zi,
            failed=zi > 0,
            n_acc=zi,
            n_rej=zi,
            n_att=zi,
            n_swp=zi,
            n_fct=zi,
            nq=zi,
            nqt=(zf + qt_ref[0]) if q_total > 0 else zf + jnp.inf,
            fact=tuple(zf for _ in range(n_fact)) if cfg.radau_factor_reuse else (),
            # Every lane votes refresh before the first attempt.
            refresh=zi + 1,
            pred=(
                (zf + 1.0, zf, zi > 0) + tuple(zf for _ in range(n_stack))
                if cfg.radau_predictor
                else ()
            ),
        )

        def body(c):
            act = (c.t < tf) & ~c.failed & (c.n_att < cfg.max_steps)
            t, y = c.t, c.y
            h_eff = jnp.where(t + c.h > tf, tf - t, c.h)
            if snap:
                h_eff = zoh_step_cap(meta, t, h_eff)
            f_vals = None
            if meta is not None:
                f_vals = gather_forcings(forc_ref, meta, t, lanes, snap)
            f0 = rhs(t, y, f_vals)

            if cfg.radau_factor_reuse:
                # Recompute Jacobian + both LUs only when some active lane
                # voted for a refresh: Newton contraction slowed or failed
                # last attempt, or h left the safety band around the
                # factored h (SolverConfig.radau_factor_reuse).
                ratio0 = h_eff / c.fact[0]
                band_bad = (
                    (ratio0 < cfg.radau_reuse_lo)
                    | (ratio0 > cfg.radau_reuse_hi)
                    | jnp.isnan(ratio0)
                )
                refresh_now = jnp.max(
                    (act & ((c.refresh > 0) | band_bad)).astype(i32)
                )
                fact = lax.cond(
                    refresh_now > 0,
                    lambda: compute_factors(t, y, f0, f_vals, h_eff),
                    lambda: c.fact,
                )
            else:
                refresh_now = jnp.ones((), i32)
                fact = compute_factors(t, y, f0, f_vals, h_eff)

            h_fact = fact[0]
            mr = [[fact[1 + i * n_eq + j] for j in range(n_eq)] for i in range(n_eq)]
            mr_inv_diag = [fact[1 + nsq + k] for k in range(n_eq)]
            o = 1 + nsq + n_eq
            cre = [[fact[o + i * n_eq + j] for j in range(n_eq)] for i in range(n_eq)]
            cim = [[fact[o + nsq + i * n_eq + j] for j in range(n_eq)]
                   for i in range(n_eq)]
            o2 = o + 2 * nsq
            c_invd = [(fact[o2 + k], fact[o2 + n_eq + k]) for k in range(n_eq)]

            def real_solve(bvec):
                x = list(bvec)
                for k in range(n_eq):
                    for i in range(k + 1, n_eq):
                        x[i] = x[i] - mr[i][k] * x[k]
                for k in reversed(range(n_eq)):
                    acc = x[k]
                    for j in range(k + 1, n_eq):
                        acc = acc - mr[k][j] * x[j]
                    x[k] = acc * mr_inv_diag[k]
                return x

            def cplx_solve(b_re, b_im):
                xr, xi = list(b_re), list(b_im)
                for k in range(n_eq):
                    for i in range(k + 1, n_eq):
                        xr[i] = xr[i] - (cre[i][k] * xr[k] - cim[i][k] * xi[k])
                        xi[i] = xi[i] - (cre[i][k] * xi[k] + cim[i][k] * xr[k])
                for k in reversed(range(n_eq)):
                    ar, ai = xr[k], xi[k]
                    for j in range(k + 1, n_eq):
                        ar = ar - (cre[k][j] * xr[j] - cim[k][j] * xi[j])
                        ai = ai - (cre[k][j] * xi[j] + cim[k][j] * xr[j])
                    xr[k] = ar * c_invd[k][0] - ai * c_invd[k][1]
                    xi[k] = ar * c_invd[k][1] + ai * c_invd[k][0]
                return xr, xi

            def solve_newton(bvec):
                """(I - h A (x) J)^{-1} b via the eigenbasis: u = (P (x) I) b,
                one real + one complex n x n solve, dZ = V w + conj."""
                def mix(p):
                    return [p[0] * bvec[i] + p[1] * bvec[n_eq + i]
                            + p[2] * bvec[2 * n_eq + i] for i in range(n_eq)]

                w1 = real_solve(mix(p1))
                wr, wi = cplx_solve(mix(p2r), mix(p2i))
                return [
                    v1[s] * w1[i] + 2.0 * (v2r[s] * wr[i] - v2i[s] * wi[i])
                    for s in range(3)
                    for i in range(n_eq)
                ]

            if cfg.radau_predictor:
                # RADAU5's extrapolated Newton start in VALUE space (mirror
                # of solver/radau.py): stage values predicted from the
                # previous attempt's collocation polynomial, mapped through
                # A^{-1} to the slope unknowns; lanes without a converged
                # previous solution (or too far past it) start from f0.
                h_prev, z_base, have = c.pred[0], c.pred[1], c.pred[2]
                zp = c.pred[3:]
                ratio = h_eff / h_prev
                use = have & (ratio <= 2.0)
                base2 = z_base * z_base
                base3 = base2 * z_base
                i_th = [[None] * 3 for _ in range(3)]
                for i in range(3):
                    th = z_base + float(rc[i]) * ratio
                    th2 = th * th
                    for s in range(3):
                        i_th[s][i] = (
                            float(rw[s, 0]) * (th - z_base)
                            + float(rw[s, 1]) * (th2 - base2)
                            + float(rw[s, 2]) * (th2 * th - base3)
                        )
                inv_a = tableau.RADAU_A_INV
                scale = h_prev / h_eff
                z = []
                for i in range(3):
                    for k in range(n_eq):
                        acc = zf
                        for j in range(3):
                            vjk = (i_th[0][j] * zp[k] + i_th[1][j] * zp[n_eq + k]
                                   + i_th[2][j] * zp[2 * n_eq + k])
                            acc = acc + float(inv_a[i, j]) * vjk
                        z.append(jnp.where(use, scale * acc, f0[k]))
            else:
                z = [f0[i % n_eq] for i in range(n_stack)]  # Z[s*n_eq+i]

            tol_y = tuple(cfg.atol + cfg.rtol * jnp.abs(y[i]) for i in range(n_eq))

            def sweep(z, conv):
                bvec = []
                for s in range(3):
                    ys = list(y)
                    for j in range(3):
                        a_w = float(ra[s, j])
                        ys = [ys[i] + (h_eff * a_w) * z[j * n_eq + i] for i in range(n_eq)]
                    fs = rhs(t + float(rc[s]) * h_eff, tuple(ys), f_vals)
                    for i in range(n_eq):
                        bvec.append(fs[i] - z[s * n_eq + i])
                delta = solve_newton(bvec)
                maxd, zmag, scaled = zf, zf, zf
                z = list(z)
                for a in range(n_stack):
                    z[a] = jnp.where(conv, z[a], z[a] + delta[a])
                    ad = jnp.abs(delta[a])
                    maxd = nan_max(maxd, ad)
                    scaled = nan_max(scaled, ad / tol_y[a % n_eq])
                    zmag = nan_max(zmag, jnp.abs(z[a]))
                tol_eff = cfg.newton_tol + (8.0 * _F32_EPS) * zmag
                done = (maxd < tol_eff) | (h_eff * scaled < kappa) | jnp.isnan(maxd)
                return z, conv | done

            # Newton sweeps until every active lane of the block converged
            # (inactive lanes start converged), at most newton_max_iter.
            def ncond(s):
                return s[0] > 0

            def nbody(s):
                _, it, z, conv, n_swp = s
                n_swp = n_swp + (~conv).astype(i32)
                z, conv = sweep(list(z), conv)
                it = it + 1
                alive = jnp.max((~conv).astype(i32)) * (it < cfg.newton_max_iter)
                return alive, it, tuple(z), conv, n_swp

            conv0 = ~act
            _, _, z, conv, n_swp_step = lax.while_loop(
                ncond, nbody,
                (jnp.max(act.astype(i32)), jnp.zeros((), i32), tuple(z), conv0, zi),
            )
            z = list(z)

            # ---- step update + error estimate ----
            y_out = list(y)
            for s in range(3):
                for i in range(n_eq):
                    y_out[i] = y_out[i] + (h_eff * float(rb[s])) * z[s * n_eq + i]
            tol_i = [cfg.atol + cfg.rtol * jnp.maximum(jnp.abs(y[i]), jnp.abs(y_out[i]))
                     for i in range(n_eq)]
            err = zf
            if radau5_err:
                # RADAU5's smoothed estimate (mirror of solver/radau.py):
                # e = (mu/h I - J)^{-1} (f0 + sum_s EA_s Z_s), and mu IS the
                # real eigenvalue gamma, so (mu/h I - J)^{-1} = h M_r^{-1}
                # reuses the Newton factorization.  h_fact, not h_eff: the
                # identity holds for the h the factors were built with.
                ea = tableau.RADAU_ERR_EA
                defect = [f0[i] + float(ea[0]) * z[i] + float(ea[1]) * z[n_eq + i]
                          + float(ea[2]) * z[2 * n_eq + i] for i in range(n_eq)]
                e_vecs = [h_fact * v for v in real_solve(defect)]
                for i in range(n_eq):
                    err = nan_max(err, jnp.abs(e_vecs[i] / tol_i[i]))
                # Rejected-step correction (mirror of solver/radau.py):
                # re-evaluate the defect's f at y + e on lanes with a
                # rejection streak whose raw estimate still reads > 1.
                lane_retry = act & (err > 1.0) & (c.reject > 0)

                def with_retry(err_in):
                    y_p = tuple(y[i] + e_vecs[i] for i in range(n_eq))
                    f_p = rhs(t, y_p, f_vals)
                    b2 = [f_p[i] + defect[i] - f0[i] for i in range(n_eq)]
                    e2 = [h_fact * v for v in real_solve(b2)]
                    err2 = zf
                    for i in range(n_eq):
                        err2 = nan_max(err2, jnp.abs(e2[i] / tol_i[i]))
                    return jnp.where(lane_retry, err2, err_in)

                err = lax.cond(
                    jnp.max(lane_retry.astype(i32)) > 0, with_retry, lambda e: e, err
                )
            else:
                for i in range(n_eq):
                    err_c = zf
                    for s in range(3):
                        err_c = err_c + (h_eff * float(re[s])) * z[s * n_eq + i]
                    err = nan_max(err, jnp.abs(err_c / tol_i[i]))

            # Honest rejection (RADAU5): an unconverged Newton has a
            # meaningless Z, whatever its error estimate says.
            newt_fail = ~conv if cfg.newton_reject_unconverged else zi > 0
            accept = act & (err <= 1.0) & ~newt_fail
            rejected = act & ~accept

            kh = h_eff - c.t_c
            t1 = t + kh

            nq, nqt = c.nq, c.nqt
            if q_total > 0:
                def interp(theta):
                    th2 = theta * theta
                    out = []
                    for i in range(n_eq):
                        qm = [zf, zf, zf]
                        for m in range(3):
                            for s in range(3):
                                qm[m] = qm[m] + float(rw[s, m]) * z[s * n_eq + i]
                        out.append(y[i] + h_eff * (qm[0] * theta + qm[1] * th2
                                                   + qm[2] * th2 * theta))
                    return out

                nq, nqt = fill_dense(
                    dense_ref, qt_ref, lanes, q_total, n_eq, accept, t, t1,
                    h_eff, nq, nqt, interp,
                )

            if radau5_err:
                # Newton-effort-aware safety (RADAU5; mirror of
                # solver/radau.py).
                m_it = float(cfg.newton_max_iter)
                safety = cfg.safety * (2.0 * m_it + 1.0) / (
                    2.0 * m_it + n_swp_step.astype(jnp.float32)
                )
            else:
                safety = cfg.safety
            raw_fac = safety * (1.0 / (err + 1e-16)) ** expo
            fac_acc = jnp.clip(raw_fac, cfg.min_scale, cfg.max_scale)
            fac_rej = jnp.where(jnp.isnan(raw_fac), cfg.nan_shrink, jnp.minimum(raw_fac, 1.0))
            fac_rej = jnp.clip(fac_rej, cfg.min_scale, cfg.max_scale)
            if cfg.newton_reject_unconverged:
                fac_rej = jnp.where(newt_fail, 0.5, fac_rej)
            h_new = h_eff * jnp.where(accept, fac_acc, fac_rej)
            if cfg.radau_h_freeze_hi > 1.0:
                # RADAU5's step freeze (mirror of solver/radau.py).
                freeze = accept & (fac_acc >= 1.0) & (fac_acc <= cfg.radau_h_freeze_hi)
                h_new = jnp.where(freeze, h_eff, h_new)

            if cfg.radau_factor_reuse:
                stale = (n_swp_step >= cfg.radau_refresh_sweeps) | newt_fail
                refresh_new = jnp.where(act, stale.astype(i32), c.refresh)
                n_fct_new = c.n_fct + act.astype(i32) * refresh_now
            else:
                refresh_new = c.refresh
                n_fct_new = c.n_fct + act.astype(i32)

            reject_new = jnp.where(accept, 0, c.reject + 1)
            failed_new = c.failed | (rejected & (reject_new > cfg.radau_max_rejects))
            t_new = jnp.where(accept, t1, t)
            n_att_new = c.n_att + act.astype(i32)
            still = (t_new < tf) & ~failed_new & (n_att_new < cfg.max_steps)
            if cfg.radau_predictor:
                # Only a CONVERGED, finite Newton solution may seed the next
                # attempt's predictor (RADAU5 semantics).
                finite = conv
                for a in range(n_stack):
                    finite = finite & jnp.isfinite(z[a])
                pred_new = (
                    jnp.where(act, h_eff, c.pred[0]),
                    jnp.where(accept, 1.0, jnp.where(act, 0.0, c.pred[1])),
                    jnp.where(act, finite, c.pred[2]),
                ) + tuple(jnp.where(act, z[a], c.pred[3 + a]) for a in range(n_stack))
            else:
                pred_new = ()
            return _Carry(
                alive=jnp.max(still.astype(i32)),
                t=t_new,
                t_c=jnp.where(accept, (t1 - t) - kh, c.t_c),
                h=jnp.where(act, h_new, c.h),
                y=tuple(jnp.where(accept, y_out[i], y[i]) for i in range(n_eq)),
                reject=jnp.where(act, reject_new, c.reject),
                failed=failed_new,
                n_acc=c.n_acc + accept.astype(i32),
                n_rej=c.n_rej + rejected.astype(i32),
                n_att=n_att_new,
                n_swp=c.n_swp + n_swp_step,
                n_fct=n_fct_new,
                nq=nq,
                nqt=nqt,
                fact=fact if cfg.radau_factor_reuse else (),
                refresh=refresh_new,
                pred=pred_new,
            )

        out = lax.while_loop(lambda c: c.alive > 0, body, carry0)

        completed = out.t >= tf
        for i in range(n_eq):
            yf_ref[i, sl] = jnp.where(completed, out.y[i], jnp.nan)
        failed_ref[sl] = (out.failed | ~completed).astype(i32)
        stats_ref[0, sl] = out.n_acc
        stats_ref[1, sl] = out.n_rej
        stats_ref[2, sl] = out.n_att
        stats_ref[3, sl] = out.n_swp
        stats_ref[4, sl] = out.n_fct

    return kernel


def radau_solve_pallas(
    model,
    y0: jax.Array,
    t0,
    tf,
    query_times=None,
    params=None,
    forcings: Optional[ForcingSet] = None,
    h0=None,
    config: SolverConfig = SolverConfig(),
    interpret: bool = False,
    t_shift=0.0,
) -> RadauResult:
    """Fused-kernel Radau IIA over ``y0[S, N]`` (float32 path).

    ``t_shift``: traced absolute-time offset seen by the model rhs only
    (see rk45_solve_pallas)."""
    from tiger_tpu.solver.controller import initial_step

    y0 = jnp.asarray(y0, jnp.float32)
    s_count = y0.shape[0]
    if h0 is None:
        h0 = initial_step(model, y0, t0, params, forcings, config)
    h0 = jnp.broadcast_to(jnp.asarray(h0, jnp.float32), (s_count,))
    param_fields = tuple(sorted(params.keys())) if params is not None else ()
    return _pipeline(
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
def _pipeline(
    model, y0, h0, params, forc_data, query_times,
    t0, tf, meta, config, param_fields, interpret,
    t_shift=0.0,
):
    s_count, n_eq = y0.shape
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
        jax.ShapeDtypeStruct((s_pad,), jnp.int32),
        jax.ShapeDtypeStruct((5, s_pad), jnp.int32),
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
        name="radau_dense",
    )(jnp.reshape(jnp.asarray(t_shift, f32), (1,)), qt_m, y0_m, h0_m, p_m, f_m)
    yf, failed, stats = outs[:3]
    if q_total > 0:
        dense = outs[3].reshape(q_total, n_eq, s_pad)[:, :, :s_count]
        dense = dense.transpose(2, 0, 1)
    else:
        dense = jnp.zeros((s_count, 0, n_eq), f32)
    stats = stats[:, :s_count]
    return RadauResult(
        y_final=yf[:, :s_count].T,
        dense=dense,
        failed=failed[:s_count] > 0,
        stats=RadauStats(
            n_accepted=stats[0], n_rejected=stats[1], n_attempts=stats[2],
            n_newton=stats[3], n_fact=stats[4],
        ),
    )
