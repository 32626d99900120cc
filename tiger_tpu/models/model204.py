"""Model 204: 5-equation snow / static / surface / grav / aquifer runoff model.

Physics match the reference exactly (src/models/model_204.hpp:43-114; Python
twin: notebook cell 12).  State y = [h_snow, h_static, h_surface, h_grav,
h_aquifer] in meters; time t in MINUTES.  Forcings: F[0] = rainfall [m/min],
F[1] = temperature [degC]; missing forcings default to 0 (model_204.hpp:80-82).

Spatial parameter fields (per system; see tiger_tpu.params for the CSV loader
and unit conversions, reference src/I_O/parameters_loader.cpp:35-101):
  c1 [m/min per mm/hr], infil, perco [m/min], Hu [m], lat [deg], sw, ss [-],
  n_mann [-], slope [-], L [km], A_h [km^2], alpha3, alpha4 [min],
  melt_f [m/min/degC], temp_thr [degC].

Notes kept for parity:
  - ET is the linear stub Emax = min(0.1*T, h_static) scaled by s = h_static/Hu
    ("later base it on HamonPET", notebook cell 11).  HamonPET / ETactual /
    soiltemp live in tiger_tpu.models.et / .soiltemp for future variants.
  - Manning term uses h_surface**(2/3): like CUDA ``pow``, jnp.power returns
    NaN for negative base, which downstream makes the step reject (err
    comparisons are False for NaN) exactly as on the GPU.
  - ``doy = 1 + t/1440`` is computed but unused by the active physics
    (model_204.hpp:84) — not reproduced here.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

def _pow23(x):
    """x**(2/3) for clamped x >= 0: exp((2/3)*log(max(x, 1e-30))).

    Skips ``jnp.power``'s generic edge-case handling (negative-base/NaN
    selects), which the RHS pays 7x per attempted step.  x=0 maps to
    ~1e-20, absorbed by the min(1, .) that follows in the Manning term; max
    f32 relative error 6e-7, below the production path's f32 working
    precision.  exp/log rather than exp2/log2: on an NVIDIA GPU the fused
    kernel (Triton, libdevice) and XLA evaluate exp and log bit for bit alike
    but exp2 differently, and that last-bit difference flips borderline
    stiffness flags between the kernel and the vmap path.  The parity path
    (safe_pow=False) keeps jnp.power for its NaN-on-negative semantics.
    """
    xc = jnp.maximum(x, jnp.asarray(1e-30, x.dtype))
    return jnp.exp((2.0 / 3.0) * jnp.log(xc))


#: Parameter keys expected in the per-system params dict.
PARAM_FIELDS = (
    "c1",
    "infil",
    "perco",
    "Hu",
    "lat",
    "sw",
    "ss",
    "n_mann",
    "slope",
    "L",
    "A_h",
    "alpha3",
    "alpha4",
    "melt_f",
    "temp_thr",
)


@dataclasses.dataclass(frozen=True)
class Model204:
    N_EQ: int = 5
    UID: int = 204

    # The Manning term h_surface**(2/3) is NaN for the (unphysical) negative
    # surface depths that transiently appear inside RK stage evaluations;
    # CUDA pow does the same, and in the reference such steps reject with an
    # unchanged h until the system is (spuriously) flagged stiff.  Default:
    # clamp the base at 0 (physically exact — Manning outflow is zero at zero
    # depth), which removes the NaNs entirely.  Set safe_pow=False for
    # bit-level behavioral parity with the reference.
    safe_pow: bool = True

    def derived_params(self, params) -> dict:
        """Hoist loop-invariant parameter math out of the RHS.

        The reference recomputes ``(1/n_mann)*sqrt(slope)``, the ``/Hu`` and
        ``/alpha`` divisions etc. on EVERY rhs call (model_204.hpp:98-113) —
        7 evals per attempted step; divides and sqrt are the expensive
        ops.  Solvers call this once per solve/kernel invocation; rhs_tuple
        uses the precomputed keys when present and falls back to raw math
        otherwise (so direct RHS calls and oracle tests are unchanged).
        """
        p = dict(params)
        p["_manning_c"] = (
            jnp.sqrt(p["slope"]) / p["n_mann"] * (p["L"] / p["A_h"] * 60.0)
        )
        p["_inv_Hu"] = 1.0 / p["Hu"]
        p["_inv_a3"] = jnp.where(p["alpha3"] >= 1.0, 1.0 / p["alpha3"], 0.0)
        p["_inv_a4"] = jnp.where(p["alpha4"] >= 1.0, 1.0 / p["alpha4"], 0.0)
        return p

    def rhs_tuple(self, t, y, params, forcings=None) -> tuple:
        """Unstacked RHS (``y``/``forcings`` any indexables; see DummyModel)."""
        P = params
        h_snow, h_stat, h_surf, h_grav, h_aq = y[0], y[1], y[2], y[3], y[4]

        dtype = h_snow.dtype
        if forcings is None:
            rainfall = jnp.zeros((), dtype)
            temperature = jnp.zeros((), dtype)
        else:
            n_forc = len(forcings)
            rainfall = forcings[0].astype(dtype) if n_forc > 0 else jnp.zeros((), dtype)
            temperature = forcings[1].astype(dtype) if n_forc > 1 else jnp.zeros((), dtype)

        # 1) Snow
        snowmelt = jnp.where(
            temperature >= P["temp_thr"],
            jnp.minimum(h_snow, temperature * P["melt_f"]),
            0.0,
        )
        x1 = rainfall + snowmelt
        dy0 = rainfall - snowmelt

        # 2) Static store
        x2 = jnp.maximum(0.0, x1 + h_stat - P["Hu"])
        d1 = x1 - x2
        e_max = jnp.minimum(0.1 * temperature, h_stat)
        s = h_stat * P["_inv_Hu"] if "_inv_Hu" in P else h_stat / P["Hu"]
        dy1 = d1 - s * e_max

        # 3) Surface store (Manning)
        x3 = jnp.minimum(x2, P["infil"])
        d2 = x2 - x3
        if self.safe_pow:
            pow23 = _pow23(jnp.maximum(h_surf, 0.0))
        else:
            pow23 = jnp.power(h_surf, 2.0 / 3.0)  # NaN for h<0, like CUDA pow
        if "_manning_c" in P:
            w = jnp.minimum(1.0, pow23 * P["_manning_c"])
        else:
            alfa2 = (1.0 / P["n_mann"]) * pow23 * jnp.sqrt(P["slope"])
            w = jnp.minimum(1.0, alfa2 * P["L"] / P["A_h"] * 60.0)
        dy2 = d2 - h_surf * w

        # 4) Gravitational store (interflow)
        x4 = jnp.minimum(x3, P["perco"])
        d3 = x3 - x4
        if "_inv_a3" in P:
            dy3 = d3 - h_grav * P["_inv_a3"]
            dy4 = x4 - h_aq * P["_inv_a4"]
        else:
            dy3 = d3 - jnp.where(P["alpha3"] >= 1.0, h_grav / P["alpha3"], 0.0)
            dy4 = x4 - jnp.where(P["alpha4"] >= 1.0, h_aq / P["alpha4"], 0.0)

        return (dy0, dy1, dy2, dy3, dy4)

    def rhs(self, t, y, params, forcings=None) -> jax.Array:
        return jnp.stack(self.rhs_tuple(t, y, params, forcings))


def link_outflow(y, params):
    """Instantaneous local outflow per link [m * km^2 / min] from the stores.

    THE hydraulics of rhs_tuple's surface/interflow/baseflow terms
    (model_204.hpp:99-113), factored here so routed discharge
    (tiger_tpu.routing.link_runoff_204) uses the SAME formulas the solver
    integrates and cannot silently drift from them.  ``y`` is [S, N].

    Stores are clamped at 0: the dense interpolant can overshoot slightly
    negative near empty stores, and pow(negative, 2/3) would NaN-poison
    every downstream discharge value (outflow from an empty store is zero).
    """
    h_surf = jnp.maximum(y[:, 2], 0.0)
    h_grav = jnp.maximum(y[:, 3], 0.0)
    h_aq = jnp.maximum(y[:, 4], 0.0)
    P = params
    pow23 = _pow23(h_surf)
    if "_manning_c" in P:
        w = jnp.minimum(1.0, pow23 * P["_manning_c"])
    else:
        alfa2 = (1.0 / P["n_mann"]) * pow23 * jnp.sqrt(P["slope"])
        w = jnp.minimum(1.0, alfa2 * P["L"] / P["A_h"] * 60.0)
    qs = h_surf * w
    if "_inv_a3" in P:
        qi = h_grav * P["_inv_a3"]
        qb = h_aq * P["_inv_a4"]
    else:
        qi = jnp.where(P["alpha3"] >= 1.0, h_grav / P["alpha3"], 0.0)
        qb = jnp.where(P["alpha4"] >= 1.0, h_aq / P["alpha4"], 0.0)
    return (qs + qi + qb) * P["A_h"]


#: Common cold-start initial state used by the reference driver (main.cpp:377).
Y0_COMMON = (0.01, 3.0, 0.0, 5.0, 0.2)
