"""Model 200: the 5-store runoff model with the full ET / soil-temperature
physics the reference shipped as library code but never wired into a model.

The reference's active Model 204 uses a linear ET stub and notes "later base
it on HamonPET" (notebook cell 11); HamonPET/ETactual (ETmethods.cpp:11-59)
and the Rankinen soil-temperature update (soiltemp.cpp:11-29) are compiled out
of its build (Makefile:77-79).  Model 200 is that intended variant:

  - potential ET from Hamon (temperature, latitude, day-of-year with
    doy = 1 + t/1440, model_204.hpp:84);
  - actual ET via the sw/ss soil-moisture ramp on s = h_static/Hu;
  - snowmelt gated on AIR temperature like 204 (soil temperature is a
    diagnostic, not a prognostic state, in the reference's helpers — it needs
    a daily update cycle that belongs in the forcing preprocessing).

Everything else (snow bucket, static/surface/grav/aquifer fluxes, Manning
surface outflow, unit conventions) is identical to Model 204.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tiger_tpu.models.et import et_actual, hamon_pet


@dataclasses.dataclass(frozen=True)
class Model200:
    N_EQ: int = 5
    UID: int = 200

    safe_pow: bool = True
    # Day-of-year at t=0.  The reference hard-codes doy = 1 + t/1440
    # (model_204.hpp:84), correct only for Jan-1 starts; the config schema
    # says "doy is computed internally from time.start and t"
    # (data/config.yaml:40) — the driver passes time.start's day of year.
    doy0: float = 1.0

    def derived_params(self, params) -> dict:
        """Hoist loop-invariant parameter math out of the RHS (see Model204)."""
        p = dict(params)
        p["_manning_c"] = (
            jnp.sqrt(p["slope"]) / p["n_mann"] * (p["L"] / p["A_h"] * 60.0)
        )
        p["_inv_Hu"] = 1.0 / p["Hu"]
        p["_inv_a3"] = jnp.where(p["alpha3"] >= 1.0, 1.0 / p["alpha3"], 0.0)
        p["_inv_a4"] = jnp.where(p["alpha4"] >= 1.0, 1.0 / p["alpha4"], 0.0)
        rad = jnp.pi / 180.0
        p["_sin_lat"] = jnp.sin(p["lat"] * rad)
        p["_cos_lat"] = jnp.cos(p["lat"] * rad)
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

        doy = self.doy0 + t / 1440.0  # anchored to time.start (config.yaml:40)

        # 1) Snow
        snowmelt = jnp.where(
            temperature >= P["temp_thr"],
            jnp.minimum(h_snow, temperature * P["melt_f"]),
            0.0,
        )
        x1 = rainfall + snowmelt
        dy0 = rainfall - snowmelt

        # 2) Static store with Hamon PET + moisture-ramp actual ET
        x2 = jnp.maximum(0.0, x1 + h_stat - P["Hu"])
        d1 = x1 - x2
        pet = hamon_pet(
            temperature, P["lat"], doy,
            sin_lat=P.get("_sin_lat"), cos_lat=P.get("_cos_lat"),
        )  # [m/min]
        e_max = jnp.minimum(pet, h_stat)
        s = h_stat * P["_inv_Hu"] if "_inv_Hu" in P else h_stat / P["Hu"]
        et = et_actual(e_max, s, P["sw"], P["ss"])
        dy1 = d1 - et

        # 3) Surface store (Manning)
        x3 = jnp.minimum(x2, P["infil"])
        d2 = x2 - x3
        # Same Manning x^(2/3) as Model 204 (model204._pow23; keeps routed
        # discharge's link_outflow numerically identical to the solver).
        from tiger_tpu.models.model204 import _pow23

        if self.safe_pow:
            pow23 = _pow23(jnp.maximum(h_surf, 0.0))
        else:
            pow23 = jnp.power(h_surf, 2.0 / 3.0)
        if "_manning_c" in P:
            w = jnp.minimum(1.0, pow23 * P["_manning_c"])
        else:
            alfa2 = (1.0 / P["n_mann"]) * pow23 * jnp.sqrt(P["slope"])
            w = jnp.minimum(1.0, alfa2 * P["L"] / P["A_h"] * 60.0)
        dy2 = d2 - h_surf * w

        # 4) Gravitational store
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
