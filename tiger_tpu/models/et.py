"""Evapotranspiration helpers: Hamon PET and actual-ET ramp.

jnp re-implementations of the reference library functions (declared
__host__ __device__ but compiled host-only and excluded from the GPU build;
src/models/ETmethods.cpp:11-59, Makefile:77-79).  The active Model204 physics
uses a linear ET stub instead; these exist for future model variants, exactly
as in the reference.  Fully vectorizable (branchless).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def hamon_pet(
    temperature: jax.Array,
    latitude: jax.Array,
    doy: jax.Array,
    sin_lat: jax.Array | None = None,
    cos_lat: jax.Array | None = None,
) -> jax.Array:
    """Hamon potential evapotranspiration [m/min].

    CBM daylight model; reference src/models/ETmethods.cpp:11-42.
    ``temperature`` in degC, ``latitude`` in degrees, ``doy`` day-of-year.
    """
    # Saturation vapor pressure (mb) and saturated vapor density (g/m^3)
    esat = 6.108 * jnp.exp((17.26939 * temperature) / (temperature + 237.3))
    wt = 216.7 * esat / (temperature + 273.3)

    # Daylight fraction (units of 12 h) via the CBM model
    # arctan as atan2(u, 1): on an NVIDIA GPU the fused kernel (Triton,
    # libdevice) and XLA evaluate atan2 bit for bit alike but arctan
    # differently (model204._pow23 says why that matters).
    u = 0.9671396 * jnp.tan(0.00860 * (doy - 186.0))
    theta = 0.2163108 + 2.0 * jnp.arctan2(u, jnp.ones_like(u))
    phi = jnp.arcsin(0.39795 * jnp.cos(theta))
    pi = jnp.pi
    # Callers on a hot path pass precomputed sin/cos of latitude (it is
    # loop-invariant; the trig costs dozens of operations per eval).
    if sin_lat is None:
        sin_lat = jnp.sin(latitude * pi / 180.0)
    if cos_lat is None:
        cos_lat = jnp.cos(latitude * pi / 180.0)
    num = jnp.sin(0.8333 * pi / 180.0) + sin_lat * jnp.sin(phi)
    den = cos_lat * jnp.cos(phi)
    arg = num / den
    d = (24.0 - (24.0 / pi) * jnp.arccos(arg)) / 12.0

    # Arctic handling: acos argument out of [-1,1] => polar day or night.
    # (The reference checks isnan(D) post-hoc; branchless equivalent.)
    # Known divergence from the reference's sign rule within ~0.8 deg of the
    # poles (where the 0.8333-deg refraction term can dominate at phi ~ 0):
    # no hydrologic basin lives there, and the reference's own rule
    # misclassifies the same refracted-twilight corner differently.
    polar_day = (phi > 0.0) & (latitude > 0.0) | (phi < 0.0) & (latitude < 0.0)
    d = jnp.where(jnp.abs(arg) > 1.0, jnp.where(polar_day, 2.0, 0.0), d)

    pet = 1.6169e-6 * d * d * wt * 60.0 / 1000.0
    return jnp.where(temperature > 0.0, pet, 0.0)


def et_actual(e_max: jax.Array, s: jax.Array, sw: jax.Array, ss: jax.Array) -> jax.Array:
    """Actual ET: linear ramp between wilting point sw and stomatal closure ss.

    Reference src/models/ETmethods.cpp:47-59.
    """
    ramp = e_max * (s - sw) / (ss - sw)
    return jnp.where(s > ss, e_max, jnp.where(s > sw, ramp, 0.0))
