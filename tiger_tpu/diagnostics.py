"""Diagnostic helpers: the JAX analog of the reference's debug kernels.

The reference's entire diagnostic surface is ~210 LoC of printf CUDA kernels
in `main.cpp` — `debugForcings/2/Multi` (:44-102), `debugMinuteForcings`
(:105-141), `debugHolding` (:145-175), `debugParams`/`debugAllParams`
(:187-213), `debugRHS` (:219-246), `checkForcingPtr` (:37-39) and the
host round-trip memcpy checks (:384-443).  Here the same inspections are
ordinary vectorized functions returning arrays/dicts (usable from tests,
notebooks, or `jax.debug.print` inside jitted code) instead of device
printf — there is no raw pointer world to peek at under XLA, and returning
values composes with pytest where printf cannot.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from tiger_tpu.forcing import ForcingSet


def forcing_at(forcings: ForcingSet, t_minutes: float, systems=None) -> np.ndarray:
    """Forcing values seen by the RHS at absolute time ``t_minutes``.

    Returns [n_forcings, len(systems)] — the zero-order-hold sample each
    system's lane would gather, i.e. what `debugForcingsMulti`/
    `debugMinuteForcings` printed per (t, sys).
    """
    sel = np.arange(forcings.num_systems) if systems is None else np.asarray(systems)
    rows = []
    for f_idx in range(len(forcings.meta.offsets)):
        off = forcings.meta.offsets[f_idx]
        n_t = forcings.meta.n_steps[f_idx]
        dt = forcings.meta.dt_min[f_idx]
        k = int(np.clip(int(t_minutes / dt), 0, n_t - 1))
        rows.append(np.asarray(forcings.data[off + k])[sel])
    return np.stack(rows)


def forcing_series(
    forcings: ForcingSet, f_idx: int, system: int, n: Optional[int] = None
) -> np.ndarray:
    """First ``n`` stored time-steps of forcing ``f_idx`` for one system
    (`debugForcings2`'s per-block peek, all samples at once)."""
    off = forcings.meta.offsets[f_idx]
    n_t = forcings.meta.n_steps[f_idx]
    n = n_t if n is None else min(n, n_t)
    return np.asarray(forcings.data[off : off + n, system])


def describe_forcings(forcings: ForcingSet) -> Dict:
    """Layout summary: what `checkForcingPtr` + the nT/dt constant dumps
    showed (offsets, step counts, dt, per-forcing value ranges)."""
    out = {"num_systems": int(forcings.num_systems), "forcings": []}
    for f_idx in range(len(forcings.meta.offsets)):
        off = forcings.meta.offsets[f_idx]
        n_t = forcings.meta.n_steps[f_idx]
        block = np.asarray(forcings.data[off : off + n_t])
        out["forcings"].append(
            {
                "offset_rows": int(off),
                "n_steps": int(n_t),
                "dt_min": float(forcings.meta.dt_min[f_idx]),
                # nan-aware: one NaN (the thing being debugged) must not
                # blank out the value range.
                "min": float(np.nanmin(block)) if np.isfinite(block).any() else float("nan"),
                "max": float(np.nanmax(block)) if np.isfinite(block).any() else float("nan"),
                "mean": float(np.nanmean(block)) if np.isfinite(block).any() else float("nan"),
                "n_nan": int(np.isnan(block).sum()),
            }
        )
    return out


def describe_params(params: Dict, system: Optional[int] = None) -> Dict:
    """Per-field value (one system) or range summary (all systems) —
    `debugParams`/`debugAllParams`/`checkDevParamsKernel204` in one call."""
    out = {}
    for k in sorted(params):
        col = np.asarray(params[k])
        if system is not None:
            out[k] = float(col[system])
        else:
            finite = np.isfinite(col).any()
            out[k] = {
                "min": float(np.nanmin(col)) if finite else float("nan"),
                "max": float(np.nanmax(col)) if finite else float("nan"),
                "mean": float(np.nanmean(col)) if finite else float("nan"),
                "n_nan": int(np.isnan(col).sum()),
            }
    return out


def eval_rhs(model, y, t, params=None, forcings: Optional[ForcingSet] = None):
    """Slopes dy/dt at (t, y) for every system — the `debugRHS` kernel.

    ``y`` is [S, N_EQ]; returns [S, N_EQ].  Useful for checking a model's
    physics at a point without running the integrator.
    """
    y = jnp.asarray(y)
    f_vals = None
    if forcings is not None:
        f_vals = tuple(
            jnp.asarray(row) for row in forcing_at(forcings, float(t))
        )
    cols = tuple(y[:, i] for i in range(y.shape[1]))
    t_vec = jnp.full((y.shape[0],), float(t), y.dtype)
    out = model.rhs_tuple(t_vec, cols, params, f_vals)
    return jnp.stack(out, axis=1)


def holding_summary(y, labels=None) -> Dict:
    """State-vector sanity ranges (`debugHolding`): per-state min/max/mean
    plus NaN/negative counts over all systems."""
    y = np.asarray(y)
    labels = labels or [f"state_{i}" for i in range(y.shape[1])]
    if len(labels) != y.shape[1]:
        raise ValueError(
            f"{len(labels)} labels for {y.shape[1]} states — a short list "
            "would silently drop trailing states from the report"
        )
    out = {}
    for i, lab in enumerate(labels):
        col = y[:, i]
        finite = np.isfinite(col).any()
        out[lab] = {
            "min": float(np.nanmin(col)) if finite else float("nan"),
            "max": float(np.nanmax(col)) if finite else float("nan"),
            "mean": float(np.nanmean(col)) if finite else float("nan"),
            "n_nan": int(np.isnan(col).sum()),
            "n_negative": int((col < 0).sum()),
        }
    return out
