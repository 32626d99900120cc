"""Forcing subsystem: packed per-system forcing series + zero-order-hold gather.

Reference pipeline (src/main.cpp:494-606 + src/I_O/forcing_loader.cpp):
gridded NetCDF (time, lat, lon) -> lookup CSV remap (stream -> flat grid index)
-> packed device array laid out [forcing-block][time][system] float32 -> in-
kernel per-step gather with zero-order hold: sampleIdx = clamp(floor(t /
(dt_hours*60)), 0, nT-1) (rk45_kernel.cu:84-110).  Forcing values are sampled
ONCE per attempted step at step-start t and held constant across all 7 RK
stages (rk45_step_dense.cuh:104-105) — reproduced here for parity.

Differences from the reference:
  - the packed array is [T_total, S] (time-major blocks concatenated on axis 0)
    so the batch dimension S is the contiguous one; the remap is a vectorized
    numpy/jnp fancy-index gather instead of the reference's O(nT*S) scalar
    host loop (main.cpp:543-549);
  - per-forcing metadata (row offset, step count, dt in MINUTES) is static
    Python data so the gather compiles to static-offset dynamic slices;
  - the known Radau-kernel indexing bugs (radau_kernel.cu:71,84: missing
    hours->minutes conversion and wrong block base) are NOT reproduced — both
    solver phases use this one correct gather.

NetCDF ingestion lives in tiger_tpu.io.netcdf (h5py-based NETCDF4 reader);
this module is pure array plumbing so it stays jittable.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class ForcingMeta(NamedTuple):
    """Static (hashable) description of the packed forcing blocks."""

    offsets: tuple[int, ...]  # start row of each forcing block in the packed array
    n_steps: tuple[int, ...]  # number of time steps per forcing
    dt_min: tuple[float, ...]  # minutes per time step (reference stores hours:
    #                            forcing_data.cu c_forc_dt; converted once here)


@dataclasses.dataclass(frozen=True)
class ForcingSet:
    """Packed forcing data [T_total, S] (float32) plus static metadata.

    ``data[offsets[j] + k, s]`` is forcing j at time-step k for system s.
    """

    data: jax.Array  # [T_total, S] float32
    meta: ForcingMeta

    @property
    def n_forcings(self) -> int:
        return len(self.meta.offsets)

    @property
    def num_systems(self) -> int:
        return self.data.shape[1]

    @staticmethod
    def from_series(series: Sequence[np.ndarray], dt_minutes: Sequence[float]) -> "ForcingSet":
        """Build from per-forcing arrays shaped [T_j, S] (already remapped to systems)."""
        if len(series) != len(dt_minutes):
            raise ValueError("series and dt_minutes must have equal length")
        offsets, n_steps = [], []
        row = 0
        for arr in series:
            offsets.append(row)
            n_steps.append(arr.shape[0])
            row += arr.shape[0]
        data = np.concatenate([np.asarray(a, np.float32) for a in series], axis=0)
        meta = ForcingMeta(tuple(offsets), tuple(n_steps), tuple(float(d) for d in dt_minutes))
        return ForcingSet(data=jnp.asarray(data), meta=meta)

    @staticmethod
    def from_grid_series(
        grids: Sequence[np.ndarray],  # [T_j, n_cells] flat grids (host or device)
        flat_index,  # [S] int cell index per system (device array reusable)
        dt_minutes: Sequence[float],
    ) -> "ForcingSet":
        """Build by remapping flat grids onto systems ON DEVICE.

        Ships only the grid (n_cells values per step) over the host->device
        link and gathers the [T, S] per-system layout there — at 131k systems
        on a 64x128 ERA5-style grid that is 16x fewer bytes per window than
        uploading the host-remapped series (100x at 1M systems), which
        matters when the host->device link is the bottleneck.  Values are bitwise-identical to
        ``from_series(remap_grid_to_systems(...))``.
        """
        if len(grids) != len(dt_minutes):
            raise ValueError("grids and dt_minutes must have equal length")
        offsets, n_steps = [], []
        row = 0
        for g in grids:
            offsets.append(row)
            n_steps.append(g.shape[0])
            row += g.shape[0]
        if isinstance(flat_index, (list, tuple)):
            raw_flats = tuple(flat_index)
        else:
            raw_flats = (flat_index,) * len(grids)
        # Host-side bounds check when the index is host data (device-cached
        # indices are validated once by the loaders): the device gather
        # CLIPS out-of-range rows, which would silently feed the wrong
        # cell's forcing where the numpy path raised.
        for f, g in zip(raw_flats, grids):
            if isinstance(f, np.ndarray):
                _check_flat_bounds(f, g.shape[-1] if g.ndim == 2 else g.size // g.shape[0], None)
        flats = tuple(jnp.asarray(f, jnp.int32) for f in raw_flats)
        data = _remap_concat_jit(
            tuple(jnp.asarray(g, jnp.float32) for g in grids), flats
        )
        meta = ForcingMeta(tuple(offsets), tuple(n_steps), tuple(float(d) for d in dt_minutes))
        return ForcingSet(data=data, meta=meta)

def _check_flat_bounds(flat: np.ndarray, n_cells: int, spec) -> None:
    """Fail loudly on lookup rows outside the forcing grid: the device
    gather (jnp.take) CLIPS out-of-range indices, which would silently feed
    affected systems the wrong cell's forcing (the numpy path raised)."""
    if len(flat) and (flat.min() < 0 or flat.max() >= n_cells):
        bad = int((np.asarray(flat) >= n_cells).sum() + (np.asarray(flat) < 0).sum())
        raise ValueError(
            f"lookup maps {bad} system(s) outside the {n_cells}-cell grid of "
            f"{getattr(spec, 'var', '?')} ({getattr(spec, 'path', '?')}); "
            "check lat_index/lon_index against the forcing file dimensions"
        )


def _check_remap_finite(chunk: np.ndarray, flat: np.ndarray, spec) -> None:
    """Reject lookups that map systems onto missing cells (NaN after fill
    handling — e.g. ERA5-Land ocean cells, or a missing hour mid-record).
    One O(T*cells) NaN scan of the already-in-memory chunk per window: NaN
    forcing would otherwise silently poison every trajectory on the cell."""
    flat = np.asarray(flat)
    grid2d = chunk.reshape(chunk.shape[0], -1)
    bad = np.isnan(grid2d).any(axis=0)[flat]
    if bad.any():
        raise ValueError(
            f"{int(bad.sum())} system(s) map to missing ({np.nan}) cells of "
            f"{getattr(spec, 'var', '?')} ({getattr(spec, 'path', '?')}); "
            "fix the lookup or fill the forcing file"
        )


@jax.jit
def _remap_concat_jit(grids, flats):
    """[(T_j, C_j)] grids + per-grid [S] cell indices -> packed [sum T_j, S]."""
    return jnp.concatenate(
        [jnp.take(g, f, axis=1) for g, f in zip(grids, flats)], axis=0
    )


#: Relative gather-index snap used when SolverConfig.forcing_step_align is
#: on: sample index = floor(t/dt + ZOH_SNAP), so a lane whose float32 time
#: landed an ulp BELOW the boundary its aligned step targeted still reads
#: the new sample.  5e-4*dt of frozen-forcing exposure (~1.8 s at hourly
#: cadence) is orders below every shipped tolerance; without alignment the
#: raw reference indexing (floor(t/dt), rk45_kernel.cu:90-110) is used.
ZOH_SNAP = 5e-4


def gather_forcings_column(
    col: jax.Array, meta: ForcingMeta, t: jax.Array, snap: float = 0.0
) -> jax.Array:
    """Zero-order-hold gather for ONE system's forcing column at time t [min].

    ``col`` is data[:, s] (shape [T_total]); returns a length-nForc float32
    vector.  Matches rk45_kernel.cu:90-110: floor(t / dt_min) clamped to
    [0, nT-1], block base = cumulative sum of previous blocks.  ``snap``:
    see ZOH_SNAP.
    """
    vals = []
    for off, n_t, dt in zip(meta.offsets, meta.n_steps, meta.dt_min):
        idx = jnp.clip(jnp.floor(t / dt + snap).astype(jnp.int32), 0, n_t - 1)
        vals.append(jax.lax.dynamic_index_in_dim(col, off + idx, keepdims=False))
    return jnp.stack(vals)


def zoh_step_cap(meta: ForcingMeta, t: jax.Array, h_eff: jax.Array) -> jax.Array:
    """Clamp ``h_eff`` so the step from ``t`` lands ON (never across) the
    next ZOH forcing-sample boundary (SolverConfig.forcing_step_align).

    Uses the same snapped index as the gather, so 'the sample this step
    integrates' and 'the boundary this step must not cross' always agree.
    Boundaries only exist inside each record — past the last sample the ZOH
    clamps and there is nothing to align to (so year-long runs on a 2-day
    record are not step-limited, they are just wrong in the reference way).
    """
    for n_t, dt in sorted(set(zip(meta.n_steps, meta.dt_min))):
        k = jnp.floor(t / dt + ZOH_SNAP)
        nb = (k + 1.0) * dt - t
        nb = jnp.where(k + 1.0 >= n_t, jnp.inf, nb)
        h_eff = jnp.minimum(h_eff, nb.astype(h_eff.dtype))
    return h_eff


@dataclasses.dataclass(frozen=True)
class ForcingSpec:
    """One gridded forcing source (reference NCForcing, main.cpp:508-515).

    ``lookup``: optional per-forcing remap CSV — the reference loads a
    separate lookup per forcing grid (pr_lookup/t2m_lookup, main.cpp:494-505)
    because grids may differ in resolution; None uses the run-level lookup.
    """

    path: str
    var: str
    dt_hours: float  # hours per time step (converted to minutes at pack time)
    lookup: Optional[str] = None


def _units_to_hours(units: str) -> Optional[float]:
    """CF time-units string -> hours per unit ('hours since ...' -> 1.0)."""
    head = units.strip().lower().split()[0] if units else ""
    return {
        "seconds": 1.0 / 3600.0, "second": 1.0 / 3600.0, "s": 1.0 / 3600.0,
        "minutes": 1.0 / 60.0, "minute": 1.0 / 60.0, "min": 1.0 / 60.0,
        "hours": 1.0, "hour": 1.0, "h": 1.0, "hrs": 1.0,
        "days": 24.0, "day": 24.0, "d": 24.0,
    }.get(head)


def discover_forcings(folder: str, var_names: Sequence[str]) -> list:
    """``forcings.type: folder_nc`` discovery: scan ``folder`` for NetCDF files
    holding each variable in ``var_names``; infer dt from the time coordinate.

    Implements the reference config schema's intended behavior
    (data/config.yaml:33-40 — folder + var names only, no per-file entries;
    the reference itself hard-codes paths and dt in main.cpp:508-515).
    Returns ForcingSpec list in ``var_names`` order.  Raises with a pointer
    to the explicit ``files:`` form when a variable is missing, found twice,
    or its time coordinate has no usable units.
    """
    import glob as _glob
    import os

    from tiger_tpu.io.netcdf import NetCDFReader

    candidates = sorted(
        _glob.glob(os.path.join(folder, "*.nc"))
        + _glob.glob(os.path.join(folder, "*.nc4"))
    )
    # ONE open per (file, var) pair total: probing every candidate per
    # variable re-opened and re-decoded each file V times.
    found: dict = {v: [] for v in var_names}
    for path in candidates:
        for var in var_names:
            try:
                rd = NetCDFReader(path, var)
            except (KeyError, ValueError, OSError):
                continue
            with rd:
                tvals, units = rd.time_info()
            found[var].append((path, tvals, units))
    specs = []
    for var in var_names:
        hits = found[var]
        if not hits:
            raise FileNotFoundError(
                f"forcings.type folder_nc: no NetCDF file in {folder!r} has a "
                f"3-D variable {var!r}; list sources explicitly under "
                "forcings.files instead"
            )
        if len(hits) > 1:
            raise ValueError(
                f"forcings.type folder_nc: variable {var!r} found in multiple "
                f"files ({[h[0] for h in hits]}); disambiguate with "
                "forcings.files"
            )
        path, tvals, units = hits[0]
        per_unit = _units_to_hours(units) if units else None
        if tvals is None or len(tvals) < 2 or per_unit is None:
            raise ValueError(
                f"Cannot infer time step for {var!r} in {path}: time "
                f"coordinate/units missing or unparseable ({units!r}); set "
                "dt_hours explicitly under forcings.files"
            )
        steps = np.diff(np.asarray(tvals, np.float64))
        if steps.min() <= 0 or not np.allclose(steps, steps[0], rtol=1e-6):
            raise ValueError(
                f"Non-uniform time coordinate for {var!r} in {path}; "
                "zero-order-hold forcing needs a constant step"
            )
        specs.append(ForcingSpec(path=path, var=var, dt_hours=float(steps[0] * per_unit)))
    return specs


def load_forcings(
    specs: Sequence[ForcingSpec],
    stream_ids: np.ndarray,
    lookup_csv: str,
    start_step: int = 0,
    duration_days: Optional[float] = None,
) -> "ForcingSet":
    """NetCDF grids -> lookup remap -> packed ForcingSet for the given systems.

    Mirrors the reference ingestion loop (main.cpp:494-574): the lookup CSV
    maps stream id -> (lat_idx, lon_idx); each forcing contributes
    round(duration_days*24/dt_hours) steps (capped at file length; the
    reference loads 2 days, main.cpp:525).  ``duration_days=None`` loads the
    full file.
    """
    from tiger_tpu.io.lookup import LookupTable
    from tiger_tpu.io.netcdf import NetCDFReader

    luts = {
        p: LookupTable.load(p)
        for p in {spec.lookup or lookup_csv for spec in specs}
    }
    grids, flats, dt_minutes = [], [], []
    for spec in specs:
        lut = luts[spec.lookup or lookup_csv]
        with NetCDFReader(spec.path, spec.var) as rd:
            if duration_days is None:
                n_steps = rd.time_size - start_step
            else:
                # ceil: a span that is not a whole multiple of dt still needs
                # the partially-covered step (round() dropped the last half
                # day of daily forcing for a 2.5-day run).
                n_steps = int(np.ceil(duration_days * 24.0 / spec.dt_hours - 1e-9))
                n_steps = min(n_steps, rd.time_size - start_step)
            flat = lut.flat_index(np.asarray(stream_ids), rd.lon_size)
            chunk = rd.load_time_chunk(start_step, n_steps)
            _check_flat_bounds(flat, chunk.shape[1] * chunk.shape[2], spec)
            _check_remap_finite(chunk, flat, spec)
            flats.append(flat)
            # Ship the grid and remap on device (see from_grid_series): the
            # host->device bytes scale with the GRID, not the basin.
            grids.append(chunk.reshape(chunk.shape[0], -1))
            dt_minutes.append(spec.dt_hours * 60.0)
    return ForcingSet.from_grid_series(grids, flats, dt_minutes)


def remap_grid_to_systems(grid_chunk: np.ndarray, flat_index: np.ndarray) -> np.ndarray:
    """Vectorized lookup remap: [T, lat, lon] grid -> [T, S] per-system series.

    ``flat_index[s] = lat_idx[s] * lon_size + lon_idx[s]`` (main.cpp:500-505).
    Replaces the reference's scalar host loop (main.cpp:543-549) with one fancy
    index per chunk.
    """
    try:
        from tiger_tpu.native import remap_gather

        return remap_gather(np.asarray(grid_chunk, np.float32), flat_index)
    except ImportError:
        t_dim = grid_chunk.shape[0]
        flat = grid_chunk.reshape(t_dim, -1)
        return np.ascontiguousarray(flat[:, flat_index])
