"""Checkpoint / hot-start support.

The reference *specifies* cold/hot initial conditions in its config schema
(config_loader.hpp:20-23, data/config.yaml initial.mode) but never implements
them.  Here: cold start = common y0 vector broadcast over systems (the
reference's hard-coded y0_common, main.cpp:377); hot start = restore the full
[S, N] state from a state file, which doubles as checkpoint/resume.

State files use the final-state layout (system, variable) plus a
``sim_time_minutes`` attribute, written as classic NetCDF through scipy (no
HDF5 library needed to checkpoint or resume).  load_state also reads a
NETCDF4 final_*.nc, so a run's final output can be fed back as the next
run's hot start.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def save_state(path: str, y: np.ndarray, link_ids: np.ndarray, sim_time_minutes: float) -> None:
    """Write a hot-start/checkpoint state file ATOMICALLY.

    Periodic checkpoints overwrite the previous one; writing in place would
    destroy the only resume point exactly when a crash lands mid-write
    (the event checkpoints exist for).  Write to a sibling temp file and
    ``os.replace`` it over the target.
    """
    import os

    from scipy.io import netcdf_file

    y = np.asarray(y)
    tmp = path + ".tmp"
    with netcdf_file(tmp, "w", version=2) as f:
        f.createDimension("system", y.shape[0])
        f.createDimension("variable", y.shape[1])
        # Link ids as f8: classic NetCDF has no 64-bit integers, and f8 is
        # exact for every id below 2**53.
        f.createVariable("system", "f8", ("system",))[:] = np.asarray(link_ids)
        f.createVariable("outputs", y.dtype.char, ("system", "variable"))[:] = y
        f.sim_time_minutes = float(sim_time_minutes)
    # fsync the data BEFORE the rename: on ext4/xfs the rename can become
    # durable while the file contents are still in the page cache, which on
    # power loss leaves a truncated file atomically renamed over the only
    # resume point.
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


def load_state(
    path: str, link_ids: Optional[np.ndarray] = None, require_time: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Read (y [S, N], link_ids [S], sim_time_minutes) from a state file.

    If ``link_ids`` is given, rows are re-ordered to match it (a hot start may
    use a subset/permutation of the checkpointed basin, e.g. when the shard
    layout changed between runs); missing links raise.  ``require_time``
    (crash resume): a file WITHOUT the sim_time_minutes attribute is not a
    resumable checkpoint (e.g. a plain final_*.nc) — raise instead of
    silently defaulting to t=0 and re-running the whole span.
    """
    with open(path, "rb") as fh:
        classic = fh.read(3) == b"CDF"
    if classic:
        from scipy.io import netcdf_file

        with netcdf_file(path, "r", mmap=False) as f:
            y = np.array(f.variables["outputs"][:], np.float64)
            ids = np.array(f.variables["system"][:]).astype(np.int64)
            attrs = dict(f._attributes)
    else:
        from tiger_tpu.io.netcdf import h5py_module

        with h5py_module().File(path, "r") as f:
            y = np.asarray(f["outputs"], np.float64)
            ids = np.asarray(f["system"], np.int64)
            attrs = dict(f.attrs)
    if require_time and "sim_time_minutes" not in attrs:
        raise ValueError(
            f"{path} has no sim_time_minutes attribute — it is a plain "
            "state/final file, not a resumable checkpoint"
        )
    t = float(attrs.get("sim_time_minutes", 0.0))
    if link_ids is not None:
        link_ids = np.asarray(link_ids, np.int64)
        order = np.argsort(ids, kind="stable")
        pos = np.searchsorted(ids[order], link_ids)
        pos = np.clip(pos, 0, len(ids) - 1)
        found = ids[order][pos] == link_ids
        if not found.all():
            raise KeyError(f"Hot-start file missing links: {link_ids[~found][:10]}")
        y = y[order][pos]
        ids = link_ids
    return y, ids, t


def cold_state(y0_common, num_systems: int) -> np.ndarray:
    """Broadcast a per-variable cold-start vector over the basin."""
    y0 = np.asarray(y0_common, np.float64)
    return np.tile(y0, (num_systems, 1))
