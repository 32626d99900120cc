"""Result writers: NetCDF (primary) and CSV (legacy/parity artifact format).

NetCDF layouts mirror the reference exactly (src/I_O/output_series.cpp:18-124):
  - final:  dims (system, variable); int coord vars ``system`` (LinkID,
    long_name "LinkID") and ``variable``; double data var ``outputs``.
  - dense:  dims (system, time, variable); double coord ``time`` with units
    "minutes since start of simulation"; double data var ``outputs``;
    optional zlib/gzip deflate.

CSV layouts match the commented-out writers that produced the committed golden
artifacts (src/main.cpp:734-773): final header ``h_snow,var1..var4`` one row
per system; dense header ``time,var{i}_sys{s}...`` with time at fixed 8
decimals and values at 9 significant digits.  (Dummy-era artifacts capitalize
``Var{i}``; pass ``var_prefix='Var'`` + ``final_header='vars'`` for that.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tiger_tpu.io.netcdf import NetCDFWriter, h5py_module



def _def_output_dims(w, link_ids, query_times=None, state_ids=None):
    """Shared dimension/coordinate boilerplate of every output layout.

    One source of truth for names, dtypes and CF attrs: the writers
    (final, dense, packed-dense, windowed) diverged silently when these
    were copy-pasted per writer.
    """
    w.def_dim("system", len(link_ids), np.asarray(link_ids, np.int32), np.int32)
    w.set_dim_attrs("system", {"long_name": "LinkID"})
    if query_times is not None:
        w.def_dim("time", len(query_times), np.asarray(query_times, np.float64), np.float64)
        w.set_dim_attrs(
            "time", {"long_name": "Time", "units": "minutes since start of simulation"}
        )
    if state_ids is not None:
        w.def_dim("variable", len(state_ids), np.asarray(state_ids, np.int32), np.int32)
        w.set_dim_attrs(
            "variable", {"long_name": "state variable", "units": "various units"}
        )

def write_final_netcdf(
    path: str,
    y_final: np.ndarray,  # [S, N]
    link_ids: np.ndarray,  # [S]
    state_ids: Optional[np.ndarray] = None,
    compression_level: int = 0,
    dtype=None,
) -> None:
    """Final-state file: dims (system, variable).  output_series.cpp:77-124.

    ``dtype=None`` preserves the input precision (an f32 solve writes f32 —
    the reference's double ``outputs`` var carries no extra information
    there and doubles the file); pass ``np.float64`` for reference-identical
    files.  ``y_final`` may be a device array (streamed by the writer).
    """
    s_count, n_eq = y_final.shape
    if state_ids is None:
        state_ids = np.arange(n_eq, dtype=np.int32)
    with NetCDFWriter(path) as w:
        _def_output_dims(w, link_ids, state_ids=state_ids)
        w.def_var("outputs", y_final, ("system", "variable"), compression_level, dtype=dtype)


def write_dense_netcdf(
    path: str,
    dense: np.ndarray,  # [S, Q, N]
    query_times: np.ndarray,  # [Q] minutes
    link_ids: np.ndarray,  # [S]
    state_ids: Optional[np.ndarray] = None,
    compression_level: int = 0,
    dtype=None,
) -> None:
    """Dense-output file: dims (system, time, variable).  output_series.cpp:18-72.

    ``dtype`` as in write_final_netcdf: None preserves input precision
    (halves the multi-GB file for f32 runs), np.float64 matches the
    reference bit layout.  ``dense`` may be a device array — it is NOT
    pulled here; the writer streams it slab by slab.
    """
    s_count, n_q, n_eq = dense.shape
    if state_ids is None:
        state_ids = np.arange(n_eq, dtype=np.int32)
    with NetCDFWriter(path) as w:
        _def_output_dims(w, link_ids, query_times, state_ids)
        w.def_var("outputs", dense, ("system", "time", "variable"), compression_level, dtype=dtype)


def _pack_cf_int16(dense):
    """Device-side CF quantization: per-state int16 codes + f32 scale/offset.

    Runs under jit on the solve device so the host pull moves 2 bytes per
    sample instead of 4/8.  Non-finite samples map to the CF fill value
    -32767; codes use the symmetric range [-32766, 32766] so max decode
    error is range/131064 (~7.6e-6 of the per-state dynamic range).
    """
    import jax.numpy as jnp

    x = jnp.asarray(dense, jnp.float32)
    finite = jnp.isfinite(x)
    big = jnp.float32(3.4e38)
    lo = jnp.min(jnp.where(finite, x, big), axis=(0, 1))
    hi = jnp.max(jnp.where(finite, x, -big), axis=(0, 1))
    lo, hi = jnp.minimum(lo, hi), jnp.maximum(lo, hi)  # all-NaN state: lo>hi
    # Divide BEFORE subtracting: hi-lo overflows f32 to inf when a state
    # spans huge-but-finite magnitudes (scale=inf would then quantize EVERY
    # sample to code 0 silently).  hi/65532 - lo/65532 cannot overflow, and
    # an (x-offset) overflow in the quantizer just saturates via the clip.
    # (f64 here is not an option: x64 is off in f32 accelerator processes
    # and jnp would silently downcast.)
    scale = jnp.maximum(hi / 65532.0 - lo / 65532.0, jnp.float32(1e-30))
    offset = hi * 0.5 + lo * 0.5
    q = jnp.clip(jnp.round((x - offset) / scale), -32766.0, 32766.0)
    q = jnp.where(finite, q.astype(jnp.int16), jnp.int16(-32767))
    return q, scale, offset


def write_dense_netcdf_packed(
    path: str,
    dense,  # [S, Q, N] (device array welcome)
    query_times: np.ndarray,  # [Q] minutes
    link_ids: np.ndarray,  # [S]
    state_ids: Optional[np.ndarray] = None,
    compression_level: int = 0,
) -> None:
    """CF int16-packed dense output (``output.precision: i16``).

    Same packing convention as the ERA5 forcing files the framework reads
    (scale_factor/add_offset/_FillValue, auto-decoded by xarray/netCDF4).
    Because scale_factor must be a scalar per NetCDF variable and the state
    ranges differ by orders of magnitude, each state becomes its own var
    ``outputs_<state_id>`` with dims (system, time) and its own scale —
    unlike the unpacked layout's single (system, time, variable) var.
    Quantization happens on device (see _pack_cf_int16): 4x fewer bytes
    than the reference's f64 ``outputs`` over both interconnect and disk.
    """
    import jax

    s_count, n_q, n_eq = dense.shape
    if state_ids is None:
        state_ids = np.arange(n_eq, dtype=np.int32)
    q, scale, offset = jax.jit(_pack_cf_int16)(dense)
    scale = np.asarray(scale, np.float64)
    offset = np.asarray(offset, np.float64)
    with NetCDFWriter(path) as w:
        _def_output_dims(w, link_ids, query_times)
        for v in range(n_eq):
            w.def_var(
                f"outputs_{int(state_ids[v])}",
                q[:, :, v],
                ("system", "time"),
                compression_level,
                attrs={
                    "scale_factor": scale[v],
                    "add_offset": offset[v],
                    "_FillValue": np.int16(-32767),
                    "long_name": f"state variable {int(state_ids[v])}",
                    "units": "various units",
                },
            )


def _pack_cf_int16_declared(dense, scale, offset):
    """Device-side CF quantization with DECLARED per-state scale/offset.

    The streaming variant of _pack_cf_int16: windowed runs cannot derive
    global ranges from data they have not solved yet, so the ranges come
    from config (output.i16_ranges) and the scale/offset are constants for
    the whole record.  Values outside the declared range saturate at the
    code limits (the CF decode then reads the range edge); non-finite
    samples map to the fill value -32767.
    """
    import jax.numpy as jnp

    x = jnp.asarray(dense, jnp.float32)
    finite = jnp.isfinite(x)
    q = jnp.clip(jnp.round((x - offset) / scale), -32766.0, 32766.0)
    return jnp.where(finite, q.astype(jnp.int16), jnp.int16(-32767))


class WindowedPackedWriter:
    """Incremental CF int16-packed dense writer for windowed (chunked) runs.

    Streaming counterpart of write_dense_netcdf_packed: one ``outputs_<id>``
    int16 variable per output state with config-declared scale/offset
    (output.i16_ranges), filled time-slice by time-slice.  Quantization runs
    jitted on the solve device, so the host pull moves 2 bytes per sample —
    4x less than the reference's f64 ``outputs`` (output_series.cpp:18-72)
    over both the interconnect and disk.  Same write/flush/close discipline
    as WindowedVarWriter (one window in flight on a worker thread).
    """

    def __init__(
        self,
        path: str,
        link_ids: np.ndarray,  # [S]
        query_times: np.ndarray,  # [Q_total] minutes
        state_ids: np.ndarray,
        ranges: dict,  # state id -> (lo, hi), validated by the config loader
        compression_level: int = 0,
        resume: bool = False,
    ):
        import functools
        from concurrent.futures import ThreadPoolExecutor

        import jax

        s_count, n_q = len(link_ids), len(query_times)
        self._state_ids = np.asarray(state_ids, np.int32)
        lo = np.array([ranges[int(v)][0] for v in self._state_ids], np.float64)
        hi = np.array([ranges[int(v)][1] for v in self._state_ids], np.float64)
        self._scale = np.maximum((hi - lo) / 65532.0, 1e-30)
        self._offset = (hi + lo) / 2.0
        self._pack = jax.jit(
            functools.partial(
                _pack_cf_int16_declared,
                scale=np.asarray(self._scale, np.float32),
                offset=np.asarray(self._offset, np.float32),
            )
        )
        names = [f"outputs_{int(v)}" for v in self._state_ids]
        if resume:
            import os

            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"resume requested but output file is missing: {path}"
                )
            f = h5py_module().File(path, "r+")
            try:
                for name, s, o in zip(names, self._scale, self._offset):
                    if name not in f:
                        raise KeyError(f"resume file {path} has no {name!r}")
                    ds = f[name]
                    if ds.shape != (s_count, n_q) or ds.dtype != np.int16:
                        raise ValueError(
                            f"resume mismatch for {path}:{name}: file has "
                            f"{ds.shape}/{ds.dtype}, run needs "
                            f"{(s_count, n_q)}/int16"
                        )
                    if not (
                        np.isclose(ds.attrs["scale_factor"], s)
                        and np.isclose(ds.attrs["add_offset"], o)
                    ):
                        raise ValueError(
                            f"resume packing mismatch for {path}:{name} — "
                            "output.i16_ranges differ from the original run's"
                        )
                for dim, vals in (
                    ("system", np.asarray(link_ids, np.int32)),
                    ("time", np.asarray(query_times, np.float64)),
                ):
                    if dim in f and not np.array_equal(np.asarray(f[dim]), vals):
                        raise ValueError(
                            f"resume coordinate mismatch for {path}:{dim}"
                        )
            except Exception:
                f.close()
                raise
            self._w = f
            self._ds = [f[name] for name in names]
        else:
            self._w = NetCDFWriter(path)
            _def_output_dims(self._w, link_ids, query_times, self._state_ids)
            self._ds = [
                self._w.def_var_empty(
                    name, (s_count, n_q), ("system", "time"), np.int16,
                    compression_level,
                    attrs={
                        "scale_factor": s,
                        "add_offset": o,
                        "_FillValue": np.int16(-32767),
                        "long_name": f"state variable {int(v)}",
                        "units": "various units",
                    },
                )
                for name, v, s, o in zip(
                    names, self._state_ids, self._scale, self._offset
                )
            ]
        self._ex = ThreadPoolExecutor(max_workers=1)
        self._pending = None

    def write(self, q0: int, block) -> None:
        """Quantize + fill time slice [q0, q0+Qw) (block: [S, Qw, N])."""
        if self._pending is not None:
            self._pending.result()
        codes = self._pack(block)  # device int16 [S, Qw, N]

        def pull_write(q0=q0, codes=codes):
            host = np.asarray(codes)
            for v, ds in enumerate(self._ds):
                ds[:, q0 : q0 + host.shape[1]] = host[:, :, v]

        self._pending = self._ex.submit(pull_write)

    def flush(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None
        self._h5.flush()

    def close(self) -> None:
        try:
            if self._pending is not None:
                self._pending.result()
                self._pending = None
        finally:
            self._ex.shutdown(wait=True)
            self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class WindowedVarWriter:
    """Incremental NetCDF writer for windowed (chunked) runs.

    Creates the dense layout of write_dense_netcdf (or the 2-D discharge
    layout when ``state_ids is None``) with the FULL time extent up front,
    then fills time slices window by window via :meth:`write` — the whole
    [S, Q_total, N] array never exists anywhere (not in HBM, not in host
    memory), which is the point of chunked solving (a year of hourly dense
    output at 1M systems is ~175 GB).

    ``write(q0, block)`` accepts device arrays; the device->host pull and the
    HDF5 write run on a single worker thread with one window in flight, so
    window k's output transfer overlaps window k+1's forcing load and solve
    (same pipelining idea as NetCDFWriter.def_var's slab prefetch, but across
    solve windows).
    """

    def __init__(
        self,
        path: str,
        var_name: str,
        link_ids: np.ndarray,  # [S]
        query_times: np.ndarray,  # [Q_total] minutes
        state_ids: Optional[np.ndarray] = None,  # None -> 2-D (system, time)
        compression_level: int = 0,
        dtype=np.float32,
        attrs: Optional[dict] = None,
        resume: bool = False,
    ):
        """``resume=True`` re-opens an existing file from a checkpointed run
        (full time extent already defined; earlier windows' slices kept) and
        validates its shape instead of recreating it."""
        from concurrent.futures import ThreadPoolExecutor

        s_count = len(link_ids)
        n_q = len(query_times)
        if resume:
            import os

            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"resume requested but output file is missing: {path}"
                )
            f = h5py_module().File(path, "r+")
            try:
                if var_name not in f:
                    raise KeyError(
                        f"resume file {path} has no variable {var_name!r}"
                    )
                ds = f[var_name]
                want = (s_count, n_q) if state_ids is None else (
                    s_count, n_q, len(state_ids)
                )
                if ds.shape != want:
                    raise ValueError(
                        f"resume shape mismatch for {path}:{var_name}: file "
                        f"has {ds.shape}, run needs {want}"
                    )
                # Shapes matching is not enough: a changed config can hit the
                # same counts while meaning different links/times/precision —
                # mixing old and new windows in one file would look valid.
                for dim, vals in (
                    ("system", np.asarray(link_ids, np.int32)),
                    ("time", np.asarray(query_times, np.float64)),
                ):
                    if dim in f and not np.array_equal(np.asarray(f[dim]), vals):
                        raise ValueError(
                            f"resume coordinate mismatch for {path}:{dim} — "
                            "the run's links/query grid differ from the file's"
                        )
                if ds.dtype != np.dtype(dtype):
                    raise ValueError(
                        f"resume dtype mismatch for {path}:{var_name}: file "
                        f"has {ds.dtype}, run writes {np.dtype(dtype)}"
                    )
            except Exception:
                f.close()
                raise
            self._w = f  # h5py.File: has .close(), all defs already exist
            self._h5 = f
            self._dtype = np.dtype(dtype)
            self._ds = ds
            self._ex = ThreadPoolExecutor(max_workers=1)
            self._pending = None
            return
        self._w = NetCDFWriter(path)
        self._h5 = self._w._f
        _def_output_dims(self._w, link_ids, query_times, state_ids)
        if state_ids is not None:
            shape = (s_count, n_q, len(state_ids))
            dims = ("system", "time", "variable")
        else:
            shape = (s_count, n_q)
            dims = ("system", "time")
        self._dtype = np.dtype(dtype)
        self._ds = self._w.def_var_empty(
            var_name, shape, dims, self._dtype, compression_level, attrs
        )
        self._ex = ThreadPoolExecutor(max_workers=1)
        self._pending = None

    def write(self, q0: int, block) -> None:
        """Fill time slice [q0, q0+block.shape[1]) (block: [S, Qw(, N)])."""
        if self._pending is not None:
            self._pending.result()  # backpressure: one window in flight

        def pull_write(q0=q0, block=block):
            self._ds[:, q0 : q0 + block.shape[1]] = np.asarray(block, self._dtype)

        self._pending = self._ex.submit(pull_write)

    def flush(self) -> None:
        """Block until all submitted windows are on disk (checkpoint barrier)."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None
        self._h5.flush()

    def close(self) -> None:
        # Shutdown/close ALWAYS run: re-raising a failed pending write before
        # them would leak the executor + HDF5 handle (and when close() runs
        # during exception unwinding, mask the original error).
        try:
            if self._pending is not None:
                self._pending.result()
                self._pending = None
        finally:
            self._ex.shutdown(wait=True)
            self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_final_csv(path: str, y_final: np.ndarray, header: str = "model204") -> None:
    """Legacy final CSV (main.cpp:736-752).  header='model204' -> h_snow,var1..;
    header='vars' -> Var0..Var4 (dummy artifacts)."""
    y_final = np.asarray(y_final)
    n_eq = y_final.shape[1]
    if header == "model204":
        cols = ["h_snow"] + [f"var{i}" for i in range(1, n_eq)]
    else:
        cols = [f"Var{i}" for i in range(n_eq)]
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for row in y_final:
            f.write(",".join(_fmt_g(v) for v in row) + "\n")


def write_dense_csv(
    path: str,
    dense: np.ndarray,  # [S, Q, N]
    query_times: np.ndarray,
    var_prefix: str = "var",
) -> None:
    """Legacy dense CSV (main.cpp:755-773): time fixed 8 decimals, values 9 sig digits."""
    dense = np.asarray(dense)
    s_count, n_q, n_eq = dense.shape
    with open(path, "w") as f:
        cols = ["time"] + [
            f"{var_prefix}{i}_sys{s}" for s in range(s_count) for i in range(n_eq)
        ]
        f.write(",".join(cols) + "\n")
        for q in range(n_q):
            parts = [f"{query_times[q]:.8f}"]
            for s in range(s_count):
                parts.extend(f"{dense[s, q, i]:.9g}" for i in range(n_eq))
            f.write(",".join(parts) + "\n")


def _fmt_g(v: float) -> str:
    # std::ostream default formatting: 6 significant digits.
    return f"{v:.6g}"


class WindowedCSVWriter:
    """Incremental CSV writer for windowed (chunked) runs: the row-per-query
    layout of write_dense_csv (``time`` at fixed 8 decimals, then every
    system's columns at 9 significant digits), appended window by window.

    ``columns`` names the per-system value columns of one row (block
    [S, Qw] or [S, Qw, N] flattens system-major to them).  ``resume=True``
    re-opens a file from a checkpointed run; the first write truncates it
    to the rows before its start, so windows written after the checkpoint
    by a crashed run are replaced, never duplicated.
    """

    def __init__(self, path: str, columns, query_times: np.ndarray,
                 resume: bool = False):
        import os

        self._path = path
        self._qt = np.asarray(query_times, np.float64)
        self._header = (",".join(["time", *columns]) + "\n").encode()
        if resume:
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"resume requested but output file is missing: {path}"
                )
            with open(path, "rb") as f:
                if f.readline() != self._header:
                    raise ValueError(
                        f"resume header mismatch for {path}: the run's "
                        "systems/states differ from the file's"
                    )
                self._rows = sum(1 for _ in f)
            self._f = open(path, "rb+")
        else:
            self._f = open(path, "wb")
            self._f.write(self._header)
            self._rows = 0
        self._resume = resume

    def write(self, q0: int, block) -> None:
        """Append time rows [q0, q0+Qw) (block: [S, Qw(, N)])."""
        block = np.asarray(block, np.float64)
        if self._resume:
            self._resume = False
            if q0 > self._rows:
                raise ValueError(
                    f"resume gap in {self._path}: file has {self._rows} rows, "
                    f"run continues at row {q0}"
                )
            self._f.seek(0)
            keep = len(self._f.readline())
            for _ in range(q0):
                keep += len(self._f.readline())
            self._f.seek(keep)
            self._f.truncate()
            self._rows = q0
        if q0 != self._rows:
            raise ValueError(f"{self._path}: rows must be written in order")
        n_q = block.shape[1]
        rows = np.moveaxis(block, 1, 0).reshape(n_q, -1)
        table = np.column_stack([self._qt[q0:q0 + n_q], rows])
        np.savetxt(self._f, table, fmt=["%.8f"] + ["%.9g"] * rows.shape[1],
                   delimiter=",")
        self._rows += n_q

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
