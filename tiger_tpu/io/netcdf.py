"""Minimal NetCDF reader/writer: NETCDF4 through h5py, classic through scipy.

NETCDF4-format files ARE HDF5 files (the reference's committed .nc artifacts
have HDF5 magic), so this module reads/writes them with h5py directly:
datasets are variables, dimensions are HDF5 dimension scales, attributes
pass through.  Files written here carry proper dimension scales +
_Netcdf4* bookkeeping attributes so netCDF4/xarray readers open them as
ordinary NetCDF4.  Classic NetCDF (CDF-1/2) is read and written with
``scipy.io.netcdf_file``, so gridded forcing works where h5py is not
installed; h5py is imported only where a NETCDF4 file is touched.

Replaces the reference's libnetcdf usage:
  - NetCDFLoader (src/I_O/forcing_loader.cpp:76-218): open a 3-D
    (time, lat, lon) float variable, expose dim sizes, read time chunks;
  - write_dense_netcdf / write_final_netcdf (src/I_O/output_series.cpp:18-124).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

_DIM_ANON = "This is a netCDF dimension but not a netCDF variable."


def h5py_module():
    """h5py, imported at the point of use: only NETCDF4 (HDF5) files need it."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "NETCDF4 (HDF5) files need the h5py package, which is not "
            "installed; use classic NetCDF inputs and output.format: csv"
        ) from exc
    return h5py


class NetCDFReader:
    """Windowed reader for one gridded variable of a NetCDF file.

    Equivalent of the reference NetCDFLoader (forcing_loader.cpp:76-218):
    assumes dims ordered (time, lat, lon) for 3-D variables.  NETCDF4 (HDF5)
    files read through h5py; classic NetCDF3 (CDF-1/2 magic) through a
    memory-mapped scipy reader — both give windowed time reads without
    loading the whole record.
    """

    def __init__(self, path: str, var_name: str):
        with open(path, "rb") as fh:
            magic = fh.read(4)
        self._classic = magic[:3] == b"CDF"
        if self._classic:
            from scipy.io import netcdf_file

            self._f = netcdf_file(path, "r", mmap=True)
        else:
            self._f = h5py_module().File(path, "r")
        # Close on EVERY init failure: forcing folder discovery probes many
        # candidate files and catches these errors, so a leaked handle per
        # probe accumulates (and HDF5 read locks can block later writers).
        self._var = None
        try:
            if self._classic:
                if var_name not in self._f.variables:
                    raise KeyError(f"Variable {var_name!r} not found in {path}")
                self._var = self._f.variables[var_name]
            else:
                if var_name not in self._f:
                    raise KeyError(f"Variable {var_name!r} not found in {path}")
                self._var = self._f[var_name]
            shape = self._var.shape
            if len(shape) != 3:
                raise ValueError(
                    f"Expected 3D variable (time, lat, lon), got {len(shape)}D"
                )
        except Exception:
            self.close()
            raise
        self.time_size, self.lat_size, self.lon_size = shape
        self.path, self.var_name = path, var_name

    def load_time_chunk(self, start: int, count: int) -> np.ndarray:
        """Read ``count`` time slices from ``start`` -> float32 [count, lat, lon].

        Bounds semantics match loadTimeChunk (forcing_loader.cpp:164-196).
        Applies CF packing (``scale_factor``/``add_offset``) when present —
        distributed ERA5 files are typically int16-packed.
        """
        if count <= 0:
            raise ValueError("Size of time chunk must be greater than zero")
        if start < 0 or start >= self.time_size:
            raise IndexError("Start time index out of range")
        if start + count > self.time_size:
            raise IndexError("Requested time steps exceed available data")
        raw = np.array(self._var[start : start + count])
        attrs = self.attrs()

        def scalar(key):
            v = attrs.get(key)
            if v is None:
                return None
            v = np.asarray(v).reshape(-1)[0]
            return float(v)

        scale = scalar("scale_factor")
        offset = scalar("add_offset")
        fill = attrs.get("_FillValue", attrs.get("missing_value"))
        if scale is not None or offset is not None:
            out = raw.astype(np.float64)
            if fill is not None:
                out[raw == np.asarray(fill).reshape(-1)[0]] = np.nan
            out = out * (scale if scale is not None else 1.0) + (
                offset if offset is not None else 0.0
            )
            return out.astype(np.float32)
        out = raw.astype(np.float32)
        if fill is not None:
            # Unpacked variables carry fill values too (ERA5-Land ocean
            # cells): map them to NaN so downstream validation can tell a
            # missing cell from a real value instead of integrating -9999.
            out[raw == np.asarray(fill).reshape(-1)[0]] = np.nan
        return out

    #: HDF5 dimension-scale bookkeeping attrs — not CF metadata.
    _HDF5_INTERNAL = ("DIMENSION_LIST", "REFERENCE_LIST", "NAME", "CLASS")

    def attrs(self) -> dict:
        if self._classic:
            return dict(getattr(self._var, "_attributes", {}))
        return {
            k: v
            for k, v in self._var.attrs.items()
            if not k.startswith("_Netcdf") and k not in self._HDF5_INTERNAL
        }

    def time_info(self):
        """(time coordinate values, units string) or (None, None).

        Used by forcing folder discovery to infer each variable's time step
        (the reference hard-codes dt per file, main.cpp:508-515).
        """
        if self._classic:
            tv = self._f.variables.get("time")
            if tv is None:
                return None, None
            units = getattr(tv, "units", None) or tv._attributes.get("units")
            vals = np.array(tv[:], np.float64)
        else:
            if "time" not in self._f:
                return None, None
            ds = self._f["time"]
            if ds.attrs.get("NAME", b"").startswith(_DIM_ANON.encode()):
                return None, None  # anonymous dimension, no coordinate values
            vals = np.asarray(ds[:], np.float64)
            units = ds.attrs.get("units")
        if isinstance(units, bytes):
            units = units.decode()
        return vals, units

    def close(self):
        if self._classic:
            # Every chunk we hand out is np.array-copied, so the mmap can go;
            # scipy still warns because variable objects reference it — drop
            # them and silence that specific warning.
            import warnings

            self._var = None
            self._f.variables = {}
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                self._f.close()
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NetCDFWriter:
    """NETCDF4 writer: define dims, coordinate vars, data vars, attributes."""

    def __init__(self, path: str):
        self._f = h5py_module().File(path, "w")
        self._f.attrs["_NCProperties"] = np.bytes_(b"version=2,tiger_tpu=" + b"0.1")
        self._dims: dict = {}
        self._dimid = 0

    def def_dim(self, name: str, size: int, coord: Optional[np.ndarray] = None, dtype=None):
        """Define a dimension, optionally with coordinate values."""
        if coord is not None:
            ds = self._f.create_dataset(name, data=np.asarray(coord, dtype))
            ds.make_scale(name)
        else:
            ds = self._f.create_dataset(name, shape=(size,), dtype="f4")
            ds.make_scale(name)
            # AFTER make_scale (which overwrites NAME with the plain dim
            # name): the anonymous marker is what tells netCDF4/xarray this
            # is a dimension without a coordinate variable, not f4 zeros.
            ds.attrs["NAME"] = np.bytes_(f"{_DIM_ANON} {size}".encode())
        ds.attrs["_Netcdf4Dimid"] = np.int32(self._dimid)
        self._dimid += 1
        self._dims[name] = ds
        return ds

    def def_var(self, name: str, data, dims: tuple[str, ...], compression: int = 0, attrs: Optional[dict] = None, dtype=None):
        """``data`` may be a numpy array OR a device (jax) array: device
        arrays are pulled row-slab by row-slab straight into the dataset, so
        the device->host transfer overlaps the disk write and the multi-GB
        dense buffer is never fully duplicated on the host.  ``dtype``
        converts per slab (None keeps the input dtype)."""
        kwargs = {}
        ndim = getattr(data, "ndim", 0)
        if compression and ndim > 0:
            kwargs = dict(compression="gzip", compression_opts=int(compression), shuffle=True)
        is_np = isinstance(data, np.ndarray)
        out_dtype = np.dtype(dtype) if dtype is not None else np.dtype(data.dtype)
        if ndim > 0 and (not is_np or out_dtype != data.dtype):
            ds = self._f.create_dataset(name, shape=data.shape, dtype=out_dtype, **kwargs)
            row_bytes = max(int(np.prod(data.shape[1:], dtype=np.int64)) * out_dtype.itemsize, 1)
            slab = max(128 * 2**20 // row_bytes, 1)
            # One-slab-ahead prefetch: the device->host pull of slab i+1
            # runs on a worker thread while slab i is being written to disk.
            with ThreadPoolExecutor(max_workers=1) as ex:
                n_rows = data.shape[0]
                nxt = ex.submit(lambda a: np.asarray(a), data[0:slab])
                for i0 in range(0, n_rows, slab):
                    cur = nxt.result()
                    if i0 + slab < n_rows:
                        nxt = ex.submit(lambda a: np.asarray(a), data[i0 + slab : i0 + 2 * slab])
                    ds[i0 : i0 + slab] = cur
        else:
            ds = self._f.create_dataset(name, data=np.asarray(data), **kwargs)
        for axis, dim in enumerate(dims):
            ds.dims[axis].attach_scale(self._dims[dim])
        for k, v in (attrs or {}).items():
            ds.attrs[k] = np.bytes_(v.encode()) if isinstance(v, str) else v
        return ds

    def def_var_empty(self, name: str, shape: tuple, dims: tuple[str, ...], dtype, compression: int = 0, attrs: Optional[dict] = None):
        """Define a data variable without writing values (filled later by the
        caller slicing the returned h5py dataset) — the incremental-output
        path for windowed/chunked runs where the full array never exists."""
        kwargs = {}
        if compression and len(shape) > 0:
            kwargs = dict(compression="gzip", compression_opts=int(compression), shuffle=True)
        ds = self._f.create_dataset(name, shape=shape, dtype=np.dtype(dtype), **kwargs)
        for axis, dim in enumerate(dims):
            ds.dims[axis].attach_scale(self._dims[dim])
        for k, v in (attrs or {}).items():
            ds.attrs[k] = np.bytes_(v.encode()) if isinstance(v, str) else v
        return ds

    def set_attr(self, name: str, value):
        self._f.attrs[name] = np.bytes_(value.encode()) if isinstance(value, str) else value

    def set_dim_attrs(self, dim: str, attrs: dict):
        """Attach attributes (long_name, units, ...) to a coordinate variable."""
        ds = self._dims[dim]
        for k, v in attrs.items():
            ds.attrs[k] = np.bytes_(v.encode()) if isinstance(v, str) else v

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_grid_forcing(
    path: str,
    var_name: str,
    data: np.ndarray,
    time_vals: Optional[np.ndarray] = None,
    lat_vals: Optional[np.ndarray] = None,
    lon_vals: Optional[np.ndarray] = None,
    attrs: Optional[dict] = None,
    time_attrs: Optional[dict] = None,
    classic: bool = False,
) -> None:
    """Write a (time, lat, lon) float32 forcing grid (ERA5-Land-shaped).

    Used by tests/benchmarks to synthesize forcing files with the layout the
    reference consumes (pr_hourly_era5land_2019.nc etc., main.cpp:508-515).
    ``time_attrs`` (e.g. {"units": "hours since 2019-01-01"}) enables dt
    inference by forcing folder discovery.  ``classic=True`` writes classic
    NetCDF (64-bit offset) through scipy instead of NETCDF4 through h5py.
    """
    data = np.asarray(data, np.float32)
    n_t, n_lat, n_lon = data.shape
    if classic:
        from scipy.io import netcdf_file

        coords = {"time": time_vals, "lat": lat_vals, "lon": lon_vals}
        with netcdf_file(path, "w", version=2) as f:
            for name, n in (("time", n_t), ("lat", n_lat), ("lon", n_lon)):
                f.createDimension(name, n)
                v = f.createVariable(name, "f8", (name,))
                c = coords[name]
                v[:] = np.arange(n, dtype=np.float64) if c is None else c
            for k, val in (time_attrs or {}).items():
                setattr(f.variables["time"], k, val)
            v = f.createVariable(var_name, "f4", ("time", "lat", "lon"))
            v[:] = data
            for k, val in (attrs or {}).items():
                setattr(v, k, val)
        return
    with NetCDFWriter(path) as w:
        w.def_dim("time", n_t, time_vals, "f8")
        w.def_dim("lat", n_lat, lat_vals, "f8")
        w.def_dim("lon", n_lon, lon_vals, "f8")
        if time_attrs:
            w.set_dim_attrs("time", time_attrs)
        w.def_var(var_name, data, ("time", "lat", "lon"), attrs=attrs)
