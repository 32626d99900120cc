"""StreamSet facade and checkpoint reorder/roundtrip behavior."""

import numpy as np
import pytest

from tiger_tpu import checkpoint as ckpt
from tiger_tpu.streams import StreamSet


def test_streamset_from_reference_csv():
    if not __import__("pathlib").Path("/root/reference/data/small_test.csv").exists():
        pytest.skip("reference mount absent")
    ss = StreamSet.from_csv("/root/reference/data/small_test.csv", (0.01, 3.0, 0.0, 5.0, 0.2))
    assert len(ss) == 10
    assert ss.y0.shape == (10, 5)
    np.testing.assert_allclose(ss.y0[3], [0.01, 3.0, 0.0, 5.0, 0.2])
    assert set(ss.model_params()) >= {"Hu", "n_mann", "alpha3"}
    # Topology resolves (links may drain outside the 10-link sample).
    topo = ss.topology
    assert topo.next_idx.shape == (10,)
    sub = ss.subset([0, 2, 4])
    assert len(sub) == 3
    np.testing.assert_array_equal(sub.ids, ss.ids[[0, 2, 4]])


def test_checkpoint_reorder_and_missing(tmp_path):
    path = str(tmp_path / "state.nc")
    y = np.arange(12, dtype=np.float64).reshape(4, 3)
    ids = np.array([40, 10, 30, 20])
    ckpt.save_state(path, y, ids, 777.0)

    # Permuted subset: rows must follow the requested id order.
    y2, ids2, t = ckpt.load_state(path, link_ids=np.array([20, 40]))
    assert t == 777.0
    np.testing.assert_array_equal(ids2, [20, 40])
    np.testing.assert_array_equal(y2, y[[3, 0]])

    with pytest.raises(KeyError, match="missing links"):
        ckpt.load_state(path, link_ids=np.array([99]))

    # Full load without reorder returns file order.
    y3, ids3, _ = ckpt.load_state(path)
    np.testing.assert_array_equal(ids3, ids)
    np.testing.assert_array_equal(y3, y)


def test_cold_state_broadcast():
    y = ckpt.cold_state((1.0, 2.0), 5)
    assert y.shape == (5, 2)
    np.testing.assert_array_equal(y[4], [1.0, 2.0])


def test_resume_requires_checkpoint_time_attr(tmp_path):
    """A plain final-state file (no sim_time_minutes) must be rejected as a
    crash-resume point instead of silently restarting from t=0."""
    import pytest

    from tiger_tpu import checkpoint as ckpt
    from tiger_tpu.io.output import write_final_netcdf

    path = str(tmp_path / "final.nc")
    write_final_netcdf(path, np.zeros((3, 5)), np.arange(1, 4))
    y, ids, t = ckpt.load_state(path)  # plain hot start: allowed, t=0
    assert t == 0.0
    with pytest.raises(ValueError, match="not a resumable checkpoint"):
        ckpt.load_state(path, require_time=True)


def test_state_file_is_classic_netcdf(tmp_path, monkeypatch):
    """Checkpoints are classic NetCDF written through scipy: saving and
    loading one needs no HDF5 library."""
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    path = str(tmp_path / "state.nc")
    y = np.random.default_rng(0).uniform(size=(5, 3)).astype(np.float32)
    ckpt.save_state(path, y, np.array([3, 1, 4, 15, 92]), 1440.0)
    with open(path, "rb") as f:
        assert f.read(3) == b"CDF"
    y2, ids, t = ckpt.load_state(path, require_time=True)
    assert t == 1440.0
    np.testing.assert_array_equal(ids, [3, 1, 4, 15, 92])
    np.testing.assert_array_equal(y2, y)


def test_classic_grid_forcing_reads_back(tmp_path):
    from tiger_tpu.io.netcdf import NetCDFReader, write_grid_forcing

    data = np.random.default_rng(1).uniform(size=(6, 3, 4)).astype(np.float32)
    path = str(tmp_path / "pr.nc")
    write_grid_forcing(path, "pr", data, time_attrs={"units": "hours since 2019-01-01"},
                       classic=True)
    with NetCDFReader(path, "pr") as r:
        assert (r.time_size, r.lat_size, r.lon_size) == (6, 3, 4)
        np.testing.assert_array_equal(r.load_time_chunk(2, 3), data[2:5])
        vals, units = r.time_info()
        np.testing.assert_array_equal(vals, np.arange(6))
        assert units == "hours since 2019-01-01"


def test_windowed_csv_writer_appends_and_resumes(tmp_path):
    """Window-by-window CSV equals the one-shot legacy dense CSV; a resume
    truncates rows written after the resume point instead of duplicating
    them."""
    from tiger_tpu.io.output import WindowedCSVWriter, write_dense_csv

    qt = np.arange(6) * 60.0
    blk = np.random.default_rng(2).uniform(size=(3, 6, 2))
    cols = [f"var{i}_sys{s}" for s in range(3) for i in range(2)]
    path, ref = str(tmp_path / "d.csv"), str(tmp_path / "ref.csv")
    write_dense_csv(ref, blk, qt)
    with WindowedCSVWriter(path, cols, qt) as w:
        w.write(0, blk[:, :2])
        w.write(2, blk[:, 2:])
    assert open(path).read() == open(ref).read()
    with WindowedCSVWriter(path, cols, qt, resume=True) as w:
        w.write(3, blk[:, 3:])
    assert open(path).read() == open(ref).read()
    with pytest.raises(ValueError, match="header"):
        WindowedCSVWriter(path, cols[:-1], qt, resume=True)


def test_cli_csv_chunked_resume_without_h5py(tmp_path, monkeypatch):
    """The CLI on a gridded basin with classic NetCDF forcing, CSV output,
    routed discharge and a checkpoint at the window boundary, with h5py
    unavailable: a run resumed from the first window's checkpoint
    reproduces the straight run bitwise (chip_smoke.py's cli phase, at a
    small size, on one device as on one card)."""
    import sys

    import chip_smoke
    from tiger_tpu import run as cli

    real_run = cli.run
    monkeypatch.setattr(cli, "run", lambda cfg, **kw: real_run(cfg, use_mesh=False, **kw))
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(chip_smoke.tempfile, "mkdtemp", lambda prefix: str(tmp_path))
    monkeypatch.setattr(chip_smoke, "peak_bytes", lambda dev=None: -1)
    chip_smoke.phase_cli(n_links=16)
