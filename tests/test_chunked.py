"""Time-chunked solving: windowed streaming must match the unchunked run."""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.test_model204 import NB_PARAMS
from tiger_tpu.chunked import netcdf_window_loader, solve_chunked
from tiger_tpu.forcing import ForcingSet, ForcingSpec
from tiger_tpu.models import Model204, Y0_COMMON
from tiger_tpu.solver import SolverConfig, solve


@pytest.fixture
def scenario():
    rng = np.random.default_rng(21)
    n_sys = 4
    hours = 96  # 4 days
    pr = rng.uniform(0, 0.0015, (hours, n_sys)).astype(np.float32)
    t2m = rng.uniform(2, 12, (4, n_sys)).astype(np.float32)
    params = {k: jnp.full((n_sys,), v) for k, v in NB_PARAMS.items()}
    y0 = jnp.tile(jnp.asarray(Y0_COMMON), (n_sys, 1))
    return pr, t2m, params, y0


def test_chunked_matches_unchunked(scenario):
    pr, t2m, params, y0 = scenario
    tf = 4 * 1440.0

    full = ForcingSet.from_series([pr, t2m], [60.0, 1440.0])
    ref = solve(Model204(), y0, 0.0, tf, jnp.arange(0.0, tf + 1, 360.0),
                params=params, forcings=full)

    def load_window(w_start, w_end):
        k_pr = int(w_start // 60)
        k_t2m = int(w_start // 1440)
        return ForcingSet.from_series(
            [pr[k_pr : int(np.ceil(w_end / 60))], t2m[k_t2m : int(np.ceil(w_end / 1440))]],
            [60.0, 1440.0],
        )

    res = solve_chunked(
        Model204(), y0, 0.0, tf, chunk_minutes=1440.0,
        load_window=load_window, query_interval=360.0, params=params,
    )
    assert res.dense.shape == ref.dense.shape
    # Window restarts perturb step sequences; with time-varying forcing the
    # frozen-at-step-start sampling then accumulates O(h)-at-boundary
    # differences (same effect as tests/test_pallas_kernel.py) — percent level.
    np.testing.assert_allclose(
        np.asarray(res.y_final), np.asarray(ref.y_final), rtol=2e-2, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(res.dense), np.asarray(ref.dense), rtol=2e-2, atol=5e-4
    )
    # t0 row prefilled once.
    np.testing.assert_allclose(np.asarray(res.dense[:, 0, :]), np.asarray(y0))


def test_netcdf_window_loader(tmp_path, scenario):
    from tiger_tpu.io import write_grid_forcing

    pr, t2m, params, y0 = scenario
    n_sys = pr.shape[1]
    # Grids where each system maps to its own cell.
    pr_g = pr.reshape(pr.shape[0], 1, n_sys)
    t2m_g = t2m.reshape(t2m.shape[0], 1, n_sys)
    write_grid_forcing(str(tmp_path / "pr.nc"), "pr", pr_g)
    write_grid_forcing(str(tmp_path / "t2m.nc"), "t2m", t2m_g)
    streams = np.arange(1, n_sys + 1)
    with open(tmp_path / "lookup.csv", "w") as f:
        f.write("stream,lat_index,lon_index\n")
        for i, s in enumerate(streams):
            f.write(f"{s},0,{i}\n")

    specs = [
        ForcingSpec(str(tmp_path / "pr.nc"), "pr", 1.0),
        ForcingSpec(str(tmp_path / "t2m.nc"), "t2m", 24.0),
    ]
    loader = netcdf_window_loader(specs, streams, str(tmp_path / "lookup.csv"))
    fs = loader(1440.0, 2880.0)
    np.testing.assert_array_equal(np.asarray(fs.data[:24]), pr[24:48])
    np.testing.assert_array_equal(np.asarray(fs.data[24]), t2m[1])

    with pytest.raises(ValueError, match="not aligned"):
        loader(30.0, 1470.0)


def test_chunked_with_routing_overlap(scenario):
    from tiger_tpu import routing

    pr, t2m, params, y0 = scenario
    n_sys = pr.shape[1]
    stream = np.arange(1, n_sys + 1)
    nxt = np.concatenate([stream[1:], [-1]])
    topo = routing.build_topology(stream, nxt)
    tf = 2 * 1440.0

    def load_window(w_start, w_end):
        k = int(w_start // 60)
        kt = int(w_start // 1440)
        return ForcingSet.from_series(
            [pr[k : int(np.ceil(w_end / 60))], t2m[kt : int(np.ceil(w_end / 1440))]],
            [60.0, 1440.0],
        )

    res, routed = solve_chunked(
        Model204(), y0, 0.0, tf, chunk_minutes=1440.0,
        load_window=load_window, query_interval=360.0, params=params,
        topology=topo,
    )
    assert routed.shape == (n_sys, res.dense.shape[1])
    ref = np.asarray(routing.routed_discharge(jnp.nan_to_num(res.dense), params, topo))
    np.testing.assert_allclose(np.asarray(routed), ref, rtol=1e-12)
    # Accumulation property: the outlet carries the basin total.
    assert np.all(np.asarray(routed)[-1, 1:] >= np.asarray(routed)[0, 1:] - 1e-12)


def test_chunked_queries_survive_misaligned_interval():
    # chunk_minutes=100 is NOT a multiple of query_interval=30: every multiple
    # of 30 in [0, 200] must still appear exactly once (the round-1 code
    # dropped t=120, the first query inside window [100, 200]).
    from tiger_tpu.models import DummyModel

    y0 = jnp.ones((2, 5))
    res = solve_chunked(
        DummyModel(), y0, 0.0, 200.0, chunk_minutes=100.0,
        load_window=lambda a, b: None, query_interval=30.0,
        config=SolverConfig(rtol=1e-6, atol=1e-9),
    )
    assert res.dense.shape[1] == 7  # t = 0, 30, 60, 90, 120, 150, 180

    ref = solve(DummyModel(), y0, 0.0, 200.0, jnp.arange(0.0, 200.0, 30.0),
                config=SolverConfig(rtol=1e-6, atol=1e-9))
    np.testing.assert_allclose(
        np.asarray(res.dense), np.asarray(ref.dense), rtol=1e-4, atol=1e-8
    )


def test_dense_sink_matches_accumulated(scenario, tmp_path):
    """dense_sink streaming == the accumulated dense, bitwise; and the
    WindowedVarWriter file equals write_dense_netcdf of the full array."""
    import h5py

    from tiger_tpu import routing
    from tiger_tpu.io import write_dense_netcdf
    from tiger_tpu.io.output import WindowedVarWriter

    pr, t2m, params, y0 = scenario
    n_sys = pr.shape[1]
    stream = np.arange(1, n_sys + 1)
    topo = routing.build_topology(stream, np.concatenate([stream[1:], [-1]]))
    tf = 2 * 1440.0

    def load_window(w_start, w_end):
        k = int(w_start // 60)
        kt = int(w_start // 1440)
        return ForcingSet.from_series(
            [pr[k : int(np.ceil(w_end / 60))], t2m[kt : int(np.ceil(w_end / 1440))]],
            [60.0, 1440.0],
        )

    kw = dict(
        chunk_minutes=1440.0, load_window=load_window, query_interval=360.0,
        params=params, topology=topo,
    )
    ref, ref_routed = solve_chunked(Model204(), y0, 0.0, tf, **kw)
    qt_all = np.arange(0.0, tf + 1e-9, 360.0)
    n_q = len(qt_all)

    got = np.full((n_sys, n_q, 5), np.nan, np.float64)
    got_routed = np.full((n_sys, n_q), np.nan, np.float64)
    seen_q0 = []
    with WindowedVarWriter(
        str(tmp_path / "dense.nc"), "outputs", stream, qt_all,
        state_ids=np.arange(5, dtype=np.int32), dtype=np.float64,
    ) as w:

        def sink(q0, qt_abs, dense_blk, routed_blk):
            seen_q0.append(q0)
            np.testing.assert_allclose(qt_abs, qt_all[q0 : q0 + len(qt_abs)])
            got[:, q0 : q0 + dense_blk.shape[1]] = np.asarray(dense_blk)
            got_routed[:, q0 : q0 + routed_blk.shape[1]] = np.asarray(routed_blk)
            w.write(q0, dense_blk)

        res, routed_empty = solve_chunked(
            Model204(), y0, 0.0, tf, dense_sink=sink, **kw
        )

    assert res.dense.shape == (n_sys, 0, 5) and routed_empty.shape == (n_sys, 0)
    assert seen_q0 == [0, 5]  # two windows; every query covered exactly once
    np.testing.assert_array_equal(got, np.asarray(ref.dense))
    np.testing.assert_array_equal(got_routed, np.asarray(ref_routed))
    np.testing.assert_array_equal(np.asarray(res.y_final), np.asarray(ref.y_final))

    # The incrementally-written file is indistinguishable from a full write.
    write_dense_netcdf(
        str(tmp_path / "full.nc"), np.asarray(ref.dense), qt_all, stream,
        dtype=np.float64,
    )
    with h5py.File(tmp_path / "dense.nc") as fa, h5py.File(tmp_path / "full.nc") as fb:
        np.testing.assert_array_equal(fa["outputs"][...], fb["outputs"][...])
        np.testing.assert_array_equal(fa["time"][...], fb["time"][...])
        np.testing.assert_array_equal(fa["system"][...], fb["system"][...])
        assert fa["outputs"].dims[1][0].name == fb["outputs"].dims[1][0].name


def test_chunked_rejects_misaligned_forcing_dt(scenario):
    pr, t2m, params, y0 = scenario

    def load_window(w_start, w_end):
        return ForcingSet.from_series([pr[:24]], [60.0])

    with pytest.raises(ValueError, match="not a multiple of"):
        solve_chunked(
            Model204(), y0, 0.0, 2880.0, chunk_minutes=90.0,
            load_window=load_window, params=params,
        )


def test_crash_resume_bitwise(tmp_path, monkeypatch):
    """Kill a chunked CLI run mid-stream, resume from the periodic checkpoint,
    and get outputs bitwise-identical to an uninterrupted run."""
    import h5py

    from tests.test_cli import make_scenario
    from tiger_tpu import checkpoint as ckpt
    from tiger_tpu import chunked as chunked_mod
    from tiger_tpu.config import load_config
    from tiger_tpu.run import run

    sc = make_scenario(tmp_path)

    def cfg_for(outdir, **initial):
        cfg = load_config(str(sc["cfg_path"]))
        cfg.time.chunk_days = 1.0
        cfg.output.checkpoint_interval = "1d"
        cfg.output.path = str(tmp_path / outdir)
        if initial:
            for k, v in initial.items():
                setattr(cfg.initial, k, v)
        return cfg

    # Reference: uninterrupted chunked run (2 days = 2 windows).
    run(cfg_for("ref"), use_mesh=False)

    # Crash: the second window's solve dies after the first window's
    # checkpoint (t=1440) has been written.
    real_solve = chunked_mod.solve
    calls = {"n": 0}

    def dying_solve(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return real_solve(*a, **kw)

    monkeypatch.setattr(chunked_mod, "solve", dying_solve)
    with pytest.raises(RuntimeError, match="simulated crash"):
        run(cfg_for("crashed"), use_mesh=False)
    monkeypatch.setattr(chunked_mod, "solve", real_solve)

    state_path = tmp_path / "crashed" / "state_basin_rank_0.nc"
    assert state_path.exists()
    assert ckpt.load_state(str(state_path))[2] == 1440.0

    # Resume from the checkpoint into the SAME output files.
    run(
        cfg_for("crashed", mode="hot", file=str(state_path), resume=True),
        use_mesh=False,
    )

    np.testing.assert_array_equal(
        ckpt.load_state(str(tmp_path / "ref" / "state_basin_rank_0.nc"))[0],
        ckpt.load_state(str(state_path))[0],
    )
    for name in ("dense_basin_rank_0.nc", "discharge_basin_rank_0.nc",
                 "final_basin_rank_0.nc"):
        with h5py.File(tmp_path / "ref" / name) as fa, \
                h5py.File(tmp_path / "crashed" / name) as fb:
            key = [k for k in ("outputs", "discharge") if k in fa][0]
            np.testing.assert_array_equal(fa[key][...], fb[key][...])


def test_resume_rejects_misaligned_time(tmp_path):
    from tests.test_cli import make_scenario
    from tiger_tpu import checkpoint as ckpt
    from tiger_tpu.config import load_config
    from tiger_tpu.run import run

    sc = make_scenario(tmp_path)
    cfg = load_config(str(sc["cfg_path"]))
    cfg.time.chunk_days = 1.0
    cfg.output.path = str(tmp_path / "out")
    run(cfg, use_mesh=False)  # produces the full-extent output files

    state = tmp_path / "out" / "state_basin_rank_0.nc"
    y, ids, _ = ckpt.load_state(str(state))
    ckpt.save_state(str(state), y, ids, 1500.0)  # not a window boundary

    cfg2 = load_config(str(sc["cfg_path"]))
    cfg2.time.chunk_days = 1.0
    cfg2.output.path = str(tmp_path / "out")
    cfg2.initial.mode = "hot"
    cfg2.initial.file = str(state)
    cfg2.initial.resume = True
    with pytest.raises(ValueError, match="not aligned"):
        run(cfg2, use_mesh=False)


def test_chunked_resolves_stiff_lanes_per_window():
    """Stiff-flagged lanes are resolved inside each window (Radau retry) and
    their corrected states feed the next window's start."""
    from tests.test_solve_device_rung import StiffMix

    s = 8
    lam = np.full(s, -0.05, np.float32)
    lam[[2, 5]] = -1e6
    y0 = jnp.ones((s, 5))
    params = {"lam": jnp.asarray(lam, y0.dtype)}
    cfg = SolverConfig(rtol=1e-6, atol=1e-9)

    ref = solve(StiffMix(), y0, 0.0, 100.0, jnp.asarray([50.0, 100.0]),
                params=params, config=cfg)
    res = solve_chunked(
        StiffMix(), y0, 0.0, 100.0, chunk_minutes=50.0,
        load_window=lambda a, b: None, query_interval=50.0,
        params=params, config=cfg,
    )
    assert res.n_stiff >= 2 and not np.asarray(res.failed).any()
    np.testing.assert_allclose(
        np.asarray(res.y_final), np.asarray(ref.y_final), rtol=1e-5, atol=1e-12
    )
    # Window-1 dense row for the stiff lanes reflects the *resolved* window-0
    # state carried forward, not NaN/stale values.
    assert np.isfinite(np.asarray(res.dense)).all()


def test_chunked_on_mesh_matches_single_device():
    """solve_chunked(mesh=8 virtual devices) == solve_chunked().

    Smooth dynamics (DummyModel): 1-row-per-shard XLA programs differ in
    last-ulp arithmetic from the single-device program, which Model-204's
    melt kink would amplify chaotically across windows — here the plumbing
    (window carry, per-window sharded solves) is what's under test, and the
    tolerance stays at rounding level.  (Bitwise mesh equality at realistic
    shard sizes is pinned by tests/test_dist_equiv.py.)
    """
    import jax

    from tiger_tpu.dist import systems_mesh
    from tiger_tpu.models import DummyModel

    y0 = jnp.tile(jnp.linspace(0.5, 2.0, 5)[None, :], (8, 1)) * jnp.arange(
        1, 9
    )[:, None] / 4.0
    ref = solve_chunked(
        DummyModel(), y0, 0.0, 4.0, chunk_minutes=1.0,
        load_window=lambda a, b: None, query_interval=0.5,
    )
    mesh = systems_mesh(jax.devices()[:8])
    res = solve_chunked(
        DummyModel(), y0, 0.0, 4.0, chunk_minutes=1.0,
        load_window=lambda a, b: None, query_interval=0.5,
        mesh=mesh,
    )
    np.testing.assert_allclose(
        np.asarray(res.y_final), np.asarray(ref.y_final), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(res.dense), np.asarray(ref.dense), rtol=1e-12, atol=1e-12
    )


class TimeProbe:
    """dy/dt = cos(2*pi*t / 1440) — depends ONLY on absolute time, so any
    window-relative time leak in chunked solving shows up immediately."""

    N_EQ = 1
    UID = 901

    def rhs(self, t, y, params, forcings=None):
        return jnp.broadcast_to(
            jnp.cos(2.0 * jnp.pi * t / 1440.0), np.shape(y)
        ).astype(y.dtype)

    def rhs_tuple(self, t, y, params, forcings=None):
        return tuple(jnp.cos(2.0 * jnp.pi * t / 1440.0) + 0.0 * yi for yi in y)


def test_chunked_passes_absolute_time_to_model():
    """Time-dependent physics must see ABSOLUTE simulation time in chunked
    runs (window-relative time froze Model 200's day-of-year)."""
    model = TimeProbe()
    y0 = jnp.zeros((3, 1))
    tf = 2880.0
    qt = jnp.arange(0.0, tf + 1, 360.0)
    ref = solve(model, y0, 0.0, tf, qt)
    res = solve_chunked(
        model, y0, 0.0, tf, chunk_minutes=720.0,
        load_window=lambda a, b: None, query_interval=360.0,
    )
    # Exact integral: y(t) = (1440 / 2pi) * sin(2pi t / 1440), amplitude 229;
    # a window-relative time leak would instead accumulate monotonically
    # (every window re-integrates the first quarter-wave).
    exact = 1440.0 / (2 * np.pi) * np.sin(2 * np.pi * np.asarray(qt) / 1440.0)
    np.testing.assert_allclose(
        np.asarray(res.dense)[:, :, 0],
        np.broadcast_to(exact, (3, len(exact))),
        rtol=1e-5, atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(res.y_final), np.asarray(ref.y_final), rtol=1e-6, atol=1e-3
    )


def test_solve_t_shift_pallas_interpret_matches_absolute():
    """The kernel path applies t_shift to the model rhs identically to an
    absolute-time integration (forcing gathers stay window-relative)."""
    from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas

    model = TimeProbe()
    y0 = jnp.zeros((4, 1), jnp.float32)
    h0 = jnp.full((4,), 1.0, jnp.float32)
    shift = 4320.0  # integrate the quarter-wave [shift, shift+360]
    abs_run = rk45_solve_pallas(
        model, y0, shift, shift + 360.0, None, h0=h0, interpret=True
    )
    rel_run = rk45_solve_pallas(
        model, y0, 0.0, 360.0, None, h0=h0, interpret=True, t_shift=shift
    )
    exact = 1440.0 / (2 * np.pi)  # sin increment over a quarter wave
    np.testing.assert_allclose(np.asarray(abs_run.y_final), exact, rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(rel_run.y_final), np.asarray(abs_run.y_final), rtol=1e-4
    )


def test_checkpoint_interval_rejects_offgrid_windows(tmp_path):
    """checkpoint_interval with window ends off the query grid must refuse
    up front (such checkpoints could never be resumed)."""
    from tests.test_cli import make_scenario
    from tiger_tpu.config import load_config
    from tiger_tpu.run import run

    sc = make_scenario(tmp_path)
    cfg = load_config(str(sc["cfg_path"]))
    cfg.time.chunk_days = 1.5
    cfg.output.print_interval = "1d"
    cfg.output.checkpoint_interval = "1d"
    cfg.output.path = str(tmp_path / "out")
    with pytest.raises(ValueError, match="multiple of"):
        run(cfg, use_mesh=False)


def test_chunked_i16_packed_output(tmp_path):
    """Streamed CF int16 dense output (output.precision i16 + declared
    output.i16_ranges — previously refused for chunked runs): decoded values
    match an f64 chunked run within half a quantization step, and the dense
    payload is 4x smaller."""
    import h5py

    from tests.test_cli import make_scenario
    from tiger_tpu.config import load_config
    from tiger_tpu.run import run

    sc = make_scenario(tmp_path)

    def cfg_for(outdir, precision, ranges=None):
        cfg = load_config(str(sc["cfg_path"]))
        cfg.time.chunk_days = 1.0
        cfg.output.path = str(tmp_path / outdir)
        cfg.output.precision = precision
        cfg.output.i16_ranges = ranges
        return cfg

    run(cfg_for("ref64", "f64"), use_mesh=False)
    ranges = {0: (0.0, 0.05), 1: (0.0, 4.0), 2: (0.0, 0.01),
              3: (0.0, 6.0), 4: (0.0, 1.0)}
    run(cfg_for("i16", "i16", ranges), use_mesh=False)

    with h5py.File(tmp_path / "ref64" / "dense_basin_rank_0.nc") as f:
        ref = np.asarray(f["outputs"])
        f64_bytes = f["outputs"].nbytes
    i16_bytes = 0
    with h5py.File(tmp_path / "i16" / "dense_basin_rank_0.nc") as f:
        for v, (lo, hi) in ranges.items():
            ds = f[f"outputs_{v}"]
            assert ds.dtype == np.int16
            i16_bytes += ds.nbytes
            scale = ds.attrs["scale_factor"]
            dec = np.asarray(ds) * scale + ds.attrs["add_offset"]
            # Out-of-declared-range values saturate at the range edge.
            exp = np.clip(ref[:, :, v], lo, hi)
            assert np.abs(dec - exp).max() <= 0.75 * scale, (v, scale)
    assert i16_bytes * 4 == f64_bytes

    # Validation: chunked i16 without declared ranges is refused with a
    # pointer at i16_ranges; a range missing an output state is refused too.
    with pytest.raises(ValueError, match="i16_ranges"):
        run(cfg_for("bad", "i16", None), use_mesh=False)
    partial = {k: v for k, v in ranges.items() if k != 3}
    with pytest.raises(ValueError, match="missing output states"):
        run(cfg_for("bad2", "i16", partial), use_mesh=False)
