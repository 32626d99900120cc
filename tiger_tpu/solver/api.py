"""Two-phase solve: RK45 over all systems, then Radau IIA over the stiff subset.

Analog of the reference host orchestration
(src/solver/rk45_api.hpp:159-313): the RK45 phase runs jitted over the whole
batch; stiff flags are pulled to the host, compacted into a dense index list
(padded to a small set of bucket sizes to bound recompilation), and the Radau
phase re-integrates just that subset from t0, overwriting its final states and
dense rows.  The reference does the same gather on the CPU
(rk45_api.hpp:190-203) before launching the Radau kernel over n_stiff threads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tiger_tpu.forcing import ForcingSet
from tiger_tpu.solver.config import SolverConfig
from tiger_tpu.solver.controller import initial_step
from tiger_tpu.solver.radau import RadauStats, radau_solve
from tiger_tpu.solver.rk45 import RKStats, rk45_solve

# Opt-in phase attribution (benchmarks/e2e_profile.py): with TT_PHASE_PROFILE=1
# each phase blocks on its outputs and records wall seconds here.  Off by
# default — the syncs would serialize device/host overlap in production runs.
import os as _os
import time as _time

_phase_times: dict = {}


def _env_flag(name: str) -> bool:
    """Env hook truthiness: '', '0', 'false' (any case) all mean OFF."""
    return _os.environ.get(name, "").strip().lower() not in ("", "0", "false")


def _phase_mark(name: str, t_start: float, *block_on) -> None:
    if not _env_flag("TT_PHASE_PROFILE"):
        return
    for a in block_on:
        if a is not None:
            jax.block_until_ready(a)
    _phase_times[name] = _phase_times.get(name, 0.0) + _time.perf_counter() - t_start


class SolveResult(NamedTuple):
    y_final: jax.Array  # [S, N]
    dense: jax.Array  # [S, Q, N]
    stiff: jax.Array  # [S] bool — went through the Radau phase
    failed: jax.Array  # [S] bool — did not finish in either phase
    rk_stats: RKStats
    # [S]-shaped per-lane Radau counters (zeros for lanes that never entered
    # the stiff phase); None when no lane did.  Segmented host retries track
    # no counters, so their lanes stay zero.
    radau_stats: Optional[RadauStats]
    n_stiff: int
    # Lanes re-integrated by the host float64 pipeline (the fallback behind
    # the device rung on kernel runs; every flagged lane on vmap runs).
    n_host: int = 0


def _scatter_stats(
    acc: Optional[RadauStats], stats, idx_abs: np.ndarray, s_count: int
) -> RadauStats:
    """Accumulate a stiff-subset stats tuple (bucket-padded; first
    ``len(idx_abs)`` entries are real) into full-batch [S] arrays, so
    consumers never see padding lanes or need to know bucket internals."""
    if acc is None:
        acc = RadauStats(
            n_accepted=np.zeros(s_count, np.int64),
            n_rejected=np.zeros(s_count, np.int64),
            n_attempts=np.zeros(s_count, np.int64),
            n_newton=np.zeros(s_count, np.int64),
            n_fact=np.zeros(s_count, np.int64),
        )
    out = []
    for have, field in zip(acc, stats):
        if field is not None:
            have = np.asarray(have).copy()
            have[idx_abs] += np.asarray(field)[: len(idx_abs)]
        out.append(have)
    return RadauStats(*out)


def _host_pull(arr):
    """``np.asarray`` that also works for non-addressable arrays (cross-
    process GLOBAL mesh): reshards to fully-replicated first, after which
    every process holds an identical full copy.  Only ever applied to the
    stiff working set and its [S] masks — small by design (the reference
    host-compacts the same subset, rk45_api.hpp:190-203); every process then
    runs the identical stiff pipeline redundantly, so the SPMD merge below
    sees the same replicated updates on every rank."""
    if arr is None:
        return None
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    from jax.sharding import NamedSharding, PartitionSpec

    rep = NamedSharding(arr.sharding.mesh, PartitionSpec())
    return np.asarray(jax.jit(lambda x: x, out_shardings=rep)(arr))


def _bucket(n: int) -> int:
    """Round up to a power of two (min 8) so Radau recompiles O(log S) times."""
    b = 8
    while b < n:
        b *= 2
    return b


import functools


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _merge_apply(y_final, dense, failed, rows, y_part, dense_part, failed_part):
    """Scatter the stiff-pass results back into the full-batch outputs.

    ONE jitted donated call: eager ``.at[].set`` here copies the multi-GB
    dense buffer per op at 1M-system scale; jitted with donation it is an
    in-place scatter.  ``rows`` is padded to a bucket size
    with out-of-range sentinels (mode='drop') so shapes stay stable across
    runs and the compile caches.
    """
    y_final = y_final.at[rows].set(y_part.astype(y_final.dtype), mode="drop")
    dense = dense.at[rows].set(dense_part.astype(dense.dtype), mode="drop")
    failed = failed.at[rows].set(failed_part, mode="drop")
    return y_final, dense, failed


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _merge_gather_apply(y_final, dense, failed, rows, y_src, dense_src, rel):
    """Device-rung variant of _merge_apply: the parts still live on the
    accelerator, so gather them inside the same jitted program."""
    y_part = jnp.take(y_src, rel, axis=0)
    dense_part = jnp.take(dense_src, rel, axis=0)
    y_final = y_final.at[rows].set(y_part.astype(y_final.dtype), mode="drop")
    dense = dense.at[rows].set(dense_part.astype(dense.dtype), mode="drop")
    failed = failed.at[rows].set(jnp.zeros(rows.shape, bool), mode="drop")
    return y_final, dense, failed


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _merge_gather_apply_masked(y_final, dense, failed, rows, y_src, dense_src,
                               failed_src):
    """Device-AUTONOMOUS rung merge: failed lanes keep their current values
    via an on-device mask, so the scatter needs no host-side ok-lane list —
    it dispatches BEFORE the failed/stats pull and its execution overlaps
    that host round trip instead of serializing behind it.
    ``rows`` carries out-of-range sentinels for bucket-padding lanes
    (mode='drop')."""
    safe = jnp.minimum(rows, y_final.shape[0] - 1)
    cur_y = jnp.take(y_final, safe, axis=0)
    cur_d = jnp.take(dense, safe, axis=0)
    cur_f = jnp.take(failed, safe, axis=0)
    m = failed_src
    y_part = jnp.where(m[:, None], cur_y, y_src.astype(y_final.dtype))
    d_part = jnp.where(m[:, None, None], cur_d, dense_src.astype(dense.dtype))
    f_part = jnp.where(m, cur_f, jnp.zeros_like(cur_f))
    y_final = y_final.at[rows].set(y_part, mode="drop")
    dense = dense.at[rows].set(d_part, mode="drop")
    failed = failed.at[rows].set(f_part, mode="drop")
    return y_final, dense, failed


@functools.partial(jax.jit, static_argnames=("bucket", "fill"))
def _stiff_rows_jit(mask, bucket, fill):
    """Device-side stiff compaction: the first ``bucket`` flagged rows in
    ascending order, sentinel ``fill`` beyond the flag count — the input to
    the SPECULATIVE rung dispatch (no host round trip; the reference does
    this gather on the CPU, rk45_api.hpp:190-203)."""
    return jnp.nonzero(mask, size=bucket, fill_value=fill)[0].astype(jnp.int32)


@jax.jit
def _gather_subset_jit(y0, h0, params, forc_data, rows):
    """Gather the stiff working set in ONE device program (the eager
    per-field takes + per-field host pulls cost ~1 s at 1M systems)."""
    take0 = lambda a: jnp.take(a, rows, axis=0)
    return (
        take0(y0),
        take0(h0),
        None if params is None else {k: take0(v) for k, v in params.items()},
        None if forc_data is None else jnp.take(forc_data, rows, axis=1),
    )


def select_kernels(backend: str, platform: str, dtype, model, interpret: bool) -> bool:
    """Whether solve() runs the fused kernels, chosen by the observed
    platform and input: 'auto' takes them for float32 batches of models with
    an unstacked RHS (``rhs_tuple``) on a GPU; 'pallas' demands them and
    raises where they cannot run, unless ``interpret`` (tests) runs them in
    the Pallas interpreter; 'xla' never takes them."""
    fit = jnp.dtype(dtype) == jnp.float32 and hasattr(model, "rhs_tuple")
    if backend == "pallas":
        if not (interpret or (platform == "gpu" and fit)):
            raise ValueError(
                "backend='pallas' needs float32 input, a model with rhs_tuple "
                f"and a GPU; got {jnp.dtype(dtype)} on platform {platform!r} "
                "(interpret=True runs the kernels in the Pallas interpreter)"
            )
        return True
    return backend == "auto" and platform == "gpu" and fit


def solve(
    model,
    y0: jax.Array,
    t0,
    tf,
    query_times: Optional[jax.Array] = None,
    params=None,
    forcings: Optional[ForcingSet] = None,
    config: SolverConfig = SolverConfig(),
    mesh=None,
    backend: str = "auto",
    t_shift=0.0,
    interpret: bool = False,
) -> SolveResult:
    """Integrate ``y0[S, N]`` from t0 to tf with dense output at query_times.

    ``t_shift`` (traced scalar, minutes): absolute-time offset seen by the
    MODEL's rhs — chunked runs integrate each window in window-relative time
    but time-dependent physics (Model 200's day-of-year) must see absolute
    simulation time.  Forcing gathers are not shifted.

    Mirrors the reference's clean entry ``run_rk45<Model>``
    (src/solver/rk45_api.hpp:273-313) including the stiff second pass.
    With ``mesh`` (a 1-D jax.sharding.Mesh) the RK45 phase is domain-
    decomposed over devices via shard_map; the (small) Radau stiff subset
    always runs single-device after host compaction.

    ``backend``: 'auto' (the fused GPU kernels for float32 batches of
    models with ``rhs_tuple`` on a GPU device; XLA/vmap otherwise),
    'pallas' (the kernels, or an error where they cannot run), or 'xla'.
    ``interpret=True`` runs the kernels in the Pallas interpreter — for
    tests on a host without a GPU.
    """
    y0 = jnp.asarray(y0)
    if y0.ndim != 2:
        raise ValueError(f"y0 must be [num_systems, N_EQ]; got shape {y0.shape}")
    s_count, n_eq = y0.shape
    if getattr(model, "N_EQ", n_eq) != n_eq:
        raise ValueError(
            f"y0 has {n_eq} state variables but {type(model).__name__} expects "
            f"{model.N_EQ}"
        )
    if params is not None:
        for k, v in params.items():
            if np.ndim(v) == 0 or np.shape(v)[0] != s_count:
                raise ValueError(
                    f"params[{k!r}] has shape {np.shape(v)}; expected "
                    f"[{s_count}] (one row per system)"
                )
    if forcings is not None and forcings.num_systems != s_count:
        raise ValueError(
            f"forcings cover {forcings.num_systems} systems; expected {s_count}"
        )
    if query_times is not None:
        qt_check = np.asarray(query_times)
        if (
            qt_check.ndim != 1
            or np.isnan(qt_check).any()
            or (len(qt_check) > 1 and (np.diff(qt_check) < 0).any())
        ):
            raise ValueError(
                "query_times must be a 1-D NaN-free array sorted ascending"
            )
        if len(qt_check) and qt_check[-1] > float(tf) + 1e-9:
            # Out-of-span queries would get inconsistent rows: zeros on the
            # interpolated paths, y(tf) from the segmented stiff retry.
            raise ValueError(
                f"query_times extend past tf ({qt_check[-1]} > {tf})"
            )
    if not (float(tf) > float(t0)):
        raise ValueError(f"tf ({tf}) must be greater than t0 ({t0})")
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"backend must be auto|pallas|xla, got {backend!r}")

    # The platform comes from y0's COMMITTED device when it has one (a
    # CPU-committed batch on a GPU host takes the XLA path); uncommitted
    # arrays follow the process default device.
    _y0_devs = y0.devices() if hasattr(y0, "devices") else set()
    _platform = (
        next(iter(_y0_devs)).platform if _y0_devs else jax.devices()[0].platform
    )
    use_kernels = select_kernels(backend, _platform, y0.dtype, model, interpret)
    t_ph = _time.perf_counter()
    if use_kernels and mesh is None:
        from tiger_tpu.kernels.rk45_pallas import rk45_solve_pallas

        # h0=None: the initial-step estimate is traced INTO the pipeline's
        # jit (one device program instead of two; the estimate lands in
        # rk.h0 for the stiff rung).
        rk = rk45_solve_pallas(
            model, y0, t0, tf, query_times, params, forcings, None, config,
            interpret=interpret, t_shift=t_shift,
        )
    elif mesh is not None:
        h0 = initial_step(model, y0, t0, params, forcings, config, t_shift=t_shift)
        _phase_mark("initial_step", t_ph, h0)
        t_ph = _time.perf_counter()
        from tiger_tpu.dist import rk45_solve_sharded

        rk = rk45_solve_sharded(
            model, y0, t0, tf, query_times, params, forcings, h0, config, mesh,
            backend="pallas" if use_kernels else "xla", t_shift=t_shift,
            interpret=interpret,
        )
    else:
        h0 = initial_step(model, y0, t0, params, forcings, config, t_shift=t_shift)
        _phase_mark("initial_step", t_ph, h0)
        t_ph = _time.perf_counter()
        rk = rk45_solve(
            model, y0, t0, tf, query_times, params, forcings, h0, config,
            t_shift=t_shift,
        )
    _phase_mark("rk_phase", t_ph, rk.y_final, rk.dense)

    y_final, dense = rk.y_final, rk.dense
    failed = rk.failed
    radau_stats = None
    cpu_extra_rows = np.zeros(0, np.int64)
    addressable = getattr(rk.stiff, "is_fully_addressable", True)
    # SPECULATIVE rung dispatch: on the single-device kernel path the whole
    # stiff second phase — device-side compaction of the first TT_SPEC_BUCKET
    # flagged rows (_stiff_rows_jit), subset gather, fused Radau kernel, and
    # the masked merge — is enqueued BEFORE any host round trip, so the
    # device never idles waiting for the stiff-flag pull.  Sentinel rows
    # beyond the flag count gather NaN working sets (jnp.take OOB fills NaN)
    # and fail within radau_max_rejects iterations, and their merge rows are
    # out-of-range, so they scatter nowhere.  The ONE host pull afterwards
    # (mask + rung failures + stats) only steers the rare fallbacks:
    # kernel-failed lanes to the host f64 pipeline, and flag counts beyond
    # the bucket to a second exact-size device rung.  Whether speculation
    # still pays without a remote device link is an open measurement
    # (ROADMAP); TT_NO_SPECULATIVE_RUNG turns it off.
    speculate = (
        use_kernels
        and mesh is None
        and addressable
        and not _env_flag("TT_NO_SPECULATIVE_RUNG")
    )
    t_ph = _time.perf_counter()
    if speculate:
        from tiger_tpu.kernels.radau_pallas import radau_solve_pallas

        # 256 covers every observed production flag count in one shot (the
        # headline flags 133; streamed windows usually fewer); TT_SPEC_BUCKET
        # shrinks it so tests can exercise the beyond-bucket overflow branch
        # without 256 interpret-mode lanes.
        bucket = int(_os.environ.get("TT_SPEC_BUCKET", "256"))
        rows_dev = _stiff_rows_jit(rk.stiff, bucket, s_count)
        y0_sub, h0_sub, params_sub, forc_sub = _gather_subset_jit(
            y0, rk.h0, params,
            None if forcings is None else forcings.data, rows_dev,
        )
        forc0 = None
        if forc_sub is not None:
            forc0 = ForcingSet(data=forc_sub, meta=forcings.meta)
        rdk = radau_solve_pallas(
            model, y0_sub, t0, tf, query_times, params_sub, forc0,
            h0=h0_sub, config=config, interpret=interpret, t_shift=t_shift,
        )
        y_final, dense, failed = _merge_gather_apply_masked(
            y_final, dense, failed, rows_dev, rdk.y_final, rdk.dense, rdk.failed,
        )
        # ONE host round trip for everything the host logic reads.
        stiff_mask, failed_np, stats_np = jax.device_get(
            (rk.stiff, rdk.failed, rdk.stats)
        )
        stiff_mask = np.asarray(stiff_mask)
        n_stiff = int(stiff_mask.sum())
        # In speculative mode this phase INCLUDES the rung's execution (the
        # one pull waits for everything enqueued); the radau_device_rung
        # mark below then times only the post-pull bookkeeping + merge sync.
        _phase_mark("stiff_count_sync", t_ph)
        t_ph = _time.perf_counter()
        n_stiff_flagged = n_stiff
        glob = False
        if n_stiff:
            idx0 = np.nonzero(stiff_mask)[0]
            cov = min(n_stiff, bucket)
            radau_stats = _scatter_stats(
                radau_stats, stats_np, idx0[:cov], s_count
            )
            # Covered lanes whose kernel attempt failed -> CPU f64 pipeline
            # (joined in after the overflow rung below); flags beyond the
            # bucket -> the exact-size device rung below.
            cpu_extra_rows = idx0[:cov][failed_np[:cov]]
            stiff_mask = np.zeros_like(stiff_mask)
            stiff_mask[idx0[cov:]] = True
            n_stiff = int(stiff_mask.sum())
            _phase_mark("radau_device_rung", t_ph, y_final, dense)
    else:
        # ONE host round trip for flags: pull the whole [S] mask and count
        # on the host.  A device-side count (`int(jnp.sum(...))`) costs the
        # same sync as the pull itself, and the mask payload (1 byte/lane)
        # is small at any batch size.
        stiff_mask = _host_pull(rk.stiff)
        n_stiff = int(stiff_mask.sum())
        _phase_mark("stiff_count_sync", t_ph)
        n_stiff_flagged = n_stiff
        # Cross-process GLOBAL mesh: host compaction works through
        # _host_pull (replicate-then-read); the per-process stiff pipeline
        # runs redundantly with identical inputs, and the jitted merges see
        # replicated updates.
        glob = bool(n_stiff) and not addressable

    # Kernel runs with flagged lanes: re-integrate the flagged subset with
    # the fused Radau kernel ON DEVICE; only its failures fall through to the
    # host float64 pipeline below.  Applies to sharded (mesh) runs too — the
    # subset is compacted to one device either way, mirroring the
    # reference's host gather (rk45_api.hpp:190-203).
    t_ph = _time.perf_counter()
    if n_stiff >= 1 and use_kernels:
        from tiger_tpu.kernels.radau_pallas import radau_solve_pallas

        idx0 = np.nonzero(stiff_mask)[0]
        # Bucketed padding, floored at 256: subset sizes drift run to run and
        # window to window, and every new shape would re-trigger a kernel
        # compile — the floor makes small counts (the common case in
        # streamed runs) share ONE compiled shape.
        pad0 = np.concatenate(
            [idx0, np.full(max(_bucket(len(idx0)), 256) - len(idx0), idx0[0], idx0.dtype)]
        )
        # ONE jitted gather for the whole working set instead of ~18 eager
        # per-field takes, each its own dispatch.
        y0_sub, h0_sub, params_sub, forc_sub = _gather_subset_jit(
            y0, rk.h0, params,
            None if forcings is None else forcings.data,
            jnp.asarray(pad0),
        )
        if mesh is not None or not getattr(y0_sub, "is_fully_addressable", True):
            # Mesh runs: the gather output is committed across the mesh
            # devices; the (single-device) Radau pallas_call and the merge
            # need it compacted to one LOCAL device — mirror the CPU
            # pipeline's host compaction.  Under a cross-process global mesh
            # _host_pull replicates the (small) subset to every process,
            # which then runs the identical rung on its own device.
            dev0 = jax.local_devices()[0]
            compact = lambda a: None if a is None else jax.device_put(
                _host_pull(a), dev0
            )
            y0_sub, h0_sub, forc_sub = (
                compact(y0_sub), compact(h0_sub), compact(forc_sub)
            )
            params_sub = None if params_sub is None else {
                k: compact(v) for k, v in params_sub.items()
            }
        forc0 = None
        if forc_sub is not None:
            forc0 = ForcingSet(data=forc_sub, meta=forcings.meta)
        rdk = radau_solve_pallas(
            model,
            y0_sub,
            t0,
            tf,
            query_times,
            params_sub,
            forc0,
            h0=h0_sub,
            config=config,
            interpret=interpret,
            t_shift=t_shift,
        )
        if not glob:
            # Device-autonomous masked merge dispatched FIRST: its execution
            # overlaps the failed/stats pull below — failed lanes keep their
            # RK values via the on-device mask, so no host decision gates
            # the scatter.  Bucket-padding lanes get
            # out-of-range sentinel rows (dropped).
            rows_all = np.full(len(pad0), s_count, np.int32)
            rows_all[: len(idx0)] = idx0
            parts = (jnp.asarray(rows_all), rdk.y_final, rdk.dense, rdk.failed)
            if mesh is not None:
                # The rung ran on one device; the full-batch outputs are
                # sharded over the mesh: replicate the (small) parts onto it.
                from jax.sharding import NamedSharding, PartitionSpec

                rep = NamedSharding(mesh, PartitionSpec())
                parts = tuple(jax.device_put(a, rep) for a in parts)
            y_final, dense, failed = _merge_gather_apply_masked(
                y_final, dense, failed, *parts
            )
        # ONE host round trip for everything the remaining host logic reads
        # (failed + 4 stats fields, instead of five serialized pulls).
        failed_np, stats_np = (
            jax.tree.map(_host_pull, (rdk.failed, rdk.stats))
            if glob
            else jax.device_get((rdk.failed, rdk.stats))
        )
        ok = ~failed_np[: len(idx0)]
        if glob:
            ok_rel = np.nonzero(ok)[0]
            if len(ok_rel):
                b = _bucket(len(ok_rel))
                rel_p = np.concatenate(
                    [ok_rel, np.zeros(b - len(ok_rel), ok_rel.dtype)]
                )
                rows_p = np.full(b, s_count, np.int32)  # sentinels -> dropped
                rows_p[: len(ok_rel)] = idx0[ok_rel]
                # Global mesh: the rung results are committed to THIS
                # process's device — hand the jitted SPMD merge host copies
                # (identical on every process) instead of mixing committed
                # single-device arrays into a global-mesh program.
                y_final, dense, failed = _merge_gather_apply(
                    y_final, dense, failed, rows_p,
                    np.asarray(rdk.y_final), np.asarray(rdk.dense), rel_p,
                )
        # Per-lane counters for EVERY flagged lane (including ones whose
        # kernel attempt failed and falls through to the CPU retry below).
        radau_stats = _scatter_stats(radau_stats, stats_np, idx0, s_count)
        stiff_mask = np.zeros_like(stiff_mask)
        stiff_mask[idx0[~ok]] = True
        n_stiff_remaining = int(stiff_mask.sum())
        _phase_mark("radau_device_rung", t_ph, y_final, dense)
    else:
        n_stiff_remaining = n_stiff

    if len(cpu_extra_rows):
        # Speculative-rung kernel failures join whatever the overflow rung
        # left over — all of it goes through the CPU f64 pipeline below.
        stiff_mask = np.array(stiff_mask, copy=True)
        stiff_mask[cpu_extra_rows] = True
        n_stiff_remaining = int(stiff_mask.sum())

    t_ph = _time.perf_counter()
    n_host = n_stiff_remaining
    if n_stiff_remaining > 0:
        n_stiff = n_stiff_remaining
        # The fallback stiff pass runs on the host CPU in float64 when the
        # RK phase ran on an accelerator: the subset is small (it is
        # host-compacted either way, mirroring rk45_api.hpp:190-203) and
        # implicit steps on lanes the f32 rung failed want f64 Newton
        # solves.
        out_dtype = y0.dtype
        # Global-mesh runs take the pull-to-host route even on CPU: their
        # arrays are not addressable in place.
        on_accel = next(iter(y0.devices())).platform != "cpu" or glob
        cpu = jax.local_devices(backend="cpu")[0] if on_accel else None
        # Give the CPU retry/Radau real float64 even when the process-level
        # x64 flag is off (the usual case for f32 accelerator runs).
        import contextlib

        x64_ctx = jax.enable_x64(True) if on_accel else contextlib.nullcontext()

        # Deferred merges: the stiff-pass results are scattered back in ONE
        # jitted donated call after the retries (see _merge_apply) instead
        # of an eager per-retry .at[].set on the full dense buffer.
        pending = []

        def merge(rows_abs, y_part, dense_part, failed_part):
            pending.append(
                (
                    np.asarray(rows_abs, np.int64),
                    np.asarray(y_part),
                    np.asarray(dense_part),
                    np.asarray(failed_part, bool),
                )
            )

        with x64_ctx:
            t_sub = _time.perf_counter()
            idx = np.nonzero(stiff_mask)[0]
            bucket = _bucket(n_stiff)
            pad_idx = np.concatenate([idx, np.full(bucket - n_stiff, idx[0], idx.dtype)])
            if on_accel:
                # One jitted gather + one host transfer for the whole working
                # set (the per-field eager takes cost ~1 s/run at 1M systems).
                gathered = _gather_subset_jit(
                    y0, rk.h0, params,
                    None if forcings is None else forcings.data,
                    pad_idx,
                )
                y0_np, h0_np, params_np, forc_np = (
                    jax.tree.map(_host_pull, gathered)
                    if glob
                    else jax.device_get(gathered)
                )
                put64 = lambda a: jax.device_put(np.asarray(a, np.float64), cpu)
                y0_sub = put64(y0_np)
                h0_sub = put64(h0_np)
                params_sub = None if params_np is None else {
                    k: put64(v) for k, v in params_np.items()
                }
                forc_sub = None
                if forc_np is not None:
                    forc_sub = ForcingSet(
                        data=jax.device_put(np.asarray(forc_np, np.float32), cpu),
                        meta=forcings.meta,
                    )
                qt_sub = None if query_times is None else put64(
                    np.asarray(query_times)
                )
            else:
                take_rows = lambda a: jnp.take(
                    jnp.asarray(a), jnp.asarray(pad_idx), axis=0
                )
                y0_sub = take_rows(y0)
                h0_sub = take_rows(rk.h0)
                params_sub = None if params is None else {
                    k: take_rows(v) for k, v in params.items()
                }
                forc_sub = None
                if forcings is not None:
                    forc_sub = ForcingSet(
                        data=forcings.data[:, pad_idx], meta=forcings.meta
                    )
                qt_sub = None if query_times is None else jnp.asarray(query_times)
            _phase_mark("stiff_subset_pull", t_sub)

            # Dense rows for the stiff subset come from SEGMENTED integration
            # (land exactly on each query; tiger_tpu.solver.segmented): the
            # interpolated dense path costs ~10x the bare integration in the
            # vmap solvers, which made this pass minutes instead of seconds.
            from tiger_tpu.solver.segmented import segmented_solve

            def run_sub(method, y0_x, h0_x, params_x, forc_x):
                if qt_sub is None:
                    fn = rk45_solve if method == "rk45" else radau_solve
                    return fn(
                        model, y0_x, t0, tf, None, params_x, forc_x,
                        h0=h0_x, config=config, t_shift=t_shift,
                    )
                return segmented_solve(
                    model, method, y0_x, t0, tf, qt_sub, params_x, forc_x,
                    h0=h0_x, config=config, t_shift=t_shift,
                )

            # First: an f64 RK45 retry of the flagged lanes.  Flags raised by the
            # float32 accelerator pass are frequently precision artifacts (error
            # ratios at tolerance ~ f32 rounding near physics kinks); a clean f64
            # attempt resolves them far more cheaply than implicit Radau steps.
            still_rel = np.arange(n_stiff)
            if on_accel:
                t_sub = _time.perf_counter()
                rk2 = run_sub("rk45", y0_sub, h0_sub, params_sub, forc_sub)
                rk2_stiff = np.asarray(rk2.stiff)[:n_stiff]
                _phase_mark("stiff_f64_rk_retry", t_sub)
                t_sub = _time.perf_counter()
                resolved_rel = np.nonzero(~rk2_stiff)[0]
                if len(resolved_rel):
                    # Index on the HOST: jnp fancy-indexing here would put
                    # the index array on the default device and pay a
                    # transfer per gather.
                    merge(
                        idx[resolved_rel],
                        np.asarray(rk2.y_final)[resolved_rel],
                        np.asarray(rk2.dense)[resolved_rel],
                        np.asarray(rk2.failed)[resolved_rel],
                    )
                still_rel = np.nonzero(rk2_stiff)[0]
                _phase_mark("stiff_rk_merge", t_sub)

            if len(still_rel):
                t_sub = _time.perf_counter()
                n2 = len(still_rel)
                bucket2 = _bucket(n2)
                pad2 = np.concatenate([still_rel, np.full(bucket2 - n2, still_rel[0])])
                # Host-side indexing (see above): the working set is tiny.
                take2 = lambda a: None if a is None else jax.device_put(
                    np.asarray(a)[pad2], cpu
                )
                forc2 = None
                if forc_sub is not None:
                    forc2 = ForcingSet(
                        data=jax.device_put(np.asarray(forc_sub.data)[:, pad2], cpu),
                        meta=forc_sub.meta,
                    )
                rd = run_sub(
                    "radau",
                    take2(y0_sub),
                    take2(h0_sub),
                    None if params_sub is None else {k: take2(v) for k, v in params_sub.items()},
                    forc2,
                )
                merge(
                    idx[still_rel],
                    np.asarray(rd.y_final)[:n2],
                    np.asarray(rd.dense)[:n2],
                    np.asarray(rd.failed)[:n2],
                )
                # Segmented retries carry no per-step counters; unsegmented
                # (no-query) retries do — fold them into the [S] arrays.
                rd_stats = getattr(rd, "stats", None)
                if rd_stats is not None:
                    radau_stats = _scatter_stats(
                        radau_stats, rd_stats, idx[still_rel], s_count
                    )
                _phase_mark("stiff_radau_retry", t_sub)

        if pending:
            t_sub = _time.perf_counter()
            rows_all = np.concatenate([m[0] for m in pending])
            n_q = dense.shape[1]
            out_np = np.dtype(out_dtype)
            b = _bucket(len(rows_all))
            rows_p = np.full(b, s_count, np.int64)  # sentinels -> dropped
            rows_p[: len(rows_all)] = rows_all
            y_p = np.zeros((b, n_eq), out_np)
            d_p = np.zeros((b, n_q, n_eq), out_np)
            f_p = np.zeros(b, bool)
            y_p[: len(rows_all)] = np.concatenate([m[1] for m in pending])
            d_p[: len(rows_all)] = np.concatenate([m[2] for m in pending])
            f_p[: len(rows_all)] = np.concatenate([m[3] for m in pending])
            # numpy args go straight into the jitted call (no eager jnp
            # conversions: those land on the default device).
            y_final, dense, failed = _merge_apply(
                y_final, dense, failed, rows_p, y_p, d_p, f_p
            )
            _phase_mark("stiff_merge_apply", t_sub, y_final, dense)
        _phase_mark("cpu_stiff_pass", t_ph, y_final, dense)

    return SolveResult(
        y_final=y_final,
        dense=dense,
        stiff=rk.stiff,
        failed=failed,
        rk_stats=rk.stats,
        radau_stats=radau_stats,
        n_stiff=n_stiff_flagged,
        n_host=n_host,
    )
