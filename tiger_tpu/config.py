"""YAML configuration system.

Implements, for real, the schema the reference specified but never compiled
(src/I_O/config_loader.{hpp,cpp} is excluded from the Makefile; the schema
lives in /root/reference/data/config.yaml): model selection, ISO-8601 time
span, cold/hot initial conditions, forcing discovery, output interval and
state subset, solver tolerances, and parallel-run knobs.  The reference's MPI
buffer sizes become sharding knobs; flags are carried for compatibility.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import re
from typing import List, Optional

import yaml


def _parse_iso8601(s: str) -> _dt.datetime:
    return _dt.datetime.fromisoformat(s)


# 's' plural only on word units: a bare-letter unit with 's' ('ms', 'hs')
# would silently parse as minutes/hours ('500ms' != 500 minutes).
_INTERVAL_RE = re.compile(
    r"^\s*(\d+(?:\.\d+)?)\s*(m|min(?:s)?|h|hr(?:s)?|hour(?:s)?|d|day(?:s)?)\s*$"
)


def parse_interval_minutes(text: str) -> float:
    """'15m' / '1h' / '1d' -> minutes (config.yaml output.print_interval)."""
    m = _INTERVAL_RE.match(str(text))
    if not m:
        raise ValueError(f"Bad interval {text!r}; expected like '15m', '1h', '1d'")
    value, unit = float(m.group(1)), m.group(2)
    minutes = value * {
        "m": 1.0, "min": 1.0, "mins": 1.0,
        "h": 60.0, "hr": 60.0, "hrs": 60.0, "hour": 60.0, "hours": 60.0,
        "d": 1440.0, "day": 1440.0, "days": 1440.0,
    }[unit]
    if minutes <= 0:
        raise ValueError(f"Interval {text!r} must be positive")
    return minutes


@dataclasses.dataclass
class ModelInfo:
    uid: int = 204
    name: str = ""


@dataclasses.dataclass
class TimeInfo:
    start: _dt.datetime = _dt.datetime(2000, 1, 1)
    end: _dt.datetime = _dt.datetime(2000, 1, 3)
    # Windowed (streaming) execution: integrate chunk_days at a time, reading
    # only that window's forcing rows and writing dense output incrementally
    # (bounded memory at year scale — the reference's loadTimeChunk design,
    # forcing_loader.cpp:164, actually wired up).  0 = solve the whole span
    # in one shot.
    chunk_days: float = 0.0

    @property
    def duration_minutes(self) -> float:
        return (self.end - self.start).total_seconds() / 60.0


@dataclasses.dataclass
class InitialInfo:
    mode: str = "cold"  # "cold" | "hot"
    file: str = ""  # state file (hot mode); NetCDF final-state layout
    cold_state: Optional[List[float]] = None  # per-variable cold-start y0
    # Crash recovery for chunked runs: continue the ORIGINAL simulation from
    # the state file's sim_time_minutes — output files are re-opened and
    # filled from that point instead of recreated.  Requires mode: hot and
    # time.chunk_days > 0.  Plain hot start (resume: false) begins a NEW run
    # at t=0 from the saved state, like the reference's intended hot mode.
    resume: bool = False


@dataclasses.dataclass
class ForcingVarInfo:
    precipitation: str = "pr"
    temperature: str = "t2m"


@dataclasses.dataclass
class ForcingInfo:
    type: str = "folder_nc"
    path: str = ""
    lookup: str = ""
    vars: ForcingVarInfo = dataclasses.field(default_factory=ForcingVarInfo)
    # Extension over the reference schema: explicit per-forcing files + dt
    # (the reference hard-codes these in main.cpp:508-515).
    files: List[dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class OutputInfo:
    print_interval: str = "1h"
    states: Optional[List[int]] = None  # None => all states
    path: str = "."
    prefix: str = "example"
    compression_level: int = 0
    format: str = "netcdf"  # "netcdf" | "csv"
    # NetCDF variable precision: None preserves solve precision (an f32 run
    # writes f32 — halves the multi-GB dense file); "f64" matches the
    # reference's double `outputs` var (output_series.cpp:37); "i16" packs
    # the dense output CF-style (ERA5 convention, per-state scale/offset,
    # quantized on device) — 4x fewer bytes than f64 on wire and disk.
    precision: Optional[str] = None  # None | "f32" | "f64" | "i16"
    # Declared per-state packing ranges for STREAMED (chunked) i16 output:
    # {state_id: [min, max], ...}.  Windowed runs cannot derive global
    # ranges from data they have not solved yet, so the CF scale/offset come
    # from here (constant over the record; out-of-range values saturate at
    # the range edge).  Unchunked i16 runs ignore this and derive exact
    # ranges from the data.
    i16_ranges: Optional[dict] = None
    # Also write the routed discharge hydrograph (downstream-accumulated link
    # outflow over the next_stream topology) as discharge_<prefix>_rank_N.nc.
    routed_discharge: bool = False
    # Multi-process routed-discharge exchange.  'ring': shard_map + ppermute
    # delivery over the sharded topology plan — each window moves only the
    # cross-shard outbox, O(M * log depth * ranks) bytes (the reference's
    # never-built MPI neighbor transfer, stream.hpp:31).  'allgather': the
    # full-basin process_allgather + replicated full-topology accumulation —
    # O(S_total * Q) bytes delivered to EVERY rank per window; kept as the
    # oracle and for backends without cross-process collectives.
    routed_exchange: str = "ring"
    # Chunked runs: overwrite state_<prefix>_rank_N.nc every this-many
    # simulated time (e.g. "30d") so a killed year-scale run resumes from the
    # last completed window via initial.mode hot (crash recovery the
    # reference's config gestures at but never implements).  None = final
    # state only.
    checkpoint_interval: Optional[str] = None


@dataclasses.dataclass
class SolverInfo:
    method: str = "RK45"
    rtol: float = 1e-6
    atol: float = 1e-9
    safety: float = 0.9
    min_scale: float = 0.2
    max_scale: float = 10.0
    initial_step: Optional[float] = None
    # 'f64' matches the reference (double everywhere); 'f32' is the fused
    # GPU kernel path (pair it with rtol >= ~1e-5: tolerances below f32
    # rounding accumulate past them); 'f32c' is f32 with compensated (Kahan)
    # state accumulation, which holds the reference's own rtol 1e-6 /
    # atol 1e-9 in f32 (SolverConfig.compensated).
    precision: str = "f64"
    # Step-size controller: 'i' (reference parity) or 'pi' (Lund-stabilized;
    # fewer rejected attempts on forcing-kink-heavy runs).
    controller: str = "i"
    # Lund stabilization exponent (controller='pi' only); DOPRI5's beta=0.04.
    pi_beta: float = 0.04


@dataclasses.dataclass
class ParallelInfo:
    # Reference mpi: block carried for compatibility; sharding is automatic.
    step_storage: int = 30
    transfer_buffer: int = 10
    discontinuity_buf: int = 0


@dataclasses.dataclass
class FlagsInfo:
    uses_dam: bool = False
    convert_area: bool = False


@dataclasses.dataclass
class SimulationConfig:
    model: ModelInfo = dataclasses.field(default_factory=ModelInfo)
    time: TimeInfo = dataclasses.field(default_factory=TimeInfo)
    initial: InitialInfo = dataclasses.field(default_factory=InitialInfo)
    params_file: str = ""
    # local_params.columns (config.yaml:27-31): positional column mapping for
    # headerless/foreign CSVs — see tiger_tpu.params.load_spatial_params.
    params_columns: Optional[dict] = None
    # global_params (config.yaml:20-22): scalar parameters broadcast to every
    # system; per-link CSV values win on name collision.
    global_params: dict = dataclasses.field(default_factory=dict)
    forcings: ForcingInfo = dataclasses.field(default_factory=ForcingInfo)
    output: OutputInfo = dataclasses.field(default_factory=OutputInfo)
    solver: SolverInfo = dataclasses.field(default_factory=SolverInfo)
    parallel: ParallelInfo = dataclasses.field(default_factory=ParallelInfo)
    flags: FlagsInfo = dataclasses.field(default_factory=FlagsInfo)

    def solver_config(self):
        from tiger_tpu.solver.config import SolverConfig

        return SolverConfig(
            rtol=self.solver.rtol,
            atol=self.solver.atol,
            safety=self.solver.safety,
            min_scale=self.solver.min_scale,
            max_scale=self.solver.max_scale,
            initial_step=self.solver.initial_step,
            controller=self.solver.controller,
            pi_beta=self.solver.pi_beta,
            compensated=self.solver.precision == "f32c",
        )


def load_config(path: str) -> SimulationConfig:
    """Parse the YAML file into a SimulationConfig (config_loader.cpp:19-84)."""
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    cfg = SimulationConfig()

    if m := doc.get("model"):
        cfg.model = ModelInfo(uid=int(m.get("uid", 204)), name=str(m.get("name", "")))
    if t := doc.get("time"):
        cfg.time = TimeInfo(
            start=_parse_iso8601(str(t["start"])),
            end=_parse_iso8601(str(t["end"])),
            chunk_days=float(t.get("chunk_days", 0.0)),
        )
        if cfg.time.chunk_days < 0:
            raise ValueError(f"time.chunk_days must be >= 0, got {cfg.time.chunk_days}")
        if cfg.time.end <= cfg.time.start:
            raise ValueError(
                f"time.end ({cfg.time.end}) must be after time.start "
                f"({cfg.time.start})"
            )
    if i := doc.get("initial"):
        cfg.initial = InitialInfo(
            mode=str(i.get("mode", "cold")),
            file=str(i.get("file") or "") if i.get("mode") == "hot" else "",
            cold_state=list(i["cold_state"]) if i.get("cold_state") else None,
            resume=bool(i.get("resume", False)),
        )
        if cfg.initial.mode not in ("cold", "hot"):
            raise ValueError(f"initial.mode must be cold|hot, got {cfg.initial.mode}")
        if cfg.initial.mode == "hot" and not cfg.initial.file:
            raise ValueError("initial.mode hot requires initial.file")
        if cfg.initial.resume and cfg.initial.mode != "hot":
            raise ValueError("initial.resume requires initial.mode: hot")
    if lp := doc.get("local_params"):
        cfg.params_file = str(lp.get("file", ""))
        if cols := lp.get("columns"):
            cfg.params_columns = {
                "stream_id": int(cols.get("stream_id", 0)),
                "next_stream_id": int(cols.get("next_stream_id", 1)),
                "params_start": int(cols.get("params_start", 2)),
                # Default = the FULL positional schema (16 columns incl.
                # t_thres); a 15 here silently zeroed the melt threshold for
                # configs that omitted num_params.
                "num_params": int(cols.get("num_params", 16)),
            }
            if "has_header" in cols:
                # Explicit header declaration beats the loader's sniff
                # (ambiguous for numeric-looking headers / empty first cells).
                cfg.params_columns["has_header"] = bool(cols["has_header"])
    if gp := doc.get("global_params"):
        for entry in gp:
            cfg.global_params[str(entry["name"])] = float(entry.get("value", 0.0))
    if f := doc.get("forcings"):
        fv = f.get("vars") or {}
        cfg.forcings = ForcingInfo(
            type=str(f.get("type", "folder_nc")),
            path=str(f.get("path", "")),
            lookup=str(f.get("lookup", "")),
            vars=ForcingVarInfo(
                precipitation=str(fv.get("precipitation", "pr")),
                temperature=str(fv.get("temperature", "t2m")),
            ),
            files=list(f.get("files", [])),
        )
    if o := doc.get("output"):
        cfg.output = OutputInfo(
            print_interval=str(o.get("print_interval", "1h")),
            states=list(o["states"]) if o.get("states") else None,
            path=str(o.get("path", ".")),
            prefix=str(o.get("prefix", "example")),
            compression_level=int(o.get("compression_level", 0)),
            format=str(o.get("format", "netcdf")),
            precision=(None if o.get("precision") is None else str(o["precision"])),
            i16_ranges=(
                None if o.get("i16_ranges") is None else dict(o["i16_ranges"])
            ),
            routed_discharge=bool(o.get("routed_discharge", False)),
            routed_exchange=str(o.get("routed_exchange", "ring")),
            checkpoint_interval=(
                None if o.get("checkpoint_interval") is None
                else str(o["checkpoint_interval"])
            ),
        )
        if cfg.output.checkpoint_interval is not None:
            parse_interval_minutes(cfg.output.checkpoint_interval)  # validate
        if cfg.output.routed_exchange not in ("ring", "allgather"):
            raise ValueError(
                "output.routed_exchange must be ring|allgather, got "
                f"{cfg.output.routed_exchange!r}"
            )
        if cfg.output.precision not in (None, "f32", "f64", "i16"):
            raise ValueError(
                f"output.precision must be f32|f64|i16, got {cfg.output.precision!r}"
            )
        if cfg.output.i16_ranges is not None:
            if cfg.output.precision != "i16":
                raise ValueError(
                    "output.i16_ranges only applies with output.precision: i16"
                )
            fixed = {}
            for k, v in cfg.output.i16_ranges.items():
                try:
                    sid = int(k)
                    lo, hi = (float(v[0]), float(v[1]))
                except (TypeError, ValueError, IndexError):
                    raise ValueError(
                        f"output.i16_ranges entries must be state_id: "
                        f"[min, max]; got {k!r}: {v!r}"
                    )
                import math

                if not (lo < hi) or not (math.isfinite(lo) and math.isfinite(hi)):
                    raise ValueError(
                        f"output.i16_ranges[{sid}] needs finite min < max, "
                        f"got [{lo}, {hi}]"
                    )
                fixed[sid] = (lo, hi)
            cfg.output.i16_ranges = fixed
        parse_interval_minutes(cfg.output.print_interval)  # validate
    if s := doc.get("solver"):
        tol = s.get("tolerances") or {}
        cfg.solver = SolverInfo(
            method=str(s.get("method", "RK45")),
            rtol=float(tol.get("rtol", 1e-6)),
            atol=float(tol.get("atol", 1e-9)),
            safety=float(tol.get("safety", 0.9)),
            min_scale=float(tol.get("min_scale", 0.2)),
            max_scale=float(tol.get("max_scale", 10.0)),
            initial_step=(None if s.get("initial_step") is None else float(s["initial_step"])),
            precision=str(s.get("precision", "f64")),
            controller=str(s.get("controller", "i")),
            pi_beta=float(s.get("pi_beta", 0.04)),
        )
        if cfg.solver.method.lower() != "rk45":
            raise ValueError(
                f"solver.method must be RK45 (got {cfg.solver.method!r}): the "
                "engine is the RK45+Radau hybrid — stiff systems are routed "
                "to Radau automatically, there is no all-Radau mode"
            )
        if cfg.solver.precision not in ("f64", "f32", "f32c"):
            raise ValueError(
                f"solver.precision must be f64|f32|f32c, got {cfg.solver.precision}"
            )
        if cfg.solver.controller not in ("i", "pi"):
            raise ValueError(
                f"solver.controller must be i|pi, got {cfg.solver.controller!r}"
            )
        if not 0.0 <= cfg.solver.pi_beta <= 0.2:
            raise ValueError(
                f"solver.pi_beta must be in [0, 0.2], got {cfg.solver.pi_beta}"
            )
        if cfg.solver.precision == "f32" and cfg.solver.rtol < 5e-6:
            import warnings

            warnings.warn(
                f"solver.precision f32 with rtol={cfg.solver.rtol:g}: tolerances "
                "below ~1e-5 are at float32 rounding level — the trajectory "
                "accumulation rounds past them.  Raise rtol (>=1e-5), use "
                "precision f32c (compensated f32: holds these tolerances at "
                "kernel speed), or f64.",
                stacklevel=2,
            )
    if p := doc.get("mpi") or doc.get("parallel"):
        cfg.parallel = ParallelInfo(
            step_storage=int(p.get("step_storage", 30)),
            transfer_buffer=int(p.get("transfer_buffer", 10)),
            discontinuity_buf=int(p.get("discontinuity_buf", 0)),
        )
    if fl := doc.get("flags"):
        cfg.flags = FlagsInfo(
            uses_dam=bool(fl.get("uses_dam", False)),
            convert_area=bool(fl.get("convert_area", False)),
        )
    return cfg
