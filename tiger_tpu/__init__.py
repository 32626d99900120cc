"""tiger_tpu — hillslope hydrologic model engine in JAX.

A from-scratch JAX / XLA / Pallas / shard_map framework with the capabilities of
PrincetonUniversity/Tiger_HLM_GPU (reference mounted read-only at /root/reference):
batched adaptive Dormand-Prince RK45 integration with dense output over millions of
independent hillslope/stream-link ODE systems, an implicit Radau IIA fallback for
stiff systems, the Tiger-HLM runoff physics, NetCDF forcing ingestion with
lookup-table remap, NetCDF/CSV output, and multi-host domain decomposition.

Design: instead of one CUDA thread per system (reference
src/solver/rk45_kernel.cu:17-176), each ODE system is one *vectorized lane*: a
single jitted ``lax.while_loop`` advances the whole batch with per-lane masked
adaptive (t, h, accept/reject, stiff) state, and Pallas kernels tile the batch so
independent tiles terminate independently.
"""

from tiger_tpu.solver.config import SolverConfig
from tiger_tpu.solver.api import solve, SolveResult
from tiger_tpu.solver.rk45 import rk45_solve
from tiger_tpu.solver.radau import radau_solve
from tiger_tpu.chunked import solve_chunked
from tiger_tpu.forcing import ForcingSet, ForcingMeta, ForcingSpec, load_forcings
from tiger_tpu.models import DummyModel, Model200, Model204, get_model
from tiger_tpu.streams import StreamSet

__version__ = "0.1.0"

__all__ = [
    "SolverConfig",
    "solve",
    "SolveResult",
    "rk45_solve",
    "radau_solve",
    "solve_chunked",
    "ForcingSet",
    "ForcingMeta",
    "ForcingSpec",
    "load_forcings",
    "DummyModel",
    "Model200",
    "Model204",
    "get_model",
    "StreamSet",
]
