"""Stream abstraction: couples a parameter row to an initial state + topology.

Reference: ``Stream<Model>`` (src/stream.hpp:28-51) pairs a SpatialParams row
with y0 and the downstream link id.  Here this is a thin batched
facade over the SoA (one object for the whole basin, not one per link).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tiger_tpu import params as params_mod
from tiger_tpu.routing import Topology, build_topology


@dataclasses.dataclass
class StreamSet:
    """The whole basin: ids, downstream ids, parameter SoA, initial states."""

    params: params_mod.SpatialParams  # full SoA incl. stream/next_stream
    y0: np.ndarray  # [S, N_EQ]
    _topology: Optional[Topology] = None

    @staticmethod
    def from_csv(csv_path: str, y0_common, columns: Optional[dict] = None) -> "StreamSet":
        """Build from a parameter CSV and a common cold-start state
        (main.cpp:376-382 builds the same vector of Stream objects).

        ``columns``: optional positional mapping (the config schema's
        local_params.columns) for headerless/foreign CSVs — same as
        load_spatial_params."""
        sp = params_mod.load_spatial_params(csv_path, columns=columns)
        n = params_mod.num_systems(sp)
        y0 = np.tile(np.asarray(y0_common, np.float64), (n, 1))
        return StreamSet(params=sp, y0=y0)

    def __len__(self) -> int:
        return params_mod.num_systems(self.params)

    @property
    def ids(self) -> np.ndarray:
        return self.params["stream"]

    @property
    def next_ids(self) -> np.ndarray:
        return self.params["next_stream"]

    @property
    def topology(self) -> Topology:
        if self._topology is None:
            self._topology = build_topology(self.ids, self.next_ids)
        return self._topology

    def model_params(self):
        return params_mod.model_params(self.params)

    def subset(self, idx) -> "StreamSet":
        return StreamSet(
            params=params_mod.slice_rows(self.params, idx), y0=self.y0[idx]
        )
