"""Model protocol: what a Tiger-HLM physics model looks like in tiger_tpu.

The reference expresses a model as a C++ struct with a static ``rhs`` device
function (src/models/model_204.hpp:15-115).  Here a model is a frozen dataclass
exposing:

  - ``N_EQ``: number of prognostic equations (state vector length),
  - ``UID``: model id used by the registry / config system,
  - ``rhs(t, y, params, forcings)``: the pure, per-system right-hand side,
    written in jnp so it is jit/vmap/grad-compatible.  ``y`` is a length-N_EQ
    vector for ONE system; the solver vmaps it over the batch, so every scalar
    op here becomes an [S]-wide vector op.

``params`` is a dict of per-system scalars (a row of the SpatialParams SoA; see
tiger_tpu.params) or ``None`` for models without spatial parameters.
``forcings`` is a length-nForc vector of forcing values at the *step-start*
time (zero-order hold frozen across the RK stages, matching the reference:
rk45_kernel.cu:84-116) or ``None`` when no forcings are loaded.
"""

from __future__ import annotations

from typing import Mapping, Optional, Protocol, runtime_checkable

import jax


@runtime_checkable
class Model(Protocol):
    N_EQ: int
    UID: int

    def rhs(
        self,
        t: jax.Array,
        y: jax.Array,
        params: Optional[Mapping[str, jax.Array]],
        forcings: Optional[jax.Array],
    ) -> jax.Array:
        """Return dy/dt, shape [N_EQ], for one system."""
        ...
