"""DummyModel: 5-state linear test system.

The reference's dummy model files were deleted from the snapshot; the behavior
is recovered from the validation notebook (src/model_dummy_python.ipynb cell 2)
and the committed golden artifacts src/final.csv / src/dense.csv, which this
model must reproduce (BASELINE config #1):

    dH0 = 1.0 - 0.5*H0
    dH1 = 1.2 + 0.5*H0 - 0.3*H1 - 0.4 - 0.6*H1
    dH2 = 0.3*H1 - 0.2
    dH3 = 0.6*H1 - 0.4*H3 - 0.3
    dH4 = 0.4*H3 - 0.1

with y0 = [1,1,1,1,1], t in [0, 5], rtol 1e-6 / atol 1e-9.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class DummyModel:
    N_EQ: int = 5
    UID: int = 1

    def rhs_tuple(self, t, y, params=None, forcings=None) -> tuple:
        """Unstacked RHS: ``y`` is any indexable of N_EQ component arrays.

        The fused kernels call this with tuples of per-lane blocks, so no
        stacking happens here.
        """
        H0, H1, H2, H3, H4 = y[0], y[1], y[2], y[3], y[4]
        dH0 = 1.0 - 0.5 * H0
        dH1 = 1.2 + 0.5 * H0 - 0.3 * H1 - 0.4 - 0.6 * H1
        dH2 = 0.3 * H1 - 0.2
        dH3 = 0.6 * H1 - 0.4 * H3 - 0.3
        dH4 = 0.4 * H3 - 0.1
        return (dH0, dH1, dH2, dH3, dH4)

    def rhs(self, t, y, params=None, forcings=None) -> jax.Array:
        return jnp.stack(self.rhs_tuple(t, y, params, forcings))
