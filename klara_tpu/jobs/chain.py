"""Device-resident Markov-chain trace.

Device-resident replacement for the reference's preallocated NState chain
storage (src/nstates/ParameterNStates/BasicContMuvParameterNState.jl:1-119,
``const MarkovChain = ParameterNState``): a dict of arrays shaped
``(n_post, n_chains, *event_shape)`` for each monitored field, plus a
diagnostics dict (the reference's per-draw diagnosticvalues channel,
src/states/ParameterStates/ParameterStates.jl:20).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Chain:
    """samples[field]     : (n_post, n_chains, ...)
    diagnostics[field]    : (n_post, n_chains, ...)
    final_state           : sampler state pytree (for resume), chains-batched
    """

    samples: Dict[str, jax.Array]
    diagnostics: Dict[str, jax.Array]
    final_state: Any

    @property
    def value(self):
        return self.samples["value"]

    @property
    def n_post(self) -> int:
        return next(iter(self.samples.values())).shape[0]

    @property
    def n_chains(self) -> int:
        return next(iter(self.samples.values())).shape[1]

    def __getitem__(self, field: str):
        if field in self.samples:
            return self.samples[field]
        return self.diagnostics[field]

    def flat(self, field: str = "value"):
        """Merge step and chain axes: (n_post * n_chains, ...)."""
        arr = self[field]
        return arr.reshape((-1,) + arr.shape[2:])
