"""Sampler protocol: pure ``(key, state, target) -> (state, info)`` kernels.

Pure-function re-design of the reference's sampler layer
(src/samplers/samplers.jl + src/samplers/iterate/*.jl).  The reference
drives mutable ``MCSamplerState`` structs through per-sampler ``iterate!``
kernels inside ``run(job)``'s Julia for-loop
(src/jobs/BasicMCJob.jl:212-244).  Here each sampler is a frozen dataclass
of *static* hyper-parameters with two pure methods:

    sampler.init(key, target, position, step_size=None) -> SamplerState
    sampler.step(key, state, target)                    -> (state, Info)

Both are jit/vmap/scan-safe: the job driver vmaps ``step`` over a chains
axis and scans it over steps (see klara_tpu.jobs.job).  Per-draw
"diagnostics" (reference: the diagnosticvalues channel,
src/states/ParameterStates/ParameterStates.jl:20) become fields of the
``Info`` NamedTuple returned each step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from klara_tpu.core.target import Target
from klara_tpu.tuners.tuners import Tuner, TuneState, VanillaTuner


class Info(NamedTuple):
    """Per-step diagnostics common to all samplers.

    ``accept``      — whether the proposal was accepted (reference `:accept`);
                      samplers with per-coordinate proposals (AMWG) report the
                      accepted FRACTION instead of a boolean
    ``accept_stat`` — acceptance probability (NUTS/HMC `a`; 0/1 for MH-family)
    ``logtarget``   — log-density after the step
    ``extras``      — sampler-specific diagnostics dict (ndoublings, logσ, ...);
                      the default is an (immutable) empty tuple, not ``{}``,
                      because a NamedTuple default is shared class-wide
    """

    accept: jax.Array
    accept_stat: jax.Array
    logtarget: jax.Array
    extras: Any = ()


def metropolis_accept(key, log_ratio):
    """Common MH accept rule: ratio > 0 || ratio > log(rand()) —
    reference src/samplers/iterate/MH.jl:26."""
    u = jax.random.uniform(key, dtype=jnp.result_type(log_ratio, jnp.float32))
    # NaN log_ratio (e.g. -inf minus -inf) must reject.
    return log_ratio > jnp.log(u)


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Base class. Subclasses define `init` and `step`."""

    def init(self, key, target: Target, position, step_size=None):
        raise NotImplementedError

    def step(self, key, state, target: Target):
        raise NotImplementedError

    # default initial step size used when neither the user nor a
    # step-size search provides one
    def default_step_size(self):
        return 1.0

    # Which statistic the tuner consumes: 'accept' (0/1) or 'accept_stat'.
    # Deliberately *unannotated* class attributes (not dataclass fields) so
    # subclasses can override with a plain assignment.
    tuner_statistic = "accept"

    # Samplers that embed their own adaptation (AM covariance, RAM rank-1
    # updates, AMWG per-coordinate logσ) set this so the job driver skips
    # the external tuner update.
    self_tuning = False

    def default_tuner(self) -> Tuner:
        return VanillaTuner()

    def bind_tuner(self, tuner: Tuner) -> "Sampler":
        """Specialise static sampler config to the tuner in use (called once
        by the job driver).  E.g. HMC switches to a fixed trajectory length
        with dynamic nleaps = round(λ/ε) under dual averaging — reference
        src/samplers/iterate/HMC.jl:142-144."""
        return self
