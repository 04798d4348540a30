"""Metropolis-Hastings (random-walk and general proposals).

Reference: src/samplers/MH.jl:47-66 (struct + convenience ctors) and the
iterate kernel src/samplers/iterate/MH.jl:72-141.  Feature parity:

  * symmetric random-walk normal proposals from a scale ``sigma``
    (MH(σ::Matrix/Vector/Real) ctors, MH.jl:63-66);
  * arbitrary user proposals via ``proposal_fn(x, scale) -> Distribution``
    (the `setproposal` closure, MH.jl:47-51), with the asymmetric
    correction  ratio += logpdf(q(x'→x)) − logpdf(q(x→x'))
    (iterate/MH.jl:83-90);
  * non-normalised proposals: ratio additionally corrected with the
    proposals' log-normalisers (iterate/MH.jl:14-24, 91-95) — here folded
    into ``Distribution.logpdf`` plus an optional ``lognormaliser``.

Extension: the proposal scale is multiplied by ``tune.step`` so
AcceptanceRateTuner adaptation (README.md:153-198 workflow) applies to MH
as well; with the default VanillaTuner step stays 1 and behavior matches
the reference exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from klara_tpu.core.target import Target
from klara_tpu.samplers.base import Info, Sampler, metropolis_accept
from klara_tpu.tuners.tuners import TuneState


class MHState(NamedTuple):
    position: jax.Array
    logtarget: jax.Array
    tune: TuneState


@dataclasses.dataclass(frozen=True)
class MH(Sampler):
    """Random-walk Metropolis by default: x' = x + step·σ·z, z ~ N(0, I).

    ``sigma`` may be a scalar, a per-coordinate vector, or a covariance
    Cholesky factor (matrix).  For a general (possibly asymmetric)
    proposal pass ``proposal_fn``.
    """

    sigma: Any = 1.0
    proposal_fn: Optional[Callable] = None  # (x, scale) -> Distribution
    symmetric: bool = True
    # normalised=False: the proposal's logpdf omits its normaliser (e.g. a
    # raw truncated-density kernel); the MH ratio is then corrected with
    # the proposals' log-normalisers via `proposal.lognormaliser()` —
    # reference src/samplers/iterate/MH.jl:14-24, 86-95 (`lognormalise`).
    # Full density = exp(logpdf - lognormaliser).
    normalised: bool = True

    def init(self, key, target: Target, position, step_size=None, tuner=None):
        position = jnp.asarray(position)
        lt = target.logdensity(position)
        tuner = tuner or self.default_tuner()
        # tune.step stays floating even for discrete (integer) positions
        f = jnp.result_type(position.dtype, jnp.float32)
        tune = tuner.init(jnp.asarray(step_size if step_size is not None else 1.0, f))
        return MHState(position, lt, tune)

    def _propose(self, key, x, scale):
        sigma = jnp.asarray(self.sigma, x.dtype)
        z = jax.random.normal(key, x.shape, x.dtype)
        if sigma.ndim == 2:
            return x + scale * (sigma @ z)
        return x + scale * sigma * z

    def step(self, key, state: MHState, target: Target):
        k_prop, k_acc = jax.random.split(key)
        x, lt = state.position, state.logtarget
        scale = state.tune.step

        if self.proposal_fn is None:
            x_new = self._propose(k_prop, x, scale)
            ratio = target.logdensity(x_new) - lt
            lt_new = ratio + lt
        else:
            fwd = self.proposal_fn(x, scale)
            x_new = fwd.sample(k_prop)
            lt_new = target.logdensity(x_new)
            ratio = lt_new - lt
            if not self.symmetric:
                rev = self.proposal_fn(x_new, scale)
                ratio = ratio + jnp.sum(rev.logpdf(x)) - jnp.sum(fwd.logpdf(x_new))
                if not self.normalised:
                    # non-normalised proposal correction
                    # (reference iterate/MH.jl:14-24)
                    ratio = ratio + jnp.sum(fwd.lognormaliser()) - jnp.sum(
                        rev.lognormaliser()
                    )

        accept = metropolis_accept(k_acc, ratio)
        position = jnp.where(accept, x_new, x)
        logtarget = jnp.where(accept, lt_new, lt)
        info = Info(
            accept=accept,
            accept_stat=jnp.minimum(1.0, jnp.exp(jnp.minimum(ratio, 0.0))),
            logtarget=logtarget,
        )
        return MHState(position, logtarget, state.tune), info
