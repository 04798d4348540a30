"""Step-size / proposal-scale tuners as pure state updaters.

Functional re-design of the reference tuner layer (src/tuners/):

  * ``TuneState`` replaces the mutable ``BasicMCTune``
    {step, accepted, proposed, totproposed, rate} (src/tuners/tuners.jl:5-25),
    extended with a tuner-specific ``extra`` pytree.
  * ``Tuner.update(tune, accept, accept_stat, burnin)`` is called once per
    MCMC step by the job driver; all burnin/period gating is expressed with
    `jnp.where` so the whole thing lives inside a `lax.scan` step and
    vmaps over chains (per-chain adaptation) or runs once on cross-chain
    pooled statistics (pooled adaptation — a many-chain extension, see
    klara_tpu.jobs.job).

Reference tuning-period semantics preserved exactly (verified against
src/samplers/iterate/HMC.jl:200-250):

  * counters: accepted/proposed accumulate per step; at a period boundary
    during burnin (``totproposed <= burnin and proposed % period == 0``)
    the rate is computed, the tuner-specific update fires, and counters
    reset via ``reset_burnin!`` (totproposed += proposed; accepted =
    proposed = 0) — src/tuners/tuners.jl:27-32.
  * DualAveraging adapts every step while ``count <= nadapt`` and then
    freezes ``step = εbar`` — src/samplers/iterate/HMC.jl:225-250,
    src/tuners/DualAveragingMCTuner.jl:95-101.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from klara_tpu.stats.logistic import logistic


def logistic_rate_score(x, k=7.0):
    """Stretched logistic score in (0, 2) — src/tuners/AcceptanceRateMCTuner.jl:9."""
    return logistic(x, 2.0, k, 0.0, 0.0)


def erf_rate_score(x, k=3.0):
    """erf-based score in (0, 2) — src/tuners/AcceptanceRateMCTuner.jl:17."""
    return jax.scipy.special.erf(k * x) + 1.0


class TuneState(NamedTuple):
    """Counterpart of the reference's MCTunerState family."""

    step: jax.Array          # step size (scalar, or per-coordinate for AMWG)
    accepted: jax.Array      # accepted proposals in current tuning period
    proposed: jax.Array      # proposed in current tuning period
    totproposed: jax.Array   # total proposed across completed periods
    rate: jax.Array          # last computed acceptance rate (NaN before first)
    extra: Any = ()          # tuner-specific adaptation state


def _fresh_counters(step, like=None):
    step = jnp.asarray(step)
    zero = jnp.zeros_like(step, dtype=jnp.int32) if like == "vector" else jnp.int32(0)
    return step, zero


@dataclasses.dataclass(frozen=True)
class Tuner:
    """Base: no-op tuner (VanillaMCTuner without verbosity).

    ``period`` is keyword-only so subclass positional signatures match the
    reference ctors (e.g. DualAveragingTuner(targetrate, nadapt) mirrors
    DualAveragingMCTuner(targetrate, nadapt), src/tuners/
    DualAveragingMCTuner.jl:83-93)."""

    period: int = dataclasses.field(default=100, kw_only=True)

    def init(self, step0) -> TuneState:
        step0 = jnp.asarray(step0)
        f = step0.dtype if step0.dtype.kind == "f" else jnp.float32
        return TuneState(
            step=step0,
            # float accumulator: supports pooled (fractional) acceptance
            accepted=jnp.zeros((), f),
            proposed=jnp.int32(0),
            totproposed=jnp.int32(0),
            rate=jnp.array(jnp.nan, dtype=f),
            extra=self._extra_init(step0),
        )

    def _extra_init(self, step0):
        return ()

    # -- per-step update -----------------------------------------------------
    def update(self, tune: TuneState, accept, accept_stat, burnin: int) -> TuneState:
        """accept: 0/1 this step (may be a pooled fraction);
        accept_stat: acceptance probability in [0,1]."""
        accepted = tune.accepted + jnp.asarray(accept, tune.accepted.dtype)
        proposed = tune.proposed + 1
        # reference gates on totproposed <= burnin (src/samplers/iterate/
        # MH.jl:127), i.e. the period that *straddles* the burnin boundary
        # still fires
        at_boundary = (proposed % self.period == 0) & (tune.totproposed <= burnin)
        rate = accepted / proposed.astype(accepted.dtype)

        new_step, new_extra = self._tune(
            tune._replace(accepted=accepted, proposed=proposed, rate=rate),
            accept_stat,
            at_boundary,
            burnin,
        )

        # reset_burnin! at period boundaries (src/tuners/tuners.jl:27-30)
        totproposed = jnp.where(at_boundary, tune.totproposed + proposed, tune.totproposed)
        accepted = jnp.where(at_boundary, 0, accepted)
        proposed = jnp.where(at_boundary, 0, proposed)
        rate = jnp.where(at_boundary, rate, tune.rate)
        return TuneState(new_step, accepted, proposed, totproposed, rate, new_extra)

    def _tune(self, tune, accept_stat, at_boundary, burnin):
        return tune.step, tune.extra

    def finalize(self, tune: TuneState) -> TuneState:
        """Freeze the tune state for post-adaptation sampling.

        Used by MCJob.run_phased at the warmup/sampling boundary: the
        sampling scan carries no tuner code, so any 'freeze' the tuner
        would apply on its first post-adaptation update must be applied
        here instead.  Base tuners adapt only inside burnin periods, so
        the default is the identity."""
        return tune


@dataclasses.dataclass(frozen=True)
class VanillaTuner(Tuner):
    """No-op tuner — src/tuners/VanillaMCTuner.jl:6-16 (verbosity is a
    host-side concern here; see klara_tpu.jobs.job progress logging)."""


@dataclasses.dataclass(frozen=True)
class AcceptanceRateTuner(Tuner):
    """Scale step by score(observed - target rate) each burnin period.

    src/tuners/AcceptanceRateMCTuner.jl:25-49; update rule at line 46:
    ``tune.step *= score(tune.rate - targetrate)``.
    """

    targetrate: float = 0.234
    score: str = "logistic"  # 'logistic' | 'erf'
    k: Optional[float] = None

    def _score(self, x):
        if self.score == "logistic":
            return logistic_rate_score(x, 7.0 if self.k is None else self.k)
        if self.score == "erf":
            return erf_rate_score(x, 3.0 if self.k is None else self.k)
        raise ValueError(f"unknown score {self.score!r}")

    def _tune(self, tune, accept_stat, at_boundary, burnin):
        scaled = tune.step * self._score(tune.rate - self.targetrate)
        return jnp.where(at_boundary, scaled, tune.step), tune.extra


class DualAveragingExtra(NamedTuple):
    mu: jax.Array       # log(10 * step0), set on first update
    eps_bar: jax.Array  # averaged step
    h_bar: jax.Array    # averaged (target - a) statistic
    count: jax.Array    # adaptation step counter


@dataclasses.dataclass(frozen=True)
class DualAveragingTuner(Tuner):
    """Hoffman-Gelman dual averaging (Algorithm 6).

    src/tuners/DualAveragingMCTuner.jl:52-101. Adapts every step during the
    first ``nadapt`` iterations, then freezes step = εbar
    (src/samplers/iterate/HMC.jl:225-250).
    """

    targetrate: float = 0.8
    nadapt: int = 1000
    gamma: float = 0.05
    t0: int = 10
    kappa: float = 0.75

    def _extra_init(self, step0):
        f = step0.dtype if step0.dtype.kind == "f" else jnp.float32
        return DualAveragingExtra(
            mu=jnp.log(10.0 * step0.astype(f)),
            eps_bar=jnp.ones_like(step0, dtype=f),
            h_bar=jnp.zeros_like(step0, dtype=f),
            count=jnp.int32(0),
        )

    def _tune(self, tune, accept_stat, at_boundary, burnin):
        ex: DualAveragingExtra = tune.extra
        count = ex.count + 1
        cf = count.astype(tune.step.dtype)
        adapting = count <= self.nadapt

        h_weight = 1.0 / (cf + self.t0)
        h_bar = (1.0 - h_weight) * ex.h_bar + h_weight * (self.targetrate - accept_stat)
        step = jnp.exp(ex.mu - jnp.sqrt(cf) * h_bar / self.gamma)
        eps_weight = cf ** (-self.kappa)
        eps_bar = jnp.exp((1.0 - eps_weight) * jnp.log(ex.eps_bar) + eps_weight * jnp.log(step))

        new_step = jnp.where(adapting, step, ex.eps_bar)
        new_extra = DualAveragingExtra(
            mu=ex.mu,
            eps_bar=jnp.where(adapting, eps_bar, ex.eps_bar),
            h_bar=jnp.where(adapting, h_bar, ex.h_bar),
            count=count,
        )
        return new_step, new_extra

    def finalize(self, tune: TuneState) -> TuneState:
        """step := εbar — the reference applies this on the first
        post-nadapt iteration (src/samplers/iterate/HMC.jl:247); at the
        phased warmup/sampling boundary it is applied once here.  (With
        nadapt == burnin this freezes one step earlier than the
        reference's trailing raw step — εbar is the better estimate.)
        A zero-length warmup (count == 0) keeps the raw step: εbar is
        still its init value 1.0."""
        ex: DualAveragingExtra = tune.extra
        return tune._replace(step=jnp.where(ex.count > 0, ex.eps_bar, tune.step))

    def set_mu_from_step(self, tune: TuneState) -> TuneState:
        """Re-anchor μ = log(10·step) after an initial step-size search —
        mirrors src/samplers/HMC.jl:183-209."""
        ex: DualAveragingExtra = tune.extra
        return tune._replace(extra=ex._replace(mu=jnp.log(10.0 * tune.step)))


class RobertsRosenthalExtra(NamedTuple):
    batch: jax.Array


@dataclasses.dataclass(frozen=True)
class RobertsRosenthalTuner(Tuner):
    """Per-coordinate ±δ adaptation of logσ (Roberts & Rosenthal 2009).

    src/tuners/RobertsRosenthalMCTuner.jl:84-107: per batch of `period`
    proposals, δ = min(0.01, batch^-0.5) and logσ_i += ±δ according to
    whether coordinate i's observed rate is above/below target.

    Here ``tune.step`` holds **logσ** (a vector for MuvAMWG), and
    ``accept``/``accept_stat`` are per-coordinate vectors supplied by the
    AMWG kernel.
    """

    targetrate: float = 0.44
    period: int = dataclasses.field(default=50, kw_only=True)

    def _extra_init(self, step0):
        return RobertsRosenthalExtra(batch=jnp.int32(0))

    def update(self, tune: TuneState, accept, accept_stat, burnin: int = 0) -> TuneState:
        # NOTE: unlike the burnin-gated tuners, Roberts-Rosenthal adaptation
        # never stops (diminishing δ ensures ergodicity) — matching the
        # reference, whose AMWG tune! is not burnin-gated
        # (src/samplers/iterate/AMWG.jl:77-87).
        f = tune.step.dtype
        accepted = tune.accepted + jnp.asarray(accept, f)  # per-coordinate vector
        proposed = tune.proposed + 1
        at_boundary = proposed % self.period == 0
        rate = accepted / jnp.maximum(proposed, 1).astype(f)

        batch = tune.extra.batch + jnp.asarray(at_boundary, jnp.int32)
        delta = jnp.minimum(0.01, batch.astype(f) ** -0.5)
        adjusted = tune.step + jnp.where(rate < self.targetrate, -delta, delta)
        step = jnp.where(at_boundary, adjusted, tune.step)

        totproposed = jnp.where(at_boundary, tune.totproposed + proposed, tune.totproposed)
        accepted = jnp.where(at_boundary, 0, accepted)
        proposed = jnp.where(at_boundary, 0, proposed)
        mean_rate = jnp.where(at_boundary, jnp.mean(rate), tune.rate)
        return TuneState(step, accepted, proposed, totproposed, mean_rate, RobertsRosenthalExtra(batch))

    def init_vector(self, logsigma0) -> TuneState:
        logsigma0 = jnp.asarray(logsigma0)
        return TuneState(
            step=logsigma0,
            accepted=jnp.zeros(logsigma0.shape, logsigma0.dtype),
            proposed=jnp.int32(0),
            totproposed=jnp.int32(0),
            rate=jnp.array(jnp.nan, logsigma0.dtype),
            extra=self._extra_init(logsigma0),
        )
