"""Hamiltonian Monte Carlo.

Reference: src/samplers/HMC.jl:89-100 (HMC(leapstep=0.1, nleaps=10)) and
kernel src/samplers/iterate/HMC.jl:124-250:

  * momentum ~ N(0, I) (line 135);
  * ``nleaps`` leapfrog steps at step ε = tune.step;
  * accept with probability min(1, exp(H' − H)) (lines 157-165);
  * with DualAveragingTuner the trajectory length λ = nleaps·leapstep is
    held fixed and nleaps = max(1, round(λ/ε)) is recomputed each
    iteration (lines 142-144); ε is dual-averaged from the per-step
    acceptance statistic during the first nadapt iterations (225-248),
    with ε initialised by the doubling/halving search and
    μ = log(10·ε₀) (src/samplers/HMC.jl:183-209).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from klara_tpu.core.target import Target
from klara_tpu.samplers.base import Info, Sampler, metropolis_accept
from klara_tpu.samplers.hamiltonian import (
    PhasePoint,
    find_reasonable_step_size,
    hamiltonian,
    leapfrog,
    sample_momentum,
)
from klara_tpu.tuners.tuners import DualAveragingTuner, TuneState


class HMCState(NamedTuple):
    position: jax.Array
    logtarget: jax.Array
    gradlogtarget: jax.Array
    inv_mass: jax.Array     # diagonal inverse mass (1 = identity, reference)
    tune: TuneState
    # log trajectory length λ + its Adam moments, adapted cross-chain by
    # the job's ChEES hook (klara_tpu.jobs.job traj_adaptation); static
    # λ = exp(log_traj) stays at its init when the hook is off.
    # NOTE: no jnp defaults here — array creation at class-definition time
    # would initialise the XLA backend on import and break
    # jax.distributed.initialize (multi-host launch).
    log_traj: jax.Array
    traj_m: jax.Array
    traj_v: jax.Array


@dataclasses.dataclass(frozen=True)
class HMC(Sampler):
    leapstep: float = 0.1
    nleaps: int = 10
    # fixed trajectory length used with dual averaging; None → nleaps*leapstep
    trajectory_length: float | None = None
    # hard cap on per-iteration leapfrog count when nleaps is dynamic
    max_nleaps: int = 1024
    # recompute nleaps = round(λ/ε) per step — set automatically by
    # bind_tuner when the tuner is DualAveraging (reference
    # src/samplers/iterate/HMC.jl:142-144); user-settable for testing
    dynamic_nleaps: bool = False
    # many-chain extension (no reference counterpart): multiply the
    # trajectory length by U(1-jitter, 1+jitter) each step to break the
    # resonances a FIXED trajectory hits on near-Gaussian targets
    # (Neal 2011 §3.2 recommends jittering ε or L).  Only active with
    # dynamic_nleaps.
    jitter: float = 0.0
    # 'step' (default): ONE shared jitter draw per iteration, applied by
    # the job driver to all chains — under vmap every chain then runs the
    # same nleaps, so no SIMD lane idles (per-chain trip counts run to
    # the batch MAX, wasting ~E[max]/E[mean] ≈ 2x the leapfrogs at
    # jitter=0.9).  This matches ChEES-HMC's shared per-iteration jitter
    # (Hoffman, Radul & Sountsov 2021).  'chain': independent per-chain
    # draws (inside the kernel) — decorrelates trajectory lengths across
    # chains at the cost of batch-max execution.
    #
    # NOTE: the shared draw needs one key common to all chains, which only
    # the MCJob driver has (it zeroes the kernel's jitter and applies one
    # draw outside the vmap).  Standalone kernel use — direct step() calls
    # or a Gibbs-nested HMC, where every chain carries its own key —
    # necessarily falls back to per-chain ('chain') draws.
    jitter_style: str = "step"

    tuner_statistic = "accept_stat"

    def bind_tuner(self, tuner):
        """Under dual averaging, hold the trajectory length λ = nleaps·ε₀
        fixed and recompute nleaps every iteration as ε adapts — reference
        src/samplers/iterate/HMC.jl:142-144."""
        if isinstance(tuner, DualAveragingTuner) and not self.dynamic_nleaps:
            return dataclasses.replace(self, dynamic_nleaps=True)
        return self

    def default_step_size(self):
        return self.leapstep

    def init(self, key, target: Target, position, step_size=None, tuner=None):
        position = jnp.asarray(position)
        lt, grad = target.logdensity_and_grad(position)
        tuner = tuner or self.default_tuner()

        if step_size is not None:
            step0 = jnp.asarray(step_size, position.dtype)
        elif isinstance(tuner, DualAveragingTuner):
            # reference runs the Alg-4 search when dual averaging is on
            step0 = find_reasonable_step_size(key, target, position)
        else:
            step0 = jnp.asarray(self.leapstep, position.dtype)

        tune = tuner.init(step0)
        if isinstance(tuner, DualAveragingTuner):
            tune = tuner.set_mu_from_step(tune)
        inv_mass = jnp.ones_like(position)
        lam0 = self.trajectory_length
        if lam0 is None:
            lam0 = self.nleaps * self.leapstep
        f = position.dtype if position.dtype.kind == "f" else jnp.float32
        zero = jnp.zeros((), f)
        return HMCState(
            position, lt, grad, inv_mass, tune,
            log_traj=jnp.log(jnp.asarray(lam0, f)),
            traj_m=zero,
            traj_v=zero,
        )

    def _nleaps(self, eps, k_jit=None, log_traj=None):
        if not self.dynamic_nleaps:
            return self.nleaps, jnp.ones((), jnp.asarray(eps).dtype)
        if log_traj is None:
            lam = self.trajectory_length
            if lam is None:
                lam = self.nleaps * self.leapstep
            lam = jnp.asarray(lam, jnp.asarray(eps).dtype)
        else:
            lam = jnp.exp(log_traj)
        frac = jnp.ones((), lam.dtype)
        if self.jitter > 0.0 and k_jit is not None:
            frac = jax.random.uniform(
                k_jit, minval=1.0 - self.jitter, maxval=1.0 + self.jitter,
                dtype=lam.dtype,
            )
            lam = lam * frac
        n = jnp.round(lam / eps).astype(jnp.int32)
        return jnp.clip(n, 1, self.max_nleaps), frac

    def step(self, key, state: HMCState, target: Target):
        key, k_jit = jax.random.split(key)
        k_mom, k_acc = jax.random.split(key)
        x, lt, grad = state.position, state.logtarget, state.gradlogtarget
        eps = state.tune.step
        inv_mass = state.inv_mass

        p0 = sample_momentum(k_mom, x, inv_mass)
        h0 = hamiltonian(lt, p0, inv_mass)

        nleaps, frac = self._nleaps(eps, k_jit, state.log_traj)
        pp = leapfrog(
            target,
            PhasePoint(x, p0, lt, grad),
            eps,
            nleaps,
            inv_mass,
        )
        h1 = hamiltonian(pp.logtarget, pp.momentum, inv_mass)
        ratio = h1 - h0
        ratio = jnp.where(jnp.isnan(ratio), -jnp.inf, ratio)

        accept = metropolis_accept(k_acc, ratio)
        new_state = HMCState(
            position=jnp.where(accept, pp.position, x),
            logtarget=jnp.where(accept, pp.logtarget, lt),
            gradlogtarget=jnp.where(accept, pp.gradlogtarget, grad),
            inv_mass=inv_mass,
            tune=state.tune,
            log_traj=state.log_traj,
            traj_m=state.traj_m,
            traj_v=state.traj_v,
        )
        a = jnp.minimum(1.0, jnp.exp(jnp.minimum(ratio, 0.0)))
        info = Info(
            accept=accept,
            accept_stat=a,
            logtarget=new_state.logtarget,
            extras={
                "nleaps": jnp.asarray(nleaps, jnp.int32),
                # phase-space endpoints for the job's cross-chain ChEES
                # trajectory hook (unused otherwise -> DCE'd by XLA)
                "x_prop": pp.position,
                "p_end": pp.momentum,
                "traj_frac": frac,
            },
        )
        return new_state, info
