"""MCJob: the simulation driver.

Many-chain re-design of the reference's ``BasicMCJob``
(src/jobs/BasicMCJob.jl:6-295).  The reference's hot loop —

    for i in 1:nsteps
        iterate!(job, sampler, variate_form)     # mutate states
        i in postrange && save(job, count)       # copy! into NState
    end                                          (BasicMCJob.jl:212-244)

— becomes a single compiled program:

    * the step kernel is a pure function, `vmap`-ed over a chains axis
      (the reference runs ONE chain per job; `run(::Vector{MCJob})` is a
      serial map, src/jobs/jobs.jl:212 — here thousands of chains run in
      lockstep per device);
    * `lax.scan` drives the steps; saving is an in-scan
      `dynamic_update_index_in_dim` scatter into preallocated
      ``(n_post, n_chains, ...)`` trace buffers, gated by the postrange
      predicate (no O(n_steps) memory, no host transfers in the loop);
    * tuner updates run inside the scan with `jnp.where` gating
      (burnin-period semantics identical to the reference, see
      klara_tpu.tuners);
    * chains are sharded over a device mesh axis ('chains') — data
      parallelism with zero per-step communication; optional *pooled*
      adaptation reduces acceptance statistics across all chains (a
      cross-device `mean`, lowered by XLA to an all-reduce).

Monitored fields (reference outopts[:monitor], src/jobs/jobs.jl:9-46):
'value', 'logtarget', 'loglikelihood', 'logprior', 'gradlogtarget'.
Diagnostics (reference outopts[:diagnostics]): 'accept', 'accept_stat',
plus sampler extras (e.g. NUTS 'ndoublings').
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from klara_tpu.core.target import Target
from klara_tpu.jobs.chain import Chain
from klara_tpu.jobs.range import MCRange
from klara_tpu.samplers.base import Info, Sampler
from klara_tpu.tuners.tuners import Tuner


@functools.partial(jax.jit, donate_argnums=0)
def _back_transform(y, L):
    """x = L y over a whitened trace, in the trace's storage dtype: under
    trace_dtype='bfloat16' the bf16 x f32 einsum would otherwise promote
    to a full-size f32 buffer (2x the bf16 trace, 3x footprint at peak).
    Jitted once at module level so XLA fuses the down-cast into the einsum
    epilogue and donates the whitened trace, without recompiling per
    call."""
    return jnp.einsum("...d,ed->...e", y, L).astype(y.dtype)


def _field_value(name: str, state, info: Info, target: Target):
    """Monitored-field lookup — all 13 reference slots ({log,gradlog,
    tensorlog,dtensorlog} × {likelihood,prior,target} + value), matching
    src/nstates/ParameterNStates/BasicContMuvParameterNState.jl:89-119."""
    if name == "value":
        return state.position
    if name == "logtarget":
        return info.logtarget
    if name == "loglikelihood":
        return target.loglikelihood(state.position)
    if name == "logprior":
        return target.logprior(state.position)
    if name == "gradlogtarget":
        if hasattr(state, "gradlogtarget"):
            return state.gradlogtarget
        return target.grad(state.position)
    if name == "gradloglikelihood":
        return target.grad_loglikelihood(state.position)
    if name == "gradlogprior":
        return target.grad_logprior(state.position)
    if name == "tensorlogtarget":
        return target.tensor(state.position)
    if name == "tensorloglikelihood":
        return target.tensor_loglikelihood(state.position)
    if name == "tensorlogprior":
        return target.tensor_logprior(state.position)
    if name == "dtensorlogtarget":
        return target.dtensor(state.position)
    if name == "dtensorloglikelihood":
        return target.dtensor_loglikelihood(state.position)
    if name == "dtensorlogprior":
        return target.dtensor_logprior(state.position)
    raise ValueError(f"unknown monitored field {name!r}")


def _diag_value(name: str, state, info: Info):
    if name == "accept":
        return info.accept
    if name == "accept_stat":
        return info.accept_stat
    if name in info.extras:
        return info.extras[name]
    if name in getattr(state, "_fields", ()):
        # sampler-state ARRAY fields (tune step, log_traj, inv_mass, ...)
        # are recordable per draw — the reference's adaptation diagnostics
        # channel (e.g. AMWG's per-draw logσ, src/samplers/AMWG.jl:109).
        # _fields excludes NamedTuple methods ('count', 'index'); the
        # dtype check excludes non-array sub-pytrees ('tune').
        val = getattr(state, name)
        if hasattr(val, "dtype"):
            return val
    raise ValueError(f"unknown diagnostic {name!r}")


@dataclasses.dataclass
class MCJob:
    """Single-parameter MCMC job over a batch of chains.

    Parameters
    ----------
    target : Target
    sampler : Sampler (static hyper-parameters)
    mcrange : MCRange (n_steps / burnin / thinning)
    tuner : Tuner or None (None -> sampler.default_tuner())
    n_chains : number of parallel chains (vmap axis, mesh-sharded)
    monitor : monitored fields saved per post-burnin draw
    diagnostics : per-draw diagnostics saved alongside
    mesh : optional jax mesh with a 'chains' axis for multi-chip sharding
    pooled_tuning : adapt from cross-chain pooled acceptance statistics
    step_size : initial step size override (else sampler default / search)
    """

    target: Target
    sampler: Sampler
    mcrange: MCRange = dataclasses.field(default_factory=MCRange)
    tuner: Optional[Tuner] = None
    n_chains: int = 1
    monitor: Sequence[str] = ("value", "logtarget")
    diagnostics: Sequence[str] = ("accept",)
    mesh: Optional[Mesh] = None
    chains_axis: str = "chains"
    pooled_tuning: bool = False
    step_size: Optional[float] = None
    # output destination (reference outopts[:destination], jobs/jobs.jl:9-46):
    # 'nstate' = device trace buffers, 'csv' = stream draws to per-field
    # files via io_callback, 'none' = keep only the final state
    destination: str = "nstate"
    filepath: Optional[str] = None
    flush: bool = False
    # csv streaming flushes to the host every `stream_chunk` steps (saved
    # draws accumulate in a device ring buffer in between): one ordered
    # io_callback round-trip per chunk instead of per step, since every
    # round-trip stalls the device (SURVEY §2.2 'chunked dumps')
    stream_chunk: int = 128
    # 'io_callback' = true in-loop streaming (bounded host memory);
    # 'post' = buffer draws on device and export the CSV directory after
    # the run — no host callbacks inside the compiled program, and the
    # in-memory trace is returned too; O(n_post) device memory like
    # 'nstate'
    stream_mode: str = "io_callback"
    # host-side burnin progress reports every `progress_period` steps —
    # the reference tuner `verbose` flag (src/samplers/iterate/MH.jl:126-140)
    verbose: bool = False
    progress_period: int = 100
    # ensemble mass-matrix adaptation (many-chain, no reference
    # counterpart): during burnin, every mass_period steps, set the
    # samplers' diagonal inverse mass to the regularised cross-chain
    # variance of the positions — with thousands of chains the ensemble
    # variance is an instant estimator of the posterior scales, replacing
    # Stan-style Welford windows; under mesh sharding the variance is a
    # cross-device collective.  Only samplers whose state carries
    # ``inv_mass`` (HMC, NUTS) participate.
    mass_adaptation: bool = False
    mass_period: int = 100
    # ChEES-style cross-chain trajectory-length adaptation (many-chain,
    # no reference counterpart; Hoffman, Radul & Sountsov 2021): during
    # burnin, ascend the Change-in-the-Estimator-of-the-Expected-Square
    # jumped distance criterion on log λ with Adam, estimated from the
    # ensemble's phase-space endpoints (a cross-device mean under a mesh).
    # The modern alternative to NUTS for many-chain regimes: fixed-shape
    # leapfrog loops (no per-chain tree control flow), near-NUTS ESS.
    # Use with HMC(jitter=...) so trajectory jitter breaks resonances;
    # requires a sampler whose state carries ``log_traj`` (HMC).
    traj_adaptation: bool = False
    traj_lr: float = 0.1
    # ChEES starts after this fraction of burnin: during the initial
    # transient (chains far from stationarity) longer trajectories ALWAYS
    # increase ensemble spread, so the ChEES gradient is uniformly
    # positive and λ rockets to its clip at the full Adam rate before
    # the ensemble equilibrates (measured: λ 0.5→1000 in <100 steps on
    # 100-dim logreg).  Delaying past the transient (and past the first
    # mass-matrix update) keeps the gradient informative.
    traj_start_frac: float = 0.1
    # Storage dtype for the device-resident SAMPLE trace buffers (the
    # (n_post, n_chains, dim) arrays — the device-memory floor of a long
    # run; the reference's NState storage is host RAM, nstates/*.jl, so it
    # never faces this).  None keeps each monitored field's compute dtype;
    # 'bfloat16' halves the trace memory so sampling windows twice as
    # long fit on the device.  Draw values carry ~0.4% relative rounding —
    # far below MC noise for moment/ESS estimation — and rank-based
    # diagnostics (rank-R-hat) are insensitive to it.  The SAMPLING kernel is
    # untouched (states stay f32; only the saved copy rounds).
    # Diagnostics buffers keep their dtypes (ints/bools).
    trace_dtype: Optional[str] = None

    def __post_init__(self):
        if self.tuner is None:
            self.tuner = self.sampler.default_tuner()
        # let the sampler specialise its static config to the tuner — e.g.
        # HMC switches to fixed-trajectory dynamic nleaps under dual
        # averaging (reference src/samplers/iterate/HMC.jl:142-144)
        self.sampler = self.sampler.bind_tuner(self.tuner)
        if self.traj_adaptation:
            if not hasattr(self.sampler, "dynamic_nleaps"):
                raise ValueError(
                    "traj_adaptation requires an HMC-family sampler whose "
                    "trajectory length is dynamic (state carries log_traj)"
                )
            if not self.sampler.dynamic_nleaps:
                self.sampler = dataclasses.replace(
                    self.sampler, dynamic_nleaps=True
                )
        if self.destination not in ("nstate", "csv", "none"):
            raise ValueError(f"unknown destination {self.destination!r}")
        if self.destination == "csv" and not self.filepath:
            raise ValueError("destination='csv' requires filepath")
        if self.stream_mode not in ("io_callback", "post"):
            raise ValueError(f"unknown stream_mode {self.stream_mode!r}")
        if self.trace_dtype is not None:
            jnp.dtype(self.trace_dtype)  # fail fast on a typo'd dtype
        self._writer = None
        # cache the compiled program: a fresh jax.jit(self._run) per call
        # would re-trace (and possibly re-compile) every run
        self._run_jit = jax.jit(self._run)
        self._resume_jit = None
        self._warm_jit = None
        self._sample_jit = None

    # ------------------------------------------------------------- from model
    @classmethod
    def from_model(cls, model, sampler, mcrange, v0: dict, pkey: Optional[str] = None, **kwargs):
        """Build a single-parameter job from a model graph + initial values —
        the reference's ``BasicMCJob(model, sampler, mcrange, v0)`` signature
        (src/jobs/BasicMCJob.jl:156-185).  Non-parameter vertices take their
        (fixed) values from ``v0``; returns (job, x0).
        """
        params = model.parameters
        if pkey is None:
            if len(params) != 1:
                raise ValueError(
                    "model has multiple parameters; pass pkey to choose one "
                    "(or use GibbsJob)"
                )
            pkey = params[0].key
        param = model[pkey]
        consts = {k: jnp.asarray(v) for k, v in v0.items() if k != pkey}
        target = Target(
            logdensity_fn=lambda x: param.conditional_logdensity(x, consts),
            name=pkey,
        )
        return cls(target, sampler, mcrange, **kwargs), jnp.asarray(v0[pkey])

    # ------------------------------------------------------------------ init
    def _init_states(self, key, x0):
        x0 = jnp.asarray(x0)
        # disambiguate "one (D,) position for all chains" from "(n_chains,)
        # scalar positions" via target.dim when n_chains == D
        if (
            x0.ndim == 1
            and self.n_chains > 1
            and x0.shape[0] == self.n_chains
            and self.target.dim is None
        ):
            raise ValueError(
                f"ambiguous initial value: x0 has shape {x0.shape} with "
                f"n_chains={self.n_chains} and target.dim unset — cannot tell "
                "one (D,)-vector position shared by all chains from per-chain "
                "scalar positions. Set Target(dim=...) or pass x0 shaped "
                "(n_chains, dim)."
            )
        single_vector = (
            x0.ndim == 1
            and self.target.dim is not None
            and x0.shape[0] == self.target.dim
        )
        if x0.ndim == 0 or single_vector or (
            x0.ndim == 1 and self.n_chains != x0.shape[0]
        ):
            x0 = jnp.broadcast_to(x0, (self.n_chains,) + x0.shape)
        elif x0.shape[0] != self.n_chains:
            x0 = jnp.broadcast_to(x0, (self.n_chains,) + x0.shape)
        init_keys = jax.random.split(key, self.n_chains)
        init_one = functools.partial(
            self.sampler.init,
            target=self.target,
            step_size=self.step_size,
            tuner=self.tuner,
        )
        states = jax.vmap(lambda k, x: init_one(k, position=x))(init_keys, x0)
        if (
            self.pooled_tuning
            and hasattr(states, "tune")
            and not self.sampler.self_tuning
        ):
            # pooled adaptation must start from ONE shared step size: the
            # per-chain Alg-4 searches give every chain a different ε0 (and
            # dual-averaging μ), so even with pooled statistics the chains
            # would adapt to different steps forever — and a per-chain ε
            # makes per-chain leapfrog trip counts, which under vmap all
            # run to the batch max (idle SIMD lanes).  Geometric mean of
            # the per-chain searches, μ re-anchored to it.
            from klara_tpu.tuners.tuners import DualAveragingTuner

            tune = states.tune
            pooled_step = jnp.exp(
                jnp.mean(jnp.log(tune.step), axis=0, keepdims=True)
            )
            tune = tune._replace(
                step=jnp.broadcast_to(pooled_step, tune.step.shape).astype(
                    tune.step.dtype
                )
            )
            if isinstance(self.tuner, DualAveragingTuner):
                tune = jax.vmap(self.tuner.set_mu_from_step)(tune)
            states = states._replace(tune=tune)
        return states

    # ------------------------------------------------------------------ step
    def _scan_fn(
        self,
        chain_keys,
        stream: bool = False,
        adapt: bool = True,
        save: bool = True,
    ):
        """Build the per-step scan body.

        ``adapt=False`` drops the tuner/mass/ChEES update code entirely —
        used by :meth:`run_phased` for the post-burnin sampling scan,
        where every adaptation is frozen anyway (the reference stops
        adapting at burnin too, src/samplers/iterate/HMC.jl:225-248).
        ``save=False`` drops the trace-buffer writes (warmup scan).
        """
        sampler, target, tuner = self.sampler, self.target, self.tuner
        burnin, thinning = self.mcrange.burnin, self.mcrange.thinning
        pooled = self.pooled_tuning
        stat_name = sampler.tuner_statistic

        # shared ('step'-style) trajectory jitter: ONE draw per iteration
        # applied to every chain via a temporary log_traj offset, so the
        # vmapped leapfrog runs the same trip count on every SIMD lane
        # (see HMC.jitter_style).  The kernel's own per-chain jitter is
        # disabled for the step call.
        shared_jitter = (
            getattr(sampler, "jitter", 0.0) > 0.0
            and getattr(sampler, "jitter_style", "chain") == "step"
            and getattr(sampler, "dynamic_nleaps", False)
        )
        step_sampler = (
            dataclasses.replace(sampler, jitter=0.0) if shared_jitter else sampler
        )

        def one_step(key, i, state):
            step_key = jax.random.fold_in(key, i)
            return step_sampler.step(step_key, state, target)

        def scan_body(carry, i):
            states, buffers = carry
            prev_pos = states.position  # pre-step positions (ChEES hook)
            frac_shared = jnp.float32(1.0)
            if shared_jitter:
                # jitter key stream disjoint from every chain's step keys
                # (those are fold_in(chain_key, i) with i < n_steps)
                jit_key = jax.random.fold_in(
                    jax.random.fold_in(chain_keys[0], 2**31 - 1), i
                )
                frac_shared = jax.random.uniform(
                    jit_key,
                    minval=1.0 - sampler.jitter,
                    maxval=1.0 + sampler.jitter,
                    dtype=states.log_traj.dtype,
                )
                lt_saved = states.log_traj
                states = states._replace(
                    log_traj=states.log_traj + jnp.log(frac_shared)
                )
            states, infos = jax.vmap(lambda k, s: one_step(k, i, s))(chain_keys, states)
            if shared_jitter:
                # log_traj passes through the kernel untouched; restore the
                # unjittered value exactly (no float round-trip)
                states = states._replace(log_traj=lt_saved)

            if adapt and not sampler.self_tuning:
                accept = infos.accept.astype(jnp.float32)
                stat = infos.accept_stat if stat_name == "accept_stat" else accept
                if pooled:
                    # cross-chain (and cross-device, via XLA-inserted psum)
                    # pooling of acceptance statistics
                    accept = jnp.broadcast_to(jnp.mean(accept), accept.shape)
                    stat = jnp.broadcast_to(
                        jnp.mean(stat.astype(jnp.float32)), stat.shape
                    )
                new_tune = jax.vmap(
                    lambda t, a, s: tuner.update(t, a, s, burnin)
                )(states.tune, accept, stat)
                states = states._replace(tune=new_tune)

            if adapt and self.mass_adaptation and hasattr(states, "inv_mass"):
                # regularised ensemble variance.  Exactly Stan's covariance
                # regularisation (stan/mcmc/var_adaptation.hpp):
                #   Σ = n/(n+5)·var + 5/(n+5)·1e-3
                # i.e. shrinkage toward the SMALL constant 1e-3, not toward
                # unit mass — a deliberately conservative prior (tiny inverse
                # mass = small effective steps in unresolved coordinates).
                # Stan's n is the window draw count; ours is the ensemble
                # size, so at n_chains=32 the variance estimate is ~13% low
                # (tested in tests/test_hardening.py mass-adaptation test);
                # at bench scale (16k chains) the bias is invisible.
                n_c = states.position.shape[0]
                var = jnp.var(states.position, axis=0, keepdims=True)
                w = n_c / (n_c + 5.0)
                new_inv_mass = jnp.broadcast_to(
                    w * var + (1.0 - w) * 1e-3 + 1e-7, states.inv_mass.shape
                )
                adapt_now = (
                    ((i + 1) % self.mass_period == 0)
                    & (i + 1 >= self.mass_period)
                    & (i < burnin)
                )
                states = states._replace(
                    inv_mass=jnp.where(adapt_now, new_inv_mass, states.inv_mass)
                )

            if adapt and self.traj_adaptation and hasattr(states, "log_traj"):
                # ChEES gradient estimate from the ensemble: per chain,
                # a-weighted (||x'−x̄'||² − ||x−x̄||²)·⟨x'−x̄', p'⟩·h, with
                # h the realized trajectory-jitter fraction.  The chain
                # means become psum collectives under a mesh.
                x_prop = infos.extras["x_prop"]
                p_end = infos.extras["p_end"]
                # realized jitter fraction: per-chain from the kernel, or
                # the shared per-step draw (kernel reports 1.0 then)
                frac = infos.extras["traj_frac"].astype(jnp.float32) * frac_shared
                a = infos.accept_stat.astype(jnp.float32)
                # ChEES is defined in the WHITENED (mass-metric) space
                # z = x/sqrt(M^-1): the squared-distance terms get
                # 1/inv_mass weights, while in the projection term
                # <z'-z̄', dz'/dT> = <x'-x̄', p'> the mass factors cancel
                # exactly (dz/dT = sqrt(M^-1)·p).  Unwhitened distances
                # let the widest posterior dimensions dominate the
                # gradient and can drive λ into runaway growth.
                inv_w = (
                    1.0 / states.inv_mass
                    if hasattr(states, "inv_mass")
                    else 1.0
                )
                xbar = jnp.mean(prev_pos, axis=0)
                xpbar = jnp.mean(x_prop, axis=0)
                dold = jnp.sum(inv_w * jnp.square(prev_pos - xbar), axis=-1)
                dnew = jnp.sum(inv_w * jnp.square(x_prop - xpbar), axis=-1)
                proj = jnp.sum((x_prop - xpbar) * p_end, axis=-1)
                w = a / jnp.maximum(jnp.mean(a), 1e-3)
                g = jnp.mean(w * (dnew - dold) * proj * frac)
                g = jnp.where(jnp.isfinite(g), g, 0.0)
                # pooled Adam ascent on log λ (all chains share the value)
                b1, b2 = 0.9, 0.999
                t = (i + 1).astype(jnp.float32)
                m = b1 * jnp.mean(states.traj_m) + (1.0 - b1) * g
                v = b2 * jnp.mean(states.traj_v) + (1.0 - b2) * g * g
                mhat = m / (1.0 - jnp.power(b1, t))
                vhat = v / (1.0 - jnp.power(b2, t))
                lt_new = jnp.mean(states.log_traj) + self.traj_lr * mhat / (
                    jnp.sqrt(vhat) + 1e-8
                )
                lt_new = jnp.clip(lt_new, jnp.log(1e-2), jnp.log(1e3))
                # never adapt λ beyond what the kernel can EXECUTE: past
                # λ·(1+jitter) = max_nleaps·ε the realized trajectory is
                # clipped, outcomes stop depending on λ, and the gradient
                # pins λ at the ceiling on sign noise
                if hasattr(sampler, "max_nleaps"):
                    eps_now = jnp.mean(states.tune.step)
                    cap = jnp.log(
                        eps_now * sampler.max_nleaps / (1.0 + sampler.jitter)
                    )
                    lt_new = jnp.minimum(lt_new, cap.astype(lt_new.dtype))
                traj_start = int(burnin * self.traj_start_frac)
                adapting = (i >= traj_start) & (i < burnin)

                def bc(x, like):
                    return jnp.broadcast_to(x.astype(like.dtype), like.shape)

                states = states._replace(
                    log_traj=jnp.where(
                        adapting, bc(lt_new, states.log_traj), states.log_traj
                    ),
                    traj_m=jnp.where(adapting, bc(m, states.traj_m), states.traj_m),
                    traj_v=jnp.where(adapting, bc(v, states.traj_v), states.traj_v),
                )

            if not save:
                if self.verbose:
                    self._progress_callback(i, infos, burnin)
                return (states, buffers), None

            save_idx = (i - burnin) // thinning
            do_save = (i >= burnin) & ((i - burnin) % thinning == 0)

            def write(bufs):
                samples, diags = bufs
                samples = {
                    name: jax.lax.dynamic_update_index_in_dim(
                        buf,
                        jax.vmap(lambda s, nf: _field_value(name, s, nf, target))(
                            states, infos
                        ).astype(buf.dtype),
                        save_idx,
                        0,
                    )
                    for name, buf in samples.items()
                }
                diags = {
                    name: jax.lax.dynamic_update_index_in_dim(
                        buf,
                        jax.vmap(lambda s, nf: _diag_value(name, s, nf))(
                            states, infos
                        ).astype(buf.dtype),
                        save_idx,
                        0,
                    )
                    for name, buf in diags.items()
                }
                return samples, diags

            buffers = jax.lax.cond(do_save, write, lambda b: b, buffers)

            if self.verbose:
                self._progress_callback(i, infos, burnin)

            if not stream:
                return (states, buffers), None

            fields = {
                name: jax.vmap(
                    lambda s, nf: _field_value(name, s, nf, target)
                )(states, infos)
                for name in self.monitor
            }
            fields.update(
                {
                    name: jax.vmap(lambda s, nf: _diag_value(name, s, nf))(
                        states, infos
                    )
                    for name in self.diagnostics
                }
            )
            return (states, buffers), (do_save, fields)

        return scan_body

    def _progress_callback(self, i, infos, burnin):
        """Host-side burnin progress report — the reference tuner `verbose`
        flag (src/samplers/iterate/MH.jl:126-140)."""

        def report(step, rate, in_burnin):
            phase = "burnin " if bool(in_burnin) else "sampling"
            print(
                f"[{self.target.name}] {phase} iteration {int(step)+1}: "
                f"{100*float(rate):.2f} % acceptance rate"
            )

        jax.lax.cond(
            # the i < n_steps conjunct silences padding steps in
            # the chunked-streaming path (no-op in the plain scan)
            ((i + 1) % self.progress_period == 0)
            & (i < self.mcrange.n_steps),
            lambda: jax.debug.callback(
                report,
                i,
                jnp.mean(infos.accept.astype(jnp.float32)),
                i < burnin,
            ),
            lambda: None,
        )

    def _alloc_buffers(self, states, example_info: Info):
        n_post, n_chains = self.mcrange.n_post, self.n_chains
        tdt = jnp.dtype(self.trace_dtype) if self.trace_dtype else None

        def alloc_like(x, cast=False):
            x = jnp.asarray(x)
            dt = x.dtype
            if cast and tdt is not None and jnp.issubdtype(dt, jnp.floating):
                dt = tdt
            return jnp.zeros((n_post,) + x.shape, dt)

        samples = {
            name: alloc_like(
                jax.vmap(lambda s, nf: _field_value(name, s, nf, self.target))(
                    states, example_info
                ),
                cast=True,
            )
            for name in self.monitor
        }
        diags = {
            name: alloc_like(
                jax.vmap(lambda s, nf: _diag_value(name, s, nf))(states, example_info)
            )
            for name in self.diagnostics
        }
        return samples, diags

    # ------------------------------------------------------------------- run
    def _run(self, key, x0):
        init_key, run_key = jax.random.split(key)
        states = self._init_states(init_key, x0)
        chain_keys = jax.random.split(run_key, self.n_chains)

        example_info = self._example_info(states, chain_keys)
        if self.destination == "nstate" or self._buffered_csv:
            buffers = self._alloc_buffers(states, example_info)
        else:
            buffers = ({}, {})

        states, buffers = self._drive(chain_keys, states, buffers)
        samples, diags = buffers
        return Chain(samples=samples, diagnostics=diags, final_state=states)

    def _drive(self, chain_keys, states, buffers):
        """Run the compiled step loop over mcrange.n_steps.

        Without a csv writer: one `lax.scan` over steps.  With one: an
        outer scan over chunks of `stream_chunk` steps, an inner fori_loop
        accumulating saved draws into a device ring buffer, and ONE
        ordered io_callback per chunk (`StreamingWriter.append_block`)."""
        n_steps = self.mcrange.n_steps
        if self._writer is None:
            scan_body = self._scan_fn(chain_keys)
            (states, buffers), _ = jax.lax.scan(
                scan_body, (states, buffers), jnp.arange(n_steps)
            )
            return states, buffers

        from jax.experimental import io_callback

        scan_body = self._scan_fn(chain_keys, stream=True)
        chunk = max(1, min(self.stream_chunk, n_steps))
        n_outer = -(-n_steps // chunk)  # ceil; trailing steps are padding
        fields_sd = jax.eval_shape(scan_body, (states, buffers), jnp.int32(0))[1][1]
        sbufs = {
            name: jnp.zeros((chunk,) + sd.shape, sd.dtype)
            for name, sd in fields_sd.items()
        }
        writer = self._writer

        def outer_body(carry, o):
            states, buffers, sbufs = carry

            def inner(j, c):
                states, buffers, sbufs, count = c
                i = o * chunk + j
                valid = i < n_steps
                (new_states, new_buffers), (do_save, fields) = scan_body(
                    (states, buffers), i
                )
                # padding steps past n_steps leave the carry untouched so
                # final_state is bit-identical to the unchunked path
                states = jax.lax.cond(
                    valid, lambda n, _: n, lambda _, s: s, new_states, states
                )
                buffers = new_buffers
                do_save = do_save & valid
                sbufs = {
                    name: jax.lax.dynamic_update_index_in_dim(
                        buf, fields[name].astype(buf.dtype), count, 0
                    )
                    for name, buf in sbufs.items()
                }
                count = count + do_save.astype(jnp.int32)
                return states, buffers, sbufs, count

            states, buffers, sbufs, count = jax.lax.fori_loop(
                0, chunk, inner, (states, buffers, sbufs, jnp.int32(0))
            )
            io_callback(
                writer.append_block,
                jax.ShapeDtypeStruct((), jnp.int32),
                count,
                sbufs,
                ordered=True,
            )
            return (states, buffers, sbufs), None

        (states, buffers, _), _ = jax.lax.scan(
            outer_body, (states, buffers, sbufs), jnp.arange(n_outer)
        )
        return states, buffers

    def run(self, key, x0=None) -> Chain:
        """Run the job end-to-end, compiled as one XLA program.

        Counterpart of reference ``run(::BasicMCJob)``
        (src/jobs/BasicMCJob.jl:212-244).  When ``x0`` is omitted, each
        chain's initial value is drawn from the target's prior — the
        reference draws NaN-initialised values from the parameter's
        pdf/prior (src/jobs/BasicMCJob.jl:59-67).
        """
        key, x0 = self._prepare_x0(key, x0)
        self._open_writer()
        self._checkin(x0)
        run_jit = self._run_jit
        x0 = self._shard_x0(x0)
        chain = run_jit(key, x0)
        chain = self._finish_output(chain)
        return self._squeeze(chain)

    # -------------------------------------------------------- phased run
    def run_phased(self, key, x0=None):
        """Run warmup and sampling as two separately-timed compiled scans.

        Returns ``(chain, timings)`` with ``timings = {'warmup_seconds',
        'sampling_seconds'}``.  Phase 1 scans steps ``[0, burnin)`` with
        all adaptation on and saves nothing; phase 2 scans
        ``[burnin, n_steps)`` with the adaptation code removed from the
        program — semantically identical to :meth:`run` because every
        adaptation freezes at burnin anyway (dual averaging holds
        step=εbar after nadapt, reference src/samplers/iterate/
        HMC.jl:225-248; mass/ChEES hooks gate on i<burnin), and verified
        bit-identical in tests (for nadapt < burnin).  Two documented
        boundary differences from :meth:`run`:

          * with nadapt >= burnin, dual averaging freezes to εbar AT the
            boundary (`Tuner.finalize`) instead of one step later — εbar
            is the better estimate, so this is a strict improvement;
          * a rate-tuner period that straddles the burnin boundary (which
            the reference lets fire just past burnin,
            src/samplers/iterate/MH.jl:127) does not fire.

        This is the honest way to report sampling throughput: warmup cost
        is real but amortises over however many draws follow, so the two
        are timed apart.

        Only in-memory output (`destination='nstate'`/`'none'`) is
        supported; use :meth:`run` for csv streaming.
        """
        import time as _time

        if self.destination == "csv":
            raise ValueError(
                "run_phased supports destination 'nstate'/'none' only"
            )
        key, x0 = self._prepare_x0(key, x0)
        self._checkin(x0)
        x0 = self._shard_x0(x0)

        if self._warm_jit is None:
            self._warm_jit = jax.jit(self._warmup_phase)
            self._sample_jit = jax.jit(self._sampling_phase)

        t0 = _time.perf_counter()
        states, chain_keys = self._warm_jit(key, x0)
        jax.block_until_ready(states)
        t1 = _time.perf_counter()
        chain = self._sample_jit(states, chain_keys)
        jax.block_until_ready(chain.final_state)
        t2 = _time.perf_counter()
        timings = {
            "warmup_seconds": t1 - t0,
            "sampling_seconds": t2 - t1,
        }
        return self._squeeze(chain), timings

    # ---------------------------------------- dense ensemble preconditioning
    def run_preconditioned(self, key, x0=None, ridge: float = 1e-6,
                           stage2_replace: Optional[dict] = None,
                           warm_stage2: bool = False,
                           back_transform: bool = True):
        """Two-stage run with a dense ensemble preconditioner.

        Many-chain dense-metric HMC/ChEES (no reference counterpart —
        the reference always uses identity mass, samplers.jl:101-103):

        1. **Stage 1** runs this job's warmup on the raw target and takes
           the cross-chain cloud of end-of-warmup positions.  With
           thousands of chains the ensemble covariance Σ of a D-dim
           posterior is massively over-determined (n_chains >> D), so a
           FULL dense estimate is available instantly — the ensemble
           analogue of Stan's windowed dense metric.
        2. **Stage 2** reruns warmup + sampling on the whitened target
           x = L y (Σ = L Lᵀ, :func:`klara_tpu.whiten_target`) from the
           whitened stage-1 states.  Sampling in y with identity/diagonal
           mass ≡ sampling in x with dense mass Σ⁻¹, at the cost of two
           (D, D) matvecs per gradient — a few percent on top of the
           target evaluation, with no per-chain matrix state.

        Returns ``(chain, timings, info)``: ``chain.value`` is mapped
        back to x-space (with ``back_transform=False`` it stays in
        whitened y-coordinates — saves a second full-trace buffer near
        the device-memory limit); ``timings['warmup_seconds']`` is the HONEST
        total adaptation cost (all of stage 1 + stage 2 warmup) and
        ``timings['sampling_seconds']`` stage 2's sampling phase;
        ``info`` carries the Cholesky factor and the whitened job.
        ``chain.final_state`` stays in WHITENED coordinates — to extend
        the run, ``info['whitened_job'].resume(...)`` continues in y and
        the new draws back-transform with ``info['chol']``
        (x = y @ cholᵀ).  On the 100-dim logreg, whitening shortens the
        ChEES trajectory several-fold (leaps/draw ~70 → ~8); the ESS/s
        effect on the H100 is not measured yet.

        Requires ``monitor=('value',)`` (other monitored fields live in
        y-space and are not back-transformed).
        """
        if tuple(self.monitor) != ("value",):
            raise ValueError(
                "run_preconditioned requires monitor=('value',); other "
                "fields are not back-transformed from the whitened space"
            )
        if self.destination != "nstate":
            raise ValueError("run_preconditioned requires destination='nstate'")
        if self.n_chains < 2:
            raise ValueError(
                "run_preconditioned needs an ensemble (n_chains >= 2; "
                "intended regime n_chains >> dim)"
            )
        # ---- stage 1: raw-target warmup -> ensemble covariance
        stage1 = dataclasses.replace(
            self,
            mcrange=MCRange(
                n_steps=self.mcrange.burnin + 1, burnin=self.mcrange.burnin
            ),
        )
        c1, t1 = stage1.run_phased(key, x0)
        # the trace may be stored reduced-precision (trace_dtype); the
        # ensemble covariance, its Cholesky, and the stage-2 start
        # positions must come back to full precision or bf16 would
        # propagate through y0 into the whitened sampler state
        x_end = jnp.asarray(c1.value[-1]).astype(jnp.float32)  # (n_chains, D)
        xc = x_end - jnp.mean(x_end, axis=0, keepdims=True)
        cov = (xc.T @ xc) / (x_end.shape[0] - 1)
        # shrink toward the diagonal with weight n/(n+D): full ensemble
        # covariance when n_chains >> D (the intended regime), a stable
        # diagonal-dominant estimate when the ensemble is small relative
        # to the dimension (where the raw cov would be singular)
        n, d = x_end.shape
        w = n / (n + d)
        diag = jnp.diag(jnp.diag(cov))
        cov = w * cov + (1.0 - w) * diag
        lam = ridge * jnp.mean(jnp.diag(cov)) + 1e-12  # relative ridge
        chol = jnp.linalg.cholesky(cov + lam * jnp.eye(cov.shape[0], dtype=cov.dtype))

        # ---- stage 2: whitened target, fresh adaptation, timed sampling.
        # ``stage2_replace`` overrides job fields for the whitened stage —
        # the usual use is pinning a FIXED trajectory length there: after
        # whitening the geometry is known (~unit isotropic), so ChEES
        # adaptation is redundant and its run-to-run noise (measured
        # lambda anywhere in 3-7+ on the same workload) only costs leaps.
        # E.g. stage2_replace=dict(traj_adaptation=False,
        # sampler=HMC(trajectory_length=3.0, jitter=0.9, ...)).
        from klara_tpu.core.target import whiten_target

        repl = dict(stage2_replace or {})
        if "step_size" not in repl and self.step_size is None:
            # The whitened geometry is known (~unit isotropic), so the
            # stage-2 pooled Alg-4 step-size search is redundant: seed
            # dual averaging at the standard eps ~ dim^-1/4 and let the
            # stage-2 warmup adapt from there.
            repl["step_size"] = float(x_end.shape[1]) ** -0.25
        wjob = dataclasses.replace(
            self,
            target=whiten_target(self.target, chol),
            **repl,
        )
        y0 = jax.scipy.linalg.solve_triangular(chol, x_end.T, lower=True).T
        key2 = jax.random.fold_in(key, 0x9EC0)
        if warm_stage2:
            # The Cholesky factor is baked into the whitened program as a
            # closure constant, so stage 2 compiles fresh per call (a new
            # L is a new program).  For timing studies, warm the whitened
            # programs with the SAME L first so the timed pass measures
            # the device, not trace+compile.
            warm, _ = wjob.run_phased(key2, y0)
            jax.block_until_ready(warm.final_state)
            # free the warm trace BEFORE the timed pass allocates its
            # own — two full (n_post, n_chains, D) buffers alive at once
            # OOM long windows that individually fit
            del warm
            key2 = jax.random.fold_in(key2, 1)
        chain, t2 = wjob.run_phased(key2, y0)

        # back-transform the trace to x-space: x = L y.  The einsum
        # materialises a second (n_post, n_chains, D) buffer alongside the
        # whitened trace; for long windows near the memory limit pass
        # ``back_transform=False`` and map chunks yourself (x = y @ L.T,
        # L in info['chol']) — e.g. per chain-chunk inside an ESS loop.
        if back_transform:
            x_trace = _back_transform(chain.samples["value"], chol)
            chain = dataclasses.replace(
                chain, samples=dict(chain.samples, value=x_trace)
            )
        timings = {
            "warmup_seconds": t1["warmup_seconds"]
            + t1["sampling_seconds"]
            + t2["warmup_seconds"],
            "sampling_seconds": t2["sampling_seconds"],
        }
        return chain, timings, {"chol": chol, "whitened_job": wjob}

    def _warmup_phase(self, key, x0):
        init_key, run_key = jax.random.split(key)
        states = self._init_states(init_key, x0)
        chain_keys = jax.random.split(run_key, self.n_chains)
        burnin = self.mcrange.burnin
        if burnin > 0:
            scan_body = self._scan_fn(chain_keys, adapt=True, save=False)
            (states, _), _ = jax.lax.scan(
                scan_body, (states, ({}, {})), jnp.arange(burnin)
            )
            if hasattr(states, "tune") and not self.sampler.self_tuning:
                states = states._replace(
                    tune=jax.vmap(self.tuner.finalize)(states.tune)
                )
        return states, chain_keys

    def _sampling_phase(self, states, chain_keys):
        example_info = self._example_info(states, chain_keys)
        if self.destination == "nstate":
            buffers = self._alloc_buffers(states, example_info)
        else:
            buffers = ({}, {})
        scan_body = self._scan_fn(chain_keys, adapt=False)
        (states, buffers), _ = jax.lax.scan(
            scan_body,
            (states, buffers),
            jnp.arange(self.mcrange.burnin, self.mcrange.n_steps),
        )
        samples, diags = buffers
        return Chain(samples=samples, diagnostics=diags, final_state=states)

    @property
    def _buffered_csv(self) -> bool:
        return self.destination == "csv" and self.stream_mode == "post"

    def _open_writer(self):
        if (
            self.destination == "csv"
            and self.stream_mode == "io_callback"
            and self._writer is None
        ):
            from klara_tpu.io.stream import StreamingWriter

            self._writer = StreamingWriter(
                self.filepath, flush=self.flush, sample_fields=set(self.monitor)
            )

    def _finish_output(self, chain: Chain) -> Chain:
        if self._writer is not None:
            jax.block_until_ready(chain.final_state)
            self._writer.close()
        elif self._buffered_csv:
            # post-run export: same directory layout/manifest as the
            # streaming path, no in-loop host callbacks (the in-memory
            # trace is also returned); appends, so resume() segments
            # accumulate like a true stream
            import numpy as np

            from klara_tpu.io.stream import StreamingWriter

            jax.block_until_ready(chain.final_state)
            fields = {
                k: np.asarray(v)
                for k, v in {**chain.samples, **chain.diagnostics}.items()
            }
            with StreamingWriter(
                self.filepath, sample_fields=set(self.monitor)
            ) as w:
                w.append_block(self.mcrange.n_post, fields)
        return chain

    # ------------------------------------------------------- univariate lift
    def _prepare_x0(self, key, x0):
        """Normalise the initial value; draw from the prior when omitted;
        auto-lift scalar positions to dim-1 vectors so EVERY sampler
        (including the vector-only AM/RAM/AMWG/slice/SMMALA) handles
        univariate targets — the reference's BasicContUnvParameter path
        (src/variables/parameters/BasicContUnvParameter.jl).  Traces are
        squeezed back to scalars on output."""
        from_prior = x0 is None
        if from_prior:
            draw_key, key = jax.random.split(key)
            x0 = jax.vmap(self.target.sample_prior)(
                jax.random.split(draw_key, self.n_chains)
            )
        x0 = jnp.asarray(x0)
        scalar = (
            x0.ndim == 0
            or (from_prior and x0.ndim == 1)  # per-chain scalar prior draws
            or (
                x0.ndim == 1
                and self.n_chains > 1
                and x0.shape[0] == self.n_chains
                and self.target.dim == 1
            )
        )
        if scalar:
            self._lift_target()
            x0 = x0[..., None]
        return key, x0

    def _shard_x0(self, x0):
        """Broadcast x0 to the chains axis and lay it out on the mesh
        (chains sharded, trailing dims replicated).  No-op without a mesh."""
        if self.mesh is None:
            return x0
        x0 = jnp.asarray(x0)
        if x0.ndim < 1 or x0.shape[0] != self.n_chains:
            x0 = jnp.broadcast_to(x0, (self.n_chains,) + x0.shape)
        sharding = NamedSharding(
            self.mesh, P(self.chains_axis, *([None] * (x0.ndim - 1)))
        )
        return jax.device_put(x0, sharding)

    def _example_info(self, states, chain_keys):
        """Zero-filled Info pytree with the step kernel's output structure,
        discovered via eval_shape (no compute traced into the program)."""
        infos_shape = jax.eval_shape(
            lambda s: jax.vmap(
                lambda k, st: self.sampler.step(k, st, self.target)
            )(chain_keys, s)[1],
            states,
        )
        return jax.tree.map(
            lambda sd: jnp.zeros(sd.shape, sd.dtype), infos_shape
        )

    def _lift_target(self):
        if getattr(self, "_lifted", False):
            return
        orig = self.target

        def wrap_scalar(f):
            return None if f is None else (lambda x, *a: f(x[0], *a))

        def wrap_grad(f):
            return (
                None
                if f is None
                else (lambda x, *a: jnp.reshape(f(x[0], *a), (1,)))
            )

        def wrap_vg(f):
            if f is None:
                return None

            def vg(x, *a):
                v, g = f(x[0], *a)
                return v, jnp.reshape(g, (1,))

            return vg

        self.target = dataclasses.replace(
            orig,
            logdensity_fn=wrap_scalar(orig.logdensity_fn),
            loglikelihood_fn=wrap_scalar(orig.loglikelihood_fn),
            logprior_fn=wrap_scalar(orig.logprior_fn),
            grad_fn=wrap_grad(orig.grad_fn),
            value_and_grad_fn=wrap_vg(orig.value_and_grad_fn),
            tensor_fn=None
            if orig.tensor_fn is None
            else (lambda x, *a: jnp.reshape(orig.tensor_fn(x[0], *a), (1, 1))),
            dtensor_fn=None
            if orig.dtensor_fn is None
            else (lambda x, *a: jnp.reshape(orig.dtensor_fn(x[0], *a), (1, 1, 1))),
            dim=1,
        )
        self._lifted = True

    def _squeeze(self, chain: Chain) -> Chain:
        """Drop the lifted trailing dim-1 axis from trace buffers so scalar
        targets yield scalar draw series (final_state stays lifted for
        resume)."""
        if not getattr(self, "_lifted", False):
            return chain

        def sq(d):
            return {
                k: (v[..., 0] if (v.ndim >= 3 and v.shape[-1] == 1) else v)
                for k, v in d.items()
            }

        return dataclasses.replace(
            chain, samples=sq(chain.samples), diagnostics=sq(chain.diagnostics)
        )

    def _checkin(self, x0):
        """Init-time validation — reference `checkin` + the per-sampler
        `@assert isfinite(logtarget)` guards (src/jobs/BasicMCJob.jl:246-277,
        src/samplers/HMC.jl:113-114): the initial value must be inside the
        target's support."""
        x0 = jnp.asarray(x0)
        probe = x0[0] if (x0.ndim > 1 and x0.shape[0] == self.n_chains) else x0
        lt0 = self.target.logdensity(probe)
        if not bool(jnp.isfinite(lt0)):
            raise ValueError(
                f"log-target not finite at the initial value "
                f"(logdensity={float(lt0)}): initial value out of support"
            )

    # convenient resume: continue sampling from a previous chain's final state
    def resume(self, key, chain: Chain) -> Chain:
        """Continue sampling from ``chain.final_state`` for another
        ``mcrange.n_steps`` steps (reference ``reset``/re-``run``,
        src/jobs/BasicMCJob.jl:187-201).  Re-applies mesh sharding to the
        restored state (it may come from a host-side checkpoint) and
        re-opens the csv writer if streaming."""
        self._open_writer()
        if self.mesh is not None:
            def reshard(x):
                x = jnp.asarray(x)
                if x.ndim >= 1 and x.shape[0] == self.n_chains:
                    spec = P(self.chains_axis, *([None] * (x.ndim - 1)))
                else:
                    spec = P(*([None] * x.ndim))
                return jax.device_put(x, NamedSharding(self.mesh, spec))

            chain = dataclasses.replace(
                chain, final_state=jax.tree.map(reshard, chain.final_state)
            )
        out = self._resume_run(key, chain)
        out = self._finish_output(out)
        return self._squeeze(out)

    def _resume_run(self, key, chain: Chain) -> Chain:
        def _resumed(states, chain_keys):
            example_info = self._example_info(states, chain_keys)
            if self.destination == "nstate" or self._buffered_csv:
                buffers = self._alloc_buffers(states, example_info)
            else:
                buffers = ({}, {})
            states2, buffers = self._drive(chain_keys, states, buffers)
            samples, diags = buffers
            return Chain(samples=samples, diagnostics=diags, final_state=states2)

        if self._resume_jit is None:
            self._resume_jit = jax.jit(_resumed)
        return self._resume_jit(
            chain.final_state, jax.random.split(key, self.n_chains)
        )


def run(jobs, key, x0s):
    """Run a sequence of jobs (reference `run(::Vector{MCJob})`,
    src/jobs/jobs.jl:212). Sequential by design — parallelism lives in the
    chains axis, not in job multiplicity."""
    keys = jax.random.split(key, len(jobs))
    return [job.run(k, x0) for job, k, x0 in zip(jobs, keys, x0s)]
