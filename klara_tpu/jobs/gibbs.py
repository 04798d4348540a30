"""GibbsJob: block-sweep simulation over a model graph.

Reference: src/jobs/BasicGibbsJob.jl:3-359.  The reference's sweep
(`iterate!`, lines 185-199) visits each dependent variable IN ORDER and

  (a) runs a nested BasicMCJob for parameters with an MCMC spec
      (MCMC-within-Gibbs, lines 188-190),
  (b) re-evaluates the full-conditional distribution against the CURRENT
      values and draws from it (`setpdf!` + rand, lines 192-193), or
  (c) applies a deterministic transformation (line 196),

with nested jobs reset between sweeps, optionally re-drawing their start
from the prior (``resetpstate``, lines 158-168).  Each variable carries
its own output options (destination / diagnostics / csv streaming,
lines 57-65 and 170-183).

Design: the sweep is irreducibly sequential across blocks
(SURVEY.md §3.4), so blocks are unrolled in Python inside ONE compiled
step function; `lax.scan` drives sweeps and `vmap` runs thousands of
independent Gibbs chains in lockstep, mesh-shardable over the
'chains' axis exactly like MCJob.  Nested MCMC blocks re-initialise the
sampler state each sweep (the reference's `reset`) — from the current
value, or from a fresh prior draw when ``reset_from_prior`` — and run
``n_steps`` kernel steps inside the sweep, with their tuner adapting
during the first ``burnin`` of those steps.  Per-block mean acceptance is
recorded as a diagnostics channel so MCMC-within-Gibbs mixing is
observable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from klara_tpu.core.target import Target
from klara_tpu.jobs.range import MCRange
from klara_tpu.models.graph import Data, GenericModel, GibbsParameter, Transformation
from klara_tpu.samplers.base import Sampler
from klara_tpu.tuners.tuners import Tuner


@dataclasses.dataclass(frozen=True)
class Nested:
    """MCMC-within-Gibbs block spec (reference dpjob BasicMCJob entries,
    src/jobs/BasicGibbsJob.jl:188-190).

    ``n_steps`` kernel steps run on the block's conditional each sweep;
    the tuner (if any) adapts during the first ``burnin`` of them — the
    nested job's own range (reference nested BasicMCJob ranges).  With
    ``reset_from_prior`` the nested start is re-drawn from the
    parameter's ``setprior`` conditional each sweep instead of continuing
    from the current value (reference ``resetpstate``,
    BasicGibbsJob.jl:158-168)."""

    sampler: Sampler
    n_steps: int = 1
    step_size: Optional[float] = None
    burnin: int = 0
    tuner: Optional[Tuner] = None
    reset_from_prior: bool = False


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GibbsChains:
    """Per-variable draws: samples[key] has shape (n_post, n_chains, ...).

    ``diagnostics`` holds per-sweep channels — '<key>.accept' is the mean
    acceptance of nested MCMC block <key> (reference per-variable
    diagnostics, BasicGibbsJob.jl:170-183)."""

    samples: Dict[str, jax.Array]
    final_values: Dict[str, jax.Array]
    diagnostics: Dict[str, jax.Array] = dataclasses.field(default_factory=dict)

    def __getitem__(self, key):
        if key in self.samples:
            return self.samples[key]
        return self.diagnostics[key]

    def flat(self, key):
        arr = self[key]
        return arr.reshape((-1,) + arr.shape[2:])


def _default_outopts():
    return {"destination": "nstate", "filepath": None, "flush": False}


@dataclasses.dataclass
class GibbsJob:
    """Gibbs sweep driver over a GenericModel.

    Parameters
    ----------
    model : GenericModel
    sweep : {param_key: Nested(...)} for MCMC-within-Gibbs blocks; params
        absent from the dict use their full-conditional ``setpdf`` draw
        (reference's dpjob Dict, BasicGibbsJob.jl:77-148).
    mcrange : MCRange
    n_chains : chains axis (vmapped, mesh-shardable)
    monitor : which dependent variables to record (default: all)
    outopts : per-variable output options (reference BasicGibbsJob.jl:57-65):
        {key: {'destination': 'nstate'|'csv'|'none', 'filepath': ..., 'flush': ...}}.
        Variables not listed use destination='nstate'.  'csv' streams the
        variable's draws during the run via io_callback (one directory per
        variable); 'none' drops the trace (final value still returned).
    record_diagnostics : record '<key>.accept' mean-acceptance channels
        for nested MCMC blocks.
    """

    model: GenericModel
    sweep: Dict[str, Nested] = dataclasses.field(default_factory=dict)
    mcrange: MCRange = dataclasses.field(default_factory=MCRange)
    n_chains: int = 1
    monitor: Optional[Sequence[str]] = None
    outopts: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    record_diagnostics: bool = True
    mesh: Optional[Mesh] = None
    chains_axis: str = "chains"
    # csv streaming flushes once per `stream_chunk` sweeps (cf. MCJob)
    stream_chunk: int = 128
    # Hoist nested HMC/NUTS blocks' Alg-4 step-size search out of the
    # sweep scan: run it ONCE per run against the INITIAL conditionals
    # and seed every sweep's dual-averaging tuner from that value (the
    # tuner still adapts within each sweep's burnin).  Set False — or
    # pass an explicit Nested.step_size — when a block's conditional
    # scale moves far from its init-time geometry over the run (e.g. a
    # variance hyperparameter travelling orders of magnitude), where a
    # stale seed can leave the nested tuner a long way from a workable
    # step.  The reference's nested-job reset performs no per-sweep
    # search either (BasicGibbsJob.jl:158-168).
    hoist_step_search: bool = True
    # Storage dtype for the device trace buffers (cf. MCJob.trace_dtype):
    # None keeps each variable's compute dtype; 'bfloat16' halves the
    # trace memory so sweep windows twice as long fit on the device.  Only
    # floating-point variables are cast; the sweep kernel itself is
    # untouched (only the saved copy rounds).
    trace_dtype: Optional[str] = None

    def __post_init__(self):
        self._dependents = self.model.dependents
        # Data vertices with an update hook are refreshed at the start of
        # every sweep (reference variables.jl:84-92) and therefore live in
        # the scan carry rather than the closure constants
        self._updatable = [
            v
            for v in self.model.vertices
            if isinstance(v, Data) and v.update is not None
        ]
        if self.monitor is None:
            self.monitor = [v.key for v in self._dependents]
        # specialise nested samplers to their tuners (e.g. HMC fixed
        # trajectory length under dual averaging), same as MCJob
        self.sweep = {
            k: (
                dataclasses.replace(spec, sampler=spec.sampler.bind_tuner(spec.tuner))
                if spec.tuner is not None
                else spec
            )
            for k, spec in self.sweep.items()
        }
        for key in self.sweep:
            if key not in self.model:
                raise ValueError(f"sweep references unknown variable {key!r}")
        for key, spec in self.sweep.items():
            if spec.reset_from_prior and self.model[key].setprior is None:
                raise ValueError(
                    f"Nested(reset_from_prior=True) on {key!r} requires the "
                    "parameter to define setprior"
                )
        self._opts = {}
        for key in self.monitor:
            opts = dict(_default_outopts())
            opts.update(self.outopts.get(key, {}))
            if opts["destination"] not in ("nstate", "csv", "none"):
                raise ValueError(
                    f"unknown destination {opts['destination']!r} for {key!r}"
                )
            if opts["destination"] == "csv" and not opts.get("filepath"):
                raise ValueError(f"destination='csv' for {key!r} requires filepath")
            self._opts[key] = opts
        unknown = set(self.outopts) - set(self.monitor)
        if unknown:
            raise ValueError(f"outopts for unmonitored variables: {sorted(unknown)}")
        if self.trace_dtype is not None:
            jnp.dtype(self.trace_dtype)  # fail fast on a typo'd dtype
        self._writers = {}
        self._run_jit = jax.jit(self._run, static_argnames=("prebatched",))

    # ---------------------------------------------------------------- sweep
    def _needs_step_hoist(self, spec: Nested) -> bool:
        """True when ``spec.sampler.init`` would embed the Alg-4
        find_reasonable_step_size while_loop: HMC/NUTS under dual
        averaging with no explicit step size.  Re-running that search
        every sweep inside the compiled scan is pure hot-loop waste — the
        reference's nested-job reset (BasicGibbsJob.jl:158-168) performs
        no such search — so GibbsJob hoists it to once per run."""
        import os

        from klara_tpu.samplers.hmc import HMC
        from klara_tpu.samplers.nuts import NUTS
        from klara_tpu.tuners.tuners import DualAveragingTuner

        if not self.hoist_step_search:
            return False
        if os.environ.get("KLARA_GIBBS_NO_HOIST"):  # probe escape hatch
            return False
        return (
            spec.step_size is None
            and isinstance(spec.sampler, (HMC, NUTS))
            and isinstance(spec.tuner, DualAveragingTuner)
        )

    def _hoist_step_sizes(self, chain_key, values: Dict[str, Any]):
        """Per-chain reasonable step sizes for nested blocks, computed
        ONCE per run against the initial conditionals (outside the sweep
        scan) and reused by every sweep's ``init``."""
        from klara_tpu.samplers.hamiltonian import find_reasonable_step_size

        out = {}
        for idx, (hk, spec) in enumerate(sorted(self.sweep.items())):
            if not self._needs_step_hoist(spec):
                continue
            var = self.model[hk]
            frozen = dict(values)
            target = Target(
                logdensity_fn=lambda x, _v=var, _f=frozen: _v.conditional_logdensity(x, _f)
            )
            k = jax.random.fold_in(jax.random.fold_in(chain_key, 0x5EED), idx)
            out[hk] = find_reasonable_step_size(k, target, values[hk])
        return out

    def _block_update(self, var, values: Dict[str, Any], key, hoisted):
        """One block of the sweep — returns (new value, diag dict)."""
        if isinstance(var, Transformation):
            return var.transform(values), {}

        assert isinstance(var, GibbsParameter)
        if var.key in self.sweep:
            spec = self.sweep[var.key]
            key, k_init = jax.random.split(key)
            x0 = values[var.key]
            if spec.reset_from_prior:
                # redraw the nested start from the prior conditional
                # (reference resetpstate, BasicGibbsJob.jl:158-168)
                key, k_prior = jax.random.split(key)
                draw = var.setprior(values).sample(k_prior)
                x0 = jnp.asarray(draw, jnp.asarray(x0).dtype).reshape(jnp.shape(x0))
            # conditional target given the CURRENT values of all others
            frozen = dict(values)
            target = Target(
                logdensity_fn=lambda x: var.conditional_logdensity(x, frozen)
            )
            step_size = spec.step_size
            if step_size is None and var.key in hoisted:
                step_size = hoisted[var.key]  # once-per-run Alg-4 result
            state = spec.sampler.init(
                k_init, target, x0, step_size=step_size, tuner=spec.tuner
            )

            def body(i, carry):
                state, key, acc = carry
                key, sub = jax.random.split(key)
                state, info = spec.sampler.step(sub, state, target)
                if spec.tuner is not None and not spec.sampler.self_tuning:
                    stat = (
                        info.accept_stat
                        if spec.sampler.tuner_statistic == "accept_stat"
                        else info.accept.astype(jnp.float32)
                    )
                    new_tune = spec.tuner.update(
                        state.tune,
                        info.accept.astype(jnp.float32),
                        stat,
                        spec.burnin,
                    )
                    state = state._replace(tune=new_tune)
                acc = acc + jnp.asarray(info.accept, jnp.float32)
                return (state, key, acc)

            state, _, acc = jax.lax.fori_loop(
                0, spec.n_steps, body, (state, key, jnp.float32(0.0))
            )
            diag = {f"{var.key}.accept": acc / spec.n_steps}
            return state.position, diag

        if var.setpdf is None:
            raise ValueError(
                f"parameter {var.key!r} needs either a setpdf full conditional "
                "or a Nested sweep entry"
            )
        dist = var.setpdf(values)
        draw = dist.sample(key)
        new = jnp.asarray(draw, jnp.asarray(values[var.key]).dtype).reshape(
            jnp.shape(values[var.key])
        )
        return new, {}

    def _sweep_fn(self, chain_key, values, i, hoisted):
        """One full sweep; returns (updated carried values, diagnostics)."""
        diags = {}
        values = dict(values)
        for u in self._updatable:  # Data.update hooks fire before any block
            values[u.key] = u.update(values)
        for b, var in enumerate(self._dependents):
            block_key = jax.random.fold_in(
                jax.random.fold_in(chain_key, i), b
            )
            values = dict(values)
            values[var.key], d = self._block_update(
                var, values, block_key, hoisted
            )
            diags.update(d)
        return {k: values[k] for k in self._carry_keys()}, diags

    def _carry_keys(self):
        return [u.key for u in self._updatable] + [v.key for v in self._dependents]

    # ------------------------------------------------------------------ run
    def _run(self, key, v0: Dict[str, Any], prebatched: bool = False):
        burnin, thinning = self.mcrange.burnin, self.mcrange.thinning
        n_post = self.mcrange.n_post
        chain_keys = jax.random.split(key, self.n_chains)

        # dependent (and updatable-data) values are per-chain; other
        # constants/data stay unbatched closure constants
        dep_keys = [v.key for v in self._dependents]
        carry_keys = self._carry_keys()
        static_vals = {
            k: jnp.asarray(v) for k, v in v0.items() if k not in carry_keys
        }

        def batch(x):
            x = jnp.asarray(x)
            if prebatched:  # resume path: values already (n_chains, ...)
                return x
            return jnp.broadcast_to(x, (self.n_chains,) + x.shape)

        values0 = {k: batch(v0[k]) for k in carry_keys}

        nstate_keys = [
            k for k in self.monitor if self._opts[k]["destination"] == "nstate"
        ]
        csv_keys = [k for k in self.monitor if self._opts[k]["destination"] == "csv"]
        diag_keys = (
            [f"{k}.accept" for k in self.sweep if k in dep_keys]
            if self.record_diagnostics
            else []
        )

        tdt = jnp.dtype(self.trace_dtype) if self.trace_dtype else None

        def _buf_dtype(v):
            dt = jnp.asarray(v).dtype
            if tdt is not None and jnp.issubdtype(dt, jnp.floating):
                return tdt
            return dt

        buffers = {
            k: jnp.zeros((n_post,) + values0[k].shape, _buf_dtype(values0[k]))
            for k in nstate_keys
        }
        diag_buffers = {
            k: jnp.zeros((n_post, self.n_chains), jnp.float32) for k in diag_keys
        }

        # nested-block Alg-4 step-size searches run ONCE per run, here,
        # outside the sweep scan (hoisted out of the hot loop)
        hoisted0 = jax.vmap(
            lambda ck, dyn: self._hoist_step_sizes(ck, {**static_vals, **dyn})
        )(chain_keys, values0)

        def scan_body(carry, i):
            values, buffers, diag_buffers = carry
            values, diags = jax.vmap(
                lambda ck, dyn, hs: self._sweep_fn(
                    ck, {**static_vals, **dyn}, i, hs
                )
            )(chain_keys, values, hoisted0)

            save_idx = (i - burnin) // thinning
            do_save = (i >= burnin) & ((i - burnin) % thinning == 0)

            def write(bufs):
                vb, db = bufs
                vb = {
                    k: jax.lax.dynamic_update_index_in_dim(
                        buf, values[k].astype(buf.dtype), save_idx, 0
                    )
                    for k, buf in vb.items()
                }
                db = {
                    k: jax.lax.dynamic_update_index_in_dim(
                        buf, diags[k].astype(buf.dtype), save_idx, 0
                    )
                    for k, buf in db.items()
                }
                return vb, db

            buffers, diag_buffers = jax.lax.cond(
                do_save, write, lambda b: b, (buffers, diag_buffers)
            )
            if not csv_keys:
                return (values, buffers, diag_buffers), None
            return (values, buffers, diag_buffers), (
                do_save,
                {k: values[k] for k in csv_keys},
            )

        n_steps = self.mcrange.n_steps
        if not csv_keys:
            (values, buffers, diag_buffers), _ = jax.lax.scan(
                scan_body, (values0, buffers, diag_buffers), jnp.arange(n_steps)
            )
        else:
            # chunked host flush: saved sweeps accumulate in a device ring
            # buffer; ONE ordered io_callback per stream_chunk sweeps per
            # variable (cf. MCJob._drive — every round-trip stalls the
            # device)
            from jax.experimental import io_callback

            chunk = max(1, min(self.stream_chunk, n_steps))
            n_outer = -(-n_steps // chunk)
            sbufs = {
                k: jnp.zeros((chunk,) + values0[k].shape, values0[k].dtype)
                for k in csv_keys
            }

            def outer_body(carry, o):
                values, buffers, diag_buffers, sbufs = carry

                def inner(j, c):
                    values, buffers, diag_buffers, sbufs, count = c
                    i = o * chunk + j
                    valid = i < n_steps
                    new_carry, (do_save, fields) = scan_body(
                        (values, buffers, diag_buffers), i
                    )
                    # padding steps (i >= n_steps) must leave values AND the
                    # device trace buffers untouched (outopts may mix
                    # nstate- and csv-destination variables)
                    values, buffers, diag_buffers = jax.lax.cond(
                        valid,
                        lambda n, _: n,
                        lambda _, o: o,
                        new_carry,
                        (values, buffers, diag_buffers),
                    )
                    do_save = do_save & valid
                    sbufs = {
                        k: jax.lax.dynamic_update_index_in_dim(
                            buf, fields[k].astype(buf.dtype), count, 0
                        )
                        for k, buf in sbufs.items()
                    }
                    return values, buffers, diag_buffers, sbufs, count + do_save.astype(jnp.int32)

                values, buffers, diag_buffers, sbufs, count = jax.lax.fori_loop(
                    0, chunk, inner, (values, buffers, diag_buffers, sbufs, jnp.int32(0))
                )
                for k in csv_keys:
                    io_callback(
                        self._writers[k].append_block,
                        jax.ShapeDtypeStruct((), jnp.int32),
                        count,
                        {k: sbufs[k]},
                        ordered=True,
                    )
                return (values, buffers, diag_buffers, sbufs), None

            (values, buffers, diag_buffers, _), _ = jax.lax.scan(
                outer_body, (values0, buffers, diag_buffers, sbufs), jnp.arange(n_outer)
            )
        return GibbsChains(
            samples=buffers, final_values=values, diagnostics=diag_buffers
        )

    def run(self, key, v0: Dict[str, Any]) -> GibbsChains:
        """Counterpart of reference run(::BasicGibbsJob)
        (BasicGibbsJob.jl:201-231)."""
        missing = [v.key for v in self.model.vertices if v.key not in v0]
        if missing:
            raise ValueError(f"v0 missing values for {missing}")
        self._open_writers()
        prebatched = False
        if self.mesh is not None:
            v0 = self._shard_carry(v0)
            prebatched = True
        out = self._run_jit(key, v0, prebatched=prebatched)
        self._close_writers(out)
        return out

    def _shard_carry(self, vals: Dict[str, Any]) -> Dict[str, Any]:
        """Batch the per-chain carry values and lay them out over the
        mesh's chains axis (GSPMD shards the whole sweep program from
        these input shardings — cf. MCJob.run)."""
        carry = set(self._carry_keys())
        out = {}
        for k, v in vals.items():
            if k not in carry:
                out[k] = v
                continue
            x = jnp.asarray(v)
            if x.ndim == 0 or x.shape[0] != self.n_chains:
                x = jnp.broadcast_to(x, (self.n_chains,) + x.shape)
            spec = P(self.chains_axis, *([None] * (x.ndim - 1)))
            out[k] = jax.device_put(x, NamedSharding(self.mesh, spec))
        return out

    def resume(self, key, chains: GibbsChains, v0: Dict[str, Any]) -> GibbsChains:
        """Continue sweeping from ``chains.final_values`` for another
        ``mcrange.n_steps`` sweeps (reference ``reset``/re-``run``,
        BasicGibbsJob.jl:150-168).  ``v0`` supplies the non-dependent
        values (hyperparameters/data), same as ``run``; dependent variables
        restart from their per-chain final values."""
        carry = self._carry_keys()
        merged = {k: v for k, v in v0.items() if k not in carry}
        merged.update({k: chains.final_values[k] for k in carry})
        missing = [v.key for v in self.model.vertices if v.key not in merged]
        if missing:
            raise ValueError(f"resume missing values for {missing}")
        self._open_writers()
        if self.mesh is not None:
            merged = self._shard_carry(merged)
        out = self._run_jit(key, merged, prebatched=True)
        self._close_writers(out)
        return out

    def _open_writers(self):
        for k, opts in self._opts.items():
            if opts["destination"] == "csv" and k not in self._writers:
                from klara_tpu.io.stream import StreamingWriter

                self._writers[k] = StreamingWriter(
                    opts["filepath"], flush=opts.get("flush", False), sample_fields={k}
                )

    def _close_writers(self, out):
        # close (flush + sidecars) but KEEP the writer objects: the cached
        # jit trace's io_callback closures captured them, so a later
        # run()/resume() must stream through the same instances (their
        # file handles lazily reopen in append mode)
        if self._writers:
            jax.block_until_ready(out.final_values)
            for w in self._writers.values():
                w.close()

    def to_dot(self) -> str:
        """Graphviz export of the job with per-variable update annotations
        (reference `job2dot`, BasicGibbsJob.jl:320-359):

          * dependent variables (parameters + transformations) get
            ``peripheries=2``;
          * monitored dependents (destination != 'none') get an
            underlined label;
          * MCMC-within-Gibbs blocks (a ``sweep`` entry) get
            ``style=diagonals`` — distinguishing them from
            conditional-distribution draws and transformations.
        """
        lines = ["digraph GibbsJob {"]
        for v in self.model.vertices:
            attrs = [f"shape={v.dotshape}"]
            if v.is_dependent:
                attrs.append("peripheries=2")
                opts = self._opts.get(v.key)
                if opts is not None and opts["destination"] != "none":
                    attrs.append(f'label=<<u>{v.key}</u>>')
                if isinstance(v, GibbsParameter) and v.key in self.sweep:
                    attrs.append("style=diagonals")
            lines.append(f'  "{v.key}" [{", ".join(attrs)}];')
        for s, t in self.model.edges:
            lines.append(f'  "{s}" -> "{t}";')
        lines.append("}")
        return "\n".join(lines)
