"""Target (log-density) abstraction.

This is the JAX replacement for the reference's central component,
``BasicContMuvParameter`` (reference: src/variables/parameters/
BasicContMuvParameter.jl:3-761) and its univariate/discrete twins.  The
reference wires 17 mutating closures (`logtarget!`, `gradlogtarget!`,
`uptogradlogtarget!`, ...) plus a forward/reverse AD auto-wiring layer
(reference: src/autodiff/*.jl).  In JAX the whole machinery collapses to a
pure scalar function ``logdensity_fn(x) -> float`` plus `jax.grad` /
`jax.value_and_grad` / `jax.hessian`:

    reference closure            ->  Target method
    ---------------------------------------------------------------
    logtarget!(state)            ->  target.logdensity(x)
    gradlogtarget!(state)        ->  target.grad(x)
    uptogradlogtarget!(state)    ->  target.logdensity_and_grad(x)
    tensorlogtarget!(state)      ->  target.tensor(x)          (= -Hessian)
    uptotensorlogtarget!(state)  ->  target.logdensity_grad_tensor(x)
    dtensorlogtarget!(state)     ->  target.dtensor(x)         (rank-3)
    loglikelihood!/logprior!     ->  target.loglikelihood / target.logprior
    setpdf!/logpdf(pdf, x)       ->  Target.from_distribution(dist)

Wiring rules mirror the reference:
  * logtarget = loglikelihood + logprior when both are given
    (reference: BasicContMuvParameter.jl:174-201);
  * logtarget = logpdf(distribution, x) when a distribution is given
    (reference: BasicContMuvParameter.jl:552-564);
  * missing derivatives are auto-filled from AD
    (reference: BasicContMuvParameter.jl:566-695) — here always available
    via jax.grad, with optional user-supplied analytical overrides.

The "tensor" is the negative Hessian of the log-target (the observed
Fisher information), as used by SMMALA (reference: src/samplers/SMMALA.jl).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp


Array = jax.Array
LogDensityFn = Callable[..., Array]


def _neg(fn):
    def wrapped(*args, **kwargs):
        return jax.tree.map(lambda t: -t, fn(*args, **kwargs))

    return wrapped


@dataclasses.dataclass(frozen=True)
class Target:
    """A (possibly unnormalised) log-density with derivative accessors.

    All methods are pure functions of the position ``x`` (an array or any
    pytree) and are safe to ``jit``/``vmap``/``grad``.  Construct via one
    of:

      * ``Target(logdensity_fn=f, dim=d)``
      * ``Target.from_loglik_logprior(ll, lp, dim=d)``
      * ``Target.from_distribution(dist, dim=d)`` where ``dist`` has a
        ``logpdf`` method (see klara_tpu.distributions).

    Analytical derivative overrides (``grad_fn``, ``tensor_fn``,
    ``dtensor_fn``) replace the AD defaults when provided — the analogue of
    the reference's hand-written gradient path
    (e.g. doc/examples/swiss/MALA/analytical.jl).
    """

    logdensity_fn: LogDensityFn
    dim: Optional[int] = None
    loglikelihood_fn: Optional[LogDensityFn] = None
    logprior_fn: Optional[LogDensityFn] = None
    # prior distribution object (klara_tpu.distributions API: logpdf +
    # sample) used to draw initial values when the job is run without an
    # explicit x0 — reference draws NaN-initialised values from the
    # parameter's pdf/prior (src/jobs/BasicMCJob.jl:59-67)
    prior: Optional[Any] = None
    grad_fn: Optional[Callable] = None
    # fused value+gradient (e.g. a hand-derived batched program); overrides the
    # grad_fn / value_and_grad default when present
    value_and_grad_fn: Optional[Callable] = None
    tensor_fn: Optional[Callable] = None
    dtensor_fn: Optional[Callable] = None
    # AD mode for the gradient default — the reference's
    # DiffOptions(mode=:reverse/:forward) (src/autodiff/autodiff.jl:55-76,
    # forward.jl / reverse.jl wrappers).  'reverse' = jax.grad (the right
    # choice for scalar log-densities); 'forward' = jax.jacfwd, matching
    # the reference's ForwardDiff path (and its univariate parameters,
    # which are forward-mode only, BasicContUnvParameter.jl:454-455).
    ad_mode: str = "reverse"
    name: str = "target"

    def __post_init__(self):
        if self.ad_mode not in ("reverse", "forward"):
            raise ValueError(
                f"ad_mode must be 'reverse' or 'forward', got {self.ad_mode!r}"
            )

    # ---------------------------------------------------------------- ctors
    @classmethod
    def from_loglik_logprior(
        cls,
        loglikelihood_fn: LogDensityFn,
        logprior_fn: LogDensityFn,
        dim: Optional[int] = None,
        **kwargs: Any,
    ) -> "Target":
        """Bayesian composition: logtarget = loglikelihood + logprior.

        Mirrors reference BasicContMuvParameter.jl:174-201.
        """

        def logdensity_fn(x, *args):
            return loglikelihood_fn(x, *args) + logprior_fn(x, *args)

        return cls(
            logdensity_fn=logdensity_fn,
            loglikelihood_fn=loglikelihood_fn,
            logprior_fn=logprior_fn,
            dim=dim,
            **kwargs,
        )

    @classmethod
    def from_distribution(cls, dist: Any, dim: Optional[int] = None, **kwargs) -> "Target":
        """Target backed by a distribution object exposing ``logpdf``.

        Mirrors reference BasicContMuvParameter.jl:552-564 (`setpdf`).
        """
        if dim is None:
            dim = getattr(dist, "dim", None)
        return cls(logdensity_fn=lambda x: jnp.sum(dist.logpdf(x)), dim=dim, **kwargs)

    # -------------------------------------------------------------- methods
    def logdensity(self, x, *args) -> Array:
        return self.logdensity_fn(x, *args)

    def loglikelihood(self, x, *args) -> Array:
        if self.loglikelihood_fn is None:
            raise ValueError("target has no loglikelihood decomposition")
        return self.loglikelihood_fn(x, *args)

    def logprior(self, x, *args) -> Array:
        if self.logprior_fn is not None:
            return self.logprior_fn(x, *args)
        if self.prior is not None:
            return jnp.sum(self.prior.logpdf(x))
        raise ValueError("target has no logprior decomposition")

    def sample_prior(self, key) -> Array:
        """Draw ONE position from the prior — used by jobs to initialise
        chains when no x0 is given (reference src/jobs/BasicMCJob.jl:59-67:
        `rand(pdf)` / `rand(prior)` for NaN-valued initial states)."""
        if self.prior is None:
            raise ValueError(
                "target has no `prior` distribution to draw initial values "
                "from; pass x0 explicitly or set Target(prior=...)"
            )
        # a multivariate prior's sample(key) already carries its event
        # shape (MvNormal -> (d,), Dirichlet -> (k,), ...); only a SCALAR
        # prior needs broadcasting to the target dimension
        probe = jax.eval_shape(lambda k: self.prior.sample(k), key)
        if probe.shape == () and self.dim is not None:
            # scalar (per-component iid) prior over a dim-D position
            return jnp.asarray(self.prior.sample(key, (self.dim,)))
        return jnp.asarray(self.prior.sample(key))

    def grad(self, x, *args) -> Array:
        """∇ log π(x) — reference `gradlogtarget!`."""
        if self.grad_fn is not None:
            return self.grad_fn(x, *args)
        if self.ad_mode == "forward":
            return jax.jacfwd(self.logdensity_fn)(x, *args)
        return jax.grad(self.logdensity_fn)(x, *args)

    # -- likelihood / prior derivative accessors ---------------------------
    # The reference's parameter state monitors all 13 target-related slots:
    # {log,gradlog,tensorlog,dtensorlog} × {likelihood,prior,target} + value
    # (src/nstates/ParameterNStates/BasicContMuvParameterNState.jl:89-119).
    # These accessors back the gradloglikelihood/gradlogprior/tensor*/
    # dtensor* monitored fields of MCJob.

    def _logprior_callable(self) -> LogDensityFn:
        if self.logprior_fn is not None:
            return self.logprior_fn
        if self.prior is not None:
            return lambda x, *args: jnp.sum(self.prior.logpdf(x))
        raise ValueError("target has no logprior decomposition")

    def _ad_grad(self, fn) -> Callable:
        return jax.jacfwd(fn) if self.ad_mode == "forward" else jax.grad(fn)

    def grad_loglikelihood(self, x, *args) -> Array:
        """∇ log L(x) — reference `gradloglikelihood!`."""
        if self.loglikelihood_fn is None:
            raise ValueError("target has no loglikelihood decomposition")
        return self._ad_grad(self.loglikelihood_fn)(x, *args)

    def grad_logprior(self, x, *args) -> Array:
        """∇ log p(x) — reference `gradlogprior!`."""
        return self._ad_grad(self._logprior_callable())(x, *args)

    def tensor_loglikelihood(self, x, *args) -> Array:
        """-Hessian of log L — reference `tensorloglikelihood!`."""
        if self.loglikelihood_fn is None:
            raise ValueError("target has no loglikelihood decomposition")
        return _neg(jax.hessian(self.loglikelihood_fn))(x, *args)

    def tensor_logprior(self, x, *args) -> Array:
        """-Hessian of log p — reference `tensorlogprior!`."""
        return _neg(jax.hessian(self._logprior_callable()))(x, *args)

    def dtensor_loglikelihood(self, x, *args) -> Array:
        """Rank-3 derivative of the likelihood tensor —
        reference `dtensorloglikelihood!`."""
        return jax.jacfwd(self.tensor_loglikelihood)(x, *args)

    def dtensor_logprior(self, x, *args) -> Array:
        """Rank-3 derivative of the prior tensor —
        reference `dtensorlogprior!`."""
        return jax.jacfwd(self.tensor_logprior)(x, *args)

    def logdensity_and_grad(self, x, *args):
        """Fused value+gradient — reference `uptogradlogtarget!`
        (BasicContMuvParameter.jl:263-323)."""
        if self.value_and_grad_fn is not None:
            return self.value_and_grad_fn(x, *args)
        if self.grad_fn is not None:
            return self.logdensity_fn(x, *args), self.grad_fn(x, *args)
        if self.ad_mode == "forward":
            return (
                self.logdensity_fn(x, *args),
                jax.jacfwd(self.logdensity_fn)(x, *args),
            )
        return jax.value_and_grad(self.logdensity_fn)(x, *args)

    def tensor(self, x, *args) -> Array:
        """Metric tensor G(x) = -Hessian of log-target (observed Fisher).

        Reference `tensorlogtarget!`; consumed by SMMALA
        (src/samplers/iterate/SMMALA.jl:112-119).
        """
        if self.tensor_fn is not None:
            return self.tensor_fn(x, *args)
        return _neg(jax.hessian(self.logdensity_fn))(x, *args)

    def logdensity_grad_tensor(self, x, *args):
        """Fused value+grad+tensor — reference `uptotensorlogtarget!`."""
        if self.tensor_fn is not None and self.grad_fn is not None:
            return (
                self.logdensity_fn(x, *args),
                self.grad_fn(x, *args),
                self.tensor_fn(x, *args),
            )
        value, grad = self.logdensity_and_grad(x, *args)
        return value, grad, self.tensor(x, *args)

    def dtensor(self, x, *args) -> Array:
        """Rank-3 derivative of the metric tensor — reference
        `dtensorlogtarget!` (needed only by full-manifold MMALA variants).
        """
        if self.dtensor_fn is not None:
            return self.dtensor_fn(x, *args)
        return jax.jacfwd(self.tensor)(x, *args)

    # ------------------------------------------------------------- helpers
    def with_name(self, name: str) -> "Target":
        return dataclasses.replace(self, name=name)


def bounded_target(target: Target, lower=None, upper=None) -> Target:
    """Wrap a target so positions outside [lower, upper] get -inf density.

    The reference enforces support via `check_support`
    (src/variables/parameters/parameters.jl:24-32) and truncation bounds in
    AMWG (src/samplers/AMWG.jl:139-151).  In JAX we fold the indicator into
    the log-density; samplers then reject automatically.
    """
    lo = -jnp.inf if lower is None else lower
    hi = jnp.inf if upper is None else upper

    def logdensity_fn(x, *args):
        raw = target.logdensity_fn(x, *args)
        ok = jnp.all(jnp.asarray(x) >= lo) & jnp.all(jnp.asarray(x) <= hi)
        return jnp.where(ok, raw, -jnp.inf)

    return dataclasses.replace(target, logdensity_fn=logdensity_fn)


def whiten_target(target: Target, chol) -> Target:
    """Reparameterise ``target`` by x = L y (L = ``chol``, lower-triangular).

    The workhorse of dense ensemble preconditioning
    (:meth:`klara_tpu.MCJob.run_preconditioned`): running any sampler on
    the whitened target with identity/diagonal mass is equivalent to
    running on ``target`` with dense mass matrix M = (L Lᵀ)⁻¹ — the
    many-chain route to a dense metric, because it needs only two extra
    (D, D) matvecs per gradient evaluation (no per-chain matrix state).

    logp_y(y) = logp_x(L y) (+ const Jacobian), grad_y = Lᵀ grad_x; the
    fused ``value_and_grad_fn`` path of the inner target (e.g. the
    batched logreg kernel) still dispatches under vmap.
    """
    chol = jnp.asarray(chol)

    def logdensity_fn(y, *args):
        return target.logdensity(chol @ y, *args)

    def value_and_grad_fn(y, *args):
        v, g = target.logdensity_and_grad(chol @ y, *args)
        return v, chol.T @ g

    # preserve the Bayesian decomposition and the analytic tensor, both
    # re-expressed in y (chain rule: grad_y = Lᵀ g, H_y = Lᵀ H_x L);
    # dtensor_fn (rank-3) and grad_fn are intentionally dropped — the
    # fused value_and_grad above covers the gradient path, and no
    # whitened-space consumer of dtensor exists
    loglik = (
        (lambda y, *a: target.loglikelihood_fn(chol @ y, *a))
        if target.loglikelihood_fn is not None
        else None
    )
    logprior = (
        (lambda y, *a: target.logprior_fn(chol @ y, *a))
        if target.logprior_fn is not None
        else None
    )
    tensor = (
        (lambda y, *a: chol.T @ target.tensor_fn(chol @ y, *a) @ chol)
        if target.tensor_fn is not None
        else None
    )
    prior = (
        _WhitenedPrior(target.prior, chol) if target.prior is not None else None
    )

    return Target(
        logdensity_fn=logdensity_fn,
        dim=target.dim,
        loglikelihood_fn=loglik,
        logprior_fn=logprior,
        prior=prior,
        value_and_grad_fn=value_and_grad_fn,
        tensor_fn=tensor,
        ad_mode=target.ad_mode,
        name=f"{target.name}_whitened",
    )


class _WhitenedPrior:
    """x-space prior seen through y = L⁻¹x: draws whiten the base draw;
    logpdf differs from the x-space one only by the constant log|det L|
    (irrelevant for init draws and MH ratios)."""

    def __init__(self, base, chol):
        self.base = base
        self.chol = chol

    def sample(self, key, shape=None):
        if shape is None:
            x = self.base.sample(key)
            if jnp.ndim(x) == 0:
                # scalar (per-component iid) base prior: draw the full
                # (dim,) iid vector — matching Target.sample_prior's
                # scalar-prior branch — so solve_triangular gets a 1-d b
                # (a 0-d draw would raise inside sample_prior's
                # eval_shape probe before that branch is reached)
                x = self.base.sample(key, (self.chol.shape[0],))
        else:
            x = self.base.sample(key, shape)
        return jax.scipy.linalg.solve_triangular(
            self.chol, jnp.asarray(x, self.chol.dtype), lower=True
        )

    def logpdf(self, y):
        return self.base.logpdf(self.chol @ y)
