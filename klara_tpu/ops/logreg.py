"""Batched logistic-regression log-density + gradient as one XLA program.

The hot op of the north-star benchmark (BASELINE.json: HMC on 100-dim
logistic regression).  Per leapfrog step, every chain c needs

    value_c = Σ_n (y_n z_cn − softplus(z_cn)) − ‖p_c‖²/(2λ) − ½d·log(2πλ)
    grad_c  = Xᵀ(y − σ(z_c)) − p_c/λ,        z_c = X p_c

``_xla_value_grad_batched`` computes both for a (C, D) batch of positions
with two matmuls over the (C, N) logits; ``make_logreg_target`` wraps it in
`jax.custom_batching.custom_vmap`, so the SAME per-chain
``target.logdensity_and_grad`` used by every sampler dispatches under the
job driver's `vmap` to the batched program — samplers need no changes.

Both likelihood terms read the same logits z, not p·(Xᵀy): when the
logits matmul rounds p (TF32 on a GPU at 'default'/'high' precision), the
rounding then cancels between them, while the p·(Xᵀy) form leaves an O(1)
value error that drives HMC's dual averaging toward ε = 0 (measured with
the same formula in ``parallel/param_shard.py``).  Where the time goes on the H100 is not measured yet: whether XLA
fuses the sigmoid into the second matmul, or the (C, N) logits make a
round trip through device memory, decides whether a hand-written kernel
could pay (ROADMAP A2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _xla_value_grad_batched(P, X, y, prior_var):
    """(C, D) positions -> value (C,), grad (C, D)."""
    lam = jnp.asarray(prior_var, P.dtype)
    D = P.shape[-1]
    logits = P @ X.T                      # (C, N)
    const = 0.5 * D * jnp.log(2.0 * jnp.pi * lam)
    value = (
        jnp.sum(logits * y - jax.nn.softplus(logits), axis=-1)
        - 0.5 * jnp.sum(P * P, axis=-1) / lam
        - const
    )
    grad = (y - jax.nn.sigmoid(logits)) @ X - P / lam
    return value, grad


def make_logreg_target(X, y, prior_var: float = 100.0):
    """Build a logistic-regression Target whose per-chain
    ``logdensity_and_grad`` dispatches to the hand-derived batched
    value+grad under `vmap` (via custom_vmap) — one batched program
    instead of vmapping AD.  Drop-in replacement for
    klara_tpu.models.examples.logistic_regression_target."""
    from klara_tpu.core.target import Target

    X = jnp.asarray(X, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    D = X.shape[1]
    lam = float(prior_var)

    def logdensity(p):
        logits = X @ p
        const = 0.5 * D * jnp.log(2.0 * jnp.pi * jnp.asarray(lam, p.dtype))
        return (
            jnp.dot(logits, y)
            - jnp.sum(jax.nn.softplus(logits))
            - 0.5 * jnp.dot(p, p) / lam
            - const
        )

    @jax.custom_batching.custom_vmap
    def value_and_grad_one(p):
        value, grad = _xla_value_grad_batched(p[None, :], X, y, lam)
        return value[0], grad[0]

    @value_and_grad_one.def_vmap
    def _rule(axis_size, in_batched, P):
        assert in_batched[0]
        value, grad = _xla_value_grad_batched(P, X, y, lam)
        return (value, grad), (True, True)

    return Target(
        logdensity_fn=logdensity,
        dim=D,
        value_and_grad_fn=value_and_grad_one,
        name="logreg_xla",
    )
