"""Recursive empirical covariance (rank-1 updates).

Reference: src/stats/covariance.jl:3-19 — scalar recursion and the
BLAS.ger! matrix form feeding the AM sampler:

    C_k = ((k-1)·C_{k-1} + x xᵀ − (k+1)·m̄ m̄ᵀ + k·m̄₂ m̄₂ᵀ) / k

where m̄ is the running mean after x and m̄₂ the one before.  The three
rank-1 updates fuse into a handful of elementwise ops (outer products).
"""

from __future__ import annotations

import jax.numpy as jnp


def recursive_covariance(last_cov, k, x, lastmean, secondlastmean):
    """Matrix (or scalar) recursive covariance update; k >= 1."""
    x = jnp.asarray(x)
    kf = jnp.asarray(k, x.dtype)
    if x.ndim == 0:
        return (
            (kf - 1.0) * last_cov
            + jnp.square(x)
            - (kf + 1.0) * jnp.square(lastmean)
            + kf * jnp.square(secondlastmean)
        ) / kf
    return (
        (kf - 1.0) * last_cov
        + jnp.outer(x, x)
        - (kf + 1.0) * jnp.outer(lastmean, lastmean)
        + kf * jnp.outer(secondlastmean, secondlastmean)
    ) / kf
