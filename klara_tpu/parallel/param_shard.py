"""Parameter-dimension sharding: scaling MCMC beyond data-parallel chains.

The reference handles dimensionality purely via dense in-process vectors
(src/states/ParameterStates/BasicContMuvParameterState.jl:62-97); the only
scaling axis it has is "run more jobs serially" (src/jobs/jobs.jl:212).
The chains axis (see klara_tpu.parallel.mesh) is the data-parallel
dimension; THIS module adds the second, tensor-parallel-style axis from
SURVEY.md §2.2/§5: for very large parameter dimension d, shard the
position/gradient vectors and the log-density's feature dimension over a
'param' mesh axis, following the scaling-book recipe — annotate shardings
with `with_sharding_constraint`, let GSPMD insert the collectives
(a psum over 'param' for each logit contraction).

Layout for the flagship logistic-regression family on a 2-D
``(chains, param)`` mesh:

    positions  (C, D)  -> P('chains', 'param')
    X          (N, D)  -> P(None,    'param')   (features co-sharded with D)
    logits     (C, N)  -> P('chains', None)      after psum over 'param'
    grad       (C, D)  -> P('chains', 'param')

Per leapfrog step the only cross-device traffic on the 'param' axis is
the (C_local, N) partial-logit reduce — everything else (softplus/σ,
Xᵀ(y − σ(Z)), prior terms) is local to the shard.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def mesh2d(
    n_chain_devices: Optional[int] = None,
    n_param_devices: int = 1,
    axes: Sequence[str] = ("chains", "param"),
) -> Mesh:
    """2-D device mesh: chains (data parallel) x param (tensor parallel).

    ``n_chain_devices=None`` uses all remaining devices after the param
    axis takes ``n_param_devices``."""
    devs = jax.devices()
    if n_chain_devices is None:
        n_chain_devices = len(devs) // n_param_devices
    n = n_chain_devices * n_param_devices
    if n > len(devs):
        raise ValueError(
            f"mesh {n_chain_devices}x{n_param_devices} needs {n} devices, "
            f"have {len(devs)}"
        )
    grid = np.array(devs[:n]).reshape(n_chain_devices, n_param_devices)
    return Mesh(grid, tuple(axes))


def param_sharded_logreg_target(
    X,
    y,
    mesh: Mesh,
    prior_var: float = 100.0,
    chains_axis: str = "chains",
    param_axis: str = "param",
):
    """Logistic-regression Target whose batched value+grad is GSPMD-sharded
    over a ``(chains, param)`` mesh.

    Same math as the main-path ``models.examples.logistic_regression_target``;
    the per-chain ``logdensity_and_grad`` dispatches under the job driver's
    `vmap` to one batched program annotated so XLA partitions the feature
    dimension across the 'param' mesh axis.  Use with
    ``MCJob(..., mesh=mesh)`` — the chains axis shards as usual.

    The likelihood is ``yᵀz − Σ softplus(z)`` of ONE logits array z, never
    ``pᵀ(Xᵀy) − Σ softplus(z)``: when a matmul rounds p (TF32 on a GPU at
    'default'/'high' precision), the rounding then cancels between the two
    terms as the log-density's own gradient does, whereas the
    precomputed-``Xᵀy`` form keeps an O(1) value error that no step size
    removes, and dual averaging drives ε toward zero.
    """
    from klara_tpu.core.target import Target

    X = jnp.asarray(X, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    N, D = X.shape
    lam = float(prior_var)

    n_param = mesh.shape[param_axis]
    if D % n_param != 0:
        raise ValueError(
            f"feature dimension D={D} is not divisible by the '{param_axis}' "
            f"mesh axis size {n_param}; pad X with zero columns to a multiple "
            f"of {n_param} (zero-padded features do not change the posterior "
            f"when the padded position coordinates start at 0 under a "
            f"Gaussian prior) or choose a mesh with n_param dividing D"
        )

    # features co-sharded with the parameter dimension, resident per-shard
    Xs = jax.device_put(X, NamedSharding(mesh, P(None, param_axis)))
    ys = jax.device_put(y, NamedSharding(mesh, P()))
    const = 0.5 * D * float(np.log(2.0 * np.pi * lam))

    def _constrain(t, *spec):
        return jax.lax.with_sharding_constraint(t, NamedSharding(mesh, P(*spec)))

    def _batched(Pm):  # (C, D) -> value (C,), grad (C, D)
        Pm = _constrain(Pm, chains_axis, param_axis)
        # contraction over the sharded D axis -> GSPMD inserts a psum
        # over 'param'; logits land P('chains', None)
        logits = _constrain(Pm @ Xs.T, chains_axis, None)
        value = (
            jnp.sum(logits * ys - jax.nn.softplus(logits), axis=-1)
            - 0.5 * jnp.sum(Pm * Pm, axis=-1) / lam
            - const
        )
        grad = (ys - jax.nn.sigmoid(logits)) @ Xs - Pm / lam
        return value, _constrain(grad, chains_axis, param_axis)

    def _one(p):  # unbatched (D,) — for init/checkin/stats paths
        # constrain only the param axis: a (D,) vector has no chains
        # dimension, and a 'chains' constraint on a length-1 leading dim
        # raises whenever that mesh axis has >1 devices
        p = _constrain(p, param_axis)
        logits = _constrain(Xs @ p, None)
        value = (
            jnp.sum(logits * ys - jax.nn.softplus(logits))
            - 0.5 * jnp.dot(p, p) / lam
            - const
        )
        grad = (ys - jax.nn.sigmoid(logits)) @ Xs - p / lam
        return value, _constrain(grad, param_axis)

    value_and_grad_one = jax.custom_batching.custom_vmap(_one)

    @value_and_grad_one.def_vmap
    def _rule(axis_size, in_batched, Pm):
        assert in_batched[0]
        value, grad = _batched(Pm)
        return (value, grad), (True, True)

    return Target(
        logdensity_fn=lambda p: _one(p)[0],
        dim=D,
        value_and_grad_fn=value_and_grad_one,
        name="logreg_param_sharded",
    )
