"""Batched logistic-regression value+grad (klara_tpu.ops.logreg).

Checks the hand-derived batched XLA program against jax.value_and_grad
of the scalar log-density — the reference's correctness oracle is the
analytical gradient in doc/examples/swiss/MALA/analytical.jl — and the
custom_vmap target against the main path's fused target
(models.examples.logistic_regression_target).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from klara_tpu.models.examples import logistic_regression_target
from klara_tpu.ops.logreg import _xla_value_grad_batched, make_logreg_target


def _problem(C=5, D=7, N=33, lam=10.0, seed=0):
    rng = np.random.default_rng(seed)
    P = jnp.asarray(rng.standard_normal((C, D)), jnp.float32) * 0.5
    X = jnp.asarray(rng.standard_normal((N, D)), jnp.float32)
    y = jnp.asarray((rng.random(N) < 0.5), jnp.float32)
    return P, X, y, lam


def _oracle(P, X, y, lam):
    D = X.shape[1]

    def logdensity(p):
        logits = X @ p
        return (
            jnp.dot(logits, y)
            - jnp.sum(jax.nn.softplus(logits))
            - 0.5 * jnp.dot(p, p) / lam
            - 0.5 * D * jnp.log(2.0 * jnp.pi * lam)
        )

    return jax.vmap(jax.value_and_grad(logdensity))(P)


def test_xla_fallback_matches_autodiff():
    P, X, y, lam = _problem()
    v_ref, g_ref = _oracle(P, X, y, lam)
    v, g = _xla_value_grad_batched(P, X, y, lam)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,D,N", [(1, 3, 20), (16, 100, 1024), (37, 9, 301)])
def test_batched_target_matches_main_path_target(C, D, N):
    """make_logreg_target's batched custom_vmap path against the main
    path's fused per-chain target, vmapped, both at 'highest'."""
    P, X, y, lam = _problem(C=C, D=D, N=N, seed=C)
    with jax.default_matmul_precision("highest"):
        v, g = jax.jit(jax.vmap(make_logreg_target(X, y, lam).logdensity_and_grad))(P)
        ref = logistic_regression_target(X, y, prior_var=lam)
        v_ref, g_ref = jax.jit(jax.vmap(ref.logdensity_and_grad))(P)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-5, atol=1e-4)


def test_make_logreg_target_dispatches_under_vmap():
    P, X, y, lam = _problem(C=4, D=3, N=20)
    target = make_logreg_target(X, y, prior_var=lam)
    # scalar path
    v0 = target.logdensity(P[0])
    v_ref, g_ref = _oracle(P, X, y, lam)
    np.testing.assert_allclose(float(v0), float(v_ref[0]), rtol=1e-5)
    # single-chain value_and_grad
    v1, g1 = target.logdensity_and_grad(P[0])
    np.testing.assert_allclose(float(v1), float(v_ref[0]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g_ref[0]), rtol=1e-5, atol=1e-6)
    # batched dispatch (the job driver's vmap)
    v, g = jax.vmap(target.logdensity_and_grad)(P)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-5, atol=1e-5)


def test_hmc_job_runs_on_fused_target():
    """End-to-end: the fused target drives an HMC job unchanged."""
    import klara_tpu as kt

    _, X, y, lam = _problem(C=1, D=3, N=50, seed=1)
    target = make_logreg_target(X, y, prior_var=lam)
    job = kt.MCJob(
        target,
        kt.HMC(leapstep=0.1, nleaps=5),
        kt.MCRange(n_steps=300, burnin=100),
        n_chains=8,
    )
    chain = job.run(jax.random.key(0), jnp.zeros(3))
    assert np.isfinite(np.asarray(chain.value)).all()
    assert float(kt.stats.acceptance(chain)) > 0.5
