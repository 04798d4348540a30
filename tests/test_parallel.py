"""Mesh-sharding tests on the virtual 8-device CPU platform.

The reference has no distributed execution (SURVEY.md §2.2); these tests
cover the new parallel components: chain sharding, pooled
cross-device adaptation, sharding-invariant determinism (SURVEY.md §5 "race
detection" substitute: same PRNG key ⇒ bit-identical chains across
shardings), and the driver dry-run entry point.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import klara_tpu as kt
from klara_tpu.parallel import chain_mesh, shard_chains


def _target():
    return kt.Target(logdensity_fn=lambda x: -0.5 * jnp.sum(jnp.square(x)), dim=2)


def test_determinism_across_shardings(chain_mesh):
    """Same key: sharded and unsharded runs produce identical draws."""
    kwargs = dict(
        target=_target(),
        sampler=kt.MALA(driftstep=0.8),
        mcrange=kt.MCRange(n_steps=200, burnin=50),
        n_chains=16,
    )
    c_single = kt.MCJob(**kwargs).run(jax.random.key(5), jnp.zeros(2))
    c_sharded = kt.MCJob(**kwargs, mesh=chain_mesh).run(jax.random.key(5), jnp.zeros(2))
    np.testing.assert_array_equal(
        np.asarray(c_single.value), np.asarray(c_sharded.value)
    )


def test_pooled_tuning_identical_across_chains(chain_mesh):
    """Pooled adaptation keeps tuner state replicated across chains and
    converges on the pooled statistic."""
    job = kt.MCJob(
        _target(),
        kt.MALA(driftstep=0.1),
        kt.MCRange(n_steps=3000, burnin=1500),
        tuner=kt.AcceptanceRateTuner(0.6),
        n_chains=32,
        mesh=chain_mesh,
        pooled_tuning=True,
    )
    chain = job.run(jax.random.key(0), jnp.zeros(2))
    steps = np.asarray(chain.final_state.tune.step)
    # every chain carries the SAME pooled step
    assert np.all(steps == steps[0])
    rate = float(kt.stats.acceptance(chain))
    assert abs(rate - 0.6) < 0.08


def test_per_chain_tuning_differs():
    job = kt.MCJob(
        _target(),
        kt.MALA(driftstep=0.1),
        kt.MCRange(n_steps=2000, burnin=1000),
        tuner=kt.AcceptanceRateTuner(0.6),
        n_chains=8,
    )
    chain = job.run(jax.random.key(1), jnp.zeros(2))
    steps = np.asarray(chain.final_state.tune.step)
    assert len(np.unique(steps)) > 1  # independent per-chain adaptation


def test_shard_chains_helper(chain_mesh):
    tree = {"a": jnp.zeros((16, 3)), "b": jnp.zeros((16,))}
    sharded = shard_chains(tree, chain_mesh)
    assert "chains" in str(sharded["a"].sharding.spec)


def test_graft_dryrun_entry():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    fn, args = g.entry()
    out_shapes = jax.eval_shape(jax.jit(fn), *args)
    assert jax.tree.leaves(out_shapes)[0].shape == (1024, 100)
    g.dryrun_multichip(8)


# ---------------------------------------------------------------------------
# 2-D (chains x param) mesh: tensor-parallel parameter dimension
# ---------------------------------------------------------------------------


def _logreg_problem(D=16, N=64, seed=3):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.standard_normal((N, D)), jnp.float32)
    y = jnp.asarray((rng.random(N) < 0.5), jnp.float32)
    return X, y


def test_mesh2d_shapes():
    from klara_tpu.parallel import mesh2d

    m = mesh2d(4, 2)
    assert m.axis_names == ("chains", "param")
    assert m.devices.shape == (4, 2)
    with pytest.raises(ValueError):
        mesh2d(8, 2)


def test_param_sharded_target_matches_unsharded():
    """Sharded batched value+grad == plain AD, and it runs inside a full
    HMC job on the 2-D mesh."""
    from klara_tpu.parallel import mesh2d, param_sharded_logreg_target

    X, y = _logreg_problem()
    D = X.shape[1]
    mesh = mesh2d(4, 2)
    target = param_sharded_logreg_target(X, y, mesh, prior_var=10.0)

    rng = np.random.default_rng(0)
    Pm = jnp.asarray(rng.standard_normal((8, D)), jnp.float32)

    def ref_logdensity(p):
        logits = X @ p
        return (
            jnp.dot(logits, y)
            - jnp.sum(jax.nn.softplus(logits))
            - 0.5 * jnp.dot(p, p) / 10.0
            - 0.5 * D * jnp.log(2.0 * jnp.pi * 10.0)
        )

    v_ref, g_ref = jax.vmap(jax.value_and_grad(ref_logdensity))(Pm)
    v, g = jax.jit(jax.vmap(target.logdensity_and_grad))(Pm)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=2e-5, atol=1e-5)

    job = kt.MCJob(
        target,
        kt.HMC(leapstep=0.05, nleaps=4),
        kt.MCRange(n_steps=200, burnin=100),
        n_chains=16,
        mesh=mesh,
    )
    chain = job.run(jax.random.key(0), jnp.zeros(D))
    assert np.isfinite(np.asarray(chain.value)).all()
    assert float(kt.stats.acceptance(chain)) > 0.3


def test_param_sharded_target_direct_unbatched_call():
    """The public per-chain logdensity_and_grad works EAGERLY on a single
    (D,) vector even when the chains mesh axis has >1 devices (the
    unbatched fallback must not apply a 'chains' constraint to a (1, D)
    array outside jit/vmap)."""
    from klara_tpu.parallel import mesh2d, param_sharded_logreg_target

    X, y = _logreg_problem()
    D = X.shape[1]
    mesh = mesh2d(4, 2)
    target = param_sharded_logreg_target(X, y, mesh, prior_var=10.0)

    p = jnp.linspace(-0.5, 0.5, D).astype(jnp.float32)
    v, g = target.logdensity_and_grad(p)  # eager, no jit/vmap

    def ref_logdensity(q):
        logits = X @ q
        return (
            jnp.dot(logits, y)
            - jnp.sum(jax.nn.softplus(logits))
            - 0.5 * jnp.dot(q, q) / 10.0
            - 0.5 * D * jnp.log(2.0 * jnp.pi * 10.0)
        )

    v_ref, g_ref = jax.value_and_grad(ref_logdensity)(p)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=2e-5, atol=1e-5)


def test_param_sharded_target_indivisible_dim_errors():
    """D not divisible by the param axis raises a clear ValueError at
    construction, not an opaque device_put divisibility error."""
    from klara_tpu.parallel import mesh2d, param_sharded_logreg_target

    X, y = _logreg_problem(D=15)
    mesh = mesh2d(4, 2)
    with pytest.raises(ValueError, match="not divisible"):
        param_sharded_logreg_target(X, y, mesh)


def test_gibbs_determinism_across_shardings(chain_mesh):
    """GibbsJob under a chains mesh is bit-identical to the unsharded run
    (same PRNG key) — the sweep program is GSPMD-sharded from the carry
    values' input shardings."""
    from klara_tpu.distributions import Normal

    def build():
        rho = 0.8
        p1 = kt.GibbsParameter(
            "p1",
            setpdf=lambda v: Normal(v["rho"] * v["p2"], jnp.sqrt(1 - v["rho"] ** 2)),
        )
        p2 = kt.GibbsParameter(
            "p2",
            setpdf=lambda v: Normal(v["rho"] * v["p1"], jnp.sqrt(1 - v["rho"] ** 2)),
        )
        return kt.GenericModel([kt.Hyperparameter("rho"), p1, p2])

    v0 = {"rho": jnp.float32(0.8), "p1": 0.0, "p2": 0.0}
    kwargs = dict(sweep={}, mcrange=kt.MCRange(n_steps=400, burnin=100), n_chains=16)
    plain = kt.GibbsJob(build(), **kwargs).run(jax.random.key(3), v0)
    sharded = kt.GibbsJob(build(), **kwargs, mesh=chain_mesh).run(
        jax.random.key(3), v0
    )
    np.testing.assert_array_equal(
        np.asarray(plain.samples["p1"]), np.asarray(sharded.samples["p1"])
    )
    np.testing.assert_array_equal(
        np.asarray(plain.samples["p2"]), np.asarray(sharded.samples["p2"])
    )
