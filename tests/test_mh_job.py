"""End-to-end MH tests — the reference README 2-D normal workflow.

Reference workloads: README.md:23-70 (unnormalised 2-D normal, MH,
10k steps / 1k burnin, mean(chain) ~ 0) and test/BasicMCJob.jl:1-83.
Promoted from eyeballed to asserted tolerances (SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import klara_tpu as kt


def normal_2d_target():
    # p(x) ∝ exp(-½ xᵀx), deliberately unnormalised like the README example
    return kt.Target(logdensity_fn=lambda x: -0.5 * jnp.sum(jnp.square(x)), dim=2)


def test_mh_normal_2d_posterior_mean():
    target = normal_2d_target()
    job = kt.MCJob(
        target,
        kt.MH(sigma=1.0),
        kt.MCRange(n_steps=5000, burnin=1000),
        n_chains=32,
    )
    chain = job.run(jax.random.key(0), jnp.zeros(2))

    m = kt.stats.mean(chain)
    # MCSE-scaled tolerance: sd=1, heavily autocorrelated; 32 chains x 4k draws
    np.testing.assert_allclose(np.asarray(m), np.zeros(2), atol=0.1)

    var = jnp.var(chain.flat("value"), axis=0)
    np.testing.assert_allclose(np.asarray(var), np.ones(2), atol=0.15)

    rate = kt.stats.acceptance(chain)
    assert 0.2 < float(rate) < 0.8


def test_trace_shapes_and_thinning():
    target = normal_2d_target()
    job = kt.MCJob(
        target,
        kt.MH(sigma=0.5),
        kt.MCRange(n_steps=103, burnin=13, thinning=7),
        n_chains=3,
        monitor=("value", "logtarget"),
        diagnostics=("accept", "accept_stat"),
    )
    chain = job.run(jax.random.key(1), jnp.ones(2))
    n_post = (103 - 13 - 1) // 7 + 1
    assert chain.value.shape == (n_post, 3, 2)
    assert chain["logtarget"].shape == (n_post, 3)
    assert chain["accept"].shape == (n_post, 3)
    assert chain.n_post == n_post and chain.n_chains == 3
    # saved logtarget must equal target at saved value
    lt = jax.vmap(jax.vmap(target.logdensity))(chain.value)
    np.testing.assert_allclose(np.asarray(lt), np.asarray(chain["logtarget"]), rtol=1e-5)


def test_trace_dtype_bf16_buffers_and_moments():
    """trace_dtype='bfloat16' halves the trace memory: sample buffers round
    to bf16 (diagnostics keep their dtypes), the sampling kernel is
    untouched (draws equal the f32-trace run within bf16 rounding), and
    moment estimates agree within MC-noise-scale tolerance."""
    target = normal_2d_target()

    def mk(trace_dtype):
        return kt.MCJob(
            target,
            kt.MH(sigma=1.0),
            kt.MCRange(n_steps=800, burnin=200),
            n_chains=16,
            monitor=("value", "logtarget"),
            diagnostics=("accept",),
            trace_dtype=trace_dtype,
        )

    c32 = mk(None).run(jax.random.key(5), jnp.zeros(2))
    c16 = mk("bfloat16").run(jax.random.key(5), jnp.zeros(2))
    assert c16.value.dtype == jnp.bfloat16
    assert c16["logtarget"].dtype == jnp.bfloat16
    assert c16["accept"].dtype == c32["accept"].dtype  # diagnostics untouched
    # same kernel, same draws — only the stored copy rounds
    np.testing.assert_allclose(
        np.asarray(c16.value, np.float32), np.asarray(c32.value),
        rtol=1e-2, atol=1e-2,
    )
    # the stats layer promotes bf16 traces to f32 before reducing
    # (stats/_common.py) — a bf16 accumulator would corrupt the mean
    m32 = np.asarray(kt.stats.mean(c32))
    m16 = np.asarray(kt.stats.mean(c16))
    assert m16.dtype == np.float32
    np.testing.assert_allclose(m16, m32, atol=5e-3)
    e32 = np.asarray(kt.stats.ess(c32))
    e16 = np.asarray(kt.stats.ess(c16))
    np.testing.assert_allclose(e16, e32, rtol=0.05)
    # raw (draws, chains, dim) arrays are accepted too
    np.testing.assert_allclose(
        np.asarray(kt.stats.mean(c16.value)), m16, atol=1e-6
    )


def test_mh_asymmetric_proposal_correction():
    """Asymmetric proposal: still targets the right distribution."""
    from klara_tpu.distributions import Normal

    target = kt.Target(logdensity_fn=lambda x: -0.5 * jnp.sum(jnp.square(x)), dim=1)
    # off-centre proposal -> asymmetric; correction must keep exactness
    job = kt.MCJob(
        target,
        kt.MH(proposal_fn=lambda x, scale: Normal(x + 0.3, scale), symmetric=False),
        kt.MCRange(n_steps=4000, burnin=500),
        n_chains=64,
    )
    chain = job.run(jax.random.key(2), jnp.zeros(1))
    m = float(kt.stats.mean(chain)[0])
    assert abs(m) < 0.1


def test_deterministic_same_key():
    target = normal_2d_target()
    job = kt.MCJob(target, kt.MH(), kt.MCRange(n_steps=50, burnin=0), n_chains=4)
    c1 = job.run(jax.random.key(7), jnp.zeros(2))
    c2 = job.run(jax.random.key(7), jnp.zeros(2))
    np.testing.assert_array_equal(np.asarray(c1.value), np.asarray(c2.value))


def test_chains_sharded_over_mesh(chain_mesh):
    """Chains sharded over the 8-device CPU mesh produce valid results."""
    target = normal_2d_target()
    job = kt.MCJob(
        target,
        kt.MH(sigma=1.0),
        kt.MCRange(n_steps=500, burnin=100),
        n_chains=64,
        mesh=chain_mesh,
    )
    chain = job.run(jax.random.key(3), jnp.zeros(2))
    assert chain.value.shape == (400, 64, 2)
    assert abs(float(kt.stats.mean(chain)[0])) < 0.35
