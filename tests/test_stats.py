"""Stats layer tests — mcvar/mcse/ess/iact/zv/rhat.

Reference: src/stats/ (mcvar.jl, zv.jl, ess.jl, iact.jl, acceptance.jl).
Estimator correctness is checked against closed forms on synthetic AR(1)
processes (known integrated autocorrelation time) and exact normals.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import klara_tpu as kt
from klara_tpu import stats


def ar1(key, n, m, phi):
    """AR(1) with unit innovations: IACT = (1+phi)/(1-phi)."""
    rng = np.random.default_rng(key)
    x = np.zeros((n, m), dtype=np.float64)
    eps = rng.standard_normal((n, m))
    for t in range(1, n):
        x[t] = phi * x[t - 1] + eps[t]
    return jnp.asarray(x[n // 5 :], dtype=jnp.float32)  # drop warmup


def test_autocov_matches_numpy():
    x = jnp.asarray(np.random.default_rng(0).standard_normal(500), dtype=jnp.float32)
    acv = np.asarray(stats.autocov(x, 10))
    xc = np.asarray(x) - np.asarray(x).mean()
    expected = np.array([(xc[: 500 - k] * xc[k:]).sum() / 500 for k in range(11)])
    np.testing.assert_allclose(acv, expected, atol=1e-3)


@pytest.mark.parametrize("phi,rtol", [(0.0, 0.35), (0.7, 0.35)])
def test_iact_ar1(phi, rtol):
    x = ar1(1, 50000, 8, phi)
    true_iact = (1 + phi) / (1 - phi)
    est = np.asarray(stats.iact(x)).mean()
    np.testing.assert_allclose(est, true_iact, rtol=rtol)


def test_ess_iid_close_to_n():
    x = jnp.asarray(np.random.default_rng(2).standard_normal((4000, 4)), jnp.float32)
    e = np.asarray(stats.ess(x, combine_chains=False))
    assert e.shape == (4,)
    np.testing.assert_allclose(e, 4000, rtol=0.35)


def test_mcvar_estimators_consistent():
    x = ar1(3, 20000, 4, 0.5)
    v_imse = np.asarray(stats.mcvar_imse(x)).mean()
    v_ipse = np.asarray(stats.mcvar_ipse(x)).mean()
    v_bm = np.asarray(stats.mcvar_bm(x)).mean()
    # all should estimate var(mean) = iact * var / n within a factor
    n = x.shape[0]
    truth = 3.0 * (1 / (1 - 0.5**2)) / n  # iact=3, var=1/(1-phi^2)
    for v in (v_imse, v_ipse, v_bm):
        assert truth / 2 < v < truth * 2


def test_mcse_is_sqrt_mcvar():
    x = ar1(4, 5000, 2, 0.3)
    np.testing.assert_allclose(
        np.asarray(stats.mcse(x)), np.sqrt(np.asarray(stats.mcvar(x))), rtol=1e-6
    )


def test_rhat_converged_vs_not():
    rng = np.random.default_rng(5)
    good = jnp.asarray(rng.standard_normal((2000, 8)), jnp.float32)
    assert float(stats.rhat(good)) < 1.01
    # offset chains -> rhat large
    bad = good + jnp.arange(8.0)[None, :]
    assert float(stats.rhat(bad)) > 1.5


def test_lzv_qzv_variance_reduction():
    """ZV control variates on an exact normal chain must cut variance."""
    target = kt.Target(logdensity_fn=lambda x: -0.5 * jnp.sum(jnp.square(x)), dim=2)
    job = kt.MCJob(
        target,
        kt.MALA(driftstep=1.0),
        kt.MCRange(n_steps=4000, burnin=500),
        n_chains=8,
        monitor=("value", "gradlogtarget"),
    )
    chain = job.run(jax.random.key(0), jnp.zeros(2))
    adj_l, a_l = stats.lzv(chain)
    adj_q, a_q = stats.qzv(chain)
    raw = np.asarray(chain.flat("value"))
    for adj in (np.asarray(adj_l), np.asarray(adj_q)):
        assert adj.shape == raw.shape
        # variance of the mean estimator shrinks (gaussian target: big margin)
        assert adj.var(axis=0).max() < 0.5 * raw.var(axis=0).max()
        assert np.abs(adj.mean(axis=0)).max() < 0.05


def test_acceptance_without_diagnostics():
    target = kt.Target(logdensity_fn=lambda x: -0.5 * jnp.sum(jnp.square(x)), dim=2)
    job = kt.MCJob(target, kt.MH(), kt.MCRange(n_steps=1000, burnin=100), n_chains=4)
    chain = job.run(jax.random.key(1), jnp.zeros(2))
    a_diag = float(stats.acceptance(chain))
    a_runs = float(stats.acceptance(chain, diagnostics=False))
    assert abs(a_diag - a_runs) < 0.05


def test_rank_normalized_diagnostics_iid():
    """Rank-normalised split-Rhat ~ 1 and bulk/tail ESS ~ n*m on iid
    draws, even for a heavy-tailed (Cauchy) distribution where plain
    moment-based diagnostics break (Vehtari et al. 2021)."""
    key = jax.random.key(0)
    n, m = 500, 8
    x = jax.random.cauchy(key, (n, m, 2))
    r = np.asarray(kt.stats.rhat_rank(x))
    assert r.shape == (2,)
    assert np.all(r < 1.02), r
    eb = np.asarray(kt.stats.ess_bulk(x))
    et = np.asarray(kt.stats.ess_tail(x))
    assert np.all(eb > 0.5 * n * m), eb
    assert np.all(et > 0.25 * n * m), et


def test_rank_normalized_rhat_detects_stuck_chain():
    key = jax.random.key(1)
    n, m = 500, 8
    x = jax.random.normal(key, (n, m, 1))
    x = x.at[:, 0, :].add(5.0)  # one chain stuck in a different mode
    r = np.asarray(kt.stats.rhat_rank(x))
    assert np.all(r > 1.05), r


def test_stats_accept_plain_samples_dict():
    """A plain ``samples`` dict (e.g. GibbsChains.samples) works like a
    Chain; bf16 storage is promoted to f32 before reducing."""
    x = ar1(3, 600, 4, 0.5)
    xb = x.astype(jnp.bfloat16)
    d = {"value": xb, "other": x}
    assert stats.mean(d).dtype == jnp.float32
    np.testing.assert_allclose(
        np.asarray(stats.mean(d)), np.mean(np.asarray(xb, np.float32)), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(stats.mcse(d, field="other")), np.asarray(stats.mcse(x)), rtol=1e-6
    )
