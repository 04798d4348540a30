"""Discrete-support MH — the reference's Poisson example
(doc/examples/Poisson/MH.jl): integer random walk with Binary(i-1, i+1)
proposals and asymmetric correction, targeting an unnormalised Poisson(λ).

Exercises the BasicDiscUnvParameter capability (reference
src/variables/parameters/BasicDiscUnvParameter.jl) in this design:
integer positions flow through the same MH kernel; the asymmetric
two-point proposal corrects at the boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy import special as jsp

import klara_tpu as kt
from klara_tpu.distributions import Binary


LAM = 6.0


def poisson_target():
    # logtarget(p) = p*log(lam) - log(p!)  (reference Poisson/MH.jl:3)
    def logdensity(p):
        pf = jnp.asarray(p, jnp.float32)
        lp = jnp.sum(pf * jnp.log(LAM) - jsp.gammaln(pf + 1.0))
        # p >= 0 support
        return jnp.where(jnp.all(p >= 0), lp, -jnp.inf)

    return kt.Target(logdensity_fn=logdensity, dim=1)


def binary_walk_proposal(x, scale):
    # Binary(0, 1) at 0, else Binary(i-1, i+1)   (Poisson/MH.jl:10)
    at_zero = x == 0
    a = jnp.where(at_zero, 0, x - 1)
    b = jnp.where(at_zero, 1, x + 1)
    return Binary(a=a, b=b, p=0.5)


def test_poisson_mh_discrete():
    job = kt.MCJob(
        poisson_target(),
        kt.MH(proposal_fn=binary_walk_proposal, symmetric=False),
        kt.MCRange(n_steps=8000, burnin=1000),
        n_chains=32,
    )
    chain = job.run(jax.random.key(0), jnp.array([2], dtype=jnp.int32))
    draws = np.asarray(chain.flat("value"))
    assert draws.dtype.kind == "i"
    assert draws.min() >= 0
    # Poisson(6): mean 6, var 6
    np.testing.assert_allclose(draws.mean(), LAM, rtol=0.05)
    np.testing.assert_allclose(draws.var(), LAM, rtol=0.15)
    # value-change acceptance fallback (reference uses diagnostics=false here)
    rate = float(kt.stats.acceptance(chain, diagnostics=False))
    assert 0.2 < rate < 0.95


def test_from_model_ctor():
    """Reference-style BasicMCJob(model, sampler, range, v0) construction."""
    p = kt.GibbsParameter(
        "p",
        logtarget=lambda x, v: jnp.sum(
            jnp.asarray(x, jnp.float32) * jnp.log(v["lam"])
            - jsp.gammaln(jnp.asarray(x, jnp.float32) + 1.0)
        ),
    )
    model = kt.likelihood_model([kt.Constant("lam"), p])
    job, x0 = kt.MCJob.from_model(
        model,
        kt.MH(proposal_fn=binary_walk_proposal, symmetric=False),
        kt.MCRange(n_steps=4000, burnin=500),
        v0={"lam": 6.0, "p": jnp.array([2], jnp.int32)},
        n_chains=16,
    )
    chain = job.run(jax.random.key(1), x0)
    m = float(np.asarray(chain.flat("value")).mean())
    assert abs(m - LAM) < 0.4
