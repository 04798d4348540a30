"""Two-phase (warmup/sampling) run, mass-adaptation shrinkage, and
13-slot monitored-field parity (round-3 VERDICT items 3, 6, 8).

The phased run must be *bit-identical* to the single-scan run: every
adaptation freezes at burnin (dual averaging holds step=eps_bar after
nadapt, reference src/samplers/iterate/HMC.jl:225-248; the mass/ChEES
hooks gate on i<burnin), so removing the adaptation code from the
post-burnin program cannot change the draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import klara_tpu as kt


def std_normal(dim):
    return kt.Target(logdensity_fn=lambda x: -0.5 * jnp.sum(x * x), dim=dim)


def scaled_normal(scales):
    scales = jnp.asarray(scales)
    return kt.Target(
        logdensity_fn=lambda x: -0.5 * jnp.sum((x / scales) ** 2),
        dim=scales.shape[0],
    )


def _hmc_job(**kw):
    # nadapt < burnin: by the end of warmup the DA freeze has already
    # fired in run() too, so run_phased must be BIT-identical
    base = dict(
        target=std_normal(3),
        sampler=kt.HMC(leapstep=0.1, nleaps=8, trajectory_length=1.2),
        mcrange=kt.MCRange(n_steps=400, burnin=150),
        tuner=kt.DualAveragingTuner(0.8, 100),
        n_chains=8,
        monitor=("value", "logtarget"),
        pooled_tuning=True,
    )
    base.update(kw)
    return kt.MCJob(**base)


# ----------------------------------------------------------- phased == run
def test_run_phased_bit_identical_to_run_hmc():
    x0 = 0.1 * jax.random.normal(jax.random.key(7), (8, 3))
    chain = _hmc_job().run(jax.random.key(3), x0)
    phased, timings = _hmc_job().run_phased(jax.random.key(3), x0)
    np.testing.assert_array_equal(
        np.asarray(chain.value), np.asarray(phased.value)
    )
    np.testing.assert_array_equal(
        np.asarray(chain["logtarget"]), np.asarray(phased["logtarget"])
    )
    np.testing.assert_array_equal(
        np.asarray(chain.final_state.position),
        np.asarray(phased.final_state.position),
    )
    assert timings["warmup_seconds"] > 0
    assert timings["sampling_seconds"] > 0


def test_run_phased_bit_identical_with_mass_and_chees():
    kw = dict(
        sampler=kt.HMC(
            leapstep=0.1, nleaps=8, trajectory_length=0.8, jitter=0.5,
            max_nleaps=64,
        ),
        mass_adaptation=True,
        mass_period=50,
        traj_adaptation=True,
    )
    x0 = 0.1 * jax.random.normal(jax.random.key(8), (8, 3))
    chain = _hmc_job(**kw).run(jax.random.key(5), x0)
    phased, _ = _hmc_job(**kw).run_phased(jax.random.key(5), x0)
    np.testing.assert_array_equal(
        np.asarray(chain.value), np.asarray(phased.value)
    )
    # frozen adaptation state carried through identically
    np.testing.assert_array_equal(
        np.asarray(chain.final_state.inv_mass),
        np.asarray(phased.final_state.inv_mass),
    )
    np.testing.assert_array_equal(
        np.asarray(chain.final_state.log_traj),
        np.asarray(phased.final_state.log_traj),
    )


def test_run_phased_nuts():
    job = kt.MCJob(
        std_normal(2),
        kt.NUTS(max_doublings=4),
        kt.MCRange(n_steps=300, burnin=100),
        tuner=kt.DualAveragingTuner(0.8, 80),
        n_chains=8,
        pooled_tuning=True,
    )
    x0 = 0.1 * jax.random.normal(jax.random.key(9), (8, 2))
    phased, timings = job.run_phased(jax.random.key(2), x0)
    ref = kt.MCJob(
        std_normal(2),
        kt.NUTS(max_doublings=4),
        kt.MCRange(n_steps=300, burnin=100),
        tuner=kt.DualAveragingTuner(0.8, 80),
        n_chains=8,
        pooled_tuning=True,
    ).run(jax.random.key(2), x0)
    np.testing.assert_array_equal(np.asarray(ref.value), np.asarray(phased.value))


def test_run_phased_rejects_csv(tmp_path):
    job = _hmc_job(destination="csv", filepath=str(tmp_path / "out"))
    with pytest.raises(ValueError, match="nstate"):
        job.run_phased(jax.random.key(0), jnp.zeros(3))


def test_run_phased_zero_burnin():
    job = _hmc_job(mcrange=kt.MCRange(n_steps=100, burnin=0),
                   tuner=kt.VanillaTuner())
    chain, timings = job.run_phased(jax.random.key(1), jnp.zeros(3))
    assert chain.value.shape[0] == 100


# -------------------------------------------------- shared ('step') jitter
def _jitter_job(style):
    return kt.MCJob(
        std_normal(3),
        kt.HMC(
            leapstep=0.1, trajectory_length=1.0, jitter=0.9,
            jitter_style=style, dynamic_nleaps=True, max_nleaps=64,
        ),
        kt.MCRange(n_steps=60, burnin=20),
        tuner=kt.VanillaTuner(),
        n_chains=16,
        diagnostics=("accept", "nleaps"),
        step_size=0.1,
    )


def test_step_jitter_shared_across_chains():
    """'step' jitter style: ONE draw per iteration -> every chain runs the
    same nleaps (no batch-max waste under vmap), varying over steps."""
    chain = _jitter_job("step").run(jax.random.key(0), jnp.zeros(3))
    nleaps = np.asarray(chain["nleaps"])  # (n_post, n_chains)
    assert np.all(nleaps == nleaps[:, :1]), "jitter must be shared per step"
    assert len(np.unique(nleaps[:, 0])) > 3, "jitter must vary across steps"


def test_chain_jitter_varies_across_chains():
    chain = _jitter_job("chain").run(jax.random.key(0), jnp.zeros(3))
    nleaps = np.asarray(chain["nleaps"])
    assert np.any(nleaps != nleaps[:, :1]), "per-chain jitter must differ"


def test_chees_adapts_with_shared_jitter():
    """ChEES trajectory adaptation works with the shared jitter draw (the
    gradient uses the realized shared fraction)."""
    job = kt.MCJob(
        scaled_normal(jnp.asarray([1.0, 1.0])),
        kt.HMC(leapstep=0.1, trajectory_length=0.2, jitter=0.9,
               jitter_style="step", max_nleaps=64),
        kt.MCRange(n_steps=800, burnin=600),
        tuner=kt.DualAveragingTuner(0.8, 600),
        n_chains=64,
        pooled_tuning=True,
        traj_adaptation=True,
    )
    x0 = jax.random.normal(jax.random.key(0), (64, 2))
    chain = job.run(jax.random.key(1), x0)
    lam = float(np.exp(np.mean(np.asarray(chain.final_state.log_traj))))
    # ChEES must grow the too-short initial trajectory (0.2) toward ~pi/2
    assert lam > 0.5, lam


# ------------------------------------------- mass-adaptation shrinkage
def test_mass_adaptation_small_ensemble_matches_stan_formula():
    """At n_chains=32 the adapted inverse mass must land on Stan's
    regularised ensemble variance, w*var + (1-w)*1e-3 with w=n/(n+5) —
    i.e. near the target variance, NOT shrunk toward zero."""
    scales = jnp.asarray([0.5, 1.0, 2.0])
    n_chains = 32
    job = kt.MCJob(
        scaled_normal(scales),
        kt.HMC(leapstep=0.05, nleaps=10, trajectory_length=1.0),
        kt.MCRange(n_steps=1500, burnin=1200),
        tuner=kt.DualAveragingTuner(0.8, 1200),
        n_chains=n_chains,
        pooled_tuning=True,
        mass_adaptation=True,
        mass_period=100,
    )
    x0 = jax.random.normal(jax.random.key(0), (n_chains, 3)) * scales
    chain = job.run(jax.random.key(1), x0)
    inv_mass = np.asarray(chain.final_state.inv_mass)[0]
    w = n_chains / (n_chains + 5.0)
    # the ensemble variance estimate is noisy at 32 chains: allow 50%
    # relative error around the shrunk target — catches the old bug
    # (shrinking the whole estimate toward 1e-3 would give ~0.22 for
    # the 2.0-scale coordinate instead of ~3.5)
    expected = w * scales.astype(np.float32) ** 2 + (1 - w) * 1e-3
    np.testing.assert_allclose(inv_mass, expected, rtol=0.5)
    # ordering must reflect the true scales
    assert inv_mass[0] < inv_mass[1] < inv_mass[2]


# -------------------------------------------- 13-slot monitored fields
def test_monitor_all_thirteen_reference_slots():
    """All 13 reference monitor slots ({log,gradlog,tensorlog,dtensorlog}
    x {likelihood,prior,target} + value) are recordable and match the
    Target accessors (reference src/nstates/ParameterNStates/
    BasicContMuvParameterNState.jl:89-119)."""
    ll = lambda x: -0.5 * jnp.sum(x * x)
    lp = lambda x: -0.25 * jnp.sum(x ** 4)
    target = kt.Target.from_loglik_logprior(ll, lp, dim=2)
    fields = (
        "value", "logtarget", "loglikelihood", "logprior",
        "gradlogtarget", "gradloglikelihood", "gradlogprior",
        "tensorlogtarget", "tensorloglikelihood", "tensorlogprior",
        "dtensorlogtarget", "dtensorloglikelihood", "dtensorlogprior",
    )
    job = kt.MCJob(
        target,
        kt.MH(0.5),
        kt.MCRange(n_steps=40, burnin=10),
        n_chains=4,
        monitor=fields,
    )
    chain = job.run(jax.random.key(0), jnp.zeros(2))
    n_post = chain.value.shape[0]
    x_last = np.asarray(chain.value)[-1]  # (n_chains, 2)

    # shapes
    assert chain["gradloglikelihood"].shape == (n_post, 4, 2)
    assert chain["tensorlogtarget"].shape == (n_post, 4, 2, 2)
    assert chain["dtensorlogprior"].shape == (n_post, 4, 2, 2, 2)

    # values match the Target accessors at the recorded positions
    for c in range(4):
        x = jnp.asarray(x_last[c])
        np.testing.assert_allclose(
            np.asarray(chain["gradloglikelihood"])[-1, c],
            np.asarray(target.grad_loglikelihood(x)), rtol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(chain["gradlogprior"])[-1, c],
            np.asarray(target.grad_logprior(x)), rtol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(chain["tensorlogtarget"])[-1, c],
            np.asarray(target.tensor(x)), rtol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(chain["dtensorlogtarget"])[-1, c],
            np.asarray(target.dtensor(x)), rtol=1e-5,
        )
    # analytic spot-checks: tensor_ll = I, tensor_lp = diag(3 x_i^2)
    np.testing.assert_allclose(
        np.asarray(chain["tensorloglikelihood"])[-1, 0],
        np.eye(2), rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(chain["tensorlogprior"])[-1, 0],
        np.diag(3.0 * x_last[0] ** 2), rtol=1e-4,
    )


def test_grad_accessors_forward_mode():
    ll = lambda x: -0.5 * jnp.sum(x * x)
    lp = lambda x: -jnp.sum(jnp.abs(x) ** 3) / 3.0
    t = kt.Target.from_loglik_logprior(ll, lp, dim=3, ad_mode="forward")
    x = jnp.asarray([0.3, -0.7, 1.1])
    np.testing.assert_allclose(
        np.asarray(t.grad_loglikelihood(x)), np.asarray(-x), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(t.grad_logprior(x)),
        -np.sign(np.asarray(x)) * np.asarray(x) ** 2,
        rtol=1e-5,
    )


def test_run_preconditioned_dense_metric():
    """Dense ensemble preconditioning (MCJob.run_preconditioned): the
    whitened two-stage run samples the correct posterior on a strongly
    correlated Gaussian, and the whitened space needs a shorter adapted
    trajectory than the raw one (the point of the dense metric)."""
    rho = 0.95
    cov = np.array([[1.0, rho], [rho, 1.0]], np.float32)
    prec = jnp.asarray(np.linalg.inv(cov))
    target = kt.Target(logdensity_fn=lambda x: -0.5 * x @ prec @ x, dim=2)

    def make_job():
        return kt.MCJob(
            target,
            kt.HMC(leapstep=0.1, nleaps=4, trajectory_length=0.5,
                   jitter=0.9, jitter_style="step", max_nleaps=64),
            kt.MCRange(n_steps=1500, burnin=600),
            tuner=kt.DualAveragingTuner(0.8, 600),
            n_chains=64,
            monitor=("value",),
            pooled_tuning=True,
            traj_adaptation=True,
        )

    x0 = jnp.zeros((64, 2))
    chain, timings, info = make_job().run_preconditioned(jax.random.key(0), x0)
    flat = np.asarray(chain.value).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(2), atol=0.08)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.1)
    assert timings["warmup_seconds"] > 0 and timings["sampling_seconds"] > 0
    assert info["chol"].shape == (2, 2)

    # whitening lifts the step-size ceiling: raw eps is pinned by the
    # smallest posterior scale (sigma_min = sqrt(1-rho) ~ 0.22), the
    # whitened space is ~isotropic unit scale (ChEES lambda itself is
    # too noisy at 64 chains to assert on)
    raw_chain, _ = make_job().run_phased(jax.random.key(0), x0)
    eps_raw = float(np.mean(np.asarray(raw_chain.final_state.tune.step)))
    eps_white = float(np.mean(np.asarray(chain.final_state.tune.step)))
    assert eps_white > eps_raw

    with pytest.raises(ValueError, match="monitor"):
        job = make_job()
        job.monitor = ("value", "logtarget")
        job.run_preconditioned(jax.random.key(0), x0)


def test_run_preconditioned_nuts_stage2():
    """stage2_replace can swap the whitened stage to a different sampler
    family (NUTS with its own diagnostics) — guards the stage-1/stage-2
    diagnostics split (stage 1 is HMC and has no 'na' channel)."""
    rho = 0.9
    cov = np.array([[1.0, rho], [rho, 1.0]], np.float32)
    prec = jnp.asarray(np.linalg.inv(cov))
    target = kt.Target(logdensity_fn=lambda x: -0.5 * x @ prec @ x, dim=2)
    job = kt.MCJob(
        target,
        kt.HMC(leapstep=0.1, nleaps=4, trajectory_length=0.5,
               jitter=0.9, jitter_style="step", max_nleaps=64),
        kt.MCRange(n_steps=1200, burnin=500),
        tuner=kt.DualAveragingTuner(0.8, 500),
        n_chains=64,
        monitor=("value",),
        diagnostics=("accept", "nleaps"),
        pooled_tuning=True,
        traj_adaptation=True,
    )
    chain, timings, info = job.run_preconditioned(
        jax.random.key(2), jnp.zeros((64, 2)),
        stage2_replace=dict(
            sampler=kt.NUTS(max_doublings=3),
            traj_adaptation=False,
            diagnostics=("accept", "na"),
        ),
    )
    flat = np.asarray(chain.value).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(2), atol=0.08)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.12)
    assert float(np.mean(np.asarray(chain["na"]))) >= 1.0


def test_whiten_target_preserves_decomposition_and_prior():
    """whiten_target keeps the Bayesian decomposition, analytic tensor
    and prior (re-expressed in whitened coordinates) — a whitened job
    can still draw its initial values from the prior."""
    from klara_tpu.distributions import Normal

    L = jnp.asarray([[2.0, 0.0], [1.0, 1.0]], jnp.float32)
    base = kt.Target.from_loglik_logprior(
        lambda x: -0.5 * jnp.sum(x**2),
        lambda x: -0.25 * jnp.sum(x**2),
        dim=2,
    )
    import dataclasses as _dc
    base = _dc.replace(base, prior=Normal(jnp.zeros(2), jnp.ones(2)),
                       tensor_fn=lambda x: 1.5 * jnp.eye(2))
    wt = kt.whiten_target(base, L)
    y = jnp.asarray([0.3, -0.7])
    x = L @ y
    np.testing.assert_allclose(wt.logdensity(y), base.logdensity(x), rtol=1e-6)
    np.testing.assert_allclose(wt.loglikelihood_fn(y), -0.5 * float(x @ x), rtol=1e-6)
    np.testing.assert_allclose(wt.logprior_fn(y), -0.25 * float(x @ x), rtol=1e-6)
    # H_y = L^T H_x L
    np.testing.assert_allclose(np.asarray(wt.tensor_fn(y)),
                               np.asarray(L.T @ (1.5 * jnp.eye(2)) @ L), rtol=1e-6)
    # prior draws whiten the base draw: x-space draw recovered by L @ y
    ydraw = wt.prior.sample(jax.random.key(0))
    xdraw = base.prior.sample(jax.random.key(0))
    np.testing.assert_allclose(np.asarray(L @ ydraw), np.asarray(xdraw), rtol=1e-5)
    # a job on the whitened target can init from the prior (no x0)
    job = kt.MCJob(wt, kt.MH(sigma=0.5), kt.MCRange(n_steps=50, burnin=10),
                   n_chains=4)
    chain = job.run(jax.random.key(1))
    assert chain.value.shape[0] == 40


def test_preconditioned_stage2_step_is_seeded_not_searched():
    """run_preconditioned seeds stage-2 dual averaging at dim^-1/4 by
    default (the whitened geometry is ~unit isotropic, so the Alg-4
    search is redundant); an explicit stage2_replace['step_size']
    overrides the seed."""
    t = kt.Target(logdensity_fn=lambda x: -0.5 * jnp.sum(x**2), dim=4)
    job = kt.MCJob(
        t, kt.HMC(leapstep=0.2, nleaps=4, trajectory_length=1.0),
        kt.MCRange(n_steps=220, burnin=100),
        tuner=kt.DualAveragingTuner(0.8, 100),
        n_chains=32, monitor=("value",), pooled_tuning=True,
    )
    x0 = 0.1 * jax.random.normal(jax.random.key(0), (32, 4))
    _, _, info = job.run_preconditioned(jax.random.key(1), x0)
    assert info["whitened_job"].step_size == pytest.approx(4.0 ** -0.25)
    _, _, info2 = job.run_preconditioned(
        jax.random.key(1), x0, stage2_replace=dict(step_size=0.123)
    )
    assert info2["whitened_job"].step_size == 0.123
    # an explicit job-level step size is inherited, not overridden
    job2 = dataclasses.replace(job, step_size=0.3)
    _, _, info3 = job2.run_preconditioned(jax.random.key(1), x0)
    assert info3["whitened_job"].step_size == 0.3


def test_preconditioned_run_with_bf16_trace():
    """run_preconditioned under trace_dtype='bfloat16': the stage-1 end
    positions come from the reduced-precision trace and must be lifted
    back to f32 before the covariance/Cholesky/whitened restart (bf16
    would otherwise propagate into the whitened sampler state and break
    the fori_loop carry)."""
    cov = jnp.asarray([[4.0, 1.8], [1.8, 1.0]], jnp.float32)
    prec = jnp.linalg.inv(cov)
    t = kt.Target(logdensity_fn=lambda x: -0.5 * x @ prec @ x, dim=2)
    job = kt.MCJob(
        t, kt.HMC(leapstep=0.2, nleaps=8, trajectory_length=1.5),
        kt.MCRange(n_steps=700, burnin=300),
        tuner=kt.DualAveragingTuner(0.8, 300),
        n_chains=128, monitor=("value",), pooled_tuning=True,
        trace_dtype="bfloat16",
    )
    x0 = 0.1 * jax.random.normal(jax.random.key(0), (128, 2))
    chain, timings, info = job.run_preconditioned(jax.random.key(1), x0)
    assert info["chol"].dtype == jnp.float32
    # the back-transform keeps the trace's storage dtype (an f32 result
    # would silently double the trace footprint the bf16 option bought)
    assert chain.value.dtype == jnp.bfloat16
    flat = np.asarray(chain.value, np.float32).reshape(-1, 2)
    np.testing.assert_allclose(np.cov(flat.T), np.asarray(cov), atol=0.5)


def test_whitened_scalar_prior_sample_and_job_init():
    """ADVICE r04: a SCALAR (per-component iid) base prior used to yield
    a 0-d whitened draw, crashing solve_triangular inside sample_prior's
    eval_shape probe — wjob.run without explicit x0 failed.  The whitened
    prior must lift scalar bases to a (dim,) iid draw."""
    from klara_tpu.distributions import Normal

    L = jnp.asarray([[2.0, 0.0], [1.0, 1.0]], jnp.float32)
    base = kt.Target.from_loglik_logprior(
        lambda x: -0.5 * jnp.sum(x**2),
        lambda x: -0.25 * jnp.sum(x**2),
        dim=2,
    )
    import dataclasses as _dc
    base = _dc.replace(base, prior=Normal(0.0, 1.0))  # scalar iid prior
    wt = kt.whiten_target(base, L)
    y = wt.prior.sample(jax.random.key(0))
    assert y.shape == (2,)
    # iid per-component (not one value tiled): components differ
    x = np.asarray(L @ y)
    assert abs(x[0] - x[1]) > 1e-6
    ydraw = wt.sample_prior(jax.random.key(3))
    assert ydraw.shape == (2,)
    job = kt.MCJob(wt, kt.MH(sigma=0.5), kt.MCRange(n_steps=30, burnin=10),
                   n_chains=4)
    chain = job.run(jax.random.key(1))  # no x0: init from the prior
    assert chain.value.shape[0] == 20
