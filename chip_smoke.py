"""Smoke run of klara_tpu's main path on NVIDIA GPUs, in one process.

    python chip_smoke.py               # one card: phases 1-8 below
    python chip_smoke.py --devices 4   # four cards: the sharded path only

Phases on one card, each printing one line (or one per case):

  1. device   platform, device kind and count, JAX version, the card's name
              and power limit (from nvidia-smi), XLA_FLAGS, compile cache.
  2. target   the batched 100-dim logreg value+grad at C=16384, N=1024 under
              each matmul precision against a float64 NumPy reference, and
              its time.
  3. chees    MCJob.run_phased with HMC + pooled dual averaging + ensemble
              mass + ChEES, as bench.py's 'chees' case, at 16,384 chains.
  4. precond  MCJob.run_preconditioned ('chees_precond', 'nuts_precond').
  5. nuts     raw NUTS, max_doublings=5, static tree.
  6. gibbs    the rats GibbsJob at 4,096 chains against the BUGS values.
  7. examples the asserted examples matrix, in this process.
  8. io       csv streaming through io_callback, and checkpoint + resume.

Phases 4 and 5 must agree with phase 3's posterior mean within 5x the
combined Monte Carlo standard error.  A failed check raises: the script
exits non-zero and prints no result line.  Without a GPU it exits non-zero
before any phase runs.  The last stdout line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

With ``--devices 4`` it runs only the chain-sharded jobs (HMC+ChEES,
run_preconditioned, the rats GibbsJob, and the parameter-sharded logreg
target on a 2x2 mesh), each compared with the same job on one card.

Compiled programs are cached in ``$JAX_COMPILATION_CACHE_DIR`` when it is
set, else in ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import bench  # noqa: E402  (the bench's job configurations; no JAX at import)
import klara_tpu as kt  # noqa: E402
from klara_tpu.models.examples import (  # noqa: E402
    rats_gibbs_model,
    synthetic_logistic_regression,
)

ACCEPT_TARGET = 0.8  # bench.py's dual-averaging target
ACCEPT_TOL = 0.05
AGREE_K = 5.0  # posterior means agree within AGREE_K x combined MCSE
EPS_RTOL = 0.05  # pooled step size: sharded vs one card
# phase-2 tolerances on the largest per-chain relative error: full float32
# matmuls, and TF32-class ones (10-bit mantissa, ~3 decimal digits)
TOL_F32 = 1e-4
TOL_TF32 = 1e-2
PRECISIONS = ("f32", "high", "default")  # bench.py's names
# the bench's precision for its ChEES, preconditioned and NUTS rows
PRECISION = "high"
# the rats posterior (BUGS): means and the tolerances tests/test_examples.py
# asserts
RATS_BUGS = {"alpha_c": (242.5, 3.0), "beta_c": (6.19, 0.15)}
RATS_MONITOR = ("alpha_c", "beta_c", "sigma2_c", "sigma2_a", "sigma2_b")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Run shape of the smoke phases.  Width (D=100, N=1024), chain counts
    and warmup (300 steps; Gibbs 500 sweeps) are bench.py's; post-burnin
    draws are cut to smoke length."""

    chains: int = 16384
    burnin: int = 300
    post: int = 300
    gibbs_chains: int = 4096
    gibbs_steps: int = 1500
    gibbs_burnin: int = 500
    io_chains: int = 64
    io_steps: int = 200


def say(line):
    print(line, flush=True)


def peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def time_ms(f, x, reps):
    """Mean milliseconds of ``f(x)`` over ``reps`` calls, after a compile
    call and two warm-ups; returns (first result, ms)."""
    out = jax.block_until_ready(f(x))
    for _ in range(2):
        jax.block_until_ready(f(x))
    t0 = time.perf_counter()
    for _ in range(reps):
        r = f(x)
    jax.block_until_ready(r)
    return out, 1e3 * (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------- checks
@jax.jit
def _chunk_sums(v):
    """Sums over chains of the per-chain means and MC variances."""
    return (
        jnp.sum(jnp.mean(v.astype(jnp.float32), axis=0), axis=0),
        jnp.sum(kt.stats.mcvar(v), axis=0),
    )


def mean_and_mcse(values, chunk=2048):
    """Posterior mean over draws and chains of a (draws, chains, ...) trace
    and its Monte Carlo standard error.  Chains are independent, so the
    pooled mean's variance is the sum of the per-chain MC variances
    (Geyer IMSE, ``kt.stats.mcvar``) over the chain count squared."""
    n_chains = values.shape[1]
    tot_m = tot_v = 0.0
    for s in range(0, n_chains, chunk):
        m, v = _chunk_sums(values[:, s : s + chunk])
        tot_m = tot_m + np.asarray(m, np.float64)
        tot_v = tot_v + np.asarray(v, np.float64)
    return tot_m / n_chains, np.sqrt(tot_v) / n_chains


def agreement(a, b):
    """Largest |mean_a - mean_b| over coordinates, in units of the combined
    MCSE; ``a``/``b`` are (mean, mcse) pairs."""
    (ma, sa), (mb, sb) = a, b
    z = np.abs(ma - mb) / np.sqrt(np.square(sa) + np.square(sb))
    return float(np.max(z))


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def all_finite(x):
    return bool(jnp.all(jnp.isfinite(jnp.asarray(x, jnp.float32))))


# ---------------------------------------------------------------- phase 1
def phase_device(n_devices=1):
    """Fail unless JAX runs on a GPU; print what it runs on."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU: JAX backend is {backend!r}")
    devs = jax.devices()
    check(len(devs) >= n_devices, f"{n_devices} devices wanted, {len(devs)} found")
    cards = bench.card_info()
    say(
        f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)} jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={bench.compile_cache_dir()}"
    )
    for line in cards:  # name, power limit as nvidia-smi prints them
        say(line)
    return devs, cards


# ---------------------------------------------------------------- phase 2
def logreg_reference(P, X, y, prior_var):
    """float64 NumPy value and gradient of the logreg log-density."""
    from scipy.special import expit

    P, X, y = (np.asarray(a, np.float64) for a in (P, X, y))
    z = P @ X.T
    d = X.shape[1]
    value = (
        z @ y
        - np.logaddexp(0.0, z).sum(axis=-1)
        - 0.5 * np.sum(P * P, axis=-1) / prior_var
        - 0.5 * d * np.log(2.0 * np.pi * prior_var)
    )
    grad = (y - expit(z)) @ X - P / prior_var
    return value, grad


def relative_errors(value, grad, ref_value, ref_grad):
    """Largest per-chain relative error of the value and of the gradient
    (2-norm over coordinates)."""
    value = np.asarray(value, np.float64)
    grad = np.asarray(grad, np.float64)
    ev = np.max(np.abs(value - ref_value) / np.abs(ref_value))
    eg = np.max(
        np.linalg.norm(grad - ref_grad, axis=-1) / np.linalg.norm(ref_grad, axis=-1)
    )
    return float(ev), float(eg)


def phase_target(sizes, cards=(), reps=20):
    """The main path's batched value+grad (vmap over the fused per-chain
    target) against a float64 reference, at each matmul precision."""
    target, X, y = synthetic_logistic_regression(dim=bench.DIM, n_data=bench.N_DATA)
    rng = np.random.default_rng(7)
    P = (0.3 * rng.standard_normal((sizes.chains, bench.DIM))).astype(np.float32)
    ref_v, ref_g = logreg_reference(P, X, y, 100.0)
    P_dev = jnp.asarray(P)
    card = "; ".join(cards) or jax.devices()[0].device_kind
    out = {}
    for precision in PRECISIONS:
        with bench.precision_context(precision):
            f = jax.jit(jax.vmap(target.logdensity_and_grad))
            (v, g), ms = time_ms(f, P_dev, reps)
        ev, eg = relative_errors(v, g, ref_v, ref_g)
        err = max(ev, eg)
        tol = TOL_F32 if precision == "f32" else TOL_TF32
        gave = "float32-level" if err <= TOL_F32 else "tf32-level"
        say(
            f"target[{precision}]: C={sizes.chains} N={bench.N_DATA} "
            f"D={bench.DIM} max rel err value={ev:.3e} grad={eg:.3e} "
            f"tol={tol:.0e} card gave {gave}; value+grad {ms:.4f} ms on {card}"
        )
        check(err <= tol, f"target[{precision}] rel err {err:.3e} > {tol:.0e}")
        out[precision] = dict(value_err=ev, grad_err=eg, ms=ms)
    return out


# ---------------------------------------------------------------- phase 3-5
def _case(case, sizes, **kw):
    return bench.build_case(
        case, sizes.chains, sizes.burnin + sizes.post, sizes.burnin, **kw
    )


def _leaps_per_step(chain, diag):
    return float(np.mean(np.asarray(chain[diag], np.float64)))


def phase_chees(sizes):
    """bench.py's 'chees' case through run_phased, called twice."""
    job, x0, _, _ = _case("chees", sizes)
    with bench.precision_context(PRECISION):
        t0 = time.perf_counter()
        chain, _ = job.run_phased(jax.random.key(0), x0)
        jax.block_until_ready(chain.value)
        first = time.perf_counter() - t0
        del chain
        t0 = time.perf_counter()
        chain, tm = job.run_phased(jax.random.key(1), x0)
        jax.block_until_ready(chain.value)
        second = time.perf_counter() - t0
    check(all_finite(chain.value), "chees: non-finite draws")
    accept = float(kt.stats.acceptance(chain))
    fs = chain.final_state
    eps = float(jnp.mean(fs.tune.step))
    lam = float(jnp.exp(jnp.mean(fs.log_traj)))
    rhat = bench.rhat_max(chain.value)
    stats = mean_and_mcse(chain.value)
    say(
        f"chees: chains={sizes.chains} post={sizes.post} precision={PRECISION} "
        f"accept={accept:.4f} (target {ACCEPT_TARGET}+-{ACCEPT_TOL}) "
        f"eps={eps:.5f} lambda={lam:.4f} rhat_max={rhat:.4f} "
        f"leaps/step={_leaps_per_step(chain, 'nleaps'):.2f} "
        f"first_call_s={first:.2f} second_call_s={second:.2f} "
        f"(warmup {tm['warmup_seconds']:.2f} + sampling "
        f"{tm['sampling_seconds']:.2f}) peak_bytes={peak_bytes()}"
    )
    check(abs(accept - ACCEPT_TARGET) <= ACCEPT_TOL,
          f"chees: pooled acceptance {accept:.4f} not within {ACCEPT_TOL} of "
          f"{ACCEPT_TARGET}")
    return dict(stats=stats, eps=eps, lam=lam, accept=accept)


def _memory_line(job, chain):
    """compiled.memory_analysis() of the job's sampling-phase program."""
    keys = jax.random.split(jax.random.key(0), job.n_chains)
    ma = job._sample_jit.lower(chain.final_state, keys).compile().memory_analysis()
    if ma is None:
        return "memory_analysis=None"
    return (
        f"memory_analysis(arg={ma.argument_size_in_bytes} "
        f"out={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} "
        f"alias={ma.alias_size_in_bytes})"
    )


def phase_precond(sizes, reference):
    """run_preconditioned for both headline cases; means against phase 3."""
    out = {}
    for case in ("chees_precond", "nuts_precond"):
        job, x0, repl, leap_diag = _case(case, sizes)
        with bench.precision_context(PRECISION):
            t0 = time.perf_counter()
            chain, tm, info = job.run_preconditioned(
                jax.random.key(2), x0, stage2_replace=repl
            )
            jax.block_until_ready(chain.value)
            call = time.perf_counter() - t0
            mem = _memory_line(info["whitened_job"], chain)
        check(all_finite(chain.value), f"{case}: non-finite draws")
        check(not bool(jnp.any(jnp.isnan(info["chol"]))), f"{case}: NaN in Cholesky")
        stats = mean_and_mcse(chain.value)
        z = agreement(stats, reference)
        say(
            f"{case}: chains={sizes.chains} post={sizes.post} "
            f"accept={float(kt.stats.acceptance(chain)):.4f} "
            f"eps={float(jnp.mean(chain.final_state.tune.step)):.5f} "
            f"leaps/step={_leaps_per_step(chain, leap_diag):.2f} "
            f"mean vs chees: max|diff|/mcse={z:.2f} (limit {AGREE_K}) "
            f"call_s={call:.2f} (stage 2 compiles per call; warmup "
            f"{tm['warmup_seconds']:.2f} + sampling {tm['sampling_seconds']:.2f}) "
            f"peak_bytes={peak_bytes()} stage-2 {mem}"
        )
        check(z <= AGREE_K, f"{case}: mean disagrees with chees ({z:.2f} mcse)")
        out[case] = dict(stats=stats, z=z)
    return out


def phase_nuts(sizes, reference):
    """Raw NUTS (static tree, depth 5) through run_phased, called twice."""
    job, x0, _, _ = _case("nuts", sizes, max_doublings=5)
    with bench.precision_context(PRECISION):
        t0 = time.perf_counter()
        chain, _ = job.run_phased(jax.random.key(0), x0)
        jax.block_until_ready(chain.value)
        first = time.perf_counter() - t0
        del chain
        t0 = time.perf_counter()
        chain, tm = job.run_phased(jax.random.key(3), x0)
        jax.block_until_ready(chain.value)
        second = time.perf_counter() - t0
    check(all_finite(chain.value), "nuts: non-finite draws")
    stats = mean_and_mcse(chain.value)
    z = agreement(stats, reference)
    say(
        f"nuts: chains={sizes.chains} post={sizes.post} max_doublings=5 "
        f"tree={'static' if job.sampler._use_static() else 'looped'} "
        f"mean leaves/step={_leaps_per_step(chain, 'na'):.2f} "
        f"eps={float(jnp.mean(chain.final_state.tune.step)):.5f} "
        f"mean vs chees: max|diff|/mcse={z:.2f} (limit {AGREE_K}) "
        f"first_call_s={first:.2f} second_call_s={second:.2f} "
        f"(warmup {tm['warmup_seconds']:.2f} + sampling "
        f"{tm['sampling_seconds']:.2f}) peak_bytes={peak_bytes()}"
    )
    check(z <= AGREE_K, f"nuts: mean disagrees with chees ({z:.2f} mcse)")
    return dict(stats=stats, z=z)


# ---------------------------------------------------------------- phase 6
def _gibbs_job(sizes, mesh=None):
    model, v0 = rats_gibbs_model()
    job = kt.GibbsJob(
        model, {},
        kt.MCRange(n_steps=sizes.gibbs_steps, burnin=sizes.gibbs_burnin),
        n_chains=sizes.gibbs_chains, monitor=RATS_MONITOR, mesh=mesh,
    )
    return job, v0


def _gibbs_stats(chains):
    return {k: mean_and_mcse(chains.samples[k][:, :, None]) for k in RATS_MONITOR}


def phase_gibbs(sizes):
    job, v0 = _gibbs_job(sizes)
    t0 = time.perf_counter()
    jax.block_until_ready(job.run(jax.random.key(0), v0).samples)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    chains = job.run(jax.random.key(4), v0)
    jax.block_until_ready(chains.samples)
    second = time.perf_counter() - t0
    for k in RATS_MONITOR:
        check(all_finite(chains.samples[k]), f"gibbs: non-finite {k}")
    means = {k: float(jnp.mean(chains.samples[k].astype(jnp.float32)))
             for k in RATS_MONITOR}
    rhat = max(bench.rhat_max(chains.samples[k][:, :, None]) for k in RATS_MONITOR)
    say(
        f"gibbs: rats chains={sizes.gibbs_chains} sweeps={sizes.gibbs_steps} "
        f"alpha_c={means['alpha_c']:.3f} (BUGS 242.5+-3.0) "
        f"beta_c={means['beta_c']:.4f} (BUGS 6.19+-0.15) "
        f"sigma2_c={means['sigma2_c']:.2f} rhat_max(5 hyper)={rhat:.4f} "
        f"first_call_s={first:.2f} second_call_s={second:.2f} "
        f"peak_bytes={peak_bytes()}"
    )
    for k, (ref, tol) in RATS_BUGS.items():
        check(abs(means[k] - ref) <= tol,
              f"gibbs: {k} mean {means[k]:.4f} not within {tol} of {ref}")
    return dict(means=means, rhat=rhat, stats=_gibbs_stats(chains))


# ---------------------------------------------------------------- phase 7
def phase_examples(only=None):
    """Every asserted example, in this process; any failure raises."""
    examples_dir = os.path.join(REPO, "examples")
    if examples_dir not in sys.path:
        sys.path.insert(0, examples_dir)
    from run_examples import build_registry

    registry, import_errors = build_registry()
    check(not import_errors, f"examples failed to import: {sorted(import_errors)}")
    names = [n for n in registry if only is None or n in only]
    t_suite = time.perf_counter()
    slowest = (0.0, None)
    for name in names:
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                registry[name]()
        except BaseException:
            sys.stdout.write(buf.getvalue()[-2000:])
            say(f"examples: {name} FAILED")
            raise
        slowest = max(slowest, (time.perf_counter() - t0, name))
    secs = time.perf_counter() - t_suite
    say(
        f"examples: {len(names)}/{len(names)} passed in {secs:.1f}s "
        f"(slowest {slowest[1]} {slowest[0]:.1f}s) peak_bytes={peak_bytes()}"
    )
    return len(names)


# ---------------------------------------------------------------- phase 8
def phase_io(sizes):
    """csv streaming via io_callback against the in-memory trace, and a
    checkpoint round trip: resuming from the restored state must equal
    resuming from the state that never left the device."""
    from klara_tpu.io import load_checkpoint, read_chain, save_checkpoint

    target, _, _ = synthetic_logistic_regression(dim=bench.DIM, n_data=bench.N_DATA)
    kwargs = dict(
        target=target,
        sampler=kt.MH(sigma=0.02),
        mcrange=kt.MCRange(n_steps=sizes.io_steps, burnin=sizes.io_steps // 2),
        n_chains=sizes.io_chains,
        monitor=("value",),
        diagnostics=("accept",),
    )
    x0 = jnp.zeros(bench.DIM)
    ref = kt.MCJob(**kwargs).run(jax.random.key(5), x0)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        streamed = kt.MCJob(
            **kwargs, destination="csv", filepath=os.path.join(d, "csv"),
            stream_chunk=64,
        )
        assert streamed.stream_mode == "io_callback"
        final = streamed.run(jax.random.key(5), x0)
        csv_s = time.perf_counter() - t0
        back = read_chain(os.path.join(d, "csv"))
        check(back.samples["value"].shape == ref.samples["value"].shape,
              f"io: csv shape {back.samples['value'].shape}")
        np.testing.assert_allclose(
            back.samples["value"], np.asarray(ref.samples["value"]), rtol=2e-7
        )
        np.testing.assert_array_equal(
            np.asarray(final.final_state.position),
            np.asarray(ref.final_state.position),
        )

        job, x0c, _, _ = bench.build_case(
            "hmc", sizes.chains, sizes.io_steps, sizes.io_steps // 2
        )
        chain = job.run(jax.random.key(6), x0c)
        path = os.path.join(d, "state.npz")
        t0 = time.perf_counter()
        save_checkpoint(path, chain.final_state)
        restored = load_checkpoint(path, like=chain.final_state)
        ckpt_s = time.perf_counter() - t0
        resumed = job.resume(
            jax.random.key(7), dataclasses.replace(chain, final_state=restored)
        )
        direct = job.resume(jax.random.key(7), chain)
        np.testing.assert_array_equal(
            np.asarray(resumed.value), np.asarray(direct.value)
        )
        np.testing.assert_array_equal(
            np.asarray(resumed.final_state.position),
            np.asarray(direct.final_state.position),
        )
        check(all_finite(resumed.value), "io: non-finite resumed draws")
    say(
        f"io: csv io_callback chains={sizes.io_chains} steps={sizes.io_steps} "
        f"matches in-memory trace (run {csv_s:.2f}s); checkpoint "
        f"chains={sizes.chains} save+load {ckpt_s:.2f}s, resumed chain equals "
        f"the in-memory resume bit for bit; peak_bytes={peak_bytes()}"
    )


# ---------------------------------------------------------------- 4 cards
def _sharding_line(name, arr, n_devices):
    devs = arr.sharding.device_set
    check(len(devs) == n_devices,
          f"{name} sits on {len(devs)} devices, not {n_devices}")
    return f"{name}.sharding={arr.sharding} on {len(devs)} devices"


def sharded_phases(sizes, n_devices):
    """The chain-sharded jobs, each against the same job on one card."""
    mesh = kt.parallel.chain_mesh(n_devices)

    # (a) HMC + ChEES, pooled dual averaging + ensemble mass over the mesh
    job1, x0, _, _ = _case("chees", sizes)
    jobn = dataclasses.replace(job1, mesh=mesh)
    with bench.precision_context(PRECISION):
        one, _ = job1.run_phased(jax.random.key(1), x0)
        t0 = time.perf_counter()
        many, _ = jobn.run_phased(jax.random.key(1), x0)
        jax.block_until_ready(many.value)
        secs = time.perf_counter() - t0
    s_one, sn = mean_and_mcse(one.value), mean_and_mcse(many.value)
    z = agreement(s_one, sn)
    e1 = float(jnp.mean(one.final_state.tune.step))
    en = float(jnp.mean(many.final_state.tune.step))
    del one
    say(
        f"sharded chees: {n_devices} devices chains={sizes.chains} "
        f"eps={en:.5f} vs one card {e1:.5f} (rtol {EPS_RTOL}) "
        f"mean max|diff|/mcse={z:.2f} (limit {AGREE_K}) call_s={secs:.2f}; "
        f"{_sharding_line('value', many.value, n_devices)}; "
        f"{_sharding_line('position', many.final_state.position, n_devices)}"
    )
    check(all_finite(many.value), "sharded chees: non-finite draws")
    check(abs(en / e1 - 1.0) <= EPS_RTOL, "sharded chees: pooled eps differs")
    check(z <= AGREE_K, f"sharded chees: mean disagrees ({z:.2f} mcse)")

    # (b) run_preconditioned with chains sharded: the ensemble covariance
    # becomes a cross-device reduction
    job1, x0, repl, _ = _case("chees_precond", sizes)
    jobn = dataclasses.replace(job1, mesh=mesh)
    with bench.precision_context(PRECISION):
        one, _, _ = job1.run_preconditioned(jax.random.key(2), x0, stage2_replace=repl)
        t0 = time.perf_counter()
        many, _, info = jobn.run_preconditioned(
            jax.random.key(2), x0, stage2_replace=repl
        )
        jax.block_until_ready(many.value)
        secs = time.perf_counter() - t0
    check(all_finite(many.value), "sharded precond: non-finite draws")
    check(not bool(jnp.any(jnp.isnan(info["chol"]))), "sharded precond: NaN chol")
    z = agreement(mean_and_mcse(one.value), mean_and_mcse(many.value))
    say(
        f"sharded chees_precond: {n_devices} devices chains={sizes.chains} "
        f"mean max|diff|/mcse={z:.2f} (limit {AGREE_K}) call_s={secs:.2f}; "
        f"{_sharding_line('value', many.value, n_devices)}; "
        f"chol.sharding={info['chol'].sharding}"
    )
    check(z <= AGREE_K, f"sharded precond: mean disagrees ({z:.2f} mcse)")

    # (c) the rats GibbsJob with chains sharded
    job1, v0 = _gibbs_job(sizes)
    jobn, _ = _gibbs_job(sizes, mesh=mesh)
    one = job1.run(jax.random.key(4), v0)
    t0 = time.perf_counter()
    many = jobn.run(jax.random.key(4), v0)
    jax.block_until_ready(many.samples)
    secs = time.perf_counter() - t0
    s1, sn = _gibbs_stats(one), _gibbs_stats(many)
    z = max(agreement(s1[k], sn[k]) for k in RATS_MONITOR)
    say(
        f"sharded gibbs: {n_devices} devices chains={sizes.gibbs_chains} "
        f"hyper means max|diff|/mcse={z:.2f} (limit {AGREE_K}) "
        f"call_s={secs:.2f}; "
        f"{_sharding_line('alpha_c', many.samples['alpha_c'], n_devices)}"
    )
    check(z <= AGREE_K, f"sharded gibbs: means disagree ({z:.2f} mcse)")

    # (d) parameter-sharded logreg target on a 2x2 (chains, param) mesh,
    # against (a)'s run of the plain target on one card; first its batched
    # value+grad against the main-path target's at the job's precision
    if n_devices == 4:
        target1, X, y = synthetic_logistic_regression(
            dim=bench.DIM, n_data=bench.N_DATA
        )
        mesh2 = kt.parallel.mesh2d(2, 2)
        job1, x0, _, _ = _case("chees", sizes)
        target = kt.parallel.param_sharded_logreg_target(X, y, mesh2)
        P2 = jax.device_put(x0, NamedSharding(mesh2, PartitionSpec("chains", None)))
        with bench.precision_context(PRECISION):
            v1, g1 = jax.jit(jax.vmap(target1.logdensity_and_grad))(x0)
            (v, g), ms = time_ms(jax.jit(jax.vmap(target.logdensity_and_grad)), P2, 10)
        ev, eg = relative_errors(v, g, np.asarray(v1, np.float64), np.asarray(g1, np.float64))
        say(
            f"param-sharded value+grad: mesh2d(2, 2) C={sizes.chains} "
            f"N={bench.N_DATA} D={bench.DIM} precision={PRECISION} vs the "
            f"main-path target: max rel err value={ev:.3e} grad={eg:.3e} "
            f"(tol {TOL_TF32:.0e}); {ms:.4f} ms"
        )
        check(max(ev, eg) <= TOL_TF32, "param-sharded: value+grad disagrees")
        jobp = dataclasses.replace(job1, mesh=mesh2, target=target)
        with bench.precision_context(PRECISION):
            t0 = time.perf_counter()
            many, _ = jobp.run_phased(jax.random.key(1), x0)
            jax.block_until_ready(many.value)
            secs = time.perf_counter() - t0
        check(all_finite(many.value), "param-sharded: non-finite draws")
        z = agreement(s_one, mean_and_mcse(many.value))
        en = float(jnp.mean(many.final_state.tune.step))
        say(
            f"param-sharded logreg: mesh2d(2, 2) chains={sizes.chains} "
            f"eps={en:.5f} vs one card {e1:.5f} mean max|diff|/mcse={z:.2f} "
            f"(limit {AGREE_K}) call_s={secs:.2f}; "
            f"{_sharding_line('value', many.value, n_devices)}"
        )
        check(abs(en / e1 - 1.0) <= EPS_RTOL, "param-sharded: pooled eps differs")
        check(z <= AGREE_K, f"param-sharded: mean disagrees ({z:.2f} mcse)")


# ---------------------------------------------------------------- main
def run_one_card(sizes, cards, only_examples=None):
    phase_target(sizes, cards)
    reference = phase_chees(sizes)["stats"]
    phase_precond(sizes, reference)
    phase_nuts(sizes, reference)
    phase_gibbs(sizes)
    phase_examples(only_examples)
    phase_io(sizes)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the chain-sharded path on four cards")
    args = ap.parse_args(argv)

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    jax.config.update("jax_compilation_cache_dir", bench.compile_cache_dir())
    devs, cards = phase_device(args.devices)
    sizes = Sizes()
    if args.devices == 1:
        run_one_card(sizes, cards)
    else:
        sharded_phases(sizes, args.devices)
    say(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
