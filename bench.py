"""Headline benchmark: effective samples/sec per GPU, warmup timed apart.

Workload (BASELINE.json north star + scale config): HMC (fixed and
ChEES-adapted trajectory) and NUTS on 100-dim Bayesian logistic
regression, vectorized chains on one device, with the full warmup stack
on:

  * pooled dual averaging (cross-chain acceptance statistic -> one shared
    step size, from one shared pooled Alg-4 init; under a mesh this is
    the psum collective path),
  * fixed trajectory length: nleaps = round(lambda/eps) per iteration
    (reference src/samplers/iterate/HMC.jl:142-144) — or cross-chain
    ChEES adaptation of lambda with a SHARED per-step trajectory jitter
    (jobs.MCJob traj_adaptation + HMC.jitter_style='step'),
  * ensemble mass-matrix adaptation (cross-chain variance -> diagonal
    inverse mass).

Metric: min-across-coordinates effective sample size (Geyer IMSE, summed
over chains, computed in chain-chunks to bound FFT memory) divided by the
SAMPLING-phase wall time (MCJob.run_phased) — warmup is real cost but
amortises over however many draws follow, so it is timed and reported
separately (warmup_seconds per case).  No number here is measured on the
H100 yet; ROADMAP A0 turns this file into the H100 benchmark.

Device: every row names the platform, device kind, device count and each
card's name and power limit (``nvidia-smi``).  A child that finds no GPU
fails instead of falling back to the CPU, unless ``JAX_PLATFORMS=cpu``
was set explicitly (the CPU rehearsal tests/test_bench_smoke.py drives).

One process per card: every case runs in its own subprocess, one at a
time, and the parent never imports JAX (a JAX process reserves most of
the card's memory, so a second one on the same card would fail).  All
subprocesses share the persistent compilation cache
(``$JAX_COMPILATION_CACHE_DIR``, else ``<repo>/.jax_cache``); the
single-chain baseline runs FIRST.

FLOPs: leapfrog FLOPs are computed analytically (one fused value+grad of
the logreg target = 2 matmuls = 4*N_DATA*DIM flops per chain-leap; leap
counts from the recorded nleaps/na diagnostics) and reported as achieved
TFLOP/s.  A peak table keyed by device kind is ROADMAP A0's.

Precision rows (hmc_high / hmc_f32 vs the default): matmul precision
changes the noise in the log-density, which changes |dH| and hence the
step size dual averaging settles on — a statistical effect, not only a
numeric one.  What 'default' and 'high' mean on the H100 (TF32 or full
float32) is what chip_smoke.py's target phase reports; the effect on
ESS/s is not measured there yet (ROADMAP A3).

The overall headline candidates are chees_precond and nuts_precond: dense
ensemble preconditioning (MCJob.run_preconditioned) whitens by the
end-of-warmup ensemble Cholesky, so stage 2 runs with a pinned lambda=2
(ChEES) or depth-3 NUTS trees.

vs_baseline: the reference (Klara.jl) publishes no numbers and runs ONE
chain at a time, single-threaded (src/jobs/jobs.jl:212).  The recorded
baseline is this framework's own single-chain sampling throughput on the
same device — vs_baseline = speedup over the reference's execution model.

Mixing gate: every multi-chain case row carries ``rhat_max`` — the
cross-chain rank-normalised split-R-hat (Vehtari et al. 2021) maximised
over coordinates, computed on up to 512 evenly-thinned draws.  When the
gate is active (n_chains >= 32 and >= 200 post draws) a case with
rhat_max > 1.02 reports ess_per_sec = 0 and an error field: raw draw
throughput with broken mixing is not effective-sample throughput.

Capture-proofing: a driver may parse a JSON line from a bounded tail of
stdout, so every emission, including the final one, is a COMPACT
headline line (hard-capped < 1500 chars: metric/value/unit/vs_baseline +
a per-case ess_per_sec map); the full per-case detail goes to
BENCH_DETAIL.json (atomic rewrite per case, so a mid-run kill keeps
everything completed so far).  A global wall budget (``--wall-budget`` /
env ``BENCH_WALL_BUDGET_S``, default 3300s) bounds the whole run:
per-case timeouts shrink to the remaining budget and cases that no
longer fit are recorded as skipped.  SIGTERM re-emits the current
compact line before exiting.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DIM = 100
N_DATA = 1024
LAMBDA = 1.9  # fixed HMC trajectory length

# Case sizes are env-overridable so the interruption self-test can drive
# the REAL parent orchestration at toy scale on CPU (tests/test_bench_smoke).
N_STEPS = int(os.environ.get("BENCH_STEPS", 700))
BURNIN = int(os.environ.get("BENCH_BURNIN", 300))
HEADLINE_CHAINS = int(os.environ.get("BENCH_HEADLINE_CHAINS", 16384))
# Post-burnin window for the PRECONDITIONED headline cases, long enough
# that the timed sampling phase is seconds (per-dispatch overhead and
# timer noise are a material fraction of a sub-second window).  This is
# the <=8k-chain window; the 16k-chain rung halves it (the ESS pass
# back-transforms from the whitened space per chain-chunk instead of
# materialising a second full x-space buffer).
HEADLINE_POST = int(os.environ.get("BENCH_HEADLINE_POST", 4000))
# Post-burnin window for the SLOW-MIXING rows (fixed-lambda HMC, raw
# NUTS): stored at thinning 2 so split-R-hat can certify (see the
# mixing-gate note) while the trace stays bounded.  Env-overridable so
# the interruption self-test can drive these rows at toy scale too.
LONG_POST = int(os.environ.get("BENCH_LONG_POST", 2400))
CHAIN_SWEEP = tuple(
    int(s) for s in os.environ.get("BENCH_SWEEP", "2048,4096,8192,16384").split(",")
)
NUTS_ATTEMPTS = tuple(
    (int(s), 5) for s in os.environ.get(
        "BENCH_NUTS_CHAINS", "16384,8192,4096,1024").split(",")
)
GIBBS_CHAINS = int(os.environ.get("BENCH_GIBBS_CHAINS", 4096))
GIBBS_STEPS = int(os.environ.get("BENCH_GIBBS_STEPS", 30000))
GIBBS_BURNIN = int(os.environ.get("BENCH_GIBBS_BURNIN", 500))
# Mixing gate (see docstring): active for real-scale cases only — at toy
# smoke-test scale (a handful of chains / ~100 draws) rank-R-hat noise
# alone can exceed any honest threshold.
RHAT_GATE = float(os.environ.get("BENCH_RHAT_GATE", 1.02))
DETAIL_PATH = os.environ.get(
    "BENCH_DETAIL_PATH", os.path.join(REPO, "BENCH_DETAIL.json")
)
MAX_LINE = 1500  # hard cap on every emitted stdout line (driver tail capture)


def compile_cache_dir(environ=os.environ):
    """Where compiled programs are cached: ``$JAX_COMPILATION_CACHE_DIR``
    when set, else the fixed ``<repo>/.jax_cache`` (listed in .gitignore;
    a fixed path, because the path is part of the cache key)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO, ".jax_cache"
    )


def _child_env():
    env = dict(os.environ)
    env["JAX_COMPILATION_CACHE_DIR"] = compile_cache_dir(env)
    env.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
    return env


def card_info():
    """Each card's name and power limit, one ``'name, limit'`` line per card
    as ``nvidia-smi`` prints them (empty without nvidia-smi).  Runs in a
    child process that never touches JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_fields():
    """Device identity carried by every bench row.  Raises when JAX found
    no GPU, unless ``JAX_PLATFORMS=cpu`` was set explicitly (the CPU
    rehearsal the tests drive), so a CPU timing never stands under a
    device's name."""
    import jax

    platform = jax.default_backend()
    if platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise RuntimeError(
            f"no GPU found (JAX backend {platform!r}); set JAX_PLATFORMS=cpu "
            "explicitly for a CPU rehearsal"
        )
    devs = jax.devices()
    return {
        "platform": platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card_info(),
    }


# ======================================================================
# child mode: run ONE case in this process, print one JSON line
# ======================================================================

def _ess_min_chunked(values, chunk=2048, chol=None):
    """min-over-dims of cross-chain-summed ESS, chunked over chains so the
    FFT autocovariance never materialises the full (nfft, 16k, 100) array.

    ``chol``: optional Cholesky factor when ``values`` is a WHITENED trace
    (run_preconditioned(back_transform=False)) — each chain-chunk is
    mapped back to x-space (x = y @ L.T) inside the jitted ESS call, so
    the full x-space trace is never materialised."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    import klara_tpu as kt

    if chol is None:
        f = jax.jit(lambda v: kt.stats.ess(v.astype(jnp.float32)))
    else:
        f = jax.jit(
            lambda v: kt.stats.ess(
                jnp.einsum("tcd,ed->tce", v.astype(jnp.float32), chol)
            )
        )
    total = None
    for s in range(0, values.shape[1], chunk):
        e = np.asarray(f(values[:, s : s + chunk]))
        total = e if total is None else total + e
    return float(np.min(total))


def rhat_max(values, chol=None, max_draws=512, dim_chunk=16,
              chains_cap=2048):
    """Max-over-coordinates rank-normalised split-R-hat of a (draws,
    chains, dim) trace, on up to ``max_draws`` evenly-thinned draws of
    up to ``chains_cap`` chains (thinned draws share the stationary
    distribution and 2k chains are ample for a convergence gate, while
    a strided gather over the full multi-GB scan-layout buffer forces a
    layout-normalising copy of all of it).  ``chol``
    back-transforms a whitened trace per DIM-chunk — each x coordinate
    needs all y dims, so chunking runs over output dims."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    import klara_tpu as kt

    values = values[:, :chains_cap]  # contiguous slice: no layout copy
    step = max(1, values.shape[0] // max_draws)
    dim = 1 if values.ndim == 2 else values.shape[-1]
    dim_chunk = min(dim_chunk, dim)

    def _prep(x):
        # thin + lift + cast INSIDE jit: an eager strided gather on a
        # multi-GB device trace materialises transposed copies of the
        # whole buffer
        x = x[::step]
        if x.ndim == 2:
            x = x[:, :, None]
        return x.astype(jnp.float32)

    if values.ndim == 2:  # (draws, chains) scalar marginal
        g = jax.jit(lambda x: jnp.max(kt.stats.rhat_rank(_prep(x))))
        return float(np.asarray(g(values)))
    if chol is None:
        # s is a TRACED operand (dynamic_slice clamps the final chunk's
        # start, harmlessly re-checking a few dims under a max): ONE
        # compiled program for all chunks, not one per offset
        f = jax.jit(
            lambda x, s: jnp.max(
                kt.stats.rhat_rank(
                    _prep(jax.lax.dynamic_slice_in_dim(x, s, dim_chunk, 2))
                )
            )
        )
        chunks = [f(values, s) for s in range(0, dim, dim_chunk)]
    else:
        f = jax.jit(
            lambda x, rows: jnp.max(
                kt.stats.rhat_rank(jnp.einsum("tcd,ed->tce", _prep(x), rows))
            )
        )
        chunks = [f(values, chol[s : s + dim_chunk]) for s in range(0, dim, dim_chunk)]
    return float(np.max(np.asarray([np.asarray(c) for c in chunks])))


def _apply_rhat_gate(out, values, n_chains, n_post, chol=None, rhat=None):
    """Record rhat_max on the row; zero the row's ESS/s if the mixing
    gate is active and fails (a regression that broke mixing must not
    post a plausible ESS/s through the chunked Geyer estimator).
    ``rhat``: precomputed max (e.g. the gibbs case's max over marginals)
    instead of computing it from ``values`` here."""
    out["rhat_max"] = round(
        rhat_max(values, chol=chol) if rhat is None else rhat, 4
    )
    if n_chains >= 32 and n_post >= 200 and out["rhat_max"] > RHAT_GATE:
        out["ess_per_sec_ungated"] = out["ess_per_sec"]
        out["ess_per_sec"] = 0.0
        out["error"] = (
            f"mixing gate: rhat_max {out['rhat_max']} > {RHAT_GATE}"
        )
    return out


def build_case(case, n_chains, n_steps, burnin, lam=LAMBDA, max_doublings=5,
               thinning=1):
    """The job of one logreg case as the bench configures it.

    Returns ``(job, x0, stage2_replace, leap_diag)``: ``stage2_replace`` is
    the whitened-stage override for the ``*_precond`` cases (None
    otherwise) and ``leap_diag`` names the diagnostic that counts leapfrog
    steps.  ``chip_smoke.py`` drives the same jobs."""
    import jax
    import jax.numpy as jnp

    import klara_tpu as kt
    from klara_tpu.models.examples import synthetic_logistic_regression

    target, _, _ = synthetic_logistic_regression(dim=DIM, n_data=N_DATA)
    extra = {}
    leap_diag = "nleaps"
    if case in ("hmc", "baseline"):
        sampler = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=lam,
                         max_nleaps=128)
    elif case in ("chees", "chees_precond"):
        # cross-chain ChEES trajectory adaptation with a SHARED per-step
        # jitter draw (all chains run the same trip count per iteration);
        # 'chees_precond' additionally runs the two-stage dense ensemble
        # preconditioner (MCJob.run_preconditioned): whitened-space
        # trajectories shorten several-fold (leaps/draw ~70 -> ~8 on the
        # 100-dim logreg)
        sampler = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=0.5,
                         jitter=0.9, jitter_style="step", max_nleaps=256)
        extra = dict(traj_adaptation=True)
    elif case == "nuts":
        sampler = kt.NUTS(max_doublings=max_doublings)
        leap_diag = "na"
    elif case == "nuts_precond":
        # stage 1 = ChEES HMC warmup (covariance estimation), stage 2 =
        # whitened NUTS: trees need only ~5 leaps after whitening, so
        # depth-3 trees (7 leaves) suffice
        sampler = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=0.5,
                         jitter=0.9, jitter_style="step", max_nleaps=256)
        extra = dict(traj_adaptation=True)
        leap_diag = "na"
    else:
        raise ValueError(case)

    # the JOB's diagnostics must match its (stage-1) sampler; for
    # nuts_precond the final chain's 'na' channel comes from the stage-2
    # replace below, while stage 1 is HMC and records 'nleaps'
    job_diag = "nleaps" if case == "nuts_precond" else leap_diag
    # long-window trace storage: past 4 GB the (stored, chains, dim) trace
    # is kept in bf16 (MCJob.trace_dtype; the sampling kernel stays f32,
    # only the saved copy rounds, ~0.4% relative, far below MC noise).
    # For slow-mixing cases (raw NUTS) the parent also passes thinning > 1:
    # storing every k-th step bounds the memory AND cuts per-stored-draw
    # autocorrelation so the R-hat gate certifies at realistic window
    # lengths (split-R-hat reads sqrt(1 + 2*IACT/n) at stationarity).
    n_stored = (n_steps - burnin - 1) // thinning + 1
    trace_dtype = (
        "bfloat16" if n_stored * n_chains * DIM * 4 > 4e9 else None
    )
    job = kt.MCJob(
        target,
        sampler,
        kt.MCRange(n_steps=n_steps, burnin=burnin, thinning=thinning),
        tuner=kt.DualAveragingTuner(0.8, burnin),
        n_chains=n_chains,
        monitor=("value",),
        diagnostics=("accept", job_diag),
        pooled_tuning=True,
        mass_adaptation=n_chains >= 32,
        mass_period=50,
        trace_dtype=trace_dtype,
        **extra,
    )
    x0 = 0.1 * jax.random.normal(jax.random.key(42), (n_chains, DIM), jnp.float32)

    repl = None
    if case == "chees_precond":
        # stage 2 runs in the whitened (~unit isotropic) space, where the
        # optimal trajectory is known: pin it instead of re-running ChEES
        # there — lambda adaptation in whitened space is noisy (3 to 7+
        # run-to-run) and the noise only costs leaps.  lambda = 2.0 was the
        # best of a 1.5/2.0/2.5/3.0 sweep; not re-swept on the H100.
        s2 = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=2.0,
                    jitter=0.9, jitter_style="step", max_nleaps=64)
        repl = dict(sampler=s2, traj_adaptation=False)
    elif case == "nuts_precond":
        repl = dict(
            sampler=kt.NUTS(max_doublings=3),
            traj_adaptation=False,
            diagnostics=("accept", "na"),
        )
    return job, x0, repl, leap_diag


def precision_context(precision):
    """Matmul-precision context of a bench row: 'default' leaves XLA's
    default (which may run f32 matmuls as TF32 on the GPU), 'high' and
    'f32' set ``jax.default_matmul_precision``; chip_smoke.py's target
    phase measures what each gives on the card."""
    import jax

    if precision == "f32":
        return jax.default_matmul_precision("float32")
    if precision == "high":
        return jax.default_matmul_precision("high")
    return contextlib.nullcontext()


def run_case(case, n_chains, n_steps, burnin, lam, max_doublings, precision,
             thinning=1):
    import numpy as np
    import jax

    import klara_tpu as kt

    job, x0, repl, leap_diag = build_case(
        case, n_chains, n_steps, burnin, lam=lam, max_doublings=max_doublings,
        thinning=thinning,
    )
    trace_dtype = job.trace_dtype
    with precision_context(precision):
        print(f"# {case} x{n_chains}: compiling+warm...", file=sys.stderr, flush=True)
        chol = None
        if repl is not None:
            # throwaway full run first so the TIMED run's warmup_seconds
            # excludes stage-1 trace/compile, matching how every other
            # case's warmup is reported (warm_stage2 covers stage 2,
            # whose Cholesky-specific program is fresh per call anyway).
            # back_transform=False: keep the trace in whitened y-space and
            # map chunks to x inside the ESS/R-hat passes, so no second
            # full x-space trace buffer is allocated.
            warm, _, _ = job.run_preconditioned(
                jax.random.key(0), x0, warm_stage2=False, stage2_replace=repl,
                back_transform=False,
            )
            jax.block_until_ready(warm.value)
            del warm  # free the throwaway trace before the timed run's alloc
            chain, timings, info = job.run_preconditioned(
                jax.random.key(1), x0, warm_stage2=True, stage2_replace=repl,
                back_transform=False,
            )
            jax.block_until_ready(chain.value)
            chol = info["chol"]
        else:
            chain, _ = job.run_phased(jax.random.key(0), x0)  # compile + warm
            jax.block_until_ready(chain.value)
            del chain  # free the warm trace before the timed run's alloc
            chain, timings = job.run_phased(jax.random.key(1), x0)
            jax.block_until_ready(chain.value)
    print(f"# {case} x{n_chains}: warmup {timings['warmup_seconds']:.2f}s, "
          f"sampling {timings['sampling_seconds']:.2f}s", file=sys.stderr,
          flush=True)

    # chain-chunk sized so the FFT workspace (~nfft x chunk x dim c64)
    # stays a couple of GB even for the long headline window
    n_post = chain.value.shape[0]
    nfft = 1
    while nfft < 2 * n_post:
        nfft *= 2
    chunk = min(2048, max(128, (1 << 28) // (nfft * DIM)))
    min_ess = _ess_min_chunked(chain.value, chunk=chunk, chol=chol)
    accept = float(np.asarray(kt.stats.acceptance(chain)))
    n_draws = chain.n_post * n_chains
    secs = timings["sampling_seconds"]

    # analytic FLOPs: one fused logreg value+grad = 2 matmuls
    # ((C,D)@(D,N) and (C,N)@(N,D)) = 4*N*D flops per chain-leap.  With
    # thinning the diagnostics are stored at every k-th step only, so
    # the stored sum is scaled by k (stored steps are an unbiased
    # every-k-th sample of the executed steps' leap counts)
    total_leaps = thinning * float(
        np.sum(np.asarray(chain[leap_diag], dtype=np.float64))
    )
    flops = total_leaps * 4.0 * N_DATA * DIM
    achieved = flops / secs

    out = {
        "sampler": case,
        "ess_per_sec": min_ess / secs,
        "sampling_seconds": round(secs, 3),
        # kernel steps executed per second (not stored draws: with
        # thinning > 1 the sampling phase runs thinning x n_post steps)
        "steps_per_sec": round((n_steps - burnin) / secs, 2),
        "draws_per_sec": round(n_draws / secs, 1),
        "thinning": thinning,
        "warmup_seconds": round(timings["warmup_seconds"], 3),
        "min_ess": round(min_ess, 1),
        "acceptance": round(accept, 3),
        "n_chains": n_chains,
        "ess_per_draw": round(min_ess / n_draws, 4),
        "achieved_tflops": round(achieved / 1e12, 2),
        "precision": precision,
        "trace_dtype": trace_dtype or "float32",
        **device_fields(),
    }
    fs = chain.final_state
    if hasattr(fs, "tune"):
        out["eps_final"] = round(float(np.mean(np.asarray(fs.tune.step))), 5)
    if hasattr(fs, "log_traj") and case == "chees":
        out["lambda_final"] = round(
            float(np.exp(np.mean(np.asarray(fs.log_traj)))), 4
        )
    if case == "nuts":
        out["max_doublings"] = max_doublings
        # per EXECUTED kernel step (total_leaps is already scaled to
        # executed steps above, so divide by executed, not stored)
        out["mean_leaves_per_step"] = round(
            total_leaps / max((n_steps - burnin) * n_chains, 1), 2
        )
    return _apply_rhat_gate(out, chain.value, n_chains, n_post, chol=chol)


def run_gibbs_case(n_chains, n_steps, burnin, precision):
    """GibbsJob row: the reference's second
    flagship job type (src/jobs/BasicGibbsJob.jl:185-199) on the rats
    hierarchical model — 7 conjugate blocks (alpha(30), beta(30),
    alpha_c, beta_c, sigma2_c, sigma2_a, sigma2_b) swept per chain,
    vectorised over chains.  Reports sweeps/sec and min-over-coordinates
    ESS/s across ALL monitored marginals.  The timed wall includes the
    burnin sweeps (conjugate Gibbs has no adaptation phase to time
    apart), so ess_per_sec is conservative by burnin/n_steps."""
    import jax

    import klara_tpu as kt
    from klara_tpu.models.examples import rats_gibbs_model

    model, v0 = rats_gibbs_model()
    # monitor the scalar hyperparameters (the quantities of scientific
    # interest, and they include the slowest-mixing marginal sigma2_c):
    # recording the 60 per-rat alpha/beta coords too would multiply the
    # trace memory per sweep by 13 and shorten the window that fits
    monitor = ("alpha_c", "beta_c", "sigma2_c", "sigma2_a", "sigma2_b")
    job = kt.GibbsJob(
        model, {}, kt.MCRange(n_steps=n_steps, burnin=burnin),
        n_chains=n_chains, monitor=monitor,
    )
    with precision_context(precision):
        print(f"# gibbs x{n_chains}: compiling+warm...", file=sys.stderr,
              flush=True)
        warm = job.run(jax.random.key(0), v0)
        jax.block_until_ready(warm.samples)
        t0 = time.perf_counter()
        chains = job.run(jax.random.key(1), v0)
        jax.block_until_ready(chains.samples)
        secs = time.perf_counter() - t0
    print(f"# gibbs x{n_chains}: {secs:.2f}s for {n_steps} sweeps",
          file=sys.stderr, flush=True)

    n_post = job.mcrange.n_post
    min_ess, ess_by_key, rhat_worst = None, {}, 0.0
    for k, arr in chains.samples.items():
        v = arr if arr.ndim == 3 else arr[:, :, None]
        e = _ess_min_chunked(v)
        ess_by_key[k] = round(e, 1)
        min_ess = e if min_ess is None else min(min_ess, e)
        rhat_worst = max(rhat_worst, rhat_max(v))
    out = {
        "sampler": "gibbs",
        "workload": ("rats hierarchical (7 conjugate blocks, 65 sampled "
                     "scalars/sweep; monitored: 5 hyperparameters)"),
        "ess_per_sec": min_ess / secs,
        "seconds": round(secs, 3),
        "sweeps_per_sec": round(n_steps / secs, 2),
        "chain_sweeps_per_sec": round(n_steps * n_chains / secs, 1),
        "min_ess": round(min_ess, 1),
        "ess_by_key": ess_by_key,
        "n_chains": n_chains,
        "n_sweeps": n_steps,
        "ess_per_draw": round(min_ess / (n_post * n_chains), 4),
        "precision": precision,
        **device_fields(),
    }
    return _apply_rhat_gate(out, None, n_chains, n_post, rhat=rhat_worst)


# ======================================================================
# parent mode: orchestrate cases in isolated subprocesses
# ======================================================================

def run_case_isolated(case, n_chains, timeout=2400, lam=LAMBDA,
                      n_steps=N_STEPS, burnin=BURNIN, max_doublings=5,
                      precision="default", thinning=1):
    """Run one case in a fresh subprocess (one attempt; failures and
    timeouts become an error row)."""
    cmd = [
        sys.executable, os.path.abspath(__file__),
        "--case", case, "--chains", str(n_chains), "--lam", str(lam),
        "--steps", str(n_steps), "--burnin", str(burnin),
        "--max-doublings", str(max_doublings), "--precision", precision,
        "--thinning", str(thinning),
    ]
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout, env=_child_env(), cwd=REPO)
        stderr, stdout = out.stderr or "", out.stdout or ""
    except subprocess.TimeoutExpired as e:
        def _txt(b):
            return b.decode(errors="replace") if isinstance(b, bytes) else (b or "")
        stderr, stdout = _txt(e.stderr), _txt(e.stdout)
        out = None
    for line in stderr.strip().splitlines():
        if line.startswith("#"):
            print(line, file=sys.stderr, flush=True)
    if out is not None:
        for line in reversed(stdout.strip().splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    return json.loads(line)
                except json.JSONDecodeError:
                    continue  # truncated/interleaved line; keep scanning
        err = (stderr or stdout or "no output").strip()[-400:]
    else:
        # keep the child's partial progress lines: they say which leg
        # (compile / warmup / sampling) the case died in
        last = (stderr.strip().splitlines() or ["<no progress output>"])[-1]
        err = (f"timeout after {timeout}s "
               f"(wall {time.perf_counter()-t0:.0f}s; last: {last[-160:]})")
    print(f"# case {case} x{n_chains} FAILED: {err[-220:]}", file=sys.stderr,
          flush=True)
    return {"sampler": case, "n_chains": n_chains, "ess_per_sec": 0.0,
            "error": err}


EXAMPLES_SUBSET = ("readme_normal,bivariate_normal_gibbs,rats_gibbs,"
                   "swiss_chees_precond,swiss_nuts_analytical")


def run_examples_live(em):
    """Re-run the examples acceptance suite LIVE on this run's device: the
    full 56-example matrix when the wall budget allows, a 5-example
    representative subset when tight, skipped (never failing the
    headline) otherwise."""
    budget = int(em.remaining() - 120)
    if budget < 240:
        return {"skipped": True, "reason": "wall budget exhausted"}
    full = budget >= 700
    rec = os.path.join(REPO, ".examples_live.json")
    # a prior run's leftover record must never be reported as THIS run's
    # result: if the subprocess dies before its end-of-suite write,
    # open(rec) below would resurrect the stale file as live=True
    try:
        os.remove(rec)
    except FileNotFoundError:
        pass
    cmd = [sys.executable, os.path.join(REPO, "examples", "run_examples.py"),
           "--record", rec]
    if not full:
        cmd += ["--only", EXAMPLES_SUBSET]
    print(f"# examples live ({'full' if full else 'subset'}), "
          f"budget {budget}s...", file=sys.stderr, flush=True)
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=budget, env=_child_env(), cwd=REPO)
        rc = out.returncode
        tail = (out.stderr or out.stdout or "")[-300:]
    except subprocess.TimeoutExpired:
        rc, tail = -1, f"timeout after {budget}s"
    try:
        with open(rec) as f:
            r = json.load(f)
    except Exception:
        return {"error": tail, "rc": rc}
    r.update(live=True, full_matrix=full, rc=rc)
    return r


class Emitter:
    """Accumulates case results; after every completed case it (a)
    atomically rewrites BENCH_DETAIL.json with the full cumulative
    detail, and (b) prints a COMPACT headline JSON line, hard-capped at
    MAX_LINE chars.  A driver may parse a JSON line from a bounded TAIL
    of stdout, so the fat detail must never ride the stdout line.
    Re-emitting per case keeps a mid-run kill from losing completed
    evidence."""

    def __init__(self, wall_budget):
        self.t0 = time.perf_counter()
        self.wall_budget = wall_budget
        self.detail = {}
        self.base = None

    def remaining(self):
        return self.wall_budget - (time.perf_counter() - self.t0)

    def case_timeout(self, want):
        # leave 60s of slack so the final emission always happens
        return max(60, min(want, int(self.remaining() - 60)))

    def fits(self, min_secs=180):
        return self.remaining() > min_secs

    def record(self, slot, result, emit=True):
        self.detail[slot] = result
        if emit:
            self.emit()

    def skip(self, slot, why="wall budget exhausted"):
        self.detail[slot] = {"skipped": True, "reason": why}
        print(f"# case {slot} SKIPPED: {why}", file=sys.stderr, flush=True)

    def emit(self):
        candidates = [
            r
            for k in (
                "hmc", "hmc_high", "chees_high", "chees_precond",
                "hmc_chees", "nuts", "nuts_precond",
            )
            for r in [self.detail.get(k)]
            if isinstance(r, dict) and r.get("ess_per_sec", 0) > 0
        ]
        sweep = [r for r in self.detail.get("hmc_sweep", [])
                 if isinstance(r, dict) and r.get("ess_per_sec", 0) > 0]
        candidates += sweep
        if not candidates:  # nothing real yet; emit a parseable zero row
            best = {"sampler": "none", "ess_per_sec": 0.0}
        else:
            best = max(candidates, key=lambda r: r["ess_per_sec"])
        base_ess = (self.base or {}).get("ess_per_sec", 0.0)
        headline = {
            "metric": "effective_samples_per_sec_per_chip",
            "value": round(best["ess_per_sec"], 2),
            "unit": (
                f"ESS/s (min over {DIM} dims, {best['sampler'].upper()} "
                f"{DIM}-dim logreg, {best.get('n_chains', '?')} chains, "
                f"{best.get('precision', 'default')} matmul precision, "
                "sampling phase; tuned warmup timed separately)"
            ),
            "vs_baseline": round(best["ess_per_sec"] / base_ess, 2)
            if base_ess
            else 0.0,
            "elapsed_seconds": round(time.perf_counter() - self.t0, 1),
        }
        if "rhat_max" in best:
            headline["rhat_max"] = best["rhat_max"]
        if "sampling_seconds" in best:
            headline["sampling_seconds"] = best["sampling_seconds"]

        # full cumulative detail -> committed file, atomically (a mid-run
        # kill keeps every completed case)
        try:
            tmp = DETAIL_PATH + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    dict(
                        headline,
                        detail=dict(self.detail, single_chain_baseline=self.base),
                    ),
                    f, indent=1,
                )
            os.replace(tmp, DETAIL_PATH)
        except OSError as e:
            print(f"# detail write failed: {e}", file=sys.stderr, flush=True)

        # compact stdout line: headline + per-case ESS/s map only
        def _ess(r):
            if not isinstance(r, dict):
                return None
            if r.get("skipped"):
                return "skipped"
            return round(r.get("ess_per_sec", 0.0), 1)

        cases = {k: _ess(r) for k, r in self.detail.items()
                 if k not in ("hmc_sweep", "examples_live")}
        cases["baseline"] = _ess(self.base)
        sweep_map = {
            str(r.get("n_chains")): round(r.get("ess_per_sec", 0.0), 1)
            for r in self.detail.get("hmc_sweep", [])
            if isinstance(r, dict) and not r.get("skipped")
        }
        compact = dict(headline, cases=cases, sweep=sweep_map,
                       detail_file="BENCH_DETAIL.json")
        line = json.dumps(compact)
        if len(line) > MAX_LINE:  # belt and braces: shed optional fields
            # the constant 'unit' prose sheds FIRST — the per-case ESS
            # map is the evidence the driver-facing line exists to carry
            for drop in ("unit", "sweep", "cases"):
                compact.pop(drop, None)
                line = json.dumps(compact)
                if len(line) <= MAX_LINE:
                    break
        print(line, flush=True)


def main(wall_budget):
    em = Emitter(wall_budget)

    def _sigterm(signum, frame):
        print(f"# SIGTERM at {time.perf_counter()-em.t0:.0f}s; re-emitting",
              file=sys.stderr, flush=True)
        em.emit()
        os._exit(0)

    signal.signal(signal.SIGTERM, _sigterm)

    # 1. the reference's execution model: ONE chain, timed first so no
    #    later fault can cost us the baseline
    em.base = run_case_isolated("baseline", n_chains=1,
                                timeout=em.case_timeout(2400))
    em.emit()

    # 2. headline candidates FIRST at 16k chains, at default and 'high'
    #    matmul precision (see the precision note above).  Fixed-lambda
    #    HMC mixes slowly (IACT of tens of steps), so like raw NUTS it
    #    needs the thinned long window before split-R-hat can certify:
    #    2400 post steps stored at thinning 2.
    hmc_steps = dict(n_steps=BURNIN + LONG_POST, thinning=2)
    if em.fits():
        em.record("hmc", run_case_isolated("hmc", HEADLINE_CHAINS,
                                           timeout=em.case_timeout(2400),
                                           **hmc_steps))
    else:
        em.skip("hmc")
    if em.fits():
        em.record("hmc_high",
                  run_case_isolated("hmc", HEADLINE_CHAINS, precision="high",
                                    timeout=em.case_timeout(2400),
                                    **hmc_steps))
    else:
        em.skip("hmc_high")
    # ChEES-adapted trajectory at 'high' precision
    if em.fits():
        em.record("chees_high",
                  run_case_isolated("chees", HEADLINE_CHAINS, precision="high",
                                    timeout=em.case_timeout(2400)))
    else:
        em.skip("chees_high")
    # ...and dense ensemble preconditioning on top (whitened lambda
    # pinned at 2.0), with 8k chains as the fallback rung.  These cases
    # run a LONG sampling window (HEADLINE_POST post-burnin draws at
    # <= 8k chains, halved at 16k) so the timed phase is seconds.
    def _precond_ladder():
        post16 = HEADLINE_POST // 2 if HEADLINE_CHAINS > 8192 else HEADLINE_POST
        ladder = [(HEADLINE_CHAINS, post16)]
        if HEADLINE_CHAINS > 8192:
            ladder.append((8192, HEADLINE_POST))
        return ladder

    for slot in ("chees_precond", "nuts_precond"):
        row = None
        for n, post in _precond_ladder():
            if not em.fits():
                break
            row = run_case_isolated(slot, n, precision="high",
                                    n_steps=BURNIN + post,
                                    timeout=em.case_timeout(2400))
            em.record(slot, row)
            if row["ess_per_sec"] > 0:
                break
        if row is None:
            em.skip(slot)

    # 3. NUTS next (it must land before optional rows); the descending-
    #    size ladder is the fallback.  Depth 5, static unrolled tree (the
    #    NUTS default, see samplers/nuts.py); depth and tree form are not
    #    re-tuned on the H100 yet (ROADMAP A1).  Raw NUTS mixes slowly,
    #    so the gate-certifiable window is long: 2400 post steps stored
    #    at thinning 2 keeps stored-draw autocorrelation low enough for
    #    split-R-hat to certify at stationarity.
    nuts = None
    for n, md in NUTS_ATTEMPTS:
        if not em.fits():
            break
        nuts = run_case_isolated("nuts", n, max_doublings=md,
                                 precision="high",
                                 n_steps=BURNIN + LONG_POST, thinning=2,
                                 timeout=em.case_timeout(2400))
        em.record("nuts", nuts)
        if nuts["ess_per_sec"] > 0:
            break
    if nuts is None:
        em.skip("nuts")

    # 3c. the reference's second flagship job type: the rats
    # hierarchical GibbsJob
    if em.fits():
        em.record("gibbs",
                  run_case_isolated("gibbs", GIBBS_CHAINS,
                                    n_steps=GIBBS_STEPS, burnin=GIBBS_BURNIN,
                                    precision="high",
                                    timeout=em.case_timeout(1800)))
    else:
        em.skip("gibbs")

    # 4. chain-count sweep for fixed-trajectory HMC (warm-cached sizes) at
    #    'high', the precision of the headline candidates
    sweep = []
    for n in CHAIN_SWEEP:
        if n == HEADLINE_CHAINS and isinstance(em.detail.get("hmc_high"), dict) \
                and em.detail["hmc_high"].get("ess_per_sec", 0) > 0:
            sweep.append(em.detail["hmc_high"])
            continue
        if not em.fits():
            break
        sweep.append(run_case_isolated("hmc", n, precision="high",
                                       timeout=em.case_timeout(1800),
                                       **hmc_steps))
        em.record("hmc_sweep", sweep)
    ok_sweep = [r for r in sweep if r.get("ess_per_sec", 0) > 0]
    if ok_sweep:
        best_hmc = max(ok_sweep, key=lambda r: r["ess_per_sec"])
        best_n = best_hmc.get("n_chains", HEADLINE_CHAINS)
    else:
        best_n = HEADLINE_CHAINS
    em.emit()

    # 5. ChEES-adapted trajectory at the sweep's best chain count, at the
    #    same 'high' precision; the HEADLINE_CHAINS point is already
    #    measured as chees_high
    if best_n == HEADLINE_CHAINS and isinstance(
            em.detail.get("chees_high"), dict) \
            and em.detail["chees_high"].get("ess_per_sec", 0) > 0:
        em.record("hmc_chees", em.detail["chees_high"], emit=False)
    elif em.fits():
        em.record("hmc_chees", run_case_isolated("chees", best_n,
                                                 precision="high",
                                                 timeout=em.case_timeout(1800)))
    else:
        em.skip("hmc_chees")

    # 6. f32 precision reference row
    if em.fits():
        em.record("hmc_f32",
                  run_case_isolated("hmc", best_n, precision="f32",
                                    timeout=em.case_timeout(1800),
                                    **hmc_steps))
    else:
        em.skip("hmc_f32")

    # 7. examples acceptance LIVE (budget-gated)
    em.record("examples_live", run_examples_live(em), emit=False)

    em.emit()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default=None,
                    help="child mode: run one case in-process")
    ap.add_argument("--chains", type=int, default=16384)
    ap.add_argument("--lam", type=float, default=LAMBDA)
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--burnin", type=int, default=BURNIN)
    ap.add_argument("--max-doublings", type=int, default=5)
    ap.add_argument("--precision", default="default", choices=["default", "high", "f32"])
    ap.add_argument("--thinning", type=int, default=1)
    ap.add_argument("--wall-budget", type=float,
                    default=float(os.environ.get("BENCH_WALL_BUDGET_S", 3300)))
    args = ap.parse_args()
    if args.case is None:
        main(args.wall_budget)
        sys.exit(0)
    device_fields()  # fail before compiling anything when there is no GPU
    if args.case == "gibbs":
        sys.path.insert(0, REPO)
        result = run_gibbs_case(args.chains, args.steps, args.burnin,
                                args.precision)
        print(json.dumps(result), flush=True)
    else:
        sys.path.insert(0, REPO)
        result = run_case(args.case, args.chains, args.steps, args.burnin,
                          args.lam, args.max_doublings, args.precision,
                          thinning=args.thinning)
        print(json.dumps(result), flush=True)
