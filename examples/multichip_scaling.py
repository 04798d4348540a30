"""Chain data-parallel scaling over a device mesh (the BASELINE north star).

Shards 16k chains of NUTS on the 100-dim logistic regression over every
available device ('chains' mesh axis), with pooled dual-averaging
adaptation (cross-device psum).  On a single host, exercise it with a
virtual mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip_scaling.py --chains 512 --steps 100

Across hosts, run one process per host after
``kt.parallel.initialize_distributed(...)`` — the same code scales over
the hosts' network (no reference counterpart: Klara is single-process,
serial chains).
"""

import argparse
import time

import jax
import jax.numpy as jnp

import klara_tpu as kt
from klara_tpu.models.examples import synthetic_logistic_regression
from klara_tpu.parallel import chain_mesh


def main(n_chains=16384, n_steps=500, burnin=200, dim=100):
    target, _, _ = synthetic_logistic_regression(dim=dim, n_data=1024)
    mesh = chain_mesh()
    print(f"devices: {len(mesh.devices.flat)}  chains: {n_chains}")

    job = kt.MCJob(
        target,
        kt.NUTS(max_doublings=6),
        kt.MCRange(n_steps=n_steps, burnin=burnin),
        tuner=kt.DualAveragingTuner(0.8, burnin),
        n_chains=n_chains,
        mesh=mesh,
        pooled_tuning=True,
        monitor=("value",),
    )
    x0 = jnp.zeros((n_chains, dim), jnp.float32)

    chain = job.run(jax.random.key(0), x0)  # compile + run
    jax.block_until_ready(chain.value)
    t0 = time.perf_counter()
    chain = job.run(jax.random.key(1), x0)
    jax.block_until_ready(chain.value)
    dt = time.perf_counter() - t0

    draws = chain.n_post * n_chains
    print(f"{draws} draws in {dt:.2f}s = {draws/dt:.0f} draws/s")
    print(f"min ESS: {float(jnp.min(kt.stats.ess(chain))):.0f}")
    return dt


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--burnin", type=int, default=200)
    ap.add_argument("--dim", type=int, default=100)
    a = ap.parse_args()
    main(a.chains, a.steps, a.burnin, a.dim)
