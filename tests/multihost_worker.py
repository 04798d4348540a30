"""Worker for the multi-process (multi-host simulation) test.

Each process gets 4 virtual CPU devices; two processes form one global
8-device mesh over the distributed runtime — the same code path as two
hosts joined over the network (SURVEY.md §2.2 multi-host row).

Usage: python multihost_worker.py <process_id> <num_processes> <port> <outdir>
"""

import os
import sys

pid, nproc, port, outdir = (
    int(sys.argv[1]),
    int(sys.argv[2]),
    sys.argv[3],
    sys.argv[4],
)

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=4").strip()
repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, repo_root)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from klara_tpu.parallel import initialize_distributed  # noqa: E402

initialize_distributed(
    coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
)

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, len(jax.devices())
assert len(jax.local_devices()) == 4

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import klara_tpu as kt  # noqa: E402
from klara_tpu.parallel import chain_mesh  # noqa: E402

mesh = chain_mesh()  # global mesh over all 8 devices, both processes
target = kt.Target(logdensity_fn=lambda x: -0.5 * jnp.sum(x * x), dim=2)
job = kt.MCJob(
    target,
    kt.MALA(driftstep=0.5),
    kt.MCRange(n_steps=400, burnin=100),
    tuner=kt.AcceptanceRateTuner(targetrate=0.6),
    n_chains=32,
    mesh=mesh,
    pooled_tuning=True,  # cross-PROCESS pooled adaptation (cross-host collective path)
)
chain = job.run(jax.random.key(0), jnp.zeros(2))

# global-array reductions are SPMD: every process computes the same
# replicated result over the process-spanning chains axis
mean = np.asarray(kt.stats.mean(chain))
rate = float(kt.stats.acceptance(chain))
assert np.all(np.abs(mean) < 0.25), mean
assert 0.3 < rate < 0.9, rate

with open(os.path.join(outdir, f"proc{pid}.ok"), "w") as f:
    f.write(f"{mean.tolist()} {rate}\n")
print(f"proc {pid}: mean={mean} rate={rate:.3f} OK")
