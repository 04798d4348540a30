"""Chain-scaling harness on a virtual N-device CPU mesh.

Holds the TOTAL chain count fixed and grows the mesh:

    efficiency(N) = T(mesh=1 device) / T(mesh=N devices)

All virtual devices share the same host cores, so naive weak scaling
would only measure core oversubscription; with identical total FLOPs on
identical silicon, any slowdown is sharding overhead (partitioning,
pooled-tuner collectives, layout) of the same GSPMD program XLA would
partition over real devices.  It is a CPU correctness canary, not a
device measurement: it cannot see NVLink or collective latency.

Run standalone:

    python benchmarks/scaling.py            # forces cpu + 8 virtual devices
    python benchmarks/scaling.py --json     # one JSON line
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _force_virtual_cpu(n=8):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_NUM_CPU_DEVICES"] = str(n)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}"
        ).strip()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", n)
    except Exception:
        pass
    assert jax.default_backend() == "cpu"


def measure(n_chains=2048, dim=25, n_data=256, n_steps=80, burnin=40, repeats=2):
    import time

    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import klara_tpu as kt
    from klara_tpu.models.examples import synthetic_logistic_regression

    target, _, _ = synthetic_logistic_regression(dim=dim, n_data=n_data)
    devices = jax.devices()
    sizes = [s for s in (1, 2, 4, 8) if s <= len(devices)]

    def run_once(n_dev):
        mesh = Mesh(np.array(devices[:n_dev]), ("chains",))
        job = kt.MCJob(
            target,
            kt.HMC(leapstep=0.05, nleaps=8),
            kt.MCRange(n_steps=n_steps, burnin=burnin),
            tuner=kt.DualAveragingTuner(0.8, burnin),
            n_chains=n_chains,
            mesh=mesh,
            pooled_tuning=True,
            monitor=("value",),
        )
        x0 = jnp.zeros((n_chains, dim), jnp.float32)
        chain = job.run(jax.random.key(0), x0)  # compile + warm
        jax.block_until_ready(chain.value)
        best = float("inf")
        for r in range(repeats):
            t0 = time.perf_counter()
            chain = job.run(jax.random.key(1 + r), x0)
            jax.block_until_ready(chain.value)
            best = min(best, time.perf_counter() - t0)
        draws = chain.n_post * n_chains
        return best, draws

    rows = []
    t1 = prev = None
    for n_dev in sizes:
        secs, draws = run_once(n_dev)
        if t1 is None:
            t1 = secs
        rows.append(
            {
                "devices": n_dev,
                "seconds": round(secs, 4),
                "draws_per_sec": round(draws / secs, 1),
                # vs the 1-device run: >1 possible on a shared host (more
                # virtual devices recruit more host cores), so this alone
                # cannot fail — see the marginal gate below
                "efficiency": round(t1 / secs, 4),
                # MARGINAL ratio T(prev)/T(this): the falsifiable signal.
                # Fixed total work on fixed silicon means doubling the
                # mesh must not make the program slower; a drop below
                # 1/1.2 flags real sharding overhead (collectives,
                # partitioning, layout) introduced by that doubling.
                "marginal_ratio": round(prev / secs, 4) if prev else 1.0,
            }
        )
        prev = secs
    # gate: no mesh size may be >20% SLOWER than the previous size.
    # (The old T(1)/T(N) >= 0.8 gate was near-unfalsifiable on a shared
    # host because extra virtual devices recruit extra host cores.)
    worst_marginal = min(r["marginal_ratio"] for r in rows)
    return {
        "method": "fixed-total-chains sharding overhead on a virtual CPU mesh",
        "n_chains": n_chains,
        "dim": dim,
        "rows": rows,
        "min_efficiency": min(r["efficiency"] for r in rows),
        "worst_marginal_ratio": worst_marginal,
        "pass_no_marginal_regression": worst_marginal >= 1.0 / 1.2,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true", help="print one JSON line")
    ap.add_argument("--chains", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=80)
    a = ap.parse_args()
    _force_virtual_cpu(8)
    result = measure(n_chains=a.chains, n_steps=a.steps, burnin=a.steps // 2)
    if a.json:
        print(json.dumps(result))
    else:
        print(f"chain-scaling efficiency ({result['method']}):")
        for r in result["rows"]:
            print(
                f"  {r['devices']} device(s): {r['seconds']:8.3f}s  "
                f"{r['draws_per_sec']:12.0f} draws/s  eff={r['efficiency']:.3f}"
                f"  marginal={r['marginal_ratio']:.3f}"
            )
        ok = result["pass_no_marginal_regression"]
        print(f"  no->20%-marginal-regression gate: {'PASS' if ok else 'FAIL'}")


if __name__ == "__main__":
    main()
