"""Run every example end-to-end with ASSERTED posterior checks.

Counterpart of the reference's doc/examples/runexamples.jl:1-57 (which
`include`s ~49 scripts and eyeballs `mean(chain)`), promoted to hard
assertions.  The example matrix mirrors examples.csv: the swiss
Bayesian-logistic-regression x {MALA,SMMALA,RAM,HMC,NUTS,slice} x
{analytical, AD} grid, the Normal family across the sampler zoo, Gamma,
Poisson (discrete support), Student-t, bivariate-normal Gibbs, and the
rats hierarchical model.

Usage: python examples/run_examples.py [--cpu] [--only SUBSTR[,SUBSTR...]]
                                       [--record PATH]

``--record`` writes a JSON artifact {platform, device, passed, total,
failed, errors, seconds}.  The artifact is written even when examples fail
or crash: every example runs under a broad ``except Exception`` (a crash
in example 3 must not cost the remaining 53 results), with the traceback
tail kept in ``errors``; the exit code is still non-zero.  chip_smoke.py
runs the same registry in-process with no such guard.
"""

import argparse
import importlib
import json
import os
import sys
import time
import traceback


def build_registry():
    """(name -> zero-arg callable, import_errors): each callable runs +
    asserts one example.  Imports are isolated per module — an
    import-time crash in one example file must not cost the rest of the
    suite or the --record artifact (it lands in import_errors and is
    reported as a failure of that module's examples)."""
    registry, import_errors = {}, {}

    # single-file examples exposing main()
    for name in (
        "readme_normal",
        "bivariate_normal_gibbs",
        "poisson_mh",
        "gamma_mh",
        "gamma_mh_truncation",
        "normal_adaptive",
        "rats_gibbs",
    ):
        try:
            registry[name] = importlib.import_module(name).main
        except Exception:
            import_errors[name] = traceback.format_exc(limit=4)[-800:]

    # parametrised families
    for mod, attr in (
        ("swiss_matrix", "SWISS_EXAMPLES"),
        ("normal_family", "NORMAL_EXAMPLES"),
        ("bivariate_family", "BIVARIATE_EXAMPLES"),
        ("t_mh", "T_EXAMPLES"),
    ):
        try:
            registry.update(getattr(importlib.import_module(mod), attr))
        except Exception:
            import_errors[mod] = traceback.format_exc(limit=4)[-800:]
    return registry, import_errors


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU platform")
    ap.add_argument("--only", default=None, help="substring filter")
    ap.add_argument("--record", default=None,
                    help="write a JSON result artifact to this path")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))  # repo root (klara_tpu)
    sys.path.insert(0, here)

    registry, import_errors = build_registry()
    subs = None if args.only is None else [
        s for s in args.only.split(",") if s
    ]
    names = [n for n in registry if subs is None or any(s in n for s in subs)]
    print(f"{len(names)} examples")
    failed, errors = [], {}
    for mod, tb in import_errors.items():
        failed.append(mod)
        errors[mod] = tb
        print(f"----- {mod}: IMPORT ERROR\n{tb}", flush=True)
    t_suite = time.perf_counter()
    for i, name in enumerate(names, 1):
        print(f"===== [{i}/{len(names)}] {name} =====", flush=True)
        t0 = time.perf_counter()
        try:
            registry[name]()
            print(f"----- {name}: OK {time.perf_counter()-t0:.1f}s", flush=True)
        except AssertionError as e:
            failed.append(name)
            print(f"----- {name}: FAILED {e}", flush=True)
        except Exception:
            # a crash (not just a posterior-check failure) in one example
            # must not abort the suite or cost the --record artifact
            failed.append(name)
            errors[name] = traceback.format_exc(limit=8)[-1500:]
            print(f"----- {name}: ERROR\n{errors[name]}", flush=True)
    if args.record:
        import jax

        with open(args.record, "w") as f:
            json.dump(
                {
                    "platform": jax.default_backend(),
                    "device": str(jax.devices()[0]),
                    # failed import modules count as extra (unrunnable)
                    # entries on top of the runnable example names
                    "passed": len(names) - len([f for f in failed if f in names]),
                    "total": len(names) + len(import_errors),
                    "failed": failed,
                    "errors": errors,
                    "seconds": round(time.perf_counter() - t_suite, 1),
                },
                f,
            )
        print(f"recorded {args.record}")
    if failed:
        print(f"FAILED: {failed}")
        sys.exit(1)
    print(f"all {len(names)} examples passed")


if __name__ == "__main__":
    main()
