"""chip_smoke.py on the CPU: its phases at tiny sizes, called directly,
its refusal to run without a GPU, and the compile-cache rule it shares
with bench.py.  The full-size run needs the card (``python chip_smoke.py``
on an H100)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench  # noqa: E402
import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(
    chains=64, burnin=100, post=100, gibbs_chains=16,
    gibbs_steps=600, gibbs_burnin=200, io_chains=4, io_steps=40,
)


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_phase_device_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device()


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/cache"])
def test_compile_cache_dir_rule(env_dir):
    environ = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": env_dir}
    want = env_dir or os.path.join(bench.REPO, ".jax_cache")
    assert bench.compile_cache_dir(environ) == want


def test_child_env_sets_cache_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert bench._child_env()["JAX_COMPILATION_CACHE_DIR"] == os.path.join(
        bench.REPO, ".jax_cache"
    )
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/x")
    assert bench._child_env()["JAX_COMPILATION_CACHE_DIR"] == "/x"


def test_device_fields_refuse_cpu_unless_asked(monkeypatch):
    assert bench.device_fields()["platform"] == "cpu"  # JAX_PLATFORMS=cpu
    monkeypatch.delenv("JAX_PLATFORMS")
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.device_fields()


def test_logreg_reference_matches_main_path_target():
    from klara_tpu.models.examples import synthetic_logistic_regression

    target, X, y = synthetic_logistic_regression(dim=7, n_data=50, seed=2)
    P = 0.3 * np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        v, g = jax.vmap(target.logdensity_and_grad)(jnp.asarray(P))
    ref_v, ref_g = chip_smoke.logreg_reference(P, X, y, 100.0)
    ev, eg = chip_smoke.relative_errors(v, g, ref_v, ref_g)
    assert ev < 1e-5 and eg < 1e-5


def test_mean_and_mcse_pooled_over_chunks():
    x = jax.random.normal(jax.random.key(0), (400, 24, 3)) + jnp.arange(3.0)
    m, se = chip_smoke.mean_and_mcse(x, chunk=7)
    m1, se1 = chip_smoke.mean_and_mcse(x, chunk=24)
    np.testing.assert_allclose(m, m1, rtol=1e-6)
    np.testing.assert_allclose(se, se1, rtol=1e-6)
    np.testing.assert_allclose(m, np.asarray(jnp.mean(x, axis=(0, 1))), rtol=1e-5)
    # iid draws: mcse ~ sd / sqrt(draws * chains)
    np.testing.assert_allclose(se, 1.0 / np.sqrt(400 * 24), rtol=0.25)
    assert chip_smoke.agreement((m, se), (m + 3 * se, se)) == pytest.approx(
        3 / np.sqrt(2), rel=1e-6
    )


def test_phase_target_tiny():
    out = chip_smoke.phase_target(TINY, reps=2)
    assert set(out) == set(chip_smoke.PRECISIONS)
    assert all(r["ms"] > 0 for r in out.values())
    assert out["f32"]["grad_err"] <= chip_smoke.TOL_F32


def test_phases_chees_precond_nuts_tiny(capsys):
    chees = chip_smoke.phase_chees(TINY)
    assert abs(chees["accept"] - chip_smoke.ACCEPT_TARGET) <= chip_smoke.ACCEPT_TOL
    assert chees["eps"] > 0 and chees["lam"] > 0
    precond = chip_smoke.phase_precond(TINY, chees["stats"])
    assert set(precond) == {"chees_precond", "nuts_precond"}
    nuts = chip_smoke.phase_nuts(TINY, chees["stats"])
    assert nuts["z"] <= chip_smoke.AGREE_K
    out = capsys.readouterr().out
    assert "memory_analysis(" in out and "mean leaves/step=" in out


def test_phase_gibbs_tiny():
    r = chip_smoke.phase_gibbs(TINY)
    assert abs(r["means"]["beta_c"] - 6.19) < 0.15
    assert set(r["stats"]) == set(chip_smoke.RATS_MONITOR)


def test_phase_examples_runs_registry_and_raises(monkeypatch):
    assert chip_smoke.phase_examples(("readme_normal",)) == 1
    import run_examples

    def broken():
        raise AssertionError("posterior off")

    monkeypatch.setattr(
        run_examples, "build_registry", lambda: ({"broken": broken}, {})
    )
    with pytest.raises(AssertionError, match="posterior off"):
        chip_smoke.phase_examples()


def test_phase_io_tiny(capsys):
    chip_smoke.phase_io(TINY)
    assert "bit for bit" in capsys.readouterr().out
