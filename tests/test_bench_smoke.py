"""Smoke-test bench.py's child-case path on the CPU test platform with
tiny shapes — catches bitrot in the benchmark harness without a GPU."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench  # noqa: E402


def test_bench_case_hmc_smoke():
    # enough post-burnin draws that the Geyer IMSE ESS is stably positive
    r = bench.run_case("hmc", n_chains=8, n_steps=140, burnin=40, lam=1.0,
                       max_doublings=3, precision="default")
    assert r["sampler"] == "hmc"
    assert r["ess_per_sec"] > 0
    assert r["sampling_seconds"] > 0 and r["warmup_seconds"] > 0
    # every row names its device; this CPU rehearsal says so
    assert r["platform"] == "cpu" and r["device_count"] == 8
    assert r["device_kind"] and isinstance(r["card"], list)
    assert r["achieved_tflops"] >= 0
    assert "eps_final" in r
    # every case row carries the mixing diagnostic; the
    # GATE is inactive at this toy scale (n_chains < 32), so ESS stands
    # even if tiny-sample rank-R-hat noise exceeds the threshold
    assert r["rhat_max"] > 0
    assert r["steps_per_sec"] > 0


def test_bench_case_gibbs_smoke():
    """The Gibbs row's child path at toy scale."""
    r = bench.run_gibbs_case(n_chains=8, n_steps=260, burnin=60,
                             precision="default")
    assert r["sampler"] == "gibbs"
    assert r["ess_per_sec"] > 0
    assert r["sweeps_per_sec"] > 0
    assert r["rhat_max"] > 0
    assert set(r["ess_by_key"]) >= {"alpha_c", "beta_c", "sigma2_c"}


def test_emitter_line_stays_under_driver_tail_capture(capsys, tmp_path,
                                                      monkeypatch):
    """A cumulative stdout line that outgrows a driver's bounded tail
    capture parses to null despite rc=0.  Stuff the emitter with MORE fat detail than a real run ever
    accumulates and assert every emitted line stays under MAX_LINE and
    json-parses, while the fat detail lands in the detail file."""
    import json

    monkeypatch.setattr(bench, "DETAIL_PATH", str(tmp_path / "detail.json"))
    em = bench.Emitter(wall_budget=10)
    em.base = {"sampler": "baseline", "ess_per_sec": 379.0, "n_chains": 1,
               "note": "x" * 400}
    fat = {k: {"sampler": "hmc", "ess_per_sec": 1e6 + ord(k[0]),
               "n_chains": 16384, "precision": "high", "rhat_max": 1.0041,
               "sampling_seconds": 3.21, "padding": "y" * 300}
           for k in ("hmc", "hmc_high", "chees_high", "chees_precond",
                     "nuts", "nuts_precond", "gibbs", "hmc_chees", "hmc_f32")}
    for k, v in fat.items():
        em.detail[k] = v
    em.detail["hmc_sweep"] = [
        {"sampler": "hmc", "ess_per_sec": 1000.0 * n, "n_chains": n,
         "padding": "z" * 200}
        for n in (2048, 4096, 8192, 16384)
    ]
    em.detail["examples_live"] = {"errors": {"x": "w" * 2000}}
    em.emit()

    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert lines
    for line in lines:
        assert len(line) <= bench.MAX_LINE, f"{len(line)}-char line emitted"
        row = json.loads(line)
    assert row["metric"] == "effective_samples_per_sec_per_chip"
    assert row["value"] > 0
    assert row["cases"]["gibbs"] > 0
    assert row["detail_file"] == "BENCH_DETAIL.json"
    detail = json.loads((tmp_path / "detail.json").read_text())
    assert detail["detail"]["chees_precond"]["padding"]
    assert detail["detail"]["single_chain_baseline"]["ess_per_sec"] == 379.0


def test_bench_case_chees_smoke():
    r = bench.run_case("chees", n_chains=8, n_steps=140, burnin=40, lam=1.0,
                       max_doublings=3, precision="default")
    assert r["ess_per_sec"] > 0
    assert "lambda_final" in r


def test_bench_case_nuts_smoke():
    # >=40 post draws: the Geyer IMSE estimate can legitimately go
    # negative on ~10 draws of a strongly antithetic NUTS chain
    r = bench.run_case("nuts", n_chains=4, n_steps=60, burnin=20, lam=1.0,
                       max_doublings=3, precision="default")
    assert r["ess_per_sec"] > 0
    assert r["max_doublings"] == 3
    assert r["mean_leaves_per_step"] >= 1


def test_bench_parent_survives_interruption(tmp_path):
    """A driver that kills bench.py mid-run must still find a parseable
    nonzero line.  Drive the REAL parent orchestration at toy
    scale on CPU, SIGTERM it as soon as the first nonzero cumulative line
    lands, and assert the last stdout JSON line still parses nonzero."""
    import json
    import queue
    import signal
    import subprocess
    import threading
    import time

    repo = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        BENCH_STEPS="80",
        BENCH_BURNIN="20",
        BENCH_HEADLINE_CHAINS="8",
        BENCH_HEADLINE_POST="60",
        BENCH_LONG_POST="60",
        BENCH_SWEEP="4,8",
        BENCH_NUTS_CHAINS="4",
        BENCH_GIBBS_CHAINS="8",
        BENCH_GIBBS_STEPS="120",
        BENCH_GIBBS_BURNIN="20",
        BENCH_DETAIL_PATH=str(tmp_path / "detail.json"),
        JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
    )
    proc = subprocess.Popen(
        [sys.executable, os.path.join(repo, "bench.py"), "--wall-budget", "600"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=repo, env=env,
    )
    lines = queue.Queue()
    t = threading.Thread(
        target=lambda: [lines.put(l) for l in proc.stdout], daemon=True)
    t.start()

    seen = []
    deadline = time.monotonic() + 420
    try:
        while time.monotonic() < deadline:
            try:
                line = lines.get(timeout=5).strip()
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            if not line.startswith("{"):
                continue
            assert len(line) <= bench.MAX_LINE, \
                f"{len(line)}-char line would overflow the driver tail"
            row = json.loads(line)
            seen.append(row)
            if row.get("value", 0) > 0:
                proc.send_signal(signal.SIGTERM)  # mid-run driver kill
                break
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    # drain whatever was emitted after the signal
    t.join(timeout=10)
    while not lines.empty():
        line = lines.get().strip()
        if line.startswith("{"):
            assert len(line) <= bench.MAX_LINE, \
                f"{len(line)}-char line would overflow the driver tail"
            seen.append(json.loads(line))

    assert seen, "bench emitted no JSON lines before interruption"
    last = seen[-1]
    assert last["metric"] == "effective_samples_per_sec_per_chip"
    assert last["value"] > 0, f"interrupted bench lost its value: {last}"
    # the fat per-case detail must have landed in the detail file
    detail = json.loads((tmp_path / "detail.json").read_text())
    assert detail["detail"], "detail file missing per-case rows"


def test_bench_case_chees_precond_smoke():
    """The dense-preconditioned ChEES case runs end-to-end at toy scale
    (n_chains < dim exercises the diagonal-shrinkage fallback)."""
    r = bench.run_case("chees_precond", n_chains=8, n_steps=140, burnin=40,
                       lam=1.0, max_doublings=3, precision="default")
    assert r["ess_per_sec"] > 0
    assert r["warmup_seconds"] > 0 and r["sampling_seconds"] > 0
    assert "lambda_final" not in r or r["lambda_final"] > 0
