"""Multi-process global mesh test — the multi-host code path.

The reference has no distributed execution at all; this exercises the new
framework's multi-host story (SURVEY.md §2.2): 2 processes x 4 virtual
CPU devices joined by `jax.distributed.initialize` into ONE 8-device
global mesh, chains sharded across processes, pooled tuner adaptation
reducing across the process boundary.  The same launch recipe runs one
process per host on real machines; see docs/guide.md.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_global_mesh(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    port = _free_port()
    env = {
        k: v
        for k, v in os.environ.items()
        # the workers configure their own platform/device env
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_NUM_CPU_DEVICES")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert (tmp_path / f"proc{pid}.ok").exists(), out
    # both processes computed the same replicated posterior summary
    r0 = (tmp_path / "proc0.ok").read_text()
    r1 = (tmp_path / "proc1.ok").read_text()
    assert r0 == r1
