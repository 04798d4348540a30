"""Test configuration: simulate an 8-device mesh on CPU.

The reference has no distributed code and hence no fake backends
(SURVEY.md §4); we deliberately test mesh sharding + collectives on a
virtual 8-device CPU platform, the standard JAX trick.  The tests always
run on the CPU, even on a machine with a GPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_NUM_CPU_DEVICES"] = "8"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# jax may already be imported (and its config read from the environment)
# by the time this file runs, so set the config directly as well (before
# any backend initialises).
jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass
assert jax.default_backend() == "cpu", "tests must run on the CPU platform"
assert len(jax.devices()) == 8, "tests expect a virtual 8-device CPU mesh"

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices():
    return jax.devices()


@pytest.fixture(scope="session")
def chain_mesh():
    from jax.sharding import Mesh
    import numpy as np

    return Mesh(np.array(jax.devices()), ("chains",))
