"""Test config: run on 8 virtual CPU devices (SURVEY.md §4 "distributed
without a cluster") so mesh/all-to-all/psum paths are exercised in CI.

JAX is held to the CPU unless ``JAX_PLATFORMS`` says otherwise.  Tests that
need a GPU carry the ``gpu`` marker and take the ``gpu_device`` fixture,
which skips them when JAX finds no GPU; on a machine with a card they run as
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os
import sys

# must happen before jax initialises a backend
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402,F401
import pytest  # noqa: E402
import numpy as np  # noqa: E402

from deepctr_tpu.data import make_schema, synthetic  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where JAX finds none"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (JAX found none)")
    return gpus[0]


@pytest.fixture(scope="session")
def tiny_schema():
    return make_schema(
        [("a", 4), ("b", 8), ("c", 16), ("tags", 10, 3)]
    )


@pytest.fixture(scope="session")
def tiny_dataset(tiny_schema):
    return synthetic.generate(
        tiny_schema, num_examples=4096, k=3, noise=0.3, seed=1
    )


@pytest.fixture(scope="session")
def small_dataset():
    schema = make_schema(
        [
            ("weekday", 8),
            ("hour", 25),
            ("region", 36),
            ("city", 120),
            ("domain", 300),
            ("slot", 60),
            ("tags", 40, 3),
        ]
    )
    return synthetic.generate(schema, num_examples=20000, k=4, noise=0.4, seed=2)
