"""Test configuration: virtual 8-device CPU mesh + float64.

Parity tests run on CPU in float64 so golden numbers from the
reference binary (which is double precision, utilities.h:462) compare
at tight tolerance.  Sharding tests use the 8 virtual CPU devices.

Tests that need an NVIDIA GPU carry the `gpu` marker and take the
`gpu` fixture, which skips them unless JAX runs on a GPU.  Run them
on the card with
    PHYML_TEST_PLATFORM=gpu python -m pytest -m gpu tests/
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

# CPU unless PHYML_TEST_PLATFORM=gpu: through the config API, which
# holds whatever JAX_PLATFORMS says.  x64 in both cases, as the CLI
# sets it (phyml_tpu.platform.select_platform).
if os.environ.get("PHYML_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
EXAMPLES = "/root/reference/examples"


@pytest.fixture(scope="session")
def nucleic():
    from phyml_tpu.io.alignment import read_alignment
    return read_alignment(os.path.join(EXAMPLES, "nucleic"),
                          datatype="nt")


@pytest.fixture(scope="session")
def proteic():
    from phyml_tpu.io.alignment import read_alignment
    return read_alignment(os.path.join(EXAMPLES, "proteic"),
                          datatype="aa")


@pytest.fixture(scope="session")
def ref_tree_a(nucleic):
    from phyml_tpu.topology import Topology
    with open(os.path.join(GOLDEN, "ref_tree_A.nwk")) as fh:
        return Topology.from_newick(fh.read(), nucleic.names)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs,
    never at import, so every pytest-xdist worker collects the same
    tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with PHYML_TEST_PLATFORM=gpu)")
