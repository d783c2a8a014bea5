"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Tests validate correctness and multi-device sharding on host CPU devices.
Tests marked `gpu` need the card: they skip elsewhere, and `chip_smoke.py`
runs them on the GPU (its phase b).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


REFERENCE = "/root/reference"


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a `gpu`-marked test unless JAX's default device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run on the card by chip_smoke.py)")


@pytest.fixture(scope="session")
def fake_genome():
    """The reference regression suite's tiny genome (500 bp, 1 contig)."""
    from tophat_tpu.index.fasta import read_fasta

    path = os.path.join(
        REFERENCE, "tests/regression_tests/test_cases/common_genomes/fake.fa")
    if not os.path.exists(path):
        pytest.skip("reference test genome unavailable")
    return read_fasta(path)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(7)
