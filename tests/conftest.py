"""Test configuration.

By default the suite runs on the CPU with 8 virtual devices, so the
sharding tests need no hardware.  Tests marked ``gpu`` compare the CUDA
kernels with the plain implementation; they skip on the CPU and run on a
GPU with ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/test_gact_cuda.py``."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_codes(rng, n, n_prob=0.02):
    """Random 5-letter codes with occasional Ns."""
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    nmask = rng.random(n) < n_prob
    codes[nmask] = 4
    return codes


def mutate(rng, codes, sub_p=0.08, ins_p=0.04, del_p=0.04):
    """Simple long-read-style mutation of a code sequence."""
    out = []
    for c in codes:
        r = rng.random()
        if r < del_p:
            continue
        if r < del_p + ins_p:
            out.append(rng.integers(0, 4))
        if rng.random() < sub_p:
            out.append((c + rng.integers(1, 4)) % 4)
        else:
            out.append(c)
    return np.array(out, dtype=np.uint8)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, at run time — never
    while the module is imported)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (the CUDA kernels have no CPU mode)")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line("markers",
                            "gpu: compares the CUDA kernels on a GPU")
