"""Seeded synthetic golden: run()'s SAM and MHAP output on chip_smoke.py's
small workload, locked by sha256.

The same hashes are what chip_smoke.py phase (e) requires on the GPU, so
a pass here plus a pass there means the GPU path (CUDA tile kernels,
speculation, compact records) prints exactly what the CPU path prints.
"""

import pytest

import chip_smoke


@pytest.fixture(scope="module")
def hashes(tmp_path_factory):
    return chip_smoke.golden_hashes(str(tmp_path_factory.mktemp("golden")))


def test_golden_synthetic_sam(hashes):
    assert hashes[0] == chip_smoke.GOLDEN_SAM_SHA256


def test_golden_synthetic_mhap(hashes):
    assert hashes[1] == chip_smoke.GOLDEN_MHAP_SHA256
