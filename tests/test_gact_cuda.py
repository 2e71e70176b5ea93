"""The CUDA tile kernels (ops/gact_cuda.py) and the kernel choice.

The kernels have no CPU mode: their Python side (shapes, the row split,
the shape/scoring rule, the choice by platform) is tested on the CPU; their
arithmetic by the ``gpu``-marked tests at the end, which skip without a
GPU (run them with ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/test_gact_cuda.py``).  This module imports nothing from the tests
package, so it collects wherever the package itself imports.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from darwin_tpu.config import Config
from darwin_tpu.ops import dispatch, gact, gact_cuda

PS = gact.static_params(gact.make_params(Config()))


def test_cuda_rows_per_lane_and_supports():
    assert [gact_cuda.rows_per_lane(q) for q in (32, 128, 129, 384, 512)] \
        == [4, 4, 8, 12, 16]
    assert gact_cuda.rows_per_lane(513) is None
    assert gact_cuda.supports(PS, 384, 384)
    assert gact_cuda.supports(PS, 128, 128)
    assert not gact_cuda.supports(PS, 1984, 960)      # large tiles: plain
    generic = (PS[0], -1, -5, -3, -9)                  # open > extend
    assert not gact_cuda.supports(generic, 384, 384)
    s = gact_cuda._scoring(PS)
    assert s.dtype == np.int32 and s.shape == (29,)
    assert list(s[25:]) == [-4, -2, -25, -1]


def test_cuda_result_shapes(monkeypatch):
    """The FFI calls' declared results, traced abstractly (no kernel runs
    and nothing is built)."""
    monkeypatch.setattr(gact_cuda, "_register", lambda: None)
    B, qt, rt = 8, 384, 384
    q = jax.ShapeDtypeStruct((B, qt), jnp.uint8)
    r = jax.ShapeDtypeStruct((B, rt), jnp.uint8)
    n = jax.ShapeDtypeStruct((B,), jnp.int32)
    score, rec, qs, rs = jax.eval_shape(
        lambda *a: gact_cuda.extend_records(*a, PS, 768), q, r, n, n)
    assert rec.shape == (rt, B) and rec.dtype == jnp.int32
    assert score.shape == qs.shape == rs.shape == (B,)
    assert gact_cuda.extend_result_shapes(B, 100, 90)[4].shape == \
        (B, 90, 128)                                   # trace pitch 32 * R
    fs = jax.eval_shape(lambda *a: gact_cuda.filter_scores(*a, PS),
                        q, r, n, n)
    assert [x.shape for x in fs] == [(B,)] * 3


def test_kernel_choice_by_platform(monkeypatch):
    monkeypatch.delenv("DARWIN_TPU_KERNEL", raising=False)
    dispatch.select_kernel("")
    for plat, want in (("cpu", "lax"), ("gpu", "cuda")):
        monkeypatch.setattr(dispatch, "_platform", lambda p=plat: p)
        assert dispatch.kernel_name() == want
    assert dispatch.tile_impl(PS, 384, 384) is gact_cuda
    assert dispatch.tile_impl(PS, 1984, 960) is gact       # plain
    monkeypatch.setattr(dispatch, "_platform", lambda: "metal")
    with pytest.raises(RuntimeError, match="no device path"):
        dispatch.kernel_name()
    monkeypatch.setattr(dispatch, "_platform", lambda: "cpu")
    monkeypatch.setenv("DARWIN_TPU_KERNEL", "cuda")
    with pytest.raises(ValueError, match="needs a GPU"):
        dispatch.kernel_name()
    monkeypatch.setenv("DARWIN_TPU_KERNEL", "lax")
    assert dispatch.tile_impl(PS, 384, 384) is gact


def test_pallas_rejected(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="valid values: lax, cuda"):
        dispatch.select_kernel("pallas")
    monkeypatch.setenv("DARWIN_TPU_KERNEL", "pallas")
    with pytest.raises(ValueError, match="valid values"):
        dispatch.kernel_name()
    monkeypatch.delenv("DARWIN_TPU_KERNEL")
    from darwin_tpu.pipeline.align import run
    cfg = Config()
    cfg.processor_library = "pallas"
    with pytest.raises(ValueError, match="unknown tile kernel 'pallas'"):
        run(str(tmp_path / "none.fa"), str(tmp_path / "none.fa"), False,
            cfg=cfg)
    dispatch.select_kernel("")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["filter_128", "extend_384"])
def test_cuda_matches_plain(gpu, case):
    import chip_smoke
    B, qt = (64, 128) if case == "filter_128" else (64, 384)
    chip_smoke.check_tiles(case.split("_")[0], B, qt, qt, PS)
