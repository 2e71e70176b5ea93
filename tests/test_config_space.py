"""Non-default scoring configurations vs the oracle.

All golden tests run the default params.cfg scores; the fused dispatch
rounds bake the substitution matrix and gap scores in as static
constants, so a config-space sweep is the only thing standing between a
wiring mistake and silently wrong output for users with custom params.cfg
files.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from darwin_tpu.config import Config
from darwin_tpu.ops import gact, records, oracle as orc
from tests.conftest import mutate, random_codes
from tests.test_gact_device import _make_batch

# (gact_sub_mat upper triangle + N, gap_open, gap_extend, long_open, long_ext)
CONFIGS = [
    # default-ish but asymmetric substitution scores
    ((3, -5, -2, -7, 4, -6, -1, 2, -8, 5, -3), -5, -1, -30, -1),
    # transition/transversion-style matrix, single-piece-like long gaps
    ((1, -4, -1, -4, 1, -4, -1, 1, -4, 1, 0), -2, -1, -2, -1),
    # heavy long-gap regime
    ((2, -6, -6, -6, 2, -6, -6, 2, -6, 2, -1), -10, -8, -12, -1),
]


def _round_tiles(args, params, max_tb):
    """The fused round's tile functions (static scoring, records folded on
    the device) on the same batch, with the records expanded to ops: the
    max-cell filter tiles' score and the end-cell extension tiles' walk."""
    q, r, ql, rl, se = args[:5]
    ps = gact.static_params(params)
    fs = jax.jit(gact.filter_scores, static_argnums=4)(q, r, ql, rl, ps)
    es, rec, _, _ = jax.jit(gact.extend_records, static_argnums=(4, 5))(
        q, r, ql, rl, ps, max_tb)
    se = np.asarray(se)
    score = np.where(se, np.asarray(es), np.asarray(fs[0]))
    ops, n_ops = records.expand_records(np.asarray(rec), len(se),
                                        q.shape[1] + r.shape[1])
    # max-cell tiles walk from the max cell, which the extension tiles'
    # end-cell walk does not: compare walks on start_end tiles only
    return {"score": score, "ops": ops,
            "n_ops": np.where(se, n_ops, -1)}


@pytest.mark.parametrize("idx", range(len(CONFIGS)))
def test_custom_scoring_matches_oracle(rng, idx):
    sub_mat, go, ge, gol, gel = CONFIGS[idx]
    cfg = Config()
    cfg.gact_sub_mat = list(sub_mat)
    cfg.gap_open, cfg.gap_extend = go, ge
    cfg.long_gap_open, cfg.long_gap_extend = gol, gel
    params = gact.make_params(cfg)
    SUB = np.array(cfg.sub_matrix_5x5, np.int32)

    B, QT, RT = 10, 56, 64
    qcodes, rcodes, qlens, rlens, start_end = _make_batch(rng, B, QT, RT)
    args = (jnp.asarray(qcodes), jnp.asarray(rcodes), jnp.asarray(qlens),
            jnp.asarray(rlens), jnp.asarray(start_end), params)

    lax_res = gact.align_and_traceback(*args, 2 * QT)
    pal_res = _round_tiles(args, params, 2 * QT)
    for b in range(B):
        ref = orc.align_with_traceback(
            qcodes[b, :qlens[b]], rcodes[b, :rlens[b]], SUB,
            go, ge, gol, gel, bool(start_end[b]), 2 * QT)
        assert int(lax_res["score"][b]) == ref["score"], (idx, b)
        assert int(pal_res["score"][b]) == ref["score"], (idx, b)
        n = int(lax_res["n_ops"][b])
        assert n == len(ref["ops"]), (idx, b)
        assert list(np.asarray(lax_res["ops"])[b, :n]) == ref["ops"], (idx, b)
        if start_end[b]:
            assert int(pal_res["n_ops"][b]) == n, (idx, b)
            assert list(pal_res["ops"][b, :n]) == ref["ops"], (idx, b)


# generic-domain scorings (open cheaper than extend on one or both lanes)
GENERIC_CONFIGS = [
    (-1, -5, -3, -9),     # both lanes open < extend
    (-1, -5, -25, -1),    # short lane generic, long lane prefix
    (-4, -2, -3, -9),     # short lane prefix, long lane generic
    (-2, -7, -2, -7),     # identical lanes, generic
]


@pytest.mark.parametrize("gaps", GENERIC_CONFIGS)
def test_open_cheaper_than_extend_generic_path(rng, gaps):
    """gap_open > gap_extend invalidates the prefix-max gap scan; such
    scorings (the reference accepts any, software/Processor.cpp:48-80) run
    the generic max-plus associative scan — in the serial-walker path and
    in the fused round's tile functions (which the CUDA kernels route to
    the plain path, gact_cuda.supports) — and must match the oracle's
    coupled recurrence exactly."""
    cfg = Config()
    cfg.gap_open, cfg.gap_extend = gaps[0], gaps[1]
    cfg.long_gap_open, cfg.long_gap_extend = gaps[2], gaps[3]
    params = gact.make_params(cfg)
    assert not gact.prefix_ok(params)
    SUB = np.array(cfg.sub_matrix_5x5, np.int32)

    B, QT, RT = 8, 48, 56
    qcodes, rcodes, qlens, rlens, start_end = _make_batch(rng, B, QT, RT)
    args = (jnp.asarray(qcodes), jnp.asarray(rcodes), jnp.asarray(qlens),
            jnp.asarray(rlens), jnp.asarray(start_end), params)
    res = gact.align_and_traceback(*args, 2 * QT)
    pal = _round_tiles(args, params, 2 * QT)
    for b in range(B):
        ref = orc.align_with_traceback(
            qcodes[b, :qlens[b]], rcodes[b, :rlens[b]], SUB,
            cfg.gap_open, cfg.gap_extend, cfg.long_gap_open,
            cfg.long_gap_extend, bool(start_end[b]), 2 * QT)
        assert int(res["score"][b]) == ref["score"], b
        n = int(res["n_ops"][b])
        assert n == len(ref["ops"]), b
        assert list(np.asarray(res["ops"])[b, :n]) == ref["ops"], b
        assert int(pal["score"][b]) == ref["score"], b
        if start_end[b]:
            assert int(pal["n_ops"][b]) == n, b
            assert list(pal["ops"][b, :n]) == ref["ops"], b


def test_generic_large_tile_round_matches_walker(rng):
    """Large-tile (escalation) geometry under a generic scoring through the
    fused round's tile function: records folded on the device must expand
    to the serial walker's ops."""
    cfg = Config()
    cfg.gap_open, cfg.gap_extend = -1, -5
    cfg.long_gap_open, cfg.long_gap_extend = -3, -9
    params = gact.make_params(cfg)

    B, QT, RT = 4, 640, 96
    qcodes, rcodes, qlens, rlens, _ = _make_batch(rng, B, QT, RT)
    qlens = np.maximum(qlens, 520)
    start_end = np.ones(B, bool)
    args = (jnp.asarray(qcodes), jnp.asarray(rcodes), jnp.asarray(qlens),
            jnp.asarray(rlens), jnp.asarray(start_end), params)
    lax_res = gact.align_and_traceback(*args, 2 * QT, all_start_end=True)
    pal_res = _round_tiles(args, params, 2 * QT)
    assert np.array_equal(np.asarray(lax_res["score"]), pal_res["score"])
    for b in range(B):
        n = int(lax_res["n_ops"][b])
        assert int(pal_res["n_ops"][b]) == n, b
        assert np.array_equal(np.asarray(lax_res["ops"])[b, :n],
                              pal_res["ops"][b, :n]), b
