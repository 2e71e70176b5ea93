"""The fused dispatch round's tile functions and their plumbing.

The plain tile implementation (gact.filter_scores / gact.extend_records:
static scoring, traceback folded into per-column records on the device)
must reproduce the serial walker of gact.align_and_traceback — itself
oracle-checked in test_gact_device.py — bit for bit.  The CUDA kernels
are tested in test_gact_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from darwin_tpu.config import Config
from darwin_tpu.ops import dispatch, gact, records
from tests.test_gact_device import _make_batch

PARAMS = gact.make_params(Config())
PS = gact.static_params(PARAMS)

_extend = jax.jit(gact.extend_records, static_argnums=(4, 5))
_filter = jax.jit(gact.filter_scores, static_argnums=4)


def _walk_vs_records(rng, B, QT, RT, max_tb, qlens_min=1):
    qcodes, rcodes, qlens, rlens, _ = _make_batch(rng, B, QT, RT)
    qlens = np.maximum(qlens, qlens_min)
    args = (jnp.asarray(qcodes), jnp.asarray(rcodes), jnp.asarray(qlens),
            jnp.asarray(rlens))
    ref = gact.align_and_traceback(*args, jnp.ones(B, bool), PARAMS, max_tb,
                                   all_start_end=True)
    score, rec, qs, rs = _extend(*args, PS, max_tb)
    assert rec.shape == (RT, B)
    ops, n_ops = records.expand_records(np.asarray(rec), B, QT + RT)
    np.testing.assert_array_equal(np.asarray(ref["score"]), score)
    np.testing.assert_array_equal(np.asarray(ref["n_ops"]), n_ops)
    np.testing.assert_array_equal(np.asarray(ref["q_steps"]), qs)
    np.testing.assert_array_equal(np.asarray(ref["r_steps"]), rs)
    ops_ref = np.asarray(ref["ops"])
    for b in range(B):
        n = int(n_ops[b])
        np.testing.assert_array_equal(ops_ref[b, :n], ops[b, :n],
                                      err_msg=f"tile {b}")


def test_round_records_match_walker(rng):
    _walk_vs_records(rng, 12, 64, 80, 128)


@pytest.mark.parametrize("max_tb", [7, 10])
def test_round_max_tb_cap(rng, max_tb):
    """Records truncate at the max_tb step cap exactly like the walker."""
    _walk_vs_records(rng, 8, 48, 48, max_tb, qlens_min=40)


def test_round_large_tiles(rng):
    """Large (escalation-shaped) tiles take the plain path on every
    platform; a QT beyond 512 rows must still fold exactly."""
    _walk_vs_records(rng, 4, 600, 32, 1200, qlens_min=520)


def test_round_filter_scores_match_batch_align(rng):
    """Max-cell (filter) tiles: score and the earliest max cell."""
    B, QT, RT = 16, 72, 72
    qcodes, rcodes, qlens, rlens, _ = _make_batch(rng, B, QT, RT)
    args = (jnp.asarray(qcodes), jnp.asarray(rcodes), jnp.asarray(qlens),
            jnp.asarray(rlens))
    ref = gact.batch_align(*args, jnp.zeros(B, bool), PARAMS,
                           with_trace=False)
    got = _filter(*args, PS)
    for k, v in zip(("score", "query_max_pos", "ref_max_pos"), got):
        np.testing.assert_array_equal(np.asarray(ref[k]), v, err_msg=k)


def test_records_multi_run_column():
    """Two I-runs in one column (reachable only through exact gap-lane
    ties) fold into one record: the walker never spills."""
    QT, RT, B = 32, 8, 4
    tr = np.zeros((RT, B, QT), np.uint8)
    INS, INS_L, DIAG = gact.T8_INS, gact.T8_INS_L, gact.T8_DIAG
    tr[3, 0, 5] = INS                       # run 1: ext
    tr[3, 0, 4] = INS | gact.F_OPEN8        # run 1: open -> DIAG
    tr[3, 0, 3] = INS_L | gact.FL_OPEN8     # run 2 (one cell) -> DIAG
    tr[3, 0, 2] = DIAG                      # closing M
    tr[2, 0, 1] = 0                         # ZERO: walk ends
    sq = np.array([5, -1, -1, -1], np.int32)
    sr = np.array([3, -1, -1, -1], np.int32)
    rec, qs, rs = jax.jit(gact.traceback_records, static_argnums=3)(
        jnp.asarray(tr), jnp.asarray(sq), jnp.asarray(sr), 64)
    rec = np.asarray(rec)
    assert rec[3, 0] == 3 | (3 << 14)       # three I ops, closing M
    assert not rec[:, 1:].any()
    ops, n_ops = records.expand_records(rec, 1, QT + RT)
    assert list(ops[0][:int(n_ops[0])]) == [1, 1, 1, 3]  # I I I M
    assert int(qs[0]) == 4 and int(rs[0]) == 1


@pytest.mark.parametrize("bits", [8, 4])
def test_compact_records_roundtrip(bits):
    """Compact records expand to the wide ones; an insert run wider than
    the nI field flags its lane."""
    rng = np.random.default_rng(bits)
    nmax = (1 << (bits - 2)) - 1
    RT, B = 24, 6
    nI = rng.integers(0, nmax + 1, size=(RT, B))
    cl = rng.integers(0, 4, size=(RT, B))
    rec = (nI | (cl << 14)).astype(np.int32)
    rec[5, 4] = nmax + 1                    # overflow in lane 4
    packed, ovf = records.compact_records(jnp.asarray(rec), bits)
    assert packed.shape == (-(-RT // (16 // bits)), B)
    assert list(np.asarray(ovf)) == [0, 0, 0, 0, 1, 0]
    ok = [0, 1, 2, 3, 5]
    o1, n1 = records.expand_records(rec[:, ok], len(ok), 4 * RT)
    o2, n2 = records.expand_records_packed(np.asarray(packed)[:, ok],
                                           len(ok), 4 * RT, bits=bits)
    np.testing.assert_array_equal(n1, n2)
    np.testing.assert_array_equal(o1, o2)


def test_subset_requests():
    req = np.arange(9 * 7, dtype=np.uint32).reshape(9, 7)
    idx = np.array([2, 5])
    sub = np.asarray(dispatch._subset_requests(req, idx))
    assert sub.shape == (9, dispatch.pad_batch(2))
    np.testing.assert_array_equal(sub[:, 0], req[:, 2])
    np.testing.assert_array_equal(sub[:, 1], req[:, 5])
    # benign padding: sizes 1 (rows 1/3/6/8), addresses 0
    assert (sub[1, 2:] == 1).all() and (sub[3, 2:] == 1).all()
    assert (sub[6, 2:] == 1).all() and (sub[8, 2:] == 1).all()
    assert (sub[0, 2:] == 0).all() and (sub[2, 2:] == 0).all()


def test_pad_batch_powers_of_two():
    assert [dispatch.pad_batch(b) for b in (1, 8, 9, 128, 129, 512)] == \
        [8, 8, 16, 128, 256, 512]
