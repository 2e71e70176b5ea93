"""Golden-tile parity against the reference's RTL test harness.

The reference ships 10 fixed 320x320 ref/query pairs for the GACT hardware
(RTL/GACT/test_data/{ref,query}_320.txt) plus the alignments its Verilog
simulation produces (test_align.txt, written by RTL/GACT/get_alignments.py
from the simulated traceback stream).  The testbench scoring is match=+1,
mismatch=-1, gap open/extend=-1, traceback from the max cell, max_tb=400
(RTL/GACT/tb_GACTTop.v:133-157).

This locks our kernel against that hardware golden set:

* tile score == the RTL's "Total score" on all 10 pairs;
* our traceback reconstructs an alignment of exactly that score (the gap
  params are linear here, so the recomputed score is unambiguous);
* on the 8 pairs where the RTL's tie-breaking agrees with the software SIMD
  kernel's (the spec we implement — the binary wires DualAlignSIMD, not the
  RTL), the aligned strings are byte-identical.  Pairs 4 and 7 contain exact
  score ties that the RTL's PE priority (SmithWatermanPE.v:149-201) resolves
  differently; both alignments are co-optimal (equal recomputed score).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from darwin_tpu.genome import encode5
from darwin_tpu.ops import gact
from darwin_tpu.ops import oracle as orc

TD = "/root/reference/RTL/GACT/test_data"
RTL_EXACT_MATCH = {0, 1, 2, 3, 5, 6, 8, 9}


def _load():
    refs = open(f"{TD}/ref_320.txt").read().split()
    qrys = open(f"{TD}/query_320.txt").read().split()
    exp = open(f"{TD}/test_align.txt").read().splitlines()
    blocks = [(exp[3 * i], exp[3 * i + 1], int(exp[3 * i + 2].split()[-1]))
              for i in range(10)]
    return refs, qrys, blocks


def _aligned_strings(ref, qry, ops, n_ops, rpos, qpos):
    ra, qa = [], []
    ri, qi = int(rpos), int(qpos)
    for op in ops[:n_ops]:
        if op == orc.OP_M:
            ra.append(ref[ri]); qa.append(qry[qi]); ri -= 1; qi -= 1
        elif op == orc.OP_I:
            ra.append("-"); qa.append(qry[qi]); qi -= 1
        elif op == orc.OP_D:
            ra.append(ref[ri]); qa.append("-"); ri -= 1
    return "".join(reversed(ra)), "".join(reversed(qa))


def _linear_score(ra, qa):
    s = 0
    for a, b in zip(ra, qa):
        if a == "-" or b == "-":
            s -= 1
        else:
            s += 1 if a == b else -1
    return s


@pytest.mark.parametrize("backend", ["lax"])
def test_rtl_golden_tiles(backend):
    refs, qrys, blocks = _load()
    sub = np.full((5, 5), -1, np.int32)
    np.fill_diagonal(sub, 1)
    sub[4, :] = -1
    sub[:, 4] = -1
    params = gact.GactParams(jnp.asarray(sub), jnp.int32(-1), jnp.int32(-1),
                             jnp.int32(-1), jnp.int32(-1))
    B, T = 10, 320
    qc = np.zeros((B, T), np.uint8)
    rc = np.zeros((B, T), np.uint8)
    for i, (r, q) in enumerate(zip(refs, qrys)):
        rc[i] = encode5(np.frombuffer(r.encode(), np.uint8))
        qc[i] = encode5(np.frombuffer(q.encode(), np.uint8))
    args = (jnp.asarray(qc), jnp.asarray(rc),
            jnp.full(B, T, jnp.int32), jnp.full(B, T, jnp.int32),
            jnp.zeros(B, bool), params, 400)
    out = gact.align_and_traceback(*args)
    scores = np.asarray(out["score"])
    ops = np.asarray(out["ops"])
    n_ops = np.asarray(out["n_ops"])
    qp = np.asarray(out["query_max_pos"])
    rp = np.asarray(out["ref_max_pos"])

    for i, (ra_exp, qa_exp, sc_exp) in enumerate(blocks):
        assert scores[i] == sc_exp, f"pair {i}: score {scores[i]} != {sc_exp}"
        ra, qa = _aligned_strings(refs[i], qrys[i], ops[i], n_ops[i],
                                  rp[i], qp[i])
        assert _linear_score(ra, qa) == sc_exp, f"pair {i}: not co-optimal"
        if i in RTL_EXACT_MATCH:
            assert ra == ra_exp and qa == qa_exp, f"pair {i}: strings differ"
