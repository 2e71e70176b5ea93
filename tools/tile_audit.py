"""Tile-level audit of an end-to-end divergence (CPU, lax backend).

When an output-level divergence vs the reference binary is NOT
rescore-equal (utils/rescore.py), it can still be legitimate: an
equal-score stripe-geometry tie inside ONE tile sends the greedy GACT
tiling down a different route, and the two routes' final alignments need
not score identically (GACT is a heuristic).  The rigorous check is at
the tile level: re-run the pipeline, capture every extension-tile
request it issued, and replay each against the compiled reference kernel
(tests/ref_kernel.py).  A divergence is adjudicated as a tie cascade iff
every tile is either bit-identical to the reference kernel or a pinned
tie (striped_align == reference, clean_align == ours, equal scores) —
anything else is a real kernel/pipeline bug.

Library use: audit(ref_fa, reads_fa, cfg) -> {"tiles", "exact", "tie",
"hard", "hard_detail"}.  CLI: python tools/tile_audit.py REF.fa READS.fa.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


import numpy as np  # noqa: E402


def _p15(cfg):
    return list(cfg.gact_sub_mat) + [cfg.gap_open, cfg.gap_extend,
                                     cfg.long_gap_open, cfg.long_gap_extend]


def audit(ref_fa: str, reads_fa: str, cfg, batch: int = 128,
          do_overlap: bool = False) -> dict:
    """Run the (lax) pipeline on the read set, replay every extension
    tile against the reference kernel, and classify each lane.  Saves and
    restores the caller's kernel-backend selection."""
    import copy

    import jax.numpy as jnp

    import ref_kernel as rk
    from darwin_tpu.genome import encode5
    from darwin_tpu.io.fasta import iter_read_batches, load_genome
    from darwin_tpu.ops import dispatch, gact
    from darwin_tpu.ops import oracle as orc
    from darwin_tpu.pipeline import extend as ext_mod
    from darwin_tpu.pipeline.align import Aligner

    lib = rk.build()
    if lib is None:
        raise RuntimeError("reference kernel not buildable on this host")
    rk.set_scoring(lib, _p15(cfg))
    sub = rk.sub_matrix(_p15(cfg))
    go, ge = cfg.gap_open, cfg.gap_extend
    goL, geL = cfg.long_gap_open, cfg.long_gap_extend

    cfg = copy.deepcopy(cfg)
    cfg.do_overlap = do_overlap
    dispatch.select_kernel("lax")
    store = load_genome(ref_fa)

    log = []
    orig = dispatch.extend_tiles_async

    def wrapped(ref_codes, query_codes, r_start, r_size, q_start, q_size,
                rev, params, *, qt, rt, max_tb, chain=None):
        resolve = orig(ref_codes, query_codes, r_start, r_size, q_start,
                       q_size, rev, params, qt=qt, rt=rt, max_tb=max_tb,
                       chain=chain)

        def resolve2():
            res = resolve()
            log.append((np.asarray(r_start).copy(),
                        np.asarray(r_size).copy(),
                        np.asarray(q_start).copy(),
                        np.asarray(q_size).copy(),
                        np.asarray(rev).copy(), qt, rt, max_tb,
                        np.asarray(res["ops"]).copy(),
                        np.asarray(res["n_ops"]).copy()))
            return res
        return resolve2

    dispatch.extend_tiles_async = wrapped
    ext_mod.extend_tiles_async = wrapped
    try:
        aligner = Aligner(cfg, store)
        for reads in iter_read_batches(reads_fa, batch):
            aligner.align_batch(reads)
        q_codes = aligner  # keep alive
        # rebuild the gather inputs the dispatch used
        bases = np.concatenate(
            [store.bases,
             np.full(4 * cfg.large_tile_long, ord("N"), np.uint8)])
        refc = jnp.asarray(dispatch.chunk_ref_codes(encode5(bases)))
    finally:
        dispatch.extend_tiles_async = orig
        ext_mod.extend_tiles_async = orig
        dispatch.select_kernel("")

    # one ExtensionManager per batch shares the aligner's upload layout;
    # regather per logged round using the recorded absolute addresses and
    # the LAST batch's query buffer — valid only for single-batch audits,
    # so cap reads per call accordingly (the fuzz audits one read set).
    from darwin_tpu.pipeline.extend import ExtensionManager
    reads = next(iter_read_batches(reads_fa, batch))
    params = gact.make_params(cfg)
    mgr = ExtensionManager(store, reads, cfg, params)
    qc = mgr.q_codes_dev

    CODE2NT = np.frombuffer(b"ACGTN", np.uint8)
    out = {"tiles": 0, "exact": 0, "tie": 0, "hard": 0, "hard_detail": []}
    for (rs, rsz, qs, qsz, rev, qt, rt, max_tb, ops, n_ops) in log:
        qtile, rtile = dispatch.gather_tiles(
            refc, qc, jnp.asarray(rs.astype(np.uint32)),
            jnp.asarray(rsz.astype(np.int32)),
            jnp.asarray(qs.astype(np.uint32)),
            jnp.asarray(qsz.astype(np.int32)),
            jnp.asarray(rev), qt, rt)
        qtile = np.asarray(qtile)
        rtile = np.asarray(rtile)
        for b in range(rs.shape[0]):
            if int(rsz[b]) <= 1 and int(qsz[b]) <= 1:
                continue  # padding lane
            out["tiles"] += 1
            qwin = CODE2NT[qtile[b, :int(qsz[b])]]
            rwin = CODE2NT[rtile[b, :int(rsz[b])]]
            dram = rwin.tobytes() + qwin.tobytes()
            req = {"align_fields": rk.AF_START_END, "ref_addr": 0,
                   "query_addr": len(rwin), "ref_size": int(rsz[b]),
                   "query_size": int(qsz[b]), "max_tb_steps": int(max_tb)}
            ref = rk.batch(lib, dram, [req], True, simd=True)[0]
            ours = [int(o) for o in ops[b, :int(n_ops[b])]]
            if ref["ops"] == ours and ref["n_ops"] == int(n_ops[b]):
                out["exact"] += 1
                continue
            # pinned tie? striped must equal the reference, clean must
            # equal us, and the tile scores must agree
            q5 = rk.window_codes(dram, req["query_addr"],
                                 req["query_size"], False, False)
            r5 = rk.window_codes(dram, req["ref_addr"],
                                 req["ref_size"], False, False)
            s_s, _, _, tr_s = orc.striped_align(q5, r5, sub, go, ge,
                                                goL, geL, True)
            ops_s, _, _ = orc.traceback(tr_s, len(q5) - 1, len(r5) - 1,
                                        int(max_tb))
            s_c, _, _, tr_c = orc.clean_align(q5, r5, sub, go, ge,
                                              goL, geL, True)
            ops_c, _, _ = orc.traceback(tr_c, len(q5) - 1, len(r5) - 1,
                                        int(max_tb))
            if (s_s == s_c == ref["score"]
                    and [int(o) for o in ops_s] == ref["ops"]
                    and [int(o) for o in ops_c] == ours):
                out["tie"] += 1
            else:
                out["hard"] += 1
                out["hard_detail"].append(
                    {"rt": rt, "qt": qt, "ref_size": int(rsz[b]),
                     "query_size": int(qsz[b]),
                     "ref_score": ref["score"], "striped": int(s_s),
                     "clean": int(s_c)})
    return out


def main():
    import argparse
    import json

    from darwin_tpu.config import Config, load_config
    ap = argparse.ArgumentParser()
    ap.add_argument("ref_fa")
    ap.add_argument("reads_fa")
    ap.add_argument("--params", default=None)
    args = ap.parse_args()
    cfg = load_config(args.params) if args.params else Config()
    res = audit(args.ref_fa, args.reads_fa, cfg)
    res.pop("hard_detail") if not res["hard"] else None
    print(json.dumps(res))
    return 1 if res["hard"] else 0


if __name__ == "__main__":
    sys.exit(main())
