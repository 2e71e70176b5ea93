"""SV-dense workload: fire the large-tile escalation path at scale.

Reads are split-alignments: left segment + a skipped reference gap
(600-1500 bp deletion relative to the reference) + right segment.  The
extension that crosses the junction gets a zero-progress 384-tile (the
corner cell zero-clamps in divergent sequence) while chained hits remain
beyond the gap — exactly the escalation trigger
(/root/reference/software/extender.cpp:353-394) — and the 1984x960 large
tile oriented by the gap direction bridges it.

Artifact: sv.json with num_large_tiles > 0, correct-locus stats, a
stage table, and a read subsample byte-compared against the compiled
reference binary (same cwd/params.cfg).

Run: python tools/sv_e2e.py [--mbp 20] [--reads 256] [--check-subsample 48]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse
import json
import time

import numpy as np

REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def make_sv_reads(store, rng, n: int, sv_frac: float = 0.75):
    """(name, seq) reads; ~sv_frac carry one deletion-SV junction.
    Names follow the simulate_reads convention (read{i}_{chr}_{start}_{+})
    so correct-locus checks parse them identically."""
    from darwin_tpu.genome import revcomp_bytes
    c = store.chromosomes[0]
    reads = []
    n_sv = 0
    for i in range(n):
        seg = int(rng.integers(2000, 4000))
        is_sv = rng.random() < sv_frac
        gap = int(rng.integers(600, 1500)) if is_sv else 0
        n_sv += is_sv
        span = 2 * seg + gap
        s0 = int(rng.integers(0, c.length_unpadded - span - 1))
        seq = np.concatenate(
            [store.bases[c.start + s0:c.start + s0 + seg],
             store.bases[c.start + s0 + seg + gap:
                         c.start + s0 + span]]).copy()
        idx = rng.integers(0, len(seq), size=len(seq) // 50)  # ~2% subs
        seq[idx] = _ACGT[rng.integers(0, 4, len(idx))]
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            seq = revcomp_bytes(seq)
        reads.append((f"read{i}_{c.name}_{s0}_{strand}", seq))
    return reads, n_sv


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=20.0)
    ap.add_argument("--reads", type=int, default=256)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--check-subsample", type=int, default=48)
    ap.add_argument("--out", default="sv.json")
    ap.add_argument("--workdir", default="/tmp/sv_e2e")
    args = ap.parse_args()

    from darwin_tpu.config import Config
    from darwin_tpu.genome import GenomeStore, make_read
    from darwin_tpu.pipeline.align import Aligner, enable_compile_cache
    from bigref_e2e import align_pipelined

    enable_compile_cache()
    _os.makedirs(args.workdir, exist_ok=True)
    rng = np.random.default_rng(17)
    store = GenomeStore()
    store.add_chromosome(
        "svchr1", _ACGT[rng.integers(0, 4, int(args.mbp * 1e6),
                                     dtype=np.uint8)])
    store.finalize()

    named, n_sv = make_sv_reads(store, rng, args.reads)
    reads = [make_read(n, s) for n, s in named]
    print(f"{len(reads)} reads, {n_sv} with a deletion SV", flush=True)

    cfg = Config()
    t0 = time.time()
    aligner = Aligner(cfg, store)
    build_s = time.time() - t0

    res = {"genome_mbp": round(store.size / 1e6, 1),
           "reads_sv": n_sv, "build_seconds": round(build_s, 1)}
    res.update(align_pipelined(aligner, reads, args.batch))
    lt = res["counters"]["num_large_tiles"]
    res["large_tiles_fired"] = lt > 0
    print(f"num_large_tiles = {lt}", flush=True)

    if args.check_subsample:
        # byte-identity vs the compiled reference binary on a subsample
        # (same cwd/params.cfg contract as tools/fuzz_ref_e2e.py)
        import shutil
        n = args.check_subsample
        ref_fa = _os.path.join(args.workdir, "genome.fa")
        with open(ref_fa, "w") as f:
            c = store.chromosomes[0]
            f.write(f">{c.name}\n")
            b = store.bases[c.start:c.start + c.length_unpadded]
            f.write(bytes(b).decode() + "\n")
        sub_fa = _os.path.join(args.workdir, "sub.fa")
        with open(sub_fa, "w") as f:
            for nm, s in named[:n]:
                f.write(f">{nm}\n{bytes(s).decode()}\n")
        shutil.copy("/root/reference/software/params.cfg",
                    _os.path.join(args.workdir, "params.cfg"))
        from darwin_tpu.pipeline.align import run
        import io
        buf = io.StringIO()
        old = _os.getcwd()
        try:
            _os.chdir(args.workdir)
            sub_cnt = run(ref_fa, sub_fa, False, cfg=Config(), out=buf,
                          err=io.StringIO())
        finally:
            _os.chdir(old)
        res["subsample_reads"] = n
        res["subsample_large_tiles"] = int(sub_cnt["num_large_tiles"])
        _sys.path.insert(0, _os.path.join(REPO, "tests"))
        import ref_binary
        path = ref_binary.build()
        if path is None:
            res["subsample_check"] = "skipped (no toolchain)"
        else:
            ref_out = ref_binary.run(ref_fa, sub_fa, False,
                                     cwd=args.workdir, timeout=3600)
            ours = buf.getvalue()
            if ours == ref_out:
                res["subsample_check"] = "identical"
            else:
                from darwin_tpu.utils.rescore import classify_sam
                cls = classify_sam(ref_out, ours, ref_fa, Config())
                res["subsample_check"] = (
                    "tie_equivalent" if not cls["hard"] else "MISMATCH")
                res["subsample_tie_equivalent"] = cls["tie_equivalent"]
                res["subsample_hard"] = len(cls["hard"])
                with open(_os.path.join(args.workdir, "ref.sam"), "w") as f:
                    f.write(ref_out)
                with open(_os.path.join(args.workdir, "ours.sam"), "w") as f:
                    f.write(ours)

    print(json.dumps(res))
    with open(_os.path.join(REPO, args.out), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    import faulthandler
    import signal
    faulthandler.register(signal.SIGUSR1)   # kill -USR1: dump stacks, live
    main()
