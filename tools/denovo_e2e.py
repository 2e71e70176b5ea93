"""Assembly-scale de novo (overlap) demonstration — the reference's
headline use case (/root/reference/README.md, software/README.md:25-27:
all-vs-all overlap of a long-read set, reads-as-index).

Simulates N reads x L bp at ~`coverage`x depth from a synthetic genome,
runs overlap mode end-to-end (the reads file is BOTH the index and the
query stream), and records reads/s, peak RSS, and output volume into
denovo.json.  Optionally spot-verifies the MHAP output byte-identical
against the compiled reference binary on a read subsample
(--check-subsample N; uses tests/ref_binary.py).

Run: python tools/denovo_e2e.py [--reads 5000] [--read-len 10000]
         [--coverage 8] [--check-subsample 500]
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)




def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=5000)
    ap.add_argument("--read-len", type=int, default=10000)
    ap.add_argument("--coverage", type=float, default=8.0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--check-subsample", type=int, default=0)
    ap.add_argument("--out", default="denovo.json")
    ap.add_argument("--workdir", default="/tmp/denovo_e2e")
    args = ap.parse_args()

    from darwin_tpu.config import Config
    from darwin_tpu.genome import GenomeStore
    from darwin_tpu.pipeline.align import run, enable_compile_cache
    from darwin_tpu.utils.simulate import simulate_reads, write_fasta

    enable_compile_cache()
    os.makedirs(args.workdir, exist_ok=True)

    genome_bp = int(args.reads * args.read_len / args.coverage)
    rng = np.random.default_rng(7)
    store = GenomeStore()
    bases = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=genome_bp, dtype=np.uint8)]
    store.add_chromosome("g", bases)
    store.finalize()
    sim = simulate_reads(store, args.reads, args.read_len, seed=11)
    reads_fa = os.path.join(args.workdir, "reads.fa")
    write_fasta(reads_fa, sim)
    print(f"simulated {len(sim)} x {args.read_len} bp reads "
          f"({args.coverage}x of {genome_bp / 1e6:.1f} Mbp)", flush=True)

    # RSS timeline: sample VmRSS every second so retention shows up as a
    # ramp correlated with batch progress, not just a peak number
    import threading
    rss_samples = []
    stop_rss = threading.Event()

    def _vmrss_gb():
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) / 1e6
        return 0.0

    def _rss_loop():
        t_start = time.time()
        while not stop_rss.wait(1.0):
            rss_samples.append((round(time.time() - t_start, 1),
                                round(_vmrss_gb(), 2)))

    threading.Thread(target=_rss_loop, daemon=True).start()

    cfg = Config()
    out_path = os.path.join(args.workdir, "out.mhap")
    stats = {}
    t0 = time.time()
    with open(out_path, "w") as sink:
        run(reads_fa, reads_fa, True, cfg=cfg, out=sink,
            reads_per_batch=args.batch, stats_out=stats)
    dt = time.time() - t0
    stop_rss.set()
    n_lines = sum(1 for _ in open(out_path))
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    res = {
        "reads": args.reads, "read_len": args.read_len,
        "coverage": args.coverage, "genome_mbp": round(genome_bp / 1e6, 1),
        "seconds": round(dt, 1),
        "align_seconds": stats.get("align_seconds"),
        "reads_per_s": round(args.reads / dt, 2),
        "mhap_records": n_lines // 6,   # record + 2 aligned strs, both dirs
        "peak_rss_gb": round(rss_gb, 2),
        "stage_seconds": stats.get("stage_seconds"),
        "stage_seconds_cold": stats.get("stage_seconds_cold"),
        "stage_seconds_warm": stats.get("stage_seconds_warm"),
        "compile_s": stats.get("compile_s"),
        "rss_timeline_gb": rss_samples[::max(len(rss_samples) // 60, 1)],
        "counters": stats.get("counters"),
    }

    if args.check_subsample:
        n = args.check_subsample
        sub_fa = os.path.join(args.workdir, "sub.fa")
        write_fasta(sub_fa, sim[:n])
        sub_out = os.path.join(args.workdir, "sub.mhap")
        with open(sub_out, "w") as sink:
            run(sub_fa, sub_fa, True, cfg=Config(), out=sink)
        from tests import ref_binary
        path = ref_binary.build()
        if path is None:
            res["subsample_check"] = "skipped (no toolchain)"
        else:
            # both sides read params.cfg from cwd (main.cpp:178)
            import shutil
            shutil.copy("/root/reference/software/params.cfg",
                        os.path.join(args.workdir, "params.cfg"))
            ref_out = ref_binary.run(sub_fa, sub_fa, True,
                                     cwd=args.workdir, timeout=3600)
            ours = open(sub_out).read()
            res["subsample_reads"] = n
            if ours == ref_out:
                res["subsample_check"] = "identical"
            else:
                # the reference's stripe-geometry tie-breaks can pick a
                # different equal-score path (utils/rescore.py); those
                # surface in MHAP as a tiny match-count/error delta with
                # identical coordinates and are not a mismatch
                from darwin_tpu.utils.rescore import classify_mhap
                cls = classify_mhap(ref_out, ours, Config())
                if cls["hard"]:
                    # an equal-score tile tie can reroute the greedy
                    # tiling (different coords/strings downstream); the
                    # tile-level audit decides whether every tile we
                    # issued was exact-or-pinned-tie vs the ref kernel
                    import tile_audit
                    aud = tile_audit.audit(sub_fa, sub_fa, Config(),
                                           do_overlap=True)
                    res["subsample_tile_audit"] = {
                        k: aud[k] for k in ("tiles", "exact", "tie",
                                            "hard")}
                    res["subsample_check"] = (
                        "tie_cascade" if aud["hard"] == 0 else "MISMATCH")
                    res["subsample_hard"] = len(cls["hard"])
                else:
                    res["subsample_check"] = "tie_equivalent"
                res["subsample_tie_equivalent"] = cls["tie_equivalent"]
                with open(os.path.join(args.workdir, "ref.mhap"), "w") as f:
                    f.write(ref_out)

    print(json.dumps(res))
    with open(os.path.join(REPO, args.out), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    import faulthandler
    import signal
    faulthandler.register(signal.SIGUSR1)   # kill -USR1: dump stacks, live
    main()
