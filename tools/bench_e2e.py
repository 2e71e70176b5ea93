"""Reproducible end-to-end benchmark: synthetic genome + reads, both modes.

Usage:
    python tools/bench_e2e.py [--genome-mbp 10] [--reads 128]
                              [--read-len 10000] [--error 0.10] [--seed 3]

Generates a random genome and error-injected reads, then measures (warm,
best of REPS):
  * reference-guided mode: index build time, align time, reads/s
  * overlap (de-novo) mode: end-to-end time
and prints one summary JSON object.  Deterministic for a given seed; the
second run of each phase must be byte-identical or the script fails.

(`bench.py` at the repo root stays the driver-facing single-line kernel
benchmark; this script is the whole-pipeline companion.)
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mbp", type=float, default=10.0)
    ap.add_argument("--reads", type=int, default=128)
    ap.add_argument("--read-len", type=int, default=10000)
    ap.add_argument("--error", type=float, default=0.10,
                    help="total error rate, split 40/30/30 sub/ins/del")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()

    from darwin_tpu.config import Config
    from darwin_tpu.genome import make_read
    from darwin_tpu.io.fasta import load_genome, load_reads
    from darwin_tpu.index.seed_table import build_seed_table
    from darwin_tpu.pipeline.align import Aligner, enable_compile_cache, run
    from darwin_tpu.utils.simulate import simulate_reads

    enable_compile_cache()
    rng = np.random.default_rng(args.seed)
    tmp = tempfile.mkdtemp(prefix="darwin_bench_")
    gpath = os.path.join(tmp, "genome.fa")
    rpath = os.path.join(tmp, "reads.fa")

    n_bases = int(args.genome_mbp * 1e6)
    with open(gpath, "w") as f:
        f.write(">chr1\n")
        s = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, n_bases)].tobytes().decode()
        for i in range(0, len(s), 80):
            f.write(s[i:i + 80] + "\n")

    store = load_genome(gpath)
    e = args.error
    sim = simulate_reads(store, args.reads, args.read_len, seed=args.seed,
                         error=(0.4 * e, 0.3 * e, 0.3 * e))
    with open(rpath, "w") as f:
        for name, seq, _ in sim:
            f.write(f">{name}\n{bytes(seq).decode()}\n")

    cfg = Config()

    # ---- index build (warm) ----
    build_seed_table(store, cfg)                     # compile + warm
    t0 = time.perf_counter()
    table = build_seed_table(store, cfg)
    t_build = time.perf_counter() - t0

    # ---- reference-guided align phase (warm, best of REPS) ----
    reads = load_reads(rpath)
    al = Aligner(cfg, store, table=table)
    base = al.align_batch(reads)
    t_align = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        lines = al.align_batch(reads)
        t_align = min(t_align, time.perf_counter() - t0)
        assert lines == base, "nondeterministic output"
    body = [ln for ln in base if not ln.startswith("@")]
    correct = sum(
        1 for ln in body
        if abs(int(ln.split("\t")[3]) - 1
               - int(ln.split("\t")[0].split("_")[-2])) < 2000)

    # ---- overlap mode end-to-end (warm, best of REPS) ----
    out0 = io.StringIO()
    run(rpath, rpath, True, cfg=Config(), out=out0, err=io.StringIO())
    t_ovl = float("inf")
    for _ in range(REPS):
        o = io.StringIO()
        t0 = time.perf_counter()
        run(rpath, rpath, True, cfg=Config(), out=o, err=io.StringIO())
        t_ovl = min(t_ovl, time.perf_counter() - t0)
        assert o.getvalue() == out0.getvalue(), "nondeterministic output"

    print(json.dumps({
        "genome_mbp": args.genome_mbp,
        "reads": args.reads,
        "read_len": args.read_len,
        "index_build_s": round(t_build, 3),
        "align_s": round(t_align, 3),
        "reads_per_s": round(args.reads / t_align, 1),
        "aligned": len(body),
        "correct_locus": correct,
        "overlap_e2e_s": round(t_ovl, 3),
        "overlap_records": out0.getvalue().count("\n"),
    }))


if __name__ == "__main__":
    main()
