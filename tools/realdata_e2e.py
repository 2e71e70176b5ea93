"""Realistic-data artifact: repeat-structured genome +
ONT-like reads, guided and overlap configs.

Real-data configs (E. coli K-12 PacBio, human chr21 ONT)
cannot be fetched here (no egress; the reference repo's own reads file is
a stripped blob, /root/reference/.MISSING_LARGE_BLOBS).  This harness
substitutes the property those datasets actually stress: repeat structure
(utils/synthgenome.py — SINE/LINE/tandem/segdup at ~chr21 fractions) and
an ONT-like error/length profile (3 % sub / 3 % ins / 4 % del, log-normal
lengths).  Records correct-locus rate, the occupancy-cap hit statistics
(num_capped_buckets — zero on uniform synthetics, nonzero here), stage
timings, and overlap-mode throughput.

Run: python tools/realdata_e2e.py [--mbp 100] [--reads 512]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=100.0)
    ap.add_argument("--reads", type=int, default=512)
    ap.add_argument("--overlap-reads", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--out", default="realdata.json")
    args = ap.parse_args()

    from darwin_tpu.config import Config
    from darwin_tpu.genome import GenomeStore, make_read
    from darwin_tpu.pipeline.align import Aligner, enable_compile_cache
    from darwin_tpu.utils.simulate import ont_lengths, simulate_reads
    from darwin_tpu.utils.synthgenome import repeat_genome
    from bigref_e2e import align_pipelined

    enable_compile_cache()
    rng = np.random.default_rng(42)
    t0 = time.time()
    bases, gstats = repeat_genome(rng, int(args.mbp * 1e6))
    print(f"repeat genome: {len(bases) / 1e6:.1f} Mbp {gstats} "
          f"({time.time() - t0:.0f}s)", flush=True)
    store = GenomeStore()
    store.add_chromosome("rchr1", bases)
    store.finalize()

    res = {"genome_mbp": round(len(bases) / 1e6, 1),
           "genome_stats": gstats}

    # ---- guided mode: ONT-like reads vs the repeat genome ----
    lens = ont_lengths(rng, args.reads)
    sim = simulate_reads(store, args.reads, 0, seed=5,
                         error=(0.03, 0.03, 0.04), read_lens=lens)
    reads = [make_read(n, s) for n, s, _ in sim]
    cfg = Config()
    t0 = time.time()
    aligner = Aligner(cfg, store)
    build_s = time.time() - t0

    g = align_pipelined(aligner, reads, args.batch, tol=64)
    g["read_len_mean"] = int(lens.mean())
    g["read_len_max"] = int(lens.max())
    g["build_seconds"] = round(build_s, 1)
    cnt = g["counters"]
    g["capped_bucket_frac"] = round(
        cnt["num_capped_buckets"]
        / max(cnt["num_queried_buckets"]
              + cnt["num_capped_buckets"], 1), 4)
    res["guided"] = g
    print(json.dumps(res["guided"]), flush=True)

    # ---- overlap mode: all-vs-all of an ONT read set from the genome ----
    n_ov = args.overlap_reads
    lens2 = ont_lengths(rng, n_ov)
    sim2 = simulate_reads(store, n_ov, 0, seed=6,
                          error=(0.03, 0.03, 0.04), read_lens=lens2)
    rstore = GenomeStore()
    for n, s, _ in sim2:
        rstore.add_chromosome(n, s)
    rstore.finalize()
    ov_reads = [make_read(n, s) for n, s, _ in sim2]
    cfg2 = Config()
    cfg2.do_overlap = True
    t0 = time.time()
    ov = Aligner(cfg2, rstore)
    ov_build_s = time.time() - t0
    o = align_pipelined(ov, ov_reads, args.batch, check_locus=False)
    o["build_seconds"] = round(ov_build_s, 1)
    o["mhap_records"] = o.pop("aligned") // 6
    o.pop("correct_locus", None)
    cnt2 = o["counters"]
    o["capped_bucket_frac"] = round(
        cnt2["num_capped_buckets"]
        / max(cnt2["num_queried_buckets"]
              + cnt2["num_capped_buckets"], 1), 4)
    res["overlap"] = o
    print(json.dumps(res))
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    import faulthandler
    import signal
    faulthandler.register(signal.SIGUSR1)   # kill -USR1: dump stacks, live
    main()
