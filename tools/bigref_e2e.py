"""End-to-end >2 Gbp demonstration: synthetic 3.2 Gbp genome (4 x 800 Mbp
chromosomes), index build, and 512 x 10 kb reads aligned on the real chip
with correct-locus verification — the reference's full uint32 / 4 GiB DRAM
address space (software/DRAM.cpp:8-13), past the old 2 GiB int32 device cap.

The genome is served to the gathers 2-bit packed and D-SOFT positions ride
uint32 end-to-end.  --window sets the minimizer window (the index is
~8 B x 2/(w+1) per base).

The align loop is PIPELINED like the production run() (and the reference's
token flow graph, software/main.cpp:590-624): batch 0 runs alone so the
cold capture (compiles + one-time uploads) is cleanly attributed, then two
batches stay in flight so batch k+1's upload/seeding hides behind batch
k's extension/decode.  The artifact carries cold/warm stage tables and
compile_s so every second is attributed in-artifact.

Run: python tools/bigref_e2e.py [--gbp 3.2] [--reads 512]
"""

# runnable standalone (no PYTHONPATH needed)
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import json
import time

import numpy as np

def synth_bases(rng, n: int) -> np.ndarray:
    """Pseudo-random ACGT bytes (single pass — the bigref host is a slow
    shared vCPU, so every elementwise pass over 3.2e9 matters)."""
    return np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=n, dtype=np.uint8)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbp", type=float, default=3.2)
    ap.add_argument("--reads", type=int, default=512)
    ap.add_argument("--read-len", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--window", type=int, default=3)
    ap.add_argument("--out", default="bigref.json")
    ap.add_argument("--allow-small", action="store_true",
                    help="permit < 2 GiB genomes (same-hardware reference "
                         "point for per-base build rate / per-read stages)")
    ap.add_argument("--layout", choices=("pairs", "csr"), default="pairs",
                    help="seed-table layout: csr (bucket offsets + "
                         "positions, ~half the device memory of pairs)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="read batches in flight after the cold batch")
    ap.add_argument("--pair-gbp", type=float, default=0.0,
                    help="after the main capture, rebuild at this genome "
                         "size with the SAME config in the SAME process "
                         "and align the same read count — the apples-to-"
                         "apples per-read-cost-vs-genome-size pair "
                         "(seed_pos_table.cpp:304-335: per-read work is "
                         "bounded by num_seeds + the cap, independent of "
                         "genome size)")
    args = ap.parse_args()

    from darwin_tpu.config import Config
    from darwin_tpu.genome import GenomeStore, make_read
    from darwin_tpu.pipeline.align import Aligner, enable_compile_cache
    from darwin_tpu.utils.simulate import simulate_reads

    enable_compile_cache()
    n_chrom = 4
    clen = int(args.gbp * 1e9) // n_chrom
    t0 = time.time()
    rng = np.random.default_rng(0)
    store = GenomeStore()
    for c in range(n_chrom):
        store.add_chromosome(f"chr{c + 1}", synth_bases(rng, clen))
        print(f"  chr{c + 1} ({time.time() - t0:.0f}s)", flush=True)
    store.finalize()
    print(f"genome: {store.size / 1e9:.2f} Gbp coordinate space "
          f"({time.time() - t0:.0f}s)", flush=True)
    assert args.allow_small or store.size > (1 << 31), \
        "demo must exceed the int32 cap (--allow-small overrides)"

    cfg = Config()
    cfg.minimizer_window = args.window

    t0 = time.time()
    table = None
    if args.layout == "csr":
        from darwin_tpu.index.seed_table import build_seed_table
        table = build_seed_table(store, cfg, layout="csr")
    aligner = Aligner(cfg, store, table=table)
    build_seconds = time.time() - t0
    print(f"seed table: {aligner.table.num_seeds / 1e6:.0f} M seeds "
          f"({build_seconds:.0f}s)", flush=True)

    sim = simulate_reads(store, args.reads, args.read_len, seed=9)
    reads = [make_read(n, s) for n, s, _ in sim]

    res = {"genome_gbp": round(store.size / 1e9, 2),
           "layout": args.layout, "window": args.window,
           "seeds_m": round(aligner.table.num_seeds / 1e6, 1),
           "build_seconds": round(build_seconds, 1),
           "build_stages": _build_stages(store)}
    res.update(align_pipelined(aligner, reads, args.batch,
                               pipeline_depth=args.pipeline_depth))

    if args.pair_gbp > 0:
        # same code, same process, same config — only the genome scale
        # changes; compiled programs carry over, so the pair's per-read
        # numbers are steady-state by construction
        import gc
        del aligner, table, reads
        store = None
        gc.collect()
        print(f"pair run at {args.pair_gbp} Gbp ...", flush=True)
        rng2 = np.random.default_rng(1)
        store2 = GenomeStore()
        clen2 = int(args.pair_gbp * 1e9) // n_chrom
        for c in range(n_chrom):
            store2.add_chromosome(f"chr{c + 1}", synth_bases(rng2, clen2))
        store2.finalize()
        t0 = time.time()
        table2 = None
        if args.layout == "csr":
            table2 = build_seed_table(store2, cfg, layout="csr")
        aligner2 = Aligner(cfg, store2, table=table2)
        pair_build = time.time() - t0
        sim2 = simulate_reads(store2, args.reads, args.read_len, seed=10)
        reads2 = [make_read(n, s) for n, s, _ in sim2]
        pair = {"genome_gbp": round(store2.size / 1e9, 3),
                "seeds_m": round(aligner2.table.num_seeds / 1e6, 1),
                "build_seconds": round(pair_build, 1),
                "build_stages": _build_stages(store2)}
        pair.update(align_pipelined(aligner2, reads2, args.batch,
                                    pipeline_depth=args.pipeline_depth))
        res["pair_small"] = pair
        big, small = res, pair
        res["scale_pair"] = {
            "per_read_s_big": round(
                big["align_seconds"] / big["reads"], 3),
            "per_read_s_small": round(
                small["align_seconds"] / small["reads"], 3),
            "warm_per_read_s_big": round(1 / max(
                big["warm_reads_per_s"], 1e-9), 3),
            "warm_per_read_s_small": round(1 / max(
                small["warm_reads_per_s"], 1e-9), 3),
        }

    print(json.dumps(res))
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


def _build_stages(store):
    from darwin_tpu.index.minimizers import BUILD_STATS
    build_stages = dict(BUILD_STATS)
    build_stages.update(getattr(store, "_packed_stats", None) or {})
    return build_stages


def align_pipelined(aligner, reads, batch_size: int,
                    pipeline_depth: int = 2, tol: int = 32,
                    check_locus: bool = True,
                    collect_lines: list | None = None) -> dict:
    """Run the align phase with overlapped batches and return the stats
    block for the artifact.

    Batch 0 runs ALONE so the cold capture (XLA compiles, one-time genome
    decode) lands in stage_seconds_cold unmixed; the remaining batches
    keep ``pipeline_depth`` in flight (the reference's token-throttled
    overlap, software/main.cpp:590-624): batch k+1's read upload/seeding
    dispatches while batch k's results fetch and decode on the host.
    Counters are per-batch dicts merged in completion order (the same
    contract as pipeline.align.run)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from darwin_tpu.pipeline.align import compile_seconds, new_counters

    batches = [reads[b:b + batch_size]
               for b in range(0, len(reads), batch_size)]
    n_ok = n_aligned = 0
    merged = new_counters()

    def check(batch, lines):
        nonlocal n_ok, n_aligned
        if collect_lines is not None:
            collect_lines.extend(lines)
        if not check_locus:      # overlap-mode callers count lines only
            n_aligned += len(lines)
            return
        best = {}
        for ln in lines:
            f = ln.split("\t")
            best.setdefault(f[0], (f[2], int(f[3])))  # first = best-scoring
        for r in batch:
            if r.name not in best:
                continue
            n_aligned += 1
            chrom, pos = best[r.name]
            want_chrom, want_pos = r.name.split("_")[-3:-1]
            if chrom == want_chrom and abs(int(want_pos) - (pos - 1)) <= tol:
                n_ok += 1

    compile0 = compile_seconds()
    t0 = time.time()
    cnt0 = new_counters()
    check(batches[0], aligner.align_batch(batches[0], cnt0))
    for k, v in cnt0.items():
        merged[k] += v
    t_cold = time.time() - t0
    print(f"  batch 0 (cold): aligned {n_aligned}, correct {n_ok} "
          f"({t_cold:.0f}s)", flush=True)

    with ThreadPoolExecutor(max_workers=max(pipeline_depth, 1)) as pool:
        inflight = deque()

        def drain():
            nonlocal n_ok, n_aligned
            j, fut, cnt = inflight.popleft()
            check(batches[j], fut.result())
            for k, v in cnt.items():
                merged[k] += v
            print(f"  batch {j}: aligned {n_aligned}, correct {n_ok} "
                  f"({time.time() - t0:.0f}s)", flush=True)

        for j in range(1, len(batches)):
            cnt = new_counters()
            inflight.append(
                (j, pool.submit(aligner.align_batch, batches[j], cnt), cnt))
            if len(inflight) >= max(pipeline_depth, 1):
                drain()
        while inflight:
            drain()
    dt = time.time() - t0

    total = dict(aligner.stage_seconds)
    cold = dict(aligner.stage_seconds_cold)
    warm = {k: v - cold.get(k, 0.0) for k, v in total.items()}
    warm_reads = len(reads) - len(batches[0])
    out = {
        "reads": len(reads), "aligned": n_aligned, "correct_locus": n_ok,
        "align_seconds": round(dt, 1),
        "reads_per_s": round(len(reads) / dt, 2),
        "pipeline_depth": pipeline_depth,
        "cold_batch_seconds": round(t_cold, 1),
        "warm_reads_per_s": round(warm_reads / max(dt - t_cold, 1e-9), 2),
        "compile_s": round(compile_seconds() - compile0, 1),
        "seed_s_per_read_warm": round(
            warm.get("seed", 0.0) / max(warm_reads, 1), 4),
        "stage_seconds": {k: round(v, 2) for k, v in sorted(
            total.items(), key=lambda kv: -kv[1])},
        "stage_seconds_cold": {k: round(v, 2) for k, v in sorted(
            cold.items(), key=lambda kv: -kv[1])},
        "stage_seconds_warm": {k: round(v, 2) for k, v in sorted(
            warm.items(), key=lambda kv: -kv[1])},
        "counters": {k: int(v) for k, v in merged.items()},
    }
    return out


def _dump_live_arrays(limit: int = 25):
    """On OOM: every live device buffer >= 1 MB, largest first — names the
    resident set that actually exhausted device memory (shapes identify
    owners)."""
    import jax
    arrs = sorted(jax.live_arrays(), key=lambda a: -a.nbytes)
    total = sum(a.nbytes for a in arrs)
    print(f"live device arrays: {len(arrs)}, {total / 1e9:.2f} GB total",
          file=_sys.stderr, flush=True)
    for a in arrs[:limit]:
        if a.nbytes < (1 << 20):
            break
        print(f"  {a.nbytes / 1e9:7.3f} GB  {a.dtype}{list(a.shape)}",
              file=_sys.stderr, flush=True)


if __name__ == "__main__":
    import faulthandler
    import signal
    faulthandler.register(signal.SIGUSR1)   # kill -USR1: dump stacks, live
    try:
        main()
    except Exception:
        try:
            _dump_live_arrays()
        except Exception:
            pass
        raise
