"""Scaling-efficiency harness: reads/s through the full pipeline at
several mesh sizes.

On a multi-GPU host this measures true scaling.  With JAX_PLATFORMS=cpu the
mesh sizes run on a virtual CPU-device mesh — that validates the sharded
path end-to-end and records *functional* numbers, but virtual devices share
the same host cores, so efficiency there is not hardware-predictive (the
JSON marks this).

Usage: python tools/bench_scale.py [--sizes 1,2,8] [--out SCALE.json]
"""

# runnable standalone (no PYTHONPATH needed)
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,2,8")
    ap.add_argument("--out", default="SCALE.json")
    ap.add_argument("--reads", type=int, default=64)
    ap.add_argument("--read-len", type=int, default=5000)
    ap.add_argument("--genome", type=int, default=2_000_000)
    args = ap.parse_args()
    sizes = [int(s) for s in args.sizes.split(",")]

    import jax
    n_virtual = max(sizes)
    # with JAX_PLATFORMS=cpu: a virtual mesh (functional scaling); on a
    # multi-GPU host: the real cards
    jax.config.update("jax_num_cpu_devices", n_virtual)
    virtual = jax.devices()[0].platform == "cpu"
    if len(jax.devices()) < n_virtual:
        raise SystemExit(f"need {n_virtual} devices, have "
                         f"{len(jax.devices())}")

    from darwin_tpu.config import Config
    from darwin_tpu.genome import GenomeStore, make_read
    from darwin_tpu.parallel.shard import make_mesh
    from darwin_tpu.pipeline.align import Aligner, new_counters
    from darwin_tpu.utils.simulate import simulate_reads
    from darwin_tpu.pipeline.align import enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(0)
    store = GenomeStore()
    store.add_chromosome(
        "chr1", rng.choice(list(b"ACGT"), size=args.genome).astype(np.uint8))
    store.finalize()
    cfg = Config()
    sim = simulate_reads(store, args.reads, args.read_len, seed=1)
    reads = [make_read(n, s) for n, s, _ in sim]

    results = {}
    base_table = None
    outputs = {}
    for n in sizes:
        mesh = make_mesh(n) if n > 1 else None
        aligner = Aligner(cfg, store, table=base_table, mesh=mesh)
        base_table = aligner.table          # build the index once
        aligner.align_batch(reads[:8])      # warm/compile
        t0 = time.time()
        aligner.counters = new_counters()
        lines = aligner.align_batch(reads)
        dt = time.time() - t0
        outputs[n] = lines
        results[str(n)] = {"reads_per_s": round(len(reads) / dt, 2),
                           "seconds": round(dt, 3)}
        if n > 1:
            # production sharded-index seeder (hash-range shards + tiled
            # all_to_all hit routing, parallel/shard_index.py) at the same
            # mesh size: validates the >HBM-index path end-to-end
            sh = Aligner(cfg, store, table=base_table, mesh=mesh,
                         shard_index=True)
            sh.align_batch(reads[:8])
            t0 = time.time()
            sh.counters = new_counters()
            sh_lines = sh.align_batch(reads)
            results[str(n)]["sharded_index"] = {
                "reads_per_s": round(len(reads) / (time.time() - t0), 2),
                "identical": sh_lines == lines}
    base = results[str(sizes[0])]["reads_per_s"]
    for n in sizes:
        r = results[str(n)]
        r["speedup"] = round(r["reads_per_s"] / base, 3)
        r["efficiency"] = round(r["reads_per_s"] / base / max(n, 1), 3)
    identical = all(outputs[n] == outputs[sizes[0]] for n in sizes)
    payload = {"virtual_mesh": virtual, "sizes": results,
               "outputs_identical": identical,
               "note": ("virtual CPU devices share host cores; efficiency "
                        "numbers are functional only" if virtual else
                        "real-chip measurement")}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
