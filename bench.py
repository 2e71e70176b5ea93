"""Benchmark on one NVIDIA GPU: the CUDA tile kernels against the plain XLA
implementation, per kernel and end to end.

1. Kernel level: GCUPS (cells / second, timed to ``block_until_ready``) of
   each tile implementation at the shapes the pipeline dispatches — 512
   filter tiles 128x128 without trace, 512 extension tiles 384x384 with
   trace and records — in one process (chip_smoke.check_tiles).
2. End to end: warm guided-mapping reads/s of the same Aligner (one index,
   one read set) with the tile kernel switched between batches in the
   order plain, kernel, kernel, plain; a warm-up batch per kernel first.

Prints the device (platform, device_kind, count, card name and power
limit) and, as its last line, one JSON object.  Fails without a GPU.

Usage: python bench.py [--genome-gbp 3.1] [--reads 128] [--reps 2]
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def e2e(gbp: float, n_reads: int, reps: int):
    from chip_smoke import synth_genome
    from darwin_tpu.config import Config
    from darwin_tpu.genome import make_read
    from darwin_tpu.ops import dispatch
    from darwin_tpu.pipeline.align import Aligner
    from darwin_tpu.utils.simulate import simulate_reads

    t0 = time.time()
    store = synth_genome(11, int(gbp * 1e9), 4)
    aligner = Aligner(Config(), store)
    setup_s = time.time() - t0
    reads = [make_read(n, s) for n, s, _ in
             simulate_reads(store, n_reads, 10000, seed=12)]
    rows, lines = [], {}
    try:
        for kern in ("lax", "cuda"):          # warm-up: compile each
            dispatch.select_kernel(kern)
            aligner.align_batch(reads)
        for kern in ["lax", "cuda", "cuda", "lax"] * reps:
            dispatch.select_kernel(kern)
            t0 = time.perf_counter()
            out = aligner.align_batch(reads)
            dt = time.perf_counter() - t0
            lines.setdefault(kern, out)
            if out != lines[kern]:
                raise AssertionError(f"{kern}: output changed between runs")
            rows.append({"kernel": kern, "reads_per_s": n_reads / dt})
    finally:
        dispatch.select_kernel("")
    if lines["lax"] != lines["cuda"]:
        raise AssertionError("kernel and plain outputs differ")
    med = {k: float(np.median([r["reads_per_s"] for r in rows
                               if r["kernel"] == k])) for k in lines}
    return {"genome_gbp": gbp, "reads": n_reads, "setup_s": setup_s,
            "runs": rows, "median_reads_per_s": med}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-gbp", type=float, default=3.1)
    ap.add_argument("--reads", type=int, default=128)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (platform {dev.platform!r})", file=sys.stderr)
        return 2
    from chip_smoke import check_tiles
    from darwin_tpu.config import Config
    from darwin_tpu.ops import gact
    from darwin_tpu.pipeline.align import enable_compile_cache
    enable_compile_cache()
    ps = gact.static_params(gact.make_params(Config()))
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"card: {card()}", flush=True)
    kernels = [check_tiles("filter", 512, 128, 128, ps, time_it=True),
               check_tiles("extend", 512, 384, 384, ps, time_it=True)]
    for k in kernels:
        print(json.dumps(k), flush=True)
    end = e2e(args.genome_gbp, args.reads, args.reps)
    print(json.dumps(end), flush=True)
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card(), "kernels": kernels,
        "e2e_median_reads_per_s": end["median_reads_per_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
