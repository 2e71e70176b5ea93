#!/usr/bin/env python3
"""Start-up proof of the aligner on one NVIDIA GPU.

Drives the main path through the entry point a user calls
(``darwin_tpu.pipeline.align.run``, the CLI's backend) and checks what comes
out.  Phases (any failure exits non-zero; nothing is caught and passed):

  (a) device   fail unless JAX runs on a GPU; print the card, the compile
               cache directory and whether the native libraries built
  (b) kernels  the tile kernels at the pipeline's widths against the plain
               XLA implementation, bit-exact (all outputs are integers):
               512 filter tiles 128x128, 512 extension tiles 384x384 with
               records at 16/8/4 bits (overflow reruns included), 16 large
               tiles 1984x960, and a generic (open > extend) scoring; plus
               each shape's GCUPS for the kernel and the plain version
  (c) guided   a seeded uniform-random human-scale genome (--genome-gbp,
               default 3.1) and 256 simulated 10 kb reads at 10% error
               through run(): every read aligned, >= 98% at the simulated
               locus
  (d) overlap  1,024 reads of 10 kb at 8x coverage of a seeded 1.28 Mbp
               genome through run(do_overlap=True): MHAP records > 0
  (e) golden   a seeded small workload in both modes: SAM and MHAP sha256
               equal the values the CPU test suite locks
               (tests/test_golden_synthetic.py)

``--four-cards`` runs only the mesh phase on four GPUs: the human-scale
genome with 128 reads through run(mesh=4) and run(mesh=4,
shard_index=True), each byte-compared with run(mesh="off").

Usage:  python chip_smoke.py [--genome-gbp 3.1] [--four-cards]
The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Files are written under .smoke/ in the checkout (gitignored) and removed.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")

# sha256 of the phase (e) outputs; tests/test_golden_synthetic.py locks the
# same values on the CPU
GOLDEN_SAM_SHA256 = (
    "5c74834f9a995b170cc1312916b8389b78c4eb4a726eb3153909cc6324a5142e")
GOLDEN_MHAP_SHA256 = (
    "6a246a60334ba1a5d5c5280a2ee0d2b2c6cd34ccdafd747663f3fd97ad935c4a")


def log(*a):
    print(*a, flush=True)


def _imports():
    sys.path.insert(0, REPO)
    import darwin_tpu  # noqa: F401  (fails outside a checkout)


# ---------------------------------------------------------------------------
# (b) tile kernels against the plain implementation
# ---------------------------------------------------------------------------

def random_tiles(rng, B, qt, rt, full=False):
    """(B, qt)/(B, rt) code tiles, every other one a noisy copy, with
    ragged lengths unless ``full``."""
    from darwin_tpu.utils.simulate import mutate_read
    acgt = np.frombuffer(b"ACGT", np.uint8)
    q = np.zeros((B, qt), np.uint8)
    r = np.zeros((B, rt), np.uint8)
    ql = np.full(B, qt, np.int32)
    rl = np.full(B, rt, np.int32)
    from darwin_tpu.genome import encode5
    for b in range(B):
        if not full:
            ql[b] = rng.integers(max(1, qt // 2), qt + 1)
            rl[b] = rng.integers(max(1, rt // 2), rt + 1)
        ref = acgt[rng.integers(0, 4, rt)]
        qry = (mutate_read(rng, ref) if b % 2 == 0
               else acgt[rng.integers(0, 4, qt)])
        qry = np.concatenate([qry, acgt[rng.integers(0, 4, qt)]])[:qt]
        r[b] = encode5(ref)
        q[b] = encode5(qry)
        r[b, rl[b]:] = 4
        q[b, ql[b]:] = 4
    return q, r, ql, rl


def _tile_fn(impl, kind, ps, max_tb):
    import jax
    if kind == "filter":
        return jax.jit(lambda q, r, ql, rl: impl.filter_scores(q, r, ql, rl,
                                                               ps))
    return jax.jit(lambda q, r, ql, rl: impl.extend_records(q, r, ql, rl, ps,
                                                            max_tb))


def check_tiles(kind, B, qt, rt, ps, rng=None, time_it=False):
    """Run ``kind`` ('filter' / 'extend') tiles through the implementation
    the dispatcher picks for this shape and scoring, and compare every
    output with the plain implementation: on the same device when the
    pick is the CUDA kernel, on the CPU backend otherwise (XLA:GPU vs
    XLA:CPU).  Raises on any difference.  With ``time_it``, also times
    both on full-length tiles and returns their GCUPS."""
    import jax
    from darwin_tpu.ops import dispatch, gact
    rng = rng or np.random.default_rng(B + qt + rt)
    max_tb = 2 * max(qt, rt)
    impl = dispatch.tile_impl(ps, qt, rt)
    dev = jax.devices()[0]
    ref_dev = dev if impl is not gact else jax.devices("cpu")[0]
    args = random_tiles(rng, B, qt, rt)
    got = _tile_fn(impl, kind, ps, max_tb)(
        *[jax.device_put(a, dev) for a in args])
    with jax.default_device(ref_dev):
        want = _tile_fn(gact, kind, ps, max_tb)(
            *[jax.device_put(a, ref_dev) for a in args])
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape or not np.array_equal(g, w):
            bad = np.argwhere(g != w)[:5] if g.shape == w.shape else "shape"
            raise AssertionError(f"{kind} {B}x{qt}x{rt}: output {i} differs "
                                 f"from the plain implementation at {bad}")
    out = {"kind": kind, "shape": f"{B}x{qt}x{rt}",
           "impl": impl.__name__.rsplit(".", 1)[-1], "bit_exact": True}
    if time_it:
        full = [jax.device_put(a, dev)
                for a in random_tiles(rng, B, qt, rt, full=True)]
        for name, m in (("kernel", impl), ("plain", gact)):
            fn = _tile_fn(m, kind, ps, max_tb)
            jax.block_until_ready(fn(*full))
            n, t0 = 0, time.perf_counter()
            while n < 3 or time.perf_counter() - t0 < 1.0:
                jax.block_until_ready(fn(*full))
                n += 1
            dt = (time.perf_counter() - t0) / n
            out[f"{name}_ms"] = dt * 1e3
            out[f"{name}_gcups"] = B * qt * rt / dt / 1e9
    return out


def check_round_bits(ps_params, B=512, T=384):
    """The fused extension round (with its speculative chain) at records
    of 16, 8 and 4 bits on the kernel the platform picks, against the plain
    implementation at 16 bits: every resolved output equal, and lanes
    whose insert runs overflow the compact records rerun (losslessly)
    wide."""
    import jax.numpy as jnp
    from darwin_tpu.ops import dispatch
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    from darwin_tpu.genome import encode5
    n = B * 2 * T
    ref = acgt[rng.integers(0, 4, n)]
    qry_parts, q_start, q_size = [], [], []
    pos = 0
    for b in range(B):
        frag = ref[b * 2 * T:b * 2 * T + T]
        if b % 8 == 0:       # an 80-base insert: overflows 8- and 4-bit
            frag = np.concatenate([frag[:150], acgt[rng.integers(0, 4, 80)],
                                   frag[150:]])
        from darwin_tpu.utils.simulate import mutate_read
        frag = mutate_read(rng, frag)[:T]
        qry_parts.append(frag)
        q_start.append(pos)
        q_size.append(len(frag))
        pos += len(frag)
    refc = jnp.asarray(encode5(ref))
    qc = jnp.asarray(encode5(np.concatenate(qry_parts)))
    r_start = np.arange(B, dtype=np.int64) * 2 * T
    r_size = np.full(B, T, np.int32)
    q_start = np.asarray(q_start, np.int64)
    q_size = np.asarray(q_size, np.int32)
    rev = np.zeros(B, bool)
    chain = (np.zeros(B, np.int64), np.full(B, n, np.int64),
             np.zeros(B, np.int64), np.full(B, pos, np.int64),
             T - 64)
    runs = [("lax", 16)] + [(dispatch.kernel_name(), b) for b in (16, 8, 4)]
    results, reruns = {}, {}
    prior = os.environ.get("DARWIN_TPU_RECBITS")
    try:
        for kern, bits in runs:
            dispatch.select_kernel(kern)
            os.environ["DARWIN_TPU_RECBITS"] = str(bits)
            before = dispatch.RECOVERY["rerun_lanes"]
            results[(kern, bits)] = dispatch.extend_tiles_async(
                refc, qc, r_start, r_size, q_start, q_size, rev, ps_params,
                qt=T, rt=T, max_tb=2 * T, chain=chain)()
            reruns[(kern, bits)] = dispatch.RECOVERY["rerun_lanes"] - before
    finally:
        dispatch.select_kernel("")
        if prior is None:
            os.environ.pop("DARWIN_TPU_RECBITS", None)
        else:
            os.environ["DARWIN_TPU_RECBITS"] = prior
    base = results[("lax", 16)]
    for key, res in results.items():
        for k, v in res.items():
            w = base[k]
            if isinstance(v, list):
                ok = all(np.array_equal(np.asarray(a), np.asarray(b))
                         for x, y in zip(v, w)
                         for a, b in (zip(x, y) if isinstance(x, tuple)
                                      else [(x, y)]))
            else:
                ok = np.array_equal(np.asarray(v), np.asarray(w))
            if not ok:
                raise AssertionError(f"extension round {key}: {k} differs")
        if key[1] != 16 and reruns[key] == 0:
            raise AssertionError(f"extension round {key}: no overflow rerun")
    if not int(np.asarray(base["n_ops"]).min()) > 0:
        raise AssertionError("extension round produced an empty traceback")
    return {"round": f"{B} lanes x {dispatch.SPEC_K} chained tiles",
            "overflow_rerun_lanes": {f"{k}/{b}": v
                                     for (k, b), v in reruns.items()},
            "bit_exact": True}


def phase_kernels(cut):
    import jax
    from darwin_tpu.config import Config
    from darwin_tpu.ops import gact
    params = gact.make_params(Config())
    ps = gact.static_params(params)
    gen_cfg = Config()
    gen_cfg.gap_open, gen_cfg.gap_extend = -1, -5
    gen_cfg.long_gap_open, gen_cfg.long_gap_extend = -3, -9
    gps = gact.static_params(gact.make_params(gen_cfg))
    B = 512 // cut
    rows = [check_tiles("filter", B, 128, 128, ps, time_it=True),
            check_tiles("extend", B, 384, 384, ps, time_it=True),
            check_tiles("extend", max(16 // cut, 2), 1984 // cut, 960 // cut,
                        ps, time_it=True),
            check_tiles("extend", 128 // cut, 384, 384, gps)]
    for r in rows:
        log(f"  {json.dumps(r)}")
    log(f"  {json.dumps(check_round_bits(params, B=B))}")
    jax.clear_caches()
    return rows


# ---------------------------------------------------------------------------
# (c)-(e) the pipeline through run()
# ---------------------------------------------------------------------------

def synth_genome(seed, total_bp, n_chrom):
    """Seeded uniform-random genome as tools/bigref_e2e.py makes it."""
    from darwin_tpu.genome import GenomeStore
    rng = np.random.default_rng(seed)
    store = GenomeStore()
    clen = total_bp // n_chrom
    for c in range(n_chrom):
        store.add_chromosome(f"chr{c + 1}", np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, size=clen, dtype=np.uint8)])
    return store.finalize()


def write_genome(path, store):
    with open(path, "wb") as f:
        for c in store.chromosomes:
            f.write(f">{c.name}\n".encode())
            f.write(store.bases[c.start:c.start + c.length_unpadded].data)
            f.write(b"\n")


def run_pipeline(ref_fa, reads_fa, overlap, **kw):
    """run() with its output captured; returns (output text, stats)."""
    from darwin_tpu.config import Config
    from darwin_tpu.pipeline.align import run
    out, err, stats = io.StringIO(), io.StringIO(), {}
    t0 = time.time()
    run(ref_fa, reads_fa, overlap, cfg=Config(), out=out, err=err,
        stats_out=stats, **kw)
    stats["wall_s"] = round(time.time() - t0, 2)
    for line in err.getvalue().splitlines():
        if line.startswith("[darwin_tpu]") or line.startswith("#"):
            log(f"    {line}")
    return out.getvalue(), stats


def report(name, stats, n_reads, batch):
    import jax
    ends = stats["batch_end_s"]
    warm_n = n_reads - batch
    warm_s = ends[-1] - ends[0] if len(ends) > 1 else float("nan")
    c = stats["counters"]
    h, m = c["num_spec_hits"], c["num_spec_misses"]
    mem = jax.devices()[0].memory_stats() or {}
    row = {
        "phase": name, "load_s": stats["load_seconds"],
        "index_s": stats["index_seconds"],
        "align_s": stats["align_seconds"], "wall_s": stats["wall_s"],
        "compile_s": stats["compile_s"],
        "cold_batch_s": ends[0],
        "warm_reads_per_s": warm_n / warm_s if len(ends) > 1 else None,
        "rounds": c["num_extend_rounds"],
        "spec_hit_rate": h / (h + m) if h + m else None,
        "large_tiles": c["num_large_tiles"],
        "filter_tiles": c["num_filter_tiles"],
        "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
        "stage_seconds_cold": stats["stage_seconds_cold"],
        "stage_seconds_warm": stats["stage_seconds_warm"],
    }
    log(f"  {json.dumps(row)}")
    return row


def check_sam(text, names):
    """Every read aligned; share whose best (first) line hits the
    simulated chromosome within 32 bp of the simulated start."""
    best = {}
    for ln in text.splitlines():
        if ln.startswith("@"):
            continue
        f = ln.split("\t")
        best.setdefault(f[0], (f[2], int(f[3])))
    missing = [n for n in names if n not in best]
    if missing:
        raise AssertionError(f"{len(missing)} reads not aligned, "
                             f"e.g. {missing[:3]}")
    ok = 0
    for n in names:
        chrom, start = n.split("_")[1:3]
        got_chrom, pos = best[n]
        ok += got_chrom == chrom and abs(int(start) - (pos - 1)) <= 32
    return ok / len(names)


def phase_guided(gbp, n_reads=256, batch=128, seed=11):
    from darwin_tpu.utils.simulate import simulate_reads, write_fasta
    t0 = time.time()
    store = synth_genome(seed, int(gbp * 1e9), 4)
    reads = simulate_reads(store, n_reads, 10000, seed=seed + 1)
    ref_fa = os.path.join(WORK, "genome.fa")
    reads_fa = os.path.join(WORK, "reads.fa")
    write_genome(ref_fa, store)
    write_fasta(reads_fa, reads)
    del store
    log(f"  genome {gbp} Gbp + {n_reads} reads written "
        f"({time.time() - t0:.1f} s)")
    return ref_fa, reads_fa, [r[0] for r in reads]


def phase_c(gbp, cut):
    batch = 128 // cut
    ref_fa, reads_fa, names = phase_guided(gbp, 256 // cut)
    text, stats = run_pipeline(ref_fa, reads_fa, False, pipeline_depth=1,
                               reads_per_batch=batch)
    frac = check_sam(text, names)
    row = report("guided", stats, len(names), batch)
    row["correct_locus"] = frac
    log(f"  guided: correct locus {frac:.4f}")
    if frac < 0.98:
        raise AssertionError(f"only {frac:.4f} of reads at the simulated "
                             "locus (need >= 0.98)")
    return row


def phase_d(cut):
    from darwin_tpu.utils.simulate import simulate_reads, write_fasta
    batch, n_reads = 128 // cut, 1024 // cut
    store = synth_genome(21, 1_280_000 // cut, 1)
    reads = simulate_reads(store, n_reads, 10000, seed=22)
    reads_fa = os.path.join(WORK, "overlap.fa")
    write_fasta(reads_fa, reads)
    text, stats = run_pipeline(reads_fa, reads_fa, True, pipeline_depth=1,
                               reads_per_batch=batch)
    n = sum(1 for ln in text.splitlines() if ln.strip())
    row = report("overlap", stats, n_reads, batch)
    row["mhap_records"] = n
    log(f"  overlap: {n} MHAP records")
    if n == 0:
        raise AssertionError("overlap mode produced no MHAP records")
    return row


def golden_workload(workdir):
    """Phase (e)'s seeded small workload: a 2 Mbp genome with 16 reads of
    3 kb (guided), and 16 reads of 3 kb from a 20 kb genome (overlap).
    Returns (ref_fa, reads_fa, overlap_fa)."""
    from darwin_tpu.utils.simulate import simulate_reads, write_fasta
    store = synth_genome(31, 2_000_000, 2)
    ref_fa = os.path.join(workdir, "golden_ref.fa")
    write_genome(ref_fa, store)
    reads_fa = os.path.join(workdir, "golden_reads.fa")
    write_fasta(reads_fa, simulate_reads(store, 16, 3000, seed=32))
    small = synth_genome(33, 20_000, 1)
    ov_fa = os.path.join(workdir, "golden_overlap.fa")
    write_fasta(ov_fa, simulate_reads(small, 16, 3000, seed=33))
    return ref_fa, reads_fa, ov_fa


def golden_hashes(workdir):
    """(SAM sha256, MHAP sha256) of the golden workload through run()."""
    ref_fa, reads_fa, ov_fa = golden_workload(workdir)
    sam, st1 = run_pipeline(ref_fa, reads_fa, False)
    mhap, st2 = run_pipeline(ov_fa, ov_fa, True)
    log(f"  golden: compile {st1['compile_s']} + {st2['compile_s']} s, "
        f"wall {st1['wall_s']} + {st2['wall_s']} s")
    if not sam.count("\n") > 16 or not mhap.strip():
        raise AssertionError("golden workload produced too little output")
    return (hashlib.sha256(sam.encode()).hexdigest(),
            hashlib.sha256(mhap.encode()).hexdigest())


def phase_e():
    sam, mhap = golden_hashes(WORK)
    log(f"  golden sha256: sam {sam}  mhap {mhap}")
    if (sam, mhap) != (GOLDEN_SAM_SHA256, GOLDEN_MHAP_SHA256):
        raise AssertionError("GPU output differs from the CPU-locked "
                             f"hashes ({GOLDEN_SAM_SHA256}, "
                             f"{GOLDEN_MHAP_SHA256})")
    return {"sam_sha256": sam, "mhap_sha256": mhap}


def phase_four_cards(gbp, cut):
    import jax
    if len(jax.devices()) < 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, have "
                             f"{len(jax.devices())}")
    ref_fa, reads_fa, names = phase_guided(gbp, 128 // cut)
    base, st = run_pipeline(ref_fa, reads_fa, False, mesh="off")
    log(f"  mesh=off: wall {st['wall_s']} s, correct locus "
        f"{check_sam(base, names):.4f}")
    for kw in ({"mesh": 4}, {"mesh": 4, "shard_index": True}):
        text, st = run_pipeline(ref_fa, reads_fa, False, **kw)
        same = text == base
        log(f"  {kw}: wall {st['wall_s']} s, byte-identical to mesh=off: "
            f"{same}")
        if not same:
            raise AssertionError(f"run({kw}) output differs from "
                                 "run(mesh='off')")
    for d in jax.devices()[:4]:
        log(f"  peak_bytes_in_use {d}: "
            f"{(d.memory_stats() or {}).get('peak_bytes_in_use')}")


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-gbp", type=float, default=3.1)
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU at toy sizes; prints "
                         "no result line")
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu_rehearsal:
        print(f"chip_smoke: JAX finds no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    _imports()
    from darwin_tpu import native
    from darwin_tpu.pipeline.align import enable_compile_cache
    enable_compile_cache()
    os.makedirs(WORK, exist_ok=True)
    t_start = time.time()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip() or smi.stderr.strip()
    except FileNotFoundError:
        card = "nvidia-smi not found"
    log(f"(a) device: {dev.device_kind} x{len(jax.devices())} "
        f"({dev.platform}); card: {card}; compile cache "
        f"{jax.config.jax_compilation_cache_dir}; native host library "
        f"built: {native.available()}")
    from darwin_tpu.ops import dispatch
    log(f"    tile kernel: {dispatch.kernel_name()}")
    if dispatch.kernel_name() == "cuda":
        from darwin_tpu.ops import gact_cuda
        t0 = time.time()
        log(f"    CUDA tile kernels: {gact_cuda.build()} "
            f"({time.time() - t0:.1f} s)")
    cut = 8 if args.cpu_rehearsal else 1
    gbp = 0.002 if args.cpu_rehearsal else args.genome_gbp
    try:
        if args.four_cards:
            log("(f) four cards")
            phase_four_cards(gbp, cut)
        else:
            for name, fn in (("(b) kernels", lambda: phase_kernels(cut)),
                             ("(c) guided", lambda: phase_c(gbp, cut)),
                             ("(d) overlap", lambda: phase_d(cut)),
                             ("(e) golden", phase_e)):
                t0 = time.time()
                log(f"{name}")
                fn()
                log(f"  {name} done in {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"total {time.time() - t_start:.1f} s")
    log(f"card: {card}")
    if args.cpu_rehearsal:
        log("rehearsal passed")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
