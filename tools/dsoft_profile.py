"""Profile INSIDE dsoft_device at big-genome scale.

Synthesizes a csr seed table OF THE TARGET SCALE directly on device (the
positions array never crosses to the device: jax.random fills it there), so
the probe isolates the seeding program itself — sub-stage timings for the
minimizer scan, bucket-range gathers, hit gather, and each of the three
lax.sorts in _hits_post — plus cold (compile) vs warm timings of the whole
fused program.

Run: python tools/dsoft_profile.py [--gbp 3.2] [--reads 128] [--hit-cap N]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import functools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from darwin_tpu.config import Config
from darwin_tpu.seeding import dsoft as D


def timed(fn, *args, reps=3, **kw):
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    cold = None
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    warm1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
        jax.block_until_ready(out)
    warm = (time.perf_counter() - t0) / reps
    return out, min(warm1, warm)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbp", type=float, default=3.2)
    ap.add_argument("--reads", type=int, default=128)
    ap.add_argument("--read-len", type=int, default=10000)
    ap.add_argument("--hit-cap", type=int, default=0,
                    help="0 = derive from n_flat_raw like the seeder")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    cfg = Config()
    k, w = cfg.seed_size, cfg.minimizer_window
    n_buckets = 1 << (2 * k)
    genome = int(args.gbp * 1e9)
    # emitted minimizer density ~2/(w+1)
    n_seeds = int(genome * 2 / (w + 1))
    max_occ = cfg.kmer_max_occurence(genome)
    print(f"synthetic table: {n_seeds/1e6:.0f} M seeds, "
          f"{n_buckets/1e6:.0f} M buckets, max_occ {max_occ}", flush=True)

    key = jax.random.PRNGKey(0)

    @jax.jit
    def synth_table(key):
        # bucket counts ~ multinomial(n_seeds, uniform) approximated by
        # rounding n_seeds/n_buckets with residual scatter; skew does not
        # matter for timing — widths are static
        base = n_seeds // n_buckets
        rem = n_seeds - base * n_buckets
        counts = jnp.full((n_buckets,), base, jnp.int32)
        idx = jax.random.randint(key, (rem,), 0, n_buckets)
        counts = counts.at[idx].add(1)
        offsets = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts)])
        return offsets

    offsets = synth_table(key)
    jax.block_until_ready(offsets)

    @jax.jit
    def synth_positions(key):
        # one fused program: no second 6.4 GB transient beside the output
        p = jax.random.bits(key, (n_seeds,), jnp.uint32)
        return jnp.minimum(p, jnp.uint32(genome - 1))

    positions = synth_positions(jax.random.PRNGKey(1))
    jax.block_until_ready(positions)
    print("table resident", flush=True)

    # reads: random codes are fine for scan timing
    B = 2 * args.reads
    lcap = 1 << (args.read_len - 1).bit_length()
    rng = np.random.default_rng(0)
    codes2 = rng.integers(0, 4, (B, lcap), dtype=np.uint8)
    lengths = np.full(B, args.read_len, np.int32)
    codes2 = jnp.asarray(codes2)
    lengths = jnp.asarray(lengths)
    jax.block_until_ready((codes2, lengths))

    pcap = lcap - k + 1
    mq_cap = D.mq_cap_for(pcap, cfg.num_seeds, cfg.max_stride, False)
    sv = D.sv_bins(cfg.bin_size, False)
    res = {}

    # ---- stage a: minimizer scan + stride schedule ----
    qm = jax.jit(functools.partial(
        D._queried_minimizers, k=k, w=w, num_seeds=cfg.num_seeds,
        max_stride=cfg.max_stride, overlap=False, mq_cap=mq_cap))
    (offs, qhash, slot_ok), res["scan_s"] = timed(qm, codes2, lengths)

    # ---- stage b: bucket ranges (csr: two gathers) ----
    br = jax.jit(lambda q, off: D._bucket_ranges(None, q,
                                                 bucket_offsets=off))
    (start, end), res["ranges_s"] = timed(br, qhash, offsets)

    @jax.jit
    def flat_stats(start, end, slot_ok):
        cnt = end - start
        eff = jnp.where(slot_ok & (cnt <= max_occ), cnt, 0)
        tot = jnp.sum(eff, axis=1)
        return jnp.max(tot), jnp.mean(tot.astype(jnp.float32))

    cnt = end - start
    need_d, mean_d = flat_stats(start, end, slot_ok)
    need = int(need_d)
    hit_cap = args.hit_cap or (1 << (need - 1).bit_length())
    res["n_flat_max"] = need
    res["n_flat_mean"] = round(float(mean_d), 1)
    res["hit_cap"] = hit_cap
    res["mq_cap"] = mq_cap
    print(f"flat hits: mean {res['n_flat_mean']:.0f} max {need} "
          f"-> hit_cap {hit_cap}", flush=True)

    # ---- stage c: ragged hit gather ----
    bh = jax.jit(functools.partial(
        D._bucket_hits_flat, max_occ=max_occ, bin_size=cfg.bin_size,
        hit_cap=hit_cap))
    (binf, offf, posf, okf, bucket_ok, total), res["gather_s"] = timed(
        bh, positions, offs, (start, end), cnt, slot_ok)

    # ---- stage d: the three sorts + counting, timed separately ----
    s1 = jax.jit(lambda a, b, c, d: jax.lax.sort(
        (a, b, c, d), num_keys=2, is_stable=True))
    (sbin, soff, spos, sok), res["sort1_hits_s"] = timed(
        s1, binf, offf, posf, okf)

    H = binf.shape[1]

    @jax.jit
    def counting(sbin, soff, sok):
        prev_bin = jnp.concatenate(
            [jnp.full((B, 1), 0xFFFFFFFF, jnp.uint32), sbin[:, :-1]], axis=1)
        prev_off = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), soff[:, :-1]], axis=1)
        valid = sok == 1
        first = valid & (sbin != prev_bin)
        delta = soff - prev_off
        inc = jnp.where(first, k, jnp.minimum(delta, k)) * valid
        c = jnp.cumsum(inc, axis=1)
        base = jax.lax.cummax(jnp.where(first, c - inc, 0), axis=1)
        s = c - base
        cross = valid & (s >= cfg.dsoft_threshold) & \
            ((s - inc) < cfg.dsoft_threshold)
        return cross

    cross, res["count_s"] = timed(counting, sbin, soff, sok)

    s2 = jax.jit(lambda key, a, b, c: jax.lax.sort(
        (key, a, b, c), num_keys=1, is_stable=True))
    aidx = jnp.arange(H, dtype=jnp.int32)[None, :].repeat(B, 0)
    akey = jnp.where(cross, aidx, D.I32MAX)
    _, res["sort2_anchors_s"] = timed(s2, akey, spos, soff, sbin)

    kkey = jnp.where(cross, 0, 1).astype(jnp.int32)  # shape stand-in
    _, res["sort3_prune_s"] = timed(s2, kkey, sbin, soff, spos)

    # ---- the real fused program, cold + warm ----
    kw = dict(k=k, w=w, num_seeds=cfg.num_seeds, max_stride=cfg.max_stride,
              overlap=False, threshold=cfg.dsoft_threshold,
              bin_size=cfg.bin_size, max_occ=max_occ, mq_cap=mq_cap,
              a_cap=8192, hit_cap=hit_cap)
    t0 = time.perf_counter()
    out = D.dsoft_device(codes2, lengths, None, positions,
                         bucket_offsets=offsets, **kw)
    jax.block_until_ready(out)
    res["full_cold_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = D.dsoft_device(codes2, lengths, None, positions,
                         bucket_offsets=offsets, **kw)
    jax.block_until_ready(out)
    res["full_warm_s"] = time.perf_counter() - t0
    res["n_hits_mean"] = round(float(jnp.mean(out["n_hits"])), 1)
    res["n_anchors_mean"] = round(float(jnp.mean(out["n_anchors"])), 1)

    res = {kk: (round(v, 4) if isinstance(v, float) else v)
           for kk, v in res.items()}
    res["B"] = B
    res["gbp"] = args.gbp
    print(json.dumps(res, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
