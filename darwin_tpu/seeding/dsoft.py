"""D-SOFT seeding on device.

Implements SeedPosTable::DSOFT (software/seed_pos_table.cpp:252-553) as a
single batched, statically-shaped XLA program per read batch:

1. minimizer scan over the query (:261-265),
2. stride schedule over the minimizer ordinal (:304-335): minimizers with
   ordinal <= N+1 are queried; in reference-guided mode every max_stride-th
   after that; in overlap mode none after,
3. bucket lookup with the occupancy skip (:311-314), hits kept when
   hit >= query offset (:318), bin = (hit - offset) / bin_size (:319),
4. stable sort of hits by (bin, offset) (:337, CompareHits compares the
   packed (bin<<32)|offset key, stable within),
5. per-bin unique-base counting with one anchor per bin at the threshold
   crossing (:356-389): the count starts at kmer_size for a new bin and adds
   min(offset_delta, kmer_size) per subsequent hit while below threshold.

Chaining (:394-498) runs on the host over the sorted hits (seeding/chain.py).

``max_candidates`` is deliberately NOT enforced: the reference's check reads
a counter that is never incremented (:369,382 with num_candidates fixed at
0), so it never fires.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from darwin_tpu.index.minimizers import minimizer_scan

I32MAX = np.int32(2**31 - 1)


def mq_cap_for(pcap: int, num_seeds: int, max_stride: int,
               overlap: bool) -> int:
    """Static bound on the number of queried minimizers."""
    base = num_seeds + 2
    if overlap:
        return min(pcap, base)
    return min(pcap, base + (max(pcap - base, 0) + max_stride - 1) // max_stride)


def _queried_minimizers(codes2, lengths, k, w, num_seeds, max_stride,
                        overlap, mq_cap):
    """Minimizer scan + the stride schedule + compaction: returns
    (offs, qhash, slot_ok) of shape (B, mq_cap)."""
    B, _ = codes2.shape
    m, emit = minimizer_scan(codes2, lengths, k, w)
    P = m.shape[1]

    ordinal = jnp.cumsum(emit.astype(jnp.int32), axis=1) - 1
    nq = jnp.int32(num_seeds)
    q_rule = ordinal <= nq + 1
    if not overlap:
        q_rule = q_rule | (((ordinal - (nq + 1)) % max_stride) == 0)
    queried = emit & q_rule

    # compact queried minimizers (position order == ordinal order) with a
    # scatter to each minimizer's own output slot — targets are unique per
    # row, so this replaces a P-wide stable sort with one linear pass
    p_idx = jnp.arange(P, dtype=jnp.int32)[None, :]
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    # ordinal counts ALL emissions; queried ones are a prefix-plus-stride
    # subset, so renumber queried minimizers densely first (mq_cap bounds
    # the queried count by construction; the guard is belt-and-braces)
    qord = jnp.cumsum(queried.astype(jnp.int32), axis=1) - 1
    tgt = jnp.where(queried & (qord < mq_cap), qord, mq_cap)
    offs = jnp.full((B, mq_cap + 1), I32MAX, jnp.int32)
    offs = offs.at[rows, tgt].min(jnp.broadcast_to(p_idx, (B, P)))
    qhash = jnp.zeros((B, mq_cap + 1), jnp.uint32)
    qhash = qhash.at[rows, tgt].max(m)
    offs = offs[:, :mq_cap]
    qhash = qhash[:, :mq_cap]
    slot_ok = offs < I32MAX
    return offs, qhash, slot_ok


def _ranged_search(h, q, lo, hi, steps: int, side: str):
    """Vectorized bisect of q into h restricted to [lo, hi) — the prefix
    LUT bounds the range, so `steps` iterations (static, from the largest
    prefix bucket) replace log2(N) full-table searchsorted steps."""
    cur = lo
    length = hi - lo
    n = h.shape[0]
    for _ in range(steps):
        half = length >> 1
        mid = jnp.clip(cur + half, 0, max(n - 1, 0))
        hv = jnp.take(h, mid)
        go = (hv < q) if side == "left" else (hv <= q)
        go = go & (length > 0)
        cur = jnp.where(go, cur + half + 1, cur)
        length = jnp.where(go, length - half - 1, half)
    return cur


def _bucket_ranges(sorted_hashes, qhash, lut=None, lut_shift=0,
                   lut_steps=0, bucket_offsets=None):
    """(start, end) table ranges per queried hash.  Three resolutions:
    csr bucket-offset table (two direct gathers — no search at all),
    prefix-LUT-accelerated bisect (SeedTable.ensure_lut), or plain
    searchsorted (hash-range shards)."""
    if bucket_offsets is not None:
        # hashes are masked to 2k <= 28 bits, so qhash and qhash+1 index
        # the (4^k + 1)-entry offset array safely as int32
        q = qhash.astype(jnp.int32)
        start = jnp.take(bucket_offsets, q)
        end = jnp.take(bucket_offsets, q + 1)
        return start, end
    if lut is None:
        start = jnp.searchsorted(sorted_hashes, qhash,
                                 side="left").astype(jnp.int32)
        end = jnp.searchsorted(sorted_hashes, qhash,
                               side="right").astype(jnp.int32)
        return start, end
    h32 = sorted_hashes.astype(jnp.int32)
    q32 = qhash.astype(jnp.int32)
    pre = (q32 >> lut_shift).astype(jnp.int32)
    pre = jnp.clip(pre, 0, lut.shape[0] - 2)
    lo = jnp.take(lut, pre)
    hi = jnp.take(lut, pre + 1)
    start = _ranged_search(h32, q32, lo, hi, lut_steps, "left")
    end = _ranged_search(h32, q32, lo, hi, lut_steps, "right")
    return start, end


def _bucket_hits_flat(positions, offs, bucket_range, cnt_global,
                      slot_ok, max_occ, bin_size, hit_cap):
    """Ragged-flat variant of _bucket_hits: hits land in a compact
    (B, hit_cap) buffer instead of (B, mq_cap*max_occ) padded slots.

    Same hit multiset in the same insertion order — slot j of a row is the
    j-th (bucket, in-bucket) pair over usable buckets in minimizer order,
    exactly the padded layout with the empty slots squeezed out — so the
    downstream stable sort produces an identical valid prefix.  The flat
    buffer is typically ~100x smaller than the worst-case padded one (most
    buckets hold a couple of positions, not kmer_max_occurence), which is
    where the gather and sort time went.

    The j -> bucket mapping is computed without a per-slot binary search:
    scatter each non-empty bucket's ordinal at its exclusive-prefix start
    slot, then a running max over slots.  Returns the extra ``total``
    (B,) int32 — real slots needed; rows with total > hit_cap LOST hits and
    the caller must retry with a bigger cap (the seeder does).
    """
    B, mq = offs.shape
    start, end = bucket_range
    cnt = end - start
    bucket_ok = slot_ok & (cnt_global <= max_occ)

    cnt_eff = jnp.where(bucket_ok, cnt, 0)
    cum = jnp.cumsum(cnt_eff, axis=1)
    sflat = cum - cnt_eff                       # start slot of each bucket
    total = cum[:, -1]

    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    bord = jnp.broadcast_to(jnp.arange(mq, dtype=jnp.int32)[None, :],
                            (B, mq))
    mark_col = jnp.where((cnt_eff > 0) & (sflat < hit_cap), sflat, hit_cap)
    ticks = jnp.zeros((B, hit_cap + 1), jnp.int32)
    ticks = ticks.at[rows, mark_col].max(bord + 1)
    bidx = jax.lax.cummax(ticks[:, :hit_cap], axis=1) - 1

    j = jnp.arange(hit_cap, dtype=jnp.int32)[None, :]
    bsafe = jnp.clip(bidx, 0, mq - 1)
    sf = jnp.take_along_axis(sflat, bsafe, 1)
    st = jnp.take_along_axis(start, bsafe, 1)
    of = jnp.take_along_axis(offs, bsafe, 1)
    ok_slot = (bidx >= 0) & (j < total[:, None])

    n = positions.shape[0]
    gidx = jnp.clip(st + (j - sf), 0, max(n - 1, 0))
    # positions span the full uint32 address space (>2 Gbp genomes,
    # reference DRAM width); bins fit int32 after the division
    pos = jnp.take(positions, gidx)                      # uint32
    of_u = of.astype(jnp.uint32)
    hit_ok = ok_slot & (pos >= of_u)
    # bins stay uint32: (pos - off) // bin_size reaches 2^32-2 for
    # bin_size=1 on a full-address-width genome (the reference keeps the
    # bin in the upper half of a uint64 key).  The all-ones sentinel is
    # unreachable by valid bins (pos <= ref_size-1 < 2^32-1).
    binf = jnp.where(hit_ok, (pos - of_u) // jnp.uint32(bin_size),
                     jnp.uint32(0xFFFFFFFF))
    okf = hit_ok.astype(jnp.int32)
    return binf, of, pos, okf, bucket_ok, total


def sv_bins(bin_size: int, overlap: bool) -> int:
    """Chaining's bin half-window (software/seed_pos_table.cpp:394,409):
    sv_num_bins = 4096/bin_size reference-guided, 1 in overlap mode.
    Must match chain.chain_anchors."""
    return 1 if overlap else (1 << 12) // bin_size


def _hits_post(binf, offf, posf, n_queried_buckets, k, threshold,
               a_cap, sv):
    """Sort hits, run the per-bin unique-base count, compact anchors, and
    prune hits to the union of anchor bin windows.  Pure function of the
    (unordered-by-bin) hit buffers — shared by the replicated and
    hash-sharded paths.  Hit validity is the bin sentinel (invalid slots
    carry bin == 0xFFFFFFFF, _bucket_hits_flat)."""
    B, H = binf.shape
    # stable sort by (bin, offset); equal pairs keep insertion order
    # (minimizer ordinal, bucket slot) like std::stable_sort on the packed
    # key (software/seed_pos_table.cpp:337,42-45).  Validity rides the bin
    # sentinel (0xFFFFFFFF is unreachable by valid bins), so the sort moves
    # three operands, not four.
    sbin, soff, spos = jax.lax.sort(
        (binf, offf, posf), num_keys=2, is_stable=True)

    # ---- per-bin counting (software/seed_pos_table.cpp:352-389) ----
    # "no previous bin" sentinel: all-ones, unreachable by valid bins
    prev_bin = jnp.concatenate(
        [jnp.full((B, 1), 0xFFFFFFFF, jnp.uint32), sbin[:, :-1]], axis=1)
    prev_off = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), soff[:, :-1]], axis=1)
    valid = sbin != jnp.uint32(0xFFFFFFFF)
    first = valid & (sbin != prev_bin)
    delta = soff - prev_off
    inc = jnp.where(first, k, jnp.minimum(delta, k)) * valid
    c = jnp.cumsum(inc, axis=1)
    base = jax.lax.cummax(jnp.where(first, c - inc, 0), axis=1)
    s = c - base
    cross = valid & (s >= threshold) & ((s - inc) < threshold)

    # compact anchors (bin-ascending order preserved): scatter each
    # crossing slot to its dense rank — targets are unique per row, so a
    # linear scatter replaces the (B, H) 4-operand compaction sort
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    ac = min(a_cap, H)          # anchor buffers cannot exceed the hit width
    acum = jnp.cumsum(cross.astype(jnp.int32), axis=1) - 1
    atgt = jnp.where(cross & (acum < ac), acum, ac)
    apos = jnp.zeros((B, ac + 1), spos.dtype).at[rows, atgt].set(
        spos)[:, :ac]
    aoff = jnp.zeros((B, ac + 1), soff.dtype).at[rows, atgt].set(
        soff)[:, :ac]
    abin = jnp.full((B, ac + 1), 0xFFFFFFFF, sbin.dtype).at[rows, atgt].set(
        sbin)[:, :ac]
    n_anchors = jnp.sum(cross.astype(jnp.int32), axis=1)

    # ---- prune hits to the union of anchor bin windows ----
    # Chaining reads only hits with bin in [anc - sv, anc + sv) for some
    # anchor (chain.chain_anchors / seed_pos_table.cpp:409); every other
    # hit is dead weight in the host fetch, and at multi-Gbp scale (bucket
    # occupancy ~ genome/4^k) dead hits dominate the buffers.  The pruned
    # arrays keep every window's contents and relative order, so the
    # chaining output is bit-identical.  Over-keeping (clipped gather at
    # the anchor-array edge) is harmless: window slices are value-ranged.
    # uint32 throughout (x64 is disabled): valid bins are <= 2^32-2, the
    # all-ones sentinel marks the anchor tail, and the +-sv window edges
    # saturate (saturation only over-keeps, which is inert).
    n_anc_c = jnp.minimum(n_anchors, ac)
    anc_b = jnp.where(
        jnp.arange(ac, dtype=jnp.int32)[None, :] < n_anc_c[:, None],
        abin, jnp.uint32(0xFFFFFFFF))
    svu = jnp.uint32(sv)
    # first anchor with bin >= hit_bin - sv + 1 (== "> hit_bin - sv",
    # phrased without underflow); hit needed iff that anchor <= bin + sv
    qlo = jnp.maximum(sbin + jnp.uint32(1), svu) - svu
    j = jax.vmap(lambda a, v: jnp.searchsorted(a, v, side="left"))(
        anc_b, qlo)
    hi_max = jnp.uint32(0xFFFFFFFE)
    qhi = jnp.where(sbin >= hi_max - svu, hi_max, sbin + svu)
    aj = jnp.take_along_axis(anc_b, jnp.minimum(j, ac - 1), axis=1)
    needed = valid & (aj <= qhi)
    # compact kept hits by scatter (dense ranks are unique per row);
    # replaces the second (B, H) 4-operand compaction sort
    pcum = jnp.cumsum(needed.astype(jnp.int32), axis=1) - 1
    ptgt = jnp.where(needed, pcum, H)
    pbin = jnp.full((B, H + 1), 0xFFFFFFFF, sbin.dtype).at[
        rows, ptgt].set(sbin)[:, :H]
    poff = jnp.zeros((B, H + 1), soff.dtype).at[rows, ptgt].set(
        soff)[:, :H]
    ppos = jnp.zeros((B, H + 1), spos.dtype).at[rows, ptgt].set(
        spos)[:, :H]
    n_kept = jnp.sum(needed.astype(jnp.int32), axis=1)

    return {
        "hits_bin": pbin, "hits_off": poff, "hits_pos": ppos,
        "n_hits": n_kept,
        "anc_pos": apos, "anc_off": aoff, "anc_bin": abin,
        "n_anchors": n_anc_c,
        "n_anchors_raw": n_anchors,
        "n_queried_buckets": n_queried_buckets,
    }


@functools.partial(
    jax.jit,
    static_argnames=("k", "w", "num_seeds", "max_stride", "overlap",
                     "max_occ", "mq_cap", "lut_shift", "lut_steps",
                     "packed_q"))
def dsoft_count(codes2, lengths, sorted_hashes, *,
                k, w, num_seeds, max_stride, overlap, max_occ, mq_cap,
                lut=None, lut_shift=0, lut_steps=0, bucket_offsets=None,
                packed_q=False):
    """Exact flat-hit-slot count per row — the cheap sizing pre-pass.

    Runs only the minimizer scan + bucket-range lookups (no hit gather, no
    sorts), so the seeder can pick ``hit_cap`` for the fused program
    exactly instead of growing it through overflow retries — each retry
    recompiled the big program (~26 s at 3.2 Gbp scale), which is what
    round 3's seed_dispatch actually spent its 138 s on.

    packed_q: codes2 is (B, Lcap/4) 2-bit-packed (ops/packed.pack2)."""
    if packed_q:
        from darwin_tpu.ops.packed import unpack2
        codes2 = unpack2(codes2)
    offs, qhash, slot_ok = _queried_minimizers(
        codes2, lengths, k, w, num_seeds, max_stride, overlap, mq_cap)
    start, end = _bucket_ranges(sorted_hashes, qhash, lut, lut_shift,
                                lut_steps, bucket_offsets)
    cnt = end - start
    eff = jnp.where(slot_ok & (cnt <= max_occ), cnt, 0)
    return jnp.sum(eff, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "w", "num_seeds", "max_stride", "overlap",
                     "threshold", "bin_size", "max_occ", "mq_cap", "a_cap",
                     "hit_cap", "lut_shift", "lut_steps", "packed_q"))
def dsoft_device(codes2, lengths, sorted_hashes, positions, *,
                 k, w, num_seeds, max_stride, overlap, threshold,
                 bin_size, max_occ, mq_cap, a_cap, hit_cap=None,
                 lut=None, lut_shift=0, lut_steps=0, bucket_offsets=None,
                 packed_q=False):
    """Batched D-SOFT hit generation + anchor selection.

    codes2 : (B, Lcap) uint8 2-bit query codes (row-padded with 0), or
             (B, Lcap/4) packed 4-per-byte when packed_q (the seeder's
             upload format — 4x fewer host->device bytes)
    lengths: (B,) int32
    sorted_hashes/positions: the SeedTable arrays (sorted_hashes is None
    for the csr layout, which passes bucket_offsets instead).
    hit_cap: flat hit-buffer width (default: the lossless worst case
             mq_cap*max_occ).  Rows needing more slots report it in
             n_flat_raw; the caller must retry with a bigger cap.

    Returns dict of device arrays:
      hits_bin/hits_off/hits_pos : (B, H) sorted hits (bin/pos uint32;
                                   invalid tail has bin == 0xFFFFFFFF)
      n_hits                     : (B,) int32
      n_flat_raw                 : (B,) int32 flat slots needed (overflow
                                   check against hit_cap)
      anc_pos/anc_off/anc_bin    : (B, a_cap) int32 anchors in bin order
      n_anchors                  : (B,) int32
      n_queried_buckets          : (B,) int32 (the reference's num_seeds stat)
    """
    if hit_cap is None:
        hit_cap = mq_cap * max_occ
    if packed_q:
        from darwin_tpu.ops.packed import unpack2
        codes2 = unpack2(codes2)
    offs, qhash, slot_ok = _queried_minimizers(
        codes2, lengths, k, w, num_seeds, max_stride, overlap, mq_cap)
    start, end = _bucket_ranges(sorted_hashes, qhash, lut, lut_shift,
                                lut_steps, bucket_offsets)
    binf, offf, posf, _okf, bucket_ok, total = _bucket_hits_flat(
        positions, offs, (start, end), end - start, slot_ok,
        max_occ, bin_size, hit_cap)
    res = _hits_post(binf, offf, posf,
                     jnp.sum(bucket_ok.astype(jnp.int32), axis=1),
                     k, threshold, a_cap, sv_bins(bin_size, overlap))
    res["n_flat_raw"] = total
    # occupancy-cap telemetry: queried buckets skipped for being over
    # kmer_max_occurence (software/seed_pos_table.cpp:314) — the repeat-
    # structure signal real genomes have and uniform synthetics don't
    res["n_capped"] = jnp.sum(
        (slot_ok & ((end - start) > max_occ)).astype(jnp.int32), axis=1)
    return res
