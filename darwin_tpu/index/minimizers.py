"""Device (w,k)-minimizer extraction.

Semantics match the reference's ``iterate_minimizers``
(software/seed_pos_table.h:518-535, scalar oracle at
software/ntcoding.cpp:145-172):

* k-mer at position p packs bases little-endian: base p occupies the LOW two
  bits (GetSeedAtPos, software/ntcoding.h:45-54).
* hash32 is the invertible Wang-style hash masked to 2k bits
  (software/ntcoding.h:56-67).
* m[p] = min over hashes of k-mers starting in the window [p-w+1, p].
* Scan range: p in [w-1, R-k) with R = the sequence length rounded UP to a
  multiple of 16 (qlen_centinel, software/seed_pos_table.h:298,392,463);
  bases beyond the true length are the DRAM 'N' padding, which the 2-bit
  packer folds to code 0 (software/seed_pos_table.h:68-74).
* Emission (software/seed_pos_table.h:342-348): with state last_m=0,
  last_p=0, emit (p, m[p]) when m != last_m or p - last_p >= w; then update.

The sequential emission automaton has a closed form used here (proof: every
change of m forces an emission, so the "last emitted" anchor is always the
start of the current equal-m run, or position 0 for the initial virtual
m=0 run):  emit(p) <=> (p - anchor(p)) % w == 0, where anchor(p) is the
largest p' <= p with m[p'] != m[p'-1] (m[w-2] := 0), else 0.  anchor is a
prefix max — ``lax.cummax`` — so the whole scan is branch-free and
vectorizes over a batch of sequences.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def hash32(key, k: int):
    """software/ntcoding.h:56-67, on uint32 arrays."""
    m = jnp.uint32((1 << (2 * k)) - 1)
    key = key.astype(jnp.uint32)
    key = (~key + (key << 21)) & m
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & m
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & m
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & m
    return key


@functools.partial(jax.jit, static_argnames=("k",))
def kmer_hashes(codes2, k: int):
    """codes2: (B, L) uint8 2-bit codes -> (B, L-k+1) uint32 hashed k-mers."""
    L = codes2.shape[-1]
    P = L - k + 1
    kmer = jnp.zeros(codes2.shape[:-1] + (P,), jnp.uint32)
    for i in range(k):
        kmer = kmer | (codes2[..., i:i + P].astype(jnp.uint32) << (2 * i))
    return hash32(kmer, k)


@functools.partial(jax.jit, static_argnames=("k", "w"))
def minimizer_scan(codes2, lengths, k: int, w: int):
    """Batched minimizer extraction.

    codes2 : (B, L) uint8, 2-bit codes, padding beyond each row's length
             must be 0 (the 'N' fold).  L must be a multiple of 16 and at
             least round16(max length).
    lengths: (B,) int32 true sequence lengths.

    Returns (mins, emit): mins (B, P) uint32 window minima, emit (B, P) bool
    emission mask, with P = L - k + 1; minimizer position p = array index.
    """
    B, L = codes2.shape
    assert L % 16 == 0
    h = kmer_hashes(codes2, k)                      # (B, P)
    P = h.shape[1]

    big = jnp.uint32(0xFFFFFFFF)
    m = h
    for d in range(1, w):
        shifted = jnp.concatenate(
            [jnp.full((B, d), big, jnp.uint32), h[:, :P - d]], axis=1)
        m = jnp.minimum(m, shifted)

    p_idx = jnp.arange(P, dtype=jnp.int32)[None, :]
    m_prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.uint32), m[:, :-1]], axis=1)
    # m[w-2] treated as the initial last_m = 0; positions < w-1 are invalid
    # and masked, so only change[w-1] = (m[w-1] != 0) matters there.
    change = (p_idx >= w - 1) & (
        m != jnp.where(p_idx == w - 1, jnp.uint32(0), m_prev))
    anchor = jax.lax.cummax(
        jnp.where(change, p_idx, 0), axis=1)

    r16 = ((lengths + 15) // 16) * 16               # qlen_centinel + k
    valid = (p_idx >= w - 1) & (p_idx < (r16 - k)[:, None])
    emit = valid & (((p_idx - anchor) % w) == 0)
    return m, emit


# ---------------------------------------------------------------------------
# fixed-shape chunked genome scan
# ---------------------------------------------------------------------------
#
# minimizer_scan compiles per (B, L); scanning each chromosome at its own
# length would recompile per chromosome (a ~30s XLA compile each on big
# programs).  The genome scan instead cuts every chromosome into CHUNK-base
# pieces with a (w+1)-base left halo (so every in-chunk window minimum and
# its predecessor are complete) and processes fixed (CROWS, CHUNK + w + 1 +
# k - 1)-shaped batches — one compiled program for any genome.  The
# emission automaton's anchor (a prefix max over change positions) is
# carried across chunks: within a batch by a tiny segmented scan over rows,
# across batches (and reset at chromosome starts) by the host.

CHUNK = 1 << 14          # bases of new positions per row
CROWS = 128              # rows per device call (host-uploaded rows)
# (CROWS*CHUNK = 2 Mbp per dispatch, same as the previous 8 x 256K rows for
# whole-genome scans; the short rows let a read-set index build — overlap
# mode — pack many short sequences into one dispatch instead of paying a
# full-width dispatch per read.)
#
# When rows are gathered ON DEVICE from the resident packed genome
# (ops/packed.gather_rows) the host sends only a (7, R) meta matrix per
# batch, so the batch can be ~16x larger and per-dispatch latency is paid
# ~16x less often: 32 Mbp/dispatch puts a whole-genome pass at ~100
# dispatches.
CROWS_PACKED = 2048

# sub-phase wall times of the most recent streaming build, for artifact
# stage tables (tools/bigref_e2e.py).  Each build populates a FRESH dict
# and rebinds this module global to it (interleaved builds cannot clobber
# each other's timings); the same dict is also returned to the caller
# (build_seed_table attaches it to the SeedTable as .build_stats).
BUILD_STATS: dict = {}


@functools.partial(jax.jit, static_argnames=("k", "w"))
def _chunk_scan(rows, off, istart, iend, nvalid, carry_in, first,
                k: int, w: int):
    """One batch of sequential chromosome chunks.

    rows   : (B, CL) uint8 2-bit codes; row b covers global code positions
             [off[b], off[b] + CL).
    off    : (B,) int32 global position of rows[b, 0].
    istart : (B,) int32 first interior (non-halo) global position.
    nvalid : (B,) int32 global end of the valid minimizer range for the
             row's chromosome (= round16(length) - k, positions >= this
             never emit and never feed the carry).
    carry_in: (B,) int32 anchor carried into each row from the previous
             batch (only meaningful for rows the segmented scan treats as
             segment starts).
    first  : (B,) int32 1 if this row starts a new chromosome (resets the
             in-batch carry chain).

    Returns (m, emit, carry_out): per-row minima/emission over the row's
    positions, and the inclusive anchor carry after each row.
    """
    B, CL = rows.shape
    h = kmer_hashes(rows, k)                        # (B, PL)
    PL = CL - k + 1
    big = jnp.uint32(0xFFFFFFFF)
    m = h
    for d in range(1, w):
        shifted = jnp.concatenate(
            [jnp.full((B, d), big, jnp.uint32), h[:, :PL - d]], axis=1)
        m = jnp.minimum(m, shifted)

    prow = jnp.arange(PL, dtype=jnp.int32)[None, :]
    pg = off[:, None] + prow                        # global position
    m_prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.uint32), m[:, :-1]], axis=1)
    # windows are complete for prow >= w-1; m_prev additionally needs
    # prow >= w except at the true sequence start (pg == w-1, where the
    # automaton compares against the initial last_m = 0)
    at_init = pg == w - 1
    window_ok = (prow >= w) | (at_init & (prow >= w - 1))
    change = window_ok & (pg < nvalid[:, None]) & (
        m != jnp.where(at_init, jnp.uint32(0), m_prev))
    anchor_local = jax.lax.cummax(jnp.where(change, pg, 0), axis=1)

    # per-row carry contribution: only changes in the row's OWN interior
    # [istart, iend) — the tail overlap beyond iend belongs to (and is
    # recomputed in) the next row's halo, and feeding it into the carry
    # would hand later rows anchors from their own future
    row_change_max = jnp.max(
        jnp.where(change & (pg < iend[:, None]), pg, 0), axis=1)  # (B,)

    # segmented exclusive scan over the B sequential rows
    def seg(carry, x):
        rcm, cin, fst = x
        incoming = jnp.where(fst == 1, cin, carry)
        return jnp.maximum(incoming, rcm), incoming

    _, excl = jax.lax.scan(seg, jnp.int32(0),
                           (row_change_max, carry_in, first))
    anchor = jnp.maximum(anchor_local, excl[:, None])
    carry_out = jnp.maximum(row_change_max, excl)

    interior = (pg >= istart[:, None]) & (pg >= w - 1) & (
        pg < iend[:, None])
    emit = interior & (((pg - anchor) % w) == 0)
    return m, emit, carry_out


def scan_many_minimizers(seqs, k: int, w: int):
    """Fixed-shape minimizer scan of MANY sequences in shared batches.

    seqs: list of (codes2, length_unpadded).  Returns a list of
    (positions, hashes) numpy pairs, one per sequence (sequence-local
    positions), each identical to minimizer_scan on that sequence alone.

    One global work list of (sequence, chunk-start) rows is packed CROWS at
    a time into the single compiled (CROWS, CL) program, so a read-set index
    build (overlap mode: thousands of short "chromosomes",
    software/README.md:25-27) costs ~total_bases/(CROWS*CHUNK) dispatches
    instead of one dispatch per sequence.  The emission automaton's anchor
    chains through rows exactly as before: ``first`` marks rows that do NOT
    continue their predecessor row (a new sequence resets the anchor to 0; a
    batch-leading row resumes its sequence's carried anchor).
    """
    halo = w + 1
    CL = CHUNK + halo + k - 1
    CL = ((CL + 15) // 16) * 16

    nvalids = []
    work = []                 # (seq_idx, chunk_start)
    for si, (codes2, length_unpadded) in enumerate(seqs):
        r16 = ((length_unpadded + 15) // 16) * 16
        nvalid = r16 - k
        nvalids.append(nvalid)
        for s in range(0, max(nvalid, 1), CHUNK):
            work.append((si, s))

    rows_np = np.zeros((CROWS, CL), np.uint8)
    off = np.zeros(CROWS, np.int32)
    istart = np.zeros(CROWS, np.int32)
    iend = np.zeros(CROWS, np.int32)
    nv = np.zeros(CROWS, np.int32)
    first = np.zeros(CROWS, np.int32)
    carry = np.zeros(CROWS, np.int32)

    out_pos = [[] for _ in seqs]
    out_hash = [[] for _ in seqs]
    carry_val = 0             # anchor of the sequence continuing into the
    for base in range(0, len(work), CROWS):   # next batch (work is ordered)
        batch = work[base:base + CROWS]
        rows_np[:] = 0
        nv[:] = 0          # empty rows: nvalid 0 -> nothing emits
        iend[:] = 0
        first[:] = 0
        carry[:] = 0
        for i, (si, s) in enumerate(batch):
            codes2 = seqs[si][0]
            o = max(s - halo, 0)
            seg_ = codes2[o:o + CL]
            rows_np[i, :len(seg_)] = seg_
            rows_np[i, len(seg_):] = 0
            off[i] = o
            istart[i] = s
            iend[i] = min(s + CHUNK, nvalids[si])
            nv[i] = nvalids[si]
            if s == 0:
                first[i] = 1          # new sequence: anchor resets to 0
            elif i == 0:
                first[i] = 1          # batch start: resume carried anchor
                carry[i] = carry_val
        m, emit, carry_out = _chunk_scan(
            jnp.asarray(rows_np), jnp.asarray(off), jnp.asarray(istart),
            jnp.asarray(iend), jnp.asarray(nv), jnp.asarray(carry),
            jnp.asarray(first), k, w)
        m = np.asarray(m)
        emit = np.asarray(emit)
        carry_val = int(np.asarray(carry_out)[len(batch) - 1])
        for i, (si, _s) in enumerate(batch):
            pr = np.nonzero(emit[i])[0]
            out_pos[si].append(pr + off[i])
            out_hash[si].append(m[i][pr])

    res = []
    for si in range(len(seqs)):
        if out_pos[si]:
            res.append((np.concatenate(out_pos[si]).astype(np.int64),
                        np.concatenate(out_hash[si]).astype(np.uint32)))
        else:
            res.append((np.zeros(0, np.int64), np.zeros(0, np.uint32)))
    return res


@functools.partial(jax.jit, static_argnames=("k", "w"))
def _chunk_scan_pairs(rows, off, istart, iend, nvalid, carry_in, first,
                      goff, k: int, w: int):
    """_chunk_scan + in-place (hash, global position) pair emission.

    Non-emitting slots are set to the 0xFFFFFFFF sentinel in BOTH outputs so
    a later device sort pushes them past every real pair; nem counts real
    pairs.  Nothing per-position ever leaves the device.
    """
    m, emit, carry_out = _chunk_scan(rows, off, istart, iend, nvalid,
                                     carry_in, first, k, w)
    B, PL = m.shape
    prow = jnp.arange(PL, dtype=jnp.int32)[None, :]
    pos = (goff[:, None] + off[:, None] + prow).astype(jnp.uint32)
    sent = jnp.uint32(0xFFFFFFFF)
    hout = jnp.where(emit, m, sent).reshape(-1)
    pout = jnp.where(emit, pos, sent).reshape(-1)
    nem = jnp.sum(emit.astype(jnp.int32))
    return hout, pout, carry_out, nem


@functools.partial(jax.jit, static_argnames=())
def _sort_pairs(hcat, pcat):
    return jax.lax.sort((hcat, pcat), num_keys=2)


def _row_batch_len(k: int, w: int) -> int:
    """Row length of a streaming-build batch: CHUNK new positions + the
    (w+1)-base left halo + k-1 tail, rounded to 16.  One home for the
    geometry shared by _packed_row_batches and its buffer-sizing callers.
    """
    # +3: row starts are aligned DOWN to a multiple of 4 so the packed
    # build's device gather is pure byte-aligned block slices
    # (ops/packed.gather_rows); the halo absorbs the alignment shift
    CL = CHUNK + (w + 1) + 3 + k - 1
    return ((CL + 15) // 16) * 16


def _resume_carry(B: int, resume0, carry_prev):
    """Anchor carry vector for a row batch: carry_prev applies ONLY to a
    batch whose row 0 continues the previous batch's sequence (resume0);
    a row-0 that starts a new sequence resets its anchor to 0 like every
    other s == 0 row.  Traced inline inside each build step's jit."""
    return jnp.zeros((B,), jnp.int32).at[0].set(
        jnp.where(resume0 != 0, carry_prev, 0))


# row indices of the (7, R) int32 streaming-build meta matrix — ONE
# host->device transfer per batch instead of seven vector uploads
(META_OFF, META_ISTART, META_IEND, META_NV, META_FIRST, META_GOFF,
 META_GSTART) = range(7)


def _meta_unpack(meta):
    """meta -> (off, istart, iend, nvalid, first, goff) inside a jit.
    goff/gstart are uint32 bit patterns staged through int32 rows; the
    consumers' uint32 casts are modular, so the int32 view is exact."""
    return (meta[META_OFF], meta[META_ISTART], meta[META_IEND],
            meta[META_NV], meta[META_FIRST], meta[META_GOFF])


def _batch_rows(packed_dev) -> int:
    """Rows per streaming-build batch.  Big batches amortize the
    per-dispatch latency of an accelerator; the CPU backend (tests) keeps
    the small width so multi-batch carry-resume stays exercised by small
    fixtures."""
    if packed_dev is None or jax.default_backend() == "cpu":
        return CROWS
    return CROWS_PACKED


def _resolve_packed(packed_dev, need_byte: int):
    """packed_dev may be a device array or a provider callable
    (ops/packed.device_packed_streaming): calling it guarantees bytes
    [0, need_byte) are uploaded and returns the current buffer handle —
    the hook that overlaps the genome upload with the first build pass."""
    if callable(packed_dev):
        return packed_dev(need_byte)
    return packed_dev


def _packed_row_batches(seqs, k: int, w: int, packed_dev=None):
    """Shared streaming-build work list: yield (rows, meta, resume0)
    batches as device arrays — rows (R, CL) uint8 2-bit codes, meta the
    (7, R) int32 matrix of _meta_unpack — covering every chromosome chunk
    in ascending global position order.  Used by both streaming builds
    (sorted pairs and csr); any fix to the halo/carry/packing semantics
    lands once, here.

    packed_dev: optional device-resident 2-bit-packed GLOBAL genome
    (ops/packed.device_packed).  When present, rows are gathered + unpacked
    ON DEVICE from it (ops/packed.gather_rows at global position
    chrom_start + local) instead of sliced on the host and uploaded, and
    batches grow to CROWS_PACKED rows (32 Mbp/dispatch): fewer, bigger
    dispatches with ONE meta upload each.  Row content is identical for every
    position the scan can read (local slices are global slices up to
    r16 - 1 < padded chromosome length; beyond iend the emission mask
    makes the values inert — tests/test_packed_build.py locks table
    equality).

    Fresh host buffers per batch: the streams never host-sync, so uploads
    may still be in flight when the next batch is packed.  ``goff``
    (chromosome global start) and ``gstart`` are staged as uint32 and
    reinterpreted as int32 — starts >= 2^31 (3.2 Gbp genomes) would
    overflow an int32 assignment, while the device's wrap-around add +
    uint32 cast recovers the exact mod-2^32 position.
    """
    halo = w + 1
    CL = _row_batch_len(k, w)
    R = _batch_rows(packed_dev)

    nvalids = []
    work = []
    for si, (codes2, length_unpadded, _g) in enumerate(seqs):
        r16 = ((length_unpadded + 15) // 16) * 16
        nvalid = r16 - k
        nvalids.append(nvalid)
        for s in range(0, max(nvalid, 1), CHUNK):
            work.append((si, s))

    if packed_dev is not None:
        from darwin_tpu.ops.packed import gather_rows

    for base in range(0, len(work), R):
        batch = work[base:base + R]
        if packed_dev is None:
            rows_np = np.zeros((R, CL), np.uint8)
        meta = np.zeros((7, R), np.int32)
        mu = meta.view(np.uint32)        # rows GOFF/GSTART hold uint32
        for i, (si, s) in enumerate(batch):
            o = max(s - halo, 0) & ~3    # byte-aligned for gather_rows
            if packed_dev is None:
                codes2 = seqs[si][0]
                seg_ = codes2[o:o + CL]
                rows_np[i, :len(seg_)] = seg_
            else:
                mu[META_GSTART, i] = (seqs[si][2] + o) & 0xFFFFFFFF
            meta[META_OFF, i] = o
            meta[META_ISTART, i] = s
            meta[META_IEND, i] = min(s + CHUNK, nvalids[si])
            meta[META_NV, i] = nvalids[si]
            mu[META_GOFF, i] = seqs[si][2] & 0xFFFFFFFF
            if s == 0 or i == 0:
                meta[META_FIRST, i] = 1
        resume0 = 1 if batch[0][1] != 0 else 0
        meta_dev = jnp.asarray(meta)
        if packed_dev is None:
            rows = jnp.asarray(rows_np)
        else:
            # rows ascend globally, so the last row bounds the byte need
            si, s = batch[-1]
            last_o = (max(s - halo, 0) & ~3) + seqs[si][2]
            need = (last_o >> 2) + (-(-CL // 4))
            rows = gather_rows(_resolve_packed(packed_dev, need),
                               meta_dev[META_GSTART], CL)
        yield rows, meta_dev, jnp.int32(resume0)


@functools.partial(jax.jit, static_argnames=("k", "w"))
def _chunk_scan_pairs_resume(rows, meta, resume0, carry_prev,
                             k: int, w: int):
    """_chunk_scan_pairs with the resume-carry protocol folded into the
    jit (the anchor carry scalar chains on device; no per-batch sync or
    eager dispatches)."""
    B = rows.shape[0]
    off, istart, iend, nvalid, first, goff = _meta_unpack(meta)
    carry_in = _resume_carry(B, resume0, carry_prev)
    h, p, carry_out, nem = _chunk_scan_pairs(
        rows, off, istart, iend, nvalid, carry_in, first, goff, k, w)
    return h, p, carry_out[B - 1], nem


@functools.partial(jax.jit, static_argnames=("k", "w"),
                   donate_argnums=(4, 5))
def _chunk_scan_pairs_accum(rows, meta, resume0, carry_prev,
                            buf_h, buf_p, woff, k: int, w: int):
    """One streaming build step: scan a row batch, compact its emitted
    (hash, pos) pairs to the front (device sort, sentinels last), and
    append them to the donated accumulator buffers at running offset
    ``woff`` — no host synchronization anywhere in the stream.

    The anchor carry chains on device: row 0 of a resuming batch takes
    ``carry_prev`` (the previous batch's last-row carry), exactly the
    host-side chaining of scan_sorted_pairs_device.  Trailing sentinel
    slots written past woff+nem are overwritten by the next batch (or
    sorted past the final N and sliced off).
    """
    B = rows.shape[0]
    off, istart, iend, nvalid, first, goff = _meta_unpack(meta)
    carry_in = _resume_carry(B, resume0, carry_prev)
    h, p, carry_out, nem = _chunk_scan_pairs(
        rows, off, istart, iend, nvalid, carry_in, first, goff, k, w)
    hs, ps = _sort_pairs(h, p)          # sentinels compact to the tail
    buf_h = jax.lax.dynamic_update_slice(buf_h, hs, (woff,))
    buf_p = jax.lax.dynamic_update_slice(buf_p, ps, (woff,))
    return buf_h, buf_p, woff + nem, carry_out[B - 1], nem


def scan_sorted_pairs_streaming(seqs, k: int, w: int, cap: int,
                                packed_dev=None):
    """Streaming device build for genomes past the all-candidates gate
    (seed_table.device_build_max_bases): transient HBM is ~8 B per EMITTED
    seed (the accumulator) plus one row batch, instead of ~8 B per scanned
    position.

    The reference's answer at this scale is a parallel bucket scatter +
    per-bucket sorts (software/seed_pos_table.cpp:143-174); the device answer
    is compact-and-append per 2 Mbp batch, then ONE device sort of the
    compacted pairs.  Output is identical to scan_sorted_pairs_device
    (keys are unique, so any (hash, pos) sort agrees).

    cap: accumulator capacity in pairs.  Returns (sorted_h, sorted_p,
    n_or_minus1): n_or_minus1 < 0 means the cap overflowed (caller retries
    with a larger cap; detection is conservative — the final batch's slot
    tail must also fit).
    """
    import time as _time
    global BUILD_STATS
    stats: dict = {}
    BUILD_STATS = stats      # per-call isolation (see BUILD_STATS doc)
    t0 = _time.perf_counter()
    slot_len = _batch_rows(packed_dev) * _row_batch_len(k, w)
    buf_h = jnp.full((cap + slot_len,), 0xFFFFFFFF, jnp.uint32)
    buf_p = jnp.full((cap + slot_len,), 0xFFFFFFFF, jnp.uint32)
    woff = jnp.int32(0)
    carry_prev = jnp.int32(0)
    nems = []

    for rows, meta, resume0 in _packed_row_batches(seqs, k, w, packed_dev):
        buf_h, buf_p, woff, carry_prev, nem = _chunk_scan_pairs_accum(
            rows, meta, resume0, carry_prev, buf_h, buf_p, woff, k, w)
        nems.append(nem)        # lazy device scalars; no stream sync

    # total in exact host arithmetic: the device woff is int32 and wraps
    # at 2^31 emitted seeds, which must be a hard error (a single
    # int32-indexed pair table cannot hold it), not a wrapped count
    n = (int(np.asarray(jnp.stack(nems)).astype(np.int64).sum())
         if nems else 0)
    if n >= (1 << 31):
        raise ValueError(
            f"{n} seeds overflow a single int32-indexed pair table; use "
            "the hash-sharded index (parallel/shard_index.py)")
    stats["scan_pass_s"] = round(_time.perf_counter() - t0, 2)
    if n > cap:        # dynamic_update_slice clamps: data was overwritten
        return None, None, -n
    t0 = _time.perf_counter()
    sh, sp = _sort_pairs(buf_h, buf_p)
    stats["sort_s"] = round(_time.perf_counter() - t0, 2)
    return sh[:n], sp[:n], n


@functools.partial(jax.jit, static_argnames=("n_buckets", "k", "w"),
                   donate_argnums=(4,))
def _csr_count_accum(rows, meta, resume0, carry_prev, counts,
                     n_buckets: int, k: int, w: int):
    """CSR build pass A: scan a row batch and scatter-add per-bucket seed
    counts into the donated (n_buckets + 1,) int32 array.  Non-emitting
    slots carry the 0xFFFFFFFF sentinel hash, clamped to the extra slot
    ``counts[n_buckets]`` (a trash bin the offset cumsum later excludes);
    nothing per-position leaves the device.  Also returns the batch's real
    emission count so the caller can total seeds in exact host arithmetic
    (the int32 offset cumsum cannot represent >= 2^31)."""
    B = rows.shape[0]
    off, istart, iend, nvalid, first, goff = _meta_unpack(meta)
    carry_in = _resume_carry(B, resume0, carry_prev)
    h, _p, carry_out, nem = _chunk_scan_pairs(
        rows, off, istart, iend, nvalid, carry_in, first, goff, k, w)
    idx = jnp.minimum(h, jnp.uint32(n_buckets)).astype(jnp.int32)
    counts = counts.at[idx].add(1, mode="drop")
    return counts, carry_out[B - 1], nem


@functools.partial(jax.jit, static_argnames=("k", "w"),
                   donate_argnums=(4, 5))
def _csr_fill_accum(rows, meta, resume0, carry_prev, cursor, posbuf,
                    k: int, w: int):
    """CSR build pass B: scan a row batch, sort its (hash, pos) pairs, and
    scatter each position into its final bucket slot.

    slot = cursor[hash] + within-batch rank: ``cursor`` starts as the
    exclusive bucket offsets and advances by each batch's per-bucket count,
    so — batches arriving in ascending global position order, ranks sorted
    by (hash, pos) — every bucket ends up position-ascending, exactly the
    sorted-pair table's in-bucket order (and the reference's per-bucket
    sort, software/seed_pos_table.cpp:166-174)."""
    B = rows.shape[0]
    off, istart, iend, nvalid, first, goff = _meta_unpack(meta)
    n_buckets = cursor.shape[0]
    n_pos = posbuf.shape[0]
    carry_in = _resume_carry(B, resume0, carry_prev)
    h, p, carry_out, _nem = _chunk_scan_pairs(
        rows, off, istart, iend, nvalid, carry_in, first, goff, k, w)
    hs, ps = _sort_pairs(h, p)                    # sentinels sort last
    m = hs.shape[0]
    i = jnp.arange(m, dtype=jnp.int32)
    run_first = jnp.concatenate(
        [jnp.ones(1, bool), hs[1:] != hs[:-1]])
    rank = i - jax.lax.cummax(jnp.where(run_first, i, 0))
    valid = hs != jnp.uint32(0xFFFFFFFF)
    hidx = jnp.minimum(hs, jnp.uint32(n_buckets)).astype(jnp.int32)
    base = jnp.take(cursor, jnp.minimum(hidx, n_buckets - 1),
                    indices_are_sorted=True)
    # slots are unique and ascending (hs sorted, rank ascending per run;
    # each invalid tail entry gets its own distinct OOB slot so the
    # unique_indices promise holds) — the flags let XLA skip the
    # sort and conflict handling a general scatter needs
    slot = jnp.where(valid, base + rank, n_pos + i)  # invalid -> dropped
    posbuf = posbuf.at[slot].set(ps, mode="drop", indices_are_sorted=True,
                                 unique_indices=True)
    cursor = cursor.at[hidx].add(1, mode="drop", indices_are_sorted=True)
    return cursor, posbuf, carry_out[B - 1]


def build_csr_streaming(seqs, k: int, w: int, packed_dev=None):
    """Streaming CSR seed-table build: (bucket_offsets, positions, n).

    Two passes over the genome (counts, then fill), each streaming 2 Mbp
    row batches; peak HBM is offsets + cursor (2 x 4 B x 4^k) + positions
    (4 B per emitted seed) + one row batch — never the 8 B-per-seed pair
    accumulator or its sort workspace.  This is what fits the DEFAULT
    minimizer window (w=3) of a 3.2 Gbp genome on one 16 GB chip:
    ~1.6 G seeds cost 6.4 GB here vs 12.8 GB as sorted pairs plus a
    >2x sort transient.  The reference's counterpart is the two-phase
    bucket scatter (software/seed_pos_table.cpp:143-174: count, offset
    cumsum, fill, per-bucket sort).

    bucket_offsets: (4^k + 1,) int32, offsets[h] .. offsets[h+1] is the
    position-ascending slice of bucket h.  positions: (n,) uint32.
    Requires 2*k <= 28 (offset array footprint) and n < 2^31.
    """
    if 2 * k > 28:
        raise ValueError("CSR bucket array gated at 4^14 entries (1 GiB)")
    n_buckets = 1 << (2 * k)
    import time as _time
    global BUILD_STATS
    stats: dict = {}
    BUILD_STATS = stats      # rebind, never clear: per-call isolation
    t0 = _time.perf_counter()

    counts = jnp.zeros((n_buckets + 1,), jnp.int32)
    carry_prev = jnp.int32(0)
    nems = []
    for rows, meta, resume0 in _packed_row_batches(seqs, k, w, packed_dev):
        counts, carry_prev, nem = _csr_count_accum(
            rows, meta, resume0, carry_prev, counts, n_buckets, k, w)
        nems.append(nem)        # lazy device scalars; no stream sync

    # total seeds in exact host arithmetic — the int32 offset cumsum wraps
    # silently at 2^31, so it cannot be its own overflow check
    # (this fetch is also the count pass's sync point)
    n = int(np.asarray(jnp.stack(nems)).astype(np.int64).sum()) if nems \
        else 0
    stats["count_pass_s"] = round(_time.perf_counter() - t0, 2)
    t0 = _time.perf_counter()
    if n >= (1 << 31):
        raise ValueError(
            f"{n} seeds overflow a single int32-indexed CSR table; use "
            "the hash-sharded index (parallel/shard_index.py)")
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts[:n_buckets])])

    cursor = offsets[:n_buckets]
    posbuf = jnp.zeros((max(n, 1),), jnp.uint32)
    carry_prev = jnp.int32(0)
    for rows, meta, resume0 in _packed_row_batches(seqs, k, w, packed_dev):
        cursor, posbuf, carry_prev = _csr_fill_accum(
            rows, meta, resume0, carry_prev, cursor, posbuf, k, w)
    # sync the fill pass HERE, so its time lands in fill_pass_s and not
    # in whatever device op the caller runs next
    int(posbuf[-1])
    stats["fill_pass_s"] = round(_time.perf_counter() - t0, 2)
    del cursor
    return offsets, posbuf[:n], n, stats


def scan_sorted_pairs_device(seqs, k: int, w: int, packed_dev=None):
    """Device-resident seed-table build: minimizer scan + (hash, position)
    sort without any per-position host round trip.

    seqs: list of (codes2, length_unpadded, global_start).  Returns
    (sorted_hashes, sorted_positions) device uint32 arrays, ascending by
    (hash, position) — exactly the order of the host path's stable argsort
    over (hash << 32 | pos) keys (keys are unique: positions are globally
    disjoint).  The only transfers are the row uploads and one final
    count (the anchor carry chains on device).

    Transient HBM is ~8 bytes per scanned position (the sort holds every
    candidate slot, emitted or not); callers gate on genome size and fall
    back to the host path beyond it.
    """
    hs, ps, nems = [], [], []
    carry_prev = jnp.int32(0)
    for rows, meta, resume0 in _packed_row_batches(seqs, k, w, packed_dev):
        h, p, carry_prev, nem = _chunk_scan_pairs_resume(
            rows, meta, resume0, carry_prev, k, w)
        hs.append(h)
        ps.append(p)
        nems.append(nem)

    if not hs:
        z = jnp.zeros(0, jnp.uint32)
        return z, z
    sh, sp = _sort_pairs(jnp.concatenate(hs), jnp.concatenate(ps))
    n = int(np.asarray(jnp.stack(nems)).sum())
    return sh[:n], sp[:n]


def scan_chromosome_minimizers(codes2: "np.ndarray", length_unpadded: int,
                               k: int, w: int):
    """Fixed-shape minimizer scan of one chromosome's (padded) 2-bit codes.

    Yields (positions, hashes) numpy arrays (chromosome-local positions).
    Identical emissions to minimizer_scan(codes2[None], [length_unpadded])
    — covered by tests — but compiles exactly one (CROWS, CL) program no
    matter the genome.
    """
    return scan_many_minimizers([(codes2, length_unpadded)], k, w)[0]
