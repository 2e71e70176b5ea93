"""GACT extension stage: the outer tiling state machine.

Replaces extender_body (software/extender.cpp:9-1065).  The reference keeps
batch_size=2 concurrent extensions and walks them tile by tile; here every
live extension across the whole read batch contributes one tile per round to
a single large device dispatch (tile gather + DP + traceback fused,
ops/dispatch.py), and the per-tile decode/advance logic runs on the host.

Per-extension behavior is bit-identical to the reference, including its
quirks (kept deliberately — output identity is a goal):

* early tile cutoff: consumption of traceback ops stops after
  min(r_tile,q_tile)-tile_overlap steps at an op==M — but the reference's
  ``break`` exits only the inner 32-op word loop (extender.cpp:280-331), so
  after the threshold each subsequent 32-op word is consumed up to and
  including its first M.  Replicated block by block.
* forward-strand left extension stops when the chained-hit list empties
  (extender.cpp:353) even mid-progress; the reverse-complement left path has
  no such check (:867).  Replicated per strand.
* a forward-strand alignment whose left extension ends exactly at the tile
  where the right side cannot start is dropped without output
  (extender.cpp:363-382 has no printer push), while the rc path emits it
  (:877-903).  Replicated.
* large-tile geometry at decode time is gated on do_overlap==0 (:261,408)
  while the request side is not (:61,136).  Replicated.
* emission order: the reference pushes completed alignments in slot
  completion order of its batch_size-slot scheduler; we reproduce that order
  exactly by replaying the slot schedule from per-extension tile counts
  (``reference_emission_order``), so results are independent of our device
  batch width.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from darwin_tpu.ops import oracle as orc
from darwin_tpu.ops.dispatch import extend_tiles_async
from darwin_tpu.ops.dispatch import pad_batch as _pad_batch
from darwin_tpu.pipeline.filter import ExtendLocation


# ---------------------------------------------------------------------------
# rescoring (extender_body::AlignmentScore, software/extender.cpp:1161-1200)
# ---------------------------------------------------------------------------

_CODE5 = np.full(256, 4, np.int8)
for _i, _c in enumerate("ACGT"):
    _CODE5[ord(_c)] = _i
    _CODE5[ord(_c.lower())] = _i


def alignment_score(ref_bytes: np.ndarray, q_bytes: np.ndarray, cfg) -> int:
    """Two-piece rescore of an aligned pair.  Each maximal gap run scores
    max(short, long) added when the run CLOSES at a non-gap column; a run at
    the very end of the alignment is never added (reference behavior — the
    accumulator is only flushed inside the else branch)."""
    if len(ref_bytes) == 0:
        return 0
    ref = np.frombuffer(bytes(ref_bytes), np.uint8) if not isinstance(
        ref_bytes, np.ndarray) else ref_bytes
    q = np.frombuffer(bytes(q_bytes), np.uint8) if not isinstance(
        q_bytes, np.ndarray) else q_bytes
    dash = np.uint8(ord("-"))
    is_gap = (ref == dash) | (q == dash)
    sub5 = np.array(cfg.sub_matrix_5x5, np.int64)
    rc = _CODE5[ref]
    qc = _CODE5[q]
    match_cols = ~is_gap
    score = int(sub5[qc[match_cols], rc[match_cols]].sum())

    # gap runs followed by a match column
    n = len(ref)
    g = is_gap.astype(np.int8)
    starts = np.nonzero((g == 1) & (np.concatenate(([0], g[:-1])) == 0))[0]
    ends = np.nonzero((g == 1) & (np.concatenate((g[1:], [0])) == 0))[0]
    for s, e in zip(starts, ends):
        if e == n - 1:
            continue  # trailing run never flushed
        ln = e - s + 1
        score += max(cfg.gap_open + (ln - 1) * cfg.gap_extend,
                     cfg.long_gap_open + (ln - 1) * cfg.long_gap_extend)
    return score


# ---------------------------------------------------------------------------
# extension state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExtendAlignment:
    """Completed alignment record for the printer (graph.h:97-121)."""
    read_num: int
    chr_id: int
    strand: str
    reference_start_offset: int
    query_start_offset: int
    reference_end_offset: int
    query_end_offset: int
    reference_length: int
    query_length: int
    aligned_reference: bytes
    aligned_query: bytes
    score: int
    do_print: bool = True


class _Ext:
    """One live extension (ExtendAlignments, graph.h:97-121)."""

    __slots__ = ("read_num", "chr_id", "strand", "ref_start_addr", "ref_len",
                 "q_len", "q_code_start", "curr_ref", "curr_q",
                 "ref_start_off", "q_start_off", "ref_end_off", "q_end_off",
                 "left_done", "right_done", "used_large", "left_hits",
                 "right_hits", "left_chunks", "right_chunks", "tiles",
                 "emitted", "group")

    def __init__(self, loc: ExtendLocation, strand: str, chrom,
                 q_len: int, q_code_start: int, group):
        self.read_num = loc.read_num
        self.chr_id = loc.chr_id
        self.strand = strand
        self.ref_start_addr = chrom.start
        self.ref_len = chrom.length
        self.q_len = q_len
        self.q_code_start = q_code_start   # offset into the device query buf
        self.curr_ref = loc.reference_pos - chrom.start
        self.curr_q = loc.query_pos
        self.ref_start_off = self.curr_ref
        self.q_start_off = self.curr_q
        self.ref_end_off = self.curr_ref
        self.q_end_off = self.curr_q
        self.left_done = False
        self.right_done = False
        self.used_large = False
        self.left_hits = np.asarray(loc.left_hits, np.uint64)
        self.right_hits = np.asarray(loc.right_hits, np.uint64)
        self.left_chunks: list = []    # prepended in reverse at emit
        self.right_chunks: list = []
        self.tiles = 0
        self.emitted: Optional[ExtendAlignment] = None
        self.group = group

    # -- tile geometry -----------------------------------------------------

    def _large_sizes(self, left: bool, cfg):
        hits = self.left_hits if left else self.right_hits
        hit = int(hits[-1])
        h1 = self.ref_start_addr + self.curr_ref
        o1 = self.curr_q
        h2, o2 = hit >> 32, hit & 0xFFFFFFFF
        if left:
            big_ref = (h1 - h2) > (o1 - o2)
        else:
            big_ref = (h2 - h1) > (o2 - o1)
        if big_ref:
            return cfg.large_tile_long, cfg.large_tile_short
        return cfg.large_tile_short, cfg.large_tile_long

    def request(self, cfg, counters):
        """(r_start_abs, r_size, q_start_rel, q_size, reversed, (rt, qt))."""
        if not self.left_done:
            rt = qt = cfg.tile_size
            if self.used_large:
                rt, qt = self._large_sizes(True, cfg)
                counters["num_large_tiles"] += 1
            r_size = min(self.curr_ref + 1, rt)
            q_size = min(self.curr_q + 1, qt)
            r_start = self.ref_start_addr + (
                self.curr_ref - rt + 1 if self.curr_ref >= rt else 0)
            q_start = self.curr_q - qt + 1 if self.curr_q >= qt else 0
            return (r_start, r_size, q_start, q_size, False, (rt, qt))
        rt = qt = cfg.tile_size
        if self.used_large:
            rt, qt = self._large_sizes(False, cfg)
            counters["num_large_tiles"] += 1
        r_size = min(self.ref_len - self.curr_ref, rt)
        q_size = min(self.q_len - self.curr_q, qt)
        return (self.ref_start_addr + self.curr_ref, r_size,
                self.curr_q, q_size, True, (rt, qt))

    # -- decode ------------------------------------------------------------

    def _applied_ops(self, ops: np.ndarray, stop_thr: int) -> np.ndarray:
        """Replicate the inner-loop-only break (extender.cpp:327-329): per
        32-op word, once the global step count has reached stop_thr, ops are
        consumed up to and including the word's first M."""
        out = []
        count = 0
        for t in range(0, len(ops), 32):
            blk = ops[t:t + 32]
            steps = count + np.arange(1, len(blk) + 1)
            cond = (steps >= stop_thr) & (blk == orc.OP_M)
            idx = np.nonzero(cond)[0]
            if len(idx):
                blk = blk[:idx[0] + 1]
            out.append(blk)
            count += len(blk)
        return np.concatenate(out) if out else ops[:0]

    def tile_stop(self, cfg):
        """(left, stop_thr) for the tile about to be decoded (decode-side
        tile sizes gated by do_overlap, extender.cpp:261,408)."""
        left = not self.left_done
        rt = qt = cfg.tile_size
        if self.used_large and not cfg.do_overlap:
            rt, qt = self._large_sizes(left, cfg)
        return left, min(rt, qt) - cfg.tile_overlap

    def apply_native(self, left: bool, n_ops_total: int, rchars, qchars,
                     new_ref: int, new_q: int, rb: bool, qb: bool,
                     cfg) -> bool:
        """Apply a natively-decoded tile (chunk append, offsets,
        termination) — shared by the per-tile and batched native paths."""
        self.tiles += 1
        if left:
            self.left_chunks.append((rchars[::-1], qchars[::-1]))
            if rb:
                self.ref_start_off = 0
            if qb:
                self.q_start_off = 0
        else:
            self.right_chunks.append((rchars, qchars))
        self.curr_ref = new_ref
        self.curr_q = new_q
        return self._post_decode(left, n_ops_total, cfg)

    def decode(self, ops: np.ndarray, bases: np.ndarray, q_bytes: np.ndarray,
               cfg, counters, next_loc) -> bool:
        """Apply one tile's traceback.  Returns True when this extension is
        finished (slot may be refilled).  ``q_bytes`` is the padded
        strand-local query ASCII; ``next_loc`` unused (slot refill handled by
        the manager)."""
        left, stop_thr = self.tile_stop(cfg)
        n_ops_total = len(ops)

        from darwin_tpu import native
        nat = native.decode_ops_native(
            ops, stop_thr, 0 if left else 1, bases, self.ref_start_addr,
            q_bytes, self.curr_ref, self.curr_q, self.ref_len, self.q_len)
        if nat is not None:
            rchars, qchars, new_ref, new_q, rb, qb = nat
            return self.apply_native(left, n_ops_total, rchars, qchars,
                                     new_ref, new_q, rb, qb, cfg)

        self.tiles += 1
        a = self._applied_ops(ops, stop_thr)

        ref_consume = a != orc.OP_I
        q_consume = a != orc.OP_D
        k_ref = np.cumsum(ref_consume) - ref_consume
        k_q = np.cumsum(q_consume) - q_consume
        tot_ref = int(ref_consume.sum())
        tot_q = int(q_consume.sum())
        dash = np.uint8(ord("-"))

        if left:
            pos_ref = np.maximum(self.curr_ref - k_ref, 0)
            pos_q = np.maximum(self.curr_q - k_q, 0)
            rchars = np.where(ref_consume,
                              bases[self.ref_start_addr + pos_ref], dash)
            qchars = np.where(q_consume, q_bytes[pos_q], dash)
            # buffer written right-to-left => chunk is reversed op order
            self.left_chunks.append((rchars[::-1], qchars[::-1]))
            if tot_ref >= self.curr_ref + 1:
                self.ref_start_off = 0
            if tot_q >= self.curr_q + 1:
                self.q_start_off = 0
            self.curr_ref = max(self.curr_ref - tot_ref, 0)
            self.curr_q = max(self.curr_q - tot_q, 0)
        else:
            pos_ref = np.minimum(self.curr_ref + k_ref, self.ref_len)
            pos_q = np.minimum(self.curr_q + k_q, self.q_len)
            rchars = np.where(ref_consume,
                              bases[self.ref_start_addr + pos_ref], dash)
            qchars = np.where(q_consume, q_bytes[pos_q], dash)
            self.right_chunks.append((rchars, qchars))
            self.curr_ref = min(self.curr_ref + tot_ref, self.ref_len)
            self.curr_q = min(self.curr_q + tot_q, self.q_len)

        return self._post_decode(left, n_ops_total, cfg)

    def _post_decode(self, left: bool, n_ops_total: int, cfg) -> bool:
        """Hit popping + termination logic shared by the native and numpy
        decode paths (extender.cpp:336-394 / :472-524)."""
        if left:
            # pop chained hits (extender.cpp:336-351)
            if len(self.left_hits):
                x = self.ref_start_addr + self.curr_ref
                h = (self.left_hits >> np.uint64(32)).astype(np.int64)
                o = (self.left_hits & np.uint64(0xFFFFFFFF)).astype(np.int64)
                good = np.nonzero((h < x) & (o < self.curr_q))[0]
                self.left_hits = self.left_hits[:good[-1] + 1] if len(good) \
                    else self.left_hits[:0]

            at_bound = self.ref_start_off == 0 or self.q_start_off == 0
            no_hits = len(self.left_hits) == 0
            outer = (n_ops_total == 0) or at_bound
            if self.strand == "+":
                outer = outer or no_hits  # fw-only check (extender.cpp:353)
            if outer:
                if self.used_large or no_hits or at_bound:
                    self.left_done = True
                    if self.ref_start_off > 0:
                        self.ref_start_off = self.curr_ref + 1
                    if self.q_start_off > 0:
                        self.q_start_off = self.curr_q + 1
                    if (self.curr_ref + 1 < self.ref_len
                            and self.curr_q + 1 < self.q_len
                            and not self.right_done):
                        self.curr_ref = self.ref_end_off + 1
                        self.curr_q = self.q_end_off + 1
                        return False
                    # cannot start the right side
                    self.right_done = True
                    if self.strand == "-":
                        # rc path emits here (extender.cpp:886-888);
                        # fw path silently drops (:363-382)
                        self._emit(cfg)
                    return True
                self.used_large = True
                return False
            self.used_large = False
            return False

        # ---- right side ----
        if len(self.right_hits):
            x = self.ref_start_addr + self.curr_ref
            h = (self.right_hits >> np.uint64(32)).astype(np.int64)
            o = (self.right_hits & np.uint64(0xFFFFFFFF)).astype(np.int64)
            good = np.nonzero((h > x) & (o > self.curr_q))[0]
            self.right_hits = self.right_hits[:good[-1] + 1] if len(good) \
                else self.right_hits[:0]

        at_end = (self.curr_ref == self.ref_len or self.curr_q == self.q_len)
        if (n_ops_total == 0) or at_end:
            if self.used_large or len(self.right_hits) == 0 or at_end:
                self.ref_end_off = self.curr_ref - 1
                self.q_end_off = self.curr_q - 1
                self._emit(cfg)
                self.right_done = True
                return True
            self.used_large = True
            return False
        self.used_large = False
        return False

    def _emit(self, cfg):
        parts_r = [c[0] for c in reversed(self.left_chunks)] + \
                  [c[0] for c in self.right_chunks]
        parts_q = [c[1] for c in reversed(self.left_chunks)] + \
                  [c[1] for c in self.right_chunks]
        ar = np.concatenate(parts_r) if parts_r else np.zeros(0, np.uint8)
        aq = np.concatenate(parts_q) if parts_q else np.zeros(0, np.uint8)
        self.emitted = ExtendAlignment(
            read_num=self.read_num, chr_id=self.chr_id, strand=self.strand,
            reference_start_offset=self.ref_start_off,
            query_start_offset=self.q_start_off,
            reference_end_offset=self.ref_end_off,
            query_end_offset=self.q_end_off,
            reference_length=self.ref_len, query_length=self.q_len,
            aligned_reference=ar.tobytes(), aligned_query=aq.tobytes(),
            score=alignment_score(ar, aq, cfg))


# ---------------------------------------------------------------------------
# reference emission-order replay
# ---------------------------------------------------------------------------

def reference_emission_order(tile_counts: List[int], batch_size: int,
                             counters=None):
    """Replay the reference's slot scheduler (extender.cpp:34-533) from
    per-extension tile counts.  Returns extension indices in completion
    order; also accumulates the reference's num_extend_tiles /
    num_active_tiles counters (which count slots x iterations, including
    dummy tiles)."""
    n = len(tile_counts)
    if n == 0:
        return []
    width = min(n, batch_size)
    slot_ext = list(range(width))
    remaining = [tile_counts[i] for i in slot_ext]
    nxt = width
    active = width
    done = 0
    order = []
    while done < n:
        if counters is not None:
            counters["num_extend_tiles"] += width
            counters["num_active_tiles"] += active
        for s in range(width):
            if slot_ext[s] is None:
                continue
            remaining[s] -= 1
            if remaining[s] == 0:
                order.append(slot_ext[s])
                done += 1
                if nxt < n:
                    slot_ext[s] = nxt
                    remaining[s] = tile_counts[nxt]
                    nxt += 1
                else:
                    slot_ext[s] = None
                    active -= 1
    return order


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------

def _round_up(x, m):
    return -(-x // m) * m


class ExtensionManager:
    """Runs all extensions of a read batch through wide device dispatches."""

    def __init__(self, store, reads, cfg, params, mesh_dispatch=None,
                 ref_codes_dev=None, stage_seconds: dict | None = None):
        import time as _time
        _t = _time.perf_counter

        def mark(key, t0):
            if stage_seconds is not None:
                stage_seconds[key] = (stage_seconds.get(key, 0.0)
                                      + _t() - t0)
            return _t()

        self.store = store
        self.cfg = cfg
        self.params = params
        self.mesh = mesh_dispatch
        # genome + large-tile 'N' margin, memoized on the store: the old
        # per-batch np.concatenate was a full-genome host copy every read
        # batch
        self.bases = store.bases_with_margin(4 * cfg.large_tile_long)
        # device genome codes shared across batches (the caller caches the
        # upload — one genome transfer per run, not one per read batch)
        self.ref_codes_dev = ref_codes_dev
        self.spec_hits = 0         # accepted speculative second tiles
        self.spec_misses = 0
        # stage-timing sink (per-call dict from Aligner.align_batch); keys:
        # ru_* sub-splits of read_upload (qbuild = host pad/concat,
        # pack = 2-bit pack + N boundaries, enqueue = device decode
        # dispatch), extend_dispatch (request build + device enqueue),
        # extend_fetch (blocking result fetch), extend_decode (host decode)
        self.stage_seconds: dict | None = stage_seconds
        t0 = _t()
        # per-(read,strand) padded ASCII + device code buffer
        margin = 4 * cfg.tile_size
        bufs, offsets = [], {}
        pos = 0
        self.q_bytes = {}
        for i, r in enumerate(reads):
            for strand, seq in (("+", r.seq), ("-", r.rc_seq)):
                padded = np.concatenate(
                    [seq, np.full(margin, ord("N"), np.uint8)])
                self.q_bytes[(i, strand)] = padded
                bufs.append(padded)
                offsets[(i, strand)] = pos
                pos += len(padded)
        self.q_code_start = offsets
        allq = np.concatenate(bufs) if bufs else np.zeros(1, np.uint8)
        # pad the buffer to a power of two (min 1 MB) with 'N': the buffer
        # length is a static shape in EVERY downstream device program
        # (codes decode, tile gathers, the fused extension dispatches), so
        # a per-batch ragged length recompiled them all each batch — at
        # 3.2 Gbp scale that was ~260 s/batch of XLA compiles booked to
        # read_upload.  Reads beyond the true data are 'N', exactly what
        # the old exact-length buffer's clipped gathers returned (the last
        # real byte is always margin 'N').
        n1 = max(1 << 20, 1 << int(np.ceil(np.log2(max(len(allq), 1)))))
        if n1 != len(allq):
            allq = np.concatenate(
                [allq, np.full(n1 - len(allq), ord("N"), np.uint8)])
        self.q_ascii = allq          # batched decode indexes it by offset
        t0 = mark("ru_qbuild", t0)
        if self.mesh is not None:
            from darwin_tpu.genome import encode5
            self.q_codes_dev = self.mesh.put_replicated(encode5(allq))
            mark("ru_enqueue", t0)
        else:
            # 2-bit packed upload + on-device decode: codes5_from_packed
            # rebuilds the identical 1-byte code buffer on the device from
            # a quarter of the bytes (the N margins and the pad tail ride
            # the boundary list).  Matches the reference's upload-once DRAM
            # seam (software/sender.cpp:4-97).
            from darwin_tpu.genome import encode2
            from darwin_tpu.ops import packed as PK
            pk = PK.pack2(encode2(allq))
            bounds = PK.n_boundaries(allq)
            # floor 2048 keeps the boundary-list length — also a static
            # shape — from recompiling across batches
            m = max(2048, 1 << int(np.ceil(np.log2(bounds.shape[0] + 1))))
            bounds = PK.pad_bounds(bounds, m)
            t0 = mark("ru_pack", t0)
            self.q_codes_dev = PK.codes5_from_packed(
                jnp.asarray(pk), jnp.asarray(bounds), len(allq))
            mark("ru_enqueue", t0)

    def _ref_dev(self):
        if self.ref_codes_dev is None:
            from darwin_tpu.genome import encode5
            from darwin_tpu.ops.dispatch import chunk_ref_codes
            codes = chunk_ref_codes(encode5(self.bases))
            self.ref_codes_dev = (self.mesh.put_replicated(codes)
                                  if self.mesh else jnp.asarray(codes))
        return self.ref_codes_dev

    def _decode_wave(self, exts, tiles, opsmat, nvec, cfg,
                     counters) -> dict:
        """Decode one wave of tiles — list of (batch row b, ext index ei)
        with ops opsmat[b, :nvec[b]] — through ONE native call (per-tile
        ctypes overhead was ~half the extension host time).  Falls back to
        the per-tile decode when the native library is absent.  Returns
        {ei: finished}."""
        from darwin_tpu import native
        out = {}
        if len(tiles) > 1 and native.available():
            n = len(tiles)
            sel = np.empty(n, np.int64)
            n_ops = np.empty(n, np.int64)
            stops = np.empty(n, np.int64)
            dirs = np.empty(n, np.int32)
            rsa = np.empty(n, np.int64)
            qoff = np.empty(n, np.int64)
            cr = np.empty(n, np.int64)
            cq = np.empty(n, np.int64)
            rl = np.empty(n, np.int64)
            ql = np.empty(n, np.int64)
            lefts = []
            for i, (b, ei) in enumerate(tiles):
                e = exts[ei]
                left, stop = e.tile_stop(cfg)
                lefts.append(left)
                sel[i] = b
                n_ops[i] = int(nvec[b])
                stops[i] = stop
                dirs[i] = 0 if left else 1
                rsa[i] = e.ref_start_addr
                qoff[i] = e.q_code_start
                cr[i] = e.curr_ref
                cq[i] = e.curr_q
                rl[i] = e.ref_len
                ql[i] = e.q_len
            res = native.decode_ops_batch_native(
                opsmat, sel, n_ops, stops, dirs, self.bases, rsa,
                self.q_ascii, qoff, cr, cq, rl, ql)
            if res is not None:
                out_ref, out_q, cols, new_ref, new_q, rb, qb = res
                for i, (b, ei) in enumerate(tiles):
                    e = exts[ei]
                    c = int(cols[i])
                    out[ei] = e.apply_native(
                        lefts[i], int(n_ops[i]), out_ref[i, :c],
                        out_q[i, :c], int(new_ref[i]), int(new_q[i]),
                        bool(rb[i]), bool(qb[i]), cfg)
                return out
        for b, ei in tiles:
            e = exts[ei]
            out[ei] = e.decode(opsmat[b, :nvec[b]], self.bases,
                               self.q_bytes[(e.read_num, e.strand)], cfg,
                               counters, None)
        return out

    def run(self, groups, reads, counters) -> List[List[ExtendAlignment]]:
        """groups: list of (read_num, strand, [ExtendLocation...]) in
        reference order (per read: fw group then rc group).  Returns the
        per-group emitted alignments in reference emission order."""
        cfg = self.cfg
        exts: List[_Ext] = []
        for gi, (read_num, strand, locs) in enumerate(groups):
            for loc in locs:
                chrom = self.store.chromosomes[loc.chr_id]
                exts.append(_Ext(loc, strand, chrom, reads[read_num].length,
                                 self.q_code_start[(read_num, strand)], gi))

        max_lanes = cfg.extension_lanes
        pending = list(range(len(exts)))
        live = pending[:max_lanes]
        pending = pending[max_lanes:]
        refc = self._ref_dev()

        import time as _time
        tacc = self.stage_seconds
        _t = _time.perf_counter

        def mark(key, t0):
            if tacc is not None:
                tacc[key] = tacc.get(key, 0.0) + _t() - t0
            return _t()

        T = cfg.tile_size
        cached_req = {}    # ei -> request computed during failed speculation
        while live:
            t0 = _t()
            counters["num_extend_rounds"] = (
                counters.get("num_extend_rounds", 0) + 1)
            # group live extensions by tile shape
            reqs = {}
            for ei in live:
                r = cached_req.pop(ei, None)
                if r is None:
                    r = exts[ei].request(cfg, counters)
                reqs.setdefault(r[5], []).append((ei, r))
            t0 = mark("extend_req", t0)
            finished = []
            # phase 1: enqueue every tile-shape group's device program
            # (async) so each group's fetch/decode overlaps the others'
            # compute; phase 2: resolve + decode in order.
            rounds = []
            for (rt, qt), items in reqs.items():
                B = len(items)
                bp = _pad_batch(B)
                if self.mesh:
                    bp = self.mesh.pad(bp)
                r_start = np.zeros(bp, np.int64)
                r_size = np.ones(bp, np.int32)
                q_start = np.zeros(bp, np.int64)
                q_size = np.ones(bp, np.int32)
                rev = np.zeros(bp, bool)
                cstart = np.zeros(bp, np.int64)
                clen = np.ones(bp, np.int64)
                qbuf0 = np.zeros(bp, np.int64)
                qlen = np.ones(bp, np.int64)
                for b, (ei, (rs, rsz, qs, qsz, rv, _)) in enumerate(items):
                    e = exts[ei]
                    r_start[b] = rs
                    r_size[b] = rsz
                    q_start[b] = e.q_code_start + qs
                    q_size[b] = qsz
                    rev[b] = rv
                    cstart[b] = e.ref_start_addr
                    clen[b] = e.ref_len
                    qbuf0[b] = e.q_code_start
                    qlen[b] = e.q_len
                t0 = mark("extend_pack", t0)
                # square tiles chain SPEC_K - 1 speculative tiles on the
                # device; accepted below only when the device-computed
                # request equals the true one (bit-exactness never depends
                # on the device's advance prediction)
                chain = ((cstart, clen, qbuf0, qlen,
                          min(rt, qt) - cfg.tile_overlap)
                         if (rt, qt) == (T, T) else None)
                dispatch = (self.mesh.extend_tiles_async if self.mesh
                            else extend_tiles_async)
                resolve = dispatch(
                    refc, self.q_codes_dev, r_start, r_size, q_start,
                    q_size, rev, self.params, qt=qt, rt=rt,
                    max_tb=2 * cfg.tile_size, chain=chain)
                rounds.append((items, resolve, rev))
                t0 = mark("extend_enqueue", t0)
            t0 = mark("extend_dispatch", t0)
            for items, resolve, rev in rounds:
                t0 = _t()
                res = resolve()
                ops_h = np.asarray(res["ops"])
                n_h = np.asarray(res["n_ops"])
                t0 = mark("extend_fetch", t0)
                n_levels = len(res["ops_spec"])
                # decode level by level in WAVES (one batched native decode
                # per level) — per tile this performs exactly the original
                # request/compare/decode sequence, stopping at the first
                # mismatch or termination; the speculative chain: accept
                # level j only while the device's request equals the true
                # one after the exact decode of level j-1
                tiles = [(b, ei) for b, (ei, _) in enumerate(items)]
                done_map = self._decode_wave(exts, tiles, ops_h, n_h, cfg,
                                             counters)
                alive = []
                for b, ei in tiles:
                    if done_map[ei]:
                        finished.append(ei)
                    else:
                        alive.append((b, ei))
                for j in range(n_levels):
                    if not alive:
                        break
                    sr = res["spec_req"][j]
                    accepted = []
                    for b, ei in alive:
                        e = exts[ei]
                        rs2, rsz2, qs2, qsz2, rv2, shape2 = e.request(
                            cfg, counters)
                        if (shape2 == (T, T) and rv2 == rev[b]
                                and rs2 == int(sr[0][b])
                                and rsz2 == int(sr[1][b])
                                and e.q_code_start + qs2 == int(sr[2][b])
                                and qsz2 == int(sr[3][b])):
                            self.spec_hits += 1
                            counters["num_spec_hits"] = (
                                counters.get("num_spec_hits", 0) + 1)
                            accepted.append((b, ei))
                        else:
                            self.spec_misses += 1
                            counters["num_spec_misses"] = (
                                counters.get("num_spec_misses", 0) + 1)
                            cached_req[ei] = (rs2, rsz2, qs2, qsz2, rv2,
                                              shape2)
                    if not accepted:
                        break
                    done_map = self._decode_wave(
                        exts, accepted, np.asarray(res["ops_spec"][j]),
                        np.asarray(res["n_ops_spec"][j]), cfg, counters)
                    alive = []
                    for b, ei in accepted:
                        if done_map[ei]:
                            finished.append(ei)
                        else:
                            alive.append((b, ei))
                # tiles that consumed all levels without termination get a
                # fresh request next round
                mark("extend_decode", t0)
            for ei in finished:
                live.remove(ei)
                if pending:
                    live.append(pending.pop(0))

        # replay reference ordering per group
        out = [[] for _ in groups]
        by_group = {}
        for idx, e in enumerate(exts):
            by_group.setdefault(e.group, []).append(idx)
        for gi, idxs in by_group.items():
            counts = [exts[i].tiles for i in idxs]
            order = reference_emission_order(counts, self.cfg.batch_size,
                                             counters)
            for local in order:
                e = exts[idxs[local]]
                if e.emitted is not None:
                    out[gi].append(e.emitted)
        return out
