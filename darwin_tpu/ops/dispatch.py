"""Device dispatchers: tile gather from resident sequence buffers + DP.

The reference passes DRAM addresses per tile and lets the kernel index host
memory with on-the-fly reverse/complement (software/Processor.cpp:105,276).
Here the genome and the read batch live in device memory as code arrays;
tiles are gathered on device by index arithmetic (reversal = a reversed
iota) and fed straight into the batched DP.  Each filter batch and each
extension round is ONE compiled program (gather + DP + traceback + result
packing) with one host->device request transfer and one device->host
result fetch.

The round programs take the tile implementation as a static argument: a
module with ``filter_scores`` and ``extend_records`` — ``ops.gact`` (plain
XLA) or ``ops.gact_cuda`` (the CUDA kernels for Hopper).  ``tile_impl``
picks one from the platform JAX runs on.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from darwin_tpu.ops import gact, records
from darwin_tpu.ops.oracle import OP_M as _OPM, OP_I as _OPI, OP_D as _OPD

orc_OP_M = int(_OPM)
orc_OP_I = int(_OPI)
orc_OP_D = int(_OPD)


# ---------------------------------------------------------------------------
# tile implementation choice
# ---------------------------------------------------------------------------

# "lax" = plain XLA (ops/gact.py), "cuda" = the Hopper kernels
# (ops/gact_cuda.py).  The platform decides; Config.processor_library (the
# reference's pluggable-kernel hook, params.cfg [FPGA]) or DARWIN_TPU_KERNEL
# overrides it.
KERNELS = ("lax", "cuda")
_forced: str | None = None


def _check_kernel(name: str) -> str:
    name = name.lower()
    if name not in KERNELS:
        raise ValueError(
            f"unknown tile kernel {name!r}; valid values: "
            f"{', '.join(KERNELS)} (or empty for the platform default)")
    return name


def select_kernel(name: str | None) -> None:
    """Force the tile kernel for this process ('' / None = platform
    default).  ``pipeline.align.run`` calls it with
    ``Config.processor_library`` on every run."""
    global _forced
    _forced = _check_kernel(name) if name else None


@functools.cache
def _platform() -> str:
    return jax.devices()[0].platform


def kernel_name() -> str:
    """The tile kernel this process runs: 'cuda' on a GPU, 'lax' on the
    CPU, unless forced (select_kernel / DARWIN_TPU_KERNEL).  Any other
    platform is an error."""
    plat = _platform()
    name = _forced or os.environ.get("DARWIN_TPU_KERNEL", "")
    if name:
        name = _check_kernel(name)
        if name == "cuda" and plat != "gpu":
            raise ValueError(
                f"tile kernel 'cuda' needs a GPU; JAX runs on {plat!r}")
        return name
    if plat == "gpu":
        return "cuda"
    if plat == "cpu":
        return "lax"
    raise RuntimeError(f"no device path for platform {plat!r} "
                       "(supported: gpu, cpu)")


def tile_impl(ps, qt: int, rt: int):
    """Tile implementation module for one dispatch shape and scoring
    (static params, gact.static_params).  The CUDA kernels cover the
    shapes and scorings ``gact_cuda.supports`` accepts; everything else —
    the large escalation tiles, open-cheaper-than-extend scorings — runs
    the plain XLA implementation."""
    if kernel_name() == "cuda":
        from darwin_tpu.ops import gact_cuda
        if gact_cuda.supports(ps, qt, rt):
            return gact_cuda
    return gact


# process-wide telemetry for the lossless compact-record overflow reruns.
# Printed as a delta per run() alongside the other non-reference counters;
# GIL-racing += is fine for telemetry.
RECOVERY = {"rerun_dispatches": 0, "rerun_lanes": 0}


def rec_bits() -> int:
    """Traceback-record packing width in the fused dispatch results:
    16 = one int16 record per entry (wide), 8 (default) or 4 = 16//bits
    records per entry (records.compact_records).  Narrower packing cuts
    the dominant device->host fetch of the extension loop 2x/4x; a lane
    whose traceback holds an insert run wider than the nI field (> 63 at
    8 bits, > 3 at 4) is flagged in the result and rerun through the wide
    layout, so the output is unconditionally lossless at any width.
    DARWIN_TPU_RECBITS selects (DARWIN_TPU_REC8=0 forces 16, kept as the
    A/B alias).  Read per dispatch — the width is a static jit argument,
    not baked into a cache."""
    if os.environ.get("DARWIN_TPU_REC8", "") == "0":
        return 16
    bits = int(os.environ.get("DARWIN_TPU_RECBITS", "8"))
    if bits not in (4, 8, 16):
        raise ValueError(f"DARWIN_TPU_RECBITS must be 4, 8 or 16: {bits}")
    return bits


# memoized by params identity + geometry (reading params.sub is a
# blocking device fetch; this runs per dispatch in the hot loop).
# Bounded like gact._PARAMS_CACHE: past the cap both structures reset, so
# long-lived processes cannot grow them without bound.
_PACK_CHECK_CACHE: dict = {}
_PACK_CHECK_KEEP: list = []
_PACK_CHECK_MAX = 256


def check_int16_packing(params, qt: int, rt: int, max_tb: int):
    """The packed device->host result matrix is int16; verify the
    configured geometry/scoring cannot overflow it.  The DP is local
    (H >= 0 throughout), so the score is bounded by the largest positive
    substitution score times the shorter tile side; steps are bounded by
    2*max_tb and run-length records by a 14-bit count.  Exotic configs
    fail loudly here instead of silently corrupting scores (params.cfg is
    user-supplied)."""
    key = (id(params), qt, rt, max_tb)
    if key in _PACK_CHECK_CACHE:
        return
    sub = gact.static_params(params)[0]
    max_sub = max(max(v for v in row) for row in sub)
    bound = max(max_sub, 0) * min(qt, rt)
    if bound >= 1 << 15 or 2 * max_tb >= 1 << 15 or qt + rt >= 1 << 14:
        raise ValueError(
            f"tile geometry ({qt}x{rt}, max_tb={max_tb}) with this scoring "
            f"overflows the int16 packed result (score bound {bound}); "
            "reduce tile_size or the scoring magnitudes")
    if len(_PACK_CHECK_KEEP) >= _PACK_CHECK_MAX:
        _PACK_CHECK_CACHE.clear()
        _PACK_CHECK_KEEP.clear()
    _PACK_CHECK_CACHE[key] = True
    _PACK_CHECK_KEEP.append(params)


# Chunk size for >2 GiB genome buffers: a single XLA array past 2^31
# elements miscomputes on this backend, so big genomes upload as a 2-D
# (n_chunks, CHUNK_ELEMS) array and gathers split the uint32 address into
# (chunk, local).  Matches the reference's uint32 / 4 GiB DRAM address
# space (software/DRAM.cpp:8-13, Darwin.bond:99-101).
CHUNK_BITS = 30
CHUNK_ELEMS = 1 << CHUNK_BITS


def chunk_ref_codes(codes: np.ndarray):
    """Host->device layout for a genome code buffer: 1-D for < 2^31
    elements (fast int32 path), else chunk-padded (n_chunks, CHUNK_ELEMS)
    for the uint32 two-level gather."""
    if codes.shape[0] < (1 << 31):
        return codes
    n = -(-codes.shape[0] // CHUNK_ELEMS)
    pad = n * CHUNK_ELEMS - codes.shape[0]
    if pad:
        codes = np.concatenate([codes, np.full(pad, 4, np.uint8)])
    return codes.reshape(n, CHUNK_ELEMS)


def _gather_seq(codes, idx_u32):
    """Gather codes[idx] where codes is 1-D (int32 indices, clipped),
    chunked 2-D (uint32 two-level), or the packed-genome pair
    (packed_bytes, n_bounds) — 2-bit byte gather + bit extract +
    N-parity overwrite, no materialized byte buffer (ops/packed.py).
    Out-of-range indices (padding lanes, including uint32-wrapped ones)
    return in-bounds garbage / N — every such lane is masked by the DP's
    length masking."""
    if isinstance(codes, (tuple, list)):
        from darwin_tpu.ops.packed import gather_codes5
        return gather_codes5(codes[0], codes[1], idx_u32)
    if codes.ndim == 1:
        n = codes.shape[0]
        return jnp.take(codes, jnp.clip(idx_u32.astype(jnp.int32),
                                        0, n - 1))
    nch = codes.shape[0]
    ch = jnp.minimum(idx_u32 >> CHUNK_BITS, np.uint32(nch - 1))
    lo = idx_u32 & np.uint32(CHUNK_ELEMS - 1)
    return codes.at[ch.astype(jnp.int32), lo.astype(jnp.int32)].get(
        mode="promise_in_bounds")


@functools.partial(jax.jit, static_argnames=("qt", "rt"))
def gather_tiles(ref_codes, query_codes, r_start, r_size, q_start, q_size,
                 rev, qt: int, rt: int):
    """Gather (B, rt) ref tiles and (B, qt) query tiles.

    rev=True gathers both tiles reversed (the right-extension orientation,
    align_fields reverse_ref+reverse_query, software/extender.cpp:206).
    Index arithmetic runs in uint32 — the reference's own address width
    (4 GiB DRAM) — with underflows landing in masked padding lanes."""
    r_start = r_start.astype(jnp.uint32)
    r_size = r_size.astype(jnp.uint32)
    q_start = q_start.astype(jnp.uint32)
    q_size = q_size.astype(jnp.uint32)
    i = jnp.arange(rt, dtype=jnp.uint32)[None, :]
    ridx = jnp.where(rev[:, None],
                     r_start[:, None] + r_size[:, None] - 1 - i,
                     r_start[:, None] + i)
    rtile = _gather_seq(ref_codes, ridx)
    j = jnp.arange(qt, dtype=jnp.uint32)[None, :]
    qidx = jnp.where(rev[:, None],
                     q_start[:, None] + q_size[:, None] - 1 - j,
                     q_start[:, None] + j)
    qtile = _gather_seq(query_codes, qidx)
    return qtile, rtile


def pad_batch(b: int) -> int:
    """Host-side batch padding for one dispatch: a power of two (min 8),
    so the number of compiled (B, qt, rt) program variants stays
    logarithmic in the batch range."""
    return max(8, 1 << (b - 1).bit_length())


def _pack_requests(r_start, r_size, q_start, q_size, rev=None,
                   chrom_start=None, chrom_len=None, q_buf_start=None,
                   q_len=None):
    """Stack the per-tile request vectors into ONE uint32 host->device
    transfer (the reference's BatchAlignmentInputFieldsDRAM batching,
    software/Darwin.bond:131-135 — one message per batch, not one per
    field).  uint32 is the full reference address width (4 GiB DRAM).
    Rows: r_start r_size q_start q_size rev, then — when speculation
    needs them — chrom_start chrom_len q_buf_start q_len."""
    n = len(np.asarray(r_start))
    rows = [r_start, r_size, q_start, q_size,
            np.zeros(n) if rev is None else np.asarray(rev)]
    if chrom_start is not None:
        rows += [chrom_start, chrom_len, q_buf_start, q_len]
    return np.stack([np.asarray(r).astype(np.uint64)
                     for r in rows]).astype(np.uint32)


@functools.partial(jax.jit, static_argnames=("impl", "ps", "qt", "rt"))
def _first_tiles_round(ref_codes, query_codes, req, impl, ps, qt, rt):
    """One fused device program for the filter stage: gather + max-cell DP,
    results packed as (3, B) int32 (score, query_max_pos, ref_max_pos)."""
    r_start, r_size = req[0], req[1].astype(jnp.int32)
    q_start, q_size = req[2], req[3].astype(jnp.int32)
    qtile, rtile = gather_tiles(ref_codes, query_codes, r_start, r_size,
                                q_start, q_size, req[4] != 0, qt, rt)
    return jnp.stack(impl.filter_scores(qtile, rtile, q_size, r_size,
                                        ps)).astype(jnp.int32)


def first_tile_scores(ref_codes, query_codes, r_start, r_size, q_start,
                      q_size, params, qt: int, rt: int):
    """Filter-stage dispatch: max-cell scores + positions, no traceback
    (software/filter.cpp:40,71: do_traceback=0, align_fields max-mode).
    Returns the (3, B) device array; the caller's np.asarray is the
    (deferred) fetch, so both strands' dispatches overlap."""
    ps = gact.static_params(params)
    return _first_tiles_round(
        ref_codes, query_codes,
        jnp.asarray(_pack_requests(r_start, r_size, q_start, q_size)),
        tile_impl(ps, qt, rt), ps, qt, rt)


def _device_consumed(rec, r_size, q_size, stop_thr, max_ops):
    """Per-lane (dr, dq) advance a tile's traceback produces under the
    extender's early-cutoff rule (extender.cpp:327-329, see
    pipeline/extend.py::_Ext._applied_ops): ops are taken per 32-op word;
    once the running step count reaches stop_thr, each word is consumed
    only up to (and including) its first M.

    rec: (RT, B) int32 traceback records (14-bit nI + 2-bit closing) in
    column order.  The walk visits columns start_r=r_size-1 down to 0;
    rows above start_r are all-zero.  Used ONLY for speculation — the host
    validates the resulting tile request, so this must be fast, not
    load-bearing.
    """
    RT, B = rec.shape
    nI = rec & 0x3FFF
    closing = (rec >> 14) & 0x3
    nI = nI[::-1]                      # walk order (descending column)
    closing = closing[::-1]
    has_close = (closing != 0).astype(jnp.int32)
    cnt = nI + has_close
    ends = jnp.cumsum(cnt, axis=0)     # inclusive
    starts = ends - cnt
    n_ops = ends[-1]                   # (B,)

    L = -(-max_ops // 32) * 32
    lane = jax.lax.broadcasted_iota(jnp.int32, (RT, B), 1)
    close_pos = jnp.where(has_close == 1, starts + nI, L)  # L = dropped
    ops = jnp.full((L, B), orc_OP_I, jnp.int32)
    ops = ops.at[close_pos, lane].set(closing, mode="drop")
    opidx = jax.lax.broadcasted_iota(jnp.int32, (L, B), 0)
    ops = jnp.where(opidx < n_ops[None, :], ops, 0)

    blocks = ops.reshape(L // 32, 32, B)
    bidx = jnp.arange(1, 33, dtype=jnp.int32)[None, :, None]  # 1-based
    t32 = jnp.arange(0, L, 32, dtype=jnp.int32)

    def blk_step(carry, xs):
        blk, t0 = xs
        count, dr, dq = carry
        # `count` is the APPLIED step count (truncated blocks shrink it,
        # extender.cpp:331 count semantics); the block's valid length is
        # governed by its ORIGINAL offset t0 in the op stream
        steps = count[None, None, :] + bidx               # (1, 32, B)
        cond = (steps >= stop_thr) & (blk[None] == orc_OP_M)
        first = jnp.min(jnp.where(cond[0], bidx[0], 33), axis=0)  # (B,)
        trunc = jnp.where(first <= 32, first, 32)
        valid_len = jnp.clip(n_ops - t0, 0, 32)
        consumed = jnp.minimum(trunc, valid_len)
        take = bidx[0] <= consumed[None, :]
        dr = dr + jnp.sum(jnp.where(take & (blk != orc_OP_I), 1, 0), axis=0)
        dq = dq + jnp.sum(jnp.where(take & (blk != orc_OP_D), 1, 0), axis=0)
        return (count + consumed, dr, dq), None

    zeros = jnp.zeros((B,), jnp.int32)
    (cnt_fin, dr, dq), _ = jax.lax.scan(blk_step, (zeros, zeros, zeros),
                                        (blocks, t32))
    return dr, dq


# Speculative chain depth for square extension tiles: rounds cost a host
# round trip each while the chained tile DP is cheap, so one round computes
# SPEC_K tiles per lane.  Outputs are K-invariant by construction — levels
# are accepted only while the device-computed request matches the exact
# host decode.  SPEC_K = 1 turns speculation off.
SPEC_K = int(os.environ.get("DARWIN_TPU_SPEC_K", "12"))


def _subset_requests(req, idx) -> jnp.ndarray:
    """Columns ``idx`` of a packed request matrix, padded (pad_batch) with
    benign rows (sizes 1, everything else 0) — the flagged lanes of a
    round gathered into their own small rerun batch."""
    r = np.asarray(req)
    nrows = r.shape[0]
    out = np.zeros((nrows, pad_batch(len(idx))), r.dtype)
    for row in (1, 3, 6, 8):          # r_size, q_size, chrom_len, q_len
        if row < nrows:
            out[row] = 1
    out[:, :len(idx)] = r[:, idx]
    return jnp.asarray(out)


@functools.partial(jax.jit, static_argnames=("impl", "ps", "qt", "rt",
                                             "max_tb", "stop_thr", "K",
                                             "bits"))
def _extend_round(ref_codes, query_codes, req, impl, ps, qt, rt, max_tb,
                  stop_thr, K, bits):
    """One fused device program per extension round: K chained tiles per
    lane.  Tile 1 is exact; each further tile's request is predicted from
    its predecessor's cutoff advance (dr, dq) and computed speculatively in
    the same program (a lax.scan over levels).  The packed int16 result
    carries all K record matrices, tile 1's stats, and each speculative
    request as deltas vs its predecessor's — the host walks the chain,
    accepting tile j+1 only while the reconstructed request equals the
    true one after tile j's exact decode.

    Rows: [rec_1..rec_K (K*R) | q_steps1 r_steps1 score1 qpos1 rpos1 |
           (d_rstart d_rsize d_qstart d_qsize) * (K-1) | flag]
    with R = RT at bits=16 (one int16 record per row) and
    ceil(RT/(16//bits)) otherwise (packed records); flag = compact-record
    overflow, which sends the lane through the wide rerun.  K = 1 needs
    only the first five request rows.
    """
    r_start, r_size = req[0], req[1].astype(jnp.int32)
    q_start, q_size = req[2], req[3].astype(jnp.int32)
    rev = req[4] != 0

    def tile(rs, rsz, qs, qsz):
        qtile, rtile = gather_tiles(ref_codes, query_codes, rs, rsz,
                                    qs, qsz, rev, qt, rt)
        return impl.extend_records(qtile, rtile, qsz, rsz, ps, max_tb)

    score1, rec1, qsteps1, rsteps1 = tile(r_start, r_size, q_start, q_size)
    recs = [rec1]
    delta_rows = []
    if K > 1:
        chrom_start = req[5]                   # uint32 (full address width)
        cl32 = req[6].astype(jnp.int32)        # per-chromosome length < 2^31
        q_buf_start = req[7]
        q_len = req[8].astype(jnp.int32)
        TT = jnp.int32(qt)                # speculation is (qt, rt) = (T, T)
        # chromosome-relative int32 coordinates (each chromosome < 2^31; the
        # uint32 subtraction is exact for in-chromosome addresses)
        rel_r = (r_start - chrom_start).astype(jnp.int32)
        rel_q = (q_start - q_buf_start).astype(jnp.int32)
        curr_ref = jnp.where(rev, rel_r, rel_r + r_size - 1)
        curr_q = jnp.where(rev, rel_q, rel_q + q_size - 1)

        def level(carry, _):
            p_rs, p_rsz, p_qs, p_qsz, p_rec, curr_ref, curr_q = carry
            dr, dq = _device_consumed(p_rec, p_rsz, p_qsz, stop_thr, qt + rt)
            # next-tile geometry (mirrors _Ext.request / decode clamps):
            # left: window ending at curr; right: window starting at curr
            curr_ref = jnp.where(rev, jnp.minimum(curr_ref + dr, cl32),
                                 jnp.maximum(curr_ref - dr, 0))
            curr_q = jnp.where(rev, jnp.minimum(curr_q + dq, q_len),
                               jnp.maximum(curr_q - dq, 0))
            rsz2 = jnp.maximum(jnp.where(rev,
                                         jnp.minimum(cl32 - curr_ref, TT),
                                         jnp.minimum(curr_ref + 1, TT)), 1)
            qsz2 = jnp.maximum(jnp.where(rev,
                                         jnp.minimum(q_len - curr_q, TT),
                                         jnp.minimum(curr_q + 1, TT)), 1)
            r_rel2 = jnp.where(rev, curr_ref,
                               jnp.where(curr_ref >= TT,
                                         curr_ref - TT + 1, 0))
            q_rel2 = jnp.where(rev, curr_q,
                               jnp.where(curr_q >= TT, curr_q - TT + 1, 0))
            rs2 = chrom_start + r_rel2.astype(jnp.uint32)
            qs2 = q_buf_start + q_rel2.astype(jnp.uint32)
            _, rec2, _, _ = tile(rs2, rsz2, qs2, qsz2)
            # level-to-level address deltas are < +-2 tiles: exact in int32
            # (uint32 wraparound difference) and in the int16 packed rows
            deltas = jnp.stack([(rs2 - p_rs).astype(jnp.int32), rsz2,
                                (qs2 - p_qs).astype(jnp.int32), qsz2])
            return ((rs2, rsz2, qs2, qsz2, rec2, curr_ref, curr_q),
                    (rec2, deltas))

        _, (spec_recs, deltas) = jax.lax.scan(
            level, (r_start, r_size, q_start, q_size, rec1, curr_ref,
                    curr_q), None, length=K - 1)
        recs += [spec_recs[j] for j in range(K - 1)]
        delta_rows = [deltas.reshape(4 * (K - 1), -1)]

    flag = jnp.zeros(r_start.shape, jnp.int32)
    if bits != 16:
        compacted = []
        for r in recs:
            cr, ovf = records.compact_records(r, bits)
            compacted.append(cr)
            flag = flag | ovf
        recs = compacted
    return jnp.concatenate(
        recs + [jnp.stack([qsteps1, rsteps1, score1, q_size - 1,
                           r_size - 1])]
        + delta_rows + [flag[None, :]], axis=0).astype(jnp.int16)


def _make_round_resolver(packed_dev, rerun_wide, B, K, qt, max_tb,
                         r_start64, q_start64, bits):
    """Shared resolve() for the packed extension-round result
    (single-device and mesh paths).  ``rerun_wide(idx)`` -> (packed_subset,
    cols): the wide-record results for flagged lanes ``idx``, found at
    columns ``cols`` of the returned matrix.  ``bits`` describes the
    primary matrix's record layout (the rerun is always wide).

    Returns the tile-1 dict (ops, n_ops, q_steps, r_steps, score,
    query_max_pos, ref_max_pos) plus, for each speculative level j in
    1..K-1:
      ops_spec/n_ops_spec : lists of tile j's expanded traceback
      spec_req            : list of (r_start, r_size, q_start, q_size)
                            int64 tuples — the request each speculative
                            tile was actually computed under
    """

    def resolve():
        packed = np.asarray(packed_dev)
        nrows = packed.shape[0]
        tailr = 6 + 4 * (K - 1)
        R = (nrows - tailr) // K
        # compact rows may carry padded zero records (they expand to no
        # ops), so R*(16//bits) bounds the wide record count from above
        L = min(qt + R * (16 // bits), 2 * max_tb)
        expand = (records.expand_records if bits == 16
                  else functools.partial(records.expand_records_packed,
                                         bits=bits))
        flagged = np.flatnonzero(packed[-1][:B] != 0)
        sub = cols = Rw = None
        tail = packed[K * R:]
        if flagged.size:  # compact-record overflow: lossless wide rerun
            # (RECOVERY telemetry is counted inside rerun_wide)
            sub_dev, cols = rerun_wide(flagged)
            sub = np.asarray(sub_dev)
            Rw = (sub.shape[0] - tailr) // K
            tail = np.array(tail)
            tail[:, flagged] = sub[K * Rw:][:, cols]

        def level(j):
            o, n = expand(packed[j * R:(j + 1) * R], B, L)
            if sub is not None:
                nv = int(cols.max()) + 1
                ow, nw = records.expand_records(
                    sub[j * Rw:(j + 1) * Rw], nv, L)
                o[flagged], n[flagged] = ow[cols], nw[cols]
            return o, n

        ops1, n1 = level(0)
        u = lambda r: r.astype(np.int64) & 0xFFFF  # unsigned row view
        ops_spec, n_spec, spec_req = [], [], []
        prev_rs, prev_qs = r_start64, q_start64
        for j in range(1, K):
            o, n = level(j)
            ops_spec.append(o)
            n_spec.append(n)
            d = tail[5 + 4 * (j - 1):5 + 4 * j]
            rs = prev_rs + d[0][:B].astype(np.int64)
            qs = prev_qs + d[2][:B].astype(np.int64)
            spec_req.append((rs, u(d[1])[:B], qs, u(d[3])[:B]))
            prev_rs, prev_qs = rs, qs
        return {"ops": ops1, "n_ops": n1,
                "q_steps": tail[0][:B], "r_steps": tail[1][:B],
                "score": tail[2][:B], "query_max_pos": tail[3][:B],
                "ref_max_pos": tail[4][:B],
                "ops_spec": ops_spec, "n_ops_spec": n_spec,
                "spec_req": spec_req}
    return resolve


def round_setup(params, r_start, r_size, q_start, q_size, rev, qt, rt,
                max_tb, chain):
    """Host-side preparation shared by the single-device and mesh
    extension dispatchers: (ps, impl, K, stop_thr, bits, req_np,
    r_start64, q_start64)."""
    check_int16_packing(params, qt, rt, max_tb)
    ps = gact.static_params(params)
    if chain is None:
        K, stop_thr = 1, 0
        req = _pack_requests(r_start, r_size, q_start, q_size, rev)
    else:
        chrom_start, chrom_len, q_buf_start, q_len, stop_thr = chain
        K = SPEC_K
        req = _pack_requests(r_start, r_size, q_start, q_size, rev,
                             chrom_start, chrom_len, q_buf_start, q_len)
    return (ps, tile_impl(ps, qt, rt), K, stop_thr, rec_bits(), req,
            np.asarray(r_start).astype(np.int64),
            np.asarray(q_start).astype(np.int64))


def extend_tiles_async(ref_codes, query_codes, r_start, r_size, q_start,
                       q_size, rev, params, *, qt: int, rt: int,
                       max_tb: int, chain=None):
    """Extension-round dispatch, split into enqueue + resolve.

    Returns a zero-arg ``resolve()`` producing the result dict (see
    _make_round_resolver).  The device program is enqueued immediately;
    the (blocking) device->host fetch only happens inside resolve, so a
    caller with several tile-shape groups per round can enqueue them all
    and overlap each group's fetch/decode with the others' compute (the
    analog of the reference keeping batch_size slots in flight,
    software/extender.cpp:45-533).

    chain: None computes one exact tile per lane; (chrom_start, chrom_len,
    q_buf_start, q_len, stop_thr) chains SPEC_K - 1 speculative tiles
    behind it (square tiles only).
    """
    B = int(np.asarray(r_start).shape[0])
    ps, impl, K, stop_thr, bits, req, r_start64, q_start64 = round_setup(
        params, r_start, r_size, q_start, q_size, rev, qt, rt, max_tb,
        chain)
    packed_dev = _extend_round(ref_codes, query_codes, jnp.asarray(req),
                               impl, ps, qt, rt, max_tb, stop_thr, K, bits)

    def rerun_wide(idx):
        # per-lane recovery: only the flagged lanes rerun, wide records;
        # returns (packed, source column per idx entry)
        RECOVERY["rerun_dispatches"] += 1
        RECOVERY["rerun_lanes"] += len(idx)
        sub = _extend_round(ref_codes, query_codes,
                            _subset_requests(req, idx), impl, ps, qt, rt,
                            max_tb, stop_thr, K, 16)
        return sub, np.arange(len(idx))

    return _make_round_resolver(packed_dev, rerun_wide, B, K, qt, max_tb,
                                r_start64, q_start64, bits)
