"""2-bit packed sequence transport: upload genomes/reads once, 4 bases per
byte, and derive every device code buffer on chip.

The reference keeps ONE resident copy of every sequence (the 4 GiB DRAM
buffer, software/DRAM.cpp:8-13) and the FPGA seam uploads it once
(software/sender.cpp:4-97).  Shipping a 3.2 Gbp genome as 1-byte codes
is 3.2 GB of host->device transfer (and the streaming index build would
re-send it as row batches); this module makes it 2 bits/base, once, and
keeps no 1-byte-per-base genome buffer on the device:

* hosts pack 2-bit codes 4-per-byte (``pack2``) and extract the non-ACGT
  run boundaries (``n_boundaries``) — N positions are the only information
  the 2-bit codes lose;
* the device unpacks (``unpack2``), reapplies N via a boundary-parity
  lookup (``apply_n``: position is N iff searchsorted(bounds, i, right) is
  odd), gathers row windows for the streaming index builds
  (``gather_rows``), and materializes the 5-letter code buffers the
  filter/extension gathers read (``codes5_from_packed``).

Everything derived here is bit-identical to the direct host encode5/encode2
uploads it replaces (tests/test_packed.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_ACGT_MASK = np.zeros(256, bool)
for _c in b"acgtACGT":
    _ACGT_MASK[_c] = True


def pack2(codes2: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes (values 0..3) 4 per byte, code i at bits 2*(i%4).
    Length is padded up to a multiple of 4 with zeros.

    Contiguous uint32 lane math instead of 4 strided byte views: little-
    endian, byte i of each word sits at bits 8i, so one shift-and-mask
    chain compresses 4 codes to the low byte — ~10x the strided-view
    throughput on the 1-core host (the 3.2 Gbp pack was 155 s)."""
    n = codes2.shape[-1]
    n4 = -(-n // 4) * 4
    if n4 == n and codes2.flags.c_contiguous:
        buf = codes2            # aligned (genome stores pad to 128)
    elif codes2.ndim == 1:
        buf = np.zeros(n4, np.uint8)
        buf[:n] = codes2
    else:
        buf = np.zeros((codes2.shape[0], n4), np.uint8)
        buf[:, :n] = codes2
    v = buf.view(np.uint32)     # little-endian: code j at bits 8j
    w = (v | (v >> 6)) & np.uint32(0x0F000F)   # codes {0,1} -> bits 0-3,
    w = (w | (w >> 12)) & np.uint32(0xFF)      # {2,3} -> 16-19; then low 8
    return w.astype(np.uint8)


def n_boundaries(bases: np.ndarray,
                 chunk: int = 256 << 20) -> np.ndarray:
    """Run boundaries of non-ACGT bytes: uint32 [s0, e0, s1, e1, ...] with
    position p non-ACGT iff an odd number of boundaries are <= p.

    Chunked: the whole-array formulation held two genome-sized temporaries
    (bool mask + int8 diff) — ~6.4 GB of transient host RAM at 3.2 Gbp."""
    starts_l, ends_l = [], []
    prev = False               # isn of the last byte of the previous chunk
    for a in range(0, len(bases), chunk):
        seg = bases[a:a + chunk]
        isn = ~_ACGT_MASK[seg]
        d = np.diff(isn.astype(np.int8))
        starts = np.flatnonzero(d == 1) + 1 + a
        ends = np.flatnonzero(d == -1) + 1 + a
        if isn[0] and not prev:
            starts = np.concatenate([[a], starts])
        elif prev and not isn[0]:
            ends = np.concatenate([[a], ends])
        starts_l.append(starts)
        ends_l.append(ends)
        prev = bool(isn[-1])
    starts = np.concatenate(starts_l) if starts_l else np.zeros(0, np.int64)
    ends = np.concatenate(ends_l) if ends_l else np.zeros(0, np.int64)
    if prev:
        ends = np.concatenate([ends, [len(bases)]])
    out = np.empty(2 * len(starts), np.uint32)
    out[0::2] = starts
    out[1::2] = ends
    return out


def unpack2(packed: jnp.ndarray) -> jnp.ndarray:
    """(..., nb) packed bytes -> (..., 4*nb) uint8 codes 0..3."""
    sh = jnp.arange(4, dtype=jnp.uint8) * 2
    c = (packed[..., None] >> sh) & jnp.uint8(3)
    return c.reshape(*packed.shape[:-1], packed.shape[-1] * 4)


def apply_n(codes: jnp.ndarray, pos_u32: jnp.ndarray,
            bounds: jnp.ndarray) -> jnp.ndarray:
    """codes with positions inside an N run replaced by 4.  ``bounds`` is
    the n_boundaries array (uint32, even length, ascending)."""
    if bounds.shape[0] == 0:
        return codes
    r = jnp.searchsorted(bounds, pos_u32, side="right")
    return jnp.where((r & 1) == 1, jnp.uint8(4), codes)


# device_packed pads the packed buffer with this many zero bytes so row
# gathers never clamp (a row's byte span is at most the batch row length
# past the last real byte); zero bytes decode to code 0, reachable only
# at positions >= the genome length, which every consumer masks.
GATHER_PAD_BYTES = 1 << 13


def gather_codes5(packed, bounds, idx_u32):
    """codes5[idx] gathered straight from the resident packed genome:
    byte gather + bit extract + N-parity overwrite — the
    no-materialization form of ``codes5_from_packed`` for ref-tile
    gathers.  At 3.2 Gbp the decoded byte buffer is 3.2 GB of HBM next
    to a 7.5 GB seed table; gathering from the 0.8 GB packed copy keeps
    the steady set ~8.4 GB (BIGREF r05's first-batch ResourceExhausted).

    Positions past the packed data clip to the last byte; the caller's
    bounds list must cover everything past the genome with an N run
    (align.Aligner._ref_codes_dev appends [size, 0xFFFFFFFF]), so every
    out-of-range or uint32-wrapped index reads 4 — the same fill the
    chunk-padded byte layout returned.  Byte index fits int32 for any
    uint32 address space (2^32 bases = 2^30 bytes)."""
    if idx_u32.dtype != jnp.uint32:
        idx_u32 = idx_u32.astype(jnp.uint32)
    b = jnp.minimum((idx_u32 >> 2).astype(jnp.int32), packed.shape[0] - 1)
    byte = jnp.take(packed, b)
    code = (byte >> ((idx_u32 & 3).astype(jnp.uint8) << 1)) & jnp.uint8(3)
    return apply_n(code, idx_u32, bounds)


@functools.partial(jax.jit, static_argnames=("CL",))
def gather_rows(packed, gstart_u32, CL: int):
    """Gather (R, CL) uint8 2-bit code rows starting at BYTE-ALIGNED
    global positions (gstart % 4 == 0, the streaming index builds' row
    batches — no per-batch genome re-upload).  ``packed`` must carry the
    GATHER_PAD_BYTES tail (device_packed) so no row clamps.

    Rows are CONTIGUOUS byte spans, so each is one vmap'd dynamic_slice —
    a block gather with slice_sizes=(nb,).  The jnp.take-per-byte
    formulation needed a 33M-element realignment take_along_axis on top;
    aligned block slices remove both."""
    nb = -(-CL // 4)
    # the pad tail must exceed any row byte span, or end-of-genome rows
    # silently clamp to shifted data (dynamic_slice clamps, no error);
    # fails loudly here if CHUNK/_row_batch_len ever outgrow the pad
    assert nb <= GATHER_PAD_BYTES, (
        f"row byte span {nb} exceeds GATHER_PAD_BYTES "
        f"{GATHER_PAD_BYTES}; raise the pad in ops/packed.py")
    if gstart_u32.dtype != jnp.uint32:     # int32-staged bit pattern
        gstart_u32 = jax.lax.bitcast_convert_type(gstart_u32, jnp.uint32)
    b0 = (gstart_u32 >> 2).astype(jnp.int32)
    rows_b = jax.vmap(
        lambda s: jax.lax.dynamic_slice(packed, (s,), (nb,)))(b0)
    return unpack2(rows_b)[:, :CL]


def _codes5_piece_inner(packed, bounds, base, L: int):
    """(L,) uint8 5-letter codes for global positions [base, base+L):
    unpack + N-parity overwrite.  base must be a multiple of 4.  Reads
    past the packed data clip to the last byte (those positions are
    >= the data length and masked by every consumer); pos stays the TRUE
    position so the N-parity overwrite is exact everywhere real."""
    nb = L // 4
    b0 = (base >> jnp.uint32(2)).astype(jnp.int32)
    npk = packed.shape[0]
    bidx = jnp.clip(b0 + jnp.arange(nb, dtype=jnp.int32), 0, npk - 1)
    codes = unpack2(jnp.take(packed, bidx))
    pos = base + jnp.arange(L, dtype=jnp.uint32)
    return apply_n(codes, pos, bounds)


_codes5_piece = jax.jit(_codes5_piece_inner, static_argnames=("L",))


@functools.partial(jax.jit, static_argnames=("L", "piece"))
def _codes5_region(packed, bounds, base, L: int, piece: int):
    """(L,) uint8 5-letter codes for global positions [base, base+L) in
    ONE program: lax.map over L/piece sub-pieces bounds the decode
    transients to one piece (~6x piece bytes) without a donated-paste
    loop, whose every paste may copy the whole destination when donation
    is not honoured."""
    nseg = L // piece

    def seg(i):
        return _codes5_piece_inner(packed, bounds,
                                   base + i * jnp.uint32(piece), piece)

    if nseg == 1:
        return seg(jnp.uint32(0))
    return jax.lax.map(seg, jnp.arange(nseg, dtype=jnp.uint32)).reshape(L)


def codes5_from_packed(packed_dev, bounds_dev, total_len: int,
                       piece: int = 1 << 26):
    """Materialize the (total_len,) uint8 5-letter code buffer on device
    from the resident packed genome — replaces the encode5 host upload for
    the filter/extension gathers.  Returns the chunk_ref_codes layout:
    1-D below 2^31 elements, else (n_chunks, 2^30) chunked.

    Positions past the packed data (the chunk padding tail) read clipped
    bytes but every such position is >= total_len and only reachable
    through masked padding lanes (ops/dispatch._gather_seq)."""
    from darwin_tpu.ops.dispatch import CHUNK_ELEMS
    assert piece % 4 == 0

    if total_len <= (1 << 31) - (1 << 20):
        # quantize to 1 MB so the region length — a static jit arg —
        # comes from a bounded set across read batches of any size
        q = 1 << 20
        n1 = -(-total_len // q) * q
        p = min(piece, 1 << (n1.bit_length() - 1))
        while n1 % p:
            p >>= 1
        out = _codes5_region(packed_dev, bounds_dev, jnp.uint32(0), n1, p)
        return out[:total_len] if n1 != total_len else out
    n_chunks = -(-total_len // CHUNK_ELEMS)
    return _codes5_chunked(packed_dev, bounds_dev, n_chunks=n_chunks,
                           chunk=CHUNK_ELEMS, piece=piece)


@functools.partial(jax.jit, static_argnames=("n_chunks", "chunk", "piece"))
def _codes5_chunked(packed, bounds, *, n_chunks: int, chunk: int,
                    piece: int):
    """(n_chunks, chunk) chunked decode in ONE program: the output is
    allocated once and filled chunk-row by chunk-row (nested lax.map), so
    peak HBM is output + one piece's transients — a per-chunk stack or
    paste would double-hold the 3.2 GB buffer next to the csr table and
    OOM the chip."""
    nseg = chunk // piece

    def chunk_body(c):
        def seg(i):
            base = c * jnp.uint32(chunk) + i * jnp.uint32(piece)
            return _codes5_piece_inner(packed, bounds, base, piece)
        return jax.lax.map(seg, jnp.arange(nseg, dtype=jnp.uint32)
                           ).reshape(chunk)

    return jax.lax.map(chunk_body, jnp.arange(n_chunks, dtype=jnp.uint32))


def pad_bounds(bounds: np.ndarray, m: int) -> np.ndarray:
    """Pad a boundary list to length m with 0xFFFFFFFF pairs.  Appended
    pairs are parity-neutral for every reachable position (they add 0 or 2
    boundaries <= p), so apply_n is unchanged — padding exists purely to
    keep the jit shape stable across read batches."""
    assert m >= bounds.shape[0] and m % 2 == 0
    out = np.full(m, 0xFFFFFFFF, np.uint32)
    out[:bounds.shape[0]] = bounds
    return out


# ---------------------------------------------------------------------------
# per-store device handle
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, donate_argnums=(0,))
def _paste_piece(buf, piece, off):
    return jax.lax.dynamic_update_slice(buf, piece, (off,))


def device_packed_streaming(store, piece_bytes: int = 64 << 20):
    """Piece-streamed variant of device_packed for the 3-stage index
    build overlap: returns ``ensure(need_byte)`` — a
    callable the streaming builds use as their packed_dev provider.

    ``ensure(b)`` guarantees packed bytes [0, b) are resident on device
    and returns the current device buffer handle.  Each piece is packed
    on the host (encode2 + pack2 of a bases slice — never the full-genome
    codes2 temporary), device_put WITHOUT a sync, and pasted into the
    full buffer by a donated dynamic_update_slice, so piece k's
    host->device transfer and the caller's device passes over pieces < k
    run while the host packs piece k+1.  ``ensure(None)`` completes the
    upload and memoizes (packed_dev, bounds_dev) on the store exactly like
    device_packed (same buffer bytes: tests/test_packed_build.py).
    """
    cached = getattr(store, "_packed_dev", None)
    if cached is not None:
        return lambda need=None: cached[0]
    import time
    nbytes = -(-store.size // 4)
    assert store.size % 4 == 0, "WORD_SIZE padding keeps stores 4-aligned"
    t0 = time.perf_counter()
    bounds_dev = jnp.asarray(n_boundaries(store.bases))
    stats = {"bounds_host_s": round(time.perf_counter() - t0, 2),
             "pack_host_s": 0.0, "upload_enqueue_s": 0.0,
             "n_pieces": 0, "streamed": True}
    store._packed_stats = stats
    state = {"buf": jnp.zeros(nbytes + GATHER_PAD_BYTES, jnp.uint8),
             "done": 0}
    bases = store.bases

    def ensure(need_byte=None):
        need = nbytes if need_byte is None else min(need_byte, nbytes)
        while state["done"] < need:
            off = state["done"]
            pb = min(piece_bytes, nbytes - off)
            t0 = time.perf_counter()
            from darwin_tpu.genome import encode2
            piece = pack2(encode2(bases[4 * off:4 * (off + pb)]))
            t1 = time.perf_counter()
            stats["pack_host_s"] = round(
                stats["pack_host_s"] + t1 - t0, 2)
            piece_dev = jnp.asarray(piece)        # async transfer
            state["buf"] = _paste_piece(state["buf"], piece_dev,
                                        jnp.int32(off))
            stats["upload_enqueue_s"] = round(
                stats["upload_enqueue_s"] + time.perf_counter() - t1, 2)
            stats["n_pieces"] += 1
            state["done"] = off + pb
        if state["done"] >= nbytes and store._packed_dev is None:
            store._packed_dev = (state["buf"], bounds_dev)
        return state["buf"]

    return ensure


def device_packed(store):
    """One-time device upload of a GenomeStore's packed 2-bit codes +
    non-ACGT run boundaries, memoized on the store.  Returns
    (packed_dev, bounds_dev).  The packed buffer carries a
    GATHER_PAD_BYTES zero tail so gather_rows block slices never clamp.

    Implemented over the piece-streamed provider: host pack overlaps the
    host->device transfer piece by piece, and the full-genome codes2 temporary
    (3.2 GB at bigref scale) never materializes."""
    cached = getattr(store, "_packed_dev", None)
    if cached is not None:
        return cached
    import time
    t0 = time.perf_counter()
    device_packed_streaming(store)(None)
    store._packed_stats["upload_wall_s"] = round(
        time.perf_counter() - t0, 2)
    return store._packed_dev
