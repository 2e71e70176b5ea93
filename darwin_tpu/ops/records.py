"""Per-column traceback records: device-side packing and host-side
expansion.

A fused extension round (ops/dispatch.py) returns one record per (column,
tile) instead of the walker's op stream:

    bits 0..13  nI       number of I ops emitted in this column
    bits 14..15 closing  0 = walk ended here (or never visited),
                         OP_M / OP_D otherwise

(14+2 bits, so a record survives the int16 device->host transfer).  The
host expands them (vectorized np.repeat) into the exact op sequence of the
serial walker (gact.batch_traceback).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from darwin_tpu.ops import oracle as _orc

orc_OP_I = int(_orc.OP_I)


def compact_records(rec, bits: int = 8):
    """Pack (RT, B) int32 traceback records (14-bit nI | closing << 14)
    16//bits per entry as bits-wide records ((bits-2)-bit nI | closing in
    the top 2 bits), cutting the device->host result bytes of the fused
    dispatch programs 2x (bits=8) or 4x (bits=4; cf. the RTL's 4-bit
    direction words, RTL/GACT/SmithWatermanPE.v:149-201 — 2 bits name the
    op, the rest carry the insert run).  Returns ((ceil(RT/per), B) int32
    holding the record group in bits 0..15, (B,) int32 overflow flags:
    nonzero when any of the lane's insert runs exceeds the nI field — the
    dispatcher reruns those lanes through the wide layout, so the
    compaction is lossless end to end."""
    per = 16 // bits
    nmax = (1 << (bits - 2)) - 1
    nI = rec & 0x3FFF
    cl = (rec >> 14) & 0x3
    ovf = jnp.any(nI > nmax, axis=0).astype(jnp.int32)
    r = jnp.minimum(nI, nmax) | (cl << (bits - 2))
    pad = -r.shape[0] % per
    if pad:
        # padded all-zero records expand to zero ops — harmless
        r = jnp.pad(r, ((0, pad), (0, 0)))
    out = r[0::per]
    for i in range(1, per):
        out = out | (r[i::per] << (bits * i))
    return out, ovf


def expand_records(rec: np.ndarray, n_valid: int, L: int):
    """Expand per-column (nI, closing) records into the serial walker's op
    arrays — vectorized np.repeat, no per-op Python loop.

    rec: (RT, B) int32.  Returns ops (n_valid, L) uint8 + n_ops (n_valid,).
    """
    w = np.asarray(rec)[:, :n_valid].astype(np.int64) & 0xFFFF
    return expand_ops(w & 0x3FFF, (w >> 14) & 0x3, L)


def expand_records_packed(crec: np.ndarray, n_valid: int, L: int,
                           bits: int = 8):
    """expand_records for the compact 16//bits-per-entry layout produced
    by compact_records(bits)."""
    per = 16 // bits
    mask = (1 << bits) - 1
    w = np.asarray(crec)[:, :n_valid].astype(np.int64) & 0xFFFF
    R2, n = w.shape
    r = np.empty((per * R2, n), np.int64)
    for i in range(per):
        r[i::per] = (w >> (bits * i)) & mask
    nmask = (1 << (bits - 2)) - 1
    return expand_ops(r & nmask, (r >> (bits - 2)) & 0x3, L)


def expand_ops(nI: np.ndarray, closing: np.ndarray, L: int):
    """Shared record-expansion core: (RT, n) insert-run lengths + closing
    ops -> (n, L) uint8 op arrays + true op counts."""
    RT, n_valid = nI.shape
    # walk order per lane: columns start_r, start_r-1, ..., 0 -> reorder
    # rows by descending column index.  Columns above start_r and columns
    # after the walk terminated hold all-zero records (the kernel only
    # writes for active lanes), so no extra masking is needed.
    nI_d = nI[::-1]
    cl_d = closing[::-1]

    # token stream per lane: for each visited column, nI I-ops then the
    # closing op (if any).  Build lane-major (B, RT, 2) counts+values.
    cnts = np.empty((n_valid, RT, 2), np.int64)
    vals = np.empty((n_valid, RT, 2), np.uint8)
    cnts[:, :, 0] = nI_d.T
    cnts[:, :, 1] = (cl_d.T != 0)
    vals[:, :, 0] = orc_OP_I
    vals[:, :, 1] = cl_d.T.astype(np.uint8)
    flat_cnt = cnts.reshape(-1)
    flat_val = vals.reshape(-1)
    stream = np.repeat(flat_val, flat_cnt)
    per_lane = cnts.reshape(n_valid, -1).sum(axis=1)
    ops = np.zeros((n_valid, L), np.uint8)
    if stream.size:
        off = np.concatenate(([0], np.cumsum(per_lane)))
        lane_of = np.repeat(np.arange(n_valid), per_lane)
        pos = np.arange(stream.size) - off[lane_of]
        keep = pos < L
        ops[lane_of[keep], pos[keep]] = stream[keep]
    return ops, per_lane.astype(np.int32)
