"""Batched GACT tile alignment on device (JAX/XLA).

Semantics match ``darwin_tpu.ops.oracle.clean_align`` /
``align_with_traceback`` — the specification distilled from the reference's
DualAlignSIMD kernel (software/Processor.cpp:164-566); see oracle.py for the
recurrences and tie-break rules.

This is the plain XLA implementation: the CPU path, the reference the CUDA
kernels (ops/gact_cuda.py) are checked against, and the GPU path for the
shapes and scorings those kernels do not cover.  Design (vs. the
reference's per-tile function calls batched two at a time,
software/params.cfg:39):

* Tiles are batched *hundreds per dispatch*; the batch is the leading axis
  of every array and the natural sharding axis.
* The DP runs as one ``lax.scan`` over reference columns.  The within-column
  short/long-gap coupling (F, F_L, H) is a max-plus *affine* recurrence with
  a constant 2x2 matrix: a prefix max in the usual open <= extend domain
  (``_column_gaps_prefix``), ``lax.associative_scan`` otherwise — log-depth,
  fully vectorized over (batch, query) instead of the reference's lazy-F
  iteration (Processor.cpp:382-497).
* Per-cell 8-bit trace words (derived from the 13-bit layout of
  Processor.h:17-34) are written to device memory; traceback runs as a
  second, batch-vectorized ``lax.scan`` that chases pointers for all tiles
  in parallel (the reference walks one tile at a time on the host,
  Processor.cpp:585-716).

All tiles in a dispatch share a static (QT, RT) shape; per-tile actual sizes
are dynamic and masked.  Padded cells never feed valid cells (DP flows
forward in q and r), so only max-tracking needs masking.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from darwin_tpu.ops import oracle as orc

NEG = np.int32(-(1 << 28))

# Compact 8-bit trace word (device layout; the reference's 13-bit one-hot
# layout, Processor.h:17-34, is kept in the oracle for documentation and
# converted in tests).  Bits 0-2: exclusive T field; bits 3-6: gap-source
# "open" flags (set = the gap opened here -> traceback returns to DIAG).
T8_ZERO = 0
T8_DEL = 1
T8_INS = 2
T8_DEL_L = 3
T8_INS_L = 4
T8_DIAG = 5
E_OPEN8 = 8      # E_DIAG_DEL
F_OPEN8 = 16     # F_DIAG_INS
EL_OPEN8 = 32    # EL_DIAG_DEL
FL_OPEN8 = 64    # FL_DIAG_INS


def pack_trace_word(word13: np.ndarray) -> np.ndarray:
    """Convert reference-layout 13-bit trace words to the 8-bit device
    layout (for oracle comparisons in tests)."""
    w = np.asarray(word13, np.int32)
    tf = w & 31
    t8 = np.zeros_like(w)
    t8 = np.where(tf == orc.T_DEL, T8_DEL, t8)
    t8 = np.where(tf == orc.T_INS, T8_INS, t8)
    t8 = np.where(tf == orc.T_DEL_L, T8_DEL_L, t8)
    t8 = np.where(tf == orc.T_INS_L, T8_INS_L, t8)
    t8 = np.where(tf == orc.T_DIAG, T8_DIAG, t8)
    t8 |= np.where(w & orc.E_DIAG_DEL, E_OPEN8, 0)
    t8 |= np.where(w & orc.F_DIAG_INS, F_OPEN8, 0)
    t8 |= np.where(w & orc.EL_DIAG_DEL, EL_OPEN8, 0)
    t8 |= np.where(w & orc.FL_DIAG_INS, FL_OPEN8, 0)
    return t8.astype(np.uint8)


class GactParams(NamedTuple):
    sub: jax.Array          # (5,5) int32
    gap_open: jax.Array     # scalar int32
    gap_extend: jax.Array
    long_gap_open: jax.Array
    long_gap_extend: jax.Array


# prefix_ok/window results memoized by params identity: the fields are
# tiny device arrays, so int() is a blocking device fetch that must not
# run per dispatch.  The
# keep-list pins the params objects so ids stay unique; it is bounded —
# past _PARAMS_CACHE_MAX distinct params objects both structures reset
# (ids may then be reused, but only after the cache referencing them is
# gone), so a long-lived process creating many Aligners cannot grow them
# without bound.
_PARAMS_CACHE: dict = {}
_PARAMS_KEEP: list = []
_PARAMS_CACHE_MAX = 256


def _params_memo_put(key, value, params):
    if len(_PARAMS_KEEP) >= _PARAMS_CACHE_MAX:
        _PARAMS_CACHE.clear()
        _PARAMS_KEEP.clear()
    _PARAMS_CACHE[key] = value
    _PARAMS_KEEP.append(params)


def prefix_ok(params) -> bool:
    """Whether the scoring admits the prefix-max gap scan (opening never
    cheaper than extending, both lanes).  Scorings outside this domain
    (the reference accepts any, software/Processor.cpp:48-80) route
    through the generic max-plus scan.  Raises on traced params — a jit
    caller must resolve this from concrete values before tracing (see
    static_params) and pass an explicit
    ``prefix_gaps`` bool; silently guessing here would pick the wrong DP
    for generic scorings."""
    key = ("prefix_ok", id(params))
    if key in _PARAMS_CACHE:
        return _PARAMS_CACHE[key]
    if isinstance(params.gap_open, jax.core.Tracer):
        raise TypeError(
            "prefix_ok(params) needs concrete scoring values; resolve it "
            "outside the jit trace and pass prefix_gaps explicitly")
    ok = (int(params.gap_open) <= int(params.gap_extend)
          and int(params.long_gap_open) <= int(params.long_gap_extend))
    _params_memo_put(key, ok, params)
    return ok


def make_params(cfg) -> GactParams:
    return GactParams(
        sub=jnp.asarray(cfg.sub_matrix_5x5, jnp.int32),
        gap_open=jnp.int32(cfg.gap_open),
        gap_extend=jnp.int32(cfg.gap_extend),
        long_gap_open=jnp.int32(cfg.long_gap_open),
        long_gap_extend=jnp.int32(cfg.long_gap_extend),
    )


def _maxplus_combine(a, b):
    """Compose max-plus affine elements: b after a.

    Element = (m00, m01, m10, m11, c0, c1) for v -> M (x) v (+) c.
    """
    a00, a01, a10, a11, ac0, ac1 = a
    b00, b01, b10, b11, bc0, bc1 = b
    m00 = jnp.maximum(b00 + a00, b01 + a10)
    m01 = jnp.maximum(b00 + a01, b01 + a11)
    m10 = jnp.maximum(b10 + a00, b11 + a10)
    m11 = jnp.maximum(b10 + a01, b11 + a11)
    c0 = jnp.maximum(jnp.maximum(b00 + ac0, b01 + ac1), bc0)
    c1 = jnp.maximum(jnp.maximum(b10 + ac0, b11 + ac1), bc1)
    return (m00, m01, m10, m11, c0, c1)


def _column_gap_scan(hp, go, ge, goL, geL):
    """Solve the within-column coupled recurrence for (F, F_L) given
    Hp = max(dag, E, E_L):

        F(q)   = max(H(q-1)+go,  F(q-1)+ge)
        F_L(q) = max(H(q-1)+goL, F_L(q-1)+geL)
        H(q)   = max(Hp(q), F(q), F_L(q))

    Substituting H(q-1) yields  v(q) = A (x) v(q-1) (+) b(q)  with
        A = [[max(go,ge), go], [goL, max(goL,geL)]]
        b(q) = (HpShift(q)+go, HpShift(q)+goL),  HpShift(q) = Hp(q-1), Hp(-1)=0.

    hp: (B, Q) int32.  Returns (F, F_L) each (B, Q).

    Generic fallback (any scoring): max-plus affine associative scan.
    """
    B, Q = hp.shape
    hps = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), hp[:, :-1]], axis=1)
    a00 = jnp.full((B, Q), jnp.maximum(go, ge), jnp.int32)
    a01 = jnp.full((B, Q), go, jnp.int32)
    a10 = jnp.full((B, Q), goL, jnp.int32)
    a11 = jnp.full((B, Q), jnp.maximum(goL, geL), jnp.int32)
    c0 = hps + go
    c1 = hps + goL
    res = jax.lax.associative_scan(
        _maxplus_combine, (a00, a01, a10, a11, c0, c1), axis=1)
    return res[4], res[5]


def _windowed_max(a, w, axis):
    """Inclusive trailing-window max over the last w (a power of two)
    elements along `axis` via log-shift steps; w >= length = full prefix
    max.  Works on jnp and np arrays alike."""
    n = a.shape[axis]
    xp = jnp if isinstance(a, jax.Array) else np
    neg = a.dtype.type(-(1 << 28)) if hasattr(a.dtype, "type") else -(1 << 28)
    s = 1
    while s < min(w, n):
        pad_shape = list(a.shape)
        pad_shape[axis] = s
        pad = xp.full(pad_shape, neg, a.dtype)
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(0, n - s)
        a = xp.maximum(a, xp.concatenate([pad, a[tuple(sl)]], axis=axis))
        s *= 2
    return a


def _column_gaps_prefix(hp, go, ge, goL, geL, wf=None, wfl=None):
    """Fast path for the within-column gap recurrence, valid whenever
    gap_open <= gap_extend and long_gap_open <= long_gap_extend (i.e.
    opening is never cheaper than extending — any sane scoring).

    Under that condition a gap opened from a *gap-derived* H value is
    dominated by (or ties) a single gap opened from the corresponding
    non-gap H earlier (two opens can't beat one; a mixed long/short run
    can't beat the better pure run).  Hence

        F(q)   = go  + ge *(q-1) + max_{j=-1..q-1}(Hb(j) - ge*j)
        F_L(q) = goL + geL*(q-1) + max_{j=-1..q-1}(Hb(j) - geL*j)

    with Hb(j) = Hp(j) = max(dag, E, E_L)(j) and Hb(-1) = 0 — two plain
    prefix maxima instead of a 6-word max-plus scan.  Values (not just the
    argmax) are exactly equal to the coupled recurrence, so trace bits are
    unaffected.  The dominated lane's prefix max is windowed per
    gap_scan_windows (wf/wfl default to the full length).
    """
    B, Q = hp.shape
    if wf is None or wfl is None:
        wf, wfl = orc.gap_scan_windows(go, ge, goL, geL, Q)
    q_idx = jnp.arange(Q, dtype=jnp.int32)[None, :]

    def one(open_, ext, w):
        # a[t] for t in [0, Q) corresponds to j = t - 1
        a = jnp.concatenate(
            [jnp.full((B, 1), ext, jnp.int32),           # j = -1: 0 - ext*(-1)
             hp[:, :Q - 1] - ext * q_idx[:, :Q - 1]], axis=1)
        m = _windowed_max(a, w, axis=1)
        return open_ + ext * (q_idx - 1) + m

    return one(go, ge, wf), one(goL, geL, wfl)


def _shift_q(x, fill):
    """x[..., q] <- x[..., q-1], x[..., 0] <- fill."""
    pad = jnp.full(x.shape[:-1] + (1,), fill, x.dtype)
    return jnp.concatenate([pad, x[..., :-1]], axis=-1)


def batch_align(qcodes, rcodes, qlens, rlens, start_end, params,
                with_trace=True, prefix_gaps=None, all_start_end=False):
    """Align a batch of tiles.

    qcodes: (B, QT) uint8 5-letter codes; rcodes: (B, RT).
    qlens/rlens: (B,) int32 actual sizes (1..QT / 1..RT).
    start_end: (B,) bool — align_fields bit 0 (score at the end cell) vs
    max-cell mode.
    prefix_gaps: None = auto-detect from concrete params (raises under a
    jit trace); an explicit bool is trusted (jit callers resolve it via
    prefix_ok before tracing).

    Returns dict with score, query_max_pos, ref_max_pos (all (B,) int32) and,
    if with_trace, trace of shape (RT, B, QT) uint8 (trace[r, b, q], 8-bit
    layout above).
    """
    QT = qcodes.shape[1]
    if prefix_gaps is None:
        # scorings with opening cheaper than extending invalidate the
        # prefix-max formulation — auto-route to the generic max-plus scan
        prefix_gaps = prefix_ok(params)
    key = ("windows", id(params), QT)
    if key in _PARAMS_CACHE:
        wins = _PARAMS_CACHE[key]
    else:
        try:
            wins = orc.gap_scan_windows(
                params.gap_open, params.gap_extend, params.long_gap_open,
                params.long_gap_extend, QT)
            _params_memo_put(key, wins, params)
        except Exception:
            # params are tracers (called under an outer jit): full scans.
            # Walked results are window-invariant, so mixing is harmless.
            wins = (QT, QT)
    return _batch_align(qcodes, rcodes, qlens, rlens, start_end, params,
                        with_trace, prefix_gaps, all_start_end, wins)


@functools.partial(jax.jit, static_argnames=("with_trace", "prefix_gaps",
                                              "all_start_end",
                                              "gap_windows"))
def _batch_align(qcodes, rcodes, qlens, rlens, start_end, params,
                 with_trace=True, prefix_gaps=True, all_start_end=False,
                 gap_windows=None):
    B, QT = qcodes.shape
    RT = rcodes.shape[1]
    sub = params.sub
    go, ge = params.gap_open, params.gap_extend
    goL, geL = params.long_gap_open, params.long_gap_extend

    q_idx = jnp.arange(QT, dtype=jnp.int32)[None, :]           # (1, QT)
    valid_q = q_idx < qlens[:, None]                           # (B, QT)
    qc = qcodes.astype(jnp.int32)
    # Farrar-style query profile: prof5[c] = sub[q, c] per query position
    # (CreateVProfile, Processor.cpp:87-115).  Per column the profile row is
    # selected by compare+select over the 5 codes — no gathers in the loop.
    prof5 = jnp.stack([jnp.take(sub[:, c], qc) for c in range(5)])  # (5,B,QT)
    q_end_mask = (q_idx == (qlens - 1)[:, None])               # (B, QT)

    def step(carry, r):
        (h_prev, e, e_l, pending_ebits, best, best_q, best_r, h_end) = carry

        rchar = jax.lax.dynamic_index_in_dim(
            rcodes, r, axis=1, keepdims=False).astype(jnp.int32)  # (B,)
        prof = prof5[0]
        for c in range(1, 5):
            prof = jnp.where((rchar == c)[:, None], prof5[c], prof)

        dag = jnp.maximum(_shift_q(h_prev, 0) + prof, 0)
        hp = jnp.maximum(jnp.maximum(dag, e), e_l)
        if prefix_gaps:
            wf, wfl = gap_windows if gap_windows is not None else (QT, QT)
            f, f_l = _column_gaps_prefix(hp, go, ge, goL, geL, wf, wfl)
        else:
            f, f_l = _column_gap_scan(hp, go, ge, goL, geL)
        h = jnp.maximum(hp, jnp.maximum(f, f_l))

        # ---- trace word (see oracle.clean_align; 8-bit device layout) ----
        is_d = h == dag
        is_f = h == f
        is_fl = h == f_l
        is_el = h == e_l
        t = jnp.full((B, QT), T8_DEL, jnp.int32)
        t = jnp.where(is_d, jnp.where(h == 0, T8_ZERO, T8_DIAG), t)
        t = jnp.where(is_fl, T8_INS_L, t)
        t = jnp.where(is_el, T8_DEL_L, t)
        t = jnp.where(~is_d & ~is_f & is_fl, T8_INS_L, t)
        t = jnp.where(~is_d & is_f, T8_INS, t)

        h_up = _shift_q(h, 0)
        f_up = _shift_q(f, NEG)
        fl_up = _shift_q(f_l, NEG)
        fbits = jnp.where(h_up + go > f_up + ge, F_OPEN8, 0)
        flbits = jnp.where(h_up + goL > fl_up + geL, FL_OPEN8, 0)
        word = (t + fbits + flbits + pending_ebits).astype(jnp.uint8)

        next_ebits = (jnp.where(h + go > e + ge, E_OPEN8, 0)
                      + jnp.where(h + goL > e_l + geL, EL_OPEN8, 0))

        e_new = jnp.maximum(h + go, e + ge)
        e_l_new = jnp.maximum(h + goL, e_l + geL)

        # ---- max tracking (earliest column with the strict global max,
        # then smallest q in that column; Processor.cpp:502-541) ----
        # Skipped when the whole dispatch is start_end (extend tiles), which
        # only reads the end cell.
        if not all_start_end:
            r_valid = r < rlens
            hm = jnp.where(valid_q & r_valid[:, None], h, -1)
            colmax = jnp.max(hm, axis=1)
            improved = colmax > best
            colargq = jnp.argmax(hm == colmax[:, None],
                                 axis=1).astype(jnp.int32)
            best = jnp.where(improved, colmax, best)
            best_q = jnp.where(improved, colargq, best_q)
            best_r = jnp.where(improved, r, best_r)

        # ---- start_end capture: H(qlen-1, rlen-1) ----
        at_end = r == (rlens - 1)
        h_at_qend = jnp.sum(jnp.where(q_end_mask, h, 0), axis=1)
        h_end = jnp.where(at_end, h_at_qend, h_end)

        carry = (h, e_new, e_l_new, next_ebits, best, best_q, best_r, h_end)
        return carry, (word if with_trace else None)

    init_ebits = jnp.full((B, QT), E_OPEN8 + EL_OPEN8, jnp.int32)
    carry0 = (
        jnp.zeros((B, QT), jnp.int32),            # H_prev
        jnp.full((B, QT), go, jnp.int32),         # E at column 0
        jnp.full((B, QT), goL, jnp.int32),        # E_L at column 0
        init_ebits,
        jnp.zeros((B,), jnp.int32),               # best score
        jnp.zeros((B,), jnp.int32),               # best q
        jnp.zeros((B,), jnp.int32),               # best r
        jnp.zeros((B,), jnp.int32),               # H at end cell
    )
    carry, trace = jax.lax.scan(step, carry0,
                                jnp.arange(RT, dtype=jnp.int32))
    (_, _, _, _, best, best_q, best_r, h_end) = carry

    score = jnp.where(start_end, h_end, best)
    q_pos = jnp.where(start_end, qlens - 1, best_q)
    r_pos = jnp.where(start_end, rlens - 1, best_r)
    out = {"score": score, "query_max_pos": q_pos, "ref_max_pos": r_pos}
    if with_trace:
        out["trace"] = trace  # (RT, B, QT) uint8
    return out


# Traceback walker states.  The gap states reuse the T-field codes so a
# DIAG-state dispatch can transition by arithmetic.
_ST_DIAG = T8_DIAG   # 5
_ST_DEL = T8_DEL     # 1
_ST_INS = T8_INS     # 2
_ST_DEL_L = T8_DEL_L # 3
_ST_INS_L = T8_INS_L # 4
_ST_DONE = 0


def _tb_transition(w, i, j, qs, rs, st):
    """One traceback transition given the fetched trace word w (int-like);
    shared between the row- and column-layout walkers."""
    w = w.astype(jnp.int32)
    tf = w & 7
    eff = jnp.where(st == _ST_DIAG, tf, st)
    is_m = eff == T8_DIAG
    is_d = (eff == T8_DEL) | (eff == T8_DEL_L)
    is_i = (eff == T8_INS) | (eff == T8_INS_L)
    op = jnp.where(is_m, orc.OP_M,
                   jnp.where(is_d, orc.OP_D,
                             jnp.where(is_i, orc.OP_I, orc.OP_NONE)))
    di = jnp.where(is_m | is_i, 1, 0)
    dj = jnp.where(is_m | is_d, 1, 0)
    qs = qs + di
    rs = rs + dj
    i = i - di
    j = j - dj
    open_bit = jnp.where(eff == T8_DEL, w & E_OPEN8,
                jnp.where(eff == T8_INS, w & F_OPEN8,
                 jnp.where(eff == T8_DEL_L, w & EL_OPEN8,
                  jnp.where(eff == T8_INS_L, w & FL_OPEN8, 1))))
    nst = jnp.where(is_m, _ST_DIAG,
                    jnp.where(open_bit != 0, _ST_DIAG, eff))
    nst = jnp.where(eff == _ST_DONE, _ST_DONE, nst)
    return (i, j, qs, rs, nst), op.astype(jnp.uint8)


def _walk(trace, start_q, start_r, max_tb_steps):
    """Batched traceback over (RT, B, QT) 8-bit trace words.

    Walks DualAlignSIMDTraceback's state machine (Processor.cpp:585-716) for
    all tiles in lock-step, with the reference's no-op state-switch
    iterations fused away (a DIAG-state visit to a gap-typed cell both
    switches state AND emits, reading the same cell — provably identical
    because the reference re-reads the unchanged (i,j) on its next
    iteration).  Every active iteration therefore emits exactly one op, so a
    fixed-length ``lax.scan`` of min(QT+RT, 2*max_tb_steps) steps suffices
    and ops land in a contiguous prefix per lane (no scatter).

    Returns (ops (B, L) uint8, cols (B, L) int32 — the reference column each
    op was emitted in — q_steps, r_steps).
    """
    RT, B, QT = trace.shape
    lane = jnp.arange(B, dtype=jnp.int32)
    L = min(QT + RT, 2 * max_tb_steps)

    def step(state, _):
        i, j, qs, rs, st = state

        # steps cap + bounds, checked at loop top (Processor.cpp:613-618)
        capped = (qs == max_tb_steps) | (rs == max_tb_steps)
        oob = (i < 0) | (j < 0)
        st = jnp.where(capped | oob, _ST_DONE, st)

        # one step per scan iteration: unrolled steps let XLA fuse each
        # gather into its successors', recomputing the whole chain
        w = trace.at[jnp.clip(j, 0, RT - 1), lane,
                     jnp.clip(i, 0, QT - 1)].get(mode="promise_in_bounds")
        state, op = _tb_transition(w, i, j, qs, rs, st)
        return state, (op, j)

    zeros = jnp.zeros((B,), jnp.int32)
    state0 = (start_q.astype(jnp.int32), start_r.astype(jnp.int32),
              zeros, zeros, jnp.full((B,), _ST_DIAG, jnp.int32))
    (i, j, qs, rs, st), (ops, cols) = jax.lax.scan(step, state0, None,
                                                   length=L)
    # (L, B) -> (B, L); contiguous prefix per lane
    return ops.T, cols.T, qs, rs


@functools.partial(jax.jit, static_argnames=("max_tb_steps",))
def batch_traceback(trace, start_q, start_r, max_tb_steps):
    """Serial traceback walker (see _walk).

    Returns:
      ops      : (B, L) uint8, op codes in traceback order (orc.OP_M/I/D)
      n_ops    : (B,) int32 total ops (total_TB_pointers)
      q_steps  : (B,) int32 query bases consumed (query_offset)
      r_steps  : (B,) int32 ref bases consumed (ref_offset)
    """
    ops, _, qs, rs = _walk(trace, start_q, start_r, max_tb_steps)
    n = jnp.sum((ops != orc.OP_NONE).astype(jnp.int32), axis=1)
    return {"ops": ops, "n_ops": n, "q_steps": qs, "r_steps": rs}


def traceback_records(trace, start_q, start_r, max_tb_steps):
    """The serial walk folded into per-column traceback records on the
    device: (RT, B) int32 with bits 0..13 the number of I ops emitted in
    the column and bits 14..15 the op that left it (OP_M / OP_D, 0 where
    the walk ended or never came).  A column holds at most one closing op
    (M and D move to the next column), so the records are exact for any
    trace (ops/records.py expands them back to the walker's op stream).
    Returns (rec, q_steps, r_steps)."""
    RT, B, _ = trace.shape
    ops, cols, qs, rs = _walk(trace, start_q, start_r, max_tb_steps)
    ops = ops.astype(jnp.int32)
    val = jnp.where(ops == orc.OP_I, 1,
                    jnp.where(ops == orc.OP_NONE, 0, ops << 14))
    cols = jnp.where(ops == orc.OP_NONE, RT, cols)    # dropped below
    lane = jax.lax.broadcasted_iota(jnp.int32, ops.shape, 0)
    rec = jnp.zeros((RT, B), jnp.int32).at[cols, lane].add(val, mode="drop")
    return rec, qs, rs


def align_and_traceback(qcodes, rcodes, qlens, rlens, start_end, params,
                        max_tb_steps, all_start_end=False,
                        prefix_gaps=None):
    """One-dispatch DP + traceback; only compact results leave the device.

    Traceback starts at (qlen-1, rlen-1) for start_end tiles and at the max
    cell otherwise (Processor.cpp:593-598).  Callers tracing this under an
    outer jit must resolve prefix_gaps from concrete params themselves
    (gact.prefix_ok) — inside a trace the auto-detection cannot run.
    """
    res = batch_align(qcodes, rcodes, qlens, rlens, start_end, params,
                      with_trace=True, all_start_end=all_start_end,
                      prefix_gaps=prefix_gaps)
    tb = batch_traceback(res["trace"],
                         jnp.where(start_end, qlens - 1, res["query_max_pos"]),
                         jnp.where(start_end, rlens - 1, res["ref_max_pos"]),
                         max_tb_steps)
    return {k: v for k, v in res.items() if k != "trace"} | tb


# ---------------------------------------------------------------------------
# Tile implementation for the fused dispatch rounds (ops/dispatch.py)
# ---------------------------------------------------------------------------
#
# A tile implementation is a module with ``filter_scores`` and
# ``extend_records`` of the signatures below; the round programs take it as
# a static argument.  This one is plain XLA (the CPU path, and the side the
# GPU kernel of ops/gact_cuda.py is measured against).  Scoring arrives as
# static Python ints (``static_params``), so the prefix/generic gap-scan
# choice and the scan windows are fixed at trace time.

def static_params(params: GactParams):
    """Scoring as hashable Python ints: (sub 5x5 tuple, go, ge, goL, geL).
    Memoized by params identity (reading the fields is a device fetch)."""
    key = ("static", id(params))
    if key not in _PARAMS_CACHE:
        sub = tuple(tuple(int(v) for v in row)
                    for row in np.asarray(params.sub))
        _params_memo_put(key, (sub, int(params.gap_open),
                               int(params.gap_extend),
                               int(params.long_gap_open),
                               int(params.long_gap_extend)), params)
    return _PARAMS_CACHE[key]


def _dp_static(qtile, rtile, qlens, rlens, start_end, ps, with_trace,
               all_start_end):
    sub, go, ge, goL, geL = ps
    params = GactParams(jnp.asarray(sub, jnp.int32), jnp.int32(go),
                        jnp.int32(ge), jnp.int32(goL), jnp.int32(geL))
    prefix = go <= ge and goL <= geL
    wins = (orc.gap_scan_windows(go, ge, goL, geL, qtile.shape[1])
            if prefix else None)
    return _batch_align(qtile, rtile, qlens, rlens, start_end, params,
                        with_trace, prefix, all_start_end, wins)


def filter_scores(qtile, rtile, qlens, rlens, ps):
    """Max-cell DP without trace (the filter stage's first tiles).
    Returns (score, query_max_pos, ref_max_pos), each (B,) int32."""
    res = _dp_static(qtile, rtile, qlens, rlens,
                     jnp.zeros(qlens.shape, bool), ps, False, False)
    return res["score"], res["query_max_pos"], res["ref_max_pos"]


def extend_records(qtile, rtile, qlens, rlens, ps, max_tb):
    """End-cell DP + traceback of extension tiles.  Returns (score, rec
    (RT, B) int32 traceback records, q_steps, r_steps)."""
    res = _dp_static(qtile, rtile, qlens, rlens,
                     jnp.ones(qlens.shape, bool), ps, True, True)
    rec, qs, rs = traceback_records(res["trace"], qlens - 1, rlens - 1,
                                    max_tb)
    return res["score"], rec, qs, rs
