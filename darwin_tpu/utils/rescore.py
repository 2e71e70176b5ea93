"""Tie-equivalence adjudication for byte-identity harnesses.

The reference SIMD kernel's trace tie-breaks are an artifact of its
16-lane striped register geometry: the lazy gap pass overrides a cell's
T field only on STRICT improvement, so whether an exact score tie between
the diagonal and a gap lane resolves to M or I/D depends on whether the
gap's source crosses one of the kernel's stripe boundaries
(segLen = ceil(query/16); Processor.cpp:308-329 first-pass non-strict
blends vs :424-431 lazy-pass strict blends).  Our kernels use a
column-parallel geometry with a deterministic converged-value tie chain
(ops/oracle.py::clean_align), byte-identical to the reference everywhere
except those stripe-geometry-dependent exact ties — where both paths
score identically (verified here by rescoring under the reference's own
two-piece-affine model).

This module classifies output differences: a SAM line pair that differs
ONLY in CIGAR, with equal coordinates, spans, and alignment scores, is a
*tie-equivalent* divergence; anything else is a hard mismatch.  The e2e
fuzz (tools/fuzz_ref_e2e.py) and artifact spot-checks use this so the
known tie class cannot mask real regressions.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

_CIG = re.compile(r"(\d+)([MIDNSHP=X])")
_NT = {"A": 0, "C": 1, "G": 2, "T": 3}


def gap_cost(length: int, go: int, ge: int, goL: int, geL: int) -> int:
    """Best two-piece affine cost of one gap run, INCLUDING lane switches
    and re-opening at interior gap cells (the DP recurrence reads H at
    every cell, and inside a pure gap run H equals the gap value, so
    E = max(H+go, E+ge) can re-open mid-run — decisive when open costs
    less than extend).  Tiny 2-state DP over the run."""
    s, lg = go, goL
    for _ in range(length - 1):
        best = s if s >= lg else lg
        s, lg = max(s + ge, best + go), max(lg + geL, best + goL)
    return max(s, lg)


def sam_alignment_score(pos0: int, cigar: str, seq: str, ref: str,
                        sub5: np.ndarray, go: int, ge: int, goL: int,
                        geL: int) -> Tuple[int, int, int]:
    """Score a SAM alignment under the reference's scoring model.

    Returns (score, query_consumed, ref_span).  ``ref`` is the full
    chromosome string; ``pos0`` 0-based.
    """
    qi, ri, total = 0, pos0, 0
    for n_s, op in _CIG.findall(cigar):
        n = int(n_s)
        if op in ("M", "=", "X"):
            for _ in range(n):
                a = _NT.get(seq[qi], 4)
                b = _NT.get(ref[ri], 4)
                total += int(sub5[a, b])
                qi += 1
                ri += 1
        elif op == "I":
            total += gap_cost(n, go, ge, goL, geL)
            qi += n
        elif op == "D":
            total += gap_cost(n, go, ge, goL, geL)
            ri += n
        elif op in ("S", "H"):
            if op == "S":
                qi += n
        else:
            raise ValueError(f"unsupported CIGAR op {op}")
    return total, qi, ri - pos0


def _load_fasta(path: str) -> Dict[str, str]:
    seqs: Dict[str, List[str]] = {}
    name = None
    for line in open(path):
        if line.startswith(">"):
            name = line[1:].split()[0]
            seqs[name] = []
        elif name is not None:
            seqs[name].append(line.strip())
    return {k: "".join(v).upper() for k, v in seqs.items()}


def classify_sam(ref_text: str, our_text: str, genome_fasta: str,
                 cfg) -> dict:
    """Line-by-line comparison of two SAM outputs.

    Returns {"hard": [(ref_line, our_line), ...], "tie_equivalent": n,
    "identical": n} — a pair counts as tie-equivalent when every field
    except the CIGAR matches and both CIGARs score identically with the
    same spans under cfg's scoring."""
    genome = _load_fasta(genome_fasta)
    sub5 = np.asarray(cfg.sub_matrix_5x5, np.int64)
    go, ge = cfg.gap_open, cfg.gap_extend
    goL, geL = cfg.long_gap_open, cfg.long_gap_extend
    res = {"hard": [], "tie_equivalent": 0, "identical": 0}
    a_lines = ref_text.splitlines()
    b_lines = our_text.splitlines()
    if len(a_lines) != len(b_lines):
        res["hard"].append((f"<{len(a_lines)} lines>",
                            f"<{len(b_lines)} lines>"))
        return res
    for a, b in zip(a_lines, b_lines):
        if a == b:
            res["identical"] += 1
            continue
        fa, fb = a.split("\t"), b.split("\t")
        if (len(fa) != len(fb) or len(fa) < 11
                or any(fa[i] != fb[i] for i in range(len(fa)) if i != 5)):
            res["hard"].append((a, b))
            continue
        try:
            ref = genome[fa[2]]
            pos0 = int(fa[3]) - 1
            sa = sam_alignment_score(pos0, fa[5], fa[9], ref, sub5,
                                     go, ge, goL, geL)
            sb = sam_alignment_score(pos0, fb[5], fb[9], ref, sub5,
                                     go, ge, goL, geL)
        except (KeyError, ValueError, IndexError):
            res["hard"].append((a, b))
            continue
        if sa == sb:          # equal score, query consumed, and ref span
            res["tie_equivalent"] += 1
        else:
            res["hard"].append((a, b))
    return res


def aligned_pair_score(ar: str, aq: str, sub5: np.ndarray, go: int,
                       ge: int, goL: int, geL: int) -> int:
    """Score an aligned string pair (gap char '-') column by column under
    the two-piece model."""
    if len(ar) != len(aq):
        raise ValueError("aligned strings of different lengths")
    total = 0
    i = 0
    n = len(ar)
    while i < n:
        a, b = ar[i], aq[i]
        if a != "-" and b != "-":
            total += int(sub5[_NT.get(a.upper(), 4), _NT.get(b.upper(), 4)])
            i += 1
            continue
        gap_in_ref = a == "-"
        j = i
        while j < n and ((ar[j] == "-") if gap_in_ref else (aq[j] == "-")):
            j += 1
        total += gap_cost(j - i, go, ge, goL, geL)
        i = j
    return total


def classify_mhap(ref_text: str, our_text: str, cfg=None,
                  max_d_matches: int = 64,
                  max_d_error: float = 0.02) -> dict:
    """Overlap-mode output is 6-line record blocks (header, aligned_ref,
    aligned_query, reverse header, aligned_query, aligned_ref;
    printer.cpp:141-176) — a tie-divergent traceback shifts the aligned
    strings and nudges the shared-match count, with identical
    coordinates.  A divergent block is tie-equivalent when every
    coordinate/strand/length field matches, the error/match-count deltas
    are small, and (when a Config is given) BOTH sides' aligned string
    pairs rescore identically under the two-piece model."""
    res = {"hard": [], "tie_equivalent": 0, "identical": 0}
    a_lines = ref_text.splitlines()
    b_lines = our_text.splitlines()
    if len(a_lines) != len(b_lines) or len(a_lines) % 6:
        res["hard"].append((f"<{len(a_lines)} lines>",
                            f"<{len(b_lines)} lines>"))
        return res
    if cfg is not None:
        sub5 = np.asarray(cfg.sub_matrix_5x5, np.int64)
        gaps = (cfg.gap_open, cfg.gap_extend,
                cfg.long_gap_open, cfg.long_gap_extend)
    for k in range(0, len(a_lines), 6):
        ba, bb = a_lines[k:k + 6], b_lines[k:k + 6]
        if ba == bb:
            res["identical"] += 1
            continue
        fa, fb = ba[0].split(), bb[0].split()
        fa2, fb2 = ba[3].split(), bb[3].split()
        # header fields: r1 r2 error matches strand s e len strand s e len
        ok = (len(fa) == len(fb) == 12 and len(fa2) == len(fb2) == 12
              and all(fa[i] == fb[i] for i in (0, 1, 4, 5, 6, 7, 8, 9,
                                               10, 11))
              and all(fa2[i] == fb2[i] for i in (0, 1, 4, 5, 6, 7, 8, 9,
                                                 10, 11))
              and abs(int(fa[3]) - int(fb[3])) <= max_d_matches
              and abs(float(fa[2]) - float(fb[2])) <= max_d_error
              # block self-consistency: lines 4/5 mirror 1/2
              and ba[4] == ba[2] and ba[5] == ba[1]
              and bb[4] == bb[2] and bb[5] == bb[1])
        if ok and cfg is not None:
            try:
                sa = aligned_pair_score(ba[1], ba[2], sub5, *gaps)
                sb = aligned_pair_score(bb[1], bb[2], sub5, *gaps)
            except ValueError:
                ok = False
            else:
                ok = sa == sb
        if ok:
            res["tie_equivalent"] += 1
        else:
            res["hard"].append((ba[0], bb[0]))
    return res
