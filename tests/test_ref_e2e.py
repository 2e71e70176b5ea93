"""END-TO-END ground truth: the COMPLETE reference binary (compiled from
/root/reference/software with the shims in native/refbin/) vs this
framework's CLI, byte-for-byte, on the reference's own bundled genome —
both output modes, default params.cfg, diverse reads including
structural-variant reads that force the large-tile escalation path.

This upgrades the golden tests from self-locked to reference-locked: the
kernel-level fuzz (test_ref_parity.py) plus this file cover byte identity
with the reference end-to-end at the default params.cfg.

Skipped automatically on hosts without g++/AVX2.
"""

import io
import os

import numpy as np
import pytest

import ref_binary as rb

try:
    BIN = rb.build()
except Exception:
    BIN = None

pytestmark = [
    pytest.mark.skipif(BIN is None,
                       reason="reference binary not buildable here"),
    pytest.mark.slow,
]

REF = "/root/reference/software/data/sample_ref.fa"


@pytest.fixture(autouse=True)
def _params_cfg(tmp_path):
    # both sides read params.cfg from the cwd (main.cpp:178 / cli.py)
    import shutil
    shutil.copy("/root/reference/software/params.cfg",
                tmp_path / "params.cfg")


def _yeast_store():
    from darwin_tpu.io.fasta import load_genome
    return load_genome(REF)


def _write_fa(path, reads):
    with open(path, "w") as f:
        for name, seq in reads:
            s = bytes(np.asarray(seq, np.uint8)).decode()
            f.write(f">{name}\n{s}\n")


def _our_cli(ref_path, reads_path, overlap, cwd):
    import contextlib
    from darwin_tpu import cli
    old = os.getcwd()
    buf = io.StringIO()
    try:
        os.chdir(cwd)  # params.cfg discovery matches the reference's
        with contextlib.redirect_stdout(buf):
            rc = cli.main([str(ref_path), str(reads_path),
                           "1" if overlap else "0"])
    finally:
        os.chdir(old)
    assert rc == 0
    return buf.getvalue()


def _sv_read(store, rng, start, left, gap, right):
    s0 = int(store.chromosomes[0].start) + start
    seq = np.concatenate([store.bases[s0:s0 + left],
                          store.bases[s0 + left + gap:
                                      s0 + left + gap + right]])
    # sprinkle errors so it is not a perfect match
    seq = seq.copy()
    idx = rng.integers(0, len(seq), size=len(seq) // 50)
    seq[idx] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                             len(idx))]
    return seq


def test_sam_byte_identical(tmp_path):
    from darwin_tpu.utils.simulate import simulate_reads
    store = _yeast_store()
    rng = np.random.default_rng(17)
    reads = []
    for i, (n, s, _) in enumerate(simulate_reads(store, 10, 2500, seed=17)):
        reads.append((n, s))
    # short and long variants
    for i, (n, s, _) in enumerate(simulate_reads(store, 2, 800, seed=18)):
        reads.append((f"short{i}_{n}", s))
    for i, (n, s, _) in enumerate(simulate_reads(store, 2, 8000, seed=19)):
        reads.append((f"long{i}_{n}", s))
    # structural variants: deletions wider than a standard tile
    reads.append(("sv_del1200", _sv_read(store, rng, 40000, 2000, 1200,
                                         2000)))
    reads.append(("sv_del900", _sv_read(store, rng, 120000, 1500, 900,
                                        1500)))
    reads_path = tmp_path / "reads.fa"
    _write_fa(reads_path, reads)

    ref_out = rb.run(REF, str(reads_path), False, str(tmp_path))
    our_out = _our_cli(REF, reads_path, False, tmp_path)
    assert ref_out == our_out
    body = [ln for ln in ref_out.splitlines() if not ln.startswith("@")]
    assert len(body) >= len(reads) - 2   # nearly everything aligns


def test_mhap_byte_identical(tmp_path):
    store = _yeast_store()
    rng = np.random.default_rng(23)
    base = int(store.chromosomes[0].start)
    reads = []
    for i in range(8):
        start = base + 60000 + i * 1500          # 3 kb reads, 1.5 kb step
        seq = store.bases[start:start + 3000].copy()
        idx = rng.integers(0, len(seq), size=60)
        seq[idx] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, len(idx))]
        if i % 3 == 2:
            from darwin_tpu.genome import revcomp_bytes
            seq = revcomp_bytes(seq)
        reads.append((f"ovl{i}", seq))
    reads_path = tmp_path / "reads.fa"
    _write_fa(reads_path, reads)

    ref_out = rb.run(str(reads_path), str(reads_path), True, str(tmp_path))
    our_out = _our_cli(reads_path, reads_path, True, tmp_path)
    assert ref_out == our_out
    assert len(ref_out.splitlines()) >= 10   # real overlap records found


NONDEFAULT_CFG = """[GACT_scoring]
sub_AA=2\nsub_AC=-6\nsub_AG=-6\nsub_AT=-6\nsub_CC=2\nsub_CG=-6\nsub_CT=-6
sub_GG=2\nsub_GT=-6\nsub_TT=2\nsub_N=-1
gap_open=-4\ngap_extend=-2\nlong_gap_open=-25\nlong_gap_extend=-1
[DSOFT_params]
seed_size=12\nminimizer_window=5\nbin_size=32\nthreshold=20
num_seeds=500\nseed_occurence_multiple=40\nmax_candidates=1000\nmax_stride=2
[GACT_first_tile]
first_tile_size=96\nfirst_tile_score_threshold=40\nfirst_tile_batch_size=64
slope_threshold=0.1\nmin_overlap=600
[GACT_extend]
tile_size=256\ntile_overlap=32\nbatch_size=2
[Multithreading]
num_threads=48
"""


def test_sam_byte_identical_nondefault_config(tmp_path):
    """Byte-identity must hold under a non-default params.cfg too
    (k/w/bin/threshold/stride, 96/256-sized tiles, different filter
    thresholds) — locks the whole config plumb-through end-to-end."""
    from darwin_tpu.utils.simulate import simulate_reads
    (tmp_path / "params.cfg").write_text(NONDEFAULT_CFG)
    store = _yeast_store()
    reads = [(n, s) for n, s, _ in simulate_reads(store, 8, 2000, seed=77)]
    reads_path = tmp_path / "reads.fa"
    _write_fa(reads_path, reads)
    ref_out = rb.run(REF, str(reads_path), False, str(tmp_path))
    our_out = _our_cli(REF, reads_path, False, tmp_path)
    assert ref_out == our_out
    assert len([l for l in ref_out.splitlines()
                if not l.startswith("@")]) >= 6


def test_sam_byte_identical_fastq_with_n(tmp_path):
    """FASTQ input (the kseq parse path on both sides) with N-run-bearing
    reads — N handling flows through hashing, the N sub-matrix row, and
    the printers identically."""
    from darwin_tpu.utils.simulate import simulate_reads
    store = _yeast_store()
    rng = np.random.default_rng(5)
    reads_path = tmp_path / "r.fq"
    with open(reads_path, "w") as f:
        for i, (n, s, _) in enumerate(simulate_reads(store, 8, 2000,
                                                     seed=5)):
            seq = np.asarray(s, np.uint8).copy()
            if i % 2 == 0:
                p = int(rng.integers(100, len(seq) - 60))
                seq[p:p + int(rng.integers(3, 40))] = ord("N")
            sq = bytes(seq).decode()
            f.write(f"@{n} extra comment\n{sq}\n+\n{'I' * len(sq)}\n")
    ref_out = rb.run(REF, str(reads_path), False, str(tmp_path))
    our_out = _our_cli(REF, reads_path, False, tmp_path)
    assert ref_out == our_out
    assert len(ref_out.splitlines()) >= 8
