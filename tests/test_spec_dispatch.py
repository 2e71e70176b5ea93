"""The fused extension round's host protocol: speculative chains, result
packing, compact records and their lossless wide reruns, on one device and
on a mesh.

Every platform runs the extension loop through the fused round programs
(ops/dispatch.py::_extend_round: gather + DP + traceback records + packed
int16 results + K-tile speculative chains), so the CPU tests exercise the
same protocol the GPU runs, with the plain tile implementation.  The
reference point is the same pipeline without speculation (SPEC_K = 1),
byte for byte."""

import numpy as np
import pytest

from darwin_tpu.config import Config
from darwin_tpu.genome import make_read
from darwin_tpu.io.fasta import load_genome
from darwin_tpu.ops import dispatch
from darwin_tpu.pipeline.align import Aligner, new_counters

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(autouse=True)
def _short_chains(monkeypatch):
    # bound the work per dispatch; resolver correctness is K-invariant by
    # construction (levels accepted only on request match)
    monkeypatch.setattr(dispatch, "SPEC_K", 4)


def _mutate(rng, frag):
    """conftest.mutate on ASCII bases (it operates on 0-3 codes)."""
    from conftest import mutate
    from darwin_tpu.genome import encode5
    return BASES[mutate(rng, encode5(frag),
                        sub_p=0.03, ins_p=0.01, del_p=0.01)]


@pytest.fixture
def tiny_workload(tmp_path, rng):
    genome = rng.choice(BASES, size=20000)
    ref = tmp_path / "ref.fa"
    with open(ref, "w") as f:
        f.write(">chr1\n" + genome.tobytes().decode() + "\n")
    reads = []
    for i in range(3):
        start = int(rng.integers(0, genome.size - 900))
        frag = genome[start:start + 800]
        seq = _mutate(rng, frag)
        if i == 2:                       # one reverse-strand read
            seq = make_read("t", seq).rc_seq
        reads.append(make_read(f"read{i}", seq))
    return str(ref), reads


def _small_cfg():
    # small tiles keep the CPU cost low while still producing multi-tile
    # extensions (and therefore speculative chains)
    cfg = Config()
    cfg.tile_size = 64
    cfg.tile_overlap = 16
    cfg.first_tile_size = 32
    cfg.first_tile_score_threshold = 20
    return cfg


def _align(ref_path, reads, spec_k, monkeypatch):
    monkeypatch.setattr(dispatch, "SPEC_K", spec_k)
    store = load_genome(ref_path)
    aligner = Aligner(_small_cfg(), store)
    cnt = new_counters()
    lines = aligner.align_batch(reads, cnt)
    return lines, cnt


def _overflow_case(rng):
    """A tile whose optimal traceback holds an 80-long insert run — one
    record with nI > 63, which the compact 8-bit layout cannot represent
    and must flag for the wide rerun."""
    from darwin_tpu.ops import gact
    from darwin_tpu.config import Config
    import jax.numpy as jnp

    ref = rng.integers(0, 4, size=192).astype(np.uint8)
    query = np.concatenate([ref[:60],
                            rng.integers(0, 4, size=80).astype(np.uint8),
                            ref[60:160]])
    B = 128
    r_start = np.zeros(B, np.int64)
    r_size = np.ones(B, np.int32)
    q_start = np.zeros(B, np.int64)
    q_size = np.ones(B, np.int32)
    rev = np.zeros(B, bool)
    r_size[0] = 160
    q_size[0] = query.size
    params = gact.make_params(Config())
    return (jnp.asarray(ref), jnp.asarray(query), r_start, r_size,
            q_start, q_size, rev, params)


def _res_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "spec_req":
            for j, (x, y) in enumerate(zip(a[k], b[k])):
                for xx, yy in zip(x, y):
                    assert np.array_equal(np.asarray(xx),
                                          np.asarray(yy)), (k, j)
        elif k in ("ops_spec", "n_ops_spec"):
            assert len(a[k]) == len(b[k]), k
            for j, (x, y) in enumerate(zip(a[k], b[k])):
                assert np.array_equal(np.asarray(x), np.asarray(y)), (k, j)
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("bits", [8, 4])
def test_rec_overflow_rerun(rng, monkeypatch, bits):
    """Compact-record overflow (insert run wider than the nI field) must
    be detected and rerun losslessly through the wide layout."""
    from darwin_tpu.ops.oracle import OP_I

    refc, qc, r_start, r_size, q_start, q_size, rev, params = \
        _overflow_case(rng)
    reruns = []
    orig = dispatch._subset_requests
    monkeypatch.setattr(dispatch, "_subset_requests",
                        lambda req, idx: reruns.append(len(idx))
                        or orig(req, idx))

    def run():
        return dispatch.extend_tiles_async(
            refc, qc, r_start, r_size, q_start, q_size, rev, params,
            qt=256, rt=256, max_tb=512)()

    monkeypatch.setenv("DARWIN_TPU_RECBITS", "16")
    wide = run()
    assert reruns == []                    # wide layout never overflows
    monkeypatch.setenv("DARWIN_TPU_RECBITS", str(bits))
    compact = run()
    assert reruns == [1]                   # exactly the one flagged lane
    _res_equal(wide, compact)
    # the case is real: the traceback holds an I-run longer than 63
    n = int(wide["n_ops"][0])
    ops = np.asarray(wide["ops"])[0, :n]
    is_i = np.concatenate(([0], (ops == OP_I).astype(int), [0]))
    d = np.diff(is_i)
    longest_i = int((np.flatnonzero(d == -1)
                     - np.flatnonzero(d == 1)).max())
    assert longest_i > 63


@pytest.mark.parametrize("bits", [8, 4])
def test_rec_overflow_spec_chain(rng, monkeypatch, bits):
    """The speculative resolver's per-level patching of flagged lanes:
    compact + overflow must equal the wide layout on every level, the
    tile-1 stats, and the reconstructed speculative requests."""
    refc, qc, r_start, r_size, q_start, q_size, rev, params = \
        _overflow_case(rng)
    chrom_start = np.zeros(128, np.int64)
    chrom_len = np.full(128, 192, np.int64)
    q_buf_start = np.zeros(128, np.int64)
    q_len = np.asarray(q_size, np.int64)

    def run():
        return dispatch.extend_tiles_async(
            refc, qc, r_start, r_size, q_start, q_size, rev, params,
            qt=256, rt=256, max_tb=512,
            chain=(chrom_start, chrom_len, q_buf_start, q_len, 192))()

    monkeypatch.setenv("DARWIN_TPU_RECBITS", "16")
    wide = run()
    monkeypatch.setenv("DARWIN_TPU_RECBITS", str(bits))
    compact = run()
    _res_equal(wide, compact)


def test_mesh_fused_dispatch_identity(rng, monkeypatch):
    """The shard_map'd fused round (per-device speculative chains,
    compact records) against the single-device pipeline without
    speculation, on a 2-device virtual mesh."""
    from darwin_tpu.genome import GenomeStore
    from darwin_tpu.parallel.shard import make_mesh
    from darwin_tpu.utils.simulate import simulate_reads

    store = GenomeStore()
    store.add_chromosome(
        "chrA", rng.choice(list(b"ACGT"), size=12000).astype(np.uint8))
    store.finalize()
    cfg = _small_cfg()
    cfg.seed_size = 10
    cfg.dsoft_threshold = 20
    sim = simulate_reads(store, 3, 800, seed=7)
    reads = [make_read(n, s) for n, s, _ in sim]

    monkeypatch.setattr(dispatch, "SPEC_K", 1)
    single = Aligner(cfg, store).align_batch(reads)

    monkeypatch.setattr(dispatch, "SPEC_K", 4)
    cnt = new_counters()
    meshed = Aligner(cfg, store, mesh=make_mesh(2)).align_batch(reads, cnt)

    assert meshed == single
    assert len(single) >= 2
    assert cnt["num_spec_hits"] + cnt["num_spec_misses"] > 0


def test_spec_dispatch_byte_identity(tiny_workload, monkeypatch):
    ref_path, reads = tiny_workload
    lax_lines, lax_cnt = _align(ref_path, reads, 1, monkeypatch)
    pl_lines, pl_cnt = _align(ref_path, reads, 4, monkeypatch)

    assert lax_cnt["num_extend_tiles"] > 0          # workload is non-trivial
    assert lax_cnt["num_spec_hits"] + lax_cnt["num_spec_misses"] == 0
    assert pl_lines == lax_lines                    # byte-identical SAM
    # the speculative chain actually ran (and mostly hit)
    trials = pl_cnt["num_spec_hits"] + pl_cnt["num_spec_misses"]
    assert trials > 0
    assert pl_cnt["num_spec_hits"] > 0
    # the reference-visible work counters agree with and without chains
    for key in ("num_filter_tiles", "num_extend_requests",
                "num_slope_filtered", "num_extend_tiles",
                "num_active_tiles", "num_large_tiles"):
        assert pl_cnt[key] == lax_cnt[key], key


@pytest.mark.parametrize("spec", [False, True])
def test_mesh_per_lane_rerun(rng, monkeypatch, spec):
    """Mesh-path overflow recovery is per-lane: exactly the flagged lanes
    (here 2 of 256) rerun through one small single-device wide program,
    and the patched results equal the wide layout."""
    from darwin_tpu.parallel.shard import MeshDispatcher, make_mesh

    refc, qc, r_start, r_size, q_start, q_size, rev, params = \
        _overflow_case(rng)
    # widen to 2 devices x 128 lanes with a second flagged lane at 200
    def widen(a, fill):
        out = np.full(256, fill, a.dtype)
        out[:128] = a
        return out
    r_start = widen(r_start, 0)
    r_size = widen(r_size, 1)
    q_start = widen(q_start, 0)
    q_size = widen(q_size, 1)
    rev = widen(rev, False)
    r_size[200] = r_size[0]
    q_size[200] = q_size[0]

    md = MeshDispatcher(make_mesh(2))
    refc = md.put_replicated(refc)
    qc = md.put_replicated(qc)

    def run():
        if spec:
            chrom_start = np.zeros(256, np.int64)
            chrom_len = np.full(256, 192, np.int64)
            q_buf_start = np.zeros(256, np.int64)
            q_len = np.asarray(q_size, np.int64)
            return md.extend_tiles_async(
                refc, qc, r_start, r_size, q_start, q_size, rev, params,
                qt=256, rt=256, max_tb=512,
                chain=(chrom_start, chrom_len, q_buf_start, q_len, 192))()
        return md.extend_tiles_async(
            refc, qc, r_start, r_size, q_start, q_size, rev, params,
            qt=256, rt=256, max_tb=512)()

    monkeypatch.setenv("DARWIN_TPU_RECBITS", "16")
    wide = run()
    monkeypatch.setenv("DARWIN_TPU_RECBITS", "8")
    before = dict(dispatch.RECOVERY)
    compact = run()
    assert dispatch.RECOVERY["rerun_dispatches"] == \
        before["rerun_dispatches"] + 1
    # per-lane: only the 2 flagged lanes rerun, not the 256-lane batch
    assert dispatch.RECOVERY["rerun_lanes"] == before["rerun_lanes"] + 2
    _res_equal(wide, compact)
