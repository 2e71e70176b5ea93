"""Device minimizer scan / seed table / D-SOFT vs the sequential reference
transcription."""

import numpy as np
import jax.numpy as jnp
import pytest

from darwin_tpu.config import Config
from darwin_tpu import genome as G
from darwin_tpu.genome import GenomeStore, make_read
from darwin_tpu.index.minimizers import minimizer_scan
from darwin_tpu.index.seed_table import build_seed_table
from darwin_tpu.seeding.seeder import Seeder
from tests import dsoft_ref as R


def small_cfg():
    cfg = Config()
    cfg.seed_size = 7
    cfg.minimizer_window = 3
    cfg.bin_size = 16
    cfg.dsoft_threshold = 14
    cfg.num_seeds = 20
    cfg.max_stride = 4
    cfg.seed_occurence_multiple = 40
    return cfg


def _random_genome(rng, n):
    return rng.choice(list(b"ACGT"), size=n).astype(np.uint8)


@pytest.mark.parametrize("w", [3, 5, 7])
def test_minimizer_scan_matches_reference(rng, w):
    k = 7
    for L in [70, 100, 256, 131]:
        seq = _random_genome(rng, L)
        lcap = ((L + 15) // 16) * 16
        c2 = np.zeros(lcap, np.uint8)
        c2[:L] = G.encode2(seq)
        m, emit = minimizer_scan(jnp.asarray(c2[None]),
                                 jnp.asarray([L], np.int32), k, w)
        m, emit = np.asarray(m[0]), np.asarray(emit[0])
        got = [(int(p), int(m[p])) for p in np.nonzero(emit)[0]]
        want = R.ref_minimizers(c2, L, k, w)
        assert got == want


def test_seed_table_matches_reference(rng):
    cfg = small_cfg()
    store = GenomeStore()
    for i in range(3):
        store.add_chromosome(f"chr{i}", _random_genome(rng, 400 + 37 * i))
    store.finalize()
    table = build_seed_table(store, cfg)
    # rebuild expectation sequentially
    exp = []
    for c in store.chromosomes:
        c2 = store.codes2[c.start:c.start + c.length]
        for p, m in R.ref_minimizers(c2, c.length_unpadded,
                                     cfg.seed_size, cfg.minimizer_window):
            exp.append((m, p + c.start))
    exp.sort()
    got = list(zip(np.asarray(table.sorted_hashes).tolist(),
                   np.asarray(table.positions).tolist()))
    assert got == exp


@pytest.mark.parametrize("overlap", [False, True])
def test_dsoft_matches_reference(rng, overlap):
    cfg = small_cfg()
    cfg.do_overlap = overlap
    store = GenomeStore()
    base = _random_genome(rng, 1200)
    store.add_chromosome("chrA", base)
    store.add_chromosome("chrB", _random_genome(rng, 700))
    store.finalize()
    table = build_seed_table(store, cfg)
    th = np.asarray(table.sorted_hashes)
    tp = np.asarray(table.positions)

    # reads: noisy copies of genome slices (fw and rc covered via Seeder)
    reads = []
    for i in range(4):
        start = int(rng.integers(0, 900))
        ln = int(rng.integers(150, 300))
        sl = base[start:start + ln].copy()
        mut = rng.random(len(sl)) < 0.05
        sl[mut] = rng.choice(list(b"ACGT"), size=mut.sum())
        reads.append(make_read(f"read{i}", sl))

    seeder = Seeder(table, cfg)
    result = seeder.seed_batch(reads)

    for i, read in enumerate(reads):
        for anchors, seq in ((result.fw_anchors[i], read.seq),
                             (result.rc_anchors[i], read.rc_seq)):
            L = len(seq)
            lcap = ((L + 15) // 16) * 16
            c2 = np.zeros(lcap, np.uint8)
            c2[:L] = G.encode2(seq)
            hits, ancs, _ = R.ref_dsoft_hits_and_anchors(
                c2, L, th, tp, k=cfg.seed_size, w=cfg.minimizer_window,
                num_seeds=cfg.num_seeds, max_stride=cfg.max_stride,
                overlap=overlap, threshold=cfg.dsoft_threshold,
                bin_size=cfg.bin_size, max_occ=table.kmer_max_occurence)
            want = R.ref_chain(hits, ancs, cfg.bin_size, overlap)
            assert len(anchors) == len(want), (i, len(anchors), len(want))
            for got_a, want_a in zip(anchors, want):
                assert got_a.hit == want_a["hit"]
                assert got_a.offset == want_a["offset"]
                assert got_a.num_chained_hits == want_a["num_chained"]
                assert got_a.anchor_score == want_a["score"]
                assert got_a.left_chained.tolist() == want_a["left"]
                assert got_a.right_chained.tolist() == want_a["right"]


def test_chunked_genome_scan_matches_single_shot(rng):
    """scan_chromosome_minimizers (fixed-shape chunked, carried anchor)
    must emit exactly the same (position, hash) pairs as the one-shot
    minimizer_scan, including across chunk boundaries."""
    import jax.numpy as jnp
    from darwin_tpu.index import minimizers as mz

    k, w = 12, 5
    old_chunk, old_rows = mz.CHUNK, mz.CROWS
    mz.CHUNK, mz.CROWS = 1 << 10, 3   # force many chunks + many batches
    try:
        for L in (700, 5000, 9973):
            codes2 = rng.integers(0, 4, size=((L + 127) // 128) * 128
                                  ).astype(np.uint8)
            codes2[L:] = 0
            m, emit = mz.minimizer_scan(
                jnp.asarray(codes2[None, :]),
                jnp.asarray([L], np.int32), k, w)
            ref_p = np.nonzero(np.asarray(emit[0]))[0]
            ref_h = np.asarray(m[0])[ref_p]
            got_p, got_h = mz.scan_chromosome_minimizers(codes2, L, k, w)
            np.testing.assert_array_equal(got_p, ref_p, err_msg=f"L={L}")
            np.testing.assert_array_equal(got_h, ref_h, err_msg=f"L={L}")
    finally:
        mz.CHUNK, mz.CROWS = old_chunk, old_rows


def test_multi_sequence_scan_matches_per_sequence(rng):
    """scan_many_minimizers packs many sequences' chunks into shared
    batches (overlap mode indexes every read); each sequence's emissions
    must equal its standalone scan — including sequences that span chunk
    rows AND batch boundaries, and sequences shorter than one k-mer."""
    from darwin_tpu.index import minimizers as mz

    k, w = 14, 3
    old_chunk, old_rows = mz.CHUNK, mz.CROWS
    mz.CHUNK, mz.CROWS = 1 << 10, 5   # multi-chunk rows + cross-batch carry
    try:
        seqs = []
        for L in (40, 1000, 5000, 17, 3000, 2048, 1, 9000):
            c2 = rng.integers(0, 4, ((L + 15) // 16) * 16).astype(np.uint8)
            seqs.append((c2, L))
        many = mz.scan_many_minimizers(seqs, k, w)
        for (c2, L), (p, h) in zip(seqs, many):
            p1, h1 = mz.scan_many_minimizers([(c2, L)], k, w)[0]
            np.testing.assert_array_equal(p, p1, err_msg=f"L={L}")
            np.testing.assert_array_equal(h, h1, err_msg=f"L={L}")
    finally:
        mz.CHUNK, mz.CROWS = old_chunk, old_rows


def test_device_table_build_matches_host(rng):
    """The device-resident build (scan + pair emission + lax.sort, no host
    argsort) must produce exactly the host path's table."""
    from darwin_tpu.config import Config
    from darwin_tpu.genome import GenomeStore
    from darwin_tpu.index import seed_table as st

    store = GenomeStore()
    for i, L in enumerate((50000, 1234, 17, 9999, 300)):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)]
        store.add_chromosome(f"c{i}", seq)
    store.finalize()
    cfg = Config()
    t_dev = st.build_seed_table(store, cfg)
    t_host = st.build_seed_table(store, cfg, method="host")
    np.testing.assert_array_equal(np.asarray(t_dev.sorted_hashes),
                                  np.asarray(t_host.sorted_hashes))
    np.testing.assert_array_equal(np.asarray(t_dev.positions),
                                  np.asarray(t_host.positions))


def test_streaming_table_build_matches_host(rng):
    """The streaming accumulator build (the >512 Mbp path: per-batch
    compaction + device append + one global sort) must equal the host
    path bit-for-bit, including cross-batch anchor carries and the
    cap-overflow retry."""
    from darwin_tpu.config import Config
    from darwin_tpu.genome import GenomeStore
    from darwin_tpu.index import minimizers as mz
    from darwin_tpu.index import seed_table as st

    store = GenomeStore()
    # > one CROWS x CHUNK batch (2 Mbp) so carries chain across batches;
    # plus small/odd chromosomes exercising new-sequence resets at batch
    # boundaries
    for i, L in enumerate((2_300_000, 123_456, 17, 50_000)):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)]
        store.add_chromosome(f"c{i}", seq)
    store.finalize()
    cfg = Config()
    t_str = st.build_seed_table(store, cfg, method="stream")
    t_host = st.build_seed_table(store, cfg, method="host")
    np.testing.assert_array_equal(np.asarray(t_str.sorted_hashes),
                                  np.asarray(t_host.sorted_hashes))
    np.testing.assert_array_equal(np.asarray(t_str.positions),
                                  np.asarray(t_host.positions))

    # overflow detection: a too-small cap must report a negative count
    # (the retry in build_seed_table then doubles it — same final table)
    seqs = [(store.codes2[c.start:c.start + c.length], c.length_unpadded,
             c.start) for c in store.chromosomes]
    k, w = cfg.seed_size, cfg.minimizer_window
    _, _, n = mz.scan_sorted_pairs_streaming(seqs, k, w, cap=1024)
    assert n < 0


def test_prefix_lut_ranges_match_searchsorted(rng):
    """The prefix-LUT bisect must reproduce searchsorted exactly —
    duplicates, absent hashes, and prefix-boundary values included."""
    import jax.numpy as jnp
    from darwin_tpu.index.seed_table import SeedTable
    from darwin_tpu.seeding.dsoft import _bucket_ranges

    k = 14
    hashes = np.sort(rng.integers(0, 1 << (2 * k), 20000).astype(np.uint32))
    hashes[100:160] = hashes[100]          # a fat bucket
    hashes = np.sort(hashes)
    t = SeedTable(jnp.asarray(hashes), jnp.asarray(hashes), k, 3,
                  1 << 20, 40).ensure_lut()
    q = np.concatenate([
        rng.choice(hashes, 500),                       # present
        rng.integers(0, 1 << (2 * k), 500).astype(np.uint32),  # random
        np.array([0, (1 << (2 * k)) - 1, hashes[0], hashes[-1]],
                 np.uint32),
    ])
    qd = jnp.asarray(q)[None, :]
    s1, e1 = _bucket_ranges(t.sorted_hashes, qd, t.prefix_lut,
                            t.lut_shift, t.lut_steps)
    s0, e0 = _bucket_ranges(t.sorted_hashes, qd)      # plain searchsorted
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s0))
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e0))


def test_bin_size_one_high_addresses(rng):
    """bin_size=1 on a genome positioned past 2^31: bins reach the full
    uint32 range (the reference keeps the bin in a uint64 key's upper
    half) — the device pipeline and host chaining must shift exactly with
    the address offset, with no int32 truncation anywhere."""
    import jax.numpy as jnp
    from darwin_tpu.config import Config
    from darwin_tpu.genome import GenomeStore
    from darwin_tpu.index.seed_table import SeedTable, build_seed_table
    from darwin_tpu.seeding.seeder import Seeder

    cfg = Config()
    cfg.seed_size = 10
    cfg.dsoft_threshold = 20
    cfg.bin_size = 1
    store = GenomeStore()
    genome = rng.choice(list(b"ACGT"), size=9000).astype(np.uint8)
    store.add_chromosome("c", genome)
    store.finalize()
    table = build_seed_table(store, cfg)

    OFF = 3_000_000_000
    hi_table = SeedTable(
        sorted_hashes=table.sorted_hashes,
        positions=jnp.asarray(
            (np.asarray(table.positions).astype(np.uint64)
             + np.uint64(OFF)).astype(np.uint32)),
        kmer_size=table.kmer_size,
        minimizer_window=table.minimizer_window,
        ref_size=table.ref_size + OFF,
        kmer_max_occurence=table.kmer_max_occurence)

    from darwin_tpu.genome import make_read
    from darwin_tpu.utils.simulate import simulate_reads
    reads = [make_read(n, s)
             for n, s, _ in simulate_reads(store, 3, 1200, seed=3)]

    lo = Seeder(table, cfg).seed_batch(reads)
    hi = Seeder(hi_table, cfg).seed_batch(reads)
    n_anchors = 0
    for a_lo, a_hi in zip(lo.fw_anchors + lo.rc_anchors,
                          hi.fw_anchors + hi.rc_anchors):
        assert len(a_lo) == len(a_hi)
        for x, y in zip(a_lo, a_hi):
            n_anchors += 1
            assert y.hit == x.hit + OFF
            assert y.offset == x.offset
            assert y.num_chained_hits == x.num_chained_hits
            assert y.anchor_score == x.anchor_score
            shift = np.uint64(OFF) << np.uint64(32)
            np.testing.assert_array_equal(
                y.left_chained, x.left_chained + shift)
            np.testing.assert_array_equal(
                y.right_chained, x.right_chained + shift)
    assert n_anchors > 0


@pytest.mark.parametrize("overlap", [False, True])
def test_hit_pruning_is_chain_exact(rng, overlap):
    """Device-side hit pruning to anchor bin windows (dsoft._hits_post)
    must leave the chained output bit-identical to the unpruned arrays:
    chaining reads only value-ranged window slices
    (seed_pos_table.cpp:409), so dropping out-of-window hits is inert."""
    from darwin_tpu.seeding import chain
    from darwin_tpu.seeding import dsoft as D

    cfg = small_cfg()
    cfg.do_overlap = overlap
    store = GenomeStore()
    base = _random_genome(rng, 3000)
    store.add_chromosome("chrA", base)
    store.finalize()
    table = build_seed_table(store, cfg).ensure_lut()

    reads = []
    for i in range(6):
        start = int(rng.integers(0, 2500))
        ln = int(rng.integers(200, 400))
        sl = base[start:start + ln].copy()
        mut = rng.random(len(sl)) < 0.08
        sl[mut] = rng.choice(list(b"ACGT"), size=mut.sum())
        reads.append(make_read(f"r{i}", sl))

    max_len = max(r.length for r in reads)
    lcap = ((max_len + 15) // 16) * 16
    B = 2 * len(reads)
    codes2 = np.zeros((B, lcap), np.uint8)
    lengths = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        codes2[2 * i, :r.length] = G.encode2(r.seq)
        codes2[2 * i + 1, :r.length] = G.encode2(r.rc_seq)
        lengths[2 * i] = lengths[2 * i + 1] = r.length

    from darwin_tpu.seeding.dsoft import mq_cap_for
    mq_cap = mq_cap_for(lcap - cfg.seed_size + 1, cfg.num_seeds,
                        cfg.max_stride, cfg.do_overlap)
    kw = dict(k=cfg.seed_size, w=cfg.minimizer_window,
              num_seeds=cfg.num_seeds, max_stride=cfg.max_stride,
              overlap=cfg.do_overlap, threshold=cfg.dsoft_threshold,
              bin_size=cfg.bin_size, max_occ=table.kmer_max_occurence,
              mq_cap=mq_cap, a_cap=4096,
              lut=table.prefix_lut, lut_shift=table.lut_shift,
              lut_steps=table.lut_steps)
    pruned = D.dsoft_device(jnp.asarray(codes2), jnp.asarray(lengths),
                            table.sorted_hashes, table.positions, **kw)

    # unpruned baseline: same pipeline with the window check disabled
    orig = D.sv_bins
    D.sv_bins = lambda b, o: (1 << 31)  # window covers every uint32 bin
    D.dsoft_device.clear_cache()
    try:
        full = D.dsoft_device(jnp.asarray(codes2), jnp.asarray(lengths),
                              table.sorted_hashes, table.positions, **kw)
    finally:
        D.sv_bins = orig
        D.dsoft_device.clear_cache()

    n_p = np.asarray(pruned["n_hits"])
    n_f = np.asarray(full["n_hits"])
    assert (n_p <= n_f).all() and n_f.sum() > 0

    def chains(res, row):
        return chain.chain_anchors(
            np.asarray(res["hits_bin"][row]).astype(np.int64),
            np.asarray(res["hits_off"][row]),
            np.asarray(res["hits_pos"][row]).astype(np.int64),
            int(np.asarray(res["n_hits"][row])),
            np.asarray(res["anc_pos"][row]).astype(np.int64),
            np.asarray(res["anc_off"][row]),
            np.asarray(res["anc_bin"][row]).astype(np.int64),
            int(np.asarray(res["n_anchors"][row])),
            cfg.bin_size, cfg.do_overlap)

    for row in range(B):
        a_p = chains(pruned, row)
        a_f = chains(full, row)
        assert len(a_p) == len(a_f)
        for x, y in zip(a_p, a_f):
            assert x.hit == y.hit and x.offset == y.offset
            assert x.num_chained_hits == y.num_chained_hits
            assert x.anchor_score == y.anchor_score
            assert x.left_chained.tolist() == y.left_chained.tolist()
            assert x.right_chained.tolist() == y.right_chained.tolist()


def test_csr_build_matches_pairs(rng):
    """The two-pass streaming CSR build must hold exactly the pairs
    table's contents: offsets[h]..offsets[h+1] slices the same
    position-ascending bucket the sorted-pair table stores for h —
    including builds spanning multiple row batches (cross-batch cursor
    advance + anchor carries) and chromosome resets inside a batch."""
    from darwin_tpu.index import seed_table as st

    cfg = Config()
    cfg.seed_size = 11          # 4^11 buckets: empties exist, and the host
    store = GenomeStore()       # offset oracle stays cheap
    for i, L in enumerate((2_300_000, 123_456, 17, 50_000)):
        store.add_chromosome(f"c{i}", _random_genome(rng, L))
    store.finalize()
    t_csr = st.build_seed_table(store, cfg, layout="csr")
    t_host = st.build_seed_table(store, cfg, method="host")

    k = cfg.seed_size
    hashes = np.asarray(t_host.sorted_hashes)
    off_ref = np.searchsorted(
        hashes, np.arange((1 << (2 * k)) + 1, dtype=np.int64)
    ).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(t_csr.bucket_offsets),
                                  off_ref)
    np.testing.assert_array_equal(np.asarray(t_csr.positions),
                                  np.asarray(t_host.positions))

    # save/load roundtrip keeps the layout; is_present answers via the
    # offset gather
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "idx.npz")
        t_csr.save(p)
        t2 = st.SeedTable.load(p)
        assert t2.sorted_hashes is None
        np.testing.assert_array_equal(np.asarray(t2.bucket_offsets),
                                      off_ref)
    present = hashes[len(hashes) // 2]
    counts = np.diff(off_ref)
    absent = int(np.flatnonzero(counts == 0)[0])
    assert t_csr.is_present(int(present)) == t_host.is_present(int(present))
    assert not t_csr.is_present(absent)


def test_csr_dsoft_matches_pairs(rng):
    """dsoft_device through the csr bucket-offset gathers must equal the
    pairs/LUT path bit-for-bit: hits, anchors, counts."""
    from darwin_tpu.index import seed_table as st
    from darwin_tpu.seeding.dsoft import dsoft_device, mq_cap_for

    cfg = small_cfg()
    store = GenomeStore()
    store.add_chromosome("c0", _random_genome(rng, 200_000))
    store.add_chromosome("c1", _random_genome(rng, 30_000))
    store.finalize()
    t_pairs = st.build_seed_table(store, cfg).ensure_lut()
    t_csr = st.build_seed_table(store, cfg, layout="csr")

    B, L = 4, 2048
    codes2 = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        s = int(rng.integers(0, store.size - L))
        seg = store.codes2[s:s + L].copy()
        flip = rng.random(L) < 0.1
        seg[flip] = (seg[flip] + 1) % 4
        codes2[b] = seg
        lengths[b] = L
    kw = dict(k=cfg.seed_size, w=cfg.minimizer_window,
              num_seeds=cfg.num_seeds, max_stride=cfg.max_stride,
              overlap=False, threshold=cfg.dsoft_threshold,
              bin_size=cfg.bin_size,
              max_occ=t_pairs.kmer_max_occurence,
              mq_cap=mq_cap_for(L - cfg.seed_size + 1, cfg.num_seeds,
                                cfg.max_stride, False),
              a_cap=512, hit_cap=4096)
    r_pairs = dsoft_device(jnp.asarray(codes2), jnp.asarray(lengths),
                           t_pairs.sorted_hashes, t_pairs.positions,
                           lut=t_pairs.prefix_lut,
                           lut_shift=t_pairs.lut_shift,
                           lut_steps=t_pairs.lut_steps, **kw)
    r_csr = dsoft_device(jnp.asarray(codes2), jnp.asarray(lengths),
                         None, t_csr.positions,
                         bucket_offsets=t_csr.bucket_offsets, **kw)
    for key in ("hits_bin", "hits_off", "hits_pos", "n_hits",
                "anc_pos", "anc_off", "anc_bin", "n_anchors",
                "n_anchors_raw", "n_queried_buckets", "n_flat_raw"):
        np.testing.assert_array_equal(
            np.asarray(r_pairs[key]), np.asarray(r_csr[key]), err_msg=key)


def test_csr_layout_validation(rng):
    """csr with k=15 (legal for pairs) must fail loudly up front, before
    any build work; unknown layouts too."""
    from darwin_tpu.index import seed_table as st

    store = GenomeStore()
    store.add_chromosome("c0", _random_genome(rng, 1000))
    store.finalize()
    cfg = Config()
    cfg.seed_size = 15
    with pytest.raises(ValueError, match="seed_size <= 14"):
        st.build_seed_table(store, cfg, layout="csr")
    with pytest.raises(ValueError, match="unknown index layout"):
        st.build_seed_table(store, cfg, layout="bogus")


def test_streaming_builds_past_int32_chromosome_starts(rng):
    """Chromosome global starts >= 2^31 (the 3.2 Gbp genome) must stage
    into the streaming builds without OverflowError (numpy 2 rejects
    out-of-range int32 assignment) and come back as exact uint32
    positions.  Small codes with a forged global start keep the test
    cheap while exercising the same wrap-and-reinterpret path."""
    from darwin_tpu.index import minimizers as mz

    k, w = 11, 5
    L = 4096
    codes2 = rng.integers(0, 4, L).astype(np.uint8)
    gstart = 2_400_000_000            # > 2^31
    seqs = [(codes2, L, gstart)]

    p_loc, h_loc = mz.scan_chromosome_minimizers(codes2, L, k, w)
    want = sorted(zip(h_loc.tolist(),
                      ((p_loc + gstart) % (1 << 32)).tolist()))

    sh, sp, n = mz.scan_sorted_pairs_streaming(seqs, k, w, cap=1 << 16)
    assert n == len(want)
    got = list(zip(np.asarray(sh).tolist(), np.asarray(sp).tolist()))
    assert got == want

    offs, pos, n2, _ = mz.build_csr_streaming(seqs, k, w)
    assert n2 == len(want)
    offs = np.asarray(offs)
    pos = np.asarray(pos)
    got_csr = []
    for h in sorted(set(h for h, _ in want)):
        got_csr.extend((h, int(p)) for p in pos[offs[h]:offs[h + 1]])
    assert got_csr == want


def test_pairs_build_oom_raises_with_hint(rng, monkeypatch):
    """A device RESOURCE_EXHAUSTED during the pairs build is an error that
    names the way out (the csr layout or the host build) — never a quiet
    switch to the host build that hides what the device could not do;
    other device errors propagate unchanged."""
    from darwin_tpu.config import Config
    from darwin_tpu.genome import GenomeStore
    from darwin_tpu.index import seed_table as st

    store = GenomeStore()
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 40_000)]
    store.add_chromosome("c0", seq)
    store.finalize()
    cfg = Config()

    def boom(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of device memory")

    monkeypatch.setattr(st, "scan_sorted_pairs_device", boom)
    monkeypatch.setattr(st, "scan_sorted_pairs_streaming", boom)
    for method in ("device", "stream"):
        with pytest.raises(RuntimeError, match="index-layout csr") as ei:
            st.build_seed_table(store, cfg, method=method)
        assert "RESOURCE_EXHAUSTED" in str(ei.value.__cause__)

    def other(*a, **k):
        raise RuntimeError("INTERNAL: something else")

    monkeypatch.setattr(st, "scan_sorted_pairs_device", other)
    with pytest.raises(RuntimeError, match="INTERNAL"):
        st.build_seed_table(store, cfg, method="device")
    # the host build needs no device sort and still works
    assert st.build_seed_table(store, cfg, method="host").num_seeds > 0


def test_occupancy_cap_telemetry_on_repeat_genome(rng):
    """A repeat-structured genome (utils/synthgenome) must trip the
    occupancy cap (n_capped_buckets > 0, software/seed_pos_table.cpp:314)
    while a uniform-random genome of the same size does not — and seeding
    must still work (anchors produced for a unique-region read)."""
    from darwin_tpu.utils.synthgenome import repeat_genome

    cfg = Config()
    cfg.seed_size = 12

    def seed_stats(bases):
        store = GenomeStore()
        store.add_chromosome("c0", bases)
        store.finalize()
        table = build_seed_table(store, cfg)
        # 16 reads spread across the genome: with ~40% repeat content at
        # least one window overlaps a high-occupancy repeat
        reads = [make_read(f"r{i}", bases[p:p + 2000])
                 for i, p in enumerate(
                     range(1000, len(bases) - 2000, len(bases) // 16))]
        return Seeder(table, cfg).seed_batch(reads)

    rep, stats = repeat_genome(rng, 300_000)
    assert stats["repeat_frac"] > 0.2
    r = seed_stats(rep)
    assert r.n_capped_buckets > 0
    assert r.n_queried_buckets > 0

    uni = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 300_000)]
    u = seed_stats(uni)
    assert u.n_capped_buckets == 0
    assert any(len(a) > 0 for a in u.fw_anchors)
