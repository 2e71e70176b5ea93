"""Whole-pipeline multi-device test: SAM output on an 8-device mesh must be
byte-identical to single-device."""

import numpy as np

from darwin_tpu.config import Config
from darwin_tpu.genome import GenomeStore, make_read
from darwin_tpu.parallel.shard import make_mesh
from darwin_tpu.pipeline.align import Aligner
from darwin_tpu.utils.simulate import simulate_reads


def test_mesh_pipeline_identical(rng):
    cfg = Config()
    cfg.seed_size = 10
    cfg.dsoft_threshold = 20
    cfg.min_overlap = 400
    store = GenomeStore()
    store.add_chromosome(
        "chrA", rng.choice(list(b"ACGT"), size=15000).astype(np.uint8))
    store.finalize()
    sim = simulate_reads(store, 6, 1500, seed=2)
    reads = [make_read(n, s) for n, s, _ in sim]

    single = Aligner(cfg, store).align_batch(reads)
    meshed = Aligner(cfg, store, mesh=make_mesh(8)).align_batch(reads)
    assert single == meshed
    assert len(single) >= 4


def test_mesh_generic_scoring_identical(rng):
    """open-cheaper-than-extend scorings must route through the generic
    max-plus scan on the mesh lax path too (the prefix_gaps decision is
    resolved from concrete params before tracing _extend_step) — output
    must equal the single-device pipeline's."""
    cfg = Config()
    cfg.seed_size = 10
    cfg.dsoft_threshold = 20
    cfg.min_overlap = 400
    cfg.gap_open, cfg.gap_extend = -1, -5
    cfg.long_gap_open, cfg.long_gap_extend = -3, -9
    store = GenomeStore()
    store.add_chromosome(
        "chrA", rng.choice(list(b"ACGT"), size=12000).astype(np.uint8))
    store.finalize()
    sim = simulate_reads(store, 4, 1200, seed=12)
    reads = [make_read(n, s) for n, s, _ in sim]

    single = Aligner(cfg, store).align_batch(reads)
    meshed = Aligner(cfg, store, mesh=make_mesh(8)).align_batch(reads)
    assert single == meshed
    assert len(single) >= 2


def test_run_mesh_identical(rng, tmp_path):
    """The production entry point itself (pipeline.align.run / the CLI's
    backend) on an 8-device mesh must be byte-identical to mesh='off' —
    this is what a multi-GPU host runs by default."""
    import io

    from darwin_tpu.pipeline.align import run

    cfg = Config()
    cfg.seed_size = 10
    cfg.dsoft_threshold = 20
    cfg.min_overlap = 400
    store = GenomeStore()
    bases = rng.choice(list(b"ACGT"), size=12000).astype(np.uint8)
    store.add_chromosome("c1", bases)
    store.finalize()
    sim = simulate_reads(store, 5, 1200, seed=3)
    ref_fa = tmp_path / "ref.fa"
    reads_fa = tmp_path / "reads.fa"
    ref_fa.write_text(">c1\n" + bases.tobytes().decode() + "\n")
    reads_fa.write_text("".join(
        f">{n}\n{s.tobytes().decode()}\n" for n, s, _ in sim))

    err = io.StringIO()
    out1 = io.StringIO()
    run(str(ref_fa), str(reads_fa), False, cfg=cfg, out=out1, err=err,
        mesh="off")
    outm = io.StringIO()
    run(str(ref_fa), str(reads_fa), False, cfg=cfg, out=outm, err=err,
        mesh=8)
    assert out1.getvalue() == outm.getvalue()
    assert out1.getvalue().count("\n") >= 5
    # 'auto' on a CPU device fleet stays single-device (virtual devices
    # are a test construct, not chips)
    from darwin_tpu.pipeline.align import _resolve_mesh
    assert _resolve_mesh(None) is None
    assert _resolve_mesh("off") is None
    m = _resolve_mesh(8)
    assert m is not None and len(m.devices.flat) == 8
