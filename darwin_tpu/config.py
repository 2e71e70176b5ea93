"""Configuration for the aligner.

Reads the same INI schema as the reference's ``params.cfg``
(sections ``[GACT_scoring] [DSOFT_params] [GACT_first_tile] [GACT_extend]
[Multithreading] [FPGA]``; reference parser: software/ConfigFile.cpp:19-70,
values consumed at software/main.cpp:183-230).  Defaults below mirror the
bundled params.cfg (software/params.cfg:1-48).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Config:
    # --- [GACT_scoring] ---
    # Upper-triangle substitution matrix in the reference's order:
    # [AA, AC, AG, AT, CC, CG, CT, GG, GT, TT, N]
    # (software/main.cpp:183-197)
    gact_sub_mat: List[int] = dataclasses.field(
        default_factory=lambda: [2, -6, -6, -6, 2, -6, -6, 2, -6, 2, -1]
    )
    gap_open: int = -4
    gap_extend: int = -2
    long_gap_open: int = -25
    long_gap_extend: int = -1

    # --- [DSOFT_params] ---
    seed_size: int = 14          # k
    minimizer_window: int = 3    # w
    bin_size: int = 64
    dsoft_threshold: int = 26
    num_seeds: int = 1000        # N: index after which stride kicks in
    seed_occurence_multiple: int = 40
    max_candidates: int = 1000   # dead in the reference (never enforced,
                                 # software/seed_pos_table.cpp:369 with a
                                 # counter that is never incremented)
    max_stride: int = 4
    do_overlap: bool = False

    # --- [GACT_first_tile] ---
    first_tile_size: int = 128
    first_tile_score_threshold: int = 60
    first_tile_batch_size: int = 64
    slope_threshold: float = 0.05
    min_overlap: int = 1000

    # --- [GACT_extend] ---
    tile_size: int = 384
    tile_overlap: int = 64
    batch_size: int = 2          # reference's slot count; kept only to
                                 # reproduce the reference's output emission
                                 # order (see pipeline/extend.py)

    # --- [Multithreading] ---
    num_threads: int = 48

    # --- [FPGA] ---
    # The reference's pluggable-kernel hook (a DLL path selecting the
    # accelerator implementation, software/main.cpp:237-255).  Here the
    # analogous knob selects the tile kernel: "" = the platform's default
    # (the CUDA kernels on a GPU, plain XLA on the CPU), "lax" or "cuda" to
    # force one (ops/dispatch.py::KERNELS).
    processor_library: str = ""

    # --- device knobs (no reference equivalent) ---
    # Device batch of tiles per GACT dispatch (the reference's batch of 2 is
    # a CPU artifact; an accelerator wants hundreds of tiles per launch,
    # SURVEY.md section 2.3 item 5).
    device_tile_batch: int = 512
    # Concurrent extensions managed by the host extension loop.
    extension_lanes: int = 512
    # Max positions gathered per seed bucket; buckets larger than
    # kmer_max_occurence are skipped entirely (software/seed_pos_table.cpp:314),
    # so this only needs to be >= kmer_max_occurence.
    max_bucket_occupancy: Optional[int] = None

    # Large-tile geometry (hard-coded in the reference,
    # software/extender.cpp:70-76).
    large_tile_long: int = 1984
    large_tile_short: int = 960

    @property
    def sub_matrix_5x5(self):
        """Full 5x5 (A,C,G,T,N) substitution matrix.

        Expansion identical to InitializeScoringParams
        (software/Processor.cpp:50-74): symmetric 4x4 from the upper
        triangle, N row/column = sub_N.
        """
        s = self.gact_sub_mat
        aa, ac, ag, at, cc, cg, ct, gg, gt, tt, n = s
        return [
            [aa, ac, ag, at, n],
            [ac, cc, cg, ct, n],
            [ag, cg, gg, gt, n],
            [at, ct, gt, tt, n],
            [n, n, n, n, n],
        ]

    def kmer_max_occurence(self, ref_length: int) -> int:
        """software/seed_pos_table.cpp:55."""
        return self.seed_occurence_multiple * (
            1 + (ref_length >> (2 * self.seed_size))
        )


def _parse_ini(path: str) -> dict:
    """Minimal INI parser matching ConfigFile semantics
    (software/ConfigFile.cpp:19-44): '[section]', 'key = value',
    '#'/';'-prefixed comments, whitespace-trimmed."""
    values = {}
    section = ""
    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith(";") or line.startswith("//"):
                continue
            if line.startswith("[") and line.endswith("]"):
                section = line[1:-1].strip()
                continue
            if "=" not in line:
                continue
            key, _, val = line.partition("=")
            values[(section, key.strip())] = val.strip()
    return values


def load_config(path: str = "params.cfg", do_overlap: bool = False) -> Config:
    """Load a params.cfg-format file into a Config (software/main.cpp:183-230)."""
    v = _parse_ini(path)
    cfg = Config()

    def geti(section, key, default):
        raw = v.get((section, key))
        return default if raw is None else int(float(raw))

    def getf(section, key, default):
        raw = v.get((section, key))
        return default if raw is None else float(raw)

    sub_keys = ["sub_AA", "sub_AC", "sub_AG", "sub_AT", "sub_CC", "sub_CG",
                "sub_CT", "sub_GG", "sub_GT", "sub_TT", "sub_N"]
    cfg.gact_sub_mat = [geti("GACT_scoring", k, d)
                        for k, d in zip(sub_keys, cfg.gact_sub_mat)]
    cfg.gap_open = geti("GACT_scoring", "gap_open", cfg.gap_open)
    cfg.gap_extend = geti("GACT_scoring", "gap_extend", cfg.gap_extend)
    cfg.long_gap_open = geti("GACT_scoring", "long_gap_open", cfg.long_gap_open)
    cfg.long_gap_extend = geti("GACT_scoring", "long_gap_extend", cfg.long_gap_extend)

    cfg.seed_size = geti("DSOFT_params", "seed_size", cfg.seed_size)
    cfg.minimizer_window = geti("DSOFT_params", "minimizer_window", cfg.minimizer_window)
    cfg.bin_size = geti("DSOFT_params", "bin_size", cfg.bin_size)
    cfg.dsoft_threshold = geti("DSOFT_params", "threshold", cfg.dsoft_threshold)
    cfg.num_seeds = geti("DSOFT_params", "num_seeds", cfg.num_seeds)
    cfg.seed_occurence_multiple = geti(
        "DSOFT_params", "seed_occurence_multiple", cfg.seed_occurence_multiple)
    cfg.max_candidates = geti("DSOFT_params", "max_candidates", cfg.max_candidates)
    cfg.max_stride = geti("DSOFT_params", "max_stride", cfg.max_stride)

    cfg.first_tile_size = geti("GACT_first_tile", "first_tile_size", cfg.first_tile_size)
    cfg.first_tile_score_threshold = geti(
        "GACT_first_tile", "first_tile_score_threshold", cfg.first_tile_score_threshold)
    cfg.first_tile_batch_size = geti(
        "GACT_first_tile", "first_tile_batch_size", cfg.first_tile_batch_size)
    cfg.slope_threshold = getf("GACT_first_tile", "slope_threshold", cfg.slope_threshold)
    cfg.min_overlap = geti("GACT_first_tile", "min_overlap", cfg.min_overlap)

    cfg.tile_size = geti("GACT_extend", "tile_size", cfg.tile_size)
    cfg.tile_overlap = geti("GACT_extend", "tile_overlap", cfg.tile_overlap)
    cfg.batch_size = geti("GACT_extend", "batch_size", cfg.batch_size)

    cfg.num_threads = geti("Multithreading", "num_threads", cfg.num_threads)

    cfg.processor_library = v.get(("FPGA", "processor_library"),
                                  cfg.processor_library)

    cfg.do_overlap = do_overlap
    return cfg
