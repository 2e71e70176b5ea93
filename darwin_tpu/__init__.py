"""darwin_tpu — a long-read aligner on an accelerator, written in JAX.

A from-scratch JAX/XLA implementation of the full D-SOFT -> GACT
alignment pipeline pioneered by Darwin (ASPLOS'18; reference C++/AVX2
implementation surveyed in SURVEY.md).  The compute path (minimizer
extraction, seed-table build, D-SOFT bin-count seeding, batched GACT tile
dynamic programming and traceback) runs as batched, statically-shaped XLA
programs on the device (an NVIDIA GPU; the CPU for tests); the
orchestration (extension state machine, output assembly) runs on the host
over *large* device batches.

Layout:
  config    — params.cfg-compatible configuration
  genome    — sequence store + chromosome registry (replaces DRAM/Index)
  io        — FASTA reading, SAM/MHAP output
  index     — minimizer extraction + seed position table (device build)
  seeding   — D-SOFT seeding / anchor selection / chaining
  ops       — GACT tile DP (plain XLA + CUDA kernels) + traceback + oracles
  pipeline  — filter / extender / printer stages and the end-to-end driver
  parallel  — device-mesh sharding of the batched kernels
"""

__version__ = "0.1.0"

from darwin_tpu.config import Config, load_config  # noqa: F401
