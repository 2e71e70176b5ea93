"""CLI matching the reference binary's interface
(software/main.cpp:168-171):

    python -m darwin_tpu.cli <REFERENCE>.fasta <READS>.fasta <OVERLAP 0|1>

Reads ``params.cfg`` from the current directory when present (same INI
schema as the reference); results on stdout, progress/counters on stderr.
"""

from __future__ import annotations

import os
import sys

from darwin_tpu.config import Config, load_config
from darwin_tpu.pipeline.align import enable_compile_cache, run


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    index_cache = None
    profile_dir = None
    layout = None     # accept a cached table's layout; build pairs anew
    mesh = None       # auto: all local GPUs (align._resolve_mesh)
    shard_index = False
    rest = []
    for a in argv:
        if a.startswith("--index-cache="):
            index_cache = a.split("=", 1)[1]
        elif a.startswith("--mesh="):
            v = a.split("=", 1)[1]
            mesh = v if v in ("auto", "off") else int(v)
        elif a == "--shard-index":
            shard_index = True
        elif a.startswith("--index-layout="):
            layout = a.split("=", 1)[1]
            if layout not in ("pairs", "csr"):
                print(f"unknown index layout {layout!r}", file=sys.stderr)
                return 1
        elif a.startswith("--profile="):
            profile_dir = a.split("=", 1)[1]
        else:
            rest.append(a)
    enable_compile_cache()
    if len(rest) < 3:
        print("Usage: python -m darwin_tpu.cli <REFERENCE>.fasta "
              "<READS>.fasta OVERLAP(0/1) [--index-cache=FILE.npz] "
              "[--index-layout=pairs|csr] [--mesh=auto|off|N] "
              "[--shard-index] "
              "[--profile=DIR]", file=sys.stderr)
        return 1
    ref_path, reads_path, overlap = rest[0], rest[1], bool(int(rest[2]))
    if os.path.exists("params.cfg"):
        print("Reading configuration ...", file=sys.stderr)
        cfg = load_config("params.cfg", do_overlap=overlap)
    else:
        cfg = Config()
        cfg.do_overlap = overlap
    if profile_dir:
        import jax
        ctx = jax.profiler.trace(profile_dir)
    else:
        import contextlib
        ctx = contextlib.nullcontext()
    with ctx:
        run(ref_path, reads_path, overlap, cfg=cfg,
            index_cache=index_cache, index_layout=layout,
            mesh=mesh, shard_index=shard_index)
    return 0


if __name__ == "__main__":
    sys.exit(main())
