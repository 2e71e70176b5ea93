"""Multi-host execution (jax.distributed).

The reference is strictly single-process (SURVEY.md section 2.4 — no
MPI/NCCL/sockets; its only seam is the host->FPGA Bond ABI).  The multi-host
equivalent scales over *hosts* the same way the device path scales over
devices: the read stream is the data axis.

Design (scaling-book style: pick a mesh, shard the batch, keep the hot
loop communication-free):

* every host loads the reference FASTA and builds (or mmap-loads) the seed
  table locally — the index is replicated, deterministic, and cheaper to
  rebuild than to broadcast;
* the read stream is sharded across processes in contiguous blocks
  (``shard_reads``) so each host's SAM/MHAP lines are a contiguous slice
  of the single-process output;
* each host runs the full local pipeline over its local devices (one
  ``Mesh`` over ``jax.local_devices()``), writing its own output shard;
  rank 0 concatenates shards in rank order, which reproduces the
  single-process output exactly (``merge_shards``).

No collectives are needed in the alignment loop; counter reduction at the
end uses a tiny psum (``reduce_counters``).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> tuple[int, int]:
    """Initialize jax.distributed (no-op on a single process).  Returns
    (process_id, num_processes)."""
    import jax

    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    return jax.process_index(), jax.process_count()


def shard_reads(n_reads: int, process_id: int, num_processes: int
                ) -> tuple[int, int]:
    """Contiguous block of the read stream owned by this process:
    [start, stop).  Blocks differ in size by at most one read."""
    base, extra = divmod(n_reads, num_processes)
    start = process_id * base + min(process_id, extra)
    stop = start + base + (1 if process_id < extra else 0)
    return start, stop


def shard_path(out_path: str, process_id: int) -> str:
    return f"{out_path}.shard{process_id:05d}"


def merge_shards(out_path: str, num_processes: int, delete: bool = True):
    """Rank-0 concatenation of per-host output shards, in rank order =
    read order = the single-process output order.  SAM header lines ('@')
    are kept only from the first shard that has them."""
    with open(out_path, "wb") as out:
        header_written = False
        for p in range(num_processes):
            sp = shard_path(out_path, p)
            wrote_header_here = False
            with open(sp, "rb") as f:
                for line in f:
                    if line.startswith(b"@"):
                        if header_written and not wrote_header_here:
                            continue
                        wrote_header_here = True
                    out.write(line)
            header_written = header_written or wrote_header_here
            if delete:
                os.remove(sp)


def reduce_counters(counters: dict) -> dict:
    """Global sums of the per-run work counters across processes
    (allgather on the replicated mesh + int64 host sum); returns python
    ints."""
    import jax
    import jax.experimental.multihost_utils as mhu

    if jax.process_count() == 1:
        return dict(counters)
    keys = sorted(counters)
    # x64-disabled jax would truncate int64/float64 transport, so ship
    # each counter as (hi, lo) int32 30-bit limbs and recombine on host —
    # exact for counters up to 2^60
    vals = np.asarray([counters[k] for k in keys], np.int64)
    local = np.stack([(vals >> 30).astype(np.int32),
                      (vals & ((1 << 30) - 1)).astype(np.int32)])
    total = np.asarray(mhu.process_allgather(local), np.int64)
    summed = (total[:, 0] << 30).sum(axis=0) + total[:, 1].sum(axis=0)
    return {k: int(v) for k, v in zip(keys, summed)}


def run_multihost(ref_path: str, reads_path: str, do_overlap: bool,
                  out_path: str, cfg=None, err=None,
                  coordinator_address: str | None = None,
                  num_processes: int | None = None,
                  process_id: int | None = None,
                  index_cache: str | None = None,
                  index_layout: str | None = None) -> dict:
    """Full distributed run: shard reads across hosts, align locally,
    merge shards on rank 0 (+ allgathered global counters).  With
    num_processes=None/1 this degrades to the single-process
    ``pipeline.align.run``.  Returns this host's counter dict."""
    import sys

    from darwin_tpu.io.fasta import count_reads
    from darwin_tpu.pipeline import align as align_mod

    err = err or sys.stderr
    pid, nproc = init(coordinator_address, num_processes, process_id)

    n_reads = count_reads(reads_path)        # one cheap streaming pass
    start, stop = shard_reads(n_reads, pid, nproc)
    print(f"[host {pid}/{nproc}] reads [{start}, {stop})", file=err)

    # each host streams its index slice of the ORIGINAL reads file
    # (FASTA or FASTQ, bounded memory — no temp re-serialization)
    local_out = shard_path(out_path, pid) if nproc > 1 else out_path
    with open(local_out, "w") as out:
        counters = align_mod.run(ref_path, reads_path, do_overlap, cfg=cfg,
                                 out=out, err=err, index_cache=index_cache,
                                 reads_range=(start, stop),
                                 index_layout=index_layout)

    if nproc > 1:
        import jax.experimental.multihost_utils as mh
        total = reduce_counters(counters)
        mh.sync_global_devices("darwin_tpu_output_shards")
        if pid == 0:
            merge_shards(out_path, nproc)
            print("global counters: "
                  + " ".join(f"{k}={total[k]}" for k in sorted(total)),
                  file=err)
    return counters
