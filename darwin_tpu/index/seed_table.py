"""Seed position table: k-mer hash -> sorted reference positions.

Replaces the reference's CSR bucket table (SeedPosTable,
software/seed_pos_table.cpp:40-240).  The reference materializes a
4^k+1-entry bucket-offset array (~1 GiB at k=14); we instead keep the
emitted (hash, position) pairs sorted by (hash, position) and resolve bucket
ranges with a vectorized binary search at query time — identical bucket
contents and identical ascending position order (the reference's parallel
scatter is order-nondeterministic but each queried bucket is then sorted by
position, software/seed_pos_table.cpp:166-174), at a fraction of the HBM
footprint.

Buckets with occupancy > kmer_max_occurence are *kept* but skipped at query
time, exactly like the reference (skip at software/seed_pos_table.cpp:314;
kmer_max_occurence = seed_occurence_multiple * (1 + ref_len >> 2k), :55).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from darwin_tpu.genome import GenomeStore
from darwin_tpu.index.minimizers import (build_csr_streaming,
                                         minimizer_scan,
                                         scan_many_minimizers,
                                         scan_sorted_pairs_device,
                                         scan_sorted_pairs_streaming)

def _is_oom(e: BaseException) -> bool:
    """Device/host out-of-memory test for the lossless build fallbacks.

    Narrowed to the runtime error types that actually carry OOM (the JAX
    backend's XlaRuntimeError / jaxlib errors and host MemoryError) so an
    unrelated exception whose chained message happens to mention
    RESOURCE_EXHAUSTED is not silently masked behind a slow rebuild."""
    if isinstance(e, MemoryError):
        return True
    name = type(e).__name__
    if name not in ("XlaRuntimeError", "JaxRuntimeError", "RuntimeError"):
        return False
    msg = str(e)
    return "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg


def _csr_hint(k: int) -> str:
    """Actionable advice for memory-exhausted pairs builds: csr only exists
    for 2k <= 28 (the 4^k offset array), so do not send k=15 users into a
    ValueError."""
    if 2 * k <= 28:
        return "  Consider --index-layout csr for genomes this large."
    return ("  (csr layout needs seed_size <= 14; at this k the host "
            "build, build_seed_table(method='host'), needs no device "
            "memory for the sort.)")


def device_build_max_bases() -> int:
    """All-candidates device build gate: the on-device pair sort transiently
    holds ~8 bytes per SCANNED position, so the gate grants it 1/32 of the
    device's memory (bytes_limit / 32 positions = a quarter of the
    memory); past it the streaming build takes over (~8 bytes per EMITTED
    seed — scan_sorted_pairs_streaming).  Devices that report no memory
    limit (the CPU) keep 512 Mi bases.  Sharded builds for tables beyond
    one device route through parallel/shard_index."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return max(512 << 20, limit // 32) if limit else 512 << 20


@dataclasses.dataclass
class SeedTable:
    """Two on-device layouts, same bucket contents and in-bucket order:

    * pairs (default): ``sorted_hashes`` + ``positions``, 8 B/seed; bucket
      ranges resolved by (LUT-accelerated) binary search at query time.
    * csr: ``bucket_offsets`` (4^k + 1 int32, ~1 GiB at k = 14) +
      ``positions``, ~4 B/seed; bucket ranges are two direct gathers.
      ``sorted_hashes`` is None.  This is the reference's own CSR shape
      (software/seed_pos_table.cpp:40-240) and what fits the default
      w = 3 index of a 3.2 Gbp genome beside it on one 16 GB chip.
    """
    sorted_hashes: jnp.ndarray | None  # (N,) uint32, ascending (pairs)
    positions: jnp.ndarray       # (N,) uint32, ascending within equal hash
    kmer_size: int
    minimizer_window: int
    ref_size: int                # full coordinate-space size (incl. guard)
    kmer_max_occurence: int
    bucket_offsets: jnp.ndarray | None = None  # (4^k + 1,) int32 (csr)
    # Prefix LUT accelerating bucket range lookups: lut[p] = first table
    # index whose hash has top-bit prefix >= p (size 2^bits + 1).  Queries
    # then binary-search only inside their prefix range (lut_steps
    # iterations instead of log2(N)); see dsoft._bucket_ranges.  Built
    # lazily — absent on hash-range shards, which use plain searchsorted.
    prefix_lut: jnp.ndarray | None = None
    lut_shift: int = 0
    lut_steps: int = 0
    # memoized host copy of sorted_hashes for is_present (lazy)
    _hashes_host: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def num_seeds(self) -> int:
        return int(self.positions.shape[0])

    def ensure_lut(self, bits: int = 22):
        """Build the prefix LUT on device (idempotent, ~one searchsorted).

        hash32 values are masked to 2k <= 30 bits, so hashes and prefix
        bounds are safely compared as int32.
        """
        if (self.prefix_lut is not None or self.num_seeds == 0
                or self.bucket_offsets is not None):
            return self         # csr needs no search acceleration
        # scale the LUT to the table (a few entries per seed is plenty);
        # 2^22+1 int32 = 16 MB caps the footprint for huge tables
        bits = min(bits, 2 * self.kmer_size,
                   max(8, int(np.ceil(np.log2(self.num_seeds + 1))) + 2))
        self.lut_shift = 2 * self.kmer_size - bits
        # lut[p] = first index with hash >= (p << shift); row 2^bits is the
        # global upper bound
        bound = jnp.arange((1 << bits) + 1,
                           dtype=jnp.int32) << self.lut_shift
        lut = jnp.searchsorted(self.sorted_hashes.astype(jnp.int32),
                               bound, side="left").astype(jnp.int32)
        max_range = int(jnp.max(lut[1:] - lut[:-1]))
        self.prefix_lut = lut
        self.lut_steps = max(int(np.ceil(np.log2(max_range + 1))), 1) + 1
        return self

    def is_present(self, kmer_hash: int) -> bool:
        """Whether the bucket for this minimizer hash is usable: non-empty
        and within the occupancy cap (SeedPosTable::IsPresent,
        software/seed_pos_table.h:537-569 / seed_pos_table.cpp:242-250).
        The host copy of the hash table is memoized so repeated queries are
        O(log N) like the reference's, not an O(N) device fetch each.  The
        csr layout answers with one two-element device gather instead (the
        1 GiB offset array is not worth a host copy)."""
        if self.bucket_offsets is not None:
            lo, hi = (int(x) for x in np.asarray(
                self.bucket_offsets[jnp.array([kmer_hash, kmer_hash + 1])]))
            return 0 < hi - lo <= self.kmer_max_occurence
        h = self._hashes_host
        if h is None:
            h = self._hashes_host = np.asarray(self.sorted_hashes)
        lo = int(np.searchsorted(h, kmer_hash, side="left"))
        hi = int(np.searchsorted(h, kmer_hash, side="right"))
        return 0 < hi - lo <= self.kmer_max_occurence

    def save(self, path: str):
        """Persist the index (no reference equivalent — the reference
        rebuilds from FASTA every run; SURVEY.md section 5 'checkpoint')."""
        arrays = {
            "positions": np.asarray(self.positions),
            "meta": np.array([self.kmer_size, self.minimizer_window,
                              self.ref_size, self.kmer_max_occurence],
                             dtype=np.int64),
        }
        if self.bucket_offsets is not None:
            arrays["offsets"] = np.asarray(self.bucket_offsets)
        else:
            arrays["hashes"] = np.asarray(self.sorted_hashes)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "SeedTable":
        z = np.load(path)
        k, w, ref_size, maxocc = (int(x) for x in z["meta"])
        return cls(
            sorted_hashes=(jnp.asarray(z["hashes"])
                           if "hashes" in z else None),
            positions=jnp.asarray(z["positions"]),
            kmer_size=k, minimizer_window=w,
            ref_size=ref_size, kmer_max_occurence=maxocc,
            bucket_offsets=(jnp.asarray(z["offsets"])
                            if "offsets" in z else None),
        )


def build_seed_table(store: GenomeStore, cfg,
                     method: str | None = None,
                     layout: str = "pairs") -> SeedTable:
    """Build the table from a finalized GenomeStore.

    Mirrors the index phase (software/main.cpp:307-509): per-chromosome
    minimizer scans (emission state resets per chromosome), positions are
    absolute coordinates (local p + chromosome start, software/main.cpp:340).

    method: None = auto (all-candidates device build under the gate,
    streaming device build past it); "host" forces the numpy argsort path
    (identity oracle for tests); "stream" forces the streaming build.
    layout: "pairs" (default) or "csr" — see SeedTable.  "csr" builds the
    bucket-offset table directly (two streaming device passes, ~half the
    resident HBM and no 8 B/seed sort transient); requires k <= 14.
    """
    k, w = cfg.seed_size, cfg.minimizer_window
    assert 3 < k <= 15, "reference constraint (software/main.cpp:310-311)"
    if layout not in ("pairs", "csr"):
        raise ValueError(f"unknown index layout {layout!r}")
    if layout == "csr":
        if method is not None:
            raise ValueError(
                "csr has a single (streaming device) build; the method "
                "parameter selects among pairs builds only")
        if 2 * k > 28:
            raise ValueError(
                f"csr layout supports seed_size <= 14 (the 4^{k} "
                "bucket-offset array would exceed 1 GiB); use the "
                "pairs layout")
        # codes2 slots are None: with a resident packed genome the row
        # batches gather on device, and materializing store.codes2 per
        # chromosome was a full-genome host encode each (seqs carry only
        # lengths + global starts)
        seqs = [(None, c.length_unpadded, c.start)
                for c in store.chromosomes]
        # the provider packs/uploads the genome in pieces ON DEMAND as the
        # count pass consumes row batches — host pack, host->device
        # transfer and the device count scan overlap as a 3-stage stream
        # instead of serializing
        from darwin_tpu.ops.packed import device_packed_streaming
        provider = device_packed_streaming(store)
        offsets, positions, _n, _stats = build_csr_streaming(
            seqs, k, w, packed_dev=provider)
        provider(None)   # complete the upload + memoize store._packed_dev
        return SeedTable(
            sorted_hashes=None,
            positions=positions,
            kmer_size=k,
            minimizer_window=w,
            ref_size=store.size,
            kmer_max_occurence=cfg.kmer_max_occurence(store.size),
            bucket_offsets=offsets,
        )
    # Fixed-shape chunked scan over ALL chromosomes as one work list: one
    # compiled program regardless of chromosome count/lengths, and short
    # sequences (overlap mode indexes every read as a chromosome) share
    # dispatches instead of paying one device call each.
    #
    # Device path: scan, (hash, pos) pair emission and the final sort all
    # stay on device — no per-position transfer or host argsort.  Its
    # transient HBM is ~8 B per scanned position, so genomes past the gate
    # (or hosts without an accelerator worth the upload) take the host path
    # with identical output order (unique keys: stable argsort over
    # (hash << 32 | pos) == lexicographic (hash, pos) sort).
    if method is None:
        method = ("device" if 0 < store.size <= device_build_max_bases()
                  else "stream" if store.size > 0 else "host")
    if method in ("device", "stream"):
        # codes2 slots unused when rows gather from the packed genome
        seqs = [(None, c.length_unpadded, c.start)
                for c in store.chromosomes]
        from darwin_tpu.ops.packed import device_packed_streaming
        packed_dev = device_packed_streaming(store)
        try:
            if method == "device":
                sh, sp = scan_sorted_pairs_device(seqs, k, w,
                                                  packed_dev=packed_dev)
            else:
                # streaming build: ~8 B of HBM per emitted seed; the cap is
                # an estimate (expected minimizer density 2/(w+1)) with a
                # lossless doubling retry — repeat-heavy genomes emit up
                # to ~1/w
                cap = int(store.size * 2.4 / (w + 1)) + (1 << 22)
                while True:
                    sh, sp, n = scan_sorted_pairs_streaming(
                        seqs, k, w, cap, packed_dev=packed_dev)
                    if n >= 0:
                        break
                    cap = max(2 * cap, -n + (1 << 22))
            packed_dev(None)   # complete upload + memoize store._packed_dev
            return SeedTable(
                sorted_hashes=sh,
                positions=sp,
                kmer_size=k,
                minimizer_window=w,
                ref_size=store.size,
                kmer_max_occurence=cfg.kmer_max_occurence(store.size),
            )
        except Exception as e:
            if not _is_oom(e):
                raise
            raise RuntimeError(
                "[darwin_tpu] the device seed-table build exhausted device "
                f"memory ({store.size} bases, method={method})."
                f"{_csr_hint(k)}") from e
    all_hashes = []
    all_pos = []
    # the full-genome host encode happens ONLY here, on the host path —
    # the device/stream builds above gather from the packed genome
    codes2 = store.codes2
    seqs = [(codes2[c.start:c.start + c.length], c.length_unpadded)
            for c in store.chromosomes]
    scans = scan_many_minimizers(seqs, k, w)
    for chrom, (p, h) in zip(store.chromosomes, scans):
        all_hashes.append(h)
        all_pos.append((p + chrom.start).astype(np.uint32))
    hashes = np.concatenate(all_hashes) if all_hashes else np.zeros(0, np.uint32)
    pos = np.concatenate(all_pos) if all_pos else np.zeros(0, np.uint32)
    key = (hashes.astype(np.uint64) << np.uint64(32)) | pos.astype(np.uint64)
    order = np.argsort(key, kind="stable")
    try:
        # the resident table (8 B/seed) must still fit beside the genome;
        # turn an allocation failure into actionable advice
        # instead of a raw backend error escaping build_seed_table
        sh = jnp.asarray(hashes[order])
        sp = jnp.asarray(pos[order])
        import jax
        jax.block_until_ready((sh, sp))
    except Exception as e:
        if not _is_oom(e):
            raise
        raise RuntimeError(
            "[darwin_tpu] the seed table itself does not fit device memory "
            f"({hashes.size / 1e6:.0f} M seeds x 8 B beside the genome)."
            f"{_csr_hint(k)}  A hash-sharded index over a multi-chip mesh "
            "(Aligner(shard_index=True)) removes the single-device bound."
        ) from e
    return SeedTable(
        sorted_hashes=sh,
        positions=sp,
        kmer_size=k,
        minimizer_window=w,
        ref_size=store.size,
        kmer_max_occurence=cfg.kmer_max_occurence(store.size),
    )


def build_read_seed_table(reads, cfg,
                          layout: str = "pairs"
                          ) -> tuple[SeedTable, "GenomeStore"]:
    """Overlap (de-novo) mode: index the reads themselves.

    The reference runs the same index phase on the reads file passed as the
    'reference' argument (software/README.md:25-27 — overlap mode invokes
    Darwin with reads as both inputs).  We build a GenomeStore over the reads
    so coordinates/guards match.
    """
    store = GenomeStore()
    for r in reads:
        store.add_chromosome(r.name, r.seq)
    store.finalize()
    return build_seed_table(store, cfg, layout=layout), store
