"""Hash-range-sharded seed index (SURVEY.md §2.4 / §7 "index sharded by
k-mer-hash range across devices, candidate hits routed with collectives").

The replicated index is right whenever the table fits one device's memory
(yeast and human both do on one 80 GB GPU); this module is the scale-out
path for genomes whose (hash, position) table does not.  Design:

* the SeedTable's hash-sorted arrays shard by ROWS over the mesh's data
  axis — contiguous row ranges of a hash-sorted array ARE hash ranges, so
  `jax.device_put` with a `P("data")` sharding is the whole partitioner;
  each shard also carries its own prefix LUT so lookups use the same
  ranged bisect as the replicated path (dsoft._ranged_search);
* lookup runs where the data lives: every device resolves all reads'
  queried minimizers against its local slice with the flat ragged gather
  (dsoft._bucket_hits_flat — compact per-device hit buffers, not the
  worst-case padded layout), then hits route to the device that owns the
  READ with one tiled all_to_all (read-block split axis 0, hit concat
  axis 1), after which the bin-sort/count/anchor stage (shared
  `dsoft._hits_post`) runs read-sharded and communication-free;
* the global occupancy cap (kmer_max_occurence, seed_pos_table.cpp:314)
  needs the TOTAL bucket count — one psum over the (B, mq) count matrix;
* flat-buffer overflow reports per-read via a pmax'd n_flat_raw so the
  Seeder's retry loop works unchanged.

Tie-breaking: the reference stable-sorts hits by (bin<<32|offset) with
insertion order (minimizer ordinal, bucket slot) breaking ties.  Equal
(bin, offset) pairs always come from one minimizer's bucket, whose
positions concatenate in shard order = position order, so the sharded sort
is bit-identical to the replicated one (verified by test).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from darwin_tpu.seeding import dsoft as D

# Sentinel hash for shard-size padding rows: sorts after every valid hash
# in BOTH the uint32 and int32 domains (hash32 values are masked to
# 2k <= 30 bits, so 0x7FFFFFFF can never equal a query) — the per-shard
# ranged bisect compares in int32.
PAD_HASH = 0x7FFFFFFF


@dataclasses.dataclass
class ShardedSeedTable:
    hashes: jax.Array        # (Npad,) uint32, row-sharded over the mesh
    positions: jax.Array     # (Npad,) uint32, row-sharded
    lut: jax.Array           # (n_shards, L) int32 per-shard prefix LUTs
    lut_shift: int
    lut_steps: int
    n_shards: int


def shard_seed_table(table, mesh: Mesh, axis: str = "data",
                     lut_bits: int = 22) -> ShardedSeedTable:
    """Row-shard the seed table over the mesh and build one prefix LUT per
    shard (rows of a hash-sorted array = contiguous hash ranges)."""
    n = int(np.prod(list(mesh.shape.values())))
    N = table.num_seeds
    Npad = -(-max(N, 1) // n) * n
    hashes = np.asarray(table.sorted_hashes)
    pos = np.asarray(table.positions)
    if Npad != N:
        hashes = np.concatenate(
            [hashes, np.full(Npad - N, PAD_HASH, np.uint32)])
        pos = np.concatenate([pos, np.zeros(Npad - N, np.uint32)])
    per = Npad // n
    bits = min(lut_bits, 2 * table.kmer_size,
               max(8, int(np.ceil(np.log2(max(per, 1) + 1))) + 2))
    shift = 2 * table.kmer_size - bits
    bound = (np.arange((1 << bits) + 1, dtype=np.int64)
             << shift).astype(np.int64)
    luts = np.zeros((n, (1 << bits) + 1), np.int32)
    steps = 1
    for i in range(n):
        local = hashes[i * per:(i + 1) * per].astype(np.int64)
        luts[i] = np.searchsorted(local, bound, side="left").astype(np.int32)
        max_range = int(np.max(luts[i][1:] - luts[i][:-1], initial=1))
        steps = max(steps, int(np.ceil(np.log2(max_range + 1))) + 1)
    sh = NamedSharding(mesh, P(axis))
    sh2 = NamedSharding(mesh, P(axis, None))
    return ShardedSeedTable(
        hashes=jax.device_put(jnp.asarray(hashes), sh),
        positions=jax.device_put(jnp.asarray(pos), sh),
        lut=jax.device_put(jnp.asarray(luts), sh2),
        lut_shift=shift, lut_steps=steps, n_shards=n)


@functools.cache
def _sharded_fn(mesh: Mesh, axis: str, k, w, num_seeds, max_stride,
                overlap, threshold, bin_size, max_occ, mq_cap, a_cap,
                hit_cap, lut_shift, lut_steps):
    def step(codes2, lengths, hashes_l, pos_l, lut_l):
        offs, qhash, slot_ok = D._queried_minimizers(
            codes2, lengths, k, w, num_seeds, max_stride, overlap, mq_cap)
        start, end = D._bucket_ranges(hashes_l, qhash, lut_l[0],
                                      lut_shift, lut_steps)
        cnt_global = jax.lax.psum(end - start, axis)
        binf, offf, posf, _okf, bucket_ok, total = D._bucket_hits_flat(
            pos_l, offs, (start, end), cnt_global, slot_ok,
            max_occ, bin_size, hit_cap)
        # route hits to the read's owner: split the read axis, concatenate
        # the hit axis (source-device order = hash order).  Validity rides
        # the bin sentinel, so only three buffers cross the mesh.
        binf = jax.lax.all_to_all(binf, axis, 0, 1, tiled=True)
        offf = jax.lax.all_to_all(offf, axis, 0, 1, tiled=True)
        posf = jax.lax.all_to_all(posf, axis, 0, 1, tiled=True)
        # bucket_ok/total depend only on psum'd or local-to-the-source
        # values; reduce to per-read globals identical on every device,
        # then take this device's read slice
        nqb = jnp.sum(bucket_ok.astype(jnp.int32), axis=1)
        nqb = jax.lax.all_to_all(nqb[:, None], axis, 0, 1, tiled=True)[:, 0]
        # occupancy-cap telemetry (replicated: cnt_global is psum'd)
        ncap = jnp.sum((slot_ok & (cnt_global > max_occ)).astype(jnp.int32),
                       axis=1)
        ncap = jax.lax.all_to_all(ncap[:, None], axis, 0, 1,
                                  tiled=True)[:, 0]
        tot = jax.lax.pmax(total, axis)
        B = codes2.shape[0]
        nsh = jax.lax.psum(1, axis)
        me = jax.lax.axis_index(axis)
        tot = jax.lax.dynamic_slice_in_dim(tot, me * (B // nsh), B // nsh)
        res = D._hits_post(binf, offf, posf, nqb, k, threshold, a_cap,
                           D.sv_bins(bin_size, overlap))
        res["n_flat_raw"] = tot
        res["n_capped"] = ncap
        return res

    out_specs = {kk: P(axis) for kk in
                 ("hits_bin", "hits_off", "hits_pos", "n_hits", "anc_pos",
                  "anc_off", "anc_bin", "n_anchors", "n_anchors_raw",
                  "n_queried_buckets", "n_flat_raw", "n_capped")}
    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis, None)),
        out_specs=out_specs, check_vma=False))


def dsoft_sharded(mesh: Mesh, codes2, lengths, st: ShardedSeedTable,
                  *, k, w, num_seeds, max_stride, overlap, threshold,
                  bin_size, max_occ, mq_cap, a_cap, hit_cap,
                  axis: str = "data"):
    """Hash-sharded D-SOFT; same result contract as dsoft.dsoft_device
    with the hit width multiplied by the mesh size (each read's hits
    gather contributions from every shard).  hit_cap is the PER-SHARD flat
    buffer width; rows whose per-shard need exceeds it report the max in
    n_flat_raw for the caller's retry loop.  The read batch B must be a
    multiple of the mesh size."""
    fn = _sharded_fn(mesh, axis, k, w, num_seeds, max_stride, overlap,
                     threshold, bin_size, max_occ, mq_cap, a_cap, hit_cap,
                     st.lut_shift, st.lut_steps)
    return fn(jnp.asarray(codes2), jnp.asarray(lengths),
              st.hashes, st.positions, st.lut)
