"""Multi-device sharding of the alignment pipeline.

The reference is single-process (SURVEY.md section 2.4: no distributed
backend exists; the Bond ABI marks a host->accelerator seam).  Here the
scaling axes are:

* ``data`` — reads, and therefore tiles/anchors derived from them, shard
  across devices.  Every batched program (D-SOFT, first tiles, GACT
  extension rounds) is embarrassingly parallel over its batch dimension:
  each device runs the same fused round program on its slice of the
  request batch (``jax.shard_map``), with zero communication in the hot
  loop.
* the seed table and genome are replicated when they fit; hash-range
  sharding with all-to-all hit exchange (parallel/shard_index.py) serves
  tables beyond one device's memory.

All entry points here are mesh-agnostic: build a mesh with ``make_mesh`` (on
CPU tests an 8-device virtual mesh) and pass it in.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from darwin_tpu.ops import dispatch, gact


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shard_batch(mesh: Mesh, *arrays, axis: str = "data"):
    """Place arrays with their leading (batch) dim sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def replicate(mesh: Mesh, *arrays):
    sharding = NamedSharding(mesh, P())
    return tuple(jax.device_put(a, sharding) for a in arrays)


@functools.cache
def _mesh_program(mesh: Mesh, round_fn, static: tuple):
    """shard_map'd round program: each device runs ``round_fn`` (a fused
    round of ops/dispatch.py) on its local column slice of the packed
    request matrix, against the replicated sequence buffers.  Per-device
    speculation needs no communication, so the mesh path keeps the
    round-trip-amortizing chain the single-device path has."""
    kw = dict(static)
    cols = P(None, "data")

    def step(refc, qc, req):
        return round_fn(refc, qc, req, **kw)

    return jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P(), P(), cols),
                                 out_specs=cols, check_vma=False))


def _local0(arr):
    """Device-local view of a replicated mesh array (shard 0 is the full
    replica) — lets the tiny per-lane recovery programs run single-device
    without a host round trip or a cross-device copy."""
    try:
        return arr.addressable_data(0)
    except AttributeError:      # plain numpy input
        return arr


class MeshDispatcher:
    """Pipeline-facing dispatcher: replicates resident sequence buffers once
    and shards every per-round tile batch over the mesh.  Drop-in for the
    single-device dispatch functions (ops/dispatch.py)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = int(np.prod(list(mesh.shape.values())))

    def put_replicated(self, arr):
        return jax.device_put(arr, NamedSharding(self.mesh, P()))

    def _put_cols(self, req):
        return jax.device_put(req, NamedSharding(self.mesh, P(None, "data")))

    def pad(self, b: int) -> int:
        """Round a batch size up so every shard is non-empty and equal."""
        m = max(self.n, 8)
        return -(-b // m) * m

    def extend_tiles_async(self, ref_codes, query_codes, r_start, r_size,
                           q_start, q_size, rev, params, *, qt, rt,
                           max_tb, chain=None):
        """Extension round over the mesh; same contract as
        ops.dispatch.extend_tiles_async."""
        B = int(np.asarray(r_start).shape[0])
        ps, impl, K, stop_thr, bits, req, r_start64, q_start64 = \
            dispatch.round_setup(params, r_start, r_size, q_start, q_size,
                                 rev, qt, rt, max_tb, chain)
        static = dict(impl=impl, ps=ps, qt=qt, rt=rt, max_tb=max_tb,
                      stop_thr=stop_thr, K=K)
        step = _mesh_program(self.mesh, dispatch._extend_round,
                             tuple(sorted((static | {"bits": bits})
                                          .items())))
        packed_dev = step(ref_codes, query_codes, self._put_cols(req))

        def rerun_wide(idx):
            # per-lane recovery: gather only the flagged lanes into one
            # small single-device rerun with wide records — same pattern
            # as ops.dispatch.extend_tiles_async
            dispatch.RECOVERY["rerun_dispatches"] += 1
            dispatch.RECOVERY["rerun_lanes"] += len(idx)
            sub = dispatch._extend_round(
                _local0(ref_codes), _local0(query_codes),
                dispatch._subset_requests(req, idx), bits=16, **static)
            return sub, np.arange(len(idx))

        return dispatch._make_round_resolver(packed_dev, rerun_wide, B, K,
                                             qt, max_tb, r_start64,
                                             q_start64, bits)

    def first_tile_scores(self, ref_codes, query_codes, r_start, r_size,
                          q_start, q_size, params, *, qt, rt):
        """Filter-stage dispatch with the tile batch sharded: the fused
        filter program per device.  Returns the (3, B) device array."""
        ps = gact.static_params(params)
        step = _mesh_program(
            self.mesh, dispatch._first_tiles_round,
            (("impl", dispatch.tile_impl(ps, qt, rt)), ("ps", ps),
             ("qt", qt), ("rt", rt)))
        req = dispatch._pack_requests(r_start, r_size, q_start, q_size)
        return step(ref_codes, query_codes, self._put_cols(req))


def sharded_extend_tiles(mesh: Mesh, ref_codes, query_codes, r_start, r_size,
                         q_start, q_size, rev, params, *, qt, rt, max_tb):
    """One extension round with the tile batch sharded over the mesh and
    the sequence buffers replicated (the batch must divide evenly over the
    mesh).  Returns the resolved result dict."""
    md = MeshDispatcher(mesh)
    return md.extend_tiles_async(
        md.put_replicated(ref_codes), md.put_replicated(query_codes),
        r_start, r_size, q_start, q_size, rev, params, qt=qt, rt=rt,
        max_tb=max_tb)()
