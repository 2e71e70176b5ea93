"""Multi-device sharding: results must be bit-identical to single-device."""

import numpy as np
import jax
import jax.numpy as jnp

from darwin_tpu.config import Config
from darwin_tpu.ops import gact
from darwin_tpu.ops.dispatch import extend_tiles_async
from darwin_tpu.parallel.shard import make_mesh, sharded_extend_tiles


def test_sharded_extend_matches_single(rng):
    assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
    cfg = Config()
    params = gact.make_params(cfg)
    B, qt, rt = 16, 48, 48
    ref = rng.integers(0, 4, size=2048).astype(np.uint8)
    qry = rng.integers(0, 4, size=1024).astype(np.uint8)
    r_start = rng.integers(0, 2048 - rt, size=B).astype(np.int32)
    r_size = rng.integers(1, rt + 1, size=B).astype(np.int32)
    q_start = rng.integers(0, 1024 - qt, size=B).astype(np.int32)
    q_size = rng.integers(1, qt + 1, size=B).astype(np.int32)
    rev = (np.arange(B) % 2 == 1)

    single = extend_tiles_async(jnp.asarray(ref), jnp.asarray(qry),
                                r_start, r_size, q_start, q_size, rev,
                                params, qt=qt, rt=rt, max_tb=2 * qt)()
    mesh = make_mesh(8)
    shard = sharded_extend_tiles(mesh, ref, qry, r_start, r_size, q_start,
                                 q_size, rev, params, qt=qt, rt=rt,
                                 max_tb=2 * qt)
    for k in ("score", "n_ops", "q_steps", "r_steps", "ops"):
        np.testing.assert_array_equal(np.asarray(single[k]),
                                      np.asarray(shard[k]), err_msg=k)
