"""CUDA tile kernels for NVIDIA Hopper, called from JAX through the XLA FFI.

The kernels (native/gact_cuda.cu) implement the tile interface of the fused
dispatch rounds (ops/dispatch.py) — ``filter_scores`` and
``extend_records`` — with the same results as the plain XLA implementation
in ops/gact.py, bit for bit.  One warp aligns one tile with the DP state in
registers; see the source file's header for the design.

The library is compiled from the repository's source with ``nvcc`` into
``native/build/`` on first use (or ahead of time with
``python -m darwin_tpu.ops.gact_cuda``); the file name carries a hash of
the source and flags, so a stale build is never loaded.  A failed build is
an error — there is no quiet switch to the plain path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "gact_cuda.cu")
_BUILD_DIR = os.path.join(_ROOT, "native", "build")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# query rows each lane of a warp holds; a tile of QT query rows takes the
# smallest R with 32 * R >= QT (the kernel is instantiated for these)
ROWS_PER_LANE = (4, 8, 12, 16)


def rows_per_lane(qt: int) -> int | None:
    for r in ROWS_PER_LANE:
        if 32 * r >= qt:
            return r
    return None


def supports(ps, qt: int, rt: int) -> bool:
    """Whether the kernels cover this tile shape and scoring (static
    params, gact.static_params).  They solve the within-column gap
    recurrence as a prefix max, exact only when opening a gap never costs
    less than extending it (gact._column_gaps_prefix), and keep at most
    32 * max(ROWS_PER_LANE) query rows in registers; the large escalation
    tiles and open-cheaper-than-extend scorings take the plain path."""
    _, go, ge, goL, geL = ps
    return go <= ge and goL <= geL and rows_per_lane(qt) is not None


def _scoring(ps) -> np.ndarray:
    sub, go, ge, goL, geL = ps
    return np.array([v for row in sub for v in row] + [go, ge, goL, geL],
                    np.int32)


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA tile kernels are built "
                       "from native/gact_cuda.cu with the CUDA toolkit")


def library_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_ARCH + _FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libgact_cuda-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the kernel library (if this source has no build yet) and
    return its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ([_nvcc()] + _ARCH + _FLAGS
           + ["-I", jax.ffi.include_dir(), "-o", tmp, _SRC])
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed:\n{' '.join(cmd)}\n"
                           f"{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def _register():
    lib = ctypes.CDLL(build())
    for name, sym in (("darwin_gact_filter", lib.GactFilter),
                      ("darwin_gact_extend", lib.GactExtend)):
        jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(sym),
                                    platform="CUDA")
    return lib


def filter_result_shapes(B: int):
    return [jax.ShapeDtypeStruct((B,), jnp.int32)] * 3


def extend_result_shapes(B: int, qt: int, rt: int):
    """score, records (RT, B), q_steps, r_steps, and the trace scratch
    (B, RT, 32 * R) the walk reads."""
    i32 = jnp.int32
    return [jax.ShapeDtypeStruct((B,), i32),
            jax.ShapeDtypeStruct((rt, B), i32),
            jax.ShapeDtypeStruct((B,), i32),
            jax.ShapeDtypeStruct((B,), i32),
            jax.ShapeDtypeStruct((B, rt, 32 * rows_per_lane(qt)), jnp.uint8)]


def filter_scores(qtile, rtile, qlens, rlens, ps):
    """Max-cell DP without trace.  Returns (score, query_max_pos,
    ref_max_pos), each (B,) int32."""
    _register()
    B, qt = qtile.shape
    out = jax.ffi.ffi_call("darwin_gact_filter", filter_result_shapes(B))(
        qtile, rtile, qlens.astype(jnp.int32), rlens.astype(jnp.int32),
        jnp.asarray(_scoring(ps)), rows_per_lane=np.int64(rows_per_lane(qt)))
    return tuple(out)


def extend_records(qtile, rtile, qlens, rlens, ps, max_tb):
    """End-cell DP + traceback records.  Returns (score, rec (RT, B) int32,
    q_steps, r_steps) — gact.extend_records' contract."""
    _register()
    B, qt = qtile.shape
    rt = rtile.shape[1]
    score, rec, qs, rs, _ = jax.ffi.ffi_call(
        "darwin_gact_extend", extend_result_shapes(B, qt, rt))(
        qtile, rtile, qlens.astype(jnp.int32), rlens.astype(jnp.int32),
        jnp.asarray(_scoring(ps)), rows_per_lane=np.int64(rows_per_lane(qt)),
        max_tb=np.int64(max_tb))
    return score, rec, qs, rs


if __name__ == "__main__":
    print(build())
