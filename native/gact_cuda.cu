// GACT tile kernels for NVIDIA Hopper (sm_90a), called from JAX through the
// XLA FFI (darwin_tpu/ops/gact_cuda.py builds and registers this file).
//
// Same semantics as the plain XLA implementation in darwin_tpu/ops/gact.py
// (itself oracle-checked against ops/oracle.py, the specification distilled
// from the reference's DualAlignSIMD, software/Processor.cpp:164-716):
//
//   GactFilter  max-cell DP without trace (the filter stage's first tiles)
//   GactExtend  end-cell DP with 8-bit trace words + the serial traceback
//               walk folded into per-column records (ops/records.py)
//
// Design: one warp per tile, kWarpsPerBlock tiles per block.  Lane l holds
// query rows [l*R, l*R + R) in registers (R = QT/32 rounded up to a
// multiple of 4).  Per reference column:
//   1. a serial pass over the lane's rows computes the diagonal and the
//      gap-free candidates hp = max(dag, E, E_L), and the lane's maxima of
//      hp(j) - ge*j and hp(j) - geL*j;
//   2. two 5-step __shfl_up_sync max scans carry those maxima across lanes
//      (the within-column gap recurrence is an exact prefix max in the
//      prefix domain open <= extend, see gact._column_gaps_prefix);
//   3. a fix-up pass forms F, F_L, H, the trace word and the next E/E_L.
// The DP state never leaves registers; only trace bytes (coalesced, one
// 32*R-byte row per column and tile) and the per-tile results reach device
// memory.  The traceback walk (one lane per tile) reads the trace its own
// warp just wrote.  All arithmetic is int32 (max, +): results are
// bit-identical to the plain implementation.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 28);

// 8-bit trace word (ops/gact.py)
constexpr int T8_ZERO = 0, T8_DEL = 1, T8_INS = 2, T8_DEL_L = 3,
              T8_INS_L = 4, T8_DIAG = 5;
constexpr int E_OPEN8 = 8, F_OPEN8 = 16, EL_OPEN8 = 32, FL_OPEN8 = 64;
// traceback op codes (ops/oracle.py)
constexpr int OP_D = 2, OP_M = 3;

// exclusive max-scan across the warp, seeded with `identity`
__device__ __forceinline__ int warp_excl_max(int x, int lane, int identity) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = max(x, y);
  }
  int ex = __shfl_up_sync(kFull, x, 1);
  return lane == 0 ? identity : max(ex, identity);
}

template <int R, bool EXTEND>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
gact_tiles(const uint8_t* __restrict__ q, const uint8_t* __restrict__ r,
           const int32_t* __restrict__ qlen, const int32_t* __restrict__ rlen,
           const int32_t* __restrict__ scoring, int B, int QT, int RT,
           int max_tb, int32_t* __restrict__ score,
           int32_t* __restrict__ qpos, int32_t* __restrict__ rpos,
           uint8_t* __restrict__ trace, int32_t* __restrict__ rec,
           int32_t* __restrict__ qsteps, int32_t* __restrict__ rsteps) {
  constexpr int QTP = 32 * R;  // trace row pitch
  __shared__ int s_sub[25];
  if (threadIdx.x < 25) s_sub[threadIdx.x] = scoring[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  const int go = scoring[25], ge = scoring[26];
  const int goL = scoring[27], geL = scoring[28];
  const int ql = qlen[b], rl = rlen[b];
  const int q0 = lane * R;

  int qc5[R];  // query code * 5 (row offset into the substitution matrix)
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int qq = q0 + k;
    qc5[k] = 5 * (qq < QT ? q[(size_t)b * QT + qq] : 4);
  }
  int hprev[R], e[R], el[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    hprev[k] = 0;
    e[k] = go;
    el[k] = goL;
  }
  unsigned eb = 0xffffffffu;  // pending E/E_L open bits, 2 per row
  int best = 0, bq = 0, br = 0, hend = 0;
  const uint8_t* rrow = r + (size_t)b * RT;
  uint8_t* tr = EXTEND ? trace + (size_t)b * RT * QTP : nullptr;

  for (int c = 0; c < rl; ++c) {
    const int rc = __ldg(rrow + c);
    int up = __shfl_up_sync(kFull, hprev[R - 1], 1);
    if (lane == 0) up = 0;
    int hp[R], dag[R];
    int ta = kNeg, tb = kNeg;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int hd = k == 0 ? up : hprev[k - 1];
      const int d = max(hd + s_sub[qc5[k] + rc], 0);
      dag[k] = d;
      const int h0 = max(max(d, e[k]), el[k]);
      hp[k] = h0;
      const int qq = q0 + k;
      ta = max(ta, h0 - ge * qq);
      tb = max(tb, h0 - geL * qq);
    }
    int runf = warp_excl_max(ta, lane, ge);
    int runfl = warp_excl_max(tb, lane, geL);

    unsigned neb = 0;
    int rw_last = 0, colmax = -1, colq = 0;
    uint32_t words[R / 4];
#pragma unroll
    for (int k = 0; k < R / 4; ++k) words[k] = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int qq = q0 + k;
      const int f = go + ge * (qq - 1) + runf;
      runf = max(runf, hp[k] - ge * qq);
      const int fl = goL + geL * (qq - 1) + runfl;
      runfl = max(runfl, hp[k] - geL * qq);
      const int h = max(hp[k], max(f, fl));
      if (EXTEND) {
        const bool is_d = h == dag[k], is_f = h == f, is_fl = h == fl,
                   is_el = h == el[k];
        const int t = is_d ? (is_el ? T8_DEL_L
                                    : is_fl ? T8_INS_L
                                            : (h == 0 ? T8_ZERO : T8_DIAG))
                           : (is_f ? T8_INS
                                   : is_fl ? T8_INS_L
                                           : is_el ? T8_DEL_L : T8_DEL);
        const int pe = (((eb >> (2 * k)) & 1u) ? E_OPEN8 : 0) |
                       (((eb >> (2 * k + 1)) & 1u) ? EL_OPEN8 : 0);
        const int w = t | pe | (k == 0 ? 0 : rw_last);
        words[k / 4] |= (uint32_t)w << (8 * (k % 4));
        rw_last = (h + go > f + ge ? F_OPEN8 : 0) |
                  (h + goL > fl + geL ? FL_OPEN8 : 0);
        neb |= ((h + go > e[k] + ge) ? 1u : 0u) << (2 * k);
        neb |= ((h + goL > el[k] + geL) ? 1u : 0u) << (2 * k + 1);
        if (qq == ql - 1 && c == rl - 1) hend = h;
      } else {
        if (qq < ql && h > colmax) {
          colmax = h;
          colq = qq;
        }
      }
      e[k] = max(h + go, e[k] + ge);
      el[k] = max(h + goL, el[k] + geL);
      hprev[k] = h;
    }
    if (EXTEND) {
      eb = neb;
      // row 0 of the lane takes the open bits of the previous lane's last
      // row (row 0 of the tile: both open)
      int rw_up = __shfl_up_sync(kFull, rw_last, 1);
      if (lane == 0) rw_up = F_OPEN8 | FL_OPEN8;
      words[0] |= (uint32_t)rw_up;
      uint32_t* dst = reinterpret_cast<uint32_t*>(tr + (size_t)c * QTP + q0);
#pragma unroll
      for (int k = 0; k < R / 4; ++k) dst[k] = words[k];
    } else {
      // earliest column with a strict improvement, then smallest q
      // (Processor.cpp:502-541)
      int m = colmax;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        m = max(m, __shfl_xor_sync(kFull, m, d));
      int cq = colmax == m ? colq : 0x7fffffff;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        cq = min(cq, __shfl_xor_sync(kFull, cq, d));
      if (m > best) {
        best = m;
        bq = cq;
        br = c;
      }
    }
  }

  if (!EXTEND) {
    if (lane == 0) {
      score[b] = best;
      qpos[b] = bq;
      rpos[b] = br;
    }
    return;
  }
  hend = __shfl_sync(kFull, hend, (ql - 1) / R);
  for (int j = lane; j < RT; j += 32) rec[(size_t)j * B + b] = 0;
  __syncwarp();  // orders this warp's trace and record stores before the walk
  if (lane != 0) return;
  score[b] = hend;

  // serial traceback walk (gact._walk / Processor.cpp:585-716), one op per
  // step, folded into per-column records: nI | closing << 14
  int i = ql - 1, j = rl - 1, qs = 0, rs = 0, st = T8_DIAG, nI = 0;
  while (qs != max_tb && rs != max_tb && i >= 0 && j >= 0) {
    const int w = tr[(size_t)j * QTP + i];
    const int eff = st == T8_DIAG ? (w & 7) : st;
    if (eff == T8_DIAG) {
      rec[(size_t)j * B + b] = nI | (OP_M << 14);
      nI = 0;
      --i;
      --j;
      ++qs;
      ++rs;
      st = T8_DIAG;
    } else if (eff == T8_DEL || eff == T8_DEL_L) {
      rec[(size_t)j * B + b] = nI | (OP_D << 14);
      nI = 0;
      --j;
      ++rs;
      const int open = eff == T8_DEL ? (w & E_OPEN8) : (w & EL_OPEN8);
      st = open ? T8_DIAG : eff;
    } else if (eff == T8_INS || eff == T8_INS_L) {
      ++nI;
      --i;
      ++qs;
      const int open = eff == T8_INS ? (w & F_OPEN8) : (w & FL_OPEN8);
      st = open ? T8_DIAG : eff;
    } else {
      break;  // ZERO cell: local alignment starts here
    }
  }
  if (nI) rec[(size_t)j * B + b] = nI;
  qsteps[b] = qs;
  rsteps[b] = rs;
}

template <bool EXTEND>
ffi::Error Launch(cudaStream_t stream, int64_t rows_per_lane,
                  const uint8_t* q, const uint8_t* r, const int32_t* qlen,
                  const int32_t* rlen, const int32_t* scoring, int B, int QT,
                  int RT, int max_tb, int32_t* score, int32_t* qpos,
                  int32_t* rpos, uint8_t* trace, int32_t* rec,
                  int32_t* qsteps, int32_t* rsteps) {
  if (QT > 32 * rows_per_lane)
    return ffi::Error::InvalidArgument("query tile wider than 32 * R");
  if (B == 0) return ffi::Error::Success();
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
#define DARWIN_LAUNCH(RR)                                                     \
  gact_tiles<RR, EXTEND><<<grid, block, 0, stream>>>(                        \
      q, r, qlen, rlen, scoring, B, QT, RT, max_tb, score, qpos, rpos,      \
      trace, rec, qsteps, rsteps)
  switch (rows_per_lane) {
    case 4: DARWIN_LAUNCH(4); break;
    case 8: DARWIN_LAUNCH(8); break;
    case 12: DARWIN_LAUNCH(12); break;
    case 16: DARWIN_LAUNCH(16); break;
    default:
      return ffi::Error::InvalidArgument(
          "rows per lane must be 4, 8, 12 or 16");
  }
#undef DARWIN_LAUNCH
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("gact_tiles launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error FilterImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                      ffi::Buffer<ffi::U8> r, ffi::Buffer<ffi::S32> qlen,
                      ffi::Buffer<ffi::S32> rlen, ffi::Buffer<ffi::S32> scoring,
                      ffi::ResultBuffer<ffi::S32> score,
                      ffi::ResultBuffer<ffi::S32> qpos,
                      ffi::ResultBuffer<ffi::S32> rpos,
                      int64_t rows_per_lane) {
  const int B = q.dimensions()[0], QT = q.dimensions()[1];
  const int RT = r.dimensions()[1];
  return Launch<false>(stream, rows_per_lane, q.typed_data(), r.typed_data(),
                       qlen.typed_data(), rlen.typed_data(),
                       scoring.typed_data(), B, QT, RT, 0,
                       score->typed_data(), qpos->typed_data(),
                       rpos->typed_data(), nullptr, nullptr, nullptr,
                       nullptr);
}

ffi::Error ExtendImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                      ffi::Buffer<ffi::U8> r, ffi::Buffer<ffi::S32> qlen,
                      ffi::Buffer<ffi::S32> rlen, ffi::Buffer<ffi::S32> scoring,
                      ffi::ResultBuffer<ffi::S32> score,
                      ffi::ResultBuffer<ffi::S32> rec,
                      ffi::ResultBuffer<ffi::S32> qsteps,
                      ffi::ResultBuffer<ffi::S32> rsteps,
                      ffi::ResultBuffer<ffi::U8> trace, int64_t rows_per_lane,
                      int64_t max_tb) {
  const int B = q.dimensions()[0], QT = q.dimensions()[1];
  const int RT = r.dimensions()[1];
  return Launch<true>(stream, rows_per_lane, q.typed_data(), r.typed_data(),
                      qlen.typed_data(), rlen.typed_data(),
                      scoring.typed_data(), B, QT, RT, (int)max_tb,
                      score->typed_data(), nullptr, nullptr,
                      trace->typed_data(), rec->typed_data(),
                      qsteps->typed_data(), rsteps->typed_data());
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    GactFilter, FilterImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Attr<int64_t>("rows_per_lane"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    GactExtend, ExtendImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::U8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::U8>>()
        .Attr<int64_t>("rows_per_lane")
        .Attr<int64_t>("max_tb"));
