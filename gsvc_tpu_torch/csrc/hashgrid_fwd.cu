// Kernel B3f of the PyTorch/CUDA port: the Mix3d2d multi-resolution hash-grid encode.
//
// Replaces the TPU kernel _fwd_kernel (gsvc_tpu/ops/pallas_hashgrid.py:270, launched by
// _fwd_call, :376).  For every query x [N, 3] in [0, 1] and every level-instance (the
// 3D grid's levels, then the xy, xz and yz planes' levels) it interpolates the
// instance's table rows at the cell corners: pos = x (res - 2) + 0.5, border corners
// (a coordinate not in (0, res - 1)) weigh 0 and the others are renormalised by
// max(sum w, 1e-9), rows come from the xor-prime hash (uint32, % level size) above
// the dense threshold.  Output [N, n_inst * F], columns in mix_grid_encode's order.
// The Python wrapper is gsvc_tpu_torch/ops/hashgrid_kernels.py; the plain PyTorch
// version (gsvc_tpu_torch/ops/hashgrid.py:mix_grid_encode) computes the same function.
//
// What bounds it on an H100: bytes, and in practice the latency of dependent gathers.
// Each query reads 144 corner rows of F floats (12 3D levels x 8 corners + 12 2D
// levels x 4) and writes n_inst * F floats; the arithmetic is a few dozen operations
// per corner.  The whole table (14.1 MB at the fixture's spec) stays in the 50 MB L2.
//
// What the design does about it: the TPU layout (packed 128-lane segments, one-hot
// reductions) is not carried over.  Blocks are instance-major (blockIdx.y = instance),
// so a block works on one level (one corner count, no divergence, one table region in
// L1 and L2) and reads x coalesced.  Two lanes share a query at F = 8 (hashgrid.cuh
// Lanes), each loading and writing its half of every row as one float4: a load
// instruction fetches 16 whole 32-byte rows (a lane a query would take two
// instructions of half rows), and a warp's store fills 16 whole sectors.  Each lane
// issues all of its corner loads before it accumulates, so 8 (3D) or 4 (2D) row
// fetches are in flight, and the corner rows need no division (hashgrid.cuh:corner).
// At the fixture's spec the rows that a training step's window needs are read ~10
// times each from L2 (3.7 M corner rows on 0.36 M distinct rows), so the gathers, not
// HBM, set the pace.
// The cell is computed with the plain version's roundings (see cell), the accumulation
// as the plain version's acc + w * v and wn + w, corner by corner, and the division
// by max(wn, 1e-9) is an IEEE division: kernel and plain version agree bit for bit on
// the same table.
#include "hashgrid.cuh"

namespace {

using gsvc::Inst;
using gsvc::Lanes;
using gsvc::cell;
using gsvc::corner;
using gsvc::load_inst;

constexpr int kFwdThreads = 128;

// One (query, instance): this lane's FL output features.
template <int F, int D>
__device__ __forceinline__ void encode_one(const float* __restrict__ table,
                                           const float* xq, const Inst& in, int f0,
                                           float* __restrict__ o) {
  constexpr int C = 1 << D, FL = Lanes<F>::FL;
  int pg[D];
  float frac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) cell(gsvc::pick3(xq, in.dims[d]), in.res, pg[d], frac[d]);
  int rows[C];
  float ws[C];
  bool valid[C];
  float v[C][FL];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    valid[c] = corner<D>(in, pg, frac, c, rows[c], ws[c]);
    if (valid[c]) gsvc::load_vec<FL>(table + rows[c] * F + f0, v[c]);
  }
  float acc[FL];
#pragma unroll
  for (int f = 0; f < FL; ++f) acc[f] = 0.0f;
  float wn = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (!valid[c]) continue;  // weight 0: adds nothing
#pragma unroll
    for (int f = 0; f < FL; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(ws[c], v[c][f]));
    wn = __fadd_rn(wn, ws[c]);
  }
  const float W = fmaxf(wn, 1e-9f);
#pragma unroll
  for (int f = 0; f < FL; ++f) acc[f] = __fdiv_rn(acc[f], W);
  gsvc::store_vec<FL>(o, acc);
}

template <int F>
__global__ void __launch_bounds__(kFwdThreads)
    hashgrid_fwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                        const int* __restrict__ meta, float* __restrict__ out, int n,
                        int n_inst) {
  using LQ = Lanes<F>;
  const int q = blockIdx.x * (kFwdThreads / LQ::L) + threadIdx.x / LQ::L;
  if (q >= n) return;  // no lane exchanges data
  const int f0 = (threadIdx.x % LQ::L) * LQ::FL;
  const Inst in = load_inst(meta, blockIdx.y);
  float xq[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) xq[d] = __ldg(x + 3 * static_cast<size_t>(q) + d);
  float* o = out + (static_cast<size_t>(q) * n_inst + blockIdx.y) * F + f0;
  if (in.ndim == 3)
    encode_one<F, 3>(table, xq, in, f0, o);
  else
    encode_one<F, 2>(table, xq, in, f0, o);
}

template <int F>
int launch(const float* table, const float* x, const int* meta, float* out, int n,
           int n_inst, cudaStream_t st) {
  constexpr int per_block = kFwdThreads / Lanes<F>::L;
  const dim3 grid((n + per_block - 1) / per_block, n_inst);
  hashgrid_fwd_kernel<F><<<grid, kFwdThreads, 0, st>>>(table, x, meta, out, n, n_inst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches ceil(n L / 128) x n_inst blocks of 128 threads on `stream` (L = 2 lanes a
// query at f = 8, else 1).  Pointers are device pointers: table [rows, f] f32 (16-byte
// aligned; rows * f < 2^31), x [n, 3] f32, meta [n_inst, 9] i32 (res, size, offset,
// ndim, dims[3], use_hash, mask), out [n, n_inst * f] f32 (16-byte aligned).  f is 2,
// 4 or 8.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hashgrid_forward(const float* table, const float* x, const int* meta,
                                float* out, int n, int n_inst, int f, void* stream) {
  if (n_inst <= 0 || n_inst > 65535 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 2: return launch<2>(table, x, meta, out, n, n_inst, st);
    case 4: return launch<4>(table, x, meta, out, n, n_inst, st);
    case 8: return launch<8>(table, x, meta, out, n, n_inst, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
