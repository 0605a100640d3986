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
// reductions) is not carried over: a thread owns one (query, instance) pair and
// gathers each corner row straight from the flat [rows, F] table, F = 8 as two
// float4 loads.  Blocks are instance-major (blockIdx.y = instance), so a warp works
// on one level (one corner count, no divergence, one table region in cache), reads
// x coalesced and writes one 32-byte sector per query.  The cell is computed with
// the plain version's roundings (see cell), the accumulation as the plain version's
// acc + w * v and wn + w, corner by corner, and the division by max(wn, 1e-9) is an
// IEEE division: kernel and plain version agree bit for bit on the same table.
#include "hashgrid.cuh"

namespace {

using gsvc::Inst;
using gsvc::cell;
using gsvc::corner;
using gsvc::load_inst;

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ table, int row,
                                         float* v) {
  const float* p = table + static_cast<size_t>(row) * F;
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int f = 0; f < F; f += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + f));
      v[f] = t.x;
      v[f + 1] = t.y;
      v[f + 2] = t.z;
      v[f + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __ldg(p + f);
  }
}

template <int F, int D>
__device__ __forceinline__ void encode_one(const float* __restrict__ table,
                                           const float* __restrict__ x, const Inst& in,
                                           int q, int inst, int n_inst,
                                           float* __restrict__ out) {
  int pg[D];
  float frac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) cell(x[3 * static_cast<size_t>(q) + in.dims[d]], in.res,
                                   pg[d], frac[d]);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  float wn = 0.0f;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    int row;
    float w;
    if (!corner<D>(in, pg, frac, c, row, w)) continue;  // weight 0: adds nothing
    float v[F];
    load_row<F>(table, row, v);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, v[f]));
    wn = __fadd_rn(wn, w);
  }
  const float W = fmaxf(wn, 1e-9f);
  float* o = out + (static_cast<size_t>(q) * n_inst + inst) * F;
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int f = 0; f < F; f += 4)
      *reinterpret_cast<float4*>(o + f) =
          make_float4(__fdiv_rn(acc[f], W), __fdiv_rn(acc[f + 1], W),
                      __fdiv_rn(acc[f + 2], W), __fdiv_rn(acc[f + 3], W));
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = __fdiv_rn(acc[f], W);
  }
}

template <int F>
__global__ void hashgrid_fwd_kernel(const float* __restrict__ table,
                                    const float* __restrict__ x,
                                    const int* __restrict__ meta, float* __restrict__ out,
                                    int n, int n_inst) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int inst = blockIdx.y;
  const Inst in = load_inst(meta, inst);
  if (in.ndim == 3)
    encode_one<F, 3>(table, x, in, q, inst, n_inst, out);
  else
    encode_one<F, 2>(table, x, in, q, inst, n_inst, out);
}

}  // namespace

// Launches ceil(n / 256) x n_inst blocks of 256 threads on `stream`.  Pointers are
// device pointers: table [rows, f] f32 (16-byte aligned when f % 4 == 0), x [n, 3]
// f32, meta [n_inst, 8] i32 (res, size, offset, ndim, dims[3], use_hash), out
// [n, n_inst * f] f32.  f is 2, 4 or 8.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int hashgrid_forward(const float* table, const float* x, const int* meta,
                                float* out, int n, int n_inst, int f, void* stream) {
  if (n_inst <= 0 || n_inst > 65535 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  constexpr int kThreads = 256;
  const dim3 grid((n + kThreads - 1) / kThreads, n_inst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GSVC_HASH_FWD_LAUNCH(FF) \
  hashgrid_fwd_kernel<FF><<<grid, kThreads, 0, st>>>(table, x, meta, out, n, n_inst)
  switch (f) {
    case 2: GSVC_HASH_FWD_LAUNCH(2); break;
    case 4: GSVC_HASH_FWD_LAUNCH(4); break;
    case 8: GSVC_HASH_FWD_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSVC_HASH_FWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
