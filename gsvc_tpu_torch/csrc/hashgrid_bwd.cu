// Kernel B3b of the PyTorch/CUDA port: the gradients of the Mix3d2d hash-grid encode.
//
// Replaces the TPU kernel _bwd_kernel (gsvc_tpu/ops/pallas_hashgrid.py:295, launched by
// _bwd_call, :399).  From the output cotangent g [N, n_inst * F] it gives
//   * the table gradient, g_table[row_c] += (g / W) * w_c for every valid corner c of
//     every (query, instance), W = max(sum w, 1e-9);
//   * the position gradient of each (query, instance), sum_c r_c dw_c / dx, with
//     r_c = sum_f g_f (V_cf - out_f) / W (out_f dropped when sum w < 1e-9, where the
//     clamp has no gradient) and dw_c / dx_d the derivative of the corner weight
//     (border corners zeroed in w and dw), the algebra of the TPU kernel
//     (pallas_hashgrid.py:348-349, _instance_indices :180).  It is written per
//     instance into gx_part [n_inst, N, 3] (0 in the dimensions that do not feed the
//     instance); the wrapper sums the instances.
// The Python wrapper is gsvc_tpu_torch/ops/hashgrid_kernels.py; the plain PyTorch
// version (autograd through gsvc_tpu_torch/ops/hashgrid.py:mix_grid_encode) computes
// the same function.
//
// What bounds it on an H100: bytes and the atomic traffic of the scatter-add.  Each
// query re-reads its 144 corner rows and adds F floats into each; the coarse 3D level
// (res 18: 5,832 dense rows) and the first 2D level (res 130) take tens of thousands
// of queries on few rows.
//
// What the design does about it: the forward is recomputed per (query, instance) from
// the table (the rows sit in L2) instead of storing the corner values; each thread adds
// its corners' rows with fire-and-forget atomics, one float4 atomic per 4 features on
// sm_90 (4x fewer L2 atomic operations).  Atomic sums are taken in an order that
// changes from run to run; the position gradient has no atomics and is deterministic.
// The TPU kernel's one-hot MXU matmul scatter is a TPU workaround and is not carried
// over.
#include "hashgrid.cuh"

namespace {

using gsvc::Inst;
using gsvc::cell;
using gsvc::corner;
using gsvc::corner_dw;
using gsvc::load_inst;

template <int F>
__device__ __forceinline__ void add_row(float* __restrict__ g_table, int row,
                                        const float* v) {
  float* p = g_table + static_cast<size_t>(row) * F;
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int f = 0; f < F; f += 4)  // float4 atomicAdd: sm_90, CUDA >= 12.1
      atomicAdd(reinterpret_cast<float4*>(p + f),
                make_float4(v[f], v[f + 1], v[f + 2], v[f + 3]));
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(p + f, v[f]);
  }
}

template <int F, int D>
__device__ __forceinline__ void backward_one(const float* __restrict__ table,
                                             const float* __restrict__ x,
                                             const float* __restrict__ g_out,
                                             const Inst& in, int q, int n, int inst,
                                             int n_inst, float* __restrict__ g_table,
                                             float* __restrict__ gx_part) {
  constexpr int C = 1 << D;
  int pg[D];
  float frac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) cell(x[3 * static_cast<size_t>(q) + in.dims[d]], in.res,
                                   pg[d], frac[d]);
  int rows[C];
  float ws[C];
  bool valid[C];
  float vals[C][F];
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  float wn = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    valid[c] = corner<D>(in, pg, frac, c, rows[c], ws[c]);
    if (!valid[c]) continue;
    const float* p = table + static_cast<size_t>(rows[c]) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      vals[c][f] = __ldg(p + f);
      acc[f] = __fadd_rn(acc[f], __fmul_rn(ws[c], vals[c][f]));
    }
    wn = __fadd_rn(wn, ws[c]);
  }
  const float W = fmaxf(wn, 1e-9f);
  const bool clamped = !(wn >= 1e-9f);
  float g[F], out[F];
  const float* gp = g_out + (static_cast<size_t>(q) * n_inst + inst) * F;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    g[f] = gp[f];
    out[f] = clamped ? 0.0f : __fdiv_rn(acc[f], W);
  }
  float gx[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (!valid[c]) continue;
    float gv[F];
    float r = 0.0f;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      gv[f] = __fdiv_rn(g[f], W) * ws[c];
      r += g[f] * (vals[c][f] - out[f]);
    }
    add_row<F>(g_table, rows[c], gv);
    r = r / W;
#pragma unroll
    for (int d = 0; d < D; ++d) gx[d] += r * corner_dw<D>(in, frac, c, d);
  }
  float part[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int d = 0; d < D; ++d) part[in.dims[d]] = gx[d];
  float* o = gx_part + (static_cast<size_t>(inst) * n + q) * 3;
  o[0] = part[0];
  o[1] = part[1];
  o[2] = part[2];
}

template <int F>
__global__ void hashgrid_bwd_kernel(const float* __restrict__ table,
                                    const float* __restrict__ x,
                                    const float* __restrict__ g_out,
                                    const int* __restrict__ meta,
                                    float* __restrict__ g_table,
                                    float* __restrict__ gx_part, int n, int n_inst) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int inst = blockIdx.y;
  const Inst in = load_inst(meta, inst);
  if (in.ndim == 3)
    backward_one<F, 3>(table, x, g_out, in, q, n, inst, n_inst, g_table, gx_part);
  else
    backward_one<F, 2>(table, x, g_out, in, q, n, inst, n_inst, g_table, gx_part);
}

}  // namespace

// Launches ceil(n / 128) x n_inst blocks of 128 threads on `stream`.  Pointers are
// device pointers: table [rows, f] f32, x [n, 3] f32, g_out [n, n_inst * f] f32,
// meta [n_inst, 8] i32 (see hashgrid.cuh Inst), g_table [rows, f] f32 (zeroed by the
// caller, 16-byte aligned when f % 4 == 0), gx_part [n_inst, n, 3] f32.  f is 2, 4 or
// 8.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hashgrid_backward(const float* table, const float* x, const float* g_out,
                                 const int* meta, float* g_table, float* gx_part, int n,
                                 int n_inst, int f, void* stream) {
  if (n_inst <= 0 || n_inst > 65535 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  constexpr int kThreads = 128;
  const dim3 grid((n + kThreads - 1) / kThreads, n_inst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GSVC_HASH_BWD_LAUNCH(FF)                                                   \
  hashgrid_bwd_kernel<FF><<<grid, kThreads, 0, st>>>(table, x, g_out, meta, g_table, \
                                                     gx_part, n, n_inst)
  switch (f) {
    case 2: GSVC_HASH_BWD_LAUNCH(2); break;
    case 4: GSVC_HASH_BWD_LAUNCH(4); break;
    case 8: GSVC_HASH_BWD_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSVC_HASH_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
