// Kernel B3b of the PyTorch/CUDA port: the gradients of the Mix3d2d hash-grid encode.
//
// Replaces the TPU kernel _bwd_kernel (gsvc_tpu/ops/pallas_hashgrid.py:295, launched by
// _bwd_call, :399).  From the output cotangent g [N, n_inst * F] it gives
//   * the table gradient, g_table[row_c] += (g / W) * w_c for every valid corner c of
//     every (query, instance), W = max(sum w, 1e-9);
//   * the position gradient dL/dx [N, 3]: per (query, instance) sum_c r_c dw_c / dx,
//     with r_c = sum_f g_f (V_cf - out_f) / W (out_f dropped when sum w < 1e-9, where
//     the clamp has no gradient) and dw_c / dx_d the derivative of the corner weight
//     (border corners zeroed in w and dw), the algebra of the TPU kernel
//     (pallas_hashgrid.py:348-349, _instance_indices :180), summed over the instances
//     in their order.
// The Python wrapper is gsvc_tpu_torch/ops/hashgrid_kernels.py; the plain PyTorch
// version (autograd through gsvc_tpu_torch/ops/hashgrid.py:mix_grid_encode) computes
// the same function.
//
// What bounds it on an H100: bytes, and in practice the gathers of the corner rows and
// the scatter of their gradients.  Each query re-reads its 144 corner rows and adds F
// floats into each (7.4 M float4 adds at a training step's union window of 25,920
// queries); the table (14.1 MB at the fixture's spec) stays in L2.
//
// What the design does about it.  Combining the updates that fall on one row inside a
// block would remove few of them at a training step's window (chip_smoke.py prints
// the counts: 1.15x fewer over 32 queries, 1.36x over 256 on the fitted state), so
// the design cuts the loads and the registers, keeps one float4 atomic add per half
// row, and spreads each block's adds over every level (an instance-major grid keeps
// the whole card adding into one level's rows at a time, which at the anchor capacity
// makes contention the cost):
//   * a block owns 32 z-consecutive queries and every instance; its 8 warps take the
//     (instance, 16 queries) tasks in turn, and two lanes share a query (hashgrid.cuh
//     Lanes), each with its half of every row (one float4 load, one float4 atomic
//     add), of the cotangent and of the output, so a row is one slot of one load
//     instruction and a query's cotangent one full sector;
//   * r_c is summed over each lane's four features and the pair's two halves are
//     added with one shuffle, so a lane keeps 8 corners x 4 values live, not 8 x 8;
//   * each (query, instance)'s position gradient goes to shared memory, and the
//     block sums each query's instances in their order and writes dL/dx [N, 3] once;
//   * the launcher zeroes the table gradient with one cudaMemsetAsync on the stream.
// Atomic sums are taken in an order that changes from run to run; the position
// gradient has no atomics and is deterministic.  The TPU kernel's one-hot MXU matmul
// scatter is a TPU workaround and is not carried over.  The corner rows need no
// division (hashgrid.cuh:corner).
#include "hashgrid.cuh"

namespace {

using gsvc::Inst;
using gsvc::Lanes;
using gsvc::cell;
using gsvc::corner;
using gsvc::corner_dw;
using gsvc::load_inst;

constexpr int kBwdQ = 32;         // queries a block
constexpr int kBwdThreads = 256;  // 8 warps

// Adds FL floats into a table row's part: float4 atomic adds (sm_90, CUDA >= 12.1) at
// FL = 4, 8, scalar ones at FL = 2.
template <int FL>
__device__ __forceinline__ void add_part(float* __restrict__ p, const float* v) {
  if constexpr (FL % 4 == 0) {
#pragma unroll
    for (int f = 0; f < FL; f += 4)
      atomicAdd(reinterpret_cast<float4*>(p + f),
                make_float4(v[f], v[f + 1], v[f + 2], v[f + 3]));
  } else {
#pragma unroll
    for (int f = 0; f < FL; ++f) atomicAdd(p + f, v[f]);
  }
}

// One (query, instance): adds this lane's FL features of every valid corner's table
// gradient and the instance's position gradient into gxq.  `live` is false past the
// last query: such a lane loads and adds nothing but takes part in the shuffles.
template <int F, int D>
__device__ __forceinline__ void backward_one(const float* __restrict__ table,
                                             const float* xq, const float* __restrict__ gp,
                                             const Inst& in, int f0, bool live,
                                             float* __restrict__ g_table, float* gxq) {
  constexpr int C = 1 << D, FL = Lanes<F>::FL, L = Lanes<F>::L;
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
    valid[c] = corner<D>(in, pg, frac, c, rows[c], ws[c]) && live;
    if (valid[c]) gsvc::load_vec<FL>(table + rows[c] * F + f0, v[c]);
  }
  float g[FL];
  if (live) {
    gsvc::load_vec<FL>(gp, g);
  } else {
#pragma unroll
    for (int f = 0; f < FL; ++f) g[f] = 0.0f;
  }
  float acc[FL];
#pragma unroll
  for (int f = 0; f < FL; ++f) acc[f] = 0.0f;
  float wn = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (!valid[c]) continue;
#pragma unroll
    for (int f = 0; f < FL; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(ws[c], v[c][f]));
    wn = __fadd_rn(wn, ws[c]);
  }
  const float W = fmaxf(wn, 1e-9f);
  const bool clamped = !(wn >= 1e-9f);
  float out[FL], gw[FL];
#pragma unroll
  for (int f = 0; f < FL; ++f) {
    out[f] = clamped ? 0.0f : __fdiv_rn(acc[f], W);
    gw[f] = __fdiv_rn(g[f], W);
  }
  float gx[D];
#pragma unroll
  for (int d = 0; d < D; ++d) gx[d] = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float r = 0.0f;
    if (valid[c]) {
#pragma unroll
      for (int f = 0; f < FL; ++f) r += g[f] * (v[c][f] - out[f]);
    }
    if constexpr (L == 2) r += __shfl_xor_sync(0xffffffffu, r, 1);  // the pair's halves
    if (!valid[c]) continue;
    float gv[FL];
#pragma unroll
    for (int f = 0; f < FL; ++f) gv[f] = gw[f] * ws[c];
    add_part<FL>(g_table + rows[c] * F + f0, gv);
    r = r / W;
#pragma unroll
    for (int d = 0; d < D; ++d) gx[d] += r * corner_dw<D>(in, frac, c, d);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (in.dims[d] == k) gxq[k] += gx[d];
  }
}

template <int F>
__global__ void __launch_bounds__(kBwdThreads)
    hashgrid_bwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                        const float* __restrict__ g_out, const int* __restrict__ meta,
                        float* __restrict__ g_table, float* __restrict__ g_x, int n,
                        int n_inst) {
  using LQ = Lanes<F>;
  constexpr int kSlices = kBwdQ / LQ::Q;  // warp tasks a block and instance
  extern __shared__ float gxs[];          // [n_inst, kBwdQ, 3]
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBwdQ;
  const int f0 = (lane % LQ::L) * LQ::FL;
  for (int t = threadIdx.x >> 5; t < n_inst * kSlices; t += kBwdThreads / 32) {
    const int inst = t / kSlices;
    const int ql = (t % kSlices) * LQ::Q + lane / LQ::L;
    const int q = q0 + ql;
    const bool live = q < n;
    float xq[3] = {0.5f, 0.5f, 0.5f};
    if (live) {
#pragma unroll
      for (int d = 0; d < 3; ++d) xq[d] = __ldg(x + 3 * static_cast<size_t>(q) + d);
    }
    const float* gp =
        g_out + (static_cast<size_t>(live ? q : 0) * n_inst + inst) * F + f0;
    const Inst in = load_inst(meta, inst);
    float gxq[3] = {0.0f, 0.0f, 0.0f};
    if (in.ndim == 3)
      backward_one<F, 3>(table, xq, gp, in, f0, live, g_table, gxq);
    else
      backward_one<F, 2>(table, xq, gp, in, f0, live, g_table, gxq);
    if (f0 == 0) {
      float* s = gxs + (inst * kBwdQ + ql) * 3;
      s[0] = gxq[0];
      s[1] = gxq[1];
      s[2] = gxq[2];
    }
  }
  __syncthreads();
  // dL/dx of each query: its instances' parts summed in instance order
  for (int ql = threadIdx.x; ql < kBwdQ && q0 + ql < n; ql += blockDim.x) {
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int inst = 0; inst < n_inst; ++inst) {
      const float* s = gxs + (inst * kBwdQ + ql) * 3;
      s0 += s[0];
      s1 += s[1];
      s2 += s[2];
    }
    float* o = g_x + 3 * static_cast<size_t>(q0 + ql);
    o[0] = s0;
    o[1] = s1;
    o[2] = s2;
  }
}

template <int F>
int launch(const float* table, const float* x, const float* g_out, const int* meta,
           float* g_table, float* g_x, int n_rows, int n, int n_inst, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(g_table, 0, sizeof(float) * n_rows * F, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = sizeof(float) * 3 * kBwdQ * n_inst;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(hashgrid_bwd_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  hashgrid_bwd_kernel<F><<<(n + kBwdQ - 1) / kBwdQ, kBwdThreads, smem, st>>>(
      table, x, g_out, meta, g_table, g_x, n, n_inst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Zeroes g_table (cudaMemsetAsync) and launches ceil(n / 32) blocks of 256 threads on
// `stream`, with n_inst * 384 bytes of shared memory each.  Pointers are device
// pointers: table [n_rows, f] f32 (n_rows * f < 2^31), x [n, 3] f32, g_out [n, n_inst *
// f] f32, meta [n_inst, 9] i32 (see hashgrid.cuh Inst), g_table [n_rows, f] f32, g_x
// [n, 3] f32 (written whole); table, g_out and g_table 16-byte aligned.  f is 2, 4 or
// 8.  Returns the first CUDA error of the memset and the launch (0 on success).
extern "C" int hashgrid_backward(const float* table, const float* x, const float* g_out,
                                 const int* meta, float* g_table, float* g_x, int n_rows,
                                 int n, int n_inst, int f, void* stream) {
  if (n_inst <= 0 || n < 0 || n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(g_table, 0, sizeof(float) * n_rows * f, st));
  switch (f) {
    case 2: return launch<2>(table, x, g_out, meta, g_table, g_x, n_rows, n, n_inst, st);
    case 4: return launch<4>(table, x, g_out, meta, g_table, g_x, n_rows, n, n_inst, st);
    case 8: return launch<8>(table, x, g_out, meta, g_table, g_x, n_rows, n, n_inst, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
