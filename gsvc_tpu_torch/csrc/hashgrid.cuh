// Shared pieces of the port's hash-grid kernels (B3f hashgrid_fwd.cu, B3b
// hashgrid_bwd.cu): one level-instance's cell, and a corner's table row and weight,
// as gsvc_tpu_torch/ops/hashgrid.py:_level_indices computes them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gsvc {

// One level-instance of the Mix3d2d encoder: a row of the int32 [n_inst, 8] table
// that gsvc_tpu_torch/ops/hashgrid_kernels.py:instance_table builds.
struct Inst {
  int res;       // grid resolution of the level
  int size;      // table rows of the level
  int offset;    // first row of the level in the flat [rows, F] table
  int ndim;      // 3 (the 3D grid) or 2 (the xy / xz / yz planes)
  int dims[3];   // which columns of x feed the instance
  int use_hash;  // res^ndim > size: the instant-NGP xor hash, else dense rows
};

__device__ __forceinline__ Inst load_inst(const int* __restrict__ meta, int i) {
  const int* m = meta + 8 * i;
  Inst in;
  in.res = m[0];
  in.size = m[1];
  in.offset = m[2];
  in.ndim = m[3];
  in.dims[0] = m[4];
  in.dims[1] = m[5];
  in.dims[2] = m[6];
  in.use_hash = m[7];
  return in;
}

// pos = x * (res - 2) + 0.5, floor and fraction.  The product and the sum are rounded
// on their own (no FMA contraction), in the plain version's order: floor(pos) picks
// the cell, and a one-ulp difference at a cell edge would move the output by a whole
// table row.
__device__ __forceinline__ void cell(float x, int res, int& pg, float& frac) {
  const float pos = __fadd_rn(__fmul_rn(x, static_cast<float>(res - 2)), 0.5f);
  const float fl = floorf(pos);
  frac = __fsub_rn(pos, fl);
  pg = static_cast<int>(fminf(fmaxf(fl, -1.0e9f), 1.0e9f));
}

// The instant-NGP hash primes of dimensions 0, 1, 2.
__device__ __forceinline__ uint32_t prime(int d) {
  return d == 0 ? 1u : (d == 1 ? 2654435761u : 805459861u);
}

// Corner c (bit d: the upper neighbour along dimension d) of the cell: its weight
// (the product of the per-dimension factors, left to right as the plain version
// multiplies them), and, when every coordinate lies strictly inside (0, res - 1),
// its row in the flat table.  Returns false for a border corner, which weighs 0.
template <int D>
__device__ __forceinline__ bool corner(const Inst& in, const int* pg, const float* frac,
                                       int c, int& row, float& w) {
  w = 1.0f;
  bool valid = true;
  uint32_t h = 0u;
  long long idx = 0, stride = 1;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    int coord;
    if ((c >> d) & 1) {
      w = __fmul_rn(w, frac[d]);
      coord = min(pg[d] + 1, in.res - 1);
    } else {
      w = __fmul_rn(w, __fsub_rn(1.0f, frac[d]));
      coord = pg[d];
    }
    valid = valid && coord > 0 && coord < in.res - 1;
    h ^= static_cast<uint32_t>(coord) * prime(d);  // uint32 wrap-around
    idx += static_cast<long long>(coord) * stride;
    stride *= in.res;
  }
  if (!valid) return false;
  const long long local = in.use_hash ? static_cast<long long>(h % static_cast<uint32_t>(in.size))
                                      : idx % in.size;
  row = in.offset + static_cast<int>(local);
  return true;
}

// d w_c / d x_d of a valid corner: the sign of dimension d's factor, times the
// other factors, times (res - 2).
template <int D>
__device__ __forceinline__ float corner_dw(const Inst& in, const float* frac, int c,
                                           int d) {
  float p = ((c >> d) & 1) ? 1.0f : -1.0f;
#pragma unroll
  for (int d2 = 0; d2 < D; ++d2) {
    if (d2 == d) continue;
    p *= ((c >> d2) & 1) ? frac[d2] : 1.0f - frac[d2];
  }
  return p * static_cast<float>(in.res - 2);
}

}  // namespace gsvc
