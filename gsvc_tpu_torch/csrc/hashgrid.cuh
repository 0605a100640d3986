// Shared pieces of the port's hash-grid kernels (B3f hashgrid_fwd.cu, B3b
// hashgrid_bwd.cu): one level-instance's cell, a corner's table row and weight, as
// gsvc_tpu_torch/ops/hashgrid.py:_level_indices computes them, the lanes a query and
// the vector loads and stores of a lane's part of a row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gsvc {

// Lanes a query in B3f and B3b: L lanes share a query, lane l taking features
// [l F / L, (l + 1) F / L) of each table row, of the output and of the cotangent: a
// float4 at F = 8 (L = 2) and F = 4 (L = 1), a float2 at F = 2 (L = 1).  So one warp
// load instruction fetches 32 / L whole 32-byte rows at F = 8 where a lane a query
// would fetch 32 rows in halves with two instructions, each lane keeps half the corner
// values live, and a query's F outputs (or cotangents) are one full sector.
template <int F>
struct Lanes {
  static constexpr int L = F == 8 ? 2 : 1;  // lanes a query
  static constexpr int FL = F / L;          // features a lane
  static constexpr int Q = 32 / L;          // queries a warp
};

// One level-instance of the Mix3d2d encoder: a row of the int32 [n_inst, 9] table
// that gsvc_tpu_torch/ops/hashgrid_kernels.py:instance_table builds.
struct Inst {
  int res;       // grid resolution of the level
  int size;      // table rows of the level
  int offset;    // first row of the level in the flat [rows, F] table
  int ndim;      // 3 (the 3D grid) or 2 (the xy / xz / yz planes)
  int dims[3];   // which columns of x feed the instance
  int use_hash;  // res^ndim > size: the instant-NGP xor hash, else dense rows
  int mask;      // size - 1 where use_hash (size is then a power of two), else 0
};

constexpr int kInstCols = 9;

__device__ __forceinline__ Inst load_inst(const int* __restrict__ meta, int i) {
  const int* m = meta + kInstCols * i;
  Inst in;
  in.res = __ldg(m);
  in.size = __ldg(m + 1);
  in.offset = __ldg(m + 2);
  in.ndim = __ldg(m + 3);
  in.dims[0] = __ldg(m + 4);
  in.dims[1] = __ldg(m + 5);
  in.dims[2] = __ldg(m + 6);
  in.use_hash = __ldg(m + 7);
  in.mask = __ldg(m + 8);
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

// v[k] for k in 0..2 by selects, so that v stays in registers (a runtime index into a
// local array would put it in local memory).
__device__ __forceinline__ float pick3(const float* v, int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

// The instant-NGP hash primes of dimensions 0, 1, 2.
__device__ __forceinline__ uint32_t prime(int d) {
  return d == 0 ? 1u : (d == 1 ? 2654435761u : 805459861u);
}

// Corner c (bit d: the upper neighbour along dimension d) of the cell: its weight
// (the product of the per-dimension factors, left to right as the plain version
// multiplies them), and, when every coordinate lies strictly inside (0, res - 1),
// its row in the flat table.  Returns false for a border corner, which weighs 0.
// No division: in a dense level a valid corner's row-major index is below
// res^ndim <= size, so the plain version's modulo leaves it as it is; in a hashed
// level size is a power of two and h % size is h & mask.  All in 32 bits (the
// launcher checks rows * F < 2^31).
template <int D>
__device__ __forceinline__ bool corner(const Inst& in, const int* pg, const float* frac,
                                       int c, int& row, float& w) {
  w = 1.0f;
  bool valid = true;
  uint32_t h = 0u, idx = 0u, stride = 1u;
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
    idx += static_cast<uint32_t>(coord) * stride;  // border corners may wrap: unused
    stride *= static_cast<uint32_t>(in.res);
  }
  row = static_cast<int>(static_cast<uint32_t>(in.offset) +
                         (in.use_hash ? h & static_cast<uint32_t>(in.mask) : idx));
  return valid;
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

// Vectors of FL floats, the part of a row one lane moves: float4 at FL = 4, 8 (as
// FL / 4 of them), float2 at FL = 2.
template <int FL>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float* v) {
  if constexpr (FL % 4 == 0) {
#pragma unroll
    for (int f = 0; f < FL; f += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + f));
      v[f] = t.x;
      v[f + 1] = t.y;
      v[f + 2] = t.z;
      v[f + 3] = t.w;
    }
  } else {
    static_assert(FL == 2, "a lane moves 2, 4 or 8 floats");
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
}

template <int FL>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float* v) {
  if constexpr (FL % 4 == 0) {
#pragma unroll
    for (int f = 0; f < FL; f += 4)
      *reinterpret_cast<float4*>(p + f) = make_float4(v[f], v[f + 1], v[f + 2], v[f + 3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

}  // namespace gsvc
