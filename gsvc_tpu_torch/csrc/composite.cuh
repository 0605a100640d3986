// Shared pieces of the port's tile-compositing kernels (B1 mirror_fwd.cu, B2
// mirror_bwd.cu, B4 bidir.cu, B5f tile_fwd.cu, B5b tile_bwd.cu, B6f stream_fwd.cu,
// B6b stream_bwd.cu): the constants of the TPU kernels
// (gsvc_tpu/render/pallas_splat.py), the shared-memory stage of one chunk of a tile's
// depth-sorted copies, and the alpha of a copy at a pixel.
#pragma once

#include <cuda_runtime.h>

namespace gsvc {

constexpr float kTEps = 1e-4f;              // per-pixel early stop
constexpr float kAlphaMin = 1.0f / 255.0f;  // smaller alphas are zeroed
constexpr float kAlphaMax = 0.99f;
constexpr int kMaxChunk = 128;              // copies per shared-memory stage
constexpr int kMaxThreads = 256;

struct Chunk {
  float mx[kMaxChunk], my[kMaxChunk];                 // tile-local means
  float ha[kMaxChunk], hb[kMaxChunk], hc[kMaxChunk];  // conic * -1/2
  float op[kMaxChunk];                                // 0 for padding ids
  float r[kMaxChunk], g[kMaxChunk], b[kMaxChunk];
};

// Gathers data chunk c of the tile's id list from the [m, 9] attribute rows
// (mux, muy, conic a/b/c, opacity, rgb) into the shared stage; means become
// tile-local (cx, cy the tile centre), padding ids (-1) get opacity 0.
__device__ __forceinline__ void load_chunk(Chunk& s, const float* __restrict__ rows,
                                           const int* __restrict__ list, int c,
                                           int chunk, int m, float cx, float cy) {
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const int id = list[c * chunk + i];
    if (id >= 0 && id < m) {
      const float* row = rows + static_cast<size_t>(id) * 9;
      s.mx[i] = row[0] - cx;
      s.my[i] = row[1] - cy;
      s.ha[i] = -0.5f * row[2];
      s.hb[i] = -0.5f * row[3];
      s.hc[i] = -0.5f * row[4];
      s.op[i] = row[5];
      s.r[i] = row[6];
      s.g[i] = row[7];
      s.b[i] = row[8];
    } else {
      s.mx[i] = s.my[i] = s.ha[i] = s.hb[i] = s.hc[i] = 0.0f;
      s.op[i] = s.r[i] = s.g[i] = s.b[i] = 0.0f;
    }
  }
}

// The nine [rows, cap] attribute planes of the single-view composite (B5f/B5b), in
// the attribute order above; padding slots carry opacity 0.
struct Planes {
  const float* p[9];
};

// Stages chunk c of plane row `row` (tile-local means, conic * -1/2), as load_chunk.
__device__ __forceinline__ void load_plane_chunk(Chunk& s, const Planes& pl, int row,
                                                 int c, int chunk, int cap, float cx,
                                                 float cy) {
  const size_t base = static_cast<size_t>(row) * cap + static_cast<size_t>(c) * chunk;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const size_t k = base + i;
    s.mx[i] = pl.p[0][k] - cx;
    s.my[i] = pl.p[1][k] - cy;
    s.ha[i] = -0.5f * pl.p[2][k];
    s.hb[i] = -0.5f * pl.p[3][k];
    s.hc[i] = -0.5f * pl.p[4][k];
    s.op[i] = pl.p[5][k];
    s.r[i] = pl.p[6][k];
    s.g[i] = pl.p[7][k];
    s.b[i] = pl.p[8][k];
  }
}

struct Alpha {
  float a;      // clamped alpha, 0 below ALPHA_MIN
  bool act;     // gradient gate: a >= ALPHA_MIN and the unclamped alpha < ALPHA_MAX
  float d0, d1;  // pixel minus tile-local mean
};

// Alpha of copy i at tile-local pixel (x, y) (pallas_splat.py _chunk_alpha).  Every
// product and sum is rounded on its own (__fmul_rn / __fadd_rn are never contracted
// into FMAs), in the plain PyTorch versions' order: ALPHA_MIN is a 1/255 step that a
// one-ulp difference could cross.
__device__ __forceinline__ Alpha alpha_at(const Chunk& s, int i, float x, float y) {
  Alpha r;
  r.d0 = __fsub_rn(x, s.mx[i]);
  r.d1 = __fsub_rn(y, s.my[i]);
  const float u = __fadd_rn(__fmul_rn(s.ha[i], r.d0), __fmul_rn(s.hb[i], r.d1));
  const float v = __fadd_rn(__fmul_rn(s.hb[i], r.d0), __fmul_rn(s.hc[i], r.d1));
  const float q = __fadd_rn(__fmul_rn(r.d0, u), __fmul_rn(r.d1, v));
  const float raw = __fmul_rn(s.op[i], expf(q));
  const float a = fminf(raw, kAlphaMax);
  const bool ge_min = a >= kAlphaMin;
  r.a = ge_min ? a : 0.0f;
  r.act = ge_min && raw < kAlphaMax;
  return r;
}

}  // namespace gsvc
