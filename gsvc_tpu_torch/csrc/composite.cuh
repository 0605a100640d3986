// Shared pieces of the port's tile-compositing kernels (B1 mirror_fwd.cu, B2
// mirror_bwd.cu, B4 bidir.cu, B5f tile_fwd.cu, B5b tile_bwd.cu, B6f stream_fwd.cu,
// B6b stream_bwd.cu): the constants of the TPU kernels
// (gsvc_tpu/render/pallas_splat.py), the single-view planes and the alpha of a copy at
// a pixel.  The stage and the alpha's evaluation are in replay.cuh.
#pragma once

#include <cuda_runtime.h>

namespace gsvc {

constexpr float kTEps = 1e-4f;              // per-pixel early stop
constexpr float kAlphaMin = 1.0f / 255.0f;  // smaller alphas are zeroed
constexpr float kAlphaMax = 0.99f;
constexpr int kMaxChunk = 128;              // copies per shared-memory stage
constexpr int kMaxThreads = 256;

// The nine [rows, cap] attribute planes of the single-view composite (B5f/B5b): mean
// x/y, conic a/b/c, opacity and rgb; padding slots carry opacity 0.
struct Planes {
  const float* p[9];
};

struct Alpha {
  float a;      // clamped alpha, 0 below ALPHA_MIN
  bool act;     // gradient gate: a >= ALPHA_MIN and the unclamped alpha < ALPHA_MAX
  float d0, d1;  // pixel minus tile-local mean
};

}  // namespace gsvc
