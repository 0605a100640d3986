// Kernel B4 of the PyTorch/CUDA port: the bidirectional decode composite.
//
// Replaces the TPU kernel _fwd_kernel_bidir (gsvc_tpu/render/pallas_splat.py:1074,
// launched by _bidir_call / bidir_composite_attrs, :1149 / :1178).  It computes the
// decoded frame, the average of the forward and x-flipped views, from the forward
// view's depth-sorted tile lists with one alpha evaluation per (copy, pixel):
//
//   out(p) = 1/2 [ sum_i a_i c_i T_i  +  sum_i a_i c_i S_i ]
//
// T_i the front prefix product of (1 - a), S_i the back suffix product.  A front loop
// composites the forward view and accumulates the suffix sum by Horner's rule
// (W <- W (1 - a) + a c); it stops at the first chunk boundary where no pixel of the
// tile keeps T >= T_EPS.  A back loop walks from the last used chunk down to that
// stop, compositing the flip view until its transmittance saturates.  Dropped terms
// carry weight < T_EPS.  The Python wrapper is gsvc_tpu_torch/render/bidir.py, whose
// plain PyTorch version computes the same function.
//
// What bounds it on an H100: arithmetic.  Each (copy, pixel) pair costs one alpha
// (quadratic form + expf) and two compositing updates, some 32 FP32 operations and
// an SFU exponential, while the bytes are small: a tile reads its id list and its
// copies' 9 attributes once (36 B per copy, shared by the tile's 2048 pixels) and
// writes 4 floats per pixel.  At 1080p that is ~45 MB against ~10^10 operations.
//
// What the design does about it: one block per data tile; each thread owns
// PPT pixels of the tile and keeps their front transmittance, forward colour sum
// and Horner back-suffix sum in registers, so the inner loop touches no memory but
// the chunk stage.  Each chunk of <= 128 copies is gathered from the [M, 9] rows into
// shared memory once (4.6 KB, conic pre-scaled by -1/2, means made tile-local) and
// read as broadcasts.  The TPU kernel's triangular-matmul cumsums (a Mosaic
// workaround: it has no cumsum) become per-pixel sequential products.  Loop stops
// are per tile and chunk-granular (__syncthreads_or), exactly as the TPU kernel's
// while-loops, so kernel and plain version agree to float rounding.  The alpha is
// computed without FMA contraction, as the plain version computes it (see alpha_at).
#include "composite.cuh"

namespace {

using gsvc::Chunk;
using gsvc::alpha_at;
using gsvc::kMaxChunk;
using gsvc::kMaxThreads;
using gsvc::kTEps;
using gsvc::load_chunk;

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
bidir_kernel(const float* __restrict__ attrs, const int* __restrict__ lists,
             const int* __restrict__ counts, float* __restrict__ out, int m,
             int n_tiles, int n_tiles_x, int tile_w, int cap, int chunk, float bg) {
  __shared__ Chunk s;
  const int g = blockIdx.x;            // data tile: frame * n_tiles + tile
  const int f = g / n_tiles;
  const int u = g - f * n_tiles;
  const int p_pix = blockDim.x * PPT;
  const int tile_h = p_pix / tile_w;
  const float* rows = attrs + static_cast<size_t>(f) * m * 9;
  const int* list = lists + static_cast<size_t>(g) * cap;
  const float cx = static_cast<float>((u % n_tiles_x) * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int n_chunks = cap / chunk;
  const int n_used = min((counts[g] + chunk - 1) / chunk, n_chunks);

  float xs[PPT], ys[PPT], tf[PPT], af[PPT][3], ah[PPT][3];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
    xs[k] = static_cast<float>(lin % tile_w) - (tile_w - 1) / 2.0f;
    ys[k] = static_cast<float>(lin / tile_w) - (tile_h - 1) / 2.0f;
    tf[k] = 1.0f;
    af[k][0] = af[k][1] = af[k][2] = 0.0f;
    ah[k][0] = ah[k][1] = ah[k][2] = 0.0f;
  }

  // front loop: forward view + Horner back-suffix accumulator
  int p = 0;
  for (; p < n_used; ++p) {
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= tf[k] >= kTEps;
    if (!__syncthreads_or(live)) break;  // also: stage reads of chunk p-1 are done
    load_chunk(s, rows, list, p, chunk, m, cx, cy);
    __syncthreads();
    for (int i = 0; i < chunk; ++i) {
      const float cr = s.r[i], cg = s.g[i], cb = s.b[i];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float a = alpha_at(s, i, xs[k], ys[k]).a;
        const float one_m = 1.0f - a;
        if (tf[k] >= kTEps) {
          const float w = a * tf[k];
          af[k][0] += w * cr;
          af[k][1] += w * cg;
          af[k][2] += w * cb;
        }
        ah[k][0] = ah[k][0] * one_m + a * cr;
        ah[k][1] = ah[k][1] * one_m + a * cg;
        ah[k][2] = ah[k][2] * one_m + a * cb;
        tf[k] *= one_m;
      }
    }
  }
  const int p_stop = p;

  // back loop: flip-view contributions of the chunks past the front stop
  float tb[PPT], ab[PPT][3];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    tb[k] = 1.0f;
    ab[k][0] = ab[k][1] = ab[k][2] = 0.0f;
  }
  for (int q = n_used - 1; q >= p_stop; --q) {
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= tb[k] >= kTEps;
    if (!__syncthreads_or(live)) break;
    load_chunk(s, rows, list, q, chunk, m, cx, cy);
    __syncthreads();
    for (int i = chunk - 1; i >= 0; --i) {
      const float cr = s.r[i], cg = s.g[i], cb = s.b[i];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float a = alpha_at(s, i, xs[k], ys[k]).a;
        if (tb[k] >= kTEps) {
          const float w = a * tb[k];
          ab[k][0] += w * cr;
          ab[k][1] += w * cg;
          ab[k][2] += w * cb;
        }
        tb[k] *= 1.0f - a;
      }
    }
  }

  float* o = out + static_cast<size_t>(g) * 4 * p_pix;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
    const float tau = tf[k] * tb[k];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c * p_pix + lin] = 0.5f * (af[k][c] + ab[k][c] + ah[k][c] * tb[k]) + tau * bg;
    o[3 * p_pix + lin] = tau;
  }
}

}  // namespace

// Launches one block per data tile on `stream`.  Pointers are device pointers:
// attrs [n_frames, m, 9] f32, lists [n_frames * n_tiles, cap] i32 (-1 padded),
// counts [n_frames * n_tiles] i32, out [n_frames * n_tiles, 4, threads * ppt] f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bidir_composite(const float* attrs, const int* lists, const int* counts,
                               float* out, int n_frames, int m, int n_tiles,
                               int n_tiles_x, int tile_w, int cap, int chunk,
                               int threads, int ppt, float bg, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || cap % chunk != 0 || threads <= 0 ||
      threads > kMaxThreads || tile_w <= 0 || (threads * ppt) % tile_w != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = n_frames * n_tiles;
  if (blocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GSVC_BIDIR_LAUNCH(P)                                                  \
  bidir_kernel<P><<<blocks, threads, 0, st>>>(attrs, lists, counts, out, m,  \
                                              n_tiles, n_tiles_x, tile_w, cap, \
                                              chunk, bg)
  switch (ppt) {
    case 1: GSVC_BIDIR_LAUNCH(1); break;
    case 2: GSVC_BIDIR_LAUNCH(2); break;
    case 4: GSVC_BIDIR_LAUNCH(4); break;
    case 8: GSVC_BIDIR_LAUNCH(8); break;
    case 16: GSVC_BIDIR_LAUNCH(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSVC_BIDIR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
