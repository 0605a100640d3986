// Kernel B5f of the PyTorch/CUDA port: the single-view forward composite over
// concatenated views.
//
// Replaces the TPU kernel _fwd_kernel (gsvc_tpu/render/pallas_splat.py:277, launched by
// _composite_call, :530).  It composites each row of the nine [V*T, cap] attribute
// planes (V views of T tiles each, concatenated; row r composites tile r % T): the
// depth-sorted copies front to back, chunk by chunk, stopping at the first chunk
// boundary where the row's list is used up or no pixel of the tile (those past the
// image's right and bottom edges included) keeps T >= T_EPS.  In training it saves the
// transmittance before every chunk (t_chk [V*T, n_chunks + 1, P]; chunks after the stop
// hold the final T, slot n_chunks the exact final T) for kernel B5b's reverse replay.
// The Python wrapper is gsvc_tpu_torch/render/tile.py, whose plain PyTorch version
// computes the same function.
//
// What bounds it on an H100: arithmetic.  Each evaluated (copy, pixel) pair costs an
// alpha (quadratic form, expf) and one compositing step, ~25 FP32 operations, while a
// row reads 36 B per copy once (shared by its P pixels) and writes 4 (+ n_chunks + 1)
// floats per pixel.
//
// What the design does about it: one block per plane row; each thread owns PPT pixels
// and keeps their transmittance and colour sums in registers.  Each chunk of <= 128
// copies is staged in shared memory once (tile-local means, conic pre-scaled by -1/2)
// and read as broadcasts.  The TPU kernel's log-space triangular-matmul cumsum (a
// Mosaic workaround) becomes a per-pixel running product inside the chunk (t_before =
// T_carry * E, E *= 1 - alpha); the carry multiplies by the unmasked chunk product, and
// a copy contributes only where t_before >= T_EPS, as on the TPU.  The stop is per row
// and chunk-granular (__syncthreads_or), as the TPU kernel's while-loop.  The alpha is
// computed without FMA contraction, in the plain version's order (see alpha_at).  Each
// block writes only its own rows of out and t_chk.
#include "composite.cuh"

namespace {

using gsvc::Chunk;
using gsvc::Planes;
using gsvc::alpha_at;
using gsvc::kMaxChunk;
using gsvc::kMaxThreads;
using gsvc::kTEps;
using gsvc::load_plane_chunk;

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
tile_fwd_kernel(Planes pl, const int* __restrict__ counts, float* __restrict__ out,
                float* __restrict__ tchk, int n_tiles, int n_tiles_x, int tile_w, int cap,
                int chunk, float bg) {
  __shared__ Chunk s;
  const int row = blockIdx.x;
  const int u = row % n_tiles;
  const int tx = u % n_tiles_x;
  const int p_pix = blockDim.x * PPT;
  const int tile_h = p_pix / tile_w;
  const float cx = static_cast<float>(tx * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int n_chunks = cap / chunk;
  const int n_used = min((counts[row] + chunk - 1) / chunk, n_chunks);
  float* tc = tchk ? tchk + static_cast<size_t>(row) * (n_chunks + 1) * p_pix : nullptr;

  float xs[PPT], ys[PPT], t[PPT], acc[PPT][3];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
    xs[k] = static_cast<float>(lin % tile_w) - (tile_w - 1) / 2.0f;
    ys[k] = static_cast<float>(lin / tile_w) - (tile_h - 1) / 2.0f;
    t[k] = 1.0f;
    acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
  }

  int c = 0;
  for (; c < n_used; ++c) {
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= t[k] >= kTEps;
    if (!__syncthreads_or(live)) break;  // also: stage reads of chunk c-1 are done
    if (tc) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) tc[c * p_pix + threadIdx.x + k * blockDim.x] = t[k];
    }
    load_plane_chunk(s, pl, row, c, chunk, cap, cx, cy);
    __syncthreads();
    float e[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) e[k] = 1.0f;
    for (int i = 0; i < chunk; ++i) {
      const float cr = s.r[i], cg = s.g[i], cb = s.b[i];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float a = alpha_at(s, i, xs[k], ys[k]).a;
        const float tb = t[k] * e[k];
        if (tb >= kTEps) {
          const float w = a * tb;
          acc[k][0] += w * cr;
          acc[k][1] += w * cg;
          acc[k][2] += w * cb;
        }
        e[k] *= 1.0f - a;
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) t[k] *= e[k];
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
    if (tc)
      for (int q = c; q <= n_chunks; ++q) tc[q * p_pix + lin] = t[k];
    float* o = out + static_cast<size_t>(row) * 4 * p_pix;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[ch * p_pix + lin] = acc[k][ch] + t[k] * bg;
    o[3 * p_pix + lin] = t[k];
  }
}

}  // namespace

// Launches one block per plane row on `stream`: n_rows blocks.  planes is a host array
// of nine device pointers to [n_rows, cap] f32 planes; counts [n_rows] i32, out
// [n_rows, 4, P] f32 and tchk [n_rows, cap / chunk + 1, P] f32 (or null: no
// checkpoints) are device pointers, P = threads * ppt = tile_h * tile_w.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tile_forward(const float* const* planes, const int* counts, float* out,
                            float* tchk, int n_rows, int n_tiles, int n_tiles_x,
                            int tile_w, int cap, int chunk, int threads, int ppt,
                            float bg, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || cap % chunk != 0 || threads <= 0 ||
      threads > kMaxThreads || tile_w <= 0 || (threads * ppt) % tile_w != 0 ||
      n_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  Planes pl;
  for (int i = 0; i < 9; ++i) pl.p[i] = planes[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GSVC_TILE_FWD_LAUNCH(P)                                                     \
  tile_fwd_kernel<P><<<n_rows, threads, 0, st>>>(pl, counts, out, tchk, n_tiles,   \
                                                 n_tiles_x, tile_w, cap, chunk, bg)
  switch (ppt) {
    case 1: GSVC_TILE_FWD_LAUNCH(1); break;
    case 2: GSVC_TILE_FWD_LAUNCH(2); break;
    case 4: GSVC_TILE_FWD_LAUNCH(4); break;
    case 8: GSVC_TILE_FWD_LAUNCH(8); break;
    case 16: GSVC_TILE_FWD_LAUNCH(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSVC_TILE_FWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
