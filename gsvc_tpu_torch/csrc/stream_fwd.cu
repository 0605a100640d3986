// Kernel B6f of the PyTorch/CUDA port: the forward composite of the forward and
// x-mirrored views straight from the chunk-aligned copy stream.
//
// Replaces the TPU kernel _fwd_kernel_stream (gsvc_tpu/render/pallas_stream.py:103,
// launched by _stream_call, :325).  The copy stream (render/splat.py
// bin_gaussians_stream) gives every (frame, tile) nblk consecutive blocks of `chunk`
// depth-sorted slots; the stream rows are [9, n_slots] (mean x/y, conic a/b/c, opacity,
// rgb; dead slots all zero).  For each (data tile, view) it walks the tile's blocks:
// the forward view front to back, the flip view back to front with each block's copies
// bottom-up, alpha evaluated at negated tile-centred x, writing the output tile
// mirror(u).  Output rows are in view order (f0 fwd, f0 flip, f1 fwd, f1 flip).  In
// training it saves the transmittance at the start of every block the tile owns,
// tchk [2, n_frames * b_max, P] (view, stream block); blocks after the tile's early
// stop hold its final T.  The Python wrapper is gsvc_tpu_torch/render/stream.py, whose
// plain PyTorch version computes the same function.
//
// What bounds it on an H100: issued FP32 instructions, as kernel B1.  Each evaluated
// (copy, pixel) pair costs an alpha and one compositing step, ~25 FP32 operations,
// every product and sum of the alpha rounded on its own (no FMA); a tile reads 36 B per
// slot once (shared by its P pixels) and writes 4 floats per pixel plus one per owned
// block.
//
// What the design does about it: kernel B1's (mirror_fwd.cu) over the stream's planes.
// One block per (data tile, view); each thread owns one pixel column of the tile
// (threads a multiple of tile_w; 128 threads x 8 pixels at 8x128 tiles) and keeps the
// column's transmittance and colour sums in registers, so a copy's x terms of the alpha
// are formed once per thread (replay.cuh column_at / alpha_col: B1's rounded
// operations, so the output equals B1's bit for bit on the same copies).
// The TPU kernel's grid of (view, stream block) with index maps and a trash row becomes
// a walk over the tile's own blocks, whose first block is the exclusive cumsum of nblk
// (frame offsets included, computed by the wrapper), so dead blocks are never visited.
// The blocks are pipelined: while the block composites stream block p, cp.async copies
// block p + 1's nine plane runs (the stream rows at b * chunk) into the other of two
// shared-memory stages (replay.cuh stage_planes); each thread makes its own slots
// tile-local after they land, and the one barrier per block (the __syncthreads_or of
// the early stop) publishes them.  A block's walk ends at its live slots: a tile's
// copies fill its span from the first slot on (render/splat.py bin_gaussians_stream),
// so the live slots of a block are a prefix of it, and the padding after them (opacity
// 0, zero alpha) is neither staged nor walked.  Stops are B1's, block-granular: a block
// runs only while some pixel of the tile keeps T >= T_EPS, and each pixel is gated by
// t_before >= T_EPS.  The two views of a data tile are independent blocks.
//
// Precision modes (template parameter MODE; render/mirror.py's table), as kernel B1
// takes them: in compute_dtype "bfloat16" a thread evaluates the alphas of two rows of
// its column at once in __nv_bfloat162 lanes (replay.cuh alpha_at / alpha_col2, bit for
// bit the plain version's bf16 alpha); in matmul_dtype "bfloat16" each copy's in-block
// factor is exp(bf16(log1p(-a))) beside the block's float32 product of (1 - a), which
// carries T to the next block and into the checkpoints (the TPU kernel's t_scr carries
// its chunk_t).  MODE 0 is the float32 kernel.
#include "replay.cuh"

namespace {

using gsvc::Alpha;
using gsvc::Column;
using gsvc::ColumnBf16;
using gsvc::Planes;
using gsvc::Stage;
using gsvc::alpha_at;
using gsvc::column_mode;
using gsvc::cp_async_commit;
using gsvc::cp_async_wait_all;
using gsvc::finish_planes;
using gsvc::kMaxChunk;
using gsvc::kMaxThreads;
using gsvc::kTEps;
using gsvc::kTransBf16;
using gsvc::stage_planes;
using gsvc::trans_factor;

template <int PPT, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
stream_fwd_kernel(const float* __restrict__ rows, const int* __restrict__ nblk,
                  const int* __restrict__ first, const int* __restrict__ nlive,
                  float* __restrict__ out, float* __restrict__ tchk, size_t n_slots,
                  size_t n_blocks, int n_tiles, int n_tiles_x, int tile_w, int chunk,
                  float bg) {
  __shared__ Stage st[2];
  const int g = blockIdx.x;            // grid step (f * T + u) * 2 + v
  const int d = g >> 1;                // data tile row f * T + u
  const int v = g & 1;                 // 0: forward view, 1: flip view
  const int f = d / n_tiles;
  const int u = d - f * n_tiles;
  const int tx = u % n_tiles_x;
  const int out_row = (2 * f + v) * n_tiles + (v ? u + (n_tiles_x - 1) - 2 * tx : u);
  const int p_pix = blockDim.x * PPT;
  const int tile_h = p_pix / tile_w;
  const float cx = static_cast<float>(tx * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int nb = nblk[d];
  const int b0 = first[d];
  float* tc = tchk ? tchk + static_cast<size_t>(v) * n_blocks * p_pix : nullptr;
  Planes pl;
#pragma unroll
  for (int q = 0; q < 9; ++q) pl.p[q] = rows + q * n_slots;

  // pixel k of this thread: lin = threadIdx.x + k * blockDim.x, all in one column
  const float x0 = static_cast<float>(threadIdx.x % tile_w) - (tile_w - 1) / 2.0f;
  const float x = v ? -x0 : x0;
  float ys[PPT], t[PPT], acc[PPT][3];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
    ys[k] = static_cast<float>(lin / tile_w) - (tile_h - 1) / 2.0f;
    t[k] = 1.0f;
    acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
  }

  // stream block at composite position q
  auto block_at = [&](int q) { return static_cast<size_t>(b0 + (v ? nb - 1 - q : q)); };
  // live slots of the blocks at positions p (staged) and p + 1
  int n = 0, n_next = 0;
  if (nb > 0) {
    n = nlive[block_at(0)];
    stage_planes(st[0], pl, block_at(0) * chunk, n);
    cp_async_commit();
    if (nb > 1) n_next = nlive[block_at(1)];
    cp_async_wait_all();
    finish_planes(st[0], n, cx, cy);
  }

  int p = 0;
  for (; p < nb; ++p) {
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= t[k] >= kTEps;
    // publishes stage p; the reads of stage p - 1 are done
    if (!__syncthreads_or(live)) break;
    if (tc) {
      const size_t b = block_at(p);
#pragma unroll
      for (int k = 0; k < PPT; ++k) tc[b * p_pix + threadIdx.x + k * blockDim.x] = t[k];
    }
    const int s = p & 1;
    if (p + 1 < nb) stage_planes(st[s ^ 1], pl, block_at(p + 1) * chunk, n_next);
    cp_async_commit();
    const int n_after = p + 2 < nb ? nlive[block_at(p + 2)] : 0;

    const Stage& S = st[s];
    // e: the in-block product of the copies' factors; pm: the block's float32
    // product of (1 - a), the same as e but in matmul_dtype "bfloat16"
    float e[PPT], pm[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) e[k] = pm[k] = 1.0f;
    for (int j = 0; j < n; ++j) {
      const ColumnBf16 cm = column_mode<MODE>(S, v ? n - 1 - j : j, x);
      const Column& c = cm.f;
      Alpha next;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float a = alpha_at<MODE>(cm, ys, k, next).a;
        const float tb = t[k] * e[k];
        if (tb >= kTEps) {
          const float w = a * tb;
          acc[k][0] += w * c.r;
          acc[k][1] += w * c.g;
          acc[k][2] += w * c.b;
        }
        e[k] *= trans_factor<MODE>(a);
        if (MODE & kTransBf16) pm[k] *= 1.0f - a;
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) t[k] *= (MODE & kTransBf16) ? pm[k] : e[k];
    cp_async_wait_all();
    if (p + 1 < nb) finish_planes(st[s ^ 1], n_next, cx, cy);
    n = n_next;
    n_next = n_after;
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
    if (tc) {
      for (int q = p; q < nb; ++q) tc[block_at(q) * p_pix + lin] = t[k];
    }
    float* o = out + static_cast<size_t>(out_row) * 4 * p_pix;
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c * p_pix + lin] = acc[k][c] + t[k] * bg;
    o[3 * p_pix + lin] = t[k];
  }
}

template <int MODE>
cudaError_t launch(int ppt, int blocks, int threads, cudaStream_t st, const float* rows,
                   const int* nblk, const int* first, const int* nlive, float* out,
                   float* tchk, size_t n_slots, size_t n_blocks, int n_tiles,
                   int n_tiles_x, int tile_w, int chunk, float bg) {
#define GSVC_STREAM_FWD_LAUNCH(P)                                                    \
  stream_fwd_kernel<P, MODE><<<blocks, threads, 0, st>>>(                            \
      rows, nblk, first, nlive, out, tchk, n_slots, n_blocks, n_tiles, n_tiles_x,    \
      tile_w, chunk, bg)
  switch (ppt) {
    case 1: GSVC_STREAM_FWD_LAUNCH(1); break;
    case 2: GSVC_STREAM_FWD_LAUNCH(2); break;
    case 4: GSVC_STREAM_FWD_LAUNCH(4); break;
    case 8: GSVC_STREAM_FWD_LAUNCH(8); break;
    case 16: GSVC_STREAM_FWD_LAUNCH(16); break;
    default: return cudaErrorInvalidValue;
  }
#undef GSVC_STREAM_FWD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Launches one block per (data tile, view) step on `stream`: 2 * n_frames * n_tiles
// blocks of `threads` threads (a multiple of tile_w) with `ppt` pixels each.  Pointers
// are device pointers: rows [9, n_frames * b_max * chunk] f32, nblk and first
// [n_frames * n_tiles] i32 (each tile's block count and first stream block, frame
// offsets f * b_max included), nlive [n_frames * b_max] i32 (each block's live slots, a
// prefix of the block), out [2 * n_frames * n_tiles, 4, threads * ppt] f32, tchk
// [2, n_frames * b_max, threads * ppt] f32 or null (inference).  `mode` is
// render/bidir.py check_precision's kAlphaBf16 and kTransBf16 bits (0: float32; a
// forward under bf16x2 is the float32 one); any other value is refused.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int stream_forward(const float* rows, const int* nblk, const int* first,
                              const int* nlive, float* out, float* tchk, int n_frames,
                              int n_tiles, int n_tiles_x, int tile_w, int chunk, int b_max,
                              int threads, int ppt, int mode, float bg, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || threads <= 0 || threads > kMaxThreads ||
      tile_w <= 0 || threads % tile_w != 0 || b_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = 2 * n_frames * n_tiles;
  if (blocks == 0) return 0;
  const size_t n_blocks = static_cast<size_t>(n_frames) * b_max;
  const size_t n_slots = n_blocks * chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gsvc::forward_mode(mode, [&](auto m) {
    return launch<decltype(m)::value>(ppt, blocks, threads, st, rows, nblk, first, nlive,
                                      out, tchk, n_slots, n_blocks, n_tiles, n_tiles_x,
                                      tile_w, chunk, bg);
  }));
}
