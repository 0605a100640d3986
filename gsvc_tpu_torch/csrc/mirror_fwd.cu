// Kernel B1 of the PyTorch/CUDA port: the training forward composite of the
// forward and x-mirrored views.
//
// Replaces the TPU kernel _fwd_kernel_mirror (gsvc_tpu/render/pallas_splat.py:636,
// launched by _mirror_call, :854).  For F frames it composites, from the forward
// view's depth-sorted tile lists alone, the forward view and the x-flipped view:
// a flip step reads data tile u, evaluates alpha at negated tile-centred x, walks
// the chunks from the last used one down (and each chunk's copies bottom-up), and
// writes the output tile mirror(u).  Output rows are in view order (f0 fwd, f0 flip,
// f1 fwd, f1 flip).  It saves the transmittance before every composite position
// (t_chk [2F*T, n_chunks + 1, P]; positions after the per-tile early stop hold the
// final T, slot n_chunks the exact final T) for kernel B2's replay.  The Python
// wrapper is gsvc_tpu_torch/render/mirror.py, whose plain PyTorch version computes the
// same function.
//
// What bounds it on an H100: issued FP32 instructions.  Each evaluated (copy, pixel)
// pair costs an alpha (quadratic form, expf) and one compositing step, ~25 FP32
// operations; the alpha's products and sums are rounded one by one (no FMA: ALPHA_MIN
// is a 1/255 step a one-ulp difference could cross), so each is one issue slot and the
// floor in issued instructions sits ~2x above the FLOP bound.  A tile reads 36 B per
// copy once (shared by its 1024 pixels) and writes 4 + n_chunks + 1 floats per pixel.
//
// What the design does about it: one block per (data tile, view) step; each thread owns
// one pixel column of the tile (threads a multiple of tile_w; 128 threads x 8 pixels at
// 8x128 tiles) and keeps the column's transmittance and colour sums in registers.  The
// column shares x, so a copy's x terms of the alpha (x - mean x and its two conic
// products) are formed once per thread instead of once per pixel (replay.cuh
// alpha_col: rounded in the plain version's order).  The chunks are pipelined: while
// the block composites chunk p, cp.async gathers chunk p + 1's rows from the [M, 9]
// rows into the other of two shared-memory stages and chunk p + 2's ids into the other
// of two id buffers; the issuing thread makes its own rows tile-local after they land,
// and the one barrier per chunk (the __syncthreads_or of the early stop) publishes
// them.  A copy is read from the stage with three vector loads.  The TPU kernel's
// log-space triangular-matmul cumsum (a Mosaic workaround) becomes a per-pixel running
// product inside the chunk (t_before = T_carry * E, E *= 1 - alpha).  Loop stops are per
// tile and chunk-granular, as the TPU kernel's while-loop.  The two views of a data tile
// are independent blocks: the forward writes no shared row.
//
// Precision modes (template parameter MODE; render/mirror.py's table): in compute_dtype
// "bfloat16" a thread evaluates the alphas of two rows of its column at once in
// __nv_bfloat162 lanes (replay.cuh alpha_col2: packed bf16 arithmetic, HFMA2.BF16 and
// friends, two pixels an instruction, the column's x terms formed once), bit for bit the
// plain version's bf16 alpha; in matmul_dtype "bfloat16" each copy's in-chunk factor is
// exp(bf16(log1p(-a))) beside the chunk's float32 product of (1 - a), which carries T to
// the next chunk and into t_chk.  MODE 0 is the float32 kernel.
#include "replay.cuh"

namespace {

using gsvc::Alpha;
using gsvc::Column;
using gsvc::ColumnBf16;
using gsvc::Stage;
using gsvc::alpha_at;
using gsvc::column_mode;
using gsvc::cp_async_commit;
using gsvc::cp_async_wait_all;
using gsvc::finish_rows;
using gsvc::kTransBf16;
using gsvc::kMaxChunk;
using gsvc::kMaxThreads;
using gsvc::kTEps;
using gsvc::stage_ids;
using gsvc::stage_rows;
using gsvc::trans_factor;

template <int PPT, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
mirror_fwd_kernel(const float* __restrict__ attrs, const int* __restrict__ lists,
                  const int* __restrict__ counts, float* __restrict__ out,
                  float* __restrict__ tchk, int m, int n_tiles, int n_tiles_x, int tile_w,
                  int cap, int chunk, float bg) {
  __shared__ Stage st[2];
  __shared__ int ids[2][kMaxChunk];
  const int g = blockIdx.x;            // grid step (f * T + u) * 2 + v
  const int d = g >> 1;                // data tile row f * T + u
  const int v = g & 1;                 // 0: forward view, 1: flip view
  const int f = d / n_tiles;
  const int u = d - f * n_tiles;
  const int tx = u % n_tiles_x;
  const int out_row = (2 * f + v) * n_tiles + (v ? u + (n_tiles_x - 1) - 2 * tx : u);
  const int p_pix = blockDim.x * PPT;
  const int tile_h = p_pix / tile_w;
  const float* rows = attrs + static_cast<size_t>(f) * m * 9;
  const int* list = lists + static_cast<size_t>(d) * cap;
  const float cx = static_cast<float>(tx * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int n_chunks = cap / chunk;
  const int n_used = min((counts[d] + chunk - 1) / chunk, n_chunks);
  float* tc = tchk + static_cast<size_t>(out_row) * (n_chunks + 1) * p_pix;

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

  // data chunk at composite position q
  auto chunk_at = [&](int q) { return v ? n_used - 1 - q : q; };
  if (n_used > 0) {
    stage_ids(ids[0], list, chunk_at(0), chunk);
    cp_async_commit();
    cp_async_wait_all();
    stage_rows(st[0], ids[0], rows, chunk, m);
    if (n_used > 1) stage_ids(ids[1], list, chunk_at(1), chunk);
    cp_async_commit();
    cp_async_wait_all();
    finish_rows(st[0], ids[0], chunk, m, cx, cy);
  }

  int p = 0;
  for (; p < n_used; ++p) {
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= t[k] >= kTEps;
    // publishes stage p and ids p + 1; the reads of stage p - 1 are done
    if (!__syncthreads_or(live)) break;
#pragma unroll
    for (int k = 0; k < PPT; ++k) tc[p * p_pix + threadIdx.x + k * blockDim.x] = t[k];
    const int b = p & 1;
    if (p + 1 < n_used) stage_rows(st[b ^ 1], ids[b ^ 1], rows, chunk, m);
    if (p + 2 < n_used) stage_ids(ids[b], list, chunk_at(p + 2), chunk);
    cp_async_commit();

    const Stage& s = st[b];
    // e: the in-chunk product of the copies' factors; pm: the chunk's float32
    // product of (1 - a), the same as e but in matmul_dtype "bfloat16"
    float e[PPT], pm[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) e[k] = pm[k] = 1.0f;
    for (int j = 0; j < chunk; ++j) {
      const ColumnBf16 cm = column_mode<MODE>(s, v ? chunk - 1 - j : j, x);
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
    if (p + 1 < n_used) finish_rows(st[b ^ 1], ids[b ^ 1], chunk, m, cx, cy);
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
    for (int q = p; q <= n_chunks; ++q) tc[q * p_pix + lin] = t[k];
    float* o = out + static_cast<size_t>(out_row) * 4 * p_pix;
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c * p_pix + lin] = acc[k][c] + t[k] * bg;
    o[3 * p_pix + lin] = t[k];
  }
}

template <int MODE>
cudaError_t launch(int ppt, int blocks, int threads, cudaStream_t st, const float* attrs,
                   const int* lists, const int* counts, float* out, float* tchk, int m,
                   int n_tiles, int n_tiles_x, int tile_w, int cap, int chunk, float bg) {
#define GSVC_MIRROR_FWD_LAUNCH(P)                                                        \
  mirror_fwd_kernel<P, MODE><<<blocks, threads, 0, st>>>(attrs, lists, counts, out, tchk, \
                                                         m, n_tiles, n_tiles_x, tile_w,  \
                                                         cap, chunk, bg)
  switch (ppt) {
    case 1: GSVC_MIRROR_FWD_LAUNCH(1); break;
    case 2: GSVC_MIRROR_FWD_LAUNCH(2); break;
    case 4: GSVC_MIRROR_FWD_LAUNCH(4); break;
    case 8: GSVC_MIRROR_FWD_LAUNCH(8); break;
    case 16: GSVC_MIRROR_FWD_LAUNCH(16); break;
    default: return cudaErrorInvalidValue;
  }
#undef GSVC_MIRROR_FWD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Launches one block per (data tile, view) step on `stream`: 2 * n_frames * n_tiles
// blocks of `threads` threads (a multiple of tile_w) with `ppt` pixels each.  Pointers
// are device pointers: attrs [n_frames, m, 9] f32, lists [n_frames * n_tiles, cap] i32
// (-1 padded), counts [n_frames * n_tiles] i32, out [2 * n_frames * n_tiles, 4,
// threads * ppt] f32, tchk [2 * n_frames * n_tiles, cap / chunk + 1, threads * ppt] f32.
// `mode` is render/bidir.py check_precision's kAlphaBf16 and kTransBf16 bits (0:
// float32; a forward under bf16x2 is the float32 one); any other value is refused.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mirror_forward(const float* attrs, const int* lists, const int* counts,
                              float* out, float* tchk, int n_frames, int m, int n_tiles,
                              int n_tiles_x, int tile_w, int cap, int chunk, int threads,
                              int ppt, int mode, float bg, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || cap % chunk != 0 || threads <= 0 ||
      threads > kMaxThreads || tile_w <= 0 || threads % tile_w != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = 2 * n_frames * n_tiles;
  if (blocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gsvc::forward_mode(mode, [&](auto md) {
    return launch<decltype(md)::value>(ppt, blocks, threads, st, attrs, lists, counts, out,
                                       tchk, m, n_tiles, n_tiles_x, tile_w, cap, chunk,
                                       bg);
  }));
}
