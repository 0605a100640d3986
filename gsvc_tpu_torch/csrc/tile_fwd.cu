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
// What bounds it on an H100: issued FP32 instructions, as kernel B1.  Each evaluated
// (copy, pixel) pair costs an alpha (quadratic form, expf; every product and sum of the
// alpha rounded on its own, so no FMA) and one compositing step, ~25 FP32 operations,
// while a row reads 36 B per copy once (shared by its P pixels) and writes 4
// (+ n_chunks + 1) floats per pixel.
//
// What the design does about it: kernel B1's (mirror_fwd.cu) over the single view's
// planes, as kernel B6f (stream_fwd.cu) over the stream's.  One block per plane row;
// each thread owns one pixel column of the tile (threads a multiple of tile_w; 128
// threads x 8 pixels at 8x128 tiles) and keeps the column's transmittance and colour
// sums in registers, so a copy's x terms of the alpha are formed once per thread
// (replay.cuh column_at / alpha_col: the same rounded operations in the plain
// version's order, so the output equals B1's forward view bit for bit on the same
// copies).  The chunks are pipelined: while the block composites chunk c, cp.async
// copies chunk c + 1's nine plane runs (row * cap + (c + 1) * chunk) into the other of
// two shared-memory stages (replay.cuh stage_planes); each thread makes its own slots
// tile-local after they land, and the one barrier per chunk (the __syncthreads_or of
// the early stop) publishes them.  A chunk's walk ends at the row's count (clamped to
// cap where the list overflowed): the padding slots of a partly filled last chunk
// (opacity 0, zero alpha) are neither staged nor walked, and no stale slot of the other
// stage is read.  Block r composites row r: launching the rows heaviest first ran the
// kernel 5% faster, but the sort of the counts cost more than that saved.  The TPU
// kernel's log-space triangular-matmul cumsum (a Mosaic workaround) becomes a
// per-pixel running product inside the chunk (t_before = T_carry * E, E *= 1 - alpha);
// the carry multiplies by the unmasked chunk product, and a copy contributes only where
// t_before >= T_EPS, as on the TPU.  Each block writes only its own rows of out and
// t_chk.
//
// Precision modes (template parameter MODE; render/mirror.py's table), as kernel B1
// takes them: in compute_dtype "bfloat16" a thread evaluates the alphas of two rows of
// its column at once in __nv_bfloat162 lanes (replay.cuh alpha_at / alpha_col2, bit for
// bit the plain version's bf16 alpha); in matmul_dtype "bfloat16" each copy's in-chunk
// factor is exp(bf16(log1p(-a))) beside the chunk's float32 product of (1 - a), which
// carries T to the next chunk and into t_chk.  MODE 0 is the float32 kernel.
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
tile_fwd_kernel(Planes pl, const int* __restrict__ counts, float* __restrict__ out,
                float* __restrict__ tchk, int n_tiles, int n_tiles_x, int tile_w, int cap,
                int chunk, float bg) {
  __shared__ Stage st[2];
  const int row = blockIdx.x;
  const int u = row % n_tiles;
  const int tx = u % n_tiles_x;
  const int p_pix = blockDim.x * PPT;
  const int tile_h = p_pix / tile_w;
  const float cx = static_cast<float>(tx * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int n_chunks = cap / chunk;
  const int count = min(counts[row], cap);
  const int n_used = (count + chunk - 1) / chunk;
  const size_t base = static_cast<size_t>(row) * cap;
  float* tc = tchk ? tchk + static_cast<size_t>(row) * (n_chunks + 1) * p_pix : nullptr;

  // pixel k of this thread: lin = threadIdx.x + k * blockDim.x, all in one column
  const float x = static_cast<float>(threadIdx.x % tile_w) - (tile_w - 1) / 2.0f;
  float ys[PPT], t[PPT], acc[PPT][3];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
    ys[k] = static_cast<float>(lin / tile_w) - (tile_h - 1) / 2.0f;
    t[k] = 1.0f;
    acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
  }

  // copies in chunk c: the slots past the count are padding
  auto real = [&](int c) { return min(chunk, count - c * chunk); };
  if (n_used > 0) {
    stage_planes(st[0], pl, base, real(0));
    cp_async_commit();
    cp_async_wait_all();
    finish_planes(st[0], real(0), cx, cy);
  }

  int c = 0;
  for (; c < n_used; ++c) {
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= t[k] >= kTEps;
    // publishes stage c; the reads of stage c - 1 are done
    if (!__syncthreads_or(live)) break;
    if (tc) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) tc[c * p_pix + threadIdx.x + k * blockDim.x] = t[k];
    }
    const int s = c & 1;
    if (c + 1 < n_used)
      stage_planes(st[s ^ 1], pl, base + static_cast<size_t>(c + 1) * chunk, real(c + 1));
    cp_async_commit();

    const Stage& S = st[s];
    const int n = real(c);
    // e: the in-chunk product of the copies' factors; pm: the chunk's float32
    // product of (1 - a), the same as e but in matmul_dtype "bfloat16"
    float e[PPT], pm[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) e[k] = pm[k] = 1.0f;
    for (int j = 0; j < n; ++j) {
      const ColumnBf16 cm = column_mode<MODE>(S, j, x);
      const Column& cl = cm.f;
      Alpha next;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float a = alpha_at<MODE>(cm, ys, k, next).a;
        const float tb = t[k] * e[k];
        if (tb >= kTEps) {
          const float w = a * tb;
          acc[k][0] += w * cl.r;
          acc[k][1] += w * cl.g;
          acc[k][2] += w * cl.b;
        }
        e[k] *= trans_factor<MODE>(a);
        if (MODE & kTransBf16) pm[k] *= 1.0f - a;
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) t[k] *= (MODE & kTransBf16) ? pm[k] : e[k];
    cp_async_wait_all();
    if (c + 1 < n_used) finish_planes(st[s ^ 1], real(c + 1), cx, cy);
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

template <int MODE>
cudaError_t launch(int ppt, int n_rows, int threads, cudaStream_t st, const Planes& pl,
                   const int* counts, float* out, float* tchk, int n_tiles, int n_tiles_x,
                   int tile_w, int cap, int chunk, float bg) {
#define GSVC_TILE_FWD_LAUNCH(P)                                                          \
  tile_fwd_kernel<P, MODE><<<n_rows, threads, 0, st>>>(pl, counts, out, tchk, n_tiles,  \
                                                       n_tiles_x, tile_w, cap, chunk, bg)
  switch (ppt) {
    case 1: GSVC_TILE_FWD_LAUNCH(1); break;
    case 2: GSVC_TILE_FWD_LAUNCH(2); break;
    case 4: GSVC_TILE_FWD_LAUNCH(4); break;
    case 8: GSVC_TILE_FWD_LAUNCH(8); break;
    case 16: GSVC_TILE_FWD_LAUNCH(16); break;
    default: return cudaErrorInvalidValue;
  }
#undef GSVC_TILE_FWD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Launches one block per plane row on `stream`: n_rows blocks of `threads` threads (a
// multiple of tile_w) with `ppt` pixels each.  planes is a host array of nine device
// pointers to [n_rows, cap] f32 planes; counts [n_rows] i32, out [n_rows, 4, P] f32 and
// tchk [n_rows, cap / chunk + 1, P] f32 (or null: no checkpoints) are device pointers,
// P = threads * ppt = tile_h * tile_w.  `mode` is render/bidir.py check_precision's
// kAlphaBf16 and kTransBf16 bits (0: float32; a forward under bf16x2 is the float32
// one); any other value is refused.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int tile_forward(const float* const* planes, const int* counts, float* out,
                            float* tchk, int n_rows, int n_tiles, int n_tiles_x,
                            int tile_w, int cap, int chunk, int threads, int ppt, int mode,
                            float bg, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || cap % chunk != 0 || threads <= 0 ||
      threads > kMaxThreads || tile_w <= 0 || threads % tile_w != 0 || n_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  Planes pl;
  for (int i = 0; i < 9; ++i) pl.p[i] = planes[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gsvc::forward_mode(mode, [&](auto m) {
    return launch<decltype(m)::value>(ppt, n_rows, threads, st, pl, counts, out, tchk,
                                      n_tiles, n_tiles_x, tile_w, cap, chunk, bg);
  }));
}
