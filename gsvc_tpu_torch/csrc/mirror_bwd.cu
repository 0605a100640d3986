// Kernel B2 of the PyTorch/CUDA port: the training backward of the mirror composite.
//
// Replaces the TPU kernel _bwd_kernel_mirror (gsvc_tpu/render/pallas_splat.py:699,
// launched by _mirror_call_bwd, :906).  For each (data tile, view) step it replays the
// composite positions p_hot (the last position with a live pixel, read from kernel
// B1's t_chk) and before, and writes each copy's gradients of its 9 attributes (mean
// x/y, conic a/b/c, opacity, rgb) into grads [2F*T, 9, cap], one row per step
// g = (f * T + u) * 2 + v.  The two views of a data tile are separate rows; their sum
// (and the per-view mean columns the densification statistics read) is the scatter
// after the kernel (gsvc_tpu_torch/render/mirror.py scatter_grads), so no two blocks
// ever add into one row.  Slots the replay never reaches are written as zeros.
//
// Per copy i and pixel, with A_i the sum of w_j gc_j over the copies after i plus
// t_final * (bg * sum(g_rgb) + g_T):
//   dL/da = live && act ? gc t_before - A_i / max(1 - a, 1e-6) : 0,   dq = -a/2 dL/da,
// and the copy's gradients follow from six pixel sums of dq (1, d0, d1, d0^2, d0 d1,
// d1^2), d = pixel - mean (the TPU kernel's pixel-basis moments taken about the
// gaussian's mean: no fp32 cancellation), plus dL/dc = sum w g_rgb.  The 1 / (1 - a) is
// an exact division, as the TPU kernel computes it off the TPU.
//
// What bounds it on an H100: issued FP32 instructions.  A replayed (copy, pixel) pair
// costs an alpha (quadratic form, expf; every product and sum rounded on its own, so no
// FMA) and ~35 more operations of backward algebra, with the exact division; bytes are
// t_chk, out4 and g_out (read once per step) and the [9, cap] gradient row.
//
// What the design does about it (replay.cuh, replay_chunk):
//   * One alpha evaluation per replayed pair.  The walk goes FORWARD through the
//     chunks, from position 0 to p_hot, with t_before = t_chk[p] times the running
//     product of (1 - a): B1's own product, so the liveness decisions are B1's.  The
//     suffix needs no first pass: since out4 = sum_j w_j c_j + t_final bg,
//       A_i = t_final g_T + g_rgb . out4_rgb - sum_{j <= i} w_j gc_j,
//     so each pixel carries the running sum of w gc (one FMA a pair) against a total
//     formed once from the out4 that B1 wrote (saved by the autograd function; bg
//     drops out).  The running sum is one scalar rather than B1's three colour sums
//     beside three colour totals: those would cost five more registers a pixel, 40 at
//     the 8 pixels a thread below, and six more instructions a pair.  Its rounding
//     differs from the plain version's reverse cumsum by a few ulp of the colour
//     total, which 1/(1 - a) amplifies up to 100x: far inside the 2e-3 tolerance of
//     the largest gradient (the CPU emulation in tests/test_torch_mirror_replay.py
//     and the card runs differ from the plain version by 1e-6 to 1e-5 of it).
//     Walking back from t_chk[p + 1] and dividing by (1 - a) would lose every live copy
//     before a pixel whose T underflowed to zero inside the chunk.
//   * Dead warps skip exactly.  T only falls, so a warp none of whose pixels has
//     t_chk[p] >= T_EPS adds nothing from position p on: it skips the chunk (and, inside
//     a chunk, stops after the first pair of copies where no pixel is live), records
//     how far it walked, and still joins the block's barriers.  The per-copy sum reads
//     no warp past that point.  The walk ends for the block at the first position
//     without a live pixel (= p_hot + 1: t_chk falls along positions).
//   * A cheaper per-copy reduction.  128 threads, each one pixel column of 8 pixels
//     (threads a multiple of tile_w): the d0 terms of the alpha and of the moments are
//     the column's, so a thread accumulates 6 sums a pixel (the d0 moments are d0
//     times the others), and a warp reduces two copies at once (reduce_pair: one
//     half-swapping exchange, then a butterfly within each half): 45 shuffles, 45
//     adds and 18 selects for two copies of 256 pixels, where the previous design
//     spent 45 shuffles and 45 adds on one copy of 128 pixels (~3x fewer
//     instructions a pair, 4x fewer shuffles).
//     The warps' sums meet in a [warps][9][chunk] stage in dynamic shared memory, and
//     one thread per copy adds them in warp order and applies the per-copy algebra.
//     No float atomics: two launches give the same bits.
//   * The chunk is staged by cp.async (replay.cuh stage_ids / stage_rows) and read
//     with three vector loads a copy.
//
// Precision modes (template parameter MODE; render/mirror.py's table): B1's alphas and
// in-chunk factors in the same mode, and under every mode but float32 the products'
// operands rounded to bf16: the cotangent g once as it is loaded (so the suffix total
// comes from it too), the colours in dL/da's c . g, and dq, d0, d1 and w in the nine
// pixel sums.  The running sum of w (c . g) keeps float32 colours and w, so each suffix
// stays the difference of two sums of the same terms.
#include "replay.cuh"

namespace {

using gsvc::Pixels;
using gsvc::Stage;
using gsvc::bf16_round;
using gsvc::cp_async_commit;
using gsvc::cp_async_wait_all;
using gsvc::finish_rows;
using gsvc::kGradBf16;
using gsvc::kMaxChunk;
using gsvc::kMaxThreads;
using gsvc::kMaxWarps;
using gsvc::kSums;
using gsvc::kTEps;
using gsvc::replay_chunk;
using gsvc::stage_ids;
using gsvc::stage_rows;

template <int PPT, int MODE>
__global__ void __launch_bounds__(kMaxThreads, 2)
mirror_bwd_kernel(const float* __restrict__ attrs, const int* __restrict__ lists,
                  const int* __restrict__ counts, const float* __restrict__ out4,
                  const float* __restrict__ tchk, const float* __restrict__ gout,
                  float* __restrict__ grads, int m, int n_tiles, int n_tiles_x, int tile_w,
                  int cap, int chunk) {
  extern __shared__ float red[];  // [n_warps][kSums][chunk]
  __shared__ Stage st;
  __shared__ int ids[kMaxChunk];
  __shared__ int walked[kMaxWarps];
  const int g = blockIdx.x;
  const int d = g >> 1;
  const int v = g & 1;
  const int f = d / n_tiles;
  const int u = d - f * n_tiles;
  const int tx = u % n_tiles_x;
  const int out_row = (2 * f + v) * n_tiles + (v ? u + (n_tiles_x - 1) - 2 * tx : u);
  const int p_pix = blockDim.x * PPT;
  const int tile_h = p_pix / tile_w;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float* rows = attrs + static_cast<size_t>(f) * m * 9;
  const int* list = lists + static_cast<size_t>(d) * cap;
  const float cx = static_cast<float>(tx * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int n_chunks = cap / chunk;
  const int n_used = min((counts[d] + chunk - 1) / chunk, n_chunks);
  const float* tc = tchk + static_cast<size_t>(out_row) * (n_chunks + 1) * p_pix;
  const float* go = gout + static_cast<size_t>(out_row) * 4 * p_pix;
  const float* o4 = out4 + static_cast<size_t>(out_row) * 4 * p_pix;
  float* gr = grads + static_cast<size_t>(g) * kSums * cap;
  float* my_red = red + warp * kSums * chunk;

  // pixel k of this thread: lin = threadIdx.x + k * blockDim.x, all in one column
  Pixels<PPT> px;
  const float x = static_cast<float>(threadIdx.x % tile_w) - (tile_w - 1) / 2.0f;
  px.x = v ? -x : x;
  px.y0 = static_cast<float>(threadIdx.x / tile_w) - (tile_h - 1) / 2.0f;
  px.dy = static_cast<float>(blockDim.x / tile_w);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float gq = go[q * p_pix + lin];
      px.g[k][q] = (MODE & kGradBf16) ? bf16_round(gq) : gq;
    }
    px.s[k] = tc[n_chunks * p_pix + lin] * go[3 * p_pix + lin] + px.g[k][0] * o4[lin] +
              px.g[k][1] * o4[p_pix + lin] + px.g[k][2] * o4[2 * p_pix + lin];
    px.pre[k] = 0.0f;
  }

  int p = 0;
  for (; p < n_used; ++p) {
    const int c = v ? n_used - 1 - p : p;
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      px.t0[k] = tc[p * p_pix + threadIdx.x + k * blockDim.x];
      live |= px.t0[k] >= kTEps;
    }
    // the previous chunk's stage and sums are consumed; no live pixel left: done
    if (!__syncthreads_or(live)) break;
    stage_ids(ids, list, c, chunk);
    cp_async_commit();
    cp_async_wait_all();
    stage_rows(st, ids, rows, chunk, m);
    cp_async_commit();
    cp_async_wait_all();
    finish_rows(st, ids, chunk, m, cx, cy);
    __syncthreads();
    const int n_walked =
        __any_sync(0xffffffffu, live)
            ? replay_chunk<PPT, MODE>(st, chunk, v, px, my_red, chunk)
            : 0;
    if ((threadIdx.x & 31) == 0) walked[warp] = n_walked;
    __syncthreads();

    // one thread per copy: add the warps' sums, apply the per-copy algebra
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      const int j = v ? chunk - 1 - i : i;
      float sm[kSums];
#pragma unroll
      for (int q = 0; q < kSums; ++q) sm[q] = 0.0f;
      for (int w = 0; w < n_warps; ++w) {
        if (j >= walked[w]) continue;
#pragma unroll
        for (int q = 0; q < kSums; ++q) sm[q] += red[(w * kSums + q) * chunk + i];
      }
      const float4 geo = st.v[i][0];
      const float con_a = -2.0f * geo.z, con_b = -2.0f * geo.w;
      const float con_c = -2.0f * st.v[i][1].x;
      const int slot = c * chunk + i;
      gr[0 * cap + slot] = -(2.0f * con_a * sm[1] + 2.0f * con_b * sm[2]);
      gr[1 * cap + slot] = -(2.0f * con_c * sm[2] + 2.0f * con_b * sm[1]);
      gr[2 * cap + slot] = sm[3];
      gr[3 * cap + slot] = 2.0f * sm[4];
      gr[4 * cap + slot] = sm[5];
      gr[5 * cap + slot] = -2.0f * sm[0] / fmaxf(st.v[i][1].y, 1e-12f);
      gr[6 * cap + slot] = sm[6];
      gr[7 * cap + slot] = sm[7];
      gr[8 * cap + slot] = sm[8];
    }
  }

  // zero the slots the replay never reached (positions from p on, unused chunks)
  for (int slot = threadIdx.x; slot < cap; slot += blockDim.x) {
    const int c = slot / chunk;
    if (c >= n_used || (v ? n_used - 1 - c : c) >= p) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) gr[q * cap + slot] = 0.0f;
    }
  }
}

template <int MODE>
cudaError_t launch(int ppt, int blocks, int threads, size_t smem, cudaStream_t st,
                   const float* attrs, const int* lists, const int* counts,
                   const float* out4, const float* tchk, const float* gout, float* grads,
                   int m, int n_tiles, int n_tiles_x, int tile_w, int cap, int chunk) {
#define GSVC_MIRROR_BWD_LAUNCH(P)                                                   \
  mirror_bwd_kernel<P, MODE><<<blocks, threads, smem, st>>>(                        \
      attrs, lists, counts, out4, tchk, gout, grads, m, n_tiles, n_tiles_x, tile_w, \
      cap, chunk)
  switch (ppt) {
    case 1: GSVC_MIRROR_BWD_LAUNCH(1); break;
    case 2: GSVC_MIRROR_BWD_LAUNCH(2); break;
    case 4: GSVC_MIRROR_BWD_LAUNCH(4); break;
    case 8: GSVC_MIRROR_BWD_LAUNCH(8); break;
    case 16: GSVC_MIRROR_BWD_LAUNCH(16); break;
    default: return cudaErrorInvalidValue;
  }
#undef GSVC_MIRROR_BWD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Launches one block per (data tile, view) step on `stream`: 2 * n_frames * n_tiles
// blocks of `threads` threads (whole warps, a multiple of tile_w) with `ppt` pixels
// each.  Pointers are device pointers: attrs [n_frames, m, 9] f32 (the rows kernel B1
// composited), lists [n_frames * n_tiles, cap] i32 (-1 padded), counts
// [n_frames * n_tiles] i32, out4 [2 * n_frames * n_tiles, 4, P] (B1's output),
// tchk [2 * n_frames * n_tiles, cap / chunk + 1, P] and gout [2 * n_frames * n_tiles,
// 4, P] f32 in output (view) row order, grads [2 * n_frames * n_tiles, 9, cap] f32 in
// step order; P = threads * ppt.  `mode` is render/bidir.py check_precision's bits: 0
// (float32), kGradBf16 alone (bf16x2) or with kAlphaBf16 and/or kTransBf16; any other
// value is refused.  `bg` is unused: out4 holds it.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int mirror_backward(const float* attrs, const int* lists, const int* counts,
                               const float* out4, const float* tchk, const float* gout,
                               float* grads, int n_frames, int m, int n_tiles,
                               int n_tiles_x, int tile_w, int cap, int chunk, int threads,
                               int ppt, int mode, float bg, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || cap % chunk != 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || tile_w <= 0 || threads % tile_w != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = 2 * n_frames * n_tiles;
  if (blocks == 0) return 0;
  const size_t smem = static_cast<size_t>(threads / 32) * kSums * chunk * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gsvc::backward_mode(mode, [&](auto md) {
    return launch<decltype(md)::value>(ppt, blocks, threads, smem, st, attrs, lists, counts,
                                       out4, tchk, gout, grads, m, n_tiles, n_tiles_x,
                                       tile_w, cap, chunk);
  }));
}
