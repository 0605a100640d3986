// Kernel B5b of the PyTorch/CUDA port: the backward of the single-view composite.
//
// Replaces the TPU kernel _bwd_kernel / _bwd_one_tile (gsvc_tpu/render/pallas_splat.py:
// 349 / :373, launched by _composite_call_bwd, :561).  For each row of the nine
// [V*T, cap] attribute planes it replays the chunks up to c_hot (the last used chunk
// whose kernel-B5f checkpoint has a live pixel) and writes each slot's gradients of its
// 9 attributes (mean x/y, conic a/b/c, opacity, rgb) into grads [V*T, 9, cap]; slots the
// replay never reaches are written as zeros.  Each block writes only its own row: no
// atomics.  The gradients reach the per-gaussian rows through the autograd of the
// plane gather (gsvc_tpu_torch/render/splat.py gather_tile_planes_rows).
//
// Per copy i and pixel, with A_i the sum of w_j gc_j over the copies after i plus
// t_final * (bg * sum(g_rgb) + g_T):
//   dL/da = live && act ? gc t_before - A_i / max(1 - a, 1e-6) : 0,   dq = -a/2 dL/da,
// and the copy's gradients follow from six pixel sums of dq (1, d0, d1, d0^2, d0 d1,
// d1^2), d = pixel - mean (the TPU kernel's pixel-basis moments taken about the
// gaussian's mean rather than the tile centre: no fp32 cancellation), plus
// dL/dc = sum w g_rgb.  The 1 / (1 - a) is an exact division (the TPU kernel takes
// pl.reciprocal(approx=True) on the TPU and the exact one elsewhere).
//
// What bounds it on an H100: issued FP32 instructions.  A replayed (copy, pixel) pair
// costs an alpha (quadratic form, expf; every product and sum rounded on its own, so no
// FMA) and ~35 more operations of backward algebra with the exact division, ~49 FP32
// operations; bytes are t_chk, out4 and g_out (read once per row) and the [9, cap]
// gradient row.
//
// What the design does about it: kernel B2's replay (mirror_bwd.cu, replay.cuh
// replay_chunk) for one view.
//   * One alpha evaluation per replayed pair.  The walk goes FORWARD through the
//     chunks, from 0 to c_hot, with t_before = t_chk[c] times the running product of
//     (1 - a): B5f's own product, so the liveness decisions are B5f's.  The suffix
//     needs no first pass: since out4 = sum_j w_j c_j + t_final bg,
//       A_i = t_final g_T + g_rgb . out4_rgb - sum_{j <= i} w_j gc_j,
//     so each pixel carries the running sum of w gc against a total formed once from
//     the out4 that B5f wrote (saved by the autograd function; bg drops out).
//   * Dead warps skip exactly.  T only falls, so a warp none of whose pixels has
//     t_chk[c] >= T_EPS adds nothing from chunk c on: it skips the chunk (and, inside a
//     chunk, stops after the first pair of copies without a live pixel), records how
//     far it walked, and still joins the block's barriers.  The walk ends for the block
//     at the first chunk without a live pixel (= c_hot + 1: t_chk falls along chunks).
//   * A cheaper per-copy reduction.  Each thread owns one pixel column of PPT pixels
//     (threads a multiple of tile_w), so the d0 terms of the alpha and of the moments
//     are the column's (6 sums a pixel), and a warp reduces two copies at once
//     (reduce_pair) into a [warps][9][chunk] stage in dynamic shared memory; one
//     thread per copy adds the warps in warp order and applies the per-copy algebra.
//     No float atomics: two launches give the same bits.
//   * A chunk's walk ends at the row's last copy: the padding slots of a partly filled
//     last chunk are neither staged nor replayed, and get zero rows.
//   * The chunks are pipelined: while the block replays chunk c, cp.async copies chunk
//     c + 1's nine plane runs into the other of two stages (replay.cuh stage_planes);
//     each thread makes its own slots tile-local after they land (finish_planes), and
//     the block's barrier at the next chunk publishes them.
//
// Precision modes (template parameter MODE; render/mirror.py's table), as kernel B2
// takes them: B5f's alphas and in-chunk factors in the same mode, and under every mode
// but float32 the products' operands rounded to bf16: the cotangent g once as it is
// loaded (so the suffix total comes from it too), the colours in dL/da's c . g, and dq,
// d0, d1 and w in the nine pixel sums.  The running sum of w (c . g) keeps float32
// colours and w, so each suffix stays the difference of two sums of the same terms.
#include "replay.cuh"

namespace {

using gsvc::Pixels;
using gsvc::Planes;
using gsvc::Stage;
using gsvc::bf16_round;
using gsvc::cp_async_commit;
using gsvc::cp_async_wait_all;
using gsvc::finish_planes;
using gsvc::kGradBf16;
using gsvc::kMaxChunk;
using gsvc::kMaxThreads;
using gsvc::kMaxWarps;
using gsvc::kSums;
using gsvc::kTEps;
using gsvc::opt_in_smem;
using gsvc::replay_chunk;
using gsvc::stage_planes;

template <int PPT, int MODE>
__global__ void __launch_bounds__(kMaxThreads, 2)
tile_bwd_kernel(Planes pl, const int* __restrict__ counts, const float* __restrict__ out4,
                const float* __restrict__ tchk, const float* __restrict__ gout,
                float* __restrict__ grads, int n_tiles, int n_tiles_x, int tile_w, int cap,
                int chunk) {
  extern __shared__ float red[];  // [n_warps][kSums][chunk]
  __shared__ Stage st[2];
  __shared__ int walked[kMaxWarps];
  const int row = blockIdx.x;
  const int u = row % n_tiles;
  const int tx = u % n_tiles_x;
  const int p_pix = blockDim.x * PPT;
  const int tile_h = p_pix / tile_w;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float cx = static_cast<float>(tx * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int n_chunks = cap / chunk;
  const int count = min(counts[row], cap);
  const int n_used = (count + chunk - 1) / chunk;
  const size_t base = static_cast<size_t>(row) * cap;
  const float* tc = tchk + static_cast<size_t>(row) * (n_chunks + 1) * p_pix;
  const float* go = gout + static_cast<size_t>(row) * 4 * p_pix;
  const float* o4 = out4 + static_cast<size_t>(row) * 4 * p_pix;
  float* gr = grads + static_cast<size_t>(row) * kSums * cap;
  float* my_red = red + warp * kSums * chunk;

  // pixel k of this thread: lin = threadIdx.x + k * blockDim.x, all in one column
  Pixels<PPT> px;
  px.x = static_cast<float>(threadIdx.x % tile_w) - (tile_w - 1) / 2.0f;
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

  // copies in chunk c: the slots past the count are padding (opacity 0: every term
  // zero), so a partly filled last chunk stages and walks only its copies
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
    for (int k = 0; k < PPT; ++k) {
      px.t0[k] = tc[c * p_pix + threadIdx.x + k * blockDim.x];
      live |= px.t0[k] >= kTEps;
    }
    // publishes stage c; the previous chunk's stage and sums are consumed; no live
    // pixel left: done
    if (!__syncthreads_or(live)) break;
    const int b = c & 1;
    if (c + 1 < n_used)
      stage_planes(st[b ^ 1], pl, base + static_cast<size_t>(c + 1) * chunk, real(c + 1));
    cp_async_commit();
    const Stage& s = st[b];
    const int n = real(c);
    const int n_walked =
        __any_sync(0xffffffffu, live)
            ? replay_chunk<PPT, MODE>(s, n, false, px, my_red, chunk)
            : 0;
    if ((threadIdx.x & 31) == 0) walked[warp] = n_walked;
    __syncthreads();

    // one thread per copy: add the warps' sums, apply the per-copy algebra; padding
    // slots get zero rows
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      const int slot = c * chunk + i;
      if (i >= n) {
#pragma unroll
        for (int q = 0; q < kSums; ++q) gr[q * cap + slot] = 0.0f;
        continue;
      }
      float sm[kSums];
#pragma unroll
      for (int q = 0; q < kSums; ++q) sm[q] = 0.0f;
      for (int w = 0; w < n_warps; ++w) {
        if (i >= walked[w]) continue;
#pragma unroll
        for (int q = 0; q < kSums; ++q) sm[q] += red[(w * kSums + q) * chunk + i];
      }
      const float4 geo = s.v[i][0];
      const float con_a = -2.0f * geo.z, con_b = -2.0f * geo.w;
      const float con_c = -2.0f * s.v[i][1].x;
      gr[0 * cap + slot] = -(2.0f * con_a * sm[1] + 2.0f * con_b * sm[2]);
      gr[1 * cap + slot] = -(2.0f * con_c * sm[2] + 2.0f * con_b * sm[1]);
      gr[2 * cap + slot] = sm[3];
      gr[3 * cap + slot] = 2.0f * sm[4];
      gr[4 * cap + slot] = sm[5];
      gr[5 * cap + slot] = -2.0f * sm[0] / fmaxf(s.v[i][1].y, 1e-12f);
      gr[6 * cap + slot] = sm[6];
      gr[7 * cap + slot] = sm[7];
      gr[8 * cap + slot] = sm[8];
    }
    cp_async_wait_all();
    if (c + 1 < n_used) finish_planes(st[b ^ 1], real(c + 1), cx, cy);
  }

  // zero the slots the replay never reached (chunks from c on, unused chunks)
  for (int slot = c * chunk + threadIdx.x; slot < cap; slot += blockDim.x) {
#pragma unroll
    for (int q = 0; q < kSums; ++q) gr[q * cap + slot] = 0.0f;
  }
}

template <int MODE>
cudaError_t launch(int ppt, int n_rows, int threads, size_t smem, cudaStream_t st,
                   const Planes& pl, const int* counts, const float* out4,
                   const float* tchk, const float* gout, float* grads, int n_tiles,
                   int n_tiles_x, int tile_w, int cap, int chunk) {
  cudaError_t err;
#define GSVC_TILE_BWD_LAUNCH(P)                                                        \
  err = opt_in_smem(tile_bwd_kernel<P, MODE>, smem);                                   \
  if (err != cudaSuccess) return err;                                                  \
  tile_bwd_kernel<P, MODE><<<n_rows, threads, smem, st>>>(                             \
      pl, counts, out4, tchk, gout, grads, n_tiles, n_tiles_x, tile_w, cap, chunk)
  switch (ppt) {
    case 1: GSVC_TILE_BWD_LAUNCH(1); break;
    case 2: GSVC_TILE_BWD_LAUNCH(2); break;
    case 4: GSVC_TILE_BWD_LAUNCH(4); break;
    case 8: GSVC_TILE_BWD_LAUNCH(8); break;
    case 16: GSVC_TILE_BWD_LAUNCH(16); break;
    default: return cudaErrorInvalidValue;
  }
#undef GSVC_TILE_BWD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Launches one block per plane row on `stream`: n_rows blocks of `threads` threads
// (whole warps, a multiple of tile_w) with `ppt` pixels each.  planes is a host array
// of nine device pointers to [n_rows, cap] f32 planes (the rows kernel B5f
// composited); counts [n_rows] i32, out4 [n_rows, 4, P] f32 (B5f's output), tchk
// [n_rows, cap / chunk + 1, P] f32, gout [n_rows, 4, P] f32 and grads [n_rows, 9, cap]
// f32 are device pointers; P = threads * ppt = tile_h * tile_w.  `mode` is
// render/bidir.py check_precision's bits: 0 (float32), kGradBf16 alone (bf16x2) or with
// kAlphaBf16 and/or kTransBf16; any other value is refused.  `bg` is unused: out4 holds
// it.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tile_backward(const float* const* planes, const int* counts,
                             const float* out4, const float* tchk, const float* gout,
                             float* grads, int n_rows, int n_tiles, int n_tiles_x,
                             int tile_w, int cap, int chunk, int threads, int ppt,
                             int mode, float bg, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || cap % chunk != 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || tile_w <= 0 || threads % tile_w != 0 ||
      n_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  Planes pl;
  for (int i = 0; i < 9; ++i) pl.p[i] = planes[i];
  const size_t smem = static_cast<size_t>(threads / 32) * kSums * chunk * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gsvc::backward_mode(mode, [&](auto m) {
    return launch<decltype(m)::value>(ppt, n_rows, threads, smem, st, pl, counts, out4,
                                      tchk, gout, grads, n_tiles, n_tiles_x, tile_w, cap,
                                      chunk);
  }));
}
