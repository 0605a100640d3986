// Kernel B6b of the PyTorch/CUDA port: the training backward of the stream composite.
//
// Replaces the TPU kernel _bwd_kernel_stream (gsvc_tpu/render/pallas_stream.py:172,
// launched by _stream_call_bwd, :374).  For each (data tile, view) it replays the
// tile's blocks of the copy stream in composite order (the forward view front to back,
// the flip view back to front with each block's copies bottom-up) up to the last block
// whose kernel-B6f checkpoint tchk [2, n_frames * b_max, P] has a live pixel, and gives
// every replayed (view, slot) the gradients of its 9 attributes (mean x/y, conic a/b/c,
// opacity, rgb) in grads [2, 9, n_slots], view by view, so no two blocks write one row;
// the two views' sum and the scatter to the gaussians follow after the kernel
// (gsvc_tpu_torch/render/stream.py scatter_stream_grads).  Slots the replay never
// reaches (padding, blocks past the stop, dead blocks) keep the zeros the wrapper
// allocates, as the plain version gives them.
//
// Per copy i and pixel, with A_i the sum of w_j gc_j over the copies after i plus
// t_final * (bg * sum(g_rgb) + g_T):
//   dL/da = live && act ? gc t_before - A_i / max(1 - a, 1e-6) : 0,   dq = -a/2 dL/da,
// and the copy's gradients follow from six pixel sums of dq (1, d0, d1, d0^2, d0 d1,
// d1^2), d = pixel - mean, plus dL/dc = sum w g_rgb; d_op = -2 m0 / max(op, 1e-12).
// The 1 / (1 - a) is an exact division (the TPU kernel's approximate reciprocal is
// taken on the TPU only).
//
// What bounds it on an H100: issued FP32 instructions, as kernel B2.  A replayed (copy,
// pixel) pair costs an alpha (quadratic form, expf; every product and sum rounded on
// its own, so no FMA) and ~35 more operations of backward algebra with the exact
// division; bytes are the stream rows, tchk, g_out and out4 read once, and the
// [2, 9, n_slots] gradients written once.
//
// What the design does about it: kernel B2's replay (mirror_bwd.cu, replay.cuh
// replay_chunk) over the stream's planes, as B5b (tile_bwd.cu) runs it over its planes.
//   * One alpha evaluation per replayed pair.  The walk goes FORWARD in composite
//     order, with t_before = tchk[v, b] times the running product of (1 - a): B6f's own
//     product, so the liveness decisions are B6f's.  The suffix needs no first pass:
//     since out4 = sum_j w_j c_j + t_final bg,
//       A_i = t_final g_T + g_rgb . out4_rgb - sum_{j <= i} w_j gc_j,
//     so each pixel carries the running sum of w gc against a total formed once from
//     the out4 that B6f wrote (saved by the autograd function; bg drops out).
//   * Dead warps skip exactly.  T only falls, so a warp none of whose pixels has
//     tchk[v, b] >= T_EPS adds nothing from that block on: it skips the block (and,
//     inside a block, stops after the first pair of copies without a live pixel),
//     records how far it walked, and still joins the block's barriers.  The walk ends
//     for the block at the first block without a live pixel (tchk falls along blocks,
//     and B6f writes its final T into the blocks after its stop).
//   * A cheaper per-copy reduction.  Each thread owns one pixel column of PPT pixels
//     (threads a multiple of tile_w; 128 x 8 at 8x128 tiles), so the d0 terms of the
//     alpha and of the moments are the column's (6 sums a pixel), and a warp reduces
//     two copies at once (reduce_pair) into a [warps][9][chunk] stage in dynamic shared
//     memory; one thread per copy adds the warps in warp order and applies the per-copy
//     algebra.  No float atomics: two launches give the same bits.
//   * A block's walk ends at its live slots: a tile's copies fill its span from the
//     first slot on, so the live slots of a block are a prefix of it, and the padding
//     after them (opacity 0: every term zero) is neither staged nor replayed.
//   * The blocks are pipelined: while the block replays stream block p, cp.async copies
//     block p + 1's nine plane runs into the other of two stages (replay.cuh
//     stage_planes); each thread makes its own slots tile-local after they land
//     (finish_planes), and the block's barrier at the next block publishes them.
//
// Precision modes (template parameter MODE; render/mirror.py's table), as kernel B2
// takes them: B6f's alphas and in-block factors in the same mode, and under every mode
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
stream_bwd_kernel(const float* __restrict__ rows, const int* __restrict__ nblk,
                  const int* __restrict__ first, const int* __restrict__ nlive,
                  const float* __restrict__ out4, const float* __restrict__ tchk,
                  const float* __restrict__ gout, float* __restrict__ grads,
                  size_t n_slots, size_t n_blocks, int n_tiles, int n_tiles_x, int tile_w,
                  int chunk) {
  extern __shared__ float red[];  // [n_warps][kSums][chunk]
  __shared__ Stage st[2];
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
  const float cx = static_cast<float>(tx * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int nb = nblk[d];
  const int b0 = first[d];
  const float* tc = tchk + static_cast<size_t>(v) * n_blocks * p_pix;
  const float* go = gout + static_cast<size_t>(out_row) * 4 * p_pix;
  const float* o4 = out4 + static_cast<size_t>(out_row) * 4 * p_pix;
  float* gr = grads + static_cast<size_t>(v) * kSums * n_slots;
  float* my_red = red + warp * kSums * chunk;
  Planes pl;
#pragma unroll
  for (int q = 0; q < 9; ++q) pl.p[q] = rows + q * n_slots;

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
    px.s[k] = o4[3 * p_pix + lin] * go[3 * p_pix + lin] + px.g[k][0] * o4[lin] +
              px.g[k][1] * o4[p_pix + lin] + px.g[k][2] * o4[2 * p_pix + lin];
    px.pre[k] = 0.0f;
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

  for (int p = 0; p < nb; ++p) {
    const size_t b = block_at(p);
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      px.t0[k] = tc[b * p_pix + threadIdx.x + k * blockDim.x];
      live |= px.t0[k] >= kTEps;
    }
    // publishes stage p; the previous block's stage and sums are consumed; no live
    // pixel left: done
    if (!__syncthreads_or(live)) break;
    const int s = p & 1;
    if (p + 1 < nb) stage_planes(st[s ^ 1], pl, block_at(p + 1) * chunk, n_next);
    cp_async_commit();
    const int n_after = p + 2 < nb ? nlive[block_at(p + 2)] : 0;
    const Stage& S = st[s];
    const int n_walked =
        __any_sync(0xffffffffu, live)
            ? replay_chunk<PPT, MODE>(S, n, v, px, my_red, chunk)
            : 0;
    if ((threadIdx.x & 31) == 0) walked[warp] = n_walked;
    __syncthreads();

    // one thread per live copy: add the warps' sums, apply the per-copy algebra
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int j = v ? n - 1 - i : i;
      float sm[kSums];
#pragma unroll
      for (int q = 0; q < kSums; ++q) sm[q] = 0.0f;
      for (int w = 0; w < n_warps; ++w) {
        if (j >= walked[w]) continue;
#pragma unroll
        for (int q = 0; q < kSums; ++q) sm[q] += red[(w * kSums + q) * chunk + i];
      }
      const float4 geo = S.v[i][0];
      const float con_a = -2.0f * geo.z, con_b = -2.0f * geo.w;
      const float con_c = -2.0f * S.v[i][1].x;
      const size_t slot = b * chunk + i;
      gr[0 * n_slots + slot] = -(2.0f * con_a * sm[1] + 2.0f * con_b * sm[2]);
      gr[1 * n_slots + slot] = -(2.0f * con_c * sm[2] + 2.0f * con_b * sm[1]);
      gr[2 * n_slots + slot] = sm[3];
      gr[3 * n_slots + slot] = 2.0f * sm[4];
      gr[4 * n_slots + slot] = sm[5];
      gr[5 * n_slots + slot] = -2.0f * sm[0] / fmaxf(S.v[i][1].y, 1e-12f);
      gr[6 * n_slots + slot] = sm[6];
      gr[7 * n_slots + slot] = sm[7];
      gr[8 * n_slots + slot] = sm[8];
    }
    cp_async_wait_all();
    if (p + 1 < nb) finish_planes(st[s ^ 1], n_next, cx, cy);
    n = n_next;
    n_next = n_after;
  }
}

template <int MODE>
cudaError_t launch(int ppt, int blocks, int threads, size_t smem, cudaStream_t st,
                   const float* rows, const int* nblk, const int* first, const int* nlive,
                   const float* out4, const float* tchk, const float* gout, float* grads,
                   size_t n_slots, size_t n_blocks, int n_tiles, int n_tiles_x,
                   int tile_w, int chunk) {
  cudaError_t err;
#define GSVC_STREAM_BWD_LAUNCH(P)                                                    \
  err = opt_in_smem(stream_bwd_kernel<P, MODE>, smem);                               \
  if (err != cudaSuccess) return err;                                                \
  stream_bwd_kernel<P, MODE><<<blocks, threads, smem, st>>>(                         \
      rows, nblk, first, nlive, out4, tchk, gout, grads, n_slots, n_blocks, n_tiles, \
      n_tiles_x, tile_w, chunk)
  switch (ppt) {
    case 1: GSVC_STREAM_BWD_LAUNCH(1); break;
    case 2: GSVC_STREAM_BWD_LAUNCH(2); break;
    case 4: GSVC_STREAM_BWD_LAUNCH(4); break;
    case 8: GSVC_STREAM_BWD_LAUNCH(8); break;
    case 16: GSVC_STREAM_BWD_LAUNCH(16); break;
    default: return cudaErrorInvalidValue;
  }
#undef GSVC_STREAM_BWD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Launches one block per (data tile, view) step on `stream`: 2 * n_frames * n_tiles
// blocks of `threads` threads (whole warps, a multiple of tile_w) with `ppt` pixels
// each.  Pointers are device pointers: rows [9, n_slots] f32 (the rows kernel B6f
// composited; n_slots = n_frames * b_max * chunk), nblk and first [n_frames * n_tiles]
// i32, nlive [n_frames * b_max] i32 (each block's live slots, a prefix of the block),
// out4 (B6f's output) and gout [2 * n_frames * n_tiles, 4, P] f32 in output (view) row
// order, tchk [2, n_frames * b_max, P] f32, grads [2, 9, n_slots] f32, zeroed by the
// caller (the kernel writes only the slots it replays); P = threads * ppt.  `mode` is
// render/bidir.py check_precision's bits: 0 (float32), kGradBf16 alone (bf16x2) or with
// kAlphaBf16 and/or kTransBf16; any other value is refused.  `bg` is unused: out4 holds
// it.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stream_backward(const float* rows, const int* nblk, const int* first,
                               const int* nlive, const float* out4, const float* tchk,
                               const float* gout, float* grads, int n_frames, int n_tiles,
                               int n_tiles_x, int tile_w, int chunk, int b_max, int threads,
                               int ppt, int mode, float bg, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || tile_w <= 0 || threads % tile_w != 0 || b_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = 2 * n_frames * n_tiles;
  if (blocks == 0) return 0;
  const size_t n_blocks = static_cast<size_t>(n_frames) * b_max;
  const size_t n_slots = n_blocks * chunk;
  const size_t smem = static_cast<size_t>(threads / 32) * kSums * chunk * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(gsvc::backward_mode(mode, [&](auto m) {
    return launch<decltype(m)::value>(ppt, blocks, threads, smem, st, rows, nblk, first,
                                      nlive, out4, tchk, gout, grads, n_slots, n_blocks,
                                      n_tiles, n_tiles_x, tile_w, chunk);
  }));
}
