// Kernel B6b of the PyTorch/CUDA port: the training backward of the stream composite.
//
// Replaces the TPU kernel _bwd_kernel_stream (gsvc_tpu/render/pallas_stream.py:172,
// launched by _stream_call_bwd, :374).  For each (data tile, view) it walks the tile's
// blocks of the copy stream in reverse composite order (the forward view back to front,
// the flip view front to back), with the suffix accumulator seeded at the
// composite-last block by t_final * (bg * sum(g_rgb) + g_T) (t_final from kernel B6f's
// output), each block's transmittance from B6f's per-block checkpoint
// tchk [2, n_frames * b_max, P].  A block whose checkpoint has no pixel at or above
// T_EPS was saturated in the forward: its slots get zero gradients and the suffix is
// unchanged.  Every (view, slot) gets the gradients of its 9 attributes (mean x/y, conic
// a/b/c, opacity, rgb) in grads [2, 9, n_slots], view by view, so no two blocks write
// one row; the two views' sum and the scatter to the gaussians follow after the kernel
// (gsvc_tpu_torch/render/stream.py scatter_stream_grads).
//
// Per copy i and pixel, in composite order inside a block:
//   t_before = T_b * prod_{j before i} (1 - a_j),  live = t_before >= T_EPS,
//   w = live ? a t_before : 0,  gc = c_i . g_rgb,
//   A_i = a_acc + sum_{j after i in the block} w_j gc_j,
//   dL/da = live && act ? gc t_before - A_i / max(1 - a, 1e-6) : 0,   dq = -a/2 dL/da,
// and the copy's gradients follow from six pixel sums of dq (1, d0, d1, d0^2, d0 d1,
// d1^2), d = pixel - mean, plus dL/dc = sum w g_rgb; d_op = -2 m0 / max(op, 1e-12).
// The 1 / (1 - a) is an exact division (the TPU kernel's approximate reciprocal is
// taken on the TPU only).
//
// What bounds it on an H100: arithmetic, as kernel B2: two alpha evaluations per
// replayed (copy, pixel) pair (a first pass gives the block's sum of w gc, from which
// the second forms each suffix as block sum minus running prefix) plus ~35 FP32
// operations of backward algebra, and a warp reduction of 9 partial sums per copy.
// Bytes are the stream rows, tchk, g_out and out4's T row read once, and the
// [2, 9, n_slots] gradients written once.
//
// What the design does about it: B2's design (mirror_bwd.cu) over the stream: one block
// per (data tile, view), PPT pixels per thread, each stream block staged once in shared
// memory with coalesced reads; per copy each warp reduces its 9 partial sums with
// shuffles into a [warps, chunk, 9] stage and one thread per copy adds the warps and
// applies the per-copy algebra.  The alpha is evaluated without FMA contraction, as B6f
// and the plain version evaluate it.
#include "composite.cuh"

namespace {

using gsvc::Alpha;
using gsvc::Chunk;
using gsvc::alpha_at;
using gsvc::kMaxChunk;
using gsvc::kMaxThreads;
using gsvc::kTEps;
using gsvc::load_stream_chunk;

constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSums = 9;  // dq * (1, d0, d1, d0^2, d0 d1, d1^2), w * (r, g, b)

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
stream_bwd_kernel(const float* __restrict__ rows, const int* __restrict__ nblk,
                  const int* __restrict__ first, const float* __restrict__ out4,
                  const float* __restrict__ tchk, const float* __restrict__ gout,
                  float* __restrict__ grads, size_t n_slots, size_t n_blocks, int n_tiles,
                  int n_tiles_x, int tile_w, int chunk, float bg) {
  __shared__ Chunk s;
  __shared__ float red[kMaxWarps][kMaxChunk][kSums];
  const int g = blockIdx.x;
  const int d = g >> 1;
  const int v = g & 1;
  const int f = d / n_tiles;
  const int u = d - f * n_tiles;
  const int tx = u % n_tiles_x;
  const int out_row = (2 * f + v) * n_tiles + (v ? u + (n_tiles_x - 1) - 2 * tx : u);
  const int p_pix = blockDim.x * PPT;
  const int tile_h = p_pix / tile_w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float cx = static_cast<float>(tx * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int nb = nblk[d];
  const int b0 = first[d];
  const float* tc = tchk + static_cast<size_t>(v) * n_blocks * p_pix;
  const float* go = gout + static_cast<size_t>(out_row) * 4 * p_pix;
  const float* t_final = out4 + (static_cast<size_t>(out_row) * 4 + 3) * p_pix;
  float* gr = grads + static_cast<size_t>(v) * kSums * n_slots;

  float xs[PPT], ys[PPT], g3[PPT][3], a_acc[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
    const float x = static_cast<float>(lin % tile_w) - (tile_w - 1) / 2.0f;
    xs[k] = v ? -x : x;
    ys[k] = static_cast<float>(lin / tile_w) - (tile_h - 1) / 2.0f;
    g3[k][0] = go[lin];
    g3[k][1] = go[p_pix + lin];
    g3[k][2] = go[2 * p_pix + lin];
    a_acc[k] = t_final[lin] * (bg * (g3[k][0] + g3[k][1] + g3[k][2]) + go[3 * p_pix + lin]);
  }

  for (int p = nb - 1; p >= 0; --p) {
    const size_t b = static_cast<size_t>(b0 + (v ? nb - 1 - p : p));
    float t0[PPT], e[PPT], sum_w[PPT];
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      t0[k] = tc[b * p_pix + threadIdx.x + k * blockDim.x];
      live |= t0[k] >= kTEps;
      e[k] = 1.0f;
      sum_w[k] = 0.0f;
    }
    // a barrier too: the previous block's stage and reductions are consumed
    if (!__syncthreads_or(live)) {
      // saturated before this block: zero gradients, suffix unchanged
      for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
#pragma unroll
        for (int q = 0; q < kSums; ++q) gr[q * n_slots + b * chunk + i] = 0.0f;
      }
      continue;
    }
    load_stream_chunk(s, rows, n_slots, b * chunk, chunk, cx, cy);
    __syncthreads();

    // pass 1: the block's sum of w gc per pixel
    for (int j = 0; j < chunk; ++j) {
      const int i = v ? chunk - 1 - j : j;
      const float cr = s.r[i], cg = s.g[i], cb = s.b[i];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float a = alpha_at(s, i, xs[k], ys[k]).a;
        const float tb = t0[k] * e[k];
        if (tb >= kTEps) sum_w[k] += a * tb * (cr * g3[k][0] + cg * g3[k][1] + cb * g3[k][2]);
        e[k] *= 1.0f - a;
      }
    }
    // pass 2: per-copy gradients
    float prefix[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      e[k] = 1.0f;
      prefix[k] = 0.0f;
    }
    for (int j = 0; j < chunk; ++j) {
      const int i = v ? chunk - 1 - j : j;
      const float cr = s.r[i], cg = s.g[i], cb = s.b[i];
      float acc[kSums];
#pragma unroll
      for (int q = 0; q < kSums; ++q) acc[q] = 0.0f;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const Alpha al = alpha_at(s, i, xs[k], ys[k]);
        const float tb = t0[k] * e[k];
        const bool lv = tb >= kTEps;
        const float w = lv ? al.a * tb : 0.0f;
        const float gc = cr * g3[k][0] + cg * g3[k][1] + cb * g3[k][2];
        const float wgc = w * gc;
        prefix[k] += wgc;
        const float a_i = a_acc[k] + (sum_w[k] - prefix[k]);
        const float d_alpha =
            (lv && al.act) ? gc * tb - a_i / fmaxf(1.0f - al.a, 1e-6f) : 0.0f;
        const float dq = d_alpha * al.a * -0.5f;
        acc[0] += dq;
        acc[1] += dq * al.d0;
        acc[2] += dq * al.d1;
        acc[3] += dq * al.d0 * al.d0;
        acc[4] += dq * al.d0 * al.d1;
        acc[5] += dq * al.d1 * al.d1;
        acc[6] += w * g3[k][0];
        acc[7] += w * g3[k][1];
        acc[8] += w * g3[k][2];
        e[k] *= 1.0f - al.a;
      }
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
        float x = acc[q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        acc[q] = x;
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kSums; ++q) red[warp][i][q] = acc[q];
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) a_acc[k] += sum_w[k];
    __syncthreads();

    // one thread per copy: add the warps' sums, apply the per-copy algebra
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      float sm[kSums];
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
        float x = 0.0f;
        for (int w = 0; w < n_warps; ++w) x += red[w][i][q];
        sm[q] = x;
      }
      const float con_a = -2.0f * s.ha[i], con_b = -2.0f * s.hb[i];
      const float con_c = -2.0f * s.hc[i];
      const size_t slot = b * chunk + i;
      gr[0 * n_slots + slot] = -(2.0f * con_a * sm[1] + 2.0f * con_b * sm[2]);
      gr[1 * n_slots + slot] = -(2.0f * con_c * sm[2] + 2.0f * con_b * sm[1]);
      gr[2 * n_slots + slot] = sm[3];
      gr[3 * n_slots + slot] = 2.0f * sm[4];
      gr[4 * n_slots + slot] = sm[5];
      gr[5 * n_slots + slot] = -2.0f * sm[0] / fmaxf(s.op[i], 1e-12f);
      gr[6 * n_slots + slot] = sm[6];
      gr[7 * n_slots + slot] = sm[7];
      gr[8 * n_slots + slot] = sm[8];
    }
  }
}

}  // namespace

// Launches one block per (data tile, view) step on `stream`: 2 * n_frames * n_tiles
// blocks.  Pointers are device pointers: rows [9, n_slots] f32 (the rows kernel B6f
// composited; n_slots = n_frames * b_max * chunk), nblk and first [n_frames * n_tiles]
// i32, out4 and gout [2 * n_frames * n_tiles, 4, P] f32 in output (view) row order,
// tchk [2, n_frames * b_max, P] f32, grads [2, 9, n_slots] f32 (slots of blocks no tile
// owns are not written); P = threads * ppt.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int stream_backward(const float* rows, const int* nblk, const int* first,
                               const float* out4, const float* tchk, const float* gout,
                               float* grads, int n_frames, int n_tiles, int n_tiles_x,
                               int tile_w, int chunk, int b_max, int threads, int ppt,
                               float bg, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || tile_w <= 0 || (threads * ppt) % tile_w != 0 || b_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = 2 * n_frames * n_tiles;
  if (blocks == 0) return 0;
  const size_t n_blocks = static_cast<size_t>(n_frames) * b_max;
  const size_t n_slots = n_blocks * chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GSVC_STREAM_BWD_LAUNCH(P)                                                      \
  stream_bwd_kernel<P><<<blocks, threads, 0, st>>>(rows, nblk, first, out4, tchk, gout, \
                                                   grads, n_slots, n_blocks, n_tiles,  \
                                                   n_tiles_x, tile_w, chunk, bg)
  switch (ppt) {
    case 1: GSVC_STREAM_BWD_LAUNCH(1); break;
    case 2: GSVC_STREAM_BWD_LAUNCH(2); break;
    case 4: GSVC_STREAM_BWD_LAUNCH(4); break;
    case 8: GSVC_STREAM_BWD_LAUNCH(8); break;
    case 16: GSVC_STREAM_BWD_LAUNCH(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSVC_STREAM_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
