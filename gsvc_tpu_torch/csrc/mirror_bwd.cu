// Kernel B2 of the PyTorch/CUDA port: the training backward of the mirror composite.
//
// Replaces the TPU kernel _bwd_kernel_mirror (gsvc_tpu/render/pallas_splat.py:699,
// launched by _mirror_call_bwd, :906).  For each (data tile, view) step it replays the
// composite positions in reverse from p_hot (the last position with a live pixel,
// read from kernel B1's t_chk) with the suffix accumulator seeded by
// t_final * (bg * sum(g_rgb) + g_T), and writes each copy's gradients of its 9
// attributes (mean x/y, conic a/b/c, opacity, rgb) into grads [2F*T, 9, cap], one row
// per step g = (f * T + u) * 2 + v.  The two views of a data tile are separate rows;
// their sum (and the per-view mean columns the densification statistics read) is the
// scatter after the kernel (gsvc_tpu_torch/render/mirror.py scatter_grads), so no two
// blocks ever add into one row.  Slots the replay never reaches are written as zeros.
//
// Per copy i and pixel, in composite order inside a chunk:
//   t_before = T_p * prod_{j before i} (1 - a_j),  live = t_before >= T_EPS,
//   w = live ? a t_before : 0,  gc = c_i . g_rgb,
//   A_i = a_acc + sum_{j after i in the chunk} w_j gc_j,
//   dL/da = live && act ? gc t_before - A_i / max(1 - a, 1e-6) : 0,   dq = -a/2 dL/da,
// and the copy's gradients follow from six pixel sums of dq (1, d0, d1, d0^2, d0 d1,
// d1^2), d = pixel - mean (the TPU kernel's pixel-basis moments taken about the
// gaussian's mean rather than the tile centre: no fp32 cancellation), plus
// dL/dc = sum w g_rgb.  The 1 / (1 - a) is an exact division, as the TPU kernel
// computes it off the TPU (it takes pl.reciprocal(approx=True) on the TPU).
//
// What bounds it on an H100: arithmetic.  Every replayed (copy, pixel) pair costs two
// alpha evaluations (a first pass gives the chunk's sum of w gc, from which the second
// pass forms each suffix as chunk sum minus running prefix: a thread cannot hold a
// chunk of per-copy values per pixel) plus ~35 FP32 operations of backward algebra,
// and a warp reduction of 9 partial sums per copy.  Bytes are t_chk and g_out (read
// once per step) and the [9, cap] gradient row.
//
// What the design does about it: one block per (data tile, view) step, PPT pixels per
// thread, each chunk of <= 128 copies staged once in shared memory.  Per copy, each
// warp reduces its 9 partial sums with shuffles into a [warps, chunk, 9] stage, and
// one thread per copy adds the warps and applies the per-copy algebra.  The alpha is
// evaluated without FMA contraction, as B1 and the plain version evaluate it.
#include "composite.cuh"

namespace {

using gsvc::Alpha;
using gsvc::Chunk;
using gsvc::alpha_at;
using gsvc::kMaxChunk;
using gsvc::kMaxThreads;
using gsvc::kTEps;
using gsvc::load_chunk;

constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSums = 9;  // dq * (1, d0, d1, d0^2, d0 d1, d1^2), w * (r, g, b)

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
mirror_bwd_kernel(const float* __restrict__ attrs, const int* __restrict__ lists,
                  const int* __restrict__ counts, const float* __restrict__ tchk,
                  const float* __restrict__ gout, float* __restrict__ grads, int m,
                  int n_tiles, int n_tiles_x, int tile_w, int cap, int chunk, float bg) {
  __shared__ Chunk s;
  __shared__ float red[kMaxWarps][kMaxChunk][kSums];
  __shared__ int hot;
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
  const float* rows = attrs + static_cast<size_t>(f) * m * 9;
  const int* list = lists + static_cast<size_t>(d) * cap;
  const float cx = static_cast<float>(tx * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int n_chunks = cap / chunk;
  const int n_used = min((counts[d] + chunk - 1) / chunk, n_chunks);
  const float* tc = tchk + static_cast<size_t>(out_row) * (n_chunks + 1) * p_pix;
  const float* go = gout + static_cast<size_t>(out_row) * 4 * p_pix;
  float* gr = grads + static_cast<size_t>(g) * kSums * cap;

  float xs[PPT], ys[PPT], g3[PPT][3], a_acc[PPT];
  int my_hot = -1;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
    const float x = static_cast<float>(lin % tile_w) - (tile_w - 1) / 2.0f;
    xs[k] = v ? -x : x;
    ys[k] = static_cast<float>(lin / tile_w) - (tile_h - 1) / 2.0f;
    g3[k][0] = go[lin];
    g3[k][1] = go[p_pix + lin];
    g3[k][2] = go[2 * p_pix + lin];
    a_acc[k] = tc[n_chunks * p_pix + lin] * (bg * (g3[k][0] + g3[k][1] + g3[k][2]) +
                                             go[3 * p_pix + lin]);
    for (int p = 0; p < n_used; ++p)
      if (tc[p * p_pix + lin] >= kTEps) my_hot = max(my_hot, p);
  }
  if (threadIdx.x == 0) hot = -1;
  __syncthreads();
  atomicMax(&hot, my_hot);
  __syncthreads();
  const int p_hot = hot;

  // zero the slots the replay never reaches (positions past p_hot, unused chunks)
  for (int slot = threadIdx.x; slot < cap; slot += blockDim.x) {
    const int c = slot / chunk;
    const int p = v ? n_used - 1 - c : c;
    if (c >= n_used || p > p_hot) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) gr[q * cap + slot] = 0.0f;
    }
  }

  for (int p = p_hot; p >= 0; --p) {
    const int c = v ? n_used - 1 - p : p;
    __syncthreads();  // the previous chunk's stage and reductions are consumed
    load_chunk(s, rows, list, c, chunk, m, cx, cy);
    __syncthreads();

    float t0[PPT], e[PPT], sum_w[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      t0[k] = tc[p * p_pix + threadIdx.x + k * blockDim.x];
      e[k] = 1.0f;
      sum_w[k] = 0.0f;
    }
    // pass 1: the chunk's sum of w gc per pixel
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
        const bool live = tb >= kTEps;
        const float w = live ? al.a * tb : 0.0f;
        const float gc = cr * g3[k][0] + cg * g3[k][1] + cb * g3[k][2];
        const float wgc = w * gc;
        prefix[k] += wgc;
        const float a_i = a_acc[k] + (sum_w[k] - prefix[k]);
        const float d_alpha =
            (live && al.act) ? gc * tb - a_i / fmaxf(1.0f - al.a, 1e-6f) : 0.0f;
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
      const int slot = c * chunk + i;
      gr[0 * cap + slot] = -(2.0f * con_a * sm[1] + 2.0f * con_b * sm[2]);
      gr[1 * cap + slot] = -(2.0f * con_c * sm[2] + 2.0f * con_b * sm[1]);
      gr[2 * cap + slot] = sm[3];
      gr[3 * cap + slot] = 2.0f * sm[4];
      gr[4 * cap + slot] = sm[5];
      gr[5 * cap + slot] = -2.0f * sm[0] / fmaxf(s.op[i], 1e-12f);
      gr[6 * cap + slot] = sm[6];
      gr[7 * cap + slot] = sm[7];
      gr[8 * cap + slot] = sm[8];
    }
  }
}

}  // namespace

// Launches one block per (data tile, view) step on `stream`: 2 * n_frames * n_tiles
// blocks.  Pointers are device pointers: attrs [n_frames, m, 9] f32 (the rows kernel
// B1 composited), lists [n_frames * n_tiles, cap] i32 (-1 padded), counts
// [n_frames * n_tiles] i32, tchk [2 * n_frames * n_tiles, cap / chunk + 1, P] f32 and
// gout [2 * n_frames * n_tiles, 4, P] f32 in output (view) row order, grads
// [2 * n_frames * n_tiles, 9, cap] f32 in step order; P = threads * ppt.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mirror_backward(const float* attrs, const int* lists, const int* counts,
                               const float* tchk, const float* gout, float* grads,
                               int n_frames, int m, int n_tiles, int n_tiles_x,
                               int tile_w, int cap, int chunk, int threads, int ppt,
                               float bg, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || cap % chunk != 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || tile_w <= 0 ||
      (threads * ppt) % tile_w != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = 2 * n_frames * n_tiles;
  if (blocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GSVC_MIRROR_BWD_LAUNCH(P)                                                    \
  mirror_bwd_kernel<P><<<blocks, threads, 0, st>>>(attrs, lists, counts, tchk, gout, \
                                                   grads, m, n_tiles, n_tiles_x,    \
                                                   tile_w, cap, chunk, bg)
  switch (ppt) {
    case 1: GSVC_MIRROR_BWD_LAUNCH(1); break;
    case 2: GSVC_MIRROR_BWD_LAUNCH(2); break;
    case 4: GSVC_MIRROR_BWD_LAUNCH(4); break;
    case 8: GSVC_MIRROR_BWD_LAUNCH(8); break;
    case 16: GSVC_MIRROR_BWD_LAUNCH(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSVC_MIRROR_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
