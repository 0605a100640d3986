// Kernel B5b of the PyTorch/CUDA port: the backward of the single-view composite.
//
// Replaces the TPU kernel _bwd_kernel / _bwd_one_tile (gsvc_tpu/render/pallas_splat.py:
// 349 / :373, launched by _composite_call_bwd, :561).  For each row of the nine
// [V*T, cap] attribute planes it replays the chunks in reverse from c_hot (the last
// used chunk whose kernel-B5f checkpoint has a live pixel) with the suffix accumulator
// seeded by t_final * (bg * sum(g_rgb) + g_T), and writes each slot's gradients of its
// 9 attributes (mean x/y, conic a/b/c, opacity, rgb) into grads [V*T, 9, cap]; slots the
// replay never reaches are written as zeros.  Each block writes only its own row: no
// atomics.  The gradients reach the per-gaussian rows through the autograd of the
// plane gather (gsvc_tpu_torch/render/splat.py gather_tile_planes_rows).
//
// Per copy i and pixel, in depth order inside a chunk:
//   t_before = T_c * prod_{j before i} (1 - a_j),  live = t_before >= T_EPS,
//   w = live ? a t_before : 0,  gc = c_i . g_rgb,
//   A_i = a_acc + sum_{j after i in the chunk} w_j gc_j,
//   dL/da = live && act ? gc t_before - A_i / max(1 - a, 1e-6) : 0,   dq = -a/2 dL/da,
// and the copy's gradients follow from six pixel sums of dq (1, d0, d1, d0^2, d0 d1,
// d1^2), d = pixel - mean (the TPU kernel's pixel-basis moments taken about the
// gaussian's mean rather than the tile centre: no fp32 cancellation), plus
// dL/dc = sum w g_rgb.  The 1 / (1 - a) is an exact division (the TPU kernel takes
// pl.reciprocal(approx=True) on the TPU and the exact one elsewhere).
//
// What bounds it on an H100: arithmetic.  Every replayed (copy, pixel) pair costs two
// alpha evaluations (a first pass gives the chunk's sum of w gc, from which the second
// forms each suffix as chunk sum minus running prefix) plus ~35 FP32 operations of
// backward algebra, ~49 in all, and a warp reduction of 9 partial sums per copy.
// Bytes are t_chk and g_out (read once per row) and the [9, cap] gradient row.
//
// What the design does about it: one block per plane row, PPT pixels per thread, each
// chunk of <= 128 copies staged once in shared memory.  Per copy, each warp reduces its
// 9 partial sums with shuffles into a [warps, chunk, 9] stage, and one thread per copy
// adds the warps and applies the per-copy algebra.  The alpha is evaluated without FMA
// contraction, as B5f and the plain version evaluate it.  This is kernel B2's design
// (mirror_bwd.cu) for one view.
#include "composite.cuh"

namespace {

using gsvc::Alpha;
using gsvc::Chunk;
using gsvc::Planes;
using gsvc::alpha_at;
using gsvc::kMaxChunk;
using gsvc::kMaxThreads;
using gsvc::kTEps;
using gsvc::load_plane_chunk;

constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSums = 9;  // dq * (1, d0, d1, d0^2, d0 d1, d1^2), w * (r, g, b)

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
tile_bwd_kernel(Planes pl, const int* __restrict__ counts, const float* __restrict__ tchk,
                const float* __restrict__ gout, float* __restrict__ grads, int n_tiles,
                int n_tiles_x, int tile_w, int cap, int chunk, float bg) {
  __shared__ Chunk s;
  __shared__ float red[kMaxWarps][kMaxChunk][kSums];
  __shared__ int hot;
  const int row = blockIdx.x;
  const int u = row % n_tiles;
  const int tx = u % n_tiles_x;
  const int p_pix = blockDim.x * PPT;
  const int tile_h = p_pix / tile_w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float cx = static_cast<float>(tx * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int n_chunks = cap / chunk;
  const int n_used = min((counts[row] + chunk - 1) / chunk, n_chunks);
  const float* tc = tchk + static_cast<size_t>(row) * (n_chunks + 1) * p_pix;
  const float* go = gout + static_cast<size_t>(row) * 4 * p_pix;
  float* gr = grads + static_cast<size_t>(row) * kSums * cap;

  float xs[PPT], ys[PPT], g3[PPT][3], a_acc[PPT];
  int my_hot = -1;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = threadIdx.x + k * blockDim.x;
    xs[k] = static_cast<float>(lin % tile_w) - (tile_w - 1) / 2.0f;
    ys[k] = static_cast<float>(lin / tile_w) - (tile_h - 1) / 2.0f;
    g3[k][0] = go[lin];
    g3[k][1] = go[p_pix + lin];
    g3[k][2] = go[2 * p_pix + lin];
    a_acc[k] = tc[n_chunks * p_pix + lin] * (bg * (g3[k][0] + g3[k][1] + g3[k][2]) +
                                             go[3 * p_pix + lin]);
    for (int c = 0; c < n_used; ++c)
      if (tc[c * p_pix + lin] >= kTEps) my_hot = max(my_hot, c);
  }
  if (threadIdx.x == 0) hot = -1;
  __syncthreads();
  atomicMax(&hot, my_hot);
  __syncthreads();
  const int c_hot = hot;

  // zero the slots the replay never reaches (chunks past c_hot)
  for (int slot = (c_hot + 1) * chunk + threadIdx.x; slot < cap; slot += blockDim.x) {
#pragma unroll
    for (int q = 0; q < kSums; ++q) gr[q * cap + slot] = 0.0f;
  }

  for (int c = c_hot; c >= 0; --c) {
    __syncthreads();  // the previous chunk's stage and reductions are consumed
    load_plane_chunk(s, pl, row, c, chunk, cap, cx, cy);
    __syncthreads();

    float t0[PPT], e[PPT], sum_w[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      t0[k] = tc[c * p_pix + threadIdx.x + k * blockDim.x];
      e[k] = 1.0f;
      sum_w[k] = 0.0f;
    }
    // pass 1: the chunk's sum of w gc per pixel
    for (int i = 0; i < chunk; ++i) {
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
    for (int i = 0; i < chunk; ++i) {
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

// Launches one block per plane row on `stream`: n_rows blocks.  planes is a host array
// of nine device pointers to [n_rows, cap] f32 planes (the rows kernel B5f
// composited); counts [n_rows] i32, tchk [n_rows, cap / chunk + 1, P] f32, gout
// [n_rows, 4, P] f32 and grads [n_rows, 9, cap] f32 are device pointers;
// P = threads * ppt = tile_h * tile_w.  Returns cudaGetLastError() after the launch.
extern "C" int tile_backward(const float* const* planes, const int* counts,
                             const float* tchk, const float* gout, float* grads,
                             int n_rows, int n_tiles, int n_tiles_x, int tile_w, int cap,
                             int chunk, int threads, int ppt, float bg, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || cap % chunk != 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || tile_w <= 0 ||
      (threads * ppt) % tile_w != 0 || n_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  Planes pl;
  for (int i = 0; i < 9; ++i) pl.p[i] = planes[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GSVC_TILE_BWD_LAUNCH(P)                                                         \
  tile_bwd_kernel<P><<<n_rows, threads, 0, st>>>(pl, counts, tchk, gout, grads,        \
                                                 n_tiles, n_tiles_x, tile_w, cap, chunk, \
                                                 bg)
  switch (ppt) {
    case 1: GSVC_TILE_BWD_LAUNCH(1); break;
    case 2: GSVC_TILE_BWD_LAUNCH(2); break;
    case 4: GSVC_TILE_BWD_LAUNCH(4); break;
    case 8: GSVC_TILE_BWD_LAUNCH(8); break;
    case 16: GSVC_TILE_BWD_LAUNCH(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSVC_TILE_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
