// Kernel B4 of the PyTorch/CUDA port: the bidirectional decode composite.
//
// Replaces the TPU kernel _fwd_kernel_bidir (gsvc_tpu/render/pallas_splat.py:1074,
// launched by _bidir_call / bidir_composite_attrs, :1149 / :1178).  It computes the
// decoded frame, the average of the forward and x-flipped views, from the forward
// view's depth-sorted tile lists with one alpha evaluation per (copy, pixel):
//
//   out(p) = 1/2 [ sum_i a_i c_i T_i  +  sum_i a_i c_i S_i ]
//
// T_i the front prefix product of (1 - a), S_i the back suffix product.  A front loop
// composites the forward view and accumulates the suffix sum by Horner's rule
// (W <- W (1 - a) + a c); it stops at the first chunk boundary where no pixel of the
// tile keeps T >= T_EPS.  A back loop walks from the last used chunk down to that
// stop, compositing the flip view until its transmittance saturates.  Dropped terms
// carry weight < T_EPS.  The Python wrapper is gsvc_tpu_torch/render/bidir.py, whose
// plain PyTorch version computes the same function.
//
// What bounds it on an H100: issued instructions, and on a decoded frame the critical
// path of its heaviest tiles.  Each (copy, pixel) pair costs one alpha (quadratic form
// + expf, every product and sum rounded on its own, so no FMA) and two compositing
// updates, while the bytes are small: a tile reads its id list and its copies' 9
// attributes once (36 B per copy, shared by its pixels) and writes 4 floats per pixel.
// A decoded frame's tiles are very unequal: at 1080p a few dozen tiles hold
// their full 1024 copies and about half of the frame's pairs, and one block per tile
// leaves each of them on one SM for longer than the whole card needs for all pairs.
//
// What the design does about it:
//   * One thread-block cluster of C CTAs per data tile (launched with
//     cudaLaunchKernelEx and a cluster dimension; C from the launch plan in
//     render/bidir.py).  CTA r owns tile rows [r tile_h / C, (r + 1) tile_h / C) of
//     every column, so a heavy tile's pairs spread over C SMs.
//   * The tile's stops stay the tile's.  At each chunk of the front loop (on T) and of
//     the back loop (on S) every CTA reduces its live flag (__syncthreads_or), writes
//     it to its shared memory, and after cluster.sync() reads all C flags through
//     distributed shared memory, so every CTA takes the same front stop and the same
//     back-loop stop as one block over the whole tile.  The flag is double-buffered,
//     so one cluster barrier per chunk suffices; a last cluster.sync() keeps every CTA
//     resident until no peer can read its flags.
//   * A thread owns one pixel column (threads a multiple of tile_w), so a copy's x
//     terms of the alpha are formed once per thread (replay.cuh column_at/alpha_col:
//     rounded in the plain version's order).  Its front transmittance, forward
//     colour sum and Horner back-suffix sum stay in registers.
//   * Each CTA stages its chunks itself with cp.async (replay.cuh stage_ids /
//     stage_rows / finish_rows), double-buffered: chunk p + 1 of the front loop and
//     chunk q - 1 of the back loop are in flight while the current chunk is
//     composited, and the vote's barrier publishes them.
//   * A chunk's walk ends at the tile's last copy.  At 1080p most tiles of a decoded
//     frame hold a few dozen copies in their one chunk, and walking all 128 slots of
//     every used chunk made padding ~60% of the (slot, pixel) pairs a frame walked.
//   * Heaviest tiles first: the launcher passes the tiles in falling order of their
//     copies (order[]), so the long-lived CTAs of the heavy tiles start first and
//     spread over the SMs, rather than landing wherever a light tile frees a slot,
//     where several of them can end up sharing one SM.
//   * Per pixel, the copies, their order, the operations and the tile's stops are
//     those of one block per tile, so C changes no bit of the output.
//
// Precision modes (template parameter MODE; render/mirror.py's table): the alphas as B1
// takes them (two rows a packed bf16 operation in compute_dtype "bfloat16"); in
// matmul_dtype "bfloat16" the in-chunk prefix and suffix products take each copy's
// factor exp(bf16(log1p(-a))), so the front loop keeps the chunk's own Horner sum
// apart and carries it, as T and S, by the chunk's float32 product of (1 - a).
#include <cooperative_groups.h>

#include "replay.cuh"

namespace cg = cooperative_groups;

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
using gsvc::kMaxChunk;
using gsvc::kMaxThreads;
using gsvc::kTEps;
using gsvc::kTransBf16;
using gsvc::stage_ids;
using gsvc::stage_rows;
using gsvc::trans_factor;

// The tile's vote on a chunk stop: whether any pixel of any CTA of the cluster is
// live.  flags[2] is this CTA's double-buffered flag in shared memory; n counts the
// votes taken.  Every thread of every CTA of the cluster calls it the same number of
// times.  Its block barrier also publishes the stage issued before it.
__device__ __forceinline__ bool tile_live(int* flags, int& n, bool live) {
  cg::cluster_group cl = cg::this_cluster();
  const int any = __syncthreads_or(live);
  int* flag = flags + (n & 1);
  if (threadIdx.x == 0) *flag = any;
  cl.sync();
  int all = 0;
  for (unsigned r = 0; r < cl.num_blocks(); ++r) all |= *cl.map_shared_rank(flag, r);
  ++n;
  return all != 0;
}

// Stages data chunk c0 into st[0] and issues the ids of chunk c1 (none if c1 < 0) into
// ids[1]; waits for both.
__device__ __forceinline__ void stage_first(Stage* st, int (*ids)[kMaxChunk],
                                            const float* __restrict__ rows,
                                            const int* __restrict__ list, int c0, int c1,
                                            int chunk, int m, float cx, float cy) {
  stage_ids(ids[0], list, c0, chunk);
  cp_async_commit();
  cp_async_wait_all();
  stage_rows(st[0], ids[0], rows, chunk, m);
  if (c1 >= 0) stage_ids(ids[1], list, c1, chunk);
  cp_async_commit();
  cp_async_wait_all();
  finish_rows(st[0], ids[0], chunk, m, cx, cy);
}

template <int PPT, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
bidir_kernel(const float* __restrict__ attrs, const int* __restrict__ lists,
             const int* __restrict__ counts, const int* __restrict__ order,
             float* __restrict__ out, int m, int n_tiles, int n_tiles_x, int tile_w,
             int cap, int chunk, float bg) {
  __shared__ Stage st[2];
  __shared__ int ids[2][kMaxChunk];
  __shared__ int flags[2];
  cg::cluster_group cl = cg::this_cluster();
  const int n_ctas = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  // data tile (frame * n_tiles + tile) of this cluster: its order[] entry
  const int g = order[blockIdx.x / n_ctas];
  const int f = g / n_tiles;
  const int u = g - f * n_tiles;
  const int p_cta = blockDim.x * PPT;  // this CTA's pixels: tile rows of all columns
  const int p_pix = p_cta * n_ctas;
  const int tile_h = p_pix / tile_w;
  const float* rows = attrs + static_cast<size_t>(f) * m * 9;
  const int* list = lists + static_cast<size_t>(g) * cap;
  const float cx = static_cast<float>((u % n_tiles_x) * tile_w) + (tile_w - 1) / 2.0f;
  const float cy = static_cast<float>((u / n_tiles_x) * tile_h) + (tile_h - 1) / 2.0f;
  const int count = min(counts[g], cap);
  const int n_used = (count + chunk - 1) / chunk;
  // copies in data chunk c: the slots past the count are padding (id -1: opacity 0,
  // alpha 0, a factor 1 and a term 0 that change no bit), so a partly filled last
  // chunk walks only its copies
  auto real = [&](int c) { return min(chunk, count - c * chunk); };

  // pixel k of this thread: lin = rank * p_cta + threadIdx.x + k * blockDim.x, all in
  // one column
  const float x = static_cast<float>(threadIdx.x % tile_w) - (tile_w - 1) / 2.0f;
  float ys[PPT], tf[PPT], af[PPT][3], ah[PPT][3];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = rank * p_cta + threadIdx.x + k * blockDim.x;
    ys[k] = static_cast<float>(lin / tile_w) - (tile_h - 1) / 2.0f;
    tf[k] = 1.0f;
    af[k][0] = af[k][1] = af[k][2] = 0.0f;
    ah[k][0] = ah[k][1] = ah[k][2] = 0.0f;
  }

  // front loop: forward view + Horner back-suffix accumulator
  int votes = 0;
  if (n_used > 0) stage_first(st, ids, rows, list, 0, n_used > 1 ? 1 : -1, chunk, m, cx, cy);
  int p = 0;
  for (; p < n_used; ++p) {
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= tf[k] >= kTEps;
    // publishes stage p and ids p + 1; the reads of stage p - 1 are done
    if (!tile_live(flags, votes, live)) break;
    const int b = p & 1;
    if (p + 1 < n_used) stage_rows(st[b ^ 1], ids[b ^ 1], rows, chunk, m);
    if (p + 2 < n_used) stage_ids(ids[b], list, p + 2, chunk);
    cp_async_commit();
    const Stage& s = st[b];
    const int n = real(p);
    if constexpr ((MODE & kTransBf16) != 0) {
      // in-chunk products of the factors f (e) and of 1 - a (pm), and the chunk's own
      // Horner sum (hc), carried into tf and ah at the chunk's end by pm
      float e[PPT], pm[PPT], hc[PPT][3];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        e[k] = pm[k] = 1.0f;
        hc[k][0] = hc[k][1] = hc[k][2] = 0.0f;
      }
      for (int i = 0; i < n; ++i) {
        const ColumnBf16 cm = column_mode<MODE>(s, i, x);
        const Column& c = cm.f;
        Alpha next;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float a = alpha_at<MODE>(cm, ys, k, next).a;
          const float tb = tf[k] * e[k];
          if (tb >= kTEps) {
            const float w = a * tb;
            af[k][0] += w * c.r;
            af[k][1] += w * c.g;
            af[k][2] += w * c.b;
          }
          const float fk = trans_factor<MODE>(a);
          hc[k][0] = hc[k][0] * fk + a * c.r;
          hc[k][1] = hc[k][1] * fk + a * c.g;
          hc[k][2] = hc[k][2] * fk + a * c.b;
          e[k] *= fk;
          pm[k] *= 1.0f - a;
        }
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        tf[k] *= pm[k];
#pragma unroll
        for (int q = 0; q < 3; ++q) ah[k][q] = ah[k][q] * pm[k] + hc[k][q];
      }
    } else {
      for (int i = 0; i < n; ++i) {
        const ColumnBf16 cm = column_mode<MODE>(s, i, x);
        const Column& c = cm.f;
        Alpha next;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float a = alpha_at<MODE>(cm, ys, k, next).a;
          const float one_m = 1.0f - a;
          if (tf[k] >= kTEps) {
            const float w = a * tf[k];
            af[k][0] += w * c.r;
            af[k][1] += w * c.g;
            af[k][2] += w * c.b;
          }
          ah[k][0] = ah[k][0] * one_m + a * c.r;
          ah[k][1] = ah[k][1] * one_m + a * c.g;
          ah[k][2] = ah[k][2] * one_m + a * c.b;
          tf[k] *= one_m;
        }
      }
    }
    cp_async_wait_all();
    if (p + 1 < n_used) finish_rows(st[b ^ 1], ids[b ^ 1], chunk, m, cx, cy);
  }
  const int p_stop = p;

  // back loop: flip-view contributions of the chunks past the front stop.  It runs
  // only after a vote that stopped the front loop, so the stages are free.
  float tb[PPT], ab[PPT][3];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    tb[k] = 1.0f;
    ab[k][0] = ab[k][1] = ab[k][2] = 0.0f;
  }
  const int q0 = n_used - 1;
  if (q0 >= p_stop)
    stage_first(st, ids, rows, list, q0, q0 - 1 >= p_stop ? q0 - 1 : -1, chunk, m, cx,
                cy);
  for (int q = q0; q >= p_stop; --q) {
    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= tb[k] >= kTEps;
    if (!tile_live(flags, votes, live)) break;
    const int b = (q0 - q) & 1;
    if (q - 1 >= p_stop) stage_rows(st[b ^ 1], ids[b ^ 1], rows, chunk, m);
    if (q - 2 >= p_stop) stage_ids(ids[b], list, q - 2, chunk);
    cp_async_commit();
    const Stage& s = st[b];
    // e: the in-chunk suffix product of the factors; pm: the chunk's float32 product of
    // (1 - a), carried into tb at the chunk's end (matmul_dtype "bfloat16" only)
    float e[PPT], pm[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) e[k] = pm[k] = 1.0f;
    for (int i = real(q) - 1; i >= 0; --i) {
      const ColumnBf16 cm = column_mode<MODE>(s, i, x);
      const Column& c = cm.f;
      Alpha next;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float a = alpha_at<MODE>(cm, ys, k, next).a;
        const float sb = (MODE & kTransBf16) ? tb[k] * e[k] : tb[k];
        if (sb >= kTEps) {
          const float w = a * sb;
          ab[k][0] += w * c.r;
          ab[k][1] += w * c.g;
          ab[k][2] += w * c.b;
        }
        if (MODE & kTransBf16) {
          e[k] *= trans_factor<MODE>(a);
          pm[k] *= 1.0f - a;
        } else {
          tb[k] *= 1.0f - a;
        }
      }
    }
    if (MODE & kTransBf16) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) tb[k] *= pm[k];
    }
    cp_async_wait_all();
    if (q - 1 >= p_stop) finish_rows(st[b ^ 1], ids[b ^ 1], chunk, m, cx, cy);
  }

  float* o = out + static_cast<size_t>(g) * 4 * p_pix;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int lin = rank * p_cta + threadIdx.x + k * blockDim.x;
    const float tau = tf[k] * tb[k];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c * p_pix + lin] = 0.5f * (af[k][c] + ab[k][c] + ah[k][c] * tb[k]) + tau * bg;
    o[3 * p_pix + lin] = tau;
  }
  // no CTA leaves while a peer may still read its flags
  cl.sync();
}

template <int MODE>
cudaError_t launch(cudaLaunchConfig_t* cfg, int ppt, const float* attrs, const int* lists,
                   const int* counts, const int* order, float* out, int m, int n_tiles,
                   int n_tiles_x, int tile_w, int cap, int chunk, float bg) {
#define GSVC_BIDIR_LAUNCH(P)                                                          \
  return cudaLaunchKernelEx(cfg, bidir_kernel<P, MODE>, attrs, lists, counts, order, out, \
                            m, n_tiles, n_tiles_x, tile_w, cap, chunk, bg)
  switch (ppt) {
    case 1: GSVC_BIDIR_LAUNCH(1);
    case 2: GSVC_BIDIR_LAUNCH(2);
    case 4: GSVC_BIDIR_LAUNCH(4);
    case 8: GSVC_BIDIR_LAUNCH(8);
    case 16: GSVC_BIDIR_LAUNCH(16);
    default: return cudaErrorInvalidValue;
  }
#undef GSVC_BIDIR_LAUNCH
}

}  // namespace

// Launches one cluster of `cluster` CTAs per data tile on `stream` (n_frames * n_tiles
// clusters; CTA r of a cluster takes the tile's rows [r tile_h / cluster, (r + 1)
// tile_h / cluster)); each CTA has `threads` threads (a multiple of tile_w) of `ppt`
// pixels.  Pointers are device pointers: attrs [n_frames, m, 9] f32, lists
// [n_frames * n_tiles, cap] i32 (-1 padded), counts [n_frames * n_tiles] i32, order
// [n_frames * n_tiles] i32 the tiles in launch order (heaviest first), out
// [n_frames * n_tiles, 4, cluster * threads * ppt] f32.  Returns the launch's error (a
// cluster the card refuses) or cudaGetLastError() after it (0 on success); it never
// launches another shape in its place.  `mode` is render/bidir.py check_precision's
// kAlphaBf16 and kTransBf16 bits (0: float32; bf16x2 composites as float32); any other
// value is refused, never replaced by float32.
extern "C" int bidir_composite(const float* attrs, const int* lists, const int* counts,
                               const int* order, float* out, int n_frames, int m,
                               int n_tiles, int n_tiles_x, int tile_w, int cap, int chunk,
                               int cluster, int threads, int ppt, int mode, float bg,
                               void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || cap % chunk != 0 || threads <= 0 ||
      threads > kMaxThreads || tile_w <= 0 || threads % tile_w != 0 || cluster < 1 ||
      order == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = n_frames * n_tiles;
  if (tiles == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles) * static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = gsvc::forward_mode(mode, [&](auto md) {
    return launch<decltype(md)::value>(&cfg, ppt, attrs, lists, counts, order, out, m,
                                       n_tiles, n_tiles_x, tile_w, cap, chunk, bg);
  });
  // clears the error a refused launch leaves, so no later launch reports it
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
