// Pieces of the mirror kernels B1 (mirror_fwd.cu) and B2 (mirror_bwd.cu) as laid out
// for Hopper, taken also by B4 (bidir.cu), the single-view kernels B5f (tile_fwd.cu)
// and B5b (tile_bwd.cu) and the stream kernels B6f (stream_fwd.cu) and B6b
// (stream_bwd.cu):
//
//   * Stage: one chunk of a tile's copies in shared memory, 48 B per copy, filled by
//     cp.async straight from the [m, 9] rows or the nine [rows, cap] planes (no
//     registers, no wait until the data is needed) and read back with three vector
//     loads;
//   * Column: a copy as seen by one thread of a block whose pixels all lie in one tile
//     column (threads a multiple of tile_w), with the x terms of the alpha formed once
//     per copy instead of once per pixel;
//   * replay_chunk: B2's per-pixel loop over one staged chunk, walking the copies in
//     composite order with one alpha evaluation per (copy, pixel), and its per-copy
//     warp reduction.
//
// Every product and sum before the alpha is rounded on its own, in the plain PyTorch
// versions' order (alpha_col), so every kernel evaluates the same alphas bit for bit.
//
// The precision modes of every compositing kernel (render/bidir.py check_precision, the
// table in render/mirror.py) are a template parameter MODE of the kernels, the bits
// below; MODE 0 is the float32 code.  compute_dtype "bfloat16" evaluates the alpha of
// two rows of a column at once in __nv_bfloat162 lanes (ColumnBf16, alpha_col2),
// matmul_dtype "bfloat16" takes each copy's in-chunk transmittance factor from a bf16
// log (trans_factor), and every mode but float32 rounds the backward's products'
// operands to bf16 (replay_chunk).
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "composite.cuh"

namespace gsvc {

constexpr int kAlphaBf16 = 1;  // compute_dtype "bfloat16"
constexpr int kTransBf16 = 2;  // matmul_dtype "bfloat16"
constexpr int kGradBf16 = 4;   // any mode but float32 / float32

// The modes a forward kernel takes (the alpha and transmittance bits: B1, B4, B5f, B6f)
// and those a backward kernel takes (float32, or kGradBf16 with any of the others: B2,
// B5b, B6b).  Each calls launch(Mode<MODE>{}) for `mode` and refuses any other value
// with cudaErrorInvalidValue: no kernel runs another mode in its place.
template <int M>
using Mode = std::integral_constant<int, M>;

template <typename Launch>
cudaError_t forward_mode(int mode, Launch&& launch) {
  switch (mode) {
    case 0: return launch(Mode<0>{});
    case kAlphaBf16: return launch(Mode<kAlphaBf16>{});
    case kTransBf16: return launch(Mode<kTransBf16>{});
    case kAlphaBf16 | kTransBf16: return launch(Mode<kAlphaBf16 | kTransBf16>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename Launch>
cudaError_t backward_mode(int mode, Launch&& launch) {
  switch (mode) {
    case 0: return launch(Mode<0>{});
    case kGradBf16: return launch(Mode<kGradBf16>{});
    case kGradBf16 | kAlphaBf16: return launch(Mode<kGradBf16 | kAlphaBf16>{});
    case kGradBf16 | kTransBf16: return launch(Mode<kGradBf16 | kTransBf16>{});
    case kGradBf16 | kAlphaBf16 | kTransBf16:
      return launch(Mode<kGradBf16 | kAlphaBf16 | kTransBf16>{});
    default: return cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A copy's factor of the transmittance inside a chunk: 1 - a, or in matmul_dtype
// "bfloat16" exp(bf16(log1p(-a))) (the TPU kernel's exclusive cumsum of bf16 logs with
// float32 accumulation, as a product of their exponentials; log1pf and expf are
// PyTorch's log1p and exp on the card).  A chunk's total stays the float32 product of
// (1 - a).
template <int MODE>
__device__ __forceinline__ float trans_factor(float a) {
  if constexpr ((MODE & kTransBf16) != 0) return expf(bf16_round(log1pf(-a)));
  else return 1.0f - a;
}

constexpr int kSums = 9;  // dq * (1, d0, d1, d0^2, d0 d1, d1^2), w * (r, g, b)
constexpr int kMaxWarps = kMaxThreads / 32;

// One chunk of copies: v[i][0] = (mean x, mean y, conic a, conic b), v[i][1] = (conic
// c, opacity, r, g), v[i][2].x = b; tile-local means and conic * -1/2 once finished.
struct Stage {
  float4 v[kMaxChunk][3];
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(fill ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issues the copy of data chunk c's ids into ids[0, chunk).  Slot i belongs to thread
// i mod blockDim.x here and in stage_rows/finish_rows, so no barrier orders them.
__device__ __forceinline__ void stage_ids(int* ids, const int* __restrict__ list, int c,
                                          int chunk) {
  for (int i = threadIdx.x; i < chunk; i += blockDim.x)
    cp_async4(ids + i, list + static_cast<size_t>(c) * chunk + i, true);
}

// Issues the gather of the rows of `ids` (already landed) into the stage; a padding id
// (-1, or out of range) reads nothing and leaves a row of zeros.
__device__ __forceinline__ void stage_rows(Stage& st, const int* ids,
                                          const float* __restrict__ rows, int chunk,
                                          int m) {
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const int id = ids[i];
    const bool ok = id >= 0 && id < m;
    const float* row = rows + (ok ? static_cast<size_t>(id) * 9 : 0);
    float* dst = &st.v[i][0].x;
#pragma unroll
    for (int q = 0; q < 9; ++q) cp_async4(dst + q, row + q, ok);
  }
}

// After cp_async_wait_all: makes the calling thread's staged rows tile-local (cx, cy the
// tile centre) with the conic scaled by -1/2; padding rows
// stay all zero (opacity 0).
__device__ __forceinline__ void finish_rows(Stage& st, const int* ids, int chunk, int m,
                                           float cx, float cy) {
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const int id = ids[i];
    if (id >= 0 && id < m) {
      float4& p = st.v[i][0];
      p.x -= cx;
      p.y -= cy;
      p.z *= -0.5f;
      p.w *= -0.5f;
      st.v[i][1].x *= -0.5f;
    }
  }
}

// Issues the copy of the `chunk` slots at `base` of the nine planes (B5f/B5b's [rows,
// cap] attribute planes, the stream rows [9, n_slots] of B6f/B6b) into the stage.
// Slot i belongs to thread i mod blockDim.x, as in stage_rows.  The copies are 4
// bytes: the stage interleaves a copy's nine values, so no 16-byte run of a plane
// lands in one piece.  A chunk's 1,152 copies, spread over the block, cost a thread
// ~10 instructions against ~10^5 of replay.
__device__ __forceinline__ void stage_planes(Stage& st, const Planes& pl, size_t base,
                                            int chunk) {
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    float* dst = &st.v[i][0].x;
#pragma unroll
    for (int q = 0; q < 9; ++q) cp_async4(dst + q, pl.p[q] + base + i, true);
  }
}

// After cp_async_wait_all: makes the calling thread's staged plane slots tile-local
// with the conic scaled by -1/2, as finish_rows (every slot: a padding slot carries
// opacity 0).
__device__ __forceinline__ void finish_planes(Stage& st, int chunk, float cx, float cy) {
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    float4& p = st.v[i][0];
    p.x -= cx;
    p.y -= cy;
    p.z *= -0.5f;
    p.w *= -0.5f;
    st.v[i][1].x *= -0.5f;
  }
}

// Copy i as seen from tile-local column x: the x terms of the quadratic form, formed
// once for all the thread's pixels.
struct Column {
  float my, hb, hc, op, r, g, b;
  float d0;        // x - mean x
  float had0;      // (conic a * -1/2) d0
  float hbd0;      // (conic b * -1/2) d0
};

__device__ __forceinline__ Column column_at(const Stage& st, int i, float x) {
  const float4 p = st.v[i][0], q = st.v[i][1];
  Column c;
  c.my = p.y;
  c.hb = p.w;
  c.hc = q.x;
  c.op = q.y;
  c.r = q.z;
  c.g = q.w;
  c.b = st.v[i][2].x;
  c.d0 = __fsub_rn(x, p.x);
  c.had0 = __fmul_rn(p.z, c.d0);
  c.hbd0 = __fmul_rn(p.w, c.d0);
  return c;
}

// The clamps and the gate of an unclamped alpha, in float32 in every mode.
__device__ __forceinline__ Alpha alpha_clamp(float raw, float d0, float d1) {
  Alpha r;
  r.d0 = d0;
  r.d1 = d1;
  const float a = fminf(raw, kAlphaMax);
  const bool ge_min = a >= kAlphaMin;
  r.a = ge_min ? a : 0.0f;
  r.act = ge_min && raw < kAlphaMax;
  return r;
}

// Alpha of the column's copy at tile-local row y (pallas_splat.py _chunk_alpha), the
// x terms taken from the column.  Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn are never contracted into FMAs), in the plain PyTorch
// versions' order: ALPHA_MIN is a 1/255 step that a one-ulp difference could cross.
__device__ __forceinline__ Alpha alpha_col(const Column& c, float y) {
  const float d1 = __fsub_rn(y, c.my);
  const float u = __fadd_rn(c.had0, __fmul_rn(c.hb, d1));
  const float v = __fadd_rn(c.hbd0, __fmul_rn(c.hc, d1));
  const float q = __fadd_rn(__fmul_rn(c.d0, u), __fmul_rn(d1, v));
  return alpha_clamp(__fmul_rn(c.op, expf(q)), c.d0, d1);
}

// Copy i as seen from column x in compute_dtype "bfloat16".  The TPU kernel evaluates
//   alpha = bf16(op) * exp(-0.5 (a d0 d0 + 2b d0 d1 + c d1 d1))
// left to right in bf16 with d0, d1 = bf16(float32 delta) and a, b, c = bf16(conic).
// Scaling by -1/2 commutes with rounding (barring subnormals), so with the staged
// ha, hb, hc = -a/2, -b/2, -c/2 the exponent is, rounded step for step the same,
//   (ha d0 d0 + (2 hb) d0 d1) + hc d1 d1,
// whose x terms ha d0 d0 and (2 hb) d0 are formed once per column, in both lanes.
struct ColumnBf16 {
  Column f;                // the float32 column: mean y, colours, d0
  __nv_bfloat162 xa, xb;   // ha d0 d0, (2 hb) d0
  __nv_bfloat162 hc, op;
  float d0;                // bf16(d0)
};

// Copy i from column x as MODE evaluates it: the float32 column, and its bf16 terms in
// compute_dtype "bfloat16" (left unset otherwise).
template <int MODE>
__device__ __forceinline__ ColumnBf16 column_mode(const Stage& st, int i, float x) {
  ColumnBf16 c;
  c.f = column_at(st, i, x);
  if constexpr ((MODE & kAlphaBf16) != 0) {
    const float4 p = st.v[i][0], q = st.v[i][1];
    const __nv_bfloat16 d0 = __float2bfloat16_rn(c.f.d0);
    c.d0 = __bfloat162float(d0);
    c.xa = __bfloat162bfloat162(__hmul_rn(__hmul_rn(__float2bfloat16_rn(p.z), d0), d0));
    c.xb = __bfloat162bfloat162(__hmul_rn(__float2bfloat16_rn(2.0f * p.w), d0));
    c.hc = __float2bfloat162_rn(q.x);
    c.op = __float2bfloat162_rn(q.y);
  }
  return c;
}

// Alphas of the column's copy at rows y0 and y1 at once, one per bf16 lane: d1 = y - mean
// y in float32, rounded to bf16; the exponent and op * exp with packed ops that are never
// contracted (__hmul2_rn, __hadd2_rn), in the TPU kernel's order; the exp of each lane
// as float32 expf of its bf16 value, rounded once (PyTorch's exp on a bf16 tensor); the
// clamps and the gate in float32.  d0 and d1 come back bf16-rounded (the moments'
// factors).
__device__ __forceinline__ void alpha_col2(const ColumnBf16& c, float y0, float y1,
                                           Alpha& r0, Alpha& r1) {
  const __nv_bfloat162 d1 =
      __floats2bfloat162_rn(__fsub_rn(y0, c.f.my), __fsub_rn(y1, c.f.my));
  const __nv_bfloat162 e = __hadd2_rn(__hadd2_rn(c.xa, __hmul2_rn(c.xb, d1)),
                                      __hmul2_rn(__hmul2_rn(c.hc, d1), d1));
  const __nv_bfloat162 ex =
      __floats2bfloat162_rn(expf(__low2float(e)), expf(__high2float(e)));
  const __nv_bfloat162 raw = __hmul2_rn(c.op, ex);
  r0 = alpha_clamp(__low2float(raw), c.d0, __low2float(d1));
  r1 = alpha_clamp(__high2float(raw), c.d0, __high2float(d1));
}

// The alpha of pixel k (row ys[k]) of a thread's unrolled walk over its PPT rows, as MODE
// evaluates it: alpha_col in float32; in compute_dtype "bfloat16" alpha_col2 of rows k
// and k + 1 when k is even, the second kept in `next` for k + 1.
template <int MODE, int PPT>
__device__ __forceinline__ Alpha alpha_at(const ColumnBf16& c, const float (&ys)[PPT],
                                          int k, Alpha& next) {
  if constexpr ((MODE & kAlphaBf16) != 0) {
    if (k & 1) return next;
    Alpha a;
    alpha_col2(c, ys[k], ys[k + 1 < PPT ? k + 1 : k], a, next);
    return a;
  } else {
    return alpha_col(c.f, ys[k]);
  }
}

// A thread's replay state: its PPT pixels (tile-local rows y0 + k dy of column x).
template <int PPT>
struct Pixels {
  float x, y0, dy;
  float t0[PPT];     // transmittance before the chunk (t_chk)
  float g[PPT][3];   // dL/d rgb
  float s[PPT];      // t_final g_T + g . out_rgb: the suffix total
  float pre[PPT];    // running sum of w (c . g) over the copies walked so far
};

// The sums of two copies (a: lanes 0-15 end up with it, b: lanes 16-31) over the warp:
// one exchange that swaps halves (each lane keeps one copy), then a butterfly within
// each half, so a lane reduces 9 values where it would reduce 18.  Fixed order:
// deterministic.
__device__ __forceinline__ void reduce_pair(const float (&a)[kSums], const float (&b)[kSums],
                                            float (&out)[kSums]) {
  const bool hi = threadIdx.x & 16;
#pragma unroll
  for (int q = 0; q < kSums; ++q) {
    const float send = hi ? a[q] : b[q];
    float keep = hi ? b[q] : a[q];
    keep += __shfl_xor_sync(0xffffffffu, send, 16);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) keep += __shfl_xor_sync(0xffffffffu, keep, off);
    out[q] = keep;
  }
}

// B2's walk of one staged chunk by one warp, copies in composite order (j = 0.. ; slot
// i = j, or chunk - 1 - j for a flip view), one alpha evaluation per (copy, pixel):
//   t_before = t0 * prod_{earlier j} f_j          (B1's factors, so B1's liveness)
//   live = t_before >= T_EPS,  w = live ? a t_before : 0,  gc = c . g
//   pre += w gc,  A = s - pre                     (the suffix after the copy)
//   dL/da = live && act ? gc t_before - A / max(1 - a, 1e-6) : 0,  dq = -a/2 dL/da
// with f = trans_factor<MODE>(a).  Under kGradBf16 the caller has rounded g (and so s)
// to bf16, dL/da's gc is c' . g with c' the bf16-rounded colours, and the sums take
// bf16(dq), bf16(d0), bf16(d1) and bf16(w); pre keeps the float32 colours, so that A
// stays the suffix of the same terms that s totals.
// Each copy's 9 pixel sums go to red[q * red_stride + i] (this warp's stage), two
// copies per warp reduction.  The walk stops after the first pair of copies past which
// no pixel of the warp is live (T only falls, so every later term is zero).  Returns
// the number of copies walked (in composite order); the caller reads no sums past it.
template <int PPT, int MODE>
__device__ __forceinline__ int replay_chunk(const Stage& st, int chunk, bool flip,
                                            Pixels<PPT>& px, float* red, int red_stride) {
  constexpr bool kRound = (MODE & kGradBf16) != 0;
  const int lane = threadIdx.x & 31;
  float e[PPT], ys[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    e[k] = 1.0f;
    ys[k] = px.y0 + static_cast<float>(k) * px.dy;
  }
  for (int j0 = 0; j0 < chunk; j0 += 2) {
    float acc[2][kSums];
    bool alive = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) acc[h][q] = 0.0f;
      const int j = j0 + h;
      if (j >= chunk) continue;
      const ColumnBf16 cm = column_mode<MODE>(st, flip ? chunk - 1 - j : j, px.x);
      const Column& c = cm.f;
      Alpha next;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const Alpha al = alpha_at<MODE>(cm, ys, k, next);
        const float tb = px.t0[k] * e[k];
        const bool live = tb >= kTEps;
        const float w = live ? al.a * tb : 0.0f;
        const float gc = c.r * px.g[k][0] + c.g * px.g[k][1] + c.b * px.g[k][2];
        px.pre[k] += w * gc;
        const float a_i = px.s[k] - px.pre[k];
        const float gcd = kRound ? bf16_round(c.r) * px.g[k][0] +
                                       bf16_round(c.g) * px.g[k][1] +
                                       bf16_round(c.b) * px.g[k][2]
                                 : gc;
        const float d_alpha =
            (live && al.act) ? gcd * tb - a_i / fmaxf(1.0f - al.a, 1e-6f) : 0.0f;
        const float dq = kRound ? bf16_round(d_alpha * al.a * -0.5f)
                                : d_alpha * al.a * -0.5f;
        const float d1 =
            kRound && (MODE & kAlphaBf16) == 0 ? bf16_round(al.d1) : al.d1;
        const float wg = kRound ? bf16_round(w) : w;
        const float dq1 = dq * d1;
        acc[h][0] += dq;
        acc[h][2] += dq1;
        acc[h][5] += dq1 * d1;
        acc[h][6] += wg * px.g[k][0];
        acc[h][7] += wg * px.g[k][1];
        acc[h][8] += wg * px.g[k][2];
        e[k] *= trans_factor<MODE>(al.a);
        alive |= live;
      }
      const float d0 = (MODE & kAlphaBf16) ? cm.d0 : kRound ? bf16_round(c.d0) : c.d0;
      // d0 is the column's: the d0 moments are the d0-free sums times d0
      acc[h][1] = d0 * acc[h][0];
      acc[h][3] = d0 * acc[h][1];
      acc[h][4] = d0 * acc[h][2];
    }
    float sums[kSums];
    reduce_pair(acc[0], acc[1], sums);
    const int j = j0 + (lane >> 4);
    if ((lane & 15) == 0 && j < chunk) {
      const int i = flip ? chunk - 1 - j : j;
#pragma unroll
      for (int q = 0; q < kSums; ++q) red[q * red_stride + i] = sums[q];
    }
    // `alive` covers the pair's second copy last: no live pixel there, none after
    if (!__any_sync(0xffffffffu, alive)) return min(j0 + 2, chunk);
  }
  return chunk;
}

// A kernel whose static shared memory plus `smem` bytes of dynamic shared memory pass
// the 48 KiB a block gets without opting in (B5b and B6b: the per-warp stage is
// threads / 32 x 9 x chunk floats, 36,864 B at 256 threads and chunk 128, beside two
// chunk stages) is opted in to what it needs.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t smem) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess || fa.sharedSizeBytes + smem <= 48 * 1024) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace gsvc
