// Fused preprocess ladder kernels for Hopper (sm_90a):
//   4:2:0 / 4:4:4 YUV planes -> resample -> 3x3 CSC -> clip -> (x - shift) / norm
//   -> (N, 3, out_h, out_w) f32 NCHW, one launch per batch.
//
// Replaces (gmat_tpu/ops/pallas_kernels.py):
//   K1 _ladder_kernel_i8          (int8 row stage)        -> ladder_kernel<uint8_t, true, *>
//   K3 _ladder_kernel_i8_chunked  (K1 over column chunks) -> the same kernel: it walks
//                                 any width, so 8K frames need no chunked variant
//   K2 _ladder_kernel             (bf16 row stage, u8 or lsb-aligned u16 samples)
//                                 -> ladder_kernel<uint8_t|uint16_t, false, *>
//   K6 _ladder_nv12_kernel        (NV12 wire, bf16 rows)  -> wire_kernel<uint8_t, false, *>
//   K7 _ladder_nv12_kernel_i8     (NV12 wire, int8 rows)  -> wire_kernel<uint8_t, true, *>
//   K8 _ladder_p010_kernel        (P010 wire, bf16 rows)  -> wire_kernel<uint16_t, false, *>
//   (* the window instance: 2 or 4 taps, or 0 for the band walk)
//
// The wire kernels read (N, 3H/2, W): luma rows, then interleaved U,V rows.  The
// TPU kernels deinterleave with zero-padded (W, out_w) column matrices (U at even
// columns, V at odd); here the planar chroma matrix (W/2 inputs) indexes U,V
// pairs, one 2-sample load per pair, which sums the same nonzero terms without
// the zeros.  K6's row stage sums luma over 512-row chunks and chroma over half
// as many; K8 in one chunk; these kernels, like K2's, sum each window in one f32
// loop (the plain versions repeat the chunks: <= 1 u8-LSB apart).
// K8 rounds the raw msb-aligned u16 value to bf16 and scales by 1/64 after the
// column stage, as the TPU kernel does (not the same as shifting first when the
// low 6 bits are set).
//
// Numerics kept from the TPU kernels (the plain PyTorch versions in ops/ladder.py
// repeat them):
//   K1: t = sum_h Ah_q[i,h] * (x[h,w] - 128)     exact, int32 (x ^ 0x80 as int8)
//       tb = bf16_rn(float(t) * inv_s)           one f32 multiply, then RNE to bf16
//   K2: t = sum_h bf16(Ah[i,h]) * bf16_rn(x[h,w]) in f32; tb = bf16_rn(t)
//   both: o = sum_w tb * bf16(Aw[w,j]) in f32; K1 then adds off[i] = 128*rowsum(Ah_q)/s;
//         epilogue (o - low|mid), 3x3 matrix, clip [0, 2*mid-1], (c - shift[c]) * inv_norm.
//   Every product of two bf16 values is exact in f32, so only the order of the f32
//   sums can differ from the plain version.  The epilogue uses explicit _rn
//   intrinsics so that no multiply-add is contracted into an FMA.
//
// What bounds it on this card: bytes.  A resample matrix from a real geometry is a
// narrow band (a 1080 -> 224 bilinear row has 2 nonzero taps of 1080), so the dense
// products the TPU ran on its matrix unit are >99% multiplications by zero: at 64 x
// 1080p -> 224^2 the dense int8 work alone would be ~89 G-op per batch, while the
// nonzero work is under 1 G-op.  Reading the input planes is what remains.
//
// What the design does about it: the host passes each resample matrix in band
// form -- for every output row (column) the first input index with a nonzero
// weight, the window length, and the window's weights packed contiguously.  Skipping
// the zeros outside a window is exact (integer sums; f32 sums plus +0).  One thread
// computes one output pixel for all three planes: for each input column w in its
// column window it recomputes the row-stage value t[i, w] over its row window (the
// same exact value a stored row stage would hold), rounds it to bf16 and accumulates
// the column stage in f32; then it runs the epilogue and writes three floats.  The
// kernel reads only the input rows and columns the matrices touch (each once from
// device memory; neighbours share through L1/L2), keeps no intermediate in memory,
// needs no shared memory, and handles any frame size, crop, smooth or flip the
// host folds into the matrices.  A warp covers 32 neighbouring output columns of
// one row, so its row windows agree and its output stores are coalesced.
//
// The planar kernel (K1/K3, K2), redesigned.  Times per 64 x 1080p -> 224^2 batch
// (i8 / bf16 u8 / bf16 u16) and per 8 x 8K batch, from scratch scripts timing
// copies of this file as chip_smoke.py times it, on an H100 80GB HBM3 at 700 W;
// PERF.md keeps the runs.
//  0. It walked each pixel's band records with loops of unknown trip count, 12
//     single-sample loads and ~33 record loads per pixel, each sample load waiting
//     on its record load: 0.105 / 0.110 / 0.124 ms, 8K 0.027 ms.  Taken apart,
//     unrolling the loops for 2 taps alone gave 0.056 / 0.055 / 0.092: the
//     dependent chain set the time, then the samples.
//  1. Windows of known width.  The host pads every window of a geometry to the
//     same 2 or 4 taps with zero weights, inside its plane (a window at the
//     plane's end moves left), and picks the instance from the widest window:
//     ladder_kernel<T, kI8, 2> (bilinear, nearest), <.., 4> (bicubic, area to
//     ~3:1), <.., 0> the band walk above (lanczos3, fused smooth, wider area).
//     The loops unroll, and a pixel's 3 x taps^2 loads are in flight together.
//  2. Records: per output row one record (first row of luma and chroma, weights,
//     K1's offsets and -128 * weight sums) read by a warp at one address; per
//     output column one coalesced record (first columns, weights), shared by u
//     and v.  32-bit offsets inside a frame.
//  3. Loads: a 2-tap window takes one load per sample (two aligned words and a
//     funnel shift per row were 4-9% slower: the same two loads and more ALU); a
//     u8 window of 3-4 taps takes two aligned 32-bit words a row, funnel-shifted,
//     and only the last frame's blocks clamp the second word to the tensor.
//  4. One pixel a thread.  Threads that kept their column records for 2, 4 or 8
//     rows were slower (4 rows 0.062 / 0.060 / 0.093, with the loads of all rows
//     first or not): fewer record loads, but fewer blocks in flight.
//  With 1-4: 0.053 / 0.053 / 0.089 ms (84% / 84% / 87% of the bound), 8K 0.024
//  (69%), 32 registers, no spills, the same bits as before.  What is left at
//  1080p is the sample loads; at 8K each luma pair sits in a sector of its own.
//
// The wire kernel (K6/K7, K8), redesigned the same way (timed as above, on the
// same card).  It walked each pixel's band records as 0. above did, one U,V pair
// load per chroma sample pair: 0.092 ms per 64 x 1080p NV12 -> 224^2 batch
// (either row stage, 48% of the bound), 0.102 for P010 (76%).  Now:
//  - 1, 2 and 4 as in the planar kernel: the host builds the same window records
//    from the wire matrices, with the same function; the instance follows the
//    widest window; one pixel a thread in the same blocks.
//  - The chroma record's first column is a U,V pair index, and the chroma window
//    is kTaps x kTaps pairs: one 2-sample load yields U and V, which share the
//    chroma row and column weights, so a 2-tap pixel issues 4 luma and 4 pair
//    loads where the planar kernel issues 12.
//  - A frame's U,V rows follow its luma rows, so a luma word (u8, 3-4 taps)
//    past a row's end stays inside the tensor and no load is clamped; a pair
//    window lies inside its plane.
//  With these: 0.053 / 0.053 / 0.089 ms (K6 / K7 / K8; 84% / 84% / 86% of the
//  bound), K7 at 8 x 8K 0.024 (67%), K6 bicubic 0.076 (was 0.126), 32
//  registers, no spills, the same bits as before; no faster than the planar
//  kernel, though it issues fewer loads: the sectors the samples sit in, not
//  the loads, are what is left.
// Later work: put the int8 row stage on the tensor cores for wide (area,
// smoothed) bands.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Band form of one resample matrix, one entry per output index.
struct Band {
  const int32_t* lo;   // first input index of the window
  const int32_t* len;  // window length (0: the row is all zeros)
  const void* wts;     // (count, stride) window weights: int8 (K1 rows) or bf16
  int32_t stride;
};

// Mirrored field for field by _LadderArgs in gmat_tpu_torch/ops/ladder.py.
struct LadderArgs {
  const void* y;
  const void* u;
  const void* v;
  float* out;
  Band row_y, col_y, row_c, col_c;  // taps == 0: the band walk reads these
  const float* off_y;  // K1 only: 128 * rowsum(Ah_q) / s per output row
  const float* off_c;
  // taps 2 or 4: every window padded to `taps` samples inside its plane.
  // rows: (out_h, 8 + 2 * taps) per output row: luma and chroma first row, off_y
  //   and off_c (f32 bits, K1), luma then chroma row weights (int8 values, or bf16
  //   values as f32 bits), then (K1) -128 * the sum of each weight row.
  // cols: (2 + 2 * taps, out_w): luma and chroma first column, luma then chroma
  //   column weights (f32 bits).
  const int32_t* rows;
  const int32_t* cols;
  int32_t n, h, w, ch, cw, out_h, out_w;
  int32_t taps;          // 2 or 4: window instances; 0: the band walk
  float inv_sy, inv_sc;  // K1 only: f32(1 / s)
  float mat[9];          // yuv2rgb_matrix, row major
  float low, mid, maxv, inv_norm;
  float shift[3];
};

// Mirrored field for field by _WireArgs in gmat_tpu_torch/ops/ladder.py.
struct WireArgs {
  const void* yuv;  // (n, 3h/2, w): h luma rows, then h/2 rows of U,V pairs
  float* out;
  Band row_y, col_y, row_c;
  Band col_c;       // planar chroma columns: w/2 inputs, one per U,V pair
  const float* off_y;  // K7 only, as in LadderArgs
  const float* off_c;
  // The window records of LadderArgs for the wire matrices: chroma rows are U,V
  // rows, and the chroma first column is a U,V pair index.
  const int32_t* rows;
  const int32_t* cols;
  int32_t n, h, w, out_h, out_w;
  int32_t taps;          // 2 or 4: window instances; 0: the band walk
  float inv_sy, inv_sc;  // K7 only
  float post;            // scale after the column stage: 1, or 1/64 for P010
  float mat[9];
  float low, mid, maxv, inv_norm;
  float shift[3];
};

namespace {

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Resampled value of one plane at output pixel (i, j), before offsets.
template <typename T, bool kI8>
__device__ __forceinline__ float resample_px(const T* __restrict__ x, int width,
                                             int i, int j, const Band& row,
                                             const Band& col, float inv_s) {
  const int h0 = row.lo[i], nh = row.len[i];
  const int w0 = col.lo[j], nw = col.len[j];
  const __nv_bfloat16* cwt =
      static_cast<const __nv_bfloat16*>(col.wts) + (size_t)j * col.stride;
  const T* base = x + (size_t)h0 * width + w0;
  float acc = 0.f;
  for (int b = 0; b < nw; ++b) {
    const T* px = base + b;
    float tb;
    if (kI8) {
      const int8_t* rw = static_cast<const int8_t*>(row.wts) + (size_t)i * row.stride;
      int t = 0;
      for (int a = 0; a < nh; ++a)
        t += (int)rw[a] * ((int)__ldg(px + (size_t)a * width) - 128);
      tb = bf16_rn(__fmul_rn(__int2float_rn(t), inv_s));
    } else {
      const __nv_bfloat16* rw =
          static_cast<const __nv_bfloat16*>(row.wts) + (size_t)i * row.stride;
      float t = 0.f;
      for (int a = 0; a < nh; ++a)
        t = __fadd_rn(t, __fmul_rn(__bfloat162float(rw[a]),
                                   bf16_rn((float)__ldg(px + (size_t)a * width))));
      tb = bf16_rn(t);
    }
    acc = __fadd_rn(acc, __fmul_rn(tb, __bfloat162float(cwt[b])));
  }
  return acc;
}

template <typename T> struct PairOf;
template <> struct PairOf<uint8_t> { using type = uchar2; };
template <> struct PairOf<uint16_t> { using type = ushort2; };

// Resampled U and V at output pixel (i, j) from interleaved U,V rows (`width`
// samples each), before offsets.  `col` is the planar chroma column band (width/2
// inputs), so it indexes U,V pairs: one load fetches both samples, and the sums
// hold exactly the nonzero terms of the TPU kernels' zero-padded (W, out_w)
// interleave-aware matrices (U at even columns, V at odd).
template <typename T, bool kI8>
__device__ __forceinline__ float2 resample_uv_px(const T* __restrict__ uv, int width,
                                                 int i, int j, const Band& row,
                                                 const Band& col, float inv_s) {
  using P = typename PairOf<T>::type;
  const int h0 = row.lo[i], nh = row.len[i];
  const int w0 = col.lo[j], nw = col.len[j];
  const int pitch = width / 2;  // pairs per row
  const __nv_bfloat16* cwt =
      static_cast<const __nv_bfloat16*>(col.wts) + (size_t)j * col.stride;
  const P* base = reinterpret_cast<const P*>(uv) + (size_t)h0 * pitch + w0;
  float acc_u = 0.f, acc_v = 0.f;
  for (int b = 0; b < nw; ++b) {
    const P* px = base + b;
    float tu, tv;
    if (kI8) {
      const int8_t* rw = static_cast<const int8_t*>(row.wts) + (size_t)i * row.stride;
      int su = 0, sv = 0;
      for (int a = 0; a < nh; ++a) {
        const P p = __ldg(px + (size_t)a * pitch);
        su += (int)rw[a] * ((int)p.x - 128);
        sv += (int)rw[a] * ((int)p.y - 128);
      }
      tu = bf16_rn(__fmul_rn(__int2float_rn(su), inv_s));
      tv = bf16_rn(__fmul_rn(__int2float_rn(sv), inv_s));
    } else {
      const __nv_bfloat16* rw =
          static_cast<const __nv_bfloat16*>(row.wts) + (size_t)i * row.stride;
      float su = 0.f, sv = 0.f;
      for (int a = 0; a < nh; ++a) {
        const P p = __ldg(px + (size_t)a * pitch);
        const float wa = __bfloat162float(rw[a]);
        su = __fadd_rn(su, __fmul_rn(wa, bf16_rn((float)p.x)));
        sv = __fadd_rn(sv, __fmul_rn(wa, bf16_rn((float)p.y)));
      }
      tu = bf16_rn(su);
      tv = bf16_rn(sv);
    }
    const float cb = __bfloat162float(cwt[b]);
    acc_u = __fadd_rn(acc_u, __fmul_rn(tu, cb));
    acc_v = __fadd_rn(acc_v, __fmul_rn(tv, cb));
  }
  return make_float2(acc_u, acc_v);
}

// Epilogue of every ladder kernel at output pixel (i, j) of frame f, on the
// resampled planes with their int8 offsets: the low / mid offsets, 3x3 matrix,
// clip [0, maxv], (c - shift[c]) * inv_norm, three stores a plane apart.
template <typename Args>
__device__ __forceinline__ void store_rgb(const Args& a, int f, int i, int j, float oy,
                                          float ou, float ov) {
  const size_t plane = (size_t)a.out_h * a.out_w;
  float* const o = a.out + f * 3 * plane + (i * a.out_w + j);
  const float yy = __fsub_rn(oy, a.low), uu = __fsub_rn(ou, a.mid),
              vv = __fsub_rn(ov, a.mid);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = __fadd_rn(__fadd_rn(__fmul_rn(a.mat[3 * c], yy),
                                  __fmul_rn(a.mat[3 * c + 1], uu)),
                        __fmul_rn(a.mat[3 * c + 2], vv));
    s = fminf(fmaxf(s, 0.f), a.maxv);
    o[c * plane] = __fmul_rn(__fsub_rn(s, a.shift[c]), a.inv_norm);
  }
}

// ---------------------------------------------------------- planar ladder kernel
constexpr int kBlockX = 32;  // output columns of a block: one per thread of a warp
constexpr int kBlockY = 8;   // output rows of a block: one per warp

// x[a][b]: sample (a, b) of the kTaps x kTaps window whose first sample is at p in
// rows `width` samples apart.  kWords: per row two aligned 32-bit words
// funnel-shifted, so a u8 window of up to 4 samples takes two loads; kGuard clamps
// the second word to `last`, the plane tensor's last word (only the second can
// pass its end: the first holds the window's first sample).  Otherwise one load
// per sample.
template <typename T, int kTaps, bool kWords, bool kGuard>
__device__ __forceinline__ void load_window(const T* __restrict__ p, int width,
                                            uintptr_t last, uint32_t (&x)[kTaps][kTaps]) {
#pragma unroll
  for (int a = 0; a < kTaps; ++a) {
    const T* r = p + a * width;
    if (kWords) {
      const uintptr_t q = (uintptr_t)r & ~(uintptr_t)3;
      const uintptr_t q1 = kGuard && q + 4 > last ? last : q + 4;
      const uint32_t s = __funnelshift_r(__ldg(reinterpret_cast<const uint32_t*>(q)),
                                         __ldg(reinterpret_cast<const uint32_t*>(q1)),
                                         8 * (uint32_t)((uintptr_t)r & 3));
#pragma unroll
      for (int b = 0; b < kTaps; ++b) x[a][b] = (s >> (8 * b)) & 0xffu;
    } else {
#pragma unroll
      for (int b = 0; b < kTaps; ++b) x[a][b] = __ldg(r + b);
    }
  }
}

// One plane's resampled value at one output pixel from its padded window x,
// before offsets: the row stage per window column b (a ascending), then the
// column stage (b ascending).  Every product is exact in f32 (bf16 x bf16, or an
// int sum), so an FMA rounds as __fadd_rn after __fmul_rn does; the first term
// is taken without the loop's 0.f + (which changes only the sign of a zero sum,
// and the epilogue's offsets, never 0, remove that sign).  K1's sum is an exact
// int: bias + sum w * x with bias = -128 * sum w is the kernel's sum w * (x - 128).
template <typename T, bool kI8, int kTaps>
__device__ __forceinline__ float window_value(const uint32_t (&x)[kTaps][kTaps],
                                              const int32_t* rw, int bias,
                                              const float (&cw)[kTaps], float inv_s) {
  float acc = 0.f;
#pragma unroll
  for (int b = 0; b < kTaps; ++b) {
    float tb;
    if (kI8) {
      int t = bias;
#pragma unroll
      for (int a = 0; a < kTaps; ++a) t += rw[a] * (int)x[a][b];
      tb = bf16_rn(__fmul_rn(__int2float_rn(t), inv_s));
    } else {
      float t = 0.f;
#pragma unroll
      for (int a = 0; a < kTaps; ++a) {
        // a u8 sample is exact in bf16; a 10-16 bit one rounds, as on the TPU
        const float xs = sizeof(T) == 1 ? (float)x[a][b] : bf16_rn((float)x[a][b]);
        t = a ? __fmaf_rn(__int_as_float(rw[a]), xs, t)
              : __fmul_rn(__int_as_float(rw[a]), xs);
      }
      tb = bf16_rn(t);
    }
    acc = b ? __fmaf_rn(tb, cw[b], acc) : __fmul_rn(tb, cw[b]);
  }
  return acc;
}

// The window records of output pixel (i, j): its column's record (first luma and
// chroma column, then their weights) read coalesced, its row's record read by
// the whole warp at one address as 16-byte words through L1.  luma() and
// chroma() are a plane's resampled value from its padded window, before the
// int8 offsets off_y() / off_c().
template <bool kI8, int kTaps>
struct Records {
  static constexpr int kRec = 8 + 2 * kTaps;  // int32 words of a row record
  int cy, cc;
  float cwy[kTaps], cwc[kTaps];
  int32_t w[kRec];

  __device__ __forceinline__ Records(const int32_t* rows, const int32_t* cols, int ow,
                                     int i, int j) {
    constexpr int kLoad = kI8 ? kRec : kRec - 4;  // the last 4: K1/K7's bias words
    const int32_t* cr = cols + j;
    cy = __ldg(cr), cc = __ldg(cr + ow);
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      cwy[k] = __int_as_float(__ldg(cr + (2 + k) * ow));
      cwc[k] = __int_as_float(__ldg(cr + (2 + kTaps + k) * ow));
    }
    const int4* rec = reinterpret_cast<const int4*>(rows + i * kRec);
#pragma unroll
    for (int q = 0; q < kLoad / 4; ++q) {
      const int4 e = __ldg(rec + q);
      w[4 * q] = e.x, w[4 * q + 1] = e.y, w[4 * q + 2] = e.z, w[4 * q + 3] = e.w;
    }
  }
  template <typename T>
  __device__ __forceinline__ float luma(const uint32_t (&x)[kTaps][kTaps],
                                        float inv_s) const {
    return window_value<T, kI8, kTaps>(x, w + 4, kI8 ? w[4 + 2 * kTaps] : 0, cwy, inv_s);
  }
  template <typename T>
  __device__ __forceinline__ float chroma(const uint32_t (&x)[kTaps][kTaps],
                                          float inv_s) const {
    return window_value<T, kI8, kTaps>(x, w + 4 + kTaps, kI8 ? w[5 + 2 * kTaps] : 0, cwc,
                                       inv_s);
  }
  __device__ __forceinline__ float off_y() const { return __int_as_float(w[2]); }
  __device__ __forceinline__ float off_c() const { return __int_as_float(w[3]); }
};

// One output pixel (i, j) of frame f on the window records; the offsets inside a
// frame are 32-bit, and the three windows' loads are independent of one
// another, so all of them are in flight together.
template <typename T, bool kI8, int kTaps, bool kGuard>
__device__ __forceinline__ void window_px(const LadderArgs& a, int f, int i, int j) {
  // u8 windows of 3-4 samples: two words a row; 2-tap windows: a load per sample
  constexpr bool kWords = sizeof(T) == 1 && kTaps > 2;
  const Records<kI8, kTaps> r(a.rows, a.cols, a.out_w, i, j);
  const size_t luma = (size_t)a.h * a.w, chroma = (size_t)a.ch * a.cw;
  const T* const y = static_cast<const T*>(a.y);
  const T* const u = static_cast<const T*>(a.u);
  const T* const v = static_cast<const T*>(a.v);
  uintptr_t last_y = 0, last_u = 0, last_v = 0;
  if (kGuard) {
    last_y = ((uintptr_t)(y + a.n * luma) - 1) & ~(uintptr_t)3;
    last_u = ((uintptr_t)(u + a.n * chroma) - 1) & ~(uintptr_t)3;
    last_v = ((uintptr_t)(v + a.n * chroma) - 1) & ~(uintptr_t)3;
  }
  const int at_y = r.w[0] * a.w + r.cy, at_c = r.w[1] * a.cw + r.cc;
  uint32_t xy[kTaps][kTaps], xu[kTaps][kTaps], xv[kTaps][kTaps];
  load_window<T, kTaps, kWords, kGuard>(y + f * luma + at_y, a.w, last_y, xy);
  load_window<T, kTaps, kWords, kGuard>(u + f * chroma + at_c, a.cw, last_u, xu);
  load_window<T, kTaps, kWords, kGuard>(v + f * chroma + at_c, a.cw, last_v, xv);
  float oy = r.template luma<T>(xy, a.inv_sy);
  float ou = r.template chroma<T>(xu, a.inv_sc);
  float ov = r.template chroma<T>(xv, a.inv_sc);
  if (kI8) {
    oy = __fadd_rn(oy, r.off_y());
    ou = __fadd_rn(ou, r.off_c());
    ov = __fadd_rn(ov, r.off_c());
  }
  store_rgb(a, f, i, j, oy, ou, ov);
}

// The band walk for windows wider than 4 (lanczos3, a fused smooth, wider area):
// each pixel reads its band records, as 0. above walked every window.
template <typename T, bool kI8>
__device__ __forceinline__ void band_px(const LadderArgs& a, int f, int i, int j) {
  const size_t luma = (size_t)a.h * a.w, chroma = (size_t)a.ch * a.cw;
  const T* y = static_cast<const T*>(a.y) + f * luma;
  const T* u = static_cast<const T*>(a.u) + f * chroma;
  const T* v = static_cast<const T*>(a.v) + f * chroma;
  float oy = resample_px<T, kI8>(y, a.w, i, j, a.row_y, a.col_y, a.inv_sy);
  float ou = resample_px<T, kI8>(u, a.cw, i, j, a.row_c, a.col_c, a.inv_sc);
  float ov = resample_px<T, kI8>(v, a.cw, i, j, a.row_c, a.col_c, a.inv_sc);
  if (kI8) {
    oy = __fadd_rn(oy, a.off_y[i]);
    ou = __fadd_rn(ou, a.off_c[i]);
    ov = __fadd_rn(ov, a.off_c[i]);
  }
  store_rgb(a, f, i, j, oy, ou, ov);
}

// A block owns kBlockX output columns x kBlockY output rows of frame blockIdx.z,
// one pixel a thread; a warp is 32 neighbouring columns of one row, so its row
// record is one address and its stores are coalesced.  Word loads can pass the
// plane tensor's end only in the last frame, so only its blocks clamp them.
template <typename T, bool kI8, int kTaps>
__global__ void __launch_bounds__(kBlockX* kBlockY) ladder_kernel(const LadderArgs a) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int f = blockIdx.z;
  if (i >= a.out_h || j >= a.out_w) return;
  if constexpr (kTaps == 0)
    band_px<T, kI8>(a, f, i, j);
  else if (sizeof(T) == 1 && kTaps > 2 && f == a.n - 1)
    window_px<T, kI8, kTaps, true>(a, f, i, j);
  else
    window_px<T, kI8, kTaps, false>(a, f, i, j);
}

// x[a][b]: U (xu) and V (xv) of pair (a, b) of the kTaps x kTaps window of U,V
// pairs whose first pair is at p, in rows `pitch` pairs apart: one load a pair.
template <typename T, int kTaps>
__device__ __forceinline__ void load_pairs(const typename PairOf<T>::type* __restrict__ p,
                                           int pitch, uint32_t (&xu)[kTaps][kTaps],
                                           uint32_t (&xv)[kTaps][kTaps]) {
#pragma unroll
  for (int a = 0; a < kTaps; ++a) {
#pragma unroll
    for (int b = 0; b < kTaps; ++b) {
      const auto q = __ldg(p + a * pitch + b);
      xu[a][b] = q.x;
      xv[a][b] = q.y;
    }
  }
}

// K6/K7/K8 on the wire layout: frame f is h luma rows then h/2 rows of w/2 U,V
// pairs, blocks and threads as in ladder_kernel.  kTaps 2 or 4: the window
// records, whose chroma first column is a pair index; U and V come from one pair
// window and share its weights.  A luma word past a row's end lies in the
// frame's U,V rows, so no load needs a clamp.  kTaps 0: the band walk.  The
// column sums are scaled by `post` (1, or 1/64 for P010, whose samples sit in
// the high bits: the raw u16 value is what rounds to bf16, as on the TPU) before
// the int8 offsets and the epilogue.
template <typename T, bool kI8, int kTaps>
__global__ void __launch_bounds__(kBlockX* kBlockY) wire_kernel(const WireArgs a) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  const int f = blockIdx.z;
  if (i >= a.out_h || j >= a.out_w) return;
  const int luma = a.h * a.w;
  const T* const y = static_cast<const T*>(a.yuv) + (size_t)f * (luma + luma / 2);
  float oy, ou, ov, offy = 0.f, offc = 0.f;
  if constexpr (kTaps == 0) {
    oy = resample_px<T, kI8>(y, a.w, i, j, a.row_y, a.col_y, a.inv_sy);
    const float2 c = resample_uv_px<T, kI8>(y + luma, a.w, i, j, a.row_c, a.col_c,
                                            a.inv_sc);
    ou = c.x, ov = c.y;
    if (kI8) offy = a.off_y[i], offc = a.off_c[i];
  } else {
    constexpr bool kWords = sizeof(T) == 1 && kTaps > 2;  // as in window_px
    const Records<kI8, kTaps> r(a.rows, a.cols, a.out_w, i, j);
    const int pitch = a.w / 2;
    uint32_t xy[kTaps][kTaps], xu[kTaps][kTaps], xv[kTaps][kTaps];
    load_window<T, kTaps, kWords, false>(y + (r.w[0] * a.w + r.cy), a.w, 0, xy);
    load_pairs<T, kTaps>(reinterpret_cast<const typename PairOf<T>::type*>(y + luma) +
                             (r.w[1] * pitch + r.cc),
                         pitch, xu, xv);
    oy = r.template luma<T>(xy, a.inv_sy);
    ou = r.template chroma<T>(xu, a.inv_sc);
    ov = r.template chroma<T>(xv, a.inv_sc);
    if (kI8) offy = r.off_y(), offc = r.off_c();
  }
  oy = __fmul_rn(oy, a.post), ou = __fmul_rn(ou, a.post), ov = __fmul_rn(ov, a.post);
  if (kI8) {
    oy = __fadd_rn(oy, offy);
    ou = __fadd_rn(ou, offc);
    ov = __fadd_rn(ov, offc);
  }
  store_rgb(a, f, i, j, oy, ou, ov);
}

inline dim3 grid_of(int out_w, int out_h, int n) {
  return dim3((out_w + kBlockX - 1) / kBlockX, (out_h + kBlockY - 1) / kBlockY, n);
}

template <typename T, bool kI8>
int launch(const LadderArgs* a, void* stream) {
  if (a->n < 1 || a->n > 65535 || a->out_h < 1 || a->out_w < 1 ||
      (size_t)a->h * a->w > 0x7fffffff || (size_t)a->ch * a->cw > 0x7fffffff ||
      (size_t)a->out_h * a->out_w > 0x7fffffff)  // 32-bit offsets inside a frame
    return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY), grid = grid_of(a->out_w, a->out_h, a->n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->taps) {
    case 0: ladder_kernel<T, kI8, 0><<<grid, block, 0, s>>>(*a); break;
    case 2: ladder_kernel<T, kI8, 2><<<grid, block, 0, s>>>(*a); break;
    case 4: ladder_kernel<T, kI8, 4><<<grid, block, 0, s>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kI8>
int launch_wire(const WireArgs* a, void* stream) {
  if (a->n < 1 || a->n > 65535 || a->h < 2 || a->w < 2 || a->out_h < 1 ||
      a->out_w < 1 || ((size_t)a->h + a->h / 2) * a->w > 0x7fffffff ||
      (size_t)a->out_h * a->out_w > 0x7fffffff)  // 32-bit offsets inside a frame
    return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY), grid = grid_of(a->out_w, a->out_h, a->n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->taps) {
    case 0: wire_kernel<T, kI8, 0><<<grid, block, 0, s>>>(*a); break;
    case 2: wire_kernel<T, kI8, 2><<<grid, block, 0, s>>>(*a); break;
    case 4: wire_kernel<T, kI8, 4><<<grid, block, 0, s>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each entry launches on `stream`, does
// not synchronise, and returns cudaGetLastError() of its launch, or
// cudaErrorInvalidValue, without launching, for arguments it does not take.
extern "C" {
int gmat_ladder_i8(const LadderArgs* a, void* stream) {
  return launch<uint8_t, true>(a, stream);
}
int gmat_ladder_bf16_u8(const LadderArgs* a, void* stream) {
  return launch<uint8_t, false>(a, stream);
}
int gmat_ladder_bf16_u16(const LadderArgs* a, void* stream) {
  return launch<uint16_t, false>(a, stream);
}
int gmat_ladder_nv12(const WireArgs* a, void* stream) {
  return launch_wire<uint8_t, false>(a, stream);
}
int gmat_ladder_nv12_i8(const WireArgs* a, void* stream) {
  return launch_wire<uint8_t, true>(a, stream);
}
int gmat_ladder_p010(const WireArgs* a, void* stream) {
  return launch_wire<uint16_t, false>(a, stream);
}
// sizeof(LadderArgs) and sizeof(WireArgs), so the loader can check the ctypes
// mirrors' layouts.
size_t gmat_ladder_args_size() { return sizeof(LadderArgs); }
size_t gmat_wire_args_size() { return sizeof(WireArgs); }
const char* gmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
}
