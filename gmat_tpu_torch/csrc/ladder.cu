// Fused preprocess ladder kernels for Hopper (sm_90a):
//   4:2:0 / 4:4:4 YUV planes -> resample -> 3x3 CSC -> clip -> (x - shift) / norm
//   -> (N, 3, out_h, out_w) f32 NCHW, one launch per batch.
//
// Replaces (gmat_tpu/ops/pallas_kernels.py):
//   K1 _ladder_kernel_i8          (int8 row stage)        -> ladder_kernel<uint8_t, true>
//   K3 _ladder_kernel_i8_chunked  (K1 over column chunks) -> the same kernel: it walks
//                                 any width, so 8K frames need no chunked variant
//   K2 _ladder_kernel             (bf16 row stage, u8 or lsb-aligned u16 samples)
//                                 -> ladder_kernel<uint8_t|uint16_t, false>
//   K6 _ladder_nv12_kernel        (NV12 wire, bf16 rows)  -> wire_kernel<uint8_t, false>
//   K7 _ladder_nv12_kernel_i8     (NV12 wire, int8 rows)  -> wire_kernel<uint8_t, true>
//   K8 _ladder_p010_kernel        (P010 wire, bf16 rows)  -> wire_kernel<uint16_t, false>
//
// The wire kernels read (N, 3H/2, W): luma rows, then interleaved U,V rows.  The
// TPU kernels deinterleave with zero-padded (W, out_w) column matrices (U at even
// columns, V at odd); here the planar chroma band (W/2 inputs) is walked over U,V
// pairs, one 2-sample load per pair, which sums the same nonzero terms without
// walking the zeros.  K6's row stage sums luma over 512-row chunks and chroma over
// half as many; K8 in one chunk; these kernels, like K2's, sum each band window
// in one f32 loop (the plain versions repeat the chunks: <= 1 u8-LSB apart).
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
// Later work: stage the touched rows in shared memory with cp.async / TMA, and put
// the int8 row stage on the tensor cores for wide (area, smoothed) bands.

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
  Band row_y, col_y, row_c, col_c;
  const float* off_y;  // K1 only: 128 * rowsum(Ah_q) / s per output row
  const float* off_c;
  int32_t n, h, w, ch, cw, out_h, out_w;
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
  int32_t n, h, w, out_h, out_w;
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

// Epilogue of every ladder kernel on offset-free planes: 3x3 matrix, clip
// [0, maxv], (c - shift[c]) * inv_norm, three stores `plane` floats apart.
template <typename Args>
__device__ __forceinline__ void store_rgb(const Args& a, float* o, size_t plane,
                                          float yy, float uu, float vv) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = __fadd_rn(__fadd_rn(__fmul_rn(a.mat[3 * c], yy),
                                  __fmul_rn(a.mat[3 * c + 1], uu)),
                        __fmul_rn(a.mat[3 * c + 2], vv));
    s = fminf(fmaxf(s, 0.f), a.maxv);
    o[c * plane] = __fmul_rn(__fsub_rn(s, a.shift[c]), a.inv_norm);
  }
}

template <typename T, bool kI8>
__global__ void __launch_bounds__(256) ladder_kernel(const LadderArgs a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int f = blockIdx.z;
  if (i >= a.out_h || j >= a.out_w) return;
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
  const size_t plane = (size_t)a.out_h * a.out_w;
  store_rgb(a, a.out + f * 3 * plane + (size_t)i * a.out_w + j, plane,
            __fsub_rn(oy, a.low), __fsub_rn(ou, a.mid), __fsub_rn(ov, a.mid));
}

// K6/K7/K8 on the wire layout: frame f is h luma rows then h/2 rows of U,V
// pairs, w samples a row.  The column sums are scaled by `post` (1, or 1/64 for
// P010, whose samples sit in the high bits: the raw u16 value is what rounds to
// bf16, as on the TPU) before the int8 offsets and the epilogue.
template <typename T, bool kI8>
__global__ void __launch_bounds__(256) wire_kernel(const WireArgs a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int f = blockIdx.z;
  if (i >= a.out_h || j >= a.out_w) return;
  const T* y = static_cast<const T*>(a.yuv) + (size_t)f * (a.h + a.h / 2) * a.w;
  const T* uv = y + (size_t)a.h * a.w;
  float oy = __fmul_rn(resample_px<T, kI8>(y, a.w, i, j, a.row_y, a.col_y, a.inv_sy),
                       a.post);
  const float2 c = resample_uv_px<T, kI8>(uv, a.w, i, j, a.row_c, a.col_c, a.inv_sc);
  float ou = __fmul_rn(c.x, a.post), ov = __fmul_rn(c.y, a.post);
  if (kI8) {
    oy = __fadd_rn(oy, a.off_y[i]);
    ou = __fadd_rn(ou, a.off_c[i]);
    ov = __fadd_rn(ov, a.off_c[i]);
  }
  const size_t plane = (size_t)a.out_h * a.out_w;
  store_rgb(a, a.out + f * 3 * plane + (size_t)i * a.out_w + j, plane,
            __fsub_rn(oy, a.low), __fsub_rn(ou, a.mid), __fsub_rn(ov, a.mid));
}

template <typename T, bool kI8>
int launch(const LadderArgs* a, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((a->out_w + 31) / 32, (a->out_h + 7) / 8, a->n);
  ladder_kernel<T, kI8><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

template <typename T, bool kI8>
int launch_wire(const WireArgs* a, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((a->out_w + 31) / 32, (a->out_h + 7) / 8, a->n);
  wire_kernel<T, kI8><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each entry launches on `stream`, does
// not synchronise, and returns cudaGetLastError() of its launch.
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
