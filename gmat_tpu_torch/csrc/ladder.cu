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
  const float yy = __fsub_rn(oy, a.low);
  const float uu = __fsub_rn(ou, a.mid);
  const float vv = __fsub_rn(ov, a.mid);
  const size_t plane = (size_t)a.out_h * a.out_w;
  float* o = a.out + f * 3 * plane + (size_t)i * a.out_w + j;
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
int launch(const LadderArgs* a, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((a->out_w + 31) / 32, (a->out_h + 7) / 8, a->n);
  ladder_kernel<T, kI8><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
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
// sizeof(LadderArgs), so the loader can check the ctypes mirror's layout.
size_t gmat_ladder_args_size() { return sizeof(LadderArgs); }
const char* gmat_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
}
