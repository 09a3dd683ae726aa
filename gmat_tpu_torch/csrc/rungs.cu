// Multi-rung ABR ladder kernels for Hopper (sm_90a):
//   4:2:0 u8 source (N, H, W) + 2x(N, H/2, W/2) -> for every rung (out_w, out_h)
//   its (N, oh, ow) + 2x(N, oh/2, ow/2) u8 planes, one launch for all rungs.
//
// Replaces (gmat_tpu/ops/pallas_kernels.py):
//   K4 _rungs_kernel_i8          (int8 row stage)           -> rungs_kernel<true>
//   K5 _rungs_kernel_i8_chunked  (K4-int8 over column chunks) -> the same kernel: it
//                                walks any width, so 4K sources need no chunked variant
//   K4 _rungs_kernel             (bf16 row stage)           -> rungs_kernel<false>
//
// Numerics kept from the TPU kernels (the plain PyTorch versions in ops/rungs.py
// repeat them), per plane of every rung:
//   int8: t = sum_h Ah_q[i,h] * (x[h,w] - 128)      exact, int32 (x ^ 0x80 as int8)
//         tb = bf16_rn(float(t) * inv_s)            one f32 multiply, then RNE to bf16
//         o = sum_w tb * bf16(Aw[w,j]) in f32, then + off[i] = 128*rowsum(Ah_q)/s once,
//         after the whole column sum (K5 adds it in its last-chunk store)
//   bf16: t = sum_h bf16(Ah[i,h]) * x[h,w] in f32 over all rows (no 512-row chunks,
//         unlike the ladder's K2); tb = bf16_rn(t); o = sum_w tb * bf16(Aw[w,j]) in f32
//   both: round half to even (__float2int_rn, as jnp.round and torch.round), clip to
//         0..255, store u8.
//   Chroma rungs resample the chroma plane (ch -> oh/2, cw -> ow/2); u and v share
//   those operands.  Every product of two bf16 values (or of bf16 and a u8 sample) is
//   exact in f32, and the sums use _rn intrinsics, so no multiply-add is contracted
//   into an FMA.
//
// What bounds it on this card: bytes.  A bilinear rung's matrices are bands of at
// most two taps, so the TPU's dense products are almost all multiplications by zero;
// the nonzero work of a 32 x 1080p batch into 720p/540p/360p is ~0.4 G-op, while
// reading the source once and writing every rung moves ~180 MB.
//
// What the design does about it (the simple form; see PERF.md for its cost): the host
// passes each resample matrix in band form (as for the ladder kernels: per output
// row or column the first input index with a nonzero weight, the window length, and
// the packed weights).  A flat job table covers every frame, rung and output sample:
// one thread computes one luma sample, or the u and v samples at one chroma position
// (they share the operands), walking its column window and recomputing the row-stage
// value over its row window.  Block y is the frame; block x walks the frame's jobs
// with a grid-stride loop, rung by rung, luma then chroma, so a warp covers
// neighbouring samples of one output row (coalesced stores, shared source rows).
// Each rung re-reads the source through L1/L2; reading the source once for all rungs
// (shared-memory staging of the touched rows) and vector loads are later work.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Band form of one resample matrix, one entry per output index.  The same layout
// as Band in ladder.cu; both are mirrored by _Band in gmat_tpu_torch/ops/ladder.py.
struct Band {
  const int32_t* lo;   // first input index of the window
  const int32_t* len;  // window length (0: the row is all zeros)
  const void* wts;     // (count, stride) window weights: int8 (int8 rows) or bf16
  int32_t stride;
};

// One rung's outputs and operands.  Mirrored by _Rung in gmat_tpu_torch/ops/rungs.py.
struct Rung {
  uint8_t* y;            // (n, out_h, out_w)
  uint8_t* u;            // (n, out_h / 2, out_w / 2)
  uint8_t* v;
  Band row_y, col_y, row_c, col_c;
  const float* off_y;    // int8 only: 128 * rowsum(Ah_q) / s per output row
  const float* off_c;
  int32_t out_h, out_w;
  float inv_sy, inv_sc;  // int8 only: f32(1 / s)
};

constexpr int kMaxRungs = 8;  // rungs per launch; the wrapper splits longer ladders

// Mirrored field for field by _RungsArgs in gmat_tpu_torch/ops/rungs.py.
struct RungsArgs {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
  int32_t n, h, w, ch, cw, n_rungs;
  Rung rung[kMaxRungs];
};

namespace {

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Resampled value of one plane at output sample (i, j), before the offset.
template <bool kI8>
__device__ __forceinline__ float resample_px(const uint8_t* __restrict__ x, int width,
                                             int i, int j, const Band& row,
                                             const Band& col, float inv_s) {
  const int h0 = row.lo[i], nh = row.len[i];
  const int w0 = col.lo[j], nw = col.len[j];
  const __nv_bfloat16* cwt =
      static_cast<const __nv_bfloat16*>(col.wts) + (size_t)j * col.stride;
  const uint8_t* base = x + (size_t)h0 * width + w0;
  float acc = 0.f;
  for (int b = 0; b < nw; ++b) {
    const uint8_t* px = base + b;
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
                                   (float)__ldg(px + (size_t)a * width)));
      tb = bf16_rn(t);
    }
    acc = __fadd_rn(acc, __fmul_rn(tb, __bfloat162float(cwt[b])));
  }
  return acc;
}

__device__ __forceinline__ uint8_t to_u8(float o) {
  const int q = __float2int_rn(o);  // round half to even
  return (uint8_t)min(max(q, 0), 255);
}

// Jobs of one rung in one frame: its luma samples, then its chroma positions.
__device__ __forceinline__ int rung_jobs(const Rung& g) {
  return g.out_h * g.out_w + (g.out_h / 2) * (g.out_w / 2);
}

template <bool kI8>
__global__ void __launch_bounds__(256) rungs_kernel(const __grid_constant__ RungsArgs a) {
  const int f = blockIdx.y;
  int per_frame = 0;
  for (int r = 0; r < a.n_rungs; ++r) per_frame += rung_jobs(a.rung[r]);
  const uint8_t* y = a.y + (size_t)f * a.h * a.w;
  const uint8_t* u = a.u + (size_t)f * a.ch * a.cw;
  const uint8_t* v = a.v + (size_t)f * a.ch * a.cw;
  for (int job = blockIdx.x * blockDim.x + threadIdx.x; job < per_frame;
       job += gridDim.x * blockDim.x) {
    int r = 0, rem = job;
    while (rem >= rung_jobs(a.rung[r])) rem -= rung_jobs(a.rung[r++]);
    const Rung& g = a.rung[r];
    const int luma = g.out_h * g.out_w;
    if (rem < luma) {
      const int i = rem / g.out_w, j = rem - i * g.out_w;
      float o = resample_px<kI8>(y, a.w, i, j, g.row_y, g.col_y, g.inv_sy);
      if (kI8) o = __fadd_rn(o, g.off_y[i]);
      g.y[(size_t)f * luma + rem] = to_u8(o);
    } else {
      rem -= luma;
      const int cow = g.out_w / 2, plane = (g.out_h / 2) * cow;
      const int i = rem / cow, j = rem - i * cow;
      float ou = resample_px<kI8>(u, a.cw, i, j, g.row_c, g.col_c, g.inv_sc);
      float ov = resample_px<kI8>(v, a.cw, i, j, g.row_c, g.col_c, g.inv_sc);
      if (kI8) {
        ou = __fadd_rn(ou, g.off_c[i]);
        ov = __fadd_rn(ov, g.off_c[i]);
      }
      g.u[(size_t)f * plane + rem] = to_u8(ou);
      g.v[(size_t)f * plane + rem] = to_u8(ov);
    }
  }
}

template <bool kI8>
int launch(const RungsArgs* a, void* stream) {
  if (a->n_rungs < 1 || a->n_rungs > kMaxRungs || a->n < 1 || a->n > 65535)
    return (int)cudaErrorInvalidValue;
  long long per_frame = 0;
  for (int r = 0; r < a->n_rungs; ++r)
    per_frame += (long long)a->rung[r].out_h * a->rung[r].out_w +
                 (long long)(a->rung[r].out_h / 2) * (a->rung[r].out_w / 2);
  if (per_frame >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  // enough blocks to fill the card many times over; the loop covers the rest
  const long long blocks = (per_frame + 255) / 256;
  const dim3 grid((unsigned)(blocks < 4096 ? blocks : 4096), a->n);
  rungs_kernel<kI8><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each entry launches on `stream`, does
// not synchronise, and returns cudaGetLastError() of its launch (or
// cudaErrorInvalidValue for arguments it does not take, without launching).
extern "C" {
int gmat_rungs_i8(const RungsArgs* a, void* stream) { return launch<true>(a, stream); }
int gmat_rungs_bf16(const RungsArgs* a, void* stream) { return launch<false>(a, stream); }
// sizeof(RungsArgs), so the loader can check the ctypes mirror's layout.
size_t gmat_rungs_args_size() { return sizeof(RungsArgs); }
}
