// Multi-rung ABR ladder kernels for Hopper (sm_90a):
//   4:2:0 u8 source (N, H, W) + 2x(N, H/2, W/2) -> for every rung (out_w, out_h)
//   its (N, oh, ow) + 2x(N, oh/2, ow/2) u8 planes, one launch for all rungs.
//
// Replaces (gmat_tpu/ops/pallas_kernels.py):
//   :876 K4 _rungs_kernel_i8          (int8 row stage)            -> rungs_kernel<true>
//   :907 K5 _rungs_kernel_i8_chunked  (K4-int8 over column chunks) -> the same kernel: it
//        tiles any width, so 4K sources need no chunked variant
//   :845 K4 _rungs_kernel             (bf16 row stage)            -> rungs_kernel<false>
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
//   exact in f32 and the sums use _rn intrinsics in tap order, so no multiply-add is
//   contracted into an FMA.  Bilinear and nearest bands have at most two taps; the
//   host pads every band to two, and a zero weight adds an exact zero.
//
// What bounds it on this card: bytes.  A 32 x 1080p batch into 720p/540p/360p reads
// the 99.5 MB source once and writes 80.2 MB of rungs: ~180 MB, 54 us at 3.35 TB/s.
// Its nonzero work is ~0.8 G multiply-adds, ~0.4 us at the int8 tensor-core rate, and
// a band of two taps per axis gives a tensor core nothing to do but multiply zeros:
// wgmma has no part here.  What the card has to spend is instructions per output.
//
// The design.  Times are per 32 x 1080p batch (bf16 / int8 rows) and per 8 x 4K batch
// (int8), from chip_smoke.py on an H100 80GB HBM3 at 700 W; PERF.md keeps the runs.
//  0. It replaced a flat job table: one thread per output sample that searched its
//     rung, divided its index, loaded its band metadata from global memory and
//     recomputed the row stage once per column tap (0.904 / 0.914, 4K 0.460 ms).
//  1. Tiles.  A block computes a th x tw tile of output samples of one plane of
//     one rung of one frame (luma, or the chroma position shared by u and v).
//     The host picks the tile per plane (32 x 256 first, halved until the block's
//     row-stage values fit 40 KB of shared memory) and uploads once per geometry a
//     record per tile (its tile row and column, and the source window
//     [r0, r0+nr) x [c0, c0+nc) it reads) and the padded band operands of every
//     tile row and tile column as aligned records.  blockIdx.y is the frame;
//     blockIdx.x walks the frame's tiles rung by rung, luma then chroma
//     (RungsArgs.tile0), so the rungs re-read a 3.1 MB frame from the 50 MB L2 and
//     the source crosses HBM about once.
//  2. Operands from the records: a thread's column-stage items share one group of
//     kOut columns, so it loads their first taps and weights (three 16-byte loads)
//     once, before the row stage; the row stage reads each output row's record
//     through L1.
//  3. The source window is read through L1, not staged.  A first version staged
//     it in shared memory with 16-byte cp.async, one tile per block (0.359 / 0.364,
//     4K 0.263 ms); a persistent grid that double-buffered those copies was slower
//     still (0.439 / 0.476, 4K 0.341 ms): a few blocks per SM with one ~8 KB window
//     in flight each keep too few bytes in flight to cover the memory latency, and
//     the staging added a barrier per tile.  Read directly, every warp's loads are
//     in flight at once and a block has one barrier.
//  4. The row stage runs once per (output row, source column) of the window, in
//     items of kGroup = 16 columns: per tap row five aligned 32-bit loads and four
//     funnel shifts, so no width or pointer has to be aligned (a block whose words
//     could reach past either end of the plane tensor takes a loop that clamps
//     them).  int8 rows sum both taps in one 16 x 8-bit dot product (__dp2a);
//     bf16 rows take the second tap as an FMA, which rounds as __fadd_rn does
//     because both products are exact.  It writes bf16_rn(t) to shared memory.
//  5. The column stage computes kOut = 4 neighbouring outputs of one row per
//     thread item from the row-stage values, for u and v together on a chroma
//     tile, rounds and clips each with one saturating convert, and stores the four
//     as one 4-byte word where the address allows.
//  With 2-4 and the 32 x 256 tile: 0.169 / 0.172 ms, 4K 0.131 ms, 31-32% of the
//  bound, 48 registers and no spills; what is left is issue (~11 instructions per
//  row-stage value, ~18 per output sample) and the barrier's idle warps.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kMaxRungs = 8;   // rungs per launch; the wrapper splits longer ladders
constexpr int kThreads = 256;  // threads per block
constexpr int kOut = 4;        // column stage: output samples per thread item
constexpr int kGroup = 16;     // row stage: source columns per thread item

// One plane of one rung (luma at even slots, the u/v pair at odd slots) and its
// tiling.  Mirrored by _RungPlane in gmat_tpu_torch/ops/rungs.py.
struct RungPlane {
  uint8_t* out[2];        // (n, out_h, out_w) outputs: y, or u and v
  const int32_t* rows;    // (tiles_y, 4, th): per output row its first tap's source
                          // row, two weights (int8 values, or f32 bits) and the
                          // int8 offset (f32 bits); zero weights past out_h
  const int32_t* cols;    // (tiles_x, 3, tw): first tap's source column, two weights
                          // (f32 bits); zero weights past out_w
  const int4* tiles;      // (tiles_y * tiles_x): ty, tx, r0 | nr << 16, c0 | nc << 16
  int32_t out_h, out_w;   // this plane's output size
  int32_t th, tw;         // tile: output rows x columns (tw a power of two, kOut to
                          // kOut * kThreads)
  int32_t tpitch;         // bf16 per row-stage row (multiple of kGroup)
  float inv_s;            // int8 only: f32(1 / s)
};

// Mirrored field for field by _RungsArgs in gmat_tpu_torch/ops/rungs.py.
struct RungsArgs {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
  int32_t n, h, w, ch, cw, n_rungs;
  int32_t tile0[2 * kMaxRungs + 1];  // first tile of each plane within a frame
  RungPlane plane[2 * kMaxRungs];
};

namespace {

// Shared memory of plane p's row-stage values (`planes` source planes).
__host__ __device__ inline size_t tvals_bytes(const RungPlane& p, int planes) {
  return (size_t)planes * p.th * p.tpitch * 2;
}

// f32 value of byte k of x, exactly: 2^23 + x_k as a float, minus 2^23.  `magic`
// is 0x4B000000, passed in a register so that the byte selector is the immediate.
__device__ __forceinline__ float u8f(uint32_t x, uint32_t magic, int k) {
  return __fsub_rn(__int_as_float(__byte_perm(x, magic, 0x7440 | k)), 8388608.f);
}

// f32 value of an integer |t| < 2^22, exactly (as __int2float_rn)
__device__ __forceinline__ float i2f(int t) {
  return __fsub_rn(__int_as_float(0x4B400000 + t), 12582912.f);
}

__device__ __forceinline__ float bf16_bits(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

// round half to even, clip to 0..255
__device__ __forceinline__ uint32_t to_u8(float o) {
#ifdef __CUDA_ARCH__
  uint32_t q;
  asm("cvt.rni.sat.u8.f32 %0, %1;" : "=r"(q) : "f"(o));
  return q;
#else
  return (uint32_t)min(max(__float2int_rn(o), 0), 255);
#endif
}

// One output sample from a row-stage row: two taps, the offset after the sum.  Both
// products are exact in f32, so an FMA of the second rounds as __fadd_rn does.
template <bool kI8>
__device__ __forceinline__ uint32_t col_px(const uint16_t* tr, int lo, float w0, float w1,
                                           float off) {
  float o = __fmaf_rn(bf16_bits(tr[lo + 1]), w1, __fmul_rn(bf16_bits(tr[lo]), w0));
  if (kI8) o = __fadd_rn(o, off);
  return to_u8(o);
}

// Row stage of one tile: once per (output row, source column) of the window, in
// items of kGroup columns; bf16_rn(t) into s_t.  kGuard clamps every word into
// [wlo, whi], for tiles whose words could lie outside the plane tensor.
template <bool kI8, bool kGuard>
__device__ __forceinline__ void row_stage(const uint8_t* const (&win)[2],
                                          const int32_t* rows, uint16_t* s_t, int planes,
                                          int th, int ng, int pth, int tpitch,
                                          uint32_t width, int r0, float inv_s,
                                          uint32_t magic, const uintptr_t (&wlo)[2],
                                          const uintptr_t (&whi)[2]) {
  const float inv_ng = 1.f / (float)ng;
  for (int k = threadIdx.x; k < planes * th * ng; k += kThreads) {
    // k / ng by a float reciprocal, corrected by one either way (k < 2^24)
    int row = (int)((float)k * inv_ng), c = k - row * ng;
    if (c < 0) --row, c += ng;
    if (c >= ng) ++row, c -= ng;
    const int pl = row >= th, i = row - pl * th;
    const uint32_t k0 = (uint32_t)(__ldg(rows + i) - r0);
    const int rw0 = __ldg(rows + pth + i), rw1 = __ldg(rows + 2 * pth + i);
    // the item's 16 bytes of each tap row, from five aligned 32-bit words
    uint32_t x[2][4];
#pragma unroll
    for (int tap = 0; tap < 2; ++tap) {
      const uintptr_t at = (uintptr_t)(win[pl] + ((k0 + tap) * width + kGroup * c));
      uintptr_t q = at & ~(uintptr_t)3;
      uint32_t v[5];
#pragma unroll
      for (int e = 0; e < 5; ++e) {
        uintptr_t qe = q + 4 * e;
        if (kGuard) qe = qe < wlo[pl] ? wlo[pl] : qe > whi[pl] ? whi[pl] : qe;
        v[e] = __ldg(reinterpret_cast<const uint32_t*>(qe));
      }
      const int sh = 8 * (int)(at & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[tap][e] = __funnelshift_r(v[e], v[e + 1], sh);
    }
    uint32_t packed[kGroup / 2];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v[4];
      if (kI8) {
        // two taps in one 16x8-bit dot product: weights (w0, w1) against the
        // bytes of both rows interleaved, each byte x ^ 0x80 = x - 128 as int8
        const int wpair = (rw0 & 0xffff) | (rw1 << 16);
        const int lo = (int)(__byte_perm(x[0][e], x[1][e], 0x5140) ^ 0x80808080u);
        const int hi = (int)(__byte_perm(x[0][e], x[1][e], 0x7362) ^ 0x80808080u);
        v[0] = __fmul_rn(i2f(__dp2a_lo(wpair, lo, 0)), inv_s);
        v[1] = __fmul_rn(i2f(__dp2a_hi(wpair, lo, 0)), inv_s);
        v[2] = __fmul_rn(i2f(__dp2a_lo(wpair, hi, 0)), inv_s);
        v[3] = __fmul_rn(i2f(__dp2a_hi(wpair, hi, 0)), inv_s);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          v[b] = __fmaf_rn(__int_as_float(rw1), u8f(x[1][e], magic, b),
                           __fmul_rn(__int_as_float(rw0), u8f(x[0][e], magic, b)));
      }
      __nv_bfloat162 b0 = __floats2bfloat162_rn(v[0], v[1]);
      __nv_bfloat162 b1 = __floats2bfloat162_rn(v[2], v[3]);
      packed[2 * e] = *reinterpret_cast<const uint32_t*>(&b0);
      packed[2 * e + 1] = *reinterpret_cast<const uint32_t*>(&b1);
    }
    uint4* dst = reinterpret_cast<uint4*>(s_t + (size_t)row * tpitch + kGroup * c);
    dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
}

template <bool kI8>
__global__ void __launch_bounds__(kThreads) rungs_kernel(const __grid_constant__ RungsArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* const s_t = reinterpret_cast<uint16_t*>(smem);

  // the block's plane and tile
  int t = blockIdx.x, pi = 0;
  while (t >= a.tile0[pi + 1]) ++pi;
  const RungPlane& p = a.plane[pi];
  const int4 rec = __ldg(p.tiles + (t - a.tile0[pi]));
  const int f = blockIdx.y;
  const bool chroma = pi & 1;
  const int planes = chroma ? 2 : 1;
  const int height = chroma ? a.ch : a.h, width = chroma ? a.cw : a.w;
  const int i0 = rec.x * p.th, j0 = rec.y * p.tw;
  const int th = min(p.th, p.out_h - i0), tw = min(p.tw, p.out_w - j0);
  const int r0 = rec.z & 0xffff, nr = (int)((uint32_t)rec.z >> 16);
  const int c0 = rec.w & 0xffff, nc = (int)((uint32_t)rec.w >> 16);
  const int ng = (nc + kGroup) / kGroup;  // the window's columns and the one after it
  if (ng * kGroup > p.tpitch) __trap();
  const int32_t* rows = p.rows + (size_t)rec.x * 4 * p.th;
  const int32_t* cols = p.cols + (size_t)rec.y * 3 * p.tw;

  // 2. this thread's column-stage operands (p.tw / kOut divides kThreads, so every
  // item of the thread has the same kOut columns), loaded before the row stage
  const int qbits = __ffs(p.tw / kOut) - 1;
  const int j = (threadIdx.x & ((1 << qbits) - 1)) * kOut;
  int4 lo = __ldg(reinterpret_cast<const int4*>(cols + j));
  const float4 w0 = __ldg(reinterpret_cast<const float4*>(cols + p.tw + j));
  const float4 w1 = __ldg(reinterpret_cast<const float4*>(cols + 2 * p.tw + j));
  lo.x -= c0, lo.y -= c0, lo.z -= c0, lo.w -= c0;

  // 3. row stage over each source plane's window (a luma tile reads only the
  // first); a block whose words could lie outside the plane tensor clamps them
  const uint8_t* const src0 = chroma ? a.u : a.y;
  const size_t first = ((size_t)f * height + r0) * width + c0;  // window's first byte
  const size_t plane_bytes = (size_t)a.n * height * width;
  const uint8_t* const win[2] = {src0 + first, a.v + first};
  const uintptr_t wlo[2] = {(uintptr_t)src0 & ~(uintptr_t)3,
                            (uintptr_t)a.v & ~(uintptr_t)3};
  const uintptr_t whi[2] = {((uintptr_t)src0 + plane_bytes - 1) & ~(uintptr_t)3,
                            ((uintptr_t)a.v + plane_bytes - 1) & ~(uintptr_t)3};
  const uint32_t magic = 0x4B000000u | ((uint32_t)a.n >> 31);  // n >= 1: 0x4B000000
  if (first < 4 || first + ((size_t)nr + 1) * width + kGroup * ng + 16 > plane_bytes)
    row_stage<kI8, true>(win, rows, s_t, planes, th, ng, p.th, p.tpitch, width, r0,
                         p.inv_s, magic, wlo, whi);
  else
    row_stage<kI8, false>(win, rows, s_t, planes, th, ng, p.th, p.tpitch, width, r0,
                          p.inv_s, magic, wlo, whi);
  __syncthreads();

  // 4. column stage: kOut outputs of one row per item, u and v together.  A thread's
  // items share their columns, so the row-stage offsets, the output pointers and
  // whether a 4-byte store is aligned are set once
  if (j >= tw) return;
  const size_t out0 = ((size_t)f * p.out_h + i0) * p.out_w + j0 + j;
  uint8_t* const dst0 = p.out[0] + out0;
  uint8_t* const dst1 = chroma ? p.out[1] + out0 : dst0;
  const bool word =
      j + kOut <= tw && ((p.out_w | (int)(uintptr_t)dst0 | (int)(uintptr_t)dst1) & 3) == 0;
  const uint16_t* const t0 = s_t;
  const uint16_t* const t1 = s_t + (size_t)th * p.tpitch;
  for (int k = threadIdx.x; k < (th << qbits); k += kThreads) {
    const int i = k >> qbits;
    const float off = kI8 ? __int_as_float(__ldg(rows + 3 * p.th + i)) : 0.f;
    const size_t at = (size_t)i * p.out_w;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      if (pl == planes) break;
      const uint16_t* tr = (pl ? t1 : t0) + i * p.tpitch;
      const uint32_t q = col_px<kI8>(tr, lo.x, w0.x, w1.x, off) |
                         col_px<kI8>(tr, lo.y, w0.y, w1.y, off) << 8 |
                         col_px<kI8>(tr, lo.z, w0.z, w1.z, off) << 16 |
                         col_px<kI8>(tr, lo.w, w0.w, w1.w, off) << 24;
      uint8_t* dst = (pl ? dst1 : dst0) + at;
      if (word) {
        *reinterpret_cast<uint32_t*>(dst) = q;
      } else {
        for (int e = 0; e < kOut && j + e < tw; ++e) dst[e] = (uint8_t)(q >> (8 * e));
      }
    }
  }
}

template <bool kI8>
int launch(const RungsArgs* a, void* stream) {
  if (a->n_rungs < 1 || a->n_rungs > kMaxRungs || a->n < 1 || a->n > 65535 ||
      a->tile0[0] != 0 || a->h > 65535 || a->w > 65535)
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  for (int pi = 0; pi < 2 * a->n_rungs; ++pi) {
    const RungPlane& p = a->plane[pi];
    if (p.th < 1 || p.tw < kOut || p.tw > kOut * kThreads || (p.tw & (p.tw - 1)) ||
        p.tpitch % kGroup || a->tile0[pi + 1] <= a->tile0[pi])
      return (int)cudaErrorInvalidValue;
    const size_t s = tvals_bytes(p, 1 + (pi & 1));
    smem = s > smem ? s : smem;
  }
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rungs_kernel<kI8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)a->tile0[2 * a->n_rungs], (unsigned)a->n);
  rungs_kernel<kI8><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*a);
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
