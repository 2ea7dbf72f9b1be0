// Building blocks shared by the attention kernels (sm_90a): 16-byte
// cp.async loads of head rows into padded shared-memory tiles, ldmatrix
// fragment loads, mma.sync.m16n8k16 with fp32 accumulation and the register
// layouts that join them; warp reductions; the shared-memory opt-in.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major), 4 registers of two 16-bit values:
//     a0 (row g, cols 2t, 2t+1)   a1 (row g+8, cols 2t, 2t+1)
//     a2 (row g, cols 2t+8, +9)   a3 (row g+8, cols 2t+8, +9)
//   B (16 x 8, k x n), 2 registers: b0 (k 2t, 2t+1; n g), b1 (k 2t+8, +9; n g)
//   C (16 x 8 fp32), 4 floats: c0, c1 (row g, cols 2t, 2t+1),
//     c2, c3 (row g+8, cols 2t, 2t+1)
// So the C tiles of two neighbouring n-tiles of a product are, once packed
// in pairs, the A fragment of a product over that dimension: the
// probabilities and dS go from one mma to the next without shared memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace cc {

// shared-memory tiles keep 8 extra 16-bit columns per row: a row stride of
// (16 k + 8) halves spreads the 8 rows of one ldmatrix over all 32 banks
constexpr int kPad = 8;

__host__ __device__ inline int pad16(int x) { return (x + 15) & ~15; }

// opt-in shared memory one Hopper CTA may use (227 KB)
constexpr size_t kMaxSmem = 232448;

// Load stages of a persistent kernel whose CTA needs fixed + per_stage
// bytes per stage: 2 (the next item loads while this one computes) where
// they fit, else 1.
__host__ __device__ inline int n_stages(size_t fixed, size_t per_stage) {
  return fixed + 2 * per_stage <= kMaxSmem ? 2 : 1;
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// two floats rounded to T, the first in the low half (the lower column)
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// the two T values packed in x (low half first) as floats
template <typename T> __device__ __forceinline__ void unpack2(uint32_t x, float& lo, float& hi);
template <>
__device__ __forceinline__ void unpack2<__nv_bfloat16>(uint32_t x, float& lo, float& hi) {
  lo = __uint_as_float(x << 16);
  hi = __uint_as_float(x & 0xffff0000u);
}
template <>
__device__ __forceinline__ void unpack2<__half>(uint32_t x, float& lo, float& hi) {
  lo = __half2float(__ushort_as_half(static_cast<unsigned short>(x & 0xffffu)));
  hi = __half2float(__ushort_as_half(static_cast<unsigned short>(x >> 16)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// d += a . b over one m16n8k16 tile, fp32 accumulation
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane addresses of one ldmatrix.x4 over a tile stored row major with row
// stride ld (elements), whose 16 x 16 block starts at (r0, c0):
//   a_frag:  the A fragment of the block itself (rows = m, cols = k)
//   b_pair:  the B fragments of two n-tiles when the stored rows are n and
//            the columns k (K for q.K^T, V for dO.V^T): r[0..1] n-tile
//            r0..r0+7, r[2..3] n-tile r0+8..r0+15
//   trans_b_pair (with .trans): the B fragments of two n-tiles when the
//            stored rows are k and the columns n (V for P.V): r[0..1]
//            n-tile c0..c0+7, r[2..3] n-tile c0+8..c0+15
//   trans_a (with .trans): the A fragment of the transposed block, when
//            the stored rows are k and the columns m (P^T for dV)
template <typename T>
__device__ __forceinline__ const T* a_frag(const T* s, int ld, int r0, int c0, int lane) {
  return s + (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3);
}
template <typename T>
__device__ __forceinline__ const T* b_pair(const T* s, int ld, int r0, int c0, int lane) {
  return s + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 + (((lane >> 3) & 1) << 3);
}
template <typename T>
__device__ __forceinline__ const T* trans_b_pair(const T* s, int ld, int r0, int c0, int lane) {
  return s + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + c0 + ((lane >> 4) << 3);
}
template <typename T>
__device__ __forceinline__ const T* trans_a(const T* s, int ld, int r0, int c0, int lane) {
  return b_pair(s, ld, r0, c0, lane);
}

// Rows 0..rows-1 of one head (hd contiguous elements at src + i * stride)
// into dst[i * ld], by 16-byte cp.async; rows rows..rows_pad-1 are zeroed.
// The caller waits (cp_async_wait_all) and synchronises.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, size_t stride,
                                          int rows, int rows_pad, int hd) {
  const int per_row = hd / 8;
  for (int e = threadIdx.x; e < rows_pad * per_row; e += blockDim.x) {
    const int i = e / per_row, c = (e % per_row) * 8;
    if (i < rows)
      cp_async16(dst + i * ld + c, src + i * stride + c);
    else
      *reinterpret_cast<uint4*>(dst + i * ld + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// One warp's fp32 C tiles acc[nt] (rows r0..r0+15, n-tile columns
// c0 + 8 nt, nt < n_tiles) rounded to T (times `mul`) and written to
// dst[i * stride + c] for rows i < rows, through the warp's [16][72]
// staging tile, with 16-byte stores.
template <typename T, int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[NT][4], T* stage,
                                           T* dst, size_t stride, int r0, int rows,
                                           int c0, int n_tiles, float mul, int lane) {
  constexpr int ld = NT * 8 + kPad;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < n_tiles) {
      *reinterpret_cast<uint32_t*>(stage + g * ld + nt * 8 + 2 * t) =
          pack2<T>(acc[nt][0] * mul, acc[nt][1] * mul);
      *reinterpret_cast<uint32_t*>(stage + (g + 8) * ld + nt * 8 + 2 * t) =
          pack2<T>(acc[nt][2] * mul, acc[nt][3] * mul);
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * n_tiles; e += 32) {
    const int i = e / n_tiles, c = (e % n_tiles) * 8;
    if (r0 + i < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + i) * stride + c0 + c) =
          *reinterpret_cast<const uint4*>(stage + i * ld + c);
  }
  __syncwarp();
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Lets `kernel` use `smem` bytes of dynamic shared memory (above 48 KB a
// kernel must opt in); returns the cudaError_t.
inline int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// max / sum over the 4 lanes of a quad (the lanes holding one C row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------ tiles of long sequences
// The kernels for L > 128 never hold a whole head: they stream its rows
// through shared memory in tiles of 64 (16 rows per warp of a 4-warp CTA).
constexpr int kTile = 64;
// stages of the cp.async ring those tiles stream through
constexpr int kRing = 2;

// exp(x - m) for those kernels as 2^(x log2 e - m log2 e): one FMA and one
// ex2.approx (relative error ~2^-22, far under the 2^-8 of the bf16 P and
// dS operands it feeds), where expf takes about ten instructions.  `mlog`
// is m log2 e; exp2_scaled(-inf, mlog) = 0.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float exp2_scaled(float x, float mlog) {
  return ex2(fmaf(x, kLog2e, -mlog));
}

// Rows r0 .. r0 + 63 of one head (row i at base + i * stride) into dst,
// rows ld apart, by cp.async (not waited for): rows at or past L are zeroed
// up to the padded length Lp; rows past Lp are left alone (no product reads
// them).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* base, size_t stride,
                                          int r0, int L, int Lp, int hd) {
  load_rows(dst, ld, base + (size_t)r0 * stride, stride, min(kTile, L - r0),
            min(kTile, Lp - r0), hd);
}

// x * scale rounded to T in rows 0 .. rows-1 of a tile.  Each thread takes
// the 16-byte chunks its own load_rows / load_tile copied, so once its
// cp.async group has been waited for no barrier is needed before this.
template <typename T>
__device__ __forceinline__ void scale_rows(T* dst, int ld, int rows, int hd, float scale) {
  const int per_row = hd / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    uint32_t* p = reinterpret_cast<uint32_t*>(dst + (e / per_row) * ld + (e % per_row) * 8);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float lo, hi;
      unpack2<T>(p[k], lo, hi);
      p[k] = pack2<T>(lo * scale, hi * scale);
    }
  }
}

// c = A[arow .. arow+15] . B[0 .. 63]^T over hd channels for one warp (A
// and B row major, rows ld apart; fp32 accumulation).  The 16-row blocks of
// B at or past `brows` (the padded rows the tile has) are not computed and
// stay 0.
template <typename T>
__device__ __forceinline__ void tile_product(float (&c)[kTile / 8][4], const T* sa, int arow,
                                             const T* sb, int ld, int hd, int brows,
                                             int lane) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < hd; ks += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, a_frag(sa, ld, arow, ks, lane));
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      if (np * 16 < brows) {
        uint32_t b[4];
        ldmatrix_x4(b, b_pair(sb, ld, np * 16, ks, lane));
        mma16816<T>(c[2 * np], a, b[0], b[1]);
        mma16816<T>(c[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// The softmax's mask on a C tile of scores (query rows i0 .., keys k0 ..):
// keys at or past L are -inf; `mask` [L, L] (may be null) is added on rows
// before L.
__device__ __forceinline__ void mask_tile(float (&s)[kTile / 8][4], int i0, int k0, int L,
                                          const float* __restrict__ mask, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + (e >> 1) * 8, j = k0 + nt * 8 + 2 * t + (e & 1);
      if (j >= L)
        s[nt][e] = -INFINITY;
      else if (mask != nullptr && i < L)
        s[nt][e] += mask[(size_t)i * L + j];
    }
}

// Occupancy of a kernel launched with 4 warps and `smem` bytes of dynamic
// shared memory: out[0] registers per thread, out[1] shared-memory bytes
// per CTA, out[2] resident CTAs per SM.  Returns the cudaError_t.
inline int occupancy(const void* kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (!err) err = set_smem(kernel, smem);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, kernel, 128, smem);
  out[0] = attr.numRegs;
  out[1] = (int)smem;
  return err;
}

}  // namespace cc
