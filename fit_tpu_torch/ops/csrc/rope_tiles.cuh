// Tile helpers shared by the RoPE-attention forward (rope_attention.cu) and
// backward (rope_attention_bwd.cu): 16-byte vector moves, the rotated tile
// load from a row-strided matrix (the (B, T, 3C) qkv projection, or one
// head of any (B, T, H, d) view), and the cp.async, ldmatrix and mma.sync
// wrappers of the fp32 forward and of both backward kernels.
//
// Those kernels' blocks have 4 warps and work on 64-row tiles; each warp
// owns 16 rows.
// Tiles hold a head dim padded to DP (a multiple of 16) in shared memory;
// padded columns and rows past the valid range are zero.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per inner-loop tile (== kBlockQ: tile loaders are shared)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16: one mma row tile per warp

// The q/k/v tiles' shared-memory row stride for a head dim padded to DP:
// DP + 8 elements, so that consecutive rows start on different banks.
template <typename T, int DP>
struct Strides {
  static constexpr int kTile = DP + 8;
};

using bf16 = __nv_bfloat16;

// 8 consecutive elements <-> 8 floats, as 16-byte vectors (the pointer is
// 16-byte aligned: d and every column offset are multiples of 8 elements).
__device__ __forceinline__ void load8(float (&o)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(float (&o)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    o[2 * j] = f.x;
    o[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&o)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float (&o)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Rows [row0, row0 + 64) of one head's q or k block (columns col0..col0+d),
// rotated pair by pair and multiplied by `mul`, into a (64, DP) tile with
// row stride Strides::kTile. Rows at or past `valid` and columns at or past d
// are zero. With ROPE false the rotation is skipped (cos_b and sin_b are not
// read): the rows are only multiplied by `mul`.
template <typename T, int DP, bool ROPE = true>
__device__ __forceinline__ void load_rotated(T* dst, const T* src, const float* cos_b,
                                             const float* sin_b, int64_t row_stride, int col0,
                                             int row0, int valid, int d, float mul) {
  constexpr int kChunksPerRow = DP / 8;
  static_assert((kBlockQ * kChunksPerRow) % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < kBlockQ * kChunksPerRow / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunksPerRow;
    const int c = (i % kChunksPerRow) * 8;
    const int row = row0 + r;
    float o[8];
    if (row < valid && c < d) {
      float x[8];
      load8(x, src + row * row_stride + col0 + c);
      if constexpr (ROPE) {
        float cs[8], sn[8];
        const int64_t t = static_cast<int64_t>(row) * d + c;
        load8(cs, cos_b + t);
        load8(sn, sin_b + t);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          o[j] = (x[j] * cs[j] - x[j + 1] * sn[j]) * mul;
          o[j + 1] = (x[j + 1] * cs[j + 1] + x[j] * sn[j + 1]) * mul;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = x[j] * mul;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = 0.f;
    }
    store8(dst + r * Strides<T, DP>::kTile + c, o);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1: the first src_bytes (0 to 16)
// are read and the rest zero-filled (src must be a valid address even when
// nothing is read).
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// 16 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  cp_async16_n(dst, src, valid ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (ex2.approx, relative error ~2^-22;
// -inf gives 0, and results below 2^-126 flush to 0, far under P's bf16
// rounding). exp2f adds range handling that costs registers and, at DP 80
// with RoPE, a spill.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a bf16 pair, the first in the low half (the lower column of
// an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A 64-row tile of (64, DP) shared memory, row stride DP + 8, filled by
// cp.async from rows [row0, row0 + 64) of a row-strided (B, T, H, d) head;
// rows at or past `valid` and columns at or past d are zero-filled.
template <int DP>
__device__ __forceinline__ void async_tile(bf16* dst, const bf16* src, int64_t row_stride, int row0,
                                           int valid, int d) {
  constexpr int kChunks = DP / 8;
  constexpr int kTile = Strides<bf16, DP>::kTile;
#pragma unroll
  for (int it = 0; it < kBlockK * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < valid && c < d;
    cp_async16(smem_u32(dst + r * kTile + c), ok ? src + row * row_stride + c : src, ok);
  }
}

// Element strides of one (B, T, H, d) operand; the head dim is contiguous.
struct Layout {
  int64_t b, t, h;
};

}  // namespace
