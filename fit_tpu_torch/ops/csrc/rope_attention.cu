// Fused 2D-RoPE + prefix-masked attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels fit_tpu/ops/fused_attention.py::_qkv_kernel
// (natural (B, T, 3C) layout) and ::_kernel (head-major layout). Both compute
//
//   q_rot = q*cos + rot(q)*sin,  k_rot = k*cos + rot(k)*sin,  rot(a, b) = (-b, a)
//   out   = softmax over valid keys (q_rot k_rot^T * scale) v
//
// for every query row, padded rows included, so no row is ever all -inf.
//
// Layout: q, k and v are read by stride straight from the (B, T, 3C) qkv
// projection (q at column h*d, k at C + h*d, v at 2C + h*d); cos/sin are the
// pair-duplicated fp32 (B, T, d) tables; lengths is (B,) int32; the output is
// (B, T, C) in the input dtype, ready for the out-projection. The head dim d
// is a multiple of 8 (at most 128), so every row segment moves as 16-byte
// vectors; the wrapper checks this and the pointers' alignment.
//
// Design. One block per (query tile of 64 rows, head, batch row), 4 warps,
// each warp owning 16 query rows. A loop over 64-key tiles takes the place of
// the TPU's sequential grid and stops at lengths[b]; the last tile masks by
// column. RoPE is applied while a tile is copied to shared memory, with
// scale*log2(e) folded into q so the softmax uses exp2. The softmax is
// online (fp32 running max and sum per row, two lanes per row) and the
// output is normalised once at the end, o/z. For bf16 the two products run on WMMA 16x16x16
// tensor-core tiles with fp32 accumulation; the head dim is zero-padded in
// shared memory to DP, a compile-time width that is a multiple of 16 (XL's
// d = 72 pads to 80), and the padding never reaches the output. The
// probabilities are rounded to bf16 before both the PV product and the row
// sum, so o/z averages the same values the product consumed. fp32 inputs
// run the same schedule with fp32 FMA dots; that path exists to hold the
// kernel against the fp32 reference.
//
// Bound at FiT-XL/2, T = 256 (d = 72): per (batch row, head) about
// 2*2*T^2*d = 19 MFLOP against 4*T*d*2 = 147 KB of q, k, v and output, about
// 128 FLOP/byte, under the H100's bf16 ridge of ~295. A call at B=16, H=16
// is ~38 MB and ~5 GFLOP, i.e. microseconds at either roofline, so latency
// (of the tile loads and of the per-row softmax), launch count and occupancy
// set its time, not the tensor cores. Tile loads therefore move 16-byte
// vectors with compile-time trip counts, so each thread has several loads in
// flight; shared-memory rows are padded off the bank period; and P is
// written over S, which keeps the footprint at 3 blocks per SM for d <= 80.
// WGMMA, TMA, a pipelined key loop and warp specialisation are left for
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per inner-loop tile (== kBlockQ: tile loaders are shared)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16: one WMMA row tile per warp
constexpr int kLdS = kBlockK + 4;  // fp32 score row stride, off the 32-bank period

// Shared-memory row strides for a head dim padded to DP: the q/k/v tiles
// (DP + 8 elements) and the fp32 output accumulator (DP + 4 floats) are
// padded so that consecutive rows start on different banks. P, the
// probabilities, is written over the scores it came from, row for row.
template <typename T, int DP>
struct Strides {
  static constexpr int kTile = DP + 8;
  static constexpr int kOut = DP + 4;
  static constexpr int kP = kLdS * sizeof(float) / sizeof(T);
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

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

// Copies (or zeroes, when src is null) 8 elements as raw 16-byte words.
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
  constexpr int kWords = 8 * sizeof(T) / 16;
  uint4 w[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = src ? reinterpret_cast<const uint4*>(src)[k] : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < kWords; ++k) reinterpret_cast<uint4*>(dst)[k] = w[k];
}

// Rows [row0, row0 + 64) of one head's q or k block (columns col0..col0+d),
// rotated pair by pair and multiplied by `mul`, into a (64, DP) tile with
// row stride Strides::kTile. Rows at or past `valid` and columns at or past d
// are zero.
template <typename T, int DP>
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
      float x[8], cs[8], sn[8];
      const int64_t t = static_cast<int64_t>(row) * d + c;
      load8(x, src + row * row_stride + col0 + c);
      load8(cs, cos_b + t);
      load8(sn, sin_b + t);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        o[j] = (x[j] * cs[j] - x[j + 1] * sn[j]) * mul;
        o[j + 1] = (x[j + 1] * cs[j + 1] + x[j] * sn[j + 1]) * mul;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = 0.f;
    }
    store8(dst + r * Strides<T, DP>::kTile + c, o);
  }
}

// Rows [row0, row0 + 64) of one head's v block into a (64, DP) tile, zero
// past `valid` rows and d columns (a zero row keeps 0 * garbage out of PV).
template <typename T, int DP>
__device__ __forceinline__ void load_plain(T* dst, const T* src, int64_t row_stride, int col0,
                                           int row0, int valid, int d) {
  constexpr int kChunksPerRow = DP / 8;
#pragma unroll
  for (int it = 0; it < kBlockK * kChunksPerRow / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunksPerRow;
    const int c = (i % kChunksPerRow) * 8;
    const int row = row0 + r;
    copy8(dst + r * Strides<T, DP>::kTile + c,
          (row < valid && c < d) ? src + row * row_stride + col0 + c : nullptr);
  }
}

// sw (16, kBlockK) fp32 = qw (16, DP) @ ks (kBlockK, DP)^T, for one warp.
template <typename T, int DP>
__device__ __forceinline__ void warp_scores(float* sw, const T* qw, const T* ks) {
  constexpr int ld = Strides<T, DP>::kTile;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
#pragma unroll
    for (int n = 0; n < kBlockK; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < DP; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, qw + k, ld);
        wmma::load_matrix_sync(bt, ks + n * ld + k, ld);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(sw + n, acc, kLdS, wmma::mem_row_major);
    }
  } else {
    const int lane = threadIdx.x % 32;
    for (int e = lane; e < kRowsPerWarp * kBlockK; e += 32) {
      const int r = e / kBlockK;
      const int j = e % kBlockK;
      float acc = 0.f;
#pragma unroll 16
      for (int c = 0; c < DP; ++c) acc += qw[r * ld + c] * ks[j * ld + c];
      sw[r * kLdS + j] = acc;
    }
  }
}

// ow (16, DP) fp32 += pw (16, kBlockK) @ vs (kBlockK, DP), for one warp.
template <typename T, int DP>
__device__ __forceinline__ void warp_accumulate_pv(float* ow, const T* pw, const T* vs) {
  using S = Strides<T, DP>;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
#pragma unroll
    for (int n = 0; n < DP; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, ow + n, S::kOut, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < kBlockK; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, pw + k, S::kP);
        wmma::load_matrix_sync(bv, vs + k * S::kTile + n, S::kTile);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(ow + n, acc, S::kOut, wmma::mem_row_major);
    }
  } else {
    const int lane = threadIdx.x % 32;
    for (int e = lane; e < kRowsPerWarp * DP; e += 32) {
      const int r = e / DP;
      const int c = e % DP;
      float acc = ow[r * S::kOut + c];
#pragma unroll 16
      for (int j = 0; j < kBlockK; ++j) acc += pw[r * S::kP + j] * vs[j * S::kTile + c];
      ow[r * S::kOut + c] = acc;
    }
  }
}

template <typename T, int DP>
constexpr size_t smem_bytes() {
  return 3 * kBlockQ * Strides<T, DP>::kTile * sizeof(T) +
         (kBlockQ * kLdS + kBlockQ * Strides<T, DP>::kOut) * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    rope_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t, const int* __restrict__ lengths,
                          T* __restrict__ out, int seq, int heads, int d, float q_mul) {
  // Every region is a multiple of 128 bytes long and each 16-row slab a
  // multiple of 32 bytes, which keeps every WMMA tile pointer aligned.
  using S = Strides<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // (64, DP) rotated q * scale * log2(e)
  T* ks = qs + kBlockQ * S::kTile;     // (64, DP) rotated k
  T* vs = ks + kBlockK * S::kTile;     // (64, DP) v
  float* ss = reinterpret_cast<float*>(vs + kBlockK * S::kTile);  // (64, 64) scores, then P
  float* os = ss + kBlockQ * kLdS;     // (64, DP) unnormalised output

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int width = heads * d;  // C
  const int64_t row_stride = 3LL * width;
  const T* src = qkv + static_cast<int64_t>(b) * seq * row_stride;
  const float* cos_b = cos_t + static_cast<int64_t>(b) * seq * d;
  const float* sin_b = sin_t + static_cast<int64_t>(b) * seq * d;
  const int len = min(max(lengths[b], 1), seq);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_rotated<T, DP>(qs, src, cos_b, sin_b, row_stride, h * d, q0, seq, d, q_mul);
  for (int i = threadIdx.x; i < kBlockQ * S::kOut; i += kThreads) os[i] = 0.f;

  const T* qw = qs + warp * kRowsPerWarp * S::kTile;
  float* sw = ss + warp * kRowsPerWarp * kLdS;
  T* pw = reinterpret_cast<T*>(sw);
  float* ow = os + warp * kRowsPerWarp * S::kOut;

  // Two lanes per query row: lane 2r + half owns row r, key columns
  // [32*half, 32*half + 32) of each tile and output columns
  // [half*DP/2, (half+1)*DP/2) for the rescale.
  const int my_row = lane >> 1;
  const int half = lane & 1;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    __syncthreads();  // the previous tile's k/v are consumed; q and os are written
    load_rotated<T, DP>(ks, src, cos_b, sin_b, row_stride, width + h * d, k0, len, d, 1.f);
    load_plain<T, DP>(vs, src, row_stride, 2 * width + h * d, k0, len, d);
    __syncthreads();

    warp_scores<T, DP>(sw, qw, ks);
    __syncwarp();

    // Online softmax. Every tile holds at least one valid key (k0 < len),
    // so the pair's max is finite, masked keys give exp2(-inf) = 0, and
    // exp2(-inf - m_new) = 0 rescales nothing on the first tile. Both lanes
    // of a row read their scores before the shuffle, so writing P over
    // them afterwards is safe.
    {
      const int j0 = half * 32;
      const float* srow = sw + my_row * kLdS + j0;
      float s[32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        s[j] = (k0 + j0 + j < len) ? srow[j] : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_run, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
      const float alpha = exp2f(m_run - m_new);
      T* prow = pw + my_row * S::kP + j0;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const T p = from_float<T>(exp2f(s[j] - m_new));
        prow[j] = p;
        sum += to_float(p);
      }
      l_run = l_run * alpha + sum + __shfl_xor_sync(0xffffffffu, sum, 1);
      m_run = m_new;
      float* orow = ow + my_row * S::kOut + half * (DP / 2);
#pragma unroll
      for (int c = 0; c < DP / 2; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    warp_accumulate_pv<T, DP>(ow, pw, vs);
    __syncwarp();
  }

  // The row sums go through this warp's (now free) score rows, so the
  // epilogue can read any row's sum.
  if (half == 0) sw[my_row] = l_run;
  __syncwarp();
  constexpr int kChunksPerRow = DP / 8;
#pragma unroll
  for (int e = lane; e < kRowsPerWarp * kChunksPerRow; e += 32) {
    const int r = e / kChunksPerRow;
    const int c = (e % kChunksPerRow) * 8;
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row < seq && c < d) {
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = ow[r * S::kOut + c + j] / sw[r];
      store8(out + (static_cast<int64_t>(b) * seq + row) * width + h * d + c, o);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* qkv, const void* cos_t, const void* sin_t, const void* lengths,
                   void* out, int batch, int seq, int heads, int head_dim, float q_mul,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(rope_attention_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  rope_attention_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const int*>(lengths), static_cast<T*>(out),
      seq, heads, head_dim, q_mul);
  return cudaGetLastError();
}

// The compiled head-dim paddings: d pads to the smallest DP >= d.
template <typename T>
cudaError_t dispatch(const void* qkv, const void* cos_t, const void* sin_t, const void* lengths,
                     void* out, int batch, int seq, int heads, int head_dim, float q_mul,
                     cudaStream_t stream) {
  if (head_dim <= 16) return launch<T, 16>(qkv, cos_t, sin_t, lengths, out, batch, seq, heads, head_dim, q_mul, stream);
  if (head_dim <= 32) return launch<T, 32>(qkv, cos_t, sin_t, lengths, out, batch, seq, heads, head_dim, q_mul, stream);
  if (head_dim <= 64) return launch<T, 64>(qkv, cos_t, sin_t, lengths, out, batch, seq, heads, head_dim, q_mul, stream);
  if (head_dim <= 80) return launch<T, 80>(qkv, cos_t, sin_t, lengths, out, batch, seq, heads, head_dim, q_mul, stream);
  return launch<T, 128>(qkv, cos_t, sin_t, lengths, out, batch, seq, heads, head_dim, q_mul, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. q_mul is
// scale * log2(e). is_bf16 selects bf16 (1) or fp32 (0) qkv/out. head_dim
// must be a multiple of 8, at most 128.
int rope_attention_fwd(const void* qkv, const void* cos_t, const void* sin_t, const void* lengths,
                       void* out, int batch, int seq, int heads, int head_dim, float q_mul,
                       int is_bf16, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || head_dim < 8 || head_dim % 8 || head_dim > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<bf16>(qkv, cos_t, sin_t, lengths, out, batch, seq, heads, head_dim, q_mul, s)
              : dispatch<float>(qkv, cos_t, sin_t, lengths, out, batch, seq, heads, head_dim, q_mul, s);
  return static_cast<int>(err);
}

const char* rope_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
