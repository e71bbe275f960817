// Row-wise fused epilogues of the FiT block for Hopper (sm_90a): adaLN
// (fp32 LayerNorm + modulate) and the SwiGLU glue silu(g) * v, each with an
// optional per-row symmetric int8 quantization of its result.
//
// Replaces four TPU kernels:
//   fit_tpu/ops/quant.py::_adaln_quant_kernel      -> adaln_rows<T, true>
//   fit_tpu/ops/fused_adaln.py::_adaln_kernel      -> adaln_rows<T, false>
//   fit_tpu/ops/quant.py::_silu_mul_quant_kernel   -> silu_mul_rows<T, true>
//   fit_tpu/ops/fused_adaln.py::_swiglu_kernel     -> silu_mul_rows<T, false>
//
// adaln_rows, for one token row x of width D and its batch row b:
//   mean = sum(x) / D,  var = sum((x - mean)^2) / D       (fp32, two passes)
//   h    = (x - mean) * rsqrt(var + eps) * (1 + scale[b]) + shift[b]
// silu_mul_rows, for one row of width H:  h = g / (1 + exp(-g)) * v  (fp32)
// Without QUANT, h is stored in the input dtype. With QUANT:
//   s = max(max|h|, 1e-12) * (1/127),  q = clamp(rint(h / s), -127, 127)
// and q (int8) and s (fp32, one per row) are stored: the (q, s) pair that
// feeds the int8 GEMM. rintf rounds half to even, like jnp.round and
// torch.round; the divide is IEEE (__fdiv_rn) and the epilogue's multiplies
// and adds are rounded one by one (__fmul_rn, __fadd_rn, no FMA
// contraction), so the codes agree with fit_tpu's except where a sum taken
// in another order moves h across a rounding boundary (one code).
//
// Bound: device memory. Each row is read once and written once; there is
// no reuse to exploit and ~20 FLOP per element. At FiT-XL/2 with batch 8
// and CFG (4,096 rows) the least traffic is ~14 MB for adaln_rows<true>
// (1152 x (2 B in + 1 B out) per row), ~4 us at 3.35 TB/s, and ~63 MB for
// silu_mul_rows<true> (3072 x (2 + 2 + 1) B per row), ~19 us. The design
// therefore moves the minimum: one read of the inputs in 16-byte vectors,
// the row held in registers between the passes (the statistics, the absmax
// and the store reuse it), and one write of int8. The bf16 intermediate
// that the unfused path writes and reads back never reaches device memory.
//
// Layout. One block of 128 threads per row. A row is cut into chunks of 8
// elements (one 16-byte bf16 vector, two fp32 vectors); thread i owns chunks
// i, i + 128, ..., at most C of them (C a compile-time 1, 2, 4 or 8, so
// widths up to 8192). D and H must be multiples of 8 and every pointer
// 16-byte aligned; shift and scale are (B, D) with a row stride that is a
// multiple of 8 elements (the chunks of a (B, 6D) adaLN output). The
// reductions go through warp shuffles and one shared-memory slot per warp,
// in a fixed order, so a row's result does not depend on the other rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // elements per chunk

__device__ __forceinline__ void load8(const float* p, float (&v)[kChunk]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[kChunk]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kChunk]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[kChunk]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Reduce v over the block; every thread gets the same value, combined in the
// same order. smem holds kWarps floats and may be reused by the next call.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* smem, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // the previous reduction's readers are done with smem
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = smem[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, smem[w]);
  return r;
}

// The row's result h (chunk c of this thread at h[c]), stored: in T, or as
// int8 codes plus one fp32 scale for the row.
template <typename T, bool QUANT, int C>
__device__ __forceinline__ void store_row(float (&h)[C][kChunk], int chunks, void* out,
                                          float* row_scale, long long row, int width,
                                          float* smem) {
  if constexpr (QUANT) {
    float amax = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (threadIdx.x + c * kThreads < chunks) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) amax = fmaxf(amax, fabsf(h[c][i]));
      }
    }
    amax = block_reduce(amax, smem, Max());
    const float s = __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
    int8_t* q_row = static_cast<int8_t*>(out) + row * width;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      if (idx < chunks) {
        union {
          int8_t b[kChunk];
          uint2 u;
        } pack;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const float r = fminf(fmaxf(rintf(__fdiv_rn(h[c][i], s)), -127.0f), 127.0f);
          pack.b[i] = static_cast<int8_t>(static_cast<int>(r));
        }
        *reinterpret_cast<uint2*>(q_row + idx * kChunk) = pack.u;
      }
    }
    if (threadIdx.x == 0) row_scale[row] = s;
  } else {
    T* o_row = static_cast<T*>(out) + row * width;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      if (idx < chunks) store8(o_row + idx * kChunk, h[c]);
    }
  }
}

template <typename T, bool QUANT, int C>
__global__ void __launch_bounds__(kThreads)
adaln_rows(const T* __restrict__ x, const T* __restrict__ shift, const T* __restrict__ scale,
           long long cond_stride, void* __restrict__ out, float* __restrict__ row_scale,
           int seq, int dim, float eps) {
  __shared__ float smem[kWarps];
  const long long row = blockIdx.x;
  const long long b = row / seq;
  const int chunks = dim / kChunk;
  const T* x_row = x + row * dim;

  float v[C][kChunk];
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int idx = threadIdx.x + c * kThreads;
    if (idx < chunks) {
      load8(x_row + idx * kChunk, v[c]);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) sum += v[c][i];
    }
  }
  const float mean = __fdiv_rn(block_reduce(sum, smem, Add()), static_cast<float>(dim));

  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (threadIdx.x + c * kThreads < chunks) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float d = __fsub_rn(v[c][i], mean);
        v[c][i] = d;
        sq += d * d;
      }
    }
  }
  const float var = __fdiv_rn(block_reduce(sq, smem, Add()), static_cast<float>(dim));
  const float rstd = rsqrtf(__fadd_rn(var, eps));

  const T* shift_row = shift + b * cond_stride;
  const T* scale_row = scale + b * cond_stride;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int idx = threadIdx.x + c * kThreads;
    if (idx < chunks) {
      float sh[kChunk], sc[kChunk];
      load8(shift_row + idx * kChunk, sh);
      load8(scale_row + idx * kChunk, sc);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float n = __fmul_rn(v[c][i], rstd);
        v[c][i] = __fadd_rn(__fmul_rn(n, __fadd_rn(1.0f, sc[i])), sh[i]);
      }
    }
  }
  store_row<T, QUANT, C>(v, chunks, out, row_scale, row, dim, smem);
}

template <typename T, bool QUANT, int C>
__global__ void __launch_bounds__(kThreads)
silu_mul_rows(const T* __restrict__ gate, const T* __restrict__ val, void* __restrict__ out,
              float* __restrict__ row_scale, int width) {
  __shared__ float smem[kWarps];
  const long long row = blockIdx.x;
  const int chunks = width / kChunk;
  const T* g_row = gate + row * width;
  const T* v_row = val + row * width;

  float h[C][kChunk];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int idx = threadIdx.x + c * kThreads;
    if (idx < chunks) {
      float g[kChunk], v[kChunk];
      load8(g_row + idx * kChunk, g);
      load8(v_row + idx * kChunk, v);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float silu = __fdiv_rn(g[i], __fadd_rn(1.0f, expf(-g[i])));
        h[c][i] = __fmul_rn(silu, v[i]);
      }
    }
  }
  store_row<T, QUANT, C>(h, chunks, out, row_scale, row, width, smem);
}

// C, the chunks per thread, is the smallest of 1, 2, 4, 8 that covers the row.
template <typename T, bool QUANT>
cudaError_t launch_adaln(const void* x, const void* shift, const void* scale,
                         long long cond_stride, void* out, float* row_scale, int rows, int seq,
                         int dim, float eps, cudaStream_t stream) {
  const int per_thread = (dim / kChunk + kThreads - 1) / kThreads;
  const dim3 grid(rows), block(kThreads);
  const T* xp = static_cast<const T*>(x);
  const T* sh = static_cast<const T*>(shift);
  const T* sc = static_cast<const T*>(scale);
  if (per_thread <= 1) {
    adaln_rows<T, QUANT, 1><<<grid, block, 0, stream>>>(xp, sh, sc, cond_stride, out, row_scale, seq, dim, eps);
  } else if (per_thread <= 2) {
    adaln_rows<T, QUANT, 2><<<grid, block, 0, stream>>>(xp, sh, sc, cond_stride, out, row_scale, seq, dim, eps);
  } else if (per_thread <= 4) {
    adaln_rows<T, QUANT, 4><<<grid, block, 0, stream>>>(xp, sh, sc, cond_stride, out, row_scale, seq, dim, eps);
  } else if (per_thread <= 8) {
    adaln_rows<T, QUANT, 8><<<grid, block, 0, stream>>>(xp, sh, sc, cond_stride, out, row_scale, seq, dim, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, bool QUANT>
cudaError_t launch_silu_mul(const void* gate, const void* val, void* out, float* row_scale,
                            int rows, int width, cudaStream_t stream) {
  const int per_thread = (width / kChunk + kThreads - 1) / kThreads;
  const dim3 grid(rows), block(kThreads);
  const T* g = static_cast<const T*>(gate);
  const T* v = static_cast<const T*>(val);
  if (per_thread <= 1) {
    silu_mul_rows<T, QUANT, 1><<<grid, block, 0, stream>>>(g, v, out, row_scale, width);
  } else if (per_thread <= 2) {
    silu_mul_rows<T, QUANT, 2><<<grid, block, 0, stream>>>(g, v, out, row_scale, width);
  } else if (per_thread <= 4) {
    silu_mul_rows<T, QUANT, 4><<<grid, block, 0, stream>>>(g, v, out, row_scale, width);
  } else if (per_thread <= 8) {
    silu_mul_rows<T, QUANT, 8><<<grid, block, 0, stream>>>(g, v, out, row_scale, width);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry returns a cudaError_t: 0 when the launch was accepted.
// is_bf16 selects bf16 (1) or fp32 (0) inputs; quant selects the int8
// epilogue (out int8 (rows, width), row_scale fp32 (rows,)) over a store in
// the input dtype (out (rows, width), row_scale unused). The width must be a
// multiple of 8, at most 8192; rows at least 1.

int adaln_rows_fwd(const void* x, const void* shift, const void* scale, long long cond_stride,
                   void* out, void* row_scale, int rows, int seq, int dim, float eps,
                   int is_bf16, int quant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rs = static_cast<float*>(row_scale);
  if (is_bf16) {
    return quant ? launch_adaln<bf16, true>(x, shift, scale, cond_stride, out, rs, rows, seq, dim, eps, s)
                 : launch_adaln<bf16, false>(x, shift, scale, cond_stride, out, rs, rows, seq, dim, eps, s);
  }
  return quant ? launch_adaln<float, true>(x, shift, scale, cond_stride, out, rs, rows, seq, dim, eps, s)
               : launch_adaln<float, false>(x, shift, scale, cond_stride, out, rs, rows, seq, dim, eps, s);
}

int silu_mul_rows_fwd(const void* gate, const void* val, void* out, void* row_scale, int rows,
                      int width, int is_bf16, int quant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rs = static_cast<float*>(row_scale);
  if (is_bf16) {
    return quant ? launch_silu_mul<bf16, true>(gate, val, out, rs, rows, width, s)
                 : launch_silu_mul<bf16, false>(gate, val, out, rs, rows, width, s);
  }
  return quant ? launch_silu_mul<float, true>(gate, val, out, rs, rows, width, s)
               : launch_silu_mul<float, false>(gate, val, out, rs, rows, width, s);
}

const char* row_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
