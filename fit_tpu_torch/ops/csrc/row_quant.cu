// Row-wise fused epilogues of the FiT block for Hopper (sm_90a): adaLN
// (fp32 LayerNorm + modulate) and the SwiGLU glue silu(g) * v, each with an
// optional per-row symmetric int8 quantization of its result.
//
// Replaces four TPU kernels:
//   fit_tpu/ops/quant.py::_adaln_quant_kernel    -> adaln_warp_rows<T, C> (K3;
//                                                   adaln_block_rows<T, true, false, C> past 1152)
//   fit_tpu/ops/fused_adaln.py::_adaln_kernel    -> adaln_block_rows<T, false, false, C> (K5)
//   fit_tpu/ops/quant.py::_silu_mul_quant_kernel -> silu_mul_rows<T, true, C> (K4)
//   fit_tpu/ops/fused_adaln.py::_swiglu_kernel   -> silu_mul_rows<T, false, C> (K6;
//                                                   swiglu_halves_fwd reads the halves of one row)
// and adds K5R, adaln_block_rows<T, false, true, C>: K5 with the FiT block's
// attention residual folded in front of it (no TPU counterpart), and K7,
// moe_combine_rows<T, C>: the sparse-MoE FFN's weighted sum of each token's
// expert rows and its shared expert's row (no TPU counterpart: fit_tpu has
// no DiT-MoE). K7 reads (k + 1) rows and writes one; at DiT-MoE-G/2's batch
// 32 with CFG (16,384 rows of 1408, k = 2) that is ~185 MB, ~55 us at
// 3.35 TB/s, where the eager gather, casts, products and sums move ~1.9 GB.
// Two more serve FLUX's blocks (no TPU counterpart: fit_tpu has no FLUX):
// K8, qk_rms_rows<T, COPY_V>, the QK-RMSNorm of each head of q and of k in
// a [q | k | v] projection row, and K6G, gelu_rows<T>, the tanh GELU of a
// row; both read their source and write their destination by row stride,
// so a double block's K8 writes its stream's rows into the joint [txt | img]
// buffer at a row offset, a single block's K8 norms linear1's q and k in
// place, and its K6G writes gelu(m) into the columns of linear2's input
// beside the attention's output. Wan's blocks add K8W, qk_rms_wide_rows<T,
// C>, the RMSNorm of a whole row of q or k across its heads, and run K5 and
// K5R on an fp32 residual stream with bf16 results (the O and Y types of
// adaln_block_rows).
//
// adaLN, for one token row x of width D and its batch row b:
//   mean = sum(x) / D,  var = sum((x - mean)^2) / D       (fp32, two passes)
//   h    = (x - mean) * rsqrt(var + eps) * (1 + scale[b]) + shift[b]
// K5R first forms the row it normalizes from the block's residual stream x,
// the attention's output y and the gate of the batch row:
//   x_new = T(x + T(gate[b] * y))
// rounded as the unfused block rounds it (the product to T, then the sum to
// T, each from the exact fp32 result), so the residual stream keeps its bits;
// x_new is stored beside h, which is K5 of x_new.
// silu_mul_rows, for one row of width H:  h = g / (1 + exp(-g)) * v  (fp32)
// Without QUANT, h is stored in the input dtype. With QUANT:
//   s = max(max|h|, 1e-12) * (1/127),  q = clamp(rint(h / s), -127, 127)
// and q (int8) and s (fp32, one per row) are stored: the (q, s) pair that
// feeds the int8 GEMM. rint rounds half to even, like jnp.round and
// torch.round; the divide is IEEE, the quotient __fdiv_rn returns (div_rn
// below), and the epilogue's multiplies and adds are rounded one by one
// (__fmul_rn, __fadd_rn, no FMA contraction), so the codes agree with
// fit_tpu's except where a sum taken in another order moves h across a
// rounding boundary (one code).
//
// Bound: device memory. Each row is read once and written once; there is
// no reuse to exploit. At FiT-XL/2 with batch 8 and CFG (4,096 rows) the
// least traffic is ~14 MB for adaLN with QUANT (1152 x (2 B in + 1 B out)
// per row), ~4.3 us at 3.35 TB/s, and ~63 MB for silu_mul_rows<true> (3072 x
// (2 + 2 + 1) B per row), ~19 us. So each kernel moves the minimum: one
// read of the inputs, the row held in registers between the passes (the
// statistics, the absmax and the store reuse it), and one write of int8;
// the bf16 intermediate that the unfused path writes and reads back never
// reaches device memory. The int8 epilogue costs ~20 instructions a value,
// which at 4,096 rows is about as long as the memory bound, so it is kept
// short: a code comes from one add (code_bits) instead of rintf and a
// float-to-int conversion, and the quotient from a multiply and four fmas
// by a reciprocal taken once per row (div_rn) instead of a reciprocal and
// a range check per value.
//
// D and H must be multiples of 8 and every pointer 16-byte aligned; shift
// and scale (and K5R's gate) are (B, D) with a row stride that is a multiple
// of 8 elements (the chunks of a (B, 6D) adaLN output). Each reduction runs
// in a fixed order, so two launches give the same bits and a row's result
// does not depend on the other rows or on how rows are spread over blocks.
//
// adaln_warp_rows (K3 for D <= 1152, every FiT and DiT width): a warp per
// row, no block barrier. Lane l owns the quads (4 elements: 8 bytes of
// bf16) l, l + 32, ..., C (<= 9) of them, so the row stays in registers;
// the sum and the sum of squares are shuffle trees inside the warp and the
// absmax one warp-wide integer max. 4-element quads cover the registry
// widths in whole columns of the warp (D = 1152 is 9 quads a lane), where
// 8-element chunks left half the lanes idle in the last column. A block of
// kRowWarps warps covers kRowWarps * rows_per_warp consecutive rows of one
// batch row (the Pallas grid (b, cdiv(T, rows))), and each warp walks
// rows_per_warp rows: its shift and scale arrive once, by cp.async beside
// its first row, into shared-memory slots that only its own lane reads
// back, and the next row's x loads while it reduces the current one. The
// launcher sizes rows_per_warp so that the whole grid is resident at once
// (one wave).
//
// adaln_block_rows (K5, K5R, and K3 past 1152, up to 8192) and
// silu_mul_rows: one block of 128 threads per row; thread i owns chunks (8
// elements: one 16-byte bf16 vector) i, i + 128, ..., at most C of them (C a
// compile-time 1, 2, 4 or 8). The reductions go through warp shuffles and one
// shared-memory slot per warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // block-per-row kernels
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // elements a thread moves at once in the block-per-row kernels
constexpr int kQuad = 4;  // elements a lane moves at once in adaln_warp_rows
constexpr int kRowWarps = 4;  // adaln_warp_rows: warps, so rows in flight, per block
constexpr int kWarpQuads = 9;  // adaln_warp_rows: quads per lane at most
constexpr int kWarpMaxWidth = 32 * kWarpQuads * kQuad;  // 1152

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

// One quad (4 elements) as it arrives from device memory, for the warp path.
template <typename T>
struct Quad;
template <>
struct Quad<bf16> {
  uint2 u;
};
template <>
struct Quad<float> {
  float4 f;
};

__device__ __forceinline__ void load_quad(const bf16* p, Quad<bf16>& q) {
  q.u = *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ void load_quad(const float* p, Quad<float>& q) {
  q.f = *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void unpack(const Quad<bf16>& q, float (&v)[kQuad]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void unpack(const Quad<float>& q, float (&v)[kQuad]) {
  v[0] = q.f.x; v[1] = q.f.y; v[2] = q.f.z; v[3] = q.f.w;
}

__device__ __forceinline__ void store_quad(bf16* p, const float (&v)[kQuad]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store_quad(float* p, const float (&v)[kQuad]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// v rounded to T and back: what storing v in T and loading it gives.
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rounded<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

template <int C>
__device__ __forceinline__ float sum_of(const float (&part)[C]) {
  float r = part[0];
#pragma unroll
  for (int c = 1; c < C; ++c) r += part[c];
  return r;
}

// Reduce v over the warp by an xor tree: every lane ends with the same bits
// (each step adds the same two values in both lanes of a pair).
template <typename Op>
__device__ __forceinline__ float warp_reduce(float v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduce v over the block; every thread gets the same value, combined in the
// same order. smem holds kWarps floats and may be reused by the next call.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* smem, Op op) {
  v = warp_reduce(v, op);
  __syncthreads();  // the previous reduction's readers are done with smem
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = smem[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, smem[w]);
  return r;
}

// h / d, the quotient __fdiv_rn returns (IEEE, round to nearest even), for
// a finite h, a positive normal d and y = __frcp_rn(d), without a divide:
// h * y is within two ulps of it; each step computes the remainder h - q * d
// in one fma and adds remainder * y (Markstein's correction), and after the
// second step q is the rounded quotient. Here d is a row's int8 scale (at
// least 1e-12 / 127, with |h / d| <= 127.0001) or the row width, so no step
// overflows, and a quotient small enough to underflow gets code 0 either
// way.
__device__ __forceinline__ float div_rn(float h, float d, float y) {
  float q = __fmul_rn(h, y);
  q = __fmaf_rn(__fmaf_rn(-q, d, h), y, q);
  return __fmaf_rn(__fmaf_rn(-q, d, h), y, q);
}

// A row's int8 scale s = max(max|h|, 1e-12) * (1/127), and what dividing
// by it takes: y = 1/s rounded to nearest, once per row, and s_div, which is
// s unless s is infinite (a row holding an infinity), then FLT_MAX: with
// y = 0 that gives h / s = 0 for a finite h and NaN for an infinite one, as
// __fdiv_rn does.
struct RowScale {
  float s, s_div, y;
};

__device__ __forceinline__ RowScale row_scale_of(float amax) {
  const float s = __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
  return {s, fminf(s, FLT_MAX), __frcp_rn(s)};
}

// The int8 code of q = h / s in the low byte: clamp(rint(q), -127, 127).
// |q| <= 127.0001 by the choice of s, so the clamp binds only on NaN, which
// fmaxf maps to -127 as the clamp does. q + 1.5 * 2^23 then lies in
// [2^23, 2^24), where floats are the integers, so the round-to-nearest-even
// add is rintf's rounding and leaves 2^22 + rint(q) in the low mantissa
// bits: its low byte is the code in two's complement.
__device__ __forceinline__ unsigned int code_bits(float q) {
  return __float_as_uint(__fadd_rn(fmaxf(q, -127.0f), 12582912.0f));
}

// The 8 codes of one chunk, packed in memory order.
__device__ __forceinline__ uint2 pack_codes(const float (&h)[kChunk], const RowScale& r) {
  unsigned int c[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) c[i] = code_bits(div_rn(h[i], r.s_div, r.y));
  uint2 out;
  out.x = __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410);
  out.y = __byte_perm(__byte_perm(c[4], c[5], 0x0040), __byte_perm(c[6], c[7], 0x0040), 0x5410);
  return out;
}

// The 4 codes of one quad, packed in memory order.
__device__ __forceinline__ uint32_t pack_codes(const float (&h)[kQuad], const RowScale& r) {
  unsigned int c[kQuad];
#pragma unroll
  for (int i = 0; i < kQuad; ++i) c[i] = code_bits(div_rn(h[i], r.s_div, r.y));
  return __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410);
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
    const RowScale rs = row_scale_of(block_reduce(amax, smem, Max()));
    int8_t* q_row = static_cast<int8_t*>(out) + row * width;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      if (idx < chunks) *reinterpret_cast<uint2*>(q_row + idx * kChunk) = pack_codes(h[c], rs);
    }
    if (threadIdx.x == 0) row_scale[row] = rs.s;
  } else {
    T* o_row = static_cast<T*>(out) + row * width;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      if (idx < chunks) store8(o_row + idx * kChunk, h[c]);
    }
  }
}

// BYTES (8 or 16) from global to shared memory without passing through
// registers, and the wait for this thread's copies.
template <int BYTES>
__device__ __forceinline__ void cp_async(float4* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One row of adaln_warp_rows, from this lane's quads x of the row to its
// int8 codes and scale. Lane l holds quads l, l + 32, ..., C of them; all
// but the last lie in the row (C is the fewest that cover it), the last
// only where last_in. slots holds the lane's (1 + scale) at slots[c * 64]
// and shift at slots[c * 64 + 32] for quad c. Each sum runs over a quad's 4
// values in order, then over the lane's quads in order, then over the lanes
// by an xor tree: a fixed order, in short dependent chains. The mean and the
// variance divide by dim as __fdiv_rn does (div_rn, y_dim = 1/dim rounded).
template <typename T, int C>
__device__ __forceinline__ void adaln_quant_row(const Quad<T> (&x)[C], const float4* slots, int lane,
                                                bool last_in, int dim, float y_dim, float eps, int8_t* out,
                                                float* row_scale, long long row) {
  const float f_dim = static_cast<float>(dim);
  float v[C][kQuad], part[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    part[c] = 0.0f;
    if (c < C - 1 || last_in) {
      unpack(x[c], v[c]);
#pragma unroll
      for (int i = 0; i < kQuad; ++i) part[c] += v[c][i];
    }
  }
  const float mean = div_rn(warp_reduce(sum_of(part), Add()), f_dim, y_dim);

#pragma unroll
  for (int c = 0; c < C; ++c) {
    part[c] = 0.0f;
    if (c < C - 1 || last_in) {
#pragma unroll
      for (int i = 0; i < kQuad; ++i) {
        const float d = __fsub_rn(v[c][i], mean);
        v[c][i] = d;
        part[c] += d * d;
      }
    }
  }
  const float var = div_rn(warp_reduce(sum_of(part), Add()), f_dim, y_dim);
  const float rstd = rsqrtf(__fadd_rn(var, eps));

#pragma unroll
  for (int c = 0; c < C; ++c) {
    part[c] = 0.0f;
    if (c < C - 1 || last_in) {
      const float4 sc = slots[c * 64], sh = slots[c * 64 + 32];
      const float scv[kQuad] = {sc.x, sc.y, sc.z, sc.w};
      const float shv[kQuad] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
      for (int i = 0; i < kQuad; ++i) {
        const float n = __fmul_rn(v[c][i], rstd);
        v[c][i] = __fadd_rn(__fmul_rn(n, scv[i]), shv[i]);
        part[c] = fmaxf(part[c], fabsf(v[c][i]));
      }
    }
  }

  float amax = part[0];
#pragma unroll
  for (int c = 1; c < C; ++c) amax = fmaxf(amax, part[c]);
  // over the warp in one integer max: non-negative floats order as their
  // bits, and amax holds no NaN (fmaxf drops one)
  const RowScale rs = row_scale_of(__uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(amax))));
  int8_t* q_row = out + row * dim + lane * kQuad;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c < C - 1 || last_in) *reinterpret_cast<uint32_t*>(q_row + c * 32 * kQuad) = pack_codes(v[c], rs);
  }
  if (lane == 0) row_scale[row] = rs.s;
}

// K3 for widths up to kWarpMaxWidth: a warp per row (see the header).
// cond holds, per warp, 2 C float4 slots per lane: (1 + scale) and shift of
// the lane's quads, slot k of quad c at [(c * 2 + k) * 32 + lane], so a
// warp's reads of one slot are 32 consecutive float4 (no bank conflict).
// They arrive by cp.async, all at once and beside the first row (scale's
// raw quad in slot 0, shift's in slot 1; a bf16 quad fills half of it),
// and each lane converts its own slots in place: no other thread reads
// them, so no barrier orders them.
template <typename T, int C>
__global__ void __launch_bounds__(kRowWarps * 32, 4)
adaln_warp_rows(const T* __restrict__ x, const T* __restrict__ shift, const T* __restrict__ scale,
                long long cond_stride, int8_t* __restrict__ out, float* __restrict__ row_scale,
                int seq, int dim, int blocks_per_batch, int rows_per_warp, float eps) {
  extern __shared__ float4 cond[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / blocks_per_batch;
  const int t0 = ((blockIdx.x % blocks_per_batch) * kRowWarps + warp) * rows_per_warp;
  if (t0 >= seq) return;  // warp-uniform, and nothing below waits on another warp
  const int t_end = min(t0 + rows_per_warp, seq);
  const bool last_in = lane + (C - 1) * 32 < dim / kQuad;
  float4* slots = cond + warp * (C * 2 * 32) + lane;

  const T* scale_row = scale + b * cond_stride + lane * kQuad;
  const T* shift_row = shift + b * cond_stride + lane * kQuad;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c < C - 1 || last_in) {
      cp_async<kQuad * sizeof(T)>(&slots[c * 64], scale_row + c * 32 * kQuad);
      cp_async<kQuad * sizeof(T)>(&slots[c * 64 + 32], shift_row + c * 32 * kQuad);
    }
  }
  const T* x_row = x + (b * seq + t0) * dim + lane * kQuad;
  Quad<T> cur[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c < C - 1 || last_in) load_quad(x_row + c * 32 * kQuad, cur[c]);
  }
  cp_async_wait_all();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c < C - 1 || last_in) {
      float sc[kQuad];
      unpack(*reinterpret_cast<const Quad<T>*>(&slots[c * 64]), sc);
      if constexpr (sizeof(T) == 2) {  // an fp32 shift arrives as it is used
        float sh[kQuad];
        unpack(*reinterpret_cast<const Quad<T>*>(&slots[c * 64 + 32]), sh);
        slots[c * 64 + 32] = make_float4(sh[0], sh[1], sh[2], sh[3]);
      }
#pragma unroll
      for (int i = 0; i < kQuad; ++i) sc[i] = __fadd_rn(1.0f, sc[i]);
      slots[c * 64] = make_float4(sc[0], sc[1], sc[2], sc[3]);
    }
  }

  const float y_dim = __frcp_rn(static_cast<float>(dim));
  for (int t = t0; t < t_end; ++t) {
    Quad<T> next[C];  // the next row loads while this one is reduced
    if (t + 1 < t_end) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < C - 1 || last_in) load_quad(x_row + dim + c * 32 * kQuad, next[c]);
      }
    }
    adaln_quant_row<T, C>(cur, slots, lane, last_in, dim, y_dim, eps, out, row_scale, b * seq + t);
#pragma unroll
    for (int c = 0; c < C; ++c) cur[c] = next[c];
    x_row += dim;
  }
}

// K5R's residual operands: y (rows, D) in Y, gate (B, D) at the row stride
// of shift and scale, and x_new's destination (rows, D), both in x's T.
// Unused by K5 and K3.
template <typename T, typename Y = T>
struct Residual {
  const Y* y;
  const T* gate;
  T* x_out;
};

// adaLN, K5, K5R (RESID) and K3 for rows wider than kWarpMaxWidth: one block
// of 128 threads per row. O is the result's type and Y K5R's branch output's
// (both T, but for an fp32 residual stream with bf16 branches: Wan's blocks).
template <typename T, bool QUANT, bool RESID, int C, typename O = T, typename Y = T>
__global__ void __launch_bounds__(kThreads)
adaln_block_rows(const T* __restrict__ x, const T* __restrict__ shift, const T* __restrict__ scale,
                 long long cond_stride, void* __restrict__ out, float* __restrict__ row_scale,
                 int seq, int dim, float eps, Residual<T, Y> res) {
  static_assert(!(QUANT && RESID), "K5R stores its result in T");
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
      if constexpr (RESID) {
        float y[kChunk], g[kChunk];
        load8(res.y + row * dim + idx * kChunk, y);
        load8(res.gate + b * cond_stride + idx * kChunk, g);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) v[c][i] = rounded<T>(__fadd_rn(v[c][i], rounded<T>(__fmul_rn(g[i], y[i]))));
        store8(res.x_out + row * dim + idx * kChunk, v[c]);
      }
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
  store_row<O, QUANT, C>(v, chunks, out, row_scale, row, dim, smem);
}

template <typename T, bool QUANT, int C>
__global__ void __launch_bounds__(kThreads)
silu_mul_rows(const T* __restrict__ gate, const T* __restrict__ val, void* __restrict__ out,
              float* __restrict__ row_scale, int width, long long ld) {
  __shared__ float smem[kWarps];
  const long long row = blockIdx.x;
  const int chunks = width / kChunk;
  const T* g_row = gate + row * ld;
  const T* v_row = val + row * ld;

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

// moe_combine_rows: one token row of the sparse-MoE FFN's output from its
// k experts' rows (ys at pos[row, j], in the experts' sorted order) and the
// shared expert's row, summed in fp32 in slot order and rounded once:
//   out = T(((0 + w0 * y0) + w1 * y1 + ...) + shared)
// each product and sum rounded on its own (__fmul_rn, __fadd_rn), as the
// eager ops round them. One block of 128 threads per row, 8-element chunks.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
moe_combine_rows(const T* __restrict__ ys, const long long* __restrict__ pos, const float* __restrict__ w,
                 const T* __restrict__ shared, T* __restrict__ out, int k, int width) {
  const long long row = blockIdx.x;
  const int chunks = width / kChunk;
  float acc[C][kChunk];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) acc[c][i] = 0.0f;
  }
  for (int j = 0; j < k; ++j) {
    const T* y_row = ys + pos[row * k + j] * width;
    const float wj = w[row * k + j];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      if (idx < chunks) {
        float v[kChunk];
        load8(y_row + idx * kChunk, v);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) acc[c][i] = __fadd_rn(acc[c][i], __fmul_rn(wj, v[i]));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int idx = threadIdx.x + c * kThreads;
    if (idx < chunks) {
      float v[kChunk];
      load8(shared + row * width + idx * kChunk, v);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) acc[c][i] = __fadd_rn(acc[c][i], v[i]);
      store8(out + row * width + idx * kChunk, acc[c]);
    }
  }
}

// K8, qk_rms_rows: for one token row of a [q | k | v] projection (each C =
// heads * head_dim wide), each head of q and of k becomes
//   y = x * rsqrt(sum(x^2) / head_dim + eps) * scale      (fp32, one cast to T)
// with q's or k's learned scale (head_dim,) in T. FLUX's RMSNorm casts
// x * rsqrt(...) to T before the scale's multiply; one cast after it is a
// departure inside T's rounding. One block of 128 threads per row, a thread
// per 8-element chunk: the head_dim / 8 threads of a head (a power of two up
// to 32, so a head lies in one warp) sum their squares by an xor tree. With
// COPY_V, v is copied to the destination beside the normed q and k;
// without, the destination is the source (in place) and v is not touched.
// Source row (b, t) is src + b * src_bs + t * src_ld, destination row dst +
// b * dst_bs + t * dst_ld (a row offset is the caller's base pointer). Every thread of the block takes
// the same number of turns, so every lane of a warp reaches each shuffle.
template <typename T, bool COPY_V>
__global__ void __launch_bounds__(kThreads)
qk_rms_rows(const T* src, long long src_bs, long long src_ld, T* dst, long long dst_bs, long long dst_ld,
            const T* __restrict__ q_scale, const T* __restrict__ k_scale, int seq, int heads,
            int head_dim, float eps) {
  const long long row = blockIdx.x;
  const long long b = row / seq;
  const long long t = row % seq;
  const T* s_row = src + b * src_bs + t * src_ld;
  T* d_row = dst + b * dst_bs + t * dst_ld;
  const int per_head = head_dim / kChunk;
  const int q_chunks = heads * per_head;
  const int normed = 2 * q_chunks;
  const int total = COPY_V ? 3 * q_chunks : normed;
  const float inv_dim = 1.0f / static_cast<float>(head_dim);  // exact: head_dim is a power of two
  for (int base = 0; base < total; base += kThreads) {
    const int idx = base + threadIdx.x;
    float v[kChunk];
    if (idx < total) {
      load8(s_row + idx * kChunk, v);
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[i] = 0.0f;
    }
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) sq += v[i] * v[i];
    for (int o = per_head >> 1; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (idx < normed) {
      float sc[kChunk];
      load8((idx < q_chunks ? q_scale : k_scale) + (idx % per_head) * kChunk, sc);
      const float r = rsqrtf(__fadd_rn(__fmul_rn(sq, inv_dim), eps));
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[i] = __fmul_rn(__fmul_rn(v[i], r), sc[i]);
    }
    if (idx < normed || (COPY_V && idx < total)) store8(d_row + idx * kChunk, v);
  }
}

// K6G, gelu_rows: the tanh GELU of each element, as PyTorch's
// gelu(approximate="tanh") computes it in fp32,
//   y = 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))
// cast once to T. A thread per 8-element chunk; grid (rows, chunk blocks),
// rows by (batch, token) strides on both sides.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gelu_rows(const T* __restrict__ src, long long src_bs, long long src_ld, T* __restrict__ dst, long long dst_bs,
          long long dst_ld, int seq, int width) {
  const int idx = blockIdx.y * kThreads + threadIdx.x;
  if (idx >= width / kChunk) return;
  const long long row = blockIdx.x;
  const long long b = row / seq;
  const long long t = row % seq;
  float v[kChunk];
  load8(src + b * src_bs + t * src_ld + idx * kChunk, v);
  constexpr float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  constexpr float kKappa = 0.044715f;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const float x = v[i];
    const float inner = kBeta * (x + kKappa * (x * x * x));
    v[i] = 0.5f * x * (1.0f + tanhf(inner));
  }
  store8(dst + b * dst_bs + t * dst_ld + idx * kChunk, v);
}

// K8W, qk_rms_wide_rows: Wan's QK-RMSNorm of a whole row of q or of k
// (width = heads * head_dim lanes, across heads) with a learned weight
// (width,) in T, in place:
//   y = T(T(x * rsqrt(sum(x^2) / width + eps)) * w)      (fp32)
// the inner cast is the released RMSNorm's (type_as before the weight), the
// outer one the store. One block of 128 threads per row, C chunks of 8 a
// thread, the sum of squares by block_reduce (a fixed order). Row (b, t)
// is x + b * bs + t * ld.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
qk_rms_wide_rows(T* x, long long bs, long long ld, const T* __restrict__ w, int seq, int width, float eps) {
  __shared__ float smem[kWarps];
  const long long row = blockIdx.x;
  T* x_row = x + (row / seq) * bs + (row % seq) * ld;
  const int chunks = width / kChunk;
  float v[C][kChunk];
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int idx = threadIdx.x + c * kThreads;
    if (idx < chunks) {
      load8(x_row + idx * kChunk, v[c]);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) sq += v[c][i] * v[c][i];
    }
  }
  const float ms = __fdiv_rn(block_reduce(sq, smem, Add()), static_cast<float>(width));
  const float r = rsqrtf(__fadd_rn(ms, eps));
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int idx = threadIdx.x + c * kThreads;
    if (idx < chunks) {
      float wc[kChunk];
      load8(w + idx * kChunk, wc);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[c][i] = __fmul_rn(rounded<T>(__fmul_rn(v[c][i], r)), wc[i]);
      store8(x_row + idx * kChunk, v[c]);
    }
  }
}

// The warp-per-row launch. rows_per_warp is the least that makes the grid
// fit in one wave: every block resident at once, so none waits for another
// to finish. Which warp handles a row does not change its result.
template <typename T, int C>
cudaError_t launch_warp_rows(const T* x, const T* shift, const T* scale, long long cond_stride,
                             int8_t* out, float* row_scale, int rows, int seq, int dim, float eps,
                             cudaStream_t stream) {
  const size_t smem = sizeof(float4) * kRowWarps * C * 2 * 32;
  static int per_sm = 0;  // resident blocks per SM: a property of the kernel, the same on every launch
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adaln_warp_rows<T, C>, kRowWarps * 32, smem);
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long wave = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;  // blocks resident at once
  const int batch = rows / seq;
  const auto per_batch = [seq](int r) { return (seq + kRowWarps * r - 1) / (kRowWarps * r); };
  int rows_per_warp = static_cast<int>((rows + wave * kRowWarps - 1) / (wave * kRowWarps));
  while (rows_per_warp < seq && static_cast<long long>(batch) * per_batch(rows_per_warp) > wave) ++rows_per_warp;
  const int blocks_per_batch = per_batch(rows_per_warp);
  adaln_warp_rows<T, C><<<batch * blocks_per_batch, kRowWarps * 32, smem, stream>>>(
      x, shift, scale, cond_stride, out, row_scale, seq, dim, blocks_per_batch, rows_per_warp, eps);
  return cudaGetLastError();
}

// K3 up to 1152 wide takes the warp path with C = ceil(quads / 32); K5, K5R,
// and K3 on wider rows, the block path with C, the chunks per thread, the
// smallest of 1, 2, 4, 8 that covers the row.
template <typename T, bool QUANT, bool RESID = false, typename O = T, typename Y = T>
cudaError_t launch_adaln(const void* x, const void* shift, const void* scale,
                         long long cond_stride, void* out, float* row_scale, int rows, int seq,
                         int dim, float eps, cudaStream_t stream, Residual<T, Y> res = {}) {
  const T* xp = static_cast<const T*>(x);
  const T* sh = static_cast<const T*>(shift);
  const T* sc = static_cast<const T*>(scale);
  if (QUANT && dim <= kWarpMaxWidth) {
    int8_t* q = static_cast<int8_t*>(out);
#define WARP_ROWS(C) \
  case C: return launch_warp_rows<T, C>(xp, sh, sc, cond_stride, q, row_scale, rows, seq, dim, eps, stream)
    switch ((dim / kQuad + 31) / 32) {
      WARP_ROWS(1); WARP_ROWS(2); WARP_ROWS(3); WARP_ROWS(4); WARP_ROWS(5);
      WARP_ROWS(6); WARP_ROWS(7); WARP_ROWS(8); WARP_ROWS(kWarpQuads);
      default: return cudaErrorInvalidValue;
    }
#undef WARP_ROWS
  }
  const int per_thread = (dim / kChunk + kThreads - 1) / kThreads;
  const dim3 grid(rows), block(kThreads);
  if (per_thread <= 1) {
    adaln_block_rows<T, QUANT, RESID, 1, O, Y><<<grid, block, 0, stream>>>(xp, sh, sc, cond_stride, out, row_scale, seq, dim, eps, res);
  } else if (per_thread <= 2) {
    adaln_block_rows<T, QUANT, RESID, 2, O, Y><<<grid, block, 0, stream>>>(xp, sh, sc, cond_stride, out, row_scale, seq, dim, eps, res);
  } else if (per_thread <= 4) {
    adaln_block_rows<T, QUANT, RESID, 4, O, Y><<<grid, block, 0, stream>>>(xp, sh, sc, cond_stride, out, row_scale, seq, dim, eps, res);
  } else if (per_thread <= 8) {
    adaln_block_rows<T, QUANT, RESID, 8, O, Y><<<grid, block, 0, stream>>>(xp, sh, sc, cond_stride, out, row_scale, seq, dim, eps, res);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, bool QUANT>
cudaError_t launch_silu_mul(const void* gate, const void* val, void* out, float* row_scale,
                            int rows, int width, long long ld, cudaStream_t stream) {
  const int per_thread = (width / kChunk + kThreads - 1) / kThreads;
  const dim3 grid(rows), block(kThreads);
  const T* g = static_cast<const T*>(gate);
  const T* v = static_cast<const T*>(val);
  if (per_thread <= 1) {
    silu_mul_rows<T, QUANT, 1><<<grid, block, 0, stream>>>(g, v, out, row_scale, width, ld);
  } else if (per_thread <= 2) {
    silu_mul_rows<T, QUANT, 2><<<grid, block, 0, stream>>>(g, v, out, row_scale, width, ld);
  } else if (per_thread <= 4) {
    silu_mul_rows<T, QUANT, 4><<<grid, block, 0, stream>>>(g, v, out, row_scale, width, ld);
  } else if (per_thread <= 8) {
    silu_mul_rows<T, QUANT, 8><<<grid, block, 0, stream>>>(g, v, out, row_scale, width, ld);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_moe_combine(const void* ys, const long long* pos, const float* w, const void* shared, void* out,
                               int rows, int k, int width, cudaStream_t stream) {
  const int per_thread = (width / kChunk + kThreads - 1) / kThreads;
  const dim3 grid(rows), block(kThreads);
  const T* y = static_cast<const T*>(ys);
  const T* sh = static_cast<const T*>(shared);
  T* o = static_cast<T*>(out);
  if (per_thread <= 1) {
    moe_combine_rows<T, 1><<<grid, block, 0, stream>>>(y, pos, w, sh, o, k, width);
  } else if (per_thread <= 2) {
    moe_combine_rows<T, 2><<<grid, block, 0, stream>>>(y, pos, w, sh, o, k, width);
  } else if (per_thread <= 4) {
    moe_combine_rows<T, 4><<<grid, block, 0, stream>>>(y, pos, w, sh, o, k, width);
  } else if (per_thread <= 8) {
    moe_combine_rows<T, 8><<<grid, block, 0, stream>>>(y, pos, w, sh, o, k, width);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qk_rms(const void* src, long long src_bs, long long src_ld, void* dst, long long dst_bs,
                          long long dst_ld, const void* q_scale, const void* k_scale, int batch,
                          int seq, int heads, int head_dim, float eps, bool copy_v, cudaStream_t stream) {
  if (head_dim < kChunk || head_dim > 32 * kChunk || (head_dim & (head_dim - 1))) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(static_cast<long long>(batch) * seq)), block(kThreads);
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  const T* qs = static_cast<const T*>(q_scale);
  const T* ks = static_cast<const T*>(k_scale);
  if (copy_v) {
    qk_rms_rows<T, true><<<grid, block, 0, stream>>>(s, src_bs, src_ld, d, dst_bs, dst_ld, qs, ks, seq,
                                                      heads, head_dim, eps);
  } else {
    qk_rms_rows<T, false><<<grid, block, 0, stream>>>(s, src_bs, src_ld, d, dst_bs, dst_ld, qs, ks, seq,
                                                       heads, head_dim, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qk_rms_wide(void* x, long long bs, long long ld, const void* w, int batch, int seq, int width,
                               float eps, cudaStream_t stream) {
  const int per_thread = (width / kChunk + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned int>(static_cast<long long>(batch) * seq)), block(kThreads);
  T* xp = static_cast<T*>(x);
  const T* wp = static_cast<const T*>(w);
  if (per_thread <= 1) {
    qk_rms_wide_rows<T, 1><<<grid, block, 0, stream>>>(xp, bs, ld, wp, seq, width, eps);
  } else if (per_thread <= 2) {
    qk_rms_wide_rows<T, 2><<<grid, block, 0, stream>>>(xp, bs, ld, wp, seq, width, eps);
  } else if (per_thread <= 4) {
    qk_rms_wide_rows<T, 4><<<grid, block, 0, stream>>>(xp, bs, ld, wp, seq, width, eps);
  } else if (per_thread <= 8) {
    qk_rms_wide_rows<T, 8><<<grid, block, 0, stream>>>(xp, bs, ld, wp, seq, width, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gelu(const void* src, long long src_bs, long long src_ld, void* dst, long long dst_bs,
                        long long dst_ld, int batch, int seq, int width, cudaStream_t stream) {
  const int chunks = width / kChunk;
  const dim3 grid(static_cast<unsigned int>(static_cast<long long>(batch) * seq), (chunks + kThreads - 1) / kThreads);
  gelu_rows<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(src), src_bs, src_ld, static_cast<T*>(dst),
                                              dst_bs, dst_ld, seq, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry returns a cudaError_t: 0 when the launch was accepted.
// is_bf16 selects bf16 (1) or fp32 (0) inputs; quant selects the int8
// epilogue (out int8 (rows, width), row_scale fp32 (rows,)) over a store in
// the input dtype (out (rows, width), row_scale unused). The width must be a
// multiple of 8, at most 8192; rows at least 1, a multiple of seq.

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

// K5R: x_out = x + gate * y (rounded as the unfused block rounds it) and
// out = K5 of x_out, all in the input dtype. y and x_out are (rows, dim);
// gate is (B, dim) at the row stride of shift and scale.
int adaln_resid_rows_fwd(const void* x, const void* y, const void* gate, const void* shift, const void* scale,
                         long long cond_stride, void* x_out, void* out, int rows, int seq, int dim, float eps,
                         int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const Residual<bf16> res{static_cast<const bf16*>(y), static_cast<const bf16*>(gate), static_cast<bf16*>(x_out)};
    return launch_adaln<bf16, false, true>(x, shift, scale, cond_stride, out, nullptr, rows, seq, dim, eps, s, res);
  }
  const Residual<float> res{static_cast<const float*>(y), static_cast<const float*>(gate), static_cast<float*>(x_out)};
  return launch_adaln<float, false, true>(x, shift, scale, cond_stride, out, nullptr, rows, seq, dim, eps, s, res);
}

// K5 and K5R on an fp32 residual stream with bf16 results: x, shift and
// scale (and K5R's gate and x_out) fp32, K5R's y bf16, out bf16. The
// residual is x + gate * y in fp32, as an fp32 stream adds a bf16 branch.
int adaln_rows_mixed_fwd(const void* x, const void* shift, const void* scale, long long cond_stride, void* out,
                         int rows, int seq, int dim, float eps, void* stream) {
  return launch_adaln<float, false, false, bf16>(x, shift, scale, cond_stride, out, nullptr, rows, seq, dim, eps,
                                                 static_cast<cudaStream_t>(stream));
}

int adaln_resid_rows_mixed_fwd(const void* x, const void* y, const void* gate, const void* shift,
                               const void* scale, long long cond_stride, void* x_out, void* out, int rows, int seq,
                               int dim, float eps, void* stream) {
  const Residual<float, bf16> res{static_cast<const bf16*>(y), static_cast<const float*>(gate),
                                  static_cast<float*>(x_out)};
  return launch_adaln<float, false, true, bf16, bf16>(x, shift, scale, cond_stride, out, nullptr, rows, seq, dim,
                                                      eps, static_cast<cudaStream_t>(stream), res);
}

int silu_mul_rows_fwd(const void* gate, const void* val, void* out, void* row_scale, int rows,
                      int width, int is_bf16, int quant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rs = static_cast<float*>(row_scale);
  if (is_bf16) {
    return quant ? launch_silu_mul<bf16, true>(gate, val, out, rs, rows, width, width, s)
                 : launch_silu_mul<bf16, false>(gate, val, out, rs, rows, width, width, s);
  }
  return quant ? launch_silu_mul<float, true>(gate, val, out, rs, rows, width, width, s)
               : launch_silu_mul<float, false>(gate, val, out, rs, rows, width, width, s);
}

// K6 on the two halves of one (rows, 2 * width) projection [gate | up], as
// a sparse-MoE expert's grouped GEMM and the shared expert write it: gate
// is the row's first width elements and the value its last, at row stride
// 2 * width; out is (rows, width).
int swiglu_halves_fwd(const void* gate_up, void* out, int rows, int width, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ld = 2LL * width;
  if (is_bf16) {
    const bf16* g = static_cast<const bf16*>(gate_up);
    return launch_silu_mul<bf16, false>(g, g + width, out, nullptr, rows, width, ld, s);
  }
  const float* g = static_cast<const float*>(gate_up);
  return launch_silu_mul<float, false>(g, g + width, out, nullptr, rows, width, ld, s);
}

// The sparse-MoE combine: out (rows, width) from ys (rows * k, width) at
// pos (rows, k) int64, weighted by w (rows, k) fp32, plus shared (rows,
// width).
int moe_combine_fwd(const void* ys, const void* pos, const void* w, const void* shared, void* out, int rows, int k,
                    int width, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* p = static_cast<const long long*>(pos);
  const float* wt = static_cast<const float*>(w);
  if (is_bf16) return launch_moe_combine<bf16>(ys, p, wt, shared, out, rows, k, width, s);
  return launch_moe_combine<float>(ys, p, wt, shared, out, rows, k, width, s);
}

// K8: FLUX's QK-RMSNorm of the q and k heads of a [q | k | v] projection,
// (batch, seq) rows by (src_bs, src_ld) element strides, into dst rows by
// (dst_bs, dst_ld); copy_v copies v beside them (dst
// another buffer), else dst is src and v is left as it is. q_scale and
// k_scale are (head_dim,); head_dim a power of two from 8 to 256.
int qk_rms_rows_fwd(const void* src, long long src_bs, long long src_ld, void* dst, long long dst_bs,
                    long long dst_ld, const void* q_scale, const void* k_scale, int batch, int seq,
                    int heads, int head_dim, float eps, int copy_v, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_qk_rms<bf16>(src, src_bs, src_ld, dst, dst_bs, dst_ld, q_scale, k_scale, batch, seq,
                               heads, head_dim, eps, copy_v != 0, s);
  }
  return launch_qk_rms<float>(src, src_bs, src_ld, dst, dst_bs, dst_ld, q_scale, k_scale, batch, seq,
                              heads, head_dim, eps, copy_v != 0, s);
}

// K8W: Wan's RMSNorm of whole rows of q or k, in place: (batch, seq) rows
// of width (a multiple of 8, at most 8192) by (bs, ld) element strides,
// times w (width,).
int qk_rms_wide_fwd(void* x, long long bs, long long ld, const void* w, int batch, int seq, int width, float eps,
                    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_qk_rms_wide<bf16>(x, bs, ld, w, batch, seq, width, eps, s);
  return launch_qk_rms_wide<float>(x, bs, ld, w, batch, seq, width, eps, s);
}

// K6G: the tanh GELU of (batch, seq, width) rows by (src_bs, src_ld) into
// rows by (dst_bs, dst_ld).
int gelu_rows_fwd(const void* src, long long src_bs, long long src_ld, void* dst, long long dst_bs, long long dst_ld,
                  int batch, int seq, int width, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_gelu<bf16>(src, src_bs, src_ld, dst, dst_bs, dst_ld, batch, seq, width, s);
  return launch_gelu<float>(src, src_bs, src_ld, dst, dst_bs, dst_ld, batch, seq, width, s);
}

const char* row_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
