// Backward of the fused 2D-RoPE + prefix-masked attention (rope_attention.cu)
// for Hopper (sm_90a).
//
// Replaces the TPU backward kernels of fit_tpu/ops/fused_attention.py:
// _bwd_kernel (head-major), _qkv_bwd_kernel (natural layout, T <= 1024),
// _qkv_chunked_bwd_kernel (single-pass from lse, T <= 2304) and the two-pass
// _qkv_chunked_dq_kernel / _qkv_chunked_dkv_kernel (T > 2304). One design
// serves every T, so the TPU's per-T routing (_use_pallas_bwd,
// _chunked_bwd_supported, _single_pass_bwd_max_t) has no counterpart.
//
// It computes the exact VJP of the forward from (qkv, g, out, lse, cos,
// sin, lengths), with q_r = rope(q) * scale * log2(e), k_r = rope(k) and the
// forward's lse2 (exp2 domain), as fused_attention.py:1225-1240 does:
//
//   p     = exp2(q_r k_r^T - lse2)  over keys < lengths[b], else 0
//   dv    = p^T g
//   dp    = g v^T,  delta = rowsum(g * out),  ds = p * (dp - delta)
//   dq    = rope_vjp(ds k_r * scale),  dk = rope_vjp(ds^T q_r / log2(e))
//   rope_vjp(x) = x*cos - rot(x*sin)   (rot is antisymmetric)
//
// Every query row takes part, padded rows included: the forward gave them a
// softmax over the valid keys, so their gradient reaches those keys' dk/dv.
// Keys at or past lengths[b] get dk = dv = 0, written explicitly.
//
// Replaced TPU kernels, by number in PERF.md section 6: #5 _bwd_kernel, #6
// _qkv_bwd_kernel (the FiT-B/2 training shape), #7 _qkv_chunked_bwd_kernel,
// #8 _qkv_chunked_dq_kernel and #9 _qkv_chunked_dkv_kernel.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at FiT-B/2
// training, micro-batch 64 x T 256 x H 12 x d 64 (bf16), it must read qkv,
// g, out, cos/sin and lse (~135 MB) and write dqkv (75.5 MB), ~63 us,
// against 5 products of 2*B*H*T^2*d = 32 GFLOP, ~33 us: bytes bound it.
// At XL T 4096 (B 1, H 16, d 72) the 5 products take ~191 us and
// operations bound it.
//
// Design, bf16 (rope_attention_bwd_mma.cuh): three launches and no
// atomics, so two runs on the same inputs agree bit for bit (a resumed
// training run repeats its loss stream). A prologue writes delta, the
// rotated q and k once as bf16 and the head-major lse2 and delta into
// scratch the wrapper allocates; then a dk/dv pass (a block per 64 keys,
// looping over every query tile) and a dq pass (a block per 64 queries,
// looping over the keys below the length), both on mma.sync m16n8k16 with
// the scores, probabilities and accumulators in registers and the streamed
// tiles in two-stage cp.async rings. Both passes recompute S and dP, so it
// does 8 products where 5 would do: fusing the dq pass into the dk/dv pass
// would need atomics or a (T / 64)-deep fp32 buffer of partial dq.
//
// Design, fp32: the schedule that preceded the bf16 kernels, kept as it was
// to hold K2 against the fp32 reference at 1e-4: delta_kernel, one thread
// per (row, head); dkdv_kernel, one block per (key tile of 64, head, batch
// row), k_r and v in shared memory while a loop walks every 64-row query
// tile, each warp owning 16 keys; dq_kernel, one block per (query tile of
// 64, head, batch row), looping over the key tiles below lengths[b]. Both
// recompute the scores from the rotated tiles (the loaders of
// rope_tiles.cuh), on fp32 FMA dots, with the score tile, then p and ds,
// and the accumulators in shared memory.

#include "rope_attention_bwd_mma.cuh"
#include "rope_tiles.cuh"

namespace {

// The rows of one (B, T, 3C) gradient written from a warp's fp32
// accumulator (16, DP): rope_vjp(acc * mul) when rotate, else acc. Rows at or
// past `seq` and columns at or past d are not stored.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, const float* acc, const float* cos_b,
                                           const float* sin_b, int row0, int seq, int d,
                                           int64_t row_stride, float mul, bool rotate) {
  constexpr int kChunksPerRow = DP / 8;
  constexpr int ld = Strides<T, DP>::kOut;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int e = lane; e < kRowsPerWarp * kChunksPerRow; e += 32) {
    const int r = e / kChunksPerRow;
    const int c = (e % kChunksPerRow) * 8;
    const int row = row0 + r;
    if (row < seq && c < d) {
      float x[8], o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = acc[r * ld + c + j] * mul;
      if (rotate) {
        float cs[8], sn[8];
        const int64_t t = static_cast<int64_t>(row) * d + c;
        load8(cs, cos_b + t);
        load8(sn, sin_b + t);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          o[j] = x[j] * cs[j] + x[j + 1] * sn[j + 1];
          o[j + 1] = x[j + 1] * cs[j + 1] - x[j] * sn[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = x[j];
      }
      store8(dst + row * row_stride + c, o);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ g, const T* __restrict__ out, float* __restrict__ delta,
                 int64_t n, int d) {
  // (row, head) i: g and out are (B*T, H*d) row-major, so its d values start at i*d.
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const T* gp = g + i * d;
  const T* op = out + i * d;
  float acc = 0.f;
  for (int c = 0; c < d; c += 8) {
    float a[8], o[8];
    load8(a, gp + c);
    load8(o, op + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += a[j] * o[j];
  }
  delta[i] = acc;
}

template <typename T, int DP>
constexpr size_t dkdv_smem_bytes() {
  using S = Strides<T, DP>;
  return 4 * kBlockQ * S::kTile * sizeof(T) +
         (kBlockQ * kLdS + 2 * kBlockQ * S::kOut + 2 * kBlockQ) * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ g, const float* __restrict__ lse,
                const float* __restrict__ delta, const float* __restrict__ cos_t,
                const float* __restrict__ sin_t, const int* __restrict__ lengths,
                T* __restrict__ dqkv, int seq, int heads, int d, float q_mul, float dk_mul) {
  // Every region is a multiple of 128 bytes long and each 16-row slab a
  // multiple of 32 bytes, which keeps every 16-byte vector access aligned.
  using S = Strides<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // (64, DP) rotated k of this block's keys
  T* vs = ks + kBlockK * S::kTile;     // (64, DP) v
  T* qs = vs + kBlockK * S::kTile;     // (64, DP) rotated q * scale * log2(e) of a query tile
  T* gs = qs + kBlockQ * S::kTile;     // (64, DP) g of that tile
  float* ss = reinterpret_cast<float*>(gs + kBlockQ * S::kTile);  // (64 keys, 64 queries)
  float* dks = ss + kBlockK * kLdS;    // (64, DP) dk accumulator (before rope_vjp)
  float* dvs = dks + kBlockK * S::kOut;  // (64, DP) dv accumulator
  float* lse_s = dvs + kBlockK * S::kOut;  // (64,) the query tile's lse2
  float* delta_s = lse_s + kBlockQ;        // (64,) and delta

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int width = heads * d;  // C
  const int64_t row_stride = 3LL * width;
  const T* src = qkv + static_cast<int64_t>(b) * seq * row_stride;
  const T* g_b = g + static_cast<int64_t>(b) * seq * width;
  T* dst = dqkv + static_cast<int64_t>(b) * seq * row_stride;
  const float* cos_b = cos_t + static_cast<int64_t>(b) * seq * d;
  const float* sin_b = sin_t + static_cast<int64_t>(b) * seq * d;
  const int64_t stat0 = static_cast<int64_t>(b) * seq * heads + h;  // (b, row 0, h) of lse/delta
  const int len = min(max(lengths[b], 1), seq);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (k0 >= len) {  // masked keys: dk = dv = 0
    constexpr int kChunksPerRow = DP / 8;
    const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < kBlockK * kChunksPerRow; i += kThreads) {
      const int row = k0 + i / kChunksPerRow;
      const int c = (i % kChunksPerRow) * 8;
      if (row < seq && c < d) {
        store8(dst + row * row_stride + width + h * d + c, zero);
        store8(dst + row * row_stride + 2 * width + h * d + c, zero);
      }
    }
    return;
  }

  load_rotated<T, DP>(ks, src, cos_b, sin_b, row_stride, width + h * d, k0, len, d, 1.f);
  load_plain<T, DP>(vs, src, row_stride, 2 * width + h * d, k0, len, d);
  for (int i = threadIdx.x; i < 2 * kBlockK * S::kOut; i += kThreads) dks[i] = 0.f;

  const T* kw = ks + warp * kRowsPerWarp * S::kTile;
  const T* vw = vs + warp * kRowsPerWarp * S::kTile;
  float* sw = ss + warp * kRowsPerWarp * kLdS;
  T* pw = reinterpret_cast<T*>(sw);
  float* dkw = dks + warp * kRowsPerWarp * S::kOut;
  float* dvw = dvs + warp * kRowsPerWarp * S::kOut;

  // Two lanes per key row: lane 2r + half owns key row r and query columns
  // [32*half, 32*half + 32) of each tile.
  const int my_row = lane >> 1;
  const int half = lane & 1;
  const int j0 = half * 32;
  const bool key_ok = k0 + warp * kRowsPerWarp + my_row < len;

  for (int q0 = 0; q0 < seq; q0 += kBlockQ) {
    __syncthreads();  // the previous query tile is consumed
    load_rotated<T, DP>(qs, src, cos_b, sin_b, row_stride, h * d, q0, seq, d, q_mul);
    load_plain<T, DP>(gs, g_b, width, h * d, q0, seq, d);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      const bool ok = q0 + i < seq;
      lse_s[i] = ok ? lse[stat0 + static_cast<int64_t>(q0 + i) * heads] : 0.f;
      delta_s[i] = ok ? delta[stat0 + static_cast<int64_t>(q0 + i) * heads] : 0.f;
    }
    __syncthreads();

    // p^T (16 keys, 64 queries), kept in registers and, rounded to T, in sw
    warp_scores<T, DP>(sw, kw, qs);
    __syncwarp();
    float p[32];
    {
      const float* srow = sw + my_row * kLdS + j0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = j0 + j;
        p[j] = (key_ok && q0 + col < seq) ? exp2f(srow[j] - lse_s[col]) : 0.f;
      }
    }
    __syncwarp();  // both lanes of a row have read it before P is written over it
    {
      T* prow = pw + my_row * S::kP + j0;
#pragma unroll
      for (int j = 0; j < 32; ++j) prow[j] = from_float<T>(p[j]);
    }
    __syncwarp();
    warp_accumulate_pv<T, DP>(dvw, pw, gs);  // dv += p^T g
    __syncwarp();

    // ds^T = p^T * (dp^T - delta), dp^T = v g^T, rounded to T in sw
    warp_scores<T, DP>(sw, vw, gs);
    __syncwarp();
    float dp[32];
    {
      const float* srow = sw + my_row * kLdS + j0;
#pragma unroll
      for (int j = 0; j < 32; ++j) dp[j] = srow[j];
    }
    __syncwarp();
    {
      T* prow = pw + my_row * S::kP + j0;
#pragma unroll
      for (int j = 0; j < 32; ++j) prow[j] = from_float<T>(p[j] * (dp[j] - delta_s[j0 + j]));
    }
    __syncwarp();
    warp_accumulate_pv<T, DP>(dkw, pw, qs);  // dk_r * scale * log2(e) += ds^T q_r
    __syncwarp();
  }

  const int row0 = k0 + warp * kRowsPerWarp;
  store_rows<T, DP>(dst + width + h * d, dkw, cos_b, sin_b, row0, seq, d, row_stride, dk_mul, true);
  store_rows<T, DP>(dst + 2 * width + h * d, dvw, cos_b, sin_b, row0, seq, d, row_stride, 1.f, false);
}

template <typename T, int DP>
constexpr size_t dq_smem_bytes() {
  using S = Strides<T, DP>;
  return 4 * kBlockQ * S::kTile * sizeof(T) + (kBlockQ * kLdS + kBlockQ * S::kOut) * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ qkv, const T* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ cos_t,
              const float* __restrict__ sin_t, const int* __restrict__ lengths,
              T* __restrict__ dqkv, int seq, int heads, int d, float q_mul, float dq_mul) {
  using S = Strides<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // (64, DP) rotated q * scale * log2(e)
  T* gs = qs + kBlockQ * S::kTile;     // (64, DP) g
  T* ks = gs + kBlockQ * S::kTile;     // (64, DP) rotated k of a key tile
  T* vs = ks + kBlockK * S::kTile;     // (64, DP) v
  float* ss = reinterpret_cast<float*>(vs + kBlockK * S::kTile);  // (64 queries, 64 keys)
  float* dqs = ss + kBlockQ * kLdS;    // (64, DP) dq accumulator (before rope_vjp)

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int width = heads * d;
  const int64_t row_stride = 3LL * width;
  const T* src = qkv + static_cast<int64_t>(b) * seq * row_stride;
  const T* g_b = g + static_cast<int64_t>(b) * seq * width;
  T* dst = dqkv + static_cast<int64_t>(b) * seq * row_stride;
  const float* cos_b = cos_t + static_cast<int64_t>(b) * seq * d;
  const float* sin_b = sin_t + static_cast<int64_t>(b) * seq * d;
  const int len = min(max(lengths[b], 1), seq);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_rotated<T, DP>(qs, src, cos_b, sin_b, row_stride, h * d, q0, seq, d, q_mul);
  load_plain<T, DP>(gs, g_b, width, h * d, q0, seq, d);
  for (int i = threadIdx.x; i < kBlockQ * S::kOut; i += kThreads) dqs[i] = 0.f;

  const T* qw = qs + warp * kRowsPerWarp * S::kTile;
  const T* gw = gs + warp * kRowsPerWarp * S::kTile;
  float* sw = ss + warp * kRowsPerWarp * kLdS;
  T* pw = reinterpret_cast<T*>(sw);
  float* dqw = dqs + warp * kRowsPerWarp * S::kOut;

  // Two lanes per query row: lane 2r + half owns row r and key columns
  // [32*half, 32*half + 32) of each tile.
  const int my_row = lane >> 1;
  const int half = lane & 1;
  const int j0 = half * 32;
  const int row = q0 + warp * kRowsPerWarp + my_row;
  const int64_t stat = (static_cast<int64_t>(b) * seq + row) * heads + h;
  const float lse_r = row < seq ? lse[stat] : 0.f;
  const float delta_r = row < seq ? delta[stat] : 0.f;

  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    __syncthreads();  // the previous key tile is consumed; q, g and dqs are written
    load_rotated<T, DP>(ks, src, cos_b, sin_b, row_stride, width + h * d, k0, len, d, 1.f);
    load_plain<T, DP>(vs, src, row_stride, 2 * width + h * d, k0, len, d);
    __syncthreads();

    warp_scores<T, DP>(sw, qw, ks);
    __syncwarp();
    float p[32];
    {
      const float* srow = sw + my_row * kLdS + j0;
#pragma unroll
      for (int j = 0; j < 32; ++j) p[j] = (k0 + j0 + j < len) ? exp2f(srow[j] - lse_r) : 0.f;
    }
    __syncwarp();
    warp_scores<T, DP>(sw, gw, vs);  // dp = g v^T, over the scores
    __syncwarp();
    float dp[32];
    {
      const float* srow = sw + my_row * kLdS + j0;
#pragma unroll
      for (int j = 0; j < 32; ++j) dp[j] = srow[j];
    }
    __syncwarp();
    {
      T* prow = pw + my_row * S::kP + j0;
#pragma unroll
      for (int j = 0; j < 32; ++j) prow[j] = from_float<T>(p[j] * (dp[j] - delta_r));
    }
    __syncwarp();
    warp_accumulate_pv<T, DP>(dqw, pw, ks);  // dq_r / scale += ds k_r
    __syncwarp();
  }

  store_rows<T, DP>(dst + h * d, dqw, cos_b, sin_b, q0 + warp * kRowsPerWarp, seq, d, row_stride,
                    dq_mul, true);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The arguments of one K2 call. bf16: `rot` holds q_r * q_mul then k_r,
// each (B, H, T, d) bf16, and `stats` lse2 then delta, each (B, H, T
// rounded up to 64) fp32. fp32: `stats` is delta (B, T, H) and `rot` is
// unused. `passes` selects the launches (1: prologue or delta, 2: dk/dv,
// 4: dq); a call makes all three, one pass alone is for timing it.
struct Args {
  const void *qkv, *g, *out;
  const float* lse;
  const float *cos_t, *sin_t;
  const int* lengths;
  void *dqkv, *rot;
  float* stats;
  int batch, seq, heads, head_dim;
  float q_mul, dq_mul, dk_mul;
  int passes;
};

template <int DP>
cudaError_t launch_fp32(const Args& a, cudaStream_t stream) {
  const float* qkv = static_cast<const float*>(a.qkv);
  const float* g = static_cast<const float*>(a.g);
  float* dqkv = static_cast<float*>(a.dqkv);
  cudaError_t err = cudaSuccess;
  if (a.passes & 1) {
    const int64_t n = static_cast<int64_t>(a.batch) * a.seq * a.heads;
    delta_kernel<float><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        g, static_cast<const float*>(a.out), a.stats, n, a.head_dim);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const dim3 grid((a.seq + kBlockQ - 1) / kBlockQ, a.heads, a.batch);
  if (a.passes & 2) {
    constexpr size_t smem = dkdv_smem_bytes<float, DP>();
    if ((err = set_smem(dkdv_kernel<float, DP>, smem)) != cudaSuccess) return err;
    dkdv_kernel<float, DP><<<grid, kThreads, smem, stream>>>(
        qkv, g, a.lse, a.stats, a.cos_t, a.sin_t, a.lengths, dqkv, a.seq, a.heads, a.head_dim,
        a.q_mul, a.dk_mul);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (a.passes & 4) {
    constexpr size_t smem = dq_smem_bytes<float, DP>();
    if ((err = set_smem(dq_kernel<float, DP>, smem)) != cudaSuccess) return err;
    dq_kernel<float, DP><<<grid, kThreads, smem, stream>>>(
        qkv, g, a.lse, a.stats, a.cos_t, a.sin_t, a.lengths, dqkv, a.seq, a.heads, a.head_dim,
        a.q_mul, a.dq_mul);
    err = cudaGetLastError();
  }
  return err;
}

template <int DP>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const bf16* qkv = static_cast<const bf16*>(a.qkv);
  const bf16* g = static_cast<const bf16*>(a.g);
  bf16* dqkv = static_cast<bf16*>(a.dqkv);
  const int seq_pad = (a.seq + kBlockQ - 1) / kBlockQ * kBlockQ;
  const int64_t n = static_cast<int64_t>(a.batch) * a.seq * a.heads;
  bf16* q_rot = static_cast<bf16*>(a.rot);
  bf16* k_rot = q_rot + n * a.head_dim;
  float* lse_h = a.stats;
  float* delta_h = lse_h + static_cast<int64_t>(a.batch) * a.heads * seq_pad;
  cudaError_t err = cudaSuccess;
  if (a.passes & 1) {
    const unsigned blocks = static_cast<unsigned>((n + kPrologueRows - 1) / kPrologueRows);
    bwd_prologue_kernel<<<blocks, kPrologueRows * (a.head_dim / 8), 0, stream>>>(
        qkv, g, static_cast<const bf16*>(a.out), a.lse, a.cos_t, a.sin_t, q_rot, k_rot, lse_h, delta_h,
        a.batch, a.seq, seq_pad, a.heads, a.head_dim, a.q_mul);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const dim3 grid((a.seq + kBlockQ - 1) / kBlockQ, a.heads, a.batch);
  constexpr size_t smem = bwd_mma_smem_bytes<DP>();
  if (a.passes & 2) {
    if ((err = set_smem(bwd_dkdv_mma_kernel<DP>, smem)) != cudaSuccess) return err;
    bwd_dkdv_mma_kernel<DP><<<grid, kThreads, smem, stream>>>(
        qkv, g, q_rot, k_rot, lse_h, delta_h, a.cos_t, a.sin_t, a.lengths, dqkv, a.seq, seq_pad,
        a.heads, a.head_dim, a.dk_mul);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (a.passes & 4) {
    if ((err = set_smem(bwd_dq_mma_kernel<DP>, smem)) != cudaSuccess) return err;
    bwd_dq_mma_kernel<DP><<<grid, kThreads, smem, stream>>>(
        qkv, g, q_rot, k_rot, lse_h, delta_h, a.cos_t, a.sin_t, a.lengths, dqkv, a.seq, seq_pad,
        a.heads, a.head_dim, a.dq_mul);
    err = cudaGetLastError();
  }
  return err;
}

// The compiled head-dim paddings, as in the forward: d pads to the smallest DP >= d.
template <bool BF16>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  const auto run = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    if constexpr (BF16) {
      return launch_bf16<DP>(a, stream);
    } else {
      return launch_fp32<DP>(a, stream);
    }
  };
  if (a.head_dim <= 16) return run(std::integral_constant<int, 16>{});
  if (a.head_dim <= 32) return run(std::integral_constant<int, 32>{});
  if (a.head_dim <= 64) return run(std::integral_constant<int, 64>{});
  if (a.head_dim <= 80) return run(std::integral_constant<int, 80>{});
  return run(std::integral_constant<int, 128>{});
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launches were accepted. qkv, g, out
// and dqkv are in one dtype (is_bf16: bf16, else fp32); lse is the
// forward's (B, T, H) fp32 log2-sum-exp. Scratch: with bf16, rot is (2, B,
// H, T, head_dim) bf16 and stats (2, B, H, T rounded up to 64) fp32; with
// fp32, rot is unused and stats is (B, T, H) fp32. passes is 7 for a whole
// call (1, 2, 4: one pass alone, reading what the earlier passes wrote).
// head_dim is a multiple of 8, at most 128.
int rope_attention_bwd(const void* qkv, const void* g, const void* out, const void* lse,
                       const void* cos_t, const void* sin_t, const void* lengths, void* dqkv,
                       void* rot, void* stats, int batch, int seq, int heads, int head_dim,
                       float scale, int is_bf16, int passes, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || head_dim < 8 || head_dim % 8 || head_dim > 128 ||
      passes < 1 || passes > 7 || (is_bf16 && rot == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr float kLog2E = 1.4426950408889634f;
  const Args a{qkv, g, out, static_cast<const float*>(lse), static_cast<const float*>(cos_t),
               static_cast<const float*>(sin_t), static_cast<const int*>(lengths), dqkv, rot,
               static_cast<float*>(stats), batch, seq, heads, head_dim, scale * kLog2E, scale,
               1.f / kLog2E, passes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch<true>(a, s) : dispatch<false>(a, s));
}

const char* rope_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
