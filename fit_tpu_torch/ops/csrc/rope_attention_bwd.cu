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
// Design: three kernels and no atomics, so the result is deterministic.
//   delta: one thread per (row, head), rowsum(g * out) in fp32.
//   dk/dv: one block per (key tile of 64, head, batch row); k_r and v stay in
//          shared memory while a loop walks every 64-row query tile; each warp
//          owns 16 keys and accumulates their dk and dv in fp32.
//   dq:    one block per (query tile of 64, head, batch row), looping over the
//          key tiles below lengths[b]; each warp owns 16 query rows.
// Both passes recompute the scores from the rotated tiles (the loaders of
// rope_tiles.cuh, the forward's arithmetic) and use the two per-warp WMMA
// products of the forward (scores = A B^T, acc += P V), bf16 in and fp32
// accumulation; fp32 inputs run the same schedule on fp32 FMA dots. Each
// warp keeps one fp32 score tile: the scores, then p in registers and p (or
// ds) in the input dtype written over it, then dp over it again.
//
// Bound at FiT-B/2 training, micro-batch 64 x T 256 x H 12 x d 64 (bf16):
// it must read qkv, g, out, cos/sin and lse (~135 MB) and write dqkv (75.5
// MB), ~63 us at 3.35 TB/s, against 5 products of 2*B*H*T^2*d = 32 GFLOP,
// ~33 us at 989 TFLOP/s: memory-bound at this T. This simple version reads
// each q/g tile once per key tile and recomputes the scores in both passes,
// so it moves several times the minimum and runs on mma.sync-class WMMA;
// TMA, WGMMA and a fused single pass are left for later work.

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
  // multiple of 32 bytes, which keeps every WMMA tile pointer aligned.
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

template <typename T, int DP>
cudaError_t launch(const void* qkv, const void* g, const void* out, const float* lse,
                   float* delta, const float* cos_t, const float* sin_t, const int* lengths,
                   void* dqkv, int batch, int seq, int heads, int head_dim, float q_mul,
                   float dq_mul, float dk_mul, cudaStream_t stream) {
  const T* qkv_t = static_cast<const T*>(qkv);
  const T* g_t = static_cast<const T*>(g);
  T* dqkv_t = static_cast<T*>(dqkv);
  const int64_t n = static_cast<int64_t>(batch) * seq * heads;
  delta_kernel<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      g_t, static_cast<const T*>(out), delta, n, head_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  constexpr size_t dkdv_smem = dkdv_smem_bytes<T, DP>();
  if ((err = set_smem(dkdv_kernel<T, DP>, dkdv_smem)) != cudaSuccess) return err;
  dkdv_kernel<T, DP><<<grid, kThreads, dkdv_smem, stream>>>(
      qkv_t, g_t, lse, delta, cos_t, sin_t, lengths, dqkv_t, seq, heads, head_dim, q_mul, dk_mul);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr size_t dq_smem = dq_smem_bytes<T, DP>();
  if ((err = set_smem(dq_kernel<T, DP>, dq_smem)) != cudaSuccess) return err;
  dq_kernel<T, DP><<<grid, kThreads, dq_smem, stream>>>(
      qkv_t, g_t, lse, delta, cos_t, sin_t, lengths, dqkv_t, seq, heads, head_dim, q_mul, dq_mul);
  return cudaGetLastError();
}

// The compiled head-dim paddings, as in the forward: d pads to the smallest DP >= d.
template <typename T>
cudaError_t dispatch(const void* qkv, const void* g, const void* out, const float* lse,
                     float* delta, const float* cos_t, const float* sin_t, const int* lengths,
                     void* dqkv, int batch, int seq, int heads, int head_dim, float q_mul,
                     float dq_mul, float dk_mul, cudaStream_t stream) {
#define FIT_BWD_LAUNCH(DP)                                                                     \
  launch<T, DP>(qkv, g, out, lse, delta, cos_t, sin_t, lengths, dqkv, batch, seq, heads, head_dim, \
                q_mul, dq_mul, dk_mul, stream)
  if (head_dim <= 16) return FIT_BWD_LAUNCH(16);
  if (head_dim <= 32) return FIT_BWD_LAUNCH(32);
  if (head_dim <= 64) return FIT_BWD_LAUNCH(64);
  if (head_dim <= 80) return FIT_BWD_LAUNCH(80);
  return FIT_BWD_LAUNCH(128);
#undef FIT_BWD_LAUNCH
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when all three launches were accepted. qkv, g,
// out and dqkv are in one dtype (is_bf16: bf16, else fp32); lse is the
// forward's (B, T, H) fp32 log2-sum-exp; delta is (B, T, H) fp32 scratch.
// q_mul is scale * log2(e), as in the forward. head_dim is a multiple of 8,
// at most 128.
int rope_attention_bwd(const void* qkv, const void* g, const void* out, const void* lse,
                       void* delta, const void* cos_t, const void* sin_t, const void* lengths,
                       void* dqkv, int batch, int seq, int heads, int head_dim, float scale,
                       int is_bf16, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || head_dim < 8 || head_dim % 8 || head_dim > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr float kLog2E = 1.4426950408889634f;
  const float q_mul = scale * kLog2E;
  const float dk_mul = 1.f / kLog2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  const float* cos_f = static_cast<const float*>(cos_t);
  const float* sin_f = static_cast<const float*>(sin_t);
  const int* len_i = static_cast<const int*>(lengths);
  const cudaError_t err =
      is_bf16 ? dispatch<bf16>(qkv, g, out, lse_f, delta_f, cos_f, sin_f, len_i, dqkv, batch, seq,
                               heads, head_dim, q_mul, scale, dk_mul, s)
              : dispatch<float>(qkv, g, out, lse_f, delta_f, cos_f, sin_f, len_i, dqkv, batch, seq,
                                heads, head_dim, q_mul, scale, dk_mul, s);
  return static_cast<int>(err);
}

const char* rope_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
