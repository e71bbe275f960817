// Fused 2D-RoPE + prefix-masked attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels fit_tpu/ops/fused_attention.py::_qkv_kernel
// (natural (B, T, 3C) layout), ::_kernel (head-major layout),
// ::_kernel_direct ((B, T, H, d) blocks) and the forward of
// ::_qkv_chunked_kernel with its lse output (below). All compute
//
//   q_rot = q*cos + rot(q)*sin,  k_rot = k*cos + rot(k)*sin,  rot(a, b) = (-b, a)
//   out   = softmax over valid keys (q_rot k_rot^T * scale) v
//
// for every query row, padded rows included, so no row is ever all -inf.
// With null cos/sin tables (the ROPE=false instantiation) q and k are taken
// as they are, which replaces fit_tpu/ops/attention.py::_flash_kernel, the
// blocked attention without RoPE. That kernel writes zeros for 128-row query
// blocks wholly past the length; this one gives those rows the softmax over
// the valid keys too (both are discarded downstream).
//
// Layout: q, k, v and out are (B, T, H, d) operands read and written by
// element strides (batch, token, head), so one kernel serves the (B, T, 3C)
// qkv projection (token stride 3C, head stride d, k and v at offsets C and
// 2C), (B, T, H, d) tensors and (B, H, T, d) views, with no copy. cos/sin
// are the pair-duplicated fp32 (B, T, d) tables; lengths is (B,) int32. The
// head dim d is a multiple of 8 (at most 128) and contiguous, every stride a
// multiple of 8 elements and every base 16-byte aligned, so every row
// segment moves as 16-byte vectors; the wrapper checks all of this.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s), at the main
// paths' shapes: FiT-XL/2 sampling (B 16, T 256, H 16, d 72, RoPE, mixed
// lengths) and FiT-B/2 training (B 64, T 256, H 12, d 64, RoPE, lse) move
// ~40 and ~110 MB for ~5 and ~7 GFLOP, so bytes bound them (~12 and ~33
// us); DiT-XL/2 at 512^2 (B 16 with CFG, T 1024, H 16, d 72, no RoPE) does
// 4*B*H*T^2*d = 77 GFLOP against ~151 MB, so operations bound it (~78 us).
// At T 256 a call is a few waves of short blocks, and tile latency and
// launch count set its time; at T 1024 the key loop's work does (the two
// products, their fragment reads and the softmax between them).
//
// Design, bf16 (rope_attention_mma.cuh). One block per (query tile of 64
// rows, head, batch row), 4 warps of 16 query rows; a loop over 64-key
// tiles takes the place of the TPU's sequential grid and stops at
// lengths[b], the last tile masking by column. Scores and the output
// accumulator stay in registers: both products run on mma.sync m16n8k16
// with fp32 accumulation, q as A fragments loaded once, k and v as B
// fragments by ldmatrix (.trans for v), and the probabilities go from the
// score accumulators straight into the second product's A fragments. The
// online softmax runs on the quad of lanes that shares a row, in the exp2
// domain (scale * log2(e) is folded into q while it is rotated). Key and
// value tiles stream through a two-stage shared-memory ring by cp.async,
// the next tile's copies in flight during this tile's products; with RoPE,
// each thread rotates its own chunks of the next key tile in place once
// they land. The head dim is zero-padded to DP, a multiple of 16 (d = 72
// pads to 80); the padding never reaches the output. The probabilities are
// rounded to bf16 before both the PV product and the row sum, so o / l
// averages the same values the product consumed.
//
// Design, fp32: the schedule that preceded the bf16 kernel, kept as it was
// (rope_attention_kernel below): the same blocks and key loop, synchronous
// tile loads between two barriers, the scores and output accumulator in
// shared memory, fp32 FMA dots, two lanes per softmax row. It exists to
// hold the kernel against the fp32 reference at 1e-4; tensor cores cannot
// serve it.
//
// With a non-null `lse` both kernels also write each row's log2-sum-exp,
// lse2 = m + log2(l) from the running max and sum they keep, as a (B, T,
// H) fp32 tensor: the residual of the backward (rope_attention_bwd.cu),
// which recomputes the probabilities as exp2(s - lse2) from the same
// rotated, scaled and rounded q (load_rotated in rope_tiles.cuh). A null
// `lse` (sampling, serving) changes nothing else.

#include "rope_attention_mma.cuh"
#include "rope_tiles.cuh"

namespace {

template <typename T, int DP>
constexpr size_t smem_bytes() {
  return 3 * kBlockQ * Strides<T, DP>::kTile * sizeof(T) +
         (kBlockQ * kLdS + kBlockQ * Strides<T, DP>::kOut) * sizeof(float);
}

template <typename T, int DP, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    rope_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          T* __restrict__ out, Layout lq, Layout lk, Layout lv, Layout lo,
                          const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                          const int* __restrict__ lengths, float* __restrict__ lse, int seq, int heads,
                          int d, float q_mul) {
  // Every region is a multiple of 128 bytes long and each 16-row slab a
  // multiple of 32 bytes, which keeps every 16-byte vector access aligned.
  using S = Strides<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // (64, DP) rotated q * scale * log2(e)
  T* ks = qs + kBlockQ * S::kTile;     // (64, DP) rotated k
  T* vs = ks + kBlockK * S::kTile;     // (64, DP) v
  float* ss = reinterpret_cast<float*>(vs + kBlockK * S::kTile);  // (64, 64) scores, then P
  float* os = ss + kBlockQ * kLdS;     // (64, DP) unnormalised output

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  // this (batch row, head)'s (T, d) matrix of each operand, rows lX.t apart
  const T* qb = q + b * lq.b + h * lq.h;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;
  T* ob = out + b * lo.b + h * lo.h;
  const float* cos_b = ROPE ? cos_t + b * seq * d : nullptr;
  const float* sin_b = ROPE ? sin_t + b * seq * d : nullptr;
  const int len = min(max(lengths[b], 1), seq);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_rotated<T, DP, ROPE>(qs, qb, cos_b, sin_b, lq.t, 0, q0, seq, d, q_mul);
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
    if constexpr (ROPE) {
      load_rotated<T, DP>(ks, kb, cos_b, sin_b, lk.t, 0, k0, len, d, 1.f);
    } else {
      load_plain<T, DP>(ks, kb, lk.t, 0, k0, len, d);
    }
    load_plain<T, DP>(vs, vb, lv.t, 0, k0, len, d);
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
  if (half == 0) {
    sw[my_row] = l_run;
    const int row = q0 + warp * kRowsPerWarp + my_row;
    if (lse != nullptr && row < seq) {
      lse[(b * seq + row) * heads + h] = m_run + log2f(l_run);
    }
  }
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
      store8(ob + row * lo.t + c, o);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  Layout lq, lk, lv, lo;
  const void *cos_t, *sin_t, *lengths;
  float* lse;
  int batch, seq, heads, head_dim;
  float q_mul;
};

// bf16 runs the mma.sync kernel (rope_attention_mma.cuh), fp32 the FMA one.
template <typename T, int DP, bool ROPE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr size_t smem = kMma ? mma_smem_bytes<DP>() : smem_bytes<T, DP>();
  const auto kernel = [] {
    if constexpr (kMma) {
      return rope_attention_mma_kernel<DP, ROPE>;
    } else {
      return rope_attention_kernel<T, DP, ROPE>;
    }
  }();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kBlockQ - 1) / kBlockQ, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.lq, a.lk, a.lv, a.lo, static_cast<const float*>(a.cos_t),
      static_cast<const float*>(a.sin_t), static_cast<const int*>(a.lengths), a.lse, a.seq, a.heads,
      a.head_dim, a.q_mul);
  return cudaGetLastError();
}

// The compiled head-dim paddings: d pads to the smallest DP >= d.
template <typename T, bool ROPE>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.head_dim <= 16) return launch<T, 16, ROPE>(a, stream);
  if (a.head_dim <= 32) return launch<T, 32, ROPE>(a, stream);
  if (a.head_dim <= 64) return launch<T, 64, ROPE>(a, stream);
  if (a.head_dim <= 80) return launch<T, 80, ROPE>(a, stream);
  return launch<T, 128, ROPE>(a, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. q, k, v and out
// are (B, T, H, d) with element strides (b, t, h) each, the head dim
// contiguous; every stride a multiple of 8 elements and every base pointer
// 16-byte aligned. cos_t and sin_t are (B, T, d) fp32, or both null for
// attention without RoPE. q_mul is scale * log2(e). is_bf16 selects bf16
// (1) or fp32 (0) operands. head_dim must be a multiple of 8, at most 128.
// lse is null, or a (B, T, H) fp32 output for each row's log2-sum-exp.
int rope_attention_fwd(const void* q, const void* k, const void* v, void* out, int64_t qb,
                       int64_t qt, int64_t qh, int64_t kb, int64_t kt, int64_t kh, int64_t vb,
                       int64_t vt, int64_t vh, int64_t ob, int64_t ot, int64_t oh,
                       const void* cos_t, const void* sin_t, const void* lengths, void* lse,
                       int batch, int seq, int heads, int head_dim, float q_mul, int is_bf16,
                       void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || head_dim < 8 || head_dim % 8 || head_dim > 128 ||
      (cos_t == nullptr) != (sin_t == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, out, {qb, qt, qh}, {kb, kt, kh}, {vb, vt, vh}, {ob, ot, oh},
               cos_t, sin_t, lengths, static_cast<float*>(lse), batch, seq, heads, head_dim,
               q_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rope = cos_t != nullptr;
  cudaError_t err;
  if (is_bf16) {
    err = rope ? dispatch<bf16, true>(a, s) : dispatch<bf16, false>(a, s);
  } else {
    err = rope ? dispatch<float, true>(a, s) : dispatch<float, false>(a, s);
  }
  return static_cast<int>(err);
}

const char* rope_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
