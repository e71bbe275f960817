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
// Design, fp32 (rope_attention_tf32.cuh): the bf16 kernel's blocks, key
// loop, cp.async ring and register-resident scores and output, on mma.sync
// m16n8k8 TF32 products taken three at a time (3xTF32: each operand split
// into a TF32 high part and a TF32 remainder), which hold the kernel
// against the fp32 plain version at 1e-4, where one TF32 product would
// move it by ~8e-4. At DiT-XL/2 512^2 the 77 GFLOP bound it at ~470 us on the
// card's 165 TFLOP/s of fp32-accurate products (a third of the 495 TF32
// rate); at T 256 bytes do. Each product also splits its operands (two
// conversions and a subtraction per fp32 value), so issue slots, not
// memory, set its time.
//
// With a non-null `lse` both kernels also write each row's log2-sum-exp,
// lse2 = m + log2(l) from the running max and sum they keep, as a (B, T,
// H) fp32 tensor: the residual of the backward (rope_attention_bwd.cu),
// which recomputes the probabilities as exp2(s - lse2) from the same
// rotated, scaled and rounded q (load_rotated in rope_tiles.cuh). The fp32
// K2 recomputes its scores on the same 3xTF32 products, in another k order
// and from its prologue's rotation, so they differ from the scores the lse
// came from by ~1e-6, inside its 1e-4 bar. A null `lse` (sampling,
// serving) changes nothing else.

#include "rope_attention_mma.cuh"
#include "rope_attention_tf32.cuh"
#include "rope_tiles.cuh"

namespace {

struct Args {
  const void *q, *k, *v;
  void* out;
  Layout lq, lk, lv, lo;
  const void *cos_t, *sin_t, *lengths;
  float* lse;
  int batch, seq, heads, head_dim;
  float q_mul;
};

// bf16 runs the bf16 mma.sync kernel (rope_attention_mma.cuh), fp32 the
// 3xTF32 one (rope_attention_tf32.cuh).
template <typename T, int DP, bool ROPE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr size_t smem = kBf16 ? mma_smem_bytes<DP>() : tf32_smem_bytes<DP>();
  const auto kernel = [] {
    if constexpr (kBf16) {
      return rope_attention_mma_kernel<DP, ROPE>;
    } else {
      return rope_attention_tf32_kernel<DP, ROPE>;
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
