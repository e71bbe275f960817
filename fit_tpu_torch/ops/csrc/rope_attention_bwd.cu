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
// What bounds it on the H100 (3.35 TB/s; 989 TFLOP/s bf16; fp32-accurate
// products as three TF32 products at 495 TFLOP/s, i.e. 165): at FiT-B/2
// training, micro-batch 64 x T 256 x H 12 x d 64, it must read qkv, g, out,
// cos/sin and lse and write dqkv, ~210 MB in bf16 (~63 us) and ~412 MB in
// fp32 (~123 us), against 5 products of 2 * T * len * d per (batch row,
// head) over the valid keys, 16.8 GFLOP (~17 us in bf16, ~102 us in fp32):
// bytes bound it in both. At XL T 4096 (B 1, H 16, d 72, length 4000) the 5
// products (189 GFLOP) take ~191 us in bf16 and ~1144 us in fp32:
// operations bound it.
//
// Design: three launches and no atomics, so two runs on the same inputs
// agree bit for bit (a resumed training run repeats its loss stream). A
// prologue (bwd_prologue_kernel, rope_attention_bwd_mma.cuh) writes delta,
// the rotated q and k once in the activations' type and the head-major
// lse2 and delta into scratch the wrapper allocates; then a dk/dv pass (a
// block per 64 keys, looping over every query tile) and a dq pass (a block
// per 64 queries, looping over the keys below the length), with the
// scores, probabilities and accumulators in registers and the streamed
// tiles in two-stage cp.async rings. Both passes recompute S and dP, so it
// does 7 products where 5 would do: fusing the dq pass into the dk/dv pass
// would need atomics or a (T / 64)-deep fp32 buffer of partial dq.
// - bf16 (rope_attention_bwd_mma.cuh): mma.sync m16n8k16, P and dS rounded
//   to bf16 as A fragments, 64-row streamed tiles in two 32-column steps.
// - fp32 (rope_attention_bwd_tf32.cuh): each product as three TF32
//   mma.sync m16n8k8 of split operands (3xTF32, the fp32 K1's scheme), P
//   and dS kept in fp32 and split only as A fragments, 32-row streamed
//   tiles, so that the six fp32 tiles fit two blocks an SM at DP 80.

#include "rope_attention_bwd_tf32.cuh"

namespace {

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The arguments of one K2 call. `rot` holds q_r * q_mul then k_r, each (B,
// H, T, d) in the activations' type, and `stats` lse2 then delta, each (B,
// H, T rounded up to 64) fp32. `passes` selects the launches (1: prologue,
// 2: dk/dv, 4: dq); a call makes all three, one pass alone is for timing it.
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

// The dk/dv and dq passes of an activation type (one signature), and the
// shared memory each takes.
template <typename K>
struct PassKernels {
  K dkdv, dq;
  size_t smem;
};

template <int DP>
PassKernels<decltype(&bwd_dkdv_mma_kernel<DP>)> pass_kernels(const bf16*) {
  return {bwd_dkdv_mma_kernel<DP>, bwd_dq_mma_kernel<DP>, bwd_mma_smem_bytes<DP>()};
}

template <int DP>
PassKernels<decltype(&bwd_dkdv_tf32_kernel<DP>)> pass_kernels(const float*) {
  return {bwd_dkdv_tf32_kernel<DP>, bwd_dq_tf32_kernel<DP>, bwd_tf32_smem_bytes<DP>()};
}

template <typename T, int DP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const T* qkv = static_cast<const T*>(a.qkv);
  const T* g = static_cast<const T*>(a.g);
  T* dqkv = static_cast<T*>(a.dqkv);
  const int seq_pad = (a.seq + kBlockQ - 1) / kBlockQ * kBlockQ;
  const int64_t n = static_cast<int64_t>(a.batch) * a.seq * a.heads;
  T* q_rot = static_cast<T*>(a.rot);
  T* k_rot = q_rot + n * a.head_dim;
  float* lse_h = a.stats;
  float* delta_h = lse_h + static_cast<int64_t>(a.batch) * a.heads * seq_pad;
  cudaError_t err = cudaSuccess;
  if (a.passes & 1) {
    const unsigned blocks = static_cast<unsigned>((n + kPrologueRows - 1) / kPrologueRows);
    bwd_prologue_kernel<T><<<blocks, kPrologueRows * (a.head_dim / 8), 0, stream>>>(
        qkv, g, static_cast<const T*>(a.out), a.lse, a.cos_t, a.sin_t, q_rot, k_rot, lse_h, delta_h,
        a.batch, a.seq, seq_pad, a.heads, a.head_dim, a.q_mul);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const auto pk = pass_kernels<DP>(qkv);
  const dim3 grid((a.seq + kBlockQ - 1) / kBlockQ, a.heads, a.batch);
  if (a.passes & 2) {
    const auto dkdv = pk.dkdv;
    if ((err = set_smem(dkdv, pk.smem)) != cudaSuccess) return err;
    dkdv<<<grid, kThreads, pk.smem, stream>>>(qkv, g, q_rot, k_rot, lse_h, delta_h, a.cos_t, a.sin_t,
                                                  a.lengths, dqkv, a.seq, seq_pad, a.heads, a.head_dim,
                                                  a.dk_mul);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (a.passes & 4) {
    const auto dq = pk.dq;
    if ((err = set_smem(dq, pk.smem)) != cudaSuccess) return err;
    dq<<<grid, kThreads, pk.smem, stream>>>(qkv, g, q_rot, k_rot, lse_h, delta_h, a.cos_t, a.sin_t,
                                                a.lengths, dqkv, a.seq, seq_pad, a.heads, a.head_dim,
                                                a.dq_mul);
    err = cudaGetLastError();
  }
  return err;
}

// The compiled head-dim paddings, as in the forward: d pads to the smallest DP >= d.
template <bool BF16>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  const auto run = [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return launch<std::conditional_t<BF16, bf16, float>, DP>(a, stream);
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
// forward's (B, T, H) fp32 log2-sum-exp. Scratch: rot is (2, B, H, T,
// head_dim) in that dtype and stats (2, B, H, T rounded up to 64) fp32.
// passes is 7 for a whole call (1, 2, 4: one pass alone, reading what the
// earlier passes wrote). head_dim is a multiple of 8, at most 128.
int rope_attention_bwd(const void* qkv, const void* g, const void* out, const void* lse,
                       const void* cos_t, const void* sin_t, const void* lengths, void* dqkv,
                       void* rot, void* stats, int batch, int seq, int heads, int head_dim,
                       float scale, int is_bf16, int passes, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || head_dim < 8 || head_dim % 8 || head_dim > 128 ||
      passes < 1 || passes > 7 || rot == nullptr) {
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
