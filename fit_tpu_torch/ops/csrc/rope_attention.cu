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
// 4*B*H*T^2*d = 77 GFLOP against ~151 MB, so operations bound it (~78 us);
// so do FLUX.1-schnell's joint attention (B 4, T 4352, H 24, d 128, RoPE:
// 931 GFLOP, ~941 us) and FiT-XL/2 at 1024^2 (12 guided rows, T 4096, H
// 16, d 72: 928 GFLOP, ~938 us). At T 256 a call is a few waves of short
// blocks, and tile latency, the pre-pass and launch count set its time; at
// T >= 1024 the key loop's tensor-core work does.
//
// Design, bf16 (rope_attention_sm90.cuh). TMA copies tiles and cannot
// rotate them, so with RoPE a pre-pass (rope_attention_kernel_rotate_k)
// rotates K once per call into a contiguous bf16 (B, H, T_pad, DP) scratch
// that the wrapper allocates, zero past each row's length and past d. It
// reads K and the tables and writes K once: ~230 MB, ~70 us, at FLUX's
// shape, where rotating each key tile in every query block that reads it
// would repeat that work T / 128 = 34 times over. Then the key loop
// (rope_attention_kernel_sm90): a block per (128 query rows, head, batch
// row) with a producer warpgroup, one thread of which keeps two stages of
// 128-key K and V tiles in flight by TMA behind mbarriers (K from the
// scratch, or from the caller's view without RoPE; V from the caller's
// view; the tensor map's zero fill pads d to DP), and two consumer
// warpgroups of 64 query rows. setmaxnreg moves registers from the producer
// (24) to the consumers (240). Each consumer rotates and scales its q on
// load into shared memory once; per key tile, S = Q K^T is a wgmma from
// shared-memory descriptors into fp32 registers, the online softmax runs
// in the exp2 domain on the quad of lanes that shares a row (keys at or
// past the length masked on the last tile; P rounded to bf16 before both
// the row sum and the product, so o / l averages the values the product
// consumed), and O += P V is a wgmma with P's A fragments in registers and
// V N-major in shared memory. Tiles are stored in 128-byte swizzle atoms
// from DP 64 up; at DP 80 the products stop at column 80, so d 72 costs
// DP 80's tensor-core work and not DP 128's. Each warpgroup runs its two
// products and its softmax in turn, so the tensor cores wait on a
// warpgroup's softmax unless the other warpgroup's products fill them.

// Design, fp32 (rope_attention_tf32.cuh): one block per (64-query tile,
// head, batch row), 4 warps of 16 query rows, a loop over 64-key tiles
// through a two-stage cp.async ring (each thread rotating its own chunks of
// K as they land), scores and output in registers, on mma.sync m16n8k8 TF32
// products taken three at a time (3xTF32: each operand split
// into a TF32 high part and a TF32 remainder), which hold the kernel
// against the fp32 plain version at 1e-4, where one TF32 product would
// move it by ~8e-4. At DiT-XL/2 512^2 the 77 GFLOP bound it at ~470 us on the
// card's 165 TFLOP/s of fp32-accurate products (a third of the 495 TF32
// rate); at T 256 bytes do. Each product also splits its operands (two
// conversions and a subtraction per fp32 value), so issue slots, not
// memory, set its time.
//
// Cross-attention (cross_attention_fwd, bf16): the same key loop
// (cross_attention_kernel_sm90, sm90_block) with the keys and values of a
// sequence of their own, kseq rows, and no RoPE: Wan2.1's video rows over
// its 512 text rows. Only the clamp of each row's key length and the tensor
// maps' row count differ from the self-attention kernel; its own name lets
// a trace tell the two apart. At Wan2.1-T2V-14B's shape (B 2, Tq 32,760, Tk
// 512, H 40, d 128: 687 GFLOP, ~1.36 GB) a call is four key tiles a block,
// so q's load and the epilogue weigh as much as the products.
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

#include "rope_attention_sm90.cuh"
#include "rope_attention_tf32.cuh"

namespace {

struct Args {
  const void *q, *k, *v;
  void* out;
  Layout lq, lk, lv, lo;
  const void *cos_t, *sin_t, *lengths;
  float* lse;
  void* kscratch;
  int batch, seq, heads, head_dim;
  float q_mul;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (the
// library links no libcuda), or null.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// The 4D (cols, rows, heads, batch) bf16 tensor map of a key or value
// operand with these element strides (rows, heads, batch), in boxes of
// (kAtom, kKeyTile, 1, 1) with the layout's swizzle; reads past cols or
// rows give zeros. A dimension of size 1 has stride 0 from the wrapper and
// gets a packed one (TMA wants a non-zero multiple of 16 bytes).
template <int DP>
cudaError_t key_map(CUtensorMap* map, const void* base, int cols, int rows, int heads, int batch, int64_t st,
                    int64_t sh, int64_t sb) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  st = st ? st : cols;
  sh = sh ? sh : st * rows;
  sb = sb ? sb : sh * heads;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {Sm90Layout<DP>::kAtom, kKeyTile, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  constexpr int atom_bytes = Sm90Layout<DP>::kAtomBytes;
  const CUtensorMapSwizzle swizzle = atom_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : atom_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16: the K pre-pass (with RoPE), then the TMA-fed wgmma kernel
// (rope_attention_sm90.cuh).
template <int DP, bool ROPE>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const bf16* k = static_cast<const bf16*>(a.k);
  CUtensorMap kmap, vmap;
  cudaError_t err;
  if constexpr (ROPE) {
    const int t_pad = (a.seq + kKeyTile - 1) / kKeyTile * kKeyTile;
    const int64_t chunks = static_cast<int64_t>(a.batch) * a.heads * t_pad * (DP / 8);
    const unsigned blocks = static_cast<unsigned>((chunks + kRotateThreads - 1) / kRotateThreads);
    rope_attention_kernel_rotate_k<DP><<<blocks, kRotateThreads, 0, stream>>>(
        k, a.lk, static_cast<const float*>(a.cos_t), static_cast<const float*>(a.sin_t),
        static_cast<const int*>(a.lengths), static_cast<bf16*>(a.kscratch), a.batch, a.seq, t_pad, a.heads,
        a.head_dim);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = key_map<DP>(&kmap, a.kscratch, DP, t_pad, a.heads, a.batch, DP, static_cast<int64_t>(t_pad) * DP,
                      static_cast<int64_t>(a.heads) * t_pad * DP);
  } else {
    err = key_map<DP>(&kmap, k, a.head_dim, a.seq, a.heads, a.batch, a.lk.t, a.lk.h, a.lk.b);
  }
  if (err != cudaSuccess) return err;
  err = key_map<DP>(&vmap, a.v, a.head_dim, a.seq, a.heads, a.batch, a.lv.t, a.lv.h, a.lv.b);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = sm90_smem_bytes<DP>();
  const auto kernel = rope_attention_kernel_sm90<DP, ROPE>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kSm90Rows - 1) / kSm90Rows, a.heads, a.batch);
  kernel<<<grid, kSm90Threads, smem, stream>>>(
      kmap, vmap, static_cast<const bf16*>(a.q), static_cast<bf16*>(a.out), a.lq, a.lo,
      static_cast<const float*>(a.cos_t), static_cast<const float*>(a.sin_t), static_cast<const int*>(a.lengths),
      a.lse, a.seq, a.heads, a.head_dim, a.q_mul);
  return cudaGetLastError();
}

// bf16 cross-attention: the same key loop over kseq keys and values of
// their own, read by stride through the tensor maps, no RoPE, no lse.
template <int DP>
cudaError_t launch_cross(const Args& a, int kseq, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  cudaError_t err = key_map<DP>(&kmap, a.k, a.head_dim, kseq, a.heads, a.batch, a.lk.t, a.lk.h, a.lk.b);
  if (err != cudaSuccess) return err;
  err = key_map<DP>(&vmap, a.v, a.head_dim, kseq, a.heads, a.batch, a.lv.t, a.lv.h, a.lv.b);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = sm90_smem_bytes<DP>();
  const auto kernel = cross_attention_kernel_sm90<DP>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kSm90Rows - 1) / kSm90Rows, a.heads, a.batch);
  kernel<<<grid, kSm90Threads, smem, stream>>>(kmap, vmap, static_cast<const bf16*>(a.q), static_cast<bf16*>(a.out),
                                               a.lq, a.lo, static_cast<const int*>(a.lengths), a.seq, kseq, a.heads,
                                               a.head_dim, a.q_mul);
  return cudaGetLastError();
}

// fp32: the 3xTF32 mma.sync kernel (rope_attention_tf32.cuh).
template <int DP, bool ROPE>
cudaError_t launch_fp32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = tf32_smem_bytes<DP>();
  const auto kernel = rope_attention_tf32_kernel<DP, ROPE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kBlockQ - 1) / kBlockQ, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<float*>(a.out), a.lq, a.lk, a.lv, a.lo, static_cast<const float*>(a.cos_t),
      static_cast<const float*>(a.sin_t), static_cast<const int*>(a.lengths), a.lse, a.seq, a.heads,
      a.head_dim, a.q_mul);
  return cudaGetLastError();
}

template <typename T, int DP, bool ROPE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_bf16<DP, ROPE>(a, stream);
  } else {
    return launch_fp32<DP, ROPE>(a, stream);
  }
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
// kscratch is the bf16 kernel's rotated-K scratch with RoPE, (B, H, T
// rounded up to 128, DP) bf16 with DP the padding of head_dim (16, 32, 64,
// 80 or 128); null otherwise.
int rope_attention_fwd(const void* q, const void* k, const void* v, void* out, int64_t qb,
                       int64_t qt, int64_t qh, int64_t kb, int64_t kt, int64_t kh, int64_t vb,
                       int64_t vt, int64_t vh, int64_t ob, int64_t ot, int64_t oh,
                       const void* cos_t, const void* sin_t, const void* lengths, void* lse,
                       void* kscratch, int batch, int seq, int heads, int head_dim, float q_mul,
                       int is_bf16, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || head_dim < 8 || head_dim % 8 || head_dim > 128 ||
      (cos_t == nullptr) != (sin_t == nullptr) ||
      (is_bf16 && cos_t != nullptr && kscratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, out, {qb, qt, qh}, {kb, kt, kh}, {vb, vt, vh}, {ob, ot, oh},
               cos_t, sin_t, lengths, static_cast<float*>(lse), kscratch, batch, seq, heads,
               head_dim, q_mul};
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

// Cross-attention (bf16 only): q and out are (B, Tq, H, d) and k and v
// (B, Tk, H, d), each with element strides (b, t, h) under the same rules
// as above; query row t attends keys 0 .. k_lengths[b] - 1 (clamped to 1
// .. Tk), without RoPE and without lse. Runs cross_attention_kernel_sm90.
int cross_attention_fwd(const void* q, const void* k, const void* v, void* out, int64_t qb, int64_t qt,
                        int64_t qh, int64_t kb, int64_t kt, int64_t kh, int64_t vb, int64_t vt, int64_t vh,
                        int64_t ob, int64_t ot, int64_t oh, const void* k_lengths, int batch, int q_seq,
                        int k_seq, int heads, int head_dim, float q_mul, void* stream) {
  if (batch < 1 || q_seq < 1 || k_seq < 1 || heads < 1 || head_dim < 8 || head_dim % 8 || head_dim > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, out, {qb, qt, qh}, {kb, kt, kh}, {vb, vt, vh}, {ob, ot, oh},
               nullptr, nullptr, k_lengths, nullptr, nullptr, batch, q_seq, heads, head_dim, q_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim <= 16) {
    err = launch_cross<16>(a, k_seq, s);
  } else if (head_dim <= 32) {
    err = launch_cross<32>(a, k_seq, s);
  } else if (head_dim <= 64) {
    err = launch_cross<64>(a, k_seq, s);
  } else if (head_dim <= 80) {
    err = launch_cross<80>(a, k_seq, s);
  } else {
    err = launch_cross<128>(a, k_seq, s);
  }
  return static_cast<int>(err);
}

const char* rope_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
