// The fp32 forward of K1 (rope_attention.cu) on tensor cores at fp32
// accuracy: every product runs as three TF32 products (3xTF32), scores and
// output stay in registers, and the key/value tiles stream through a
// two-stage shared-memory ring filled by cp.async.
//
// Why three products. TF32 keeps 11 significant bits, so one TF32 product
// per dot moves the attention output by ~8e-4 at d 16 and 72 (an emulation
// in plain PyTorch, tests/test_torch_port_tf32.py), past the 1e-4 bar
// against the fp32 plain version. Each operand is split as
// hi = tf32(x), lo = tf32(x - hi), and a product as
// lo_a hi_b + hi_a lo_b + hi_a hi_b (the small terms first, the lo_a lo_b
// term dropped), which leaves ~2^-22 of relative error: the emulation moves
// by 2.4-2.7e-7, near fp32's own error. It is the scheme of CUTLASS's
// OpMultiplyAddFastF32.
//
// One block per (64-query tile, head, batch row), 4 warps of 16 query rows.
// Per 64-key tile j, each warp:
//   S (16 x 64 fp32, 32 floats a thread) = Q K_j^T by mma.sync m16n8k8
//     tf32, Q held in registers as fp32 A fragments for the whole key loop
//     (40 registers at DP 80) and split at each k-step, K_j's B fragments
//     read from shared memory as float2 and split;
//   masks keys >= len on the last tile, takes the row max and sum across the
//     quad of lanes that shares a row (shfl_xor 1, 2) in the exp2 domain
//     (q_mul = scale * log2(e) is folded into q), and rescales O in
//     registers; P stays fp32 (the row sum adds the values the product
//     splits);
//   O (16 x DP fp32) += P V_j by mma.sync, P's A fragments made from the S
//     accumulators in registers with no shuffle, V_j's B fragments read
//     from shared memory and split.
//
// Fragment order. A tf32 m16n8k8 A fragment holds columns (t, t + 4) of its
// rows and a B fragment rows (t, t + 4), t = lane % 4, while an accumulator
// holds columns (2t, 2t + 1). The k index of a product may be permuted as
// long as A and B agree, so both products take it in the order "column t is
// element 2t, column t + 4 is element 2t + 1" of their 8-wide k-step:
//   Q K^T: q's (2t, 2t + 1) and k's (2t, 2t + 1) are adjacent floats, one
//     float2 read each;
//   P V:   P's (2t, 2t + 1) are the accumulator pair s[n][0, 1] (rows g) and
//     s[n][2, 3] (rows g + 8) as they are, and V's B fragment comes from
//     key rows 2t and 2t + 1.
//
// Shared memory: two stages of K, row stride DP + 8 floats, and of V, row
// stride DP + 4. With float2 reads of K (a half-warp a phase), rows g
// 0..3 start 8 banks apart at every compiled DP (DP + 8 is 8 or 24 mod
// 32); V's scalar reads of key rows 2t, 2t + 1 start 8 banks apart (2 (DP
// + 4) is 8 mod 32), so no fragment read conflicts. q is loaded, rotated
// and scaled into K's second stage, read into registers, and that stage
// is refilled with tile 1 only after the loop's first barrier. At DP 80 a
// block takes 88 KB, 2 blocks an SM; at DP 128, 137 KB and one.
//
// What bounds it. The card's least time for fp32-accurate products is
// three TF32 products at 495 TFLOP/s, i.e. 165 TFLOP/s: DiT-XL/2 at 512^2
// (77.3 GFLOP, RoPE off) is bound by operations at ~470 us, the T 256
// shapes by bytes. Beside the three mma.sync a product takes, each of its
// fp32 operands costs two conversions and a subtraction: per 64-key tile
// and warp at DP 80, 480 mma.sync and ~1,100 split instructions (K's and
// V's splits are repeated by all 4 warps). The splits and mma.sync's issue
// rate, not the memory, set its time.
//
// Registers. The compiler's own scheduling took all 255 registers and
// spilled at DP 64 to 128, three ways: it hoisted every fragment read of a
// product ahead of its mma.sync, it hoisted q's splits out of the key loop
// (8 registers a k-step for the whole loop), and it kept one global pointer
// per unrolled cp.async and RoPE-table read live across the loop. So the
// products' shared-memory reads and mma.sync are volatile (program order,
// a k-step's reads batched ahead of its products), q is split by volatile
// conversions, and the copy and rotate loops are not unrolled. ptxas then
// gives 167-175 registers at DP 64, 190-198 at DP 80 and 221-235 at DP
// 128, with no spill.

#pragma once

#include "rope_tiles.cuh"

namespace {

// fp32 -> tf32, round to nearest with ties away from zero: the low 13 bits
// of the result are zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo to ~2^-22 relative: hi is x in tf32, lo the rest in tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// split_tf32 as volatile instructions, for q's fragments: the compiler may
// not hoist their split out of the key loop, where the 2 x 4 registers of
// each k-step would stay live for the whole loop (80 at DP 80, and spills).
__device__ __forceinline__ void split_tf32_here(float x, uint32_t& hi, uint32_t& lo) {
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c (16x8 fp32) += a (16x8 tf32, row) b (8x8 tf32, col). volatile, as the
// shared-memory reads below: the compiler keeps them in program order, so
// it cannot hoist a whole product's fragment reads ahead of its mma.sync
// (which took every register and spilled at DP 64 to 128).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory reads at a 32-bit shared address (a tile's base plus a
// constant offset, which ptxas folds into the instruction).
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// c[n] += a b[n] at fp32 accuracy for N n8 tiles that share one A fragment
// (given split), b[n] the two fp32 values of each B fragment: the small
// terms lo_a hi_b and hi_a lo_b first, then hi_a hi_b, each pass over all N
// accumulators, so consecutive mma.sync never wait on one another.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                           const float2 (&b)[N]) {
  uint32_t hi[N][2], lo[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    split_tf32(b[n].x, hi[n][0], lo[n][0]);
    split_tf32(b[n].y, hi[n][1], lo[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a_lo, hi[n][0], hi[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a_hi, lo[n][0], lo[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a_hi, hi[n][0], hi[n][1]);
}

// cp.async.wait_group 0 that is also a compiler memory barrier: no load of
// the landed tile moves above it, and no load after it (the next key tile's
// RoPE tables) is hoisted into the products before it, where its registers
// would stay live across them.
__device__ __forceinline__ void cp_async_wait_all_fenced() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// A ROWS-row fp32 tile of (ROWS, DP) shared memory, row stride LD, filled
// by cp.async from rows [row0, row0 + ROWS) of a row-strided (B, T, H, d)
// head; rows at or past `valid` and columns at or past d are zero-filled.
template <int DP, int LD, int ROWS = kBlockK>
__device__ __forceinline__ void async_tile_f32(float* dst, const float* src, int64_t row_stride, int row0,
                                               int valid, int d) {
  constexpr int kChunks = DP / 4;
  static_assert(ROWS * kChunks % kThreads == 0, "whole chunks per thread");
  // not unrolled: unrolled, the compiler keeps one global pointer per copy
  // live across the key loop and steps them all by a tile
#pragma unroll 1
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const int row = row0 + r;
    const bool ok = row < valid && c < d;
    cp_async16(smem_u32(dst + r * LD + c), ok ? src + row * row_stride + c : src, ok);
  }
}

// Rotates, in place and pair by pair as load_rotated does with mul = 1, the
// chunks of an fp32 K tile that this thread copied with async_tile_f32
// (once its copies have landed); the zero-filled chunks stay zero.
template <int DP, int LD>
__device__ __forceinline__ void rotate_tile_f32(float* tile, const float* cos_b, const float* sin_b, int row0,
                                                int valid, int d) {
  constexpr int kChunks = DP / 4;
#pragma unroll 1  // as async_tile_f32: unrolled, its table pointers stay live across the key loop
  for (int it = 0; it < kBlockK * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const int row = row0 + r;
    if (row < valid && c < d) {
      float4* p = reinterpret_cast<float4*>(tile + r * LD + c);
      const float4 x = *p;
      const int64_t t = static_cast<int64_t>(row) * d + c;
      const float4 cs = *reinterpret_cast<const float4*>(cos_b + t);
      const float4 sn = *reinterpret_cast<const float4*>(sin_b + t);
      *p = make_float4(x.x * cs.x - x.y * sn.x, x.y * cs.y + x.x * sn.y, x.z * cs.z - x.w * sn.z,
                       x.w * cs.w + x.z * sn.w);
    }
  }
}

template <int DP>
constexpr size_t tf32_smem_bytes() {
  return 2 * kBlockK * ((DP + 8) + (DP + 4)) * sizeof(float);  // 2 x K, 2 x V; q passes through K's stage 1
}

// Blocks an SM must hold: 2 at DP <= 80 (shared memory allows no more at
// DP 80), 1 at DP 128 (137 KB).
template <int DP, bool ROPE>
__global__ void __launch_bounds__(kThreads, DP <= 80 ? 2 : 1)
    rope_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ out, Layout lq, Layout lk,
                               Layout lv, Layout lo, const float* __restrict__ cos_t,
                               const float* __restrict__ sin_t, const int* __restrict__ lengths,
                               float* __restrict__ lse, int seq, int heads, int d, float q_mul) {
  static_assert(DP % 16 == 0 && DP <= 128, "DP is a multiple of 16, at most 128");
  constexpr int kLdK = DP + 8;
  constexpr int kLdV = DP + 4;
  constexpr int kTileK = kBlockK * kLdK;
  constexpr int kTileV = kBlockK * kLdV;
  constexpr int kSteps = DP / 8;  // k-steps of Q K^T, n8 tiles of P V
  constexpr int kChunkN = kSteps > 8 ? kSteps / 2 : kSteps;  // P V's n8 tiles split at a time (registers)
  static_assert(kLdK == Strides<float, DP>::kTile, "q goes through load_rotated at K's row stride");
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // 2 stages of (64, DP) k; stage 1 first holds q
  float* vs = ks + 2 * kTileK;                 // 2 stages of (64, DP) v

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const float* qb = q + b * lq.b + h * lq.h;
  const float* kb = k + b * lk.b + h * lk.h;
  const float* vb = v + b * lv.b + h * lv.h;
  float* ob = out + b * lo.b + h * lo.h;
  const float* cos_b = ROPE ? cos_t + b * seq * d : nullptr;
  const float* sin_b = ROPE ? sin_t + b * seq * d : nullptr;
  const int len = min(max(lengths[b], 1), seq);
  const int ntiles = (len + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int tq = lane & 3;  // its k (and column) pair within an 8-wide step

  // Tile 0 of k and v in flight while q is loaded and rotated.
  async_tile_f32<DP, kLdK>(ks, kb, lk.t, 0, len, d);
  async_tile_f32<DP, kLdV>(vs, vb, lv.t, 0, len, d);
  cp_async_commit();
  load_rotated<float, DP, ROPE>(ks + kTileK, qb, cos_b, sin_b, lq.t, 0, q0, seq, d, q_mul);
  if constexpr (ROPE) {
    cp_async_wait_all_fenced();
    rotate_tile_f32<DP, kLdK>(ks, cos_b, sin_b, 0, len, d);
  }
  __syncthreads();

  float qf[kSteps][4];  // this warp's 16 q rows as fp32 A fragments, k-step by k-step
  {
    const float* qrow = ks + kTileK + (warp * kRowsPerWarp + g) * kLdK + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const float2 top = *reinterpret_cast<const float2*>(qrow + kk * 8);
      const float2 bot = *reinterpret_cast<const float2*>(qrow + 8 * kLdK + kk * 8);
      qf[kk][0] = top.x;
      qf[kk][1] = bot.x;
      qf[kk][2] = top.y;
      qf[kk][3] = bot.y;
    }
  }

  float o[kSteps][4];  // O: n8 tiles of head dim; rows g (0, 1) and g + 8 (2, 3)
#pragma unroll
  for (int n = 0; n < kSteps; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    const float* kt = ks + st * kTileK;
    const float* vt = vs + st * kTileV;
    // Tile j has landed (this thread's copies, then everyone's), and every
    // warp is done with tile j-1 (and, at j = 0, with q), whose stage tile
    // j+1 now fills.
    cp_async_wait_all_fenced();
    __syncthreads();
    const int k1 = (j + 1) * kBlockK;
    if (j + 1 < ntiles) {
      async_tile_f32<DP, kLdK>(ks + (st ^ 1) * kTileK, kb, lk.t, k1, len, d);
      async_tile_f32<DP, kLdV>(vs + (st ^ 1) * kTileV, vb, lv.t, k1, len, d);
    }
    cp_async_commit();

    // S = Q K^T: 8 n8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const uint32_t krow = smem_u32(kt + g * kLdK + 2 * tq);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32_here(qf[kk][e], a_hi[e], a_lo[e]);
      float2 bk[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) bk[n] = lds2(krow + (n * 8 * kLdK + kk * 8) * 4);
      mma_3xtf32<8>(s, a_hi, a_lo, bk);
    }

    // Online softmax over the quad that shares each row. Every tile holds a
    // valid key (j * 64 < len), so the new max is finite; masked keys give
    // exp2(-inf) = 0, and the first tile's alpha = exp2(-inf) rescales zeros.
    const int k0 = j * kBlockK;
    if (k0 + kBlockK > len) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + n * 8 + 2 * tq + (e & 1) >= len) s[n][e] = -INFINITY;
        }
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = fast_exp2(s[n][e] - mx[e >> 1]);
      sum[0] += s[n][0] + s[n][1];
      sum[1] += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < kSteps; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: k-step kk is keys 8 kk .. 8 kk + 7, A column t key 2t and
    // column t + 4 key 2t + 1, so P's fragment is s[kk] reordered
    const uint32_t vrow = smem_u32(vt + 2 * tq * kLdV + g);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t p_hi[4], p_lo[4];
      split_tf32(s[kk][0], p_hi[0], p_lo[0]);
      split_tf32(s[kk][2], p_hi[1], p_lo[1]);
      split_tf32(s[kk][1], p_hi[2], p_lo[2]);
      split_tf32(s[kk][3], p_hi[3], p_lo[3]);
#pragma unroll
      for (int n0 = 0; n0 < kSteps; n0 += kChunkN) {
        float2 bv[kChunkN];
#pragma unroll
        for (int n = 0; n < kChunkN; ++n) {
          const uint32_t vp = vrow + (kk * 8 * kLdV + (n0 + n) * 8) * 4;
          bv[n] = make_float2(lds(vp), lds(vp + kLdV * 4));
        }
        mma_3xtf32<kChunkN>(o + n0, p_hi, p_lo, bv);
      }
    }

    // With RoPE, k_{j+1} is rotated in place once this thread's copies of
    // it have landed; the next tile's barrier publishes it.
    if constexpr (ROPE) {
      if (j + 1 < ntiles) {
        cp_async_wait_all_fenced();
        rotate_tile_f32<DP, kLdK>(ks + (st ^ 1) * kTileK, cos_b, sin_b, k1, len, d);
      }
    }
  }

  // Epilogue: O / l straight from the accumulators, a float2 per row and
  // n8 tile (a quad writes 32 contiguous bytes), and lse2 = m + log2(l).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * kRowsPerWarp + g + 8 * r;
    if (row >= seq) continue;
    float* orow = ob + row * lo.t;
#pragma unroll
    for (int n = 0; n < kSteps; ++n) {
      const int c = n * 8 + 2 * tq;
      if (c < d) {
        *reinterpret_cast<float2*>(orow + c) = make_float2(o[n][2 * r] / l_run[r], o[n][2 * r + 1] / l_run[r]);
      }
    }
    if (lse != nullptr && tq == 0) lse[(b * seq + row) * heads + h] = m_run[r] + log2f(l_run[r]);
  }
}

}  // namespace
