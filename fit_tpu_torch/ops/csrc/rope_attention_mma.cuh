// The bf16 forward of K1 (rope_attention.cu) on warp-level tensor-core
// instructions: scores and output stay in registers, and the key/value tiles
// stream through a two-stage shared-memory ring filled by cp.async.
//
// One block per (64-query tile, head, batch row), 4 warps of 16 query rows.
// Per 64-key tile j, each warp:
//   S (16 x 64 fp32, 32 floats a thread) = Q K_j^T by mma.sync m16n8k16, with
//     Q held as ldmatrix A fragments for the whole key loop and K_j's B
//     fragments from ldmatrix on the row-major (keys x DP) tile;
//   masks keys >= len on the last tile, takes the row max and sum across the
//     quad of lanes that shares a row (shfl_xor 1, 2) in the exp2 domain
//     (q_mul = scale * log2(e) is folded into q), rounds P to bf16 before
//     both the row sum and the product, and rescales O in registers;
//   O (16 x DP fp32) += P V_j by mma.sync, P's A fragments made from the S
//     accumulators in registers (two n8 C tiles are one k16 A fragment), V_j's
//     B fragments from ldmatrix.trans on the row-major tile.
// While tile j is multiplied, tile j+1 is on its way into the other stage:
// K and V by cp.async.cg (16-byte copies, zero-filled past len and d). With
// RoPE, each thread rotates the chunks of K_{j+1} it copied, in place, after
// tile j's products (holding them in registers across the products instead
// cost 20 registers a thread at DP 80 and spilled). One __syncthreads per
// tile orders the ring. The epilogue writes O / l as bf16 through the warp's
// rows of the (now free) Q tile, for 16-byte stores, and lse2 = m + log2(l).
//
// Shared memory: Q plus two stages of K and V, each (64, DP + 8) bf16. The
// padded row stride puts the 8 rows an ldmatrix reads on distinct bank
// quads at every DP this file compiles (16, 32, 64, 80, 128), so no swizzle
// is needed. At DP 80 a block takes 55 KB and up to 168 registers a thread,
// so 3 blocks (12 warps) share an SM.

#pragma once

#include "rope_tiles.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1: the first src_bytes (0 to 16)
// are read and the rest zero-filled (src must be a valid address even when
// nothing is read).
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// 16 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  cp_async16_n(dst, src, valid ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (ex2.approx, relative error ~2^-22;
// -inf gives 0, and results below 2^-126 flush to 0, far under P's bf16
// rounding). exp2f adds range handling that costs registers and, at DP 80
// with RoPE, a spill.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 8 bf16 (one 16-byte chunk) -> 8 floats, exactly
__device__ __forceinline__ void unpack8(float (&x)[8], uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Two floats as a bf16 pair, the first in the low half (the lower column of
// an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A 64-row tile of (64, DP) shared memory, row stride DP + 8, filled by
// cp.async from rows [row0, row0 + 64) of a row-strided (B, T, H, d) head;
// rows at or past `valid` and columns at or past d are zero-filled.
template <int DP>
__device__ __forceinline__ void async_tile(bf16* dst, const bf16* src, int64_t row_stride, int row0,
                                           int valid, int d) {
  constexpr int kChunks = DP / 8;
  constexpr int kTile = Strides<bf16, DP>::kTile;
#pragma unroll
  for (int it = 0; it < kBlockK * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < valid && c < d;
    cp_async16(smem_u32(dst + r * kTile + c), ok ? src + row * row_stride + c : src, ok);
  }
}

// Rotates, in place and pair by pair as load_rotated does with mul = 1, the
// chunks of a K tile that this thread copied with async_tile (once its
// copies have landed: cp.async.wait_group makes them visible to it); the
// zero-filled chunks stay zero.
template <int DP>
__device__ __forceinline__ void rotate_tile(bf16* tile, const float* cos_b, const float* sin_b,
                                            int row0, int valid, int d) {
  constexpr int kChunks = DP / 8;
  constexpr int kTile = Strides<bf16, DP>::kTile;
#pragma unroll
  for (int it = 0; it < kBlockK * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int row = row0 + r;
    if (row < valid && c < d) {
      uint4* p = reinterpret_cast<uint4*>(tile + r * kTile + c);
      float x[8], cs[8], sn[8], y[8];
      unpack8(x, *p);
      const int64_t t = static_cast<int64_t>(row) * d + c;
      load8(cs, cos_b + t);
      load8(sn, sin_b + t);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        y[j] = x[j] * cs[j] - x[j + 1] * sn[j];
        y[j + 1] = x[j + 1] * cs[j + 1] + x[j] * sn[j + 1];
      }
      *p = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                      pack_bf16(y[6], y[7]));
    }
  }
}

template <int DP>
constexpr size_t mma_smem_bytes() {
  return 5 * kBlockK * Strides<bf16, DP>::kTile * sizeof(bf16);  // Q, 2 x K, 2 x V
}

// Element strides of one (B, T, H, d) operand; the head dim is contiguous.
struct Layout {
  int64_t b, t, h;
};

// Blocks an SM must hold: 3 at DP <= 80 (up to 168 registers a thread);
// DP 128 keeps 64 output and 32 q registers a thread, and its 85 KB of
// shared memory allow only 2 anyway.
template <int DP, bool ROPE>
__global__ void __launch_bounds__(kThreads, DP <= 80 ? 3 : 2)
    rope_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ out, Layout lq,
                              Layout lk, Layout lv, Layout lo, const float* __restrict__ cos_t,
                              const float* __restrict__ sin_t, const int* __restrict__ lengths,
                              float* __restrict__ lse, int seq, int heads, int d, float q_mul) {
  static_assert(DP % 16 == 0 && DP <= 128, "DP is a multiple of 16, at most 128");
  constexpr int kTile = Strides<bf16, DP>::kTile;
  constexpr int kTileElems = kBlockK * kTile;
  constexpr int kD16 = DP / 16;  // k-steps of Q K^T, n-tile pairs of P V
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // (64, DP) rotated q * q_mul; the output staging at the end
  bf16* ks = qs + kTileElems;                // 2 stages of (64, DP) k
  bf16* vs = ks + 2 * kTileElems;            // 2 stages of (64, DP) v

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const bf16* qb = q + b * lq.b + h * lq.h;
  const bf16* kb = k + b * lk.b + h * lk.h;
  const bf16* vb = v + b * lv.b + h * lv.h;
  bf16* ob = out + b * lo.b + h * lo.h;
  const float* cos_b = ROPE ? cos_t + b * seq * d : nullptr;
  const float* sin_b = ROPE ? sin_t + b * seq * d : nullptr;
  const int len = min(max(lengths[b], 1), seq);
  const int ntiles = (len + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int tq = lane & 3;  // its column pair within an n8 tile

  // Tile 0 of k and v in flight while q is loaded and rotated.
  async_tile<DP>(ks, kb, lk.t, 0, len, d);
  async_tile<DP>(vs, vb, lv.t, 0, len, d);
  cp_async_commit();
  load_rotated<bf16, DP, ROPE>(qs, qb, cos_b, sin_b, lq.t, 0, q0, seq, d, q_mul);
  if constexpr (ROPE) {
    cp_async_wait_all();
    rotate_tile<DP>(ks, cos_b, sin_b, 0, len, d);
  }
  __syncthreads();

  uint32_t qf[kD16][4];  // this warp's 16 q rows as A fragments, k-step by k-step
  {
    const bf16* qrow = qs + (warp * kRowsPerWarp + (lane & 15)) * kTile + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kD16; ++kk) ldmatrix_x4(qf[kk], smem_u32(qrow + kk * 16));
  }

  float o[2 * kD16][4];  // O: n8 tiles of head dim; rows g (0, 1) and g + 8 (2, 3)
#pragma unroll
  for (int n = 0; n < 2 * kD16; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // ldmatrix row addresses: K (non-transposed, two key n8 tiles by one k16
  // step) and V (transposed, one key k16 step by two head-dim n8 tiles)
  const int k_ld = ((lane & 7) + ((lane >> 4) << 3)) * kTile + ((lane >> 3) & 1) * 8;
  const int v_ld = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kTile + (lane >> 4) * 8;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    const bf16* kt = ks + st * kTileElems;
    const bf16* vt = vs + st * kTileElems;
    // Tile j has landed (this thread's copies, then everyone's), and every
    // warp is done with tile j-1, whose stage tile j+1 now fills.
    cp_async_wait_all();
    __syncthreads();
    const int k1 = (j + 1) * kBlockK;
    if (j + 1 < ntiles) {
      async_tile<DP>(ks + (st ^ 1) * kTileElems, kb, lk.t, k1, len, d);
      async_tile<DP>(vs + (st ^ 1) * kTileElems, vb, lv.t, k1, len, d);
    }
    cp_async_commit();

    // S = Q K^T: 8 n8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_u32(kt + np * 16 * kTile + kk * 16 + k_ld));
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
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
    // P, rounded to bf16 once: the row sum and the product see the same values
    uint32_t pf[4][4];  // A fragments of P, one per 16-key step
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat162 p_lo = __floats2bfloat162_rn(fast_exp2(s[n][0] - mx[0]), fast_exp2(s[n][1] - mx[0]));
      const __nv_bfloat162 p_hi = __floats2bfloat162_rn(fast_exp2(s[n][2] - mx[1]), fast_exp2(s[n][3] - mx[1]));
      const float2 f_lo = __bfloat1622float2(p_lo);
      const float2 f_hi = __bfloat1622float2(p_hi);
      sum[0] += f_lo.x + f_lo.y;
      sum[1] += f_hi.x + f_hi.y;
      pf[n / 2][(n & 1) * 2] = *reinterpret_cast<const uint32_t*>(&p_lo);
      pf[n / 2][(n & 1) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&p_hi);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < 2 * kD16; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < kD16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_u32(vt + kk * 16 * kTile + np * 16 + v_ld));
        mma_bf16(o[2 * np], pf[kk], bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], pf[kk], bv[2], bv[3]);
      }
    }

    // With RoPE, k_{j+1} is rotated in place once this thread's copies of
    // it have landed; the next tile's barrier publishes it.
    if constexpr (ROPE) {
      if (j + 1 < ntiles) {
        cp_async_wait_all();
        rotate_tile<DP>(ks + (st ^ 1) * kTileElems, cos_b, sin_b, k1, len, d);
      }
    }
  }

  // Epilogue: O / l as bf16 into this warp's rows of the q tile (no other
  // warp reads them after the fragments were loaded), then 16-byte stores.
  bf16* stage = qs + warp * kRowsPerWarp * kTile;
#pragma unroll
  for (int n = 0; n < 2 * kD16; ++n) {
    const int c = n * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(stage + g * kTile + c) = pack_bf16(o[n][0] / l_run[0], o[n][1] / l_run[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kTile + c) =
        pack_bf16(o[n][2] / l_run[1], o[n][3] / l_run[1]);
  }
  if (lse != nullptr && tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * kRowsPerWarp + g + 8 * r;
      if (row < seq) lse[(b * seq + row) * heads + h] = m_run[r] + log2f(l_run[r]);
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
      *reinterpret_cast<uint4*>(ob + row * lo.t + c) = *reinterpret_cast<const uint4*>(stage + r * kTile + c);
    }
  }
}

}  // namespace
