// The fp32 backward of K2 (rope_attention_bwd.cu) on tensor cores at fp32
// accuracy: the bf16 passes' schedule (rope_attention_bwd_mma.cuh) with the
// fp32 K1's arithmetic (rope_attention_tf32.cuh), every product as three
// TF32 mma.sync m16n8k8 of split operands (3xTF32). Three launches, no
// atomics, a fixed summation order: two calls write the same bits.
//
// 1. Prologue: bwd_prologue_kernel<float> (rope_attention_bwd_mma.cuh)
//    writes delta = rowsum(g * out), q_r * q_mul and k_r in fp32 into
//    head-major (B, H, T, d) scratch (the expressions of the fp32 K1's
//    loaders, unrounded, so K2's probabilities agree with K1's lse2), and
//    lse2 and delta head-major (B, H, T rounded up to 64).
// 2. dk/dv pass (bwd_dkdv_tf32_kernel): one block per (64 keys, head, batch
//    row), 4 warps of 16 keys. k_r and v stay in shared memory; q_r, g and
//    their lse2 and delta stream through a two-stage cp.async ring in tiles
//    of 32 query rows (padded query rows included, rows past T zero-filled,
//    so they add exactly 0). Per tile each warp computes S^T = K Q^T into
//    registers, P^T = exp2(S^T - lse2) in fp32, dv += P^T G, dP^T = V G^T,
//    dS^T = P^T (dP^T - delta) in fp32, and dk += dS^T Q; P^T and dS^T are
//    split into tf32 A fragments straight from the accumulators. dk and dv
//    stay in registers; the epilogue applies rope_vjp / log2(e) to dk,
//    zeroes the rows of keys at or past the length, and stores 16-byte
//    chunks through the warp's own rows of the K and V tiles.
// 3. dq pass (bwd_dq_tf32_kernel): one block per (64 queries, head, batch
//    row): q_r and g stay in shared memory, k_r and v stream through the
//    ring in tiles of 32 keys below the length; S = Q K^T and dP = G V^T in
//    registers, P masked past the length, dS = P (dP - delta) in fp32, dq
//    += dS K; the epilogue applies rope_vjp * scale.
//
// Fragment order. In A B^T (S^T, dP^T, S, dP) both operands come from
// shared memory, so the k index (head dim) is taken in its own order:
// fragment column t is column t, t + 4 is t + 4. In P B (dv, dk, dq) the A
// fragment comes from the accumulators, which hold columns (2t, 2t + 1), so
// that product takes the fp32 K1's order (rope_attention_tf32.cuh): column t is
// element 2t and t + 4 is 2t + 1; the accumulator pair is then the A
// fragment with no shuffle, and B is read from rows 2t and 2t + 1.
//
// Shared memory. Every tile has row stride DP + 4 floats and every read is
// a 32-bit scalar: lanes (g, t) read row g (or g + 8), column t (A and B of
// A B^T: banks 4g + t or 20g + t mod 32, all distinct at every compiled
// DP) or rows 2t and 2t + 1, column g (B of P B: 8t + g), so no read
// conflicts. A float2 read (as the fp32 K1's K) would need a stride of 8
// mod 32 and the scalar reads one of 4 mod 8, and Q and G serve both.
// Two resident (64, DP) tiles, two stages of two (32, DP) streamed tiles
// and two stages of 64 statistics: 68.5 KB at DP 64, 84.5 KB at DP 80
// (2 blocks an SM, as registers allow), 132.5 KB at DP 128 (one).
//
// Arithmetic. S and dP come out of their products in fp32; P = exp2(S -
// lse2) and dS = P (dP - delta) are formed in fp32 registers and split
// (hi = tf32(x), lo = tf32(x - hi)) only as A fragments of the next
// product, so the cancellation in dP - delta happens before any rounding.
// Each product sums lo_a hi_b + hi_a lo_b + hi_a hi_b and drops lo_a lo_b,
// as the fp32 K1; tests/test_torch_port_tf32.py emulates all seven
// products in this order and holds dq, dk and dv within 1e-5 of a float64
// VJP. The emulation rounds each sum once; the tensor cores truncate as
// they accumulate, so dP and the P B products collect their mma.sync in
// zeroed partial sums (a k-step of dP, a 32-row tile of dk, dv and dq)
// that rounded fp32 adds join (tf32_abt, tf32_pb).
//
// Registers. The products' shared-memory reads and mma.sync are volatile
// and the copy loops rolled, as in the fp32 K1, so the compiler cannot
// hoist a product's reads (or K's and V's loop-invariant splits) into
// registers that stay live across the loop.

#pragma once

#include "rope_attention_bwd_mma.cuh"
#include "rope_attention_tf32.cuh"

namespace {

constexpr int kStream = 32;             // rows of a streamed tile: query rows (dk/dv), keys (dq)
constexpr int kStreamN8 = kStream / 8;  // its n8 tiles in A B^T, its k-steps in P B

template <int DP>
constexpr size_t bwd_tf32_smem_bytes() {
  return (2 * kBlockK + 2 * 2 * kStream) * (DP + 4) * sizeof(float) + 2 * 2 * kStream * sizeof(float);
}

// s (16 x 32) = A B^T at fp32 accuracy: A this warp's 16 rows of a (64, DP)
// tile, B the 32 rows of a streamed (32, DP) tile, both row stride DP + 4.
// a_addr is the shared address of A's element (16 warp + g, t), b_addr of
// B's (g, t). With PARTIAL (dP) each k-step's three mma.sync go into a
// zeroed partial sum, added to s by a rounded fp32 add (see tf32_pb): dP's
// error is what is left of dS = P (dP - delta) where the two cancel (a row
// of one key, whose exact dS is 0, summed into dk over every query), and
// the tensor cores' truncation moved dk by 2.2e-4 there at DP 128 (5.2e-5
// with the partial sums). S goes without (its error only scales P): with
// them too, the dk/dv pass spilled at DP 80.
template <int DP, bool PARTIAL>
__device__ __forceinline__ void tf32_abt(float (&s)[kStreamN8][4], uint32_t a_addr, uint32_t b_addr) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int n = 0; n < kStreamN8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(lds(a_addr + (kk * 8) * 4), a_hi[0], a_lo[0]);               // row g, column t
    split_tf32(lds(a_addr + (8 * LD + kk * 8) * 4), a_hi[1], a_lo[1]);      // row g + 8
    split_tf32(lds(a_addr + (kk * 8 + 4) * 4), a_hi[2], a_lo[2]);           // column t + 4
    split_tf32(lds(a_addr + (8 * LD + kk * 8 + 4) * 4), a_hi[3], a_lo[3]);
    float2 b[kStreamN8];
#pragma unroll
    for (int n = 0; n < kStreamN8; ++n) {
      const uint32_t bp = b_addr + (n * 8 * LD + kk * 8) * 4;
      b[n] = make_float2(lds(bp), lds(bp + 16));
    }
    if constexpr (PARTIAL) {  // two n8 tiles a partial sum (the dq pass spilled at DP 64 with four)
#pragma unroll
      for (int h = 0; h < kStreamN8; h += 2) {
        float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const float2 bh[2] = {b[h], b[h + 1]};
        mma_3xtf32<2>(part, a_hi, a_lo, bh);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[h + n][e] += part[n][e];
        }
      }
    } else {
      mma_3xtf32<kStreamN8>(s, a_hi, a_lo, b);
    }
  }
}

// acc (16 x DP) += P B at fp32 accuracy: P (16 x 32) the fp32 accumulators
// of a tf32_abt, split as A fragments; B a streamed (32, DP) tile, row
// stride DP + 4, bt_addr the shared address of its element (2t, g). The
// tile's 12 mma.sync a column go into a zeroed partial sum, added to acc
// by a rounded fp32 add: the tensor cores' own fp32 accumulation truncates,
// and over the T / 32 tiles of a pass its bias moved dk by 2.2e-4 of the
// plain version at DP 128 and T 4096 on an H100, past the 1e-4 bar.
template <int DP>
__device__ __forceinline__ void tf32_pb(float (&acc)[DP / 8][4], const float (&p)[kStreamN8][4], uint32_t bt_addr) {
  constexpr int LD = DP + 4;
  constexpr int kSteps = DP / 8;                               // n8 tiles of the head dim
  constexpr int kChunkN = kSteps % 4 == 0 ? 4 : 2;             // a partial sum's n8 tiles (registers)
  uint32_t p_hi[kStreamN8][4], p_lo[kStreamN8][4];
#pragma unroll
  for (int kk = 0; kk < kStreamN8; ++kk) {
    split_tf32(p[kk][0], p_hi[kk][0], p_lo[kk][0]);
    split_tf32(p[kk][2], p_hi[kk][1], p_lo[kk][1]);
    split_tf32(p[kk][1], p_hi[kk][2], p_lo[kk][2]);
    split_tf32(p[kk][3], p_hi[kk][3], p_lo[kk][3]);
  }
#pragma unroll
  for (int n0 = 0; n0 < kSteps; n0 += kChunkN) {
    float part[kChunkN][4];
#pragma unroll
    for (int n = 0; n < kChunkN; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kStreamN8; ++kk) {
      float2 b[kChunkN];
#pragma unroll
      for (int n = 0; n < kChunkN; ++n) {
        const uint32_t bp = bt_addr + (kk * 8 * LD + (n0 + n) * 8) * 4;
        b[n] = make_float2(lds(bp), lds(bp + LD * 4));
      }
      mma_3xtf32<kChunkN>(part, p_hi[kk], p_lo[kk], b);
    }
#pragma unroll
    for (int n = 0; n < kChunkN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
    }
  }
}

// Stages rope_vjp(acc * mul) (or, with rotate false, acc) of this warp's 16
// rows into its rows of a (64, DP) tile, row stride DP + 4, as float2
// pairs; rows at or past `valid` and columns at or past d get zeros.
template <int DP>
__device__ __forceinline__ void stage_rows(float* stage, const float (&acc)[DP / 8][4], const float* cos_b,
                                           const float* sin_b, int row0, int valid, int d, float mul,
                                           bool rotate) {
  constexpr int LD = DP + 4;
  const int lane = threadIdx.x % 32;
  const int gr = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = gr + 8 * r;
      float2 x = make_float2(0.f, 0.f);
      if (row0 + lr < valid && col < d) {
        x = rotate ? rope_vjp2(acc[n][2 * r], acc[n][2 * r + 1], cos_b, sin_b, row0 + lr, col, d, mul)
                   : make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
      *reinterpret_cast<float2*>(stage + lr * LD + col) = x;
    }
  }
}

// Blocks an SM must hold: 2 (registers: dk and dv take 2 x DP / 2 a
// thread; shared memory allows 3 at DP 64, 2 at DP 80, 1 at DP 128).
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    bwd_dkdv_tf32_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                         const float* __restrict__ q_rot, const float* __restrict__ k_rot,
                         const float* __restrict__ lse_h, const float* __restrict__ delta_h,
                         const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                         const int* __restrict__ lengths, float* __restrict__ dqkv, int seq,
                         int seq_pad, int heads, int d, float dk_mul) {
  static_assert(DP % 16 == 0 && DP <= 128, "DP is a multiple of 16, at most 128");
  constexpr int LD = DP + 4;
  constexpr int kRes = kBlockK * LD;  // a resident tile
  constexpr int kStr = kStream * LD;  // a streamed tile
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // (64, DP) k_r of this block's keys; dk staging at the end
  float* vs = ks + kRes;                       // (64, DP) v; dv staging at the end
  float* qs = vs + kRes;                       // 2 stages of (32, DP) q_r * q_mul
  float* gs = qs + 2 * kStr;                   // 2 stages of (32, DP) g
  float* stat_s = gs + 2 * kStr;               // 2 stages of lse2[32], delta[32]

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int width = heads * d;
  const int64_t row_stride = 3LL * width;
  const int64_t bh = b * heads + h;
  const float* qr = q_rot + bh * seq * d;
  const float* kr = k_rot + bh * seq * d;
  const float* vb = qkv + b * seq * row_stride + 2 * width + h * d;
  const float* gb = g + b * seq * width + h * d;
  const float* lse_bh = lse_h + bh * seq_pad;
  const float* delta_bh = delta_h + bh * seq_pad;
  float* dk_dst = dqkv + b * seq * row_stride + width + h * d;
  float* dv_dst = dk_dst + width;
  const float* cos_b = cos_t + b * seq * d;
  const float* sin_b = sin_t + b * seq * d;
  const int len = min(max(lengths[b], 1), seq);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int tq = lane & 3;   // its column (A B^T) or column pair (accumulators)

  if (k0 >= len) {  // masked keys: dk = dv = 0
    zero_key_rows<float, DP>(dk_dst, dv_dst, row_stride, k0, seq, d);
    return;
  }

  const int nq = (seq + kStream - 1) / kStream;
  async_tile_f32<DP, LD>(ks, kr, d, k0, len, d);
  async_tile_f32<DP, LD>(vs, vb, row_stride, k0, len, d);
  async_tile_f32<DP, LD, kStream>(qs, qr, d, 0, seq, d);
  async_tile_f32<DP, LD, kStream>(gs, gb, width, 0, seq, d);
  async_stats<kStream>(stat_s, lse_bh, delta_bh, 0, seq);
  cp_async_commit();

  float dk[DP / 8][4], dv[DP / 8][4];  // rows g (0, 1) and g + 8 (2, 3) of this warp's keys
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  const uint32_t k_addr = smem_u32(ks + (warp * kRowsPerWarp + gr) * LD + tq);
  const uint32_t v_addr = k_addr + kRes * 4;

  for (int j = 0; j < nq; ++j) {
    const int st = j & 1;
    const float* qt = qs + st * kStr;
    const float* gt = gs + st * kStr;
    const float* lse_s = stat_s + st * 2 * kStream;
    const float* delta_s = lse_s + kStream;
    // Query tile j has landed (this thread's copies, then everyone's), and
    // every warp is done with tile j-1, whose stage tile j+1 now fills.
    cp_async_wait_all_fenced();
    __syncthreads();
    if (j + 1 < nq) {
      const int q1 = (j + 1) * kStream;
      async_tile_f32<DP, LD, kStream>(qs + (st ^ 1) * kStr, qr, d, q1, seq, d);
      async_tile_f32<DP, LD, kStream>(gs + (st ^ 1) * kStr, gb, width, q1, seq, d);
      async_stats<kStream>(stat_s + (st ^ 1) * 2 * kStream, lse_bh, delta_bh, q1, seq);
    }
    cp_async_commit();

    // P^T = exp2(K Q^T - lse2), by query column, in fp32
    float s[kStreamN8][4];
    tf32_abt<DP, false>(s, k_addr, smem_u32(qt + gr * LD + tq));
#pragma unroll
    for (int n = 0; n < kStreamN8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + n * 8 + 2 * tq);
      s[n][0] = fast_exp2(s[n][0] - l.x);
      s[n][1] = fast_exp2(s[n][1] - l.y);
      s[n][2] = fast_exp2(s[n][2] - l.x);
      s[n][3] = fast_exp2(s[n][3] - l.y);
    }
    tf32_pb<DP>(dv, s, smem_u32(gt + 2 * tq * LD + gr));  // dv += P^T G

    // dS^T = P^T (V G^T - delta), in fp32
    float ds[kStreamN8][4];
    tf32_abt<DP, true>(ds, v_addr, smem_u32(gt + gr * LD + tq));
#pragma unroll
    for (int n = 0; n < kStreamN8; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + n * 8 + 2 * tq);
      ds[n][0] = s[n][0] * (ds[n][0] - dl.x);
      ds[n][1] = s[n][1] * (ds[n][1] - dl.y);
      ds[n][2] = s[n][2] * (ds[n][2] - dl.x);
      ds[n][3] = s[n][3] * (ds[n][3] - dl.y);
    }
    tf32_pb<DP>(dk, ds, smem_u32(qt + 2 * tq * LD + gr));  // dk_r * scale * log2(e) += dS^T Q_r
  }
  cp_async_wait_all();  // the last (empty) group

  // Epilogue: this warp's rows of the K and V tiles (no other warp reads
  // them) stage rope_vjp(dk / log2(e)) and dv; keys at or past the length
  // get zero rows.
  float* kst = ks + warp * kRowsPerWarp * LD;
  float* vst = vs + warp * kRowsPerWarp * LD;
  const int row0 = k0 + warp * kRowsPerWarp;
  __syncwarp();
  stage_rows<DP>(kst, dk, cos_b, sin_b, row0, len, d, dk_mul, true);
  stage_rows<DP>(vst, dv, cos_b, sin_b, row0, len, d, 1.f, false);
  __syncwarp();
  store_staged<float, DP, LD>(dk_dst, kst, row_stride, row0, seq, d);
  store_staged<float, DP, LD>(dv_dst, vst, row_stride, row0, seq, d);
}

// Blocks an SM must hold: 3 at DP <= 64 (shared memory allows it, and dq
// takes DP / 2 registers a thread), 2 above.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 3 : 2)
    bwd_dq_tf32_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                       const float* __restrict__ q_rot, const float* __restrict__ k_rot,
                       const float* __restrict__ lse_h, const float* __restrict__ delta_h,
                       const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                       const int* __restrict__ lengths, float* __restrict__ dqkv, int seq,
                       int seq_pad, int heads, int d, float dq_mul) {
  static_assert(DP % 16 == 0 && DP <= 128, "DP is a multiple of 16, at most 128");
  constexpr int LD = DP + 4;
  constexpr int kRes = kBlockQ * LD;
  constexpr int kStr = kStream * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // (64, DP) q_r * q_mul; dq staging at the end
  float* gs = qs + kRes;                       // (64, DP) g
  float* ks = gs + kRes;                       // 2 stages of (32, DP) k_r
  float* vs = ks + 2 * kStr;                   // 2 stages of (32, DP) v

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int width = heads * d;
  const int64_t row_stride = 3LL * width;
  const int64_t bh = b * heads + h;
  const float* qr = q_rot + bh * seq * d;
  const float* kr = k_rot + bh * seq * d;
  const float* vb = qkv + b * seq * row_stride + 2 * width + h * d;
  const float* gb = g + b * seq * width + h * d;
  float* dq_dst = dqkv + b * seq * row_stride + h * d;
  const float* cos_b = cos_t + b * seq * d;
  const float* sin_b = sin_t + b * seq * d;
  const int len = min(max(lengths[b], 1), seq);
  const int ntiles = (len + kStream - 1) / kStream;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane >> 2;
  const int tq = lane & 3;

  async_tile_f32<DP, LD, kStream>(ks, kr, d, 0, len, d);
  async_tile_f32<DP, LD, kStream>(vs, vb, row_stride, 0, len, d);
  async_tile_f32<DP, LD>(qs, qr, d, q0, seq, d);
  async_tile_f32<DP, LD>(gs, gb, width, q0, seq, d);
  cp_async_commit();

  const int row0 = q0 + warp * kRowsPerWarp;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gr + 8 * r;
    lse_r[r] = row < seq ? lse_h[bh * seq_pad + row] : 0.f;
    delta_r[r] = row < seq ? delta_h[bh * seq_pad + row] : 0.f;
  }
  float dq[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const uint32_t q_addr = smem_u32(qs + (warp * kRowsPerWarp + gr) * LD + tq);
  const uint32_t g_addr = q_addr + kRes * 4;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    const float* kt = ks + st * kStr;
    const float* vt = vs + st * kStr;
    cp_async_wait_all_fenced();
    __syncthreads();
    const int key0 = j * kStream;
    if (j + 1 < ntiles) {
      async_tile_f32<DP, LD, kStream>(ks + (st ^ 1) * kStr, kr, d, key0 + kStream, len, d);
      async_tile_f32<DP, LD, kStream>(vs + (st ^ 1) * kStr, vb, row_stride, key0 + kStream, len, d);
    }
    cp_async_commit();

    // P = exp2(Q K^T - lse2), 0 for keys at or past the length
    float s[kStreamN8][4];
    tf32_abt<DP, false>(s, q_addr, smem_u32(kt + gr * LD + tq));
    const bool tail = key0 + kStream > len;
#pragma unroll
    for (int n = 0; n < kStreamN8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fast_exp2(s[n][e] - lse_r[e / 2]);
        if (tail && key0 + n * 8 + 2 * tq + (e & 1) >= len) s[n][e] = 0.f;
      }
    }

    // dS = P (G V^T - delta), in fp32
    float ds[kStreamN8][4];
    tf32_abt<DP, true>(ds, g_addr, smem_u32(vt + gr * LD + tq));
#pragma unroll
    for (int n = 0; n < kStreamN8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = s[n][e] * (ds[n][e] - delta_r[e / 2]);
    }
    tf32_pb<DP>(dq, ds, smem_u32(kt + 2 * tq * LD + gr));  // dq_r / scale += dS K_r
  }
  cp_async_wait_all();  // the last (empty) group

  // Epilogue: rope_vjp(dq * scale) through this warp's rows of the q tile
  // (no other warp reads them).
  float* stage = qs + warp * kRowsPerWarp * LD;
  __syncwarp();
  stage_rows<DP>(stage, dq, cos_b, sin_b, row0, seq, d, dq_mul, true);
  __syncwarp();
  store_staged<float, DP, LD>(dq_dst, stage, row_stride, row0, seq, d);
}

}  // namespace
