// The bf16 backward of K2 (rope_attention_bwd.cu) on warp-level tensor-core
// instructions: three launches, no atomics, so the result is deterministic.
//
// Replaces fit_tpu/ops/fused_attention.py's _bwd_kernel, _qkv_bwd_kernel,
// _qkv_chunked_bwd_kernel, _qkv_chunked_dq_kernel and _qkv_chunked_dkv_kernel
// (the formulas are in rope_attention_bwd.cu's header).
//
// 1. Prologue (bwd_prologue_kernel): one thread per 8-element chunk of a
//    (row, head), writing the scratch in order. It gives delta =
//    rowsum(g * out) in fp32 (the chunks' shares summed in order); q_r *
//    q_mul and k_r once as bf16 into head-major (B, H, T, d) scratch (the
//    fp32 expression and the single rounding of load_rotated, so both
//    passes read the values K1 computed and the probabilities agree with
//    K1's lse); and lse2 and delta head-major (B, H, T rounded up to 64) in
//    fp32, so that a query tile's 64 statistics move as 16-byte copies.
//    cos and sin are read once per element, not once per tile.
// 2. dk/dv pass (bwd_dkdv_mma_kernel): one block per (64 keys, head, batch
//    row), 4 warps of 16 keys. k_r and v sit in shared memory for the whole
//    loop; q_r, g, lse2 and delta stream through a two-stage cp.async ring
//    over every query tile (padded query rows included: the forward gave
//    them a softmax over the valid keys). Per query tile each warp computes
//    S^T = K Q^T and dP^T = V G^T into registers (K and V as ldmatrix A
//    fragments of its own rows, Q and G as B fragments by plain ldmatrix),
//    P^T = exp2(S^T - lse2) rounded to bf16, dS^T = P^T (dP^T - delta)
//    rounded to bf16, and dv += P^T G, dk += dS^T Q with P^T and dS^T as A
//    fragments made from the accumulators and G, Q as B fragments by
//    ldmatrix.trans. dk and dv stay in registers; the epilogue applies
//    rope_vjp / log2(e) to dk, writes zero rows for keys at or past the
//    length, and stores 16-byte chunks through the warp's rows of the K
//    and V tiles. Query rows past T arrive as zeros (q, g, lse2 and delta
//    zero-filled), so they add exactly 0.
// 3. dq pass (bwd_dq_mma_kernel): one block per (64 queries, head, batch
//    row), the forward's loop plus one product: q_r and g are A fragments
//    held for the whole loop, k_r and v stream through a two-stage cp.async
//    ring over the keys below the length, S = Q K^T and dP = G V^T in
//    registers, P (masked past the length) and dS as above, dq += dS K
//    with K by ldmatrix.trans; the epilogue applies rope_vjp * scale.
//
// Both passes take each 64-row tile in two 32-column sub-steps (below).
//
// This does 7 products per (query tile, key tile) against the minimal 5 (S
// and dP are computed in both passes): fusing dq into the dk/dv pass would
// need atomics, or a (T / 64)-deep fp32 buffer of partial dq, and a fixed
// order is what makes a resumed training run repeat its loss stream bit
// for bit. At FiT-B/2 training (B 64, T 256, H 12, d 64) bytes bound K2
// (~63 us at 3.35 TB/s, against ~33 us for the 5 products at 989
// TFLOP/s); at XL T 4096 operations do (~191 us).
//
// Shared memory: six (64, DP + 8) bf16 tiles a block (K, V and two stages
// of Q and G; or Q and G staging and two stages of K and V) and, in the
// dk/dv pass, two stages of 128 floats: 56 KB at DP 64, 68 KB at DP 80.
// The padded row stride puts an ldmatrix's 8 rows on distinct bank quads.

#pragma once

#include "rope_tiles.cuh"

namespace {

template <int DP>
constexpr size_t bwd_mma_smem_bytes() {
  return 6 * kBlockK * Strides<bf16, DP>::kTile * sizeof(bf16) + 2 * 2 * kBlockQ * sizeof(float);
}

// A bf16 pair of an mma fragment -> two floats, exactly (the low half is
// the lower column).
__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// The prologue's block: 32 (batch row, head, token) rows, one thread per
// 8-element chunk of each, so a block has 32 * d / 8 threads (at most 512).
constexpr int kPrologueRows = 32;

// T is the activations' type: bf16 (the rotated q and k rounded once) or
// fp32 (the 3xTF32 passes of rope_attention_bwd_tf32.cuh read them as they
// are).
template <typename T>
__global__ void __launch_bounds__(512)
    bwd_prologue_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                        const T* __restrict__ out, const float* __restrict__ lse,
                        const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                        T* __restrict__ q_rot, T* __restrict__ k_rot,
                        float* __restrict__ lse_h, float* __restrict__ delta_h, int batch, int seq,
                        int seq_pad, int heads, int d, float q_mul) {
  __shared__ float part[512];  // each chunk's share of its row's delta
  // Rows in head-major order, (b, h, t) -> (b * H + h) * T + t, so that
  // neighbouring threads write neighbouring bytes of the scratch.
  const int nc = d / 8;
  const int c = (threadIdx.x % nc) * 8;
  const int64_t rows = static_cast<int64_t>(batch) * heads * seq;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kPrologueRows + threadIdx.x / nc;
  const int width = heads * d;
  float acc = 0.f;
  if (row < rows) {
    const int t = static_cast<int>(row % seq);
    const int64_t bh = row / seq;
    const int h = static_cast<int>(bh % heads);
    const int64_t bt = (bh / heads) * seq + t;
    const T* q = qkv + bt * 3 * width + h * d + c;
    float a[8], o[8], cs[8], sn[8], x[8], y[8], xr[8], yr[8];
    load8(a, g + bt * width + h * d + c);
    load8(o, out + bt * width + h * d + c);
    load8(cs, cos_t + bt * d + c);
    load8(sn, sin_t + bt * d + c);
    load8(x, q);
    load8(y, q + width);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += a[j] * o[j];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      xr[j] = (x[j] * cs[j] - x[j + 1] * sn[j]) * q_mul;
      xr[j + 1] = (x[j + 1] * cs[j + 1] + x[j] * sn[j + 1]) * q_mul;
      yr[j] = y[j] * cs[j] - y[j + 1] * sn[j];
      yr[j + 1] = y[j + 1] * cs[j + 1] + y[j] * sn[j + 1];
    }
    store8(q_rot + row * d + c, xr);
    store8(k_rot + row * d + c, yr);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  // one thread per row sums its chunks in order and moves its statistics
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kPrologueRows + threadIdx.x;
  if (threadIdx.x < kPrologueRows && r < rows) {
    float delta = 0.f;
    for (int j = 0; j < nc; ++j) delta += part[threadIdx.x * nc + j];
    const int t = static_cast<int>(r % seq);
    const int64_t bh = r / seq;
    const int64_t bt = (bh / heads) * seq + t;
    lse_h[bh * seq_pad + t] = lse[bt * heads + bh % heads];
    delta_h[bh * seq_pad + t] = delta;
  }
}

// ROWS lse2 values, then ROWS deltas, of query rows [q0, q0 + ROWS) by
// cp.async from one (batch row, head)'s rows of the head-major statistics;
// values past `seq` are zero-filled. The first ROWS / 2 threads issue the
// 16-byte copies.
template <int ROWS = kBlockQ>
__device__ __forceinline__ void async_stats(float* dst, const float* lse_bh, const float* delta_bh,
                                            int q0, int seq) {
  constexpr int kCopies = ROWS / 4;  // of each array
  if (threadIdx.x < 2 * kCopies) {
    const int i = threadIdx.x % kCopies;
    const float* src = (threadIdx.x < kCopies ? lse_bh : delta_bh) + q0 + 4 * i;
    const int n = min(max(seq - (q0 + 4 * i), 0), 4);
    cp_async16_n(smem_u32(dst + (threadIdx.x / kCopies) * ROWS + 4 * i), n ? src : lse_bh, 4 * n);
  }
}

// rope_vjp(x * mul) of one accumulator pair (columns col, col + 1 of `row`):
// x cos - rot(x sin), rot(a, b) = (-b, a).
__device__ __forceinline__ float2 rope_vjp2(float x0, float x1, const float* cos_b, const float* sin_b,
                                            int row, int col, int d, float mul) {
  const float2 cs = *reinterpret_cast<const float2*>(cos_b + static_cast<int64_t>(row) * d + col);
  const float2 sn = *reinterpret_cast<const float2*>(sin_b + static_cast<int64_t>(row) * d + col);
  x0 *= mul;
  x1 *= mul;
  return make_float2(x0 * cs.x + x1 * sn.y, x1 * cs.y - x0 * sn.x);
}

// rope_vjp2 as a bf16 pair.
__device__ __forceinline__ uint32_t rope_vjp_pair(float x0, float x1, const float* cos_b,
                                                  const float* sin_b, int row, int col, int d,
                                                  float mul) {
  const float2 r = rope_vjp2(x0, x1, cos_b, sin_b, row, col, d, mul);
  return pack_bf16(r.x, r.y);
}

// Stores this warp's 16 staged rows (row stride LD elements) into the rows
// [row0, row0 + 16) below `seq` of a row-strided (T, d) destination, as
// 16-byte chunks.
template <typename T, int DP, int LD = Strides<T, DP>::kTile>
__device__ __forceinline__ void store_staged(T* dst, const T* stage, int64_t row_stride, int row0,
                                             int seq, int d) {
  constexpr int kChunk = 16 / sizeof(T);  // elements a chunk
  constexpr int kChunksPerRow = DP / kChunk;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int e = lane; e < kRowsPerWarp * kChunksPerRow; e += 32) {
    const int r = e / kChunksPerRow;
    const int c = (e % kChunksPerRow) * kChunk;
    const int row = row0 + r;
    if (row < seq && c < d) {
      *reinterpret_cast<uint4*>(dst + row * row_stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
    }
  }
}

// A dk/dv block whose keys all lie at or past the length: dk = dv = 0 on
// its rows below `seq`, in 16-byte chunks.
template <typename T, int DP>
__device__ __forceinline__ void zero_key_rows(T* dk_dst, T* dv_dst, int64_t row_stride, int k0, int seq,
                                              int d) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kChunksPerRow = DP / kChunk;
  for (int i = threadIdx.x; i < kBlockK * kChunksPerRow; i += kThreads) {
    const int row = k0 + i / kChunksPerRow;
    const int c = (i % kChunksPerRow) * kChunk;
    if (row < seq && c < d) {
      *reinterpret_cast<uint4*>(dk_dst + row * row_stride + c) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv_dst + row * row_stride + c) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Both passes take each 64-row tile of the loop in two sub-steps of 32
// columns: the scores and their bf16 fragments then take 24 registers a
// thread, not 48 (with 64 columns DP 64 spilled under 3 blocks an SM; 16
// columns ran slower). kSub is the sub-step's width, kSubN8 its n8 tiles,
// kSub16 its k16 steps.
constexpr int kSub = 32;
constexpr int kSubN8 = kSub / 8;
constexpr int kSub16 = kSub / 16;

// s (16 x 32 fp32) = A (this warp's 16 rows of a (64, DP) tile, by
// ldmatrix at a_ld) B^T (32 rows of a (64, DP) tile from b_tile, B
// fragments by plain ldmatrix at b_ld).
template <int DP>
__device__ __forceinline__ void mma_abt(float (&s)[kSubN8][4], const bf16* a_tile, const bf16* b_tile,
                                        int a_ld, int b_ld) {
  constexpr int kTile = Strides<bf16, DP>::kTile;
#pragma unroll
  for (int n = 0; n < kSubN8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, smem_u32(a_tile + a_ld + kk * 16));
#pragma unroll
    for (int np = 0; np < kSubN8 / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, smem_u32(b_tile + np * 16 * kTile + kk * 16 + b_ld));
      mma_bf16(s[2 * np], af, bf[0], bf[1]);
      mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// s (16 x 32) = A (16 x DP, A fragments held in registers) B^T (32 rows of
// a (64, DP) tile from b_tile, B fragments by plain ldmatrix at b_ld).
template <int DP>
__device__ __forceinline__ void mma_frag_bt(float (&s)[kSubN8][4], const uint32_t (&af)[DP / 16][4],
                                            const bf16* b_tile, int b_ld) {
  constexpr int kTile = Strides<bf16, DP>::kTile;
#pragma unroll
  for (int n = 0; n < kSubN8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kSubN8 / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, smem_u32(b_tile + np * 16 * kTile + kk * 16 + b_ld));
      mma_bf16(s[2 * np], af[kk], bf[0], bf[1]);
      mma_bf16(s[2 * np + 1], af[kk], bf[2], bf[3]);
    }
  }
}

// acc (16 x DP fp32) += P (16 x 32, bf16 A fragments by 16-column step) B
// (32 rows of a (64, DP) tile from b_tile, row-major in its k dim, B
// fragments by ldmatrix.trans at bt_ld).
template <int DP>
__device__ __forceinline__ void mma_pb(float (&acc)[DP / 8][4], const uint32_t (&pf)[kSub16][4],
                                       const bf16* b_tile, int bt_ld) {
  constexpr int kTile = Strides<bf16, DP>::kTile;
#pragma unroll
  for (int kk = 0; kk < kSub16; ++kk) {
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, smem_u32(b_tile + kk * 16 * kTile + np * 16 + bt_ld));
      mma_bf16(acc[2 * np], pf[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], pf[kk], bf[2], bf[3]);
    }
  }
}

// The lane's ldmatrix row addresses within a (64, DP + 8) tile: A fragments
// of warp w's 16 rows; B fragments of two n8 tiles by one k16 step (plain,
// for A B^T); and of one k16 step by two n8 tiles (transposed, for P B).
struct LdAddr {
  int a, b, bt;
};

template <int DP>
__device__ __forceinline__ LdAddr ld_addr(int warp, int lane) {
  constexpr int kTile = Strides<bf16, DP>::kTile;
  return {(warp * kRowsPerWarp + (lane & 15)) * kTile + (lane >> 4) * 8,
          ((lane & 7) + ((lane >> 4) << 3)) * kTile + ((lane >> 3) & 1) * 8,
          ((lane & 7) + (((lane >> 3) & 1) << 3)) * kTile + (lane >> 4) * 8};
}

// Blocks an SM must hold: 3 at DP <= 64 (up to 168 registers a thread); 2
// at DP 80, whose dk and dv take 80 registers (under the cap of 3 blocks it
// spilled; with 2 it runs as fast or faster), and at DP 128.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 3 : 2)
    bwd_dkdv_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                        const bf16* __restrict__ q_rot, const bf16* __restrict__ k_rot,
                        const float* __restrict__ lse_h, const float* __restrict__ delta_h,
                        const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                        const int* __restrict__ lengths, bf16* __restrict__ dqkv, int seq,
                        int seq_pad, int heads, int d, float dk_mul) {
  static_assert(DP % 16 == 0 && DP <= 128, "DP is a multiple of 16, at most 128");
  constexpr int kTile = Strides<bf16, DP>::kTile;
  constexpr int kTileElems = kBlockK * kTile;
  constexpr int kD16 = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // (64, DP) k_r of this block's keys; dk staging at the end
  bf16* vs = ks + kTileElems;                // (64, DP) v; dv staging at the end
  bf16* qs = vs + kTileElems;                // 2 stages of (64, DP) q_r * q_mul
  bf16* gs = qs + 2 * kTileElems;            // 2 stages of (64, DP) g
  float* stat_s = reinterpret_cast<float*>(gs + 2 * kTileElems);  // 2 stages of lse2[64], delta[64]

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int width = heads * d;
  const int64_t row_stride = 3LL * width;
  const int64_t bh = b * heads + h;
  const bf16* qr = q_rot + bh * seq * d;
  const bf16* kr = k_rot + bh * seq * d;
  const bf16* vb = qkv + b * seq * row_stride + 2 * width + h * d;
  const bf16* gb = g + b * seq * width + h * d;
  const float* lse_bh = lse_h + bh * seq_pad;
  const float* delta_bh = delta_h + bh * seq_pad;
  bf16* dk_dst = dqkv + b * seq * row_stride + width + h * d;
  bf16* dv_dst = dk_dst + width;
  const float* cos_b = cos_t + b * seq * d;
  const float* sin_b = sin_t + b * seq * d;
  const int len = min(max(lengths[b], 1), seq);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (k0 >= len) {  // masked keys: dk = dv = 0
    zero_key_rows<bf16, DP>(dk_dst, dv_dst, row_stride, k0, seq, d);
    return;
  }

  const int nq = (seq + kBlockQ - 1) / kBlockQ;
  async_tile<DP>(ks, kr, d, k0, len, d);
  async_tile<DP>(vs, vb, row_stride, k0, len, d);
  async_tile<DP>(qs, qr, d, 0, seq, d);
  async_tile<DP>(gs, gb, width, 0, seq, d);
  async_stats(stat_s, lse_bh, delta_bh, 0, seq);
  cp_async_commit();

  float dk[2 * kD16][4], dv[2 * kD16][4];  // rows g (0, 1) and g + 8 (2, 3) of this warp's keys
#pragma unroll
  for (int n = 0; n < 2 * kD16; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  const LdAddr ld = ld_addr<DP>(warp, lane);
  const int tq = lane & 3;

  for (int j = 0; j < nq; ++j) {
    const int st = j & 1;
    const bf16* qt = qs + st * kTileElems;
    const bf16* gt = gs + st * kTileElems;
    const float* lse_s = stat_s + st * 2 * kBlockQ;
    const float* delta_s = lse_s + kBlockQ;
    // Query tile j has landed (this thread's copies, then everyone's), and
    // every warp is done with tile j-1, whose stage tile j+1 now fills.
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < nq) {
      const int q1 = (j + 1) * kBlockQ;
      async_tile<DP>(qs + (st ^ 1) * kTileElems, qr, d, q1, seq, d);
      async_tile<DP>(gs + (st ^ 1) * kTileElems, gb, width, q1, seq, d);
      async_stats(stat_s + (st ^ 1) * 2 * kBlockQ, lse_bh, delta_bh, q1, seq);
    }
    cp_async_commit();

#pragma unroll
    for (int sub = 0; sub < kBlockQ / kSub; ++sub) {
      if (j * kBlockQ + sub * kSub >= seq) break;  // rows past T add nothing
      const bf16* qsub = qt + sub * kSub * kTile;
      const bf16* gsub = gt + sub * kSub * kTile;
      const float* lse_sub = lse_s + sub * kSub;
      const float* delta_sub = delta_s + sub * kSub;
      // P^T = exp2(K Q^T - lse2), by query column, rounded to bf16 as A fragments
      float s[kSubN8][4];
      mma_abt<DP>(s, ks, qsub, ld.a, ld.b);
      uint32_t pf[kSub16][4];
#pragma unroll
      for (int n = 0; n < kSubN8; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(lse_sub + n * 8 + 2 * tq);
        pf[n / 2][(n & 1) * 2] = pack_bf16(fast_exp2(s[n][0] - l.x), fast_exp2(s[n][1] - l.y));
        pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(fast_exp2(s[n][2] - l.x), fast_exp2(s[n][3] - l.y));
      }
      mma_pb<DP>(dv, pf, gsub, ld.bt);  // dv += P^T G

      // dS^T = P^T (V G^T - delta), rounded to bf16, over P^T's fragments
      mma_abt<DP>(s, vs, gsub, ld.a, ld.b);
#pragma unroll
      for (int n = 0; n < kSubN8; ++n) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_sub + n * 8 + 2 * tq);
        uint32_t& lo = pf[n / 2][(n & 1) * 2];
        uint32_t& hi = pf[n / 2][(n & 1) * 2 + 1];
        const float2 p_lo = unpack_bf16(lo), p_hi = unpack_bf16(hi);
        lo = pack_bf16(p_lo.x * (s[n][0] - dl.x), p_lo.y * (s[n][1] - dl.y));
        hi = pack_bf16(p_hi.x * (s[n][2] - dl.x), p_hi.y * (s[n][3] - dl.y));
      }
      mma_pb<DP>(dk, pf, qsub, ld.bt);  // dk_r * scale * log2(e) += dS^T Q_r
    }
  }
  cp_async_wait_all();  // the last (empty) group

  // Epilogue: this warp's rows of the K and V tiles (no other warp reads
  // them) stage rope_vjp(dk / log2(e)) and dv as bf16; keys at or past the
  // length get zero rows.
  const int gr = lane >> 2;
  bf16* kst = ks + warp * kRowsPerWarp * kTile;
  bf16* vst = vs + warp * kRowsPerWarp * kTile;
  const int row0 = k0 + warp * kRowsPerWarp;
#pragma unroll
  for (int n = 0; n < 2 * kD16; ++n) {
    const int col = n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = gr + 8 * r;
      const bool ok = row0 + lr < len && col < d;
      *reinterpret_cast<uint32_t*>(kst + lr * kTile + col) =
          ok ? rope_vjp_pair(dk[n][2 * r], dk[n][2 * r + 1], cos_b, sin_b, row0 + lr, col, d, dk_mul) : 0u;
      *reinterpret_cast<uint32_t*>(vst + lr * kTile + col) =
          ok ? pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]) : 0u;
    }
  }
  __syncwarp();
  store_staged<bf16, DP>(dk_dst, kst, row_stride, row0, seq, d);
  store_staged<bf16, DP>(dv_dst, vst, row_stride, row0, seq, d);
}

// 3 blocks an SM at DP <= 80; 2 at DP 128.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 80 ? 3 : 2)
    bwd_dq_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                      const bf16* __restrict__ q_rot, const bf16* __restrict__ k_rot,
                      const float* __restrict__ lse_h, const float* __restrict__ delta_h,
                      const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                      const int* __restrict__ lengths, bf16* __restrict__ dqkv, int seq,
                      int seq_pad, int heads, int d, float dq_mul) {
  static_assert(DP % 16 == 0 && DP <= 128, "DP is a multiple of 16, at most 128");
  constexpr int kTile = Strides<bf16, DP>::kTile;
  constexpr int kTileElems = kBlockK * kTile;
  constexpr int kD16 = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // (64, DP) q_r * q_mul; dq staging at the end
  bf16* gs = qs + kTileElems;                // (64, DP) g
  bf16* ks = gs + kTileElems;                // 2 stages of (64, DP) k_r
  bf16* vs = ks + 2 * kTileElems;            // 2 stages of (64, DP) v

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int width = heads * d;
  const int64_t row_stride = 3LL * width;
  const int64_t bh = b * heads + h;
  const bf16* qr = q_rot + bh * seq * d;
  const bf16* kr = k_rot + bh * seq * d;
  const bf16* vb = qkv + b * seq * row_stride + 2 * width + h * d;
  const bf16* gb = g + b * seq * width + h * d;
  bf16* dq_dst = dqkv + b * seq * row_stride + h * d;
  const float* cos_b = cos_t + b * seq * d;
  const float* sin_b = sin_t + b * seq * d;
  const int len = min(max(lengths[b], 1), seq);
  const int ntiles = (len + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane >> 2;  // the fragment row (and row + 8) this lane holds
  const int tq = lane & 3;   // its column pair within an n8 tile

  async_tile<DP>(ks, kr, d, 0, len, d);
  async_tile<DP>(vs, vb, row_stride, 0, len, d);
  async_tile<DP>(qs, qr, d, q0, seq, d);
  async_tile<DP>(gs, gb, width, q0, seq, d);
  cp_async_commit();

  const int row0 = q0 + warp * kRowsPerWarp;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gr + 8 * r;
    lse_r[r] = row < seq ? lse_h[bh * seq_pad + row] : 0.f;
    delta_r[r] = row < seq ? delta_h[bh * seq_pad + row] : 0.f;
  }
  const LdAddr ld = ld_addr<DP>(warp, lane);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[kD16][4], gf[kD16][4];  // this warp's 16 query rows of q_r and g as A fragments
#pragma unroll
  for (int kk = 0; kk < kD16; ++kk) {
    ldmatrix_x4(qf[kk], smem_u32(qs + ld.a + kk * 16));
    ldmatrix_x4(gf[kk], smem_u32(gs + ld.a + kk * 16));
  }

  float dq[2 * kD16][4];
#pragma unroll
  for (int n = 0; n < 2 * kD16; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    const bf16* kt = ks + st * kTileElems;
    const bf16* vt = vs + st * kTileElems;
    cp_async_wait_all();
    __syncthreads();
    const int k0 = j * kBlockK;
    if (j + 1 < ntiles) {
      async_tile<DP>(ks + (st ^ 1) * kTileElems, kr, d, k0 + kBlockK, len, d);
      async_tile<DP>(vs + (st ^ 1) * kTileElems, vb, row_stride, k0 + kBlockK, len, d);
    }
    cp_async_commit();

#pragma unroll
    for (int sub = 0; sub < kBlockK / kSub; ++sub) {
      const bf16* ksub = kt + sub * kSub * kTile;
      const bf16* vsub = vt + sub * kSub * kTile;
      const int key0 = k0 + sub * kSub;
      if (key0 >= len) break;
      // P = exp2(Q K^T - lse2), 0 for keys at or past the length
      float s[kSubN8][4];
      mma_frag_bt<DP>(s, qf, ksub, ld.b);
      const bool tail = key0 + kSub > len;
      uint32_t pf[kSub16][4];
#pragma unroll
      for (int n = 0; n < kSubN8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = fast_exp2(s[n][e] - lse_r[e / 2]);
          if (tail && key0 + n * 8 + 2 * tq + (e & 1) >= len) p[e] = 0.f;
        }
        pf[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }

      // dS = P (G V^T - delta), rounded to bf16, over P's fragments
      mma_frag_bt<DP>(s, gf, vsub, ld.b);
#pragma unroll
      for (int n = 0; n < kSubN8; ++n) {
        uint32_t& lo = pf[n / 2][(n & 1) * 2];
        uint32_t& hi = pf[n / 2][(n & 1) * 2 + 1];
        const float2 p_lo = unpack_bf16(lo), p_hi = unpack_bf16(hi);
        lo = pack_bf16(p_lo.x * (s[n][0] - delta_r[0]), p_lo.y * (s[n][1] - delta_r[0]));
        hi = pack_bf16(p_hi.x * (s[n][2] - delta_r[1]), p_hi.y * (s[n][3] - delta_r[1]));
      }
      mma_pb<DP>(dq, pf, ksub, ld.bt);  // dq_r / scale += dS K_r
    }
  }
  cp_async_wait_all();  // the last (empty) group

  // Epilogue: rope_vjp(dq * scale) as bf16 through this warp's rows of the
  // q tile (no other warp reads them after the fragments were loaded).
  bf16* stage = qs + warp * kRowsPerWarp * kTile;
#pragma unroll
  for (int n = 0; n < 2 * kD16; ++n) {
    const int col = n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = gr + 8 * r;
      const bool ok = row0 + lr < seq && col < d;
      *reinterpret_cast<uint32_t*>(stage + lr * kTile + col) =
          ok ? rope_vjp_pair(dq[n][2 * r], dq[n][2 * r + 1], cos_b, sin_b, row0 + lr, col, d, dq_mul) : 0u;
    }
  }
  __syncwarp();
  store_staged<bf16, DP>(dq_dst, stage, row_stride, row0, seq, d);
}

}  // namespace
