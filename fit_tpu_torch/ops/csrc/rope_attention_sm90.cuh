// The bf16 forward of K1 (rope_attention.cu) for Hopper: a K pre-pass that
// rotates K once per call, then a warp-specialised key loop on wgmma fed by
// TMA. Design, bounds and costs are in rope_attention.cu's header note.
//
// rope_attention_kernel_rotate_k<DP> (RoPE only): a thread per 8-element
// chunk of a contiguous bf16 (B, H, T_pad, DP) scratch, T_pad = T rounded
// up to the key tile. It reads K through the caller's strides, rotates it
// pair by pair in fp32 (k cos + rot(k) sin, as q is rotated) and rounds to
// bf16; rows at or past len and columns at or past d are written as zeros.
//
// rope_attention_kernel_sm90<DP, ROPE>: one block per (128 query rows,
// head, batch row), three warpgroups. cross_attention_kernel_sm90<DP> runs
// the same block (sm90_block) over keys and values of a sequence of their
// own, kseq rows long, without RoPE: cross-attention to a text sequence.
//   warpgroup 0, the producer: gives up its registers (setmaxnreg 24) and
//     one thread keeps a two-stage ring of K and V tiles (kKeyTile keys x
//     DP) in flight by TMA, each tile behind a "full" mbarrier that counts
//     its bytes and an "empty" one that the 8 consumer warps arrive on. K
//     comes from the scratch with RoPE, else from the caller's view, as V
//     does; the tensor map's zero fill pads d to DP and rows past T.
//   warpgroups 1 and 2, the consumers (setmaxnreg 240), 64 query rows each:
//     q is rotated, scaled by q_mul = scale * log2(e) and rounded to bf16 on
//     load, as load_rotated does, into the swizzled layout wgmma reads.
//     Per key tile j:
//       S (64 x kKeyTile fp32, registers) = Q K_j^T, wgmma from two shared
//         memory descriptors (both K-major), DP / 16 k-steps;
//       keys at or past len masked on the last tile; the online softmax in
//         the exp2 domain on the quad of lanes that shares a row; P rounded
//         to bf16 before both the row sum and the product; O rescaled;
//       O (64 x DP fp32, registers) += P V_j, wgmma with P's A fragments in
//         registers (the S accumulators of two n8 tiles make one k16
//         fragment) and V_j from shared memory, N-major (transposed).
//     The epilogue stages O / l as bf16 through the warpgroup's rows of the
//     Q tile for 16-byte stores by the caller's strides, and writes
//     lse2 = m + log2(l).
//
// Shared memory layout (Sm90Layout). Every tile is stored as column blocks
// of (rows x kAtom) bf16 under the swizzle of the atom's row width: 64
// elements and the 128-byte swizzle from DP 64 up (DP 80 in two blocks, the
// second holding columns 64-79 and TMA's zeros), 32 and 64 bytes at DP 32,
// 16 and 32 bytes at DP 16. TMA writes K and V tiles in that layout, the
// consumers write Q and the output staging by the same swizzle function,
// and the wgmma descriptors describe it: the K-major operands (Q, K) step a
// k16 slice 32 bytes on within an atom and a column block on past it, with
// 8-row groups 8 atom rows apart; the N-major V steps 16 keys by 16 atom
// rows, with the next column block (the leading byte offset) kKeyTile atom
// rows away. Products stop at DP: S takes DP / 16 k-steps and P V is N =
// DP wide, so DP 80's padding to 128 columns costs shared memory, not
// tensor-core work. At DP 80 and 128 a block takes Q 32 KB and two stages
// of K and V, 160 KB in all: one block an SM.

#pragma once

#include <cuda.h>

#include "rope_tiles.cuh"

namespace {

constexpr int kSm90Rows = 128;       // query rows a block: two consumer warpgroups of 64
constexpr int kSm90Threads = 384;    // the producer warpgroup and two consumer warpgroups
constexpr int kKeyTile = 128;        // keys a tile
constexpr int kSm90Stages = 2;       // K and V tiles in flight
constexpr int kRotateThreads = 256;  // the pre-pass's block

// A tile's shared-memory layout at a head-dim padding: kCols column blocks
// of (rows x kAtom) bf16, each row one swizzle atom of kAtomBytes. The atom
// is 64 elements (128-byte rows, the 128-byte swizzle) from DP 64 up, else
// DP itself (DP 16: 32 bytes, DP 32: 64 bytes). DP 80 takes two 64-wide
// column blocks, the second filled to column 80 (TMA zero-fills the rest,
// and no product reads it): TMA moves a 128-row box at one row request a
// row, and 16-element boxes (32-byte rows, five a tile) left the key loop
// waiting on its copies.
template <int DP>
struct Sm90Layout {
  static constexpr int kAtom = DP < 64 ? DP : 64;
  static constexpr int kAtomBytes = kAtom * 2;
  static constexpr int kCols = (DP + kAtom - 1) / kAtom;
  static constexpr int kWidth = kCols * kAtom;        // columns stored: DP, or 128 at DP 80
  static constexpr int kGroupBytes = 8 * kAtomBytes;  // an 8-row group of one column block
  static constexpr int kMode = kAtom == 64 ? 1 : kAtom == 32 ? 2 : 3;  // the wgmma descriptor's swizzle
  static constexpr int kTileBytes = kKeyTile * kWidth * 2;

  // Element offset of (row r, columns c..c+7) in a tile of `rows` rows; c
  // is a multiple of 8. The swizzle XORs the 16-byte chunk index within
  // the atom's row with the row's bits above 128 bytes (row bits 0-2 at
  // 128 bytes, 1-2 at 64, 2 at 32), as TMA and wgmma apply it to shared
  // addresses: every tile starts on a 1024-byte boundary.
  __device__ static __forceinline__ int offset(int r, int c, int rows) {
    const int chunk = (c % kAtom) / 8;
    const int sw = chunk ^ ((r * kAtomBytes / 128) & (kAtom / 8 - 1));
    return (c / kAtom) * rows * kAtom + r * kAtom + sw * 8;
  }

  // Byte offset of k-step kk (16 columns) in a K-major operand of `rows`
  // rows: 32 bytes on within an atom, a column block on past it.
  __device__ static __forceinline__ uint32_t kstep(int kk, int rows) {
    return (kk / (kAtom / 16)) * rows * kAtomBytes + (kk % (kAtom / 16)) * 32;
  }
};

template <int DP>
constexpr size_t sm90_smem_bytes() {
  // 1024 bytes of slack to align the base, the Q tile, K and V tiles, then 4 barriers a stage
  return 1024 + kSm90Rows * Sm90Layout<DP>::kWidth * 2 + 2 * kSm90Stages * Sm90Layout<DP>::kTileBytes +
         4 * kSm90Stages * 8;
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lead_bytes, uint32_t stride_bytes,
                                               int mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lead_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((stride_bytes >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(mode) << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accesses of an accumulator across a
// wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma m64nNk16, f32 += bf16 x bf16: ss (A and B from shared memory, the
// scores, N = kKeyTile) and rs (A from registers, the output, N = DP).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d (64 x 16) += A (64 x 16, registers) B (16 x 16, shared, N-major)
  __device__ static __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  // d (64 x 32) += A (64 x 16, registers) B (16 x 32, shared, N-major)
  __device__ static __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, N-major)
  __device__ static __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  // d (64 x 80) += A (64 x 16, registers) B (16 x 80, shared, N-major)
  __device__ static __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128) (+)= A (64 x 16, shared, K-major) B (16 x 128, shared, K-major)
  __device__ static __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d (64 x 128) += A (64 x 16, registers) B (16 x 128, shared, N-major)
  __device__ static __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4D (d, T, H, B) tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 64 rows of one head's q from row0 (columns 0..d), rotated pair by pair
// and multiplied by `mul` exactly as load_rotated does, into rows rbase ..
// rbase + 63 of the block's swizzled (128, DP) Q tile; rows at or past
// `valid` and columns at or past d are zero. `tid` is the thread's index in
// its warpgroup. A thread's chunks are read four at a time, all loads of a
// batch before any arithmetic, so their latencies overlap.
template <int DP, bool ROPE>
__device__ __forceinline__ void load_q_swizzled(bf16* qs, const bf16* src, const float* cos_b, const float* sin_b,
                                                int64_t row_stride, int row0, int rbase, int valid, int d,
                                                float mul, int tid) {
  constexpr int kChunks = DP / 8;
  constexpr int kPerThread = kChunks / 2;  // 64 rows of kChunks chunks over 128 threads
  constexpr int kBatch = kPerThread < 4 ? kPerThread : 4;
#pragma unroll
  for (int it0 = 0; it0 < kPerThread; it0 += kBatch) {
    float x[kBatch][8], cs[kBatch][8], sn[kBatch][8];
    bool ok[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch && it0 + u < kPerThread; ++u) {
      const int i = tid + (it0 + u) * 128;
      const int row = row0 + i / kChunks;
      const int c = (i % kChunks) * 8;
      ok[u] = row < valid && c < d;
      if (ok[u]) {
        load8(x[u], src + row * row_stride + c);
        if constexpr (ROPE) {
          const int64_t t = static_cast<int64_t>(row) * d + c;
          load8(cs[u], cos_b + t);
          load8(sn[u], sin_b + t);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch && it0 + u < kPerThread; ++u) {
      const int i = tid + (it0 + u) * 128;
      float o[8];
      if (ok[u]) {
        if constexpr (ROPE) {
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            o[j] = (x[u][j] * cs[u][j] - x[u][j + 1] * sn[u][j]) * mul;
            o[j + 1] = (x[u][j + 1] * cs[u][j + 1] + x[u][j] * sn[u][j + 1]) * mul;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) o[j] = x[u][j] * mul;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = 0.f;
      }
      store8(qs + Sm90Layout<DP>::offset(rbase + i / kChunks, (i % kChunks) * 8, kSm90Rows), o);
    }
  }
}

// The K pre-pass: k rotated once into the contiguous (B, H, t_pad, DP)
// scratch `kr`, zeros at rows >= len and columns >= d.
template <int DP>
__global__ void __launch_bounds__(kRotateThreads)
    rope_attention_kernel_rotate_k(const bf16* __restrict__ k, Layout lk, const float* __restrict__ cos_t,
                                   const float* __restrict__ sin_t, const int* __restrict__ lengths,
                                   bf16* __restrict__ kr, int batch, int seq, int t_pad, int heads, int d) {
  constexpr int kChunks = DP / 8;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRotateThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(batch) * heads * t_pad * kChunks) return;
  const int c = static_cast<int>(i % kChunks) * 8;
  int64_t rest = i / kChunks;
  const int t = static_cast<int>(rest % t_pad);
  rest /= t_pad;
  const int h = static_cast<int>(rest % heads);
  const int64_t b = rest / heads;
  const int len = min(max(lengths[b], 1), seq);
  float y[8];
  if (t < len && c < d) {
    float x[8], cs[8], sn[8];
    load8(x, k + b * lk.b + t * lk.t + h * lk.h + c);
    const int64_t at = (b * seq + t) * d + c;
    load8(cs, cos_t + at);
    load8(sn, sin_t + at);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      y[j] = x[j] * cs[j] - x[j + 1] * sn[j];
      y[j + 1] = x[j + 1] * cs[j + 1] + x[j] * sn[j + 1];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = 0.f;
  }
  store8(kr + i * 8, y);
}

// The key loop of one block, shared by both kernels below. kmap and vmap
// are 4D (d or DP, T or t_pad, H, B) bf16 tensor maps with (kAtom,
// kKeyTile, 1, 1) boxes and the layout's swizzle (the kernels' own
// __grid_constant__ parameters). seq is the query rows' count (q, out, lse
// and the tables); kseq the keys', which lengths[b] is clamped to.
template <int DP, bool ROPE>
__device__ __forceinline__ void sm90_block(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                           const bf16* __restrict__ q, bf16* __restrict__ out, Layout lq, Layout lo,
                                           const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                                           const int* __restrict__ lengths, float* __restrict__ lse, int seq,
                                           int kseq, int heads, int d, float q_mul) {
  static_assert(DP % 16 == 0 && DP <= 128, "DP is a multiple of 16, at most 128");
  using L = Sm90Layout<DP>;
  constexpr int kAtom = L::kAtom;
  constexpr int kN = kKeyTile / 2;   // S floats a thread
  constexpr int kO = DP / 2;         // O floats a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  bf16* qs = reinterpret_cast<bf16*>(base);
  const uint32_t qs_addr = smem_u32(qs);
  const uint32_t ks_addr = qs_addr + kSm90Rows * L::kWidth * 2;              // kSm90Stages K tiles
  const uint32_t vs_addr = ks_addr + kSm90Stages * L::kTileBytes;            // kSm90Stages V tiles
  const uint32_t bars = vs_addr + kSm90Stages * L::kTileBytes;               // full K, full V, empty K, empty V
  const auto full_k = [&](int s) { return bars + 8 * s; };
  const auto full_v = [&](int s) { return bars + 8 * (kSm90Stages + s); };
  const auto empty_k = [&](int s) { return bars + 8 * (2 * kSm90Stages + s); };
  const auto empty_v = [&](int s) { return bars + 8 * (3 * kSm90Stages + s); };

  const int q0 = blockIdx.x * kSm90Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(lengths[b], 1), kseq);
  const int ntiles = (len + kKeyTile - 1) / kKeyTile;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSm90Stages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);  // lane 0 of every consumer warp
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(kmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(vmap)) : "memory");
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kSm90Stages;
        const uint32_t parity = ((j / kSm90Stages) & 1) ^ 1;
        mbar_wait(empty_k(s), parity);
        mbar_expect_tx(full_k(s), L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) {
          tma_load(ks_addr + s * L::kTileBytes + c * kKeyTile * L::kAtomBytes, kmap, c * kAtom, j * kKeyTile, h,
                   b, full_k(s));
        }
        mbar_wait(empty_v(s), parity);
        mbar_expect_tx(full_v(s), L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) {
          tma_load(vs_addr + s * L::kTileBytes + c * kKeyTile * L::kAtomBytes, vmap, c * kAtom, j * kKeyTile, h,
                   b, full_v(s));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;  // this warpgroup's 64 rows of the block's 128
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // the fragment rows g and g + 8 of the warp's 16
    const int tq = lane & 3;  // the column pair within each n8 tile
    const bf16* qb = q + b * lq.b + h * lq.h;
    const float* cos_b = ROPE ? cos_t + static_cast<int64_t>(b) * seq * d : nullptr;
    const float* sin_b = ROPE ? sin_t + static_cast<int64_t>(b) * seq * d : nullptr;
    load_q_swizzled<DP, ROPE>(qs, qb, cos_b, sin_b, lq.t, q0 + 64 * cw, 64 * cw, seq, d, q_mul, tid);
    // the generic proxy's writes, made visible to wgmma, then the warpgroup's barrier
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

    float o[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    const uint32_t q_addr = qs_addr + 64 * cw * L::kAtomBytes;

    for (int j = 0; j < ntiles; ++j) {
      const int s_ = j % kSm90Stages;
      const uint32_t parity = (j / kSm90Stages) & 1;
      const uint32_t k_addr = ks_addr + s_ * L::kTileBytes;
      const uint32_t v_addr = vs_addr + s_ * L::kTileBytes;

      // S = Q K_j^T
      float s[kN];
      mbar_wait(full_k(s_), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        Wgmma<kKeyTile>::ss(s, wgmma_desc(q_addr + L::kstep(kk, kSm90Rows), 16, L::kGroupBytes, L::kMode),
                            wgmma_desc(k_addr + L::kstep(kk, kKeyTile), 16, L::kGroupBytes, L::kMode), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if (lane == 0) mbar_arrive(empty_k(s_));

      // Online softmax over the quad that shares each row. Every tile holds a
      // valid key (j * kKeyTile < len), so the new max is finite; masked keys
      // give exp2(-inf) = 0, and the first tile's alpha = exp2(-inf) rescales zeros.
      const int k0 = j * kKeyTile;
      if (k0 + kKeyTile > len) {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          if (k0 + (i / 4) * 8 + 2 * tq + (i & 1) >= len) s[i] = -INFINITY;
        }
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int n = 0; n < kN / 4; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
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
      uint32_t pf[kKeyTile / 16][4];  // A fragments of P, one per 16-key step
#pragma unroll
      for (int n = 0; n < kN / 4; ++n) {
        const __nv_bfloat162 p_lo =
            __floats2bfloat162_rn(fast_exp2(s[4 * n] - mx[0]), fast_exp2(s[4 * n + 1] - mx[0]));
        const __nv_bfloat162 p_hi =
            __floats2bfloat162_rn(fast_exp2(s[4 * n + 2] - mx[1]), fast_exp2(s[4 * n + 3] - mx[1]));
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
      for (int n = 0; n < kO / 4; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }

      // O += P V_j
      mbar_wait(full_v(s_), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        Wgmma<DP>::rs(o, pf[kk],
                      wgmma_desc(v_addr + kk * 16 * L::kAtomBytes, kKeyTile * L::kAtomBytes, L::kGroupBytes,
                                 L::kMode));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty_v(s_));
    }

    // Epilogue: O / l as bf16 into this warp's 16 rows of the Q tile (no
    // wgmma reads them any more), then 16-byte stores by the output's strides.
    const int r0 = 64 * cw + 16 * warp;
    const float inv_l[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
    for (int n = 0; n < kO / 4; ++n) {
      const int c = n * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(qs + L::offset(r0 + g, c & ~7, kSm90Rows) + (c & 7)) =
          pack_bf16(o[4 * n] * inv_l[0], o[4 * n + 1] * inv_l[0]);
      *reinterpret_cast<uint32_t*>(qs + L::offset(r0 + g + 8, c & ~7, kSm90Rows) + (c & 7)) =
          pack_bf16(o[4 * n + 2] * inv_l[1], o[4 * n + 3] * inv_l[1]);
    }
    if (lse != nullptr && tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + r0 + g + 8 * r;
        if (row < seq) lse[(static_cast<int64_t>(b) * seq + row) * heads + h] = m_run[r] + log2f(l_run[r]);
      }
    }
    __syncwarp();
    bf16* ob = out + b * lo.b + h * lo.h;
    constexpr int kChunksPerRow = DP / 8;
#pragma unroll
    for (int e = lane; e < 16 * kChunksPerRow; e += 32) {
      const int r = e / kChunksPerRow;
      const int c = (e % kChunksPerRow) * 8;
      const int row = q0 + r0 + r;
      if (row < seq && c < d) {
        *reinterpret_cast<uint4*>(ob + row * lo.t + c) =
            *reinterpret_cast<const uint4*>(qs + L::offset(r0 + r, c, kSm90Rows));
      }
    }
  }
}

// K1's key loop over the query rows' own keys (self-attention; RoPE or not).
template <int DP, bool ROPE>
__global__ void __launch_bounds__(kSm90Threads, 1)
    rope_attention_kernel_sm90(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                               const bf16* __restrict__ q, bf16* __restrict__ out, Layout lq, Layout lo,
                               const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                               const int* __restrict__ lengths, float* __restrict__ lse, int seq, int heads,
                               int d, float q_mul) {
  sm90_block<DP, ROPE>(&kmap, &vmap, q, out, lq, lo, cos_t, sin_t, lengths, lse, seq, seq, heads, d, q_mul);
}

// The same key loop over a key sequence of its own (cross-attention: kseq
// keys and values of another tensor, RoPE off), under a name of its own so
// that a trace tells it from self-attention.
template <int DP>
__global__ void __launch_bounds__(kSm90Threads, 1)
    cross_attention_kernel_sm90(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                                const bf16* __restrict__ q, bf16* __restrict__ out, Layout lq, Layout lo,
                                const int* __restrict__ lengths, int seq, int kseq, int heads, int d, float q_mul) {
  sm90_block<DP, false>(&kmap, &vmap, q, out, lq, lo, nullptr, nullptr, lengths, nullptr, seq, kseq, heads, d,
                        q_mul);
}

}  // namespace
