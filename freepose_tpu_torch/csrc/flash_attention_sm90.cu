// Attention K2, K3 and K4 on Hopper: wgmma + TMA, bf16, head dims 64, 72
// and 256, with an optional per-batch key mask.
//
// Replaces, on the card, every bf16 call of three TPU kernels of
// freepose_tpu/ops/attention.py:
//   * K2 `_flash_kernel_single` (:75), the whole-K/V regime, through the
//     wrapper flash_attention_k2: DINOv2-L self-attention (d = 64), the
//     Hiera-L global blocks (d = 72) and SAM2 memory self-attention (d = 256);
//   * K3 `_flash_kernel` (:30, with `_kernel_squeeze` :70), the streaming
//     regime, through flash_attention_k3 (d = 256 at its test shape);
//   * K4 `_stream_kernel` (:208), streaming attention with a per-batch key
//     mask shared by the heads, through flash_attention_stream: SAM2 memory
//     cross-attention, [O objects, 1, 4096, 256] against 7 mask-memory slots
//     x 4,096 tokens + 16 pointers x 4 tokens = 28,736 keys, empty slots
//     masked.
// The dispatch in freepose_tpu_torch/ops/attention.py:_launch sends every
// bf16 call here; fp32 calls and K5 run csrc/flash_attention.cu.
//
// Function (the TPU kernels' semantics): softmax(q·kᵀ·scale)·v on bf16
// operands; logits, running max, running sum and accumulator in fp32; p
// rounded to bf16 before P·V; a masked key's logit is -1e30 in the units
// the online softmax compares (log2 units here), so a row whose keys are
// all masked averages V uniformly; keys at or past nk take -inf; output
// acc / max(l, 1e-30) in bf16.
//
// Bound on the H100 (4·n·(valid keys)·d operations at 989 TFLOP/s bf16
// against each input and the output moved once at 3.35 TB/s): operations
// everywhere.
//   [128, 16, 905, 64] (the template pack's ViT batch): 429 GFLOP, 0.434 ms;
//   [1, 8, 4096, 72] (a Hiera-L global block): 38.7 GFLOP, 0.039 ms;
//   [2, 1, 4096, 256] (memory self-attention): 34.4 GFLOP, 0.035 ms;
//   [1, 1, 4096, 256] x 6,144 keys (K3): 25.8 GFLOP, 0.026 ms;
//   [2, 1, 4096, 256] x 28,736 keys, 36,940 of 57,472 valid (K4 at the smoke's
//   mask): 155 GFLOP, 0.157 ms.
//
// Design:
//   1. Tensor cores through wgmma. A warpgroup (4 warps) owns 64 query rows.
//      S = Q·Kᵀ is wgmma m64nBKk16 with Q and K read from shared memory
//      (both K-major: d contiguous). P goes from the S accumulators straight
//      into A register fragments (the m64nN accumulator layout of two
//      adjacent 8-key blocks is the m64k16 A layout), and O += P·V is wgmma
//      m64nDk16 with A from registers and V as the B operand, MN-major (d
//      contiguous), hence the transpose bit.
//   2. One read of each K/V tile per warpgroup product: wgmma reads its B
//      operand from shared memory once per 64-row product, where each
//      mma.sync warp would re-read the tile for its own 16 rows.
//   3. Asynchronous copies. A producer warpgroup, of which one thread issues
//      every load as TMA (cp.async.bulk.tensor.3d) into swizzled shared
//      memory, signals completion through mbarriers; K and V have a barrier
//      each per stage, so Q·Kᵀ starts before V has landed. A ring of K/V
//      stages lets the next tiles' loads overlap this tile's products; the
//      consumers release a stage through an `empty` mbarrier. No
//      __syncthreads after set-up. The producer gives its registers to the
//      consumers with setmaxnreg (24 left a thread; see Sm90). A lone
//      producer warp does not save them: the register file is split over the
//      SM's four sub-partitions, so 9 warps cap a thread at 170 registers,
//      and at d 256 (168 registers) ptxas spilled and serialised the wgmma.
//   4. d 64: 128-key tiles, 3 stages; blocks of 192 rows (3 consumer
//      warpgroups sharing each K/V tile, 120 KB of shared memory, one per SM)
//      or of 64 rows (one warpgroup, 104 KB, two per SM), whichever waves
//      cost less (ops/attention.py:sm90_config). n = 905 pads to 960 rows
//      (5 x 192, the same 5.7% as 64-row tiles). No spill: 160 registers per
//      consumer thread at 192 rows (O 32, S 64, P 32).
//   5. d 72: a row is one 128-byte swizzle atom of 64 columns and a tail of
//      8. A 128-byte-swizzled box cannot be wider than 64 bf16 columns, so
//      the tail has maps of its own: [rows, 16] boxes at column 64 with the
//      32-byte swizzle, whose columns 72-79 lie past the map's inner
//      dimension of 72 and are zero-filled by TMA. (An unswizzled [rows, 8]
//      box beside a block of zeros would need the zeros written at set-up
//      for Q, K and V alike, and a stride to reach them; TMA's fill gives
//      them with every load.) Q·Kᵀ takes a fifth k-step over columns 64-79
//      on the tails (layout type 3, 32-byte swizzle: 8-row groups 256 bytes
//      apart); its zero columns add nothing. P·V is m64n64k16 on the atom
//      plus m64n8k16 on the tail's columns 64-71, so O is 36 fp32 registers
//      and columns 72-79 are never computed or stored. Key tiles of 128;
//      blocks of 192 rows (3 stages, 150 KB) or 128 (3 stages, 140 KB), one
//      per SM, or of 64 rows (2 stages, 90 KB, two per SM). At the Hiera-L
//      shape [1, 8, 4096, 72] each runs 2 waves, and 128-row blocks, whose
//      second wave is nearly full where that of 192-row blocks is a third
//      full, take the least time (ops/attention.py:WAVE_COST).
//   6. d 256: the O accumulator takes 128 fp32 registers per thread, so Q
//      never goes into registers (Q·Kᵀ reads it from shared memory) and the
//      key tile is 64 (S: 32 registers); 128 rows per block (2 consumer
//      warpgroups), 192 KB of shared memory (Q 64 KB, 2 stages of K and V
//      64 KB each), one block per SM.
//   7. Key splits. When the blocks leave the card short of a wave, the key
//      tiles are split over `splits` blocks: each writes its partial
//      (m, l, acc) in fp32 to scratch from the wrapper, and the combine
//      kernel of split_combine.cuh merges them (ops/attention.py:sm90_config
//      picks the count: [2, 1, 4096, 256] takes 2, K3's shape 4, K4's 4).
//   8. The key mask (K4). sm90_key_tiles_kernel turns the byte mask
//      [batch, nk] into, per batch element, the count of key tiles holding a
//      valid key, their indices in increasing order and a flag on each that
//      is partially masked; an element with no valid key lists every tile,
//      flagged (its rows then average V over its nk keys). The attention
//      kernel walks that list: the producer loads only listed tiles and
//      hands each stage's tile index and flag to the consumers in shared
//      memory, so a tile the mask empties is neither loaded nor waited on;
//      the consumers read the mask bytes of a flagged tile's keys (from
//      global memory, L2-resident) and set masked logits to -1e30 before the
//      row max; full tiles read no mask. Split s of a batch element takes
//      listed tiles [s·L / S, (s + 1)·L / S): an equal contiguous share of
//      its L listed tiles; an empty share still writes its partial (m =
//      -1e30 in log2 units, l = 0, acc = 0), which the combine weighs 0. The
//      list is built on the device in the same C call, so nothing on the
//      host reads the mask. Unmasked calls are a separate instance (the
//      KEY_MASK template flag): every tile, no list, no mask reads.
//   Tensor maps are 3-D [bh, n, d] (built on the host with
//   cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint, so no
//   -lcuda): a ragged tile past n or nk gets TMA's zero fill and never the
//   next head's rows; a d 256 row is four atoms, each its own [rows, 64]
//   box. Zero-filled keys would still give logit 0, so keys at or past nk
//   are set to -inf after Q·Kᵀ. The shared-memory base is aligned to 1,024
//   bytes here (the swizzle atoms need it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_combine.cuh"

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float MASKED = -1e30f;  // running-max start and a masked key's logit
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D, int NWG>
struct Sm90 {
  static_assert(D == 64 || D == 72 || D == 256, "head dim 64, 72 or 256");
  static constexpr int BK = D == 256 ? 64 : 128;            // keys per tile
  static constexpr int ATOMS = D / 64;                      // 128-byte swizzle atoms per row
  static constexpr bool TAIL = D % 64 != 0;                 // d 72: columns 64-79 in 32-byte-swizzled boxes
  static constexpr int ROWS = NWG * 64;                     // query rows per block
  static constexpr int THREADS = (NWG + 1) * 128;           // consumer warpgroups + the producer warpgroup
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;       // blocks per SM the registers must allow
  // K/V ring: 3 stages, 2 where 3 would not fit (d 256; d 72 at two blocks per SM).
  static constexpr int STAGES = D == 256 || (TAIL && MIN_BLOCKS == 2) ? 2 : 3;
  // setmaxnreg: the producer keeps 24 registers a thread, the consumers take
  // what it gives up (at most 240): 160 with 3 warpgroups, 240 with 2, 232
  // with 1 (two blocks per SM).
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS_FIT = (65536 / MIN_BLOCKS - 128 * PRODUCER_REGS) / (128 * NWG) / 8 * 8;
  static constexpr int CONSUMER_REGS = CONSUMER_REGS_FIT < 240 ? CONSUMER_REGS_FIT : 240;
  static constexpr uint32_t Q_ATOM = 64 * 128;              // one [64, 64] bf16 box
  static constexpr uint32_t Q_TAIL = TAIL ? 64 * 32 : 0;    // one [64, 16] box
  static constexpr uint32_t Q_WG = ATOMS * Q_ATOM + Q_TAIL;   // one warpgroup's 64 rows
  static constexpr uint32_t Q_BYTES = NWG * Q_WG;
  static constexpr uint32_t KV_ATOM = BK * 128;             // one [BK, 64] bf16 box
  static constexpr uint32_t KV_TAIL = TAIL ? BK * 32 : 0;   // one [BK, 16] box
  static constexpr uint32_t KV_BYTES = ATOMS * KV_ATOM + KV_TAIL;  // one stage of K (or of V)
  static constexpr uint32_t TILE_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 3 * STAGES;             // q, then k_full, v_full, empty per stage
  // + each stage's key tile and mask flag (int2), for masked calls
  static constexpr size_t SMEM = 1024 + TILE_BYTES + 8 * N_BARS + 8 * STAGES;
  static_assert(Q_WG % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms need 1,024-byte alignment");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
// (A clock64 timeout with a trap in this loop made ptxas spill and
// serialise the wgmma at d 256, so the wait has none.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map at (column c0, row c1, head c2).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving accumulator reads or writes across a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptors; lbo / sbo in bytes.
// 128-byte swizzle (layout type 1). K-major operands: rows 128 B apart,
// 8-row groups at sbo = 1,024 B, lbo unused (16). MN-major (V): 8-key groups
// at sbo = 1,024 B, 64-column atoms at lbo.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
// 32-byte swizzle (layout type 3), the d 72 tails: rows of 16 columns 32 B
// apart, 8-row groups (K-major) or 8-key groups (MN-major) at sbo = 256 B;
// lbo unused (16): a k-step or an n8 product stays inside one 32-byte row.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32) |
         (3ull << 62);
}

// Accumulator operand lists of the wgmma wrappers below.
#define ACC4(b) "+f"(d[(b) + 0]), "+f"(d[(b) + 1]), "+f"(d[(b) + 2]), "+f"(d[(b) + 3])
#define ACC8(b) ACC4(b), ACC4((b) + 4)
#define ACC32(b) ACC8(b), ACC8((b) + 8), ACC8((b) + 16), ACC8((b) + 24)
#define ACC64(b) ACC32(b), ACC32((b) + 32)
#define ACC128(b) ACC64(b), ACC64((b) + 64)

// d[64 x 64] (+)= A[64 x 16] · B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] · B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 8] += A[64 x 16] · B[16 x 8], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : ACC4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] · B[16 x 64], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 256] += A[64 x 16] · B[16 x 256], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ACC128(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The tensor maps of one call: q, k, v in [rows, 64] boxes with the
// 128-byte swizzle, and at d 72 their tails in [rows, 16] boxes with the
// 32-byte swizzle (at other head dims the tail maps are never read).
struct Maps {
  CUtensorMap q, k, v, qt, kt, vt;
};

// Grid (query blocks, key splits, bh). Maps: q [bh, n, D], k and v
// [bh, nk, D], bf16. One split: o [bh, n, D] bf16. Several: part_acc
// [splits, bh, n, D] (unnormalised accumulator), part_m (row max of
// q·kᵀ·scale) and part_l (row sum) [splits, bh, n], fp32. KEY_MASK: mask
// [bh / heads, nk] bytes (0 = masked key), and the key-tile list of
// sm90_key_tiles_kernel (tile_count [bh / heads], tile_list and
// tile_partial [bh / heads, tiles]); otherwise split s takes tiles
// [s·tiles_per_split, (s + 1)·tiles_per_split).
template <int D, int NWG, bool KEY_MASK>
__global__ void __launch_bounds__((NWG + 1) * 128, NWG == 1 ? 2 : 1)  // Sm90::THREADS, MIN_BLOCKS
sm90_attention_kernel(const __grid_constant__ Maps maps, bf16* __restrict__ o, float* __restrict__ part_acc,
                      float* __restrict__ part_m, float* __restrict__ part_l, const uint8_t* __restrict__ mask,
                      const int* __restrict__ tile_count, const int* __restrict__ tile_list,
                      const uint8_t* __restrict__ tile_partial, int heads, int n, int nk, int tiles_per_split,
                      float scale_log2) {
  using C = Sm90<D, NWG>;
  constexpr int BK = C::BK, STAGES = C::STAGES, ATOMS = C::ATOMS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // Q: NWG warpgroups x (ATOMS boxes of [64, 64], tail)
  const uint32_t sk = sq + C::Q_BYTES;         // K: STAGES x (ATOMS boxes of [BK, 64], tail)
  const uint32_t sv = sk + STAGES * C::KV_BYTES;
  const uint32_t bars = sv + STAGES * C::KV_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  // Each stage's (key tile, partially masked) for masked calls: written by
  // the producer before its k_full arrive, read by the consumers after the
  // wait on it (the arrive releases, the wait acquires).
  int2* stage_tile = reinterpret_cast<int2*>(smem_raw + (bars + 8u * C::N_BARS - raw));

  const int q0 = blockIdx.x * C::ROWS;
  const int split = blockIdx.y, bh = blockIdx.z;
  const int n_tiles = (nk + BK - 1) / BK;
  const size_t batch = (size_t)(bh / heads);
  int first, count;  // this split's share: positions [first, first + count) of the tile order
  if constexpr (KEY_MASK) {
    const int listed = tile_count[batch];
    first = (int)((long long)split * listed / gridDim.y);
    count = (int)((long long)(split + 1) * listed / gridDim.y) - first;
  } else {
    first = split * tiles_per_split;
    count = min(n_tiles, first + tiles_per_split) - first;  // >= 1: the host checks the split count
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), NWG * 4);  // every consumer warp releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= NWG * 4) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == NWG * 4 && lane == 0 && count > 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int w = 0; w < NWG; ++w) {
        const uint32_t dst = sq + w * C::Q_WG;
        for (int a = 0; a < ATOMS; ++a) tma_load(dst + a * C::Q_ATOM, &maps.q, q_full, a * 64, q0 + w * 64, bh);
        if constexpr (C::TAIL) tma_load(dst + ATOMS * C::Q_ATOM, &maps.qt, q_full, ATOMS * 64, q0 + w * 64, bh);
      }
      for (int it = 0; it < count; ++it) {
        const int s = it % STAGES;
        int tile = first + it, partial = 0;
        if constexpr (KEY_MASK) {  // read before the wait, so the load's latency hides behind it
          tile = tile_list[batch * n_tiles + first + it];
          partial = tile_partial[batch * n_tiles + first + it];
        }
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        if constexpr (KEY_MASK) stage_tile[s] = make_int2(tile, partial);
        const int key0 = tile * BK;
        const uint32_t k_st = sk + s * C::KV_BYTES, v_st = sv + s * C::KV_BYTES;
        mbar_expect_tx(k_full(s), C::KV_BYTES);
        for (int a = 0; a < ATOMS; ++a) tma_load(k_st + a * C::KV_ATOM, &maps.k, k_full(s), a * 64, key0, bh);
        if constexpr (C::TAIL) tma_load(k_st + ATOMS * C::KV_ATOM, &maps.kt, k_full(s), ATOMS * 64, key0, bh);
        mbar_expect_tx(v_full(s), C::KV_BYTES);
        for (int a = 0; a < ATOMS; ++a) tma_load(v_st + a * C::KV_ATOM, &maps.v, v_full(s), a * 64, key0, bh);
        if constexpr (C::TAIL) tma_load(v_st + ATOMS * C::KV_ATOM, &maps.vt, v_full(s), ATOMS * 64, key0, bh);
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows q0 + wg * 64 + [0, 64). Thread layout
  // of the m64nN accumulators: warp w of the group holds rows 16w + g and
  // 16w + g + 8; in each 8-column block, columns 2t and 2t + 1.
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  const uint32_t q_wg = sq + wg * C::Q_WG;
  float oacc[ATOMS * 32];         // O columns [0, 64·ATOMS)
  float otail[C::TAIL ? 4 : 1];   // d 72: O columns 64-71
#pragma unroll
  for (int i = 0; i < ATOMS * 32; ++i) oacc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (C::TAIL ? 4 : 1); ++i) otail[i] = 0.0f;
  float m_lo = MASKED, m_hi = MASKED, l_lo = 0.0f, l_hi = 0.0f;  // log2 units, rows g and g + 8
  if (count > 0) mbar_wait(q_full, 0);
  const uint8_t* mrow = KEY_MASK ? mask + batch * nk : nullptr;

  for (int it = 0; it < count; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;

    // S = Q·Kᵀ over 4·ATOMS k-steps of 16 columns (32 bytes inside a swizzle
    // atom), and at d 72 a fifth on the tails (columns 64-79, 72-79 zero).
    float sacc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.0f;
    mbar_wait(k_full(s), parity);
    int key0 = (first + it) * BK;
    bool partial = false;
    if constexpr (KEY_MASK) {
      const int2 st = stage_tile[s];
      key0 = st.x * BK;
      partial = st.y != 0;
    }
    const uint32_t k_st = sk + s * C::KV_BYTES;
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ATOMS * 4; ++kk) {
      const uint64_t da = sw128_desc(q_wg + (kk / 4) * C::Q_ATOM + (kk % 4) * 32, 16, 1024);
      const uint64_t db = sw128_desc(k_st + (kk / 4) * C::KV_ATOM + (kk % 4) * 32, 16, 1024);
      wgmma_ss<BK>(sacc, da, db, kk > 0);
    }
    if constexpr (C::TAIL) wgmma_ss<BK>(sacc, sw32_desc(q_wg + ATOMS * C::Q_ATOM), sw32_desc(k_st + ATOMS * C::KV_ATOM), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    // sc: what turns an entry of sacc into log2 units. A partially masked
    // tile is converted here (masked keys -1e30, keys past nk -inf), so its
    // entries are already in those units; elsewhere keys past nk (TMA's zero
    // fill, only in the last tile) take -inf.
    float sc = scale_log2;
    bool ragged = key0 + BK > nk;
    if constexpr (KEY_MASK) {
      if (partial) {
        sc = 1.0f;
        ragged = false;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = key0 + j * 8 + 2 * t + e;
            const bool in = key < nk;
            const bool ok = in && mrow[key] != 0;
            const float fill = in ? MASKED : -INFINITY;
            sacc[4 * j + e] = ok ? sacc[4 * j + e] * scale_log2 : fill;
            sacc[4 * j + 2 + e] = ok ? sacc[4 * j + 2 + e] * scale_log2 : fill;
          }
      }
    }
    if (ragged) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (key0 + j * 8 + 2 * t + e >= nk) sacc[4 * j + e] = sacc[4 * j + 2 + e] = -INFINITY;
    }
    // Online softmax in log2 units: x = s·sc, p = 2^(x - m).
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo) * sc);
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi) * sc);
    const float a_lo = ex2(m_lo - mn_lo), a_hi = ex2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
    uint32_t pf[BK / 16][4];  // P as the A fragments of P·V, 16 keys each
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(fmaf(sacc[4 * j], sc, -mn_lo));
      const float p1 = ex2(fmaf(sacc[4 * j + 1], sc, -mn_lo));
      const float p2 = ex2(fmaf(sacc[4 * j + 2], sc, -mn_hi));
      const float p3 = ex2(fmaf(sacc[4 * j + 3], sc, -mn_hi));
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pf[j / 2][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_lo = a_lo * l_lo + sum_lo;  // per-thread partial sums; the quad adds them at the end
    l_hi = a_hi * l_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < ATOMS * 8; ++j) {
      oacc[4 * j] *= a_lo;
      oacc[4 * j + 1] *= a_lo;
      oacc[4 * j + 2] *= a_hi;
      oacc[4 * j + 3] *= a_hi;
    }
    if constexpr (C::TAIL) {
      otail[0] *= a_lo;
      otail[1] *= a_lo;
      otail[2] *= a_hi;
      otail[3] *= a_hi;
    }

    // O += P·V over BK / 16 k-steps: 16 keys = two 8-row groups, 2,048 bytes
    // of each atom and 512 of the tail.
    mbar_wait(v_full(s), parity);
    const uint32_t v_st = sv + s * C::KV_BYTES;
    fence_regs(oacc);
    fence_regs(otail);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs<ATOMS * 64>(oacc, pf[kk], sw128_desc(v_st + kk * 2048, C::KV_ATOM, 1024));
      if constexpr (C::TAIL) wgmma_rs_n8(otail, pf[kk], sw32_desc(v_st + ATOMS * C::KV_ATOM + kk * 512));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oacc);
    fence_regs(otail);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const int row_lo = q0 + wg * 64 + w * 16 + g, row_hi = row_lo + 8;
  // Columns 2t, 2t + 1 of each 8-column block of O: x0, x1 of row g, x2, x3
  // of row g + 8.
  const size_t prow = ((size_t)split * gridDim.z + bh) * n;  // row 0 of this (split, bh) in the partials
  const float inv_lo = 1.0f / fmaxf(l_lo, 1e-30f), inv_hi = 1.0f / fmaxf(l_hi, 1e-30f);
  auto store = [&](int col, float x0, float x1, float x2, float x3) {
    if (gridDim.y == 1) {
      bf16* og = o + (size_t)bh * n * D + col;
      if (row_lo < n)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row_lo * D) = __floats2bfloat162_rn(x0 * inv_lo, x1 * inv_lo);
      if (row_hi < n)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row_hi * D) = __floats2bfloat162_rn(x2 * inv_hi, x3 * inv_hi);
    } else {
      float* ag = part_acc + prow * D + col;
      if (row_lo < n) *reinterpret_cast<float2*>(ag + (size_t)row_lo * D) = make_float2(x0, x1);
      if (row_hi < n) *reinterpret_cast<float2*>(ag + (size_t)row_hi * D) = make_float2(x2, x3);
    }
  };
#pragma unroll
  for (int j = 0; j < ATOMS * 8; ++j) store(j * 8 + 2 * t, oacc[4 * j], oacc[4 * j + 1], oacc[4 * j + 2], oacc[4 * j + 3]);
  if constexpr (C::TAIL) store(ATOMS * 64 + 2 * t, otail[0], otail[1], otail[2], otail[3]);  // columns 64-71
  if (gridDim.y > 1 && t == 0) {  // m back in natural units: the max of q·kᵀ·scale
    if (row_lo < n) {
      part_m[prow + row_lo] = m_lo * LN2;
      part_l[prow + row_lo] = l_lo;
    }
    if (row_hi < n) {
      part_m[prow + row_hi] = m_hi * LN2;
      part_l[prow + row_hi] = l_hi;
    }
  }
}

// The key-tile list of K4 (plain version: ops/attention.py:key_tile_list).
// One block per batch element; mask [batch, nk] bytes (0 = masked key).
// Writes count[b] = the number of key tiles of `bk` keys that hold a valid
// key, list[b, :count] their indices in increasing order and partial[b, i]
// = 1 where listed tile i also holds a masked key (keys past nk are not
// masked keys); positions past count hold -1 and 0. A batch element with no
// valid key lists every tile, each flagged. Each thread counts the valid
// keys of one tile per pass (16 bytes a load where the row and the tile
// are 16-byte aligned); a ballot and the warps' counts place the listed
// tiles in order.
constexpr int LIST_THREADS = 1024;

__global__ void __launch_bounds__(LIST_THREADS)
sm90_key_tiles_kernel(const uint8_t* __restrict__ mask, int nk, int bk, int* __restrict__ count,
                      int* __restrict__ list, uint8_t* __restrict__ partial) {
  constexpr int WARPS = LIST_THREADS / 32;
  __shared__ int warp_listed[WARPS];
  __shared__ int base;
  const int n_tiles = (nk + bk - 1) / bk;
  const uint8_t* row = mask + (size_t)blockIdx.x * nk;
  const bool vec = ((reinterpret_cast<uintptr_t>(row) | (uintptr_t)bk) & 15) == 0;
  int* lb = list + (size_t)blockIdx.x * n_tiles;
  uint8_t* pb = partial + (size_t)blockIdx.x * n_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n_tiles; t0 += LIST_THREADS) {
    const int tile = t0 + threadIdx.x;
    int valid = 0, keys = 0;
    if (tile < n_tiles) {
      const int k0 = tile * bk, k1 = min(nk, k0 + bk);
      keys = k1 - k0;
      int k = k0;
      if (vec) {
        int bytes = 0;  // 8 per nonzero byte
        for (; k + 16 <= k1; k += 16) {
          const uint4 x = *reinterpret_cast<const uint4*>(row + k);
          bytes += __popc(__vcmpne4(x.x, 0)) + __popc(__vcmpne4(x.y, 0)) + __popc(__vcmpne4(x.z, 0)) +
                   __popc(__vcmpne4(x.w, 0));
        }
        valid = bytes / 8;
      }
      for (; k < k1; ++k) valid += row[k] != 0;
    }
    const unsigned listed = __ballot_sync(0xffffffffu, valid > 0);
    if (lane == 0) warp_listed[warp] = __popc(listed);
    __syncthreads();
    int at = base + __popc(listed & ((1u << lane) - 1u));
    for (int v = 0; v < warp; ++v) at += warp_listed[v];
    if (valid > 0) {
      lb[at] = tile;
      pb[at] = valid < keys;
    }
    __syncthreads();  // every thread has read base and warp_listed
    if (threadIdx.x == 0)
      for (int v = 0; v < WARPS; ++v) base += warp_listed[v];
    __syncthreads();
  }
  const int listed = base;
  for (int i = threadIdx.x; i < n_tiles; i += LIST_THREADS) {
    if (listed == 0) {
      lb[i] = i;
      pb[i] = 1;
    } else if (i >= listed) {
      lb[i] = -1;
      pb[i] = 0;
    }
  }
  if (threadIdx.x == 0) count[blockIdx.x] = listed == 0 ? n_tiles : listed;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 3-D map of a contiguous bf16 [bh, rows, d] tensor, boxes of [box_rows, 64]
// with the 128-byte swizzle, or (tail) of [box_rows, 16] with the 32-byte
// swizzle; out-of-range rows and columns read as zeros.
inline bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int bh, int rows, int d, int box_rows,
                     bool tail) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {tail ? 16u : 64u, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, tail ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raise the kernel's dynamic shared-memory limit once per device.
template <int D, int NWG, bool KEY_MASK>
int allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(sm90_attention_kernel<D, NWG, KEY_MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Sm90<D, NWG>::SMEM);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return (int)err;
}

inline int launch_key_tiles(const uint8_t* mask, int batch, int nk, int bk, int* count, int* list, uint8_t* partial,
                            cudaStream_t stream) {
  if (batch <= 0 || nk <= 0 || bk <= 0) return (int)cudaErrorInvalidValue;
  sm90_key_tiles_kernel<<<batch, LIST_THREADS, 0, stream>>>(mask, nk, bk, count, list, partial);
  return (int)cudaGetLastError();
}

template <int D, int NWG, bool KEY_MASK>
int launch_sm90(const void* q, const void* k, const void* v, void* o, void* part_acc, void* part_m, void* part_l,
                const void* mask, void* tile_count, void* tile_list, void* tile_partial, int bh, int heads, int n,
                int nk, int splits, float scale, cudaStream_t stream) {
  using C = Sm90<D, NWG>;
  const int n_tiles = (nk + C::BK - 1) / C::BK;
  const int per = splits > 0 ? (n_tiles + splits - 1) / splits : 0;
  if (splits < 1 || splits > 65535 || o == nullptr) return (int)cudaErrorInvalidValue;
  // Unmasked splits take whole shares of every tile and none may be empty;
  // masked splits share the listed tiles, and an empty share is allowed.
  if (!KEY_MASK && (splits - 1) * per >= n_tiles) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_acc == nullptr || part_m == nullptr || part_l == nullptr)) return (int)cudaErrorInvalidValue;
  if (KEY_MASK && (tile_count == nullptr || tile_list == nullptr || tile_partial == nullptr || heads < 1 ||
                 bh % heads != 0))
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  Maps maps;
  if (!make_map(enc, &maps.q, q, bh, n, D, 64, false) || !make_map(enc, &maps.k, k, bh, nk, D, C::BK, false) ||
      !make_map(enc, &maps.v, v, bh, nk, D, C::BK, false))
    return (int)cudaErrorInvalidValue;
  if (C::TAIL) {
    if (!make_map(enc, &maps.qt, q, bh, n, D, 64, true) || !make_map(enc, &maps.kt, k, bh, nk, D, C::BK, true) ||
        !make_map(enc, &maps.vt, v, bh, nk, D, C::BK, true))
      return (int)cudaErrorInvalidValue;
  } else {
    maps.qt = maps.q;
    maps.kt = maps.k;
    maps.vt = maps.v;
  }
  const int err = allow_smem<D, NWG, KEY_MASK>();
  if (err != 0) return err;
  if (KEY_MASK) {
    const int list_err = launch_key_tiles((const uint8_t*)mask, bh / heads, nk, C::BK, (int*)tile_count,
                                        (int*)tile_list, (uint8_t*)tile_partial, stream);
    if (list_err != 0) return list_err;
  }
  const dim3 grid((n + C::ROWS - 1) / C::ROWS, splits, bh);
  sm90_attention_kernel<D, NWG, KEY_MASK><<<grid, C::THREADS, C::SMEM, stream>>>(
      maps, (bf16*)o, (float*)part_acc, (float*)part_m, (float*)part_l, (const uint8_t*)mask,
      (const int*)tile_count, (const int*)tile_list, (const uint8_t*)tile_partial, KEY_MASK ? heads : 1, n, nk, per,
      scale * LOG2E);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || splits == 1) return (int)launched;
  return split_combine::launch((const float*)part_acc, (const float*)part_m, (const float*)part_l, (bf16*)o, splits,
                               (long)bh * n, D, stream);
}

template <int D, int NWG>
int launch_either(const void* q, const void* k, const void* v, void* o, void* part_acc, void* part_m, void* part_l,
                  const void* mask, void* tile_count, void* tile_list, void* tile_partial, int bh, int heads, int n,
                  int nk, int splits, float scale, cudaStream_t stream) {
  if (mask != nullptr)
    return launch_sm90<D, NWG, true>(q, k, v, o, part_acc, part_m, part_l, mask, tile_count, tile_list, tile_partial,
                                     bh, heads, n, nk, splits, scale, stream);
  return launch_sm90<D, NWG, false>(q, k, v, o, part_acc, part_m, part_l, nullptr, nullptr, nullptr, nullptr, bh, 1,
                                    n, nk, splits, scale, stream);
}

}  // namespace flash

// q [bh, n, d], k/v [bh, nk, d], o [bh, n, d], bf16, contiguous, 16-byte
// aligned; d 64 with warpgroups 1 or 3, d 72 with 1, 2 or 3, d 256 with 2
// (rows per block = 64 x warpgroups). With splits > 1 the kernel writes part_acc
// [splits, bh, n, d], part_m and part_l [splits, bh, n] (fp32 scratch) and
// the combine kernel then writes o. Unmasked (mask null): each split gets
// ceil(tiles / splits) key tiles and none may be empty. Masked: mask
// [bh / heads, nk] bytes (0 = masked key), shared by the `heads` heads of a
// batch element; the list kernel first writes tile_count [bh / heads] and
// tile_list [bh / heads, tiles] (int32) and tile_partial [bh / heads,
// tiles] (bytes), tiles = ceil(nk / flash_sm90_key_tile(d)), and the splits
// share each element's listed tiles. Returns a cudaError_t.
extern "C" int flash_sm90_launch(const void* q, const void* k, const void* v, void* o, void* part_acc, void* part_m,
                                 void* part_l, const void* mask, void* tile_count, void* tile_list,
                                 void* tile_partial, int bh, int heads, int n, int nk, int d, int warpgroups,
                                 int splits, float scale, void* stream) {
  if (n <= 0 || nk <= 0 || bh <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_SM90_CASE(D, NWG)                                                                                    \
  if (d == D && warpgroups == NWG)                                                                                 \
    return flash::launch_either<D, NWG>(q, k, v, o, part_acc, part_m, part_l, mask, tile_count, tile_list,        \
                                        tile_partial, bh, heads, n, nk, splits, scale, s);
  FLASH_SM90_CASE(64, 3)
  FLASH_SM90_CASE(64, 1)
  FLASH_SM90_CASE(72, 3)
  FLASH_SM90_CASE(72, 2)
  FLASH_SM90_CASE(72, 1)
  FLASH_SM90_CASE(256, 2)
#undef FLASH_SM90_CASE
  return (int)cudaErrorInvalidValue;
}

// Keys per tile (Sm90::BK) at head dim d, 0 for a head dim the kernel does
// not take: the split rule of ops/attention.py:sm90_config counts tiles of it.
extern "C" int flash_sm90_key_tile(int d) {
  if (d == 64) return flash::Sm90<64, 1>::BK;
  if (d == 72) return flash::Sm90<72, 1>::BK;
  if (d == 256) return flash::Sm90<256, 2>::BK;
  return 0;
}

// The list kernel alone: mask [batch, nk] bytes; count [batch], list
// [batch, tiles] int32 and partial [batch, tiles] bytes, tiles =
// ceil(nk / key_tile). Returns a cudaError_t.
extern "C" int flash_sm90_key_tiles_launch(const void* mask, int batch, int nk, int key_tile, void* count, void* list,
                                           void* partial, void* stream) {
  return flash::launch_key_tiles((const uint8_t*)mask, batch, nk, key_tile, (int*)count, (int*)list,
                                 (uint8_t*)partial, (cudaStream_t)stream);
}

// The combine alone: acc [splits, rows, d], m and l [splits, rows] fp32
// contiguous, 16-byte aligned; o [rows, d] bf16; d a multiple of 4, at most
// 1024. Returns a cudaError_t.
extern "C" int flash_sm90_combine_launch(const void* acc, const void* m, const void* l, void* o, int splits, int rows,
                                         int d, void* stream) {
  if (splits < 1 || rows <= 0 || d <= 0 || d % 4 != 0 || d > 1024) return (int)cudaErrorInvalidValue;
  return split_combine::launch((const float*)acc, (const float*)m, (const float*)l, (flash::bf16*)o, splits, rows, d,
                               (cudaStream_t)stream);
}
