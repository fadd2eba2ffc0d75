// Attention kernels K2, K3, K4 (softmax(q·kᵀ·scale)·v on the tensor cores)
// and K5 (fp32, with an additive logit bias; its note is further down).
//
// One tile kernel (mma.sync), instantiated per head dim, stood in for three
// TPU kernels of freepose_tpu/ops/attention.py (through the entry point
// flash_tile_launch): K2 `_flash_kernel_single` and K3 `_flash_kernel` (+
// `_kernel_squeeze`) at d = 64, 72 and 256, and K4 `_stream_kernel` with a
// per-batch key mask shared by the heads of a batch element (block index
// i // h on the TPU; caller: SAM2 memory cross-attention, 4096 queries
// against 7 mask-memory slots x 4096 tokens + 16 object pointers x 4 tokens
// = 28,736 keys at d = 256, with empty slots masked). Every bf16 call of the
// dispatch in freepose_tpu_torch/ops/attention.py:_launch now runs
// csrc/flash_attention_sm90.cu (wgmma + TMA); this kernel stays as the
// previous design, which chip_smoke.py and the card-only tests time and
// check beside it on the same inputs (ops/attention.py:flash_attention_tile).
//
// Semantics kept from the TPU kernels: bf16 operands with fp32
// accumulation; logits, running max and sum in fp32; p rounded to bf16
// before the P·V product; keys masked by the key mask set to -1e30 (a row
// whose keys are all masked therefore averages V uniformly,
// exp(-1e30 - -1e30) = 1); output acc / max(l, 1e-30). Keys past `nk` take
// -inf instead, so they add nothing even to an all-masked row, which then
// averages exactly the nk real keys, as the dense reference does.
//
// What bounds it on H100: the two products are 4·n·nk·d flop against
// 2·(2·n + 2·nk)·d bytes per (batch·head): ~450 FLOP/byte at the DINOv2-L
// shape (n = nk = 905, d = 64), ~2,000 at the Hiera-L global shape
// (n = nk = 4096, d = 72), ~3,600 at the memory cross-attention shape. All
// are above the card's bf16 balance (989 TFLOP/s over 3.35 TB/s = 295):
// tensor-core throughput bounds it.
//
// Design. The TPU kernels keep all of K and V resident per (batch·head) or
// stream them over a sequential grid axis with (max, sum, acc) in VMEM
// scratch; on Hopper K and V do not fit a block's 227 KB of shared memory
// (at n = 912, d = 64 in bf16 they take ~233 KB). Here one block of 4 warps
// runs per (batch·head, 64-query tile); each warp owns 16 query rows.
//   * K/V stream through shared memory in BK-key tiles, double-buffered with
//     cp.async, so the next tile's copy overlaps this tile's products. The
//     key mask is read per key tile from global memory (28.7 KB per batch
//     element at the cross-attention shape, L2-resident).
//   * Q·Kᵀ and P·V run as mma.sync m16n8k16 bf16 with fp32 accumulators,
//     operands from shared memory through ldmatrix (V through .trans).
//   * The head dim is padded in shared memory only, to DP = the next multiple
//     of 16 (the mma k-step): d = 72 runs as 80 with zero columns, which add
//     nothing to Q·Kᵀ and give zero output columns that are not stored. HBM
//     rows keep their native d (a 72-wide bf16 row is 144 bytes, 16-byte
//     aligned, so cp.async moves it in 9 chunks).
//   * Shared rows are DP + 8 elements: an odd number of 16-byte chunks, so
//     the eight rows of an ldmatrix 8x8 matrix hit distinct banks.
//   * P goes from the Q·Kᵀ accumulators straight into the A fragments of
//     P·V (the m16n8 accumulator layout of two adjacent key tiles is the
//     m16k16 A layout), so P never touches shared memory.
//   * Register budget. The O accumulator is 16 rows x DP fp32 per warp, DP/2
//     registers per thread: 32 at d = 64, 40 at d = 72, 128 at d = 256. Up
//     to d = 128 the warp's Q rows also live in registers (DP/4); at d = 256
//     they would take 64 more, so Q is re-read from shared memory with
//     ldmatrix for every key tile, and the key tile shrinks to 32 keys to
//     halve the score and P registers.
//
// fp32 inputs at d = 64 with no mask (accepted for tests on the card) take
// a plain scalar kernel of the same online-softmax structure
// (flash_f32_launch).
//
// K5 flash_attention_bias (replaces _stream_bias_kernel): fp32 attention
// with an additive per-head logit bias [heads, n, nk] shared across the
// batch (block index i % h on the TPU) and an optional per-batch key mask
// in K4's layout. Caller: the 24 blocks of the BEiT-L/16 trunk of ZoeD_N,
// relative-position bias at [1, 16, 577, 64] (384² input, 24² patches +
// cls), bias [16, 577, 577], all fp32 as the production depth model is.
// Semantics of the TPU kernel: logits = q·kᵀ·scale + bias in fp32, then
// masked keys -1e30; keys past nk add nothing (-inf here; the TPU pads them
// with a masked zero row); running max, sum and accumulator in fp32; output
// acc / max(l, 1e-30).
//
// What bounds it on H100: 4·n·nk·d fp32 operations (1.36 GFLOP per launch,
// 20 µs at 67 TFLOP/s on the CUDA cores) against q, k, v, o and the bias
// moved once (30.8 MB, 9.2 µs at 3.35 TB/s): fp32 operations. Tensor cores
// would take TF32, which keeps ~3 decimal digits and changes the fp32
// numerics the JAX model has; a 3xTF32 split is later work.
//
// Design: both products register-tiled on the CUDA cores, as an SGEMM is.
// A block takes K5_BQ = 32 query rows and streams 64-key tiles; its 128
// threads form an 8 x 16 grid.
//   * S = Q·Kᵀ: a thread owns a 4 x 4 micro-tile of S, rows ty + 8·i
//     and keys tx + 16·j. Per step of 4 head dims it loads 4 float4 of Q
//     and 4 of K from shared memory (rows 68 floats apart: the 8 lanes of a
//     quarter-warp hit 8 distinct 16-byte bank groups) for 64 FMAs, so every
//     value read feeds 4 FMAs.
//   * Softmax: the 16 threads of a row group sit in one half-warp; the tile
//     max is reduced over them with 4 xor-shuffles per row. Each logit's exp
//     is computed once, by the thread that owns it; each row's rescale
//     factor once per lane quad, one expf per thread, and shuffled to the
//     16 lanes. The row sum stays a per-thread partial until the end.
//   * P goes to shared memory, into the bias tile's own buffer: each thread
//     overwrites exactly the bias values it read. O += P·V: a thread owns
//     4 rows x 4 adjacent head dims of O in registers; per 4 keys it loads 4
//     float4 of P and 4 of V for 64 FMAs.
//   * K, V and the bias tile are double-buffered with cp.async: the next
//     tile's copy is in flight during this tile's math. K and V go 16 bytes
//     at a time (their rows are 256 bytes); a bias row is 577 floats long,
//     not 16-byte aligned, so the bias goes 4 bytes at a time, coalesced
//     along keys (a warp reads 128 consecutive bytes of one row) into rows
//     80 floats apart (the two row groups of a warp then hit disjoint
//     banks). Ragged edges zero-fill in the copy: nothing is padded on the
//     host.
//   * Grid: 64-row blocks (125 KB of shared memory, one per SM) made 160
//     blocks at ZoeD_N's shape, 1.2 waves on 132 SMs, and were slower in
//     every measured split count; 32-row blocks take 97 KB, two per SM, 304
//     blocks. Key splits (blockIdx.z takes an equal share of the key tiles
//     and writes fp32 partials (m, l, acc), merged by the combine kernel of
//     split_combine.cuh in the same C call) fill the card more evenly; the
//     wrapper's rule (ops/attention.py:k5_config) picks the count from
//     measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_combine.cuh"

namespace flash {

constexpr int BQ = 64;        // queries per block
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr float MASKED = -1e30f;

using bf16 = __nv_bfloat16;

template <int HD>
struct Tile {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8 (16-byte rows)");
  static constexpr int DP = (HD + 15) / 16 * 16;  // padded to the mma k-step
  static constexpr int LD = DP + 8;               // shared row stride (elements)
  static constexpr bool Q_IN_REGS = DP <= 128;
  static constexpr int BK = DP <= 128 ? 64 : 32;  // keys per streamed tile
  static constexpr size_t SMEM = (size_t)(BQ + 4 * BK) * LD * sizeof(bf16);  // Q + 2 stages of K, V
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `ok` false zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] · b[16x8], bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Rows [row0, row0 + rows) of a [limit, HD] bf16 matrix -> shared (stride
// LD), 16 bytes per cp.async; rows >= limit are zero-filled.
template <int HD, int LD>
__device__ __forceinline__ void load_tile_async(bf16* s, const bf16* g, int row0, int rows, int limit) {
  constexpr int CHUNKS = HD / 8;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = row0 + r < limit;
    cp_async16(s + r * LD + c * 8, g + (long)(ok ? row0 + r : 0) * HD + c * 8, ok);
  }
}

// q [bh, n, HD], k/v [bh, nk, HD], o [bh, n, HD], all bf16 and contiguous.
// mask: nullptr, or [bh / heads, nk] bytes (0 = masked key), shared by the
// heads of one batch element.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const uint8_t* __restrict__ mask, bf16* __restrict__ o, int heads, int n, int nk,
                  float scale) {
  using T = Tile<HD>;
  constexpr int DP = T::DP, LD = T::LD, BK = T::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;      // [2][BK * LD]
  bf16* Vs = Ks + 2 * BK * LD;  // [2][BK * LD]

  const long bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const bf16* kg = k + bh * nk * HD;
  const bf16* vg = v + bh * nk * HD;
  const uint8_t* mrow = mask ? mask + (bh / heads) * (long)nk : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column pair
  const int r0 = warp * 16;

  if constexpr (DP != HD) {  // zero the padded columns once; cp.async never writes them
    for (int r = threadIdx.x; r < BQ + 4 * BK; r += THREADS)
      for (int c = HD; c < DP; c += 8) *reinterpret_cast<uint4*>(Qs + r * LD + c) = make_uint4(0, 0, 0, 0);
  }
  load_tile_async<HD, LD>(Qs, q + bh * n * HD, q0, BQ, n);
  load_tile_async<HD, LD>(Ks, kg, 0, BK, nk);
  load_tile_async<HD, LD>(Vs, vg, 0, BK, nk);
  cp_async_commit();

  uint32_t qf[T::Q_IN_REGS ? DP / 16 : 1][4];  // this warp's Q rows as A fragments
  float acc[DP / 8][4];                        // O accumulator, 16 rows x DP dims
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m_lo = MASKED, m_hi = MASKED, l_lo = 0.0f, l_hi = 0.0f;  // rows g and g + 8

  const int n_tiles = (nk + BK - 1) / BK;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async<HD, LD>(Ks + (stage ^ 1) * BK * LD, kg, (it + 1) * BK, BK, nk);
      load_tile_async<HD, LD>(Vs + (stage ^ 1) * BK * LD, vg, (it + 1) * BK, BK, nk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (T::Q_IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          ldmatrix_x4(qf[kk], Qs + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
    }
    const bf16* Kt = Ks + stage * BK * LD;
    const bf16* Vt = Vs + stage * BK * LD;

    // S = Q·Kᵀ for 16 rows x BK keys: BK/8 accumulator tiles of 8 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      if constexpr (T::Q_IN_REGS) {
        a[0] = qf[kk][0]; a[1] = qf[kk][1]; a[2] = qf[kk][2]; a[3] = qf[kk][3];
      } else {
        ldmatrix_x4(a, Qs + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t b[4];  // keys j*8.. (b[0], b[1]) and (j+1)*8.. (b[2], b[3])
        ldmatrix_x4(b, Kt + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
      }
    }

    // Scale and mask, then the online softmax on rows g (s[.][0..1]) and
    // g + 8 (s[.][2..3]); this thread holds keys key0 + j*8 + {0, 1}.
    const int key0 = it * BK + 2 * t;
    float mx_lo = MASKED, mx_hi = MASKED;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + j * 8 + e;
        float fill = 0.0f;
        bool ok = key < nk;
        if (!ok) {
          fill = -INFINITY;
        } else if (mrow != nullptr && mrow[key] == 0) {
          ok = false;
          fill = MASKED;
        }
        s[j][e] = ok ? s[j][e] * scale : fill;
        s[j][e + 2] = ok ? s[j][e + 2] * scale : fill;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float a_lo = __expf(m_lo - mn_lo), a_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
    uint32_t pf[BK / 16][4];  // P as A fragments of P·V
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = __expf(s[j][0] - mn_lo), p1 = __expf(s[j][1] - mn_lo);
      const float p2 = __expf(s[j][2] - mn_hi), p3 = __expf(s[j][3] - mn_hi);
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pf[j / 2][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_lo = a_lo * l_lo + sum_lo;  // per-thread partial sums; the quad adds them at the end
    l_hi = a_hi * l_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= a_lo; acc[j][1] *= a_lo;
      acc[j][2] *= a_hi; acc[j][3] *= a_hi;
    }

    // O += P·V: keys in steps of 16, head dims in pairs of 8-wide tiles.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < DP / 8; j += 2) {
        uint32_t b[4];  // dims j*8.. (b[0], b[1]) and (j+1)*8.. (b[2], b[3])
        ldmatrix_x4_trans(b, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + j * 8 + (lane >> 4) * 8);
        mma_bf16(acc[j], pf[kk], b[0], b[1]);
        mma_bf16(acc[j + 1], pf[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const float inv_lo = 1.0f / fmaxf(quad_sum(l_lo), 1e-30f);
  const float inv_hi = 1.0f / fmaxf(quad_sum(l_hi), 1e-30f);
  const int row_lo = q0 + r0 + g, row_hi = row_lo + 8;
  bf16* og = o + bh * n * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {  // padded columns (j >= HD / 8) are not stored
    const int col = j * 8 + 2 * t;
    if (row_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(og + (long)row_lo * HD + col) =
          __floats2bfloat162_rn(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    if (row_hi < n)
      *reinterpret_cast<__nv_bfloat162*>(og + (long)row_hi * HD + col) =
          __floats2bfloat162_rn(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
  }
}

// Launch the bf16 tile kernel for one head dim; returns a cudaError_t.
template <int HD>
inline int launch_tile(const void* q, const void* k, const void* v, const void* mask, void* o, int bh,
                       int heads, int n, int nk, float scale, cudaStream_t stream) {
  const size_t smem = Tile<HD>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(flash_tile_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (n + BQ - 1) / BQ);
  flash_tile_kernel<HD><<<grid, THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                        (const uint8_t*)mask, (bf16*)o, heads, n, nk, scale);
  return (int)cudaGetLastError();
}

// Dispatch on the head dims the port's models use: 64 (DINOv2), 72 (Hiera-L
// global blocks), 256 (SAM2 memory attention).
inline int launch_tile_any(const void* q, const void* k, const void* v, const void* mask, void* o, int bh,
                           int heads, int n, int nk, int d, float scale, cudaStream_t stream) {
  if (n <= 0 || nk <= 0 || bh <= 0 || heads <= 0 || bh % heads != 0 || (n + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64: return launch_tile<64>(q, k, v, mask, o, bh, heads, n, nk, scale, stream);
    case 72: return launch_tile<72>(q, k, v, mask, o, bh, heads, n, nk, scale, stream);
    case 256: return launch_tile<256>(q, k, v, mask, o, bh, heads, n, nk, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5 (see the note at the top). Shared memory per block: Q [BQ][LDS], two
// stages of K and of V [BK][LDS], two stages of the bias tile, then P,
// [BQ][LDB].
constexpr int K5_D = 64;            // head dim
constexpr int K5_BQ = 32;           // query rows per block
constexpr int K5_BK = 64;           // keys per streamed tile
constexpr int K5_TX = K5_BK / 4;    // threads across a row group: 4 keys of S, 4 dims of O each
constexpr int K5_TY = K5_BQ / 4;    // row groups (a thread owns rows ty + K5_TY·i)
constexpr int K5_THREADS = K5_TX * K5_TY;
constexpr int K5_LDS = K5_D + 4;    // Q, K, V row stride (floats)
constexpr int K5_LDB = K5_BK + 16;  // bias / P row stride (floats)
constexpr size_t K5_SMEM = (size_t)(K5_BQ * K5_LDS + 4 * K5_BK * K5_LDS + 2 * K5_BQ * K5_LDB) * sizeof(float);

// 4-byte global -> shared copy; `ok` false zero-fills the destination.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

// Key tile k0 of K, V (16-byte copies) and the [BQ, BK] bias tile at query
// row q0 (4-byte copies along keys) into one stage; out-of-range rows and
// keys are zero-filled.
__device__ __forceinline__ void k5_load_stage(float* Ks, float* Vs, float* Bs, const float* kg, const float* vg,
                                              const float* bg, int k0, int q0, int n, int nk) {
  constexpr int C4 = K5_D / 4;
  for (int i = threadIdx.x; i < K5_BK * C4; i += K5_THREADS) {
    const int r = i / C4, c = i % C4;
    const bool ok = k0 + r < nk;
    const long src = (long)(ok ? k0 + r : 0) * K5_D + c * 4;
    cp_async16(Ks + r * K5_LDS + c * 4, kg + src, ok);
    cp_async16(Vs + r * K5_LDS + c * 4, vg + src, ok);
  }
  for (int i = threadIdx.x; i < K5_BQ * K5_BK; i += K5_THREADS) {
    const int r = i / K5_BK, c = i % K5_BK;
    const bool ok = q0 + r < n && k0 + c < nk;
    cp_async4(Bs + r * K5_LDB + c, bg + (ok ? (long)(q0 + r) * nk + k0 + c : 0), ok);
  }
}

// Sum or max over the 16 lanes of a row group (a half-warp).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int w = 1; w < K5_TX; w <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int w = 1; w < K5_TX; w <<= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// K5. q [bh, n, 64], k/v [bh, nk, 64], o [bh, n, 64], fp32 contiguous;
// bias [heads, n, nk] fp32, read at bh % heads; mask nullptr or
// [bh / heads, nk] bytes (0 = masked key). Grid (bh, ceil(n / K5_BQ), splits):
// with one split the block writes o; with more, split z takes key tiles
// [z·per, (z + 1)·per) and writes its unnormalised partials acc [splits,
// bh·n, 64], m and l [splits, bh·n].
__global__ void __launch_bounds__(K5_THREADS, 2)  // two blocks per SM: what their shared memory allows
flash_bias_kernel_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ bias, const uint8_t* __restrict__ mask, float* __restrict__ o,
                      float* __restrict__ part_acc, float* __restrict__ part_m, float* __restrict__ part_l,
                      int heads, int n, int nk, float scale) {
  constexpr int TY = K5_TY;
  extern __shared__ __align__(16) float k5_smem[];
  float* Qs = k5_smem;
  float* Ks = Qs + K5_BQ * K5_LDS;
  float* Vs = Ks + 2 * K5_BK * K5_LDS;
  float* Bs = Vs + 2 * K5_BK * K5_LDS;
  const long bh = blockIdx.x;
  const int q0 = blockIdx.y * K5_BQ;
  const int tiles = (nk + K5_BK - 1) / K5_BK;
  const int per = (tiles + gridDim.z - 1) / gridDim.z;
  const int t_begin = blockIdx.z * per, t_end = min(tiles, t_begin + per);
  const int tx = threadIdx.x % K5_TX, ty = threadIdx.x / K5_TX;
  const int lane = threadIdx.x & 31, group = lane & ~(K5_TX - 1);  // first lane of this row group
  const float* qg = q + bh * n * K5_D;
  const float* kg = k + bh * nk * K5_D;
  const float* vg = v + bh * nk * K5_D;
  const float* bg = bias + (bh % heads) * (long)n * nk;
  const uint8_t* mrow = mask ? mask + (bh / heads) * (long)nk : nullptr;

  for (int i = threadIdx.x; i < K5_BQ * K5_D / 4; i += K5_THREADS) {
    const int r = i / (K5_D / 4), c = i % (K5_D / 4);
    const bool ok = q0 + r < n;
    cp_async16(Qs + r * K5_LDS + c * 4, qg + (long)(ok ? q0 + r : 0) * K5_D + c * 4, ok);
  }
  if (t_begin < t_end) k5_load_stage(Ks, Vs, Bs, kg, vg, bg, t_begin * K5_BK, q0, n, nk);
  cp_async_commit();

  float acc[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      const int nx = st ^ 1;
      k5_load_stage(Ks + nx * K5_BK * K5_LDS, Vs + nx * K5_BK * K5_LDS, Bs + nx * K5_BQ * K5_LDB, kg, vg, bg,
                    (t + 1) * K5_BK, q0, n, nk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and Q) has landed for every thread
    const float* Kt = Ks + st * K5_BK * K5_LDS;
    const float* Vt = Vs + st * K5_BK * K5_LDS;
    float* Bt = Bs + st * K5_BQ * K5_LDB;

    // S = Q·Kᵀ on the thread's 4 x 4 micro-tile.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < K5_D; c += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (ty + TY * i) * K5_LDS + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(Kt + (tx + K5_TX * j) * K5_LDS + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += a[i].x * b[j].x;
          s[i][j] += a[i].y * b[j].y;
          s[i][j] += a[i].z * b[j].z;
          s[i][j] += a[i].w * b[j].w;
        }
    }

    // Logits, the tile's row max over the row group, the new running max.
    const int k0 = t * K5_BK;
    float mx[4] = {MASKED, MASKED, MASKED, MASKED};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + K5_TX * j;
      const bool past = key >= nk, masked = !past && mrow != nullptr && mrow[key] == 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = past ? -INFINITY
                             : masked ? MASKED : s[i][j] * scale + Bt[(ty + TY * i) * K5_LDB + tx + K5_TX * j];
        s[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float mn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) mn[i] = fmaxf(m[i], half_warp_max(mx[i]));
    // Rescale factors: lane quad member r computes row r's, once.
    const int r = tx & 3;
    const float mine = expf((r == 0 ? m[0] : r == 1 ? m[1] : r == 2 ? m[2] : m[3]) -
                            (r == 0 ? mn[0] : r == 1 ? mn[1] : r == 2 ? mn[2] : mn[3]));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = __shfl_sync(0xffffffffu, mine, group + i);
      m[i] = mn[i];
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn[i]);
        sum += p;
        Bt[(ty + TY * i) * K5_LDB + tx + K5_TX * j] = p;  // over the bias value this thread read
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

    // O += P·V on the thread's 4 rows x 4 dims.
#pragma unroll 4
    for (int kk = 0; kk < K5_BK; kk += 4) {
      float4 p[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(Bt + (ty + TY * i) * K5_LDB + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const float4*>(Vt + (kk + j) * K5_LDS + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] += p[i].x * w[0].x; acc[i][0] += p[i].y * w[1].x; acc[i][0] += p[i].z * w[2].x; acc[i][0] += p[i].w * w[3].x;
        acc[i][1] += p[i].x * w[0].y; acc[i][1] += p[i].y * w[1].y; acc[i][1] += p[i].z * w[2].y; acc[i][1] += p[i].w * w[3].y;
        acc[i][2] += p[i].x * w[0].z; acc[i][2] += p[i].y * w[1].z; acc[i][2] += p[i].z * w[2].z; acc[i][2] += p[i].w * w[3].z;
        acc[i][3] += p[i].x * w[0].w; acc[i][3] += p[i].y * w[1].w; acc[i][3] += p[i].z * w[2].w; acc[i][3] += p[i].w * w[3].w;
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  const long rows_total = (long)gridDim.x * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = half_warp_sum(l[i]);
    const int row = q0 + ty + TY * i;
    if (row >= n) continue;
    const long at = bh * n + row;
    if (gridDim.z == 1) {
      const float inv = 1.0f / fmaxf(lt, 1e-30f);
      reinterpret_cast<float4*>(o + at * K5_D)[tx] =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    } else {
      const long pa = blockIdx.z * rows_total + at;
      reinterpret_cast<float4*>(part_acc + pa * K5_D)[tx] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (tx == 0) {
        part_m[pa] = m[i];
        part_l[pa] = lt;
      }
    }
  }
}

inline int launch_bias(const void* q, const void* k, const void* v, const void* bias, const void* mask, void* o,
                       void* part_acc, void* part_m, void* part_l, int bh, int heads, int n, int nk, int splits,
                       float scale, cudaStream_t stream) {
  // K5_SMEM is above the 48 KB default, and the limit is an attribute of
  // each device: raise it once on every device the kernel launches on.
  static bool smem_allowed[64] = {};
  int dev = 0;
  cudaError_t attr = cudaGetDevice(&dev);
  if (attr != cudaSuccess) return (int)attr;
  if (dev >= 64 || !smem_allowed[dev]) {
    attr = cudaFuncSetAttribute(flash_bias_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K5_SMEM);
    if (attr != cudaSuccess) return (int)attr;
    if (dev < 64) smem_allowed[dev] = true;
  }
  const dim3 grid(bh, (n + K5_BQ - 1) / K5_BQ, splits);
  flash_bias_kernel_f32<<<grid, K5_THREADS, K5_SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias, (const uint8_t*)mask, (float*)o,
      (float*)part_acc, (float*)part_m, (float*)part_l, heads, n, nk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return split_combine::launch((const float*)part_acc, (const float*)part_m, (const float*)part_l, (float*)o, splits,
                               (long)bh * n, K5_D, stream);
}

}  // namespace flash

namespace {

constexpr int BQ = flash::BQ;
constexpr int BK = 64;
constexpr int HD = 64;  // the fp32 kernel's head dim
constexpr float NEG_INF = flash::MASKED;

// fp32: one thread per query row, keys streamed through shared memory in
// 64-key tiles with the same online softmax.
__global__ void __launch_bounds__(BQ)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, int n, int nk, float scale) {
  __shared__ float Ks[BK][HD + 1];
  __shared__ float Vs[BK][HD + 1];
  const long bh = blockIdx.x;
  const int row = blockIdx.y * BQ + threadIdx.x;
  float qr[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qr[c] = row < n ? q[(bh * n + row) * HD + c] : 0.0f;
    acc[c] = 0.0f;
  }
  float m = NEG_INF, l = 0.0f;
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * HD; i += BQ) {
      const int r = i / HD, c = i % HD;
      const bool ok = k0 + r < nk;
      Ks[r][c] = ok ? k[(bh * nk + k0 + r) * HD + c] : 0.0f;
      Vs[r][c] = ok ? v[(bh * nk + k0 + r) * HD + c] : 0.0f;
    }
    __syncthreads();
    float s[BK];
    float mx = NEG_INF;
    for (int j = 0; j < BK; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < HD; ++c) dot += qr[c] * Ks[j][c];
      s[j] = k0 + j < nk ? dot * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < HD; ++c) acc[c] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - mn);
      l += p;
#pragma unroll
      for (int c = 0; c < HD; ++c) acc[c] += p * Vs[j][c];
    }
  }
  if (row >= n) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < HD; ++c) o[(bh * n + row) * HD + c] = acc[c] * inv;
}

}  // namespace

// The tile kernel: q [bh, n, d], k/v [bh, nk, d], o [bh, n, d], bf16,
// contiguous and 16-byte aligned, d in {64, 72, 256}; mask nullptr (K2, K3)
// or [bh / heads, nk] bytes, 0 = masked key (K4). Returns a cudaError_t.
extern "C" int flash_tile_launch(const void* q, const void* k, const void* v, const void* mask, void* o, int bh,
                                 int heads, int n, int nk, int d, float scale, void* stream) {
  return flash::launch_tile_any(q, k, v, mask, o, bh, heads, n, nk, d, scale, (cudaStream_t)stream);
}

// fp32 K2: q [bh, n, 64], k/v [bh, nk, 64], o [bh, n, 64], contiguous, no
// mask. Returns a cudaError_t.
extern "C" int flash_f32_launch(const void* q, const void* k, const void* v, void* o, int bh, int n, int nk, int d,
                                float scale, void* stream) {
  if (d != HD || n <= 0 || nk <= 0 || bh <= 0 || (n + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, (n + BQ - 1) / BQ);
  flash_kernel_f32<<<grid, BQ, 0, (cudaStream_t)stream>>>((const float*)q, (const float*)k, (const float*)v,
                                                          (float*)o, n, nk, scale);
  return (int)cudaGetLastError();
}

// K5: q [bh, n, d], k/v [bh, nk, d], o [bh, n, d], fp32 with d = 64,
// contiguous and 16-byte aligned; bias [heads, n, nk] fp32 contiguous,
// shared across the batch; mask nullptr or [bh / heads, nk] bytes, 0 =
// masked key. `splits` key splits, each a non-empty share of the 64-key
// tiles; with more than one the fp32 partials go to part_acc [splits, bh·n,
// 64], part_m and part_l [splits, bh·n] and the combine kernel merges them
// into o. Returns a cudaError_t.
extern "C" int flash_attention_bias_launch(const void* q, const void* k, const void* v, const void* bias,
                                           const void* mask, void* o, void* part_acc, void* part_m, void* part_l,
                                           int bh, int heads, int n, int nk, int d, int splits, float scale,
                                           void* stream) {
  const int tiles = (nk + flash::K5_BK - 1) / flash::K5_BK;
  if (d != flash::K5_D || n <= 0 || nk <= 0 || bh <= 0 || heads <= 0 || bh % heads != 0 || splits < 1 ||
      splits > tiles || (tiles + (tiles + splits - 1) / splits - 1) / ((tiles + splits - 1) / splits) != splits ||
      (splits > 1 && (part_acc == nullptr || part_m == nullptr || part_l == nullptr)) ||
      (n + flash::K5_BQ - 1) / flash::K5_BQ > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  return flash::launch_bias(q, k, v, bias, mask, o, part_acc, part_m, part_l, bh, heads, n, nk, splits, scale,
                            (cudaStream_t)stream);
}

// The merge of K5's key splits alone (what a K5 call with splits launches
// after the kernel): acc [splits, rows, 64], m and l [splits, rows] fp32,
// contiguous and 16-byte aligned -> o [rows, 64] fp32. Returns a
// cudaError_t.
extern "C" int flash_bias_combine_launch(const void* acc, const void* m, const void* l, void* o, int splits,
                                         long rows, void* stream) {
  if (splits < 1 || rows <= 0) return (int)cudaErrorInvalidValue;
  return split_combine::launch((const float*)acc, (const float*)m, (const float*)l, (float*)o, splits, rows,
                               flash::K5_D, (cudaStream_t)stream);
}
