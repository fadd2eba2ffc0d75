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
// Design (simple, on the CUDA cores): TPR = 4 adjacent threads per query
// row, each holding 16 of its 64 dims of q and of the accumulator in
// registers; BQB = 32 rows per block of 128 threads, so the ZoeD_N shape
// runs 16 x 19 = 304 blocks. (One thread per row, the first version, gave
// 160 blocks of 2 warps and ran slower than the plain version.) Keys stream
// through shared memory in BKB = 32-key tiles of K and V; a logit is the
// sum of the row's 4 partial dots over two xor-shuffles, so the 4 threads
// hold identical logits, maxima and sums. The bias is the one large input
// (21.3 MB at the ZoeD_N shape, more than q, k, v and o together): each key
// tile stages its [BQB, BKB] bias tile through shared memory with coalesced
// row loads (a bias row is contiguous over keys; a thread reading its own
// row from global memory would stride 2.3 KB between lanes). Ragged edges
// are masked in the kernel (577 is no multiple of any tile): the bias is
// read in place, never padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

constexpr int TPR = 4;               // K5: threads per query row
constexpr int BQB = 32;              // K5: query rows per block
constexpr int KTHREADS = BQB * TPR;  // K5: threads per block
constexpr int BKB = 32;              // K5: keys per streamed tile
constexpr int HDB = 64;              // K5: head dim
constexpr int C4 = HDB / 4 / TPR;    // K5: float4 chunks of a row per thread

// K5. q [bh, n, HDB], k/v [bh, nk, HDB], o [bh, n, HDB], fp32 contiguous;
// bias [heads, n, nk] fp32, read at bh % heads; mask nullptr or
// [bh / heads, nk] bytes (0 = masked key).
__global__ void __launch_bounds__(KTHREADS)
flash_bias_kernel_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ bias, const uint8_t* __restrict__ mask, float* __restrict__ o,
                      int heads, int n, int nk, float scale) {
  __shared__ __align__(16) float Ks[BKB][HDB];
  __shared__ __align__(16) float Vs[BKB][HDB];
  __shared__ float S[BQB][BKB + 1];  // the bias tile (odd stride: the 8 rows of a warp hit 8 banks)
  const long bh = blockIdx.x;
  const int q0 = blockIdx.y * BQB;
  // The TPR threads of a row are adjacent lanes; thread `part` owns the
  // float4 chunks part, part + TPR, ... of the row (so a quad reads 64
  // contiguous bytes of a K or V row, and the quads of a warp the same ones).
  const int t = threadIdx.x, r = t / TPR, part = t % TPR, row = q0 + r;
  const float* kg = k + bh * nk * HDB;
  const float* vg = v + bh * nk * HDB;
  const float* bg = bias + (bh % heads) * (long)n * nk;
  const uint8_t* mrow = mask ? mask + (bh / heads) * (long)nk : nullptr;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float qr[4 * C4], acc[4 * C4];
#pragma unroll
  for (int i = 0; i < C4; ++i) {
    const float4 x = row < n ? reinterpret_cast<const float4*>(q + (bh * n + row) * HDB)[part + i * TPR] : zero;
    qr[4 * i] = x.x; qr[4 * i + 1] = x.y; qr[4 * i + 2] = x.z; qr[4 * i + 3] = x.w;
    acc[4 * i] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.0f;
  }
  float m = MASKED, l = 0.0f;

  for (int k0 = 0; k0 < nk; k0 += BKB) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = t; i < BKB * HDB / 4; i += KTHREADS) {
      const int kj = i / (HDB / 4), c4 = i % (HDB / 4);
      const bool ok = k0 + kj < nk;
      reinterpret_cast<float4*>(Ks[kj])[c4] = ok ? reinterpret_cast<const float4*>(kg + (long)(k0 + kj) * HDB)[c4] : zero;
      reinterpret_cast<float4*>(Vs[kj])[c4] = ok ? reinterpret_cast<const float4*>(vg + (long)(k0 + kj) * HDB)[c4] : zero;
    }
    for (int i = t; i < BQB * BKB; i += KTHREADS) {  // a warp reads 32 consecutive keys of one bias row
      const int br = i / BKB, c = i % BKB;
      const int qi = q0 + br, key = k0 + c;
      S[br][c] = (qi < n && key < nk) ? bg[(long)qi * nk + key] : 0.0f;
    }
    __syncthreads();

    // Logits of this row for the tile: partial dots over the thread's 16
    // dims, summed over the row's TPR lanes, so all of them hold the same s.
    float s[BKB];
    float mx = MASKED;
#pragma unroll
    for (int j = 0; j < BKB; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks[j]);
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
#pragma unroll
      for (int i = 0; i < C4; ++i) {
        const float4 kk = kr[part + i * TPR];
        d0 += qr[4 * i] * kk.x;
        d1 += qr[4 * i + 1] * kk.y;
        d2 += qr[4 * i + 2] * kk.z;
        d3 += qr[4 * i + 3] * kk.w;
      }
      float d = (d0 + d1) + (d2 + d3);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int key = k0 + j;
      float x;
      if (key >= nk) {
        x = -INFINITY;
      } else if (mrow != nullptr && mrow[key] == 0) {
        x = MASKED;
      } else {
        x = d * scale + S[r][j];
      }
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < 4 * C4; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BKB; ++j) {
      const float p = expf(s[j] - mn);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(Vs[j]);
#pragma unroll
      for (int i = 0; i < C4; ++i) {
        const float4 vv = vr[part + i * TPR];
        acc[4 * i] += p * vv.x;
        acc[4 * i + 1] += p * vv.y;
        acc[4 * i + 2] += p * vv.z;
        acc[4 * i + 3] += p * vv.w;
      }
    }
  }
  if (row >= n) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  float4* og = reinterpret_cast<float4*>(o + (bh * n + row) * HDB);
#pragma unroll
  for (int i = 0; i < C4; ++i)
    og[part + i * TPR] = make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv, acc[4 * i + 2] * inv, acc[4 * i + 3] * inv);
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
// masked key.
extern "C" int flash_attention_bias_launch(const void* q, const void* k, const void* v, const void* bias,
                                           const void* mask, void* o, int bh, int heads, int n, int nk, int d,
                                           float scale, void* stream) {
  if (d != flash::HDB || n <= 0 || nk <= 0 || bh <= 0 || heads <= 0 || bh % heads != 0 ||
      (n + flash::BQB - 1) / flash::BQB > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, (n + flash::BQB - 1) / flash::BQB);
  flash::flash_bias_kernel_f32<<<grid, flash::KTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias, (const uint8_t*)mask, (float*)o,
      heads, n, nk, scale);
  return (int)cudaGetLastError();
}
