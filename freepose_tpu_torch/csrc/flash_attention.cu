// Attention kernel K2: softmax(q·kᵀ·scale)·v for the ViTs' self-attention.
//
// Replaces freepose_tpu/ops/attention.py:_flash_kernel_single, the whole-K/V
// regime of flash_attention on the TPU (driven here by
// freepose_tpu_torch/ops/attention.py:flash_attention).
//
// Semantics kept from the TPU kernel: logits, running max and sum in fp32;
// bf16 operands with fp32 accumulation; p rounded to v's dtype before the
// P·V product; keys >= seq_len set to -1e30; output acc / max(l, 1e-30).
//
// What bounds it on H100: at the DINOv2-L shape (n = 905, d = 64) the two
// products are 4·n²·d = 210 MFLOP per (batch·head) against 4·n·d·2 = 463 KB
// moved, ~450 FLOP/byte, above the card's bf16 balance (989 TFLOP/s over
// 3.35 TB/s = 295): tensor-core throughput bounds it, and at d = 64 the
// softmax's exponentials compete with the products for issue slots.
//
// Design. The TPU kernel keeps all of K and V resident per (batch·head); on
// Hopper that does not fit (K and V at n = 912, d = 64 in bf16 take ~233 KB,
// more than a block's 227 KB of shared memory). Instead, one block of 4 warps
// per (batch·head, 64-query tile), each warp owning 16 query rows:
//   * K/V stream through shared memory in 64-key tiles, double-buffered with
//     cp.async so the next tile's copy overlaps this tile's products;
//   * Q·Kᵀ and P·V run on the tensor cores as mma.sync m16n8k16 bf16 with
//     fp32 accumulators; operands come from shared memory through ldmatrix
//     (rows padded to 144 bytes, so the eight rows of an 8x8 matrix hit
//     distinct banks), V through ldmatrix.trans;
//   * the online softmax (running max and sum, rescaled fp32 accumulator)
//     stays in registers, and P goes from the Q·Kᵀ accumulators straight into
//     the A fragments of P·V: the m16n8 accumulator layout of two adjacent
//     key tiles is the m16k16 A layout, so P never touches shared memory.
// wgmma and TMA (Hopper's asynchronous warpgroup products and bulk copies)
// are the next step.
//
// fp32 inputs (accepted for tests on the card) take a plain scalar kernel of
// the same online-softmax structure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per streamed tile
constexpr int HD = 64;       // head dim
constexpr int LD = 72;       // padded shared-memory row stride (elements)
constexpr int THREADS = 128; // 4 warps x 16 query rows
constexpr float NEG_INF = -1e30f;

using bf16 = __nv_bfloat16;

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

// Rows [row0, row0 + 64) of a [rows, HD] bf16 matrix -> shared (stride LD),
// 16 bytes per cp.async; rows >= limit are zero-filled.
__device__ __forceinline__ void load_tile_async(bf16* s, const bf16* g, int row0, int limit) {
  for (int i = threadIdx.x; i < 64 * (HD / 8); i += THREADS) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    const bool ok = row0 + r < limit;
    cp_async16(s + r * LD + c * 8, g + (long)(ok ? row0 + r : 0) * HD + c * 8, ok);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr size_t BF16_SMEM = (size_t)(BQ + 4 * BK) * LD * sizeof(bf16);  // Q + 2 stages of K, V

__global__ void __launch_bounds__(THREADS)
flash_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  bf16* __restrict__ o, int n, int nk, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;       // [2][BK * LD]
  bf16* Vs = Ks + 2 * BK * LD;   // [2][BK * LD]

  const long bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const bf16* kg = k + bh * nk * HD;
  const bf16* vg = v + bh * nk * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column pair
  const int r0 = warp * 16;

  load_tile_async(Qs, q + bh * n * HD, q0, n);
  load_tile_async(Ks, kg, 0, nk);
  load_tile_async(Vs, vg, 0, nk);
  cp_async_commit();

  uint32_t qf[HD / 16][4];  // this warp's Q rows as A fragments
  float acc[HD / 8][4];     // O accumulator, 16 rows x 64 dims
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.0f, l_hi = 0.0f;  // rows g and g + 8

  const int n_tiles = (nk + BK - 1) / BK;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async(Ks + (stage ^ 1) * BK * LD, kg, (it + 1) * BK, nk);
      load_tile_async(Vs + (stage ^ 1) * BK * LD, vg, (it + 1) * BK, nk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* Kt = Ks + stage * BK * LD;
    const bf16* Vt = Vs + stage * BK * LD;

    // S = Q·Kᵀ for 16 rows x 64 keys: eight 8-key accumulator tiles.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t b[4];  // keys j*8.. (b[0], b[1]) and (j+1)*8.. (b[2], b[3])
        ldmatrix_x4(b, Kt + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], qf[kk], b[0], b[1]);
        mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
      }
    }

    // Online softmax on rows g (s[.][0..1]) and g + 8 (s[.][2..3]).
    const int key0 = it * BK + 2 * t;
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + j * 8 + (e & 1) < nk;
        s[j][e] = ok ? s[j][e] * scale : NEG_INF;
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
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= a_lo; acc[j][1] *= a_lo;
      acc[j][2] *= a_hi; acc[j][3] *= a_hi;
    }

    // O += P·V: keys in steps of 16, head dims in pairs of 8-wide tiles.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < HD / 8; j += 2) {
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
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (row_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(og + (long)row_lo * HD + col) =
          __floats2bfloat162_rn(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    if (row_hi < n)
      *reinterpret_cast<__nv_bfloat162*>(og + (long)row_hi * HD + col) =
          __floats2bfloat162_rn(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
  }
}

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

// dtype: 0 = bf16, 1 = fp32. q [bh, n, d], k/v [bh, nk, d], o [bh, n, d],
// all contiguous and 16-byte aligned; d must be 64.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int bh, int n, int nk, int d, float scale, int dtype,
                                      void* stream) {
  if (d != HD || n <= 0 || nk <= 0 || bh <= 0 || (n + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, (n + BQ - 1) / BQ);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    cudaError_t err = cudaFuncSetAttribute(flash_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)BF16_SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_kernel_bf16<<<grid, THREADS, BF16_SMEM, s>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                       (bf16*)o, n, nk, scale);
  } else if (dtype == 1) {
    flash_kernel_f32<<<grid, BQ, 0, s>>>((const float*)q, (const float*)k, (const float*)v, (float*)o, n,
                                         nk, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
