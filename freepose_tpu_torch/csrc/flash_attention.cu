// Attention kernels on the CUDA cores in fp32: K2 for fp32 inputs
// (flash_f32_launch) and K5 (flash_attention_bias_launch, with an additive
// logit bias). Every bf16 call of K2, K3 and K4 runs
// csrc/flash_attention_sm90.cu (wgmma + TMA); the dispatch is
// freepose_tpu_torch/ops/attention.py:_launch.
//
// fp32 K2 (`_flash_kernel_single` of freepose_tpu/ops/attention.py for fp32
// inputs at d = 64 with no mask, accepted for tests on the card): a plain
// scalar kernel, one thread per query row, keys streamed through shared
// memory in 64-key tiles with the TPU kernel's online softmax (logits,
// running max and sum in fp32; keys past nk add nothing; output
// acc / max(l, 1e-30)).
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_combine.cuh"

namespace flash {

constexpr float MASKED = -1e30f;  // a masked key's logit

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

constexpr int BQ = 64;  // query rows per block, one thread each
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
