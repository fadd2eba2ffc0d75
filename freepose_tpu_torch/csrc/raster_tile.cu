// Raster tile kernel K1: per-tile z-buffered shading of binned faces.
//
// Replaces freepose_tpu/ops/rasterizer_pallas.py:_raster_tile_kernel (driven
// there by rasterize_pallas; here by freepose_tpu_torch/ops/rasterizer_cuda.py).
//
// Inputs: per-face attribute rows face_rows [P, F, 32] f32 (edge
// coefficients, per-vertex 1/z, sign, 1/area, seam epsilon, validity,
// per-vertex RGB; rows 28-31 are padding) and each tile's candidate slots
// [P, T, M] int32 (face indices, -1 = no face: the slot reads as valid = 0).
// Tile t of pose p covers pixels [tx, tx + tile) x [ty, ty + tile), tx =
// (t % grid)·tile, ty = (t / grid)·tile. For every pixel and candidate face
// the kernel evaluates the three edge functions, the -eps seam-tolerant
// coverage test and the perspective-correct depth z = 1/max(sum(l_i / z_i),
// 1e-12), and keeps the running minimum with a strict '<' so a tie keeps the
// lowest slot (jnp.argmin / torch.argmin semantics). The winning face is
// shaded once: vertex colour interpolated perspective-correctly, times
// ambient, clipped to [0, 1]. Output: the image [P, res, res, 4] (depth, r,
// g, b) directly, depth 0 on a miss; pixels of the last tile row or column
// past res are computed and not stored.
//
// What bounds it on H100: fp32 arithmetic, not memory. Each (pixel, face)
// pair costs ~21 fp32 operations for its coverage test as the reference
// writes it (three edge functions, three sign products, three compares)
// against 112 bytes of attributes per face read once per tile: at the main
// path's shapes (M = 256 faces, 784 px per tile) ~4M operations per 28 KB
// of rows, far past the card's fp32-operations-per-byte balance (67
// TFLOP/s over 3.35 TB/s = 20).
//
// Design.
//   * Gather in the kernel. A block gathers rows 0-19 (geometry, valid and
//     c0r) of its tile's M faces from face_rows into shared memory with
//     16-byte cp.async, face-major ([M][20] floats, 20 KB at M = 256); an
//     invalid slot gets a zero row. The colour rows 20-27 of each pixel's
//     winning face are read from face_rows at the end. No [P·T, 32, M] pack
//     ever exists in device memory: the prologue writes only the per-face
//     rows and the slot indices.
//   * One block per tile; a thread per slot puts the face's 5 row chunks
//     in flight together. (Persistent blocks that gather the next tile
//     during this one's shading were slower: their barrier per tile idles
//     the warps that finish early, where independent blocks let the SM run
//     others.)
//   * The face loop stops after the tile's last slot that holds a face
//     (binning packs them first); every slot before it is tested, a slot
//     with valid = 0 skipped by the whole block at once. A face's 20 values
//     come in 5 float4 loads that every thread of the block makes at the
//     same address (a broadcast), issued while the previous face is tested.
//   * Fewer operations per pair, each result bit for bit the reference's:
//     - a face's sign s = ±1 is folded into its edge coefficients and
//       1/area once per tile (exact), so the three sign products go;
//     - a thread shades RY x RX = 2 x 4 adjacent pixels; edge k is
//       dkx·(py - yk) - dky·(px - xk), the same expression in the same order
//       as the reference, and its first product depends on the row only,
//       its second on the column only, so each is computed once per face
//       for the RY rows or RX columns and reused (reusing a rounded product
//       rounds identically; stepping w += d0x would not, and is not done);
//     - the depth comparison runs on the clamped 1/z, not on z: the IEEE
//       division moves out of the loop except in a near-tie band where it
//       decides the strict '<' on rounded depths exactly (NEAR_TIE).
//     A pair then costs 3 subtractions and 3 compares, plus per face
//     (6 ops x (RY + RX)) / (RY·RX) of row and column terms.
//   * 2 x 4 pixels per thread (98 threads per block at tile 28, 76
//     registers) was the fastest of the 1 x 2, 1 x 4, 2 x 2 and 2 x 4
//     builds measured on the main path's chunk (PERF.md).
//
// Numerics: built with --fmad=false so a*b - c*d rounds exactly as the plain
// PyTorch version (and XLA) does; divisions are IEEE (no fast math). Every
// (pixel, face) pair the slots hold is tested: no pixel or face culling.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Attribute rows (must match freepose_tpu_torch/ops/rasterizer_cuda.py:_ROWS).
enum Row {
  D0X = 0, D0Y, BX, BY,
  D1X, D1Y, CX, CY,
  D2X, D2Y, AX, AY,
  IZA, IZB, IZC, SGN,
  INV_AREA, EPS, VALID, C0R,
  C0G, C0B, C1R, C1G,
  C1B, C2R, C2G, C2B,
  N_ATTRS = 32
};
constexpr int ROW4 = N_ATTRS / 4;  // float4s per face row
constexpr int GEOM4 = 5;           // float4s holding rows 0-19 (geometry, valid and c0r)

// Where a new face's clamped 1/z exceeds the best one's by more than this
// factor, its rounded depth is strictly smaller: for izc > RN(b·NEAR_TIE) >
// b·(1 + 2^-21), 1/izc < (1/b)·(1 - 2^-22), and rounding each quotient moves
// it by at most 2^-24 relative. Only in the band (b, b·NEAR_TIE] are both
// quotients computed and compared, so the division leaves the inner loop
// and the strict '<' on rounded depths is kept exactly.
constexpr float NEAR_TIE = 1.00000095367431640625f;  // 1 + 2^-20

// Pixels per thread (adjacent rows and columns of one tile), and the most
// threads a block takes, so that ptxas may give each thread the registers
// its pixels need.
constexpr int RY = 2, RX = 4;
constexpr int MAX_THREADS = 512;

// 16-byte global -> shared copy; `ok` false zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// One block per tile.
__global__ void __launch_bounds__(MAX_THREADS)
raster_tile_kernel(const float4* __restrict__ face_rows,  // [P, F, 8] float4
                   const int* __restrict__ slots,         // [P, T, M]
                   float4* __restrict__ out,              // [P, res, res]
                   int f_total, int m, int res, int tile, int grid, float ambient, int depth_only) {
  extern __shared__ float4 rows[];  // [M][GEOM4]: rows 0-19 of each slot's face
  __shared__ int held;              // 1 + the last slot that holds a face
  const long g = blockIdx.x;
  const int n_grid = grid * grid;
  const long pose = g / n_grid;
  const int t = (int)(g % n_grid);
  if (threadIdx.x == 0) held = 0;
  __syncthreads();
  // One thread per slot: its index, then the face's 5 row chunks in flight together.
  const float4* pose_rows = face_rows + pose * f_total * ROW4;
  for (int s = threadIdx.x; s < m; s += blockDim.x) {
    const int idx = slots[g * m + s];
    const float4* src = pose_rows + (long)(idx >= 0 ? idx : 0) * ROW4;
#pragma unroll
    for (int c = 0; c < GEOM4; ++c) cp_async16(rows + (long)s * GEOM4 + c, src + c, idx >= 0);
    if (idx >= 0) atomicMax(&held, s + 1);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int n_held = held;  // slots past it hold no face (valid = 0)
  // Fold each face's sign s = ±1 into its edge coefficients and 1/area.
  // Multiplying by ±1 is exact and rounding is symmetric, so the edge
  // functions come out as exactly w·s, which the coverage test compares,
  // and (w·s)·(s·(1/area)) rounds exactly as w·(1/area) does.
  for (int f = threadIdx.x; f < n_held; f += blockDim.x) {
    float* a = reinterpret_cast<float*>(rows + (long)f * GEOM4);
    const float s = a[SGN];
    a[D0X] *= s; a[D0Y] *= s; a[D1X] *= s; a[D1Y] *= s; a[D2X] *= s; a[D2Y] *= s; a[INV_AREA] *= s;
  }
  __syncthreads();

  const int tcols = (tile + RX - 1) / RX;  // threads across a tile row
  const int row0 = (threadIdx.x / tcols) * RY, col0 = (threadIdx.x % tcols) * RX;
  const int x0 = (t % grid) * tile, y0 = (t / grid) * tile;
  const float ox = (float)x0, oy = (float)y0;
  float py[RY], px[RX], biz[RY][RX];
  int bi[RY][RX];
#pragma unroll
  for (int y = 0; y < RY; ++y) py[y] = (float)(row0 + y) + 0.5f + oy;
#pragma unroll
  for (int x = 0; x < RX; ++x) px[x] = (float)(col0 + x) + 0.5f + ox;
#pragma unroll
  for (int y = 0; y < RY; ++y)
#pragma unroll
    for (int x = 0; x < RX; ++x) {
      biz[y][x] = 0.0f;  // the winner's max(Σ l_i / z_i, 1e-12); every covered face exceeds 0
      bi[y][x] = -1;
    }

  // The next face's rows are loaded while this one is tested.
  float4 n0, n1, n2, n3, n4;
  if (n_held > 0) { n0 = rows[0]; n1 = rows[1]; n2 = rows[2]; n3 = rows[3]; n4 = rows[4]; }
  for (int f = 0; f < n_held; ++f) {
    const float4 g0 = n0, g1 = n1, g2 = n2, g3 = n3, g4 = n4;  // g4: s/area, eps, valid, c0r
    if (f + 1 < n_held) {
      const float4* fr = rows + (f + 1) * GEOM4;
      n0 = fr[0]; n1 = fr[1]; n2 = fr[2]; n3 = fr[3]; n4 = fr[4];
    }
    if (!(g4.z > 0.5f)) continue;
    // Edge k of pixel (x, y): s·dkx·(py - yk) - s·dky·(px - xk); the first
    // product depends on the row only, the second on the column only.
    float er[RY][3], ec[RX][3];
#pragma unroll
    for (int y = 0; y < RY; ++y) {
      er[y][0] = g0.x * (py[y] - g0.w);
      er[y][1] = g1.x * (py[y] - g1.w);
      er[y][2] = g2.x * (py[y] - g2.w);
    }
#pragma unroll
    for (int x = 0; x < RX; ++x) {
      ec[x][0] = g0.y * (px[x] - g0.z);
      ec[x][1] = g1.y * (px[x] - g1.z);
      ec[x][2] = g2.y * (px[x] - g2.z);
    }
    const float ne = -g4.y;
    const float ia = g4.x;
#pragma unroll
    for (int y = 0; y < RY; ++y)
#pragma unroll
      for (int x = 0; x < RX; ++x) {
        const float w0 = er[y][0] - ec[x][0];
        const float w1 = er[y][1] - ec[x][1];
        const float w2 = er[y][2] - ec[x][2];
        if ((w0 >= ne) & (w1 >= ne) & (w2 >= ne)) {
          const float izp = w0 * ia * g3.x + w1 * ia * g3.y + w2 * ia * g3.z;
          const float izc = fmaxf(izp, 1e-12f);
          const float bz = biz[y][x];
          if (izc > bz && (izc > bz * NEAR_TIE || 1.0f / izc < 1.0f / bz)) {
            biz[y][x] = izc;
            bi[y][x] = f;
          }
        }
      }
  }

#pragma unroll
  for (int y = 0; y < RY; ++y) {
    const int yy = y0 + row0 + y;
    if (row0 + y >= tile || yy >= res) continue;
#pragma unroll
    for (int x = 0; x < RX; ++x) {
      const int xx = x0 + col0 + x;
      if (col0 + x >= tile || xx >= res) continue;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (bi[y][x] >= 0) {
        const float z = 1.0f / biz[y][x];
        o.x = z;
        if (!depth_only) {
          const float* a = reinterpret_cast<const float*>(rows + bi[y][x] * GEOM4);
          const float ia = a[INV_AREA];
          const float l0 = (a[D0X] * (py[y] - a[BY]) - a[D0Y] * (px[x] - a[BX])) * ia;
          const float l1 = (a[D1X] * (py[y] - a[CY]) - a[D1Y] * (px[x] - a[CX])) * ia;
          const float l2 = (a[D2X] * (py[y] - a[AY]) - a[D2Y] * (px[x] - a[AX])) * ia;
          // Colour rows 20-27 of the winner, from device memory (row 19, c0r, is in shared memory).
          const float4* row = pose_rows + (long)slots[g * m + bi[y][x]] * ROW4;
          const float4 c5 = row[5], c6 = row[6];
          const float col[9] = {a[C0R], c5.x, c5.y, c5.z, c5.w, c6.x, c6.y, c6.z, c6.w};  // rows C0R-C2B
          float rgb[3];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float c0 = col[ch] * a[IZA];
            const float c1 = col[3 + ch] * a[IZB];
            const float c2 = col[6 + ch] * a[IZC];
            const float v = (l0 * c0 + l1 * c1 + l2 * c2) * z * ambient;
            rgb[ch] = fminf(fmaxf(v, 0.0f), 1.0f);
          }
          o.y = rgb[0]; o.z = rgb[1]; o.w = rgb[2];
        }
      }
      out[(pose * res + yy) * (long)res + xx] = o;
    }
  }
}

}  // namespace

// face_rows [poses, f_total, 32] f32 and slots [poses, T, m] int32 (T =
// ceil(res / tile)², each index -1 or in [0, f_total)), contiguous; out
// [poses, res, res, 4] f32. Returns a cudaError_t.
extern "C" int raster_tile_launch(const void* face_rows, const void* slots, void* out, int poses, int f_total, int m,
                                  int res, int tile, float ambient, int depth_only, void* stream) {
  if (poses <= 0 || f_total <= 0 || m <= 0 || res <= 0 || tile <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (res + tile - 1) / tile;
  const long n_tiles = (long)poses * grid * grid;
  const int threads = ((tile + RX - 1) / RX) * ((tile + RY - 1) / RY);
  if (threads > MAX_THREADS || n_tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m * GEOM4 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(raster_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  raster_tile_kernel<<<(unsigned)n_tiles, threads, smem, (cudaStream_t)stream>>>(
      (const float4*)face_rows, (const int*)slots, (float4*)out, f_total, m, res, tile, grid, ambient, depth_only);
  return (int)cudaGetLastError();
}
