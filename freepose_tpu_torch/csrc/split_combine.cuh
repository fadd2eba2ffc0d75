// The merge of an attention kernel's key splits, shared by the sm90 kernel
// (flash_attention_sm90.cu, bf16 output) and K5 (flash_attention.cu, fp32
// output). Each library is built alone and launches the merge from its own
// C call, so each instantiates the kernel from this one source.
//
// acc [splits, rows, d], m and l [splits, rows], fp32 -> o [rows, d] =
// Σ_s e^(m_s - M)·acc_s / max(Σ_s e^(m_s - M)·l_s, 1e-30), M = max_s m_s;
// d / 4 threads per row, each on 4 adjacent columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace split_combine {

__device__ __forceinline__ void store4(float* o, float4 a) { *reinterpret_cast<float4*>(o) = a; }
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 a) {
  __nv_bfloat162* og = reinterpret_cast<__nv_bfloat162*>(o);
  og[0] = __floats2bfloat162_rn(a.x, a.y);
  og[1] = __floats2bfloat162_rn(a.z, a.w);
}

template <typename Out>
__global__ void __launch_bounds__(256)
split_combine_kernel(const float* __restrict__ acc, const float* __restrict__ m, const float* __restrict__ l,
                     Out* __restrict__ o, int splits, long rows, int d) {
  const int tpr = d / 4;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long row = idx / tpr;
  const int c4 = (int)(idx % tpr);
  if (row >= rows) return;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[s * rows + row]);
  float sum = 0.0f;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s = 0; s < splits; ++s) {
    const float wgt = expf(m[s * rows + row] - mx);
    sum += wgt * l[s * rows + row];
    const float4 x = reinterpret_cast<const float4*>(acc + (s * rows + row) * d)[c4];
    a.x += wgt * x.x;
    a.y += wgt * x.y;
    a.z += wgt * x.z;
    a.w += wgt * x.w;
  }
  const float inv = 1.0f / fmaxf(sum, 1e-30f);
  store4(o + row * d + 4 * c4, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
}

// d a multiple of 4; every pointer 16-byte aligned. Returns a cudaError_t.
template <typename Out>
inline int launch(const float* acc, const float* m, const float* l, Out* o, int splits, long rows, int d,
                  cudaStream_t stream) {
  const long blocks = (rows * (d / 4) + 255) / 256;
  if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
  split_combine_kernel<Out><<<(unsigned)blocks, 256, 0, stream>>>(acc, m, l, o, splits, rows, d);
  return (int)cudaGetLastError();
}

}  // namespace split_combine
