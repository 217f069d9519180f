// Fused per-bucket SGD update: out = p - lr * g over one gradient
// bucket's concatenated flat float32 parameters, in one launch.
//
// Replaces the TPU kernel paddle_tpu/kernels/fused_update.py
// `_sgd_kernel` (pallas_call in `build_fused_bucket_update.update`),
// which tiled the flat bucket to (8, 128) VPU blocks after zero
// padding.  Here there is no padding: a grid-stride loop over 16-byte
// (float4) loads and stores covers the aligned body and a scalar tail
// takes the last numel % 4 elements (or every element when a pointer
// is not 16-byte aligned).
//
// Bound by bytes: 12 bytes moved per element (p and g read, out
// written) for 2 floating-point operations; the loop keeps several
// 16-byte loads in flight per thread so the card's memory runs at its
// rate on large buckets.  Small buckets are bound by the launch.
//
// Bit identity: the per-parameter `sgd` op computes p - lr * g with two
// roundings (a product, then a difference).  nvcc would contract that
// into one fused multiply-add, which rounds once and can differ in the
// last bit, so the kernel writes the two roundings out with
// __fmul_rn / __fsub_rn, which are never contracted.
//
// `lr` is a pointer to the executor's learning-rate scalar on the
// device: the host never reads it, so a step issues no synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sgd1(float p, float g, float lr) {
  return __fsub_rn(p, __fmul_rn(lr, g));
}

__global__ void fused_sgd_kernel(const float* __restrict__ p,
                                 const float* __restrict__ g,
                                 const float* __restrict__ lr_ptr,
                                 float* __restrict__ out, long long n,
                                 int vectorized) {
  const float lr = __ldg(lr_ptr);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long body = 0;
  if (vectorized) {
    const long long n4 = n >> 2;
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const float4 a = __ldg(p4 + i);
      const float4 b = __ldg(g4 + i);
      float4 r;
      r.x = sgd1(a.x, b.x, lr);
      r.y = sgd1(a.y, b.y, lr);
      r.z = sgd1(a.z, b.z, lr);
      r.w = sgd1(a.w, b.w, lr);
      o4[i] = r;
    }
    body = n4 << 2;
  }
  for (long long i = body + tid; i < n; i += stride) {
    out[i] = sgd1(__ldg(p + i), __ldg(g + i), lr);
  }
}

}  // namespace

extern "C" int fused_sgd_update(const void* p, const void* g,
                                const void* lr, void* out, long long n,
                                void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int vectorized =
      ((uintptr_t)p % 16 == 0 && (uintptr_t)g % 16 == 0 &&
       (uintptr_t)out % 16 == 0) ? 1 : 0;
  const int threads = 256;
  // enough blocks for one float4 per thread, capped: the grid-stride
  // loop covers the rest with several loads in flight per thread
  long long work = vectorized ? (n + 3) / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  fused_sgd_kernel<<<(unsigned)blocks, threads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)p, (const float*)g, (const float*)lr, (float*)out, n,
      vectorized);
  return (int)cudaGetLastError();
}
