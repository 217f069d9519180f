// Fused per-bucket SGD update: p -= lr * g over one gradient bucket's
// flat float32 parameters, in place, in one launch.
//
// Replaces the TPU kernel paddle_tpu/kernels/fused_update.py
// `_sgd_kernel` (pallas_call in `build_fused_bucket_update.update`),
// which tiled the flat bucket to (8, 128) VPU blocks after zero
// padding and wrote a new buffer.  Here the executor keeps each
// bucket's parameters as views of one flat buffer, so the kernel
// updates that buffer where it lies: no padding, no concatenation, no
// output allocation.  `p` is the one read-write pointer; each element
// is read and then written by the same thread.
//
// Bound by bytes: 12 bytes moved per element (p and g read, p written)
// for 2 floating-point operations.  Design, for the card's memory rate
// on buckets of up to hundreds of MB: one 16-byte load of p and of g
// per thread, and a grid that covers the whole bucket, so every SM
// keeps as many loads in flight as it holds threads and the blocks
// drain evenly.  A grid-stride loop keeps any size correct; a scalar
// tail takes the last numel % 4 elements, and every element when a
// pointer is not 16-byte aligned.  Small buckets are bound by the
// launch.
//
// Three compile-time switches rebuild the alternatives this design was
// measured against (tools/torch_tree_probe.py sgd-sweep; PERF.md):
//   SGD_UNROLL         float4 pairs in flight per thread and iteration
//   SGD_BLOCKS_PER_SM  0: a grid covering the bucket; k > 0: k blocks
//                      per SM, the rest by the grid-stride loop
//   SGD_STREAMING      1: streaming cache hints (__ldcs / __stcs)
// The defaults are the design above.
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

#ifndef SGD_UNROLL
#define SGD_UNROLL 1
#endif
#ifndef SGD_BLOCKS_PER_SM
#define SGD_BLOCKS_PER_SM 0
#endif
#ifndef SGD_STREAMING
#define SGD_STREAMING 0
#endif

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sgd1(float p, float g, float lr) {
  return __fsub_rn(p, __fmul_rn(lr, g));
}

__device__ __forceinline__ float4 load4(const float4* a) {
#if SGD_STREAMING
  return __ldcs(a);
#else
  return *a;
#endif
}

__device__ __forceinline__ void store4(float4* a, float4 v) {
#if SGD_STREAMING
  __stcs(a, v);
#else
  *a = v;
#endif
}

__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(float* p, const float* __restrict__ g,
                 const float* __restrict__ lr_ptr, long long n,
                 int vectorized) {
  const float lr = __ldg(lr_ptr);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long body = 0;
  if (vectorized) {
    const long long n4 = n >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long i0 = tid; i0 < n4; i0 += stride * SGD_UNROLL) {
      float4 a[SGD_UNROLL], b[SGD_UNROLL];
#pragma unroll
      for (int u = 0; u < SGD_UNROLL; ++u) {
        const long long i = i0 + u * stride;
        if (i < n4) {
          a[u] = load4(p4 + i);
          b[u] = load4(g4 + i);
        }
      }
#pragma unroll
      for (int u = 0; u < SGD_UNROLL; ++u) {
        const long long i = i0 + u * stride;
        if (i < n4) {
          float4 r;
          r.x = sgd1(a[u].x, b[u].x, lr);
          r.y = sgd1(a[u].y, b[u].y, lr);
          r.z = sgd1(a[u].z, b[u].z, lr);
          r.w = sgd1(a[u].w, b[u].w, lr);
          store4(p4 + i, r);
        }
      }
    }
    body = n4 << 2;
  }
  for (long long i = body + tid; i < n; i += stride) {
    p[i] = sgd1(p[i], g[i], lr);
  }
}

}  // namespace

// p -= lr * g in place.  Returns the CUDA error of the launch.
extern "C" int fused_sgd_update_(void* p, const void* g, const void* lr,
                                 long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int vectorized =
      ((uintptr_t)p % 16 == 0 && (uintptr_t)g % 16 == 0) ? 1 : 0;
  // one float4 (or one float, unaligned) per thread over the bucket
  const long long work = vectorized ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
#if SGD_BLOCKS_PER_SM > 0
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks > (long long)sms * SGD_BLOCKS_PER_SM)
    blocks = (long long)sms * SGD_BLOCKS_PER_SM;
#endif
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  fused_sgd_kernel<<<(unsigned)blocks, kThreads, 0,
                     (cudaStream_t)stream>>>(
      (float*)p, (const float*)g, (const float*)lr, n, vectorized);
  return (int)cudaGetLastError();
}
