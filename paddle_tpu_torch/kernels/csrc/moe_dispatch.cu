// Fused MoE gate + capacity dispatch: routing plus a gather.
//
// Replaces the TPU kernel paddle_tpu/kernels/moe_dispatch.py
// `_gate_dispatch_kernel` (pallas_call in `build_moe_gate_dispatch`).
// Given tokens x [T, D] and the router gate_w [D, E], float32, it
// computes exactly what that kernel (and parallel/moe.moe_gate plus
// moe_dense's dispatch einsum) computes:
//
//   logits = x . gate_w, probs = softmax(logits)            (per token)
//   idx1 = argmax(probs) (first index on ties); top-2: idx2 = argmax of
//   probs * (1 - onehot(idx1)); g1, g2 = the probs at those indices
//   pos1 = number of earlier tokens whose first choice is the same
//   expert; pos2 = first_count[e] + number of earlier tokens whose
//   second choice is e (second choices after ALL first choices);
//   an assignment is kept when pos < C
//   expert_in [E, C, D] = x[token of slot (e, c)], zeros in empty slots
//   combine [T, E, C] = g1/(g1+g2) and g2/(g1+g2) at the kept slots
//   (top-1: g1), zeros elsewhere; the denominator clamped at 1e-9
//   aux = E * sum_e mean_t(onehot(idx1))[e] * mean_t(probs)[e]
//
// The TPU kernel formed the one-hot dispatch tensor [T, E, C] in VMEM
// and contracted it with x; with exactly one nonzero term per output
// element that contraction IS a gather (x * 1 plus exact zeros), so the
// gather here is bit-equal to it and no [T, E, C] one-hot exists.
//
// Three launches, no atomics, so every result is independent of the
// order blocks run in:
//   1. route_kernel   one warp per token: the logits' dot products
//      (lanes split D, a fixed shuffle tree sums), softmax, top-1/top-2.
//   2. position_kernel   one CTA: per-expert exclusive scans over tokens
//      in token order (warp ballots + a fixed prefix over warps), the
//      slot -> token map and slot weights, and aux with fixed-order
//      reductions.
//   3. write_kernel   one block per slot row (expert_in) and one per
//      token row (combine): every output element written once.
//
// Bound by bytes: at T 4096, D 1024, E 8, C 1280 it reads x (16.8 MB)
// and writes expert_in (42 MB) and the dense combine (168 MB); the
// logits' 67 MFLOP do not matter.  The combine is dense because the
// consumer (moe_dense's combine einsum) takes it so; a sparse combine is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxExperts = 64;
constexpr int kRouteWarps = 8;     // tokens per route block
constexpr int kScanThreads = 1024; // the position kernel's one CTA
constexpr int kScanWarps = kScanThreads / kWarp;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 1. one warp per token
__global__ void route_kernel(const float* __restrict__ x,
                             const float* __restrict__ gw,
                             float* __restrict__ probs,   // [T, E]
                             int* __restrict__ idx,       // [2, T]
                             float* __restrict__ gate,    // [2, T]
                             int T, int D, int E, int top_k) {
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kRouteWarps + threadIdx.x / kWarp;
  if (t >= T) return;
  const float* xr = x + (long long)t * D;
  float logit[kMaxExperts];
  // 8 experts at a time: each lane accumulates its d = lane + 32k terms
  for (int e0 = 0; e0 < E; e0 += 8) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int d = lane; d < D; d += kWarp) {
      const float xv = __ldg(xr + d);
      const float* wrow = gw + (long long)d * E + e0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (e0 + j < E) acc[j] = fmaf(xv, __ldg(wrow + j), acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float s = warp_sum(acc[j]);
      if (e0 + j < E) logit[e0 + j] = s;
    }
  }
  // softmax: exp(l - max) / sum(exp(l - max)), as jax.nn.softmax
  float mx = logit[0];
  for (int e = 1; e < E; ++e) mx = fmaxf(mx, logit[e]);
  float sum = 0.f;
  for (int e = 0; e < E; ++e) {
    logit[e] = expf(logit[e] - mx);
    sum += logit[e];
  }
  int i1 = 0;
  float best = -1.f;
  for (int e = 0; e < E; ++e) {
    const float p = logit[e] / sum;
    logit[e] = p;
    if (p > best) { best = p; i1 = e; }
  }
  int i2 = 0;
  if (top_k == 2) {
    float best2 = -1.f;
    for (int e = 0; e < E; ++e) {
      const float p2 = logit[e] * (e == i1 ? 0.f : 1.f);
      if (p2 > best2) { best2 = p2; i2 = e; }
    }
  }
  for (int e = lane; e < E; e += kWarp) probs[(long long)t * E + e] = logit[e];
  if (lane == 0) {
    idx[t] = i1;
    gate[t] = logit[i1];
    idx[T + t] = i2;
    gate[T + t] = logit[i2];
  }
}

// 2. one CTA: positions, the slot map and aux
__global__ void __launch_bounds__(kScanThreads)
position_kernel(const float* __restrict__ probs, const int* __restrict__ idx,
                const float* __restrict__ gate,
                int* __restrict__ slot_token,    // [E * C]
                float* __restrict__ slot_weight, // [E * C]
                float* __restrict__ aux, int T, int E, int C, int top_k) {
  __shared__ int warp_count[kMaxExperts][kScanWarps];
  __shared__ int base[kMaxExperts];
  __shared__ int first_count[kMaxExperts];
  __shared__ double red[kScanThreads];
  const int tid = threadIdx.x;
  const int lane = tid % kWarp, warp = tid / kWarp;
  const unsigned lt = (1u << lane) - 1u;

  for (long long s = tid; s < (long long)E * C; s += kScanThreads) {
    slot_token[s] = -1;
    slot_weight[s] = 0.f;
  }
  if (tid < E) base[tid] = 0;
  __syncthreads();

  for (int choice = 0; choice < top_k; ++choice) {
    const int* ci = idx + (long long)choice * T;
    for (int t0 = 0; t0 < T; t0 += kScanThreads) {
      const int t = t0 + tid;
      const int e_me = t < T ? ci[t] : -1;
      int rank = 0;
      for (int e = 0; e < E; ++e) {
        const unsigned b = __ballot_sync(0xffffffffu, e_me == e);
        if (e_me == e) rank = __popc(b & lt);
        if (lane == 0) warp_count[e][warp] = __popc(b);
      }
      __syncthreads();
      // exclusive prefix over warps, expert by expert, in warp order
      if (tid < E) {
        int run = base[tid];
        for (int w = 0; w < kScanWarps; ++w) {
          const int c = warp_count[tid][w];
          warp_count[tid][w] = run;
          run += c;
        }
        base[tid] = run;
      }
      __syncthreads();
      if (t < T) {
        const int pos = warp_count[e_me][warp] + rank;
        if (pos < C) {
          const long long s = (long long)e_me * C + pos;
          slot_token[s] = t;
          float w;
          if (top_k == 1) {
            w = gate[t];
          } else {
            const float g1 = gate[t], g2 = gate[T + t];
            const float denom = fmaxf(g1 + g2, 1e-9f);
            w = (choice == 0 ? g1 : g2) / denom;
          }
          slot_weight[s] = w;
        }
      }
      __syncthreads();
    }
    if (choice == 0) {
      // first_count[e]: every first choice of e; second choices start
      // after them
      if (tid < E) first_count[tid] = base[tid];
      __syncthreads();
    }
  }

  // aux = E * sum_e (first_count[e] / T) * (sum_t probs[t, e] / T),
  // each sum in a fixed order (double partials, a fixed tree)
  float acc = 0.f;
  for (int e = 0; e < E; ++e) {
    double part = 0.0;
    for (int t = tid; t < T; t += kScanThreads)
      part += (double)probs[(long long)t * E + e];
    red[tid] = part;
    __syncthreads();
    for (int s = kScanThreads / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) {
      const float frac_probs = (float)(red[0] / (double)T);
      const float frac_tokens = (float)first_count[e] / (float)T;
      acc += frac_tokens * frac_probs;
    }
    __syncthreads();
  }
  if (tid == 0) aux[0] = (float)E * acc;
}

// 3. blocks [0, E*C): expert_in rows; blocks [E*C, E*C + T): combine rows
__global__ void write_kernel(const float* __restrict__ x,
                             const int* __restrict__ slot_token,
                             const float* __restrict__ slot_weight,
                             float* __restrict__ expert_in,
                             float* __restrict__ combine, int T, int D,
                             int E, int C, int vec_x, int vec_cb) {
  const long long EC = (long long)E * C;
  const long long b = blockIdx.x;
  if (b < EC) {
    const int t = slot_token[b];
    float* dst = expert_in + b * D;
    if (vec_x) {
      float4* d4 = reinterpret_cast<float4*>(dst);
      const float4* s4 =
          reinterpret_cast<const float4*>(x + (long long)(t < 0 ? 0 : t) * D);
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = threadIdx.x; i < D / 4; i += blockDim.x)
        d4[i] = t >= 0 ? __ldg(s4 + i) : z;
    } else {
      for (int i = threadIdx.x; i < D; i += blockDim.x)
        dst[i] = t >= 0 ? __ldg(x + (long long)t * D + i) : 0.f;
    }
    return;
  }
  const int t = (int)(b - EC);
  float* row = combine + (long long)t * EC;
  if (vec_cb) {
    float4* r4 = reinterpret_cast<float4*>(row);
    const int4* st4 = reinterpret_cast<const int4*>(slot_token);
    const float4* sw4 = reinterpret_cast<const float4*>(slot_weight);
    for (long long i = threadIdx.x; i < EC / 4; i += blockDim.x) {
      const int4 s = st4[i];
      const float4 w = sw4[i];
      float4 v;
      v.x = s.x == t ? w.x : 0.f;
      v.y = s.y == t ? w.y : 0.f;
      v.z = s.z == t ? w.z : 0.f;
      v.w = s.w == t ? w.w : 0.f;
      r4[i] = v;
    }
  } else {
    for (long long i = threadIdx.x; i < EC; i += blockDim.x)
      row[i] = slot_token[i] == t ? slot_weight[i] : 0.f;
  }
}

}  // namespace

// Scratch (all on the device, from the caller): probs [T, E] f32,
// idx [2, T] i32, gate [2, T] f32, slot_token [E * C] i32, slot_weight
// [E * C] f32.  Outputs: expert_in [E, C, D], combine [T, E, C],
// aux [1] f32.  Returns the first CUDA error of the three launches.
// What the kernel takes is decided in one place, the wrapper's
// moe_dispatch_supports; the guard below only keeps a direct call of
// this C interface inside the fixed-size arrays.
extern "C" int moe_gate_dispatch(const void* x, const void* gate_w,
                                 void* probs, void* idx, void* gate,
                                 void* slot_token, void* slot_weight,
                                 void* expert_in, void* combine, void* aux,
                                 int T, int D, int E, int C, int top_k,
                                 void* stream) {
  if (T < 1 || D < 1 || E < 1 || E > kMaxExperts || C < 1 ||
      (top_k != 1 && top_k != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  route_kernel<<<(T + kRouteWarps - 1) / kRouteWarps, kRouteWarps * kWarp,
                 0, st>>>((const float*)x, (const float*)gate_w,
                          (float*)probs, (int*)idx, (float*)gate, T, D, E,
                          top_k);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  position_kernel<<<1, kScanThreads, 0, st>>>(
      (const float*)probs, (const int*)idx, (const float*)gate,
      (int*)slot_token, (float*)slot_weight, (float*)aux, T, E, C, top_k);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long ec = (long long)E * C;
  const int vec_x = (D % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)expert_in % 16 == 0) ? 1 : 0;
  const int vec_cb = (ec % 4 == 0 && (uintptr_t)combine % 16 == 0 &&
                      (uintptr_t)slot_token % 16 == 0 &&
                      (uintptr_t)slot_weight % 16 == 0) ? 1 : 0;
  write_kernel<<<(unsigned)(ec + T), 256, 0, st>>>(
      (const float*)x, (const int*)slot_token, (const float*)slot_weight,
      (float*)expert_in, (float*)combine, T, D, E, C, vec_x, vec_cb);
  return (int)cudaGetLastError();
}
