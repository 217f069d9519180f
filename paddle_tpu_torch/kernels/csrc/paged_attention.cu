// Paged-attention decode for Hopper (sm_90a), split-KV, plain C interface.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py:
// _decode_kernel.  For each slot s and window row w it computes masked
// softmax attention of q[s, w] over the logical positions
// j <= positions[s] + w of that slot's KV context, reading K/V straight
// from the block pool through the slot's block table
// (pool[layer, tables[s, j / BS], j % BS, :]) and dequantizing on the
// way: bf16 exactly, int8 as payload x the float32 scale of its
// (layer, block).  The result is the pre-output-projection context
// [S, W, D] in float32.
//
// Bound: bytes.  Every needed K and V row is read once per (slot,
// layer); the arithmetic is 4 flops per K/V element per window row.  At
// decode shapes (8 slots x 8 heads) one CTA per (head, slot) puts 64 CTAs
// on 132 SMs, each walking its whole context alone, so most of the card
// waits on a few long chains of loads.  Design:
//
// - Split-KV.  Grid (split, head, slot): each CTA takes `split_len`
//   positions of one (head, slot) (64 by default, a shape choice made by
//   the wrapper) and stops at the last position row W-1 can see; CTAs
//   past a slot's context exit at once.  It writes its partial (m, l,
//   acc[W][d_head]) -- the split's running max, sum of exp and
//   unnormalised P.V -- to a float32 scratch.  A slot whose context fits
//   one split writes its output directly.
// - A deterministic merge.  The CTA that finishes a (head, slot) last,
//   found by a ticket counter, combines the splits' partials in split
//   order (m = max m_i, l = sum l_i e^(m_i - m), o = sum acc_i e^(m_i - m)
//   / l) and resets the counter to zero for the next launch.  The counter
//   decides only who merges, never the order, and no atomic touches a
//   value: a slot's result depends only on that slot's inputs and is the
//   same from call to call.
// - Short chains.  The split's block-table entries and q load together
//   with the cursor (none depends on it).
// - Staged loads.  The split's K rows go to shared memory by cp.async
//   16-byte copies of the raw pool bytes in tiles of 16 positions, one
//   commit group per tile, then its V rows as one more group: every load
//   of the split is in flight at once, and tile t's scores start as soon
//   as tile t has landed, while the later tiles and V still load.  Values
//   are dequantized when read from shared memory.
// - Scores by warps.  A position's dot product takes d_head / 4 lanes,
//   each with 4 dims of q (the first 4 window rows' q in registers) and
//   of K, reduced with shuffles.  The split's softmax takes one warp per
//   window row.  P.V: each thread owns 4 dims and one residue class of
//   positions, accumulating in float32 registers; the classes are summed
//   in a fixed order through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;      // positions per cp.async commit group
constexpr int kMaxTiles = 8;   // a split holds at most 128 positions
constexpr int kRows = 4;       // window rows per P.V pass (and q in
                               // registers)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wait until at most n of this thread's commit groups are pending
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}

// 4 consecutive elements of a staged row -> float32 (int8: x scale, one
// rounding, as the plain version's payload.float() * scale)
template <typename T>
__device__ __forceinline__ float4 load4(const T* row, int k, float scale);

template <>
__device__ __forceinline__ float4 load4<float>(const float* row, int k,
                                               float) {
  return reinterpret_cast<const float4*>(row)[k];
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* row, int k, float) {
  const uint2 u = reinterpret_cast<const uint2*>(row)[k];
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

template <>
__device__ __forceinline__ float4 load4<int8_t>(const int8_t* row, int k,
                                                float scale) {
  const int u = reinterpret_cast<const int*>(row)[k];
  return make_float4(
      __fmul_rn(static_cast<float>(static_cast<int8_t>(u & 0xff)), scale),
      __fmul_rn(static_cast<float>(static_cast<int8_t>((u >> 8) & 0xff)),
                scale),
      __fmul_rn(static_cast<float>(static_cast<int8_t>((u >> 16) & 0xff)),
                scale),
      __fmul_rn(static_cast<float>(static_cast<int8_t>(u >> 24)), scale));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

__device__ __forceinline__ void fma4(float4& acc, float p, float4 v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory of one CTA, in this order (every part a multiple of 16
// bytes):
//   k_s, v_s [split_len][dh]   the split's raw K and V rows (type T)
//   q_s      [W][dh]           this head's query rows, float32
//   p_s      [W][split_len]    scores, then probabilities
//   red_s    [classes][kRows][dh]  P.V partial sums per position class
//   ks_s, vs_s [split_len]     int8 scales per position (1 otherwise)
//   m_s, l_s [W]               the split's max and sum of exp per row
__host__ __device__ inline size_t smem_bytes(int W, int dh, int split_len,
                                             int elem) {
  const size_t kv = (size_t)split_len * dh * elem;
  const size_t f = (size_t)W * dh + (size_t)W * split_len +
                   (size_t)(kThreads / (dh / 4)) * kRows * dh +
                   2 * (size_t)split_len + 2 * (size_t)((W + 3) / 4 * 4);
  return 2 * kv + f * sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q, const T* __restrict__ pool_k,
                   const T* __restrict__ pool_v,
                   const float* __restrict__ scale_k,
                   const float* __restrict__ scale_v,
                   const int* __restrict__ tables,
                   const int* __restrict__ positions,
                   float* __restrict__ out, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int* __restrict__ counters,
                   int W, int D, int H, int NB, int BS, int NBpool, int layer,
                   int split_len, float scale) {
  constexpr int kVec = 16 / sizeof(T);        // elements per 16-byte copy
  constexpr int kChunks = DH / kVec;          // 16-byte copies per row
  constexpr int kLanes = DH / 4;              // lanes per position
  constexpr int kPerPass = 32 / kLanes;       // positions per warp pass
  constexpr int kClasses = kThreads / kLanes; // P.V position classes

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int n_split_grid = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the split's block-table entries do not depend on the cursor: their
  // loads fly together with the cursor's
  __shared__ int tab_s[kTile * kMaxTiles + 1];
  const int ctx_len = NB * BS;
  const int start = split * split_len;
  const int b0 = start / BS;
  const int pos = positions[s];
  const int* tab = tables + (size_t)s * NB;
  const int n_tab = min((start + split_len - 1) / BS, NB - 1) - b0 + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + (size_t)split_len * DH;
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)split_len * DH);
  for (int i = tid; i < n_tab; i += kThreads) tab_s[i] = tab[b0 + i];
  for (int i = tid; i < W * DH; i += kThreads) {
    const int w = i / DH, d = i - w * DH;
    q_s[i] = q[((size_t)s * W + w) * D + (size_t)h * DH + d];
  }
  // positions past pos + W - 1 are masked for every row: stop there
  const int n_ctx = min(pos + W, ctx_len);
  const int n_split = (n_ctx + split_len - 1) / split_len;
  if (split >= n_split) return;
  const int len = min(split_len, n_ctx - start);
  const int n_tiles = (len + kTile - 1) / kTile;

  float* p_s = q_s + W * DH;
  float* red_s = p_s + W * split_len;
  float* ks_s = red_s + kClasses * kRows * DH;
  float* vs_s = ks_s + split_len;
  float* m_s = vs_s + split_len;
  float* l_s = m_s + (W + 3) / 4 * 4;

  const size_t layer_base = (size_t)layer * NBpool;
  __syncthreads();  // tab_s, q_s

  // 1. issue every load of the split: K by tiles (one group each), then V
  for (int t = 0; t < n_tiles; ++t) {
    const int rows = min(kTile, len - t * kTile);
    for (int c = tid; c < rows * kChunks; c += kThreads) {
      const int jl = t * kTile + c / kChunks, part = c % kChunks;
      const int j = start + jl;
      const size_t off = ((layer_base + tab_s[j / BS - b0]) * BS + j % BS) *
                             (size_t)D + (size_t)h * DH + part * kVec;
      cp_async16(k_s + jl * DH + part * kVec, pool_k + off);
    }
    cp_async_commit();
  }
  for (int c = tid; c < len * kChunks; c += kThreads) {
    const int jl = c / kChunks, part = c % kChunks;
    const int j = start + jl;
    const size_t off = ((layer_base + tab_s[j / BS - b0]) * BS + j % BS) *
                           (size_t)D + (size_t)h * DH + part * kVec;
    cp_async16(v_s + jl * DH + part * kVec, pool_v + off);
  }
  cp_async_commit();

  // while they fly: the int8 scales per position (read after the first
  // tile's barrier below, so they need none of their own)
  for (int jl = tid; jl < len; jl += kThreads) {
    const int j = start + jl;
    const size_t blk = layer_base + tab_s[j / BS - b0];
    ks_s[jl] = scale_k != nullptr ? scale_k[blk] : 1.f;
    vs_s[jl] = scale_v != nullptr ? scale_v[blk] : 1.f;
  }

  // 2. scores, tile by tile as the tiles land
  const int sub = lane / kLanes;  // which position of the warp's pass
  const int k4 = lane % kLanes;   // which 4 dims
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  float4 q_reg[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    q_reg[r] = r < W ? q4[r * kLanes + k4] : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_dyn(n_tiles - t);  // tile t's K (and all before it)
    __syncthreads();
    const int t0 = t * kTile;
    const int rows = min(kTile, len - t0);
    for (int base = warp * kPerPass; base < rows;
         base += kWarps * kPerPass) {
      const int jl = t0 + base + sub;
      const bool ok = base + sub < rows;
      const float4 kv = ok ? load4<T>(k_s + jl * DH, k4, ks_s[jl])
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      const int j = start + jl;
      for (int w = 0; w < W; ++w) {
        float4 qv = q_reg[0];
#pragma unroll
        for (int r = 1; r < kRows; ++r)
          if (r == w) qv = q_reg[r];
        if (w >= kRows) qv = q4[w * kLanes + k4];
        float dot = dot4(qv, kv);
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (ok && k4 == 0)
          p_s[w * split_len + jl] = j <= pos + w ? dot * scale : -INFINITY;
      }
    }
  }
  __syncthreads();

  // 3. the split's softmax: one warp per window row
  for (int w = warp; w < W; w += kWarps) {
    float* pr = p_s + w * split_len;
    float m = -INFINITY;
    for (int jl = lane; jl < len; jl += 32) m = fmaxf(m, pr[jl]);
    m = warp_max(m);
    float l = 0.f;
    for (int jl = lane; jl < len; jl += 32) {
      const float sc = pr[jl];
      const float e = sc == -INFINITY ? 0.f : expf(sc - m);
      pr[jl] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_s[w] = m;
      l_s[w] = l;
    }
  }
  cp_async_wait<0>();  // V
  __syncthreads();

  // 4. P.V, kRows window rows at a time; the classes summed in order
  const bool single = n_split == 1;
  const size_t sh = (size_t)s * H + h;
  const size_t part = sh * n_split_grid + split;
  const int cls = tid / kLanes;
  float4* red4 = reinterpret_cast<float4*>(red_s);
  for (int w0 = 0; w0 < W; w0 += kRows) {
    float4 acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int jl = cls; jl < len; jl += kClasses) {
      const float4 v = load4<T>(v_s + jl * DH, k4, vs_s[jl]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (w0 + r < W) fma4(acc[r], p_s[(w0 + r) * split_len + jl], v);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      red4[(cls * kRows + r) * kLanes + k4] = acc[r];
    __syncthreads();
    for (int i = tid; i < kRows * DH; i += kThreads) {
      const int r = i / DH, d = i - r * DH;
      const int w = w0 + r;
      if (w >= W) continue;
      float o = 0.f;
#pragma unroll 4
      for (int c = 0; c < kClasses; ++c) o += red_s[(c * kRows + r) * DH + d];
      if (single)
        out[((size_t)s * W + w) * D + (size_t)h * DH + d] = o / l_s[w];
      else
        part_acc[(part * W + w) * DH + d] = o;
    }
    __syncthreads();
  }
  if (single) return;
  for (int w = tid; w < W; w += kThreads) {
    part_ml[(part * W + w) * 2] = m_s[w];
    part_ml[(part * W + w) * 2 + 1] = l_s[w];
  }

  // 5. the last CTA of this (head, slot) merges the splits in order
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + sh, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t first = sh * n_split_grid;
  for (int i = tid; i < W * DH; i += kThreads) {
    const int w = i / DH, d = i - w * DH;
    float m = -INFINITY;
    for (int sp = 0; sp < n_split; ++sp)
      m = fmaxf(m, __ldcg(part_ml + ((first + sp) * W + w) * 2));
    float l = 0.f, o = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const size_t pi = (first + sp) * W + w;
      const float mi = __ldcg(part_ml + pi * 2);
      const float f = mi == -INFINITY ? 0.f : expf(mi - m);
      l = fmaf(f, __ldcg(part_ml + pi * 2 + 1), l);
      o = fmaf(f, __ldcg(part_acc + pi * DH + d), o);
    }
    out[((size_t)s * W + w) * D + (size_t)h * DH + d] = o / l;
  }
  if (tid == 0) counters[sh] = 0;
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* scale_k, const void* scale_v,
                   const void* tables, const void* positions, void* out,
                   void* part_acc, void* part_ml, void* counters, int S,
                   int W, int D, int H, int NB, int BS, int NBpool,
                   int layer, int split_len, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(W, DH, split_len, sizeof(T));
  // raise the dynamic shared-memory cap once per instantiation, to the
  // largest request seen so far
  static size_t cap = 48 * 1024;
  if (smem > cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    cap = smem;
  }
  const int n_split = (NB * BS + split_len - 1) / split_len;
  const dim3 grid(n_split, H, S);
  paged_split_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const float*>(scale_k),
      static_cast<const float*>(scale_v), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<float*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), W, D, H, NB, BS, NBpool, layer,
      split_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int dh, const void* q, const void* pool_k,
                      const void* pool_v, const void* scale_k,
                      const void* scale_v, const void* tables,
                      const void* positions, void* out, void* part_acc,
                      void* part_ml, void* counters, int S, int W, int D,
                      int H, int NB, int BS, int NBpool, int layer,
                      int split_len, float scale, cudaStream_t stream) {
#define PAGED_LAUNCH(DH_)                                                   \
  return launch<T, DH_>(q, pool_k, pool_v, scale_k, scale_v, tables,       \
                        positions, out, part_acc, part_ml, counters, S, W, \
                        D, H, NB, BS, NBpool, layer, split_len, scale,     \
                        stream)
  switch (dh) {
    case 16: PAGED_LAUNCH(16);
    case 32: PAGED_LAUNCH(32);
    case 64: PAGED_LAUNCH(64);
    case 128: PAGED_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef PAGED_LAUNCH
}

}  // namespace

// Shared memory one CTA needs (dynamic and static), for the caller's
// limit check.  kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8.
extern "C" size_t paged_attention_decode_smem(int W, int dh, int split_len,
                                              int kv_dtype) {
  const int elem = kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1;
  return smem_bytes(W, dh, split_len, elem) +
         sizeof(int) * (kTile * kMaxTiles + 2);
}

// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8 (scale_k/scale_v are then
// the float32 [L, NBpool] scales; NULL otherwise).  part_acc and part_ml
// are float32 scratch of S * H * n_split * W * d_head and
// S * H * n_split * W * 2 elements (n_split = ceil(NB * BS / split_len));
// counters is int32 [S * H], all zero before the launch and left zero
// after it.  Returns the CUDA error of the launch (0 on success).  The
// caller checks shapes, dtypes, devices, contiguity and 16-byte alignment
// of the pools; d_head = D / H must be 16, 32, 64 or 128, and split_len a
// multiple of 16 of at most 128.
extern "C" int paged_attention_decode(
    const void* q, const void* pool_k, const void* pool_v,
    const void* scale_k, const void* scale_v, const void* tables,
    const void* positions, void* out, void* part_acc, void* part_ml,
    void* counters, int S, int W, int D, int H, int NB, int BS, int NBpool,
    int layer, int split_len, float scale, int kv_dtype, void* stream) {
  if (split_len < kTile || split_len % kTile != 0 ||
      split_len > kTile * kMaxTiles || H < 1 || D % H != 0 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int dh = D / H;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return launch_dh<float>(dh, q, pool_k, pool_v, scale_k, scale_v,
                              tables, positions, out, part_acc, part_ml,
                              counters, S, W, D, H, NB, BS, NBpool, layer,
                              split_len, scale, st);
    case 1:
      return launch_dh<__nv_bfloat16>(dh, q, pool_k, pool_v, scale_k,
                                      scale_v, tables, positions, out,
                                      part_acc, part_ml, counters, S, W, D,
                                      H, NB, BS, NBpool, layer, split_len,
                                      scale, st);
    case 2:
      return launch_dh<int8_t>(dh, q, pool_k, pool_v, scale_k, scale_v,
                               tables, positions, out, part_acc, part_ml,
                               counters, S, W, D, H, NB, BS, NBpool, layer,
                               split_len, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
