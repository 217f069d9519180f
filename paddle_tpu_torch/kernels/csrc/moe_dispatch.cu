// Fused MoE gate + capacity dispatch in routing form, and its backward.
//
// Replaces the TPU kernel paddle_tpu/kernels/moe_dispatch.py
// `_gate_dispatch_kernel` (pallas_call in `build_moe_gate_dispatch`).
// Given tokens x [T, D] and the router gate_w [D, E], float32, it
// computes what that kernel (and parallel/moe.moe_gate plus moe_dense's
// dispatch einsum) computes:
//
//   logits = x . gate_w, probs = softmax(logits)            (per token)
//   idx1 = argmax(probs) (first index on ties); top-2: idx2 = argmax of
//   probs * (1 - onehot(idx1)); g1, g2 = the probs at those indices
//   pos1 = number of earlier tokens whose first choice is the same
//   expert; pos2 = first_count[e] + number of earlier tokens whose
//   second choice is e (second choices after ALL first choices);
//   an assignment is kept when pos < C
//   expert_in [E, C, D] = x[token of slot (e, c)], zeros in empty slots
//   combine weight of a kept slot: g1/(g1+g2) or g2/(g1+g2) (top-1: g1),
//   the denominator clamped at 1e-9
//   aux = E * sum_e mean_t(onehot(idx1))[e] * mean_t(probs)[e]
//
// Routing form.  The TPU kernel writes the combine weights as a dense
// [T, E, C] tensor because the MXU likes dense contractions; every row
// of it has at most two nonzeros.  Here the forward writes the routing:
//   slot_token [E, C]   the token in each capacity slot, or -1
//   slot_weight [E, C]  its combine weight (0 in an empty slot)
//   slot_of [k, T]      each token's slot e * C + pos per choice, or -1
// and the consumer (parallel/moe.moe_combine) gathers at most two
// expert rows a token.  A caller that asks for the dense combine (the
// JAX contract) gets each token's row written from slot_of: zeros and
// at most two weights, a streaming write.  The TPU kernel's one-hot
// dispatch contraction has one nonzero term per output element, so the
// gather into expert_in is bit-equal to it.
//
// Forward: two launches, no atomics, so every output is independent of
// the order blocks run in and two calls are bit-equal.
//   1. route_kernel   a tile of kTile tokens a CTA (one CTA an SM at the
//      MoE LM's shape).  gate_w's rows are requested first, then the
//      tile's x rows go to shared memory by cp.async in kGroups column
//      groups, two in flight: the logits build up group by group as each
//      lands (up to 8 experts; more: all groups first), each gate_w
//      vector from shared memory shared by a warp's kTokWarp tokens, a
//      warp-wide reduce-scatter summing the lanes.  Then per token (8
//      lanes a token) the softmax and top-1/top-2, and per tile each
//      expert's first- and second-choice counts and its sum of probs
//      (aux), in a fixed order.
//   2. place_kernel   kSplit CTAs a tile.  Each sums the earlier tiles'
//      counts and every tile's totals itself (a fixed split over threads,
//      then a fixed order) and ranks the tile's tokens (__match_any_sync
//      in token order); the first writes slot_of and the kept slots'
//      slot_token / slot_weight.  Each reads its share of the tile's x
//      rows once and writes each to its kept choices' slots of
//      expert_in, and zero-fills its even share of the empty slots; CTA
//      (0, 0) writes aux and the first-choice totals.  The redundant
//      prefix reads tiles x 2E counts a CTA: 8 KB at T 4096, E 8.
//      kSplit CTAs a tile keep enough rows in flight on each SM.  The
//      dense combine, when asked for: the CTA's token rows zeroed in a
//      streaming write, then their weights.
//
// Backward (route_backward_kernel, one launch, kSplit CTAs a tile): per
// tile of tokens, the combine weights' cotangent gathered at slot_of,
// the top-2 renormalisation's VJP, the aux term and the softmax VJP ->
// d_logits; then dx = d_logits . gate_w^T (gate_w in shared memory as in
// pass 1) plus the d expert_in rows at slot_of, a token's two choices
// added in choice order, each CTA of a tile over its share of the
// columns.  dgate_w = x^T . d_logits is a GEMM left to the caller.
//
// Bound by bytes.  At T 4096, D 1024, E 8, C 1280, top-2 the forward
// reads x (16.8 MB) and writes expert_in (42 MB); the logits' 67 MFLOP
// do not matter.  The dense combine adds 168 MB.  The backward reads the
// kept rows of d expert_in (at most 33.5 MB) and writes dx (16.8 MB).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxExperts = 64;
constexpr int kTile = 32;                   // tokens a CTA (one a lane)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kTokWarp = kTile / kWarps;    // tokens a warp, pass 1
constexpr int kLdl = kMaxExperts + 1;       // a tile row of logits
constexpr int kGateFloats = 9216;           // 36 KB of gate_w a chunk
constexpr int kChunkCols = 1024;            // x: 128 KB of a tile a chunk
constexpr int kGroups = 4;                  // cp.async groups a chunk
constexpr int kSplit = 4;                   // CTAs a tile, place/backward
constexpr unsigned kFull = 0xffffffffu;

// D-columns a shared-memory chunk (a multiple of 4 below D), and the row
// strides of the transposed gate_w chunk (16-byte aligned rows, 4 floats
// of padding so that the transposing store spreads over banks) and of
// the x tile
__host__ __device__ inline int gate_chunk(int D, int E) {
  int dc = (kGateFloats / E - 4) & ~3;
  dc = dc < kChunkCols ? dc : kChunkCols;
  return dc < D ? dc : D;
}
__host__ __device__ inline int gate_ld(int dc) { return ((dc + 3) & ~3) + 4; }
__host__ __device__ inline int x_ld(int dc) { return (dc + 3) & ~3; }

// dynamic shared memory of route_kernel (x tile + gate_w chunk) and of
// route_backward_kernel (gate_w chunk)
inline size_t route_smem(int D, int E) {
  const int dc = gate_chunk(D, E);
  return ((size_t)kTile * x_ld(dc) + (size_t)E * gate_ld(dc)) * sizeof(float);
}
inline size_t backward_smem(int D, int E) {
  return (size_t)E * gate_ld(gate_chunk(D, E)) * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared, zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `one` (0 or 1) committed groups are in flight
__device__ __forceinline__ void cp_async_wait(bool one) {
  if (one)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// gate_w rows [d0, d0 + n) into gwT[e * ld + d - d0].  Fast path
// (kVec: D % 4 == 0, gate_w aligned; E a multiple of 4 whose quarter
// divides kThreads): each thread keeps one 4-expert column group and
// walks rows in 16-byte vectors with no division (gate_rows); the route
// kernel takes a thread's first kGateRegs rows through registers
// (gate_load early, gate_store later)
constexpr int kGateRegs = 8;

template <bool kVec>
__device__ __forceinline__ bool gate_fast(int E) {
  return kVec && E % 4 == 0 && kThreads % (E / 4) == 0;
}

__device__ __forceinline__ void gate_load(float4 (&v)[kGateRegs],
                                          const float* __restrict__ gw,
                                          int d0, int n, int E) {
  const int e4n = E / 4, step = kThreads / e4n;
  const float4* s4 = reinterpret_cast<const float4*>(gw + (long long)d0 * E);
  const int d = threadIdx.x / e4n, e4 = threadIdx.x % e4n;
#pragma unroll
  for (int u = 0; u < kGateRegs; ++u)
    if (d + u * step < n) v[u] = __ldg(s4 + (d + u * step) * e4n + e4);
}

// rows d + k * step, k >= k0, of this thread's column group
__device__ __forceinline__ void gate_rows(const float* __restrict__ gw,
                                          float* gwT, int d0, int n, int E,
                                          int ld, int k0) {
  const int e4n = E / 4, step = kThreads / e4n;
  const float4* s4 = reinterpret_cast<const float4*>(gw + (long long)d0 * E);
  const int e4 = threadIdx.x % e4n;
  float* dst = gwT + 4 * e4 * ld;
#pragma unroll 4
  for (int r = threadIdx.x / e4n + k0 * step; r < n; r += step) {
    const float4 w = __ldg(s4 + r * e4n + e4);
    dst[r] = w.x;
    dst[ld + r] = w.y;
    dst[2 * ld + r] = w.z;
    dst[3 * ld + r] = w.w;
  }
}

__device__ __forceinline__ void gate_store(const float4 (&v)[kGateRegs],
                                           const float* __restrict__ gw,
                                           float* gwT, int d0, int n, int E,
                                           int ld) {
  const int e4n = E / 4, step = kThreads / e4n;
  const float4* s4 = reinterpret_cast<const float4*>(gw + (long long)d0 * E);
  const int d = threadIdx.x / e4n, e4 = threadIdx.x % e4n;
  float* dst = gwT + 4 * e4 * ld;
#pragma unroll
  for (int u = 0; u < kGateRegs; ++u) {
    const int r = d + u * step;
    if (r < n) {
      dst[r] = v[u].x;
      dst[ld + r] = v[u].y;
      dst[2 * ld + r] = v[u].z;
      dst[3 * ld + r] = v[u].w;
    }
  }
  gate_rows(gw, gwT, d0, n, E, ld, kGateRegs);
}

// the general path: one float at a time
__device__ __forceinline__ void stage_gate(const float* __restrict__ gw,
                                           float* gwT, int d0, int n, int E,
                                           int ld) {
  const float* src = gw + (long long)d0 * E;
  for (int i = threadIdx.x; i < n * E; i += kThreads) {
    const int d = i / E;
    gwT[(i - d * E) * ld + d] = __ldg(src + i);
  }
}

// Reduce-scatter over the warp: each lane holds v[0..31]; afterwards
// lane l's v[0] is the sum over lanes of v[l] (31 shuffles, a fixed
// order).  Step O keeps the half of v[0..2O) that bit O of the lane
// selects and adds the partner's copy of it.
template <int O>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32],
                                                    int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32],
                                                     int lane) {
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0];
}

// max / sum / argmax over a segment of 8 lanes (lanes with equal lane / 8)
__device__ __forceinline__ float seg8_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float seg8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
// the larger value, the lower index on ties (argmax's first index)
__device__ __forceinline__ void seg8_argmax(float& best, int& at) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    const float b = __shfl_xor_sync(kFull, best, o);
    const int a = __shfl_xor_sync(kFull, at, o);
    if (b > best || (b == best && a < at)) {
      best = b;
      at = a;
    }
  }
}

__device__ __forceinline__ void zero_row(float* __restrict__ dst, int D,
                                         bool vec, int lane) {
  if (vec) {
    float4* d = reinterpret_cast<float4*>(dst);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = lane; i < D / 4; i += kWarp) d[i] = z;
  } else {
    for (int i = lane; i < D; i += kWarp) dst[i] = 0.f;
  }
}

// 1. logits, softmax, top-k; per-tile counts and prob sums
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
route_kernel(const float* __restrict__ x, const float* __restrict__ gw,
             float* __restrict__ probs,        // [T, E]
             int* __restrict__ idx,            // [k, T]
             int* __restrict__ tile_counts,    // [tiles, 2E]
             double* __restrict__ tile_psum,   // [tiles, E]
             int T, int D, int E, int top_k) {
  extern __shared__ float4 dyn4[];
  __shared__ float s_lg[kTile * kLdl];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int tile = blockIdx.x, t0 = tile * kTile;
  const int dc = gate_chunk(D, E), ld = gate_ld(dc), ldx = x_ld(dc);
  float* xs = reinterpret_cast<float*>(dyn4);   // [kTile][ldx]
  float* gwT = xs + kTile * ldx;                // [E][ld]

  for (int i = tid; i < kTile * E; i += kThreads)
    s_lg[(i / E) * kLdl + i % E] = 0.f;

  for (int d0 = 0; d0 < D; d0 += dc) {
    const int n = min(dc, D - d0);
    // column groups of the chunk, 16-byte aligned: group g is columns
    // [g * g_cols, (g + 1) * g_cols)
    const int g_cols = ((n + kGroups - 1) / kGroups + 3) & ~3;
    const int ng = (n + g_cols - 1) / g_cols;
    // the tile's x columns of group g, one cp.async group; rows past T
    // are zeros
    auto issue = [&](int g) {
      const int c0 = g * g_cols, m = min(g_cols, n - c0);
      if (kVec) {
        const int m4 = m / 4;
        for (int i = tid; i < kTile * m4; i += kThreads) {
          const int q = i / m4, c = c0 + 4 * (i - q * m4), t = t0 + q;
          cp_async16(xs + q * ldx + c,
                     x + (long long)(t < T ? t : 0) * D + d0 + c, t < T);
        }
      } else {
        for (int i = tid; i < kTile * m; i += kThreads) {
          const int q = i / m, c = c0 + i - q * m, t = t0 + q;
          cp_async4(xs + q * ldx + c,
                    x + (long long)(t < T ? t : 0) * D + d0 + c, t < T);
        }
      }
      cp_async_commit();
    };
    // up to 8 experts: two groups in flight, the logits building up as
    // each lands while the next comes in; more experts: every group
    // first, then 8 experts at a time
    const bool piped = E <= 8;
    __syncthreads();     // the previous chunk's readers are done
    // gate_w's first rows are requested before x's, so that they do not
    // queue behind 128 KB of x
    float4 gv[kGateRegs];
    const bool fast = gate_fast<kVec>(E);
    if (fast) gate_load(gv, gw, d0, n, E);
    for (int g = 0; g < (piped ? min(ng, 2) : ng); ++g) issue(g);
    if (fast)
      gate_store(gv, gw, gwT, d0, n, E, ld);
    else
      stage_gate(gw, gwT, d0, n, E, ld);
    const float* xw = xs + warp * kTokWarp * ldx;   // this warp's tokens
    for (int e0 = 0; e0 < E; e0 += 8) {
      float acc[kTokWarp][8];
#pragma unroll
      for (int q = 0; q < kTokWarp; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[q][j] = 0.f;
      for (int g = 0; g < ng; ++g) {
        if (e0 == 0 && (piped || g == 0)) {
          cp_async_wait(piped && g + 1 < ng);
          __syncthreads();
          if (piped && g + 2 < ng) issue(g + 2);
        }
        const int c1 = min(n, (g + 1) * g_cols);
        if (kVec) {
          for (int d = g * g_cols + lane * 4; d < c1; d += kWarp * 4) {
            float4 xv[kTokWarp];
#pragma unroll
            for (int q = 0; q < kTokWarp; ++q)
              xv[q] = *reinterpret_cast<const float4*>(xw + q * ldx + d);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (e0 + j < E) {
                const float4 w = *reinterpret_cast<const float4*>(
                    gwT + (e0 + j) * ld + d);
#pragma unroll
                for (int q = 0; q < kTokWarp; ++q) {
                  float a = acc[q][j];
                  a = fmaf(xv[q].x, w.x, a);
                  a = fmaf(xv[q].y, w.y, a);
                  a = fmaf(xv[q].z, w.z, a);
                  acc[q][j] = fmaf(xv[q].w, w.w, a);
                }
              }
            }
          }
        } else {
          for (int d = g * g_cols + lane; d < c1; d += kWarp) {
            float xv[kTokWarp];
#pragma unroll
            for (int q = 0; q < kTokWarp; ++q) xv[q] = xw[q * ldx + d];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (e0 + j < E) {
                const float w = gwT[(e0 + j) * ld + d];
#pragma unroll
                for (int q = 0; q < kTokWarp; ++q)
                  acc[q][j] = fmaf(xv[q], w, acc[q][j]);
              }
            }
          }
        }
      }
      // lane l gets token warp * 4 + l / 8, expert e0 + l % 8
      float v[32];
#pragma unroll
      for (int q = 0; q < kTokWarp; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j) v[q * 8 + j] = acc[q][j];
      const float sum = warp_reduce_scatter(v, lane);
      if (e0 + lane % 8 < E)
        s_lg[(warp * kTokWarp + lane / 8) * kLdl + e0 + lane % 8] += sum;
    }
  }
  __syncwarp();

  __shared__ int s_i1[kTile], s_i2[kTile];
  // softmax and top-k: the 8 lanes of segment lane / 8 take the warp's
  // token warp * 4 + lane / 8, lane j its experts j, j + 8, ...; lane j
  // starts from its first expert, so the index the segment agrees on is
  // always an expert's
  {
    const int q = warp * kTokWarp + lane / 8, j = lane % 8, t = t0 + q;
    float* l = s_lg + q * kLdl;
    float mx = -INFINITY;
    for (int e = j; e < E; e += 8) mx = fmaxf(mx, l[e]);
    mx = seg8_max(mx);
    float part = 0.f;
    for (int e = j; e < E; e += 8) {
      const float v = expf(l[e] - mx);   // as jax.nn.softmax
      l[e] = v;
      part += v;
    }
    const float sum = seg8_sum(part);
    float best = -INFINITY;
    int i1 = E;
    for (int e = j; e < E; e += 8) {
      const float p = l[e] / sum;
      l[e] = p;
      if (e == j || p > best) { best = p; i1 = e; }
    }
    seg8_argmax(best, i1);
    int i2 = -1;
    if (top_k == 2) {
      float best2 = -INFINITY;
      i2 = E;
      for (int e = j; e < E; e += 8) {
        const float p2 = e == i1 ? 0.f : l[e];
        if (e == j || p2 > best2) { best2 = p2; i2 = e; }
      }
      seg8_argmax(best2, i2);
    }
    if (j == 0) {
      const bool valid = t < T;
      s_i1[q] = valid ? i1 : -1;
      s_i2[q] = valid ? i2 : -1;
      if (valid) {
        idx[t] = i1;
        if (top_k == 2) idx[T + t] = i2;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {   // the tile's counts: lane i is token i
    const int i1 = s_i1[lane], i2 = s_i2[lane];
    int* cnt = tile_counts + (long long)tile * 2 * E;
    for (int e = 0; e < E; ++e) {
      const unsigned b1 = __ballot_sync(kFull, i1 == e);
      const unsigned b2 = __ballot_sync(kFull, i2 == e);
      if (lane == 0) {
        cnt[e] = __popc(b1);
        cnt[E + e] = __popc(b2);
      }
    }
  }
  const int nt = min(kTile, T - t0);
  for (int i = tid; i < nt * E; i += kThreads)
    probs[(long long)t0 * E + i] = s_lg[(i / E) * kLdl + i % E];
  // each expert's prob sum over the tile's tokens in order: 4 runs of 8
  // tokens, then the runs in order
  __shared__ double s_part[4][kMaxExperts];
  if (tid < 4 * E) {
    const int e = tid % E, r = tid / E;
    double s = 0.0;
    for (int q = 8 * r; q < min(8 * r + 8, nt); ++q)
      s += (double)s_lg[q * kLdl + e];
    s_part[r][e] = s;
  }
  __syncthreads();
  if (tid < E)
    tile_psum[(long long)tile * E + tid] =
        ((s_part[0][tid] + s_part[1][tid]) + s_part[2][tid]) + s_part[3][tid];
}

// 2. positions, the routing, expert_in, aux (and the dense combine);
// CTA (tile, sub) of kSplit a tile
__global__ void __launch_bounds__(kThreads)
place_kernel(const float* __restrict__ x, const float* __restrict__ probs,
             const int* __restrict__ idx, const int* __restrict__ tile_counts,
             const double* __restrict__ tile_psum,
             int* __restrict__ slot_token,      // [E * C]
             float* __restrict__ slot_weight,   // [E * C]
             int* __restrict__ slot_of,         // [k, T]
             int* __restrict__ first_count,     // [E]
             float* __restrict__ expert_in,     // [E * C, D]
             float* __restrict__ combine,       // [T, E * C] or null
             float* __restrict__ aux, int T, int D, int E, int C, int top_k,
             int tiles, int vec, int vec_cb) {
  __shared__ int s_lt[kThreads], s_all[kThreads];
  __shared__ double s_ps[kThreads];
  __shared__ int s_plt[2 * kMaxExperts], s_pall[2 * kMaxExperts];
  __shared__ int s_base[2][kMaxExperts], s_fill[kMaxExperts];
  __shared__ float s_fp[kMaxExperts];
  __shared__ long long s_zoff[kMaxExperts + 1];
  __shared__ int s_slot[2 * kTile];
  __shared__ float s_w[2 * kTile];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int tile = blockIdx.x, sub = blockIdx.y, t0 = tile * kTile;
  const bool first_cta = tile == 0 && sub == 0;
  const long long EC = (long long)E * C;
  // counts of the earlier tiles and of all tiles: thread (p, g) sums
  // tiles g, g + G, ... of pair p (choice, expert); integers, so exact
  const int P = 2 * E, G = kThreads / P;
  if (tid < P * G) {
    const int p = tid % P, g = tid / P;
    int lt = 0, all = 0;
#pragma unroll 4
    for (int b = g; b < tiles; b += G) {
      const int c = tile_counts[(long long)b * P + p];
      all += c;
      lt += b < tile ? c : 0;
    }
    s_lt[tid] = lt;
    s_all[tid] = all;
  }
  const int GE = kThreads / E;
  if (first_cta && tid < E * GE) {   // the prob sums, for aux
    const int p = tid % E, g = tid / E;
    double s = 0.0;
    for (int b = g; b < tiles; b += GE) s += tile_psum[(long long)b * E + p];
    s_ps[tid] = s;
  }
  __syncthreads();
  if (tid < P) {
    int lt = 0, all = 0;
    for (int g = 0; g < G; ++g) {
      lt += s_lt[g * P + tid];
      all += s_all[g * P + tid];
    }
    s_plt[tid] = lt;
    s_pall[tid] = all;
  }
  if (first_cta && tid < E) {
    double s = 0.0;
    for (int g = 0; g < GE; ++g) s += s_ps[g * E + tid];
    s_fp[tid] = (float)(s / (double)T);
  }
  __syncthreads();
  if (tid < E) {
    const int f = s_pall[tid], sec = s_pall[E + tid];
    s_base[0][tid] = s_plt[tid];
    s_base[1][tid] = f + s_plt[E + tid];   // after ALL first choices
    s_fill[tid] = min(C, f + sec);
    if (first_cta) first_count[tid] = f;
  }
  __syncthreads();
  if (tid == 0) {
    s_zoff[0] = 0;
    for (int e = 0; e < E; ++e) s_zoff[e + 1] = s_zoff[e] + (C - s_fill[e]);
    if (first_cta) {
      float acc = 0.f;
      for (int e = 0; e < E; ++e)
        acc += ((float)s_pall[e] / (float)T) * s_fp[e];
      aux[0] = (float)E * acc;
    }
  }

  // rank within the tile: warp j takes choice j, lane i token t0 + i
  if (warp < top_k) {
    const int j = warp, t = t0 + lane;
    const bool valid = t < T;
    const int e = valid ? idx[(long long)j * T + t] : -1;
    const unsigned same = __match_any_sync(kFull, e);
    const int rank = __popc(same & ((1u << lane) - 1u));
    int slot = -1;
    float w = 0.f;
    if (valid) {
      const int pos = s_base[j][e] + rank;
      const float* p = probs + (long long)t * E;
      if (top_k == 1) {
        w = p[e];
      } else {
        const float g1 = p[idx[t]], g2 = p[idx[T + t]];
        const float denom = fmaxf(g1 + g2, 1e-9f);
        w = (j == 0 ? g1 : g2) / denom;
      }
      if (pos < C) slot = e * C + pos;
      if (sub == 0) {
        if (slot >= 0) {
          slot_token[slot] = t;
          slot_weight[slot] = w;
        }
        slot_of[(long long)j * T + t] = slot;
      }
    }
    s_slot[j * kTile + lane] = slot;
    s_w[j * kTile + lane] = w;
  } else if (warp == 1) {   // top-1: no second choices
    s_slot[kTile + lane] = -1;
    s_w[kTile + lane] = 0.f;
  }
  __syncthreads();

  // this CTA's tokens q = sub, sub + kSplit, ... of the tile: each x
  // row read once and written to its kept choices' slots, 8 vectors a
  // thread in flight
  const int nq = (kTile - sub + kSplit - 1) / kSplit;
  if (vec) {
    const int n4 = D / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* ei4 = reinterpret_cast<float4*>(expert_in);
    for (int w0 = tid; w0 < nq * n4; w0 += kThreads * 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int w = w0 + u * kThreads;
        if (w < nq * n4) {
          const int i = w / n4, q = sub + i * kSplit;
          if (s_slot[q] >= 0 || s_slot[kTile + q] >= 0)
            v[u] = __ldg(x4 + (long long)(t0 + q) * n4 + (w - i * n4));
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int w = w0 + u * kThreads;
        if (w < nq * n4) {
          const int i = w / n4, q = sub + i * kSplit, c = w - i * n4;
          const int s0 = s_slot[q], s1 = s_slot[kTile + q];
          if (s0 >= 0) ei4[(long long)s0 * n4 + c] = v[u];
          if (s1 >= 0) ei4[(long long)s1 * n4 + c] = v[u];
        }
      }
    }
  } else {
    for (int w = tid; w < nq * D; w += kThreads) {
      const int i = w / D, q = sub + i * kSplit, c = w - i * D;
      const int s0 = s_slot[q], s1 = s_slot[kTile + q];
      if (s0 >= 0 || s1 >= 0) {
        const float v = __ldg(x + (long long)(t0 + q) * D + c);
        if (s0 >= 0) expert_in[(long long)s0 * D + c] = v;
        if (s1 >= 0) expert_in[(long long)s1 * D + c] = v;
      }
    }
  }
  // this CTA's even share of the empty slots (expert e's empty slots
  // are s_fill[e] .. C - 1)
  const long long Z = s_zoff[E], ctas = (long long)tiles * kSplit;
  const long long me = (long long)tile * kSplit + sub;
  for (long long z = Z * me / ctas + warp; z < Z * (me + 1) / ctas;
       z += kWarps) {
    int e = 0;
    while (s_zoff[e + 1] <= z) ++e;
    const long long slot = (long long)e * C + s_fill[e] + (z - s_zoff[e]);
    if (lane == 0) {
      slot_token[slot] = -1;
      slot_weight[slot] = 0.f;
    }
    zero_row(expert_in + slot * D, D, vec != 0, lane);
  }

  // the dense combine, when asked for: this CTA's token rows zeroed in
  // a streaming write, then each row's at most two weights (the zeros
  // of this CTA land first: the barrier orders its threads' writes)
  if (combine != nullptr) {
    const int nt = min(kTile, T - t0);
    const int nr = nt > sub ? (nt - sub + kSplit - 1) / kSplit : 0;
    for (int i = 0; i < nr; ++i) {
      float* row = combine + (long long)(t0 + sub + i * kSplit) * EC;
      if (vec_cb) {
        float4* r4 = reinterpret_cast<float4*>(row);
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (long long c = tid; c < EC / 4; c += kThreads) r4[c] = z;
      } else {
        for (long long c = tid; c < EC; c += kThreads) row[c] = 0.f;
      }
    }
    __syncthreads();
    if (tid < 2 * nr) {
      const int i = tid / 2, j = tid % 2, q = sub + i * kSplit;
      const int slot = s_slot[j * kTile + q];
      if (slot >= 0)
        combine[(long long)(t0 + q) * EC + slot] = s_w[j * kTile + q];
    }
  }
}

// the backward: d_logits and dx for a tile of tokens; CTA (tile, sub)
// of kSplit a tile takes columns [D * sub / kSplit, D * (sub + 1) /
// kSplit) of dx (in vectors of 4 when kVec)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
route_backward_kernel(const float* __restrict__ gw,
                      const float* __restrict__ probs,
                      const int* __restrict__ idx,
                      const int* __restrict__ slot_of,
                      const int* __restrict__ first_count,
                      const float* __restrict__ d_ei,    // [E * C, D] or null
                      const float* __restrict__ d_sw,    // [E * C] or null
                      const float* __restrict__ d_aux,   // [1] or null
                      float* __restrict__ dx,            // [T, D]
                      float* __restrict__ d_logits,      // [T, E]
                      int T, int D, int E, int top_k) {
  extern __shared__ float4 dyn4[];
  float* gwT = reinterpret_cast<float*>(dyn4);
  __shared__ float s_dl[kTile * kLdl];
  __shared__ int s_slot[2 * kTile];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int tile = blockIdx.x, sub = blockIdx.y, t0 = tile * kTile;
  const int nt = min(kTile, T - t0);

  if (warp == 0) {
    const int t = t0 + lane;
    int s0 = -1, s1 = -1;
    if (t < T) {
      float* dp = s_dl + lane * kLdl;   // d probs, then d logits
      const float* p = probs + (long long)t * E;
      const float da = d_aux != nullptr ? d_aux[0] : 0.f;
      for (int e = 0; e < E; ++e)
        dp[e] = d_aux != nullptr
                    ? da * (float)E * ((float)first_count[e] / (float)T) /
                          (float)T
                    : 0.f;
      s0 = slot_of[t];
      s1 = top_k == 2 ? slot_of[T + t] : -1;
      if (d_sw != nullptr) {
        float dc0 = s0 >= 0 ? d_sw[s0] : 0.f;
        float dc1 = s1 >= 0 ? d_sw[s1] : 0.f;
        const int i1 = idx[t];
        if (top_k == 2) {
          const int i2 = idx[T + t];
          const float g1 = p[i1], g2 = p[i2], total = g1 + g2;
          const float denom = fmaxf(total, 1e-9f);
          const float dd =
              total >= 1e-9f ? -(dc0 * g1 + dc1 * g2) / (denom * denom) : 0.f;
          dc0 = dc0 / denom + dd;
          dc1 = dc1 / denom + dd;
          dp[i1] += dc0;   // choice order: a coinciding pair adds in turn
          dp[i2] += dc1;
        } else {
          dp[i1] += dc0;
        }
      }
      float s = 0.f;
      for (int e = 0; e < E; ++e) s += dp[e] * p[e];
      for (int e = 0; e < E; ++e) dp[e] = p[e] * (dp[e] - s);
    }
    s_slot[lane] = s0;
    s_slot[kTile + lane] = s1;
  }
  __syncthreads();
  if (sub == 0)
    for (int i = tid; i < nt * E; i += kThreads)
      d_logits[(long long)t0 * E + i] = s_dl[(i / E) * kLdl + i % E];

  const int dc = gate_chunk(D, E), ld = gate_ld(dc);
  const int c0 = kVec ? 4 * (D / 4 * sub / kSplit) : D * sub / kSplit;
  const int c1 = kVec ? 4 * (D / 4 * (sub + 1) / kSplit)
                      : D * (sub + 1) / kSplit;
  for (int d0 = c0; d0 < c1; d0 += dc) {
    const int n = min(dc, c1 - d0);
    __syncthreads();
    if (gate_fast<kVec>(E))
      gate_rows(gw, gwT, d0, n, E, ld, 0);
    else
      stage_gate(gw, gwT, d0, n, E, ld);
    __syncthreads();
    if (kVec) {
      const int nq = n / 4;
#pragma unroll 4
      for (int w = tid; w < nt * nq; w += kThreads) {
        const int q = w / nq, d = 4 * (w - q * nq);
        const float* dl = s_dl + q * kLdl;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int e = 0; e < E; ++e) {
          const float a = dl[e];
          const float4 g = *reinterpret_cast<const float4*>(gwT + e * ld + d);
          acc.x = fmaf(a, g.x, acc.x);
          acc.y = fmaf(a, g.y, acc.y);
          acc.z = fmaf(a, g.z, acc.z);
          acc.w = fmaf(a, g.w, acc.w);
        }
        if (d_ei != nullptr) {
          float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
          const int s0 = s_slot[q], s1 = s_slot[kTile + q];
          if (s0 >= 0)
            r = __ldg(reinterpret_cast<const float4*>(
                d_ei + (long long)s0 * D + d0 + d));
          if (s1 >= 0) {
            const float4 r1 = __ldg(reinterpret_cast<const float4*>(
                d_ei + (long long)s1 * D + d0 + d));
            r.x += r1.x;
            r.y += r1.y;
            r.z += r1.z;
            r.w += r1.w;
          }
          acc.x += r.x;
          acc.y += r.y;
          acc.z += r.z;
          acc.w += r.w;
        }
        *reinterpret_cast<float4*>(dx + (long long)(t0 + q) * D + d0 + d) =
            acc;
      }
    } else {
      for (int w = tid; w < nt * n; w += kThreads) {
        const int q = w / n, d = w - q * n;
        const float* dl = s_dl + q * kLdl;
        float acc = 0.f;
        for (int e = 0; e < E; ++e) acc = fmaf(dl[e], gwT[e * ld + d], acc);
        if (d_ei != nullptr) {
          float r = 0.f;
          const int s0 = s_slot[q], s1 = s_slot[kTile + q];
          if (s0 >= 0) r = __ldg(d_ei + (long long)s0 * D + d0 + d);
          if (s1 >= 0) r += __ldg(d_ei + (long long)s1 * D + d0 + d);
          acc += r;
        }
        dx[(long long)(t0 + q) * D + d0 + d] = acc;
      }
    }
  }
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

inline bool bad_shape(int T, int D, int E, int C, int top_k) {
  return T < 1 || D < 1 || E < 1 || E > kMaxExperts || C < 1 ||
         (top_k != 1 && top_k != 2);
}

// opt a kernel into `bytes` of dynamic shared memory (static and dynamic
// shared memory together may pass the default 48 KB only so);
// `granted` remembers the largest size asked for so far
template <typename K>
int allow_smem(K kernel, size_t bytes, size_t* granted) {
  if (bytes <= *granted) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == 0) *granted = bytes;
  return rc;
}

size_t g_route_smem[2] = {0, 0}, g_backward_smem[2] = {0, 0};

}  // namespace

// Tokens a CTA: the wrapper sizes the per-tile scratch by it.
extern "C" int moe_route_tile() { return kTile; }

// Forward.  Outputs: probs [T, E] f32, idx [k, T] i32, slot_token
// [E, C] i32, slot_weight [E, C] f32, slot_of [k, T] i32, first_count
// [E] i32, expert_in [E, C, D] f32, aux [1] f32 and, unless `combine` is
// null, the dense combine [T, E, C] f32.  Scratch: tile_counts
// [tiles, 2E] i32, tile_psum [tiles, E] f64, tiles = ceil(T / kTile).
// Returns the first CUDA error of the two launches.  What the kernel
// takes is decided in one place, the wrapper's moe_dispatch_supports;
// the guard below only keeps a direct call inside the fixed-size arrays.
extern "C" int moe_route_forward(const void* x, const void* gate_w,
                                 void* probs, void* idx, void* tile_counts,
                                 void* tile_psum, void* slot_token,
                                 void* slot_weight, void* slot_of,
                                 void* first_count, void* expert_in,
                                 void* combine, void* aux, int T, int D,
                                 int E, int C, int top_k, void* stream) {
  if (bad_shape(T, D, E, C, top_k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (T + kTile - 1) / kTile;
  const size_t smem = route_smem(D, E);
  const bool vec = D % 4 == 0 && aligned16(x) && aligned16(gate_w);
  auto route = vec ? route_kernel<true> : route_kernel<false>;
  int rc = allow_smem(route, smem, &g_route_smem[vec]);
  if (rc) return rc;
  route<<<tiles, kThreads, smem, st>>>(
      (const float*)x, (const float*)gate_w, (float*)probs, (int*)idx,
      (int*)tile_counts, (double*)tile_psum, T, D, E, top_k);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long ec = (long long)E * C;
  const int vec_rows = D % 4 == 0 && aligned16(x) && aligned16(expert_in);
  const int vec_cb = combine != nullptr && ec % 4 == 0 && aligned16(combine);
  place_kernel<<<dim3(tiles, kSplit), kThreads, 0, st>>>(
      (const float*)x, (const float*)probs, (const int*)idx,
      (const int*)tile_counts, (const double*)tile_psum, (int*)slot_token,
      (float*)slot_weight, (int*)slot_of, (int*)first_count,
      (float*)expert_in, (float*)combine, (float*)aux, T, D, E, C, top_k,
      tiles, vec_rows, vec_cb);
  return (int)cudaGetLastError();
}

// Backward.  Inputs: the forward's probs, idx, slot_of and first_count,
// and the cotangents of expert_in [E, C, D], slot_weight [E, C] and aux
// [1] (each may be null: zero).  Outputs dx [T, D] and d_logits [T, E].
extern "C" int moe_route_backward(const void* gate_w, const void* probs,
                                  const void* idx, const void* slot_of,
                                  const void* first_count,
                                  const void* d_expert_in,
                                  const void* d_slot_weight,
                                  const void* d_aux, void* dx,
                                  void* d_logits, int T, int D, int E, int C,
                                  int top_k, void* stream) {
  if (bad_shape(T, D, E, C, top_k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (T + kTile - 1) / kTile;
  const size_t smem = backward_smem(D, E);
  const bool vec = D % 4 == 0 && aligned16(dx) && aligned16(gate_w) &&
                   (d_expert_in == nullptr || aligned16(d_expert_in));
  auto bwd = vec ? route_backward_kernel<true> : route_backward_kernel<false>;
  int rc = allow_smem(bwd, smem, &g_backward_smem[vec]);
  if (rc) return rc;
  bwd<<<dim3(tiles, kSplit), kThreads, smem, st>>>(
      (const float*)gate_w, (const float*)probs, (const int*)idx,
      (const int*)slot_of, (const int*)first_count,
      (const float*)d_expert_in, (const float*)d_slot_weight,
      (const float*)d_aux, (float*)dx, (float*)d_logits, T, D, E, top_k);
  return (int)cudaGetLastError();
}
