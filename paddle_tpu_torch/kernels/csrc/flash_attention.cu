// Flash attention, forward and backward, for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernels of paddle_tpu/kernels/flash_attention.py:
//   flash_attention_fwd     <- _fwd_kernel  (O and the per-row logsumexp)
//   flash_attention_bwd_dq  <- _dq_kernel   (dQ = sum_k dS K)
//   flash_attention_bwd_dkv <- _dkv_kernel  (dV = sum_q P^T dO,
//                                             dK = sum_q dS^T Q)
// Tensors keep the JAX package's [batch, seq, heads, head_dim] layout and
// are read through their strides: no fold to [b*h, s, d], no transposes,
// no head-pair packing (those were TPU lane and VMEM choices).  lse and
// delta = rowsum(dO * O) are float32 [batch, heads, seq_q].
//
// Semantics follow the JAX kernels exactly: scores S = Q K^T * scale;
// causal masking is top-left aligned (query row i sees key positions
// 0..i, also when seq_q != seq_k) with the finite mask value -1e30; a
// row whose softmax sum is 0 divides by 1.  K/V tiles wholly above the
// diagonal are skipped (forward, dQ), and a K/V tile's backward starts
// at the first query tile that can see it (dK/dV).
//
// Bound: operations.  At the training shape [8, 512, 16, 128] causal in
// float32, the forward does 8.6 GFLOP on 134 MB, far above the card's
// float32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP per byte).
// Design, simple first: float32 FMA on tiles staged in shared memory,
// inputs converted to float32 as they are staged (bf16 in, float32
// accumulate).  One CTA of 256 threads per (batch*head, 64-row tile);
// each thread owns a 4x4 block of a 64x64 score tile (rows ty+16i,
// columns tx+16j) and 4 rows x D/16 columns of its accumulators, so a
// row's softmax max and sum reduce inside one half-warp by shuffles.
// Shared rows are padded to D+4 floats: the 16-byte loads of the
// score products are free of bank conflicts.  The online softmax keeps
// the running max and sum per row in registers.  No atomics: dQ is
// summed over K tiles by its own CTA and dK/dV over Q tiles by theirs,
// so the backward is bit-identical from run to run.  Tensor cores
// (mma.sync / wgmma), TMA and cp.async pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // query rows and key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kSP = kTile + 4;   // padded row of a 64-wide score tile
constexpr float kNegInf = -1e30f;

struct Layout {
  long long sb, ss, sh;  // element strides of the batch, seq, head dims
};

template <typename T>
struct Chunk;  // elements per 16-byte global load
template <>
struct Chunk<float> {
  static constexpr int N = 4;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load_chunk(const float* p, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]);
  const float2 d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows [row0, row0 + 64) of head (b, h) of x -> dst [64][D + 4] float32;
// rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* x, Layout l,
                                          int b, int h, int row0, int n) {
  constexpr int N = Chunk<T>::N;
  constexpr int kPerRow = D / N;
  const T* base = x + (long long)b * l.sb + (long long)h * l.sh;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * N;
    float* d = dst + r * (D + 4) + c;
    const int row = row0 + r;
    if (row < n) {
      load_chunk(base + (long long)row * l.ss + c, d);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) d[e] = 0.f;
    }
  }
}

// The first 64 entries from v + row0 (a [b, h] row of lse or delta)
// -> dst; zero past n.
__device__ __forceinline__ void load_vec(float* dst, const float* v,
                                         int row0, int n) {
  const int t = threadIdx.x;
  if (t < kTile) dst[t] = (row0 + t < n) ? v[row0 + t] : 0.f;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] = sum_k A[ty+16i][k] * B[tx+16j][k], k < K; both operands
// [64][K + 4] in shared memory.
template <int K>
__device__ __forceinline__ void mm_abt(const float* A, const float* B,
                                       int ty, int tx, float (&acc)[4][4]) {
  constexpr int S = K + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * S + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * S + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// Column of a thread's j-th accumulator: 4 consecutive columns per
// 16-byte load when D >= 64, else every 16th column.
template <int D>
__device__ __forceinline__ int col_of(int tx, int j) {
  if constexpr (D >= 64) {
    return 4 * (tx + 16 * (j >> 2)) + (j & 3);
  } else {
    return tx + 16 * j;
  }
}

// acc[i][j] += sum_k P[ty+16i][k] * B[k][col_of(j)], k < 64; P is
// [64][68], B [64][D + 4], both in shared memory.
template <int D>
__device__ __forceinline__ void mm_ab(const float* P, const float* B, int ty,
                                      int tx, float (&acc)[4][D / 16]) {
  constexpr int S = D + 4;
  constexpr int NC = D / 16;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kSP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* brow = B + (k + kk) * S;
      float bv[NC];
      if constexpr (D >= 64) {
#pragma unroll
        for (int g = 0; g < D / 64; ++g) {
          const float4 t =
              *reinterpret_cast<const float4*>(brow + 4 * (tx + 16 * g));
          bv[4 * g] = t.x;
          bv[4 * g + 1] = t.y;
          bv[4 * g + 2] = t.z;
          bv[4 * g + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j) bv[j] = brow[tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = comp(p[i], kk);
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv, bv[j], acc[i][j]);
      }
    }
  }
}

// Rows [row0, row0 + 64) of acc (this thread's part) -> a contiguous
// [B, n, H, D] tensor, rows past n dropped, times `mul` per row.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[4][D / 16],
                                           const float (&mul)[4], int b, int h,
                                           int H, int n, int row0, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n) continue;
    T* dst = out + (((long long)b * n + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      store_val(dst + col_of<D>(tx, j), acc[i][j] * mul[i]);
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return (2 * kTile * (D + 4) + kTile * kSP) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (3 * kTile * (D + 4) + kTile * kSP + 2 * kTile) * sizeof(float);
}
template <int D>
constexpr size_t dkv_smem() {
  return (4 * kTile * (D + 4) + kTile * kSP + 2 * kTile) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int H, int SQ, int SK, Layout lq,
               Layout lk, Layout lv, float scale, int causal) {
  constexpr int S = D + 4;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sKV = sQ + kTile * S;
  float* sP = sKV + kTile * S;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = blockIdx.y, q0 = qt * kTile;

  load_tile<T, D>(sQ, q, lq, b, h, q0, SQ);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }
  int nk = (SK + kTile - 1) / kTile;
  if (causal && nk > qt + 1) nk = qt + 1;  // tiles past the diagonal
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's P.V is done with sKV and sP
    load_tile<T, D>(sKV, k, lk, b, h, k0, SK);
    __syncthreads();
    float s[4][4];
    mm_abt<D>(sQ, sKV, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= SK || (causal && col > row)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(ty + 16 * i) * kSP + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // K reads done, P written
    load_tile<T, D>(sKV, v, lv, b, h, k0, SK);
    __syncthreads();
    mm_ab<D>(sP, sKV, ty, tx, acc);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / l_safe;
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < SQ)
      lse[((long long)b * H + h) * SQ + row] = m[i] + logf(l_safe);
  }
  store_rows<T, D>(o, acc, inv, b, h, H, SQ, q0, ty, tx);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int SQ, int SK, Layout lq, Layout lk,
              Layout lv, float scale, int causal) {
  constexpr int S = D + 4;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * S;
  float* sKV = sdO + kTile * S;
  float* sDS = sKV + kTile * S;
  float* sL = sDS + kTile * kSP;
  float* sDelta = sL + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = blockIdx.y, q0 = qt * kTile;
  const Layout ld = {(long long)SQ * H * D, (long long)H * D, D};
  const long long vec = ((long long)b * H + h) * SQ;

  load_tile<T, D>(sQ, q, lq, b, h, q0, SQ);
  load_tile<T, D>(sdO, dout, ld, b, h, q0, SQ);
  load_vec(sL, lse + vec, q0, SQ);
  load_vec(sDelta, delta + vec, q0, SQ);
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  int nk = (SK + kTile - 1) / kTile;
  if (causal && nk > qt + 1) nk = qt + 1;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's dS.K is done with sKV and sDS
    load_tile<T, D>(sKV, v, lv, b, h, k0, SK);
    __syncthreads();
    float dp[4][4];
    mm_abt<D>(sdO, sKV, ty, tx, dp);  // dP = dO V^T
    __syncthreads();
    load_tile<T, D>(sKV, k, lk, b, h, k0, SK);
    __syncthreads();
    float s[4][4];
    mm_abt<D>(sQ, sKV, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool masked = col >= SK || (causal && col > row);
        const float p = masked ? 0.f : expf(s[i][j] * scale - sL[r]);
        sDS[r * kSP + tx + 16 * j] = p * (dp[i][j] - sDelta[r]) * scale;
      }
    }
    __syncthreads();
    mm_ab<D>(sDS, sKV, ty, tx, acc);  // dQ += dS K
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dq, acc, one, b, h, H, SQ, q0, ty, tx);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int SQ, int SK,
               Layout lq, Layout lk, Layout lv, float scale, int causal) {
  constexpr int S = D + 4;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kTile * S;
  float* sQ = sV + kTile * S;
  float* sdO = sQ + kTile * S;
  float* sPS = sdO + kTile * S;
  float* sL = sPS + kTile * kSP;
  float* sDelta = sL + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kt = blockIdx.y, k0 = kt * kTile;
  const Layout ld = {(long long)SQ * H * D, (long long)H * D, D};
  const long long vec = ((long long)b * H + h) * SQ;

  load_tile<T, D>(sK, k, lk, b, h, k0, SK);
  load_tile<T, D>(sV, v, lv, b, h, k0, SK);
  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }
  const int nq = (SQ + kTile - 1) / kTile;
  // causal: query tiles before this key tile's diagonal never see it
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the last tile's products are done with sQ/sdO/sPS
    load_tile<T, D>(sQ, q, lq, b, h, q0, SQ);
    load_tile<T, D>(sdO, dout, ld, b, h, q0, SQ);
    load_vec(sL, lse + vec, q0, SQ);
    load_vec(sDelta, delta + vec, q0, SQ);
    __syncthreads();
    // transposed tiles: rows are key positions, columns query positions
    float st[4][4], dpt[4][4];
    mm_abt<D>(sK, sQ, ty, tx, st);
    mm_abt<D>(sV, sdO, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int krow = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qcol = q0 + c;
        const bool masked = qcol >= SQ || (causal && qcol < krow);
        const float p = masked ? 0.f : expf(st[i][j] * scale - sL[c]);
        dpt[i][j] = p * (dpt[i][j] - sDelta[c]) * scale;  // dS^T
        sPS[(ty + 16 * i) * kSP + c] = p;
      }
    }
    __syncthreads();
    mm_ab<D>(sPS, sdO, ty, tx, acc_v);  // dV += P^T dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sPS[(ty + 16 * i) * kSP + tx + 16 * j] = dpt[i][j];
    __syncthreads();
    mm_ab<D>(sPS, sQ, ty, tx, acc_k);  // dK += dS^T Q
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dk, acc_k, one, b, h, H, SK, k0, ty, tx);
  store_rows<T, D>(dv, acc_v, one, b, h, H, SK, k0, ty, tx);
}

// Raise the kernel's dynamic shared-memory cap (above 48 KB it must be
// asked for).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int B, H, SQ, SK;
  Layout lq, lk, lv;
  float scale;
  int causal;
  cudaStream_t stream;
};

enum class Which { kFwd, kDq, kDkv };

template <typename T, int D>
cudaError_t launch(Which which, const Args& a) {
  const dim3 block(kThreads);
  if (which == Which::kFwd) {
    const size_t smem = fwd_smem<D>();
    cudaError_t err = allow_smem(fwd_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.SQ + kTile - 1) / kTile);
    fwd_kernel<T, D><<<grid, block, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.lse_out, a.H,
        a.SQ, a.SK, a.lq, a.lk, a.lv, a.scale, a.causal);
  } else if (which == Which::kDq) {
    const size_t smem = dq_smem<D>();
    cudaError_t err = allow_smem(dq_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.SQ + kTile - 1) / kTile);
    dq_kernel<T, D><<<grid, block, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
        a.delta, (T*)a.dq, a.H, a.SQ, a.SK, a.lq, a.lk, a.lv, a.scale,
        a.causal);
  } else {
    const size_t smem = dkv_smem<D>();
    cudaError_t err = allow_smem(dkv_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.SK + kTile - 1) / kTile);
    dkv_kernel<T, D><<<grid, block, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
        a.delta, (T*)a.dk, (T*)a.dv, a.H, a.SQ, a.SK, a.lq, a.lk, a.lv,
        a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Which which, int d, const Args& a) {
  switch (d) {
    case 16: return launch<T, 16>(which, a);
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, int d, int dtype, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.SQ <= 0 || a.SK <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_d<float>(which, d, a);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(which, d, a);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, int B, int H,
               int SQ, int SK, long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh, float scale,
               int causal, void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B;
  a.H = H;
  a.SQ = SQ;
  a.SK = SK;
  a.lq = {q_sb, q_ss, q_sh};
  a.lk = {k_sb, k_ss, k_sh};
  a.lv = {v_sb, v_ss, v_sh};
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// q/k/v: [B, S, H, D] of dtype (0 float32, 1 bfloat16) with element
// strides (batch, seq, head) and unit stride over D, 16-byte aligned
// rows.  o, dout, dq, dk, dv: contiguous [B, S, H, D] of the same dtype.
// lse, delta: contiguous float32 [B, H, SQ].  Each returns the launch's
// cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int SQ, int SK, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
    int dtype, void* stream) {
  Args a = make_args(q, k, v, B, H, SQ, SK, q_sb, q_ss, q_sh, k_sb, k_ss,
                     k_sh, v_sb, v_ss, v_sh, scale, causal, stream);
  a.o = o;
  a.lse_out = static_cast<float*>(lse);
  return run(Which::kFwd, D, dtype, a);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int SQ,
    int SK, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int causal, int dtype,
    void* stream) {
  Args a = make_args(q, k, v, B, H, SQ, SK, q_sb, q_ss, q_sh, k_sb, k_ss,
                     k_sh, v_sb, v_ss, v_sh, scale, causal, stream);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  return run(Which::kDq, D, dtype, a);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int SQ, int SK, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int causal, int dtype,
    void* stream) {
  Args a = make_args(q, k, v, B, H, SQ, SK, q_sb, q_ss, q_sh, k_sb, k_ss,
                     k_sh, v_sb, v_ss, v_sh, scale, causal, stream);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return run(Which::kDkv, D, dtype, a);
}
