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
// row whose softmax sum is 0 divides by 1.  Key tiles wholly above the
// diagonal are skipped (forward, dQ), and a key tile's backward starts
// at the first query tile that can see it (dK/dV).  No atomics: O and dQ
// are summed over key tiles by their own CTA and dK/dV over query tiles
// by theirs, each in a fixed order, so every kernel is bit-identical
// from run to run.
//
// Bound: operations.  At the training shape [8, 512, 16, 128] causal in
// float32, the forward does 8.6 GFLOP on 134 MB and the backward 30 GFLOP
// on about 370 MB, far above the card's ridge.
//
// One design for all three kernels: every product on the tensor cores
// with mma.sync, accumulated in float32.
//   - float32 inputs: m16n8k8 TF32 with the 3xTF32 split.  Each operand
//     x becomes big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big),
//     and acc += a_small b_big + a_big b_small + a_big b_big (small terms
//     first): float32-level accuracy at three TF32 products per product.
//   - bfloat16 inputs: m16n8k16.  S = Q K^T and dP = dO V^T take the
//     inputs as they are (exact products).  P and dS are float32, so
//     P V, P^T dO, dS K and dS^T Q split them into a bf16 hi + lo pair:
//     two products, lo first.
// Ownership.  Forward and dQ: each warp owns 16 query rows of its CTA
// (dQ: 8 warps, 128 rows; forward: 8 warps in float32, 4 in bf16, where
// two CTAs share an SM so one CTA's loads overlap the other's products).
// The forward computes S for them, keeps the online softmax (running
// max, running sum) in registers and adds P V to its D-wide accumulator;
// dQ computes S and dP in one pass over the head dim (interleaved mma
// chains), then dQ += dS K.  dK/dV: the CTA owns 64 key rows; warps w
// and w + 4 share 16 of them: warp w computes S^T, P^T and dV += P^T dO,
// its partner dP^T, dS^T and dK += dS^T Q, with P^T passed through
// shared memory behind a barrier of the pair, so each warp holds one
// D-wide float32 accumulator (two did not fit 255 registers).  S, dP,
// P and dS live in mma accumulator registers: a row's values sit in one
// quad of lanes, so the forward's row max and sum are a thread's own
// values and two xor-shuffles; lse, delta, the scale and the causal mask
// are applied there, and every exp is exp2f of a log2(e)-scaled argument.
// The next product takes P or dS as its A operand straight from those
// registers: with bf16 the accumulator pairs are the A pairs; with TF32
// the k order inside each 8-wide step is permuted (mma k index t <->
// column 2t, t+4 <-> column 2t+1), which makes the accumulator layout the
// A layout, and the B rows are read in the same order.
// Staging: cp.async (16 bytes, .cg), double-buffered (the forward: a
// ring of three buffers, one barrier fewer a step).  The forward's and dQ's CTAs keep
// their query rows (Q; Q and dO) and stream tiles of K and V (separate
// buffers, behind one wait): 32 keys a step, 64 in the bf16 forward.
// dK/dV's CTA keeps its K and V rows and streams 32-row tiles of Q, dO,
// lse and delta.  Every warp reads the streamed tile as a B operand, so
// a float32 tile is split once when it lands (TF32 big parts in place,
// small parts in a buffer beside it) rather than by each of the 8 warps.
// Rows of 32-bit words are XOR-swizzled in 16-byte chunks (word c of row
// r at c ^ 4(r mod 8)), so the score products' ldmatrix loads, the
// scalar loads of the transposed TF32 B operand and the bf16
// ldmatrix.trans loads are free of bank conflicts for rows of 32 words or
// more.  At D = 128 an SM holds one CTA of 8 warps: in float32 the
// shared memory allows one (192 KB forward, 224 KB dQ, 168.5 KB dK/dV),
// in bf16 (96 KB dQ, 72.5 KB dK/dV) the registers do; the bf16 forward's
// CTAs of 4 warps (112 KB) fit two.  A warp (a pair in dK/dV) whose 16
// rows are all masked for a tile (causal) or past the sequence skips
// that tile's products; the forward masks only on the steps that cross
// the diagonal or the sequence end.  Causal load balance: heavy CTAs
// first (the query tiles near the end for the forward and dQ, the key
// tiles near 0 for dK/dV).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Layout {
  long long sb, ss, sh;  // element strides of the batch, seq, head dims
};

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kDqRows = 16 * kBwdWarps;  // query rows of a dQ CTA
constexpr int kDqKeys = 32;     // keys a dQ step (a multiple of 16)
constexpr int kDkvKeys = 8 * kBwdWarps;  // key rows of a dK/dV CTA
constexpr int kDkvRows = 32;    // query rows a dK/dV step (a multiple of 16)

// 32-bit words per row of a T[D] tile row
template <typename T, int D>
__host__ __device__ constexpr int words() {
  return D * (int)sizeof(T) / 4;
}

// Word c of row r of a tile with W words a row: 16-byte chunks XOR-
// swizzled by the row (c ^ 4(r mod 8), inside each 32-word span).
template <int W>
__host__ __device__ constexpr int swz_mask() {
  return (W < 32 ? W : 32) - 4;
}
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  return r * W + (c ^ ((r << 2) & swz_mask<W>()));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src,
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

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + R) of one head (`head`: its row 0; rows `ss`
// elements apart) -> R swizzled rows of `tile` by cp.async; rows at or
// past n are zero.
template <typename T, int D, int R, int NT = kBwdThreads>
__device__ __forceinline__ void stage(uint32_t* tile, const T* head,
                                      long long ss, int row0, int n) {
  constexpr int W = words<T, D>();
  constexpr int C = W / 4;                  // 16-byte chunks a row
  constexpr int E = 16 / (int)sizeof(T);    // elements a chunk
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C, c = i % C;
    const int row = row0 + r;
    const bool ok = row < n;
    cp_async16(tile + swz<W>(r, 4 * c),
               head + (long long)(ok ? row : 0) * ss + c * E, ok);
  }
}

// row 0 of head (b, h) of x
template <typename T>
__device__ __forceinline__ const T* head_of(const T* x, Layout l, int b,
                                            int h) {
  return x + (long long)b * l.sb + (long long)h * l.sh;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small (+ a rest below float32 resolution), both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// (x0, x1) -> bf16 pairs hi and lo = the rounded rest (low half x0)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a b in 3xTF32: a_small b_big + a_big b_small + a_big b_big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t* ab,
                                           const uint32_t* as,
                                           const uint32_t* bb,
                                           const uint32_t* bs) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint32_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const uint32_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A staged float32 tile of R rows, split in place into its TF32 big
// parts; the small parts go to `small` (the same layout).  Every warp
// reads these tiles as B operands: splitting once here spares each warp
// the conversions.
template <int W, int R, int NT = kBwdThreads>
__device__ __forceinline__ void split_tile(uint32_t* tile, uint32_t* small) {
  for (int i = threadIdx.x; i < R * W / 4; i += NT) {
    const uint4 x = reinterpret_cast<const uint4*>(tile)[i];
    uint4 b, s;
    split_tf32(__uint_as_float(x.x), b.x, s.x);
    split_tf32(__uint_as_float(x.y), b.y, s.y);
    split_tf32(__uint_as_float(x.z), b.z, s.z);
    split_tf32(__uint_as_float(x.w), b.w, s.w);
    reinterpret_cast<uint4*>(tile)[i] = b;
    reinterpret_cast<uint4*>(small)[i] = s;
  }
}

// P score products in one pass over the head dim (S = Q K^T with
// dP = dO V^T, or their transposes): acc[p][n] += A_p[ra .. ra+16) .
// B_p[8n .. 8n+8)^T, A and B rows of tiles of inputs in shared memory;
// for float32 the B tiles are split (big in B, small in Bs).  Fragments
// by ldmatrix (b16 rows of 16 bytes; a 32-bit word lands where the TF32
// and bf16 fragments both want it): A = rows ra + {0, 8} + lane % 8,
// 4-word chunks kw/4 + {0, 1}; B = rows 8n + {0, 8} + lane % 8, the same
// chunks, two n-tiles a load.  Word kw = hi + lo with hi a multiple of
// 32: the swizzle touches lo only.
template <typename T, int D, int N, int P>
__device__ __forceinline__ void mma_scores(float (&acc)[P][N][4],
                                           const uint32_t* const (&sA)[P],
                                           int ra,
                                           const uint32_t* const (&sB)[P],
                                           const uint32_t* const (&sBs)[P],
                                           int g, int t) {
  static_assert(N % 2 == 0, "B loads take two n-tiles");
  constexpr int W = words<T, D>();
  const int lane = t | (g << 2), mi = lane >> 3, rr = lane & 7;
  const int sw = (rr << 2) & swz_mask<W>();
  const int row_a = (ra + 8 * (mi & 1) + rr) * W;
  const int row_b = (8 * (mi >> 1) + rr) * W;
#pragma unroll 1
  for (int hi = 0; hi < W; hi += 32) {
#pragma unroll
    for (int lo = 0; lo < (W < 32 ? W : 32); lo += 8) {
      const int ca = row_a + hi + ((lo + 4 * (mi >> 1)) ^ sw);
      const int cb = row_b + hi + ((lo + 4 * (mi & 1)) ^ sw);
      uint32_t a[P][4], as[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        ldmatrix_x4(a[p], sA[p] + ca);
        if constexpr (std::is_same<T, float>::value) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(__uint_as_float(a[p][i]), a[p][i], as[p][i]);
        }
      }
#pragma unroll
      for (int n = 0; n < N; n += 2) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          uint32_t b[4];  // b0, b1 of n-tile n, then of n + 1
          ldmatrix_x4(b, sB[p] + cb + 8 * n * W);
          if constexpr (std::is_same<T, float>::value) {
            uint32_t bs[4];
            ldmatrix_x4(bs, sBs[p] + cb + 8 * n * W);
            mma_3xtf32(acc[p][n], a[p], as[p], b, bs);
            mma_3xtf32(acc[p][n + 1], a[p], as[p], b + 2, bs + 2);
          } else {
            mma_bf16(acc[p][n], a[p], b);
            mma_bf16(acc[p][n + 1], a[p], b + 2);
          }
        }
      }
    }
  }
}

// acc[nd] += A . B[.., 8nd .. 8nd+8): A (16 rows x 8NA) float32 in
// accumulator layout (a[j] = columns 8j .. 8j+8: P or dS), B the first
// 8NA rows of a tile of inputs in shared memory (dO, K or Q; for
// float32 split, big in B and small in Bs).
template <typename T, int D, int NA>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4],
                                        const float (&a)[NA][4],
                                        const uint32_t* sB,
                                        const uint32_t* sBs, int g, int t) {
  constexpr int W = words<T, D>();
  constexpr int kMask = swz_mask<W>();
  if constexpr (std::is_same<T, float>::value) {
    // B rows 8j + 2t and 8j + 2t + 1 (swizzles sw0, sw1), word 8nd + g
    const int sw0 = (t << 3) & kMask, sw1 = ((t << 3) + 4) & kMask;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      // k t <-> column 2t and k t+4 <-> column 2t+1 of this step, so the
      // accumulator registers are the A fragment: (c0, c2, c1, c3)
      uint32_t ab[4], as[4];
      split_tf32(a[j][0], ab[0], as[0]);
      split_tf32(a[j][2], ab[1], as[1]);
      split_tf32(a[j][1], ab[2], as[2]);
      split_tf32(a[j][3], ab[3], as[3]);
      const int r = (8 * j + 2 * t) * W;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const int hi = 32 * (nd >> 2), lo = 8 * (nd & 3) + g;
        const int j0 = r + hi + (lo ^ sw0), j1 = r + W + hi + (lo ^ sw1);
        const uint32_t bb[2] = {sB[j0], sB[j1]}, bs[2] = {sBs[j0], sBs[j1]};
        mma_3xtf32(acc[nd], ab, as, bb, bs);
      }
    }
  } else {
    const int lane = (t | (g << 2));
    const int m = lane >> 3;  // this lane's ldmatrix row address: matrix m
    const int sw = ((lane & 7) << 2) & kMask;
    const uint32_t* base = sB + (8 * (m & 1) + (lane & 7)) * W;
#pragma unroll
    for (int j = 0; j < NA; j += 2) {
      // k16 step = accumulator tiles j, j + 1 as bf16 pairs, hi and lo
      uint32_t hi[4], lo[4];
      split_bf16(a[j][0], a[j][1], hi[0], lo[0]);
      split_bf16(a[j][2], a[j][3], hi[1], lo[1]);
      split_bf16(a[j + 1][0], a[j + 1][1], hi[2], lo[2]);
      split_bf16(a[j + 1][2], a[j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        // b (k rows 2t, 2t+1 at column g) of n-tiles nd and nd + 1:
        // chunk nd + m/2 of rows 8j + 8(m & 1) + (lane & 7)
        const int c = 32 * (nd >> 3) + ((4 * ((nd & 7) + (m >> 1))) ^ sw);
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, base + 8 * j * W + c);
        mma_bf16(acc[nd], lo, bb);
        mma_bf16(acc[nd], hi, bb);
        mma_bf16(acc[nd + 1], lo, bb + 2);
        mma_bf16(acc[nd + 1], hi, bb + 2);
      }
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// A warp's accumulator (rows row, row + 8; columns 8nd + 2t, +1) -> a
// contiguous [B, n, H, D] tensor, rows past n dropped.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[D / 8][4],
                                          int b, int h, int H, int n, int row,
                                          int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= n) continue;
    T* dst = out + (((long long)b * n + r) * H + h) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      store_pair(dst + 8 * nd, acc[nd][2 * half], acc[nd][2 * half + 1]);
  }
}

// warps of a forward CTA, 16 query rows each.  In float32 the shared
// memory holds one CTA of 8 an SM; in bf16 the registers allow 8 warps an
// SM, as two CTAs of 4, so one CTA's loads overlap the other's products.
template <typename T>
__host__ __device__ constexpr int fwd_warps() {
  return std::is_same<T, float>::value ? 8 : 4;
}
// keys a forward step (a multiple of 16): the bf16 step's tiles are half
// as wide, so twice the keys fit the same shared memory
template <typename T>
__host__ __device__ constexpr int fwd_keys() {
  return std::is_same<T, float>::value ? 32 : 64;
}
// float32 B tiles are split once per step (split_tile): room for the
// small parts of the current K and V (forward, dQ) or Q and dO (dK/dV)
// tiles
template <typename T>
__host__ __device__ constexpr int split_tiles() {
  return std::is_same<T, float>::value ? 2 : 0;
}
template <typename T, int D>
constexpr size_t fwd_smem() {
  return (size_t)(16 * fwd_warps<T>() + (6 + split_tiles<T>()) *
                  fwd_keys<T>()) * words<T, D>() * 4;
}
template <typename T, int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * kDqRows + (4 + split_tiles<T>()) * kDqKeys) *
         words<T, D>() * 4;
}
template <typename T, int D>
constexpr size_t dkv_smem() {
  return (size_t)(2 * kDkvKeys + (4 + split_tiles<T>()) * kDkvRows) *
             words<T, D>() * 4 +
         // lse and delta [2][kDkvRows]; P^T [pair][kDkvRows / 8][4][32]
         (4 * kDkvRows + kBwdWarps / 2 * kDkvRows / 2 * 32) * sizeof(float);
}

// Each warp owns 16 query rows: S = Q K^T for a step of keys, the online
// softmax in the accumulator registers (running max m in the log2
// domain; each thread sums its own columns of a row, and the quad's sums
// are added once at the end), then O += P V.
template <typename T, int D>
__global__ void __launch_bounds__(32 * fwd_warps<T>(), 8 / fwd_warps<T>())
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int H, int SQ, int SK, Layout lq,
               Layout lk, Layout lv, float scale, int causal) {
  constexpr int W = words<T, D>();
  constexpr int NT = 32 * fwd_warps<T>();   // threads
  constexpr int R = 16 * fwd_warps<T>();    // query rows
  constexpr int KN = fwd_keys<T>();
  constexpr int N = KN / 8;                 // n-tiles of a key step
  extern __shared__ __align__(16) uint32_t smem_w[];
  uint32_t* sQ = smem_w;                    // [R][W]
  uint32_t* sK = sQ + R * W;                // [3][KN][W]
  uint32_t* sV = sK + 3 * KN * W;           // [3][KN][W]
  uint32_t* sKs = sV + 3 * KN * W;          // [KN][W] small parts,
  uint32_t* sVs = sKs + KN * W;             // float32 only
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nq = (SQ + R - 1) / R;
  const int q0 = (nq - 1 - (int)blockIdx.y) * R;  // heavy tiles first
  const T* kh = head_of(k, lk, b, h);
  const T* vh = head_of(v, lv, b, h);

  int nk = (SK + KN - 1) / KN;
  if (causal) {  // keys past the tile's last row are masked everywhere
    const int last = min(q0 + R, SQ) - 1;
    nk = min(nk, last / KN + 1);
  }
  stage<T, D, R, NT>(sQ, head_of(q, lq, b, h), lq.ss, q0, SQ);
  stage<T, D, KN, NT>(sK, kh, lk.ss, 0, SK);
  stage<T, D, KN, NT>(sV, vh, lv.ss, 0, SK);
  cp_async_commit();
  // K/V tiles in a ring of three buffers: tile j + 2 loads while tile j
  // computes, so the barrier after a tile lands also guards the reuse of
  // the buffer step j - 1 read (no barrier at the end of a step)
  if (nk > 1) {
    stage<T, D, KN, NT>(sK + KN * W, kh, lk.ss, KN, SK);
    stage<T, D, KN, NT>(sV + KN * W, vh, lv.ss, KN, SK);
  }
  cp_async_commit();

  const int r0 = 16 * warp;  // this warp's rows of the tile
  const int row = q0 + r0 + g;
  const float scale_log2 = scale * kLog2e;
  // rows row and row + 8: the running max of the log2-scaled scores, and
  // this thread's part of the running sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * KN;
    const int buf = j % 3;
    cp_async_wait<1>();  // tile j has landed (tile j + 1 may be in flight)
    __syncthreads();     // and every warp is done with step j - 1, whose
    if (j + 2 < nk) {    // buffer now takes tile j + 2
      const int nb = (j + 2) % 3;
      stage<T, D, KN, NT>(sK + nb * KN * W, kh, lk.ss, k0 + 2 * KN, SK);
      stage<T, D, KN, NT>(sV + nb * KN * W, vh, lv.ss, k0 + 2 * KN, SK);
    }
    cp_async_commit();
    uint32_t* cK = sK + buf * KN * W;
    uint32_t* cV = sV + buf * KN * W;
    if constexpr (split_tiles<T>() > 0) {
      split_tile<W, KN, NT>(cK, sKs);
      split_tile<W, KN, NT>(cV, sVs);
      __syncthreads();
    }
    // warp-uniform: rows past the sequence, or every key of the step
    // above this warp's diagonal
    if (q0 + r0 < SQ && !(causal && k0 > q0 + r0 + 15)) {
      float s[1][N][4];  // S, then P
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[0][n][c] = 0.f;
      const uint32_t* const sA[1] = {sQ};
      const uint32_t* const sB[1] = {cK};
      const uint32_t* const sBs[1] = {sKs};
      mma_scores<T, D, N, 1>(s, sA, r0, sB, sBs, g, t);
      // warp-uniform: the step crosses the sequence end or the diagonal
      const bool edge = k0 + KN > SK || (causal && k0 + KN - 1 > q0 + r0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[0][n][c] * scale_log2;
          if (edge) {
            const int col = k0 + 8 * n + 2 * t + (c & 1);
            if (col >= SK || (causal && col > row + 8 * (c >> 1)))
              x = kNegInf;
          }
          s[0][n][c] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // a row's values: the quad's lanes
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = exp2f(s[0][n][c] - m[c >> 1]);
          l[c >> 1] += p;
          s[0][n][c] = p;
        }
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nd][c] *= alpha[c >> 1];
      mma_acc<T, D, N>(acc, s[0], cV, sVs, g, t);  // O += P V
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / l_safe;
    const int r = row + 8 * i;
    if (t == 0 && r < SQ)  // natural log: m * ln(2) + ln(l)
      lse[((long long)b * H + h) * SQ + r] = m[i] * kLn2 + logf(l_safe);
  }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] *= inv[c >> 1];
  store_acc<T, D>(o, acc, b, h, H, SQ, row, t);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int SQ, int SK, Layout lq, Layout lk,
              Layout lv, float scale, int causal) {
  constexpr int W = words<T, D>();
  extern __shared__ __align__(16) uint32_t smem_w[];
  uint32_t* sQ = smem_w;                    // [kDqRows][W]
  uint32_t* sdO = sQ + kDqRows * W;         // [kDqRows][W]
  uint32_t* sK = sdO + kDqRows * W;         // [2][kDqKeys][W]
  uint32_t* sV = sK + 2 * kDqKeys * W;      // [2][kDqKeys][W]
  uint32_t* sKs = sV + 2 * kDqKeys * W;     // [kDqKeys][W] small parts,
  uint32_t* sVs = sKs + kDqKeys * W;        // float32 only
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nq = (SQ + kDqRows - 1) / kDqRows;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kDqRows;  // heavy tiles first
  const long long vec = ((long long)b * H + h) * SQ;
  const T* kh = head_of(k, lk, b, h);
  const T* vh = head_of(v, lv, b, h);

  int nk = (SK + kDqKeys - 1) / kDqKeys;
  if (causal) {  // keys past the tile's last row are masked everywhere
    const int last = min(q0 + kDqRows, SQ) - 1;
    nk = min(nk, last / kDqKeys + 1);
  }
  stage<T, D, kDqRows>(sQ, head_of(q, lq, b, h), lq.ss, q0, SQ);
  stage<T, D, kDqRows>(sdO, dout + ((long long)b * SQ * H + h) * D,
                       (long long)H * D, q0, SQ);
  stage<T, D, kDqKeys>(sK, kh, lk.ss, 0, SK);
  stage<T, D, kDqKeys>(sV, vh, lv.ss, 0, SK);
  cp_async_commit();

  const int r0 = 16 * warp;  // this warp's rows of the tile
  const int row = q0 + r0 + g;
  // exp(s * scale - lse) = exp2(s * scale * log2(e) - lse * log2(e))
  const float scale_log2 = scale * kLog2e;
  const float lse0 = row < SQ ? lse[vec + row] * kLog2e : 0.f;
  const float lse1 = row + 8 < SQ ? lse[vec + row + 8] * kLog2e : 0.f;
  const float del0 = row < SQ ? delta[vec + row] : 0.f;
  const float del1 = row + 8 < SQ ? delta[vec + row + 8] : 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kDqKeys;
    const int buf = j & 1;
    if (j + 1 < nk) {  // the next K/V tile loads while this one computes
      stage<T, D, kDqKeys>(sK + (buf ^ 1) * kDqKeys * W, kh, lk.ss,
                           k0 + kDqKeys, SK);
      stage<T, D, kDqKeys>(sV + (buf ^ 1) * kDqKeys * W, vh, lv.ss,
                           k0 + kDqKeys, SK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    uint32_t* cK = sK + buf * kDqKeys * W;
    uint32_t* cV = sV + buf * kDqKeys * W;
    if constexpr (split_tiles<T>() > 0) {
      split_tile<W, kDqKeys>(cK, sKs);
      split_tile<W, kDqKeys>(cV, sVs);
      __syncthreads();
    }
    // warp-uniform: rows past the sequence, or every key of the step
    // above this warp's diagonal
    if (q0 + r0 < SQ && !(causal && k0 > q0 + r0 + 15)) {
      constexpr int N = kDqKeys / 8;
      float sd[2][N][4];  // S (then dS) and dP
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) sd[0][n][c] = sd[1][n][c] = 0.f;
      const uint32_t* const sA[2] = {sQ, sdO};
      const uint32_t* const sB[2] = {cK, cV};
      const uint32_t* const sBs[2] = {sKs, sVs};
      mma_scores<T, D, N, 2>(sd, sA, r0, sB, sBs, g, t);  // S, dP
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qrow = row + 8 * (c >> 1);
          const int col = k0 + 8 * n + 2 * t + (c & 1);
          const bool masked = col >= SK || (causal && col > qrow);
          const float p = masked ? 0.f
                                 : exp2f(fmaf(sd[0][n][c], scale_log2,
                                              c < 2 ? -lse0 : -lse1));
          sd[0][n][c] = p * (sd[1][n][c] - (c < 2 ? del0 : del1)) * scale;
        }
      mma_acc<T, D, N>(acc, sd[0], cK, sKs, g, t);  // dQ += dS K
    }
    __syncthreads();  // done with this buffer before it is refilled
  }
  store_acc<T, D>(dq, acc, b, h, H, SQ, row, t);
}

// Warps w and w + 4 share key rows 16 (w mod 4) .. +16: warp w computes
// S^T, P^T and dV += P^T dO, its partner dP^T, dS^T = P^T (dP^T - delta)
// and dK += dS^T Q, with P^T passed through shared memory behind a
// barrier of the pair.  Each warp so holds one D-wide accumulator.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int SQ, int SK,
               Layout lq, Layout lk, Layout lv, float scale, int causal) {
  constexpr int W = words<T, D>();
  constexpr int N = kDkvRows / 8;            // n-tiles of a query step
  extern __shared__ __align__(16) uint32_t smem_w[];
  uint32_t* sK = smem_w;                     // [kDkvKeys][W]
  uint32_t* sV = sK + kDkvKeys * W;          // [kDkvKeys][W]
  uint32_t* sQ = sV + kDkvKeys * W;          // [2][kDkvRows][W]
  uint32_t* sdO = sQ + 2 * kDkvRows * W;     // [2][kDkvRows][W]
  uint32_t* sQs = sdO + 2 * kDkvRows * W;    // [kDkvRows][W] small parts,
  uint32_t* sdOs = sQs + kDkvRows * W;       // float32 only
  float* sL = reinterpret_cast<float*>(
      sdO + (2 + split_tiles<T>()) * kDkvRows * W);  // [2][kDkvRows]
  float* sDelta = sL + 2 * kDkvRows;                  // [2][kDkvRows]
  float* sP = sDelta + 2 * kDkvRows;  // [pair][N][4][32 lanes]: P^T
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp % (kBwdWarps / 2);
  const bool dk_warp = warp >= kBwdWarps / 2;  // dP^T, dS^T, dK
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kDkvKeys;  // key tile 0 (heaviest) first
  // what the loop stages: this head's rows of Q, dO (rows H*D apart), and
  // of lse or delta (thread x < 2 kDkvRows copies row x mod kDkvRows)
  const T* qh = head_of(q, lq, b, h);
  const T* doh = dout + ((long long)b * SQ * H + h) * D;
  const int x = threadIdx.x;
  const float* vec = (x < kDkvRows ? lse : delta) + ((long long)b * H + h) * SQ;
  float* svec = (x < kDkvRows ? sL : sDelta) + x % kDkvRows;

  // query rows [i * kDkvRows, +kDkvRows) of Q, dO, lse, delta -> buffer
  auto stage_q = [&](int i, int buf) {
    const int row0 = i * kDkvRows;
    stage<T, D, kDkvRows>(sQ + buf * kDkvRows * W, qh, lq.ss, row0, SQ);
    stage<T, D, kDkvRows>(sdO + buf * kDkvRows * W, doh, (long long)H * D,
                          row0, SQ);
    if (x < 2 * kDkvRows) {
      const int row = row0 + x % kDkvRows;
      cp_async4(svec + buf * kDkvRows, vec + (row < SQ ? row : 0), row < SQ);
    }
  };

  stage<T, D, kDkvKeys>(sK, head_of(k, lk, b, h), lk.ss, k0, SK);
  stage<T, D, kDkvKeys>(sV, head_of(v, lv, b, h), lv.ss, k0, SK);
  const int nq = (SQ + kDkvRows - 1) / kDkvRows;
  // causal: query rows before this key tile never see it
  const int i0 = causal ? k0 / kDkvRows : 0;
  if (i0 < nq) stage_q(i0, 0);
  cp_async_commit();

  const int r0 = 16 * pair;  // the pair's key rows of the tile
  const int krow = k0 + r0 + g;
  const float scale_log2 = scale * kLog2e;
  float* my_p = sP + pair * N * 4 * 32 + lane;
  float acc[D / 8][4];  // dV or dK
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

  for (int i = i0; i < nq; ++i) {
    const int q0 = i * kDkvRows;
    const int buf = (i - i0) & 1;
    if (i + 1 < nq) stage_q(i + 1, buf ^ 1);  // loads while this computes
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    uint32_t* cQ = sQ + buf * kDkvRows * W;
    uint32_t* cdO = sdO + buf * kDkvRows * W;
    if constexpr (split_tiles<T>() > 0) {
      split_tile<W, kDkvRows>(cQ, sQs);
      split_tile<W, kDkvRows>(cdO, sdOs);
      __syncthreads();
    }
    // pair-uniform: key rows past the sequence, or every query row of
    // the step before the pair's first key
    if (k0 + r0 < SK && !(causal && q0 + kDkvRows - 1 < k0 + r0)) {
      // transposed tiles: rows are key positions, columns query positions
      float s[1][N][4];  // S^T then P^T, or dP^T then dS^T
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[0][n][c] = 0.f;
      const uint32_t* const sA[1] = {dk_warp ? sV : sK};
      const uint32_t* const sB[1] = {dk_warp ? cdO : cQ};
      const uint32_t* const sBs[1] = {dk_warp ? sdOs : sQs};
      mma_scores<T, D, N, 1>(s, sA, r0, sB, sBs, g, t);
      if (!dk_warp) {
        const float* cL = sL + buf * kDkvRows;
#pragma unroll
        for (int n = 0; n < N; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int kr = krow + 8 * (c >> 1);
            const int col = 8 * n + 2 * t + (c & 1);
            const int qcol = q0 + col;
            const bool masked = qcol >= SQ || (causal && qcol < kr);
            s[0][n][c] = masked ? 0.f
                                : exp2f(fmaf(s[0][n][c], scale_log2,
                                             -cL[col] * kLog2e));  // P^T
            my_p[(4 * n + c) * 32] = s[0][n][c];
          }
      }
      // barrier 1 + pair of the pair's 64 threads: the P warp arrives
      // once its P^T is written and goes on; its partner waits for it
      if (!dk_warp) {
        asm volatile("bar.arrive %0, %1;" ::"r"(1 + pair), "n"(64)
                     : "memory");
      } else {
        asm volatile("bar.sync %0, %1;" ::"r"(1 + pair), "n"(64)
                     : "memory");
        const float* cDelta = sDelta + buf * kDkvRows;
#pragma unroll
        for (int n = 0; n < N; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = 8 * n + 2 * t + (c & 1);
            s[0][n][c] = my_p[(4 * n + c) * 32] *
                         (s[0][n][c] - cDelta[col]) * scale;  // dS^T
          }
      }
      // dV += P^T dO, or dK += dS^T Q
      mma_acc<T, D, N>(acc, s[0], dk_warp ? cQ : cdO, dk_warp ? sQs : sdOs,
                       g, t);
    }
    __syncthreads();  // done with this buffer (and sP) before refilling
  }
  cp_async_wait<0>();  // nothing in flight at exit (no query step ran)
  store_acc<T, D>(dk_warp ? dk : dv, acc, b, h, H, SK, krow, t);
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
  if (which == Which::kFwd) {
    const size_t smem = fwd_smem<T, D>();
    cudaError_t err = allow_smem(fwd_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    // all of L1 as shared memory, so two bf16 CTAs fit an SM
    err = cudaFuncSetAttribute(fwd_kernel<T, D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    constexpr int warps = fwd_warps<T>(), rows = 16 * warps;
    const dim3 grid(a.B * a.H, (a.SQ + rows - 1) / rows);
    fwd_kernel<T, D><<<grid, 32 * warps, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.lse_out, a.H,
        a.SQ, a.SK, a.lq, a.lk, a.lv, a.scale, a.causal);
  } else if (which == Which::kDq) {
    const size_t smem = dq_smem<T, D>();
    cudaError_t err = allow_smem(dq_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.SQ + kDqRows - 1) / kDqRows);
    dq_kernel<T, D><<<grid, kBwdThreads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
        a.delta, (T*)a.dq, a.H, a.SQ, a.SK, a.lq, a.lk, a.lv, a.scale,
        a.causal);
  } else {
    const size_t smem = dkv_smem<T, D>();
    cudaError_t err = allow_smem(dkv_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.SK + kDkvKeys - 1) / kDkvKeys);
    dkv_kernel<T, D><<<grid, kBwdThreads, smem, a.stream>>>(
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
