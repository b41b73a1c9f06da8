// FlashAttention-2 forward and backward for Hopper (sm_90a): causal plus an
// optional sliding window, GQA read natively, bf16 or fp32 in and out.
//
// Replaces, for the forward, the Pallas TPU kernel
// src/repro/kernels/flash_attn/kernel.py:69 flash_mha (body _flash_kernel)
// and the reference's own forward src/repro/models/transformer/attention.py:94
// _flash_fwd; for the backward, the reference's hand-written
// attention.py:143 _flash_bwd (pass 1, dq; pass 2, dk and dv):
//
//   forward   s = (q . k) * dh^-0.5, masked to -1e30 where jk > iq or
//             iq - jk >= window; online softmax with fp32 m, l, acc; p is
//             rounded to v's type before P.V; o = acc / max(l, 1e-20) in
//             the input type, lse = m + log(max(l, 1e-20)) in fp32.
//   dq        delta = rowsum(do * o) (fp32, written out for the dk/dv pass);
//             p = exp(s - lse); dp = do . v; ds = p * (dp - delta) * scale;
//             dq = sum ds . k.
//   dk, dv    dv = sum p^T . do, dk = sum ds^T . q, summed over the rep
//             query heads of the KV head in a fixed order (no atomics: two
//             calls give the same bits).
//
// The reference's products take bf16 (or fp32) inputs into fp32 sums; its
// forward rounds p to v's type, its backward keeps p, dp and ds in fp32.
// Layouts are the reference's: q, o, do, dq (B, S, H, dh); k, v, dk, dv
// (B, S, KV, dh), query head h reading KV head h / (H / KV) with no repeat
// copy; lse and delta (B, H, S) fp32.
//
// Two families of kernels; FLASH_DISPATCH picks one by (type, dh) at compile
// time, never at run time, and no kernel falls back to another:
//
// 1. Tensor-core kernels: bf16 at dh 64 and 128 (dh 128 is the training
//    path), all three passes.  What bounds them on an H100: operations.  At
//    the training shape (S = 4096, H = 24, KV = 2, dh = 128, window 4096)
//    one product over the 201 M valid (q, k) pairs is 51.55 GFLOP, against
//    0.02 ms of bytes.  Common machinery: 64-row tiles (wgmma's M) in
//    shared memory in wgmma's 128-byte swizzle, copied by 16-byte cp.async;
//    the other sequence axis streams through a ring of two stages, the next
//    tile's copy in flight while the current one computes; products with
//    both operands in shared memory, or with the fp32 accumulator of one
//    product, whose layout is a register A operand's, feeding the next.
//
//    Forward (flash_fwd_kernel_wgmma).  The reference's s takes bf16 q and
//    k into fp32 (a product of two bf16 values is exact in fp32) and its
//    P.V takes p rounded to bf16, so both products are single bf16 wgmmas
//    with fp32 accumulators: only the order of the sums differs.  2
//    products, 103 GFLOP at the training shape, 0.104 ms at 989 TFLOP/s.
//    A block owns one 64-row query tile and a head group of HB query heads
//    of one KV head (HB = 2 where H / KV is even, else 1), one warpgroup
//    per head; every K and V tile in the ring serves all HB warpgroups,
//    which halves the tile copies from L2.  At the training shape a head
//    group walks 2,080 (query tile, key tile) steps of 32 KB of K and V, so
//    12 head groups copy 0.82 GB a launch, not 24 heads' 1.64 GB (counted
//    from the tile walk, not measured; the unique K and V are 4 MB).  The online softmax
//    stays in the s accumulator's registers, in base 2 (scale * log2 e and
//    the running max folded into one FMA); l sums the fp32 p, and p,
//    rounded once to bf16, is the register A operand of P.V.  Tiles with
//    every pair valid skip the mask.  The grid runs query tiles slowest,
//    so the heaviest tiles of every head group are issued first.
//
//    Backward.  p and ds are fp32 operands, and rounding them once to bf16
//    misses the reference's accuracy (2.3-2.7x the card's gate at S = 2048,
//    tests/test_torch_flash_attn.py).  So each is split, hi = bf16(x) and
//    lo = bf16(x - hi), which carries 16 of x's 24 bits (the rest is below
//    2^-17 |x|), and its product runs as two bf16 wgmmas accumulating in
//    fp32: dq does 4 products (s, dp, hi(ds) . k, lo(ds) . k), 206 GFLOP,
//    0.208 ms at 989 TFLOP/s; dk/dv does 6 (s, dp and the split p^T . do
//    and ds^T . q), 309 GFLOP, 0.313 ms.  A block is one warpgroup.
//    dq: a block owns a 64-row query tile of one query head and walks the
//    key tiles from the window's first to the diagonal.  dk/dv: a block
//    owns a 64-row key tile of one KV head and a group of rep / G of its
//    query heads, and streams their (q, do, lse, delta) tiles; each group
//    writes fp32 partials (B, S, KV, G, dh) to a scratch that the wrapper
//    allocates, and flash_bwd_dkv_reduce_kernel sums them in the order
//    g = 0..G-1 and rounds to bf16.  A single dk/dv block per key tile would
//    walk 12 heads x 64 query tiles at the training shape, twice an SM's
//    share; flash_bwd_dkv_plan chooses G so the longest block fits that
//    share and sizes the scratch.
//
// 2. CUDA-core kernels: fp32 at every dh (8, 16, 64, 128) and bf16 at dh 8
//    and 16.  Every product is an fp32 FMA.  fp32 stays here because its
//    products must be full fp32: the tensor cores take fp32 only as TF32
//    (10 mantissa bits).  bf16 at dh 8 and 16 (the reduced configs) is half
//    of or one wgmma k-step, too narrow for the tensor-core machinery to
//    pay.  One block of 256 threads per (64-row query tile, query head) for
//    the forward and dq passes, and per (32-row key tile, KV head) for
//    dk/dv, walking the rep query heads inside the block; the loop over the
//    other sequence axis runs inside the block (the TPU grid's sequential
//    axis).  Tiles sit in shared memory as fp32 with a padded row stride
//    (dh + 1: threads that read 16 different rows at one column hit 16
//    different banks); each thread keeps a 4 x 4 (2 x 4 for dk/dv) block of
//    scores and a 4 x max(dh / 16, 1) block of accumulators in registers,
//    so each shared-memory load feeds two to four FMAs.  Row maxima and sums
//    reduce over the 16 lanes of a half-warp with shuffles.  Lane tx of a
//    half-warp owns head columns tx + 16 j; at dh 8 lanes 0..7 own one each
//    and lanes 8..15 compute a copy of lane tx - 8's and write nothing.
//
// Every kernel skips tiles that hold no valid (q, k) pair; that is exact: a
// tile before a row's window only adds terms that corr = exp(-1e30 - m) = 0
// wipes when the row's first valid tile arrives, and a tile past the
// diagonal adds p = exp(-1e30 - m) = 0.  The heaviest tiles are issued
// first (the last query tile of a causal row has the most key tiles; key
// tile 0 the most query tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>
#include <utility>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16 (columns), ty = tid / 16 (rows)
constexpr int kTileQ = 64;     // query rows per tile
constexpr int kTileK = 64;     // key rows per tile of the forward and dq passes
constexpr int kTileKV = 32;    // key rows per block of the dk/dv pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's astype
}

// Sum and max over the 16 lanes that share a tile row (one half-warp).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ bool valid(int iq, int jk, int window) {
  return jk <= iq && (window <= 0 || iq - jk < window);
}

// Head columns of the CUDA-core kernels: lane tx of a half-warp owns columns
// tx + 16 dd, dd < kRD.  At dh 8 lanes 0..7 own one each; lanes 8..15 read
// column tx - 8 (a copy of lane tx - 8's work) and write nothing.
template <int DH>
constexpr int kRD = DH < 16 ? 1 : DH / 16;
template <int DH>
__device__ __forceinline__ int hcol(int tx, int dd) {
  return DH < 16 ? tx % DH : tx + 16 * dd;
}
template <int DH>
__device__ __forceinline__ bool owns(int tx) {
  return DH >= 16 || tx < DH;
}

// rows [s0, s0 + R) of one head (row s at src + s * stride) into dst as fp32
// with row stride DH + 1; rows at or past S read as 0.
template <typename T, int R, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int s0, int S,
                                          long long stride) {
  for (int i = threadIdx.x; i < R * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int s = s0 + r;
    dst[r * (DH + 1) + d] = s < S ? to_f(src[(long long)s * stride + d]) : 0.f;
  }
}

template <int DH>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((kTileQ + 2 * kTileK) * (DH + 1) + kTileQ * (kTileK + 1));
}
template <int DH>
constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * kTileQ + 2 * kTileK) * (DH + 1) + kTileQ * (kTileK + 1));
}
template <int DH>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         ((2 * kTileKV + 2 * kTileQ) * (DH + 1) + 2 * kTileKV * (kTileQ + 1) + 2 * kTileQ);
}

// -------------------------------------------------- forward (CUDA cores) ----
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int H, int KV, int window,
                 float scale) {
  constexpr int LD = DH + 1, LP = kTileK + 1;
  constexpr int RM = kTileQ / 16, RN = kTileK / 16, RD = kRD<DH>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTileQ * LD;
  float* sV = sK + kTileK * LD;
  float* sP = sV + kTileK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_qt = (S + kTileQ - 1) / kTileQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kTileQ;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / KV);
  const long long qs = (long long)H * DH, ks = (long long)KV * DH;
  const T* qb = q + (long long)b * S * qs + (long long)h * DH;
  const T* kb = k + (long long)b * S * ks + (long long)g * DH;
  const T* vb = v + (long long)b * S * ks + (long long)g * DH;

  load_tile<T, kTileQ, DH>(sQ, qb, q0, S, qs);
  float m[RM], l[RM], acc[RM][RD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) acc[i][dd] = 0.f;
  }
  const int row_hi = min(q0 + kTileQ, S) - 1;
  const int col_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = col_lo / kTileK; t <= row_hi / kTileK; ++t) {
    const int k0 = t * kTileK;
    __syncthreads();  // the last tile's readers of sK, sV and sP are done
    load_tile<T, kTileK, DH>(sK, kb, k0, S, ks);
    load_tile<T, kTileK, DH>(sV, vb, k0, S, ks);
    __syncthreads();
    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[RM], c[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < RN; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int iq = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] = valid(iq, k0 + tx + 16 * j, window) ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty + 16 * i) * LP + tx + 16 * j] = to_f(from_f<T>(p));  // p.astype(v.dtype)
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) acc[i][dd] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTileK; ++c) {
      float p[RM], vv[RD];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = sP[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) vv[dd] = sV[c * LD + hcol<DH>(tx, dd)];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int dd = 0; dd < RD; ++dd) acc[i][dd] = fmaf(p[i], vv[dd], acc[i][dd]);
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int iq = q0 + ty + 16 * i;
    if (iq >= S) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* orow = o + ((long long)b * S + iq) * qs + (long long)h * DH;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd)
      if (owns<DH>(tx)) orow[tx + 16 * dd] = from_f<T>(acc[i][dd] / den);
    if (tx == 0) lse[((long long)b * H + h) * S + iq] = m[i] + logf(den);
  }
}

// ----------------------------------------------------- backward: dq pass ----
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int KV, int window, float scale) {
  constexpr int LD = DH + 1, LP = kTileK + 1;
  constexpr int RM = kTileQ / 16, RN = kTileK / 16, RD = kRD<DH>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTileQ * LD;
  float* sK = sdO + kTileQ * LD;
  float* sV = sK + kTileK * LD;
  float* sS = sV + kTileK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_qt = (S + kTileQ - 1) / kTileQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kTileQ;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / KV);
  const long long qs = (long long)H * DH, ks = (long long)KV * DH;
  const long long qoff = (long long)b * S * qs + (long long)h * DH;
  const T* kb = k + (long long)b * S * ks + (long long)g * DH;
  const T* vb = v + (long long)b * S * ks + (long long)g * DH;
  const long long roff = ((long long)b * H + h) * S;  // lse / delta row of this head

  load_tile<T, kTileQ, DH>(sQ, q + qoff, q0, S, qs);
  load_tile<T, kTileQ, DH>(sdO, dout + qoff, q0, S, qs);
  __syncthreads();
  float lse_r[RM], dlt[RM], acc[RM][RD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i, iq = q0 + r;
    float part = 0.f;
    if (iq < S && owns<DH>(tx)) {
      const T* orow = o + qoff + (long long)iq * qs;
#pragma unroll
      for (int dd = 0; dd < RD; ++dd)
        part = fmaf(sdO[r * LD + tx + 16 * dd], to_f(orow[tx + 16 * dd]), part);
    }
    dlt[i] = row_sum(part);
    lse_r[i] = iq < S ? lse[roff + iq] : 0.f;
    if (tx == 0 && iq < S) delta[roff + iq] = dlt[i];
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) acc[i][dd] = 0.f;
  }
  const int row_hi = min(q0 + kTileQ, S) - 1;
  const int col_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = col_lo / kTileK; t <= row_hi / kTileK; ++t) {
    const int k0 = t * kTileK;
    __syncthreads();
    load_tile<T, kTileK, DH>(sK, kb, k0, S, ks);
    load_tile<T, kTileK, DH>(sV, vb, k0, S, ks);
    __syncthreads();
    float s[RM][RN], dp[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; ++d) {
      float a[RM], e[RM], c[RN], w[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = sQ[(ty + 16 * i) * LD + d];
        e[i] = sdO[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        c[j] = sK[(tx + 16 * j) * LD + d];
        w[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(e[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int iq = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float sv = valid(iq, k0 + tx + 16 * j, window) ? s[i][j] * scale : kNeg;
        const float p = expf(sv - lse_r[i]);
        sS[(ty + 16 * i) * LP + tx + 16 * j] = p * (dp[i][j] - dlt[i]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTileK; ++c) {
      float ds[RM], kk[RD];
#pragma unroll
      for (int i = 0; i < RM; ++i) ds[i] = sS[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) kk[dd] = sK[c * LD + hcol<DH>(tx, dd)];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int dd = 0; dd < RD; ++dd) acc[i][dd] = fmaf(ds[i], kk[dd], acc[i][dd]);
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int iq = q0 + ty + 16 * i;
    if (iq >= S) continue;
    T* row = dq + qoff + (long long)iq * qs;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd)
      if (owns<DH>(tx)) row[tx + 16 * dd] = from_f<T>(acc[i][dd]);
  }
}

// -------------------------------------------------- backward: dk/dv pass ----
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int H, int KV, int window, float scale) {
  constexpr int LD = DH + 1, LP = kTileQ + 1;
  constexpr int RM = kTileKV / 16, RN = kTileQ / 16, RD = kRD<DH>;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTileKV * LD;
  float* sQ = sV + kTileKV * LD;
  float* sdO = sQ + kTileQ * LD;
  float* sP = sdO + kTileQ * LD;   // (key row, query row)
  float* sdS = sP + kTileKV * LP;  // (key row, query row)
  float* sL = sdS + kTileKV * LP;
  float* sD = sL + kTileQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kTileKV;  // key tile 0 has the most query tiles: issued first
  const int g = blockIdx.y, b = blockIdx.z, rep = H / KV;
  const long long qs = (long long)H * DH, ks = (long long)KV * DH;
  const long long koff = (long long)b * S * ks + (long long)g * DH;

  load_tile<T, kTileKV, DH>(sK, k + koff, k0, S, ks);
  load_tile<T, kTileKV, DH>(sV, v + koff, k0, S, ks);
  float acc_k[RM][RD], acc_v[RM][RD];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) acc_k[i][dd] = acc_v[i][dd] = 0.f;
  // query rows with a valid pair in this key tile: k0 <= iq <= k0 + kTileKV - 2 + window
  const int row_hi = window > 0 ? min(S - 1, k0 + kTileKV - 2 + window) : S - 1;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const long long qoff = (long long)b * S * qs + (long long)h * DH;
    const long long roff = ((long long)b * H + h) * S;
    for (int t = k0 / kTileQ; t <= row_hi / kTileQ; ++t) {
      const int q0 = t * kTileQ;
      __syncthreads();
      load_tile<T, kTileQ, DH>(sQ, q + qoff, q0, S, qs);
      load_tile<T, kTileQ, DH>(sdO, dout + qoff, q0, S, qs);
      if (tid < kTileQ) {
        const int iq = q0 + tid;
        sL[tid] = iq < S ? lse[roff + iq] : 0.f;
        sD[tid] = iq < S ? delta[roff + iq] : 0.f;
      }
      __syncthreads();
      float s[RM][RN], dp[RM][RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DH; ++d) {
        float c[RM], w[RM], a[RN], e[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          c[i] = sK[(ty + 16 * i) * LD + d];
          w[i] = sV[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          a[j] = sQ[(tx + 16 * j) * LD + d];
          e[j] = sdO[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            s[i][j] = fmaf(a[j], c[i], s[i][j]);
            dp[i][j] = fmaf(e[j], w[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int jk = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int rq = tx + 16 * j, iq = q0 + rq;
          // query rows past S are padding: they must add nothing
          const bool ok = iq < S && valid(iq, jk, window);
          const float p = expf((ok ? s[i][j] * scale : kNeg) - sL[rq]);
          sP[(ty + 16 * i) * LP + rq] = p;
          sdS[(ty + 16 * i) * LP + rq] = p * (dp[i][j] - sD[rq]) * scale;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int rq = 0; rq < kTileQ; ++rq) {
        float p[RM], ds[RM], e[RD], a[RD];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          p[i] = sP[(ty + 16 * i) * LP + rq];
          ds[i] = sdS[(ty + 16 * i) * LP + rq];
        }
#pragma unroll
        for (int dd = 0; dd < RD; ++dd) {
          e[dd] = sdO[rq * LD + hcol<DH>(tx, dd)];
          a[dd] = sQ[rq * LD + hcol<DH>(tx, dd)];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int dd = 0; dd < RD; ++dd) {
            acc_v[i][dd] = fmaf(p[i], e[dd], acc_v[i][dd]);
            acc_k[i][dd] = fmaf(ds[i], a[dd], acc_k[i][dd]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int jk = k0 + ty + 16 * i;
    if (jk >= S) continue;
    const long long off = koff + (long long)jk * ks;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) {
      if (!owns<DH>(tx)) continue;
      dk[off + tx + 16 * dd] = from_f<T>(acc_k[i][dd]);
      dv[off + tx + 16 * dd] = from_f<T>(acc_v[i][dd]);
    }
  }
}

// -------------------------------------------- tensor-core kernels (bf16) ----
using bf16 = __nv_bfloat16;
constexpr int kWG = 128;   // one warpgroup a block
constexpr int kTile = 64;  // rows of every tile (wgmma's M)

template <typename T, int DH>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value && (DH == 64 || DH == 128);

// The last query row with a valid pair in the dk/dv key tile that starts at
// k0: k0 <= iq <= k0 + kTile - 2 + window.
__host__ __device__ inline int dkv_row_hi(int k0, int S, int window) {
  const int hi = k0 + kTile - 2 + window;
  return window > 0 && hi < S - 1 ? hi : S - 1;
}

template <int DH>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return kTile * DH * 2;
}

// The tensor-core kernels copy 16-byte chunks of every row.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes (4 bytes) from global to shared memory, zero-filled when !ok (src
// must still be a valid address: nothing is read from it).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// this thread's copies have landed; the proxy fence then makes them visible
// to the wgmmas (async proxy) of every thread after the next barrier
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence, commit and wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Tiles of 64 rows x DH bf16 in wgmma's 128-byte swizzle: column halves of
// 64 elements (DH / 64 of them, kTile * 128 bytes apart), each row 128 bytes,
// its 16-byte chunk c stored at chunk c ^ (row % 8).  Tiles start on 1024-byte
// boundaries (the swizzle reads address bits 7..9 as the row).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)((c >> 3) * kTile * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// rows [s0, s0 + 64) of one head (row s at src + s * stride) into a swizzled
// tile, copied by NT threads; rows at or past S read as 0.  Thread t copies
// chunk t % (DH / 8) of rows t / (DH / 8) + R j (R = 8 NT / DH rows a pass):
// rows R apart keep their row % 8, so their swizzled addresses differ by
// R * 128 bytes, an immediate offset from one register.
template <int DH, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* __restrict__ src, int s0,
                                                int S, long long stride, int t) {
  constexpr int kChunks = DH / 8, kRows = NT / kChunks;
  static_assert(kRows % 8 == 0 && kTile % kRows == 0, "rows a pass must keep the swizzle");
  const int r = t / kChunks, c = t % kChunks;
  const uint32_t d = dst + sw128(r, c);
  const bf16* row = src + (long long)(s0 + r) * stride + c * 8;
#pragma unroll
  for (int j = 0; j < kTile / kRows; ++j) {
    const bool ok = s0 + r + kRows * j < S;
    cp_async16(d + j * kRows * 128, ok ? row + (long long)j * kRows * stride : src, ok);
  }
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// Descriptor of a swizzled tile read K-major (tile rows are M or N, the head
// dim is K) and its k-step kk's offset in 16-byte units: column half kk / 4,
// 32 bytes into the half's rows.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile) { return make_desc(tile, 16, 1024); }
__host__ __device__ constexpr int kmajor_step(int kk) {
  return ((kk >> 2) * kTile * 128 + (kk & 3) * 32) >> 4;
}
// ... read MN-major (tile rows are K, the head dim is N, read transposed):
// k-step kk is rows 16 kk .. 16 kk + 15; the next 64 columns lie a half
// (kTile * 128 bytes) on.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile) {
  return make_desc(tile, kTile * 128, 1024);
}
__host__ __device__ constexpr int mnmajor_step(int kk) { return (kk * 16 * 128) >> 4; }

// The wgmma wrappers add the k-step's offset to the base descriptors in
// PTX, so the compiler holds one descriptor a tile, not one a k-step.
template <int OFF>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %34, 0;\n"
      "add.s64 da, %32, %35;\nadd.s64 db, %33, %35;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(OFF));
}

template <int OFF>
__device__ __forceinline__ void wgmma_m64n64k16_rs_t(float (&d)[32], const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %37, 0;\n"
      "add.s64 db, %36, %38;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(OFF));
}

template <int OFF>
__device__ __forceinline__ void wgmma_m64n128k16_rs_t(float (&d)[64], const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %69, 0;\n"
      "add.s64 db, %68, %70;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(OFF));
}

template <int DH, int OFF>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[DH / 2], const uint32_t* a, uint64_t db) {
  if constexpr (DH == 128) {
    wgmma_m64n128k16_rs_t<OFF>(d, a, db);
  } else {
    wgmma_m64n64k16_rs_t<OFF>(d, a, db);
  }
}

// d = a . b^T over the head dim (one k-step a KK): a and b K-major tiles
template <int... KK>
__device__ __forceinline__ void product_ss(float (&d)[32], uint64_t da, uint64_t db,
                                           std::integer_sequence<int, KK...>) {
  (wgmma_m64n64k16_ss<kmajor_step(KK)>(d, da, db), ...);
}
// d += (hi + lo) . b over b's 64 rows (k-steps KK = 0..3): hi and lo the
// split register operands, b an MN-major tile
template <int DH, int... KK>
__device__ __forceinline__ void product_rs(float (&d)[DH / 2], const uint32_t (&hi)[16],
                                           const uint32_t (&lo)[16], uint64_t db,
                                           std::integer_sequence<int, KK...>) {
  ((wgmma_rs_t<DH, mnmajor_step(KK)>(d, hi + 4 * KK, db),
    wgmma_rs_t<DH, mnmajor_step(KK)>(d, lo + 4 * KK, db)), ...);
}
using RowSteps = std::make_integer_sequence<int, kTile / 16>;

// fp32 pair -> bf16x2 (a in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of a 64 x N wgmma: thread t of the warpgroup holds
// element 4 n + 2 i + j at row 16 (t / 32) + (t % 32) / 4 + 8 i and column
// 8 n + 2 (t % 4) + j.  It is also the layout of a register A operand, so a
// 64 x 64 accumulator (32 fp32 a thread) gives the A operands of 4 k-steps
// (4 bf16 pairs each): k-step kk takes elements 8 kk .. 8 kk + 7, in pairs.
//
// The operand split: x = hi + lo + e with hi = bf16(x), lo = bf16(x - hi),
// |e| <= 2^-17 |x|.
__device__ __forceinline__ void split_frags(const float (&x)[32], uint32_t (&hi)[16],
                                            uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float a = x[2 * i], b = x[2 * i + 1];
    hi[i] = pack_bf16(a, b);
    lo[i] = pack_bf16(a - __uint_as_float(hi[i] << 16), b - __uint_as_float(hi[i] & 0xffff0000u));
  }
}

// d += a . b over b's 64 rows (k-steps KK = 0..3), a the bf16 register
// operand and b an MN-major tile
template <int DH, int... KK>
__device__ __forceinline__ void product_rs1(float (&d)[DH / 2], const uint32_t (&a)[16],
                                            uint64_t db, std::integer_sequence<int, KK...>) {
  (wgmma_rs_t<DH, mnmajor_step(KK)>(d, a + 4 * KK, db), ...);
}

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, far under any p that moves a bf16 product)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------- forward on the tensor cores ----
constexpr float kLn2 = 0.6931471805599453f;

// One key tile of the forward's online softmax, in the s accumulator (layout
// above: element x is row 8 ((x >> 1) & 1) + this thread's r0, key
// 8 (x >> 2) + (x & 1) + this thread's c0).  Scores and the running max m
// are in base 2: s c with c = dh^-0.5 log2 e, so p = 2^(s c - m) =
// exp(s dh^-0.5 - m ln 2).  s becomes p (fp32), l (this thread's share of
// each row's sum: its 16 columns) is rescaled and adds the fp32 p, and corr
// is the rescale of the row's accumulator.  MASK: the tile holds invalid
// pairs, which score kNeg, as in the reference: a row with no valid key yet
// gets p = 1, which corr = 2^(kNeg - m) = 0 wipes at its first valid key.
// Such a tile scales before it subtracts: fma(kNeg, c, -m) with m =
// round(kNeg c) would leave the product's rounding error (~1e21) in the
// exponent.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float c, int iq0, int jk0,
                                             int window) {
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int i = (x >> 1) & 1;
    if constexpr (MASK)
      s[x] = valid(iq0 + 8 * i, jk0 + 8 * (x >> 2) + (x & 1), window) ? s[x] * c : kNeg;
    mx[i] = fmaxf(mx[i], s[x]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the row's 64 columns lie in the 4 threads of a quad
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // without the mask, s is raw: max(s) c is the max of the rounded s c
    const float m_new = fmaxf(m[i], MASK ? mx[i] : mx[i] * c);
    corr[i] = exp2_approx(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int i = (x >> 1) & 1;
    s[x] = exp2_approx(MASK ? s[x] - m[i] : fmaf(s[x], c, -m[i]));
    sum[i] += s[x];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
}

template <int DH, int HB>
constexpr size_t fwd_tc_smem() {
  return 1024 + (HB + 4) * tile_bytes<DH>();
}

// A block: HB warpgroups, warpgroup w the query head blockIdx.x HB + w (all
// of one KV head, since HB divides H / KV) over the 64-row query tile
// blockIdx.z from the last; c = dh^-0.5 log2 e.
template <int DH, int HB>
__global__ void __launch_bounds__(HB * kWG)
flash_fwd_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                       int S, int H, int KV, int window, float c) {
  constexpr uint32_t T = tile_bytes<DH>();
  using HeadSteps = std::make_integer_sequence<int, DH / 16>;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t pad = ((smem_u32(smem_tc) + 1023) & ~1023u) - smem_u32(smem_tc);
  // q of warpgroup w at base + w T; stage st: k at base + (HB + 2 st) T, v after it
  const uint32_t base = smem_u32(smem_tc) + pad;

  const int wg = (int)threadIdx.x / kWG, tid = (int)threadIdx.x % kWG;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int n_qt = (S + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * kTile;  // heaviest query tile first
  const int h = (int)blockIdx.x * HB + wg, b = blockIdx.y, g = h / (H / KV);
  const long long qs = (long long)H * DH, ks = (long long)KV * DH;
  const long long qoff = (long long)b * S * qs + (long long)h * DH;
  const bf16* kb = k + (long long)b * S * ks + (long long)g * DH;
  const bf16* vb = v + (long long)b * S * ks + (long long)g * DH;
  const int row_hi = min(q0 + kTile, S) - 1;
  const int col_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = col_lo / kTile, t_hi = row_hi / kTile;
  const uint32_t sQ = base + wg * T;

  load_tile_async<DH, kWG>(sQ, q + qoff, q0, S, qs, tid);
  load_tile_async<DH, HB * kWG>(base + HB * T, kb, t_lo * kTile, S, ks, (int)threadIdx.x);
  load_tile_async<DH, HB * kWG>(base + (HB + 1) * T, vb, t_lo * kTile, S, ks, (int)threadIdx.x);
  cp_async_commit();

  float acc[DH / 2], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    const uint32_t sK = base + (HB + 2 * st) * T, sV = sK + T;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warpgroup is done with the other stage
    if (t < t_hi) {
      const uint32_t nK = base + (HB + 2 - 2 * st) * T;
      load_tile_async<DH, HB * kWG>(nK, kb, (t + 1) * kTile, S, ks, (int)threadIdx.x);
      load_tile_async<DH, HB * kWG>(nK + T, vb, (t + 1) * kTile, S, ks, (int)threadIdx.x);
    }
    cp_async_commit();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
    product_ss(s, desc_kmajor(sQ), desc_kmajor(sK), HeadSteps());
    wgmma_commit();
    wgmma_wait();
    pin(s);

    // every (q, k) pair of the tile valid: the same for all warpgroups
    const int k0 = t * kTile;
    const bool full = k0 + kTile - 1 <= q0 && (window <= 0 || q0 + kTile - 1 - k0 < window);
    float corr[2];
    if (full) {
      softmax_tile<false>(s, m, l, corr, c, q0 + r0, k0 + c0, window);
    } else {
      softmax_tile<true>(s, m, l, corr, c, q0 + r0, k0 + c0, window);
    }
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) acc[x] *= corr[(x >> 1) & 1];
    uint32_t p[16];  // p.astype(v.dtype): the A operand of P.V
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    pin(p);
    pin(acc);
    wgmma_fence();
    product_rs1<DH>(acc, p, desc_mnmajor(sV), RowSteps());
    wgmma_commit();
    wgmma_wait();
    pin(acc);
    pin(p);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the row's sum over its quad
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int iq = q0 + r0 + 8 * i;
    if (iq >= S) continue;
    const float den = fmaxf(l[i], 1e-20f);
    bf16* row = o + qoff + (long long)iq * qs + c0;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n) =
          pack_bf16(acc[4 * n + 2 * i] / den, acc[4 * n + 2 * i + 1] / den);
    if ((lane & 3) == 0) lse[((long long)b * H + h) * S + iq] = m[i] * kLn2 + logf(den);
  }
}

// ------------------------------------------ backward on the tensor cores ----
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

template <int DH>
constexpr size_t dq_tc_smem() {
  return 1024 + 6 * tile_bytes<DH>() + kTile * sizeof(float);
}
template <int DH>
constexpr size_t dkv_tc_smem() {
  return 1024 + 6 * tile_bytes<DH>() + 2 * 2 * kTile * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kWG)
flash_bwd_dq_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ o,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ delta, bf16* __restrict__ dq, int S, int H, int KV,
                          int window, float scale) {
  constexpr uint32_t T = tile_bytes<DH>();
  using HeadSteps = std::make_integer_sequence<int, DH / 16>;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t pad = ((smem_u32(smem_tc) + 1023) & ~1023u) - smem_u32(smem_tc);
  const uint32_t base = smem_u32(smem_tc) + pad;
  const uint32_t sQ = base, sdO = base + T;  // stage st: k at base + (2 + 2 st) T, v after it
  float* sDelta = reinterpret_cast<float*>(smem_tc + pad + 6 * T);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int n_qt = (S + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * kTile;  // heaviest query tile first
  const int h = blockIdx.x, b = blockIdx.y, g = h / (H / KV);
  const long long qs = (long long)H * DH, ks = (long long)KV * DH;
  const long long qoff = (long long)b * S * qs + (long long)h * DH;
  const bf16* kb = k + (long long)b * S * ks + (long long)g * DH;
  const bf16* vb = v + (long long)b * S * ks + (long long)g * DH;
  const long long roff = ((long long)b * H + h) * S;  // lse / delta row of this head
  const int row_hi = min(q0 + kTile, S) - 1;
  const int col_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = col_lo / kTile, t_hi = row_hi / kTile;

  load_tile_async<DH, kWG>(sQ, q + qoff, q0, S, qs, tid);
  load_tile_async<DH, kWG>(sdO, dout + qoff, q0, S, qs, tid);
  load_tile_async<DH, kWG>(base + 2 * T, kb, t_lo * kTile, S, ks, tid);
  load_tile_async<DH, kWG>(base + 3 * T, vb, t_lo * kTile, S, ks, tid);
  cp_async_commit();
  {  // delta = rowsum(do * o) while the copies fly: two threads a row
    const int r = tid >> 1, iq = q0 + r, c_lo = (tid & 1) * (DH / 2);
    float part = 0.f;
    if (iq < S) {
      const uint4* orow = reinterpret_cast<const uint4*>(o + qoff + (long long)iq * qs + c_lo);
      const uint4* drow = reinterpret_cast<const uint4*>(dout + qoff + (long long)iq * qs + c_lo);
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) part = dot8(drow[c], orow[c], part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((tid & 1) == 0) {
      sDelta[r] = part;
      if (iq < S) delta[roff + iq] = part;
    }
  }
  __syncthreads();
  float lse_r[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int iq = q0 + r0 + 8 * i;
    lse_r[i] = iq < S ? lse[roff + iq] : 0.f;
    dlt[i] = sDelta[r0 + 8 * i];
  }

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    const uint32_t sK = base + (2 + 2 * st) * T, sV = sK + T;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every thread is done with the other stage
    if (t < t_hi) {
      const uint32_t nK = base + (4 - 2 * st) * T;
      load_tile_async<DH, kWG>(nK, kb, (t + 1) * kTile, S, ks, tid);
      load_tile_async<DH, kWG>(nK + T, vb, (t + 1) * kTile, S, ks, tid);
    }
    cp_async_commit();

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    pin(s);
    pin(dp);
    wgmma_fence();
    product_ss(s, desc_kmajor(sQ), desc_kmajor(sK), HeadSteps());
    product_ss(dp, desc_kmajor(sdO), desc_kmajor(sV), HeadSteps());
    wgmma_commit();
    wgmma_wait();
    pin(s);
    pin(dp);

    const int k0 = t * kTile;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1, iq = q0 + r0 + 8 * i, jk = k0 + 8 * (x >> 2) + c0 + (x & 1);
      const float e = expf(s[x] * scale - lse_r[i]);
      const float p = valid(iq, jk, window) ? e : 0.f;  // a select, not a branch
      dp[x] = p * (dp[x] - dlt[i]) * scale;             // ds
    }
    uint32_t hi[16], lo[16];
    split_frags(dp, hi, lo);
    pin(hi);
    pin(lo);
    pin(acc);
    wgmma_fence();
    product_rs<DH>(acc, hi, lo, desc_mnmajor(sK), RowSteps());
    wgmma_commit();
    wgmma_wait();
    pin(acc);
    pin(hi);
    pin(lo);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int iq = q0 + r0 + 8 * i;
    if (iq >= S) continue;
    bf16* row = dq + qoff + (long long)iq * qs + c0;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n) = pack_bf16(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
  }
}

template <int DH>
__global__ void __launch_bounds__(kWG)
flash_bwd_dkv_kernel_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ part_k, float* __restrict__ part_v, int S, int H,
                           int KV, int G, int window, float scale) {
  constexpr uint32_t T = tile_bytes<DH>();
  using HeadSteps = std::make_integer_sequence<int, DH / 16>;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t pad = ((smem_u32(smem_tc) + 1023) & ~1023u) - smem_u32(smem_tc);
  const uint32_t base = smem_u32(smem_tc) + pad;
  // k at base, v at base + T; stage st: q at base + (2 + 2 st) T, do after it
  const uint32_t sRows = base + 6 * T;  // stage st: lse[64], then delta[64]
  const float* rows_f = reinterpret_cast<const float*>(smem_tc + pad + 6 * T);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int kvg = blockIdx.x / G, grp = blockIdx.x % G, b = blockIdx.y;
  const int k0 = blockIdx.z * kTile;  // key tile 0 has the most query tiles: issued first
  const int rep = H / KV, h_lo = kvg * rep + grp * rep / G;
  const int n_h = kvg * rep + (grp + 1) * rep / G - h_lo;
  const long long qs = (long long)H * DH, ks = (long long)KV * DH;
  const long long koff = (long long)b * S * ks + (long long)kvg * DH;
  const int t_lo = k0 / kTile, n_t = dkv_row_hi(k0, S, window) / kTile - t_lo + 1;
  const int n_steps = n_h * n_t;

  // step i: query head h_lo + i / n_t, query tile t_lo + i % n_t; threads
  // 0..63 copy its lse rows, 64..127 its delta rows
  const bf16* qb = q + (long long)b * S * qs;
  const bf16* dob = dout + (long long)b * S * qs;
  const float* rows_g = (tid < kTile ? lse : delta) + (long long)b * H * S;
  auto issue = [&](int i, int st) {
    const int h = h_lo + i / n_t, q0 = (t_lo + i % n_t) * kTile;
    load_tile_async<DH, kWG>(base + (2 + 2 * st) * T, qb + h * DH, q0, S, qs, tid);
    load_tile_async<DH, kWG>(base + (3 + 2 * st) * T, dob + h * DH, q0, S, qs, tid);
    const float* row = rows_g + (long long)h * S;
    const int iq = q0 + (tid & (kTile - 1));
    cp_async4(sRows + st * 2 * kTile * 4 + tid * 4, iq < S ? row + iq : row, iq < S);
  };
  load_tile_async<DH, kWG>(base, k + koff, k0, S, ks, tid);
  load_tile_async<DH, kWG>(base + T, v + koff, k0, S, ks, tid);
  issue(0, 0);
  cp_async_commit();

  float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    const uint32_t sQ = base + (2 + 2 * st) * T, sdO = sQ + T;
    const float* sL = rows_f + st * 2 * kTile;
    const float* sD = sL + kTile;
    cp_async_wait_all();
    __syncthreads();  // step i is in; every thread is done with the other stage
    if (i + 1 < n_steps) issue(i + 1, st ^ 1);
    cp_async_commit();

    // s^T = k . q^T and dp^T = v . do^T: rows are keys, columns queries
    float s[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
    pin(s);
    pin(dp);
    wgmma_fence();
    product_ss(s, desc_kmajor(base), desc_kmajor(sQ), HeadSteps());
    product_ss(dp, desc_kmajor(base + T), desc_kmajor(sdO), HeadSteps());
    wgmma_commit();
    wgmma_wait();
    pin(s);
    pin(dp);

    const int q0 = (t_lo + i % n_t) * kTile;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int jk = k0 + r0 + 8 * ((x >> 1) & 1), cq = 8 * (x >> 2) + c0 + (x & 1), iq = q0 + cq;
      // query rows past S are padding: they must add nothing
      const float e = expf(s[x] * scale - sL[cq]);
      const float p = iq < S && valid(iq, jk, window) ? e : 0.f;  // a select, not a branch
      s[x] = p;
      dp[x] = p * (dp[x] - sD[cq]) * scale;  // ds
    }
    uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
    split_frags(s, p_hi, p_lo);
    split_frags(dp, ds_hi, ds_lo);
    pin(p_hi);
    pin(p_lo);
    pin(ds_hi);
    pin(ds_lo);
    pin(dv_acc);
    pin(dk_acc);
    wgmma_fence();
    product_rs<DH>(dv_acc, p_hi, p_lo, desc_mnmajor(sdO), RowSteps());
    product_rs<DH>(dk_acc, ds_hi, ds_lo, desc_mnmajor(sQ), RowSteps());
    wgmma_commit();
    wgmma_wait();
    pin(dv_acc);
    pin(dk_acc);
    pin(p_hi);
    pin(p_lo);
    pin(ds_hi);
    pin(ds_lo);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int jk = k0 + r0 + 8 * i;
    if (jk >= S) continue;
    const long long off = ((((long long)b * S + jk) * KV + kvg) * G + grp) * DH + c0;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<float2*>(part_k + off + 8 * n) =
          make_float2(dk_acc[4 * n + 2 * i], dk_acc[4 * n + 2 * i + 1]);
      *reinterpret_cast<float2*>(part_v + off + 8 * n) =
          make_float2(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
    }
  }
}

// dk, dv (rows x DH bf16) = the G group partials (rows x G x DH fp32) summed
// in the order g = 0..G-1: four columns a thread
__global__ void __launch_bounds__(256)
flash_bwd_dkv_reduce_kernel(const float* __restrict__ part_k, const float* __restrict__ part_v,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, long long rows, int G,
                            int DH) {
  const int q4 = DH / 4;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < rows * q4;
       e += (long long)gridDim.x * 256) {
    const long long row = e / q4;
    const int c = (int)(e % q4);
    const float4* pk = reinterpret_cast<const float4*>(part_k + row * G * DH) + c;
    const float4* pv = reinterpret_cast<const float4*>(part_v + row * G * DH) + c;
    float4 sk = pk[0], sv = pv[0];
    for (int g = 1; g < G; ++g) {
      const float4 a = pk[g * q4], w = pv[g * q4];
      sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
      sv.x += w.x, sv.y += w.y, sv.z += w.z, sv.w += w.w;
    }
    reinterpret_cast<uint2*>(dk + row * DH)[c] = make_uint2(pack_bf16(sk.x, sk.y), pack_bf16(sk.z, sk.w));
    reinterpret_cast<uint2*>(dv + row * DH)[c] = make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The forward's head group: query heads of one KV head that share a block.
__host__ __device__ constexpr int fwd_head_group(int rep) { return rep % 2 == 0 ? 2 : 1; }

template <int DH, int HB>
int fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int H,
           int KV, int window, float scale, cudaStream_t stream) {
  const size_t smem = fwd_tc_smem<DH, HB>();
  cudaError_t err = allow_smem(flash_fwd_kernel_wgmma<DH, HB>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H / HB, B, (S + kTile - 1) / kTile);  // query tiles slowest: heaviest first
  const double log2e = 1.4426950408889634;
  flash_fwd_kernel_wgmma<DH, HB><<<grid, HB * kWG, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, S, H, KV, window,
      (float)(scale * log2e));
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int H,
        int KV, int window, float scale, cudaStream_t stream) {
  if constexpr (kTensorCores<T, DH>) {
    if (!aligned16({q, k, v, o})) return (int)cudaErrorMisalignedAddress;
    return fwd_head_group(H / KV) == 2
               ? fwd_tc<DH, 2>(q, k, v, o, lse, B, S, H, KV, window, scale, stream)
               : fwd_tc<DH, 1>(q, k, v, o, lse, B, S, H, KV, window, scale, stream);
  } else {
    const size_t smem = fwd_smem<DH>();
    cudaError_t err = allow_smem(flash_fwd_kernel<T, DH>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + kTileQ - 1) / kTileQ, H, B);
    flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S, H, KV, window, scale);
    return (int)cudaGetLastError();
  }
}

template <typename T, int DH>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, int B, int S, int H, int KV, int window,
           float scale, cudaStream_t stream) {
  if constexpr (kTensorCores<T, DH>) {
    if (!aligned16({q, k, v, o, dout})) return (int)cudaErrorMisalignedAddress;
    const size_t smem = dq_tc_smem<DH>();
    cudaError_t err = allow_smem(flash_bwd_dq_kernel_wgmma<DH>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(H, B, (S + kTile - 1) / kTile);  // query tiles slowest: heaviest first
    flash_bwd_dq_kernel_wgmma<DH><<<grid, kWG, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout, lse,
        delta, (bf16*)dq, S, H, KV, window, scale);
  } else {
    const size_t smem = dq_smem<DH>();
    cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, DH>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + kTileQ - 1) / kTileQ, H, B);
    flash_bwd_dq_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, delta, (T*)dq,
        S, H, KV, window, scale);
  }
  return (int)cudaGetLastError();
}

// part: the tensor-core path's fp32 scratch, 2 * B * S * KV * groups * DH
// floats (dk's partials, then dv's); unused (may be null) on the CUDA-core path.
template <typename T, int DH>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, float* part, int B, int S, int H, int KV,
            int window, int groups, float scale, cudaStream_t stream) {
  if constexpr (kTensorCores<T, DH>) {
    if (part == nullptr || groups < 1 || groups > H / KV) return (int)cudaErrorInvalidValue;
    if (!aligned16({q, k, v, dout})) return (int)cudaErrorMisalignedAddress;
    const size_t smem = dkv_tc_smem<DH>();
    cudaError_t err = allow_smem(flash_bwd_dkv_kernel_wgmma<DH>, smem);
    if (err != cudaSuccess) return (int)err;
    const long long rows = (long long)B * S * KV;
    float* part_v = part + rows * groups * DH;
    const dim3 grid(KV * groups, B, (S + kTile - 1) / kTile);  // key tile 0 first
    flash_bwd_dkv_kernel_wgmma<DH><<<grid, kWG, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, part,
        part_v, S, H, KV, groups, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long n = rows * (DH / 4);  // a grid-stride loop: at most 8 blocks an SM
    const int blocks = (int)std::min<long long>((n + 255) / 256, 8LL * sms);
    flash_bwd_dkv_reduce_kernel<<<blocks, 256, 0, stream>>>(part, part_v, (bf16*)dk, (bf16*)dv,
                                                            rows, groups, DH);
  } else {
    const size_t smem = dkv_smem<DH>();
    cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, DH>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + kTileKV - 1) / kTileKV, KV, B);
    flash_bwd_dkv_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, S, H,
        KV, window, scale);
  }
  return (int)cudaGetLastError();
}

template <typename Kern>
int occupancy(Kern kern, size_t bytes, int* smem, int* blocks, int threads = kWG) {
  *smem = (int)bytes;
  cudaError_t err = allow_smem(kern, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads, bytes);
  return (int)err;
}

// The dk/dv pass's query-head groups G and the fp32 scratch (elements) of
// their partials on the current device; 0 and 0 on the CUDA-core path.  G
// is the smallest whose longest block (key tile 0: its query tiles times
// ceil(rep / G) heads), beside the other blocks its SM holds, takes no
// longer than an SM's share of all the pass's tile steps.  At the training
// shape (B = 1, S = 4096, 2 KV heads of 12, 132 SMs, 2 blocks an SM) a
// block walks at most 2 heads x 64 query tiles: G = 6.
template <typename T, int DH>
int dkv_plan(int B, int S, int H, int KV, int window, int* groups, long long* scratch) {
  *groups = 0, *scratch = 0;
  if constexpr (kTensorCores<T, DH>) {
    int device = 0, sms = 0, smem = 0, resident = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const int occ = occupancy(flash_bwd_dkv_kernel_wgmma<DH>, dkv_tc_smem<DH>(), &smem, &resident);
    if (occ != 0) return occ;
    const int n_t = (S + kTile - 1) / kTile, rep = H / KV;
    auto query_tiles = [&](int j) { return dkv_row_hi(j * kTile, S, window) / kTile - j + 1; };
    long long steps = 0;
    for (int j = 0; j < n_t; ++j) steps += query_tiles(j);
    const double share = (double)B * KV * rep * steps / sms;
    int g = 1;
    while (g < rep && (double)resident * query_tiles(0) * ((rep + g - 1) / g) > share) ++g;
    *groups = g;
    *scratch = 2LL * B * S * KV * g * DH;  // dk's partials, then dv's
  }
  return 0;
}

// dtype 0 = float32, 1 = bfloat16; dh in {8, 16, 64, 128}
#define FLASH_DISPATCH(FN, ...)                                         \
  do {                                                                  \
    if (dtype == 0) {                                                   \
      switch (dh) {                                                     \
        case 8: return FN<float, 8>(__VA_ARGS__);                       \
        case 16: return FN<float, 16>(__VA_ARGS__);                     \
        case 64: return FN<float, 64>(__VA_ARGS__);                     \
        case 128: return FN<float, 128>(__VA_ARGS__);                   \
      }                                                                 \
    } else if (dtype == 1) {                                            \
      switch (dh) {                                                     \
        case 8: return FN<__nv_bfloat16, 8>(__VA_ARGS__);               \
        case 16: return FN<__nv_bfloat16, 16>(__VA_ARGS__);             \
        case 64: return FN<__nv_bfloat16, 64>(__VA_ARGS__);             \
        case 128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);           \
      }                                                                 \
    }                                                                   \
    return (int)cudaErrorInvalidValue;                                  \
  } while (0)

}  // namespace

extern "C" {

// q (B, S, H, dh), k and v (B, S, KV, dh) -> o like q, lse (B, H, S) fp32.
// window <= 0: causal only.  Returns the cudaError_t of the launch
// (cudaErrorMisalignedAddress, before any launch, for a bf16 tensor at dh 64
// or 128 that does not start on 16 bytes).
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
              int H, int KV, int dh, int window, int dtype, float scale, cudaStream_t stream) {
  FLASH_DISPATCH(fwd, q, k, v, o, lse, B, S, H, KV, window, scale, stream);
}

// -> dq like q, delta (B, H, S) fp32 (read by flash_bwd_dkv, launched after).
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, float* delta, void* dq, int B, int S, int H, int KV, int dh,
                 int window, int dtype, float scale, cudaStream_t stream) {
  FLASH_DISPATCH(bwd_dq, q, k, v, o, dout, lse, delta, dq, B, S, H, KV, window, scale, stream);
}

// -> dk, dv like k, each summed over the rep query heads of its KV head.
// bf16 at dh 64 and 128 runs on the tensor cores in `groups` query-head
// groups and needs `part`, an fp32 scratch of 2 * B * S * KV * groups * dh
// floats; the other (type, dh) ignore both.
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, float* part, int B,
                  int S, int H, int KV, int dh, int window, int dtype, int groups, float scale,
                  cudaStream_t stream) {
  FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, part, B, S, H, KV, window, groups,
                 scale, stream);
}

// The dk/dv pass's plan at this shape on the current device: its query-head
// `groups` and the fp32 `scratch` elements the caller allocates as its
// `part`; both 0 where (dtype, dh) runs the CUDA-core kernel.
int flash_bwd_dkv_plan(int B, int S, int H, int KV, int dh, int window, int dtype, int* groups,
                       long long* scratch) {
  FLASH_DISPATCH(dkv_plan, B, S, H, KV, window, groups, scratch);
}

// The tensor-core kernel of `pass` (0: dq, 1: dk/dv, 2: the forward, whose
// head group follows rep = H / KV) at dh: its threads a block (128 a
// warpgroup; the forward's head group is threads / 128), dynamic shared
// memory (bytes) and how many blocks of it an SM holds (the occupancy
// calculator, from its registers and shared memory).
int flash_tc_occupancy(int pass, int dh, int rep, int* threads, int* smem, int* blocks) {
  const int hb = fwd_head_group(rep);
  *threads = pass == 2 ? hb * kWG : kWG;
  switch (pass * 1000 + dh) {
    case 64: return occupancy(flash_bwd_dq_kernel_wgmma<64>, dq_tc_smem<64>(), smem, blocks);
    case 128: return occupancy(flash_bwd_dq_kernel_wgmma<128>, dq_tc_smem<128>(), smem, blocks);
    case 1064: return occupancy(flash_bwd_dkv_kernel_wgmma<64>, dkv_tc_smem<64>(), smem, blocks);
    case 1128: return occupancy(flash_bwd_dkv_kernel_wgmma<128>, dkv_tc_smem<128>(), smem, blocks);
    case 2064:
      return hb == 2 ? occupancy(flash_fwd_kernel_wgmma<64, 2>, fwd_tc_smem<64, 2>(), smem, blocks, 2 * kWG)
                     : occupancy(flash_fwd_kernel_wgmma<64, 1>, fwd_tc_smem<64, 1>(), smem, blocks);
    case 2128:
      return hb == 2 ? occupancy(flash_fwd_kernel_wgmma<128, 2>, fwd_tc_smem<128, 2>(), smem, blocks, 2 * kWG)
                     : occupancy(flash_fwd_kernel_wgmma<128, 1>, fwd_tc_smem<128, 1>(), smem, blocks);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
