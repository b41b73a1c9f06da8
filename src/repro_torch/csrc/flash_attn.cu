// FlashAttention-2 forward and backward for Hopper (sm_90a): causal plus an
// optional sliding window, GQA read natively, bf16 or fp32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/kernel.py:
// flash_mha (body _flash_kernel) for the forward, and the reference's
// hand-written backward src/repro/models/transformer/attention.py:
// _flash_bwd (pass 1, dq; pass 2, dk and dv) for the backward:
//
//   forward   s = (q . k) * dh^-0.5, masked to -1e30 where jk > iq or
//             iq - jk >= window; online softmax with fp32 m, l, acc; p is
//             rounded to v's type before P.V; o = acc / max(l, 1e-20) in
//             the input type, lse = m + log(max(l, 1e-20)) in fp32.
//   dq        delta = rowsum(do * o) (fp32, written out for the dk/dv pass);
//             p = exp(s - lse); dp = do . v; ds = p * (dp - delta) * scale;
//             dq = sum ds . k.
//   dk, dv    dv = sum p^T . do, dk = sum ds^T . q, summed over the rep
//             query heads of the KV head inside one block (no atomics: the
//             sum is deterministic).
//
// Every score, p, dp and ds is fp32 and every product is an fp32 FMA on the
// CUDA cores, as the reference computes them (its bf16 products are exact
// in fp32 and accumulate in fp32; p and ds are fp32 operands).  Layouts are
// the reference's: q, o, do, dq (B, S, H, dh); k, v, dk, dv (B, S, KV, dh),
// query head h reading KV head h / (H / KV) with no repeat copy; lse and
// delta (B, H, S) fp32.
//
// What bounds it on an H100: operations.  At the training shape (S = 4096,
// H = 24, dh = 128, window 4096) the forward does 2 products of 2 * dh flops
// over 201 M valid (q, k) pairs: 103 GFLOP, 0.104 ms at the 989 TFLOP/s
// bf16 tensor rate, against 55 MB of bytes (0.016 ms).  The backward's p
// and ds are fp32 operands, so three of its five products need the 67
// TFLOP/s fp32 rate.  This first kernel runs every product on the CUDA
// cores, so it sits far above the tensor-core bound: the tensor cores for
// the bf16 products are a later optimisation.
//
// What the design does about it: one block of 256 threads per (64-row query
// tile, query head) for the forward and dq passes, and per (32-row key tile,
// KV head) for dk/dv; the loop over the other sequence axis runs inside the
// block (the TPU grid's sequential axis).  Tiles sit in shared memory as
// fp32 with a padded row stride (dh + 1: threads that read 16 different
// rows at one column hit 16 different banks); each thread keeps a 4 x 4
// (2 x 4 for dk/dv) block of scores and a 4 x dh/16 block of accumulators
// in registers, so each shared-memory load feeds two to four FMAs.  Row
// maxima and sums reduce over the 16 lanes of a half-warp with shuffles.
// Tiles that hold no valid (q, k) pair are skipped; that is exact: a tile
// before a row's window only adds terms that corr = exp(-1e30 - m) = 0
// wipes when the row's first valid tile arrives, and a tile past the
// diagonal adds p = exp(-1e30 - m) = 0.  Query tiles are issued heaviest
// first (the last tile of a causal row has the most key tiles).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------------------- forward ----
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int H, int KV, int window,
                 float scale) {
  constexpr int LD = DH + 1, LP = kTileK + 1;
  constexpr int RM = kTileQ / 16, RN = kTileK / 16, RD = DH / 16;
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
      for (int dd = 0; dd < RD; ++dd) vv[dd] = sV[c * LD + tx + 16 * dd];
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
    for (int dd = 0; dd < RD; ++dd) orow[tx + 16 * dd] = from_f<T>(acc[i][dd] / den);
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
  constexpr int RM = kTileQ / 16, RN = kTileK / 16, RD = DH / 16;
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
    if (iq < S) {
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
      for (int dd = 0; dd < RD; ++dd) kk[dd] = sK[c * LD + tx + 16 * dd];
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
    for (int dd = 0; dd < RD; ++dd) row[tx + 16 * dd] = from_f<T>(acc[i][dd]);
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
  constexpr int RM = kTileKV / 16, RN = kTileQ / 16, RD = DH / 16;
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
          e[dd] = sdO[rq * LD + tx + 16 * dd];
          a[dd] = sQ[rq * LD + tx + 16 * dd];
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
      dk[off + tx + 16 * dd] = from_f<T>(acc_k[i][dd]);
      dv[off + tx + 16 * dd] = from_f<T>(acc_v[i][dd]);
    }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DH>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int H,
        int KV, int window, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<DH>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DH>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTileQ - 1) / kTileQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S, H, KV, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, int B, int S, int H, int KV, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = dq_smem<DH>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, DH>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTileQ - 1) / kTileQ, H, B);
  flash_bwd_dq_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, delta, (T*)dq, S,
      H, KV, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dk, void* dv, int B, int S, int H, int KV, int window,
            float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem<DH>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, DH>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTileKV - 1) / kTileKV, KV, B);
  flash_bwd_dkv_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, S, H,
      KV, window, scale);
  return (int)cudaGetLastError();
}

// dtype 0 = float32, 1 = bfloat16; dh in {16, 64, 128}
#define FLASH_DISPATCH(FN, ...)                                         \
  do {                                                                  \
    if (dtype == 0) {                                                   \
      switch (dh) {                                                     \
        case 16: return FN<float, 16>(__VA_ARGS__);                     \
        case 64: return FN<float, 64>(__VA_ARGS__);                     \
        case 128: return FN<float, 128>(__VA_ARGS__);                   \
      }                                                                 \
    } else if (dtype == 1) {                                            \
      switch (dh) {                                                     \
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
// window <= 0: causal only.  Returns the cudaError_t of the launch.
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
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int B, int S, int H,
                  int KV, int dh, int window, int dtype, float scale, cudaStream_t stream) {
  FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, window, scale, stream);
}

}  // extern "C"
