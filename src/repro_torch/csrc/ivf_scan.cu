// IVF candidate scan (gather + score + per-tile top-k) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ivf_scan/kernel.py: ivf_scan_tiled (a blocked
// lax.scan, not a pallas_call) and the dense src/repro/kernels/ivf_scan/ref.py
// ivf_candidate_scan, which compute the same function: for each query q and
// each of its W candidate slots, score = q . emb[cand[q, w]] where cmask is
// set and -inf where it is not (sentinel ids N are clamped for the gather and
// never score), then the top k by (score desc, candidate position asc).  This
// kernel writes each tile's top-k (scores and positions); the caller merges
// the tiles' lists with a stable sort (tiles in position order) and reads the
// raw cand values at the winning positions, so rows with fewer than k live
// slots return the lowest-position masked slots' ids, as the reference does.
//
// What bounds it on an H100: bytes.  Every candidate slot's id (4 B) and mask
// (1 B) is read once, and every live candidate's embedding row (4 D bytes).
// At the serving shape (Q = 4, W = 14,916 slots of nprobe 4 lists on the
// 169,343-node Arxiv-scale index, D = 128) that is at most 30.8 MB, 9.2 us at
// 3.35 TB/s (fewer where slots are masked); 2 D flops per live candidate are
// far under the fp32 rate.
//
// What the design does about it: one block per (tile of 256 candidate slots,
// query), 256 threads, so Q = 4 and W = 14,916 give 236 blocks for the 132
// SMs.  The query row sits in shared memory.  A warp owns candidate rows,
// four at a time so that four rows' loads are in flight per lane: it reads
// the ids and masks (one broadcast load each), skips masked rows without
// touching the embedding table, and reads each live row with coalesced loads
// (lane l holds columns l, l + 32, ...).  The dot product is summed in a
// fixed order -- rounded products, 32 lane partial sums, then a halving
// shuffle tree, with no contraction into FMAs -- which ref.py's dot_scores
// repeats, so kernel and plain version agree bit for bit.  The tile's scores
// stay in shared memory, where one warp runs k selection rounds; round t
// takes the best slot after round t-1's winner in the (score desc, position
// asc) order, so masked (-inf) slots come out in position order too.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 256;  // candidate slots per block, TILE in kernel.py
constexpr int kRows = 4;    // candidate rows a warp scores at once

// (score, position) order of the reference: larger score first, then the
// lower position.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
ivf_scan_tile_kernel(const float* __restrict__ q, const float* __restrict__ emb,
                     const int* __restrict__ cand, const uint8_t* __restrict__ cmask,
                     float* __restrict__ out_s, int* __restrict__ out_p,
                     int N, int D, int W, int k, int n_tiles) {
  extern __shared__ float smem[];
  float* qs = smem;      // [D] this query's row
  float* sc = smem + D;  // [kTile] this tile's scores
  const long long qi = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - (int)(qi * n_tiles);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < D; d += kThreads) qs[d] = q[qi * D + d];
  __syncthreads();

  const int tile0 = tile * kTile;
  const int cnt = min(kTile, W - tile0);
  const int* crow = cand + qi * W + tile0;
  const uint8_t* mrow = cmask + qi * W + tile0;
  for (int r0 = warp * kRows; r0 < cnt; r0 += kWarps * kRows) {
    const float* e[kRows];
    bool live[kRows];
    float acc[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = r0 + u;
      live[u] = r < cnt && __ldg(mrow + r) != 0;
      const int id = live[u] ? min(max(__ldg(crow + r), 0), N - 1) : 0;
      e[u] = emb + (long long)id * D;
      acc[u] = 0.f;
    }
    for (int d = lane; d < D; d += 32) {
      const float qd = qs[d];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (live[u]) acc[u] = __fadd_rn(acc[u], __fmul_rn(__ldg(e[u] + d), qd));
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[u] = __fadd_rn(acc[u], __shfl_xor_sync(0xffffffffu, acc[u], o));
      if (lane == 0 && r0 + u < cnt) sc[r0 + u] = live[u] ? acc[u] : -CUDART_INF_F;
    }
  }
  __syncthreads();

  if (warp != 0) return;
  const size_t out0 = ((size_t)qi * n_tiles + tile) * k;
  float pv = CUDART_INF_F;  // the previous round's winner; everything is after it
  int pp = -1;
  for (int t = 0; t < k; ++t) {
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;  // none found yet
    for (int c = lane; c < cnt; c += 32) {
      const float v = sc[c];
      const bool after = v < pv || (v == pv && c > pp);
      if (after && better(v, c, bv, bi)) { bv = v; bi = c; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    const bool found = bi != 0x7fffffff;  // false only past a short tile's end
    if (lane == 0) {
      out_s[out0 + t] = found ? bv : -CUDART_INF_F;
      out_p[out0 + t] = tile0 + (found ? bi : 0);
    }
    pv = bv;
    pp = bi;
  }
}

}  // namespace

extern "C" {

// q (Q, D) f32, emb (N, D) f32, cand (Q, W) int32, cmask (Q, W) bool ->
// out_s / out_p (Q, n_tiles, k) with n_tiles = ceil(W / kTile), k <= kTile.
// Returns the launch's cudaError_t.
int ivf_scan_tiles(const float* q, const float* emb, const int* cand, const uint8_t* cmask,
                   float* out_s, int* out_p, int Q, int N, int D, int W, int k,
                   cudaStream_t stream) {
  const int n_tiles = (W + kTile - 1) / kTile;
  const long long blocks = (long long)Q * n_tiles;
  if (blocks > 0x7fffffffLL || k < 1 || k > kTile) return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(float) * (size_t)(D + kTile));
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ivf_scan_tile_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, emb, cand, cmask, out_s, out_p, N, D, W, k, n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
