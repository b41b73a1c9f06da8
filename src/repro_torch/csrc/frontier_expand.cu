// Workset membership mark for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/frontier_expand/kernel.py:
// ws_mark_kernel (body _mark_kernel):
//   out[q, w] = 1  iff  cand[q, w] occurs in the ascending row ws[q, 0:C],
// found by a lower-bound search.  Sentinel pad slots are ordinary values: a
// candidate equal to the pad value matches a pad slot (callers mask
// sentinels themselves).  Every hop of the compact stage-3 backend proposes
// C * K candidates per query (the neighbours of every workset entry) and
// marks them here, so that only fresh ids enter the dedup sort.
//
// What bounds it on an H100: bytes.  Each candidate is read once (4 bytes)
// and each mark written once (1 byte): 5 * Q * W bytes.  On the main path
// (Q = 4, C = 2048, K = 1016, W = C * K = 2,080,768) that is 41.6 MB, 12.4 us
// at 3.35 TB/s.  A full search is ceil(log2 C) + 1 = 12 rounds of about four
// integer operations per candidate (~0.4 G operations, 6 us at the card's
// 67 T 32-bit integer operations per second; by Hopper's 64 integer lanes
// per SM it comes near the byte time), but most candidates need none: a
// workset entry's K candidates are its few live neighbours and then the
// sentinel, 98.5-99.2% of them on the main path.
//
// What the design does about it:
//   * a persistent grid (blocks_per_q x Q blocks, from the wrapper's plan):
//     a block copies its query's row into shared memory once (its first
//     tile's loads in flight meanwhile) and then walks that query's tiles of
//     4096 candidates, issuing the next tile's loads (four 16-byte loads a
//     thread) before it marks the current one;
//   * a dead-candidate shortcut: each warp keeps the (value, mark) pair of
//     its last search.  A lane whose candidate equals that value takes the
//     cached mark, a search runs only on the lanes that differ, and a warp
//     where no lane differs (__any_sync) issues no search: exact by
//     construction, since an equal value has an equal mark.  After a search
//     the pair becomes lane 31's (its candidate, and its mark whether cached
//     or searched).  The pair starts as (ws[q, C - 1], 1);
//   * the search itself is branch-free with a trip count that depends on C
//     only, so the lanes of a warp that do search stay converged;
//   * marks are stored four to a 32-bit word.  The kernel masks the ragged
//     end of W itself (the TPU wrapper pads W with int32 max instead); rows
//     whose W is not a multiple of 4, or unaligned pointers, take a
//     one-candidate-per-load variant (the wrapper's plan chooses it).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                       // 16-byte loads per thread
constexpr int kTile = kThreads * 4 * kVecs;    // candidates per block tile
constexpr unsigned kFull = 0xffffffffu;

// 1 iff x occurs in the ascending row s[0:C], C >= 1.  Branch-free lower
// bound: the answer stays in [base, base + len] and len halves each round.
__device__ __forceinline__ uint32_t member(const int* __restrict__ s, int C, int x) {
  int base = 0;
  int len = C;
  while (len > 1) {
    const int half = len >> 1;
    base = (s[base + half] < x) ? base + half : base;
    len -= half;
  }
  const int pos = base + (s[base] < x ? 1 : 0);
  return (pos < C && s[pos] == x) ? 1u : 0u;
}

// The mark of each lane's candidate x under the warp's (cv, cm) pair, which
// it updates.  Called by all 32 lanes together.
__device__ __forceinline__ uint32_t mark(const int* __restrict__ row, int C, int x, int& cv,
                                         uint32_t& cm) {
  const bool differ = x != cv;
  uint32_t m = cm;
  if (__any_sync(kFull, differ)) {
    if (differ) m = member(row, C, x);
    cv = __shfl_sync(kFull, x, 31);
    cm = __shfl_sync(kFull, m, 31);
  }
  return m;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ws_mark_kernel(const int* __restrict__ ws, const int* __restrict__ cand,
               uint8_t* __restrict__ out, int C, long long W) {
  extern __shared__ int row[];
  const long long q = blockIdx.y;
  const int* crow = cand + q * W;
  uint8_t* orow = out + q * W;
  const long long tiles = (W + kTile - 1) / kTile;
  // the block's first tile is loaded before the row is copied (its loads
  // are in flight meanwhile); then the warp's (value, mark) pair starts as
  // the row's last id, which occurs in it
  auto copy_row = [&](int& cv, uint32_t& cm) {
    const int* wrow = ws + q * C;
    for (int i = threadIdx.x; i < C; i += kThreads) row[i] = wrow[i];
    __syncthreads();
    cv = row[C - 1];
    cm = 1u;
  };
  int cv;
  uint32_t cm;
  long long t = blockIdx.x;
  if constexpr (kVec) {  // W % 4 == 0: a group of four is wholly inside W or wholly out
    int4 cur[kVecs], nxt[kVecs] = {};
    auto load = [&](int4* c4, long long tt) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const long long w = tt * kTile + 4LL * (v * kThreads + threadIdx.x);
        c4[v] = w < W ? __ldg(reinterpret_cast<const int4*>(crow + w)) : make_int4(0, 0, 0, 0);
      }
    };
    if (t < tiles) load(cur, t);
    copy_row(cv, cm);
    for (; t < tiles; t += gridDim.x) {
      if (t + gridDim.x < tiles) load(nxt, t + gridDim.x);  // in flight while this tile is marked
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const long long w = t * kTile + 4LL * (v * kThreads + threadIdx.x);
        const bool in = w < W;  // lanes past W hold the pair's value: no search, no store
        const uint32_t m0 = mark(row, C, in ? cur[v].x : cv, cv, cm);
        const uint32_t m1 = mark(row, C, in ? cur[v].y : cv, cv, cm);
        const uint32_t m2 = mark(row, C, in ? cur[v].z : cv, cv, cm);
        const uint32_t m3 = mark(row, C, in ? cur[v].w : cv, cv, cm);
        if (in) *reinterpret_cast<uint32_t*>(orow + w) = m0 | m1 << 8 | m2 << 16 | m3 << 24;
      }
#pragma unroll
      for (int v = 0; v < kVecs; ++v) cur[v] = nxt[v];
    }
  } else {
    constexpr int kPer = 4 * kVecs;  // candidates per thread per tile
    int cur[kPer], nxt[kPer] = {};
    auto load = [&](int* c, long long tt) {
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const long long w = tt * kTile + (long long)v * kThreads + threadIdx.x;
        c[v] = w < W ? __ldg(crow + w) : 0;
      }
    };
    if (t < tiles) load(cur, t);
    copy_row(cv, cm);
    for (; t < tiles; t += gridDim.x) {
      if (t + gridDim.x < tiles) load(nxt, t + gridDim.x);
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const long long w = t * kTile + (long long)v * kThreads + threadIdx.x;
        const bool in = w < W;
        const uint32_t m = mark(row, C, in ? cur[v] : cv, cv, cm);
        if (in) orow[w] = (uint8_t)m;
      }
#pragma unroll
      for (int v = 0; v < kPer; ++v) cur[v] = nxt[v];
    }
  }
}

}  // namespace

extern "C" {

// ws (Q, C) int32, each row ascending; cand (Q, W) int32 -> out (Q, W) bool
// (one byte, 0 or 1).  Needs 1 <= C with 4 * C bytes of shared memory per
// block (the caller checks).  vec (four candidates a load) needs W % 4 == 0,
// a 16-byte aligned cand and a 4-byte aligned out; blocks_per_q >= 1 blocks
// walk each query's tiles.  A plan the shapes do not allow returns
// cudaErrorInvalidValue without launching; else the cudaError_t of the
// launch.
int ws_mark(const int* ws, const int* cand, uint8_t* out, int Q, int C, long long W, int vec,
            int blocks_per_q, cudaStream_t stream) {
  const bool aligned = W % 4 == 0 && (reinterpret_cast<uintptr_t>(cand) & 15u) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 3u) == 0;
  if (C < 1 || Q < 1 || Q > 65535 || blocks_per_q < 1 || (vec && !aligned))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)C;
  void (*kern)(const int*, const int*, uint8_t*, int, long long) =
      vec ? ws_mark_kernel<true> : ws_mark_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)blocks_per_q, (unsigned)Q);
  kern<<<grid, kThreads, smem, stream>>>(ws, cand, out, C, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
