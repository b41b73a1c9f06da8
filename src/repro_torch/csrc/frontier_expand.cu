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
// at 3.35 TB/s.  The search is ceil(log2 C) + 1 = 12 rounds of about four
// integer operations (compare, select, add, subtract) per candidate: ~0.4 G
// operations, 6 us at the card's 67 T 32-bit integer operations per second,
// under the byte time.  (That table rate counts an fp32 FMA as two
// operations on 128 lanes per SM; Hopper issues 32-bit integer instructions
// on 64 lanes per SM, so by issue rate the search comes near the byte time.)
// The workset row (8 KB) is read once per block and is not counted.
//
// What the design does about it: one block per (tile of 4096 candidates,
// query).  The block copies its query's row into shared memory with
// coalesced loads; each thread then takes 16 candidates as four 16-byte
// loads (all issued before the first search), runs a branch-free lower-bound
// search in shared memory whose trip count depends on C only (no divergence
// within a warp), and stores four marks packed into one 32-bit word.  Dead
// ELL slots arrive as the sentinel, so most warps search one value and the
// shared-memory reads broadcast.  The kernel masks the ragged end of W
// itself (the TPU wrapper pads W with int32 max instead); rows whose W is
// not a multiple of 4, or unaligned pointers, take a one-candidate-per-load
// variant.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                       // 16-byte loads per thread
constexpr int kTile = kThreads * 4 * kVecs;    // candidates per block

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

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ws_mark_kernel(const int* __restrict__ ws, const int* __restrict__ cand,
               uint8_t* __restrict__ out, int C, long long W) {
  extern __shared__ int row[];
  const long long q = blockIdx.y;
  const int* wrow = ws + q * C;
  for (int i = threadIdx.x; i < C; i += kThreads) row[i] = wrow[i];
  __syncthreads();

  const int* crow = cand + q * W;
  uint8_t* orow = out + q * W;
  const long long tile0 = (long long)blockIdx.x * kTile;
  if (kVec) {  // W % 4 == 0: a group of four is wholly inside W or wholly out
    int4 c4[kVecs];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const long long w = tile0 + 4LL * (v * kThreads + threadIdx.x);
      if (w < W) c4[v] = __ldg(reinterpret_cast<const int4*>(crow + w));
    }
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const long long w = tile0 + 4LL * (v * kThreads + threadIdx.x);
      if (w < W) {
        const uint32_t packed = member(row, C, c4[v].x) | member(row, C, c4[v].y) << 8 |
                                member(row, C, c4[v].z) << 16 | member(row, C, c4[v].w) << 24;
        *reinterpret_cast<uint32_t*>(orow + w) = packed;
      }
    }
  } else {
#pragma unroll 4
    for (int v = 0; v < 4 * kVecs; ++v) {
      const long long w = tile0 + (long long)v * kThreads + threadIdx.x;
      if (w < W) orow[w] = (uint8_t)member(row, C, __ldg(crow + w));
    }
  }
}

}  // namespace

extern "C" {

// ws (Q, C) int32, each row ascending; cand (Q, W) int32 -> out (Q, W) bool
// (one byte, 0 or 1).  Needs 1 <= C with 4 * C bytes of shared memory per
// block (the caller checks).  Returns the cudaError_t of the launch.
int ws_mark(const int* ws, const int* cand, uint8_t* out, int Q, int C, long long W,
            cudaStream_t stream) {
  const size_t smem = sizeof(int) * (size_t)C;
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(cand) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 3u) == 0;
  void (*kern)(const int*, const int*, uint8_t*, int, long long) =
      vec ? ws_mark_kernel<true> : ws_mark_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((W + kTile - 1) / kTile), (unsigned)Q);
  kern<<<grid, kThreads, smem, stream>>>(ws, cand, out, C, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
