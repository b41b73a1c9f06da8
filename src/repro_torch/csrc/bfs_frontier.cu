// One pull-BFS frontier hop for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bfs_frontier/kernel.py:
// frontier_hop_kernel (body _hop_kernel):
//   reach[q, i] = OR_k (mask[i, k] && frontier[q, nbr[i, k]]),
// where neighbour id N is the sentinel and reads 0.
//
// What bounds it on an H100: bytes.  The mask of every ELL slot must be
// read (N * K bytes: 172 MB for the Arxiv-scale graph, K = 1016), and the
// neighbour id of every live slot (4 bytes each); the frontier test itself
// is a few integer operations per live slot.
//
// What the design does about it:
//   * pack pass: each query's bool frontier row becomes a bitmap of N bits
//     (21 KB per query at N = 169,343), so all Q bitmaps stay resident in
//     L1/L2 instead of one 169 KB int8 row per query, the layout the TPU
//     kernel keeps in VMEM and one Hopper block could not hold twice;
//   * hop pass: a warp owns a node row and reads it once for all Q queries
//     (the TPU kernel re-reads each adjacency tile once per query).  Lanes
//     read the mask 8 slots at a time (256 contiguous bytes per warp load),
//     read a neighbour id only where its mask bit is set, and test that id
//     in every query's bitmap; a warp-wide OR of the per-query bit sets
//     gives the row's answer for up to 32 queries.
// The ELL layout itself is the reference's (dead slots included).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQG = 32;  // queries per hop block (bits of the OR word)

// words[q, w] bit b = frontier[q, 32 w + b]; one ballot per warp.
__global__ void __launch_bounds__(kThreads)
pack_frontier_kernel(const uint8_t* __restrict__ f, uint32_t* __restrict__ words,
                     int Q, int N, int W) {
  const long t = (long)blockIdx.x * kThreads + threadIdx.x;
  const long per_q = (long)W * 32;
  if (t >= (long)Q * per_q) return;  // whole warps: Q * W * 32 is a multiple of 32
  const int q = (int)(t / per_q);
  const long i = t - q * per_q;
  const bool bit = i < N && f[(long)q * N + i] != 0;
  const uint32_t w = __ballot_sync(0xffffffffu, bit);
  if ((threadIdx.x & 31) == 0) words[(long)q * W + i / 32] = w;
}

// Bit set over the block's queries: bit j = node v is in query (q0 + j)'s
// frontier.  Ids outside [0, N) -- the sentinel N -- read 0.
__device__ __forceinline__ uint32_t probe(const uint32_t* __restrict__ words,
                                          int v, int qn, int N, int W) {
  if ((unsigned)v >= (unsigned)N) return 0u;
  uint32_t hit = 0u;
  for (int j = 0; j < qn; ++j)
    hit |= ((__ldg(words + (long)j * W + (v >> 5)) >> (v & 31)) & 1u) << j;
  return hit;
}

template <bool kVec8>
__global__ void __launch_bounds__(kThreads)
frontier_hop_kernel(const uint32_t* __restrict__ words, const int* __restrict__ nbr,
                    const uint8_t* __restrict__ mask, uint8_t* __restrict__ out,
                    int Q, int N, int K, int W) {
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * kQG;
  const int qn = min(kQG, Q - q0);
  const uint32_t* wq = words + (long)q0 * W;
  const long n_warps = (long)gridDim.x * (kThreads / 32);
  for (long i = (long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); i < N;
       i += n_warps) {
    const uint8_t* mrow = mask + i * K;
    const int* nrow = nbr + i * K;
    uint32_t acc = 0u;
    if (kVec8) {
      for (int c = lane * 8; c < K; c += 32 * 8) {
        const uint2 m8 = __ldg(reinterpret_cast<const uint2*>(mrow + c));
        if ((m8.x | m8.y) == 0u) continue;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const uint32_t byte = ((b < 4 ? m8.x : m8.y) >> (8 * (b & 3))) & 0xffu;
          if (byte) acc |= probe(wq, __ldg(nrow + c + b), qn, N, W);
        }
      }
    } else {
      for (int c = lane; c < K; c += 32)
        if (__ldg(mrow + c)) acc |= probe(wq, __ldg(nrow + c), qn, N, W);
    }
    acc = __reduce_or_sync(0xffffffffu, acc);
    if (lane < qn) out[(long)(q0 + lane) * N + i] = (uint8_t)((acc >> lane) & 1u);
  }
}

}  // namespace

extern "C" {

// frontier (Q, N) bool, nbr (N, K) int32, mask (N, K) bool -> out (Q, N)
// bool.  words (Q, ceil(N / 32)) uint32 is caller-allocated scratch.  The
// 8-wide mask loads need K % 8 == 0 and an 8-byte aligned mask; other
// shapes take the one-slot-per-lane loop.  Returns the cudaError_t.
int bfs_frontier_hop(const uint8_t* frontier, const int* nbr, const uint8_t* mask,
                     uint8_t* out, uint32_t* words, int Q, int N, int K,
                     cudaStream_t stream) {
  const int W = (N + 31) / 32;
  const long pack_threads = (long)Q * W * 32;
  pack_frontier_kernel<<<(unsigned)((pack_threads + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(frontier, words, Q, N, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long rows_per_block = kThreads / 32;
  const dim3 grid((unsigned)((N + rows_per_block - 1) / rows_per_block),
                  (Q + kQG - 1) / kQG);
  const bool vec8 = K % 8 == 0 && (reinterpret_cast<uintptr_t>(mask) & 7u) == 0;
  if (vec8)
    frontier_hop_kernel<true><<<grid, kThreads, 0, stream>>>(words, nbr, mask, out, Q, N, K, W);
  else
    frontier_hop_kernel<false><<<grid, kThreads, 0, stream>>>(words, nbr, mask, out, Q, N, K, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
