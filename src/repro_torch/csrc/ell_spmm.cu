// Batched ELL neighbour aggregation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ell_spmm/kernel.py:
// ell_aggregate_kernel (body _ell_kernel):
//   out[q, i, :] = sum_k mask[q, i, k] * feat[q, nbr[q, i, k], :]
// over per-query feature tiles (Q queries x M <= ~1k subgraph nodes, K = 8..64
// neighbour slots), fp32 accumulation, output in feat's dtype (fp32 or bf16).
// A slot counts when its mask is set and its id lies in [0, M); an id of M or
// more is the zero sentinel (the reference clamps it onto its appended zero
// row), so no padded copy of feat is made.  Slots are added one after another
// in slot order, in fp32 with no contraction, which is what the plain version
// (ref.py, the TPU kernel's unrolled K loop) does: the two agree bit for bit.
//
// What bounds it on an H100: bytes.  Each input is read once and the output
// written once: at Q = 64, M = 1024, K = 32, D = 128 in fp32 that is feat
// 33.6 MB + ids 8.4 MB + mask 2.1 MB + out 33.6 MB = 77.6 MB, 23 us at
// 3.35 TB/s; the adds (Q * M * K * D, 0.27 G) are far under the fp32 rate.
// But the gathers read a feature row once per live slot: Q * M * K * D * 4 =
// 1.07 GB at that shape if every slot were live, 32x the tile.
//
// What the design does about it: a block owns 8 output rows of one query,
// one warp per row.  The warp loads 32 slot ids and masks at once
// (coalesced), takes a ballot of the live slots and walks them in slot
// order; for each it reads the neighbour's feature row with coalesced loads
// (lane l holds columns l, l + 32, l + 64, l + 96 of a 128-column slab) and
// adds it into four fp32 registers.  Dead slots cost no feature read.  The
// TPU kernel keeps the query's whole (M+1, D) tile in VMEM; here that tile
// (525 KB at M = 1024, D = 128, fp32) does not fit the 227 KB of shared
// memory a block can have, so this first kernel reads the rows through L2:
// the re-reads of a query's tile (33.6 MB for all queries, under the 50 MB
// L2) hit in L2 and not device memory while the blocks of a few queries are
// in flight.  Staging would take column slabs: 32 of the D columns of a
// query's tile are (M+1) * 32 * 4 = 131 KB, so a block could hold one slab in
// shared memory and serve all M rows' gathers from it, D / 32 passes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // output rows per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;   // columns per lane per slab
constexpr int kSlab = 32 * kCols;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_aggregate_kernel(const T* __restrict__ feat, const int* __restrict__ nbr,
                     const uint8_t* __restrict__ mask, T* __restrict__ out,
                     int M, int K, int D, int row_blocks) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = blockIdx.x / row_blocks;
  const int row = (blockIdx.x - (int)(q * row_blocks)) * kWarps + warp;
  if (row >= M) return;  // whole warp: no shuffles below are left half-done
  const T* ftile = feat + q * M * D;
  const long long slot0 = (q * M + row) * K;
  T* orow = out + (q * M + row) * D;

  for (int c0 = 0; c0 < D; c0 += kSlab) {
    float acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
    for (int s0 = 0; s0 < K; s0 += 32) {
      const int s = s0 + lane;
      int id = 0;
      bool live = false;
      if (s < K) {
        id = __ldg(nbr + slot0 + s);
        live = __ldg(mask + slot0 + s) != 0 && (unsigned)id < (unsigned)M;
      }
      unsigned bits = __ballot_sync(0xffffffffu, live);
      while (bits) {  // live slots in slot order
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        const T* f = ftile + (long long)__shfl_sync(0xffffffffu, id, j) * D;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = c0 + c * 32 + lane;
          if (d < D) acc[c] = __fadd_rn(acc[c], to_f32(__ldg(f + d)));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = c0 + c * 32 + lane;
      if (d < D) store(orow + d, acc[c]);
    }
  }
}

template <typename T>
int launch(const void* feat, const int* nbr, const uint8_t* mask, void* out,
           int Q, int M, int K, int D, cudaStream_t stream) {
  const int row_blocks = (M + kWarps - 1) / kWarps;
  const long long blocks = (long long)Q * row_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ell_aggregate_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(feat), nbr, mask, static_cast<T*>(out), M, K, D, row_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// feat (Q, M, D), nbr (Q, M, K) int32, mask (Q, M, K) bool -> out (Q, M, D);
// dtype 0 = fp32, 1 = bf16 (feat and out).  Returns the launch's cudaError_t.
int ell_aggregate(const void* feat, const int* nbr, const uint8_t* mask, void* out,
                  int Q, int M, int K, int D, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch<float>(feat, nbr, mask, out, Q, M, K, D, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(feat, nbr, mask, out, Q, M, K, D, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
