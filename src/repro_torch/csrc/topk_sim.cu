// Fused similarity scoring + per-tile top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_sim/kernel.py:
// topk_sim_blocks (body _topk_sim_kernel): fp32 scores q . e for every
// candidate row, columns past the candidate count at -inf, and for each
// tile of c_blk candidates its top-k by k rounds of max/argmax with the
// lowest column winning ties.  The caller merges the per-tile lists.
//
// What bounds it on an H100: bytes.  Every candidate row is read once
// (N * D * 4 bytes: 86.7 MB for the 169,343 x 128 Arxiv-scale index, 26 us
// at 3.35 TB/s), while the arithmetic is 2 * Q flops per 4 bytes read --
// for the serving batch (Q = 4) two orders of magnitude under the card's
// fp32 rate per byte of bandwidth.
//
// What the design does about it: one block per (candidate tile, group of up
// to kQB queries).  The group's query rows sit in shared memory, so each
// candidate row streams from device memory once for all queries of the
// group (the TPU kernel pads Q to 128 and re-streams each tile per query
// block).  A warp owns a candidate row: its lanes read the row coalesced,
// multiply it with every query in full fp32 FMA (no TF32 anywhere) and
// reduce across the warp.  The tile's scores stay in shared memory, where
// one warp per query runs the k argmax rounds.  Tiles are small (256 rows)
// so that ~660 blocks keep every SM's loads in flight.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQB = 8;  // queries per block

// (value, column) order of the reference's argmax: larger value first,
// lower column first among equal values.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
topk_sim_tile_kernel(const float* __restrict__ q, const float* __restrict__ emb,
                     float* __restrict__ out_s, int* __restrict__ out_i,
                     int Q, int N, int D, int k, int c_blk, int n_tiles) {
  extern __shared__ float smem[];
  float* qs = smem;               // [kQB][D] query rows of this group
  float* sc = smem + kQB * D;     // [kQB][c_blk] scores of this tile
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * kQB;
  const int qn = min(kQB, Q - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kQB * D; i += kThreads) {
    const int j = i / D;
    qs[i] = j < qn ? q[(size_t)(q0 + j) * D + (i - j * D)] : 0.f;
  }
  __syncthreads();

  const long row0 = (long)tile * c_blk;
  for (int r = warp; r < c_blk; r += kWarps) {
    const long g = row0 + r;
    float acc[kQB];
#pragma unroll
    for (int j = 0; j < kQB; ++j) acc[j] = 0.f;
    if (g < N) {
      const float* e = emb + g * D;
#pragma unroll 4
      for (int d = lane; d < D; d += 32) {
        const float ev = __ldg(e + d);
#pragma unroll
        for (int j = 0; j < kQB; ++j) acc[j] = fmaf(ev, qs[j * D + d], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kQB; ++j) {
        if (j < qn) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kQB; ++j)
        if (j < qn) sc[j * c_blk + r] = g < N ? acc[j] : -CUDART_INF_F;
    }
  }
  __syncthreads();

  for (int j = warp; j < qn; j += kWarps) {
    float* s = sc + j * c_blk;
    const size_t out0 = ((size_t)(q0 + j) * n_tiles + tile) * k;
    for (int t = 0; t < k; ++t) {
      float bv = -CUDART_INF_F;
      int bi = c_blk;
      for (int c = lane; c < c_blk; c += 32) {
        const float v = s[c];
        if (better(v, c, bv, bi)) { bv = v; bi = c; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) {
        out_s[out0 + t] = bv;
        out_i[out0 + t] = (int)(row0 + bi);
        s[bi] = -CUDART_INF_F;  // mask the winner out, as the TPU kernel does
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// q (Q, D) f32, emb (N, D) f32 -> out_s / out_i (Q, n_tiles, k) with
// n_tiles = ceil(N / c_blk).  Returns the launch's cudaError_t.
int topk_sim_tiles(const float* q, const float* emb, float* out_s, int* out_i,
                   int Q, int N, int D, int k, int c_blk, cudaStream_t stream) {
  const int n_tiles = (N + c_blk - 1) / c_blk;
  const int smem = (int)(sizeof(float) * (size_t)kQB * (D + c_blk));
  cudaError_t err = cudaFuncSetAttribute(
      topk_sim_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, (Q + kQB - 1) / kQB);
  topk_sim_tile_kernel<<<grid, kThreads, smem, stream>>>(
      q, emb, out_s, out_i, Q, N, D, k, c_blk, n_tiles);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
