// IVF candidate scan (gather + score + top-k) for Hopper (sm_90a), one
// launch a call.
//
// Replaces src/repro/kernels/ivf_scan/kernel.py: ivf_scan_tiled (a blocked
// lax.scan, not a pallas_call) and the dense src/repro/kernels/ivf_scan/ref.py
// ivf_candidate_scan, which compute the same function: for each query q and
// each of its W candidate slots, score = q . emb[cand[q, w]] where cmask is
// set and -inf where it is not (sentinel ids N are clamped for the gather and
// never score), then the top k by (score desc, candidate position asc), with
// the raw cand values at the winning positions -- so rows with fewer than k
// live slots return the lowest-position masked slots' ids, as the reference
// does.
//
// What bounds it on an H100: bytes.  Every candidate slot's id (4 B) and mask
// (1 B) is read once, and every live candidate's embedding row (4 D bytes).
// At the serving shape (Q = 4, W = 14,916 slots of nprobe 4 lists on the
// 169,343-node Arxiv-scale index, D = 128) that is at most 30.8 MB, 9.2 us at
// 3.35 TB/s (fewer where slots are masked); 2 D flops per live candidate are
// far under the fp32 rate.
//
// What the design does about it: a grid of (slot range, query) blocks of 8
// warps, sized to fill the card (kernel.py: launch_plan).  A warp walks its
// runs of 32 slots: it reads the run's ids and masks (a slot a lane,
// coalesced), compacts the live slots with a ballot, and gathers their
// embedding rows kRows at a time, every lane's loads of all kRows rows
// issued before any is used (kRows * D / 32 loads in flight a lane; masked
// slots never touch the table).  The dot product is summed in a fixed order
// -- rounded products, lane l summing columns l, l + 32, ... in order from
// +0, then a halving shuffle tree, with no contraction into FMAs -- which
// ref.py's dot_scores repeats, so kernel and plain version agree bit for
// bit.  Each warp keeps a running top kk (kk = min(k, 256)) of (score,
// position), in its registers (a lane an entry) up to kk = 32, else in
// shared memory, which a candidate enters only if it beats the last entry;
// masked slots enter as (-inf, position) while a list still has room for
// them.  Each list goes to device memory whole, and the block that
// takes its query's last ticket merges the query's lists (topk_merge.cuh:
// through shared memory where they fit, k rounds of a block-wide arg-best
// where k times the entries is small, else the tree merge) and writes the
// final scores and cand[q, position] ids.  For k > 256 a warp's runs span
// at most 256 slots, all of which its list keeps.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

using topk::Entry;
using topk::kCap;
using topk::kFull;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRun = 32;   // slots a warp reads at a time
constexpr int kRows = 8;   // live rows a warp gathers at a time
constexpr int kCols = 4;   // columns a lane loads of a row per 128-column block
constexpr int kDevices = 64;  // devices a process can launch on

constexpr long long kStageBytes = 64 * 1024;  // most shared memory a block stages a merge in

// Shared memory the last block stages a query's merge in (two copies of
// its lists at every level), or 0: the merge then runs in device memory.
__host__ __device__ inline int stage_bytes(long long stride) {
  return 16 * stride <= kStageBytes ? (int)(16 * stride) : 0;
}

// Dynamic shared memory: the query row, then the warps' lists -- the same
// bytes as the last block's merge stage.  kernel.py mirrors it.
__host__ __device__ inline int ivf_smem_bytes(int D, int kk, long long stride) {
  const int lists = kWarps * kk * 8;
  const int stage = stage_bytes(stride);
  return (D * 4 + 15) / 16 * 16 + (lists > stage ? lists : stage);
}

__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const float* __restrict__ q, const float* __restrict__ emb,
                const int* __restrict__ cand, const uint8_t* __restrict__ cmask,
                float* __restrict__ out_s, int* __restrict__ out_i, Entry* __restrict__ pool,
                Entry* __restrict__ tree, unsigned long long* __restrict__ ws, int Q, int N,
                int D, int W, int k, int kk, int span, long long stride) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);                             // [D]
  Entry* lists = reinterpret_cast<Entry*>(smem + (D * 4 + 15) / 16 * 16);  // [kWarps][kk]
  const int qi = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < D; d += kThreads) qs[d] = q[(long long)qi * D + d];
  for (int i = threadIdx.x; i < kWarps * kk; i += kThreads) lists[i] = topk::pad_entry();
  __syncthreads();

  Entry* list = lists + warp * kk;
  const bool in_regs = kk <= 32;   // the list in registers, lane p entry p
  Entry reg = topk::pad_entry();
  Entry last = topk::pad_entry();  // the list's last entry: what a candidate must beat
  const int* crow = cand + (long long)qi * W;
  const uint8_t* mrow = cmask + (long long)qi * W;
  const int s0 = blockIdx.x * span;
  const int s1 = min(W, s0 + span);
  for (int base = s0 + warp * kRun; base < s1; base += kWarps * kRun) {
    const int p = base + lane;
    const bool in = p < s1;
    const int id = in ? __ldg(crow + p) : 0;
    const bool live = in && __ldg(mrow + p) != 0;
    // masked slots score -inf: they enter only while the list ends in -inf
    if (last.s == -CUDART_INF_F) {
      unsigned bits = __ballot_sync(kFull, in && !live && p < last.i);
      while (bits) {
        const int src = __ffs(bits) - 1;
        bits &= bits - 1;
        const Entry v{-CUDART_INF_F, base + src};
        if (in_regs) {
          last = topk::reg_insert(reg, kk, v, lane);
        } else {
          topk::list_insert(list, kk, v, lane);
          last = list[kk - 1];
        }
      }
    }
    unsigned bits = __ballot_sync(kFull, live);
    while (bits) {
      int src[kRows];
      int n = 0;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        src[u] = bits ? __ffs(bits) - 1 : 0;
        if (bits) ++n;
        bits &= bits - 1;
      }
      const float* e[kRows];
      float acc[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int rid = min(max(__shfl_sync(kFull, id, src[u]), 0), N - 1);
        e[u] = emb + (long long)rid * D;
        acc[u] = 0.f;
      }
      for (int c0 = 0; c0 < D; c0 += 32 * kCols) {
        float v[kRows][kCols];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int m = 0; m < kCols; ++m) {
            const int d = c0 + lane + 32 * m;
            v[u][m] = u < n && d < D ? __ldg(e[u] + d) : 0.f;
          }
#pragma unroll
        for (int m = 0; m < kCols; ++m) {
          const int d = c0 + lane + 32 * m;
          if (d < D) {
            const float qd = qs[d];
#pragma unroll
            for (int u = 0; u < kRows; ++u) acc[u] = __fadd_rn(acc[u], __fmul_rn(v[u][m], qd));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[u] = __fadd_rn(acc[u], __shfl_xor_sync(kFull, acc[u], o));
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const Entry c{acc[u], base + src[u]};
        if (u < n && topk::better(c, last)) {
          if (in_regs) {
            last = topk::reg_insert(reg, kk, c, lane);
          } else {
            topk::list_insert(list, kk, c, lane);
            last = list[kk - 1];
          }
        }
      }
    }
  }
  __syncwarp();

  // the list whole to device memory; the query's last block merges them
  Entry* qpool = pool + (long long)qi * stride;
  Entry* dst = qpool + (long long)(blockIdx.x * kWarps + warp) * kk;
  for (int x = lane; x < kk; x += 32) dst[x] = in_regs ? reg : list[x];
  if (!topk::last_block(ws + qi, gridDim.x)) return;
  topk::merge_out(qpool, tree + (long long)qi * stride, 1, gridDim.x * kWarps, kk, k, stride,
                  lists, stage_bytes(stride) / 8, out_s + (long long)qi * k,
                  out_i + (long long)qi * k, crow);
}

}  // namespace

extern "C" {

// q (Q, D) f32, emb (N, D) f32, cand (Q, W) int32, cmask (Q, W) bool ->
// out_s (Q, k) f32, out_i (Q, k) int32: the top k by (score desc, position
// asc), 1 <= k <= W, ids read from cand.  pool and tree are caller scratch
// of Q * stride entries each; ws holds Q tickets, zero on entry and left
// zero.
// The plan (kk, slots a block, grid_x, stride) comes from kernel.py's
// launch_plan; a plan the shapes do not allow returns
// cudaErrorInvalidValue without launching.  Returns the cudaError_t.
int ivf_scan(const float* q, const float* emb, const int* cand, const uint8_t* cmask,
             float* out_s, int* out_i, void* pool, void* tree, unsigned long long* ws, int Q,
             int N, int D, int W, int k, int kk, int span, int grid_x, long long stride,
             cudaStream_t stream) {
  const bool large = k > kCap;
  const long long lists = (long long)grid_x * kWarps;
  bool ok = Q > 0 && Q <= 65535 && N > 0 && D > 0 && W > 0 && 1 <= k && k <= W &&
            kk == (large ? kCap : k) && span > 0 && span % kRun == 0 &&
            grid_x == (W + span - 1) / span && stride >= topk::merge_stride((int)lists, kk, k);
  if (ok && large) ok = span <= kWarps * kCap;
  if (!ok) return (int)cudaErrorInvalidValue;
  // the kernel's shared-memory limit is raised when a launch needs more than
  // it was raised to on the device (a host call a launch otherwise)
  static int limit[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  const int smem = ivf_smem_bytes(D, kk, stride);
  if (smem > limit[dev]) {
    err = cudaFuncSetAttribute(ivf_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    limit[dev] = smem;
  }
  ivf_scan_kernel<<<dim3((unsigned)grid_x, (unsigned)Q), kThreads, smem, stream>>>(
      q, emb, cand, cmask, out_s, out_i, static_cast<Entry*>(pool), static_cast<Entry*>(tree),
      ws, Q, N, D, W, k, kk, span, stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
