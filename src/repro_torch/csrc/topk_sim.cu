// Fused similarity scoring + top-k for Hopper (sm_90a): a scan kernel and a
// merge kernel, launched together by one call.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_sim/kernel.py:
// topk_sim_blocks (body _topk_sim_kernel) and the caller's cross-tile
// lax.top_k merge: fp32 scores q . e for every candidate row and the top k
// of each query, ordered by score descending and then the lower row id.
//
// What bounds it on an H100: bytes at the serving batch.  Every candidate
// row is read once (N * D * 4 bytes: 86.7 MB for the 169,343 x 128
// Arxiv-scale index, 26 us at 3.35 TB/s), and the arithmetic is 2 Q flops
// per 4 bytes; at Q = 64 the fp32 operations bound it (2 Q N D flops at
// 67 TFLOP/s, 41 us).
//
// What the design does about it:
//   * a persistent grid (a block an SM) in which each block owns a
//     contiguous range of tiles (64 rows at D = 128; 32 KB at most a tile),
//     streamed once for all its queries;
//   * one producer lane keeps a ring of kStages tiles in shared memory
//     filled, a tile one 1-D bulk copy (cp.async.bulk, full / empty
//     mbarriers) -- the "bulk" variant, for D % 4 == 0 and a 16-byte
//     aligned table -- or, for any other shape (a D % 4 != 0 row, an
//     unaligned view), plain loads by the producer warp's lanes (the
//     "plain" variant, the same kernel otherwise);
//   * 8 consumer warps score every tile, a warp for QW queries (up to 8 of
//     the group) and a slice of the tile's 32-row batches (8 / ceil(group /
//     QW) slices): lane group g (lanes 8 g .. 8 g + 7) takes 8 rows of the
//     batch, lane l of it reads 16-byte column units l, l + 8, ... of each
//     (8 lanes cover a row's consecutive units, so a quarter-warp's reads
//     hit every bank once) and the same units of each query, forms the 8
//     partial dot products in full fp32 FMAs (no TF32), and a transposed
//     butterfly (reduce-scatter over lane bits 2, 1, 0) leaves row l's
//     score in lane l: 7 shuffles a query for 32 rows, where a shuffle tree
//     a row would take 160.  A warp's QW dot products have no branch
//     between them, so their chains interleave;
//   * each (query, row slice) keeps a running top kk (kk = min(k, 256)),
//     owned by one warp, in its registers (a lane an entry) up to kk = 32,
//     else in shared memory; a row enters only if it beats the list's last
//     entry (a ballot over the batch's rows), one insertion at a time, or,
//     for 4 or more at once in a register list (its first batches), a
//     bitonic merge of the sorted batch into it; at the end the block
//     merges a query's slices into one list;
//   * each list goes to device memory whole, and the merge kernel (a block
//     a query) merges a query's lists through its shared memory
//     (topk_merge.cuh: k rounds of a block-wide arg-best where k times the
//     entries is small, else the tree merge) and writes the final (Q, k) scores and ids.  (The scan's last block merging every query measured slower
//     from Q = 4 up, and one block cannot merge 64 queries' lists in time.)
//     For k > 256 a block's range is at most 256 rows, all of which its
//     lists keep.
// The launch plan (variant, QW, query group, kk, grid) is computed by the
// Python wrapper (kernels/topk_sim/kernel.py: launch_plan) and checked here;
// the tile rows and shared memory are computed here (launch_plan mirrors
// them).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

using topk::Entry;
using topk::kCap;
using topk::kFull;

constexpr int kConsumers = 8;
constexpr int kThreads = (1 + kConsumers) * 32;  // a producer warp and the consumers
constexpr int kMaxTileRows = 64;
constexpr int kTileBytes = 32768;   // most bytes a tile holds
constexpr int kBatch = 32;          // rows a consumer warp scores at a time
constexpr int kLaneRows = 8;        // rows of a batch a lane holds partials of
constexpr int kMergeInsert = 4;     // candidates from which a register list merges the batch
constexpr int kStages = 4;
constexpr int kMaxGroup = 64;       // queries a block scores
constexpr int kGroupBytes = 32768;  // shared memory for the group's queries, and for its lists
constexpr int kStageAlign = 128;
constexpr int kMergeThreads = 256;
constexpr long long kMergeSmem = 227 * 1024;
constexpr int kDevices = 64;  // devices a process can launch on

enum Variant { kBulk = 0, kPlain = 1 };

__host__ __device__ inline int ceil4(int x) { return (x + 3) & ~3; }

// Rows a tile holds: 64, or fewer so that a tile stays within 32 KB.
__host__ __device__ inline int tile_rows(int D) {
  const int r = kTileBytes / (4 * ceil4(D));
  return r < kMaxTileRows ? r : kMaxTileRows;
}
__host__ __device__ inline int stage_bytes(int D) {
  return (tile_rows(D) * ceil4(D) * 4 + kStageAlign - 1) / kStageAlign * kStageAlign;
}

// The consumer warps of a block: qslices = ceil(group / qw) query slices of
// qw queries, times rslices = 8 / qslices row slices (warp (r, c) scores
// the tile's 8-row batches r, r + rslices, ... for slice c's queries).
__host__ __device__ inline int qslices(int group, int qw) { return (group + qw - 1) / qw; }
__host__ __device__ inline int rslices(int group, int qw) {
  return kConsumers / qslices(group, qw);
}

// Dynamic shared memory: the stages, the queries (zero past the group's
// last, up to qslices * qw), the warps' lists (rslices a query) twice (the
// block merges them into one a query), and a full and an empty barrier a
// stage.  kernel.py's scan_smem_bytes mirrors it.
__host__ __device__ inline int scan_smem_bytes(int D, int group, int qw, int kk) {
  return kStages * stage_bytes(D) + qslices(group, qw) * qw * ceil4(D) * 4 +
         2 * group * rslices(group, qw) * kk * 8 + 16 * kStages;
}

// Shared memory of a merge block: two copies of a query's lists at every
// level, or none (the merge then runs in device memory).
__host__ __device__ inline int merge_smem_bytes(long long stride) {
  return 16 * stride <= kMergeSmem ? (int)(16 * stride) : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// p[r]: this lane's partial of row r of its lane group's 8 rows (the group:
// lanes 8 g .. 8 g + 7, which split the row's 16-byte units).  Returns, in
// lane l, the whole sum of its group's row l & 7: halves of the rows are
// exchanged across lane bits 2, 1 and 0 (each lane keeps the half its bit
// selects and adds its partner's copy of it), 7 shuffles for 8 rows.
__device__ __forceinline__ float reduce_rows(const float (&p)[kLaneRows], int lane) {
  const bool b2 = lane & 4, b1 = lane & 2, b0 = lane & 1;
  float h[4], f[2];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    h[m] = (b2 ? p[m + 4] : p[m]) + __shfl_xor_sync(kFull, b2 ? p[m] : p[m + 4], 4);
#pragma unroll
  for (int m = 0; m < 2; ++m)
    f[m] = (b1 ? h[m + 2] : h[m]) + __shfl_xor_sync(kFull, b1 ? h[m] : h[m + 2], 2);
  return (b0 ? f[1] : f[0]) + __shfl_xor_sync(kFull, b0 ? f[0] : f[1], 1);
}

// One block: tiles [t0, t1) (the grid splits the tiles evenly) for queries
// [q0, q0 + qn); writes each query's top-kk list of its range to
// pool[query][blockIdx.x].
template <int QW, int kVariant>
__global__ void __launch_bounds__(kThreads, 1)
topk_sim_scan_kernel(const float* __restrict__ q, const float* __restrict__ emb,
                     Entry* __restrict__ pool, int Q, int N, int D, int group, int kk,
                     long long stride) {
  extern __shared__ __align__(kStageAlign) uint8_t smem[];
  const int D4 = ceil4(D);
  const int rows = tile_rows(D);
  const int sbytes = stage_bytes(D);
  const int nqs = qslices(group, QW), nrs = rslices(group, QW);
  float* qs = reinterpret_cast<float*>(smem + kStages * sbytes);  // [nqs * QW][D4]
  Entry* lists = reinterpret_cast<Entry*>(qs + nqs * QW * D4);    // [group][nrs][kk]
  Entry* spare = lists + group * nrs * kk;                        // the block merge's other half
  uint64_t* full = reinterpret_cast<uint64_t*>(spare + group * nrs * kk);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * group;
  const int qn = min(group, Q - q0);
  const int n_tiles = (N + rows - 1) / rows;
  const int t0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  const int active = nrs * qslices(qn, QW);  // consumer warps with a query

  for (int i = threadIdx.x; i < nqs * QW * D4; i += kThreads) {
    const int j = i / D4, d = i - j * D4;
    qs[i] = j < qn && d < D ? q[(long long)(q0 + j) * D + d] : 0.f;
  }
  for (int i = threadIdx.x; i < qn * nrs * kk; i += kThreads) lists[i] = topk::pad_entry();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kVariant == kBulk ? 1 : 32);
      mbar_init(&empty[s], active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // the producer
    for (int i = 0; i < t1 - t0; ++i) {
      const int s = i % kStages;
      const long long row0 = (long long)(t0 + i) * rows;
      const int nr = (int)min((long long)rows, N - row0);
      float* st = reinterpret_cast<float*>(smem + s * sbytes);
      if (lane == 0 && i >= kStages) mbar_wait(&empty[s], (uint32_t)((i / kStages - 1) & 1));
      __syncwarp();
      if (kVariant == kBulk) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], (uint32_t)(nr * D * 4));
          bulk_load(st, emb + row0 * D, (uint32_t)(nr * D * 4), &full[s]);
        }
      } else {
#pragma unroll 4
        for (int x = lane; x < nr * D4; x += 32) {
          const int r = x / D4, c = x - r * D4;
          st[x] = c < D ? __ldg(emb + (row0 + r) * D + c) : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else if (warp - 1 < active) {
    // a consumer: row slice rs, queries [qw0, qw0 + QW) of the group (all
    // QW scored, those past the group against zero query rows, so that the
    // queries' chains interleave; only live ones are offered)
    const int rs = (warp - 1) / qslices(qn, QW);
    const int qw0 = ((warp - 1) % qslices(qn, QW)) * QW;
    const int units = D4 / 4;
    const float4* q4 = reinterpret_cast<const float4*>(qs) + (long long)qw0 * units;
    const bool in_regs = kk <= 32;  // each list in registers, lane p entry p
    Entry reg[QW], last[QW];
#pragma unroll
    for (int j = 0; j < QW; ++j) reg[j] = last[j] = topk::pad_entry();
    for (int i = 0; i < t1 - t0; ++i) {
      const int s = i % kStages;
      const long long row0 = (long long)(t0 + i) * rows;
      const int nr = (int)min((long long)rows, N - row0);
      mbar_wait(&full[s], (uint32_t)((i / kStages) & 1));
      const float4* st = reinterpret_cast<const float4*>(smem + s * sbytes);
      for (int b0 = rs * kBatch; b0 < nr; b0 += nrs * kBatch) {
        // lane group g = lane >> 3 holds rows b0 + 8 g .. + 7, lane l & 7
        // of it units l & 7, (l & 7) + 8, ...
        const int g0 = b0 + (lane >> 3) * kLaneRows;
        float p[QW][kLaneRows];
#pragma unroll
        for (int j = 0; j < QW; ++j)
#pragma unroll
          for (int r = 0; r < kLaneRows; ++r) p[j][r] = 0.f;
        for (int u = lane & 7; u < units; u += 8) {
          float4 x[kLaneRows];
#pragma unroll
          for (int r = 0; r < kLaneRows; ++r)
            x[r] = g0 + r < nr ? st[(g0 + r) * units + u] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < QW; ++j) {
            const float4 y = q4[j * units + u];
#pragma unroll
            for (int r = 0; r < kLaneRows; ++r)
              p[j][r] = fmaf(x[r].w, y.w, fmaf(x[r].z, y.z, fmaf(x[r].y, y.y,
                                                                 fmaf(x[r].x, y.x, p[j][r]))));
          }
        }
        float sc[QW];
#pragma unroll
        for (int j = 0; j < QW; ++j) sc[j] = reduce_rows(p[j], lane);
        // offer the batch's rows to each query's list: lane l holds row b0 + l
        const int r = b0 + lane;
#pragma unroll
        for (int j = 0; j < QW; ++j) {
          if (qw0 + j >= qn) break;
          Entry* list = lists + ((qw0 + j) * nrs + rs) * kk;
          const Entry mine{sc[j], (int)(row0 + r)};
          if (!in_regs) last[j] = list[kk - 1];
          unsigned bits = __ballot_sync(kFull, r < nr && topk::better(mine, last[j]));
          if (in_regs && __popc(bits) >= kMergeInsert) {  // a list's early batches
            last[j] = topk::reg_merge(reg[j], kk, (bits >> lane) & 1 ? mine : topk::pad_entry(),
                                      lane);
            continue;
          }
          while (bits) {
            const int src = __ffs(bits) - 1;
            bits &= bits - 1;
            const Entry v{__shfl_sync(kFull, mine.s, src), __shfl_sync(kFull, mine.i, src)};
            if (in_regs) last[j] = topk::reg_insert(reg[j], kk, v, lane);
            else topk::list_insert(list, kk, v, lane);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (in_regs) {
#pragma unroll
      for (int j = 0; j < QW; ++j)
        if (qw0 + j < qn && lane < kk) lists[((qw0 + j) * nrs + rs) * kk + lane] = reg[j];
    }
  }
  __syncthreads();
  // the row slices' lists of a query into one (the top kk of the block's
  // range), then to device memory
  const Entry* fin = topk::merge_tree(lists, spare, qn, nrs, kk, kk, (long long)nrs * kk);
  for (int j = warp; j < qn; j += kThreads / 32) {
    Entry* dst = pool + (q0 + j) * stride + (long long)blockIdx.x * kk;
    for (int x = lane; x < kk; x += 32) dst[x] = fin[(long long)j * nrs * kk + x];
  }
}

// The merge: block q merges query q's n lists into its top k.
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(Entry* __restrict__ pool, Entry* __restrict__ tree, float* __restrict__ out_s,
                  int* __restrict__ out_i, int n, int kk, int k, long long stride) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long q = blockIdx.x;
  topk::merge_out(pool + q * stride, tree + q * stride, 1, n, kk, k, stride,
                  reinterpret_cast<Entry*>(smem), merge_smem_bytes(stride) / 8, out_s + q * k,
                  out_i + q * k, nullptr);
}

int merge_limit[kDevices] = {};  // the merge kernel's raised shared-memory limit, a device

template <int QW, int V>
int launch(const float* q, const float* emb, float* out_s, int* out_i, Entry* pool, Entry* tree,
           int Q, int N, int D, int k, int group, int kk, int grid_x, long long stride,
           cudaStream_t stream) {
  // each kernel's shared-memory limit is raised when a launch needs more
  // than it was raised to on the device (a host call a launch otherwise)
  static int scan_limit[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  const int smem = scan_smem_bytes(D, group, QW, kk);
  if (smem > scan_limit[dev]) {
    err = cudaFuncSetAttribute(topk_sim_scan_kernel<QW, V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    scan_limit[dev] = smem;
  }
  const int msmem = merge_smem_bytes(stride);
  if (msmem > merge_limit[dev]) {
    err = cudaFuncSetAttribute(topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               msmem);
    if (err != cudaSuccess) return (int)err;
    merge_limit[dev] = msmem;
  }
  const dim3 grid((unsigned)grid_x, (unsigned)((Q + group - 1) / group));
  topk_sim_scan_kernel<QW, V><<<grid, kThreads, smem, stream>>>(q, emb, pool, Q, N, D, group, kk,
                                                                stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<(unsigned)Q, kMergeThreads, msmem, stream>>>(pool, tree, out_s, out_i,
                                                                    grid_x, kk, k, stride);
  return (int)cudaGetLastError();
}

template <int V>
int launch_qw(int qw, const float* q, const float* emb, float* out_s, int* out_i, Entry* pool,
              Entry* tree, int Q, int N, int D, int k, int group, int kk, int grid_x,
              long long stride, cudaStream_t stream) {
  switch (qw) {
    case 1: return launch<1, V>(q, emb, out_s, out_i, pool, tree, Q, N, D, k, group, kk, grid_x,
                                stride, stream);
    case 2: return launch<2, V>(q, emb, out_s, out_i, pool, tree, Q, N, D, k, group, kk, grid_x,
                                stride, stream);
    case 4: return launch<4, V>(q, emb, out_s, out_i, pool, tree, Q, N, D, k, group, kk, grid_x,
                                stride, stream);
    case 8: return launch<8, V>(q, emb, out_s, out_i, pool, tree, Q, N, D, k, group, kk, grid_x,
                                stride, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (Q, D) f32, emb (N, D) f32 -> out_s (Q, k) f32, out_i (Q, k) int32, the
// top k by (score desc, id asc), 1 <= k <= N: the scan kernel, then the
// merge kernel, on `stream`.  pool and tree are caller scratch of Q * stride
// entries each.  The plan (variant, qw, group, kk, grid_x, stride) comes
// from kernel.py's launch_plan; a plan the shapes or the table's alignment
// do not allow returns cudaErrorInvalidValue without launching.  Returns
// the cudaError_t.
int topk_sim_scan(const float* q, const float* emb, float* out_s, int* out_i, void* pool,
                  void* tree, int Q, int N, int D, int k, int variant, int qw, int group, int kk,
                  int grid_x, long long stride, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(emb);
  const bool large = k > kCap;
  const int rows = D > 0 ? tile_rows(D) : 0;
  const int n_tiles = rows > 0 ? (N + rows - 1) / rows : 0;
  bool ok = Q > 0 && N > 0 && rows >= 1 && 1 <= k && k <= N && kk == (large ? kCap : k) &&
            group >= 1 && group <= kMaxGroup && (qw == 1 || qw == 2 || qw == 4 || qw == 8) &&
            qw * kConsumers >= group && qslices(group, qw) * qw * ceil4(D) * 4 <= kGroupBytes &&
            group * rslices(group, qw) * kk * 8 <= kGroupBytes && grid_x >= 1 && grid_x <= n_tiles &&
            (Q + group - 1) / group <= 65535 && stride >= topk::merge_stride(grid_x, kk, k);
  if (ok && large)  // a block's range, at most ceil(n_tiles / grid_x) tiles, fits a list
    ok = (n_tiles + grid_x - 1) / grid_x * rows <= kCap;
  if (variant == kBulk)
    ok = ok && D % 4 == 0 && (addr & 15u) == 0;
  else
    ok = ok && variant == kPlain;
  if (!ok) return (int)cudaErrorInvalidValue;
  Entry* p = static_cast<Entry*>(pool);
  Entry* t = static_cast<Entry*>(tree);
  if (variant == kBulk)
    return launch_qw<kBulk>(qw, q, emb, out_s, out_i, p, t, Q, N, D, k, group, kk, grid_x, stride,
                            stream);
  return launch_qw<kPlain>(qw, q, emb, out_s, out_i, p, t, Q, N, D, k, group, kk, grid_x, stride,
                           stream);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
