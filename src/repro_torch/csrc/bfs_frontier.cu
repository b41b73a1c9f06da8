// One pull-BFS frontier hop for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bfs_frontier/kernel.py:
// frontier_hop_kernel (body _hop_kernel):
//   reach[q, i] = OR_k (mask[i, k] && frontier[q, nbr[i, k]]),
// where neighbour id N is the sentinel and reads 0.
//
// What bounds it on an H100: bytes.  The mask may be anything, so every
// mask byte must be read (N * K bytes: 172 MB for the Arxiv-scale graph,
// K = 1016, of which 98.5-99.2% are dead slots), and the neighbour id of
// every live slot (4 bytes each); the frontier test itself is a few
// integer operations per live slot.
//
// What the design does about it:
//   * pack pass: words[g, v] holds node v's frontier bits for query group
//     g (32 queries), so one load probes a node for the whole group (N
//     words a group: 677 KB at N = 169,343, resident in L2); for the bulk
//     variant the same pass zeroes the reach;
//   * hop pass, bulk variant (K % 8 == 0, 16-byte aligned mask and ids): a
//     persistent grid, two blocks an SM (registers held to 60 a thread for
//     it), walks tiles of R consecutive rows, R a multiple of 16, so a
//     tile's mask is one contiguous, 16-byte aligned run of R * K bytes
//     (R = 32: 32,512 bytes at K = 1016).  A block has
//     three warp roles.  One producer thread keeps a ring of 2 stages filled
//     by one-dimensional bulk copies (cp.async.bulk; a full and an empty
//     mbarrier a stage).  8 scanner warps read the current stage with
//     16-byte shared loads, each its R / 8 rows, and mark which 16-byte
//     chunks hold a live slot in the tile's live-chunk bitmap (a ballot a
//     32-chunk group), one of a ring in shared memory handed on through
//     mbarriers.  8 prober warps walk the handed-on bitmaps a live chunk a
//     lane: its 16 mask bytes, the neighbour ids of its live slots (a
//     16-byte load a quarter-chunk that holds one; no id of a dead quarter
//     is read), each id's word of query bits, and a
//     store of 1 to every reach byte hit (the pack zeroed `out`).  So the
//     gathers of live slots overlap the stream of the mask instead of
//     stalling it, and the mask is streamed once for all query groups.  A
//     tile whose size is not a multiple of 16 bytes (the graph's last tile,
//     R * K = 8 mod 16) copies all but its last 8 bytes and reads those
//     directly.  (Designs tried on the H100 on the way were slower: scanning
//     warps that probed their own chunks, since every live chunk's
//     dependent loads stalled the scan, and a scan kernel followed by a
//     probe kernel, since the probes then no longer overlapped the stream.)
//   * hop pass, row variant (any other K or alignment, or a ring that
//     would not fit in shared memory): a warp owns a node row and reads it
//     once for all queries, 8 slots a lane at a time where K % 8 == 0 and
//     the mask is 8-byte aligned, else one.
// The launch plan (variant, rows per tile, grid) is computed by the
// Python wrapper (kernels/bfs_frontier/kernel.py: launch_plan) and checked
// here; the shared memory it needs is computed here (launch_plan mirrors
// the sum to decide whether the ring fits).  The ELL layout itself is the reference's (dead slots
// included).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQG = 32;  // queries per hop block (bits of the OR word)
constexpr int kStages = 2;  // bulk: ring stages (on the H100, 3 and 4 were slower)
constexpr int kStageAlign = 128;
constexpr int kScanners = 8;  // bulk: scanner warps a block, each a slice of every tile
constexpr int kProbers = 8;   // bulk: prober warps a block
constexpr int kHopThreads = (1 + kScanners + kProbers) * 32;  // and one producer warp
constexpr int kBitmaps = 4;    // bulk: tiles' live-chunk bitmaps in flight to the probers
constexpr int kProbeWords = 8;  // bulk: bitmap words a prober takes at a time
constexpr unsigned kFull = 0xffffffffu;

enum Variant { kBulk = 0, kRows8 = 1, kRows = 2 };

// words[g, v] bit j = frontier[32 g + j, v]: a word a node for each group
// of 32 queries, so that one load probes a node for all of them.  Where
// `zero` is not null (the bulk variant, whose probers store only hits),
// it also sets zero[32 g + j, v] = 0.
__global__ void __launch_bounds__(kThreads)
pack_frontier_kernel(const uint8_t* __restrict__ f, uint32_t* __restrict__ words,
                     uint8_t* __restrict__ zero, int Q, int N) {
  const long t = (long)blockIdx.x * kThreads + threadIdx.x;
  const int groups = (Q + kQG - 1) / kQG;
  if (t >= (long)groups * N) return;
  const int g = (int)(t / N);
  const long v = t - (long)g * N;
  const int q0 = g * kQG;
  const int qn = min(kQG, Q - q0);
  uint32_t w = 0u;
  for (int j = 0; j < qn; ++j) {
    const long at = (long)(q0 + j) * N + v;
    w |= (f[at] != 0 ? 1u : 0u) << j;
    if (zero) zero[at] = 0;
  }
  words[t] = w;
}

// Bit set over the group's queries: bit j = node v is in query (32 g + j)'s
// frontier.  Ids outside [0, N) -- the sentinel N -- read 0.
__device__ __forceinline__ uint32_t probe(const uint32_t* __restrict__ wg, int v, int N) {
  return (unsigned)v < (unsigned)N ? __ldg(wg + v) : 0u;
}

// ---------------------------------------------------------------- bulk ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival that also announces the bytes the stage's copy will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
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

__host__ __device__ __forceinline__ int stage_bytes(int rows, int K) {
  return (rows * K + kStageAlign - 1) / kStageAlign * kStageAlign;
}

// Words of a tile's live-chunk bitmap: a bit for each 16-byte chunk.
__host__ __device__ __forceinline__ int tile_words(int rows, int K) {
  return ((rows * K + 15) / 16 + 31) / 32;
}

// Dynamic shared memory of the bulk variant: the stages, the tiles' bitmap
// ring, the probers' lists, a full and an empty barrier a stage and a
// bitmap.  kernel.py's bulk_smem_bytes computes the same sum.
__host__ __device__ __forceinline__ int bulk_smem_bytes(int rows, int K) {
  return kStages * stage_bytes(rows, K) + 4 * kBitmaps * tile_words(rows, K) +
         4 * kProbers * 32 * kProbeWords + 16 * (kStages + kBitmaps);
}

// Issue tile `tile`'s mask into `stage`: all of it but a last 8 bytes that
// do not make a 16-byte unit (the scan reads those directly).
__device__ __forceinline__ void issue_tile(const uint8_t* __restrict__ mask, uint8_t* stage,
                                           uint64_t* bar, int tile, int rows, int N, int K) {
  const long r0 = (long)tile * rows;
  const int nr = min(rows, (int)(N - r0));
  const uint32_t copy = (uint32_t)(nr * K) & ~15u;
  mbar_expect_tx(bar, copy);
  if (copy) bulk_load(stage, mask + r0 * K, copy, bar);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void shared_or(uint32_t* p, uint32_t v) {
  asm volatile("red.shared::cta.or.b32 [%0], %1;\n" ::"r"(smem_u32(p)), "r"(v) : "memory");
}

// The bulk variant, one kernel of three warp roles.  A producer warp keeps
// a ring of kStages mask tiles filled by bulk copies.  kScanners scanner
// warps each scan their rows of every tile (their slice) from shared memory,
// a ballot a 32-chunk group, and OR the group's bits into the tile's
// live-chunk bitmap, one of a ring of kBitmaps in shared memory; then they
// release the stage and hand the bitmap on.  kProbers prober warps each take
// kProbeWords words of a handed-on bitmap, list their live chunks (a warp
// prefix sum places each lane's), and walk the list a chunk a lane: the 16
// mask bytes (8 for the mask's last chunk when N * K = 8 mod 16; from device
// memory, where the stage may already hold the next tile), the neighbour
// ids of the live slots only, and each id's word of query bits for every
// query group, and store 1 to every reach byte hit (the pack kernel zeroed
// `out`).  Probing thus overlaps the stream instead of following it.
__global__ void __launch_bounds__(kHopThreads, 2)
frontier_hop_bulk_kernel(const uint32_t* __restrict__ words, const int* __restrict__ nbr,
                         const uint8_t* __restrict__ mask, uint8_t* __restrict__ out, int Q,
                         int N, int K, int rows) {
  extern __shared__ __align__(kStageAlign) uint8_t smem[];
  const int sbytes = stage_bytes(rows, K);
  const int tw = tile_words(rows, K);
  uint32_t* bitmaps = reinterpret_cast<uint32_t*>(smem + kStages * sbytes);  // [kBitmaps][tw]
  uint32_t* lists = bitmaps + kBitmaps * tw;                     // [kProbers][32 * kProbeWords]
  uint64_t* full = reinterpret_cast<uint64_t*>(lists + kProbers * 32 * kProbeWords);
  uint64_t* empty = full + kStages;     // [kStages]: scanners -> producer
  uint64_t* bm_full = empty + kStages;  // [kBitmaps]: scanners -> probers
  uint64_t* bm_empty = bm_full + kBitmaps;  // [kBitmaps]: probers -> scanners
  const int tiles = (N + rows - 1) / rows;
  // this block's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int mine = (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kBitmaps * tw; i += kHopThreads) bitmaps[i] = 0u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kScanners);
    }
    for (int d = 0; d < kBitmaps; ++d) {
      mbar_init(&bm_full[d], kScanners);
      mbar_init(&bm_empty[d], kProbers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < mine; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], (uint32_t)((i / kStages - 1) & 1));
        issue_tile(mask, smem + s * sbytes, &full[s], blockIdx.x + i * gridDim.x, rows, N, K);
      }
    }
    return;
  }

  if (warp <= kScanners) {  // a scanner: its slice of every tile
    const int sw = warp - 1;
    const int rows_w = rows / kScanners;
    for (int i = 0; i < mine; ++i) {
      const int s = i % kStages;
      const int d = i % kBitmaps;
      const long r0 = (long)(blockIdx.x + i * gridDim.x) * rows;
      const int nr = min(rows, (int)(N - r0));
      const int copied = (nr * K) & ~15;  // bytes of the tile the bulk copy brought
      const int w0 = sw * rows_w;  // the slice: rows [w0, w0 + wr) of the tile
      const int wr = max(0, min(rows_w, nr - w0));
      const int o_begin = w0 * K;  // a multiple of 16: rows_w * K is
      const int nchunks = (wr * K + 15) >> 4;
      const uint8_t* st = smem + s * sbytes;
      uint32_t* bm = bitmaps + d * tw;
      if (i >= kBitmaps) mbar_wait(&bm_empty[d], (uint32_t)((i / kBitmaps - 1) & 1));
      mbar_wait(&full[s], (uint32_t)((i / kStages) & 1));
      for (int c0 = 0; c0 < nchunks; c0 += 32) {
        const int c = c0 + lane;
        const int o0 = o_begin + 16 * c;  // the chunk's first byte in the tile
        bool nonzero = false;
        if (c < nchunks) {
          if (o0 < copied) {
            const uint4 m = *reinterpret_cast<const uint4*>(st + o0);
            nonzero = (m.x | m.y | m.z | m.w) != 0u;
          } else {  // the tile's last 8 bytes, outside the copy
            const uint2 t = __ldg(reinterpret_cast<const uint2*>(mask + r0 * K + o0));
            nonzero = (t.x | t.y) != 0u;
          }
        }
        const uint32_t bits = __ballot_sync(kFull, nonzero);
        if (lane == 0 && bits) {
          const int g = o_begin / 16 + c0;  // the group's first chunk in the tile
          const int sh = g & 31;
          shared_or(&bm[g >> 5], bits << sh);
          const uint32_t spill = sh ? bits >> (32 - sh) : 0u;  // chunks in the next word
          if (spill) shared_or(&bm[(g >> 5) + 1], spill);
        }
      }
      __syncwarp();  // the warp has read the stage and written its bits
      if (lane == 0) {
        mbar_arrive(&empty[s]);
        mbar_arrive(&bm_full[d]);
      }
    }
    return;
  }

  // a prober: words [pw * kProbeWords, ...) of every tile's bitmap
  const int pw = warp - 1 - kScanners;
  const int groups = (Q + kQG - 1) / kQG;
  uint32_t* list = lists + pw * 32 * kProbeWords;
  const uint32_t lower = (1u << lane) - 1u;
  for (int i = 0; i < mine; ++i) {
    const int d = i % kBitmaps;
    const long r0 = (long)(blockIdx.x + i * gridDim.x) * rows;
    const int nbytes = min(rows, (int)(N - r0)) * K;  // the tile's mask bytes
    uint32_t* bm = bitmaps + d * tw;
    mbar_wait(&bm_full[d], (uint32_t)((i / kBitmaps) & 1));
    for (int wb = pw * kProbeWords; wb < tw; wb += kProbers * kProbeWords) {
      const int wi = wb + lane;
      uint32_t bits = lane < kProbeWords && wi < tw ? bm[wi] : 0u;
      if (lane < kProbeWords && wi < tw) bm[wi] = 0u;  // clear for the tile kBitmaps on
      const int cnt = __popc(bits);
      // the warp's exclusive prefix sum of cnt (0..32: six bit planes)
      int before = 0, total = 0;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        const uint32_t plane = __ballot_sync(kFull, (cnt >> b) & 1);
        before += __popc(plane & lower) << b;
        total += __popc(plane) << b;
      }
      for (int e = before; bits; bits &= bits - 1) list[e++] = 32 * wi + __ffs(bits) - 1;
      __syncwarp();
      for (int e0 = 0; e0 < total; e0 += 32) {
        if (e0 + lane < total) {
          const int o = 16 * (int)list[e0 + lane];  // the chunk's first byte in the tile
          const uint8_t* gm = mask + r0 * K + o;
          uint32_t m[4] = {0u, 0u, 0u, 0u};
          if (o + 16 <= nbytes) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(gm));
            m[0] = v.x, m[1] = v.y, m[2] = v.z, m[3] = v.w;
          } else {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(gm));
            m[0] = v.x, m[1] = v.y;
          }
          int ids[16];
          const int* gn = nbr + r0 * K + o;
#pragma unroll
          for (int qd = 0; qd < 4; ++qd) {  // a live quarter's ids: one 16-byte load
            int4 v = make_int4(N, N, N, N);
            if (m[qd]) v = __ldg(reinterpret_cast<const int4*>(gn + 4 * qd));
            ids[4 * qd] = m[qd] & 0xffu ? v.x : N;
            ids[4 * qd + 1] = m[qd] & 0xff00u ? v.y : N;
            ids[4 * qd + 2] = m[qd] & 0xff0000u ? v.z : N;
            ids[4 * qd + 3] = m[qd] & 0xff000000u ? v.w : N;
          }
          // K % 8 == 0 and K >= 8: a chunk starts at column col <= K - 8 and
          // so spans at most two rows (col + 15 < 2 K)
          const int row = o / K;
          const int col = o - row * K;
          for (int g = 0; g < groups; ++g) {
            const uint32_t* wg = words + (long)g * N;
            const int qn = min(kQG, Q - g * kQG);
            uint32_t hit[16];  // every id's word of query bits, all in flight at once
#pragma unroll
            for (int b = 0; b < 16; ++b) hit[b] = probe(wg, ids[b], N);
            uint32_t lo = 0u, hi = 0u;  // hits in the chunk's first row and in the next
#pragma unroll
            for (int b = 0; b < 16; ++b) {
              if (col + b < K) lo |= hit[b]; else hi |= hit[b];
            }
            uint8_t* dst = out + (long)g * kQG * N + r0 + row;
            for (int j = 0; j < qn; ++j) {
              if ((lo >> j) & 1u) dst[(long)j * N] = 1;
              if ((hi >> j) & 1u) dst[(long)j * N + 1] = 1;
            }
          }
        }
      }
      __syncwarp();  // the list is read before the next words overwrite it
    }
    if (lane == 0) mbar_arrive(&bm_empty[d]);
  }
}

// ----------------------------------------------------------------- rows ----
template <bool kVec8>
__global__ void __launch_bounds__(kThreads)
frontier_hop_rows_kernel(const uint32_t* __restrict__ words, const int* __restrict__ nbr,
                         const uint8_t* __restrict__ mask, uint8_t* __restrict__ out,
                         int Q, int N, int K) {
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * kQG;
  const int qn = min(kQG, Q - q0);
  const uint32_t* wg = words + (long)blockIdx.y * N;
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
          if (byte) acc |= probe(wg, __ldg(nrow + c + b), N);
        }
      }
    } else {
      for (int c = lane; c < K; c += 32)
        if (__ldg(mrow + c)) acc |= probe(wg, __ldg(nrow + c), N);
    }
    acc = __reduce_or_sync(0xffffffffu, acc);
    if (lane < qn) out[(long)(q0 + lane) * N + i] = (uint8_t)((acc >> lane) & 1u);
  }
}

}  // namespace

extern "C" {

// frontier (Q, N) bool, nbr (N, K) int32, mask (N, K) bool -> out (Q, N)
// bool.  words (ceil(Q / 32), N) uint32 is caller-allocated scratch.  The
// plan (variant, rows per tile, grid_x) comes from kernel.py's
// launch_plan; a plan the shapes or the alignment of the mask and ids do
// not allow returns cudaErrorInvalidValue without launching.  All of it
// runs on `stream`: the pack, then the row kernel, or the pack (zeroing
// `out`) and the bulk kernel.  Returns the cudaError_t.
int bfs_frontier_hop(const uint8_t* frontier, const int* nbr, const uint8_t* mask,
                     uint8_t* out, uint32_t* words, int Q, int N, int K, int variant, int rows,
                     int grid_x, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(mask);
  const uintptr_t nbr_addr = reinterpret_cast<uintptr_t>(nbr);
  const int groups = (Q + kQG - 1) / kQG;
  bool ok = Q > 0 && N > 0 && K >= 0 && grid_x > 0 && groups <= 65535;
  if (variant == kBulk)
    ok = ok && K >= 8 && K % 8 == 0 && ((addr | nbr_addr) & 15u) == 0 && rows >= kScanners &&
         rows % (2 * kScanners) == 0 && grid_x <= (N + rows - 1) / rows;
  else if (variant == kRows8)
    ok = ok && K % 8 == 0 && (addr & 7u) == 0;
  else
    ok = ok && variant == kRows;
  if (!ok) return (int)cudaErrorInvalidValue;

  const bool bulk = variant == kBulk;
  const int smem = bulk ? bulk_smem_bytes(rows, K) : 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)  // a ring too large for a block is refused here, before any launch
    err = cudaFuncSetAttribute(frontier_hop_bulk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long pack_threads = (long)groups * N;
  pack_frontier_kernel<<<(unsigned)((pack_threads + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(frontier, words, bulk ? out : nullptr, Q, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (bulk) {
    frontier_hop_bulk_kernel<<<grid_x, kHopThreads, smem, stream>>>(words, nbr, mask, out, Q, N,
                                                                    K, rows);
  } else {
    const dim3 grid((unsigned)grid_x, (unsigned)groups);
    if (variant == kRows8)
      frontier_hop_rows_kernel<true><<<grid, kThreads, 0, stream>>>(words, nbr, mask, out, Q, N,
                                                                    K);
    else
      frontier_hop_rows_kernel<false><<<grid, kThreads, 0, stream>>>(words, nbr, mask, out, Q, N,
                                                                     K);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
