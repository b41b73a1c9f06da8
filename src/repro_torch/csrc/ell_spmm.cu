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
// 3.35 TB/s; the adds (one per live slot and column, 0.17 G at that shape)
// are far under the fp32 rate.  But the gathers read a feature row once per
// live slot: about 20 times the query's tile at that shape (0.67 GB), which
// no cache serves at the byte bound's pace.
//
// What the design does about it: the TPU kernel keeps the query's whole
// (M+1, D) tile in VMEM; here that tile (525 KB at M = 1024, D = 128, fp32)
// does not fit the 227 KB of shared memory a block can have, but a slab of
// its columns does.  Two variants, chosen by kernel.py's ell_plan from the
// shapes alone:
//
// * slab (kSlab): a block of 32 warps owns one (query, column slab).  A slab
//   row is RB = 128 bytes (32 fp32 or 64 bf16 columns), or 64 where (M+1)
//   rows of 128 do not fit; a query's slabs are adjacent in
//   blockIdx, so their re-reads of its ids and mask mostly hit in L2.  The
//   block stages the slab's M rows into shared memory with 16-byte cp.async
//   copies (element copies where D or feat's address is not 16-byte
//   aligned) and zeroes row M.  Each warp then walks batches of 4 output
//   rows, loading the next batch's slot ids and masks (32 slots a row, one
//   a lane) while it adds the current one.  A lane reads 8 bytes of a slab
//   row, so a warp adds R = 32 * 8 / RB rows at once (2 or 4), lane group g
//   (RB / 8 lanes) row g: at RB = 128 each half-warp reads
//   one whole 128-byte row, and the two halves of one 8-byte read are two
//   bank-conflict-free passes.  Per row and 32 slots, a ballot of the live
//   slots and their ranks put the rows' byte offsets (id * RB) into the
//   row's list in shared memory in slot order; the lists are padded to the
//   longest of the warp's R rows, rounded up to 4, with row M's offset
//   (adding +0.0 leaves a sum as it is: a sum that starts at +0.0 is never
//   -0.0).  The warp then adds 4 slab rows a step from one 16-byte read of
//   each group's list, each lane summing its two words' columns.  64-byte
//   rows put two rows in one pass, whose reads share a bank where their
//   offsets differ by a multiple of 128 bytes.
// * l2 (kL2): where no slab fits (M past 3,375), a block owns 8 output rows
//   of one query, a warp a row, and reads the neighbours' rows through L1/L2
//   with 4-byte loads (lane l holds columns l, l + 32, l + 64, l + 96 of each
//   128-column pass).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Variant { kSlab = 0, kL2 = 1 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;       // slab: 32 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;            // slab: output rows a warp loads at a time
constexpr int kListSlots = 32;       // slab: slots a row's list holds (one a lane)
constexpr int kSmemPerBlock = 232448;
constexpr int kDevices = 64;        // devices a process can launch on
constexpr int kL2Warps = 8;          // l2: output rows a block, one warp each
constexpr int kL2Threads = kL2Warps * 32;
constexpr int kL2Cols = 4;           // l2: columns a lane a pass
constexpr int kL2Pass = 32 * kL2Cols;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bytes of a slab row a lane reads: a warp's read is two 128-byte rows, one
// a half-warp, or four 64-byte ones.
constexpr int kLaneBytes = 8;
// Output rows a warp adds at once: its lanes' bytes over a slab row's.
__host__ __device__ constexpr int warp_rows(int RB) { return 32 * kLaneBytes / RB; }

// Shared memory of a slab block: the (M+1)-row slab, 16-byte aligned, then
// each warp's R = warp_rows(RB) lists of kListSlots offsets.
__host__ __device__ inline int slab_bytes(int M, int RB) { return ((M + 1) * RB + 15) / 16 * 16; }
__host__ __device__ inline long long slab_smem_bytes(int M, int RB) {
  return (((long long)M + 1) * RB + 15) / 16 * 16 +
         (long long)kWarps * warp_rows(RB) * kListSlots * 4;
}

// One 4-byte word of the slab (an fp32 column, or a bf16 column pair with
// the lower column in the low half) added into sums a[k], a[k + 1].
__device__ __forceinline__ void add_word(float* a, uint32_t w, float*) {
  a[0] = __fadd_rn(a[0], __uint_as_float(w));
}
__device__ __forceinline__ void add_word(float* a, uint32_t w, __nv_bfloat16*) {
  a[0] = __fadd_rn(a[0], __uint_as_float(w << 16));
  a[1] = __fadd_rn(a[1], __uint_as_float(w & 0xffff0000u));
}

// The lane's 8 bytes of four slab rows at byte offsets o (from the lane's
// bytes of row 0) added into its column sums in order; the four reads are
// issued first.
template <typename T>
__device__ __forceinline__ void add4(float (&a)[4], const unsigned char* col, int4 o) {
  constexpr int W = 4 / (int)sizeof(T);  // columns a 4-byte word
  const uint2 v[4] = {*reinterpret_cast<const uint2*>(col + o.x),
                      *reinterpret_cast<const uint2*>(col + o.y),
                      *reinterpret_cast<const uint2*>(col + o.z),
                      *reinterpret_cast<const uint2*>(col + o.w)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    add_word(a, v[j].x, (T*)nullptr);
    add_word(a + W, v[j].y, (T*)nullptr);
  }
}

template <typename T, int RB>
__global__ void __launch_bounds__(kThreads, 1)
ell_slab_kernel(const T* __restrict__ feat, const int* __restrict__ nbr,
                const uint8_t* __restrict__ mask, T* __restrict__ out, int M, int K, int D,
                int slabs, bool vec) {
  constexpr int L = RB / kLaneBytes;                // lanes a slab row
  constexpr int R = warp_rows(RB);                  // rows a warp adds at once
  constexpr int G = kBatch / R;                     // row groups a batch
  constexpr int CPL = kLaneBytes / (int)sizeof(T);  // columns a lane
  constexpr int COLS = RB / (int)sizeof(T);  // columns a slab
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long q = blockIdx.x / slabs;
  const int c0 = (int)(blockIdx.x - q * slabs) * COLS;
  const int width = min(COLS, D - c0);
  const long long qm = q * M;
  const T* ftile = feat + qm * D + c0;

  // stage the slab (rows 0..M-1) and zero row M
  if (vec) {
    const int cpr = width * (int)sizeof(T) / 16;  // 16-byte chunks a row
    const uint32_t base = smem_u32(smem);
    for (int i = threadIdx.x; i < M * cpr; i += kThreads) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async16(base + r * RB + c * 16, ftile + (long long)r * D + c * (16 / (int)sizeof(T)));
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < M * width; i += kThreads) {
      const int r = i / width, c = i - r * width;
      reinterpret_cast<T*>(smem + r * RB)[c] = ftile[(long long)r * D + c];
    }
  }
  if (threadIdx.x < RB / 4) reinterpret_cast<uint32_t*>(smem + M * RB)[threadIdx.x] = 0u;

  // a warp's work: batches b = warp, warp + kWarps, ... of 4 rows, each in
  // chunks of 32 slots; the next (batch, chunk)'s ids and masks load while
  // the current one is added
  const int nbatch = (M + kBatch - 1) / kBatch, nch = (K + 31) / 32;
  const int* qnbr = nbr + qm * K + lane;  // this lane's slot of the query's row 0
  const uint8_t* qmask = mask + qm * K + lane;
  int id[kBatch], mk[kBatch], nid[kBatch], nmk[kBatch];
  auto load = [&](int b, int c, int (&ids)[kBatch], int (&mks)[kBatch]) {
    const int s = c * 32;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int row = b * kBatch + j;
      ids[j] = 0;
      mks[j] = 0;
      if (b < nbatch && row < M && s + lane < K) {
        const int slot = row * K + s;
        ids[j] = __ldg(qnbr + slot);
        mks[j] = __ldg(qmask + slot);
      }
    }
  };
  load(warp, 0, nid, nmk);
  if (vec) cp_async_wait_all();
  __syncthreads();

  int* lists = reinterpret_cast<int*>(smem + slab_bytes(M, RB)) + warp * R * kListSlots;
  const int g = lane / L;
  const int* mine = lists + g * kListSlots;
  const unsigned char* col = smem + (lane % L) * kLaneBytes;  // this lane's bytes of slab row 0
  const unsigned lt = (1u << lane) - 1u;
  const int zero = M * RB;
  const int cl = (lane % L) * CPL;  // this lane's first column in the slab
  T* qout = out + qm * D + c0 + cl;
  float acc[G][4] = {};
  for (int b = warp, c = 0; b < nbatch;) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      id[j] = nid[j];
      mk[j] = nmk[j];
    }
    const int nb = c + 1 == nch ? b + kWarps : b, nc = c + 1 == nch ? 0 : c + 1;
    load(nb, nc, nid, nmk);
    if (c == 0) {
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[h][j] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      // compact each of rows h * R + r's live slots into its list in slot
      // order, padded with row M's offset to the warp's longest list rounded
      // up to 4
      unsigned bits[R];
      int n[R], npad = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = h * R + r;
        bits[r] = __ballot_sync(kFull, mk[j] != 0 && (unsigned)id[j] < (unsigned)M);
        n[r] = __popc(bits[r]);
        npad = max(npad, n[r]);
      }
      npad = (npad + 3) & ~3;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((bits[r] >> lane) & 1u)
          lists[r * kListSlots + __popc(bits[r] & lt)] = id[h * R + r] * RB;
        if (lane >= n[r] && lane < npad) lists[r * kListSlots + lane] = zero;
      }
      __syncwarp();
      int i = 0;
#pragma unroll 1
      for (; i + 8 <= npad; i += 8) {
        add4<T>(acc[h], col, *reinterpret_cast<const int4*>(mine + i));
        add4<T>(acc[h], col, *reinterpret_cast<const int4*>(mine + i + 4));
      }
      if (i < npad) add4<T>(acc[h], col, *reinterpret_cast<const int4*>(mine + i));
      __syncwarp();
    }
    if (c + 1 == nch) {  // the batch's sums are whole: write the slab's columns
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const int row = b * kBatch + h * R + g;
        if (row < M && cl < width) {
          T* o = qout + (long long)row * D;
#pragma unroll
          for (int j = 0; j < CPL; ++j)
            if (cl + j < width) store(o + j, acc[h][j]);
        }
      }
    }
    b = nb;
    c = nc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kL2Threads)
ell_l2_kernel(const T* __restrict__ feat, const int* __restrict__ nbr,
              const uint8_t* __restrict__ mask, T* __restrict__ out, int M, int K, int D,
              int row_blocks) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = blockIdx.x / row_blocks;
  const int row = (blockIdx.x - (int)(q * row_blocks)) * kL2Warps + warp;
  if (row >= M) return;  // whole warp: no shuffles below are left half-done
  const T* ftile = feat + q * M * D;
  const long long slot0 = (q * M + row) * K;
  T* orow = out + (q * M + row) * D;

  for (int c0 = 0; c0 < D; c0 += kL2Pass) {
    float acc[kL2Cols];
#pragma unroll
    for (int j = 0; j < kL2Cols; ++j) acc[j] = 0.f;
    for (int s0 = 0; s0 < K; s0 += 32) {
      const int s = s0 + lane;
      int id = 0;
      bool live = false;
      if (s < K) {
        id = __ldg(nbr + slot0 + s);
        live = __ldg(mask + slot0 + s) != 0 && (unsigned)id < (unsigned)M;
      }
      unsigned bits = __ballot_sync(kFull, live);
      while (bits) {  // live slots in slot order
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        const T* f = ftile + (long long)__shfl_sync(kFull, id, j) * D;
#pragma unroll
        for (int c = 0; c < kL2Cols; ++c) {
          const int d = c0 + c * 32 + lane;
          if (d < D) acc[c] = __fadd_rn(acc[c], to_f32(__ldg(f + d)));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kL2Cols; ++c) {
      const int d = c0 + c * 32 + lane;
      if (d < D) store(orow + d, acc[c]);
    }
  }
}

// Let the slab kernel take up to `smem` bytes of dynamic shared memory on
// the current device (the limit is a setting of each device; it is raised
// once a device, to a block's whole 227 KB).
template <typename T, int RB>
cudaError_t allow_smem(int smem) {
  static bool raised[kDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ell_slab_kernel<T, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemPerBlock);
  if (err == cudaSuccess) raised[dev] = true;
  return err;
}

template <typename T, int RB>
int occupancy(int smem, int* blocks) {
  cudaError_t err = allow_smem<T, RB>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ell_slab_kernel<T, RB>, kThreads,
                                                        smem);
  return (int)err;
}

template <typename T, int RB>
int launch_slab(const void* feat, const int* nbr, const uint8_t* mask, void* out, int M, int K,
                int D, int slabs, int grid, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem<T, RB>(smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = (reinterpret_cast<uintptr_t>(feat) & 15u) == 0 &&
                   ((long long)D * sizeof(T)) % 16 == 0;
  ell_slab_kernel<T, RB><<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), nbr, mask, static_cast<T*>(out), M, K, D, slabs, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* feat, const int* nbr, const uint8_t* mask, void* out, int Q, int M,
           int K, int D, int variant, int cols, int grid, int smem, cudaStream_t stream) {
  if (variant == kL2) {
    const long long row_blocks = (M + kL2Warps - 1) / kL2Warps;
    if (cols != 0 || smem != 0 || grid != (long long)Q * row_blocks)
      return (int)cudaErrorInvalidValue;
    ell_l2_kernel<T><<<(unsigned)grid, kL2Threads, 0, stream>>>(
        static_cast<const T*>(feat), nbr, mask, static_cast<T*>(out), M, K, D, (int)row_blocks);
    return (int)cudaGetLastError();
  }
  const int rb = cols * (int)sizeof(T);
  if (variant != kSlab || (rb != 64 && rb != 128)) return (int)cudaErrorInvalidValue;
  const long long slabs = (D + cols - 1) / cols;
  const long long need = slab_smem_bytes(M, rb);
  if (grid != (long long)Q * slabs || smem != need || need > kSmemPerBlock)
    return (int)cudaErrorInvalidValue;
  if (rb == 128)
    return launch_slab<T, 128>(feat, nbr, mask, out, M, K, D, (int)slabs, grid, smem, stream);
  return launch_slab<T, 64>(feat, nbr, mask, out, M, K, D, (int)slabs, grid, smem, stream);
}

}  // namespace

extern "C" {

// feat (Q, M, D), nbr (Q, M, K) int32, mask (Q, M, K) bool -> out (Q, M, D);
// dtype 0 = fp32, 1 = bf16 (feat and out).  The plan (variant, slab columns,
// grid, dynamic shared memory) comes from kernel.py's ell_plan; one the
// shapes do not give returns cudaErrorInvalidValue without launching.
// Returns the launch's cudaError_t.
int ell_aggregate(const void* feat, const int* nbr, const uint8_t* mask, void* out, int Q, int M,
                  int K, int D, int dtype, int variant, int cols, int grid, int smem,
                  cudaStream_t stream) {
  if (Q <= 0 || M <= 0 || K <= 0 || D <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(feat, nbr, mask, out, Q, M, K, D, variant, cols, grid, smem, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, nbr, mask, out, Q, M, K, D, variant, cols, grid, smem,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the slab kernel for `dtype` and `cols` columns, at `smem` bytes
// of dynamic shared memory, that an SM of the current card holds (the
// occupancy calculator: registers, threads and shared memory); for reports.
int ell_slab_occupancy(int dtype, int cols, int smem, int* blocks) {
  const int rb = cols * (dtype == 0 ? 4 : 2);
  if (dtype == 0 && rb == 128) return occupancy<float, 128>(smem, blocks);
  if (dtype == 0 && rb == 64) return occupancy<float, 64>(smem, blocks);
  if (dtype == 1 && rb == 128) return occupancy<__nv_bfloat16, 128>(smem, blocks);
  if (dtype == 1 && rb == 64) return occupancy<__nv_bfloat16, 64>(smem, blocks);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
