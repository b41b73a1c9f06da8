// The top-k bookkeeping shared by the two stage-1 scan kernels
// (topk_sim.cu, ivf_scan.cu): a candidate is a (score, index) entry,
// ordered by score descending and then index ascending -- the reference's
// lax.top_k order, where the index is a row id (topk_sim) or a candidate
// position (ivf_scan).
//
// Each kernel keeps running sorted lists of kk = min(k, kCap) entries (a
// warp inserts a candidate that beats a list's last entry: in registers,
// a lane an entry, up to kk = 32, else in shared memory), writes each list
// whole to device memory when its range is done, and merges a query's
// lists into its top k, staged through shared memory where they fit: by k
// rounds of a block-wide arg-best where that is cheap, else by a tree
// merge, pairwise level by level (each entry's place in the merged pair is
// its own index plus a binary search in the partner), keeping the first
// min(2 len, k) entries of each pair.  For k <= kCap a list keeps the top
// kk of its range; past kCap a list spans at most kCap candidates and so
// keeps all of them.  ivf_scan merges in the block that takes its query's
// last ticket (last_block: the workspace the tickets live in is zeroed
// once by the wrapper, and the last block sets its ticket back to 0);
// topk_sim in a merge kernel of a block a query.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace topk {

constexpr int kCap = 256;                // list capacity, and a tree list's span
constexpr int kPadIndex = 0x7fffffff;    // a padding entry: (-inf, kPadIndex)
constexpr unsigned kFull = 0xffffffffu;

struct __align__(8) Entry {
  float s;
  int i;
};

__device__ __forceinline__ Entry pad_entry() { return Entry{-CUDART_INF_F, kPadIndex}; }

// a before b: larger score first, then the lower index
__device__ __forceinline__ bool better(Entry a, Entry b) {
  return a.s > b.s || (a.s == b.s && a.i < b.i);
}

// Entries a set of lists occupies at any level of the tree merge: n lists of
// len entries, each level halving the lists and doubling their length up
// to k.  The wrappers mirror it to size their scratch.
__host__ __device__ inline long long merge_stride(int n, int len, int k) {
  long long most = (long long)n * len;
  while (n > 1) {
    n = (n + 1) / 2;
    len = 2 * len < k ? 2 * len : k;
    const long long now = (long long)n * len;
    most = now > most ? now : most;
  }
  return most;
}

// The warp inserts v into list[0, kk) (sorted by better()); the last entry
// falls off.  Every lane passes the same v.
__device__ __forceinline__ void list_insert(Entry* list, int kk, Entry v, int lane) {
  int pos = 0;
  for (int c = 0; c < kk; c += 32) {
    const int i = c + lane;
    pos += __popc(__ballot_sync(kFull, i < kk && better(list[i], v)));
  }
  if (pos >= kk) return;
  // shift [pos, kk - 1) up by one, the last 32-entry chunk first
  for (int c = (kk - 1) & ~31; c + 32 > pos && c >= 0; c -= 32) {
    const int i = c + lane;
    const bool move = i >= pos && i + 1 < kk;
    Entry e;
    if (move) e = list[i];
    __syncwarp();
    if (move) list[i + 1] = e;
    __syncwarp();
  }
  if (lane == 0) list[pos] = v;
  __syncwarp();
}

// A running list of kk <= 32 entries held in registers: lane p holds entry
// p (lanes past kk hold paddings).  The warp inserts v (every lane passes
// the same v); the last entry falls off.  Returns the new last entry.
__device__ __forceinline__ Entry reg_insert(Entry& mine, int kk, Entry v, int lane) {
  const int pos = __popc(__ballot_sync(kFull, lane < kk && better(mine, v)));
  const Entry up{__shfl_up_sync(kFull, mine.s, 1), __shfl_up_sync(kFull, mine.i, 1)};
  if (pos < kk) {
    if (lane == pos) mine = v;
    else if (lane > pos && lane < kk) mine = up;
  }
  return Entry{__shfl_sync(kFull, mine.s, kk - 1), __shfl_sync(kFull, mine.i, kk - 1)};
}

// The better (first) or the worse of a lane's entry and its partner's.
__device__ __forceinline__ Entry xchg(Entry e, int stride, bool keep_better) {
  const Entry o{__shfl_xor_sync(kFull, e.s, stride), __shfl_xor_sync(kFull, e.i, stride)};
  return better(o, e) == keep_better ? o : e;
}

// Sorts the warp's 32 entries (one a lane) so that lane 0 holds the best: a
// bitonic network of 15 exchange steps.
__device__ __forceinline__ Entry warp_sort(Entry e, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      e = xchg(e, stride, ((lane & size) == 0) == ((lane & stride) == 0));
  return e;
}

// A register list (as reg_insert's) takes up to 32 candidates at once, one a
// lane (paddings elsewhere): the candidates sorted, the list's lane p paired
// with candidate 31 - p and the better kept (the best 32 of both, a bitonic
// sequence), then a bitonic merge.  Returns the new last entry.
__device__ __forceinline__ Entry reg_merge(Entry& mine, int kk, Entry cand, int lane) {
  Entry c = warp_sort(cand, lane);
  c = Entry{__shfl_sync(kFull, c.s, 31 - lane), __shfl_sync(kFull, c.i, 31 - lane)};
  Entry e = better(c, mine) ? c : mine;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) e = xchg(e, stride, (lane & stride) == 0);
  mine = lane < kk ? e : pad_entry();
  return Entry{__shfl_sync(kFull, mine.s, kk - 1), __shfl_sync(kFull, mine.i, kk - 1)};
}

// Entries of sorted l[0, len) before v: strictly better (or_equal false) or
// not after it (or_equal true).
__device__ __forceinline__ int count_before(const Entry* l, int len, Entry v, bool or_equal) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const Entry e = l[mid];
    if (or_equal ? !better(v, e) : better(e, v)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The block merges, for each of nq queries (stride entries apart in a and
// b), n sorted lists of len entries at the front of a into one list of k,
// a pair a level; returns the buffer that holds the result.  In a pair the
// first list's entry goes first among equal entries (only paddings are
// equal), so each level places every entry once.
__device__ inline const Entry* merge_tree(Entry* a, Entry* b, int nq, int n, int len, int k,
                                          long long stride) {
  while (n > 1) {
    const int n2 = (n + 1) / 2;
    const int len2 = 2 * len < k ? 2 * len : k;
    const long long total = (long long)nq * n2 * 2 * len;
    for (long long t = threadIdx.x; t < total; t += blockDim.x) {
      const int x = (int)(t % len);
      long long r = t / len;
      const int side = (int)(r & 1);
      r >>= 1;
      const int p = (int)(r % n2);
      const long long qi = r / n2;
      const Entry* A = a + qi * stride + (long long)(2 * p) * len;
      const bool has_b = 2 * p + 1 < n;
      Entry v;
      int pos;
      if (side == 0) {
        v = A[x];
        pos = x + (has_b ? count_before(A + len, len, v, false) : 0);
      } else if (has_b) {
        v = A[len + x];
        pos = x + count_before(A, len, v, true);
      } else {  // no partner: paddings fill the rest
        v = pad_entry();
        pos = len + x;
      }
      if (pos < len2) b[qi * stride + (long long)p * len2 + pos] = v;
    }
    __syncthreads();
    Entry* sw = a;
    a = b;
    b = sw;
    n = n2;
    len = len2;
  }
  return a;
}

// The merge selects round by round where k rounds over a query's entries
// cost little (k * entries up to this: the serving waves' k = 3 and the
// IVF batch's k = 32 over 40 lists), else merges by tree (k rounds of two
// block barriers each outlast log2(lists) tree levels once k * entries is
// large, as for topk_sim's 132 lists of 32).
constexpr long long kSelectWork = 65536;

// The block selects the top k of the e entries of a (shared memory), k
// rounds of a block-wide arg-best over the entries after the last winner,
// into fin[0, k).
__device__ inline void select_rounds(const Entry* a, long long e, int k, Entry* fin) {
  __shared__ Entry best_of[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = (blockDim.x + 31) >> 5;
  Entry prev{CUDART_INF_F, -1};  // everything is after it
  for (int r = 0; r < k; ++r) {
    Entry best = pad_entry();
    for (long long t = threadIdx.x; t < e; t += blockDim.x) {
      const Entry c = a[t];
      if (better(prev, c) && better(c, best)) best = c;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const Entry c{__shfl_xor_sync(kFull, best.s, o), __shfl_xor_sync(kFull, best.i, o)};
      if (better(c, best)) best = c;
    }
    if (lane == 0) best_of[warp] = best;
    __syncthreads();
    best = best_of[0];
    for (int w = 1; w < warps; ++w)
      if (better(best_of[w], best)) best = best_of[w];
    if (threadIdx.x == 0) fin[r] = best;
    prev = best;
    __syncthreads();
  }
}

// The block merges, for each of nq queries (stride entries apart in a and
// b, outputs k apart in out_s / out_i), n lists of kk entries at the front
// of a into the query's top k.  Queries go through `stage` (shared memory,
// stage_entries entries) in batches when one fits -- selected round by
// round where k * n * kk <= kSelectWork, else tree-merged -- or are
// tree-merged in place in device memory.  An output index is the entry's index, or
// idmap[index] where idmap is given.
__device__ inline void merge_out(Entry* a, Entry* b, int nq, int n, int kk, int k,
                                 long long stride, Entry* stage, long long stage_entries,
                                 float* out_s, int* out_i, const int* idmap) {
  const long long per = stage_entries / (2 * stride);
  for (int j0 = 0; j0 < nq; j0 += per > 0 ? (int)per : nq) {
    const int nb = per > 0 ? (int)(nq - j0 < per ? nq - j0 : per) : nq;
    const Entry* fin;
    if (per > 0) {
      const long long len0 = (long long)n * kk;
      for (long long t = threadIdx.x; t < nb * len0; t += blockDim.x) {
        const long long j = t / len0, x = t - j * len0;
        stage[j * stride + x] = a[(j0 + j) * stride + x];
      }
      __syncthreads();
      if (k * len0 <= kSelectWork) {
        for (int j = 0; j < nb; ++j)
          select_rounds(stage + j * stride, len0, k, stage + per * stride + j * stride);
        fin = stage + per * stride;
      } else {
        fin = merge_tree(stage, stage + per * stride, nb, n, kk, k, stride);
      }
    } else {
      fin = merge_tree(a, b, nq, n, kk, k, stride);
    }
    for (int t = threadIdx.x; t < nb * k; t += blockDim.x) {
      const int j = t / k, r = t - j * k;
      const Entry e = fin[j * stride + r];
      out_s[(long long)(j0 + j) * k + r] = e.s;
      out_i[(long long)(j0 + j) * k + r] = idmap ? idmap[e.i] : e.i;
    }
    __syncthreads();
  }
}

// Every thread of the block calls this after writing its lists: true in
// the block that takes the last of `blocks` tickets (which it resets).
__device__ __forceinline__ bool last_block(unsigned long long* ticket, unsigned blocks) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1ull) == (unsigned long long)(blocks - 1);
    if (last) *ticket = 0ull;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

}  // namespace topk
