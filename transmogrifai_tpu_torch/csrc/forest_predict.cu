// Forest descent on Hopper: route every row down every tree of an ensemble,
// then either sum the leaf values it reaches (predict) or sum per-row
// statistics per (tree, leaf) (the exact leaf statistics of a refit):
//
//   out[s, :]    = sum_t leaf[t, node(s, t), :]       (trees in ascending t)
//   sums[t, l, :] = sum_s aug[s, :] * 1[node(s, t) == l]
//
// Two layouts, two kernels each:
//
// * forest_predict_heap replaces transmogrifai_tpu/ops/forest.py
//   _predict_pallas, forest_leaf_sums_heap its _leaf_sums_pallas
//   (complete-heap trees). Node j of level l sits at heap index 2^l - 1 + j;
//   node' = 2 node + (codes[s, feat] > bin).
// * forest_predict_chain replaces transmogrifai_tpu/ops/forest.py
//   _predict_chain_pallas, forest_leaf_sums_chain its
//   _leaf_sums_chain_pallas (slot-chain trees). Level l holds min(2^l, W)
//   slots of (feat, bin, base); slot' = base + (codes[s, feat] > bin).
//
// A bin equal to n_bins is the "route left" sentinel: codes are < n_bins.
// A split feature outside [0, d) reads code 0 and a chain slot outside its
// level reads as slot 0 with go 0, which is what the JAX package's one-hot
// gathers give for such tables. A heap is a chain whose level l holds its
// 2^l nodes with base 2 j, so one descent serves both.
//
// Predict. What bounds it: each row's descent is a chain of dependent
// steps (depth a tree), each a split record and then a code; the bytes
// the call must move (the codes once, the tables, the leaves, out) take
// ~5 us at the serve shapes. The first design (one thread a row, 128 rows
// a block, the row's codes read from L1/L2 at every step, three int
// tables staged in 48 KB rounds between barriers) ran at 1-6% of that
// (PERF.md): each step was a scattered 32-byte sector for 4 useful bytes,
// and the restaging left the descent idle. This design:
// * A pass packs each slot into one 32-bit record: bits 0-8 the bin + 1
//   clamped to [0, 256] (go = code >= it for the byte codes below); bits
//   9-19 the base, signed (2 j for a heap; before the last level clamped
//   to [-1023, 1023], which only moves slots that no level holds; at the
//   last level -1024 says "read the int32 base", so every leaf slot stays
//   exact); bits 20-31 the feature, d for one outside [0, d), which reads
//   the zero byte after every staged row. Each level ends in a sink record
//   (feature d, never go, base 0): a step reads min((unsigned)slot, Wl),
//   so a slot outside its level goes to slot 0 with no branch.
// * Block: R rows, R from the row count so that the blocks fill the SMs
//   (four blocks an SM where the records are small). It copies its rows of
//   codes once, coalesced 16 bytes a load, into shared memory as bytes
//   (clamped to [0, 255]; n_bins <= 256), row stride an odd number of
//   words so that 32 rows reading one feature hit 32 banks. The records
//   go to shared memory with cp.async: all trees at once where they fit
//   beside the codes (up to 227 KB), else in tiles of trees,
//   double-buffered, the next tile arriving while this one descends.
// * A thread walks its row down four trees at once, independent steps in
//   flight, each step one record load and one code load from shared
//   memory, and adds the row's leaf values in registers in ascending tree
//   order: the bits of ops/forest.py leaf_values and of a rerun, whatever
//   the rows a block. Each output element is written once. (Other launch
//   shapes, timed and not taken: experiments/forest_variants.cu.)
// * More than 4095 features, more than 256 bins, W > 512, heaps deeper
//   than 10 or a row stride that leaves no room for a tree take the first
//   design (the wide path below), which reads everything as int32; so do
//   forests whose rows read few codes (T x depth <= d / 4: a single
//   shallow tree, such as a decision tree), for which copying all d codes
//   of a row costs more than reading those few in place.
//
// Leaf sums: a descent followed by a segmented sum, with no float atomics,
// so that reruns give the same bits and integer-valued sums come out
// exact. The rows are cut into chunks by their count alone and the trees
// into tiles that fit in shared memory; one block per (chunk, tile)
// descends a tile of its rows through its trees (the wide path's helpers:
// code_at, chain_width, heap_leaf, chain_leaf over tables staged by
// stage_heap, stage_chain), writes the leaf ids to shared memory, and then
// one thread per (tree, statistic) adds the rows' statistics into its own
// (tree, leaf) cells in row order. Each block writes its (tile trees,
// leaves, k) partial once; a second pass adds the chunk partials in chunk
// order. A sum therefore never depends on the tree tiling.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/cuda_build.py). Plain C entry points for
// ctypes: pointers and the stream come in as void*, each entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRows = 128;                 // wide path: rows (threads) a block
constexpr int kCols = 4;                   // output columns summed per pass
constexpr int kSmemDefault = 48 * 1024;    // opt-in beyond this
constexpr int kSmemMax = 227 * 1024;
constexpr int kSumThreads = 128;           // leaf sums: rows per tile
constexpr int kSumSmem = 96 * 1024;        // leaf sums: target per block
constexpr int kSumMaxTrees = 16;           // leaf sums: trees per tile

__device__ __forceinline__ int code_at(const int* __restrict__ row, int f,
                                       int d) {
  return (f >= 0 && f < d) ? __ldg(row + f) : 0;
}

// Width of chain level l: min(2^l, W). Levels below lc = ceil(log2 W) are
// narrower than W.
__device__ __forceinline__ int chain_width(int l, int lc, int W) {
  return l < lc ? (1 << l) : W;
}

// Stage the heap tables of trees [t0, t0 + nt): H nodes per tree.
__device__ __forceinline__ void stage_heap(const int* __restrict__ feat,
                                           const int* __restrict__ bins,
                                           int* s_feat, int* s_bin,
                                           long long t0, int nt, int H) {
  for (int i = threadIdx.x; i < nt * H; i += blockDim.x) {
    s_feat[i] = feat[t0 * H + i];
    s_bin[i] = bins[t0 * H + i];
  }
}

// Leaf of one row in one heap tree (tables tf, tb of that tree).
__device__ __forceinline__ int heap_leaf(const int* crow, const int* tf,
                                         const int* tb, int depth, int d) {
  int node = 0;
  for (int l = 0; l < depth; ++l) {
    const int j = (1 << l) - 1 + node;
    node = 2 * node + (code_at(crow, tf[j], d) > tb[j] ? 1 : 0);
  }
  return node;
}

// Stage the used slots of each chain level of trees [t0, t0 + nt), packed
// level after level: S slots per tree.
__device__ __forceinline__ void stage_chain(
    const int* __restrict__ feat, const int* __restrict__ bins,
    const int* __restrict__ base, int* s_feat, int* s_bin, int* s_base,
    long long t0, int nt, int depth, int W, int S, int lc) {
  const int narrow = (1 << lc) - 1;          // slots of the narrow levels
  for (int i = threadIdx.x; i < nt * S; i += blockDim.x) {
    const int tt = i / S;
    const int s = i - tt * S;
    int l, j;
    if (s < narrow) {
      l = 31 - __clz(s + 1);
      j = s - ((1 << l) - 1);
    } else {
      l = lc + (s - narrow) / W;
      j = (s - narrow) - (l - lc) * W;
    }
    const long long src = ((t0 + tt) * depth + l) * W + j;
    s_feat[i] = feat[src];
    s_bin[i] = bins[src];
    s_base[i] = base[src];
  }
}

// Final slot of one row in one chain tree (packed tables of that tree).
__device__ __forceinline__ int chain_leaf(const int* crow, const int* tf,
                                          const int* tb, const int* ta,
                                          int depth, int W, int lc, int d) {
  int slot = 0;
  int off = 0;
  for (int l = 0; l < depth; ++l) {
    const int Wl = chain_width(l, lc, W);
    if (slot >= 0 && slot < Wl) {
      const int e = off + slot;
      slot = ta[e] + (code_at(crow, tf[e], d) > tb[e] ? 1 : 0);
    } else {
      slot = 0;
    }
    off += Wl;
  }
  return slot;
}

// ---------------------------------------------------------------------------
// Predict: packed records, codes as bytes in shared memory
// ---------------------------------------------------------------------------

constexpr int kFeatShift = 20;             // record: feature in bits 20-31
constexpr int kMaxPackedD = 4095;          // d itself is the zero column
constexpr int kBaseShift = 9;              // record: signed base, bits 9-19
constexpr int kBaseMax = 1023;
constexpr int kEscape = -1024;             // last level: read the int32 base
constexpr unsigned kNever = 256u;          // bin + 1 no byte code reaches
constexpr int kMaxPackedW = 512;           // dead slots stay past every level
constexpr int kMaxPackedHeapDepth = 10;    // 2 j <= kBaseMax at the last level
constexpr int kPredMaxThreads = 512;
constexpr int kTrees = 4;               // trees a thread walks at once

// A tree's records: level l holds its Wl slots and then a sink at index Wl
// (feature d, never go, base 0), so a slot past its level (or negative)
// reads the sink by min((unsigned)slot, Wl) and goes to slot 0, as the
// reference's one-hot gather does.
int chain_records(int depth, int W, int lc) {
  int S = 0;
  for (int l = 0; l < depth; ++l) S += (l < lc ? (1 << l) : W) + 1;
  return S;
}

__device__ __forceinline__ unsigned record(int f, int b, int a, int d) {
  const unsigned fp = f >= 0 && f < d ? (unsigned)f : (unsigned)d;
  const unsigned bp = (unsigned)(min(max(b, -1), 255) + 1);
  return bp | ((unsigned)a & 2047u) << kBaseShift | fp << kFeatShift;
}

// The signed base of a record.
__device__ __forceinline__ int record_base(unsigned x) {
  return (int)(x << (32 - kFeatShift)) >> (32 - kFeatShift + kBaseShift);
}

// Pack every tree's slots into records (see above and the top of the
// file): rec (T, Sp), a tree's levels one after the other, then zeros. A
// heap (base null) is the chain of W = 2^(depth - 1) whose level l, slot
// j is heap node 2^l - 1 + j, with base 2 j.
__global__ void pack_kernel(const int* __restrict__ feat,
                            const int* __restrict__ bins,
                            const int* __restrict__ base,
                            unsigned* __restrict__ rec, int T, int depth,
                            int W, int lc, int Sp, int d) {
  const long long m = (long long)T * Sp;
  const int H = (1 << depth) - 1;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    const long long t = i / Sp;
    int s = (int)(i - t * Sp);
    int l = 0;
    for (; l < depth; ++l) {                 // the level holding record s
      const int Wl = l < lc ? 1 << l : W;
      if (s <= Wl) break;
      s -= Wl + 1;
    }
    const int Wl = l < lc ? 1 << l : W;
    if (l == depth) {
      rec[i] = 0u;                           // padding
    } else if (s == Wl) {
      rec[i] = kNever | (unsigned)d << kFeatShift;   // the sink
    } else if (base == nullptr) {
      const long long src = t * H + (1 << l) - 1 + s;
      rec[i] = record(feat[src], bins[src], 2 * s, d);
    } else {
      const long long src = (t * depth + l) * W + s;
      const int a = base[src];
      rec[i] = record(feat[src], bins[src],
                      l + 1 < depth ? min(max(a, -kBaseMax), kBaseMax)
                                    : (a >= -kBaseMax && a <= kBaseMax
                                           ? a : kEscape), d);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// The "memory" clobber keeps shared-memory reads below the wait.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned code_byte(int c) {
  return (unsigned)min(max(c, 0), 255);
}

// Block: R = blockDim.x rows from row0 = blockIdx.x * R; thread q walks
// row q down kTrees trees at once (kTrees independent steps in flight).
// Trees in tiles of tc (one tile, or two buffers). smem: the tiles'
// records [nbuf][tc * Sp], then the rows' codes [R][stride] bytes. Sums
// output columns [k0, k0 + kc).
__global__ void __launch_bounds__(kPredMaxThreads)
predict_kernel(const int* __restrict__ codes, const unsigned* __restrict__ rec,
               const int* __restrict__ base, const float* __restrict__ leaf,
               float* __restrict__ out, int* __restrict__ ids, int n, int d,
               int T, int depth, int W, int lc, int Sp, int W_out, int k,
               int k0, int kc, int tc, int stride, int vec) {
  extern __shared__ __align__(16) unsigned pred_smem[];
  const int R = blockDim.x;
  const int q = threadIdx.x;
  const int tile_words = tc * Sp;
  const int ntiles = (T + tc - 1) / tc;
  unsigned* tab = pred_smem;
  unsigned char* sc = reinterpret_cast<unsigned char*>(
      pred_smem + (size_t)(ntiles > 1 ? 2 : 1) * tile_words);
  const long long row0 = (long long)blockIdx.x * R;
  auto stage = [&](int it) {
    const long long t0 = (long long)it * tc;
    const int words = (int)min((long long)tc, T - t0) * Sp;
    unsigned* dst = tab + (it & 1) * tile_words;
    const unsigned* src = rec + t0 * Sp;
    for (int i = 4 * q; i < words; i += 4 * R) cp_async16(dst + i, src + i);
    cp_async_commit();
  };
  if (ntiles > 0) stage(0);
  // the block's rows of codes, once, as bytes; byte d of a row reads 0
  const int m = (int)min((long long)R, n - row0);
  const int* crows = codes + row0 * d;
  if (vec) {                                 // d % 4 == 0, 16-byte aligned
    const int dq = d >> 2;
    const int4* c4 = reinterpret_cast<const int4*>(crows);
    for (int i = q; i < m * dq; i += R) {
      const int r = i / dq;
      const int4 v = __ldg(c4 + i);
      *reinterpret_cast<unsigned*>(sc + r * stride + 4 * (i - r * dq)) =
          code_byte(v.x) | code_byte(v.y) << 8 | code_byte(v.z) << 16 |
          code_byte(v.w) << 24;
    }
  } else {
    for (int i = q; i < m * d; i += R) {
      const int r = i / d;
      sc[r * stride + (i - r * d)] =
          (unsigned char)code_byte(__ldg(crows + i));
    }
  }
  sc[q * stride + d] = 0;
  const unsigned char* row = sc + q * stride;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage(it + 1);                         // the buffer tile it - 1 used
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned* tb = tab + (it & 1) * tile_words;
    const int t0 = it * tc;
    const int ntt = min(tc, T - t0);
    for (int tt = 0; tt < ntt; tt += kTrees) {
      // kTrees trees at once; past the tile's last tree a lane redoes it
      // and adds nothing
      const unsigned* tr[kTrees];
      int slot[kTrees];
#pragma unroll
      for (int u = 0; u < kTrees; ++u) {
        tr[u] = tb + min(tt + u, ntt - 1) * Sp;
        slot[u] = 0;
      }
      int off = 0;
      for (int l = 0; l + 1 < depth; ++l) {
        const unsigned Wl = l < lc ? 1u << l : (unsigned)W;
#pragma unroll
        for (int u = 0; u < kTrees; ++u) {
          const unsigned x = tr[u][off + min((unsigned)slot[u], Wl)];
          slot[u] = record_base(x) + (row[x >> kFeatShift] >= (x & 511u));
        }
        off += Wl + 1;
      }
      if (depth > 0) {                       // the last level: exact slots
        const int l = depth - 1;
        const unsigned Wl = l < lc ? 1u << l : (unsigned)W;
#pragma unroll
        for (int u = 0; u < kTrees; ++u) {
          const unsigned e = min((unsigned)slot[u], Wl);
          const unsigned x = tr[u][off + e];
          int a = record_base(x);
          if (a == kEscape)
            a = __ldg(base + ((long long)(t0 + min(tt + u, ntt - 1)) * depth
                              + l) * W + e);
          slot[u] = a + (row[x >> kFeatShift] >= (x & 511u));
        }
      }
      const long long r = row0 + q;
#pragma unroll
      for (int u = 0; u < kTrees; ++u) {
        if (tt + u >= ntt) break;
        const int t = t0 + tt + u;
        if (ids != nullptr && r < n) ids[r * T + t] = slot[u];
        if ((unsigned)slot[u] < (unsigned)W_out) {
          const float* lv = leaf + ((long long)t * W_out + slot[u]) * k + k0;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (c < kc) acc[c] += __ldg(lv + c);
        }
      }
    }
    __syncthreads();                         // its buffer is free again
  }
  if (row0 + q < n)
    for (int c = 0; c < kc; ++c) out[(row0 + q) * k + k0 + c] = acc[c];
}

// ---------------------------------------------------------------------------
// The wide path: the first design, every table and code as int32
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRows)
heap_kernel(const int* __restrict__ codes, const int* __restrict__ feat,
            const int* __restrict__ bins, const float* __restrict__ leaf,
            float* __restrict__ out, int* __restrict__ ids, int n, int d,
            int T, int depth, int k, int tc) {
  extern __shared__ int smem[];
  const int H = (1 << depth) - 1;
  const int L = 1 << depth;
  int* s_feat = smem;
  int* s_bin = smem + tc * H;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const int* crow = codes + (live ? row : 0) * (long long)d;
  for (int k0 = 0; k0 < k; k0 += kCols) {
    const int kc = min(kCols, k - k0);
    float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
    for (int t0 = 0; t0 < T; t0 += tc) {
      const int nt = min(tc, T - t0);
      __syncthreads();
      stage_heap(feat, bins, s_feat, s_bin, t0, nt, H);
      __syncthreads();
      if (!live) continue;
      for (int tt = 0; tt < nt; ++tt) {
        const int node = heap_leaf(crow, s_feat + tt * H, s_bin + tt * H,
                                   depth, d);
        const int t = t0 + tt;
        if (ids != nullptr && k0 == 0) ids[row * T + t] = node;
        const float* lv = leaf + ((long long)t * L + node) * k + k0;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (c < kc) acc[c] += __ldg(lv + c);
      }
    }
    if (live)
      for (int c = 0; c < kc; ++c) out[row * k + k0 + c] = acc[c];
  }
}

__global__ void __launch_bounds__(kRows)
chain_kernel(const int* __restrict__ codes, const int* __restrict__ feat,
             const int* __restrict__ bins, const int* __restrict__ base,
             const float* __restrict__ leaf, float* __restrict__ out,
             int* __restrict__ ids, int n, int d, int T, int depth, int W,
             int W_out, int k, int tc, int S, int lc) {
  extern __shared__ int smem[];
  int* s_feat = smem;
  int* s_bin = smem + tc * S;
  int* s_base = smem + 2 * tc * S;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const int* crow = codes + (live ? row : 0) * (long long)d;
  for (int k0 = 0; k0 < k; k0 += kCols) {
    const int kc = min(kCols, k - k0);
    float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
    for (int t0 = 0; t0 < T; t0 += tc) {
      const int nt = min(tc, T - t0);
      __syncthreads();
      stage_chain(feat, bins, base, s_feat, s_bin, s_base, t0, nt, depth, W,
                  S, lc);
      __syncthreads();
      if (!live) continue;
      for (int tt = 0; tt < nt; ++tt) {
        const int off = tt * S;
        const int slot = chain_leaf(crow, s_feat + off, s_bin + off,
                                    s_base + off, depth, W, lc, d);
        const int t = t0 + tt;
        if (ids != nullptr && k0 == 0) ids[row * T + t] = slot;
        if (slot >= 0 && slot < W_out) {
          const float* lv = leaf + ((long long)t * W_out + slot) * k + k0;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (c < kc) acc[c] += __ldg(lv + c);
        }
      }
    }
    if (live)
      for (int c = 0; c < kc; ++c) out[row * k + k0 + c] = acc[c];
  }
}

// Leaf sums, second half of a row tile: one thread per (tree, statistic)
// adds the tile's rows in row order into its own cells of the tile's
// (tree, leaf, k) accumulator. ids: (rows, tc) leaf ids, -1 adds nothing;
// aug: the tile's first row of statistics.
__device__ __forceinline__ void add_rows(const short* s_ids, float* s_acc,
                                         const float* __restrict__ aug,
                                         int nr, int nt, int tc, int Lo,
                                         int k) {
  for (int p = threadIdx.x; p < nt * k; p += blockDim.x) {
    const int tt = p / k;
    const int c = p - tt * k;
    float* acc = s_acc + (size_t)tt * Lo * k + c;
    for (int i = 0; i < nr; ++i) {
      const int id = s_ids[i * tc + tt];
      if (id >= 0) acc[id * k] += __ldg(aug + (long long)i * k + c);
    }
  }
}

// Block (chunk, tile): rows [chunk * rpc, +rpc) through heap trees
// [tile * tc, +tc); writes part[chunk, t, leaf, c].
__global__ void __launch_bounds__(kSumThreads)
heap_sums_kernel(const int* __restrict__ codes, const int* __restrict__ feat,
                 const int* __restrict__ bins, const float* __restrict__ aug,
                 float* __restrict__ part, int n, int d, int T, int depth,
                 int k, int tc, int rpc) {
  extern __shared__ int smem[];
  const int H = (1 << depth) - 1;
  const int L = 1 << depth;
  const long long t0 = (long long)blockIdx.y * tc;
  const int nt = min((long long)tc, T - t0);
  int* s_feat = smem;
  int* s_bin = smem + tc * H;
  float* s_acc = reinterpret_cast<float*>(smem + 2 * tc * H);
  short* s_ids = reinterpret_cast<short*>(s_acc + (size_t)tc * L * k);
  stage_heap(feat, bins, s_feat, s_bin, t0, nt, H);
  for (int i = threadIdx.x; i < nt * L * k; i += blockDim.x) s_acc[i] = 0.f;
  __syncthreads();
  const long long lo = (long long)blockIdx.x * rpc;
  const long long hi = min((long long)n, lo + rpc);
  for (long long r0 = lo; r0 < hi; r0 += kSumThreads) {
    const int nr = (int)min((long long)kSumThreads, hi - r0);
    if ((int)threadIdx.x < nr) {
      const int* crow = codes + (r0 + threadIdx.x) * d;
      for (int tt = 0; tt < nt; ++tt)
        s_ids[threadIdx.x * tc + tt] = (short)heap_leaf(
            crow, s_feat + tt * H, s_bin + tt * H, depth, d);
    }
    __syncthreads();
    add_rows(s_ids, s_acc, aug + r0 * k, nr, nt, tc, L, k);
    __syncthreads();
  }
  float* dst = part + ((long long)blockIdx.x * T + t0) * L * k;
  for (int i = threadIdx.x; i < nt * L * k; i += blockDim.x) dst[i] = s_acc[i];
}

// Block (chunk, tile) over chain trees; a final slot outside [0, W_out)
// adds nothing.
__global__ void __launch_bounds__(kSumThreads)
chain_sums_kernel(const int* __restrict__ codes, const int* __restrict__ feat,
                  const int* __restrict__ bins, const int* __restrict__ base,
                  const float* __restrict__ aug, float* __restrict__ part,
                  int n, int d, int T, int depth, int W, int W_out, int k,
                  int tc, int S, int lc, int rpc) {
  extern __shared__ int smem[];
  const long long t0 = (long long)blockIdx.y * tc;
  const int nt = min((long long)tc, T - t0);
  int* s_feat = smem;
  int* s_bin = smem + tc * S;
  int* s_base = smem + 2 * tc * S;
  float* s_acc = reinterpret_cast<float*>(smem + 3 * tc * S);
  short* s_ids = reinterpret_cast<short*>(s_acc + (size_t)tc * W_out * k);
  stage_chain(feat, bins, base, s_feat, s_bin, s_base, t0, nt, depth, W, S,
              lc);
  for (int i = threadIdx.x; i < nt * W_out * k; i += blockDim.x)
    s_acc[i] = 0.f;
  __syncthreads();
  const long long lo = (long long)blockIdx.x * rpc;
  const long long hi = min((long long)n, lo + rpc);
  for (long long r0 = lo; r0 < hi; r0 += kSumThreads) {
    const int nr = (int)min((long long)kSumThreads, hi - r0);
    if ((int)threadIdx.x < nr) {
      const int* crow = codes + (r0 + threadIdx.x) * d;
      for (int tt = 0; tt < nt; ++tt) {
        const int off = tt * S;
        const int slot = chain_leaf(crow, s_feat + off, s_bin + off,
                                    s_base + off, depth, W, lc, d);
        s_ids[threadIdx.x * tc + tt] =
            (short)((slot >= 0 && slot < W_out) ? slot : -1);
      }
    }
    __syncthreads();
    add_rows(s_ids, s_acc, aug + r0 * k, nr, nt, tc, W_out, k);
    __syncthreads();
  }
  float* dst = part + ((long long)blockIdx.x * T + t0) * W_out * k;
  for (int i = threadIdx.x; i < nt * W_out * k; i += blockDim.x)
    dst[i] = s_acc[i];
}

// out[i] = part[0, i] + part[1, i] + ... in chunk order.
__global__ void combine_kernel(const float* __restrict__ part,
                               float* __restrict__ out, long long m,
                               int n_chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = part[i];
  for (int c = 1; c < n_chunks; ++c) s += part[(long long)c * m + i];
  out[i] = s;
}

// Trees per leaf-sum tile and the tile's shared memory: as many trees as
// fit in kSumSmem, at most kSumMaxTrees (more tiles, more blocks in
// flight), at least one.
cudaError_t plan_sums(int T, size_t tree_bytes, int* tc, size_t* smem) {
  if (tree_bytes > (size_t)kSmemMax) return cudaErrorInvalidValue;
  long long fit = (long long)(kSumSmem / tree_bytes);
  if (fit < 1) fit = 1;
  if (fit > kSumMaxTrees) fit = kSumMaxTrees;
  if (fit > T) fit = T;
  *tc = (int)fit;
  *smem = (size_t)fit * tree_bytes;
  return cudaSuccess;
}

// Trees per shared-memory chunk, and the bytes that chunk takes: as many
// trees as fit in the default 48 KB, at least one.
void plan_chunk(int T, size_t tree_bytes, int* tc, size_t* smem) {
  size_t per = tree_bytes > 0 ? tree_bytes : 1;
  long long fit = (long long)(kSmemDefault / per);
  if (fit < 1) fit = 1;
  if (fit > T) fit = T > 0 ? T : 1;
  *tc = (int)fit;
  *smem = (size_t)fit * tree_bytes;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= (size_t)kSmemDefault) return cudaSuccess;
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// ceil(log2 W) and the records of a chain tree (chain_records); a heap
// (W = 0) is the chain of W = 2^(depth - 1) whose levels are all narrow.
void chain_shape(int depth, int* W, int* lc, int* S) {
  if (*W == 0) *W = depth > 0 ? 1 << (depth - 1) : 1;
  *lc = 0;
  while ((1 << *lc) < *W) ++*lc;
  *S = chain_records(depth, *W, *lc);
}

int round_up(long long x, int m) { return (int)((x + m - 1) / m * m); }

constexpr int kDevices = 64;               // host caches, per device index
constexpr size_t kSmallForest = 48 * 1024; // records that leave room for 4
                                           // blocks an SM

int sm_count(int device) {
  static int sms[kDevices];
  if (device < 0 || device >= kDevices) return 1;
  if (sms[device] == 0 &&
      (cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                              device) != cudaSuccess || sms[device] < 1))
    sms[device] = 1;
  return sms[device];
}

// The packed path's launch: threads (rows) a block, trees a tile, the
// staged row's bytes (an odd number of words), shared memory.
struct Plan {
  int threads, tc, stride;
  size_t smem;
};

// Plan the packed path, or return false for the wide path: as many rows a
// block as fill the SMs once, or four times where the records are small
// enough for four blocks an SM, fewer where the codes leave no room for a
// tree's records.
bool plan_predict(int n, int d, int T, int depth, int Sp, int device,
                  Plan* p) {
  // a forest whose rows read a few codes each (T x depth <= d / 4, a
  // single shallow tree) reads them faster in place than it copies all d
  if (d > kMaxPackedD || 4LL * T * depth <= d) return false;
  int words = (d + 4) / 4;                   // the codes and the zero byte
  if (!(words & 1)) ++words;
  p->stride = 4 * words;
  const size_t tree = (size_t)Sp * 4;
  const long long per =
      (long long)sm_count(device) * (tree * T <= kSmallForest ? 4 : 1);
  int R = std::max(32, std::min(round_up((n + per - 1) / per, 32),
                                kPredMaxThreads));
  for (; R >= 32; R -= 32) {
    const size_t codes = (size_t)R * p->stride;
    if (codes + tree * T <= (size_t)kSmemMax) {
      p->tc = std::max(T, 1);
      p->smem = codes + tree * T;
    } else {
      const long long tc = ((long long)kSmemMax - (long long)codes) /
                           (2 * (long long)tree);
      if (tc < 1) continue;
      p->tc = (int)tc;
      p->smem = codes + 2 * tree * tc;
    }
    p->threads = R;
    return true;
  }
  return false;
}

// Opt a kernel into smem bytes of dynamic shared memory once per device.
template <typename Kernel>
cudaError_t allow_smem_cached(Kernel kernel, size_t smem, int device,
                              size_t* done) {
  if (device >= 0 && device < kDevices && smem <= done[device])
    return cudaSuccess;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess && device >= 0 && device < kDevices)
    done[device] = smem;
  return err;
}

// Launch the packed path: records into rec, then the descent, kCols
// output columns a launch (leaf ids with the first).
cudaError_t predict_packed(const int* codes, const int* feat,
                           const int* bins, const int* base,
                           const float* leaf, float* out, int* ids,
                           unsigned* rec, int n, int d, int T, int depth,
                           int W, int lc, int S, int W_out, int k,
                           const Plan& p, int device, cudaStream_t stream) {
  static size_t done[kDevices];
  const int Sp = round_up(S, 4);
  const long long m = (long long)T * Sp;
  cudaError_t err;
  if (m > 0) {
    pack_kernel<<<(unsigned)std::min((m + 255) / 256, 4096LL), 256, 0,
                  stream>>>(feat, bins, base, rec, T, depth, W, lc, Sp, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  err = allow_smem_cached(predict_kernel, p.smem, device, done);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && ((uintptr_t)codes & 15) == 0;
  const unsigned blocks =
      (unsigned)(((long long)n + p.threads - 1) / p.threads);
  for (int k0 = 0; k0 < k; k0 += kCols) {
    predict_kernel<<<blocks, p.threads, p.smem, stream>>>(
        codes, rec, base, leaf, out, k0 == 0 ? ids : nullptr, n, d, T, depth,
        W, lc, Sp, W_out, k, k0, std::min(kCols, k - k0), p.tc, p.stride,
        vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* tg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The words of the record workspace forest_predict_heap (W 0) or
// forest_predict_chain takes for T trees of this depth and width.
int forest_predict_workspace(int T, int depth, int W, long long* words) {
  if (T < 0 || depth < 0 || W < 0) return (int)cudaErrorInvalidValue;
  int lc, S;
  chain_shape(depth, &W, &lc, &S);
  *words = (long long)T * round_up(S, 4);
  return 0;
}

// codes (n, d) int32 in [0, n_bins); feat, bins (T, 2^depth - 1) int32;
// leaf (T, 2^depth, k) f32; rec: forest_predict_workspace words -> out
// (n, k) f32; ids (n, T) int32 or null.
int forest_predict_heap(const void* codes, const void* feat,
                        const void* bins, const void* leaf, void* out,
                        void* ids, void* rec, int n, int d, int T, int depth,
                        int k, int n_bins, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  int W = 0, lc, S;
  chain_shape(depth, &W, &lc, &S);
  Plan p;
  if (n_bins <= 256 && depth <= kMaxPackedHeapDepth &&
      plan_predict(n, d, T, depth, round_up(S, 4), device, &p))
    return (int)predict_packed(
        (const int*)codes, (const int*)feat, (const int*)bins, nullptr,
        (const float*)leaf, (float*)out, (int*)ids, (unsigned*)rec, n, d, T,
        depth, W, lc, S, 1 << depth, k, p, device, (cudaStream_t)stream);
  const int H = (1 << depth) - 1;
  int tc;
  size_t smem;
  plan_chunk(T, 2 * sizeof(int) * (size_t)H, &tc, &smem);
  err = allow_smem(heap_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  heap_kernel<<<blocks, kRows, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feat, (const int*)bins,
      (const float*)leaf, (float*)out, (int*)ids, n, d, T, depth, k, tc);
  return (int)cudaGetLastError();
}

// codes (n, d) int32 in [0, n_bins); feat, bins, base (T, depth, W) int32;
// leaf (T, W_out, k) f32; rec: forest_predict_workspace words -> out (n,
// k) f32; ids (n, T) int32 or null.
int forest_predict_chain(const void* codes, const void* feat,
                         const void* bins, const void* base,
                         const void* leaf, void* out, void* ids, void* rec,
                         int n, int d, int T, int depth, int W, int W_out,
                         int k, int n_bins, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  if (W < 1) return (int)cudaErrorInvalidValue;
  int lc, S;
  chain_shape(depth, &W, &lc, &S);
  Plan p;
  if (n_bins <= 256 && W <= kMaxPackedW &&
      plan_predict(n, d, T, depth, round_up(S, 4), device, &p))
    return (int)predict_packed(
        (const int*)codes, (const int*)feat, (const int*)bins,
        (const int*)base, (const float*)leaf, (float*)out, (int*)ids,
        (unsigned*)rec, n, d, T, depth, W, lc, S, W_out, k, p, device,
        (cudaStream_t)stream);
  S -= depth;                                // the used slots, no sinks
  int tc;
  size_t smem;
  plan_chunk(T, 3 * sizeof(int) * (size_t)S, &tc, &smem);
  err = allow_smem(chain_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  chain_kernel<<<blocks, kRows, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feat, (const int*)bins,
      (const int*)base, (const float*)leaf, (float*)out, (int*)ids, n, d, T,
      depth, W, W_out, k, tc, S, lc);
  return (int)cudaGetLastError();
}

// codes (n, d) int32; feat, bins (T, 2^depth - 1) int32; aug (n, k) f32;
// part (n_chunks, T, 2^depth, k) f32 scratch -> out (T, 2^depth, k) f32.
// Rows [c * rows_per_chunk, +rows_per_chunk) make chunk c.
int forest_leaf_sums_heap(const void* codes, const void* feat,
                          const void* bins, const void* aug, void* part,
                          void* out, int n, int d, int T, int depth, int k,
                          int n_chunks, int rows_per_chunk, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || T <= 0 || k <= 0) return (int)cudaSuccess;
  const int H = (1 << depth) - 1;
  const int L = 1 << depth;
  int tc;
  size_t smem;
  err = plan_sums(T, 2 * sizeof(int) * (size_t)H
                         + sizeof(float) * (size_t)L * k
                         + sizeof(short) * kSumThreads, &tc, &smem);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(heap_sums_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_chunks, (unsigned)((T + tc - 1) / tc));
  heap_sums_kernel<<<grid, kSumThreads, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feat, (const int*)bins,
      (const float*)aug, (float*)part, n, d, T, depth, k, tc,
      rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)T * L * k;
  combine_kernel<<<(unsigned)((m + 255) / 256), 256, 0,
                   (cudaStream_t)stream>>>((const float*)part, (float*)out,
                                           m, n_chunks);
  return (int)cudaGetLastError();
}

// codes (n, d) int32; feat, bins, base (T, depth, W) int32; aug (n, k) f32;
// part (n_chunks, T, W_out, k) f32 scratch -> out (T, W_out, k) f32.
int forest_leaf_sums_chain(const void* codes, const void* feat,
                           const void* bins, const void* base,
                           const void* aug, void* part, void* out, int n,
                           int d, int T, int depth, int W, int W_out, int k,
                           int n_chunks, int rows_per_chunk, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || T <= 0 || k <= 0) return (int)cudaSuccess;
  int lc = 0;
  while ((1 << lc) < W) ++lc;                // ceil(log2 W)
  int S = 0;                                 // used slots per tree
  for (int l = 0; l < depth; ++l) S += l < lc ? (1 << l) : W;
  int tc;
  size_t smem;
  err = plan_sums(T, 3 * sizeof(int) * (size_t)S
                         + sizeof(float) * (size_t)W_out * k
                         + sizeof(short) * kSumThreads, &tc, &smem);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(chain_sums_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_chunks, (unsigned)((T + tc - 1) / tc));
  chain_sums_kernel<<<grid, kSumThreads, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feat, (const int*)bins,
      (const int*)base, (const float*)aug, (float*)part, n, d, T, depth, W,
      W_out, k, tc, S, lc, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)T * W_out * k;
  combine_kernel<<<(unsigned)((m + 255) / 256), 256, 0,
                   (cudaStream_t)stream>>>((const float*)part, (float*)out,
                                           m, n_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
