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
// Non-finite values. The reference contracts a one-hot with the leaf
// values (predict) or the statistics (leaf sums) at full f32 precision, so
// a NaN or +-Inf meets every 0 of the one-hot and gives NaN there. Here:
// a predict's output column is NaN for every row if a leaf value of it is
// NaN, and otherwise for every row that misses one of its +-Inf leaves (a
// row reaching all of them gets the float sum); a leaf sum's stat column
// is NaN in every cell if a row's stat is NaN, and a +-Inf stat makes
// every cell of each tree NaN but the one leaf its rows reach (NaN too if
// they reach two, or none). Finite inputs keep their bits.
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
//   so a slot outside its level goes to slot 0 with no branch. The same
//   pass counts the leaf table's NaN and +-Inf values per output column.
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
//   the rows a block. It also counts the +-Inf leaf values it adds: a row
//   that reaches fewer than all of its column's is NaN there. The kernel
//   is a template on the columns a launch sums (1 to 4), so that no
//   column past k costs an add or a count. Each output element is
//   written once. (Other launch shapes, timed and not taken:
//   experiments/forest_variants.cu.)
// * More than 4095 features, more than 256 bins, W > 512, heaps deeper
//   than 10 or a row stride that leaves no room for a tree take the first
//   design (the wide path below), which reads everything as int32 and
//   scans the leaf table in every block; so do forests whose rows read few
//   codes (T x depth <= d / 4: a single shallow tree, such as a decision
//   tree), for which copying all d codes of a row costs more than reading
//   those few in place.
//
// Leaf sums. What bounds them: the bytes (codes, tables, stats once, sums
// written once) take ~2 us at the RF refit (19,712 rows, 50 chain trees of
// depth 12, W 256, k 3); the work is a descent per (row, tree) and then k
// adds into a cell that only the data decides. The sums must keep their
// bits on a rerun and be exact on integer-valued stats, so there are no
// float atomics, and the order is fixed by the row count alone: rows in
// ascending order within the chunks of ops/forest.py row_chunks(n), each
// cell starting from +0.0f, then the chunk partials in chunk order (a
// partial never is -0.0, so an empty chunk adds nothing to the bits). The
// first design (one thread per (tree, stat) walking the chunk's rows as a
// chain of shared-memory read-modify-writes, 15 of 128 threads busy at the
// RF refit; int32 codes read from global memory at every step; three int
// tables restaged per block) ran at 160-240x the byte bound (PERF.md).
// This design:
// * The predict's pass packs the records once a call (and sets the
//   non-finite flags below to their start values). Block (chunk, tile of
//   trees): the tile's records go to shared memory with cp.async while the
//   chunk's rows of codes are staged as bytes (eight 16-byte loads in
//   flight a thread), up to 512 rows at a time, with their stats; a thread
//   walks its row down four trees at once (the predict's descent) and
//   writes the leaf ids to shared memory; then each warp marks, for each
//   tree, the lanes (rows) that reach one leaf (__match_any_sync: peers).
// * The adds, with every warp busy and no atomics: a warp takes a (tree,
//   stat) pair and 32 rows at a time; the lanes of a group of peers each
//   add the group's stats in lane (row) order, one shuffle a round (four
//   in flight), and the group's lowest lane adds them to its cell, which
//   lives in shared memory for the whole chunk. Each block writes its
//   (tile, leaves, k) partial once. (Designs timed and not taken: the
//   lowest lane walking its peers' stats in shared memory, peers matched
//   per (tree, stat), a warp per tree; experiments/forest_variants.py.)
// * A thread whose row holds a stat that is not finite records it with
//   integer atomics, which are deterministic: a NaN flag per stat, and per
//   (tree, stat) the lowest and highest leaf such rows reach (W_out for
//   none). The combine pass adds the chunk partials in chunk order and
//   writes NaN where the flags rule a cell out.
// * Tiles: trees a tile such that the blocks fill every SM twice, within
//   ~113 KB of shared memory a block (two blocks an SM).
// * More than 4095 features, more than 256 bins, W > 512 or heaps deeper
//   than 10 take the first design (wide path), with the same flags and
//   combine.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/cuda_build.py). Plain C entry points for
// ctypes: pointers and the stream come in as void*, each entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kRows = 128;                 // wide path: rows (threads) a block
constexpr int kCols = 4;                   // output columns summed per pass
constexpr int kSmemDefault = 48 * 1024;    // opt-in beyond this
constexpr int kSmemMax = 227 * 1024;
constexpr int kSumThreads = 128;           // wide leaf sums: rows per tile
constexpr int kSumSmem = 96 * 1024;        // wide leaf sums: target per block
constexpr int kSumMaxTrees = 16;           // wide leaf sums: trees per tile

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
// Non-finite values
// ---------------------------------------------------------------------------

// Block-wide: a NaN flag and the count of +-Inf values in columns [k0, k0 +
// kc) of a (rows, k) leaf table, added into s_nan / s_inf (zeroed by the
// caller before a barrier). The wide path's predicts scan in every block.
__device__ void scan_leaves(const float* __restrict__ leaf, long long rows,
                            int k, int k0, int kc, int* s_nan, int* s_inf) {
  for (long long i = threadIdx.x; i < rows * kc; i += blockDim.x) {
    const long long r = i / kc;
    const int c = (int)(i - r * kc);
    const float v = __ldg(leaf + r * k + k0 + c);
    if (isnan(v)) atomicOr(s_nan + c, 1);
    else if (isinf(v)) atomicAdd(s_inf + c, 1);
  }
}

// A predict's output: NaN where the leaf table has a NaN in the column or
// the row reached fewer than all of its +-Inf leaves (hit of n_inf).
__device__ __forceinline__ float spread(float acc, int nan, int hit,
                                        int n_inf) {
  return nan || hit != n_inf ? __int_as_float(0x7fc00000) : acc;
}

// Leaf sums' flags, int32 words: nan[k], lo[T][k], hi[T][k].
__device__ __forceinline__ int flag_start(int i, int k, int T) {
  return i < k ? 0 : (i < k + T * k ? INT_MAX : -1);
}

// A row's stats a[0, k) that are not finite, for the combine: NaN in stat
// c sets nan[c]; +-Inf lowers lo and raises hi of (tree, c) to the leaf
// leaf_of(tt) it reaches in each tree t0 + tt of the tile (W_out: none).
template <typename LeafOf>
__device__ __forceinline__ void note_nonfinite(const float* a, int k,
                                               int* flags, int T, int t0,
                                               int ntt, LeafOf leaf_of) {
  for (int c = 0; c < k; ++c) {
    const float v = a[c];
    if (isfinite(v)) continue;
    if (isnan(v)) {
      atomicOr(flags + c, 1);
      continue;
    }
    for (int tt = 0; tt < ntt; ++tt) {
      const int l = leaf_of(tt);
      atomicMin(flags + k + (t0 + tt) * k + c, l);
      atomicMax(flags + k + (T + t0 + tt) * k + c, l);
    }
  }
}

// ---------------------------------------------------------------------------
// Packed records, codes as bytes in shared memory
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
constexpr int kPackThreads = 256;
constexpr int kScanRows = 512;             // leaf rows a scan slice takes
constexpr int kMaxScanSlices = 64;
constexpr int kStageLoads = 8;             // code loads in flight a thread
// static shared memory beside the dynamic: the predicts' column flags
constexpr int kFlagSmem = 2 * kCols * sizeof(int);

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

// Blocks [0, rec_blocks): pack every tree's slots into records (see above
// and the top of the file; rec null: none): rec (T, Sp), a tree's levels
// one after the other, then zeros. A heap (base null) is the chain of W =
// 2^(depth - 1) whose level l, slot j is heap node 2^l - 1 + j, with base
// 2 j. With flags (leaf sums), also set them to their start values.
// Blocks past those (predict): block s scans column s % k of slice s / k of
// the (rows, k) leaf table, writing scan[2 s] its NaN flag and scan[2 s +
// 1] its count of +-Inf values.
__global__ void pack_kernel(const int* __restrict__ feat,
                            const int* __restrict__ bins,
                            const int* __restrict__ base,
                            unsigned* __restrict__ rec, int T, int depth,
                            int W, int lc, int Sp, int d, int rec_blocks,
                            int* __restrict__ flags, int k,
                            const float* __restrict__ leaf, long long rows,
                            int* __restrict__ scan, int slices) {
  if ((int)blockIdx.x >= rec_blocks) {
    __shared__ int s_nan, s_inf;
    const int s = blockIdx.x - rec_blocks;
    const int c = s % k;
    const long long per = (rows + slices - 1) / slices;
    const long long lo = (s / k) * per;
    const long long hi = min(rows, lo + per);
    if (threadIdx.x == 0) s_nan = s_inf = 0;
    __syncthreads();
    int nan = 0, inf = 0;
    for (long long r = lo + threadIdx.x; r < hi; r += blockDim.x) {
      const float v = __ldg(leaf + r * k + c);
      nan |= isnan(v);
      inf += isinf(v);
    }
    if (nan) atomicOr(&s_nan, 1);
    if (inf) atomicAdd(&s_inf, inf);
    __syncthreads();
    if (threadIdx.x == 0) {
      scan[2 * s] = s_nan;
      scan[2 * s + 1] = s_inf;
    }
    return;
  }
  const long long stride = (long long)rec_blocks * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (flags != nullptr)
    for (long long i = first; i < k + 2LL * T * k; i += stride)
      flags[i] = flag_start((int)i, k, T);
  const long long m = rec != nullptr ? (long long)T * Sp : 0;
  const int H = (1 << depth) - 1;
  for (long long i = first; i < m; i += stride) {
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

// Copy m rows of codes from crows into sc as bytes, row stride `stride`
// (vec: d % 4 == 0 and crows 16-byte aligned, 16 bytes a load), and zero
// byte d of row threadIdx.x: the zero column a record's feature d reads.
__device__ __forceinline__ void stage_codes(const int* __restrict__ crows,
                                            unsigned char* sc, int m, int d,
                                            int stride, int vec) {
  const int R = blockDim.x;
  const int q = threadIdx.x;
  if (vec) {
    const int dq = d >> 2;
    const int4* c4 = reinterpret_cast<const int4*>(crows);
    for (int i0 = q; i0 < m * dq; i0 += kStageLoads * R) {
      int4 v[kStageLoads];                   // the loads first, in flight
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u)
        if (i0 + u * R < m * dq) v[u] = __ldg(c4 + i0 + u * R);
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int i = i0 + u * R;
        if (i >= m * dq) break;
        const int r = i / dq;
        *reinterpret_cast<unsigned*>(sc + r * stride + 4 * (i - r * dq)) =
            code_byte(v[u].x) | code_byte(v[u].y) << 8 |
            code_byte(v[u].z) << 16 | code_byte(v[u].w) << 24;
      }
    }
  } else {
    for (int i = q; i < m * d; i += R) {
      const int r = i / d;
      sc[r * stride + (i - r * d)] =
          (unsigned char)code_byte(__ldg(crows + i));
    }
  }
  sc[q * stride + d] = 0;
}

// Walk one row (its codes as bytes) down kTrees trees at once: tr[u] holds
// the records of tree tree[u]; slot[u] gets its final slot.
__device__ __forceinline__ void descend(const unsigned* const (&tr)[kTrees],
                                        const int (&tree)[kTrees],
                                        const unsigned char* row,
                                        const int* __restrict__ base,
                                        int depth, int W, int lc,
                                        int (&slot)[kTrees]) {
#pragma unroll
  for (int u = 0; u < kTrees; ++u) slot[u] = 0;
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
  if (depth > 0) {                           // the last level: exact slots
    const int l = depth - 1;
    const unsigned Wl = l < lc ? 1u << l : (unsigned)W;
#pragma unroll
    for (int u = 0; u < kTrees; ++u) {
      const unsigned e = min((unsigned)slot[u], Wl);
      const unsigned x = tr[u][off + e];
      int a = record_base(x);
      if (a == kEscape)
        a = __ldg(base + ((long long)tree[u] * depth + l) * W + e);
      slot[u] = a + (row[x >> kFeatShift] >= (x & 511u));
    }
  }
}

// Block: R = blockDim.x rows from row0 = blockIdx.x * R; thread q walks
// row q down kTrees trees at once (kTrees independent steps in flight).
// Trees in tiles of tc (one tile, or two buffers). smem: the tiles'
// records [nbuf][tc * Sp], then the rows' codes [R][stride] bytes. Sums
// output columns [k0, k0 + KC); scan: the pack pass's leaf counts.
template <int KC>
__global__ void __launch_bounds__(kPredMaxThreads)
predict_kernel(const int* __restrict__ codes, const unsigned* __restrict__ rec,
               const int* __restrict__ base, const float* __restrict__ leaf,
               float* __restrict__ out, int* __restrict__ ids,
               const int* __restrict__ scan, int slices, int n, int d, int T,
               int depth, int W, int lc, int Sp, int W_out, int k, int k0,
               int tc, int stride, int vec) {
  extern __shared__ __align__(16) unsigned pred_smem[];
  __shared__ int s_nan[kCols], s_inf[kCols];
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
  if (q < kCols) s_nan[q] = s_inf[q] = 0;
  __syncthreads();
  for (int i = q; i < KC * slices; i += R) { // the pack pass's slices
    const int* e = scan + 2 * ((i / KC) * k + k0 + i % KC);
    if (e[0]) atomicOr(s_nan + i % KC, 1);
    if (e[1]) atomicAdd(s_inf + i % KC, e[1]);
  }
  // the block's rows of codes, once, as bytes; byte d of a row reads 0
  stage_codes(codes + row0 * d, sc, (int)min((long long)R, n - row0), d,
              stride, vec);
  const unsigned char* row = sc + q * stride;
  float acc[KC];
  int hit[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    acc[c] = 0.f;
    hit[c] = 0;
  }
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
      int tree[kTrees], slot[kTrees];
#pragma unroll
      for (int u = 0; u < kTrees; ++u) {
        const int v = min(tt + u, ntt - 1);
        tr[u] = tb + v * Sp;
        tree[u] = t0 + v;
      }
      descend(tr, tree, row, base, depth, W, lc, slot);
      const long long r = row0 + q;
#pragma unroll
      for (int u = 0; u < kTrees; ++u) {
        if (tt + u >= ntt) break;
        const int t = t0 + tt + u;
        if (ids != nullptr && r < n) ids[r * T + t] = slot[u];
        if ((unsigned)slot[u] < (unsigned)W_out) {
          const float* lv = leaf + ((long long)t * W_out + slot[u]) * k + k0;
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            const float v = __ldg(lv + c);
            acc[c] += v;
            hit[c] += isinf(v);
          }
        }
      }
    }
    __syncthreads();                         // its buffer is free again
  }
  if (ntiles == 0) __syncthreads();          // s_nan, s_inf
  if (row0 + q < n)
#pragma unroll
    for (int c = 0; c < KC; ++c)
      out[(row0 + q) * k + k0 + c] = spread(acc[c], s_nan[c], hit[c],
                                            s_inf[c]);
}

// ---------------------------------------------------------------------------
// The wide path: the first design, every table and code as int32
// ---------------------------------------------------------------------------

// Zero the block's non-finite counts of the next output columns, then scan
// the (rows, k) leaf table into them.
__device__ __forceinline__ void wide_leaf_flags(const float* leaf,
                                                long long rows, int k, int k0,
                                                int kc, int* s_nan,
                                                int* s_inf) {
  __syncthreads();                           // the last columns' reads
  if (threadIdx.x < kCols) s_nan[threadIdx.x] = s_inf[threadIdx.x] = 0;
  __syncthreads();
  scan_leaves(leaf, rows, k, k0, kc, s_nan, s_inf);
  __syncthreads();
}

__global__ void __launch_bounds__(kRows)
heap_kernel(const int* __restrict__ codes, const int* __restrict__ feat,
            const int* __restrict__ bins, const float* __restrict__ leaf,
            float* __restrict__ out, int* __restrict__ ids, int n, int d,
            int T, int depth, int k, int tc) {
  extern __shared__ int smem[];
  __shared__ int s_nan[kCols], s_inf[kCols];
  const int H = (1 << depth) - 1;
  const int L = 1 << depth;
  int* s_feat = smem;
  int* s_bin = smem + tc * H;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const int* crow = codes + (live ? row : 0) * (long long)d;
  for (int k0 = 0; k0 < k; k0 += kCols) {
    const int kc = min(kCols, k - k0);
    wide_leaf_flags(leaf, (long long)T * L, k, k0, kc, s_nan, s_inf);
    float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
    int hit[kCols] = {0, 0, 0, 0};
    bool counting = false;                   // +-Inf leaves in the columns
    for (int c = 0; c < kc; ++c) counting |= s_inf[c] > 0;
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
          if (c < kc) {
            const float v = __ldg(lv + c);
            acc[c] += v;
            if (counting) hit[c] += isinf(v);
          }
      }
    }
    if (live)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < kc)
          out[row * k + k0 + c] = spread(acc[c], s_nan[c], hit[c],
                                         s_inf[c]);
  }
}

__global__ void __launch_bounds__(kRows)
chain_kernel(const int* __restrict__ codes, const int* __restrict__ feat,
             const int* __restrict__ bins, const int* __restrict__ base,
             const float* __restrict__ leaf, float* __restrict__ out,
             int* __restrict__ ids, int n, int d, int T, int depth, int W,
             int W_out, int k, int tc, int S, int lc) {
  extern __shared__ int smem[];
  __shared__ int s_nan[kCols], s_inf[kCols];
  int* s_feat = smem;
  int* s_bin = smem + tc * S;
  int* s_base = smem + 2 * tc * S;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const int* crow = codes + (live ? row : 0) * (long long)d;
  for (int k0 = 0; k0 < k; k0 += kCols) {
    const int kc = min(kCols, k - k0);
    wide_leaf_flags(leaf, (long long)T * W_out, k, k0, kc, s_nan, s_inf);
    float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
    int hit[kCols] = {0, 0, 0, 0};
    bool counting = false;                   // +-Inf leaves in the columns
    for (int c = 0; c < kc; ++c) counting |= s_inf[c] > 0;
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
            if (c < kc) {
              const float v = __ldg(lv + c);
              acc[c] += v;
              if (counting) hit[c] += isinf(v);
            }
        }
      }
    }
    if (live)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < kc)
          out[row * k + k0 + c] = spread(acc[c], s_nan[c], hit[c],
                                         s_inf[c]);
  }
}

// ---------------------------------------------------------------------------
// Leaf sums
// ---------------------------------------------------------------------------

constexpr int kSumMaxRows = 512;           // rows (threads) a block
constexpr int kSumTarget = 113 * 1024;     // shared memory: two blocks an SM

// Block (chunk, tile): rows [chunk * rpc, +rpc) through trees [tile * tc,
// +tc), R = blockDim.x rows at a time; writes part[chunk, t, leaf, c].
// smem: the tile's records [tc][Sp], the cells [tc][W_out][k], the rows'
// stats [R][k], peer masks [tc][R], leaf ids [tc][R] (W_out: none), codes
// [R][stride] bytes.
__global__ void __launch_bounds__(kSumMaxRows)
sums_kernel(const int* __restrict__ codes, const unsigned* __restrict__ rec,
            const int* __restrict__ base, const float* __restrict__ aug,
            float* __restrict__ part, int* __restrict__ flags, int n, int d,
            int T, int depth, int W, int lc, int Sp, int W_out, int k,
            int tc, int rpc, int stride, int vec) {
  extern __shared__ __align__(16) unsigned sum_smem[];
  const int R = blockDim.x;
  const int q = threadIdx.x;
  const int t0 = blockIdx.y * tc;
  const int ntt = min(tc, T - t0);
  const int cells = ntt * W_out * k;
  unsigned* tab = sum_smem;
  float* s_acc = reinterpret_cast<float*>(tab + (size_t)tc * Sp);
  float* s_aug = s_acc + (size_t)tc * W_out * k;
  unsigned* s_peers = reinterpret_cast<unsigned*>(s_aug + (size_t)R * k);
  unsigned short* s_ids = reinterpret_cast<unsigned short*>(
      s_peers + (size_t)tc * R);
  unsigned char* sc = reinterpret_cast<unsigned char*>(s_ids + (size_t)tc * R);
  const unsigned* src = rec + (size_t)t0 * Sp;
  for (int i = 4 * q; i < ntt * Sp; i += 4 * R) cp_async16(tab + i, src + i);
  cp_async_commit();
  for (int i = q; i < cells; i += R) s_acc[i] = 0.f;
  const int warp = q >> 5;
  const int lane = q & 31;
  const long long lo = (long long)blockIdx.x * rpc;
  const long long hi = min((long long)n, lo + rpc);
  for (long long r0 = lo; r0 < hi; r0 += R) {
    const int nr = (int)min((long long)R, hi - r0);
    stage_codes(codes + r0 * d, sc, nr, d, stride, vec);
    for (int i = q; i < nr * k; i += R) s_aug[i] = __ldg(aug + r0 * k + i);
    cp_async_wait<0>();
    __syncthreads();
    if (q < nr) {
      const unsigned char* row = sc + q * stride;
      for (int tt = 0; tt < ntt; tt += kTrees) {
        const unsigned* tr[kTrees];
        int tree[kTrees], slot[kTrees];
#pragma unroll
        for (int u = 0; u < kTrees; ++u) {
          const int v = min(tt + u, ntt - 1);
          tr[u] = tab + v * Sp;
          tree[u] = t0 + v;
        }
        descend(tr, tree, row, base, depth, W, lc, slot);
#pragma unroll
        for (int u = 0; u < kTrees; ++u)
          if (tt + u < ntt)
            s_ids[(tt + u) * R + q] = (unsigned short)(
                (unsigned)slot[u] < (unsigned)W_out ? slot[u] : W_out);
      }
      note_nonfinite(s_aug + q * k, k, flags, T, t0, ntt,
                     [&](int tt) { return (int)s_ids[tt * R + q]; });
    }
    // the lanes of each warp (32 rows) that reach one leaf: peers
    for (int tt = 0; tt < ntt; ++tt)
      s_peers[tt * R + q] = __match_any_sync(
          0xffffffffu, q < nr ? s_ids[tt * R + q] : 0xffffu);
    __syncthreads();
    // warp per (tree, stat), 32 rows at a time: the lanes that reach one
    // leaf (peers) each add the group's stats in lane (row) order, one
    // shuffle a round, and the lowest of them writes the cell
    for (int p = warp; p < ntt * k; p += R >> 5) {
      const int tt = p / k;
      const int c = p - tt * k;
      float* acc = s_acc + (size_t)tt * W_out * k + c;
      const unsigned short* ids = s_ids + tt * R;
      for (int g = 0; g < nr; g += 32) {
        const bool row = g + lane < nr;
        const unsigned id = row ? ids[g + lane] : 0xffffu;
        const float v = row ? s_aug[(g + lane) * k + c] : 0.f;
        const unsigned peers = s_peers[tt * R + g + lane];
        const bool write = id < (unsigned)W_out && lane == __ffs(peers) - 1;
        float a = write ? acc[id * k] : 0.f;
        const int rounds = __reduce_max_sync(0xffffffffu, __popc(peers));
        unsigned m = peers;
        for (int r = 0; r < rounds; r += 4) {  // four shuffles in flight
          float x[4];
          unsigned mm = m;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            x[u] = __shfl_sync(0xffffffffu, v, mm ? __ffs(mm) - 1 : lane);
            mm &= mm - 1;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (m) a += x[u];
            m &= m - 1;
          }
        }
        if (write) acc[id * k] = a;
      }
    }
    __syncthreads();
  }
  float* dst = part + ((size_t)blockIdx.x * T + t0) * W_out * k;
  for (int i = q; i < cells; i += R) dst[i] = s_acc[i];
}

// The wide path's adds: one thread per (tree, statistic) adds the tile's
// rows in row order into its own cells of the tile's (tree, leaf, k)
// accumulator. ids: (rows, tc) leaf ids, -1 adds nothing; aug: the tile's
// first row of statistics.
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

// Wide path, block (chunk, tile): rows [chunk * rpc, +rpc) through heap
// trees [tile * tc, +tc); writes part[chunk, t, leaf, c].
__global__ void __launch_bounds__(kSumThreads)
heap_sums_kernel(const int* __restrict__ codes, const int* __restrict__ feat,
                 const int* __restrict__ bins, const float* __restrict__ aug,
                 float* __restrict__ part, int* __restrict__ flags, int n,
                 int d, int T, int depth, int k, int tc, int rpc) {
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
    const int q = threadIdx.x;
    if (q < nr) {
      const int* crow = codes + (r0 + q) * d;
      for (int tt = 0; tt < nt; ++tt)
        s_ids[q * tc + tt] = (short)heap_leaf(
            crow, s_feat + tt * H, s_bin + tt * H, depth, d);
      note_nonfinite(aug + (r0 + q) * k, k, flags, T, (int)t0, nt,
                     [&](int tt) { return (int)s_ids[q * tc + tt]; });
    }
    __syncthreads();
    add_rows(s_ids, s_acc, aug + r0 * k, nr, nt, tc, L, k);
    __syncthreads();
  }
  float* dst = part + ((long long)blockIdx.x * T + t0) * L * k;
  for (int i = threadIdx.x; i < nt * L * k; i += blockDim.x) dst[i] = s_acc[i];
}

// Wide path, block (chunk, tile) over chain trees; a final slot outside
// [0, W_out) adds nothing.
__global__ void __launch_bounds__(kSumThreads)
chain_sums_kernel(const int* __restrict__ codes, const int* __restrict__ feat,
                  const int* __restrict__ bins, const int* __restrict__ base,
                  const float* __restrict__ aug, float* __restrict__ part,
                  int* __restrict__ flags, int n, int d, int T, int depth,
                  int W, int W_out, int k, int tc, int S, int lc, int rpc) {
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
    const int q = threadIdx.x;
    if (q < nr) {
      const int* crow = codes + (r0 + q) * d;
      for (int tt = 0; tt < nt; ++tt) {
        const int off = tt * S;
        const int slot = chain_leaf(crow, s_feat + off, s_bin + off,
                                    s_base + off, depth, W, lc, d);
        s_ids[q * tc + tt] =
            (short)((slot >= 0 && slot < W_out) ? slot : -1);
      }
      note_nonfinite(aug + (r0 + q) * k, k, flags, T, (int)t0, nt,
                     [&](int tt) {
                       const int id = s_ids[q * tc + tt];
                       return id < 0 ? W_out : id;
                     });
    }
    __syncthreads();
    add_rows(s_ids, s_acc, aug + r0 * k, nr, nt, tc, W_out, k);
    __syncthreads();
  }
  float* dst = part + ((long long)blockIdx.x * T + t0) * W_out * k;
  for (int i = threadIdx.x; i < nt * W_out * k; i += blockDim.x)
    dst[i] = s_acc[i];
}

// out[i] = part[0, i] + part[1, i] + ... in chunk order, NaN where the
// flags rule the cell out: a NaN in its stat, or a +-Inf row of its (tree,
// stat) that reaches another leaf than this one (or none).
__global__ void sums_combine_kernel(const float* __restrict__ part,
                               float* __restrict__ out,
                               const int* __restrict__ flags, int m,
                               int n_chunks, int T, int W_out, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int c = i % k;
  const int tl = i / k;
  const int t = tl / W_out;
  const int nan = flags[c];
  const int lo = flags[k + t * k + c];
  const int hi = flags[k + (T + t) * k + c];
  float s = part[i];
  for (int ch = 1; ch < n_chunks; ++ch) s += part[(long long)ch * m + i];
  if (nan || (hi >= 0 && (lo != hi || lo != tl - t * W_out)))
    s = __int_as_float(0x7fc00000);
  out[i] = s;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Trees per wide leaf-sum tile and the tile's shared memory: as many trees
// as fit in kSumSmem, at most kSumMaxTrees (more tiles, more blocks in
// flight), at least one.
cudaError_t plan_sums_wide(int T, size_t tree_bytes, int* tc, size_t* smem) {
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
// trees as fit in the default 48 KB beside the static flags, at least one.
void plan_chunk(int T, size_t tree_bytes, int* tc, size_t* smem) {
  size_t per = tree_bytes > 0 ? tree_bytes : 1;
  long long fit = (long long)((kSmemDefault - kFlagSmem) / per);
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

// The leaf scan's slices of a (rows, k) leaf table.
int scan_slices(long long rows) {
  return (int)std::max(1LL, std::min((rows + kScanRows - 1) / kScanRows,
                                     (long long)kMaxScanSlices));
}

// The workspace, in 32-bit words: records (T, Sp) at 0; then at `flags`
// the predict's leaf scan (2 k slices words) or, with n_chunks (leaf
// sums), the flags (k + 2 T k words) and at `part` the chunk partials
// (n_chunks, T, W_out, k) f32.
struct Layout {
  long long flags, part, words;
  int Sp, slices;
};

Layout layout(int T, int depth, int W, int W_out, int k, int n_chunks) {
  int lc, S;
  chain_shape(depth, &W, &lc, &S);
  Layout w;
  w.Sp = round_up(S, 4);
  w.slices = scan_slices((long long)T * W_out);
  w.flags = (long long)T * w.Sp;
  if (n_chunks > 0) {
    w.part = (w.flags + k + 2LL * T * k + 3) / 4 * 4;
    w.words = w.part + (long long)n_chunks * T * W_out * k;
  } else {
    w.part = w.words = w.flags + 2LL * k * w.slices;
  }
  return w;
}

// The pack pass: records (records true) and, for leaf sums, the flags'
// start values (flags non-null), or, for a predict, the leaf scan (leaf
// non-null).
cudaError_t pack(const int* feat, const int* bins, const int* base,
                 unsigned* ws, const Layout& w, bool records, int T,
                 int depth, int W, int lc, int d, int k, int* flags,
                 const float* leaf, long long leaf_rows,
                 cudaStream_t stream) {
  const long long m = records ? (long long)T * w.Sp : 0;
  const int rec_blocks = (int)std::max(
      1LL, std::min((m + kPackThreads - 1) / kPackThreads, 4096LL));
  const int scan_blocks = leaf != nullptr ? k * w.slices : 0;
  pack_kernel<<<rec_blocks + scan_blocks, kPackThreads, 0, stream>>>(
      feat, bins, base, records ? ws : nullptr, T, depth, W, lc, w.Sp, d,
      rec_blocks, flags, k,
      leaf, leaf_rows, reinterpret_cast<int*>(ws) + w.flags, w.slices);
  return cudaGetLastError();
}

// The packed path's launch: threads (rows) a block, trees a tile, the
// staged row's bytes (an odd number of words), shared memory.
struct Plan {
  int threads, tc, stride;
  size_t smem;
};

// The staged row of d byte codes and the zero byte: an odd number of words.
int row_stride(int d) {
  int words = (d + 4) / 4;
  if (!(words & 1)) ++words;
  return 4 * words;
}

// Plan the packed path, or return false for the wide path: as many rows a
// block as fill the SMs once, or four times where the records are small
// enough for four blocks an SM, fewer where the codes leave no room for a
// tree's records.
bool plan_predict(int n, int d, int T, int depth, int Sp, int device,
                  Plan* p) {
  // a forest whose rows read a few codes each (T x depth <= d / 4, a
  // single shallow tree) reads them faster in place than it copies all d
  if (d > kMaxPackedD || 4LL * T * depth <= d) return false;
  p->stride = row_stride(d);
  const size_t tree = (size_t)Sp * 4;
  const long long per =
      (long long)sm_count(device) * (tree * T <= kSmallForest ? 4 : 1);
  int R = std::max(32, std::min(round_up((n + per - 1) / per, 32),
                                kPredMaxThreads));
  const long long room = kSmemMax - kFlagSmem;  // beside the static flags
  for (; R >= 32; R -= 32) {
    const size_t codes = (size_t)R * p->stride;
    if (codes + tree * T <= (size_t)room) {
      p->tc = std::max(T, 1);
      p->smem = codes + tree * T;
    } else {
      const long long tc = (room - (long long)codes) / (2 * (long long)tree);
      if (tc < 1) continue;
      p->tc = (int)tc;
      p->smem = codes + 2 * tree * tc;
    }
    p->threads = R;
    return true;
  }
  return false;
}

// Plan the packed leaf sums, or return false for the wide path: a block
// takes the chunk's rows up to kSumMaxRows at a time, and as many trees a
// tile as make the (chunk, tile) blocks fill every SM twice, within
// kSumTarget bytes of shared memory (at least one tree, within kSmemMax).
bool plan_sums(int n_chunks, int rpc, int d, int T, int Sp, int W_out, int k,
               int device, Plan* p) {
  if (d > kMaxPackedD) return false;
  p->stride = row_stride(d);
  p->threads = std::min(round_up(rpc, 32), kSumMaxRows);
  const size_t fixed = (size_t)p->threads * (4 * (size_t)k + p->stride);
  const size_t tree = 4 * (size_t)Sp + 4 * (size_t)W_out * k
                      + 6 * (size_t)p->threads;
  if (fixed + tree > (size_t)kSmemMax) return false;
  const long long tiles = std::max(
      1LL, (2LL * sm_count(device) + n_chunks - 1) / n_chunks);
  long long tc = (T + tiles - 1) / tiles;
  const size_t room = (size_t)kSumTarget > fixed ? kSumTarget - fixed : 0;
  const long long fit = std::max(1LL, (long long)(room / tree));
  tc = std::max(1LL, std::min({tc, fit, (long long)T}));
  p->tc = (int)tc;
  p->smem = fixed + tree * tc;
  return true;
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

// Launch the packed path: records and the leaf scan into ws, then the
// descent, kCols output columns a launch (leaf ids with the first).
cudaError_t predict_packed(const int* codes, const int* feat,
                           const int* bins, const int* base,
                           const float* leaf, float* out, int* ids,
                           unsigned* ws, int n, int d, int T, int depth,
                           int W, int lc, int W_out, int k, const Plan& p,
                           int device, cudaStream_t stream) {
  static size_t done[kCols][kDevices];
  const Layout w = layout(T, depth, W, W_out, k, 0);
  cudaError_t err = pack(feat, bins, base, ws, w, true, T, depth, W, lc, d,
                         k, nullptr, leaf, (long long)T * W_out, stream);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && ((uintptr_t)codes & 15) == 0;
  const unsigned blocks =
      (unsigned)(((long long)n + p.threads - 1) / p.threads);
  for (int k0 = 0; k0 < k; k0 += kCols) {
    auto go = [&](auto kernel, size_t* ok) {
      cudaError_t e = allow_smem_cached(kernel, p.smem, device, ok);
      if (e != cudaSuccess) return e;
      kernel<<<blocks, p.threads, p.smem, stream>>>(
          codes, ws, base, leaf, out, k0 == 0 ? ids : nullptr,
          reinterpret_cast<const int*>(ws) + w.flags, w.slices, n, d, T,
          depth, W, lc, w.Sp, W_out, k, k0, p.tc, p.stride, vec);
      return cudaGetLastError();
    };
    switch (std::min(kCols, k - k0)) {       // the columns of this launch
      case 1: err = go(predict_kernel<1>, done[0]); break;
      case 2: err = go(predict_kernel<2>, done[1]); break;
      case 3: err = go(predict_kernel<3>, done[2]); break;
      default: err = go(predict_kernel<4>, done[3]); break;
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Leaf sums, both layouts (base null: heaps): the pack pass, the (chunk,
// tile) blocks, then the combine. packed: the byte path may be taken.
cudaError_t leaf_sums(const int* codes, const int* feat, const int* bins,
                      const int* base, const float* aug, unsigned* ws,
                      float* out, int n, int d, int T, int depth, int W,
                      int W_out, int k, bool packed, int n_chunks, int rpc,
                      int device, cudaStream_t stream) {
  static size_t done[kDevices];
  const bool heap = base == nullptr;
  int lc, S;
  chain_shape(depth, &W, &lc, &S);
  const Layout w = layout(T, depth, heap ? 0 : W, W_out, k, n_chunks);
  int* flags = reinterpret_cast<int*>(ws) + w.flags;
  float* part = reinterpret_cast<float*>(ws) + w.part;
  Plan p;
  packed = packed && plan_sums(n_chunks, rpc, d, T, w.Sp, W_out, k, device,
                               &p);
  int tc;
  size_t smem;
  cudaError_t err;
  if (packed) {
    tc = p.tc;
    smem = p.smem;
    err = allow_smem_cached(sums_kernel, smem, device, done);
  } else if (heap) {
    const int H = (1 << depth) - 1;
    err = plan_sums_wide(T, 2 * sizeof(int) * (size_t)H
                                + sizeof(float) * (size_t)W_out * k
                                + sizeof(short) * kSumThreads, &tc, &smem);
    if (err == cudaSuccess) err = allow_smem(heap_sums_kernel, smem);
  } else {
    S -= depth;                              // the used slots, no sinks
    err = plan_sums_wide(T, 3 * sizeof(int) * (size_t)S
                                + sizeof(float) * (size_t)W_out * k
                                + sizeof(short) * kSumThreads, &tc, &smem);
    if (err == cudaSuccess) err = allow_smem(chain_sums_kernel, smem);
  }
  if (err != cudaSuccess) return err;
  err = pack(feat, bins, base, ws, w, packed, T, depth, W, lc, d, k, flags,
             nullptr, 0, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)n_chunks, (unsigned)((T + tc - 1) / tc));
  if (packed)
    sums_kernel<<<grid, p.threads, smem, stream>>>(
        codes, ws, base, aug, part, flags, n, d, T, depth, W, lc, w.Sp,
        W_out, k, tc, rpc, p.stride,
        d % 4 == 0 && ((uintptr_t)codes & 15) == 0);
  else if (heap)
    heap_sums_kernel<<<grid, kSumThreads, smem, stream>>>(
        codes, feat, bins, aug, part, flags, n, d, T, depth, k, tc, rpc);
  else
    chain_sums_kernel<<<grid, kSumThreads, smem, stream>>>(
        codes, feat, bins, base, aug, part, flags, n, d, T, depth, W, W_out,
        k, tc, S, lc, rpc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int m = T * W_out * k;
  sums_combine_kernel<<<(unsigned)((m + 255) / 256), 256, 0, stream>>>(
      part, out, flags, m, n_chunks, T, W_out, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The words of the workspace that forest_predict_heap (W 0) or
// forest_predict_chain (n_chunks 0), or forest_leaf_sums_heap (W 0) or
// forest_leaf_sums_chain over n_chunks row chunks, take for T trees of
// this depth and width with W_out leaves of k values.
int forest_workspace(int T, int depth, int W, int W_out, int k, int n_chunks,
                     long long* words) {
  if (T < 0 || depth < 0 || W < 0 || W_out < 0 || k < 0 || n_chunks < 0)
    return (int)cudaErrorInvalidValue;
  *words = layout(T, depth, W, W_out, k, n_chunks).words;
  return 0;
}

// codes (n, d) int32 in [0, n_bins); feat, bins (T, 2^depth - 1) int32;
// leaf (T, 2^depth, k) f32; ws: forest_workspace words -> out (n, k) f32;
// ids (n, T) int32 or null.
int forest_predict_heap(const void* codes, const void* feat,
                        const void* bins, const void* leaf, void* out,
                        void* ids, void* ws, int n, int d, int T, int depth,
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
        (const float*)leaf, (float*)out, (int*)ids, (unsigned*)ws, n, d, T,
        depth, W, lc, 1 << depth, k, p, device, (cudaStream_t)stream);
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
// leaf (T, W_out, k) f32; ws: forest_workspace words -> out (n, k) f32;
// ids (n, T) int32 or null.
int forest_predict_chain(const void* codes, const void* feat,
                         const void* bins, const void* base,
                         const void* leaf, void* out, void* ids, void* ws,
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
        (unsigned*)ws, n, d, T, depth, W, lc, W_out, k, p, device,
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

// codes (n, d) int32 in [0, n_bins); feat, bins (T, 2^depth - 1) int32;
// aug (n, k) f32; ws: forest_workspace words -> out (T, 2^depth, k) f32.
// Rows [c * rows_per_chunk, +rows_per_chunk) make chunk c.
int forest_leaf_sums_heap(const void* codes, const void* feat,
                          const void* bins, const void* aug, void* ws,
                          void* out, int n, int d, int T, int depth, int k,
                          int n_bins, int n_chunks, int rows_per_chunk,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || T <= 0 || k <= 0) return (int)cudaSuccess;
  return (int)leaf_sums(
      (const int*)codes, (const int*)feat, (const int*)bins, nullptr,
      (const float*)aug, (unsigned*)ws, (float*)out, n, d, T, depth, 0,
      1 << depth, k, n_bins <= 256 && depth <= kMaxPackedHeapDepth,
      n_chunks, rows_per_chunk, device, (cudaStream_t)stream);
}

// codes (n, d) int32 in [0, n_bins); feat, bins, base (T, depth, W) int32;
// aug (n, k) f32; ws: forest_workspace words -> out (T, W_out, k) f32.
int forest_leaf_sums_chain(const void* codes, const void* feat,
                           const void* bins, const void* base,
                           const void* aug, void* ws, void* out, int n,
                           int d, int T, int depth, int W, int W_out, int k,
                           int n_bins, int n_chunks, int rows_per_chunk,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || T <= 0 || k <= 0) return (int)cudaSuccess;
  if (W < 1) return (int)cudaErrorInvalidValue;
  return (int)leaf_sums(
      (const int*)codes, (const int*)feat, (const int*)bins,
      (const int*)base, (const float*)aug, (unsigned*)ws, (float*)out, n, d,
      T, depth, W, W_out, k, n_bins <= 256 && W <= kMaxPackedW, n_chunks,
      rows_per_chunk, device, (cudaStream_t)stream);
}

}  // extern "C"
