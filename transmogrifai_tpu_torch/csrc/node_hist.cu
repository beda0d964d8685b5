// Node histogram of tree growth on Hopper: each tree's rows, grouped by
// their current slot, add their stats into (slot, feature, bin) cells.
//
//   hist[ki, j, t, f, b] = sum_s bf16(sw[ki][s, t]) * 1[node[s, t] == stride * j]
//                                                  * 1[codes[s, f] == b]
//
// node_hist replaces docs/experiments/node_hist_pallas.py _node_hist_pallas
// (and the masked-stat contraction the JAX package runs instead of it,
// transmogrifai_tpu/histeng/kernels.py _node_hist_xla), which expand a
// (S, k * Wl * T) slot-one-hot x stat operand and multiply it with the bin
// one-hot: 2 * S * k * Wl * T * d * nb operations for S * k * T * d useful
// adds, over lanes padded to the TPU's 128-wide layout. Here no operand is
// built and no lane is padded: a row adds into the cells of its own slot
// only. A node value that is negative, odd under stride 2, or >= stride * Wl
// adds nothing; a code outside [0, nb) (the sentinel nb) adds nothing. Stats
// are rounded to bf16 (round to nearest even) as the growth operand is;
// sums are f32.
//
// What bounds it on this card: the bytes of the output at the RF refit's
// deep levels (k 2, Wl 256, T 50, d 64, nb 32: 210 MB written, ~63 us at
// 3.35 TB/s); at one tree (GBT, T 1) the work is small (~2 us of bytes)
// and what bounds the call is latency: how many SMs get work and how many
// dependent loads each thread waits for.
//
// Design:
// * Inputs are read in place: the growers' int64 node (S, T) and the k
//   stat tensors through their own pointers; nothing is copied per call.
// * Pass A, a stable counting sort of each tree's row ids by slot over
//   many blocks (the first design gave a tree one block, so one SM sorted
//   every row at T = 1): (A1) block (tile, tree) counts its tile's rows per
//   slot (warp-aggregated shared-memory integer atomics) and keeps each
//   row's slot tree-major, so the strided int64 node is read once; (A2)
//   one block per tree turns the counts into an exclusive scan over (slot,
//   tile), so a tile's rows of slot j start where the earlier slots and
//   the earlier tiles' rows of j end, and scans the slots into row, chunk
//   and workspace offsets and each chunk's record; (A3) block (tile, tree)
//   scatters its rows: each warp
//   owns a contiguous range, a row's place is its warp's cursor for the
//   slot plus the lanes before it with the same slot (__match_any_sync).
//   The order (ascending rows within a slot) does not depend on the tile
//   size or the warp count.
// * Every segment (slot of a tree) is cut into chunks of `chunk` rows (a
//   segment of n rows has max(1, ceil(n / chunk)) chunks); chunk = 128
//   spreads a single tree's early levels (19,712 rows in one slot at level
//   0) over 154 blocks.
// * Pass B, block (chunk, tree): the chunk's rows are staged into shared
//   memory in sub-tiles with cp.async (each row's d codes, 16 bytes a
//   thread when the row allows it, and its k stats, rounded to bf16 once),
//   double-buffered, so the adds wait on shared memory only. Where the
//   blocks stage each row's codes once per tree (T > 1: 252 MB as int32 at
//   an RF refit level), nb <= 255 and d % 16 == 0, a pre-pass packs the
//   codes into bytes once a call, so they stage a quarter of the bytes
//   (pass B 21% faster at the RF refit's deepest level; at one tree the
//   pre-pass costs more than it saves, PERF.md). One thread
//   per (stat, feature) pair (pairs beyond the block run in further
//   groups) owns nb f32 bins in shared memory, bin b of thread q at
//   b * threads + q: the lanes of a warp add into 32 distinct banks
//   whatever their codes (the first design's row stride of threads + 1
//   made lanes of different codes collide, ~3.5-way). The bins then go out
//   through a small 32 x 8 tile a warp (row stride 9), each store writing
//   whole 32-byte sectors: a segment's first chunk straight into the
//   output (an empty segment writes zeros), its later chunks into a
//   workspace. Shared memory stays near 21 KB a block at the RF refit
//   shape, for ~10 blocks an SM.
// * Pass C, block (cell tile, segment group, tree): for each segment of
//   more than one chunk (A2 lists them) adds its later chunks' partials,
//   in chunk order, to the first chunk's sums in the output.
// * Non-finite stats spread as the reference's contraction spreads them.
//   Its operand lane (ki, j, t) of row s is bf16(1[node == stride j] *
//   sw[ki][s, t]), and 0 * (+-Inf or NaN) is NaN, so: (1) a row whose f32
//   stat is not finite makes every lane of (ki, t) but its own slot's NaN
//   (a row that adds nothing has no own slot); (2) within a lane, the
//   one-hot rule of hist.cu: a cell (f, b) is NaN when a row of the slot
//   whose rounded stat is not finite has codes[s, f] != b. Finite inputs
//   pay little for it: for (1) each scatter (A3) block reads a slice of the
//   flat stat arrays once, coalesced, with a NaN-propagating max (only a
//   slice with a non-finite value is read again, to record its rows'
//   slots per (ki, t): none yet, one slot, or several; stats past the
//   first four get a pass of their own), and pass C writes NaN into the
//   lanes that (1) names; for
//   (2) the threads that round the staged stats raise a block flag at a
//   non-finite one, and only then does each pair walk its chunk's rows
//   again, to find the bin they all hit, and write NaN into its other
//   bins before the write-out (the chunk sums carry it on).
// * No float atomics: a cell is the sequential sum of each chunk's rows in
//   ascending row order, then of the chunk partials in chunk order, so
//   reruns give the same bits, nothing depends on the launch configuration
//   (block size, sort tile, sort warps, staging depth), and
//   integer-valued stats sum exactly (while the sums stay below 2^24).
//   histeng/kernels.py node_hist_direct sums in the same order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/cuda_build.py). Plain C entry points for
// ctypes: pointers and the stream come in as void*, each entry returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxStats = 4;               // stats per pass-B launch
constexpr int kSmemDefault = 48 * 1024;    // opt-in beyond this
constexpr int kSmemMax = 227 * 1024;
constexpr int kCountThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kCombineThreads = 256;
constexpr int kTileFloats = 32 * 9;        // a warp's write-out tile
constexpr unsigned kFull = 0xffffffffu;

struct Stats {
  const float* p[kMaxStats];
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr unsigned kInfBits = 0x7f800000u;   // |v| bits from here: not finite

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// Fold one value into "the one value they all have": 0 none yet, h, or -1
// (several, or one that is no slot or bin: h = -1).
__device__ __forceinline__ int fold(int have, int h) {
  return have == 0 ? h : (have == h ? have : -1);
}

// The same fold into a word of global memory, by any number of threads.
__device__ __forceinline__ void fold_atomic(int* p, int h) {
  const int old = atomicCAS(p, 0, h);
  if (old != 0 && old != h) atomicExch(p, -1);
}

// The slot j of a node value, or -1 when the row adds nothing.
__device__ __forceinline__ int slot_of(long long v, int stride, int Wl) {
  if (v < 0 || v % stride) return -1;
  v /= stride;
  return v < Wl ? (int)v : -1;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// The "memory" clobber keeps the compiler from moving shared-memory reads
// of the staged data above the wait.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Exclusive prefix of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum. sh: 32 ints of shared memory.
__device__ int block_excl_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) sh[lane] = s;
  }
  __syncthreads();
  const int pre = (w ? sh[w - 1] : 0) + x - v;
  *total = sh[nw - 1];
  __syncthreads();                           // sh may be reused
  return pre;
}

// NaN-propagating max.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A block's slice of the flat (S, T) stat arrays: units [lo, hi) (float4
// where every array is 16-byte aligned, else float), and for block 0 the
// floats after the last whole unit, [tail, ST). The host sizes the slices
// (per units a block, look_plan).
struct Slice {
  long long lo, hi, tail, ST;
  int unit;
};

__device__ __forceinline__ Slice slice_of(int S, int T, long long b,
                                          long long per, int unit) {
  Slice c;
  c.ST = (long long)S * T;
  c.unit = unit;
  const long long nu = unit == 4 ? c.ST >> 2 : c.ST;
  c.lo = min(b * per, nu);
  c.hi = min(c.lo + per, nu);
  c.tail = b == 0 ? nu * unit : c.ST;
  return c;
}

// One unit (a float in .x where unit is 1).
__device__ __forceinline__ float4 unit_at(const float* p, long long i,
                                          int unit) {
  if (unit == 1) return make_float4(__ldg(p + i), 0.f, 0.f, 0.f);
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

// The NaN-propagating max of |x| over one unit.
__device__ __forceinline__ float unit_max(float4 v) {
  return max_nan(max_nan(fabsf(v.x), fabsf(v.y)),
                 max_nan(fabsf(v.z), fabsf(v.w)));
}

// Each thread's first unit of the block's slice of each of the kg arrays
// (zeros past the slice), loaded when the block starts and looked at when
// it is done, so that the loads' latency hides behind the block's work.
struct FirstUnits {
  float4 v[kMaxStats];
};

__device__ __forceinline__ FirstUnits first_units(const Stats& sw, int kg,
                                                  const Slice& c) {
  FirstUnits f;
#pragma unroll
  for (int ki = 0; ki < kMaxStats; ++ki)
    f.v[ki] = ki < kg && c.lo + threadIdx.x < c.hi
                  ? unit_at(sw.p[ki], c.lo + threadIdx.x, c.unit)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  return f;
}

// The block looks at the rest of its slice of the kg flat (S, T) stat
// arrays (first: first_units') and folds, for each value that is not
// finite, its row's slot j into nonfin[ki * T + t] as j + 1 (-1 for a row
// that adds nothing). Coalesced reads and a NaN-propagating max; only a
// block whose slice holds a non-finite value reads it again to find the
// rows.
__device__ void look_nonfinite(const Stats& sw, int kg,
                               const FirstUnits& first, const Slice& c,
                               const long long* __restrict__ node,
                               int* __restrict__ nonfin, int T, int Wl,
                               int stride) {
  float m = 0.f;
#pragma unroll
  for (int ki = 0; ki < kMaxStats; ++ki) {
    if (ki >= kg) break;
    m = max_nan(m, unit_max(first.v[ki]));
    for (long long i = c.lo + threadIdx.x + blockDim.x; i < c.hi;
         i += blockDim.x)
      m = max_nan(m, unit_max(unit_at(sw.p[ki], i, c.unit)));
    for (long long e = c.tail + threadIdx.x; e < c.ST; e += blockDim.x)
      m = max_nan(m, fabsf(__ldg(sw.p[ki] + e)));
  }
  if (!__syncthreads_or(!(m < __int_as_float(0x7f800000)))) return;
  for (int ki = 0; ki < kg; ++ki) {
    auto fold_row = [&](long long e) {
      if (abs_bits(__ldg(sw.p[ki] + e)) >= kInfBits) {
        const int j = slot_of(node[e], stride, Wl);
        fold_atomic(nonfin + ki * T + e % T, j >= 0 ? j + 1 : -1);
      }
    };
    for (long long e = c.lo * c.unit + threadIdx.x; e < c.hi * c.unit;
         e += blockDim.x)
      fold_row(e);
    for (long long e = c.tail + threadIdx.x; e < c.ST; e += blockDim.x)
      fold_row(e);
  }
}

// The stats past the first kMaxStats: look_nonfinite over the grid.
__global__ void node_look_kernel(Stats sw, int kg,
                                 const long long* __restrict__ node,
                                 int* __restrict__ nonfin, int S, int T,
                                 int Wl, int stride, long long per,
                                 int unit) {
  const Slice c = slice_of(S, T, blockIdx.x, per, unit);
  look_nonfinite(sw, kg, first_units(sw, kg, c), c, node, nonfin, T, Wl,
                 stride);
}

// A1: block (tile, t) counts the tile's rows of tree t per slot into
// counts[(t * Wl + j) * tiles + tile], and keeps each row's slot in
// slots[t * S + s] (tree-major, so that A3 reads it coalesced); the tile-0
// blocks clear nonfin (k, T). smem: cnt[Wl] ints.
__global__ void node_count_kernel(const long long* __restrict__ node,
                                  int* __restrict__ counts,
                                  int* __restrict__ slots,
                                  int* __restrict__ nonfin, int S, int T,
                                  int k, int Wl, int stride, int tile_rows) {
  extern __shared__ int cnt[];
  const int tile = blockIdx.x;
  const int t = blockIdx.y;
  const int tiles = gridDim.x;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < Wl; j += blockDim.x) cnt[j] = 0;
  if (tile == 0)                             // pass B folds into it
    for (int ki = threadIdx.x; ki < k; ki += blockDim.x)
      nonfin[ki * T + t] = 0;
  __syncthreads();
  const int s0 = tile * tile_rows;
  const int s1 = min(s0 + tile_rows, S);
  // every lane runs every round, so the warp votes together
  for (int base = s0; base < s1; base += blockDim.x) {
    const int s = base + threadIdx.x;
    const int j = s < s1 ? slot_of(node[(long long)s * T + t], stride, Wl)
                         : -1;
    if (s < s1) slots[(long long)t * S + s] = j;
    const unsigned peers = __match_any_sync(kFull, j);
    if (j >= 0 && lane == __ffs(peers) - 1) atomicAdd(&cnt[j], __popc(peers));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < Wl; j += blockDim.x)
    counts[((long long)t * Wl + j) * tiles + tile] = cnt[j];
}

// A2: block t turns its counts (Wl, tiles) into the exclusive scan over
// (slot, tile) in place, and writes meta (T, 3, Wl + 1): row offsets,
// chunk offsets and the workspace offsets of the chunks after the first
// of multi-chunk segments, per slot; multi (T, Wl + 1): the number of
// multi-chunk segments, then their slots in order; and recs (T,
// max_chunks): each chunk's record (slot, first row, rows, place in its
// segment), rows -1 past the tree's last chunk.
__global__ void node_scan_kernel(int* __restrict__ counts,
                                 int* __restrict__ meta,
                                 int* __restrict__ multi,
                                 int4* __restrict__ recs, int Wl, int tiles,
                                 int chunk, int max_chunks) {
  __shared__ int sh[32];
  const int t = blockIdx.x;
  const int nt = blockDim.x;
  int* c = counts + (long long)t * Wl * tiles;
  // (slot, tile) counts: each thread a contiguous run of items
  const int N = Wl * tiles;
  const int per = (N + nt - 1) / nt;
  const int i0 = min((int)threadIdx.x * per, N);
  const int i1 = min(i0 + per, N);
  int local = 0;
  for (int i = i0; i < i1; ++i) local += c[i];
  int total;
  int acc = block_excl_scan(local, sh, &total);
  for (int i = i0; i < i1; ++i) {
    const int v = c[i];
    c[i] = acc;
    acc += v;
  }
  __syncthreads();
  // slots: rows, chunks, workspace chunks, multi-chunk segments
  int* off = meta + (long long)t * 3 * (Wl + 1);
  int* coff = off + (Wl + 1);
  int* loff = coff + (Wl + 1);
  int* mlist = multi + (long long)t * (Wl + 1);
  int4* rc = recs + (long long)t * max_chunks;
  const int perj = (Wl + nt - 1) / nt;
  const int j0 = min((int)threadIdx.x * perj, Wl);
  const int j1 = min(j0 + perj, Wl);
  int lch = 0, lws = 0, lmul = 0;
  for (int j = j0; j < j1; ++j) {
    const int n = (j + 1 < Wl ? c[(j + 1) * tiles] : total) - c[j * tiles];
    const int nch = n > chunk ? (n + chunk - 1) / chunk : 1;
    lch += nch;
    if (nch > 1) {
      lws += nch - 1;
      lmul += 1;
    }
  }
  int tch, tws, tmul;
  int ach = block_excl_scan(lch, sh, &tch);
  int aws = block_excl_scan(lws, sh, &tws);
  int amul = block_excl_scan(lmul, sh, &tmul);
  for (int j = j0; j < j1; ++j) {
    const int start = c[j * tiles];
    const int n = (j + 1 < Wl ? c[(j + 1) * tiles] : total) - start;
    const int nch = n > chunk ? (n + chunk - 1) / chunk : 1;
    off[j] = start;
    coff[j] = ach;
    loff[j] = aws;
    for (int q = 0; q < nch; ++q)
      rc[ach + q] = make_int4(j, start + q * chunk,
                              min(chunk, max(0, n - q * chunk)), q);
    ach += nch;
    if (nch > 1) {
      aws += nch - 1;
      mlist[1 + amul] = j;
      amul += 1;
    }
  }
  for (int cc = tch + threadIdx.x; cc < max_chunks; cc += nt)
    rc[cc] = make_int4(0, 0, -1, 0);
  if (threadIdx.x == 0) {
    off[Wl] = total;
    coff[Wl] = tch;
    loff[Wl] = tws;
    mlist[0] = tmul;
  }
}

// A3: block (tile, t) scatters the tile's row ids of tree t to their
// sorted places, and looks at its slice of the first kg stats for
// non-finite values. smem: wcnt[warps][Wl] ints.
__global__ void node_scatter_kernel(const int* __restrict__ slots,
                                    const int* __restrict__ counts,
                                    int* __restrict__ rows, Stats sw, int kg,
                                    const long long* __restrict__ node,
                                    int* __restrict__ nonfin, int S, int T,
                                    int Wl, int stride, int tile_rows,
                                    long long look_per, int look_unit) {
  extern __shared__ int wcnt[];
  const int tile = blockIdx.x;
  const int t = blockIdx.y;
  const int tiles = gridDim.x;
  const Slice look = slice_of(S, T, (long long)t * tiles + tile, look_per,
                              look_unit);
  const FirstUnits first = first_units(sw, kg, look);  // looked at last
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < warps * Wl; i += blockDim.x) wcnt[i] = 0;
  __syncthreads();
  const int s0 = tile * tile_rows;
  const int s1 = min(s0 + tile_rows, S);
  const int per = (((s1 - s0) + warps - 1) / warps + 31) & ~31;
  const int w0 = min(s0 + w * per, s1);
  const int w1 = min(w0 + per, s1);
  const int* sl = slots + (long long)t * S;
  for (int base = w0; base < w1; base += 32) {
    const int s = base + lane;
    const int j = s < w1 ? sl[s] : -1;
    const unsigned peers = __match_any_sync(kFull, j);
    if (j >= 0 && lane == __ffs(peers) - 1)
      wcnt[w * Wl + j] += __popc(peers);
  }
  __syncthreads();
  // per slot: the tile's start, then the warps in order
  const int* c = counts + (long long)t * Wl * tiles;
  for (int j = threadIdx.x; j < Wl; j += blockDim.x) {
    int acc = c[(long long)j * tiles + tile];
    for (int v = 0; v < warps; ++v) {
      const int n = wcnt[v * Wl + j];
      wcnt[v * Wl + j] = acc;
      acc += n;
    }
  }
  __syncthreads();
  int* out = rows + (long long)t * S;
  for (int base = w0; base < w1; base += 32) {
    const int s = base + lane;
    const int j = s < w1 ? sl[s] : -1;
    const unsigned peers = __match_any_sync(kFull, j);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (j >= 0) out[wcnt[w * Wl + j] + rank] = s;
    __syncwarp();
    if (j >= 0 && lane == __ffs(peers) - 1) wcnt[w * Wl + j] += __popc(peers);
    __syncwarp();
  }
  look_nonfinite(sw, kg, first, look, node, nonfin, T, Wl, stride);
}

// Codes as bytes, for pass B to stage a quarter of the bytes: a valid
// code (in [0, nb), nb <= 255) as is, any other as 255. Four a thread.
__global__ void node_codes8_kernel(const int4* __restrict__ codes,
                                   unsigned* __restrict__ out, long long n4,
                                   int nb) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int4 c = codes[i];
  auto b = [nb](int v) { return (unsigned)v < (unsigned)nb ? (unsigned)v : 255u; };
  out[i] = b(c.x) | b(c.y) << 8 | b(c.z) << 16 | b(c.w) << 24;
}

// Pass B's rare path, out of line so that it costs the common one no
// registers: NaN in every bin (bq[b * nt]) of the pair (stat sw_k, feature
// f) but the one that all the chunk's rows (seg[0, n)) with a non-finite
// rounded stat hit.
template <typename CodeT>
__device__ __noinline__ void nan_other_bins(const CodeT* __restrict__ codes,
                                            const float* __restrict__ sw_k,
                                            const int* __restrict__ seg,
                                            int n, int d, int f, int T, int t,
                                            int nb, float* bq, int nt) {
  int hit = 0;
  for (int r = 0; r < n; ++r) {
    const long long s = seg[r];
    if (abs_bits(bf16_round(sw_k[s * T + t])) >= kInfBits) {
      const int cd = codes[s * d + f];
      hit = fold(hit, (unsigned)cd < (unsigned)nb ? cd + 1 : -1);
    }
  }
  if (hit != 0)
    for (int b = 0; b < nb; ++b)
      if (b + 1 != hit) bq[b * nt] = __int_as_float(0x7fffffff);
}

// Pass B: block (c, t) sums chunk c of tree t's chunks for kg stats, the
// codes as CodeT (int, or bytes from node_codes8_kernel).
// smem: a union of the staging buffers (codes[2][R * d] CodeT, stats[2][kg
// * R] floats) and the write-out's transpose tiles (kTileFloats a warp),
// then bins[nb][nt].
template <typename CodeT>
__global__ void node_hist_kernel(const CodeT* __restrict__ codes, Stats sw,
                                 const int* __restrict__ meta,
                                 const int4* __restrict__ recs,
                                 const int* __restrict__ rows,
                                 float* __restrict__ out,
                                 float* __restrict__ part, int S, int d,
                                 int T, int kg, int Wl, int nb, int chunk,
                                 int part_slots, int R, int vec, int front) {
  extern __shared__ __align__(16) int smem[];
  const int max_chunks = gridDim.x;
  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int q = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = q & 31;
  const int w = q >> 5;
  const int nw = nt >> 5;
  // one load says which rows this block sums, or that it has none
  const int4 rc = recs[(long long)t * max_chunks + c];
  const int n = rc.z;
  if (n < 0) return;
  const int j = rc.x;
  const int qc = rc.w;                       // chunk within the segment
  const int* seg = rows + (long long)t * S + rc.y;
  const int* loff = meta + (long long)t * 3 * (Wl + 1) + 2 * (Wl + 1);
  const int row_bytes = d * (int)sizeof(CodeT);
  CodeT* scodes = reinterpret_cast<CodeT*>(smem);             // [2][R * d]
  float* sstat = reinterpret_cast<float*>(smem + 2 * R * row_bytes / 4);
  float* tiles32 = reinterpret_cast<float*>(smem);  // [nw][kTileFloats]
  float* bins = reinterpret_cast<float*>(smem + front);  // [nb][nt]
  const int P = kg * d;
  const long long width = (long long)d * nb;
  const int tiles = (n + R - 1) / R;
  // stage sub-tile `it` of the chunk into buffer `buf`: a warp a row's
  // codes at a time, lanes along the row (16 bytes a lane where the rows
  // allow it, else 4), the row ids loaded 32 at a time and passed by
  // shuffles, so no copy waits on a load; the stats a thread a row
  auto stage = [&](int it, int buf) {
    const int ra = it * R;
    const int m = min(R, n - ra);
    char* sc = reinterpret_cast<char*>(scodes) + buf * R * row_bytes;
    float* ss = sstat + buf * kg * R;
    const char* src = reinterpret_cast<const char*>(codes);
    for (int rb = 0; rb < m; rb += 32) {
      const int mine = rb + lane < m ? seg[ra + rb + lane] : 0;
      const int re = min(rb + 32, m);
      for (int r = rb + w; r < re; r += nw) {
        const long long s = __shfl_sync(kFull, mine, r - rb);
        const char* row = src + s * row_bytes;
        char* dst = sc + r * row_bytes;
        if (vec) {
          for (int i = 16 * lane; i < row_bytes; i += 16 * 32)
            cp_async16(dst + i, row + i);
        } else {
          for (int i = 4 * lane; i < row_bytes; i += 4 * 32)
            cp_async4(dst + i, row + i);
        }
      }
    }
    for (int r = q; r < m; r += nt) {
      const long long s = seg[ra + r];
      for (int ki = 0; ki < kg; ++ki)
        cp_async4(ss + ki * R + r, sw.p[ki] + s * T + t);
    }
    cp_async_commit();
  };
  for (int g0 = 0; g0 < P; g0 += nt) {
    const int p = g0 + q;
    const int np = min(nt, P - g0);
    const int ki = p / d;
    const int f = p - ki * d;
    for (int b = 0; b < nb; ++b) bins[b * nt + q] = 0.f;
    bool chunk_bad = false;                  // a staged stat is not finite
    if (tiles) stage(0, 0);
    for (int it = 0; it < tiles; ++it) {
      const int buf = it & 1;
      if (it + 1 < tiles) {
        stage(it + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      // round the stats this thread staged (its own copies have landed)
      const int m = min(R, n - it * R);
      float* ss = sstat + buf * kg * R;
      bool bad = false;
      for (int r = q; r < m; r += nt)
        for (int kk = 0; kk < kg; ++kk) {
          const float v = bf16_round(ss[kk * R + r]);
          ss[kk * R + r] = v;
          bad |= abs_bits(v) >= kInfBits;
        }
      chunk_bad |= __syncthreads_or(bad);
      if (p < P) {
        const CodeT* sc = scodes + buf * R * d + f;
        const float* sv = ss + ki * R;
        float* bq = bins + q;                // a lane's own bank
        for (int r = 0; r < m; ++r) {
          const int cd = sc[r * d];
          if ((unsigned)cd < (unsigned)nb) bq[cd * nt] += sv[r];
        }
      }
      __syncthreads();                       // the buffer is free again
    }
    if (chunk_bad && p < P)
      nan_other_bins(codes, sw.p[ki], seg, n, d, f, T, t, nb, bins + q, nt);
    __syncthreads();                         // every pair's bins summed
    // write-out, a warp 32 pairs at a time, 8 bins at a time: each lane
    // copies its pair's 8 bins into the warp's tile (row stride 9: 32
    // distinct banks), then each store writes 4 pairs x 8 bins, whole
    // 32-byte sectors
    float* tile = tiles32 + w * kTileFloats;
    for (int pb = w * 32; pb < np; pb += nw * 32) {
      const int pl = pb + lane;
      long long base = 0;                    // this lane's pair's first bin
      if (pl < np) {
        const int pp = g0 + pl;
        if (qc == 0) {
          const int kk = pp / d;
          base = (((long long)kk * Wl + j) * T + t) * width +
                 (long long)(pp - kk * d) * nb;
        } else {
          base = ((long long)t * part_slots + loff[j] + qc - 1) *
                     (long long)P * nb + (long long)pp * nb;
        }
      }
      float* dst = qc == 0 ? out : part;
      const int bl = lane & 7;
      for (int b0 = 0; b0 < nb; b0 += 8) {
        if (pl < np)
          for (int bb = 0; bb < 8 && b0 + bb < nb; ++bb)
            tile[lane * 9 + bb] = bins[(b0 + bb) * nt + pl];
        __syncwarp();
#pragma unroll
        for (int i4 = 0; i4 < 32; i4 += 4) {
          const int pi = i4 + (lane >> 3);
          const long long bp = __shfl_sync(kFull, base, pi);
          if (pb + pi < np && b0 + bl < nb)
            dst[bp + b0 + bl] = tile[pi * 9 + bl];
        }
        __syncwarp();
      }
    }
    __syncthreads();                         // bins and tiles free again
  }
}

// Pass C: block (cell tile, g, t) adds, for the multi-chunk segments g,
// g + gridDim.y, ... of tree t, the partials of its later chunks in chunk
// order to its first chunk's (in the output); where nonfin (kg, T) names
// another slot than j (or several), lane j is NaN instead.
__global__ void node_combine_kernel(const int* __restrict__ meta,
                                    const int* __restrict__ multi,
                                    const int* __restrict__ nonfin,
                                    const float* __restrict__ part,
                                    float* __restrict__ out, int d, int T,
                                    int kg, int Wl, int nb, int part_slots) {
  const int t = blockIdx.z;
  const int cells = kg * d * nb;             // the wrapper keeps it < 2^31
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const int* off = meta + (long long)t * 3 * (Wl + 1);
  const int* coff = off + (Wl + 1);
  const int* loff = coff + (Wl + 1);
  const int* mlist = multi + (long long)t * (Wl + 1);
  const int width = d * nb;
  const int ki = i / width;
  const int fb = i - ki * width;
  const int nm = mlist[0];
  const int sp = nonfin[ki * T + t];         // 0: no lane is NaN
  const float nan = __int_as_float(0x7fffffff);
  for (int m = blockIdx.y; m < nm; m += gridDim.y) {
    const int j = mlist[1 + m];
    const int nch = coff[j + 1] - coff[j];
    const float* src =
        part + ((long long)t * part_slots + loff[j]) * cells + i;
    float* dst = out + (((long long)ki * Wl + j) * T + t) * width + fb;
    float acc = *dst;
#pragma unroll 16
    for (int qc = 1; qc < nch; ++qc) acc += src[(long long)(qc - 1) * cells];
    *dst = sp != 0 && sp != j + 1 ? nan : acc;
  }
  if (sp != 0)
    for (int j = blockIdx.y; j < Wl; j += gridDim.y)
      if (sp != j + 1)
        out[(((long long)ki * Wl + j) * T + t) * width + fb] = nan;
}

// The workspace of one call: ints and floats (see node_hist).
struct Layout {
  int tiles;
  int max_chunks;                              // per tree
  long long recs, codes8, counts, meta, multi, slots, rows, nonfin, ints;
  long long part_slots, floats;
};

Layout layout(int S, int d, int T, int k, int Wl, int nb, int chunk,
              int tile_rows) {
  Layout L;
  L.tiles = (S + tile_rows - 1) / tile_rows;
  // at most one chunk per slot plus one per `chunk` rows; the int4 records
  // first, where the workspace is aligned
  L.max_chunks = Wl + (S + chunk - 1) / chunk;
  L.recs = 0;
  L.codes8 = L.recs + 4LL * T * L.max_chunks;  // the codes as bytes
  L.counts = L.codes8 + ((long long)S * d + 3) / 4;
  L.meta = L.counts + (long long)T * Wl * L.tiles;
  L.multi = L.meta + (long long)T * 3 * (Wl + 1);
  L.slots = L.multi + (long long)T * (Wl + 1);
  L.rows = L.slots + (long long)T * S;
  L.nonfin = L.rows + (long long)T * S;
  L.ints = L.nonfin + (long long)k * T;
  // the chunks after the first of segments longer than one chunk: a
  // segment of n > chunk rows has ceil(n / chunk) - 1 < n / chunk of them
  L.part_slots = ((long long)S + chunk - 1) / chunk;
  const int kg = k < kMaxStats ? k : kMaxStats;
  L.floats = (long long)T * L.part_slots * kg * d * nb;
  return L;
}

// Units a block's slice of the flat stat arrays holds (see Slice), over
// nblk blocks: float4 where each of the k arrays is 16-byte aligned.
void look_plan(const void* const* sw, int k, int S, int T, long long nblk,
               long long* per, int* unit) {
  *unit = 4;
  for (int i = 0; i < k; ++i)
    if ((uintptr_t)sw[i] & 15) *unit = 1;
  const long long nu = (long long)S * T / *unit;
  *per = (nu + nblk - 1) / nblk;
}

cudaError_t opt_in(const void* fn, size_t smem) {
  if (smem <= (size_t)kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

const char* tg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The workspace sizes node_hist takes for these arguments: *n_int int32
// and *n_float f32 elements.
int node_hist_workspace(int S, int d, int T, int k, int Wl, int nb,
                        int chunk, int tile_rows, long long* n_int,
                        long long* n_float) {
  if (S < 1 || d < 1 || T < 1 || k < 1 || Wl < 1 || nb < 1 || chunk < 1 ||
      tile_rows < 1)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(S, d, T, k, Wl, nb, chunk, tile_rows);
  *n_int = L.ints;
  *n_float = L.floats;
  return 0;
}

// codes (S, d) int32; node (S, T) int64; sw: k pointers (host array) to
// (S, T) f32 stats; iws (int32, 16-byte aligned) and fws (f32):
// workspaces of n_int and n_float elements, at least what
// node_hist_workspace gives -> out (k, Wl, T, d, nb) f32. chunk (rows per chunk) is part of the
// function: it sets the order of the sums. max_threads bounds pass B's
// block (a multiple of 32), tile_rows and sort_warps set pass A's tiles
// and scatter warps, stage_rows pass B's sub-tile; none changes a bit of
// the result.
int node_hist(const void* codes, const void* node, const void* const* sw,
              void* iws, void* fws, void* out, long long n_int,
              long long n_float, int S, int d, int T, int k, int Wl, int nb,
              int stride, int chunk, int max_threads, int tile_rows,
              int sort_warps, int stage_rows, int device, void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S < 1 || d < 1 || T < 1 || T > 65535 || k < 1 || Wl < 1 || nb < 1 ||
      (stride != 1 && stride != 2) || chunk < 1 ||
      max_threads < 32 || max_threads % 32 || max_threads > 1024 ||
      tile_rows < 1 || sort_warps < 1 || sort_warps > 32 || stage_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const Layout L = layout(S, d, T, k, Wl, nb, chunk, tile_rows);
  if (n_int < L.ints || n_float < L.floats) return (int)cudaErrorInvalidValue;
  int* iw = (int*)iws;
  int* counts = iw + L.counts;
  int* meta = iw + L.meta;
  int* multi = iw + L.multi;
  int4* recs = (int4*)(iw + L.recs);
  int* slots = iw + L.slots;
  int* rows = iw + L.rows;
  int* nonfin = iw + L.nonfin;
  const long long* nd = (const long long*)node;
  // pass A
  const size_t smem_c = (size_t)Wl * sizeof(int);
  if (smem_c > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if ((err = opt_in((const void*)node_count_kernel, smem_c)) != cudaSuccess)
    return (int)err;
  dim3 grid_a((unsigned)L.tiles, (unsigned)T);
  node_count_kernel<<<grid_a, kCountThreads, smem_c, stream>>>(
      nd, counts, slots, nonfin, S, T, k, Wl, stride, tile_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  node_scan_kernel<<<T, kScanThreads, 0, stream>>>(
      counts, meta, multi, recs, Wl, L.tiles, chunk, L.max_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int warps = sort_warps;
  while (warps > 1 &&
         (size_t)warps * Wl * sizeof(int) > (size_t)kSmemDefault)
    warps /= 2;
  const size_t smem_s = (size_t)warps * Wl * sizeof(int);
  if (smem_s > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if ((err = opt_in((const void*)node_scatter_kernel, smem_s)) !=
      cudaSuccess)
    return (int)err;
  // the stats as kMaxStats-pointer groups
  auto group = [&](int k0) {
    Stats st;
    for (int i = 0; i < kMaxStats; ++i)
      st.p[i] = k0 + i < k ? (const float*)sw[k0 + i] : nullptr;
    return st;
  };
  long long per;
  int unit;
  look_plan(sw, k, S, T, (long long)L.tiles * T, &per, &unit);
  node_scatter_kernel<<<grid_a, warps * 32, smem_s, stream>>>(
      slots, counts, rows, group(0), k < kMaxStats ? k : kMaxStats, nd,
      nonfin, S, T, Wl, stride, tile_rows, per, unit);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // the codes as bytes where pass B stages each row's codes more than
  // once (once a tree), they fit and the rows stay 16-byte aligned
  const bool aligned = ((uintptr_t)codes & 15) == 0;
  const bool bytes = T > 1 && nb <= 255 && d % 16 == 0 && aligned;
  const void* pcodes = codes;
  if (bytes) {
    const long long n4 = (long long)S * d / 4;
    node_codes8_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        (const int4*)codes, (unsigned*)(iw + L.codes8), n4, nb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    pcodes = iw + L.codes8;
  }
  const int row_bytes = bytes ? d : 4 * d;
  const bool vec = row_bytes % 16 == 0 && aligned;
  // passes B and C, kMaxStats stats at a time over the same sort
  const long long width = (long long)d * nb;
  for (int k0 = 0; k0 < k; k0 += kMaxStats) {
    const int kg = k - k0 < kMaxStats ? k - k0 : kMaxStats;
    const Stats st = group(k0);
    if (k0 > 0) {                            // A3 looked at the first group
      long long nblk = ((long long)S * T + 1023) / 1024;
      if (nblk > 1024) nblk = 1024;
      look_plan(sw + k0, kg, S, T, nblk, &per, &unit);
      node_look_kernel<<<(unsigned)nblk, 256, 0, stream>>>(
          st, kg, nd, nonfin + (long long)k0 * T, S, T, Wl, stride, per,
          unit);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    const int P = kg * d;
    int threads = ((P + 31) / 32) * 32;
    if (threads > max_threads) threads = max_threads;
    int R = stage_rows;
    // ints before the bins: the staging buffers or the transpose tiles
    auto front_of = [&](int th, int r) {
      const int stage_ints = 2 * r * (row_bytes / 4 + kg);
      const int tile_ints = (th / 32) * kTileFloats;
      return stage_ints > tile_ints ? stage_ints : tile_ints;
    };
    auto smem_of = [&](int th, int r) {
      return ((size_t)front_of(th, r) + (size_t)nb * th) * sizeof(int);
    };
    while (R > 1 && smem_of(threads, R) > (size_t)kSmemDefault) R /= 2;
    while (threads > 32 && smem_of(threads, R) > (size_t)kSmemDefault)
      threads -= 32;
    const size_t smem_b = smem_of(threads, R);
    if (smem_b > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
    float* o = (float*)out + (long long)k0 * Wl * T * width;
    dim3 grid_b((unsigned)L.max_chunks, (unsigned)T);
    if (bytes) {
      if ((err = opt_in((const void*)node_hist_kernel<unsigned char>,
                        smem_b)) != cudaSuccess)
        return (int)err;
      node_hist_kernel<unsigned char><<<grid_b, threads, smem_b, stream>>>(
          (const unsigned char*)pcodes, st, meta, recs, rows, o, (float*)fws,
          S, d, T, kg, Wl, nb, chunk, (int)L.part_slots, R, vec ? 1 : 0,
          front_of(threads, R));
    } else {
      if ((err = opt_in((const void*)node_hist_kernel<int>, smem_b)) !=
          cudaSuccess)
        return (int)err;
      node_hist_kernel<int><<<grid_b, threads, smem_b, stream>>>(
          (const int*)pcodes, st, meta, recs, rows, o, (float*)fws, S, d, T,
          kg, Wl, nb, chunk, (int)L.part_slots, R, vec ? 1 : 0,
          front_of(threads, R));
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // the segments of one tree spread over blocks when trees are few
    const long long cells = (long long)kg * d * nb;
    const long long ctiles = (cells + kCombineThreads - 1) / kCombineThreads;
    long long spread = 1024 / (ctiles * T);
    const long long most = (S + chunk) / (chunk + 1);  // multi-chunk segments
    if (spread > most) spread = most;
    if (spread > Wl) spread = Wl;
    if (spread < 1) spread = 1;
    dim3 grid_c((unsigned)ctiles, (unsigned)spread, (unsigned)T);
    node_combine_kernel<<<grid_c, kCombineThreads, 0, stream>>>(
        meta, multi, nonfin + (long long)k0 * T, (const float*)fws, o, d, T,
        kg, Wl, nb, (int)L.part_slots);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
