// One-hot histogram on Hopper: per-row statistics summed by bin code.
//
//   hist[a, f * nb + b] = sum_s A[s, a] * 1[codes[s, f] == b]
//
// hist_matmul replaces transmogrifai_tpu/histeng/kernels.py _hist_pallas,
// which expands a bin-major one-hot in VMEM and feeds a dense MXU product:
// 2 * S * B * d * nb operations for S * B * d useful adds. A code equal to
// nb (or any code outside [0, nb)) is a sentinel and adds nothing. Two
// modes: exact (f32 operands, f32 sums) and not exact (operands rounded to
// bf16 to nearest even, f32 sums), as in the Pallas kernel.
//
// What bounds it on this card: the bytes, each input read once and the
// output written once (GBT refit leaves: S 19,712, d 64, B 128, nb 64,
// ~17 MB, ~5 us at 3.35 TB/s). The first design missed that by ~80x:
// one thread per (stat column, feature) walked a pinned chunk's ~2,464
// rows in series, a load latency per batch of rows, even for the columns
// whose codes are all the sentinel (63 of 64 at a GBT leaf call, where
// the trees are padded to a block of 64), and at nb = 256 the 48 KB
// shared-memory default cut its blocks to 32 threads.
//
// Design:
// * The rows are cut into K chunks exactly as the JAX package's pinned
//   contraction cuts them (chunk k holds rows [k * rows, (k + 1) * rows)),
//   and each chunk into kSplits splits of ceil(rows / kSplits) rows.
// * Pass 0 (hist_flag_kernel) marks, in one bit mask a feature, each chunk
//   that holds a valid code, reading the codes once, coalesced; integer
//   atomics only.
// * Pass 1 (hist_partial_kernel): block (stat tile, feature, chunk) of a
//   marked pair, kSplits x `at` threads: thread (split, column) walks its
//   split's rows in order, 16 rows a batch (their codes and stats loaded
//   together, one wait a batch, then the adds), and adds A[s, a] into its
//   own nb bins in shared memory ([split][bin][column]: a warp's adds fall
//   in distinct banks). Every row adds, with no branch: a row without a
//   valid code adds 0 * A[s, a] into bin 0, which is +-0 for a finite
//   stat and changes no bit (a bin starts at +0 and never holds -0, so x +
//   (+-0) == x). Skipping those rows and the zero stats instead (the
//   first design) cost a branch and a reconvergence a row. The
//   splits cut each column's serial walk over a chunk 16-fold, which is
//   what a single-tree GBT leaf call waits for. Blocks are sized by shared
//   memory (the stat tile `at` shrinks, never the split count): nb 64 runs
//   16 columns, nb 256 runs 4, each in 64 KB. The block then adds its
//   kSplits partials in split order and writes
//   the chunk partial, coalesced along the stat columns, to a (K, d * nb,
//   B) workspace. Pairs without a valid code launch nothing but an exit
//   and write nothing.
// * Pass 2 (hist_combine_kernel): 32 x 32 tiles of the output; each
//   element combines its K chunk partials (an unmarked one is +0 and is
//   not read) in the fixed pairwise order of the JAX package's
//   _tree_combine, ((p0 + p1) + (p2 + p3)) + ..., an odd leftover carried
//   to the next round, and the tile is written transposed through shared
//   memory, coalesced along the output's rows.
// * Non-finite stats spread as the reference's contraction spreads them:
//   there every product A[s, a] * 1[codes[s, f] == b] enters cell (a, f,
//   b), and 0 * (+-Inf or NaN) is NaN. So cell (a, f, b) is NaN when a row
//   whose stat A[s, a] (after the bf16 rounding, when not exact) is not
//   finite has codes[s, f] != b (a sentinel code counts as != b);
//   otherwise it is the ordinary sum, which may itself be +-Inf, or NaN
//   from +Inf + -Inf. Finite inputs pay nothing a row: a non-finite stat
//   reaches one of its split's bins (bin 0 as 0 * stat = NaN when its code
//   is not valid), and the sum over splits that pass 1 already makes for
//   each bin carries it on (no sum that is not finite becomes finite
//   again). Only a block that meets a bin that is not finite walks its
//   rows again, to find the bin that every non-finite row of a column
//   hits, writes NaN into that column's other bins of the chunk partial
//   and marks, per stat column, the chunk as holding a non-finite stat (a
//   bin whose finite stats overflowed finds no such row and keeps its
//   sum). A feature whose chunk holds no valid code launches no walk
//   there, so pass 2 writes NaN where a marked chunk meets an unmarked
//   (feature, chunk) pair; a chunk with no valid code in any feature is
//   scanned by its feature-0 blocks. The rare paths are out of line (no
//   registers taken from the common one).
// * No float atomics: every sum has one fixed order (rows in order within
//   a split, splits in order, chunks in the pinned order), whatever the
//   stat tile or block size, so reruns give the same bits, and
//   integer-valued stats come out exact (while the sums stay below 2^24).
// * Every grid dimension that grows with a width is flattened into grid.x,
//   so no feature or stat count meets grid.y's cap of 65,535.
// * Not taken: staging A and the codes in shared memory with cp.async,
//   double-buffered, one staged copy of A shared by a tile of features
//   (experiments/hist_staged.cu, the same order of sums). It was slower on
//   the card at every shape timed (PERF.md): the shared-memory adds, not
//   the L2 reads of A, bound this pass, and staging adds two shared-memory
//   reads to each add, block barriers to each stage and fewer blocks to
//   each SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/cuda_build.py). Plain C entry points for
// ctypes: pointers and the stream come in as void*, each entry returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kSplits = 16;                // splits per pinned chunk
constexpr int kMaxChunks = 8;              // histeng/kernels.py HIST_SHARDS
constexpr int kMinCols = 1;                // narrowest stat tile
constexpr int kSmemDefault = 48 * 1024;    // opt-in beyond this
constexpr int kSmemTarget = 64 * 1024;     // three blocks an SM
constexpr int kSmemMax = 227 * 1024;
constexpr int kUnroll = 16;                // rows per load batch
constexpr int kFlagGroups = 32;            // row groups of pass 0

// A stat as the sums take it: as is (exact) or rounded to bf16.
__device__ __forceinline__ float stat(float v, int exact) {
  return exact ? v : __bfloat162float(__float2bfloat16_rn(v));
}

// The |value| from which a stat is not finite as the sums take it: +Inf
// as is; rounded to bf16, every value from half an ulp above the largest
// finite bf16 rounds to Inf. !(|v| < it) also holds for NaN.
__device__ __forceinline__ float nonfinite_from(int exact) {
  return __int_as_float(exact ? 0x7f800000 : 0x7f7f8000);
}

// NaN-propagating max.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Fold one non-finite row's code into the bin that every such row hits:
// 0 none yet, b + 1 bin b, -1 none (two bins, or a code outside [0, nb)).
__device__ __forceinline__ int hit_bin(int hit, int c, int nb) {
  const int h = (unsigned)c < (unsigned)nb ? c + 1 : -1;
  return hit == 0 ? h : (hit == h ? hit : -1);
}

// Pass 0: bit k of flags[f] is set when chunk k of feature f holds a valid
// code. Block (feature tile of 32, chunk, row group), 8 warps of rows.
__global__ void hist_flag_kernel(const int* __restrict__ codes,
                                 int* __restrict__ flags, int S, int d,
                                 int nb, int rows) {
  __shared__ int found[32];                  // the block's features
  const int fl = threadIdx.x & 31;
  const int f = blockIdx.x * 32 + fl;
  const int k = blockIdx.y;
  const int G = gridDim.z * (blockDim.x >> 5);
  const int g = blockIdx.z * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (threadIdx.x < 32) found[threadIdx.x] = 0;
  __syncthreads();
  if (f < d) {
    const long long c0 = (long long)k * rows;
    const long long c1 = min(c0 + rows, (long long)S);
    int any = 0;
#pragma unroll 8
    for (long long s = c0 + g; s < c1; s += G)
      any |= (unsigned)__ldg(codes + s * d + f) < (unsigned)nb;
    if (any) found[fl] = 1;                  // the same value: no race
  }
  __syncthreads();
  if (threadIdx.x < 32 && f < d && found[fl]) atomicOr(flags + f, 1 << k);
}

// Pass 1's rare path, out of line so that it costs the common one no
// registers. Thread (split sp, column al) of a block whose bins met a
// value that is not finite finds the bin that all rows [s0, s1) with a
// non-finite stat in column a hit; the threads of split 0 fold those over
// the splits, write NaN into every other bin of their column of the
// chunk partial (out[b * B], b < nb) and mark the chunk in nonfin[a].
// hits: kSplits * at ints of shared memory.
__device__ __noinline__ void nan_other_bins(const int* __restrict__ codes,
                                            const float* __restrict__ A,
                                            long long s0, long long s1,
                                            int d, int f, int B, int a,
                                            int nb, float lim, int sp,
                                            int al, int at, int* hits,
                                            float* out, int* nonfin,
                                            int k) {
  int hit = 0;
  if (a < B)
    for (long long s = s0; s < s1; ++s)
      if (!(fabsf(__ldg(A + s * B + a)) < lim))
        hit = hit_bin(hit, __ldg(codes + s * d + f), nb);
  hits[sp * at + al] = hit;
  __syncthreads();
  if (sp != 0 || a >= B) return;
  for (int q = 1; q < kSplits; ++q) {
    const int h = hits[q * at + al];
    if (h != 0) hit = hit == 0 ? h : (hit == h ? hit : -1);
  }
  if (hit == 0) return;                      // finite stats overflowed
  for (int b = 0; b < nb; ++b)
    if (b + 1 != hit) out[(long long)b * B] = __int_as_float(0x7fffffff);
  atomicOr(nonfin + a, 1 << k);
}

// Pass 1: block (stat tile x feature f, k), stat tiles along grid.x
// first. smem: bins[kSplits][nb][at]. nonfin[a]: bit k set when chunk k
// holds a stat of column a that is not finite as the sums take it.
__global__ void hist_partial_kernel(const int* __restrict__ codes,
                                    const float* __restrict__ A,
                                    const int* __restrict__ flags,
                                    int* __restrict__ nonfin,
                                    float* __restrict__ part, int S, int d,
                                    int B, int nb, int rows, int at,
                                    int stiles, int exact) {
  extern __shared__ float bins[];
  const int f = blockIdx.x / stiles;
  const int k = blockIdx.y;
  const int nt = blockDim.x;
  const int sp = threadIdx.x / at;
  const int al = threadIdx.x - sp * at;
  const int a0 = (blockIdx.x - f * stiles) * at;
  const int a = a0 + al;
  const long long c0 = (long long)k * rows;
  const long long c1 = min(c0 + rows, (long long)S);
  const int sub = (rows + kSplits - 1) / kSplits;
  const long long s0 = min(c0 + (long long)sp * sub, c1);
  const long long s1 = min(s0 + sub, c1);
  if (!(flags[f] >> k & 1)) {
    // no valid code of f in this chunk, nothing to add; where no feature
    // has one, the feature-0 blocks still mark the chunk's non-finite stats
    if (f != 0) return;
    bool any = false;
    for (int g = threadIdx.x; g < d; g += nt) any |= flags[g] >> k & 1;
    if (__syncthreads_or(any) || a >= B) return;
    float top = 0.f;
    for (long long s = s0; s < s1; ++s)
      top = max_nan(top, fabsf(__ldg(A + s * B + a)));
    if (!(top < nonfinite_from(exact))) atomicOr(nonfin + a, 1 << k);
    return;
  }
  for (int i = threadIdx.x; i < kSplits * nb * at; i += nt) bins[i] = 0.f;
  __syncthreads();
  float* mb = bins + sp * nb * at + al;
  if (a < B) {
    long long s = s0;
    // a batch's codes and stats load together (one wait a batch), then
    // the adds in row order
    for (; s + kUnroll <= s1; s += kUnroll) {
      int c[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        c[u] = __ldg(codes + (s + u) * d + f);
        v[u] = __ldg(A + (s + u) * B + a);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = (unsigned)c[u] < (unsigned)nb;
        const float x = stat(v[u], exact);
        mb[(ok ? c[u] : 0) * at] += ok ? x : 0.f * x;
      }
    }
    for (; s < s1; ++s) {
      const int c = __ldg(codes + s * d + f);
      const bool ok = (unsigned)c < (unsigned)nb;
      const float x = stat(__ldg(A + s * B + a), exact);
      mb[(ok ? c : 0) * at] += ok ? x : 0.f * x;
    }
  }
  __syncthreads();
  // the splits in order, then the chunk partial, coalesced along a
  const long long width = (long long)d * nb;
  float* out = part + ((long long)k * width + (long long)f * nb) * B + a0;
  bool bad = false;
  for (int i = threadIdx.x; i < nb * at; i += nt) {
    const int c = i / at;
    const int aj = i - c * at;
    float v = bins[i];
#pragma unroll
    for (int q = 1; q < kSplits; ++q) v += bins[q * nb * at + i];
    bad |= !(fabsf(v) < __int_as_float(0x7f800000));
    if (a0 + aj < B) out[(long long)c * B + aj] = v;
  }
  if (__syncthreads_or(bad))
    nan_other_bins(codes, A, s0, s1, d, f, B, a, nb, nonfinite_from(exact),
                   sp, al, at, reinterpret_cast<int*>(bins), out + al,
                   nonfin, k);
}

// The pinned pairwise order of K partials: ((p0 + p1) + (p2 + p3)) + ...,
// an odd leftover carried to the next round (K = 8, every S >= 8, written
// out so that the partials stay in registers).
__device__ __forceinline__ float tree_combine(float* v, int K) {
  if (K == kMaxChunks)
    return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
  int m = K;
  while (m > 1) {
    const int h = m / 2;
    for (int q = 0; q < h; ++q) v[q] = v[2 * q] + v[2 * q + 1];
    if (m % 2) {
      v[h] = v[m - 1];
      m = h + 1;
    } else {
      m = h;
    }
  }
  return v[0];
}

// Pass 2: block (32 output columns j, 32 stat columns a), the jt tiles
// along j first in grid.x, 32 x 8 threads. A cell is NaN where a chunk
// with a non-finite stat of its column holds no valid code of its feature.
__global__ void hist_combine_kernel(const float* __restrict__ part,
                                    const int* __restrict__ flags,
                                    const int* __restrict__ nonfin,
                                    float* __restrict__ out, int d, int B,
                                    int nb, int K, int jt) {
  __shared__ float tile[32][33];
  const int width = d * nb;                  // the wrapper keeps it < 2^31
  const int j0 = (blockIdx.x % jt) * 32;
  const int a0 = (blockIdx.x / jt) * 32;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int jj = ty; jj < 32; jj += 8) {
    const int j = j0 + jj;
    const int a = a0 + tx;
    float v[kMaxChunks];
    if (j < width && a < B) {
      const int m = flags[j / nb];           // the feature's marked chunks
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k)
        v[k] = m >> k & 1 ? part[((long long)k * width + j) * B + a] : 0.f;
      const float r = m ? tree_combine(v, K) : 0.f;
      tile[jj][tx] = nonfin[a] & ~m ? __int_as_float(0x7fffffff) : r;
    }
  }
  __syncthreads();
  for (int aa = ty; aa < 32; aa += 8) {
    const int a = a0 + aa;
    const int j = j0 + tx;
    if (a < B && j < width) out[(long long)a * width + j] = tile[tx][aa];
  }
}

}  // namespace

extern "C" {

const char* tg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// codes (S, d) int32; A (S, B) f32; flags (d + B) int32 and part (K,
// d * nb, B) f32 workspaces -> out (B, d * nb) f32. rows = ceil(S / K)
// rows per chunk, K <= 8. max_cols bounds the stat tile of pass 1 (a
// power of two, 1..32); it changes no bit of the result.
int hist_matmul(const void* codes, const void* A, void* flags, void* part,
                void* out, int S, int d, int B, int nb, int K, int rows,
                int exact, int max_cols, int device, void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kMaxChunks || nb < 1 || S < 1 || d < 1 || B < 1 ||
      rows < 1 || max_cols < kMinCols || max_cols > 32 ||
      (max_cols & (max_cols - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  // the stat tile: the widest whose bins leave room for three blocks an SM
  int at = max_cols;
  auto smem_of = [&](int c) {
    return (size_t)kSplits * nb * c * sizeof(float);
  };
  while (at > kMinCols && smem_of(at) > (size_t)kSmemTarget) at /= 2;
  const size_t smem = smem_of(at);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)kSmemDefault) {
    err = cudaFuncSetAttribute(hist_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // flags: d feature masks, then B masks of the chunks with a non-finite
  // stat
  int* nonfin = (int*)flags + d;
  err = cudaMemsetAsync(flags, 0, (size_t)(d + B) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid0((unsigned)((d + 31) / 32), (unsigned)K, kFlagGroups);
  hist_flag_kernel<<<grid0, 256, 0, stream>>>((const int*)codes, (int*)flags,
                                              S, d, nb, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // every grid dimension that grows with a width is flattened into
  // grid.x (2^31 - 1 blocks), never grid.y or grid.z (65,535)
  const int stiles = (B + at - 1) / at;
  dim3 grid1((unsigned)((long long)stiles * d), (unsigned)K);
  hist_partial_kernel<<<grid1, kSplits * at, smem, stream>>>(
      (const int*)codes, (const float*)A, (const int*)flags, nonfin,
      (float*)part, S, d, B, nb, rows, at, stiles, exact);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long jt = ((long long)d * nb + 31) / 32;
  hist_combine_kernel<<<(unsigned)(jt * ((B + 31) / 32)), 256, 0, stream>>>(
      (const float*)part, (const int*)flags, nonfin, (float*)out, d, B, nb,
      K, (int)jt);
  return (int)cudaGetLastError();
}

}  // extern "C"
