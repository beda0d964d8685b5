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
// All four share the descent below (code_at, chain_width, heap_leaf,
// chain_leaf) over split tables staged in shared memory (stage_heap,
// stage_chain).
//
// A bin equal to n_bins is the "route left" sentinel: codes are < n_bins.
// A split feature outside [0, d) reads code 0 and a chain slot outside its
// level reads as slot 0 with go 0, which is what the JAX package's one-hot
// gathers give for such tables.
//
// What bounds it: each row is independent and its descent is a chain of
// dependent loads (depth levels per tree), so the kernel is bound by load
// latency, not by the bytes it must move (codes once, out once) nor by its
// few integer operations. The design keeps every load of that chain
// on-chip: one thread per row walks its row down the trees in order, the
// split tables of a chunk of trees are staged in shared memory by the
// whole block, and the thread's row of codes stays in L1 across all trees.
// Leaf values are summed in registers in ascending tree order, so reruns
// give the same bits, and each output element is written once.
//
// The leaf sums are a descent followed by a segmented sum, with no float
// atomics, so that reruns give the same bits and integer-valued sums come
// out exact. The rows are cut into chunks by their count alone and the
// trees into tiles that fit in shared memory; one block per (chunk, tile)
// descends a tile of its rows through its trees, writes the leaf ids to
// shared memory, and then one thread per (tree, statistic) adds the rows'
// statistics into its own (tree, leaf) cells in row order. Each block
// writes its (tile trees, leaves, k) partial once; a second pass adds the
// chunk partials in chunk order. A sum therefore never depends on the
// tree tiling. The work is bound by the same load latency as predict plus
// the serial adds of each (tree, statistic) thread, not by bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/cuda_build.py). Plain C entry points for
// ctypes: pointers and the stream come in as void*, each entry returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;                 // rows (threads) per block
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

}  // namespace

extern "C" {

const char* tg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// codes (n, d) int32; feat, bins (T, 2^depth - 1) int32;
// leaf (T, 2^depth, k) f32 -> out (n, k) f32; ids (n, T) int32 or null.
int forest_predict_heap(const void* codes, const void* feat,
                        const void* bins, const void* leaf, void* out,
                        void* ids, int n, int d, int T, int depth, int k,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
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

// codes (n, d) int32; feat, bins, base (T, depth, W) int32;
// leaf (T, W_out, k) f32 -> out (n, k) f32; ids (n, T) int32 or null.
int forest_predict_chain(const void* codes, const void* feat,
                         const void* bins, const void* base,
                         const void* leaf, void* out, void* ids, int n,
                         int d, int T, int depth, int W, int W_out, int k,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  int lc = 0;
  while ((1 << lc) < W) ++lc;                // ceil(log2 W)
  int S = 0;                                 // used slots per tree
  for (int l = 0; l < depth; ++l) S += l < lc ? (1 << l) : W;
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
