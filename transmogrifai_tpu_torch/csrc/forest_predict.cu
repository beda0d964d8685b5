// Forest descent on Hopper: route every row down every tree of an ensemble
// and sum the leaf values it reaches.
//
//   out[s, :] = sum_t leaf[t, node(s, t), :]            (trees in ascending t)
//
// Two layouts, one kernel each:
//
// * forest_predict_heap replaces transmogrifai_tpu/ops/forest.py
//   _predict_pallas (complete-heap trees). Node j of level l sits at heap
//   index 2^l - 1 + j; node' = 2 node + (codes[s, feat] > bin).
// * forest_predict_chain replaces transmogrifai_tpu/ops/forest.py
//   _predict_chain_pallas (slot-chain trees). Level l holds min(2^l, W)
//   slots of (feat, bin, base); slot' = base + (codes[s, feat] > bin).
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

__device__ __forceinline__ int code_at(const int* __restrict__ row, int f,
                                       int d) {
  return (f >= 0 && f < d) ? __ldg(row + f) : 0;
}

// Width of chain level l: min(2^l, W). Levels below lc = ceil(log2 W) are
// narrower than W.
__device__ __forceinline__ int chain_width(int l, int lc, int W) {
  return l < lc ? (1 << l) : W;
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
      for (int i = threadIdx.x; i < nt * H; i += kRows) {
        s_feat[i] = feat[(long long)t0 * H + i];
        s_bin[i] = bins[(long long)t0 * H + i];
      }
      __syncthreads();
      if (!live) continue;
      for (int tt = 0; tt < nt; ++tt) {
        const int* tf = s_feat + tt * H;
        const int* tb = s_bin + tt * H;
        int node = 0;
        for (int l = 0; l < depth; ++l) {
          const int j = (1 << l) - 1 + node;
          node = 2 * node + (code_at(crow, tf[j], d) > tb[j] ? 1 : 0);
        }
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
  const int narrow = (1 << lc) - 1;          // slots of the narrow levels
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const int* crow = codes + (live ? row : 0) * (long long)d;
  for (int k0 = 0; k0 < k; k0 += kCols) {
    const int kc = min(kCols, k - k0);
    float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
    for (int t0 = 0; t0 < T; t0 += tc) {
      const int nt = min(tc, T - t0);
      __syncthreads();
      // stage the used slots of each level, packed level after level
      for (int i = threadIdx.x; i < nt * S; i += kRows) {
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
        const long long src = ((long long)(t0 + tt) * depth + l) * W + j;
        s_feat[i] = feat[src];
        s_bin[i] = bins[src];
        s_base[i] = base[src];
      }
      __syncthreads();
      if (!live) continue;
      for (int tt = 0; tt < nt; ++tt) {
        int slot = 0;
        int off = tt * S;
        for (int l = 0; l < depth; ++l) {
          const int Wl = chain_width(l, lc, W);
          if (slot >= 0 && slot < Wl) {
            const int e = off + slot;
            slot = s_base[e] + (code_at(crow, s_feat[e], d) > s_bin[e] ? 1 : 0);
          } else {
            slot = 0;
          }
          off += Wl;
        }
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

}  // extern "C"
