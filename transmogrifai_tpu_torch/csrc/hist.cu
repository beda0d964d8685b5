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
// What bounds it: the bytes. Each (stat column, feature) pair reads its
// rows' codes and stats once and adds into its own bins; at the GBT refit
// shape (S 19,712, d 64, B 128, nb 64) that is ~17 MB moved for 1.6e8
// adds, ~5 us of HBM time and ~2.4 us of f32 issue at the card's peaks.
// The dense product the TPU runs would be ~4,000 times the arithmetic.
//
// Design (simple and right first; speed is later work):
// * The rows are cut into K chunks exactly as the JAX package's pinned
//   contraction cuts them (chunk k holds rows [k * rows, (k + 1) * rows)).
// * Pass 1: one thread per (stat column a, feature f) and chunk walks the
//   chunk's rows in order and adds A[s, a] into its own nb bins in shared
//   memory (bin b of thread t at b * threads + t, so a warp's bins sit in
//   distinct banks). Threads with neighbouring a sit in one warp, so the
//   stat loads coalesce and the code load is a broadcast; a thread loads
//   the rows in batches of 8 and reads a stat only for a valid code.
//   Partials go to a (K, d * nb, B) workspace, coalesced along a.
// * Pass 2: one thread per output element combines its K partials in the
//   fixed pairwise order of the JAX package's _tree_combine,
//   ((p0 + p1) + (p2 + p3)) + ..., an odd leftover carried to the next
//   round.
// * No float atomics: every sum has one fixed order, so reruns give the
//   same bits, and integer-valued stats come out exact (while the sums
//   stay below 2^24).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/cuda_build.py). Plain C entry points for
// ctypes: pointers and the stream come in as void*, each entry returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMinThreads = 32;
constexpr int kSmemDefault = 48 * 1024;  // opt-in beyond this
constexpr int kSmemMax = 227 * 1024;
constexpr int kMaxChunks = 8;              // histeng/kernels.py HIST_SHARDS
constexpr int kCombineThreads = 256;
constexpr int kUnroll = 8;                 // rows per load batch

// A stat as the sums take it: as is (exact) or rounded to bf16.
__device__ __forceinline__ float stat(float v, int exact) {
  return exact ? v : __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void hist_partial_kernel(const int* __restrict__ codes,
                                    const float* __restrict__ A,
                                    float* __restrict__ part, int S, int d,
                                    int B, int nb, int rows, int exact) {
  extern __shared__ float bins[];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const long long p = (long long)blockIdx.x * nt + t;
  const int k = blockIdx.y;
  if (p >= (long long)B * d) return;
  const int a = (int)(p % B);
  const int f = (int)(p / B);
  for (int b = 0; b < nb; ++b) bins[b * nt + t] = 0.f;
  const long long s0 = (long long)k * rows;
  const long long s1 = min(s0 + rows, (long long)S);
  long long s = s0;
  // rows in batches of kUnroll: the batch's codes load together, then the
  // stats of its valid codes, then the adds in row order; a thread waits
  // two load latencies per batch instead of one per row
  for (; s + kUnroll <= s1; s += kUnroll) {
    int c[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) c[u] = __ldg(codes + (s + u) * d + f);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = (unsigned)c[u] < (unsigned)nb ? __ldg(A + (s + u) * B + a) : 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if ((unsigned)c[u] < (unsigned)nb)
        bins[c[u] * nt + t] += stat(v[u], exact);
  }
  for (; s < s1; ++s) {
    const int c = __ldg(codes + s * d + f);
    if ((unsigned)c < (unsigned)nb)
      bins[c * nt + t] += stat(__ldg(A + s * B + a), exact);
  }
  const long long width = (long long)d * nb;
  float* out = part + (long long)k * width * B + (long long)f * nb * B + a;
  for (int b = 0; b < nb; ++b) out[(long long)b * B] = bins[b * nt + t];
}

__global__ void hist_combine_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int B,
                                    long long width, int K) {
  const long long i = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= width * B) return;
  const int a = (int)(i % B);
  const long long j = i / B;
  float v[kMaxChunks];
  for (int k = 0; k < K; ++k) v[k] = part[((long long)k * width + j) * B + a];
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
  out[(long long)a * width + j] = v[0];
}

}  // namespace

extern "C" {

const char* tg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// codes (S, d) int32; A (S, B) f32; part (K, d * nb, B) f32 workspace ->
// out (B, d * nb) f32. rows = ceil(S / K) rows per chunk, K <= 8.
int hist_matmul(const void* codes, const void* A, void* part, void* out,
                int S, int d, int B, int nb, int K, int rows, int exact,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kMaxChunks || nb < 1) return (int)cudaErrorInvalidValue;
  int threads = kMaxThreads;
  while (threads > kMinThreads &&
         (size_t)nb * threads * sizeof(float) > (size_t)kSmemDefault)
    threads /= 2;
  const size_t smem = (size_t)nb * threads * sizeof(float);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)kSmemDefault) {
    err = cudaFuncSetAttribute(hist_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long pairs = (long long)B * d;
  dim3 grid((unsigned)((pairs + threads - 1) / threads), (unsigned)K);
  hist_partial_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const float*)A, (float*)part, S, d, B, nb, rows,
      exact);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long width = (long long)d * nb;
  const long long total = width * B;
  hist_combine_kernel<<<(unsigned)((total + kCombineThreads - 1) /
                                   kCombineThreads),
                        kCombineThreads, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)out, B, width, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
