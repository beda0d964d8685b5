// EXPERIMENT, not on any path: a staged variant of csrc/hist.cu's pass 1,
// kept as the record of a design that was measured and lost on an H100.
// It computes hist_matmul's function in the same order (so it is
// bit-equal to csrc/hist.cu) and is timed against it by
// experiments/hist_staged.py; PERF.md gives the readings.
//
//   hist[a, f * nb + b] = sum_s A[s, a] * 1[codes[s, f] == b]
//
// The idea: csrc/hist.cu's pass 1 gives each feature its own blocks, so
// every feature's blocks re-read each row of A from L2 (48 times at the
// RF sweep's leaf call), and each thread waits on its loads once per
// batch of 16 rows. Here a block takes a tile of F features, stages the
// rows its thread groups walk next into shared memory with cp.async (the
// stat tile's A, 16 bytes a copy, and the listed features' codes),
// double-buffered, and all F features read the one staged copy of A.
//
// Pass 1 (hist_partial_kernel): block (stat tile of `at` columns, feature
// tile of F features, chunk), kGroups x `at` threads. The block lists the
// tile's features marked for its chunk (none: it exits) and gives each of
// the nf listed features G = kGroups / nf' thread groups (nf' = nf rounded
// up to a power of two), which walk G of the chunk's 16 splits at a time,
// in 16 / G rounds; a round ends by adding its splits' bins, in split
// order, to the feature's sums, so the order is csrc/hist.cu's whatever
// F, G or the staging depth. Passes 0 and 2 are csrc/hist.cu's.
//
// Why it lost (PERF.md): the adds, not the L2 reads of A, bound the
// partial pass. Staging adds two shared-memory reads to every add, the
// buffers and the round sums cut the blocks an SM holds from 3 to 2, two
// block barriers a stage of 8-32 rows replace one load wait per 16 rows,
// and a tile of F features walks F times the rows per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/cuda_build.py). Plain C entry points for
// ctypes: pointers and the stream come in as void*, each entry returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kSplits = 16;                // splits per pinned chunk
constexpr int kGroups = 16;                // thread groups of pass 1
constexpr int kMaxChunks = 8;              // histeng/kernels.py HIST_SHARDS
constexpr int kStageRows = 128;            // rows a pass-1 stage holds
constexpr int kSmemDefault = 48 * 1024;    // opt-in beyond this
constexpr int kBinsTarget = 64 * 1024;     // pass 1's bins, at most
constexpr int kSmemMax = 227 * 1024;
constexpr int kFlagGroups = 32;            // row groups of pass 0

// A stat as the sums take it: as is (exact) or rounded to bf16.
__device__ __forceinline__ float stat(float v, int exact) {
  return exact ? v : __bfloat162float(__float2bfloat16_rn(v));
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

// Pass 1: block (stat tile x feature tile, k), kGroups x at threads.
// smem (floats): bins[kGroups][nb][at], acc[F][nb][at], then two staging
// buffers of A (G slots of R rows x at, slot stride R * at + apad) and
// codes (G slots of R rows x F, slot stride R * F + 1).
__global__ void hist_partial_kernel(const int* __restrict__ codes,
                                    const float* __restrict__ A,
                                    const int* __restrict__ flags,
                                    float* __restrict__ part, int S, int d,
                                    int B, int nb, int rows, int at, int F,
                                    int stiles, int exact, int vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int feats[kGroups];             // the tile's marked features
  __shared__ int n_feats;
  const int k = blockIdx.y;
  const int st = blockIdx.x % stiles;
  const int f0 = (blockIdx.x / stiles) * F;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < F && f0 + i < d; ++i)
      if (flags[f0 + i] >> k & 1) feats[n++] = f0 + i;
    n_feats = n;
  }
  __syncthreads();
  const int nf = n_feats;
  if (nf == 0) return;                       // block-uniform
  // slot groups: G per feature, the tile's 16 splits in 16 / G rounds
  int np2 = 1;
  while (np2 < nf) np2 <<= 1;
  const int G = kGroups / np2;
  const int rounds = kSplits / G;
  const int q = tid / at;
  const int al = tid - q * at;
  const int fi = q / G;
  const int g = q - fi * G;
  const int a0 = st * at;
  const int a = a0 + al;
  const bool active = fi < nf && a < B;
  const int R = kStageRows / G;              // rows a slot a stage
  const int apad = at < 32 ? at : 0;         // slots in distinct banks
  const int a_slot = R * at + apad;
  const int c_slot = R * F + 1;
  float* bins = smem;
  float* acc = bins + kGroups * nb * at;
  float* sA = acc + F * nb * at;             // [2][G * a_slot]
  int* sC = reinterpret_cast<int*>(sA + 2 * G * a_slot);  // [2][G * c_slot]
  const long long c0 = (long long)k * rows;
  const long long c1 = min(c0 + rows, (long long)S);
  const int sub = (rows + kSplits - 1) / kSplits;
  const int tiles = (sub + R - 1) / R;       // stages a round
  const int steps = rounds * tiles;
  // rows [s0, s1) of split `sp`
  auto split_rows = [&](int sp, long long& s0, long long& s1) {
    s0 = min(c0 + (long long)sp * sub, c1);
    s1 = min(s0 + sub, c1);
  };
  // stage step u (round u / tiles, tile u % tiles) into buffer `buf`: each
  // slot's R rows of the stat tile (16 bytes a copy where the rows allow
  // it) and of the marked features' codes
  auto stage = [&](int u, int buf) {
    const int r = u / tiles;
    const int t = u - r * tiles;
    float* dA = sA + buf * G * a_slot;
    int* dC = sC + buf * G * c_slot;
    const int cols = min(at, B - a0);
    if (vec) {
      const int v4 = at / 4;
      for (int i = tid; i < G * R * v4; i += nt) {
        const int gs = i / (R * v4);
        const int rem = i - gs * R * v4;
        const int rr = rem / v4;
        const int c = 4 * (rem - rr * v4);
        long long s0, s1;
        split_rows(r * G + gs, s0, s1);
        const long long s = s0 + (long long)t * R + rr;
        if (s < s1 && c < cols)
          cp_async16(dA + gs * a_slot + rr * at + c, A + s * B + a0 + c);
      }
    } else {
      for (int i = tid; i < G * R * at; i += nt) {
        const int gs = i / (R * at);
        const int rem = i - gs * R * at;
        const int rr = rem / at;
        const int c = rem - rr * at;
        long long s0, s1;
        split_rows(r * G + gs, s0, s1);
        const long long s = s0 + (long long)t * R + rr;
        if (s < s1 && c < cols)
          cp_async4(dA + gs * a_slot + rr * at + c, A + s * B + a0 + c);
      }
    }
    for (int i = tid; i < G * R * nf; i += nt) {
      const int gs = i / (R * nf);
      const int rem = i - gs * R * nf;
      const int rr = rem / nf;
      const int ff = rem - rr * nf;
      long long s0, s1;
      split_rows(r * G + gs, s0, s1);
      const long long s = s0 + (long long)t * R + rr;
      if (s < s1)
        cp_async4(dC + gs * c_slot + rr * F + ff, codes + s * d + feats[ff]);
    }
    cp_async_commit();
  };
  float* mb = bins + q * nb * at + al;
  for (int i = tid; i < kGroups * nb * at; i += nt) bins[i] = 0.f;
  stage(0, 0);
  const long long width = (long long)d * nb;
  for (int u = 0; u < steps; ++u) {
    const int buf = u & 1;
    if (u + 1 < steps) {
      stage(u + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // the stage has landed
    const int r = u / tiles;
    const int t = u - r * tiles;
    if (active) {
      long long s0, s1;
      split_rows(r * G + g, s0, s1);
      const long long lo = s0 + (long long)t * R;
      const int n = (int)max(0LL, min((long long)R, s1 - lo));
      const float* vA = sA + buf * G * a_slot + g * a_slot + al;
      const int* vC = sC + buf * G * c_slot + g * c_slot + fi;
      // the split's rows in order. A zero stat adds nothing: a bin starts
      // at +0 and never holds -0, so x + (+-0) == x and the add is skipped
#pragma unroll 8
      for (int rr = 0; rr < n; ++rr) {
        const int c = vC[rr * F];
        const float v = vA[rr * at];
        if ((unsigned)c < (unsigned)nb && v != 0.f)
          mb[c * at] += stat(v, exact);
      }
    }
    __syncthreads();                         // the buffer is free again
    if (t == tiles - 1) {
      // fold this round's G splits, in split order, into each feature's
      // sums (the first round starts them); after the last round write the
      // chunk partial, coalesced along a
      const bool last = r == rounds - 1;
      for (int i = tid; i < nf * nb * at; i += nt) {
        const int ff = i / (nb * at);
        const int rem = i - ff * nb * at;
        const float* b = bins + ff * G * nb * at + rem;
        float v = r ? acc[i] + b[0] : b[0];
        for (int gs = 1; gs < G; ++gs) v += b[gs * nb * at];
        if (last) {
          const int c = rem / at;
          const int aj = rem - c * at;
          if (a0 + aj < B)
            part[((long long)k * width + (long long)feats[ff] * nb + c) * B +
                 a0 + aj] = v;
        } else {
          acc[i] = v;
        }
      }
      if (!last) {
        __syncthreads();
        for (int i = tid; i < kGroups * nb * at; i += nt) bins[i] = 0.f;
        __syncthreads();
      }
    }
  }
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

// Pass 2: block (32 output columns j, 32 stat columns a), flattened into
// grid.x (jt tiles along j), 32 x 8 threads.
__global__ void hist_combine_kernel(const float* __restrict__ part,
                                    const int* __restrict__ flags,
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
      tile[jj][tx] = m ? tree_combine(v, K) : 0.f;
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

// codes (S, d) int32; A (S, B) f32; flags (d) int32 and part (K, d * nb,
// B) f32 workspaces -> out (B, d * nb) f32. rows = ceil(S / K) rows per
// chunk, K <= 8. max_cols bounds pass 1's stat tile (a power of two,
// 1..32) and feats is its feature tile (1..16); neither changes a bit of
// the result.
int hist_matmul(const void* codes, const void* A, void* flags, void* part,
                void* out, int S, int d, int B, int nb, int K, int rows,
                int exact, int max_cols, int feats, int device,
                void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kMaxChunks || nb < 1 || S < 1 || d < 1 || B < 1 ||
      rows < 1 || max_cols < 1 || max_cols > 32 ||
      (max_cols & (max_cols - 1)) || feats < 1 || feats > kGroups)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  // the stat tile: the widest whose bins fit kBinsTarget
  int at = max_cols;
  while (at > 1 && (size_t)kGroups * nb * at * sizeof(float) >
                       (size_t)kBinsTarget)
    at /= 2;
  const int apad = at < 32 ? at : 0;
  const size_t smem =
      ((size_t)(kGroups + feats) * nb * at +
       2 * ((size_t)kStageRows * at + (size_t)kGroups * apad) +
       2 * ((size_t)kStageRows * feats + kGroups)) * sizeof(float);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)kSmemDefault) {
    err = cudaFuncSetAttribute(hist_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = at % 4 == 0 && B % 4 == 0 && ((uintptr_t)A & 15) == 0;
  err = cudaMemsetAsync(flags, 0, (size_t)d * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid0((unsigned)((d + 31) / 32), (unsigned)K, kFlagGroups);
  hist_flag_kernel<<<grid0, 256, 0, stream>>>((const int*)codes, (int*)flags,
                                              S, d, nb, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int stiles = (B + at - 1) / at;
  const long long ftiles = (d + feats - 1) / feats;
  dim3 grid1((unsigned)(stiles * ftiles), (unsigned)K);
  hist_partial_kernel<<<grid1, kGroups * at, smem, stream>>>(
      (const int*)codes, (const float*)A, (const int*)flags, (float*)part, S,
      d, B, nb, rows, at, feats, stiles, exact, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long jt = ((long long)d * nb + 31) / 32;
  hist_combine_kernel<<<(unsigned)(jt * ((B + 31) / 32)), 256, 0, stream>>>(
      (const float*)part, (const int*)flags, (float*)out, d, B, nb, K,
      (int)jt);
  return (int)cudaGetLastError();
}

}  // extern "C"
