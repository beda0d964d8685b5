// Node histogram of tree growth on Hopper: each tree's rows, grouped by
// their current slot, add their stats into (slot, feature, bin) cells.
//
//   hist[ki, j, t, f, b] = sum_s bf16(sw[ki, s, t]) * 1[node[s, t] == stride * j]
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
// What bounds it: the bytes of the output. At an RF refit level (k 2, Wl
// 256, T 50, d 64, nb 32) it writes 210 MB, ~63 us at 3.35 TB/s, for ~2.5e6
// row-tree visits; the codes (5 MB at the refit shapes) stay in L2.
//
// Design (simple and right first):
// * Pass A (node_sort_kernel): one block per tree makes a stable counting
//   sort of the row ids by slot: offsets (T, Wl + 1) and rows (T, S), rows
//   ascending within a slot. Each warp owns a contiguous range of rows and
//   counts its rows per slot (integer shared-memory atomics); per-(warp,
//   slot) prefix sums give every warp its cursor per slot; then each warp
//   walks its range again 32 rows at a time, and a row's place is its
//   warp's cursor plus the number of lanes before it with the same slot
//   (__match_any_sync). The order does not depend on the warp count. It
//   also cuts every segment into chunks of `chunk` rows (a segment of n
//   rows has max(1, ceil(n / chunk)) chunks) and numbers them per tree.
// * Pass B (node_hist_kernel): one block per (chunk, tree), one thread per
//   (stat, feature) pair (pairs beyond the block's threads run in further
//   groups over the same rows). Each thread owns nb f32 bins in shared
//   memory (bin b of thread q at b * (threads + 1) + q) and walks its
//   chunk's rows in order, 8 rows a batch: bins[codes[s, f]] +=
//   bf16(sw[ki, s, t]). Then the block writes the bins, coalesced (the odd
//   row stride keeps that read free of bank conflicts): a segment's only
//   chunk straight into the output (an empty segment writes zeros), the
//   chunks of a longer segment into a workspace.
// * Pass C (node_combine_kernel): one block per (slot, tree) of more than
//   one chunk adds its chunks' partials in chunk order into the output.
// * No float atomics: a cell is the sequential sum of each chunk's rows in
//   ascending row order, and the chunk partials are added in order, so
//   reruns give the same bits, nothing depends on the launch
//   configuration, and integer-valued stats sum exactly (while the sums
//   stay below 2^24). histeng/kernels.py node_hist_direct sums in the same
//   order. The chunks spread the early levels, where one slot holds most
//   rows, over many blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/cuda_build.py). Plain C entry points for
// ctypes: pointers and the stream come in as void*, each entry returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMinThreads = 32;
constexpr int kSmemDefault = 48 * 1024;  // opt-in beyond this
constexpr int kSmemMax = 227 * 1024;
constexpr int kUnroll = 8;                 // rows per load batch
constexpr int kCombineThreads = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The slot j of a node value, or -1 when the row adds nothing.
__device__ __forceinline__ int slot_of(int v, int stride, int Wl) {
  if (v < 0 || v % stride) return -1;
  v /= stride;
  return v < Wl ? v : -1;
}

// Pass A: block t sorts tree t's row ids by slot, stably, and numbers the
// chunks. meta (T, 3, Wl + 1): row offsets, chunk offsets, and the
// workspace offsets of the chunks of multi-chunk segments, per slot.
// smem: cnt[warps][Wl] ints, then tot[Wl] ints.
__global__ void node_sort_kernel(const int* __restrict__ node,
                                 int* __restrict__ meta,
                                 int* __restrict__ rows, int S, int T, int Wl,
                                 int stride, int chunk) {
  extern __shared__ int sm[];
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int* cnt = sm;                             // cnt[w * Wl + j]
  int* tot = sm + warps * Wl;                // tot[j]
  for (int i = threadIdx.x; i < warps * Wl; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int per = (S + warps - 1) / warps;
  const int s0 = min(w * per, S);
  const int s1 = min(s0 + per, S);
  for (int s = s0 + lane; s < s1; s += 32) {
    const int j = slot_of(__ldg(node + (long long)s * T + t), stride, Wl);
    if (j >= 0) atomicAdd(&cnt[w * Wl + j], 1);
  }
  __syncthreads();
  // per slot: exclusive prefix over the warps, and the slot's total
  for (int j = threadIdx.x; j < Wl; j += blockDim.x) {
    int acc = 0;
    for (int v = 0; v < warps; ++v) {
      const int c = cnt[v * Wl + j];
      cnt[v * Wl + j] = acc;
      acc += c;
    }
    tot[j] = acc;
  }
  __syncthreads();
  // exclusive prefixes over the slots (Wl is at most a few hundred)
  if (threadIdx.x == 0) {
    int* off = meta + (long long)t * 3 * (Wl + 1);
    int* coff = off + (Wl + 1);
    int* loff = coff + (Wl + 1);
    int acc = 0, cacc = 0, lacc = 0;
    for (int j = 0; j < Wl; ++j) {
      const int n = tot[j];
      const int nch = n > chunk ? (n + chunk - 1) / chunk : 1;
      tot[j] = acc;
      off[j] = acc;
      coff[j] = cacc;
      loff[j] = lacc;
      acc += n;
      cacc += nch;
      if (nch > 1) lacc += nch;
    }
    off[Wl] = acc;
    coff[Wl] = cacc;
    loff[Wl] = lacc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < warps * Wl; i += blockDim.x)
    cnt[i] += tot[i % Wl];
  __syncthreads();
  // scatter: each warp walks its range in order, 32 rows at a time
  int* out = rows + (long long)t * S;
  for (int base = s0; base < s1; base += 32) {
    const int s = base + lane;
    const int j = s < s1 ? slot_of(__ldg(node + (long long)s * T + t), stride,
                                   Wl)
                         : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, j);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (j >= 0) out[cnt[w * Wl + j] + rank] = s;
    __syncwarp();
    if (j >= 0 && lane == __ffs(peers) - 1) cnt[w * Wl + j] += __popc(peers);
    __syncwarp();
  }
}

// Pass B: block (c, t) sums chunk c of tree t's chunks.
__global__ void node_hist_kernel(const int* __restrict__ codes,
                                 const float* __restrict__ sw,
                                 const int* __restrict__ meta,
                                 const int* __restrict__ rows,
                                 float* __restrict__ out,
                                 float* __restrict__ part, int S, int d,
                                 int T, int k, int Wl, int nb, int chunk,
                                 int part_slots) {
  extern __shared__ float bins[];
  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int q = threadIdx.x;
  const int nt = blockDim.x;
  const int st = nt + 1;                     // bins row stride
  const int* off = meta + (long long)t * 3 * (Wl + 1);
  const int* coff = off + (Wl + 1);
  const int* loff = coff + (Wl + 1);
  if (c >= coff[Wl]) return;
  // the slot whose chunks hold c: the last j with coff[j] <= c
  int lo = 0, hi = Wl - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (coff[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int j = lo;
  const int qc = c - coff[j];                // chunk within the segment
  const bool whole = coff[j + 1] - coff[j] == 1;
  const int r0 = off[j] + qc * chunk;
  const int r1 = min(r0 + chunk, off[j + 1]);
  const int* seg = rows + (long long)t * S;
  const int P = k * d;
  const long long width = (long long)d * nb;
  float* dst = whole ? nullptr
                     : part + ((long long)t * part_slots + loff[j] + qc) *
                                  (long long)P * nb;
  for (int g0 = 0; g0 < P; g0 += nt) {
    const int p = g0 + q;
    const int np = min(nt, P - g0);
    if (g0) __syncthreads();                 // the last group's bins read
    for (int b = 0; b < nb; ++b) bins[b * st + q] = 0.f;
    if (p < P) {
      const int ki = p / d;
      const int f = p % d;
      const float* swk = sw + (long long)ki * S * T + t;
      int r = r0;
      // a batch's row ids, then their codes and stats, then the adds in
      // row order: two load latencies per batch instead of per row
      for (; r + kUnroll <= r1; r += kUnroll) {
        int s[kUnroll], cd[kUnroll];
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) s[u] = __ldg(seg + r + u);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          cd[u] = __ldg(codes + (long long)s[u] * d + f);
          v[u] = __ldg(swk + (long long)s[u] * T);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if ((unsigned)cd[u] < (unsigned)nb)
            bins[cd[u] * st + q] += bf16_round(v[u]);
      }
      for (; r < r1; ++r) {
        const int s = __ldg(seg + r);
        const int cd = __ldg(codes + (long long)s * d + f);
        if ((unsigned)cd < (unsigned)nb)
          bins[cd * st + q] += bf16_round(__ldg(swk + (long long)s * T));
      }
    }
    __syncthreads();
    // coalesced write of the group's pairs: element (pair g0 + i / nb,
    // bin i % nb); consecutive i are consecutive addresses within a stat
    for (int i = q; i < np * nb; i += nt) {
      const int pl = i / nb;
      const int b = i - pl * nb;
      const float v = bins[b * st + pl];
      const int pp = g0 + pl;
      if (whole) {
        const int ki = pp / d;
        const int f = pp - ki * d;
        out[(((long long)ki * Wl + j) * T + t) * width + (long long)f * nb +
            b] = v;
      } else {
        dst[(long long)pp * nb + b] = v;
      }
    }
  }
}

// Pass C: block (j, t) adds the chunk partials of a multi-chunk segment in
// chunk order.
__global__ void node_combine_kernel(const int* __restrict__ meta,
                                    const float* __restrict__ part,
                                    float* __restrict__ out, int d, int T,
                                    int k, int Wl, int nb, int part_slots) {
  const int j = blockIdx.x;
  const int t = blockIdx.y;
  const int* off = meta + (long long)t * 3 * (Wl + 1);
  const int* coff = off + (Wl + 1);
  const int* loff = coff + (Wl + 1);
  const int nch = coff[j + 1] - coff[j];
  if (nch < 2) return;
  const long long cells = (long long)k * d * nb;
  const long long width = (long long)d * nb;
  const float* src = part + ((long long)t * part_slots + loff[j]) * cells;
  for (long long i = threadIdx.x; i < cells; i += blockDim.x) {
    float acc = src[i];
    for (int qc = 1; qc < nch; ++qc) acc += src[qc * cells + i];
    const long long ki = i / width;
    out[((ki * Wl + j) * T + t) * width + (i - ki * width)] = acc;
  }
}

}  // namespace

extern "C" {

const char* tg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// codes (S, d) int32; node (S, T) int32; sw (k, S, T) f32; workspaces meta
// (T, 3, Wl + 1) and rows (T, S) int32, part (T, part_slots, k, d, nb) f32
// with part_slots >= 2 * ceil(S / chunk) -> out (k, Wl, T, d, nb) f32.
// chunk (rows per chunk) is part of the function: it sets the order of the
// sums. max_threads bounds pass B's block (a multiple of 32), sort_warps
// pass A's; neither changes a bit of the result.
int node_hist(const void* codes, const void* node, const void* sw,
              void* meta, void* rows, void* part, void* out, int S, int d,
              int T, int k, int Wl, int nb, int stride, int chunk,
              int part_slots, int max_threads, int sort_warps, int device,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S < 1 || d < 1 || T < 1 || k < 1 || Wl < 1 || nb < 1 ||
      (stride != 1 && stride != 2) || chunk < 1 ||
      part_slots < 2 * ((S + chunk - 1) / chunk) ||
      max_threads < kMinThreads || max_threads % 32 || max_threads > 1024 ||
      sort_warps < 1 || sort_warps > 32)
    return (int)cudaErrorInvalidValue;
  // pass A: shrink the warp count until the per-warp counters fit
  int warps = sort_warps;
  while (warps > 1 &&
         (size_t)(warps + 1) * Wl * sizeof(int) > (size_t)kSmemDefault)
    warps /= 2;
  const size_t smem_a = (size_t)(warps + 1) * Wl * sizeof(int);
  if (smem_a > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem_a > (size_t)kSmemDefault) {
    err = cudaFuncSetAttribute(node_sort_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_a);
    if (err != cudaSuccess) return (int)err;
  }
  node_sort_kernel<<<T, warps * 32, smem_a, (cudaStream_t)stream>>>(
      (const int*)node, (int*)meta, (int*)rows, S, T, Wl, stride, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // pass B: one thread per (stat, feature) pair up to max_threads, fewer
  // when the bins would not fit the default shared memory
  const int P = k * d;
  int threads = ((P + 31) / 32) * 32;
  if (threads > max_threads) threads = max_threads;
  while (threads > kMinThreads &&
         (size_t)nb * (threads + 1) * sizeof(float) > (size_t)kSmemDefault)
    threads -= 32;
  const size_t smem_b = (size_t)nb * (threads + 1) * sizeof(float);
  if (smem_b > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem_b > (size_t)kSmemDefault) {
    err = cudaFuncSetAttribute(node_hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_b);
    if (err != cudaSuccess) return (int)err;
  }
  // at most one chunk per slot plus one per `chunk` rows
  const int max_chunks = Wl + (S + chunk - 1) / chunk;
  dim3 grid_b((unsigned)max_chunks, (unsigned)T);
  node_hist_kernel<<<grid_b, threads, smem_b, (cudaStream_t)stream>>>(
      (const int*)codes, (const float*)sw, (const int*)meta,
      (const int*)rows, (float*)out, (float*)part, S, d, T, k, Wl, nb, chunk,
      part_slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_c((unsigned)Wl, (unsigned)T);
  node_combine_kernel<<<grid_c, kCombineThreads, 0, (cudaStream_t)stream>>>(
      (const int*)meta, (const float*)part, (float*)out, d, T, k, Wl, nb,
      part_slots);
  return (int)cudaGetLastError();
}

}  // extern "C"
