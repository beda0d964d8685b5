// Forest predict designs that were timed and not taken (timed by
// experiments/forest_variants.py; built only by that script).
//
// 1. One-change variants of the first design, to split what held it back.
// The base variant is that design as it shipped before the packed kernel
// of csrc/forest_predict.cu: one thread a row, 128 rows a block, the row's
// codes read as int32 from global memory (L1/L2) at every step, the split
// tables staged as int32 arrays in rounds of trees that fit in 48 KB,
// between two block barriers. Each flag changes one thing:
//
// * smem_codes: the block's rows of codes are copied into shared memory
//   once, as bytes, coalesced 16 bytes a load (row stride an odd number of
//   words, byte d zero for a feature outside [0, d));
// * packed: each staged slot is one 32-bit record, bin + 1 | base << 9 |
//   feature << 20, packed while staging (one shared-memory load a step
//   instead of two or three);
// * rpt: rows a thread (1 or 2), walked down each tree in lockstep, so a
//   block of 128 threads holds 128 x rpt rows and each staged table byte
//   serves that many.
//
// 2. Launch shapes of the packed design (forest_sweep): the shipped
// kernel's descent with RPT rows (1 or 2) and TPT trees (1, 2 or 4) a
// thread walked at once, and the rows a block given (0: the shipped
// planner's choice). It ships at 1 row x 4 trees, planned rows.
//
// k is 1 and no leaf ids are written: the designs are timed at the serve
// shapes only, and each is checked bit for bit against the plain version
// there. Trees add in ascending order, as in every design.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kTableBytes = 48 * 1024;     // the first design's staging cap
constexpr int kSmemMax = 227 * 1024;

__device__ __forceinline__ void slot_level(int s, int W, int lc, int* l,
                                           int* j) {
  const int narrow = (1 << lc) - 1;
  if (s < narrow) {
    *l = 31 - __clz(s + 1);
    *j = s - ((1 << *l) - 1);
  } else {
    *l = lc + (s - narrow) / W;
    *j = (s - narrow) - (*l - lc) * W;
  }
}

__device__ __forceinline__ unsigned code_byte(int c) {
  return (unsigned)min(max(c, 0), 255);
}

// A code: from the staged bytes, or from global memory (f == d reads 0).
template <bool kSmemCodes>
__device__ __forceinline__ int code_of(const unsigned char* sc, int roff,
                                       const int* crow, int f, int d) {
  if (kSmemCodes) return sc[roff + f];
  return f < d ? __ldg(crow + f) : 0;
}

template <bool kChain, bool kSmemCodes, bool kPacked, int kRPT>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const int* __restrict__ codes, const int* __restrict__ feat,
               const int* __restrict__ bins, const int* __restrict__ base,
               const float* __restrict__ leaf, float* __restrict__ out, int n,
               int d, int T, int depth, int W, int W_out, int lc, int S,
               int tc, int stride, int vec) {
  extern __shared__ __align__(16) int smem[];
  const int q = threadIdx.x;
  const int R = kThreads * kRPT;
  const int fields = kPacked ? 1 : (kChain ? 3 : 2);
  int* s_a = smem;                           // feat, or the records
  int* s_b = smem + tc * S;                  // bins
  int* s_c = smem + 2 * tc * S;              // chain bases
  unsigned char* sc =
      reinterpret_cast<unsigned char*>(smem + fields * tc * S);
  const long long row0 = (long long)blockIdx.x * R;
  if (kSmemCodes) {
    const int m = (int)min((long long)R, n - row0);
    const int* crows = codes + row0 * d;
    if (vec) {
      const int dq = d >> 2;
      const int4* c4 = reinterpret_cast<const int4*>(crows);
      for (int i = q; i < m * dq; i += kThreads) {
        const int r = i / dq;
        const int4 v = __ldg(c4 + i);
        *reinterpret_cast<unsigned*>(sc + r * stride + 4 * (i - r * dq)) =
            code_byte(v.x) | code_byte(v.y) << 8 | code_byte(v.z) << 16 |
            code_byte(v.w) << 24;
      }
    } else {
      for (int i = q; i < m * d; i += kThreads) {
        const int r = i / d;
        sc[r * stride + (i - r * d)] =
            (unsigned char)code_byte(__ldg(crows + i));
      }
    }
    for (int r = q; r < R; r += kThreads) sc[r * stride + d] = 0;
  }
  const int* crow[kRPT];
  int roff[kRPT];
  float acc[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const long long row = row0 + q + i * kThreads;
    crow[i] = codes + (row < n ? row : 0) * (long long)d;
    roff[i] = (q + i * kThreads) * stride;
    acc[i] = 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += tc) {
    const int nt = min(tc, T - t0);
    __syncthreads();
    for (int i = q; i < nt * S; i += kThreads) {
      const int tt = i / S;
      const int s = i - tt * S;
      int l, j, f, b, a;
      slot_level(s, W, lc, &l, &j);
      if (kChain) {
        const long long src = ((long long)(t0 + tt) * depth + l) * W + j;
        f = feat[src];
        b = bins[src];
        a = base[src];
      } else {
        const long long src = (long long)(t0 + tt) * S + s;
        f = feat[src];
        b = bins[src];
        a = 2 * j;
      }
      if (kPacked) {
        const unsigned fp = f >= 0 && f < d ? (unsigned)f : (unsigned)d;
        const unsigned bp = (unsigned)(min(max(b, -1), 255) + 1);
        const unsigned ap = a >= 0 && a < 2046 ? (unsigned)a : 2046u;
        s_a[i] = (int)(bp | ap << 9 | fp << 20);
      } else {
        s_a[i] = f;
        s_b[i] = b;
        if (kChain) s_c[i] = a;
      }
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const int t = t0 + tt;
      const int o = tt * S;
      int slot[kRPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) slot[i] = 0;
      int off = 0;
      for (int l = 0; l < depth; ++l) {
        const int Wl = l < lc ? 1 << l : W;
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          const bool live = (unsigned)slot[i] < (unsigned)Wl;
          const int e = o + off + (live ? slot[i] : 0);
          int go, a;
          if (kPacked) {
            const unsigned x = (unsigned)s_a[e];
            go = code_of<kSmemCodes>(sc, roff[i], crow[i], x >> 20, d) >=
                 (int)(x & 511u);
            a = (int)(x >> 9 & 2047u);
          } else {
            const int f = s_a[e];
            const int fp = (unsigned)f < (unsigned)d ? f : d;
            go = code_of<kSmemCodes>(sc, roff[i], crow[i], fp, d) > s_b[e];
            a = kChain ? s_c[e] : 2 * slot[i];
          }
          slot[i] = live ? a + go : 0;
        }
        off += Wl;
      }
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
        if ((unsigned)slot[i] < (unsigned)W_out)
          acc[i] += __ldg(leaf + (long long)t * W_out + slot[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const long long row = row0 + q + i * kThreads;
    if (row < n) out[row] = acc[i];
  }
}

template <bool kChain, bool kSmemCodes, bool kPacked, int kRPT>
cudaError_t launch(const int* codes, const int* feat, const int* bins,
                   const int* base, const float* leaf, float* out, int n,
                   int d, int T, int depth, int W, int W_out, int lc, int S,
                   cudaStream_t stream) {
  const int fields = kPacked ? 1 : (kChain ? 3 : 2);
  const size_t tree = (size_t)fields * 4 * S;
  int tc = (int)(kTableBytes / (tree > 0 ? tree : 1));
  if (tc > T) tc = T;
  if (tc < 1) tc = 1;
  int words = (d + 4) / 4;
  if (!(words & 1)) ++words;
  const int stride = 4 * words;
  const size_t smem = tree * tc +
      (kSmemCodes ? (size_t)kThreads * kRPT * stride : 0);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      variant_kernel<kChain, kSmemCodes, kPacked, kRPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && ((uintptr_t)codes & 15) == 0;
  const unsigned blocks =
      (unsigned)(((long long)n + kThreads * kRPT - 1) / (kThreads * kRPT));
  variant_kernel<kChain, kSmemCodes, kPacked, kRPT>
      <<<blocks, kThreads, smem, stream>>>(codes, feat, bins, base, leaf,
                                           out, n, d, T, depth, W, W_out, lc,
                                           S, tc, stride, vec);
  return cudaGetLastError();
}

template <bool kChain, bool kSmemCodes, bool kPacked>
cudaError_t by_rows(int rpt, const int* codes, const int* feat,
                    const int* bins, const int* base, const float* leaf,
                    float* out, int n, int d, int T, int depth, int W,
                    int W_out, int lc, int S, cudaStream_t stream) {
  if (rpt == 2)
    return launch<kChain, kSmemCodes, kPacked, 2>(
        codes, feat, bins, base, leaf, out, n, d, T, depth, W, W_out, lc, S,
        stream);
  return launch<kChain, kSmemCodes, kPacked, 1>(
      codes, feat, bins, base, leaf, out, n, d, T, depth, W, W_out, lc, S,
      stream);
}

template <bool kChain, bool kSmemCodes>
cudaError_t by_packing(int packed, int rpt, const int* codes, const int* feat,
                       const int* bins, const int* base, const float* leaf,
                       float* out, int n, int d, int T, int depth, int W,
                       int W_out, int lc, int S, cudaStream_t stream) {
  if (packed)
    return by_rows<kChain, kSmemCodes, true>(rpt, codes, feat, bins, base,
                                             leaf, out, n, d, T, depth, W,
                                             W_out, lc, S, stream);
  return by_rows<kChain, kSmemCodes, false>(rpt, codes, feat, bins, base,
                                            leaf, out, n, d, T, depth, W,
                                            W_out, lc, S, stream);
}

template <bool kChain>
cudaError_t by_codes(int smem_codes, int packed, int rpt, const int* codes,
                     const int* feat, const int* bins, const int* base,
                     const float* leaf, float* out, int n, int d, int T,
                     int depth, int W, int W_out, int lc, int S,
                     cudaStream_t stream) {
  if (smem_codes)
    return by_packing<kChain, true>(packed, rpt, codes, feat, bins, base,
                                    leaf, out, n, d, T, depth, W, W_out, lc,
                                    S, stream);
  return by_packing<kChain, false>(packed, rpt, codes, feat, bins, base,
                                   leaf, out, n, d, T, depth, W, W_out, lc, S,
                                   stream);
}

// ---------------------------------------------------------------------------
// 2. The packed design's launch shapes (a copy of csrc/forest_predict.cu's
// packed path, templated on rows and trees a thread)
// ---------------------------------------------------------------------------

constexpr int kFeatShift = 20;
constexpr int kBaseShift = 9;
constexpr int kBaseMax = 1023;
constexpr int kEscape = -1024;
constexpr unsigned kNever = 256u;
constexpr int kMaxThreads = 512;
constexpr size_t kSmallForest = 48 * 1024;

int round_up(long long x, int m) { return (int)((x + m - 1) / m * m); }

// ceil(log2 W) and the records of a tree: each level's slots and a sink.
void chain_shape(int depth, int* W, int* lc, int* S) {
  if (*W == 0) *W = depth > 0 ? 1 << (depth - 1) : 1;
  *lc = 0;
  while ((1 << *lc) < *W) ++*lc;
  *S = 0;
  for (int l = 0; l < depth; ++l) *S += (l < *lc ? (1 << l) : *W) + 1;
}

__device__ __forceinline__ unsigned record(int f, int b, int a, int d) {
  const unsigned fp = f >= 0 && f < d ? (unsigned)f : (unsigned)d;
  const unsigned bp = (unsigned)(min(max(b, -1), 255) + 1);
  return bp | ((unsigned)a & 2047u) << kBaseShift | fp << kFeatShift;
}

__device__ __forceinline__ int record_base(unsigned x) {
  return (int)(x << (32 - kFeatShift)) >> (32 - kFeatShift + kBaseShift);
}

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
    for (; l < depth; ++l) {
      const int Wl = l < lc ? 1 << l : W;
      if (s <= Wl) break;
      s -= Wl + 1;
    }
    const int Wl = l < lc ? 1 << l : W;
    if (l == depth) {
      rec[i] = 0u;
    } else if (s == Wl) {
      rec[i] = kNever | (unsigned)d << kFeatShift;
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int RPT, int TPT>
__global__ void __launch_bounds__(kMaxThreads)
sweep_kernel(const int* __restrict__ codes, const unsigned* __restrict__ rec,
             const int* __restrict__ base, const float* __restrict__ leaf,
             float* __restrict__ out, int n, int d, int T, int depth, int W,
             int lc, int Sp, int W_out, int tc, int stride, int vec) {
  extern __shared__ __align__(16) unsigned pred_smem[];
  const int nt = blockDim.x;
  const int q = threadIdx.x;
  const int R = nt * RPT;
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
    for (int i = 4 * q; i < words; i += 4 * nt) cp_async16(dst + i, src + i);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (ntiles > 0) stage(0);
  const int m = (int)min((long long)R, n - row0);
  const int* crows = codes + row0 * d;
  if (vec) {
    const int dq = d >> 2;
    const int4* c4 = reinterpret_cast<const int4*>(crows);
    for (int i = q; i < m * dq; i += nt) {
      const int r = i / dq;
      const int4 v = __ldg(c4 + i);
      *reinterpret_cast<unsigned*>(sc + r * stride + 4 * (i - r * dq)) =
          code_byte(v.x) | code_byte(v.y) << 8 | code_byte(v.z) << 16 |
          code_byte(v.w) << 24;
    }
  } else {
    for (int i = q; i < m * d; i += nt) {
      const int r = i / d;
      sc[r * stride + (i - r * d)] =
          (unsigned char)code_byte(__ldg(crows + i));
    }
  }
  for (int r = q; r < R; r += nt) sc[r * stride + d] = 0;
  const unsigned char* rows[RPT];
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    rows[i] = sc + (q + i * nt) * stride;
    acc[i] = 0.f;
  }
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned* tb = tab + (it & 1) * tile_words;
    const int t0 = it * tc;
    const int ntt = min(tc, T - t0);
    for (int tt = 0; tt < ntt; tt += TPT) {
      const unsigned* tr[TPT];
#pragma unroll
      for (int u = 0; u < TPT; ++u) tr[u] = tb + min(tt + u, ntt - 1) * Sp;
      int slot[RPT][TPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int u = 0; u < TPT; ++u) slot[i][u] = 0;
      int off = 0;
      for (int l = 0; l + 1 < depth; ++l) {
        const unsigned Wl = l < lc ? 1u << l : (unsigned)W;
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int u = 0; u < TPT; ++u) {
            const unsigned x = tr[u][off + min((unsigned)slot[i][u], Wl)];
            slot[i][u] = record_base(x) +
                         (rows[i][x >> kFeatShift] >= (x & 511u));
          }
        off += Wl + 1;
      }
      if (depth > 0) {
        const int l = depth - 1;
        const unsigned Wl = l < lc ? 1u << l : (unsigned)W;
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int u = 0; u < TPT; ++u) {
            const unsigned e = min((unsigned)slot[i][u], Wl);
            const unsigned x = tr[u][off + e];
            int a = record_base(x);
            if (a == kEscape)
              a = __ldg(base + ((long long)(t0 + min(tt + u, ntt - 1)) * depth
                                + l) * W + e);
            slot[i][u] = a + (rows[i][x >> kFeatShift] >= (x & 511u));
          }
      }
#pragma unroll
      for (int u = 0; u < TPT; ++u) {
        if (tt + u >= ntt) break;
        const int t = t0 + tt + u;
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          if ((unsigned)slot[i][u] < (unsigned)W_out)
            acc[i] += __ldg(leaf + (long long)t * W_out + slot[i][u]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const long long row = row0 + q + i * nt;
    if (row < n) out[row] = acc[i];
  }
}

template <int RPT, int TPT>
cudaError_t sweep(const int* codes, const int* feat, const int* bins,
                  const int* base, const float* leaf, float* out,
                  unsigned* rec, int n, int d, int T, int depth, int W,
                  int W_out, int block_rows, int device,
                  cudaStream_t stream) {
  int lc, S;
  chain_shape(depth, &W, &lc, &S);
  const int Sp = round_up(S, 4);
  int words = (d + 4) / 4;
  if (!(words & 1)) ++words;
  const int stride = 4 * words;
  const size_t tree = (size_t)Sp * 4;
  int R = block_rows;
  if (R <= 0) {                              // the shipped planner's rows
    int sms = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long per = (long long)sms * (tree * T <= kSmallForest ? 4 : 1);
    R = round_up((n + per - 1) / per, 32 * RPT);
  }
  R = std::max(32 * RPT, std::min(round_up(R, 32 * RPT), kMaxThreads * RPT));
  int tc = 0;
  size_t smem = 0;
  for (; R >= 32 * RPT; R -= 32 * RPT) {
    const size_t cb = (size_t)R * stride;
    if (cb + tree * T <= (size_t)kSmemMax) {
      tc = std::max(T, 1);
      smem = cb + tree * T;
      break;
    }
    const long long fit = ((long long)kSmemMax - (long long)cb) /
                          (2 * (long long)tree);
    if (fit >= 1) {
      tc = (int)fit;
      smem = cb + 2 * tree * tc;
      break;
    }
  }
  if (tc < 1) return cudaErrorInvalidValue;
  const long long m = (long long)T * Sp;
  pack_kernel<<<(unsigned)std::min((m + 255) / 256, 4096LL), 256, 0,
                stream>>>(feat, bins, base, rec, T, depth, W, lc, Sp, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sweep_kernel<RPT, TPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && ((uintptr_t)codes & 15) == 0;
  sweep_kernel<RPT, TPT><<<(unsigned)((n + R - 1) / R), R / RPT, smem,
                           stream>>>(codes, rec, base, leaf, out, n, d, T,
                                     depth, W, lc, Sp, W_out, tc, stride,
                                     vec);
  return cudaGetLastError();
}

template <int RPT>
cudaError_t sweep_trees(int tpt, const int* codes, const int* feat,
                        const int* bins, const int* base, const float* leaf,
                        float* out, unsigned* rec, int n, int d, int T,
                        int depth, int W, int W_out, int block_rows,
                        int device, cudaStream_t stream) {
  auto go = [&](auto fn) {
    return fn(codes, feat, bins, base, leaf, out, rec, n, d, T, depth, W,
              W_out, block_rows, device, stream);
  };
  return tpt == 1   ? go(sweep<RPT, 1>)
         : tpt == 2 ? go(sweep<RPT, 2>)
                    : go(sweep<RPT, 4>);
}

}  // namespace

extern "C" {

const char* tg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One variant: base null for heaps (feat, bins (T, 2^depth - 1)), else
// chains (feat, bins, base (T, depth, W)); leaf (T, W_out) f32 -> out (n)
// f32. codes (n, d) int32 in [0, 256).
int forest_variant(int smem_codes, int packed, int rpt, const void* codes,
                   const void* feat, const void* bins, const void* base,
                   const void* leaf, void* out, int n, int d, int T,
                   int depth, int W, int W_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const bool chain = base != nullptr;
  if (!chain) W = depth > 0 ? 1 << (depth - 1) : 1;
  int lc = 0;
  while ((1 << lc) < W) ++lc;
  int S = 0;
  for (int l = 0; l < depth; ++l) S += l < lc ? (1 << l) : W;
  if (chain)
    err = by_codes<true>(smem_codes, packed, rpt, (const int*)codes,
                         (const int*)feat, (const int*)bins,
                         (const int*)base, (const float*)leaf, (float*)out,
                         n, d, T, depth, W, W_out, lc, S,
                         (cudaStream_t)stream);
  else
    err = by_codes<false>(smem_codes, packed, rpt, (const int*)codes,
                          (const int*)feat, (const int*)bins, nullptr,
                          (const float*)leaf, (float*)out, n, d, T, depth, W,
                          W_out, lc, S, (cudaStream_t)stream);
  return (int)err;
}

// The record words forest_sweep takes for T trees (W 0: heaps).
int forest_sweep_workspace(int T, int depth, int W, long long* words) {
  int lc, S;
  chain_shape(depth, &W, &lc, &S);
  *words = (long long)T * round_up(S, 4);
  return 0;
}

// The packed design at rpt rows (1, 2) and tpt trees (1, 2, 4) a thread
// and block_rows rows a block (0: planned); tables as forest_variant's,
// rec forest_sweep_workspace words.
int forest_sweep(int rpt, int tpt, int block_rows, const void* codes,
                 const void* feat, const void* bins, const void* base,
                 const void* leaf, void* out, void* rec, int n, int d, int T,
                 int depth, int W, int W_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if ((rpt != 1 && rpt != 2) || (tpt != 1 && tpt != 2 && tpt != 4) ||
      d > 4095)
    return (int)cudaErrorInvalidValue;
  if (base == nullptr) W = 0;
  auto go = [&](auto fn) {
    return fn(tpt, (const int*)codes, (const int*)feat, (const int*)bins,
              (const int*)base, (const float*)leaf, (float*)out,
              (unsigned*)rec, n, d, T, depth, W, W_out, block_rows, device,
              (cudaStream_t)stream);
  };
  return (int)(rpt == 1 ? go(sweep_trees<1>) : go(sweep_trees<2>));
}

}  // extern "C"
