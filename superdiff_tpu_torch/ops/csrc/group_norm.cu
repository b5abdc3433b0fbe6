// GroupNorm with fp32 statistics, an optional per-(batch, channel) input
// shift and an optional SiLU, for Hopper (sm_90a).
//
//   xs = x + shift[b, c]                       (fp32, never rounded)
//   mean_g, var_g = max(E[xs^2] - E[xs]^2, 0)  over each (batch, group), fp32
//   a = rsqrt(var_g + eps) w_c ;  b = bias_c - mean_g a
//   y = act(xs a + b)                          (fp32, rounded once to x's dtype)
//
// act is SiLU or the identity. This replaces no TPU kernel: in the JAX
// reference (superdiff_tpu/models/unet.py:57, GroupNorm32) XLA fuses the
// statistics, the apply, the shift add before it and the SiLU after it. The
// port's plain version (ops/group_norm.py::group_norm_plain) runs them as
// some nine PyTorch ops with two fp32 copies of x.
//
// Bound on the H100: bytes. Any implementation reads x once from DRAM and
// writes y: 2 x numel x 2 bytes in bf16 (4 B an element). This design reads
// x twice (the statistics, then the apply), the second time from L2 where x
// fits there (b8's largest UNet input, (24, 320, 64, 64), is 31 MB of the
// 50 MB L2), else from DRAM (6 B an element: the VAE decoder's upper
// levels). At 3.35 TB/s the 61 norms of a b8 UNet step are 4.1 GB, 1.2 ms;
// the 30 of a b8 VAE decode 14.7 GB, of which this design moves 22 GB.
//
// Design: TWO launches a call, group_norm_stats then group_norm_apply, with
// no grid-wide barrier (which a one-launch design would need between the
// statistics and the apply, and which a cooperative launch limits to one
// wave). Each (batch, group) reduction is split over S blocks (up to
// kMaxSplits, enough that B x S blocks fill the SMs: b1's UNet has only 3
// batch rows); each block writes its partial (sum, sum of squares) to a
// scratch buffer, and every apply block adds the S partials of the groups
// it needs in a fixed order (a lane per partial, then a fixed butterfly of
// warp shuffles), so the result is the same from run to run, with no
// atomics: a captured step stays bit-identical to the eager one. The apply
// blocks run in the reverse order of the statistics blocks, so the rows the
// statistics read last, the likeliest still in L2, are read again first.
// Both kernels read x in the layout it has, with no copy:
//  * channels_last (NHWC memory, cuDNN's outputs): a block takes a run of
//    pixel rows of one batch row; thread t reads the 16 bytes of channels
//    (t % V) * n .. + n of rows t / V, t / V + R, ... (V = C / n vectors a
//    row, R rows at once, n = 8 bf16 or 4 fp32), kUnroll rows in flight.
//    Its sums are per channel, so a 16-byte vector may straddle a group
//    boundary (C / G = 10, 12, 20, 30, 60) and any C / G is taken; the block
//    adds its channels' sums over its rows, then each group's channels.
//  * NCHW-contiguous: a group of one batch row is one contiguous run of
//    C / G x H x W elements, split over S blocks of 256 threads; 16-byte
//    vectors when H x W is a multiple of n (each vector in one channel),
//    else one element at a time.
// The launches take no host sync and write only the scratch, y and the
// (B, G) mean and rstd (for the backward), all allocated by the caller, so
// a call can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSplits = 64;     // partial sums per (batch, group)
constexpr int kRowThreads = 512;   // channels_last: threads a block aims at
constexpr int kGroupThreads = 256; // NCHW: threads a block
constexpr int kUnroll = 4;         // 16-byte loads a thread has in flight
constexpr int kMaxChannels = 4096;  // V = C / n 16-byte vectors a row: 512 bf16, 1024 fp32
                                    // (ops/group_norm.py::_MAX_CHANNELS checks it on any device)

enum Flags { kF32 = 1, kSilu = 2, kShift = 4 };

struct GnArgs {
  const void* x;
  void* y;
  const float* weight;
  const float* bias;
  const void* shift;  // x's dtype
  float2* part;   // (B, S, G) channels_last, (B, G, S) NCHW: (sum, sum of squares)
  float2* stats;  // (B, G): (mean, rstd)
  int C, P, G, cpg, S, shift_stride, flags;
  float eps;
};

// 16 bytes of x as floats, and back
template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
  __device__ static float one(const void* p, size_t i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  __device__ static void put(void* p, size_t i, float v) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  }
};

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ static float one(const void* p, size_t i) {
    return static_cast<const float*>(p)[i];
  }
  __device__ static void put(void* p, size_t i, float v) { static_cast<float*>(p)[i] = v; }
};

__device__ __forceinline__ float act(float y, bool silu) {
  return silu ? __fdividef(y, 1.0f + __expf(-y)) : y;
}

// where split s of S starts in n rows or vectors (n < 2^31)
__device__ __forceinline__ unsigned split_at(unsigned n, int s, int S) {
  return static_cast<unsigned>(static_cast<unsigned long long>(n) * s / S);
}

// The S partials of group g (stride apart from `first`) added by one warp
// in a fixed order; lane 0 turns them into (mean, rstd).
__device__ __forceinline__ float2 combine(const float2* first, size_t stride, int S, float n,
                                          float eps, int lane) {
  float sum = 0.0f, sq = 0.0f;
  for (int k = lane; k < S; k += 32) {
    const float2 v = first[k * stride];
    sum += v.x;
    sq += v.y;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const float mean = sum / n;
  const float var = fmaxf(sq / n - mean * mean, 0.0f);
  return make_float2(mean, rsqrtf(var + eps));
}

// ---- channels_last ---------------------------------------------------------

// kBound: kRowThreads, or 2 kRowThreads for an fp32 row of V > kRowThreads
// vectors (one thread a vector; the stats block's sums, R x C = threads x n,
// still fit kMaxChannels)
template <typename T, int kBound>
__global__ void __launch_bounds__(kBound) group_norm_stats_cl(GnArgs a) {
  constexpr int N = Pack<T>::kN;
  __shared__ __align__(16) float sums[kMaxChannels];
  __shared__ __align__(16) float sqs[kMaxChannels];
  const int V = a.C / N, R = blockDim.x / V, t = threadIdx.x;
  const int c0 = (t % V) * N, r0 = t / V;
  const int s = blockIdx.x % a.S, b = blockIdx.x / a.S;
  const int p0 = split_at(a.P, s, a.S), p1 = split_at(a.P, s + 1, a.S);
  float sh[N], sum[N], sq[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    sh[e] = (a.flags & kShift)
                ? Pack<T>::one(a.shift, static_cast<size_t>(b) * a.shift_stride + c0 + e)
                : 0.0f;
    sum[e] = sq[e] = 0.0f;
  }
  const T* xb = static_cast<const T*>(a.x) + static_cast<size_t>(b) * a.P * a.C + c0;
  for (int p = p0 + r0; p < p1; p += kUnroll * R) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pp = p + u * R;
      raw[u] = pp < p1 ? __ldg(reinterpret_cast<const uint4*>(xb + static_cast<size_t>(pp) * a.C))
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * R < p1) {
        float v[N];
        Pack<T>::unpack(raw[u], v);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float f = v[e] + sh[e];
          sum[e] += f;
          sq[e] = fmaf(f, f, sq[e]);
        }
      }
    }
  }
  // thread t's channels sit at t * N of row r0 (r0 * C + c0 == t * N)
#pragma unroll
  for (int e = 0; e < N; ++e) {
    sums[t * N + e] = sum[e];
    sqs[t * N + e] = sq[e];
  }
  __syncthreads();
  for (int c = t; c < a.C; c += blockDim.x) {
    float cs = 0.0f, cq = 0.0f;
    for (int r = 0; r < R; ++r) {
      cs += sums[r * a.C + c];
      cq += sqs[r * a.C + c];
    }
    sums[c] = cs;
    sqs[c] = cq;
  }
  __syncthreads();
  for (int g = t; g < a.G; g += blockDim.x) {
    float gs = 0.0f, gq = 0.0f;
    for (int k = 0; k < a.cpg; ++k) {
      gs += sums[g * a.cpg + k];
      gq += sqs[g * a.cpg + k];
    }
    a.part[(static_cast<size_t>(b) * a.S + s) * a.G + g] = make_float2(gs, gq);
  }
}

template <typename T, int kBound>
__global__ void __launch_bounds__(kBound) group_norm_apply_cl(GnArgs a) {
  constexpr int N = Pack<T>::kN;
  extern __shared__ float2 group_stats[];  // (mean, rstd) of each group of row b
  const int V = a.C / N, R = blockDim.x / V, t = threadIdx.x;
  const int blk = gridDim.x - 1 - blockIdx.x;  // the statistics' order, reversed
  const int s = blk % a.S, b = blk / a.S;
  const int lane = t & 31, full_warps = blockDim.x >> 5;
  const float n = static_cast<float>(static_cast<long long>(a.cpg) * a.P);
  for (int g = t >> 5; g < a.G && (t >> 5) < full_warps; g += full_warps) {
    const float2 ms = combine(a.part + static_cast<size_t>(b) * a.S * a.G + g, a.G, a.S, n,
                              a.eps, lane);
    if (lane == 0) {
      group_stats[g] = ms;
      if (s == 0) a.stats[static_cast<size_t>(b) * a.G + g] = ms;
    }
  }
  __syncthreads();
  const int c0 = (t % V) * N, r0 = t / V;
  const bool silu = a.flags & kSilu;
  float sh[N], mul[N], add[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int c = c0 + e;
    const float2 ms = group_stats[c / a.cpg];
    mul[e] = ms.y * a.weight[c];
    add[e] = a.bias[c] - ms.x * mul[e];
    sh[e] = (a.flags & kShift)
                ? Pack<T>::one(a.shift, static_cast<size_t>(b) * a.shift_stride + c)
                : 0.0f;
  }
  const int p0 = split_at(a.P, s, a.S), p1 = split_at(a.P, s + 1, a.S);
  const size_t off = static_cast<size_t>(b) * a.P * a.C + c0;
  const T* xb = static_cast<const T*>(a.x) + off;
  T* yb = static_cast<T*>(a.y) + off;
  for (int p = p0 + r0; p < p1; p += kUnroll * R) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pp = p + u * R;
      raw[u] = pp < p1 ? __ldcs(reinterpret_cast<const uint4*>(xb + static_cast<size_t>(pp) * a.C))
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pp = p + u * R;
      if (pp < p1) {
        float v[N];
        Pack<T>::unpack(raw[u], v);
#pragma unroll
        for (int e = 0; e < N; ++e) v[e] = act(fmaf(v[e] + sh[e], mul[e], add[e]), silu);
        *reinterpret_cast<uint4*>(yb + static_cast<size_t>(pp) * a.C) = Pack<T>::pack(v);
      }
    }
  }
}

// ---- NCHW-contiguous -------------------------------------------------------

// kVec: elements a load (16 bytes' worth, or 1 when H x W is not a multiple)
template <typename T, int kVec>
__device__ __forceinline__ void load_run(const T* p, float (&v)[kVec], bool last_use) {
  if constexpr (kVec == 1) {
    v[0] = Pack<T>::one(p, 0);
  } else {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    Pack<T>::unpack(last_use ? __ldcs(q) : __ldg(q), v);
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kGroupThreads) group_norm_stats_cf(GnArgs a) {
  __shared__ float2 warp_sums[kGroupThreads / 32];
  const int t = threadIdx.x, s = blockIdx.x % a.S, bg = blockIdx.x / a.S;
  const int b = bg / a.G, g = bg % a.G;
  const unsigned nv = static_cast<unsigned>(a.cpg * a.P / kVec);
  const unsigned v0 = split_at(nv, s, a.S), v1 = split_at(nv, s + 1, a.S);
  const T* xg = static_cast<const T*>(a.x) + static_cast<size_t>(bg) * a.cpg * a.P;
  const bool shifted = a.flags & kShift;
  const size_t shift0 = static_cast<size_t>(b) * a.shift_stride + static_cast<size_t>(g) * a.cpg;
  const unsigned P = a.P;
  float sum = 0.0f, sq = 0.0f;
  for (unsigned i = v0 + t; i < v1; i += kUnroll * kGroupThreads) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned ii = i + u * kGroupThreads;
      if (ii < v1) load_run<T, kVec>(xg + static_cast<size_t>(ii) * kVec, v[u], false);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned ii = i + u * kGroupThreads;
      if (ii < v1) {
        const float sh = shifted ? Pack<T>::one(a.shift, shift0 + ii * kVec / P) : 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float f = v[u][e] + sh;
          sum += f;
          sq = fmaf(f, f, sq);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  if ((t & 31) == 0) warp_sums[t >> 5] = make_float2(sum, sq);
  __syncthreads();
  if (t == 0) {
    float gs = 0.0f, gq = 0.0f;
    for (int w = 0; w < kGroupThreads / 32; ++w) {
      gs += warp_sums[w].x;
      gq += warp_sums[w].y;
    }
    a.part[static_cast<size_t>(bg) * a.S + s] = make_float2(gs, gq);
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kGroupThreads) group_norm_apply_cf(GnArgs a) {
  __shared__ float2 group_stat;
  const int t = threadIdx.x;
  const int blk = gridDim.x - 1 - blockIdx.x;  // the statistics' order, reversed
  const int s = blk % a.S, bg = blk / a.S;
  const int b = bg / a.G, g = bg % a.G;
  if (t < 32) {
    const float n = static_cast<float>(static_cast<long long>(a.cpg) * a.P);
    const float2 ms = combine(a.part + static_cast<size_t>(bg) * a.S, 1, a.S, n, a.eps, t);
    if (t == 0) {
      group_stat = ms;
      if (s == 0) a.stats[bg] = ms;
    }
  }
  __syncthreads();
  const float2 ms = group_stat;
  const bool silu = a.flags & kSilu, shifted = a.flags & kShift;
  const unsigned nv = static_cast<unsigned>(a.cpg * a.P / kVec);
  const unsigned v0 = split_at(nv, s, a.S), v1 = split_at(nv, s + 1, a.S);
  const size_t off = static_cast<size_t>(bg) * a.cpg * a.P;
  const T* xg = static_cast<const T*>(a.x) + off;
  T* yg = static_cast<T*>(a.y) + off;
  const int cg0 = g * a.cpg;
  const unsigned P = a.P;
  for (unsigned i = v0 + t; i < v1; i += kUnroll * kGroupThreads) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned ii = i + u * kGroupThreads;
      if (ii < v1) load_run<T, kVec>(xg + static_cast<size_t>(ii) * kVec, v[u], true);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned ii = i + u * kGroupThreads;
      if (ii < v1) {
        const int c = cg0 + static_cast<int>(ii * kVec / P);
        const float mul = ms.y * a.weight[c];
        const float add = a.bias[c] - ms.x * mul;
        const float sh =
            shifted ? Pack<T>::one(a.shift, static_cast<size_t>(b) * a.shift_stride + c) : 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[u][e] = act(fmaf(v[u][e] + sh, mul, add), silu);
        if constexpr (kVec == 1) {
          Pack<T>::put(yg, ii, v[u][0]);
        } else {
          *reinterpret_cast<uint4*>(yg + static_cast<size_t>(ii) * kVec) = Pack<T>::pack(v[u]);
        }
      }
    }
  }
}

int multiprocessors() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// S: enough blocks to fill the SMs four times over, each with at least
// kUnroll passes of `per_pass` units of its `units`, at most kMaxSplits
int splits(long long rows_of_blocks, long long units, long long per_pass) {
  const long long want = (4LL * multiprocessors() + rows_of_blocks - 1) / rows_of_blocks;
  const long long most = units / (per_pass * kUnroll);
  long long s = want < most ? want : most;
  if (s > kMaxSplits) s = kMaxSplits;
  return s < 1 ? 1 : static_cast<int>(s);
}

template <typename T, int kBound>
cudaError_t launch_cl_bound(GnArgs& a, int B, cudaStream_t stream) {
  const int V = a.C / Pack<T>::kN;
  const int R = V < kRowThreads ? kRowThreads / V : 1;
  const int threads = V * R;
  a.S = splits(B, a.P, R);
  const unsigned blocks = static_cast<unsigned>(B) * a.S;
  group_norm_stats_cl<T, kBound><<<blocks, threads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_norm_apply_cl<T, kBound><<<blocks, threads, a.G * sizeof(float2), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cl(GnArgs& a, int B, cudaStream_t stream) {
  if constexpr (Pack<T>::kN == 4) {  // fp32: up to 1024 vectors a row
    if (a.C / 4 > kRowThreads) return launch_cl_bound<T, 2 * kRowThreads>(a, B, stream);
  }
  return launch_cl_bound<T, kRowThreads>(a, B, stream);
}

template <typename T, int kVec>
cudaError_t launch_cf_vec(GnArgs& a, int B, cudaStream_t stream) {
  a.S = splits(static_cast<long long>(B) * a.G, static_cast<long long>(a.cpg) * a.P / kVec,
               kGroupThreads);
  const unsigned blocks = static_cast<unsigned>(B) * a.G * a.S;
  group_norm_stats_cf<T, kVec><<<blocks, kGroupThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_norm_apply_cf<T, kVec><<<blocks, kGroupThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cf(GnArgs& a, int B, cudaStream_t stream) {
  return a.P % Pack<T>::kN == 0 ? launch_cf_vec<T, Pack<T>::kN>(a, B, stream)
                                : launch_cf_vec<T, 1>(a, B, stream);
}

}  // namespace

extern "C" int group_norm_max_splits() { return kMaxSplits; }

// x, y: (B, C, H, W) with P = H x W, channels_last (NHWC memory) or NCHW,
// 16-byte aligned, bf16 or fp32 (kF32); weight, bias: (C,) fp32; shift: (B, C)
// in x's dtype, rows shift_stride apart, or null; part: B x G x group_norm_max_splits() float2 of scratch;
// stats: (B, G) float2 out. flags: the Flags above.
extern "C" int group_norm_launch(const void* x, void* y, const void* weight, const void* bias,
                                 const void* shift, void* part, void* stats, int B, int C, int P,
                                 int G, int channels_last, int flags, int shift_stride, float eps,
                                 void* stream) {
  if (B < 1 || P < 1 || G < 1 || C % G != 0 || C % 8 != 0 || C > kMaxChannels ||
      static_cast<long long>(C / G) * P >= (1LL << 31) ||
      ((flags & kShift) != 0) != (shift != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  GnArgs a{x, y, static_cast<const float*>(weight), static_cast<const float*>(bias), shift,
           static_cast<float2*>(part), static_cast<float2*>(stats),
           C, P, G, C / G, 1, shift_stride, flags, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (flags & kF32)
    err = channels_last ? launch_cl<float>(a, B, st) : launch_cf<float>(a, B, st);
  else
    err = channels_last ? launch_cl<__nv_bfloat16>(a, B, st) : launch_cf<__nv_bfloat16>(a, B, st);
  return static_cast<int>(err);
}
